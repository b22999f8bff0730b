"""Batched augmentation on the training device (counterpart of
``semi_seg_ecg_tpu/ops/preprocess.py``).

The JAX package fuses the weak/strong augmentation stage into its train
step: the host ships raw (resampled, filtered) signals and the device
builds the views. The port runs the same ops on whole batches on the card,
eagerly, before the step's forward. Each op is split in two:

- ``sample(generator, shape)`` makes every random draw the op needs, with
  the trainer's ``torch.Generator``, on that generator's device;
- ``apply(draws, x, y)`` is deterministic given the draws.

The split exists because PyTorch and JAX generators give different numbers:
the tests make the draws with the same ``jax.random`` calls and keys the
JAX op makes, hand them to ``apply`` and hold its output against the JAX
op's. Draws are made in the shapes and (for the uniform ones) on the
``[0, 1)`` scale that the JAX op draws, and the arithmetic after them
follows the JAX op operation for operation. Every draw has the batch as
its leading axis; under a process group it is drawn for the global batch
and sliced to the rank's rows (``parallel.dist.global_rows``), so a
rank's draws are those of its rows in one process holding every rank's.

Every device op of the JAX package is ported:

=====================  =======================================================
op                     on the device
=====================  =======================================================
random_resize_crop     per-sample coordinate grid, linear interpolation; the
                       signal and the labels in one gather launch
xflip / yflip          time-reverse (labels too) / negate
amplitude_scaling      ``x * (1 + sigma * N(0, 1))``
drop (RandomMask)      rank of per-point uniforms (a stable argsort of a
                       stable argsort) below a per-sample count
cutout                 span mask zeroes the signal; labels there become 0
shift (RandomShift)    slope-1 gather ``out[j] = x[j -/+ s]``, zero-padded:
                       one pair launch with labels, one lerp without
random_baseline_shift  per-lead median x random span x signed scale
adaptive_powerline     50 or 60 Hz at half the 5-95 percentile range
*_noise                whole-window sine / square / white noise
partial_*_noise        the noise placed in a random span, the wave restarted
                       at its start (a slope-1 gather over a doubled wave)
standardize            per-sample z-norm over (lead, time), zero-guarded
RandomApply            per-sample gate; the inner op runs on the whole batch
RandAugment            per-sample Gumbel top-k N-of-K, per-op prob gate,
                       magnitude ``level`` applied like ``set_level``
=====================  =======================================================

The gathers go through the gather kernel (``ops/gather1d.py``), and a
gated op (RandomApply, a RandAugment member) launches every step whether
or not a sample takes it, as in the JAX package. Host-only ops (filters,
crops, resampling, ``to_tensor``, per-lead standardize) answer ``None``
here as there, and :func:`plan_device_augment` keeps their chains on the
host.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from ..parallel.dist import global_rows
from .gather1d import monotonic_gather, monotonic_gather_pair
from .select import exact_quantiles

MAX_LEVEL = 10  # RandAugment magnitude scale (transforms.py set_level)

def _rand(gen: torch.Generator, shape) -> torch.Tensor:
    return global_rows(lambda s: torch.rand(s, generator=gen,
                                            device=gen.device), shape)


def _randn(gen: torch.Generator, shape) -> torch.Tensor:
    return global_rows(lambda s: torch.randn(s, generator=gen,
                                             device=gen.device), shape)


def _gumbel(gen: torch.Generator, shape) -> torch.Tensor:
    tiny = torch.finfo(torch.float32).tiny
    return -torch.log(-torch.log(_rand(gen, shape).clamp_min(tiny)))


def _div(a: torch.Tensor, b: float) -> torch.Tensor:
    """``a / b`` rounded once, as the JAX op divides. On CUDA, PyTorch turns
    a tensor over a Python number into a multiply by the number's
    reciprocal, which is an ulp off for some elements; a tensor divisor
    keeps the division."""
    a = a.float()
    return a / torch.full(a.shape, b, dtype=a.dtype, device=a.device)


def standardize_batch(x: torch.Tensor) -> torch.Tensor:
    """Per-sample z-norm over (lead, time); zeros where the (population)
    std is 0."""
    axes = tuple(range(1, x.dim()))
    loc = x.mean(dim=axes, keepdim=True)
    scale = x.std(dim=axes, correction=0, keepdim=True)
    return torch.where(scale != 0,
                       (x - loc) / torch.where(scale == 0, 1.0, scale), 0.0)


# ---------------------------------------------------------------------------
# Random resize crop
# ---------------------------------------------------------------------------


def sample_resize_crop(gen: torch.Generator, b: int, scale_min: float = 0.5,
                       scale_max: float = 2.0) -> Dict[str, torch.Tensor]:
    """Per-sample scale ratio in ``[scale_min, scale_max)`` and a uniform
    for the crop start."""
    return {"ratio": _rand(gen, (b,)) * (scale_max - scale_min) + scale_min,
            "u_start": _rand(gen, (b,))}


def random_resize_crop_apply(draws: Dict[str, torch.Tensor], x: torch.Tensor,
                             y: Optional[torch.Tensor] = None,
                             target_length: Optional[int] = None,
                             scale_min: float = 0.5, scale_max: float = 2.0):
    """Batched RandomResizeCrop: resized length ``s = floor(T·ratio)``, the
    content at ``[left_pad, left_pad + s)`` of a ``max(T, s)`` canvas, a
    ``T`` window from ``start``. Output position ``j`` reads original time
    ``(start + j − left_pad) · T / s``: linear interpolation for the signal,
    nearest on the reference's ``linspace(0, T−1, s)`` grid for labels, zero
    outside the content."""
    del scale_max  # consumed by sample_resize_crop
    b, c, t = x.shape
    target_length = target_length or t
    if target_length != t:
        raise ValueError("random_resize_crop on the device keeps the "
                         f"length: target_length {target_length} != {t}")
    ratio = draws["ratio"].to(x.device)
    u_start = draws["u_start"].to(x.device)
    s = torch.floor(t * ratio).to(torch.int32)            # resized length
    canvas = torch.clamp(s, min=t)
    left_pad = torch.clamp((t - s) // 2, min=0)
    start = (u_start * (canvas - t + 1).float()).to(torch.int32)
    start = torch.minimum(start, canvas - t)

    j = torch.arange(t, device=x.device, dtype=torch.int32)[None, :]
    coord = start[:, None] + j - left_pad[:, None]
    inside = (coord >= 0) & (coord < s[:, None])
    # a Python number over a tensor is reciprocal-then-multiply in PyTorch
    # (Tensor.__rtruediv__); the JAX op divides, so divide tensor by tensor
    sf = s[:, None].float()
    t_orig = coord.float() * (torch.full_like(sf, t) / sf)
    t_orig = torch.clamp(t_orig, 0.0, t - 1)
    if y is None:
        s_min = max(int(t * scale_min), 1)
        x_out = monotonic_gather(x.contiguous(), t_orig.contiguous(),
                                 max_slope=t / s_min)
        y_out = None
    else:
        denom = torch.clamp(s - 1, min=1).float()[:, None]
        y_coord = coord.float() * (torch.full_like(denom, t - 1) / denom)
        yi = torch.clamp(torch.round(y_coord).to(torch.int32), 0, t - 1)
        # the signal and the labels in one kernel launch
        x_out, y_out = monotonic_gather_pair(
            x.contiguous(), t_orig.contiguous(), y.contiguous(),
            yi.contiguous())
        y_out = torch.where(inside, y_out, 0)
    return torch.where(inside[:, None, :], x_out, 0.0), y_out


def random_resize_crop_batch(gen: torch.Generator, x: torch.Tensor,
                             y: Optional[torch.Tensor] = None,
                             target_length: Optional[int] = None,
                             scale_min: float = 0.5, scale_max: float = 2.0):
    draws = sample_resize_crop(gen, x.shape[0], scale_min, scale_max)
    return random_resize_crop_apply(draws, x, y, target_length, scale_min,
                                    scale_max)


# ---------------------------------------------------------------------------
# Shared randomness helpers
# ---------------------------------------------------------------------------


def sample_span(gen: torch.Generator, b: int) -> Dict[str, torch.Tensor]:
    return {"u_count": _rand(gen, (b,)), "u_start": _rand(gen, (b,))}


def _uniform_span(draws: Dict[str, torch.Tensor], t: int, ratio: float,
                  device: torch.device):
    """Random contiguous span per sample: ``count = int(u·ratio·T)`` capped
    at ``T``, ``start = int(u'·(T − count))``. Returns (mask (B, T) float,
    start (B,), count (B,))."""
    u_count = draws["u_count"].to(device)
    u_start = draws["u_start"].to(device)
    count = torch.clamp((u_count * ratio * t).to(torch.int32), max=t)
    start = (u_start * (t - count).float()).to(torch.int32)
    j = torch.arange(t, device=device)
    mask = ((j[None, :] >= start[:, None])
            & (j[None, :] < (start + count)[:, None])).float()
    return mask, start, count


# ---------------------------------------------------------------------------
# Device op registry
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class DeviceOp:
    """One batched augmentation over (B, C, T) signals and (B, T) labels
    (y may be None): ``sample(generator, shape) -> draws`` and
    ``apply(draws, x, y) -> (x, y)``."""

    sample: Callable
    apply: Callable
    label_changeable: bool = False


def _signal_only(sample: Callable, fn: Callable) -> DeviceOp:
    return DeviceOp(sample=sample,
                    apply=lambda draws, x, y, _fn=fn: (_fn(draws, x), y))


def _noise_level(kwargs: Dict[str, Any], level: Optional[int]):
    """amplitude and freq after a RandAugment magnitude
    (transforms._Noise.set_level: amplitude = level/10, freq = 0.5 /
    (level/10))."""
    if level is None:
        return kwargs.get("amplitude", 1.0), kwargs.get("freq", 0.5)
    frac = level / MAX_LEVEL
    return frac * 1.0, 0.5 / max(frac, 1e-9)


def _wave(name: str, t: int, amplitude: float, freq: float,
          device: torch.device) -> torch.Tensor:
    """Deterministic (1, 1, T) waveform for sine/square noise."""
    tt = _div(torch.arange(t, device=device), t)
    if name == "sine":
        w = torch.sin(_div(2 * math.pi * tt, freq))
    else:  # square: +1 for phase in [0, pi), -1 in [pi, 2*pi)
        w = torch.where(_div(tt, freq) % 1.0 < 0.5, 1.0, -1.0)
    return (amplitude * w)[None, None, :]


def _make_noise_op(kind: str, partial: bool, kwargs: Dict[str, Any],
                   level: Optional[int]) -> DeviceOp:
    amplitude, freq = _noise_level(kwargs, level)
    ratio = kwargs.get("ratio", 0.5)
    if level is not None:
        ratio = level / MAX_LEVEL * 0.5  # _RandomPartialNoise.set_level

    def sample(gen, shape):
        draws = sample_span(gen, shape[0]) if partial else {}
        draws["normal"] = _randn(gen, shape) if kind == "white" else None
        return draws

    def noise(draws, x):
        b, c, t = x.shape
        if kind == "white":
            n = amplitude * draws["normal"].to(x.device)
        else:
            n = _wave(kind, t, amplitude, freq, x.device).expand(b, c, t)
        if not partial:
            return x + n
        mask, start, _ = _uniform_span(draws, t, ratio, x.device)
        if kind != "white":
            # the reference writes noise[:, :count] into the span, so the
            # wave restarts at phase 0 there: a circular roll by start,
            # read as one monotone slope-1 map over the doubled wave
            j = torch.arange(t, device=x.device)[None, :]
            pos = (j - start[:, None] + t).float()
            n = monotonic_gather(torch.cat([n, n], dim=2), pos.contiguous(),
                                 max_slope=1.0)
        return x + n * mask[:, None, :]

    return _signal_only(sample, noise)


def _shift_apply(draws, x, y, ratio: float):
    """``out[j] = in[j − s]`` for a signed per-sample shift ``s``, zero
    where ``j − s`` leaves the window: one slope-1 gather launch of the
    signal, or of the signal and the labels together."""
    b, c, t = x.shape
    amount = (draws["u_amount"].to(x.device) * ratio * t).to(torch.int32)
    right = draws["u_right"].to(x.device) < 0.5
    signed = torch.where(right, amount, -amount)[:, None]
    j = torch.arange(t, device=x.device, dtype=torch.int32)[None, :]
    src = j - signed
    valid = (src >= 0) & (src < t)
    src = torch.clamp(src, 0, t - 1)
    pos = src.float().contiguous()
    if y is None:
        xg = monotonic_gather(x.contiguous(), pos, max_slope=1.0)
    else:
        xg, yg = monotonic_gather_pair(x.contiguous(), pos, y.contiguous(),
                                       src.contiguous())
        y = torch.where(valid, yg, 0)
    return torch.where(valid[:, None, :], xg, 0.0), y


def _drop_apply(draws, x, ratio: float):
    """Zero ``count`` points per sample, a choice without replacement: the
    points whose rank among the sample's uniforms is below ``count`` (a
    stable sort, as ``jnp.argsort``, so ties rank alike)."""
    t = x.shape[-1]
    max_count = max(int(t * ratio), 1)
    count = (draws["u_count"].to(x.device) * max_count).to(torch.int32)
    u = draws["u"].to(x.device)
    order = torch.argsort(u, dim=1, stable=True)
    rank = torch.argsort(order, dim=1, stable=True)
    return x * (rank >= count[:, None])[:, None, :]


def _cutout_apply(draws, x, y, ratio: float):
    mask, _, _ = _uniform_span(draws, x.shape[-1], ratio, x.device)
    x = x * (1.0 - mask[:, None, :])
    if y is not None:
        y = torch.where(mask.bool(), 0, y)  # cut labels become background
    return x, y


def _baseline_apply(draws, x, ratio: float, scale: float):
    """The per-lead median, times a signed uniform amount, added over a
    random span."""
    background, = exact_quantiles(x, (50.0,))
    mask, _, _ = _uniform_span(draws, x.shape[-1], ratio, x.device)
    sign = 1.0 - 2.0 * (draws["u_sign"].to(x.device) < 0.5).float()
    amt = draws["u_amount"].to(x.device) * scale * sign
    return x + background * amt[:, None, None] * mask[:, None, :]


def _make_device_op(name: str, kwargs: Dict[str, Any],
                    level: Optional[int] = None) -> Optional[DeviceOp]:
    """Device equivalent of one transform config entry; ``None`` for an op
    that only exists on the host. ``level`` is the RandAugment magnitude,
    which overrides the statistical knobs as ``Transform.set_level`` does."""
    kwargs = dict(kwargs or {})

    if name in ("amplitude_scaling", "AmplitudeScaling"):
        sigma = kwargs.get("sigma", 0.5)
        if level is not None:
            sigma = level / MAX_LEVEL * 0.5

        def amp(draws, x, sigma=sigma):
            return x * (1.0 + sigma * draws["normal"].to(x.device))

        return _signal_only(lambda gen, shape: {"normal": _randn(gen, shape)},
                            amp)

    if name in ("adaptive_powerline_noise", "AdaptivePowerlineNoise"):
        op_fs = kwargs.get("fs", 500)

        def powerline(draws, x, op_fs=op_fs):
            t = x.shape[-1]
            lo, hi = exact_quantiles(x, (5.0, 95.0))
            mains = torch.where(draws["u"].to(x.device) < 0.5, 50.0, 60.0)
            tt = _div(torch.arange(t, device=x.device), op_fs)[None, None, :]
            return x + 0.5 * (hi - lo) * torch.sin(2 * math.pi * mains * tt)

        return _signal_only(
            lambda gen, shape: {"u": _rand(gen, (shape[0], 1, 1))}, powerline)

    if name in ("xflip", "XFlip"):
        def xflip(draws, x, y):
            return (torch.flip(x, dims=(-1,)),
                    None if y is None else torch.flip(y, dims=(-1,)))

        return DeviceOp(sample=lambda gen, shape: None, apply=xflip,
                        label_changeable=True)

    if name in ("yflip", "YFlip"):
        return _signal_only(lambda gen, shape: None, lambda draws, x: -x)

    if name in ("drop", "RandomMask"):
        ratio = kwargs.get("mask_ratio", 0.3)
        return _signal_only(
            lambda gen, shape: {"u_count": _rand(gen, (shape[0],)),
                                "u": _rand(gen, (shape[0], shape[-1]))},
            lambda draws, x, ratio=ratio: _drop_apply(draws, x, ratio))

    if name in ("cutout", "Cutout"):
        ratio = kwargs.get("mask_ratio", 0.3)
        return DeviceOp(
            sample=lambda gen, shape: sample_span(gen, shape[0]),
            apply=lambda draws, x, y, ratio=ratio: _cutout_apply(
                draws, x, y, ratio),
            label_changeable=True)

    if name in ("shift", "RandomShift"):
        ratio = kwargs.get("mask_ratio", 0.3)
        # jax.random.bernoulli(k, 0.5, (b,)) is uniform(k, (b,)) < 0.5
        return DeviceOp(
            sample=lambda gen, shape: {"u_amount": _rand(gen, (shape[0],)),
                                       "u_right": _rand(gen, (shape[0],))},
            apply=lambda draws, x, y, ratio=ratio: _shift_apply(
                draws, x, y, ratio),
            label_changeable=True)

    if name in ("random_baseline_shift", "RandomBaselineShift"):
        ratio = kwargs.get("ratio", 0.5)
        scale = kwargs.get("scale", 3.0)
        if level is not None:
            ratio = level / MAX_LEVEL * 0.5
            scale = level / MAX_LEVEL * 3.0

        def sample(gen, shape):
            draws = sample_span(gen, shape[0])
            draws["u_sign"] = _rand(gen, (shape[0],))
            draws["u_amount"] = _rand(gen, (shape[0],))
            return draws

        return _signal_only(
            sample, lambda draws, x, ratio=ratio, scale=scale:
            _baseline_apply(draws, x, ratio, scale))

    noise_kinds = {"sine_noise": ("sine", False), "SineNoise": ("sine", False),
                   "square_noise": ("square", False),
                   "SquareNoise": ("square", False),
                   "white_noise": ("white", False),
                   "WhiteNoise": ("white", False),
                   "partial_sine_noise": ("sine", True),
                   "RandomPartialSineNoise": ("sine", True),
                   "partial_square_noise": ("square", True),
                   "RandomPartialSquareNoise": ("square", True),
                   "partial_white_noise": ("white", True),
                   "RandomPartialWhiteNoise": ("white", True)}
    if name in noise_kinds:
        return _make_noise_op(*noise_kinds[name], kwargs, level)

    if name in ("standardize", "Standardize"):
        axis = kwargs.get("axis", (-1, -2))
        axis = tuple(axis) if isinstance(axis, (list, tuple)) else (axis,)
        if sorted(axis) != [-2, -1]:
            return None  # per-lead schemas stay on the host, as in JAX
        return _signal_only(lambda gen, shape: None,
                            lambda draws, x: standardize_batch(x))

    if name in ("random_resize_crop", "RandomResizeCrop"):
        scale_min = kwargs.get("scale_min", 0.5)
        scale_max = kwargs.get("scale_max", 2.0)

        def rrc(draws, x, y, rrc_kwargs=kwargs):
            return random_resize_crop_apply(draws, x, y, **rrc_kwargs)

        return DeviceOp(
            sample=lambda gen, shape: sample_resize_crop(
                gen, shape[0], scale_min, scale_max),
            apply=rrc, label_changeable=True)

    if name == "RandomApply":
        inner_entry = kwargs.get("transform")
        prob = kwargs.get("prob", 0.5)
        if inner_entry is None:
            return None
        inner = _make_device_op(*_entry_name_kwargs(inner_entry), level)
        if inner is None:
            return None

        def rapply(draws, x, y, inner=inner, prob=prob):
            gate = draws["u_gate"].to(x.device) < prob
            xi, yi = inner.apply(draws["op"], x, y)
            x = torch.where(gate[:, None, None], xi, x)
            if y is not None and yi is not None:
                y = torch.where(gate[:, None], yi, y)
            return x, y

        return DeviceOp(
            sample=lambda gen, shape, inner=inner: {
                "u_gate": _rand(gen, (shape[0],)),
                "op": inner.sample(gen, shape)},
            apply=rapply, label_changeable=inner.label_changeable)

    if name == "RandAugment":
        ops_cfg = kwargs.get("ops")
        if not ops_cfg:
            return None
        ra_level = kwargs.get("level", 10)
        num_layers = kwargs.get("num_layers", 2)
        prob = kwargs.get("prob", 0.5)
        members: List[DeviceOp] = []
        for entry in ops_cfg:
            ename, ekwargs = _entry_name_kwargs(entry)
            op = _make_device_op(ename, ekwargs, level=ra_level)
            if op is None:
                return None
            members.append(op)

        def sample(gen, shape, members=members):
            k = len(members)
            return {"gumbel": _gumbel(gen, (shape[0], k)),
                    "u_prob": _rand(gen, (shape[0], k)),
                    "ops": [m.sample(gen, shape) for m in members]}

        def ra(draws, x, y, members=members, num_layers=num_layers,
               prob=prob):
            return _rand_augment(draws, x, y, members, num_layers, prob)

        return DeviceOp(
            sample=sample, apply=ra,
            label_changeable=any(m.label_changeable for m in members))

    return None  # host-only op (filters, crops, resample, to_tensor, ...)


def _rand_augment(draws, x, y, ops: List[DeviceOp], num_layers: int,
                  prob: float):
    """Per-sample N-of-K RandAugment (transforms.py:628-657): the
    ``num_layers`` largest Gumbel draws pick distinct ops, each gated by
    ``prob``; every op runs on the whole batch and is blended in where it
    applies."""
    gumbel = draws["gumbel"].to(x.device)
    u_prob = draws["u_prob"].to(x.device)
    k = len(ops)
    threshold = torch.sort(gumbel, dim=1).values[:, k - num_layers][:, None]
    applied = (gumbel >= threshold) & (u_prob < prob)
    for i, op in enumerate(ops):
        xi, yi = op.apply(draws["ops"][i], x, y)
        x = torch.where(applied[:, i, None, None], xi, x)
        if y is not None and yi is not None:
            y = torch.where(applied[:, i, None], yi, y)
    return x, y


def _sample_chain(gen, ops: List[DeviceOp], shape) -> list:
    return [op.sample(gen, shape) for op in ops]


def _apply_chain(draws: list, ops: List[DeviceOp], x, y=None):
    for d, op in zip(draws, ops):
        x, y = op.apply(d, x, y)
    return x, y


def _entry_name_kwargs(entry) -> Tuple[str, Dict[str, Any]]:
    if isinstance(entry, str):
        return entry, {}
    name, kwargs = list(entry.items())[0]
    return name, (kwargs or {})


def _build_chain(cfg_list) -> Optional[List[DeviceOp]]:
    """Device ops for a whole transform chain, or None if an entry exists
    only on the host (that chain then runs on the host)."""
    ops = []
    for entry in cfg_list or []:
        name, kwargs = _entry_name_kwargs(entry)
        op = _make_device_op(name, kwargs)
        if op is None:
            return None
        ops.append(op)
    return ops


# ---------------------------------------------------------------------------
# Pipeline split planning
# ---------------------------------------------------------------------------

_TO_TENSOR_ONLY = [{"to_tensor": {"dtype": "float"}}]


@dataclass
class DeviceAugPlan:
    """How ``device_augment: true`` splits a dataset config.

    ``labeled_overrides`` / ``unlabeled_overrides`` are merged over the
    dataset config for the *train* datasets (evaluation keeps the host
    path). ``sample(generator, batch) -> draws`` and ``apply(draws, batch)
    -> batch`` are the device stage, and ``augment(generator, batch)`` the
    two in turn; all three are None when everything stays on the host."""

    labeled_overrides: Dict[str, Any] = field(default_factory=dict)
    unlabeled_overrides: Dict[str, Any] = field(default_factory=dict)
    sample: Optional[Callable] = None
    apply: Optional[Callable] = None
    summary: str = "host-only"

    @property
    def augment(self) -> Optional[Callable]:
        if self.apply is None:
            return None
        return lambda gen, batch: self.apply(self.sample(gen, batch), batch)


def plan_device_augment(dataset_cfg: Dict[str, Any]) -> DeviceAugPlan:
    """Split the augmentation pipeline between host and device, branch by
    branch, with the JAX package's rules (the strong view builds on the
    weak view, semi_dataset.py:240-243):

    - weak chain on the device: labeled and unlabeled ship raw signals;
    - weak on the host, strong on the device: the unlabeled branch ships
      the host-weak view before standardize;
    - strong on the host, weak on the device: the unlabeled branch stays
      wholly on the host; the labeled one still runs on the device;
    - ``transforms`` other than standardize/to_tensor: all on the host.
    """
    aug_cfg = dataset_cfg.get("augmentations") or []
    strong_cfg = dataset_cfg.get("strong_augmentations") or []
    transforms_cfg = dataset_cfg.get("transforms") or _TO_TENSOR_ONLY

    final_ops = _build_chain([
        e for e in transforms_cfg
        if _entry_name_kwargs(e)[0] != "to_tensor"
    ])
    if final_ops is None:
        return DeviceAugPlan(summary="host-only (unsupported transforms)")

    weak_ops = _build_chain(aug_cfg)
    strong_ops = _build_chain(strong_cfg) if strong_cfg else []
    weak_dev = weak_ops is not None
    strong_dev = strong_ops is not None and bool(strong_cfg)

    labeled_device = weak_dev
    unlab_weak_device = weak_dev and (strong_dev or not strong_cfg)
    device_strong = strong_dev

    labeled_overrides: Dict[str, Any] = {}
    unlabeled_overrides: Dict[str, Any] = {}
    if labeled_device:
        labeled_overrides = {
            "augmentations": None,
            # the labeled view's strong branch is never consumed
            "strong_augmentations": None,
            "transforms": _TO_TENSOR_ONLY,
        }
    if unlab_weak_device:
        unlabeled_overrides = {
            "augmentations": None,
            "strong_augmentations": None,
            "transforms": _TO_TENSOR_ONLY,
        }
    elif device_strong:
        # the host computes the weak view but must not standardize it: the
        # device builds the strong view on top, then standardizes both
        unlabeled_overrides = {
            "strong_augmentations": None,
            "transforms": _TO_TENSOR_ONLY,
        }

    unlab_final_device = unlab_weak_device or device_strong
    if not (labeled_device or unlab_final_device):
        return DeviceAugPlan(summary="host-only (unsupported augmentations)")

    def sample(gen, batch: Dict[str, torch.Tensor]) -> Dict[str, list]:
        """The draws of one step, in the JAX package's six key streams
        (labeled weak, unlabeled weak, strong, and the final transforms of
        each view)."""
        draws: Dict[str, list] = {}
        if labeled_device and "ecg" in batch:
            shape = tuple(batch["ecg"].shape)
            draws["lab"] = _sample_chain(gen, weak_ops, shape)
            draws["fl"] = _sample_chain(gen, final_ops, shape)
        if "ecg_u_w" in batch and unlab_final_device:
            shape = tuple(batch["ecg_u_w"].shape)
            if unlab_weak_device:
                draws["unlab"] = _sample_chain(gen, weak_ops, shape)
            draws["fu"] = _sample_chain(gen, final_ops, shape)
            if device_strong:
                draws["strong"] = _sample_chain(gen, strong_ops, shape)
                draws["fs"] = _sample_chain(gen, final_ops, shape)
        return draws

    def apply(draws: Dict[str, list],
              batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        out = dict(batch)
        if labeled_device and "ecg" in batch:
            x, y = _apply_chain(draws["lab"], weak_ops, batch["ecg"],
                                batch.get("target"))
            # the final transforms are signal-only (dataset.get parity)
            out["ecg"], _ = _apply_chain(draws["fl"], final_ops, x)
            if y is not None:
                out["target"] = y
        if "ecg_u_w" in batch and unlab_final_device:
            u = batch["ecg_u_w"]
            if unlab_weak_device:
                u, _ = _apply_chain(draws["unlab"], weak_ops, u)
            out["ecg_u_w"], _ = _apply_chain(draws["fu"], final_ops, u)
            if device_strong:
                # the strong view derives from the weak view before the
                # final transforms (semi_dataset.py:240-243)
                u_s, _ = _apply_chain(draws["strong"], strong_ops, u)
                out["ecg_u_s"], _ = _apply_chain(draws["fs"], final_ops, u_s)
        return out

    parts = ["weak=device" if weak_dev else "weak=host"]
    if strong_cfg:
        parts.append("strong=device" if device_strong else "strong=host")
    if weak_dev and strong_cfg and not device_strong:
        parts.append("unlabeled=host (strong chain unsupported)")
    return DeviceAugPlan(
        labeled_overrides=labeled_overrides,
        unlabeled_overrides=unlabeled_overrides,
        sample=sample, apply=apply, summary=", ".join(parts))
