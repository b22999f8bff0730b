"""Config-driven 1-D signal transform / augmentation library (host-side NumPy).

Capability parity with the reference library (src/utils/transforms.py:11-770):
the same 25 ops, the same ``MAPPING`` config keys, the same recursive config
parser with ``RandomApply`` / ``RandAugment`` / class-name fallback — but
redesigned for a batched device training loop:

- **Explicit RNG.** Every random op draws from a ``numpy.random.Generator``
  passed per call instead of the global ``np.random`` state. The dataset
  derives one generator per (seed, epoch, sample) so results are reproducible
  and order-independent — the discipline a multi-host input pipeline needs.
- **Pure outputs.** No op mutates its input arrays.
- **Static shapes.** Every op maps ``(C, T) -> (C, T')`` with ``T'`` known
  from config, so batches always have one static shape.

All ops operate on ``float`` arrays shaped ``(C, T)`` (C=leads); label arrays
are integer ``(C, T)``. Ops that may change labels are marked
``label_changeable`` (transforms.py:315-332 parity).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
from scipy.interpolate import interp1d
from scipy.signal import butter, resample as _scipy_resample, sosfiltfilt, square

from . import native


def _fourier_resample(x: np.ndarray, m: int, axis: int = 1) -> np.ndarray:
    """scipy.signal.resample. scipy's pocketfft (C++, SIMD) outperforms the
    native Bluestein fallback in native/ecgdata.cpp, so the library kernel
    (validated bit-close in tests/test_native.py) only serves environments
    without scipy."""
    try:
        return _scipy_resample(x, m, axis=axis)
    except NameError:  # pragma: no cover - scipy always present here
        return native.resample_fourier(x, m)


def _label_resample(y: np.ndarray, m: int, kind: str) -> np.ndarray:
    """interp1d(kind)(linspace(0, n-1, m)) with native acceleration."""
    if y.ndim == 2 and kind in ("nearest", "zero"):
        out = native.resample_labels(y, m, kind)
        if out is not None:
            return out
    f = interp1d(np.arange(y.shape[1]), y, axis=1, kind=kind,
                 fill_value="extrapolate")
    return f(np.linspace(0, y.shape[1] - 1, m))

__all__ = [
    "AdaptivePowerlineNoise",
    "AmplitudeScaling",
    "CenterCrop",
    "Compose",
    "Cutout",
    "HighpassFilter",
    "LowpassFilter",
    "MovingWindowCrop",
    "NCrop",
    "RandAugment",
    "RandomApply",
    "RandomBaselineShift",
    "RandomCrop",
    "RandomMask",
    "RandomPartialSineNoise",
    "RandomPartialSquareNoise",
    "RandomPartialWhiteNoise",
    "RandomResizeCrop",
    "RandomShift",
    "Resample",
    "SineNoise",
    "SOSFilter",
    "SquareNoise",
    "Standardize",
    "ToTensor",
    "WhiteNoise",
    "XFlip",
    "YFlip",
    "get_transforms_from_config",
]


def _ensure_rng(rng: Optional[np.random.Generator]) -> np.random.Generator:
    return rng if rng is not None else np.random.default_rng()


class Transform:
    """Base: ``__call__(x, y=None, rng=None)`` returns x or (x, y)."""

    label_changeable = False

    def __call__(self, x, y=None, rng=None):
        rng = _ensure_rng(rng)
        if y is not None:
            if self.label_changeable:
                return self._apply(rng, x, y)
            return self._apply(rng, x), y
        return self._apply(rng, x)

    def _apply(self, rng, x, y=None):
        raise NotImplementedError

    def set_level(self, level: int, max_level: int = 10) -> None:
        """RandAugment magnitude hook (transforms.py:334-335 parity)."""


# ---------------------------------------------------------------------------
# Preprocessing
# ---------------------------------------------------------------------------


class Resample(Transform):
    """Resample to a target length or sampling rate (transforms.py:47-80).

    ``method='fourier'`` matches ``scipy.signal.resample``; ``method='interp'``
    with ``kind='zero'``/``'nearest'`` is the label path (zero-order hold).
    """

    def __init__(self, target_length=None, target_fs=None, method="fourier",
                 kind="nearest"):
        self.target_length, self.target_fs = target_length, target_fs
        self.method, self.kind = method, kind

    def _resample(self, x: np.ndarray, m: int) -> np.ndarray:
        return (_fourier_resample(x, m, axis=1) if self.method == "fourier"
                else _label_resample(x, m, self.kind))

    def __call__(self, x, fs=None, rng=None):
        """fs-aware when the second argument is a sampling rate (the
        dataset prefix path); label-joint when it is an array (``resample``
        used inside an augmentation/crop pipeline, where Compose passes
        labels positionally)."""
        if isinstance(fs, np.ndarray):
            y = fs
            x = self(x)
            y_len = self.target_length or x.shape[1]
            return x, _label_resample(y, y_len, "nearest").astype(y.dtype)
        needs_fs_change = fs and self.target_fs and fs != self.target_fs
        if needs_fs_change:
            return self._resample(x, int(x.shape[1] * self.target_fs / fs))
        if self.target_length and x.shape[1] != self.target_length:
            return self._resample(x, self.target_length)
        return x


class RandomResizeCrop(Transform):
    """Random time-scale (Fourier) then pad+crop back to ``target_length``
    (transforms.py:82-127). Labels are resized with nearest interpolation."""

    label_changeable = True

    def __init__(self, target_length: int, scale_min: float = 0.5,
                 scale_max: float = 2.0):
        self.target_length = target_length
        self.scale_min, self.scale_max = scale_min, scale_max

    def _apply(self, rng, x, y=None):
        sig_len = x.shape[1]
        ratio = rng.uniform(self.scale_min, self.scale_max)
        size = int(sig_len * ratio)

        x_resized = _fourier_resample(x, size, axis=1)
        if y is not None:
            y_resized = _label_resample(y, size, "nearest")

        pad = self.target_length - size
        if pad > 0:
            left, right = pad // 2, pad - pad // 2
            x_resized = np.pad(x_resized, ((0, 0), (left, right)))
            if y is not None:
                y_resized = np.pad(y_resized, ((0, 0), (left, right)))

        start = rng.integers(0, x_resized.shape[1] - self.target_length + 1)
        x_crop = x_resized[:, start:start + self.target_length]
        if y is not None:
            y_crop = y_resized[:, start:start + self.target_length]
            return x_crop, y_crop
        return x_crop


class _WindowCrop(Transform):
    """Joint signal/label window extraction (transforms.py:129-192)."""

    label_changeable = True

    def __init__(self, crop_length: int):
        self.crop_length = crop_length

    def _as_lead_major(self, x, y=None):
        """Promote 1-D inputs to (1, T) and validate the x/y pairing."""
        if x.ndim == 1:
            x = x[None, :]
        elif x.ndim > 2:
            raise ValueError(
                f"signal must be 1-D or 2-D; got shape {x.shape}")
        seq_len = x.shape[1]
        if self.crop_length > seq_len:
            raise ValueError(
                f"cannot take a {self.crop_length}-sample window from a "
                f"length-{seq_len} signal")
        if y is not None:
            if y.ndim == 1:
                y = y[None, :]
            elif y.ndim > 2:
                raise ValueError(
                    f"label must be 1-D or 2-D; got shape {y.shape}")
            if y.shape[1] != seq_len:
                raise ValueError(
                    f"signal/label lengths differ: {x.shape} vs {y.shape}")
        return x, y

    def _take_windows(self, start_idx, x, y=None):
        if isinstance(start_idx, (int, np.integer)):
            start_idx = [int(start_idx)]
        windows = [x[:, i:i + self.crop_length] for i in start_idx]
        x_crop = windows[0] if len(windows) == 1 else np.stack(windows)
        if y is not None:
            lwin = [y[:, i:i + self.crop_length] for i in start_idx]
            y_crop = lwin[0] if len(lwin) == 1 else np.stack(lwin)
            return x_crop, y_crop
        return x_crop


class RandomCrop(_WindowCrop):
    def _apply(self, rng, x, y=None):
        x, y = self._as_lead_major(x, y)
        start = int(rng.integers(0, x.shape[1] - self.crop_length + 1))
        return self._take_windows(start, x, y)


class CenterCrop(_WindowCrop):
    def _apply(self, rng, x, y=None):
        x, y = self._as_lead_major(x, y)
        start = (x.shape[1] - self.crop_length) // 2
        return self._take_windows(start, x, y)


class MovingWindowCrop(_WindowCrop):
    def __init__(self, crop_length: int, crop_stride: int):
        super().__init__(crop_length)
        self.crop_stride = crop_stride

    def _apply(self, rng, x, y=None):
        x, y = self._as_lead_major(x, y)
        starts = np.arange(0, x.shape[1] - self.crop_length + 1,
                           self.crop_stride)
        return self._take_windows(starts, x, y)


class NCrop(_WindowCrop):
    def __init__(self, crop_length: int, num_segments: int):
        super().__init__(crop_length)
        self.num_segments = num_segments

    def _apply(self, rng, x, y=None):
        x, y = self._as_lead_major(x, y)
        seq_len = x.shape[1]
        gap = seq_len - self.crop_length
        # degenerate geometries (1 segment, or more segments than spare
        # samples) fall back to evenly spaced starts instead of a
        # zero-step np.arange crash
        if self.num_segments <= 1 or gap <= 0:
            starts = np.array([max(gap, 0) // 2])
        else:
            step = gap // (self.num_segments - 1)
            if step < 1:
                starts = np.unique(
                    np.linspace(0, gap, self.num_segments).astype(np.int64))
            else:
                starts = np.arange(0, gap + 1, step)
        return self._take_windows(starts, x, y)


class SOSFilter(Transform):
    """Zero-phase Butterworth SOS filter (transforms.py:259-272)."""

    def __init__(self, fs: int, cutoff: float, order: int = 5,
                 btype: str = "highpass"):
        self.sos = butter(order, cutoff, btype=btype, fs=fs, output="sos")

    def _apply(self, rng, x, y=None):
        if x.ndim == 2:
            out = native.sosfiltfilt(self.sos, x)
            if out is not None:
                return out
        return np.ascontiguousarray(sosfiltfilt(self.sos, x))


class HighpassFilter(SOSFilter):
    def __init__(self, fs: int, cutoff: float, order: int = 5):
        super().__init__(fs, cutoff, order, btype="highpass")


class LowpassFilter(SOSFilter):
    def __init__(self, fs: int, cutoff: float, order: int = 5):
        super().__init__(fs, cutoff, order, btype="lowpass")


class Standardize(Transform):
    """Z-normalise; exact zero where std == 0 (transforms.py:290-310)."""

    def __init__(self, axis: Union[int, Tuple[int, ...], List[int]] = (-1, -2)):
        self.axis = tuple(axis) if isinstance(axis, list) else axis

    def _apply(self, rng, x, y=None):
        if self.axis in ((-1, -2), (-2, -1)) and x.ndim == 2:
            out = native.standardize(x)
            if out is not None:
                return out
        mu = x.mean(axis=self.axis, keepdims=True)
        sd = x.std(axis=self.axis, keepdims=True)
        return np.divide(x - mu, sd, out=np.zeros_like(x), where=sd != 0)


# ---------------------------------------------------------------------------
# Augmentations — signal manipulation
# ---------------------------------------------------------------------------


class AmplitudeScaling(Transform):
    """Per-point Gaussian amplitude jitter (transforms.py:340-351)."""

    def __init__(self, sigma: float = 0.5):
        self.sigma = sigma

    def _apply(self, rng, x, y=None):
        return x * rng.normal(1.0, self.sigma, size=x.shape)

    def set_level(self, level, max_level=10):
        self.sigma = level / max_level * 0.5


class XFlip(Transform):
    """Time-reverse signal (and label) (transforms.py:353-366)."""

    label_changeable = True

    def _apply(self, rng, x, y=None):
        x = np.flip(x, axis=1)
        if y is not None:
            return x, np.flip(y, axis=1)
        return x


class YFlip(Transform):
    """Negate amplitude (transforms.py:368-372)."""

    def _apply(self, rng, x, y=None):
        return -x


class _Mask(Transform):
    def __init__(self, mask_ratio: float = 0.3):
        self.mask_ratio = mask_ratio


class RandomMask(_Mask):
    """Zero out random sample points (transforms.py:384-392)."""

    def _apply(self, rng, x, y=None):
        out = x.copy()
        count = int(rng.integers(0, max(int(x.shape[-1] * self.mask_ratio), 1)))
        idx = rng.choice(x.shape[-1], size=count, replace=False)
        out[:, idx] = 0
        return out


class Cutout(_Mask):
    """Zero a contiguous span of signal and label (transforms.py:394-407).
    The reference sets the cut label region to class 0 (background); we keep
    that semantic."""

    label_changeable = True

    def _apply(self, rng, x, y=None):
        out = x.copy()
        count = int(rng.uniform(0, self.mask_ratio) * x.shape[-1])
        start = int(rng.integers(0, x.shape[-1] - count))
        out[:, start:start + count] = 0
        if y is not None:
            y = y.copy()
            y[:, start:start + count] = 0
            return out, y
        return out


class RandomShift(_Mask):
    """Shift left/right with zero padding (transforms.py:409-433)."""

    label_changeable = True

    def _shift(self, a, shift, direction):
        out = a.copy()
        n = a.shape[-1]
        if direction == 1:
            out[:, shift:] = a[:, :n - shift]
            out[:, :shift] = 0
        else:
            out[:, :n - shift] = a[:, shift:]
            out[:, n - shift:] = 0
        return out

    def _apply(self, rng, x, y=None):
        direction = int(rng.choice([-1, 1]))
        shift = int(rng.uniform(0, self.mask_ratio) * x.shape[-1])
        x = self._shift(x, shift, direction)
        if y is not None:
            return x, self._shift(y, shift, direction)
        return x


# ---------------------------------------------------------------------------
# Augmentations — noise
# ---------------------------------------------------------------------------


class _Noise(Transform):
    def __init__(self, amplitude: float = 1.0, freq: float = 0.5):
        self.amplitude = amplitude
        self.freq = freq

    def _noise(self, rng, x):
        raise NotImplementedError

    def _apply(self, rng, x, y=None):
        return x + self._noise(rng, x)

    def set_level(self, level, max_level=10):
        frac = level / max_level
        # level 0 zeroes the amplitude, so freq is moot — guard the divide
        # (the reference raises ZeroDivisionError on this legal setting)
        self.amplitude, self.freq = frac * 1.0, 0.5 / max(frac, 1e-9)


class RandomBaselineShift(_Noise):
    """Shift a random span by a multiple of the median (transforms.py:457-478)."""

    def __init__(self, ratio: float = 0.5, scale: float = 3.0):
        self.ratio = ratio
        self.scale = scale

    def _noise(self, rng, x):
        background = np.median(x, axis=1, keepdims=True)
        count = int(rng.uniform(0, self.ratio) * x.shape[1])
        start = int(rng.integers(0, x.shape[1] - count))
        sign = 1 - 2 * int(rng.integers(2))
        shift_scale = rng.uniform(0, self.scale) * sign
        shifts = np.zeros_like(x)
        shifts[:, start:start + count] = background * shift_scale
        return shifts

    def set_level(self, level, max_level=10):
        super().set_level(level, max_level)
        frac = level / max_level
        self.ratio, self.scale = frac * 0.5, frac * 3.0


class AdaptivePowerlineNoise(_Noise):
    """50/60 Hz sine at half the robust signal range (transforms.py:480-502)."""

    def __init__(self, fs: int = 500):
        self.fs = fs

    def _noise(self, rng, x):
        t = (np.arange(x.shape[-1]) / self.fs)[None, :]
        hi, lo = (np.quantile(x, q, axis=1, keepdims=True)
                  for q in (0.95, 0.05))
        mains_hz = 50 if rng.random() < 0.5 else 60
        return 0.5 * (hi - lo) * np.sin(2 * np.pi * mains_hz * t)


class SineNoise(_Noise):
    def _noise(self, rng, x):
        t = (np.arange(x.shape[-1]) / x.shape[-1])[None, :]
        return self.amplitude * np.sin(2 * np.pi * t / self.freq)


class SquareNoise(_Noise):
    def _noise(self, rng, x):
        t = (np.arange(x.shape[-1]) / x.shape[-1])[None, :]
        return self.amplitude * square(2 * np.pi * t / self.freq)


class WhiteNoise(_Noise):
    def _noise(self, rng, x):
        return self.amplitude * rng.standard_normal(x.shape)


class _RandomPartialNoise(_Noise):
    """Apply the parent noise to a random span only (transforms.py:524-550)."""

    def __init__(self, amplitude: float = 1.0, freq: float = 0.5,
                 ratio: float = 0.5):
        super().__init__(amplitude, freq)
        self.ratio = ratio

    def _apply(self, rng, x, y=None):
        noise = self._noise(rng, x)
        count = int(rng.uniform(0, self.ratio) * x.shape[-1])
        start = int(rng.integers(0, x.shape[-1] - count))
        partial = np.zeros_like(x)
        partial[:, start:start + count] = noise[:, :count]
        return x + partial

    def set_level(self, level, max_level=10):
        super().set_level(level, max_level)
        self.ratio = level / max_level * 0.5


class RandomPartialSineNoise(_RandomPartialNoise, SineNoise):
    pass


class RandomPartialSquareNoise(_RandomPartialNoise, SquareNoise):
    pass


class RandomPartialWhiteNoise(_RandomPartialNoise, WhiteNoise):
    pass


# ---------------------------------------------------------------------------
# Composition
# ---------------------------------------------------------------------------


class RandomApply(Transform):
    def __init__(self, transform: Transform, prob: float = 0.5):
        self.transform = transform
        self.prob = prob

    def __call__(self, x, y=None, rng=None):
        rng = _ensure_rng(rng)
        if rng.random() < self.prob:
            return self.transform(x, y, rng=rng) if y is not None \
                else self.transform(x, rng=rng)
        return (x, y) if y is not None else x


class Compose(Transform):
    def __init__(self, transforms: List[Any]):
        self.transforms = transforms

    def __call__(self, x, y=None, rng=None):
        rng = _ensure_rng(rng)
        for t in self.transforms:
            if y is not None:
                x, y = t(x, y, rng=rng)
            else:
                x = t(x, rng=rng)
        return (x, y) if y is not None else x


class ToTensor(Transform):
    """Cast to the device-bound dtype. Output stays a NumPy array — arrays are
    batched and transferred to the device in one shot by the loader, which beats
    per-sample tensor conversion (transforms.py:602-623 capability parity)."""

    _DTYPES = {
        "float": np.float32,
        "double": np.float64,
        "int": np.int32,
        "long": np.int64,
    }

    def __init__(self, dtype="float"):
        if isinstance(dtype, str):
            assert dtype in self._DTYPES, f"unknown dtype name '{dtype}'"
            dtype = self._DTYPES[dtype]
        self.dtype = dtype

    def __call__(self, x, y=None, rng=None):
        if y is not None:
            return np.asarray(x, dtype=self.dtype), y
        return np.asarray(x, dtype=self.dtype)


class RandAugment(Transform):
    """N-of-K random augmentation at magnitude `level`
    (transforms.py:628-657; https://arxiv.org/abs/1909.13719)."""

    def __init__(self, ops: List[Transform], level: int = 10,
                 num_layers: int = 2, prob: float = 0.5):
        for op in ops:
            op.set_level(level=level)
        self.ops: List[RandomApply] = [RandomApply(op, prob=prob)
                                       for op in ops]
        self.num_layers, self.prob = num_layers, prob

    def __call__(self, x, y=None, rng=None):
        rng = _ensure_rng(rng)
        chosen = rng.choice(len(self.ops), size=self.num_layers, replace=False)
        for i in chosen:
            op = self.ops[int(i)]
            if y is not None:
                x, y = op(x, y, rng=rng)
            else:
                x = op(x, rng=rng)
        return (x, y) if y is not None else x


MAPPING = {
    "adaptive_powerline_noise": AdaptivePowerlineNoise,
    "amplitude_scaling": AmplitudeScaling,
    "center_crop": CenterCrop,
    "cutout": Cutout,
    "drop": RandomMask,
    "highpass_filter": HighpassFilter,
    "lowpass_filter": LowpassFilter,
    "moving_window_crop": MovingWindowCrop,
    "n_crop": NCrop,
    "random_baseline_shift": RandomBaselineShift,
    "random_crop": RandomCrop,
    "partial_sine_noise": RandomPartialSineNoise,
    "partial_square_noise": RandomPartialSquareNoise,
    "partial_white_noise": RandomPartialWhiteNoise,
    "random_resize_crop": RandomResizeCrop,
    "resample": Resample,
    "shift": RandomShift,
    "sine_noise": SineNoise,
    "sos_filter": SOSFilter,
    "square_noise": SquareNoise,
    "standardize": Standardize,
    "to_tensor": ToTensor,
    "white_noise": WhiteNoise,
    "xflip": XFlip,
    "yflip": YFlip,
}


def _split_entry(entry: Union[str, Dict[str, Any]]) -> Tuple[str, dict]:
    """A config entry is either a bare op name or ``{name: kwargs}``."""
    if isinstance(entry, str):
        return entry, {}
    if isinstance(entry, dict):
        assert len(entry) == 1, \
            "each transform entry maps exactly one name to its kwargs"
        name, kwargs = next(iter(entry.items()))
        return name, kwargs or {}
    raise ValueError(
        f"transform entries are strings or single-key dicts; got {entry!r}")


def _build_combinator(name: str, kwargs: dict) -> Transform:
    """RandomApply / RandAugment wrap recursively-parsed inner configs."""
    if name == "RandomApply":
        assert "transform" in kwargs, "RandomApply config needs 'transform'"
        assert "prob" in kwargs, "RandomApply config needs 'prob'"
        (inner,) = get_transforms_from_config([kwargs["transform"]])
        return RandomApply(inner, prob=kwargs["prob"])
    assert "ops" in kwargs, "RandAugment config needs 'ops'"
    return RandAugment(
        ops=get_transforms_from_config(kwargs["ops"]),
        level=kwargs.get("level", 10),
        num_layers=kwargs.get("num_layers", 2),
        prob=kwargs.get("prob", 0.5),
    )


def get_transforms_from_config(
    config: List[Union[str, Dict[str, Any]]]
) -> Optional[List[Transform]]:
    """Recursive config → transform-list parser (transforms.py:721-770)."""
    transforms: List[Transform] = []
    for entry in config:
        name, kwargs = _split_entry(entry)
        if name in MAPPING:
            transforms.append(MAPPING[name](**kwargs))
        elif name in ("RandomApply", "RandAugment"):
            transforms.append(_build_combinator(name, kwargs))
        elif name in globals():
            transforms.append(globals()[name](**kwargs))
        else:
            raise ValueError(f"unknown transform '{name}'")
    return transforms or None
