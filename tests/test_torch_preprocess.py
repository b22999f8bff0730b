"""The port's device augmentation against the JAX package's, on the CPU.

PyTorch and JAX generators give different numbers, so each port op takes
its random draws as an argument (``DeviceOp.sample`` / ``DeviceOp.apply``).
Here the draws are made with the same ``jax.random`` calls, on the same
keys and split in the same order, as the JAX op makes them
(:func:`jax_op_draws` mirrors ``semi_seg_ecg_tpu/ops/preprocess.py``), and
handed to the port's ``apply``. The JAX gathers run their Pallas kernel in
interpret mode; the port's run the kernel's plain version.

Tolerances: labels and integer geometry exactly; signals within atol 1e-5
/ rtol 1e-5 (a ``sin`` from another library, the gather's one-ulp lerp
rounding, a standardize that divides by a std summed in another order).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from semi_seg_ecg_tpu.ops import preprocess as jax_pre
from semi_seg_ecg_tpu.ops.pallas import gather1d as jax_gather
from semi_seg_ecg_tpu_torch.ops import gather1d
from semi_seg_ecg_tpu_torch.ops import preprocess as pre

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, T = 4, 300
RA_OPS = [{"AmplitudeScaling": {"sigma": 0.5}},
          {"AdaptivePowerlineNoise": {"fs": 250}},
          {"RandomPartialWhiteNoise": {"amplitude": 1, "ratio": 0.5}},
          {"RandomPartialSineNoise": {"amplitude": 1, "ratio": 0.5}}]
PARTIAL = {"partial_sine_noise", "RandomPartialSineNoise",
           "partial_square_noise", "RandomPartialSquareNoise",
           "partial_white_noise", "RandomPartialWhiteNoise"}


@pytest.fixture(autouse=True)
def interpret_impl(monkeypatch):
    monkeypatch.setattr(jax_gather, "GATHER_IMPL", "interpret")


def jax_op_draws(name, kwargs, key, shape, level=None):
    """The draws the JAX op ``name`` makes from ``key``, as the port's
    ``apply`` takes them."""
    b = shape[0]
    kwargs = kwargs or {}
    if name in ("amplitude_scaling", "AmplitudeScaling"):
        return {"normal": jax.random.normal(key, shape)}
    if name in ("adaptive_powerline_noise", "AdaptivePowerlineNoise"):
        return {"u": jax.random.uniform(key, (b, 1, 1))}
    if name in PARTIAL:
        k1, k2 = jax.random.split(key)
        k_count, k_start = jax.random.split(k2)  # _uniform_span
        white = "white" in name.lower()
        return {"u_count": jax.random.uniform(k_count, (b,)),
                "u_start": jax.random.uniform(k_start, (b,)),
                "normal": jax.random.normal(k1, shape) if white else None}
    if name in ("standardize", "Standardize", "xflip", "XFlip", "yflip",
                "YFlip", "sine_noise", "SineNoise", "square_noise",
                "SquareNoise"):
        return None
    if name in ("white_noise", "WhiteNoise"):
        k1, _ = jax.random.split(key)
        return {"normal": jax.random.normal(k1, shape)}
    if name in ("drop", "RandomMask"):
        k1, k2 = jax.random.split(key)
        return {"u_count": jax.random.uniform(k1, (b,)),
                "u": jax.random.uniform(k2, (b, shape[-1]))}
    if name in ("cutout", "Cutout"):
        return span_draws(key, b)
    if name in ("shift", "RandomShift"):
        # bernoulli(k, 0.5, (b,)) is uniform(k, (b,)) < 0.5
        k1, k2 = jax.random.split(key)
        return {"u_amount": jax.random.uniform(k1, (b,)),
                "u_right": jax.random.uniform(k2, (b,))}
    if name in ("random_baseline_shift", "RandomBaselineShift"):
        k1, k2, k3 = jax.random.split(key, 3)
        return {**span_draws(k1, b), "u_sign": jax.random.uniform(k2, (b,)),
                "u_amount": jax.random.uniform(k3, (b,))}
    if name == "RandomApply":
        k_gate, k_op = jax.random.split(key)
        return {"u_gate": jax.random.uniform(k_gate, (b,)),
                "op": jax_op_draws(*pre._entry_name_kwargs(
                    kwargs["transform"]), k_op, shape, level)}
    if name in ("random_resize_crop", "RandomResizeCrop"):
        k_ratio, k_start = jax.random.split(key)
        return {"ratio": jax.random.uniform(
                    k_ratio, (b,), minval=kwargs.get("scale_min", 0.5),
                    maxval=kwargs.get("scale_max", 2.0)),
                "u_start": jax.random.uniform(k_start, (b,))}
    if name == "RandAugment":
        ops = kwargs["ops"]
        k_sel, k_prob, k_ops = jax.random.split(key, 3)
        op_keys = jax.random.split(k_ops, len(ops))
        return {"gumbel": jax.random.gumbel(k_sel, (b, len(ops))),
                "u_prob": jax.random.uniform(k_prob, (b, len(ops))),
                "ops": [jax_op_draws(*pre._entry_name_kwargs(e), k, shape,
                                     level=kwargs.get("level", 10))
                        for e, k in zip(ops, op_keys)]}
    raise AssertionError(f"no draws written for {name}")


def span_draws(key, b):
    """``_uniform_span``'s two uniforms."""
    k_count, k_start = jax.random.split(key)
    return {"u_count": jax.random.uniform(k_count, (b,)),
            "u_start": jax.random.uniform(k_start, (b,))}


def jax_chain_draws(entries, key, shape):
    """``_apply_chain``'s key split, op by op."""
    if not entries:
        return []
    return [jax_op_draws(*pre._entry_name_kwargs(e), k, shape)
            for e, k in zip(entries, jax.random.split(key, len(entries)))]


def to_torch(tree):
    if isinstance(tree, dict):
        return {k: to_torch(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_torch(v) for v in tree]
    if tree is None:
        return None
    return torch.from_numpy(np.array(tree))


def signal(seed, b=B, c=1, t=T):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, c, t)).astype(np.float32)
    y = rng.integers(0, 4, (b, t)).astype(np.int32)
    return x, y


def assert_signal_close(ours, theirs):
    np.testing.assert_allclose(np.asarray(ours), np.asarray(theirs),
                               atol=1e-5, rtol=1e-5)


SHIPPED_OPS = [
    ("random_resize_crop", {"target_length": T, "scale_min": 0.5,
                            "scale_max": 2.0}, None),
    ("standardize", {"axis": [-1, -2]}, None),
    ("AmplitudeScaling", {"sigma": 0.5}, None),
    ("AmplitudeScaling", {"sigma": 0.5}, 10),
    ("AdaptivePowerlineNoise", {"fs": 250}, None),
    ("RandomPartialWhiteNoise", {"amplitude": 1, "ratio": 0.5}, 10),
    ("RandomPartialSineNoise", {"amplitude": 1, "ratio": 0.5}, 10),
    ("RandomPartialSineNoise", {"amplitude": 0.5, "ratio": 0.3,
                                "freq": 0.2}, None),
    ("partial_square_noise", {"ratio": 0.4}, 7),
]


def assert_op_matches_jax(name, kwargs, level=None, seed=0, key=11):
    """The port's ``apply`` under the JAX op's draws equals the JAX op:
    signals within 1e-5, labels exactly, ``label_changeable`` equal."""
    x, y = signal(seed)
    key = jax.random.key(key)
    jop = jax_pre._make_device_op(name, kwargs, level)
    op = pre._make_device_op(name, kwargs, level)
    assert op.label_changeable == jop.label_changeable
    jx, jy = jop.apply(key, jnp.asarray(x), jnp.asarray(y))
    draws = to_torch(jax_op_draws(name, kwargs, key, x.shape, level))
    tx, ty = op.apply(draws, torch.from_numpy(x), torch.from_numpy(y).long())
    assert tx.shape == x.shape and tx.dtype == torch.float32
    assert_signal_close(tx, jx)
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
    assert ty.dtype == torch.int64
    return tx, ty


@pytest.mark.parametrize("name,kwargs,level", SHIPPED_OPS,
                         ids=[f"{n}-{lv}" for n, _, lv in SHIPPED_OPS])
def test_op_matches_jax_under_injected_draws(name, kwargs, level):
    assert_op_matches_jax(name, kwargs, level)


# the device ops ported after the shipped chains', each with and without a
# RandAugment level where the JAX op has a level override
NEW_OPS = [
    ("yflip", {}, None),
    ("YFlip", {}, 10),
    ("drop", {"mask_ratio": 0.3}, None),
    ("RandomMask", {"mask_ratio": 0.6}, 10),
    ("XFlip", {}, 10),
    ("Cutout", {"mask_ratio": 0.5}, 10),
    ("RandomShift", {"mask_ratio": 0.5}, 10),
    ("random_baseline_shift", {"ratio": 0.4, "scale": 2.0}, None),
    ("RandomBaselineShift", {}, 7),
    ("sine_noise", {"amplitude": 0.5, "freq": 0.2}, None),
    ("SineNoise", {}, 10),
    ("square_noise", {"amplitude": 2.0, "freq": 0.3}, None),
    ("SquareNoise", {}, 4),
    ("white_noise", {"amplitude": 0.5}, None),
    ("WhiteNoise", {}, 10),
    ("RandomApply", {"transform": {"shift": {"mask_ratio": 0.4}},
                     "prob": 0.5}, None),
    ("RandomApply", {"transform": "RandomBaselineShift", "prob": 0.7}, 10),
]


@pytest.mark.parametrize("name,kwargs,level", NEW_OPS,
                         ids=[f"{n}-{lv}" for n, _, lv in NEW_OPS])
def test_new_op_matches_jax(name, kwargs, level):
    tx, _ = assert_op_matches_jax(name, kwargs, level)
    x, _ = signal(0)
    # every op changes the signal, and a gate leaves some samples as they
    # were and changes others
    changed = (tx.numpy() != x).any(axis=(1, 2))
    assert changed.any()
    if name == "RandomApply":
        assert not changed.all()


def test_drop_ranks_ties_alike():
    """Tied uniforms rank in index order on both sides (a stable sort), so
    the same points are dropped."""
    x, _ = signal(8)
    key = jax.random.key(2)
    draws = jax_op_draws("drop", {"mask_ratio": 0.5}, key, x.shape)
    u = np.round(np.asarray(draws["u"]) * 8) / 8   # many ties
    b = x.shape[0]
    draws = {"u_count": draws["u_count"], "u": jnp.asarray(u)}
    # the JAX op's own arithmetic on the tied uniforms
    max_count = int(T * 0.5)
    count = (np.asarray(draws["u_count"]) * max_count).astype(np.int32)
    rank = np.asarray(jnp.argsort(jnp.argsort(draws["u"], axis=1), axis=1))
    want = x * (rank >= count[:, None])[:, None, :]
    got = pre._make_device_op("drop", {"mask_ratio": 0.5}).apply(
        to_torch(draws), torch.from_numpy(x), None)[0]
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got.numpy() == 0).sum(axis=(1, 2)).tolist() == count.tolist()
    assert b == B


def test_shift_gathers_once_per_call(monkeypatch):
    """Shift takes the signal and the labels in one pair call (one kernel
    launch on the card), the signal alone in one ``monotonic_gather``."""
    calls = []
    for name in ("monotonic_gather", "monotonic_gather_pair"):
        real = getattr(pre, name)
        monkeypatch.setattr(pre, name, lambda *a, _f=real, _n=name, **k: (
            calls.append(_n), _f(*a, **k))[1])
    x, y = signal(9)
    op = pre._make_device_op("shift", {"mask_ratio": 0.5})
    draws = op.sample(torch.Generator().manual_seed(0), x.shape)
    tx, ty = op.apply(draws, torch.from_numpy(x), torch.from_numpy(y).long())
    assert calls == ["monotonic_gather_pair"]
    tx_alone, none = op.apply(draws, torch.from_numpy(x), None)
    assert calls == ["monotonic_gather_pair", "monotonic_gather"]
    assert none is None and torch.equal(tx_alone, tx)


@pytest.mark.parametrize("name,kwargs", [
    ("AdaptivePowerlineNoise", {"fs": 250}),
    ("RandomPartialSineNoise", {"amplitude": 1, "ratio": 0.5}),
    ("partial_square_noise", {"ratio": 0.5, "freq": 0.3})])
def test_noise_ops_match_jax_at_the_recipe_length(name, kwargs):
    """2,500 samples at 250 Hz: the powerline's sin takes arguments up to
    2 pi 60 x 10, where one ulp of the time grid (k / fs, a division, not a
    multiply by 1 / fs) moves the noise by ~4e-4."""
    x, _ = signal(6, t=2500)
    key = jax.random.key(13)
    jx, _ = jax_pre._make_device_op(name, kwargs, 10).apply(
        key, jnp.asarray(x), None)
    draws = to_torch(jax_op_draws(name, kwargs, key, x.shape, 10))
    tx, _ = pre._make_device_op(name, kwargs, 10).apply(
        draws, torch.from_numpy(x), None)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=1e-5,
                               rtol=1e-5)


def test_resize_crop_geometry_is_exact():
    """Integer geometry (resized length, pad, start) and the labels are
    exact, and every output sample outside the content is 0 on both
    sides; the scale range covers both shrink and stretch."""
    x, y = signal(1, b=8)
    key = jax.random.key(3)
    kw = {"target_length": T, "scale_min": 0.5, "scale_max": 2.0}
    jx, jy = jax_pre.random_resize_crop_batch(key, jnp.asarray(x),
                                              jnp.asarray(y), **kw)
    draws = to_torch(jax_op_draws("random_resize_crop", kw, key, x.shape))
    ratio = draws["ratio"].numpy()
    assert (ratio < 1).any() and (ratio > 1).any()
    before = gather1d.LAUNCHES
    tx, ty = pre.random_resize_crop_apply(draws, torch.from_numpy(x),
                                          torch.from_numpy(y).long(), **kw)
    assert gather1d.LAUNCHES == before  # CPU tensors: the plain version
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
    np.testing.assert_array_equal(tx.numpy() == 0, np.asarray(jx) == 0)
    assert_signal_close(tx, jx)
    with pytest.raises(ValueError, match="keeps the length"):
        pre.random_resize_crop_apply(draws, torch.from_numpy(x),
                                     target_length=T // 2)


def test_resize_crop_gathers_once_per_call(monkeypatch):
    """With labels, the signal and the labels go through one pair call (one
    kernel launch on the card); without, the signal through one
    ``monotonic_gather``, to the same signal."""
    calls = []
    for name in ("monotonic_gather", "monotonic_gather_pair"):
        real = getattr(pre, name)
        monkeypatch.setattr(pre, name, lambda *a, _f=real, _n=name, **k: (
            calls.append(_n), _f(*a, **k))[1])
    x, y = signal(7, b=6)
    draws = pre.sample_resize_crop(torch.Generator().manual_seed(0), 6)
    tx, ty = pre.random_resize_crop_apply(draws, torch.from_numpy(x),
                                          torch.from_numpy(y).long())
    assert calls == ["monotonic_gather_pair"]
    tx_alone, none = pre.random_resize_crop_apply(draws, torch.from_numpy(x))
    assert calls == ["monotonic_gather_pair", "monotonic_gather"]
    assert none is None and torch.equal(tx_alone, tx)
    assert ty.dtype == torch.int64 and ty.shape == (6, T)


def test_rand_augment_selection_matches_jax():
    """N-of-K selection and the prob gate: with every member op at work,
    the whole RandAugment output agrees sample by sample, and the number
    of ops each sample saw is the JAX package's."""
    x, _ = signal(2, b=16)
    kwargs = {"ops": RA_OPS, "level": 10, "num_layers": 3, "prob": 0.5}
    key = jax.random.key(5)
    jop = jax_pre._make_device_op("RandAugment", kwargs)
    op = pre._make_device_op("RandAugment", kwargs)
    jx, _ = jop.apply(key, jnp.asarray(x), None)
    draws = to_torch(jax_op_draws("RandAugment", kwargs, key, x.shape))
    tx, _ = op.apply(draws, torch.from_numpy(x), None)
    assert_signal_close(tx, jx)
    gumbel, u_prob = draws["gumbel"], draws["u_prob"]
    selected = gumbel >= torch.sort(gumbel, dim=1).values[:, 1:2]
    assert (selected.sum(dim=1) == 3).all()
    applied = (selected & (u_prob < 0.5)).sum(dim=1)
    assert set(applied.tolist()) > {0}  # some samples changed, some not
    unchanged = (tx.numpy() == x).all(axis=(1, 2))
    np.testing.assert_array_equal(unchanged, applied.numpy() == 0)


def fixmatch_dataset_cfg(length=T):
    with open(os.path.join(REPO, "configs", "base", "vit_tiny",
                           "fixmatch.yaml")) as f:
        ds = yaml.safe_load(f)["dataset"]
    ds = dict(ds, device_augment=True)
    ds["augmentations"] = [{"random_resize_crop": dict(
        ds["augmentations"][0]["random_resize_crop"], target_length=length)}]
    return ds


def test_fixmatch_augment_matches_jax():
    """The shipped FixMatch chain end to end: six key streams (labeled
    weak, unlabeled weak, strong, and each view's standardize), the strong
    view built on the weak one."""
    ds = fixmatch_dataset_cfg()
    x, y = signal(3)
    u, _ = signal(4)
    batch = {"ecg": x, "target": y, "ecg_u_w": u}
    key = jax.random.key(7)
    theirs = jax_pre.plan_device_augment(ds).augment(
        key, {k: jnp.asarray(v) for k, v in batch.items()})
    k_lab, k_unlab, k_strong, k_fl, k_fu, k_fs = jax.random.split(key, 6)
    shape = x.shape
    final = [e for e in ds["transforms"] if "to_tensor" not in e]
    draws = to_torch({
        "lab": jax_chain_draws(ds["augmentations"], k_lab, shape),
        "fl": jax_chain_draws(final, k_fl, shape),
        "unlab": jax_chain_draws(ds["augmentations"], k_unlab, shape),
        "fu": jax_chain_draws(final, k_fu, shape),
        "strong": jax_chain_draws(ds["strong_augmentations"], k_strong,
                                  shape),
        "fs": jax_chain_draws(final, k_fs, shape)})
    plan = pre.plan_device_augment(ds)
    ours = plan.apply(draws, {"ecg": torch.from_numpy(x),
                              "target": torch.from_numpy(y).long(),
                              "ecg_u_w": torch.from_numpy(u)})
    assert set(ours) == set(theirs) == {"ecg", "target", "ecg_u_w",
                                        "ecg_u_s"}
    np.testing.assert_array_equal(ours["target"].numpy(),
                                  np.asarray(theirs["target"]))
    for k in ("ecg", "ecg_u_w", "ecg_u_s"):
        assert_signal_close(ours[k], theirs[k])
    # the port's own draws: the same structure, reproducible from a seed
    torch_batch = {"ecg": torch.from_numpy(x),
                   "target": torch.from_numpy(y).long(),
                   "ecg_u_w": torch.from_numpy(u)}
    gen = torch.Generator().manual_seed(0)
    a = plan.augment(gen, torch_batch)
    b = plan.augment(gen.manual_seed(0), torch_batch)
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
        assert a[k].shape == ours[k].shape and a[k].dtype == ours[k].dtype


@pytest.mark.parametrize("backbone", ["vit_tiny", "resnet18"])
@pytest.mark.parametrize("recipe", ["fixmatch", "scratch"])
def test_plan_matches_jax_for_shipped_configs(backbone, recipe):
    with open(os.path.join(REPO, "configs", "base", backbone,
                           f"{recipe}.yaml")) as f:
        ds = dict(yaml.safe_load(f)["dataset"], device_augment=True)
    ours, theirs = pre.plan_device_augment(ds), jax_pre.plan_device_augment(ds)
    assert ours.summary == theirs.summary
    assert ours.labeled_overrides == theirs.labeled_overrides
    assert ours.unlabeled_overrides == theirs.unlabeled_overrides
    assert (ours.augment is None) == (theirs.augment is None)


def test_standardize_is_population_std():
    x, _ = signal(5, c=3)
    x[1] = 2.5  # a constant sample standardizes to 0
    theirs = np.asarray(jax_pre.standardize_batch(jnp.asarray(x)))
    ours = pre.standardize_batch(torch.from_numpy(x)).numpy()
    assert (ours[1] == 0).all()
    np.testing.assert_allclose(ours, theirs, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("entry", [
    "xflip", {"cutout": {"mask_ratio": 0.3}}, {"shift": {}},
    {"RandomApply": {"transform": "yflip"}}, {"sine_noise": {}},
    {"RandAugment": {"ops": ["AmplitudeScaling", "YFlip"]}}])
def test_unported_ops_raise(entry):
    """The six ops the port once refused as not yet ported: each now
    matches the JAX op under its draws, and a weak chain of it runs on the
    device in both packages' plans."""
    name, kwargs = pre._entry_name_kwargs(entry)
    assert_op_matches_jax(name, kwargs)
    ds = dict(fixmatch_dataset_cfg(), augmentations=[entry])
    ours, theirs = pre.plan_device_augment(ds), jax_pre.plan_device_augment(ds)
    assert ours.summary == theirs.summary == "weak=device, strong=device"
    assert ours.labeled_overrides == theirs.labeled_overrides


NEW_OP_CHAINS = {
    "augmentations": [
        {"random_resize_crop": {"target_length": T}},
        {"RandomApply": {"transform": {"RandomShift": {"mask_ratio": 0.3}},
                         "prob": 0.5}},
        "xflip", {"cutout": {"mask_ratio": 0.2}}],
    "strong_augmentations": [{"RandAugment": {
        "ops": [{"AmplitudeScaling": {"sigma": 0.5}}, "RandomShift",
                "Cutout", "YFlip", "RandomMask", "RandomBaselineShift",
                "SineNoise", "SquareNoise", "WhiteNoise",
                {"RandomPartialSineNoise": {"ratio": 0.5}},
                {"RandomApply": {"transform": "XFlip"}}],
        "level": 6, "num_layers": 4, "prob": 0.7}}],
}


def test_new_op_chains_match_jax():
    """A FixMatch dataset config whose chains use the newly ported ops:
    both packages plan it alike (summary, overrides), and the whole
    augmentation, under the JAX draws of its six key streams, matches."""
    ds = dict(fixmatch_dataset_cfg(), **NEW_OP_CHAINS)
    ours, theirs = pre.plan_device_augment(ds), jax_pre.plan_device_augment(ds)
    assert ours.summary == theirs.summary == "weak=device, strong=device"
    assert ours.labeled_overrides == theirs.labeled_overrides
    assert ours.unlabeled_overrides == theirs.unlabeled_overrides
    x, y = signal(10)
    u, _ = signal(11)
    key = jax.random.key(17)
    want = theirs.augment(key, {"ecg": jnp.asarray(x), "target": jnp.asarray(y),
                                "ecg_u_w": jnp.asarray(u)})
    k_lab, k_unlab, k_strong, k_fl, k_fu, k_fs = jax.random.split(key, 6)
    final = [e for e in ds["transforms"] if "to_tensor" not in e]
    weak, strong = ds["augmentations"], ds["strong_augmentations"]
    draws = to_torch({
        "lab": jax_chain_draws(weak, k_lab, x.shape),
        "fl": jax_chain_draws(final, k_fl, x.shape),
        "unlab": jax_chain_draws(weak, k_unlab, x.shape),
        "fu": jax_chain_draws(final, k_fu, x.shape),
        "strong": jax_chain_draws(strong, k_strong, x.shape),
        "fs": jax_chain_draws(final, k_fs, x.shape)})
    got = ours.apply(draws, {"ecg": torch.from_numpy(x),
                             "target": torch.from_numpy(y).long(),
                             "ecg_u_w": torch.from_numpy(u)})
    np.testing.assert_array_equal(got["target"].numpy(),
                                  np.asarray(want["target"]))
    for k in ("ecg", "ecg_u_w", "ecg_u_s"):
        assert_signal_close(got[k], want[k])


def test_host_only_ops_stay_on_the_host():
    for name, kwargs in (("highpass_filter", {"fs": 250, "cutoff": 0.67}),
                         ("random_crop", {"length": 100}),
                         ("standardize", {"axis": -1})):
        assert jax_pre._make_device_op(name, kwargs) is None
        assert pre._make_device_op(name, kwargs) is None
    ds = dict(fixmatch_dataset_cfg(),
              transforms=[{"standardize": {"axis": -1}}])
    assert pre.plan_device_augment(ds).summary == \
        jax_pre.plan_device_augment(ds).summary == \
        "host-only (unsupported transforms)"
