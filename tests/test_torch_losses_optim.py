"""The port's losses, metrics, lr schedule and optimizer against the JAX
package's, on the CPU.

Losses: the same fp32 logits and labels (some out of range, which the JAX
package's one-hot pick scores 0) through both; fp32 within atol 1e-6 /
rtol 1e-6 (one log-softmax, sums in another order). Metrics: the per-sample
counts are integers and equal exactly; ``MeanIoU`` over them equal to 1e-12.
Optimizer: K = 5 updates of ``torch.optim`` against the optax chain of
``build_optimizer`` on identical gradients, parameters within 1e-6 absolute
(about 1e-3 of the largest lr; fp32 Adam arithmetic in another order); the
lr of every update equals ``make_lr_schedule``'s at the pre-increment count.
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from semi_seg_ecg_tpu.ops import losses as jax_losses
from semi_seg_ecg_tpu.ops import metrics as jax_metrics
from semi_seg_ecg_tpu.utils.optimizer import build_optimizer as jax_optimizer
from semi_seg_ecg_tpu.utils.optimizer import make_lr_schedule as jax_schedule
from semi_seg_ecg_tpu_torch.ops import losses, metrics
from semi_seg_ecg_tpu_torch.utils.optimizer import (
    build_optimizer,
    make_lr_schedule,
    resolve_lr,
)


def logits_labels(seed, b=3, c=4, t=50, out_of_range=True):
    rng = np.random.default_rng(seed)
    logits = (3 * rng.standard_normal((b, c, t))).astype(np.float32)
    labels = rng.integers(0, c, (b, t)).astype(np.int32)
    if out_of_range:
        labels[0, :3] = [-1, c, c + 5]
    return logits, labels


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_matches_jax(reduction, masked):
    logits, labels = logits_labels(0)
    mask = (np.random.default_rng(1).uniform(size=labels.shape) < 0.6
            ).astype(np.float32) if masked else None
    theirs = np.asarray(jax_losses.cross_entropy(
        jnp.asarray(logits), jnp.asarray(labels), reduction,
        None if mask is None else jnp.asarray(mask)))
    ours = losses.cross_entropy(
        torch.from_numpy(logits), torch.from_numpy(labels).long(), reduction,
        None if mask is None else torch.from_numpy(mask)).numpy()
    assert ours.shape == theirs.shape
    np.testing.assert_allclose(ours, theirs, atol=1e-6, rtol=1e-6)
    if reduction == "none":
        assert (ours[0, :3] == 0).all()  # out-of-range labels score 0


def test_soft_and_per_sample_cross_entropy_match_jax():
    logits, labels = logits_labels(2, out_of_range=False)
    q = np.random.default_rng(3).dirichlet(np.ones(4), (3, 50)).transpose(
        0, 2, 1).astype(np.float32)
    mask = np.random.default_rng(4).uniform(size=(3, 50)).astype(np.float32)
    for reduction in ("mean", "sum", "none"):
        theirs = np.asarray(jax_losses.soft_cross_entropy(
            jnp.asarray(logits), jnp.asarray(q), reduction,
            jnp.asarray(mask)))
        ours = losses.soft_cross_entropy(
            torch.from_numpy(logits), torch.from_numpy(q), reduction,
            torch.from_numpy(mask)).numpy()
        np.testing.assert_allclose(ours, theirs, atol=1e-6, rtol=1e-6)
    theirs = np.asarray(jax_losses.per_sample_cross_entropy(
        jnp.asarray(logits), jnp.asarray(labels)))
    ours = losses.per_sample_cross_entropy(
        torch.from_numpy(logits), torch.from_numpy(labels).long()).numpy()
    assert ours.shape == (3,)
    np.testing.assert_allclose(ours, theirs, atol=1e-6, rtol=1e-6)


def test_cross_entropy_is_fp32_under_bf16_autocast():
    logits, labels = logits_labels(5, out_of_range=False)
    x = torch.from_numpy(logits).bfloat16()
    with torch.autocast("cpu", dtype=torch.bfloat16):
        loss = losses.cross_entropy(x, torch.from_numpy(labels).long())
    assert loss.dtype == torch.float32
    want = losses.cross_entropy(x.float(), torch.from_numpy(labels).long())
    torch.testing.assert_close(loss, want, rtol=0, atol=0)


def test_segmentation_stats_and_metrics_match_jax():
    rng = np.random.default_rng(6)
    cfg = {"task": "segmentation", "num_classes": 4,
           "target_metrics": ["MeanIoU", "DiceScore",
                              {"MeanIoU": {"per_class": True}}]}
    preds = rng.integers(0, 4, (6, 200)).astype(np.int32)
    labels = rng.integers(0, 4, (6, 200)).astype(np.int32)
    labels[0] = 2  # classes absent from a sample: union 0 scores 0
    theirs = [np.asarray(a) for a in jax_metrics.segmentation_stats(
        jnp.asarray(preds), jnp.asarray(labels), 4)]
    ours = [a.numpy() for a in metrics.segmentation_stats(
        torch.from_numpy(preds).long(), torch.from_numpy(labels).long(), 4)]
    for a, b in zip(ours, theirs):
        assert a.dtype == np.int32
        np.testing.assert_array_equal(a, b)
    ours_fn, ours_best = metrics.build_metric_fn(cfg)
    theirs_fn, theirs_best = jax_metrics.build_metric_fn(cfg)
    assert ours_best == theirs_best
    for lo in (0, 3):  # two eval batches of 3
        sel = slice(lo, lo + 3)
        ours_fn.update(*(a[sel] for a in ours))
        theirs_fn.update(*(a[sel] for a in theirs))
    got = metrics.flatten_metric_dict(ours_fn.compute())
    want = jax_metrics.flatten_metric_dict(theirs_fn.compute())
    assert got.keys() == want.keys()
    for k in got:
        assert got[k] == pytest.approx(want[k], abs=1e-12), k
    assert metrics.is_best_metric(ours_fn["MeanIoU"], 0.1, 0.2)


def train_cfg(optimizer, max_norm=None, warmup_epochs=1, **kwargs):
    return {"optimizer": optimizer, "lr": 1e-3, "min_lr": 1e-4,
            "epochs": 4, "warmup_epochs": warmup_epochs,
            "weight_decay": 0.05, "max_norm": max_norm,
            "optimizer_kwargs": kwargs}


class Params(torch.nn.Module):
    def __init__(self, arrays):
        super().__init__()
        for name, a in arrays.items():
            self.register_parameter(name,
                                    torch.nn.Parameter(torch.from_numpy(a)))


@pytest.mark.parametrize("optimizer,kwargs", [
    ("adamw", {"betas": [0.9, 0.95]}),
    ("sgd", {"momentum": 0.9}),
])
@pytest.mark.parametrize("max_norm", [None, 1.0])
def test_optimizer_steps_match_optax(optimizer, kwargs, max_norm):
    rng = np.random.default_rng(7)
    arrays = {"w": rng.standard_normal((8, 5)).astype(np.float32),
              "b": rng.standard_normal(5).astype(np.float32)}
    steps_per_epoch = 2
    cfg = {"train": train_cfg(optimizer, max_norm, **kwargs)}
    model = Params(arrays)
    opt = build_optimizer(cfg, model, steps_per_epoch)
    tx = jax_optimizer(cfg, None, steps_per_epoch)
    params = {k: jnp.asarray(v) for k, v in arrays.items()}
    state = tx.init(params)
    schedule = jax_schedule(cfg["train"], steps_per_epoch)
    clipped = False
    for step in range(5):
        grads = {k: (2 * rng.standard_normal(v.shape)).astype(np.float32)
                 for k, v in arrays.items()}
        norm = np.sqrt(sum((g.astype(np.float64) ** 2).sum()
                           for g in grads.values()))
        clipped |= max_norm is not None and norm > max_norm
        for name, p in model.named_parameters():
            p.grad = torch.from_numpy(grads[name].copy())
        opt.step()
        assert opt.optimizer.param_groups[0]["lr"] == pytest.approx(
            float(schedule(step)), rel=1e-12)
        updates, state = tx.update({k: jnp.asarray(g) for k, g in
                                    grads.items()}, state, params)
        params = optax.apply_updates(params, updates)
        for name, p in model.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(),
                                       np.asarray(params[name]), rtol=0,
                                       atol=1e-6, err_msg=f"{name} step "
                                                          f"{step}")
        if step == 0:
            # warmup: optax reads the schedule at count 0, so lr is 0 and
            # nothing moves (AdamW's decay is scaled by the lr too)
            for name, p in model.named_parameters():
                np.testing.assert_array_equal(p.detach().numpy(),
                                              arrays[name])
    assert clipped == (max_norm is not None)


def test_lr_schedule_matches_jax():
    cfg = train_cfg("adamw", warmup_epochs=1.5)
    ours, theirs = make_lr_schedule(cfg, 7), jax_schedule(cfg, 7)
    for step in range(0, 7 * 4 + 1):
        assert ours(step) == pytest.approx(float(theirs(step)), rel=1e-6,
                                           abs=1e-12)
    assert ours(0) == 0.0 and ours(7 * 4) == pytest.approx(1e-4)


def test_resolve_lr_and_unported_options():
    config = {"dataloader": {"batch_size": 16},
              "train": {"lr": None, "blr": 0.016}}
    resolve_lr(config)
    assert config["train"]["lr"] == pytest.approx(1e-3)
    assert config["train"]["eff_batch_size"] == 16
    # layer decay and freezing (ported; tests/test_torch_optim_options.py
    # holds them on real models): without a backbone, layer decay is
    # refused as the JAX package refuses it (no depth), and freezing
    # freezes nothing, as the JAX mask, so one step equals optax's
    arrays = {"w": np.full((2, 3), 0.5, np.float32)}
    model = Params({"w": arrays["w"].copy()})
    with pytest.raises(ValueError, match="depth"):
        build_optimizer({"train": dict(train_cfg("adamw"),
                                       layer_decay=0.75)}, model, 1)
    with pytest.raises(AssertionError, match="depth"):
        jax_optimizer({"train": dict(train_cfg("adamw"), layer_decay=0.75)},
                      {"w": jnp.asarray(arrays["w"])}, 1)
    cfg = {"train": train_cfg("adamw", warmup_epochs=0),
           "mode": "freeze_backbone"}
    opt = build_optimizer(cfg, model, 1)
    tx = jax_optimizer(cfg, {"w": jnp.asarray(arrays["w"])}, 1)
    grad = np.linspace(-1, 1, 6, dtype=np.float32).reshape(2, 3)
    model.w.grad = torch.from_numpy(grad.copy())
    opt.step()
    params = {"w": jnp.asarray(arrays["w"])}
    updates, _ = tx.update({"w": jnp.asarray(grad)}, tx.init(params), params)
    np.testing.assert_allclose(
        model.w.detach().numpy(),
        np.asarray(optax.apply_updates(params, updates)["w"]), atol=1e-7)
    with pytest.raises(ValueError, match="Unknown optimizer"):
        build_optimizer({"train": train_cfg("lamb")}, model, 1)
