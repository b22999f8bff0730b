"""Sequence parallelism (``parallel.seq_parallel``) in the port, on the CPU.

Against the JAX package:

- the ring (``ops/ring_attention.py``): its plain version, s ∈ {2, 4} seq
  ranks run as threads of this process (``seq_shard.run_threads``), against the
  JAX package's ``ring_attention`` on its seq mesh of the conftest's CPU
  devices: values at n ∈ {64, 31, 101} (rtol 2e-5, atol 2e-6) and
  gradients at n = 33 (rtol 5e-4, atol 5e-6), ``tests/test_ring_attention.py``'s
  shapes and bounds, and at the shapes of its sub-blocked case;
- the split rule (``parallel/seq_shard.splits_time``) against
  ``_array_sharding``'s specs, and its warning once per length;
- one base step of two gloo ranks at ``(data 1, seq 2)`` of
  ``tests/torch_dist_worker.py`` on the global batch of 8, for the full
  ResNet18 of ``tests/test_parallel.py::test_seq_parallel_step_equals_single_device``
  and the ring ViT of
  ``tests/test_ring_attention.py::test_vit_seq_parallel_ring_step_matches_single_device``
  (at depth 2),
  against the JAX package's ``(data 4, seq 2)`` step from the same weights,
  within those tests' bounds or, as the port's AdamW locksteps hold a
  parameter whose gradient lies within rounding of zero, ``TIGHT_ATOL_LR``
  lr (the attention's key bias, whose gradient is rounding alone,
  ``PARAM_ATOL_LR`` lr); the two ranks' states are equal bit for bit.

Against the whole-tensor ops: each time-split op of ``parallel/seq_shard.py``
(convolutions of every stride, padding and dilation ResNet18 uses, the max
pool with its ties, ``avg_down``'s pool, the resize) at s ∈ {2, 3, 4} over
ResNet18's odd lengths, values and gradients within 1e-6.

The device augmentation and cache switch off with the JAX package's line
and leave the caller's config as it was; ReCo, ST++, the seq axis with
the model axis and int8 serving under it run, and the two seq ranks'
step written as a checkpoint directory by both ranks loads to the pickle
file's payload.

``slow``: the FixMatch, Mean Teacher and CPS steps of both backbones with
dropout on, two gloo ranks against one process, and ``train_main``,
``test_main`` and ``inference_main`` of a tiny recipe at seq 2.
"""

import copy
import os

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from semi_seg_ecg_tpu.algorithms.base import SPEC as JAX_BASE_SPEC
from semi_seg_ecg_tpu.algorithms.base import make_train_step as jax_step
from semi_seg_ecg_tpu.algorithms.common import build_state
from semi_seg_ecg_tpu.models import build_model_from_config as jax_build
from semi_seg_ecg_tpu.ops.ring_attention import ring_attention as jax_ring
from semi_seg_ecg_tpu.parallel import mesh as jax_mesh
from semi_seg_ecg_tpu.utils.optimizer import build_optimizer as jax_optimizer
from semi_seg_ecg_tpu_torch.algorithms import common, get_algorithm
from semi_seg_ecg_tpu_torch.ops.interpolate import linear_interpolate
from semi_seg_ecg_tpu_torch.ops.ring_attention import ring_attention
from semi_seg_ecg_tpu_torch.parallel import seq_shard
from semi_seg_ecg_tpu_torch.parallel.seq_shard import run_threads
from semi_seg_ecg_tpu_torch.utils import checkpoint as ckpt
from tests.test_parallel import _tiny_config
from tests.test_ring_attention import _vit_sp_config
from tests.test_torch_parallel_train import port_state
from tests.test_torch_resume import assert_payloads_equal
from tests.test_torch_train_slice import (
    KEY_BIAS,
    PARAM_ATOL_LR,
    TIGHT_ATOL_LR,
)
from tests.torch_dist_worker import start_ranks, wait_ranks

TIMEOUT = 240


def counts_of(n, size):
    return [b - a for a, b in (seq_shard.block(n, size, j)
                               for j in range(size))]


def port_ring(q, k, v, scale, size, g=None):
    """The port's plain ring over ``size`` thread ranks on the global
    (B, H, n, D) q, k, v: the output, and with ``g`` the gradients of
    ``(out · g).sum()``, whole."""
    n = q.shape[2]
    counts = counts_of(n, size)

    def rank(comm):
        a, b = seq_shard.block(n, size, comm.rank)
        qkv = [torch.from_numpy(t[:, :, a:b].copy()).requires_grad_()
               for t in (q, k, v)]
        out = ring_attention(*qkv, scale, counts, comm)
        if g is None:
            return out.detach(), None
        (out * torch.from_numpy(g[:, :, a:b].copy())).sum().backward()
        return out.detach(), [t.grad for t in qkv]

    res = run_threads(size, rank)
    out = torch.cat([r[0] for r in res], 2).numpy()
    if g is None:
        return out, None
    return out, [torch.cat([r[1][i] for r in res], 2).numpy()
                 for i in range(3)]


def jax_ring_on_mesh(size, fn):
    jax_mesh.make_mesh({"parallel": {"seq_parallel": size}},
                       devices=jax.devices()[:8])
    try:
        return fn()
    finally:
        jax_mesh.set_current_mesh(None)


def qkv(rng, b, h, n, d):
    return tuple(rng.standard_normal((b, h, n, d)).astype(np.float32)
                 for _ in range(3))


@pytest.mark.parametrize("size", [2, 4])
@pytest.mark.parametrize("n", [64, 31, 101])
def test_plain_ring_matches_jax_ring(size, n):
    q, k, v = qkv(np.random.default_rng(n), 4, 2, n, 16)
    scale = 16 ** -0.5
    want = jax_ring_on_mesh(size, lambda: np.asarray(
        jax.jit(lambda q, k, v: jax_ring(q, k, v, scale))(q, k, v)))
    got, _ = port_ring(q, k, v, scale, size)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("size", [2, 4])
def test_plain_ring_gradients_match_jax_ring(size):
    rng = np.random.default_rng(33)
    q, k, v = qkv(rng, 2, 2, 33, 8)
    g = rng.standard_normal((2, 2, 33, 8)).astype(np.float32)
    scale = 8 ** -0.5
    want = jax_ring_on_mesh(size, lambda: jax.jit(jax.grad(
        lambda q, k, v: (jax_ring(q, k, v, scale) * g).sum(),
        argnums=(0, 1, 2)))(q, k, v))
    _, got = port_ring(q, k, v, scale, size, g)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, np.asarray(b), rtol=5e-4, atol=5e-6)


@pytest.mark.parametrize("n", [64, 101])
def test_plain_ring_matches_jax_subblocked_ring(n, monkeypatch):
    """The JAX ring's key sub-blocking has no counterpart on the kernel
    path; the plain ring agrees with it at its test's shapes."""
    import semi_seg_ecg_tpu.ops.ring_attention as ra

    monkeypatch.setattr(ra, "_SCORE_CAP", 64)
    monkeypatch.setattr(ra, "_MIN_BLK", 16)
    rng = np.random.default_rng(n)
    q, k, v = qkv(rng, 2, 2, n, 8)
    g = rng.standard_normal((2, 2, n, 8)).astype(np.float32)
    scale = 8 ** -0.5

    def jax_side():
        out = jax.jit(lambda q, k, v: jax_ring(q, k, v, scale))(q, k, v)
        grads = jax.jit(jax.grad(
            lambda q, k, v: (jax_ring(q, k, v, scale) * g).sum(),
            argnums=(0, 1, 2)))(q, k, v)
        return np.asarray(out), [np.asarray(t) for t in grads]

    want, want_g = jax_ring_on_mesh(4, jax_side)
    got, got_g = port_ring(q, k, v, scale, 4, g)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-6)
    for a, b in zip(got_g, want_g):
        np.testing.assert_allclose(a, b, rtol=5e-4, atol=5e-6)


# ---------------------------------------------------------------------------
# The time-split ops against the whole-tensor ones
# ---------------------------------------------------------------------------

# ResNet18's lengths at 2,500 samples: the stem's output, the pool's, the
# stages'
LENGTHS = [1250, 625, 313, 157, 79]


def split_op(length, size, whole, split, seed=0):
    """``whole(x)`` and the concatenated ``split(x_block, length)`` of every
    thread rank, and their input gradients for one random output
    gradient."""
    torch.manual_seed(seed)
    x = torch.randn(2, 3, length).requires_grad_()
    y = whole(x)
    g = torch.randn_like(y)
    (y * g).sum().backward()

    def rank(comm):
        a, b = seq_shard.block(length, size, comm.rank)
        xb = x.detach()[..., a:b].clone().requires_grad_()
        with seq_shard.using(seq_shard.TimeShard(length, comm)):
            yb = split(xb)
        oa, ob = seq_shard.block(y.shape[-1], size, comm.rank)
        (yb * g[..., oa:ob]).sum().backward()
        return yb.detach(), xb.grad

    res = run_threads(size, rank)
    return (y.detach(), x.grad, torch.cat([r[0] for r in res], -1),
            torch.cat([r[1] for r in res], -1))


CONVS = {  # (kernel, stride, padding, dilation): ResNet18's and the head's
    "stem": (7, 2, 3, 1), "k3": (3, 1, 1, 1), "k3s2": (3, 2, 1, 1),
    "down": (1, 2, 0, 1), "dilated": (3, 1, 2, 2)}


@pytest.mark.parametrize("size", [2, 3, 4])
@pytest.mark.parametrize("length", LENGTHS)
def test_split_ops_match_whole_ops(size, length):
    w = torch.randn(4, 3, 7)
    ops = {f"conv_{name}": (
        lambda x, k=k, s=s, p=p, d=d: F.conv1d(x, w[..., :k], None, s, p, d),
        lambda x, k=k, s=s, p=p, d=d: seq_shard.conv1d(
            x, length, w[..., :k], None, s, p, d)[0])
        for name, (k, s, p, d) in CONVS.items()}
    ops["max_pool"] = (lambda x: F.max_pool1d(x, 3, 2, 1),
                       lambda x: seq_shard.max_pool1d(x, length, 3, 2, 1)[0])
    ops["avg_pool"] = (
        lambda x: F.avg_pool1d(x, 2, 2, ceil_mode=True,
                               count_include_pad=False),
        lambda x: seq_shard.avg_pool1d(x, length, 2, 2)[0])
    ops["resize"] = (lambda x: linear_interpolate(x, 2500),
                     lambda x: seq_shard.linear_interpolate(x, length, 2500))
    for name, (whole, split) in ops.items():
        y, gx, ys, gxs = split_op(length, size, whole, split)
        assert ys.shape == y.shape, name
        torch.testing.assert_close(ys, y, rtol=1e-6, atol=1e-6, msg=name)
        torch.testing.assert_close(gxs, gx, rtol=1e-6, atol=1e-6, msg=name)


@pytest.mark.parametrize("size", [2, 3])
def test_split_max_pool_routes_ties_as_the_whole_pool(size):
    """Tied windows (a constant signal with steps) send their gradient to
    the same element as ``F.max_pool1d`` on the whole tensor, also where a
    window straddles a block boundary."""
    length = 157
    base = torch.repeat_interleave(torch.arange(0.0, 40.0), 4)[:length]
    x = base.reshape(1, 1, -1).repeat(2, 3, 1)
    xt = x.clone().requires_grad_()
    yt = F.max_pool1d(xt, 3, 2, 1)
    torch.manual_seed(1)
    gt = torch.randn_like(yt)
    (yt * gt).sum().backward()

    def rank(comm):
        a, b = seq_shard.block(length, size, comm.rank)
        xb = x[..., a:b].clone().requires_grad_()
        with seq_shard.using(seq_shard.TimeShard(length, comm)):
            yb = seq_shard.max_pool1d(xb, length, 3, 2, 1)[0]
        oa, ob = seq_shard.block(yt.shape[-1], size, comm.rank)
        (yb * gt[..., oa:ob]).sum().backward()
        return xb.grad

    got = torch.cat(run_threads(size, rank), -1)
    assert torch.equal(got, xt.grad)


# ---------------------------------------------------------------------------
# The split rule
# ---------------------------------------------------------------------------


def test_split_rule_matches_jax_array_sharding():
    P = jax.sharding.PartitionSpec
    mesh = jax_mesh.make_mesh({"parallel": {"seq_parallel": 2}},
                              devices=jax.devices()[:8])
    try:
        batch = {"ecg": np.zeros((8, 1, 256), np.float32),
                 "target": np.zeros((8, 256), np.int32),
                 "id": np.zeros((8,), np.int32),
                 "short": np.zeros((8, 62), np.float32),
                 "ragged": np.zeros((8, 255), np.float32)}
        for name, arr in batch.items():
            spec = jax_mesh._array_sharding(mesh, arr, ("data",)).spec
            assert seq_shard.splits_time(arr.shape, 2) == (
                spec != P("data")), name
    finally:
        jax_mesh.set_current_mesh(None)
    local, length = seq_shard.split_batch(
        {"ecg": torch.zeros(2, 1, 256), "target": torch.zeros(2, 256),
         "id": torch.zeros(2)}, 2, 1)
    assert length == 256
    assert local["ecg"].shape == (2, 1, 128) and local["id"].shape == (2,)
    assert seq_shard.split_batch({"x": torch.zeros(2, 1, 255)}, 2, 0)[1] \
        is None


def test_ragged_warning_is_the_jax_line_once(capsys):
    seq_shard._WARNED_RAGGED.discard(4097)
    for _ in range(3):
        seq_shard.splits_time((2, 1, 4097), 2)
    out = capsys.readouterr().out
    assert out.count("seq_parallel=2 requested but trailing time dim 4097 "
                     "is not divisible by it") == 1


# ---------------------------------------------------------------------------
# Refusals and the switch-off
# ---------------------------------------------------------------------------


def test_device_augment_and_cache_switch_off_on_a_copy(capsys):
    cfg = {"parallel": {"seq_parallel": 2},
           "dataset": {"device_augment": True, "device_cache": True}}
    out = common.seq_parallel_config(cfg)
    assert cfg["dataset"] == {"device_augment": True, "device_cache": True}
    assert not out["dataset"]["device_augment"]
    assert not out["dataset"]["device_cache"]
    said = capsys.readouterr().out
    for knob in ("device_augment", "device_cache"):
        assert (f"{knob} disabled: seq_parallel shards the time axis and "
                "the fused augment path assumes data-only sharding — using "
                "the host augmentation path") in said
    one = {"parallel": {"seq_parallel": 1}, "dataset": {"device_cache": True}}
    assert common.seq_parallel_config(one) is one


@pytest.mark.parametrize("override", [
    {"algorithm": "reco"}, {"algorithm": "stpp"},
    {"parallel": {"seq_parallel": 2, "model_parallel": 2}},
    {"quantize": "int8"}])
def test_seq_parallel_refusals(override, seq_steps):
    """The former refusals under the seq axis (ReCo, ST++, the model axis
    beside it, int8 serving) run: their parity cases are in
    ``tests/test_torch_seq_algorithms.py``, ``test_torch_reco.py``,
    ``test_torch_stpp.py`` and below. The last one every layout had,
    ``checkpoint_backend: orbax``, is the directory backend: each takes it,
    and the two seq ranks' ResNet18 step, written both ways by every rank,
    loads to the pickle file's payload."""
    cfg = {"algorithm": "fixmatch", "parallel": {"seq_parallel": 2}}
    cfg.update(override)
    assert common.checkpoint_backend(cfg) == "pickle"
    assert common.checkpoint_backend(
        dict(cfg, checkpoint_backend="orbax")) == "orbax"
    saved = seq_steps["saved"]
    assert os.path.isdir(saved["orbax"])
    assert_payloads_equal(ckpt.load_checkpoint(saved["orbax"]),
                          ckpt.load_checkpoint(saved["pickle"]))


def test_seq_parallel_is_ported():
    """The former refusal case of
    ``test_torch_train_slice.py::test_unported_algorithms_and_options_raise``:
    the single-stage algorithms train under the seq axis (the steps below
    hold them against the JAX package), with either checkpoint backend."""
    for algorithm in ("base", "fixmatch", "mean_teacher", "cps"):
        cfg = {"algorithm": algorithm, "parallel": {"seq_parallel": 2}}
        assert common.checkpoint_backend(cfg) == "pickle"
        assert get_algorithm(algorithm).SPEC.name == algorithm


# ---------------------------------------------------------------------------
# Two gloo ranks at (data 1, seq 2) against the JAX (data 4, seq 2) step
# ---------------------------------------------------------------------------


def jax_seq_state(cfg):
    """The JAX package's base model, optimizer and initial state (seed 0)
    on a (data 4, seq 2) mesh, and the state as a port state_dict."""
    mesh = jax_mesh.make_mesh(cfg, devices=jax.devices()[:8])
    try:
        model = jax_build(cfg, train=True)
        tx = jax_optimizer(cfg, None, 10, model=model)
        state = jax.device_put(build_state(cfg, model, tx, JAX_BASE_SPEC,
                                           seed=0),
                               jax_mesh.replicated(mesh))
    finally:
        jax_mesh.set_current_mesh(None)
    return (model, tx, state), port_state(cfg, state.model.params,
                                          state.model.batch_stats)


def jax_seq_step(cfg, jax_state, batch):
    """One JAX base step on the (data 4, seq 2) mesh: the model after it,
    as a port state_dict, and the loss."""
    model, tx, state = jax_state
    mesh = jax_mesh.make_mesh(cfg, devices=jax.devices()[:8])
    try:
        new, metrics = jax.jit(jax_step(model, tx, cfg, 10))(
            state, jax_mesh.shard_batch(mesh, batch))
    finally:
        jax_mesh.set_current_mesh(None)
    return (port_state(cfg, new.model.params, new.model.batch_stats),
            float(metrics["loss"]))


def vit_ring_config():
    """``tests/test_ring_attention.py``'s ring ViT at depth 2 (its depth 12
    compiles for a minute on the CPU)."""
    cfg = _vit_sp_config()
    cfg["backbone"]["vit_tiny"].update(depth=2, out_indices=[1])
    return cfg


STEP_RUNS = {
    # tests/test_parallel.py::test_seq_parallel_step_equals_single_device
    "resnet18": (_tiny_config, 1e-5, 5e-4, 1e-5),
    # tests/test_ring_attention.py::test_vit_seq_parallel_ring_step_...
    "vit_ring": (vit_ring_config, 1e-5, 5e-3, 5e-5),
}


@pytest.fixture(scope="module")
def seq_steps(tmp_path_factory):
    """The port's two seq ranks on the JAX package's initial weights,
    started first; the JAX steps run while they do."""
    rng = np.random.default_rng(0)
    batch = {"ecg": rng.standard_normal((8, 1, 256)).astype(np.float32),
             "target": rng.integers(0, 4, (8, 256))}
    runs, jax_states = [], {}
    for name, (make, *_) in STEP_RUNS.items():
        cfg = make()
        cfg["parallel"] = {"model_parallel": 1, "seq_parallel": 2}
        jax_states[name], init = jax_seq_state(cfg)
        port_cfg = dict(copy.deepcopy(cfg), algorithm="base", device="cpu")
        runs.append({"config": port_cfg, "states": {"model": init},
                     "batches": [batch], "updates": 10})
    work = str(tmp_path_factory.mktemp("seq"))
    # then the ResNet18 step's checkpoint, written with each backend
    save = {"config": runs[0]["config"], "out_dir": work, "batch": batch}
    handle = start_ranks([("steps", {"runs": runs}),
                          ("save_backends", save)], work, world=2)
    jax_side = {name: jax_seq_step(dict(run["config"]), jax_states[name],
                                   batch)
                for name, run in zip(STEP_RUNS, runs)}
    codes, logs, out = wait_ranks(handle, TIMEOUT)
    for r, code in enumerate(codes):
        assert code == 0, f"rank {r}:\n{logs[r][-4000:]}"
    steps = {name: ([out[r][0][i] for r in range(2)], jax_side[name])
             for i, name in enumerate(STEP_RUNS)}
    steps["saved"] = {b: os.path.join(work, f"{b}.ckpt")
                      for b in ("pickle", "orbax")}
    return steps


@pytest.mark.parametrize("name", list(STEP_RUNS))
def test_two_seq_ranks_match_jax_seq_step(seq_steps, name):
    ranks, (want, loss) = seq_steps[name]
    _, loss_rtol, rtol, atol = STEP_RUNS[name]
    assert ranks[0]["metrics"][0]["loss"] == pytest.approx(loss,
                                                           rel=loss_rtol)
    got = ranks[0]["states"]["model"]
    assert got.keys() == want.keys()
    lr = STEP_RUNS[name][0]()["train"]["lr"]
    for k, v in want.items():
        if v.dtype.kind != "f":
            continue
        g = got[k]
        if k.endswith(KEY_BIAS):
            # the key bias's gradient is zero but for rounding (softmax
            # ignores a shift of every key), so Adam moves it by up to lr
            # in a direction rounding picks: the locksteps' rule
            third = v.shape[0] // 3
            keys = slice(third, 2 * third)
            assert np.abs(g[keys] - v[keys]).max() <= PARAM_ATOL_LR * lr, k
            g, v = np.delete(g, np.s_[keys]), np.delete(v, np.s_[keys])
        # Adam's first update is lr·sign(g): an element whose gradient lies
        # within rounding of zero moves by a rounding-chosen share of lr
        # (the port's AdamW locksteps hold it within TIGHT_ATOL_LR lr)
        bound = np.maximum(rtol * np.abs(v) + atol, TIGHT_ATOL_LR * lr)
        assert (np.abs(g - v) <= bound).all(), (k, float(
            (np.abs(g - v) - rtol * np.abs(v) - atol).max()))
    # the seq ranks' replicated parameters stay equal bit for bit
    for k, v in got.items():
        np.testing.assert_array_equal(ranks[1]["states"]["model"][k], v,
                                      err_msg=k)


# ---------------------------------------------------------------------------
# slow: the semi-supervised steps with dropout on, the entries
# ---------------------------------------------------------------------------

SEQ = 500


def dropout_config(family, algorithm):
    """A tiny recipe with every dropout on (ViT tokens, drop-path, the
    head) and SGD with momentum, at ``seq_parallel`` 2."""
    cfg = {"seed": 0, "precision": "fp32", "algorithm": algorithm,
           "device": "cpu",
           "backbone": {"vit_tiny": {
               "num_leads": 1, "seq_len": SEQ, "patch_size": 25,
               "width": 64, "depth": 2, "heads": 2, "dim_head": 32,
               "mlp_dim": 128, "out_indices": [1], "drop_out_rate": 0.1,
               "drop_path_rate": 0.1}},
           "decode_head": {"FCNHead": {
               "in_channels": 64, "in_index": 0, "channels": 16,
               "num_convs": 1, "concat_input": True, "dropout_ratio": 0.1,
               "num_classes": 4, "align_corners": False}},
           "dataset": {"signal_length": SEQ},
           "dataloader": {"batch_size": 2},
           "train": {"optimizer": "sgd", "lr": 1e-2, "min_lr": 1e-4,
                     "epochs": 2, "warmup_epochs": 0, "weight_decay": 0.05,
                     "max_norm": 1.0, "optimizer_kwargs": {"momentum": 0.9},
                     "conf_thresh": 0.3, "ema_decay": 0.99},
           "parallel": {"seq_parallel": 2}}
    if family == "resnet18":
        cfg["backbone"] = {"resnet18": {"num_leads": 1, "stem_channels": 8,
                                        "base_channels": 8}}
        cfg["decode_head"]["FCNHead"].update(in_channels=64, in_index=3)
    return cfg


def one_process(run):
    from semi_seg_ecg_tpu_torch.algorithms import get_algorithm
    from semi_seg_ecg_tpu_torch.models import build_model_from_config

    cfg = copy.deepcopy(run["config"])
    cfg["parallel"] = {}
    modules = {}
    for role, state in run["states"].items():
        modules[role] = build_model_from_config(cfg, train=True)
        modules[role].load_state_dict({k: torch.from_numpy(v)
                                       for k, v in state.items()})
    with common.full_fp32():
        trainer = common.Trainer(cfg, get_algorithm(cfg["algorithm"]).SPEC,
                                 torch.device("cpu"), len(run["batches"]),
                                 model=modules["model"],
                                 peer=modules.get("peer"))
        metrics = [{k: float(v) for k, v in trainer.train_step(
            {k: torch.from_numpy(v) for k, v in b.items()}).items()}
            for b in run["batches"]]
    return metrics, {k: v.numpy() for k, v in
                     trainer.model.state_dict().items()}


DROPOUT_RUNS = [("vit_tiny", "fixmatch"), ("vit_tiny", "mean_teacher"),
                ("vit_tiny", "cps"), ("resnet18", "fixmatch"),
                ("resnet18", "cps"), ("resnet18", "base")]


@pytest.mark.slow
def test_dropout_steps_match_one_process(tmp_path):
    """Three steps of each run on two seq ranks equal one process on the
    whole time axis: losses 1e-5 relative, states 5e-4 relative + 1e-5
    (phase 10's bounds), the two ranks bit for bit."""
    from semi_seg_ecg_tpu_torch.models import build_model_from_config

    rng = np.random.default_rng(3)
    x = lambda: (2 * rng.standard_normal((2, 1, SEQ))).astype(  # noqa
        np.float32)
    batches = [{"ecg": x(), "target": rng.integers(0, 4, (2, SEQ)),
                "ecg_u_w": x(), "ecg_u_s": x()} for _ in range(3)]
    runs = []
    for i, (family, algorithm) in enumerate(DROPOUT_RUNS):
        cfg = dropout_config(family, algorithm)
        states = {}
        for j, role in enumerate(("model", "peer") if algorithm == "cps"
                                 else ("model",)):
            torch.manual_seed(10 * i + j)
            states[role] = {k: v.numpy() for k, v in build_model_from_config(
                cfg, train=True).state_dict().items()}
        runs.append({"config": cfg, "states": states, "batches": batches})
    codes, logs, out = wait_ranks(start_ranks(
        [("steps", {"runs": runs})], str(tmp_path), world=2), TIMEOUT)
    assert codes == [0, 0], logs[0][-4000:] + logs[1][-4000:]
    for i, run in enumerate(runs):
        metrics, state = one_process(run)
        got = out[0][0][i]
        for a, b in zip(got["metrics"], metrics):
            for k in b:
                assert a[k] == pytest.approx(b[k], rel=1e-5), (i, k)
        for k, v in state.items():
            np.testing.assert_array_equal(out[1][0][i]["states"]["model"][k],
                                          got["states"]["model"][k])
            if v.dtype.kind == "f":
                np.testing.assert_allclose(got["states"]["model"][k], v,
                                           rtol=5e-4, atol=1e-5,
                                           err_msg=f"{DROPOUT_RUNS[i]} {k}")


@pytest.mark.slow
def test_entries_under_seq_parallel(tmp_path):
    """``train`` → ``test`` → ``inference`` of the tiny ViT FixMatch recipe
    at seq 2 (two gloo ranks through ``scripts/torch_run.sh``; device
    augmentation switched off with the JAX package's line): the run's files
    from rank 0, and the served probabilities equal one process's within
    1e-5."""
    import subprocess
    import sys

    import yaml

    from tests.test_torch_train_slice import tiny_recipe

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg, _ = tiny_recipe(tmp_path, "vit_tiny", "fixmatch", "seq")
    cfg["backbone"]["vit_tiny"]["attention_impl"] = "auto"
    cfg["parallel"] = {"seq_parallel": 2}
    cfg["train"]["epochs"] = 1
    path = tmp_path / "seq.yaml"
    path.write_text(yaml.safe_dump(cfg))
    out = tmp_path / "exps" / "seq"
    logs = []
    for entry in ("train", "test", "inference"):
        run = subprocess.run(["bash", os.path.join(root, "scripts",
                                                   "torch_run.sh"), entry,
                              "--gpus", "2", "--master_port",
                              str(29600 + os.getpid() % 300), "-f",
                              str(path)], capture_output=True, text=True,
                             timeout=TIMEOUT)
        assert run.returncode == 0, run.stdout[-3000:] + run.stderr[-3000:]
        logs.append(run.stdout)
    assert "device_augment disabled: seq_parallel shards the time axis" \
        in logs[0]
    for name in ("best-MeanIoU.ckpt", "test_metrics.csv",
                 "test_outputs.npy"):
        assert (out / name).exists(), name
    served = np.load(out / "test_outputs.npy")
    one = dict(cfg, parallel={}, exp_name="one",
               test={"model_path": str(out / "best-MeanIoU.ckpt")})
    path_one = tmp_path / "one.yaml"
    path_one.write_text(yaml.safe_dump(one))
    subprocess.run([sys.executable, "-m", "semi_seg_ecg_tpu_torch.cli",
                    "inference", "-f", str(path_one)], check=True,
                   cwd=root, timeout=TIMEOUT, capture_output=True)
    want = np.load(tmp_path / "exps" / "one" / "test_outputs.npy")
    np.testing.assert_allclose(served, want, atol=1e-5)
