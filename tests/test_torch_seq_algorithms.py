"""Every algorithm and option under the seq axis, and the seq and model axes
together, in the port, on the CPU.

Against the JAX package:

- ReCo: two gloo seq ranks at ``(data 1, seq 2)`` of
  ``tests/torch_dist_worker.py`` take two fp32 ViT ReCo steps (AdamW,
  ``attention_impl: auto``, so the ring) with the JAX package's own draws
  fed to both packages, against the JAX one-device ReCo step from the same
  weights: losses within 1e-5 relative, the student and the EMA teacher
  within the AdamW locksteps' rule (``assert_states_agree``), the ranks'
  states equal bit for bit;
- the ViT's ``output_cls_token`` under seq: two seq ranks as threads
  (``seq_shard.run_threads``) return their patch blocks and the whole cls
  row; joined, the JAX backbone's ``(patches, cls)`` within 1e-5, and the
  parameters' gradients of one loss, summed over the ranks, ``jax.grad``'s
  within 1e-5 of their largest element;
- the ring on a model rank's heads: each model rank's ``(B, H/m, n, D)``
  ring over its two seq ranks (threads), joined, the JAX ``ring_attention``
  on its ``(data, seq 2, model m)`` mesh (heads sharded over model), values
  and gradients within ``tests/test_ring_attention.py``'s bounds.

Against one process of the port (which ``tests/test_torch_quant.py`` holds
code for code against the JAX package):

- int8 serving under seq 2 (threads): a ResNet18 and a ViT of the int8
  build, dynamic and calibrated: every int8 layer's input codes, joined over
  the ranks, are one process's; the logits agree within 1e-5 and the
  calibrated absmax of every layer is one process's (the ViT's attention
  output by the ring within 1e-6 relative of the dense one's).

``slow`` (multi-process gloo groups, kept out of tier 1 for its time):
int8 serving at ``(data 1, model 3)`` through the model group, dynamic and
calibrated;
``seq × model`` at ``(data 1, seq 2, model 2)``: a ResNet18 and a ViT base
step against the JAX package's ``(data 2, seq 2, model 2)`` mesh step, and
FixMatch and ReCo steps of both backbones with dropout on against one
process; remat, ``accum_iter: 2`` and ZeRO-1 under seq against one
process.
"""

import contextlib
import copy
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semi_seg_ecg_tpu.algorithms import reco as jax_reco
from semi_seg_ecg_tpu.algorithms.common import TrainState
from semi_seg_ecg_tpu.models import build_model_from_config as jax_build
from semi_seg_ecg_tpu.models.backbones.vision_transformer import (
    vit_tiny as jax_vit,
)
from semi_seg_ecg_tpu.ops.ring_attention import ring_attention as jax_ring
from semi_seg_ecg_tpu.parallel import mesh as jax_mesh
from semi_seg_ecg_tpu.utils.optimizer import build_optimizer as jax_optimizer
from semi_seg_ecg_tpu.utils.train_state import ModelState
from semi_seg_ecg_tpu_torch.models import build_model_from_config
from semi_seg_ecg_tpu_torch.models.backbones.vision_transformer import (
    vit_tiny,
)
from semi_seg_ecg_tpu_torch.models import quant_layers
from semi_seg_ecg_tpu_torch.ops import quant
from semi_seg_ecg_tpu_torch.parallel import seq_shard
from semi_seg_ecg_tpu_torch.utils.calibrate import calibrate_quant
from semi_seg_ecg_tpu_torch.utils.weights import jax_trees_to_state_dict
from tests.test_torch_reco import NN, Q, TEMP, jax_draws, reco_model_config
from tests.test_torch_seq_parallel import (
    STEP_RUNS,
    TIMEOUT,
    dropout_config,
    jax_seq_state,
    jax_seq_step,
    one_process,
    port_ring,
    qkv,
)
from tests.test_torch_train_slice import (
    K,
    KEY_BIAS,
    PARAM_ATOL_LR,
    SEQ,
    TIGHT_ATOL_LR,
    assert_states_agree,
    batches,
    perturbed_state,
    port_model,
)
from tests.torch_dist_worker import run_ranks, start_ranks, wait_ranks
from tests.torch_dist_worker import one_thread  # noqa: F401 (autouse)


# ---------------------------------------------------------------------------
# ReCo: two gloo seq ranks against the JAX ReCo step
# ---------------------------------------------------------------------------

RECO_STEPS = 2


def reco_seq_config():
    """``tests/test_torch_reco.py``'s ViT ReCo recipe (AdamW) with the
    ring's ``auto`` attention and its lockstep's thresholds (the contrastive
    term is live on every step)."""
    cfg = reco_model_config("vit_tiny")
    cfg["backbone"]["vit_tiny"]["attention_impl"] = "auto"
    cfg["train"].update(conf_thresh=0.7, eash_conf_thresh=0.2,
                        hard_conf_thresh=0.99, contr_temp=TEMP,
                        contr_num_queries=Q, contr_num_negatives=NN)
    return cfg


@pytest.fixture(scope="module")
def reco_seq(tmp_path_factory):
    """The port's two seq ranks (started first) and the JAX one-device
    ReCo steps from the same perturbed weights, both fed the JAX package's
    draws: ``(ranks' results, JAX metrics, JAX state dicts)``."""
    cfg = reco_seq_config()
    jmodel = jax_build(cfg, train=True)
    params, stats = perturbed_state(jmodel, 8)
    init = {k: v.numpy() for k, v in
            port_model(cfg, params, stats).state_dict().items()}
    draws = [tuple(t.numpy() for t in jax_draws(jax.random.fold_in(
        jax.random.key(cfg["seed"] + 7), step)))
        for step in range(RECO_STEPS)]
    steps = [{k: v.astype(np.int64) if k == "target" else v
              for k, v in b.items()} for b in batches(8)[:RECO_STEPS]]
    port_cfg = dict(copy.deepcopy(cfg), device="cpu",
                    parallel={"seq_parallel": 2})
    handle = start_ranks([("steps", {"runs": [{
        "config": port_cfg, "states": {"model": init}, "batches": steps,
        "updates": K, "reco_draws": draws}]})],
        str(tmp_path_factory.mktemp("reco_seq")), world=2)
    tx = jax_optimizer(cfg, params, K, model=jmodel)
    state = TrainState(step=jnp.asarray(0, jnp.int32),
                       model=ModelState(params, stats),
                       opt_state=tx.init(params),
                       ema=ModelState(params, stats), peer=None,
                       peer_opt_state=None)
    step = jax.jit(jax_reco.make_train_step(jmodel, tx, cfg, K))
    theirs = []
    for batch in steps:
        state, metrics = step(state, {k: jnp.asarray(v)
                                      for k, v in batch.items()})
        theirs.append({k: float(v) for k, v in metrics.items()})
    keys = init.keys()
    jax_sds = {role: jax_trees_to_state_dict(ms.params, ms.batch_stats, keys)
               for role, ms in (("model", state.model), ("ema", state.ema))}
    codes, logs, out = wait_ranks(handle, TIMEOUT)
    for r, code in enumerate(codes):
        assert code == 0, f"rank {r}:\n{logs[r][-4000:]}"
    return [out[r][0][0] for r in range(2)], theirs, jax_sds


def test_two_seq_ranks_match_jax_reco_step(reco_seq):
    ranks, theirs, jax_sds = reco_seq
    for step, (a, b) in enumerate(zip(ranks[0]["metrics"], theirs)):
        assert a.keys() == b.keys()
        assert b["contr_loss"] > 0, step
        for k in a:
            assert a[k] == pytest.approx(b[k], rel=1e-5), (step, k)
    for role in ("model", "ema"):
        got = {k: torch.from_numpy(v)
               for k, v in ranks[0]["states"][role].items()}
        assert_states_agree(jax_sds[role], got)
        for k, v in ranks[0]["states"][role].items():
            np.testing.assert_array_equal(ranks[1]["states"][role][k], v,
                                          err_msg=f"{role} {k}")


# ---------------------------------------------------------------------------
# The cls token under seq
# ---------------------------------------------------------------------------

CLS_KW = dict(num_leads=1, seq_len=SEQ, patch_size=25, width=64, depth=2,
              heads=2, dim_head=32, mlp_dim=128, out_indices=(0, 1),
              output_cls_token=True)


def test_cls_token_under_seq_matches_jax():
    """``(patches, cls)`` of every out index: two seq ranks' patch blocks
    joined and each rank's cls row against the JAX backbone; the
    parameters' gradients of ``Σ patches·g + Σ cls·h`` (the cls term
    counted once: a half on each rank), summed over the ranks, against
    ``jax.grad``."""
    rng = np.random.default_rng(16)
    x = (2 * rng.standard_normal((2, 1, SEQ))).astype(np.float32)
    n = SEQ // 25
    gp = [rng.standard_normal((2, 64, n)).astype(np.float32)
          for _ in range(2)]
    gc = [rng.standard_normal((2, 64)).astype(np.float32) for _ in range(2)]
    jmodel = jax_vit(**CLS_KW, dtype=jnp.float32)
    xn = jnp.asarray(x.transpose(0, 2, 1))
    variables = jmodel.init({"params": jax.random.key(0)}, xn, train=False)
    params = jax.tree_util.tree_map(
        lambda a: a + 0.1 * rng.standard_normal(a.shape).astype(np.float32),
        jax.tree_util.tree_map(np.asarray, dict(variables["params"])))

    def loss(p):
        feats = jmodel.apply({"params": p}, xn, train=False)
        return sum((pa.transpose(0, 2, 1) * g).sum() + (c * h).sum()
                   for (pa, c), g, h in zip(feats, gp, gc))

    want = jmodel.apply({"params": params}, xn, train=False)
    want_grads = jax.grad(loss)(params)
    model = vit_tiny(**CLS_KW)
    keys = model.state_dict().keys()
    model.load_state_dict(jax_trees_to_state_dict(params, {}, keys,
                                                  backbone_only=True))
    model.eval()
    copies = [copy.deepcopy(model) for _ in range(2)]

    def rank(comm):
        a, b = seq_shard.block(SEQ, 2, comm.rank)
        pa, pb = seq_shard.block(n, 2, comm.rank)
        with seq_shard.seq_group(comm), seq_shard.time_sharded(SEQ):
            feats = copies[comm.rank](torch.from_numpy(x[..., a:b].copy()))
            total = sum((p * torch.from_numpy(g[..., pa:pb].copy())).sum()
                        + (c * torch.from_numpy(h)).sum() / 2
                        for (p, c), g, h in zip(feats, gp, gc))
            total.backward()
        return ([(p.detach(), c.detach()) for p, c in feats],
                {k: v.grad for k, v in copies[comm.rank].named_parameters()
                 if v.grad is not None})

    res = run_threads_checked(2, rank)
    for i, (wp, wc) in enumerate(want):
        got_p = torch.cat([r[0][i][0] for r in res], -1).numpy()
        np.testing.assert_allclose(got_p, np.asarray(wp).transpose(0, 2, 1),
                                   atol=1e-5, rtol=1e-5)
        for r in res:
            np.testing.assert_allclose(r[0][i][1].numpy(), np.asarray(wc),
                                       atol=1e-5, rtol=1e-5)
    grads = jax_trees_to_state_dict(jax.tree_util.tree_map(
        np.asarray, want_grads), {}, keys, backbone_only=True)
    # only seq rank 0 holds the cls token, so only its backward reaches it
    assert "cls_embedding" in res[0][1] and "cls_embedding" not in res[1][1]
    for k, g in grads.items():
        got = sum(r[1][k] for r in res if k in r[1])
        err = float((got - g).abs().max())
        assert err <= 1e-5 * max(1.0, float(g.abs().max())), (k, err)


def run_threads_checked(size, fn):
    """``seq_shard.run_threads``, each rank's time axis split for real (a
    rank that ran whole would pass by the one-process arithmetic)."""
    split = []

    def ranked(comm):
        split.append(comm.rank)
        return fn(comm)

    out = seq_shard.run_threads(size, ranked)
    assert sorted(split) == list(range(size))
    return out


# ---------------------------------------------------------------------------
# The ring on a model rank's heads
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("heads,model", [(4, 2), (3, 3)])
def test_ring_on_model_rank_heads_matches_jax(heads, model):
    """The JAX ring shards its heads over ``model`` when they divide; the
    port's model rank ``m`` runs the ring on its heads ``[m·H/tp,
    (m+1)·H/tp)`` over its own seq group. Joined over the model ranks: the
    JAX ring's output and gradients."""
    rng = np.random.default_rng(heads)
    q, k, v = qkv(rng, 2, heads, 33, 16)
    g = rng.standard_normal(q.shape).astype(np.float32)
    scale = 16 ** -0.5
    jax_mesh.make_mesh({"parallel": {"seq_parallel": 2,
                                     "model_parallel": model}},
                       devices=jax.devices()[:2 * model])
    try:
        want = np.asarray(jax.jit(lambda q, k, v: jax_ring(q, k, v, scale))(
            q, k, v))
        want_g = jax.jit(jax.grad(
            lambda q, k, v: (jax_ring(q, k, v, scale) * g).sum(),
            argnums=(0, 1, 2)))(q, k, v)
    finally:
        jax_mesh.set_current_mesh(None)
    per = heads // model
    outs, grads = [], []
    for m in range(model):
        heads_m = slice(m * per, (m + 1) * per)
        out, gr = port_ring(*(t[:, heads_m] for t in (q, k, v)), scale, 2,
                            g[:, heads_m])
        outs.append(out)
        grads.append(gr)
    np.testing.assert_allclose(np.concatenate(outs, 1), want, rtol=2e-5,
                               atol=2e-6)
    for i in range(3):
        np.testing.assert_allclose(
            np.concatenate([gr[i] for gr in grads], 1),
            np.asarray(want_g[i]), rtol=5e-4, atol=5e-6)


# ---------------------------------------------------------------------------
# int8 serving under seq: two thread ranks against one process
# ---------------------------------------------------------------------------


def int8_config(family, **parallel):
    """A narrow int8 serving build of either backbone (the ViT's heads and
    hidden width divide by 3)."""
    cfg = {"seed": 0, "precision": "fp32", "device": "cpu",
           "quantize": "int8",
           "backbone": {"vit_tiny": {
               "num_leads": 1, "seq_len": SEQ, "patch_size": 25, "width": 96,
               "depth": 2, "heads": 3, "dim_head": 32, "mlp_dim": 192,
               "out_indices": [1]}},
           "decode_head": {"FCNHead": {
               "in_channels": 96, "in_index": 0, "channels": 16,
               "num_convs": 1, "concat_input": True, "dropout_ratio": 0.0,
               "num_classes": 4, "align_corners": False}},
           "dataset": {"signal_length": SEQ}, "parallel": parallel}
    if family == "resnet18":
        cfg["backbone"] = {"resnet18": {"num_leads": 1, "stem_channels": 8,
                                        "base_channels": 8}}
        cfg["decode_head"]["FCNHead"].update(in_channels=64, in_index=3)
    return cfg


@contextlib.contextmanager
def recorded_codes():
    """Inside, every int8 layer's input codes are recorded in call order,
    by thread: ``{thread id: [codes, ...]}``."""
    codes, inner = {}, quant.quantize_input

    def recorded(x, act_scale):
        q, scale = inner(x, act_scale)
        codes.setdefault(threading.get_ident(), []).append(q)
        return q, scale

    quant.quantize_input = quant_layers.quantize_input = recorded
    try:
        yield codes
    finally:
        quant.quantize_input = quant_layers.quantize_input = inner


def join_codes(pieces, whole):
    """The ranks' pieces of one layer's codes joined along the axis they
    split (the one whose length differs from the whole's; none: every rank
    holds the whole)."""
    dims = [d for d in range(whole.dim()) if pieces[0].shape[d]
            != whole.shape[d]]
    if not dims:
        for p in pieces[1:]:
            assert torch.equal(p, pieces[0])
        return pieces[0]
    return torch.cat(pieces, dims[0])


def int8_inputs():
    rng = np.random.default_rng(9)
    return [torch.from_numpy((2 * rng.standard_normal((2, 1, SEQ))).astype(
        np.float32)) for _ in range(2)]


@pytest.mark.parametrize("calibrated", [False, True],
                         ids=["dynamic", "calibrated"])
@pytest.mark.parametrize("family", ["resnet18", "vit_tiny"])
def test_int8_serving_under_seq_matches_one_process(family, calibrated):
    cfg = int8_config(family)
    torch.manual_seed(3)
    model = build_model_from_config(cfg, serving=True).eval()
    batch, cal = int8_inputs()
    copies = [copy.deepcopy(model) for _ in range(2)]
    with torch.no_grad():
        absmax = calibrate_quant(model, [cal]) if calibrated else {}
        with recorded_codes() as codes:
            want = model(batch)["seg_logits"]
        (want_codes,) = codes.values()

    def rank(comm):
        net = copies[comm.rank]
        with torch.no_grad(), seq_shard.seq_group(comm):
            got_absmax = calibrate_quant(net, [cal]) if calibrated else {}
            rank_codes.pop(threading.get_ident(), None)  # calibration's
            out = seq_shard.sharded_call(lambda t: net(t)["seg_logits"],
                                         batch)
        return out, rank_codes[threading.get_ident()], got_absmax

    with recorded_codes() as rank_codes:
        res = run_threads_checked(2, rank)
    for out, _, got_absmax in res:
        np.testing.assert_allclose(out.numpy(), want.numpy(), atol=1e-5,
                                   rtol=0)
        assert got_absmax.keys() == absmax.keys()
        for k, v in absmax.items():
            if family == "vit_tiny" and k.endswith("attn.fn.to_out.0"):
                # the ring's output rounds apart from the dense attention's
                torch.testing.assert_close(got_absmax[k], v, rtol=1e-6,
                                           atol=0)
            else:
                assert torch.equal(got_absmax[k], v), k
    assert len(res[0][1]) == len(res[1][1]) == len(want_codes)
    for i, whole in enumerate(want_codes):
        joined = join_codes([r[1][i] for r in res], whole)
        assert joined.shape == whole.shape, i
        differ = (joined != whole).sum().item()
        if family == "vit_tiny":
            # the ring's rounding may move a code across a .5 boundary
            assert differ <= 1e-4 * whole.numel(), (i, differ)
            assert (joined.int() - whole.int()).abs().max() <= 1, i
        else:
            assert differ == 0, (i, differ)


# ---------------------------------------------------------------------------
# slow: gloo groups
# ---------------------------------------------------------------------------


@pytest.mark.slow
@pytest.mark.parametrize("calibrated", [False, True],
                         ids=["dynamic", "calibrated"])
def test_int8_serving_under_model_parallel_matches_one_process(tmp_path,
                                                               calibrated):
    """Three model ranks of the int8 ViT (one head, a third of the MLP
    each): every int8 layer's codes (the row-parallel ``to_out.0`` and
    ``net.3`` joined over the ranks, the others equal on every rank) and
    the calibrated absmax are one process's, the logits within 1e-5."""
    from tests.torch_dist_worker import task_serve, to_numpy

    cfg = int8_config("vit_tiny", model_parallel=3)
    torch.manual_seed(3)
    state = {k: v.numpy() for k, v in build_model_from_config(
        cfg, serving=True).state_dict().items()}
    batch, cal = (t.numpy() for t in int8_inputs())
    kwargs = {"config": cfg, "state": state, "batches": [batch],
              "calibrate": [cal] if calibrated else ()}
    out = run_ranks([("serve", kwargs)], str(tmp_path), world=3,
                    timeout=TIMEOUT)
    one = to_numpy(task_serve(**dict(kwargs, config=dict(cfg,
                                                          parallel={}))))
    ranks = [r[0] for r in out]
    for r in ranks:
        np.testing.assert_allclose(r["logits"][0], one["logits"][0],
                                   atol=1e-5, rtol=0)
        assert r["absmax"].keys() == one["absmax"].keys()
        for k, v in one["absmax"].items():
            assert r["absmax"][k] == v, k
        assert len(r["codes"]) == len(one["codes"])
    for i, whole in enumerate(one["codes"]):
        joined = join_codes([torch.from_numpy(r["codes"][i]) for r in ranks],
                            torch.from_numpy(whole))
        np.testing.assert_array_equal(joined.numpy(), whole, err_msg=str(i))


SEQ_MODEL = {"seq_parallel": 2, "model_parallel": 2}


@pytest.mark.slow
def test_seq_model_steps_match_jax_mesh_step(tmp_path):
    """``(data 1, seq 2, model 2)``: four gloo ranks take a base step of
    ``STEP_RUNS``' ResNet18 and ring ViT (2 heads: one a model rank) on
    the global batch of 8, against the JAX package's ``(data 2, seq 2,
    model 2)`` step, within ``test_two_seq_ranks_match_jax_seq_step``'s
    bounds; the ranks' gathered states equal bit for bit."""
    rng = np.random.default_rng(0)
    batch = {"ecg": rng.standard_normal((8, 1, 256)).astype(np.float32),
             "target": rng.integers(0, 4, (8, 256))}
    runs, jax_states = [], {}
    for name, (make, *_) in STEP_RUNS.items():
        cfg = make()
        cfg["parallel"] = dict(SEQ_MODEL)
        jax_states[name], init = jax_seq_state(cfg)
        runs.append({"config": dict(copy.deepcopy(cfg), algorithm="base",
                                    device="cpu"),
                     "states": {"model": init}, "batches": [batch],
                     "updates": 10})
    handle = start_ranks([("steps", {"runs": runs})], str(tmp_path), world=4)
    want = {name: jax_seq_step(dict(run["config"]), jax_states[name], batch)
            for name, run in zip(STEP_RUNS, runs)}
    codes, logs, out = wait_ranks(handle, TIMEOUT)
    assert codes == [0] * 4, logs[0][-4000:]
    for i, name in enumerate(STEP_RUNS):
        ranks = [out[r][0][i] for r in range(4)]
        state, loss = want[name]
        _, loss_rtol, rtol, atol = STEP_RUNS[name]
        assert ranks[0]["metrics"][0]["loss"] == pytest.approx(
            loss, rel=loss_rtol)
        lr = runs[i]["config"]["train"]["lr"]
        got = ranks[0]["states"]["model"]
        for k, v in state.items():
            if v.dtype.kind != "f":
                continue
            g = got[k]
            if k.endswith(KEY_BIAS):
                third = v.shape[0] // 3
                keys = slice(third, 2 * third)
                assert np.abs(g[keys] - v[keys]).max() <= PARAM_ATOL_LR * lr
                g, v = np.delete(g, np.s_[keys]), np.delete(v, np.s_[keys])
            bound = np.maximum(rtol * np.abs(v) + atol, TIGHT_ATOL_LR * lr)
            assert (np.abs(g - v) <= bound).all(), (name, k)
        for r in ranks[1:]:
            for k, v in got.items():
                np.testing.assert_array_equal(r["states"]["model"][k], v,
                                              err_msg=f"{name} {k}")


def one_process_runs(runs, world, tmp_path):
    """The runs on ``world`` gloo ranks and in one process: each run's
    ranks' results and one process's ``(metrics, state)``; the ranks'
    states equal bit for bit."""
    out = run_ranks([("steps", {"runs": runs})], str(tmp_path), world=world,
                    timeout=TIMEOUT)
    results = []
    for i, run in enumerate(runs):
        ranks = [out[r][0][i] for r in range(world)]
        for r in ranks[1:]:
            for k, v in ranks[0]["states"]["model"].items():
                np.testing.assert_array_equal(r["states"]["model"][k], v)
        results.append((ranks, one_process(run)))
    return results


def assert_one_process(label, ranks, single, adamw_lr=None):
    """Phase 10's bounds: losses 1e-5 relative, states 5e-4 relative +
    1e-5; under AdamW (``adamw_lr``) at least ``TIGHT_ATOL_LR`` lr, the
    AdamW locksteps' rule (Adam's first update is lr·sign(g), and an
    element whose gradient lies within rounding of zero moves by a
    rounding-chosen share of lr)."""
    metrics, state = single
    for a, b in zip(ranks[0]["metrics"], metrics):
        for k in b:
            assert a[k] == pytest.approx(b[k], rel=1e-5), (label, k)
    floor = 0.0 if adamw_lr is None else TIGHT_ATOL_LR * adamw_lr
    for k, v in state.items():
        if v.dtype.kind == "f":
            got = ranks[0]["states"]["model"][k]
            bound = np.maximum(5e-4 * np.abs(v) + 1e-5, floor)
            assert (np.abs(got - v) <= bound).all(), (label, k)


def seq_batches(rows):
    rng = np.random.default_rng(5)
    x = lambda: (2 * rng.standard_normal((rows, 1, 500))).astype(  # noqa
        np.float32)
    return [{"ecg": x(), "target": rng.integers(0, 4, (rows, 500)),
             "ecg_u_w": x(), "ecg_u_s": x()} for _ in range(3)]


def seeded_states(cfg, algorithm, seed):
    states = {}
    for j, role in enumerate(("model", "peer") if algorithm == "cps"
                             else ("model",)):
        torch.manual_seed(seed + j)
        states[role] = {k: v.numpy() for k, v in build_model_from_config(
            cfg, train=True).state_dict().items()}
    return states


def reco_dropout_config(family):
    cfg = dropout_config(family, "reco")
    cfg.update(use_latent_projection=True, projection_in_dim=64,
               projection_out_dim=16)
    cfg["train"].update(eash_conf_thresh=0.2, hard_conf_thresh=0.99,
                        contr_num_queries=Q, contr_num_negatives=NN)
    return cfg


@pytest.mark.slow
def test_seq_model_dropout_steps_match_one_process(tmp_path):
    """FixMatch and ReCo of both backbones with every dropout on, three
    steps at ``(data 1, seq 2, model 2)`` against one process."""
    runs = []
    for i, (family, algorithm) in enumerate(
            [("vit_tiny", "fixmatch"), ("resnet18", "fixmatch"),
             ("vit_tiny", "reco"), ("resnet18", "reco")]):
        cfg = (reco_dropout_config(family) if algorithm == "reco"
               else dropout_config(family, algorithm))
        cfg["parallel"] = dict(SEQ_MODEL)
        runs.append({"config": cfg,
                     "states": seeded_states(cfg, algorithm, 10 * i),
                     "batches": seq_batches(2)})
    for i, (ranks, single) in enumerate(one_process_runs(runs, 4, tmp_path)):
        assert_one_process(i, ranks, single)


@pytest.mark.slow
@pytest.mark.parametrize("option", ["remat", "accum", "zero1"])
def test_seq_options_match_one_process(tmp_path, option):
    """The options no other test holds under seq: ``remat`` (both
    backbones' FixMatch) and ``train.accum_iter: 2`` (ResNet18 base, ViT
    Mean Teacher) at ``(data 1, seq 2)``; ZeRO-1 (ResNet18 CPS, ViT
    FixMatch under AdamW) at ``(data 2, seq 2)``; three steps with dropout
    on against one process."""
    cases = {"remat": [("vit_tiny", "fixmatch"), ("resnet18", "fixmatch")],
             "accum": [("resnet18", "base"), ("vit_tiny", "mean_teacher")],
             "zero1": [("resnet18", "cps"), ("vit_tiny", "fixmatch")]}[option]
    data = 2 if option == "zero1" else 1
    runs = []
    for i, (family, algorithm) in enumerate(cases):
        cfg = dropout_config(family, algorithm)
        if option == "remat":
            cfg["backbone"][family]["remat"] = True
        elif option == "accum":
            cfg["train"]["accum_iter"] = 2
        else:
            cfg["parallel"]["shard_optimizer"] = True
            if family == "vit_tiny":
                cfg["train"].update(optimizer="adamw", optimizer_kwargs={
                    "betas": [0.9, 0.999]})
        runs.append({"config": cfg,
                     "states": seeded_states(cfg, algorithm, 20 * i),
                     "batches": seq_batches(2 * data)})
    for i, (ranks, single) in enumerate(one_process_runs(runs, 2 * data,
                                                         tmp_path)):
        train = runs[i]["config"]["train"]
        assert_one_process(cases[i], ranks, single,
                           train["lr"] if train["optimizer"] == "adamw"
                           else None)
