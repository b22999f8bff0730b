"""Tensor parallelism (``parallel.model_parallel``) in the port, on the CPU.

Gloo ranks of ``tests/torch_dist_worker.py`` (port only) lay themselves
out as the port's ``(data, model)`` mesh and take, on their data rank's
rows of the same global batches, K = 3 AdamW steps (``max_norm`` set,
dropout, attention dropout and drop-path on) of the tiny lockstep ViT
(depth 2, width 64, ``dim_head`` 32, dense attention on the CPU). Each run
is held against the port's one process on the global batch: losses within
1e-5 relative, every network's gathered state within 5e-4 relative +
1e-5 (``tests/test_parallel.py``'s bounds for a sharded step), and the
model ranks' gathered states equal. Runs: at ``(data 2, model 2)`` base
(heads 2: head-parallel; also with ``remat``), base with heads 3
(attention replicated, MLP sliced), CPS and CPS with ZeRO-1, and ResNet18 (no rule matches: the JAX
package's warning, replicated); at ``(1, 2)`` Mean Teacher and ReCo.

Against the JAX package: ``make_mesh``'s coordinates and groups for
``(world, model)`` in (2,1), (4,2), (4,4), (6,3) and its divisibility
assertion; which parameters are sliced, against ``state_shardings`` at
``model 2`` for heads 2 and 3 (the port keeps whole heads: at heads 3 its
attention stays whole where the JAX package splits the fused columns);
one base step at ``(2, 2)`` with dropout off against the JAX package's TP
step on a ``(data 2, model 2)`` CPU mesh from the same weights and global
batch, within that test's bounds (loss 1e-4 relative; parameters rtol
5e-3, atol 2e-5).

Checkpoints: the ``(2, 2)`` base run's checkpoint (written by rank 0,
gathered over both axes) has one process's keys and shapes and its values
within the bounds above, the JAX package restores its model, and it
resumes for a fourth step under ``model_parallel`` 2 (on the ranks) and 1
(here), the two resumed steps agreeing.

``slow``: ``train_main`` of the tiny FixMatch and ST++ recipes at
``(2, 2)``.
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from semi_seg_ecg_tpu.algorithms import base as jax_base
from semi_seg_ecg_tpu.algorithms.common import (
    load_eval_model as jax_load_eval_model,
)
from semi_seg_ecg_tpu.config import normalize_config as jax_normalize
from semi_seg_ecg_tpu.models import build_model_from_config as jax_build
from semi_seg_ecg_tpu.parallel.mesh import make_mesh as jax_make_mesh
from semi_seg_ecg_tpu.parallel.mesh import shard_batch
from semi_seg_ecg_tpu.parallel.sharding_rules import (
    shard_state,
    state_shardings,
)
from semi_seg_ecg_tpu.utils.optimizer import build_optimizer as jax_optimizer
from semi_seg_ecg_tpu.utils.train_state import ModelState, TrainState
from semi_seg_ecg_tpu_torch.algorithms import get_algorithm
from semi_seg_ecg_tpu_torch.algorithms.common import Trainer, full_fp32
from semi_seg_ecg_tpu_torch.models import build_model_from_config
from semi_seg_ecg_tpu_torch.parallel import dist as pdist
from semi_seg_ecg_tpu_torch.parallel import mesh as pmesh
from semi_seg_ecg_tpu_torch.parallel import sharding_rules as rules
from semi_seg_ecg_tpu_torch.utils import checkpoint as ckpt
from semi_seg_ecg_tpu_torch.utils.weights import jax_trees_to_state_dict
from tests.test_torch_parallel_train import (
    global_batches,
    port_state,
    run_config,
)
from tests.test_torch_reco import NN, Q, TEMP, reco_model_config
from tests.test_torch_train_slice import (
    K,
    KEY_BIAS,
    LR,
    PARAM_ATOL_LR,
    TIGHT_ATOL_LR,
    perturbed_state,
)
from tests.torch_dist_worker import start_ranks, wait_ranks

TIMEOUT = 240
LOSS_RTOL, STATE_RTOL, STATE_ATOL = 1e-5, 5e-4, 1e-5
# tests/test_parallel.py::test_tensor_parallel_vit_step_matches_dp
JAX_LOSS_RTOL, JAX_RTOL, JAX_ATOL = 1e-4, 5e-3, 2e-5
DROPOUT = {"drop_out_rate": 0.1, "attn_drop_out_rate": 0.1,
           "drop_path_rate": 0.1}


def tp_config(algorithm, model_parallel, family="vit_tiny", heads=2,
              dropout=True, shard_optimizer=False, remat=False):
    """The lockstep configuration of ``algorithm`` with ``max_norm`` 1,
    dropout on (off with ``dropout`` False), ``remat`` and the model
    axis."""
    cfg = (reco_model_config(family) if algorithm == "reco"
           else run_config(family, algorithm))
    if algorithm == "reco":
        cfg["train"].update(conf_thresh=0.7, eash_conf_thresh=0.2,
                            hard_conf_thresh=0.99, contr_temp=TEMP,
                            contr_num_queries=Q, contr_num_negatives=NN)
    cfg["train"]["max_norm"] = 1.0 if dropout else None
    if family == "vit_tiny":
        cfg["backbone"]["vit_tiny"].update(heads=heads, remat=remat)
        if dropout:
            cfg["backbone"]["vit_tiny"].update(DROPOUT)
    cfg["decode_head"]["FCNHead"]["dropout_ratio"] = 0.1 if dropout else 0.0
    cfg["parallel"] = {"model_parallel": model_parallel,
                       "shard_optimizer": shard_optimizer}
    return cfg


def seeded_states(cfg, seed, peer=False):
    """Port initial states: the JAX init trees plus noise (as the other
    locksteps take them), and for CPS a peer from other noise."""
    jmodel = jax_build(cfg, train=True)
    jit = "resnet18" in cfg["backbone"]
    params, stats = perturbed_state(jmodel, seed, jit)
    states = {"model": port_state(cfg, params, stats)}
    if peer:
        states["peer"] = port_state(cfg, *perturbed_state(jmodel, seed + 100,
                                                          jit))
    return states, (params, stats)


def one_process(run, batches=None, resume=None):
    """The run in this process (``model_parallel`` 1) on the global
    batches: per-step metrics, every network's state and, with the run's
    ``checkpoint``, its own checkpoint written beside it."""
    cfg = copy.deepcopy(run["config"])
    cfg["parallel"] = dict(cfg["parallel"], model_parallel=1)
    if resume:
        cfg["resume"] = resume
    modules = {}
    for role, state in run["states"].items():
        modules[role] = build_model_from_config(cfg, train=True)
        modules[role].load_state_dict({k: torch.from_numpy(v)
                                       for k, v in state.items()})
    with full_fp32():
        trainer = Trainer(cfg, get_algorithm(cfg["algorithm"]).SPEC,
                          torch.device("cpu"), K, model=modules["model"],
                          peer=modules.get("peer"))
        metrics = [{k: float(v) for k, v in trainer.train_step(
            {k: torch.from_numpy(v) for k, v in b.items()}).items()}
            for b in (batches or run["batches"])]
    states = {role: {k: v.numpy() for k, v in m.state_dict().items()}
              for role, m in (("model", trainer.model),
                              ("ema", trainer.teacher),
                              ("peer", trainer.peer)) if m is not None}
    if run.get("checkpoint"):
        ckpt.save_checkpoint(run["checkpoint"] + ".one", 0, config=cfg,
                             step=trainer.step, **trainer.checkpoint_state())
    return metrics, states


def jax_tp_step(cfg, params, stats, batch):
    """One JAX base step on a (data 2, model 2) mesh of the conftest's CPU
    devices under its TP rules: the metrics and the parameters after it,
    as a port state_dict."""
    jmodel = jax_build(cfg, train=True)
    tx = jax_optimizer(cfg, params, K, model=jmodel)
    mesh = jax_make_mesh(cfg, devices=jax.devices()[:4])
    state = shard_state(mesh, TrainState(
        step=jnp.asarray(0, jnp.int32), model=ModelState(params, stats),
        opt_state=tx.init(params), ema=None, peer=None, peer_opt_state=None))
    step = jax.jit(jax_base.make_train_step(jmodel, tx, cfg, K))
    state, metrics = step(state, shard_batch(mesh, {
        "ecg": batch["ecg"], "target": batch["target"].astype(np.int32)}))
    return ({k: float(v) for k, v in metrics.items()},
            port_state(cfg, state.model.params, state.model.batch_stats))


# the ranks' runs: name -> (world, config maker, seed, peer)
RUNS = {
    "base": (4, lambda: tp_config("base", 2), 0, False),
    "heads3": (4, lambda: tp_config("base", 2, heads=3), 1, False),
    # the recompute of each block repeats its all-reduces on every rank
    "remat": (4, lambda: tp_config("base", 2, remat=True), 6, False),
    "cps": (4, lambda: tp_config("cps", 2), 3, True),
    "cps_zero1": (4, lambda: tp_config("cps", 2, shard_optimizer=True), 3,
                  True),
    "resnet18": (4, lambda: tp_config("base", 2, family="resnet18"), 2,
                 False),
    "mean_teacher": (2, lambda: tp_config("mean_teacher", 2), 4, False),
    "reco": (2, lambda: tp_config("reco", 2), 5, False),
}


@pytest.fixture(scope="module")
def tp_runs(tmp_path_factory):
    """Every run on its group of ranks, the JAX TP step, the one-process
    references and the resumed fourth steps."""
    root = tmp_path_factory.mktemp("tp")
    batches = global_batches(0)
    runs, jax_init = {}, None
    for name, (world, make, seed, peer) in RUNS.items():
        cfg = make()
        states, init = seeded_states(cfg, seed, peer)
        runs[name] = {"config": cfg, "states": states, "batches": batches}
        if name == "base":
            jax_init = init
    runs["base"]["checkpoint"] = str(root / "tp.ckpt")
    jax_cfg = tp_config("base", 2, dropout=False)
    runs["jax_step"] = {"config": jax_cfg,
                        "states": seeded_states(jax_cfg, 0)[0],
                        "batches": batches[:1]}
    resume_batch = global_batches(7)[:1]
    resumed = dict(runs["base"], batches=resume_batch, checkpoint=None,
                   config=dict(runs["base"]["config"],
                               resume=runs["base"]["checkpoint"]))
    by_world = {w: [n for n, r in RUNS.items() if r[0] == w] for w in (4, 2)}
    by_world[4].append("jax_step")
    handles = {w: start_ranks(
        [("steps", {"runs": [runs[n] for n in names],
                    "optimizer_state": True})]
        + ([("steps", {"runs": [resumed]})] if w == 4 else []),
        str(root / f"world{w}"), world=w) for w, names in by_world.items()}
    jax_side = jax_tp_step(jax_cfg, *jax_init, batches[0])
    ones = {name: one_process(run) for name, run in runs.items()}
    results, logs = {}, {}
    for w, handle in handles.items():
        codes, logs[w], out = wait_ranks(handle, TIMEOUT)
        for r, code in enumerate(codes):
            assert code == 0, f"world {w} rank {r}:\n{logs[w][r][-4000:]}"
        for i, name in enumerate(by_world[w]):
            results[name] = [out[r][0][i] for r in range(w)]
        if w == 4:
            results["resumed"] = [out[r][1][0] for r in range(w)]
    # the TP checkpoint, resumed in one unsliced process
    ones["resumed"] = one_process(dict(runs["base"], checkpoint=None),
                                  resume_batch,
                                  resume=runs["base"]["checkpoint"])
    return runs, results, ones, jax_side, logs


def assert_state_close(got, want, what, rtol=STATE_RTOL, atol=STATE_ATOL,
                       adamw=False):
    """Every entry within ``rtol`` and ``atol``, except two that AdamW's
    normalised update moves by rounding. The attention's key bias (the k
    third of ``to_qkv.bias``) has a zero gradient but for rounding (the
    softmax ignores a shift of every key), so it moves by up to lr a step
    in a direction rounding picks: held within ``PARAM_ATOL_LR`` lr. With
    ``adamw``, any parameter whose gradient lies near zero moves by a
    rounding-sized share of lr: each is held within the larger of the bound
    and ``TIGHT_ATOL_LR`` lr. These are the AdamW locksteps' rules
    (``tests/test_torch_train_slice.assert_states_agree``)."""
    assert got.keys() == want.keys(), what
    for k, v in want.items():
        g = np.asarray(got[k])
        if v.dtype.kind != "f":
            np.testing.assert_array_equal(g, v, err_msg=f"{what} {k}")
            continue
        if k.endswith(KEY_BIAS):
            third = v.shape[0] // 3
            keys = slice(third, 2 * third)
            assert np.abs(g[keys] - v[keys]).max() <= PARAM_ATOL_LR * LR, k
            g, v = np.delete(g, np.s_[keys]), np.delete(v, np.s_[keys])
        bound = rtol * np.abs(v) + atol
        if adamw and not k.endswith(("running_mean", "running_var")):
            bound = np.maximum(bound, TIGHT_ATOL_LR * LR)
        assert (np.abs(g - v) <= bound).all(), (what, k, float(
            (np.abs(g - v) - bound).max()))


@pytest.mark.parametrize("name", list(RUNS))
def test_tp_steps_match_one_process(tp_runs, name):
    _, results, ones, _, _ = tp_runs
    ranks = results[name]
    metrics, states = ones[name]
    assert len(ranks[0]["metrics"]) == len(metrics) == K
    for step, (a, b) in enumerate(zip(ranks[0]["metrics"], metrics)):
        assert a.keys() == b.keys(), step
        for k in b:
            assert a[k] == pytest.approx(b[k], rel=LOSS_RTOL), (step, k)
    for r, got in enumerate(ranks):
        assert got["states"].keys() == states.keys()
        for role, want in states.items():
            assert_state_close(got["states"][role], want, f"rank {r} {role}",
                               adamw=name != "resnet18")
            # every rank gathers the same whole state
            for k, v in got["states"][role].items():
                np.testing.assert_array_equal(
                    v, ranks[0]["states"][role][k], err_msg=f"{r} {k}")


def test_each_rank_holds_its_heads_and_columns(tp_runs):
    """Heads 2 over 2 model ranks: one head of each q/k/v third, half the
    MLP; heads 3: whole attention, half the MLP; ResNet18: nothing."""
    _, results, _, _, _ = tp_runs
    assert results["base"][0]["sliced"] == {
        f"backbone.block{i}.{k}": list(shape) for i in range(2)
        for k, shape in (("attn.fn.to_qkv.weight", (96, 64)),
                         ("attn.fn.to_qkv.bias", (96,)),
                         ("attn.fn.to_out.0.weight", (64, 32)),
                         ("ff.fn.net.0.weight", (64, 64)),
                         ("ff.fn.net.0.bias", (64,)),
                         ("ff.fn.net.3.weight", (64, 64)))}
    assert set(results["heads3"][0]["sliced"]) == {
        f"backbone.block{i}.ff.fn.net.{k}" for i in range(2)
        for k in ("0.weight", "0.bias", "3.weight")}
    assert results["resnet18"][0]["sliced"] == {}


def test_resnet18_warns_as_the_jax_package(tp_runs):
    *_, logs = tp_runs
    warning = ("WARNING: model_parallel=2 but no tensor-parallel sharding "
               "rule matched any parameter — training proceeds fully "
               "replicated on the model axis")
    assert warning in logs[4][0]


def test_zero1_under_the_model_axis(tp_runs):
    """ZeRO-1 over the data group on the rank's slices: the replicated
    optimizer's run and gathered state; each data rank keeps its own
    parameters' moments."""
    _, results, _, _, _ = tp_runs
    for r in range(4):
        sharded = results["cps_zero1"][r]
        plain = results["cps"][r]
        assert sharded["metrics"] == plain["metrics"]
        for role in ("model", "peer"):
            for k, v in plain["states"][role].items():
                np.testing.assert_array_equal(sharded["states"][role][k], v)
            report = sharded["optimizers"][role]
            want = plain["optimizers"][role]["state"]
            assert report["state"]["state"].keys() == want["state"].keys()
            for i, entry in want["state"].items():
                for k, v in entry.items():
                    np.testing.assert_array_equal(
                        report["state"]["state"][i][k], v)
            assert report["bytes"] <= 0.6 * plain["optimizers"][role][
                "bytes"]
    for role in ("model", "peer"):
        held = [set(results["cps_zero1"][r]["optimizers"][role]["held"])
                for r in (0, 2)]   # data ranks 0 and 1, model rank 0
        assert not held[0] & held[1]


def test_tp_step_matches_the_jax_package(tp_runs):
    _, results, _, (theirs, params), _ = tp_runs
    ours = results["jax_step"][0]
    assert ours["metrics"][0]["loss"] == pytest.approx(theirs["loss"],
                                                       rel=JAX_LOSS_RTOL)
    # the JAX package counts no num_batches_tracked
    got = {k: v for k, v in ours["states"]["model"].items()
           if not k.endswith("num_batches_tracked")}
    assert_state_close(got, {k: v for k, v in params.items()
                             if k in got}, "JAX", JAX_RTOL, JAX_ATOL)


def test_tp_checkpoint_is_the_unsliced_layout(tp_runs):
    """Rank 0's checkpoint of the (2, 2) run against one process's: the
    same keys, shapes and optimizer entries, values within the bounds;
    the JAX package restores its model."""
    runs, results, _, _, _ = tp_runs
    path = runs["base"]["checkpoint"]
    tp, one = ckpt.load_checkpoint(path), ckpt.load_checkpoint(path + ".one")
    assert tp.keys() == one.keys()
    assert tp["step"] == one["step"] == K
    assert_state_close(tp["model"], one["model"], "model", adamw=True)
    opt_tp, opt_one = tp["optimizer"], one["optimizer"]
    assert opt_tp["count"] == opt_one["count"] == K
    assert opt_tp["state"].keys() == opt_one["state"].keys()
    for i, entry in opt_one["state"].items():
        for k, v in entry.items():
            assert np.shape(opt_tp["state"][i][k]) == np.shape(v), (i, k)
    np.testing.assert_array_equal(
        tp["model"]["backbone.block0.attn.fn.to_qkv.weight"],
        results["base"][0]["states"]["model"][
            "backbone.block0.attn.fn.to_qkv.weight"])
    # the JAX package's reader: its model trees, back in the port's keys
    jcfg = jax_normalize(dict(copy.deepcopy(runs["base"]["config"]),
                              test={"model_path": path}))
    _, jstate = jax_load_eval_model(jcfg)
    back = jax_trees_to_state_dict(jstate.params, jstate.batch_stats,
                                   tp["model"].keys())
    assert back.keys() == tp["model"].keys()
    for k, v in back.items():
        if k.endswith("num_batches_tracked"):  # the JAX package counts none
            continue
        np.testing.assert_array_equal(v.numpy(), tp["model"][k], err_msg=k)


def test_tp_checkpoint_resumes_under_either_model_axis(tp_runs):
    """The (2, 2) checkpoint resumed for a fourth step on the ranks
    (``model_parallel`` 2) and in one process (1): the same step."""
    _, results, ones, _, _ = tp_runs
    metrics, states = ones["resumed"]
    got = results["resumed"][0]
    assert got["metrics"][0]["loss"] == pytest.approx(metrics[0]["loss"],
                                                      rel=LOSS_RTOL)
    assert_state_close(got["states"]["model"], states["model"], "resumed",
                       adamw=True)


@pytest.mark.parametrize("world, model", [(2, 1), (4, 2), (4, 4), (6, 3)])
def test_make_mesh_matches_jax(monkeypatch, world, model):
    """Each rank's coordinates and its data and model groups, against the
    JAX mesh over ``world`` CPU devices (device ``r`` standing for rank
    ``r``)."""
    cfg = {"parallel": {"model_parallel": model}}
    jmesh = jax_make_mesh(cfg, devices=jax.devices()[:world])
    ids = np.vectorize(lambda d: d.id)(jmesh.devices)   # (data, seq, model)
    monkeypatch.setattr(pmesh, "get_world_size", lambda: world)
    monkeypatch.setattr(pmesh.dist, "new_group", lambda ranks: tuple(ranks))
    try:
        for r in range(world):
            monkeypatch.setattr(pmesh, "get_rank", lambda: r)
            pdist.set_mesh(None)
            mesh = pmesh.make_mesh(cfg)
            (d,), (s,), (m,) = np.nonzero(ids == r)
            assert (mesh.data, mesh.seq, mesh.model) == ids.shape
            assert (mesh.data_rank, mesh.model_rank) == (d, m)
            if model > 1:
                assert mesh.data_group == tuple(ids[:, s, m])
                assert mesh.model_group == tuple(ids[d, s, :])
            else:
                assert mesh.data_group is mesh.model_group is None
    finally:
        pdist.set_mesh(None)


def test_make_mesh_refuses_what_the_jax_package_refuses(monkeypatch):
    cfg = {"parallel": {"model_parallel": 3}}
    monkeypatch.setattr(pmesh, "get_world_size", lambda: 4)
    for make in (pmesh.make_mesh,
                 lambda c: jax_make_mesh(c, devices=jax.devices()[:4])):
        with pytest.raises(AssertionError, match="not divisible by "
                                                 "model_parallel=3"):
            make(cfg)
    # a model group may not straddle two hosts
    monkeypatch.setattr(pmesh, "get_world_size", lambda: 6)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    with pytest.raises(AssertionError, match="must divide each process"):
        pmesh.make_mesh(cfg)


@pytest.mark.parametrize("heads", [2, 3])
def test_sliced_parameters_match_jax_rules(heads):
    """The parameters the port slices at ``model 2``, against those the JAX
    package's ``state_shardings`` puts on the model axis: the same at
    heads 2; at heads 3 the port keeps attention whole (its heads do not
    divide), where the JAX package splits the fused qkv columns."""
    cfg = tp_config("base", 2, heads=heads)
    model = build_model_from_config(cfg, train=True)
    plan = rules.model_plan(model, 2)
    jmodel = jax_build(cfg, train=True)
    params, stats = perturbed_state(jmodel, 0)
    mesh = jax_make_mesh(cfg, devices=jax.devices()[:4])
    shardings = state_shardings(mesh, ModelState(params, stats))
    flags = jax.tree.map(
        lambda p, s: np.full(np.shape(p), float("model" in str(s.spec)),
                             np.float32), ModelState(params, stats),
        shardings)
    as_port = jax_trees_to_state_dict(flags.params, flags.batch_stats,
                                      model.state_dict().keys())
    theirs = {k for k, v in as_port.items() if v.numel() and bool(v.all())}
    attention = {k for k in theirs if ".attn.fn." in k}
    assert len(attention) == 6 and len(theirs) == 12
    assert set(plan) == (theirs if heads == 2 else theirs - attention)


def test_shard_then_unshard_is_the_identity():
    """A rank's slices of a state dict, gathered back over two model
    ranks (one process stands for both), bit for bit."""
    cfg = tp_config("base", 2)
    model = build_model_from_config(cfg, train=True)
    plan = rules.model_plan(model, 2)
    state = model.state_dict()
    pieces = []
    for m in range(2):
        mesh = pmesh.Mesh(data=1, seq=1, model=2, data_rank=0, model_rank=m)
        pieces.append(rules.shard_state(state, plan, mesh))
    for k, v in state.items():
        spec = plan.get(k)
        if spec is None:
            assert pieces[0][k] is v
            continue
        assert pieces[0][k].shape[spec.dim] * 2 == v.shape[spec.dim]
        assert torch.equal(spec.join([p[k] for p in pieces]), v), k
    # q, k and v of head 1 are rank 1's
    w = state["backbone.block0.attn.fn.to_qkv.weight"]
    got = pieces[1]["backbone.block0.attn.fn.to_qkv.weight"]
    for third in range(3):
        assert torch.equal(got[32 * third:32 * (third + 1)],
                           w[64 * third + 32:64 * (third + 1)])


@pytest.mark.parametrize("sliced", [False, True])
def test_replicated_gradients_come_from_model_rank_0(monkeypatch, sliced):
    """Under a model axis every replicated parameter's gradient is taken
    from model rank 0 over the model group, whether or not a rule slices
    another parameter (ResNet18 has none: all of it is replicated)."""
    from semi_seg_ecg_tpu_torch.utils.optimizer import TrainOptimizer

    params = [torch.nn.Parameter(torch.ones(4, 2)),
              torch.nn.Parameter(torch.ones(2))]
    opt = TrainOptimizer(torch.optim.SGD(
        [{"params": params, "lr_scale": 1.0}], lr=0.1), lambda n: 0.1,
        params, ["a", "b"])
    opt.shard_({"a": rules.ROWS} if sliced else {}, pmesh.Mesh(
        data=1, seq=1, model=2, data_rank=0, model_rank=0,
        model_group="model"))
    for p in params:
        p.grad = torch.ones_like(p)
    calls = []
    monkeypatch.setattr(pdist, "broadcast_from_owners_",
                        lambda *args: calls.append(args))
    assert opt.step()
    replicated = params[1:] if sliced else params
    assert len(calls) == 1
    tensors, owners, group = calls[0]
    assert [t is p.grad for t, p in zip(tensors, replicated)] == \
        [True] * len(replicated) and len(tensors) == len(replicated)
    assert owners == [0] * len(replicated) and group == "model"


def write_recipe(root, algorithm, name):
    from semi_seg_ecg_tpu_torch.data.synthetic import make_synthetic_dataset
    from tests.test_torch_train_slice import tiny_recipe

    cfg, _ = tiny_recipe(root, "vit_tiny", algorithm, name)
    # two steps of 2 x 2 rows, and ST++'s reliable half as many
    cfg["dataset"].update(make_synthetic_dataset(
        str(root / "tp_data"), num_train_labeled=8, num_train_unlabeled=16,
        num_valid=2, num_test=2, length=500, seed=4))
    cfg["parallel"] = {"model_parallel": 2}
    path = str(root / f"{name}.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return cfg, path


@pytest.mark.slow
@pytest.mark.parametrize("algorithm", ["fixmatch", "stpp"])
def test_train_main_at_data_2_model_2(tmp_path, algorithm):
    """``train_main`` of the tiny recipe on 4 ranks at ``(2, 2)``: the run's
    files, finite losses, and a checkpoint one process serves."""
    from semi_seg_ecg_tpu_torch.cli import inference_main
    from tests.torch_dist_worker import run_ranks

    cfg, path = write_recipe(tmp_path, algorithm, f"tp_{algorithm}")
    run_ranks([("train_main", {"argv": ["-f", path]})],
              str(tmp_path / "ranks"), world=4, timeout=TIMEOUT * 2)
    out = os.path.join(cfg["output_dir"], f"tp_{algorithm}")
    assert os.path.exists(os.path.join(out, "test_metrics.csv"))
    best = os.path.join(out, "best-MeanIoU.ckpt")
    payload = ckpt.load_checkpoint(best)
    model = build_model_from_config(cfg, train=True)
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == {
        k: np.shape(v) for k, v in payload["model"].items()}
    served = dict(cfg, parallel={"model_parallel": 1})
    with open(path, "w") as f:
        yaml.safe_dump(served, f)
    probs = inference_main(["-f", path, "--model_path", best, "--exp_name",
                            f"tp_{algorithm}_served"])
    assert np.isfinite(probs).all()
