"""Data-parallel train steps of the port on the CPU: two gloo ranks against
the JAX package's step on a 2-device data mesh.

Base, FixMatch, Mean Teacher (its default train-mode teacher, whose
BatchNorm takes the global batch's statistics too) and CPS, on the ViT
(depth 2, width 64, dense attention) and the ResNet18 of width 8, at the
lockstep configurations of ``tests/test_torch_train_slice.py`` (fp32,
dropout off; AdamW for the ViT, SGD with momentum for the ResNet). The
JAX step takes K = 3 global batches of 2 x 2 rows on a mesh of two of the
conftest's CPU devices (GSPMD: gradients and BatchNorm statistics over the
global batch); each of two ranks of ``tests/torch_dist_worker.py`` (port
only) takes rows ``[2r, 2r + 2)`` of the same batches through
``Trainer.train_step``. Per step the losses (the mean over the ranks)
agree within rtol 1e-5 and FixMatch's ``mask_ratio`` counts the same
confident pixels; after K steps every network of both ranks (the student,
the teacher, the peer) is held to that file's ``assert_states_agree``, and
the two ranks' states are equal bit for bit.

ReCo, whose loss the JAX package computes over the global batch, runs
under two ranks against one process holding the global batch: the same
losses within rtol 1e-5 and the same states within those tolerances.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semi_seg_ecg_tpu.algorithms import base as jax_base
from semi_seg_ecg_tpu.algorithms import cps as jax_cps
from semi_seg_ecg_tpu.algorithms import fixmatch as jax_fixmatch
from semi_seg_ecg_tpu.algorithms import mean_teacher as jax_mt
from semi_seg_ecg_tpu.algorithms.common import apply_eval
from semi_seg_ecg_tpu.models import build_model_from_config as jax_build
from semi_seg_ecg_tpu.parallel.mesh import make_mesh, replicated, shard_batch
from semi_seg_ecg_tpu.utils.optimizer import build_optimizer as jax_optimizer
from semi_seg_ecg_tpu.utils.train_state import ModelState, TrainState
from semi_seg_ecg_tpu_torch.algorithms import reco
from semi_seg_ecg_tpu_torch.algorithms.common import (
    Trainer,
    full_fp32,
    init_model,
)
from semi_seg_ecg_tpu_torch.models import build_model_from_config
from semi_seg_ecg_tpu_torch.utils.weights import jax_trees_to_state_dict
from tests.test_torch_reco import NN, Q, TEMP, reco_model_config
from tests.test_torch_train_slice import (
    K,
    SEQ,
    assert_states_agree,
    lockstep_config,
    perturbed_state,
    resnet_lockstep_config,
)
from tests.torch_dist_worker import run_ranks
from tests.torch_dist_worker import one_thread  # noqa: F401 (autouse)

WORLD, B = 2, 2
JAX_ALGORITHMS = {"base": jax_base, "fixmatch": jax_fixmatch,
                  "mean_teacher": jax_mt, "cps": jax_cps}
RUNS = [(family, algorithm) for family in ("vit_tiny", "resnet18")
        for algorithm in JAX_ALGORITHMS]
# the seed of each run's init noise and batches; FixMatch's and CPS's
# assert that no confidence or pseudo-label lies within float noise of its
# threshold or of a tie
SEEDS = {("vit_tiny", "fixmatch"): 1, ("resnet18", "fixmatch"): 2}
TIMEOUT = 240


def run_config(family, algorithm):
    cfg = (resnet_lockstep_config(algorithm) if family == "resnet18"
           else lockstep_config("xla", algorithm))
    cfg["train"]["ema_decay"] = 0.99
    return cfg


def global_batches(seed, n=WORLD * B):
    rng = np.random.default_rng(seed)
    x = lambda: (2 * rng.standard_normal((n, 1, SEQ))).astype(np.float32)
    return [{"ecg": x(), "target": rng.integers(0, 4, (n, SEQ)),
             "ecg_u_w": x(), "ecg_u_s": x()} for _ in range(K)]


def port_state(cfg, params, stats):
    keys = build_model_from_config(cfg, train=True).state_dict().keys()
    return {k: v.numpy() for k, v in
            jax_trees_to_state_dict(params, stats, keys).items()}


def jax_run(family, algorithm, seed):
    """K steps of the JAX package on a 2-device mesh. Returns the port's
    run description (config, initial states, global batches), the JAX
    metrics per step and its final states, as port state_dicts."""
    cfg = run_config(family, algorithm)
    jmodel = jax_build(cfg, train=True)
    jit = family == "resnet18"
    params, stats = perturbed_state(jmodel, seed, jit)
    tx = jax_optimizer(cfg, params, K, model=jmodel)
    peer = ema = peer_opt = None
    if algorithm == "mean_teacher":
        ema = ModelState(params, stats)
    if algorithm == "cps":
        peer = ModelState(*perturbed_state(jmodel, seed + 100, jit))
        peer_opt = tx.init(peer.params)
    mesh = make_mesh(cfg, devices=jax.devices()[:WORLD])
    state = jax.device_put(TrainState(
        step=jnp.asarray(0, jnp.int32), model=ModelState(params, stats),
        opt_state=tx.init(params), ema=ema, peer=peer,
        peer_opt_state=peer_opt), replicated(mesh))
    step = jax.jit(JAX_ALGORITHMS[algorithm].make_train_step(jmodel, tx,
                                                             cfg, K))
    eval_logits = jax.jit(lambda ms, x: apply_eval(jmodel, ms, x)[
        "seg_logits"])
    batches = global_batches(seed)
    metrics = []
    for batch in batches:
        u_w = jnp.asarray(batch["ecg_u_w"])
        if algorithm == "fixmatch":
            # no confidence within float noise of the threshold
            conf = np.asarray(jax.nn.softmax(eval_logits(state.model, u_w),
                                             axis=1).max(axis=1))
            assert np.abs(conf - cfg["train"]["conf_thresh"]).min() > 1e-4
        if algorithm == "cps":
            # no pseudo-label within float noise of a tie
            for ms in (state.model, state.peer):
                top2 = np.sort(np.asarray(eval_logits(ms, u_w)), axis=1)
                assert (top2[:, -1] - top2[:, -2]).min() > 1e-4
        state, m = step(state, shard_batch(mesh, {
            k: v.astype(np.int32) if k == "target" else v
            for k, v in batch.items()}))
        metrics.append({k: float(v) for k, v in m.items()})
    initial = {"model": port_state(cfg, params, stats)}
    if peer is not None:
        initial["peer"] = port_state(cfg, *perturbed_state(jmodel, seed + 100,
                                                           jit))
    final = {role: port_state(cfg, s.params, s.batch_stats) for role, s in
             (("model", state.model), ("ema", state.ema),
              ("peer", state.peer)) if s is not None}
    run = {"config": cfg, "states": initial, "batches": batches}
    return run, metrics, final


def reco_run():
    cfg = reco_model_config("resnet18")
    cfg["train"].update(conf_thresh=0.7, eash_conf_thresh=0.2,
                        hard_conf_thresh=0.99, contr_temp=TEMP,
                        contr_num_queries=Q, contr_num_negatives=NN)
    model = init_model(cfg, torch.device("cpu"), seed=8)
    return {"config": cfg, "batches": global_batches(9),
            "states": {"model": {k: v.numpy() for k, v in
                                 model.state_dict().items()}}}


def one_process(run):
    """The run in this process on the global batches."""
    cfg = run["config"]
    model = build_model_from_config(cfg, train=True)
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in run["states"]["model"].items()})
    with full_fp32():
        trainer = Trainer(copy.deepcopy(cfg), reco.SPEC, torch.device("cpu"),
                          K, model=model)
        metrics = [{k: float(v) for k, v in trainer.train_step(
            {k: torch.from_numpy(v) for k, v in batch.items()}).items()}
            for batch in run["batches"]]
    return metrics, {"model": trainer.model.state_dict(),
                     "ema": trainer.teacher.state_dict()}


@pytest.fixture(scope="module")
def locksteps(tmp_path_factory):
    """Every run through JAX on the mesh and through two ranks (one group
    for all of them)."""
    jax_side, runs = {}, []
    for family, algorithm in RUNS:
        run, metrics, final = jax_run(family, algorithm,
                                      SEEDS.get((family, algorithm), 0))
        jax_side[family, algorithm] = (metrics, final)
        runs.append(run)
    runs.append(reco_run())
    results = run_ranks([("steps", {"runs": runs})],
                        str(tmp_path_factory.mktemp("steps")),
                        timeout=TIMEOUT)
    return jax_side, runs, [r[0] for r in results]


def state_dicts(states):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in states.items()}


def assert_ranks_equal(ranks, index):
    """Rank 1's networks equal rank 0's bit for bit: both applied the same
    averaged gradients to the same broadcast weights."""
    first, second = (ranks[r][index]["states"] for r in range(WORLD))
    assert first.keys() == second.keys()
    for role in first:
        for k, v in first[role].items():
            np.testing.assert_array_equal(v, second[role][k],
                                          err_msg=f"{role} {k}")


@pytest.mark.parametrize("family, algorithm", RUNS)
def test_two_ranks_match_the_jax_data_mesh(locksteps, family, algorithm):
    jax_side, _, ranks = locksteps
    index = RUNS.index((family, algorithm))
    theirs, final = jax_side[family, algorithm]
    ours = ranks[0][index]["metrics"]
    assert len(ours) == len(theirs) == K
    for step, (a, b) in enumerate(zip(ours, theirs)):
        assert a.keys() == b.keys(), step
        for k in a:
            if k == "mask_ratio":
                # the same count of confident pixels
                n = WORLD * B * SEQ
                assert round(a[k] * n) == round(b[k] * n), step
            else:
                assert a[k] == pytest.approx(b[k], rel=1e-5), (step, k)
    if algorithm == "fixmatch":
        assert any(0 < m["mask_ratio"] < 1 for m in theirs)
    assert_ranks_equal(ranks, index)
    got = ranks[0][index]["states"]
    assert set(got) == set(final)
    for role, want in final.items():
        assert_states_agree(state_dicts(want), state_dicts(got[role]))
    if family == "resnet18":
        assert "backbone.layer4.1.bn2.running_var" in final["model"]


def test_reco_two_ranks_match_one_process(locksteps):
    _, runs, ranks = locksteps
    metrics, final = one_process(runs[-1])
    ours = ranks[0][-1]["metrics"]
    for step, (a, b) in enumerate(zip(ours, metrics)):
        assert a.keys() == b.keys(), step
        assert b["contr_loss"] > 0, step
        for k in a:
            if k == "mask_ratio":
                n = WORLD * B * SEQ
                assert round(a[k] * n) == round(b[k] * n), step
            else:
                assert a[k] == pytest.approx(b[k], rel=1e-5), (step, k)
    assert_ranks_equal(ranks, len(runs) - 1)
    got = ranks[0][-1]["states"]
    for role, want in final.items():
        assert_states_agree(want, state_dicts(got[role]))
    assert "latent_projection.2.running_var" in final["ema"]
