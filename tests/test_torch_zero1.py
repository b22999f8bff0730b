"""ZeRO-1 (``parallel.shard_optimizer: true``) in the port, on the CPU.

Two gloo ranks of ``tests/torch_dist_worker.py`` (one group) take, on
rows ``[2r, 2r + 2)`` of the same global batches, K = 3 fp32 steps of the
tiny lockstep ViT (depth 2, width 64, dense attention, AdamW) with the
optimizer sharded and replicated: base with ``frozen_stages: 1`` (the
position and patch embeddings and block 0 frozen) and CPS (the peer's
optimizer sharded too). The sharded runs equal the replicated ones bit
for bit: each rank applies the same elementwise update to the same
averaged, clipped gradients and takes the other parameters from their
owners, so the losses, every network's state and the whole optimizer
state (``TrainOptimizer.state_dict``, gathered into the unsharded layout)
are the replicated run's, key for key. Each rank keeps the moments of its
own parameters only (the two sets are disjoint and cover the trainable
parameters, frozen ones in neither) and at most 0.6 of the replicated
bytes; a whole state loaded back keeps the rank's share and gathers to
itself; the gathered state resumes in one unsharded process.

Against the JAX package: one sharded base step on the ranks against the
JAX package's ``shard_optimizer`` step on a 2-device mesh (its moments
sharded over the data axis, the output pinned) from the same weights and
global batch: parameters within 5e-4 and the loss within 1e-4 relative,
``tests/test_zero1.py``'s bounds for a sharded against a replicated step.

``slow``: ``train_main`` of the tiny ViT FixMatch recipe on two ranks with
and without ZeRO-1: the same ``log.txt`` losses and checkpoints equal key
for key; the ZeRO-1 checkpoint resumes in one process.
"""

import copy
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from semi_seg_ecg_tpu.algorithms import base as jax_base
from semi_seg_ecg_tpu.models import build_model_from_config as jax_build
from semi_seg_ecg_tpu.parallel.mesh import make_mesh, shard_batch
from semi_seg_ecg_tpu.parallel.sharding_rules import (
    shard_state,
    state_shardings,
)
from semi_seg_ecg_tpu.utils.optimizer import build_optimizer as jax_optimizer
from semi_seg_ecg_tpu.utils.train_state import ModelState, TrainState
from semi_seg_ecg_tpu_torch.algorithms import get_algorithm
from semi_seg_ecg_tpu_torch.algorithms.common import Trainer, full_fp32
from semi_seg_ecg_tpu_torch.models import build_model_from_config
from semi_seg_ecg_tpu_torch.utils import checkpoint as ckpt
from semi_seg_ecg_tpu_torch.utils.optimizer import (
    balanced_owners,
    frozen_parameter_names,
)
from tests.test_torch_parallel_train import (
    global_batches,
    port_state,
    run_config,
)
from tests.test_torch_resume import assert_payloads_equal
from tests.test_torch_train_slice import K, perturbed_state, tiny_recipe
from tests.torch_dist_worker import run_ranks

WORLD = 2
TIMEOUT = 240
# tests/test_zero1.py: a sharded step against a replicated one
PARAM_ATOL, LOSS_RTOL = 5e-4, 1e-4


def zero1(cfg, on):
    cfg = copy.deepcopy(cfg)
    cfg["parallel"] = {"model_parallel": 1, "shard_optimizer": on}
    return cfg


def initial_states(cfg, seed, peer=False):
    jmodel = jax_build(cfg, train=True)
    params, stats = perturbed_state(jmodel, seed)
    states = {"model": port_state(cfg, params, stats)}
    if peer:
        states["peer"] = port_state(cfg, *perturbed_state(jmodel, seed + 100))
    return states, (params, stats)


def jax_zero1_step(cfg, params, stats, batch):
    """One JAX ``shard_optimizer`` base step on a 2-device mesh: the
    metrics and the parameters after it, as a port state_dict."""
    jmodel = jax_build(cfg, train=True)
    tx = jax_optimizer(cfg, params, K, model=jmodel)
    mesh = make_mesh(cfg, devices=jax.devices()[:WORLD])
    state = shard_state(mesh, TrainState(
        step=jnp.asarray(0, jnp.int32), model=ModelState(params, stats),
        opt_state=tx.init(params), ema=None, peer=None, peer_opt_state=None),
        shard_optimizer=True)
    shardings = state_shardings(mesh, state, shard_optimizer=True)
    inner = jax_base.make_train_step(jmodel, tx, cfg, K)

    def step(s, b):
        new, metrics = inner(s, b)
        return jax.lax.with_sharding_constraint(new, shardings), metrics

    state, metrics = jax.jit(step)(state, shard_batch(mesh, {
        "ecg": batch["ecg"], "target": batch["target"].astype(np.int32)}))
    return ({k: float(v) for k, v in metrics.items()},
            port_state(cfg, state.model.params, state.model.batch_stats))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The runs, each sharded and replicated, on one group of two ranks,
    and the JAX package's sharded step."""
    base_cfg = run_config("vit_tiny", "base")
    frozen = copy.deepcopy(base_cfg)
    frozen["backbone"]["vit_tiny"]["frozen_stages"] = 1
    cps_cfg = run_config("vit_tiny", "cps")
    base_states, jax_init = initial_states(base_cfg, 0)
    cps_states, _ = initial_states(cps_cfg, 3, peer=True)
    batches = global_batches(0)
    runs = {}
    for name, cfg, states in (("base", frozen, base_states),
                              ("cps", cps_cfg, cps_states)):
        for on in (True, False):
            runs[name, on] = {"config": zero1(cfg, on), "states": states,
                              "batches": batches}
    runs["one_step", True] = {"config": zero1(base_cfg, True),
                              "states": base_states,
                              "batches": batches[:1]}
    keys = list(runs)
    results = run_ranks(
        [("steps", {"runs": [runs[k] for k in keys],
                    "optimizer_state": True})],
        str(tmp_path_factory.mktemp("zero1")), timeout=TIMEOUT)
    by_run = {k: [r[0][i] for r in results] for i, k in enumerate(keys)}
    jax_side = jax_zero1_step(zero1(base_cfg, True), *jax_init, batches[0])
    return runs, by_run, jax_side


@pytest.mark.parametrize("name", ["base", "cps"])
def test_sharded_steps_equal_replicated(ranks, name):
    runs, by_run, _ = ranks
    sharded, replicated = by_run[name, True], by_run[name, False]
    for got in sharded:
        assert got["metrics"] == replicated[0]["metrics"]  # bit for bit
        assert got["states"].keys() == replicated[0]["states"].keys()
        for role, state in replicated[0]["states"].items():
            for k, v in state.items():
                np.testing.assert_array_equal(got["states"][role][k], v,
                                              err_msg=f"{role} {k}")
    assert set(sharded[0]["optimizers"]) == (
        {"model", "peer"} if name == "cps" else {"model"})
    for role, want in replicated[0]["optimizers"].items():
        for r in range(WORLD):
            # the whole state, gathered on every rank: the replicated
            # run's, key for key; loaded back, it gathers to itself
            report = sharded[r]["optimizers"][role]
            assert_payloads_equal(report["state"], want["state"])
            assert_payloads_equal(report["reloaded"], report["state"])
    cfg = runs[name, True]["config"]
    if name == "base":
        assert cfg["backbone"]["vit_tiny"]["frozen_stages"] == 1


@pytest.mark.parametrize("name", ["base", "cps"])
def test_each_rank_keeps_its_own_moments(ranks, name):
    runs, by_run, _ = ranks
    cfg = runs[name, True]["config"]
    model = build_model_from_config(cfg, train=True)
    frozen = frozen_parameter_names(cfg, model)
    trainable = [n for n, _ in model.named_parameters() if n not in frozen]
    assert bool(frozen) == (name == "base")
    for role, want in by_run[name, False][0]["optimizers"].items():
        held = [set(by_run[name, True][r]["optimizers"][role]["held"])
                for r in range(WORLD)]
        assert not held[0] & held[1]
        assert held[0] | held[1] == set(trainable)
        assert not (held[0] | held[1]) & frozen
        assert want["held"] == trainable
        assert len(want["state"]["state"]) == len(trainable)
        for r in range(WORLD):
            assert by_run[name, True][r]["optimizers"][role]["bytes"] <= \
                0.6 * want["bytes"]


def test_balanced_owners():
    assert balanced_owners([5, 1, 4, 2, 2], 2) == [0, 1, 1, 1, 0]
    assert balanced_owners([3, 3], 2) == [0, 1]
    assert balanced_owners([7], 3) == [0]


def test_one_sharded_step_matches_the_jax_package(ranks):
    _, by_run, (theirs, params) = ranks
    ours = by_run["one_step", True]
    assert ours[0]["metrics"][0]["loss"] == pytest.approx(
        theirs["loss"], rel=LOSS_RTOL)
    for k, want in params.items():
        if k.endswith("num_batches_tracked"):  # the JAX package counts none
            continue
        np.testing.assert_allclose(ours[0]["states"]["model"][k], want,
                                   atol=PARAM_ATOL, rtol=0, err_msg=k)


def test_gathered_state_resumes_unsharded(ranks):
    """The sharded run's gathered state and the replicated run's, each in
    one unsharded process with the final weights: the same next step."""
    runs, by_run, _ = ranks
    run = runs["base", True]
    cfg = zero1(run["config"], False)
    batch = {k: torch.from_numpy(v) for k, v in global_batches(7)[0].items()}
    out = []
    for on in (True, False):
        model = build_model_from_config(cfg, train=True)
        model.load_state_dict({k: torch.from_numpy(v) for k, v in
                               by_run["base", on][0]["states"]["model"].items()})
        with full_fp32():
            trainer = Trainer(copy.deepcopy(cfg), get_algorithm("base").SPEC,
                              torch.device("cpu"), K, model=model)
            state = by_run["base", on][0]["optimizers"]["model"]["state"]
            trainer.optimizer.load_state_dict(state)
            assert_payloads_equal(ckpt._to_numpy(
                trainer.optimizer.state_dict()), state)
            trainer.step = K
            metrics = trainer.train_step(batch)
        out.append((metrics["loss"].item(), trainer.model.state_dict()))
    assert out[0][0] == out[1][0]
    for k, v in out[1][1].items():
        assert torch.equal(out[0][1][k], v), k


@pytest.mark.slow
def test_two_rank_train_main_checkpoints_as_replicated(tmp_path):
    """``train_main`` of the tiny FixMatch recipe on two ranks, ZeRO-1 on
    and off: the same epoch losses, checkpoints equal key for key (rank 0
    writes the gathered optimizer state), and the ZeRO-1 file resumes in
    one process."""
    from semi_seg_ecg_tpu_torch.cli import train_main
    from semi_seg_ecg_tpu_torch.data.synthetic import make_synthetic_dataset

    paths = {}
    for on in (True, False):
        cfg, _ = tiny_recipe(tmp_path, "vit_tiny", "fixmatch", f"z{int(on)}")
        cfg["dataset"].update(make_synthetic_dataset(
            str(tmp_path / "data2"), num_train_labeled=8,
            num_train_unlabeled=8, num_valid=2, num_test=2, length=500,
            seed=4))
        cfg["parallel"] = {"model_parallel": 1, "shard_optimizer": on}
        paths[on] = str(tmp_path / f"z{int(on)}.yaml")
        with open(paths[on], "w") as f:
            yaml.safe_dump(cfg, f)
    run_ranks([("train_main", {"argv": ["-f", paths[on]]})
               for on in (True, False)], str(tmp_path / "ranks"),
              timeout=TIMEOUT)
    exps = tmp_path / "exps"
    rows = []
    for on in (True, False):
        with open(exps / f"z{int(on)}" / "log.txt") as f:
            row = json.loads(f.readline())
        rows.append({k: v for k, v in row.items() if k != "wall_s"})
    assert rows[0] == rows[1]
    files = [ckpt.load_checkpoint(str(exps / f"z{int(on)}" /
                                      "best-loss.ckpt")) for on in (True,
                                                                    False)]
    for key in ("model", "optimizer", "step", "epoch"):
        assert_payloads_equal(files[0][key], files[1][key], key)
    resumed = copy.deepcopy(yaml.safe_load(open(paths[True])))
    resumed.update(exp_name="resumed", resume=str(
        exps / "z1" / "best-loss.ckpt"))
    resumed["train"]["epochs"] = 2
    resumed["parallel"]["shard_optimizer"] = False
    path = str(tmp_path / "resumed.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(resumed, f)
    train_main(["-f", path])
    assert os.path.exists(str(exps / "resumed" / "log.txt"))
