"""Gradient accumulation (``train.accum_iter``) in the port against the JAX
package's ``optax.MultiSteps``, on the CPU.

The optimizer alone: ``TrainOptimizer`` with a window of k micro-steps
against ``optax.MultiSteps`` over the JAX package's chain, on random
gradients (AdamW and SGD with momentum, with clipping): every parameter
within 1e-6 after each micro-step, the lr of each update the schedule's at
the update count, and nothing moves inside a window. The port sums the
window's gradients and divides by k, optax keeps a running mean; the two
round apart in the last bits.

Whole steps: ``lockstep_states`` of ``tests/test_torch_train_slice.py``
with ``accum_iter: 2`` (the JAX chain under ``optax.MultiSteps``, as its
``run_training`` builds it) runs K = 3 micro-steps of base, FixMatch, Mean
Teacher, CPS and ReCo through both packages: one update and an open
window. Losses within rtol 1e-5; every network (the Mean Teacher's and
ReCo's EMA teacher, which must follow the one update only, and the CPS
peer, whose optimizer accumulates too) within ``assert_states_agree``'s
bounds (BN statistics 1e-5, parameters 0.2 lr, the key bias 6 lr); the open
window's gradients (optax's mean times its ``mini_step``, the port's
``.grad``) within 1e-4 of each tensor's largest element + 1e-7.

Two gloo ranks (``tests/torch_dist_worker.py``) of Mean Teacher (ViT,
dense attention, its train-mode teacher) take the same K micro-steps on
their halves of each global batch as one process holding it: losses
within rtol 1e-5, the student and teacher within ``assert_states_agree``'s
bounds, the ranks equal bit for bit.

``train.scan_steps: 2`` under two gloo ranks (the units' steps run
eagerly on the CPU), with ``accum_iter`` 1 and 2: ``run_training`` of
``tests/test_torch_scan_steps.py``'s FixMatch run (4 rows a rank, 4 steps)
and one process holding both shards, each against the JAX package's
``run_training`` on a 2-device data mesh (its ``jax.lax.scan`` of 2
steps, of ``optax.MultiSteps`` steps at ``accum_iter: 2``), and the ranks
against the one process, all from the JAX run's initial trees: the
epoch's train losses within rtol 1e-5 and the final model by
``assert_states_agree``; the two ranks' models equal bit for bit.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from semi_seg_ecg_tpu.algorithms import base as jax_base
from semi_seg_ecg_tpu.algorithms import cps as jax_cps
from semi_seg_ecg_tpu.algorithms import fixmatch as jax_fixmatch
from semi_seg_ecg_tpu.algorithms import mean_teacher as jax_mt
from semi_seg_ecg_tpu.algorithms import reco as jax_reco
from semi_seg_ecg_tpu.utils.optimizer import build_optimizer as jax_optimizer
from semi_seg_ecg_tpu.utils.optimizer import make_lr_schedule as jax_schedule
from semi_seg_ecg_tpu_torch.algorithms import (
    base,
    cps,
    fixmatch,
    mean_teacher,
    reco,
)
from semi_seg_ecg_tpu_torch.algorithms.common import Trainer, init_model
from semi_seg_ecg_tpu_torch.ops import reco_loss
from semi_seg_ecg_tpu_torch.utils.optimizer import build_optimizer
from tests.test_torch_losses_optim import Params, train_cfg
from tests.test_torch_parallel_train import (
    assert_ranks_equal,
    global_batches,
    state_dicts,
)
from tests.test_torch_reco import jax_draws, reco_model_config
from tests.torch_dist_worker import (
    data_parallel_size,
    run_ranks,
    start_ranks,
    wait_ranks,
)
from tests.test_torch_train_slice import (
    BATCH,
    K,
    SEQ,
    assert_states_agree,
    lockstep_config,
    lockstep_states,
    resnet_lockstep_config,
)
from tests.torch_dist_worker import one_thread  # noqa: F401 (autouse)

ACCUM = 2
# FixMatch's threshold: no confidence of its seed's three micro-steps lies
# within 1e-4 of it (lockstep_states asserts that), and some pass it
CONF = 0.7
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-7


@pytest.mark.parametrize("accum", [2, 3])
@pytest.mark.parametrize("optimizer,kwargs", [
    ("adamw", {"betas": [0.9, 0.95]}),
    ("sgd", {"momentum": 0.9}),
])
def test_window_matches_multisteps(optimizer, kwargs, accum):
    rng = np.random.default_rng(11)
    arrays = {"w": rng.standard_normal((8, 5)).astype(np.float32),
              "b": rng.standard_normal(5).astype(np.float32)}
    updates_per_epoch = 2
    cfg = {"train": dict(train_cfg(optimizer, 1.0, warmup_epochs=0,
                                   **kwargs), accum_iter=accum)}
    model = Params(arrays)
    opt = build_optimizer(cfg, model, updates_per_epoch)
    tx = optax.MultiSteps(jax_optimizer(cfg, None, updates_per_epoch),
                          every_k_schedule=accum)
    schedule = jax_schedule(cfg["train"], updates_per_epoch)
    params = {k: jnp.asarray(v) for k, v in arrays.items()}
    state = tx.init(params)

    @jax.jit  # one compiled update, as the JAX package's train step runs it
    def update(grads, state, params):
        updates, state = tx.update(grads, state, params)
        return optax.apply_updates(params, updates), state

    for micro in range(3 * accum + 1):
        before = {k: p.detach().clone() for k, p in model.named_parameters()}
        grads = {k: (2 * rng.standard_normal(v.shape)).astype(np.float32)
                 for k, v in arrays.items()}
        opt.zero_grad()
        for name, p in model.named_parameters():
            g = torch.from_numpy(grads[name].copy())
            p.grad = g if p.grad is None else p.grad + g
        applied = opt.step()
        assert applied == ((micro + 1) % accum == 0), micro
        assert opt.count == (micro + 1) // accum
        params, state = update({k: jnp.asarray(g) for k, g in
                                grads.items()}, state, params)
        assert opt.micro_step == int(state.mini_step) == (micro + 1) % accum
        for name, p in model.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(),
                                       np.asarray(params[name]), rtol=0,
                                       atol=1e-6, err_msg=f"{name} {micro}")
            if not applied:
                assert torch.equal(p.detach(), before[name])
        if applied:
            assert opt.optimizer.param_groups[0]["lr"] == pytest.approx(
                float(schedule(opt.count - 1)), rel=1e-12)


def fixmatch_cfg():
    cfg = lockstep_config("xla", "fixmatch")
    cfg["train"]["conf_thresh"] = CONF
    return cfg


def mean_teacher_cfg():
    cfg = resnet_lockstep_config("mean_teacher")
    cfg["train"].update(mt_teacher_eval=True, ema_decay=0.99)
    return cfg


def reco_cfg():
    # test_torch_reco.py's lockstep recipe: every pixel easy, the student's
    # probabilities pick the hard anchors
    cfg = reco_model_config("resnet18")
    cfg["train"].update(conf_thresh=0.7, eash_conf_thresh=0.2,
                        hard_conf_thresh=0.99, contr_temp=0.25,
                        contr_num_queries=16, contr_num_negatives=32)
    return cfg


# (JAX algorithm, port algorithm, config, seed, roles)
CASES = {
    "base": (jax_base, base, lambda: lockstep_config("xla", "base"), 2,
             {"model"}),
    "fixmatch": (jax_fixmatch, fixmatch,
                 fixmatch_cfg, 4, {"model"}),
    "mean_teacher": (jax_mt, mean_teacher, mean_teacher_cfg, 8,
                     {"model", "ema"}),
    "cps": (jax_cps, cps, lambda: resnet_lockstep_config("cps"), 8,
            {"model", "peer"}),
    "reco": (jax_reco, reco, reco_cfg, 8, {"model", "ema"}),
}


@pytest.mark.parametrize("algorithm", list(CASES))
def test_accumulation_lockstep_matches_jax(algorithm, monkeypatch):
    jax_algo, port_algo, make_cfg, seed, roles = CASES[algorithm]
    cfg = copy.deepcopy(make_cfg())
    cfg["train"]["accum_iter"] = ACCUM
    if algorithm == "reco":
        calls = []

        def draws_of_the_jax_package(gen, num_classes, num_queries,
                                     num_negatives, device):
            calls.append(len(calls))
            return jax_draws(jax.random.fold_in(
                jax.random.key(cfg["seed"] + 7), calls[-1]))

        monkeypatch.setattr(reco_loss, "reco_draws",
                            draws_of_the_jax_package)
    impl = cfg["backbone"].get("vit_tiny", {}).get("attention_impl", "xla")
    theirs, ours, jax_sds, port_sds = lockstep_states(
        impl, algorithm, jax_algo, port_algo, seed=seed, cfg=cfg)
    assert set(jax_sds) == set(port_sds) == roles | {"acc_grads"}
    for step, (a, b) in enumerate(zip(ours, theirs)):
        assert a.keys() == b.keys()
        for k in a:
            if k == "mask_ratio":  # the same count of confident pixels
                assert round(a[k] * BATCH * SEQ) == \
                    round(b[k] * BATCH * SEQ), step
            else:
                assert a[k] == pytest.approx(b[k], rel=1e-5), (step, k)
    if algorithm == "fixmatch":
        assert any(0 < m["mask_ratio"] < 1 for m in theirs)
    for role in roles:
        assert_states_agree(jax_sds[role], port_sds[role])
    for key, want in jax_sds["acc_grads"].items():
        got = port_sds["acc_grads"][key].detach()
        err = (got - want).abs().max().item()
        assert err <= GRAD_RTOL * want.abs().max().item() + GRAD_ATOL, \
            (key, err)


def test_two_ranks_accumulate_as_one_process(tmp_path):
    cfg = lockstep_config("xla", "mean_teacher")
    cfg["train"].update(accum_iter=ACCUM, ema_decay=0.99)
    model = init_model(cfg, torch.device("cpu"), seed=3)
    run = {"config": cfg, "batches": global_batches(5),
           "states": {"model": {k: v.numpy() for k, v in
                                model.state_dict().items()}}}
    ranks = [r[0] for r in run_ranks([("steps", {"runs": [run]})],
                                     str(tmp_path), timeout=240)]
    trainer = Trainer(copy.deepcopy(cfg), mean_teacher.SPEC,
                      torch.device("cpu"), K, model=model)
    metrics = [{k: float(v) for k, v in trainer.train_step(
        {k: torch.from_numpy(v) for k, v in batch.items()}).items()}
        for batch in run["batches"]]
    assert trainer.optimizer.count == 1 and trainer.optimizer.micro_step == 1
    for step, (a, b) in enumerate(zip(ranks[0][0]["metrics"], metrics)):
        for k in b:
            assert a[k] == pytest.approx(b[k], rel=1e-5), (step, k)
    assert_ranks_equal(ranks, 0)
    got = ranks[0][0]["states"]
    for role, module in (("model", trainer.model), ("ema", trainer.teacher)):
        assert_states_agree(module.state_dict(), state_dicts(got[role]))


SCAN_ACCUMS = (1, 2)
SCAN_WORLD, SCAN_ROWS = 2, 4  # ranks, rows a rank


@pytest.fixture(scope="module")
def scan_runs(tmp_path_factory):
    """For each of SCAN_ACCUMS the JAX package's 2-device run, two gloo
    ranks' run and one process's run holding both shards, each of its
    ``scan`` experiment directory; the ranks' final states."""
    import yaml

    from semi_seg_ecg_tpu_torch.algorithms import common, fixmatch
    from semi_seg_ecg_tpu_torch.config import normalize_config
    from semi_seg_ecg_tpu_torch.data.synthetic import make_synthetic_dataset
    from semi_seg_ecg_tpu_torch.utils.weights import jax_trees_to_state_dict
    from tests.test_torch_scan_steps import jax_run_training, jax_scan_config

    root = tmp_path_factory.mktemp("scan_ranks")
    data = make_synthetic_dataset(str(root / "data"), num_train_labeled=8,
                                  num_train_unlabeled=32, num_valid=2,
                                  num_test=2, length=SEQ, seed=12)

    def config(side, accum, resume=None):
        cfg = jax_scan_config(root / f"{side}{accum}", data)
        cfg["dataloader"]["batch_size"] = SCAN_ROWS
        cfg["train"]["accum_iter"] = accum
        if resume is not None:
            cfg["resume"] = resume
        return cfg

    monkeypatch = pytest.MonkeyPatch()
    dirs = {accum: {"jax": root / f"jax{accum}" / "scan"}
            for accum in SCAN_ACCUMS}
    try:
        params, stats = jax_run_training(config("jax", SCAN_ACCUMS[0]),
                                         monkeypatch, devices=SCAN_WORLD)
        # the JAX run's initial trees, as a torch file each port run
        # resumes from (the model restored, the optimizer fresh)
        cfg = normalize_config(config("port", 1))
        model = common.init_model(cfg, torch.device("cpu"))
        init = str(root / "init.pth")
        torch.save({"model": jax_trees_to_state_dict(
            params, stats, model.state_dict().keys())}, init)
        paths = []
        for accum in SCAN_ACCUMS:
            path = str(root / f"ranks{accum}.yaml")
            with open(path, "w") as f:
                yaml.safe_dump(config("ranks", accum, init), f)
            paths.append(path)
        handle = start_ranks([("run_training", {"argv": ["-f", path]})
                              for path in paths], str(root / "ranks"),
                             world=SCAN_WORLD)
        for accum in SCAN_ACCUMS[1:]:
            jax_run_training(config("jax", accum), monkeypatch,
                             devices=SCAN_WORLD)
        for accum in SCAN_ACCUMS:
            with data_parallel_size(SCAN_WORLD):
                common.run_training(normalize_config(
                    config("one", accum, init)), fixmatch.SPEC)
        codes, logs, results = wait_ranks(handle, 240)
    finally:
        monkeypatch.undo()
    for r, (code, log) in enumerate(zip(codes, logs)):
        assert code == 0, f"rank {r}:\n{log[-4000:]}"
    for i, accum in enumerate(SCAN_ACCUMS):
        dirs[accum].update(one=root / f"one{accum}" / "scan",
                           ranks=root / f"ranks{accum}" / "scan",
                           states=[results[r][i]["states"]
                                   for r in range(SCAN_WORLD)])
    return dirs


@pytest.mark.parametrize("accum", SCAN_ACCUMS)
def test_two_ranks_scan_steps_match_jax_mesh_and_one_process(scan_runs,
                                                             accum):
    from tests.test_torch_scan_steps import assert_scan_runs_agree

    run = scan_runs[accum]
    for want, got in (("jax", "one"), ("jax", "ranks"), ("one", "ranks")):
        assert_scan_runs_agree(run[want], run[got], 4)
    first, second = run["states"]
    assert first.keys() == second.keys() == {"model"}
    for k, v in first["model"].items():
        np.testing.assert_array_equal(v, second["model"][k], err_msg=k)
