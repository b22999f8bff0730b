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
from tests.torch_dist_worker import run_ranks
from tests.test_torch_train_slice import (
    BATCH,
    K,
    SEQ,
    assert_states_agree,
    lockstep_config,
    lockstep_states,
    resnet_lockstep_config,
)

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
