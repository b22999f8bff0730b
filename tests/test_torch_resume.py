"""Resume (``resume:`` / ``--resume``) in the port, on the CPU.

Self-resume, bit for bit. The tiny ViT recipes of base, Mean Teacher and
CPS (``tiny_recipe``, device augmentation, flash attention's plain
version, bf16 autocast, dropout on) train 2 epochs of 3 micro-steps with
``accum_iter: 2``, so a window is open at the first epoch's end. The
straight run writes a snapshot after each epoch; a second run resumes from
the first snapshot through the command line's ``--resume``. The resumed
run's epoch equals the straight run's second: its ``log.txt`` row (but the
wall clock), and its snapshot, which holds the model, the teacher or the
peer, both optimizers (moments, update count, the open window's summed
gradients), the step, the metrics and the best-so-far thresholds, equal
the straight run's array for array. The logged lr is the schedule's at
``global_step // accum_iter``. Two gloo ranks of CPS
(``tests/torch_dist_worker.py``) do the same: rank 0 writes the snapshot,
and the open window it holds is the ranks' mean partial sum, so the
resumed ranks equal the straight ones bit for bit.

From a JAX ``.ckpt``. Three base steps (the tiny lockstep ViT, AdamW, with
and without ``accum_iter: 2``) through the JAX package's jitted step are
saved by its ``save_checkpoint``; the JAX package's ``maybe_resume`` and
the port's (into a model of other weights) each restore the file and take
three more steps on the same batches. The states agree within
``assert_states_agree``'s bounds (BN statistics 1e-5; parameters 0.2 lr,
the key bias 6 lr).

The optax-leaf bridge (``utils/optim_state.py``) on each layout the JAX
package writes (AdamW, SGD with and without momentum, each under
``optax.MultiSteps`` or not, frozen stages): every moment, momentum buffer
and open-window gradient equals the JAX leaf found by its tree path, laid
out as torch lays it, and a list of another length raises naming both
counts. A ``.pth`` restores the model and restarts the optimizer; a
port ``.ckpt`` hands its best thresholds on; ST++ refuses to resume; the
command line carries ``--resume`` and ``--start_epoch``.
"""

import copy
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from semi_seg_ecg_tpu.algorithms import base as jax_base
from semi_seg_ecg_tpu.models import build_model_from_config as jax_build
from semi_seg_ecg_tpu.utils import checkpoint as jax_ckpt
from semi_seg_ecg_tpu.utils.optimizer import build_optimizer as jax_optimizer
from semi_seg_ecg_tpu.utils.train_state import ModelState, TrainState
from semi_seg_ecg_tpu_torch.algorithms import base, get_algorithm, stpp
from semi_seg_ecg_tpu_torch.algorithms.common import Trainer, run_training
from semi_seg_ecg_tpu_torch.config import parse_train_args
from semi_seg_ecg_tpu_torch.data.synthetic import make_synthetic_dataset
from semi_seg_ecg_tpu_torch.models import build_model_from_config
from semi_seg_ecg_tpu_torch.utils import checkpoint as torch_ckpt
from semi_seg_ecg_tpu_torch.utils.optim_state import load_optax_leaves
from semi_seg_ecg_tpu_torch.utils.optimizer import (
    build_optimizer,
    make_lr_schedule,
)
from semi_seg_ecg_tpu_torch.utils.weights import jax_trees_to_state_dict
from tests.test_torch_train_slice import (
    K,
    SEQ,
    assert_states_agree,
    batches,
    lockstep_config,
    perturbed_state,
    port_model,
    tiny_recipe,
)
from tests.torch_dist_worker import run_ranks
from tests.torch_dist_worker import one_thread  # noqa: F401 (autouse)

ACCUM, STEPS_PER_EPOCH = 2, 3
CPU = torch.device("cpu")


def assert_payloads_equal(got, want, path="payload"):
    """Equal structure and values, arrays bit for bit."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), path
        for k in want:
            assert_payloads_equal(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_payloads_equal(g, w, f"{path}/{i}")
    elif isinstance(want, np.ndarray):
        np.testing.assert_array_equal(got, want, err_msg=path)
        assert got.dtype == want.dtype, path
    else:
        assert got == want, path


def window_recipe(tmp_path, algorithm, ranks=1):
    """The tiny ViT recipe of ``algorithm`` for 2 epochs of 3 micro-steps
    a rank with ``accum_iter: 2``; returns its config and path."""
    recipe = "scratch" if algorithm == "base" else algorithm
    cfg, _ = tiny_recipe(tmp_path, "vit_tiny", recipe, "straight")
    rows = ranks * cfg["dataloader"]["batch_size"] * STEPS_PER_EPOCH
    data = make_synthetic_dataset(
        str(tmp_path / "data_odd"), num_train_labeled=rows,
        num_train_unlabeled=rows, num_valid=2, num_test=2, length=SEQ,
        seed=5)
    cfg["dataset"].update(data)
    cfg["train"].update(epochs=2, accum_iter=ACCUM)
    path = str(tmp_path / "recipe.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return cfg, path


def assert_resumed_equals_straight(exps, config, algorithm):
    """The straight run's first snapshot holds an open window; the resumed
    run's epoch equals the straight run's second: its ``log.txt`` row (but
    the wall clock) and its snapshot, array for array."""
    payload = torch_ckpt.load_checkpoint(
        str(exps / "straight" / "checkpoint-1.ckpt"))
    # the window of micro-steps 2-3 is open at the first epoch's end
    assert payload["step"] == STEPS_PER_EPOCH
    assert payload["optimizer"]["micro_step"] == 1
    assert payload["optimizer"]["count"] == 1
    assert payload["optimizer"]["acc_grads"]
    rows = {}
    for name in ("straight", "resumed"):
        with open(exps / name / "log.txt") as f:
            rows[name] = [json.loads(line) for line in f]
        for row in rows[name]:
            row.pop("wall_s")
    assert [r["epoch"] for r in rows["resumed"]] == [1]
    assert rows["resumed"][0] == rows["straight"][1]
    # the logged lr: the schedule of max(3 // 2, 1) = 1 update an epoch at
    # update global_step // accum_iter
    lr_fn = make_lr_schedule(config["train"], 1)
    for epoch, row in enumerate(rows["straight"]):
        steps = range(epoch * STEPS_PER_EPOCH, (epoch + 1) * STEPS_PER_EPOCH)
        assert row["train_lr"] == pytest.approx(
            np.mean([lr_fn(g // ACCUM) for g in steps]), rel=1e-12)

    want, got = (torch_ckpt.load_checkpoint(str(exps / name /
                                                "checkpoint-2.ckpt"))
                 for name in ("straight", "resumed"))
    assert want["step"] == 2 * STEPS_PER_EPOCH
    assert want["optimizer"]["count"] == 3
    extras = {"base": set(), "mean_teacher": {"model_ema"},
              "cps": {"model_peer", "peer_optimizer"}}[algorithm]
    assert extras <= set(want)
    for payload in (got, want):
        payload.pop("config")
    assert_payloads_equal(got, want)


@pytest.mark.parametrize("algorithm", ["base", "mean_teacher", "cps"])
def test_self_resume_is_bit_equal(algorithm, tmp_path):
    _, path = window_recipe(tmp_path, algorithm)
    spec = get_algorithm(algorithm).SPEC
    exps = tmp_path / "exps"
    run_training(parse_train_args(["-f", path]), spec,
                 snapshot_epochs={1, 2})
    config = parse_train_args(["-f", path, "--exp_name", "resumed",
                               "--resume", str(exps / "straight" /
                                               "checkpoint-1.ckpt")])
    run_training(config, spec, snapshot_epochs={2})
    assert config["start_epoch"] == 1
    assert_resumed_equals_straight(exps, config, algorithm)


def test_two_ranks_resume_the_global_window(tmp_path):
    """Rank 0 writes the checkpoint, but the open window's gradients in it
    are the global batch's: every rank of the resumed run continues the
    window the straight run continued."""
    _, path = window_recipe(tmp_path, "cps", ranks=2)
    exps = tmp_path / "exps"
    argv = ["-f", path, "--exp_name", "resumed", "--resume",
            str(exps / "straight" / "checkpoint-1.ckpt")]
    ranks = run_ranks([
        ("run_training", {"argv": ["-f", path], "snapshot_epochs": [1, 2]}),
        ("run_training", {"argv": argv, "snapshot_epochs": [2]}),
    ], str(tmp_path / "ranks"), timeout=240)
    assert [r[1]["start_epoch"] for r in ranks] == [1, 1]
    assert_resumed_equals_straight(exps, parse_train_args(argv), "cps")


def jax_base_steps(cfg, params, stats, accum):
    """The JAX package's base training: its chain (under MultiSteps with
    ``accum``), the jitted step and a fresh state from the trees."""
    jmodel = jax_build(cfg, train=True)
    tx = jax_optimizer(cfg, params, K, model=jmodel)
    if accum > 1:
        tx = optax.MultiSteps(tx, every_k_schedule=accum)
    step = jax.jit(jax_base.make_train_step(jmodel, tx, cfg, K))
    state = TrainState(step=jnp.asarray(0, jnp.int32),
                       model=ModelState(params, stats),
                       opt_state=tx.init(params))
    return step, state


def run_jax(step, state, seed):
    for batch in batches(seed):
        state, _ = step(state, {k: jnp.asarray(v) for k, v in batch.items()})
    return state


@pytest.mark.parametrize("accum", [1, 2])
def test_resume_from_a_jax_checkpoint_matches_jax(accum, tmp_path):
    cfg = lockstep_config("xla", "base")
    cfg["train"]["accum_iter"] = accum
    jmodel = jax_build(cfg, train=True)
    params, stats = perturbed_state(jmodel, 2)
    step, state = jax_base_steps(cfg, params, stats, accum)
    state = run_jax(step, state, 2)
    path = str(tmp_path / "jax.ckpt")
    jax_ckpt.save_checkpoint(path, 0, state.model, opt_state=state.opt_state,
                             config=cfg, step=int(state.step),
                             best={"loss": 0.5, "MeanIoU": 0.25})
    # both packages resume into other weights and a fresh optimizer
    other, other_stats = perturbed_state(jmodel, 3)
    _, fresh = jax_base_steps(cfg, other, other_stats, accum)
    jax_config = {"resume": path}
    resumed = jax_ckpt.maybe_resume(jax_config, fresh)
    config = dict(copy.deepcopy(cfg), resume=path)
    trainer = Trainer(config, base.SPEC, CPU, K,
                      model=port_model(cfg, other, other_stats))
    assert trainer.step == int(resumed.step) == K
    assert config["start_epoch"] == jax_config["start_epoch"] == 1
    assert trainer.resume_best == {"loss": 0.5, "MeanIoU": 0.25}
    assert trainer.optimizer.micro_step == (K % accum)
    resumed = run_jax(step, resumed, 3)
    for batch in batches(3):
        trainer.train_step({k: torch.from_numpy(v).long() if k == "target"
                            else torch.from_numpy(v)
                            for k, v in batch.items()})
    assert trainer.optimizer.count == 2 * K // accum
    port_sd = trainer.model.state_dict()
    assert_states_agree(jax_trees_to_state_dict(
        resumed.model.params, resumed.model.batch_stats, port_sd.keys()),
        port_sd)


def leaves_by_part(opt_state):
    """The optax state's P-long parts as trees of NumPy leaves, by the
    attribute that holds them (``mu``, ``nu``, ``trace``, ``acc_grads``),
    from the leaves' own tree paths."""
    parts = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(opt_state)[0]:
        attrs = [k.name for k in path
                 if isinstance(k, jax.tree_util.GetAttrKey)]
        keys = [k.key for k in path if isinstance(k, jax.tree_util.DictKey)]
        if not keys:
            continue
        node = parts.setdefault(attrs[-1], {})
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = np.asarray(leaf)
    return parts


LAYOUTS = {
    "adamw": ("adamw", {}, 1, -1),
    "adamw_accum_frozen": ("adamw", {}, 2, 1),
    "sgd_momentum": ("sgd", {"momentum": 0.9}, 1, -1),
    "sgd_momentum_accum": ("sgd", {"momentum": 0.9}, 3, -1),
    "sgd_accum": ("sgd", {}, 2, -1),
}


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_optax_leaves_bridge(layout):
    name, kwargs, accum, frozen_stages = LAYOUTS[layout]
    cfg = lockstep_config("xla", "base")
    cfg["train"].update(optimizer=name, optimizer_kwargs=kwargs,
                        accum_iter=accum, max_norm=1.0)
    cfg["backbone"]["vit_tiny"]["frozen_stages"] = frozen_stages
    jmodel = jax_build(cfg, train=True)
    params, stats = perturbed_state(jmodel, 6)
    tx = jax_optimizer(cfg, params, K, model=jmodel)
    if accum > 1:
        tx = optax.MultiSteps(tx, every_k_schedule=accum)
    # every array leaf random (second moments positive), every count 1:
    # one update made, one micro-step of an open window
    rng = np.random.default_rng(0)
    opt_state = jax.tree.map(
        lambda a: jnp.ones_like(a) if a.ndim == 0 else jnp.asarray(
            np.abs(rng.standard_normal(a.shape)).astype(np.float32)),
        tx.init(params))
    model = port_model(cfg, params, stats)
    opt = build_optimizer(cfg, model, K)
    load_optax_leaves(opt, jax.tree.leaves(opt_state), params,
                      model.state_dict().keys())
    assert opt.count == 1
    assert opt.micro_step == (1 if accum > 1 else 0)
    parts = {part: jax_trees_to_state_dict(tree, stats,
                                           model.state_dict().keys())
             for part, tree in leaves_by_part(opt_state).items()}
    assert set(parts) == {"adamw": {"mu", "nu"},
                          "sgd": {"trace"} if kwargs else set()}[name] | (
        {"acc_grads"} if accum > 1 else set())
    held = set(opt.names)
    frozen = {n for n, _ in model.named_parameters()} - held
    assert bool(frozen) == (frozen_stages >= 0)
    torch_keys = {"mu": "exp_avg", "nu": "exp_avg_sq",
                  "trace": "momentum_buffer"}
    for pname, p in model.named_parameters():
        state = opt.optimizer.state.get(p, {})
        if pname in frozen:
            assert not state and p.grad is None
            continue
        for part, key in torch_keys.items():
            if part in parts:
                assert torch.equal(state[key], parts[part][pname]), \
                    (pname, part)
        if name == "adamw":
            assert state["step"].dtype == torch.float32 and \
                state["step"].device == CPU and float(state["step"]) == 1
        if accum > 1:
            assert torch.equal(p.grad, parts["acc_grads"][pname])
        else:
            assert p.grad is None
    # a list of another optimizer's layout is refused
    other = lockstep_config("xla", "base")
    other["train"].update(optimizer="sgd", optimizer_kwargs={})
    leaves = jax.tree.leaves(jax_optimizer(other, params, K).init(params))
    with pytest.raises(ValueError, match=rf"has {len(leaves)} leaves.*"
                                         rf"expects {len(jax.tree.leaves(opt_state))}"):
        load_optax_leaves(opt, leaves, params, model.state_dict().keys())


def test_resume_from_a_torch_checkpoint_restarts_the_optimizer(tmp_path):
    cfg = lockstep_config("xla", "base")
    saved = build_model_from_config(cfg, train=True)
    with torch.no_grad():
        for p in saved.parameters():
            p.add_(1.0)
    path = str(tmp_path / "model.pth")
    torch_ckpt.save_torch_checkpoint(path, saved, epoch=3)
    config = dict(copy.deepcopy(cfg), resume=path)
    trainer = Trainer(config, base.SPEC, CPU, K,
                      model=build_model_from_config(cfg, train=True))
    for k, v in saved.state_dict().items():
        assert torch.equal(trainer.model.state_dict()[k], v), k
    assert config["start_epoch"] == 4
    assert trainer.step == 0 and trainer.optimizer.count == 0
    assert not trainer.optimizer.optimizer.state
    assert trainer.resume_best is None


def test_resume_restores_best_thresholds(tmp_path):
    """best-*.ckpt thresholds ride the checkpoint: a resumed run must not
    let its first epoch overwrite the true best files."""
    cfg = lockstep_config("xla", "base")
    model = build_model_from_config(cfg, train=True)
    opt = build_optimizer(cfg, model, K)
    path = str(tmp_path / "best-MeanIoU.ckpt")
    torch_ckpt.save_checkpoint(path, 3, model, opt, config=cfg, step=12,
                               best={"loss": 0.125, "MeanIoU": 0.875})
    config = dict(copy.deepcopy(cfg), resume=f"file://{path}")
    trainer = Trainer(config, base.SPEC, CPU, K,
                      model=build_model_from_config(cfg, train=True))
    assert trainer.resume_best == {"loss": 0.125, "MeanIoU": 0.875}
    assert config["start_epoch"] == 4 and trainer.step == 12


def test_stpp_refuses_resume(tmp_path):
    with pytest.raises(ValueError, match="stpp.*same checkpoint"):
        stpp.train({"resume": str(tmp_path / "x.ckpt")})


def test_cli_carries_resume_and_start_epoch(tmp_path):
    path = str(tmp_path / "cfg.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(lockstep_config("xla", "base"), f)
    config = parse_train_args(["-f", path, "--resume", "run.ckpt",
                               "--start_epoch", "3"])
    assert config["resume"] == "run.ckpt" and config["start_epoch"] == 3
    config = parse_train_args(["-f", path])
    assert config["resume"] is None and config["start_epoch"] == 0
