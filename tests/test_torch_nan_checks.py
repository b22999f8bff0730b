"""``debug.nan_checks`` in the port (``utils/nan_checks.py``) against the
JAX package's ``jax_debug_nans``, on the CPU.

The JAX package sets ``jax_debug_nans`` in ``run_training`` and leaves it
set, so that ``cli.train_main``'s training and its ``test: true`` pass
raise ``FloatingPointError`` where a jitted call returns a NaN. A depth-2
ViT (dense attention, fp32, host augmentation) on a numpy-seeded
synthetic split of 4 steps an epoch, through each package's
``cli.train_main``, with a NaN planted in one record:

- of the train split: both raise at the same step (at ``scan_steps: 2``
  the JAX package raises in the scanned unit that holds the port's step),
  the port at the backward op anomaly mode names, and neither writes a
  ``best-*.ckpt``;
- of the validation split: both raise at epoch 0's first validation
  batch, before the epoch's checkpoints, at K = 1 and 2;
- of the test split, after a clean training run: both raise in the test
  pass. The clean training is FixMatch at K = 2 (one unit of 2 steps)
  from the JAX run's
  initial trees, held to ``tests/test_torch_scan_steps.py``'s rule (train
  losses within rtol 1e-5, the best checkpoint by the lockstep rule), and
  the port's run equals its run without the checks bit for bit.

The JAX package's C++ dispatch path loses the check in JAX 0.9.0 (once
any ``jax.debug_nans(False)`` context, which JAX's own ops enter while
tracing, has exited on a thread, the fast path's hook is cleared there),
so its jitted train step checks its first call only, and a NaN in a later
step's record ends its run at the loss's abort (``Loss is nan``,
``SystemExit``). The comparisons plant the NaN where the JAX package
checks; the port checks every step, as ``jax_debug_nans`` is documented
to (:func:`test_port_checks_every_step`).

Every JAX call runs in a ``try`` whose ``finally`` resets
``jax_debug_nans``, which is process-wide and would reach the next test
of the worker. The host side of a captured step's check (the flags a
graph leaves, the update skipped, the eager rerun) runs here with planted
flags and stand-in graphs; the graphs themselves run on a card
(``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 20). Two gloo
ranks with the NaN on one rank's rows: ``-m slow``.
"""

import copy
import json
import os
import pickle
import re

import jax
import numpy as np
import pytest
import torch
import yaml

from semi_seg_ecg_tpu_torch.algorithms import common, get_algorithm
from semi_seg_ecg_tpu_torch.cli import train_main
from semi_seg_ecg_tpu_torch.config import normalize_config
from semi_seg_ecg_tpu_torch.data.synthetic import make_synthetic_dataset
from semi_seg_ecg_tpu_torch.utils import captured_step
from semi_seg_ecg_tpu_torch.utils import checkpoint as torch_ckpt
from semi_seg_ecg_tpu_torch.utils import nan_checks
from tests.test_torch_resume import assert_payloads_equal
from tests.test_torch_scan_steps import NoWriter, jax_scan_config
from tests.test_torch_train_slice import SEQ
from tests.torch_dist_worker import one_thread, run_ranks  # noqa: F401

STEPS = 4  # an epoch's steps: 8 labeled records, batch 2
BAD_SAMPLE = 100  # the sample of the record made NaN


def nan_config(root, data, algorithm, k, exp_name, test=False):
    """The depth-2 ViT recipe of ``algorithm`` (``jax_scan_config``'s: dense
    attention, dropout 0, host augmentation) on ``data`` at batch 2 for one
    epoch at ``scan_steps: k``, with ``debug.nan_checks``; written under
    ``root``, returns ``(config, path)``."""
    cfg = jax_scan_config(root, data)
    cfg.update(algorithm=algorithm, exp_name=exp_name, test=test,
               debug={"nan_checks": True})
    cfg["dataloader"] = {"batch_size": 2, "num_workers": 0}
    cfg["train"]["scan_steps"] = k
    path = str(root / f"{exp_name}.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return cfg, path


@pytest.fixture
def data(tmp_path):
    return make_synthetic_dataset(str(tmp_path / "data"),
                                  num_train_labeled=2 * STEPS,
                                  num_train_unlabeled=2 * STEPS, num_valid=2,
                                  num_test=2, length=SEQ, seed=5)


def plant_nan(data, split, record):
    """Make one sample of ``split``'s record ``record`` NaN, in its file."""
    path = os.path.join(data["ecg_dir"], f"{split}_{record}.pkl")
    with open(path, "rb") as f:
        x = np.array(pickle.load(f), np.float32)
    x[..., BAD_SAMPLE] = np.nan
    with open(path, "wb") as f:
        pickle.dump(x, f)


def record_at(cfg, step):
    """The train split's record in the first row of epoch 0's ``step``
    (the base recipe's loader, which is the JAX package's)."""
    loaders = common.build_train_loaders(normalize_config(copy.deepcopy(
        cfg)), get_algorithm("base").SPEC)
    try:
        loaders["labeled"].set_epoch(0)
        return int(loaders["labeled"].step_indices()[step, 0, 0])
    finally:
        for loader in loaders.values():
            loader.close()


def one_device_compiled_init(m):
    """With the monkeypatch context ``m``: the JAX package on one of the
    conftest's CPU devices, for speed its init compiled (its op-by-op init
    compiles each op) and TensorBoard's writer (it imports TensorFlow) left
    out."""
    from semi_seg_ecg_tpu.algorithms import common as jax_common

    all_devices = jax.devices
    init_state = jax_common.init_model_state
    m.setattr(jax, "devices", lambda *a: all_devices(*a)[:1])
    m.setattr(jax_common, "init_model_state",
              lambda model, config, seed: jax.jit(
                  lambda: init_state(model, config, seed))())
    m.setattr(jax_common, "TensorBoardWriter", NoWriter)


def jax_train_main(path, monkeypatch):
    """The JAX package's ``cli.train_main`` of ``path`` on one of the
    conftest's CPU devices; returns the ``FloatingPointError`` it raised
    (None), the steps its epochs' loops reached (the first step of each
    scanned unit) and its ``eval_step`` calls."""
    from semi_seg_ecg_tpu.algorithms import common as jax_common
    from semi_seg_ecg_tpu.cli import train_main as jax_main

    steps, evals = [], []

    class Recorded(jax_common.ProfileSchedule):
        def step(self, global_step):
            steps.append(global_step)
            return super().step(global_step)

    make_eval_step = jax_common.make_eval_step

    def counted_eval_step(model, num_classes):
        fn = make_eval_step(model, num_classes)

        def call(*args):
            evals.append(len(evals))
            return fn(*args)

        return call

    with monkeypatch.context() as m:
        one_device_compiled_init(m)
        m.setattr(jax_common, "ProfileSchedule", Recorded)
        m.setattr(jax_common, "make_eval_step", counted_eval_step)
        try:
            jax_main(["-f", path])
            raised = None
        except FloatingPointError as e:
            raised = e
        finally:
            jax.config.update("jax_debug_nans", False)
    return raised, steps, evals


def port_train_main(path):
    """The port's ``cli.train_main`` of ``path``; the ``FloatingPointError``
    it raised."""
    with pytest.raises(FloatingPointError) as info:
        train_main(["-f", path])
    assert not torch.is_anomaly_enabled()
    return info.value


def best_files(root, exp_name):
    exp = root / exp_name
    return sorted(p for p in os.listdir(exp) if p.startswith("best-")) \
        if exp.exists() else []


@pytest.mark.parametrize("k", [1, 2])
def test_train_record_nan_raises_where_the_jax_package_does(
        k, data, tmp_path, monkeypatch):
    """A NaN in the record of the step the JAX package checks (its jitted
    step's first call at K = 1, the second unit's scan at K = 2): both
    raise there, the port at its backward op (anomaly mode's error as the
    cause), and neither writes a checkpoint."""
    cfg, _ = nan_config(tmp_path, data, "base", k, "probe")
    step = 0 if k == 1 else STEPS - 1
    plant_nan(data, "train_labeled", record_at(cfg, step))
    _, path = nan_config(tmp_path, data, "base", k, "jax")
    raised, steps, _ = jax_train_main(path, monkeypatch)
    assert raised is not None and steps[-1] == step - step % k
    _, path = nan_config(tmp_path, data, "base", k, "port")
    error = port_train_main(path)
    assert re.match(rf"debug.nan_checks: train step {step}: Function "
                    r"'\w+Backward\d*' returned nan values", str(error))
    assert isinstance(error.__cause__, RuntimeError)
    assert best_files(tmp_path, "jax") == best_files(tmp_path, "port") == []


def test_valid_record_nan_raises_before_the_checkpoints(data, tmp_path,
                                                        monkeypatch):
    """A NaN in a validation record: both raise at epoch 0's first eval
    batch (the port at K = 1 and 2), before the epoch's checkpoints."""
    plant_nan(data, "valid", 1)
    _, path = nan_config(tmp_path, data, "base", 1, "jax")
    raised, steps, evals = jax_train_main(path, monkeypatch)
    assert raised is not None and evals == [0] and steps == [0, 1, 2, 3]
    for k in (1, 2):
        _, path = nan_config(tmp_path, data, "base", k, f"port{k}")
        error = port_train_main(path)
        assert str(error) == ("debug.nan_checks: NaN in eval_step's probs "
                              "and loss at batch 0 of epoch 0's validation")
        assert best_files(tmp_path, f"port{k}") == []
    assert best_files(tmp_path, "jax") == []


def test_clean_training_then_test_record_nan(data, tmp_path, monkeypatch):
    """The base recipe at K = 2 on clean train and validation splits, then
    a NaN in a test record: the JAX package's ``run_training`` and ``test``
    (its ``train_main``'s two calls) from its initial trees, the port's
    from the same trees; the training runs agree (the epoch's train loss
    within rtol 1e-5, the best checkpoint by the lockstep rule), both test
    passes raise, and the port's run with the checks equals its run
    without them bit for bit."""
    from semi_seg_ecg_tpu.algorithms import base as jax_base
    from semi_seg_ecg_tpu.config import normalize_config as jax_normalize
    from semi_seg_ecg_tpu_torch.algorithms import base
    from semi_seg_ecg_tpu_torch.utils.weights import jax_trees_to_state_dict
    from tests.test_torch_scan_steps import jax_run_training
    from tests.test_torch_train_slice import assert_states_agree

    plant_nan(data, "test", 0)
    configs = {side: nan_config(tmp_path, data, "base", 2, side)[0]
               for side in ("jax", "port", "unchecked")}
    del configs["unchecked"]["debug"]
    try:
        params, stats = jax_run_training(configs["jax"], monkeypatch,
                                         spec=jax_base.SPEC)
        with monkeypatch.context() as m, \
                pytest.raises(FloatingPointError):
            one_device_compiled_init(m)
            jax_base.test(jax_normalize(configs["jax"]))
    finally:
        jax.config.update("jax_debug_nans", False)

    def transplant(trainer):
        trainer.model.load_state_dict(jax_trees_to_state_dict(
            params, stats, trainer.model.state_dict().keys()))

    for side in ("port", "unchecked"):
        cfg = normalize_config(configs[side])
        common.run_training(cfg, base.SPEC, state_hook=transplant)
        if side == "port":
            with pytest.raises(FloatingPointError, match="batch 0 of the "
                               "test pass"):
                base.test(cfg, nan_checks=True)
    rows, payloads = {}, {}
    for side in configs:
        with open(tmp_path / side / "log.txt") as f:
            rows[side] = json.loads(f.readline())
        payloads[side] = torch_ckpt.load_checkpoint(
            str(tmp_path / side / "best-loss.ckpt"))
    assert rows["port"]["train_loss"] == pytest.approx(
        rows["jax"]["train_loss"], rel=1e-5)
    keys = payloads["port"]["model"].keys()
    assert_states_agree(
        torch_ckpt.model_state_dict(payloads["jax"]["model"], keys),
        {k: torch.as_tensor(v) for k, v in payloads["port"]["model"].items()})
    assert payloads["jax"]["step"] == payloads["port"]["step"] == STEPS
    assert {k: v for k, v in rows["port"].items() if k != "wall_s"} == \
        {k: v for k, v in rows["unchecked"].items() if k != "wall_s"}
    assert_payloads_equal(*[{k: payloads[side][k] for k in
                             ("model", "optimizer", "step")}
                            for side in ("port", "unchecked")], "nan_checks")


@pytest.mark.parametrize("split,k", [("train_labeled", 1),
                                     ("train_labeled", 2), ("valid", 2)])
def test_port_checks_every_step(split, k, data, tmp_path):
    """The port checks every step and every epoch's validation, where the
    JAX package's fast path does not (the module docstring): a NaN in the
    record of a later step raises at that step, a NaN in epoch 1's
    validation input at epoch 1."""
    cfg, _ = nan_config(tmp_path, data, "fixmatch", k, "probe")
    if split == "valid":
        cfg["train"]["epochs"] = 2
        passes = []
        evaluate, eval_step = common.evaluate, common.eval_step

        def counted(*args, **kwargs):
            passes.append(kwargs["nan_checks"])
            return evaluate(*args, **kwargs)

        def poisoned(model, x, *args, **kwargs):
            if len(passes) == 2:
                x = x * float("nan")
            return eval_step(model, x, *args, **kwargs)

        with pytest.MonkeyPatch.context() as m:
            m.setattr(common, "evaluate", counted)
            m.setattr(common, "eval_step", poisoned)
            with pytest.raises(FloatingPointError, match="batch 0 of epoch "
                               "1's validation"):
                common.run_training(normalize_config(cfg),
                                    get_algorithm("fixmatch").SPEC)
        assert passes == ["epoch 0's validation", "epoch 1's validation"]
        return
    step = 2
    plant_nan(data, split, record_at(cfg, step))
    _, path = nan_config(tmp_path, data, "fixmatch", k, "port")
    error = port_train_main(path)
    assert str(error).startswith(f"debug.nan_checks: train step {step}: ")
    assert best_files(tmp_path, "port") == []


# ---------------------------------------------------------------------------
# The host side of a captured step under debug.nan_checks
# ---------------------------------------------------------------------------


class StandInGraph:
    """A graph's replay, recorded; ``run`` is its work on the host."""

    def __init__(self, name, replayed, run=None):
        self.name, self.replayed, self.run = name, replayed, run

    def replay(self):
        self.replayed.append(self.name)
        if self.run is not None:
            self.run()


def planted_capture(trainer, batch, grad_flags, metric_flags):
    """A ``CapturedStep`` of a CPU ``trainer`` (the card's parts left
    out): its update kind's two graphs, stand-ins that record their
    replays and leave the planted ``grad_flags`` and ``metric_flags``, the
    second running the update (the optimizer's step past its check) on
    the gradients a backward on ``batch`` left."""
    # the constructor refuses the CPU
    captured = object.__new__(captured_step.CapturedStep)
    captured.trainer = trainer
    captured.keep_graph = False
    captured.optimizers = trainer.optimizers
    captured.remat_calls = []
    captured.replays_by_kind = {kind: 0 for kind in captured_step.KINDS}
    captured.reruns = 0
    captured.static_in = {k: v.clone() for k, v in batch.items()}
    captured.keys = ["loss"]
    captured.static_out = {"update": torch.zeros(1)}
    replayed = []

    def update():
        # the update a graph applies; the host counters are replay's
        trainer.optimizer.optimizer.step()

    captured.graphs = {"update": [
        (StandInGraph("backward", replayed), grad_flags),
        (StandInGraph("update", replayed, update), metric_flags)]}
    return captured, replayed


def planted_trainer(tmp_path, data):
    cfg, _ = nan_config(tmp_path, data, "base", 2, "host")
    cfg = normalize_config(cfg)
    trainer = common.Trainer(cfg, get_algorithm("base").SPEC,
                             torch.device("cpu"), STEPS)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 1, SEQ)).astype(np.float32))
    batch = {"ecg": x, "target": torch.zeros(2, SEQ, dtype=torch.int64)}
    return trainer, batch


@pytest.mark.parametrize("case", ["clear", "metrics", "not_reproduced",
                                  "reproduced"])
def test_captured_step_host_decision(case, data, tmp_path):
    """With clear flags a replay runs both graphs and counts the step; with
    the metrics' flag set it raises after the update, naming the metric;
    with a gradient's flag set the update's graph does not run, the
    parameters, optimizer and counters stay as they were, the gradients
    the graph holds come back, and the step's eager rerun under anomaly
    mode raises: at the backward op when the batch holds the NaN, else
    naming the flagged gradient as not reproduced; the update's lr is not
    written."""
    trainer, batch = planted_trainer(tmp_path, data)
    n = sum(len(o.params) for o in trainer.optimizers) + 1
    grads, metrics = torch.zeros(n), torch.zeros(1)
    if case in ("not_reproduced", "reproduced"):
        grads[3] = 1.0
    if case == "metrics":
        metrics[0] = 1.0
    if case == "reproduced":
        batch = dict(batch, ecg=batch["ecg"].clone())
        batch["ecg"][1, 0, BAD_SAMPLE] = float("nan")
    captured, replayed = planted_capture(trainer, batch, grads, metrics)
    trainer.captured = captured
    # a later update, whose lr is not the one the optimizer holds
    trainer.optimizer.count = 2
    loss = trainer.model(batch["ecg"], labels=batch["target"],
                         return_loss=True)["loss"]
    loss.backward()
    held = [p.grad for p in trainer.optimizer.params]
    before = {n: p.detach().clone()
              for n, p in trainer.model.named_parameters()}
    lrs = [g["lr"] for g in trainer.optimizer.optimizer.param_groups]
    if case == "clear":
        out = captured.step(batch)
        assert replayed == ["backward", "update"] and list(out) == ["loss"]
        assert (trainer.step, trainer.optimizer.count) == (1, 3)
        return
    name = trainer.optimizer.names[2]
    want = {"metrics": "train step 0: NaN in the step's loss",
            "not_reproduced": f"train step 0: the captured step's gradients "
                              f"of {name} held a NaN, and the step's eager "
                              "rerun did not reproduce it",
            "reproduced": r"train step 0: Function '\w+Backward\d*' "
                          "returned nan values"}[case]
    with pytest.raises(FloatingPointError, match=want):
        captured.step(batch)
    if case == "metrics":
        assert replayed == ["backward", "update"]
        assert trainer.step == 1
        return
    assert replayed == ["backward"] and captured.reruns == 1
    assert (trainer.step, trainer.optimizer.count) == (0, 2)
    assert trainer.nan_rerun is None and not torch.is_anomaly_enabled()
    assert all(p.grad is g for p, g in zip(trainer.optimizer.params, held))
    for n, p in trainer.model.named_parameters():
        assert torch.equal(p, before[n]), n
    assert not trainer.optimizer.optimizer.state
    # the update's lr is written before the update's graph only
    assert [g["lr"] for g in trainer.optimizer.optimizer.param_groups] == lrs


def test_grad_flags_mark_nan_not_inf():
    """One flag a trainable parameter, set by a NaN element and not by an
    inf (``jax_debug_infs`` stays off), zero where a parameter has no
    gradient; element 0 is the find of a rank's backward ops."""
    params = [torch.nn.Parameter(torch.zeros(3)) for _ in range(4)]

    class Opt:
        pass

    opt = Opt()
    opt.params, opt.names = params, ["a", "b", "c", "d"]
    params[0].grad = torch.tensor([1.0, float("nan"), 2.0])
    params[1].grad = torch.tensor([float("inf"), 1.0, 0.0])
    params[2].grad = torch.full((3,), 3e38)  # its norm overflows
    flags = nan_checks.grad_flags([opt])
    assert flags.tolist() == [0.0, 1.0, 0.0, 0.0, 0.0]
    assert nan_checks.flagged_names(flags.tolist(), [opt]) == ["a"]
    with pytest.raises(FloatingPointError, match="train step 7: NaN in the "
                       "gradients of a "):
        nan_checks.raise_for_grads(flags, [opt], 7)
    flags[1] = 0.0
    flags[0] = 1.0
    with pytest.raises(FloatingPointError, match="another rank's backward"):
        nan_checks.raise_for_grads(flags, [opt], 7)
    nan_checks.raise_for_grads(torch.zeros(5), [opt], 7)
    with pytest.raises(FloatingPointError, match="did not reproduce"):
        nan_checks.raise_for_grads(torch.zeros(5), [opt], 7, rerun_of=["a"])


@pytest.mark.slow
def test_two_ranks_raise_with_the_nan_on_one(data, tmp_path):
    """Two gloo ranks at ``scan_steps`` 1 and 2, FixMatch and CPS, a NaN on
    rank 1 only, in its signal or in its losses: each rank raises
    ``FloatingPointError`` at step 0 and none waits at a collective (the
    group ends within its timeout). Rank 1 names the backward op; rank 0
    names the op the NaN reached it at (through the head's BatchNorm
    statistics over the ranks, forward or backward) or, where it did not,
    says another rank's backward returned it (the gradients' flags over
    the ranks)."""
    runs = []
    for algorithm, k, where in (("fixmatch", 1, "ecg"),
                                ("fixmatch", 2, "loss"),
                                ("cps", 1, "loss"), ("cps", 2, "ecg")):
        _, path = nan_config(tmp_path, data, algorithm, k,
                             f"{algorithm}{k}")
        runs.append(("nan_checks", {"argv": ["-f", path], "rank": 1,
                                    "where": where}))
    results = run_ranks(runs, str(tmp_path / "ranks"), timeout=240)
    for r, by_run in enumerate(results):
        for message in by_run:
            assert message.startswith("debug.nan_checks: train step 0: ")
            at_op = re.search(r"Function '\w+' returned nan values \(rank "
                              rf"{r}, found after the backward\)", message)
            assert at_op if r == 1 else at_op or "another rank's backward" \
                in message, (r, message)


def test_backward_nans_lets_the_step_graph_go():
    """``BackwardNans`` holds the nodes it hooks while inside and lets them
    go on exit: a held graph would keep the parameters' gradient
    accumulators, with the stream they were made on, into the next step
    (on a card a capture on another stream then waits on that one: found
    over NCCL ranks). It records, in the backward's order, the node that
    returned a NaN."""
    lin = torch.nn.Linear(4, 4)

    def accumulator():
        return lin.weight.expand_as(lin.weight).grad_fn.next_functions[0][0]

    with nan_checks.BackwardNans() as found:
        out = lin(torch.randn(2, 4))
        accumulator().metadata["step"] = 0
        (out * float("nan")).sum().backward()
        assert found.first() == "MulBackward0" and found.any()
    del out
    assert "step" not in accumulator().metadata
