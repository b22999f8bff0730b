"""``train.scan_steps`` in the port (``utils/captured_step.py``), on the CPU.

On the CPU a unit of K stacked batches runs its K steps eagerly (on a
card each is a replay of the captured step: ``tests/test_torch_cuda.py``
and ``chip_smoke.py`` phase 18 hold those). Here:

- the port's ``scan_steps: 2`` FixMatch run (one epoch of 4 steps, one
  process holding the JAX mesh's 8 shards) against the JAX package's
  ``scan_steps: 2`` run (its ``jax.lax.scan`` of 2 jitted steps) from the
  same transplanted init, dropout 0, host augmentation (both packages draw
  it alike): the epoch's train losses within rtol 1e-5 and the final state
  by ``tests/test_torch_train_slice.py``'s lockstep rule
  (``assert_states_agree``: BatchNorm statistics within 1e-5, every
  parameter within ``PARAM_ATOL_LR`` lr and all but the key bias within
  ``TIGHT_ATOL_LR`` lr);
- each of the six algorithms at K = 2 (two units and a tail of 1) and
  K = 8 (all tail) against K = 1, bit for bit: every step's logged scalars
  with its lr, the ``log.txt`` rows but their wall time, and every
  checkpoint's networks and optimizers;
- the units, the refusals, and the host side of a captured step that runs
  without a card: the optimizer's lr tensors filled per update, its
  checkpoint in the eager layout, and the graph's kernel names read from
  its DOT description. (The remat stand-ins need a CUDA generator's
  offset, which a CPU generator does not keep: the card tests hold them.)
"""

import copy
import glob
import json
import os

import numpy as np
import pytest
import torch
import yaml

from semi_seg_ecg_tpu_torch.algorithms import common, get_algorithm
from semi_seg_ecg_tpu_torch.data.synthetic import make_synthetic_dataset
from semi_seg_ecg_tpu_torch.utils import captured_step
from semi_seg_ecg_tpu_torch.utils import checkpoint as torch_ckpt
from semi_seg_ecg_tpu_torch.utils.logging import MetricLogger
from semi_seg_ecg_tpu_torch.utils.optimizer import build_optimizer
from tests.test_torch_resume import assert_payloads_equal
from tests.test_torch_train_slice import (
    REPO,
    SEQ,
    lockstep_config,
    tiny_recipe,
)
from tests.torch_dist_worker import one_thread  # noqa: F401 (autouse)

STEPS = 3  # an epoch's steps: K = 2 leaves a tail of 1, K = 8 all tail
RECIPES = {"base": "scratch", "fixmatch": "fixmatch",
           "mean_teacher": "mean_teacher", "cps": "cps", "reco": "reco",
           "stpp": "stpp"}
NETS = ("model", "optimizer", "model_ema", "model_peer", "peer_optimizer",
        "step", "epoch")


def run_port(cfg, root, algorithm, k, monkeypatch):
    """One ``algorithm.train`` of ``cfg`` at ``scan_steps: k`` under
    ``root``; returns every step's logged scalars (lr included), the
    ``log.txt`` rows without their wall time, and each checkpoint's
    networks by path."""
    cfg = copy.deepcopy(cfg)
    cfg["train"]["scan_steps"] = k
    cfg["output_dir"] = str(root / f"k{k}")
    rows = []

    class Recorded(MetricLogger):
        def update(self, **kwargs):
            rows.append(kwargs)
            super().update(**kwargs)

    monkeypatch.setattr(common, "MetricLogger", Recorded)
    get_algorithm(algorithm).train(cfg)
    torch_ckpt.wait_for_pending()
    exp = os.path.join(cfg["output_dir"], cfg["exp_name"])
    logs, ckpts = {}, {}
    for path in sorted(glob.glob(os.path.join(exp, "**", "log.txt"),
                                 recursive=True)):
        with open(path) as f:
            logs[os.path.relpath(path, exp)] = [
                {k: v for k, v in json.loads(line).items() if k != "wall_s"}
                for line in f]
    for path in sorted(glob.glob(os.path.join(exp, "**", "*.ckpt"),
                                 recursive=True)):
        payload = torch_ckpt.load_checkpoint(path)
        ckpts[os.path.relpath(path, exp)] = {
            k: payload[k] for k in NETS if k in payload}
    return rows, logs, ckpts


@pytest.fixture(scope="module")
def recipes(tmp_path_factory):
    """Each algorithm's tiny ViT recipe (depth 2, flash attention, device
    augmentation, dropout as shipped) on a split of ``STEPS`` steps."""
    root = tmp_path_factory.mktemp("scan_recipes")
    data = make_synthetic_dataset(str(root / "data"),
                                  num_train_labeled=2 * STEPS,
                                  num_train_unlabeled=2 * STEPS, num_valid=2,
                                  num_test=2, length=SEQ, seed=11)
    out = {}
    for algorithm, recipe in RECIPES.items():
        cfg, _ = tiny_recipe(root, "vit_tiny", recipe, algorithm)
        cfg["dataset"].update(data)
        if algorithm == "reco":  # fewer contrastive samples, same code
            cfg["train"].update(contr_num_queries=32, contr_num_negatives=64)
        out[algorithm] = cfg
    return out


@pytest.mark.parametrize("algorithm", list(RECIPES))
def test_scan_steps_equal_one_step_a_dispatch(algorithm, recipes, tmp_path,
                                              monkeypatch):
    cfg = recipes[algorithm]
    want = run_port(cfg, tmp_path, algorithm, 1, monkeypatch)
    rows, logs, ckpts = want
    # ST++: stage 1, then stage 2 on the reliable half, then stage 3
    assert len(rows) >= STEPS and all("lr" in r for r in rows)
    assert logs and ckpts
    for k in (2, 8):
        got = run_port(cfg, tmp_path, algorithm, k, monkeypatch)
        assert got[0] == rows, k
        assert got[1] == logs, k
        assert got[2].keys() == ckpts.keys(), k
        assert_payloads_equal(got[2], ckpts, f"k{k}")


def jax_scan_config(root, data):
    """The lockstep's depth-2 ViT FixMatch (dense attention, dropout 0)
    as a run: batch 8, 4 steps, one epoch, host augmentation,
    ``scan_steps: 2``."""
    cfg = lockstep_config("xla", "fixmatch")
    cfg.update(device="cpu", output_dir=str(root), exp_name="scan",
               mode="scratch", resume=None, start_epoch=0)
    # no resize crop: the edge samples it repeats make constant patches,
    # where the ViT's two patch LayerNorms raise each package's rounding
    # noise to O(0.1) in the logits
    cfg["dataset"].update(
        data, device_augment=False, augmentations=[],
        strong_augmentations=[{"RandAugment": {
            "ops": [{"AmplitudeScaling": {"sigma": 0.5}}],
            "level": 10, "num_layers": 1, "prob": 0.5}}],
        transforms=[{"standardize": {"axis": [-1, -2]}},
                    {"to_tensor": {"dtype": "float"}}])
    cfg["dataloader"] = {"batch_size": 8, "num_workers": 0}
    cfg["train"].update(epochs=1, scan_steps=2, fused_state=False)
    with open(os.path.join(REPO, "configs", "base", "vit_tiny",
                           "fixmatch.yaml")) as f:
        cfg["metric"] = yaml.safe_load(f)["metric"]
    return cfg


def test_port_scan_steps_matches_jax_scan(tmp_path, monkeypatch):
    """FixMatch at ``scan_steps: 2`` through both packages'
    ``run_training``, the JAX package's on one of the conftest's CPU
    devices, the port's from the JAX run's initial trees."""
    import jax

    from semi_seg_ecg_tpu.algorithms import common as jax_common
    from semi_seg_ecg_tpu.algorithms import fixmatch as jax_fixmatch
    from semi_seg_ecg_tpu.config import normalize_config as jax_normalize
    from semi_seg_ecg_tpu_torch.algorithms import fixmatch
    from semi_seg_ecg_tpu_torch.config import normalize_config
    from semi_seg_ecg_tpu_torch.utils.weights import jax_trees_to_state_dict
    from tests.test_torch_train_slice import assert_states_agree

    data = make_synthetic_dataset(str(tmp_path / "data"),
                                  num_train_labeled=8,
                                  num_train_unlabeled=32, num_valid=2,
                                  num_test=2, length=SEQ, seed=12)
    init = {}

    def keep_init(config, model, state):
        # host copies: the jitted steps donate the state's buffers
        init["trees"] = jax.tree_util.tree_map(
            np.asarray, (state.model.params, state.model.batch_stats))
        return state

    devices = jax.devices
    monkeypatch.setattr(jax, "devices", lambda *a: devices(*a)[:1])
    # for speed: the init compiled (its trees are carried across whatever
    # they are), TensorBoard's writer (it imports TensorFlow) left out
    init_state = jax_common.init_model_state
    monkeypatch.setattr(jax_common, "init_model_state",
                        lambda model, config, seed: jax.jit(
                            lambda: init_state(model, config, seed))())
    monkeypatch.setattr(jax_common, "TensorBoardWriter", NoWriter)
    jax_common.run_training(
        jax_normalize(jax_scan_config(tmp_path / "jax", data)),
        jax_fixmatch.SPEC, state_hook=keep_init)
    monkeypatch.setattr(jax, "devices", devices)

    def transplant(trainer):
        params, stats = init["trees"]
        trainer.model.load_state_dict(jax_trees_to_state_dict(
            params, stats, trainer.model.state_dict().keys()))

    common.run_training(normalize_config(jax_scan_config(tmp_path / "port",
                                                         data)),
                        fixmatch.SPEC, state_hook=transplant)
    rows = []
    for side in ("jax", "port"):
        with open(tmp_path / side / "scan" / "log.txt") as f:
            rows.append(json.loads(f.readline()))
    theirs, ours = rows
    for key in ("train_loss", "train_loss_x", "train_loss_u_s",
                "train_mask_ratio"):
        assert ours[key] == pytest.approx(theirs[key], rel=1e-5), key
    assert 0 < ours["train_mask_ratio"] < 1  # the mask does work
    payloads = [torch_ckpt.load_checkpoint(str(
        tmp_path / side / "scan" / "best-loss.ckpt")) for side in
        ("jax", "port")]
    keys = payloads[1]["model"].keys()
    want = torch_ckpt.model_state_dict(payloads[0]["model"], keys)
    assert_states_agree(want, {k: torch.as_tensor(v) for k, v in
                               payloads[1]["model"].items()})
    assert payloads[0]["step"] == payloads[1]["step"] == 4


class NoWriter:
    def __init__(self, *args, **kwargs):
        pass

    def __getattr__(self, name):
        return lambda *args, **kwargs: None


def test_units_stack_k_batches_and_leave_the_tail():
    batches = [{"x": np.full((2, 3), i, np.float32),
                "y": np.full((2,), i, np.int64)} for i in range(5)]
    units = list(captured_step.stacked_units(iter(batches), 2))
    assert [u["x"].shape for u in units] == [(2, 2, 3), (2, 2, 3),
                                             (1, 2, 3)]
    steps = [captured_step.unit_slice(u, j) for u in units
             for j in range(captured_step.unit_steps(u))]
    for b, s in zip(batches, steps):
        for key in b:
            np.testing.assert_array_equal(s[key], b[key])
            assert s[key].dtype == b[key].dtype
    assert len(steps) == 5


def test_units_of_one_batch_are_views():
    """K = 1 (and the tail) goes through the same loop as K > 1: each batch
    a unit of leading axis 1 that shares the batch's memory."""
    batches = [{"x": np.full((2, 3), i, np.float32)} for i in range(3)]
    for k in (1, 2):
        tail = list(captured_step.stacked_units(iter(batches), k))[-1]
        assert tail["x"].shape == (1, 2, 3)
        assert np.shares_memory(tail["x"], batches[-1]["x"])
    units = list(captured_step.stacked_units(iter(batches), 1))
    assert len(units) == 3 and all(
        np.shares_memory(u["x"], b["x"]) for u, b in zip(units, batches))


@pytest.mark.parametrize("case", ["process_group", "accum_iter",
                                  "nan_checks"])
def test_scan_steps_refusals(case, monkeypatch):
    """K > 1 under a process group, ``accum_iter`` > 1 or
    ``debug.nan_checks`` raises with the reason, on either device (the
    check runs in the Trainer, before any step); K = 1 takes them all."""
    cfg = lockstep_config("xla", "base")
    cfg["train"]["scan_steps"] = 2
    if case == "process_group":
        monkeypatch.setattr(captured_step.pdist, "get_world_size",
                            lambda: 2)
        match = "process group of 2 ranks: a gloo collective"
    elif case == "accum_iter":
        cfg["train"]["accum_iter"] = 2
        match = "accum_iter 2: all but the last micro-step"
    else:
        cfg["debug"] = {"nan_checks": True}
        match = "nan_checks: autograd's anomaly mode"
    with pytest.raises(ValueError, match="train.scan_steps: 2 is refused"
                       ".*" + match):
        common.Trainer(copy.deepcopy(cfg), get_algorithm("base").SPEC,
                       torch.device("cpu"), 4)
    monkeypatch.undo()
    cfg["train"]["scan_steps"] = 1
    assert captured_step.check_scan_steps(cfg) == 1
    # a CUDA-only piece refuses the CPU
    trainer = common.Trainer(copy.deepcopy(dict(cfg, debug={})),
                             get_algorithm("base").SPEC,
                             torch.device("cpu"), 4)
    with pytest.raises(ValueError, match="needs a CUDA device"):
        captured_step.CapturedStep(trainer)


@pytest.mark.parametrize("optimizer", ["adamw", "sgd"])
def test_capturable_optimizer_host_side(optimizer):
    """``make_capturable_``: each group's lr a tensor that ``write_lr``
    fills with the schedule's lr of the update count times the group's
    scale (layer decay gives two groups); the state_dict keeps the eager
    layout, so either run resumes the other; a captured optimizer refuses
    a new state."""
    cfg = lockstep_config("xla", "base")
    cfg["train"].update(layer_decay=0.75, warmup_epochs=1)
    if optimizer == "sgd":
        cfg["train"].update(optimizer="sgd",
                            optimizer_kwargs={"momentum": 0.9})
    model = common.init_model(cfg, torch.device("cpu"))
    eager = build_optimizer(cfg, model, 4)
    x = torch.randn(2, 1, SEQ)
    for _ in range(2):  # the lazy state
        eager.zero_grad()
        model(x)["seg_logits"].square().mean().backward()
        eager.step()
    want = eager.state_dict()
    opt = build_optimizer(cfg, model, 4)
    opt.load_state_dict(copy.deepcopy(want))
    opt.make_capturable_()
    groups = opt.optimizer.param_groups
    assert len(groups) > 1 and len({g["lr_scale"] for g in groups}) > 1
    assert all(torch.is_tensor(g["lr"]) and g["lr"].dtype == torch.float32
               for g in groups)
    assert all(g["capturable"] if optimizer == "adamw" else g["fused"]
               for g in groups)
    for count in range(6):
        opt.count = count
        opt.write_lr()
        lr = opt.schedule(count)
        for g in groups:
            assert g["lr"].item() == np.float32(lr * g["lr_scale"])
    # the groups hold the lr of the last update, as an eager step leaves
    opt.count = want["count"] - 1
    opt.write_lr()
    opt.count = want["count"]
    assert_payloads_equal(torch_ckpt._to_numpy(opt.state_dict()),
                          torch_ckpt._to_numpy(want))
    if optimizer == "adamw":
        assert all(s["step"].device.type == "cpu"
                   for s in opt.state_dict()["state"].values())
    with pytest.raises(RuntimeError, match="graph holds the tensors"):
        opt.load_state_dict(want)


def test_dot_kernel_names():
    """A graph's DOT description as ``cudaGraphDebugDotPrint`` writes it
    (torch 2.11, CUDA 12.8: a node's statement spans lines) read one name
    a kernel node, other nodes left out."""
    def node(i, kind, rest):
        return (f'"graph_1_node_{i}"[style="bold" shape="record" '
                f'label="{{{kind}\n| {{ID | {i} (topoId: {5 - i}){rest}}}'
                '\n| {{node handle | func handle} | {0x1 | 0x2}}\n'
                '| {cooperative | 0}\n}"];\n')
    dot = ('digraph dot {\nsubgraph cluster_1 {\nlabel="graph_1" '
           'graph[style="dashed"];\n'
           + node(0, "KERNEL", " | _ZN55_GLOBAL__N__991f94f4_22_flash_"
                  "attention_fwd_cu_2c13897913flash_fwd_mmaILi64EEEv7Tensor4"
                  "S1_S1_S1_Pfiiiifb\\<\\<\\<\\{2,6\\},128,46080"
                  "\\>\\>\\>")
           + node(1, "MEMSET", "")
           + node(2, "KERNEL", " | _ZN44_GLOBAL__N__1292ee5e_11_gather1d_cu_"
                  "gather1d15gather1d_kernelIjLb1ELb0ELb1EEEvNS_4LerpENS_"
                  "5IndexIT_EE\\<\\<\\<\\{1,2\\},256,0\\>\\>"
                  "\\>")
           + '"graph_1_node_0" -> "graph_1_node_2" [style="solid"];\n}\n}\n')
    names = captured_step.dot_kernel_names(dot)
    assert names == [
        "_ZN55_GLOBAL__N__991f94f4_22_flash_attention_fwd_cu_2c13897913"
        "flash_fwd_mmaILi64EEEv7Tensor4S1_S1_S1_Pfiiiifb",
        "_ZN44_GLOBAL__N__1292ee5e_11_gather1d_cu_gather1d15gather1d_kernel"
        "IjLb1ELb0ELb1EEEvNS_4LerpENS_5IndexIT_EE"]
    assert captured_step.count_kernels(names, {
        "fwd": "flash_fwd_", "bwd": "flash_bwd_dq", "gather":
        "gather1d_kernel"}) == {"fwd": 1, "bwd": 0, "gather": 1}
