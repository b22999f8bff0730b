"""Activation checkpointing (``remat: true``) in the port, on the CPU.

Remat must not change what a step computes. For each backbone (the ViT of
depth 3, width 64 with flash attention, dropout 0.1 and drop-path 0.2;
the ResNet18 of width 8, whose blocks hold BatchNorms), with the FCN
head's dropout at 0.3 and the trainer's explicit generators, two FixMatch
steps with remat on equal two with remat off bit for bit: the losses, the
gradients of the last step and the whole state, BatchNorm running
statistics included. Without the recompute's care both would differ:
``torch.utils.checkpoint`` restores only the global RNGs, so the block's
dropout generator would draw new masks, and the recomputed forward would
update the running statistics a second time (``models/remat.py``).

Against the JAX package (whose ``remat`` wraps each block in ``nn.remat``),
remat runs in the ``frozen_stages`` locksteps of both backbones in
``tests/test_torch_optim_options.py``.

Two gloo ranks of ``tests/torch_dist_worker.py`` with remat on, each on
its rows of the global batches, take the steps of one process with remat
off on the global batches: dropout masks drawn for the global batch and
BatchNorm statistics over it, in the recompute too (the ranks' collectives
stay matched, or the group would hang); losses within rtol 1e-5 and states
within ``assert_states_agree``.
"""

import copy

import numpy as np
import pytest
import torch

from semi_seg_ecg_tpu_torch.algorithms import fixmatch
from semi_seg_ecg_tpu_torch.algorithms.common import Trainer, init_model
from tests.test_torch_parallel_train import global_batches
from tests.test_torch_train_slice import (
    assert_states_agree,
    lockstep_config,
    resnet_lockstep_config,
)
from tests.torch_dist_worker import run_ranks
from tests.torch_dist_worker import one_thread  # noqa: F401 (autouse)

STEPS = 2


def remat_config(family, remat):
    if family == "vit_tiny":
        cfg = lockstep_config("flash", "fixmatch")
        cfg["backbone"]["vit_tiny"].update(depth=3, out_indices=[2],
                                           drop_out_rate=0.1,
                                           drop_path_rate=0.2)
        cfg["train"]["conf_thresh"] = 0.3
    else:
        cfg = resnet_lockstep_config("fixmatch")
        cfg["train"]["conf_thresh"] = 0.95
    cfg["decode_head"]["FCNHead"]["dropout_ratio"] = 0.3
    cfg["backbone"][family]["remat"] = remat
    cfg["train"]["ema_decay"] = 0.99
    return cfg


def run_steps(cfg, batches):
    """The steps from seed 5's model: per-step metrics, the last step's
    gradients and the final state."""
    trainer = Trainer(copy.deepcopy(cfg), fixmatch.SPEC, torch.device("cpu"),
                      STEPS, model=init_model(cfg, torch.device("cpu"),
                                              seed=5))
    metrics = [trainer.train_step({k: torch.from_numpy(v) for k, v in
                                   batch.items()}) for batch in batches]
    grads = {k: p.grad.clone() for k, p in trainer.model.named_parameters()}
    return metrics, grads, trainer.model.state_dict()


@pytest.mark.parametrize("family", ["vit_tiny", "resnet18"])
def test_remat_steps_equal_plain_steps(family):
    batches = global_batches(3)[:STEPS]
    off = run_steps(remat_config(family, False), batches)
    on = run_steps(remat_config(family, True), batches)
    for a, b in zip(on[0], off[0]):
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), k
    assert any(0 < float(m["mask_ratio"]) < 1 for m in off[0])
    for k, g in off[1].items():
        assert torch.equal(on[1][k], g), k
    stats = [k for k in off[2] if "running" in k]
    assert stats
    for k, v in off[2].items():
        assert torch.equal(on[2][k], v), k


def test_remat_keeps_eval_mode_and_its_outputs():
    """An eval forward under ``remat`` is a plain forward (nothing is
    checkpointed where no graph is recorded), equal to remat off."""
    x = torch.from_numpy(global_batches(4)[0]["ecg"])
    outs = []
    for remat in (False, True):
        cfg = remat_config("vit_tiny", remat)
        model = init_model(cfg, torch.device("cpu"), seed=1).eval()
        outs.append(model(x)["seg_logits"])
    assert torch.equal(outs[0], outs[1])


@pytest.mark.slow
def test_two_ranks_with_remat_match_one_process(tmp_path):
    runs, want = [], []
    for family in ("vit_tiny", "resnet18"):
        batches = global_batches(6)[:STEPS]
        model = init_model(remat_config(family, False), torch.device("cpu"),
                           seed=5)
        runs.append({"config": remat_config(family, True),
                     "batches": batches,
                     "states": {"model": {k: v.numpy() for k, v in
                                          model.state_dict().items()}}})
        want.append(run_steps(remat_config(family, False), batches))
    ranks = run_ranks([("steps", {"runs": runs})], str(tmp_path),
                      timeout=240)
    for r, result in enumerate(ranks):
        for run, (metrics, _, state) in zip(result[0], want):
            for a, b in zip(run["metrics"], metrics):
                for k in ("loss_x", "loss_u_s", "loss"):
                    assert a[k] == pytest.approx(float(b[k]), rel=1e-5), \
                        (r, k)
            assert_states_agree(state, {k: torch.from_numpy(np.asarray(v))
                                        for k, v in
                                        run["states"]["model"].items()})



@pytest.mark.parametrize("parts", [1, 2])
def test_rank_draws_are_one_process_rows(monkeypatch, parts):
    """Under ``concatenated_rows(parts)``, rank r of 2 with b rows of each
    part draws exactly one process's mask rows of its rows of each part
    (one process: the parts one after the other, each holding the ranks'
    rows in rank order)."""
    from semi_seg_ecg_tpu_torch.models.dropout import Dropout
    from semi_seg_ecg_tpu_torch.parallel import dist as pdist

    world, b = 2, 3
    x = torch.ones(parts * world * b, 5)
    layer = Dropout(0.5).train()
    layer.generator = torch.Generator().manual_seed(1)
    want = layer(x).reshape(parts, world, b, 5)
    monkeypatch.setattr(pdist, "get_world_size", lambda: world)
    for rank in range(world):
        monkeypatch.setattr(pdist, "get_rank", lambda: rank)
        layer.generator.manual_seed(1)
        with pdist.concatenated_rows(parts):
            got = layer(x[:parts * b])
        assert torch.equal(got.reshape(parts, b, 5), want[:, rank])
