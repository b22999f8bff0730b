"""ST++, ``algorithm: stpp`` (counterpart of
``semi_seg_ecg_tpu/algorithms/stpp.py``): three stages of self-training
with a reliability ranking of the unlabeled set.

1. ``train_sup``: supervised (the ``base`` step) under ``{exp}/stage1``,
   with snapshots ``checkpoint-{e}.ckpt`` after the epochs of
   :func:`snapshot_epoch_list` (⅓, ⅔, final);
2. ``prepare_semisup``: :func:`select_reliable` ranks every unlabeled
   sample by the mean per-sample mIoU of the earlier snapshots' argmax
   against the final one's and keeps the top half. The ranking writes each
   value at the sample's true dataset row (``loader.step_indices()``), the
   JAX package's fix of the reference's index shadowing (stpp.py:51 vs
   :72);
3. ``train_semisup``: stage 2 on the reliable half under ``{exp}/stage2``,
   teacher = stage 1's best model; stage 3 on every unlabeled sample in the
   experiment root, teacher = stage 2's best model.

In stages 2 and 3 the teacher (``Trainer.teacher``, loaded in place by the
stage hook) is frozen and predicts in eval mode; the student learns from
its hard labels on the *weak* view: ``loss = (loss_x + CE(weak, teacher
labels)) / 2``, auxiliary heads weighted into ``loss_x``, no EMA. The
spec keeps the teacher (``uses_ema``), so the checkpoints of stages 2 and 3
hold it as ``model_ema``, as the JAX package's do. Under a process group
each rank ranks its shards of the unlabeled split and the ranks exchange
their rows (``parallel.dist.all_gather_rows``, the JAX package's
multi-host exchange, over the data group: the seq and model ranks of a
data rank hold the same rows), so every rank sorts the same reliabilities
and keeps the same reliable ids. Under ``parallel.seq_parallel`` each seq
rank runs the snapshots on its time block, as the JAX package shards the
ranking's batches over seq, and the per-sample counts are summed over the
seq ranks before the mIoU. ``resume`` is refused (:func:`train` says why).
"""

from __future__ import annotations

import os
from typing import Any, Dict, List

import numpy as np
import torch

from ..config import experiment_dir, resolve_device, test_cfg
from ..data.dataset import build_seg_dataset
from ..models import build_model_from_config
from ..ops.losses import cross_entropy
from ..ops.metrics import per_sample_miou, segmentation_stats
from ..parallel import seq_shard
from ..parallel.dist import all_gather_rows
from ..parallel.sharding_rules import load_full_state_dict
from ..utils import checkpoint as ckpt
from ..utils.logging import log
from .base import SPEC as BASE_SPEC, aux_loss_weights
from .common import (
    AlgorithmSpec,
    amp_context,
    eval_loader,
    forward_parts,
    full_fp32,
    load_eval_weights,
    prefetched,
    run_test,
    run_training,
    shard_for_mesh,
)


def select_reliable(models: List[torch.nn.Module], loader, num_classes: int,
                    device: torch.device, amp):
    """Reliability ranking (reference stpp.py:45-88): per batch, each
    snapshot's eval-mode argmax, the per-sample mIoU of each earlier one
    against the last, averaged; the ranks' rows exchanged; a stable
    descending sort; the top half. Returns ``(reliable_ids,
    unreliable_ids, reliability)``, the last per sample in dataset
    order."""
    n = len(loader.dataset)
    mat = loader.step_indices()
    reliability = np.zeros(n)
    for model in models:
        model.eval()
    with torch.no_grad(), amp():
        for step, batch in enumerate(prefetched(loader, device)):
            # under the seq axis each seq rank compares its time block, and
            # the counts are summed over the seq ranks before the mIoU (a
            # mean of the blocks' mIoUs would be another number)
            local, length = seq_shard.split_batch({"x": batch["ecg"]})
            with seq_shard.time_sharded(length):
                preds = [torch.argmax(m(local["x"])["seg_logits"], dim=1)
                         for m in models]
                counts = [[seq_shard.sum_counts(s).cpu().numpy() for s in
                           segmentation_stats(pred, preds[-1], num_classes)]
                          for pred in preds[:-1]]
            mious = [per_sample_miou(*c) for c in counts]
            reliability[mat[step].reshape(-1)] = np.mean(mious, axis=0)
    all_gather_rows(mat.reshape(-1), [reliability])
    order = np.argsort(-reliability, kind="stable")
    half = len(order) // 2
    return order[:half].tolist(), order[half:].tolist(), reliability


def snapshot_epoch_list(num_epochs: int) -> List[int]:
    """Stage-1 snapshot epochs ⅓, ⅔, final (reference stpp.py:377-386),
    each at least 1: a snapshot is written after its epoch completes, so
    there is no ``checkpoint-0.ckpt``. Duplicates stand: that snapshot
    counts twice in the mean."""
    return [max(num_epochs // 3, 1), max(num_epochs * 2 // 3, 1),
            max(num_epochs, 1)]


def prepare_semisup(config: Dict[str, Any]) -> List[int]:
    """Load the three stage-1 snapshots and rank the ``train_unlabeled``
    split (its eval-mode items). Returns the reliable ids."""
    device = resolve_device(config)
    ds = build_seg_dataset(config["dataset"], split="train_unlabeled",
                           mode="eval")
    loader = eval_loader(config, ds, mode="eval")
    stage1 = os.path.join(experiment_dir(config), "stage1")
    models = []
    for e in snapshot_epoch_list(config["train"]["epochs"]):
        model = build_model_from_config(config)
        # load_checkpoint flushes the writer before it reads
        load_eval_weights(model, os.path.join(stage1, f"checkpoint-{e}.ckpt"))
        models.append(shard_for_mesh(model.to(device)))
    try:
        with full_fp32():
            reliable, unreliable, _ = select_reliable(
                models, loader, config["metric"]["num_classes"], device,
                amp_context(config, device))
    finally:
        loader.close()
    log(f"ST++ reliability ranking: {len(reliable)} reliable / "
        f"{len(unreliable)} unreliable unlabeled samples")
    return reliable


def make_train_step(trainer):
    """Self-training step: the frozen teacher's hard labels on the weak
    view (reference stpp.py:150-178)."""
    model, teacher = trainer.model, trainer.teacher
    optimizer, amp = trainer.optimizer, trainer.amp
    train_cfg = trainer.config["train"]

    def train_step(batch):
        ecg_x, mask_x, ecg_u_w = batch["ecg"], batch["target"], \
            batch["ecg_u_w"]
        num_lb = ecg_x.shape[0]
        with amp():
            teacher.eval()
            with torch.no_grad():
                mask_u_w = torch.argmax(teacher(ecg_u_w)["seg_logits"],
                                        dim=1)
            model.train()
            out = forward_parts(model, [ecg_x, ecg_u_w])
            pred_x = out["seg_logits"][:num_lb]
            pred_u = out["seg_logits"][num_lb:]
            loss_x = cross_entropy(pred_x, mask_x)
            if "aux_seg_logits" in out:
                for w, aux in zip(
                        aux_loss_weights(train_cfg,
                                         len(out["aux_seg_logits"])),
                        out["aux_seg_logits"]):
                    loss_x = loss_x + w * cross_entropy(aux[:num_lb], mask_x)
            loss_u_s = cross_entropy(pred_u, mask_u_w)
            loss = (loss_x + loss_u_s) / 2.0
        optimizer.zero_grad()
        loss.backward()
        optimizer.step()
        loss = loss.detach()
        return {"loss_total": loss, "loss_x": loss_x.detach(),
                "loss_u_s": loss_u_s.detach(), "loss": loss}

    return train_step


def _load_stage_teacher(stage_id: int):
    """The hook of stage ``stage_id``: stage ``stage_id - 1``'s
    ``best-{target_metric}.ckpt`` into ``Trainer.teacher``, in place."""
    def hook(trainer):
        config = trainer.config
        target_metric = test_cfg(config).get("target_metric", "MeanIoU")
        path = os.path.join(experiment_dir(config), f"stage{stage_id - 1}",
                            f"best-{target_metric}.ckpt")
        payload = ckpt.load_checkpoint(path)  # flushes the writer first
        log(f"Load teacher model from {path}")
        teacher = trainer.teacher
        load_full_state_dict(teacher, ckpt.model_state_dict(
            payload["model"], teacher.state_dict().keys()))

    return hook


SEMISUP_SPEC = AlgorithmSpec(name="stpp", make_train_step=make_train_step,
                             uses_unlabeled=True, uses_ema=True)


def train_sup(config):
    """Stage 1 (reference stpp.py:248-449): supervised, with snapshots."""
    run_training(config, BASE_SPEC, output_subdir="stage1",
                 snapshot_epochs=set(snapshot_epoch_list(
                     config["train"]["epochs"])))


def train_semisup(config, stage_id: int, unlabeled_subset_ids=None):
    """Stages 2 and 3 (reference stpp.py:488-735)."""
    run_training(config, SEMISUP_SPEC,
                 output_subdir="stage2" if stage_id == 2 else None,
                 unlabeled_subset_ids=unlabeled_subset_ids,
                 state_hook=_load_stage_teacher(stage_id))


def train(config):
    if config.get("resume"):
        # the JAX package keeps resume set through its three run_training
        # calls, so every stage reloads the one checkpoint and starts at
        # its epoch + 1, which resumes no stage where it stopped
        raise ValueError(
            "resume is refused under algorithm: stpp: its three stages "
            "share one config, so each stage would reload the same "
            "checkpoint and start at its epoch + 1 rather than where that "
            "stage stopped")
    train_sup(config)
    reliable_ids = prepare_semisup(config)
    train_semisup(config, stage_id=2, unlabeled_subset_ids=reliable_ids)
    train_semisup(config, stage_id=3)


def test(config, nan_checks=False):
    return run_test(config, nan_checks)
