"""Mean Teacher, ``algorithm: mean_teacher`` (counterpart of
``semi_seg_ecg_tpu/algorithms/mean_teacher.py``).

The teacher (``Trainer.teacher``, a copy of the student at init) predicts
soft pseudo-labels, softmax probabilities, on the weak view without a
graph; the student trains on ``cat(labeled, strong)`` in one forward; the
loss is ``(CE(pred_x) + softCE(pred_u_s, prob_u_w)) / 2``, auxiliary heads
weighted into ``loss_x``; after the optimizer update the teacher's
parameters and BN running statistics become their EMA with the student's
(``utils/train_state.ema_update``, ``train.ema_decay``: 0.999 in code, the
shipped configs say 0.99).

Teacher mode, as in the JAX package: by default the teacher predicts in
train mode, with the batch's BN statistics, whose update of the teacher's
running statistics is discarded (``models/norm.batch_statistics_only``),
and live dropout drawn from its own generator, independent of the
student's draws (the reference never calls ``model_teacher.eval()``).
``train.mt_teacher_eval: true`` selects the eval-mode teacher: running
statistics, no dropout.
"""

from __future__ import annotations

import contextlib

import torch

from ..models.norm import batch_statistics_only
from ..ops.losses import cross_entropy, soft_cross_entropy
from ..utils.train_state import ema_update
from .base import aux_loss_weights
from .common import AlgorithmSpec, forward_parts, run_test, run_training


def make_train_step(trainer):
    model, teacher = trainer.model, trainer.teacher
    optimizer, amp = trainer.optimizer, trainer.amp
    train_cfg = trainer.config["train"]
    ema_decay = train_cfg.get("ema_decay", 0.999)
    teacher_eval = bool(train_cfg.get("mt_teacher_eval", False))

    def train_step(batch):
        ecg_x, mask_x = batch["ecg"], batch["target"]
        ecg_u_w, ecg_u_s = batch["ecg_u_w"], batch["ecg_u_s"]
        num_lb = ecg_x.shape[0]
        with amp():
            teacher.train(not teacher_eval)
            with torch.no_grad(), (contextlib.nullcontext() if teacher_eval
                                   else batch_statistics_only(teacher)):
                logits_u_w = teacher(ecg_u_w)["seg_logits"]
                prob_u_w = torch.softmax(logits_u_w.float(), dim=1)

            model.train()
            out = forward_parts(model, [ecg_x, ecg_u_s])
            pred_x = out["seg_logits"][:num_lb]
            pred_u_s = out["seg_logits"][num_lb:]
            loss_x = cross_entropy(pred_x, mask_x)
            if "aux_seg_logits" in out:
                for w, aux in zip(
                        aux_loss_weights(train_cfg,
                                         len(out["aux_seg_logits"])),
                        out["aux_seg_logits"]):
                    loss_x = loss_x + w * cross_entropy(aux[:num_lb], mask_x)
            loss_u_s = soft_cross_entropy(pred_u_s, prob_u_w)
            loss = (loss_x + loss_u_s) / 2.0
        optimizer.zero_grad()
        loss.backward()
        # the teacher follows real updates only (a window's last
        # micro-step under train.accum_iter)
        if optimizer.step():
            ema_update(model, teacher, ema_decay)
        loss = loss.detach()
        return {"loss_total": loss, "loss_x": loss_x.detach(),
                "loss_u_s": loss_u_s.detach(), "loss": loss}

    return train_step


SPEC = AlgorithmSpec(name="mean_teacher", make_train_step=make_train_step,
                     uses_unlabeled=True, uses_ema=True)


def train(config):
    run_training(config, SPEC)


def test(config, nan_checks=False):
    return run_test(config, nan_checks)
