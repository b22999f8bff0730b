"""Cross Pseudo Supervision, ``algorithm: cps`` (counterpart of
``semi_seg_ecg_tpu/algorithms/cps.py``).

Two independently initialised networks, ``Trainer.model`` (model 1) and
``Trainer.peer`` (model 2, from ``seed + 10_000``), each with its own AdamW
(``Trainer.peer_optimizer``). Both predict hard pseudo-labels on the weak
view in eval mode, without a graph, before either updates; model 1 then
learns from model 2's labels and model 2 from model 1's (cps.py:108-112):
per network, ``loss = (CE(labeled) + CE(weak, other's labels)) / 2`` over
one forward of ``cat(labeled, weak)`` and its own backward; then each
network's update (the JAX package's one step: model 1's update reaches
nothing of model 2's forward, so updating after both backwards gives the
same numbers, and ``debug.nan_checks`` checks both gradients before
either update). The peer's dropout comes from ``seed + 1``. The logged
losses are the two networks' means. Evaluation, checkpoint selection and the test pass use
model 1; the peer and its optimizer ride along in the checkpoint.
"""

from __future__ import annotations

import torch

from ..ops.losses import cross_entropy
from .base import aux_loss_weights
from .common import AlgorithmSpec, forward_parts, run_test, run_training


def make_train_step(trainer):
    models = (trainer.model, trainer.peer)
    optimizers = (trainer.optimizer, trainer.peer_optimizer)
    amp = trainer.amp
    train_cfg = trainer.config["train"]

    def one_model_step(model, optimizer, ecg_x, mask_x, ecg_u_w,
                       mask_u_other):
        num_lb = ecg_x.shape[0]
        with amp():
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
            loss_u = cross_entropy(pred_u, mask_u_other)
            loss = (loss_x + loss_u) / 2.0
        optimizer.zero_grad()
        loss.backward()
        return loss.detach(), loss_x.detach(), loss_u.detach()

    def train_step(batch):
        ecg_x, mask_x, ecg_u_w = batch["ecg"], batch["target"], \
            batch["ecg_u_w"]
        # cross pseudo-labels, inference mode (cps.py:96-102)
        with amp(), torch.no_grad():
            masks = []
            for model in models:
                model.eval()
                masks.append(torch.argmax(model(ecg_u_w)["seg_logits"],
                                          dim=1))
        # model 1 learns from model 2's labels and the other way round
        l1, lx1, lu1 = one_model_step(models[0], optimizers[0], ecg_x,
                                      mask_x, ecg_u_w, masks[1])
        l2, lx2, lu2 = one_model_step(models[1], optimizers[1], ecg_x,
                                      mask_x, ecg_u_w, masks[0])
        for optimizer in optimizers:
            optimizer.step()
        loss = (l1 + l2) / 2
        return {"loss_total": loss, "loss_x": (lx1 + lx2) / 2,
                "loss_u_s": (lu1 + lu2) / 2, "loss": loss}

    return train_step


SPEC = AlgorithmSpec(name="cps", make_train_step=make_train_step,
                     uses_unlabeled=True, uses_peer=True)


def train(config):
    run_training(config, SPEC)


def test(config, nan_checks=False):
    return run_test(config, nan_checks)
