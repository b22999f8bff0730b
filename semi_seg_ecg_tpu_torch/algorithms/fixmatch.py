"""FixMatch, ``algorithm: fixmatch`` (counterpart of
``semi_seg_ecg_tpu/algorithms/fixmatch.py``): hard pseudo-labels and their
confidence from an eval-mode, gradient-free forward on the weak view; the
student trains on ``cat(labeled, strong)`` in one forward; the
unsupervised CE is masked by ``confidence >= conf_thresh``; the loss is
``(loss_x + loss_u_s) / 2`` and ``mask_ratio`` is logged.
"""

from __future__ import annotations

import torch

from ..ops.losses import cross_entropy
from .base import aux_loss_weights
from .common import AlgorithmSpec, run_test, run_training


def make_train_step(model, optimizer, config, amp):
    train_cfg = config["train"]
    conf_thresh = train_cfg["conf_thresh"]

    def train_step(batch):
        ecg_x, mask_x = batch["ecg"], batch["target"]
        ecg_u_w, ecg_u_s = batch["ecg_u_w"], batch["ecg_u_s"]
        num_lb = ecg_x.shape[0]
        with amp():
            # pseudo-labels: running BN statistics, no dropout, no graph
            model.eval()
            with torch.no_grad():
                pred_u_w = model(ecg_u_w)["seg_logits"]
                prob_u_w = torch.softmax(pred_u_w.float(), dim=1)
                conf_u_w = prob_u_w.max(dim=1).values
                mask_u_w = torch.argmax(prob_u_w, dim=1)
                conf_mask = (conf_u_w >= conf_thresh).float()

            model.train()
            out = model(torch.cat([ecg_x, ecg_u_s], dim=0))
            pred_x = out["seg_logits"][:num_lb]
            pred_u_s = out["seg_logits"][num_lb:]
            loss_x = cross_entropy(pred_x, mask_x)
            if "aux_seg_logits" in out:
                for w, aux in zip(
                        aux_loss_weights(train_cfg,
                                         len(out["aux_seg_logits"])),
                        out["aux_seg_logits"]):
                    loss_x = loss_x + w * cross_entropy(aux[:num_lb], mask_x)
            loss_u_s = cross_entropy(pred_u_s, mask_u_w, mask=conf_mask)
            loss = (loss_x + loss_u_s) / 2.0
        optimizer.zero_grad()
        loss.backward()
        optimizer.step()
        loss = loss.detach()
        return {"loss_total": loss, "loss_x": loss_x.detach(),
                "loss_u_s": loss_u_s.detach(),
                "mask_ratio": conf_mask.mean(),
                # the NaN abort keys on 'loss'
                "loss": loss}

    return train_step


SPEC = AlgorithmSpec(name="fixmatch", make_train_step=make_train_step,
                     uses_unlabeled=True)


def train(config):
    run_training(config, SPEC)


def test(config):
    return run_test(config)
