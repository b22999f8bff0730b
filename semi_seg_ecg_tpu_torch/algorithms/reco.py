"""ReCo, ``algorithm: reco`` (counterpart of
``semi_seg_ecg_tpu/algorithms/reco.py``): Mean Teacher with the regional
contrastive loss.

The teacher (``Trainer.teacher``, a copy of the student at init) predicts
in eval mode (running statistics, no dropout), without a graph, on the weak
view: fp32 softmax probabilities and the confidence mask ``conf >=
conf_thresh``. The student makes one forward of ``cat(labeled, strong)``
with ``return_latent`` (the :class:`~..models.LatentProjection` of the last
feature). The loss is ``(loss_x + masked softCE(strong, teacher) + contr) /
3``, auxiliary heads weighted into ``loss_x``, ``contr`` the ReCo loss
(``ops/reco_loss.py``) of the strong view's latents against the teacher's
probabilities, its samples drawn from ``Trainer.loss_gen``. After the
optimizer update the teacher becomes the EMA of the whole student,
projection included (``train.ema_decay``, 0.99 by default).

The JAX package computes the ReCo loss over the global batch (its regions,
prototypes and samples span every shard of the data mesh), so under a
process group the loss's inputs are gathered from every rank
(``parallel.dist.gather_batch``, differentiable) and every rank computes
the same global loss. The gather's backward sums the ranks' gradients of
it, and the optimizer's mean over the ranks then leaves the gradient of
the loss once. Under a split time axis (``parallel.seq_parallel``) the
rows gathered over data are then gathered over the seq ranks' time blocks
(``seq_shard.gather_whole_time``), so every rank of the data×seq group
draws one process's pixels from the same ``(B·T)`` arrays. That gather is
``replicated``: every seq rank computes the same loss, so its backward
keeps the rank's block of the gradient without summing the ranks' (a
plain time gather would count the term's gradient s times, since the
optimizer sums the seq ranks' gradients). The confidence ratio and the
other two losses are global means over the time axis, as in FixMatch.

Config keys and defaults as the JAX package reads them (reference
reco.py:253-262): ``conf_thresh``, ``easy_conf_thresh`` or the reference's
typo key ``eash_conf_thresh`` (0.65), ``hard_conf_thresh`` (0.80),
``contr_temp`` (0.25), ``contr_num_queries`` (256),
``contr_num_negatives`` (512).
"""

from __future__ import annotations

import torch

from ..ops import reco_loss
from ..ops.losses import cross_entropy, soft_cross_entropy
from ..parallel import seq_shard
from ..parallel.dist import gather_batch
from ..utils.train_state import ema_update
from .base import aux_loss_weights
from .common import AlgorithmSpec, forward_parts, run_test, run_training


def gather_for_loss(t: torch.Tensor) -> torch.Tensor:
    """``t``'s rows of every data rank, and under a split time axis every
    seq rank's time block: the global batch, for a loss that every rank of
    the data×seq group computes alike (differentiable)."""
    return seq_shard.gather_whole_time(gather_batch(t), replicated=True)


def make_train_step(trainer):
    model, teacher = trainer.model, trainer.teacher
    optimizer, amp, gen = trainer.optimizer, trainer.amp, trainer.loss_gen
    train_cfg = trainer.config["train"]
    ema_decay = train_cfg.get("ema_decay", 0.99)
    conf_thresh = train_cfg["conf_thresh"]
    easy_thresh = train_cfg.get("easy_conf_thresh",
                                train_cfg.get("eash_conf_thresh", 0.65))
    hard_thresh = train_cfg.get("hard_conf_thresh", 0.80)
    temp = train_cfg.get("contr_temp", 0.25)
    num_queries = train_cfg.get("contr_num_queries", 256)
    num_negatives = train_cfg.get("contr_num_negatives", 512)

    def train_step(batch):
        ecg_x, mask_x = batch["ecg"], batch["target"]
        ecg_u_w, ecg_u_s = batch["ecg_u_w"], batch["ecg_u_s"]
        num_lb = ecg_x.shape[0]
        with amp():
            teacher.eval()
            with torch.no_grad():
                pred_u_w = teacher(ecg_u_w)["seg_logits"]
                prob_u_w = torch.softmax(pred_u_w.float(), dim=1)
                conf_mask = (prob_u_w.max(dim=1).values
                             >= conf_thresh).float()

            model.train()
            out = forward_parts(model, [ecg_x, ecg_u_s],
                                return_latent=True)
            pred_x = out["seg_logits"][:num_lb]
            pred_u_s = out["seg_logits"][num_lb:]
            latent_u_s = out["latent"][num_lb:]
            loss_x = cross_entropy(pred_x, mask_x)
            if "aux_seg_logits" in out:
                for w, aux in zip(
                        aux_loss_weights(train_cfg,
                                         len(out["aux_seg_logits"])),
                        out["aux_seg_logits"]):
                    loss_x = loss_x + w * cross_entropy(aux[:num_lb], mask_x)
            loss_u_s = soft_cross_entropy(pred_u_s, prob_u_w, mask=conf_mask)
            draws = reco_loss.reco_draws(gen, prob_u_w.shape[1], num_queries,
                                         num_negatives, prob_u_w.device)
            contr = reco_loss.compute_reco_loss(
                draws, gather_for_loss(latent_u_s),
                gather_for_loss(prob_u_w),
                gather_for_loss(torch.softmax(pred_u_s.detach().float(),
                                              dim=1)),
                easy_threshold=easy_thresh, hard_threshold=hard_thresh,
                temp=temp)
            loss = (loss_x + loss_u_s + contr) / 3.0
        optimizer.zero_grad()
        loss.backward()
        # the teacher follows real updates only (a window's last
        # micro-step under train.accum_iter)
        if optimizer.step():
            ema_update(model, teacher, ema_decay)
        loss = loss.detach()
        return {"loss_total": loss, "loss_x": loss_x.detach(),
                "loss_u_s": loss_u_s.detach(), "contr_loss": contr.detach(),
                "mask_ratio": seq_shard.global_mean(conf_mask), "loss": loss}

    return train_step


SPEC = AlgorithmSpec(name="reco", make_train_step=make_train_step,
                     uses_unlabeled=True, uses_ema=True)


def train(config):
    run_training(config, SPEC)


def test(config, nan_checks=False):
    return run_test(config, nan_checks)
