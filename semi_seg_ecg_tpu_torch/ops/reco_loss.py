"""Regional contrastive (ReCo) loss (counterpart of
``semi_seg_ecg_tpu/ops/reco_loss.py``).

Semantics as in the JAX package (after the reference's
``compute_reco_loss`` / ``negative_index_sampler``, reco.py:30-154):
teacher-confident pixels (``conf >= easy_threshold``) form per-class
regions; per class with a region, hard anchors (student probability of the
class below ``hard_threshold``) are sampled with replacement; each anchor's
negatives are drawn from *other* classes with probability
``softmax(cos(proto_i, proto_j) / temp)``, then a pixel of the drawn class
uniformly; InfoNCE over cosines at ``temp``, with the class prototype as
the positive. Gradients flow through the anchors only.

Split in three, as ``ops/preprocess.py`` splits its ops, so that a test can
feed the JAX package's own draws:

- :func:`reco_draws`: the random numbers of one call, from a generator;
- :func:`reco_regions` and :func:`reco_sample`: masks, prototypes and the
  sampled indices;
- :func:`reco_loss_core`: latent, prototypes and indices → loss.

Mirrors of the JAX draws: :func:`masked_sample` is the inverse CDF
(:func:`masked_cdf`, ``searchsorted(right=True)``, clipped to ``[0, P-1]``;
an empty mask samples uniformly), and
``jax.random.categorical(k, logits, shape=(Q, Nn))`` is
``argmax(gumbel + logits)`` with gumbels ``-log(-log(u))``, ``u`` clamped at
``finfo(float32).tiny``. All four classes go through every op at once:
shapes are static and nothing waits on the device (no ``.item()``, no
boolean-mask indexing, no ``nonzero``), so a CUDA graph can capture the
loss. The loss is computed in fp32 whatever the autocast; its products are
full fp32 where TF32 is off, as the training loop's ``full_fp32`` sets it.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

COS_EPS = 1e-8


class RecoDraws(NamedTuple):
    """The random numbers of one loss call: ``pool_u`` (C, Q·Nn) picks the
    negative pixel pools, ``anchor_u`` (C, Q) the anchors, ``gumbel`` (C,
    Q, Nn, C) the negatives' classes."""

    pool_u: torch.Tensor
    anchor_u: torch.Tensor
    gumbel: torch.Tensor


class RecoRegions(NamedTuple):
    """Per-class regions of the flattened ``P = B·T`` pixels: ``valid`` and
    ``hard`` (C, P) masks, ``protos`` (C, D) masked means of the latent
    (zero for an empty class, no gradient), ``class_valid`` and ``active``
    (C,) (a region, and a region with hard anchors), ``valid_seg`` the
    count of classes with a region."""

    valid: torch.Tensor
    hard: torch.Tensor
    protos: torch.Tensor
    class_valid: torch.Tensor
    active: torch.Tensor
    valid_seg: torch.Tensor


def reco_draws(generator: torch.Generator, num_classes: int,
               num_queries: int, num_negatives: int,
               device: torch.device) -> RecoDraws:
    """One call's uniforms and gumbels, on ``device`` from ``generator``."""
    c, q, n = num_classes, num_queries, num_negatives
    pool_u = torch.rand((c, q * n), generator=generator, device=device)
    anchor_u = torch.rand((c, q), generator=generator, device=device)
    u = torch.rand((c, q, n, c), generator=generator, device=device)
    gumbel = -torch.log(-torch.log(u.clamp_(min=torch.finfo(
        torch.float32).tiny)))
    return RecoDraws(pool_u, anchor_u, gumbel)


def _cosine(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cosine over the last axis, each norm clamped at ``COS_EPS`` on its
    own (not ``F.cosine_similarity``'s convention)."""
    na = torch.linalg.vector_norm(a, dim=-1).clamp(min=COS_EPS)
    nb = torch.linalg.vector_norm(b, dim=-1).clamp(min=COS_EPS)
    return (a * b).sum(dim=-1) / (na * nb)


def reco_regions(lat: torch.Tensor, prob_t: torch.Tensor,
                 prob_s: torch.Tensor, easy_threshold: float,
                 hard_threshold: float) -> RecoRegions:
    """Regions from the flattened fp32 ``lat`` (P, D) and the teacher's and
    student's probabilities (P, C)."""
    c = prob_t.shape[1]
    conf = prob_t.max(dim=1).values
    pseudo = torch.argmax(prob_t, dim=1)
    classes = torch.arange(c, device=lat.device)
    valid = (conf >= easy_threshold) & (pseudo == classes[:, None])  # (C, P)
    hard = valid & (prob_s.t() < hard_threshold)
    vf = valid.float()
    count = vf.sum(dim=1)
    protos = (vf @ lat.detach()) / count.clamp(min=1.0)[:, None]
    class_valid = count > 0
    active = class_valid & hard.any(dim=1)
    return RecoRegions(valid, hard, protos, class_valid, active,
                       class_valid.sum())


def masked_cdf(mask: torch.Tensor) -> torch.Tensor:
    """Per row of ``mask`` (R, P), the CDF of the uniform distribution over
    its True set (over all P where the row is empty): the running count
    over the row's count, the count summed exactly in integers and each
    value divided once, so every device rounds it alike, each value within
    an ulp or two of the JAX package's float ``cumsum`` of ``mask /
    count``."""
    p_len = mask.shape[1]
    count = mask.sum(dim=1, keepdim=True)
    running = torch.where(count > 0, torch.cumsum(mask, dim=1),
                          torch.arange(1, p_len + 1, device=mask.device))
    return running / torch.where(count > 0, count, p_len)


def masked_sample(mask: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Per row of ``mask`` (R, P), indices uniform over its True set at the
    uniforms ``u`` (R, S): the first index whose CDF value exceeds ``u``
    (``searchsorted(right=True)``), clipped to ``[0, P-1]``."""
    return torch.searchsorted(masked_cdf(mask), u.contiguous(),
                              right=True).clamp_(0, mask.shape[1] - 1)


def negative_class_scores(draws: RecoDraws, regions: RecoRegions,
                          temp: float) -> torch.Tensor:
    """(C, Q, Nn, C) gumbels plus the prototype logits, whose argmax over
    the last axis is each negative's class:
    ``jax.random.categorical(k, neg_logits[ci], shape=(Q, Nn))``, with the
    logits ``cos(proto_ci, proto_j) / temp``, ``-inf`` at ``j = ci`` and at
    classes without a region."""
    c = draws.gumbel.shape[-1]
    protos = regions.protos
    neg_logits = _cosine(protos[:, None, :], protos[None, :, :]) / temp
    eye = torch.eye(c, dtype=torch.bool, device=protos.device)
    neg_logits = neg_logits.masked_fill(
        ~regions.class_valid[None, :] | eye, float("-inf"))
    return draws.gumbel + neg_logits[:, None, None, :]


def reco_sample(draws: RecoDraws, regions: RecoRegions,
                temp: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(anchor_idx (C, Q), neg_idx (C, Q, Nn))``, pixel indices into P:
    the anchors from the hard masks, each negative from its class's pool
    (a (C, Q·Nn) sample of each class's region) at its own slot,
    ``pools[samp_class, slot]``."""
    _, q, n, _ = draws.gumbel.shape
    pools = masked_sample(regions.valid, draws.pool_u)  # (C, Q·Nn)
    anchor_idx = masked_sample(regions.hard, draws.anchor_u)
    samp_class = torch.argmax(negative_class_scores(draws, regions, temp),
                              dim=-1)  # (C, Q, Nn)
    slot = torch.arange(q * n, device=pools.device).view(q, n)
    neg_idx = pools.view(-1)[samp_class * (q * n) + slot]
    return anchor_idx, neg_idx


def reco_loss_core(lat: torch.Tensor, protos: torch.Tensor,
                   anchor_idx: torch.Tensor, neg_idx: torch.Tensor,
                   active: torch.Tensor, valid_seg: torch.Tensor,
                   temp: float) -> torch.Tensor:
    """The loss from the flattened fp32 latent ``lat`` (P, D), with a
    gradient through the anchors only: per class the mean over its Q
    anchors of CE with label 0 over ``cos(anchor, [proto, negatives]) /
    temp``, counted where the class is ``active``, summed and divided by
    ``valid_seg``; 0 unless ``valid_seg > 1``."""
    c, q, n = neg_idx.shape
    d = lat.shape[1]
    anchors = lat[anchor_idx]                                  # (C, Q, D)
    na = torch.linalg.vector_norm(anchors, dim=-1).clamp(min=COS_EPS)
    # the positive, the class prototype; the negatives' norms are their
    # pixels' (each pixel's computed once), their products one batched
    # matrix-vector product over the gathered rows
    pos = (anchors * protos[:, None, :]).sum(dim=-1) / (
        na * torch.linalg.vector_norm(protos, dim=-1).clamp(
            min=COS_EPS)[:, None])
    pixel_norm = torch.linalg.vector_norm(lat.detach(), dim=-1).clamp(
        min=COS_EPS)
    neg_feat = lat.detach()[neg_idx.reshape(-1)].view(c, q, n, d)
    neg = torch.matmul(neg_feat, anchors.unsqueeze(-1)).squeeze(-1) / (
        na[..., None] * pixel_norm[neg_idx])
    logits = torch.cat([pos[..., None], neg], dim=-1) / temp  # (C, Q, 1+Nn)
    ce = (torch.logsumexp(logits, dim=-1) - logits[..., 0]).mean(dim=1)
    total = torch.where(active, ce, 0.0).sum()
    loss = total / valid_seg.clamp(min=1).float()
    return torch.where(valid_seg > 1, loss, 0.0)


def compute_reco_loss(draws: RecoDraws, latent: torch.Tensor,
                      prob_teacher: torch.Tensor,
                      prob_student: torch.Tensor, easy_threshold: float,
                      hard_threshold: float, temp: float) -> torch.Tensor:
    """The ReCo loss of student latents ``latent`` (B, D, T) (strong view)
    against the teacher's probabilities ``prob_teacher`` (B, C, T), with the
    student's ``prob_student`` (B, C, T) picking the hard anchors; Q and Nn
    are the draws'."""
    b, d, t = latent.shape
    c = prob_teacher.shape[1]
    with torch.autocast(latent.device.type, enabled=False):
        lat = latent.float().transpose(1, 2).reshape(b * t, d)
        prob_t = prob_teacher.float().transpose(1, 2).reshape(b * t, c)
        prob_s = prob_student.float().transpose(1, 2).reshape(b * t, c)
        regions = reco_regions(lat, prob_t, prob_s, easy_threshold,
                               hard_threshold)
        anchor_idx, neg_idx = reco_sample(draws, regions, temp)
        return reco_loss_core(lat, regions.protos, anchor_idx, neg_idx,
                              regions.active, regions.valid_seg, temp)
