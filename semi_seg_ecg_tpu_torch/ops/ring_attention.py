"""Ring attention over the seq ranks (counterpart of
``semi_seg_ecg_tpu/ops/ring_attention.py``).

Under ``parallel.seq_parallel`` s > 1 each seq rank holds one chunk of the
ViT's tokens (``parallel/seq_shard.py``; the cls token and the first block
of patches on seq rank 0, each other rank its block of patches, so the
chunks are as the patch embedding makes them and differ by at most two
tokens). Softmax attention is all-to-all over tokens, so the K/V chunks
travel: padded to the longest chunk, they rotate s − 1 times around the
ring (send to rank i + 1, receive from rank i − 1; ``SeqComm.exchange``)
while each rank attends its own queries to the chunk it holds. The
result is exact attention over every token.

On CUDA tensors each hop is one launch of the hand-written flash forward
(``ops/flash_attention.flash_attention_hop_forward``: this rank's ``nq``
queries against the chunk's ``n_kv`` valid keys), and the hops' normalised
``(out_i, lse_i)`` are merged by their log-sum-exp in fp32:
``lse = logsumexp_i lse_i``, ``out = Σ_i exp(lse_i − lse) out_i``. A flash
hop never materialises an (nq, nk) score block, so the key sub-blocking of
the JAX package (``_SCORE_CAP``) has no counterpart on this path.

The backward is equation-based (the JAX package's ``_make_local_ring``),
not autograd through the hops: it keeps only (q, k, v, out, lse), runs the
rotation again with one flash backward launch per hop (P from the merged
lse, Δ = rowsum(dO ∘ O) from the merged out: the hop's part of dq and of
the visiting chunk's dk, dv), lets fp32 dK/dV accumulators ride the ring
with their chunks, and sends each home with one last rotation.

The plain version (CPU tensors, and :func:`ring_attention_plain` on the
card for comparison) is the JAX fold in PyTorch: the online-softmax state
(running max, denominator, accumulator) updated per visiting chunk
(``_block_update``) and the hop gradients recomputed from the saved
log-sum-exp (``_hop_grads``), in fp32, with the chunk's pad keys masked.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from .flash_attention import (
    BF16_ULP,
    backward_error_bound,
    flash_attention_hop_backward,
    flash_attention_hop_forward,
    forward_error_bound,
)

_BIG_NEG = -1e30  # a masked score: finite, so (s - m) is never inf - inf


def _block_update(q, k, v, kmask, o, m, l, scale):
    """Fold one visiting chunk into the online-softmax state (fp32): ``q``
    (B, H, nq, D), ``k``/``v`` (B, H, nk, D), ``kmask`` (nk,) True for a
    token; ``o``, ``m``, ``l`` the accumulator, running max and
    denominator."""
    sc = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    sc = torch.where(kmask, sc, _BIG_NEG)
    m_new = torch.maximum(m, sc.amax(dim=-1))
    p = torch.exp(sc - m_new[..., None]) * kmask
    corr = torch.exp(m - m_new)
    l_new = l * corr + p.sum(dim=-1)
    o_new = o * corr[..., None] + torch.einsum("bhqk,bhkd->bhqd", p, v)
    return o_new, m_new, l_new


def _hop_grads(q, dout, lse, dd, k, v, kmask, scale):
    """``(dq, dk, dv)`` of one visiting chunk from the merged ``lse`` and
    ``dd = rowsum(dout ∘ out)`` (fp32): P = exp(S − lse), dV = Pᵀ dO,
    dS = P (dO Vᵀ − dd) · scale, dq = dS K, dK = dSᵀ q."""
    sc = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    p = torch.exp(sc - lse[..., None]) * kmask
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dout)
    dp = torch.einsum("bhqd,bhkd->bhqk", dout, v)
    ds = p * (dp - dd[..., None]) * scale
    return (torch.einsum("bhqk,bhkd->bhqd", ds, k),
            torch.einsum("bhqk,bhqd->bhkd", ds, q), dv)


def _rotate(comm, t: torch.Tensor) -> torch.Tensor:
    """``t`` to seq rank i + 1; what rank i − 1 sends, returned."""
    s, i = comm.size, comm.rank
    return comm.exchange({(i + 1) % s: t},
                         {(i - 1) % s: (tuple(t.shape), t.dtype)},
                         t.device)[(i - 1) % s]


def _pad_tokens(t: torch.Tensor, n: int) -> torch.Tensor:
    return F.pad(t, (0, 0, 0, n - t.shape[2]))


def ring_forward(q, k, v, comm, scale, counts, kernel):
    """``(out, lse)`` of this rank's queries over every rank's tokens: the
    K/V chunks rotated s − 1 times, a flash forward per hop merged by the
    hops' log-sum-exp (``kernel``), or the plain fold. ``out`` in q's
    dtype, ``lse`` fp32."""
    s, i = comm.size, comm.rank
    width = max(counts)
    # k and v travel as one buffer
    kv = torch.stack([_pad_tokens(k, width), _pad_tokens(v, width)])
    outs, lses = [], []
    if not kernel:
        ar = torch.arange(width, device=q.device)
        qf = q.float()
        o = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        m = torch.full(q.shape[:3], _BIG_NEG, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros(q.shape[:3], dtype=torch.float32, device=q.device)
    for t in range(s):
        if t:
            kv = _rotate(comm, kv)
        n_kv = counts[(i - t) % s]
        if kernel:
            out_t, lse_t = flash_attention_hop_forward(q, kv[0], kv[1],
                                                       scale, n_kv)
            outs.append(out_t)
            lses.append(lse_t)
        else:
            o, m, l = _block_update(qf, kv[0].float(), kv[1].float(),
                                    ar < n_kv, o, m, l, scale)
    if kernel:
        lse_all = torch.stack(lses)
        lse = torch.logsumexp(lse_all, dim=0)
        w = torch.exp(lse_all - lse)
        out = sum(w[j][..., None] * outs[j].float() for j in range(s))
    else:
        out = o / l[..., None]
        lse = m + torch.log(l)
    return out.to(q.dtype), lse


def ring_backward(q, k, v, out, lse, dout, comm, scale, counts, kernel):
    """``(dq, dk, dv)`` of this rank's chunk: the rotation again, a flash
    backward per hop on the merged ``out`` and ``lse`` (``kernel``) or the
    plain hop gradients, fp32 dK/dV accumulators riding with their chunks
    and sent home by one last rotation."""
    s, i = comm.size, comm.rank
    width = max(counts)
    kv = torch.stack([_pad_tokens(k, width), _pad_tokens(v, width)])
    dkv = torch.zeros(kv.shape, dtype=torch.float32, device=q.device)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    if kernel:
        dout = dout.to(q.dtype).contiguous()
    else:
        ar = torch.arange(width, device=q.device)
        qf, dof = q.float(), dout.float()
        dd = (dof * out.float()).sum(dim=-1)
    for t in range(s):
        if t:
            kv = _rotate(comm, kv)
            dkv = _rotate(comm, dkv)
        n_kv = counts[(i - t) % s]
        if kernel:
            dq_t, dk_t, dv_t = flash_attention_hop_backward(
                q, kv[0], kv[1], out, lse, dout, scale, n_kv)
        else:
            dq_t, dk_t, dv_t = _hop_grads(qf, dof, lse, dd, kv[0].float(),
                                          kv[1].float(), ar < n_kv, scale)
        dq += dq_t.float()
        dkv[0] += dk_t.float()
        dkv[1] += dv_t.float()
    if s > 1:
        # the accumulator held now is that of rank i + 1's chunk
        dkv = _rotate(comm, dkv)
    n = counts[i]
    return (dq.to(q.dtype), dkv[0, :, :, :n].to(k.dtype),
            dkv[1, :, :, :n].to(v.dtype))


class _Ring(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, comm, scale, counts, kernel):
        out, lse = ring_forward(q, k, v, comm, scale, counts, kernel)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (comm, scale, counts, kernel)
        return out

    @staticmethod
    def backward(ctx, dout):
        return ring_backward(*ctx.saved_tensors, dout, *ctx.args) + (
            None, None, None, None)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   scale: float, counts: Sequence[int], comm,
                   kernel: Optional[bool] = None) -> torch.Tensor:
    """Exact attention of this seq rank's tokens over every rank's:
    ``q, k, v`` this rank's ``(B, H, counts[rank], D)`` chunk (rank order
    is token order), ``comm`` the seq ranks' :class:`SeqComm`. Returns the
    chunk's output in q's dtype, differentiable. ``kernel`` (default: the
    tensors are on CUDA) runs the hops through the flash kernels, else
    through the plain fold; on CUDA tensors the kernel path raises rather
    than falls back."""
    counts = tuple(int(c) for c in counts)
    if q.shape[2] != counts[comm.rank]:
        raise ValueError(f"ring_attention: rank {comm.rank} holds "
                         f"{q.shape[2]} tokens, counts say "
                         f"{counts[comm.rank]}")
    if kernel is None:
        kernel = q.is_cuda
    return _Ring.apply(q, k, v, comm, float(scale), counts, bool(kernel))


def ring_attention_plain(q, k, v, scale, counts, comm) -> torch.Tensor:
    """:func:`ring_attention` through the plain fold on any device."""
    return ring_attention(q, k, v, scale, counts, comm, kernel=False)


def ring_forward_error_bound(q, k, v, scale) -> torch.Tensor:
    """Per-element tolerance of the bf16 kernel ring's output against the
    plain ring's, over the whole token axis: the single flash kernel's
    bound (``forward_error_bound``) plus each hop's output rounded to bf16
    before the merge, at most one bf16 ulp of the hop's share of
    P |V|."""
    with torch.autocast(q.device.type, enabled=False):
        qf, kf, vf = q.float(), k.float(), v.float()
        p = torch.softmax(torch.einsum("bhnd,bhmd->bhnm", qf, kf) * scale,
                          dim=-1)
        return forward_error_bound(q, k, v, scale) + BF16_ULP * (
            p @ vf.abs())


def ring_backward_error_bound(q, k, v, out, lse, dout, scale):
    """Per-element tolerances ``(dq, dk, dv)`` of the bf16 kernel ring's
    gradients against the plain ring's, over the whole token axis: the
    flash backward's bound (``backward_error_bound``) plus each hop's
    gradient rounded to bf16 before it is summed in fp32 (one bf16 ulp of
    the sum of the hops' magnitudes, which the bound's first term holds)."""
    base = backward_error_bound(q, k, v, out, lse, dout, scale)
    with torch.autocast(q.device.type, enabled=False):
        qf, kf, dof = q.float(), k.float(), dout.float()
        delta = (dof * out.float()).sum(dim=-1, keepdim=True)
        p = torch.exp(torch.einsum("bhnd,bhmd->bhnm", qf, kf) * scale
                      - lse.unsqueeze(-1))
        ds = p * (dof @ v.float().transpose(-1, -2) - delta)
        terms = (scale * (ds.abs() @ kf.abs()),
                 scale * (ds.abs().transpose(-1, -2) @ qf.abs()),
                 p.transpose(-1, -2) @ dof.abs())
    return tuple(b + BF16_ULP * t for b, t in zip(base, terms))
