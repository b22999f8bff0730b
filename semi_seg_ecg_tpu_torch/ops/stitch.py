"""Windowed overlap-add inference for arbitrarily long records (counterpart
of ``semi_seg_ecg_tpu/ops/stitch.py``).

A Holter or telemetry record is hours long; the model takes fixed windows.
:func:`overlap_add_infer` slides the window across the record at stride
``hop``, standardizes each window over (leads, time) as the test pipeline's
``standardize: axis [-1, -2]`` does, runs the model on batches of windows
and blends the overlaps with a tapered weight (raised cosine with a 0.05
floor, sampled at half-integer offsets so that no weight is exactly zero),
normalized by the accumulated weight: a sample covered by a single window
gets that window's probabilities exactly (w/w == 1).

The record lives on the model's device for the whole call and the stitched
field comes back as one device tensor: no per-batch fetch. Each batch's
windows are a strided view of one contiguous span of the record
(``Tensor.unfold``), so windowing needs no gather; ``hop`` divides
``window``, and each window's k = window / hop hop-sized sub-blocks are
folded into a ``(n_blocks, C, hop)`` accumulator with k slice adds per
batch. The taper weights do not depend on the data and are folded once.

The JAX package compiles one program per record geometry and keeps it in a
cache keyed on the ``infer`` object (``_PROGRAMS``); eager PyTorch compiles
nothing, so there is no such cache here. Nor are the windows padded up to
a batch multiple: the last batch is short, so there are no zero-weight
padding windows and no zero tail pad behind them. The flash forwards of a
ViT are therefore 12 x ceil(n_win / batch).
"""

from __future__ import annotations

import math
from typing import Callable, Tuple

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["overlap_add_infer", "plan_windows", "standardize_windows"]


def _taper(window: int, kind: str) -> np.ndarray:
    if kind == "flat":
        return np.ones(window, np.float32)
    if kind == "hann":
        # half-sample offset: strictly positive at the endpoints; the 0.05
        # floor keeps single-cover normalization well-conditioned in f32
        w = 0.5 - 0.5 * np.cos(2 * np.pi * (np.arange(window) + 0.5) / window)
        return (0.05 + 0.95 * w).astype(np.float32)
    raise ValueError(f"unknown taper '{kind}' (expected 'hann' or 'flat')")


def plan_windows(total: int, window: int, hop: int,
                 batch: int) -> Tuple[int, int, int, int]:
    """Static window plan: ``(n_win, n_win_pad, n_blocks, padded_len)``.

    ``n_win`` windows at stride ``hop`` cover ``total`` samples (the last
    window may run into padding); ``n_win_pad`` rounds up to a batch
    multiple; the padded record is ``n_blocks * hop`` samples where each
    block is one hop-sized output tile.
    """
    if window % hop != 0:
        raise ValueError(f"hop ({hop}) must divide window ({window})")
    if total < 1:
        raise ValueError("record must contain at least one sample")
    n_win = max(0, math.ceil((total - window) / hop)) + 1
    n_win_pad = math.ceil(n_win / batch) * batch
    k = window // hop
    n_blocks = n_win_pad - 1 + k
    return n_win, n_win_pad, n_blocks, n_blocks * hop


def standardize_windows(win: torch.Tensor) -> torch.Tensor:
    """``(B, leads, window)`` z-normalized per window over (leads, time),
    with the population std (``jnp.std``); a flat window becomes zeros."""
    mu = win.mean(dim=(1, 2), keepdim=True)
    sd = win.std(dim=(1, 2), keepdim=True, correction=0)
    nonzero = sd != 0.0
    return torch.where(nonzero, (win - mu) / torch.where(nonzero, sd, 1.0),
                       0.0)


@torch.inference_mode()
def overlap_add_infer(infer: Callable, ecg, *, window: int,
                      hop: int | None = None, batch: int = 64,
                      taper: str = "hann", standardize: bool = True,
                      mesh=None):
    """Segment an arbitrary-length record with a fixed-window model.

    ``infer`` maps ``(B, leads, window)`` to ``(B, C, window)`` class
    probabilities on its ``infer.device`` (e.g. from
    :func:`serving.make_serving_fn`); ``ecg`` is the full record ``(leads,
    total)`` (or ``(total,)``, promoted to one lead), a numpy array or a
    tensor, and is placed on that device. Returns ``(probs, labels)``:
    ``(C, total)`` float32 stitched probabilities and their ``(total,)``
    int32 argmax, as tensors on that device; the caller pays the one
    fetch.

    ``hop`` defaults to ``window // 2`` (50% overlap) and must divide
    ``window``; ``standardize`` applies the per-window z-normalization.
    ``batch`` windows go through ``infer`` at a time (the last batch may
    be shorter); the result does not depend on it beyond the summation
    order of three or more overlapping windows.
    """
    if mesh is not None:
        raise NotImplementedError(
            "overlap_add_infer(mesh=...) is not yet ported to the torch "
            "package (multi-GPU, ROADMAP queue 1 item 10)")
    ecg = torch.as_tensor(ecg, dtype=torch.float32).to(infer.device)
    if ecg.ndim == 1:
        ecg = ecg[None, :]
    if ecg.ndim != 2:
        raise ValueError(f"record must be (leads, T) or (T,), got "
                         f"{tuple(ecg.shape)}")
    hop = window // 2 if hop is None else hop
    total = ecg.shape[1]
    n_win, _, _, _ = plan_windows(total, window, hop, batch)
    k = window // hop
    n_blocks = n_win - 1 + k
    # the valid windows' reach, n_blocks * hop samples, gets signal-shaped
    # content (reflection keeps the last window's standardization honest;
    # records shorter than the pad repeat their edge value); its extent
    # depends only on (total, window, hop)
    pad = n_blocks * hop - total
    record = ecg if pad <= 0 else F.pad(
        ecg[None], (0, pad), mode="reflect" if pad < total else "replicate")[0]
    wvec = torch.from_numpy(_taper(window, taper)).to(ecg.device)

    acc = None
    for first in range(0, n_win, batch):
        nb = min(batch, n_win - first)
        span = record[:, first * hop:(first + nb - 1) * hop + window]
        win = span.unfold(-1, window, hop).transpose(0, 1).contiguous()
        if standardize:
            win = standardize_windows(win)
        probs = infer(win).float()  # (nb, C, window)
        if acc is None:
            acc = probs.new_zeros((n_blocks, probs.shape[1], hop))
        contrib = (probs * wvec).unflatten(-1, (k, hop))
        for j in range(k):  # k is small: dense slice adds, no scatter
            acc[first + j:first + j + nb] += contrib[:, :, j]
    wacc = wvec.new_zeros((n_blocks, hop))
    for j, w in enumerate(wvec.view(k, hop)):
        wacc[j:j + n_win] += w
    num_classes = acc.shape[1]
    flat = acc.permute(1, 0, 2).reshape(num_classes, n_blocks * hop)
    probs = flat[:, :total] / wacc.reshape(-1)[:total].clamp_min(1e-8)
    return probs, probs.argmax(dim=0).to(torch.int32)
