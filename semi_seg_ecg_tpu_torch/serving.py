"""Serving surfaces of the port (counterpart of
``semi_seg_ecg_tpu/serving.py``).

- :func:`make_serving_fn`: a config's eval model with its checkpoint, as a
  callable ``infer(ecg) -> softmax (B, C, T)`` on the config's device, with
  ``run_inference``'s precision rule (fp32 unless ``test.use_amp``).
- :func:`long_record_inference`: one record of any length, filtered once at
  full length and stitched by :func:`ops.stitch.overlap_add_infer`.
- :class:`StreamingSegmenter`: the same stitch, live, chunk by chunk, for
  one or many concurrent streams.
- :func:`serve_batched`: fixed batch buckets for ragged request sizes.

The StableHLO export (``export_serving`` / ``load_serving``) and the HTTP
server (``make_http_server``) are not ported yet.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch

from .algorithms import common
from .config import resolve_device, test_cfg
from .models import compute_dtype
from .ops.stitch import _taper, plan_windows, standardize_windows


class ServingFn:
    """``infer(ecg) -> softmax (B, C, T)`` of an eval model: ``ecg`` a
    ``(B, leads, T)`` float32 tensor on :attr:`device`, the result float32
    there too. The one precision rule of the port's eval forwards
    (``run_inference``, the stitcher, the streaming segmenter): full fp32
    under inference mode unless ``use_amp``, which runs the model under
    the config's autocast dtype; no TF32 in cuBLAS and cuDNN, and the flash
    kernels' 3xTF32 products (fp32 accumulation, fp32 accuracy) are outside
    what ``full_fp32`` sets. :attr:`num_classes` is the decode head's
    output channels (the stitcher and the streaming segmenter size their
    accumulators from it without a probe forward)."""

    def __init__(self, model: torch.nn.Module, device: torch.device,
                 use_amp: bool, amp_dtype: torch.dtype):
        self.model, self.device = model, device
        self.use_amp, self.amp_dtype = use_amp, amp_dtype
        self.num_classes = int(model.decode_head.cls_seg.out_channels)

    def __call__(self, ecg: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode(), common.full_fp32(), torch.autocast(
                self.device.type, dtype=self.amp_dtype,
                enabled=self.use_amp):
            logits = self.model(ecg)["seg_logits"]
        return torch.softmax(logits.float(), dim=1)


def make_serving_fn(config: Dict[str, Any]):
    """``(infer, model)`` for a config: the eval-mode model with the
    requested checkpoint restored (``algorithms.common.load_eval_model``),
    on the config's device (the CUDA card unless it says ``device: cpu``),
    and its :class:`ServingFn`."""
    if config.get("quantize", None):
        raise NotImplementedError(
            f"quantize: {config['quantize']!r} is not yet ported to the "
            "torch package")
    device = resolve_device(config)
    use_amp = bool(test_cfg(config).get("use_amp", False))
    amp_dtype = compute_dtype(config) if use_amp else torch.float32
    model = common.load_eval_model(config, device)
    return ServingFn(model, device, use_amp, amp_dtype), model


def long_record_inference(
    config: Dict[str, Any],
    ecg,
    *,
    batch: int = 64,
    hop: Optional[int] = None,
    taper: str = "hann",
    infer: Optional[Callable] = None,
    mesh=None,
):
    """Segment one arbitrarily long record (Holter/telemetry scale).

    The record is filtered ONCE at full length with the config's
    ``dataset.filter`` chain (no window-edge filter artifacts, unlike
    filtering pre-cut windows), then windowed at ``signal_length``,
    per-window standardized, batched through the eval model and
    taper-stitched on the model's device
    (:func:`ops.stitch.overlap_add_infer`: one fetch per record).

    ``ecg``: ``(leads, T)`` or ``(T,)`` raw signal at the model's sampling
    rate. ``infer`` overrides the model function; by default the config's
    checkpoint is loaded via :func:`make_serving_fn` — when segmenting many
    records, build ``infer`` once and pass it, or every call pays the
    checkpoint load. Per-window standardization follows the config's
    ``dataset.transforms`` (applied iff a ``standardize`` entry is present,
    as in every shipped recipe; axes other than the full ``[-1, -2]``
    window are not representable per window and are rejected).
    Returns ``{"probs": (C, T) float32, "labels": (T,) int32}`` numpy.
    """
    from .data.transforms import get_transforms_from_config
    from .ops.stitch import overlap_add_infer

    if mesh is not None:
        raise NotImplementedError(
            "long_record_inference(mesh=...) is not yet ported to the torch "
            "package (multi-GPU, ROADMAP queue 1 item 10)")
    ecg = np.asarray(ecg, np.float32)
    if ecg.ndim == 1:
        ecg = ecg[None, :]
    for t in (get_transforms_from_config(
            config["dataset"].get("filter") or []) or []):
        ecg = t(ecg)
    standardize = False
    for entry in config["dataset"].get("transforms") or []:
        name = entry if isinstance(entry, str) else next(iter(entry))
        # the transforms parser accepts both the MAPPING key
        # ('standardize') and the class-name spelling ('Standardize')
        if name.lower() == "standardize":
            axis = (entry.get(name) or {}).get("axis", (-1, -2)) \
                if isinstance(entry, dict) else (-1, -2)
            axis = tuple(axis) if isinstance(axis, (list, tuple)) else (axis,)
            if axis not in ((-1, -2), (-2, -1)):
                raise ValueError(
                    f"long_record_inference: per-window standardize over "
                    f"axis {axis} is not supported (whole-window axes only)")
            standardize = True
    if infer is None:
        infer, _ = make_serving_fn(config)
    window = int(config["dataset"].get("signal_length", 2500))
    probs, labels = overlap_add_infer(
        infer, ecg, window=window, hop=hop, batch=batch, taper=taper,
        standardize=standardize)
    return {"probs": probs.cpu().numpy(), "labels": labels.cpu().numpy()}


class StreamingSegmenter:
    """Online (real-time) segmentation of an unbounded ECG stream.

    The live-telemetry counterpart of :func:`long_record_inference`:
    samples arrive in chunks of any size (``push``), and class
    probabilities are finalized and returned with bounded latency — a
    sample is emitted once the last window covering it has run, i.e.
    worst-case latency of one ``window`` plus the chunk period. The window
    grid, per-window standardization, taper blend and tail rule are
    :mod:`ops.stitch`'s, so streaming a record chunk by chunk reproduces
    ``overlap_add_infer``'s output.

    One step per window: the model's forward on the window, plus the
    ``window - hop`` overlap accumulator, which stays on ``infer.device``
    between pushes; each step fetches its ``hop`` finalized probabilities
    once (the latency contract) and takes their argmax on the host. Each
    window is standardized over (leads, time), as every shipped recipe's
    ``dataset.transforms`` does; ``taper`` is the offline stitcher's
    (``--taper``). ``infer`` maps ``(B, leads, window) -> (B, C,
    window)`` probabilities and carries ``device`` and ``num_classes``
    (:class:`ServingFn`).

    ``num_streams`` batches S concurrent live streams through the same
    step — the batch dimension is the stream dimension. Streams advance in
    lockstep (``push`` takes ``(S, leads, n)``); per-stream standardization
    and overlap carries are independent, so each stream's output is the
    same as running it alone.
    """

    def __init__(self, infer: Callable, *, window: int,
                 hop: Optional[int] = None, num_leads: int = 1,
                 taper: str = "hann", num_streams: int = 1, mesh=None):
        if mesh is not None:
            raise NotImplementedError(
                "StreamingSegmenter(mesh=...) is not yet ported to the torch "
                "package (multi-GPU, ROADMAP queue 1 item 10)")
        hop = window // 2 if hop is None else hop
        if window % hop != 0:
            raise ValueError(f"hop ({hop}) must divide window ({window})")
        if num_streams < 1:
            raise ValueError("num_streams must be >= 1")
        self.infer = infer
        self.window, self.hop, self.leads = window, hop, num_leads
        self.num_streams = num_streams
        self.num_classes = int(infer.num_classes)
        self._wvec = torch.from_numpy(_taper(window, taper)).to(infer.device)
        self.reset()

    @torch.inference_mode()
    def reset(self):
        S, device = self.num_streams, self.infer.device
        self._buf = np.zeros((S, self.leads, 0), np.float32)  # unprocessed
        self._last = np.zeros((S, self.leads, 0), np.float32)  # reflect src
        # contributions of earlier windows to the next window - hop samples
        # and their taper weights (data-independent, shared by the streams)
        self._acc = torch.zeros((S, self.num_classes, self.window - self.hop),
                                device=device)
        self._wacc = torch.zeros(self.window - self.hop, device=device)
        self._total = 0  # samples pushed per stream
        self._emitted = 0  # samples finalized per stream

    def _squeeze(self, probs, labels):
        if self.num_streams == 1:
            return probs[0], labels[0]
        return probs, labels

    @torch.inference_mode()
    def _run_window(self, win: np.ndarray):
        """One step: ``(S, leads, window)`` raw samples in, the ``hop``
        samples it finalizes out (``(S, C, hop)``, ``(S, hop)`` numpy)."""
        hop, carry = self.hop, self.window - self.hop
        win = torch.from_numpy(np.ascontiguousarray(win)).to(self.infer.device)
        # (S, C, window)
        acc = self.infer(standardize_windows(win)).float() * self._wvec
        acc[:, :, :carry] += self._acc
        wacc = self._wvec.clone()
        wacc[:carry] += self._wacc
        out = acc[:, :, :hop] / wacc[:hop].clamp_min(1e-8)
        self._acc, self._wacc = acc[:, :, hop:], wacc[hop:]
        probs = out.cpu().numpy()
        return probs, probs.argmax(axis=1).astype(np.int32)

    def _empty(self):
        S = self.num_streams
        return self._squeeze(np.zeros((S, self.num_classes, 0), np.float32),
                             np.zeros((S, 0), np.int32))

    def push(self, chunk):
        """Feed ``n`` new samples per stream — ``(S, leads, n)``; with
        ``num_streams == 1`` also ``(leads, n)`` or ``(n,)``. Returns
        ``(probs, labels)`` for the samples finalized by this chunk —
        ``(S, C, m)`` / ``(S, m)``, leading axis squeezed for a single
        stream, possibly with m == 0."""
        chunk = np.asarray(chunk, np.float32)
        if self.num_streams == 1:
            if chunk.ndim == 1:
                chunk = chunk[None]
            if chunk.ndim == 2:
                chunk = chunk[None]
        want = (self.num_streams, self.leads)
        if chunk.ndim != 3 or chunk.shape[:2] != want:
            raise ValueError(f"expected (streams, leads, n) = (*{want}, n), "
                             f"got shape {chunk.shape}")
        self._total += chunk.shape[2]
        self._buf = np.concatenate([self._buf, chunk], axis=2)
        self._last = np.concatenate([self._last, chunk],
                                    axis=2)[:, :, -self.window:]
        probs_out, labels_out = [], []
        while self._buf.shape[2] >= self.window:
            p, l = self._run_window(self._buf[:, :, :self.window])
            probs_out.append(p)
            labels_out.append(l)
            self._buf = self._buf[:, :, self.hop:]
            self._emitted += self.hop
        if not probs_out:
            return self._empty()
        return self._squeeze(np.concatenate(probs_out, axis=2),
                             np.concatenate(labels_out, axis=1))

    def flush(self):
        """End of stream: run the remaining tail windows (content-padded
        with the same reflect/edge rule as the offline stitcher) and
        return ``(probs, labels)`` for all not-yet-finalized samples up
        to the stream length. The segmenter then resets."""
        total, window, hop = self._total, self.window, self.hop
        if total < 1:
            self.reset()
            return self._empty()
        # the offline engine owns the window-grid/tail rule
        n_win, _, _, _ = plan_windows(total, window, hop, 1)
        reach = (n_win - 1) * hop + window
        pad = reach - total
        if pad > 0:
            if pad < total:  # reflect from the retained tail (pad < window)
                ext = self._last[:, :, -(pad + 1):-1][:, :, ::-1]
            else:  # tiny record: edge values
                ext = np.repeat(self._last[:, :, -1:], pad, axis=2)
            self._buf = np.concatenate([self._buf, ext], axis=2)
        probs_out, labels_out = [], []
        n_run = (self._emitted // hop)
        for i in range(n_run, n_win):
            p, l = self._run_window(self._buf[:, :, :window])
            probs_out.append(p)
            labels_out.append(l)
            self._buf = self._buf[:, :, hop:]
        # the final window's trailing overlap is covered by no later
        # window: normalize the carry directly
        with torch.inference_mode():
            tail = (self._acc / self._wacc.clamp_min(1e-8)).cpu().numpy()
        probs_out.append(tail)
        labels_out.append(tail.argmax(axis=1).astype(np.int32))
        probs = np.concatenate(probs_out, axis=2)
        labels = np.concatenate(labels_out, axis=1)
        keep = total - self._emitted
        self.reset()
        return self._squeeze(probs[:, :, :keep], labels[:, :keep])


def serve_batched(serve: Callable, ecg: np.ndarray,
                  bucket_sizes: Sequence[int] = (16, 64, 256)):
    """Run ``serve`` on an arbitrary-size batch through fixed size buckets.

    ``serve`` maps a numpy ``(n, leads, T)`` batch to ``(n, C, T)``. The
    batch is padded up to the smallest admitting bucket (largest bucket
    repeated for the overflow), so ``serve`` only ever sees
    ``len(bucket_sizes)`` batch sizes, and the padding is sliced back off.
    Rows are independent in this model family, so padding rows never change
    real outputs. An eager forward gains nothing from it (the padding is
    extra work); it is for a serving artifact traced at fixed batch sizes,
    which the port does not have yet (ROADMAP queue 1 item 6)."""
    if not bucket_sizes:
        raise ValueError("bucket_sizes must be non-empty")
    buckets = sorted(bucket_sizes)
    n = ecg.shape[0]
    if n == 0:
        # output row shape (C, T) is only knowable from the program: run
        # the smallest bucket once and keep zero rows
        probe = np.zeros((buckets[0],) + tuple(ecg.shape[1:]), ecg.dtype)
        return np.asarray(serve(probe))[:0]
    outs = []
    off = 0
    while off < n:
        rest = n - off
        size = next((b for b in buckets if b >= rest), buckets[-1])
        take = min(rest, size)
        chunk = ecg[off:off + take]
        if take < size:
            pad = np.zeros((size - take,) + tuple(ecg.shape[1:]),
                           dtype=ecg.dtype)
            chunk = np.concatenate([np.asarray(chunk), pad], axis=0)
        outs.append(np.asarray(serve(chunk))[:take])
        off += take
    return np.concatenate(outs, axis=0)
