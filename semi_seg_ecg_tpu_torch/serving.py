"""Serving surfaces of the port (counterpart of
``semi_seg_ecg_tpu/serving.py``).

- :func:`make_serving_fn`: a config's eval model with its checkpoint, as a
  callable ``infer(ecg) -> softmax (B, C, T)`` on the config's device, with
  ``run_inference``'s precision rule (fp32 unless ``test.use_amp``) and
  ``quantize: int8`` (dynamic scales, or static ones calibrated on the
  first ``quantize_calibration`` test batches).
- :func:`long_record_inference`: one record of any length, filtered once at
  full length and stitched by :func:`ops.stitch.overlap_add_infer`.
- :class:`StreamingSegmenter`: the same stitch, live, chunk by chunk, for
  one or many concurrent streams.
- :func:`serve_batched`: fixed batch buckets for ragged request sizes.
- :func:`export_serving` / :func:`load_serving`: the deployment unit, one
  file holding the serving program with its weights baked in
  (``torch.export``), loaded and run without the model code or the
  checkpoint; :func:`make_http_server` serves it over HTTP.

Artifact layout, the JAX package's with a magic of its own: ``ECGTEXP1``,
a 4-byte little-endian JSON-header length, the JSON header (shapes,
classes, precision, quantization, platforms), then the
``torch.export.save`` bytes. The program is the eval model followed by
the float softmax, as :class:`ServingFn` computes it; its batch is
symbolic unless pinned. The ViT's flash attention is the PyTorch operator
``semi_seg_ecg_tpu_torch::flash_attention_forward`` in the program, so the
loaded artifact launches the CUDA kernel as the eager model does (12 times
a batch for vit_tiny). A cross-platform artifact (``platforms=("cuda",
"cpu")``, the JAX package's multi-platform export) holds one program per
platform, because an exported program's constants live on one device: the
header's ``platforms`` lists them in order and ``programs`` gives each
one's ``offset`` and ``length`` in the bytes after the header. Each
program holds the same weights (and calibrated scales), moved to its
device; the CPU program's flash operator takes the plain version. A
one-platform artifact keeps the layout above, with no ``programs``.
"""

from __future__ import annotations

import contextlib
import copy
import io
import json
import os
import struct
import threading
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

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

    @contextlib.contextmanager
    def precision(self):
        """The forward's precision: TF32 off, autocast when ``use_amp``."""
        with common.full_fp32(), torch.autocast(
                self.device.type, dtype=self.amp_dtype,
                enabled=self.use_amp):
            yield

    def __call__(self, ecg: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode(), self.precision():
            logits = self.model(ecg)["seg_logits"]
        return torch.softmax(logits.float(), dim=1)


def _calibration_batches(config: Dict[str, Any], n: int):
    """The first ``n`` test-split batches (``(B, leads, T)`` float32
    numpy), for int8 activation calibration."""
    from .data.dataset import build_seg_dataset
    from .data.loader import get_dataloader

    ds = build_seg_dataset(config["dataset"], split="test")
    loader = get_dataloader(
        ds, mode="test", batch_size=config["dataloader"]["batch_size"],
        seed=config.get("seed", 0), num_workers=0)
    out = []
    try:
        for i, b in enumerate(loader):
            if i >= n:
                break
            out.append(b["ecg"])
    finally:
        loader.close()
    return out


def make_serving_fn(config: Dict[str, Any]):
    """``(infer, model)`` for a config: the eval-mode model with the
    requested checkpoint restored (``algorithms.common.load_eval_model``,
    which builds ``quantize: int8`` in int8), on the config's device (the
    CUDA card unless it says ``device: cpu``), and its :class:`ServingFn`.
    ``quantize: int8`` with ``quantize_calibration: N`` calibrates static
    activation scales on the first N test batches
    (``utils/calibrate.py``), in the serving precision."""
    device = resolve_device(config)
    use_amp = bool(test_cfg(config).get("use_amp", False))
    amp_dtype = compute_dtype(config) if use_amp else torch.float32
    model = common.load_eval_model(config, device)
    infer = ServingFn(model, device, use_amp, amp_dtype)
    n_cal = int(config.get("quantize_calibration", 0) or 0)
    if config.get("quantize") == "int8" and n_cal > 0:
        from .utils.calibrate import calibrate_quant

        batches = [torch.from_numpy(b).to(device)
                   for b in _calibration_batches(config, n_cal)]
        with infer.precision():
            calibrate_quant(model, batches)
    return infer, model


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
    ``mesh`` (``parallel/mesh.make_mesh``) splits the windows over its
    data ranks (:func:`ops.stitch.overlap_add_infer`); every rank returns
    the whole record's result.
    Returns ``{"probs": (C, T) float32, "labels": (T,) int32}`` numpy.
    """
    from .data.transforms import get_transforms_from_config
    from .ops.stitch import overlap_add_infer

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
        standardize=standardize, mesh=mesh)
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

    ``mesh`` (``parallel/mesh.make_mesh``) splits the streams over its
    data ranks, as the JAX package shards the stream axis: every rank
    pushes the same ``(S, leads, n)`` chunks, steps its own block of
    ``S / data`` streams and keeps their carries, and each step's result
    is all-gathered over the data group, so ``push`` returns every
    stream's, as the JAX object returns the global array.
    """

    def __init__(self, infer: Callable, *, window: int,
                 hop: Optional[int] = None, num_leads: int = 1,
                 taper: str = "hann", num_streams: int = 1, mesh=None):
        hop = window // 2 if hop is None else hop
        if window % hop != 0:
            raise ValueError(f"hop ({hop}) must divide window ({window})")
        if num_streams < 1:
            raise ValueError("num_streams must be >= 1")
        if mesh is not None and num_streams % mesh.data != 0:
            raise ValueError(
                f"num_streams ({num_streams}) must divide by the mesh's "
                f"data axis ({mesh.data})")
        self.mesh = mesh
        # this rank's block of streams
        per = num_streams if mesh is None else num_streams // mesh.data
        first = 0 if mesh is None else mesh.data_rank * per
        self._mine = slice(first, first + per)
        self.infer = infer
        self.window, self.hop, self.leads = window, hop, num_leads
        self.num_streams = num_streams
        self.num_classes = int(infer.num_classes)
        self._wvec = torch.from_numpy(_taper(window, taper)).to(infer.device)
        self.reset()

    @torch.inference_mode()
    def reset(self):
        device = self.infer.device
        S = self._mine.stop - self._mine.start
        n = self.num_streams
        self._buf = np.zeros((n, self.leads, 0), np.float32)  # unprocessed
        self._last = np.zeros((n, self.leads, 0), np.float32)  # reflect src
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
        samples it finalizes out (``(S, C, hop)``, ``(S, hop)`` numpy);
        under a mesh this rank steps its block of the streams and gathers
        the others'."""
        hop, carry = self.hop, self.window - self.hop
        win = torch.from_numpy(np.ascontiguousarray(
            win[self._mine])).to(self.infer.device)
        # (S, C, window)
        acc = self.infer(standardize_windows(win)).float() * self._wvec
        acc[:, :, :carry] += self._acc
        wacc = self._wvec.clone()
        wacc[:carry] += self._wacc
        out = acc[:, :, :hop] / wacc[:hop].clamp_min(1e-8)
        self._acc, self._wacc = acc[:, :, hop:], wacc[hop:]
        probs = self._gathered(out).cpu().numpy()
        return probs, probs.argmax(axis=1).astype(np.int32)

    def _gathered(self, out: torch.Tensor) -> torch.Tensor:
        """Every stream's rows of ``out`` (this rank's block), gathered
        over the mesh's data group."""
        if self.mesh is None:
            return out
        from .parallel.dist import gather_batch

        return gather_batch(out, self.mesh.data_group)

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
            tail = self._gathered(
                self._acc / self._wacc.clamp_min(1e-8)).cpu().numpy()
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

    ``serve`` maps a numpy ``(n, leads, T)`` batch to ``(n, C, T)``, numpy
    or a tensor (a loaded artifact's :class:`ArtifactFn`); the result is
    numpy. The batch is padded up to the smallest admitting bucket (largest
    bucket repeated for the overflow), so ``serve`` only ever sees
    ``len(bucket_sizes)`` batch sizes, and the padding is sliced back off.
    Rows are independent in this model family at float precision, so
    padding rows never change real outputs (int8 with dynamic scales
    quantizes each batch with the whole batch's absmax, as in the JAX
    package). An eager forward gains nothing from it (the padding is extra
    work); it serves a symbolic-batch artifact at a few batch sizes."""
    if not bucket_sizes:
        raise ValueError("bucket_sizes must be non-empty")
    buckets = sorted(bucket_sizes)
    n = ecg.shape[0]
    if n == 0:
        # output row shape (C, T) is only knowable from the program: run
        # the smallest bucket once and keep zero rows
        probe = np.zeros((buckets[0],) + tuple(ecg.shape[1:]), ecg.dtype)
        return _numpy(serve(probe))[:0]
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
        outs.append(_numpy(serve(chunk))[:take])
        off += take
    return np.concatenate(outs, axis=0)


def _numpy(out) -> np.ndarray:
    return out.cpu().numpy() if torch.is_tensor(out) else np.asarray(out)


# ---------------------------------------------------------------------------
# The serving artifact
# ---------------------------------------------------------------------------

_MAGIC = b"ECGTEXP1"
# the largest batch a symbolic-batch artifact takes
MAX_BATCH = 65535


class _ServingProgram(torch.nn.Module):
    """What the artifact computes: the eval model under the serving
    precision, then the float softmax over classes (:class:`ServingFn`'s
    forward). Autocast is entered inside, so the exported graph holds it."""

    def __init__(self, infer: ServingFn):
        super().__init__()
        self.model = infer.model
        self.device_type = infer.device.type
        self.amp_dtype = infer.amp_dtype if infer.use_amp else None

    def forward(self, ecg: torch.Tensor) -> torch.Tensor:
        if self.amp_dtype is None:
            logits = self.model(ecg)["seg_logits"]
        else:
            with torch.autocast(self.device_type, dtype=self.amp_dtype):
                logits = self.model(ecg)["seg_logits"]
        return torch.softmax(logits.float(), dim=1)


# the platforms the port lowers a serving program for
PLATFORMS = ("cuda", "cpu")


def _export_platforms(platforms: Optional[Sequence[str]],
                      device: torch.device) -> list:
    """The artifact's platforms, in order (default: the config's device
    type). A name the port cannot lower (``tpu`` among them) or a repeat
    raises ``ValueError``; ``cuda`` where torch sees no card raises
    ``RuntimeError``."""
    if platforms is None:
        return [device.type]
    platforms = list(platforms)
    unknown = [p for p in platforms if p not in PLATFORMS]
    if unknown or not platforms or len(set(platforms)) != len(platforms):
        raise ValueError(
            f"export_serving(platforms={platforms}): the port lowers a "
            f"serving program for each of {list(PLATFORMS)}, each once")
    if "cuda" in platforms and not torch.cuda.is_available():
        raise RuntimeError("export_serving: platform 'cuda' asked for, and "
                           "torch sees no CUDA device")
    return platforms


def _export_program(infer: "ServingFn", platform: str,
                    batch_size: Optional[int], length: int) -> bytes:
    """``torch.export.save`` bytes of ``infer``'s serving program traced on
    ``platform`` (the model copied there if it lies elsewhere)."""
    device = torch.device(platform)
    if device.type != infer.device.type:
        model = copy.deepcopy(infer.model).to(device)
        infer = ServingFn(model, device, infer.use_amp, infer.amp_dtype)
    program = _ServingProgram(infer)
    for p in program.parameters():
        p.requires_grad_(False)
    example = torch.zeros((batch_size or 2, 1, length), dtype=torch.float32,
                          device=device)
    dynamic = None
    if batch_size is None:
        # the CUDA convolutions' trace bounds the batch at 65535
        dynamic = {"ecg": {0: torch.export.Dim("batch", min=1,
                                               max=MAX_BATCH)}}
    with common.full_fp32():
        exported = torch.export.export(program, (example,),
                                       dynamic_shapes=dynamic)
    buf = io.BytesIO()
    torch.export.save(exported, buf)
    return buf.getvalue()


def export_serving(config: Dict[str, Any], out_path: str,
                   batch_size: Optional[int] = None,
                   platforms: Optional[Sequence[str]] = None
                   ) -> Dict[str, Any]:
    """Export the config's serving program to ``out_path`` (atomically);
    returns the artifact header. The program is :func:`make_serving_fn`'s
    (its checkpoint, precision, ``quantize`` and calibrated scales), traced
    by ``torch.export`` on the config's device with the weights and
    calibrated scales as the program's state; tracing launches no kernel.
    The batch is symbolic (1 to ``MAX_BATCH``) unless ``batch_size`` pins
    it. ``platforms`` defaults to the config's device; ``("cuda", "cpu")``
    writes one file with a program for each (:func:`_export_platforms`
    says what raises)."""
    device = resolve_device(config)
    platforms = _export_platforms(platforms, device)
    infer, _ = make_serving_fn(config)
    num_leads = 1
    length = int(config["dataset"].get("signal_length", 2500))
    blobs = [_export_program(infer, p, batch_size, length)
             for p in platforms]

    quantize = config.get("quantize", None)
    static = (quantize == "int8"
              and int(config.get("quantize_calibration", 0) or 0) > 0)
    header = {
        "format": "torch.export",
        "input_shape": [batch_size, num_leads, length],
        "num_classes": infer.num_classes,
        "output": "softmax_probs (B, C, T) float32",
        # the precision of the traced graph: fp32 unless test.use_amp
        "precision": (config.get("precision", "bf16") if infer.use_amp
                      else "fp32"),
        "quantize": quantize,
        "act_scales": ("static" if static else
                       "dynamic" if quantize == "int8" else None),
        "platforms": platforms,
        "torch_version": torch.__version__,
    }
    if len(blobs) > 1:
        offsets = np.cumsum([0] + [len(b) for b in blobs]).tolist()
        header["programs"] = [
            {"platform": p, "offset": o, "length": len(b)}
            for p, o, b in zip(platforms, offsets, blobs)]
    payload = json.dumps(header).encode("utf-8")
    tmp = out_path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<I", len(payload)))
        f.write(payload)
        for blob in blobs:
            f.write(blob)
    os.replace(tmp, out_path)  # atomic, as checkpoints are written
    return header


class ArtifactFn:
    """A loaded artifact as a serving function: ``serve(ecg) -> softmax
    (B, C, T)`` float32 on :attr:`device`, for a ``(B, leads, T)`` float32
    tensor or numpy array; run under inference mode with TF32 off (process
    state the program does not hold: PyTorch's default lets cuDNN use TF32
    for fp32 convolutions). It carries :attr:`device` and
    :attr:`num_classes`, so the long-record stitcher and the streaming
    segmenter take it as they take :class:`ServingFn`."""

    def __init__(self, program: torch.nn.Module, header: Dict[str, Any],
                 device: torch.device):
        self.program, self.header, self.device = program, header, device
        self.num_classes = int(header["num_classes"])

    def __call__(self, ecg) -> torch.Tensor:
        """Raises ``ValueError`` on a shape the artifact does not take (a
        pinned artifact takes its own batch size only)."""
        if not torch.is_tensor(ecg):
            ecg = torch.from_numpy(np.asarray(ecg, np.float32))
        want = self.header["input_shape"]
        if ecg.dim() != 3 or list(ecg.shape[1:]) != want[1:] or (
                want[0] is not None and ecg.shape[0] != want[0]):
            raise ValueError(f"expected shape {want}, got {list(ecg.shape)}")
        ecg = ecg.to(self.device, torch.float32)
        with torch.inference_mode(), common.full_fp32():
            return self.program(ecg)


def load_serving(path: str, platform: Optional[str] = None
                 ) -> Tuple[ArtifactFn, Dict[str, Any]]:
    """Load an exported artifact: ``(serve, header)`` with ``serve`` an
    :class:`ArtifactFn` running one of its programs on that program's
    device. A one-platform artifact runs its platform's (the current CUDA
    device, or the CPU); a cross-platform one the program of the process's
    platform, the JAX package's current-backend rule: ``cuda`` where torch
    sees a card, else ``cpu``. ``platform`` picks one instead. An artifact
    without the platform raises ``ValueError``, a CUDA program where torch
    sees no card ``RuntimeError``. Needs the flash-attention operator
    registered (``ops/flash_attention.py``), none of the model code.
    Refuses a file that is not an artifact of this package (a JAX
    ``ECGSHLO1`` artifact included), a truncated one, and a corrupt
    header."""
    from .ops import flash_attention  # noqa: F401  registers the operator

    with open(path, "rb") as f:
        magic = f.read(len(_MAGIC))
        if magic != _MAGIC:
            raise ValueError(f"{path}: not a serving artifact "
                             f"(bad magic {magic!r})")
        raw_len = f.read(4)
        if len(raw_len) != 4:
            raise ValueError(f"{path}: truncated serving artifact")
        (hlen,) = struct.unpack("<I", raw_len)
        raw_header = f.read(hlen)
        blob = f.read()
        if len(raw_header) != hlen or not blob:
            raise ValueError(f"{path}: truncated serving artifact")
        try:
            header = json.loads(raw_header.decode("utf-8"))
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            raise ValueError(f"{path}: corrupt artifact header: {e}") from e
    programs = header.get("programs")
    if platform is None:
        platform = header["platforms"][0] if programs is None else (
            "cuda" if torch.cuda.is_available() else "cpu")
    if platform not in header["platforms"]:
        raise ValueError(f"{path}: the artifact holds programs for "
                         f"{header['platforms']}, none for {platform!r}")
    if platform == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{path}: a CUDA program, and torch sees no CUDA "
                           "device")
    if programs is not None:
        entry = next(e for e in programs if e["platform"] == platform)
        blob = blob[entry["offset"]:entry["offset"] + entry["length"]]
        if len(blob) != entry["length"]:
            raise ValueError(f"{path}: truncated serving artifact")
    program = torch.export.load(io.BytesIO(blob)).module()
    return ArtifactFn(program, header, torch.device(platform)), header


def make_http_server(artifact_path: str, host: str = "127.0.0.1",
                     port: int = 8000,
                     bucket_sizes: Sequence[int] = (16, 64, 256)):
    """An HTTP server over an exported artifact (``cli.py serve``).

    Endpoints:
    - ``GET /v1/metadata`` → the artifact header (JSON) + bucket sizes;
    - ``POST /v1/predict`` with an ``.npy``-serialized float32 array
      ``(B, leads, T)`` body → ``.npy`` softmax probabilities ``(B, C, T)``.

    A symbolic-batch artifact serves requests through
    :func:`serve_batched` (its ``bucket_sizes``), a pinned one at its own
    batch; one request at a time runs on the device (a lock), inside
    ``torch.cuda.device`` of the artifact's device; HTTP I/O is threaded.
    400 on a body that is not an ``.npy`` array of the input shape, 404 on
    an unknown path. Returns the server; call ``serve_forever()`` (and
    ``shutdown()``)."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    serve, header = load_serving(artifact_path)
    meta = json.dumps({**header, "bucket_sizes": list(bucket_sizes),
                       "endpoints": ["GET /v1/metadata",
                                     "POST /v1/predict"]}).encode()
    device_lock = threading.Lock()

    def on_device():
        return (torch.cuda.device(serve.device)
                if serve.device.type == "cuda" else contextlib.nullcontext())

    def run(x: np.ndarray) -> np.ndarray:
        return _numpy(serve(x))

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):  # quiet: stdout is the CLI's channel
            pass

        def _reply(self, code, body, ctype):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _error(self, code, msg):
            self._reply(code, json.dumps({"error": msg}).encode(),
                        "application/json")

        def do_GET(self):
            if self.path == "/v1/metadata":
                self._reply(200, meta, "application/json")
            else:
                self._error(404, f"unknown path {self.path}")

        def do_POST(self):
            if self.path != "/v1/predict":
                self._error(404, f"unknown path {self.path}")
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                x = np.load(io.BytesIO(self.rfile.read(length)),
                            allow_pickle=False)
                x = np.ascontiguousarray(x, np.float32)
            except (ValueError, TypeError, OSError, EOFError) as e:
                self._error(400, f"body must be a .npy array: {e}")
                return
            want = header["input_shape"]
            if (x.ndim != 3 or list(x.shape[1:]) != want[1:] or
                    (want[0] is not None and x.shape[0] != want[0])):
                self._error(400, f"expected shape {want}, got {list(x.shape)}")
                return
            with device_lock, on_device():
                if want[0] is not None:  # pinned batch: exact size, no pad
                    probs = run(x)
                else:
                    probs = serve_batched(run, x, bucket_sizes)
            buf = io.BytesIO()
            np.save(buf, probs, allow_pickle=False)
            self._reply(200, buf.getvalue(), "application/x-npy")

    return ThreadingHTTPServer((host, port), Handler)
