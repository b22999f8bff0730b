"""The time axis split over the seq ranks (counterpart of the JAX package's
``seq`` mesh axis: ``parallel/mesh.py``'s ``_array_sharding`` and GSPMD's
spatial partition of every 1-D convolution).

Under ``parallel.seq_parallel`` s > 1 the seq ranks of one data rank load
the same rows and each takes its block of the time axis
(:func:`split_batch`, the JAX package's split rule: a trailing axis that
divides by s and is at least ``MIN_TIME_DIM · s`` long; anything else stays
whole on every seq rank, with the JAX package's warning once per length).
A step on a split batch runs inside :func:`time_sharded`, and the model's
time-axis ops ask :func:`active` whether they hold a block or the whole.

Blocks. A tensor of global length L along time is split as
``[i·L // s, (i+1)·L // s)`` on seq rank i (:func:`block`), whatever layer
made it: each op computes its output blocks from the **global** lengths
(ResNet18 at 2,500 samples goes 1,250, 625, 313, 157, 79: odd from the
max pool on, so blocks differ by one and a strided window can straddle a
boundary). Each op works out the global input range every rank's output
block needs, fetches its halos (:func:`halo_parts`: the samples other
ranks hold, by point-to-point, zero or −inf outside ``[0, L)``, so padding
appears only at the global edges), and runs the whole-tensor op without
padding on the rank's samples joined with them, saving only the pieces
(so a rank's activations are its block's). The result is that op's output
on the block, the same arithmetic on the same values: in fp32 a split
forward equals the whole one bit for bit, and the backward (the fetch's
adjoint adds each halo's gradient back into its owners' blocks) is the
whole op's but for the order of the sums at the boundaries; a max pool's
tied window holds the same elements in the same order and routes its
gradient to the same one.

Reductions over time (the losses' means, the evaluators' counts) are
summed over the seq ranks (:func:`global_sum`, :func:`global_mean`: an
all-reduce forward, the identity backward), so each rank's gradient is its
part of the global loss's, and the replicated parameters' gradients are
summed over seq and averaged over data (``utils/optimizer.TrainOptimizer``).

The ops talk to the other seq ranks through a :class:`SeqComm` (the mesh's
seq group, point to point), or a :class:`ThreadComm` that runs s ranks as
threads of one process (:func:`run_threads` with :func:`seq_group`: the
tests, and the kernel ring held against the plain one on the card).

Three pieces serve what each rank computes alike: a ``replicated`` time
gather (:func:`gather_whole_time`) for a loss every rank computes from the
whole axis (ReCo's), whose backward keeps the rank's block of its own
gradient; :func:`broadcast_first` for the ViT's cls row, which seq rank 0
holds; and :func:`absmax`, an int8 input's absmax over the ranks that
split it.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.logging import log
from . import dist as pdist

# a trailing dim this short is a feature/stat axis, not a time axis (the
# JAX package's _MIN_TIME_DIM)
MIN_TIME_DIM = 32

# trailing lengths already warned about: a ragged time axis runs whole on
# every seq rank, which the user should hear once
_WARNED_RAGGED: set = set()


def block(length: int, size: int, rank: int) -> Tuple[int, int]:
    """``[a, b)``: seq rank ``rank``'s block of a global length."""
    return rank * length // size, (rank + 1) * length // size


class SeqComm:
    """The current mesh's seq group: ``size`` ranks, this one ``rank``, their
    global ranks ``ranks``."""

    def __init__(self, mesh):
        self.size, self.rank = mesh.seq, mesh.seq_rank
        self.ranks, self.group = mesh.seq_ranks, mesh.seq_group

    def exchange(self, sends: Dict[int, torch.Tensor],
                 recvs: Dict[int, Tuple[tuple, torch.dtype]],
                 device: torch.device) -> Dict[int, torch.Tensor]:
        """``sends[j]`` to seq rank j; from seq rank j a ``recvs[j] =
        (shape, dtype)`` tensor (``parallel.dist.exchange``)."""
        return pdist.exchange(sends, recvs, self.ranks, self.group, device)

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        return pdist.all_reduce_sum_(t, self.group)

    def all_reduce_max_(self, t: torch.Tensor) -> torch.Tensor:
        return pdist.all_reduce_max_(t, self.group)

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """``(size, *t.shape)``: every seq rank's ``t``."""
        return pdist._gather_tensor(t, self.group)


class ThreadComm:
    """A :class:`SeqComm` for ``size`` seq ranks run as threads of one
    process (:func:`run_threads`): the tensors pass through a shared
    mailbox between barriers. Autograd's backward of CUDA tensors runs on
    one device thread, so a rank's backward that waits for another's
    deadlocks there: call the ring's forward and backward functions
    directly on the card."""

    def __init__(self, shared, rank):
        self.shared, self.size, self.rank = shared, shared["size"], rank

    def _sync(self):
        self.shared["barrier"].wait()

    def exchange(self, sends, recvs, device):
        box = self.shared["box"]
        for j, t in sends.items():
            box[(self.rank, j)] = t.detach().clone()
        self._sync()
        out = {j: box[(j, self.rank)].to(device) for j in recvs}
        self._sync()
        for j in sends:
            del box[(self.rank, j)]
        self._sync()
        return out

    def all_gather(self, t):
        box = self.shared["box"]
        box[("gather", self.rank)] = t.detach().clone()
        self._sync()
        out = torch.stack([box[("gather", j)] for j in range(self.size)])
        self._sync()
        return out

    def all_reduce_(self, t):
        return t.copy_(self.all_gather(t).sum(0))

    def all_reduce_max_(self, t):
        return t.copy_(self.all_gather(t).amax(0))


def run_threads(size: int, fn: Callable[[ThreadComm], Any]) -> List[Any]:
    """``[fn(ThreadComm(rank)) for rank in range(size)]``, the ranks run as
    concurrent threads; an exception in one breaks the others' barriers
    and is raised. Inside ``fn``, :func:`seq_group` makes the thread's comm
    the seq group of the entries (``split_batch``, ``time_sharded``)."""
    shared = {"size": size, "box": {}, "barrier": threading.Barrier(size)}
    results, errors = [None] * size, []

    def go(rank):
        try:
            results[rank] = fn(ThreadComm(shared, rank))
        except BaseException as e:  # noqa: BLE001 - raised below
            errors.append(e)
            shared["barrier"].abort()

    threads = [threading.Thread(target=go, args=(r,)) for r in range(size)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return results


@dataclass(frozen=True)
class TimeShard:
    """A step whose batch holds a block of a global time axis of
    ``length`` samples on each of the ``comm``'s ranks."""

    length: int
    comm: Any

    @property
    def size(self) -> int:
        return self.comm.size

    @property
    def rank(self) -> int:
        return self.comm.rank

    def block(self, length: int) -> Tuple[int, int]:
        return block(length, self.size, self.rank)

    def blocks(self, length: int) -> List[Tuple[int, int]]:
        return [block(length, self.size, j) for j in range(self.size)]


_ACTIVE: contextvars.ContextVar = contextvars.ContextVar("time_shard",
                                                         default=None)


def active() -> Optional[TimeShard]:
    """The :class:`TimeShard` of the step in progress, or None (the time
    axis whole)."""
    return _ACTIVE.get()


@contextlib.contextmanager
def using(shard: Optional[TimeShard]):
    """Inside, :func:`active` is ``shard`` (None: the time axis whole)."""
    token = _ACTIVE.set(shard)
    try:
        yield shard
    finally:
        _ACTIVE.reset(token)


_COMMS: Dict[int, SeqComm] = {}

# the seq group that split_batch and time_sharded take in place of the
# mesh's (seq_group: the ranks of run_threads)
_GROUP: contextvars.ContextVar = contextvars.ContextVar("seq_group",
                                                        default=None)


@contextlib.contextmanager
def seq_group(comm):
    """Inside, :func:`split_batch` and :func:`time_sharded` split over
    ``comm`` (a :class:`ThreadComm`: the seq ranks as threads of one
    process) instead of the current mesh's seq group."""
    token = _GROUP.set(comm)
    try:
        yield comm
    finally:
        _GROUP.reset(token)


def _mesh_comm(mesh) -> SeqComm:
    comm = _COMMS.get(id(mesh))
    if comm is None or comm.group is not mesh.seq_group:
        comm = _COMMS[id(mesh)] = SeqComm(mesh)
    return comm


def time_sharded(length: Optional[int], comm=None):
    """The context of a step on a batch split by :func:`split_batch`
    (``length`` its global time length; None: not split, nothing to do).
    ``comm`` defaults to the current mesh's seq group."""
    if length is None:
        return using(None)
    if comm is None:
        comm = _GROUP.get() or _mesh_comm(pdist.current_mesh())
    return using(TimeShard(int(length), comm))


def splits_time(shape: Sequence[int], size: int, base: int = 1) -> bool:
    """Whether an array of ``shape`` takes the seq axis on its trailing
    (time) dim: the JAX package's ``_array_sharding`` for ``base`` leading
    (batch) dims. A long trailing dim that does not divide warns once per
    length and stays whole."""
    ndim = len(shape)
    if size <= 1 or ndim <= base:
        return False
    t = shape[-1]
    if t < MIN_TIME_DIM * size:
        return False
    if t % size == 0:
        return True
    if t not in _WARNED_RAGGED:
        _WARNED_RAGGED.add(t)
        log(f"seq_parallel={size} requested but trailing time dim {t} is "
            "not divisible by it — this array stays seq-REPLICATED (full "
            "per-sample footprint on every seq rank). Pad/crop the signal "
            "length to a multiple of seq_parallel to get the memory "
            "saving.", force=True)
    return False


def split_batch(batch: Dict[str, Any], size: Optional[int] = None,
                rank: Optional[int] = None):
    """``(batch, length)``: this seq rank's block of the time axis of every
    array of ``batch`` that :func:`splits_time` takes, and the global time
    length; None and the batch as it is when no array is split (or when
    they would be split at two lengths: a step has one time axis)."""
    if size is None:
        mesh, comm = pdist.current_mesh(), _GROUP.get()
        size, rank = ((comm.size, comm.rank) if comm is not None else
                      (1, 0) if mesh is None else (mesh.seq, mesh.seq_rank))
    if size <= 1:
        return batch, None
    split = {k: v for k, v in batch.items()
             if splits_time(tuple(v.shape), size)}
    lengths = {v.shape[-1] for v in split.values()}
    if len(lengths) != 1:
        return batch, None
    (length,) = lengths
    a, b = block(length, size, rank)
    return ({k: v[..., a:b] if k in split else v
             for k, v in batch.items()}, length)


# ---------------------------------------------------------------------------
# Fetching a global range of a split tensor
# ---------------------------------------------------------------------------


def _overlap(a: int, b: int, c: int, d: int) -> Tuple[int, int]:
    return max(a, c), min(b, d)


def _split(a: int, b: int, own_a: int, own_b: int) -> Tuple[int, int]:
    """``[m0, m1)``: the part of the range ``[a, b)`` that this rank's block
    ``[own_a, own_b)`` holds; ``[a, m0)`` and ``[m1, b)`` are its halos."""
    m0 = min(max(own_a, a), b)
    return m0, min(max(own_b, m0), b)


def _fetch_halos(x: torch.Tensor, comm, length: int,
                 ranges: Sequence[Tuple[int, int]], fill: float):
    """The halos ``(left, right)`` of this rank's ``ranges[rank]`` of the
    global time axis (last dim) of the split ``x``: the samples other
    ranks hold, ``fill`` outside ``[0, length)``."""
    r, s = comm.rank, comm.size
    own_a, own_b = block(length, s, r)
    a, b = ranges[r]
    m0, m1 = _split(a, b, own_a, own_b)
    lead = tuple(x.shape[:-1])
    left = x.new_full(lead + (m0 - a,), fill)
    right = x.new_full(lead + (b - m1,), fill)
    sends, recvs = {}, {}
    for j in range(s):
        if j == r:
            continue
        lo, hi = _overlap(*ranges[j], own_a, own_b)
        if lo < hi:
            sends[j] = x[..., lo - own_a:hi - own_a]
        lo, hi = _overlap(a, b, *block(length, s, j))
        if lo < hi:
            recvs[j] = (lead + (hi - lo,), x.dtype)
    for j, t in comm.exchange(sends, recvs, x.device).items():
        lo, hi = _overlap(a, b, *block(length, s, j))
        if lo < m0:
            left[..., lo - a:hi - a] = t
        else:
            right[..., lo - m1:hi - m1] = t
    return left, right


def _fetch_halos_adjoint(g_left: torch.Tensor, g_right: torch.Tensor, comm,
                         length: int, ranges: Sequence[Tuple[int, int]],
                         local: int) -> torch.Tensor:
    """The adjoint of :func:`_fetch_halos`: each halo sample's gradient
    added into its owner's block (the fill's gradient dropped)."""
    r, s = comm.rank, comm.size
    own_a, own_b = block(length, s, r)
    a, b = ranges[r]
    m0, m1 = _split(a, b, own_a, own_b)
    lead = tuple(g_left.shape[:-1])
    gx = g_left.new_zeros(lead + (local,))
    sends, recvs = {}, {}
    for j in range(s):
        if j == r:
            continue
        lo, hi = _overlap(a, b, *block(length, s, j))
        if lo < hi:
            sends[j] = (g_left[..., lo - a:hi - a] if lo < m0
                        else g_right[..., lo - m1:hi - m1])
        lo, hi = _overlap(*ranges[j], own_a, own_b)
        if lo < hi:
            recvs[j] = (lead + (hi - lo,), g_left.dtype)
    for j, t in comm.exchange(sends, recvs, g_left.device).items():
        lo, hi = _overlap(*ranges[j], own_a, own_b)
        gx[..., lo - own_a:hi - own_a] += t
    return gx


class _FetchHalos(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, length, ranges, fill):
        ctx.comm, ctx.length, ctx.ranges = comm, length, ranges
        ctx.local = x.shape[-1]
        return _fetch_halos(x, comm, length, ranges, fill)

    @staticmethod
    def backward(ctx, g_left, g_right):
        return (_fetch_halos_adjoint(g_left.contiguous(),
                                     g_right.contiguous(), ctx.comm,
                                     ctx.length, ctx.ranges, ctx.local),
                None, None, None, None)


def halo_parts(x: torch.Tensor, length: int,
               ranges: Sequence[Tuple[int, int]], fill: float = 0.0,
               shard: Optional[TimeShard] = None):
    """``(left, mid, right)``: samples ``[a, b) = ranges[rank]`` of the
    global time axis (the last dim, ``length`` samples, split by
    :func:`block`) of ``x``, this rank's block, in three pieces: the halo
    before this rank's samples, the view of them ``x`` holds, the halo
    after. ``ranges`` names every seq rank's range, since each rank sends
    the others what they ask of its block. Samples outside ``[0,
    length)`` are ``fill``. Differentiable: the backward sends each halo's
    gradient back to the ranks that own it, which add it into their
    blocks."""
    shard = shard or active()
    ranges = tuple((int(a), int(b)) for a, b in ranges)
    left, right = _FetchHalos.apply(x, shard.comm, int(length), ranges,
                                    float(fill))
    own_a, own_b = shard.block(length)
    m0, m1 = _split(*ranges[shard.rank], own_a, own_b)
    return left, x[..., m0 - own_a:m1 - own_a], right


def fetch_time_range(x: torch.Tensor, length: int,
                     ranges: Sequence[Tuple[int, int]], fill: float = 0.0,
                     shard: Optional[TimeShard] = None) -> torch.Tensor:
    """:func:`halo_parts` joined: ``x_global[..., a:b]`` for this rank's
    ``[a, b) = ranges[rank]``, differentiable."""
    return torch.cat(halo_parts(x, length, ranges, fill, shard), dim=-1)


# ---------------------------------------------------------------------------
# The time-axis ops
# ---------------------------------------------------------------------------
#
# Each op runs on ``cat(left, mid, right)`` and saves only the pieces: the
# mid is a view of a tensor its producer keeps anyway and the halos are a
# few samples, so the joined copy lives in the forward (and again in the
# backward) alone, and a rank's activations are its block's.


def _autocast_dtype(t: torch.Tensor):
    """The dtype autocast runs a convolution in here, or None."""
    dev = t.device.type
    return (torch.get_autocast_dtype(dev)
            if torch.is_autocast_enabled(dev) else None)


class _HaloConv(torch.autograd.Function):
    """``F.conv1d(cat(left, mid, right), weight, bias, stride, 0,
    dilation)`` in autocast's dtype when autocast is on (as autocast runs
    ``F.conv1d``), its backward ``aten.convolution_backward`` on the joined
    input rebuilt from the saved pieces."""

    @staticmethod
    def forward(ctx, left, mid, right, weight, bias, stride, dilation):
        dt = _autocast_dtype(mid)
        with torch.autocast(mid.device.type, enabled=False):
            xin = torch.cat([left, mid, right], dim=-1)
            w, b = weight, bias
            if dt is not None:
                xin, w = xin.to(dt), w.to(dt)
                b = None if b is None else b.to(dt)
            y = F.conv1d(xin, w, b, stride, 0, dilation)
        ctx.save_for_backward(left, mid, right, weight)
        ctx.conf = (dt, stride, dilation, None if bias is None else (
            bias.shape[0], bias.dtype))
        return y

    @staticmethod
    def backward(ctx, grad):
        left, mid, right, weight = ctx.saved_tensors
        dt, stride, dilation, bias = ctx.conf
        xin = torch.cat([left, mid, right], dim=-1)
        w = weight
        if dt is not None:
            xin, w = xin.to(dt), w.to(dt)
        g_in, g_w, g_b = torch.ops.aten.convolution_backward(
            grad.to(xin.dtype), xin, w,
            None if bias is None else [bias[0]], [stride], [0],
            [dilation], False, [0], 1,
            [True, ctx.needs_input_grad[3], bias is not None])
        g_in = g_in.to(mid.dtype)
        n0, n1 = left.shape[-1], left.shape[-1] + mid.shape[-1]
        return (g_in[..., :n0], g_in[..., n0:n1], g_in[..., n1:],
                None if g_w is None else g_w.to(weight.dtype),
                None if bias is None else g_b.to(bias[1]), None, None)


class _HaloMaxPool(torch.autograd.Function):
    """``F.max_pool1d(cat(left, mid, right), kernel, stride)``, its
    backward a scatter-add to the saved argmax indices (the same element of
    a tied window as the whole-tensor pool picks)."""

    @staticmethod
    def forward(ctx, left, mid, right, kernel, stride):
        y, idx = F.max_pool1d(torch.cat([left, mid, right], dim=-1), kernel,
                              stride, return_indices=True)
        ctx.save_for_backward(idx)
        ctx.widths = (left.shape[-1], mid.shape[-1], right.shape[-1])
        return y

    @staticmethod
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        n0, n1, n2 = ctx.widths
        g_in = grad.new_zeros(grad.shape[:-1] + (n0 + n1 + n2,))
        g_in.scatter_add_(-1, idx, grad)
        return (g_in[..., :n0], g_in[..., n0:n0 + n1], g_in[..., n0 + n1:],
                None, None)


class _HaloAvgPool(torch.autograd.Function):
    """``F.avg_pool1d(cat(left, mid, right), kernel, stride, ceil_mode=True,
    count_include_pad=False)``; the backward needs the shape alone."""

    @staticmethod
    def forward(ctx, left, mid, right, kernel, stride):
        ctx.conf = (kernel, stride, left.shape[-1], mid.shape[-1],
                    right.shape[-1])
        return F.avg_pool1d(torch.cat([left, mid, right], dim=-1), kernel,
                            stride, ceil_mode=True, count_include_pad=False)

    @staticmethod
    def backward(ctx, grad):
        kernel, stride, n0, n1, n2 = ctx.conf
        with torch.enable_grad():
            x = grad.new_zeros(grad.shape[:-1] + (n0 + n1 + n2,),
                               requires_grad=True)
            y = F.avg_pool1d(x, kernel, stride, ceil_mode=True,
                             count_include_pad=False)
            (g_in,) = torch.autograd.grad(y, x, grad)
        return (g_in[..., :n0], g_in[..., n0:n0 + n1], g_in[..., n0 + n1:],
                None, None)


def _out_blocks(shard: TimeShard, out_len: int, what: str):
    blocks = shard.blocks(out_len)
    if any(b <= a for a, b in blocks):
        raise ValueError(
            f"{what}: an output of {out_len} samples leaves a seq rank of "
            f"{shard.size} without any; use a longer signal or a smaller "
            "seq_parallel")
    return blocks


def conv_out_length(length: int, kernel: int, stride: int = 1,
                    padding: int = 0, dilation: int = 1) -> int:
    return (length + 2 * padding - dilation * (kernel - 1) - 1) // stride + 1


def conv_ranges(shard: TimeShard, length: int, kernel: int, stride: int = 1,
                padding: int = 0, dilation: int = 1):
    """``(out_length, ranges)`` of a convolution over a split time axis of
    ``length`` samples: every seq rank's global input range for its block
    of the output (reaching past ``[0, length)`` where the padding is)."""
    out_len = conv_out_length(length, kernel, stride, padding, dilation)
    span = dilation * (kernel - 1) + 1
    return out_len, [(a * stride - padding, (b - 1) * stride - padding + span)
                     for a, b in _out_blocks(shard, out_len, "conv1d")]


def conv1d(x: torch.Tensor, length: int, weight: torch.Tensor,
           bias: Optional[torch.Tensor] = None, stride: int = 1,
           padding: int = 0, dilation: int = 1,
           shard: Optional[TimeShard] = None) -> Tuple[torch.Tensor, int]:
    """``(y, out_length)``: this rank's block of ``F.conv1d`` over the
    global time axis of ``x`` (``length`` samples), zero padding at the
    global edges only."""
    shard = shard or active()
    out_len, ranges = conv_ranges(shard, length, weight.shape[-1], stride,
                                  padding, dilation)
    parts = halo_parts(x, length, ranges, 0.0, shard)
    return _HaloConv.apply(*parts, weight, bias, stride, dilation), out_len


def conv_module(conv: torch.nn.Conv1d, x: torch.Tensor, length: int,
                shard: Optional[TimeShard] = None
                ) -> Tuple[torch.Tensor, int]:
    """:func:`conv1d` with an ``nn.Conv1d``'s parameters; an int8
    convolution (``models/quant_layers.Int8Conv1d``) runs its own
    ``split_forward`` (quantized before its halos are fetched)."""
    shard = shard or active()
    if hasattr(conv, "split_forward"):
        return conv.split_forward(x, length, shard)
    (stride,), (dilation,) = conv.stride, conv.dilation
    (padding,) = conv.padding
    return conv1d(x, length, conv.weight, conv.bias, stride, padding,
                  dilation, shard)


def max_pool1d(x: torch.Tensor, length: int, kernel: int, stride: int,
               padding: int = 0, shard: Optional[TimeShard] = None
               ) -> Tuple[torch.Tensor, int]:
    """``(y, out_length)``: this rank's block of ``F.max_pool1d``
    (floor mode), −inf padding at the global edges only."""
    shard = shard or active()
    out_len = (length + 2 * padding - kernel) // stride + 1
    ranges = [(a * stride - padding, (b - 1) * stride - padding + kernel)
              for a, b in _out_blocks(shard, out_len, "max_pool1d")]
    parts = halo_parts(x, length, ranges, float("-inf"), shard)
    return _HaloMaxPool.apply(*parts, kernel, stride), out_len


def avg_pool1d(x: torch.Tensor, length: int, kernel: int, stride: int,
               shard: Optional[TimeShard] = None
               ) -> Tuple[torch.Tensor, int]:
    """``(y, out_length)``: this rank's block of ``F.avg_pool1d`` with
    ``ceil_mode=True``, ``count_include_pad=False`` and no padding (the
    ResNet's ``avg_down``): a last window past the end averages the
    samples it holds."""
    shard = shard or active()
    out_len = -(-(length - kernel) // stride) + 1
    if (out_len - 1) * stride >= length:
        out_len -= 1
    ranges = [(a * stride, min((b - 1) * stride + kernel, length))
              for a, b in _out_blocks(shard, out_len, "avg_pool1d")]
    parts = halo_parts(x, length, ranges, 0.0, shard)
    return _HaloAvgPool.apply(*parts, kernel, stride), out_len


def linear_interpolate(x: torch.Tensor, length: int, size: int,
                       align_corners: bool = False,
                       shard: Optional[TimeShard] = None) -> torch.Tensor:
    """This rank's block of ``ops.interpolate.linear_interpolate(x_global,
    size)`` over the last dim: the taps of the global lengths, the source
    range the block's taps reach fetched, the same two-tap arithmetic."""
    from ..ops.interpolate import _interp_coords

    if length == size:
        return x
    shard = shard or active()
    lo, hi, w_lo, w_hi = _interp_coords(length, size, align_corners)
    blocks = _out_blocks(shard, size, "linear_interpolate")
    ranges = [(int(lo[a]), int(hi[b - 1]) + 1) for a, b in blocks]
    xin = fetch_time_range(x, length, ranges, 0.0, shard)
    a, b = blocks[shard.rank]
    start = ranges[shard.rank][0]
    if torch.compiler.is_compiling():
        # a trace holds its own constants (ops/interpolate.py)
        lo_t, hi_t, w_lo_t, w_hi_t = (torch.from_numpy(t).to(x.device)
                                      for t in _block_taps(
                                          length, size, align_corners, a,
                                          b, start))
    else:
        lo_t, hi_t, w_lo_t, w_hi_t = _device_block_taps(
            length, size, align_corners, a, b, start, x.device)
    return (xin.index_select(-1, lo_t) * w_lo_t.to(x.dtype)
            + xin.index_select(-1, hi_t) * w_hi_t.to(x.dtype))


def _block_taps(length: int, size: int, align_corners: bool, a: int, b: int,
                start: int):
    """The taps of output samples ``[a, b)`` of a resize from ``length`` to
    ``size``, their indices relative to ``start``."""
    from ..ops.interpolate import _interp_coords

    lo, hi, w_lo, w_hi = _interp_coords(length, size, align_corners)
    return lo[a:b] - start, hi[a:b] - start, w_lo[a:b], w_hi[a:b]


@functools.lru_cache(maxsize=64)
def _device_block_taps(length: int, size: int, align_corners: bool, a: int,
                       b: int, start: int, device: torch.device):
    """:func:`_block_taps` on ``device``, uploaded once: a step copies
    nothing from the host, as a CUDA graph capture needs."""
    with torch.inference_mode(False):
        return tuple(torch.from_numpy(np.ascontiguousarray(t)).to(device)
                     for t in _block_taps(length, size, align_corners, a,
                                          b, start))


# ---------------------------------------------------------------------------
# Reductions and gathers over the seq ranks
# ---------------------------------------------------------------------------


class _SeqSum(torch.autograd.Function):
    """The sum over the seq ranks forward, the identity backward: each
    rank's part of a global sum."""

    @staticmethod
    def forward(ctx, t, comm):
        out = t.detach().clone().contiguous()
        comm.all_reduce_(out)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def global_sum(t: torch.Tensor,
               shard: Optional[TimeShard] = None) -> torch.Tensor:
    """``t.sum()`` of a time-split tensor over the global time axis (the
    whole ``t.sum()`` without a shard)."""
    shard = shard or active()
    if shard is None:
        return t.sum()
    return _SeqSum.apply(t.sum(), shard.comm)


def global_mean(t: torch.Tensor,
                shard: Optional[TimeShard] = None) -> torch.Tensor:
    """``t.mean()`` over the global array: ``t``'s last dim is the step's
    input time axis, split in equal blocks."""
    shard = shard or active()
    if shard is None:
        return t.mean()
    count = t.numel() // t.shape[-1] * shard.length
    return global_sum(t, shard) / count


def time_mean(t: torch.Tensor,
              shard: Optional[TimeShard] = None) -> torch.Tensor:
    """The mean over the (split) last dim, per leading index."""
    shard = shard or active()
    if shard is None:
        return t.mean(dim=-1)
    return _SeqSum.apply(t.sum(dim=-1), shard.comm) / shard.length


def sum_counts(t: torch.Tensor,
               shard: Optional[TimeShard] = None) -> torch.Tensor:
    """Counts taken on each rank's block, summed over the seq ranks (no
    gradient)."""
    shard = shard or active()
    if shard is None:
        return t
    return shard.comm.all_reduce_(t.contiguous().clone())


class _GatherTime(torch.autograd.Function):
    """Every rank's block along ``dim``, concatenated in rank order; the
    backward sums the whole gradient over the ranks and keeps this rank's
    block (every rank's loss reaches every block)."""

    @staticmethod
    def forward(ctx, x, comm, dim, counts):
        ctx.comm, ctx.dim, ctx.counts = comm, dim, counts
        width = max(counts)
        pad = list(x.shape)
        pad[dim] = width - x.shape[dim]
        xp = torch.cat([x, x.new_zeros(pad)], dim) if pad[dim] else x
        stacked = comm.all_gather(xp.contiguous())
        return torch.cat([stacked[j].narrow(dim, 0, c)
                          for j, c in enumerate(counts)], dim)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        ctx.comm.all_reduce_(grad)
        start = sum(ctx.counts[:ctx.comm.rank])
        return (grad.narrow(ctx.dim, start, ctx.counts[ctx.comm.rank]),
                None, None, None)


class _GatherReplicated(_GatherTime):
    """:class:`_GatherTime` for a loss that every seq rank computes alike
    from the gathered whole: the backward keeps this rank's block of the
    (same) gradient without summing it over the ranks, so the gradient
    all-reduce's sum over seq counts the loss once, not s times."""

    @staticmethod
    def backward(ctx, grad):
        start = sum(ctx.counts[:ctx.comm.rank])
        return (grad.narrow(ctx.dim, start, ctx.counts[ctx.comm.rank]),
                None, None, None)


def gather_time(x: torch.Tensor, counts: Sequence[int], dim: int = -1,
                shard: Optional[TimeShard] = None,
                replicated: bool = False) -> torch.Tensor:
    """The whole axis ``dim`` of a split ``x`` whose seq rank j holds
    ``counts[j]`` entries of it, differentiable. By default each rank's
    loss of the result is its own part of the global loss, and the
    backward sums the ranks' gradients; ``replicated``: every rank computes
    the same loss from the whole (ReCo's contrastive term), and the
    backward keeps the rank's block of its own gradient."""
    shard = shard or active()
    dim %= x.dim()
    fn = _GatherReplicated if replicated else _GatherTime
    return fn.apply(x, shard.comm, dim, tuple(int(c) for c in counts))


def gather_whole_time(x: torch.Tensor,
                      shard: Optional[TimeShard] = None,
                      replicated: bool = False) -> torch.Tensor:
    """:func:`gather_time` of the last dim of ``x``, split in the blocks of
    the step's input time axis (the resized logits, probabilities and
    latents); ``x`` as it is without a shard."""
    shard = shard or active()
    if shard is None:
        return x
    counts = [b - a for a, b in shard.blocks(shard.length)]
    return gather_time(x, counts, -1, shard, replicated)


class _BroadcastFirst(torch.autograd.Function):
    """Seq rank 0's tensor on every seq rank; the backward sums the ranks'
    gradients onto rank 0 (the others' input is a placeholder)."""

    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        out = (x.detach().clone() if comm.rank == 0
               else torch.zeros_like(x)).contiguous()
        return comm.all_reduce_(out)

    @staticmethod
    def backward(ctx, grad):
        grad = ctx.comm.all_reduce_(grad.contiguous().clone())
        return (grad if ctx.comm.rank == 0 else None), None


def broadcast_first(x: torch.Tensor,
                    shard: Optional[TimeShard] = None) -> torch.Tensor:
    """Seq rank 0's ``x`` on every seq rank, differentiable (the ViT's cls
    token, which rank 0 holds; every other rank passes a tensor of its
    shape)."""
    shard = shard or active()
    return _BroadcastFirst.apply(x, shard.comm)


def absmax(t: torch.Tensor, model_group=None,
           shard: Optional[TimeShard] = None) -> torch.Tensor:
    """``t.abs().amax()`` of the global tensor whose pieces the seq ranks
    (under a split time axis) and the ranks of ``model_group`` (a sliced
    feature axis) hold: the local absmax, its maximum over those groups
    (exact). int8 serving's per-tensor activation scale."""
    m = t.detach().abs().amax().float()
    shard = shard or active()
    if shard is not None:
        shard.comm.all_reduce_max_(m)
    if model_group is not None:
        pdist.all_reduce_max_(m, model_group)
    return m


def sharded_call(fn: Callable[[torch.Tensor], torch.Tensor],
                 x: torch.Tensor) -> torch.Tensor:
    """``fn(x)`` for a ``(B, C, T)`` input whose ``(B, C', T)`` output keeps
    the time axis, run on this seq rank's block of ``x`` inside
    :func:`time_sharded` and gathered whole (the test and inference
    entries' forwards); ``fn(x)`` where the time axis is not split."""
    local, length = split_batch({"x": x})
    if length is None:
        return fn(x)
    with time_sharded(length):
        return gather_whole_time(fn(local["x"]))
