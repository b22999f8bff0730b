"""``train.scan_steps``: K train steps a dispatch, as replays of CUDA
graphs of the step (counterpart of the JAX package's ``jax.lax.scan`` of
its jitted step, ``semi_seg_ecg_tpu/algorithms/common.py``).

With ``train.scan_steps`` K > 1 the training loop groups K host batches
into one unit: stacked and uploaded with one pinned copy a key
(:func:`stacked_units`), the counterpart of ``np.stack`` and
``shard_stacked_batch``; the epoch's tail, shorter than K, goes one step a
unit. Each inner step's metrics reach the log, the lr and the abort on a
non-finite loss as with K = 1.

On a card, :class:`CapturedStep` takes ``Trainer.train_step``'s device
work (the cache's ``materialize``, the augmentation, the algorithm's step:
forwards, losses, backward, the gradients' all-reduce over the process
group, clip, optimizer update, EMA or peer update; every kernel of the
port inside) into CUDA graphs (``torch.cuda.CUDAGraph``) and replays one
a step. The
port seeds every step's draws on the host (``Trainer.reseed``) and torch
refuses ``manual_seed`` while capturing, so one step is captured and
replayed K times, not K steps captured once: before each replay the host
copies the step's slice of the unit into the graphs' static input,
reseeds the trainer's generators (registered with every graph, so the
reseed takes effect in the replay) and, before the graph that holds an
update, writes each optimizer group's lr into its device tensor
(``TrainOptimizer.write_lr``);
after it, the step's metrics are copied out of the graph's output, which
the next replay overwrites. The host counters (the trainer's step, each
optimizer's update count and micro-step) advance as in an eager step.

Gradient accumulation (``train.accum_iter`` k > 1, ``optax.MultiSteps``
in the JAX package): a window's micro-steps are of two kinds, so there
are two graphs, captured into one memory pool: the accumulating one
(forward and backward into the window's gradients) and the updating one
(the same, then divide, all-reduce, clip, update, the EMA teacher's or
the peer's update, and the gradients zeroed in place for the next
window). Before each replay the host picks the graph from the
optimizers' ``micro_step``, so a window may span units, an epoch's tail
and epochs. The window's gradients are fixed tensors both graphs share:
the eager warm-up makes them, and a parameter without one keeps none
(``TrainOptimizer.make_capturable_``). With k = 1 the updating graph is
the only one, and the capture sets every ``.grad`` to None at its start,
as each step does, so the backward allocates the gradients from the
graph's pool and each replay rewrites them in place (under
``debug.nan_checks``, below, they are fixed tensors at k = 1 too).

Under a process group (NCCL: data, ZeRO-1, seq and model ranks) the
step's collectives are captured with it: the gradient all-reduce, the
BatchNorm statistics' and ReCo's all-gathers, ZeRO-1's and the model
axis's broadcasts, the model axis's activation all-reduces and the seq
axis's point-to-point halos and ring hops. Every rank warms up, captures
and replays in the same order, since each follows the same counters. An
epoch's end (the open window's mean over the ranks,
``TrainOptimizer.average_window_``), the evaluation and the checkpoint's
gathers run eagerly between replays, on the communicators the graphs
captured (NCCL lets captured and eager calls share one).

The warm-up is eager and real: the run's steps up to and including its
first update (the first step when k = 1; a resumed run with an open
window finishes it). It makes the optimizers' lazy state (AdamW's
moments, SGD's momentum), gives every process group the step uses its
NCCL communicator (none may be created inside a capture), decides once
which gradients the seq ranks' all-reduce takes (``parallel.dist.
all_reduce_grads_``; its host sync cannot be captured), builds the
kernels (``ops/cuda_build.py``), fills the allocator and records where
each remat block's forward found its generators (``models/remat.py``).
Before it the optimizers become capturable
(``TrainOptimizer.make_capturable_``: the lr a device tensor, AdamW's
step count on the device, SGD's fused update). Each capture runs with the
optimizers' ``micro_step`` set to the position its graph stands for, and
the host counters restored after it. Autocast runs with its cast cache
off (``Trainer.amp``), as capture needs.

``debug.nan_checks`` (``utils/nan_checks.py``, the JAX package's
``jax_debug_nans``, which checks every jitted call's outputs, the scanned
steps' included): autograd's anomaly mode checks every backward op on the
host, which a capture cannot hold, so the warm-up runs under it and the
captures and replays without it, and the checks are in the graphs. A
step's capture ends at the entry of its first optimizer step (after every
backward, CPS's two included, before the ranks' all-reduce and the
update: ``Trainer._check_grads``) with a NaN flag a gradient, MAX-reduced
over every rank inside the graph (:meth:`CapturedStep.split`), and the rest
of the step (the update, the EMA teacher, the metrics, and the metrics'
own flags) is captured into the next graph; the window's gradients, which
live across the two, are fixed tensors at every ``accum_iter``. A replay
runs the first graph and reads its flags (one host sync); when they are
clear it runs the second and reads the metrics' flags before it returns
them. When they are set the update is not applied: every rank runs the
same step again eagerly (the same batch and reseed; in one process under
anomaly mode, under a group with ``nan_checks.BackwardNans``), as
``jax_debug_nans`` reruns a jitted call de-optimised, which raises
``FloatingPointError`` at the backward op that returns the NaN, or,
when none does, naming the flagged gradients. No step after the warm-up
runs eagerly unless a flag is set.

No fallback: a capture or a replay that fails raises, and on a card K > 1
runs no step eagerly but the warm-up (and a flagged step's rerun). On the
CPU nothing is captured: a unit runs its K steps eagerly (the plain
version the tests hold against K = 1), under any process group and
``accum_iter``, with ``debug.nan_checks``' eager checks. Refused, with the
reason (:func:`check_scan_steps`): a gloo process group with CUDA tensors
(its collectives are host calls a graph cannot hold, and running the
steps eagerly instead would be a hidden fallback).

:meth:`CapturedStep.kernel_names_of` lists a graph's kernel nodes: the
ported kernels' host counters (``ops/flash_attention.LAUNCHES``, ...)
count at each capture and never at a replay, so a run's launches are read
from the graphs themselves.
"""

from __future__ import annotations

import os
import re
import tempfile
from typing import Any, Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..models import remat
from ..parallel import dist as pdist
from . import nan_checks

def scan_steps(config: Dict[str, Any]) -> int:
    """``train.scan_steps``, at least 1."""
    return max(int(config["train"].get("scan_steps", 1) or 1), 1)


def check_scan_steps(config: Dict[str, Any],
                     device: Optional[torch.device] = None) -> int:
    """:func:`scan_steps`, or a ``ValueError`` with the reason when a run on
    ``device`` (unset: the CPU) cannot take K > 1: under a gloo process
    group with CUDA tensors. ``debug.nan_checks`` takes K > 1: the
    captured step splits at its gradients' NaN flags and reruns a flagged
    step eagerly under anomaly mode (the module docstring)."""
    k = scan_steps(config)
    backend = pdist.backend()
    if k > 1 and device is not None and device.type == "cuda" and \
            backend not in (None, "nccl"):
        raise ValueError(
            f"train.scan_steps: {k} is refused under a {backend} process "
            f"group of {pdist.get_world_size()} ranks with CUDA tensors: "
            "its collectives are host calls a CUDA graph cannot hold, and "
            "taking the steps eagerly instead would be a hidden fallback "
            "(NCCL's are captured)")
    return k


def stacked_units(batches: Iterable[Dict[str, np.ndarray]],
                  k: int) -> Iterator[Dict[str, np.ndarray]]:
    """Host batches in units: ``k`` batches stacked on a new leading axis,
    then the tail shorter than ``k`` one batch a unit (leading axis 1). A
    unit of one batch (``k`` = 1, the tail) is a view of it, not a copy."""
    buf: List[Dict[str, np.ndarray]] = []
    for b in batches:
        buf.append(b)
        if len(buf) == k:
            yield _unit(buf)
            buf = []
    for b in buf:
        yield _unit([b])


def _unit(buf: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    if len(buf) == 1:
        return {key: np.asarray(v)[None] for key, v in buf[0].items()}
    return {key: np.stack([x[key] for x in buf]) for key in buf[0]}


def unit_steps(unit: Dict[str, torch.Tensor]) -> int:
    """The number of steps a unit of :func:`stacked_units` holds."""
    return next(iter(unit.values())).shape[0]


def unit_slice(unit: Dict[str, torch.Tensor], j: int
               ) -> Dict[str, torch.Tensor]:
    """Step ``j``'s batch of a unit (views)."""
    return {key: v[j] for key, v in unit.items()}


# the two kinds of micro-step, each a graph: one that accumulates into the
# window's gradients, one that ends the window with the update
KINDS = ("accumulate", "update")


class CapturedStep:
    """One trainer's step, warmed up and captured once its first update has
    been applied, then replayed at every call (see the module docstring).
    ``trainer`` is an ``algorithms.common.Trainer`` on a CUDA device; with
    ``keep_graph`` the graphs keep their nodes for :meth:`kernel_names_of` (a
    caller that counts launches puts one in ``trainer.captured`` before
    the first step)."""

    def __init__(self, trainer, keep_graph: bool = False):
        if trainer.device.type != "cuda":
            raise ValueError("a captured step needs a CUDA device, not "
                             f"{trainer.device}")
        self.trainer = trainer
        self.keep_graph = keep_graph
        self.optimizers = trainer.optimizers
        # by KINDS, a step's graphs in order, each with the NaN flags
        # (debug.nan_checks) its replay leaves: the gradients' at a split,
        # the metrics' after the last (without the checks: one graph, None)
        self.graphs: Dict[str, List[Tuple[torch.cuda.CUDAGraph,
                                          Optional[torch.Tensor]]]] = {}
        self.static_in: Dict[str, torch.Tensor] = {}
        self.static_out: Dict[str, torch.Tensor] = {}
        self.keys: List[str] = []
        self.remat_calls: List = []  # remat.RematCall of the captured step
        self.warm_up_steps = 0
        self.replays_by_kind = {kind: 0 for kind in KINDS}
        self.reruns = 0  # eager reruns of a step whose flags were set
        self._pool = None
        self._open: Optional[torch.cuda.CUDAGraph] = None  # capturing
        self._segments = None
        self._first_counts: Optional[List[int]] = None
        self._kernel_names: Dict[str, List[str]] = {}

    @property
    def replays(self) -> int:
        """The replays so far, of either graph."""
        return sum(self.replays_by_kind.values())

    @property
    def kind(self) -> str:
        """The kind of the next micro-step: ``update`` when it ends the
        optimizers' window, else ``accumulate``."""
        kinds = {KINDS[o.micro_step == o.accum - 1] for o in self.optimizers}
        if len(kinds) != 1:
            raise RuntimeError("the optimizers' windows are out of step: "
                               f"{[o.micro_step for o in self.optimizers]}")
        return kinds.pop()

    def step(self, batch: Dict[str, torch.Tensor]
             ) -> Dict[str, torch.Tensor]:
        """The next step on ``batch`` (device tensors): an eager warm-up
        step until the run's first update, the capture after it, then a
        replay of the graph of the micro-step's kind. Returns the step's
        metrics, 0-d fp32 tensors that later steps leave as they are."""
        if not self.graphs:
            return self._warm_up(batch)
        t = self.trainer
        kind = self.kind
        for key, v in batch.items():
            self.static_in[key].copy_(v)
        t.reseed()
        for call in self.remat_calls:
            call.point_stand_ins()
        segments = self.graphs[kind]
        for graph, flags in segments[:-1]:
            # debug.nan_checks: the gradients' flags decide whether the
            # update's graph runs
            graph.replay()
            if flags.cpu().any():
                self._rerun(flags)
        if kind == "update":
            # read by the update, in the last graph
            for opt in self.optimizers:
                opt.write_lr()
        graph, flags = segments[-1]
        graph.replay()
        out = self.static_out[kind].clone()
        t.step += 1
        for opt in self.optimizers:
            opt.replayed()
        self.replays_by_kind[kind] += 1
        if flags is not None:
            nan_checks.raise_for_metrics(flags, self.keys, t.step - 1)
        return dict(zip(self.keys, out.unbind(0)))

    def _rerun(self, flags: torch.Tensor) -> None:
        """A replay's gradients held a NaN (``flags``: the graph's
        :func:`nan_checks.grad_flags`, set on every rank alike): the
        update's graph does not run, and the same step runs again eagerly
        (``Trainer.eager_step``: in one process under anomaly mode), from
        the window's gradients set aside, as ``jax_debug_nans`` reruns a
        jitted call de-optimised. It raises ``FloatingPointError`` at the
        backward op that returns the NaN, or, when none does, naming the
        flagged gradients."""
        t = self.trainer
        params = [p for opt in self.optimizers for p in opt.params]
        held = [p.grad for p in params]
        for p in params:
            p.grad = None
        t.nan_rerun = nan_checks.flagged_names(flags.cpu().tolist(),
                                               self.optimizers)
        self.reruns += 1
        try:
            t.eager_step(self.static_in)
        finally:
            t.nan_rerun = None
            for p, g in zip(params, held):
                p.grad = g

    def _warm_up(self, batch):
        """One eager, real step of the warm-up, with capturable optimizers,
        recording each remat block's generator positions; once it has
        applied the run's first update, the capture."""
        t = self.trainer
        if self._first_counts is None:
            for opt in self.optimizers:
                opt.make_capturable_(fixed_grads=t.nan_checks)
            self._first_counts = [o.count for o in self.optimizers]
        with remat.recording() as calls:
            metrics = t.eager_step(batch)
        self.remat_calls = calls
        self.warm_up_steps += 1
        if all(o.count > c for o, c in zip(self.optimizers,
                                           self._first_counts)):
            self._capture(batch)
        return metrics

    def _begin_segment(self) -> torch.cuda.CUDAGraph:
        """A new graph of the step, capturing from here (on the capture's
        stream, into its pool), with the step's generators registered."""
        t = self.trainer
        graph = torch.cuda.CUDAGraph(keep_graph=self.keep_graph)
        if self.keep_graph:
            # the nodes outlive the instantiation, for debug_dump
            graph.enable_debug_mode()
        for gen in t.generators() + [s for call in self.remat_calls
                                     for s in call.stand_ins]:
            graph.register_generator_state(gen)
        # the loader's and the checkpoint writer's threads may touch the
        # card, and NCCL's watchdog query its events, while this thread
        # captures
        graph.capture_begin(self._pool, capture_error_mode="thread_local")
        return graph

    def split(self, flags: torch.Tensor) -> None:
        """Inside a capture under ``debug.nan_checks``, at the step's
        gradient check: end the open graph at ``flags`` (the gradients'
        :func:`nan_checks.grad_flags`, which :meth:`step` reads after its
        replay) and capture the rest of the step into the next."""
        self._open.capture_end()
        self._segments.append((self._open, flags))
        self._open = self._begin_segment()

    def _capture(self, batch):
        t = self.trainer
        self.static_in = {key: torch.empty_like(v) for key, v in
                          batch.items()}
        # every graph in one pool: they never run at once
        self._pool = torch.cuda.graph_pool_handle()
        kinds = KINDS if self.optimizers[0].accum > 1 else ("update",)
        counters = (t.step, [(o.count, o.micro_step)
                             for o in self.optimizers])
        stream = torch.cuda.Stream()
        try:
            for kind in kinds:
                for opt in self.optimizers:
                    opt.micro_step = opt.accum - 1 if kind == "update" else 0
                self._segments = []
                # as torch.cuda.graph does on entry
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
                # anomaly mode's checks are host syncs, which a capture
                # cannot hold; debug.nan_checks' flags are in the graphs
                with torch.cuda.stream(stream), \
                        torch.autograd.set_detect_anomaly(False), \
                        remat.capturing(self.remat_calls):
                    self._open = self._begin_segment()
                    try:
                        out = t.device_step(self.static_in)
                        self.keys = list(out)
                        stacked = torch.stack([out[k].float()
                                               for k in self.keys])
                        flags = nan_checks.metric_flags(stacked) \
                            if t.nan_checks else None
                    finally:
                        self._open.capture_end()
                self.static_out[kind] = stacked
                self._segments.append((self._open, flags))
                if self.keep_graph:
                    for graph, _ in self._segments:
                        graph.instantiate()
                self.graphs[kind] = self._segments
        finally:
            self._open = self._segments = None
            # each capture ran the step's host code once: its counters
            t.step = counters[0]
            for opt, (count, micro) in zip(self.optimizers, counters[1]):
                opt.count, opt.micro_step = count, micro

    @property
    def kernel_names(self) -> List[str]:
        """:meth:`kernel_names_of` the updating graph, which every captured
        run has."""
        return self.kernel_names_of("update")

    def kernel_names_of(self, kind: str) -> List[str]:
        """The (mangled) name of every kernel node of the graphs of ``kind``
        (:data:`KINDS`; under ``debug.nan_checks`` a step's graphs, in
        order), one entry a node (``keep_graph``).
        Read from each graph's DOT description (``cudaGraphDebugDotPrint``
        through ``CUDAGraph.debug_dump``), which holds each kernel node's
        function."""
        if kind not in self._kernel_names:
            self._kernel_names[kind] = [
                name for names in self.segment_kernel_names(kind)
                for name in names]
        return self._kernel_names[kind]

    def segment_kernel_names(self, kind: str) -> List[List[str]]:
        """:meth:`kernel_names_of` each graph of ``kind`` apart: the one a
        step ends with, and under ``debug.nan_checks`` the one before each
        gradient check."""
        if kind not in self.graphs or not self.keep_graph:
            raise RuntimeError(f"kernel_names needs a captured {kind} "
                               "graph built with keep_graph")
        out = []
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "graph.dot")
            for graph, _ in self.graphs[kind]:
                graph.debug_dump(path)
                with open(path) as f:
                    out.append(dot_kernel_names(f.read()))
        return out


# a node of a graph's DOT description (``cudaGraphDebugDotPrint``): its
# statement, which may span lines, and in a kernel node's label the
# function after the node's ID
_DOT_NODE = re.compile(r'^"[^"]*node[^"]*"\[(.*?)\];\s*$', re.M | re.S)
_DOT_FUNCTION = re.compile(r'\{ID \|[^|]*\|\s*([^\s|\\<]+)')


def dot_kernel_names(dot: str) -> List[str]:
    """The function of each kernel node of a graph's DOT description, one
    entry a node, in the file's order."""
    names = []
    for node in _DOT_NODE.finditer(dot):
        body = node.group(1)
        if 'label="{KERNEL' not in body:
            continue
        function = _DOT_FUNCTION.search(body)
        if function is None:
            raise ValueError(f"a kernel node without its function: "
                             f"{body[:200]}")
        names.append(function.group(1))
    return names


def count_kernels(names: Iterable[str],
                  needles: Dict[str, str]) -> Dict[str, int]:
    """Per key of ``needles``, the names that hold its substring."""
    names = list(names)
    return {key: sum(needle in n for n in names)
            for key, needle in needles.items()}
