"""``train.scan_steps``: K train steps a dispatch, as replays of one CUDA
graph of the step (counterpart of the JAX package's ``jax.lax.scan`` of
its jitted step, ``semi_seg_ecg_tpu/algorithms/common.py``).

With ``train.scan_steps`` K > 1 the training loop groups K host batches
into one unit: stacked and uploaded with one pinned copy a key
(:func:`stacked_units`), the counterpart of ``np.stack`` and
``shard_stacked_batch``; the epoch's tail, shorter than K, goes one step a
unit. Each inner step's metrics reach the log, the lr and the abort on a
non-finite loss as with K = 1.

On a card, :class:`CapturedStep` takes ``Trainer.train_step``'s device
work (the cache's ``materialize``, the augmentation, the algorithm's step:
forwards, losses, backward, clip, optimizer update, EMA or peer update;
every kernel of the port inside) into one ``torch.cuda.CUDAGraph`` and
replays it once a step. The port seeds every step's draws on the host
(``Trainer.reseed``) and torch refuses ``manual_seed`` while capturing, so
one step is captured and replayed K times, not K steps captured once:
before each replay the host copies the step's slice of the unit into the
graph's static input, reseeds the trainer's generators (registered with
the graph, so the reseed takes effect in the replay) and writes each
optimizer group's lr into its device tensor
(``TrainOptimizer.write_lr``); after it, the step's metrics are copied
out of the graph's output, which the next replay overwrites. The host
counters (the trainer's step, each optimizer's update count) advance as
in an eager step.

Warm-up is the run's first step, taken eagerly as a real step: it makes
the optimizers' lazy state (AdamW's moments, SGD's momentum), builds the
kernels (``ops/cuda_build.py``), fills the allocator and records where
each remat block's forward found its generators (``models/remat.py``),
so K > 1 makes the updates and draws of K = 1. Before it the optimizers
become capturable (``TrainOptimizer.make_capturable_``: the lr a device
tensor, AdamW's step count on the device, SGD's fused update). The
capture sets every ``.grad`` to None at its start, as each step does
(``TrainOptimizer.zero_grad``), so the backward allocates the gradients
from the graph's private pool; they stay there, and each replay rewrites
them in place. Autocast runs with its cast cache off
(``Trainer.amp``), as capture needs.

No fallback: a capture or a replay that fails raises, and on a card K > 1
never runs a step eagerly but the warm-up. On the CPU nothing is captured:
a unit runs its K steps eagerly (the plain version the tests hold against
K = 1). Refused, with the reason (:func:`check_scan_steps`): a process
group (gloo's collectives are host calls a graph cannot hold; NCCL's
all-reduce could be captured, but has not run on two cards here),
``train.accum_iter`` > 1 (a window's micro-steps differ: all but the last
make no update, which needs a second graph) and ``debug.nan_checks``
(autograd's anomaly mode checks every backward on the host).

:attr:`CapturedStep.kernel_names` lists the graph's kernel nodes: the
ported kernels' host counters (``ops/flash_attention.LAUNCHES``, ...)
count once at capture and never at a replay, so a run's launches are read
from the graph itself.
"""

from __future__ import annotations

import os
import re
import tempfile
from typing import Any, Dict, Iterable, Iterator, List, Optional

import numpy as np
import torch

from ..models import remat
from ..parallel import dist as pdist

def scan_steps(config: Dict[str, Any]) -> int:
    """``train.scan_steps``, at least 1."""
    return max(int(config["train"].get("scan_steps", 1) or 1), 1)


def check_scan_steps(config: Dict[str, Any]) -> int:
    """:func:`scan_steps`, or a ``ValueError`` with the reason when the run
    cannot take K > 1 (the same on either device)."""
    k = scan_steps(config)
    if k == 1:
        return k
    reasons = []
    if pdist.get_world_size() > 1:
        reasons.append(
            f"under a process group of {pdist.get_world_size()} ranks: a "
            "gloo collective is a host call a CUDA graph cannot hold, and "
            "NCCL's captured all-reduce has not run on two cards")
    accum = int(config["train"].get("accum_iter", 1) or 1)
    if accum > 1:
        reasons.append(
            f"with train.accum_iter {accum}: all but the last micro-step "
            "of a window make no update, so a window needs a second graph")
    if (config.get("debug") or {}).get("nan_checks", False):
        reasons.append(
            "with debug.nan_checks: autograd's anomaly mode checks every "
            "backward on the host, which a CUDA graph cannot capture")
    if reasons:
        raise ValueError(f"train.scan_steps: {k} is refused "
                         + "; ".join(reasons))
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


class CapturedStep:
    """One trainer's step, warmed up and captured at its first call, then
    replayed at every call (see the module docstring). ``trainer`` is an
    ``algorithms.common.Trainer`` on a CUDA device; with ``keep_graph`` the
    graph keeps its nodes for :attr:`kernel_names` (a caller that counts
    launches puts one in ``trainer.captured`` before the first step)."""

    def __init__(self, trainer, keep_graph: bool = False):
        if trainer.device.type != "cuda":
            raise ValueError("a captured step needs a CUDA device, not "
                             f"{trainer.device}")
        self.trainer = trainer
        self.keep_graph = keep_graph
        self.optimizers = [o for o in (trainer.optimizer,
                                       trainer.peer_optimizer)
                           if o is not None]
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.static_in: Dict[str, torch.Tensor] = {}
        self.static_out: Optional[torch.Tensor] = None
        self.keys: List[str] = []
        self.remat_calls: List = []  # remat.RematCall of the captured step
        self.replays = 0
        self._kernel_names: Optional[List[str]] = None

    def step(self, batch: Dict[str, torch.Tensor]
             ) -> Dict[str, torch.Tensor]:
        """The next step on ``batch`` (device tensors): the warm-up step and
        the capture at the first call, a replay at every later one. Returns
        the step's metrics, 0-d fp32 tensors that later steps leave as they
        are."""
        if self.graph is None:
            metrics = self._warm_up(batch)
            self._capture(batch)
            return metrics
        t = self.trainer
        for key, v in batch.items():
            self.static_in[key].copy_(v)
        t.reseed()
        for call in self.remat_calls:
            call.point_stand_ins()
        for opt in self.optimizers:
            opt.write_lr()
        self.graph.replay()
        out = self.static_out.clone()
        t.step += 1
        for opt in self.optimizers:
            opt.count += 1
        self.replays += 1
        return dict(zip(self.keys, out.unbind(0)))

    def _warm_up(self, batch):
        """The run's first step, eager and real, with capturable optimizers,
        recording each remat block's generator positions."""
        for opt in self.optimizers:
            opt.make_capturable_()
        t = self.trainer
        with remat.recording() as calls:
            metrics = t.eager_step(batch)
        self.remat_calls = calls
        return metrics

    def _capture(self, batch):
        t = self.trainer
        self.static_in = {key: torch.empty_like(v) for key, v in
                          batch.items()}
        graph = torch.cuda.CUDAGraph(keep_graph=self.keep_graph)
        if self.keep_graph:
            # the graph's nodes outlive its instantiation, for debug_dump
            graph.enable_debug_mode()
        for gen in t.generators() + [s for call in self.remat_calls
                                     for s in call.stand_ins]:
            graph.register_generator_state(gen)
        counters = (t.step, [(o.count, o.micro_step)
                             for o in self.optimizers])
        try:
            # the loader's and the checkpoint writer's threads may touch
            # the card while this thread captures
            with torch.cuda.graph(graph, capture_error_mode="thread_local"), \
                    remat.capturing(self.remat_calls):
                out = t.device_step(self.static_in)
                self.keys = list(out)
                self.static_out = torch.stack([out[k].float()
                                               for k in self.keys])
        finally:
            # capturing ran the step's host code once: its counters
            t.step = counters[0]
            for opt, (count, micro) in zip(self.optimizers, counters[1]):
                opt.count, opt.micro_step = count, micro
        if self.keep_graph:
            graph.instantiate()
        self.graph = graph

    @property
    def kernel_names(self) -> List[str]:
        """The (mangled) name of every kernel node of the captured graph,
        one entry a node (``keep_graph``).
        Read from the graph's DOT description (``cudaGraphDebugDotPrint``
        through ``CUDAGraph.debug_dump``), which holds each kernel node's
        function."""
        if self._kernel_names is None:
            if self.graph is None or not self.keep_graph:
                raise RuntimeError("kernel_names needs a captured step "
                                   "built with keep_graph")
            with tempfile.TemporaryDirectory() as tmp:
                path = os.path.join(tmp, "graph.dot")
                self.graph.debug_dump(path)
                with open(path) as f:
                    self._kernel_names = dot_kernel_names(f.read())
        return self._kernel_names


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
