"""Shared training and evaluation machinery (counterpart of
``semi_seg_ecg_tpu/algorithms/common.py``).

One process per device: the config's ``device`` (``resolve_device``), the
CUDA card unless it says ``cpu``; under ``torchrun`` (or SLURM) each rank
takes its own card and trains data-parallel (``parallel/``), as the JAX
package trains over the data axis of its mesh. The training loop exists
once; an algorithm contributes a :class:`AlgorithmSpec` whose
``make_train_step`` returns the body of one step, and says whether the run
keeps an EMA teacher (Mean Teacher) or a peer with its own optimizer (CPS),
which the :class:`Trainer` holds beside the model. Around the step, the
loop:

- builds the loaders, with the device-augment plan's host overrides, each
  rank loading its own shards of every global batch (``batch_size`` rows
  a rank; the lr scales with the global batch, ``resolve_lr``);
- moves each batch to the device from pinned memory without blocking, one
  batch ahead of the step that uses it;
- reseeds its generators every step from ``(seed, step)``: one for dropout
  and DropPath (``models/dropout.py``), the teacher's from a stream of its
  own, the peer's from ``seed + 1``, the loss's draws (ReCo's samples) from
  another stream, and, for ``device_augment``, one from ``seed + 0x5EED``
  for the augmentation draws (``ops/preprocess.py``) — the JAX package's
  ``fold_in(key, step)``;
- sets the scheduled lr of each update, on the peer's optimizer too
  (``utils/optimizer.py``); with ``train.accum_iter`` k > 1 an update
  takes the mean gradient of k micro-steps (a window counted on the global
  micro-step, so it may span an epoch's end), the schedule counts
  ``max(steps_per_epoch // k, 1)`` updates an epoch, and the EMA teacher
  follows updates only;
- drains the step metrics every ``PRINT_FREQ`` steps, their mean over the
  ranks, aborting on a non-finite loss (every rank at once, after
  flushing the pending checkpoint writes and naming the last one that
  landed), and prints the progress line (the logged lr
  is that of update ``global_step // k``; TensorBoard's scalars are
  written on a window's last micro-step);
- traces the steps ``profile:`` names (``utils/profiling.py``);
- evaluates the model (the student, CPS's model 1) after each epoch, each
  rank on its shards of the split, the rows exchanged
  (``parallel.dist.all_gather_rows``), and writes ``best-loss.ckpt`` /
  ``best-{metric}.ckpt`` (teacher or peer included) and a ``log.txt``
  line, on rank 0 only; under ``checkpoint_backend: orbax`` every rank
  writes its part of the checkpoint directory. With ``async_checkpoint``
  (on unless the config says ``false``, as in the JAX package) the
  writer thread of ``utils/checkpoint.py`` writes the files while the
  next epoch runs; the run flushes it before it returns, and every rank
  then waits at a barrier, so a rank that reads a file rank 0 wrote (a
  resume, ``run_test`` after training) finds it.

Data parallelism as the JAX package's data mesh computes it: rank 0's
weights are broadcast at the start, each step's gradients averaged over
the ranks before clipping (``utils/optimizer.TrainOptimizer``; an
accumulation window open at an epoch's end is averaged then, so rank 0's
checkpoint holds the global batch's partial sum), BatchNorm
statistics taken over the global batch (``models/norm.py``) and per-row
random draws made for the global batch (``parallel.dist.global_rows``).
N ranks with ``batch_size`` b take the steps of one process holding N
shards of b rows (the loader's ``num_shards=N, local_shards=N``).

``resume:`` (``--resume``) restarts a run from a checkpoint
(``utils/checkpoint.maybe_resume``: the port's own ``.ckpt`` or
directory, a JAX ``.ckpt`` or a ``.pth``) before every rank takes rank
0's weights; the
epoch after the file's is the first to run, and its best-so-far
thresholds carry over, so the first resumed epoch does not overwrite the
real ``best-*.ckpt``.

For ST++'s stages, :func:`run_training` also takes an output subdirectory,
a subset of the unlabeled rows, the epochs after which it writes
``checkpoint-{epoch + 1}.ckpt`` snapshots, and a hook that gets the built
:class:`Trainer` (it loads the stage teacher).

``mode`` other than ``scratch`` warm-starts the backbone of the model (and
of the peer) from ``pretrained_backbone`` (:func:`load_pretrained_backbone`);
``debug.nan_checks`` is the JAX package's ``jax_debug_nans``
(``utils/nan_checks.py``; slow, for debugging): from :func:`run_training`'s
start to the end of ``cli.train_main`` a NaN in a step's gradients or
metrics, or in an evaluation batch's probabilities or loss (the epoch's
validation, the ``test: true`` pass) raises ``FloatingPointError`` on every
rank, before the step's update and before the epoch's checkpoints; an
eager step names the backward op that returned the NaN (in one process
autograd's anomaly mode, whose error the ``FloatingPointError`` is raised
from).

Precision: the whole run is full fp32 (no TF32 in cuBLAS and cuDNN,
``full_fp32``; the flash kernels form fp32 products from three TF32
products each, 3xTF32 with fp32 accumulation, to fp32 accuracy, which
``full_fp32`` does not govern); with
``precision: bf16`` the forwards and losses run under bf16 autocast, with
fp32 parameters and optimizer and no loss scaling, as the JAX package
computes in bf16 with fp32 parameters. ``train.fused_state`` is accepted
and does nothing: torch updates the parameters in place, which is what the
JAX package's fused state buys. ``train.scan_steps`` K > 1 runs K steps a
dispatch, as the JAX package scans K steps into one device program: the
loop uploads K stacked batches at once (the epoch's tail one at a time),
and on a card each step is a replay of a CUDA graph of the step's device
work (``utils/captured_step.py``: under ``train.accum_iter`` > 1 one graph
for the accumulating micro-step and one for the updating one; under NCCL
with the step's collectives inside), after an eager warm-up up to the
run's first update; on the CPU a unit's steps run eagerly, under any
process group. Every step's metrics, lr and draws are those of K = 1. A
gloo process group with CUDA tensors refuses K > 1 with the reason. Under
``debug.nan_checks`` a captured step is two graphs split at the gradients'
NaN flags, and a set flag reruns the step eagerly.
``dataset.device_cache`` puts the train split on the device once and
ships row indices per step (``data/device_cache.py``; the rows are gathered
before the augmentation stage), when the device-augment plan runs every
train augmentation on the device; otherwise the run logs why and streams,
as the JAX package does. ``parallel.shard_optimizer`` over more than one
rank is ZeRO-1: each rank keeps the optimizer state of its own share of
the parameters (``utils/optimizer.TrainOptimizer``), with the numbers of
the replicated run.

``parallel.model_parallel`` m > 1 lays the ranks out as a ``(data,
model)`` mesh (``parallel/mesh.py``: rank ``r`` is data rank ``r // m``,
model rank ``r % m``). The model ranks of one data rank load the same
rows and draw the same masks; the trainer builds every network whole,
takes rank 0's weights over the whole group, then slices each one over
the model axis (``parallel/sharding_rules.shard_module_``: the ViT's
attention heads and MLP columns, Megatron's layout; a ResNet, which no
rule matches, runs replicated with the JAX package's warning). Gradients,
BatchNorm statistics, ReCo's gathered rows and the evaluators' rows go
over the data group. A pickle checkpoint holds the unsliced layout,
gathered over the model group on every rank before rank 0 writes (a
directory checkpoint takes each rank's slices as they are); the test and
inference entries, the per-epoch evaluation and ST++'s ranking run the
model sliced the same way.

``parallel.seq_parallel`` s > 1 adds the seq axis (``parallel/mesh.py``:
rank ``r`` is data rank ``r // (s·m)``, seq rank ``(r // m) % s``). The seq
ranks of one data rank load the same rows with the same draws; each step
and each evaluation or serving batch then takes the rank's block of the
time axis (``parallel/seq_shard.split_batch``, the JAX package's split
rule) and runs inside ``seq_shard.time_sharded``: the model's time-axis
ops exchange halos with the other seq ranks, the ViT's attention runs the
ring, the losses and the evaluators' counts are global, the gradients are
summed over seq and averaged over data, and ``run_test`` and
``run_inference`` gather the time blocks of the probabilities whole. As
in the JAX package, ``device_augment`` and ``device_cache`` are switched
off under seq (on a copy of the config, with its log line). The
checkpoint is unchanged: the parameters are replicated over seq. Every
algorithm and checkpoint backend runs on every ``(data, seq, model)`` mesh:
ReCo gathers its loss's inputs over data and seq (``algorithms/reco.py``),
ST++ ranks on the seq ranks' time blocks (``algorithms/stpp.py``), under
``seq × model`` the ring runs on a model rank's heads over its own seq
group, and int8 serving takes each split input's absmax over the group
that splits it (``models/quant_layers.py``).
"""

from __future__ import annotations

import contextlib
import copy
import csv
import datetime
import math
import os
import sys
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, Optional

import numpy as np
import torch
import yaml

from ..config import experiment_dir, resolve_device, test_cfg
from ..data.dataset import build_seg_dataset
from ..data.loader import get_dataloader
from ..models import build_model_from_config, compute_dtype
from ..models.dropout import use_generator
from ..ops.losses import per_sample_cross_entropy
from ..ops.metrics import (
    build_metric_fn,
    flatten_metric_dict,
    is_best_metric,
    segmentation_stats,
)
from ..parallel import dist as pdist
from ..parallel import mesh as pmesh
from ..parallel import seq_shard
from ..parallel.sharding_rules import full_state_dict, shard_module_
from ..utils import captured_step as capture
from ..utils import checkpoint as ckpt
from ..utils import nan_checks as nans
from ..utils.logging import JsonlLogger, MetricLogger, TensorBoardWriter, log
from ..utils.optimizer import (
    accum_iter,
    build_optimizer,
    make_lr_schedule,
    resolve_lr,
    updates_per_epoch,
)
from ..utils.profiling import ProfileSchedule, device_memory_mb
from ..utils.weights import jax_trees_to_state_dict

PRINT_FREQ = 20
AUGMENT_SEED_OFFSET = 0x5EED
# the CPS peer's init seed (the JAX package's ``seed + 10_000``) and the
# offset of its dropout seed
PEER_INIT_SEED_OFFSET = 10_000
PEER_SEED_OFFSET = 1
# the Mean Teacher's train-mode forward draws its dropout from this stream
# of ``(seed, step)`` (the JAX package folds 3 into the step key)
TEACHER_STREAM = 3
# the stream of a loss's own draws (ReCo's samples; the JAX package draws
# them from ``fold_in(key(seed + 7), step)``)
LOSS_STREAM = 7


@dataclass
class AlgorithmSpec:
    """What varies between algorithms. ``make_train_step(trainer)`` returns
    ``step(batch) -> metrics`` (0-d tensors on the device), which runs the
    forward(s) under ``trainer.amp()``, the backward(s) and the optimizer
    update(s) on what the :class:`Trainer` holds: ``model`` and
    ``optimizer``, with ``uses_ema`` the ``teacher``, with ``uses_peer``
    the ``peer`` and ``peer_optimizer``, and the ``loss_gen`` generator for
    a loss's random draws."""

    name: str
    make_train_step: Callable[..., Callable]
    uses_unlabeled: bool = False
    uses_ema: bool = False
    uses_peer: bool = False


def loader_workers(dataloader_cfg: Dict[str, Any]) -> int:
    """num_workers with an unset default of 4; an explicit 0 means
    synchronous loading."""
    n = dataloader_cfg.get("num_workers", 4)
    return 4 if n is None else int(n)


def loader_worker_type(dataloader_cfg: Dict[str, Any]) -> str:
    return dataloader_cfg.get("worker_type", None) or "thread"


@contextlib.contextmanager
def full_fp32():
    """TF32 off for cuBLAS matmuls and cuDNN convolutions while inside, so
    fp32 work is full fp32 as in the JAX package (PyTorch's default lets
    cuDNN use TF32); the process's settings come back on exit."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def amp_context(config: Dict[str, Any], device: torch.device,
                cache_enabled: Optional[bool] = None) -> Callable:
    """A factory of the config's compute-precision context: bf16 (or fp16)
    autocast, or nothing at fp32; ``cache_enabled=False`` turns autocast's
    cache of cast weights off (a CUDA graph capture needs it off)."""
    dtype = compute_dtype(config)
    enabled = dtype != torch.float32
    return lambda: torch.autocast(device.type, dtype=dtype, enabled=enabled,
                                  cache_enabled=cache_enabled)


def forward_parts(model: torch.nn.Module, parts, **kwargs):
    """``model(cat(parts), **kwargs)``: one forward of the parts' rows
    (BatchNorm statistics over all of them) whose per-row draws under a
    process group are those one process holding every rank's rows of each
    part makes (``parallel.dist.concatenated_rows``), which needs parts of
    equal rows."""
    if pdist.data_size() > 1 and len({p.shape[0] for p in parts}) > 1:
        raise ValueError("a concatenated batch under a process group needs "
                         "parts of equal rows, not "
                         f"{[p.shape[0] for p in parts]}")
    with pdist.concatenated_rows(len(parts)):
        return model(torch.cat(parts, dim=0), **kwargs)


def step_seed(seed: int, step: int, stream: int = 0) -> int:
    """A generator seed for one step of a run: distinct across steps,
    seeds and streams, the same on every replay."""
    entropy = [seed, step] + ([stream] if stream else [])
    return int(np.random.SeedSequence(entropy).generate_state(
        1, np.uint64)[0])


def init_model(config: Dict[str, Any], device: torch.device,
               train: bool = True,
               seed: Optional[int] = None) -> torch.nn.Module:
    """The config's model initialised from ``seed`` (default: the config's):
    PyTorch's default initialisation, the ResNet's Kaiming fan-out convs;
    the process's global RNG state is left as it was."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(config.get("seed", 0) if seed is None else seed)
        model = build_model_from_config(config, train=train)
    return model.to(device)


def load_pretrained_backbone(config: Dict[str, Any],
                             model: torch.nn.Module) -> None:
    """Warm-start ``model.backbone`` from ``pretrained_backbone``, in place
    (the JAX package's ``load_pretrained_backbone``; reference
    base.py:289-303). Three kinds of file: a JAX ``.ckpt`` whose
    ``model.params`` holds a ``backbone`` subtree or is a bare backbone
    tree; a reference ``.pth`` (or flat ``.ckpt``) holding the full model,
    whose ``backbone.*`` keys are taken; or one holding the bare backbone.
    The load is strict: a key missing or left over raises."""
    path = config["pretrained_backbone"]
    payload = ckpt.load_checkpoint(path)
    log(f"Load backbone from {path}")
    source = payload.get("model", payload)
    target = model.backbone.state_dict().keys()
    if "params" in source:
        params, stats = source["params"], source.get("batch_stats", {})
        if "backbone" in params:
            params, stats = params["backbone"], stats.get("backbone", {})
        state = jax_trees_to_state_dict(params, stats, target,
                                        backbone_only=True)
    else:
        state = {k: torch.as_tensor(v) for k, v in source.items()}
        if any(k.startswith("backbone.") for k in state):
            state = {k[len("backbone."):]: v for k, v in state.items()
                     if k.startswith("backbone.")}
    model.backbone.load_state_dict(state)


def init_train_model(config: Dict[str, Any], device: torch.device,
                     seed: int) -> torch.nn.Module:
    """A training model from ``seed``, its backbone warm-started unless
    ``mode`` is ``scratch``."""
    model = init_model(config, torch.device("cpu"), seed=seed)
    if config.get("mode", "scratch") != "scratch":
        load_pretrained_backbone(config, model)
    return model.to(device)


CHECKPOINT_BACKENDS = ("pickle", "orbax")


def checkpoint_backend(config: Dict[str, Any]) -> str:
    """The config's ``checkpoint_backend``: ``pickle`` (the default, one
    file from rank 0) or ``orbax`` (a directory every rank writes through
    ``torch.distributed.checkpoint``); another name raises."""
    backend = config.get("checkpoint_backend") or "pickle"
    if backend not in CHECKPOINT_BACKENDS:
        raise ValueError(f"checkpoint_backend: {backend!r} is none of "
                         f"{CHECKPOINT_BACKENDS}")
    return backend


def seq_parallel_config(config: Dict[str, Any]) -> Dict[str, Any]:
    """``config``, or under ``seq_parallel > 1`` a copy with
    ``device_augment`` and ``device_cache`` off (the JAX package's
    switch-off, with its log line; the caller's config is not changed)."""
    if ((config.get("parallel") or {}).get("seq_parallel") or 1) <= 1 or \
            not any(config["dataset"].get(k, False)
                    for k in ("device_augment", "device_cache")):
        return config
    config = {**config, "dataset": dict(config["dataset"])}
    for knob in ("device_augment", "device_cache"):
        if config["dataset"].get(knob, False):
            log(f"{knob} disabled: seq_parallel shards the time axis and "
                "the fused augment path assumes data-only sharding — using "
                "the host augmentation path", force=True)
            config["dataset"][knob] = False
    return config


# ---------------------------------------------------------------------------
# Data plumbing
# ---------------------------------------------------------------------------


def build_train_loaders(config: Dict[str, Any], spec: AlgorithmSpec,
                        unlabeled_subset_ids=None) -> Dict[str, Any]:
    eval_cfg = ds_cfg = config["dataset"]
    lab_cfg = unlab_cfg = ds_cfg
    if ds_cfg.get("device_augment", False):
        # the plan decides per branch what the host still computes and what
        # the device stage builds; evaluation keeps the host path
        from ..ops.preprocess import plan_device_augment

        plan = plan_device_augment(ds_cfg)
        lab_cfg = {**ds_cfg, **plan.labeled_overrides}
        unlab_cfg = {**ds_cfg, **plan.unlabeled_overrides}
    seed = config["seed"]
    batch_size = config["dataloader"]["batch_size"]
    num_shards = pmesh.data_parallel_size()
    common = dict(batch_size=batch_size, seed=seed, num_shards=num_shards,
                  num_workers=loader_workers(config["dataloader"]),
                  worker_type=loader_worker_type(config["dataloader"]),
                  **pmesh.host_shard_args(num_shards))
    drop_last = config["dataloader"].get("drop_last", None)

    loaders: Dict[str, Any] = {}
    if spec.uses_unlabeled:
        ds_unlab = build_seg_dataset(unlab_cfg, split="train_unlabeled")
        if unlabeled_subset_ids is not None:
            from ..data.dataset import Subset

            ds_unlab = Subset(ds_unlab, unlabeled_subset_ids)
        num_unlabeled = len(ds_unlab)
        ds_lab = build_seg_dataset(lab_cfg, split="train_labeled",
                                   num_unlabeled=num_unlabeled)
        loaders["unlabeled"] = get_dataloader(
            ds_unlab, mode="train", rng_salt=1, drop_last=drop_last,
            **common)
        log(f"Unlabeled: {num_unlabeled} samples / "
            f"{len(loaders['unlabeled'])} batches")
    else:
        ds_lab = build_seg_dataset(lab_cfg, split="train_labeled")
    loaders["labeled"] = get_dataloader(
        ds_lab, mode="train", rng_salt=0, drop_last=drop_last, **common)
    log(f"Labeled: {len(ds_lab)} samples / {len(loaders['labeled'])} batches")
    ds_valid = build_seg_dataset(eval_cfg, split="valid")
    loaders["valid"] = get_dataloader(ds_valid, mode="valid", rng_salt=2,
                                      **common)
    if spec.uses_unlabeled and \
            len(loaders["labeled"]) != len(loaders["unlabeled"]):
        raise ValueError("The number of labeled and unlabeled batches "
                         "should be the same")
    return loaders


def combined_batches(loaders, spec: AlgorithmSpec) -> Iterator[Dict]:
    """Merged step dicts: labeled ``ecg``/``target`` and the unlabeled
    weak/strong views (``ecg_u_w``/``ecg_u_s``); under ``device_cache``
    the row indices ``idx``/``idx_u``."""
    if not spec.uses_unlabeled:
        yield from loaders["labeled"]
        return
    for labeled, unlabeled in zip(loaders["labeled"], loaders["unlabeled"]):
        if "idx" in labeled:  # device_cache: index-only batches
            yield {"idx": labeled["idx"], "idx_u": unlabeled["idx_u"]}
            continue
        batch = {"ecg": labeled["ecg"], "target": labeled["target"],
                 "ecg_u_w": unlabeled["ecg"]}
        if "ecg_aug" in unlabeled:
            batch["ecg_u_s"] = unlabeled["ecg_aug"]
        yield batch


def to_device(batch: Dict[str, np.ndarray],
              device: torch.device) -> Dict[str, torch.Tensor]:
    """Host arrays → device tensors; on CUDA through pinned memory with a
    non-blocking copy, so the copy overlaps the running step."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t
    return out


def prefetched(batches, device: torch.device) -> Iterator[Dict]:
    """Device batches, each copied one step ahead of its use."""
    ahead = None
    for b in batches:
        nxt = to_device(b, device)
        if ahead is not None:
            yield ahead
        ahead = nxt
    if ahead is not None:
        yield ahead


# ---------------------------------------------------------------------------
# Evaluation
# ---------------------------------------------------------------------------


def eval_step(model: torch.nn.Module, x: torch.Tensor, labels: torch.Tensor,
              num_classes: int, collect_outputs: bool = True,
              nan_flags: bool = False) -> Dict[str, torch.Tensor]:
    """Softmax probabilities (with ``collect_outputs``), per-sample CE and
    per-class counts of one batch, from an eval-mode forward (the caller
    sets mode and autocast); with ``nan_flags`` the NaN flags of the
    probabilities and the CE over every rank (``nan``,
    ``utils/nan_checks.eval_flags``). Under the seq axis each seq rank
    runs its block of the time axis, the counts and CE are summed over the
    seq ranks, and the probabilities gathered whole."""
    batch, length = seq_shard.split_batch({"x": x, "labels": labels})
    with seq_shard.time_sharded(length):
        logits = model(batch["x"])["seg_logits"].float()
        probs = torch.softmax(logits, dim=1)
        preds = torch.argmax(probs, dim=1)
        stats = segmentation_stats(preds, batch["labels"], num_classes)
        inter, psum, tsum = (seq_shard.sum_counts(t) for t in stats)
        loss = per_sample_cross_entropy(logits, batch["labels"])
        out = {"loss": loss, "inter": inter, "psum": psum, "tsum": tsum}
        if nan_flags:
            out["nan"] = nans.eval_flags(probs, loss)
        if collect_outputs:
            out["probs"] = seq_shard.gather_whole_time(probs)
    return out


def evaluate(model: torch.nn.Module, loader, metric_fn, num_classes: int,
             device: torch.device, amp: Callable,
             eval_batch_size: Optional[int] = None,
             collect_outputs: bool = True,
             nan_checks: Optional[str] = None):
    """Full-dataset evaluation, each rank on the shards its ``loader``
    holds, the rows then exchanged so that every rank has all of them.
    With ``nan_checks`` (the pass's name, for the message) a NaN in a
    batch's probabilities or loss raises ``FloatingPointError`` on every
    rank (``debug.nan_checks``).
    Returns ``(valid_stats, metric_dict, outputs, labels_onehot)``:
    ``outputs`` are softmax probabilities ``(N, C, T)`` in dataset order
    and ``labels_onehot`` ``(N, C, T)`` int64, the arrays ``run_test``
    saves. Metric updates are replayed in the reference's eval batch
    grouping, as in the JAX package."""
    n = len(loader.dataset)
    mat = loader.step_indices()
    loss_ps = np.zeros(n)
    inter = np.zeros((n, num_classes), np.int64)
    psum = np.zeros((n, num_classes), np.int64)
    tsum = np.zeros((n, num_classes), np.int64)
    outputs = labels_np = None
    t0 = time.time()
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad(), amp():
            for step, batch in enumerate(prefetched(loader, device)):
                out = eval_step(model, batch["ecg"], batch["target"],
                                num_classes, collect_outputs,
                                nan_flags=nan_checks is not None)
                if nan_checks is not None:
                    nans.raise_for_eval(out.pop("nan"), nan_checks, step)
                out = {k: v.cpu().numpy() for k, v in out.items()}
                flat = mat[step].reshape(-1)
                loss_ps[flat] = out["loss"]
                inter[flat] = out["inter"]
                psum[flat] = out["psum"]
                tsum[flat] = out["tsum"]
                if collect_outputs:
                    if outputs is None:
                        outputs = np.zeros((n,) + out["probs"].shape[1:],
                                           np.float32)
                        labels_np = np.zeros(
                            (n,) + tuple(batch["target"].shape[1:]),
                            np.int64)
                    outputs[flat] = out["probs"]
                    labels_np[flat] = batch["target"].cpu().numpy()
    finally:
        model.train(was_training)
    arrays = [loss_ps, inter, psum, tsum]
    if collect_outputs:
        arrays += [outputs, labels_np]
    pdist.all_gather_rows(mat.reshape(-1), arrays)
    if eval_batch_size is None:
        eval_batch_size = loader.batch_size
    for lo in range(0, n, eval_batch_size):
        sel = slice(lo, lo + eval_batch_size)
        metric_fn.update(inter[sel], psum[sel], tsum[sel])
    metric_dict = flatten_metric_dict(metric_fn.compute())
    metric_fn.reset()
    valid_stats = {"loss": float(loss_ps.mean())}
    metric_str = "  ".join(f"{k}: {v:.3f}" for k, v in metric_dict.items())
    log(f"* {metric_str}  loss: {valid_stats['loss']:.3f}  "
        f"({time.time() - t0:.1f}s)")
    labels_onehot = None
    if collect_outputs:
        eye = np.eye(num_classes, dtype=np.int64)
        labels_onehot = eye[labels_np].transpose(0, 2, 1)  # (N, C, T)
    return valid_stats, metric_dict, outputs, labels_onehot


# ---------------------------------------------------------------------------
# The shared training loop
# ---------------------------------------------------------------------------


class Trainer:
    """The state of one run: model and optimizer, the Mean Teacher's
    ``teacher`` or the CPS ``peer`` and ``peer_optimizer`` where the
    algorithm keeps one, the generators, and the per-step function, so
    that a caller (the training loop, a test, a profile) can run single
    steps. ``model`` / ``peer`` given are used as they are (no warm
    start); else they are initialised from ``seed`` / ``seed + 10_000``.
    A config with ``resume`` restores them (and the optimizers and the
    step) from the checkpoint it names; ``resume_best`` holds that file's
    best-so-far thresholds. Under ``train.scan_steps`` > 1 on a card
    each step after the warm-up replays a graph of the step captured in
    :attr:`captured` (``utils/captured_step.CapturedStep``). Under
    ``debug.nan_checks`` (:attr:`nan_checks`) each optimizer's step starts
    with the step's gradient check (:meth:`_check_grads`), and an eager
    step names the backward op that returns a NaN and checks its
    metrics (:meth:`eager_step`)."""

    def __init__(self, config: Dict[str, Any], spec: AlgorithmSpec,
                 device: torch.device, updates_per_epoch: int,
                 model: Optional[torch.nn.Module] = None,
                 peer: Optional[torch.nn.Module] = None):
        self.config = config
        self.device = device
        self.seed = config["seed"]
        # on a card K > 1 captures the step (check_scan_steps refuses a
        # group whose collectives a graph cannot hold); on the CPU a unit's
        # steps run eagerly
        self.scan_steps = capture.check_scan_steps(config, device)
        self.nan_checks = nans.enabled(config)
        # the names of the gradients a captured step's graph flagged, while
        # its eager rerun runs (utils/captured_step.py)
        self.nan_rerun = None
        self._grads_checked = False
        self._backward_nans = None  # an eager step's, under a group
        self.capture = self.scan_steps > 1 and device.type == "cuda"
        self.captured: Optional[capture.CapturedStep] = None
        self.mesh = pmesh.make_mesh(config)
        self.model = model if model is not None else init_train_model(
            config, device, self.seed)
        self.optimizer = build_optimizer(config, self.model,
                                         updates_per_epoch)
        self.amp = amp_context(config, device,
                               cache_enabled=False if self.capture else None)
        self.teacher = self.teacher_gen = None
        if spec.uses_ema:
            # the teacher starts as a copy of the student
            # (mean_teacher.py:281-291) and learns only through the EMA
            self.teacher = copy.deepcopy(self.model).requires_grad_(False)
            self.teacher_gen = torch.Generator(device=device)
            use_generator(self.teacher, self.teacher_gen)
        self.peer = self.peer_optimizer = self.peer_gen = None
        if spec.uses_peer:
            # an independently initialised second network (cps.py:270-276)
            self.peer = peer if peer is not None else init_train_model(
                config, device, self.seed + PEER_INIT_SEED_OFFSET)
            self.peer_optimizer = build_optimizer(config, self.peer,
                                                  updates_per_epoch)
            self.peer_gen = torch.Generator(device=device)
            use_generator(self.peer, self.peer_gen)
        if self.optimizer.sharded:
            log(f"shard_optimizer: optimizer state sharded over "
                f"{pdist.data_size()} ranks, each updating its own "
                "parameters and broadcasting them")
        self.dropout_gen = torch.Generator(device=device)
        use_generator(self.model, self.dropout_gen)
        self.loss_gen = torch.Generator(device=device)
        self.inner_step = spec.make_train_step(self)
        self.augment = None
        self.augment_gen = None
        self.cache = None
        if config["dataset"].get("device_augment", False):
            from ..ops.preprocess import plan_device_augment

            plan = plan_device_augment(config["dataset"])
            log(f"device_augment: {plan.summary}")
            if plan.augment is not None:
                self.augment = plan.augment
                self.augment_gen = torch.Generator(device=device)
        if self.mesh.seq > 1:
            log(f"seq_parallel: {self.mesh.seq} seq ranks x "
                f"{self.mesh.data} data ranks; time axes split where they "
                "divide")
        self.step = 0
        if self.nan_checks:
            for opt in self.optimizers:
                opt.before_update = self._check_grads
        self.resume_best = ckpt.maybe_resume(config, self)
        # every rank starts from rank 0's weights (warm starts and resumes
        # included)
        for module in (self.model, self.teacher, self.peer):
            if module is not None:
                pdist.broadcast_module_(module)
        if self.mesh.model > 1:
            # then each network (and its optimizer's state) is sliced to
            # this model rank's share
            for module, opt in ((self.model, self.optimizer),
                                (self.teacher, None),
                                (self.peer, self.peer_optimizer)):
                if module is not None:
                    plan = shard_module_(module, self.mesh)
                    if opt is not None:
                        opt.shard_(plan, self.mesh)
            log(f"model_parallel: {self.mesh.model} model ranks x "
                f"{self.mesh.data} data ranks; "
                f"{len(self.model.model_plan)} parameters sliced")

    def checkpoint_state(self) -> Dict[str, Any]:
        """Every network's state dict and each optimizer's state in the
        unsliced, unsharded layout: a collective (the model group's
        slices, ZeRO-1's shares), so every rank calls it."""
        nets = {"model": self.model, "ema_model": self.teacher,
                "peer_model": self.peer}
        out = {k: None if m is None else full_state_dict(m)
               for k, m in nets.items()}
        for key, opt in (("optimizer", self.optimizer),
                         ("peer_optimizer", self.peer_optimizer)):
            out[key] = None if opt is None else opt.state_dict()
        return out

    def local_checkpoint_state(self) -> Dict[str, Any]:
        """What this rank holds, for the directory checkpoint, with no
        collective: every network's state dict (its model-axis slices
        where sliced), each optimizer's ``local_state_dict()`` (its ZeRO-1
        share), the slices by payload key and the model group."""
        nets = {"model": self.model, "ema_model": self.teacher,
                "peer_model": self.peer}
        out: Dict[str, Any] = {k: None if m is None else m.state_dict()
                               for k, m in nets.items()}
        for key, opt in (("optimizer", self.optimizer),
                         ("peer_optimizer", self.peer_optimizer)):
            out[key] = None if opt is None else opt.local_state_dict()
        plans = {"model": self.model, "model_ema": self.teacher,
                 "model_peer": self.peer, "optimizer": self.model,
                 "peer_optimizer": self.peer}
        out["slices"] = {k: getattr(m, "model_plan", None) or {}
                         for k, m in plans.items() if m is not None}
        out["model_group"] = self.mesh.model_group \
            if self.mesh.model > 1 else None
        return out

    def use_device_cache(self, spec: AlgorithmSpec,
                         loaders: Dict[str, Any]) -> None:
        """``dataset.device_cache``: upload the train split to the device
        and put index loaders in ``loaders`` in place of the labeled and
        unlabeled stream loaders (closed), when the plan runs every train
        augmentation on the device; else say why and stream."""
        from ..data.device_cache import DeviceCache, plan_allows_device_cache

        reason = plan_allows_device_cache(self.config, spec)
        if reason is not None:
            log(f"device_cache disabled: {reason}", force=True)
            return
        self.cache = DeviceCache.build(loaders, self.device)
        for name, loader in self.cache.index_loaders.items():
            loaders[name].close()
            loaders[name] = loader
        log(f"device_cache: {self.cache.bytes_uploaded / 1e6:.1f} MB raw "
            f"prefix resident on {self.device}; steps ship indices only")

    def train_step(self, batch: Dict[str, torch.Tensor]
                   ) -> Dict[str, torch.Tensor]:
        """One step on a device batch (an index batch under the device
        cache); advances the step counter. Under ``train.scan_steps`` > 1
        on a card, the captured step (eager up to the run's first update,
        which the capture follows)."""
        if self.capture:
            if self.captured is None:
                self.captured = capture.CapturedStep(self)
            return self.captured.step(batch)
        return self.eager_step(batch)

    @property
    def optimizers(self) -> list:
        """The optimizer, and the peer's where the algorithm keeps one."""
        return [o for o in (self.optimizer, self.peer_optimizer)
                if o is not None]

    def eager_step(self, batch: Dict[str, torch.Tensor]
                   ) -> Dict[str, torch.Tensor]:
        """:meth:`reseed`, :meth:`device_step`, count the step. Under
        ``debug.nan_checks`` a NaN a backward op returns raises
        ``FloatingPointError`` (in one process anomaly mode's error at the
        op, raised from; under a process group ``nan_checks.BackwardNans``'
        find, at the gradient check, when every rank's backward has run),
        and a NaN in the metrics raises after the step."""
        self.reseed()
        if not self.nan_checks:
            metrics = self.device_step(batch)
            self.step += 1
            return metrics
        if pdist.get_world_size() > 1:
            with nans.BackwardNans() as self._backward_nans:
                try:
                    metrics = self.device_step(batch)
                finally:
                    self._backward_nans = None
        else:
            try:
                with torch.autograd.set_detect_anomaly(True):
                    metrics = self.device_step(batch)
            except RuntimeError as e:
                if not nans.is_anomaly(e):
                    raise
                raise FloatingPointError(
                    f"debug.nan_checks: train step {self.step}: {e}") from e
        self.step += 1
        nans.check_metrics(metrics, self.step - 1)
        return metrics

    def _check_grads(self) -> None:
        """``debug.nan_checks`` at the entry of the step's first optimizer
        step (every backward of the step done, CPS's two included): the
        gradients' flags over every rank, with the backward ops' find under
        a group, which raise here, or under a capture end the step's first
        graph (``utils/captured_step.CapturedStep.split``)."""
        if self._grads_checked:
            return
        self._grads_checked = True
        found = self._backward_nans
        flags = nans.grad_flags(self.optimizers,
                                None if found is None else found.any())
        if self.device.type == "cuda" and \
                torch.cuda.is_current_stream_capturing():
            self.captured.split(flags)
            return
        nans.raise_for_grads(flags, self.optimizers, self.step,
                             rerun_of=self.nan_rerun,
                             at_op=None if found is None else found.first())

    def generators(self) -> list:
        """The step's generators: dropout, the teacher's, the peer's, the
        loss's, the augmentation's (those the run has)."""
        return [g for g in (self.dropout_gen, self.teacher_gen,
                            self.peer_gen, self.loss_gen, self.augment_gen)
                if g is not None]

    def reseed(self) -> None:
        """Seed each generator for step :attr:`step`, from ``(seed,
        step)`` and its stream."""
        self.dropout_gen.manual_seed(step_seed(self.seed, self.step))
        if self.teacher_gen is not None:
            self.teacher_gen.manual_seed(step_seed(self.seed, self.step,
                                                   TEACHER_STREAM))
        if self.peer_gen is not None:
            self.peer_gen.manual_seed(step_seed(
                self.seed + PEER_SEED_OFFSET, self.step))
        self.loss_gen.manual_seed(step_seed(self.seed, self.step,
                                            LOSS_STREAM))
        if self.augment_gen is not None:
            self.augment_gen.manual_seed(step_seed(
                self.seed + AUGMENT_SEED_OFFSET, self.step))

    def device_step(self, batch: Dict[str, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
        """A step's device work on a batch, with the generators seeded: the
        cache's rows, the augmentation, the algorithm's step (what a
        captured step holds)."""
        self._grads_checked = False
        if self.cache is not None:
            batch = self.cache.materialize(batch)
        if self.augment is not None:
            batch = self.augment(self.augment_gen, batch)
        # under the seq axis, this seq rank's block of the time axis
        batch, length = seq_shard.split_batch(batch)
        with seq_shard.time_sharded(length):
            return self.inner_step(batch)


def run_training(config: Dict[str, Any], spec: AlgorithmSpec,
                 output_subdir: Optional[str] = None,
                 unlabeled_subset_ids=None, snapshot_epochs=(),
                 state_hook: Optional[Callable[[Trainer], None]] = None
                 ) -> None:
    """End-to-end training: epochs of steps, per-epoch validation, best
    checkpoints and ``log.txt``. ST++'s stages add ``output_subdir`` (the
    run's files go there, under the experiment directory),
    ``unlabeled_subset_ids`` (the unlabeled rows to train on),
    ``snapshot_epochs`` (after epoch ``e - 1``, for each ``e`` in it, a
    ``checkpoint-{e}.ckpt``) and ``state_hook`` (called with the built
    Trainer). Rank 0 writes the files; every rank returns after them."""
    pdist.init_distributed_mode(config.get("ddp"), config.get("device"))
    backend = checkpoint_backend(config)
    async_write = bool(config.get("async_checkpoint", True))
    pmesh.make_mesh(config)
    config = seq_parallel_config(config)
    device = resolve_device(config)
    main = pdist.is_main_process()
    log(f"job dir: {os.getcwd()}")
    log(yaml.dump(config, default_flow_style=False, sort_keys=False))
    seed = config["seed"]

    loaders = build_train_loaders(config, spec, unlabeled_subset_ids)
    steps_per_epoch = len(loaders["labeled"])
    if steps_per_epoch <= 0:
        raise ValueError("empty train loader")
    out_dir = experiment_dir(config)
    if out_dir and output_subdir:
        out_dir = os.path.join(out_dir, output_subdir)
    log_writer = None
    if out_dir and main:
        os.makedirs(out_dir, exist_ok=True)
        log_writer = TensorBoardWriter(out_dir)
    jsonl = JsonlLogger(out_dir if main else None)

    resolve_lr(config, pmesh.data_parallel_size())
    eff = config["train"]["eff_batch_size"]
    updates = updates_per_epoch(config, steps_per_epoch)
    log(f"base lr: {config['train']['lr'] * 256 / eff}")
    log(f"actual lr: {config['train']['lr']}")
    log(f"accumulate grad iterations: {accum_iter(config)}")
    log(f"effective batch size: {eff}")

    num_classes = config["metric"]["num_classes"]
    metric_fn, best_metrics = build_metric_fn(config["metric"])
    num_epochs = config["train"]["epochs"]
    best_loss = float("inf")
    lr_fn = make_lr_schedule(config["train"], updates)
    nan_checks = nans.enabled(config)
    try:
        with full_fp32():
            trainer = Trainer(config, spec, device, updates)
            if config["dataset"].get("device_cache", False):
                trainer.use_device_cache(spec, loaders)
            if state_hook is not None:
                state_hook(trainer)
            if trainer.resume_best:
                # the thresholds from before the restart: the first resumed
                # epoch must not overwrite the real best-*.ckpt files
                best_loss = trainer.resume_best.get("loss", best_loss)
                for k, v in trainer.resume_best.items():
                    if k in best_metrics:
                        best_metrics[k] = v
                log(f"Resume: best-checkpoint thresholds restored: "
                    f"{trainer.resume_best}")
            log(f"Start training for {num_epochs} epochs on {device}"
                f" (seed {seed}, {pdist.get_world_size()} rank(s))")
            start_time = time.time()
            for epoch in range(config.get("start_epoch", 0), num_epochs):
                for name in ("labeled", "unlabeled"):
                    if name in loaders:
                        loaders[name].set_epoch(epoch)
                train_stats = _train_one_epoch(
                    trainer, loaders, spec, epoch, steps_per_epoch, lr_fn,
                    log_writer)
                # a window open at the epoch's end: every rank holds the
                # ranks' mean partial sum, the one rank 0's checkpoint keeps
                # (eager, between replays, into a captured run's fixed
                # gradients)
                for opt in trainer.optimizers:
                    opt.average_window_()
                valid_stats, metrics, _, _ = evaluate(
                    trainer.model, loaders["valid"], metric_fn,
                    num_classes, device, trainer.amp,
                    collect_outputs=False,
                    nan_checks=f"epoch {epoch}'s validation"
                    if nan_checks else None)
                curr_loss = valid_stats["loss"]

                save_paths = []
                if out_dir and (epoch + 1) in snapshot_epochs:
                    save_paths.append(os.path.join(
                        out_dir, f"checkpoint-{epoch + 1}.ckpt"))
                if out_dir and curr_loss < best_loss:
                    best_loss = curr_loss
                    save_paths.append(os.path.join(out_dir,
                                                   "best-loss.ckpt"))
                for metric_name, metric_obj in metric_fn.items():
                    if metric_obj.per_class:
                        continue
                    curr = metrics[metric_name]
                    log(f"{metric_name}: {curr:.3f}")
                    if out_dir and is_best_metric(
                            metric_obj, best_metrics[metric_name], curr):
                        best_metrics[metric_name] = curr
                        save_paths.append(os.path.join(
                            out_dir, f"best-{metric_name}.ckpt"))
                    log(f"Best {metric_name}: "
                        f"{best_metrics[metric_name]:.3f}")
                if save_paths:
                    _save(trainer, save_paths, epoch, config, backend,
                          async_write, main,
                          metrics={"loss": curr_loss, **metrics},
                          best={"loss": best_loss, **best_metrics})

                if log_writer is not None:
                    log_writer.add_scalar("perf/valid_loss", curr_loss,
                                          epoch)
                    for k, v in metrics.items():
                        log_writer.add_scalar(f"perf/{k}", v, epoch)
                    log_writer.flush()
                jsonl.write({
                    **{f"train_{k}": v for k, v in train_stats.items()},
                    **{f"valid_{k}": v for k, v in valid_stats.items()},
                    **metrics,
                    "epoch": epoch,
                    "wall_s": round(time.time() - start_time, 3),
                })
            ckpt.wait_for_pending()
            total = str(datetime.timedelta(
                seconds=int(time.time() - start_time)))
            log(f"Training time {total}")
        # the other ranks read what rank 0 wrote only once it is there
        pdist.barrier()
    finally:
        for loader in loaders.values():
            loader.close()
        if log_writer is not None:
            log_writer.close()


def _save(trainer: Trainer, paths, epoch: int, config: Dict[str, Any],
          backend: str, async_write: bool, main: bool, **extra) -> None:
    """Write one checkpoint to ``paths``: a pickle of the gathered state
    from rank 0 (the model axis's slices and ZeRO-1's shares gathered on
    every rank first), or the directory, every rank writing its part."""
    kwargs = dict(config=config, step=trainer.step, async_write=async_write,
                  backend=backend, **extra)
    if backend == "orbax":
        ckpt.save_checkpoint(paths, epoch, **kwargs,
                             **trainer.local_checkpoint_state())
        return
    states = trainer.checkpoint_state()
    if main:
        ckpt.save_checkpoint(paths, epoch, **kwargs, **states)


def _train_one_epoch(trainer: Trainer, loaders, spec: AlgorithmSpec,
                     epoch: int, steps_per_epoch: int, lr_fn,
                     log_writer) -> Dict[str, float]:
    accum = trainer.optimizer.accum
    logger = MetricLogger()
    pending = []  # (iteration, device metrics), drained at PRINT_FREQ
    t_epoch = time.time()
    t_last = time.time()
    data_wait = 0.0
    profiler = ProfileSchedule(trainer.config.get("profile"), trainer.device,
                               pdist.get_rank())

    def drain():
        nonlocal pending
        if not pending:
            return
        keys = list(pending[0][1])
        # the global batch's metrics: every rank sees the same values and
        # so aborts on a non-finite loss together
        host = pdist.all_reduce_mean(torch.stack([
            torch.stack([m[k].float() for k in keys])
            for _, m in pending])).cpu().tolist()
        for (i, _), values in zip(pending, host):
            scalars = dict(zip(keys, values))
            if not math.isfinite(scalars.get("loss",
                                             scalars.get("loss_total", 0.0))):
                log(f"Loss is {scalars}, stopping training")
                # the pending writes all predate this epoch's checkpoint
                # decisions: flush them and name the last that landed
                ckpt.wait_for_pending()
                last_good = ckpt.last_written_checkpoint()
                if last_good:
                    log(f"Last good checkpoint: {last_good}")
                sys.exit(1)
            global_step = epoch * steps_per_epoch + i
            scalars["lr"] = float(lr_fn(global_step // accum))
            logger.update(**scalars)
            if log_writer is not None and (global_step + 1) % accum == 0:
                epoch_1000x = int((epoch + i / steps_per_epoch) * 1000)
                for k, v in scalars.items():
                    log_writer.add_scalar(k, v, epoch_1000x)
        pending = []

    def progress(it):
        per_it = (time.time() - t_epoch) / (it + 1)
        eta = str(datetime.timedelta(
            seconds=int(per_it * (steps_per_epoch - it - 1))))
        mem = device_memory_mb(trainer.device)
        mem_part = f"  max mem: {mem:.0f}MB" if mem is not None else ""
        log(f"Epoch: [{epoch}]  [{it + 1}/{steps_per_epoch}]  "
            f"eta: {eta}  {logger}  time: {per_it:.4f}  "
            f"data: {data_wait / (it + 1):.4f}{mem_part}")

    # units of scan_steps stacked batches, each uploaded at once (the tail
    # one batch a unit)
    units = capture.stacked_units(combined_batches(loaders, spec),
                                  trainer.scan_steps)
    it = -1  # the last step taken
    for unit in prefetched(units, trainer.device):
        data_wait += time.time() - t_last
        first = it + 1
        for j in range(capture.unit_steps(unit)):
            it += 1
            profiler.step(epoch * steps_per_epoch + it)
            pending.append((it, trainer.train_step(
                capture.unit_slice(unit, j))))
        if (it + 1) // PRINT_FREQ != first // PRINT_FREQ \
                or it == steps_per_epoch - 1:
            drain()
            progress(it)
        t_last = time.time()
    drain()
    profiler.close()
    log(f"Averaged stats: {logger}")
    return logger.stats()


# ---------------------------------------------------------------------------
# Test and inference entries
# ---------------------------------------------------------------------------


def shard_for_mesh(model: torch.nn.Module) -> torch.nn.Module:
    """``model`` sliced over the current mesh's model axis
    (``parallel/sharding_rules.shard_module_``) when it has one, else as it
    is; returns it."""
    mesh = pdist.current_mesh()
    if mesh is not None and mesh.model > 1:
        shard_module_(model, mesh)
    return model


def load_eval_weights(model: torch.nn.Module, checkpoint_path: str) -> None:
    """Restore a checkpoint's ``model`` (a JAX or port ``.ckpt`` or a torch
    ``.pth``) into an eval build, strictly; auxiliary-head weights of a
    training checkpoint are dropped, as the JAX package drops them."""
    payload = ckpt.load_checkpoint(checkpoint_path)
    state = {k: v for k, v in ckpt.model_state_dict(
        payload["model"], model.state_dict().keys()).items()
             if not k.startswith("auxiliary_heads.")}
    model.load_state_dict(state)


def load_eval_model(config: Dict[str, Any],
                    device: torch.device) -> torch.nn.Module:
    """Build the eval-mode serving model (``quantize: int8`` honoured) and
    restore the requested checkpoint (``test.model_path``, else
    ``best-{target_metric}.ckpt`` in the experiment directory) with
    :func:`load_eval_weights`; sliced over the model axis of the current
    mesh (:func:`shard_for_mesh`)."""
    model = build_model_from_config(config, serving=True)
    if test_cfg(config).get("model_path", None):
        checkpoint_path = config["test"]["model_path"]
    else:
        target_metric = test_cfg(config).get("target_metric", "loss")
        checkpoint_path = os.path.join(experiment_dir(config),
                                       f"best-{target_metric}.ckpt")
    if not os.path.exists(checkpoint_path):
        raise FileNotFoundError(f"Checkpoint not found: {checkpoint_path}")
    load_eval_weights(model, checkpoint_path)
    log(f"Loaded checkpoint {checkpoint_path}")
    return shard_for_mesh(model.to(device).eval())


def eval_loader(config: Dict[str, Any], dataset, mode: str = "test"):
    """An evaluation loader of ``dataset``, sharded over the ranks."""
    num_shards = pmesh.data_parallel_size()
    return get_dataloader(
        dataset, mode=mode, batch_size=config["dataloader"]["batch_size"],
        seed=config["seed"], num_shards=num_shards,
        num_workers=loader_workers(config["dataloader"]),
        worker_type=loader_worker_type(config["dataloader"]),
        **pmesh.host_shard_args(num_shards))


def _test_loader(config: Dict[str, Any]):
    ds_test = build_seg_dataset(config["dataset"], split="test")
    return ds_test, eval_loader(config, ds_test)


def run_test(config: Dict[str, Any],
             nan_checks: bool = False) -> Dict[str, float]:
    """Evaluate the best checkpoint on the test split and write
    ``test_metrics.csv`` (the ``csv`` module, values as ``%.4f``),
    ``test_outputs.npy`` and ``test_labels.npy`` (rank 0; each rank
    evaluates its shards). The forward runs in the config's precision, as
    the JAX package's test pass does. ``nan_checks``: the ``test: true``
    pass of a ``debug.nan_checks`` training run (``cli.train_main``),
    where a NaN output raises ``FloatingPointError``."""
    pdist.init_distributed_mode(config.get("ddp"), config.get("device"))
    pmesh.make_mesh(config)
    device = resolve_device(config)
    out_dir = experiment_dir(config) if pdist.is_main_process() else None
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    _, loader = _test_loader(config)
    metric_fn, _ = build_metric_fn(config["metric"])
    num_classes = config["metric"]["num_classes"]
    try:
        with full_fp32():
            model = load_eval_model(config, device)
            test_stats, metrics, outputs, labels = evaluate(
                model, loader, metric_fn, num_classes, device,
                amp_context(config, device),
                eval_batch_size=config["dataloader"]["batch_size"],
                nan_checks="the test pass" if nan_checks else None)
    finally:
        loader.close()
    metrics = dict(metrics)
    metrics["loss"] = test_stats["loss"]
    if out_dir:
        with open(os.path.join(out_dir, "test_metrics.csv"), "w",
                  newline="") as f:
            writer = csv.writer(f)
            writer.writerow(list(metrics))
            writer.writerow([f"{v:.4f}" for v in metrics.values()])
        np.save(os.path.join(out_dir, "test_outputs.npy"), outputs)
        np.save(os.path.join(out_dir, "test_labels.npy"), labels)
    log("Done!")
    return metrics


def run_inference(config: Dict[str, Any]) -> np.ndarray:
    """Softmax of ``seg_logits`` over the test split, in dataset order →
    ``test_outputs.npy`` (no labels, no metrics; rank 0 writes, each rank
    serves its shards), through :func:`serving.make_serving_fn` and so in
    its precision."""
    # serving imports this module: import it when called
    from ..serving import make_serving_fn

    pdist.init_distributed_mode(config.get("ddp"), config.get("device"))
    pmesh.make_mesh(config)
    infer, _ = make_serving_fn(config)
    out_dir = experiment_dir(config) if pdist.is_main_process() else None
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    ds_test, loader = _test_loader(config)

    outputs = None
    mat = loader.step_indices()
    try:
        for step, batch in enumerate(loader):
            x = torch.from_numpy(batch["ecg"]).to(infer.device)
            # under the seq axis: this rank's block, gathered whole
            probs = seq_shard.sharded_call(infer, x).cpu().numpy()
            if outputs is None:
                outputs = np.zeros((len(ds_test),) + probs.shape[1:],
                                   np.float32)
            outputs[mat[step].reshape(-1)] = probs
    finally:
        loader.close()
    pdist.all_gather_rows(mat.reshape(-1), [outputs])
    if out_dir:
        np.save(os.path.join(out_dir, "test_outputs.npy"), outputs)
    log("Done!")
    return outputs
