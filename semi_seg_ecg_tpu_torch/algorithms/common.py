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
  (``utils/optimizer.py``);
- drains the step metrics every ``PRINT_FREQ`` steps, their mean over the
  ranks, aborting on a non-finite loss (every rank at once), and prints
  the progress line;
- evaluates the model (the student, CPS's model 1) after each epoch, each
  rank on its shards of the split, the rows exchanged
  (``parallel.dist.all_gather_rows``), and writes ``best-loss.ckpt`` /
  ``best-{metric}.ckpt`` (teacher or peer included) and a ``log.txt``
  line, on rank 0 only.

Data parallelism as the JAX package's data mesh computes it: rank 0's
weights are broadcast at the start, each step's gradients averaged over
the ranks before clipping (``utils/optimizer.TrainOptimizer``), BatchNorm
statistics taken over the global batch (``models/norm.py``) and per-row
random draws made for the global batch (``parallel.dist.global_rows``).
N ranks with ``batch_size`` b take the steps of one process holding N
shards of b rows (the loader's ``num_shards=N, local_shards=N``).

For ST++'s stages, :func:`run_training` also takes an output subdirectory,
a subset of the unlabeled rows, the epochs after which it writes
``checkpoint-{epoch + 1}.ckpt`` snapshots, and a hook that gets the built
:class:`Trainer` (it loads the stage teacher).

``mode`` other than ``scratch`` warm-starts the backbone of the model (and
of the peer) from ``pretrained_backbone`` (:func:`load_pretrained_backbone`);
``debug.nan_checks`` runs training under autograd's anomaly detection, the
counterpart of ``jax_debug_nans`` (slow, for debugging); ``async_checkpoint``
writes synchronously (``utils/checkpoint.save_checkpoint``).

Precision: the whole run is full fp32 (no TF32 in cuBLAS and cuDNN,
``full_fp32``; the flash kernels form fp32 products from three TF32
products each, 3xTF32 with fp32 accumulation, to fp32 accuracy, which
``full_fp32`` does not govern); with
``precision: bf16`` the forwards and losses run under bf16 autocast, with
fp32 parameters and optimizer and no loss scaling, as the JAX package
computes in bf16 with fp32 parameters. ``train.fused_state`` and
``train.scan_steps`` are accepted and do nothing (XLA dispatch devices).
Resume, gradient accumulation, ``device_cache``, ``parallel.model_parallel``
and ``seq_parallel`` above 1, ``parallel.shard_optimizer`` (ZeRO-1) across
ranks, ``checkpoint_backend: orbax`` and ``profile`` are not ported yet and
raise.
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
from ..utils import checkpoint as ckpt
from ..utils.logging import JsonlLogger, MetricLogger, TensorBoardWriter, log
from ..utils.optimizer import build_optimizer, make_lr_schedule, resolve_lr
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


def amp_context(config: Dict[str, Any], device: torch.device) -> Callable:
    """A factory of the config's compute-precision context: bf16 (or fp16)
    autocast, or nothing at fp32."""
    dtype = compute_dtype(config)
    enabled = dtype != torch.float32
    return lambda: torch.autocast(device.type, dtype=dtype, enabled=enabled)


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


def _refuse_unported(config: Dict[str, Any], world_size: int) -> None:
    if config.get("resume"):
        raise NotImplementedError(
            "resume is not yet ported to the torch package")
    parallel = config.get("parallel") or {}
    for axis in ("model_parallel", "seq_parallel"):
        if (parallel.get(axis) or 1) > 1:
            raise NotImplementedError(
                f"parallel.{axis} > 1 is not yet ported to the torch "
                "package")
    if parallel.get("shard_optimizer") and world_size > 1:
        # the JAX package shards the optimizer only over more than one
        # data-parallel replica
        raise NotImplementedError(
            "parallel.shard_optimizer (ZeRO-1) is not yet ported to the "
            "torch package")
    if (config["train"].get("accum_iter", 1) or 1) > 1:
        raise NotImplementedError(
            "train.accum_iter > 1 is not yet ported to the torch package")
    if config["dataset"].get("device_cache", False):
        raise NotImplementedError(
            "dataset.device_cache is not yet ported to the torch package")
    if config.get("checkpoint_backend", "pickle") not in ("pickle", None):
        raise NotImplementedError(
            f"checkpoint_backend: {config['checkpoint_backend']!r} is not "
            "yet ported to the torch package, which writes pickle .ckpt "
            "files (the JAX package reads them); an orbax checkpoint "
            "converts with `python tools/convert_checkpoint.py to-torch`")
    if config.get("profile"):
        raise NotImplementedError(
            "profile (the training trace schedule) is not yet ported to the "
            "torch package")


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
    weak/strong views (``ecg_u_w``/``ecg_u_s``)."""
    if not spec.uses_unlabeled:
        yield from loaders["labeled"]
        return
    for labeled, unlabeled in zip(loaders["labeled"], loaders["unlabeled"]):
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
              num_classes: int) -> Dict[str, torch.Tensor]:
    """Softmax probabilities, per-sample CE and per-class counts of one
    batch, from an eval-mode forward (the caller sets mode and autocast)."""
    logits = model(x)["seg_logits"].float()
    probs = torch.softmax(logits, dim=1)
    preds = torch.argmax(probs, dim=1)
    inter, psum, tsum = segmentation_stats(preds, labels, num_classes)
    loss = per_sample_cross_entropy(logits, labels)
    return {"probs": probs, "loss": loss, "inter": inter, "psum": psum,
            "tsum": tsum}


def evaluate(model: torch.nn.Module, loader, metric_fn, num_classes: int,
             device: torch.device, amp: Callable,
             eval_batch_size: Optional[int] = None,
             collect_outputs: bool = True):
    """Full-dataset evaluation, each rank on the shards its ``loader``
    holds, the rows then exchanged so that every rank has all of them.
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
                                num_classes)
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


def device_memory_mb(device: torch.device) -> Optional[float]:
    if device.type != "cuda":
        return None
    return torch.cuda.max_memory_allocated(device) / 2 ** 20


class Trainer:
    """The state of one run: model and optimizer, the Mean Teacher's
    ``teacher`` or the CPS ``peer`` and ``peer_optimizer`` where the
    algorithm keeps one, the generators, and the per-step function, so
    that a caller (the training loop, a test, a profile) can run single
    steps. ``model`` / ``peer`` given are used as they are (no warm
    start); else they are initialised from ``seed`` / ``seed + 10_000``."""

    def __init__(self, config: Dict[str, Any], spec: AlgorithmSpec,
                 device: torch.device, updates_per_epoch: int,
                 model: Optional[torch.nn.Module] = None,
                 peer: Optional[torch.nn.Module] = None):
        self.config = config
        self.device = device
        self.seed = config["seed"]
        self.model = model if model is not None else init_train_model(
            config, device, self.seed)
        self.optimizer = build_optimizer(config, self.model,
                                         updates_per_epoch)
        self.amp = amp_context(config, device)
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
        self.dropout_gen = torch.Generator(device=device)
        use_generator(self.model, self.dropout_gen)
        self.loss_gen = torch.Generator(device=device)
        self.inner_step = spec.make_train_step(self)
        self.augment = None
        self.augment_gen = None
        if config["dataset"].get("device_augment", False):
            from ..ops.preprocess import plan_device_augment

            plan = plan_device_augment(config["dataset"])
            log(f"device_augment: {plan.summary}")
            if plan.augment is not None:
                self.augment = plan.augment
                self.augment_gen = torch.Generator(device=device)
        # every rank starts from rank 0's weights (warm starts included)
        for module in (self.model, self.teacher, self.peer):
            if module is not None:
                pdist.broadcast_module_(module)
        self.step = 0

    def train_step(self, batch: Dict[str, torch.Tensor]
                   ) -> Dict[str, torch.Tensor]:
        """One step on a device batch; advances the step counter."""
        self.dropout_gen.manual_seed(step_seed(self.seed, self.step))
        if self.teacher_gen is not None:
            self.teacher_gen.manual_seed(step_seed(self.seed, self.step,
                                                   TEACHER_STREAM))
        if self.peer_gen is not None:
            self.peer_gen.manual_seed(step_seed(
                self.seed + PEER_SEED_OFFSET, self.step))
        self.loss_gen.manual_seed(step_seed(self.seed, self.step,
                                            LOSS_STREAM))
        if self.augment is not None:
            self.augment_gen.manual_seed(step_seed(
                self.seed + AUGMENT_SEED_OFFSET, self.step))
            batch = self.augment(self.augment_gen, batch)
        metrics = self.inner_step(batch)
        self.step += 1
        return metrics


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
    _refuse_unported(config, pdist.get_world_size())
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
    log(f"base lr: {config['train']['lr'] * 256 / eff}")
    log(f"actual lr: {config['train']['lr']}")
    log(f"effective batch size: {eff}")

    num_classes = config["metric"]["num_classes"]
    metric_fn, best_metrics = build_metric_fn(config["metric"])
    num_epochs = config["train"]["epochs"]
    best_loss = float("inf")
    lr_fn = make_lr_schedule(config["train"], steps_per_epoch)
    nan_checks = bool((config.get("debug") or {}).get("nan_checks", False))
    try:
        with full_fp32(), torch.autograd.set_detect_anomaly(nan_checks):
            trainer = Trainer(config, spec, device, steps_per_epoch)
            if state_hook is not None:
                state_hook(trainer)
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
                valid_stats, metrics, _, _ = evaluate(
                    trainer.model, loaders["valid"], metric_fn,
                    num_classes, device, trainer.amp,
                    collect_outputs=False)
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
                if save_paths and main:
                    ckpt.save_checkpoint(
                        save_paths, epoch, trainer.model,
                        trainer.optimizer, config=config,
                        metrics={"loss": curr_loss, **metrics},
                        best={"loss": best_loss, **best_metrics},
                        step=trainer.step, ema_model=trainer.teacher,
                        peer_model=trainer.peer,
                        peer_optimizer=trainer.peer_optimizer)

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


def _train_one_epoch(trainer: Trainer, loaders, spec: AlgorithmSpec,
                     epoch: int, steps_per_epoch: int, lr_fn,
                     log_writer) -> Dict[str, float]:
    logger = MetricLogger()
    pending = []  # (iteration, device metrics), drained at PRINT_FREQ
    t_epoch = time.time()
    t_last = time.time()
    data_wait = 0.0

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
                sys.exit(1)
            update_step = epoch * steps_per_epoch + i
            scalars["lr"] = float(lr_fn(update_step))
            logger.update(**scalars)
            if log_writer is not None:
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

    it = -1
    for batch in prefetched(combined_batches(loaders, spec), trainer.device):
        data_wait += time.time() - t_last
        it += 1
        pending.append((it, trainer.train_step(batch)))
        if (it + 1) % PRINT_FREQ == 0 or it == steps_per_epoch - 1:
            drain()
            progress(it)
        t_last = time.time()
    drain()
    log(f"Averaged stats: {logger}")
    return logger.stats()


# ---------------------------------------------------------------------------
# Test and inference entries
# ---------------------------------------------------------------------------


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
    :func:`load_eval_weights`."""
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
    return model.to(device).eval()


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


def run_test(config: Dict[str, Any]) -> Dict[str, float]:
    """Evaluate the best checkpoint on the test split and write
    ``test_metrics.csv`` (the ``csv`` module, values as ``%.4f``),
    ``test_outputs.npy`` and ``test_labels.npy`` (rank 0; each rank
    evaluates its shards). The forward runs in the config's precision, as
    the JAX package's test pass does."""
    pdist.init_distributed_mode(config.get("ddp"), config.get("device"))
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
                eval_batch_size=config["dataloader"]["batch_size"])
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
            probs = infer(x).cpu().numpy()
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
