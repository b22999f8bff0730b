"""Checkpoints (counterpart of ``semi_seg_ecg_tpu/utils/checkpoint.py``).

Two formats come in:

- a ``.ckpt``: a pickle with NumPy leaves. The JAX package writes ``{epoch,
  model: {params, batch_stats}, config, ...}``; the port's trainer writes
  :func:`save_checkpoint`'s ``{epoch, step, model: <flat state_dict>,
  optimizer, config, metrics, best}``, with Mean Teacher's ``model_ema``
  and CPS's ``model_peer`` / ``peer_optimizer`` under the JAX package's
  payload keys. Either is read with an unpickler
  that admits only NumPy's array and dtype constructors, so a file that
  names a JAX class (or anything else) is refused rather than imported;
  JAX ``model`` trees go through ``utils/weights.py``. A flat state_dict
  is the JAX package's torch format, so its ``load_checkpoint`` and
  ``restore_model_state`` read the port's files as they are;
- a torch ``.pth`` in the reference layout, ``{model: state_dict, ...}``,
  which is what :func:`save_torch_checkpoint` writes and what the JAX
  package's own ``.pth`` loader reads.

``checkpoint_backend: orbax`` writes the same payload as a directory of
the same name (``best-loss.ckpt/``) through ``torch.distributed.checkpoint``
(DCP), every rank writing what it holds: its ZeRO-1 share of the optimizer
state (whole parameters, keyed by name), its model-axis slices as DTensors
on a mesh over its model group, and each replicated tensor once, from the
lowest rank that holds it (the copy the pickle file holds). Everything but
tensors (epoch, step, config, metrics, best, each network's key order and
the optimizers' groups, ``count`` and ``micro_step``) is the sidecar
``sidecar.pkl``, which rank 0 writes and the NumPy-only unpickler reads.
The layout does not depend on the writer's: each tensor has its unsliced
shape, except the fused q/k/v rows, which are stored as ``(3, rows / 3,
...)`` so that a model rank's heads are one block of dimension 1. So a
directory written at any ``(data, model)`` layout, with ZeRO-1 or not,
loads whole in one process (:func:`load_checkpoint` gives the pickle
file's payload) and resumes at any other. The write is atomic: a
temporary directory, DCP's closing collective (after which every rank's
files and the metadata are there), then rank 0 renames it. A JAX orbax
directory (no DCP ``.metadata``) is refused with the converter's name:
the port does not read orbax.

The writer. With ``async_write`` (``async_checkpoint``, on by default as
in the JAX package) :func:`save_checkpoint` snapshots the state before it
returns and one ordered writer thread, behind a queue of 2, writes it:
the trainer updates its tensors in place, so the snapshot is a
non-blocking device-to-host copy into pinned host memory on the current
stream, whose event the writer thread waits on before it reads the copy
(a CPU tensor is cloned). The snapshot holds no device memory; at most
four host copies of the state are alive at once (two queued, one being
written, one waiting for room). A file written this way equals the
synchronous file of the same call byte for byte. :func:`wait_for_pending`
flushes the queue (also at exit); :func:`last_written_checkpoint` names
the last file whose rename landed, and a write that fails on the thread
is logged and leaves it on the file before. Under the directory backend
the writer thread runs the whole DCP save, plan, files and metadata, on a
gloo group of its own, so every rank takes part in DCP's collective plan
in the order of its queue while the training loop's collectives go on.

:func:`maybe_resume` restarts a run (``resume:`` / ``--resume``) from any
of them: the port's own ``.ckpt`` or directory restores everything it
holds, a JAX ``.ckpt`` its trees and, through ``utils/optim_state.py``,
its optax state, a ``.pth`` the model only.
"""

from __future__ import annotations

import atexit
import copy
import os
import pickle
import queue
import shutil
import threading
import traceback
import warnings
from typing import Any, Callable, Collection, Dict, Optional, Sequence, Union

import numpy as np
import torch

from .logging import log
from .optim_state import load_optax_leaves
from .weights import jax_trees_to_state_dict

# what a NumPy-leaved pickle may name: array and scalar reconstruction,
# dtypes (numpy >= 2 moved numpy.core to numpy._core)
_NUMPY_MODULES = ("numpy", "numpy.core.multiarray", "numpy._core.multiarray",
                  "numpy.core.numeric", "numpy._core.numeric")
_NUMPY_NAMES = ("_reconstruct", "_frombuffer", "ndarray", "dtype", "scalar")

# the directory backend's files: DCP's metadata and the sidecar
DCP_METADATA = ".metadata"
SIDECAR = "sidecar.pkl"
NETWORKS = ("model", "model_ema", "model_peer")
OPTIMIZERS = ("optimizer", "peer_optimizer")
CONVERT_HINT = "`python tools/convert_checkpoint.py to-torch`"


class _NumpyOnlyUnpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str):
        if (module in _NUMPY_MODULES and name in _NUMPY_NAMES) or (
                module == "numpy.dtypes" and name.endswith("DType")):
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"checkpoint names {module}.{name}: only NumPy arrays and plain "
            "Python values can be read without the framework that wrote "
            "them")


def _read_numpy_pickle(path: str):
    with open(path, "rb") as f:
        return _NumpyOnlyUnpickler(f).load()


def load_checkpoint(path: str) -> Dict[str, Any]:
    """A checkpoint's payload: torch tensors for ``.pth``/``.pt``, NumPy
    trees for a pickle ``.ckpt`` and for the port's directory (the payload
    its pickle file would hold). Flushes this process's pending writes
    first. A JAX orbax directory is refused."""
    wait_for_pending()
    if path.endswith((".pth", ".pt")):
        return torch.load(path, map_location="cpu", weights_only=True)
    if os.path.isdir(path):
        if not os.path.exists(os.path.join(path, DCP_METADATA)):
            raise NotImplementedError(
                f"{path}: a JAX orbax directory checkpoint, which the torch "
                "package does not read (its directories are written by "
                "torch.distributed.checkpoint); convert it with "
                f"{CONVERT_HINT}")
        return _load_directory(path)
    return _read_numpy_pickle(path)


def model_state_dict(payload_model: Dict[str, Any],
                     target_keys: Optional[Collection[str]] = None
                     ) -> Dict[str, torch.Tensor]:
    """A checkpoint's ``model`` entry as the port's ``state_dict``: JAX
    ``{params, batch_stats}`` trees are translated (``target_keys``, the
    receiving model's keys, resolve the ResNet ``avg_down`` names), a flat
    state_dict (of tensors or NumPy arrays) is taken key for key."""
    if isinstance(payload_model, dict) and "params" in payload_model:
        return jax_trees_to_state_dict(payload_model["params"],
                                       payload_model.get("batch_stats", {}),
                                       target_keys)
    return {k: torch.as_tensor(v) for k, v in payload_model.items()}


# ---------------------------------------------------------------------------
# The writer thread
# ---------------------------------------------------------------------------

# one ordered writer: two writes to one path (best-loss.ckpt improving on
# consecutive epochs) must not race each other's temporary files, and the
# last one enqueued must win
_QUEUE: Optional[queue.Queue] = None
_WORKER: Optional[threading.Thread] = None
# the last checkpoint that fully landed: what the NaN abort names
_LAST_WRITTEN: Optional[str] = None
_LAST_WRITTEN_LOCK = threading.Lock()
_WORKER_LOCK = threading.Lock()


def _record_written(path: str) -> None:
    global _LAST_WRITTEN
    with _LAST_WRITTEN_LOCK:
        _LAST_WRITTEN = path


def last_written_checkpoint() -> Optional[str]:
    """The path of the last checkpoint whose write completed (an async
    write counts once its rename has landed), or None."""
    with _LAST_WRITTEN_LOCK:
        return _LAST_WRITTEN


def _ensure_worker() -> queue.Queue:
    """The writer's queue, the thread started by whichever thread saves
    first."""
    global _QUEUE, _WORKER
    with _WORKER_LOCK:
        if _WORKER is not None and _WORKER.is_alive():
            return _QUEUE
        # bounded: each entry holds a host copy of the whole state, so a
        # slow disk makes save_checkpoint wait rather than pile copies up
        jobs: queue.Queue = queue.Queue(maxsize=2)

        def loop():
            while True:
                job = jobs.get()
                try:
                    job()
                except Exception as e:  # logged, as in the JAX package
                    log(f"async checkpoint write failed: {e!r}\n"
                        f"{traceback.format_exc()}", force=True)
                finally:
                    jobs.task_done()

        _QUEUE = jobs
        _WORKER = threading.Thread(target=loop, daemon=True,
                                   name="ckpt-writer")
        _WORKER.start()
        return jobs


def wait_for_pending() -> None:
    """Block until every queued checkpoint write has landed (call before
    reading the files back)."""
    if _QUEUE is not None:
        backlog = _QUEUE.unfinished_tasks
        if backlog:
            log(f"flushing {backlog} pending checkpoint write(s)...")
        _QUEUE.join()


atexit.register(wait_for_pending)


class _Snapshot:
    """Host copies of a payload's tensors, taken when it is built: CUDA
    tensors copied without blocking into pinned memory on the current
    stream (:meth:`ready` waits for the copies), CPU tensors cloned."""

    def __init__(self, obj):
        self.event = None
        self.tree = self._copy(obj)
        if self.event is not None:
            self.event.record()

    def _copy(self, obj):
        if isinstance(obj, torch.Tensor):
            t = obj.detach()
            if t.is_cuda:
                if self.event is None:
                    self.event = torch.cuda.Event()
                host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                return host.copy_(t, non_blocking=True)
            return t.clone()
        if isinstance(obj, dict):
            return {k: self._copy(v) for k, v in obj.items()}
        if isinstance(obj, (list, tuple)):
            return type(obj)(self._copy(v) for v in obj)
        return copy.deepcopy(obj)

    def ready(self):
        """The host tree, once its copies have landed."""
        if self.event is not None:
            self.event.synchronize()
        return self.tree


def _to_numpy(obj):
    """Tensors → NumPy arrays, through dicts, lists and tuples."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, dict):
        return {k: _to_numpy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_numpy(v) for v in obj)
    return obj


def _state(optimizer) -> Dict[str, Any]:
    return optimizer if isinstance(optimizer, dict) else \
        optimizer.state_dict()


def _model_state(model) -> Dict[str, Any]:
    return model if isinstance(model, dict) else model.state_dict()


def _submit(job: Callable[[], None], async_write: bool) -> None:
    if async_write:
        _ensure_worker().put(job)
    else:
        job()


def save_checkpoint(path: Union[str, Sequence[str]], epoch: int,
                    model: Union[torch.nn.Module, Dict[str, Any]],
                    optimizer=None,
                    config: Optional[Dict[str, Any]] = None,
                    metrics: Optional[Dict[str, Any]] = None,
                    best: Optional[Dict[str, Any]] = None,
                    step: Optional[int] = None,
                    ema_model=None, peer_model=None,
                    peer_optimizer=None, async_write: bool = False,
                    backend: str = "pickle",
                    slices: Optional[Dict[str, Dict[str, Any]]] = None,
                    model_group=None) -> None:
    """Write one training checkpoint to each of ``path`` (one payload, one
    snapshot), atomically; with ``async_write`` through the writer thread
    (see the module's docstring), else before returning. The Mean
    Teacher's teacher goes under ``model_ema``, the CPS peer and its
    optimizer under ``model_peer`` and ``peer_optimizer``, each model a flat
    state_dict. A model is given as itself or as its state_dict, an
    optimizer as itself or as its ``state_dict()``.

    ``backend="pickle"`` writes a pickle with NumPy leaves, from rank 0, of
    the unsliced, unsharded state (``algorithms/common.Trainer.checkpoint_state``
    gathers it on every rank first). ``backend="orbax"`` writes the
    directory, and every rank calls it with what it holds
    (``Trainer.local_checkpoint_state``): its networks' state dicts (model
    axis slices where sliced), its optimizers' ``local_state_dict()``,
    ``slices`` (per payload key, the :class:`~..parallel.sharding_rules.Slice`
    of each sliced parameter by name) and the ``model_group`` they are
    sliced over."""
    paths = [path] if isinstance(path, str) else list(path)
    payload: Dict[str, Any] = {
        "epoch": epoch,
        "step": step,
        "model": _model_state(model),
        "config": config,
    }
    if optimizer is not None:
        payload["optimizer"] = _state(optimizer)
    if ema_model is not None:
        payload["model_ema"] = _model_state(ema_model)
    if peer_model is not None:
        payload["model_peer"] = _model_state(peer_model)
    if peer_optimizer is not None:
        payload["peer_optimizer"] = _state(peer_optimizer)
    if metrics is not None:
        payload["metrics"] = {k: float(v) for k, v in metrics.items()}
    if best is not None:
        payload["best"] = {k: float(v) for k, v in best.items()}
    snap = _Snapshot(payload)
    if backend == "orbax":
        group = _dcp_group()
        mesh = None if model_group is None else _cpu_mesh(model_group)
        _submit(lambda: _write_directory(paths, snap.ready(), slices or {},
                                         mesh, group), async_write)
        return
    if backend != "pickle":
        raise ValueError(f"unknown checkpoint backend {backend!r}")

    def write():
        data = _to_numpy(snap.ready())
        for p in paths:
            tmp = p + ".tmp"
            with open(tmp, "wb") as f:
                pickle.dump(data, f, protocol=pickle.HIGHEST_PROTOCOL)
            if os.path.isdir(p):  # a directory checkpoint of the same name
                shutil.rmtree(p)
            os.replace(tmp, p)  # atomic: no torn file on preemption
            _record_written(p)

    _submit(write, async_write)


# ---------------------------------------------------------------------------
# The directory backend (torch.distributed.checkpoint)
# ---------------------------------------------------------------------------

_GROUPS: Dict[Any, Any] = {}


def _quiet_single_process() -> None:
    """DCP warns on every call in one process, which is this backend's
    one-process case, not a mistake."""
    warnings.filterwarnings(
        "ignore", message="torch.distributed is disabled, unavailable or "
        "uninitialized", category=UserWarning)


def _dist_on() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized() and \
        dist.get_world_size() > 1


def _dcp_group():
    """The gloo group the directory saves run on, made once per process
    group on every rank (a collective), or None in one process."""
    if not _dist_on():
        return None
    import torch.distributed as dist

    key = ("dcp", id(dist.group.WORLD))
    if key not in _GROUPS:
        _GROUPS[key] = dist.new_group(backend="gloo")
    return _GROUPS[key]


def _cpu_mesh(group):
    """A CPU DeviceMesh over ``group``, for DTensors that describe host
    copies of a rank's slices (no collective runs on it)."""
    from torch.distributed.device_mesh import DeviceMesh

    key = ("mesh", id(group))
    if key not in _GROUPS:
        _GROUPS[key] = DeviceMesh.from_group(group, "cpu")
    return _GROUPS[key]


def _grouped(name: str) -> bool:
    """Whether parameter ``name``'s rows are the fused q/k/v projection's,
    stored as ``(3, rows / 3, ...)``."""
    return name.endswith(("attn.fn.to_qkv.weight", "attn.fn.to_qkv.bias"))


def _stored(name: str, t: torch.Tensor, spec, mesh):
    """``t`` (a rank's tensor of parameter ``name``) as the directory
    stores it: the q/k/v rows grouped, and a model-axis slice as a DTensor
    sharded over ``mesh`` on its sliced dimension."""
    grouped = _grouped(name) and t.dim() >= 1
    if grouped:
        t = t.unflatten(0, (3, -1))
    if spec is None or t.dim() <= spec.dim:
        return t
    from torch.distributed.tensor import DTensor, Shard

    dim = spec.dim + int(grouped)
    shape = list(t.shape)
    shape[dim] *= mesh.size()
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(t.contiguous(), mesh, [Shard(dim)],
                              run_check=False, shape=torch.Size(shape),
                              stride=stride)


def _split_directory_payload(payload: Dict[str, Any],
                             slices: Dict[str, Dict[str, Any]], mesh):
    """A rank's payload as DCP's flat state dict (``key/name[/field]``)
    and the sidecar's tensor-free rest."""
    tensors: Dict[str, Any] = {}
    meta: Dict[str, Any] = {}
    for key, value in payload.items():
        plan = slices.get(key, {})
        if key in NETWORKS:
            meta[key] = list(value)
            for name, t in value.items():
                tensors[f"{key}/{name}"] = _stored(name, t, plan.get(name),
                                                   mesh)
        elif key in OPTIMIZERS:
            meta[key] = {k: v for k, v in value.items()
                         if k not in ("state", "acc_grads")}
            # a TrainOptimizer's local state is keyed by parameter name, a
            # torch optimizer's state_dict by index
            for name, entry in value["state"].items():
                name = str(name)
                for field, t in entry.items():
                    if not torch.is_tensor(t):
                        raise TypeError(
                            f"{key} state {name}.{field} is not a tensor; "
                            "the directory backend stores tensors only")
                    tensors[f"{key}/state/{name}/{field}"] = _stored(
                        name, t, plan.get(name), mesh)
            for name, t in value.get("acc_grads", {}).items():
                tensors[f"{key}/acc_grads/{name}"] = _stored(
                    name, t, plan.get(name), mesh)
        else:
            meta[key] = value
    return tensors, meta


def _write_directory(paths: Sequence[str], payload: Dict[str, Any],
                     slices, mesh, group) -> None:
    import torch.distributed as dist
    import torch.distributed.checkpoint as dcp

    tensors, meta = _split_directory_payload(payload, slices, mesh)
    main = group is None or dist.get_rank() == 0
    if group is None:
        _quiet_single_process()
    for p in paths:
        tmp, old = p + ".dcp-tmp", p + ".dcp-old"
        os.makedirs(tmp, exist_ok=True)
        # a tensor several ranks hold is written by the lowest of them:
        # the pickle file's copy (the model ranks' BatchNorm statistics
        # round apart on a card)
        dcp.save(tensors, storage_writer=dcp.FileSystemWriter(tmp),
                 planner=dcp.DefaultSavePlanner(
                     dedup_save_to_lowest_rank=True),
                 process_group=group, no_dist=group is None)
        # DCP's closing collective has returned: every rank's files and
        # the metadata are in tmp
        if not main:
            continue
        with open(os.path.join(tmp, SIDECAR), "wb") as f:
            pickle.dump(_to_numpy(meta), f, protocol=pickle.HIGHEST_PROTOCOL)
        _remove(old)
        if os.path.exists(p):  # the directory (or file) this one replaces
            os.rename(p, old)
        os.rename(tmp, p)
        _remove(old)
        _record_written(p)


def _remove(path: str) -> None:
    if os.path.isdir(path):
        shutil.rmtree(path)
    elif os.path.exists(path):
        os.remove(path)


def directory_bytes(path: str) -> Dict[str, int]:
    """The bytes of a directory checkpoint's files: each rank's DCP files
    (``rank{r}``), the metadata and the sidecar."""
    out: Dict[str, int] = {}
    for name in sorted(os.listdir(path)):
        size = os.path.getsize(os.path.join(path, name))
        key = name
        if name.startswith("__") and name.endswith(".distcp"):
            key = f"rank{name[2:].split('_')[0]}"
        out[key] = out.get(key, 0) + size
    return out


def _load_directory(path: str) -> Dict[str, Any]:
    """The payload of a directory checkpoint, whole, in this process (no
    collective): the pickle file's payload of the same save."""
    import torch.distributed.checkpoint as dcp

    _quiet_single_process()
    reader = dcp.FileSystemReader(path)
    tensors = {key: torch.empty(md.size, dtype=md.properties.dtype)
               for key, md in reader.read_metadata()
               .state_dict_metadata.items()}
    dcp.load(tensors, storage_reader=reader, no_dist=True)
    payload = _read_numpy_pickle(os.path.join(path, SIDECAR))

    def whole(name, t):
        return (t.flatten(0, 1) if _grouped(name) and t.dim() >= 2
                else t).numpy()

    for key in NETWORKS:
        if key in payload:
            payload[key] = {name: whole(name, tensors[f"{key}/{name}"])
                            for name in payload[key]}
    for key in OPTIMIZERS:
        if key not in payload:
            continue
        opt = payload[key]
        names = opt.pop("names", None)
        index = {name: i for i, name in enumerate(names)} if names else {}
        state: Dict[int, Dict[str, Any]] = {}
        grads: Dict[str, Any] = {}
        for dkey, t in tensors.items():
            parts = dkey.split("/")
            if parts[0] != key:
                continue
            if parts[1] == "state":
                i = index[parts[2]] if index else int(parts[2])
                state.setdefault(i, {})[parts[3]] = whole(parts[2], t)
            elif parts[1] == "acc_grads":
                grads[parts[2]] = whole(parts[2], t)
        opt["state"] = {i: state[i] for i in sorted(state)}
        if grads:
            by_order = sorted(grads, key=index.__getitem__)
            opt["acc_grads"] = {n: grads[n] for n in by_order}
    return payload


def save_torch_checkpoint(path: str,
                          model: Union[torch.nn.Module,
                                       Dict[str, torch.Tensor]],
                          epoch: Optional[int] = None,
                          config: Optional[Dict[str, Any]] = None,
                          **entries: Any) -> None:
    """Write ``{model, epoch, config, **entries}`` as a torch ``.pth``
    (reference layout, CPU tensors), atomically. ``model`` is a module or
    its state_dict; ``entries`` are the reference's other keys as they are
    to be stored (``optimizer``, ``scaler``, ``metrics``, ``model_ema``)."""
    payload = {
        "model": {k: v.detach().cpu()
                  for k, v in _model_state(model).items()},
        "epoch": epoch,
        "config": config,
        **entries,
    }
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def resolve_checkpoint_url(path: str) -> str:
    """URL-resume capability (reference misc.py:307-309 uses torch.hub).

    This build runs with zero network egress, so URLs resolve against the
    torch-hub download cache instead of the network: ``file://`` maps to the
    local path, and ``http(s)://`` URLs are looked up by filename in
    ``$TORCH_HOME/hub/checkpoints`` (the directory ``torch.hub`` populates).
    A cache miss raises with instructions rather than attempting a fetch."""
    if path.startswith("file://"):
        return path[len("file://"):]
    if not path.startswith(("http://", "https://")):
        return path
    fname = os.path.basename(path.split("?", 1)[0])
    torch_home = os.environ.get(
        "TORCH_HOME", os.path.join(os.path.expanduser("~"), ".cache", "torch")
    )
    cached = os.path.join(torch_home, "hub", "checkpoints", fname)
    if os.path.exists(cached):
        log(f"URL resume served from torch-hub cache: {cached}")
        return cached
    raise FileNotFoundError(
        f"URL resume requires a pre-downloaded checkpoint (no network "
        f"egress). Place the file at {cached} or pass a local path."
    )


def _restore_module(module: torch.nn.Module, payload_model) -> None:
    module.load_state_dict(model_state_dict(payload_model,
                                            module.state_dict().keys()))


def maybe_resume(config: Dict[str, Any], trainer) -> Optional[Dict[str, Any]]:
    """``--resume`` (the JAX package's ``maybe_resume``, reference
    misc.py:305-321) into a built ``trainer`` (``algorithms/common.Trainer``),
    in place: the model, and the teacher (``model_ema``) and peer
    (``model_peer``) where both run and file have one. A torch ``.pth``
    then restarts the optimizer; the port's ``.ckpt`` and a JAX ``.ckpt``
    restore the optimizers (the update count and an open accumulation
    window too) and the step. Sets ``config["start_epoch"]`` to the file's
    epoch + 1. Returns the file's best-so-far thresholds (``best``), if
    any."""
    resume = config.get("resume")
    if not resume:
        return None
    resume = resolve_checkpoint_url(str(resume))
    payload = load_checkpoint(resume)  # flushes this process's writes
    _restore_module(trainer.model, payload["model"])
    for module, key in ((trainer.teacher, "model_ema"),
                        (trainer.peer, "model_peer")):
        if module is not None and key in payload:
            _restore_module(module, payload[key])
    log(f"Resume checkpoint {resume}")
    if resume.endswith((".pth", ".pt")):
        # a torch optimizer's state is keyed by the writer's param groups:
        # the weights warm-start, the statistics restart; the epoch counter
        # carries over (reference misc.py:315-320)
        if payload.get("epoch") is not None:
            config["start_epoch"] = payload["epoch"] + 1
            log(f"Torch-format checkpoint: model restored, optimizer "
                f"restarted, resuming at epoch {config['start_epoch']}")
        else:
            log("Torch-format checkpoint: model restored, optimizer "
                "restarted")
        return payload.get("best")
    if "optimizer" in payload and payload.get("epoch") is not None:
        jax_trees = "params" in payload["model"]
        for optimizer, key, model_key, module in (
                (trainer.optimizer, "optimizer", "model", trainer.model),
                (trainer.peer_optimizer, "peer_optimizer", "model_peer",
                 trainer.peer)):
            if optimizer is None or key not in payload:
                continue
            if jax_trees:
                load_optax_leaves(optimizer, payload[key],
                                  payload[model_key]["params"],
                                  module.state_dict().keys())
            else:
                # files written before accumulation was ported hold no
                # count; every step was an update then
                optimizer.load_state_dict(
                    {"count": payload.get("step") or 0, **payload[key]})
        if payload.get("step") is not None:
            trainer.step = int(payload["step"])
        config["start_epoch"] = payload["epoch"] + 1
        log("With optim & sched!")
    return payload.get("best")
