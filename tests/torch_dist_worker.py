"""One rank of the port's data-parallel tests on the CPU
(``tests/test_torch_parallel.py``, ``tests/test_torch_parallel_train.py``).

It imports the port and torch, nothing of JAX. The test starts
``WORLD_SIZE`` of these with torchrun's variables (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) and a
timeout:

    python tests/torch_dist_worker.py JOB.pkl OUT_DIR

``JOB.pkl`` holds the ``device`` (``cpu``, or ``cuda`` for the card
tests), the ``backend`` (None: the device's default), ``join`` and
``tasks``, a list of ``(task, kwargs)``. With ``join`` the rank joins the
group through ``parallel.dist.init_distributed_mode`` first, and the
entries it runs keep it; without, each entry joins from torchrun's
variables itself and leaves when it returns. The rank runs the tasks in
order and writes their results, NumPy leaves only, as a list to
``OUT_DIR/rank{RANK}.pkl``. Each process uses one CPU thread, so that two
ranks and the single-process runs they are held against round alike.
:func:`start_ranks` and :func:`wait_ranks` are the tests' launcher.
"""

import contextlib
import copy
import os
import pickle
import socket
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from semi_seg_ecg_tpu_torch.parallel import dist as pdist  # noqa: E402

def to_numpy(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, dict):
        return {k: to_numpy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [to_numpy(v) for v in obj]
    return obj


def rank_rows(a):
    """This rank's rows of a global batch array."""
    b = a.shape[0] // pdist.get_world_size()
    r = pdist.get_rank()
    return a[r * b:(r + 1) * b]


def task_batchnorm(x, grad_out, state):
    """A TorchBatchNorm and a LatentProjection in train mode on this
    rank's rows: outputs, input gradients, the parameters' gradients (of
    this rank's share, not averaged) and the state after the step."""
    from semi_seg_ecg_tpu_torch.models.encoder_decoder import (
        LatentProjection,
    )
    from semi_seg_ecg_tpu_torch.models.norm import TorchBatchNorm

    out = {}
    for name, module in (("bn", TorchBatchNorm(x.shape[1])),
                         ("projection", LatentProjection(x.shape[1], 8))):
        module.load_state_dict({k: torch.from_numpy(v)
                                for k, v in state[name].items()})
        xr = torch.from_numpy(rank_rows(x)).requires_grad_()
        y = module.train()(xr)
        g = grad_out[name]
        (y * torch.from_numpy(rank_rows(g))).sum().backward()
        out[name] = {"y": y, "x_grad": xr.grad,
                     "param_grads": {k: p.grad for k, p
                                     in module.named_parameters()},
                     "state": module.state_dict()}
    return out


def task_draws(config, batch, seed):
    """The device augmentation's draws for this rank's rows of ``batch``,
    and a dropout and a DropPath mask, from generators seeded ``seed``."""
    from semi_seg_ecg_tpu_torch.models.dropout import Dropout, DropPath
    from semi_seg_ecg_tpu_torch.ops.preprocess import plan_device_augment

    plan = plan_device_augment(config["dataset"])
    gen = torch.Generator().manual_seed(seed)
    draws = plan.sample(gen, {k: torch.from_numpy(rank_rows(v))
                              for k, v in batch.items()})
    x = torch.ones(rank_rows(batch["ecg"]).shape)
    masks = {}
    for name, module in (("dropout", Dropout(0.5)),
                         ("droppath", DropPath(0.5))):
        module.generator = torch.Generator().manual_seed(seed)
        masks[name] = module.train()(x) != 0
    return {"augment": draws, "masks": masks}


def launch_counts():
    from semi_seg_ecg_tpu_torch.ops import flash_attention as fa
    from semi_seg_ecg_tpu_torch.ops import gather1d

    return fa.LAUNCHES, fa.BWD_LAUNCHES, gather1d.LAUNCHES


def task_steps(runs, device="cpu"):
    """For each run, ``Trainer.train_step`` on this rank's rows of each
    global batch: per-step metrics (the mean over the ranks, as the
    training loop drains them) and kernel launches (flash forward,
    backward, gather), and every network's final state."""
    from semi_seg_ecg_tpu_torch.algorithms import get_algorithm
    from semi_seg_ecg_tpu_torch.algorithms.common import Trainer, full_fp32
    from semi_seg_ecg_tpu_torch.models import build_model_from_config

    device = torch.device(device)
    if device.type == "cuda":
        device = pdist.cuda_device()
    out = []
    for run in runs:
        cfg = run["config"]
        spec = get_algorithm(cfg["algorithm"]).SPEC
        modules = {}
        for role in ("model", "peer"):
            if role in run["states"]:
                modules[role] = build_model_from_config(cfg, train=True)
                modules[role].load_state_dict(
                    {k: torch.from_numpy(v)
                     for k, v in run["states"][role].items()})
                modules[role].to(device)
        with full_fp32():
            trainer = Trainer(copy.deepcopy(cfg), spec, device,
                              len(run["batches"]), model=modules["model"],
                              peer=modules.get("peer"))
            metrics, launches = [], []
            for batch in run["batches"]:
                before = launch_counts()
                step = trainer.train_step({
                    k: torch.from_numpy(rank_rows(v)).to(device)
                    for k, v in batch.items()})
                launches.append([a - b for a, b in zip(launch_counts(),
                                                       before)])
                metrics.append({k: float(pdist.all_reduce_mean(v))
                                for k, v in step.items()})
        states = {role: module.state_dict() for role, module in
                  (("model", trainer.model), ("ema", trainer.teacher),
                   ("peer", trainer.peer)) if module is not None}
        out.append({"metrics": metrics, "launches": launches,
                    "states": states})
    return out


def task_select_reliable(config, snapshots):
    """ST++'s ranking of the unlabeled split by the given snapshots, each
    rank on its shards."""
    from semi_seg_ecg_tpu_torch.algorithms.common import (
        amp_context,
        eval_loader,
    )
    from semi_seg_ecg_tpu_torch.algorithms.stpp import select_reliable
    from semi_seg_ecg_tpu_torch.data.dataset import build_seg_dataset
    from semi_seg_ecg_tpu_torch.models import build_model_from_config

    models = []
    for state in snapshots:
        model = build_model_from_config(config)
        model.load_state_dict({k: torch.from_numpy(v)
                               for k, v in state.items()})
        models.append(model)
    ds = build_seg_dataset(config["dataset"], split="train_unlabeled",
                           mode="eval")
    loader = eval_loader(config, ds, mode="eval")
    try:
        reliable, unreliable, reliability = select_reliable(
            models, loader, config["metric"]["num_classes"],
            torch.device("cpu"), amp_context(config, torch.device("cpu")))
    finally:
        loader.close()
    return {"reliable": reliable, "unreliable": unreliable,
            "reliability": reliability}


@contextlib.contextmanager
def data_parallel_size(num_shards):
    """Inside, the loaders and the lr take ``num_shards`` data-parallel
    shards (unset: the group's size): one process holding every shard
    of an ``num_shards``-rank run, as the JAX package's one process over
    ``num_shards`` devices."""
    from semi_seg_ecg_tpu_torch.parallel import mesh

    saved = mesh.data_parallel_size
    if num_shards is not None:
        mesh.data_parallel_size = lambda: num_shards
    try:
        yield
    finally:
        mesh.data_parallel_size = saved


def task_train_main(argv, num_shards=None):
    from semi_seg_ecg_tpu_torch.cli import train_main

    with data_parallel_size(num_shards):
        return train_main(argv)


def task_evaluate(config, checkpoint, split):
    """One evaluation of ``checkpoint`` on ``split`` through
    ``algorithms.common.evaluate``, as the training loop runs it: the
    metrics and the loss."""
    from semi_seg_ecg_tpu_torch.algorithms import common
    from semi_seg_ecg_tpu_torch.data.dataset import build_seg_dataset
    from semi_seg_ecg_tpu_torch.ops.metrics import build_metric_fn

    device = torch.device("cpu")
    config = dict(config, test={"model_path": checkpoint})
    ds = build_seg_dataset(config["dataset"], split=split)
    loader = common.eval_loader(config, ds, mode="valid")
    metric_fn, _ = build_metric_fn(config["metric"])
    try:
        with common.full_fp32():
            stats, metrics, _, _ = common.evaluate(
                common.load_eval_model(config, device), loader, metric_fn,
                config["metric"]["num_classes"], device,
                common.amp_context(config, device), collect_outputs=False)
    finally:
        loader.close()
    return {"loss": stats["loss"], **metrics}


def task_test_main(argv):
    from semi_seg_ecg_tpu_torch.cli import test_main

    return test_main(argv)


def task_inference_main(argv):
    from semi_seg_ecg_tpu_torch.cli import inference_main

    return inference_main(argv)


def task_nan_abort(argv, rank):
    """``train_main`` with every step's signal on ``rank`` made NaN."""
    from semi_seg_ecg_tpu_torch.algorithms import common
    from semi_seg_ecg_tpu_torch.cli import train_main

    step = common.Trainer.train_step

    def poisoned(self, batch):
        if pdist.get_rank() == rank:
            batch = dict(batch, ecg=batch["ecg"] * float("nan"))
        return step(self, batch)

    common.Trainer.train_step = poisoned
    return train_main(argv)


TASKS = {"batchnorm": task_batchnorm, "draws": task_draws,
         "steps": task_steps, "select_reliable": task_select_reliable,
         "evaluate": task_evaluate, "train_main": task_train_main,
         "test_main": task_test_main,
         "inference_main": task_inference_main, "nan_abort": task_nan_abort}


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_ranks(tasks, work_dir, world=2, device="cpu", backend=None,
                one_card=False, join=True):
    """Start ``world`` ranks on ``tasks`` (see the module docstring) in
    ``work_dir``, each writing its output to ``rank{r}.log`` there; with
    ``one_card`` every rank takes ``LOCAL_RANK`` 0. Returns the handle
    :func:`wait_ranks` takes."""
    os.makedirs(work_dir, exist_ok=True)
    job = os.path.join(work_dir, "job.pkl")
    with open(job, "wb") as f:
        pickle.dump({"device": device, "backend": backend, "join": join,
                     "tasks": tasks}, f)
    port = str(_free_port())
    procs = []
    for r in range(world):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(world),
                   LOCAL_RANK="0" if one_card else str(r),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=port,
                   OMP_NUM_THREADS="1")
        with open(os.path.join(work_dir, f"rank{r}.log"), "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), job, work_dir],
                env=env, stdout=log, stderr=subprocess.STDOUT))
    return work_dir, procs


def wait_ranks(handle, timeout):
    """Wait at most ``timeout`` seconds for every rank of ``handle`` (all
    are killed past it, and the call raises). Returns ``(returncodes,
    logs, results)``, ``results[r]`` rank r's list or None."""
    work_dir, procs = handle
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 0.01))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.wait()
        raise AssertionError(f"ranks in {work_dir} did not finish within "
                             f"{timeout} s")
    logs, results = [], []
    for r in range(len(procs)):
        with open(os.path.join(work_dir, f"rank{r}.log")) as f:
            logs.append(f.read())
        path = os.path.join(work_dir, f"rank{r}.pkl")
        results.append(None)
        if os.path.exists(path):
            with open(path, "rb") as f:
                results[r] = pickle.load(f)
    return [p.returncode for p in procs], logs, results


def run_ranks(tasks, work_dir, timeout=120, **kwargs):
    """:func:`start_ranks` (``kwargs`` are its options), then
    :func:`wait_ranks`; raises unless every rank exits 0 (with its log).
    Returns the ranks' results."""
    codes, logs, results = wait_ranks(start_ranks(tasks, work_dir, **kwargs),
                                      timeout)
    for r, (code, log) in enumerate(zip(codes, logs)):
        assert code == 0, f"rank {r} exited {code}:\n{log[-4000:]}"
    return results


def main(job_path, out_dir):
    torch.set_num_threads(1)
    with open(job_path, "rb") as f:
        job = pickle.load(f)
    if job["join"]:
        pdist.init_distributed_mode({"dist_backend": job["backend"]},
                                    job["device"])
    rank = int(os.environ["RANK"])
    results = [to_numpy(TASKS[name](**kwargs))
               for name, kwargs in job["tasks"]]
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)


if __name__ == "__main__":
    main(*sys.argv[1:])
