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

The group's rendezvous port is rank 0's own (:func:`host_store`): rank 0
starts the ``TCPStore`` server on a port the kernel picks and publishes
the number in ``OUT_DIR/store_port``. A port chosen by the launcher and
freed for the ranks to bind could be taken by any other process in
between, and the group would then wait out its timeout.
"""

import contextlib
import copy
import os
import pickle
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from semi_seg_ecg_tpu_torch.parallel import dist as pdist  # noqa: E402

# a test module's torch work on one intra-op thread: the tier-1 run's
# workers share the cores, and each process's default pool of one thread a
# core oversubscribes them
TEST_THREADS = 1


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Autouse in each ``tests/test_torch_*.py`` that imports it: the
    module's tests run torch on ``TEST_THREADS`` intra-op threads, and the
    processes they start (``OMP_NUM_THREADS``) too; both are put back
    after the module."""
    threads, omp = torch.get_num_threads(), os.environ.get(
        "OMP_NUM_THREADS")
    torch.set_num_threads(TEST_THREADS)
    os.environ["OMP_NUM_THREADS"] = str(TEST_THREADS)
    try:
        yield
    finally:
        torch.set_num_threads(threads)
        if omp is None:
            os.environ.pop("OMP_NUM_THREADS", None)
        else:
            os.environ["OMP_NUM_THREADS"] = omp


def to_numpy(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, dict):
        return {k: to_numpy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [to_numpy(v) for v in obj]
    return obj


def rank_rows(a):
    """This rank's rows of a global batch array: its data rank's (the
    model ranks of a data rank hold the same rows)."""
    b = a.shape[0] // pdist.data_size()
    r = pdist.data_rank()
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


def optimizer_report(opt):
    """A ``TrainOptimizer``'s whole state (``state_dict``, a collective
    under ZeRO-1), the names of the parameters this rank keeps state for,
    and the bytes of that state; the whole state again after loading it
    back into the optimizer, as a resume does."""
    state = opt.state_dict()
    held = [n for n, p in zip(opt.names, opt.params) if opt.holds(p)]
    nbytes = sum(v.numel() * v.element_size()
                 for entry in opt.optimizer.state.values()
                 for v in entry.values() if torch.is_tensor(v))
    opt.load_state_dict(state)
    return {"state": state, "held": held, "bytes": nbytes,
            "reloaded": opt.state_dict()}


def task_steps(runs, device="cpu", optimizer_state=False):
    """For each run, ``Trainer.train_step`` on this rank's rows of each
    global batch: per-step metrics (the mean over the data ranks, as the
    training loop drains them) and kernel launches (flash forward,
    backward, gather), and every network's final state (gathered over the
    model axis into the unsliced layout), with the names the model axis
    slices and their local shapes (``sliced``); with ``optimizer_state``
    each optimizer's :func:`optimizer_report`. A run with ``checkpoint``
    has rank 0 write the trainer's checkpoint there (every rank gathers
    it), as the training loop writes one; ``updates`` (default: the
    number of batches) is the schedule's updates an epoch; ``reco_draws``
    (a ``(pool_u, anchor_u, gumbel)`` triple of arrays a step) replaces
    ReCo's draws, as a test feeds the JAX package's."""
    from semi_seg_ecg_tpu_torch.parallel.sharding_rules import (
        full_state_dict,
    )
    from semi_seg_ecg_tpu_torch.utils.checkpoint import save_checkpoint

    from semi_seg_ecg_tpu_torch.algorithms import get_algorithm
    from semi_seg_ecg_tpu_torch.algorithms.common import Trainer, full_fp32
    from semi_seg_ecg_tpu_torch.models import build_model_from_config

    from semi_seg_ecg_tpu_torch.ops import reco_loss

    device = torch.device(device)
    if device.type == "cuda":
        device = pdist.cuda_device()
    out, own_draws = [], reco_loss.reco_draws
    for run in runs:
        cfg = run["config"]
        reco_loss.reco_draws = own_draws
        if run.get("reco_draws"):
            given = iter(run["reco_draws"])
            reco_loss.reco_draws = lambda *args, **kwargs: \
                reco_loss.RecoDraws(*(torch.from_numpy(a).to(device)
                                      for a in next(given)))
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
                              run.get("updates", len(run["batches"])),
                              model=modules["model"],
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
        states = {role: full_state_dict(module) for role, module in
                  (("model", trainer.model), ("ema", trainer.teacher),
                   ("peer", trainer.peer)) if module is not None}
        plan = getattr(trainer.model, "model_plan", {})
        local = dict(trainer.model.named_parameters())
        result = {"metrics": metrics, "launches": launches,
                  "states": states,
                  "sliced": {n: tuple(local[n].shape) for n in plan}}
        if run.get("checkpoint"):
            saved = trainer.checkpoint_state()
            if pdist.is_main_process():
                save_checkpoint(run["checkpoint"], 0, config=cfg,
                                step=trainer.step, **saved)
            pdist.barrier()
        if optimizer_state:
            result["optimizers"] = {
                role: optimizer_report(opt) for role, opt in
                (("model", trainer.optimizer),
                 ("peer", trainer.peer_optimizer)) if opt is not None}
        out.append(result)
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


def task_save_backends(config, out_dir, batch):
    """A Trainer of ``config`` takes one step on this rank's rows of the
    global ``batch``; every rank but 0 then moves its BatchNorm running
    variances (replicated buffers, which ranks on a card round apart), and
    the checkpoint is written with each backend
    (``out_dir/{pickle,orbax}.ckpt``) as the training loop does, async.
    Returns how many times each write called
    ``parallel.dist.all_gather_object``."""
    from semi_seg_ecg_tpu_torch.algorithms import common, get_algorithm
    from semi_seg_ecg_tpu_torch.utils import checkpoint as ckpt

    spec = get_algorithm(config["algorithm"]).SPEC
    trainer = common.Trainer(config, spec, torch.device("cpu"), 1)
    trainer.train_step({k: torch.from_numpy(rank_rows(v))
                        for k, v in batch.items()})
    if pdist.get_rank():
        for name, buf in trainer.model.named_buffers():
            if name.endswith("running_var"):
                buf.add_(pdist.get_rank())
    gather, calls = pdist.all_gather_object, {}
    try:
        for backend in ("pickle", "orbax"):
            calls[backend] = 0

            def counted(*args, backend=backend, **kwargs):
                calls[backend] += 1
                return gather(*args, **kwargs)

            pdist.all_gather_object = counted
            common._save(trainer, [os.path.join(out_dir, f"{backend}.ckpt")],
                         0, config, backend, True, pdist.is_main_process(),
                         metrics={"loss": 1.0}, best={"loss": 1.0})
    finally:
        pdist.all_gather_object = gather
    ckpt.wait_for_pending()
    pdist.barrier()
    return calls


def task_run_training(argv, snapshot_epochs=()):
    """``run_training`` of the config ``argv`` names, writing a
    ``checkpoint-{e}.ckpt`` after each epoch ``e - 1`` of
    ``snapshot_epochs``; returns the start epoch and this rank's final
    networks (``states``, unsliced)."""
    from semi_seg_ecg_tpu_torch.algorithms import get_algorithm
    from semi_seg_ecg_tpu_torch.algorithms.common import run_training
    from semi_seg_ecg_tpu_torch.config import parse_train_args
    from semi_seg_ecg_tpu_torch.parallel.sharding_rules import (
        full_state_dict,
    )

    config = parse_train_args(argv)
    trainers = []
    run_training(config, get_algorithm(config["algorithm"]).SPEC,
                 snapshot_epochs=set(snapshot_epochs),
                 state_hook=trainers.append)
    trainer = trainers[0]
    return {"start_epoch": config.get("start_epoch", 0),
            "states": {role: to_numpy(full_state_dict(module))
                       for role, module in (("model", trainer.model),
                                            ("ema", trainer.teacher),
                                            ("peer", trainer.peer))
                       if module is not None}}


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


def task_nan_checks(argv, rank, where):
    """``train_main`` (``debug.nan_checks``) with a NaN on ``rank``: in
    every step's signal (``where`` ``ecg``) or in its cross-entropies
    (``loss``); the ``FloatingPointError``'s message."""
    from semi_seg_ecg_tpu_torch.algorithms import common, cps, fixmatch
    from semi_seg_ecg_tpu_torch.cli import train_main

    step = common.Trainer.train_step
    losses = {m: m.cross_entropy for m in (cps, fixmatch)}

    def poisoned(self, batch):
        if where == "ecg":
            batch = dict(batch, ecg=batch["ecg"] * float("nan"))
        return step(self, batch)

    def nan_loss(ce):
        return lambda *args, **kwargs: ce(*args, **kwargs) * float("nan")

    if pdist.get_rank() == rank:
        common.Trainer.train_step = poisoned
        if where == "loss":
            for m, ce in losses.items():
                m.cross_entropy = nan_loss(ce)
    try:
        train_main(argv)
    except FloatingPointError as e:
        return str(e)
    finally:
        common.Trainer.train_step = step
        for m, ce in losses.items():
            m.cross_entropy = ce
    raise AssertionError("train_main did not raise")


class KernelInfer:
    """A fixed 1-D convolution's softmax, ``(B, leads, T) -> (B, C, T)``,
    with the attributes the stitcher and the streaming segmenter read;
    ``calls`` counts the windows each call takes."""

    device = torch.device("cpu")

    def __init__(self, kernel):
        self.kernel = torch.from_numpy(kernel)
        self.num_classes = kernel.shape[0]
        self.calls = []

    def __call__(self, x):
        import torch.nn.functional as F

        self.calls.append(x.shape[0])
        w = self.kernel[:, :x.shape[1]]
        return torch.softmax(F.conv1d(x, w, padding=w.shape[-1] // 2), dim=1)


def task_longrec(kernel, cases, streams, config):
    """Long records on the data ranks of ``make_mesh()``: for each case
    ``(record, window, hop, batch)``, ``overlap_add_infer(mesh=)``'s
    probabilities and labels and the window counts of this rank's calls;
    ``long_record_inference(mesh=)`` of the first record under
    ``config``; the streaming segmenter on ``streams = (chunks, window,
    hop)`` (each chunk ``(S, leads, n)``) with ``mesh=``, its pushes and
    flush concatenated; the error of one stream too many for the mesh."""
    from semi_seg_ecg_tpu_torch import serving
    from semi_seg_ecg_tpu_torch.ops.stitch import overlap_add_infer
    from semi_seg_ecg_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh()
    out = {"stitched": [], "calls": []}
    for ecg, window, hop, batch in cases:
        infer = KernelInfer(kernel)
        out["stitched"].append(overlap_add_infer(
            infer, ecg, window=window, hop=hop, batch=batch, mesh=mesh))
        out["calls"].append(infer.calls)
    out["long_record"] = serving.long_record_inference(
        config, cases[0][0], infer=KernelInfer(kernel), mesh=mesh)
    chunks, window, hop = streams
    seg = serving.StreamingSegmenter(
        KernelInfer(kernel), window=window, hop=hop,
        num_leads=chunks[0].shape[1], num_streams=chunks[0].shape[0],
        mesh=mesh)
    pushed = [seg.push(c) for c in chunks] + [seg.flush()]
    out["streams"] = [np.concatenate([p[i] for p in pushed], axis=-1)
                      for i in range(2)]
    try:
        serving.StreamingSegmenter(KernelInfer(kernel), window=window,
                                   hop=hop, num_streams=mesh.data + 1,
                                   mesh=mesh)
        out["uneven"] = None
    except ValueError as e:
        out["uneven"] = str(e)
    return out


@contextlib.contextmanager
def recorded_codes():
    """Inside, ``quantize_input`` (``ops/quant.py`` and its import in
    ``models/quant_layers.py``) records every int8 layer's input codes in
    call order into the list it yields."""
    from semi_seg_ecg_tpu_torch.models import quant_layers
    from semi_seg_ecg_tpu_torch.ops import quant

    codes, inner = [], quant.quantize_input

    def recorded(x, act_scale):
        q, scale = inner(x, act_scale)
        codes.append(q)
        return q, scale

    quant.quantize_input = quant_layers.quantize_input = recorded
    try:
        yield codes
    finally:
        quant.quantize_input = quant_layers.quantize_input = inner


def task_serve(config, state, batches, calibrate=()):
    """A serving build of ``config`` (``quantize: int8`` honoured) with
    ``state``, sliced over the model axis of ``make_mesh(config)``, on each
    of ``batches`` split over its seq axis (``seq_shard.sharded_call``),
    after calibrating on ``calibrate`` when given: the gathered softmax
    logits, the int8 layers' input codes in call order (this rank's
    pieces) and the calibrated absmax."""
    from semi_seg_ecg_tpu_torch.algorithms.common import shard_for_mesh
    from semi_seg_ecg_tpu_torch.models import build_model_from_config
    from semi_seg_ecg_tpu_torch.parallel import seq_shard
    from semi_seg_ecg_tpu_torch.parallel.mesh import make_mesh
    from semi_seg_ecg_tpu_torch.utils.calibrate import calibrate_quant

    make_mesh(config)
    model = build_model_from_config(config, serving=True)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    model = shard_for_mesh(model.eval())
    absmax = {}
    with torch.no_grad():
        if calibrate:
            absmax = calibrate_quant(model, [torch.from_numpy(c)
                                             for c in calibrate])
        with recorded_codes() as codes:
            logits = [seq_shard.sharded_call(
                lambda t: model(t)["seg_logits"], torch.from_numpy(x))
                for x in batches]
    return {"logits": logits, "codes": codes, "absmax": absmax}


TASKS = {"batchnorm": task_batchnorm, "draws": task_draws,
         "steps": task_steps, "select_reliable": task_select_reliable,
         "evaluate": task_evaluate, "train_main": task_train_main,
         "run_training": task_run_training,
         "test_main": task_test_main,
         "inference_main": task_inference_main, "nan_abort": task_nan_abort,
         "nan_checks": task_nan_checks,
         "longrec": task_longrec, "serve": task_serve,
         "save_backends": task_save_backends}


PORT_FILE = "store_port"
STORE_WAIT = 300  # seconds a rank waits for rank 0 to publish the port


def host_store(work_dir):
    """Rank 0: a ``TCPStore`` server on a port the kernel picks, its number
    written to ``work_dir/PORT_FILE`` (renamed into place whole); every
    rank: ``MASTER_PORT`` set to that number, and torch's ``env://``
    rendezvous told to join the server as a client
    (``TORCHELASTIC_USE_AGENT_STORE``, as under torchrun's agent, which
    hosts the store itself), so ``parallel.dist.init_distributed_mode``
    joins as it does under torchrun. Returns rank 0's store (keep it while
    the process runs), else None."""
    path = os.path.join(work_dir, PORT_FILE)
    store = None
    if int(os.environ["RANK"]) == 0:
        store = torch.distributed.TCPStore(
            "127.0.0.1", 0, int(os.environ["WORLD_SIZE"]), is_master=True,
            wait_for_workers=False)
        with open(path + ".tmp", "w") as f:
            f.write(str(store.port))
        os.replace(path + ".tmp", path)
    deadline = time.monotonic() + STORE_WAIT
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"rank 0 published no port in {path} within "
                               f"{STORE_WAIT} s")
        time.sleep(0.05)
    with open(path) as f:
        os.environ["MASTER_PORT"] = f.read()
    os.environ["TORCHELASTIC_USE_AGENT_STORE"] = "True"
    return store


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
    # an earlier group's port in this directory is not this group's
    with contextlib.suppress(FileNotFoundError):
        os.remove(os.path.join(work_dir, PORT_FILE))
    procs = []
    for r in range(world):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(world),
                   LOCAL_RANK="0" if one_card else str(r),
                   MASTER_ADDR="127.0.0.1", OMP_NUM_THREADS="1")
        with open(os.path.join(work_dir, f"rank{r}.log"), "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), job, work_dir],
                env=env, stdout=log, stderr=subprocess.STDOUT))
    return work_dir, procs


def rank_logs(work_dir, procs):
    out = []
    for r in range(len(procs)):
        with open(os.path.join(work_dir, f"rank{r}.log")) as f:
            out.append(f.read())
    return out


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
        tails = "".join(f"\n--- rank {r}:\n{log[-2000:]}"
                        for r, log in enumerate(rank_logs(work_dir, procs)))
        raise AssertionError(f"ranks in {work_dir} did not finish within "
                             f"{timeout} s{tails}")
    logs, results = rank_logs(work_dir, procs), []
    for r in range(len(procs)):
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
    store = host_store(out_dir)  # noqa: F841 (rank 0's server, kept)
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
