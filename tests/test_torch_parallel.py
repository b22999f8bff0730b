"""The port's data-parallel pieces on the CPU, two gloo ranks against one
process and against the JAX package's 2-device data mesh.

The ranks are processes of ``tests/torch_dist_worker.py`` (port only, no
JAX), started with torchrun's variables and a timeout, so a hang fails the
test. The JAX side runs here, on the conftest's 8 CPU devices. One group of
two ranks runs, in order:

- a ``TorchBatchNorm`` and a ``LatentProjection`` in train mode on rows
  ``[r·b, (r+1)·b)`` of a global batch: outputs, input gradients, the
  running statistics and the parameters' gradients (summed over the ranks)
  within 1e-6 (of the values' scale) of the same module on all ``2b`` rows
  in one process, and the BatchNorm against the JAX ``TorchBatchNorm`` on
  a 2-device mesh;
- the device augmentation's draws and a dropout and a DropPath mask: rank
  r's are rows ``[r·b, (r+1)·b)`` of the one-process draw, bit for bit;
- ST++'s reliability ranking: the same reliable ids as one process;
- ``train_main`` for one epoch of the ``vit_tiny`` FixMatch recipe (fp32,
  dropout off, device augmentation, flash attention's plain version) on a
  tiny synthetic split, beside one process holding both shards
  (``num_shards=2, local_shards=2``, the JAX package's one process over
  two devices): one ``log.txt`` line per epoch and rank 1 silent; the
  checkpoints within the lockstep tolerances of
  ``tests/test_torch_train_slice.py``.

Then two ranks and one process evaluate the 2-rank run's checkpoint: the
validation metrics rank 0 recorded in it, and ``test_main``'s
``test_metrics.csv``, ``test_outputs.npy`` and ``test_labels.npy``, equal
the one process's exactly (each forward takes a batch of ``b`` rows either
way), and so do the inference entry's outputs. A NaN on rank 1 stops
both ranks of a ``train_main`` that joins the group from torchrun's
variables itself. ``host_shard_args`` is the JAX
package's ``_host_shard_args``, and the backend's refusals hold.
"""

import copy
import csv
import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from jax.sharding import NamedSharding, PartitionSpec

from semi_seg_ecg_tpu.algorithms import common as jax_common
from semi_seg_ecg_tpu.models.norm import TorchBatchNorm as JaxBatchNorm
from semi_seg_ecg_tpu.parallel.mesh import make_mesh
from semi_seg_ecg_tpu_torch.algorithms.common import init_model
from semi_seg_ecg_tpu_torch.config import normalize_config
from semi_seg_ecg_tpu_torch.data.synthetic import make_synthetic_dataset
from semi_seg_ecg_tpu_torch.models.encoder_decoder import LatentProjection
from semi_seg_ecg_tpu_torch.models.norm import TorchBatchNorm
from semi_seg_ecg_tpu_torch.parallel import dist as pdist
from semi_seg_ecg_tpu_torch.parallel import mesh as pmesh
from semi_seg_ecg_tpu_torch.utils import checkpoint as torch_ckpt
from tests.test_torch_train_slice import SEQ, assert_states_agree, tiny_recipe
from tests.torch_dist_worker import start_ranks, task_draws, wait_ranks
from tests.torch_dist_worker import one_thread  # noqa: F401 (autouse)

WORLD, B = 2, 2          # ranks, rows a rank
CHANNELS, T = 6, 40      # the BatchNorm input (2B, CHANNELS, T)
BN_TOL = 1e-6
TIMEOUT = 150            # seconds a group of ranks may take


def bn_inputs():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((WORLD * B, CHANNELS, T)) + 0.5).astype(
        np.float32)
    grads = {"bn": rng.standard_normal(x.shape).astype(np.float32),
             "projection": rng.standard_normal(
                 (WORLD * B, 8, T)).astype(np.float32)}
    states = {}
    torch.manual_seed(0)
    for name, module in (("bn", TorchBatchNorm(CHANNELS)),
                         ("projection", LatentProjection(CHANNELS, 8))):
        for k, v in module.state_dict().items():
            if v.is_floating_point():  # statistics and affine away from 0/1
                v.add_(torch.rand(v.shape) * 0.5)
        states[name] = {k: v.numpy() for k, v in module.state_dict().items()}
    return x, grads, states


def train_config(root):
    """The vit_tiny FixMatch recipe at the tiny size, fp32 and without
    dropout, on a split whose shards need padding (3 validation and 5
    test rows over 2 ranks)."""
    cfg, _ = tiny_recipe(root, "vit_tiny", "fixmatch", "dp")
    data = make_synthetic_dataset(str(root / "dp_data"),
                                  num_train_labeled=8, num_train_unlabeled=8,
                                  num_valid=3, num_test=5, length=SEQ,
                                  seed=5)
    cfg["dataset"].update(data)
    cfg["precision"] = "fp32"
    cfg["decode_head"]["FCNHead"]["dropout_ratio"] = 0.0
    cfg["dataloader"]["batch_size"] = B
    cfg["train"]["conf_thresh"] = 0.5   # the unlabeled loss does work
    return cfg


def write_config(root, cfg, exp_name):
    path = str(root / f"{exp_name}.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(dict(cfg, exp_name=exp_name), f)
    return path


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The groups' results: ``two`` (two ranks), ``one`` (one process
    holding both shards), ``sharded`` and ``single`` (the test pass of the
    2-rank checkpoint), the configs and the experiment root."""
    root = tmp_path_factory.mktemp("torch_parallel")
    cfg = train_config(root)
    x, grads, states = bn_inputs()
    rng = np.random.default_rng(1)
    aug_batch = {k: rng.standard_normal((WORLD * B, 1, SEQ)).astype(
        np.float32) for k in ("ecg", "ecg_u_w")}
    aug_batch["target"] = rng.integers(0, 4, (WORLD * B, SEQ))
    normalized = normalize_config(copy.deepcopy(cfg))
    snapshots = [{k: v.numpy() for k, v in init_model(
        normalized, torch.device("cpu"), train=False, seed=s)
        .state_dict().items()} for s in (11, 12, 13)]
    ranking = ("select_reliable", {"config": normalized,
                                   "snapshots": snapshots})
    two = start_ranks([
        ("batchnorm", {"x": x, "grad_out": grads, "state": states}),
        ("draws", {"config": normalized, "batch": aug_batch, "seed": 3}),
        ranking,
        ("train_main", {"argv": ["-f", write_config(root, cfg, "two")]})],
        str(root / "two"))
    one = start_ranks([
        ranking,
        ("train_main", {"argv": ["-f", write_config(root, cfg, "one")],
                        "num_shards": WORLD})],
        str(root / "one"), world=1)
    results = {}
    for name, handle in (("two", two), ("one", one)):
        codes, logs, results[name] = wait_ranks(handle, TIMEOUT)
        for r, (code, log) in enumerate(zip(codes, logs)):
            assert code == 0, f"{name} rank {r}:\n{log[-4000:]}"
        results[name + "_logs"] = logs

    ckpt = os.path.join(cfg["output_dir"], "two", "best-loss.ckpt")
    test_argv = ["-f", write_config(root, cfg, "two"), "--model_path", ckpt,
                 "--exp_name"]
    sharded = start_ranks(
        [("test_main", {"argv": test_argv + ["sharded_test"]}),
         ("inference_main", {"argv": test_argv + ["sharded_inference"]})],
        str(root / "sharded"))
    single = start_ranks([
        ("evaluate", {"config": normalized, "checkpoint": ckpt,
                      "split": "valid"}),
        ("test_main", {"argv": test_argv + ["single_test"]}),
        ("inference_main", {"argv": test_argv + ["single_inference"]})],
        str(root / "single"), world=1)
    for name, handle in (("sharded", sharded), ("single", single)):
        codes, logs, results[name] = wait_ranks(handle, TIMEOUT)
        for r, (code, log) in enumerate(zip(codes, logs)):
            assert code == 0, f"{name} rank {r}:\n{log[-4000:]}"
    results.update(config=normalized, inputs=(x, grads, states),
                   aug_batch=aug_batch, exps=cfg["output_dir"])
    return results


def one_process_batchnorm(name, x, grad, state):
    module = (TorchBatchNorm(CHANNELS) if name == "bn"
              else LatentProjection(CHANNELS, 8))
    module.load_state_dict({k: torch.from_numpy(v) for k, v in
                            state.items()})
    xt = torch.from_numpy(x).requires_grad_()
    y = module.train()(xt)
    (y * torch.from_numpy(grad)).sum().backward()
    return {"y": y.detach().numpy(), "x_grad": xt.grad.numpy(),
            "param_grads": {k: p.grad.numpy()
                            for k, p in module.named_parameters()},
            "state": {k: v.numpy() for k, v in module.state_dict().items()}}


def jax_batchnorm(x, grad, state):
    """The JAX package's TorchBatchNorm (fp32) in train mode on a 2-device
    data mesh, NWC: output, input and parameter gradients, statistics."""
    mesh = make_mesh(devices=jax.devices()[:WORLD])
    rows = NamedSharding(mesh, PartitionSpec("data"))
    bn = JaxBatchNorm(use_running_average=False, dtype=jnp.float32)
    stats = {"mean": state["running_mean"], "var": state["running_var"]}

    def loss(params, xs, g):
        y, new = bn.apply({"params": params, "batch_stats": stats}, xs,
                          mutable=["batch_stats"])
        return jnp.sum(y * g), (y, new["batch_stats"])

    params = {"scale": state["weight"], "bias": state["bias"]}
    to_nwc = lambda a: jax.device_put(a.transpose(0, 2, 1), rows)
    (_, (y, new)), (g_params, g_x) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(params, to_nwc(x),
                                             to_nwc(grad))
    to_ncw = lambda a: np.asarray(a).transpose(0, 2, 1)
    return {"y": to_ncw(y), "x_grad": to_ncw(g_x),
            "param_grads": {"weight": np.asarray(g_params["scale"]),
                            "bias": np.asarray(g_params["bias"])},
            "state": {"running_mean": np.asarray(new["mean"]),
                      "running_var": np.asarray(new["var"])}}


def assert_close(got, want, what):
    """Within BN_TOL of the larger of 1 and ``want``'s largest magnitude: a
    parameter's gradient sums 2b·T products, and the JAX module's own fp32
    rounding of it reaches 6.3e-6 at magnitudes of 15 (against float64)."""
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= BN_TOL * scale, (what, err, scale)


def assert_matches(two_ranks, want, what):
    """Rank r's rows and statistics, and the ranks' summed parameter
    gradients, against ``want`` (:func:`assert_close`)."""
    for r, got in enumerate(two_ranks):
        rows = slice(r * B, (r + 1) * B)
        for k in ("y", "x_grad"):
            assert_close(got[k], want[k][rows], f"{what} {k}")
        for k, v in want["state"].items():
            assert_close(got["state"][k], v, f"{what} {k}")
    for k, v in want["param_grads"].items():
        assert_close(sum(got["param_grads"][k] for got in two_ranks), v,
                     f"{what} grad {k}")


@pytest.mark.parametrize("name", ["bn", "projection"])
def test_batchnorm_takes_global_statistics(ranks, name):
    x, grads, states = ranks["inputs"]
    two_ranks = [ranks["two"][r][0][name] for r in range(WORLD)]
    assert_matches(two_ranks, one_process_batchnorm(
        name, x, grads[name], states[name]), f"{name} one process")
    counter = next(k for k in states[name]
                   if k.endswith("num_batches_tracked"))
    assert all(int(got["state"][counter]) ==
               int(states[name][counter]) + 1 for got in two_ranks)
    if name == "bn":
        assert_matches(two_ranks, jax_batchnorm(x, grads[name],
                                                states[name]), "bn JAX")


def flat_tensors(tree):
    if isinstance(tree, dict):
        return [a for k in sorted(tree) for a in flat_tensors(tree[k])]
    if isinstance(tree, list):
        return [a for v in tree for a in flat_tensors(v)]
    return [] if tree is None else [np.asarray(tree)]


def test_draws_are_rows_of_the_global_draw(ranks):
    """Rank r's draws equal rows [r·b, (r+1)·b) of one process's draw for
    the global batch, bit for bit."""
    full = task_draws(ranks["config"], ranks["aug_batch"], seed=3)
    want = flat_tensors(full)
    assert len(want) >= 10
    for r in range(WORLD):
        got = flat_tensors(ranks["two"][r][1])
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.shape[0] == B and w.shape[0] == WORLD * B
            np.testing.assert_array_equal(g, np.asarray(w)[r * B:(r + 1) * B])


def test_stpp_ranking_gives_every_rank_the_same_ids(ranks):
    single = ranks["one"][0][0]
    for r in range(WORLD):
        got = ranks["two"][r][2]
        assert got["reliable"] == single["reliable"]
        assert got["unreliable"] == single["unreliable"]
        np.testing.assert_array_equal(got["reliability"],
                                      single["reliability"])
    assert len(single["reliable"]) == 4


def test_train_main_writes_on_rank_zero_only(ranks):
    out_dir = os.path.join(ranks["exps"], "two")
    for name in ("log.txt", "best-loss.ckpt", "best-MeanIoU.ckpt",
                 "test_metrics.csv", "test_outputs.npy"):
        assert os.path.exists(os.path.join(out_dir, name)), name
    with open(os.path.join(out_dir, "log.txt")) as f:
        lines = [json.loads(line) for line in f]
    assert [e["epoch"] for e in lines] == [0]
    assert np.isfinite(lines[0]["train_loss"])
    rank0, rank1 = ranks["two_logs"]
    assert "Start training" in rank0 and "effective batch size: 4" in rank0
    # rank 1 prints its group line and nothing else
    printed = re.findall(r"^\[\d{4}-\d\d-\d\d [\d:]+\] (.*)$", rank1,
                         re.MULTILINE)
    assert len(printed) == 1 and "distributed init" in printed[0], printed


def test_train_main_matches_one_process_over_both_shards(ranks):
    two = torch_ckpt.load_checkpoint(os.path.join(ranks["exps"], "two",
                                                  "best-loss.ckpt"))
    one = torch_ckpt.load_checkpoint(os.path.join(ranks["exps"], "one",
                                                  "best-loss.ckpt"))
    assert two["step"] == one["step"] == 2   # 8 rows, 2 a rank, 2 ranks
    assert_states_agree(torch_ckpt.model_state_dict(one["model"]),
                        torch_ckpt.model_state_dict(two["model"]))
    assert two["metrics"]["loss"] == pytest.approx(one["metrics"]["loss"],
                                                   rel=1e-5)
    assert two["config"]["train"]["eff_batch_size"] == \
        one["config"]["train"]["eff_batch_size"] == WORLD * B


def read_csv(path):
    with open(path, newline="") as f:
        header, row = list(csv.reader(f))
    return dict(zip(header, row))


def test_sharded_evaluation_equals_one_process(ranks):
    """The validation metrics rank 0 recorded with the checkpoint, and the
    test pass of two ranks, equal one process's evaluation of it."""
    two = torch_ckpt.load_checkpoint(os.path.join(ranks["exps"], "two",
                                                  "best-loss.ckpt"))
    valid = ranks["single"][0][0]
    assert two["metrics"] == valid
    sharded = ranks["sharded"][0][0]
    single = ranks["single"][0][1]
    assert sharded == single and ranks["sharded"][1][0] == single
    dirs = [os.path.join(ranks["exps"], name)
            for name in ("sharded_test", "single_test")]
    assert read_csv(os.path.join(dirs[0], "test_metrics.csv")) == \
        read_csv(os.path.join(dirs[1], "test_metrics.csv"))
    for name in ("test_outputs.npy", "test_labels.npy"):
        got, want = (np.load(os.path.join(d, name)) for d in dirs)
        assert got.shape[0] == 5
        np.testing.assert_array_equal(got, want)
    # the inference entry: every rank returns all rows, rank 0 writes them
    single_probs = ranks["single"][0][2]
    for r in range(WORLD):
        np.testing.assert_array_equal(ranks["sharded"][r][1], single_probs)
    np.testing.assert_array_equal(np.load(os.path.join(
        ranks["exps"], "sharded_inference", "test_outputs.npy")),
        single_probs)


def test_nan_on_one_rank_stops_both(tmp_path):
    cfg = train_config(tmp_path)
    path = write_config(tmp_path, cfg, "nan")
    codes, logs, _ = wait_ranks(start_ranks(
        [("nan_abort", {"argv": ["-f", path], "rank": 1})],
        str(tmp_path / "nan"), join=False), TIMEOUT)
    assert codes == [1, 1], logs
    assert "stopping training" in logs[0]


@pytest.mark.parametrize("num_shards, procs, index",
                         [(1, 1, 0), (8, 1, 0), (8, 2, 1), (8, 4, 3),
                          (6, 3, 2)])
def test_host_shard_args_matches_jax(monkeypatch, num_shards, procs, index):
    monkeypatch.setattr(jax, "process_count", lambda: procs)
    monkeypatch.setattr(jax, "process_index", lambda: index)
    monkeypatch.setattr(pdist, "get_world_size", lambda: procs)
    monkeypatch.setattr(pdist, "get_rank", lambda: index)
    assert pmesh.host_shard_args(num_shards) == \
        jax_common._host_shard_args(num_shards)


def test_host_shard_args_refuses_uneven_shards(monkeypatch):
    monkeypatch.setattr(jax, "process_count", lambda: 2)
    monkeypatch.setattr(pdist, "get_world_size", lambda: 2)
    for fn in (pmesh.host_shard_args, jax_common._host_shard_args):
        with pytest.raises(AssertionError, match="divide evenly"):
            fn(3)


def test_one_process_needs_no_group():
    ddp = {}
    pdist.init_distributed_mode(ddp, "cpu")
    assert ddp == {"rank": 0, "world_size": 1, "distributed": False}
    assert pmesh.data_parallel_size() == 1
    t = torch.arange(3.0)
    assert pdist.all_reduce_mean(t) is t
    assert pdist.gather_batch(t) is t
    rows = np.arange(3)
    arrays = [np.zeros(3)]
    assert pdist.all_gather_rows(rows, arrays) is arrays


@pytest.mark.parametrize("backend, device, error, match", [
    ("nccl", "cpu", RuntimeError, "CUDA tensors only"),
    ("nccl", "cuda", RuntimeError, "needs the nccl backend"),
    ("mpi", "cpu", ValueError, "expected one of"),
])
def test_group_refuses_an_unusable_backend(monkeypatch, backend, device,
                                           error, match):
    """Two ranks without a backend they can run raise before any
    rendezvous; nothing falls back to another backend or device."""
    if device == "cuda" and torch.cuda.is_available():
        pytest.skip("the card is there: nccl would start")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(error, match=match):
        pdist.init_distributed_mode({"dist_backend": backend}, device)
    assert not torch.distributed.is_initialized()


def test_rank_without_its_card_raises(monkeypatch):
    if torch.cuda.device_count() > 3:
        pytest.skip("the host has a cuda:3")
    monkeypatch.setenv("RANK", "3")
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("LOCAL_RANK", "3")
    with pytest.raises(RuntimeError, match="cuda:3"):
        pdist.cuda_device()


def test_slurm_variables_stand_for_torchrun_s(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("SLURM_PROCID", "5")
    monkeypatch.setenv("SLURM_NTASKS", "8")
    monkeypatch.setenv("SLURM_LOCALID", "1")
    assert pdist._env_ranks() == (5, 8, 1)
    assert pdist.local_rank() == 1
