"""The port's checkpoint writer (``utils/checkpoint.py``) on the CPU.

The writer thread (``async_checkpoint``, the counterparts of the JAX
package's writer tests in ``tests/test_checkpoint.py``):

- a non-finite loss flushes the queued writes and names the last file
  that landed; a queued write round-trips; a write that fails on the
  thread is logged and leaves the pointer on the file before;
- an async file equals the synchronous file of the same call byte for
  byte (the directory: payload for payload); a parameter changed in place
  after ``save_checkpoint`` returns does not reach the file; the last
  write to one path wins, also where one backend replaces the other's,
  and saves from more threads than cores land in each thread's order;
- the JAX package's ``load_checkpoint`` and ``restore_model_state`` read a
  file the port wrote async to the port's weights, bit for bit.

The directory backend (``checkpoint_backend: orbax``, written through
``torch.distributed.checkpoint``):

- a base run writes ``best-*.ckpt`` directories and its test entry reads
  them (``tests/test_orbax_backend.py``'s e2e case); a JAX orbax
  directory is refused with the converter's name;
- two gloo ranks with ZeRO-1 take a step and write the directory without
  an ``all_gather_object``, each rank its own files; loaded in one
  process it is the pickle file's payload of the same state (a replicated
  buffer that the ranks hold apart taken from rank 0, as the pickle file
  takes it), and a resume
  from it equals the resume from the pickle file bit for bit (the state,
  and after a step);
  ``slow``: the same at the ``(1, 3)`` (data, model) layout, the ViT's
  heads sliced over three model ranks.
"""

import os
import sys
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import yaml

from semi_seg_ecg_tpu.utils import checkpoint as jax_ckpt
from semi_seg_ecg_tpu_torch.algorithms import common, get_algorithm
from semi_seg_ecg_tpu_torch.cli import test_main as port_test_main
from semi_seg_ecg_tpu_torch.cli import train_main
from semi_seg_ecg_tpu_torch.config import normalize_config, parse_train_args
from semi_seg_ecg_tpu_torch.utils import checkpoint as ckpt
from tests.test_torch_export import model_config
from tests.test_torch_resume import assert_payloads_equal
from tests.test_torch_train_slice import SEQ, tiny_recipe
from tests.torch_dist_worker import run_ranks

TIMEOUT = 240


def small_state(seed):
    """A Linear + BatchNorm model after one AdamW step, and the step's
    optimizer state dict."""
    torch.manual_seed(seed)
    model = torch.nn.Sequential(torch.nn.Linear(4, 3),
                                torch.nn.BatchNorm1d(3))
    opt = torch.optim.AdamW(model.parameters(), lr=1e-3)
    model(torch.randn(5, 4)).square().sum().backward()
    opt.step()
    return model, opt.state_dict()


def save(path, model, opt, epoch=1, **kwargs):
    ckpt.save_checkpoint(path, epoch, model, opt, config={"seed": 0},
                         metrics={"loss": 0.5}, best={"loss": 0.5}, step=3,
                         **kwargs)


def test_nan_abort_flushes_and_names_a_landed_file(tmp_path, capsys):
    """A non-finite loss at drain time flushes the queued writes (they all
    predate the poisoned epoch) and names the last one that landed."""
    model, opt = small_state(0)
    good = str(tmp_path / "checkpoint-1.ckpt")
    gate = threading.Event()
    ckpt._ensure_worker().put(gate.wait)  # holds the writer back
    save(good, model, opt, async_write=True)
    assert not os.path.exists(good)
    trainer = SimpleNamespace(
        optimizer=SimpleNamespace(accum=1), config={},
        device=torch.device("cpu"), step=0,
        train_step=lambda batch: {"loss": torch.tensor(float("nan"))})
    threading.Timer(0.2, gate.set).start()
    with pytest.raises(SystemExit) as exc:
        common._train_one_epoch(
            trainer, {"labeled": [{"ecg": np.zeros((2, 1, 16), np.float32)}]},
            SimpleNamespace(uses_unlabeled=False), epoch=0,
            steps_per_epoch=1, lr_fn=lambda s: 0.1, log_writer=None)
    assert exc.value.code == 1
    assert os.path.exists(good) and ckpt.last_written_checkpoint() == good
    out = capsys.readouterr().out
    assert f"Last good checkpoint: {good}" in out


def test_deferred_write_round_trips(tmp_path):
    model, opt = small_state(1)
    path = str(tmp_path / "deferred.ckpt")
    save(path, model, opt, epoch=2, async_write=True)
    ckpt.wait_for_pending()
    payload = ckpt.load_checkpoint(path)
    assert payload["epoch"] == 2 and payload["metrics"]["loss"] == 0.5
    np.testing.assert_array_equal(payload["model"]["0.weight"],
                                  model[0].weight.detach().numpy())
    assert ckpt.last_written_checkpoint() == path


def test_failed_write_is_logged_and_the_pointer_stays(tmp_path, capsys):
    model, opt = small_state(6)
    good = str(tmp_path / "good.ckpt")
    save(good, model, opt, async_write=True)
    save(str(tmp_path / "missing" / "bad.ckpt"), model, opt,
         async_write=True)
    ckpt.wait_for_pending()
    assert ckpt.last_written_checkpoint() == good
    out = capsys.readouterr().out
    assert "async checkpoint write failed: FileNotFoundError" in out


@pytest.mark.parametrize("backend", ["pickle", "orbax"])
def test_async_file_equals_sync_file(tmp_path, backend):
    """The pickle file byte for byte; the directory payload for payload."""
    model, opt = small_state(2)
    paths = [str(tmp_path / f"{mode}.ckpt") for mode in ("sync", "async")]
    save(paths[0], model, opt, backend=backend)
    save(paths[1], model, opt, backend=backend, async_write=True)
    ckpt.wait_for_pending()
    if backend == "pickle":
        with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
            assert a.read() == b.read()
    else:
        assert os.path.isdir(paths[1])
        assert_payloads_equal(ckpt.load_checkpoint(paths[1]),
                              ckpt.load_checkpoint(paths[0]))


@pytest.mark.parametrize("backend", ["pickle", "orbax"])
def test_in_place_update_after_save_does_not_reach_the_file(tmp_path,
                                                             backend):
    model, opt = small_state(3)
    want = {k: v.clone().numpy() for k, v in model.state_dict().items()}
    moment = opt["state"][0]["exp_avg"].clone().numpy()
    path = str(tmp_path / "snap.ckpt")
    gate = threading.Event()
    ckpt._ensure_worker().put(gate.wait)
    save(path, model, opt, backend=backend, async_write=True)
    with torch.no_grad():  # the next step's in-place update
        for t in list(model.state_dict().values()) + [
                opt["state"][0]["exp_avg"]]:
            t.add_(1)
    gate.set()
    payload = ckpt.load_checkpoint(path)
    assert_payloads_equal(payload["model"], want)
    np.testing.assert_array_equal(payload["optimizer"]["state"][0]["exp_avg"],
                                  moment)


def test_last_write_to_one_path_wins(tmp_path):
    model, opt = small_state(4)
    path = str(tmp_path / "best-loss.ckpt")
    for epoch in (1, 2, 3):
        save(path, model, opt, epoch=epoch, async_write=True)
    ckpt.wait_for_pending()
    assert ckpt.load_checkpoint(path)["epoch"] == 3
    assert ckpt.last_written_checkpoint() == path
    for backend in ("orbax", "pickle"):  # a backend over the other's file
        save(path, model, opt, epoch=4, backend=backend, async_write=True)
        assert ckpt.load_checkpoint(path)["epoch"] == 4
        assert os.path.isdir(path) == (backend == "orbax")
    assert os.listdir(tmp_path) == ["best-loss.ckpt"]


def test_saves_from_many_threads_land_in_order(tmp_path):
    """More saving threads than cores, switching every microsecond: each
    thread's last save to its own path is what lands, and the pointer
    names a file that landed."""
    model, opt = small_state(5)
    paths = [str(tmp_path / f"t{i}.ckpt")
             for i in range(2 * (os.cpu_count() or 1))]

    def saves(path):
        for epoch in range(4):
            save(path, model, opt, epoch=epoch, async_write=True)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=saves, args=(p,)) for p in paths]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
        ckpt.wait_for_pending()
    finally:
        sys.setswitchinterval(interval)
    assert [ckpt.load_checkpoint(p)["epoch"] for p in paths] == \
        [3] * len(paths)
    assert ckpt.last_written_checkpoint() in paths


def test_jax_package_reads_an_async_file(tmp_path):
    """The JAX package's ``load_checkpoint`` and ``restore_model_state``
    read the port's async file (a flat state_dict, translated against the
    JAX model's trees) to the port's weights."""
    import jax

    from semi_seg_ecg_tpu.models import build_model_from_config as jax_build
    from semi_seg_ecg_tpu.utils.train_state import ModelState
    from semi_seg_ecg_tpu_torch.utils.weights import jax_trees_to_state_dict

    config = {**model_config("resnet"), "seed": 0}
    model = common.init_model(normalize_config(config), torch.device("cpu"))
    path = str(tmp_path / "port.ckpt")
    ckpt.save_checkpoint(path, 0, model, config=config, async_write=True)
    ckpt.wait_for_pending()
    payload = jax_ckpt.load_checkpoint(path)
    assert jax_ckpt.is_torch_state_dict(payload["model"])
    jmodel = jax_build(config, train=False)
    shapes = jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0),
                            np.zeros((1, 1, SEQ), np.float32)))
    restored = jax_ckpt.restore_model_state(payload["model"], ModelState(
        params=shapes["params"], batch_stats=shapes["batch_stats"]))
    state = model.state_dict()
    back = jax_trees_to_state_dict(restored.params, restored.batch_stats,
                                   state.keys())
    for k, v in state.items():
        if v.is_floating_point():
            np.testing.assert_array_equal(np.asarray(back[k]), v.numpy(), k)


def test_orbax_backend_e2e(tmp_path):
    """A base run with ``checkpoint_backend: orbax`` writes its best
    checkpoints as directories, and the test entry reads one."""
    cfg, path = tiny_recipe(tmp_path, "resnet18", "scratch", "orbax")
    cfg["checkpoint_backend"] = "orbax"
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    train_main(["-f", path])
    exp = tmp_path / "exps" / "orbax"
    for name in ("best-loss.ckpt", "best-MeanIoU.ckpt"):
        assert sorted(os.listdir(exp / name)) == [
            ".metadata", "__0_0.distcp", ckpt.SIDECAR]
    metrics = port_test_main(["-f", path])
    assert 0.0 <= metrics["MeanIoU"] <= 1.0
    # a JAX orbax directory: no DCP metadata
    jax_dir = tmp_path / "jax_orbax.ckpt"
    os.makedirs(jax_dir / "d")
    (jax_dir / "meta.pkl").write_bytes(b"")
    with pytest.raises(NotImplementedError, match="to-torch"):
        ckpt.load_checkpoint(str(jax_dir))


# ---------------------------------------------------------------------------
# Every rank writes the directory; one process resumes from it
# ---------------------------------------------------------------------------


def layout_config(tmp_path, family, parallel):
    """The tiny ``family`` base recipe at ``parallel``; returns its path."""
    cfg, path = tiny_recipe(tmp_path, family, "scratch", "layout")
    if family == "vit_tiny":  # heads three model ranks divide
        cfg["backbone"]["vit_tiny"].update(heads=3, dim_head=16)
    cfg["parallel"] = parallel
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def fixed_batch(rows):
    rng = np.random.default_rng(0)
    return {"ecg": rng.standard_normal((rows, 1, SEQ)).astype(np.float32),
            "target": rng.integers(0, 4, (rows, SEQ))}


def resumed(path, checkpoint):
    """A one-process Trainer resumed from ``checkpoint`` (``--resume``):
    its state at resume, and after one step on a fixed batch."""
    config = parse_train_args(["-f", path, "--resume", checkpoint])
    config["parallel"] = {}
    spec = get_algorithm(config["algorithm"]).SPEC
    trainer = common.Trainer(config, spec, torch.device("cpu"), 1)

    def state():
        return ckpt._to_numpy({"model": trainer.model.state_dict(),
                               "optimizer": trainer.optimizer.state_dict(),
                               "step": trainer.step})

    before = state()
    trainer.train_step({k: torch.from_numpy(v)
                        for k, v in fixed_batch(2).items()})
    return before, state()


def check_layout(tmp_path, family, parallel, world):
    """One step at ``parallel`` over ``world`` gloo ranks, then the
    checkpoint written with each backend: the directory against the
    pickle file, loaded and resumed in one process."""
    path = layout_config(tmp_path, family, parallel)
    out = tmp_path / "ranks"
    results = run_ranks([("save_backends", {
        "config": parse_train_args(["-f", path]), "out_dir": str(out),
        "batch": fixed_batch(4)})],
        str(out), world=world, timeout=TIMEOUT)
    # the directory write gathers nothing; every rank wrote its own file
    assert [r[0]["orbax"] for r in results] == [0] * world
    written = ckpt.directory_bytes(str(out / "orbax.ckpt"))
    assert all(written.get(f"rank{r}", 0) > 0 for r in range(world))
    assert_payloads_equal(ckpt.load_checkpoint(str(out / "orbax.ckpt")),
                          ckpt.load_checkpoint(str(out / "pickle.ckpt")))
    runs = [resumed(path, str(out / f"{b}.ckpt")) for b in ("pickle",
                                                             "orbax")]
    assert_payloads_equal(runs[1], runs[0])


def test_two_rank_zero1_directory_resumes_as_the_pickle(tmp_path):
    check_layout(tmp_path, "resnet18",
                 {"shard_optimizer": True, "model_parallel": 1}, world=2)


@pytest.mark.slow
def test_model_axis_directory_resumes_as_the_pickle(tmp_path):
    check_layout(tmp_path, "vit_tiny", {"model_parallel": 3}, world=3)


@pytest.fixture(autouse=True)
def _flushed():
    """Every test starts and ends with an empty queue and no pointer."""
    ckpt.wait_for_pending()
    ckpt._record_written(None)
    yield
    ckpt.wait_for_pending()
