"""The port's experiment tools (``semi_seg_ecg_tpu_torch/tools/``
``prepare_data``, ``run_bench_grid``, ``rehearse_wfdb`` and
``convert_checkpoint``) against the JAX package's ``tools/`` of the same
names, on the CPU.

- prepare_data: one WFDB tree (formats 16 and 212) through both tools
  gives the same pkl and CSV files, byte for byte; the mask expansion
  equals the JAX tool's on the annotation streams its own tests use.
- The grid: every cell's config equals the one the JAX ``run_cell`` hands
  its algorithm (recorded by a stand-in ``get_algorithm``), key for key
  but ``device``, which only the port's config names as a torch device;
  with stand-in metrics both tools write the same ``sweep_results.csv``.
  One real cell trains and tests ResNet18 on the CPU.
- The rehearsal: the port's chain runs whole at the JAX test's size
  (``tests/test_wfdb_rehearsal.py``: 24 records of 2 s, 2 epochs, batch
  1). The JAX chain runs with its train, test and long-record stages
  replaced by recorders (the real JAX chain is that test's): its raw and
  prepared trees equal the port's byte for byte, its config the port's
  but ``device``, its long-record arguments the port's, and its summary
  keys the port's.
- The converter: ``to-torch`` of a JAX ``.ckpt`` equals the JAX tool's
  ``.pth`` tensor for tensor; a ``.pth`` through ``to-framework`` loads
  into the JAX model and the port model, whose fp32 logits agree within
  1e-5; the port's own ``.ckpt`` and directory convert to their state;
  a JAX orbax directory is refused.
- Without a card, the grid and the rehearsal at their default device
  raise.
"""

import argparse
import copy
import functools
import os
import pickle
import sys
import tempfile
import types

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch
import yaml

import semi_seg_ecg_tpu.cli as jax_cli
from semi_seg_ecg_tpu.data.synthetic import make_synthetic_wfdb as jax_wfdb
from semi_seg_ecg_tpu.utils import checkpoint as jax_ckpt
from semi_seg_ecg_tpu.utils.train_state import ModelState
from semi_seg_ecg_tpu_torch import cli as port_cli
from semi_seg_ecg_tpu_torch.data.synthetic import make_synthetic_wfdb
from semi_seg_ecg_tpu_torch.models import build_model_from_config
from semi_seg_ecg_tpu_torch.tools import convert_checkpoint
from semi_seg_ecg_tpu_torch.tools import prepare_data
from semi_seg_ecg_tpu_torch.tools import rehearse_wfdb
from semi_seg_ecg_tpu_torch.tools import run_bench_grid
from semi_seg_ecg_tpu_torch.utils import checkpoint as port_ckpt
from semi_seg_ecg_tpu_torch.utils.weights import jax_trees_to_state_dict
from tools import convert_checkpoint as jax_convert
from tools import prepare_data as jax_prepare
from tools import rehearse_wfdb as jax_rehearse
from tools import run_bench_grid as jax_grid
from tests.test_torch_resnet import (
    SEQ,
    inputs,
    jax_build,
    jax_logits,
    resnet_config,
    vit_config,
)
from tests.torch_dist_worker import one_thread  # noqa: F401 (autouse)


def read_tree(root, subdirs):
    files = {}
    for sub in subdirs:
        for name in sorted(os.listdir(os.path.join(root, sub))):
            with open(os.path.join(root, sub, name), "rb") as f:
                files[f"{sub}/{name}"] = f.read()
    return files


PREPARED = ("ecg", "label", "index")


# ---------------------------------------------------------------------------
# prepare_data
# ---------------------------------------------------------------------------

class Ann:
    def __init__(self, sample, symbol):
        self.sample, self.symbol = sample, symbol


@pytest.mark.parametrize("ann, length", [
    (Ann([5, 7, 10, 20, 22, 25, 30, 33, 38],
         ["(", "p", ")", "(", "N", ")", "(", "t", ")"]), 50),
    (Ann([5, 7, 10], ["(", "u", ")"]), 20),      # unknown symbol
    (Ann([15, 17, 30], ["(", "N", ")"]), 20),    # clipped to the length
    (Ann([3, 6], ["(", "t"]), 12),               # no closing ')'
    (Ann([-2, 1, 4, 8], ["(", "p", "x", ")"]), 10),
], ids=["triplets", "unknown", "clipped", "unclosed", "negative-onset"])
def test_annotations_to_mask_is_the_jax_tools(ann, length):
    ours = prepare_data.annotations_to_mask(ann, length,
                                            prepare_data.DEFAULT_SYMBOL_MAP)
    theirs = jax_prepare.annotations_to_mask(ann, length,
                                             jax_prepare.DEFAULT_SYMBOL_MAP)
    assert ours.dtype == theirs.dtype == np.int64
    np.testing.assert_array_equal(ours, theirs)


@pytest.mark.parametrize("extra, classes", [
    (["--labeled_ratio", "0.5", "--lead", "0", "--seed", "3",
      "--splits", "0.6,0.2,0.2", "--prefix", "LUDB"], (1, 2, 3)),
    (["--seed", "1", "--symbol_map", "p=1,N=2"], (1, 2)),
], ids=["half-labeled", "no-t-waves"])
def test_prepare_data_files_are_the_jax_tools(tmp_path, extra, classes):
    """Formats 16 and 212 alternate over the records; the JAX tool reads
    them through its own pure-Python reader (no ``wfdb`` package here)."""
    raw = str(tmp_path / "raw")
    wf = jax_wfdb(raw, num_records=10, fs=500, seconds=1.0, seed=4)
    argv = ["--records_dir", raw, "--ann_ext", wf["ann_ext"], *extra]
    prepare_data.main(argv + ["--out_dir", str(tmp_path / "port")])
    jax_prepare.main(argv + ["--out_dir", str(tmp_path / "jax")])
    ours = read_tree(tmp_path / "port", PREPARED)
    assert len(ours) == 2 * 10 + 4
    assert ours == read_tree(tmp_path / "jax", PREPARED)
    name = wf["record_names"][1]
    with open(tmp_path / "port" / "label" / f"{name}_label.pkl", "rb") as f:
        mask = pickle.load(f)
    want = np.where(np.isin(wf["masks"][name], classes), wf["masks"][name],
                    0)
    np.testing.assert_array_equal(mask, want)


# ---------------------------------------------------------------------------
# The grid
# ---------------------------------------------------------------------------

GRID_BACKBONES = ("resnet18", "vit_tiny")
GRID_DATASETS = ("ludb", "qtdb")
GRID_RATIOS = (2, 16)
GRID_ALGORITHMS = ("scratch", "mean_teacher", "fixmatch", "cps", "reco",
                   "stpp")
SYNTHETIC = {"ecg_dir": "/d/ecg", "label_dir": "/d/label",
             "index_dir": "/d/index", "train_labeled_csv": "l.csv",
             "train_unlabeled_csv": "u.csv", "valid_csv": "v.csv",
             "test_csv": "t.csv", "filename_col": "waveform",
             "label_filename_col": "label", "signal_length": 2500}


class Recorder:
    """A stand-in for ``get_algorithm``: each module it returns records
    the configs it is given and tests to stand-in metrics, one set per
    call."""

    def __init__(self):
        self.configs = []

    def __call__(self, name):
        recorder = self

        class Module:
            @staticmethod
            def train(config):
                recorder.configs.append(config)

            @staticmethod
            def test(config):
                i = len(recorder.configs)
                return {"MeanIoU": 0.5 + i / 997, "loss": 1.25 - i / 991,
                        "Precision": i / 7}

        return Module


@pytest.mark.parametrize("variant", ["recipe", "cut"])
@pytest.mark.parametrize("algo", GRID_ALGORITHMS)
def test_cell_config_is_the_jax_run_cells(monkeypatch, algo, variant):
    cut = variant == "cut"
    args = argparse.Namespace(output_dir="/out", epochs=25 if cut else None,
                              batch_size=4 if cut else None, device="cpu")
    data = SYNTHETIC if cut else None
    recorder = Recorder()
    monkeypatch.setattr(jax_grid, "get_algorithm", recorder)
    for backbone in GRID_BACKBONES:
        for dataset in GRID_DATASETS:
            for ratio in GRID_RATIOS:
                row = jax_grid.run_cell(backbone, algo, dataset, ratio,
                                        args, data)
                theirs = dict(recorder.configs[-1])
                ours = run_bench_grid.cell_config(backbone, algo, dataset,
                                                  ratio, args, data)
                # the one key apart: a torch device here, JAX's there
                assert ours.pop("device") == "cpu"
                theirs.pop("device")
                assert ours == theirs
                assert ours["exp_name"] == \
                    f"{backbone}/{algo}/{dataset}/1over{ratio}"
                assert row["ratio"] == f"1/{ratio}"
    if cut:
        assert ours["train"]["epochs"] == 25
        assert ours["train"]["warmup_epochs"] == 2
        assert ours["dataloader"]["batch_size"] == 4
        assert {k: ours["dataset"][k] for k in SYNTHETIC} == SYNTHETIC
    assert len(recorder.configs) == 8


def test_sweep_table_is_the_jax_tools(tmp_path, monkeypatch):
    grid = ["--backbones", *GRID_BACKBONES, "--algorithms", "scratch",
            "cps", "--datasets", *GRID_DATASETS, "--ratios", "2", "8",
            "--epochs", "3"]
    monkeypatch.setattr(jax_grid, "get_algorithm", Recorder())
    monkeypatch.setattr(run_bench_grid, "get_algorithm", Recorder())
    monkeypatch.setattr(sys, "argv", ["run_bench_grid.py", *grid,
                                      "--output_dir", str(tmp_path / "jax")])
    jax_grid.main()
    assert run_bench_grid.main([*grid, "--output_dir",
                                str(tmp_path / "port"),
                                "--device", "cpu"]) == 0
    table = "sweep_results.csv"
    ours = (tmp_path / "port" / table).read_bytes()
    assert ours == (tmp_path / "jax" / table).read_bytes()
    rows = pd.read_csv(tmp_path / "port" / table)
    assert len(rows) == 16
    assert list(rows.columns[:4]) == ["backbone", "algorithm", "dataset",
                                      "ratio"]


def test_one_grid_cell_on_the_cpu(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    rows, seconds, table = run_bench_grid.sweep(run_bench_grid.parse_args([
        "--device", "cpu", "--synthetic", "--epochs", "1",
        "--algorithms", "scratch", "--datasets", "ludb", "--ratios", "2",
        "--output_dir", str(tmp_path)]))
    assert [r["algorithm"] for r in rows] == ["scratch"]
    assert seconds[0]["train_s"] > 0 and seconds[0]["test_s"] > 0
    table = pd.read_csv(table)
    assert len(table) == 1 and 0.0 <= table["MeanIoU"][0] <= 1.0
    assert os.path.exists(tmp_path / "resnet18" / "scratch" / "ludb" /
                          "1over2" / "best-MeanIoU.ckpt")
    assert "results:" in capsys.readouterr().out


def test_grid_and_rehearsal_without_a_card_raise(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("the card is there: the tools would run on it")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        run_bench_grid.main(["--synthetic", "--epochs", "1",
                             "--output_dir", str(tmp_path / "grid")])
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        rehearse_wfdb.main(["--root", str(tmp_path / "rehearsal")])
    assert not os.path.exists(tmp_path / "grid")
    assert not os.path.exists(tmp_path / "rehearsal" / "raw")


# ---------------------------------------------------------------------------
# The rehearsal
# ---------------------------------------------------------------------------

REHEARSAL = dict(epochs=2, num_records=24, fs=500, seconds=2.0,
                 algorithm="fixmatch", seed=0, batch_size=1)


def recorded_jax_chain(root, monkeypatch):
    """The JAX ``rehearse`` with its train, test and long-record stages
    replaced by recorders that write what the chain reads back: its
    summary, the config it trained and the long-record arguments."""
    seen = {}

    def train_main(argv):
        with open(argv[1]) as f:
            seen["config"] = yaml.safe_load(f)
        exp = os.path.join(seen["config"]["output_dir"],
                           seen["config"]["exp_name"])
        os.makedirs(exp)
        open(os.path.join(exp, "best-MeanIoU.ckpt"), "wb").close()

    def test_main(argv):
        exp = os.path.join(seen["config"]["output_dir"],
                           seen["config"]["exp_name"])
        pd.DataFrame([{"MeanIoU": 0.5}]).to_csv(
            os.path.join(exp, "test_metrics.csv"), index=False)

    def infer_longrec_main(argv):
        seen["longrec"] = list(argv)
        out = argv[argv.index("--out-dir") + 1]
        os.makedirs(out)
        np.save(os.path.join(out, "labels.npy"),
                np.load(argv[argv.index("--eval-labels") + 1]))
        open(os.path.join(out, "intervals.csv"), "w").close()

    monkeypatch.setitem(sys.modules, "train",
                        types.SimpleNamespace(main=train_main))
    monkeypatch.setitem(sys.modules, "test",
                        types.SimpleNamespace(main=test_main))
    monkeypatch.setattr(jax_cli, "infer_longrec_main", infer_longrec_main)
    seen["summary"] = jax_rehearse.rehearse(root, **REHEARSAL)
    return seen


def test_rehearsal_chain_is_the_jax_chains(tmp_path, monkeypatch):
    port_root, jax_root = str(tmp_path / "port"), str(tmp_path / "jax")
    argvs = {}
    for name in ("train_main", "test_main", "infer_longrec_main"):
        def spy(argv, _entry=getattr(port_cli, name), _name=name):
            argvs[_name] = list(argv)
            return _entry(argv)

        monkeypatch.setattr(port_cli, name, spy)
    stages = {}
    summary = rehearse_wfdb.rehearse(port_root, device="cpu",
                                     stage_seconds=stages, **REHEARSAL)
    assert 0.0 <= summary["test_MeanIoU"] <= 1.0
    assert 0.0 <= summary["longrec_overall_sensitivity"] <= 1.0
    assert np.isfinite(summary["longrec_overall_ppv"])
    assert list(stages) == ["wfdb", "prepare", "train", "test", "longrec",
                            "score"]
    exp = os.path.join(port_root, "exps", "rehearse_fixmatch")
    assert os.path.exists(os.path.join(exp, "best-MeanIoU.ckpt"))
    labels = np.load(os.path.join(port_root, "longrec_out", "labels.npy"))
    assert labels.shape == (1000,)

    jax = recorded_jax_chain(jax_root, monkeypatch)
    assert list(summary) == list(jax["summary"])
    assert {k: summary[k] for k in ("records", "epochs", "fs",
                                    "algorithm")} == \
        {k: jax["summary"][k] for k in ("records", "epochs", "fs",
                                        "algorithm")}
    assert read_tree(port_root, ["raw"]) == read_tree(jax_root, ["raw"])
    assert read_tree(os.path.join(port_root, "prepared"), PREPARED) == \
        read_tree(os.path.join(jax_root, "prepared"), PREPARED)
    with open(argvs["train_main"][1]) as f:
        ours = yaml.safe_load(f)
    assert ours.pop("device") == "cpu" and jax["config"].pop("device") is None
    assert ours == yaml.safe_load(yaml.dump(jax["config"]).replace(
        jax_root, port_root))
    assert argvs["test_main"] == argvs["train_main"]
    assert argvs["infer_longrec_main"] == [
        a.replace(jax_root, port_root) for a in jax["longrec"]]


def test_synthetic_wfdb_is_the_jax_packages(tmp_path):
    ours = make_synthetic_wfdb(str(tmp_path / "port"), num_records=4,
                               fs=360, seconds=1.5, seed=2, ann_ext="q1c")
    theirs = jax_wfdb(str(tmp_path / "jax"), num_records=4, fs=360,
                      seconds=1.5, seed=2, ann_ext="q1c")
    assert read_tree(tmp_path, ["port"]) == {
        k.replace("jax/", "port/"): v
        for k, v in read_tree(tmp_path, ["jax"]).items()}
    assert ours["record_names"] == theirs["record_names"]
    for name in ours["record_names"]:
        np.testing.assert_array_equal(ours["masks"][name],
                                      theirs["masks"][name])


def test_rehearsal_config_is_the_jax_tools(tmp_path):
    for length, algorithm in ((2500, "fixmatch"), (500, "mean_teacher")):
        ours = rehearse_wfdb.build_config("/r", "/d", 3, algorithm, 1,
                                          length, 2, device="cpu")
        theirs = jax_rehearse.build_config("/r", "/d", 3, algorithm, 1,
                                           length, 2)
        assert ours.pop("device") == "cpu" and theirs.pop("device") is None
        assert ours == theirs


# ---------------------------------------------------------------------------
# The converter
# ---------------------------------------------------------------------------

FAMILIES = {"resnet18": lambda: resnet_config(dropout=0.0),
            "vit_tiny": vit_config,
            "resnet18-avgdown": lambda: resnet_config(
                dropout=0.0, deep_stem=True, avg_down=True)}


@functools.lru_cache(maxsize=None)
def init_trees(family):
    """A family's config and its JAX init trees, compiled once a process
    (a ResNet's init compiles for seconds)."""
    cfg = FAMILIES[family]()
    variables = jax.jit(jax_build(cfg).init)(
        {"params": jax.random.key(0), "dropout": jax.random.key(1)},
        jnp.zeros((2, 1, SEQ), jnp.float32))
    return cfg, jax.device_get(variables)


def trees(family, seed):
    """The family's config and its init trees plus numpy noise from
    ``seed`` (running variances kept positive)."""
    cfg, variables = init_trees(family)
    rng = np.random.default_rng(seed)

    def noisy(tree, positive=False):
        if isinstance(tree, dict):
            return {k: noisy(v, positive or k == "var")
                    for k, v in tree.items()}
        a = np.asarray(tree, np.float32)
        a = a + 0.1 * rng.standard_normal(a.shape).astype(np.float32)
        return np.abs(a) + 0.5 if positive else a

    return (copy.deepcopy(cfg), noisy(dict(variables["params"])),
            noisy(dict(variables["batch_stats"])))


def jax_checkpoint(path, family, seed=7, ema=True):
    """A JAX ``.ckpt`` of perturbed trees with its config, metrics and an
    EMA teacher; the config and the trees."""
    cfg, params, stats = trees(family, seed)
    ema_state = ModelState(*trees(family, seed + 1)[1:]) if ema else None
    jax_ckpt.save_checkpoint(path, 3, ModelState(params, stats), config=cfg,
                             metrics={"MeanIoU": 0.625}, ema_state=ema_state)
    return cfg, params, stats


def port_logits(model, x):
    with torch.no_grad():
        return model.eval()(torch.from_numpy(x))["seg_logits"].numpy()


def assert_payloads_equal(ours, theirs):
    assert list(ours) == list(theirs)
    for key in ours:
        if isinstance(ours[key], dict) and key.startswith("model"):
            assert list(ours[key]) == list(theirs[key]), key
            for name, t in ours[key].items():
                assert t.dtype == theirs[key][name].dtype, name
                assert torch.equal(t, theirs[key][name]), name
        else:
            assert ours[key] == theirs[key], key


@pytest.mark.parametrize("family", ["resnet18", "vit_tiny"])
def test_to_torch_of_a_jax_ckpt_is_the_jax_tools(tmp_path, family):
    src = str(tmp_path / "best.ckpt")
    jax_checkpoint(src, family)
    for tool, name in ((convert_checkpoint, "port"), (jax_convert, "jax")):
        tool.main(["to-torch", src, str(tmp_path / f"{name}.pth")])
    ours = torch.load(tmp_path / "port.pth", weights_only=True)
    theirs = torch.load(tmp_path / "jax.pth", weights_only=True)
    assert set(ours) == {"epoch", "model", "optimizer", "scaler", "config",
                         "metrics", "model_ema"}
    assert set(theirs) == set(ours)
    assert_payloads_equal(ours, {k: theirs[k] for k in ours})
    # and it loads strictly into the port's model
    model = build_model_from_config(ours["config"])
    model.load_state_dict(ours["model"], strict=True)


def test_to_torch_names_avg_down_as_the_configs_model(tmp_path):
    """The JAX trees do not say ``avg_down``; with the embedded config the
    ``.pth`` takes the model's shifted downsample names (the JAX tool
    writes the unshifted ones)."""
    src, dst = str(tmp_path / "best.ckpt"), str(tmp_path / "best.pth")
    cfg, params, stats = jax_checkpoint(src, "resnet18-avgdown", ema=False)
    convert_checkpoint.main(["to-torch", src, dst])
    model = build_model_from_config(cfg)
    got = torch.load(dst, weights_only=True)["model"]
    model.load_state_dict(got, strict=True)
    want = jax_trees_to_state_dict(params, stats, model.state_dict().keys())
    assert "backbone.layer2.0.downsample.1.weight" in got
    assert list(got) == list(want)
    for key, value in want.items():
        assert torch.equal(got[key], value), key


@pytest.mark.parametrize("family", ["resnet18", "vit_tiny"])
def test_to_framework_loads_into_both_models(tmp_path, family):
    src = str(tmp_path / "best.ckpt")
    cfg, params, stats = jax_checkpoint(src, family)
    pth, ckpt = str(tmp_path / "ref.pth"), str(tmp_path / "back.ckpt")
    jax_convert.main(["to-torch", src, pth])   # a reference-layout .pth
    convert_checkpoint.main(["to-framework", pth, ckpt])
    payload = jax_ckpt.load_checkpoint(ckpt)
    assert payload["epoch"] == 3 and payload["metrics"] == {"MeanIoU": 0.625}
    restored = jax_ckpt.restore_model_state(payload["model"],
                                            ModelState(params, stats))
    for got, want in ((restored.params, params),
                      (restored.batch_stats, stats)):
        jax.tree_util.tree_map(np.testing.assert_array_equal, got, want)
    x = inputs(seed=3)
    theirs = jax_logits(jax_build(cfg, train=False, serving=True),
                        restored.params, restored.batch_stats, x)

    model = build_model_from_config(cfg)
    model.load_state_dict(port_ckpt.model_state_dict(
        port_ckpt.load_checkpoint(ckpt)["model"]), strict=True)
    ours = port_logits(model, x)
    np.testing.assert_allclose(ours, theirs, atol=1e-5, rtol=0)
    teacher = build_model_from_config(cfg)
    teacher.load_state_dict(port_ckpt.model_state_dict(
        port_ckpt.load_checkpoint(ckpt)["model_ema"]), strict=True)


def test_to_framework_backbone_only_warm_starts_both(tmp_path):
    """A bare backbone ``.pth`` (no config) with ``-f`` becomes a ``.ckpt``
    that both packages' ``pretrained_backbone`` take."""
    from semi_seg_ecg_tpu.algorithms.common import (
        load_pretrained_backbone as jax_load_backbone)
    from semi_seg_ecg_tpu_torch.algorithms.common import (
        load_pretrained_backbone)

    cfg, params, stats = trees("resnet18", 6)
    full = jax_trees_to_state_dict(params, stats)
    bare = {k[len("backbone."):]: v for k, v in full.items()
            if k.startswith("backbone.")}
    pth, ckpt = str(tmp_path / "bare.pth"), str(tmp_path / "bare.ckpt")
    torch.save({"model": {**bare, "mask_embedding": torch.zeros(3)}}, pth)
    cfg_path = tmp_path / "cfg.yaml"
    cfg_path.write_text(yaml.dump(cfg))
    convert_checkpoint.main(["to-framework", pth, ckpt, "-f",
                             str(cfg_path)])
    cfg = dict(cfg, mode="finetune", pretrained_backbone=ckpt)
    model = build_model_from_config(cfg)
    load_pretrained_backbone(cfg, model)
    for key, value in bare.items():
        assert torch.equal(model.backbone.state_dict()[key], value), key
    template = ModelState(*trees("resnet18", 9)[1:])
    warm = jax_load_backbone(cfg, template)
    jax.tree_util.tree_map(np.testing.assert_array_equal,
                           warm.params["backbone"], params["backbone"])
    jax.tree_util.tree_map(np.testing.assert_array_equal,
                           warm.batch_stats["backbone"], stats["backbone"])


@pytest.mark.parametrize("backend", ["pickle", "orbax"])
def test_to_torch_of_the_ports_own_checkpoints(tmp_path, backend):
    cfg = vit_config()
    torch.manual_seed(0)
    model, teacher = build_model_from_config(cfg), build_model_from_config(
        cfg)
    src, dst = str(tmp_path / "best.ckpt"), str(tmp_path / "best.pth")
    port_ckpt.save_checkpoint(src, 2, model, config=cfg,
                              metrics={"MeanIoU": 0.25}, ema_model=teacher,
                              backend=backend)
    assert os.path.isdir(src) == (backend == "orbax")
    convert_checkpoint.main(["to-torch", src, dst])
    out = torch.load(dst, weights_only=True)
    assert out["epoch"] == 2 and out["metrics"] == {"MeanIoU": 0.25}
    for key, module in (("model", model), ("model_ema", teacher)):
        want = module.state_dict()
        assert list(out[key]) == list(want)
        for name, t in want.items():
            assert torch.equal(out[key][name], t), name


def test_jax_orbax_directory_is_refused(tmp_path):
    cfg, params, stats = trees("vit_tiny", 1)
    src = str(tmp_path / "best.ckpt")
    jax_ckpt.save_checkpoint(src, 0, ModelState(params, stats), config=cfg,
                             backend="orbax")
    assert os.path.isdir(src)
    with pytest.raises(NotImplementedError, match="to-torch"):
        convert_checkpoint.main(["to-torch", src,
                                 str(tmp_path / "best.pth")])
    assert not os.path.exists(tmp_path / "best.pth")
