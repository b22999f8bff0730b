"""``dataset.device_cache`` in the port against the JAX package, on the CPU.

- The row map: an oversampled labeled list (8 files repeated to 40 rows)
  keeps each file once, every repeat mapping to its file's row, and a
  ``Subset`` view (ST++'s stages 2-3) composes through it; the port's
  ``_base_and_rowmap`` gives the JAX package's rows on the same files.
- ``plan_allows_device_cache`` gives the JAX package's reason, word for
  word, on five configs it refuses and none on one it allows.
- A one-epoch FixMatch ``train_main`` of the tiny ViT recipe (device
  augmentation, flash attention's plain version) with the cache against
  the same run streaming: the steps receive index batches, and the
  per-step losses and the final checkpoint's model equal the streaming
  run's bit for bit (the same rows, the same draws, the same arithmetic;
  the JAX package holds its cached run within rtol 1e-5).

``slow``: ST++ (three stages, stages 2-3 on a ``Subset`` of the unlabeled
split) with the cache against streaming, bit for bit.
"""

import copy
import os

import numpy as np
import pytest
import torch
import yaml

from semi_seg_ecg_tpu.algorithms import fixmatch as jax_fixmatch
from semi_seg_ecg_tpu.algorithms import base as jax_base
from semi_seg_ecg_tpu.data import dataset as jax_dataset
from semi_seg_ecg_tpu.data import device_cache as jax_cache
from semi_seg_ecg_tpu_torch.algorithms import base, common, fixmatch
from semi_seg_ecg_tpu_torch.cli import train_main
from semi_seg_ecg_tpu_torch.data import dataset
from semi_seg_ecg_tpu_torch.data import device_cache
from semi_seg_ecg_tpu_torch.data.synthetic import make_synthetic_dataset
from semi_seg_ecg_tpu_torch.utils import checkpoint as ckpt
from tests.test_torch_preprocess import fixmatch_dataset_cfg
from tests.test_torch_train_slice import tiny_recipe
from tests.torch_dist_worker import one_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return make_synthetic_dataset(
        str(tmp_path_factory.mktemp("cache_data")), num_train_labeled=8,
        num_train_unlabeled=16, num_valid=2, num_test=2, length=500, seed=3)


def test_rowmap_dedup_and_subset(data):
    ds = dataset.build_seg_dataset(dict(data), split="train_labeled",
                                   num_unlabeled=40)  # 8 files, 40 rows
    base_ds, rowmap, uniques = device_cache._base_and_rowmap(ds)
    assert len(rowmap) == 40 and len(uniques) == 8
    for i in range(40):
        assert base_ds.filenames[i] == base_ds.filenames[uniques[rowmap[i]]]
    sub = dataset.Subset(ds, [3, 11, 19])  # the same file every 8 rows
    _, sub_rowmap, _ = device_cache._base_and_rowmap(sub)
    assert sub_rowmap.tolist() == [rowmap[3]] * 3
    theirs = jax_dataset.build_seg_dataset(dict(data), split="train_labeled",
                                           num_unlabeled=40)
    for ours_view, their_view in ((ds, theirs),
                                  (sub, jax_dataset.Subset(theirs,
                                                           [3, 11, 19]))):
        _, a, ua = device_cache._base_and_rowmap(ours_view)
        _, b, ub = jax_cache._base_and_rowmap(their_view)
        assert a.tolist() == b.tolist() and ua == ub


def plan_configs():
    """(name, config, algorithm) pairs: five that refuse the cache, one
    that allows it."""
    ds = dict(fixmatch_dataset_cfg(), device_cache=True)
    host_op = {"lowpass_filter": {"fs": 250, "cutoff": 40}}
    strong_host = [{"RandAugment": {"ops": [host_op], "level": 10,
                                    "num_layers": 1, "prob": 0.5}}]
    return [
        ("no_device_augment", dict(ds, device_augment=False), "fixmatch"),
        ("train_crop", dict(ds, train_crop={"random_crop": {"length": 200}}),
         "fixmatch"),
        ("host_only", dict(ds, augmentations=[host_op],
                           strong_augmentations=strong_host), "fixmatch"),
        ("weak_on_host", dict(ds, augmentations=[host_op]), "fixmatch"),
        ("strong_on_host", dict(ds, strong_augmentations=strong_host),
         "fixmatch"),
        ("strong_on_host_supervised",
         dict(ds, strong_augmentations=strong_host), "base"),
    ]


@pytest.mark.parametrize("name,ds,algorithm", plan_configs(),
                         ids=[c[0] for c in plan_configs()])
def test_plan_reasons_match_jax(name, ds, algorithm):
    specs = {"fixmatch": (fixmatch.SPEC, jax_fixmatch.SPEC),
             "base": (base.SPEC, jax_base.SPEC)}[algorithm]
    config = {"dataset": ds}
    ours = device_cache.plan_allows_device_cache(config, specs[0])
    theirs = jax_cache.plan_allows_device_cache(config, specs[1])
    assert ours == theirs
    # a supervised run never takes the unlabeled branch
    assert (ours is None) == (name == "strong_on_host_supervised")


def run_recorded(monkeypatch, path):
    """``train_main`` of ``path``, recording each step's batch keys and
    losses."""
    steps = []
    real = common.Trainer.train_step

    def recorded(self, batch):
        metrics = real(self, batch)
        steps.append((sorted(batch), {k: v.item() for k, v in
                                      metrics.items()}))
        return metrics

    monkeypatch.setattr(common.Trainer, "train_step", recorded)
    train_main(["-f", path])
    monkeypatch.setattr(common.Trainer, "train_step", real)
    return steps


def test_cached_fixmatch_trains_as_streaming(tmp_path, monkeypatch, capsys):
    cfg, stream_path = tiny_recipe(tmp_path, "vit_tiny", "fixmatch",
                                   "stream")
    cached = copy.deepcopy(cfg)
    cached["exp_name"] = "cached"
    cached["dataset"]["device_cache"] = True
    cache_path = str(tmp_path / "cached.yaml")
    with open(cache_path, "w") as f:
        yaml.safe_dump(cached, f)
    streamed = run_recorded(monkeypatch, stream_path)
    got = run_recorded(monkeypatch, cache_path)
    assert "device_cache: 0.0 MB raw prefix resident on cpu" in \
        capsys.readouterr().out
    assert len(got) == len(streamed) == 2
    for (keys, losses), (want_keys, want) in zip(got, streamed):
        assert keys == ["idx", "idx_u"]
        assert want_keys == ["ecg", "ecg_u_w", "target"]
        assert losses == want  # bit for bit
    exps = tmp_path / "exps"
    a = ckpt.load_checkpoint(str(exps / "cached" / "best-loss.ckpt"))
    b = ckpt.load_checkpoint(str(exps / "stream" / "best-loss.ckpt"))
    for k, v in b["model"].items():
        np.testing.assert_array_equal(a["model"][k], v, err_msg=k)


def test_refused_cache_streams_and_says_why(tmp_path, capsys):
    """A plan that keeps an augmentation on the host logs the JAX
    package's reason on every rank and builds no cache."""
    cfg, _ = tiny_recipe(tmp_path, "vit_tiny", "fixmatch", "refused")
    cfg["dataset"].update(device_cache=True, augmentations=[
        {"lowpass_filter": {"fs": 250, "cutoff": 40}}])
    loaders = {"labeled": None}
    trainer = common.Trainer.__new__(common.Trainer)
    trainer.config, trainer.device, trainer.cache = cfg, torch.device(
        "cpu"), None
    trainer.use_device_cache(fixmatch.SPEC, loaders)
    assert trainer.cache is None and loaders == {"labeled": None}
    assert "device_cache disabled: weak augmentations fall back to the " \
        "host" in capsys.readouterr().out


@pytest.mark.slow
def test_cached_stpp_trains_as_streaming(tmp_path, monkeypatch):
    """ST++'s three stages, stages 2-3 on the reliable ``Subset`` of the
    unlabeled split, with the cache against streaming: every step's
    losses bit for bit."""
    cfg, stream_path = tiny_recipe(tmp_path, "vit_tiny", "stpp", "stream")
    cached = copy.deepcopy(cfg)
    cached["exp_name"] = "cached"
    cached["dataset"]["device_cache"] = True
    cache_path = str(tmp_path / "cached.yaml")
    with open(cache_path, "w") as f:
        yaml.safe_dump(cached, f)
    streamed = run_recorded(monkeypatch, stream_path)
    got = run_recorded(monkeypatch, cache_path)
    assert len(got) == len(streamed) > 2
    assert all(keys[0].startswith("idx") for keys, _ in got)
    assert [losses for _, losses in got] == [losses for _, losses in streamed]
    assert os.path.exists(str(tmp_path / "exps" / "cached"))
