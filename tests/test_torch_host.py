"""The port's copies of the host-side code against the JAX package's.

``config.py`` must merge every shipped YAML to an equal dict (and normalize
it alike, apart from the device key, which names a torch device in the
port); ``data/*`` must give bit-equal test-split items and batches on the
``data/synthetic.py`` fixture.
"""

import glob
import os

import numpy as np
import pytest

from semi_seg_ecg_tpu import config as jax_config
from semi_seg_ecg_tpu.data.dataset import build_seg_dataset as jax_dataset
from semi_seg_ecg_tpu.data.loader import get_dataloader as jax_loader
from semi_seg_ecg_tpu.data.synthetic import make_synthetic_dataset as jax_make
from semi_seg_ecg_tpu_torch import config as torch_config
from semi_seg_ecg_tpu_torch.data.dataset import build_seg_dataset
from semi_seg_ecg_tpu_torch.data.loader import get_dataloader
from semi_seg_ecg_tpu_torch.data.synthetic import make_synthetic_dataset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(REPO, "configs", "**", "*.yaml"),
                           recursive=True))


def test_every_config_is_found():
    assert len(CONFIGS) >= 30


@pytest.mark.parametrize("path", CONFIGS,
                         ids=[os.path.relpath(p, REPO) for p in CONFIGS])
def test_config_merges_and_normalizes_alike(path):
    base = os.path.join(REPO, "configs", "base", "vit_tiny", "scratch.yaml")
    for args in ((path,), (base, path)):
        ours = torch_config.load_config(*args)
        theirs = jax_config.load_config(*args)
        assert ours == theirs
        ours_n = torch_config.normalize_config(ours)
        theirs_n = jax_config.normalize_config(theirs)
        assert ours_n.pop("device") in ("cuda", "cpu")
        theirs_n.pop("device")
        assert ours_n == theirs_n


@pytest.mark.parametrize("device,expected", [
    ("tpu", "cuda"), ("cuda", "cuda"), ("gpu", "cuda"), (None, "cuda"),
    ("cpu", "cpu")])
def test_device_key_names_a_torch_device(device, expected):
    cfg = {} if device is None else {"device": device}
    assert torch_config.normalize_config(cfg)["device"] == expected


def test_synthetic_fixture_is_byte_equal(tmp_path):
    kw = dict(num_train_labeled=2, num_train_unlabeled=2, num_valid=2,
              num_test=3, length=500, seed=5)
    ours = make_synthetic_dataset(str(tmp_path / "ours"), **kw)
    theirs = jax_make(str(tmp_path / "theirs"), **kw)
    for sub in ("ecg", "label", "index"):
        names = sorted(os.listdir(ours[f"{sub}_dir"]))
        assert names == sorted(os.listdir(theirs[f"{sub}_dir"]))
        for name in names:
            with open(os.path.join(ours[f"{sub}_dir"], name), "rb") as f:
                a = f.read()
            with open(os.path.join(theirs[f"{sub}_dir"], name), "rb") as f:
                assert a == f.read(), f"{sub}/{name}"


@pytest.fixture(scope="module")
def test_split_cfg(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_host_data")
    cfg = make_synthetic_dataset(str(root), num_train_labeled=1,
                                 num_train_unlabeled=1, num_valid=1,
                                 num_test=5, length=1000, seed=2)
    cfg.update(
        signal_length=750,  # resample path
        filter=[{"highpass_filter": {"fs": 250, "cutoff": 0.67}},
                {"lowpass_filter": {"fs": 250, "cutoff": 40}}],
        transforms=[{"standardize": {"axis": [-1, -2]}},
                    {"to_tensor": {"dtype": "float"}}],
    )
    return cfg


def test_test_split_items_are_bit_equal(test_split_cfg):
    ours = build_seg_dataset(test_split_cfg, split="test")
    theirs = jax_dataset(test_split_cfg, split="test")
    assert len(ours) == len(theirs) == 5
    for i in range(len(ours)):
        a, b = ours[i], theirs[i]
        assert a.keys() == b.keys() == {"ecg", "target"}
        for key in a:
            assert a[key].dtype == b[key].dtype
            np.testing.assert_array_equal(a[key], b[key])


def test_test_loader_batches_are_bit_equal(test_split_cfg):
    kw = dict(mode="test", batch_size=2, seed=0, num_workers=2)
    ours = get_dataloader(build_seg_dataset(test_split_cfg, split="test"),
                          **kw)
    theirs = jax_loader(jax_dataset(test_split_cfg, split="test"), **kw)
    np.testing.assert_array_equal(ours.step_indices(), theirs.step_indices())
    batches = list(zip(ours, theirs))
    assert len(batches) == 3
    for a, b in batches:
        for key in b:
            np.testing.assert_array_equal(a[key], b[key])
    ours.close()
    theirs.close()
