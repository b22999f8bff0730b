"""The port's copies of the host-side code against the JAX package's.

``config.py`` must merge every shipped YAML to an equal dict (and normalize
it alike, apart from the device key, which names a torch device in the
port); ``data/*`` must give bit-equal test-split items and batches on the
``data/synthetic.py`` fixture. ``data/wfdb_io.py``: files written by either
package's ``wrsamp`` / ``wrann`` are byte-equal and read back by the other's
``rdrecord`` / ``rdann`` bit for bit; ``make_synthetic_wfdb`` writes
byte-equal records. ``ops/delineation.py`` gives exactly equal intervals,
matches and metrics on seeded random label fields.
``utils/checkpoint.resolve_checkpoint_url`` resolves ``file://``, a plain
path and an http URL found in ``$TORCH_HOME/hub/checkpoints`` to the JAX
package's paths, and a cache miss raises in both.
"""

import glob
import os

import numpy as np
import pytest

from semi_seg_ecg_tpu import config as jax_config
from semi_seg_ecg_tpu.data.dataset import build_seg_dataset as jax_dataset
from semi_seg_ecg_tpu.data.loader import get_dataloader as jax_loader
from semi_seg_ecg_tpu.data import wfdb_io as jax_wfdb
from semi_seg_ecg_tpu.data.synthetic import make_synthetic_dataset as jax_make
from semi_seg_ecg_tpu.data.synthetic import (
    make_synthetic_wfdb as jax_wfdb_make,
)
from semi_seg_ecg_tpu.ops import delineation as jax_delineation
from semi_seg_ecg_tpu.utils.checkpoint import (
    resolve_checkpoint_url as jax_resolve_url,
)
from semi_seg_ecg_tpu_torch import config as torch_config
from semi_seg_ecg_tpu_torch.data.dataset import build_seg_dataset
from semi_seg_ecg_tpu_torch.data.loader import get_dataloader
from semi_seg_ecg_tpu_torch.data import wfdb_io
from semi_seg_ecg_tpu_torch.data.synthetic import (
    make_synthetic_dataset,
    make_synthetic_wfdb,
)
from semi_seg_ecg_tpu_torch.ops import delineation
from semi_seg_ecg_tpu_torch.utils.checkpoint import resolve_checkpoint_url

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


def read_bytes(path):
    with open(path, "rb") as f:
        return f.read()


def assert_same_record(a, b):
    assert (a.record_name, a.fs, a.n_sig, a.sig_len, a.sig_name) == \
        (b.record_name, b.fs, b.n_sig, b.sig_len, b.sig_name)
    assert a.p_signal.dtype == b.p_signal.dtype == np.float64
    np.testing.assert_array_equal(a.p_signal, b.p_signal)


def assert_same_annotation(a, b):
    assert a.symbol == b.symbol and a.aux_note == b.aux_note
    for key in ("sample", "num", "subtype", "chan"):
        np.testing.assert_array_equal(getattr(a, key), getattr(b, key))


@pytest.mark.parametrize("fmt", [16, 212])
def test_wfdb_io_round_trips_between_the_packages(tmp_path, fmt):
    rng = np.random.default_rng(fmt)
    signal = rng.standard_normal((777, 3)) * 0.4
    signal[5, 1] = np.nan  # the format's invalid-sample sentinel
    # annotation gaps past the 10-bit interval field take SKIP words
    samples = np.sort(rng.integers(0, 5000, 40))
    samples[-1] = 3000 + samples[-2]
    symbols = [str(s) for s in rng.choice(["(", "p", "N", "t", ")"], 40)]
    for writer, io_mod in (("ours", wfdb_io), ("theirs", jax_wfdb)):
        base = str(tmp_path / writer / "rec")
        os.makedirs(os.path.dirname(base))
        io_mod.wrsamp(base, 360.0, signal, fmt=fmt, gain=100.0,
                      sig_names=["i", "ii", "v1"])
        io_mod.wrann(base, "atr", samples, symbols)
    ours, theirs = str(tmp_path / "ours" / "rec"), str(tmp_path / "theirs"
                                                      / "rec")
    for ext in (".hea", ".dat", ".atr"):
        assert read_bytes(ours + ext) == read_bytes(theirs + ext), ext
    for path in (ours, theirs + ".hea"):
        assert_same_record(wfdb_io.rdrecord(path), jax_wfdb.rdrecord(path))
        assert_same_annotation(wfdb_io.rdann(path, "atr"),
                               jax_wfdb.rdann(path, "atr"))
    assert np.isnan(wfdb_io.rdrecord(ours).p_signal[5, 1])
    np.testing.assert_array_equal(wfdb_io.rdann(theirs, "atr").sample,
                                  samples)


def test_wfdb_io_refuses_alike(tmp_path):
    base = str(tmp_path / "rec")
    for io_mod in (wfdb_io, jax_wfdb):
        with pytest.raises(ValueError, match="non-decreasing"):
            io_mod.wrann(base, "atr", np.array([3, 1]), ["N", "N"])
        with pytest.raises(ValueError, match="mismatch"):
            io_mod.wrann(base, "atr", np.array([1, 3]), ["N"])


def test_synthetic_wfdb_is_byte_equal(tmp_path):
    kw = dict(num_records=3, fs=250, seconds=3.0, seed=4)
    ours = make_synthetic_wfdb(str(tmp_path / "ours"), **kw)
    theirs = jax_wfdb_make(str(tmp_path / "theirs"), **kw)
    assert ours["record_names"] == theirs["record_names"]
    assert (ours["ann_ext"], ours["fs"]) == (theirs["ann_ext"],
                                            theirs["fs"])
    names = sorted(os.listdir(ours["records_dir"]))
    assert names == sorted(os.listdir(theirs["records_dir"]))
    assert {n.rsplit(".", 1)[1] for n in names} == {"hea", "dat", "i"}
    for name in names:
        assert read_bytes(os.path.join(ours["records_dir"], name)) == \
            read_bytes(os.path.join(theirs["records_dir"], name)), name
    for name, mask in theirs["masks"].items():
        np.testing.assert_array_equal(ours["masks"][name], mask)


def label_field(seed, total=3000):
    """Runs of random classes 0-3 and random lengths 1-60 samples."""
    rng = np.random.default_rng(seed)
    runs = rng.integers(1, 61, total)
    classes = rng.integers(0, 4, total)
    return np.repeat(classes, runs)[:total]


@pytest.mark.parametrize("seed", range(4))
def test_delineation_is_the_jax_delineation(seed):
    pred, true = label_field(seed), label_field(seed + 100)
    # a prediction near the truth: boundaries shifted by a few samples
    near = np.roll(true, int(np.random.default_rng(seed).integers(-6, 7)))
    for min_duration in (1, 5):
        for classes in (None, [1, 3]):
            ours = delineation.labels_to_intervals(pred, classes,
                                                   min_duration)
            theirs = jax_delineation.labels_to_intervals(pred, classes,
                                                         min_duration)
            np.testing.assert_equal(ours, theirs)
            np.testing.assert_array_equal(
                delineation.intervals_to_labels(ours, pred.size),
                jax_delineation.intervals_to_labels(theirs, pred.size))
    for p, t in ((pred, true), (near, true)):
        for tolerance in (0, 3, 40):
            np.testing.assert_equal(
                delineation.match_boundaries(np.flatnonzero(np.diff(p)),
                                             np.flatnonzero(np.diff(t)),
                                             tolerance),
                jax_delineation.match_boundaries(
                    np.flatnonzero(np.diff(p)), np.flatnonzero(np.diff(t)),
                    tolerance))
        for kw in ({"fs": 250.0}, {"fs": 500.0, "tolerance_ms": 20.0,
                                   "min_duration": 4, "classes": [2, 3]}):
            np.testing.assert_equal(
                delineation.delineation_metrics(p, t, **kw),
                jax_delineation.delineation_metrics(p, t, **kw))


def test_resolve_checkpoint_url_is_the_jax_one(tmp_path, monkeypatch):
    monkeypatch.setenv("TORCH_HOME", str(tmp_path / "torch_home"))
    cache = tmp_path / "torch_home" / "hub" / "checkpoints"
    cache.mkdir(parents=True)
    (cache / "model.pth").write_bytes(b"x")
    local = str(tmp_path / "ckpt.bin")
    for url, want in ((f"file://{local}", local), (local, local),
                      ("https://example.com/weights/model.pth?dl=1",
                       str(cache / "model.pth"))):
        assert resolve_checkpoint_url(url) == jax_resolve_url(url) == want
    for resolve in (resolve_checkpoint_url, jax_resolve_url):
        with pytest.raises(FileNotFoundError, match="pre-downloaded"):
            resolve("http://example.com/absent.pth")
