"""Long-record serving of the port against the JAX package's.

``ops/stitch.py`` (``plan_windows``, ``_taper``, ``overlap_add_infer``),
``serving.py`` (``long_record_inference``, ``StreamingSegmenter``) and
``cli.infer_longrec_main``, each held against its JAX counterpart on the
same inputs, made from a seed with numpy:

- the window plan and the taper are exactly equal;
- the stitcher, with a model written alike in both frameworks (the softmax
  of a fixed 1-D convolution), within atol 2e-6 over a fuzz of geometries
  (hop = window, window/2, window/4; records shorter than, equal to and
  not a multiple of the window; batch 1, 3, 64) — the JAX tests' bound
  against their numpy oracle;
- ``long_record_inference`` on real small models at fp32 (ViT-1D depth 2
  with flash attention, the JAX kernel in interpret mode and the port's
  plain version; a narrow 2-stage ResNet-1D) with the shipped filter
  chain, from one JAX ``.ckpt``: probabilities within atol 1e-5, labels
  equal except where the top two probabilities lie within 1e-5;
- the streaming segmenter fed random chunk sizes against the port's
  offline stitcher (atol 2e-6) and against the JAX segmenter;
- ``infer-longrec`` on ``.npy`` and WFDB records and a directory, with
  ``--intervals``, ``--eval-labels`` and ``--model-fs``: ``probs.npy``
  within 1e-5, ``intervals.csv`` and the delineation table equal;
- ``mesh=`` on two gloo ranks of ``tests/torch_dist_worker.py``: the
  stitcher, ``long_record_inference`` and the streaming segmenter on
  every rank against one process and against the JAX package's ``mesh=``
  on a 2-device CPU mesh within 1e-5, each window run once, a rank that
  sees only padding running none, and the stream count the data axis does
  not divide refused in the JAX package's words.
"""

import contextlib
import io
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
import yaml

from semi_seg_ecg_tpu import serving as jax_serving
from semi_seg_ecg_tpu.cli import infer_longrec_main as jax_longrec_main
from semi_seg_ecg_tpu.config import normalize_config as jax_normalize
from semi_seg_ecg_tpu.models import build_model_from_config as jax_build
from semi_seg_ecg_tpu.ops import stitch as jax_stitch
from semi_seg_ecg_tpu.utils.checkpoint import save_checkpoint
from semi_seg_ecg_tpu.utils.train_state import ModelState
from semi_seg_ecg_tpu_torch import serving
from semi_seg_ecg_tpu_torch.cli import infer_longrec_main
from semi_seg_ecg_tpu_torch.config import normalize_config
from semi_seg_ecg_tpu_torch.data.synthetic import make_synthetic_wfdb
from semi_seg_ecg_tpu_torch.ops import stitch
from semi_seg_ecg_tpu_torch.parallel import mesh as pmesh

C, LEADS, WINDOW = 3, 2, 32
SIG = 250  # the small models' window: 1 s at 250 Hz
TIE = 1e-5
FILTERS = [{"highpass_filter": {"fs": 250, "cutoff": 0.67}},
           {"lowpass_filter": {"fs": 250, "cutoff": 40}}]
KERNEL = np.random.default_rng(7).standard_normal((C, LEADS, 5)).astype(
    np.float32)


def jax_conv_infer(x):
    y = jax.lax.conv_general_dilated(
        x, jnp.asarray(KERNEL[:, :x.shape[1]]), (1,), [(2, 2)],
        dimension_numbers=("NCH", "OIH", "NCH"))
    return jax.nn.softmax(y, axis=1)


class ConvInfer:
    """The port's twin of :func:`jax_conv_infer`, with the attributes the
    stitcher and the streaming segmenter read."""

    device = torch.device("cpu")
    num_classes = C

    def __init__(self):
        self.calls = []

    def __call__(self, x):
        self.calls.append(tuple(x.shape))
        w = torch.from_numpy(KERNEL[:, :x.shape[1]])
        return torch.softmax(F.conv1d(x, w, padding=2), dim=1)


def record(seed, total, leads=LEADS):
    return np.random.default_rng(seed).standard_normal(
        (leads, total)).astype(np.float32)


def assert_labels_match(got, want, probs):
    """Equal labels, except where the top two probabilities lie within
    ``TIE``."""
    top2 = np.sort(probs, axis=0)[-2:]
    tie = (top2[1] - top2[0]) <= TIE
    assert np.array_equal(got[~tie], want[~tie])


# ---------------------------------------------------------------------------
# ops/stitch.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("total,window,hop,batch", [
    (1, 32, 32, 1), (31, 32, 16, 3), (32, 32, 8, 64), (900_000, 2500, 1250,
                                                        64),
    (21_600_000, 2500, 1250, 64), (30_000, 2500, 2500, 7)])
def test_plan_windows_is_the_jax_plan(total, window, hop, batch):
    assert stitch.plan_windows(total, window, hop, batch) == \
        jax_stitch.plan_windows(total, window, hop, batch)


@pytest.mark.parametrize("kind", ["hann", "flat"])
@pytest.mark.parametrize("window", [1, 8, 2500])
def test_taper_is_the_jax_taper(kind, window):
    ours, theirs = stitch._taper(window, kind), jax_stitch._taper(window,
                                                                   kind)
    assert ours.dtype == theirs.dtype
    np.testing.assert_array_equal(ours, theirs)


def test_plan_and_taper_refuse_alike():
    with pytest.raises(ValueError, match="must divide"):
        stitch.plan_windows(100, WINDOW, 10, 4)
    with pytest.raises(ValueError, match="at least one sample"):
        stitch.plan_windows(0, WINDOW, 16, 4)
    with pytest.raises(ValueError, match="unknown taper"):
        stitch._taper(WINDOW, "kaiser")


@pytest.mark.parametrize("batch", [1, 3, 64])
@pytest.mark.parametrize("hop", [WINDOW, WINDOW // 2, WINDOW // 4])
def test_overlap_add_matches_jax(hop, batch):
    for i, total in enumerate((WINDOW - 5, WINDOW, 3 * WINDOW + 7, 150)):
        ecg = record(100 * hop + 10 * batch + i, total)
        infer = ConvInfer()
        probs, labels = stitch.overlap_add_infer(infer, ecg, window=WINDOW,
                                                 hop=hop, batch=batch)
        want, want_labels = jax_stitch.overlap_add_infer(
            jax_conv_infer, ecg, window=WINDOW, hop=hop, batch=batch)
        assert probs.shape == (C, total) and probs.dtype == torch.float32
        assert labels.shape == (total,) and labels.dtype == torch.int32
        np.testing.assert_allclose(probs.numpy(), np.asarray(want),
                                   atol=2e-6, err_msg=f"total {total}")
        assert_labels_match(labels.numpy(), np.asarray(want_labels),
                            probs.numpy())
        np.testing.assert_array_equal(labels.numpy(),
                                      probs.numpy().argmax(axis=0))
        # a short last batch instead of zero-weight padding windows
        n_win = stitch.plan_windows(total, WINDOW, hop, batch)[0]
        assert sum(s[0] for s in infer.calls) == n_win
        assert len(infer.calls) == -(-n_win // batch)


def test_overlap_add_does_not_depend_on_batch():
    ecg = record(3, 9 * WINDOW + 11)
    runs = [stitch.overlap_add_infer(ConvInfer(), ecg, window=WINDOW,
                                     hop=WINDOW // 2, batch=b)[0].numpy()
            for b in (1, 4, 64)]
    for other in runs[1:]:  # the JAX test's bound: batch is no semantic
        np.testing.assert_allclose(other, runs[0], atol=1e-6)


def test_single_cover_is_the_model_on_the_standardized_window():
    ecg = record(4, 3 * WINDOW)
    probs, _ = stitch.overlap_add_infer(ConvInfer(), ecg, window=WINDOW,
                                        hop=WINDOW, batch=2, taper="flat")
    wins = ecg.reshape(LEADS, 3, WINDOW).transpose(1, 0, 2)
    mu = wins.mean(axis=(1, 2), keepdims=True)
    sd = wins.std(axis=(1, 2), keepdims=True)
    want = ConvInfer()(torch.from_numpy((wins - mu) / sd)).numpy()
    np.testing.assert_allclose(
        probs.numpy(), want.transpose(1, 0, 2).reshape(C, -1), atol=1e-6)


def test_standardize_uses_the_population_std():
    """A one-lead window of 8 samples: the Bessel-corrected std is
    sqrt(8/7) = 1.069 times the population std, so a ``correction`` slip
    moves every standardized sample by 7%. A flat window becomes zeros."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 1, 8)).astype(np.float32)
    x[2] = 4.0
    got = stitch.standardize_windows(torch.from_numpy(x)).numpy()
    mu, sd = x[:2].mean(axis=(1, 2), keepdims=True), x[:2].std(
        axis=(1, 2), keepdims=True)
    np.testing.assert_allclose(got[:2], (x[:2] - mu) / sd, atol=1e-6)
    np.testing.assert_array_equal(got[2], 0.0)
    bessel = x[:2].std(axis=(1, 2), ddof=1, keepdims=True)
    assert np.abs(got[:2] - (x[:2] - mu) / bessel).max() > 0.05

    ecg = np.concatenate([rng.standard_normal((1, 8)),
                          np.full((1, 8), 2.0)], axis=1).astype(np.float32)
    ours, _ = stitch.overlap_add_infer(ConvInfer(), ecg, window=8, hop=4,
                                       batch=2)
    theirs, _ = jax_stitch.overlap_add_infer(jax_conv_infer, ecg, window=8,
                                             hop=4, batch=2)
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), atol=2e-6)


def test_one_dim_record_is_one_lead():
    sig = record(6, 70, leads=1)[0]
    probs, labels = stitch.overlap_add_infer(ConvInfer(), sig, window=WINDOW,
                                             hop=16, batch=4)
    want, _ = jax_stitch.overlap_add_infer(jax_conv_infer, sig,
                                           window=WINDOW, hop=16, batch=4)
    assert probs.shape == (C, 70) and labels.shape == (70,)
    np.testing.assert_allclose(probs.numpy(), np.asarray(want), atol=2e-6)


# ---------------------------------------------------------------------------
# serving.StreamingSegmenter
# ---------------------------------------------------------------------------


def stream(seg, ecg, rng, streams=None):
    """Push ``ecg`` in random chunks of 1-22 samples, then flush; returns
    the concatenated probabilities and labels."""
    axis = ecg.ndim - 1
    total, off, probs, labels = ecg.shape[-1], 0, [], []
    while off < total:
        n = int(rng.integers(1, 23))
        p, l = seg.push(ecg[..., off:off + n])
        probs.append(p)
        labels.append(l)
        off += n
    p, l = seg.flush()
    return (np.concatenate(probs + [p], axis=axis),
            np.concatenate(labels + [l], axis=axis - 1))


@pytest.mark.parametrize("taper", ["hann", "flat"])
@pytest.mark.parametrize("hop", [WINDOW, WINDOW // 2, WINDOW // 4])
def test_streaming_matches_the_offline_stitcher_and_jax(hop, taper):
    for i, total in enumerate((WINDOW - 5, 2 * WINDOW, 3 * WINDOW + 7)):
        ecg = record(200 + 10 * hop + i, total)
        seg = serving.StreamingSegmenter(ConvInfer(), window=WINDOW, hop=hop,
                                         num_leads=LEADS, taper=taper)
        probs, labels = stream(seg, ecg, np.random.default_rng(i))
        assert probs.shape == (C, total) and labels.dtype == np.int32
        want, want_labels = stitch.overlap_add_infer(
            ConvInfer(), ecg, window=WINDOW, hop=hop, batch=3, taper=taper)
        np.testing.assert_allclose(probs, want.numpy(), atol=2e-6)
        np.testing.assert_array_equal(labels, want_labels.numpy())
        theirs = jax_serving.StreamingSegmenter(
            jax_conv_infer, window=WINDOW, hop=hop, num_leads=LEADS,
            taper=taper)
        jax_probs, jax_labels = stream(theirs, ecg, np.random.default_rng(i))
        np.testing.assert_allclose(probs, jax_probs, atol=2e-6)
        assert_labels_match(labels, jax_labels, probs)


def test_streams_are_independent():
    S, total = 3, 2 * WINDOW + 9
    ecgs = np.stack([record(300 + s, total) for s in range(S)])
    seg = serving.StreamingSegmenter(ConvInfer(), window=WINDOW,
                                     hop=WINDOW // 2, num_leads=LEADS,
                                     num_streams=S)
    probs, labels = stream(seg, ecgs, np.random.default_rng(1))
    assert probs.shape == (S, C, total) and labels.shape == (S, total)
    for s in range(S):
        alone = serving.StreamingSegmenter(ConvInfer(), window=WINDOW,
                                           hop=WINDOW // 2, num_leads=LEADS)
        want, want_labels = stream(alone, ecgs[s], np.random.default_rng(2))
        np.testing.assert_allclose(probs[s], want, atol=1e-6)
        np.testing.assert_array_equal(labels[s], want_labels)


def test_flush_resets_and_latency_is_bounded():
    rng = np.random.default_rng(9)
    seg = serving.StreamingSegmenter(ConvInfer(), window=WINDOW,
                                     hop=WINDOW // 2, num_leads=LEADS)
    emitted = 0
    for i in range(6):
        p, _ = seg.push(record(400 + i, 16))
        emitted += p.shape[1]
        assert 16 * (i + 1) - emitted <= WINDOW
    seg.flush()
    p, l = seg.flush()  # nothing pushed since: empty, still C rows
    assert p.shape == (C, 0) and l.shape == (0,)
    ecg = record(410, 2 * WINDOW)
    first, _ = seg.push(ecg)
    tail, _ = seg.flush()
    want, _ = stitch.overlap_add_infer(ConvInfer(), ecg, window=WINDOW,
                                       hop=WINDOW // 2, batch=2)
    np.testing.assert_allclose(np.concatenate([first, tail], axis=1),
                               want.numpy(), atol=2e-6)
    with pytest.raises(ValueError, match="expected"):
        seg.push(np.zeros((2, LEADS + 1, 4), np.float32))


@pytest.mark.parametrize("n", [0, 1, 17, 64, 300])
def test_serve_batched_is_the_jax_one(n):
    """Fixed buckets for ragged batches: rows padded up to a bucket and
    sliced back, as the JAX package's."""
    rng = np.random.default_rng(n)
    ecg = rng.standard_normal((n, 1, 8)).astype(np.float32)
    seen = {"ours": [], "theirs": []}

    def serve(who):
        def fn(x):
            seen[who].append(x.shape[0])
            return np.concatenate([x, 2 * x], axis=1)
        return fn

    ours = serving.serve_batched(serve("ours"), ecg)
    theirs = jax_serving.serve_batched(serve("theirs"), ecg)
    np.testing.assert_array_equal(ours, theirs)
    assert ours.shape == (n, 2, 8)
    assert seen["ours"] == seen["theirs"]
    assert set(seen["ours"]) <= {16, 64, 256}


def test_unported_options_raise(models):
    """``mesh=`` is ported (:func:`test_mesh_stitch_on_two_ranks`); what
    still raises is a stream count the mesh's data axis does not divide,
    in the JAX package's words."""
    infer = ConvInfer()
    mesh = pmesh.Mesh(data=2, seq=1, model=1, data_rank=0, model_rank=0)
    with pytest.raises(ValueError, match="must divide by the mesh's data"):
        serving.StreamingSegmenter(infer, window=WINDOW, num_streams=3,
                                   mesh=mesh)
    # int8 serving is ported (tests/test_torch_quant.py holds it against
    # the JAX package): the serving function runs the int8 model
    from semi_seg_ecg_tpu_torch.models.quant_layers import int8_modules

    config, _ = models[0]["resnet"]
    infer, model = serving.make_serving_fn(normalize_config(
        {**config, "quantize": "int8"}))
    # the stem, 4 + 4 block convs and a downsample, the head's ConvBN
    assert len(int8_modules(model)) == 1 + 8 + 1 + 1
    probs = infer(torch.from_numpy(record(2, SIG, leads=1)[None]))
    np.testing.assert_allclose(probs.sum(dim=1).numpy(), 1.0, atol=1e-5)


# ---------------------------------------------------------------------------
# long_record_inference on real models
# ---------------------------------------------------------------------------


def vit_config():
    return {
        "backbone": {"vit_tiny": {
            "num_leads": 1, "seq_len": SIG, "patch_size": 25, "width": 64,
            "depth": 2, "heads": 2, "dim_head": 32, "mlp_dim": 128,
            "out_indices": [1], "qk_norm": True,
            "attention_impl": "flash"}},
        "decode_head": {"FCNHead": {
            "in_channels": 64, "in_index": 0, "channels": 16,
            "num_convs": 1, "concat_input": False, "dropout_ratio": 0.1,
            "num_classes": 4, "align_corners": False}}}


def resnet_config():
    return {
        "backbone": {"resnet18": {
            "num_leads": 1, "stem_channels": 8, "base_channels": 8,
            "num_stages": 2, "out_indices": [0, 1], "strides": [1, 2],
            "dilations": [1, 1]}},
        "decode_head": {"FCNHead": {
            "in_channels": 16, "in_index": 1, "channels": 16,
            "num_convs": 1, "concat_input": False, "dropout_ratio": 0.1,
            "num_classes": 4, "align_corners": False}}}


MODELS = {"vit": vit_config, "resnet": resnet_config}


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """Per model: a config (fp32, ``device: cpu``, the shipped filter chain
    and per-window standardization) and a ``.ckpt`` of perturbed JAX
    weights that both packages load."""
    root = tmp_path_factory.mktemp("torch_longrec")
    out = {}
    for seed, (name, make) in enumerate(MODELS.items()):
        config = {
            **make(), "seed": seed, "precision": "fp32", "device": "cpu",
            "dataset": {"signal_length": SIG, "filter": FILTERS,
                        "transforms": [{"standardize": {"axis": [-1, -2]}},
                                       {"to_tensor": {"dtype": "float"}}]},
            "test": {"model_path": str(root / f"{name}.ckpt"),
                     "target_metric": "MeanIoU"}}
        model = jax_build(jax_normalize(config), train=False, serving=True)
        variables = jax.jit(model.init)(
            {"params": jax.random.key(seed), "dropout": jax.random.key(1)},
            jnp.zeros((2, 1, SIG), jnp.float32))
        rng = np.random.default_rng(seed)

        def noisy(tree, positive=False):
            if isinstance(tree, dict):
                return {k: noisy(v, positive or k == "var")
                        for k, v in tree.items()}
            a = np.asarray(tree, np.float32)
            a = a + 0.05 * rng.standard_normal(a.shape).astype(np.float32)
            return np.abs(a) + 0.5 if positive else a

        state = ModelState(
            params=noisy(dict(variables["params"])),
            batch_stats=noisy(dict(variables.get("batch_stats", {}))))
        save_checkpoint(config["test"]["model_path"], 0, state,
                        config=config)
        path = root / f"{name}.yaml"
        path.write_text(yaml.safe_dump(config))
        out[name] = (config, str(path))
    return out, root


@pytest.mark.parametrize("name", sorted(MODELS))
def test_long_record_inference_matches_jax(models, name):
    config, _ = models[0][name]
    total = int(6.3 * SIG)
    ecg = (np.sin(np.arange(total) / 9.0)[None]
           + record(500, total, leads=1)).astype(np.float32)
    infer, model = serving.make_serving_fn(normalize_config(config))
    assert infer.num_classes == 4 and not model.training
    ours = serving.long_record_inference(config, ecg, batch=4, infer=infer)
    theirs = jax_serving.long_record_inference(jax_normalize(config), ecg,
                                               batch=4)
    assert ours["probs"].shape == (4, total)
    assert ours["probs"].dtype == np.float32
    assert ours["labels"].dtype == np.int32
    np.testing.assert_allclose(ours["probs"].sum(axis=0), 1.0, atol=1e-5)
    np.testing.assert_allclose(ours["probs"], theirs["probs"], atol=1e-5)
    assert_labels_match(ours["labels"], theirs["labels"], ours["probs"])
    # the port's own streaming segmenter on the filtered record, through
    # the real model, against its offline stitch of the same record
    from semi_seg_ecg_tpu_torch.data.transforms import (
        get_transforms_from_config,
    )

    filtered = ecg
    for t in get_transforms_from_config(FILTERS):
        filtered = t(filtered)
    seg = serving.StreamingSegmenter(infer, window=SIG, num_leads=1)
    probs, labels = stream(seg, filtered, np.random.default_rng(3))
    np.testing.assert_allclose(probs, ours["probs"], atol=2e-6)
    assert_labels_match(labels, ours["labels"], probs)


def test_long_record_refuses_other_standardize_axes(models):
    config, _ = models[0]["resnet"]
    bad = {**config, "dataset": {**config["dataset"], "transforms": [
        {"standardize": {"axis": [-1]}}]}}
    with pytest.raises(ValueError, match="not supported"):
        serving.long_record_inference(bad, record(0, SIG, leads=1),
                                      infer=ConvInfer())


# ---------------------------------------------------------------------------
# infer-longrec
# ---------------------------------------------------------------------------


def run_both(config_path, argv, out_root, tag):
    """Both packages' ``infer_longrec_main`` on the same arguments, into
    ``out_root/{torch,jax}_{tag}``; returns the two output directories and
    what each printed from its delineation table on."""
    printed = {}
    dirs = {}
    for name, main in (("torch", infer_longrec_main),
                       ("jax", jax_longrec_main)):
        dirs[name] = str(out_root / f"{name}_{tag}")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            main(["-f", config_path, "--batch", "4", "--out-dir",
                  dirs[name], *argv])
        text = buf.getvalue()
        printed[name] = text[text.find("delineation vs"):] \
            if "delineation vs" in text else ""
    return dirs["torch"], dirs["jax"], printed


def assert_same_outputs(ours, theirs, intervals=False):
    probs = np.load(os.path.join(ours, "probs.npy"))
    want = np.load(os.path.join(theirs, "probs.npy"))
    assert probs.shape == want.shape and probs.dtype == np.float32
    np.testing.assert_allclose(probs, want, atol=1e-5)
    labels = np.load(os.path.join(ours, "labels.npy"))
    np.testing.assert_array_equal(labels, np.load(os.path.join(
        theirs, "labels.npy")))
    if intervals:
        with open(os.path.join(ours, "intervals.csv")) as f:
            text = f.read()
        with open(os.path.join(theirs, "intervals.csv")) as f:
            assert text == f.read()
        assert text.count("\n") > 1


@pytest.fixture(scope="module")
def cli_records(models):
    """A ``.npy`` record, a directory of ``.npy`` and WFDB records (fmt 16
    and 212, 250 Hz) and the WFDB records' ground-truth label fields."""
    _, root = models
    rng = np.random.default_rng(11)
    rec = (np.sin(np.arange(int(5.3 * SIG)) / 7.0)
           + 0.3 * rng.standard_normal(int(5.3 * SIG))).astype(np.float32)
    np.save(root / "rec.npy", rec)
    rec_dir = root / "records"
    wfdb = make_synthetic_wfdb(str(rec_dir), num_records=2, fs=250,
                               seconds=4.2, seed=3)
    np.save(rec_dir / "extra.npy", rec[:3 * SIG])
    masks = {}
    for name, mask in wfdb["masks"].items():
        masks[name] = str(root / f"{name}_labels.npy")
        np.save(masks[name], mask.astype(np.int32))
    return str(root / "rec.npy"), str(rec_dir), masks


@pytest.mark.parametrize("name", sorted(MODELS))
def test_cli_npy_record_with_intervals(models, cli_records, name, tmp_path):
    _, config_path = models[0][name]
    ours, theirs, _ = run_both(config_path, ["--record", cli_records[0],
                                             "--intervals"], tmp_path, "npy")
    assert_same_outputs(ours, theirs, intervals=True)


def test_cli_wfdb_record_with_eval_labels(models, cli_records, tmp_path):
    _, config_path = models[0]["resnet"]
    _, rec_dir, masks = cli_records
    ours, theirs, printed = run_both(
        config_path, ["--record", os.path.join(rec_dir, "rec_1"),
                      "--intervals", "--eval-labels", masks["rec_1"],
                      "--tolerance-ms", "100"], tmp_path, "wfdb")
    assert_same_outputs(ours, theirs, intervals=True)
    assert printed["torch"] and printed["torch"] == printed["jax"]


def test_cli_directory_mode(models, cli_records, tmp_path):
    _, config_path = models[0]["resnet"]
    ours, theirs, _ = run_both(config_path, ["--record", cli_records[1],
                                             "--intervals"], tmp_path, "dir")
    stems = sorted(os.listdir(ours))
    assert stems == sorted(os.listdir(theirs)) == ["extra", "rec_0",
                                                   "rec_1"]
    for stem in stems:
        assert_same_outputs(os.path.join(ours, stem),
                            os.path.join(theirs, stem), intervals=True)


def test_cli_model_fs_resamples_and_maps_back(models, cli_records,
                                              tmp_path):
    """A 500 Hz reading of the record: Fourier-resampled to the model's 250
    Hz and mapped back to 500 Hz, with the eval labels on that timebase."""
    _, config_path = models[0]["vit"]
    ours_first = infer_longrec_main(
        ["-f", config_path, "--record", cli_records[0], "--batch", "4",
         "--out-dir", str(tmp_path / "self"), "--fs", "500"])
    labels = str(tmp_path / "self_labels.npy")
    np.save(labels, ours_first["labels"])
    ours, theirs, printed = run_both(
        config_path, ["--record", cli_records[0], "--fs", "500",
                      "--model-fs", "250", "--intervals",
                      "--eval-labels", labels], tmp_path, "model_fs")
    assert_same_outputs(ours, theirs, intervals=True)
    assert np.load(os.path.join(ours, "probs.npy")).shape[1] == \
        np.load(cli_records[0]).size
    assert printed["torch"] and printed["torch"] == printed["jax"]


def test_cli_self_score_and_lead_mismatch(models, cli_records, tmp_path):
    _, config_path = models[0]["resnet"]
    first = infer_longrec_main(["-f", config_path, "--record",
                                cli_records[0], "--out-dir",
                                str(tmp_path / "a")])
    labels = str(tmp_path / "labels.npy")
    np.save(labels, first["labels"])
    again = infer_longrec_main(["-f", config_path, "--record",
                                cli_records[0], "--out-dir",
                                str(tmp_path / "b"), "--eval-labels",
                                labels, "--min-duration-ms", "0"])
    overall = again["delineation"]["overall"]
    assert overall["sensitivity"] == overall["ppv"] == 1.0

    two_lead = str(tmp_path / "two_lead.npy")
    np.save(two_lead, record(12, 3 * SIG))
    for main in (infer_longrec_main, jax_longrec_main):
        with pytest.raises(SystemExit, match="leads but"):
            main(["-f", config_path, "--record", two_lead, "--out-dir",
                  str(tmp_path / "c")])
    with pytest.raises(SystemExit, match="out of range"):
        infer_longrec_main(["-f", config_path, "--record", two_lead,
                            "--lead", "2", "--out-dir",
                            str(tmp_path / "d")])
    out = infer_longrec_main(["-f", config_path, "--record", two_lead,
                              "--lead", "1", "--out-dir",
                              str(tmp_path / "e")])
    assert out["probs"].shape == (4, 3 * SIG)


# ---------------------------------------------------------------------------
# mesh=: the windows and the streams over two data ranks
# ---------------------------------------------------------------------------

MESH_CASES = [  # (seed, total, hop, batch)
    (60, 9 * WINDOW + 11, 16, 2),
    # 2 windows over 2 ranks x 2: rank 1 sees only padding
    (61, WINDOW + 7, WINDOW // 2, 2),
    (62, 5 * WINDOW, WINDOW // 4, 3),
]
MESH_STREAMS, MESH_STREAM_TOTAL = 4, WINDOW + 40
LONG_CONFIG = {"dataset": {"signal_length": WINDOW,
                           "transforms": ["standardize"]}}


def jax_data_mesh(n=2):
    from jax.sharding import Mesh

    return Mesh(np.asarray(jax.devices()[:n]).reshape(n, 1, 1),
                ("data", "seq", "model"))


@pytest.fixture(scope="module")
def mesh_ranks(tmp_path_factory):
    """Two gloo ranks of ``tests/torch_dist_worker.py`` running
    ``task_longrec`` on the cases, the long record and the streams."""
    from tests.torch_dist_worker import run_ranks

    cases = [(record(seed, total), WINDOW, hop, batch)
             for seed, total, hop, batch in MESH_CASES]
    ecgs = record(63, MESH_STREAMS * MESH_STREAM_TOTAL).reshape(
        LEADS, MESH_STREAMS, MESH_STREAM_TOTAL).transpose(1, 0, 2).copy()
    half = MESH_STREAM_TOTAL // 2
    chunks = [ecgs[:, :, :half], ecgs[:, :, half:]]
    results = run_ranks(
        [("longrec", {"kernel": KERNEL, "cases": cases,
                      "streams": (chunks, WINDOW, WINDOW // 2),
                      "config": LONG_CONFIG})],
        str(tmp_path_factory.mktemp("longrec_mesh")), timeout=120)
    return cases, chunks, [r[0] for r in results]


def test_mesh_stitch_on_two_ranks(mesh_ranks):
    """``overlap_add_infer(mesh=)`` on two data ranks: every rank returns
    the one-process record and the JAX package's ``mesh=`` record on a
    2-device CPU mesh within 1e-5 (its test's addition-order bound); the
    ranks' windows are each window once, and a rank that sees only
    padding runs none."""
    cases, _, ranks = mesh_ranks
    for i, (ecg, window, hop, batch) in enumerate(cases):
        want, want_labels = stitch.overlap_add_infer(
            ConvInfer(), ecg, window=window, hop=hop, batch=batch)
        theirs, _ = jax_stitch.overlap_add_infer(
            jax_conv_infer, ecg, window=window, hop=hop, batch=batch,
            mesh=jax_data_mesh())
        for r, got in enumerate(ranks):
            probs, labels = got["stitched"][i]
            np.testing.assert_allclose(probs, want.numpy(), atol=1e-5,
                                       err_msg=f"case {i} rank {r}")
            np.testing.assert_allclose(probs, np.asarray(theirs), atol=1e-5,
                                       err_msg=f"case {i} rank {r} JAX")
            assert_labels_match(labels, want_labels.numpy(), want.numpy())
        n_win = stitch.plan_windows(ecg.shape[1], window, hop, 1)[0]
        calls = [got["calls"][i] for got in ranks]
        assert sum(map(sum, calls)) == n_win, (i, calls)
        assert all(b <= batch for c in calls for b in c)
        if i == 1:
            assert calls[1] == [], calls


def test_mesh_long_record_inference(mesh_ranks):
    cases, _, ranks = mesh_ranks
    want = serving.long_record_inference(LONG_CONFIG, cases[0][0],
                                         infer=ConvInfer())
    for got in ranks:
        np.testing.assert_allclose(got["long_record"]["probs"],
                                   want["probs"], atol=1e-5)
        assert_labels_match(got["long_record"]["labels"], want["labels"],
                            want["probs"])


def test_mesh_streams_on_two_ranks(mesh_ranks):
    """``StreamingSegmenter(mesh=)``: each rank steps two of the four
    streams, and every rank returns all four as one process and the JAX
    package's ``mesh=`` segmenter do; three streams over two ranks raise
    the JAX package's error."""
    from semi_seg_ecg_tpu.serving import StreamingSegmenter as JaxSegmenter

    _, chunks, ranks = mesh_ranks

    def run(seg):
        pushed = [seg.push(c) for c in chunks] + [seg.flush()]
        return np.concatenate([np.asarray(p[0]) for p in pushed], axis=-1)

    kwargs = dict(window=WINDOW, hop=WINDOW // 2, num_leads=LEADS,
                  num_streams=MESH_STREAMS)
    want = run(serving.StreamingSegmenter(ConvInfer(), **kwargs))
    theirs = run(JaxSegmenter(jax_conv_infer, mesh=jax_data_mesh(),
                              **kwargs))
    assert want.shape == (MESH_STREAMS, C, MESH_STREAM_TOTAL)
    for got in ranks:
        np.testing.assert_allclose(got["streams"][0], want, atol=1e-5)
        np.testing.assert_allclose(got["streams"][0], theirs, atol=1e-5)
        assert got["uneven"] == ("num_streams (3) must divide by the mesh's "
                                 "data axis (2)")
