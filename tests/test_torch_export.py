"""The port's serving artifact against the JAX package's serving path.

``serving.export_serving`` / ``load_serving`` / ``make_http_server`` and
``cli.py``'s ``export`` and ``serve``, on the CPU, with small models (a
narrow 2-stage ResNet-1D; a depth-2, width-64 ViT-1D with ``attention_impl:
flash``: the operator's CPU implementation on the port's side, the Pallas
kernel in interpret mode on the JAX package's) restored from one JAX
``.ckpt``:

- one symbolic-batch artifact serves batches 1, 3 and 16 within 1e-5 of
  the port's ``ServingFn`` (the same arithmetic, traced) and within 1e-4 of
  the JAX package's ``make_serving_fn`` (fp32 softmax of logits that agree
  to rounding); rows sum to 1 within 1e-5;
- the ViT's program holds one flash operator per block, and tracing it
  launches no kernel; the forward and backward operators pass opcheck's
  default checks, and a flash block compiled by ``torch.compile``
  (``aot_eager``, one graph) equals eager;
- a pinned batch, the int8 artifacts (dynamic and calibrated), the header's
  precision of the traced graph (fp32 without ``test.use_amp``, the
  autocast dtype with it, the graph then holding the autocast region);
- ``serve_batched`` over the artifact (ragged and empty batches), the
  artifact as the long-record stitcher's model;
- the HTTP server: metadata, predict within 1e-6 of the artifact, 400 on a
  bad body or shape, 404 on an unknown path;
- the loader refuses a non-artifact, a truncated file, a corrupt header and
  the JAX package's ``ECGSHLO1`` artifact;
- the cross-platform artifact on the CPU: the ``("cpu",)`` program against
  the CPU lowering of the JAX package's ``export_serving(platforms=("cpu",
  "tpu"))`` within 1e-4, a two-program file (a ``("cuda", "cpu")``
  export's layout) serving its CPU program on a host without a card, and
  the platform names that raise; ``tests/test_torch_cuda.py`` exports and
  serves ``("cuda", "cpu")`` on the card;
- the ``export`` and ``serve`` entries of ``cli.py``.

Each artifact is loaded once (:func:`loaded`) and its op list read from the
loaded program (:func:`program_ops`); the JAX package's artifact is
exported once (``jax_artifact``).
"""

import contextlib
import io
import json
import os
import struct
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
import yaml

import jax.numpy as jnp

from semi_seg_ecg_tpu import serving as jax_serving
from semi_seg_ecg_tpu.models import build_model_from_config as jax_build
from semi_seg_ecg_tpu.utils.checkpoint import save_checkpoint as jax_save
from semi_seg_ecg_tpu.utils.train_state import ModelState
from semi_seg_ecg_tpu_torch import serving
from semi_seg_ecg_tpu_torch.cli import export_main
from semi_seg_ecg_tpu_torch.config import normalize_config
from semi_seg_ecg_tpu_torch.ops import flash_attention as fa
from semi_seg_ecg_tpu_torch.models.quant_layers import int8_modules
from tests.test_torch_quant import METRIC, activation_reductions, noisy_trees
from tests.test_torch_train_slice import jit_init_variables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIG = 500
OP = "semi_seg_ecg_tpu_torch.flash_attention_forward.default"


def model_config(name):
    head = {"in_index": 0, "channels": 16, "num_convs": 1,
            "concat_input": False, "dropout_ratio": 0.1, "num_classes": 4,
            "align_corners": False}
    if name == "resnet":
        backbone = {"resnet18": {
            "num_leads": 1, "stem_channels": 8, "base_channels": 8,
            "num_stages": 2, "out_indices": [1], "strides": [1, 2],
            "dilations": [1, 1]}}
        head["in_channels"] = 16
    else:
        backbone = {"vit_tiny": {
            "num_leads": 1, "seq_len": SIG, "patch_size": 25, "width": 64,
            "depth": 2, "heads": 2, "dim_head": 32, "mlp_dim": 128,
            "out_indices": [1], "qk_norm": True,
            "attention_impl": "flash"}}
        head["in_channels"] = 64
    return {"backbone": backbone, "decode_head": {"FCNHead": head}}


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """Per model: a config (``device: cpu``, fp32 training precision, a
    synthetic test split), its JAX ``.ckpt`` and its symbolic-batch
    artifact."""
    from semi_seg_ecg_tpu_torch.data.synthetic import make_synthetic_dataset

    root = tmp_path_factory.mktemp("torch_export")
    data = make_synthetic_dataset(str(root / "data"), num_train_labeled=1,
                                  num_train_unlabeled=1, num_valid=1,
                                  num_test=4, length=SIG, seed=6)
    out = {}
    for seed, name in enumerate(("resnet", "vit")):
        config = {**model_config(name), "seed": seed, "precision": "fp32",
                  "device": "cpu", "metric": METRIC,
                  "dataset": {**data, "signal_length": SIG},
                  "dataloader": {"batch_size": 2, "num_workers": 0},
                  "test": {"model_path": str(root / f"{name}.ckpt"),
                           "target_metric": "MeanIoU"},
                  "output_dir": str(root), "exp_name": name}
        jmodel = jax_build(config, train=False, serving=True)
        params, stats = noisy_trees(jit_init_variables(jmodel), seed)
        jax_save(config["test"]["model_path"], 0,
                 ModelState(params=params, batch_stats=stats), config=config)
        before = fa.LAUNCHES
        path = str(root / f"{name}.pt2")
        header = serving.export_serving(normalize_config(config), path)
        assert fa.LAUNCHES == before
        out[name] = (config, path, header)
    return out, root


def ecg(seed, n):
    return np.random.default_rng(seed).standard_normal(
        (n, 1, SIG)).astype(np.float32)


_LOADED = {}


def loaded(path):
    """``serving.load_serving(path)``, once per path."""
    if path not in _LOADED:
        _LOADED[path] = serving.load_serving(path)
    return _LOADED[path]


@pytest.fixture(scope="module")
def jax_artifact(exported):
    """The JAX package's cross-platform artifact of the ResNet (batch 2,
    ``platforms=("cpu", "tpu")``) and its CPU serving function."""
    config, _, _ = exported[0]["resnet"]
    path = str(exported[1] / "model-xplat.shlo")
    header = jax_serving.export_serving(config, path, batch_size=2,
                                        platforms=("cpu", "tpu"))
    assert header["platforms"] == ["cpu", "tpu"]
    return path, jax_serving.load_serving(path)[0]


@pytest.mark.parametrize("name", ["resnet", "vit"])
def test_artifact_matches_serving_fn_and_jax(exported, name):
    config, path, header = exported[0][name]
    assert header == {
        "format": "torch.export", "input_shape": [None, 1, SIG],
        "num_classes": 4, "output": "softmax_probs (B, C, T) float32",
        "precision": "fp32", "quantize": None, "act_scales": None,
        "platforms": ["cpu"], "torch_version": torch.__version__}
    serve, loaded_header = loaded(path)
    assert loaded_header == header
    assert serve.device == torch.device("cpu") and serve.num_classes == 4
    infer, _ = serving.make_serving_fn(normalize_config(config))
    jinfer, _ = jax_serving.make_serving_fn(config)
    for n in (1, 3, 16):  # symbolic batch: one artifact, several sizes
        x = ecg(n, n)
        got = serve(x)
        assert got.dtype == torch.float32 and got.shape == (n, 4, SIG)
        got = got.numpy()
        np.testing.assert_allclose(got, infer(torch.from_numpy(x)).numpy(),
                                   atol=1e-5, rtol=0)
        np.testing.assert_allclose(got.sum(axis=1), 1.0, atol=1e-5)
        if n == 3:  # the JAX package compiles one program per batch size
            np.testing.assert_allclose(
                got, np.asarray(jinfer(jnp.asarray(x))), atol=1e-4, rtol=0)


def program_ops(serve):
    """The operators a loaded artifact's program calls, in order (the
    graph ``torch.export.load`` gives, unflattened)."""
    return [str(n.target) for n in serve.program.graph.nodes
            if n.op == "call_function"]


def test_vit_program_holds_the_flash_operator(exported):
    """One flash operator per ViT block (the CUDA kernel on the card, 12
    launches a batch for vit_tiny), none in the ResNet's."""
    assert program_ops(loaded(exported[0]["vit"][1])[0]).count(OP) == 2
    assert program_ops(loaded(exported[0]["resnet"][1])[0]).count(OP) == 0
    serve, _ = loaded(exported[0]["vit"][1])
    before = fa.LAUNCHES
    serve(ecg(0, 2))
    assert fa.LAUNCHES == before  # CPU tensors: the plain version


@pytest.mark.parametrize("strided", [False, True])
def test_flash_operator_passes_opcheck(strided):
    """The forward and backward operators pass ``torch.library.opcheck``'s
    default checks (schema, autograd registration, fake tensors, and
    AOTAutograd's static and dynamic dispatch) on CPU tensors, contiguous
    and as the ViT hands them over; the outputs' strides equal the fakes'
    (B, N, H, D) memory."""
    b, h, n, d = 2, 3, 11, 8
    rng = np.random.default_rng(1)
    if strided:
        x = torch.from_numpy(rng.standard_normal((b, n, 3 * h * d)).astype(
            np.float32))
        q, k, v = (t.reshape(b, n, h, d).transpose(1, 2)
                   for t in x.chunk(3, dim=-1))
    else:
        q, k, v = (torch.from_numpy(rng.standard_normal((b, h, n, d)).astype(
            np.float32)).requires_grad_() for _ in range(3))
    torch.library.opcheck(fa._forward_op, (q, k, v, 0.3))
    out, lse = fa.flash_attention_forward(q, k, v, 0.3)
    assert out.stride() == (n * h * d, d, h * d, 1) and lse.shape == (b, h, n)
    dout = torch.from_numpy(rng.standard_normal((b, h, n, d)).astype(
        np.float32))
    args = (q.detach(), k.detach(), v.detach(), out.detach(), lse, dout, 0.3)
    torch.library.opcheck(fa._backward_op, args)
    for g in fa._backward_op(*args):
        assert g.stride() == (n * h * d, d, h * d, 1)


def test_flash_block_compiles_as_eager():
    """``torch.compile(fullgraph=True, backend="aot_eager")`` of a flash
    ViT block, forward and backward, captures both operators in one graph
    each way and equals eager bit for bit."""
    from semi_seg_ecg_tpu_torch.models.backbones.vision_transformer import (
        TransformerBlock,
    )

    torch.manual_seed(0)
    block = TransformerBlock(64, 128, heads=2, dim_head=32, qk_norm=True,
                             attention_impl="flash").eval()
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, 20, 64)).astype(np.float32))

    def run(fn):
        xx = x.clone().requires_grad_()
        out = fn(xx)
        out.square().sum().backward()
        grads = [p.grad for p in block.parameters()] + [xx.grad]
        block.zero_grad(set_to_none=True)
        return [out.detach()] + grads

    eager = run(block)
    compiled = run(torch.compile(block, fullgraph=True, backend="aot_eager"))
    for a, b in zip(compiled, eager):
        assert torch.equal(a, b)


def test_pinned_batch(exported):
    config, _, _ = exported[0]["resnet"]
    path = str(exported[1] / "pinned.pt2")
    header = serving.export_serving(normalize_config(config), path,
                                    batch_size=2)
    assert header["input_shape"] == [2, 1, SIG]
    serve, _ = serving.load_serving(path)
    assert serve(ecg(1, 2)).shape == (2, 4, SIG)
    with pytest.raises(ValueError, match=r"expected shape \[2, 1, 500\]"):
        serve(ecg(1, 3))


@pytest.mark.parametrize("calibration", [0, 2], ids=["dynamic", "static"])
@pytest.mark.parametrize("name", ["resnet", "vit"])
def test_int8_artifacts(exported, name, calibration):
    config, _, _ = exported[0][name]
    config = normalize_config({**config, "quantize": "int8",
                               "quantize_calibration": calibration})
    path = str(exported[1] / f"{name}-int8-{calibration}.pt2")
    header = serving.export_serving(config, path)
    assert header["quantize"] == "int8"
    assert header["act_scales"] == ("static" if calibration else "dynamic")
    serve, _ = serving.load_serving(path)
    infer, _ = serving.make_serving_fn(config)
    x = serving._calibration_batches(config, 1)[0]
    got = serve(x).numpy()
    np.testing.assert_allclose(got, infer(torch.from_numpy(x)).numpy(),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(got.sum(axis=1), 1.0, atol=1e-5)
    assert program_ops(serve).count("aten._int_mm.default") > 0
    # the calibrated program carries its scales: no activation reductions
    n_layers = len(int8_modules(infer.model))
    assert activation_reductions(serve, torch.from_numpy(x)) == (
        0 if calibration else n_layers)


def test_header_precision_reflects_traced_graph(exported):
    """A bf16 training config without ``test.use_amp`` exports an fp32
    graph, and the header says so; with ``use_amp`` the graph holds the
    autocast region and the header says bf16."""
    config, fp32_path, _ = exported[0]["vit"]
    root = exported[1]
    cfg = normalize_config({**config, "precision": "bf16"})
    header = serving.export_serving(cfg, str(root / "bf16cfg.pt2"),
                                    batch_size=1)
    assert header["precision"] == "fp32"
    amp = {**cfg, "test": {**cfg["test"], "use_amp": True}}
    header = serving.export_serving(amp, str(root / "amp.pt2"))
    assert header["precision"] == "bf16"
    serve, _ = serving.load_serving(str(root / "amp.pt2"))
    assert "wrap_with_autocast" in program_ops(serve)
    fp32, _ = loaded(fp32_path)
    infer, _ = serving.make_serving_fn(amp)
    x = ecg(5, 3)
    got = serve(x)
    np.testing.assert_allclose(got, infer(torch.from_numpy(x)), atol=1e-5,
                               rtol=0)
    assert not torch.allclose(got, fp32(x), atol=1e-5)


def test_serve_batched_over_the_artifact(exported):
    """Ragged batches route through fixed buckets; outputs match the
    direct call row for row and padding rows never leak; the empty batch
    gives zero rows of the program's row shape."""
    serve, _ = loaded(exported[0]["resnet"][1])
    calls = []

    def counting_serve(x):
        calls.append(x.shape[0])
        return serve(x)

    x = ecg(2, 11)
    got = serving.serve_batched(counting_serve, x, bucket_sizes=(4, 8))
    np.testing.assert_allclose(got, serve(x).numpy(), atol=1e-5, rtol=0)
    assert calls == [8, 4]
    with pytest.raises(ValueError, match="non-empty"):
        serving.serve_batched(serve, x, bucket_sizes=())
    empty = serving.serve_batched(serve, x[:0], bucket_sizes=(4,))
    assert empty.shape == (0, 4, SIG) and empty.dtype == np.float32


def test_artifact_serves_long_records(exported):
    """The loaded artifact carries ``device`` and ``num_classes``, so the
    stitcher and the streaming segmenter take it as the eager model."""
    config, path, _ = exported[0]["vit"]
    serve, _ = loaded(path)
    infer, _ = serving.make_serving_fn(normalize_config(config))
    record = np.random.default_rng(8).standard_normal((1, 1777)).astype(
        np.float32)
    cfg = {"dataset": {"signal_length": SIG}}
    got = serving.long_record_inference(cfg, record, batch=4, infer=serve)
    want = serving.long_record_inference(cfg, record, batch=4, infer=infer)
    np.testing.assert_allclose(got["probs"], want["probs"], atol=1e-5)
    seg = serving.StreamingSegmenter(serve, window=SIG)
    assert seg.num_classes == 4


def test_http_server_predict_and_metadata(exported):
    """``cli.py serve``'s surface: metadata and ``.npy`` in, ``.npy`` out
    over a real socket, matching the direct artifact call."""
    path = exported[0]["vit"][1]
    server = serving.make_http_server(path, port=0, bucket_sizes=(4,))
    port = server.server_address[1]
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        base = f"http://127.0.0.1:{port}"
        meta = json.loads(urllib.request.urlopen(
            base + "/v1/metadata", timeout=30).read())
        assert meta["num_classes"] == 4 and meta["bucket_sizes"] == [4]
        assert meta["format"] == "torch.export"

        x = ecg(4, 5)
        buf = io.BytesIO()
        np.save(buf, x)
        req = urllib.request.Request(base + "/v1/predict",
                                     data=buf.getvalue(), method="POST")
        probs = np.load(io.BytesIO(
            urllib.request.urlopen(req, timeout=120).read()))
        serve, _ = loaded(path)
        want = serving.serve_batched(serve, x, bucket_sizes=(4,))
        np.testing.assert_allclose(probs, want, atol=1e-6, rtol=0)

        wrong = io.BytesIO()
        np.save(wrong, np.zeros((2, 1, SIG + 1), np.float32))
        for url, body, code in [("/v1/predict", b"junk", 400),
                                ("/v1/predict", wrong.getvalue(), 400),
                                ("/v1/other", b"", 404), ("/nope", None, 404)]:
            req = urllib.request.Request(
                base + url, data=body,
                method="GET" if body is None else "POST")
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.urlopen(req, timeout=30)
            assert e.value.code == code
    finally:
        server.shutdown()
        server.server_close()
        t.join(timeout=30)
    assert not t.is_alive()


def test_loader_rejects_non_artifacts(exported, jax_artifact, tmp_path):
    bad = tmp_path / "not_an_artifact.pt2"
    bad.write_bytes(b"definitely not an exported program")
    with pytest.raises(ValueError, match="bad magic"):
        serving.load_serving(str(bad))
    truncated = tmp_path / "truncated.pt2"
    truncated.write_bytes(b"ECGTEXP1\x10")  # magic + partial length word
    with pytest.raises(ValueError, match="truncated"):
        serving.load_serving(str(truncated))
    raw = open(exported[0]["resnet"][1], "rb").read()
    (truncated).write_bytes(raw[:40])  # the header cut short
    with pytest.raises(ValueError, match="truncated"):
        serving.load_serving(str(truncated))
    corrupt = tmp_path / "corrupt.pt2"
    corrupt.write_bytes(b"ECGTEXP1" + struct.pack("<I", 4) + b"{no}" + b"x")
    with pytest.raises(ValueError, match="corrupt artifact header"):
        serving.load_serving(str(corrupt))
    # the JAX package's own StableHLO artifact
    with pytest.raises(ValueError, match="bad magic b'ECGSHLO1'"):
        serving.load_serving(jax_artifact[0])


def test_export_refuses_other_platforms(exported, jax_artifact, tmp_path):
    """The former refusal, now the cross-platform artifact on the CPU (no
    card here): the ``("cpu",)`` program against the CPU lowering of the
    JAX package's ``("cpu", "tpu")`` artifact within
    ``test_artifact_matches_serving_fn_and_jax``'s 1e-4; a file in the
    two-program layout of a ``("cuda", "cpu")`` export serves its CPU
    program by the current-platform rule (and by name), and refuses a
    platform it lacks or a card torch does not see; ``tpu``, unknown
    names and repeats raise ``ValueError`` naming what the port lowers,
    ``cuda`` without a card ``RuntimeError``."""
    config = normalize_config(exported[0]["resnet"][0])
    path = str(tmp_path / "x.pt2")
    for platforms in (("cpu", "tpu"), ("tpu",), ("gpu",), ("cpu", "cpu")):
        with pytest.raises(ValueError, match=r"\['cuda', 'cpu'\]"):
            serving.export_serving(config, path, platforms=platforms)
    for platforms in (("cuda",), ("cuda", "cpu")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serving.export_serving(config, path, platforms=platforms)
    header = serving.export_serving(config, path, batch_size=1,
                                    platforms=("cpu",))
    assert header["platforms"] == ["cpu"] and "programs" not in header
    serve, _ = serving.load_serving(path)
    x = ecg(7, 2)
    want = np.asarray(jax_artifact[1](jnp.asarray(x)))
    for row in range(2):  # the port's program pins batch 1, the JAX one 2
        np.testing.assert_allclose(serve(x[row:row + 1]).numpy()[0],
                                   want[row], atol=1e-4, rtol=0)
    # the layout a ("cuda", "cpu") export writes; the CUDA bytes are never
    # read on this host
    with open(path, "rb") as f:
        f.seek(8)
        (hlen,) = struct.unpack("<I", f.read(4))
        f.seek(12 + hlen)
        blob = f.read()
    cuda_blob = b"\0" * 64
    two = dict(header, platforms=["cuda", "cpu"], programs=[
        {"platform": "cuda", "offset": 0, "length": len(cuda_blob)},
        {"platform": "cpu", "offset": len(cuda_blob), "length": len(blob)}])
    raw = json.dumps(two).encode()
    both = tmp_path / "both.pt2"
    both.write_bytes(b"ECGTEXP1" + struct.pack("<I", len(raw)) + raw
                     + cuda_blob + blob)
    for platform in (None, "cpu"):
        serve2, got_header = serving.load_serving(str(both), platform)
        assert got_header == two and serve2.device == torch.device("cpu")
        torch.testing.assert_close(serve2(x[:1]), serve(x[:1]), rtol=0,
                                   atol=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serving.load_serving(str(both), "cuda")
    with pytest.raises(ValueError, match="none for 'cuda'"):
        serving.load_serving(path, "cuda")


def test_cli_export_and_serve(exported, tmp_path):
    """``python -m semi_seg_ecg_tpu_torch.cli export`` writes the artifact
    and prints one JSON line; ``serve`` prints where it listens, then
    answers."""
    config, _, _ = exported[0]["resnet"]
    cfg_path = tmp_path / "config.yaml"
    cfg_path.write_text(yaml.safe_dump(config))
    out = str(tmp_path / "cli.pt2")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        header = export_main(["-f", str(cfg_path), "--out", out, "--batch",
                              "3", "--model_path",
                              config["test"]["model_path"]])
    line = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert line["artifact"] == out and line["bytes"] == os.path.getsize(out)
    assert line["input_shape"] == [3, 1, SIG] == header["input_shape"]

    proc = subprocess.Popen(
        [sys.executable, "-m", "semi_seg_ecg_tpu_torch.cli", "serve", out,
         "--port", "0", "--buckets", "4"], cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        listening = json.loads(proc.stdout.readline())
        assert listening["buckets"] == [4] and listening["artifact"] == out
        meta = json.loads(urllib.request.urlopen(
            listening["listening"] + "/v1/metadata", timeout=60).read())
        assert meta["input_shape"] == [3, 1, SIG]
    finally:
        proc.terminate()
        proc.wait(timeout=60)
        proc.stdout.close()
        proc.stderr.close()
