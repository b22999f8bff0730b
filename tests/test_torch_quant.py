"""int8 serving in the port against the JAX package, on the CPU.

``ops/quant.py``, ``models/quant_layers.py``, ``utils/calibrate.py`` and
the ``quantize`` builds, each held against its JAX counterpart on the same
inputs, made from a seed with numpy:

- ``quantize_symmetric`` and ``quantize_static``: codes and scales bit-equal
  (random tensors, per-channel scales, the all-zero tensor, exact .5 ties,
  which both round half to even);
- the int32 accumulators of the convolution (NCW against the JAX package's
  NWC; the ResNet's strides, paddings and dilations, the stem's k = 7 and
  the patch embedding's k = 25, which the card's integer GEMM takes only
  padded) and of the dense layer equal, their dequantized outputs within
  1e-6 relative;
- the int8 ResNet-1D and ViT-1D with transplanted weights against the JAX
  int8 models: logits within ``MODEL_RTOL`` relative norm and argmax
  agreement of at least ``MODEL_AGREE``. The two packages' fp32 arithmetic
  ahead of each int8 layer (LayerNorm, BatchNorm, GELU, the softmax of
  attention) rounds apart by an ulp or so, which can move an activation
  across a .5 code boundary; the test counts those code flips at the first
  layers that see them and measured 0 here, so the logits agree to fp32
  rounding;
- calibration: the same batches give the same per-layer absmax (within
  1e-6 relative), and static-scale logits match the JAX package's;
- the port's forms of ``tests/test_quantization.py``: the float
  ``state_dict`` loads into the int8 model, argmax agreement with the float
  model, static against dynamic scales, the graph without activation
  reductions, and the rejections;
- F3: only serving builds quantize; ST++'s ranking ignores ``quantize``.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from semi_seg_ecg_tpu import serving as jax_serving
from semi_seg_ecg_tpu.models import build_model_from_config as jax_build
from semi_seg_ecg_tpu.ops import quant as jq
from semi_seg_ecg_tpu.utils.calibrate import calibrate_quant as jax_calibrate
from semi_seg_ecg_tpu.utils.checkpoint import save_checkpoint as jax_save
from semi_seg_ecg_tpu.utils.train_state import ModelState
from semi_seg_ecg_tpu_torch import serving
from semi_seg_ecg_tpu_torch.algorithms import stpp
from semi_seg_ecg_tpu_torch.config import normalize_config
from semi_seg_ecg_tpu_torch.models import build_model_from_config
from semi_seg_ecg_tpu_torch.models.quant_layers import (
    Int8Conv1d,
    Int8Linear,
    int8_modules,
)
from semi_seg_ecg_tpu_torch.ops import quant
from semi_seg_ecg_tpu_torch.utils.calibrate import calibrate_quant
from semi_seg_ecg_tpu_torch.utils.checkpoint import save_checkpoint
from semi_seg_ecg_tpu_torch.utils.weights import (
    jax_quant_to_absmax,
    jax_trees_to_state_dict,
)
from tests.test_models import RESNET_CFG, VIT_CFG
from tests.test_torch_stpp import unlabeled_dataset_config
from tests.test_torch_train_slice import jit_init_variables
from tests.torch_dist_worker import one_thread  # noqa: F401 (autouse)

SIG = 500
# port int8 model against the JAX int8 model (see the module docstring)
MODEL_RTOL, MODEL_AGREE = 1e-4, 0.999
OUT_RTOL = 1e-6
# static scales calibrated by each package on its own: the absmax the two
# record differ by an ulp where the activations do (1 of 11 layers of the
# ViT here), and a static scale one ulp apart moves later codes; measured
# 5.1e-3 relative norm of the probabilities, argmax agreement 1.0. With
# the JAX package's absmax carried into the port, within 1e-5.
STATIC_RTOL = 6e-3
METRIC = {"task": "segmentation", "compute_on_cpu": True,
          "sync_on_compute": False, "num_classes": 4,
          "include_background": True, "per_class": False,
          "input_format": "one-hot", "target_metrics": ["MeanIoU"]}


def small_config(name):
    """A narrow ResNet-1D (2 stages) or a depth-2 ViT-1D, fp32, with the
    FCN head; the ViT's patch embedding takes k = 25."""
    head = {"in_index": 0, "channels": 16, "num_convs": 1,
            "concat_input": True, "dropout_ratio": 0.1, "num_classes": 4,
            "align_corners": False}
    if name == "resnet":
        backbone = {"resnet18": {
            "num_leads": 1, "stem_channels": 8, "base_channels": 8,
            "num_stages": 2, "out_indices": [1], "strides": [1, 2],
            "dilations": [1, 2]}}
        head["in_channels"] = 16
    else:
        backbone = {"vit_tiny": {
            "num_leads": 1, "seq_len": SIG, "patch_size": 25, "width": 64,
            "depth": 2, "heads": 2, "dim_head": 32, "mlp_dim": 128,
            "out_indices": [1], "attention_impl": "xla"}}
        head["in_channels"] = 64
    return {"seed": 0, "precision": "fp32", "device": "cpu",
            "backbone": backbone, "decode_head": {"FCNHead": head}}


def noisy_trees(variables, seed):
    rng = np.random.default_rng(seed)

    def noisy(tree, positive=False):
        if isinstance(tree, dict):
            return {k: noisy(v, positive or k == "var")
                    for k, v in tree.items()}
        a = np.asarray(tree, np.float32)
        a = a + 0.05 * rng.standard_normal(a.shape).astype(np.float32)
        return np.abs(a) + 0.5 if positive else a

    return (noisy(dict(variables["params"])),
            noisy(dict(variables.get("batch_stats", {}))))


@pytest.fixture(scope="module")
def pair():
    """Per model: the JAX int8 model and its (perturbed) trees, and the
    port's int8 model with those weights."""
    out = {}
    for seed, name in enumerate(("resnet", "vit")):
        cfg = small_config(name)
        jmodel = jax_build({**cfg, "quantize": "int8"}, train=False,
                           serving=True)
        params, stats = noisy_trees(jit_init_variables(jmodel), seed)
        model = build_model_from_config({**cfg, "quantize": "int8"},
                                        serving=True)
        model.load_state_dict(jax_trees_to_state_dict(
            params, stats, model.state_dict().keys()))
        out[name] = (cfg, jmodel, params, stats, model.eval())
    return out


def batch(seed, n=3):
    return np.random.default_rng(seed).standard_normal(
        (n, 1, SIG)).astype(np.float32)


def jax_logits(jmodel, params, stats, x, quant_tree=None):
    variables = {"params": params, "batch_stats": stats}
    if quant_tree is not None:
        variables["quant"] = quant_tree
    out = jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(
        variables, jnp.asarray(x))
    return np.asarray(out["seg_logits"], np.float32)


def port_logits(model, x):
    with torch.inference_mode():
        return model(torch.from_numpy(x))["seg_logits"].numpy()


def assert_models_agree(got, want):
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    agree = float((got.argmax(1) == want.argmax(1)).mean())
    assert rel <= MODEL_RTOL, rel
    assert agree >= MODEL_AGREE, agree


# ---------------------------------------------------------------------------
# ops/quant.py
# ---------------------------------------------------------------------------


def _ties():
    # scale exactly 1 (absmax 127): every .5 rounds half to even
    t = np.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, 127.0, 3.5, 0.0],
                 np.float32)
    return t


QUANT_CASES = {
    "random": (lambda: np.random.default_rng(0).standard_normal(
        (4, 16, 40)).astype(np.float32), None),
    "wide": (lambda: (np.random.default_rng(1).standard_normal((257,))
                      * 1e3).astype(np.float32), None),
    "per_channel": (lambda: np.random.default_rng(2).standard_normal(
        (8, 3, 5)).astype(np.float32), ((1, 2), (1, 2))),
    "per_row": (lambda: np.random.default_rng(3).standard_normal(
        (6, 33)).astype(np.float32), ((1,), (1,))),
    "zeros": (lambda: np.zeros((4, 4), np.float32), None),
    "half_ties": (_ties, None),
}


@pytest.mark.parametrize("case", sorted(QUANT_CASES))
def test_quantize_symmetric_matches_jax(case):
    make, dims = QUANT_CASES[case]
    t = make()
    port_dim, jax_axis = dims if dims else (None, None)
    q, s = quant.quantize_symmetric(torch.from_numpy(t), port_dim)
    jqv, js = jq.quantize_symmetric(jnp.asarray(t), jax_axis)
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jqv))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    if case == "half_ties":
        assert q.numpy().tolist() == [0, 2, 2, 0, -2, -2, 126, 127, 4, 0]
    if case == "zeros":
        assert not q.any() and np.isfinite(s.numpy()).all()
    # symmetric linear quantization: within half a step
    recon = q.float() * s
    assert (recon - torch.from_numpy(t)).abs().le(s / 2 + 1e-7).all()


@pytest.mark.parametrize("scale", [0.0, 1e-3, 0.02, 1.0])
def test_quantize_static_matches_jax(scale):
    t = np.random.default_rng(4).standard_normal((2, 8, 30)).astype(
        np.float32)
    s = np.float32(scale)
    q, sp = quant.quantize_static(torch.from_numpy(t), torch.tensor(s))
    jqv, js = jq.quantize_static(jnp.asarray(t), jnp.asarray(s))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jqv))
    np.testing.assert_array_equal(sp.numpy(), np.asarray(js))
    assert sp.shape == (1, 1, 1)


@pytest.mark.parametrize("m,k,n", [(1, 7, 8), (16, 25, 64), (17, 15, 24),
                                   (40, 64, 20), (3, 1, 1)])
def test_int_matmul_is_exact_at_any_shape(m, k, n):
    """The zero padding to the card's integer-GEMM shapes (m > 16, k and n
    multiples of 8) leaves the int32 product exact."""
    rng = np.random.default_rng(m * k + n)
    a = rng.integers(-127, 128, (m, k)).astype(np.int8)
    w = rng.integers(-127, 128, (n, k)).astype(np.int8)
    got = quant.int_matmul(torch.from_numpy(a), torch.from_numpy(w))
    assert got.dtype == torch.int32 and got.shape == (m, n)
    np.testing.assert_array_equal(got.numpy(),
                                  a.astype(np.int64) @ w.T.astype(np.int64))


# (C_in, C_out, K, stride, padding, dilation): the ResNet's convs (stem
# k7/s2, 3x3 s1/s2, 1x1 s2 downsample, dilated), the FCN head's, and k = 25
CONV_CASES = [(1, 8, 7, 2, 3, 1), (16, 32, 3, 1, 1, 1), (16, 32, 3, 2, 1, 1),
              (16, 32, 1, 2, 0, 1), (8, 8, 3, 1, 2, 2), (3, 8, 5, 1, 4, 2),
              (1, 16, 25, 25, 0, 1)]


@pytest.mark.parametrize("cin,cout,k,stride,pad,dil", CONV_CASES)
def test_int8_conv1d_matches_jax(cin, cout, k, stride, pad, dil):
    rng = np.random.default_rng(cin + cout + k + stride)
    x = rng.standard_normal((2, cin, 100)).astype(np.float32)
    w = (rng.standard_normal((cout, cin, k)) * 0.2).astype(np.float32)
    b = rng.standard_normal(cout).astype(np.float32)
    x_nwc, w_wio = jnp.asarray(x.transpose(0, 2, 1)), \
        jnp.asarray(w.transpose(2, 1, 0))
    # the int32 accumulators on the same codes
    xq, _ = jq.quantize_symmetric(x_nwc)
    kq, _ = jq.quantize_symmetric(w_wio, axis=(0, 1))
    want_acc = jax.lax.conv_general_dilated(
        xq, kq, (stride,), [(pad, pad)], rhs_dilation=(dil,),
        dimension_numbers=("NWC", "WIO", "NWC"),
        preferred_element_type=jnp.int32)
    got_acc = quant.int_conv1d(
        torch.from_numpy(np.asarray(xq).transpose(0, 2, 1).copy()),
        torch.from_numpy(np.asarray(kq).transpose(2, 1, 0).copy()),
        stride, pad, dil)
    assert got_acc.dtype == torch.int32
    np.testing.assert_array_equal(got_acc.numpy(),
                                  np.asarray(want_acc).transpose(0, 2, 1))
    want = np.asarray(jq.int8_conv(x_nwc, w_wio, (stride,), [(pad, pad)],
                                   (dil,), bias=jnp.asarray(b),
                                   out_dtype=jnp.float32)).transpose(0, 2, 1)
    got = quant.int8_conv1d(torch.from_numpy(x), torch.from_numpy(w),
                            torch.from_numpy(b), stride, pad, dil).numpy()
    np.testing.assert_allclose(got, want, rtol=OUT_RTOL, atol=0)
    # and it tracks the float convolution (two rounding steps only)
    ref = torch.nn.functional.conv1d(torch.from_numpy(x), torch.from_numpy(w),
                                     torch.from_numpy(b), stride, pad, dil)
    rel = np.linalg.norm(got - ref.numpy()) / np.linalg.norm(ref.numpy())
    assert rel < 0.02, rel


@pytest.mark.parametrize("shape,cin,cout", [((4, 7), 48, 24),
                                            ((2, 21), 25, 64),
                                            ((5,), 64, 192)])
def test_int8_linear_matches_jax(shape, cin, cout):
    rng = np.random.default_rng(cin * cout)
    x = rng.standard_normal(shape + (cin,)).astype(np.float32)
    w = (rng.standard_normal((cout, cin)) * 0.2).astype(np.float32)
    b = rng.standard_normal(cout).astype(np.float32)
    xq, _ = jq.quantize_symmetric(jnp.asarray(x))
    kq, _ = jq.quantize_symmetric(jnp.asarray(w.T), axis=(0,))
    want_acc = jax.lax.dot_general(
        xq, kq, (((x.ndim - 1,), (0,)), ((), ())),
        preferred_element_type=jnp.int32)
    got_acc = quant.int_matmul(
        torch.from_numpy(np.asarray(xq).reshape(-1, cin)),
        torch.from_numpy(np.asarray(kq).T.copy()))
    np.testing.assert_array_equal(got_acc.numpy(),
                                  np.asarray(want_acc).reshape(-1, cout))
    want = np.asarray(jq.int8_dense(jnp.asarray(x), jnp.asarray(w.T),
                                    bias=jnp.asarray(b),
                                    out_dtype=jnp.float32))
    got = quant.int8_linear(torch.from_numpy(x), torch.from_numpy(w),
                            torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=OUT_RTOL, atol=0)
    ref = x @ w.T + b
    assert np.linalg.norm(got - ref) / np.linalg.norm(ref) < 0.02


def test_int8_layers_output_the_autocast_dtype():
    conv = Int8Conv1d(4, 8, 3, padding=1).eval()
    lin = Int8Linear(8, 16).eval()
    x = torch.randn(2, 4, 20)
    with torch.no_grad():
        assert conv(x).dtype == torch.float32
        with torch.autocast("cpu", dtype=torch.bfloat16):
            y = conv(x)
            assert y.dtype == torch.bfloat16
            assert lin(y.transpose(1, 2)).dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# the int8 models against the JAX package's
# ---------------------------------------------------------------------------


def first_code_flips(pair_entry, x):
    """Codes of the first int8 layer's input that differ between the two
    packages: the count of .5-boundary flips the upstream fp32 arithmetic
    causes (the first layer of each model sees the patch-embedding's
    LayerNorm (ViT) or the raw signal (ResNet))."""
    cfg, jmodel, params, stats, model = pair_entry
    name, first = int8_modules(model)[0]
    seen = {}
    handle = first.register_forward_pre_hook(
        lambda m, args: seen.setdefault("x", args[0]))
    port_logits(model, x)
    handle.remove()
    q_port, _ = quant.quantize_symmetric(seen["x"])
    # the same input through the JAX package's own arithmetic: the port's
    # tensor there, so that only the quantizer is compared
    q_jax, _ = jq.quantize_symmetric(jnp.asarray(seen["x"].numpy()))
    return int((q_port.numpy() != np.asarray(q_jax)).sum())


@pytest.mark.parametrize("name", ["resnet", "vit"])
def test_int8_model_matches_jax(pair, name):
    cfg, jmodel, params, stats, model = pair[name]
    x = batch(10)
    want = jax_logits(jmodel, params, stats, x)
    got = port_logits(model, x)
    assert first_code_flips(pair[name], x) == 0
    assert_models_agree(got, want)
    # the int8 model is not the float one
    float_model = build_model_from_config(cfg)
    float_model.load_state_dict(model.state_dict())
    assert not np.allclose(port_logits(float_model.eval(), x), got,
                           atol=1e-5)


@pytest.mark.parametrize("name", ["resnet", "vit"])
def test_calibration_matches_jax(pair, name):
    cfg, jmodel, params, stats, model = pair[name]
    cal = [batch(20 + i, n=2) for i in range(3)]
    jquant = jax_calibrate(jmodel, params, stats,
                           [jnp.asarray(c) for c in cal])
    want = jax_quant_to_absmax(jax.tree.map(np.asarray, dict(jquant)),
                               model.state_dict().keys())
    try:
        got = calibrate_quant(model, [torch.from_numpy(c) for c in cal])
        assert sorted(got) == sorted(want) == sorted(
            n for n, _ in int8_modules(model))
        for key in want:
            np.testing.assert_allclose(got[key].numpy(), want[key].numpy(),
                                       rtol=1e-6, atol=0, err_msg=key)
        x = cal[0]
        want_logits = jax_logits(jmodel, params, stats, x, jquant)
        assert_models_agree(port_logits(model, x), want_logits)
        # the JAX package's own scales, carried into the port
        for key, m in int8_modules(model):
            m.act_absmax = want[key]
        assert_models_agree(port_logits(model, x), want_logits)
    finally:
        for _, m in int8_modules(model):
            m.act_absmax = None


def test_calibration_raises_on_no_batches_or_no_int8_layers(pair):
    model = pair["resnet"][4]
    with pytest.raises(ValueError, match="at least one batch"):
        calibrate_quant(model, [])
    assert all(m.act_absmax is None and not m.calibrating
               for _, m in int8_modules(model))
    with pytest.raises(ValueError, match="no int8 layers"):
        calibrate_quant(build_model_from_config(small_config("resnet")),
                        [torch.zeros(1, 1, SIG)])


# ---------------------------------------------------------------------------
# tests/test_quantization.py, in the port
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cfg", [RESNET_CFG, VIT_CFG], ids=["resnet", "vit"])
def test_quantized_state_dict_identical(cfg):
    """A float checkpoint loads strictly into the int8 model: the same
    keys, shapes and dtypes, no calibrated absmax among them."""
    fp = build_model_from_config(dict(cfg))
    q = build_model_from_config({**cfg, "quantize": "int8"}, serving=True)
    tree = lambda m: [(k, tuple(v.shape), v.dtype)
                      for k, v in m.state_dict().items()]
    assert tree(fp) == tree(q)
    calibrate_quant(q, [torch.randn(1, 1, 2500)])
    assert tree(fp) == tree(q)
    q.load_state_dict(fp.state_dict())  # strict
    n_layers = len(int8_modules(q))
    # every conv of a ConvBN (ResNet18: 20), or the ViT's patch embedding
    # and 4 per block (12 blocks); the FCN head's ConvBN: 1
    assert n_layers == (21 if "resnet18" in cfg["backbone"] else 50)
    assert not any(isinstance(m, (Int8Conv1d, Int8Linear))
                   for m in q.decode_head.cls_seg.modules())


@pytest.mark.parametrize("cfg", [RESNET_CFG, VIT_CFG], ids=["resnet", "vit"])
def test_quantized_model_argmax_agreement(cfg):
    """Int8 serving makes (nearly) the float model's decisions when fed the
    float model's weights (the JAX test's rule: > 0.9 overall, > 0.995
    where the float margin is above its median, logits within 0.1)."""
    torch.manual_seed(3)
    fp = build_model_from_config(dict(cfg)).eval()
    q = build_model_from_config({**cfg, "quantize": "int8"},
                                serving=True).eval()
    q.load_state_dict(fp.state_dict())
    x = np.random.default_rng(3).standard_normal((2, 1, 2500)).astype(
        np.float32)
    logits_fp, logits_q = port_logits(fp, x), port_logits(q, x)
    pred_fp, pred_q = logits_fp.argmax(1), logits_q.argmax(1)
    assert float((pred_fp == pred_q).mean()) > 0.9
    top2 = np.sort(logits_fp, axis=1)[:, -2:, :]
    margin = top2[:, 1] - top2[:, 0]
    confident = margin > np.median(margin)
    assert float((pred_fp == pred_q)[confident].mean()) > 0.995
    rel = np.linalg.norm(logits_q - logits_fp) / np.linalg.norm(logits_fp)
    assert rel < 0.1, rel


@pytest.mark.parametrize("cfg", [RESNET_CFG, VIT_CFG], ids=["resnet", "vit"])
def test_static_scales_track_dynamic(cfg):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 1, 2500)).astype(np.float32)
    torch.manual_seed(5)
    q = build_model_from_config({**cfg, "quantize": "int8"},
                                serving=True).eval()
    l_dyn = port_logits(q, x)
    absmax = calibrate_quant(q, [torch.from_numpy(rng.standard_normal(
        (2, 1, 2500)).astype(np.float32)) for _ in range(3)]
        + [torch.from_numpy(x)])
    assert absmax and all(a.shape == () and float(a) > 0
                          for a in absmax.values())
    l_sta = port_logits(q, x)
    rel = np.linalg.norm(l_sta - l_dyn) / np.linalg.norm(l_dyn)
    assert rel < 0.1, rel
    assert float((l_dyn.argmax(1) == l_sta.argmax(1)).mean()) > 0.9


def activation_reductions(model, x):
    """``aten.amax`` calls over a whole tensor (the per-tensor activation
    scales; the weights' are per output channel) in one call of ``model``
    (a module or a loaded artifact)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    count = [0]

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if func is torch.ops.aten.amax.default:
                dims = args[1] if len(args) > 1 else kwargs.get("dim", ())
                if len(dims) == args[0].dim():
                    count[0] += 1
            return func(*args, **kwargs)

    with torch.no_grad(), Count():
        model(x)
    return count[0]


def test_static_scale_graph_has_no_activation_reductions():
    """The point of calibration: the static forward reduces no activation
    tensor to find its scale; the dynamic one reduces one per int8
    layer."""
    torch.manual_seed(7)
    q = build_model_from_config({**RESNET_CFG, "quantize": "int8"},
                                serving=True).eval()
    x = torch.randn(2, 1, 2500)
    n_layers = len(int8_modules(q))
    assert activation_reductions(q, x) == n_layers
    calibrate_quant(q, [x])
    assert activation_reductions(q, x) == 0


def test_unknown_quantize_rejected():
    with pytest.raises(ValueError, match="Unsupported quantize"):
        build_model_from_config({**RESNET_CFG, "quantize": "int4"},
                                serving=True)
    bad = {**RESNET_CFG, "backbone": {"resnet18": {"num_leads": 1,
                                                   "quantize": "int4"}}}
    with pytest.raises(ValueError, match="Unsupported quantize"):
        build_model_from_config(bad)


# ---------------------------------------------------------------------------
# F3: only serving builds quantize
# ---------------------------------------------------------------------------


def test_training_build_ignores_quantize():
    model = build_model_from_config({**RESNET_CFG, "quantize": "int8"},
                                    train=True, serving=True)
    assert not int8_modules(model)


def test_nonserving_eval_build_ignores_quantize():
    """Eval-mode builds inside the training pipeline (in-loop evaluation,
    ST++'s snapshot ranking) stay float when the config carries a quantize
    key; only serving builds (``load_eval_model``) quantize."""
    model = build_model_from_config({**RESNET_CFG, "quantize": "int8"})
    assert not int8_modules(model)
    # a quantize key in the backbone's own kwargs reaches the backbone, as
    # in the JAX package
    model = build_model_from_config({**RESNET_CFG, "backbone": {
        "resnet18": {"num_leads": 1, "quantize": "int8"}}})
    assert int8_modules(model) and not int8_modules(model.decode_head)


def test_stpp_ranking_ignores_quantize(tmp_path, monkeypatch):
    """ST++'s reliability ranking of a config with ``quantize: int8`` is
    the ranking without it: the same float snapshots, the same values bit
    for bit."""
    cfg = small_config("resnet")
    cfg.update(algorithm="stpp", output_dir=str(tmp_path), exp_name="exp",
               dataset=unlabeled_dataset_config(tmp_path),
               dataloader={"batch_size": 4, "num_workers": 0},
               train={"epochs": 3}, metric=METRIC)
    stage1 = tmp_path / "exp" / "stage1"
    os.makedirs(stage1)
    for i, e in enumerate(stpp.snapshot_epoch_list(3)):
        torch.manual_seed(30 + i)
        save_checkpoint(str(stage1 / f"checkpoint-{e}.ckpt"), e,
                        build_model_from_config(cfg))
    seen = []
    select = stpp.select_reliable

    def watch(models, *args, **kwargs):
        out = select(models, *args, **kwargs)
        seen.append((models, out))
        return out

    monkeypatch.setattr(stpp, "select_reliable", watch)
    plain = stpp.prepare_semisup(normalize_config(cfg))
    quantized = stpp.prepare_semisup(normalize_config(
        {**cfg, "quantize": "int8"}))
    assert plain == quantized
    for models, _ in seen:
        assert len(models) == 3 and not any(int8_modules(m) for m in models)
    np.testing.assert_array_equal(seen[0][1][2], seen[1][1][2])
    # while the serving build of the same config quantizes
    assert int8_modules(build_model_from_config(
        {**cfg, "quantize": "int8"}, serving=True))


# ---------------------------------------------------------------------------
# the serving entries in int8, against the JAX package's
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def int8_checkpoints(tmp_path_factory, pair):
    """Per model: a config (``device: cpu``, a synthetic test split) and a
    JAX ``.ckpt`` of the pair's weights that both packages load."""
    from semi_seg_ecg_tpu_torch.data.synthetic import make_synthetic_dataset

    root = tmp_path_factory.mktemp("torch_quant")
    data = make_synthetic_dataset(str(root / "data"), num_train_labeled=1,
                                  num_train_unlabeled=1, num_valid=1,
                                  num_test=6, length=SIG, seed=9)
    out = {}
    for name, (cfg, _, params, stats, _) in pair.items():
        path = str(root / f"{name}.ckpt")
        jax_save(path, 0, ModelState(params=params, batch_stats=stats),
                 config=cfg)
        out[name] = {**cfg, "dataset": {**data, "signal_length": SIG},
                     "dataloader": {"batch_size": 2, "num_workers": 0},
                     "test": {"model_path": path},
                     "output_dir": str(root), "exp_name": name}
    return out


@pytest.mark.parametrize("calibration", [0, 2], ids=["dynamic", "static"])
@pytest.mark.parametrize("name", ["resnet", "vit"])
def test_make_serving_fn_int8_matches_jax(int8_checkpoints, name,
                                          calibration):
    config = {**int8_checkpoints[name], "quantize": "int8",
              "quantize_calibration": calibration}
    infer, model = serving.make_serving_fn(normalize_config(config))
    assert len(int8_modules(model)) > 0
    assert all((m.act_absmax is not None) == bool(calibration)
               for _, m in int8_modules(model))
    jinfer, jstate = jax_serving.make_serving_fn(config)
    x = serving._calibration_batches(normalize_config(config), 1)[0]
    got = infer(torch.from_numpy(x)).numpy()
    want = np.asarray(jinfer(jnp.asarray(x)))
    np.testing.assert_allclose(got.sum(axis=1), 1.0, atol=1e-5)
    if not calibration:
        np.testing.assert_allclose(got, want, atol=1e-5)
        return
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel <= STATIC_RTOL, rel
    assert float((got.argmax(1) == want.argmax(1)).mean()) >= MODEL_AGREE
    # the JAX package's calibrated absmax, carried into the port
    from semi_seg_ecg_tpu.algorithms.common import load_eval_model
    from semi_seg_ecg_tpu.utils.calibrate import calibrate_quant as jcal

    jmodel, jms = load_eval_model({**config, "precision": "fp32"})
    jquant = jcal(jmodel, jms.params, jms.batch_stats, [
        jnp.asarray(b) for b in serving._calibration_batches(
            normalize_config(config), calibration)])
    absmax = jax_quant_to_absmax(jax.tree.map(np.asarray, dict(jquant)),
                                 model.state_dict().keys())
    for key, m in int8_modules(model):
        m.act_absmax = absmax[key]
    np.testing.assert_allclose(infer(torch.from_numpy(x)).numpy(), want,
                               atol=1e-5)


def test_run_inference_int8_calibrated(int8_checkpoints):
    """``inference`` with ``quantize: int8`` and ``quantize_calibration``
    serves the split through :func:`serving.make_serving_fn`: calibrated
    on the first test batches, static scales after. (The JAX package's
    ``run_inference`` shards its batches over the test harness's 8-device
    CPU mesh and calibrates on the padded shards, so the two are held
    together at ``make_serving_fn`` above, on the same batches.)"""
    from semi_seg_ecg_tpu_torch.algorithms.common import run_inference

    config = normalize_config({**int8_checkpoints["resnet"],
                               "quantize": "int8", "quantize_calibration": 2,
                               "exp_name": "torch_static"})
    ours = run_inference(config)
    infer, _ = serving.make_serving_fn(config)
    want = np.concatenate([infer(torch.from_numpy(b)).numpy()
                           for b in serving._calibration_batches(config, 3)])
    assert ours.shape == want.shape == (6, 4, SIG)
    np.testing.assert_array_equal(ours, want)
    dynamic = run_inference(dict(config, exp_name="torch_dynamic",
                                 quantize_calibration=0))
    assert not np.allclose(dynamic, ours, atol=1e-6)


def test_test_pass_and_long_records_serve_int8(int8_checkpoints):
    """The test pass (``run_test``) evaluates the int8 model with dynamic
    scales, as the JAX package's does; ``long_record_inference`` serves a
    record through it, against the JAX package's."""
    from semi_seg_ecg_tpu_torch.algorithms.common import run_test

    config = normalize_config({
        **int8_checkpoints["vit"], "quantize": "int8", "metric": METRIC})
    run_test(config)
    outputs = np.load(os.path.join(config["output_dir"], config["exp_name"],
                                   "test_outputs.npy"))
    infer, _ = serving.make_serving_fn(config)
    x = serving._calibration_batches(config, 1)[0]
    np.testing.assert_allclose(outputs[:2], infer(torch.from_numpy(x)),
                               atol=1e-6)

    # 8 windows at hop SIG / 2, two full batches of 4: dynamic int8 scales
    # each batch by its own absmax, and the JAX stitcher fills a short last
    # batch with zero-weight windows where the port runs it short
    ecg = np.random.default_rng(11).standard_normal((1, 9 * SIG // 2)) \
        .astype(np.float32)
    lr = {**config, "dataset": {"signal_length": SIG}}
    ours = serving.long_record_inference(lr, ecg, batch=4)
    theirs = jax_serving.long_record_inference(
        {**int8_checkpoints["vit"], "quantize": "int8",
         "dataset": {"signal_length": SIG}}, ecg, batch=4)
    np.testing.assert_allclose(ours["probs"], theirs["probs"], atol=1e-5)
