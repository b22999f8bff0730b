"""The port's ViT-1D + FCNHead against the JAX package's, on the CPU.

The same inputs, made with numpy from a seed, and the same weights — the
JAX model's init trees, perturbed with numpy noise so that every norm scale,
bias and running statistic is non-trivial, carried across by the port's
``utils/weights.py`` — go through both models. The JAX flash path runs its
Pallas kernel in interpret mode (the model picks it off-TPU); the port's
flash path runs the kernel's plain version, because the tensors lie on the
CPU. Logits must match within atol 2e-4 / rtol 1e-3 at fp32: twelve fp32
layers of sums taken in another order.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from semi_seg_ecg_tpu.models import build_model_from_config as jax_build
from semi_seg_ecg_tpu.ops.interpolate import (
    linear_interpolate as jax_interpolate,
)
from semi_seg_ecg_tpu.utils.torch_interop import trees_to_torch_sd
from semi_seg_ecg_tpu_torch.models import build_model_from_config
from semi_seg_ecg_tpu_torch.models.backbones.vision_transformer import (
    Attention,
)
from semi_seg_ecg_tpu_torch.ops import flash_attention as torch_flash
from semi_seg_ecg_tpu_torch.ops.interpolate import linear_interpolate
from semi_seg_ecg_tpu_torch.utils.weights import jax_trees_to_state_dict

SEQ, PATCH, WIDTH, HEADS, DIM_HEAD = 500, 25, 64, 2, 32


def vit_config(attention_impl="xla", **backbone):
    bb = {"num_leads": 1, "seq_len": SEQ, "patch_size": PATCH,
          "width": WIDTH, "depth": 2, "heads": HEADS, "dim_head": DIM_HEAD,
          "mlp_dim": 128, "out_indices": [0, 1],
          "attention_impl": attention_impl}
    bb.update(backbone)
    return {
        "precision": "fp32",
        "backbone": {"vit_tiny": bb},
        "decode_head": {"FCNHead": {
            "in_channels": WIDTH, "in_index": 1, "channels": 16,
            "num_convs": 1, "concat_input": True, "dropout_ratio": 0.1,
            "num_classes": 4, "align_corners": False}},
    }


def perturbed_jax_trees(model, x, seed):
    variables = model.init(
        {"params": jax.random.key(0), "dropout": jax.random.key(1)},
        jnp.asarray(x), train=False)
    rng = np.random.default_rng(seed)

    def noisy(tree, positive=False):
        if isinstance(tree, dict):
            return {k: noisy(v, positive or k == "var")
                    for k, v in tree.items()}
        a = np.asarray(tree, np.float32)
        a = a + 0.1 * rng.standard_normal(a.shape).astype(np.float32)
        return np.abs(a) + 0.5 if positive else a

    return noisy(dict(variables["params"])), noisy(
        dict(variables["batch_stats"]))


@pytest.mark.parametrize("attention_impl,backbone", [
    ("xla", {}),
    ("flash", {}),
    ("flash", {"qk_norm": True}),
    ("xla", {"layer_scale": 0.5}),
    ("flash", {"final_norm": True, "qkv_bias": False}),
    ("flash", {"num_leads": 3}),
], ids=["xla", "flash", "flash-qknorm", "xla-layerscale",
        "flash-finalnorm-nobias", "flash-3leads"])
def test_vit_fcn_logits_match_jax(attention_impl, backbone):
    cfg = vit_config(attention_impl, **backbone)
    leads = backbone.get("num_leads", 1)  # patchify's '(p c)' order
    x = np.random.default_rng(0).standard_normal((2, leads, SEQ)).astype(
        np.float32)
    jmodel = jax_build(cfg, train=False, serving=True)
    params, stats = perturbed_jax_trees(jmodel, x, seed=1)
    ref = np.asarray(jmodel.apply({"params": params, "batch_stats": stats},
                                  jnp.asarray(x), train=False)["seg_logits"])

    model = build_model_from_config(cfg).eval()
    model.load_state_dict(jax_trees_to_state_dict(params, stats))
    before = torch_flash.LAUNCHES
    with torch.no_grad():
        ours = model(torch.from_numpy(x))["seg_logits"].numpy()
    assert torch_flash.LAUNCHES == before  # CPU tensors: the plain version
    assert ours.shape == ref.shape == (2, 4, SEQ)
    np.testing.assert_allclose(ours, ref, atol=2e-4, rtol=1e-3)


@pytest.mark.parametrize("impl,dim_head,n,on_cuda,attn_drop,want", [
    ("flash", 64, 101, True, 0.0, True),
    # a head dim the kernel does not take still goes to the kernel's
    # wrapper, which raises on the card: no quiet swap to the dense path
    ("flash", 160, 101, True, 0.0, True),
    ("flash", 64, 101, True, 0.1, False),  # dropout needs the (N, N) matrix
    ("auto", 64, 511, True, 0.0, False),
    ("auto", 64, 512, True, 0.0, True),
    ("auto", 64, 4096, False, 0.0, False),
    ("xla", 64, 4096, True, 0.0, False),
    ("ring", 64, 4096, True, 0.0, False),  # no sequence mesh: dense
])
def test_use_flash_rules(impl, dim_head, n, on_cuda, attn_drop, want):
    attn = Attention(32, 32, heads=2, dim_head=dim_head,
                     attn_dropout=attn_drop, attention_impl=impl).train()
    assert attn._use_flash(n, on_cuda) is want


def test_state_dict_keys_follow_reference_key_space():
    """The port's module names are the reference torch keys the JAX
    package's own ``.pth`` exporter writes, variant leaves included."""
    cfg = vit_config("flash", qk_norm=True, layer_scale=0.1, final_norm=True)
    x = np.zeros((2, 1, SEQ), np.float32)
    jmodel = jax_build(cfg, train=False, serving=True)
    params, stats = perturbed_jax_trees(jmodel, x, seed=2)
    ours = jax_trees_to_state_dict(params, stats)
    theirs = trees_to_torch_sd(params, stats)
    assert set(ours) == set(theirs) == set(build_model_from_config(
        cfg).state_dict())
    for key, value in theirs.items():
        np.testing.assert_array_equal(ours[key].numpy(), value)


@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("in_len,out_len", [(20, 500), (7, 1), (33, 33),
                                            (100, 37)])
def test_linear_interpolate_matches_jax(align_corners, in_len, out_len):
    x = np.random.default_rng(3).standard_normal((2, in_len, 3)).astype(
        np.float32)
    ref = np.asarray(jax_interpolate(jnp.asarray(x), out_len,
                                     align_corners=align_corners,
                                     time_axis=1))
    ours = linear_interpolate(torch.from_numpy(x), out_len,
                              align_corners=align_corners,
                              time_axis=1).numpy()
    # the same float64 coordinates and fp32 taps on both sides
    np.testing.assert_allclose(ours, ref, atol=1e-6, rtol=1e-6)


def test_interpolate_taps_stay_on_the_device():
    """The taps are made once per (lengths, device): a serving call under
    inference mode first, then a training forward that saves them for its
    backward, then an exported program, which holds its own copies, and
    eager calls after it, which still get the kept ones."""
    from semi_seg_ecg_tpu_torch.ops import interpolate

    size = 911  # lengths no other test asks for
    x = torch.randn(2, 3, 17)
    with torch.inference_mode():
        served = linear_interpolate(x, size)
    before = interpolate._device_coords.cache_info()
    xg = x.clone().requires_grad_()
    trained = linear_interpolate(xg, size)
    trained.sum().backward()
    assert torch.equal(trained.detach(), served)
    assert xg.grad is not None
    after = interpolate._device_coords.cache_info()
    assert after.hits == before.hits + 1 and after.misses == before.misses

    class Resize(torch.nn.Module):
        def forward(self, t):
            return linear_interpolate(t, size)

    program = torch.export.export(Resize(), (x,)).module()
    assert torch.equal(program(x), served)
    assert torch.equal(linear_interpolate(x, size), served)
    assert interpolate._device_coords.cache_info().misses == after.misses


def test_unported_parts_raise():
    from semi_seg_ecg_tpu_torch.models.quant_layers import int8_modules

    cfg = vit_config()
    # int8 convolutions, named in the backbone's own kwargs, reach the
    # backbone (ported; tests/test_torch_quant.py holds them against JAX)
    resnet = dict(cfg, backbone={"resnet18": {"num_leads": 1,
                                              "quantize": "int8"}})
    assert int8_modules(build_model_from_config(resnet).backbone)
    # the config's quantize: only a serving build quantizes
    assert not int8_modules(build_model_from_config(dict(cfg,
                                                         quantize="int8")))
    assert len(int8_modules(build_model_from_config(
        dict(cfg, quantize="int8"), serving=True))) == 1 + 4 * 2 + 2
    # (the patch embedding, 4 linears a block, the head's two ConvBNs)
    # remat (activation checkpointing, ported) changes nothing in eval, nor
    # in a training forward and its gradients, dropout on
    # (tests/test_torch_remat.py holds whole steps)
    from semi_seg_ecg_tpu_torch.models.dropout import use_generator

    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, 1, SEQ)).astype(np.float32))
    outs = []
    for remat in (False, True):
        torch.manual_seed(0)
        model = build_model_from_config(vit_config(
            remat=remat, drop_out_rate=0.2, drop_path_rate=0.2), train=True)
        use_generator(model, torch.Generator().manual_seed(3))
        with torch.no_grad():
            evaluated = model.eval()(x)["seg_logits"]
        trained = model.train()(x)["seg_logits"]
        trained.square().sum().backward()
        outs.append((evaluated, trained,
                     model.backbone.to_patch_embedding[2].weight.grad))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_flash_path_hands_the_kernel_views_of_the_projection(monkeypatch):
    """q, k, v reach the flash wrapper as the transposed chunks of the qkv
    projection's output, sharing its storage (no copy), and the wrapper's
    (B, N, H, D)-memory output reaches the out projection as a view."""
    from semi_seg_ecg_tpu_torch.models.backbones import vision_transformer

    heads, dim_head = 2, 32
    attn = Attention(64, 64, heads=heads, dim_head=dim_head,
                     attention_impl="flash").eval()
    seen = {}
    attn.to_qkv.register_forward_hook(
        lambda module, args, out: seen.update(qkv=out))
    attn.to_out[0].register_forward_pre_hook(
        lambda module, args: seen.update(merged=args[0]))

    def fake_flash(q, k, v, scale):
        seen.update(q=q, k=k, v=v)
        out = torch_flash.flash_attention_plain(q, k, v, scale)[0]
        seen["out"] = out.transpose(1, 2).contiguous().transpose(1, 2)
        return seen["out"]

    monkeypatch.setattr(vision_transformer, "flash_attention", fake_flash)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (3, 11, 64)).astype(np.float32))
    with torch.no_grad():
        got = attn(x)
    qkv, inner = seen["qkv"], heads * dim_head
    for i, name in enumerate("qkv"):
        t = seen[name]
        assert t.shape == (3, heads, 11, dim_head), name
        assert not t.is_contiguous(), name
        assert (t.untyped_storage().data_ptr()
                == qkv.untyped_storage().data_ptr()), name
        assert t.data_ptr() == qkv.data_ptr() + i * inner * 4, name
        assert t.stride() == (11 * 3 * inner, dim_head, 3 * inner, 1), name
    assert (seen["merged"].untyped_storage().data_ptr()
            == seen["out"].untyped_storage().data_ptr())
    # and the module's output is the dense path's
    attn.attention_impl = "xla"
    with torch.no_grad():
        np.testing.assert_allclose(got.numpy(), attn(x).numpy(), atol=1e-6)
