"""The port's ResNet-1D + FCNHead against the JAX package's, on the CPU.

Model parity. The JAX model's init trees, perturbed with numpy noise so that
every BN scale, bias and running statistic is non-trivial, go into the port
through ``utils/weights.py``; the same numpy inputs go through both. Widths:
stem and base 8, T = 256, five variants (plain resnet18, deep stem with
avg-down, dilations with contract-dilation, multi-grid, a one-block-per-
stage Bottleneck). Eval-mode fp32 logits agree within atol 1e-4; train-mode
logits (batch statistics, dropout 0) within atol 3e-5 (each package is up
to 8e-6 from a float64 run, ``TRAIN_LOGITS_ATOL``) and the updated BN
running statistics within atol 1e-5.

Key space and init: the port's keys are the ones the JAX package's own
``.pth`` exporter names; the ``avg_down`` index shift resolves from JAX to
the port and back; Kaiming fan-out draws; ``zero_init_residual``; frozen
stages. Pooling: the stem pool's backward on a tie-heavy input equals
``jax.grad`` of the JAX package's ``max_pool_k3s2`` bit for bit.

Warm start (``mode != scratch``): a backbone saved by the JAX package as a
``.ckpt`` (full model or bare backbone tree) or as a reference ``.pth``
(full or bare state_dict) reaches the port's backbone exactly, and with the
same head weights the port's logits equal the JAX model's.
"""

import copy
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from semi_seg_ecg_tpu.models import build_model_from_config as jax_build
from semi_seg_ecg_tpu.ops.pooling import max_pool_k3s2
from semi_seg_ecg_tpu.utils import checkpoint as jax_ckpt
from semi_seg_ecg_tpu.utils.torch_interop import (
    save_torch_checkpoint,
    trees_to_torch_sd,
)
from semi_seg_ecg_tpu.utils.train_state import ModelState
from semi_seg_ecg_tpu_torch.algorithms.common import (
    init_model,
    init_train_model,
)
from semi_seg_ecg_tpu_torch.models import build_model_from_config
from semi_seg_ecg_tpu_torch.models.backbones.resnet import (
    BasicBlock,
    Bottleneck,
    resnet18,
)
from semi_seg_ecg_tpu_torch.utils.weights import (
    jax_trees_to_state_dict,
    model_specs,
)
from tests.torch_dist_worker import one_thread  # noqa: F401 (autouse)

SEQ, WIDTH = 256, 8
# train mode, fp32: each package's logits lie up to 8e-6 from a float64 run
# of the same model (batch-statistic BN through ~20 layers; the JAX
# BatchNorm takes the variance as E[x²] - E[x]², torch in two passes), and
# up to 1.4e-5 from each other
TRAIN_LOGITS_ATOL = 3e-5
STATS_ATOL = 1e-5

VARIANTS = {
    "resnet18": ("resnet18", {}),
    "deepstem-avgdown": ("resnet18", {"deep_stem": True, "avg_down": True}),
    "dilated-contract": ("resnet18", {"dilations": [1, 1, 2, 4],
                                      "strides": [1, 2, 1, 1],
                                      "contract_dilation": True}),
    "multigrid": ("resnet18", {"dilations": [1, 1, 1, 2],
                               "multi_grid": [1, 2, 4],
                               "stage_blocks": [1, 1, 1, 3]}),
    "bottleneck": ("resnet50", {"stage_blocks": [1, 1, 1, 1]}),
}


def resnet_config(name="resnet18", dropout=0.1, **backbone):
    bb = {"num_leads": 1, "stem_channels": WIDTH, "base_channels": WIDTH,
          "num_stages": 4, "out_indices": [0, 1, 2, 3]}
    bb.update(backbone)
    expansion = 4 if name == "resnet50" else 1
    return {
        "seed": 0, "precision": "fp32",
        "backbone": {name: bb},
        "decode_head": {"FCNHead": {
            "in_channels": WIDTH * 8 * expansion, "in_index": 3,
            "channels": 16, "num_convs": 1, "concat_input": True,
            "dropout_ratio": dropout, "num_classes": 4,
            "align_corners": False}},
    }


def perturbed_trees(model, seed):
    variables = jax.jit(model.init)(
        {"params": jax.random.key(0), "dropout": jax.random.key(1)},
        jnp.zeros((2, 1, SEQ), jnp.float32))
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


def inputs(seed=0, batch=3):
    return np.random.default_rng(seed).standard_normal(
        (batch, 1, SEQ)).astype(np.float32)


def jax_logits(jmodel, params, stats, x, train=False):
    """The JAX model's logits (and with ``train`` its updated batch
    statistics), jitted: one compile instead of one per op."""
    variables = {"params": params, "batch_stats": stats}
    if not train:
        return np.asarray(jax.jit(lambda v, x: jmodel.apply(
            v, x, train=False)["seg_logits"])(variables, jnp.asarray(x)))
    out, mutated = jax.jit(lambda v, x: jmodel.apply(
        v, x, train=True, rngs={"dropout": jax.random.key(0)},
        mutable=["batch_stats"]))(variables, jnp.asarray(x))
    return np.asarray(out["seg_logits"]), jax.device_get(
        mutated["batch_stats"])


@functools.lru_cache(maxsize=None)
def variant_trees(variant, seed=1):
    """Perturbed JAX trees of a variant, made once per test process."""
    name, backbone = VARIANTS[variant]
    return perturbed_trees(jax_build(resnet_config(name, **backbone)), seed)


def transplanted(cfg, variant, seed=1):
    jmodel = jax_build(cfg, train=False, serving=True)
    params, stats = variant_trees(variant, seed)
    model = build_model_from_config(cfg).eval()
    model.load_state_dict(jax_trees_to_state_dict(
        params, stats, model.state_dict().keys()))
    return jmodel, params, stats, model


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_resnet_fcn_logits_match_jax(variant):
    name, backbone = VARIANTS[variant]
    cfg = resnet_config(name, dropout=0.0, **backbone)
    jmodel, params, stats, model = transplanted(cfg, variant)
    x = inputs()
    ref = jax_logits(jmodel, params, stats, x)
    with torch.no_grad():
        ours = model(torch.from_numpy(x))["seg_logits"].numpy()
    assert ours.shape == ref.shape == (3, 4, SEQ)
    np.testing.assert_allclose(ours, ref, atol=1e-4, rtol=0)

    # train mode: batch statistics, and the running statistics they update
    ref, mutated = jax_logits(jmodel, params, stats, x, train=True)
    with torch.no_grad():
        ours = model.train()(torch.from_numpy(x))["seg_logits"].numpy()
    np.testing.assert_allclose(ours, ref, atol=TRAIN_LOGITS_ATOL, rtol=0)
    want = jax_trees_to_state_dict(params, mutated,
                                   model.state_dict().keys())
    got = model.state_dict()
    running = [k for k in want if k.endswith(("running_mean",
                                              "running_var"))]
    assert running
    for key in running:
        np.testing.assert_allclose(got[key].numpy(), want[key].numpy(),
                                   atol=STATS_ATOL, rtol=0, err_msg=key)


@pytest.mark.parametrize("variant", ["resnet18", "bottleneck"])
def test_resnet_keys_follow_reference_key_space(variant):
    """The port's module names are the reference torch keys that the JAX
    package's ``.pth`` exporter writes."""
    name, backbone = VARIANTS[variant]
    _, params, stats, model = transplanted(resnet_config(name, **backbone),
                                           variant)
    ours = jax_trees_to_state_dict(params, stats)
    theirs = trees_to_torch_sd(params, stats)
    assert set(ours) == set(theirs) == set(model.state_dict())
    assert "backbone.stem.0.weight" in ours
    assert "backbone.layer2.0.downsample.1.running_var" in ours
    for key, value in theirs.items():
        np.testing.assert_array_equal(ours[key].numpy(), value)


def test_avg_down_shift_both_ways():
    """The JAX tree does not record ``avg_down``. JAX → port: the target's
    keys decide between ``downsample.{0,1}`` and ``.{1,2}``, so one tree
    loads strictly into either model. Port → JAX: the same walker maps
    each key of the avg-down model's state_dict back to its tree leaf."""
    _, params, stats, model = transplanted(resnet_config(avg_down=True),
                                           "resnet18")
    sd = model.state_dict()
    assert "backbone.layer2.0.downsample.0.weight" not in sd
    assert "backbone.layer2.0.downsample.1.weight" in sd
    plain = build_model_from_config(resnet_config())
    plain.load_state_dict(jax_trees_to_state_dict(
        params, stats, plain.state_dict().keys()))
    assert "backbone.layer2.0.downsample.0.weight" in plain.state_dict()
    # a stride-1 downsample keeps its conv at index 0 under avg_down
    bottleneck = build_model_from_config(resnet_config(
        "resnet50", avg_down=True, stage_blocks=[1, 1, 1, 1]))
    assert "backbone.layer1.0.downsample.0.weight" in \
        bottleneck.state_dict()
    specs = list(model_specs(params, stats, sd.keys()))
    assert {key for _, key, _ in specs} == {
        k for k in sd if not k.endswith("num_batches_tracked")}
    for path, key, kind in specs:
        leaf = stats if path[-1] in ("mean", "var") else params
        for p in path:
            leaf = leaf[p]
        arr = sd[key].numpy()
        if kind == "conv":
            arr = arr.transpose(2, 1, 0)
        np.testing.assert_array_equal(arr, leaf, err_msg=key)


def test_kaiming_fan_out_init_and_zero_init_residual():
    torch.manual_seed(0)
    model = resnet18(1, zero_init_residual=True)
    for key in ("layer1.0.conv1.weight", "layer1.1.conv2.weight",
                "layer4.0.conv1.weight"):
        w = model.state_dict()[key]
        want = (2.0 / (w.shape[0] * w.shape[2])) ** 0.5  # fan_out = out·k
        assert abs(w.std().item() / want - 1) < 0.05, key
    blocks = [m for m in model.modules() if isinstance(m, BasicBlock)]
    assert len(blocks) == 8
    for block in blocks:
        assert torch.count_nonzero(block.bn2.weight) == 0
        assert torch.all(block.bn1.weight == 1)
    assert torch.all(model.layer2[0].downsample[1].weight == 1)
    bottleneck = build_model_from_config(resnet_config(
        "resnet50", zero_init_residual=True, stage_blocks=[1, 1, 1, 1]))
    for block in bottleneck.modules():
        if isinstance(block, Bottleneck):
            assert torch.count_nonzero(block.bn3.weight) == 0


def test_frozen_stages_run_in_eval_mode():
    """``frozen_stages: 1``: the stem and layer1 keep eval mode under
    ``train()`` (running statistics used and left alone), as the JAX
    package's ``stem_train`` / ``stage_train`` flags run them, and the
    train-mode forward matches the JAX package's."""
    cfg = resnet_config(dropout=0.0, frozen_stages=1)
    jmodel, params, stats, model = transplanted(cfg, "resnet18")
    model.train()
    backbone = model.backbone
    assert not backbone.stem.training and not backbone.layer1.training
    assert backbone.layer2.training and model.decode_head.training
    before = copy.deepcopy(backbone.state_dict())
    x = inputs(seed=5)
    with torch.no_grad():
        ours = model(torch.from_numpy(x))["seg_logits"].numpy()
    after = backbone.state_dict()
    for key in before:
        if key.endswith("running_mean"):
            frozen = key.startswith(("stem.", "layer1."))
            assert torch.equal(before[key], after[key]) == frozen, key
    ref, _ = jax_logits(jmodel, params, stats, x, train=True)
    np.testing.assert_allclose(ours, ref, atol=TRAIN_LOGITS_ATOL, rtol=0)


@pytest.mark.parametrize("t", [250, 251, 1250])
def test_stem_pool_routes_tied_gradients_like_jax(t):
    """Flat-line segments make most windows tie; the gradient goes to the
    earliest maximum on both sides, bit for bit."""
    rng = np.random.default_rng(t)
    levels = rng.integers(-2, 3, (2, 5, t // 10 + 1)).astype(np.float32)
    x = np.repeat(levels, 10, axis=-1)[..., :t]  # steps of 10 equal samples
    x[:, :, ::37] += rng.standard_normal(x[:, :, ::37].shape).astype(
        np.float32)
    g = rng.standard_normal((2, 5, (t + 1) // 2)).astype(np.float32)

    xt = torch.from_numpy(x).requires_grad_()
    out = resnet18(5).maxpool(xt)
    out.backward(torch.from_numpy(g))
    _, vjp = jax.vjp(max_pool_k3s2, jnp.asarray(x.transpose(0, 2, 1)))
    (want,) = vjp(jnp.asarray(g.transpose(0, 2, 1)))
    want = np.asarray(want).transpose(0, 2, 1)
    assert out.shape == g.shape
    np.testing.assert_array_equal(xt.grad.numpy(), want)
    assert (want == 0).mean() > 0.3  # the ties did route somewhere


FORMATS = ["jax_ckpt_full", "jax_ckpt_bare", "pth_full", "pth_bare"]


def vit_config():
    return {
        "seed": 0, "precision": "fp32",
        "backbone": {"vit_tiny": {
            "num_leads": 1, "seq_len": SEQ, "patch_size": 16, "width": 32,
            "depth": 2, "heads": 2, "dim_head": 16, "mlp_dim": 64,
            "out_indices": [0, 1], "attention_impl": "xla"}},
        "decode_head": {"FCNHead": {
            "in_channels": 32, "in_index": 1, "channels": 16,
            "num_convs": 1, "concat_input": False, "dropout_ratio": 0.0,
            "num_classes": 4, "align_corners": False}},
    }


def save_backbone(path, fmt, params, stats):
    bb_params = params["backbone"]
    bb_stats = stats.get("backbone", {})
    if fmt == "jax_ckpt_full":
        jax_ckpt.save_checkpoint(path, 0, ModelState(params, stats))
    elif fmt == "jax_ckpt_bare":
        jax_ckpt.save_checkpoint(path, 0, ModelState(bb_params, bb_stats))
    elif fmt == "pth_full":
        save_torch_checkpoint(path, {"model": trees_to_torch_sd(params,
                                                                stats)})
    else:
        save_torch_checkpoint(path, {"model": trees_to_torch_sd(
            bb_params, bb_stats, backbone_only=True)})


@functools.lru_cache(maxsize=None)
def warm_start_source(family):
    """A JAX model with perturbed trees and its logits on fixed inputs."""
    cfg = resnet_config(dropout=0.0) if family == "resnet18" \
        else vit_config()
    jmodel = jax_build(cfg, train=False, serving=True)
    params, stats = perturbed_trees(jmodel, seed=7)
    x = inputs(seed=9)
    return cfg, params, stats, x, jax_logits(jmodel, params, stats, x)


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("family", ["resnet18", "vit_tiny"])
def test_pretrained_backbone_warm_start_matches_jax(family, fmt, tmp_path):
    cfg, params, stats, x, ref = warm_start_source(family)
    path = str(tmp_path / ("backbone.pth" if fmt.startswith("pth")
                           else "backbone.ckpt"))
    save_backbone(path, fmt, params, stats)

    cfg = dict(cfg, mode="finetune", pretrained_backbone=path)
    scratch = init_model(cfg, torch.device("cpu"))
    model = init_train_model(cfg, torch.device("cpu"), seed=0)
    want = jax_trees_to_state_dict(params, stats)
    got = model.state_dict()
    for key, value in want.items():
        if key.startswith("backbone."):
            assert torch.equal(got[key], value), key
            if value.is_floating_point():
                assert not torch.equal(scratch.state_dict()[key], value)
        else:  # the head stays as initialised
            assert torch.equal(got[key], scratch.state_dict()[key]), key
    # with the JAX head's weights too, the logits are the JAX model's
    model.decode_head.load_state_dict(
        {k[len("decode_head."):]: v for k, v in want.items()
         if k.startswith("decode_head.")})
    with torch.no_grad():
        ours = model.eval()(torch.from_numpy(x))["seg_logits"].numpy()
    np.testing.assert_allclose(ours, ref, atol=1e-4, rtol=0)
