"""The port's FLOP counter (``semi_seg_ecg_tpu_torch/tools/flops_audit.py``)
against hand counts and against the JAX tool's analytic count.

``torch.utils.flop_counter.FlopCounterMode`` with the port's flash
formulas reproduces the hand counts of ``tests/test_flops_audit.py`` (a
dot, a batched dot, an NCW convolution, a strided grouped convolution),
as ``tools/flops_audit.count_jaxpr`` does for the same ops in JAX.

Over one whole FixMatch step (the pseudo-label forward, the train forward,
the backward, the update) of a small ResNet18 and a small dense-attention
ViT, the port's count equals ``count_jaxpr`` of the JAX package's step
(``jax.make_jaxpr`` on abstract state: nothing compiles) exactly, tolerance
0, once the two ops the JAX count takes otherwise are added to the port's,
each computed from the shapes:

- the decode head's resize, which the JAX package computes as an einsum
  with a dense (out, in) interpolation matrix and the port as two taps a
  sample: 2·rows·C·in·out a resize, for the eval forward's rows, the train
  forward's and its backward's input gradient. With the JAX package's
  matrix path switched off (``_MATMUL_MAX_ENTRIES = 0``: its two-gather
  path, the port's), the JAX count loses exactly that;
- a strided convolution's input gradient, which ``count_jaxpr`` counts as a
  transposed convolution over the stride-dilated cotangent (T_in output
  positions) and the port at the forward's T_out:
  2·rows·C_in·C_out·K·(T_in - T_out) for each strided convolution of the
  train forward whose input takes a gradient.

In the port a flash step counts what the dense step counts (forward
4·B·H·Nq·Nkv·D, backward 8·B·H·Nq·Nkv·D through the formulas).
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import semi_seg_ecg_tpu.ops.interpolate as jax_interp
from semi_seg_ecg_tpu.algorithms import fixmatch as jax_fixmatch
from semi_seg_ecg_tpu.algorithms.common import build_state
from semi_seg_ecg_tpu.models import build_model_from_config as jax_build
from semi_seg_ecg_tpu.utils.optimizer import build_optimizer as jax_optimizer
from semi_seg_ecg_tpu_torch.config import normalize_config
from semi_seg_ecg_tpu_torch.tools import flops_audit
from semi_seg_ecg_tpu_torch.tools.flagship import build_trainer
from tests.torch_dist_worker import one_thread  # noqa: F401 (autouse)
from tools.flops_audit import count_jaxpr

SEQ, BATCH, CLASSES = 500, 2, 4


def port_count(fn, *args):
    flops_audit.register_flash_formulas()
    with torch.utils.flop_counter.FlopCounterMode(display=False) as counter:
        fn(*args)
    return counter.get_total_flops()


def jax_count(fn, *args):
    return count_jaxpr(jax.make_jaxpr(fn)(*args).jaxpr)


def zeros(*shape):
    return np.zeros(shape, np.float32)


HAND = {
    "dot": ((zeros(8, 32), zeros(32, 16)), lambda a, b: a @ b,
            lambda a, b: a @ b, 2 * 8 * 16 * 32),
    "batched_dot": ((zeros(4, 8, 32), zeros(4, 32, 16)),
                    lambda a, b: jnp.einsum("bmk,bkn->bmn", a, b),
                    lambda a, b: torch.einsum("bmk,bkn->bmn", a, b),
                    2 * 4 * 8 * 16 * 32),
    # NCW: B=2, C_in=3, T=100, C_out=5, K=7, stride 1, SAME
    "conv": ((zeros(2, 3, 100), zeros(5, 3, 7)),
             lambda x, w: jax.lax.conv_general_dilated(
                 x, w, window_strides=(1,), padding="SAME",
                 dimension_numbers=("NCH", "OIH", "NCH")),
             lambda x, w: torch.nn.functional.conv1d(x, w, padding=3),
             2 * 2 * 100 * 5 * 3 * 7),
    # stride 2, groups 2: the contraction a channel is C_in / groups
    "strided_grouped_conv": (
        (zeros(2, 4, 100), zeros(8, 2, 3)),
        lambda x, w: jax.lax.conv_general_dilated(
            x, w, window_strides=(2,), padding="SAME",
            feature_group_count=2, dimension_numbers=("NCH", "OIH", "NCH")),
        lambda x, w: torch.nn.functional.conv1d(x, w, stride=2, padding=1,
                                                groups=2),
        2 * 2 * 50 * 8 * 2 * 3),
}


@pytest.mark.parametrize("name", sorted(HAND))
def test_hand_counts(name):
    args, jax_fn, torch_fn, want = HAND[name]
    assert jax_count(jax_fn, *map(jnp.asarray, args)) == want
    assert port_count(torch_fn, *map(torch.from_numpy, args)) == want


def vit_config(attention_impl):
    return {
        "seed": 0, "precision": "fp32", "algorithm": "fixmatch",
        "backbone": {"vit_tiny": {
            "num_leads": 1, "seq_len": SEQ, "patch_size": 25, "width": 64,
            "depth": 2, "heads": 2, "dim_head": 32, "mlp_dim": 128,
            "out_indices": [1], "attention_impl": attention_impl}},
        "decode_head": {"FCNHead": {
            "in_channels": 64, "in_index": 0, "channels": 16,
            "num_convs": 1, "concat_input": False, "dropout_ratio": 0.0,
            "num_classes": CLASSES, "align_corners": False}},
        "dataset": {"signal_length": SEQ},
        "dataloader": {"batch_size": BATCH},
        "train": {"optimizer": "adamw", "lr": 1e-3, "min_lr": 1e-4,
                  "epochs": 2, "warmup_epochs": 0, "weight_decay": 0.05,
                  "max_norm": None,
                  "optimizer_kwargs": {"betas": [0.9, 0.999]},
                  "conf_thresh": 0.8},
    }


def resnet_config():
    cfg = vit_config("xla")
    cfg["backbone"] = {"resnet18": {"num_leads": 1, "stem_channels": 8,
                                    "base_channels": 8}}
    cfg["decode_head"]["FCNHead"].update(in_channels=64, in_index=3)
    return cfg


CONFIGS = {"resnet18": resnet_config, "vit_dense": lambda: vit_config("xla")}


def jax_step_count(cfg, matmul_resize=True):
    """``count_jaxpr`` of the JAX package's FixMatch step on abstract
    state and batch; ``matmul_resize=False`` takes the two-gather resize."""
    model = jax_build(cfg, train=True)
    tx = jax_optimizer(cfg, None, 3, model=model)
    state = jax.eval_shape(functools.partial(
        build_state, cfg, model, tx, jax_fixmatch.SPEC, seed=0))
    signal = jax.ShapeDtypeStruct((BATCH, 1, SEQ), jnp.float32)
    batch = {"ecg": signal, "ecg_u_w": signal, "ecg_u_s": signal,
             "target": jax.ShapeDtypeStruct((BATCH, SEQ), jnp.int32)}
    step = jax_fixmatch.make_train_step(model, tx, cfg, 3)
    old = jax_interp._MATMUL_MAX_ENTRIES
    jax_interp._MATMUL_MAX_ENTRIES = old if matmul_resize else 0
    try:
        return jax_count(step, state, batch)
    finally:
        jax_interp._MATMUL_MAX_ENTRIES = old


def port_step(cfg):
    """The port's FixMatch step of ``cfg`` on the CPU: its count, the
    resize's FLOPs as the JAX einsum counts them, and the strided
    convolutions' input-gradient excess of ``count_jaxpr``."""
    cfg = normalize_config(dict(copy.deepcopy(cfg), device="cpu"))
    trainer = build_trainer(cfg, torch.device("cpu"), 3)
    extra = {"resize": 0, "strided_dgrad": 0}

    def conv_hook(mod, inputs, out):
        x = inputs[0]
        if x.requires_grad and mod.stride[0] > 1:
            extra["strided_dgrad"] += (
                2 * x.shape[0] * mod.in_channels // mod.groups
                * mod.out_channels * mod.kernel_size[0]
                * (x.shape[-1] - out.shape[-1]))

    def head_hook(mod, inputs, out):
        # the decode head's logits, resized to SEQ after it: once in the
        # forward, and once more as the backward's input gradient in train
        logits = out["seg_logits"] if isinstance(out, dict) else out
        rows, c, n_in = logits.shape
        once = 2 * rows * c * n_in * SEQ
        extra["resize"] += once * (2 if logits.requires_grad else 1)

    for m in trainer.model.modules():
        if isinstance(m, torch.nn.Conv1d):
            m.register_forward_hook(conv_hook)
    trainer.model.decode_head.register_forward_hook(head_hook)
    rng = np.random.default_rng(0)
    signal = lambda: torch.from_numpy(  # noqa: E731
        rng.standard_normal((BATCH, 1, SEQ)).astype(np.float32))
    batch = {"ecg": signal(), "ecg_u_w": signal(), "ecg_u_s": signal(),
             "target": torch.from_numpy(rng.integers(0, 4, (BATCH, SEQ)))}
    total, by_op, _ = flops_audit.count_step(trainer, batch)
    return total, by_op, extra


@pytest.mark.parametrize("family", sorted(CONFIGS))
def test_step_count_is_the_jax_count(family):
    cfg = CONFIGS[family]()
    ours, _, extra = port_step(cfg)
    assert ours > 0 and extra["resize"] > 0
    if family == "resnet18":
        assert extra["strided_dgrad"] > 0
    # tolerance 0: integer counts of the same products
    assert jax_step_count(cfg) == ours + extra["resize"] + \
        extra["strided_dgrad"]
    assert jax_step_count(cfg, matmul_resize=False) == \
        ours + extra["strided_dgrad"]


def test_flash_counts_as_dense():
    flash, flash_ops, _ = port_step(vit_config("flash"))
    dense, dense_ops, _ = port_step(vit_config("xla"))
    assert flash == dense
    fwd = "semi_seg_ecg_tpu_torch.flash_attention_forward"
    bwd = "semi_seg_ecg_tpu_torch.flash_attention_backward"
    # forwards on 3 batches of rows (pseudo-labels, labeled, strong) at 4,
    # backwards on 2 at 8
    assert flash_ops[fwd] > 0 and 3 * flash_ops[bwd] == 4 * flash_ops[fwd]
    assert fwd not in dense_ops and bwd not in dense_ops


def test_flash_formulas_are_the_dense_products():
    """The formulas on one call: forward 4·B·H·Nq·Nkv·D, backward
    8·B·H·Nq·Nkv·D, and the dense path's products count the same."""
    from semi_seg_ecg_tpu_torch.ops import flash_attention as fa
    from semi_seg_ecg_tpu_torch.ops.attention import dense_attention

    b, h, n, d = 2, 3, 17, 8
    q, k, v = (torch.randn(b, h, n, d, requires_grad=True)
               for _ in range(3))
    scale = d ** -0.5
    forward = port_count(lambda: fa.flash_attention(q, k, v, scale))
    assert forward == 4 * b * h * n * n * d
    both = port_count(lambda: fa.flash_attention(q, k, v, scale).sum()
                      .backward())
    assert both == 12 * b * h * n * n * d
    dense = port_count(lambda: dense_attention(q, k, v, scale).sum()
                       .backward())
    assert dense == both
