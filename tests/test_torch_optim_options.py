"""Layer decay and backbone freezing in the port against the JAX package,
on the CPU.

Trees. A ViT of depth 3, width 64 (with an auxiliary FCN head and ReCo's
latent projection, so every kind of name appears) and the ResNet18 of
width 8 of ``tests/test_torch_train_slice.py`` are built in both packages.
Each JAX leaf is carried to its port parameter by ``utils/weights.py``'s
spec walker: the lr scale and the weight-decay flag of every parameter
equal the JAX package's ``param_lr_scales_and_wd_mask`` leaf by leaf
(exactly: the same power of 0.75), and the frozen set equals
``frozen_param_mask`` for ``mode: freeze_backbone``, ResNet
``frozen_stages`` 0 and 1 and ViT ``frozen_stages`` 2 (whose mask leaves
``cls_embedding`` trainable).

Steps. K = 3 base-algorithm AdamW steps (weight decay 0.05), fp32 with
dropout off, from transplanted weights through the JAX package's jitted
step and the port's ``Trainer``, once with ``layer_decay: 0.75`` and once
with each freezing mode (the ``frozen_stages`` cases with ``remat`` on
both sides too): losses within rtol 1e-5 and states within the existing
locksteps' tolerances (``assert_states_agree``); the frozen parameters,
and the BatchNorm statistics of the stages that run in eval mode,
bit-unchanged on both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semi_seg_ecg_tpu.algorithms import base as jax_base
from semi_seg_ecg_tpu.models import build_model_from_config as jax_build
from semi_seg_ecg_tpu.utils.lr_decay import param_lr_scales_and_wd_mask
from semi_seg_ecg_tpu.utils.optimizer import frozen_param_mask
from semi_seg_ecg_tpu_torch.algorithms import base
from semi_seg_ecg_tpu_torch.models import build_model_from_config
from semi_seg_ecg_tpu_torch.utils.lr_decay import param_lr_scales_and_wd
from semi_seg_ecg_tpu_torch.utils.optimizer import (
    build_optimizer,
    frozen_parameter_names,
)
from semi_seg_ecg_tpu_torch.utils.weights import model_specs
from tests.test_torch_train_slice import (
    SEQ,
    assert_states_agree,
    lockstep_states,
    lockstep_config,
    perturbed_state,
    port_model,
    resnet_lockstep_config,
)

LAYER_DECAY = 0.75


def vit_config(**backbone):
    cfg = lockstep_config("xla", "base")
    cfg["backbone"]["vit_tiny"].update(depth=3, out_indices=[2], **backbone)
    head = dict(cfg["decode_head"]["FCNHead"], channels=8)
    cfg["auxiliary_heads"] = [{"FCNHead": head}]
    cfg.update(use_latent_projection=True, projection_in_dim=64,
               projection_out_dim=16)
    return cfg


def resnet_config(**backbone):
    cfg = resnet_lockstep_config("base")
    cfg["backbone"]["resnet18"].update(backbone)
    cfg["train"].update(optimizer="adamw",
                        optimizer_kwargs={"betas": [0.9, 0.999]})
    return cfg


def jax_param_shapes(cfg):
    model = jax_build(cfg, train=True)
    shapes = jax.eval_shape(lambda: model.init(
        {"params": jax.random.key(0), "dropout": jax.random.key(1),
         "droppath": jax.random.key(2)},
        jnp.zeros((2, 1, SEQ), jnp.float32),
        train=model.with_auxiliary_heads,
        return_latent=model.with_projection))
    return model, shapes["params"]


def by_port_name(tree, params, keys):
    """A JAX tree aligned with ``params``, as ``{port name: leaf}``."""
    out = {}
    for path, key, _ in model_specs(params, {}, keys):
        if path[-1] in ("mean", "var"):  # BatchNorm statistics
            continue
        leaf = tree
        for p in path:
            leaf = leaf[p]
        out[key] = leaf
    return out


def test_lr_scales_and_weight_decay_match_jax():
    cfg = vit_config()
    jmodel, params = jax_param_shapes(cfg)
    depth = cfg["backbone"]["vit_tiny"]["depth"]
    scales, wd = param_lr_scales_and_wd_mask(
        params, depth, LAYER_DECAY, jmodel.no_weight_decay())
    model = build_model_from_config(cfg, train=True)
    keys = set(model.state_dict())
    want_scale = by_port_name(scales, params, keys)
    want_wd = by_port_name(wd, params, keys)
    got = param_lr_scales_and_wd(model, LAYER_DECAY)
    assert got.keys() == want_scale.keys()
    assert model.no_weight_decay() == jmodel.no_weight_decay()
    for name, (scale, decays) in got.items():
        assert scale == want_scale[name], name
        assert decays == bool(want_wd[name]), name
    # every layer id occurs: embeddings 0, blocks 1..3, the rest 4
    assert {round(np.log(s) / np.log(LAYER_DECAY)) for s, _ in
            got.values()} == {4, 3, 2, 1, 0}
    assert not got["backbone.pos_embedding"][1]
    assert got["latent_projection.0.weight"] == (1.0, True)


def test_layer_decay_needs_a_backbone_depth():
    """The JAX package asserts a backbone depth; the port says why."""
    cfg = resnet_config()
    cfg["train"]["layer_decay"] = LAYER_DECAY
    with pytest.raises(ValueError, match="depth"):
        build_optimizer(cfg, build_model_from_config(cfg, train=True), 1)


@pytest.mark.parametrize("family, mode, stages", [
    ("resnet18", "freeze_backbone", -1),
    ("resnet18", "scratch", 0),
    ("resnet18", "scratch", 1),
    ("vit_tiny", "scratch", 2),
    ("vit_tiny", "freeze_backbone", -1),
])
def test_frozen_set_matches_jax(family, mode, stages):
    cfg = (resnet_config if family == "resnet18" else vit_config)(
        frozen_stages=stages)
    cfg["mode"] = mode
    jmodel, params = jax_param_shapes(cfg)
    mask = frozen_param_mask(params, cfg, backbone_frozen_stages=stages,
                             backbone_type="resnet" if family == "resnet18"
                             else "vit")
    model = build_model_from_config(cfg, train=True)
    want = {k for k, v in by_port_name(
        mask, params, set(model.state_dict())).items() if v}
    assert want and frozen_parameter_names(cfg, model) == want
    if family == "vit_tiny" and mode == "scratch":
        assert "backbone.pos_embedding" in want
        assert "backbone.cls_embedding" not in want
    opt = build_optimizer(cfg, model, 1)
    grouped = {id(p) for g in opt.optimizer.param_groups for p in g["params"]}
    for name, p in model.named_parameters():
        assert (name in want) == (not p.requires_grad) == \
            (id(p) not in grouped), name


LOCKSTEPS = {
    "vit_layer_decay": (vit_config, {}, {}),
    "vit_frozen_stages_remat": (vit_config,
                                {"frozen_stages": 2, "remat": True}, {}),
    "resnet_freeze_backbone": (resnet_config, {},
                               {"mode": "freeze_backbone"}),
    "resnet_frozen_stages_remat": (resnet_config,
                                   {"frozen_stages": 1, "remat": True}, {}),
}


@pytest.mark.parametrize("case", list(LOCKSTEPS))
def test_option_steps_match_jax(case):
    make, backbone, extra = LOCKSTEPS[case]
    cfg = make(**backbone)
    cfg.pop("use_latent_projection", None)
    cfg["auxiliary_heads"] = None
    cfg.update(extra)
    if case == "vit_layer_decay":
        cfg["train"]["layer_decay"] = LAYER_DECAY
    theirs, ours, jax_sds, port_sds = lockstep_states(
        "xla", "base", jax_base, base, seed=3, cfg=cfg)
    for step, (a, b) in enumerate(zip(ours, theirs)):
        assert a["loss"] == pytest.approx(b["loss"], rel=1e-5), step
    assert_states_agree(jax_sds["model"], port_sds["model"])

    # the start both sides took, and what stayed as it was
    jit = "resnet18" in cfg["backbone"]
    start = port_model(cfg, *perturbed_state(jax_build(cfg, train=True), 3,
                                             jit)).state_dict()
    model = build_model_from_config(cfg, train=True)
    frozen = frozen_parameter_names(cfg, model)
    family = next(iter(cfg["backbone"]))
    stages = cfg["backbone"][family].get("frozen_stages", -1)
    eval_stats = [k for k in start if "running" in k and (
        k.startswith("backbone.stem.") and stages >= 0
        or any(k.startswith(f"backbone.layer{s}.")
               for s in range(1, stages + 1)))]
    assert bool(frozen) == (case != "vit_layer_decay")
    for k in sorted(frozen) + eval_stats:
        for side in (jax_sds["model"], port_sds["model"]):
            np.testing.assert_array_equal(side[k].numpy(), start[k].numpy(),
                                          err_msg=k)
    moved = [k for k, p in model.named_parameters() if k not in frozen
             and not torch.equal(port_sds["model"][k], start[k])]
    assert moved and "decode_head.cls_seg.weight" in moved
    if case == "vit_frozen_stages_remat":
        assert "backbone.cls_embedding" in moved
    if case == "resnet_freeze_backbone":
        # as in the JAX package, the frozen backbone's BatchNorms still
        # run in train mode and track their statistics
        assert not torch.equal(port_sds["model"][
            "backbone.layer4.1.bn2.running_mean"],
            start["backbone.layer4.1.bn2.running_mean"])
