"""The ported training slice as a whole, against the JAX package, on the CPU.

Lockstep. A small ViT-1D (depth 2, width 64, 2 heads x 32, 500 samples in
patches of 25) + FCNHead starts from the JAX model's init trees, perturbed
with numpy noise and carried across by ``utils/weights.py``. Dropout is 0,
precision fp32, ``warmup_epochs: 0`` so that the first lr is not 0. K = 3
steps on identical pre-augmented batches go through the JAX package's
jitted ``make_train_step`` (flash attention: the Pallas kernels, forward
and backward, in interpret mode) and through the port's
``Trainer.train_step`` (the kernels' plain versions, the tensors being on
the CPU). Per step the losses agree within rtol 1e-5 and ``mask_ratio``
counts the same confident pixels; after K steps the BatchNorm running
statistics agree within atol 1e-5 + rtol 1e-5 and every parameter within
``PARAM_ATOL_LR`` x lr. The last is stated in units of lr because Adam's
``m / (sqrt(v) + eps)`` turns gradients that are zero in exact arithmetic
(the key bias: softmax ignores a shift shared by all keys) into fp32 noise
of size ~1e-9, whose update is O(lr) with either sign (0.5 lr seen); every
other parameter agrees within ``TIGHT_ATOL_LR`` x lr (0.05 lr seen: small
gradients, whose relative rounding Adam passes on at full size).

FixMatch's ``confidence >= 0.8`` mask would flip on a confidence within
float noise of the threshold; the test asserts that no confidence of its
seed lies within 1e-4 of it, so it cannot be flaky.

End to end. ``train_main`` with ``device: cpu`` trains on a tiny synthetic
split with ``device_augment: true`` and flash attention, writes its files,
serves its checkpoint through the port's ``inference_main``, and the JAX
package's ``load_eval_model`` reads the same ``.ckpt`` to logits within
atol 2e-4 of the port's.
"""

import copy
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from semi_seg_ecg_tpu.algorithms import base as jax_base
from semi_seg_ecg_tpu.algorithms import fixmatch as jax_fixmatch
from semi_seg_ecg_tpu.algorithms.common import (
    apply_eval,
    load_eval_model as jax_load_eval_model,
)
from semi_seg_ecg_tpu.config import normalize_config as jax_normalize
from semi_seg_ecg_tpu.models import build_model_from_config as jax_build
from semi_seg_ecg_tpu.utils.optimizer import build_optimizer as jax_optimizer
from semi_seg_ecg_tpu.utils.train_state import ModelState, TrainState
from semi_seg_ecg_tpu_torch.algorithms import base, fixmatch, get_algorithm
from semi_seg_ecg_tpu_torch.algorithms.common import Trainer
from semi_seg_ecg_tpu_torch.cli import inference_main, train_main
from semi_seg_ecg_tpu_torch.cli import test_main as port_test_main
from semi_seg_ecg_tpu_torch.models import build_model_from_config
from semi_seg_ecg_tpu_torch.ops import flash_attention as fa
from semi_seg_ecg_tpu_torch.ops import gather1d
from semi_seg_ecg_tpu_torch.utils import checkpoint as torch_ckpt
from semi_seg_ecg_tpu_torch.utils.weights import jax_trees_to_state_dict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEQ, WIDTH, BATCH, K, LR = 500, 64, 2, 3, 1e-3
CONF_THRESH = 0.8
PARAM_ATOL_LR = 2.0 * K   # every parameter, in units of lr
TIGHT_ATOL_LR = 0.2       # every parameter but the key bias
KEY_BIAS = "attn.fn.to_qkv.bias"


def lockstep_config(attention_impl, algorithm):
    return {
        "seed": 0, "precision": "fp32", "algorithm": algorithm,
        "backbone": {"vit_tiny": {
            "num_leads": 1, "seq_len": SEQ, "patch_size": 25,
            "width": WIDTH, "depth": 2, "heads": 2, "dim_head": 32,
            "mlp_dim": 128, "out_indices": [1],
            "attention_impl": attention_impl}},
        "decode_head": {"FCNHead": {
            "in_channels": WIDTH, "in_index": 0, "channels": 16,
            "num_convs": 1, "concat_input": False, "dropout_ratio": 0.0,
            "num_classes": 4, "align_corners": False}},
        "dataset": {"signal_length": SEQ},
        "dataloader": {"batch_size": BATCH},
        "train": {"optimizer": "adamw", "lr": LR, "min_lr": 1e-4,
                  "epochs": 2, "warmup_epochs": 0, "weight_decay": 0.05,
                  "max_norm": None,
                  "optimizer_kwargs": {"betas": [0.9, 0.999]},
                  "conf_thresh": CONF_THRESH},
    }


def perturbed_state(model, seed):
    # auxiliary heads exist only in a train-mode graph
    variables = model.init(
        {"params": jax.random.key(0), "dropout": jax.random.key(1),
         "droppath": jax.random.key(2)},
        jnp.zeros((2, 1, SEQ), jnp.float32),
        train=model.with_auxiliary_heads)
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


def batches(seed):
    rng = np.random.default_rng(seed)
    x = lambda: (2 * rng.standard_normal((BATCH, 1, SEQ))).astype(
        np.float32)
    return [{"ecg": x(), "target": rng.integers(0, 4, (BATCH, SEQ)).astype(
                 np.int32), "ecg_u_w": x(), "ecg_u_s": x()}
            for _ in range(K)]


def lockstep(attention_impl, algorithm, jax_algo, port_algo, seed,
             **extra):
    """K steps through both packages; returns per-step metrics of each and
    the final state of each, as flat reference-key state_dicts."""
    cfg = dict(lockstep_config(attention_impl, algorithm), **extra)
    jmodel = jax_build(cfg, train=True)
    params, stats = perturbed_state(jmodel, seed)
    tx = jax_optimizer(cfg, params, K, model=jmodel)
    state = TrainState(step=jnp.asarray(0, jnp.int32),
                       model=ModelState(params, stats),
                       opt_state=tx.init(params))
    jax_step = jax.jit(jax_algo.make_train_step(jmodel, tx, cfg, K))

    model = build_model_from_config(cfg, train=True)
    model.load_state_dict(jax_trees_to_state_dict(params, stats))
    trainer = Trainer(copy.deepcopy(cfg), port_algo.SPEC,
                      torch.device("cpu"), K, model=model)

    theirs, ours = [], []
    for batch in batches(seed):
        if algorithm == "fixmatch":
            logits = apply_eval(jmodel, state.model,
                                jnp.asarray(batch["ecg_u_w"]))["seg_logits"]
            conf = np.asarray(jax.nn.softmax(logits, axis=1).max(axis=1))
            assert np.abs(conf - CONF_THRESH).min() > 1e-4
        state, metrics = jax_step(state, {k: jnp.asarray(v)
                                          for k, v in batch.items()})
        theirs.append({k: float(v) for k, v in metrics.items()})
        metrics = trainer.train_step({k: torch.from_numpy(v).long()
                                      if k == "target" else
                                      torch.from_numpy(v)
                                      for k, v in batch.items()})
        ours.append({k: float(v) for k, v in metrics.items()})
    assert int(state.step) == trainer.step == K
    jax_sd = jax_trees_to_state_dict(state.model.params,
                                     state.model.batch_stats)
    return theirs, ours, jax_sd, trainer.model.state_dict()


def assert_states_agree(jax_sd, port_sd):
    assert jax_sd.keys() <= port_sd.keys()
    for key, want in jax_sd.items():
        got = port_sd[key].detach().numpy()
        want = want.numpy()
        if key.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5,
                                       err_msg=key)
            continue
        if want.dtype.kind != "f":
            continue
        err = np.abs(got - want).max() / LR
        assert err <= PARAM_ATOL_LR, (key, err)
        if not key.endswith(KEY_BIAS):
            assert err <= TIGHT_ATOL_LR, (key, err)


@pytest.mark.parametrize("attention_impl", ["flash", "xla"])
def test_fixmatch_lockstep_matches_jax(attention_impl):
    before = fa.LAUNCHES, fa.BWD_LAUNCHES
    theirs, ours, jax_sd, port_sd = lockstep(
        attention_impl, "fixmatch", jax_fixmatch, fixmatch, seed=4)
    assert (fa.LAUNCHES, fa.BWD_LAUNCHES) == before  # CPU: plain versions
    ratios = [m["mask_ratio"] for m in theirs]
    assert any(0 < r < 1 for r in ratios), ratios  # the mask does work
    for step, (a, b) in enumerate(zip(ours, theirs)):
        assert a.keys() == b.keys()
        # the same count of confident pixels; the two means round apart
        assert round(a["mask_ratio"] * BATCH * SEQ) == \
            round(b["mask_ratio"] * BATCH * SEQ), step
        for k in ("loss_x", "loss_u_s", "loss_total", "loss"):
            assert a[k] == pytest.approx(b[k], rel=1e-5), (step, k)
    assert_states_agree(jax_sd, port_sd)


def test_base_lockstep_matches_jax():
    """base with an auxiliary FCN head on the same features, its loss
    weighted 0.4 into the objective."""
    aux = {"FCNHead": dict(lockstep_config("flash", "base")["decode_head"][
        "FCNHead"], channels=8)}
    theirs, ours, jax_sd, port_sd = lockstep("flash", "base", jax_base,
                                             base, seed=2,
                                             auxiliary_heads=[aux])
    assert any(k.startswith("auxiliary_heads.0.") for k in jax_sd)
    for step, (a, b) in enumerate(zip(ours, theirs)):
        assert a["loss"] == pytest.approx(b["loss"], rel=1e-5), step
    assert_states_agree(jax_sd, port_sd)


def test_train_step_draws_dropout_from_the_trainer_generator():
    """With dropout on, a step is a function of ``(seed, step)``: two
    trainers from one init take the same step, whatever the global RNG
    did in between."""
    cfg = lockstep_config("flash", "fixmatch")
    cfg["decode_head"]["FCNHead"]["dropout_ratio"] = 0.3
    cfg["backbone"]["vit_tiny"].update(drop_out_rate=0.1,
                                       drop_path_rate=0.2)
    batch = {k: torch.from_numpy(v).long() if k == "target"
             else torch.from_numpy(v) for k, v in batches(3)[0].items()}
    runs = []
    for draw in (1, 50):
        torch.manual_seed(0)
        model = build_model_from_config(cfg, train=True)
        torch.rand(draw)  # move the global RNG
        trainer = Trainer(copy.deepcopy(cfg), fixmatch.SPEC,
                          torch.device("cpu"), K, model=model)
        runs.append((trainer.train_step(batch), model.state_dict()))
    (m1, sd1), (m2, sd2) = runs
    assert m1["loss"] == m2["loss"]
    for k in sd1:
        torch.testing.assert_close(sd1[k], sd2[k], rtol=0, atol=0)


def test_train_flag_sets_the_mode_for_one_call():
    """``model(x, train=True)``, the JAX package's ``train=`` flag: a
    train-mode forward (dropout on) from an eval-mode model, which stays in
    eval mode."""
    cfg = lockstep_config("flash", "base")
    cfg["decode_head"]["FCNHead"]["dropout_ratio"] = 0.5
    model = build_model_from_config(cfg, train=True).eval()
    x = torch.from_numpy(batches(4)[0]["ecg"])
    with torch.no_grad():
        evaluated = model(x)["seg_logits"]
        trained = model(x, train=True)["seg_logits"]
    assert not model.training and not torch.equal(evaluated, trained)


def test_unported_algorithms_and_options_raise():
    for name in ("mean_teacher", "cps", "reco", "stpp"):
        with pytest.raises(NotImplementedError, match="not yet ported"):
            get_algorithm(name)
    with pytest.raises(ValueError, match="Invalid algorithm"):
        get_algorithm("nope")


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """One CPU training run of the slice's recipe, cut to a tiny split and a
    depth-2 model: FixMatch, device augmentation, flash attention."""
    from semi_seg_ecg_tpu_torch.data.synthetic import make_synthetic_dataset

    root = tmp_path_factory.mktemp("torch_train")
    data = make_synthetic_dataset(str(root / "data"), num_train_labeled=4,
                                  num_train_unlabeled=4, num_valid=2,
                                  num_test=3, length=SEQ, seed=3)
    with open(os.path.join(REPO, "configs", "base", "vit_tiny",
                           "fixmatch.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg.update(device="cpu", output_dir=str(root / "exps"), exp_name="fm")
    cfg["backbone"]["vit_tiny"].update(
        seq_len=SEQ, width=WIDTH, depth=2, heads=2, dim_head=32,
        mlp_dim=128, out_indices=[1], attention_impl="flash")
    cfg["decode_head"]["FCNHead"].update(in_channels=WIDTH, in_index=0,
                                         channels=16)
    cfg["dataset"].update(data, device_augment=True, signal_length=SEQ)
    cfg["dataset"]["augmentations"][0]["random_resize_crop"][
        "target_length"] = SEQ
    cfg["dataloader"] = {"batch_size": 2, "num_workers": 0}
    cfg["train"].update(epochs=1, warmup_epochs=0)
    path = str(root / "fixmatch.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    launches = gather1d.LAUNCHES, fa.LAUNCHES, fa.BWD_LAUNCHES
    metrics = train_main(["-f", path])
    assert (gather1d.LAUNCHES, fa.LAUNCHES, fa.BWD_LAUNCHES) == launches
    return cfg, path, os.path.join(str(root / "exps"), "fm"), metrics


def test_train_main_writes_the_run_files(trained):
    cfg, _, out_dir, metrics = trained
    for name in ("log.txt", "best-loss.ckpt", "best-MeanIoU.ckpt",
                 "test_metrics.csv", "test_outputs.npy", "test_labels.npy"):
        assert os.path.exists(os.path.join(out_dir, name)), name
    with open(os.path.join(out_dir, "log.txt")) as f:
        epoch = json.loads(f.readline())
    assert epoch["epoch"] == 0
    for k in ("train_loss", "train_loss_x", "train_loss_u_s",
              "train_mask_ratio", "valid_loss", "MeanIoU"):
        assert np.isfinite(epoch[k]), k
    with open(os.path.join(out_dir, "test_metrics.csv")) as f:
        header, row = (line.strip().split(",") for line in f)
    assert header == ["MeanIoU", "loss"]
    assert float(row[1]) == pytest.approx(metrics["loss"], abs=1e-4)
    outputs = np.load(os.path.join(out_dir, "test_outputs.npy"))
    labels = np.load(os.path.join(out_dir, "test_labels.npy"))
    assert outputs.shape == labels.shape == (3, 4, SEQ)
    np.testing.assert_allclose(outputs.sum(axis=1), 1.0, atol=1e-5)
    payload = torch_ckpt.load_checkpoint(os.path.join(out_dir,
                                                      "best-loss.ckpt"))
    assert payload["epoch"] == 0 and payload["step"] == 2
    assert payload["optimizer"]["state"]  # AdamW moments, NumPy leaves


def test_trained_ckpt_is_served_by_both_packages(trained, tmp_path):
    cfg, path, out_dir, _ = trained
    ckpt_path = os.path.join(out_dir, "best-MeanIoU.ckpt")
    # the test pass ran in the recipe's bf16; serve in it too
    override = str(tmp_path / "amp.yaml")
    with open(override, "w") as f:
        yaml.safe_dump({"test": {"use_amp": True}}, f)
    probs = inference_main(["-f", path, "-o", override, "--model_path",
                            ckpt_path, "--exp_name", "served"])
    assert probs.shape == (3, 4, SEQ)
    np.testing.assert_allclose(probs, np.load(os.path.join(
        out_dir, "test_outputs.npy")), atol=1e-6)
    # test_main re-runs the test pass on best-MeanIoU.ckpt
    assert port_test_main(["-f", path]) == pytest.approx(trained[3],
                                                         abs=1e-6)

    x = np.random.default_rng(0).standard_normal((2, 1, SEQ)).astype(
        np.float32)
    jcfg = jax_normalize(dict(copy.deepcopy(cfg), precision="fp32",
                              test={"model_path": ckpt_path}))
    jmodel, jstate = jax_load_eval_model(jcfg)
    theirs = np.asarray(apply_eval(jmodel, jstate, jnp.asarray(x))[
        "seg_logits"])
    model = build_model_from_config(cfg).eval()
    state = torch_ckpt.model_state_dict(torch_ckpt.load_checkpoint(
        ckpt_path)["model"])
    model.load_state_dict(state)
    with torch.no_grad():
        ours = model(torch.from_numpy(x))["seg_logits"].numpy()
    np.testing.assert_allclose(ours, theirs, atol=2e-4)
