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

The ResNet18 (width 8) FixMatch and base locksteps take SGD with momentum
(``resnet_lockstep_config``) and are held to the same bounds.

End to end. ``train_main`` with ``device: cpu`` trains on a tiny synthetic
split with ``device_augment: true`` and flash attention, writes its files,
serves its checkpoint through the port's ``inference_main``, and the JAX
package's ``load_eval_model`` reads the same ``.ckpt`` to logits within
atol 2e-4 of the port's. The config keys the port once dropped or
refused work: ``checkpoint_backend: orbax`` writes directories holding
the pickle file's payload, ``async_checkpoint`` files equal to the
synchronous ones, ``debug.nan_checks`` trains under anomaly detection; ``profile``'s trace holds the steps of its window
that the epoch reaches (``utils/profiling.ProfileSchedule``).
"""

import copy
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
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
from tests.torch_dist_worker import one_thread  # noqa: F401 (autouse)

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


def resnet_lockstep_config(algorithm):
    """A ResNet18 of stem and base width 8 with the lockstep's head, trained
    by SGD with momentum: its update is proportional to the gradient, so
    the two packages' rounding stays rounding-sized through every BN layer
    and each parameter is held within TIGHT_ATOL_LR. (Adam's first update is
    lr·sign(g): a gradient element within rounding noise of 0 moves by up
    to 2 lr either way, and a ResNet has many; the ViT locksteps hold
    AdamW.)"""
    cfg = lockstep_config("xla", algorithm)
    cfg["backbone"] = {"resnet18": {"num_leads": 1, "stem_channels": 8,
                                    "base_channels": 8}}
    cfg["decode_head"]["FCNHead"]["in_channels"] = 64
    cfg["decode_head"]["FCNHead"]["in_index"] = 3
    cfg["train"].update(optimizer="sgd", optimizer_kwargs={"momentum": 0.9})
    return cfg


def init_variables(model):
    """The model's init trees, op by op."""
    # auxiliary heads exist only in a train-mode graph, the ReCo projection
    # only in a graph that returns the latent
    return functools.partial(model.init, train=model.with_auxiliary_heads,
                             return_latent=model.with_projection)(
        {"params": jax.random.key(0), "dropout": jax.random.key(1),
         "droppath": jax.random.key(2)},
        jnp.zeros((2, 1, SEQ), jnp.float32))


# (model, trees) of each compiled init; a model equal to one here shares it
JIT_INITS = []


def jit_init_variables(model):
    """:func:`init_variables` compiled, once per (equal) model: a ResNet's
    op-by-op init is slow. Its trees round apart from the op-by-op ones, so
    the ViT locksteps keep the latter."""
    for known, trees in JIT_INITS:
        if known == model:
            return trees
    JIT_INITS.append((model, jax.jit(functools.partial(init_variables,
                                                       model))()))
    return JIT_INITS[-1][1]


def perturbed_state(model, seed, jit=False):
    """The model's init trees plus numpy noise; ``jit`` takes them from
    :func:`jit_init_variables`."""
    variables = jit_init_variables(model) if jit else init_variables(model)
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
             cfg=None, **extra):
    """K steps through both packages; returns per-step metrics of each and
    the final model state of each, as flat reference-key state_dicts."""
    theirs, ours, jax_sds, port_sds = lockstep_states(
        attention_impl, algorithm, jax_algo, port_algo, seed, cfg, **extra)
    return theirs, ours, jax_sds["model"], port_sds["model"]


def port_model(cfg, params, stats):
    model = build_model_from_config(cfg, train=True)
    model.load_state_dict(jax_trees_to_state_dict(
        params, stats, model.state_dict().keys()))
    return model


def lockstep_states(attention_impl, algorithm, jax_algo, port_algo, seed,
                    cfg=None, **extra):
    """``lockstep`` with every network of the run: the final states are
    dicts of ``model``, and the Mean Teacher's ``ema`` or the CPS ``peer``
    (initialised from other noise), as the algorithm keeps them. ReCo's
    and ST++'s ``ema`` starts as the student, as the JAX package's and
    the port's trainers start it."""
    cfg = dict(cfg or lockstep_config(attention_impl, algorithm), **extra)
    jmodel = jax_build(cfg, train=True)
    jit = "resnet18" in cfg["backbone"]
    params, stats = perturbed_state(jmodel, seed, jit)
    tx = jax_optimizer(cfg, params, K, model=jmodel)
    accum = cfg["train"].get("accum_iter", 1)
    if accum > 1:
        # as the JAX package's run_training wraps it
        tx = optax.MultiSteps(tx, every_k_schedule=accum)
    spec = port_algo.SPEC
    ema = peer = peer_opt = peer_module = None
    if spec.uses_ema:
        ema = ModelState(params, stats)
    if spec.uses_peer:
        peer = ModelState(*perturbed_state(jmodel, seed + 100, jit))
        peer_opt = tx.init(peer.params)
        peer_module = port_model(cfg, peer.params, peer.batch_stats)
    state = TrainState(step=jnp.asarray(0, jnp.int32),
                       model=ModelState(params, stats),
                       opt_state=tx.init(params), ema=ema, peer=peer,
                       peer_opt_state=peer_opt)
    jax_step = jax.jit(jax_algo.make_train_step(jmodel, tx, cfg, K))

    trainer = Trainer(copy.deepcopy(cfg), spec, torch.device("cpu"), K,
                      model=port_model(cfg, params, stats), peer=peer_module)

    eval_logits = jax.jit(lambda ms, x: apply_eval(jmodel, ms, x)[
        "seg_logits"])
    theirs, ours = [], []
    for batch in batches(seed):
        u_w = jnp.asarray(batch["ecg_u_w"])
        if algorithm in ("fixmatch", "reco"):
            # no confidence within float noise of the threshold
            logits = eval_logits(
                state.ema if algorithm == "reco" else state.model, u_w)
            conf = np.asarray(jax.nn.softmax(logits, axis=1).max(axis=1))
            assert np.abs(conf - cfg["train"]["conf_thresh"]).min() > 1e-4
        if algorithm in ("cps", "stpp"):
            # no pseudo-label within float noise of a tie
            for ms in ((state.model, state.peer) if algorithm == "cps"
                       else (state.ema,)):
                top2 = np.sort(np.asarray(eval_logits(ms, u_w)), axis=1)
                assert (top2[:, -1] - top2[:, -2]).min() > 1e-4
        state, metrics = jax_step(state, {k: jnp.asarray(v)
                                          for k, v in batch.items()})
        theirs.append({k: float(v) for k, v in metrics.items()})
        metrics = trainer.train_step({k: torch.from_numpy(v).long()
                                      if k == "target" else
                                      torch.from_numpy(v)
                                      for k, v in batch.items()})
        ours.append({k: float(v) for k, v in metrics.items()})
    assert int(state.step) == trainer.step == K
    roles = {"model": (state.model, trainer.model),
             "ema": (state.ema, trainer.teacher),
             "peer": (state.peer, trainer.peer)}
    jax_sds, port_sds = {}, {}
    for role, (jax_state, module) in roles.items():
        if module is not None:
            port_sds[role] = module.state_dict()
            jax_sds[role] = jax_trees_to_state_dict(
                jax_state.params, jax_state.batch_stats, port_sds[role].keys())
    if accum > 1:
        # the open window's gradients: optax's running mean of its
        # mini_step gradients, the port's sum of them in .grad
        mini = int(state.opt_state.mini_step)
        assert trainer.optimizer.micro_step == mini
        acc = jax_trees_to_state_dict(state.opt_state.acc_grads,
                                      state.model.batch_stats,
                                      port_sds["model"].keys())
        grads = dict(trainer.model.named_parameters())
        jax_sds["acc_grads"] = {k: v * mini for k, v in acc.items()
                                if k in grads}
        port_sds["acc_grads"] = {k: grads[k].grad for k in
                                 jax_sds["acc_grads"]}
    return theirs, ours, jax_sds, port_sds


def assert_states_agree(jax_sd, port_sd):
    """BN statistics within 1e-5; every parameter within PARAM_ATOL_LR x lr
    and every one but the key bias within TIGHT_ATOL_LR x lr."""
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


@pytest.mark.parametrize("algorithm", ["fixmatch", "base"])
def test_resnet_lockstep_matches_jax(algorithm):
    """ResNet18 (width 8) FixMatch and base: batch-statistic BatchNorm in
    every student pass, eval-mode pseudo-labels from running statistics."""
    jax_algo, port_algo = {"fixmatch": (jax_fixmatch, fixmatch),
                           "base": (jax_base, base)}[algorithm]
    theirs, ours, jax_sd, port_sd = lockstep(
        "xla", algorithm, jax_algo, port_algo, seed=8,
        cfg=resnet_lockstep_config(algorithm))
    assert "backbone.layer4.1.bn2.running_var" in jax_sd
    if algorithm == "fixmatch":
        assert any(0 < m["mask_ratio"] < 1 for m in theirs)
    for step, (a, b) in enumerate(zip(ours, theirs)):
        assert a.keys() == b.keys()
        for k in a:
            if k == "mask_ratio":
                assert round(a[k] * BATCH * SEQ) == \
                    round(b[k] * BATCH * SEQ), step
            else:
                assert a[k] == pytest.approx(b[k], rel=1e-5), (step, k)
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


def test_unported_algorithms_and_options_raise(tmp_path):
    with pytest.raises(ValueError, match="Invalid algorithm"):
        get_algorithm("nope")
    # remat (activation checkpointing, ported): an eval forward is the same
    # with or without it, and so are a training forward and its gradients
    # (tests/test_torch_remat.py holds whole steps)
    outs = []
    x = torch.from_numpy(batches(5)[0]["ecg"])
    for remat in (False, True):
        cfg = resnet_lockstep_config("base")
        cfg["backbone"]["resnet18"]["remat"] = remat
        torch.manual_seed(0)
        model = build_model_from_config(cfg, train=True)
        with torch.no_grad():
            evaluated = model.eval()(x)["seg_logits"]
        trained = model.train()(x)["seg_logits"]
        trained.square().sum().backward()
        outs.append((evaluated, trained, model.backbone.stem[0].weight.grad,
                     model.backbone.layer4[1].bn2.running_var.clone()))
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    # the last refusal, checkpoint_backend: orbax, is the directory
    # backend now: a trainer's state written both ways after a step (the
    # writer thread, as the loop writes) loads to one payload. Across ranks
    # and layouts: tests/test_torch_checkpoint_writer.py
    from semi_seg_ecg_tpu_torch.algorithms import common
    from semi_seg_ecg_tpu_torch.utils.checkpoint import wait_for_pending
    from tests.test_torch_resume import assert_payloads_equal

    cfg = resnet_lockstep_config("base")
    trainer = Trainer(copy.deepcopy(cfg), base.SPEC, torch.device("cpu"), K)
    trainer.train_step({"ecg": x, "target": torch.zeros((BATCH, SEQ),
                                                        dtype=torch.long)})
    paths = {b: str(tmp_path / f"{b}.ckpt") for b in ("pickle", "orbax")}
    for backend, path in paths.items():
        common._save(trainer, [path], 0, cfg, backend, True, True,
                     best={"loss": 1.0})
    wait_for_pending()
    payloads = [torch_ckpt.load_checkpoint(p) for p in paths.values()]
    assert os.path.isdir(paths["orbax"])
    assert_payloads_equal(payloads[1], payloads[0])
    # every layout and option takes either backend; another name raises.
    # int8 serving under the model axis runs
    # (tests/test_torch_seq_algorithms.py holds it against one process's
    # int8, codes and logits); the model axis
    # (tests/test_torch_tensor_parallel.py), ZeRO-1
    # (tests/test_torch_zero1.py) and the device cache
    # (tests/test_torch_device_cache.py) train; the reference's ddp
    # section trains
    cfg = lockstep_config("xla", "base")
    for layout in ({**cfg, "parallel": {"model_parallel": 2},
                    "quantize": "int8"},
                   {**cfg, "parallel": {"shard_optimizer": True,
                                        "model_parallel": 2},
                    "dataset": {**cfg["dataset"], "device_cache": True},
                    "ddp": {"world_size": 2, "distributed": True}}):
        assert common.checkpoint_backend(layout) == "pickle"
        assert common.checkpoint_backend(
            dict(layout, checkpoint_backend="orbax")) == "orbax"
    with pytest.raises(ValueError, match="checkpoint_backend: 'zarr'"):
        common.checkpoint_backend(dict(cfg, checkpoint_backend="zarr"))


def tiny_recipe(root, family, algorithm, exp_name, data_seed=3):
    """A shipped base recipe (``configs/base/{family}/{algorithm}.yaml``)
    on the CPU, cut to a tiny synthetic split and a narrow model, with
    device augmentation (and flash attention for the ViT); writes it
    under ``root`` and returns ``(config, path)``."""
    from semi_seg_ecg_tpu_torch.data.synthetic import make_synthetic_dataset

    data = make_synthetic_dataset(str(root / f"data{data_seed}"),
                                  num_train_labeled=4, num_train_unlabeled=4,
                                  num_valid=2, num_test=3, length=SEQ,
                                  seed=data_seed)
    with open(os.path.join(REPO, "configs", "base", family,
                           f"{algorithm}.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg.update(device="cpu", output_dir=str(root / "exps"),
               exp_name=exp_name)
    if family == "vit_tiny":
        cfg["backbone"]["vit_tiny"].update(
            seq_len=SEQ, width=WIDTH, depth=2, heads=2, dim_head=32,
            mlp_dim=128, out_indices=[1], attention_impl="flash")
        cfg["decode_head"]["FCNHead"].update(in_channels=WIDTH, in_index=0,
                                             channels=16)
    else:
        cfg["backbone"]["resnet18"].update(stem_channels=8, base_channels=8)
        cfg["decode_head"]["FCNHead"].update(in_channels=64, channels=16)
    if cfg.get("use_latent_projection"):  # ReCo: the narrow last feature
        cfg.update(projection_in_dim=64, projection_out_dim=16)
    cfg["dataset"].update(data, device_augment=True, signal_length=SEQ)
    cfg["dataset"]["augmentations"][0]["random_resize_crop"][
        "target_length"] = SEQ
    cfg["dataloader"] = {"batch_size": 2, "num_workers": 0}
    cfg["train"].update(epochs=1, warmup_epochs=0)
    path = str(root / f"{exp_name}.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return cfg, path


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """One CPU training run of the slice's recipe, cut to a tiny split and a
    depth-2 model: FixMatch, device augmentation, flash attention."""
    root = tmp_path_factory.mktemp("torch_train")
    cfg, path = tiny_recipe(root, "vit_tiny", "fixmatch", "fm")
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


@pytest.mark.parametrize("key", ["checkpoint_backend", "profile",
                                 "nan_checks", "async_checkpoint",
                                 "scan_steps"])
def test_config_keys_work_or_raise(key, tmp_path, monkeypatch):
    """Keys the JAX package reads and the port used to drop or refuse:
    ``checkpoint_backend: orbax`` writes each checkpoint as a directory
    (``torch.distributed.checkpoint``) whose payload is the pickle file's
    of the same call (each save is also written as a pickle file beside
    it), and a JAX orbax directory is refused with the converter's name;
    the trace schedule traces the steps of its window up to the epoch's
    end (here step 1 of steps 0-1); ``debug.nan_checks`` trains under
    autograd's anomaly detection; ``async_checkpoint`` (on by default)
    writes files equal byte for byte to the same calls written
    synchronously beside them; ``train.scan_steps: 2`` takes the epoch's
    two steps as one unit of two stacked batches (its steps equal K = 1's
    bit for bit: ``tests/test_torch_scan_steps.py``)."""
    from semi_seg_ecg_tpu_torch.algorithms import common
    from tests.test_torch_resume import assert_payloads_equal

    cfg, path = tiny_recipe(tmp_path, "resnet18", "scratch", key)
    trace_dir = tmp_path / "trace"
    override = {"checkpoint_backend": {"checkpoint_backend": "orbax"},
                "profile": {"profile": {"trace_dir": str(trace_dir),
                                        "start_step": 1, "num_steps": 2}},
                "nan_checks": {"debug": {"nan_checks": True}},
                "async_checkpoint": {"async_checkpoint": True},
                "scan_steps": {"train": dict(cfg["train"],
                                             scan_steps=2)}}[key]
    with open(path, "w") as f:
        yaml.safe_dump(dict(cfg, **override), f)
    anomaly = []
    step = common.Trainer.device_step

    def spy(self, batch):
        anomaly.append(torch.is_anomaly_enabled())
        return step(self, batch)

    save = common._save
    twin = {"checkpoint_backend": ".pickle", "async_checkpoint": ".sync"}

    def saved_twice(trainer, paths, *args, **kwargs):
        # the same call written synchronously as a pickle file, then as
        # the run writes it
        save(trainer, [p + twin[key] for p in paths], *args[:2], "pickle",
             False, *args[4:], **kwargs)
        save(trainer, paths, *args, **kwargs)

    units = []
    stacked = common.capture.stacked_units

    def counted(batches, k):
        for unit in stacked(batches, k):
            units.append(len(next(iter(unit.values()))))
            yield unit

    monkeypatch.setattr(common.Trainer, "device_step", spy)
    monkeypatch.setattr(common.capture, "stacked_units", counted)
    if key in twin:
        monkeypatch.setattr(common, "_save", saved_twice)
    train_main(["-f", path])
    assert anomaly == [key == "nan_checks"] * 2
    assert units == ([2] if key == "scan_steps" else [1, 1])
    assert not torch.is_anomaly_enabled()
    best = os.path.join(str(tmp_path / "exps"), key, "best-MeanIoU.ckpt")
    payload = torch_ckpt.load_checkpoint(best)
    assert payload["step"] == 2 and "backbone.stem.0.weight" in \
        payload["model"]
    if key == "async_checkpoint":
        with open(best + twin[key], "rb") as a, open(best, "rb") as b:
            assert a.read() == b.read()
    if key == "checkpoint_backend":
        assert os.path.isdir(best)
        assert_payloads_equal(payload, torch_ckpt.load_checkpoint(
            best + twin[key]))
        os.makedirs(tmp_path / "orbax.ckpt")  # a JAX orbax directory
        with pytest.raises(NotImplementedError, match="to-torch"):
            torch_ckpt.load_checkpoint(str(tmp_path / "orbax.ckpt"))
    if key == "profile":
        assert os.listdir(trace_dir) == ["rank0_steps1-1.pt.trace.json"]
        assert traced_steps(trace_dir / "rank0_steps1-1.pt.trace.json") == \
            {"ProfilerStep#1"}


def traced_steps(path):
    """The ``ProfilerStep#n`` ranges of a Chrome trace."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return {e["name"] for e in events
            if e.get("name", "").startswith("ProfilerStep#")}


def test_profile_schedule(tmp_path):
    """The window of steps 2-3 of 0-5, then nothing more; without a
    ``trace_dir`` no trace."""
    from semi_seg_ecg_tpu_torch.utils.profiling import (
        ProfileSchedule,
        device_memory_mb,
    )

    cpu = torch.device("cpu")
    sched = ProfileSchedule({"trace_dir": str(tmp_path / "trace"),
                             "start_step": 2, "num_steps": 2}, cpu)
    x = torch.ones(4)
    for step in range(6):
        sched.step(step)
        x = x * 2
    sched.close()
    assert sched.path == str(tmp_path / "trace" / "rank0_steps2-3.pt.trace.json")
    assert traced_steps(sched.path) == {"ProfilerStep#2", "ProfilerStep#3"}
    idle = ProfileSchedule({"start_step": 0, "num_steps": 2}, cpu)
    for step in range(3):
        idle.step(step)
    idle.close()
    assert idle.path is None
    assert device_memory_mb(cpu) is None
