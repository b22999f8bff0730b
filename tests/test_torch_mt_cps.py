"""Mean Teacher and CPS in the port, against the JAX package, on the CPU.

Lockstep (the harness of ``test_torch_train_slice.py``): K = 3 fp32 steps
on the same seeded numpy batches through the JAX package's jitted
``make_train_step`` and the port's ``Trainer.train_step``, dropout 0, the
ResNet18 of width 8 trained by SGD with momentum (tight: see
``resnet_lockstep_config``). Mean Teacher runs the eval-mode teacher
(``mt_teacher_eval: true``: a dropout-noised teacher cannot be pinned
across frameworks) and holds the teacher's EMA weights and statistics too;
CPS holds both peers, the second initialised from other noise. Per step the
losses agree within rtol 1e-5; after K steps every network's BN statistics
within 1e-5 and its parameters within ``TIGHT_ATOL_LR`` x lr.

The train-mode teacher (the default) normalizes with the batch's
statistics and leaves its running statistics alone: after a step they are
the EMA of their old values and the student's, bit for bit.

End to end: seven of the eight recipes the port runs,
``resnet18/{scratch, mean_teacher, fixmatch, cps}`` and
``vit_tiny/{scratch, mean_teacher, cps}`` (``test_torch_train_slice.py``
runs ``vit_tiny/fixmatch``), train through ``train_main`` on the CPU at a
tiny size with device augmentation, run their test pass, write
``model_ema`` or ``model_peer`` and ``peer_optimizer`` into the checkpoint,
and serve it through ``inference_main`` and ``test_main``.
"""

import os

import numpy as np
import pytest
import torch

from semi_seg_ecg_tpu.algorithms import cps as jax_cps
from semi_seg_ecg_tpu.algorithms import mean_teacher as jax_mt
from semi_seg_ecg_tpu_torch.algorithms import cps, mean_teacher
from semi_seg_ecg_tpu_torch.algorithms.common import Trainer, init_model
from semi_seg_ecg_tpu_torch.cli import inference_main, train_main
from semi_seg_ecg_tpu_torch.cli import test_main as port_test_main
from semi_seg_ecg_tpu_torch.utils import checkpoint as torch_ckpt
from tests.test_torch_train_slice import (
    K,
    assert_states_agree,
    batches,
    lockstep_states,
    resnet_lockstep_config,
    tiny_recipe,
)


@pytest.mark.parametrize("algorithm", ["mean_teacher", "cps"])
def test_lockstep_matches_jax(algorithm):
    jax_algo, port_algo = {"mean_teacher": (jax_mt, mean_teacher),
                           "cps": (jax_cps, cps)}[algorithm]
    cfg = resnet_lockstep_config(algorithm)
    cfg["train"].update(mt_teacher_eval=True, ema_decay=0.99)
    theirs, ours, jax_sds, port_sds = lockstep_states(
        "xla", algorithm, jax_algo, port_algo, seed=8, cfg=cfg)
    roles = {"mean_teacher": {"model", "ema"},
             "cps": {"model", "peer"}}[algorithm]
    assert set(jax_sds) == set(port_sds) == roles
    for step, (a, b) in enumerate(zip(ours, theirs)):
        assert a.keys() == b.keys() == {"loss_total", "loss_x",
                                        "loss_u_s", "loss"}
        for k in a:
            assert a[k] == pytest.approx(b[k], rel=1e-5), (step, k)
    for role in roles:
        assert_states_agree(jax_sds[role], port_sds[role])
    # the second network moved away from the first
    second = port_sds["ema" if algorithm == "mean_teacher" else "peer"]
    moved = max((second[k] - v).abs().max().item()
                for k, v in port_sds["model"].items()
                if v.is_floating_point())
    assert moved > 0


@pytest.mark.parametrize("teacher_eval", [False, True])
def test_teacher_forward_leaves_its_statistics_alone(teacher_eval):
    """The train-mode teacher predicts from the batch's statistics (BN in
    train mode, not tracking) and the eval-mode one from its running ones;
    either way only the EMA moves the teacher's buffers."""
    cfg = resnet_lockstep_config("mean_teacher")
    cfg["train"].update(mt_teacher_eval=teacher_eval, ema_decay=0.9)
    trainer = Trainer(cfg, mean_teacher.SPEC, torch.device("cpu"), K,
                      model=init_model(cfg, torch.device("cpu")))
    seen = []
    bn = trainer.teacher.backbone.stem[1]
    bn.register_forward_hook(lambda m, args, out: seen.append(
        (m.training, m.track_running_stats)))
    before = {k: v.clone() for k, v in trainer.teacher.state_dict().items()}
    batch = {k: torch.from_numpy(v).long() if k == "target"
             else torch.from_numpy(v) for k, v in batches(1)[0].items()}
    trainer.train_step(batch)
    assert seen == [(not teacher_eval, teacher_eval)]
    assert bn.track_running_stats  # restored after the forward
    student = trainer.model.state_dict()
    for key, value in trainer.teacher.state_dict().items():
        if value.is_floating_point():
            want = before[key] * 0.9 + student[key] * (1.0 - 0.9)
            assert torch.equal(value, want), key
        else:  # num_batches_tracked: no teacher forward counted
            assert torch.equal(value, before[key]), key


RECIPES = [("resnet18", "scratch"), ("resnet18", "mean_teacher"),
           ("resnet18", "fixmatch"), ("resnet18", "cps"),
           ("vit_tiny", "scratch"), ("vit_tiny", "mean_teacher"),
           ("vit_tiny", "cps")]


@pytest.mark.parametrize("family,algorithm", RECIPES,
                         ids=["/".join(r) for r in RECIPES])
def test_recipe_trains_tests_and_serves(family, algorithm, tmp_path):
    name = f"{family}_{algorithm}"
    cfg, path = tiny_recipe(tmp_path, family, algorithm, name)
    metrics = train_main(["-f", path])
    out_dir = os.path.join(str(tmp_path / "exps"), name)
    for f in ("log.txt", "best-loss.ckpt", "best-MeanIoU.ckpt",
              "test_metrics.csv", "test_outputs.npy", "test_labels.npy"):
        assert os.path.exists(os.path.join(out_dir, f)), f
    assert np.isfinite(metrics["loss"]) and 0 <= metrics["MeanIoU"] <= 1
    ckpt_path = os.path.join(out_dir, "best-MeanIoU.ckpt")
    payload = torch_ckpt.load_checkpoint(ckpt_path)
    assert payload["step"] == 2
    extras = {"mean_teacher": {"model_ema"},
              "cps": {"model_peer", "peer_optimizer"}}.get(algorithm, set())
    assert extras == {"model_ema", "model_peer",
                      "peer_optimizer"} & set(payload)
    init = init_model(dict(cfg, seed=0), torch.device("cpu")).state_dict()
    trained = torch_ckpt.model_state_dict(payload["model"])
    assert max((trained[k] - v).abs().max().item() for k, v in init.items()
               if v.is_floating_point()) > 0
    if algorithm == "mean_teacher":
        teacher = payload["model_ema"]
        assert teacher.keys() == payload["model"].keys()
        assert any(not np.array_equal(teacher[k], payload["model"][k])
                   for k in teacher)
    if algorithm == "cps":
        assert payload["model_peer"].keys() == payload["model"].keys()
        assert payload["peer_optimizer"]["state"]

    probs = inference_main(["-f", path, "--model_path", ckpt_path,
                            "--exp_name", f"{name}_served"])
    assert probs.shape == (3, 4, 500)
    np.testing.assert_allclose(probs.sum(axis=1), 1.0, atol=1e-5)
    assert port_test_main(["-f", path]) == pytest.approx(metrics, abs=1e-6)
