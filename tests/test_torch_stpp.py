"""ST++ in the port against the JAX package, on the CPU.

- ``snapshot_epoch_list`` for 1-10 epochs and ``per_sample_miou`` (empty
  unions included, with and without the background class) equal the JAX
  package's;
- ``select_reliable``: three ResNet18 snapshots of width 8 (the JAX
  package's perturbed init trees from three seeds, carried into the port)
  rank the same 12 unlabeled windows: the same order, reliabilities within
  1e-6, each written at its true dataset row; and so do two seq ranks
  (threads) that rank on their halves of the time axis;
- the stage-2/3 step: three fp32 steps (SGD with momentum, dropout 0)
  through the JAX package's ``make_train_step`` and the port's
  ``Trainer.train_step``, losses within rtol 1e-5, the student as in
  ``test_torch_mt_cps.py``, the frozen teacher unchanged on both sides.
"""

import contextlib
import copy
import os
import types

import numpy as np
import pytest
import yaml

import jax
import torch

from semi_seg_ecg_tpu.algorithms import stpp as jax_stpp
from semi_seg_ecg_tpu.data.dataset import build_seg_dataset as jax_dataset
from semi_seg_ecg_tpu.data.loader import get_dataloader as jax_loader
from semi_seg_ecg_tpu.models import build_model_from_config as jax_build
from semi_seg_ecg_tpu.ops.metrics import per_sample_miou as jax_miou
from semi_seg_ecg_tpu.parallel.mesh import make_mesh
from semi_seg_ecg_tpu.utils.train_state import ModelState
from semi_seg_ecg_tpu_torch.algorithms import stpp
from semi_seg_ecg_tpu_torch.data.dataset import build_seg_dataset
from semi_seg_ecg_tpu_torch.data.loader import get_dataloader
from semi_seg_ecg_tpu_torch.data.synthetic import make_synthetic_dataset
from semi_seg_ecg_tpu_torch.ops.metrics import per_sample_miou
from semi_seg_ecg_tpu_torch.parallel import seq_shard
from semi_seg_ecg_tpu_torch.utils.weights import jax_trees_to_state_dict
from tests.test_torch_train_slice import (
    REPO,
    SEQ,
    assert_states_agree,
    lockstep_states,
    perturbed_state,
    port_model,
    resnet_lockstep_config,
)

NUM_UNLABELED = 12


def test_snapshot_epochs_match_jax():
    for epochs in range(1, 11):
        assert stpp.snapshot_epoch_list(epochs) == \
            jax_stpp.snapshot_epoch_list(epochs), epochs


@pytest.mark.parametrize("include_background", [True, False])
def test_per_sample_miou_matches_jax(include_background):
    rng = np.random.default_rng(0)
    inter = rng.integers(0, 5, (16, 4)).astype(np.int32)
    psum = inter + rng.integers(0, 5, (16, 4)).astype(np.int32)
    tsum = inter + rng.integers(0, 5, (16, 4)).astype(np.int32)
    psum[:4, 2] = tsum[:4, 2] = inter[:4, 2] = 0  # empty unions count 0
    got = per_sample_miou(inter, psum, tsum, include_background)
    want = jax_miou(inter, psum, tsum, include_background)
    np.testing.assert_array_equal(got, want)
    assert got.shape == (16,)


def unlabeled_dataset_config(tmp_path):
    with open(os.path.join(REPO, "configs", "base", "resnet18",
                           "stpp.yaml")) as f:
        cfg = yaml.safe_load(f)["dataset"]
    cfg.update(make_synthetic_dataset(
        str(tmp_path / "data"), num_train_labeled=2,
        num_train_unlabeled=NUM_UNLABELED, num_valid=2, num_test=2,
        length=SEQ, seed=5), signal_length=SEQ)
    return cfg


@pytest.fixture(scope="module")
def jax_ranking(tmp_path_factory):
    """The JAX package's ranking of the unlabeled split by three perturbed
    snapshots, and the snapshots as port models: ``(dataset config, port
    models, reliable ids, reliability)``."""
    cfg = resnet_lockstep_config("base")
    ds_cfg = unlabeled_dataset_config(tmp_path_factory.mktemp("stpp"))
    jmodel = jax_build(cfg)
    states = [ModelState(*perturbed_state(jmodel, seed, jit=True))
              for seed in (40, 41, 42)]
    mesh = make_mesh(cfg, devices=jax.devices()[:1])
    loader = jax_loader(jax_dataset(ds_cfg, split="train_unlabeled",
                                    mode="eval"),
                        mode="eval", batch_size=5, num_workers=0)
    want_ids, _, want = jax_stpp.select_reliable(jmodel, states, loader,
                                                 mesh, 4, return_values=True)
    models = [port_model(cfg, s.params, s.batch_stats).eval()
              for s in states]
    return ds_cfg, models, want_ids, want


def test_select_reliable_matches_jax(jax_ranking):
    ds_cfg, models, want_ids, want = jax_ranking
    # another batch size: the rows, not the batches, carry the values
    loader = get_dataloader(build_seg_dataset(ds_cfg, split="train_unlabeled",
                                              mode="eval"),
                            mode="eval", batch_size=4, num_workers=0)
    got_ids, rest, got = stpp.select_reliable(
        models, loader, 4, torch.device("cpu"), contextlib.nullcontext)
    assert len(got_ids) == len(rest) == NUM_UNLABELED // 2
    assert sorted(got_ids + rest) == list(range(NUM_UNLABELED))
    np.testing.assert_allclose(got, want, atol=1e-6)
    assert 0 < got.min() < got.max() < 1  # the snapshots disagree
    assert got_ids == want_ids
    order = np.argsort(-got, kind="stable")
    assert got_ids == order[:NUM_UNLABELED // 2].tolist()


def test_select_reliable_under_seq_matches_jax(jax_ranking, monkeypatch):
    """Two seq ranks as threads (``seq_shard.run_threads``) rank on their
    time blocks, the counts summed over them before the mIoU: each rank's
    reliabilities within 1e-6 of the JAX package's one-device ranking (which
    its own tests hold equal to its seq-sharded one), the order the
    same."""
    ds_cfg, models, want_ids, want = jax_ranking
    split = []
    inner = seq_shard.split_batch

    def recorded(batch, *args):
        out = inner(batch, *args)
        split.append(out[1])
        return out

    monkeypatch.setattr(seq_shard, "split_batch", recorded)

    def rank(comm):
        loader = get_dataloader(build_seg_dataset(
            ds_cfg, split="train_unlabeled", mode="eval"), mode="eval",
            batch_size=4, num_workers=0)
        with seq_shard.seq_group(comm):
            return stpp.select_reliable(
                [copy.deepcopy(m) for m in models], loader, 4,
                torch.device("cpu"), contextlib.nullcontext)

    for got_ids, rest, got in seq_shard.run_threads(2, rank):
        np.testing.assert_allclose(got, want, atol=1e-6)
        assert got_ids == want_ids
        assert sorted(got_ids + rest) == list(range(NUM_UNLABELED))
    # every batch of both ranks was split at the signal's length
    assert split == [SEQ] * (2 * -(-NUM_UNLABELED // 4))


def test_stage_step_lockstep_matches_jax():
    cfg = resnet_lockstep_config("stpp")
    spec = types.SimpleNamespace(SPEC=stpp.SEMISUP_SPEC)
    theirs, ours, jax_sds, port_sds = lockstep_states(
        "xla", "stpp", jax_stpp, spec, seed=8, cfg=copy.deepcopy(cfg))
    for step, (a, b) in enumerate(zip(ours, theirs)):
        assert a.keys() == b.keys() == {"loss_total", "loss_x", "loss_u_s",
                                        "loss"}
        for k in a:
            assert a[k] == pytest.approx(b[k], rel=1e-5), (step, k)
    assert_states_agree(jax_sds["model"], port_sds["model"])
    # the teacher is frozen: both still hold the initial weights (the
    # harness starts the teacher as the student)
    init = jax_trees_to_state_dict(
        *perturbed_state(jax_build(cfg, train=True), 8, jit=True),
        port_sds["ema"].keys())
    for sd in (port_sds["ema"], jax_sds["ema"]):
        for key, value in init.items():
            assert torch.equal(sd[key], value), key
    moved = max((port_sds["model"][k] - v).abs().max().item()
                for k, v in init.items() if v.is_floating_point())
    assert moved > 0
