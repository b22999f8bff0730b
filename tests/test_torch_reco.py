"""ReCo in the port against the JAX package, on the CPU.

Model: the latent projection. A ResNet18 of width 8 and a 2-layer ViT with
``use_latent_projection`` carry weights across both ways (the JAX package's
perturbed init trees into the port through ``utils/weights.py``; the port's
init into the JAX package through its ``torch_sd_to_trees``); the same
inputs give the same ``latent`` and ``seg_logits``, in eval mode within
1e-5 and in train mode (batch-statistic BN) within 3e-5, each in units of
the output's largest magnitude where that exceeds 1 (``assert_close``), and
the updated BN statistics agree within 1e-5. In units: the ViT's eval
logits reach 22, where fp32 rounding alone puts the two packages 1.0e-5
apart; the ResNet's train-mode latent passes one more batch-statistic BN
(the projection's, over B·T/8 positions) and lies up to 3.8e-5 from a
float64 run in either package, 6.2e-5 from each other, at magnitude 4.8.

Loss (B = 2, D = 16, T = 256, Q = 16, Nn = 32). The JAX draws are mirrored:
``categorical`` is the argmax of gumbels plus logits, pinned to the
installed JAX. Fed the indices that the JAX package's own draws give, the
port's loss core matches ``compute_reco_loss`` in value (rtol 1e-5) and in
the latent gradient (within 1e-5 of ``jax.grad``'s largest element) in five
regimes. Fed the same uniforms and gumbels, the port's sampler picks the
JAX package's indices except where a uniform sits at a CDF step within
float rounding (the two CDFs round apart).

Lockstep: three fp32 ReCo steps (ResNet18 of width 8, SGD with momentum,
dropout 0) through the JAX package's ``make_train_step`` and the port's
``Trainer.train_step``, the port's draws replaced by the JAX package's own
from ``fold_in(key(seed + 7), step)``; thresholds low enough that the
contrastive term is non-zero on every step. Losses within rtol 1e-5;
student, teacher EMA and BN statistics as in ``test_torch_mt_cps.py``.

Under the seq axis (threads): the loss of two ranks' time halves gathered
by ``reco.gather_for_loss`` equals one process's, and so do the ranks'
latent gradients joined; a plain time gather would double them (the
gradient all-reduce sums the seq ranks' gradients).
"""

import copy
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from semi_seg_ecg_tpu.algorithms import reco as jax_reco
from semi_seg_ecg_tpu.models import build_model_from_config as jax_build
from semi_seg_ecg_tpu.ops import reco_loss as jax_reco_loss
from semi_seg_ecg_tpu.utils.torch_interop import torch_sd_to_trees
from semi_seg_ecg_tpu_torch.algorithms import reco
from semi_seg_ecg_tpu_torch.models import build_model_from_config
from semi_seg_ecg_tpu_torch.ops import reco_loss
from semi_seg_ecg_tpu_torch.utils.weights import jax_trees_to_state_dict
from tests.test_torch_train_slice import (
    SEQ,
    assert_states_agree,
    lockstep_config,
    lockstep_states,
    perturbed_state,
    resnet_lockstep_config,
)

B, D, T, C, Q, NN = 2, 16, 256, 4, 16, 32
TEMP = 0.25
EVAL_ATOL, TRAIN_ATOL, STATS_ATOL = 1e-5, 3e-5, 1e-5


def assert_close(got, want, tol, what):
    """max |got - want| <= tol x max(1, max |want|)."""
    err = float(np.abs(got - want).max())
    assert err <= tol * max(1.0, float(np.abs(want).max())), (what, err)


# a uniform within this of a CDF value may round to the other side of it
CDF_ROUNDING = 4 * np.finfo(np.float32).eps


def reco_model_config(family):
    cfg = (resnet_lockstep_config("reco") if family == "resnet18"
           else lockstep_config("xla", "reco"))
    in_dim = cfg["decode_head"]["FCNHead"]["in_channels"]
    cfg.update(use_latent_projection=True, projection_in_dim=in_dim,
               projection_out_dim=16)
    return cfg


@functools.lru_cache(maxsize=None)
def jax_model(family):
    """The family's JAX model, its perturbed init trees and its forward,
    ``apply(params, stats, x, train) -> (latent, seg_logits, new
    batch_stats or None)``, jitted once for the module."""
    cfg = reco_model_config(family)
    jmodel = jax_build(cfg, train=True)
    params, stats = perturbed_state(jmodel, 11, jit=True)

    @functools.partial(jax.jit, static_argnums=3)
    def apply(params, stats, x, train):
        variables = {"params": params, "batch_stats": stats}
        if train:
            out, new = jmodel.apply(variables, x, train=True,
                                    return_latent=True,
                                    mutable=["batch_stats"],
                                    rngs={"dropout": jax.random.key(0),
                                          "droppath": jax.random.key(1)})
            return out["latent"], out["seg_logits"], new["batch_stats"]
        out = jmodel.apply(variables, x, train=False, return_latent=True)
        return out["latent"], out["seg_logits"], None

    return cfg, params, stats, apply


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
@pytest.mark.parametrize("family", ["resnet18", "vit_tiny"])
def test_latent_matches_jax(family, direction):
    cfg, params, stats, apply = jax_model(family)
    model = build_model_from_config(cfg, train=True)
    keys = model.state_dict().keys()
    assert {"latent_projection.0.weight", "latent_projection.2.running_var",
            "latent_projection.3.weight"} <= set(keys)
    if direction == "jax_to_port":
        model.load_state_dict(jax_trees_to_state_dict(params, stats, keys))
    else:
        torch.manual_seed(5)
        model = build_model_from_config(cfg, train=True)
        params, stats = torch_sd_to_trees(
            {k: v.numpy() for k, v in model.state_dict().items()},
            params, stats)
    x = np.random.default_rng(3).standard_normal((3, 1, SEQ)).astype(
        np.float32)
    for train, atol in ((False, EVAL_ATOL), (True, TRAIN_ATOL)):
        latent, logits, new_stats = apply(params, stats, jnp.asarray(x),
                                          train)
        latent, logits = np.asarray(latent), np.asarray(logits)
        with torch.no_grad():
            out = model(torch.from_numpy(x), return_latent=True,
                        train=train)
        assert out["latent"].shape == (3, 16, SEQ)
        assert_close(out["latent"].numpy(), latent, atol, ("latent", train))
        assert_close(out["seg_logits"].numpy(), logits, atol,
                     ("seg_logits", train))
    # the train-mode forward moved the running statistics alike
    want = jax_trees_to_state_dict(params, new_stats, keys)
    got = model.state_dict()
    for key, value in want.items():
        if key.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got[key].numpy(), value.numpy(),
                                       atol=STATS_ATOL, err_msg=key)


def test_eval_build_carries_the_projection():
    """An eval build holds the projection too, so a ReCo training
    checkpoint loads into it strictly; the latent is the last feature."""
    cfg = reco_model_config("resnet18")
    train_keys = build_model_from_config(cfg, train=True).state_dict().keys()
    assert build_model_from_config(cfg).state_dict().keys() == train_keys
    plain = build_model_from_config(dict(cfg, use_latent_projection=False))
    with torch.no_grad():
        out = plain(torch.zeros(2, 1, SEQ), return_latent=True)
    assert out["latent"].shape == (2, 64, SEQ)


# ---------------------------------------------------------------------------
# The loss
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("logits", [
    [0.3, -1.0, 2.0, 0.0],
    [-np.inf, 1.0, -np.inf, 0.5],
    [-np.inf, -np.inf, 4.0, -np.inf],
])
def test_categorical_is_argmax_of_gumbels(logits):
    """The draw mirror: ``jax.random.categorical(k, l, shape=(Q, Nn))`` is
    ``argmax(jax.random.gumbel(k, (Q, Nn, C)) + l)`` in the installed JAX."""
    key = jax.random.key(7)
    l = jnp.asarray(logits, jnp.float32)
    want = jax.random.categorical(key, l, shape=(Q, NN))
    got = jnp.argmax(jax.random.gumbel(key, (Q, NN, C)) + l, axis=-1)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def loss_inputs(regime, seed=0):
    """``(latent (B, D, T), prob_t, prob_s, easy, hard)`` of one regime."""
    rng = np.random.default_rng(seed)
    latent = rng.standard_normal((B, D, T)).astype(np.float32)
    logits_t = rng.standard_normal((B, C, T)).astype(np.float32)
    logits_s = rng.standard_normal((B, C, T)).astype(np.float32)
    easy, hard = 0.5, 0.9
    winners = rng.integers(0, C, (B, T))
    if regime != "nothing_confident":
        for bi in range(B):
            logits_t[bi, winners[bi], np.arange(T)] += 10.0
    else:
        easy = 0.99
    if regime == "single_class":
        logits_t[:, 2] += 100.0
    if regime == "one_class_not_hard":
        # the student is sure of class 1 wherever the teacher says 1
        logits_s[:, 1] = np.where(winners == 1, 20.0, logits_s[:, 1])
    if regime == "low_hard_threshold":
        hard = 0.3
    softmax = lambda z: np.array(jax.nn.softmax(jnp.asarray(z), axis=1))
    return latent, softmax(logits_t), softmax(logits_s), easy, hard


def jax_draws(key):
    """The uniforms and gumbels ``compute_reco_loss`` draws from ``key``,
    as the port's :class:`RecoDraws`."""
    keys = jax.random.split(key, 3 * C).reshape(C, 3)
    pool_u = jnp.stack([jax.random.uniform(keys[ci, 0], (Q * NN,))
                        for ci in range(C)])
    anchor_u = jnp.stack([jax.random.uniform(keys[ci, 1], (Q,))
                          for ci in range(C)])
    gumbel = jnp.stack([jax.random.gumbel(keys[ci, 2], (Q, NN, C))
                        for ci in range(C)])
    return reco_loss.RecoDraws(*(torch.from_numpy(np.array(a))
                                 for a in (pool_u, anchor_u, gumbel)))


@jax.jit
def jax_loss_and_grad(key, latent, prob_t, prob_s, easy, hard):
    """``compute_reco_loss`` and its gradient in the latent."""
    return jax.value_and_grad(
        lambda lat: jax_reco_loss.compute_reco_loss(
            key, lat, prob_t, prob_s, easy_threshold=easy,
            hard_threshold=hard, temp=TEMP, num_queries=Q,
            num_negatives=NN))(latent)


def jax_indices(key, latent, prob_t, prob_s, easy, hard):
    """The indices ``compute_reco_loss`` samples from ``key``, through the
    JAX package's own sampler: ``(pools (C, Q·Nn), anchor_idx (C, Q),
    samp_class (C, Q, Nn), neg_idx (C, Q, Nn))``."""
    return tuple(torch.from_numpy(np.asarray(a).astype(np.int64))
                 for a in _jax_indices(key, jnp.asarray(latent),
                                       jnp.asarray(prob_t),
                                       jnp.asarray(prob_s), easy, hard))


@jax.jit
def _jax_indices(key, latent, prob_t, prob_s, easy, hard):
    p = B * T
    lat = jnp.asarray(latent).transpose(0, 2, 1).reshape(p, D)
    pt = jnp.asarray(prob_t).transpose(0, 2, 1).reshape(p, C)
    ps = jnp.asarray(prob_s).transpose(0, 2, 1).reshape(p, C)
    conf, pseudo = jnp.max(pt, axis=1), jnp.argmax(pt, axis=1)
    valid = jnp.stack([(conf >= easy) & (pseudo == ci) for ci in range(C)])
    hard_m = valid & (ps.T < hard)
    vf = valid.astype(jnp.float32)
    counts = vf.sum(axis=1)
    protos = (vf[:, :, None] * lat[None]).sum(axis=1) / jnp.maximum(
        counts, 1.0)[:, None]
    neg_logits = jax_reco_loss._cosine(protos[:, None], protos[None]) / TEMP
    neg_logits = jnp.where((counts > 0)[None, :], neg_logits, -jnp.inf)
    neg_logits = jnp.where(jnp.eye(C, dtype=bool), -jnp.inf, neg_logits)
    keys = jax.random.split(key, 3 * C).reshape(C, 3)
    pools = jnp.stack([jax_reco_loss._masked_sample(keys[ci, 0], valid[ci],
                                                    Q * NN)
                       for ci in range(C)])
    anchor = jnp.stack([jax_reco_loss._masked_sample(keys[ci, 1],
                                                     hard_m[ci], Q)
                        for ci in range(C)])
    samp = jnp.stack([jax.random.categorical(keys[ci, 2], neg_logits[ci],
                                             shape=(Q, NN))
                      for ci in range(C)])
    slot = jnp.arange(Q * NN).reshape(Q, NN)
    neg = jnp.stack([pools[samp[ci], slot] for ci in range(C)])
    return pools, anchor, samp, neg


def port_regions(latent, prob_t, prob_s, easy, hard):
    flat = lambda a: torch.from_numpy(a).transpose(1, 2).reshape(
        B * T, a.shape[1])
    lat = flat(latent).requires_grad_()
    return lat, reco_loss.reco_regions(lat.detach(), flat(prob_t),
                                       flat(prob_s), easy, hard)


REGIMES = ["ordinary", "single_class", "nothing_confident",
           "one_class_not_hard", "low_hard_threshold"]


@pytest.mark.parametrize("regime", REGIMES)
def test_loss_core_matches_jax(regime):
    latent, prob_t, prob_s, easy, hard = loss_inputs(regime)
    key = jax.random.key(21)
    want, want_grad = jax_loss_and_grad(key, jnp.asarray(latent),
                                        jnp.asarray(prob_t),
                                        jnp.asarray(prob_s), easy, hard)
    want, want_grad = float(want), np.asarray(want_grad)

    _, anchor_idx, _, neg_idx = jax_indices(key, latent, prob_t, prob_s,
                                            easy, hard)
    lat, regions = port_regions(latent, prob_t, prob_s, easy, hard)
    got = reco_loss.reco_loss_core(lat, regions.protos, anchor_idx,
                                   neg_idx, regions.active,
                                   regions.valid_seg, TEMP)
    got.backward()
    grad = lat.grad.view(B, T, D).transpose(1, 2).numpy()

    expect_zero = regime in ("single_class", "nothing_confident")
    assert (want == 0.0) == expect_zero, want
    if regime == "one_class_not_hard":
        assert regions.class_valid[1] and not regions.active[1]
        assert int(regions.active.sum()) >= 2
    assert float(got.detach()) == pytest.approx(want, rel=1e-5, abs=0)
    scale = max(np.abs(want_grad).max(), 1e-30)
    assert np.abs(grad - want_grad).max() <= 1e-5 * scale
    # gradient through the anchors only: rows no anchor picked get none
    picked = np.zeros(B * T, bool)
    picked[anchor_idx.numpy().reshape(-1)] = True
    flat_grad = lat.grad.numpy()
    assert not np.abs(flat_grad[~picked]).any()


@pytest.mark.parametrize("regime", ["ordinary", "low_hard_threshold",
                                    "nothing_confident"])
def test_sampler_matches_jax(regime):
    latent, prob_t, prob_s, easy, hard = loss_inputs(regime, seed=1)
    key = jax.random.key(33)
    pools_j, anchor_j, samp_j, neg_j = jax_indices(key, latent, prob_t,
                                                   prob_s, easy, hard)
    draws = jax_draws(key)
    _, regions = port_regions(latent, prob_t, prob_s, easy, hard)
    anchor_idx, neg_idx = reco_loss.reco_sample(draws, regions, TEMP)
    pools = reco_loss.masked_sample(regions.valid, draws.pool_u)

    def assert_at_cdf_steps(got, want, mask, u):
        cdf = reco_loss.masked_cdf(mask)
        differ = (got != want).nonzero().tolist()
        for row, col in differ:
            step = min(int(got[row, col]), int(want[row, col]))
            assert abs(float(cdf[row, step]) - float(u[row, col])) \
                <= CDF_ROUNDING, (row, col)
        return len(differ)

    assert_at_cdf_steps(pools, pools_j, regions.valid, draws.pool_u)
    assert_at_cdf_steps(anchor_idx, anchor_j, regions.hard, draws.anchor_u)
    # negatives: the JAX package's classes, through the port's pools
    slot = torch.arange(Q * NN).view(Q, NN)
    want_neg = torch.stack([pools.view(-1)[samp_j[ci] * (Q * NN) + slot]
                            for ci in range(C)])
    np.testing.assert_array_equal(neg_idx.numpy(), want_neg.numpy())
    assert (regions.valid.sum() > 0) == (regime != "nothing_confident")


def test_compute_reco_loss_is_static_and_fp32():
    """The whole call under bf16 autocast from bf16 inputs: an fp32 loss,
    the same value as from fp32 inputs rounded alike, and a gradient."""
    latent, prob_t, prob_s, easy, hard = loss_inputs("ordinary")
    gen = torch.Generator().manual_seed(0)
    draws = reco_loss.reco_draws(gen, C, Q, NN, torch.device("cpu"))
    assert draws.gumbel.shape == (C, Q, NN, C)
    assert torch.isfinite(draws.gumbel).all()
    lat = torch.from_numpy(latent).bfloat16().requires_grad_()
    with torch.autocast("cpu", dtype=torch.bfloat16):
        loss = reco_loss.compute_reco_loss(
            draws, lat, torch.from_numpy(prob_t), torch.from_numpy(prob_s),
            easy, hard, TEMP)
    assert loss.dtype == torch.float32 and loss > 0
    ref = reco_loss.compute_reco_loss(
        draws, lat.detach().float(), torch.from_numpy(prob_t),
        torch.from_numpy(prob_s), easy, hard, TEMP)
    assert float(loss.detach()) == float(ref)
    loss.backward()
    assert lat.grad is not None and lat.grad.abs().sum() > 0


# ---------------------------------------------------------------------------
# Lockstep
# ---------------------------------------------------------------------------


def test_reco_lockstep_matches_jax(monkeypatch):
    cfg = reco_model_config("resnet18")
    # the perturbed teacher's confidences on the lockstep's batches lie in
    # 0.48-1.0 (median 0.9997); every pixel is easy (the reference's typo
    # key), the student's probabilities pick the hard anchors
    cfg["train"].update(conf_thresh=0.7, eash_conf_thresh=0.2,
                        hard_conf_thresh=0.99, contr_temp=TEMP,
                        contr_num_queries=Q, contr_num_negatives=NN)
    calls = []

    def draws_of_the_jax_package(gen, num_classes, num_queries,
                                 num_negatives, device):
        assert (num_classes, num_queries, num_negatives) == (C, Q, NN)
        step = len(calls)
        calls.append(step)
        return jax_draws(jax.random.fold_in(
            jax.random.key(cfg["seed"] + 7), step))

    monkeypatch.setattr(reco_loss, "reco_draws", draws_of_the_jax_package)
    theirs, ours, jax_sds, port_sds = lockstep_states(
        "xla", "reco", jax_reco, reco, seed=8, cfg=copy.deepcopy(cfg))
    assert calls == [0, 1, 2]
    for step, (a, b) in enumerate(zip(ours, theirs)):
        assert a.keys() == b.keys() == {"loss_total", "loss_x", "loss_u_s",
                                        "contr_loss", "mask_ratio", "loss"}
        assert b["contr_loss"] > 0, step
        assert 0 < b["mask_ratio"] < 1, step
        for k in a:
            assert a[k] == pytest.approx(b[k], rel=1e-5), (step, k)
    assert set(port_sds) == {"model", "ema"}
    for role in ("model", "ema"):
        assert_states_agree(jax_sds[role], port_sds[role])
    assert "latent_projection.2.running_var" in jax_sds["ema"]


# ---------------------------------------------------------------------------
# Under the seq axis: the loss's inputs gathered, its gradient counted once
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("gather", ["for_loss", "plain_time"])
def test_reco_gradient_counted_once_under_seq(gather):
    """Two seq ranks (threads) each hold a half of the time axis of the
    loss's inputs, gather them whole and compute the same loss from the
    JAX package's draws: the value is one process's (and the JAX
    package's within 1e-5). Through ``reco.gather_for_loss`` (the step's
    gather) the ranks' latent gradients, joined as the optimizer's sum over
    seq joins them, are one process's; a plain time gather, whose backward
    sums the ranks' (equal) gradients, would count the term's gradient
    twice, s times over s ranks."""
    from semi_seg_ecg_tpu_torch.parallel import seq_shard

    latent, prob_t, prob_s, easy, hard = loss_inputs("ordinary")
    key = jax.random.key(5)
    draws = jax_draws(key)
    want_jax, _ = jax_loss_and_grad(key, latent, prob_t, prob_s, easy, hard)
    lat = torch.from_numpy(latent).requires_grad_()
    want = reco_loss.compute_reco_loss(
        draws, lat, torch.from_numpy(prob_t), torch.from_numpy(prob_s), easy,
        hard, TEMP)
    want.backward()
    assert float(want) == pytest.approx(float(want_jax), rel=1e-5)

    def rank(comm):
        a, b = seq_shard.block(T, 2, comm.rank)
        block = lambda x: torch.from_numpy(x[..., a:b].copy())  # noqa: E731
        lb = block(latent).requires_grad_()
        with seq_shard.using(seq_shard.TimeShard(T, comm)):
            whole = [reco.gather_for_loss(t) if gather == "for_loss"
                     else seq_shard.gather_whole_time(t)
                     for t in (lb, block(prob_t), block(prob_s))]
            loss = reco_loss.compute_reco_loss(draws, *whole, easy, hard,
                                               TEMP)
            loss.backward()
        return loss.detach(), lb.grad

    res = seq_shard.run_threads(2, rank)
    for loss, _ in res:
        assert torch.equal(loss, want.detach())
    grad = torch.cat([g for _, g in res], -1)
    factor = 1 if gather == "for_loss" else 2
    assert lat.grad.abs().max() > 0
    torch.testing.assert_close(grad, factor * lat.grad, rtol=1e-6, atol=1e-7)
