"""The port's time-axis gather against the JAX package's.

On the CPU the port's wrappers run the kernel's plain version
(``monotonic_gather_plain``, ``torch.gather`` for labels); it is held
against the JAX package's ``_xla_gather`` (bit for bit: the same formula,
operation for operation) and against the Pallas kernel in interpret mode
(within one fp32 ulp of the interpolated magnitude ``(1-w)|x0| + w|x1|``
where w != 0: its one-hot matmul sums the two products in another order;
bit for bit where w == 0). The CUDA kernel is held against the plain version in
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semi_seg_ecg_tpu.ops.pallas import gather1d as jax_gather
from semi_seg_ecg_tpu_torch.ops import gather1d
from tests.torch_dist_worker import one_thread  # noqa: F401 (autouse)


@pytest.fixture
def interpret_impl(monkeypatch):
    monkeypatch.setattr(jax_gather, "GATHER_IMPL", "interpret")


def monotone_pos(rng, b, t, max_slope):
    """Per-sample monotone positions in [0, T-1] with bounded slope."""
    deltas = rng.uniform(0.0, max_slope, (b, t))
    pos = np.cumsum(deltas, axis=1) - rng.uniform(0, 100, (b, 1))
    return np.clip(pos, 0, t - 1).astype(np.float32)


def ulps(a, ref, x, pos):
    """|a - ref| in fp32 ulps of the interpolated magnitude: a cancelling
    lerp has a small result but the rounding of its larger terms."""
    mag = gather1d.monotonic_gather_plain(torch.from_numpy(np.abs(x)),
                                          torch.from_numpy(pos)).numpy()
    return np.abs(a - ref) / np.spacing(mag)


@pytest.mark.parametrize("c,t,slope", [(1, 500, 2.0), (3, 300, 1.0),
                                       (2, 131, 2.5)])
def test_plain_lerp_matches_jax(interpret_impl, c, t, slope):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, c, t)).astype(np.float32)
    pos = monotone_pos(rng, 3, t, slope)
    before = gather1d.LAUNCHES
    ours = gather1d.monotonic_gather(torch.from_numpy(x),
                                     torch.from_numpy(pos),
                                     max_slope=slope).numpy()
    assert gather1d.LAUNCHES == before  # CPU tensors never launch
    xla = np.asarray(jax_gather._xla_gather(jnp.asarray(x),
                                            jnp.asarray(pos)))
    np.testing.assert_array_equal(ours, xla)
    pallas = np.asarray(jax_gather.monotonic_gather(
        jnp.asarray(x), jnp.asarray(pos), max_slope=slope, block_j=128))
    integral = np.broadcast_to((pos == np.floor(pos))[:, None, :], ours.shape)
    np.testing.assert_array_equal(ours[integral], pallas[integral])
    assert ulps(ours, pallas, x, pos)[~integral].max() <= 1.0


def test_slope_one_roll_is_a_bit_copy(interpret_impl):
    """The partial-noise roll: integral positions over a doubled wave read
    exact copies, on both sides."""
    rng = np.random.default_rng(1)
    t = 200
    x = rng.standard_normal((4, 1, 2 * t)).astype(np.float32)
    start = rng.integers(0, t, (4, 1))
    pos = (np.arange(t)[None, :] - start + t).astype(np.float32)
    ours = gather1d.monotonic_gather(torch.from_numpy(x),
                                     torch.from_numpy(pos)).numpy()
    pallas = np.asarray(jax_gather.monotonic_gather(
        jnp.asarray(x), jnp.asarray(pos), max_slope=1.0, block_j=128))
    want = np.take_along_axis(x, pos.astype(np.int64)[:, None, :], axis=2)
    np.testing.assert_array_equal(ours, want)
    np.testing.assert_array_equal(pallas, want)


def test_last_position_stays_in_bounds():
    """pos == T-1 has w == 0: the clamped neighbour is read and weighted 0,
    so the result is x[T-1] exactly."""
    x = torch.arange(12, dtype=torch.float32).reshape(2, 1, 6)
    pos = torch.full((2, 3), 5.0)
    out = gather1d.monotonic_gather(x, pos)
    torch.testing.assert_close(out, x[:, :, 5:].expand(2, 1, 3),
                               rtol=0, atol=0)
    xla = np.asarray(jax_gather._xla_gather(jnp.asarray(x.numpy()),
                                            jnp.asarray(pos.numpy())))
    np.testing.assert_array_equal(out.numpy(), xla)


def test_int_variant_is_exact(interpret_impl):
    rng = np.random.default_rng(2)
    t = 257
    y = rng.integers(0, 4, (3, t)).astype(np.int32)
    idx = np.clip(np.round(monotone_pos(rng, 3, t, 2.0)), 0,
                  t - 1).astype(np.int32)
    ours = gather1d.monotonic_gather_int(torch.from_numpy(y).long(),
                                         torch.from_numpy(idx))
    assert ours.dtype == torch.int64
    theirs = np.asarray(jax_gather.monotonic_gather_int(
        jnp.asarray(y), jnp.asarray(idx), max_slope=2.0, block_j=128))
    np.testing.assert_array_equal(ours.numpy(), theirs)
    np.testing.assert_array_equal(ours.numpy(),
                                  np.take_along_axis(y, idx, axis=1))


def test_shapes_are_checked():
    with pytest.raises(ValueError, match="monotonic_gather"):
        gather1d.monotonic_gather(torch.zeros(2, 5), torch.zeros(2, 5))
    with pytest.raises(ValueError, match="monotonic_gather_int"):
        gather1d.monotonic_gather_int(torch.zeros(2, 5, dtype=torch.long),
                                      torch.zeros(3, 5, dtype=torch.int32))
    x, pos = torch.zeros(2, 1, 5), torch.zeros(2, 5)
    y, idx = torch.zeros(3, 5, dtype=torch.long), torch.zeros(
        3, 5, dtype=torch.int32)
    with pytest.raises(ValueError, match="different batch sizes"):
        gather1d.monotonic_gather_pair(x, pos, y, idx)
    with pytest.raises(ValueError, match="monotonic_gather_pair"):
        gather1d.monotonic_gather_pair(x, pos, y[:2, :, None], idx[:2])


def resize_crop_maps(t, ratio, u_start):
    """The resize-crop's signal positions and label indices for one scale
    ``ratio`` per sample, as ``random_resize_crop`` computes them: clipped
    into [0, T-1], so a shrink has flat runs at 0 and at T-1."""
    s = np.floor(t * ratio).astype(np.int32)
    canvas = np.maximum(s, t)
    left_pad = np.maximum((t - s) // 2, 0)
    start = np.minimum((u_start * (canvas - t + 1)).astype(np.int32),
                       canvas - t)
    coord = (start[:, None] + np.arange(t)[None, :]
             - left_pad[:, None]).astype(np.float32)
    pos = np.clip(coord * (np.float32(t) / s[:, None].astype(np.float32)),
                  0, t - 1).astype(np.float32)
    denom = np.maximum(s - 1, 1).astype(np.float32)[:, None]
    idx = np.clip(np.round(coord * (np.float32(t - 1) / denom)), 0,
                  t - 1).astype(np.int32)
    return pos, idx


@pytest.mark.parametrize("ratio", [0.5, 1.0, 2.0])
@pytest.mark.parametrize("label_dtype", [np.int32, np.int64])
def test_pair_equals_the_two_gathers(interpret_impl, ratio, label_dtype):
    """The resize-crop's pair entry on CPU tensors: the two plain calls,
    and the JAX package's gathers (interpret mode), on the maps of scales
    0.5 (flat runs at both ends), 1 and 2."""
    rng = np.random.default_rng(4)
    b, c, t = 3, 2, 300
    x = rng.standard_normal((b, c, t)).astype(np.float32)
    y = rng.integers(0, 4, (b, t)).astype(label_dtype)
    pos, idx = resize_crop_maps(t, np.full(b, ratio, np.float32),
                                np.array([0.0, 0.5, 0.999], np.float32))
    if ratio == 0.5:
        assert (pos[:, 0] == 0).all() and (pos[:, -1] == t - 1).all()
    before = gather1d.LAUNCHES
    x_out, y_out = gather1d.monotonic_gather_pair(
        torch.from_numpy(x), torch.from_numpy(pos), torch.from_numpy(y),
        torch.from_numpy(idx))
    assert gather1d.LAUNCHES == before  # CPU tensors never launch
    assert y_out.dtype == torch.from_numpy(y).dtype
    np.testing.assert_array_equal(x_out.numpy(), gather1d.monotonic_gather(
        torch.from_numpy(x), torch.from_numpy(pos)).numpy())
    np.testing.assert_array_equal(y_out.numpy(), gather1d.monotonic_gather_int(
        torch.from_numpy(y), torch.from_numpy(idx)).numpy())
    np.testing.assert_array_equal(x_out.numpy(), np.asarray(
        jax_gather._xla_gather(jnp.asarray(x), jnp.asarray(pos))))
    slope = 1.0 / ratio
    pallas = np.asarray(jax_gather.monotonic_gather(
        jnp.asarray(x), jnp.asarray(pos), max_slope=slope, block_j=128))
    integral = np.broadcast_to((pos == np.floor(pos))[:, None, :],
                               x_out.shape)
    np.testing.assert_array_equal(x_out.numpy()[integral], pallas[integral])
    # (scale 0.5 reads whole samples only)
    assert np.max(ulps(x_out.numpy(), pallas, x, pos)[~integral],
                  initial=0.0) <= 1.0
    np.testing.assert_array_equal(y_out.numpy(), np.asarray(
        jax_gather.monotonic_gather_int(jnp.asarray(y), jnp.asarray(idx),
                                        max_slope=slope, block_j=128)))
