"""The port's flash-attention forward against the JAX package's.

On the CPU the port's wrapper runs the kernel's plain version
(``flash_attention_plain``); it is held against the JAX ``_flash_forward``
with its Pallas kernel in interpret mode, out and lse, at fp32 within atol
1e-5 (two fp32 softmax formulations, sums in another order). The CUDA
kernel is held against the plain version in ``tests/test_torch_cuda.py``,
which imports nothing of JAX, so that it also runs where a CUDA card is
and the JAX package's dependencies are not.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from semi_seg_ecg_tpu.ops.attention import dense_attention as jax_dense
from semi_seg_ecg_tpu.ops.pallas.flash_attention import _flash_forward
from semi_seg_ecg_tpu_torch.ops import flash_attention as fa
from semi_seg_ecg_tpu_torch.ops.attention import dense_attention


def qkv(shape, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("n", [37, 101, 300])
@pytest.mark.parametrize("d", [32, 64])
def test_plain_forward_matches_jax_flash_forward(n, d):
    q, k, v = qkv((2, 2, n, d))
    scale = d ** -0.5
    ref_out, ref_lse = _flash_forward(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), scale, None, None,
                                      True)
    before = fa.LAUNCHES
    out, lse = fa.flash_attention_forward(torch.from_numpy(q),
                                          torch.from_numpy(k),
                                          torch.from_numpy(v), scale)
    assert fa.LAUNCHES == before  # CPU tensors never launch the kernel
    assert out.dtype == torch.float32 and lse.dtype == torch.float32
    assert tuple(lse.shape) == (2, 2, n)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), atol=1e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse), atol=1e-5)


def test_dense_attention_matches_jax():
    q, k, v = qkv((2, 3, 50, 16), seed=1)
    ref = jax_dense(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 0.25,
                    mm_dtype=jnp.float32)
    ours = dense_attention(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), 0.25)
    assert ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-6)


def test_plain_forward_bf16_keeps_dtype_and_fp32_math():
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in qkv((1, 2, 70, 32), seed=2))
    out, lse = fa.flash_attention_plain(q, k, v, 0.2)
    ref_out, ref_lse = fa.flash_attention_plain(q.float(), k.float(),
                                                v.float(), 0.2)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    torch.testing.assert_close(out, ref_out.to(torch.bfloat16))
    torch.testing.assert_close(lse, ref_lse)

