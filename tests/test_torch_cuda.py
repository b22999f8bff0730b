"""The port's CUDA kernels on the card, against their plain versions.

These tests need a CUDA device, nvcc and nothing of JAX; they skip where
there is no card. On a machine with one, run them without the JAX-side
conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances: fp32 atol 1e-5 (the kernel's fp32 FMA sums against the plain
version's fp32 matmuls, another order); bf16 ``out`` within one bf16 ulp
(rtol 2^-7, atol 1e-5: both round the same fp32 value once); 1e-4 on
``lse``.
"""

import numpy as np
import pytest
import torch

from semi_seg_ecg_tpu_torch.algorithms.common import full_fp32
from semi_seg_ecg_tpu_torch.models import build_model_from_config
from semi_seg_ecg_tpu_torch.ops import flash_attention as fa


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    with full_fp32():  # the plain versions' fp32 matmuls without TF32
        yield torch.device("cuda")


def qkv(shape, dtype, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            .to("cuda", dtype) for _ in range(3)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype", [
    ((16, 3, 101, 64), torch.float32),
    ((16, 3, 101, 64), torch.bfloat16),
    ((2, 3, 1000, 64), torch.float32),
    ((2, 4, 257, 100), torch.bfloat16),
    ((1, 2, 1, 8), torch.float32),
    ((3, 1, 130, 128), torch.float32),
])
def test_kernel_matches_plain(cuda, shape, dtype):
    q, k, v = qkv(shape, dtype)
    scale = shape[-1] ** -0.5
    before = fa.LAUNCHES
    out, lse = fa.flash_attention_forward(q, k, v, scale)
    torch.cuda.synchronize()
    assert fa.LAUNCHES == before + 1
    assert out.dtype == dtype and lse.dtype == torch.float32
    ref_out, ref_lse = fa.flash_attention_plain(q, k, v, scale)
    rtol = 0.0 if dtype == torch.float32 else 2.0 ** -7
    torch.testing.assert_close(out.float(), ref_out.float(), atol=1e-5,
                               rtol=rtol)
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=0)


@pytest.mark.cuda
def test_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    q, k, v = qkv((2, 2, 16, 32), torch.float32)
    with pytest.raises(NotImplementedError, match="backward not yet ported"):
        fa.flash_attention_forward(q.clone().requires_grad_(), k, v, 0.1)
    with pytest.raises(ValueError, match="all be CUDA"):
        fa.flash_attention_forward(q, k.cpu(), v, 0.1)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa.flash_attention_forward(q.half(), k.half(), v.half(), 0.1)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention_forward(q.transpose(2, 3), k.transpose(2, 3),
                                   v.transpose(2, 3), 0.1)
    big = qkv((1, 1, 8, 160), torch.float32)
    with pytest.raises(ValueError, match="range"):
        fa.flash_attention_forward(*big, 0.1)


@pytest.mark.cuda
def test_vit_flash_matches_dense_on_the_card(cuda):
    backbone = {"num_leads": 1, "seq_len": 500, "patch_size": 25,
                "width": 64, "depth": 2, "heads": 2, "dim_head": 32,
                "mlp_dim": 128, "out_indices": [1]}
    head = {"FCNHead": {"in_channels": 64, "in_index": 0, "channels": 16,
                        "num_convs": 1, "concat_input": False,
                        "num_classes": 4}}
    torch.manual_seed(0)
    flash = build_model_from_config({"backbone": {"vit_tiny": dict(
        backbone, attention_impl="flash")}, "decode_head": head})
    dense = build_model_from_config({"backbone": {"vit_tiny": dict(
        backbone, attention_impl="xla")}, "decode_head": head})
    dense.load_state_dict(flash.state_dict())
    x = torch.randn(4, 1, 500, device=cuda)
    before = fa.LAUNCHES
    with torch.inference_mode():
        a = flash.to(cuda).eval()(x)["seg_logits"]
        b = dense.to(cuda).eval()(x)["seg_logits"]
    assert fa.LAUNCHES == before + 2  # one per block
    torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)
