"""The port's CUDA kernels on the card, against their plain versions.

These tests need a CUDA device, nvcc and nothing of JAX; they skip where
there is no card. On a machine with one, run them without the JAX-side
conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances. Flash forward: fp32 atol 1e-5 (the kernel's fp32 FMA sums
against the plain version's fp32 matmuls, another order); bf16 ``out``
within one bf16 ulp (rtol 2^-7, atol 1e-5: both round the same fp32 value
once); 1e-4 on ``lse``. Flash backward: each gradient is a sum over N
products, so fp32 within atol 1e-4 + rtol 1e-4; bf16 within one bf16 ulp
on top (rtol 2^-7). Gather: bit for bit (the kernel's arithmetic is the
plain version's, rounded at the same places).
"""

import numpy as np
import pytest
import torch

from semi_seg_ecg_tpu_torch.algorithms.common import full_fp32
from semi_seg_ecg_tpu_torch.models import build_model_from_config
from semi_seg_ecg_tpu_torch.ops import flash_attention as fa
from semi_seg_ecg_tpu_torch.ops import gather1d
from semi_seg_ecg_tpu_torch.ops.attention import dense_attention


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
    out, lse = fa.flash_attention_forward(q, k, v, 0.1)
    with pytest.raises(ValueError, match="lse"):
        fa.flash_attention_backward(q, k, v, out, lse[..., :8], out, 0.1)
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


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype", [
    ((32, 3, 101, 64), torch.float32),
    ((32, 3, 101, 64), torch.bfloat16),
    ((2, 3, 1000, 64), torch.float32),
    ((2, 4, 257, 100), torch.bfloat16),
    ((1, 2, 1, 8), torch.float32),
    ((3, 1, 130, 128), torch.float32),
])
def test_backward_kernel_matches_plain(cuda, shape, dtype):
    q, k, v = qkv(shape, dtype)
    dout = qkv(shape, dtype, seed=1)[0]
    scale = shape[-1] ** -0.5
    out, lse = fa.flash_attention_forward(q, k, v, scale)
    before = fa.BWD_LAUNCHES
    grads = fa.flash_attention_backward(q, k, v, out, lse, dout, scale)
    torch.cuda.synchronize()
    assert fa.BWD_LAUNCHES == before + 1
    ref = fa.flash_attention_backward_plain(q, k, v, out, lse, dout, scale)
    rtol = 1e-4 if dtype == torch.float32 else 2.0 ** -7
    for name, got, want in zip("qkv", grads, ref):
        assert got.dtype == dtype, name
        torch.testing.assert_close(got.float(), want.float(), atol=1e-4,
                                   rtol=rtol, msg=f"d{name}")


@pytest.mark.cuda
def test_flash_gradients_match_dense_autograd(cuda):
    q, k, v = (t.requires_grad_() for t in qkv((4, 3, 101, 64),
                                               torch.float32))
    dout = qkv((4, 3, 101, 64), torch.float32, seed=1)[0]
    scale = 0.125
    before = (fa.LAUNCHES, fa.BWD_LAUNCHES)
    fa.flash_attention(q, k, v, scale).backward(dout)
    assert (fa.LAUNCHES, fa.BWD_LAUNCHES) == (before[0] + 1, before[1] + 1)
    got = [t.grad for t in (q, k, v)]
    for t in (q, k, v):
        t.grad = None
    dense_attention(q, k, v, scale).backward(dout)
    for name, a, b in zip("qkv", got, (q.grad, k.grad, v.grad)):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4,
                                   msg=f"d{name}")


def monotone_pos(rng, b, t, max_slope, j=None):
    """Per-sample monotone positions in [0, T-1] with bounded slope."""
    deltas = rng.uniform(0.0, max_slope, (b, j or t))
    pos = np.cumsum(deltas, axis=1) - rng.uniform(0, 100, (b, 1))
    return np.clip(pos, 0, t - 1).astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("b,c,t,j,slope,integral", [
    (16, 1, 2500, 2500, 2.0, False),   # resize-crop of the signal
    (16, 1, 5000, 2500, 1.0, True),    # the partial-sine roll
    (256, 12, 5000, 5000, 2.0, False),
    (3, 2, 7, 9, 1.5, False),
])
def test_gather_kernel_matches_plain(cuda, b, c, t, j, slope, integral):
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((b, c, t)).astype(
        np.float32)).cuda()
    pos = monotone_pos(rng, b, t, slope, j)
    if integral:
        pos = np.floor(pos)
    pos[:, -1] = t - 1  # the last position reads in bounds
    pos = torch.from_numpy(pos).cuda()
    before = gather1d.LAUNCHES
    out = gather1d.monotonic_gather(x, pos, max_slope=slope)
    torch.cuda.synchronize()
    assert gather1d.LAUNCHES == before + 1
    torch.testing.assert_close(out, gather1d.monotonic_gather_plain(x, pos),
                               atol=0, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.int64, torch.int32])
def test_gather_int_kernel_matches_plain(cuda, dtype):
    rng = np.random.default_rng(1)
    y = torch.from_numpy(rng.integers(0, 4, (16, 2500))).to("cuda", dtype)
    idx = np.clip(np.round(monotone_pos(rng, 16, 2500, 2.0)), 0, 2499)
    idx = torch.from_numpy(idx.astype(np.int32)).cuda()
    before = gather1d.LAUNCHES
    out = gather1d.monotonic_gather_int(y, idx, max_slope=2.0)
    torch.cuda.synchronize()
    assert gather1d.LAUNCHES == before + 1 and out.dtype == dtype
    torch.testing.assert_close(out, torch.gather(y, 1, idx.long()),
                               atol=0, rtol=0)


@pytest.mark.cuda
def test_fixmatch_augmentation_on_the_card_matches_the_cpu(cuda):
    """The shipped FixMatch chain, one set of draws from a CPU generator,
    applied on the card (gather kernel) and on the CPU (plain version): the
    labels exactly, the signals within 1e-5 (sin and the standardize
    reductions of two libraries; a time grid built by multiplying with
    1 / fs instead of dividing was 6.6e-4 off here)."""
    import os

    import yaml

    from semi_seg_ecg_tpu_torch.ops import preprocess as pre

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "configs", "base", "vit_tiny",
        "fixmatch.yaml")
    with open(path) as f:
        ds = dict(yaml.safe_load(f)["dataset"], device_augment=True)
    plan = pre.plan_device_augment(ds)
    gen = torch.Generator().manual_seed(0)
    cpu = {"ecg": torch.randn(16, 1, 2500, generator=gen),
           "target": torch.randint(0, 4, (16, 2500), generator=gen),
           "ecg_u_w": torch.randn(16, 1, 2500, generator=gen)}
    draws = plan.sample(gen, cpu)
    before = gather1d.LAUNCHES
    on_card = plan.apply(draws, {k: v.cuda() for k, v in cpu.items()})
    torch.cuda.synchronize()
    assert gather1d.LAUNCHES == before + 4
    on_cpu = plan.apply(draws, cpu)
    assert torch.equal(on_card["target"].cpu(), on_cpu["target"])
    for k in ("ecg", "ecg_u_w", "ecg_u_s"):
        torch.testing.assert_close(on_card[k].cpu(), on_cpu[k], atol=1e-5,
                                   rtol=0, msg=k)
