"""The port's CUDA kernels on the card, against their plain versions.

These tests need a CUDA device, nvcc and nothing of JAX; they skip where
there is no card. On a machine with one, run them without the JAX-side
conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances, element by element, from ``forward_tolerance`` and
``backward_tolerance`` of ``ops/flash_attention.py``, as in chip_smoke.py.
Flash forward: fp32 atol 1e-5 (the kernel's 3xTF32 tensor-core products,
within a few fp32 roundings of an fp32 product, summed in another order
than the plain version's fp32 matmuls); 1e-4 on ``lse``. Flash backward:
each gradient is a sum over N products, so fp32 within atol 1e-4 + rtol
1e-4. bf16, both directions: within the error bound of
``forward_error_bound`` / ``backward_error_bound`` (the tensor-core kernels
round P and dS to bf16 as operands; the bound is that rounding, doubled,
plus one bf16 ulp of the result). Layouts: a strided
call equals the contiguous one bit for bit, in both dtypes (the kernels
read the same values into the same tiles). Gather: bit for bit (the
kernel's arithmetic is the plain version's, rounded at the same
places). int8 serving (``ops/quant.py``): the card's codes and int32
accumulators equal the CPU's (true divisions, ``torch._int_mm`` exact on
both), the dequantized outputs within 1e-6 relative. A serving artifact
exported and loaded on the card: within 1e-5 of ``ServingFn`` (the same
kernels, traced); a ``("cuda", "cpu")`` artifact's CUDA program equal to
the one-platform artifact's, its CPU program within 1e-5 of the CPU's
``ServingFn``. Both flash operators pass opcheck's default checks, and a
flash block compiled with ``aot_eager`` equals eager. An async checkpoint
of card tensors holds them as they were when it was queued. Remat: a step with it equals one without bit for bit,
with one more flash forward per block. Gradient accumulation: a window of
two micro-steps through the kernels against the dense path, as phase 4 of
chip_smoke.py holds three steps. ``train.scan_steps``: replays of the
captured step equal eager steps with the same capturable optimizers bit
for bit under deterministic algorithms, for every algorithm and option,
each replay launching the step's kernels (read from the graph's kernel
nodes); a captured optimizer's state resumes eagerly and the other way
round. With ``train.accum_iter`` > 1 the replays of the accumulating and
the updating graph equal the eager micro-steps with the capturable
optimizers bit for bit, each graph launching a step's kernels; on two
cards two NCCL ranks replay their captured steps (the gradient
all-reduce inside the graph) as the eager ranks step, within the data
parallel test's bounds, the ranks equal. Under ``debug.nan_checks`` a
captured step is two graphs split at its gradients' NaN flags, equal to
the unchecked captured run bit for bit on clean batches; a NaN in a
batch raises from the step's eager rerun with nothing updated.
"""

import copy

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


def chunked_qkv(shape, dtype, seed=0):
    """q, k, v as the ViT hands them over: the transposed chunks of one
    (B, N, 3·H·D) projection output."""
    b, h, n, d = shape
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((b, n, 3 * h * d)).astype(
        np.float32)).to("cuda", dtype)
    return [t.reshape(b, n, h, d).transpose(1, 2) for t in x.chunk(3, -1)]


def assert_within(got, want, tol, msg=""):
    excess = ((got.float() - want.float()).abs() - tol).max().item()
    assert excess <= 0, f"{msg}: {excess} past the error bound"


def check_forward(q, k, v, scale):
    out, lse = fa.flash_attention_forward(q, k, v, scale)
    torch.cuda.synchronize()
    assert out.dtype == q.dtype and lse.dtype == torch.float32
    ref_out, ref_lse = fa.flash_attention_plain(q, k, v, scale)
    assert_within(out, ref_out, fa.forward_tolerance(q, k, v, scale,
                                                     ref_out), "out")
    torch.testing.assert_close(lse, ref_lse, atol=fa.LSE_ATOL, rtol=0)
    return out, lse


def check_backward(q, k, v, dout, scale):
    out, lse = fa.flash_attention_forward(q, k, v, scale)
    grads = fa.flash_attention_backward(q, k, v, out, lse, dout, scale)
    torch.cuda.synchronize()
    ref = fa.flash_attention_backward_plain(q, k, v, out, lse, dout, scale)
    tols = fa.backward_tolerance(q, k, v, out, lse, dout, scale, ref)
    for name, got, want, tol in zip("qkv", grads, ref, tols):
        assert got.dtype == q.dtype, name
        assert_within(got, want, tol, f"d{name}")
    return grads


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype", [
    ((16, 3, 101, 64), torch.float32),
    ((16, 3, 101, 64), torch.bfloat16),
    ((2, 3, 1000, 64), torch.float32),
    ((2, 4, 257, 100), torch.bfloat16),
    ((1, 2, 1, 8), torch.float32),
    ((3, 1, 130, 128), torch.float32),
    ((2, 4, 257, 100), torch.float32),
    # long-record serving: a batch of 64 windows, a step of 8 streams
    ((64, 3, 101, 64), torch.float32),
    ((64, 3, 101, 64), torch.bfloat16),
    ((8, 3, 101, 64), torch.float32),
    # the 3xTF32 forward's error margin at long N (the fp32 path that
    # attention_impl: auto takes from N = 512)
    ((2, 3, 2048, 64), torch.float32),
    ((1, 3, 4096, 64), torch.float32),
    # one of 3 model ranks' heads (parallel.model_parallel: 3)
    ((16, 1, 101, 64), torch.float32),
    ((16, 1, 101, 64), torch.bfloat16),
])
def test_kernel_matches_plain(cuda, shape, dtype):
    q, k, v = qkv(shape, dtype)
    before = fa.LAUNCHES
    check_forward(q, k, v, shape[-1] ** -0.5)
    assert fa.LAUNCHES == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 101, 130, 1000])
@pytest.mark.parametrize("d", [8, 64, 100, 128])
def test_bf16_kernels_within_the_error_bound(cuda, n, d):
    shape = (2, 3, n, d)
    q, k, v = qkv(shape, torch.bfloat16, seed=n + d)
    dout = qkv(shape, torch.bfloat16, seed=n + d + 1)[0]
    check_forward(q, k, v, d ** -0.5)
    check_backward(q, k, v, dout, d ** -0.5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_strided_calls_equal_the_contiguous_ones(cuda, dtype):
    shape = (4, 3, 101, 64)
    q, k, v = chunked_qkv(shape, dtype)
    assert not q.is_contiguous()
    b, h, n, d = shape
    dout = qkv((b, n, h, d), dtype, seed=1)[0].transpose(1, 2)
    scale = d ** -0.5
    out, lse = check_forward(q, k, v, scale)
    grads = check_backward(q, k, v, dout, scale)
    assert out.transpose(1, 2).is_contiguous()  # (B, N, H, D) memory
    assert all(g.transpose(1, 2).is_contiguous() for g in grads)
    cq, ck, cv, cdo = (t.contiguous() for t in (q, k, v, dout))
    c_out, c_lse = fa.flash_attention_forward(cq, ck, cv, scale)
    assert torch.equal(out, c_out) and torch.equal(lse, c_lse)
    c_grads = fa.flash_attention_backward(cq, ck, cv, c_out, c_lse, cdo,
                                          scale)
    for name, a, c in zip("qkv", grads, c_grads):
        assert torch.equal(a, c), f"d{name}"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_one_head_a_rank_as_the_vit_hands_it_over(cuda, dtype):
    """A model rank's single head at model_parallel 3: q, k, v the
    transposed chunks of its (B, N, 3·D) projection slice, the forward and
    backward kernels against their plain versions."""
    shape = (32, 1, 101, 64)
    q, k, v = chunked_qkv(shape, dtype)
    dout = qkv(shape, dtype, seed=1)[0]
    before = fa.LAUNCHES, fa.BWD_LAUNCHES
    check_forward(q, k, v, shape[-1] ** -0.5)
    check_backward(q, k, v, dout, shape[-1] ** -0.5)
    assert (fa.LAUNCHES, fa.BWD_LAUNCHES) == (before[0] + 2, before[1] + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_is_deterministic(cuda, dtype):
    q, k, v = qkv((8, 3, 300, 64), dtype)
    dout = qkv((8, 3, 300, 64), dtype, seed=1)[0]
    out, lse = fa.flash_attention_forward(q, k, v, 0.125)
    first = fa.flash_attention_backward(q, k, v, out, lse, dout, 0.125)
    second = fa.flash_attention_backward(q, k, v, out, lse, dout, 0.125)
    for name, a, b in zip("qkv", first, second):
        assert torch.equal(a, b), f"d{name}"


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
    with pytest.raises(ValueError, match="unit stride along D"):
        fa.flash_attention_forward(q.transpose(2, 3), k.transpose(2, 3),
                                   v.transpose(2, 3), 0.1)
    # bf16 rows of 65 elements (130 bytes), and a base 2 bytes off
    wide = qkv((2, 2, 16, 65), torch.bfloat16)
    with pytest.raises(ValueError, match="misaligned"):
        fa.flash_attention_forward(*(t[..., :64] for t in wide), 0.1)
    flat = torch.zeros(2 * 2 * 16 * 64 + 1, dtype=torch.bfloat16,
                       device="cuda")
    shifted = flat[1:].view(2, 2, 16, 64)
    with pytest.raises(ValueError, match="misaligned"):
        fa.flash_attention_forward(shifted, shifted, shifted, 0.1)
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
    ((2, 4, 257, 100), torch.float32),
    # one of 3 model ranks' heads (parallel.model_parallel: 3)
    ((16, 1, 101, 64), torch.float32),
    ((16, 1, 101, 64), torch.bfloat16),
])
def test_backward_kernel_matches_plain(cuda, shape, dtype):
    q, k, v = qkv(shape, dtype)
    dout = qkv(shape, dtype, seed=1)[0]
    before = fa.BWD_LAUNCHES
    check_backward(q, k, v, dout, shape[-1] ** -0.5)
    assert fa.BWD_LAUNCHES == before + 1


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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_autograd_output_gradient_of_any_layout(cuda, dtype):
    """``.sum().backward()`` hands the backward an expanded ``dout`` of
    stride 0, which the kernels do not take: the autograd Function copies
    it, and the gradients are the kernels' on the dense ``dout``."""
    q, k, v = (t.requires_grad_() for t in qkv((2, 3, 101, 64), dtype))
    before = (fa.LAUNCHES, fa.BWD_LAUNCHES)
    fa.flash_attention(q, k, v, 0.125).sum().backward()
    assert (fa.LAUNCHES, fa.BWD_LAUNCHES) == (before[0] + 1, before[1] + 1)
    out, lse = fa.flash_attention_forward(q.detach(), k.detach(),
                                          v.detach(), 0.125)
    want = fa.flash_attention_backward(q.detach(), k.detach(), v.detach(),
                                       out, lse, torch.ones_like(out), 0.125)
    for name, t, w in zip("qkv", (q, k, v), want):
        assert torch.equal(t.grad, w), f"d{name}"


def monotone_pos(rng, b, t, max_slope, j=None):
    """Per-sample monotone positions in [0, T-1] with bounded slope."""
    deltas = rng.uniform(0.0, max_slope, (b, j or t))
    pos = np.cumsum(deltas, axis=1) - rng.uniform(0, 100, (b, 1))
    return np.clip(pos, 0, t - 1).astype(np.float32)


def assert_launches_once(fn, *args):
    """``fn(*args)`` on the card, synchronised; exactly one gather launch."""
    before = gather1d.LAUNCHES
    out = fn(*args)
    torch.cuda.synchronize()
    assert gather1d.LAUNCHES == before + 1
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("b,c,t,j,slope,integral", [
    (16, 1, 2500, 2500, 2.0, False),   # resize-crop of the signal
    (16, 1, 5000, 2500, 1.0, True),    # the partial-sine roll
    (256, 12, 5000, 5000, 2.0, False),
    (3, 2, 7, 9, 1.5, False),          # J under one tile of 256
    (2, 12, 3000, 2049, 4.0, False),   # slope 4, 12 leads, J % 4 == 1
    (5, 3, 40, 1, 1.0, False),         # one output per row
    (4, 5, 600, 1022, 0.5, False),     # J % 4 == 2, a ragged last tile
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
    out = assert_launches_once(
        lambda: gather1d.monotonic_gather(x, pos, max_slope=slope))
    torch.testing.assert_close(out, gather1d.monotonic_gather_plain(x, pos),
                               atol=0, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("j", [1023, 1024, 2048, 3001])
def test_gather_kernel_reads_any_map(cuda, j):
    """No monotone map or slope bound is assumed: a random permutation of
    fractional positions, and T - 1 on both sides of a tile edge (outputs
    1023 and 1024 are the last of one 256-output block and the first of
    the next)."""
    rng = np.random.default_rng(3)
    b, c, t = 3, 12, 4096
    x = torch.from_numpy(rng.standard_normal((b, c, t)).astype(
        np.float32)).cuda()
    pos = rng.permutation(np.linspace(0, t - 1, j * b)).reshape(b, j)
    pos[:, 1022:1026] = t - 1
    pos[:, :3] = [0.0, t - 1.5, 0.5]
    pos = torch.from_numpy(pos.astype(np.float32)).cuda()
    out = assert_launches_once(gather1d.monotonic_gather, x, pos)
    want = gather1d.monotonic_gather_plain(x, pos)
    torch.testing.assert_close(out, want, atol=0, rtol=0)
    edge = out[:, :, 1022:1026] if j > 1022 else out[:, :, :0]
    assert torch.equal(edge, x[:, :, t - 1:].expand_as(edge))


def label_rows(dtype, b, t, j, seed=1):
    rng = np.random.default_rng(seed)
    y = torch.from_numpy(rng.integers(0, 4, (b, t))).to("cuda", dtype)
    idx = np.clip(np.round(monotone_pos(rng, b, t, 2.0, j)), 0, t - 1)
    idx[:, -1] = t - 1
    return y, torch.from_numpy(idx.astype(np.int32)).cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.int64, torch.int32, torch.float32])
def test_gather_int_kernel_matches_plain(cuda, dtype):
    for b, t, j in [(16, 2500, 2500), (3, 900, 1027)]:  # J % 256 == 3
        y, idx = label_rows(dtype, b, t, j)
        out = assert_launches_once(
            lambda: gather1d.monotonic_gather_int(y, idx, max_slope=2.0))
        assert out.dtype == dtype
        torch.testing.assert_close(out, torch.gather(y, 1, idx.long()),
                                   atol=0, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.int64, torch.int32, torch.float32])
@pytest.mark.parametrize("c,t,j,ty,jy", [
    (1, 2500, 2500, 2500, 2500),       # the resize-crop's pair
    (12, 3000, 2049, 700, 5),          # the two parts of unequal sizes
])
def test_gather_pair_equals_two_calls(cuda, dtype, c, t, j, ty, jy):
    rng = np.random.default_rng(2)
    b = 4
    x = torch.from_numpy(rng.standard_normal((b, c, t)).astype(
        np.float32)).cuda()
    pos = torch.from_numpy(monotone_pos(rng, b, t, 2.0, j)).cuda()
    y, idx = label_rows(dtype, b, ty, jy)
    x_out, y_out = assert_launches_once(gather1d.monotonic_gather_pair, x,
                                        pos, y, idx)
    before = gather1d.LAUNCHES
    x_want = gather1d.monotonic_gather(x, pos)
    y_want = gather1d.monotonic_gather_int(y, idx)
    torch.cuda.synchronize()
    assert gather1d.LAUNCHES == before + 2
    assert y_out.dtype == dtype
    torch.testing.assert_close(x_out, x_want, atol=0, rtol=0)
    torch.testing.assert_close(y_out, y_want, atol=0, rtol=0)
    torch.testing.assert_close(x_out, gather1d.monotonic_gather_plain(
        x, pos), atol=0, rtol=0)
    torch.testing.assert_close(y_out, torch.gather(y, 1, idx.long()),
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
    # the labeled resize-crop (signal and labels in one launch), the weak
    # view's resize-crop and the strong view's partial-sine roll
    assert gather1d.LAUNCHES == before + 3
    on_cpu = plan.apply(draws, cpu)
    assert torch.equal(on_card["target"].cpu(), on_cpu["target"])
    for k in ("ecg", "ecg_u_w", "ecg_u_s"):
        torch.testing.assert_close(on_card[k].cpu(), on_cpu[k], atol=1e-5,
                                   rtol=0, msg=k)


# (entry, level, gather launches of one call with labels): each device op
# ported after the shipped chains', with and without a RandAugment level
NEW_OP_CASES = [
    ("xflip", None, 0), ("YFlip", 10, 0),
    ({"drop": {"mask_ratio": 0.3}}, None, 0),
    ({"cutout": {"mask_ratio": 0.5}}, 10, 0),
    ({"shift": {"mask_ratio": 0.5}}, None, 1),
    ({"RandomBaselineShift": {"ratio": 0.4, "scale": 2.0}}, None, 0),
    ("RandomBaselineShift", 7, 0),
    ({"sine_noise": {"amplitude": 0.5, "freq": 0.2}}, None, 0),
    ("SquareNoise", 4, 0), ("white_noise", None, 0), ("WhiteNoise", 10, 0),
    ({"RandomApply": {"transform": "RandomShift", "prob": 0.5}}, None, 1),
    ({"RandomApply": {"transform": "Cutout", "prob": 0.7}}, 10, 0),
]


@pytest.mark.cuda
@pytest.mark.parametrize("entry,level,gathers", NEW_OP_CASES,
                         ids=[f"{i}" for i in range(len(NEW_OP_CASES))])
def test_new_augment_ops_on_the_card_match_the_cpu(cuda, entry, level,
                                                   gathers):
    """Each newly ported device op under one set of draws from a CPU
    generator, on the card and on the CPU, with labels and without: labels
    exactly, signals within 1e-5 absolute and relative; shift launches the
    gather once either way (a pair with labels), the others never."""
    from semi_seg_ecg_tpu_torch.ops import preprocess as pre

    op = pre._make_device_op(*pre._entry_name_kwargs(entry), level)
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(16, 1, 2500, generator=gen)
    y = torch.randint(0, 4, (16, 2500), generator=gen)
    draws = op.sample(gen, tuple(x.shape))
    for labels in (y, None):
        before = gather1d.LAUNCHES
        cx, cy = op.apply(draws, x.cuda(), None if labels is None
                          else labels.cuda())
        torch.cuda.synchronize()
        assert gather1d.LAUNCHES == before + gathers
        px, py = op.apply(draws, x, labels)
        torch.testing.assert_close(cx.cpu(), px, atol=1e-5, rtol=1e-5)
        if labels is None:
            assert cy is None and py is None
        else:
            assert torch.equal(cy.cpu(), py)


@pytest.mark.cuda
def test_resnet18_forward_on_the_card_matches_the_cpu(cuda):
    """Full-width ResNet18 + FCNHead (the shipped recipe's model), seed-0
    weights, fp32 without TF32: the card's logits within 1e-4 of the CPU's
    (cuDNN sums the convolutions in another order)."""
    cfg = {"backbone": {"resnet18": {"num_leads": 1}},
           "decode_head": {"FCNHead": {
               "in_channels": 512, "in_index": 3, "channels": 128,
               "num_convs": 1, "concat_input": False, "num_classes": 4}}}
    torch.manual_seed(0)
    model = build_model_from_config(cfg).eval()
    x = torch.randn(4, 1, 2500, generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        want = model(x)["seg_logits"]
        got = model.to(cuda)(x.to(cuda))["seg_logits"]
    assert got.shape == (4, 4, 2500)
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=0)


@pytest.mark.cuda
def test_stem_pool_routes_ties_on_the_card_as_on_the_cpu(cuda):
    """The stem's k3/s2/p1 max pool over flat lines (most windows tie):
    the card's gradient equals the CPU's bit for bit, so ties go to the
    earliest element there too (the JAX package's routing, pinned against
    ``jax.grad`` in ``tests/test_torch_resnet.py``)."""
    from semi_seg_ecg_tpu_torch.models.backbones.resnet import resnet18

    rng = np.random.default_rng(0)
    x = np.repeat(rng.integers(-2, 3, (4, 8, 126)).astype(np.float32), 10,
                  axis=-1)[..., :1251]
    g = torch.from_numpy(rng.standard_normal((4, 8, 626)).astype(
        np.float32))
    grads = []
    for device in (cuda, torch.device("cpu")):
        xt = torch.from_numpy(x).to(device).requires_grad_()
        resnet18(1).maxpool(xt).backward(g.to(device))
        grads.append(xt.grad.cpu())
    assert torch.equal(grads[0], grads[1])
    assert (grads[1] == 0).float().mean() > 0.3


@pytest.mark.cuda
@pytest.mark.parametrize("algorithm,per_step", [
    ("mean_teacher", (2, 1, 3)),  # teacher + student, student; 3 gathers
    ("cps", (4, 2, 2)),  # two eval + two student passes; no strong view
    ("reco", (2, 1, 3)),  # as Mean Teacher
    ("stpp", (2, 1, 2)),  # stage 2-3: teacher + student; no strong view
])
def test_mean_teacher_and_cps_steps_launch_the_kernels(cuda, algorithm,
                                                       per_step):
    """One step of the shipped vit_tiny recipe (depth cut to 2) with flash
    attention and device augmentation: flash forward launches per block in
    each pass, backward per block of each student pass, the gathers of the
    augmentation; nothing else."""
    import os

    import yaml

    from semi_seg_ecg_tpu_torch.algorithms import get_algorithm
    from semi_seg_ecg_tpu_torch.algorithms.common import Trainer, init_model
    from semi_seg_ecg_tpu_torch.config import normalize_config

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "configs", "base", "vit_tiny",
        f"{algorithm}.yaml")
    with open(path) as f:
        cfg = normalize_config(yaml.safe_load(f))
    depth = 2
    cfg["backbone"]["vit_tiny"].update(depth=depth, out_indices=[1],
                                       attention_impl="flash")
    cfg["decode_head"]["FCNHead"]["in_index"] = 0
    cfg["dataset"]["device_augment"] = True
    module = get_algorithm(algorithm)
    spec = module.SEMISUP_SPEC if algorithm == "stpp" else module.SPEC
    trainer = Trainer(cfg, spec, cuda, 4, model=init_model(cfg, cuda))
    gen = torch.Generator(device="cuda").manual_seed(0)
    batch = {"ecg": torch.randn(16, 1, 2500, generator=gen, device=cuda),
             "target": torch.randint(0, 4, (16, 2500), generator=gen,
                                     device=cuda),
             "ecg_u_w": torch.randn(16, 1, 2500, generator=gen, device=cuda)}
    before = fa.LAUNCHES, fa.BWD_LAUNCHES, gather1d.LAUNCHES
    metrics = trainer.train_step(batch)
    torch.cuda.synchronize()
    after = fa.LAUNCHES, fa.BWD_LAUNCHES, gather1d.LAUNCHES
    fwd, bwd, gathers = per_step
    assert tuple(a - b for a, b in zip(after, before)) == (
        fwd * depth, bwd * depth, gathers)
    assert torch.isfinite(metrics["loss"])


@pytest.mark.cuda
def test_remat_recomputes_through_the_kernels(cuda):
    """One fp32 FixMatch step of the shipped vit_tiny recipe (depth cut to
    2) with flash attention, device augmentation, dropout and drop-path,
    with remat off and on: the recompute launches the flash forward once
    more per block (the student pass), nothing else changes; the metrics
    equal remat off's bit for bit (the forward is the same), the
    gradients and the state within 1e-5 of each tensor's largest element
    (the card's default algorithms do not repeat a backward bit for bit;
    chip_smoke.py phase 11 holds whole steps bit-equal under
    deterministic algorithms)."""
    import os

    import yaml

    from semi_seg_ecg_tpu_torch.algorithms import fixmatch
    from semi_seg_ecg_tpu_torch.algorithms.common import Trainer, init_model
    from semi_seg_ecg_tpu_torch.config import normalize_config

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "configs", "base", "vit_tiny",
        "fixmatch.yaml")
    with open(path) as f:
        cfg = normalize_config(yaml.safe_load(f))
    depth = 2
    cfg["precision"] = "fp32"
    cfg["backbone"]["vit_tiny"].update(depth=depth, out_indices=[1],
                                       attention_impl="flash",
                                       drop_out_rate=0.1, drop_path_rate=0.1)
    cfg["decode_head"]["FCNHead"]["in_index"] = 0
    cfg["dataset"]["device_augment"] = True
    cfg["train"]["conf_thresh"] = 0.5
    gen = torch.Generator(device="cuda").manual_seed(0)
    batch = {"ecg": torch.randn(16, 1, 2500, generator=gen, device=cuda),
             "target": torch.randint(0, 4, (16, 2500), generator=gen,
                                     device=cuda),
             "ecg_u_w": torch.randn(16, 1, 2500, generator=gen, device=cuda)}
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    runs = []
    try:
        for remat in (False, True):
            cfg["backbone"]["vit_tiny"]["remat"] = remat
            trainer = Trainer(cfg, fixmatch.SPEC, cuda, 4,
                              model=init_model(cfg, cuda))
            before = fa.LAUNCHES, fa.BWD_LAUNCHES, gather1d.LAUNCHES
            metrics = trainer.train_step(batch)
            torch.cuda.synchronize()
            after = fa.LAUNCHES, fa.BWD_LAUNCHES, gather1d.LAUNCHES
            assert tuple(a - b for a, b in zip(after, before)) == (
                (3 if remat else 2) * depth, depth, 3)
            runs.append((metrics, {k: p.grad for k, p in
                                   trainer.model.named_parameters()},
                         trainer.model.state_dict()))
    finally:
        torch.backends.cudnn.deterministic = saved
    (m0, g0, s0), (m1, g1, s1) = runs
    for k in m0:
        assert torch.equal(m0[k], m1[k]), k
    for want, got in ((g0, g1), (s0, s1)):
        for k, v in want.items():
            if v.is_floating_point():
                assert (got[k] - v).abs().max() <= 1e-5 * v.abs().max(), k
            else:
                assert torch.equal(got[k], v), k


@pytest.mark.cuda
def test_accumulated_window_flash_matches_dense(cuda):
    """One window of ``accum_iter: 2`` fp32 FixMatch micro-steps of the
    shipped vit_tiny recipe (depth cut to 2, dropout off, device
    augmentation) with flash attention and with the dense path: each
    micro-step launches the kernels of a step (none on the dense path but
    the gathers), the first applies nothing, the second the one update; the
    losses within 1e-4 relative, the BN statistics within 1e-4, the
    parameters within 0.5 lr (the key bias, whose gradient is zero in exact
    arithmetic and whose Adam step is lr-sized noise, within 2 lr)."""
    import os

    import yaml

    from semi_seg_ecg_tpu_torch.algorithms import fixmatch
    from semi_seg_ecg_tpu_torch.algorithms.common import Trainer, init_model
    from semi_seg_ecg_tpu_torch.config import normalize_config

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "configs", "base", "vit_tiny",
        "fixmatch.yaml")
    with open(path) as f:
        cfg = normalize_config(yaml.safe_load(f))
    depth = 2
    cfg["precision"] = "fp32"
    cfg["backbone"]["vit_tiny"].update(depth=depth, out_indices=[1])
    cfg["decode_head"]["FCNHead"].update(in_index=0, dropout_ratio=0.0)
    cfg["dataset"]["device_augment"] = True
    cfg["train"].update(conf_thresh=0.5, accum_iter=2, warmup_epochs=0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    batches = [{"ecg": torch.randn(8, 1, 2500, generator=gen, device=cuda),
                "target": torch.randint(0, 4, (8, 2500), generator=gen,
                                        device=cuda),
                "ecg_u_w": torch.randn(8, 1, 2500, generator=gen,
                                       device=cuda)} for _ in range(2)]
    runs = {}
    for impl, kernels in (("flash", (2 * depth, depth, 3)),
                          ("xla", (0, 0, 3))):
        cfg["backbone"]["vit_tiny"]["attention_impl"] = impl
        trainer = Trainer(cfg, fixmatch.SPEC, cuda, 4,
                          model=init_model(cfg, cuda))
        start = {k: v.clone() for k, v in trainer.model.state_dict().items()}
        losses = []
        for micro, batch in enumerate(batches):
            before = fa.LAUNCHES, fa.BWD_LAUNCHES, gather1d.LAUNCHES
            losses.append(trainer.train_step(batch)["loss"].item())
            torch.cuda.synchronize()
            after = fa.LAUNCHES, fa.BWD_LAUNCHES, gather1d.LAUNCHES
            assert tuple(a - b for a, b in zip(after, before)) == kernels
            assert trainer.optimizer.count == micro
            if micro == 0:
                for k, p in trainer.model.named_parameters():
                    assert torch.equal(p.detach(), start[k]), k
        assert trainer.optimizer.count == 1
        assert trainer.optimizer.micro_step == 0
        runs[impl] = losses, trainer.model.state_dict()
    (lf, sf), (ld, sd) = runs["flash"], runs["xla"]
    for a, b in zip(lf, ld):
        assert abs(a - b) <= 1e-4 * abs(b)
    lr = cfg["train"]["lr"]
    for k, v in sd.items():
        if not v.is_floating_point():
            continue
        err = (sf[k] - v).abs().max().item()
        if "running" in k:
            assert err <= 1e-4 + 1e-4 * v.abs().max().item(), k
        else:
            assert err <= (2.0 if k.endswith("to_qkv.bias") else 0.5) * lr, k


@pytest.mark.cuda
def test_reco_loss_on_the_card(cuda):
    """The ReCo loss at B = 4 (D = 128, T = 2500, Q = 256, Nn = 512): no
    host sync in a call; fed the CPU's indices, the card's loss core equals
    the CPU's in value and latent gradient within 1e-5 relative; the card's
    own sampler picks the CPU's anchors and pools (the CDF is exact
    integer counts over one division on either device)."""
    from semi_seg_ecg_tpu_torch.ops import reco_loss

    b, d, t, c, q, n = 4, 128, 2500, 4, 256, 512
    gen = torch.Generator().manual_seed(0)
    latent = torch.randn(b, d, t, generator=gen)
    logits_t = torch.randn(b, c, t, generator=gen)
    logits_t.scatter_add_(1, torch.randint(0, c, (b, 1, t), generator=gen),
                          torch.full((b, 1, t), 4.0))
    prob_t = torch.softmax(logits_t, dim=1)
    prob_s = torch.softmax(torch.randn(b, c, t, generator=gen), dim=1)
    draws = reco_loss.reco_draws(gen, c, q, n, torch.device("cpu"))
    args = (0.65, 0.8)

    def flat(x, device):
        return x.to(device).transpose(1, 2).reshape(b * t, x.shape[1])

    results = {}
    for device in ("cpu", cuda):
        lat = flat(latent, device).requires_grad_()
        regions = reco_loss.reco_regions(lat.detach(), flat(prob_t, device),
                                         flat(prob_s, device), *args)
        dev_draws = reco_loss.RecoDraws(*(x.to(device) for x in draws))
        sampled = reco_loss.reco_sample(dev_draws, regions, 0.25)
        pools = reco_loss.masked_sample(regions.valid, dev_draws.pool_u)
        if device == "cpu":
            cpu_idx = sampled
        loss = reco_loss.reco_loss_core(
            lat, regions.protos, *(i.to(device) for i in cpu_idx),
            regions.active, regions.valid_seg, 0.25)
        loss.backward()
        results[str(device)] = (float(loss), lat.grad.cpu(),
                                sampled[0].cpu(), pools.cpu())
    (l0, g0, a0, p0), (l1, g1, a1, p1) = results.values()
    assert l1 == pytest.approx(l0, rel=1e-5) and l0 > 0
    assert (g1 - g0).abs().max() <= 1e-5 * g0.abs().max()
    assert torch.equal(a0, a1) and torch.equal(p0, p1)

    inputs = [x.to(cuda) for x in (latent, prob_t, prob_s)]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        card_draws = reco_loss.reco_draws(
            torch.Generator(device=cuda).manual_seed(1), c, q, n, cuda)
        loss = reco_loss.compute_reco_loss(card_draws, *inputs, *args, 0.25)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.isfinite(loss)


def small_vit_serving(device):
    """A depth-2 ViT-1D (flash attention) + FCNHead with seed-0 weights,
    as ``serving.ServingFn`` at fp32, on ``device``."""
    from semi_seg_ecg_tpu_torch.serving import ServingFn

    torch.manual_seed(0)
    model = build_model_from_config({
        "backbone": {"vit_tiny": {
            "num_leads": 1, "seq_len": 500, "patch_size": 25, "width": 64,
            "depth": 2, "heads": 2, "dim_head": 32, "mlp_dim": 128,
            "out_indices": [1], "attention_impl": "flash"}},
        "decode_head": {"FCNHead": {
            "in_channels": 64, "in_index": 0, "channels": 16,
            "num_convs": 1, "concat_input": False, "num_classes": 4}}})
    return ServingFn(model.to(device).eval(), device, False, torch.float32)


@pytest.mark.cuda
def test_stitcher_and_streaming_on_the_card_match_the_cpu(cuda):
    """The long-record stitcher through the flash ViT on the card against
    the CPU's plain path within 1e-4 (the serving bound), launching 2 flash
    forwards per batch of windows; the streaming segmenter on the card
    against the card's offline stitcher within 1e-5, with 2 launches per
    window step, and its stream carries kept on the card."""
    from semi_seg_ecg_tpu_torch.ops.stitch import overlap_add_infer
    from semi_seg_ecg_tpu_torch.serving import StreamingSegmenter

    rng = np.random.default_rng(3)
    records = rng.standard_normal((3, 1, 4321)).astype(np.float32)
    card, cpu = small_vit_serving(cuda), small_vit_serving(
        torch.device("cpu"))
    before = fa.LAUNCHES
    probs, labels = overlap_add_infer(card, records[0], window=500, hop=250,
                                      batch=4)
    assert fa.LAUNCHES == before + 2 * 5  # 17 windows in 5 batches
    assert probs.is_cuda and labels.dtype == torch.int32
    want, _ = overlap_add_infer(cpu, records[0], window=500, hop=250,
                                batch=4)
    torch.testing.assert_close(probs.cpu(), want, atol=1e-4, rtol=0)

    seg = StreamingSegmenter(card, window=500, hop=250, num_streams=3)
    assert seg._acc.is_cuda
    before = fa.LAUNCHES
    got = [seg.push(records[:, :, i:i + 300])[0]
           for i in range(0, 4321, 300)] + [seg.flush()[0]]
    assert fa.LAUNCHES == before + 2 * 17
    got = np.concatenate(got, axis=2)
    for s in range(3):
        ref, _ = overlap_add_infer(card, records[s], window=500, hop=250,
                                   batch=4)
        np.testing.assert_allclose(got[s], ref.cpu().numpy(), atol=1e-5)


# ---------------------------------------------------------------------------
# The serving deployment: the flash operator, int8, the artifact
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("strided", [False, True])
def test_flash_operator_on_the_card(cuda, strided):
    """The forward as the PyTorch operator: the kernel (one launch), within
    the forward tolerance of the plain version, its output in the fake's
    (B, N, H, D) memory; the operator's schema, fake and autograd
    registration pass ``torch.library.opcheck``."""
    shape = (16, 3, 101, 64)
    q, k, v = (chunked_qkv if strided else qkv)(shape, torch.float32)
    op = torch.ops.semi_seg_ecg_tpu_torch.flash_attention_forward
    before = fa.LAUNCHES
    out, lse = op(q, k, v, 0.125)
    torch.cuda.synchronize()
    assert fa.LAUNCHES == before + 1
    ref, ref_lse = fa.flash_attention_plain(q, k, v, 0.125)
    assert_within(out, ref, fa.forward_tolerance(q, k, v, 0.125, ref), "out")
    torch.testing.assert_close(lse, ref_lse, atol=fa.LSE_ATOL, rtol=0)
    b, h, n, d = shape
    assert out.stride() == (n * h * d, d, h * d, 1)
    torch.library.opcheck(fa._forward_op, (q, k, v, 0.125), test_utils=(
        "test_schema", "test_autograd_registration", "test_faketensor"))


@pytest.mark.cuda
@pytest.mark.parametrize("m,cin,k,cout", [
    (17, 1, 7, 64),     # m just above 16; the ResNet stem's k = 7
    (16, 1, 15, 64),    # m = 16 (padded to 17); k = 15
    (40, 1, 25, 192),   # the patch embedding's k = 25
    (101, 64, 3, 64),   # a 3-tap conv of the ResNet's first stage
    (33, 192, 1, 576),  # the qkv projection's shape
])
def test_int8_ops_on_the_card_match_the_cpu(cuda, m, cin, k, cout):
    """``int8_conv1d`` (im2col rows: B · L = m, k = C_in · K) and
    ``int8_linear`` at the shapes the card's integer GEMM takes only
    padded: the card's int32 accumulators equal the CPU's, outputs within
    1e-6 relative."""
    from semi_seg_ecg_tpu_torch.ops import quant

    rng = np.random.default_rng(m + k)
    w = torch.from_numpy((rng.standard_normal((cout, cin, k)) * 0.2).astype(
        np.float32))
    x = torch.from_numpy(rng.standard_normal((1, cin, m * 2)).astype(
        np.float32))
    bias = torch.from_numpy(rng.standard_normal(cout).astype(np.float32))
    pad = k // 2
    # stride 2 with this padding: exactly m output positions
    want = quant.int8_conv1d(x, w, bias, stride=2, padding=pad)
    got = quant.int8_conv1d(x.to(cuda), w.to(cuda), bias.to(cuda), stride=2,
                            padding=pad)
    assert got.shape == want.shape == (1, cout, m)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-6, atol=0)
    xq, _ = quant.quantize_symmetric(x)
    kq, _ = quant.quantize_symmetric(w, dim=(1, 2))
    acc = quant.int_conv1d(xq.to(cuda), kq.to(cuda), 2, pad)
    assert torch.equal(acc.cpu(), quant.int_conv1d(xq, kq, 2, pad))
    xl = torch.from_numpy(rng.standard_normal((m, cin * k)).astype(
        np.float32))
    wl = w.reshape(cout, cin * k)
    torch.testing.assert_close(
        quant.int8_linear(xl.to(cuda), wl.to(cuda), bias.to(cuda)).cpu(),
        quant.int8_linear(xl, wl, bias), rtol=1e-6, atol=0)


@pytest.mark.cuda
def test_serving_artifact_on_the_card(cuda, tmp_path):
    """A depth-2 flash ViT exported on the card and loaded: tracing it
    launches nothing, each call launches the flash forward once per block,
    and its output is ``ServingFn``'s within 1e-5 at batches 1, 3 and 17;
    an int8 artifact within 1e-5 of the int8 ``ServingFn``."""
    from semi_seg_ecg_tpu_torch import serving

    config = vit_serving_config(tmp_path)
    for quantize in (None, "int8"):
        cfg = dict(config, quantize=quantize)
        path = str(tmp_path / f"{quantize}.pt2")
        before = fa.LAUNCHES
        header = serving.export_serving(cfg, path)
        assert fa.LAUNCHES == before
        assert header["platforms"] == ["cuda"]
        serve, _ = serving.load_serving(path)
        infer, _ = serving.make_serving_fn(cfg)
        for n in (1, 3, 17):
            x = torch.randn(n, 1, 500, device=cuda)
            before = fa.LAUNCHES
            got = serve(x)
            torch.cuda.synchronize()
            assert fa.LAUNCHES == before + 2
            assert got.is_cuda and got.shape == (n, 4, 500)
            torch.testing.assert_close(got, infer(x), atol=1e-5, rtol=0)


def vit_serving_config(tmp_path):
    """A depth-2 flash ViT serving config on the card, its seed-0 weights
    written as a ``.pth``."""
    from semi_seg_ecg_tpu_torch.utils.checkpoint import save_torch_checkpoint

    config = {
        "device": "cuda", "precision": "fp32", "seed": 0,
        "dataset": {"signal_length": 500},
        "test": {"model_path": str(tmp_path / "vit.pth")},
        "backbone": {"vit_tiny": {
            "num_leads": 1, "seq_len": 500, "patch_size": 25, "width": 64,
            "depth": 2, "heads": 2, "dim_head": 32, "mlp_dim": 128,
            "out_indices": [1], "attention_impl": "flash"}},
        "decode_head": {"FCNHead": {
            "in_channels": 64, "in_index": 0, "channels": 16,
            "num_convs": 1, "concat_input": False, "num_classes": 4}}}
    torch.manual_seed(0)
    save_torch_checkpoint(config["test"]["model_path"],
                          build_model_from_config(config), epoch=0)
    return config


@pytest.mark.cuda
def test_cross_platform_artifact_on_the_card(cuda, tmp_path):
    """``platforms=("cuda", "cpu")``: one file, its CUDA program (the
    process's platform here) launching the flash forward once per block
    and equal to the ``("cuda",)`` artifact's, its CPU program (asked for
    by name) launching nothing and within 1e-5 of ``ServingFn`` on the
    CPU."""
    from semi_seg_ecg_tpu_torch import serving

    config = vit_serving_config(tmp_path)
    both, single = str(tmp_path / "both.pt2"), str(tmp_path / "cuda.pt2")
    header = serving.export_serving(config, both, platforms=("cuda", "cpu"))
    assert header["platforms"] == ["cuda", "cpu"]
    assert [p["platform"] for p in header["programs"]] == ["cuda", "cpu"]
    serving.export_serving(config, single)
    serve, _ = serving.load_serving(both)
    alone, _ = serving.load_serving(single)
    cpu_serve, _ = serving.load_serving(both, "cpu")
    assert serve.device.type == "cuda" and cpu_serve.device.type == "cpu"
    infer_cpu, _ = serving.make_serving_fn(dict(config, device="cpu"))
    for n in (1, 3):
        x = torch.randn(n, 1, 500, device=cuda)
        before = fa.LAUNCHES
        got = serve(x)
        torch.cuda.synchronize()
        assert fa.LAUNCHES == before + 2
        assert torch.equal(got, alone(x))
        before = fa.LAUNCHES
        on_cpu = cpu_serve(x.cpu())
        assert fa.LAUNCHES == before and on_cpu.device.type == "cpu"
        torch.testing.assert_close(on_cpu, infer_cpu(x.cpu()), atol=1e-5,
                                   rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("strided", [False, True])
def test_flash_operators_pass_full_opcheck_on_the_card(cuda, strided):
    """Both operators, CUDA tensors: opcheck's default checks, AOTAutograd's
    static and dynamic dispatch among them."""
    shape = (4, 3, 101, 64)
    q, k, v = (chunked_qkv if strided else qkv)(shape, torch.float32)
    if not strided:
        q, k, v = (t.requires_grad_() for t in (q, k, v))
    torch.library.opcheck(fa._forward_op, (q, k, v, 0.125))
    out, lse = fa._forward_op(q, k, v, 0.125)
    dout = torch.randn(shape, device=cuda)
    torch.library.opcheck(fa._backward_op, (
        q.detach(), k.detach(), v.detach(), out.detach(), lse, dout, 0.125))


@pytest.mark.cuda
def test_flash_block_compiles_on_the_card(cuda):
    """``torch.compile(fullgraph=True, backend="aot_eager")`` of a flash
    ViT block on the card: one forward and one backward launch a call, as
    eager, and the same values and gradients."""
    from semi_seg_ecg_tpu_torch.models.backbones.vision_transformer import (
        TransformerBlock,
    )

    torch.manual_seed(0)
    block = TransformerBlock(192, 768, heads=3, dim_head=64,
                             attention_impl="flash").to(cuda).eval()
    x = torch.randn(8, 101, 192, device=cuda)

    def run(fn):
        xx = x.clone().requires_grad_()
        before = fa.LAUNCHES, fa.BWD_LAUNCHES
        out = fn(xx)
        out.square().sum().backward()
        torch.cuda.synchronize()
        assert (fa.LAUNCHES, fa.BWD_LAUNCHES) == (before[0] + 1,
                                                  before[1] + 1)
        grads = [p.grad for p in block.parameters()] + [xx.grad]
        block.zero_grad(set_to_none=True)
        return [out.detach()] + grads

    eager = run(block)
    compiled = torch.compile(block, fullgraph=True, backend="aot_eager")
    run(compiled)  # the capture
    for a, b in zip(run(compiled), eager):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.cuda
def test_async_checkpoint_snapshots_card_tensors(cuda, tmp_path):
    """A write queued behind a held writer thread: the card's parameters
    changed in place after ``save_checkpoint`` returns do not reach the
    file, which equals the synchronous file byte for byte."""
    import threading

    from semi_seg_ecg_tpu_torch.utils import checkpoint as ckpt

    torch.manual_seed(0)
    model = torch.nn.Linear(256, 256).to(cuda)
    sync, late = str(tmp_path / "sync.ckpt"), str(tmp_path / "async.ckpt")
    ckpt.save_checkpoint(sync, 0, model, step=1)
    gate = threading.Event()
    ckpt._ensure_worker().put(gate.wait)
    ckpt.save_checkpoint(late, 0, model, step=1, async_write=True)
    with torch.no_grad():
        for p in model.parameters():
            p.mul_(2)
    gate.set()
    ckpt.wait_for_pending()
    with open(sync, "rb") as a, open(late, "rb") as b:
        assert a.read() == b.read()
    assert ckpt.last_written_checkpoint() == late


@pytest.mark.cuda
def test_two_ranks_step_as_one_process_holding_both_shards(cuda, tmp_path):
    """Data parallelism on the card: three fp32 steps of the vit_tiny
    FixMatch recipe (depth cut to 2, flash attention, device augmentation,
    dropout off, SGD with momentum) under two ranks of
    ``tests/torch_dist_worker.py`` with 8 rows each (NCCL on two cards, else
    gloo with CUDA tensors on one) against one process holding both shards:
    losses within 1e-5 relative, parameters and BN statistics within 5e-4
    relative + 1e-5 (the JAX package's bound for a sharded step), the two
    ranks' states equal, each rank launching per step the kernels of its
    own rows (two passes of 2 flash forwards, one of 2 backwards, 3
    gathers)."""
    import copy
    import os

    import yaml

    from semi_seg_ecg_tpu_torch.algorithms import fixmatch
    from semi_seg_ecg_tpu_torch.algorithms.common import Trainer, init_model
    from semi_seg_ecg_tpu_torch.config import normalize_config
    # tests/ is on the path of a pytest run (a package named "tests" that
    # another distribution installs would shadow "tests.torch_dist_worker")
    from torch_dist_worker import run_ranks

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "configs", "base", "vit_tiny",
        "fixmatch.yaml")
    with open(path) as f:
        cfg = normalize_config(yaml.safe_load(f))
    cfg["precision"] = "fp32"
    cfg["backbone"]["vit_tiny"].update(depth=2, out_indices=[1],
                                       attention_impl="flash")
    cfg["decode_head"]["FCNHead"].update(in_index=0, dropout_ratio=0.0)
    cfg["dataset"]["device_augment"] = True
    cfg["train"].update(warmup_epochs=0, optimizer="sgd", conf_thresh=0.5,
                        optimizer_kwargs={"momentum": 0.9})
    rng = np.random.default_rng(0)
    x = lambda: rng.standard_normal((16, 1, 2500)).astype(np.float32)
    batches = [{"ecg": x(), "target": rng.integers(0, 4, (16, 2500)),
                "ecg_u_w": x()} for _ in range(3)]
    model = init_model(cfg, torch.device("cpu"))
    run = {"config": cfg, "batches": batches,
           "states": {"model": {k: v.numpy() for k, v in
                                model.state_dict().items()}}}
    two_cards = torch.cuda.device_count() >= 2
    ranks = run_ranks([("steps", {"runs": [run], "device": "cuda"})],
                      str(tmp_path), timeout=300, device="cuda",
                      backend="nccl" if two_cards else "gloo",
                      one_card=not two_cards)
    trainer = Trainer(copy.deepcopy(cfg), fixmatch.SPEC, cuda, 3,
                      model=model.to(cuda))
    want = [{k: v.item() for k, v in trainer.train_step(
        {k: torch.from_numpy(v).to(cuda) for k, v in b.items()}).items()}
        for b in batches]
    first, second = (r[0][0] for r in ranks)
    assert first["launches"] == second["launches"] == [[4, 2, 3]] * 3
    for a, b in zip(first["metrics"], want):
        for k in ("loss", "loss_x", "loss_u_s"):
            assert a[k] == pytest.approx(b[k], rel=1e-5), k
    for k, v in trainer.model.state_dict().items():
        got = first["states"]["model"][k]
        np.testing.assert_array_equal(got, second["states"]["model"][k])
        if v.is_floating_point():
            np.testing.assert_allclose(got, v.cpu().numpy(), rtol=5e-4,
                                       atol=1e-5, err_msg=k)


# ---------------------------------------------------------------------------
# Ring attention's hops: the kernels with their query and key counts apart
# ---------------------------------------------------------------------------

HOP_CASES = [(51, 51, 50), (50, 51, 51), (1025, 1025, 1024), (513, 513, 512),
             (64, 128, 100), (7, 64, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("nq,nk,n_kv", HOP_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_hop_kernels_match_plain(cuda, nq, nk, n_kv, dtype):
    """q of nq rows against the first n_kv of nk keys (the rest of a
    padded chunk masked), forward and backward, the backward on the out
    and lse of a longer softmax (a ring's merged ones, here over the chunk
    and another of nq keys)."""
    b, h, d = 2, 3, 64
    scale = d ** -0.5
    (q,) = qkv((b, h, nq, d), dtype, seed=1)[:1]
    k, v, dout = qkv((b, h, nk, d), dtype, seed=2)[:2] + [
        qkv((b, h, nq, d), dtype, seed=3)[0]]
    before = fa.LAUNCHES
    out, lse = fa.flash_attention_hop_forward(q, k, v, scale, n_kv)
    assert fa.LAUNCHES == before + 1
    ks, vs = k[:, :, :n_kv], v[:, :, :n_kv]
    ref_out, ref_lse = fa.flash_attention_plain(q, ks, vs, scale)
    assert_within(out, ref_out, fa.forward_tolerance(q, ks, vs, scale,
                                                     ref_out), "out")
    torch.testing.assert_close(lse, ref_lse, atol=fa.LSE_ATOL, rtol=0)
    # the merged softmax over this chunk and another
    k2, v2 = qkv((b, h, nq, d), dtype, seed=4)[:2]
    g_out, g_lse = fa.flash_attention_plain(
        q, torch.cat([ks, k2], 2), torch.cat([vs, v2], 2), scale)
    before = fa.BWD_LAUNCHES
    grads = fa.flash_attention_hop_backward(q, k, v, g_out, g_lse, dout,
                                            scale, n_kv)
    assert fa.BWD_LAUNCHES == before + 1
    ref = fa.flash_attention_backward_plain(q, ks, vs, g_out, g_lse, dout,
                                            scale)
    tols = fa.backward_tolerance(q, ks, vs, g_out, g_lse, dout, scale, ref)
    for name, got, want, tol in zip("qkv", grads, ref, tols):
        assert got.dtype == dtype, name
        got = got if name == "q" else got[:, :, :n_kv]
        assert_within(got, want, tol, f"d{name}")
    for got in grads[1:]:
        assert not got[:, :, n_kv:].any()


@pytest.mark.cuda
@pytest.mark.parametrize("size,n", [(2, 101), (3, 64), (4, 257)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_ring_matches_plain_ring(cuda, size, n, dtype):
    """The ring through the kernels against the plain ring, forward and
    gradients (the seq ranks as threads, ``seq_shard.run_threads``), the
    ranks' chunks uneven and padded, within the single kernel's
    tolerances (fp32) or the ring's bf16 error bounds."""
    from semi_seg_ecg_tpu_torch.ops import ring_attention as ra
    from semi_seg_ecg_tpu_torch.parallel.seq_shard import block, run_threads

    b, h, d = 2, 3, 64
    scale = d ** -0.5
    q, k, v = qkv((b, h, n, d), dtype, seed=5)
    g = qkv((b, h, n, d), dtype, seed=6)[0]
    blocks = [block(n, size, j) for j in range(size)]
    counts = [hi - lo for lo, hi in blocks]

    def ring(kernel):
        def rank(comm):
            lo, hi = blocks[comm.rank]
            qi, ki, vi, gi = (t[:, :, lo:hi].contiguous()
                              for t in (q, k, v, g))
            out, lse = ra.ring_forward(qi, ki, vi, comm, scale, counts,
                                       kernel)
            return out, ra.ring_backward(qi, ki, vi, out, lse, gi, comm,
                                         scale, counts, kernel)

        res = run_threads(size, rank)
        torch.cuda.synchronize()
        return (torch.cat([r[0] for r in res], 2),
                [torch.cat([r[1][i] for r in res], 2) for i in range(3)])

    out, grads = ring(True)
    out_p, grads_p = ring(False)
    if dtype == torch.float32:
        tol = fa.forward_tolerance(q, k, v, scale, out_p)
        tols = fa.backward_tolerance(q, k, v, out_p, None, g, scale, grads_p)
    else:
        ref_out, ref_lse = fa.flash_attention_plain(q, k, v, scale)
        tol = ra.ring_forward_error_bound(q, k, v, scale)
        tols = ra.ring_backward_error_bound(q, k, v, ref_out, ref_lse, g,
                                            scale)
    assert_within(out, out_p, tol, "out")
    for name, got, want, t in zip("qkv", grads, grads_p, tols):
        assert_within(got, want, t, f"d{name}")


# train.scan_steps: flash forward and backward passes a ViT step makes, and
# the augmentation's gather launches, by algorithm (ST++: its stage step)
SCAN_PASSES = {"base": (1, 1, 1), "fixmatch": (2, 1, 3),
               "mean_teacher": (2, 1, 3), "cps": (4, 2, 2),
               "reco": (2, 1, 3), "stpp": (2, 1, 2)}
SCAN_NEEDLES = {"fwd": "flash_fwd_", "bwd": "flash_bwd_dq",
                "gather": "gather1d_kernel"}


def scan_config(algorithm, family="vit_tiny", precision="fp32", **train):
    """The shipped recipe of ``algorithm`` at depth 2 (ViT) or width 8
    (ResNet18), flash attention, device augmentation, dropout as shipped
    (the ViT's drop-out and drop-path 0.1), batch 8."""
    import os

    import yaml

    from semi_seg_ecg_tpu_torch.config import normalize_config

    recipe = "scratch" if algorithm == "base" else algorithm
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "configs", "base", family,
        f"{recipe}.yaml")
    with open(path) as f:
        cfg = normalize_config(yaml.safe_load(f))
    cfg["precision"] = precision
    if family == "vit_tiny":
        cfg["backbone"]["vit_tiny"].update(
            depth=2, out_indices=[1], attention_impl="flash",
            drop_out_rate=0.1, drop_path_rate=0.1)
        cfg["decode_head"]["FCNHead"]["in_index"] = 0
    else:
        cfg["backbone"]["resnet18"].update(stem_channels=8, base_channels=8)
        cfg["decode_head"]["FCNHead"]["in_channels"] = 64
        if cfg.get("use_latent_projection"):
            cfg["projection_in_dim"] = 64
    cfg["dataset"]["device_augment"] = True
    cfg["train"].update(conf_thresh=0.5, warmup_epochs=0, **train)
    return cfg


def scan_run(cfg, algorithm, device, steps, captured):
    """``steps`` steps of a Trainer of ``cfg`` from one init on fixed
    device batches: eager with capturable optimizers, or (``captured``)
    at ``scan_steps: 2`` with the graph's nodes kept; returns the per-step
    metrics, the final states and the trainer."""
    from semi_seg_ecg_tpu_torch.algorithms import get_algorithm
    from semi_seg_ecg_tpu_torch.algorithms.common import Trainer, init_model
    from semi_seg_ecg_tpu_torch.utils.captured_step import CapturedStep

    cfg = copy.deepcopy(cfg)
    cfg["train"]["scan_steps"] = 2 if captured else 1
    module = get_algorithm(algorithm)
    spec = module.SEMISUP_SPEC if algorithm == "stpp" else module.SPEC
    trainer = Trainer(cfg, spec, device, 4, model=init_model(cfg, device))
    if captured:
        trainer.captured = CapturedStep(trainer, keep_graph=True)
    else:
        for opt in (trainer.optimizer, trainer.peer_optimizer):
            if opt is not None:
                opt.make_capturable_()
    gen = torch.Generator(device="cuda").manual_seed(0)
    metrics = []
    for _ in range(steps):
        batch = {"ecg": torch.randn(8, 1, 2500, generator=gen, device=device),
                 "target": torch.randint(0, 4, (8, 2500), generator=gen,
                                         device=device),
                 "ecg_u_w": torch.randn(8, 1, 2500, generator=gen,
                                        device=device)}
        if not spec.uses_unlabeled:
            del batch["ecg_u_w"]  # as the loop's labeled-only batches
        metrics.append({k: v.item() for k, v in
                        trainer.train_step(batch).items()})
    states = {name: {k: v.detach().clone() for k, v in
                     module_.state_dict().items()}
              for name, module_ in (("model", trainer.model),
                                    ("teacher", trainer.teacher),
                                    ("peer", trainer.peer))
              if module_ is not None}
    return metrics, states, trainer


SCAN_CASES = [("vit_tiny", a, "fp32", {}) for a in SCAN_PASSES] + [
    ("vit_tiny", "fixmatch", "bf16", {"remat": True}),
    ("vit_tiny", "fixmatch", "fp32", {"layer_decay": 0.75,
                                      "frozen_stages": 1, "dense": True}),
    ("resnet18", "fixmatch", "fp32", {"max_norm": 1.0}),
    ("resnet18", "fixmatch", "fp32", {"optimizer": "sgd",
                                      "optimizer_kwargs": {"momentum": 0.9}}),
    ("resnet18", "mean_teacher", "bf16", {"freeze_backbone": True}),
]


@pytest.fixture()
def deterministic(cuda, monkeypatch):
    """PyTorch's deterministic algorithms (cuDNN's too), so that a step
    repeats bit for bit on the card."""
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    saved = (torch.are_deterministic_algorithms_enabled(),
             torch.backends.cudnn.deterministic)
    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.deterministic = True
    try:
        yield cuda
    finally:
        torch.use_deterministic_algorithms(saved[0])
        torch.backends.cudnn.deterministic = saved[1]


@pytest.mark.cuda
@pytest.mark.parametrize("family,algorithm,precision,options", SCAN_CASES)
def test_captured_step_replays_the_eager_step(deterministic, family,
                                              algorithm, precision, options):
    """``train.scan_steps: 2``: four steps, the first the eager warm-up,
    the other three replays of the captured step, against four eager steps
    with the same capturable optimizers (tensor lr, AdamW's step on the
    card, SGD's fused update) from one init on the same batches, under
    deterministic algorithms: every step's metrics and every tensor of
    every network bit for bit. The graph holds the step's kernels (its
    kernel nodes: the host counters count at the warm-up and at the
    capture, never at a replay)."""
    from semi_seg_ecg_tpu_torch.utils import captured_step

    cuda = deterministic

    options = dict(options)
    cfg = scan_config(algorithm, family, precision)
    if options.pop("remat", False):
        cfg["backbone"][family]["remat"] = True
    if options.pop("dense", False):
        cfg["backbone"]["vit_tiny"]["attention_impl"] = "xla"
    if "frozen_stages" in options:
        cfg["backbone"][family]["frozen_stages"] = options.pop(
            "frozen_stages")
    if options.pop("freeze_backbone", False):
        cfg["mode"] = "freeze_backbone"
    cfg["train"].update(options)
    steps = 4
    want, want_states, _ = scan_run(cfg, algorithm, cuda, steps, False)
    before = fa.LAUNCHES, fa.BWD_LAUNCHES, gather1d.LAUNCHES
    got, got_states, trainer = scan_run(cfg, algorithm, cuda, steps, True)
    torch.cuda.synchronize()
    counted = tuple(a - b for a, b in zip(
        (fa.LAUNCHES, fa.BWD_LAUNCHES, gather1d.LAUNCHES), before))
    assert trainer.captured is not None and trainer.captured.replays == 3
    fwd, bwd, gathers = SCAN_PASSES[algorithm]
    depth = 2 if family == "vit_tiny" and cfg["backbone"]["vit_tiny"][
        "attention_impl"] == "flash" else 0
    remat = cfg["backbone"][family].get("remat", False)
    per_step = {"fwd": (fwd + (bwd if remat else 0)) * depth,
                "bwd": bwd * depth, "gather": gathers}
    assert captured_step.count_kernels(trainer.captured.kernel_names,
                                       SCAN_NEEDLES) == per_step
    # the warm-up step and the capture's one pass of the host code
    assert counted == tuple(2 * v for v in per_step.values())
    assert got == want
    for name, state in want_states.items():
        for k, v in state.items():
            assert torch.equal(got_states[name][k], v), (name, k)


@pytest.mark.cuda
def test_captured_run_resumes_eagerly_and_back(cuda, tmp_path):
    """A captured trainer's optimizer state holds the eager layout (float
    lr, the step count on the host), loads into an eager trainer, and an
    eager one's state into a trainer that then captures."""
    from semi_seg_ecg_tpu_torch.utils import checkpoint as ckpt

    cfg = scan_config("fixmatch")
    _, _, captured = scan_run(cfg, "fixmatch", cuda, 3, True)
    _, _, eager = scan_run(cfg, "fixmatch", cuda, 3, False)
    states = []
    for trainer in (captured, eager):
        state = ckpt._to_numpy(trainer.optimizer.state_dict())
        assert all(isinstance(g["lr"], float) and not g["capturable"]
                   for g in state["param_groups"])
        states.append(state)
    assert states[0].keys() == states[1].keys()
    assert states[0]["count"] == states[1]["count"] == 3
    for entry in states[0]["state"].values():
        assert entry["step"].shape == () and entry["step"] == 3
    cfg2 = copy.deepcopy(cfg)
    for scan, state in ((1, states[0]), (2, states[1])):
        cfg2["train"]["scan_steps"] = scan
        from semi_seg_ecg_tpu_torch.algorithms import fixmatch
        from semi_seg_ecg_tpu_torch.algorithms.common import (
            Trainer,
            init_model,
        )

        trainer = Trainer(copy.deepcopy(cfg2), fixmatch.SPEC, cuda, 4,
                          model=init_model(cfg2, cuda))
        trainer.optimizer.load_state_dict(copy.deepcopy(state))
        gen = torch.Generator(device="cuda").manual_seed(1)
        for _ in range(2):
            batch = {"ecg": torch.randn(8, 1, 2500, generator=gen,
                                        device=cuda),
                     "target": torch.randint(0, 4, (8, 2500), generator=gen,
                                             device=cuda),
                     "ecg_u_w": torch.randn(8, 1, 2500, generator=gen,
                                            device=cuda)}
            assert torch.isfinite(trainer.train_step(batch)["loss"])
        assert trainer.optimizer.count == 5


ACCUM_SCAN_CASES = [("vit_tiny", "fixmatch", "fp32", 2),
                    ("vit_tiny", "fixmatch", "bf16", 3),
                    ("vit_tiny", "mean_teacher", "fp32", 2),
                    ("vit_tiny", "cps", "fp32", 2),
                    ("resnet18", "fixmatch", "fp32", 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("family,algorithm,precision,accum",
                         ACCUM_SCAN_CASES)
def test_captured_accumulation_replays_the_eager_micro_steps(
        deterministic, family, algorithm, precision, accum):
    """``train.scan_steps: 2`` with ``accum_iter`` k: three windows and a
    micro-step, the first window the eager warm-up, then replays of the
    accumulating and the updating graph, against the same micro-steps
    taken eagerly with the capturable optimizers, under deterministic
    algorithms: every micro-step's metrics and every tensor of every
    network bit for bit. Each graph holds a step's kernels (its kernel
    nodes); the host counters count the warm-up's k steps and the two
    captures."""
    from semi_seg_ecg_tpu_torch.utils import captured_step

    cuda = deterministic
    cfg = scan_config(algorithm, family, precision, accum_iter=accum)
    steps = 3 * accum + 1
    want, want_states, _ = scan_run(cfg, algorithm, cuda, steps, False)
    before = fa.LAUNCHES, fa.BWD_LAUNCHES, gather1d.LAUNCHES
    got, got_states, trainer = scan_run(cfg, algorithm, cuda, steps, True)
    torch.cuda.synchronize()
    counted = tuple(a - b for a, b in zip(
        (fa.LAUNCHES, fa.BWD_LAUNCHES, gather1d.LAUNCHES), before))
    captured = trainer.captured
    fwd, bwd, gathers = SCAN_PASSES[algorithm]
    depth = 2 if family == "vit_tiny" else 0
    per_step = {"fwd": fwd * depth, "bwd": bwd * depth, "gather": gathers}
    assert captured.warm_up_steps == accum
    updates = sum(j % accum == accum - 1 for j in range(accum, steps))
    assert captured.replays_by_kind == {
        "accumulate": steps - accum - updates, "update": updates}
    for kind in captured_step.KINDS:
        assert captured_step.count_kernels(captured.kernel_names_of(kind),
                                           SCAN_NEEDLES) == per_step, kind
    assert counted == tuple((accum + 2) * v for v in per_step.values())
    assert got == want
    for name, state in want_states.items():
        for k, v in state.items():
            assert torch.equal(got_states[name][k], v), (name, k)


def host_state(obj):
    """``obj`` with each tensor copied to the host, through dicts and
    lists."""
    if torch.is_tensor(obj):
        return obj.detach().cpu().clone()
    if isinstance(obj, dict):
        return {k: host_state(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(host_state(v) for v in obj)
    return obj


def assert_states_equal(got, want, path=""):
    """Two :func:`host_state` trees equal, tensors bit for bit."""
    if torch.is_tensor(want):
        assert torch.equal(got, want), path
    elif isinstance(want, dict):
        assert got.keys() == want.keys(), path
        for k in want:
            assert_states_equal(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            assert_states_equal(a, b, f"{path}/{i}")
    else:
        assert got == want, path


def trainer_state(trainer, buffers=True):
    """A trainer's networks (without ``buffers``, their parameters only)
    and optimizers, on the host."""
    return host_state({
        "nets": {name: m.state_dict() if buffers
                 else dict(m.named_parameters()) for name, m in (
                     ("model", trainer.model), ("teacher", trainer.teacher),
                     ("peer", trainer.peer)) if m is not None},
        "optimizers": [o.state_dict() for o in trainer.optimizers],
        "step": trainer.step})


NAN_SCAN_CASES = [("vit_tiny", "fixmatch", "bf16", 1),
                  ("vit_tiny", "fixmatch", "fp32", 2),
                  ("vit_tiny", "cps", "fp32", 1),
                  ("resnet18", "fixmatch", "fp32", 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("family,algorithm,precision,accum",
                         NAN_SCAN_CASES)
def test_captured_step_with_nan_checks_equals_the_unchecked_one(
        deterministic, family, algorithm, precision, accum):
    """``debug.nan_checks`` at ``train.scan_steps: 2``: each micro-step's
    capture splits at the gradients' NaN flags into two graphs, the first
    holding the step's kernels (its kernel nodes), the second none of
    them; on clean batches no step reruns, and the run equals the captured
    run without the checks bit for bit (metrics, networks, optimizers)
    under deterministic algorithms."""
    from semi_seg_ecg_tpu_torch.utils import captured_step

    cuda = deterministic
    cfg = scan_config(algorithm, family, precision, accum_iter=accum)
    steps = 3 * accum + 1 if accum > 1 else 4
    want, _, plain = scan_run(cfg, algorithm, cuda, steps, True)
    want_state = trainer_state(plain)
    got, _, trainer = scan_run(dict(cfg, debug={"nan_checks": True}),
                               algorithm, cuda, steps, True)
    captured = trainer.captured
    fwd, bwd, gathers = SCAN_PASSES[algorithm]
    depth = 2 if family == "vit_tiny" else 0
    per_step = {"fwd": fwd * depth, "bwd": bwd * depth, "gather": gathers}
    none = {k: 0 for k in per_step}
    for kind in captured.graphs:
        assert [captured_step.count_kernels(names, SCAN_NEEDLES)
                for names in captured.segment_kernel_names(kind)] == [
            per_step, none], kind
        assert len(plain.captured.graphs[kind]) == 1
    assert captured.reruns == 0
    assert got == want
    assert_states_equal(trainer_state(trainer), want_state)


@pytest.mark.cuda
def test_captured_step_with_a_nan_raises_from_its_eager_rerun(cuda):
    """``debug.nan_checks`` at ``train.scan_steps: 2``: after the warm-up
    and a replay, a NaN in one labeled row of the batch sets the gradients'
    flags; the update's graph does not run, and the step's eager rerun
    raises ``FloatingPointError`` at the backward op (anomaly mode's error
    the cause), the parameters, optimizer and step as they were (the
    BatchNorm statistics move with the step's forward)."""
    import re

    from semi_seg_ecg_tpu_torch.algorithms import fixmatch
    from semi_seg_ecg_tpu_torch.algorithms.common import Trainer, init_model
    from semi_seg_ecg_tpu_torch.utils.captured_step import CapturedStep

    cfg = dict(scan_config("fixmatch", precision="bf16"),
               debug={"nan_checks": True})
    cfg["train"]["scan_steps"] = 2
    trainer = Trainer(cfg, fixmatch.SPEC, cuda, 4,
                      model=init_model(cfg, cuda))
    trainer.captured = CapturedStep(trainer)
    gen = torch.Generator(device="cuda").manual_seed(3)
    batches = [{"ecg": torch.randn(8, 1, 2500, generator=gen, device=cuda),
                "target": torch.randint(0, 4, (8, 2500), generator=gen,
                                        device=cuda),
                "ecg_u_w": torch.randn(8, 1, 2500, generator=gen,
                                       device=cuda)} for _ in range(3)]
    batches[2]["ecg"][5, 0, 1000] = float("nan")
    for batch in batches[:2]:
        trainer.train_step(batch)
    before = trainer_state(trainer, buffers=False)
    with pytest.raises(FloatingPointError) as info:
        trainer.train_step(batches[2])
    assert re.match(r"debug.nan_checks: train step 2: Function "
                    r"'\w+Backward\d*' returned nan values",
                    str(info.value))
    assert isinstance(info.value.__cause__, RuntimeError)
    assert trainer.captured.reruns == 1
    assert trainer.captured.replays_by_kind["update"] == 1
    assert_states_equal(trainer_state(trainer, buffers=False), before)


@pytest.mark.cuda
@pytest.mark.parametrize("accum", [1, 2])
def test_two_nccl_ranks_replay_the_captured_step(cuda, tmp_path, accum):
    """``train.scan_steps: 2`` under two NCCL ranks (two cards; the
    gradient all-reduce and the BatchNorm statistics' all-gather inside
    the graphs): five fp32 steps of the depth-2 ViT FixMatch recipe (SGD
    with momentum, whose fused update equals the foreach one) on 8 rows a
    rank, against the same ranks stepping eagerly: losses within 1e-5
    relative, states within 5e-4 relative + 1e-5, the two ranks equal."""
    from torch_dist_worker import run_ranks

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards: NCCL takes one card a rank")
    cfg = scan_config("fixmatch", optimizer="sgd",
                      optimizer_kwargs={"momentum": 0.9}, accum_iter=accum)
    cfg["backbone"]["vit_tiny"].update(drop_out_rate=0.0,
                                       drop_path_rate=0.0)
    rng = np.random.default_rng(2)
    x = lambda: rng.standard_normal((16, 1, 2500)).astype(np.float32)
    batches = [{"ecg": x(), "target": rng.integers(0, 4, (16, 2500)),
                "ecg_u_w": x()} for _ in range(5)]
    init = build_model_from_config(cfg, train=True)
    states = {"model": {k: v.numpy() for k, v in init.state_dict().items()}}
    runs = []
    for scan in (1, 2):
        run_cfg = copy.deepcopy(cfg)
        run_cfg["train"]["scan_steps"] = scan
        runs.append({"config": run_cfg, "batches": batches,
                     "states": states})
    ranks = run_ranks([("steps", {"runs": runs, "device": "cuda"})],
                      str(tmp_path), timeout=300, device="cuda",
                      backend="nccl")
    (eager0, captured0), (eager1, captured1) = (r[0] for r in ranks)
    for a, b in zip(captured0["metrics"], eager0["metrics"]):
        for k in ("loss", "loss_x", "loss_u_s"):
            assert a[k] == pytest.approx(b[k], rel=1e-5), k
    for k, v in eager0["states"]["model"].items():
        got = captured0["states"]["model"][k]
        np.testing.assert_array_equal(got, captured1["states"]["model"][k])
        np.testing.assert_array_equal(v, eager1["states"]["model"][k])
        if v.dtype.kind == "f":
            np.testing.assert_allclose(got, v, rtol=5e-4, atol=1e-5,
                                       err_msg=k)
