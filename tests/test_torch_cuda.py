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
places).
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
    trainer = Trainer(cfg, get_algorithm(algorithm).SPEC, cuda, 4,
                      model=init_model(cfg, cuda))
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
