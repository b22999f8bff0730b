"""The port's flash attention, forward and backward, against the JAX
package's.

On the CPU the port's wrappers run the kernels' plain versions
(``flash_attention_plain``, ``flash_attention_backward_plain``); they are
held against the JAX ``_flash_forward`` / ``_flash_backward`` with their
Pallas kernels in interpret mode. Forward: out and lse at fp32 within atol
1e-5 (two fp32 softmax formulations, sums in another order). Backward: dq,
dk, dv at fp32 within atol 1e-5 + rtol 1e-4 (sums over N products in
another order), and in bf16 within one bf16 ulp of each other (rtol 2^-7:
both round an fp32 result once). Emulations of where the kernels round
(bf16 P and dS; the fp32 kernels' 3xTF32 split) hold the tolerances the
card is checked with. The CUDA
kernels are held against the plain versions in ``tests/test_torch_cuda.py``,
which imports nothing of JAX, so that it also runs where a CUDA card is
and the JAX package's dependencies are not.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from semi_seg_ecg_tpu.ops.attention import dense_attention as jax_dense
from semi_seg_ecg_tpu.ops.pallas.flash_attention import (
    _flash_backward,
    _flash_forward,
)
from semi_seg_ecg_tpu_torch.ops import flash_attention as fa
from semi_seg_ecg_tpu_torch.ops.attention import dense_attention
from tests.torch_dist_worker import one_thread  # noqa: F401 (autouse)


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



def jax_flash_grads(q, k, v, dout, scale):
    """dq, dk, dv of the JAX custom VJP's backward, Pallas in interpret
    mode, from its own forward's out and lse."""
    q, k, v, dout = (jnp.asarray(a) for a in (q, k, v, dout))
    out, lse = _flash_forward(q, k, v, scale, None, None, True)
    return [np.asarray(g, np.float32) for g in _flash_backward(
        q, k, v, out, lse, dout, scale, None, None, True)]


@pytest.mark.parametrize("n", [37, 64])
@pytest.mark.parametrize("d", [16, 32])
def test_plain_backward_matches_jax_flash_backward(n, d):
    q, k, v = qkv((2, 2, n, d), seed=3)
    dout = qkv((2, 2, n, d), seed=4)[0]
    scale = d ** -0.5
    ref = jax_flash_grads(q, k, v, dout, scale)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, dout))
    out, lse = fa.flash_attention_forward(tq, tk, tv, scale)
    before = fa.BWD_LAUNCHES
    grads = fa.flash_attention_backward(tq, tk, tv, out, lse, tdo, scale)
    assert fa.BWD_LAUNCHES == before  # CPU tensors never launch
    for name, got, want in zip("qkv", grads, ref):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-4,
                                   err_msg=f"d{name}")
    # and against autograd through the dense formulation
    tq, tk, tv = (t.clone().requires_grad_() for t in (tq, tk, tv))
    dense_attention(tq, tk, tv, scale).backward(tdo)
    for name, got, t in zip("qkv", grads, (tq, tk, tv)):
        np.testing.assert_allclose(got.numpy(), t.grad.numpy(), atol=1e-5,
                                   rtol=1e-4, err_msg=f"d{name} dense")


def test_plain_backward_bf16_within_one_ulp_of_jax():
    q, k, v = qkv((1, 2, 64, 32), seed=5)
    dout = qkv((1, 2, 64, 32), seed=6)[0]
    bf = [jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v, dout)]
    ref = jax_flash_grads(*bf, 0.2)
    tq, tk, tv, tdo = (torch.from_numpy(np.asarray(a.astype(jnp.float32)))
                       .to(torch.bfloat16) for a in bf)
    out, lse = fa.flash_attention_forward(tq, tk, tv, 0.2)
    grads = fa.flash_attention_backward(tq, tk, tv, out, lse, tdo, 0.2)
    for name, got, want in zip("qkv", grads, ref):
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(), want, atol=1e-5,
                                   rtol=2.0 ** -7, err_msg=f"d{name}")


def test_flash_attention_function_gradients_are_the_plain_backward():
    q, k, v = (torch.from_numpy(a).requires_grad_()
               for a in qkv((2, 3, 40, 16), seed=7))
    dout = torch.from_numpy(qkv((2, 3, 40, 16), seed=8)[0])
    out = fa.flash_attention(q, k, v, 0.25)
    ref_out, lse = fa.flash_attention_plain(q.detach(), k.detach(),
                                            v.detach(), 0.25)
    torch.testing.assert_close(out.detach(), ref_out, rtol=0, atol=0)
    out.backward(dout)
    want = fa.flash_attention_backward_plain(
        q.detach(), k.detach(), v.detach(), ref_out, lse, dout, 0.25)
    for name, t, w in zip("qkv", (q, k, v), want):
        torch.testing.assert_close(t.grad, w, rtol=0, atol=0,
                                   msg=f"d{name}")
    # under no_grad nothing is saved and nothing needs a graph
    with torch.no_grad():
        assert not fa.flash_attention(q, k, v, 0.25).requires_grad


def test_autograd_dout_reaches_the_backward_in_a_layout_the_kernels_take(
        monkeypatch):
    """``.sum().backward()`` hands the Function an expanded ``dout`` of
    stride 0; the Function copies it before the backward wrapper, which on
    a card refuses such a layout, and the gradients stay the plain ones."""
    seen, real = [], fa.flash_attention_backward

    def spy(q, k, v, out, lse, dout, scale):
        seen.append(dout)
        return real(q, k, v, out, lse, dout, scale)

    monkeypatch.setattr(fa, "flash_attention_backward", spy)
    q, k, v = (torch.from_numpy(a).requires_grad_()
               for a in qkv((2, 3, 40, 16), seed=9))
    fa.flash_attention(q, k, v, 0.25).sum().backward()
    (dout,) = seen
    assert fa.layout_fault(dout) is None
    assert torch.equal(dout, torch.ones_like(dout))
    out, lse = fa.flash_attention_plain(q.detach(), k.detach(), v.detach(),
                                        0.25)
    want = fa.flash_attention_backward_plain(
        q.detach(), k.detach(), v.detach(), out, lse, torch.ones_like(out),
        0.25)
    for name, t, w in zip("qkv", (q, k, v), want):
        torch.testing.assert_close(t.grad, w, rtol=0, atol=0,
                                   msg=f"d{name}")


def test_layout_fault_names_what_the_kernels_do_not_take():
    b, h, n, d = 2, 3, 40, 16
    x = torch.zeros(b, n, 3 * h * d, dtype=torch.bfloat16)
    chunks = [t.reshape(b, n, h, d).transpose(1, 2) for t in x.chunk(3, -1)]
    assert all(fa.layout_fault(t) is None for t in chunks)
    assert "unit stride" in fa.layout_fault(chunks[0].transpose(2, 3))
    assert "unit stride" in fa.layout_fault(
        torch.ones(()).expand(b, h, n, d))
    odd = torch.zeros(b, h, n, d + 1, dtype=torch.bfloat16)[..., :d]
    assert "misaligned" in fa.layout_fault(odd)  # 34-byte rows
    assert fa.layout_fault(odd.float()) is None  # fp32 rows: 4-byte pieces


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tolerances_follow_the_dtype(dtype):
    """fp32 kernels are held to atol + rtol·|plain|, bf16 ones to their
    error bound: one definition for the card tests and chip_smoke.py."""
    shape, scale = (2, 2, 37, 16), 0.25
    q, k, v, dout = (torch.from_numpy(a).to(dtype)
                     for a in qkv(shape, seed=3) + qkv(shape, seed=4)[:1])
    out, lse = fa.flash_attention_plain(q, k, v, scale)
    grads = fa.flash_attention_backward_plain(q, k, v, out, lse, dout, scale)
    fwd = fa.forward_tolerance(q, k, v, scale, out)
    bwd = fa.backward_tolerance(q, k, v, out, lse, dout, scale, grads)
    if dtype == torch.float32:
        atol, rtol = fa.FWD_TOL_FP32
        torch.testing.assert_close(fwd, atol + rtol * out.abs())
        atol, rtol = fa.BWD_TOL_FP32
        want = [atol + rtol * g.abs() for g in grads]
    else:
        torch.testing.assert_close(fwd, fa.forward_error_bound(q, k, v,
                                                               scale))
        want = fa.backward_error_bound(q, k, v, out, lse, dout, scale)
    for got, w in zip(bwd, want):
        assert got.dtype == torch.float32
        torch.testing.assert_close(got, w)


def emulate_forward_bf16(q, k, v, scale, block=64):
    """The bf16 forward kernel's rounding, in plain fp32 PyTorch: fp32
    scores of bf16 operands, the online softmax over 64-key tiles, each
    tile's probabilities rounded to bf16 before P V, fp32 sums, the
    output rounded to bf16."""
    qf, kf, vf = (t.float() for t in (q, k, v))
    s = torch.einsum("bhnd,bhmd->bhnm", qf, kf) * scale
    m = torch.full(s.shape[:-1] + (1,), -np.inf)
    l, acc = torch.zeros_like(m), torch.zeros_like(qf)
    for k0 in range(0, s.shape[-1], block):
        tile = s[..., k0:k0 + block]
        m_new = torch.maximum(m, tile.amax(dim=-1, keepdim=True))
        corr = torch.exp(m - m_new)
        p = torch.exp(tile - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + p.bfloat16().float() @ vf[..., k0:k0 + block, :]
        m = m_new
    return (acc / l).bfloat16()


def emulate_backward_bf16(q, k, v, out, lse, dout, scale):
    """The bf16 backward kernels' rounding: P and dS computed in fp32 and
    rounded to bf16 as the operands of dV, dK and dQ; results in bf16."""
    qf, kf, vf, dof = (t.float() for t in (q, k, v, dout))
    delta = (dof * out.float()).sum(dim=-1, keepdim=True)
    p = torch.exp(torch.einsum("bhnd,bhmd->bhnm", qf, kf) * scale
                  - lse.unsqueeze(-1))
    ds = p * (dof @ vf.transpose(-1, -2) - delta)
    pb, dsb = p.bfloat16().float(), ds.bfloat16().float()
    return ((dsb @ kf * scale).bfloat16(),
            (dsb.transpose(-1, -2) @ qf * scale).bfloat16(),
            (pb.transpose(-1, -2) @ dof).bfloat16())


@pytest.mark.parametrize("magnitude", [1.0, 8.0])
@pytest.mark.parametrize("d", [64, 100])
@pytest.mark.parametrize("n", [101, 257])
def test_error_bounds_hold_for_the_kernels_bf16_rounding(n, d, magnitude):
    """An emulation of where the bf16 kernels round (P and dS as
    tensor-core operands) stays within forward_error_bound and
    backward_error_bound of the plain versions, the tolerances the card
    tests and chip_smoke.py hold the kernels to."""
    scale = d ** -0.5
    worst = 0.0
    for seed in (11, 12):
        q, k, v, dout = (torch.from_numpy(magnitude * a).bfloat16()
                         for a in qkv((2, 2, n, d), seed) + qkv(
                             (2, 2, n, d), seed + 100)[:1])
        ref_out, lse = fa.flash_attention_plain(q, k, v, scale)
        out = emulate_forward_bf16(q, k, v, scale)
        ratio = ((out.float() - ref_out.float()).abs()
                 / fa.forward_error_bound(q, k, v, scale)).max().item()
        assert ratio <= 1, f"out at {ratio} of the bound"
        worst = max(worst, ratio)
        want = fa.flash_attention_backward_plain(q, k, v, out, lse, dout,
                                                 scale)
        got = emulate_backward_bf16(q, k, v, out, lse, dout, scale)
        bounds = fa.backward_error_bound(q, k, v, out, lse, dout, scale)
        for name, g, w, b in zip("qkv", got, want, bounds):
            ratio = ((g.float() - w.float()).abs() / b).max().item()
            assert ratio <= 1, f"d{name} at {ratio} of the bound"
            worst = max(worst, ratio)
    assert worst > 0  # the rounding shows, and the bound is not vacuous


def tf32(x):
    """x rounded to TF32 as ``cvt.rna.tf32.f32`` rounds it: to the nearest
    value with 10 mantissa bits, ties away from zero (on the int32 view of
    the fp32 bits: add half of the 13 dropped bits, then clear them)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_tf32(x):
    """x = hi + lo as the fp32 kernels split it: hi rounded to TF32, lo the
    exact rest, which the tensor core reads truncated to TF32 (its top 19
    bits)."""
    hi = tf32(x)
    lo = (x - hi).contiguous().view(torch.int32) & -0x2000
    return hi, lo.view(torch.float32)


def mm_tf32x3(a, b):
    """``a @ b`` as the fp32 kernels form it: each operand split into TF32
    hi and lo parts, lo·hi + hi·lo + hi·hi (lo·lo dropped), fp32 sums."""
    a_hi, a_lo = split_tf32(a)
    b_hi, b_lo = split_tf32(b)
    return (a_lo @ b_hi + a_hi @ b_lo) + a_hi @ b_hi


def emulate_forward_tf32x3(q, k, v, scale, block=64):
    """The fp32 forward kernel's arithmetic: S = Q Kᵀ and P V in 3xTF32,
    the online softmax over 64-key tiles in fp32. Returns (out, lse)."""
    s = mm_tf32x3(q, k.transpose(-1, -2)) * scale
    m = torch.full(s.shape[:-1] + (1,), -np.inf)
    l, acc = torch.zeros_like(m), torch.zeros_like(q)
    for k0 in range(0, s.shape[-1], block):
        tile = s[..., k0:k0 + block]
        m_new = torch.maximum(m, tile.amax(dim=-1, keepdim=True))
        corr = torch.exp(m - m_new)
        p = torch.exp(tile - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + mm_tf32x3(p, v[..., k0:k0 + block, :])
        m = m_new
    return acc / l, (m + torch.log(l)).squeeze(-1)


def emulate_backward_tf32x3(q, k, v, out, lse, dout, scale):
    """The fp32 backward kernels' arithmetic: Δ, P and dS in fp32, every
    product (S, dP, dV, dQ, dK) in 3xTF32."""
    delta = (dout * out).sum(dim=-1, keepdim=True)
    p = torch.exp(mm_tf32x3(q, k.transpose(-1, -2)) * scale
                  - lse.unsqueeze(-1))
    ds = p * (mm_tf32x3(dout, v.transpose(-1, -2)) - delta)
    return (mm_tf32x3(ds, k) * scale,
            mm_tf32x3(ds.transpose(-1, -2), q) * scale,
            mm_tf32x3(p.transpose(-1, -2), dout))


# the fp32 rows of chip_smoke.py phase 2 and tests/test_torch_cuda.py at
# batch 1-2: the serving and training shape (also one head of it, and the
# strided case, which reads the same values), N = 1000, D = 100 and 128,
# and a single row
FP32_SHAPES = [(2, 3, 101, 64), (1, 3, 1000, 64), (2, 4, 257, 100),
               (1, 1, 130, 128), (1, 2, 1, 8)]


def fp32_inputs(shape, magnitude, seed):
    q, k, v = qkv(shape, seed)
    dout = qkv(shape, seed + 100)[0]
    return [torch.from_numpy(magnitude * a) for a in (q, k, v)] + [
        torch.from_numpy(dout)]


@pytest.mark.parametrize("magnitude", [0.25, 1.0])
@pytest.mark.parametrize("shape", FP32_SHAPES)
def test_tf32x3_split_holds_the_fp32_tolerances(shape, magnitude):
    """An emulation of the fp32 kernels' 3xTF32 products stays within
    forward_tolerance, LSE_ATOL and backward_tolerance of the plain
    versions at the shapes the card checks, with inputs at the scale of
    those checks (unit normal) and below; the plain versions still match
    the JAX flash forward and backward there (Pallas in interpret mode, N
    cut to 300)."""
    scale = shape[-1] ** -0.5
    q, k, v, dout = fp32_inputs(shape, magnitude, seed=21)
    ref_out, ref_lse = fa.flash_attention_plain(q, k, v, scale)
    out, lse = emulate_forward_tf32x3(q, k, v, scale)
    ratio = ((out - ref_out).abs() / fa.forward_tolerance(
        q, k, v, scale, ref_out)).max().item()
    assert ratio <= 1, f"out at {ratio} of the tolerance"
    assert (lse - ref_lse).abs().max().item() <= fa.LSE_ATOL
    want = fa.flash_attention_backward_plain(q, k, v, out, lse, dout, scale)
    got = emulate_backward_tf32x3(q, k, v, out, lse, dout, scale)
    tols = fa.backward_tolerance(q, k, v, out, lse, dout, scale, want)
    for name, g, w, t in zip("qkv", got, want, tols):
        ratio = ((g - w).abs() / t).max().item()
        assert ratio <= 1, f"d{name} at {ratio} of the tolerance"

    cut = [a[:, :, :300] for a in (q, k, v, dout)]
    jq, jk, jv = (jnp.asarray(a.numpy()) for a in cut[:3])
    j_out, j_lse = _flash_forward(jq, jk, jv, scale, None, None, True)
    p_out, p_lse = fa.flash_attention_plain(*cut[:3], scale)
    np.testing.assert_allclose(p_out.numpy(), np.asarray(j_out), atol=1e-5)
    np.testing.assert_allclose(p_lse.numpy(), np.asarray(j_lse), atol=1e-5)
    p_grads = fa.flash_attention_backward_plain(*cut[:3], p_out, p_lse,
                                                cut[3], scale)
    for name, got, want in zip("qkv", p_grads, jax_flash_grads(
            *(a.numpy() for a in cut), scale)):
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-4,
                                   err_msg=f"d{name}")


def attention64(q, k, v, dout, scale):
    """out, lse and dq, dk, dv in float64: the truth both fp32
    computations are measured against."""
    q, k, v, dout = (t.double() for t in (q, k, v, dout))
    s = q @ k.transpose(-1, -2) * scale
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse.unsqueeze(-1))
    out = p @ v
    ds = p * (dout @ v.transpose(-1, -2)
              - (dout * out).sum(dim=-1, keepdim=True))
    return (out, lse, ds @ k * scale, ds.transpose(-1, -2) @ q * scale,
            p.transpose(-1, -2) @ dout)


@pytest.mark.parametrize("magnitude", [1.0, 4.0])
@pytest.mark.parametrize("shape", FP32_SHAPES[:-1])
def test_tf32x3_split_is_as_accurate_as_fp32(shape, magnitude):
    """Against a float64 truth, the 3xTF32 emulation's forward and
    gradients are off by at most three times what the plain fp32 versions
    are off (plus four fp32 ulps of the largest value), at either input
    scale: the split keeps fp32's accuracy, not TF32's. At magnitude 4 both
    miss the fp32 atol of 1e-5, which does not scale with the inputs
    (scores of standard deviation 16). Not at N = 1, where the plain
    softmax is exact."""
    scale = shape[-1] ** -0.5
    q, k, v, dout = fp32_inputs(shape, magnitude, seed=22)
    truth = attention64(q, k, v, dout, scale)
    plain_out, plain_lse = fa.flash_attention_plain(q, k, v, scale)
    plain = (plain_out, plain_lse) + fa.flash_attention_backward_plain(
        q, k, v, plain_out, plain_lse, dout, scale)
    emu_out, emu_lse = emulate_forward_tf32x3(q, k, v, scale)
    emu = (emu_out, emu_lse) + emulate_backward_tf32x3(
        q, k, v, emu_out, emu_lse, dout, scale)
    for name, t, p, e in zip(("out", "lse", "dq", "dk", "dv"), truth, plain,
                             emu):
        err_plain = (p.double() - t).abs().max().item()
        err_emu = (e.double() - t).abs().max().item()
        ulp = 2.0 ** -24 * t.abs().max().item()
        assert err_emu <= 3 * err_plain + 4 * ulp, (
            f"{name}: 3xTF32 off by {err_emu}, fp32 by {err_plain}")
