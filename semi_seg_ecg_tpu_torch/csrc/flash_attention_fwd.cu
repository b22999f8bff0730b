// Flash-attention forward for NVIDIA Hopper (sm_90a), bf16 and fp32 inputs.
//
// Replaces the TPU kernel semi_seg_ecg_tpu/ops/pallas/flash_attention.py
// `_fwd_kernel` (launched by `_flash_forward`): out = softmax(q kᵀ · scale) v
// with an online softmax, so the (N, N) score matrix never reaches device
// memory, plus the fp32 row logsumexp `lse` that the backward consumes. Key
// columns >= N are masked to -inf, as `_fwd_kernel` masks them. q, k, v and
// out are (B, H, N, D) operands in any layout whose last dimension has
// stride 1 (the strides of B, H and N are arguments: the ViT hands over the
// transposed chunks of its qkv projection as they are, and the wrapper
// allocates out as (B, N, H, D) memory); lse is (B·H, N) fp32.
//
// What bounds it on an H100 (3.35 TB/s; 989 TFLOP/s bf16 on the tensor
// cores, 67 TFLOP/s fp32 outside them). At the training student pass, bf16
// (B=32, H=3, N=101, D=64), the work is 0.25 GFLOP over 5.0 MB moved: the
// bound is 1.49 us of memory (0.25 us of tensor-core time). On an NVIDIA
// H100 80GB HBM3 at 700.00 W (chip_smoke.py phase 2; PERF.md §6) this
// kernel takes 7.7 us there, against 24.0 us for the CUDA-core kernel it
// replaces (and 7.1-7.2 us for SDPA), and 0.519 ms at (8, 12, 2048, 64),
// against 3.67-3.74 ms (199 TFLOP/s; SDPA 0.23 ms).
//
// In fp32 the card's fastest fp32-accurate product is three TF32 products
// (495 / 3 = 165 TFLOP/s). At the serving shape, fp32 (16, 3, 101, 64), the
// work is 0.125 GFLOP over 5.0 MB: the bound is 1.49 us of memory (0.76 us
// of 3xTF32 time). On the same card (chip_smoke.py phase 2, parent and this
// kernel in one call; PERF.md §6) flash_fwd_fp32 takes 10.6 us there,
// against 15.6 us for the CUDA-core kernel it replaces (SDPA 16.9 us), and
// 88 us at (4, 3, 1000, 64), against 160.5 us (35 TFLOP/s of fp32-accurate
// products; SDPA 148 us).
//
// bf16 design (flash_fwd_mma). One CTA of 4 warps per (batch·head, 64-row
// q tile), 16 q rows per warp (32-row tiles of 2 warps, twice the CTAs,
// were 6.5% slower at the training shape on that card: 8.19 against
// 7.68 us, PERF.md):
//   - the tensor cores: S = Q Kᵀ and O += P V are mma.sync m16n8k16 with bf16
//     operands and fp32 accumulators. Q's fragments are loaded once with
//     ldmatrix and stay in registers for the whole key loop; K fragments
//     come through ldmatrix, V's through ldmatrix.trans.
//   - the softmax runs on the fp32 S fragments, in base 2: scale·log2(e) is
//     applied to fp32 S (never to bf16 Q, which would round it when scale is
//     not a power of two, as at D = 100). A row is spread over the four
//     lanes of a quad, so a row max is two __shfl_xor_sync; the row sum is
//     kept per lane and reduced once at the end.
//   - P is rounded to bf16 in registers and fed straight back as the A
//     operand of P V: the accumulator layout of two 16x8 tiles is the A
//     layout of one 16x16 tile, so P never touches shared memory.
//   - the load latency: K/V tiles of 64 keys stream through a 2-stage ring
//     in shared memory with cp.async (16 bytes a thread where the operand's
//     base and strides allow it, else 4), so tile kb+1 loads while tile kb
//     computes; at N = 101 the Q tile and both K/V tiles are in flight at
//     once. Rows are padded by 16 bytes, which puts the 8 rows an ldmatrix
//     reads on distinct banks. Rows and keys >= N and columns >= D are
//     zero-filled by the copy's src-size; D is rounded up to a multiple of
//     16 (64 or 128) for the k-steps.
//
// fp32 design (flash_fwd_fp32): the same CTA, pipeline and online softmax
// on the tensor cores, with every product in 3xTF32 (flash_common.cuh):
//   - S = Q Kᵀ and O += P V are mma.sync m16n8k8 with tf32 operands and fp32
//     accumulators, three per product (lo·hi, hi·lo, hi·hi of the split
//     operands), so the results keep fp32's accuracy, not TF32's. The split
//     is the kernel's own contract, independent of the TF32 flags of cuBLAS
//     and cuDNN (algorithms/common.full_fp32).
//   - the three products of the 8 n-tiles of a k-step are issued as three
//     passes over the tiles, so no mma waits on the one before it: in the
//     first design each tile's three products were chained, and at the
//     serving shape (one warp per scheduler, nothing else to issue) the
//     kernel took 23.8 us; with this order, the split of flash_common.cuh
//     and an unguarded k-step loop it takes 10.6 us (PERF.md §6).
//   - P from registers: the m16n8k8 accumulator gives a lane columns 2t and
//     2t+1, the A operand wants t and t+4. P V contracts over the keys, so
//     the keys are relabelled instead of shuffled: C's column 2t is A's
//     column t, 2t+1 is t+4, and V's rows are read in that order.
//   - fragments: Q's (A) and K's (B of S) come through ldmatrix.x4, whose
//     8 x 16-byte matrices are 8 x 4 fp32 quarters of a tf32 fragment; V's
//     relabelled rows are plain 32-bit loads. Rows of D + 4 floats put every
//     load on distinct banks. All operands are split in registers as they
//     are read: hi and lo in shared memory would double K/V and leave one
//     CTA per SM (87,040 bytes now at D = 64, two per SM).
//   - K/V tiles stream through the 2-stage cp.async ring as in bf16;
//     columns >= D are zero-filled, and every k-step of DMAX runs.
//   - scale·log2(e) multiplies fp32 S; Q is not pre-scaled.

#include <initializer_list>
#include <math.h>

#include "flash_common.cuh"

namespace {

using bf16 = __nv_bfloat16;
using flash::head_offset;
using flash::LN2;
using flash::LOG2E;

constexpr int BLOCK_N = 64;  // keys per streamed K/V tile

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int WARPS = 4;
constexpr int BM = WARPS * 16;  // q rows per CTA
constexpr int MMA_THREADS = WARPS * 32;

template <int DMAX>
constexpr size_t mma_smem_bytes() {
  // q tile, then two stages of k and v tiles, rows padded by 8 elements
  return sizeof(bf16) * (BM + 4 * BLOCK_N) * (DMAX + 8);
}

template <int DMAX>
__global__ void __launch_bounds__(MMA_THREADS)
flash_fwd_mma(Tensor4 q, Tensor4 k, Tensor4 v, Tensor4 o,
              float* __restrict__ lse, int heads, int nq, int nkv, int d,
              float scale_log2, bool vec16) {
  constexpr int LD = DMAX + 8;    // padded row, in elements
  constexpr int KS = DMAX / 16;   // k-steps over the head dim
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [BM][LD]
  bf16* ks = qs + BM * LD;                        // [2][BLOCK_N][LD]
  bf16* vs = ks + 2 * BLOCK_N * LD;               // [2][BLOCK_N][LD]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = lane & 3;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BM;
  const int wrow = warp * 16;
  const bf16* qh = static_cast<const bf16*>(q.ptr) + head_offset(q, bh, heads);
  const bf16* kh = static_cast<const bf16*>(k.ptr) + head_offset(k, bh, heads);
  const bf16* vh = static_cast<const bf16*>(v.ptr) + head_offset(v, bh, heads);
  const int num_kb = (nkv + BLOCK_N - 1) / BLOCK_N;

  // group 0: the q tile and K/V tile 0; group 1: K/V tile 1 (maybe empty)
  flash::load_tile<BM, DMAX, LD, MMA_THREADS>(qs, qh, q.sn, q0, nq, d, vec16);
  for (int kb = 0; kb < 2; ++kb) {
    if (kb < num_kb) {
      flash::load_tile<BLOCK_N, DMAX, LD, MMA_THREADS>(
          ks + kb * BLOCK_N * LD, kh, k.sn, kb * BLOCK_N, nkv, d, vec16);
      flash::load_tile<BLOCK_N, DMAX, LD, MMA_THREADS>(
          vs + kb * BLOCK_N * LD, vh, v.sn, kb * BLOCK_N, nkv, d, vec16);
    }
    flash::cp_async_commit();
  }
  flash::cp_async_wait<1>();
  __syncthreads();

  // a warp whose 16 rows all lie past N only helps with the loads
  const bool live = q0 + wrow < nq;
  uint32_t qf[KS][4];
  if (live) {
#pragma unroll
    for (int s = 0; s < KS; ++s)
      flash::ldmatrix_x4(qf[s], &qs[(wrow + (lane & 15)) * LD + 16 * s +
                                    (lane >> 4) * 8]);
  }

  float m[2] = {-INFINITY, -INFINITY};  // running max, base-2 units
  float l[2] = {0.f, 0.f};              // this lane's part of the row sum
  float acc[DMAX / 8][4];
#pragma unroll
  for (int j = 0; j < DMAX / 8; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int kb = 0; kb < num_kb; ++kb) {
    if (kb > 0) {
      flash::cp_async_wait<1>();  // tile kb has landed; kb+1 may be in flight
      __syncthreads();
    }
    const bf16* kt = ks + (kb & 1) * BLOCK_N * LD;
    const bf16* vt = vs + (kb & 1) * BLOCK_N * LD;
    const int k0 = kb * BLOCK_N;
    if (live) {
      // S = Q Kᵀ: 16 rows x 64 keys, 8 C tiles
      float s[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int st = 0; st < KS; ++st) {
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          uint32_t b[4];
          flash::ldmatrix_x4(
              b, &kt[(16 * p + (lane & 7) + ((lane >> 4) << 3)) * LD +
                     16 * st + ((lane >> 3) & 1) * 8]);
          flash::mma_bf16(s[2 * p], qf[st], b[0], b[1]);
          flash::mma_bf16(s[2 * p + 1], qf[st], b[2], b[3]);
        }
      }
      // scale in fp32, then mask the keys past N
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] *= scale_log2;
      }
      if (k0 + BLOCK_N > nkv) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if (k0 + 8 * j + 2 * t + e >= nkv) s[j][e] = s[j][2 + e] = -INFINITY;
          }
        }
      }
      // online softmax over rows g (e = 0, 1) and g + 8 (e = 2, 3); the
      // tile holds key k0 < N, so both maxima are finite and exp2(-inf)
      // clears the masked keys and the first tile's correction
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
      }
      float corr[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float m_new = fmaxf(m[i], mx[i]);
        corr[i] = exp2f(m[i] - m_new);
        m[i] = m_new;
        l[i] *= corr[i];
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = exp2f(s[j][e] - m[e >> 1]);
          l[e >> 1] += s[j][e];
        }
      }
#pragma unroll
      for (int j = 0; j < DMAX / 8; ++j) {
        acc[j][0] *= corr[0];
        acc[j][1] *= corr[0];
        acc[j][2] *= corr[1];
        acc[j][3] *= corr[1];
      }
      // O += P V, P from registers as bf16
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t a[4];
        flash::c_to_a(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
        for (int p = 0; p < DMAX / 16; ++p) {
          uint32_t b[4];
          flash::ldmatrix_x4_trans(
              b, &vt[(16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                     16 * p + (lane >> 4) * 8]);
          flash::mma_bf16(acc[2 * p], a, b[0], b[1]);
          flash::mma_bf16(acc[2 * p + 1], a, b[2], b[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with this stage
    if (kb + 2 < num_kb) {
      flash::load_tile<BLOCK_N, DMAX, LD, MMA_THREADS>(
          ks + (kb & 1) * BLOCK_N * LD, kh, k.sn, (kb + 2) * BLOCK_N, nkv, d,
          vec16);
      flash::load_tile<BLOCK_N, DMAX, LD, MMA_THREADS>(
          vs + (kb & 1) * BLOCK_N * LD, vh, v.sn, (kb + 2) * BLOCK_N, nkv, d,
          vec16);
    }
    flash::cp_async_commit();
  }

  if (!live) return;
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    l[i] = fmaxf(l[i], 1e-30f);
    inv[i] = 1.f / l[i];
  }
  bf16* oh = static_cast<bf16*>(o.ptr) + head_offset(o, bh, heads);
  flash::store_rows<DMAX>(oh, o.sn, acc, q0 + wrow, nq, d, inv[0], inv[1]);
  if (t == 0) {
    const int g = lane >> 2;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = q0 + wrow + g + 8 * i;
      if (r < nq) lse[(size_t)bh * nq + r] = m[i] * LN2 + logf(l[i]);
    }
  }
}

template <int DMAX>
cudaError_t launch_mma(const Tensor4& q, const Tensor4& k, const Tensor4& v,
                       const Tensor4& o, float* lse, int bh, int heads, int nq,
                       int nkv, int d, float scale, cudaStream_t stream) {
  // the attribute belongs to the current device, so it is set on every
  // launch rather than cached once per process
  constexpr size_t smem = mma_smem_bytes<DMAX>();
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_mma<DMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const bool vec16 = flash::aligned_to(q, 2, 16) &&
                     flash::aligned_to(k, 2, 16) &&
                     flash::aligned_to(v, 2, 16);
  const dim3 grid((nq + BM - 1) / BM, bh);
  flash_fwd_mma<DMAX><<<grid, MMA_THREADS, smem, stream>>>(
      q, k, v, o, lse, heads, nq, nkv, d, scale * LOG2E, vec16);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// fp32: tensor cores, 3xTF32
// ---------------------------------------------------------------------------

template <int DMAX>
constexpr size_t fp32_smem_bytes() {
  // q tile, then two stages of k and v tiles, rows padded by 4 floats
  return sizeof(float) * (BM + 4 * BLOCK_N) * (DMAX + 4);
}

template <int DMAX>
__global__ void __launch_bounds__(MMA_THREADS)
flash_fwd_fp32(Tensor4 q, Tensor4 k, Tensor4 v, Tensor4 o,
               float* __restrict__ lse, int heads, int nq, int nkv, int d,
               float scale_log2, bool vec16) {
  constexpr int LD = DMAX + 4;   // padded row, in floats (4 modulo 32)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);  // [BM][LD]
  float* ks = qs + BM * LD;                         // [2][BLOCK_N][LD]
  float* vs = ks + 2 * BLOCK_N * LD;                // [2][BLOCK_N][LD]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = lane & 3;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BM;
  const int wrow = warp * 16;
  const float* qh = static_cast<const float*>(q.ptr) + head_offset(q, bh, heads);
  const float* kh = static_cast<const float*>(k.ptr) + head_offset(k, bh, heads);
  const float* vh = static_cast<const float*>(v.ptr) + head_offset(v, bh, heads);
  const int num_kb = (nkv + BLOCK_N - 1) / BLOCK_N;

  // group 0: the q tile and K/V tile 0; group 1: K/V tile 1 (maybe empty)
  flash::load_tile<BM, DMAX, LD, MMA_THREADS>(qs, qh, q.sn, q0, nq, d, vec16);
  for (int kb = 0; kb < 2; ++kb) {
    if (kb < num_kb) {
      flash::load_tile<BLOCK_N, DMAX, LD, MMA_THREADS>(
          ks + kb * BLOCK_N * LD, kh, k.sn, kb * BLOCK_N, nkv, d, vec16);
      flash::load_tile<BLOCK_N, DMAX, LD, MMA_THREADS>(
          vs + kb * BLOCK_N * LD, vh, v.sn, kb * BLOCK_N, nkv, d, vec16);
    }
    flash::cp_async_commit();
  }
  flash::cp_async_wait<1>();
  __syncthreads();

  // a warp whose 16 rows all lie past N only helps with the loads
  const bool live = q0 + wrow < nq;

  float m[2] = {-INFINITY, -INFINITY};  // running max, base-2 units
  float l[2] = {0.f, 0.f};              // this lane's part of the row sum
  float acc[DMAX / 8][4];
#pragma unroll
  for (int j = 0; j < DMAX / 8; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int kb = 0; kb < num_kb; ++kb) {
    if (kb > 0) {
      flash::cp_async_wait<1>();  // tile kb has landed; kb+1 may be in flight
      __syncthreads();
    }
    const float* kt = ks + (kb & 1) * BLOCK_N * LD;
    const float* vt = vs + (kb & 1) * BLOCK_N * LD;
    const int k0 = kb * BLOCK_N;
    if (live) {
      // S = Q Kᵀ: 16 rows x 64 keys, 8 C tiles
      float s[8][4];
      flash::gemm_abt_tf32x3<DMAX, LD>(s, qs + wrow * LD, kt, lane);
      // scale in fp32, then mask the keys past N
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] *= scale_log2;
      }
      if (k0 + BLOCK_N > nkv) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if (k0 + 8 * j + 2 * t + e >= nkv) s[j][e] = s[j][2 + e] = -INFINITY;
          }
        }
      }
      // online softmax over rows g (e = 0, 1) and g + 8 (e = 2, 3), as in
      // flash_fwd_mma
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
      }
      float corr[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float m_new = fmaxf(m[i], mx[i]);
        corr[i] = exp2f(m[i] - m_new);
        m[i] = m_new;
        l[i] *= corr[i];
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = exp2f(s[j][e] - m[e >> 1]);
          l[e >> 1] += s[j][e];
        }
      }
#pragma unroll
      for (int j = 0; j < DMAX / 8; ++j) {
        acc[j][0] *= corr[0];
        acc[j][1] *= corr[0];
        acc[j][2] *= corr[1];
        acc[j][3] *= corr[1];
      }
      // O += P V, P split from registers with the keys relabelled
      flash::gemm_cb_tf32x3<DMAX, LD>(acc, s, vt, lane);
    }
    __syncthreads();  // every warp is done with this stage
    if (kb + 2 < num_kb) {
      flash::load_tile<BLOCK_N, DMAX, LD, MMA_THREADS>(
          ks + (kb & 1) * BLOCK_N * LD, kh, k.sn, (kb + 2) * BLOCK_N, nkv, d,
          vec16);
      flash::load_tile<BLOCK_N, DMAX, LD, MMA_THREADS>(
          vs + (kb & 1) * BLOCK_N * LD, vh, v.sn, (kb + 2) * BLOCK_N, nkv, d,
          vec16);
    }
    flash::cp_async_commit();
  }

  if (!live) return;
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    l[i] = fmaxf(l[i], 1e-30f);
    inv[i] = 1.f / l[i];
  }
  float* oh = static_cast<float*>(o.ptr) + head_offset(o, bh, heads);
  flash::store_rows<DMAX>(oh, o.sn, acc, q0 + wrow, nq, d, inv[0], inv[1]);
  if (t == 0) {
    const int g = lane >> 2;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = q0 + wrow + g + 8 * i;
      if (r < nq) lse[(size_t)bh * nq + r] = m[i] * LN2 + logf(l[i]);
    }
  }
}

template <int DMAX>
cudaError_t launch_fp32(const Tensor4& q, const Tensor4& k, const Tensor4& v,
                        const Tensor4& o, float* lse, int bh, int heads,
                        int nq, int nkv, int d, float scale,
                        cudaStream_t stream) {
  constexpr size_t smem = fp32_smem_bytes<DMAX>();
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_fp32<DMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const bool vec16 = flash::aligned_to(q, 4, 16) &&
                     flash::aligned_to(k, 4, 16) &&
                     flash::aligned_to(v, 4, 16);
  const dim3 grid((nq + BM - 1) / BM, bh);
  flash_fwd_fp32<DMAX><<<grid, MMA_THREADS, smem, stream>>>(
      q, k, v, o, lse, heads, nq, nkv, d, scale * LOG2E, vec16);
  return cudaGetLastError();
}

}  // namespace

// C interface for ctypes. Returns a cudaError_t (0 on success). q, k, v and
// out are (batch, heads, n, d) descriptors with unit stride along d: q and
// out hold nq rows, k and v nkv rows (keys >= nkv are masked, so the tensors
// may hold more: a ring hop's padded chunk); lse is (batch·heads, nq) fp32.
// dtype: 0 is fp32, 1 is bf16; a bf16 operand needs a 4-byte aligned base
// and even strides. The caller allocates out and lse.
extern "C" int flash_attention_fwd(const Tensor4* q, const Tensor4* k,
                                   const Tensor4* v, const Tensor4* out,
                                   void* lse, int batch, int heads, int nq,
                                   int nkv, int d, float scale, int dtype,
                                   void* stream) {
  const long long bh = (long long)batch * heads;
  if (batch <= 0 || heads <= 0 || bh > 65535 || nq <= 0 || nkv <= 0 ||
      d <= 0 || d > 128 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  const Tensor4 &qq = *q, &kk = *k, &vv = *v, &oo = *out;
  if (dtype == 0) {
    return (int)(d <= 64
        ? launch_fp32<64>(qq, kk, vv, oo, l, (int)bh, heads, nq, nkv, d,
                          scale, s)
        : launch_fp32<128>(qq, kk, vv, oo, l, (int)bh, heads, nq, nkv, d,
                           scale, s));
  }
  for (const Tensor4* t : {q, k, v, out}) {
    if (!flash::aligned_to(*t, 2, 4)) return (int)cudaErrorMisalignedAddress;
  }
  return (int)(d <= 64
      ? launch_mma<64>(qq, kk, vv, oo, l, (int)bh, heads, nq, nkv, d, scale,
                       s)
      : launch_mma<128>(qq, kk, vv, oo, l, (int)bh, heads, nq, nkv, d, scale,
                        s));
}
