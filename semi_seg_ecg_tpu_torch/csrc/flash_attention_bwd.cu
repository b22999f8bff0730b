// Flash-attention backward for NVIDIA Hopper (sm_90a), bf16 and fp32 inputs.
//
// Replaces the TPU kernel semi_seg_ecg_tpu/ops/pallas/flash_attention.py
// `_bwd_kernel` (launched by `_flash_backward`, the custom VJP's backward).
// From q, k, v, the forward's out and row logsumexp `lse`, and the output
// gradient dO it recomputes the probabilities blockwise and forms
//
//   Δ  = rowsum(dO ⊙ O)
//   P  = exp(S − lse),  S = q kᵀ · scale
//   dV = Pᵀ dO,  dP = dO Vᵀ,  dS = P ⊙ (dP − Δ)
//   dQ = dS K · scale,  dK = dSᵀ Q · scale
//
// without the (N, N) matrices in device memory. Queries and keys have
// their own counts, nq and nkv (a ring attention's hop: this rank's queries
// against a visiting chunk of keys, with the merged out and lse of the whole
// ring). Rows >= nq and keys >= nkv are masked (P = 0 there, as `_bwd_kernel` masks with `row_valid` and
// `col < n_valid`). Operands are (B, H, N, D) in any layout with unit stride
// along D (the strides of B, H, N are arguments; the wrapper allocates dq,
// dk, dv as (B, N, H, D) memory, the layout the ViT's qkv projection takes
// its gradient in); lse and Δ are (B·H, N) fp32. Gradients are stored in the
// input dtype, as the Pallas kernel's fp32 results are cast back.
//
// Two kernels, so that no gradient is summed across CTAs with atomics and
// every result is deterministic: a dQ kernel, one CTA per (b·h, 64-query
// tile), and a dK/dV kernel, one CTA per (b·h, 64-key tile). Both recompute
// S and dP: 10·B·H·N²·D flops in all, against the forward's 4·B·H·N²·D.
//
// What bounds it on an H100 (3.35 TB/s; 989 TFLOP/s bf16 on the tensor
// cores, 67 TFLOP/s fp32 outside them). At the training student pass, bf16
// (B=32, H=3, N=101, D=64), 0.63 GFLOP over 10 MB moved (q, k, v, o, dO
// read, dq, dk, dv written): the bound is 2.98 us of memory (0.63 us of
// tensor-core time). On an NVIDIA H100 80GB HBM3 at 700.00 W
// (chip_smoke.py phase 2; PERF.md §6) the two kernels take 20.5 us there,
// Δ included, against 85.4-85.9 us for the CUDA-core kernels they replace
// with Δ in PyTorch (SDPA's backward: 18.1 us), and 1.71 ms at
// (8, 12, 2048, 64), against 11.63 ms (151 TFLOP/s; SDPA 0.65 ms).
//
// In fp32 (3xTF32, 165 TFLOP/s of fp32-accurate products) the training
// shape moves 19.9 MB and does 0.63 GFLOP: the bound is 5.94 us of memory
// (3.8 us of 3xTF32 time). On the same card (chip_smoke.py phase 2, parent
// and these kernels in one call; PERF.md §6) the fp32 kernels take 52.5 us
// there, Δ included, against 75.8-76.0 us for the CUDA-core kernels with Δ
// in PyTorch (SDPA's backward 59.1-71.4 us), and 340 us at
// (4, 3, 1000, 64), against 498.5 us (23 TFLOP/s; SDPA 336-338 us).
//
// bf16 design (flash_bwd_dq_mma, then flash_bwd_dkdv_mma; 4 warps, 16 rows
// or keys per warp):
//   - every product is mma.sync m16n8k16 with bf16 operands and fp32
//     accumulators: S and dP, then dQ += dS K in the dQ kernel; Sᵀ = K Qᵀ
//     and dPᵀ = V dOᵀ, then dV += Pᵀ dO and dK += dSᵀ Q in the dK/dV kernel.
//     Computing the transposed scores there makes Pᵀ and dSᵀ come out of the
//     accumulators in the A layout of the next product, so P and dS stay in
//     registers in both kernels (rounded to bf16 as operands, fp32 for dS =
//     P (dP − Δ)); no operand is staged transposed through shared memory:
//     the B operands that need it come through ldmatrix.trans.
//   - Δ moves into the dQ kernel, launched first: each query tile streams
//     an O tile in with its q, dO and first K/V tiles, sums dO ⊙ O for its
//     rows in fp32 from shared memory, keeps Δ, and stores it for the dK/dV
//     kernel, which streams it with lse.
//   - the load latency: the streamed tiles (K, V in the dQ kernel; Q, dO,
//     lse, Δ in the dK/dV kernel) pass through a 2-stage cp.async ring, so
//     tile j+1 loads while tile j computes; rows padded by 16 bytes keep
//     ldmatrix free of bank conflicts; rows >= N and columns >= D are
//     zero-filled by the copy's src-size, D is rounded up to 64 or 128.
//   - scale·log2(e) multiplies the fp32 scores, and P = exp2(S' − lse·log2 e).
//
// fp32 design (flash_bwd_dq_fp32, then flash_bwd_dkdv_fp32): the bf16
// kernels' structure, with every product in 3xTF32 (mma.sync m16n8k8, three
// products of the tf32-split operands each, fp32 accumulators;
// flash_common.cuh), which keeps fp32's accuracy and is the kernels' own
// contract, whatever the TF32 flags of cuBLAS and cuDNN say:
//   - Pᵀ, dS and dSᵀ are fed to the next product from registers, split
//     there, with the contracted index relabelled as in the fp32 forward (a
//     C tile's columns 2t, 2t+1 are the A operand's t, t+4; the B operand's
//     rows are read in that order). P and dS = P (dP − Δ) are fp32.
//   - Δ is the dQ kernel's, in fp32, from the O and dO tiles it streams; the
//     O tile lands in the second K stage and is read before K tile 1 is
//     loaded there, so the kernel takes 6 tiles of shared memory: 2 CTAs
//     per SM at D = 64 (104,960 bytes), and it fits at D = 128.
//   - the products and fragments are the forward's (flash_common.cuh:
//     gemm_abt_tf32x3 for S, dP and their transposes, gemm_cb_tf32x3 for
//     the products fed from registers); tiles stream through the same
//     2-stage cp.async ring; columns >= D are zero-filled.
//   - results differ from the plain version's in the last bits (3xTF32
//     products, another summation order): within atol 1e-4 + rtol 1e-4.
//     The same tiles and no atomics keep them deterministic, and a strided
//     call equals the contiguous one bit for bit.

#include <initializer_list>
#include <math.h>

#include "flash_common.cuh"

namespace {

using bf16 = __nv_bfloat16;
using flash::head_offset;
using flash::LOG2E;

constexpr int BLOCK = 64;  // q rows and keys per tile

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int MMA_THREADS = 128;  // 4 warps x 16 rows

// `tiles` bf16 tiles of BLOCK rows padded by 8 elements, then `vectors`
// fp32 vectors of BLOCK
template <int DMAX>
constexpr size_t mma_smem_bytes(int tiles, int vectors) {
  return sizeof(bf16) * tiles * BLOCK * (DMAX + 8) +
         sizeof(float) * vectors * BLOCK;
}

// S (or Sᵀ) and dP (or dPᵀ) for one warp: 16 rows of the resident operands
// (`a_s`, `a_d`) against the 64 rows of the streamed ones (`b_s`, `b_d`)
template <int DMAX, int LD>
__device__ __forceinline__ void scores(float s[8][4], float dp[8][4],
                                       const bf16* a_s, const bf16* a_d,
                                       const bf16* b_s, const bf16* b_d,
                                       int lane) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
  }
#pragma unroll
  for (int st = 0; st < DMAX / 16; ++st) {
    uint32_t as[4], ad[4];
    const int a_off = (lane & 15) * LD + 16 * st + (lane >> 4) * 8;
    flash::ldmatrix_x4(as, a_s + a_off);
    flash::ldmatrix_x4(ad, a_d + a_off);
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int b_off = (16 * p + (lane & 7) + ((lane >> 4) << 3)) * LD +
                        16 * st + ((lane >> 3) & 1) * 8;
      uint32_t bs[4], bd[4];
      flash::ldmatrix_x4(bs, b_s + b_off);
      flash::ldmatrix_x4(bd, b_d + b_off);
      flash::mma_bf16(s[2 * p], as, bs[0], bs[1]);
      flash::mma_bf16(s[2 * p + 1], as, bs[2], bs[3]);
      flash::mma_bf16(dp[2 * p], ad, bd[0], bd[1]);
      flash::mma_bf16(dp[2 * p + 1], ad, bd[2], bd[3]);
    }
  }
}

// acc (16 x DMAX) += A (16 x 64, as C tiles c[8]) · B, B (64 x DMAX) read
// row-major from shared memory through ldmatrix.trans
template <int DMAX, int LD>
__device__ __forceinline__ void accumulate(float (*acc)[4], float c[8][4],
                                           const bf16* b, int lane) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t a[4];
    flash::c_to_a(a, c[2 * kk], c[2 * kk + 1]);
#pragma unroll
    for (int p = 0; p < DMAX / 16; ++p) {
      uint32_t bb[4];
      flash::ldmatrix_x4_trans(
          bb, b + (16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                  16 * p + (lane >> 4) * 8);
      flash::mma_bf16(acc[2 * p], a, bb[0], bb[1]);
      flash::mma_bf16(acc[2 * p + 1], a, bb[2], bb[3]);
    }
  }
}

// dQ for one 64-query tile of one (batch, head); computes and stores Δ
template <int DMAX>
__global__ void __launch_bounds__(MMA_THREADS)
flash_bwd_dq_mma(Tensor4 q, Tensor4 k, Tensor4 v, Tensor4 o, Tensor4 dout,
                 const float* __restrict__ lse, float* __restrict__ delta,
                 Tensor4 dq, int heads, int nq, int nkv, int d, float scale,
                 bool vec16) {
  constexpr int LD = DMAX + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [BLOCK][LD]
  bf16* dos = qs + BLOCK * LD;                    // [BLOCK][LD]
  bf16* os = dos + BLOCK * LD;                    // [BLOCK][LD]
  bf16* ks = os + BLOCK * LD;                     // [2][BLOCK][LD]
  bf16* vs = ks + 2 * BLOCK * LD;                 // [2][BLOCK][LD]
  float* lse_s = reinterpret_cast<float*>(vs + 2 * BLOCK * LD);  // [BLOCK]
  float* delta_s = lse_s + BLOCK;                                // [BLOCK]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BLOCK;
  const int wrow = warp * 16;
  const bf16* qh = static_cast<const bf16*>(q.ptr) + head_offset(q, bh, heads);
  const bf16* kh = static_cast<const bf16*>(k.ptr) + head_offset(k, bh, heads);
  const bf16* vh = static_cast<const bf16*>(v.ptr) + head_offset(v, bh, heads);
  const bf16* oh = static_cast<const bf16*>(o.ptr) + head_offset(o, bh, heads);
  const bf16* doh =
      static_cast<const bf16*>(dout.ptr) + head_offset(dout, bh, heads);
  const int num_kb = (nkv + BLOCK - 1) / BLOCK;

  flash::load_tile<BLOCK, DMAX, LD, MMA_THREADS>(qs, qh, q.sn, q0, nq, d, vec16);
  flash::load_tile<BLOCK, DMAX, LD, MMA_THREADS>(dos, doh, dout.sn, q0, nq, d,
                                                 vec16);
  flash::load_tile<BLOCK, DMAX, LD, MMA_THREADS>(os, oh, o.sn, q0, nq, d,
                                                 vec16);
  for (int kb = 0; kb < 2; ++kb) {
    if (kb < num_kb) {
      flash::load_tile<BLOCK, DMAX, LD, MMA_THREADS>(
          ks + kb * BLOCK * LD, kh, k.sn, kb * BLOCK, nkv, d, vec16);
      flash::load_tile<BLOCK, DMAX, LD, MMA_THREADS>(
          vs + kb * BLOCK * LD, vh, v.sn, kb * BLOCK, nkv, d, vec16);
    }
    flash::cp_async_commit();
  }

  if (tid < BLOCK)
    lse_s[tid] = q0 + tid < nq ? lse[(size_t)bh * nq + q0 + tid] * LOG2E : 0.f;
  flash::cp_async_wait<1>();
  __syncthreads();

  // Δ = rowsum(dO ⊙ O) in fp32 from the tiles (zero past d): two lanes per
  // row, each over half the columns. A warp sums its own 16 rows, so the
  // rows it reads below are ready after __syncwarp.
  {
    const int r = tid >> 1, c0 = (tid & 1) * (DMAX / 2);
    float sum = 0.f;
#pragma unroll
    for (int c = c0; c < c0 + DMAX / 2; c += 2) {
      const float2 a = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(os + r * LD + c));
      const float2 b = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(dos + r * LD + c));
      sum = fmaf(a.x, b.x, sum);
      sum = fmaf(a.y, b.y, sum);
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    if ((tid & 1) == 0) {
      delta_s[r] = sum;
      if (q0 + r < nq) delta[(size_t)bh * nq + q0 + r] = sum;
    }
    __syncwarp();
  }

  const bool live = q0 + wrow < nq;
  float lse2[2], dlt[2];
  bool row_ok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = wrow + g + 8 * i;
    row_ok[i] = q0 + r < nq;
    lse2[i] = lse_s[r];
    dlt[i] = delta_s[r];
  }
  const float scale_log2 = scale * LOG2E;
  float acc[DMAX / 8][4];
#pragma unroll
  for (int j = 0; j < DMAX / 8; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int kb = 0; kb < num_kb; ++kb) {
    if (kb > 0) {
      flash::cp_async_wait<1>();
      __syncthreads();
    }
    const bf16* kt = ks + (kb & 1) * BLOCK * LD;
    const bf16* vt = vs + (kb & 1) * BLOCK * LD;
    const int k0 = kb * BLOCK;
    if (live) {
      float s[8][4], dp[8][4];
      scores<DMAX, LD>(s, dp, qs + wrow * LD, dos + wrow * LD, kt, vt, lane);
      // P and dS = P (dP − Δ), rows g (e < 2) and g + 8
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          const bool ok = row_ok[i] && k0 + 8 * j + 2 * t + (e & 1) < nkv;
          const float p = ok ? exp2f(s[j][e] * scale_log2 - lse2[i]) : 0.f;
          dp[j][e] = p * (dp[j][e] - dlt[i]);
        }
      }
      accumulate<DMAX, LD>(acc, dp, kt, lane);  // dQ += dS K
    }
    __syncthreads();  // every warp is done with this stage
    if (kb + 2 < num_kb) {
      flash::load_tile<BLOCK, DMAX, LD, MMA_THREADS>(
          ks + (kb & 1) * BLOCK * LD, kh, k.sn, (kb + 2) * BLOCK, nkv, d,
          vec16);
      flash::load_tile<BLOCK, DMAX, LD, MMA_THREADS>(
          vs + (kb & 1) * BLOCK * LD, vh, v.sn, (kb + 2) * BLOCK, nkv, d,
          vec16);
    }
    flash::cp_async_commit();
  }

  if (!live) return;
  bf16* dqh = static_cast<bf16*>(dq.ptr) + head_offset(dq, bh, heads);
  flash::store_rows<DMAX>(dqh, dq.sn, acc, q0 + wrow, nq, d, scale, scale);
}

// dK and dV for one 64-key tile of one (batch, head); reads the Δ that the
// dQ kernel stored
template <int DMAX>
__global__ void __launch_bounds__(MMA_THREADS)
flash_bwd_dkdv_mma(Tensor4 q, Tensor4 k, Tensor4 v, Tensor4 dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, Tensor4 dk, Tensor4 dv,
                   int heads, int nq, int nkv, int d, float scale,
                   bool vec16) {
  constexpr int LD = DMAX + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);  // [BLOCK][LD]
  bf16* vs = ks + BLOCK * LD;                     // [BLOCK][LD]
  bf16* qs = vs + BLOCK * LD;                     // [2][BLOCK][LD]
  bf16* dos = qs + 2 * BLOCK * LD;                // [2][BLOCK][LD]
  float* lse_s = reinterpret_cast<float*>(dos + 2 * BLOCK * LD);  // [2][BLOCK]
  float* delta_s = lse_s + 2 * BLOCK;                             // [2][BLOCK]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * BLOCK;
  const int wrow = warp * 16;
  const bf16* qh = static_cast<const bf16*>(q.ptr) + head_offset(q, bh, heads);
  const bf16* kh = static_cast<const bf16*>(k.ptr) + head_offset(k, bh, heads);
  const bf16* vh = static_cast<const bf16*>(v.ptr) + head_offset(v, bh, heads);
  const bf16* doh =
      static_cast<const bf16*>(dout.ptr) + head_offset(dout, bh, heads);
  const float* lh = lse + (size_t)bh * nq;
  const float* dh = delta + (size_t)bh * nq;
  const int num_qb = (nq + BLOCK - 1) / BLOCK;

  auto load_q_tile = [&](int qb) {
    const int stage = qb & 1;
    flash::load_tile<BLOCK, DMAX, LD, MMA_THREADS>(
        qs + stage * BLOCK * LD, qh, q.sn, qb * BLOCK, nq, d, vec16);
    flash::load_tile<BLOCK, DMAX, LD, MMA_THREADS>(
        dos + stage * BLOCK * LD, doh, dout.sn, qb * BLOCK, nq, d, vec16);
    if (tid < BLOCK) {
      const int row = qb * BLOCK + tid;
      const bool ok = row < nq;
      flash::cp_async4(lse_s + stage * BLOCK + tid, ok ? lh + row : lh,
                       ok ? 4 : 0);
      flash::cp_async4(delta_s + stage * BLOCK + tid, ok ? dh + row : dh,
                       ok ? 4 : 0);
    }
  };

  flash::load_tile<BLOCK, DMAX, LD, MMA_THREADS>(ks, kh, k.sn, k0, nkv, d, vec16);
  flash::load_tile<BLOCK, DMAX, LD, MMA_THREADS>(vs, vh, v.sn, k0, nkv, d, vec16);
  load_q_tile(0);
  flash::cp_async_commit();
  if (num_qb > 1) load_q_tile(1);
  flash::cp_async_commit();

  const bool live = k0 + wrow < nkv;
  bool key_ok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) key_ok[i] = k0 + wrow + g + 8 * i < nkv;
  const float scale_log2 = scale * LOG2E;
  float acc_dk[DMAX / 8][4], acc_dv[DMAX / 8][4];
#pragma unroll
  for (int j = 0; j < DMAX / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_dk[j][e] = acc_dv[j][e] = 0.f;
  }

  for (int qb = 0; qb < num_qb; ++qb) {
    flash::cp_async_wait<1>();  // tile qb has landed; qb+1 may be in flight
    __syncthreads();
    const int stage = qb & 1;
    const bf16* qt = qs + stage * BLOCK * LD;
    const bf16* dot = dos + stage * BLOCK * LD;
    const float* lse_t = lse_s + stage * BLOCK;
    const float* dlt_t = delta_s + stage * BLOCK;
    const int q0 = qb * BLOCK;
    if (live) {
      // Sᵀ = K Qᵀ and dPᵀ = V dOᵀ: 16 keys x 64 queries
      float s[8][4], dp[8][4];
      scores<DMAX, LD>(s, dp, ks + wrow * LD, vs + wrow * LD, qt, dot, lane);
      // Pᵀ and dSᵀ = Pᵀ (dPᵀ − Δ); keys g (e < 2) and g + 8, queries
      // 8j + 2t + (e & 1)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * j + 2 * t + (e & 1);
          const bool ok = key_ok[e >> 1] && q0 + c < nq;
          const float p =
              ok ? exp2f(s[j][e] * scale_log2 - lse_t[c] * LOG2E) : 0.f;
          s[j][e] = p;
          dp[j][e] = p * (dp[j][e] - dlt_t[c]);
        }
      }
      accumulate<DMAX, LD>(acc_dv, s, dot, lane);  // dV += Pᵀ dO
      accumulate<DMAX, LD>(acc_dk, dp, qt, lane);  // dK += dSᵀ Q
    }
    __syncthreads();  // every warp is done with this stage
    if (qb + 2 < num_qb) load_q_tile(qb + 2);
    flash::cp_async_commit();
  }

  if (!live) return;
  bf16* dkh = static_cast<bf16*>(dk.ptr) + head_offset(dk, bh, heads);
  bf16* dvh = static_cast<bf16*>(dv.ptr) + head_offset(dv, bh, heads);
  flash::store_rows<DMAX>(dkh, dk.sn, acc_dk, k0 + wrow, nkv, d, scale, scale);
  flash::store_rows<DMAX>(dvh, dv.sn, acc_dv, k0 + wrow, nkv, d, 1.f, 1.f);
}

template <int DMAX>
cudaError_t launch_mma(const Tensor4& q, const Tensor4& k, const Tensor4& v,
                       const Tensor4& o, const Tensor4& dout,
                       const float* lse, float* delta, const Tensor4& dq,
                       const Tensor4& dk, const Tensor4& dv, int bh,
                       int heads, int nq, int nkv, int d, float scale,
                       cudaStream_t stream) {
  // the attributes belong to the current device, so they are set on every
  // launch rather than cached once per process
  // dQ: q, dO, O and two stages of K and V; lse and Δ. dK/dV: K, V and
  // two stages of q and dO; two stages of lse and Δ.
  constexpr size_t smem_dq = mma_smem_bytes<DMAX>(7, 2);
  constexpr size_t smem_dkdv = mma_smem_bytes<DMAX>(6, 4);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_mma<DMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_dq);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dkdv_mma<DMAX>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_dkdv);
  if (err != cudaSuccess) return err;
  bool vec16 = true;
  for (const Tensor4* t : {&q, &k, &v, &o, &dout})
    vec16 = vec16 && flash::aligned_to(*t, 2, 16);
  // dQ: one CTA per 64-query tile; dK/dV: one per 64-key tile
  const dim3 grid_q((nq + BLOCK - 1) / BLOCK, bh);
  const dim3 grid_k((nkv + BLOCK - 1) / BLOCK, bh);
  flash_bwd_dq_mma<DMAX><<<grid_q, MMA_THREADS, smem_dq, stream>>>(
      q, k, v, o, dout, lse, delta, dq, heads, nq, nkv, d, scale, vec16);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dkdv_mma<DMAX><<<grid_k, MMA_THREADS, smem_dkdv,
                                          stream>>>(
      q, k, v, dout, lse, delta, dk, dv, heads, nq, nkv, d, scale, vec16);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// fp32: tensor cores, 3xTF32
// ---------------------------------------------------------------------------

// `tiles` fp32 tiles of BLOCK rows padded by 4 floats, then `vectors` fp32
// vectors of BLOCK
template <int DMAX>
constexpr size_t fp32_smem_bytes(int tiles, int vectors) {
  return sizeof(float) * (tiles * BLOCK * (DMAX + 4) + vectors * BLOCK);
}

// dQ for one 64-query tile of one (batch, head); computes and stores Δ
template <int DMAX>
__global__ void __launch_bounds__(MMA_THREADS)
flash_bwd_dq_fp32(Tensor4 q, Tensor4 k, Tensor4 v, Tensor4 o, Tensor4 dout,
                  const float* __restrict__ lse, float* __restrict__ delta,
                  Tensor4 dq, int heads, int nq, int nkv, int d, float scale,
                  bool vec16) {
  constexpr int LD = DMAX + 4;  // padded row, in floats (4 modulo 32)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);  // [BLOCK][LD]
  float* dos = qs + BLOCK * LD;                     // [BLOCK][LD]
  float* ks = dos + BLOCK * LD;                     // [2][BLOCK][LD]
  float* vs = ks + 2 * BLOCK * LD;                  // [2][BLOCK][LD]
  float* lse_s = vs + 2 * BLOCK * LD;               // [BLOCK]
  float* delta_s = lse_s + BLOCK;                   // [BLOCK]
  // the O tile is only read for Δ, before K tile 1 needs the space: an own
  // buffer would take a second CTA off each SM
  float* os = ks + BLOCK * LD;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BLOCK;
  const int wrow = warp * 16;
  const float* qh = static_cast<const float*>(q.ptr) + head_offset(q, bh, heads);
  const float* kh = static_cast<const float*>(k.ptr) + head_offset(k, bh, heads);
  const float* vh = static_cast<const float*>(v.ptr) + head_offset(v, bh, heads);
  const float* oh = static_cast<const float*>(o.ptr) + head_offset(o, bh, heads);
  const float* doh =
      static_cast<const float*>(dout.ptr) + head_offset(dout, bh, heads);
  const int num_kb = (nkv + BLOCK - 1) / BLOCK;

  // group 0: q, dO, O and K/V tile 0
  flash::load_tile<BLOCK, DMAX, LD, MMA_THREADS>(qs, qh, q.sn, q0, nq, d, vec16);
  flash::load_tile<BLOCK, DMAX, LD, MMA_THREADS>(dos, doh, dout.sn, q0, nq, d,
                                                 vec16);
  flash::load_tile<BLOCK, DMAX, LD, MMA_THREADS>(os, oh, o.sn, q0, nq, d,
                                                 vec16);
  flash::load_tile<BLOCK, DMAX, LD, MMA_THREADS>(ks, kh, k.sn, 0, nkv, d, vec16);
  flash::load_tile<BLOCK, DMAX, LD, MMA_THREADS>(vs, vh, v.sn, 0, nkv, d, vec16);
  flash::cp_async_commit();
  if (tid < BLOCK)
    lse_s[tid] = q0 + tid < nq ? lse[(size_t)bh * nq + q0 + tid] * LOG2E : 0.f;
  flash::cp_async_wait<0>();
  __syncthreads();

  // Δ = rowsum(dO ⊙ O) in fp32 from the tiles (zero past d): two lanes per
  // row, each over half the columns
  {
    const int r = tid >> 1, c0 = (tid & 1) * (DMAX / 2);
    float sum = 0.f;
#pragma unroll 8
    for (int c = c0; c < c0 + DMAX / 2; ++c)
      sum = fmaf(os[r * LD + c], dos[r * LD + c], sum);
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    if ((tid & 1) == 0) {
      delta_s[r] = sum;
      if (q0 + r < nq) delta[(size_t)bh * nq + q0 + r] = sum;
    }
  }
  __syncthreads();  // O is read and Δ is in shared memory
  // group 1: K/V tile 1 (maybe empty), over O
  if (num_kb > 1) {
    flash::load_tile<BLOCK, DMAX, LD, MMA_THREADS>(ks + BLOCK * LD, kh, k.sn,
                                                   BLOCK, nkv, d, vec16);
    flash::load_tile<BLOCK, DMAX, LD, MMA_THREADS>(vs + BLOCK * LD, vh, v.sn,
                                                   BLOCK, nkv, d, vec16);
  }
  flash::cp_async_commit();

  const bool live = q0 + wrow < nq;
  float lse2[2], dlt[2];
  bool row_ok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = wrow + g + 8 * i;
    row_ok[i] = q0 + r < nq;
    lse2[i] = lse_s[r];
    dlt[i] = delta_s[r];
  }
  const float scale_log2 = scale * LOG2E;
  float acc[DMAX / 8][4];
#pragma unroll
  for (int j = 0; j < DMAX / 8; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int kb = 0; kb < num_kb; ++kb) {
    if (kb > 0) {
      flash::cp_async_wait<1>();
      __syncthreads();
    }
    const float* kt = ks + (kb & 1) * BLOCK * LD;
    const float* vt = vs + (kb & 1) * BLOCK * LD;
    const int k0 = kb * BLOCK;
    if (live) {
      float s[8][4], dp[8][4];
      flash::gemm_abt_tf32x3<DMAX, LD>(s, qs + wrow * LD, kt, lane);
      flash::gemm_abt_tf32x3<DMAX, LD>(dp, dos + wrow * LD, vt, lane);
      // P and dS = P (dP − Δ), rows g (e < 2) and g + 8
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          const bool ok = row_ok[i] && k0 + 8 * j + 2 * t + (e & 1) < nkv;
          const float p = ok ? exp2f(s[j][e] * scale_log2 - lse2[i]) : 0.f;
          dp[j][e] = p * (dp[j][e] - dlt[i]);
        }
      }
      flash::gemm_cb_tf32x3<DMAX, LD>(acc, dp, kt, lane);  // dQ += dS K
    }
    __syncthreads();  // every warp is done with this stage
    if (kb + 2 < num_kb) {
      flash::load_tile<BLOCK, DMAX, LD, MMA_THREADS>(
          ks + (kb & 1) * BLOCK * LD, kh, k.sn, (kb + 2) * BLOCK, nkv, d,
          vec16);
      flash::load_tile<BLOCK, DMAX, LD, MMA_THREADS>(
          vs + (kb & 1) * BLOCK * LD, vh, v.sn, (kb + 2) * BLOCK, nkv, d,
          vec16);
    }
    flash::cp_async_commit();
  }

  if (!live) return;
  float* dqh = static_cast<float*>(dq.ptr) + head_offset(dq, bh, heads);
  flash::store_rows<DMAX>(dqh, dq.sn, acc, q0 + wrow, nq, d, scale, scale);
}

// dK and dV for one 64-key tile of one (batch, head); reads the Δ that the
// dQ kernel stored
template <int DMAX>
__global__ void __launch_bounds__(MMA_THREADS)
flash_bwd_dkdv_fp32(Tensor4 q, Tensor4 k, Tensor4 v, Tensor4 dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, Tensor4 dk, Tensor4 dv,
                    int heads, int nq, int nkv, int d, float scale,
                   bool vec16) {
  constexpr int LD = DMAX + 4;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ks = reinterpret_cast<float*>(smem_raw);  // [BLOCK][LD]
  float* vs = ks + BLOCK * LD;                      // [BLOCK][LD]
  float* qs = vs + BLOCK * LD;                      // [2][BLOCK][LD]
  float* dos = qs + 2 * BLOCK * LD;                 // [2][BLOCK][LD]
  float* lse_s = dos + 2 * BLOCK * LD;              // [2][BLOCK]
  float* delta_s = lse_s + 2 * BLOCK;               // [2][BLOCK]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * BLOCK;
  const int wrow = warp * 16;
  const float* qh = static_cast<const float*>(q.ptr) + head_offset(q, bh, heads);
  const float* kh = static_cast<const float*>(k.ptr) + head_offset(k, bh, heads);
  const float* vh = static_cast<const float*>(v.ptr) + head_offset(v, bh, heads);
  const float* doh =
      static_cast<const float*>(dout.ptr) + head_offset(dout, bh, heads);
  const float* lh = lse + (size_t)bh * nq;
  const float* dh = delta + (size_t)bh * nq;
  const int num_qb = (nq + BLOCK - 1) / BLOCK;

  auto load_q_tile = [&](int qb) {
    const int stage = qb & 1;
    flash::load_tile<BLOCK, DMAX, LD, MMA_THREADS>(
        qs + stage * BLOCK * LD, qh, q.sn, qb * BLOCK, nq, d, vec16);
    flash::load_tile<BLOCK, DMAX, LD, MMA_THREADS>(
        dos + stage * BLOCK * LD, doh, dout.sn, qb * BLOCK, nq, d, vec16);
    if (tid < BLOCK) {
      const int row = qb * BLOCK + tid;
      const bool ok = row < nq;
      flash::cp_async4(lse_s + stage * BLOCK + tid, ok ? lh + row : lh,
                       ok ? 4 : 0);
      flash::cp_async4(delta_s + stage * BLOCK + tid, ok ? dh + row : dh,
                       ok ? 4 : 0);
    }
  };

  flash::load_tile<BLOCK, DMAX, LD, MMA_THREADS>(ks, kh, k.sn, k0, nkv, d, vec16);
  flash::load_tile<BLOCK, DMAX, LD, MMA_THREADS>(vs, vh, v.sn, k0, nkv, d, vec16);
  load_q_tile(0);
  flash::cp_async_commit();
  if (num_qb > 1) load_q_tile(1);
  flash::cp_async_commit();

  const bool live = k0 + wrow < nkv;
  bool key_ok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) key_ok[i] = k0 + wrow + g + 8 * i < nkv;
  const float scale_log2 = scale * LOG2E;
  float acc_dk[DMAX / 8][4], acc_dv[DMAX / 8][4];
#pragma unroll
  for (int j = 0; j < DMAX / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_dk[j][e] = acc_dv[j][e] = 0.f;
  }

  for (int qb = 0; qb < num_qb; ++qb) {
    flash::cp_async_wait<1>();  // tile qb has landed; qb+1 may be in flight
    __syncthreads();
    const int stage = qb & 1;
    const float* qt = qs + stage * BLOCK * LD;
    const float* dot = dos + stage * BLOCK * LD;
    const float* lse_t = lse_s + stage * BLOCK;
    const float* dlt_t = delta_s + stage * BLOCK;
    const int q0 = qb * BLOCK;
    if (live) {
      // Sᵀ = K Qᵀ and dPᵀ = V dOᵀ: 16 keys x 64 queries
      float s[8][4], dp[8][4];
      flash::gemm_abt_tf32x3<DMAX, LD>(s, ks + wrow * LD, qt, lane);
      flash::gemm_abt_tf32x3<DMAX, LD>(dp, vs + wrow * LD, dot, lane);
      // Pᵀ and dSᵀ = Pᵀ (dPᵀ − Δ); keys g (e < 2) and g + 8, queries
      // 8j + 2t + (e & 1)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * j + 2 * t + (e & 1);
          const bool ok = key_ok[e >> 1] && q0 + c < nq;
          const float p =
              ok ? exp2f(s[j][e] * scale_log2 - lse_t[c] * LOG2E) : 0.f;
          s[j][e] = p;
          dp[j][e] = p * (dp[j][e] - dlt_t[c]);
        }
      }
      flash::gemm_cb_tf32x3<DMAX, LD>(acc_dv, s, dot, lane);  // dV += Pᵀ dO
      flash::gemm_cb_tf32x3<DMAX, LD>(acc_dk, dp, qt, lane);  // dK += dSᵀ Q
    }
    __syncthreads();  // every warp is done with this stage
    if (qb + 2 < num_qb) load_q_tile(qb + 2);
    flash::cp_async_commit();
  }

  if (!live) return;
  float* dkh = static_cast<float*>(dk.ptr) + head_offset(dk, bh, heads);
  float* dvh = static_cast<float*>(dv.ptr) + head_offset(dv, bh, heads);
  flash::store_rows<DMAX>(dkh, dk.sn, acc_dk, k0 + wrow, nkv, d, scale, scale);
  flash::store_rows<DMAX>(dvh, dv.sn, acc_dv, k0 + wrow, nkv, d, 1.f, 1.f);
}

template <int DMAX>
cudaError_t launch_fp32(const Tensor4& q, const Tensor4& k, const Tensor4& v,
                        const Tensor4& o, const Tensor4& dout,
                        const float* lse, float* delta, const Tensor4& dq,
                        const Tensor4& dk, const Tensor4& dv, int bh,
                        int heads, int nq, int nkv, int d, float scale,
                        cudaStream_t stream) {
  // dQ: q, dO and two stages of K and V (O lands in K's second stage);
  // lse and Δ. dK/dV: K, V and two stages of q and dO; two stages of lse
  // and Δ.
  constexpr size_t smem_dq = fp32_smem_bytes<DMAX>(6, 2);
  constexpr size_t smem_dkdv = fp32_smem_bytes<DMAX>(6, 4);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_fp32<DMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_dq);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dkdv_fp32<DMAX>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_dkdv);
  if (err != cudaSuccess) return err;
  bool vec16 = true;
  for (const Tensor4* t : {&q, &k, &v, &o, &dout})
    vec16 = vec16 && flash::aligned_to(*t, 4, 16);
  // dQ: one CTA per 64-query tile; dK/dV: one per 64-key tile
  const dim3 grid_q((nq + BLOCK - 1) / BLOCK, bh);
  const dim3 grid_k((nkv + BLOCK - 1) / BLOCK, bh);
  flash_bwd_dq_fp32<DMAX><<<grid_q, MMA_THREADS, smem_dq, stream>>>(
      q, k, v, o, dout, lse, delta, dq, heads, nq, nkv, d, scale, vec16);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dkdv_fp32<DMAX><<<grid_k, MMA_THREADS, smem_dkdv,
                                          stream>>>(
      q, k, v, dout, lse, delta, dk, dv, heads, nq, nkv, d, scale, vec16);
  return cudaGetLastError();
}

}  // namespace

// C interface for ctypes. Returns a cudaError_t (0 on success). q, k, v,
// out, dout, dq, dk, dv are (batch, heads, n, d) descriptors with unit
// stride along d: q, out, dout and dq hold nq rows, k, v, dk and dv nkv rows
// (keys >= nkv are masked, and their dk, dv rows are not written); lse and
// delta are (batch·heads, nq) fp32. out and lse may be those of a longer
// softmax than this call's keys (a ring's merged output: Δ and P then come
// from it, and dq, dk, dv are this hop's part). dtype: 0 is fp32, 1 is bf16
// (a bf16 operand needs a 4-byte aligned base and even strides). delta is
// scratch that the dQ kernel fills from out and dout, and the dK/dV kernel
// reads. The caller allocates dq, dk, dv and delta.
extern "C" int flash_attention_bwd(const Tensor4* q, const Tensor4* k,
                                   const Tensor4* v, const Tensor4* out,
                                   const Tensor4* dout, const void* lse,
                                   void* delta, const Tensor4* dq,
                                   const Tensor4* dk, const Tensor4* dv,
                                   int batch, int heads, int nq, int nkv,
                                   int d, float scale, int dtype,
                                   void* stream) {
  const long long bh = (long long)batch * heads;
  if (batch <= 0 || heads <= 0 || bh > 65535 || nq <= 0 || nkv <= 0 ||
      d <= 0 || d > 128 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  if (dtype == 0) {
    return (int)(d <= 64
        ? launch_fp32<64>(*q, *k, *v, *out, *dout, l, dl, *dq, *dk, *dv,
                          (int)bh, heads, nq, nkv, d, scale, s)
        : launch_fp32<128>(*q, *k, *v, *out, *dout, l, dl, *dq, *dk, *dv,
                           (int)bh, heads, nq, nkv, d, scale, s));
  }
  for (const Tensor4* t : {q, k, v, out, dout, dq, dk, dv}) {
    if (!flash::aligned_to(*t, 2, 4)) return (int)cudaErrorMisalignedAddress;
  }
  return (int)(d <= 64
      ? launch_mma<64>(*q, *k, *v, *out, *dout, l, dl, *dq, *dk, *dv,
                       (int)bh, heads, nq, nkv, d, scale, s)
      : launch_mma<128>(*q, *k, *v, *out, *dout, l, dl, *dq, *dk, *dv,
                        (int)bh, heads, nq, nkv, d, scale, s));
}
