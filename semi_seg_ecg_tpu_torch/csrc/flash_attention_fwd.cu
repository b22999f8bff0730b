// Flash-attention forward for NVIDIA Hopper (sm_90a), fp32 and bf16 inputs.
//
// Replaces the TPU kernel semi_seg_ecg_tpu/ops/pallas/flash_attention.py
// `_fwd_kernel` (launched by `_flash_forward`): out = softmax(q kᵀ · scale) v
// with an online softmax, so the (N, N) score matrix never reaches device
// memory, plus the row logsumexp `lse` that the backward pass consumes.
// Key columns >= N are masked to -inf. q, k, v, out are (B·H, N, D)
// contiguous; lse is (B·H, N) fp32. All arithmetic is fp32: bf16 inputs are
// widened with __bfloat162float, and fp32 inputs use full fp32 FMA (no TF32),
// as the Pallas kernel upcasts every block to fp32.
//
// What bounds it on an H100 (3.35 TB/s, 67 TFLOP/s fp32 outside the tensor
// cores, 989 TFLOP/s bf16 in them). The work is 4·B·H·N²·D flops over
// 4·B·H·N·D elements moved. At the ViT-tiny serving shape (B=16, H=3, N=101,
// D=64, fp32) that is 0.125 GFLOP and 5 MB: about 1.9 us of fp32 FMA and
// 1.5 us of memory. There the grid is 96 CTAs, one wave with one CTA per
// SM, so a call takes the latency of one CTA: its K/V tiles are loaded
// without overlap with the products, and each thread runs its ~2k FMAs
// per tile in sequence with only 8 warps per SM to hide the latency. Overlap
// (double-buffered K/V) and more warps per SM (smaller q tiles) are the
// steps for that regime. At long N the flops dominate: (8, 12, 2048, 64)
// bf16 needs 103 GFLOP, 0.10 ms on the tensor cores.
//
// Design. One CTA of 256 threads per (batch·head, 64-row q tile); K/V stream
// through shared memory in 64-row tiles; the running max, running sum and
// the output accumulator stay in fp32 registers. The threads form a 16x16
// grid: thread (ty, tx) owns q rows 4ty..4ty+3, score columns tx+16j of the
// current tile and output columns tx+16e, so each shared-memory read feeds
// four FMAs (q and p tiles are stored transposed and read as float4) and a
// row reduction is a 16-lane shuffle. It uses CUDA cores only: the score
// and value products in the tensor cores (wgmma, with TMA loads) are the
// step that makes it fast, and are left for later.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BLOCK_M = 64;           // q rows per CTA
constexpr int BLOCK_N = 64;           // keys per streamed K/V tile
constexpr int THREADS = 256;          // 16 x 16 thread grid
constexpr int TSTRIDE = BLOCK_M + 4;  // row stride of the transposed tiles

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void narrow_store(float* p, float x) { *p = x; }
__device__ __forceinline__ void narrow_store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <int DMAX>
constexpr size_t smem_bytes() {
  return sizeof(float) * (DMAX * TSTRIDE            // q tile, transposed
                          + BLOCK_N * (DMAX + 1)    // k tile, padded rows
                          + BLOCK_N * DMAX          // v tile
                          + BLOCK_N * TSTRIDE);     // p tile, transposed
}

// DMAX (64 or 128) fixes the register tile; the runtime head dim d <= DMAX
// is zero-padded in shared memory.
template <typename T, int DMAX>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, int n, int d, float scale) {
  constexpr int EPT = DMAX / 16;  // output columns per thread
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;                       // [DMAX][TSTRIDE]
  float* ks = qt + DMAX * TSTRIDE;        // [BLOCK_N][DMAX + 1]
  float* vs = ks + BLOCK_N * (DMAX + 1);  // [BLOCK_N][DMAX]
  float* pt = vs + BLOCK_N * DMAX;        // [BLOCK_N][TSTRIDE]

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int q0 = blockIdx.x * BLOCK_M;
  const size_t head = (size_t)blockIdx.y * n * d;
  const T* qh = q + head;
  const T* kh = k + head;
  const T* vh = v + head;

  // q tile, pre-scaled as in the Pallas kernel; rows >= n and columns >= d
  // are zero
  for (int idx = tid; idx < BLOCK_M * DMAX; idx += THREADS) {
    const int r = idx / DMAX, c = idx % DMAX;
    float x = 0.f;
    if (q0 + r < n && c < d) x = widen(qh[(size_t)(q0 + r) * d + c]) * scale;
    qt[c * TSTRIDE + r] = x;
  }

  float m_i[4], l_i[4], acc[4][EPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = -INFINITY;
    l_i[i] = 0.f;
#pragma unroll
    for (int e = 0; e < EPT; ++e) acc[i][e] = 0.f;
  }

  const int num_kb = (n + BLOCK_N - 1) / BLOCK_N;
  for (int kb = 0; kb < num_kb; ++kb) {
    const int k0 = kb * BLOCK_N;
    __syncthreads();  // the previous tile's readers are done
    for (int idx = tid; idx < BLOCK_N * DMAX; idx += THREADS) {
      const int r = idx / DMAX, c = idx % DMAX;
      float kx = 0.f, vx = 0.f;
      if (k0 + r < n && c < d) {
        const size_t off = (size_t)(k0 + r) * d + c;
        kx = widen(kh[off]);
        vx = widen(vh[off]);
      }
      ks[r * (DMAX + 1) + c] = kx;
      vs[r * DMAX + c] = vx;
    }
    __syncthreads();

    // s = (q·scale) kᵀ for rows 4ty+i, columns tx+16j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < d; ++c) {
      const float4 qv = *reinterpret_cast<const float4*>(&qt[c * TSTRIDE + 4 * ty]);
      const float qr[4] = {qv.x, qv.y, qv.z, qv.w};
      float kc[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) kc[j] = ks[(tx + 16 * j) * (DMAX + 1) + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qr[i], kc[j], s[i][j]);
    }

    // online softmax; tile kb always holds column k0 < n, so every row max
    // is finite and exp(-inf - m) = 0 clears both masked columns and the
    // first tile's correction
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (k0 + tx + 16 * j >= n) {
#pragma unroll
        for (int i = 0; i < 4; ++i) s[i][j] = -INFINITY;
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_i[i], mx);
      const float corr = expf(m_i[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        rs += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l_i[i] = l_i[i] * corr + rs;
      m_i[i] = m_new;
#pragma unroll
      for (int e = 0; e < EPT; ++e) acc[i][e] *= corr;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      *reinterpret_cast<float4*>(&pt[(tx + 16 * j) * TSTRIDE + 4 * ty]) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    }
    __syncthreads();

    // acc += p v over this tile's valid keys
    const int kn = min(BLOCK_N, n - k0);
    for (int c = 0; c < kn; ++c) {
      const float4 pv = *reinterpret_cast<const float4*>(&pt[c * TSTRIDE + 4 * ty]);
#pragma unroll
      for (int e = 0; e < EPT; ++e) {
        const float vv = vs[c * DMAX + tx + 16 * e];
        acc[0][e] = fmaf(pv.x, vv, acc[0][e]);
        acc[1][e] = fmaf(pv.y, vv, acc[1][e]);
        acc[2][e] = fmaf(pv.z, vv, acc[2][e]);
        acc[3][e] = fmaf(pv.w, vv, acc[3][e]);
      }
    }
  }

  T* oh = out + head;
  float* lh = lse + (size_t)blockIdx.y * n;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + 4 * ty + i;
    if (r >= n) continue;
    const float l = fmaxf(l_i[i], 1e-30f);
#pragma unroll
    for (int e = 0; e < EPT; ++e) {
      const int c = tx + 16 * e;
      if (c < d) narrow_store(&oh[(size_t)r * d + c], acc[i][e] / l);
    }
    if (tx == 0) lh[r] = m_i[i] + logf(l);
  }
}

template <typename T, int DMAX>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   void* lse, int bh, int n, int d, float scale,
                   cudaStream_t stream) {
  // the attribute belongs to the current device, so it is set on every
  // launch rather than cached once per process
  constexpr size_t smem = smem_bytes<DMAX>();
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, DMAX>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + BLOCK_M - 1) / BLOCK_M, bh);
  flash_fwd_kernel<T, DMAX><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out),
      static_cast<float*>(lse), n, d, scale);
  return cudaGetLastError();
}

}  // namespace

// C interface for ctypes. Returns a cudaError_t (0 on success). dtype: 0 is
// fp32, 1 is bf16. The caller allocates out (q's dtype) and lse (fp32).
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* out, void* lse,
                                   int bh, int n, int d, float scale,
                                   int dtype, void* stream) {
  if (bh <= 0 || bh > 65535 || n <= 0 || d <= 0 || d > 128 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return (int)(d <= 64
        ? launch<float, 64>(q, k, v, out, lse, bh, n, d, scale, s)
        : launch<float, 128>(q, k, v, out, lse, bh, n, d, scale, s));
  }
  return (int)(d <= 64
      ? launch<__nv_bfloat16, 64>(q, k, v, out, lse, bh, n, d, scale, s)
      : launch<__nv_bfloat16, 128>(q, k, v, out, lse, bh, n, d, scale, s));
}
