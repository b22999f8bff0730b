// Flash-attention backward for NVIDIA Hopper (sm_90a), fp32 and bf16 inputs.
//
// Replaces the TPU kernel semi_seg_ecg_tpu/ops/pallas/flash_attention.py
// `_bwd_kernel` (launched by `_flash_backward`, the custom VJP's backward).
// From q, k, v, the forward's row logsumexp `lse`, the output gradient dO
// and Δ = rowsum(dO ⊙ O) (computed by the caller, as the JAX package does
// outside its kernel) it recomputes the probabilities blockwise and forms
//
//   P  = exp(S − lse),  S = q kᵀ · scale
//   dV = Pᵀ dO,  dP = dO Vᵀ,  dS = P ⊙ (dP − Δ)
//   dQ = dS K · scale,  dK = dSᵀ Q · scale
//
// without the (N, N) matrices in device memory. Rows and columns >= N are
// masked (P = 0 there, as `_bwd_kernel` masks with `row_valid` and
// `col < n_valid`). Tensors are (B·H, N, D) contiguous, lse and Δ (B·H, N)
// fp32. All arithmetic is fp32 on CUDA cores; gradients are stored in the
// input dtype, as the Pallas kernel's fp32 results are cast back.
//
// Two kernels, so that no gradient is summed across CTAs with atomics and
// every result is deterministic:
//   (a) flash_bwd_dkdv: one CTA per (b·h, 64-key tile). K and V stay in
//       shared memory; q, dO, lse and Δ tiles stream through; dK and dV
//       accumulate in registers.
//   (b) flash_bwd_dq:   one CTA per (b·h, 64-query tile). q, dO, lse and Δ
//       stay; K and V tiles stream through; dQ accumulates in registers.
// Both recompute S and dP (four N²·D products between them, plus dV, dK and
// dQ: 10·B·H·N²·D flops in all, against the forward's 4·B·H·N²·D).
//
// What bounds it on an H100 (3.35 TB/s, 67 TFLOP/s fp32 outside the tensor
// cores, 989 TFLOP/s bf16 in them). At the ViT-tiny training shape (B=32,
// H=3, N=101, D=64) the work is 0.63 GFLOP over 8 tensors of 2.5 MB (fp32):
// ~9.4 us of fp32 FMA against ~6 us of memory. The grids there are 2 x 96
// CTAs, one wave each, so a call takes about two CTA latencies, as the
// forward takes one (PERF.md). Tensor cores (wgmma) and overlapped tile
// loads are the steps that make it fast, left for later.
//
// Thread layout, as in the forward: 256 threads form a 16 x 16 grid; in
// (a) thread (ty, tx) owns key rows 4ty..4ty+3 and query columns tx+16j of
// the transposed score tile, and key rows 4ty..4ty+3, columns tx+16e of the
// dK/dV accumulators; in (b) query rows 4ty.., key columns tx+16j, and dQ
// columns tx+16e. Operands read four rows at a time are stored transposed
// and read as float4; operands read by column are stored with rows padded
// to D+1 floats, which keeps a warp's reads on distinct banks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BLOCK = 64;          // q rows and keys per tile
constexpr int THREADS = 256;       // 16 x 16 thread grid
constexpr int TSTRIDE = BLOCK + 4; // row stride of the transposed tiles

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void narrow_store(float* p, float x) { *p = x; }
__device__ __forceinline__ void narrow_store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

template <int DMAX>
constexpr size_t dkdv_smem_floats() {
  return 2 * DMAX * TSTRIDE           // k, v tiles, transposed
         + 2 * BLOCK * (DMAX + 1)     // q (pre-scaled), dO tiles, padded rows
         + 2 * BLOCK * TSTRIDE        // P, dS tiles, [q row][key]
         + 2 * BLOCK;                 // lse, Δ
}

template <int DMAX>
constexpr size_t dq_smem_floats() {
  return 2 * DMAX * TSTRIDE           // q (pre-scaled), dO tiles, transposed
         + 2 * BLOCK * (DMAX + 1)     // k, v tiles, padded rows
         + BLOCK * TSTRIDE;           // dS tile, [key][q row]
}

// (a) dK and dV for one 64-key tile of one (batch, head)
template <typename T, int DMAX>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               T* __restrict__ dk, T* __restrict__ dv, int n, int d,
               float scale) {
  constexpr int EPT = DMAX / 16;  // accumulator columns per thread
  constexpr int QS = DMAX + 1;    // padded row stride
  extern __shared__ __align__(16) float smem[];
  float* kt = smem;                       // [DMAX][TSTRIDE]
  float* vt = kt + DMAX * TSTRIDE;        // [DMAX][TSTRIDE]
  float* qs = vt + DMAX * TSTRIDE;        // [BLOCK][QS]
  float* dos = qs + BLOCK * QS;           // [BLOCK][QS]
  float* pt = dos + BLOCK * QS;           // [BLOCK q][TSTRIDE keys]
  float* dst = pt + BLOCK * TSTRIDE;      // [BLOCK q][TSTRIDE keys]
  float* lse_s = dst + BLOCK * TSTRIDE;   // [BLOCK]
  float* delta_s = lse_s + BLOCK;         // [BLOCK]

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int k0 = blockIdx.x * BLOCK;
  const size_t head = (size_t)blockIdx.y * n * d;
  const T* qh = q + head;
  const T* doh = dout + head;
  const float* lh = lse + (size_t)blockIdx.y * n;
  const float* dh = delta + (size_t)blockIdx.y * n;

  for (int idx = tid; idx < BLOCK * DMAX; idx += THREADS) {
    const int r = idx / DMAX, c = idx % DMAX;
    float kx = 0.f, vx = 0.f;
    if (k0 + r < n && c < d) {
      const size_t off = head + (size_t)(k0 + r) * d + c;
      kx = widen(k[off]);
      vx = widen(v[off]);
    }
    kt[c * TSTRIDE + r] = kx;
    vt[c * TSTRIDE + r] = vx;
  }

  float acc_dk[4][EPT], acc_dv[4][EPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < EPT; ++e) acc_dk[i][e] = acc_dv[i][e] = 0.f;

  const int num_qb = (n + BLOCK - 1) / BLOCK;
  for (int qb = 0; qb < num_qb; ++qb) {
    const int q0 = qb * BLOCK;
    __syncthreads();  // the previous tile's readers are done
    for (int idx = tid; idx < BLOCK * DMAX; idx += THREADS) {
      const int r = idx / DMAX, c = idx % DMAX;
      float qx = 0.f, dx = 0.f;
      if (q0 + r < n && c < d) {
        const size_t off = (size_t)(q0 + r) * d + c;
        qx = widen(qh[off]) * scale;  // pre-scaled, as in the forward
        dx = widen(doh[off]);
      }
      qs[r * QS + c] = qx;
      dos[r * QS + c] = dx;
    }
    if (tid < BLOCK) {
      const bool ok = q0 + tid < n;
      lse_s[tid] = ok ? lh[q0 + tid] : 0.f;
      delta_s[tid] = ok ? dh[q0 + tid] : 0.f;
    }
    __syncthreads();

    // Sᵀ and dPᵀ for key rows 4ty+i, query columns tx+16j; the sums run
    // over c in the forward's order, so S is bit-equal to the S its lse
    // was taken over
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < d; ++c) {
      const float4 k4 = ld4(&kt[c * TSTRIDE + 4 * ty]);
      const float4 v4 = ld4(&vt[c * TSTRIDE + 4 * ty]);
      const float kr[4] = {k4.x, k4.y, k4.z, k4.w};
      const float vr[4] = {v4.x, v4.y, v4.z, v4.w};
      float qc[4], dc[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        qc[j] = qs[(tx + 16 * j) * QS + c];
        dc[j] = dos[(tx + 16 * j) * QS + c];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qc[j], kr[i], s[i][j]);
          dp[i][j] = fmaf(dc[j], vr[i], dp[i][j]);
        }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int qr = tx + 16 * j;
      const bool row_ok = q0 + qr < n;
      float p[4], ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool ok = row_ok && k0 + 4 * ty + i < n;
        p[i] = ok ? expf(s[i][j] - lse_s[qr]) : 0.f;
        ds[i] = p[i] * (dp[i][j] - delta_s[qr]);
      }
      *reinterpret_cast<float4*>(&pt[qr * TSTRIDE + 4 * ty]) =
          make_float4(p[0], p[1], p[2], p[3]);
      *reinterpret_cast<float4*>(&dst[qr * TSTRIDE + 4 * ty]) =
          make_float4(ds[0], ds[1], ds[2], ds[3]);
    }
    __syncthreads();

    // dV += Pᵀ dO and dK += dSᵀ (q · scale) over this tile's valid rows
    const int qn = min(BLOCK, n - q0);
    for (int r = 0; r < qn; ++r) {
      const float4 p4 = ld4(&pt[r * TSTRIDE + 4 * ty]);
      const float4 d4 = ld4(&dst[r * TSTRIDE + 4 * ty]);
#pragma unroll
      for (int e = 0; e < EPT; ++e) {
        const float dov = dos[r * QS + tx + 16 * e];
        const float qv = qs[r * QS + tx + 16 * e];
        acc_dv[0][e] = fmaf(p4.x, dov, acc_dv[0][e]);
        acc_dv[1][e] = fmaf(p4.y, dov, acc_dv[1][e]);
        acc_dv[2][e] = fmaf(p4.z, dov, acc_dv[2][e]);
        acc_dv[3][e] = fmaf(p4.w, dov, acc_dv[3][e]);
        acc_dk[0][e] = fmaf(d4.x, qv, acc_dk[0][e]);
        acc_dk[1][e] = fmaf(d4.y, qv, acc_dk[1][e]);
        acc_dk[2][e] = fmaf(d4.z, qv, acc_dk[2][e]);
        acc_dk[3][e] = fmaf(d4.w, qv, acc_dk[3][e]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = k0 + 4 * ty + i;
    if (r >= n) continue;
#pragma unroll
    for (int e = 0; e < EPT; ++e) {
      const int c = tx + 16 * e;
      if (c < d) {
        narrow_store(&dk[head + (size_t)r * d + c], acc_dk[i][e]);
        narrow_store(&dv[head + (size_t)r * d + c], acc_dv[i][e]);
      }
    }
  }
}

// (b) dQ for one 64-query tile of one (batch, head)
template <typename T, int DMAX>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const T* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             T* __restrict__ dq, int n, int d, float scale) {
  constexpr int EPT = DMAX / 16;
  constexpr int KS = DMAX + 1;
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;                       // [DMAX][TSTRIDE]
  float* dot = qt + DMAX * TSTRIDE;       // [DMAX][TSTRIDE]
  float* ks = dot + DMAX * TSTRIDE;       // [BLOCK][KS]
  float* vs = ks + BLOCK * KS;            // [BLOCK][KS]
  float* dst = vs + BLOCK * KS;           // [BLOCK keys][TSTRIDE q rows]

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int q0 = blockIdx.x * BLOCK;
  const size_t head = (size_t)blockIdx.y * n * d;
  const T* kh = k + head;
  const T* vh = v + head;

  for (int idx = tid; idx < BLOCK * DMAX; idx += THREADS) {
    const int r = idx / DMAX, c = idx % DMAX;
    float qx = 0.f, dx = 0.f;
    if (q0 + r < n && c < d) {
      const size_t off = head + (size_t)(q0 + r) * d + c;
      qx = widen(q[off]) * scale;
      dx = widen(dout[off]);
    }
    qt[c * TSTRIDE + r] = qx;
    dot[c * TSTRIDE + r] = dx;
  }
  float lse_r[4], delta_r[4];
  bool row_ok[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + 4 * ty + i;
    row_ok[i] = r < n;
    lse_r[i] = row_ok[i] ? lse[(size_t)blockIdx.y * n + r] : 0.f;
    delta_r[i] = row_ok[i] ? delta[(size_t)blockIdx.y * n + r] : 0.f;
  }

  float acc[4][EPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < EPT; ++e) acc[i][e] = 0.f;

  const int num_kb = (n + BLOCK - 1) / BLOCK;
  for (int kb = 0; kb < num_kb; ++kb) {
    const int k0 = kb * BLOCK;
    __syncthreads();  // the previous tile's readers are done
    for (int idx = tid; idx < BLOCK * DMAX; idx += THREADS) {
      const int r = idx / DMAX, c = idx % DMAX;
      float kx = 0.f, vx = 0.f;
      if (k0 + r < n && c < d) {
        const size_t off = (size_t)(k0 + r) * d + c;
        kx = widen(kh[off]);
        vx = widen(vh[off]);
      }
      ks[r * KS + c] = kx;
      vs[r * KS + c] = vx;
    }
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < d; ++c) {
      const float4 q4 = ld4(&qt[c * TSTRIDE + 4 * ty]);
      const float4 d4 = ld4(&dot[c * TSTRIDE + 4 * ty]);
      const float qr[4] = {q4.x, q4.y, q4.z, q4.w};
      const float dr[4] = {d4.x, d4.y, d4.z, d4.w};
      float kc[4], vc[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kc[j] = ks[(tx + 16 * j) * KS + c];
        vc[j] = vs[(tx + 16 * j) * KS + c];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qr[i], kc[j], s[i][j]);
          dp[i][j] = fmaf(dr[i], vc[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool col_ok = k0 + tx + 16 * j < n;
      float ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p =
            (row_ok[i] && col_ok) ? expf(s[i][j] - lse_r[i]) : 0.f;
        ds[i] = p * (dp[i][j] - delta_r[i]);
      }
      *reinterpret_cast<float4*>(&dst[(tx + 16 * j) * TSTRIDE + 4 * ty]) =
          make_float4(ds[0], ds[1], ds[2], ds[3]);
    }
    __syncthreads();

    // dQ += dS K over this tile's valid keys
    const int kn = min(BLOCK, n - k0);
    for (int r = 0; r < kn; ++r) {
      const float4 d4 = ld4(&dst[r * TSTRIDE + 4 * ty]);
#pragma unroll
      for (int e = 0; e < EPT; ++e) {
        const float kv = ks[r * KS + tx + 16 * e];
        acc[0][e] = fmaf(d4.x, kv, acc[0][e]);
        acc[1][e] = fmaf(d4.y, kv, acc[1][e]);
        acc[2][e] = fmaf(d4.z, kv, acc[2][e]);
        acc[3][e] = fmaf(d4.w, kv, acc[3][e]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (!row_ok[i]) continue;
    const int r = q0 + 4 * ty + i;
#pragma unroll
    for (int e = 0; e < EPT; ++e) {
      const int c = tx + 16 * e;
      if (c < d) narrow_store(&dq[head + (size_t)r * d + c], acc[i][e] * scale);
    }
  }
}

template <typename T, int DMAX>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dq, void* dk, void* dv, int bh, int n, int d,
                   float scale, cudaStream_t stream) {
  // the attributes belong to the current device, so they are set on every
  // launch rather than cached once per process
  constexpr size_t smem_a = sizeof(float) * dkdv_smem_floats<DMAX>();
  constexpr size_t smem_b = sizeof(float) * dq_smem_floats<DMAX>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv<T, DMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_a);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dq<T, DMAX>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_b);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + BLOCK - 1) / BLOCK, bh);
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* dop = static_cast<const T*>(dout);
  const float* lp = static_cast<const float*>(lse);
  const float* dp = static_cast<const float*>(delta);
  flash_bwd_dkdv<T, DMAX><<<grid, THREADS, smem_a, stream>>>(
      qp, kp, vp, dop, lp, dp, static_cast<T*>(dk), static_cast<T*>(dv), n,
      d, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dq<T, DMAX><<<grid, THREADS, smem_b, stream>>>(
      qp, kp, vp, dop, lp, dp, static_cast<T*>(dq), n, d, scale);
  return cudaGetLastError();
}

}  // namespace

// C interface for ctypes. Returns a cudaError_t (0 on success). dtype: 0 is
// fp32, 1 is bf16 (q, k, v, dout, dq, dk, dv); lse and delta are fp32. The
// caller allocates dq, dk, dv.
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const void* lse, const void* delta,
                                   void* dq, void* dk, void* dv, int bh,
                                   int n, int d, float scale, int dtype,
                                   void* stream) {
  if (bh <= 0 || bh > 65535 || n <= 0 || d <= 0 || d > 128 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return (int)(d <= 64
        ? launch<float, 64>(q, k, v, dout, lse, delta, dq, dk, dv, bh, n, d,
                            scale, s)
        : launch<float, 128>(q, k, v, dout, lse, delta, dq, dk, dv, bh, n, d,
                             scale, s));
  }
  return (int)(d <= 64
      ? launch<__nv_bfloat16, 64>(q, k, v, dout, lse, delta, dq, dk, dv, bh,
                                  n, d, scale, s)
      : launch<__nv_bfloat16, 128>(q, k, v, dout, lse, delta, dq, dk, dv, bh,
                                   n, d, scale, s));
}
