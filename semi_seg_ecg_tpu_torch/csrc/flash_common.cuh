// Pieces shared by the flash-attention kernels (flash_attention_fwd.cu,
// flash_attention_bwd.cu): the strided tensor descriptor of the C interface,
// and the warp-level tensor-core helpers of the bf16 kernels (inline PTX for
// cp.async, ldmatrix and mma.sync m16n8k16 bf16 -> fp32).
//
// Fragment layouts of mma.sync.aligned.m16n8k16.row.col (lane = 4·g + t,
// g = lane / 4, t = lane % 4), which the kernels rely on:
//   A (16 x 16, row major), 4 registers of 2 bf16:
//     a0 = A[g][2t..2t+1],   a1 = A[g+8][2t..2t+1],
//     a2 = A[g][2t+8..2t+9], a3 = A[g+8][2t+8..2t+9]
//   B (16 x 8, k x n), 2 registers: b0 = B[2t..2t+1][g], b1 = B[2t+8..2t+9][g]
//   C (16 x 8, fp32), 4 registers: c0,c1 = C[g][2t..2t+1],
//     c2,c3 = C[g+8][2t..2t+1]
// Two C tiles side by side (16 x 16) are, packed to bf16, exactly an A tile:
// a product's result feeds the next product from registers.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// One (B, H, N, D) operand: its base pointer and the element strides of B,
// H and N. The last dimension has stride 1.
struct Tensor4 {
  void* ptr;
  long long sb, sh, sn;
};

namespace flash {

constexpr float LOG2E = 1.4426950408889634f;  // exp(x) = exp2(x · LOG2E)
constexpr float LN2 = 0.69314718055994531f;

// element offset of row 0 of (batch·heads + head) = bh
__host__ __device__ __forceinline__ long long head_offset(const Tensor4& t,
                                                          int bh, int heads) {
  return (long long)(bh / heads) * t.sb + (long long)(bh % heads) * t.sh;
}

// true when the base and the B, H, N strides are multiples of `bytes`
inline bool aligned_to(const Tensor4& t, int elem, int bytes) {
  return (reinterpret_cast<uintptr_t>(t.ptr) % bytes) == 0 &&
         (t.sb * elem) % bytes == 0 && (t.sh * elem) % bytes == 0 &&
         (t.sn * elem) % bytes == 0;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async of `bytes` (<= 16; the rest of the 16 is zero-filled)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes));
}

// cp.async of `bytes` (<= 4; the rest of the 4 is zero-filled)
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i
__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a · b on the tensor cores: bf16 operands, fp32 accumulation
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two fp32 values rounded to bf16 (round to nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// the A operand (16 rows x 16) made of the C tiles c[j] and c[j + 1]
__device__ __forceinline__ void c_to_a(uint32_t a[4], const float c0[4],
                                       const float c1[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// Stream rows [row0, row0 + ROWS) x columns [0, DMAX) of a bf16 operand
// into shared memory [ROWS][LD] with cp.async. Rows >= n and columns >= d
// are zero-filled (a src-size of 0 reads nothing; the address is kept in
// bounds all the same). `vec16`: base and strides are 16-byte aligned, so
// a thread copies 16 bytes at once; otherwise 4 (the wrapper guarantees 4).
template <int ROWS, int DMAX, int LD, int THREADS>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          long long sn, int row0, int n,
                                          int d, bool vec16) {
  if (vec16) {
    constexpr int CPR = DMAX / 8;  // 16-byte chunks per row
    static_assert(ROWS * CPR % THREADS == 0, "whole rounds of chunks");
#pragma unroll
    for (int it = 0; it < ROWS * CPR / THREADS; ++it) {
      const int i = threadIdx.x + it * THREADS;
      const int r = i / CPR, c = (i % CPR) * 8;
      const int row = row0 + r;
      const bool ok = row < n && c < d;
      cp_async16(&dst[r * LD + c], ok ? src + row * sn + c : src,
                 ok ? 2 * min(8, d - c) : 0);
    }
  } else {
    constexpr int CPR = DMAX / 2;  // 4-byte chunks per row
    static_assert(ROWS * CPR % THREADS == 0, "whole rounds of chunks");
#pragma unroll 4
    for (int it = 0; it < ROWS * CPR / THREADS; ++it) {
      const int i = threadIdx.x + it * THREADS;
      const int r = i / CPR, c = (i % CPR) * 2;
      const int row = row0 + r;
      const bool ok = row < n && c < d;
      cp_async4(&dst[r * LD + c], ok ? src + row * sn + c : src,
                ok ? 2 * min(2, d - c) : 0);
    }
  }
}

// A thread's share of rows [row0, row0 + ROWS) x columns [0, DMAX) of one
// or two fp32 operands (a, and b where TWO): put(r, c, a[row0 + r][c],
// b[row0 + r][c]) for each of its rows r, with 0 past n and d. THREADS is a
// multiple of DMAX, so a thread keeps one column. The loads go out in
// batches of BATCH rows into registers before any is stored: stored one
// by one, each row's load would wait out the memory latency on its own.
template <int ROWS, int DMAX, int THREADS, bool TWO, typename Put>
__device__ __forceinline__ void load_fp32(const float* a, long long sa,
                                          const float* b, long long sb,
                                          int row0, int n, int d, Put put) {
  constexpr int RSTEP = THREADS / DMAX;  // rows apart of a thread's loads
  constexpr int COUNT = ROWS / RSTEP;
  constexpr int BATCH = COUNT < 8 ? COUNT : 8;
  static_assert(THREADS % DMAX == 0 && ROWS % RSTEP == 0 &&
                COUNT % BATCH == 0, "whole rows per round and batch");
  const int c = threadIdx.x % DMAX, r0 = threadIdx.x / DMAX;
  const float* pa = a + (row0 + r0) * sa + c;
  const float* pb = b + (row0 + r0) * sb + c;
#pragma unroll
  for (int i0 = 0; i0 < COUNT; i0 += BATCH) {
    float x[BATCH], y[BATCH];
#pragma unroll
    for (int j = 0; j < BATCH; ++j) {
      const int i = i0 + j;
      const bool ok = row0 + r0 + i * RSTEP < n && c < d;
      x[j] = ok ? __ldg(pa + i * RSTEP * sa) : 0.f;
      y[j] = (TWO && ok) ? __ldg(pb + i * RSTEP * sb) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < BATCH; ++j)
      put(r0 + (i0 + j) * RSTEP, c, x[j], y[j]);
  }
}

// Store rows [row0, row0 + 16) of a warp's fp32 accumulator tile (16 x
// DMAX, as DMAX / 8 C tiles) times `mul` to a bf16 operand, rows < n and
// columns < d only.
template <int DMAX>
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst, long long sn,
                                           float (*acc)[4], int row0,
                                           int n, int d, float mul_lo,
                                           float mul_hi) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < DMAX / 8; ++j) {
    const int c = 8 * j + 2 * t;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = row0 + g + 8 * half;
      const float mul = half ? mul_hi : mul_lo;
      if (r >= n || c >= d) continue;
      __nv_bfloat16* p = dst + r * sn + c;
      const float x0 = acc[j][2 * half] * mul;
      const float x1 = acc[j][2 * half + 1] * mul;
      if (c + 1 < d) {
        *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x0, x1);
      } else {
        *p = __float2bfloat16_rn(x0);
      }
    }
  }
}

}  // namespace flash
