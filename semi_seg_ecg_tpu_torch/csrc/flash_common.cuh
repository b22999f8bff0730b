// Pieces shared by the flash-attention kernels (flash_attention_fwd.cu,
// flash_attention_bwd.cu): the strided tensor descriptor of the C interface,
// the tile loaders, and the warp-level tensor-core helpers (inline PTX for
// cp.async, ldmatrix, mma.sync m16n8k16 bf16 -> fp32 and m16n8k8 tf32 ->
// fp32).
//
// Fragment layouts of mma.sync.aligned.m16n8k16.row.col (lane = 4·g + t,
// g = lane / 4, t = lane % 4), which the bf16 kernels rely on:
//   A (16 x 16, row major), 4 registers of 2 bf16:
//     a0 = A[g][2t..2t+1],   a1 = A[g+8][2t..2t+1],
//     a2 = A[g][2t+8..2t+9], a3 = A[g+8][2t+8..2t+9]
//   B (16 x 8, k x n), 2 registers: b0 = B[2t..2t+1][g], b1 = B[2t+8..2t+9][g]
//   C (16 x 8, fp32), 4 registers: c0,c1 = C[g][2t..2t+1],
//     c2,c3 = C[g+8][2t..2t+1]
// Two C tiles side by side (16 x 16) are, packed to bf16, exactly an A tile:
// a product's result feeds the next product from registers.
//
// mma.sync.aligned.m16n8k8.row.col with tf32 operands, which the fp32
// kernels rely on: one 32-bit register per element,
//   A (16 x 8): a0 = A[g][t], a1 = A[g+8][t], a2 = A[g][t+4], a3 = A[g+8][t+4]
//   B (8 x 8, k x n): b0 = B[t][g], b1 = B[t+4][g]
//   C (16 x 8, fp32): as above, c0,c1 = C[g][2t..2t+1], c2,c3 = C[g+8][2t..2t+1]
// Here a C tile is not an A tile (its lane holds columns 2t, 2t+1; A wants
// t, t+4). When the next product contracts over C's columns, the index can
// be relabelled instead of shuffled: C's column 2t becomes A's column t and
// 2t+1 becomes t+4, and the B operand's rows are read in that same order
// (row 2t for b0, 2t+1 for b1; gemm_cb_tf32x3).
//
// fp32 accuracy from TF32 products (3xTF32): each fp32 operand x is split
// into hi = tf32(x), rounded to nearest (10 mantissa bits, ties away from
// zero), and lo = x − hi (exact in fp32), and a·b is hi·hi + hi·lo + lo·hi
// with fp32 accumulation. The tensor core reads the top 19 bits of each
// operand register, so lo enters truncated to tf32. The dropped lo·lo and
// that truncation leave about 2^-21 of |a||b| per product: within a few
// fp32 roundings, against TF32's 2^-11 (tests/test_torch_flash_attention.py
// emulates the split on the CPU and finds it as accurate as fp32).
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

// Stream rows [row0, row0 + ROWS) x columns [0, DMAX) of a bf16 or fp32
// operand into shared memory [ROWS][LD] with cp.async. Rows >= n and columns
// >= d are zero-filled (a src-size of 0 reads nothing; the address is kept
// in bounds all the same). `vec16`: base and strides are 16-byte aligned,
// so a thread copies 16 bytes at once; otherwise 4 (the wrapper guarantees
// 4).
template <int ROWS, int DMAX, int LD, int THREADS, typename T>
__device__ __forceinline__ void load_tile(T* dst, const T* src, long long sn,
                                          int row0, int n, int d,
                                          bool vec16) {
  constexpr int SIZE = sizeof(T);
  if (vec16) {
    constexpr int EPC = 16 / SIZE;  // elements per 16-byte chunk
    constexpr int CPR = DMAX / EPC;  // chunks per row
    static_assert(ROWS * CPR % THREADS == 0, "whole rounds of chunks");
#pragma unroll
    for (int it = 0; it < ROWS * CPR / THREADS; ++it) {
      const int i = threadIdx.x + it * THREADS;
      const int r = i / CPR, c = (i % CPR) * EPC;
      const int row = row0 + r;
      const bool ok = row < n && c < d;
      cp_async16(&dst[r * LD + c], ok ? src + row * sn + c : src,
                 ok ? SIZE * min(EPC, d - c) : 0);
    }
  } else {
    constexpr int EPC = 4 / SIZE;  // elements per 4-byte chunk
    constexpr int CPR = DMAX / EPC;
    static_assert(ROWS * CPR % THREADS == 0, "whole rounds of chunks");
#pragma unroll 4
    for (int it = 0; it < ROWS * CPR / THREADS; ++it) {
      const int i = threadIdx.x + it * THREADS;
      const int r = i / CPR, c = (i % CPR) * EPC;
      const int row = row0 + r;
      const bool ok = row < n && c < d;
      cp_async4(&dst[r * LD + c], ok ? src + row * sn + c : src,
                ok ? SIZE * min(EPC, d - c) : 0);
    }
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

// Store rows [row0, row0 + 16) of a warp's fp32 accumulator tile (16 x
// DMAX, as DMAX / 8 C tiles) times `mul` to an fp32 operand, rows < n and
// columns < d only.
template <int DMAX>
__device__ __forceinline__ void store_rows(float* dst, long long sn,
                                          float (*acc)[4], int row0, int n,
                                          int d, float mul_lo,
                                          float mul_hi) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < DMAX / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = row0 + g + 8 * (e >> 1), c = 8 * j + 2 * t + (e & 1);
      if (r < n && c < d)
        dst[r * sn + c] = acc[j][e] * (e < 2 ? mul_lo : mul_hi);
    }
  }
}

// x = hi + lo: hi is x rounded to tf32 (to nearest, ties away from zero,
// as cvt.rna.tf32.f32 rounds finite values: half of the 13 dropped bits
// added to the magnitude's bits, then cleared), lo the exact rest, which
// the tensor core truncates to tf32. Two integer operations and a
// subtraction: cvt.rna.tf32.f32 compiles to a longer sequence (a compare
// and selects for NaN and infinities), and the splits are a large share of
// the fp32 kernels' instructions.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// c += a · b on the tensor cores: tf32 operands, fp32 accumulation
__device__ __forceinline__ void mma_tf32(float c[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c[j] += a · b[j] for the 8 n-tiles j to fp32 accuracy (3xTF32): the
// lo·hi products of all 8 tiles, then hi·lo, then hi·hi, so that no mma
// waits on the one issued just before it (at the serving shape one warp
// per scheduler has nothing else to issue meanwhile)
__device__ __forceinline__ void mma8_3xtf32(float (*c)[4],
                                            const uint32_t a_hi[4],
                                            const uint32_t a_lo[4],
                                            const uint32_t (*b_hi)[2],
                                            const uint32_t (*b_lo)[2]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) mma_tf32(c[j], a_lo, b_hi[j]);
#pragma unroll
  for (int j = 0; j < 8; ++j) mma_tf32(c[j], a_hi, b_lo[j]);
#pragma unroll
  for (int j = 0; j < 8; ++j) mma_tf32(c[j], a_hi, b_hi[j]);
}

// A fragment of 16 rows x 8 columns of a row-major fp32 tile in shared
// memory (row stride LD), split: rows g, g + 8, columns t, t + 4. ldmatrix
// moves 8 rows of 16 bytes per matrix and gives lane 4g + t the 32-bit word
// t of row g, which is the tf32 fragment layout: one ldmatrix.x4 for the
// four 8 x 4 quarters (rows 0-7 / 8-15, columns 0-3 / 4-7). LD is 4
// modulo 32, so the 8 rows of a matrix start on 8 distinct bank quads.
template <int LD>
__device__ __forceinline__ void load_a_tf32(uint32_t hi[4], uint32_t lo[4],
                                            const float* a, int lane) {
  uint32_t r[4];
  ldmatrix_x4(r, a + ((lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                     (lane >> 4) * 4);
#pragma unroll
  for (int e = 0; e < 4; ++e) split_tf32(__uint_as_float(r[e]), hi[e], lo[e]);
}

// s = A Bᵀ (16 x 64, 8 C tiles) to fp32 accuracy: A is 16 rows and B 64
// rows of row-major fp32 tiles in shared memory (row stride LD), over the
// DMAX / 8 k-steps of 8 columns (the tiles are zero past the head dim; a
// runtime bound on the k-steps cost the loop its scheduling across them).
// B's fragments, b0 = B[8j + g][t] and b1 = B[8j + g][t + 4], come two
// tiles per ldmatrix.x4 and are read for all 8 tiles before the products.
template <int DMAX, int LD>
__device__ __forceinline__ void gemm_abt_tf32x3(float s[8][4], const float* a,
                                                const float* b, int lane) {
#pragma unroll
  for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
  const float* brow =
      b + ((lane & 7) + (lane >> 4) * 8) * LD + ((lane >> 3) & 1) * 4;
#pragma unroll
  for (int st = 0; st < DMAX / 8; ++st) {
    uint32_t a_hi[4], a_lo[4], b_hi[8][2], b_lo[8][2];
    load_a_tf32<LD>(a_hi, a_lo, a + 8 * st, lane);
#pragma unroll
    for (int j = 0; j < 8; j += 2) {
      uint32_t r[4];
      ldmatrix_x4(r, brow + 8 * j * LD + 8 * st);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        split_tf32(__uint_as_float(r[e]), b_hi[j + e / 2][e % 2],
                   b_lo[j + e / 2][e % 2]);
    }
    mma8_3xtf32(s, a_hi, a_lo, b_hi, b_lo);
  }
}

// acc (16 x DMAX, DMAX / 8 C tiles) += C B to fp32 accuracy: C is 16 x 64
// in registers (8 C tiles), B 64 rows x DMAX of a row-major fp32 tile in
// shared memory. C feeds the A operand as it lies, its columns relabelled
// (C's column 2t is A's column t, 2t + 1 is t + 4), and B's rows are read
// in that order: b0 = B[8kk + 2t][8p + g], b1 = B[8kk + 2t + 1][8p + g].
// LD is 4 modulo 32, so rows 2t of the four t land 8 banks apart.
template <int DMAX, int LD>
__device__ __forceinline__ void gemm_cb_tf32x3(float (*acc)[4],
                                               const float c[8][4],
                                               const float* b, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    uint32_t a_hi[4], a_lo[4];
    split_tf32(c[kk][0], a_hi[0], a_lo[0]);
    split_tf32(c[kk][2], a_hi[1], a_lo[1]);
    split_tf32(c[kk][1], a_hi[2], a_lo[2]);
    split_tf32(c[kk][3], a_hi[3], a_lo[3]);
    const float* rows = b + (8 * kk + 2 * t) * LD + g;
#pragma unroll
    for (int p0 = 0; p0 < DMAX / 8; p0 += 8) {
      uint32_t b_hi[8][2], b_lo[8][2];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        split_tf32(rows[8 * (p0 + j)], b_hi[j][0], b_lo[j][0]);
        split_tf32(rows[LD + 8 * (p0 + j)], b_hi[j][1], b_lo[j][1]);
      }
      mma8_3xtf32(acc + p0, a_hi, a_lo, b_hi, b_lo);
    }
  }
}

}  // namespace flash
