// Time-axis gather for NVIDIA Hopper (sm_90a): linear interpolation of
// per-sample positions, and its nearest (integer-index) variant.
//
// Replaces the TPU kernel semi_seg_ecg_tpu/ops/pallas/gather1d.py `_kernel`
// (launched by `_pallas_gather`, public entries `monotonic_gather` and
// `monotonic_gather_int`):
//
//   out[b, c, j] = x[b, c, i0] * (1 - w) + x[b, c, i1] * w
//   i0 = floor(pos[b, j]), w = pos[b, j] - i0, i1 = min(i0 + 1, T - 1)
//
// with pos in [0, T-1]; the integer variant copies y[b, idx[b, j]].
//
// What bounds it on an H100: nothing but memory. Each output element costs
// two reads of x (neighbours, mostly from the same cache line), one read of
// pos shared by the C leads, one write, and three flops. At the training
// path's shapes ((16, 1, 2500) f32: 0.3 MB moved) the bound is ~0.1 us and a
// launch costs more than the work; at (256, 12, 5000) it is 37 us.
//
// Design. One thread per output element over the flattened (b, c, j) index,
// reading x directly through the L1/L2 caches: the Pallas kernel's one-hot
// matmul over a 128-aligned input span is how a TPU turns a gather into MXU
// work, and a GPU reads an index directly. The maps are monotone, so
// neighbouring threads read neighbouring addresses and the reads coalesce.
// The arithmetic is written with __fmul_rn/__fadd_rn so nvcc cannot
// contract it into an FMA: the result equals the plain PyTorch version
// (two products and a sum, each rounded) bit for bit, and a w == 0 output
// is an exact copy of x[i0].

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
gather_lerp_kernel(const float* __restrict__ x, const float* __restrict__ pos,
                   float* __restrict__ out, int c, int t, int j,
                   long long total) {
  const long long idx = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (idx >= total) return;
  const int jj = (int)(idx % j);
  const long long bc = idx / j;  // b * c + lead
  const int b = (int)(bc / c);
  const float p = pos[(long long)b * j + jj];
  const float f = floorf(p);
  const int i0 = (int)f;
  const float w = __fadd_rn(p, -f);
  const int i1 = min(i0 + 1, t - 1);
  const float* row = x + bc * t;
  out[idx] = __fadd_rn(__fmul_rn(row[i0], __fadd_rn(1.0f, -w)),
                       __fmul_rn(row[i1], w));
}

// element-size-generic copy: labels of any 4- or 8-byte type
template <typename T>
__global__ void __launch_bounds__(THREADS)
gather_index_kernel(const T* __restrict__ y, const int* __restrict__ index,
                    T* __restrict__ out, int t, int j, long long total) {
  const long long idx = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (idx >= total) return;
  const long long b = idx / j;
  out[idx] = y[b * t + index[idx]];
}

int blocks_for(long long total) {
  return (int)((total + THREADS - 1) / THREADS);
}

}  // namespace

// C interface for ctypes. Each returns a cudaError_t (0 on success). The
// caller allocates the outputs and checks shapes, types and bounds.
extern "C" int gather1d_lerp(const void* x, const void* pos, void* out,
                             int b, int c, int t, int j, void* stream) {
  if (b <= 0 || c <= 0 || t <= 0 || j <= 0) return (int)cudaErrorInvalidValue;
  const long long total = (long long)b * c * j;
  gather_lerp_kernel<<<blocks_for(total), THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(pos),
      static_cast<float*>(out), c, t, j, total);
  return (int)cudaGetLastError();
}

extern "C" int gather1d_index(const void* y, const void* index, void* out,
                              int b, int t, int j, int elem_bytes,
                              void* stream) {
  if (b <= 0 || t <= 0 || j <= 0 || (elem_bytes != 4 && elem_bytes != 8))
    return (int)cudaErrorInvalidValue;
  const long long total = (long long)b * j;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 4) {
    gather_index_kernel<uint32_t><<<blocks_for(total), THREADS, 0, s>>>(
        static_cast<const uint32_t*>(y), static_cast<const int*>(index),
        static_cast<uint32_t*>(out), t, j, total);
  } else {
    gather_index_kernel<uint64_t><<<blocks_for(total), THREADS, 0, s>>>(
        static_cast<const uint64_t*>(y), static_cast<const int*>(index),
        static_cast<uint64_t*>(out), t, j, total);
  }
  return (int)cudaGetLastError();
}
