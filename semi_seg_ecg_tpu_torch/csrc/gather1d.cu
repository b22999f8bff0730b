// Time-axis gather for NVIDIA Hopper (sm_90a): linear interpolation of
// per-sample positions, and its nearest (integer-index) variant for labels,
// alone or both in one launch.
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
// What bounds it on an H100: memory alone. Each output costs one read of
// pos shared by the C leads, the reads of x its neighbours touch (mostly
// the same sectors as its neighbours'), one write, and three flops. At the
// training path's shapes ((16, 1, 2500) f32: 0.3 MB moved) the bound is
// ~0.1 us and a launch costs more than the work; at (256, 12, 5000) it is
// 34 us.
//
// Design. The Pallas kernel's one-hot matmul over a 128-aligned input span
// is how a TPU turns a gather into MXU work; a GPU reads an index
// directly, through L1. The grid is (output tiles, batch): blockIdx.y is
// the sample and blockIdx.x a tile of THREADS outputs, so no thread
// divides an index. A thread takes one output position: it reads pos
// once, forms i0, i1 and the weights once, and walks the C leads with
// them, so neighbouring threads read neighbouring elements of x and write
// neighbouring outputs (coalesced 4-byte accesses) for every lead. The
// labels take blocks of their own in the same grid: a pair launch gathers
// the resize-crop's signal and labels at once. A launch at the training
// path's shapes costs the card its launch floor plus the latency of two
// dependent reads, and a shorter instruction path shortens the latter, so
// each launch runs a kernel compiled for what it does: the signal, the
// labels or both, and with one lead (the training path) no lead loop. Four
// outputs per thread with 16-byte loads of pos and 16-byte stores was the
// first design; on the card it was no faster at (256, 12, 5000) and slower at
// the training shapes, where each warp's reads of x then span four times
// as many cache lines (PERF.md, Findings). The reads never assume a
// monotone map or a slope bound: any pos in [0, T-1] gives the plain
// version's result (indices are clamped into the row, so a position
// outside it cannot read outside x). The arithmetic is written with
// __fmul_rn/__fadd_rn so nvcc cannot contract it into an FMA: the result
// equals the plain PyTorch version (two products and a sum, each rounded)
// bit for bit, and a w == 0 output is an exact copy of x[i0].

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;  // output positions per block

struct Lerp {    // out (B, C, J) from x (B, C, T) at pos (B, J)
  const float* x;
  const float* pos;
  float* out;
  int c, t, j, tiles;
};

template <typename L>
struct Index {   // out (B, J) from y (B, T) at idx (B, J)
  const L* y;
  const int* idx;
  L* out;
  int t, j, tiles;
};

int tiles_for(int j) { return (j + THREADS - 1) / THREADS; }

// output position jj of sample b, every lead (one if ONE_LEAD)
template <bool ONE_LEAD>
__device__ __forceinline__ void lerp_at(const float* __restrict__ x,
                                        const float* __restrict__ pos,
                                        float* __restrict__ out, int b,
                                        int c, int t, int j, int jj) {
  const float p = __ldg(pos + (long long)b * j + jj);
  const float f = floorf(p);
  const int i0 = min(max((int)f, 0), t - 1);
  const int i1 = min(i0 + 1, t - 1);
  const float w = __fadd_rn(p, -f);
  const float v = __fadd_rn(1.0f, -w);
  const long long row = (long long)b * c;
  const int leads = ONE_LEAD ? 1 : c;
  for (int l = 0; l < leads; ++l) {
    const float* xr = x + (row + l) * t;
    out[(row + l) * j + jj] = __fadd_rn(__fmul_rn(__ldg(xr + i0), v),
                                        __fmul_rn(__ldg(xr + i1), w));
  }
}

// one launch of the signal (SIGNAL), the labels (LABELS) or both: blocks
// [0, a.tiles) of a sample interpolate its signal, the next s.tiles copy
// its labels (4- or 8-byte elements)
template <typename L, bool SIGNAL, bool LABELS, bool ONE_LEAD>
__global__ void __launch_bounds__(THREADS)
gather1d_kernel(const Lerp a, const Index<L> s) {
  const int b = blockIdx.y;
  if (SIGNAL && (!LABELS || (int)blockIdx.x < a.tiles)) {
    const int jj = blockIdx.x * THREADS + threadIdx.x;
    if (jj < a.j)
      lerp_at<ONE_LEAD>(a.x, a.pos, a.out, b, a.c, a.t, a.j, jj);
  } else if (LABELS) {
    const int jj = (blockIdx.x - a.tiles) * THREADS + threadIdx.x;
    if (jj < s.j) {
      const long long r = (long long)b * s.j + jj;
      s.out[r] = __ldg(s.y + (long long)b * s.t
                       + min(max(__ldg(s.idx + r), 0), s.t - 1));
    }
  }
}

__global__ void empty_kernel() {}

template <typename L, bool SIGNAL, bool LABELS>
int launch(const Lerp& a, const Index<L>& s, int b, cudaStream_t stream) {
  const dim3 grid(a.tiles + s.tiles, b);
  if (!SIGNAL || a.c == 1) {
    gather1d_kernel<L, SIGNAL, LABELS, true>
        <<<grid, THREADS, 0, stream>>>(a, s);
  } else {
    gather1d_kernel<L, SIGNAL, LABELS, false>
        <<<grid, THREADS, 0, stream>>>(a, s);
  }
  return (int)cudaGetLastError();
}

template <typename L>
int launch_labels(const Lerp& a, const void* y, const void* idx, void* yout,
                  int b, int ty, int jy, cudaStream_t stream) {
  const Index<L> s{static_cast<const L*>(y), static_cast<const int*>(idx),
                   static_cast<L*>(yout), ty, jy, tiles_for(jy)};
  return a.tiles ? launch<L, true, true>(a, s, b, stream)
                 : launch<L, false, true>(a, s, b, stream);
}

}  // namespace

// C interface for ctypes; returns a cudaError_t (0 on success). One launch
// does the signal's interpolation (x (B, C, T) fp32 at pos (B, J) fp32 into
// out (B, C, J)), the labels' copy (y (B, TY) of elem_bytes 4 or 8 at idx
// (B, JY) int32 into yout (B, JY)), or both: c == 0 leaves out the signal,
// jy == 0 the labels. The caller allocates the outputs and checks shapes,
// types and contiguity.
extern "C" int gather1d(const void* x, const void* pos, void* out, int b,
                        int c, int t, int j, const void* y, const void* idx,
                        void* yout, int ty, int jy, int elem_bytes,
                        void* stream) {
  const bool signal = c > 0, labels = jy > 0;
  if (b <= 0 || b > 65535 || !(signal || labels)
      || (signal && (t <= 0 || j <= 0))
      || (labels && (ty <= 0 || (elem_bytes != 4 && elem_bytes != 8))))
    return (int)cudaErrorInvalidValue;
  const Lerp a{static_cast<const float*>(x), static_cast<const float*>(pos),
               static_cast<float*>(out), c, t, j,
               signal ? tiles_for(j) : 0};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!labels)
    return launch<unsigned, true, false>(a, Index<unsigned>{}, b, s);
  return elem_bytes == 8
             ? launch_labels<unsigned long long>(a, y, idx, yout, b, ty, jy, s)
             : launch_labels<unsigned>(a, y, idx, yout, b, ty, jy, s);
}

// a kernel that does nothing: its time, launched as the gathers are, is
// the card's launch floor (chip_smoke.py reports it beside the bounds)
extern "C" int gather1d_empty(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}
