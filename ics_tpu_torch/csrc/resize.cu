// Banded resampling of one axis of a float32 array: the cubic (and every
// other jax.image.resize kernel) resize of utils/resize.py::resize_jax.
//
// Replaces no TPU kernel: the JAX package resizes with jax.image.resize
// (ics_tpu/utils/resize.py:51-70), which multiplies by a dense weight matrix
// per resized axis, as the port did with cuBLAS.  Each output of an axis has
// at most a few non-zero weights (4 for the cubic on an upscale, about
// 4 / scale on a downscale), so the dense product multiplied mostly by zeros.
//
// The array is viewed as (outer, n_in, inner) -> (outer, n_out, inner):
//   dst[o, j, b] = sum over t < count[j] of w[t, j] * src[o, start[j] + t, b]
// with the tables of ops/cuda_resize.py (start, count per output; the
// weights tap-major, (taps, n_out)).  Each sum is a fixed-order fmaf chain
// from 0 in ascending tap order: no atomics, the same bits on every run.  The
// dense product summed the same non-zero terms, among its zeros.
//
// What bounds it on this card: device-memory bandwidth.  A pass reads its
// input once and writes its output once (at 24 MP 0.1-0.5 GB a pass)
// and does 2 flops per tap.
//
// Design.  The row pass (outer == 1: the first axis, each row W*C floats)
// gives each thread two columns of a 512-column tile and walks 8 output rows:
// neighbouring threads read neighbouring floats of a row, and the input rows
// an output row shares with the previous one come from L1.  The pipeline's
// rows hold an odd number of floats (odd widths, 3 channels), so the rows are
// not 16-byte aligned and the loads are 4-byte, coalesced.  The column pass
// (outer > 1) gives each thread one (output column, channel) of a row and
// walks 8 rows of the image, two at a time: a warp's taps fall on a few
// neighbouring cache lines of one input row, and the weights stay in L1.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 2;   // columns per thread of the row pass
constexpr int kRows = 8;   // output rows (row pass) or image rows (column pass) per block
constexpr int kMaxGridY = 65535;

__global__ void __launch_bounds__(kThreads)
resample_rows(const float* __restrict__ src, float* __restrict__ dst,
              const int* __restrict__ start, const int* __restrict__ count,
              const float* __restrict__ w, int n_out, int inner) {
  const long long b0 = static_cast<long long>(blockIdx.x) * (kThreads * kCols) + threadIdx.x;
  bool live[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) live[c] = b0 + c * kThreads < inner;
  if (!live[0]) return;
  for (int j0 = blockIdx.y * kRows; j0 < n_out; j0 += gridDim.y * kRows) {
    const int j1 = min(j0 + kRows, n_out);
    for (int j = j0; j < j1; ++j) {
      const int n = count[j];
      const float* p = src + static_cast<size_t>(start[j]) * inner + b0;
      float acc[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[c] = 0.0f;
#pragma unroll 4
      for (int t = 0; t < n; ++t) {
        const float wt = __ldg(w + static_cast<size_t>(t) * n_out + j);
        const float* row = p + static_cast<size_t>(t) * inner;
#pragma unroll
        for (int c = 0; c < kCols; ++c)
          if (live[c]) acc[c] = __fmaf_rn(wt, __ldg(row + c * kThreads), acc[c]);
      }
      float* out = dst + static_cast<size_t>(j) * inner + b0;
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        if (live[c]) out[c * kThreads] = acc[c];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
resample_cols(const float* __restrict__ src, float* __restrict__ dst,
              const int* __restrict__ start, const int* __restrict__ count,
              const float* __restrict__ w, int outer, int n_in, int n_out, int inner) {
  const long long q = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long row_out = static_cast<long long>(n_out) * inner;
  if (q >= row_out) return;
  const int j = static_cast<int>(q / inner);
  const int b = static_cast<int>(q - static_cast<long long>(j) * inner);
  const int n = count[j];
  const size_t row_in = static_cast<size_t>(n_in) * inner;
  const float* base = src + static_cast<size_t>(start[j]) * inner + b;
  for (int o0 = blockIdx.y * kRows; o0 < outer; o0 += gridDim.y * kRows) {
    const int o1 = min(o0 + kRows, outer);
    for (int o = o0; o < o1; o += 2) {
      const bool two = o + 1 < o1;
      const float* p0 = base + o * row_in;
      const float* p1 = two ? p0 + row_in : p0;
      float acc0 = 0.0f, acc1 = 0.0f;
#pragma unroll 4
      for (int t = 0; t < n; ++t) {
        const float wt = __ldg(w + static_cast<size_t>(t) * n_out + j);
        const size_t at = static_cast<size_t>(t) * inner;
        acc0 = __fmaf_rn(wt, __ldg(p0 + at), acc0);
        acc1 = __fmaf_rn(wt, __ldg(p1 + at), acc1);
      }
      dst[o * row_out + q] = acc0;
      if (two) dst[(o + 1) * row_out + q] = acc1;
    }
  }
}

unsigned grid_y(long long rows) {
  const long long blocks = (rows + kRows - 1) / kRows;
  return static_cast<unsigned>(blocks < kMaxGridY ? blocks : kMaxGridY);
}

}  // namespace

// src (outer, n_in, inner) and dst (outer, n_out, inner), contiguous float32;
// start, count (n_out,) int32; weights (taps, n_out) float32 on the card.
extern "C" int ics_resample(const float* src, float* dst, const int* start, const int* count,
                            const float* weights, int outer, int n_in, int n_out, int inner,
                            void* stream) {
  if (outer < 1 || n_in < 1 || n_out < 1 || inner < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (outer == 1) {
    const unsigned gx = static_cast<unsigned>((inner + kThreads * kCols - 1) / (kThreads * kCols));
    resample_rows<<<dim3(gx, grid_y(n_out)), kThreads, 0, s>>>(src, dst, start, count, weights,
                                                               n_out, inner);
  } else {
    const long long row_out = static_cast<long long>(n_out) * inner;
    const unsigned gx = static_cast<unsigned>((row_out + kThreads - 1) / kThreads);
    resample_cols<<<dim3(gx, grid_y(outer)), kThreads, 0, s>>>(src, dst, start, count, weights,
                                                               outer, n_in, n_out, inner);
  }
  return static_cast<int>(cudaGetLastError());
}
