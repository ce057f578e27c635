// K1: per-channel 2-D convolution with scipy valid/same/full semantics.
//
// Replaces the TPU kernel ics_tpu/ops/pallas_conv.py::_make_kernel (wrappers
// _conv_planar, conv_rgb_pallas).  Planar (C, H, W) float32 input, per-channel
// (C, MK, NK) taps, (C, Ho, Wo) output; convolution = correlation with the
// flipped kernel, and the mode is the zero padding (plo, qlo) of
// ics_tpu/ops/conv.py::_pads.
//
// What bounds it on the card: at 9x9 and 24 MP one call is about 11.7 GFLOP
// of float32 FMA against one 290 MB read and one write, so it is light on
// compute for an H100 and the one full read is the floor.  The TPU kernel
// pre-padded the whole frame in HBM (pallas_conv.py:93-106), one extra pass.
//
// Design: each block owns one channel and a 32x32 output tile.  It stages
// the tile plus its (MK-1, NK-1) halo in shared memory with zero fill at the
// borders, so the frame is read once (halo re-reads hit L2) and never padded
// in device memory.  The flipped taps (at most 31x31) sit in shared memory
// too.  Each thread accumulates 4 vertically adjacent outputs, so every tap
// read from shared memory feeds 4 FMAs.  Each output is one thread's sum in a
// fixed tap order: results are bitwise reproducible run to run.

#include <cuda_runtime.h>

namespace {

constexpr int kTileW = 32;  // output tile width == blockDim.x
constexpr int kRowsY = 8;   // blockDim.y
constexpr int kRpt = 4;     // output rows per thread
constexpr int kTileH = kRowsY * kRpt;
constexpr int kMaxK = 31;
constexpr int kSmemW = kTileW + kMaxK - 1;
constexpr int kSmemH = kTileH + kMaxK - 1;

__global__ void __launch_bounds__(kTileW * kRowsY)
conv2d_kernel(const float* __restrict__ a, const float* __restrict__ k,
              float* __restrict__ out, int H, int W, int MK, int NK, int plo,
              int qlo, int Ho, int Wo) {
  __shared__ float tile[kSmemH * kSmemW];
  __shared__ float taps[kMaxK * kMaxK];

  const int c = blockIdx.z;
  const int i0 = blockIdx.y * kTileH;
  const int j0 = blockIdx.x * kTileW;
  const int tid = threadIdx.y * kTileW + threadIdx.x;
  constexpr int nthreads = kTileW * kRowsY;
  const float* ac = a + static_cast<size_t>(c) * H * W;
  const float* kc = k + static_cast<size_t>(c) * MK * NK;

  // convolution = correlation with the flipped kernel
  for (int t = tid; t < MK * NK; t += nthreads) {
    const int ti = t / NK, tj = t - (t / NK) * NK;
    taps[t] = kc[(MK - 1 - ti) * NK + (NK - 1 - tj)];
  }
  const int th = kTileH + MK - 1;
  const int tw = kTileW + NK - 1;
  for (int t = tid; t < th * tw; t += nthreads) {
    const int r = t / tw, s = t - (t / tw) * tw;
    const int gi = i0 + r - plo, gj = j0 + s - qlo;
    tile[r * kSmemW + s] = (gi >= 0 && gi < H && gj >= 0 && gj < W)
                               ? ac[static_cast<size_t>(gi) * W + gj]
                               : 0.0f;
  }
  __syncthreads();

  const int tx = threadIdx.x;
  const int r0 = threadIdx.y * kRpt;
  float acc[kRpt];
#pragma unroll
  for (int r = 0; r < kRpt; ++r) acc[r] = 0.0f;
  for (int ti = 0; ti < MK; ++ti) {
    const float* row = tile + (r0 + ti) * kSmemW + tx;
    for (int tj = 0; tj < NK; ++tj) {
      const float w = taps[ti * NK + tj];
#pragma unroll
      for (int r = 0; r < kRpt; ++r) acc[r] = fmaf(row[r * kSmemW + tj], w, acc[r]);
    }
  }

  const int j = j0 + tx;
  if (j >= Wo) return;
  float* oc = out + static_cast<size_t>(c) * Ho * Wo;
#pragma unroll
  for (int r = 0; r < kRpt; ++r) {
    const int i = i0 + r0 + r;
    if (i < Ho) oc[static_cast<size_t>(i) * Wo + j] = acc[r];
  }
}

}  // namespace

extern "C" int ics_conv2d(const float* a, const float* k, float* out, int C,
                          int H, int W, int MK, int NK, int plo, int qlo,
                          int Ho, int Wo, void* stream) {
  if (MK < 1 || NK < 1 || MK > kMaxK || NK > kMaxK || C < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (Ho <= 0 || Wo <= 0) return 0;
  const dim3 block(kTileW, kRowsY);
  const dim3 grid((Wo + kTileW - 1) / kTileW, (Ho + kTileH - 1) / kTileH, C);
  conv2d_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      a, k, out, H, W, MK, NK, plo, qlo, Ho, Wo);
  return static_cast<int>(cudaGetLastError());
}
