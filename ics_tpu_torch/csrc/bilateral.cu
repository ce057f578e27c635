// K6: the bilateral filter of planar (C, H, W) float32 input.
//
// Replaces the TPU kernel ics_tpu/ops/pallas_bilateral.py::_make_kernel
// (wrappers _bilateral_plane, bilateral_pallas), whose math is
// ics_tpu/utils/filters.py::bilateral_filter.  Each plane is padded
// symmetrically by R (np.pad 'symmetric'); over the (2R+1)^2 offsets
// (dy, dx) of every pixel,
//   gi = exp(-(nb - c)^2 * inv2si2) * norm_i,
//   gs = exp(-(dy^2 + dx^2) * inv2ss2) * norm_s,
//   num += nb * gi * gs,  den += gi * gs,
// and the output is num / den.  The four constants are computed in double on
// the host and rounded once, as the TPU kernel's are.
//
// What bounds it on the card: operations.  At R = 5 one 24 MP plane is 24 M
// pixels x 121 offsets x 9 float32 operations (expf counted as one), about 26
// GFLOP, against 192 MB moved (one read, one write).
//
// Design: each block owns one channel (grid.z) and a 32x32 output tile.  It
// stages the tile plus its R-wide halo in shared memory, reflecting the
// indices as it loads (period 2n, so right for any R against any side): no
// padded copy of the frame in device memory, where the TPU wrapper padded it
// in HBM first.  The spatial weights gs, a (2R+1)^2 table, are computed once
// per block into shared memory.  Each thread keeps 4 vertically adjacent
// outputs, their centres and their (num, den) in registers and walks the
// offsets in the TPU kernel's order (rows outer, columns inner): each output
// is one thread's sum in a fixed order, so the result is bitwise
// reproducible, with no atomics.  expf is the accurate one (no fast math).

#include <cuda_runtime.h>

namespace {

constexpr int kTileW = 32;  // output tile width == blockDim.x
constexpr int kRowsY = 8;   // blockDim.y
constexpr int kRpt = 4;     // output rows per thread
constexpr int kTileH = kRowsY * kRpt;
constexpr int kMaxRadius = 32;  // 53.8 KB of shared memory at R = 32

__device__ __forceinline__ int reflect(int i, int n) {
  // np.pad(..., 'symmetric') index: the edge repeats, period 2n
  const int p = 2 * n;
  int m = i % p;
  if (m < 0) m += p;
  return m < n ? m : p - 1 - m;
}

__global__ void __launch_bounds__(kTileW * kRowsY)
bilateral_kernel(const float* __restrict__ src, float* __restrict__ out, int H,
                 int W, int R, float inv2si2, float norm_i, float inv2ss2,
                 float norm_s) {
  extern __shared__ float smem[];
  const int K = 2 * R + 1;
  const int sw = kTileW + 2 * R;
  const int sh = kTileH + 2 * R;
  float* gs = smem;            // K x K spatial weights
  float* tile = smem + K * K;  // sh x sw staged input

  const int c = blockIdx.z;
  const int i0 = blockIdx.y * kTileH;
  const int j0 = blockIdx.x * kTileW;
  const int tid = threadIdx.y * kTileW + threadIdx.x;
  constexpr int nthreads = kTileW * kRowsY;
  const float* sc = src + static_cast<size_t>(c) * H * W;

  for (int t = tid; t < K * K; t += nthreads) {
    const float dy = static_cast<float>(t / K - R);
    const float dx = static_cast<float>(t - (t / K) * K - R);
    gs[t] = expf(-(dy * dy + dx * dx) * inv2ss2) * norm_s;
  }
  for (int t = tid; t < sh * sw; t += nthreads) {
    const int r = t / sw, s = t - (t / sw) * sw;
    const int gi = reflect(i0 + r - R, H), gj = reflect(j0 + s - R, W);
    tile[t] = sc[static_cast<size_t>(gi) * W + gj];
  }
  __syncthreads();

  const int tx = threadIdx.x;
  const int r0 = threadIdx.y * kRpt;
  float ctr[kRpt], num[kRpt], den[kRpt];
#pragma unroll
  for (int r = 0; r < kRpt; ++r) {
    ctr[r] = tile[(r0 + r + R) * sw + tx + R];
    num[r] = 0.0f;
    den[r] = 0.0f;
  }
  for (int dy = 0; dy < K; ++dy) {
    const float* row = tile + (r0 + dy) * sw + tx;
    const float* g = gs + dy * K;
    for (int dx = 0; dx < K; ++dx) {
      const float ws = g[dx];
#pragma unroll
      for (int r = 0; r < kRpt; ++r) {
        const float nb = row[r * sw + dx];
        const float diff = nb - ctr[r];
        const float gi = expf(-(diff * diff) * inv2si2) * norm_i;
        const float wgt = gi * ws;
        num[r] = fmaf(nb, wgt, num[r]);
        den[r] += wgt;
      }
    }
  }

  const int j = j0 + tx;
  if (j >= W) return;
  float* oc = out + static_cast<size_t>(c) * H * W;
#pragma unroll
  for (int r = 0; r < kRpt; ++r) {
    const int i = i0 + r0 + r;
    if (i < H) oc[static_cast<size_t>(i) * W + j] = num[r] / den[r];
  }
}

}  // namespace

extern "C" int ics_bilateral(const float* src, float* out, int C, int H, int W,
                             int R, float inv2si2, float norm_i, float inv2ss2,
                             float norm_s, void* stream) {
  if (C < 1 || H < 1 || W < 1 || R < 0 || R > kMaxRadius) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int K = 2 * R + 1;
  const size_t smem = (static_cast<size_t>(K) * K +
                       static_cast<size_t>(kTileH + 2 * R) * (kTileW + 2 * R)) *
                      sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        bilateral_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 block(kTileW, kRowsY);
  const dim3 grid((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH, C);
  bilateral_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      src, out, H, W, R, inv2si2, norm_i, inv2ss2, norm_s);
  return static_cast<int>(cudaGetLastError());
}
