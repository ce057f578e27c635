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
// and the output is num / den.
//
// What bounds it on the card: operations, and among them the exponential.
// At R = 5 one 24 MP plane is 24 M pixels x 121 offsets = 2.9 G weights.
// Each needs one ex2 of the SFU, which computes 16 per clock per SM on
// compute capability 9.0 (about 4.2 T/s on an H100 SXM): 0.70 ms, against
// 192 MB moved (one read, one write, 0.06 ms).
//
// Design, so that each weight costs the SFU's ex2 and five float32
// instructions around it:
//   - the two constant factors norm_i * norm_s cancel in num / den and are
//     dropped; the two exponentials are one, base 2, with the constants
//     folded on the host in double and rounded once:
//       s = sqrt(inv2si2 * log2 e),  a = inv2ss2 * log2 e,
//       w = exp2(-((nb*s - c*s)^2 + a*dy^2 + a*dx^2)),
//     so per weight: t = nbs - cs (nbs = nb*s once per staged value), the
//     negated spatial term er[r] + sx[dx] (er per output row and input row,
//     sx a shared table of -a*dx^2), fma(-t, t, .), ex2, an fma into num
//     and an add into den;
//   - each block owns one channel (grid.z) and a 32 x 64 output tile,
//     staged with its R-wide halo in shared memory, reflecting the indices
//     as it loads (period 2n, so right for any R against any side): no
//     padded copy of the frame in device memory;
//   - rows are register-blocked: each thread owns 8 vertically adjacent
//     outputs of one column and walks the 2R + 8 staged input rows once;
//     each value it loads feeds every (output row, dy) pair it belongs to,
//     the range of output rows chosen per input row by a uniform branch
//     into an instance with that range unrolled (no predicated-off work);
//   - each output is one thread's sum in the TPU kernel's order (dy outer,
//     dx inner), so the result is bitwise reproducible, with no atomics.
// The exponential is the SFU's ex2.approx.ftz (see weight()); nothing else
// is approximate.

#include <cuda_runtime.h>

namespace {

constexpr int kTileW = 32;  // output tile width == blockDim.x
constexpr int kRowsY = 8;   // blockDim.y
constexpr int kRpt = 8;     // output rows per thread
constexpr int kTileH = kRowsY * kRpt;
constexpr int kMaxRadius = 32;  // 48.3 KB of shared memory at R = 32

__device__ __forceinline__ int reflect(int i, int n) {
  // np.pad(..., 'symmetric') index: the edge repeats, period 2n
  const int p = 2 * n;
  int m = i % p;
  if (m < 0) m += p;
  return m < n ? m : p - 1 - m;
}

// 2^x of the weight's exponent x <= 0: the SFU's ex2.approx.ftz (about 2
// ulp; a result below 2^-126 flushes to 0, where the centre's weight is 1).
// Measured 1.20x faster than the accurate exp2f on an H100 at one 24 MP
// plane r 5 (PERF.md); 1.3e-6 relative against the plain twin there, as
// exp2f gives.
__device__ __forceinline__ float weight(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

struct Row {
  const float* in;  // staged input row, at this thread's column (dx = 0)
  const float* sx;  // -a * (dx - R)^2, dx < K
  int K;
  float s;
  float dy0;  // (input row - R) as a float: dy of output row 0
  float a;
};

// One staged input row against output rows LO..HI, whose dy is dy0 - r.
template <int LO, int HI>
__device__ __forceinline__ void row_taps(const Row& q, const float (&cs)[kRpt],
                                         float (&num)[kRpt], float (&den)[kRpt]) {
  float er[kRpt];
#pragma unroll
  for (int r = LO; r <= HI; ++r) {
    const float dy = q.dy0 - static_cast<float>(r);
    er[r] = -(q.a * dy * dy);
  }
  for (int dx = 0; dx < q.K; ++dx) {
    const float nb = q.in[dx];
    const float nbs = nb * q.s;
    const float ex = q.sx[dx];
#pragma unroll
    for (int r = LO; r <= HI; ++r) {
      const float t = nbs - cs[r];
      const float w = weight(fmaf(-t, t, er[r] + ex));
      num[r] = fmaf(nb, w, num[r]);
      den[r] += w;
    }
  }
}

template <int LO, int HI>
__device__ __forceinline__ void pick_hi(int hi, const Row& q, const float (&cs)[kRpt],
                                        float (&num)[kRpt], float (&den)[kRpt]) {
  if constexpr (HI < kRpt) {
    if (hi == HI) {
      row_taps<LO, HI>(q, cs, num, den);
    } else {
      pick_hi<LO, HI + 1>(hi, q, cs, num, den);
    }
  }
}

// output rows lo..hi (a uniform range per input row) take the row
template <int LO>
__device__ __forceinline__ void pick(int lo, int hi, const Row& q, const float (&cs)[kRpt],
                                     float (&num)[kRpt], float (&den)[kRpt]) {
  if constexpr (LO < kRpt) {
    if (lo == LO) {
      pick_hi<LO, LO>(hi, q, cs, num, den);
    } else {
      pick<LO + 1>(lo, hi, q, cs, num, den);
    }
  }
}

__global__ void __launch_bounds__(kTileW * kRowsY)
bilateral_kernel(const float* __restrict__ src, float* __restrict__ out, int H, int W, int R,
                 float s, float a) {
  extern __shared__ float smem[];
  const int K = 2 * R + 1;
  const int sw = kTileW + 2 * R;
  const int sh = kTileH + 2 * R;
  float* sx = smem;        // K spatial terms of dx
  float* tile = smem + K;  // sh x sw staged input

  const int c = blockIdx.z;
  const int i0 = blockIdx.y * kTileH;
  const int j0 = blockIdx.x * kTileW;
  const int tid = threadIdx.y * kTileW + threadIdx.x;
  constexpr int nthreads = kTileW * kRowsY;
  const float* sc = src + static_cast<size_t>(c) * H * W;

  for (int t = tid; t < K; t += nthreads) {
    const float d = static_cast<float>(t - R);
    sx[t] = -(a * d * d);
  }
  for (int t = tid; t < sh * sw; t += nthreads) {
    const int r = t / sw, q = t - (t / sw) * sw;
    const int gi = reflect(i0 + r - R, H), gj = reflect(j0 + q - R, W);
    tile[t] = sc[static_cast<size_t>(gi) * W + gj];
  }
  __syncthreads();

  const int tx = threadIdx.x;
  const int r0 = threadIdx.y * kRpt;
  float cs[kRpt], num[kRpt], den[kRpt];
#pragma unroll
  for (int r = 0; r < kRpt; ++r) {
    cs[r] = tile[(r0 + r + R) * sw + tx + R] * s;
    num[r] = 0.0f;
    den[r] = 0.0f;
  }
  // input row rr feeds output rows r with dy = rr - r in [0, K)
  for (int rr = 0; rr < K + kRpt - 1; ++rr) {
    const Row q{tile + (r0 + rr) * sw + tx, sx, K, s, static_cast<float>(rr - R), a};
    pick<0>(max(0, rr - K + 1), min(kRpt - 1, rr), q, cs, num, den);
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

// s = sqrt(inv2si2 * log2 e) and a = inv2ss2 * log2 e, in double on the
// host and rounded once (ops/cuda_bilateral.py::_kernel_constants).
extern "C" int ics_bilateral(const float* src, float* out, int C, int H, int W, int R,
                             float s, float a, void* stream) {
  if (C < 1 || H < 1 || W < 1 || R < 0 || R > kMaxRadius) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int K = 2 * R + 1;
  const size_t smem = (static_cast<size_t>(K) +
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
      src, out, H, W, R, s, a);
  return static_cast<int>(cudaGetLastError());
}
