// K3: the blind PSF gradient, MK*NK whole-window dot products per channel.
//
// Replaces the TPU kernel ics_tpu/ops/pallas_correlate.py::_make_kernel
// (wrappers _corr_planar, psf_gradient, correlate_psf_valid):
//
//     corr[c, ti, tj] = sum_{i<M, j<N} u[c, i + ti, j + tj] * err[c, i, j]
//     out[c, a, b]    = corr[c, MK-1-a, NK-1-b]
//
// With u the solver window and err its residual, ``out`` is
// gradk = conv_valid(rot180(u), err): the solver's rot180(u) cancels against
// the kernel flip of convolution, so no rotated copy is ever made.
//
// What bounds it on the card: at the 24 MP case's finest blind window
// (u 3x520x520, mk 9) one call reads about 6.5 MB and does 3*81*512*512 FMAs
// (64 MFMA), a few microseconds of either.  The TPU kernel walked row bands
// in order and carried the (C, MK*MK) sum in one output block across its
// sequential grid; blocks of a GPU run in no order.
//
// Design: pass 1 splits the rows into bands, one block per (band, channel).
// For each tap row ti, every thread accumulates the NK column taps of its
// elements in registers; the block then reduces them with a fixed shuffle
// tree and writes its MK*NK partial sums to a (n_bands, C, MK*NK) scratch.
// Pass 2 sums the bands in index order and applies the final flip.  No
// float atomics: the result is bitwise reproducible run to run.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <int TB>  // tap bound: NK <= TB
__global__ void __launch_bounds__(kThreads)
psf_grad_partial(const float* __restrict__ u, const float* __restrict__ err,
                 float* __restrict__ partial, int C, int uM, int uN, int M,
                 int N, int band_rows) {
  __shared__ float red[kWarps][TB];
  const int band = blockIdx.x, c = blockIdx.y;
  const int MK = uM - M + 1, NK = uN - N + 1;
  const int r0 = band * band_rows;
  const int r1 = min(M, r0 + band_rows);
  const int n_el = (r1 - r0) * N;
  const float* uc = u + static_cast<size_t>(c) * uM * uN;
  const float* ec = err + static_cast<size_t>(c) * M * N;
  float* out = partial + (static_cast<size_t>(band) * C + c) * MK * NK;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  for (int ti = 0; ti < MK; ++ti) {
    float acc[TB];
#pragma unroll
    for (int q = 0; q < TB; ++q) acc[q] = 0.0f;
    for (int e = threadIdx.x; e < n_el; e += kThreads) {
      const int i = r0 + e / N, j = e - (e / N) * N;
      const float ev = ec[static_cast<size_t>(i) * N + j];
      const float* ur = uc + static_cast<size_t>(i + ti) * uN + j;
#pragma unroll
      for (int tj = 0; tj < TB; ++tj) {
        if (tj < NK) acc[tj] = fmaf(ur[tj], ev, acc[tj]);
      }
    }
#pragma unroll
    for (int tj = 0; tj < TB; ++tj) {
      if (tj < NK) {
        float v = acc[tj];
        for (int off = 16; off > 0; off >>= 1) {
          v += __shfl_down_sync(0xffffffffu, v, off);
        }
        if (lane == 0) red[warp][tj] = v;
      }
    }
    __syncthreads();
    if (threadIdx.x < NK) {
      float s = 0.0f;
      for (int w = 0; w < kWarps; ++w) s += red[w][threadIdx.x];
      out[ti * NK + threadIdx.x] = s;
    }
    __syncthreads();
  }
}

__global__ void psf_grad_finish(const float* __restrict__ partial,
                                float* __restrict__ out, int C, int MK, int NK,
                                int n_bands) {
  const int taps = MK * NK;
  for (int t = blockIdx.x * blockDim.x + threadIdx.x; t < C * taps;
       t += gridDim.x * blockDim.x) {
    float s = 0.0f;
    for (int b = 0; b < n_bands; ++b) s += partial[static_cast<size_t>(b) * C * taps + t];
    const int c = t / taps, r = t - c * taps;
    const int ti = r / NK, tj = r - ti * NK;
    out[c * taps + (MK - 1 - ti) * NK + (NK - 1 - tj)] = s;
  }
}

template <int TB>
void launch_partial(const float* u, const float* err, float* partial, int C,
                    int uM, int uN, int M, int N, int band_rows, int n_bands,
                    cudaStream_t stream) {
  psf_grad_partial<TB><<<dim3(n_bands, C), kThreads, 0, stream>>>(
      u, err, partial, C, uM, uN, M, N, band_rows);
}

}  // namespace

extern "C" int ics_psf_grad(const float* u, const float* err, float* partial,
                            float* out, int C, int uM, int uN, int M, int N,
                            int band_rows, int n_bands, void* stream) {
  const int MK = uM - M + 1, NK = uN - N + 1;
  if (MK < 1 || NK < 1 || NK > 32 || C < 1 || band_rows < 1 ||
      n_bands * band_rows < M) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (NK <= 4) {
    launch_partial<4>(u, err, partial, C, uM, uN, M, N, band_rows, n_bands, s);
  } else if (NK <= 8) {
    launch_partial<8>(u, err, partial, C, uM, uN, M, N, band_rows, n_bands, s);
  } else if (NK <= 16) {
    launch_partial<16>(u, err, partial, C, uM, uN, M, N, band_rows, n_bands, s);
  } else {
    launch_partial<32>(u, err, partial, C, uM, uN, M, N, band_rows, n_bands, s);
  }
  cudaError_t rc = cudaGetLastError();
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const int total = C * MK * NK;
  psf_grad_finish<<<(total + 255) / 256, 256, 0, s>>>(partial, out, C, MK, NK,
                                                      n_bands);
  return static_cast<int>(cudaGetLastError());
}
