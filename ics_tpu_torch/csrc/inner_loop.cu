// K2: the five RL-MM inner iterations of one outer iteration, in one launch.
//
// Replaces the TPU kernel ics_tpu/ops/pallas_solver.py::_make_kernel
// (wrappers _inner_loop, inner_loop_pallas) and, by its math, the unrolled
// sibling _make_kernel_unrolled.  Parity mode only, float32: per inner
// iteration and channel
//
//   1. err   = conv_valid(u, psf) - image
//   2. gradu = conv_full(err, rot180(psf)): the zero-padded residual with the
//              UNFLIPPED taps; dof = ((g - i) / (g + i))^2 on the inner crop
//              (divided by lambd when non-blind); greg = lambd*gradu + (u-ut)/2
//   3. dt    = sf * (max u + 1/(uM*uN)) / (max |greg| + 1e-15) over the whole
//              padded window; u -= dt*greg; the inner crop is blended
//              u = (1-dof)*u + dof*image
//   blind only:
//   4. err   = conv_valid(u, psf) - image (the residual the whiteness metric
//              reads)
//   5. gradk = rot180(corr_valid(u, err))
//   6. dtpsf = sf/mk * (max psf + 1/(uM*uN*3)) / (max |gradk| + 1e-15), across
//              all channels; psf -= dtpsf*gradk; channel tie if correlation;
//              clamp at 0 and normalize each channel to sum 1.
//
// What bounds it on the card: the windows that take this path (the JAX
// bound 8*(3*uM*uN*4) < 10 MiB, about 330^2) hold about five 3-channel
// float32 buffers, at most 4 MB: more than one SM's 227 KB of shared memory,
// well inside the 50 MB L2.  The work per outer is small (tens of MFMA), so
// launch overhead and the grid-wide dependencies bound it: the per-channel
// maxima of step 3 and the cross-channel PSF step of step 6 need every
// pixel of the previous step.
//
// Design: one persistent cooperative launch (cudaLaunchCooperativeKernel,
// grid sized by the occupancy API so all blocks are resident) per outer
// iteration.  Steps are separated by cooperative_groups grid barriers; the
// buffers stay in L2.  Maxima go through per-block partials that every
// block reduces after the barrier (max is exact in any order); the gradk
// partial sums go through a (n_blocks, C, mk*mk) scratch that block 0 sums
// in block order before it runs the mk^2 PSF step alone.  No float atomics,
// and a fixed grid per device: bitwise reproducible run to run.
//
// ``u`` is updated in place (the TPU kernel aliases it: input_output_aliases
// {0: 0}); ``ut`` keeps the window as it was at the start of the launch.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cmath>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kC = 3;
constexpr int kMaxK = 31;
constexpr int kInnerIter = 5;  // ref lib/deconvolution.pyx:375

struct Params {
  float* u;              // (C, uM, uN), updated in place
  const float* image;    // (C, M, N)
  const float* psf_in;   // (C, mk, mk)
  float* psf;            // (C, mk, mk) working and output PSF
  float* err;            // (C, M, N) last residual
  float* ut;             // (C, uM, uN) u at the start of the launch
  float* greg;           // (C, uM, uN) regularized gradient
  float* dof;            // (C, M, N) depth-of-field weights
  float* partial;        // n_blocks * (2*C) maxima, then n_blocks * C * mk^2
  int uM, uN, M, N, mk;
  float sf, lambd, inv_un, inv_un3;
  int blind, correlation;
};

// max that propagates NaN, as jnp.max does
__device__ __forceinline__ float nan_max(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return fmaxf(a, b);
}

// err = conv_valid(u, psf) - image, channel-major grid-stride mapping (the
// gradk partials of step 5 use the same mapping, so each thread reads back
// only the residuals it wrote).
__device__ void residual(const Params& p, const float* s_psf, size_t gtid,
                         size_t gstride) {
  const int mk = p.mk, mk2 = mk * mk;
  const size_t usz = static_cast<size_t>(p.uM) * p.uN;
  const size_t isz = static_cast<size_t>(p.M) * p.N;
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    const float* uc = p.u + c * usz;
    const float* tc = s_psf + c * mk2;
    for (size_t r = gtid; r < isz; r += gstride) {
      const int i = static_cast<int>(r / p.N);
      const int j = static_cast<int>(r - static_cast<size_t>(i) * p.N);
      float acc = -p.image[c * isz + r];
      for (int t1 = 0; t1 < mk; ++t1) {
        const float* ur = uc + static_cast<size_t>(i + t1) * p.uN + j;
        const float* tr = tc + (mk - 1 - t1) * mk + (mk - 1);
        for (int t2 = 0; t2 < mk; ++t2) acc = fmaf(ur[t2], tr[-t2], acc);
      }
      p.err[c * isz + r] = acc;
    }
  }
}

template <int TB>  // tap bound: mk <= TB (register accumulators of step 5)
__global__ void __launch_bounds__(kThreads) inner_loop_kernel(Params p) {
  cg::grid_group grid = cg::this_grid();
  __shared__ float s_psf[kC * kMaxK * kMaxK];
  __shared__ float s_gk[kC * kMaxK * kMaxK];
  __shared__ float s_red[kWarps][TB > 2 * kC ? TB : 2 * kC];
  __shared__ float s_max[2 * kC];

  const int nb = gridDim.x, b = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const size_t gtid = static_cast<size_t>(b) * kThreads + tid;
  const size_t gstride = static_cast<size_t>(nb) * kThreads;
  const int mk = p.mk, mk2 = mk * mk;
  const int uM = p.uM, uN = p.uN, M = p.M, N = p.N;
  const int pad = (uM - M) / 2;
  const size_t usz = static_cast<size_t>(uM) * uN;
  const size_t isz = static_cast<size_t>(M) * N;
  float* pmax = p.partial;                                   // [nb][2C]
  float* pcorr = p.partial + static_cast<size_t>(nb) * 2 * kC;  // [nb][C][mk2]

  for (size_t e = gtid; e < kC * usz; e += gstride) p.ut[e] = p.u[e];
  for (size_t e = gtid; e < static_cast<size_t>(kC) * mk2; e += gstride) {
    p.psf[e] = p.psf_in[e];
  }
  grid.sync();

  for (int it = 0; it < kInnerIter; ++it) {
    for (int e = tid; e < kC * mk2; e += kThreads) s_psf[e] = p.psf[e];
    __syncthreads();

    // 1. residual
    residual(p, s_psf, gtid, gstride);
    grid.sync();

    // 2. gradu (full conv, unflipped taps), DoF weights, regularized
    // gradient, and this block's per-channel maxima of u and |greg|
    float lu[kC], lg[kC];
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      lu[c] = -INFINITY;
      lg[c] = -INFINITY;
      const float* ec = p.err + c * isz;
      const float* tc = s_psf + c * mk2;
      for (size_t r = gtid; r < usz; r += gstride) {
        const int pi = static_cast<int>(r / uN);
        const int qi = static_cast<int>(r - static_cast<size_t>(pi) * uN);
        float g = 0.0f;
        for (int a = 0; a < mk; ++a) {
          const int x = pi + a - (mk - 1);
          if (x < 0 || x >= M) continue;
          for (int bb = 0; bb < mk; ++bb) {
            const int y = qi + bb - (mk - 1);
            if (y < 0 || y >= N) continue;
            g = fmaf(ec[static_cast<size_t>(x) * N + y], tc[a * mk + bb], g);
          }
        }
        const float uv = p.u[c * usz + r];
        const float gr = p.lambd * g + (uv - p.ut[c * usz + r]) * 0.5f;
        p.greg[c * usz + r] = gr;
        lu[c] = nan_max(lu[c], uv);
        lg[c] = nan_max(lg[c], fabsf(gr));
        const int ci = pi - pad, cj = qi - pad;
        if (ci >= 0 && ci < M && cj >= 0 && cj < N) {
          const size_t k = c * isz + static_cast<size_t>(ci) * N + cj;
          const float im = p.image[k];
          float d = (g - im) / (g + im);
          d = d * d;
          if (!p.blind) d = d / p.lambd;
          p.dof[k] = d;
        }
      }
    }
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      for (int off = 16; off > 0; off >>= 1) {
        lu[c] = nan_max(lu[c], __shfl_xor_sync(0xffffffffu, lu[c], off));
        lg[c] = nan_max(lg[c], __shfl_xor_sync(0xffffffffu, lg[c], off));
      }
      if (lane == 0) {
        s_red[warp][c] = lu[c];
        s_red[warp][kC + c] = lg[c];
      }
    }
    __syncthreads();
    if (tid < 2 * kC) {
      float m = -INFINITY;
      for (int w = 0; w < kWarps; ++w) m = nan_max(m, s_red[w][tid]);
      pmax[b * 2 * kC + tid] = m;
    }
    grid.sync();

    // 3. per-channel step over the whole padded window, then the DoF blend
    // of the inner crop
    if (tid < 2 * kC) {
      float m = -INFINITY;
      for (int k = 0; k < nb; ++k) m = nan_max(m, pmax[k * 2 * kC + tid]);
      s_max[tid] = m;
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      const float dt = p.sf * (s_max[c] + p.inv_un) / (s_max[kC + c] + 1e-15f);
      for (size_t r = gtid; r < usz; r += gstride) {
        const size_t e = c * usz + r;
        float un = p.u[e] - dt * p.greg[e];
        const int pi = static_cast<int>(r / uN);
        const int qi = static_cast<int>(r - static_cast<size_t>(pi) * uN);
        const int ci = pi - pad, cj = qi - pad;
        if (ci >= 0 && ci < M && cj >= 0 && cj < N) {
          const size_t k = c * isz + static_cast<size_t>(ci) * N + cj;
          const float d = p.dof[k];
          un = (1.0f - d) * un + d * p.image[k];
        }
        p.u[e] = un;
      }
    }
    grid.sync();

    if (!p.blind) continue;

    // 4. fresh residual of the updated window
    residual(p, s_psf, gtid, gstride);

    // 5. this block's partial corr_valid(u, err), same element mapping
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      const float* uc = p.u + c * usz;
      const float* ec = p.err + c * isz;
      for (int ti = 0; ti < mk; ++ti) {
        float acc[TB];
#pragma unroll
        for (int q = 0; q < TB; ++q) acc[q] = 0.0f;
        for (size_t r = gtid; r < isz; r += gstride) {
          const int i = static_cast<int>(r / N);
          const int j = static_cast<int>(r - static_cast<size_t>(i) * N);
          const float ev = ec[r];
          const float* ur = uc + static_cast<size_t>(i + ti) * uN + j;
#pragma unroll
          for (int tj = 0; tj < TB; ++tj) {
            if (tj < mk) acc[tj] = fmaf(ur[tj], ev, acc[tj]);
          }
        }
#pragma unroll
        for (int tj = 0; tj < TB; ++tj) {
          if (tj < mk) {
            float v = acc[tj];
            for (int off = 16; off > 0; off >>= 1) {
              v += __shfl_down_sync(0xffffffffu, v, off);
            }
            if (lane == 0) s_red[warp][tj] = v;
          }
        }
        __syncthreads();
        if (tid < mk) {
          float s = 0.0f;
          for (int w = 0; w < kWarps; ++w) s += s_red[w][tid];
          pcorr[(static_cast<size_t>(b) * kC + c) * mk2 + ti * mk + tid] = s;
        }
        __syncthreads();
      }
    }
    grid.sync();

    // 6. block 0: sum the partials in block order, flip, and run the PSF
    // step, channel tie, clamp and normalization
    if (b == 0) {
      for (int t = tid; t < kC * mk2; t += kThreads) {
        float s = 0.0f;
        for (int k = 0; k < nb; ++k) s += pcorr[static_cast<size_t>(k) * kC * mk2 + t];
        const int c = t / mk2, r = t - c * mk2;
        const int ti = r / mk, tj = r - ti * mk;
        s_gk[c * mk2 + (mk - 1 - ti) * mk + (mk - 1 - tj)] = s;
      }
      __syncthreads();
      if (tid == 0) {
        float gk_max = -INFINITY, k_max = -INFINITY;
        for (int t = 0; t < kC * mk2; ++t) {
          gk_max = nan_max(gk_max, fabsf(s_gk[t]));
          k_max = nan_max(k_max, s_psf[t]);
        }
        const float dtpsf = p.sf / static_cast<float>(mk) * (k_max + p.inv_un3) /
                            (gk_max + 1e-15f);
        for (int t = 0; t < kC * mk2; ++t) s_psf[t] = s_psf[t] - dtpsf * s_gk[t];
        if (p.correlation) {
          for (int t = 0; t < mk2; ++t) {
            const float mean = (s_psf[t] + s_psf[mk2 + t] + s_psf[2 * mk2 + t]) / 3.0f;
            s_psf[t] = s_psf[mk2 + t] = s_psf[2 * mk2 + t] = mean;
          }
        }
        for (int c = 0; c < kC; ++c) {
          float total = 0.0f;
          for (int t = 0; t < mk2; ++t) {
            float v = s_psf[c * mk2 + t];
            v = v < 0.0f ? 0.0f : v;  // keeps NaN, as jnp.maximum does
            s_psf[c * mk2 + t] = v;
            total += v;
          }
          for (int t = 0; t < mk2; ++t) p.psf[c * mk2 + t] = s_psf[c * mk2 + t] / total;
        }
      }
    }
    grid.sync();
  }
}

template <int TB>
int occupancy_blocks(int* n_blocks) {
  int dev = 0, sms = 0, occ = 0, coop = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc == cudaSuccess) rc = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (rc == cudaSuccess) rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (rc == cudaSuccess) {
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, inner_loop_kernel<TB>,
                                                       kThreads, 0);
  }
  if (rc != cudaSuccess) return static_cast<int>(rc);
  if (!coop || occ < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  // two resident blocks per SM at most: more blocks only lengthen the
  // barriers and block 0's partial sums
  *n_blocks = sms * (occ < 2 ? occ : 2);
  return 0;
}

template <int TB>
int launch(Params p, int n_blocks, cudaStream_t stream) {
  void* args[] = {&p};
  cudaError_t rc = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(inner_loop_kernel<TB>), dim3(n_blocks),
      dim3(kThreads), args, 0, stream);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int ics_inner_loop_blocks(int* n_blocks, int mk) {
  if (mk < 1 || mk > kMaxK) return static_cast<int>(cudaErrorInvalidValue);
  if (mk <= 4) return occupancy_blocks<4>(n_blocks);
  if (mk <= 8) return occupancy_blocks<8>(n_blocks);
  if (mk <= 16) return occupancy_blocks<16>(n_blocks);
  return occupancy_blocks<32>(n_blocks);
}

extern "C" int ics_inner_loop(float* u, const float* image, const float* psf_in,
                              float* psf_out, float* err, float* ut, float* greg,
                              float* dof, float* partial, int C, int uM, int uN,
                              int M, int N, int mk, float step_factor,
                              float lambd, float inv_un, float inv_un3,
                              int blind, int correlation, int n_blocks,
                              void* stream) {
  if (C != kC || mk < 1 || mk > kMaxK || uM - M + 1 != mk || uN - N + 1 != mk ||
      n_blocks < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p{u, image, psf_in, psf_out, err, ut, greg, dof, partial,
           uM, uN, M, N, mk, step_factor, lambd, inv_un, inv_un3,
           blind, correlation};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mk <= 4) return launch<4>(p, n_blocks, s);
  if (mk <= 8) return launch<8>(p, n_blocks, s);
  if (mk <= 16) return launch<16>(p, n_blocks, s);
  return launch<32>(p, n_blocks, s);
}
