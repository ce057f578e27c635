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
// What bounds it on the card: latency.  The windows that take this path (the
// JAX bound 8*(3*uM*uN*4) < 10 MiB, about 330^2) hold a few MB, inside the
// 50 MB L2, and one outer is a few hundred MFLOP; but the per-channel maxima
// of step 3 and the PSF step of step 6 need every pixel of the step before,
// so the steps are separated by grid-wide barriers, and each step between
// two barriers is a short chain of L2 reads, shared-memory FMAs and writes.
//
// Design: one persistent cooperative launch per outer iteration, one block
// of 512 threads per SM, a fixed grid per device, no float atomics: results
// are bitwise reproducible run to run.
//   - The window is cut into 2-D tiles of TH rows x 32 columns, TH chosen at
//     launch so that the tiles about match the blocks; the image uses the
//     same tiling.  A block owns the tiles b, b + nb, ... of each, so every
//     pointwise value (ut, greg, dof) is written and read by one thread and
//     needs no barrier.
//   - The residual (steps 1 and 4), the full conv of step 2 and the gradk
//     dots of step 5 stage u or err with its halo for all three channels in
//     shared memory (zero-filled outside the image), then run tap loops that
//     are unrolled for the pyramid's PSF sizes (3, 5, 7, 9; a run-time-size
//     instance takes the rest up to 31).
//   - Step 2 leaves per-block maxima; after the barrier every block reduces
//     them with six warps (lanes over the blocks, then a shuffle max: max is
//     exact in any order).
//   - Steps 4 and 5 run on the block's own image tiles without a barrier
//     between them: the fresh residual stays in shared memory for the dots.
//     Each block's gradk partial is a fixed-order sum over its tiles.
//   - Step 6 runs in every block.  The partials are stored producer-major
//     ([block][entry], one coalesced line per 32 entries); each warp sums a
//     fixed chunk of producers in producer order, lanes over the entries,
//     and the chunks are then added in chunk order: a fixed tree, so every
//     block holds the same PSF bit for bit.  (One warp per entry with lanes
//     over the producers read the same bytes markedly slower: every block
//     reads them at once.)  The step, channel tie, clamp and
//     normalization run on all threads with block-wide reductions.
//     The next iteration reads the PSF from shared memory, so no barrier
//     follows step 6.  A blind inner iteration crosses four grid barriers
//     (after steps 1, 2, 3 and 5), a non-blind one three.
//   - Values that other blocks wrote during the launch are read with
//     ld.global.cg (L2, never a stale L1 line).
//
// ``u`` is updated in place (the TPU kernel aliases it: input_output_aliases
// {0: 0}); ``ut`` keeps the window as it was at the start of the launch.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cmath>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kTW = 32;      // tile width: one warp across a tile row
constexpr int kMaxTH = 64;   // tile height bound
constexpr int kMaxLines = 8;  // blocks per grid <= 32 * kMaxLines
constexpr int kSumRegs = 8;   // step 6 sums 32 * kSumRegs entries per pass
constexpr int kC = 3;
constexpr int kMaxK = 31;
constexpr int kInnerIter = 5;  // ref lib/deconvolution.pyx:375

struct Params {
  float* u;              // (C, uM, uN), updated in place
  const float* image;    // (C, M, N)
  const float* psf_in;   // (C, mk, mk)
  float* psf_out;        // (C, mk, mk)
  float* err;            // (C, M, N) last residual
  float* ut;             // (C, uM, uN) u at the start of the launch
  float* greg;           // (C, uM, uN) regularized gradient
  float* dof;            // (C, M, N) depth-of-field weights
  float* partial;        // [2C][nb] maxima, then [nb][C*mk^2] gradk partials
  int uM, uN, M, N, mk;
  float sf, lambd, inv_un, inv_un3;
  int blind, correlation;
  int th;                // tile height
  int w_cols, n_wt;      // window: column tiles, tiles
  int i_cols, n_it;      // image: column tiles, tiles
};

// max that propagates NaN, as jnp.max does
__device__ __forceinline__ float nan_max(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return fmaxf(a, b);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = nan_max(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// a fixed xor tree: every lane ends with the same bits (a + b == b + a)
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__host__ __device__ inline int halo_rows(int th, int mk) { return th + mk - 1; }
__host__ __device__ inline int halo_cols(int mk) { return kTW + mk - 1; }

// Shared-memory layout, in floats: psf, gk, acc (C*mk^2 each), the step-5
// group partials, 40 floats of reductions, the halo tiles and the err tiles
// of the three channels, then the step-6 chunk sums.
struct Smem {
  float* psf;   // working PSF
  float* gk;    // gradk, flipped
  float* acc;   // this block's gradk partial, unflipped
  float* part;  // step-5 group partials [G][C*mk^2]
  float* red;   // [kWarps][2]
  float* mx;    // [8]: the six maxima of step 3, then gk and psf maxima
  float* halo;  // [C][th + mk - 1][32 + mk - 1]
  float* etile; // [C][th][32]
  float* chunks;  // step 6: [kWarps][32 * kSumRegs] chunk sums
};

__host__ __device__ inline int groups(int mk) {
  const int t = kC * mk * mk;
  return t >= kThreads ? 1 : kThreads / t;
}

__host__ __device__ inline size_t smem_floats(int mk, int th) {
  const size_t t = static_cast<size_t>(kC) * mk * mk;
  return 3 * t + groups(mk) * t + 2 * kWarps + 8 +
         static_cast<size_t>(kC) * halo_rows(th, mk) * halo_cols(mk) +
         static_cast<size_t>(kC) * th * kTW + kWarps * 32 * kSumRegs;
}

__device__ inline Smem carve(float* base, int mk, int th) {
  const int t = kC * mk * mk;
  Smem s;
  s.psf = base;
  s.gk = s.psf + t;
  s.acc = s.gk + t;
  s.part = s.acc + t;
  s.red = s.part + groups(mk) * t;
  s.mx = s.red + 2 * kWarps;
  s.halo = s.mx + 8;
  s.etile = s.halo + kC * halo_rows(th, mk) * halo_cols(mk);
  s.chunks = s.etile + kC * th * kTW;
  return s;
}

// Stage rows r0.. and columns c0.. of a (C, rows, cols) array, with its
// halo, into s.halo, zero outside the array.  Each thread issues its loads
// in batches of eight before it stores any, so that the L2 round trips
// overlap.
template <int MK>
__device__ __forceinline__ void stage_halo(const Params& p, const float* src, int rows, int cols,
                                           int r0, int c0, float* dst) {
  constexpr int kBatch = 8;
  const int mk = MK ? MK : p.mk;
  const int hr = halo_rows(p.th, mk), hc = halo_cols(mk);
  const size_t plane = static_cast<size_t>(rows) * cols;
  const int n = kC * hr * hc;
  for (int e0 = threadIdx.x; e0 < n; e0 += kBatch * kThreads) {
    float v[kBatch];
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      const int e = e0 + q * kThreads;
      v[q] = 0.0f;
      if (e < n) {
        const int rr = e / hc, sc = e - rr * hc;
        const int c = rr / hr, gi = r0 + rr - c * hr, gj = c0 + sc;
        if (gi >= 0 && gi < rows && gj >= 0 && gj < cols) {
          v[q] = __ldcg(src + c * plane + static_cast<size_t>(gi) * cols + gj);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      if (e0 + q * kThreads < n) dst[e0 + q * kThreads] = v[q];
    }
  }
}

// err = conv_valid(u, psf) - image on one image tile, written to global and
// kept (zero outside the image) in s.etile.
template <int MK>
__device__ void residual_tile(const Params& p, const Smem& s, int tile) {
  const int mk = MK ? MK : p.mk, mk2 = mk * mk, th = p.th;
  const int hr = halo_rows(th, mk), hc = halo_cols(mk);
  const int i0 = (tile / p.i_cols) * th, j0 = (tile % p.i_cols) * kTW;
  stage_halo<MK>(p, p.u, p.uM, p.uN, i0, j0, s.halo);
  __syncthreads();
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const size_t isz = static_cast<size_t>(p.M) * p.N;
  const int j = j0 + tx;
  // the three channels' tap chains interleave
  for (int r = ty; r < th; r += kWarps) {
    const int i = i0 + r;
    const bool ok = i < p.M && j < p.N;
    const size_t k = static_cast<size_t>(i) * p.N + j;
    float acc[kC];
#pragma unroll
    for (int c = 0; c < kC; ++c) acc[c] = ok ? -p.image[c * isz + k] : 0.0f;
    if (ok) {
#pragma unroll
      for (int t1 = 0; t1 < mk; ++t1) {
#pragma unroll
        for (int t2 = 0; t2 < mk; ++t2) {
#pragma unroll
          for (int c = 0; c < kC; ++c) {
            acc[c] = fmaf(s.halo[(c * hr + r + t1) * hc + tx + t2],
                          s.psf[c * mk2 + (mk - 1 - t1) * mk + (mk - 1 - t2)], acc[c]);
          }
        }
      }
#pragma unroll
      for (int c = 0; c < kC; ++c) p.err[c * isz + k] = acc[c];
    }
#pragma unroll
    for (int c = 0; c < kC; ++c) s.etile[(c * th + r) * kTW + tx] = acc[c];
  }
}

// Step 2 on one window tile: gradu from the zero-padded residual, greg, the
// DoF weights of the inner crop, and this thread's maxima of u and |greg|.
template <int MK>
__device__ void gradient_tile(const Params& p, const Smem& s, int tile, float (&lu)[kC],
                              float (&lg)[kC]) {
  const int mk = MK ? MK : p.mk, mk2 = mk * mk, th = p.th;
  const int hr = halo_rows(th, mk), hc = halo_cols(mk);
  const int p0 = (tile / p.w_cols) * th, q0 = (tile % p.w_cols) * kTW;
  stage_halo<MK>(p, p.err, p.M, p.N, p0 - (mk - 1), q0 - (mk - 1), s.halo);
  __syncthreads();
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int pad = (p.uM - p.M) / 2;
  const size_t usz = static_cast<size_t>(p.uM) * p.uN;
  const size_t isz = static_cast<size_t>(p.M) * p.N;
  const int qi = q0 + tx;
  for (int r = ty; r < th; r += kWarps) {
    const int pi = p0 + r;
    if (pi >= p.uM || qi >= p.uN) continue;
    const int ci = pi - pad, cj = qi - pad;
    const bool crop = ci >= 0 && ci < p.M && cj >= 0 && cj < p.N;
    const size_t e = static_cast<size_t>(pi) * p.uN + qi;
    const size_t k = static_cast<size_t>(ci) * p.N + cj;
    float uv[kC], utv[kC], im[kC], g[kC];
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      uv[c] = p.u[c * usz + e];
      utv[c] = p.ut[c * usz + e];
      im[c] = crop ? p.image[c * isz + k] : 0.0f;
      g[c] = 0.0f;
    }
#pragma unroll
    for (int a = 0; a < mk; ++a) {
#pragma unroll
      for (int b = 0; b < mk; ++b) {
#pragma unroll
        for (int c = 0; c < kC; ++c) {
          g[c] = fmaf(s.halo[(c * hr + r + a) * hc + tx + b], s.psf[c * mk2 + a * mk + b], g[c]);
        }
      }
    }
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      const float gr = p.lambd * g[c] + (uv[c] - utv[c]) * 0.5f;
      p.greg[c * usz + e] = gr;
      lu[c] = nan_max(lu[c], uv[c]);
      lg[c] = nan_max(lg[c], fabsf(gr));
      if (crop) {
        float d = (g[c] - im[c]) / (g[c] + im[c]);
        d = d * d;
        if (!p.blind) d = d / p.lambd;
        p.dof[c * isz + k] = d;
      }
    }
  }
  __syncthreads();  // the halo is restaged by the next tile
}

// Step 3 on one window tile: the per-channel step, then the DoF blend of the
// inner crop.
__device__ void update_tile(const Params& p, const Smem& s, int tile) {
  const int th = p.th;
  const int p0 = (tile / p.w_cols) * th, q0 = (tile % p.w_cols) * kTW;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int pad = (p.uM - p.M) / 2;
  const size_t usz = static_cast<size_t>(p.uM) * p.uN;
  const size_t isz = static_cast<size_t>(p.M) * p.N;
  const int qi = q0 + tx;
  float dt[kC];
#pragma unroll
  for (int c = 0; c < kC; ++c) dt[c] = p.sf * (s.mx[c] + p.inv_un) / (s.mx[kC + c] + 1e-15f);
  for (int r = ty; r < th; r += kWarps) {
    const int pi = p0 + r;
    if (pi >= p.uM || qi >= p.uN) continue;
    const int ci = pi - pad, cj = qi - pad;
    const bool crop = ci >= 0 && ci < p.M && cj >= 0 && cj < p.N;
    const size_t e = static_cast<size_t>(pi) * p.uN + qi;
    const size_t k = static_cast<size_t>(ci) * p.N + cj;
    float uv[kC], gv[kC], dv[kC], iv[kC];
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      uv[c] = p.u[c * usz + e];
      gv[c] = p.greg[c * usz + e];
      dv[c] = crop ? p.dof[c * isz + k] : 0.0f;
      iv[c] = crop ? p.image[c * isz + k] : 0.0f;
    }
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      float un = uv[c] - dt[c] * gv[c];
      if (crop) un = (1.0f - dv[c]) * un + dv[c] * iv[c];
      p.u[c * usz + e] = un;
    }
  }
}

// Step 5 on the tile that residual_tile just staged: this tile's
// corr_valid(u, err) for every (channel, tap), added to the block's partial.
// G groups of threads split the tile's rows; each (group, entry) sum runs in
// row-major order, and the groups are added in group order.
template <int MK>
__device__ void gradk_tile(const Params& p, const Smem& s, int tile, bool first) {
  const int mk = MK ? MK : p.mk, mk2 = mk * mk, th = p.th;
  const int hr = halo_rows(th, mk), hc = halo_cols(mk);
  const int T = kC * mk2, G = groups(mk);
  const int i0 = (tile / p.i_cols) * th;
  const int rows = p.M - i0 < th ? p.M - i0 : th;
  for (int w = threadIdx.x; w < T * G; w += kThreads) {
    const int g = w / T, e = w - g * T;
    const int c = e / mk2, tap = e - c * mk2;
    const int ti = tap / mk, tj = tap - ti * mk;
    const float* hcp = s.halo + (c * hr + ti) * hc + tj;
    const float* ecp = s.etile + c * th * kTW;
    float acc = 0.0f;
    for (int r = g; r < rows; r += G) {
#pragma unroll 8
      for (int j = 0; j < kTW; ++j) acc = fmaf(hcp[r * hc + j], ecp[r * kTW + j], acc);
    }
    s.part[g * T + e] = acc;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < T; e += kThreads) {
    float v = s.part[e];
    for (int g = 1; g < G; ++g) v += s.part[g * T + e];
    s.acc[e] = first ? v : s.acc[e] + v;
  }
  __syncthreads();  // the halo and the partials are reused by the next tile
}

// Block-wide max of two values per thread, into s.mx[6] and s.mx[7].
__device__ void block_max2(const Smem& s, float a, float b) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  a = warp_max(a);
  b = warp_max(b);
  if (lane == 0) {
    s.red[2 * warp] = a;
    s.red[2 * warp + 1] = b;
  }
  __syncthreads();
  if (warp == 0) {
    a = lane < kWarps ? s.red[2 * lane] : -INFINITY;
    b = lane < kWarps ? s.red[2 * lane + 1] : -INFINITY;
    a = warp_max(a);
    b = warp_max(b);
    if (lane == 0) {
      s.mx[6] = a;
      s.mx[7] = b;
    }
  }
  __syncthreads();
}

// Step 6, run by every block on the same partials in the same order.
__device__ void psf_step(const Params& p, const Smem& s, int nb, int b) {
  const int mk = p.mk, mk2 = mk * mk, T = kC * mk2;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int producers = nb < p.n_it ? nb : p.n_it;  // blocks that own image tiles
  const float* pcorr = p.partial + static_cast<size_t>(2 * kC) * nb;
  // The partials are [producer][entry].  Warp w sums the producers of chunk
  // (w + b) % kWarps in producer order, 256 entries at a time (lanes over
  // the entries, so each load is one coalesced line); the chunks are then
  // added in chunk order.  Every block reads the same partials, and the
  // rotation by b spreads their hot lines over the L2 at any moment; the
  // sum of each entry is the same in every block.
  const int chunk = (producers + kWarps - 1) / kWarps;
  const int ch = (warp + b) % kWarps;
  const int k0 = ch * chunk, k1 = producers < k0 + chunk ? producers : k0 + chunk;
  for (int e0 = 0; e0 < T; e0 += 32 * kSumRegs) {
    float v[kSumRegs];
#pragma unroll
    for (int q = 0; q < kSumRegs; ++q) v[q] = 0.0f;
#pragma unroll 4
    for (int k = k0; k < k1; ++k) {
      const float* row = pcorr + static_cast<size_t>(k) * T + e0 + lane;
#pragma unroll
      for (int q = 0; q < kSumRegs; ++q) {
        if (e0 + q * 32 + lane < T) v[q] += __ldcg(row + q * 32);
      }
    }
#pragma unroll
    for (int q = 0; q < kSumRegs; ++q) s.chunks[ch * 32 * kSumRegs + q * 32 + lane] = v[q];
    __syncthreads();
    for (int t = threadIdx.x; t < 32 * kSumRegs && e0 + t < T; t += kThreads) {
      float sum = s.chunks[t];
      for (int c = 1; c < kWarps; ++c) sum += s.chunks[c * 32 * kSumRegs + t];
      const int e = e0 + t;
      const int c = e / mk2, r = e - c * mk2;
      const int ti = r / mk, tj = r - ti * mk;
      s.gk[c * mk2 + (mk - 1 - ti) * mk + (mk - 1 - tj)] = sum;
    }
    __syncthreads();
  }
  __syncthreads();
  float gmax = -INFINITY, kmax = -INFINITY;
  for (int t = threadIdx.x; t < T; t += kThreads) {
    gmax = nan_max(gmax, fabsf(s.gk[t]));
    kmax = nan_max(kmax, s.psf[t]);
  }
  block_max2(s, gmax, kmax);
  const float dtpsf =
      p.sf / static_cast<float>(mk) * (s.mx[7] + p.inv_un3) / (s.mx[6] + 1e-15f);
  for (int t = threadIdx.x; t < T; t += kThreads) s.psf[t] = s.psf[t] - dtpsf * s.gk[t];
  __syncthreads();
  if (p.correlation) {
    for (int t = threadIdx.x; t < mk2; t += kThreads) {
      const float mean = (s.psf[t] + s.psf[mk2 + t] + s.psf[2 * mk2 + t]) / 3.0f;
      s.psf[t] = s.psf[mk2 + t] = s.psf[2 * mk2 + t] = mean;
    }
    __syncthreads();
  }
  // clamp at 0 and normalize: one warp per channel, each lane rescales the
  // entries it summed
  if (warp < kC) {
    float* pc = s.psf + warp * mk2;
    float total = 0.0f;
    for (int t = lane; t < mk2; t += 32) {
      float v = pc[t];
      v = v < 0.0f ? 0.0f : v;  // keeps NaN, as jnp.maximum does
      pc[t] = v;
      total += v;
    }
    total = warp_sum(total);
    for (int t = lane; t < mk2; t += 32) pc[t] = pc[t] / total;
  }
  __syncthreads();
}

template <int MK>
__global__ void __launch_bounds__(kThreads, 1) inner_loop_kernel(Params p) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float smem[];
  const int mk = MK ? MK : p.mk, mk2 = mk * mk;
  const Smem s = carve(smem, mk, p.th);
  const int nb = gridDim.x, b = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tx = lane, ty = warp;
  const size_t usz = static_cast<size_t>(p.uM) * p.uN;
  float* pmax = p.partial;  // [2C][nb]

  for (int t = threadIdx.x; t < kC * mk2; t += kThreads) s.psf[t] = p.psf_in[t];
  // ut: each thread copies the window pixels it owns in steps 2 and 3
  for (int tile = b; tile < p.n_wt; tile += nb) {
    const int p0 = (tile / p.w_cols) * p.th, qi = (tile % p.w_cols) * kTW + tx;
    for (int r = ty; r < p.th; r += kWarps) {
      const int pi = p0 + r;
      if (pi >= p.uM || qi >= p.uN) continue;
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        const size_t e = c * usz + static_cast<size_t>(pi) * p.uN + qi;
        p.ut[e] = p.u[e];
      }
    }
  }
  __syncthreads();

  for (int it = 0; it < kInnerIter; ++it) {
    const bool last = it == kInnerIter - 1;
    // 1. residual
    for (int tile = b; tile < p.n_it; tile += nb) {
      residual_tile<MK>(p, s, tile);
      __syncthreads();
    }
    grid.sync();

    // 2. gradient, DoF, greg and this block's maxima
    float lu[kC], lg[kC];
#pragma unroll
    for (int c = 0; c < kC; ++c) lu[c] = lg[c] = -INFINITY;
    for (int tile = b; tile < p.n_wt; tile += nb) gradient_tile<MK>(p, s, tile, lu, lg);
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      lu[c] = warp_max(lu[c]);
      lg[c] = warp_max(lg[c]);
      if (lane == 0) {
        s.part[warp * 2 * kC + c] = lu[c];
        s.part[warp * 2 * kC + kC + c] = lg[c];
      }
    }
    __syncthreads();
    if (threadIdx.x < 2 * kC) {
      float m = -INFINITY;
      for (int w = 0; w < kWarps; ++w) m = nan_max(m, s.part[w * 2 * kC + threadIdx.x]);
      pmax[threadIdx.x * nb + b] = m;
    }
    grid.sync();

    // 3. every block reduces the maxima (one warp per quantity), then steps
    // its own window tiles
    if (warp < 2 * kC) {
      float m = -INFINITY;
      // all loads at once (nb <= 32 * kMaxLines); max is exact in any order
      float v[kMaxLines];
#pragma unroll
      for (int li = 0; li < kMaxLines; ++li) {
        const int k = li * 32 + lane;
        v[li] = k < nb ? __ldcg(pmax + warp * nb + k) : -INFINITY;
      }
#pragma unroll
      for (int li = 0; li < kMaxLines; ++li) m = nan_max(m, v[li]);
      m = warp_max(m);
      if (lane == 0) s.mx[warp] = m;
    }
    __syncthreads();
    for (int tile = b; tile < p.n_wt; tile += nb) update_tile(p, s, tile);
    if (!p.blind) {
      if (!last) grid.sync();
      continue;
    }
    grid.sync();

    // 4. fresh residual of the updated window and 5. this block's gradk
    // partial from it, tile by tile
    bool first = true;
    for (int tile = b; tile < p.n_it; tile += nb) {
      residual_tile<MK>(p, s, tile);
      __syncthreads();
      gradk_tile<MK>(p, s, tile, first);
      first = false;
    }
    if (b < p.n_it) {
      float* pcorr = p.partial + static_cast<size_t>(2 * kC) * nb;
      for (int e = threadIdx.x; e < kC * mk2; e += kThreads) {
        pcorr[static_cast<size_t>(b) * kC * mk2 + e] = s.acc[e];
      }
    }
    grid.sync();

    // 6. the PSF step, in every block
    psf_step(p, s, nb, b);
  }
  if (b == 0) {
    for (int t = threadIdx.x; t < kC * mk2; t += kThreads) p.psf_out[t] = s.psf[t];
  }
}

// The tile height for a window: 32-column strips, and as many row bands as
// leave about one tile per block.
int tile_height(int uM, int uN, int nb) {
  const int strips = (uN + kTW - 1) / kTW;
  const int bands = nb / strips > 1 ? nb / strips : 1;
  const int th = (uM + bands - 1) / bands;
  return th > kMaxTH ? kMaxTH : th;
}

template <int MK>
const void* kernel_ptr() {
  return reinterpret_cast<const void*>(inner_loop_kernel<MK>);
}

const void* kernel_for(int mk) {
  switch (mk) {
    case 3: return kernel_ptr<3>();
    case 5: return kernel_ptr<5>();
    case 7: return kernel_ptr<7>();
    case 9: return kernel_ptr<9>();
    default: return kernel_ptr<0>();
  }
}

int set_smem(const void* kern, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)));
}

}  // namespace

// One block per SM, once a block with the largest tile this mk can take
// fits on one; the scratch holds n_blocks * (2C + C*mk^2) floats.
extern "C" int ics_inner_loop_blocks(int* n_blocks, int mk) {
  if (mk < 1 || mk > kMaxK) return static_cast<int>(cudaErrorInvalidValue);
  const void* kern = kernel_for(mk);
  const size_t bytes = smem_floats(mk, kMaxTH) * sizeof(float);
  int dev = 0, sms = 0, occ = 0, coop = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc == cudaSuccess) rc = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (rc == cudaSuccess) rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (rc == cudaSuccess) rc = static_cast<cudaError_t>(set_smem(kern, bytes));
  if (rc == cudaSuccess) {
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kern, kThreads, bytes);
  }
  if (rc != cudaSuccess) return static_cast<int>(rc);
  if (!coop || occ < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  *n_blocks = sms < 32 * kMaxLines ? sms : 32 * kMaxLines;
  return 0;
}

extern "C" int ics_inner_loop(float* u, const float* image, const float* psf_in,
                              float* psf_out, float* err, float* ut, float* greg,
                              float* dof, float* partial, int C, int uM, int uN,
                              int M, int N, int mk, float step_factor,
                              float lambd, float inv_un, float inv_un3,
                              int blind, int correlation, int n_blocks,
                              void* stream) {
  if (C != kC || mk < 1 || mk > kMaxK || uM - M + 1 != mk || uN - N + 1 != mk ||
      n_blocks < 1 || n_blocks > 32 * kMaxLines || M < 1 || N < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int th = tile_height(uM, uN, n_blocks);
  const int w_cols = (uN + kTW - 1) / kTW, i_cols = (N + kTW - 1) / kTW;
  Params p{u, image, psf_in, psf_out, err, ut, greg, dof, partial,
           uM, uN, M, N, mk, step_factor, lambd, inv_un, inv_un3,
           blind, correlation, th,
           w_cols, w_cols * ((uM + th - 1) / th),
           i_cols, i_cols * ((M + th - 1) / th)};
  const void* kern = kernel_for(mk);
  const size_t bytes = smem_floats(mk, th) * sizeof(float);
  int rc = set_smem(kern, bytes);
  if (rc != 0) return rc;
  void* args[] = {&p};
  rc = static_cast<int>(cudaLaunchCooperativeKernel(
      kern, dim3(n_blocks), dim3(kThreads), args, bytes, static_cast<cudaStream_t>(stream)));
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
