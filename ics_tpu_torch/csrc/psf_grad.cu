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
// (64 MFMA), about 2 microseconds of either.  At that size a launch, the
// latency of each dependent step and the cross-block sum are the cost.  The
// TPU kernel walked row bands in order and carried the (C, MK*MK) sum in one
// output block across its sequential grid; blocks of a GPU run in no order.
//
// Design: one cooperative launch of a persistent grid sized to the card
// (ops/cuda_correlate.py::geometry; the entry refuses a geometry that does
// not match).  A work unit is (channel, tap-row chunk, row band, column
// strip); each block walks its units:
//   - it stages the band's u rows, plus the chunk's halo rows, in shared
//     memory once (16-byte cp.async where the rows are 16-byte aligned, else
//     4-byte ones; zeros past the window);
//   - each thread owns items of 4 adjacent error columns and keeps a
//     register window of the 4 + NK - 1 u values they touch, fed by 16-byte
//     shared loads: 4*NK FMAs per window of (3 + NK) / 4 loads.  At mk in
//     {3, 5, 7, 9} (square) a thread holds all MK*NK sums (81 at mk 9);
//     other sizes run a run-time instance in which each warp owns one tap
//     row of an 8-row chunk and holds its NK (<= 8, 16 or 32) column sums;
//   - the sums are reduced by a fixed butterfly in each warp (a reduce-
//     scatter: each stage halves the values a lane keeps), then across the
//     block's warps in index order, and written as the unit's partials.
// After one grid.sync() one warp per output sums the units' partials in
// fixed index order and a fixed shuffle tree, and writes it flipped.  No
// float atomics: the result is bitwise reproducible run to run.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 4;                 // adjacent error columns per item
constexpr int kChunkRows = kWarps;       // tap rows per chunk, run-time instance
constexpr int kSmemBudget = 44 * 1024;   // stage bytes per block (the sums' table is static)
constexpr int kMaxTapsSide = 32;         // NK bound (column sums in registers)

struct Params {
  const float* u;
  const float* err;
  float* partial;  // [C * MK * NK][n_bands * n_strips]
  float* out;      // [C][MK][NK]
  int C, uM, uN, M, N, MK, NK;
  int tr, n_chunks, ws, n_strips, stage_w, band_rows, n_bands, n_units;
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// cp.async with zero fill: src_size 0 writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Reduce-scatter of v[0..N) over the warp: afterwards lane l holds, in
// v[0..N/32), the warp sums of entries l*(N/32) .. l*(N/32) + N/32 - 1.
template <int N, int O>
__device__ __forceinline__ void scatter_sum(float* v, int lane) {
  if constexpr (O > 0) {
    const bool upper = (lane & O) != 0;
#pragma unroll
    for (int k = 0; k < N / 2; ++k) {
      const float send = upper ? v[k] : v[k + N / 2];
      const float keep = upper ? v[k + N / 2] : v[k];
      v[k] = keep + __shfl_xor_sync(0xffffffffu, send, O);
    }
    scatter_sum<N / 2, O / 2>(v, lane);
  }
}

// 16-byte loads of the register window: u columns [j, j + 4 * W4)
template <int W4>
__device__ __forceinline__ void load_window(float* w, const float* src) {
  const float4* s4 = reinterpret_cast<const float4*>(src);
#pragma unroll
  for (int v = 0; v < W4; ++v) {
    const float4 x = s4[v];
    w[4 * v] = x.x;
    w[4 * v + 1] = x.y;
    w[4 * v + 2] = x.z;
    w[4 * v + 3] = x.w;
  }
}

// K > 0: the unrolled instance (MK = NK = K, all tap rows per thread);
// K = 0: the run-time instance (one tap row per warp, NK <= TB).
template <int K, int TB>
__global__ void __launch_bounds__(kThreads) psf_grad_kernel(Params p) {
  constexpr int NC = K > 0 ? K : TB;                 // column sums per tap row
  constexpr int W4 = (kCols + NC - 1 + 3) / 4;       // float4 loads per window
  constexpr int NV = K > 0 ? (K * K + 31) / 32 * 32 : 32;  // sums, padded
  constexpr int PER_LANE = NV / 32;
  extern __shared__ float4 smem4[];
  float* stage = reinterpret_cast<float*>(smem4);
  __shared__ float red[kWarps][K > 0 ? NV : 1];
  cg::grid_group grid = cg::this_grid();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int groups = p.ws / kCols;
  const int n_slots = p.n_bands * p.n_strips;
  const int taps = p.MK * p.NK;
  const bool vec = p.uN % 4 == 0 && (reinterpret_cast<uintptr_t>(p.u) & 15) == 0;
  const int q4 = p.stage_w / 4;

  for (int unit = blockIdx.x; unit < p.n_units; unit += gridDim.x) {
    int rest = unit;
    const int strip = rest % p.n_strips;
    rest /= p.n_strips;
    const int band = rest % p.n_bands;
    rest /= p.n_bands;
    const int chunk = rest % p.n_chunks;
    const int c = rest / p.n_chunks;
    const int r0 = band * p.band_rows, rows = min(p.band_rows, p.M - r0);
    const int t0 = chunk * p.tr, trn = min(p.tr, p.MK - t0);
    const int j0 = strip * p.ws;
    const int slot = band * p.n_strips + strip;
    const int items = rows * groups;

    // stage u rows r0 + t0 .. r0 + t0 + rows + trn - 2, columns j0 ..
    const float* uc =
        p.u + static_cast<size_t>(c) * p.uM * p.uN + static_cast<size_t>(r0 + t0) * p.uN + j0;
    const int srows = rows + trn - 1;
    for (int t = threadIdx.x; t < srows * q4; t += kThreads) {
      const int r = t / q4, s = (t - r * q4) * 4;
      float* dst = stage + r * p.stage_w + s;
      const float* src = uc + static_cast<size_t>(r) * p.uN + s;
      const int left = p.uN - (j0 + s);  // window columns from s on
      if (vec && left >= 4) {
        cp_async16(dst, src, true);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) cp_async4(dst + q, q < left ? src + q : uc, q < left);
      }
    }
    cp_async_wait_all();
    __syncthreads();

    const float* ec = p.err + static_cast<size_t>(c) * p.M * p.N + static_cast<size_t>(r0) * p.N;
    float acc[NV];
#pragma unroll
    for (int k = 0; k < NV; ++k) acc[k] = 0.0f;

    if constexpr (K > 0) {
      for (int it = threadIdx.x; it < items; it += kThreads) {
        const int row = it / groups, g = it - row * groups;
        const int j = j0 + g * kCols;
        float e[kCols];
#pragma unroll
        for (int q = 0; q < kCols; ++q) {
          e[q] = j + q < p.N ? __ldg(ec + static_cast<size_t>(row) * p.N + j + q) : 0.0f;
        }
        const float* base = stage + row * p.stage_w + g * kCols;
#pragma unroll
        for (int ti = 0; ti < K; ++ti) {
          float w[4 * W4];
          load_window<W4>(w, base + ti * p.stage_w);
#pragma unroll
          for (int tj = 0; tj < K; ++tj) {
#pragma unroll
            for (int q = 0; q < kCols; ++q) {
              acc[ti * K + tj] = fmaf(w[q + tj], e[q], acc[ti * K + tj]);
            }
          }
        }
      }
      scatter_sum<NV, 16>(acc, lane);
#pragma unroll
      for (int k = 0; k < PER_LANE; ++k) red[warp][lane * PER_LANE + k] = acc[k];
      __syncthreads();
      for (int t = threadIdx.x; t < taps; t += kThreads) {
        float s = 0.0f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) s += red[w][t];
        p.partial[(static_cast<size_t>(c) * taps + t) * n_slots + slot] = s;
      }
    } else {
      const int ti = warp;  // this warp's tap row: t0 + ti
      if (ti < trn) {
        for (int it = lane; it < items; it += 32) {
          const int row = it / groups, g = it - row * groups;
          const int j = j0 + g * kCols;
          float e[kCols];
#pragma unroll
          for (int q = 0; q < kCols; ++q) {
            e[q] = j + q < p.N ? __ldg(ec + static_cast<size_t>(row) * p.N + j + q) : 0.0f;
          }
          float w[4 * W4];
          load_window<W4>(w, stage + (row + ti) * p.stage_w + g * kCols);
          // sums past NK read staged values and are never written
#pragma unroll
          for (int tj = 0; tj < TB; ++tj) {
#pragma unroll
            for (int q = 0; q < kCols; ++q) acc[tj] = fmaf(w[q + tj], e[q], acc[tj]);
          }
        }
      }
      scatter_sum<NV, 16>(acc, lane);
      if (ti < trn && lane < p.NK) {
        p.partial[(static_cast<size_t>(c) * taps + (t0 + ti) * p.NK + lane) * n_slots + slot] =
            acc[0];
      }
    }
    __syncthreads();  // the stage and red are reused by the next unit
  }

  grid.sync();

  // one warp per output: the units' partials in index order, then a fixed
  // shuffle tree; lane 0's sum is written, flipped
  const int nw = gridDim.x * kWarps;
  for (int o = blockIdx.x * kWarps + warp; o < p.C * taps; o += nw) {
    const float* src = p.partial + static_cast<size_t>(o) * n_slots;
    float s = 0.0f;
    for (int k = lane; k < n_slots; k += 32) s += __ldcg(src + k);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) {
      const int c = o / taps, t = o - c * taps;
      const int ti = t / p.NK, tj = t - ti * p.NK;
      p.out[c * taps + (p.MK - 1 - ti) * p.NK + (p.NK - 1 - tj)] = s;
    }
  }
}

const void* kernel_for(int inst, int tb) {
  switch (inst) {
    case 3: return reinterpret_cast<const void*>(psf_grad_kernel<3, 3>);
    case 5: return reinterpret_cast<const void*>(psf_grad_kernel<5, 5>);
    case 7: return reinterpret_cast<const void*>(psf_grad_kernel<7, 7>);
    case 9: return reinterpret_cast<const void*>(psf_grad_kernel<9, 9>);
    case 0:
      switch (tb) {
        case 8: return reinterpret_cast<const void*>(psf_grad_kernel<0, 8>);
        case 16: return reinterpret_cast<const void*>(psf_grad_kernel<0, 16>);
        case 32: return reinterpret_cast<const void*>(psf_grad_kernel<0, 32>);
        default: return nullptr;
      }
    default: return nullptr;
  }
}

int div_up(int a, int b) { return (a + b - 1) / b; }

}  // namespace

// Blocks of one instance that fit on an SM with a full stage budget.
extern "C" int ics_psf_grad_occupancy(int* per_sm, int inst, int tb) {
  const void* kern = kernel_for(inst, tb);
  if (kern == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kern, kThreads, kSmemBudget));
}

// The geometry comes from ops/cuda_correlate.py::geometry; a launch whose
// geometry does not match its shapes is refused.
extern "C" int ics_psf_grad(const float* u, const float* err, float* partial, float* out,
                            int C, int uM, int uN, int M, int N, int inst, int tb, int tr,
                            int ws, int n_strips, int stage_w, int band_rows, int n_bands,
                            int grid, int smem, void* stream) {
  const int MK = uM - M + 1, NK = uN - N + 1;
  const bool unrolled = MK == NK && (MK == 3 || MK == 5 || MK == 7 || MK == 9);
  const int want_tb = unrolled ? MK : NK <= 8 ? 8 : NK <= 16 ? 16 : 32;
  const int nc = unrolled ? MK : tb;
  if (C < 1 || M < 1 || N < 1 || MK < 1 || NK < 1 || NK > kMaxTapsSide ||
      inst != (unrolled ? MK : 0) || tb != want_tb || tr != (unrolled ? MK : kChunkRows) ||
      ws < kCols || ws % kCols != 0 || n_strips != div_up(N, ws) ||
      stage_w != ws + 4 * div_up(kCols + nc - 1, 4) - 4 || band_rows < 1 ||
      n_bands != div_up(M, band_rows) ||
      smem != 4 * stage_w * (band_rows + tr - 1) || smem > kSmemBudget) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n_units = C * div_up(MK, tr) * n_bands * n_strips;
  if (grid < 1 || grid > n_units) return static_cast<int>(cudaErrorInvalidValue);
  Params p{u, err, partial, out, C, uM, uN, M, N, MK, NK,
           tr, div_up(MK, tr), ws, n_strips, stage_w, band_rows, n_bands, n_units};
  void* args[] = {&p};
  const cudaError_t rc = cudaLaunchCooperativeKernel(
      kernel_for(inst, tb), dim3(grid), dim3(kThreads), args, static_cast<size_t>(smem),
      static_cast<cudaStream_t>(stream));
  if (rc != cudaSuccess) return static_cast<int>(rc);
  return static_cast<int>(cudaGetLastError());
}
