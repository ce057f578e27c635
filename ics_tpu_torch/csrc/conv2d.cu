// K1: per-channel 2-D convolution with scipy valid/same/full semantics.
//
// Replaces the TPU kernel ics_tpu/ops/pallas_conv.py::_make_kernel (wrappers
// _conv_planar, conv_rgb_pallas).  Planar (C, H, W) float32 input, per-channel
// (C, MK, NK) taps, (C, Ho, Wo) output; convolution = correlation with the
// flipped kernel, and the mode is the zero padding (plo, qlo) of
// ics_tpu/ops/conv.py::_pads.
//
// What bounds it on the card: at 9x9 and 24 MP one call is 5.8 G float32
// FMAs (0.174 ms at 67 TFLOP/s) against one 290 MB read and one write (0.173
// ms at 3.35 TB/s): both floors at once, so the FMAs must run near the FP32
// rate while the copies overlap them.  A direct kernel that reads each tap
// and each input value from shared memory for every FMA is held by shared
// memory issue instead, at about a fifth of the FP32 rate.
//
// Design: register blocking over a persistent grid.
//   - Each block has 4 warps and walks output tiles of (4*R) x 128; each
//     thread owns R rows x 4 columns of a tile.  R = 8 for taps up to 7x7 on
//     planes with at least two 32-row tiles per SM, else 4 (9x9 and larger
//     taps, and the blind windows, which then spread over every SM).
//   - For each input row of its footprint, a thread loads the 4 + NK - 1
//     values it needs into registers with 16-byte shared loads and reuses
//     them for every tap of that row and every output row that the input
//     row feeds.  For the sizes the pyramid makes (3, 5, 7, 9) the kernel is
//     a template on (MK, NK): every loop unrolls and the flipped taps sit in
//     registers, so the inner loop is FMAs and a few 16-byte loads.  Any
//     other size up to 31x31 takes a run-time-size instance of the same
//     kernel, which reads the taps as warp-uniform 16-byte broadcasts.
//   - Tiles are staged with cp.async into a two-stage ring in dynamic shared
//     memory, zero-filled out of bounds (the padding of every mode, with no
//     padded copy in device memory): the next tile's copy overlaps the
//     current tile's FMAs.  Copies are 16 bytes where the row pitch and the
//     mode's column offset allow it (W and qlo multiples of 4), else 4.
//   - Every output is one thread's fmaf chain from 0.0f over the flipped
//     taps, tap rows outer and tap columns inner: the same arithmetic as the
//     first version of this kernel, bit for bit, and no atomics, so results
//     are bitwise reproducible run to run.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreadsX = 32;                    // one warp across a tile row
constexpr int kThreadsY = 4;                     // warps per block
constexpr int kThreads = kThreadsX * kThreadsY;  // 128
constexpr int kCols = 4;                         // output columns per thread
constexpr int kTileW = kThreadsX * kCols;        // 128 output columns
constexpr int kMaxK = 31;

// staged columns: thread tx reads from column 4*tx up to 4*tx + 4*ceil(NK/4)
// + 3 (the run-time instance; the fixed ones read less)
__host__ __device__ constexpr int stage_w(int nk) { return kTileW + 4 * ((nk + 3) / 4); }
__host__ __device__ constexpr int taps_w(int nk) { return 4 * ((nk + 3) / 4); }

struct Args {
  const float* a;
  const float* k;
  float* out;
  int C, H, W, MK, NK, plo, qlo, Ho, Wo;
  int n_rt, n_ct, n_tiles;  // row tiles, column tiles, C * n_rt * n_ct
  int vec_in, vec_out;      // 16-byte staging copies, 16-byte stores
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

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// all but the newest group have landed
__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

struct Tile {
  int c, i0, j0;  // channel, first output row, first output column
};

__device__ __forceinline__ Tile tile_at(const Args& p, int t, int th) {
  const int ct = t % p.n_ct;
  const int rest = t / p.n_ct;
  return Tile{rest / p.n_rt, (rest % p.n_rt) * th, ct * kTileW};
}

// Issue the copies of one tile and its halo (sh x sw floats) into buf.
__device__ __forceinline__ void stage(float* buf, const Args& p, const Tile& t, int sh,
                                      int sw) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* src = p.a + static_cast<size_t>(t.c) * p.H * p.W;
  const int gi0 = t.i0 - p.plo, gj0 = t.j0 - p.qlo;
  if (p.vec_in) {
    for (int r = warp; r < sh; r += kThreadsY) {
      const int gi = gi0 + r;
      const bool row_ok = gi >= 0 && gi < p.H;
      const float* row = src + static_cast<size_t>(row_ok ? gi : 0) * p.W;
      for (int q = lane; q < sw / 4; q += kThreadsX) {
        const int gj = gj0 + 4 * q;  // W and gj are multiples of 4
        const bool ok = row_ok && gj >= 0 && gj < p.W;
        cp_async16(buf + r * sw + 4 * q, ok ? row + gj : src, ok);
      }
    }
  } else {
    for (int r = warp; r < sh; r += kThreadsY) {
      const int gi = gi0 + r;
      const bool row_ok = gi >= 0 && gi < p.H;
      const float* row = src + static_cast<size_t>(row_ok ? gi : 0) * p.W;
      for (int s = lane; s < sw; s += kThreadsX) {
        const int gj = gj0 + s;
        const bool ok = row_ok && gj >= 0 && gj < p.W;
        cp_async4(buf + r * sw + s, ok ? row + gj : src, ok);
      }
    }
  }
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Fixed (MK, NK): w holds the flipped taps.  For each input row ir of the
// thread's footprint, load the row once and feed every output row r with
// tap row ti = ir - r: each output still sees tap rows in increasing order
// and tap columns in increasing order within a row.
template <int MK, int NK, int R>
__device__ __forceinline__ void compute_fixed(const float* buf, const float (&w)[MK * NK],
                                              float (&acc)[R][kCols]) {
  constexpr int SW = stage_w(NK);
  constexpr int XN = 4 * ((kCols + NK - 1 + 3) / 4);
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const float* base = buf + ty * R * SW + kCols * tx;
#pragma unroll
  for (int ir = 0; ir < R + MK - 1; ++ir) {
    float x[XN];
#pragma unroll
    for (int q = 0; q < XN / 4; ++q) {
      const float4 v = ld4(base + ir * SW + 4 * q);
      x[4 * q] = v.x;
      x[4 * q + 1] = v.y;
      x[4 * q + 2] = v.z;
      x[4 * q + 3] = v.w;
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int ti = ir - r;
      if (ti < 0 || ti >= MK) continue;
#pragma unroll
      for (int tj = 0; tj < NK; ++tj) {
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[r][c] = fmaf(x[c + tj], w[ti * NK + tj], acc[r][c]);
      }
    }
  }
}

// Run-time (mk, nk): the flipped taps in shared memory, rows padded to a
// multiple of 4 with zeros that no FMA reads.  Tap columns go in groups of
// four; each thread keeps the previous group's 16-byte load per row, so one
// new 16-byte load feeds up to 16 FMAs per row.
template <int R>
__device__ __forceinline__ void compute_runtime(const float* buf, const float* s_taps, int mk,
                                                int nk, int sw, float (&acc)[R][kCols]) {
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int tw = taps_w(nk);
  const float* base = buf + ty * R * sw + kCols * tx;
  for (int ti = 0; ti < mk; ++ti) {
    float4 xa[R];
#pragma unroll
    for (int r = 0; r < R; ++r) xa[r] = ld4(base + (r + ti) * sw);
    for (int tj0 = 0; tj0 < nk; tj0 += 4) {
      const float4 wv = ld4(s_taps + ti * tw + tj0);
      const float wq[4] = {wv.x, wv.y, wv.z, wv.w};
      const int nq = nk - tj0;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float4 xb = ld4(base + (r + ti) * sw + tj0 + 4);
        const float x[8] = {xa[r].x, xa[r].y, xa[r].z, xa[r].w, xb.x, xb.y, xb.z, xb.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (q < nq) {
#pragma unroll
            for (int c = 0; c < kCols; ++c) acc[r][c] = fmaf(x[q + c], wq[q], acc[r][c]);
          }
        }
        xa[r] = xb;
      }
    }
  }
}

template <int R>
__device__ __forceinline__ void store(const Args& p, const Tile& t, const float (&acc)[R][kCols]) {
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int j = t.j0 + kCols * tx;
  if (j >= p.Wo) return;
  float* oc = p.out + static_cast<size_t>(t.c) * p.Ho * p.Wo;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = t.i0 + ty * R + r;
    if (i >= p.Ho) break;
    float* o = oc + static_cast<size_t>(i) * p.Wo + j;
    if (p.vec_out) {  // Wo is a multiple of 4, so j + 3 < Wo
      *reinterpret_cast<float4*>(o) = make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    } else {
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        if (j + c < p.Wo) o[c] = acc[r][c];
      }
    }
  }
}

// MK = NK = 0: the run-time-size instance
template <int MK, int NK, int R>
__global__ void __launch_bounds__(kThreads, R == 8 ? 3 : 4) conv2d_kernel(Args p) {
  extern __shared__ __align__(16) float smem[];
  constexpr bool kFixed = MK > 0;
  const int mk = kFixed ? MK : p.MK, nk = kFixed ? NK : p.NK;
  const int th = kThreadsY * R;
  const int sh = th + mk - 1, sw = stage_w(nk);
  float* ring[2] = {smem, smem + sh * sw};
  float* s_taps = smem + 2 * sh * sw;  // run-time instance only
  float w[kFixed ? MK * NK : 1];        // fixed instances: taps in registers

  int t = blockIdx.x;  // the grid never exceeds the tile count
  stage(ring[0], p, tile_at(p, t, th), sh, sw);
  cp_async_commit();
  int cur_c = -1;
  for (int it = 0; t < p.n_tiles; ++it, t += gridDim.x) {
    const Tile tile = tile_at(p, t, th);
    if (t + static_cast<int>(gridDim.x) < p.n_tiles) {
      stage(ring[(it + 1) & 1], p, tile_at(p, t + gridDim.x, th), sh, sw);
    }
    cp_async_commit();  // possibly empty: the wait below stays uniform
    if (tile.c != cur_c) {
      // convolution = correlation with the flipped kernel
      const float* kc = p.k + static_cast<size_t>(tile.c) * mk * nk;
      if constexpr (kFixed) {
#pragma unroll
        for (int e = 0; e < MK * NK; ++e) w[e] = __ldg(kc + (MK * NK - 1 - e));
      } else {
        const int tw = taps_w(nk);
        for (int e = threadIdx.x; e < mk * tw; e += kThreads) {
          const int ti = e / tw, tj = e - (e / tw) * tw;
          s_taps[e] = tj < nk ? kc[(mk - 1 - ti) * nk + (nk - 1 - tj)] : 0.0f;
        }
      }
      cur_c = tile.c;
    }
    cp_async_wait_prev();
    __syncthreads();

    float acc[R][kCols];
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[r][c] = 0.0f;
    }
    if constexpr (kFixed) {
      compute_fixed<MK, NK, R>(ring[it & 1], w, acc);
    } else {
      compute_runtime<R>(ring[it & 1], s_taps, mk, nk, sw, acc);
    }
    store<R>(p, tile, acc);
    __syncthreads();  // the ring slot and the taps are free again
  }
}

size_t smem_bytes(int mk, int nk, int R, bool fixed) {
  const size_t stage = static_cast<size_t>(kThreadsY * R + mk - 1) * stage_w(nk);
  return (2 * stage + (fixed ? 0 : static_cast<size_t>(mk) * taps_w(nk))) * sizeof(float);
}

// Blocks of one instance that fit on an SM with `smem` bytes of dynamic
// shared memory, after raising the instance's opt-in limit when needed.
int blocks_per_sm(const void* kern, size_t smem, int* occ) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const cudaError_t e =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(occ, kern, kThreads, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  return *occ < 1 ? static_cast<int>(cudaErrorInvalidConfiguration) : 0;
}

template <int MK, int NK, int R>
int launch(Args p, int sms, cudaStream_t stream) {
  constexpr bool kFixed = MK > 0;
  const size_t smem = smem_bytes(kFixed ? MK : p.MK, kFixed ? NK : p.NK, R, kFixed);
  const void* kern = reinterpret_cast<const void*>(conv2d_kernel<MK, NK, R>);
  int occ = 0, rc = 0;
  if constexpr (kFixed) {
    // fixed shared memory: ask once per process (thread-safe static init)
    static int cached_rc = blocks_per_sm(kern, smem, &occ);
    static int cached_occ = occ;
    rc = cached_rc;
    occ = cached_occ;
  } else {
    rc = blocks_per_sm(kern, smem, &occ);
  }
  if (rc != 0) return rc;
  p.n_rt = (p.Ho + kThreadsY * R - 1) / (kThreadsY * R);
  p.n_ct = (p.Wo + kTileW - 1) / kTileW;
  p.n_tiles = p.C * p.n_rt * p.n_ct;
  const int grid = p.n_tiles < occ * sms ? p.n_tiles : occ * sms;
  conv2d_kernel<MK, NK, R><<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// 8 rows per thread for taps up to 7x7 on planes that give every SM two
// tiles of 32 rows; 4 otherwise: at 9x9 the 4-row instance holds its 81 taps
// in 128 registers and runs four blocks per SM, and the blind windows
// (3x363^2 .. 3x512^2) spread over the card.
int dispatch(const Args& p, bool big, int sms, cudaStream_t s) {
  if (p.MK == p.NK) {
    switch (p.MK) {
      case 3: return big ? launch<3, 3, 8>(p, sms, s) : launch<3, 3, 4>(p, sms, s);
      case 5: return big ? launch<5, 5, 8>(p, sms, s) : launch<5, 5, 4>(p, sms, s);
      case 7: return big ? launch<7, 7, 8>(p, sms, s) : launch<7, 7, 4>(p, sms, s);
      case 9: return launch<9, 9, 4>(p, sms, s);
      default: break;
    }
  }
  return launch<0, 0, 4>(p, sms, s);
}

}  // namespace

extern "C" int ics_conv2d(const float* a, const float* k, float* out, int C,
                          int H, int W, int MK, int NK, int plo, int qlo,
                          int Ho, int Wo, void* stream) {
  if (MK < 1 || NK < 1 || MK > kMaxK || NK > kMaxK || C < 1 || H < 1 || W < 1 || plo < 0 ||
      qlo < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (Ho <= 0 || Wo <= 0) return 0;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const bool a16 = (reinterpret_cast<uintptr_t>(a) & 15) == 0;
  const bool o16 = (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  Args p{a, k, out, C, H, W, MK, NK, plo, qlo, Ho, Wo, 0, 0, 0,
         a16 && W % 4 == 0 && qlo % 4 == 0, o16 && Wo % 4 == 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long tiles8 = static_cast<long>(C) * ((Ho + 31) / 32) * ((Wo + kTileW - 1) / kTileW);
  return dispatch(p, tiles8 >= 2L * sms, sms, s);
}
