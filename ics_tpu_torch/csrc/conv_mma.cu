// K4s and K4: per-channel 2-D convolution as banded products on the bf16
// tensor cores, with scipy valid/same/full semantics.
//
// Replaces the TPU kernels ics_tpu/ops/pallas_conv_mxu.py::_make_split_kernel
// (K4s: f32 in and out, each operand split into bf16 hi and lo halves, the
// three products hi*hi + hi*lo + lo*hi summed in f32) and ::_make_kernel (K4:
// bf16 operands, f32 accumulation, bf16 out rounded once).  One source, one
// template with a compile-time split flag.
//
// The banded product.  For an output row i, an 8-column output block starting
// at j0 and one tap row ti,
//   out[i, j0 + n] += sum_kk in[i + ti, j0 + kk] * B[kk, n],
//   B[kk, n] = kf[ti, kk - n] on the band 0 <= kk - n < NK, else 0,
// with kf the flipped taps.  kk runs over 8 + NK - 1 input columns, rounded
// up to the 16 of one mma.sync m16n8k16 step: one step for NK <= 9 (16/9 of
// the direct MACs), three at NK = 31.  Sixteen output rows form the product's
// M dimension.  The TPU kernel used a 256 x 128 band sized for its matrix
// unit, 256/NK times the direct MACs.
//
// What bounds it on the card: at 9x9 and 24 MP one K4s call is about 15 M
// mma instructions (62 GFLOP on the tensor cores) against one 290 MB read
// and one write, so the operand loads from shared memory and the frame's
// read and write bound it, not the tensor cores.
//
// Design: each block owns one channel and a 64 x 64 output tile, four warps
// of 16 rows each; a warp holds the f32 accumulators of its eight 8-column
// blocks.  The block stages its input tile plus the halo in shared memory as
// bf16 (K4s: the hi and lo halves, split once at staging, following
// _split_hi_lo: hi = the f32 with its low 16 bits cleared, lo = bf16_rn(x -
// hi)); zero fill at the borders gives the scipy modes without a padded copy.
// The row stride is 4 words mod 8, so a fragment's four 32-bit loads hit 32
// distinct banks.  The B fragments are built per (tap row, k-step) from the
// flipped f32 taps and reused over the eight blocks.  Each tap row's
// products go into a fresh accumulator that is then added to the total:
// the tensor cores truncate what they accumulate, and at 31x31 one chained
// accumulator drifted by 1.5e-5 of the result.  Each output is summed by
// one thread in a fixed order: bitwise reproducible run to run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kTileH = 16 * kWarps;  // output rows per block
constexpr int kBlocksN = 8;          // 8-column output blocks per warp
constexpr int kTileW = 8 * kBlocksN;  // output columns per block
constexpr int kMaxK = 31;
constexpr int kTapsBytes = kMaxK * kMaxK * 4;

__host__ __device__ constexpr int ksteps(int nk) { return (8 + nk - 1 + 15) / 16; }
// staged columns: the last block's last k-step reads up to 55 + 16 * steps
__host__ __device__ constexpr int stage_w(int nk) { return kTileW - 8 + 16 * ksteps(nk); }

__device__ __forceinline__ uint32_t pack(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// _split_hi_lo: hi is exact in bf16 (truncation), lo rounds the exact f32 rest
__device__ __forceinline__ void split(float x, __nv_bfloat16& hi, __nv_bfloat16& lo) {
  const uint32_t bits = __float_as_uint(x) & 0xFFFF0000u;
  hi = __ushort_as_bfloat16(static_cast<unsigned short>(bits >> 16));
  lo = __float2bfloat16_rn(x - __uint_as_float(bits));
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// A fragment rows g and g + 8, columns 2q, 2q + 1 and 2q + 8, 2q + 9
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const __nv_bfloat16* tile, int row,
                                       int col, int ws) {
  const __nv_bfloat16* p = tile + row * ws + col;
  a[0] = *reinterpret_cast<const uint32_t*>(p);
  a[1] = *reinterpret_cast<const uint32_t*>(p + 8 * ws);
  a[2] = *reinterpret_cast<const uint32_t*>(p + 8);
  a[3] = *reinterpret_cast<const uint32_t*>(p + 8 * ws + 8);
}

template <bool kSplit, typename T>
__global__ void __launch_bounds__(32 * kWarps)
conv_mma_kernel(const T* __restrict__ a, const T* __restrict__ k, T* __restrict__ out, int H,
                int W, int MK, int NK, int plo, int qlo, int Ho, int Wo) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* taps = reinterpret_cast<float*>(smem);
  const int ws = stage_w(NK);
  const int th = kTileH + MK - 1;
  __nv_bfloat16* tile_hi = reinterpret_cast<__nv_bfloat16*>(smem + kTapsBytes);
  __nv_bfloat16* tile_lo = tile_hi + th * ws;  // used by K4s only

  const int c = blockIdx.z;
  const int i0 = blockIdx.y * kTileH;
  const int j0 = blockIdx.x * kTileW;
  const int tid = threadIdx.x;
  constexpr int nthreads = 32 * kWarps;
  const T* ac = a + static_cast<size_t>(c) * H * W;
  const T* kc = k + static_cast<size_t>(c) * MK * NK;

  // convolution = correlation with the flipped kernel
  for (int t = tid; t < MK * NK; t += nthreads) {
    const int ti = t / NK, tj = t - (t / NK) * NK;
    taps[t] = to_f32(kc[(MK - 1 - ti) * NK + (NK - 1 - tj)]);
  }
  for (int t = tid; t < th * ws; t += nthreads) {
    const int r = t / ws, s = t - (t / ws) * ws;
    const int gi = i0 + r - plo, gj = j0 + s - qlo;
    const bool in = gi >= 0 && gi < H && gj >= 0 && gj < W;
    if constexpr (kSplit) {
      split(in ? ac[static_cast<size_t>(gi) * W + gj] : 0.0f, tile_hi[t], tile_lo[t]);
    } else {
      tile_hi[t] = in ? ac[static_cast<size_t>(gi) * W + gj] : __float2bfloat16_rn(0.0f);
    }
  }
  __syncthreads();

  const int warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, q = lane & 3;
  const int wr = warp * 16;
  const int steps = ksteps(NK);
  float acc[kBlocksN][4];
#pragma unroll
  for (int b = 0; b < kBlocksN; ++b) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[b][e] = 0.0f;
  }

  for (int ti = 0; ti < MK; ++ti) {
    // The tensor cores truncate the f32 sums they accumulate; a fresh
    // accumulator per tap row, added to the total in round-to-nearest,
    // keeps that bias to the size of one row's partial sum.
    float part[kBlocksN][4];
#pragma unroll
    for (int b = 0; b < kBlocksN; ++b) {
#pragma unroll
      for (int e = 0; e < 4; ++e) part[b][e] = 0.0f;
    }
    for (int s = 0; s < steps; ++s) {
      // B fragment: rows kk = 16s + 2q + {0, 1, 8, 9}, column n = g
      __nv_bfloat16 bh[4], bl[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int tj = 16 * s + 2 * q + (e & 1) + (e >> 1) * 8 - g;
        const float v = (tj >= 0 && tj < NK) ? taps[ti * NK + tj] : 0.0f;
        if constexpr (kSplit) {
          split(v, bh[e], bl[e]);
        } else {
          bh[e] = __float2bfloat16_rn(v);  // exact: the taps are bf16
        }
      }
      const uint32_t bh0 = pack(bh[0], bh[1]), bh1 = pack(bh[2], bh[3]);
      const int row = wr + g + ti;
#pragma unroll
      for (int b = 0; b < kBlocksN; ++b) {
        const int col = 8 * b + 16 * s + 2 * q;
        uint32_t ah[4];
        load_a(ah, tile_hi, row, col, ws);
        mma(part[b], ah, bh0, bh1);
        if constexpr (kSplit) {
          uint32_t al[4];
          load_a(al, tile_lo, row, col, ws);
          mma(part[b], ah, pack(bl[0], bl[1]), pack(bl[2], bl[3]));
          mma(part[b], al, bh0, bh1);
        }
      }
    }
#pragma unroll
    for (int b = 0; b < kBlocksN; ++b) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[b][e] += part[b][e];
    }
  }

  T* oc = out + static_cast<size_t>(c) * Ho * Wo;
#pragma unroll
  for (int b = 0; b < kBlocksN; ++b) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = i0 + wr + g + 8 * h;
      const int j = j0 + 8 * b + 2 * q;
      if (i >= Ho) continue;
      if (j < Wo) store(oc + static_cast<size_t>(i) * Wo + j, acc[b][2 * h]);
      if (j + 1 < Wo) store(oc + static_cast<size_t>(i) * Wo + j + 1, acc[b][2 * h + 1]);
    }
  }
}

template <bool kSplit, typename T>
int launch(const void* a, const void* k, void* out, int C, int H, int W, int MK, int NK,
           int plo, int qlo, int Ho, int Wo, void* stream) {
  if (MK < 1 || NK < 1 || MK > kMaxK || NK > kMaxK || C < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (Ho <= 0 || Wo <= 0) return 0;
  const size_t smem =
      kTapsBytes + (kSplit ? 2 : 1) * sizeof(__nv_bfloat16) * (kTileH + MK - 1) * stage_w(NK);
  const dim3 grid((Wo + kTileW - 1) / kTileW, (Ho + kTileH - 1) / kTileH, C);
  conv_mma_kernel<kSplit, T><<<grid, 32 * kWarps, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(a), static_cast<const T*>(k), static_cast<T*>(out), H, W, MK, NK,
      plo, qlo, Ho, Wo);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K4s: float32 a (C, H, W), taps (C, MK, NK), out (C, Ho, Wo)
extern "C" int ics_conv_mma_split(const void* a, const void* k, void* out, int C, int H, int W,
                                  int MK, int NK, int plo, int qlo, int Ho, int Wo,
                                  void* stream) {
  return launch<true, float>(a, k, out, C, H, W, MK, NK, plo, qlo, Ho, Wo, stream);
}

// K4: bfloat16 a, taps and out
extern "C" int ics_conv_mma_bf16(const void* a, const void* k, void* out, int C, int H, int W,
                                 int MK, int NK, int plo, int qlo, int Ho, int Wo,
                                 void* stream) {
  return launch<false, __nv_bfloat16>(a, k, out, C, H, W, MK, NK, plo, qlo, Ho, Wo, stream);
}
