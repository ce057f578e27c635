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
// mma instructions (62 GFLOP on the tensor cores, 0.06 ms at the bf16 peak)
// against one 290 MB read and one write (0.17 ms): the frame's bytes bound
// it, so the design keeps the copies streaming under the products and keeps
// the instructions around the products few.
//
// Design:
//   - A persistent grid walks output tiles of TR x 64 (TR = 64, 32 or 16
//     rows; ops/cuda_conv_mma.py::geometry picks TR, the grid and the
//     shared-memory bytes and passes them in).  Each warp owns 16 rows: K4
//     one warp across the tile with eight 8-column blocks, K4s two warps
//     with four each (its split pass and hi/lo fragments need the
//     registers that K4 spends on accumulators).
//   - Staging is asynchronous: cp.async copies the next tiles and their
//     halos into a ring while the current tile's products run.  K4's ring
//     has three bf16 slots (two copies in flight).  K4s's has two f32 slots
//     and two slots of hi and lo bf16 tiles: each staged value is split
//     once, by _split_hi_lo's rule (hi = the f32 with its low 16 bits
//     cleared, lo = bf16_rn(x - hi)), and each turn has one barrier, after
//     which the copy two tiles ahead, the split of the next tile and this
//     tile's products run unsynchronised, so warps that split overlap warps
//     that multiply.  Splitting at fragment build instead (no hi/lo tiles,
//     8-byte f32 loads and the split per fragment), and a split pass between
//     two barriers, were each slower on the card.  Copies are 16, 8 or 4
//     bytes, the widest that the plane's pitch, the mode's column offset
//     and the base pointer allow; zero fill at the borders gives the scipy
//     modes without a padded copy.  A bf16 plane of odd width or odd column
//     offset takes plain 2-byte loads, eight in flight per thread.  Each
//     thread's place in the copy walk is set once: no integer division per
//     element.
//   - A fragments come from ldmatrix.  The row stride (56 + 16 * steps bf16,
//     an odd number of 16-byte units) puts the eight rows of each 8x8
//     matrix in eight distinct bank groups.  Where NK <= 9 (one k-step) a
//     warp walks its blocks with a rolling window: block b's A is the
//     8-column groups b and b + 1, so each group is loaded once per tap row
//     and serves two blocks.
//   - B fragments depend only on the channel's taps: they are built once per
//     block and channel.  K4's unrolled sizes (MK = NK in 3, 5, 7, 9) hold
//     them in registers; K4s and the run-time instance (up to 31x31) read
//     them from a shared table, one 16- or 8-byte entry per tap row, k-step
//     and lane.
//   - Stores: K4s writes f32 pairs straight out (a warp instruction covers
//     8 rows x 32 bytes); K4 stages its bf16 outputs in shared memory and
//     writes whole 128-byte rows.  Both write pairs where the output pitch
//     is even.
//   - The sum order is fixed: each tap row's products go into a fresh
//     accumulator (the tensor cores truncate the f32 sums they carry; at
//     31x31 one chained accumulator drifted by 1.5e-5 of the result), added
//     to the total in round-to-nearest, tap rows in order; every product
//     keeps its place in its m16n8k16 step.  So each output is summed by one
//     thread in a fixed order: bitwise reproducible run to run, and equal to
//     the first version of this kernel bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kTileW = 64;          // output columns per tile
constexpr int kMaxK = 31;
constexpr int kMaxThreads = 256;    // 64-row tiles of K4s
constexpr int kSmemOptIn = 232448;  // 227 KB: the most one block may use
constexpr int kOutStride = kTileW + 8;  // K4's staged outputs: bf16 per row

// Per kernel: 8-column output blocks per warp (K4s 4: the split pass's
// registers; K4 8), warps across a tile, and the ring slots (K4s: f32, each
// with a slot of hi and lo tiles; K4: bf16, copies two tiles ahead).
__host__ __device__ constexpr int warp_blocks(bool split) { return split ? 4 : 8; }
__host__ __device__ constexpr int warps_across(bool split) {
  return kTileW / (8 * warp_blocks(split));
}
__host__ __device__ constexpr int ring_slots(bool split) { return split ? 2 : 3; }

__host__ __device__ constexpr int ksteps(int nk) { return (8 + nk - 1 + 15) / 16; }
// staged columns: the last block's last k-step reads up to 55 + 16 * steps
__host__ __device__ constexpr int stage_w(int nk) { return kTileW - 8 + 16 * ksteps(nk); }

// Bytes of one block's B table: every K4s instance, K4's run-time one.
__host__ __device__ constexpr int table_bytes(bool split, int inst, int mk, int nk) {
  return inst && !split ? 0 : mk * ksteps(nk) * 32 * (split ? 16 : 8);
}

// Dynamic shared memory of one block (ops/cuda_conv_mma.py::smem_bytes
// computes the same), in planes of (tile_rows + mk - 1) x stage_w values:
// K4s two f32 ring slots and two slots of hi and lo bf16 tiles, each with a
// B table; K4 three bf16 ring slots, the staged outputs and, at run-time
// sizes, a B table.
__host__ __device__ constexpr int smem_bytes(bool split, int inst, int tile_rows, int mk, int nk) {
  return (split ? 8 * ring_slots(true) : 2 * ring_slots(false)) *
             (tile_rows + mk - 1) * stage_w(nk) +
         (split ? 0 : 2 * tile_rows * kOutStride) +
         (split ? ring_slots(true) : 1) * table_bytes(split, inst, mk, nk);
}

struct Args {
  const void* a;
  const void* k;
  void* out;
  int C, H, W, MK, NK, plo, qlo, Ho, Wo;
  int tile_rows, n_rt, n_ct, n_tiles;
  int copy_bytes;  // 16, 8 or 4: cp.async width; 2: plain loads (bf16)
  int pair_out;    // stores as element pairs (Wo even, out aligned)
};

struct Tile {
  int c, i0, j0;  // channel, first output row, first output column
};

__device__ __forceinline__ Tile tile_at(const Args& p, int t) {
  const int ct = t % p.n_ct;
  const int rest = t / p.n_ct;
  return Tile{rest / p.n_rt, (rest % p.n_rt) * p.tile_rows, ct * kTileW};
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// cp.async with zero fill: src_size 0 writes zeros and reads nothing
template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool ok) {
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "r"(ok ? 16 : 0));
  } else if constexpr (kBytes == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "r"(ok ? 8 : 0));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "r"(ok ? 4 : 0));
  }
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// all but the newest kPending groups have landed
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  if constexpr (kPending == 0) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  } else if constexpr (kPending == 1) {
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  } else {
    static_assert(kPending == 2, "at most two copies in flight");
    asm volatile("cp.async.wait_group 2;\n" ::: "memory");
  }
}

// A thread's first chunk of the copy walk and its stride, in (row, chunk)
// of a stage with `cpr` chunks per row: set once per kernel.
struct Walk {
  int r0, q0, dr, dq;
};

__device__ __forceinline__ Walk walk_of(int cpr) {
  const int tid = threadIdx.x, n = blockDim.x;
  return Walk{tid / cpr, tid % cpr, n / cpr, n % cpr};
}

// Copy one tile and its halo (sh x sw elements) into buf, kBytes a chunk.
template <typename T, int kBytes>
__device__ __forceinline__ void stage_chunks(T* buf, const Args& p, const Tile& t, int sh, int sw,
                                             Walk w) {
  constexpr int E = kBytes / static_cast<int>(sizeof(T));
  const int cpr = sw / E;
  const T* src = static_cast<const T*>(p.a) + static_cast<size_t>(t.c) * p.H * p.W;
  const int gi0 = t.i0 - p.plo, gj0 = t.j0 - p.qlo;  // gj0 and W are multiples of E
  int r = w.r0, q = w.q0;
  auto next = [&]() {
    r += w.dr;
    q += w.dq;
    if (q >= cpr) {
      q -= cpr;
      ++r;
    }
  };
  if constexpr (kBytes == 2) {
    // plain loads, eight in flight before their stores
    while (r < sh) {
      constexpr int kBatch = 8;
      T v[kBatch];
      int at[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int gi = gi0 + r, gj = gj0 + q;
        const bool ok = r < sh && gi >= 0 && gi < p.H && gj >= 0 && gj < p.W;
        v[u] = ok ? src[static_cast<size_t>(gi) * p.W + gj] : __ushort_as_bfloat16(0);
        at[u] = r < sh ? r * sw + q : -1;
        next();
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (at[u] >= 0) buf[at[u]] = v[u];
      }
    }
  } else {
    for (; r < sh; next()) {
      const int gi = gi0 + r, gj = gj0 + E * q;
      const bool ok = gi >= 0 && gi < p.H && gj >= 0 && gj < p.W;
      cp_async<kBytes>(buf + r * sw + E * q, ok ? src + static_cast<size_t>(gi) * p.W + gj : src,
                       ok);
    }
  }
}

template <typename T>
__device__ __forceinline__ void stage(T* buf, const Args& p, const Tile& t, int sh, int sw,
                                      Walk w) {
  switch (p.copy_bytes) {
    case 16: stage_chunks<T, 16>(buf, p, t, sh, sw, w); break;
    case 8: stage_chunks<T, 8>(buf, p, t, sh, sw, w); break;
    case 4: stage_chunks<T, 4>(buf, p, t, sh, sw, w); break;
    default:
      if constexpr (sizeof(T) == 2) stage_chunks<T, 2>(buf, p, t, sh, sw, w);
      break;
  }
}

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

// The landed f32 stage (n values, a multiple of 4) into its hi and lo tiles.
__device__ __forceinline__ void split_stage(const float* raw, __nv_bfloat16* hi,
                                            __nv_bfloat16* lo, int n) {
  for (int i = threadIdx.x; i < n / 4; i += blockDim.x) {
    const float4 v = reinterpret_cast<const float4*>(raw)[i];
    __nv_bfloat16 h[4], l[4];
    split(v.x, h[0], l[0]);
    split(v.y, h[1], l[1]);
    split(v.z, h[2], l[2]);
    split(v.w, h[3], l[3]);
    reinterpret_cast<uint2*>(hi)[i] = make_uint2(pack(h[0], h[1]), pack(h[2], h[3]));
    reinterpret_cast<uint2*>(lo)[i] = make_uint2(pack(l[0], l[1]), pack(l[2], l[3]));
  }
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// B fragment of tap row ti, k-step s for this lane: rows kk = 16s + 2q +
// {0, 1, 8, 9}, column n = g, from the flipped taps.  h: the bf16 (hi)
// halves, l: the lo halves (K4s only).
template <bool kSplit, typename T>
__device__ __forceinline__ void b_frag(const T* kc, int mk, int nk, int ti, int s,
                                       uint32_t (&h)[2], uint32_t (&l)[2]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  __nv_bfloat16 bh[4], bl[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int tj = 16 * s + 2 * q + (e & 1) + (e >> 1) * 8 - g;
    // convolution = correlation with the flipped kernel
    const float v =
        (tj >= 0 && tj < nk) ? to_f32(kc[(mk - 1 - ti) * nk + (nk - 1 - tj)]) : 0.0f;
    if constexpr (kSplit) {
      split(v, bh[e], bl[e]);
    } else {
      bh[e] = __float2bfloat16_rn(v);  // exact: the taps are bf16
      bl[e] = bh[e];
    }
  }
  h[0] = pack(bh[0], bh[1]);
  h[1] = pack(bh[2], bh[3]);
  l[0] = pack(bl[0], bl[1]);
  l[1] = pack(bl[2], bl[3]);
}

template <int K, typename T>
__device__ __forceinline__ void build_b_regs(const T* kc, uint32_t (&bh)[K][2]) {
#pragma unroll
  for (int ti = 0; ti < K; ++ti) {
    uint32_t unused[2];
    b_frag<false>(kc, K, K, ti, 0, bh[ti], unused);
  }
}

// one entry per (tap row, k-step, lane): the hi pair, then the lo pair (K4s)
template <bool kSplit, typename T>
__device__ __forceinline__ void build_b_table(const T* kc, int mk, int nk, int steps,
                                              uint32_t* table) {
  const int lane = threadIdx.x & 31;
  for (int x = threadIdx.x >> 5; x < mk * steps; x += blockDim.x >> 5) {
    const int ti = x / steps;
    uint32_t h[2], l[2];
    b_frag<kSplit>(kc, mk, nk, ti, x - ti * steps, h, l);
    if constexpr (kSplit) {
      reinterpret_cast<uint4*>(table)[x * 32 + lane] = make_uint4(h[0], h[1], l[0], l[1]);
    } else {
      reinterpret_cast<uint2*>(table)[x * 32 + lane] = make_uint2(h[0], h[1]);
    }
  }
}

__device__ __forceinline__ void table_entry(const uint32_t* table, int x, uint32_t (&bh)[2],
                                            uint32_t (&bl)[2], std::true_type) {
  const uint4 e = reinterpret_cast<const uint4*>(table)[x * 32 + (threadIdx.x & 31)];
  bh[0] = e.x;
  bh[1] = e.y;
  bl[0] = e.z;
  bl[1] = e.w;
}

__device__ __forceinline__ void table_entry(const uint32_t* table, int x, uint32_t (&bh)[2],
                                            uint32_t (&)[2], std::false_type) {
  const uint2 e = reinterpret_cast<const uint2*>(table)[x * 32 + (threadIdx.x & 31)];
  bh[0] = e.x;
  bh[1] = e.y;
}

__device__ __forceinline__ void ldsm_x2(uint32_t& r0, uint32_t& r1, const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(smem_addr(p)));
}

// The A fragment registers of one 8-column group (16 rows from `row`, 8
// columns from `col`): h = rows g and g + 8, columns 2q and 2q + 1 of the
// hi tile (the mma's a0/a1 or a2/a3), l = the same of the lo tile (K4s).
template <bool kSplit>
__device__ __forceinline__ void load_group(const __nv_bfloat16* hi, const __nv_bfloat16* lo,
                                           int sw, int row, int col, uint32_t (&h)[2],
                                           uint32_t (&l)[2]) {
  // ldmatrix.x2: lanes 0-15 give the addresses of the 16 rows
  const int at = (row + (threadIdx.x & 15)) * sw + col;
  ldsm_x2(h[0], h[1], hi + at);
  if constexpr (kSplit) ldsm_x2(l[0], l[1], lo + at);
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One k-step of one block: A from groups (h0, h1), the products in the
// order hi*hi, then hi*lo and lo*hi for K4s.
template <bool kSplit>
__device__ __forceinline__ void products(float (&part)[4], const uint32_t (&h0)[2],
                                         const uint32_t (&h1)[2], const uint32_t (&l0)[2],
                                         const uint32_t (&l1)[2], const uint32_t (&bh)[2],
                                         const uint32_t (&bl)[2]) {
  const uint32_t ah[4] = {h0[0], h0[1], h1[0], h1[1]};
  mma(part, ah, bh[0], bh[1]);
  if constexpr (kSplit) {
    const uint32_t al[4] = {l0[0], l0[1], l1[0], l1[1]};
    mma(part, ah, bl[0], bl[1]);
    mma(part, al, bh[0], bh[1]);
  }
}

// Unrolled sizes (MK = NK = K <= 9, one k-step): a rolling window of
// 8-column groups; B from breg (K4) or the table (K4s).  hi/lo: this warp's
// first stage row and column.
template <bool kSplit, int K, int NB>
__device__ __forceinline__ void compute_fixed(const __nv_bfloat16* hi, const __nv_bfloat16* lo,
                                              int sw, const uint32_t (&breg)[NB][2],
                                              const uint32_t* table,
                                              float (&acc)[warp_blocks(kSplit)][4]) {
#pragma unroll
  for (int ti = 0; ti < K; ++ti) {
    uint32_t bh[2], bl[2] = {0u, 0u};
    if constexpr (kSplit) {
      table_entry(table, ti, bh, bl, std::true_type{});
    } else {
      bh[0] = breg[ti][0];
      bh[1] = breg[ti][1];
    }
    uint32_t h0[2], l0[2] = {0u, 0u};
    load_group<kSplit>(hi, lo, sw, ti, 0, h0, l0);
#pragma unroll
    for (int b = 0; b < warp_blocks(kSplit); ++b) {
      uint32_t h1[2], l1[2] = {0u, 0u};
      load_group<kSplit>(hi, lo, sw, ti, 8 * (b + 1), h1, l1);
      float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      products<kSplit>(part, h0, h1, l0, l1, bh, bl);
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[b][e] += part[e];
      h0[0] = h1[0];
      h0[1] = h1[1];
      l0[0] = l1[0];
      l0[1] = l1[1];
    }
  }
}

// Run-time sizes (up to 31x31, up to three k-steps): B from the table, the
// two groups of each block and k-step loaded for it.
template <bool kSplit>
__device__ __forceinline__ void compute_runtime(const __nv_bfloat16* hi, const __nv_bfloat16* lo,
                                                int sw, int mk, int steps,
                                                const uint32_t* table,
                                                float (&acc)[warp_blocks(kSplit)][4]) {
  for (int ti = 0; ti < mk; ++ti) {
    uint32_t bh[3][2], bl[3][2] = {};
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      if (s < steps) {
        table_entry(table, ti * steps + s, bh[s], bl[s], std::integral_constant<bool, kSplit>{});
      }
    }
#pragma unroll
    for (int b = 0; b < warp_blocks(kSplit); ++b) {
      float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int s = 0; s < 3; ++s) {
        if (s < steps) {
          uint32_t h0[2], h1[2], l0[2] = {0u, 0u}, l1[2] = {0u, 0u};
          load_group<kSplit>(hi, lo, sw, ti, 8 * b + 16 * s, h0, l0);
          load_group<kSplit>(hi, lo, sw, ti, 8 * b + 16 * s + 8, h1, l1);
          products<kSplit>(part, h0, h1, l0, l1, bh[s], bl[s]);
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[b][e] += part[e];
    }
  }
}

__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// K4s: accumulator e of block b is row g + 8 * (e >> 1), column 8b + 2q +
// (e & 1); each f32 pair goes straight out (a warp instruction writes 8
// rows x 32 bytes: whole sectors).  t.j0 is this warp's first column.
template <int NB>
__device__ __forceinline__ void store_pairs(const Args& p, const Tile& t, int wr,
                                            const float (&acc)[NB][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  float* oc = static_cast<float*>(p.out) + static_cast<size_t>(t.c) * p.Ho * p.Wo;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = t.i0 + wr + g + 8 * h;
    if (i >= p.Ho) continue;
    float* row = oc + static_cast<size_t>(i) * p.Wo;
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      const int j = t.j0 + 8 * b + 2 * q;
      if (j >= p.Wo) continue;
      if (p.pair_out) {  // Wo is even, so j + 1 < Wo
        store2(row + j, acc[b][2 * h], acc[b][2 * h + 1]);
      } else {
        row[j] = acc[b][2 * h];
        if (j + 1 < p.Wo) row[j + 1] = acc[b][2 * h + 1];
      }
    }
  }
}

// K4: the warp stages its 16 x 64 outputs in ob (the pairs' 4-byte writes
// hit 32 distinct banks: the stride is 4 words mod 32), then writes each
// 128-byte output row with one warp instruction, lane l the pair at columns
// 2l and 2l + 1 (where Wo is even), else as single elements.
__device__ __forceinline__ void store_staged(const Args& p, const Tile& t, int wr,
                                             const float (&acc)[8][4], __nv_bfloat16* ob) {
  constexpr int NB = 8, S = kOutStride;
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      store2(ob + (g + 8 * h) * S + 8 * b + 2 * q, acc[b][2 * h], acc[b][2 * h + 1]);
    }
  }
  __syncwarp();
  __nv_bfloat16* oc = static_cast<__nv_bfloat16*>(p.out) + static_cast<size_t>(t.c) * p.Ho * p.Wo;
  const int rows = min(16, p.Ho - t.i0 - wr);
  if (p.pair_out) {
    const int j = t.j0 + 2 * lane;
    if (j < p.Wo) {  // Wo is even, so j + 1 < Wo
      for (int r = 0; r < rows; ++r) {
        *reinterpret_cast<__nv_bfloat162*>(oc + static_cast<size_t>(t.i0 + wr + r) * p.Wo + j) =
            *reinterpret_cast<const __nv_bfloat162*>(ob + r * S + 2 * lane);
      }
    }
  } else {
    for (int r = 0; r < rows; ++r) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = t.j0 + lane + 32 * h;
        if (j < p.Wo) oc[static_cast<size_t>(t.i0 + wr + r) * p.Wo + j] = ob[r * S + lane + 32 * h];
      }
    }
  }
  __syncwarp();  // ob is written again by the next tile
}

// K = 0: the run-time-size instance
template <bool kSplit, int K>
__global__ void __launch_bounds__(kMaxThreads, 2) conv_mma_kernel(Args p) {
  using T = typename std::conditional<kSplit, float, __nv_bfloat16>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr bool kFixed = K > 0;
  constexpr bool kRegB = kFixed && !kSplit;  // K4's unrolled sizes: B in registers
  constexpr int NB = warp_blocks(kSplit), kSlots = ring_slots(kSplit);
  const int mk = kFixed ? K : p.MK, nk = kFixed ? K : p.NK;
  const int steps = kFixed ? 1 : ksteps(nk);
  const int sh = p.tile_rows + mk - 1, sw = stage_w(nk), plane = sh * sw;
  const int warp = threadIdx.x >> 5;
  const int wr = (warp / warps_across(kSplit)) * 16;        // this warp's first row
  const int wc = (warp % warps_across(kSplit)) * 8 * NB;    // and first column
  const Walk walk = walk_of(sw / (p.copy_bytes / static_cast<int>(sizeof(T))));

  T* ring = reinterpret_cast<T*>(smem);
  __nv_bfloat16* tiles = reinterpret_cast<__nv_bfloat16*>(ring + kSlots * plane);
  uint32_t breg[kRegB ? K : 1][2] = {};
  float acc[NB][4];
  int t = blockIdx.x;  // the grid never exceeds the tile count
  const int grid = gridDim.x;

  if constexpr (kSplit) {
    // Two f32 ring slots, then two slots of hi and lo tiles, then two B
    // tables.  One barrier a turn: after it, the copy two tiles ahead, the
    // split of the next tile (and its table when its channel differs) and
    // this tile's products run with no barrier between them, so warps that
    // split overlap warps that multiply.
    const int tab_words = table_bytes(true, 0, mk, nk) / 4;
    uint32_t* tabs = reinterpret_cast<uint32_t*>(tiles + 4 * plane);
    int tab_c[2] = {-1, -1};
    stage(ring, p, tile_at(p, t), sh, sw, walk);
    cp_async_commit();
    if (t + grid < p.n_tiles) stage(ring + plane, p, tile_at(p, t + grid), sh, sw, walk);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // the first tile landed
    split_stage(ring, tiles, tiles + plane, plane);
    tab_c[0] = tile_at(p, t).c;
    build_b_table<true>(static_cast<const T*>(p.k) + static_cast<size_t>(tab_c[0]) * mk * nk,
                        mk, nk, steps, tabs);
    for (int slot = 0; t < p.n_tiles; slot ^= 1, t += grid) {
      const Tile tile = tile_at(p, t);
      cp_async_wait<0>();
      __syncthreads();  // this tile split, the next landed; the other slots are free
      if (t + 2 * grid < p.n_tiles) {
        stage(ring + slot * plane, p, tile_at(p, t + 2 * grid), sh, sw, walk);
        cp_async_commit();
      }
      if (t + grid < p.n_tiles) {
        const int nx = slot ^ 1, c = tile_at(p, t + grid).c;
        split_stage(ring + nx * plane, tiles + 2 * nx * plane, tiles + (2 * nx + 1) * plane, plane);
        if (c != tab_c[nx]) {
          build_b_table<true>(static_cast<const T*>(p.k) + static_cast<size_t>(c) * mk * nk, mk,
                              nk, steps, tabs + nx * tab_words);
          tab_c[nx] = c;
        }
      }
#pragma unroll
      for (int b = 0; b < NB; ++b) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[b][e] = 0.0f;
      }
      const __nv_bfloat16* hi = tiles + 2 * slot * plane + wr * sw + wc;
      const uint32_t* table = tabs + slot * tab_words;
      if constexpr (kFixed) {
        compute_fixed<true, K>(hi, hi + plane, sw, breg, table, acc);
      } else {
        compute_runtime<true>(hi, hi + plane, sw, mk, steps, table, acc);
      }
      store_pairs(p, Tile{tile.c, tile.i0, tile.j0 + wc}, wr, acc);
    }
  } else {
    // Three bf16 ring slots, the staged outputs, then the B table of the
    // run-time instance: the slot of the previous tile takes the tile two
    // ahead while this one's products run.
    uint32_t* table = reinterpret_cast<uint32_t*>(tiles + p.tile_rows * kOutStride);
    __nv_bfloat16* ob = tiles + warp * 16 * kOutStride;  // this warp's staged outputs
    int cur_c = -1;
    for (int s = 0; s < kSlots - 1; ++s) {
      if (t + s * grid < p.n_tiles) {
        stage(ring + s * plane, p, tile_at(p, t + s * grid), sh, sw, walk);
      }
      cp_async_commit();
    }
    for (int slot = 0; t < p.n_tiles; slot = slot + 1 == kSlots ? 0 : slot + 1, t += grid) {
      const Tile tile = tile_at(p, t);
      const int back = slot == 0 ? kSlots - 1 : slot - 1;  // the previous tile's slot
      if (t + (kSlots - 1) * grid < p.n_tiles) {
        stage(ring + back * plane, p, tile_at(p, t + (kSlots - 1) * grid), sh, sw, walk);
      }
      cp_async_commit();  // possibly empty: the wait below stays uniform
      if (tile.c != cur_c) {  // B fragments, once per block and channel
        const T* kc = static_cast<const T*>(p.k) + static_cast<size_t>(tile.c) * mk * nk;
        if constexpr (kRegB) {
          build_b_regs<K>(kc, breg);
        } else {
          build_b_table<false>(kc, mk, nk, steps, table);
        }
        cur_c = tile.c;
      }
      cp_async_wait<kSlots - 1>();
      __syncthreads();  // this slot and the table ready

#pragma unroll
      for (int b = 0; b < NB; ++b) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[b][e] = 0.0f;
      }
      const __nv_bfloat16* st = ring + slot * plane + wr * sw + wc;
      if constexpr (kFixed) {
        compute_fixed<false, K>(st, st, sw, breg, table, acc);
      } else {
        compute_runtime<false>(st, st, sw, mk, steps, table, acc);
      }
      store_staged(p, Tile{tile.c, tile.i0, tile.j0 + wc}, wr, acc, ob);
      __syncthreads();  // the ring slot and the table are free again
    }
  }
}

template <bool kSplit, int K>
int run(const Args& p, int grid, int smem, cudaStream_t stream) {
  const void* kern = reinterpret_cast<const void*>(conv_mma_kernel<kSplit, K>);
  // raise the instance's opt-in limit once per process (thread-safe static init)
  static const cudaError_t attr =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemOptIn);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  conv_mma_kernel<kSplit, K><<<grid, 2 * warps_across(kSplit) * p.tile_rows, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The widest copy (16, 8 or 4 bytes) that keeps every row's copies aligned
// on a plane of pitch W read from qlo elements before each tile's first
// column; else the element size.
int widest_copy(const void* a, int W, int qlo, int itemsize) {
  const uintptr_t base = reinterpret_cast<uintptr_t>(a);
  for (int bytes = 16; bytes >= 4; bytes /= 2) {
    if (base % bytes == 0 && (static_cast<size_t>(W) * itemsize) % bytes == 0 &&
        (static_cast<size_t>(qlo) * itemsize) % bytes == 0) {
      return bytes;
    }
  }
  return itemsize;  // a bf16 plane of odd width or offset: plain loads
}

// The geometry (inst, tile_rows, grid, smem) comes from
// ops/cuda_conv_mma.py::geometry; a value that does not match this call's
// shape is refused.
template <bool kSplit>
int launch(const void* a, const void* k, void* out, int C, int H, int W, int MK, int NK, int plo,
           int qlo, int Ho, int Wo, int inst, int tile_rows, int grid, int smem, void* stream) {
  if (MK < 1 || NK < 1 || MK > kMaxK || NK > kMaxK || C < 1 || H < 1 || W < 1 || plo < 0 ||
      qlo < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (Ho <= 0 || Wo <= 0) return 0;
  const int want_inst = (MK == NK && (MK == 3 || MK == 5 || MK == 7 || MK == 9)) ? MK : 0;
  if (inst != want_inst || (tile_rows != 16 && tile_rows != 32 && tile_rows != 64) ||
      smem != smem_bytes(kSplit, inst, tile_rows, MK, NK) || smem > kSmemOptIn) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  constexpr int itemsize = kSplit ? 4 : 2;
  const int n_rt = (Ho + tile_rows - 1) / tile_rows, n_ct = (Wo + kTileW - 1) / kTileW;
  const long n_tiles = static_cast<long>(C) * n_rt * n_ct;
  if (grid < 1 || grid > n_tiles) return static_cast<int>(cudaErrorInvalidValue);
  const bool out_pairs = reinterpret_cast<uintptr_t>(out) % (2 * itemsize) == 0 && Wo % 2 == 0;
  const Args p{a,        k,    out,  C,    H,    W,
               MK,       NK,   plo,  qlo,  Ho,   Wo,
               tile_rows, n_rt, n_ct, static_cast<int>(n_tiles),
               widest_copy(a, W, qlo, itemsize), out_pairs ? 1 : 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (inst) {
    case 3: return run<kSplit, 3>(p, grid, smem, s);
    case 5: return run<kSplit, 5>(p, grid, smem, s);
    case 7: return run<kSplit, 7>(p, grid, smem, s);
    case 9: return run<kSplit, 9>(p, grid, smem, s);
    default: return run<kSplit, 0>(p, grid, smem, s);
  }
}

}  // namespace

// K4s: float32 a (C, H, W), taps (C, MK, NK), out (C, Ho, Wo)
extern "C" int ics_conv_mma_split(const void* a, const void* k, void* out, int C, int H, int W,
                                  int MK, int NK, int plo, int qlo, int Ho, int Wo, int inst,
                                  int tile_rows, int grid, int smem, void* stream) {
  return launch<true>(a, k, out, C, H, W, MK, NK, plo, qlo, Ho, Wo, inst, tile_rows, grid, smem,
                      stream);
}

// K4: bfloat16 a, taps and out
extern "C" int ics_conv_mma_bf16(const void* a, const void* k, void* out, int C, int H, int W,
                                 int MK, int NK, int plo, int qlo, int Ho, int Wo, int inst,
                                 int tile_rows, int grid, int smem, void* stream) {
  return launch<false>(a, k, out, C, H, W, MK, NK, plo, qlo, Ho, Wo, inst, tile_rows, grid, smem,
                       stream);
}
