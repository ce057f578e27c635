// K4s, K4, K4h and K4d: per-channel 2-D convolution as banded products on
// the bf16 tensor cores, with scipy valid/same/full semantics.
//
// Replaces the TPU kernels of ics_tpu/ops/pallas_conv_mxu.py:
//   - K4s, ::_make_split_kernel (:118): f32 in and out, each operand split
//     into bf16 hi and lo halves, the three products hi*hi + hi*lo + lo*hi
//     summed in f32 (precision 'bf16x3');
//   - K4, ::_make_kernel (:170) on bf16 operands: f32 accumulation, bf16 out
//     rounded once;
//   - K4h, ::_make_kernel (:170) on f32 operands at lax.Precision.HIGHEST:
//     each operand split into three bf16 slices (hi, mid, lo: x exactly),
//     the six products HIGHEST runs on the MXU (lo*hi, mid*mid, hi*lo,
//     mid*hi, hi*mid, hi*hi, the small ones first) summed in f32, f32 out;
//   - K4d, ::_make_kernel (:170) on f32 operands at lax.Precision.DEFAULT:
//     each operand rounded to bf16 (to nearest even), one product, f32
//     accumulation, f32 out with no final rounding.
// One source, one template over the variant (V: 0 K4, 1 K4s, 2 K4h, 3 K4d).
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
// the instructions around the products few.  K4h runs twice K4s's products
// (0.12 ms at the peak) over the same bytes, K4d a third of them.
//
// Design:
//   - A persistent grid walks output tiles of TR x 64 (TR = 64, 32 or 16
//     rows; ops/cuda_conv_mma.py::geometry picks TR, the grid and the
//     shared-memory bytes and passes them in).  Each warp owns 16 rows: K4
//     one warp across the tile with eight 8-column blocks, the f32 variants
//     (K4s, K4h, K4d) two warps with four each (their slice pass and slice
//     fragments need the registers that K4 spends on accumulators).
//   - Staging is asynchronous: cp.async copies the next tiles and their
//     halos into a ring while the current tile's products run.  K4's ring
//     has three bf16 slots (two copies in flight).  The f32 variants' has
//     two f32 slots and two slots of bf16 slice tiles (K4s hi and lo, K4h
//     hi, mid and lo, K4d one rounded tile): each staged value is sliced
//     once (K4s by _split_hi_lo's rule: hi = the f32 with its low 16 bits
//     cleared, lo = bf16_rn(x - hi); K4h the same twice: mid = the rest with
//     its low 16 bits cleared, lo = the rest of that, exact in bf16; K4d
//     bf16_rn(x)), and each turn has one barrier, after which the copy two
//     tiles ahead, the slicing of the next tile and this tile's products run
//     unsynchronised, so warps that slice overlap warps that multiply.  K4d
//     keeps this f32 ring rather than loading and rounding with plain loads
//     as it stages: cp.async cannot convert, and plain loads would leave the
//     copy synchronous in the warps that multiply.  Slicing at fragment
//     build instead (no slice tiles, 8-byte f32 loads and the split per
//     fragment), and a slice pass between two barriers, were each slower on
//     the card for K4s.  Copies are 16, 8 or 4 bytes, the widest that the
//     plane's pitch, the mode's column offset and the base pointer allow;
//     zero fill at the borders gives the scipy modes without a padded copy.
//     A bf16 plane of odd width or odd column offset takes plain 2-byte
//     loads, eight in flight per thread.  Each thread's place in the copy
//     walk is set once: no integer division per element.
//   - A fragments come from ldmatrix.  The row stride (56 + 16 * steps bf16,
//     an odd number of 16-byte units) puts the eight rows of each 8x8
//     matrix in eight distinct bank groups.  Where NK <= 9 (one k-step) a
//     warp walks its blocks with a rolling window: block b's A is the
//     8-column groups b and b + 1, so each group is loaded once per tap row
//     and serves two blocks.
//   - B fragments depend only on the channel's taps: they are built once per
//     block and channel.  K4's unrolled sizes (MK = NK in 3, 5, 7, 9) hold
//     them in registers; the f32 variants and K4's run-time instance (up to
//     31x31) read them from a shared table, one entry per tap row, k-step
//     and lane: K4s its hi and lo pairs (16 bytes), K4 and K4d one bf16 pair
//     (8 bytes), K4h the four f32 taps (16 bytes), sliced as they are read:
//     three slices of pairs (24 bytes) in two tables would not fit 31x31 in
//     shared memory beside the ring.
//   - Stores: the f32 variants write f32 pairs straight out (a warp
//     instruction covers 8 rows x 32 bytes); K4 stages its bf16 outputs in
//     shared memory and writes whole 128-byte rows.  Both write pairs where
//     the output pitch is even.
//   - The sum order is fixed: each tap row's products go into a fresh
//     accumulator (the tensor cores truncate the f32 sums they carry; at
//     31x31 one chained accumulator drifted by 1.5e-5 of the result), added
//     to the total in round-to-nearest, tap rows in order; every product
//     keeps its place in its m16n8k16 step.  K4h keeps hi*hi in an
//     accumulator of its own, apart from the five small products (with all
//     six chained in one, 18 truncating sums a tap row at 29x31 taps, it sat
//     2.0e-6 of the largest value from its f32 twin; split, 1.7e-6 from
//     that twin and 3.5e-7 from a float64 convolution, where the twin's own
//     error is 1.7e-6).  So each output is summed by one
//     thread in a fixed order: bitwise reproducible run to run, and K4s and
//     K4 equal to the first version of this kernel bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kTileW = 64;          // output columns per tile
constexpr int kMaxK = 31;
constexpr int kMaxThreads = 256;    // 64-row tiles of the f32 variants
constexpr int kSmemOptIn = 232448;  // 227 KB: the most one block may use
constexpr int kOutStride = kTileW + 8;  // K4's staged outputs: bf16 per row

// The variants (ops/cuda_conv_mma.py VARIANTS).
constexpr int kBf16 = 0;     // K4: bf16 in and out
constexpr int kSplit = 1;    // K4s: f32, hi/lo slices, three products
constexpr int kHighest = 2;  // K4h: f32, hi/mid/lo slices, six products
constexpr int kDefault = 3;  // K4d: f32, one rounded slice, one product

__host__ __device__ constexpr bool f32_in(int v) { return v != kBf16; }
// bf16 slices of each staged value (and of each B fragment)
__host__ __device__ constexpr int slices(int v) {
  return v == kSplit ? 2 : v == kHighest ? 3 : 1;
}
// Per variant: 8-column output blocks per warp (f32 variants 4: the slice
// pass's registers; K4 8), warps across a tile, and the ring slots (f32:
// each with a slot of slice tiles; K4: bf16, copies two tiles ahead).
__host__ __device__ constexpr int warp_blocks(int v) { return f32_in(v) ? 4 : 8; }
__host__ __device__ constexpr int warps_across(int v) {
  return kTileW / (8 * warp_blocks(v));
}
__host__ __device__ constexpr int ring_slots(int v) { return f32_in(v) ? 2 : 3; }
// accumulators per tap row: K4h sums hi*hi apart from its five small products
__host__ __device__ constexpr int parts(int v) { return v == kHighest ? 2 : 1; }
// bytes of one B table entry (tap row, k-step, lane)
__host__ __device__ constexpr int entry_bytes(int v) {
  return v == kSplit || v == kHighest ? 16 : 8;
}

__host__ __device__ constexpr int ksteps(int nk) { return (8 + nk - 1 + 15) / 16; }
// staged columns: the last block's last k-step reads up to 55 + 16 * steps
__host__ __device__ constexpr int stage_w(int nk) { return kTileW - 8 + 16 * ksteps(nk); }

// Bytes of one block's B table: every f32 instance, K4's run-time one.
__host__ __device__ constexpr int table_bytes(int v, int inst, int mk, int nk) {
  return inst && !f32_in(v) ? 0 : mk * ksteps(nk) * 32 * entry_bytes(v);
}

// Dynamic shared memory of one block (ops/cuda_conv_mma.py::smem_bytes
// computes the same), in planes of (tile_rows + mk - 1) x stage_w values:
// the f32 variants two f32 ring slots and two slots of slice tiles, each
// with a B table; K4 three bf16 ring slots, the staged outputs and, at
// run-time sizes, a B table.
__host__ __device__ constexpr int smem_bytes(int v, int inst, int tile_rows, int mk, int nk) {
  return f32_in(v) ? ring_slots(v) * (4 + 2 * slices(v)) * (tile_rows + mk - 1) * stage_w(nk) +
                         ring_slots(v) * table_bytes(v, inst, mk, nk)
                   : 2 * ring_slots(v) * (tile_rows + mk - 1) * stage_w(nk) +
                         2 * tile_rows * kOutStride + table_bytes(v, inst, mk, nk);
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

// The value's bf16 slices, s[0] the largest: K4s hi and lo; K4h hi, mid and
// lo, x = hi + mid + lo exactly (each rest is exact in f32, the last one in
// bf16: at most 8 significant bits); K4 and K4d bf16_rn(x) (exact for K4's
// bf16 values).
template <int V>
__device__ __forceinline__ void slice(float x, __nv_bfloat16 (&s)[slices(V)]) {
  if constexpr (V == kSplit) {
    split(x, s[0], s[1]);
  } else if constexpr (V == kHighest) {
    const uint32_t bits = __float_as_uint(x) & 0xFFFF0000u;
    s[0] = __ushort_as_bfloat16(static_cast<unsigned short>(bits >> 16));
    split(x - __uint_as_float(bits), s[1], s[2]);
  } else {
    s[0] = __float2bfloat16_rn(x);
  }
}

// The landed f32 stage (n values, a multiple of 4) into its slice tiles,
// slice j at tiles + j * n.
template <int V>
__device__ __forceinline__ void slice_stage(const float* raw, __nv_bfloat16* tiles, int n) {
  constexpr int S = slices(V);
  for (int i = threadIdx.x; i < n / 4; i += blockDim.x) {
    const float4 v = reinterpret_cast<const float4*>(raw)[i];
    __nv_bfloat16 x[4][S];
    slice<V>(v.x, x[0]);
    slice<V>(v.y, x[1]);
    slice<V>(v.z, x[2]);
    slice<V>(v.w, x[3]);
#pragma unroll
    for (int j = 0; j < S; ++j) {
      reinterpret_cast<uint2*>(tiles + j * n)[i] =
          make_uint2(pack(x[0][j], x[1][j]), pack(x[2][j], x[3][j]));
    }
  }
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// The four taps of the B fragment of tap row ti, k-step s for this lane:
// rows kk = 16s + 2q + {0, 1, 8, 9}, column n = g, from the flipped taps.
template <typename T>
__device__ __forceinline__ void b_taps(const T* kc, int mk, int nk, int ti, int s,
                                       float (&v)[4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int tj = 16 * s + 2 * q + (e & 1) + (e >> 1) * 8 - g;
    // convolution = correlation with the flipped kernel
    v[e] = (tj >= 0 && tj < nk) ? to_f32(kc[(mk - 1 - ti) * nk + (nk - 1 - tj)]) : 0.0f;
  }
}

// The taps' slices as the mma's B registers: b[j] holds slice j of taps
// (0, 1) and of taps (2, 3).
template <int V>
__device__ __forceinline__ void b_regs(const float (&v)[4], uint32_t (&b)[slices(V)][2]) {
  __nv_bfloat16 x[4][slices(V)];
#pragma unroll
  for (int e = 0; e < 4; ++e) slice<V>(v[e], x[e]);
#pragma unroll
  for (int j = 0; j < slices(V); ++j) {
    b[j][0] = pack(x[0][j], x[1][j]);
    b[j][1] = pack(x[2][j], x[3][j]);
  }
}

template <int K, typename T>
__device__ __forceinline__ void build_b_regs(const T* kc, uint32_t (&breg)[K][2]) {
#pragma unroll
  for (int ti = 0; ti < K; ++ti) {
    float v[4];
    b_taps(kc, K, K, ti, 0, v);
    uint32_t b[1][2];
    b_regs<kBf16>(v, b);
    breg[ti][0] = b[0][0];
    breg[ti][1] = b[0][1];
  }
}

// One entry per (tap row, k-step, lane): K4s the hi pair, then the lo pair;
// K4 and K4d the bf16 pair; K4h the four f32 taps, sliced where read.
template <int V, typename T>
__device__ __forceinline__ void build_b_table(const T* kc, int mk, int nk, int steps,
                                              uint32_t* table) {
  const int lane = threadIdx.x & 31;
  for (int x = threadIdx.x >> 5; x < mk * steps; x += blockDim.x >> 5) {
    const int ti = x / steps;
    float v[4];
    b_taps(kc, mk, nk, ti, x - ti * steps, v);
    if constexpr (V == kHighest) {
      reinterpret_cast<uint4*>(table)[x * 32 + lane] =
          make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]),
                     __float_as_uint(v[3]));
    } else {
      uint32_t b[slices(V)][2];
      b_regs<V>(v, b);
      if constexpr (V == kSplit) {
        reinterpret_cast<uint4*>(table)[x * 32 + lane] =
            make_uint4(b[0][0], b[0][1], b[1][0], b[1][1]);
      } else {
        reinterpret_cast<uint2*>(table)[x * 32 + lane] = make_uint2(b[0][0], b[0][1]);
      }
    }
  }
}

template <int V>
__device__ __forceinline__ void table_entry(const uint32_t* table, int x,
                                            uint32_t (&b)[slices(V)][2]) {
  const int at = x * 32 + (threadIdx.x & 31);
  if constexpr (V == kHighest) {
    const uint4 e = reinterpret_cast<const uint4*>(table)[at];
    const float v[4] = {__uint_as_float(e.x), __uint_as_float(e.y), __uint_as_float(e.z),
                        __uint_as_float(e.w)};
    b_regs<V>(v, b);
  } else if constexpr (V == kSplit) {
    const uint4 e = reinterpret_cast<const uint4*>(table)[at];
    b[0][0] = e.x;
    b[0][1] = e.y;
    b[1][0] = e.z;
    b[1][1] = e.w;
  } else {
    const uint2 e = reinterpret_cast<const uint2*>(table)[at];
    b[0][0] = e.x;
    b[0][1] = e.y;
  }
}

__device__ __forceinline__ void ldsm_x2(uint32_t& r0, uint32_t& r1, const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(smem_addr(p)));
}

// The A fragment registers of one 8-column group (16 rows from `row`, 8
// columns from `col`) of each slice tile (slice j at tile + j * plane):
// a[j] = rows g and g + 8, columns 2q and 2q + 1 (the mma's a0/a1 or a2/a3).
template <int S>
__device__ __forceinline__ void load_group(const __nv_bfloat16* tile, int plane, int sw, int row,
                                           int col, uint32_t (&a)[S][2]) {
  // ldmatrix.x2: lanes 0-15 give the addresses of the 16 rows
  const int at = (row + (threadIdx.x & 15)) * sw + col;
#pragma unroll
  for (int j = 0; j < S; ++j) ldsm_x2(a[j][0], a[j][1], tile + j * plane + at);
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One k-step of one block: A from groups (a0, a1), slice by slice.  K4s:
// hi*hi, hi*lo, lo*hi into part[0]; K4h hi*hi into part[0] and the small
// products into part[1], smallest first: lo*hi, mid*mid, hi*lo, mid*hi,
// hi*mid; K4 and K4d one product.
template <int V>
__device__ __forceinline__ void products(float (&part)[parts(V)][4],
                                         const uint32_t (&a0)[slices(V)][2],
                                         const uint32_t (&a1)[slices(V)][2],
                                         const uint32_t (&b)[slices(V)][2]) {
  uint32_t a[slices(V)][4];
#pragma unroll
  for (int j = 0; j < slices(V); ++j) {
    a[j][0] = a0[j][0];
    a[j][1] = a0[j][1];
    a[j][2] = a1[j][0];
    a[j][3] = a1[j][1];
  }
  if constexpr (V == kSplit) {
    mma(part[0], a[0], b[0]);
    mma(part[0], a[0], b[1]);
    mma(part[0], a[1], b[0]);
  } else if constexpr (V == kHighest) {
    mma(part[1], a[2], b[0]);
    mma(part[1], a[1], b[1]);
    mma(part[1], a[0], b[2]);
    mma(part[1], a[1], b[0]);
    mma(part[1], a[0], b[1]);
    mma(part[0], a[0], b[0]);
  } else {
    mma(part[0], a[0], b[0]);
  }
}

// A tap row's products into the total, in round-to-nearest: K4h's hi*hi
// plus its small products, then the total.
template <int V>
__device__ __forceinline__ void add_parts(float (&acc)[4], const float (&part)[parts(V)][4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if constexpr (parts(V) == 2) {
      acc[e] += part[0][e] + part[1][e];
    } else {
      acc[e] += part[0][e];
    }
  }
}

// Unrolled sizes (MK = NK = K <= 9, one k-step): a rolling window of
// 8-column groups; B from breg (K4) or the table (f32 variants).  tile:
// this warp's first stage row and column in the first slice tile.
template <int V, int K, int NB>
__device__ __forceinline__ void compute_fixed(const __nv_bfloat16* tile, int plane, int sw,
                                              const uint32_t (&breg)[NB][2],
                                              const uint32_t* table,
                                              float (&acc)[warp_blocks(V)][4]) {
  constexpr int S = slices(V);
#pragma unroll
  for (int ti = 0; ti < K; ++ti) {
    uint32_t b[S][2];
    if constexpr (V == kBf16) {
      b[0][0] = breg[ti][0];
      b[0][1] = breg[ti][1];
    } else {
      table_entry<V>(table, ti, b);
    }
    uint32_t a0[S][2];
    load_group<S>(tile, plane, sw, ti, 0, a0);
#pragma unroll
    for (int blk = 0; blk < warp_blocks(V); ++blk) {
      uint32_t a1[S][2];
      load_group<S>(tile, plane, sw, ti, 8 * (blk + 1), a1);
      float part[parts(V)][4] = {};
      products<V>(part, a0, a1, b);
      add_parts<V>(acc[blk], part);
#pragma unroll
      for (int j = 0; j < S; ++j) {
        a0[j][0] = a1[j][0];
        a0[j][1] = a1[j][1];
      }
    }
  }
}

// Run-time sizes (up to 31x31, up to three k-steps): B from the table, the
// two groups of each block and k-step loaded for it.
template <int V>
__device__ __forceinline__ void compute_runtime(const __nv_bfloat16* tile, int plane, int sw,
                                                int mk, int steps, const uint32_t* table,
                                                float (&acc)[warp_blocks(V)][4]) {
  constexpr int S = slices(V);
  for (int ti = 0; ti < mk; ++ti) {
    uint32_t b[3][S][2] = {};
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      if (s < steps) table_entry<V>(table, ti * steps + s, b[s]);
    }
#pragma unroll
    for (int blk = 0; blk < warp_blocks(V); ++blk) {
      float part[parts(V)][4] = {};
#pragma unroll
      for (int s = 0; s < 3; ++s) {
        if (s < steps) {
          uint32_t a0[S][2], a1[S][2];
          load_group<S>(tile, plane, sw, ti, 8 * blk + 16 * s, a0);
          load_group<S>(tile, plane, sw, ti, 8 * blk + 16 * s + 8, a1);
          products<V>(part, a0, a1, b[s]);
        }
      }
      add_parts<V>(acc[blk], part);
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
template <int V, int K>
__global__ void __launch_bounds__(kMaxThreads, 2) conv_mma_kernel(Args p) {
  using T = typename std::conditional<f32_in(V), float, __nv_bfloat16>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr bool kFixed = K > 0;
  constexpr bool kRegB = kFixed && !f32_in(V);  // K4's unrolled sizes: B in registers
  constexpr int NB = warp_blocks(V), kSlots = ring_slots(V), S = slices(V);
  const int mk = kFixed ? K : p.MK, nk = kFixed ? K : p.NK;
  const int steps = kFixed ? 1 : ksteps(nk);
  const int sh = p.tile_rows + mk - 1, sw = stage_w(nk), plane = sh * sw;
  const int warp = threadIdx.x >> 5;
  const int wr = (warp / warps_across(V)) * 16;        // this warp's first row
  const int wc = (warp % warps_across(V)) * 8 * NB;    // and first column
  const Walk walk = walk_of(sw / (p.copy_bytes / static_cast<int>(sizeof(T))));

  T* ring = reinterpret_cast<T*>(smem);
  __nv_bfloat16* tiles = reinterpret_cast<__nv_bfloat16*>(ring + kSlots * plane);
  uint32_t breg[kRegB ? K : 1][2] = {};
  float acc[NB][4];
  int t = blockIdx.x;  // the grid never exceeds the tile count
  const int grid = gridDim.x;

  if constexpr (f32_in(V)) {
    // Two f32 ring slots, then two slots of S slice tiles, then two B
    // tables.  One barrier a turn: after it, the copy two tiles ahead, the
    // slicing of the next tile (and its table when its channel differs) and
    // this tile's products run with no barrier between them, so warps that
    // slice overlap warps that multiply.
    const int tab_words = table_bytes(V, 0, mk, nk) / 4;
    uint32_t* tabs = reinterpret_cast<uint32_t*>(tiles + kSlots * S * plane);
    int tab_c[2] = {-1, -1};
    stage(ring, p, tile_at(p, t), sh, sw, walk);
    cp_async_commit();
    if (t + grid < p.n_tiles) stage(ring + plane, p, tile_at(p, t + grid), sh, sw, walk);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // the first tile landed
    slice_stage<V>(ring, tiles, plane);
    tab_c[0] = tile_at(p, t).c;
    build_b_table<V>(static_cast<const T*>(p.k) + static_cast<size_t>(tab_c[0]) * mk * nk,
                        mk, nk, steps, tabs);
    for (int slot = 0; t < p.n_tiles; slot ^= 1, t += grid) {
      const Tile tile = tile_at(p, t);
      cp_async_wait<0>();
      __syncthreads();  // this tile sliced, the next landed; the other slots are free
      if (t + 2 * grid < p.n_tiles) {
        stage(ring + slot * plane, p, tile_at(p, t + 2 * grid), sh, sw, walk);
        cp_async_commit();
      }
      if (t + grid < p.n_tiles) {
        const int nx = slot ^ 1, c = tile_at(p, t + grid).c;
        slice_stage<V>(ring + nx * plane, tiles + S * nx * plane, plane);
        if (c != tab_c[nx]) {
          build_b_table<V>(static_cast<const T*>(p.k) + static_cast<size_t>(c) * mk * nk, mk,
                              nk, steps, tabs + nx * tab_words);
          tab_c[nx] = c;
        }
      }
#pragma unroll
      for (int b = 0; b < NB; ++b) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[b][e] = 0.0f;
      }
      const __nv_bfloat16* st = tiles + S * slot * plane + wr * sw + wc;
      const uint32_t* table = tabs + slot * tab_words;
      if constexpr (kFixed) {
        compute_fixed<V, K>(st, plane, sw, breg, table, acc);
      } else {
        compute_runtime<V>(st, plane, sw, mk, steps, table, acc);
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
          build_b_table<kBf16>(kc, mk, nk, steps, table);
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
        compute_fixed<kBf16, K>(st, plane, sw, breg, table, acc);
      } else {
        compute_runtime<kBf16>(st, plane, sw, mk, steps, table, acc);
      }
      store_staged(p, Tile{tile.c, tile.i0, tile.j0 + wc}, wr, acc, ob);
      __syncthreads();  // the ring slot and the table are free again
    }
  }
}

template <int V, int K>
int run(const Args& p, int grid, int smem, cudaStream_t stream) {
  const void* kern = reinterpret_cast<const void*>(conv_mma_kernel<V, K>);
  // raise the instance's opt-in limit once per process (thread-safe static init)
  static const cudaError_t attr =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemOptIn);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  conv_mma_kernel<V, K><<<grid, 2 * warps_across(V) * p.tile_rows, smem, stream>>>(p);
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
template <int V>
int launch(const void* a, const void* k, void* out, int C, int H, int W, int MK, int NK, int plo,
           int qlo, int Ho, int Wo, int inst, int tile_rows, int grid, int smem, void* stream) {
  if (MK < 1 || NK < 1 || MK > kMaxK || NK > kMaxK || C < 1 || H < 1 || W < 1 || plo < 0 ||
      qlo < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (Ho <= 0 || Wo <= 0) return 0;
  const int want_inst = (MK == NK && (MK == 3 || MK == 5 || MK == 7 || MK == 9)) ? MK : 0;
  if (inst != want_inst || (tile_rows != 16 && tile_rows != 32 && tile_rows != 64) ||
      smem != smem_bytes(V, inst, tile_rows, MK, NK) || smem > kSmemOptIn) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  constexpr int itemsize = f32_in(V) ? 4 : 2;
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
    case 3: return run<V, 3>(p, grid, smem, s);
    case 5: return run<V, 5>(p, grid, smem, s);
    case 7: return run<V, 7>(p, grid, smem, s);
    case 9: return run<V, 9>(p, grid, smem, s);
    default: return run<V, 0>(p, grid, smem, s);
  }
}

}  // namespace

// Each entry: a (C, H, W), taps (C, MK, NK), out (C, Ho, Wo).
#define ICS_CONV_MMA_ENTRY(name, variant)                                                     \
  extern "C" int name(const void* a, const void* k, void* out, int C, int H, int W, int MK,   \
                      int NK, int plo, int qlo, int Ho, int Wo, int inst, int tile_rows,     \
                      int grid, int smem, void* stream) {                                    \
    return launch<variant>(a, k, out, C, H, W, MK, NK, plo, qlo, Ho, Wo, inst, tile_rows,   \
                           grid, smem, stream);                                              \
  }

ICS_CONV_MMA_ENTRY(ics_conv_mma_split, kSplit)      // K4s: float32 a, taps and out
ICS_CONV_MMA_ENTRY(ics_conv_mma_bf16, kBf16)        // K4: bfloat16 a, taps and out
ICS_CONV_MMA_ENTRY(ics_conv_mma_highest, kHighest)  // K4h: float32 a, taps and out
ICS_CONV_MMA_ENTRY(ics_conv_mma_default, kDefault)  // K4d: float32 a, taps and out
