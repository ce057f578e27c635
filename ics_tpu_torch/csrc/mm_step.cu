// K8, the MM step: steps 4-8 of the RL-MM op loop's inner iteration in
// parity mode (ops/cuda_solver.py::inner_loop_ops), in two launches.
//
// Replaces no TPU kernel: XLA fuses these steps of the lax.scan body of
// ics_tpu/models/rl_mm.py:377-531.  The port ran them as some 23 PyTorch
// launches an inner step, which read and wrote about 42 window-sized
// tensors:
//   4. dof  = ((gradu[crop] - image) / (gradu[crop] + image))**2, / lambd
//      when non-blind;
//   5. greg = lambd * gradu + (u - ut) / 2;
//   6. dt   = sf * (amax(u) + 1/(uM uN)) / (amax(|greg|) + 1e-15) per channel,
//      u'   = u - dt * greg over the padded window;
//   8. u'[crop] = (1 - dof) * u'[crop] + dof * image.
//
// What bounds it on this card: device-memory bandwidth.  The maxima come
// before any update, so a pass must read the window before the update
// writes it: pass A reads gradu, u and ut; pass B reads them again with the
// image on the crop and writes u' (8 window-sized passes; at 24 MP a window
// is 289 MB).  Each element costs a few f32 operations.
//
// Design.  The window tensors start on 16 bytes (ops/cuda_step.py copies one
// that does not), so in each channel the elements whose flat index in the
// tensor is a multiple of 4 start 16-byte groups: `head` (0-3) elements
// before the first of them, a tail of 0-3 after the last.  The channel's
// plane is cut into `blocks` chunks of `chunk` elements (a multiple of 4)
// from `head` on, one per block (grid blocks x C, one wave of 4 blocks of
// 256 threads an SM at the 38-48 registers the passes take; holding them to
// 32 spilled and ran slower); the first block also takes the head, the last
// the tail, one element a thread; the rest go 4 at a time, one 16-byte load
// of each input.  At 24 MP the planes are odd (the frame is padded to odd
// sizes), so no row is aligned and every channel but the first has a head.
// Pass A (mm_step_max_kernel) writes each block's maxima of u and |greg| to
// `partial`; pass B (mm_step_update_kernel) reduces its channel's partials
// in a fixed order in one warp, forms dt, recomputes greg and writes u' into
// a fresh output (at the first inner step ut is u, so nothing is written
// over an input); the image is read with 4-byte loads on the crop only, its
// rows being offset from the window's by `pad`.  No atomics.
//
// Bits: the result is bitwise that of the PyTorch ops on the card.  Every
// f32 operation is a round-to-nearest intrinsic in the ops' order, so no
// multiply-add is contracted.  PyTorch divides a CUDA tensor by a Python
// scalar as a product with the scalar's reciprocal, taken in float64 and
// rounded to float32: dof / lambd is dof * inv_lambd (float(1.0 / lambd),
// from the host; 1.0f / float(lambd) moves an ulp at lambd = 1000 / 3) and
// (u - ut) / 2 is (u - ut) * 0.5f.  Scalars enter as float32.  The maxima
// propagate NaN as torch.amax does; max is exact, so their order moves no
// bit (a signed zero of amax(u) is added to 1/(uM uN) and vanishes).

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 256;

struct Params {
  const float* __restrict__ gradu;  // (C, uM, uN)
  const float* __restrict__ u;      // (C, uM, uN)
  const float* __restrict__ ut;     // (C, uM, uN); may be u itself
  const float* __restrict__ image;  // (C, M, N)
  float* __restrict__ out;          // (C, uM, uN)
  float* __restrict__ partial;      // (C, blocks, 2): max u, max |greg|
  int uM, uN, M, N, pad;            // crop: rows and columns [pad, pad + M|N)
  int blocks;                       // blocks per channel (gridDim.x)
  int chunk;                        // elements of a plane per block, a multiple of 4
  float lambd, inv_lambd, sf, inv_un, eps;
  int blind;
};

// A block's elements of its channel's plane: [lo, hi), of which [alo, ahi)
// in 16-byte groups
struct Range {
  int lo, alo, ahi, hi;
};

__device__ __forceinline__ Range block_range(const Params& p) {
  const int plane = p.uM * p.uN;
  const int head = min(static_cast<int>((4 - static_cast<long long>(blockIdx.y) * plane % 4) % 4),
                       plane);
  const int b = blockIdx.x;
  Range r;
  r.lo = b == 0 ? 0 : min(head + b * p.chunk, plane);
  r.hi = b == p.blocks - 1 ? plane : min(head + (b + 1) * p.chunk, plane);
  r.alo = max(r.lo, head);
  r.ahi = r.alo + max(r.hi - r.alo, 0) / 4 * 4;
  if (r.alo > r.hi) r.alo = r.ahi = r.hi;
  return r;
}

__device__ __forceinline__ float4 load4(const float* __restrict__ a) {
  return __ldg(reinterpret_cast<const float4*>(a));
}

// torch.amax's maximum: a NaN anywhere makes the maximum NaN
__device__ __forceinline__ float nan_max(float m, float v) { return (v != v || v > m) ? v : m; }

// step 5: lambd * gradu + (u - ut) / 2
__device__ __forceinline__ float greg_of(float g, float u, float ut, float lambd) {
  return __fadd_rn(__fmul_rn(lambd, g), __fmul_rn(__fsub_rn(u, ut), 0.5f));
}

// pass A's work on one element
__device__ __forceinline__ void take_max(float g, float u, float ut, float lambd, float& mu,
                                         float& mg) {
  mu = nan_max(mu, u);
  mg = nan_max(mg, fabsf(greg_of(g, u, ut, lambd)));
}

__global__ void __launch_bounds__(kThreads) mm_step_max_kernel(Params p) {
  const int c = blockIdx.y;
  const size_t base = static_cast<size_t>(c) * p.uM * p.uN;
  const float* g = p.gradu + base;
  const float* u = p.u + base;
  const float* ut = p.ut + base;
  const Range r = block_range(p);
  const int t = threadIdx.x;
  float mu = -INFINITY, mg = -INFINITY;
  for (int j = r.lo + t; j < r.alo; j += kThreads) take_max(g[j], u[j], ut[j], p.lambd, mu, mg);
  for (int j = r.alo + 4 * t; j < r.ahi; j += 4 * kThreads) {
    const float4 gv = load4(g + j), uv = load4(u + j), tv = load4(ut + j);
    take_max(gv.x, uv.x, tv.x, p.lambd, mu, mg);
    take_max(gv.y, uv.y, tv.y, p.lambd, mu, mg);
    take_max(gv.z, uv.z, tv.z, p.lambd, mu, mg);
    take_max(gv.w, uv.w, tv.w, p.lambd, mu, mg);
  }
  for (int j = r.ahi + t; j < r.hi; j += kThreads) take_max(g[j], u[j], ut[j], p.lambd, mu, mg);
  // the block's maxima: each warp by shuffles, then the warps in order
  for (int off = 16; off > 0; off >>= 1) {
    mu = nan_max(mu, __shfl_xor_sync(0xffffffffu, mu, off));
    mg = nan_max(mg, __shfl_xor_sync(0xffffffffu, mg, off));
  }
  __shared__ float s_mu[kThreads / 32], s_mg[kThreads / 32];
  const int warp = t / 32;
  if ((t & 31) == 0) {
    s_mu[warp] = mu;
    s_mg[warp] = mg;
  }
  __syncthreads();
  if (t == 0) {
    for (int w = 1; w < kThreads / 32; ++w) {
      mu = nan_max(mu, s_mu[w]);
      mg = nan_max(mg, s_mg[w]);
    }
    float* out = p.partial + (static_cast<size_t>(c) * p.blocks + blockIdx.x) * 2;
    out[0] = mu;
    out[1] = mg;
  }
}

// element j of the channel: on the crop (steps 4 and 8) its image value
__device__ __forceinline__ bool on_crop(const Params& p, const float* image, int j, float& im) {
  const int y = j / p.uN - p.pad;
  const int x = j - (y + p.pad) * p.uN - p.pad;
  const bool in = y >= 0 && y < p.M && x >= 0 && x < p.N;
  if (in) im = __ldg(image + static_cast<size_t>(y) * p.N + x);
  return in;
}

// pass B's work on one element: step 6's update over the whole window, then
// on the crop steps 4 and 8
__device__ __forceinline__ float update(const Params& p, float dt, float g, float u, float ut,
                                        bool in, float im) {
  float v = __fsub_rn(u, __fmul_rn(dt, greg_of(g, u, ut, p.lambd)));
  if (in) {
    const float d = __fdiv_rn(__fsub_rn(g, im), __fadd_rn(g, im));
    float dof = __fmul_rn(d, d);
    if (!p.blind) dof = __fmul_rn(dof, p.inv_lambd);
    v = __fadd_rn(__fmul_rn(__fsub_rn(1.0f, dof), v), __fmul_rn(dof, im));
  }
  return v;
}

__global__ void __launch_bounds__(kThreads) mm_step_update_kernel(Params p) {
  const int c = blockIdx.y;
  __shared__ float s_dt;
  if (threadIdx.x < 32) {  // step 6's maxima and dt, in one warp, in a fixed order
    float mu = -INFINITY, mg = -INFINITY;
    const float* part = p.partial + static_cast<size_t>(c) * p.blocks * 2;
    for (int b = threadIdx.x; b < p.blocks; b += 32) {
      mu = nan_max(mu, part[2 * b]);
      mg = nan_max(mg, part[2 * b + 1]);
    }
    for (int off = 16; off > 0; off >>= 1) {
      mu = nan_max(mu, __shfl_xor_sync(0xffffffffu, mu, off));
      mg = nan_max(mg, __shfl_xor_sync(0xffffffffu, mg, off));
    }
    if (threadIdx.x == 0)
      s_dt = __fdiv_rn(__fmul_rn(p.sf, __fadd_rn(mu, p.inv_un)), __fadd_rn(mg, p.eps));
  }
  __syncthreads();
  const float dt = s_dt;
  const size_t base = static_cast<size_t>(c) * p.uM * p.uN;
  const float* g = p.gradu + base;
  const float* u = p.u + base;
  const float* ut = p.ut + base;
  const float* image = p.image + static_cast<size_t>(c) * p.M * p.N;
  float* out = p.out + base;
  const Range r = block_range(p);
  const int t = threadIdx.x;
  float im = 0.0f;
  for (int j = r.lo + t; j < r.alo; j += kThreads) {
    const bool in = on_crop(p, image, j, im);
    out[j] = update(p, dt, g[j], u[j], ut[j], in, im);
  }
  for (int j = r.alo + 4 * t; j < r.ahi; j += 4 * kThreads) {
    const float4 gv = load4(g + j), uv = load4(u + j), tv = load4(ut + j);
    float iv[4];
    bool in[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) in[e] = on_crop(p, image, j + e, iv[e]);
    *reinterpret_cast<float4*>(out + j) = make_float4(
        update(p, dt, gv.x, uv.x, tv.x, in[0], iv[0]), update(p, dt, gv.y, uv.y, tv.y, in[1], iv[1]),
        update(p, dt, gv.z, uv.z, tv.z, in[2], iv[2]), update(p, dt, gv.w, uv.w, tv.w, in[3], iv[3]));
  }
  for (int j = r.ahi + t; j < r.hi; j += kThreads) {
    const bool in = on_crop(p, image, j, im);
    out[j] = update(p, dt, g[j], u[j], ut[j], in, im);
  }
}

}  // namespace

// gradu, u, ut, out (C, uM, uN) and image (C, M, N), contiguous float32 on
// the card, the first four starting on 16 bytes; partial (C, blocks, 2)
// float32 scratch; the crop is rows and columns [pad, pad + M) x [pad,
// pad + N) of the window; blocks and chunk from ops/cuda_step.py::geometry.
// Two launches on `stream`: pass A, then pass B.
extern "C" int ics_mm_step(const float* gradu, const float* u, const float* ut,
                           const float* image, float* out, float* partial, int C, int uM,
                           int uN, int M, int N, int pad, int blocks, int chunk, float lambd,
                           float inv_lambd, float sf, float inv_un, float eps, int blind,
                           void* stream) {
  const long long plane = static_cast<long long>(uM) * uN;
  const auto off16 = [](const void* a) { return reinterpret_cast<uintptr_t>(a) % 16 != 0; };
  if (off16(gradu) || off16(u) || off16(ut) || off16(out))
    return static_cast<int>(cudaErrorMisalignedAddress);
  if (C < 1 || C > 65535 || uM < 1 || uN < 1 || M < 1 || N < 1 || pad < 0 ||
      pad + M > uM || pad + N > uN || blocks < 1 || chunk < 4 || chunk % 4 != 0 ||
      static_cast<long long>(blocks) * chunk < plane ||
      plane + 4LL * (chunk + kThreads) >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{gradu, u, ut, image, out, partial, uM, uN, M, N, pad, blocks, chunk,
                 lambd, inv_lambd, sf, inv_un, eps, blind};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(C));
  mm_step_max_kernel<<<grid, kThreads, 0, s>>>(p);
  mm_step_update_kernel<<<grid, kThreads, 0, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}
