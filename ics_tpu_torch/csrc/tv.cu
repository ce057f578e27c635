// K5: the 8-neighbour TV magnitude and divergence of planar (C, H, W) input.
//
// Replaces the TPU kernel ics_tpu/ops/pallas_tv.py::_make_kernel (wrappers
// _tv_planar, tv_op_pallas), whose math is ics_tpu/ops/tv.py::tv_op (ref
// lib/deconvolution.pyx:137-239): 2nd-order (central) or 1st-order (forward
// and backward) differences, L1 or L2 norm, epsilon, diagonals divided by
// sqrt(2), both outputs divided by `adjust`, and the border ring left at 0.
//
// What bounds it on the card: a single stencil pass of about 40 flops per
// pixel against one read and two writes, so device-memory bandwidth (at 24
// MP f32: 290 MB in, 580 MB out).
//
// Design: one thread per output pixel in 32 x 8 blocks; the nine neighbours
// come through L1 (a row band with its halo in shared memory saves nothing
// here: neighbouring threads share the lines).  Every operation is a
// round-to-nearest intrinsic in tv_op's order, so nvcc fuses no multiply-add
// and the result is bitwise the plain PyTorch version's.  bf16 input is
// widened to f32, the math runs in f32 and each output is rounded once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBlockW = 32;
constexpr int kBlockH = 8;

__device__ __forceinline__ float ld(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

struct Consts {
  float eps, eps2, sqrt2, adjust;
};

template <int kNorm>
__device__ __forceinline__ float nrm(float x, float y, const Consts& k) {
  if constexpr (kNorm == 1) {
    return __fadd_rn(__fadd_rn(fabsf(x), fabsf(y)), k.eps);
  } else {
    return __fsqrt_rn(__fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), k.eps2));
  }
}

template <typename T, int kOrder, int kNorm>
__global__ void __launch_bounds__(kBlockW * kBlockH)
tv_kernel(const T* __restrict__ u, T* __restrict__ tv, T* __restrict__ dv, int H, int W,
          Consts k) {
  const int j = blockIdx.x * kBlockW + threadIdx.x;
  const int i = blockIdx.y * kBlockH + threadIdx.y;
  if (i >= H || j >= W) return;
  const size_t plane = static_cast<size_t>(H) * W;
  const size_t at = blockIdx.z * plane + static_cast<size_t>(i) * W + j;
  if (i == 0 || j == 0 || i == H - 1 || j == W - 1) {
    st(tv + at, 0.0f);
    st(dv + at, 0.0f);
    return;
  }
  const T* p = u + at;
  // s(di, dj) = u[i + di, j + dj]
  auto s = [&](int di, int dj) { return ld(p + static_cast<ptrdiff_t>(di) * W + dj); };
  const float c = s(0, 0);
  float t, d;
  if constexpr (kOrder == 2) {
    const float m2c = __fmul_rn(-2.0f, c);
    const float udx = __fadd_rn(__fadd_rn(m2c, s(-1, 0)), s(1, 0));
    const float udy = __fadd_rn(__fadd_rn(m2c, s(0, -1)), s(0, 1));
    const float udxdy = __fdiv_rn(__fadd_rn(__fadd_rn(m2c, s(-1, -1)), s(1, 1)), k.sqrt2);
    const float udydx = __fdiv_rn(__fadd_rn(__fadd_rn(m2c, s(-1, 1)), s(1, -1)), k.sqrt2);
    d = __fdiv_rn(__fsub_rn(__fsub_rn(__fsub_rn(-udx, udy), udxdy), udydx), k.adjust);
    t = __fdiv_rn(__fadd_rn(nrm<kNorm>(udx, udy, k), nrm<kNorm>(udxdy, udydx, k)), k.adjust);
  } else {
    const float udx_b = __fsub_rn(c, s(-1, 0));
    const float udy_b = __fsub_rn(c, s(0, -1));
    const float udx_f = __fadd_rn(-c, s(1, 0));
    const float udy_f = __fadd_rn(-c, s(0, 1));
    const float udxdy_b = __fdiv_rn(__fsub_rn(c, s(-1, -1)), k.sqrt2);
    const float udydx_b = __fdiv_rn(__fsub_rn(c, s(-1, 1)), k.sqrt2);
    const float udydx_f = __fdiv_rn(__fadd_rn(-c, s(1, -1)), k.sqrt2);
    const float udxdy_f = __fdiv_rn(__fadd_rn(-c, s(1, 1)), k.sqrt2);
    float acc = __fadd_rn(udx_b, udy_b);
    acc = __fsub_rn(acc, udx_f);
    acc = __fsub_rn(acc, udy_f);
    acc = __fadd_rn(acc, udxdy_b);
    acc = __fadd_rn(acc, udydx_b);
    acc = __fsub_rn(acc, udxdy_f);
    acc = __fsub_rn(acc, udydx_f);
    d = __fdiv_rn(acc, k.adjust);
    float n = __fadd_rn(nrm<kNorm>(udx_b, udy_b, k), nrm<kNorm>(udx_f, udy_f, k));
    n = __fadd_rn(n, nrm<kNorm>(udxdy_b, udydx_b, k));
    n = __fadd_rn(n, nrm<kNorm>(udxdy_f, udydx_f, k));
    t = __fdiv_rn(n, k.adjust);
  }
  st(tv + at, t);
  st(dv + at, d);
}

template <typename T>
int launch(const void* u, void* tv, void* dv, int C, int H, int W, int order, int norm,
           Consts k, void* stream) {
  if (C < 1 || (order != 1 && order != 2) || (norm != 1 && norm != 2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (H <= 0 || W <= 0) return 0;
  const dim3 block(kBlockW, kBlockH);
  const dim3 grid((W + kBlockW - 1) / kBlockW, (H + kBlockH - 1) / kBlockH, C);
  auto st = static_cast<cudaStream_t>(stream);
  auto* in = static_cast<const T*>(u);
  auto* t = static_cast<T*>(tv);
  auto* d = static_cast<T*>(dv);
  if (order == 2 && norm == 1) tv_kernel<T, 2, 1><<<grid, block, 0, st>>>(in, t, d, H, W, k);
  if (order == 2 && norm == 2) tv_kernel<T, 2, 2><<<grid, block, 0, st>>>(in, t, d, H, W, k);
  if (order == 1 && norm == 1) tv_kernel<T, 1, 1><<<grid, block, 0, st>>>(in, t, d, H, W, k);
  if (order == 1 && norm == 2) tv_kernel<T, 1, 2><<<grid, block, 0, st>>>(in, t, d, H, W, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// u, tv, div: (C, H, W), all float32 (is_bf16 = 0) or all bfloat16 (1).
// eps, eps2, sqrt2 and adjust are tv_op's constants rounded to float32.
extern "C" int ics_tv(const void* u, void* tv, void* dv, int C, int H, int W, int order,
                      int norm, float eps, float eps2, float sqrt2, float adjust, int is_bf16,
                      void* stream) {
  const Consts k{eps, eps2, sqrt2, adjust};
  if (is_bf16) return launch<__nv_bfloat16>(u, tv, dv, C, H, W, order, norm, k, stream);
  return launch<float>(u, tv, dv, C, H, W, order, norm, k, stream);
}
