// K7: the RL-MM solver's outer-loop stop, decided on the card.
//
// Replaces the stop of the JAX solver's on-device outer loop,
// ics_tpu/models/rl_mm.py:543-575 (the residual-whiteness test, the
// whiteness-plateau stop of RLConfig.early_stop) and outer_cond :598-600,
// which lax.while_loop evaluates without a host round-trip.  Here the solver
// replays each outer as a CUDA graph (models/rl_mm.py) and this kernel keeps
// the stop state in device memory, so the body has no host read in it.
//
// What bounds it on the card: nothing but one launch's latency.  It reads
// 32 bytes and writes 29; at 3.35 TB/s that is 0.02 ns.
//
// Design: one thread.  The state is three float32 values,
// mr = [m_r, m_r_prev, m_r_best], and four int32 values,
// ints = [it, since_best, stop, go], with `go` also written to a bool that a
// caller can test.  Every operation is a round-to-nearest intrinsic in the
// JAX file's order (no multiply-add can be contracted), so the state is
// bitwise that of the plain PyTorch version, ops/cuda_outer.py::
// outer_stop_plain: tau and 1 - early_stop come in as float32, as JAX
// compares float32 values against weakly typed Python floats.

#include <cuda_runtime.h>

namespace {

struct StopParams {
  int iterations;    // the outer cap
  int blind;         // blind test (M_r grew) or the relative one against tau
  int early;         // the plateau stop: early_stop > 0 and not blind
  int patience;      // early_stop_patience
  int use_stopping;  // 0: the state keeps its M_r and never stops
  float tau;         // float32(tau)
  float keep;        // float32(1 - early_stop)
};

__global__ void outer_stop_kernel(const float* __restrict__ m_r_new, float* mr, int* ints,
                                  bool* go, StopParams p) {
  const int it = ints[0];
  int since = ints[1];
  bool stop = false;
  if (p.use_stopping) {
    const float now = *m_r_new;
    const float prev = it > 0 ? mr[0] : mr[1];  // rl_mm.py:543
    bool hit;
    if (p.blind) {
      hit = now > prev;  // :545
    } else {
      hit = __fdiv_rn(__fsub_rn(now, prev), __fadd_rn(now, prev)) > p.tau;  // :548
    }
    stop = it > 1 && hit;
    if (p.early) {  // :566-575
      const float best = mr[2];
      const bool improved = now < __fmul_rn(best, p.keep);
      mr[2] = improved ? now : best;
      since = improved ? 0 : since + 1;
      stop = stop || (it > 1 && since >= p.patience);
    }
    mr[0] = now;
    mr[1] = prev;
  }
  const bool more = it + 1 < p.iterations && !stop;  // outer_cond, :598-600
  ints[0] = it + 1;
  ints[1] = since;
  ints[2] = stop;
  ints[3] = more;
  *go = more;
}

}  // namespace

// m_r_new: this outer's whiteness metric (float32, may alias mr[0] when
// use_stopping is 0: it is not read then); mr float32[3], ints int32[4] and
// go (bool) are updated in place.
extern "C" int ics_outer_stop(const float* m_r_new, float* mr, int* ints, bool* go,
                              int iterations, int blind, float tau, int early, float keep,
                              int patience, int use_stopping, void* stream) {
  const StopParams p{iterations, blind, early, patience, use_stopping, tau, keep};
  outer_stop_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(m_r_new, mr, ints, go, p);
  return static_cast<int>(cudaGetLastError());
}
