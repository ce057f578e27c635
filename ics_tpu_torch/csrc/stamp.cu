// The tracer's stamp: the card's %globaltimer written to device memory on a
// stream (utils/trace.py).
//
// Replaces no TPU kernel: the JAX package times its stages on the host and
// reads device time only from the profiler.  Here a span that must not
// synchronise (Tracer(sync=False)) launches one stamp where it opens and one
// where it closes, on the stream its work runs on; the stamps are read once
// after the frame and mapped onto the host's clock by a calibration
// (Tracer.calibrate).  %globaltimer counts nanoseconds on the card; its
// resolution is the card's (PERF.md).
//
// What bounds it on this card: one launch's latency.  One thread writes
// `count` successive readings (8 bytes each) from `index` on; the tracer
// writes one, and a run of them measures the timer's resolution.

#include <cuda_runtime.h>

namespace {

__global__ void stamp_kernel(long long* out, int count) {
  for (int i = 0; i < count; ++i) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    out[i] = static_cast<long long>(t);
  }
}

}  // namespace

// buf: int64 on the card; writes buf[index], ..., buf[index + count - 1].
extern "C" int ics_stamp(long long* buf, int index, int count, void* stream) {
  stamp_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(buf + index, count);
  return static_cast<int>(cudaGetLastError());
}
