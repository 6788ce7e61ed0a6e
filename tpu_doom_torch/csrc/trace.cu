// Device-clock stamps for `tpu_doom_torch/trace.py`: a one-thread kernel
// that reads `%globaltimer` (ns) and writes it, with the tick it belongs
// to, into a ring of ticks x slots on the device. Launched on the current
// stream at a span's start and end, it becomes a node of a graph being
// captured, so that a replayed tick stamps where it runs, with no host
// read. The tick comes from a device counter that the stamp opening a
// tick increments; a graph's first node is that stamp.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return (long long)t;
}

// ring (n_ticks, n_slots, 2) i64: entry (tick, ns). The stamp writes the
// row of tick `*counter + ahead` (a span issued before its tick's graph
// takes ahead = 1); `opens` also stores that tick in the counter.
__global__ void trace_stamp_kernel(long long* ring, long long* counter, int slot,
                                   int n_slots, int n_ticks, int ahead, int opens) {
  long long tick = *counter + ahead;
  if (opens) *counter = tick;
  long long* e = ring + ((tick % n_ticks) * n_slots + slot) * 2;
  e[0] = tick;
  e[1] = global_ns();
}

// The smallest step of %globaltimer seen over `steps` changes of it.
__global__ void trace_resolution_kernel(long long* out, int steps) {
  long long best = 1LL << 62;
  long long last = global_ns();
  for (int i = 0; i < steps; ++i) {
    long long now = global_ns();
    while (now == last) now = global_ns();
    if (now - last < best) best = now - last;
    last = now;
  }
  *out = best;
}

}  // namespace

extern "C" int tdt_trace_stamp(void* ring, void* counter, int slot, int n_slots,
                               int n_ticks, int ahead, int opens, void* stream) {
  trace_stamp_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(
      (long long*)ring, (long long*)counter, slot, n_slots, n_ticks, ahead, opens);
  return (int)cudaGetLastError();
}

extern "C" int tdt_trace_resolution(void* out, int steps, void* stream) {
  trace_resolution_kernel<<<1, 1, 0, (cudaStream_t)stream>>>((long long*)out, steps);
  return (int)cudaGetLastError();
}
