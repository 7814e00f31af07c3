// The time loop's section clock for Hopper (sm_90a): the stamp kernel.
//
// No TPU kernel behind it: the port's tracing (profiling.SectionClock).
// One thread reads the device's global nanosecond timer (%globaltimer)
// and adds its advance since the previous stamp, which the buffer's last
// slot holds, to slot `section` (a section of the time loop's step, in
// profiling.SECTIONS order), then stores the time as the last stamp; a
// negative `section` only stores it (the start of a block). The stamps of
// a block run on one stream, one after another, in a twin of the block's
// CUDA graph, so each section's slot sums the device time between the
// stamps around its kernels, with no read of the host. A stamp is one
// 64-bit load, two stores and a launch of one thread: the cost is the
// launch, a microsecond or two inside a graph.
//
// C interface (loaded with ctypes): the int64 slots, the section, the
// index of the last slot and the stream; returns cudaGetLastError() of
// the launch.

#include <cuda_runtime.h>

namespace {

__global__ void stamp_kernel(long long* slots, int section, int last) {
  unsigned long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  const long long t = static_cast<long long>(now);
  if (section >= 0) slots[section] += t - slots[last];
  slots[last] = t;
}

}  // namespace

extern "C" int semi_stamp_i64(void* slots, int section, int last,
                              void* stream) {
  stamp_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<long long*>(slots), section, last);
  return static_cast<int>(cudaGetLastError());
}
