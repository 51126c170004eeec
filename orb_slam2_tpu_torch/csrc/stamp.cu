// A device time stamp: one thread writes the SM's %globaltimer (ns) into
// one slot of an int64 buffer.
//
// The tracking step (slam/track_step.py) launches it between its stages,
// so a CUDA graph of the step carries the stamps as nodes of its own and
// each replay leaves the time at which every stage boundary was reached
// on the device.  The stamp orders after the kernel before it and before
// the kernel after it on the stream, so the difference of two stamps is
// the device time of the stages between them, launch gaps included.
// %globaltimer counts ns on one clock for the whole device; the host's
// clock is another, so only differences of stamps are compared with host
// times.

#include <cuda_runtime.h>

namespace {

__global__ void stamp_kernel(long long* buf, int slot) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  buf[slot] = static_cast<long long>(t);
}

}  // namespace

// buf: device int64 buffer; slot: the index written.
extern "C" int orb_stamp(long long* buf, int slot, cudaStream_t stream) {
  stamp_kernel<<<1, 1, 0, stream>>>(buf, slot);
  return static_cast<int>(cudaGetLastError());
}
