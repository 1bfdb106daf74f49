// What the port's kernels share: the current device's SM count, the layout of
// the per-stream scratch buffer, and the last-block ticket with which a grid
// finishes a cross-block reduction inside the same launch.
//
// The scratch buffer (hdu_scratch_bytes() bytes, one per device and stream,
// made by ops/build.py) starts with kCounterSlots uint32 counters and then
// holds kPartialFloats fp32 partial sums. It is zero when made, and every
// launch that takes a ticket leaves the counters it used at zero again, so
// no call needs a memset launch. Two launches that share a buffer must not
// overlap: the buffer belongs to one stream.

#pragma once

#include <cuda_runtime.h>

namespace hdu {

constexpr int kCounterSlots = 1024;
// The last kReservedSlots counters belong to cc.cu: compose_finish's six
// bbox accumulators and its ticket, then the labelling's count of listed
// local roots (set back to zero by the finish pass that follows the roots
// pass); the other kernels take tickets below.
constexpr int kReservedSlots = 8;
constexpr int kTicketSlots = kCounterSlots - kReservedSlots;
constexpr long long kPartialFloats = 1LL << 19;  // 2 MiB
constexpr long long kScratchBytes = 4LL * kCounterSlots + 4 * kPartialFloats;

inline unsigned int* counters(void* scratch) { return static_cast<unsigned int*>(scratch); }

inline float* partials(void* scratch) {
  return reinterpret_cast<float*>(static_cast<char*>(scratch) + 4 * kCounterSlots);
}

constexpr int kMaxDevices = 64;

// The current device's SM count, read once per device.
inline int sm_count() {
  static int sms[kMaxDevices] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= kMaxDevices) return 132;
  if (sms[dev] == 0) {
    int n = 0;
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    sms[dev] = n > 0 ? n : 132;
  }
  return sms[dev];
}

// Called by every thread of a block once it has written its partials: true
// in all threads of the one block, among the `blocks` that share *counter,
// that arrives last. That block may then read the others' partials, with
// L2 loads (__ldcg: L1 is not coherent across SMs), and must set *counter
// back to 0 when done.
__device__ __forceinline__ bool arrive_last(unsigned int* counter, unsigned int blocks) {
  __shared__ bool last;
  __threadfence();  // this thread's partials are visible before the ticket
  __syncthreads();
  if (threadIdx.x == 0 && threadIdx.y == 0) last = atomicAdd(counter, 1u) == blocks - 1;
  __syncthreads();
  return last;
}

}  // namespace hdu
