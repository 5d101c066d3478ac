// Device time stamps for the port's tracer (`utils/profiling.py`).
//
// Replaces no TPU kernel: the JAX package traces with the XLA profiler,
// whose device events carry the ops that launched them. A replayed CUDA
// graph's kernels carry none, so the tracer puts these one-thread kernels
// between the forward's stages; they are captured into the graph like any
// other kernel and replayed with it. Each launch reads the device's
// nanosecond clock (%globaltimer) and writes it, with its mark's id, into
// the next slot of a ring in device memory. A graph's arguments are fixed
// at capture, so the slot comes from a device counter (atomicAdd): every
// replay writes new slots, in the order the stream runs the stamps. Bound:
// one atomic and 12 bytes written, a few microseconds of launch and none
// of bandwidth.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__global__ void stamp_kernel(unsigned long long* count, long long* times, int* ids,
                             unsigned long long capacity, int mark) {
  const unsigned long long t = globaltimer();
  const unsigned long long slot = atomicAdd(count, 1ULL);
  if (slot < capacity) {  // a full ring drops the stamp; `count` still counts it
    times[slot] = static_cast<long long>(t);
    ids[slot] = mark;
  }
}

}  // namespace

// One stamp on `stream` (capturable). Returns the launch's cudaError.
extern "C" int rnnpose_stamp(void* count, void* times, void* ids, unsigned long long capacity,
                             int mark, void* stream) {
  stamp_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned long long*>(count), static_cast<long long*>(times),
      static_cast<int*>(ids), capacity, mark);
  return static_cast<int>(cudaGetLastError());
}

