// An empty kernel and its plain C entry, CUDA C++ for sm_90a: the floor of
// what one launch through the port's binding (kernels/build.Kernel: the
// entry bound once, one packed struct, the raw stream) costs the host,
// which no wrapper can beat.  Built only by the measurements that read
// that floor, chip_smoke.py's phase 8 and scripts/launch_breakdown.py;
// no module of the port launches it.

#include <cuda_runtime.h>

namespace {

__global__ void empty_kernel(const void*) {}

}  // namespace

// One launch, on `stream`, of a kernel that does nothing with its one
// pointer argument (the struct's one 8-byte field).
extern "C" int empty_launch(const void* const* args, cudaStream_t stream) {
  empty_kernel<<<1, 32, 0, stream>>>(args[0]);
  return static_cast<int>(cudaGetLastError());
}
