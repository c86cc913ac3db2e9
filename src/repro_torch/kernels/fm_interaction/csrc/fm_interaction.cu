// FM pairwise interaction, CUDA C++ for sm_90a.
//
// Replaces the TPU kernel repro/kernels/fm_interaction/kernel.py::
// fm_interaction_pallas (body _kernel).  For each sample b of v [B, F, D]
// (fp32 or bf16) it writes
//   out[b] = 0.5 * sum_d ((sum_f v[b,f,d])^2 - sum_f v[b,f,d]^2),
// the sum over field pairs i < j of <v_i, v_j> by the sum-square trick,
// accumulated in fp32 and stored in v's dtype.
//
// What bounds it on an H100: bytes.  It reads v once (B*F*D elements) and
// writes B values; the ~4 flops per element are far below the card's rate.
// At FM serving (B 65 536, F 40, D 10, fp32) that is 104.9 MB of useful
// reads, 0.031 ms at 3.35 TB/s.
//
// Design.  The TPU kernel loads a [block_b, F, D] tile into VMEM per grid
// step.  Here a warp owns 32 / L samples at a time, L = the power of two
// >= D (at most 32): lane c of a sample's L-lane group accumulates
// sum_f v and sum_f v^2 for columns d = c, c + L, ... in registers (one
// pass over F, the F loop unrolled for independent loads), forms
// s^2 - sq, and the group sums over d with xor shuffles that stay inside
// the group.  No shared memory, no atomics, one write per sample.  At
// D = 10 a warp covers two samples with 20 of its lanes.  v may be a
// strided view: the kernel takes the B and F strides (in elements) and
// needs a unit stride on d only, so FM's [..., :D] slice of its
// [B, F, D+1] rows is read in place, the linear-weight column skipped.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr long long kMaxBlocks = 132LL * 8 * 4;  // 4 waves of full occupancy

enum Dtype { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <typename T, int L>
__global__ void __launch_bounds__(kThreads)
fm_kernel(const T* __restrict__ v, long long B, int F, int D, long long sb, long long sf,
          T* __restrict__ out) {
  constexpr int kPerWarp = 32 / L;  // samples per warp
  const int lane = threadIdx.x & 31;
  const int sub = lane / L;
  const int c = lane % L;
  const long long warp = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  const long long step = static_cast<long long>(gridDim.x) * kWarps * kPerWarp;
  // the loop bound is the same for every lane of the warp: the shuffles
  // below always run on the full warp
  for (long long b0 = warp * kPerWarp; b0 < B; b0 += step) {
    const long long b = b0 + sub;
    float t = 0.f;
    if (b < B) {
      const T* row = v + b * sb;
      for (int d = c; d < D; d += L) {
        float s = 0.f, sq = 0.f;
#pragma unroll 4
        for (int f = 0; f < F; ++f) {
          const float x = load(row + f * sf + d);
          s += x;
          sq += x * x;
        }
        t += s * s - sq;
      }
    }
#pragma unroll
    for (int o = L / 2; o > 0; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
    if (c == 0 && b < B) store(out + b, 0.5f * t);
  }
}

template <typename T, int L>
cudaError_t launch_l(const void* v, long long B, int F, int D, long long sb, long long sf,
                     void* out, cudaStream_t stream) {
  const long long warps = (B + 32 / L - 1) / (32 / L);
  long long blocks = (warps + kWarps - 1) / kWarps;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  fm_kernel<T, L><<<static_cast<int>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(v), B, F, D, sb, sf, static_cast<T*>(out));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* v, long long B, int F, int D, long long sb, long long sf,
                   void* out, cudaStream_t stream) {
  if (D <= 1) return launch_l<T, 1>(v, B, F, D, sb, sf, out, stream);
  if (D <= 2) return launch_l<T, 2>(v, B, F, D, sb, sf, out, stream);
  if (D <= 4) return launch_l<T, 4>(v, B, F, D, sb, sf, out, stream);
  if (D <= 8) return launch_l<T, 8>(v, B, F, D, sb, sf, out, stream);
  if (D <= 16) return launch_l<T, 16>(v, B, F, D, sb, sf, out, stream);
  return launch_l<T, 32>(v, B, F, D, sb, sf, out, stream);
}

}  // namespace

// Plain C entry point (bound with ctypes).  v: [B, F, D] on the card with
// element strides (sb, sf, 1); dtype 0 = fp32, 1 = bf16; out: [B] of the
// same dtype, contiguous.  Enqueues one launch on `stream`, never
// synchronises, and returns the CUDA error of the launch (0 on success).
extern "C" int fm_interaction(const void* v, long long B, int F, int D, long long sb,
                              long long sf, int dtype, void* out, cudaStream_t stream) {
  if (B <= 0 || F < 0 || D <= 0 || (dtype != kF32 && dtype != kBF16))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = dtype == kF32
                              ? launch<float>(v, B, F, D, sb, sf, out, stream)
                              : launch<__nv_bfloat16>(v, B, F, D, sb, sf, out, stream);
  return static_cast<int>(err);
}
