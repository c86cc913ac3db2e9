// Tiered-arena gather + decode, CUDA C++ for sm_90a.
//
// Replaces the TPU kernel repro/kernels/cache_ops/kernel.py::
// gather_decode_pallas (body _gather_decode_kernel).  The arena keeps its
// hottest slots [0, H) as fp32 rows (`head`, [H, D]) and the colder slots
// [H, H+T) encoded (`tail`, [T, D]): fp16, or row-wise int8 with a [T, 2]
// fp32 (scale, zero_point) sideband.  For each lane i of `slots` it writes
// out[i] = the decoded row of slot slots[i]:
//   0 <= s < H      head[s] as is;
//   H <= s < H+T    fp16: the upcast of tail[s-H];
//                   int8: q * scale + zp, rounded after the multiply and
//                   again after the add (never one fused multiply-add, so
//                   the result is bitwise the two eager torch ops that
//                   decode the arena for training);
//   otherwise       a zero row.
//
// What bounds it on an H100: bytes.  Per lane it reads a 4 B slot and one
// row (512 B of fp32 head, or 128 B of int8 payload + 8 B of sideband at
// D = 128) and writes 512 B; at the card's 3.35 TB/s a flush of the paper's
// 506 438-slot arena (377.8 MB) needs 0.113 ms, one step's writeback of
// ~25 k lanes about 5 us.  It does no arithmetic worth counting.
//
// Design.  The TPU kernel streams one row per sequential grid step through
// VMEM.  Here one warp owns one output row at a time (8 warps per block,
// grid-stride over rows): the 32 lanes read the slot once (a broadcast
// load), then move the row as 16 B stores — a float4 of the head row, four
// halves (8 B) or a char4 (4 B) of the tail row decoded in registers.  The
// (scale, zp) pair is read once per row.  Rows, not lanes, are the unit of
// parallelism, so a gather of a few thousand rows still spreads over every
// SM.  A scalar path covers D % 4 != 0 and unaligned pointers.

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / 32;  // one warp per row
constexpr long long kMaxBlocks = 132LL * 8 * 4;  // 4 waves of full occupancy

enum Codec { kFp16 = 0, kInt8 = 1 };

template <int CODEC>
__device__ __forceinline__ float decode1(const void* trow, int c, float scale, float zp) {
  if (CODEC == kFp16) return __half2float(static_cast<const __half*>(trow)[c]);
  const float q = static_cast<float>(static_cast<const int8_t*>(trow)[c]);
  return __fadd_rn(__fmul_rn(q, scale), zp);
}

template <int CODEC>
__device__ __forceinline__ float4 decode4(const void* trow, int c4, float scale, float zp) {
  float4 v;
  if (CODEC == kFp16) {
    const uint2 u = __ldg(static_cast<const uint2*>(trow) + c4);  // four halves
    const float2 a = __half22float2(*reinterpret_cast<const __half2*>(&u.x));
    const float2 b = __half22float2(*reinterpret_cast<const __half2*>(&u.y));
    v = make_float4(a.x, a.y, b.x, b.y);
  } else {
    const char4 q = __ldg(static_cast<const char4*>(trow) + c4);
    v.x = __fadd_rn(__fmul_rn(static_cast<float>(q.x), scale), zp);
    v.y = __fadd_rn(__fmul_rn(static_cast<float>(q.y), scale), zp);
    v.z = __fadd_rn(__fmul_rn(static_cast<float>(q.z), scale), zp);
    v.w = __fadd_rn(__fmul_rn(static_cast<float>(q.w), scale), zp);
  }
  return v;
}

template <int CODEC, bool VEC>
__global__ void __launch_bounds__(kThreads)
gather_decode_kernel(const float* __restrict__ head, long long H,
                     const void* __restrict__ tail, long long T,
                     const float* __restrict__ side, const int* __restrict__ slots,
                     long long K, int D, float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long stride = static_cast<long long>(gridDim.x) * kRowsPerBlock;
  const int payload_bytes = CODEC == kFp16 ? 2 : 1;
  for (long long r = static_cast<long long>(blockIdx.x) * kRowsPerBlock + (threadIdx.x >> 5);
       r < K; r += stride) {
    const long long s = __ldg(slots + r);
    float* o = out + r * D;
    if (s < 0 || s >= H + T) {  // padding / out of range: a zero row
      if (VEC) {
        for (int c = lane; c < D / 4; c += 32)
          reinterpret_cast<float4*>(o)[c] = make_float4(0.f, 0.f, 0.f, 0.f);
      } else {
        for (int c = lane; c < D; c += 32) o[c] = 0.f;
      }
    } else if (s < H) {  // fp32 head row
      const float* hrow = head + s * D;
      if (VEC) {
        for (int c = lane; c < D / 4; c += 32)
          reinterpret_cast<float4*>(o)[c] = __ldg(reinterpret_cast<const float4*>(hrow) + c);
      } else {
        for (int c = lane; c < D; c += 32) o[c] = __ldg(hrow + c);
      }
    } else {  // encoded tail row
      const long long t = s - H;
      const void* trow = static_cast<const char*>(tail) + t * D * payload_bytes;
      float scale = 0.f, zp = 0.f;
      if (CODEC == kInt8) {
        scale = __ldg(side + 2 * t);
        zp = __ldg(side + 2 * t + 1);
      }
      if (VEC) {
        for (int c = lane; c < D / 4; c += 32)
          reinterpret_cast<float4*>(o)[c] = decode4<CODEC>(trow, c, scale, zp);
      } else {
        for (int c = lane; c < D; c += 32) o[c] = decode1<CODEC>(trow, c, scale, zp);
      }
    }
  }
}

template <int CODEC>
cudaError_t launch(bool vec, int blocks, cudaStream_t stream, const float* head, long long H,
                   const void* tail, long long T, const float* side, const int* slots,
                   long long K, int D, float* out) {
  if (vec)
    gather_decode_kernel<CODEC, true><<<blocks, kThreads, 0, stream>>>(
        head, H, tail, T, side, slots, K, D, out);
  else
    gather_decode_kernel<CODEC, false><<<blocks, kThreads, 0, stream>>>(
        head, H, tail, T, side, slots, K, D, out);
  return cudaGetLastError();
}

bool aligned(const void* p, uintptr_t n) { return reinterpret_cast<uintptr_t>(p) % n == 0; }

}  // namespace

// Plain C entry point (bound with ctypes).  head: fp32 [H, D]; tail: fp16 or
// int8 [T, D]; sideband: fp32 [T, 2] for int8, NULL for fp16; slots: int32
// [K]; out: fp32 [K, D]; all contiguous on the card.  codec: 0 = fp16,
// 1 = int8.  Enqueues one launch on `stream`, never synchronises, and
// returns the CUDA error of the launch (0 on success).
extern "C" int gather_decode(const float* head, long long H, const void* tail, long long T,
                             const float* sideband, const int* slots, long long K, int D,
                             int codec, float* out, cudaStream_t stream) {
  if (K <= 0 || D <= 0 || H < 0 || T < 0 || (codec != kFp16 && codec != kInt8) ||
      (codec == kInt8 && T > 0 && sideband == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = D % 4 == 0 && aligned(head, 16) && aligned(out, 16) &&
                   aligned(tail, codec == kFp16 ? 8 : 4);
  long long blocks = (K + kRowsPerBlock - 1) / kRowsPerBlock;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  const cudaError_t err =
      codec == kFp16
          ? launch<kFp16>(vec, static_cast<int>(blocks), stream, head, H, tail, T, sideband,
                          slots, K, D, out)
          : launch<kInt8>(vec, static_cast<int>(blocks), stream, head, H, tail, T, sideband,
                          slots, K, D, out);
  return static_cast<int>(err);
}
