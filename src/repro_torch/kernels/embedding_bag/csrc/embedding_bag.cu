// Embedding bag (fused gather + segment sum / mean), CUDA C++ for sm_90a.
//
// Replaces the TPU kernel repro/kernels/embedding_bag/kernel.py::
// embedding_bag_pallas (body _kernel) together with its wrapper's densify
// and mean combiner (repro/kernels/embedding_bag/ops.py).  Bag s of a
// feature owns the lanes of the feature's flat id vector whose segment id is
// s (segment ids sorted within the feature, as in the reference).  Of those, the first max_bag lanes by position are
// kept, as densify keeps them (a -1 lane inside them still uses a
// position).  For each bag it writes
//   out[s] = sum over kept lanes with 0 <= id < V of table[id]
// and, with the mean combiner, divides by the number of kept lanes with
// id >= 0 (at least 1).  A negative id is padding; an id >= V adds a zero
// row but counts for the mean, as embedding_bag_ref treats it.  It
// accumulates in the table's dtype, lane by lane in bag order, as the
// Pallas body does: fp32 in fp32; bf16 as an fp32 register rounded to bf16
// after every add (what a bf16 add is), the mean as a division by the
// count rounded to bf16.  (Accumulating bf16 bags in fp32 moved 5 of 7168
// outputs of the reference's (128, 1024, 100, 7) sweep case by up to 0.094,
// past its 3e-2 tolerance.)
//
// What bounds it on an H100: bytes.  It reads each kept in-range lane's row
// once (plus the ids and segment ids) and writes [F, S, D]; one add per
// element read.  At the DLRM's bag step (26 features of 4 096 bags of <= 4
// lanes, 425 984 lanes, D 128, fp32) that is ~136 MB of kept rows (fewer
// distinct ones: a repeat comes from L2) and 54.5 MB written.
//
// Design.  The TPU kernel revisits one output block over a sequential grid
// axis (one bag lane per step).  Blocks on Hopper run in no order, so here
// one warp owns one (feature, bag, D-chunk) unit and loops over the bag's
// lanes itself, keeping the sum in registers: no atomics, no [S, max_bag]
// id matrix.  One launch covers every feature of a call (the concatenated
// flat ids and segment ids of F features, feature f owning the lanes
// [off[f], off[f+1]); the offsets travel in the kernel's parameters), so a
// pool call over a slab's 26 features is one launch and not 26.  The warp
// finds its bag's lanes itself: lower_bound(s) and lower_bound(s + 1) in its
// feature's own lane range of the sorted segment ids, by a 32-way search
// (every lane probes one position, a ballot picks the sub-range: 3 rounds at
// 16 384 lanes), the end probed first in the 32 lanes after the start (a
// short bag ends there).  Features are never folded into one id space by
// adding f * S to the segment ids: a lane outside [0, S) belongs to no bag,
// and an offset would move a -1 lane of feature f into feature f-1's last
// bag.  The warp loads up to 32 of the bag's ids at once (one coalesced
// load) and broadcasts them with shuffles; each lane adds a float4 (fp32)
// or four bf16 values (8 B) of the row per lane, so a chunk is 128 columns;
// a scalar path (one column per lane) covers D % 4 != 0 and unaligned
// views.  The table may have a row stride (`ld`) but needs a unit column
// stride.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr long long kMaxBlocks = 132LL * 8 * 4;  // 4 waves of full occupancy
constexpr int kMaxFeatures = 256;  // features per launch: their offsets are kernel parameters

struct LaneOffsets {
  int at[kMaxFeatures + 1];
};

enum Dtype { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float load1(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}
__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// an fp32 value rounded to the table's dtype and back
__device__ __forceinline__ float keep(float x, const float*) { return x; }
__device__ __forceinline__ float keep(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));  // four bf16
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<const unsigned int*>(&a);
  u.y = *reinterpret_cast<const unsigned int*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}

// The first index in [lo, hi) whose segment id is >= key (hi if none), found
// by the whole warp: each round every lane probes one of 32 evenly spaced
// positions and a ballot keeps the sub-range that holds the answer, which
// stays in [lo, hi] (positions >= hi count as >= key).  Same on every lane.
__device__ __forceinline__ int lower_bound_warp(const int* __restrict__ seg, int lo, int hi,
                                                int key, int lane) {
  while (hi - lo > 32) {
    const int step = (hi - lo + 31) >> 5;
    const int p = lo + (lane + 1) * step - 1;  // lane 31's probe is >= hi - 1
    const unsigned m = __ballot_sync(0xffffffffu, p >= hi || __ldg(seg + p) >= key);
    const int j = m ? __ffs(m) - 1 : 32;  // the answer is in (probe j-1, probe j]
    const int next_hi = j < 32 ? min(lo + (j + 1) * step - 1, hi) : hi;
    lo += j * step;
    hi = next_hi;
  }
  const int p = lo + lane;
  const unsigned m = __ballot_sync(0xffffffffu, p >= hi || __ldg(seg + p) >= key);
  return m ? lo + __ffs(m) - 1 : hi;
}

// lower_bound_warp for an answer that is usually within 32 lanes of lo (the
// end of a short bag): one coalesced probe of those lanes first.
__device__ __forceinline__ int lower_bound_near(const int* __restrict__ seg, int lo, int hi,
                                                int key, int lane) {
  const int p = lo + lane;
  const unsigned m = __ballot_sync(0xffffffffu, p >= hi || __ldg(seg + p) >= key);
  return m ? lo + __ffs(m) - 1 : lower_bound_warp(seg, lo + 32, hi, key, lane);
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
bag_kernel(const T* __restrict__ table, long long V, int D, long long ld,
           const int* __restrict__ ids, const int* __restrict__ seg,
           const __grid_constant__ LaneOffsets off, int F, int S, int max_bag, bool mean,
           int chunks, T* __restrict__ out) {
  constexpr int kW = VEC ? 4 : 1;  // columns per lane
  const int lane = threadIdx.x & 31;
  const long long per_feature = static_cast<long long>(S) * chunks;
  const long long units = F * per_feature;
  const long long stride = static_cast<long long>(gridDim.x) * kWarps;
  for (long long u = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
       u < units; u += stride) {  // u is the same for every lane of the warp
    const int f = static_cast<int>(u / per_feature);
    const long long r = u - f * per_feature;
    const int s = static_cast<int>(r / chunks);
    const int col = static_cast<int>(r % chunks) * 32 * kW + lane * kW;
    const bool live = col < D;
    const int f_hi = off.at[f + 1];
    const int start = lower_bound_warp(seg, off.at[f], f_hi, s, lane);
    const int n = min(lower_bound_near(seg, start, f_hi, s + 1, lane) - start, max_bag);
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    int cnt = 0;
    for (int t0 = 0; t0 < n; t0 += 32) {
      const int mine = t0 + lane < n ? __ldg(ids + start + t0 + lane) : -1;
      const int m = min(32, n - t0);
#pragma unroll 4
      for (int j = 0; j < m; ++j) {
        const int id = __shfl_sync(0xffffffffu, mine, j);  // the same on every lane
        if (id < 0) continue;
        ++cnt;
        if (id >= V || !live) continue;
        const T* row = table + static_cast<long long>(id) * ld + col;
        if (VEC) {
          const float4 x = load4(row);
          acc.x = keep(acc.x + x.x, table);
          acc.y = keep(acc.y + x.y, table);
          acc.z = keep(acc.z + x.z, table);
          acc.w = keep(acc.w + x.w, table);
        } else {
          acc.x = keep(acc.x + load1(row), table);
        }
      }
    }
    if (!live) continue;
    if (mean) {
      const float c = keep(static_cast<float>(cnt > 1 ? cnt : 1), table);
      acc.x /= c;
      acc.y /= c;
      acc.z /= c;
      acc.w /= c;
    }
    T* o = out + (static_cast<long long>(f) * S + s) * D + col;
    if (VEC)
      store4(o, acc);
    else
      store1(o, acc.x);
  }
}

template <typename T>
cudaError_t launch(const void* table, long long V, int D, long long ld, const int* ids,
                   const int* seg, const LaneOffsets& off, int F, int S, int max_bag, bool mean,
                   void* out, cudaStream_t stream) {
  const uintptr_t align = sizeof(T) * 4;
  const bool vec = D % 4 == 0 && ld % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(table) % align == 0 &&
                   reinterpret_cast<uintptr_t>(out) % align == 0;
  const int chunks = vec ? (D + 127) / 128 : (D + 31) / 32;
  const long long units = static_cast<long long>(F) * S * chunks;
  long long blocks = (units + kWarps - 1) / kWarps;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  const T* tab = static_cast<const T*>(table);
  T* o = static_cast<T*>(out);
  if (vec)
    bag_kernel<T, true><<<static_cast<int>(blocks), kThreads, 0, stream>>>(
        tab, V, D, ld, ids, seg, off, F, S, max_bag, mean, chunks, o);
  else
    bag_kernel<T, false><<<static_cast<int>(blocks), kThreads, 0, stream>>>(
        tab, V, D, ld, ids, seg, off, F, S, max_bag, mean, chunks, o);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes).  table: [V, D] on the card with
// row stride ld (elements) and unit column stride, dtype 0 = fp32,
// 1 = bf16; ids, seg: int32 [N], the F features' flat ids and segment ids
// concatenated; lane_offsets: F + 1 host ints, feature f = lanes
// [lane_offsets[f], lane_offsets[f+1]), its segment ids sorted; S bags per
// feature; max_bag > 0 lanes kept per bag by position; mean: 0 = sum,
// 1 = mean; out: [F, S, D] contiguous, the table's dtype.  Enqueues one
// launch per kMaxFeatures features on `stream` (one for F <= 256), never
// synchronises, and returns the first CUDA error (0 on success).
extern "C" int embedding_bag_multi(const void* table, long long V, int D, long long ld,
                                   int dtype, const int* ids, const int* seg,
                                   const int* lane_offsets, int F, int S, int max_bag, int mean,
                                   void* out, cudaStream_t stream) {
  if (F <= 0 || S <= 0 || D <= 0 || V < 0 || max_bag <= 0 || (dtype != kF32 && dtype != kBF16))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t item = dtype == kF32 ? 4 : 2;
  for (int f0 = 0; f0 < F; f0 += kMaxFeatures) {
    const int nf = F - f0 < kMaxFeatures ? F - f0 : kMaxFeatures;
    LaneOffsets off;
    for (int f = 0; f <= nf; ++f) off.at[f] = lane_offsets[f0 + f];
    void* o = static_cast<char*>(out) + static_cast<size_t>(f0) * S * D * item;
    const cudaError_t err =
        dtype == kF32
            ? launch<float>(table, V, D, ld, ids, seg, off, nf, S, max_bag, mean != 0, o, stream)
            : launch<__nv_bfloat16>(table, V, D, ld, ids, seg, off, nf, S, max_bag, mean != 0, o,
                                    stream);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}
