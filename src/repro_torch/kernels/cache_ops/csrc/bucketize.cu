// Per-shard routing image of the sharded collection, CUDA C++ for sm_90a.
//
// Replaces the TPU kernel repro/kernels/cache_ops/kernel.py::
// bucketize_pallas (body _bucketize_kernel).  Given the owning shard
// owner[0..u) and the shard-local row local[0..u) of each dedup'd lane
// (-1 on padding and replicated lanes), it writes the [S, u] image
//   out[s, i] = local[i]  if owner[i] == s and local[i] >= 0,  else -1.
//
// What bounds it on an H100: bytes.  It reads 8 B and writes 4 * S B per
// lane (10.2 MB at the sharded Criteo path's u = 425 984, S = 4: about
// 3 us at 3.35 TB/s) and does 2 compares and 1 select per output word.
//
// Design.  The Pallas grid runs one program per shard, and every program
// re-reads both inputs.  Here one pass over the lanes does all S rows:
// each thread loads 4 consecutive lanes of owner and local with one 16 B
// load each and writes its 4 output words to each of the S rows with one
// 16 B store per row (scalar stores when u % 4 != 0, where a row's start
// is not 16 B aligned).  The u % 4 tail lanes are written one word at a
// time by the first threads of the grid.  S is a runtime int; a grid-
// stride loop covers any u.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 8;  // 8 CTAs of 256 threads per SM on a 132-SM H100

__device__ __forceinline__ int pick(int o, int l, int s) { return (o == s && l >= 0) ? l : -1; }

__global__ void __launch_bounds__(kThreads)
bucketize_kernel(const int* __restrict__ owner, const int* __restrict__ local, long long u,
                 int num_shards, int* __restrict__ out) {
  const long long n4 = u >> 2;
  const bool aligned = (u & 3) == 0;  // every row starts on a 16 B boundary
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  for (long long i = gid; i < n4; i += stride) {
    const int4 o = __ldg(reinterpret_cast<const int4*>(owner) + i);
    const int4 l = __ldg(reinterpret_cast<const int4*>(local) + i);
    for (int s = 0; s < num_shards; ++s) {
      int4 r;
      r.x = pick(o.x, l.x, s);
      r.y = pick(o.y, l.y, s);
      r.z = pick(o.z, l.z, s);
      r.w = pick(o.w, l.w, s);
      int* row = out + (long long)s * u;
      if (aligned) {
        reinterpret_cast<int4*>(row)[i] = r;
      } else {
        row[4 * i] = r.x;
        row[4 * i + 1] = r.y;
        row[4 * i + 2] = r.z;
        row[4 * i + 3] = r.w;
      }
    }
  }
  if (gid < (u & 3)) {  // the tail lanes, one word per shard each
    const long long i = 4 * n4 + gid;
    const int o = owner[i], l = local[i];
    for (int s = 0; s < num_shards; ++s) out[(long long)s * u + i] = pick(o, l, s);
  }
}

}  // namespace

// owner, local: int32 [u], 16 B aligned; out: int32 [num_shards, u].
// Launches on `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int bucketize(const int* owner, const int* local, long long u, int num_shards,
                         int* out, cudaStream_t stream) {
  if (u <= 0 || num_shards <= 0) return 0;
  long long blocks = ((u >> 2) + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;  // u < 4: the tail threads alone
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  bucketize_kernel<<<(int)blocks, kThreads, 0, stream>>>(owner, local, u, num_shards, out);
  return (int)cudaGetLastError();
}
