// Per-shard routing image of the sharded collection, and the router's
// route + image in one launch, CUDA C++ for sm_90a.
//
// Replaces the TPU kernel repro/kernels/cache_ops/kernel.py::
// bucketize_pallas (body _bucketize_kernel).  Given the owning shard
// owner[0..u) and the shard-local row local[0..u) of each dedup'd lane
// (-1 on padding and replicated lanes), it writes the [S, u] image
//   out[s, i] = local[i]  if owner[i] == s and local[i] >= 0,  else -1.
//
// Two entries share the kernel.  `bucketize` takes owner and local as
// above (the image the JAX package's bucketize_pallas is held against).
// `route_bucketize` takes the dedup'd frequency ranks uniq[0..u) and the
// slab's rank -> (shard, row) tables, and routes each lane itself before
// the image, as the sharded collection's _route does with ~16 torch ops:
//   owner[i] = rank_owner[r], local[i] = rank_local[r]  for r = uniq[i]
//   with r >= 0, r >= rep_k and r < len(rank_owner), else -1 for both
//   (the replicated head r < rep_k, the padding rank 2^31 - 1, and any
//   rank outside the tables, as take_fill's range check);
// it writes the image and, when their pointers are not NULL, owner and
// local too, all int32.  The sharded plan needs the image alone.
//
// What bounds them on an H100: bytes.  bucketize reads 8 B and writes
// 4 * S B per lane (10.2 MB at the sharded Criteo path's u = 425 984,
// S = 4: about 3 us at 3.35 TB/s); route_bucketize reads 4 B of rank and
// two random 4 B table entries and writes 4 * S B a lane, 8 B more with
// owner and local (at most 11.9 MB, 3.6 us, with the image alone; more if
// each random read costs a 32 B sector of the 135 MB tables).  Both do 2
// compares and 1 select per output word.
//
// Design.  The Pallas grid runs one program per shard, and every program
// re-reads both inputs.  Here one pass over the lanes does all S rows:
// each thread takes 4 consecutive lanes, loads owner and local with one
// 16 B load each (or routes 4 ranks, read with one 16 B load when uniq is
// aligned and 4 scalar loads when not, issuing all 8 random table reads
// before it uses any), and writes its 4 output words to each of the S
// rows (and owner / local) with one 16 B store per row (scalar stores
// when u % 4 != 0, where a row's start is not 16 B aligned).  The u % 4
// tail lanes are written one word at a time by the first threads of the
// grid.  S is a runtime int; a grid-stride loop covers any u.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 8;  // 8 CTAs of 256 threads per SM on a 132-SM H100

__device__ __forceinline__ int pick(int o, int l, int s) { return (o == s && l >= 0) ? l : -1; }

// The route of a lane: the rank's tables, or -1 off the routed range.
struct Route {
  const int* uniq;
  const int* rank_owner;
  const int* rank_local;
  long long n_rank;
  long long rep_k;
  bool uniq_vec;  // uniq starts on a 16 B boundary

  __device__ __forceinline__ bool routed(int r) const {
    return r >= 0 && r >= rep_k && r < n_rank;
  }
};

__device__ __forceinline__ void store4(int* row, long long i, bool vec, int a, int b, int c,
                                       int d) {
  if (vec) {
    reinterpret_cast<int4*>(row)[i] = make_int4(a, b, c, d);
  } else {
    row[4 * i] = a;
    row[4 * i + 1] = b;
    row[4 * i + 2] = c;
    row[4 * i + 3] = d;
  }
}

// ROUTE: lanes from uniq through the tables, owner / local written to
// out_owner / out_local unless those are NULL (both or neither); else lanes
// read from owner / local.
template <bool ROUTE>
__global__ void __launch_bounds__(kThreads)
bucketize_kernel(const int* __restrict__ owner, const int* __restrict__ local, Route route,
                 long long u, int num_shards, int* __restrict__ out,
                 int* __restrict__ out_owner, int* __restrict__ out_local) {
  const long long n4 = u >> 2;
  const bool vec = (u & 3) == 0;  // every row starts on a 16 B boundary
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  for (long long i = gid; i < n4; i += stride) {
    int o[4], l[4];
    if (ROUTE) {
      int r[4];
      if (route.uniq_vec) {
        const int4 q = __ldg(reinterpret_cast<const int4*>(route.uniq) + i);
        r[0] = q.x, r[1] = q.y, r[2] = q.z, r[3] = q.w;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) r[j] = __ldg(route.uniq + 4 * i + j);
      }
      bool ok[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) ok[j] = route.routed(r[j]);
#pragma unroll
      for (int j = 0; j < 4; ++j) {  // all 8 table reads in flight before any use
        o[j] = ok[j] ? __ldg(route.rank_owner + r[j]) : -1;
        l[j] = ok[j] ? __ldg(route.rank_local + r[j]) : -1;
      }
      if (out_owner != nullptr) {
        store4(out_owner, i, vec, o[0], o[1], o[2], o[3]);
        store4(out_local, i, vec, l[0], l[1], l[2], l[3]);
      }
    } else {
      const int4 a = __ldg(reinterpret_cast<const int4*>(owner) + i);
      const int4 b = __ldg(reinterpret_cast<const int4*>(local) + i);
      o[0] = a.x, o[1] = a.y, o[2] = a.z, o[3] = a.w;
      l[0] = b.x, l[1] = b.y, l[2] = b.z, l[3] = b.w;
    }
    for (int s = 0; s < num_shards; ++s)
      store4(out + (long long)s * u, i, vec, pick(o[0], l[0], s), pick(o[1], l[1], s),
             pick(o[2], l[2], s), pick(o[3], l[3], s));
  }
  if (gid < (u & 3)) {  // the tail lanes, one word per row each
    const long long i = 4 * n4 + gid;
    int o, l;
    if (ROUTE) {
      const int r = route.uniq[i];
      const bool ok = route.routed(r);
      o = ok ? route.rank_owner[r] : -1;
      l = ok ? route.rank_local[r] : -1;
      if (out_owner != nullptr) {
        out_owner[i] = o;
        out_local[i] = l;
      }
    } else {
      o = owner[i], l = local[i];
    }
    for (int s = 0; s < num_shards; ++s) out[(long long)s * u + i] = pick(o, l, s);
  }
}

int grid(long long u) {
  long long blocks = ((u >> 2) + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;  // u < 4: the tail threads alone
  return static_cast<int>(blocks < kMaxBlocks ? blocks : kMaxBlocks);
}

}  // namespace

// Plain C entry points (bound with ctypes).  Each takes its arguments as
// one struct of 8-byte fields, which the wrapper packs in one call (a
// ctypes call converts each argument on its own, and that cost the host
// more than the launch), and the stream.  Each enqueues one launch on
// `stream`, never synchronises, and returns cudaGetLastError() (0 =
// launched); sizes it cannot take return cudaErrorInvalidValue and launch
// nothing.

struct BucketizeArgs {
  const int* owner;  // int32 [u], 16 B aligned
  const int* local;  // int32 [u], 16 B aligned
  long long u;
  long long num_shards;
  int* out;  // int32 [num_shards, u]
};

struct RouteBucketizeArgs {
  const int* uniq;  // int32 [u], any 4 B alignment
  long long u;
  const int* rank_owner;  // int32 [n_rank]
  const int* rank_local;  // int32 [n_rank]
  long long n_rank;
  long long rep_k;
  long long num_shards;
  int* out;        // int32 [num_shards, u] image, 16 B aligned
  int* out_owner;  // int32 [u], 16 B aligned, or NULL (with out_local)
  int* out_local;  // int32 [u], 16 B aligned, or NULL (with out_owner)
};

extern "C" int bucketize(const BucketizeArgs* a, cudaStream_t stream) {
  if (a->u <= 0 || a->num_shards <= 0 || a->num_shards > (1 << 30) || a->owner == nullptr ||
      a->local == nullptr || a->out == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  bucketize_kernel<false><<<grid(a->u), kThreads, 0, stream>>>(
      a->owner, a->local, Route{}, a->u, static_cast<int>(a->num_shards), a->out, nullptr,
      nullptr);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int route_bucketize(const RouteBucketizeArgs* a, cudaStream_t stream) {
  if (a->u <= 0 || a->num_shards <= 0 || a->num_shards > (1 << 30) || a->n_rank < 0 ||
      a->uniq == nullptr || a->out == nullptr ||
      (a->out_owner == nullptr) != (a->out_local == nullptr) ||
      (a->n_rank > 0 && (a->rank_owner == nullptr || a->rank_local == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Route route{a->uniq, a->rank_owner, a->rank_local, a->n_rank, a->rep_k,
                    reinterpret_cast<uintptr_t>(a->uniq) % 16 == 0};
  bucketize_kernel<true><<<grid(a->u), kThreads, 0, stream>>>(
      nullptr, nullptr, route, a->u, static_cast<int>(a->num_shards), a->out, a->out_owner,
      a->out_local);
  return static_cast<int>(cudaGetLastError());
}
