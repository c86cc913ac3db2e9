// Victim threshold for bounded top-K eviction, CUDA C++ for sm_90a.
//
// Replaces the TPU kernel repro/kernels/cache_ops/kernel.py::
// victim_threshold_pallas (body _threshold_kernel).  Given int32 eviction
// keys key[0..n) and a count kv, it finds t, the kv-th largest key in the
// order-preserving uint32 domain (u = key ^ 0x80000000), and n_gt, the
// number of keys strictly above t.  Both are integers, so any correct
// algorithm equals the Pallas kernel's 32-round bitwise descent bit for bit.
//
// What bounds it on an H100: bytes, and below them the latency of one
// launch.  The keys are read from HBM once (4 B each: 2.0 MB at the DLRM's
// 506 438 slots, about 0.6 us at 3.35 TB/s; 8 MB at FM's 2 097 152 slots);
// one launch and a handful of barriers take longer than that, so the design
// aims at one launch and few barriers, not at bandwidth.
//
// Design: a radix select in ONE launch.  Each CTA copies its slice of the
// keys into shared memory (as many as fit; the rest is re-read from L2 on
// every pass), then runs 4 passes of 8-bit digits, most significant first.
// A pass histograms the digit of the keys whose higher digits equal the
// prefix chosen so far (shared-memory atomics, aggregated over the lanes of
// a warp that hold the same digit), merges the CTAs' histograms, and every
// CTA scans the same 256 merged bins the same way: the chosen digit d is the
// one where the count from the top reaches the remaining kv.  The keys in
// the bins above d are strictly above t, so n_gt is the sum over the passes
// of those counts and kv shrinks by the same amount; no counting pass
// follows.  The CTAs merge their histograms through global memory: a grid of
// one CTA per SM, launched with cudaLaunchCooperativeKernel (the occupancy
// query confirms the slice fits), adds each CTA's histogram by global atomics
// into a 4 x 256 scratch that CTA 0 zeroes at entry, with grid-wide barriers
// between passes.  At 132 CTAs each holds 15 KB of the DLRM's keys, or 62 KB
// of FM's.  A 16-CTA thread-block cluster merging through distributed
// shared memory needs no grid barrier, but is slower on the H100 on both
// live key vectors: each of its 16 SMs scans 8x the keys of the grid's 132
// (PERF.md).
// The launch makes no memset and no host sync: t and n_gt stay on the card.

#include <algorithm>

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kBins = 256;
constexpr int kPasses = 4;  // 8-bit digits, most significant first
constexpr unsigned kSign = 0x80000000u;
constexpr int kMaxKeyBytes = 200 * 1024;  // dynamic shared memory for keys, per CTA
constexpr int kMaxDevices = 64;

struct Select {     // the running select, the same in every CTA
  unsigned prefix;  // the digits chosen so far
  unsigned kv;      // how many keys of this prefix are still to be taken
  unsigned n_gt;    // keys strictly above every prefix extension chosen so far
};

// One key's digit of `pass` into the CTA's histogram, if its higher digits
// equal `prefix`.  Lanes of a warp that hold the same digit add once.
__device__ __forceinline__ void count_digit(unsigned* hist, unsigned u, bool valid, int pass,
                                            unsigned prefix) {
  const int shift = 24 - 8 * pass;
  const bool match = valid && (pass == 0 || (u >> (shift + 8)) == prefix);
  const unsigned digit = (u >> shift) & 0xffu;
  const unsigned active = __ballot_sync(0xffffffffu, match);
  if (match) {
    const unsigned peers = __match_any_sync(active, digit);
    if ((threadIdx.x & 31) == __ffs(peers) - 1) atomicAdd(hist + digit, __popc(peers));
  }
}

// The CTA's histogram of one pass over its keys: s_keys[0, n_smem) in shared
// memory, then key[lo, hi) from global memory.  Loop bounds are the same on
// every lane of a warp, as the ballots need.
__device__ __forceinline__ void local_hist(unsigned* hist, const unsigned* s_keys, int n_smem,
                                           const int* __restrict__ key, int lo, int hi, int pass,
                                           unsigned prefix) {
  const int warp0 = threadIdx.x & ~31;
  const int lane = threadIdx.x & 31;
  for (int i0 = warp0; i0 < n_smem; i0 += kThreads) {
    const int i = i0 + lane;
    count_digit(hist, i < n_smem ? s_keys[i] : 0u, i < n_smem, pass, prefix);
  }
  for (int i0 = lo + warp0; i0 < hi; i0 += kThreads) {
    const int i = i0 + lane;
    const unsigned u = i < hi ? static_cast<unsigned>(__ldg(key + i)) ^ kSign : 0u;
    count_digit(hist, u, i < hi, pass, prefix);
  }
}

// Every CTA runs this on the same merged histogram (thread b < 256 holds bin
// b), so every CTA picks the same digit: the bin where the count from the
// top reaches the remaining kv.  Updates `sel` in shared memory.
__device__ __forceinline__ void pick_digit(unsigned h, Select* sel, unsigned* warp_tot) {
  const int b = threadIdx.x, lane = b & 31, w = b >> 5;
  const unsigned kv = sel->kv;
  unsigned s = h;  // becomes the inclusive suffix sum: bins >= b
  if (b < kBins) {  // whole warps
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned x = __shfl_down_sync(0xffffffffu, s, o);
      if (lane + o < 32) s += x;
    }
    if (lane == 0) warp_tot[w] = s;
  }
  __syncthreads();  // also: every thread has read sel->kv
  if (b < kBins) {
    for (int v = w + 1; v < kBins / 32; ++v) s += warp_tot[v];
    const unsigned above = s - h;  // keys of this prefix with a larger digit
    if (above < kv && kv <= s) {   // exactly one bin
      sel->prefix = (sel->prefix << 8) | static_cast<unsigned>(b);
      sel->kv = kv - above;
      sel->n_gt += above;
    }
  }
  __syncthreads();
}

// This CTA's slice [lo, hi) of n keys cut into `parts`, and the first
// n_smem of them copied into shared memory as ordered uint32.
__device__ __forceinline__ int load_slice(const int* __restrict__ key, int n, int parts, int part,
                                          int cap, unsigned* s_keys, int* lo, int* hi) {
  const long long per = (static_cast<long long>(n) + parts - 1) / parts;
  *lo = static_cast<int>(min(static_cast<long long>(n), per * part));
  *hi = static_cast<int>(min(static_cast<long long>(n), per * (part + 1)));
  const int n_smem = min(*hi - *lo, cap);
  for (int i = threadIdx.x; i < n_smem; i += kThreads)
    s_keys[i] = static_cast<unsigned>(__ldg(key + *lo + i)) ^ kSign;
  return n_smem;
}

__global__ void __launch_bounds__(kThreads, 1)
threshold_grid(const int* __restrict__ key, int n, unsigned kv, int cap, unsigned* ghist,
               long long* t_out, int* ngt_out) {
  extern __shared__ unsigned s_keys[];
  __shared__ unsigned hist[kBins];
  __shared__ unsigned warp_tot[kWarps];
  __shared__ Select sel;
  cg::grid_group grid = cg::this_grid();
  if (blockIdx.x == 0)
    for (int i = threadIdx.x; i < kPasses * kBins; i += kThreads) ghist[i] = 0u;
  int lo, hi;
  const int n_smem = load_slice(key, n, static_cast<int>(gridDim.x), static_cast<int>(blockIdx.x),
                                cap, s_keys, &lo, &hi);
  if (threadIdx.x == 0) sel = Select{0u, kv, 0u};
  for (int i = threadIdx.x; i < kBins; i += kThreads) hist[i] = 0u;
  __syncthreads();
  for (int pass = 0; pass < kPasses; ++pass) {
    local_hist(hist, s_keys, n_smem, key, lo + n_smem, hi, pass, sel.prefix);
    if (pass == 0) grid.sync();  // CTA 0 has zeroed the global histograms
    __syncthreads();
    unsigned* g = ghist + pass * kBins;
    if (threadIdx.x < kBins) {
      if (hist[threadIdx.x]) atomicAdd(g + threadIdx.x, hist[threadIdx.x]);
      hist[threadIdx.x] = 0u;  // for the next pass
    }
    grid.sync();  // every CTA has added its histogram
    pick_digit(threadIdx.x < kBins ? __ldcg(g + threadIdx.x) : 0u, &sel, warp_tot);
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    *t_out = static_cast<long long>(sel.prefix);
    *ngt_out = static_cast<int>(sel.n_gt);
  }
}

struct DeviceSetup {
  bool ready;
  int sms;
};
DeviceSetup g_setup[kMaxDevices];

// Once per device: the dynamic shared-memory limit above 48 KB and the SM
// count.
cudaError_t setup(int dev, DeviceSetup** out) {
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  DeviceSetup* s = &g_setup[dev];
  if (!s->ready) {
    cudaError_t err = cudaDeviceGetAttribute(&s->sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(threshold_grid, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kMaxKeyBytes);
    if (err != cudaSuccess) return err;
    s->ready = true;
  }
  *out = s;
  return cudaSuccess;
}

}  // namespace

// Plain C entry point (bound with ctypes).  key: int32 [n] on the current
// device; t_out: int64 [1]; ngt_out: int32 [1]; scratch: 4 * 256 uint32 of
// device memory (the histograms; its contents on entry do not matter).
// Enqueues one launch on `stream`, never synchronises, and returns the CUDA
// error of the launch (0 on success).
extern "C" int victim_threshold(const int* key, int n, int kv, long long* t_out, int* ngt_out,
                                void* scratch, cudaStream_t stream) {
  if (n <= 0 || kv <= 0 || kv > n) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  DeviceSetup* s = nullptr;
  if (err == cudaSuccess) err = setup(dev, &s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned ukv = static_cast<unsigned>(kv);
  // one CTA per SM (fewer for small n); the slice decides the shared memory
  int grid = static_cast<int>(std::min(static_cast<long long>(s->sms),
                                       (static_cast<long long>(n) + kThreads - 1) / kThreads));
  const int per = static_cast<int>((static_cast<long long>(n) + grid - 1) / grid);
  int cap = std::min(per, kMaxKeyBytes / 4);
  size_t smem = static_cast<size_t>(cap) * 4;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, threshold_grid, kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  unsigned* ghist = static_cast<unsigned*>(scratch);
  void* args[] = {(void*)&key, (void*)&n, (void*)&ukv, (void*)&cap, (void*)&ghist,
                  (void*)&t_out, (void*)&ngt_out};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(threshold_grid), dim3(grid),
                                    dim3(kThreads), args, smem, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
