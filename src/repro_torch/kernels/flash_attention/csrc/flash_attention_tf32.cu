// Flash attention forward in fp32 on Hopper's tensor cores by a 3xTF32
// split, CUDA C++ for sm_90a.  The fp32 route of the port's flash attention
// for heads of up to 128 columns; wider fp32 heads take the SIMT kernel in
// flash_attention.cu, and bf16 inputs the kernel in flash_attention_sm90.cu.
//
// Replaces the TPU kernel repro/kernels/flash_attention/kernel.py::
// flash_attention_pallas (body _kernel).  For each batch b and query head h
// (KV head h / g, g = Hq / Hkv) it writes
//   o[b, h] = softmax(mask(q[b, h] * scale @ k[b, h/g]^T)) @ v[b, h/g]
// with scale = 1/sqrt(D) applied to q in fp32 before the product, the causal
// mask (q_pos >= k_pos) and the optional sliding window (q_pos - k_pos <
// window).  The softmax is the reference's online softmax in fp32, as the
// SIMT kernel has it: masked scores are the finite sentinel -1e30 (not
// -inf), the running max starts at -1e30, p = expf(s - max), keys past Sk
// get no weight (-inf, p = 0), the running sum is l * corr + sum(p), the
// accumulator acc * corr + p @ v, and the output acc / max(l, 1e-30).
//
// What bounds it on an H100: operations.  At the fp32 SmolLM-360M's prefill
// (B 2, S 4096, 15 query heads over 5 KV heads, d 64, causal) one launch
// does 6.444e10 FLOP over the live (q, k) pairs: 0.9618 ms at the SIMT
// units' 67 TFLOP/s fp32.  This kernel issues three TF32 products for each
// fp32 one, 1.933e11 TF32 FLOP: 0.390 ms at the tensor cores' 495 TFLOP/s.
//
// Numerics: every operand is split, x = hi + lo with hi = tf32(x) and lo =
// tf32(x - hi) (cvt.rna: round to nearest, ties away), and each product is
// issued as hi*lo + lo*hi + hi*hi into one fp32 accumulator, the small terms
// first.  A product of two TF32 values is exact in fp32; the dropped lo*lo
// term and the rounding of lo leave about 2^-22 of each product.  One TF32
// rounding of each operand (10-bit mantissa) misses the port's bound of
// 2e-5 (1 + |o|).  Emulated on the CPU (tests/test_torch_flash_tf32.py,
// `python tests/test_torch_flash_tf32.py`), with randn inputs, against an
// fp64 oracle, the tensor cores' fp32 sums modelled as rounding toward zero
// after each k-step (elements over the bound, and the worst excess):
//   case (B 1, causal)                 one TF32 rounding         3xTF32 split
//   S 512, d 64, 4/2 heads              78 608 (1.04e-3)         0 (-1.96e-5)
//   S 1024, d 64, 15/5 heads           486 643 (1.01e-3)         0 (-1.96e-5)
//   S 4096, d 64, 2/1 heads            121 299 (7.53e-4)         0 (-1.97e-5)
//   S 2048, d 128, 2/1, window 1024    209 411 (1.03e-3)         0 (-1.95e-5)
//   S 256, d 16, 6/3 heads, B 2         33 429 (1.03e-3)         0 (-1.99e-5)
// P @ V takes each tile's product into a fresh accumulator and folds it into
// the running one as acc * corr + pv by one FMA, in the reference's form,
// so the tensor cores' truncating sums never run over more than one tile.
//
// Design.  One CTA of two warpgroups (256 threads) owns one (b, h, 128-row
// q tile) at d <= 64; at 64 < d <= 128 one warpgroup owns a 64-row tile.
// Warpgroup w computes rows 64w..64w+63.  The CTA loops over the live
// 64-key tiles:
//   * S = (q scale) K^T by wgmma m64n64k8 .tf32 (fp32 accumulators), three
//     issues per 8-column slice of the head (Q_hi K_lo, Q_lo K_hi, then
//     Q_hi K_hi), A = the Q tile and B = the K tile [keys, d], both K-major
//     in shared memory (wgmma takes .tf32 operands K-major only);
//   * O = P V by wgmma m64n64k8 with A = P in registers and B = V^T [d,
//     keys] in shared memory, again three issues per 8 keys (p_lo V_hi,
//     p_hi V_lo, p_hi V_hi).  The S accumulator holds keys {2t, 2t+1} of
//     each group of 8 in thread t of a quad, while a .tf32 A fragment takes
//     keys {t, t+4}; instead of shuffling p, V^T stores each group of 8 keys
//     permuted (key 2i at position i, key 2i+1 at position 4 + i), so the
//     accumulator's registers are P's A fragments as they stand, and the
//     sum over keys is the same sum;
//   * a split pass (flash_tf32x3_split_kernel, one CTA per 64-key tile of
//     each KV head, launched first by the same call) reads k and v through
//     their four strides, splits them and writes each tile as a stage of
//     the attention kernel's shared memory holds it: k_hi, k_lo, V^T_hi and
//     V^T_lo in 32-column atoms of 128-byte rows with the 128-byte swizzle
//     that wgmma's descriptors read, keys past Sk and columns past D zero.
//     So a KV tile is split once, not once per query head and q tile, and
//     the attention kernel moves a stage by one bulk copy (cp.async.bulk on
//     an mbarrier) that thread 0 starts, with no SIMT work and no registers
//     held for it.  At the SmolLM shape the pass reads 21 MB and writes
//     42 MB, ~0.02 ms at 3.35 TB/s; it takes ~0.05 ms, its V^T writes
//     16 bytes to a row;
//   * q is read through its strides once per CTA, scaled, split and stored
//     the same way; the head pads with zeros to 64 or 128 columns;
//   * at d <= 64 two stages (Q 64 KB, 64 KB a stage: 193 KB), tile j + 1's
//     copy in flight while tile j's products run; at d <= 128 (Q 64 KB, a
//     stage 128 KB) one stage, refilled after the tile's products.  A stage
//     is refilled by whichever warpgroup releases it last (a counter in
//     shared memory), so no barrier of the whole CTA holds the two
//     warpgroups in step and one's softmax runs under the other's products;
//   * tiles with no live (q, k) pair are skipped: causal tiles past the
//     diagonal end the loop, a window starts it at the first tile that
//     reaches into it; only tiles that cross the diagonal, the window's
//     edge or Sk pay for the mask; q tiles go heaviest first.  Both
//     warpgroups run every tile of the CTA's range, also the one causal
//     tile that is dead for the lower 64 rows: a branch around the
//     products made ptxas serialise the wgmma pipeline;
//   * o is written through its strides, so the model's [B, S, H, D]
//     tensors pass as [B, H, S, D] views and nothing is copied.
//
// On an H100 at 700 W (chip_smoke.py) this runs the fp32 SmolLM layer at
// ~0.78 ms, 0.05 ms of it the split pass: ~4x the SIMT kernel's speed, 1.2x
// faster than the fp32 units' bound, 2x the three TF32 products' floor.
// What holds it there (scripts/flash_tf32_breakdown.py cuts one part at a
// time): the two extra TF32 products (~0.3 ms; one product alone runs in
// ~0.47 ms) and expf (~0.07 ms); the products and the softmax overlap only
// across the two warpgroups.  Keeping Q_hi in registers for S did not help.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBK = 64;            // keys per tile
constexpr float kMasked = -1e30f;  // the reference's mask sentinel

struct Strides {
  long long b, h, s, d;
};

// The tile shapes of a head of 64 NA padded columns: NW warpgroups, BQ q
// rows, the shared-memory plan and the load units each thread takes.
template <int NA>
struct Shape {
  static constexpr int kNW = NA == 1 ? 2 : 1;
  static constexpr int kThreads = 128 * kNW;
  static constexpr int kBQ = 64 * kNW;
  static constexpr int kDP = 64 * NA;
  static constexpr int kStages = NA == 1 ? 2 : 1;  // K/V stages in shared memory
  static constexpr uint32_t kQBytes = kBQ * kDP * 4;  // one of q_hi, q_lo
  static constexpr uint32_t kTBytes = kBK * kDP * 4;  // one of k_hi, k_lo, vt_hi, vt_lo
  static constexpr uint32_t kStageBytes = 4 * kTBytes;
  static constexpr int kSmem = 2 * kQBytes + kStages * kStageBytes + 1024;
  static constexpr int kQuadsLg = NA == 1 ? 4 : 5;             // log2(kDP / 4)
  static constexpr int kKUnits = kBK * kDP / 4 / kThreads;    // (key, 4 columns)
  static constexpr int kVUnits = kBK / 8 * kDP / kThreads;    // (8 keys, 1 column)
  static constexpr int kQUnits = kBQ * kDP / 4 / kThreads;    // (row, 4 columns)
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of byte column cb of row r in a tile of `rows` rows stored as
// atoms of [rows][128 B] (32 fp32 columns), each 128-byte swizzled (16-byte
// chunk c of row r sits at chunk c ^ (r % 8)); atoms start 1024-byte aligned.
__device__ __forceinline__ uint32_t swizzled(int rows, int r, int cb) {
  return (cb >> 7) * rows * 128 + r * 128 + ((((cb >> 4) & 7) ^ (r & 7)) << 4) + (cb & 15);
}

// wgmma shared-memory descriptor, 128-byte swizzle, K-major: start address
// and stride byte offset (8 rows of 128 B) in 16-byte units.
__device__ __forceinline__ uint64_t descriptor(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1024 >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Orders the compiler's uses of accumulator registers after a wgmma wait.
__device__ __forceinline__ void fence_regs(float (&r)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
// Makes this thread's shared-memory stores visible to wgmma (the async proxy).
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

#define WG_D4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define WG_D32                                                                     \
  WG_D4(0), WG_D4(4), WG_D4(8), WG_D4(12), WG_D4(16), WG_D4(20), WG_D4(24), \
      WG_D4(28)
#define WG_REGS32                                                           \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

// d[64 x 64] (+)= A[64 x 8] B[8 x 64], TF32 operands, A and B K-major in
// shared memory; d's old value is dropped unless `accumulate`.
__device__ __forceinline__ void mma_ss(float (&d)[32], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " WG_REGS32
      ", %32, %33, p, 1, 1;\n}\n"
      : WG_D32
      : "l"(a), "l"(b), "r"(accumulate));
}

// The same with A in registers: the .tf32 A fragment of rows r and r + 8
// (r = 16 warp + lane / 4), columns t and t + 4 (t = lane % 4).
__device__ __forceinline__ void mma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                       int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " WG_REGS32
      ", {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : WG_D32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ float tf32(float x) {  // round to TF32, ties away from zero
  uint32_t y;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(y) : "f"(x));
  return __uint_as_float(y);
}

__device__ __forceinline__ void st4(uint32_t addr, float a, float b, float c, float d) {
  asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "f"(a), "f"(b), "f"(c),
               "f"(d)
               : "memory");
}

// x = hi + lo, stored as hi at `hi` and lo at `lo` (shared memory).
__device__ __forceinline__ void split_store(uint32_t hi, uint32_t lo, float4 x) {
  const float h0 = tf32(x.x), h1 = tf32(x.y), h2 = tf32(x.z), h3 = tf32(x.w);
  st4(hi, h0, h1, h2, h3);
  st4(lo, tf32(x.x - h0), tf32(x.y - h1), tf32(x.z - h2), tf32(x.w - h3));
}

// The same into global memory, at byte offset `off` of the hi and lo tiles.
__device__ __forceinline__ void split_put(char* hi, char* lo, uint32_t off, float4 x) {
  const float4 h = make_float4(tf32(x.x), tf32(x.y), tf32(x.z), tf32(x.w));
  *reinterpret_cast<float4*>(hi + off) = h;
  *reinterpret_cast<float4*>(lo + off) =
      make_float4(tf32(x.x - h.x), tf32(x.y - h.y), tf32(x.z - h.z), tf32(x.w - h.w));
}

// Columns c..c+3 of row r of a [rows, D] slice, zeros past the slice.
__device__ __forceinline__ float4 load_quad(const float* base, long long rs, long long cs, int r,
                                            int c, int rows, int D) {
  float x[4];
#pragma unroll
  for (int e = 0; e < 4; ++e)
    x[e] = r < rows && c + e < D ? __ldg(base + r * rs + (c + e) * cs) : 0.f;
  return make_float4(x[0], x[1], x[2], x[3]);
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
}
// One thread: `bytes` from global `src` to shared `dst` by the bulk-copy
// engine, its completion counted on the mbarrier `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}
// Waits until `count` threads have reached named barrier `id`.
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(bar), "r"(parity)
      : "memory");
}

// The split pass: key tile j of KV head (b, hk), k_hi, k_lo, V^T_hi and
// V^T_lo laid out as one shared-memory stage (the 128-byte swizzle and the
// permuted keys included), written to `tiles` at stage (b, hk, j), so the
// attention kernel moves a whole stage with one bulk copy.  Thread t takes K
// units (key t / (DP/4) + i kStepK, columns 4 (t % (DP/4)) + 0..3) and V
// units (column t % DP of keys 8 (t / DP + i kStepV) + 0..7); keys past Sk
// and columns past D are zeros.  V^T row c holds keys 8 g + {0, 2, 4, 6},
// then 8 g + {1, 3, 5, 7}: P's A fragments take keys {t, t + 4} of each 8.
template <int NA>
__global__ void __launch_bounds__(Shape<NA>::kThreads)
flash_tf32x3_split_kernel(const float* __restrict__ k, const float* __restrict__ v,
                          float* __restrict__ tiles, Strides ks, Strides vs, int Hkv, int Sk,
                          int D) {
  using S = Shape<NA>;
  constexpr int kStepK = S::kThreads >> S::kQuadsLg, kStepV = S::kThreads / S::kDP;
  const int j = blockIdx.x, hk = blockIdx.y, b = blockIdx.z, k0 = j * kBK, tid = threadIdx.x;
  char* blk = reinterpret_cast<char*>(tiles) +
              ((static_cast<long long>(b) * Hkv + hk) * gridDim.x + j) * S::kStageBytes;
  const float* kp = k + b * ks.b + hk * ks.h;
  const float* vp = v + b * vs.b + hk * vs.h;
  const int kr = tid >> S::kQuadsLg, kc = 4 * (tid & ((1 << S::kQuadsLg) - 1));
#pragma unroll 4
  for (int i = 0; i < S::kKUnits; ++i) {
    const int r = kr + i * kStepK;
    split_put(blk, blk + S::kTBytes, swizzled(kBK, r, 4 * kc),
              load_quad(kp, ks.s, ks.d, k0 + r, kc, Sk, D));
  }
  const int vg = tid / S::kDP, vc = tid % S::kDP;
  char* vt = blk + 2 * S::kTBytes;
#pragma unroll 2
  for (int i = 0; i < S::kVUnits; ++i) {
    const int g = vg + i * kStepV, key = k0 + 8 * g;
    float x[8];
#pragma unroll
    for (int e = 0; e < 8; ++e)
      x[e] = key + e < Sk && vc < D ? __ldg(vp + (key + e) * vs.s + vc * vs.d) : 0.f;
    const uint32_t even = swizzled(S::kDP, vc, 32 * g), odd = even ^ 16;  // the next chunk
    split_put(vt, vt + S::kTBytes, even, make_float4(x[0], x[2], x[4], x[6]));
    split_put(vt, vt + S::kTBytes, odd, make_float4(x[1], x[3], x[5], x[7]));
  }
}

template <int NA>
__global__ void __launch_bounds__(Shape<NA>::kThreads, 1)
flash_tf32x3_kernel(const float* __restrict__ q, const float* __restrict__ tiles,
                    float* __restrict__ o, Strides qs, Strides os, int Sq, int Sk, int D, int Hkv,
                    int group, float scale, int causal, int has_window, int window) {
  using S = Shape<NA>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ alignas(8) uint64_t full[S::kStages];  // a stage's bulk copy has landed
  __shared__ int released[S::kStages];  // warpgroups done with a stage, counted up
  const uint32_t sq_hi = (smem_addr(smem_raw) + 1023) & ~1023u, sq_lo = sq_hi + S::kQBytes;
  // stage s at skv + s kStageBytes: k_hi, k_lo, vt_hi, vt_lo
  const uint32_t skv = sq_lo + S::kQBytes;

  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int iq = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = iq * S::kBQ, q_hi = min(q0 + S::kBQ, Sq) - 1;
  const int qa = q0 + 64 * wg, qb = qa + 63;  // this warpgroup's rows
  const float* qp = q + b * qs.b + h * qs.h;

  // the live key tiles [j_lo, j_hi): a window starts them, causality ends them
  const int nk = (Sk + kBK - 1) / kBK;
  const int j_hi = causal ? min(nk, q_hi / kBK + 1) : nk;
  const int j_lo = has_window && q0 - (kBK - 1) - window >= 0
                       ? (q0 - (kBK - 1) - window) / kBK + 1 : 0;
  // this KV head's split tiles, one stage each
  const char* kv = reinterpret_cast<const char*>(tiles) +
                   (static_cast<long long>(b) * Hkv + h / group) * nk * S::kStageBytes;

  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < S::kStages; ++i) {
      mbar_init(smem_addr(&full[i]));
      released[i] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
#pragma unroll
    for (int i = 0; i < S::kStages; ++i)  // the first tiles, one a stage
      if (j_lo + i < j_hi)
        bulk_load(skv + i * S::kStageBytes, kv + static_cast<long long>(j_lo + i) * S::kStageBytes,
                  S::kStageBytes, smem_addr(&full[i]));
  }
  if (j_lo < j_hi) {
#pragma unroll 4
    for (int i = 0; i < S::kQUnits; ++i) {  // q * scale, rounded in fp32, then split
      const int u = tid + i * S::kThreads, r = u >> S::kQuadsLg;
      const int c = 4 * (u & ((1 << S::kQuadsLg) - 1));
      const float4 x = load_quad(qp, qs.s, qs.d, q0 + r, c, Sq, D);
      const uint32_t off = swizzled(S::kBQ, r, 4 * c);
      split_store(sq_hi + off, sq_lo + off,
                  make_float4(__fmul_rn(x.x, scale), __fmul_rn(x.y, scale),
                              __fmul_rn(x.z, scale), __fmul_rn(x.w, scale)));
    }
    fence_async_smem();
  }
  __syncthreads();  // q, the mbarriers and the counters are in

  // thread (warp, lane) of a warpgroup holds rows r and r + 8 (r = 16 warp +
  // lane / 4) of its 64, columns 8 j + 2 (lane % 4) + {0, 1} of each 8
  float acc[NA][32];
#pragma unroll
  for (int a = 0; a < NA; ++a)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[a][i] = 0.f;
  float m[2] = {kMasked, kMasked}, l[2] = {0.f, 0.f};  // running max; partial row sums
  const int row0 = qa + 16 * warp + (lane >> 2), col0 = 2 * (lane & 3);

  // Tile j (the n-th, in stage n % kStages): the wait for its bulk copy;
  // S = three products; the softmax; P V, three products into a fresh
  // accumulator; the wait and acc = acc corr + P V; then the warpgroup
  // releases the stage, and the last one to release it starts the copy of
  // tile j + kStages into it.  No barrier of the whole CTA holds the two
  // warpgroups in step, so one's softmax runs under the other's products
  // (named barriers that handed them the tensor cores in turn, as FA3
  // does, were slower).  The loop body has no branch around a wgmma, so
  // ptxas keeps the products pipelined.
  for (int j = j_lo, n = 0; j < j_hi; ++j, ++n) {
    const int st = n % S::kStages;
    const uint32_t kst = skv + st * S::kStageBytes;
    mbar_wait(smem_addr(&full[st]), (n / S::kStages) & 1);

    // Every warpgroup computes every tile of [j_lo, j_hi), also one that is
    // dead for its 64 rows (one a CTA at the causal diagonal): branching
    // around the products makes ptxas serialise the wgmma pipeline.  A dead
    // tile changes nothing: its keys are masked, so p = exp(-1e30 - m) = 0
    // once the row has a live key, and before that its weights are wiped
    // by corr = exp(-1e30 - m_new) = 0 at the row's first live key.
    const int k0 = j * kBK, k_hi = k0 + kBK - 1;
    float s[32];
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < 3; ++t)  // Q_hi K_lo, Q_lo K_hi, Q_hi K_hi
#pragma unroll
      for (int kk = 0; kk < S::kDP / 8; ++kk) {
        const uint32_t off = (kk & 3) * 32;  // 8 columns = 32 bytes
        const uint32_t qt = (t == 1 ? sq_lo : sq_hi) + (kk >> 2) * S::kBQ * 128 + wg * 64 * 128;
        const uint32_t kt = kst + (t == 0 ? S::kTBytes : 0) + (kk >> 2) * kBK * 128;
        mma_ss(s, descriptor(qt + off), descriptor(kt + off), t > 0 || kk > 0);
      }
    wgmma_commit();
    wgmma_wait();
    fence_regs(s);

    const bool edge = (causal && k_hi > qa) || (has_window && qb - k0 >= window) || k_hi >= Sk;
    if (edge) {
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int key = k0 + 8 * (e >> 2) + col0 + (e & 1), row = row0 + 8 * ((e >> 1) & 1);
        if (key >= Sk)
          s[e] = -INFINITY;  // past the keys: no weight, as if the tile ended here
        else if ((causal && row < key) || (has_window && row - key >= window))
          s[e] = kMasked;
      }
    }
    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = s[2 * i];
#pragma unroll
      for (int j8 = 0; j8 < 8; ++j8)
        mx = fmaxf(mx, fmaxf(s[4 * j8 + 2 * i], s[4 * j8 + 2 * i + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[i], mx);
      corr[i] = expf(m[i] - m_new);
      m[i] = m_new;
    }
    // p = exp(s - max), split into the A fragments of P: k-step kk (keys
    // 8 kk .. 8 kk + 7, permuted as V^T is) is s[4 kk + {0, 2, 1, 3}]
    uint32_t p_hi[8][4], p_lo[8][4];
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const float p = expf(s[e] - m[(e >> 1) & 1]);
      sum[(e >> 1) & 1] += p;
      const float hi = tf32(p);
      const int slot = ((e >> 1) & 1) | ((e & 1) << 1);  // (row, key) -> a0..a3
      p_hi[e >> 2][slot] = __float_as_uint(hi);
      p_lo[e >> 2][slot] = __float_as_uint(tf32(p - hi));
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + sum[i];
    float pv[32];
#pragma unroll
    for (int a = 0; a < NA; ++a) {
      wgmma_fence();
#pragma unroll
      for (int t = 0; t < 3; ++t)  // p_lo V_hi, p_hi V_lo, p_hi V_hi
#pragma unroll
        for (int kk = 0; kk < kBK / 8; ++kk) {
          const uint32_t vt = kst + (t == 1 ? 3 : 2) * S::kTBytes + (kk >> 2) * S::kDP * 128 +
                              a * 64 * 128 + (kk & 3) * 32;
          mma_rs(pv, t == 0 ? p_lo[kk] : p_hi[kk], descriptor(vt), t > 0 || kk > 0);
        }
      wgmma_commit();
      wgmma_wait();
      fence_regs(pv);
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[a][e] = __fmaf_rn(acc[a][e], corr[(e >> 1) & 1], pv[e]);
    }
    bar_sync(1 + wg, 128);  // every warp of this warpgroup is done reading the stage
    if ((tid & 127) == 0 &&
        atomicAdd(&released[st], 1) == S::kNW * (n / S::kStages) + S::kNW - 1 &&
        j + S::kStages < j_hi)
      bulk_load(kst, kv + static_cast<long long>(j + S::kStages) * S::kStageBytes,
                S::kStageBytes, smem_addr(&full[st]));
  }

  float* op = o + b * os.b + h * os.h;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float sum = l[i];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float den = fmaxf(sum, 1e-30f);
    const int row = row0 + 8 * i;
    if (row >= Sq) continue;
#pragma unroll
    for (int a = 0; a < NA; ++a)
#pragma unroll
      for (int j8 = 0; j8 < 8; ++j8)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 64 * a + 8 * j8 + col0 + e;
          if (c < D) op[row * os.s + c * os.d] = acc[a][4 * j8 + 2 * i + e] / den;
        }
  }
}

template <int NA>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, void* tiles, int B,
                   int Hq, int Hkv, int Sq, int Sk, int D, const Strides* st, float scale,
                   int causal, int has_window, int window, cudaStream_t stream) {
  using S = Shape<NA>;
  static bool configured = false;  // the attribute is per function: set it once
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_tf32x3_kernel<NA>, cudaFuncAttributeMaxDynamicSharedMemorySize, S::kSmem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const int nk = (Sk + kBK - 1) / kBK;
  flash_tf32x3_split_kernel<NA><<<dim3(nk, Hkv, B), S::kThreads, 0, stream>>>(
      static_cast<const float*>(k), static_cast<const float*>(v), static_cast<float*>(tiles),
      st[1], st[2], Hkv, Sk, D);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_tf32x3_kernel<NA><<<dim3((Sq + S::kBQ - 1) / S::kBQ, Hq, B), S::kThreads, S::kSmem,
                            stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(tiles), static_cast<float*>(o),
      st[0], st[3], Sq, Sk, D, Hkv, Hq / Hkv, scale, causal, has_window, window);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes).  q [B, Hq, Sq, D], k and v
// [B, Hkv, Sk, D], o [B, Hq, Sq, D], all fp32 on the card, D <= 128, each
// given by its four element strides (b, h, s, d; any strides).  scale is
// 1/sqrt(D) rounded to fp32; has_window = 0 means no window.  `tiles` is
// 16-byte aligned scratch of B * Hkv * ceil(Sk / 64) stages, each 64 keys
// of k_hi, k_lo, V^T_hi and V^T_lo at the head padded to DP = 64 (D <= 64)
// or 128 columns: 16 * 64 * DP bytes.
// Enqueues two launches on `stream` (the split pass, then the attention
// kernel), never synchronises, and returns the CUDA error of the launches
// (0 on success).
extern "C" int flash_attention_tf32x3_fwd(
    const void* q, const void* k, const void* v, void* o, int B, int Hq, int Hkv, int Sq,
    int Sk, int D, long long qsb, long long qsh, long long qss, long long qsd, long long ksb,
    long long ksh, long long kss, long long ksd, long long vsb, long long vsh, long long vss,
    long long vsd, long long osb, long long osh, long long oss, long long osd, float scale,
    int causal, int has_window, int window, void* tiles, cudaStream_t stream) {
  if (B <= 0 || B > 65535 || Hq <= 0 || Hq > 65535 || Hkv <= 0 || Hq % Hkv != 0 || Sq <= 0 ||
      Sk <= 0 || D <= 0 || D > 128 || reinterpret_cast<uintptr_t>(tiles) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides st[4] = {{qsb, qsh, qss, qsd}, {ksb, ksh, kss, ksd}, {vsb, vsh, vss, vsd},
                         {osb, osh, oss, osd}};
  const cudaError_t err =
      D <= 64 ? launch<1>(q, k, v, o, tiles, B, Hq, Hkv, Sq, Sk, D, st, scale, causal,
                          has_window, window, stream)
              : launch<2>(q, k, v, o, tiles, B, Hq, Hkv, Sq, Sk, D, st, scale, causal,
                          has_window, window, stream);
  return static_cast<int>(err);
}
