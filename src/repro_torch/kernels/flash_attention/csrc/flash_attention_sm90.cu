// Flash attention forward in bf16 on Hopper's tensor cores, CUDA C++ for
// sm_90a.  The bf16 route of the port's flash attention; fp32 inputs take the
// 3xTF32 kernel in flash_attention_tf32.cu, or past d 128 the SIMT kernel in
// flash_attention.cu.
//
// Replaces the TPU kernel repro/kernels/flash_attention/kernel.py::
// flash_attention_pallas (body _kernel).  For each batch b and query head h
// (KV head h / g, g = Hq / Hkv) it writes
//   o[b, h] = softmax(mask(q[b, h] @ k[b, h/g]^T * scale)) @ v[b, h/g]
// with the causal mask (q_pos >= k_pos) and the optional sliding window
// (q_pos - k_pos < window).  The softmax is the reference's online softmax
// in fp32: masked scores are the finite sentinel -1e30 (not -inf), the
// running max starts at -1e30, keys past Sk get no weight (-inf, p = 0), and
// the output is acc / max(l, 1e-30), stored in bf16.
//
// What bounds it on an H100: operations.  At SmolLM-360M's prefill (B 8,
// S 4096, 15 query heads over 5 KV heads, d 64, causal) one launch does
// 2.578e11 FLOP over the live (q, k) pairs on 168 MB of q, k, v and o:
// 0.2606 ms at the tensor cores' 989 TFLOP/s bf16, 0.050 ms at 3.35 TB/s.
//
// Numerics: p is split, not rounded.  The reference computes p @ v in fp32.
// Rounding p to bf16 once for the tensor cores misses the port's bound of
// 2e-5 (1 + |o|) plus one bf16 ulp of o; splitting it as p_hi = bf16(p),
// p_lo = bf16(p - p_hi) leaves a residual of about 2^-18 relative.  Emulated
// with fp32 statistics, bf16 inputs and causal masks, against an fp64 oracle
// rounded to bf16 (elements over the bound):
//   case                          p in bf16 (worst excess)   p_hi + p_lo
//   S 512, d 64                   10 698 (1.4e-3)            0
//   S 4096, d 64                  84 807 (2.4e-3)            0
//   S 2048, d 128, window 1024    88 976 (1.9e-3)            0
//   S 256, d 16                    1 332 (1.2e-3)            0
// So P @ V is issued twice into one accumulator, for p_hi and for p_lo: 1.5x
// the tensor-core FLOP of one rounding.  Scores stay fp32 (bf16 x bf16
// products are exact in fp32); scale * log2(e) is folded into exp2 and
// applied to the fp32 scores, so q * scale is never rounded to bf16; the row
// max and the row sum are fp32, the sum taken over the unrounded p.
//
// Design.  One CTA of two warpgroups (256 threads) owns one (b, h, 128-row q
// tile); warpgroup w computes rows 64w..64w+63 of it.  The CTA loops over the
// live 64-key tiles:
//   * S = Q K^T by wgmma m64n64k16 (bf16 x bf16 -> fp32), A = the Q tile and
//     B = the K tile in its natural [keys, d] layout (K-major for B), both in
//     shared memory;
//   * O += P V by wgmma m64n64k16 with A = P in registers (the S
//     accumulator's fragments are exactly the A fragments of P) and B = the V
//     tile [keys, d] (MN-major: the transpose bit), once for p_hi and once
//     for p_lo, one instruction per 64 columns of the head;
//   * q, k and v are stored in 64-column atoms of 128-byte rows with the
//     128-byte swizzle that wgmma's descriptors read; the head width is
//     padded with zeros to a multiple of 64 (the atom: d 16, 20 and 32 pad
//     to 64; d 64, 128 and 256 are exact), so one layout serves every head;
//   * K and V arrive by cp.async into a ring of three stages (two at d 256,
//     where three do not fit beside the q tile): tile j+1 loads while tile
//     j's products run, and tile j's P V runs on through the next tile's
//     copy wait and barrier.  The copy width (16, 8 or 4 bytes, or
//     ordinary 2-byte loads) is a template parameter the wrapper picks from
//     the pointers and strides, since a [B, S, H, D] view's rows need not be
//     16-byte aligned (d 20: KV head 1 starts 40 bytes in); nothing is copied
//     to align it.  Rows past Sq or Sk are zero-filled by the copy;
//   * tiles with no live (q, k) pair are skipped: causal tiles past the
//     diagonal end the loop, a window starts it at the first tile that
//     reaches into it (O(S * W) for a windowed layer), and a warpgroup skips
//     the products of a tile that is dead for its 64 rows; only tiles that
//     cross the diagonal, the window's edge or Sk pay for the mask;
//   * q, k, v and o are read and written through their strides (d-stride
//     1), so the model's [B, S, H, D] tensors pass as [B, H, S, D] views and
//     the output comes back in q's layout; q tiles go heaviest first;
//   * two CTAs share an SM at d <= 64 (at most 128 registers, 65 KB of
//     shared memory each), so one CTA's softmax overlaps the other's
//     products; a wider head keeps one CTA an SM, whose accumulators would
//     spill at 128 registers.  ptxas reports no spills for any instantiation.
//
// On an H100 at 700 W (chip_smoke.py) this runs SmolLM's layer at ~1.17 ms,
// 2x SDPA's time and 4.5x its bound.  What holds it there: the softmax's
// SIMT instructions (exp2, the hi/lo split, the row max and sums) issue from
// the same warpgroups that wait on the tensor cores, so the two only overlap
// across warpgroups; a producer warp with TMA and warpgroups that ping-pong
// their softmax against each other's products are the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 128;           // q rows per CTA: two warpgroups of 64
constexpr int kBK = 64;            // keys per tile
constexpr int kThreads = 256;
constexpr float kMasked = -1e30f;  // the reference's mask sentinel
constexpr float kLog2e = 1.4426950408889634f;

struct Strides {
  long long b, h, s, d;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of byte column cb of row r in a tile of `rows` rows stored as
// 64-column atoms of [rows][128 B], each 128-byte swizzled (16-byte chunk c
// of row r sits at chunk c ^ (r % 8)); atoms start 1024-byte aligned.
__device__ __forceinline__ uint32_t swizzled(int rows, int r, int cb) {
  return (cb >> 7) * rows * 128 + r * 128 + ((((cb >> 4) & 7) ^ (r & 7)) << 4) + (cb & 15);
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets, all in 16-byte units.
__device__ __forceinline__ uint64_t descriptor(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
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

#define WG_D4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define WG_D32                                                                     \
  WG_D4(0), WG_D4(4), WG_D4(8), WG_D4(12), WG_D4(16), WG_D4(20), WG_D4(24), \
      WG_D4(28)
#define WG_REGS32                                                           \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

// d[64 x 64] (+)= A[64 x 16] B[16 x 64]^T, A and B K-major in shared memory;
// d's old value is dropped unless `accumulate`.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_REGS32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : WG_D32
      : "l"(a), "l"(b), "r"(accumulate));
}

// d[64 x 64] += A[64 x 16] B[16 x 64], A in registers, B MN-major in shared
// memory (transpose bit set).
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_REGS32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WG_D32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Copies W bytes from global src to shared dst, or writes W zero bytes when
// !valid (the row lies past the sequence).  W = 2 is an ordinary load.
template <int W>
__device__ __forceinline__ void copy_piece(uint32_t dst, const __nv_bfloat16* src, bool valid) {
  if constexpr (W == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
                 "r"(valid ? 16 : 0)
                 : "memory");
  } else if constexpr (W == 8 || W == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst), "l"(src), "n"(W),
                 "r"(valid ? W : 0)
                 : "memory");
  } else {
    const unsigned short x = valid ? *reinterpret_cast<const unsigned short*>(src) : 0;
    asm volatile("st.shared.u16 [%0], %1;\n" ::"r"(dst), "h"(x) : "memory");
  }
}

// Rows r0 .. r0 + rows - 1 of a [S, D] slice (row stride `stride`, d-stride
// 1) into a swizzled tile at shared address dst; rows >= n are zeros.  This
// thread copies piece p (W bytes) of rows first, first + step, ...: a row's
// 2 D / W pieces take the low bits of the thread index, rounded up to a
// power of two, so the mapping costs shifts and masks, no division.
template <int W>
__device__ __forceinline__ void load_tile(uint32_t dst, int rows, const __nv_bfloat16* base,
                                          long long stride, int r0, int n, int D) {
  const int per_row = 2 * D / W, lg = per_row <= 1 ? 0 : 32 - __clz(per_row - 1);
  const int p = threadIdx.x & ((1 << lg) - 1), first = threadIdx.x >> lg, step = kThreads >> lg;
  if (p >= per_row) return;
  const int cb = p * W;
  const __nv_bfloat16* src = base + (r0 + first) * stride + cb / 2;
  for (int r = first; r < rows; r += step, src += step * stride) {
    const bool valid = r0 + r < n;
    copy_piece<W>(dst + swizzled(rows, r, cb), valid ? src : base, valid);
  }
}

__device__ __forceinline__ float ex2(float x) {  // 2^x, one MUFU op
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// p = 2^(s sc - m) = exp(scale (s - max)) of one tile's raw scores s (m: the
// row max in log2 units), added to the row sums l and split into the bf16 A
// fragments of P: hi = bf16(p), lo = bf16(p - hi), 16 keys to a fragment.
// kExact rounds s sc as m was rounded, so a row whose scores so far are all
// the sentinel gets p = 1 as in the reference's softmax; a tile with no
// masked score takes one FFMA instead (its exact product would leave the
// sentinel's rounding error, ~1e22, in the exponent).
template <bool kExact>
__device__ __forceinline__ void split_p(const float (&s)[32], const float (&m)[2], float sc,
                                        float (&l)[2], uint32_t (&hi)[4][4],
                                        uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int e = 0; e < 32; e += 2) {
    const int i = (e >> 1) & 1;
    // __fmul_rn: a product nvcc may not contract into an FMA
    const float p0 = ex2(kExact ? __fmul_rn(s[e], sc) - m[i] : fmaf(s[e], sc, -m[i]));
    const float p1 = ex2(kExact ? __fmul_rn(s[e + 1], sc) - m[i] : fmaf(s[e + 1], sc, -m[i]));
    l[i] += p0 + p1;
    const __nv_bfloat162 h = __floats2bfloat162_rn(p0, p1);
    const float2 hf = __bfloat1622float2(h);
    hi[e >> 3][(e >> 1) & 3] = bits(h);
    lo[e >> 3][(e >> 1) & 3] = bits(__floats2bfloat162_rn(p0 - hf.x, p1 - hf.y));
  }
}

// Stages of the k/v ring: three where they fit beside the q tile (d <= 192),
// so a tile's P @ V can run on while the next tile's loads are issued.
__host__ __device__ constexpr int stages(int na) { return na == 4 ? 2 : 3; }

constexpr int smem_bytes(int na) {  // the q tile, the k/v ring, alignment
  return (kBQ + 2 * stages(na) * kBK) * 64 * na * 2 + 1024;
}

template <int NA, int W>
__global__ void __launch_bounds__(kThreads, NA == 1 ? 2 : 1)
flash_wgmma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                   Strides qs, Strides ks, Strides vs, Strides os, int Sq, int Sk, int D,
                   int group, float scale_log2, int causal, int has_window, int window) {
  constexpr int DP = 64 * NA;                      // padded head width
  constexpr uint32_t kQBytes = kBQ * DP * 2;       // the q tile
  constexpr uint32_t kTileBytes = kBK * DP * 2;    // one k or v tile
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sq = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t sk = sq + kQBytes;  // stage s: k at sk + 2 s kTileBytes, v after it
  constexpr int kStages = stages(NA);

  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int iq = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = iq * kBQ, q_hi = min(q0 + kBQ, Sq) - 1;
  const int qa = q0 + 64 * wg, qb = qa + 63;  // this warpgroup's rows
  const __nv_bfloat16* qp = q + b * qs.b + h * qs.h;
  const __nv_bfloat16* kp = k + b * ks.b + (h / group) * ks.h;
  const __nv_bfloat16* vp = v + b * vs.b + (h / group) * vs.h;

  // the live key tiles [j_lo, j_hi): a window starts them, causality ends them
  const int nk = (Sk + kBK - 1) / kBK;
  const int j_hi = causal ? min(nk, q_hi / kBK + 1) : nk;
  const int j_lo = has_window && q0 - (kBK - 1) - window >= 0
                       ? (q0 - (kBK - 1) - window) / kBK + 1 : 0;

  if (D < DP) {  // the padded columns of q, k and v stay zero
    for (uint32_t i = tid * 16; i < kQBytes + 2 * kStages * kTileBytes; i += kThreads * 16)
      asm volatile("st.shared.v4.u32 [%0], {%1, %1, %1, %1};\n" ::"r"(sq + i), "r"(0) : "memory");
    __syncthreads();
  }
  if (j_lo < j_hi) {
    load_tile<W>(sq, kBQ, qp, qs.s, q0, Sq, D);
    load_tile<W>(sk, kBK, kp, ks.s, j_lo * kBK, Sk, D);
    load_tile<W>(sk + kTileBytes, kBK, vp, vs.s, j_lo * kBK, Sk, D);
  }
  cp_async_commit();

  // thread (warp, lane) of a warpgroup holds rows r and r + 8 (r = 16 warp +
  // lane / 4) of its 64, columns 8 j + 2 (lane % 4) + {0, 1} of each 8
  float acc[NA][32];
#pragma unroll
  for (int a = 0; a < NA; ++a)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[a][i] = 0.f;
  // the running max in log2 units (m = max(s) sc, rounded once) and this
  // thread's partial row sums
  float m[2] = {kMasked, kMasked}, l[2] = {0.f, 0.f};
  const int row0 = qa + 16 * warp + (lane >> 2), col0 = 2 * (lane & 3);

  // Tile j: wait for its copies; a barrier (every thread's copies landed,
  // and every warpgroup is past tile j - 1, so P @ V of tile j + 1 - stages
  // is done and its stage is free); issue tile j + 1's copies into that
  // stage; S = Q K^T, whose wait also retires tile j - 1's P @ V; softmax;
  // P @ V left running into the next tile's wait and barrier (with two
  // stages it is waited for here, before the barrier that frees its stage).
  for (int j = j_lo, st = 0; j < j_hi; ++j, st = st + 1 == kStages ? 0 : st + 1) {
    const uint32_t kst = sk + st * 2 * kTileBytes, vst = kst + kTileBytes;
    cp_async_wait_all();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to wgmma
    __syncthreads();
    if (j + 1 < j_hi) {
      const uint32_t nxt = sk + (st + 1 == kStages ? 0 : st + 1) * 2 * kTileBytes;
      load_tile<W>(nxt, kBK, kp, ks.s, (j + 1) * kBK, Sk, D);
      load_tile<W>(nxt + kTileBytes, kBK, vp, vs.s, (j + 1) * kBK, Sk, D);
      cp_async_commit();
    }

    const int k0 = j * kBK, k_hi = k0 + kBK - 1;
    const bool dead = qa >= Sq || (causal && k0 > qb) || (has_window && qa - k_hi >= window);
    if (dead) {  // uniform over the warpgroup; retire P @ V before the next barrier
      wgmma_wait();
    } else {
      float s[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t atom = kk >> 2, off = (kk & 3) * 32;  // 16 columns = 32 bytes
        wgmma_ss(s, descriptor(sq + atom * kBQ * 128 + wg * 64 * 128 + off, 0, 1024),
                 descriptor(kst + atom * kBK * 128 + off, 0, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait();
      fence_regs(s);
#pragma unroll
      for (int a = 0; a < NA; ++a) fence_regs(acc[a]);

      // s is raw q.k, masked with the sentinel; sc = scale log2(e)
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
        // sc > 0, so max(s) sc rounded is the max of each s sc rounded
        const float m_new = fmaxf(m[i], __fmul_rn(mx, scale_log2));
        corr[i] = ex2(m[i] - m_new);
        m[i] = m_new;
        l[i] *= corr[i];
      }
      uint32_t p_hi[4][4], p_lo[4][4];  // A fragments of P, one per 16 keys
      if (edge)
        split_p<true>(s, m, scale_log2, l, p_hi, p_lo);
      else
        split_p<false>(s, m, scale_log2, l, p_hi, p_lo);
#pragma unroll
      for (int a = 0; a < NA; ++a)
#pragma unroll
        for (int e = 0; e < 32; ++e) acc[a][e] *= corr[(e >> 1) & 1];
      wgmma_fence();
#pragma unroll
      for (int a = 0; a < NA; ++a)
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) {
          const uint64_t bd = descriptor(vst + a * kBK * 128 + kk * 2048, 1024, 1024);
          wgmma_rs(acc[a], p_hi[kk], bd);
          wgmma_rs(acc[a], p_lo[kk], bd);
        }
      wgmma_commit();
      if (kStages == 2) wgmma_wait();
    }
  }
  wgmma_wait();
#pragma unroll
  for (int a = 0; a < NA; ++a) fence_regs(acc[a]);

  __nv_bfloat16* op = o + b * os.b + h * os.h;
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
      for (int j8 = 0; j8 < 8; ++j8) {
        const int c = 64 * a + 8 * j8 + col0;
        if (c >= D) continue;
        const float x0 = acc[a][4 * j8 + 2 * i] / den, x1 = acc[a][4 * j8 + 2 * i + 1] / den;
        __nv_bfloat16* dst = op + row * os.s + c;
        if constexpr (W >= 4) {  // D even, o 4-byte aligned: both columns at once
          *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(x0, x1);
        } else {
          dst[0] = __float2bfloat16(x0);
          if (c + 1 < D) dst[1] = __float2bfloat16(x1);
        }
      }
  }
}

template <int NA, int W>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int Hq, int Sq,
                   int Sk, int D, int group, const Strides* st, float scale_log2, int causal,
                   int has_window, int window, cudaStream_t stream) {
  constexpr int bytes = smem_bytes(NA);
  static bool configured = false;  // the attribute is per function: set it once
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_wgmma_kernel<NA, W>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid((Sq + kBQ - 1) / kBQ, Hq, B);
  flash_wgmma_kernel<NA, W><<<grid, kThreads, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), st[0], st[1], st[2],
      st[3], Sq, Sk, D, group, scale_log2, causal, has_window, window);
  return cudaGetLastError();
}

template <int NA>
cudaError_t launch_w(int w, const void* q, const void* k, const void* v, void* o, int B, int Hq,
                     int Sq, int Sk, int D, int group, const Strides* st, float scale_log2,
                     int causal, int has_window, int window, cudaStream_t stream) {
  switch (w) {
    case 16:
      return launch<NA, 16>(q, k, v, o, B, Hq, Sq, Sk, D, group, st, scale_log2, causal,
                            has_window, window, stream);
    case 8:
      return launch<NA, 8>(q, k, v, o, B, Hq, Sq, Sk, D, group, st, scale_log2, causal,
                           has_window, window, stream);
    case 4:
      return launch<NA, 4>(q, k, v, o, B, Hq, Sq, Sk, D, group, st, scale_log2, causal,
                           has_window, window, stream);
    default:
      return launch<NA, 2>(q, k, v, o, B, Hq, Sq, Sk, D, group, st, scale_log2, causal,
                           has_window, window, stream);
  }
}

}  // namespace

// Plain C entry point (bound with ctypes).  q [B, Hq, Sq, D], k and v
// [B, Hkv, Sk, D], o [B, Hq, Sq, D], all bf16 on the card, each given by its
// four element strides (b, h, s, d; the d-strides must be 1).  copy_bytes
// (16, 8, 4 or 2) divides every pointer's address, every b/h/s stride in
// bytes and the row's 2 D bytes.  scale is 1/sqrt(D) rounded to fp32;
// has_window = 0 means no window.  Enqueues one launch on `stream`, never
// synchronises, and returns the CUDA error of the launch (0 on success).
extern "C" int flash_attention_bf16_fwd(
    const void* q, const void* k, const void* v, void* o, int B, int Hq, int Hkv, int Sq,
    int Sk, int D, long long qsb, long long qsh, long long qss, long long qsd, long long ksb,
    long long ksh, long long kss, long long ksd, long long vsb, long long vsh, long long vss,
    long long vsd, long long osb, long long osh, long long oss, long long osd, float scale,
    int causal, int has_window, int window, int copy_bytes, cudaStream_t stream) {
  if (B <= 0 || B > 65535 || Hq <= 0 || Hq > 65535 || Hkv <= 0 || Hq % Hkv != 0 || Sq <= 0 ||
      Sk <= 0 || D <= 0 || D > 256 || qsd != 1 || ksd != 1 || vsd != 1 || osd != 1 ||
      (copy_bytes != 16 && copy_bytes != 8 && copy_bytes != 4 && copy_bytes != 2) ||
      (2 * D) % copy_bytes != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides st[4] = {{qsb, qsh, qss, qsd}, {ksb, ksh, kss, ksd}, {vsb, vsh, vss, vsd},
                         {osb, osh, oss, osd}};
  const int group = Hq / Hkv, na = (D + 63) / 64;
  const float scale_log2 = scale * kLog2e;
  cudaError_t err;
  if (na == 1)
    err = launch_w<1>(copy_bytes, q, k, v, o, B, Hq, Sq, Sk, D, group, st, scale_log2, causal,
                      has_window, window, stream);
  else if (na == 2)
    err = launch_w<2>(copy_bytes, q, k, v, o, B, Hq, Sq, Sk, D, group, st, scale_log2, causal,
                      has_window, window, stream);
  else if (na == 3)
    err = launch_w<3>(copy_bytes, q, k, v, o, B, Hq, Sq, Sk, D, group, st, scale_log2, causal,
                      has_window, window, stream);
  else
    err = launch_w<4>(copy_bytes, q, k, v, o, B, Hq, Sq, Sk, D, group, st, scale_log2, causal,
                      has_window, window, stream);
  return static_cast<int>(err);
}
