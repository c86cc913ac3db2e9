// Flash attention forward in fp32 on the SIMT units, CUDA C++ for sm_90a.
// The fp32 route of the port's flash attention for heads of 129 to 256
// columns (the wrapper's route "simt"); fp32 heads of up to 128 columns take
// the tensor-core kernel in flash_attention_tf32.cu (three TF32 products for
// each fp32 one), and bf16 inputs the kernel in flash_attention_sm90.cu.
//
// Replaces the TPU kernel repro/kernels/flash_attention/kernel.py::
// flash_attention_pallas (body _kernel).  For each batch b and query head h
// (KV head h / g, g = Hq / Hkv) it writes
//   o[b, h] = softmax(mask(q[b, h] * scale @ k[b, h/g]^T)) @ v[b, h/g]
// with scale = 1/sqrt(D) applied to q before the product, the causal mask
// (q_pos >= k_pos) and the optional sliding window (q_pos - k_pos < window).
// The softmax is the reference's online softmax in fp32: masked scores are
// the finite sentinel -1e30 (not -inf), the running max starts at -1e30, and
// the output is acc / max(l, 1e-30), stored in fp32.
//
// What bounds it on an H100: operations, at the SIMT units' 67 TFLOP/s fp32
// (at the fp32 SmolLM-360M's prefill, B 2, S 4096, 15 query heads, d 64,
// causal: 6.4e10 FLOP, 0.96 ms; chip_smoke.py timed that layer at ~3.1 ms
// on an H100 at 700 W).  One TF32
// rounding of the operands misses the port's 2e-5 bound, but a hi + lo
// split of each operand into three TF32 products meets it: that is the
// tensor-core route of flash_attention_tf32.cu, whose shared-memory plan
// stops at d 128.  Wider fp32 heads (no model of the repo has one) stay here.
//
// Design.  The Pallas grid (B, Hq, nq, nk) walks the KV blocks in order on
// one core, carrying m, l and acc in VMEM scratch.  Here one CTA of 256
// threads owns one (b, h, 64-row q tile) and loops over 64-key tiles itself:
//   * q * scale, k^T, v and p^T are staged in shared memory as fp32 (q once,
//     k and v per tile), padded to a head width of 64 * NM (NM = 1..4, so
//     any d <= 256), rows padded by 4 floats for float4 reads;
//   * thread (ty, tx) of a 16 x 16 layout owns rows 4ty..4ty+3 of the tile:
//     a 4 x 4 block of scores (keys 4tx..4tx+3), and fp32 accumulators for
//     columns 64m + 4tx..4tx+3 of the output, m < NM, in registers;
//   * the row max and row sum cross the 16 threads of a row with xor
//     shuffles (they sit in one half-warp);
//   * a tile with no live (q, k) pair is skipped, as the Pallas grid skips
//     it: causal tiles past the diagonal end the loop, and a window skips
//     the tiles wholly behind it, so a windowed layer costs O(S * W);
//   * keys past Sk (a ragged last tile) get no weight at all (-inf, p = 0),
//     masked keys inside the sequence get the reference's -1e30;
//   * q, k, v and o are read and written through their four strides, so the
//     model's [B, S, H, D] tensors are passed as [B, H, S, D] views and the
//     Pallas wrapper's transposes cost nothing here;
//   * q tiles are issued heaviest first (the last causal tile has the most
//     live keys).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;             // q rows per CTA
constexpr int kBK = 64;             // keys per tile
constexpr int kThreads = 256;       // 16 x 16
constexpr int kLd = kBQ + 4;        // leading dim of q^T, k^T and p^T in shared memory
constexpr float kNegInf = -1e30f;   // the reference's mask sentinel

struct Strides {
  long long b, h, s, d;
};

__device__ __forceinline__ float get(const float4& x, int i) {
  return i == 0 ? x.x : i == 1 ? x.y : i == 2 ? x.z : x.w;
}

constexpr size_t smem_bytes(int nm) {
  return sizeof(float) * (2 * 64 * nm * kLd + kBK * 64 * nm + kBK * kLd);
}

template <int NM>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, Strides qs, Strides ks, Strides vs, Strides os, int Sq,
                 int Sk, int D, int group, float scale, int causal, int has_window,
                 int window) {
  constexpr int DP = 64 * NM;  // padded head width
  extern __shared__ float4 smem4[];
  float* Qt = reinterpret_cast<float*>(smem4);  // [DP][kLd]  (q * scale)^T
  float* Kt = Qt + DP * kLd;                    // [DP][kLd]  k^T of the tile
  float* Vs = Kt + DP * kLd;                    // [kBK][DP]  v of the tile
  float* Pt = Vs + kBK * DP;                    // [kBK][kLd] p^T of the tile

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int iq = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = iq * kBQ, q_hi = q0 + kBQ - 1;
  const float* qp = q + b * qs.b + h * qs.h;
  const float* kp = k + b * ks.b + (h / group) * ks.h;
  const float* vp = v + b * vs.b + (h / group) * vs.h;

  // consecutive threads take consecutive d: coalesced reads of a row
  for (int i = tid; i < kBQ * DP; i += kThreads) {
    const int r = i / DP, d = i % DP;
    float x = 0.f;
    if (q0 + r < Sq && d < D) x = qp[(q0 + r) * qs.s + d * qs.d] * scale;
    Qt[d * kLd + r] = x;
  }

  float acc[4][4 * NM];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * NM; ++c) acc[i][c] = 0.f;
  }

  const int nk = (Sk + kBK - 1) / kBK;
  for (int ik = 0; ik < nk; ++ik) {
    const int k0 = ik * kBK, k_hi = k0 + kBK - 1;
    if (causal && q_hi < k0) break;                  // this and every later tile is dead
    if (has_window && q0 - k_hi >= window) continue;  // wholly behind the window
    __syncthreads();  // the previous tile's readers are done with Kt, Vs and Pt
    for (int i = tid; i < kBK * DP; i += kThreads) {
      const int r = i / DP, d = i % DP;
      float kx = 0.f, vx = 0.f;
      if (k0 + r < Sk && d < D) {
        kx = kp[(k0 + r) * ks.s + d * ks.d];
        vx = vp[(k0 + r) * vs.s + d * vs.d];
      }
      Kt[d * kLd + r] = kx;
      Vs[r * DP + d] = vx;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(&Qt[d * kLd + 4 * ty]);
      const float4 c = *reinterpret_cast<const float4*>(&Kt[d * kLd + 4 * tx]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] += get(a, i) * get(c, j);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + 4 * ty + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + 4 * tx + j;
        if (kj >= Sk)
          s[i][j] = -INFINITY;  // past the keys: no weight, as if the tile ended here
        else if ((causal && qi < kj) || (has_window && qi - kj >= window))
          s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * NM; ++c) acc[i][c] *= corr;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(&Pt[(4 * tx + j) * kLd + 4 * ty]) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      const float4 p = *reinterpret_cast<const float4*>(&Pt[c * kLd + 4 * ty]);
#pragma unroll
      for (int mm = 0; mm < NM; ++mm) {
        const float4 w = *reinterpret_cast<const float4*>(&Vs[c * DP + 64 * mm + 4 * tx]);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][4 * mm + j] += get(p, i) * get(w, j);
      }
    }
  }

  float* op = o + b * os.b + h * os.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + 4 * ty + i;
    if (r >= Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int mm = 0; mm < NM; ++mm)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int d = 64 * mm + 4 * tx + j;
        if (d < D) op[r * os.s + d * os.d] = acc[i][4 * mm + j] / den;
      }
  }
}

template <int NM>
cudaError_t launch_nm(const void* q, const void* k, const void* v, void* o, int B, int Hq,
                      int Sq, int Sk, int D, int group, const Strides* st, float scale,
                      int causal, int has_window, int window, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes(NM);
  static bool configured = false;  // the attribute is per function: set it once
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<NM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid((Sq + kBQ - 1) / kBQ, Hq, B);
  flash_fwd_kernel<NM><<<grid, kThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), st[0], st[1], st[2], st[3], Sq, Sk, D, group, scale, causal,
      has_window, window);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes).  q [B, Hq, Sq, D], k and v
// [B, Hkv, Sk, D], o [B, Hq, Sq, D], all fp32 on the card, each given by its
// four element strides (b, h, s, d).  scale is 1/sqrt(D) rounded to fp32;
// has_window = 0 means no window.  Enqueues one launch on `stream`, never
// synchronises, and returns the CUDA error of the launch (0 on success).
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int B, int Hq, int Hkv, int Sq,
    int Sk, int D, long long qsb, long long qsh, long long qss, long long qsd, long long ksb,
    long long ksh, long long kss, long long ksd, long long vsb, long long vsh, long long vss,
    long long vsd, long long osb, long long osh, long long oss, long long osd, float scale,
    int causal, int has_window, int window, cudaStream_t stream) {
  if (B <= 0 || B > 65535 || Hq <= 0 || Hq > 65535 || Hkv <= 0 || Hq % Hkv != 0 || Sq <= 0 ||
      Sk <= 0 || D <= 0 || D > 256)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides st[4] = {{qsb, qsh, qss, qsd}, {ksb, ksh, kss, ksd}, {vsb, vsh, vss, vsd},
                         {osb, osh, oss, osd}};
  const int group = Hq / Hkv, nm = (D + 63) / 64;
  const cudaError_t err =
      nm == 1   ? launch_nm<1>(q, k, v, o, B, Hq, Sq, Sk, D, group, st, scale, causal,
                               has_window, window, stream)
      : nm == 2 ? launch_nm<2>(q, k, v, o, B, Hq, Sq, Sk, D, group, st, scale, causal,
                               has_window, window, stream)
      : nm == 3 ? launch_nm<3>(q, k, v, o, B, Hq, Sq, Sk, D, group, st, scale, causal,
                               has_window, window, stream)
                : launch_nm<4>(q, k, v, o, B, Hq, Sq, Sk, D, group, st, scale, causal,
                               has_window, window, stream);
  return static_cast<int>(err);
}
