// Tiered-arena gather + decode, and gather + decode + host encode, CUDA C++
// for sm_90a.
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
// Two entries share that body.  `gather_decode` writes the fp32 [K, D]
// rows.  `gather_decode_encode` serves a write-back into an encoded host
// tier: it keeps each decoded row in registers and writes the host codec's
// row instead, so no fp32 [K, D] block is written to device memory and
// read back only to be encoded (the transmitter's gather_slots followed by
// HostStore.encode_block, one launch for ~14 torch ops):
//   fp16 host   __float2half_rn of each element;
//   int8 host   the row's min and max by warp shuffles, then, in the order
//               and roundings of the codec's eager torch ops (store/codec.py)
//               scale = max(mx - mn, 1e-12) / 254, zp = 0.5 * (mx + mn),
//               q = clamp(rint((x - zp) / scale), -127, 127); every
//               division correctly rounded (__fdiv_rn, never a reciprocal),
//               rintf rounding half to even as torch.round does; one char4
//               store per lane, lane 0 writes (scale, zp).
// A NaN anywhere in a row makes its min, max, scale and zp NaN and every
// code 0, and an infinite extreme makes scale or zp infinite and the codes
// 0, as torch's amin / amax (which propagate NaN), clamp (which keeps NaN)
// and int8 cast do; so a diverged row reaches the host tier as it would
// have through the composition.  Bitwise the plain composition, with one
// exception: on a row whose min or max is a zero of both signs the min /
// max of a warp (fminf / fmaxf) and torch's reduction may pick zeros of
// different sign, and zp = +-0 then differs in its sign bit only (it
// decodes the same).
//
// What bounds them on an H100: bytes.  Per lane they read a 4 B slot and
// one row (512 B of fp32 head, or 128 B of int8 payload + 8 B of sideband
// at D = 128) and write 512 B (gather_decode) or the host row, 136 B for
// int8 and 256 B for fp16 (gather_decode_encode); at the card's 3.35 TB/s
// a flush of the paper's 506 438-slot arena (377.8 MB) needs 0.113 ms, one
// step's write-back of ~25 k lanes about 5 us, below one launch's latency.
// They do no arithmetic worth counting.
//
// Design.  The TPU kernel streams one row per sequential grid step through
// VMEM.  Here one warp owns one output row at a time (8 warps per block,
// grid-stride over rows): the 32 lanes read the slot once (a broadcast
// load), then move the row as 16 B loads — a float4 of the head row, four
// halves (8 B) or a char4 (4 B) of the tail row decoded in registers.  The
// (scale, zp) pair is read once per row.  The int8 encode reads its row
// twice, once for the min / max and once to quantise; the second read hits
// L1.  Rows, not lanes, are the unit of parallelism, so a gather of a few
// thousand rows still spreads over every SM.  A scalar path covers D % 4 !=
// 0 and unaligned pointers.


#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / 32;  // one warp per row
constexpr long long kMaxBlocks = 132LL * 8 * 4;  // 4 waves of full occupancy
constexpr unsigned kFull = 0xffffffffu;

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

// One lane's view of the decoded row of slot s for the encode entry, which
// reads its row twice: a zero row, a head row or a tail row with its
// (scale, zp).
template <int CODEC>
struct Row {
  int kind;  // 0 zero (padding / out of range), 1 head, 2 tail
  const float* hrow;
  const void* trow;
  float scale, zp;

  __device__ __forceinline__ Row(const float* head, long long H, const void* tail, long long T,
                                 const float* side, long long s, int D) {
    kind = (s < 0 || s >= H + T) ? 0 : (s < H ? 1 : 2);
    hrow = head + (kind == 1 ? s : 0) * D;
    const long long t = kind == 2 ? s - H : 0;
    trow = static_cast<const char*>(tail) + t * D * (CODEC == kFp16 ? 2 : 1);
    scale = zp = 0.f;
    if (CODEC == kInt8 && kind == 2) {
      scale = __ldg(side + 2 * t);
      zp = __ldg(side + 2 * t + 1);
    }
  }
  __device__ __forceinline__ float4 get4(int c4) const {
    if (kind == 0) return make_float4(0.f, 0.f, 0.f, 0.f);
    if (kind == 1) return __ldg(reinterpret_cast<const float4*>(hrow) + c4);
    return decode4<CODEC>(trow, c4, scale, zp);
  }
  __device__ __forceinline__ float get1(int c) const {
    if (kind == 0) return 0.f;
    if (kind == 1) return __ldg(hrow + c);
    return decode1<CODEC>(trow, c, scale, zp);
  }
};

template <int CODEC, bool VEC>
__global__ void __launch_bounds__(kThreads)
gather_decode_kernel(const float* __restrict__ head, long long H,
                     const void* __restrict__ tail, long long T,
                     const float* __restrict__ side, const int* __restrict__ slots,
                     long long K, int D, float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long stride = static_cast<long long>(gridDim.x) * kRowsPerBlock;
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
      const void* trow = static_cast<const char*>(tail) + t * D * (CODEC == kFp16 ? 2 : 1);
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

// min / max that return a NaN operand, as torch's amin / amax / clamp_min
// do; fminf / fmaxf (which drop it) otherwise.
__device__ __forceinline__ float nan_min(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}

// The int8 code of x: q = clamp(rint((x - zp) / scale), -127, 127), a NaN
// kept through the clamp and cast as torch casts it (static_cast, NaN -> 0).
__device__ __forceinline__ signed char quantise(float x, float scale, float zp) {
  const float q = rintf(__fdiv_rn(__fsub_rn(x, zp), scale));
  return static_cast<signed char>(q != q ? q : fminf(fmaxf(q, -127.f), 127.f));
}

template <int CODEC, int HOST, bool VEC>
__global__ void __launch_bounds__(kThreads)
gather_decode_encode_kernel(const float* __restrict__ head, long long H,
                            const void* __restrict__ tail, long long T,
                            const float* __restrict__ side, const int* __restrict__ slots,
                            long long K, int D, void* __restrict__ payload,
                            float* __restrict__ out_side) {
  const int lane = threadIdx.x & 31;
  const long long stride = static_cast<long long>(gridDim.x) * kRowsPerBlock;
  for (long long r = static_cast<long long>(blockIdx.x) * kRowsPerBlock + (threadIdx.x >> 5);
       r < K; r += stride) {
    const Row<CODEC> row(head, H, tail, T, side, __ldg(slots + r), D);
    if (HOST == kFp16) {
      __half* o = static_cast<__half*>(payload) + r * D;
      if (VEC) {
        for (int c = lane; c < D / 4; c += 32) {
          const float4 v = row.get4(c);
          const __half2 a = __floats2half2_rn(v.x, v.y), b = __floats2half2_rn(v.z, v.w);
          uint2 u;
          u.x = *reinterpret_cast<const unsigned*>(&a);
          u.y = *reinterpret_cast<const unsigned*>(&b);
          reinterpret_cast<uint2*>(o)[c] = u;
        }
      } else {
        for (int c = lane; c < D; c += 32) o[c] = __float2half_rn(row.get1(c));
      }
      continue;
    }
    float mn = __int_as_float(0x7f800000), mx = -mn;  // +inf, -inf
    if (VEC) {
      for (int c = lane; c < D / 4; c += 32) {
        const float4 v = row.get4(c);
        mn = nan_min(nan_min(mn, v.x), nan_min(nan_min(v.y, v.z), v.w));
        mx = nan_max(nan_max(mx, v.x), nan_max(nan_max(v.y, v.z), v.w));
      }
    } else {
      for (int c = lane; c < D; c += 32) {
        const float v = row.get1(c);
        mn = nan_min(mn, v);
        mx = nan_max(mx, v);
      }
    }
#pragma unroll
    for (int off = 16; off; off >>= 1) {
      mn = nan_min(mn, __shfl_xor_sync(kFull, mn, off));
      mx = nan_max(mx, __shfl_xor_sync(kFull, mx, off));
    }
    // the codec's order: clamp_min(mx - mn, 1e-12) / 254, then 0.5 * (mx + mn)
    const float scale = __fdiv_rn(nan_max(__fsub_rn(mx, mn), static_cast<float>(1e-12)), 254.f);
    const float zp = __fmul_rn(0.5f, __fadd_rn(mx, mn));
    signed char* o = static_cast<signed char*>(payload) + r * D;
    if (VEC) {
      for (int c = lane; c < D / 4; c += 32) {
        const float4 v = row.get4(c);
        char4 q;
        q.x = quantise(v.x, scale, zp);
        q.y = quantise(v.y, scale, zp);
        q.z = quantise(v.z, scale, zp);
        q.w = quantise(v.w, scale, zp);
        reinterpret_cast<char4*>(o)[c] = q;
      }
    } else {
      for (int c = lane; c < D; c += 32) o[c] = quantise(row.get1(c), scale, zp);
    }
    if (lane == 0) {
      out_side[2 * r] = scale;
      out_side[2 * r + 1] = zp;
    }
  }
}

bool aligned(const void* p, uintptr_t n) { return reinterpret_cast<uintptr_t>(p) % n == 0; }

int grid(long long K) {
  const long long blocks = (K + kRowsPerBlock - 1) / kRowsPerBlock;
  return static_cast<int>(blocks < kMaxBlocks ? blocks : kMaxBlocks);
}

bool bad_args(const float* head, long long H, const void* tail, long long T,
              const float* sideband, const int* slots, long long K, int D, int codec) {
  return K <= 0 || D <= 0 || H < 0 || T < 0 || (codec != kFp16 && codec != kInt8) ||
         (H > 0 && head == nullptr) || (T > 0 && tail == nullptr) || slots == nullptr ||
         (codec == kInt8 && T > 0 && sideband == nullptr);
}

template <int CODEC, int HOST>
cudaError_t launch_encode(bool vec, cudaStream_t stream, const float* head, long long H,
                          const void* tail, long long T, const float* side, const int* slots,
                          long long K, int D, void* payload, float* out_side) {
  if (vec)
    gather_decode_encode_kernel<CODEC, HOST, true><<<grid(K), kThreads, 0, stream>>>(
        head, H, tail, T, side, slots, K, D, payload, out_side);
  else
    gather_decode_encode_kernel<CODEC, HOST, false><<<grid(K), kThreads, 0, stream>>>(
        head, H, tail, T, side, slots, K, D, payload, out_side);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry points (bound with ctypes).  Each takes its arguments as
// one struct of 8-byte fields, which the wrapper packs in one call (a
// ctypes call converts each argument on its own, and that cost the host
// more than the launch), and the stream.  head: fp32 [H, D]; tail: fp16 or
// int8 [T, D]; sideband: fp32 [T, 2] for int8, NULL for fp16; slots: int32
// [K]; all contiguous on the card.  codec: the tail's, 0 = fp16, 1 = int8.
// Each enqueues one launch on `stream`, never synchronises, and returns
// the CUDA error of the launch (0 on success); arguments it cannot take
// (sizes, codecs, a missing sideband) return cudaErrorInvalidValue and
// launch nothing.

struct GatherDecodeArgs {
  const float* head;
  long long H;
  const void* tail;
  long long T;
  const float* sideband;
  const int* slots;
  long long K;
  long long D;
  long long codec;
  void* out;  // gather_decode: fp32 [K, D]; gather_decode_encode: the payload
};

struct GatherDecodeEncodeArgs {
  GatherDecodeArgs g;
  long long host_codec;  // the host tier's, 0 = fp16, 1 = int8
  float* out_sideband;   // fp32 [K, 2] for an int8 host, NULL for fp16
};

// out: fp32 [K, D].
extern "C" int gather_decode(const GatherDecodeArgs* a, cudaStream_t stream) {
  const int D = static_cast<int>(a->D);
  if (a->D > (1 << 30) || a->codec < 0 || a->codec > 1 || a->out == nullptr ||
      bad_args(a->head, a->H, a->tail, a->T, a->sideband, a->slots, a->K, D,
               static_cast<int>(a->codec)))
    return static_cast<int>(cudaErrorInvalidValue);
  float* out = static_cast<float*>(a->out);
  const bool vec = D % 4 == 0 && aligned(a->head, 16) && aligned(out, 16) &&
                   aligned(a->tail, a->codec == kFp16 ? 8 : 4);
  if (a->codec == kFp16) {
    if (vec)
      gather_decode_kernel<kFp16, true><<<grid(a->K), kThreads, 0, stream>>>(
          a->head, a->H, a->tail, a->T, a->sideband, a->slots, a->K, D, out);
    else
      gather_decode_kernel<kFp16, false><<<grid(a->K), kThreads, 0, stream>>>(
          a->head, a->H, a->tail, a->T, a->sideband, a->slots, a->K, D, out);
  } else {
    if (vec)
      gather_decode_kernel<kInt8, true><<<grid(a->K), kThreads, 0, stream>>>(
          a->head, a->H, a->tail, a->T, a->sideband, a->slots, a->K, D, out);
    else
      gather_decode_kernel<kInt8, false><<<grid(a->K), kThreads, 0, stream>>>(
          a->head, a->H, a->tail, a->T, a->sideband, a->slots, a->K, D, out);
  }
  return static_cast<int>(cudaGetLastError());
}

// g.out: the payload, [K, D] of the host codec's dtype.
extern "C" int gather_decode_encode(const GatherDecodeEncodeArgs* a, cudaStream_t stream) {
  const GatherDecodeArgs& g = a->g;
  const int D = static_cast<int>(g.D);
  const int codec = static_cast<int>(g.codec), host = static_cast<int>(a->host_codec);
  if (g.D > (1 << 30) || g.codec < 0 || g.codec > 1 || g.out == nullptr ||
      bad_args(g.head, g.H, g.tail, g.T, g.sideband, g.slots, g.K, D, codec) ||
      (a->host_codec != kFp16 && a->host_codec != kInt8) ||
      (host == kInt8 && a->out_sideband == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = D % 4 == 0 && aligned(g.head, 16) && aligned(g.tail, codec == kFp16 ? 8 : 4) &&
                   aligned(g.out, host == kFp16 ? 8 : 4);
  cudaError_t err;
  if (codec == kFp16)
    err = host == kFp16
              ? launch_encode<kFp16, kFp16>(vec, stream, g.head, g.H, g.tail, g.T, g.sideband,
                                            g.slots, g.K, D, g.out, a->out_sideband)
              : launch_encode<kFp16, kInt8>(vec, stream, g.head, g.H, g.tail, g.T, g.sideband,
                                            g.slots, g.K, D, g.out, a->out_sideband);
  else
    err = host == kFp16
              ? launch_encode<kInt8, kFp16>(vec, stream, g.head, g.H, g.tail, g.T, g.sideband,
                                            g.slots, g.K, D, g.out, a->out_sideband)
              : launch_encode<kInt8, kInt8>(vec, stream, g.head, g.H, g.tail, g.T, g.sideband,
                                            g.slots, g.K, D, g.out, a->out_sideband);
  return static_cast<int>(err);
}
