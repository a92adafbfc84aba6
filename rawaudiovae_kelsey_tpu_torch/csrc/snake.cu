// SnakeBeta, the learnable periodic activation of the Oobleck VAE
// (models/variants.py), forward and backward, with a plain C interface for
// ctypes (ops/snake.py holds the wrappers, their plain PyTorch versions and
// the autograd Function).
//
//   rvk_snake_fwd  y = x + inv_c · sin²(A_c · x),   A_c = e^alpha_c,
//                  inv_c = 1 / (e^beta_c + 1e-9)
//   rvk_snake_bwd  dx = dy · (1 + inv_c · A_c · sin(2 A_c x))
//                  d alpha_c = inv_c · Σ dy · sin(2 t) · t,       t = A_c x
//                  d beta_c  = −inv_c² · e^beta_c · Σ dy · sin²(t)
//
// x, y, dy and dx are (B, C, L) contiguous, channel c the middle index, in
// one dtype (fp32 or bf16, code 0 or 1 as in gemm.cuh); alpha, beta and
// their gradients are (C,) in a dtype of their own.  The arithmetic is fp32
// (the precise sincosf and expf: this file must not be built with
// --use_fast_math), each output rounded once to its dtype.
//
// No TPU kernel of the JAX package has this op: it is a port-only kernel,
// row 21 of PERF.md's table.  Plain PyTorch runs the forward as five
// elementwise passes and autograd the backward as about eight, saving
// A·x, sin(A·x) and sin² beside x; here each direction is one launch and
// only x is kept for the backward.
//
// What bounds both: bytes, at 2 + 2 (forward) and 2 + 2 + 2 (backward)
// bytes an element in bf16.  The per-element arithmetic (one sincosf, about
// 20 fp32 instructions on its fast path, and a few FMAs) is under the
// issue budget those bytes leave (about 35 instructions an element for the
// forward and 50 for the backward at 3.35 TB/s over 132 SMs).  So every
// thread reads and writes 16-byte vectors of 8 elements, which share one
// channel when L is a multiple of 8, and computes the channel's two
// constants once a chunk.
//
// The backward's two sums per channel: the grid is (splits, C), block (s,
// c) walking its share of channel c's B·L elements in chunks of 8 with a
// stride of one block, each thread adding into two fp32 sums in order; the
// block folds its threads' sums in a fixed order and writes one partial per
// sum.  With splits > 1 the last block of a channel to finish (a counter
// per channel, taken with atomicAdd and put back to 0 by that block) adds
// the channel's partials in split order.  The splits are the caller's, a
// function of the shape alone, so the order of every addition is a
// function of the shapes alone: the same bits on every run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 8;  // elements a thread takes at a time

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void from_f32(float v, float* p) { *p = v; }
__device__ __forceinline__ void from_f32(float v, bf16* p) {
  *p = __float2bfloat16_rn(v);
}

// Chunk at p (8 elements on a 16-byte boundary) as fp32.
__device__ __forceinline__ void load8(const float* p, float (&v)[kChunk]) {
  const float4 a = __ldcs(reinterpret_cast<const float4*>(p));
  const float4 b = __ldcs(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const bf16* p, float (&v)[kChunk]) {
  // a bf16 is the top half of its fp32: element 2 i is the low half of word
  // i, element 2 i + 1 the high half
  const uint4 raw = __ldcs(reinterpret_cast<const uint4*>(p));
  const unsigned w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
  }
}

__device__ __forceinline__ void store8(float* p, const float (&v)[kChunk]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ unsigned bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

__device__ __forceinline__ void store8(bf16* p, const float (&v)[kChunk]) {
  uint4 raw;
  raw.x = bf16_bits(v[0]) | (bf16_bits(v[1]) << 16);
  raw.y = bf16_bits(v[2]) | (bf16_bits(v[3]) << 16);
  raw.z = bf16_bits(v[4]) | (bf16_bits(v[5]) << 16);
  raw.w = bf16_bits(v[6]) | (bf16_bits(v[7]) << 16);
  *reinterpret_cast<uint4*>(p) = raw;
}

// The channel's constants: A = e^alpha, inv = 1 / (e^beta + 1e-9), and e^beta.
template <typename TP>
__device__ __forceinline__ void constants(const TP* alpha, const TP* beta,
                                          int c, float& a, float& inv,
                                          float& eb) {
  a = expf(to_f32(alpha[c]));
  eb = expf(to_f32(beta[c]));
  inv = __fdiv_rn(1.f, __fadd_rn(eb, 1e-9f));
}

// One element of the forward, explicit roundings so that the vector and
// the scalar path give the same bits.
__device__ __forceinline__ float snake_of(float x, float a, float inv) {
  const float s = sinf(__fmul_rn(a, x));
  return __fadd_rn(x, __fmul_rn(inv, __fmul_rn(s, s)));
}

// One element of the backward: dx, and the two summands.
__device__ __forceinline__ float snake_grad(float x, float dy, float a,
                                            float inv, float& sa, float& sb) {
  const float t = __fmul_rn(a, x);
  float s, c;
  sincosf(t, &s, &c);
  const float s2t = __fmul_rn(2.f, __fmul_rn(s, c));  // sin(2 t)
  sa = fmaf(__fmul_rn(dy, s2t), t, sa);
  sb = fmaf(dy, __fmul_rn(s, s), sb);
  return __fmul_rn(dy, fmaf(__fmul_rn(inv, a), s2t, 1.f));
}

// Forward, vector path (L a multiple of 8, 16-byte aligned pointers):
// chunks with a grid stride; chunk k lies in channel (8 k / L) mod C.
template <typename TX, typename TP>
__global__ void __launch_bounds__(kThreads)
snake_fwd_vec(const TX* __restrict__ x, const TP* __restrict__ alpha,
              const TP* __restrict__ beta, TX* __restrict__ y,
              long long chunks, int channels, int chunks_per_row) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long k = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       k < chunks; k += stride) {
    const int c = static_cast<int>((k / chunks_per_row) % channels);
    float a, inv, eb;
    constants(alpha, beta, c, a, inv, eb);
    float v[kChunk];
    load8(x + k * kChunk, v);
#pragma unroll
    for (int j = 0; j < kChunk; ++j) v[j] = snake_of(v[j], a, inv);
    store8(y + k * kChunk, v);
  }
}

// Forward, scalar path (any L, any alignment): one element at a time.
template <typename TX, typename TP>
__global__ void __launch_bounds__(kThreads)
snake_fwd_scalar(const TX* __restrict__ x, const TP* __restrict__ alpha,
                 const TP* __restrict__ beta, TX* __restrict__ y,
                 long long n, int channels, int length) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       i < n; i += stride) {
    const int c = static_cast<int>((i / length) % channels);
    float a, inv, eb;
    constants(alpha, beta, c, a, inv, eb);
    from_f32(snake_of(to_f32(x[i]), a, inv), y + i);
  }
}

// Sum of v over the block's threads, in a fixed order; valid in thread 0.
__device__ __forceinline__ float block_sum(float v, float* warp_sums) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_down_sync(0xFFFFFFFFu, v, off);
  }
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  float total = 0.f;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total += warp_sums[w];
  }
  __syncthreads();  // warp_sums is free for the next call
  return total;
}

// Backward: block (s, c) takes split s of channel c's B·L elements.  kVec:
// units are chunks of 8 (L a multiple of 8, aligned pointers), else single
// elements.  Unit u of the channel is row u / units_per_row, at
// (row · C + c) · L + (u mod units_per_row) · width.
template <typename TX, typename TP, bool kVec>
__global__ void __launch_bounds__(kThreads)
snake_bwd(const TX* __restrict__ x, const TP* __restrict__ alpha,
          const TP* __restrict__ beta, const TX* __restrict__ dy,
          TX* __restrict__ dx, TP* __restrict__ d_alpha,
          TP* __restrict__ d_beta, float* __restrict__ partials,
          unsigned* __restrict__ counters, int rows, int channels,
          int length) {
  __shared__ float warp_sums[kWarps];
  __shared__ bool last;
  constexpr int kWidth = kVec ? kChunk : 1;
  const int c = blockIdx.y, split = blockIdx.x, splits = gridDim.x;
  const int units_per_row = length / kWidth;
  const long long units = static_cast<long long>(rows) * units_per_row;
  const long long per = (units + splits - 1) / splits;
  const long long lo = split * per;
  const long long hi = lo + per < units ? lo + per : units;
  float a, inv, eb;
  constants(alpha, beta, c, a, inv, eb);
  float sa = 0.f, sb = 0.f;
  for (long long u = lo + threadIdx.x; u < hi; u += kThreads) {
    const long long row = u / units_per_row;
    const long long at = (row * channels + c) * length +
                         (u - row * units_per_row) * kWidth;
    if (kVec) {
      float xv[kChunk], g[kChunk];
      load8(x + at, xv);
      load8(dy + at, g);
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        g[j] = snake_grad(xv[j], g[j], a, inv, sa, sb);
      }
      store8(dx + at, g);
    } else {
      from_f32(snake_grad(to_f32(x[at]), to_f32(dy[at]), a, inv, sa, sb),
               dx + at);
    }
  }
  sa = block_sum(sa, warp_sums);
  sb = block_sum(sb, warp_sums);
  if (splits == 1) {
    if (threadIdx.x == 0) {
      from_f32(__fmul_rn(inv, sa), d_alpha + c);
      from_f32(__fmul_rn(-__fmul_rn(__fmul_rn(inv, inv), eb), sb),
               d_beta + c);
    }
    return;
  }
  if (threadIdx.x == 0) {
    float* mine = partials + 2 * (static_cast<long long>(c) * splits + split);
    mine[0] = sa;
    mine[1] = sb;
    __threadfence();  // the partials before the count that publishes them
    last = atomicAdd(counters + c, 1u) == static_cast<unsigned>(splits - 1);
  }
  __syncthreads();
  if (last && threadIdx.x == 0) {
    __threadfence();
    const float* all = partials + 2 * static_cast<long long>(c) * splits;
    float ta = 0.f, tb = 0.f;
    for (int s = 0; s < splits; ++s) {
      ta += __ldcg(all + 2 * s);
      tb += __ldcg(all + 2 * s + 1);
    }
    from_f32(__fmul_rn(inv, ta), d_alpha + c);
    from_f32(__fmul_rn(-__fmul_rn(__fmul_rn(inv, inv), eb), tb), d_beta + c);
    counters[c] = 0u;  // ready for the next launch
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<std::uintptr_t>(p) & 15) == 0;
}

template <typename TX, typename TP>
cudaError_t fwd(const void* x, const void* alpha, const void* beta, void* y,
                int rows, int channels, int length, int blocks,
                cudaStream_t s) {
  const TX* xx = static_cast<const TX*>(x);
  const TP* a = static_cast<const TP*>(alpha);
  const TP* b = static_cast<const TP*>(beta);
  TX* yy = static_cast<TX*>(y);
  const long long n = static_cast<long long>(rows) * channels * length;
  if (length % kChunk == 0 && aligned16(x) && aligned16(y)) {
    snake_fwd_vec<TX, TP><<<blocks, kThreads, 0, s>>>(
        xx, a, b, yy, n / kChunk, channels, length / kChunk);
  } else {
    snake_fwd_scalar<TX, TP><<<blocks, kThreads, 0, s>>>(
        xx, a, b, yy, n, channels, length);
  }
  return cudaGetLastError();
}

template <typename TX, typename TP>
cudaError_t bwd(const void* x, const void* alpha, const void* beta,
                const void* dy, void* dx, void* d_alpha, void* d_beta,
                float* partials, unsigned* counters, int rows, int channels,
                int length, int splits, cudaStream_t s) {
  const TX* xx = static_cast<const TX*>(x);
  const TP* a = static_cast<const TP*>(alpha);
  const TP* b = static_cast<const TP*>(beta);
  const TX* g = static_cast<const TX*>(dy);
  TX* dxx = static_cast<TX*>(dx);
  TP* da = static_cast<TP*>(d_alpha);
  TP* db = static_cast<TP*>(d_beta);
  const dim3 grid(splits, channels);
  if (length % kChunk == 0 && aligned16(x) && aligned16(dy) &&
      aligned16(dx)) {
    snake_bwd<TX, TP, true><<<grid, kThreads, 0, s>>>(
        xx, a, b, g, dxx, da, db, partials, counters, rows, channels, length);
  } else {
    snake_bwd<TX, TP, false><<<grid, kThreads, 0, s>>>(
        xx, a, b, g, dxx, da, db, partials, counters, rows, channels, length);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x and y: (rows, channels, length) of dtype_x; alpha, beta: (channels,) of
// dtype_p (0 = fp32, 1 = bf16).  blocks >= 1: the grid, any size.
int rvk_snake_fwd(const void* x, const void* alpha, const void* beta, void* y,
                  int rows, int channels, int length, int blocks, int dtype_x,
                  int dtype_p, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (blocks < 1 || rows < 0 || channels < 1 || length < 1) {
    return cudaErrorInvalidValue;
  }
  if (rows == 0) return cudaSuccess;
  if (dtype_x == 0 && dtype_p == 0) {
    return fwd<float, float>(x, alpha, beta, y, rows, channels, length,
                             blocks, s);
  }
  if (dtype_x == 1 && dtype_p == 0) {
    return fwd<bf16, float>(x, alpha, beta, y, rows, channels, length, blocks,
                            s);
  }
  if (dtype_x == 1 && dtype_p == 1) {
    return fwd<bf16, bf16>(x, alpha, beta, y, rows, channels, length, blocks,
                           s);
  }
  if (dtype_x == 0 && dtype_p == 1) {
    return fwd<float, bf16>(x, alpha, beta, y, rows, channels, length, blocks,
                            s);
  }
  return cudaErrorInvalidValue;
}

// x, dy and dx: (rows, channels, length) of dtype_x; alpha, beta, d_alpha
// and d_beta: (channels,) of dtype_p.  partials: scratch of 2 · channels ·
// splits floats; counters: channels unsigned ints, 0 on entry and on exit
// (unused at splits = 1).  splits >= 1 is the caller's choice and fixes the
// order of the additions.
int rvk_snake_bwd(const void* x, const void* alpha, const void* beta,
                  const void* dy, void* dx, void* d_alpha, void* d_beta,
                  float* partials, unsigned* counters, int rows, int channels,
                  int length, int splits, int dtype_x, int dtype_p,
                  void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (splits < 1 || rows < 1 || channels < 1 || channels > 65535 ||
      length < 1) {
    return cudaErrorInvalidValue;
  }
  if (dtype_x == 0 && dtype_p == 0) {
    return bwd<float, float>(x, alpha, beta, dy, dx, d_alpha, d_beta,
                             partials, counters, rows, channels, length,
                             splits, s);
  }
  if (dtype_x == 1 && dtype_p == 0) {
    return bwd<bf16, float>(x, alpha, beta, dy, dx, d_alpha, d_beta, partials,
                            counters, rows, channels, length, splits, s);
  }
  if (dtype_x == 1 && dtype_p == 1) {
    return bwd<bf16, bf16>(x, alpha, beta, dy, dx, d_alpha, d_beta, partials,
                           counters, rows, channels, length, splits, s);
  }
  if (dtype_x == 0 && dtype_p == 1) {
    return bwd<float, bf16>(x, alpha, beta, dy, dx, d_alpha, d_beta, partials,
                            counters, rows, channels, length, splits, s);
  }
  return cudaErrorInvalidValue;
}

}  // extern "C"
