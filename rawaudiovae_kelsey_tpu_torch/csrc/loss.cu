// The VAE loss MSE + β·KL of the train step, forward and backward, with a
// plain C interface for ctypes (ops/loss.py holds the wrappers, their plain
// PyTorch versions and the autograd Functions).
//
//   rvk_loss_sums   sq = Σ (recon − x)²   and   kl = Σ (1 + logvar − mu² −
//                   e^logvar), both fp32
//   rvk_loss_grads  d recon  = (scale_x · (recon − x)) · g_m
//                   d mu     = (scale_mu · mu) · g_k
//                   d logvar = (scale_lv · (e^logvar − 1)) · g_k
//                   each rounded once to its input's dtype; g_m and g_k are
//                   fp32 scalars in device memory, the scales fp32 values
//                   (2 / n_x, 1 / n_l, 1 / (2 n_l) under a mean, 2, 1, 1/2
//                   under a sum)
//
// recon and x share one dtype, mu and logvar another: fp32 and fp32, bf16
// and fp32 (the bf16 train step's) or bf16 and bf16 (0 = fp32, 1 = bf16,
// the codes of gemm.cuh), brought to fp32 in registers: no operand is
// copied to fp32 in device memory.
//
// rvk_loss_sums replaces the TPU kernel _loss_sums (_loss_kernel) of
// rawaudiovae_kelsey_tpu/ops/pallas_loss.py, which walks the batch tiles as
// a sequential grid and adds each tile's sums into one SMEM cell per term,
// with the rows padded to its 128-row tile.  rvk_loss_grads replaces the
// elementwise backward that the JAX package's custom_vjp
// (pallas_loss.py:145-159) leaves to XLA, where PyTorch would run it as
// about five passes over the reconstruction.
//
// What bounds both: bytes.  At the train step's (131072, 1024) bf16
// reconstruction and target and (131072, 256) fp32 mu and logvar, the sums
// read 805 MB (0.240 ms at 3.35 TB/s) and the gradients read those 805 MB
// and write 537 MB (0.401 ms).  So every thread reads 16-byte vectors,
// neighbouring threads on neighbouring addresses, keeps kUnroll chunks of
// each operand in flight before it adds, and writes 16-byte vectors; the
// exponentials (precise expf: this file must not be built with
// --use_fast_math) are far below the bytes' time.
//
// The sums: blocks run in no order, so they take two stages.  Every thread
// walks chunks of kChunk = 8 elements with a grid stride, whatever the
// dtype (a bf16 chunk is one 16-byte load, an fp32 chunk two), adds each
// chunk's elements in order into one fp32 sum per term, then the n mod 8
// elements past the last chunk are added by the grid's first thread; a
// block folds its threads' sums by warp shuffles and shared memory and
// writes one partial per term; a single block adds the partials in a fixed
// order.  No float atomics.  The grid is the caller's, a function of the
// shape alone, so the order of every addition is a function of the shapes
// alone: the same bits on every run, bf16 operands the same bits as their
// fp32 copies, and a view not on a 16-byte boundary (scalar loads, the same
// order) the same bits as an aligned copy.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 8;   // elements a thread takes at a time
constexpr int kUnroll = 2;  // chunks of each operand in flight a thread

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void from_f32(float v, float* p) { *p = v; }
__device__ __forceinline__ void from_f32(float v, bf16* p) {
  *p = __float2bfloat16_rn(v);
}

// Chunk c of p (elements 8 c .. 8 c + 7) as fp32.  kVec: p lies on a 16-byte
// boundary, one (bf16) or two (fp32) streaming 16-byte loads; otherwise
// eight scalar loads.
template <bool kVec>
__device__ __forceinline__ void load_chunk(const float* p, long long c,
                                           float (&v)[kChunk]) {
  p += c * kChunk;
  if (kVec) {
    const float4 a = __ldcs(reinterpret_cast<const float4*>(p));
    const float4 b = __ldcs(reinterpret_cast<const float4*>(p) + 1);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
#pragma unroll
    for (int j = 0; j < kChunk; ++j) v[j] = p[j];
  }
}

template <bool kVec>
__device__ __forceinline__ void load_chunk(const bf16* p, long long c,
                                           float (&v)[kChunk]) {
  p += c * kChunk;
  if (kVec) {
    // a bf16 is the top half of its fp32: element 2 i is the low half of
    // word i, element 2 i + 1 the high half
    const uint4 raw = __ldcs(reinterpret_cast<const uint4*>(p));
    const unsigned w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
    }
  } else {
#pragma unroll
    for (int j = 0; j < kChunk; ++j) v[j] = __bfloat162float(p[j]);
  }
}

// Chunk c of p from fp32, each element rounded once to p's dtype.
template <bool kVec>
__device__ __forceinline__ void store_chunk(float* p, long long c,
                                            const float (&v)[kChunk]) {
  p += c * kChunk;
  if (kVec) {
    reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
  } else {
#pragma unroll
    for (int j = 0; j < kChunk; ++j) p[j] = v[j];
  }
}

__device__ __forceinline__ unsigned bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

template <bool kVec>
__device__ __forceinline__ void store_chunk(bf16* p, long long c,
                                            const float (&v)[kChunk]) {
  p += c * kChunk;
  if (kVec) {
    uint4 raw;
    raw.x = bf16_bits(v[0]) | (bf16_bits(v[1]) << 16);
    raw.y = bf16_bits(v[2]) | (bf16_bits(v[3]) << 16);
    raw.z = bf16_bits(v[4]) | (bf16_bits(v[5]) << 16);
    raw.w = bf16_bits(v[6]) | (bf16_bits(v[7]) << 16);
    *reinterpret_cast<uint4*>(p) = raw;
  } else {
#pragma unroll
    for (int j = 0; j < kChunk; ++j) p[j] = __float2bfloat16_rn(v[j]);
  }
}

// One element of each sum: explicit roundings, so that the compiler's
// contraction cannot make the vector and the scalar path differ.
__device__ __forceinline__ float add_sq(float acc, float r, float x) {
  const float d = __fsub_rn(r, x);
  return fmaf(d, d, acc);
}

__device__ __forceinline__ float add_kl(float acc, float m, float lv) {
  const float t = __fsub_rn(__fsub_rn(__fadd_rn(1.f, lv), __fmul_rn(m, m)),
                            expf(lv));
  return __fadd_rn(acc, t);
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

// Stage 1: partials[2 b] = block b's share of sq, partials[2 b + 1] of kl.
template <typename TX, typename TL, bool kVec>
__global__ void __launch_bounds__(kThreads)
loss_partials(const TX* __restrict__ recon, const TX* __restrict__ x,
              const TL* __restrict__ mu, const TL* __restrict__ logvar,
              long long n_x, long long n_l, float* __restrict__ partials) {
  __shared__ float warp_sums[kWarps];
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long first =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long chunks_x = n_x / kChunk, chunks_l = n_l / kChunk;
  float sq = 0.f, kl = 0.f;
  for (long long c = first; c < chunks_x; c += kUnroll * stride) {
    float r[kUnroll][kChunk], v[kUnroll][kChunk];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (c + u * stride < chunks_x) {
        load_chunk<kVec>(recon, c + u * stride, r[u]);
        load_chunk<kVec>(x, c + u * stride, v[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (c + u * stride < chunks_x) {
#pragma unroll
        for (int j = 0; j < kChunk; ++j) sq = add_sq(sq, r[u][j], v[u][j]);
      }
    }
  }
  for (long long c = first; c < chunks_l; c += kUnroll * stride) {
    float m[kUnroll][kChunk], lv[kUnroll][kChunk];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (c + u * stride < chunks_l) {
        load_chunk<kVec>(mu, c + u * stride, m[u]);
        load_chunk<kVec>(logvar, c + u * stride, lv[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (c + u * stride < chunks_l) {
#pragma unroll
        for (int j = 0; j < kChunk; ++j) kl = add_kl(kl, m[u][j], lv[u][j]);
      }
    }
  }
  if (first == 0) {  // the masked tails, fewer than kChunk elements each
    for (long long i = chunks_x * kChunk; i < n_x; ++i) {
      sq = add_sq(sq, to_f32(recon[i]), to_f32(x[i]));
    }
    for (long long i = chunks_l * kChunk; i < n_l; ++i) {
      kl = add_kl(kl, to_f32(mu[i]), to_f32(logvar[i]));
    }
  }
  sq = block_sum(sq, warp_sums);
  kl = block_sum(kl, warp_sums);
  if (threadIdx.x == 0) {
    partials[2 * blockIdx.x] = sq;
    partials[2 * blockIdx.x + 1] = kl;
  }
}

// Stage 2, one block: out[0] = Σ_b partials[2 b], out[1] = Σ_b
// partials[2 b + 1]; thread t takes blocks t, t + 256, ... in order.
__global__ void __launch_bounds__(kThreads)
loss_finish(const float* partials, int n_blocks, float* out) {
  __shared__ float warp_sums[kWarps];
  float sq = 0.f, kl = 0.f;
  for (int b = threadIdx.x; b < n_blocks; b += kThreads) {
    sq += partials[2 * b];
    kl += partials[2 * b + 1];
  }
  sq = block_sum(sq, warp_sums);
  kl = block_sum(kl, warp_sums);
  if (threadIdx.x == 0) {
    out[0] = sq;
    out[1] = kl;
  }
}

// The closed-form gradients, elementwise: chunks with a grid stride, then
// the tails, one element a thread.
template <typename TX, typename TL, bool kVec>
__global__ void __launch_bounds__(kThreads)
loss_grads(const TX* __restrict__ recon, const TX* __restrict__ x,
           const TL* __restrict__ mu, const TL* __restrict__ logvar,
           const float* __restrict__ g_m, const float* __restrict__ g_k,
           TX* __restrict__ d_recon, TL* __restrict__ d_mu,
           TL* __restrict__ d_logvar, long long n_x, long long n_l,
           float scale_x, float scale_mu, float scale_lv) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long first =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long chunks_x = n_x / kChunk, chunks_l = n_l / kChunk;
  const float gm = *g_m, gk = *g_k;
  for (long long c = first; c < chunks_x; c += kUnroll * stride) {
    float r[kUnroll][kChunk], v[kUnroll][kChunk];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (c + u * stride < chunks_x) {
        load_chunk<kVec>(recon, c + u * stride, r[u]);
        load_chunk<kVec>(x, c + u * stride, v[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (c + u * stride < chunks_x) {
#pragma unroll
        for (int j = 0; j < kChunk; ++j) {
          r[u][j] = __fmul_rn(__fmul_rn(scale_x, __fsub_rn(r[u][j], v[u][j])),
                              gm);
        }
        store_chunk<kVec>(d_recon, c + u * stride, r[u]);
      }
    }
  }
  for (long long c = first; c < chunks_l; c += kUnroll * stride) {
    float m[kUnroll][kChunk], lv[kUnroll][kChunk];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (c + u * stride < chunks_l) {
        load_chunk<kVec>(mu, c + u * stride, m[u]);
        load_chunk<kVec>(logvar, c + u * stride, lv[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (c + u * stride < chunks_l) {
#pragma unroll
        for (int j = 0; j < kChunk; ++j) {
          m[u][j] = __fmul_rn(__fmul_rn(scale_mu, m[u][j]), gk);
          lv[u][j] = __fmul_rn(
              __fmul_rn(scale_lv, __fsub_rn(expf(lv[u][j]), 1.f)), gk);
        }
        store_chunk<kVec>(d_mu, c + u * stride, m[u]);
        store_chunk<kVec>(d_logvar, c + u * stride, lv[u]);
      }
    }
  }
  const long long i = chunks_x * kChunk + first;
  if (i < n_x) {
    from_f32(__fmul_rn(__fmul_rn(scale_x, __fsub_rn(to_f32(recon[i]),
                                                    to_f32(x[i]))), gm),
             d_recon + i);
  }
  const long long k = chunks_l * kChunk + first;
  if (k < n_l) {
    from_f32(__fmul_rn(__fmul_rn(scale_mu, to_f32(mu[k])), gk), d_mu + k);
    from_f32(__fmul_rn(__fmul_rn(scale_lv,
                                 __fsub_rn(expf(to_f32(logvar[k])), 1.f)),
                       gk),
             d_logvar + k);
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<std::uintptr_t>(p) & 15) == 0;
}

template <typename TX, typename TL>
cudaError_t sums(const void* recon, const void* x, const void* mu,
                 const void* logvar, float* partials, float* out,
                 long long n_x, long long n_l, int n_blocks, cudaStream_t s) {
  const TX* r = static_cast<const TX*>(recon);
  const TX* xx = static_cast<const TX*>(x);
  const TL* m = static_cast<const TL*>(mu);
  const TL* lv = static_cast<const TL*>(logvar);
  if (aligned16(recon) && aligned16(x) && aligned16(mu) && aligned16(logvar)) {
    loss_partials<TX, TL, true><<<n_blocks, kThreads, 0, s>>>(
        r, xx, m, lv, n_x, n_l, partials);
  } else {
    loss_partials<TX, TL, false><<<n_blocks, kThreads, 0, s>>>(
        r, xx, m, lv, n_x, n_l, partials);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  loss_finish<<<1, kThreads, 0, s>>>(partials, n_blocks, out);
  return cudaGetLastError();
}

template <typename TX, typename TL>
cudaError_t grads(const void* recon, const void* x, const void* mu,
                  const void* logvar, const float* g_m, const float* g_k,
                  void* d_recon, void* d_mu, void* d_logvar, long long n_x,
                  long long n_l, float scale_x, float scale_mu,
                  float scale_lv, int n_blocks, cudaStream_t s) {
  const TX* r = static_cast<const TX*>(recon);
  const TX* xx = static_cast<const TX*>(x);
  const TL* m = static_cast<const TL*>(mu);
  const TL* lv = static_cast<const TL*>(logvar);
  TX* dr = static_cast<TX*>(d_recon);
  TL* dm = static_cast<TL*>(d_mu);
  TL* dl = static_cast<TL*>(d_logvar);
  if (aligned16(recon) && aligned16(x) && aligned16(mu) &&
      aligned16(logvar) && aligned16(d_recon) && aligned16(d_mu) &&
      aligned16(d_logvar)) {
    loss_grads<TX, TL, true><<<n_blocks, kThreads, 0, s>>>(
        r, xx, m, lv, g_m, g_k, dr, dm, dl, n_x, n_l, scale_x, scale_mu,
        scale_lv);
  } else {
    loss_grads<TX, TL, false><<<n_blocks, kThreads, 0, s>>>(
        r, xx, m, lv, g_m, g_k, dr, dm, dl, n_x, n_l, scale_x, scale_mu,
        scale_lv);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// recon and x: n_x elements of dtype_x; mu and logvar: n_l elements of
// dtype_l (0 = fp32, 1 = bf16; not fp32 recon with bf16 mu); partials:
// scratch of 2 * n_blocks floats;
// out: two floats, (sq, kl).  n_blocks >= 1 is the caller's choice and
// fixes the order of the additions.
int rvk_loss_sums(const void* recon, const void* x, const void* mu,
                  const void* logvar, float* partials, float* out,
                  long long n_x, long long n_l, int n_blocks, int dtype_x,
                  int dtype_l, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_blocks < 1 || n_x < 0 || n_l < 0) return cudaErrorInvalidValue;
  if (dtype_x == 0 && dtype_l == 0) {
    return sums<float, float>(recon, x, mu, logvar, partials, out, n_x, n_l,
                              n_blocks, s);
  }
  if (dtype_x == 1 && dtype_l == 0) {
    return sums<bf16, float>(recon, x, mu, logvar, partials, out, n_x, n_l,
                             n_blocks, s);
  }
  if (dtype_x == 1 && dtype_l == 1) {
    return sums<bf16, bf16>(recon, x, mu, logvar, partials, out, n_x, n_l,
                            n_blocks, s);
  }
  return cudaErrorInvalidValue;
}

// recon, x and d_recon: n_x elements of dtype_x; mu, logvar, d_mu and
// d_logvar: n_l elements of dtype_l; g_m and g_k: one fp32 each, read on
// the device (no host sync).  n_blocks >= 1: the grid, any size.
int rvk_loss_grads(const void* recon, const void* x, const void* mu,
                   const void* logvar, const float* g_m, const float* g_k,
                   void* d_recon, void* d_mu, void* d_logvar, long long n_x,
                   long long n_l, float scale_x, float scale_mu,
                   float scale_lv, int n_blocks, int dtype_x, int dtype_l,
                   void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_blocks < 1 || n_x < 0 || n_l < 0) return cudaErrorInvalidValue;
  if (dtype_x == 0 && dtype_l == 0) {
    return grads<float, float>(recon, x, mu, logvar, g_m, g_k, d_recon, d_mu,
                               d_logvar, n_x, n_l, scale_x, scale_mu,
                               scale_lv, n_blocks, s);
  }
  if (dtype_x == 1 && dtype_l == 0) {
    return grads<bf16, float>(recon, x, mu, logvar, g_m, g_k, d_recon, d_mu,
                              d_logvar, n_x, n_l, scale_x, scale_mu,
                              scale_lv, n_blocks, s);
  }
  if (dtype_x == 1 && dtype_l == 1) {
    return grads<bf16, bf16>(recon, x, mu, logvar, g_m, g_k, d_recon, d_mu,
                             d_logvar, n_x, n_l, scale_x, scale_mu,
                             scale_lv, n_blocks, s);
  }
  return cudaErrorInvalidValue;
}

}  // extern "C"
