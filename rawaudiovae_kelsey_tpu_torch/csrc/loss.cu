// The VAE loss's two reductions in one pass, with a plain C interface for
// ctypes (ops/loss.py holds the wrapper, the plain PyTorch version and the
// autograd Functions).
//
//   rvk_loss_sums   sq = Σ (recon − x)²   and   kl = Σ (1 + logvar − mu² −
//                   e^logvar), both fp32, from fp32 or bf16 inputs
//
// It replaces the TPU kernel _loss_sums (_loss_kernel) of
// rawaudiovae_kelsey_tpu/ops/pallas_loss.py, which walks the batch tiles as
// a sequential grid and adds each tile's sums into one SMEM cell per term,
// with the rows padded to its 128-row tile.  Blocks here run in no order, so
// the sum is two stages: every block walks its share of the elements with a
// grid stride (neighbouring threads on neighbouring addresses; the tail is
// masked, nothing is padded), folds its threads' sums by warp shuffles and
// shared memory, and writes one partial per term; then a single block adds
// the partials in a fixed order.  No float atomics: for a given shape the
// grid, and so the order of every addition, is fixed, and two runs give the
// same bits.  All arithmetic is fp32; expf is the precise one (this file
// must not be built with --use_fast_math).
//
// What bounds it: bytes.  At (4096, 1024) + (4096, 256) fp32 it reads 42 MB
// for 13 M additions and 1 M exponentials — 12.5 µs at 3.35 TB/s, of the
// order of the two launches themselves.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

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
template <typename T>
__global__ void __launch_bounds__(kThreads)
loss_partials(const T* recon, const T* x, const T* mu, const T* logvar,
              long long n_x, long long n_l, float* partials) {
  __shared__ float warp_sums[kWarps];
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long first =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  float sq = 0.f, kl = 0.f;
  for (long long i = first; i < n_x; i += stride) {
    const float d = to_f32(recon[i]) - to_f32(x[i]);
    sq += d * d;
  }
  for (long long i = first; i < n_l; i += stride) {
    const float m = to_f32(mu[i]), lv = to_f32(logvar[i]);
    kl += 1.f + lv - m * m - expf(lv);
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

template <typename T>
cudaError_t loss_sums(const void* recon, const void* x, const void* mu,
                      const void* logvar, float* partials, float* out,
                      long long n_x, long long n_l, int n_blocks,
                      cudaStream_t s) {
  loss_partials<T><<<n_blocks, kThreads, 0, s>>>(
      static_cast<const T*>(recon), static_cast<const T*>(x),
      static_cast<const T*>(mu), static_cast<const T*>(logvar), n_x, n_l,
      partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  loss_finish<<<1, kThreads, 0, s>>>(partials, n_blocks, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// recon and x: n_x elements; mu and logvar: n_l elements; all four of one
// dtype (0 = fp32, 1 = bf16, the codes of gemm.cuh); partials: scratch of
// 2 * n_blocks floats; out: two floats, (sq, kl).  n_blocks >= 1 is the
// caller's choice and fixes the order of the additions.
int rvk_loss_sums(const void* recon, const void* x, const void* mu,
                  const void* logvar, float* partials, float* out,
                  long long n_x, long long n_l, int n_blocks, int dtype,
                  void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_blocks < 1) return cudaErrorInvalidValue;
  if (dtype == 0) {
    return loss_sums<float>(recon, x, mu, logvar, partials, out, n_x, n_l,
                            n_blocks, s);
  }
  if (dtype == 1) {
    return loss_sums<bf16>(recon, x, mu, logvar, partials, out, n_x, n_l,
                           n_blocks, s);
  }
  return cudaErrorInvalidValue;
}

}  // extern "C"
