// The ordered sum of a product's slices, shared by the two mainloops that
// cut a contraction into slices: the bf16 tensor-core one (wgmma.cuh
// launch_wgrad_outs) and the fp32 one of the CUDA cores (sgemm.cuh
// launch_wgrad and launch_fwd).
//
// A weight gradient dW = aᵀ b over a batch of K rows whose grid of output
// tiles is small (dW3 at the training microbatch is 256 x 2048) cuts the
// batch into slices, each slice a whole dW and its column sums written to
// a workspace; this kernel then adds the slices in slice order.  No
// atomics, so two launches give equal bits.  It reads split · (M·N + N)
// floats and writes M·N + N an output: memory-bound, a few microseconds at
// the training microbatch's shapes on an H100.  A forward product whose
// contraction was cut into slices (the fp32 encoder and decoder at the
// server's batch) is added the same way by slices_epilogue, which then adds
// the bias and applies the activation.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

#include "gemm.cuh"

namespace rvk {
namespace {

// the most outputs one launch writes side by side (grad_accum2's two heads,
// the encoder's two heads)
constexpr int kMaxOuts = 2;

// Where each output's sums go: dW (M, N) row-major and db (N,).
struct SliceOut {
  float* dw[kMaxOuts];
  float* db[kMaxOuts];
};

// p[o] for a run-time o < kMaxOuts, by selects: an array in a kernel's
// parameters indexed at run time would be copied to local memory.
template <typename T>
__device__ __forceinline__ T* pick(T* const (&p)[kMaxOuts], int o) {
  T* out = p[0];
#pragma unroll
  for (int i = 1; i < kMaxOuts; ++i) {
    if (o == i) out = p[i];
  }
  return out;
}

// For each output o < outs and i < M·N + N: the sum over slices s, in
// order, of src[(o · slices + s) · (M·N + N) + i]; the first M·N values go
// to out.dw[o], the next N to out.db[o] (dropped where out.db[o] is null:
// a 3-pass weight gradient's db comes from the split pass).  Four floats a
// thread: mn and n multiples of 4 (a quad never straddles dW and db, or two
// outputs), everything 16-byte aligned.
__global__ void sum_slices(const float* __restrict__ src, SliceOut out,
                           size_t mn, int n, int slices, int outs) {
  const size_t stride = mn + n;
  const size_t q = 4 * (size_t(blockIdx.x) * blockDim.x + threadIdx.x);
  if (q >= outs * stride) return;
  const int o = static_cast<int>(q / stride);
  const size_t i = q - o * stride;
  if (i >= mn && pick(out.db, o) == nullptr) return;
  const float* first = src + o * slices * stride + i;
  float4 sum = *reinterpret_cast<const float4*>(first);
  for (int s = 1; s < slices; ++s) {
    const float4 v = *reinterpret_cast<const float4*>(first + s * stride);
    sum.x += v.x;
    sum.y += v.y;
    sum.z += v.z;
    sum.w += v.w;
  }
  *reinterpret_cast<float4*>(i < mn ? pick(out.dw, o) + i
                                    : pick(out.db, o) + (i - mn)) = sum;
}

// sum_slices over `outs` outputs of (mn + n) floats a slice, on `stream`.
inline cudaError_t add_slices(const float* workspace, const SliceOut& out,
                              size_t mn, int n, int slices, int outs,
                              cudaStream_t stream) {
  const int threads = 256;
  const size_t quads = outs * (mn + n) / 4;
  sum_slices<<<static_cast<unsigned>((quads + threads - 1) / threads),
               threads, 0, stream>>>(workspace, out, mn, n, slices, outs);
  return cudaGetLastError();
}

// v with the activation kAct (an rvk::Act: none, relu, tanh) applied.
template <int kAct>
__device__ __forceinline__ float activate(float v) {
  if (kAct == kActRelu) return fmaxf(v, 0.f);
  if (kAct == kActTanh) return tanhf(v);
  return v;
}

// Where a forward product's slices go: C (M, N) row-major and its bias
// (N,) or null, an output each.
struct SliceAct {
  float* c[kMaxOuts];
  const float* bias[kMaxOuts];
};

// A forward product C = act(A · B + bias) whose contraction was cut into
// slices (sgemm.cuh launch_fwd: the server's batch of 256 rows gives too
// few output tiles to fill the card).  For each output o < outs and i <
// M·N: the sum over slices s, in order, of src[(o · slices + s) · M·N +
// i], then the bias of column i % N added and the activation kAct applied
// in fp32, as the unsplit epilogue does once its k loop is done, into
// out.c[o][i].  Four floats a thread: N a multiple of 4 (a quad never
// straddles two rows or two outputs), everything 16-byte aligned.
template <int kAct>
__global__ void slices_epilogue(const float* __restrict__ src, SliceAct out,
                                size_t mn, int n, int slices, int outs) {
  const size_t q = 4 * (size_t(blockIdx.x) * blockDim.x + threadIdx.x);
  if (q >= outs * mn) return;
  const int o = static_cast<int>(q / mn);
  const size_t i = q - o * mn;
  const float* first = src + o * slices * mn + i;
  float4 sum = *reinterpret_cast<const float4*>(first);
  for (int s = 1; s < slices; ++s) {
    const float4 v = *reinterpret_cast<const float4*>(first + s * mn);
    sum.x += v.x;
    sum.y += v.y;
    sum.z += v.z;
    sum.w += v.w;
  }
  const float* bias = pick(out.bias, o);
  float4 b = make_float4(0.f, 0.f, 0.f, 0.f);
  if (bias != nullptr) b = *reinterpret_cast<const float4*>(bias + i % n);
  float4 y;
  y.x = activate<kAct>(sum.x + b.x);
  y.y = activate<kAct>(sum.y + b.y);
  y.z = activate<kAct>(sum.z + b.z);
  y.w = activate<kAct>(sum.w + b.w);
  *reinterpret_cast<float4*>(pick(out.c, o) + i) = y;
}

// slices_epilogue over `outs` outputs of M·N = mn floats a slice, on
// `stream`.
template <int kAct>
cudaError_t add_slices_act(const float* workspace, const SliceAct& out,
                           size_t mn, int n, int slices, int outs,
                           cudaStream_t stream) {
  const int threads = 256;
  const size_t quads = outs * mn / 4;
  slices_epilogue<kAct>
      <<<static_cast<unsigned>((quads + threads - 1) / threads), threads, 0,
         stream>>>(workspace, out, mn, n, slices, outs);
  return cudaGetLastError();
}

}  // namespace
}  // namespace rvk
