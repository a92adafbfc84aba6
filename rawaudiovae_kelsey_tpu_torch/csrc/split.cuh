// The split pass of the 3-pass product: an fp32 matrix to the bf16 halves
// the tensor cores multiply, and the column sums of the unsplit values.
//
//   hi = the top 16 bits of (u + 0x8000), u the bits of v
//        (v rounded to bf16 half up on the magnitude, not to even)
//   lo = bf16_rn(v - hi)
//   colsum[c] = sum_r v[r, c]            (optional, fp32, a fixed order)
//
// Bit for bit the split of the TPU kernels (rawaudiovae_kelsey_tpu/ops/
// pallas_mlp.py _split_hi_lo) and of ops/mlp.py split_hi_lo; gemm.cuh's
// split_hi_lo is the same arithmetic on the CUDA cores.  It replaces no TPU
// kernel of its own: the TPU kernels enc_bwd_full / dec_bwd_full split each
// operand tile in VMEM as they multiply it, and full.cu's chains run it on
// every operand once before the tensor-core products that read both halves
// by TMA.  The bias gradients of those chains sum the unsplit fp32 values
// here (pallas_mlp.py:762-775, 859-872): hi + lo is not v.
//
// Design.  A block of 256 threads covers 64 rows x 256 columns: thread t
// takes four adjacent columns 4 (t % 64) .. (one 16-byte load, two 8-byte
// stores) in the rows t / 64, + 4, + 8, ... of its 64, so a warp reads 512
// contiguous bytes of a row; four rows' loads are issued before the first
// is split.  With sums, each thread adds its rows in order, the block adds
// its four row lanes in order through shared memory and writes one partial
// a column for its 64 rows; split_finish then adds the partials of every
// column in row-block order.  No atomics: for a
// given shape the order of every addition is fixed, and two runs give the
// same bits (loss.cu's two stages, along columns).
//
// What bounds it: bytes.  4 bytes read and 4 written an element; at the
// stream's batch h and dh (4096 x 2048) are 64 MB each way, ~0.02 ms at
// 3.35 TB/s on an H100.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gemm.cuh"

namespace rvk {
namespace {

constexpr int kSplitRows = 64;    // rows a block (ops/mlp.py SPLIT_ROWS)
constexpr int kSplitCols = 256;   // columns a block: 64 threads x 4
constexpr int kSplitLanes = 4;    // row lanes of a block

// v (rows, cols) → hi, lo (rows, cols) bf16; with `partial`, the block's
// column sums of v to partial[blockIdx.y · cols + c].  cols a multiple of
// 4, every pointer 16-byte aligned.
__global__ void __launch_bounds__(kThreads)
split_pass(const float* __restrict__ v, bf16* __restrict__ hi,
           bf16* __restrict__ lo, float* __restrict__ partial, int rows,
           int cols) {
  __shared__ float4 lanes[kSplitLanes][kSplitCols / 4];
  const int tx = threadIdx.x % (kSplitCols / 4);
  const int ty = threadIdx.x / (kSplitCols / 4);
  const int c = blockIdx.x * kSplitCols + 4 * tx;
  const int r0 = blockIdx.y * kSplitRows;
  float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
  if (c < cols) {
    // kBatch rows' loads in flight before any is used: one 16-byte load a
    // thread at a time leaves the memory system idle
    constexpr int kBatch = 4;
    for (int i0 = 0; i0 < kSplitRows / kSplitLanes; i0 += kBatch) {
      float4 x[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int r = r0 + ty + (i0 + j) * kSplitLanes;
        if (r < rows) {
          x[j] = *reinterpret_cast<const float4*>(v + size_t(r) * cols + c);
        }
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int r = r0 + ty + (i0 + j) * kSplitLanes;
        if (r >= rows) break;
        const size_t at = size_t(r) * cols + c;
        const float in[4] = {x[j].x, x[j].y, x[j].z, x[j].w};
        uint32_t h[2], l[2];
#pragma unroll
        for (int i = 0; i < 4; i += 2) {
          float h0, l0, h1, l1;
          split_hi_lo(in[i], h0, l0);
          split_hi_lo(in[i + 1], h1, l1);
          // both halves are bf16 values: their top 16 bits are the bf16
          h[i / 2] = (__float_as_uint(h0) >> 16) |
                     (__float_as_uint(h1) & 0xFFFF0000u);
          l[i / 2] = (__float_as_uint(l0) >> 16) |
                     (__float_as_uint(l1) & 0xFFFF0000u);
        }
        *reinterpret_cast<uint2*>(hi + at) = make_uint2(h[0], h[1]);
        *reinterpret_cast<uint2*>(lo + at) = make_uint2(l[0], l[1]);
        // the lane's rows in order
        sum.x += x[j].x;
        sum.y += x[j].y;
        sum.z += x[j].z;
        sum.w += x[j].w;
      }
    }
  }
  if (partial == nullptr) return;
  lanes[ty][tx] = sum;
  __syncthreads();
  if (ty == 0 && c < cols) {
    for (int y = 1; y < kSplitLanes; ++y) {
      const float4 s = lanes[y][tx];
      sum.x += s.x;
      sum.y += s.y;
      sum.z += s.z;
      sum.w += s.w;
    }
    *reinterpret_cast<float4*>(partial + size_t(blockIdx.y) * cols + c) =
        sum;
  }
}

// colsum[c] = sum over the row blocks b, in order, of partial[b · cols + c].
__global__ void __launch_bounds__(kThreads)
split_finish(const float* __restrict__ partial, int blocks, int cols,
             float* __restrict__ colsum) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= cols) return;
  float s = partial[c];
  for (int b = 1; b < blocks; ++b) s += partial[size_t(b) * cols + c];
  colsum[c] = s;
}

// The split pass on `stream`: v (rows, cols) fp32 → hi, lo bf16; with
// `colsum`, its column sums, through `workspace` (ceil(rows / 64) · cols
// floats) when rows > 64.  rows >= 0, cols a multiple of 4 (of 8 for the
// products that read the halves), every pointer 16-byte aligned.
inline cudaError_t split_matrix(const float* v, bf16* hi, bf16* lo,
                                float* colsum, float* workspace, int rows,
                                int cols, cudaStream_t stream) {
  if (rows < 0 || cols <= 0 || cols % 4 != 0) return cudaErrorInvalidValue;
  if (rows == 0) {
    return colsum == nullptr
               ? cudaSuccess
               : cudaMemsetAsync(colsum, 0, cols * sizeof(float), stream);
  }
  const int blocks = cdiv(rows, kSplitRows);
  if (colsum != nullptr && blocks > 1 && workspace == nullptr) {
    return cudaErrorInvalidValue;
  }
  float* partial = colsum == nullptr ? nullptr
                   : blocks == 1     ? colsum
                                     : workspace;
  split_pass<<<dim3(cdiv(cols, kSplitCols), blocks), kThreads, 0, stream>>>(
      v, hi, lo, partial, rows, cols);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || partial == nullptr || blocks == 1) return err;
  split_finish<<<cdiv(cols, kThreads), kThreads, 0, stream>>>(
      workspace, blocks, cols, colsum);
  return cudaGetLastError();
}

}  // namespace
}  // namespace rvk
