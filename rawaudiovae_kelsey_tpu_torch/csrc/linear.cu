// The fused linear layer y = act(x @ w + b) of the deep/wide MLP VAE, in
// its two forms, fp32 or bf16 operands, with a plain C interface for
// ctypes (ops/_build.py loads the library; ops/linear.py holds the
// wrappers, the dispatch rule and the plain PyTorch versions).
//
// rvk_linear_fwd replaces the TPU kernel linear_fwd (_linear_kernel) of
// rawaudiovae_kelsey_tpu/ops/pallas_linear.py: an output tile owns the
// whole contraction; bias and activation are applied in fp32 on the
// accumulator and the result is rounded once.  bf16 operands that TMA can
// address take the tensor-core mainloop (wgmma.cuh), the same launch as the
// tensor-core k-split below: the deep model's whole-k layers (512 -> 256,
// 256 -> 512, 512 -> 1024 at batch 4096) are below the card's ridge, 6-13
// MB against 0.5-2 GFLOP, so what matters is enough tiles to read them
// from every SM (the 128 x 64 tile).  fp32 operands with k and n multiples
// of 4 and 16-byte aligned pointers take the register-tiled fp32 mainloop
// of sgemm.cuh (x K-major, w N-major: IEEE fp32 FFMAs, one accumulator
// across all of k).  The first version, for the other fp32 shapes and for
// bf16 operands TMA cannot take, is one launch of the tiled GEMM of
// gemm.cuh on the CUDA cores (x read along its rows, w along its rows too,
// every ragged edge masked).
//
// rvk_linear_ksplit_fwd replaces linear_ksplit_fwd (_linear_ksplit_kernel)
// there.  The TPU kernel tiles the contraction over its grid and carries an
// fp32 accumulator across the k slices, which its grid visits in order.
// Blocks of a CUDA grid run in no order, so the counterpart is split-K in
// two stages:
//   1. grid (batch tiles, n tiles, k slices): each block contracts one
//      slice of k and writes its fp32 partial tile to a workspace
//      (slices, batch, n) — product.cuh, no bias, no activation;
//   2. one pass over (batch, n) adds the slices in slice order, adds the
//      bias in fp32, applies the activation and rounds once.
// No atomics: two launches on the same inputs give equal bits.  The slice
// depth comes from the caller (KSPLIT_BLOCK_K of ops/linear.py) and the
// slice count is ceil(k / depth): a function of the shape alone.  A ragged
// last slice contracts what is left of k; nothing is padded.  Splitting
// gives a layer slices x as many blocks as the whole-k launch, at the
// price of the workspace's round trip (2 * 4 * slices bytes per output
// element against 2 * k FLOPs: noise beside the product for k >= 1024).
// That is the first version, on the CUDA cores: fp32 operands with k or n
// no multiple of 4 or an unaligned pointer take it, and bf16 operands that
// TMA cannot (k or n no multiple of 8, an unaligned pointer).
//
// The other operands take a form in which a block owns an output tile and
// walks all of k, slice after slice in order, in one fp32 accumulator -
// what the TPU kernel does - with bias, activation and the single rounding
// in its epilogue: the same launch as rvk_linear_fwd's.  No workspace: at
// 4096 x 4096 -> 4096 the first version's eight fp32 partial planes are
// 1.07 GB written and read back, 0.32 ms at the memory rate.
// * bf16 operands: the tensor-core form (wgmma.cuh); the workspace's round
//   trip alone would take more than twice its product's bound.
// * fp32 operands with k and n multiples of 4 and 16-byte aligned pointers:
//   the register-tiled fp32 mainloop of sgemm.cuh, x K-major, w N-major,
//   one IEEE FFMA chain an output in k order.  Its bits are those of
//   rvk_linear_fwd's code 2 on the same operands.

#include "product.cuh"
#include "sgemm.cuh"
#include "wgmma.cuh"

using rvk::dst;
using rvk::src;

namespace {

template <typename T>
cudaError_t linear_fwd(const T* x, const T* w, const T* b, T* y, int batch,
                       int k, int n, int act, cudaStream_t s) {
  rvk::Gemm<T, T, T> g = {};
  g.a = rvk::view(x, k, k);
  g.out[0].b = rvk::view(w, n, k);
  g.out[0].bias = b;
  g.out[0].c = y;
  g.M = batch, g.N = n, g.K = k;
  g.act = act;
  return rvk::launch_gemm<rvk::kKContig, rvk::kRContig>(g, 1, s);
}

// A as a plain row-major (M, ld) matrix.
template <typename T>
struct MatrixRows {
  const T* x;
  int ld;
  struct Row {
    const T* base;  // nullptr past the last row
  };
  __device__ __forceinline__ Row row(int m, int M) const {
    return Row{m < M ? x + static_cast<size_t>(m) * ld : nullptr};
  }
  __device__ __forceinline__ float at(const Row& r, int k) const {
    return r.base != nullptr ? rvk::to_f32(r.base[k]) : 0.f;
  }
};

// stage 1's epilogue: the slice's partial sum, as it is, to ws[z][m][n]
struct PartialStore {
  float* ws;
  size_t plane;  // M * N
  int N;
  __device__ __forceinline__ void operator()(int m, int n, float v,
                                             int z) const {
    ws[z * plane + static_cast<size_t>(m) * N + n] = v;
  }
};

// stage 2: y = act(sum_z ws[z] + b), the slices added in order
template <typename T>
__global__ void __launch_bounds__(rvk::kThreads)
ksplit_reduce_kernel(const float* __restrict__ ws, rvk::BiasActStore<T> out,
                     size_t plane, int slices) {
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < plane; i += stride) {
    float v = ws[i];
    for (int z = 1; z < slices; ++z) v += ws[z * plane + i];
    out.finish(i, static_cast<int>(i % out.N), v);
  }
}

template <typename T>
cudaError_t linear_ksplit_fwd(const T* x, const T* w, const T* b, T* y,
                              float* ws, int batch, int k, int n, int slices,
                              int kslice, int act, cudaStream_t s) {
  if (batch <= 0 || n <= 0) return cudaSuccess;
  const size_t plane = static_cast<size_t>(batch) * n;
  const cudaError_t err = rvk::launch_product<1>(
      MatrixRows<T>{x, k}, w, n, PartialStore{ws, plane, n}, batch, n, k,
      slices, kslice, s);
  if (err != cudaSuccess) return err;
  const size_t want = (plane + rvk::kThreads - 1) / rvk::kThreads;
  const size_t cap = static_cast<size_t>(rvk::sm_count()) * 16;
  const unsigned blocks = static_cast<unsigned>(want < cap ? want : cap);
  ksplit_reduce_kernel<T><<<blocks, rvk::kThreads, 0, s>>>(
      ws, rvk::BiasActStore<T>{b, y, n, act}, plane, slices);
  return cudaGetLastError();
}

// The tensor-core form of both entry points: bf16 only, the bias 4-byte
// aligned (its pairs are single loads), tiles 128 x tile_n.
int tensor_core_linear(const void* x, const void* w, const void* b, void* y,
                       int batch, int k, int n, int act, int dtype,
                       int tile_n, cudaStream_t s) {
  if (dtype != rvk::kBF16 || reinterpret_cast<uintptr_t>(b) % 4 != 0) {
    return cudaErrorInvalidValue;
  }
  using T = rvk::bf16;
  return rvk::tc::launch_wgmma<true>(src<T>(x), src<T>(w), dst<T>(y),
                                     rvk::tc::BiasActPair{src<T>(b), act},
                                     batch, n, k, tile_n, s);
}

// The row-parallel forms (tensor parallelism, parallel/tensor_parallel.py):
// y = x @ w in fp32, the sums as they are, no bias, no activation; the ranks
// add their partial sums, then the bias, the activation and the one
// rounding follow.  The first version is linear_fwd's whole-k GEMM with an
// fp32 output, or the k-split's two stages with an fp32 output and nothing
// added in the second.
template <typename T>
cudaError_t linear_partial(const T* x, const T* w, float* y, int batch,
                           int k, int n, cudaStream_t s) {
  rvk::Gemm<T, T, float> g = {};
  g.a = rvk::view(x, k, k);
  g.out[0].b = rvk::view(w, n, k);
  g.out[0].c = y;
  g.M = batch, g.N = n, g.K = k;
  g.act = rvk::kActNone;
  return rvk::launch_gemm<rvk::kKContig, rvk::kRContig>(g, 1, s);
}

template <typename T>
cudaError_t linear_ksplit_partial(const T* x, const T* w, float* y,
                                  float* ws, int batch, int k, int n,
                                  int slices, int kslice, cudaStream_t s) {
  if (batch <= 0 || n <= 0) return cudaSuccess;
  const size_t plane = static_cast<size_t>(batch) * n;
  const cudaError_t err = rvk::launch_product<1>(
      MatrixRows<T>{x, k}, w, n, PartialStore{ws, plane, n}, batch, n, k,
      slices, kslice, s);
  if (err != cudaSuccess) return err;
  const size_t want = (plane + rvk::kThreads - 1) / rvk::kThreads;
  const size_t cap = static_cast<size_t>(rvk::sm_count()) * 16;
  const unsigned blocks = static_cast<unsigned>(want < cap ? want : cap);
  ksplit_reduce_kernel<float><<<blocks, rvk::kThreads, 0, s>>>(
      ws, rvk::BiasActStore<float>{nullptr, y, n, rvk::kActNone}, plane,
      slices);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x (batch, k); w (k, n); b (n,); y (batch, n); all of one dtype
// (rvk::DType); act an rvk::Act (none, relu or tanh).  kernel (an
// rvk::tc::Kernel): 0, the tiled GEMM on the CUDA cores; 1, the tensor-core
// form, bf16 only, in tiles 128 x tile_n (256, 128 or 64; the caller's
// choice, ops/tensor_cores.py tile_n); 2, the fp32 mainloop of sgemm.cuh,
// fp32 only, k and n multiples of 4, 16-byte aligned pointers, on the tile
// sgemm::kTiles[tile_n] (ops/tensor_cores.py sgemm_tile).  The first
// version ignores tile_n.
int rvk_linear_fwd(const void* x, const void* w, const void* b, void* y,
                   int batch, int k, int n, int act, int dtype, int tile_n,
                   int kernel, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kernel == rvk::tc::kSgemm) {
    if (dtype != rvk::kF32) return cudaErrorInvalidValue;
    return rvk::sgemm::launch_act<false>(src<float>(x), src<float>(w),
                                         src<float>(b), dst<float>(y), batch,
                                         n, k, act, tile_n, s);
  }
  if (kernel != rvk::tc::kCudaCores) {
    if (kernel != rvk::tc::kTensorCores) return cudaErrorInvalidValue;
    return tensor_core_linear(x, w, b, y, batch, k, n, act, dtype, tile_n,
                              s);
  }
  return rvk::with_dtype(dtype, [&](auto tag) {
    using T = std::remove_pointer_t<decltype(tag)>;
    return linear_fwd(src<T>(x), src<T>(w), src<T>(b), dst<T>(y), batch, k,
                      n, act, s);
  });
}

// The same function with the contraction walked slice by slice.  kernel (an
// rvk::tc::Kernel): 0, the split-K path on the CUDA cores, where ws is
// fp32 scratch of slices * batch * n elements, slices = ceil(k / kslice);
// 1, the tensor-core form, bf16 only, in tiles 128 x tile_n; 2, the fp32
// mainloop of sgemm.cuh, fp32 only, k and n multiples of 4, 16-byte aligned
// pointers, on the tile sgemm::kTiles[tile_n].  Codes 1 and 2 take no
// scratch (ws may be null) and walk k in one accumulator: the same launches
// as rvk_linear_fwd's.
int rvk_linear_ksplit_fwd(const void* x, const void* w, const void* b,
                          void* y, void* ws, int batch, int k, int n,
                          int slices, int kslice, int act, int dtype,
                          int tile_n, int kernel, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kernel == rvk::tc::kSgemm) {
    if (dtype != rvk::kF32) return cudaErrorInvalidValue;
    return rvk::sgemm::launch_act<false>(src<float>(x), src<float>(w),
                                         src<float>(b), dst<float>(y), batch,
                                         n, k, act, tile_n, s);
  }
  if (kernel != rvk::tc::kCudaCores) {
    if (kernel != rvk::tc::kTensorCores) return cudaErrorInvalidValue;
    return tensor_core_linear(x, w, b, y, batch, k, n, act, dtype, tile_n,
                              s);
  }
  if (kslice <= 0 || slices != rvk::cdiv(k, kslice)) {
    return cudaErrorInvalidValue;
  }
  return rvk::with_dtype(dtype, [&](auto tag) {
    using T = std::remove_pointer_t<decltype(tag)>;
    return linear_ksplit_fwd(src<T>(x), src<T>(w), src<T>(b), dst<T>(y),
                             static_cast<float*>(ws), batch, k, n, slices,
                             kslice, act, s);
  });
}

// The row-parallel form of both entry points: x (batch, k) a rank's
// column slice of the layer's input, w (k, n) its row shard, y (batch, n)
// the fp32 partial sums x @ w, no bias, no activation.  kernel: 0, the first
// version, rvk_linear_fwd's whole-k GEMM where slices is 0, else the k-split
// (ws fp32 scratch of slices * batch * n elements, slices = ceil(k /
// kslice)); 1, the tensor-core form (bf16 only, wgmma.cuh PartialRows) in
// tiles 128 x tile_n; 2, sgemm.cuh's fp32 mainloop with no bias and no
// activation (fp32 only, k and n multiples of 4, 16-byte aligned pointers)
// on the tile sgemm::kTiles[tile_n].  Codes 1 and 2 take no scratch.
int rvk_linear_partial(const void* x, const void* w, float* y, void* ws,
                       int batch, int k, int n, int slices, int kslice,
                       int dtype, int tile_n, int kernel, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kernel == rvk::tc::kSgemm) {
    if (dtype != rvk::kF32) return cudaErrorInvalidValue;
    return rvk::sgemm::launch_act<false>(src<float>(x), src<float>(w),
                                         nullptr, y, batch, n, k,
                                         rvk::kActNone, tile_n, s);
  }
  if (kernel != rvk::tc::kCudaCores) {
    if (kernel != rvk::tc::kTensorCores || dtype != rvk::kBF16) {
      return cudaErrorInvalidValue;
    }
    using T = rvk::bf16;
    const T* const b[1] = {src<T>(w)};
    float* const c[1] = {y};
    return rvk::tc::launch_partial<rvk::tc::MatrixTiles>(
        src<T>(x), b, c, batch, n, k, tile_n, s);
  }
  if (slices > 0 && (kslice <= 0 || slices != rvk::cdiv(k, kslice))) {
    return cudaErrorInvalidValue;
  }
  return rvk::with_dtype(dtype, [&](auto tag) {
    using T = std::remove_pointer_t<decltype(tag)>;
    if (slices == 0) {
      return linear_partial(src<T>(x), src<T>(w), y, batch, k, n, s);
    }
    return linear_ksplit_partial(src<T>(x), src<T>(w), y,
                                 static_cast<float*>(ws), batch, k, n,
                                 slices, kslice, s);
  });
}

}  // extern "C"
