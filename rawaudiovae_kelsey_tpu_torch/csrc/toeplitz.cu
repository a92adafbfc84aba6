// The block-Toeplitz product: the convolution primitive of the conv1d VAE,
// fp32 or bf16 operands, with a plain C interface for ctypes
// (ops/_build.py loads the library; ops/toeplitz.py holds the wrapper, the
// plain PyTorch version and the autograd Function, ops/conv.py the two
// convolutions that map onto it).
//
//   y[b, t, :] = act( sum_j x[b, t + j - shift, :] @ w[j] + bias )
//
// x (B, nb, G), w (KB, G, N), bias (N,) → y (B, t_out, N) in x's dtype;
// rows of x outside [0, nb) read as zero (that is the SAME padding).
//
// rvk_toeplitz_fwd replaces the TPU kernel toeplitz_fwd (_toeplitz_kernel)
// of rawaudiovae_kelsey_tpu/ops/pallas_toeplitz.py.  That kernel forms a
// full panel x @ w[j] per tap and shifts the result rows, because its
// matrix unit wants aligned operands.  Here the op is ONE implicit GEMM:
// seen from the flat signal, the KB blocks output row (b, t) reads are
// contiguous — flat elements [(t - shift)·G, (t - shift + KB)·G) of batch
// row b, cut to [0, nb·G) — so
//   M = B·t_out rows,  N columns,  contraction KB·G  against
//   w viewed as (KB·G, N),
// with an A operand whose rows overlap (row stride G, not KB·G) and are
// zero outside their batch row.  product.cuh does the tiling; ToeplitzRows
// below is that A operand; bias, activation and the one rounding are the
// epilogue.  The signal is read from device memory once per column tile
// (the overlap between neighbouring rows is served by the caches), nothing
// is padded or copied, and row indices are size_t (B·t_out reaches 2^20 at
// the first encoder layer).
//
// Operand modes: bf16 operands accumulate in fp32; fp32 with passes = 1 is
// IEEE fp32 FMAs (the TPU runs that case as one bf16 pass; this is at least
// as accurate); fp32 with passes = 4 forms every product from the bf16
// hi/lo split of both operands as (hh + ll) + (hl + lh), the arithmetic of
// the TPU kernel's passes = 4.  That is the first version, on the CUDA
// cores: every element of A is a guarded scalar load, converted to fp32.
//
// bf16 operands that TMA can address (G and N multiples of 8, 16-byte
// aligned pointers) take the tensor-core form instead: the same implicit
// GEMM on the mainloop of wgmma.cuh, whose ToeplitzTiles walk loads each
// warpgroup's 64 rows of A as one 3-D TMA box of x (b_half batch rows x
// t_half positions x 64 channels) at (g0, t0 - shift + j, b0) for tap j:
// TMA's zero fill is the SAME padding and the batch edge, its clipping the
// store's.  The conv1d model's middle layers are memory-bound (encoder
// layer 2: 101 MB against 12.9 GFLOP at batch 4096), so what counts is that
// x is streamed once from device memory into swizzled tiles by the copy
// engine, not element by element through the registers; the overlapping
// windows of neighbouring taps are served by L2.

#include "product.cuh"
#include "wgmma.cuh"

using rvk::dst;
using rvk::src;

namespace {

// Row m = (b, t) of the implicit A: element k is the flat element
// (t - shift)·G + k of batch row b, zero outside [0, nb·G).
template <typename T>
struct ToeplitzRows {
  const T* x;
  int t_out, shift, G, row_len;  // row_len = nb * G
  struct Row {
    const T* base;  // the batch row; nullptr past the last output row
    int f0;         // flat offset of the window's first element
  };
  __device__ __forceinline__ Row row(int m, int M) const {
    if (m >= M) return Row{nullptr, 0};
    const int b = m / t_out, t = m - b * t_out;
    return Row{x + static_cast<size_t>(b) * row_len, (t - shift) * G};
  }
  __device__ __forceinline__ float at(const Row& r, int k) const {
    const int f = r.f0 + k;
    return (r.base != nullptr && f >= 0 && f < row_len)
               ? rvk::to_f32(r.base[f])
               : 0.f;
  }
};

template <int kPasses, typename T>
cudaError_t toeplitz_fwd(const T* x, const T* w, const T* bias, T* y, int B,
                         int nb, int G, int kb, int N, int t_out, int shift,
                         int act, cudaStream_t s) {
  const int K = kb * G;
  return rvk::launch_product<kPasses>(
      ToeplitzRows<T>{x, t_out, shift, G, nb * G}, w, N,
      rvk::BiasActStore<T>{bias, y, N, act}, B * t_out, N, K, 1, K, s);
}

}  // namespace

extern "C" {

// x (B, nb, G); w (kb, G, N); bias (N,); y (B, t_out, N); all of one dtype
// (rvk::DType); act an rvk::Act (none, relu or tanh); passes 1, or 4 with
// fp32 operands.  B·t_out, nb·G and kb·G must fit an int (the wrapper
// checks).  kernel (an rvk::tc::Kernel): 0, the first version above; 1, the
// tensor-core form, bf16 with passes 1 only, walking the output in halves
// of b_half batch rows x t_half positions (ops/toeplitz.py tile_plan) in
// tiles 128 x tile_n (ops/tensor_cores.py tile_n); the first version
// ignores t_half, b_half and tile_n.
int rvk_toeplitz_fwd(const void* x, const void* w, const void* bias, void* y,
                     int B, int nb, int G, int kb, int N, int t_out,
                     int shift, int act, int passes, int dtype, int t_half,
                     int b_half, int tile_n, int kernel, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kernel != rvk::tc::kCudaCores) {
    if (kernel != rvk::tc::kTensorCores || dtype != rvk::kBF16 ||
        passes != 1 || reinterpret_cast<uintptr_t>(bias) % 4 != 0) {
      return cudaErrorInvalidValue;
    }
    using T = rvk::bf16;
    return rvk::tc::launch_toeplitz(
        src<T>(x), src<T>(w), dst<T>(y),
        rvk::tc::BiasActPair{src<T>(bias), act}, B, nb, G, kb, N, t_out,
        shift, t_half, b_half, tile_n, s);
  }
  if (passes == 4) {
    if (dtype != rvk::kF32) return cudaErrorInvalidValue;
    return toeplitz_fwd<4>(src<float>(x), src<float>(w), src<float>(bias),
                           dst<float>(y), B, nb, G, kb, N, t_out, shift, act,
                           s);
  }
  if (passes != 1) return cudaErrorInvalidValue;
  return rvk::with_dtype(dtype, [&](auto tag) {
    using T = std::remove_pointer_t<decltype(tag)>;
    return toeplitz_fwd<1>(src<T>(x), src<T>(w), src<T>(bias), dst<T>(y), B,
                           nb, G, kb, N, t_out, shift, act, s);
  });
}

}  // extern "C"
