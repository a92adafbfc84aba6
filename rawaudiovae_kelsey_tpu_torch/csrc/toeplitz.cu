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
//
// fp32 operands with passes = 1, G, N and the contraction window's origin
// multiples of 4 and 16-byte aligned pointers take sgemm.cuh's register-
// tiled mainloop (kernel code 2) with the implicit A staged by 16-byte
// cp.async copies (ToeplitzA): a 16-byte copy lies wholly inside its
// batch row or wholly outside it, and cp.async zero-fills the outside.
// The contraction is the caller's window [k0, k0 + k_len) of w viewed as
// (KB·G, N): conv1d_pallas (ops/conv.py) places the convolution's weight at
// rows [r0, r0 + K·Cin) of a zero tap stack, a quarter of which is zeros
// at the conv1d VAE's layers 1-3, and passes that window.  One slice, one
// FFMA chain an output in k order from +0: the first version's chain, which
// the zero rows outside the window leave unchanged (fma(x, 0, s) == s for
// finite x), so the two give equal bits.
//
// A tap width G or an output width N below 8 takes the narrow-channel form
// (kernel code 3, narrow.cuh), in either dtype and pass count: blocks walk
// items of 128 output positions, copying the next item's window of x while
// each thread sums one position's row (two in bf16) of this one, with the
// first version's FMA chain and so its bits.
//
// fp32 operands with passes = 4 that TMA can address through their halves
// (G and N multiples of 8, 16-byte aligned pointers) take the tensor cores
// too (kernel code 1): the split pass (split.cuh, bit for bit the TPU
// kernel's _split_hi_lo) turns x viewed as (B·nb, G) and w viewed as (KB·G,
// N) into bf16 halves in the caller's workspace, then wgmma.cuh's Toeplitz
// walk multiplies each stage four ways into four fp32 accumulators and adds
// them (hh + ll) + (hl + lh) before the bias and the activation, fp32 out
// (FourPassRows).  What bounds it: at the conv1d VAE's wide layers the
// bytes (layer 1 at batch 4096: x read, its halves written and read, y
// written, ~470 MB against 12.9 GFLOP in four bf16 passes), and the split
// pass is about half of them: splitting x's boxes in shared memory would
// save that, and is not done here.

#include "narrow.cuh"
#include "product.cuh"
#include "sgemm.cuh"
#include "split.cuh"
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

// fp32, passes = 1, on sgemm.cuh's mainloop: C (M, N) = act(A · w + bias)
// with A the implicit ToeplitzA and w its window's K rows of taps (K, N),
// N-major.
template <int BM, int BN, int kAct>
__global__ void __launch_bounds__(rvk::sgemm::kThreads, 2)
sgemm_toeplitz_kernel(const rvk::sgemm::ToeplitzA a,
                      const float* __restrict__ w,
                      const float* __restrict__ bias, float* __restrict__ c,
                      int M, int N, int K) {
  rvk::sgemm::product_tile<BM, BN, true, false, kAct, false, false,
                           rvk::sgemm::kStages, false, float, true>(
      a.x, w, bias, c, nullptr, M, N, K, K, 0, blockIdx.x * BN, nullptr,
      nullptr, rvk::kActNone, nullptr, nullptr, a);
}

// y (B·t_out, N) = act(Σ_k A[m, k] · w[k0 + k] + bias) in IEEE fp32 over the
// contraction window [k0, k0 + K) of w viewed as (KB·G, N): A the
// ToeplitzA `a` (a.k0 = k0), w the whole tap stack, act an rvk::Act; G, k0,
// K and N multiples of 4, every pointer 16-byte aligned.  Tile
// kTiles[tile], the whole window in one slice: each output is one FFMA
// chain in k order from +0, so that skipping rows of w that are exactly
// zero changes no bit (fma(x, 0, s) == s for finite x, and s is never -0),
// and two launches give equal bits.  Nothing to compute launches nothing.
cudaError_t sgemm_toeplitz(const rvk::sgemm::ToeplitzA& a, const float* w,
                           const float* bias, float* y, int M, int N, int K,
                           int act, int tile, cudaStream_t stream) {
  namespace sg = rvk::sgemm;
  const float* wk = w + static_cast<size_t>(a.k0) * N;
  if (!sg::takes(K, N, {a.x, wk, bias, y}) || bias == nullptr ||
      a.G % 4 != 0 || a.k0 % 4 != 0 || a.k0 < 0 || a.t_out <= 0) {
    return cudaErrorInvalidValue;
  }
  if (M <= 0 || N <= 0) return cudaSuccess;
  const auto product = [&](auto act_of) {
    constexpr int kA = decltype(act_of)::value;
    return sg::with_tile(tile, [&](auto index) {
      constexpr int i = decltype(index)::value;
      constexpr int BM = sg::kTiles[i][0], BN = sg::kTiles[i][1];
      if (rvk::cdiv(M, BM) > 65535) return cudaErrorInvalidValue;  // grid y
      auto kernel = sgemm_toeplitz_kernel<BM, BN, kA>;
      constexpr int smem = sg::kSmemBytes<BM, BN, true, false>;
      static uint64_t opted_in = 0;
      const cudaError_t err = sg::opt_in(kernel, smem, opted_in);
      if (err != cudaSuccess) return err;
      const dim3 grid(rvk::cdiv(N, BN), rvk::cdiv(M, BM), 1);
      kernel<<<grid, sg::kThreads, smem, stream>>>(a, wk, bias, y, M, N, K);
      return cudaGetLastError();
    });
  };
  switch (act) {
    case rvk::kActNone:
      return product(std::integral_constant<int, rvk::kActNone>{});
    case rvk::kActRelu:
      return product(std::integral_constant<int, rvk::kActRelu>{});
    case rvk::kActTanh:
      return product(std::integral_constant<int, rvk::kActTanh>{});
    default:
      return cudaErrorInvalidValue;
  }
}

// fp32, passes = 4, on the tensor cores: x viewed as (B·nb, G) and w as
// (KB·G, N) split into bf16 halves in `ws` (x's hi and lo, then w's, one
// after another: 2 · (B·nb·G + KB·G·N) values), then the 4-pass Toeplitz
// walk (wgmma.cuh launch_toeplitz4) on the plan (t_half, b_half).
cudaError_t toeplitz_split(const float* x, const float* w, const float* bias,
                           float* y, rvk::bf16* ws, int B, int nb, int G,
                           int kb, int N, int t_out, int shift, int act,
                           int t_half, int b_half, cudaStream_t s) {
  if (B <= 0 || t_out <= 0 || N <= 0) return cudaSuccess;
  if (ws == nullptr || nb < 1) return cudaErrorInvalidValue;
  const size_t nx = size_t(B) * nb * G, nw = size_t(kb) * G * N;
  rvk::bf16* const x_hi = ws;
  rvk::bf16* const x_lo = x_hi + nx;
  rvk::bf16* const w_hi = x_lo + nx;
  rvk::bf16* const w_lo = w_hi + nw;
  cudaError_t err = rvk::split_matrix(x, x_hi, x_lo, nullptr, nullptr,
                                      B * nb, G, s);
  if (err == cudaSuccess) {
    err = rvk::split_matrix(w, w_hi, w_lo, nullptr, nullptr, kb * G, N, s);
  }
  if (err != cudaSuccess) return err;
  return rvk::tc::with_act(act, [&](auto a) {
    return rvk::tc::launch_toeplitz4<decltype(a)::value>(
        {x_hi, x_lo}, {w_hi, w_lo}, y, bias, B, nb, G, kb, N, t_out, shift,
        t_half, b_half, s);
  });
}

}  // namespace

extern "C" {

// x (B, nb, G); w (kb, G, N); bias (N,); y (B, t_out, N); all of one dtype
// (rvk::DType); act an rvk::Act (none, relu or tanh); passes 1, or 4 with
// fp32 operands.  B·t_out, nb·G and kb·G must fit an int (the wrapper
// checks).  workspace: the 4-pass tensor-core form's bf16 halves, 2 · (B·nb·G
// + kb·G·N) values, 16-byte aligned (null for every other form).  [k0, k0 +
// k_len): the contraction window of w viewed as (kb·G, N), outside which w
// is zero (the whole stack, 0 and kb·G, where the caller knows no zero
// rows); only kernel 2 reads it.  kernel (an rvk::tc::Kernel): 0, the first
// version above; 1, the tensor-core form, bf16 with passes 1 or fp32 with
// passes 4 (B·nb and kb·G at most 65535 · 64 rows, the split pass's grid),
// walking the output in halves of b_half batch rows x t_half positions
// (ops/toeplitz.py tile_plan) in tiles 128 x tile_n (ops/tensor_cores.py
// tile_n; 64 at passes 4); 2, sgemm.cuh, fp32 with passes 1 only, on
// the tile kTiles[tile_n] (ops/tensor_cores.py sgemm_whole_tile); 3, the
// narrow-channel form, tile_n its chunk of output columns and t_half the
// output positions a thread sums (ops/toeplitz.py narrow_chunk,
// narrow_rows).  Forms 0 and 2 ignore t_half and b_half, the first version
// tile_n too.
int rvk_toeplitz_fwd(const void* x, const void* w, const void* bias, void* y,
                     void* workspace, int B, int nb, int G, int kb, int N,
                     int t_out, int shift, int act, int passes, int dtype,
                     int k0, int k_len, int t_half, int b_half, int tile_n,
                     int kernel, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kernel == rvk::tc::kTensorCores && passes == 4) {
    if (dtype != rvk::kF32 || tile_n != 64 ||
        size_t(B) * nb > size_t(65535) * rvk::kSplitRows ||
        size_t(kb) * G > size_t(65535) * rvk::kSplitRows) {
      return cudaErrorInvalidValue;
    }
    return toeplitz_split(src<float>(x), src<float>(w), src<float>(bias),
                          dst<float>(y), static_cast<rvk::bf16*>(workspace),
                          B, nb, G, kb, N, t_out, shift, act, t_half, b_half,
                          s);
  }
  if (kernel == rvk::tc::kTensorCores) {
    if (dtype != rvk::kBF16 || passes != 1 ||
        reinterpret_cast<uintptr_t>(bias) % 4 != 0) {
      return cudaErrorInvalidValue;
    }
    using T = rvk::bf16;
    return rvk::tc::launch_toeplitz(
        src<T>(x), src<T>(w), dst<T>(y),
        rvk::tc::BiasActPair{src<T>(bias), act}, B, nb, G, kb, N, t_out,
        shift, t_half, b_half, tile_n, s);
  }
  if (kernel == rvk::tc::kSgemm) {
    if (dtype != rvk::kF32 || passes != 1 || nb < 1 || k0 < 0 ||
        k_len < 1 || k0 + k_len > kb * G) {
      return cudaErrorInvalidValue;
    }
    return sgemm_toeplitz(
        rvk::sgemm::ToeplitzA{src<float>(x), t_out, shift, G, nb * G, k0},
        src<float>(w), src<float>(bias), dst<float>(y), B * t_out, N, k_len,
        act, tile_n, s);
  }
  if (kernel == rvk::tc::kNarrow) {
    return rvk::with_dtype(dtype, [&](auto tag) {
      using T = std::remove_pointer_t<decltype(tag)>;
      return rvk::narrow::launch<T>(src<T>(x), src<T>(w), src<T>(bias),
                                    dst<T>(y), B, nb, G, kb, N, t_out, shift,
                                    act, passes, tile_n, t_half, s);
    });
  }
  if (kernel != rvk::tc::kCudaCores) return cudaErrorInvalidValue;
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
