// Tiled GEMM with a fused epilogue: the one device routine every dense-VAE
// kernel of this package, forward and backward, is built from.
//
//   C[m, n] = epilogue( sum_k A[m, k] * B[k, n] )
//
// Operands.  A and B are each read through a View: element (r, k), where r
// is the row of A (m) or the column of B (n) and k the contraction index,
// of one matrix or of two joined along k (k < split reads p0, the rest
// p1).  A View is either k-contiguous (element at r * ld + k) or
// r-contiguous (element at k * ld + r), a compile-time choice.  That covers
// every product of the model:
//   x @ W         A k-contiguous (x row-major), B r-contiguous (W is (in, out));
//   a @ Wᵀ        A k-contiguous, B k-contiguous (W read by its rows);
//   [a1 a2] @ [W1ᵀ; W2ᵀ]   the same with two sources joined along k;
//   aᵀ @ b        A r-contiguous, B r-contiguous (both (batch, ·), k = batch).
// Element types: fp32 or bf16 (converted to fp32 as they are staged), or
// int8 B with one fp32 scale per output column (dequantized as q * scale,
// the product the plain version forms).
//
// Epilogue, in fp32: + bias[n] (optional), then ReLU, tanh, or a gate
// (C = 0 where gate[m, n] <= 0: the ReLU backward), then one rounding to the
// output type (fp32 or bf16).  Optionally the blocks of the first row of
// tiles also sum B over k for their columns (colsum[n] = sum_k B[k, n], the
// bias gradient of a weight-gradient product), in k order.  One launch can
// carry two outputs that share A (blockIdx.z picks which): the encoder's
// two heads, or the two head gradients that both contract h.
//
// Design: a block of 256 threads (16 x 16) owns a BM x BN tile of C and
// walks K in BK-deep slabs staged in shared memory, double-buffered: each
// thread loads the next slab into registers before it runs the current
// one's FMAs, so global latency hides behind arithmetic.  Each thread keeps
// a (BM/16) x (BN/16) register tile of fp32 accumulators, strided by 16
// rows and columns so shared-memory reads broadcast and stores coalesce.
// A k-contiguous operand is loaded with neighbouring threads on
// neighbouring k and stored transposed (+1 column of padding keeps those
// stores off one bank).  Every edge (M, N and K) is masked in the kernel,
// so a ragged batch needs no padding.  A block loops over the whole of K
// itself: a contraction over the batch is one pass with no atomics and no
// second reduction, so two runs give identical bits.  fp32 FMAs on the
// CUDA cores, no tensor cores: wgmma / TMA pipelines are later work.
//
// The 3-pass operand mode (kPasses = 3, fp32 operands only): the product
// of the `high` precision tier.  Every fp32 element v is split once, as it
// is staged into shared memory, into hi(v) — v rounded to bf16 by the bit
// arithmetic (u + 0x8000) & 0xFFFF0000, the split of the TPU kernels
// (pallas_mlp.py _split_hi_lo) — and lo(v) = bf16_rn(v - hi(v)), kept as
// bf16-valued floats in a hi slab and a lo slab.  Three fp32 accumulators
// take hi·hi, hi·lo and lo·hi (each product of two bf16 values is exact in
// fp32) and are added as (hh + hl) + lh in the epilogue: the arithmetic of
// three bf16 tensor-core passes, on the CUDA cores.  Out-of-range elements
// stage as 0 in both slabs.  The column sums add the unsplit values, kept
// in a third slab of B.  Shared memory: 2 + 3 slabs, double-buffered,
// 41,600 bytes at 64 x 64 — inside the 48 KB a block gets without opting
// in, so the tile sizes and the k depth stay those of the 1-pass mode.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace rvk {
namespace {

using bf16 = __nv_bfloat16;

enum Act : int { kActNone = 0, kActRelu = 1, kActTanh = 2, kActGate = 3 };
// operand dtype codes of the C entry points (ops/mlp.py DTYPE_CODES)
enum DType : int { kF32 = 0, kBF16 = 1 };

constexpr int kThreads = 256;
constexpr int kBK = 16;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(int8_t v) {
  return static_cast<float>(v);
}

// fp32 → (hi, lo), both bf16-valued, v ≈ hi + lo.  hi rounds the magnitude
// bits half up (not to even), as pallas_mlp.py _split_hi_lo does.
__device__ __forceinline__ void split_hi_lo(float v, float& hi, float& lo) {
  hi = __uint_as_float((__float_as_uint(v) + 0x8000u) & 0xFFFF0000u);
  lo = __bfloat162float(__float2bfloat16_rn(v - hi));
}

// The cotangent before an activation, da = act'(y) · dy, from the layer's
// output y and its cotangent g = dy, in fp32 (benchmarks/deep_bwd_probe.py
// _da): relu passes g where y > 0, tanh gives g · (1 − y · y), none g; act
// an Act.  tanh is written with the rounding intrinsics so that the
// compiler cannot contract 1 − y · y into one fused multiply-add: it gives
// the bits of the plain version's three operations.  The callers round the
// result to the operand dtype.
__device__ __forceinline__ float cotangent(int act, float y, float g) {
  if (act == kActRelu) return y > 0.f ? g : 0.f;
  if (act == kActTanh) return __fmul_rn(g, __fsub_rn(1.f, __fmul_rn(y, y)));
  return g;
}

__device__ __forceinline__ void store_as(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_as(bf16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T>
struct View {
  const T* p0;  // k in [0, split)
  const T* p1;  // k in [split, K); unused when split >= K
  int ld0, ld1, split;
};

template <bool kKC, typename T>
__device__ __forceinline__ float fetch(const View<T>& v, int r, int k) {
  const T* p = v.p0;
  int ld = v.ld0;
  if (k >= v.split) {
    p = v.p1;
    ld = v.ld1;
    k -= v.split;
  }
  const size_t idx = kKC ? static_cast<size_t>(r) * ld + k
                         : static_cast<size_t>(k) * ld + r;
  return to_f32(p[idx]);
}

template <typename TB, typename TC>
struct GemmOut {
  View<TB> b;
  const float* scale;  // (N,) per output column; int8 B only
  const TC* bias;      // (N,) or nullptr
  const TC* gate;      // (M, N) row-major; kActGate only
  TC* c;               // (M, N) row-major
  float* colsum;       // (N,) sum of B over k, or nullptr
};

template <typename TA, typename TB, typename TC>
struct Gemm {
  View<TA> a;
  GemmOut<TB, TC> out[2];  // blockIdx.z selects one
  int M, N, K, act;
};

template <int BM, int BN, int kPasses, typename TA, bool kAKC, typename TB,
          bool kBKC, typename TC>
__global__ void __launch_bounds__(kThreads)
gemm_kernel(const Gemm<TA, TB, TC> args) {
  static_assert(kPasses == 1 || kPasses == 3, "1 or 3 passes");
  static_assert(kPasses == 1 || (std::is_same<TA, float>::value &&
                                 std::is_same<TB, float>::value),
                "the 3-pass mode splits fp32 operands");
  constexpr bool kSplit = kPasses == 3;
  // slabs of A: the value (1 pass) or hi, lo (3 passes); of B: the same,
  // then the unsplit value for the column sums
  constexpr int kRaw = kSplit ? 2 : 0;
  constexpr int TM = BM / 16;
  constexpr int TN = BN / 16;
  constexpr int LA = BM * kBK / kThreads;  // A values a thread stages
  constexpr int LB = kBK * BN / kThreads;  // B values a thread stages
  // two slabs of each operand: the next one is stored while the current
  // one is read, so one barrier a slab suffices
  __shared__ float As[kSplit ? 2 : 1][2][kBK][BM + 1];
  __shared__ float Bs[kSplit ? 3 : 1][2][kBK][BN + 1];

  const GemmOut<TB, TC> g = args.out[blockIdx.z];
  const int M = args.M, N = args.N, K = args.K;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  // staging position (r, k) within the slab of the l-th value a thread
  // loads: neighbouring threads on the operand's contiguous axis
  auto a_pos = [](int l, int& r, int& k) {
    const int idx = threadIdx.x + l * kThreads;
    r = kAKC ? idx / kBK : idx % BM;
    k = kAKC ? idx % kBK : idx / BM;
  };
  auto b_pos = [](int l, int& r, int& k) {
    const int idx = threadIdx.x + l * kThreads;
    r = kBKC ? idx / kBK : idx % BN;
    k = kBKC ? idx % kBK : idx / BN;
  };

  // global → registers, out-of-range is 0
  float ra[LA], rb[LB];
  auto load_slab = [&](int k0) {
#pragma unroll
    for (int l = 0; l < LA; ++l) {
      int r, k;
      a_pos(l, r, k);
      const int m = m0 + r, kk = k0 + k;
      ra[l] = (m < M && kk < K) ? fetch<kAKC>(args.a, m, kk) : 0.f;
    }
#pragma unroll
    for (int l = 0; l < LB; ++l) {
      int r, k;
      b_pos(l, r, k);
      const int n = n0 + r, kk = k0 + k;
      float v = 0.f;
      if (n < N && kk < K) {
        v = fetch<kBKC>(g.b, n, kk);
        if constexpr (std::is_same<TB, int8_t>::value) v *= g.scale[n];
      }
      rb[l] = v;
    }
  };
  // registers → shared slab s, both as [k][r]
  auto store_slab = [&](int s) {
#pragma unroll
    for (int l = 0; l < LA; ++l) {
      int r, k;
      a_pos(l, r, k);
      if constexpr (kSplit) {
        split_hi_lo(ra[l], As[0][s][k][r], As[1][s][k][r]);
      } else {
        As[0][s][k][r] = ra[l];
      }
    }
#pragma unroll
    for (int l = 0; l < LB; ++l) {
      int r, k;
      b_pos(l, r, k);
      if constexpr (kSplit) {
        split_hi_lo(rb[l], Bs[0][s][k][r], Bs[1][s][k][r]);
        Bs[kRaw][s][k][r] = rb[l];
      } else {
        Bs[0][s][k][r] = rb[l];
      }
    }
  };

  // acc[0]: the product (1 pass) or hi·hi; acc[1]: hi·lo; acc[2]: lo·hi
  float acc[kPasses][TM][TN];
#pragma unroll
  for (int p = 0; p < kPasses; ++p) {
#pragma unroll
    for (int i = 0; i < TM; ++i) {
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[p][i][j] = 0.f;
    }
  }
  // the column sums: one thread of each column of threads, first row of
  // tiles only, adding B's staged values in k order
  const bool sums = g.colsum != nullptr && blockIdx.x == 0 && ty == 0;
  float csum[TN];
#pragma unroll
  for (int j = 0; j < TN; ++j) csum[j] = 0.f;

  load_slab(0);
  store_slab(0);
  __syncthreads();
  int s = 0;
  for (int k0 = 0; k0 < K; k0 += kBK) {
    const bool more = k0 + kBK < K;
    // the next slab's global loads are in flight during this slab's FMAs
    if (more) load_slab(k0 + kBK);
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[0][s][kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[0][s][kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          acc[0][i][j] = fmaf(a[i], b[j], acc[0][i][j]);
        }
      }
      if constexpr (kSplit) {
        float al[TM], bl[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) al[i] = As[1][s][kk][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < TN; ++j) bl[j] = Bs[1][s][kk][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < TM; ++i) {
#pragma unroll
          for (int j = 0; j < TN; ++j) {
            acc[1][i][j] = fmaf(a[i], bl[j], acc[1][i][j]);
            acc[2][i][j] = fmaf(al[i], b[j], acc[2][i][j]);
          }
        }
      }
    }
    if (sums) {
#pragma unroll
      for (int kk = 0; kk < kBK; ++kk) {
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          csum[j] += Bs[kRaw][s][kk][tx + 16 * j];
        }
      }
    }
    if (more) store_slab(s ^ 1);
    __syncthreads();
    s ^= 1;
  }

  // epilogue: the sum first, then the bias, as the plain `x @ w + b` does
  const int act = args.act;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n >= N) continue;
      const size_t at = static_cast<size_t>(m) * N + n;
      float v = acc[0][i][j];
      if constexpr (kSplit) v = (v + acc[1][i][j]) + acc[2][i][j];
      if (g.bias != nullptr) v += to_f32(g.bias[n]);
      if (act == kActRelu) {
        v = fmaxf(v, 0.f);
      } else if (act == kActTanh) {
        v = tanhf(v);
      } else if (act == kActGate) {
        if (!(to_f32(g.gate[at]) > 0.f)) v = 0.f;
      }
      store_as(g.c + at, v);
    }
  }
  if (sums) {
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < N) g.colsum[n] = csum[j];
    }
  }
}

inline int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0, n = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    sms = n > 0 ? n : 1;
  }
  return sms;
}

inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// A single-source View: one matrix with leading dimension ld and K extent k.
template <typename T>
View<T> view(const T* p, int ld, int k) {
  return View<T>{p, nullptr, ld, 0, k};
}

// Launch one GEMM (n_out = 1) or two that share A (n_out = 2).  64 x 64
// tiles when they give at least half the SMs a block; 32 x 32 tiles
// otherwise, so that the long-K, narrow-N shapes (the heads, the decoder's
// output layer) and small batches still spread over the card.  On the H100
// this picks the faster of the two at every serving shape measured (batch
// 100 and 256; PERF.md).  kPasses = 3 takes the 3-pass operand mode (fp32
// operands).  Returns the launch's error code.
template <bool kAKC, bool kBKC, int kPasses = 1, typename TA, typename TB,
          typename TC>
cudaError_t launch_gemm(const Gemm<TA, TB, TC>& args, int n_out,
                        cudaStream_t stream) {
  if (args.M <= 0 || args.N <= 0) return cudaSuccess;
  const dim3 block(kThreads);
  if (2 * cdiv(args.M, 64) * cdiv(args.N, 64) * n_out >= sm_count()) {
    const dim3 grid(cdiv(args.M, 64), cdiv(args.N, 64), n_out);
    gemm_kernel<64, 64, kPasses, TA, kAKC, TB, kBKC, TC>
        <<<grid, block, 0, stream>>>(args);
  } else {
    const dim3 grid(cdiv(args.M, 32), cdiv(args.N, 32), n_out);
    gemm_kernel<32, 32, kPasses, TA, kAKC, TB, kBKC, TC>
        <<<grid, block, 0, stream>>>(args);
  }
  return cudaGetLastError();
}

// The operand layouts of the model's products (see the top of this file).
constexpr bool kKContig = true;
constexpr bool kRContig = false;

// The C entry points take untyped pointers and a DType code: with_dtype
// calls f with a null T* (T = float for kF32, bf16 for kBF16) to name the
// element type, and src / dst cast each pointer to it.
template <typename F>
cudaError_t with_dtype(int dtype, F&& f) {
  if (dtype == kF32) return f(static_cast<float*>(nullptr));
  if (dtype == kBF16) return f(static_cast<bf16*>(nullptr));
  return cudaErrorInvalidValue;
}

template <typename T>
const T* src(const void* p) {
  return static_cast<const T*>(p);
}

template <typename T>
T* dst(void* p) {
  return static_cast<T*>(p);
}

}  // namespace
}  // namespace rvk
