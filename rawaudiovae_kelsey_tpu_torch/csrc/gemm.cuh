// Tiled fp32 GEMM with a fused bias + activation epilogue: the one device
// routine every dense-VAE forward kernel of this package is built from.
//
//   C[m, n] = act( sum_k A[m, k] * B[k, n] + bias[n] )
//
// A is (M, K) fp32 row-major (activations); B is (K, N) row-major in the
// model's (in, out) weight layout, either fp32 or int8 with one fp32 scale
// per output column (dequantized to fp32 as it is staged in shared memory,
// so the product sees exactly q * scale, as the plain version does).  One
// launch can carry two outputs that share A (blockIdx.z picks which): the
// encoder's mu and logvar heads both read h.
//
// Design: a block of 256 threads (16 x 16) owns a BM x BN tile of C and
// walks K in BK-deep slabs staged in shared memory, double-buffered: each
// thread loads the next slab into registers before it runs the current
// one's FMAs, so global latency hides behind arithmetic.  Each thread keeps
// a (BM/16) x (BN/16) register tile of fp32 accumulators, strided by 16
// rows and columns so shared-memory reads broadcast and stores coalesce.
// Every edge (M, N and K) is masked in the kernel, so a ragged batch needs
// no padding.  fp32 FMAs on the CUDA cores, no tensor cores: serving runs in
// fp32, and wgmma / TMA pipelines are later work.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace rvk {
namespace {

enum Act : int { kActNone = 0, kActRelu = 1, kActTanh = 2 };

constexpr int kThreads = 256;
constexpr int kBK = 16;

template <typename TB>
struct GemmOut {
  const TB* B;         // (K, N) row-major
  const float* scale;  // (N,) per output column; int8 B only
  const float* bias;   // (N,)
  float* C;            // (M, N) row-major
};

template <typename TB>
struct GemmOuts {
  GemmOut<TB> out[2];  // blockIdx.z selects one
};

__device__ __forceinline__ float load_b(const float* B, const float*,
                                        size_t idx, int) {
  return B[idx];
}

__device__ __forceinline__ float load_b(const int8_t* B, const float* scale,
                                        size_t idx, int n) {
  return static_cast<float>(B[idx]) * scale[n];
}

template <int BM, int BN, typename TB>
__global__ void __launch_bounds__(kThreads)
gemm_bias_act(const float* __restrict__ A, GemmOuts<TB> outs, int M, int N,
              int K, int act) {
  constexpr int TM = BM / 16;
  constexpr int TN = BN / 16;
  constexpr int LA = BM * kBK / kThreads;  // A values a thread stages
  constexpr int LB = kBK * BN / kThreads;  // B values a thread stages
  // two slabs of each operand: the next one is stored while the current
  // one is read, so one barrier a slab suffices.  +1 column of padding on
  // A: its transposed store would otherwise put a warp's 16 k-values of one
  // row on the same bank
  __shared__ float As[2][kBK][BM + 1];
  __shared__ float Bs[2][kBK][BN];

  const GemmOut<TB> g = outs.out[blockIdx.z];
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  // global → registers: neighbouring threads read neighbouring k of one
  // row of A and neighbouring output columns of B; out-of-range is 0
  float ra[LA], rb[LB];
  auto load_slab = [&](int k0) {
#pragma unroll
    for (int l = 0; l < LA; ++l) {
      const int idx = threadIdx.x + l * kThreads;
      const int m = m0 + idx / kBK, k = k0 + idx % kBK;
      ra[l] = (m < M && k < K) ? A[static_cast<size_t>(m) * K + k] : 0.f;
    }
#pragma unroll
    for (int l = 0; l < LB; ++l) {
      const int idx = threadIdx.x + l * kThreads;
      const int k = k0 + idx / BN, n = n0 + idx % BN;
      rb[l] = (k < K && n < N)
                  ? load_b(g.B, g.scale, static_cast<size_t>(k) * N + n, n)
                  : 0.f;
    }
  };
  // registers → shared slab s (A transposed to [k][m])
  auto store_slab = [&](int s) {
#pragma unroll
    for (int l = 0; l < LA; ++l) {
      const int idx = threadIdx.x + l * kThreads;
      As[s][idx % kBK][idx / kBK] = ra[l];
    }
#pragma unroll
    for (int l = 0; l < LB; ++l) {
      const int idx = threadIdx.x + l * kThreads;
      Bs[s][idx / BN][idx % BN] = rb[l];
    }
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  }

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
      for (int i = 0; i < TM; ++i) a[i] = As[s][kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[s][kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
    if (more) store_slab(s ^ 1);
    __syncthreads();
    s ^= 1;
  }

  // epilogue: the sum first, then the bias, as the plain `x @ w + b` does
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n >= N) continue;
      float v = acc[i][j] + g.bias[n];
      if (act == kActRelu) {
        v = fmaxf(v, 0.f);
      } else if (act == kActTanh) {
        v = tanhf(v);
      }
      g.C[static_cast<size_t>(m) * N + n] = v;
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

// Launch one GEMM (n_out = 1) or two that share A (n_out = 2).  64 x 64
// tiles when they give at least half the SMs a block; 32 x 32 tiles
// otherwise, so that the long-K, narrow-N shapes (the heads, the decoder's
// output layer) and small batches still spread over the card.  On the H100
// this picks the faster of the two at every serving shape measured (batch
// 100 and 256; PERF.md).  Returns the launch's error code.
template <typename TB>
cudaError_t launch_gemm(const float* A, const GemmOuts<TB>& outs, int n_out,
                        int M, int N, int K, int act, cudaStream_t stream) {
  const dim3 block(kThreads);
  if (2 * cdiv(M, 64) * cdiv(N, 64) * n_out >= sm_count()) {
    const dim3 grid(cdiv(M, 64), cdiv(N, 64), n_out);
    gemm_bias_act<64, 64, TB><<<grid, block, 0, stream>>>(A, outs, M, N, K,
                                                          act);
  } else {
    const dim3 grid(cdiv(M, 32), cdiv(N, 32), n_out);
    gemm_bias_act<32, 32, TB><<<grid, block, 0, stream>>>(A, outs, M, N, K,
                                                          act);
  }
  return cudaGetLastError();
}

}  // namespace
}  // namespace rvk
