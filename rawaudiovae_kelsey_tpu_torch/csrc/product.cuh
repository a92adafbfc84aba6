// Tiled product with a row-addressed A operand, a k range per block and a
// caller-supplied epilogue: the device routine of the two kernels that
// gemm.cuh's Views cannot express.
//
//   C[m, n] = epi( sum_{k in slice z} A(m, k) * W[k, n] )
//
// * A is read through a "rows" object: rows.row(m, M) gives a thread what it
//   needs to address row m (computed once: a thread stages the same rows in
//   every slab), rows.at(row, k) the element, 0 where the row has none.
//   That covers a plain row-major matrix (linear.cu) and the overlapping
//   windows of a flat signal, zero outside each batch row (toeplitz.cu).
//   Within a row k is contiguous, so neighbouring threads load
//   neighbouring k.
// * W is (K, N) row-major, fp32 or bf16, read by its rows.
// * blockIdx.z names a k slice [z*kslice, min(K, (z+1)*kslice)): with one
//   slice a block owns the whole contraction, with several each block hands
//   the epilogue the partial sum of its slice (split-K; linear.cu adds the
//   slices in a second, ordered stage — no atomics).
// * epi(m, n, v, z) gets the fp32 sum and does the rest (bias, activation,
//   rounding, store).
//
// The tiling is gemm.cuh's: 256 threads as 16 x 16, a BM x BN tile of C,
// K walked in 16-deep slabs staged in shared memory and double-buffered
// through registers, (BM/16) x (BN/16) fp32 accumulators a thread, every
// edge masked.  Tiles: 64 x 64, 32 x 32 when that leaves SMs idle, and
// 128 x 16 for outputs at most 16 columns wide (the conv1d VAE's last
// decoder layer has 4).
//
// The 4-pass operand mode (kPasses = 4, fp32 operands only): every element
// is split as it is staged into hi and lo bf16-valued floats (split_hi_lo
// of gemm.cuh, bit for bit the TPU kernels' _split_hi_lo), four
// accumulators take hi·hi, lo·lo, hi·lo and lo·hi, and the epilogue gets
// (hh + ll) + (hl + lh): the arithmetic of pallas_toeplitz.py's passes = 4,
// on the CUDA cores.
#pragma once

#include "gemm.cuh"

namespace rvk {
namespace {

template <int BM, int BN, int kPasses, typename TB, typename ARows,
          typename Epi>
__global__ void __launch_bounds__(kThreads)
product_kernel(const ARows a, const TB* __restrict__ w, int ldw,
               const Epi epi, int M, int N, int K, int kslice) {
  static_assert(kPasses == 1 || kPasses == 4, "1 or 4 passes");
  constexpr bool kSplit = kPasses == 4;
  constexpr int TM = BM / 16;
  constexpr int TN = BN / 16;
  constexpr int LA = BM * kBK / kThreads;  // == TM: 16 rows a pass
  constexpr int LB = kBK * BN / kThreads;
  static_assert(LA >= 1 && LB >= 1, "a tile stages at least one value");
  __shared__ float As[kSplit ? 2 : 1][2][kBK][BM + 1];
  __shared__ float Bs[kSplit ? 2 : 1][2][kBK][BN + 1];

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int kbeg = blockIdx.z * kslice;
  const int kend = min(K, kbeg + kslice);

  // A staging: this thread loads column ak of rows ar, ar + 16, ...
  const int ak = threadIdx.x % kBK;
  const int ar = threadIdx.x / kBK;
  typename ARows::Row rows[LA];
#pragma unroll
  for (int l = 0; l < LA; ++l) rows[l] = a.row(m0 + ar + 16 * l, M);

  float ra[LA], rb[LB];
  auto load_slab = [&](int k0) {
    const int ka = k0 + ak;
#pragma unroll
    for (int l = 0; l < LA; ++l) {
      ra[l] = ka < kend ? a.at(rows[l], ka) : 0.f;
    }
#pragma unroll
    for (int l = 0; l < LB; ++l) {
      const int idx = threadIdx.x + l * kThreads;
      const int n = n0 + idx % BN, kk = k0 + idx / BN;
      rb[l] = (n < N && kk < kend)
                  ? to_f32(w[static_cast<size_t>(kk) * ldw + n])
                  : 0.f;
    }
  };
  auto store_slab = [&](int s) {
#pragma unroll
    for (int l = 0; l < LA; ++l) {
      const int r = ar + 16 * l;
      if constexpr (kSplit) {
        split_hi_lo(ra[l], As[0][s][ak][r], As[1][s][ak][r]);
      } else {
        As[0][s][ak][r] = ra[l];
      }
    }
#pragma unroll
    for (int l = 0; l < LB; ++l) {
      const int idx = threadIdx.x + l * kThreads;
      const int r = idx % BN, k = idx / BN;
      if constexpr (kSplit) {
        split_hi_lo(rb[l], Bs[0][s][k][r], Bs[1][s][k][r]);
      } else {
        Bs[0][s][k][r] = rb[l];
      }
    }
  };

  // acc[0]: the product (1 pass) or hi·hi; then lo·lo, hi·lo, lo·hi
  float acc[kPasses][TM][TN];
#pragma unroll
  for (int p = 0; p < kPasses; ++p) {
#pragma unroll
    for (int i = 0; i < TM; ++i) {
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[p][i][j] = 0.f;
    }
  }

  if (kbeg < kend) {
    load_slab(kbeg);
    store_slab(0);
  }
  __syncthreads();
  int s = 0;
  for (int k0 = kbeg; k0 < kend; k0 += kBK) {
    const bool more = k0 + kBK < kend;
    if (more) load_slab(k0 + kBK);
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float ah[TM], bh[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) ah[i] = As[0][s][kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) bh[j] = Bs[0][s][kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          acc[0][i][j] = fmaf(ah[i], bh[j], acc[0][i][j]);
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
            acc[1][i][j] = fmaf(al[i], bl[j], acc[1][i][j]);
            acc[2][i][j] = fmaf(ah[i], bl[j], acc[2][i][j]);
            acc[3][i][j] = fmaf(al[i], bh[j], acc[3][i][j]);
          }
        }
      }
    }
    if (more) store_slab(s ^ 1);
    __syncthreads();
    s ^= 1;
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n >= N) continue;
      float v = acc[0][i][j];
      if constexpr (kSplit) {
        v = (v + acc[1][i][j]) + (acc[2][i][j] + acc[3][i][j]);
      }
      epi(m, n, v, static_cast<int>(blockIdx.z));
    }
  }
}

// Launch the product over `slices` k slices of depth `kslice` (one slice of
// depth K: the whole contraction in a block).  Returns the launch's error.
template <int kPasses, typename TB, typename ARows, typename Epi>
cudaError_t launch_product(const ARows& a, const TB* w, int ldw,
                           const Epi& epi, int M, int N, int K, int slices,
                           int kslice, cudaStream_t stream) {
  if (M <= 0 || N <= 0 || slices <= 0) return cudaSuccess;
  const dim3 block(kThreads);
  if (N <= 16) {
    const dim3 grid(cdiv(M, 128), 1, slices);
    product_kernel<128, 16, kPasses><<<grid, block, 0, stream>>>(
        a, w, ldw, epi, M, N, K, kslice);
  } else if (2LL * cdiv(M, 64) * cdiv(N, 64) * slices >= sm_count()) {
    const dim3 grid(cdiv(M, 64), cdiv(N, 64), slices);
    product_kernel<64, 64, kPasses><<<grid, block, 0, stream>>>(
        a, w, ldw, epi, M, N, K, kslice);
  } else {
    const dim3 grid(cdiv(M, 32), cdiv(N, 32), slices);
    product_kernel<32, 32, kPasses><<<grid, block, 0, stream>>>(
        a, w, ldw, epi, M, N, K, kslice);
  }
  return cudaGetLastError();
}

// bias (optional) + activation in fp32, one rounding, C (M, N) row-major.
template <typename T>
struct BiasActStore {
  const T* bias;
  T* c;
  int N, act;
  __device__ __forceinline__ void finish(size_t at, int n, float v) const {
    if (bias != nullptr) v += to_f32(bias[n]);
    if (act == kActRelu) {
      v = fmaxf(v, 0.f);
    } else if (act == kActTanh) {
      v = tanhf(v);
    }
    store_as(c + at, v);
  }
  __device__ __forceinline__ void operator()(int m, int n, float v,
                                             int) const {
    finish(static_cast<size_t>(m) * N + n, n, v);
  }
};

}  // namespace
}  // namespace rvk
