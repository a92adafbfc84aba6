// The fused backward of one linear layer y = act(x @ w + b): the two
// products that consume the cotangent da = act'(y) · dy, with da formed
// inside each of them and never written to device memory.  fp32 or bf16
// operands, fp32 accumulation, a plain C interface for ctypes (ops/_build.py
// loads the library; ops/linear_bwd.py holds the wrappers and the plain
// PyTorch versions).
//
//   rvk_dw_fused   dW (k, n) = xᵀ · da  and  db (n,) = Σ_rows da, both fp32
//   rvk_dx_fused   dx (B, k) = da · wᵀ, in the operand dtype
//
// They replace the TPU kernels dw_fused (_dw_kernel) and dx_fused
// (_dx_kernel) of benchmarks/deep_bwd_probe.py.  da follows that file's
// _da: y and dy are brought to fp32; relu gives dy where y > 0 and 0
// elsewhere, tanh dy · (1 − y · y), none dy; the result is rounded to the
// operand dtype (to nearest even for bf16) BEFORE it enters a product or the
// bias sum.  The tanh branch is written with the rounding intrinsics so that
// the compiler cannot contract 1 − y · y into one fused multiply-add: it
// must give the bits of the three separate operations of the plain version.
//
// dw_fused.  The TPU kernel's grid (n blocks, batch chunks) visits the batch
// chunks in order and keeps a (k, block_n) panel of dW in VMEM across them.
// Blocks of a CUDA grid run in no order, so a block here owns one tile of dW
// and loops over the whole batch itself, as the weight-gradient products of
// bwd.cu do (gemm.cuh with the contraction over the batch): no atomics, no
// second pass, equal bits on every launch.  What is new is the B operand:
// it is not loaded but formed from the y and dy slabs as they are staged
// into shared memory.  db is the column sum of those same staged (rounded)
// values, added in batch order by the first row of tiles.  Both operands are
// contiguous along their row index (x columns, da columns), so neighbouring
// threads load neighbouring columns.
//
// dx_fused.  The TPU kernel's second grid axis walks the n blocks in order
// with a (block_b, k) fp32 accumulator in VMEM; here that axis is the
// block's own contraction loop and the accumulator its registers, rounded
// once to the operand dtype at the end.  The A operand is da, formed at
// staging; B is w (k, n) read by its rows.  Both are contiguous along the
// contraction, so they are loaded with neighbouring threads on neighbouring
// n and stored transposed into the slabs.  (matmul_nt_mask of bwd.cu gates
// the OUTPUT of a product; this kernel transforms an INPUT, so it shares no
// epilogue with it.)
//
// What bounds them: operations.  At the deep model's largest layer (batch
// 4096, 4096 x 4096) each product is 137 GFLOP over 160 MB (bf16) — far
// above the ridge — and runs as fp32 FMAs on the CUDA cores, 64 x 64 tiles,
// 16-deep slabs double-buffered through registers (the tiling of gemm.cuh).
// A tile of dW re-reads its y / dy slabs once per row of tiles (64 times at
// 4096²) and x once per column of tiles; blocks that run together share a
// column of tiles, so those re-reads are served by the 50 MB L2 and cost the
// extra activation arithmetic only.  bf16 mma.sync / wgmma on the staged
// slabs is the later step.  Every edge (batch, k, n) is masked: nothing is
// padded and no size need divide a tile.

#include "gemm.cuh"

using rvk::bf16;
using rvk::cdiv;
using rvk::dst;
using rvk::kBK;
using rvk::kThreads;
using rvk::src;
using rvk::to_f32;

namespace {

// An operand that is loaded as it is.  Element (r, k): r the row of A or the
// column of B, k the contraction index; kKC says which of the two is
// contiguous in memory.
template <typename T, bool kKContig>
struct Loaded {
  static constexpr bool kKC = kKContig;
  const T* p;
  int ld;
  __device__ __forceinline__ float at(int r, int k) const {
    const size_t i = kKC ? static_cast<size_t>(r) * ld + k
                         : static_cast<size_t>(k) * ld + r;
    return to_f32(p[i]);
  }
};

// The cotangent da = act'(y) · dy, formed from y and dy (both (B, n),
// row-major) and rounded to T.  As the B operand of dW it is read with r = a
// column of da and k = the batch row (kKContig = false); as the A operand
// of dx with r = the batch row and k = a column (kKContig = true).
template <typename T, bool kKContig>
struct Cotangent {
  static constexpr bool kKC = kKContig;
  const T* y;
  const T* dy;
  int ld, act;
  __device__ __forceinline__ float at(int r, int k) const {
    const size_t i = kKC ? static_cast<size_t>(r) * ld + k
                         : static_cast<size_t>(k) * ld + r;
    const float g = to_f32(dy[i]);
    float da = g;
    if (act == rvk::kActRelu) {
      da = to_f32(y[i]) > 0.f ? g : 0.f;
    } else if (act == rvk::kActTanh) {
      const float v = to_f32(y[i]);
      da = __fmul_rn(g, __fsub_rn(1.f, __fmul_rn(v, v)));
    }
    if constexpr (std::is_same<T, bf16>::value) {
      da = __bfloat162float(__float2bfloat16_rn(da));
    }
    return da;
  }
};

// C (M, N) = Σ_k A(m, k) · B(n, k), rounded once to TC; colsum[n] = Σ_k
// B(n, k) in k order when colsum is given.  The tiling of gemm.cuh's kernel
// with its operands behind at(): 256 threads as 16 x 16, a BM x BN tile,
// 16-deep slabs, double-buffered.
template <int BM, int BN, typename AOp, typename BOp, typename TC>
__global__ void __launch_bounds__(kThreads)
fused_kernel(const AOp a, const BOp b, TC* __restrict__ c,
             float* __restrict__ colsum, int M, int N, int K) {
  constexpr int TM = BM / 16;
  constexpr int TN = BN / 16;
  constexpr int LA = BM * kBK / kThreads;
  constexpr int LB = kBK * BN / kThreads;
  __shared__ float As[2][kBK][BM + 1];
  __shared__ float Bs[2][kBK][BN + 1];

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  // slab position (r, k) of the l-th value a thread stages: neighbouring
  // threads on the operand's contiguous axis
  auto a_pos = [](int l, int& r, int& k) {
    const int idx = threadIdx.x + l * kThreads;
    r = AOp::kKC ? idx / kBK : idx % BM;
    k = AOp::kKC ? idx % kBK : idx / BM;
  };
  auto b_pos = [](int l, int& r, int& k) {
    const int idx = threadIdx.x + l * kThreads;
    r = BOp::kKC ? idx / kBK : idx % BN;
    k = BOp::kKC ? idx % kBK : idx / BN;
  };

  float ra[LA], rb[LB];
  auto load_slab = [&](int k0) {
#pragma unroll
    for (int l = 0; l < LA; ++l) {
      int r, k;
      a_pos(l, r, k);
      const int m = m0 + r, kk = k0 + k;
      ra[l] = (m < M && kk < K) ? a.at(m, kk) : 0.f;
    }
#pragma unroll
    for (int l = 0; l < LB; ++l) {
      int r, k;
      b_pos(l, r, k);
      const int n = n0 + r, kk = k0 + k;
      rb[l] = (n < N && kk < K) ? b.at(n, kk) : 0.f;
    }
  };
  auto store_slab = [&](int s) {
#pragma unroll
    for (int l = 0; l < LA; ++l) {
      int r, k;
      a_pos(l, r, k);
      As[s][k][r] = ra[l];
    }
#pragma unroll
    for (int l = 0; l < LB; ++l) {
      int r, k;
      b_pos(l, r, k);
      Bs[s][k][r] = rb[l];
    }
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  }
  const bool sums = colsum != nullptr && blockIdx.x == 0 && ty == 0;
  float csum[TN];
#pragma unroll
  for (int j = 0; j < TN; ++j) csum[j] = 0.f;

  load_slab(0);
  store_slab(0);
  __syncthreads();
  int s = 0;
  for (int k0 = 0; k0 < K; k0 += kBK) {
    const bool more = k0 + kBK < K;
    if (more) load_slab(k0 + kBK);
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float av[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = As[s][kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = Bs[s][kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
    if (sums) {
#pragma unroll
      for (int kk = 0; kk < kBK; ++kk) {
#pragma unroll
        for (int j = 0; j < TN; ++j) csum[j] += Bs[s][kk][tx + 16 * j];
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
      rvk::store_as(c + static_cast<size_t>(m) * N + n, acc[i][j]);
    }
  }
  if (sums) {
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < N) colsum[n] = csum[j];
    }
  }
}

// 64 x 64 tiles when they give at least half the SMs a block, 32 x 32
// otherwise (the rule of gemm.cuh's launch_gemm).
template <typename AOp, typename BOp, typename TC>
cudaError_t launch_fused(const AOp& a, const BOp& b, TC* c, float* colsum,
                         int M, int N, int K, cudaStream_t stream) {
  if (M <= 0 || N <= 0) return cudaSuccess;
  const dim3 block(kThreads);
  if (2 * cdiv(M, 64) * cdiv(N, 64) >= rvk::sm_count()) {
    const dim3 grid(cdiv(M, 64), cdiv(N, 64));
    fused_kernel<64, 64><<<grid, block, 0, stream>>>(a, b, c, colsum, M, N,
                                                     K);
  } else {
    const dim3 grid(cdiv(M, 32), cdiv(N, 32));
    fused_kernel<32, 32><<<grid, block, 0, stream>>>(a, b, c, colsum, M, N,
                                                     K);
  }
  return cudaGetLastError();
}

bool known_act(int act) {
  return act == rvk::kActNone || act == rvk::kActRelu ||
         act == rvk::kActTanh;
}

}  // namespace

extern "C" {

// x (batch, k); y and dy (batch, n); all of one dtype (rvk::DType).  dw
// (k, n) and db (n,) fp32.  act an rvk::Act: none, relu or tanh.
int rvk_dw_fused(const void* x, const void* y, const void* dy, float* dw,
                 float* db, int batch, int k, int n, int act, int dtype,
                 void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!known_act(act)) return cudaErrorInvalidValue;
  return rvk::with_dtype(dtype, [&](auto tag) {
    using T = std::remove_pointer_t<decltype(tag)>;
    return launch_fused(Loaded<T, false>{src<T>(x), k},
                        Cotangent<T, false>{src<T>(y), src<T>(dy), n, act},
                        dw, db, k, n, batch, s);
  });
}

// y and dy (batch, n); w (k, n); dx (batch, k); all of one dtype.
int rvk_dx_fused(const void* y, const void* dy, const void* w, void* dx,
                 int batch, int k, int n, int act, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!known_act(act)) return cudaErrorInvalidValue;
  return rvk::with_dtype(dtype, [&](auto tag) {
    using T = std::remove_pointer_t<decltype(tag)>;
    return launch_fused(Cotangent<T, true>{src<T>(y), src<T>(dy), n, act},
                        Loaded<T, true>{src<T>(w), n}, dst<T>(dx),
                        static_cast<float*>(nullptr), batch, k, n, s);
  });
}

}  // extern "C"
