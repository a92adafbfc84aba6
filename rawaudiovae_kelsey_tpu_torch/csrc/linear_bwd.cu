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
// bias sum (rvk::cotangent, gemm.cuh: every form computes it so, and forms
// the same bits).
//
// The first version, dw_fused.  The TPU kernel's grid (n blocks, batch
// chunks) visits the batch chunks in order and keeps a (k, block_n) panel of
// dW in VMEM across them.  Blocks of a CUDA grid run in no order, so a block
// here owns one tile of dW and loops over the whole batch itself, as the
// weight-gradient products of bwd.cu do (gemm.cuh with the contraction over
// the batch): no atomics, no second pass, equal bits on every launch.  What
// is new is the B operand: it is not loaded but formed from the y and dy
// slabs as they are staged into shared memory.  db is the column sum of those
// same staged (rounded) values, added in batch order by the first row of
// tiles.  Both operands are contiguous along their row index (x columns, da
// columns), so neighbouring threads load neighbouring columns.
//
// The first version, dx_fused.  The TPU kernel's second grid axis walks the n
// blocks in order with a (block_b, k) fp32 accumulator in VMEM; here that
// axis is the block's own contraction loop and the accumulator its
// registers, rounded once to the operand dtype at the end.  The A operand is
// da, formed at staging; B is w (k, n) read by its rows.  Both are
// contiguous along the contraction, so they are loaded with neighbouring
// threads on neighbouring n and stored transposed into the slabs.
// (matmul_nt_mask of bwd.cu gates the OUTPUT of a product; this kernel
// transforms an INPUT, so it shares no epilogue with it.)
//
// Which form a shape takes (ops/linear_bwd.py, ops/tensor_cores.py; the
// `kernel` code of the entry points):
// * bf16 with k and n multiples of 8 and every pointer on a 16-byte boundary
//   (what TMA addresses): the tensor-core forms of wgmma.cuh (header, "the
//   fused linear backward").  dx is the plain product's walk with da as a
//   register A: the producer stages y's and dy's (128 x 64) boxes where A's
//   box would go, and each consumer warpgroup reads its rows of both with
//   ldmatrix, forms da in fp32 as below, rounds it to bf16 and multiplies
//   from registers; B is w read by its rows (matmul_nt's).  dW is computed
//   as its transpose, dWᵀ = daᵀ · x: daᵀ the register A read from y's and
//   dy's (64 batch x 64 n) boxes by transposed ldmatrix, x the N-major B,
//   the batch cut into slices as grad_accum's (launch_wgrad), dW stored
//   transposed from the accumulators, db the row sums of the same rounded
//   daᵀ fragments, added across each quad of lanes.  da is formed once a
//   tile: k / tile_n times for each row block of dx, k / tile_n times for
//   each column block of dW.
// * fp32 with k and n multiples of 4 and 16-byte aligned pointers: the
//   register-tiled IEEE fp32 forms of sgemm.cuh (sgemm_fused_kernel): y
//   and dy staged by cp.async side by side, da formed as dx's K-major A is
//   transposed into its compute buffer, or in place of y for dW's N-major
//   B, whose column sums are db.
// * Every other shape (ragged widths, unaligned views) keeps the first
//   version below, the only one with no constraint on k, n and alignment.
//   It bounds by operations: at batch 4096, 4096 x 4096 each product is 137
//   GFLOP, run as fp32 FMAs on the CUDA cores in 64 x 64 tiles, 16-deep
//   slabs double-buffered through registers (the tiling of gemm.cuh), 10-13
//   TFLOP/s on an H100 in either dtype (PERF.md).
// No form writes da to device memory.  Every edge (batch, k, n) is masked
// or zero-filled: nothing is padded and no size need divide a tile.

#include "gemm.cuh"
#include "sgemm.cuh"
#include "wgmma.cuh"

// The tensor-core forms (wgmma.cuh) and the fp32 forms (sgemm.cuh): their
// launches, here where they are used, so that only this file compiles
// their kernels.
namespace rvk {
namespace tc {
namespace {

// dx (M, N) = da · wᵀ, rounded once to bf16, on the tensor cores in 128 x
// tile_n tiles, da = act'(y) · dy (act an rvk::Act) formed in registers from
// the staged y and dy (CotangentRows): y and dy (M, K), w (N, K) and dx (M,
// N) row-major bf16, 16-byte aligned, K and N multiples of 8.  One fp32
// accumulator an output over all of K, in order.
cudaError_t launch_dx_fused(const bf16* y, const bf16* dy, const bf16* w,
                            bf16* dx, int M, int N, int K, int act,
                            int tile_n, cudaStream_t stream) {
  if (M <= 0 || N <= 0) return cudaSuccess;
  if (K <= 0 || K % 8 != 0 || N % 8 != 0 || !aligned16(y) ||
      !aligned16(dy) || !aligned16(w) || !aligned16(dx)) {
    return cudaErrorInvalidValue;
  }
  return with_act(act, [&](auto a) {
    return with_width(tile_n, [&](auto width) {
      constexpr int BN = decltype(width)::value;
      Maps<1, true> maps;
      const cudaError_t errs[] = {
          matrix_map(&maps.a, y, M, K, kTileM, kTileK),
          matrix_map(&maps.a2, dy, M, K, kTileM, kTileK),
          matrix_map(&maps.b[0], w, N, K, BN, kTileK),
          matrix_map(&maps.c[0], dx, M, N, 64, 64)};
      for (const cudaError_t err : errs) {
        if (err != cudaSuccess) return err;
      }
      return launch_tiles<BN, false>(
          maps, RoundPair{}, CotangentRows<decltype(a)::value>{{M, K}}, N,
          stream);
    });
  });
}

// dw (M, N) = xᵀ · da and db (N,) = colsum(da), fp32, da = act'(y) · dy (act
// an rvk::Act) formed in registers: x (K, M), y and dy (K, N) row-major
// bf16, 16-byte aligned, M and N multiples of 8, K > 0 (the batch, any
// length).  The walk is the transpose, dWᵀ = daᵀ · x (CotangentWgrad: daᵀ
// the M-major A, read from y's and dy's (64 k x 64 n) boxes by transposed
// ldmatrix; x the N-major B), N / 128 tile rows of 128 x tile_n tiles, and
// each tile stores its dW block transposed; db is the row sums of the
// formed daᵀ, from the tiles of the first tile column.  The batch is cut
// into `split` slices as launch_wgrad_outs's: slice s writes dW and db to
// `workspace` at s · (M·N + N) when there are more than one, and sum_slices
// adds them in order.
cudaError_t launch_dw_fused(const bf16* x, const bf16* y, const bf16* dy,
                            float* dw, float* db, float* workspace, int M,
                            int N, int K, int act, int tile_n, int split,
                            cudaStream_t stream) {
  if (M <= 0 || N <= 0) return cudaSuccess;
  const int k_total = cdiv(K, kTileK);
  const int steps = split > 0 ? cdiv(k_total, split) : 0;
  if (K <= 0 || M % 8 != 0 || N % 8 != 0 || split < 1 ||
      cdiv(k_total, steps) != split || !aligned16(x) || !aligned16(y) ||
      !aligned16(dy) || !aligned16(dw) || !aligned16(db) ||
      (split > 1 && (workspace == nullptr || !aligned16(workspace)))) {
    return cudaErrorInvalidValue;
  }
  const size_t mn = size_t(M) * N;
  WgradOut epi{};
  epi.dw[0] = split == 1 ? dw : workspace;
  epi.db[0] = split == 1 ? db : workspace + mn;
  epi.stride = split == 1 ? 0 : mn + N;
  const cudaError_t err = with_act(act, [&](auto a) {
    return with_width(tile_n, [&](auto width) {
      constexpr int BN = decltype(width)::value;
      Maps<1, true> maps;
      const cudaError_t errs[] = {
          matrix_map(&maps.a, y, K, N, kTileK, 64),
          matrix_map(&maps.a2, dy, K, N, kTileK, 64),
          matrix_map(&maps.b[0], x, K, M, kTileK, 64)};
      for (const cudaError_t e : errs) {
        if (e != cudaSuccess) return e;
      }
      const CotangentWgrad<decltype(a)::value> tiles{
          {N, cdiv(N, kTileM), steps, k_total, split}};
      return launch_tiles<BN, true>(maps, epi, tiles, M, stream);
    });
  });
  if (err != cudaSuccess || split == 1) return err;
  SliceOut out{};
  out.dw[0] = dw;
  out.db[0] = db;
  return add_slices(workspace, out, mn, N, split, 1, stream);
}

}  // namespace
}  // namespace tc

namespace sgemm {
namespace {

// dx (M, N) = da · wᵀ in IEEE fp32, da = act'(y) · dy (act an rvk::Act)
// formed in the kernel: y and dy (M, K) and w (N, K) row-major fp32, K and
// N multiples of 4, every pointer 16-byte aligned; tile kTiles[tile], one
// accumulator an output over all of K in order.
cudaError_t launch_dx_fused(const float* y, const float* dy, const float* w,
                            float* dx, int M, int N, int K, int act,
                            int tile, cudaStream_t stream) {
  if (!takes(K, N, {y, dy, w, dx})) return cudaErrorInvalidValue;
  if (M <= 0 || N <= 0) return cudaSuccess;
  return with_tile(tile, [&](auto index) {
    constexpr int i = decltype(index)::value;
    return launch_fused_tile<kTiles[i][0], kTiles[i][1], true>(
        y, dy, w, nullptr, dx, nullptr, M, N, K, K, 1, 0, act, stream);
  });
}

// dw (M, N) = xᵀ · da and db (N,) = colsum(da) in IEEE fp32, da = act'(y) ·
// dy formed in the kernel: x (K, M), y and dy (K, N) row-major fp32, M and
// N multiples of 4, every pointer 16-byte aligned, K > 0 (the batch).  The
// batch is cut into `split` slices as launch_wgrad's, through `workspace`
// (split · (M·N + N) floats) when there are more than one.
cudaError_t launch_dw_fused(const float* x, const float* y, const float* dy,
                            float* dw, float* db, float* workspace, int M,
                            int N, int K, int act, int tile, int split,
                            cudaStream_t stream) {
  if (M <= 0 || N <= 0) return cudaSuccess;
  const int k_total = cdiv(K, kSliceRows);
  const int steps = split > 0 ? cdiv(k_total, split) : 0;
  if (K <= 0 || M % 4 != 0 || N % 4 != 0 || split < 1 ||
      cdiv(k_total, steps) != split ||
      !aligned({x, y, dy, dw, db, workspace}) ||
      (split > 1 && workspace == nullptr)) {
    return cudaErrorInvalidValue;
  }
  const size_t mn = size_t(M) * N;
  float* c = split == 1 ? dw : workspace;
  float* colsum = split == 1 ? db : workspace + mn;
  const size_t stride = split == 1 ? 0 : mn + N;
  const cudaError_t err = with_tile(tile, [&](auto index) {
    constexpr int i = decltype(index)::value;
    return launch_fused_tile<kTiles[i][0], kTiles[i][1], false>(
        x, nullptr, y, dy, c, colsum, M, N, K, steps * kSliceRows, split,
        stride, act, stream);
  });
  if (err != cudaSuccess || split == 1) return err;
  SliceOut out{};
  out.dw[0] = dw;
  out.db[0] = db;
  return add_slices(workspace, out, mn, N, split, 1, stream);
}

}  // namespace
}  // namespace sgemm
}  // namespace rvk

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
    float da = rvk::cotangent(act, to_f32(y[i]), to_f32(dy[i]));
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
// (k, n) and db (n,) fp32.  act an rvk::Act: none, relu or tanh.  kernel (an
// rvk::tc::Kernel): 0, the first version (tile, split and workspace
// ignored); 1, the tensor-core form (rvk::tc::launch_dw_fused), bf16 only,
// k and n multiples of 8, 16-byte aligned pointers, batch > 0, in tiles 128
// (n) x tile (k) over `split` slices of the batch, through `workspace`
// (split · (k·n + n) floats) when split > 1 (ops/tensor_cores.py
// wgrad_plan of the transpose); 2, the fp32 form of sgemm.cuh
// (rvk::sgemm::launch_dw_fused), fp32 only, k and n multiples of 4, 16-byte
// aligned pointers, batch > 0, on the tile sgemm::kTiles[tile] over `split`
// slices through `workspace` as above (sgemm_wgrad_plan).
int rvk_dw_fused(const void* x, const void* y, const void* dy, float* dw,
                 float* db, float* workspace, int batch, int k, int n,
                 int act, int dtype, int tile, int split, int kernel,
                 void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!known_act(act)) return cudaErrorInvalidValue;
  if (kernel == rvk::tc::kSgemm) {
    if (dtype != rvk::kF32 || batch <= 0) return cudaErrorInvalidValue;
    return rvk::sgemm::launch_dw_fused(src<float>(x), src<float>(y),
                                       src<float>(dy), dw, db, workspace, k,
                                       n, batch, act, tile, split, s);
  }
  if (kernel == rvk::tc::kTensorCores) {
    if (dtype != rvk::kBF16 || batch <= 0) return cudaErrorInvalidValue;
    using T = rvk::bf16;
    return rvk::tc::launch_dw_fused(src<T>(x), src<T>(y), src<T>(dy), dw, db,
                                    workspace, k, n, batch, act, tile, split,
                                    s);
  }
  if (kernel != rvk::tc::kCudaCores) return cudaErrorInvalidValue;
  return rvk::with_dtype(dtype, [&](auto tag) {
    using T = std::remove_pointer_t<decltype(tag)>;
    return launch_fused(Loaded<T, false>{src<T>(x), k},
                        Cotangent<T, false>{src<T>(y), src<T>(dy), n, act},
                        dw, db, k, n, batch, s);
  });
}

// y and dy (batch, n); w (k, n); dx (batch, k); all of one dtype.  kernel:
// 0, the first version (tile ignored); 1, the tensor-core form
// (rvk::tc::launch_dx_fused), bf16 only, k and n multiples of 8, 16-byte
// aligned pointers, in tiles 128 x tile (ops/tensor_cores.py); 2, the fp32
// form of sgemm.cuh (rvk::sgemm::launch_dx_fused), fp32 only, k and n
// multiples of 4, 16-byte aligned pointers, on the tile sgemm::kTiles[tile].
int rvk_dx_fused(const void* y, const void* dy, const void* w, void* dx,
                 int batch, int k, int n, int act, int dtype, int tile,
                 int kernel, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!known_act(act)) return cudaErrorInvalidValue;
  if (kernel == rvk::tc::kSgemm) {
    if (dtype != rvk::kF32) return cudaErrorInvalidValue;
    return rvk::sgemm::launch_dx_fused(src<float>(y), src<float>(dy),
                                       src<float>(w), dst<float>(dx), batch,
                                       k, n, act, tile, s);
  }
  if (kernel == rvk::tc::kTensorCores) {
    if (dtype != rvk::kBF16) return cudaErrorInvalidValue;
    using T = rvk::bf16;
    return rvk::tc::launch_dx_fused(src<T>(y), src<T>(dy), src<T>(w),
                                    dst<T>(dx), batch, k, n, act, tile, s);
  }
  if (kernel != rvk::tc::kCudaCores) return cudaErrorInvalidValue;
  return rvk::with_dtype(dtype, [&](auto tag) {
    using T = std::remove_pointer_t<decltype(tag)>;
    return launch_fused(Cotangent<T, true>{src<T>(y), src<T>(dy), n, act},
                        Loaded<T, true>{src<T>(w), n}, dst<T>(dx),
                        static_cast<float*>(nullptr), batch, k, n, s);
  });
}

}  // extern "C"
