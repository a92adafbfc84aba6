// fp32 mainloop for Hopper's CUDA cores (sm_90a): the device routine of the
// fp32 forms of rvk_linear_fwd (linear.cu), rvk_matmul_nt, rvk_grad_accum,
// rvk_matmul_nt_mask and rvk_matmul_nt2_mask (bwd.cu: sgemm_gated_kernel),
// rvk_encoder_fwd and rvk_decoder_fwd (mlp.cu), rvk_quantized_decoder_fwd
// (quant.cu: an int8 B), rvk_dx_fused and rvk_dw_fused (linear_bwd.cu:
// sgemm_fused_kernel), the fp32 forms of rvk_enc_bwd_dw1,
// rvk_grad_accum2 and rvk_dec_bwd_fused (bwd.cu: the launches above, one
// after another), and the fp32 one-pass rvk_toeplitz_fwd (toeplitz.cu:
// sgemm_toeplitz_kernel on product_tile with an implicit Toeplitz A).
//
//   C[m, n] = epi( sum_k A[m, k] * B[k, n] )
//
// IEEE fp32 FFMAs, one fp32 accumulator per output, k in order: the
// `float32` and `highest` tiers promise IEEE fp32 products, so neither TF32
// nor a bf16 split of the operands.  A is one of two layouts, a
// compile-time choice: K-major, a (M, K) row-major matrix (x of the linear
// layer, a of matmul_nt), or M-major, a (K, M) row-major matrix read as its
// transpose (aᵀ of the weight gradient aᵀ b, the contraction over the
// batch).  B is one of two layouts too: K-major, a (N, K) row-major matrix
// read by its rows (a @ wᵀ: matmul_nt's w), or N-major, a (K, N) row-major
// matrix (x @ w: the linear layer's w; b of the weight gradient).  The
// epilogue adds the bias (optional) and applies none / relu / tanh, a
// template argument, then stores 16 bytes a thread; or, as the gate
// (kActGate), keeps the sum where the gate's value at the same place is
// above zero and stores 0 elsewhere.
//
// Which TPU kernels run on it: linear_fwd (_linear_kernel) of
// rawaudiovae_kelsey_tpu/ops/pallas_linear.py, matmul_nt, matmul_nt_mask,
// matmul_nt2_mask, grad_accum (_grad_accum_kernel), encoder_fwd and
// decoder_fwd of rawaudiovae_kelsey_tpu/ops/pallas_mlp.py,
// quantized_decoder_fwd of rawaudiovae_kelsey_tpu/ops/quant.py, toeplitz_fwd
// (_toeplitz_kernel) of rawaudiovae_kelsey_tpu/ops/pallas_toeplitz.py, and
// dw_fused and dx_fused of benchmarks/deep_bwd_probe.py, in fp32.  As
// there, an output tile carries one accumulator across its contraction,
// and a block walks its k range itself, in order.  The forward products of
// launch take all of K in one slice: no workspace, no atomics, so two
// launches give equal bits.  The encoder and decoder (launch_fwd) may cut
// K into slices (the grid's z) where their output is too few tiles to fill
// the card (the server's 256 rows), each slice's sums written to a
// workspace and added in order, the bias and the activation after them
// (slices_epilogue, slices.cuh); the encoder's two heads are one grid whose
// tile columns run over both outputs (sgemm_heads_kernel).  The weight gradient (launch_wgrad)
// computes dW = aᵀ b and db = colsum(b): at the training microbatch dW21,
// dW22 (2048 x 256) and dW3 (256 x 2048) are 32 tiles of 128 x 128 for
// 132 SMs, so the batch is cut into slices (the grid's z), each slice a
// whole dW written to a workspace, added in order afterwards (sum_slices,
// slices.cuh): the same bits on every launch.  The TPU kernel carries dW
// in VMEM across its sequential batch grid; here each slice is one block's
// walk over its rows of the batch.  The gated input gradients
// (launch_gated) are a @ wᵀ with the gate in the epilogue, and the encoder's
// dh the two heads' products joined along k: A = [a1 a2] and B = [w1 w2],
// both K-major, the first pair's k read from a1 / w1 and the rest from a2 /
// w2 as the slabs are copied (Operand, kJoin), one accumulator over both in
// k order.
//
// What bounds it.  At 4096 x 4096 -> 4096 the product is 137 GFLOP on 201
// MB: 683 FLOPs a byte against the card's fp32 ridge of 20 (67 TFLOP/s
// over 3.35 TB/s), so FFMA issue is the limit.  An SM issues 128 FFMA
// lanes a clock from four schedulers, one warp instruction each, and its
// shared memory returns 128 bytes a clock; the design is about keeping
// every issue slot on an FFMA.
//
// Design.
// * Tiles and threads.  A block of 256 threads owns a BM x BN tile of C,
//   128 x 128, 128 x 64 or 64 x 64, chosen by the caller (ops/
//   tensor_cores.py sgemm_tile: the fewest waves of tiles times the tile's
//   area, the larger on a tie; kTiles below).  Its eight warps stand 2 (m)
//   x 4 (n), each over a warp tile of BM / 2 x BN / 4; a warp's 32 lanes
//   stand 8 (m) x 4 (n), and each lane keeps RM x RN sub-tiles of 4 x 4
//   accumulators (RM = BM / 64, RN = BN / 64): 8 x 8 at 128 x 128, 64 FMAs
//   for every 16 floats read.  A k-step reads a lane's 4 rows of A and 4
//   columns of B of each sub-tile as one 16-byte load each (LDS.128): the
//   eight lanes of a quarter warp read eight neighbouring 16-byte chunks of
//   A and one chunk of B (a broadcast), so no read waits on a bank.
// * Staging.  K is walked in slabs of kBK, 16 deep at 128 x 128 and 32 for
//   the narrower tiles, through a ring of kStages = 4 slabs in shared memory
//   filled by 16-byte cp.async.cg copies (three slabs in flight while the
//   fourth is computed).  An N-major operand is copied as it lies, k-rows
//   of BN floats, and read straight from the ring.  A K-major operand
//   arrives as rows of kBK k; after its slab has landed each thread reads
//   back the 16-byte chunks it copied itself (no barrier: a thread's own
//   cp.async writes are visible to it once waited for) and stores them
//   k-major into one of two compute buffers, As[k][m], so that the k-step
//   reads m-contiguous chunks.  A warp's copies cover 32 / (kBK / 4) rows x
//   kBK / 4 k-quads; the chunk index is XORed with the quad (scaled to
//   spread over 8 chunks) so that its transposed stores hit 32 distinct
//   banks, and the readers apply the same XOR, which keeps their eight
//   chunks distinct.  One __syncthreads a slab; within it the fragments of
//   k-step k + 1 are read while k-step k's FMAs run.
// * Ragged edges.  Copies of rows past M or N and of k past K are zero
//   fills (cp.async with a source size of 0), so the loop has no mask; the
//   epilogue skips rows past M and 16-byte column chunks past N.
// * An M-major A is staged as an N-major B is: copied as it lies, k-rows of
//   BM floats, read straight from the ring (no compute buffers, no
//   transposition), so the weight gradient takes the x @ w form's shared
//   memory for both operands.
// * An int8 N-major B with one fp32 scale a column (the int8 decoder's q
//   (K, N) and s (N,)) is copied as it lies into a ring of int8 slabs, a
//   quarter of the fp32 ring's bytes, by 4-byte cp.async.ca copies, one a
//   4 columns, placed as the fp32 operand's 16-byte copies are.  After a
//   slab has landed each thread reads back the copies it made itself (no
//   barrier, as for a K-major operand), dequantizes each value as q · s
//   (one fp32 multiply, rounded to nearest: dequantize_weight's bits) and
//   stores it into one of two fp32 compute buffers, which the k-steps read
//   as they read an fp32 ring.  A thread's columns are the same in every
//   slab, so its four scales are loaded once.  Each element is dequantized
//   once a block, 1/64 of the FFMAs at 64 x 64; the k order and the FFMAs
//   are the fp32 operand's, so the product equals the fp32 kernel's on the
//   dequantized matrix bit for bit.
// * The block-Toeplitz product's A (ToeplitzA, Operand kToe) is the flat
//   signal read as overlapping rows, row (b, t) starting at element (t −
//   shift) · G + k0 of batch row b: a thread works out its rows' batch row
//   and offset once (WindowRows; its rows are the same in every slab), and
//   each 16-byte copy is checked against its batch row, a zero fill
//   outside.  Nothing is padded or copied; the rows' overlap is served by
//   L2.  The contraction is the caller's window of the tap stack (the conv1d
//   layers' packed stacks hold zeros outside it), B from its origin.
// * The bias gradient colsum(b) of the weight gradient is summed by the
//   blocks of dW's first tile row from the B slabs they already hold in
//   shared memory, while the FFMAs run: thread t adds column t % BN over
//   the rows of its group t / BN (kThreads / BN groups of kBK · BN /
//   kThreads rows a slab), in k order; the groups are added in order at the
//   end.  No second read of b; rows past the batch are zero fills.
// * What it takes: k and n multiples of 4 (16-byte rows and chunks, 4-byte
//   ones for an int8 B; m and n
//   for the weight gradient; each pair's k for a joined product, so that no
//   16-byte copy straddles the join) and 16-byte aligned base pointers; the
//   callers check, and every other fp32 shape keeps the first version
//   (gemm.cuh).
// * Registers.  __launch_bounds__(256, 2): two blocks an SM, at most 128
//   registers a thread; the build's ptxas report shows the count and any
//   spill; an int8 B's four scales take four more, and at 128 x 128 that
//   form spills 20 bytes.  Shared memory, (4 + 2) slabs of a K-major
//   operand and 4 of an N-major one: 80 KB at 128 x 128 for x @ w, 96 KB
//   for a @ wᵀ and its gated and joined forms (the gate is read from
//   device memory in the epilogue, once a tile); 128 and 144 KB at 128 x
//   64, where the grids hold about one block an SM; an int8 B's ring is a
//   quarter of an fp32 one, beside its two fp32 compute buffers (72 KB at
//   128 x 128).
// The slab depths, the ring's depth and the fragment pipelining are the
// fastest of the variants timed against one another on an H100 (PERF.md).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>
#include <type_traits>

#include "gemm.cuh"
#include "slices.cuh"

namespace rvk {
namespace sgemm {
namespace {

constexpr int kThreads = 256;
// tile index (the entry points' `tile` argument) → (BM, BN);
// ops/tensor_cores.py SGEMM_TILES
constexpr int kTiles[3][2] = {{128, 128}, {128, 64}, {64, 64}};

constexpr int kStages = 4;  // the cp.async ring, in slabs
// a slice of a weight gradient's batch is a whole number of these rows
// (ops/tensor_cores.py sgemm_wgrad_plan; the tensor-core form's k-step)
constexpr int kSliceRows = 64;
// The slab's depth in k, by tile: 16 at 128 x 128 (the large grids, two
// blocks an SM); 32 for the narrower tiles (grids of about one block an SM,
// where each slab's barrier and transposition stand exposed).
template <int BM, int BN>
constexpr int kSlabDepth = BM * BN >= 128 * 128 ? 16 : 32;

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// the 4-byte copy of an int8 operand: four values, a column each
__device__ __forceinline__ void cp_async4(int8_t* dst, const int8_t* src,
                                          bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// one copy of four consecutive elements: 16 bytes of fp32, 4 of int8
__device__ __forceinline__ void copy4(float* dst, const float* src,
                                      bool valid) {
  cp_async16(dst, src, valid);
}
__device__ __forceinline__ void copy4(int8_t* dst, const int8_t* src,
                                      bool valid) {
  cp_async4(dst, src, valid);
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// every group but the newest `kPending` has landed (this thread's copies)
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// The implicit A of the block-Toeplitz product (toeplitz.cu): row m = (b,
// t) of B · t_out rows, element k the flat element (t − shift) · G + k0 + k
// of batch row b of x (B, nb · G), zero outside [0, nb · G); k0 is the
// contraction window's origin.  G and k0 are multiples of 4 (so is
// row_len = nb · G), so a 16-byte copy, four k from a multiple of 4, lies
// wholly inside its batch row or wholly outside it: cp.async zero-fills
// the copies outside, which is the SAME padding and the batch edge.
struct ToeplitzA {
  const float* x;
  int t_out, shift, G, row_len, k0;
};

// A thread's rows of a Toeplitz A, worked out once before the mainloop (a
// thread copies the same rows in every slab): each copy's batch row b and
// the flat offset f = (t − shift) · G + k0 of its row's element k = 0.
template <int kCopies>
struct WindowRows {
  int b[kCopies], f[kCopies];
};

// One operand seen as R rows (M of A, N of B) by K, staged in slabs of
// kBK through a ring of kS slabs.  kKMajor: element (r, k) at p[r * ld +
// k]; otherwise at p[k * ld + r].  A Toeplitz operand (kToe, K-major fp32
// only: the block-Toeplitz product's A) reads element (r, k) through a
// ToeplitzA and the thread's WindowRows instead.  Its shared memory, in
// floats: the ring, and for a K-major operand two transposed compute
// buffers after it.  A
// formed operand (kForm: the cotangent da = act'(y) · dy of the fused
// linear backward, linear_bwd.cu) has a second ring for dy beside y's, and
// the pass that reads a slab back forms da from the two (rvk::cotangent):
// into the compute buffer as it transposes a K-major operand, in place of
// y in its own ring for an N-major one.  A joined operand (kJoin, K-major
// only: the encoder's dh, [a1 a2] and [w1 w2]) is two matrices of `ld`
// columns side by side along k: k below ld from p, the rest from q at k -
// ld.  ld is a multiple of 4, so a 16-byte copy never straddles the join.
// An int8 operand (T = int8_t, N-major only: the int8 decoder's weights)
// has a ring of int8 slabs and, after it, two fp32 compute buffers that
// the read-back pass fills with the dequantized values q · s[column].
template <int R, bool kKMajor, int kBK, int kS = kStages, bool kForm = false,
          bool kJoin = false, typename T = float, bool kToe = false>
struct Operand {
  static_assert(!kJoin || (kKMajor && !kForm),
                "a joined operand is K-major and not formed");
  static constexpr bool kQuant = std::is_same<T, int8_t>::value;
  static_assert(!kQuant || (!kKMajor && !kForm && !kJoin),
                "an int8 operand is N-major, neither formed nor joined");
  static_assert(!kToe || (kKMajor && !kForm && !kJoin && !kQuant),
                "a Toeplitz operand is a K-major fp32 A");
  static constexpr int kSlab = R * kBK;  // elements
  static constexpr int kRings = kForm ? 2 : 1;
  // the ring's floats (an int8 slab is a quarter of an fp32 one), then the
  // compute buffers of a K-major or an int8 operand
  static constexpr int kRingFloats =
      static_cast<int>(kRings * kS * kSlab * sizeof(T) / 4);
  static constexpr bool kBuffers = kKMajor || kQuant;
  static constexpr int kFloats = kRingFloats + (kBuffers ? 2 : 0) * kSlab;
  static constexpr int kCopies = kSlab / 4 / kThreads;  // a thread's, a slab
  static_assert(kCopies >= 1 && kSlab % (4 * kThreads) == 0,
                "a slab is whole copies of 4 elements, the same count a "
                "thread");
  static_assert(kKMajor || kThreads % (R / 4) == 0,
                "an N-major operand's thread copies the same columns in "
                "every slab");
  static constexpr int kQuads = kBK / 4;  // 16-byte copies a row of a slab
  static_assert((kQuads & (kQuads - 1)) == 0 && kQuads <= 8,
                "a power of two of k-quads, at most 8");

  // The XOR of a K-major compute buffer's 16-byte chunk index at k-row k.
  // A warp's copies cover 32 / kQuads rows x kQuads k-quads; the quad q
  // of k (k / 4) moves the chunk by q * 8 / kQuads, so that the warp's
  // transposed stores of one k-offset hit 32 distinct banks.  Readers XOR
  // the same value, a permutation within an aligned group of 8 chunks.
  __device__ __forceinline__ static int swizzle(int k) {
    return ((k >> 2) & (kQuads - 1)) * (8 / kQuads);
  }

  // the slab's i-th copy of 4 elements of this thread: row r (of R) and k
  // offset kq for a K-major operand; k-row kq and column r for an N-major
  // one (the same r in every copy and slab)
  __device__ __forceinline__ static void place(int i, int& r, int& kq) {
    const int idx = threadIdx.x + i * kThreads;
    if (kKMajor) {
      r = idx / kQuads, kq = (idx % kQuads) * 4;
    } else {
      kq = idx / (R / 4), r = (idx % (R / 4)) * 4;
    }
  }

  // a Toeplitz operand's WindowRows of this thread
  using Rows = WindowRows<kCopies>;

  // This thread's rows from r0 of a Toeplitz A of M rows (rows past M
  // are never read: issue zero-fills them).
  __device__ __forceinline__ static Rows window_rows(const ToeplitzA& toe,
                                                     int r0, int M) {
    Rows w{};
#pragma unroll
    for (int i = 0; i < kCopies; ++i) {
      int r, kq;
      place(i, r, kq);
      const int m = r0 + r;
      if (m < M) {
        const int b = m / toe.t_out, t = m - b * toe.t_out;
        w.b[i] = b;
        w.f[i] = (t - toe.shift) * toe.G + toe.k0;
      }
    }
    return w;
  }

  // start the copies of slab `slab` into ring stage `stage`; rows from r0
  // of `rows`, k of K; a formed operand's q (dy, laid out as p) into the
  // second ring; a joined operand's k from ld on from q; a Toeplitz
  // operand's from toe.x through this thread's rows `win`, zero outside
  // the batch row
  __device__ __forceinline__ static void issue(float* sm, const T* p,
                                               const T* q, int ld, int r0,
                                               int rows, int K, int slab,
                                               int stage,
                                               const ToeplitzA& toe = {},
                                               const Rows& win = {}) {
    T* ring = reinterpret_cast<T*>(sm) + stage * kSlab;
    const int k0 = slab * kBK;
#pragma unroll
    for (int i = 0; i < kCopies; ++i) {
      int r, kq;
      place(i, r, kq);
      const int row = r0 + r, k = k0 + kq;
      const int to = kKMajor ? r * kBK + kq : kq * R + r;
      if constexpr (kToe) {
        // the flat element of k in the batch row, in range or not as a
        // whole 16-byte copy
        const int e = win.f[i] + k;
        const bool valid = row < rows && k < K &&
                           static_cast<unsigned>(e) <
                               static_cast<unsigned>(toe.row_len);
        copy4(ring + to,
              valid ? toe.x + static_cast<size_t>(win.b[i]) * toe.row_len + e
                    : toe.x,
              valid);
        continue;
      }
      const bool valid = row < rows && k < K;
      // a joined operand's k from ld on is q's at k - ld
      const bool second = kJoin && k >= ld;
      const int kk = second ? k - ld : k;
      const size_t at = kKMajor ? static_cast<size_t>(row) * ld + kk
                                : static_cast<size_t>(kk) * ld + row;
      copy4(ring + to, valid ? (second ? q : p) + at : p, valid);
      if constexpr (kForm) {
        copy4(ring + kS * kSlab + to, valid ? q + at : q, valid);
      }
    }
  }

  // This thread's copies of ring stage `stage`, read back: a K-major
  // operand's k-major into compute buffer `buf` (swizzled); a formed one's
  // as da (act an rvk::Act), an N-major one's in place; an int8 one's
  // dequantized, q · scale (its four columns' scales) rounded once, into
  // compute buffer `buf` as it lies.  Nothing for an fp32 N-major operand
  // that is loaded as it is.
  __device__ __forceinline__ static void transpose(float* sm, int stage,
                                                   int buf, int act,
                                                   float4 scale = {}) {
    if constexpr (kQuant) {
      const int8_t* ring =
          reinterpret_cast<const int8_t*>(sm) + stage * kSlab;
      float* out = sm + kRingFloats + buf * kSlab;
#pragma unroll
      for (int i = 0; i < kCopies; ++i) {
        int r, kq;
        place(i, r, kq);
        const int at = kq * R + r;
        const char4 q = *reinterpret_cast<const char4*>(ring + at);
        *reinterpret_cast<float4*>(out + at) =
            make_float4(__fmul_rn(static_cast<float>(q.x), scale.x),
                        __fmul_rn(static_cast<float>(q.y), scale.y),
                        __fmul_rn(static_cast<float>(q.z), scale.z),
                        __fmul_rn(static_cast<float>(q.w), scale.w));
      }
    } else if constexpr (kKMajor || kForm) {
      float* ring = sm + stage * kSlab;
      float* out = sm + kRingFloats + buf * kSlab;
#pragma unroll
      for (int i = 0; i < kCopies; ++i) {
        int r, kq;
        place(i, r, kq);
        const int at = kKMajor ? r * kBK + kq : kq * R + r;
        float4 v = *reinterpret_cast<const float4*>(ring + at);
        if constexpr (kForm) {
          const float4 g =
              *reinterpret_cast<const float4*>(ring + kS * kSlab + at);
          v = make_float4(cotangent(act, v.x, g.x), cotangent(act, v.y, g.y),
                          cotangent(act, v.z, g.z), cotangent(act, v.w, g.w));
        }
        if constexpr (kKMajor) {
          const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int k = kq + j;
            out[k * R + (((r >> 2) ^ swizzle(k)) << 2) + (r & 3)] = e[j];
          }
        } else {
          *reinterpret_cast<float4*>(ring + at) = v;
        }
      }
    }
  }

  // the buffer the k-steps of slab t read
  __device__ __forceinline__ static const float* compute(const float* sm,
                                                          int t) {
    return kBuffers ? sm + kRingFloats + (t & 1) * kSlab
                    : sm + (t % kS) * kSlab;
  }

  // an int8 operand's scales of this thread's four columns from n0 (zeros
  // past N, whose values are zero fills); zeros for any other operand
  __device__ __forceinline__ static float4 scales(const float* s, int n0,
                                                  int N) {
    float4 v = {};
    if constexpr (kQuant) {
      int r, kq;
      place(0, r, kq);
      if (n0 + r < N) v = *reinterpret_cast<const float4*>(s + n0 + r);
    }
    return v;
  }

  // rows r .. r + 3 (r a multiple of 4) at k-row k of a compute buffer
  __device__ __forceinline__ static float4 frag(const float* buf, int k,
                                                int r) {
    const int at = kKMajor ? (((r >> 2) ^ swizzle(k)) << 2) : r;
    return *reinterpret_cast<const float4*>(buf + k * R + at);
  }
};

__device__ __forceinline__ float lane(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// One block's output tile of C (M, N) = act(A · B + bias), its columns
// from n0: A (M, K) if kAKMajor, else (K, M); B (N, K) if kBKMajor, else
// (K, N); bias (N,) or null.  Slice z = blockIdx.z of the contraction is k
// in [z · rows, min(K, (z + 1) · rows)), `rows` a multiple of kSliceRows
// (or all of K in one slice); it writes its sums to c + z · stride and, for
// a weight gradient (M-major A), the column sums of its B to colsum + z ·
// stride from the blocks of the first tile row.  A formed operand (kFormA,
// kFormB: the fused linear backward's cotangent) is da = act'(y) · dy with
// y at a (or b) and dy at a2 (or b2), both laid out as the operand, and
// `form` the activation (an rvk::Act); kS is the ring's depth in slabs.  A
// joined product (kJoin: both operands K-major) contracts [a a2] with [b
// b2] along k, K the sum of both pairs' (equal) k.  kAct == kActGate: C =
// where(gate > 0, A · B, 0), gate (M, N) laid out as C, no bias.  TB =
// int8_t: B is the int8 q (K, N), N-major, dequantized with the column
// scales `scale` (N,) as its slabs are read back.  kToe: A is the implicit
// Toeplitz operand `toe` (K-major; `a` unused), B its taps from the
// window's origin.
template <int BM, int BN, bool kAKMajor, bool kBKMajor, int kAct,
          bool kFormA = false, bool kFormB = false, int kS = kStages,
          bool kJoin = false, typename TB = float, bool kToe = false>
__device__ __forceinline__ void product_tile(
    const float* __restrict__ a, const TB* __restrict__ b,
    const float* __restrict__ bias, float* __restrict__ c,
    float* __restrict__ colsum, int M, int N, int K, int rows, size_t stride,
    int n0, const float* __restrict__ a2 = nullptr,
    const TB* __restrict__ b2 = nullptr, int form = kActNone,
    const float* __restrict__ gate = nullptr,
    const float* __restrict__ scale = nullptr, const ToeplitzA& toe = {}) {
  constexpr int kBK = kSlabDepth<BM, BN>;
  using OpA = Operand<BM, kAKMajor, kBK, kS, kFormA, kJoin, float, kToe>;
  using OpB = Operand<BN, kBKMajor, kBK, kS, kFormB, kJoin, TB>;
  constexpr int RM = BM / 64, RN = BN / 64;  // 4 x 4 sub-tiles a lane
  constexpr int WM = BM / 2, WN = BN / 4;    // the warp tile
  // a weight gradient sums B's columns: kGroups groups of kGroupRows rows
  // of each slab
  constexpr bool kColsum = !kAKMajor;
  constexpr int kGroups = kThreads / BN;
  constexpr int kGroupRows = kBK / kGroups;
  static_assert(!kColsum || (!kBKMajor && kGroupRows * kGroups == kBK),
                "the column sums read whole rows of an N-major B slab");
  extern __shared__ float4 smem4[];
  float* sa = reinterpret_cast<float*>(smem4);
  float* sb = sa + OpA::kFloats;

  const int m0 = blockIdx.y * BM;
  const int warp = threadIdx.x / 32, lane_id = threadIdx.x % 32;
  const int am = (warp / 4) * WM + (lane_id % 8) * 4;  // a lane's first row
  const int bn = (warp % 4) * WN + (lane_id / 8) * 4;  // and column
  // a joined operand's rows are each pair's k long
  const int lda = kJoin ? K / 2 : kAKMajor ? K : M;
  const int ldb = kJoin ? K / 2 : kBKMajor ? K : N;
  // this slice's k range, in slabs from `first`
  const int z = blockIdx.z;
  const int k_end = min(K, (z + 1) * rows);
  const int first = z * rows / kBK;
  const int slabs = (k_end + kBK - 1) / kBK - first;
  c += z * stride;
  const bool sums = kColsum && blockIdx.y == 0;
  float csum = 0.f;
  // a Toeplitz A's rows of this thread (nothing for any other A)
  typename OpA::Rows win{};
  if constexpr (kToe) win = OpA::window_rows(toe, m0, M);

#pragma unroll
  for (int s = 0; s < kS - 1; ++s) {
    if (s < slabs) {
      OpA::issue(sa, a, a2, lda, m0, M, k_end, first + s, s, toe, win);
      OpB::issue(sb, b, b2, ldb, n0, N, k_end, first + s, s);
    }
    cp_async_commit();
  }
  // an int8 B's column scales, for every slab this thread reads back
  const float4 bscale = OpB::scales(scale, n0, N);
  cp_async_wait<kS - 2>();
  OpA::transpose(sa, 0, 0, form);
  OpB::transpose(sb, 0, 0, form, bscale);
  __syncthreads();

  float acc[RM][RN][4][4];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j)
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[i][j][u][v] = 0.f;

  for (int t = 0; t < slabs; ++t) {
    // slab t + 2 into the stage slab t - 1 left: every thread passed the
    // barrier after computing it, and read back its own copies of it
    const int next = t + kS - 1;
    if (next < slabs) {
      OpA::issue(sa, a, a2, lda, m0, M, k_end, first + next, next % kS, toe,
                 win);
      OpB::issue(sb, b, b2, ldb, n0, N, k_end, first + next, next % kS);
    }
    cp_async_commit();

    // the fragments of k-step k + 1 are read while k-step k's FMAs run
    const float* as = OpA::compute(sa, t);
    const float* bs = OpB::compute(sb, t);
    float4 fa[2][RM], fb[2][RN];
#pragma unroll
    for (int i = 0; i < RM; ++i) fa[0][i] = OpA::frag(as, 0, am + 32 * i);
#pragma unroll
    for (int j = 0; j < RN; ++j) fb[0][j] = OpB::frag(bs, 0, bn + 16 * j);
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      if (k + 1 < kBK) {
#pragma unroll
        for (int i = 0; i < RM; ++i)
          fa[(k + 1) & 1][i] = OpA::frag(as, k + 1, am + 32 * i);
#pragma unroll
        for (int j = 0; j < RN; ++j)
          fb[(k + 1) & 1][j] = OpB::frag(bs, k + 1, bn + 16 * j);
      }
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < RN; ++j)
#pragma unroll
          for (int u = 0; u < 4; ++u)
#pragma unroll
            for (int v = 0; v < 4; ++v)
              acc[i][j][u][v] = fmaf(lane(fa[k & 1][i], u),
                                     lane(fb[k & 1][j], v), acc[i][j][u][v]);
    }

    if constexpr (kColsum) {
      // this slab's rows of B, in k order, for the bias gradient
      if (sums) {
        const float* col = bs + (threadIdx.x / BN) * kGroupRows * BN +
                           threadIdx.x % BN;
#pragma unroll
        for (int r = 0; r < kGroupRows; ++r) csum += col[r * BN];
      }
    }

    if (t + 1 < slabs) {
      // slab t + 1 has landed (this thread's copies); a K-major operand's
      // goes k-major, an int8 one's dequantized, into the compute buffer
      // slab t - 1 used
      cp_async_wait<kS - 2>();
      OpA::transpose(sa, (t + 1) % kS, (t + 1) & 1, form);
      OpB::transpose(sb, (t + 1) % kS, (t + 1) & 1, form, bscale);
    }
    __syncthreads();
  }

  if constexpr (kColsum) {
    // the groups' sums added in order (the ring is idle: every copy has
    // landed and every thread passed the last slab's barrier)
    if (sums) {
      const int t = threadIdx.x;
      sa[t] = csum;
      __syncthreads();
      if (t < BN && n0 + t < N) {
        float v = 0.f;
#pragma unroll
        for (int g = 0; g < kGroups; ++g) v += sa[g * BN + t];
        colsum[z * stride + n0 + t] = v;
      }
    }
  }

  // epilogue: the sum first, then the bias, as the plain `x @ w + b` does;
  // or the gate: its 16-byte chunk where the output's goes, compared in
  // fp32 (pallas_mlp.py:359-360, 393-394)
#pragma unroll
  for (int j = 0; j < RN; ++j) {
    const int n = n0 + bn + 16 * j;
    if (n >= N) continue;
    float4 bj = make_float4(0.f, 0.f, 0.f, 0.f);
    if (bias != nullptr) bj = *reinterpret_cast<const float4*>(bias + n);
#pragma unroll
    for (int i = 0; i < RM; ++i) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int m = m0 + am + 32 * i + u;
        if (m >= M) continue;
        const size_t at = static_cast<size_t>(m) * N + n;
        float4 out;
        if constexpr (kAct == kActGate) {
          const float4 g = *reinterpret_cast<const float4*>(gate + at);
          out.x = g.x > 0.f ? acc[i][j][u][0] : 0.f;
          out.y = g.y > 0.f ? acc[i][j][u][1] : 0.f;
          out.z = g.z > 0.f ? acc[i][j][u][2] : 0.f;
          out.w = g.w > 0.f ? acc[i][j][u][3] : 0.f;
        } else {
          out.x = activate<kAct>(acc[i][j][u][0] + bj.x);
          out.y = activate<kAct>(acc[i][j][u][1] + bj.y);
          out.z = activate<kAct>(acc[i][j][u][2] + bj.z);
          out.w = activate<kAct>(acc[i][j][u][3] + bj.w);
        }
        *reinterpret_cast<float4*>(c + at) = out;
      }
    }
  }
}

// product_tile over a grid of ceil(N / BN) tile columns, ceil(M / BM) tile
// rows and the contraction's slices; TB = int8_t: an int8 B and its column
// scales.
template <int BM, int BN, bool kAKMajor, bool kBKMajor, int kAct,
          typename TB = float>
__global__ void __launch_bounds__(kThreads, 2)
sgemm_kernel(const float* __restrict__ a, const TB* __restrict__ b,
             const float* __restrict__ scale, const float* __restrict__ bias,
             float* __restrict__ c, float* __restrict__ colsum, int M, int N,
             int K, int rows, size_t stride) {
  product_tile<BM, BN, kAKMajor, kBKMajor, kAct, false, false, kStages,
               false, TB>(a, b, bias, c, colsum, M, N, K, rows, stride,
                          blockIdx.x * BN, nullptr, nullptr, kActNone,
                          nullptr, scale);
}

// Outputs of one A side by side (the encoder's two heads, mu = h · W21 and
// logvar = h · W22): output o's B (K, N) N-major, its bias (N,) or null,
// and its C (M, N); for an int8 B (TB = int8_t, one output: a layer of the
// int8 decoder) its column scales (N,), unused for fp32.
template <typename TB>
struct OutsOf {
  const TB* b[kMaxOuts];
  const float* scale[kMaxOuts];
  const float* bias[kMaxOuts];
  float* c[kMaxOuts];
};
using Outs = OutsOf<float>;

// Both heads in one grid: 2 · ceil(N / BN) tile columns, column tn of
// output tn / ceil(N / BN), whose B, bias and C the block takes by selects
// (pick: a parameter array indexed at run time would go to local memory).
// At the training microbatch one head is 128 tiles of 128 x 128, under half
// a wave of two blocks an SM; both are one wave.
template <int BM, int BN, int kAct>
__global__ void __launch_bounds__(kThreads, 2)
sgemm_heads_kernel(const float* __restrict__ a, Outs outs, int M, int N,
                   int K, int rows, size_t stride) {
  const int cols = (N + BN - 1) / BN;
  const int o = blockIdx.x / cols;
  product_tile<BM, BN, true, false, kAct>(
      a, pick(outs.b, o), pick(outs.bias, o), pick(outs.c, o), nullptr, M,
      N, K, rows, stride, (blockIdx.x - o * cols) * BN);
}

// Opt `kernel` in to `smem` bytes of dynamic shared memory (above the 48 KB
// a block gets without asking), once a device: `opted_in` is the caller's
// bit set of the devices done, one for each kernel.
template <typename Kernel>
cudaError_t opt_in(Kernel kernel, int smem, uint64_t& opted_in) {
  int device = 0;
  cudaGetDevice(&device);
  if (device < 64 && (opted_in >> device & 1)) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && device < 64) opted_in |= uint64_t{1} << device;
  return err;
}

// the dynamic shared memory of a tile's rings (and compute buffers)
template <int BM, int BN, bool kAKMajor, bool kBKMajor, bool kFormA = false,
          bool kFormB = false, int kS = kStages, typename TB = float>
constexpr int kSmemBytes =
    (Operand<BM, kAKMajor, kSlabDepth<BM, BN>, kS, kFormA>::kFloats +
     Operand<BN, kBKMajor, kSlabDepth<BM, BN>, kS, kFormB, false,
             TB>::kFloats) * 4;

// sgemm_kernel on tile BM x BN over `slices` slices of `rows` rows of the
// contraction each (one slice of K rows: the plain product); TB = int8_t:
// an int8 B with its column scales `scale`.
template <int BM, int BN, bool kAKMajor, bool kBKMajor, int kAct,
          typename TB = float>
cudaError_t launch_tile(const float* a, const TB* b, const float* bias,
                        float* c, float* colsum, int M, int N, int K,
                        int rows, int slices, size_t stride,
                        cudaStream_t stream, const float* scale = nullptr) {
  auto kernel = sgemm_kernel<BM, BN, kAKMajor, kBKMajor, kAct, TB>;
  constexpr int smem =
      kSmemBytes<BM, BN, kAKMajor, kBKMajor, false, false, kStages, TB>;
  static uint64_t opted_in = 0;
  const cudaError_t err = opt_in(kernel, smem, opted_in);
  if (err != cudaSuccess) return err;
  const dim3 grid(cdiv(N, BN), cdiv(M, BM), slices);
  kernel<<<grid, kThreads, smem, stream>>>(a, b, scale, bias, c, colsum, M,
                                           N, K, rows, stride);
  return cudaGetLastError();
}

// f(std::integral_constant<int, tile>) for a tile index of kTiles; anything
// else is refused.
template <typename F>
cudaError_t with_tile(int tile, F&& f) {
  switch (tile) {
    case 0:
      return f(std::integral_constant<int, 0>{});
    case 1:
      return f(std::integral_constant<int, 1>{});
    case 2:
      return f(std::integral_constant<int, 2>{});
    default:
      return cudaErrorInvalidValue;
  }
}

// Whether every base pointer is on a 16-byte boundary (null is).
inline bool aligned(std::initializer_list<const void*> ptrs) {
  uintptr_t bits = 0;
  for (const void* p : ptrs) bits |= reinterpret_cast<uintptr_t>(p);
  return bits % 16 == 0;
}

// Whether the kernel takes these operands: k and n multiples of 4, every
// base pointer on a 16-byte boundary (the callers check too).
inline bool takes(int K, int N, std::initializer_list<const void*> ptrs) {
  return K > 0 && K % 4 == 0 && N % 4 == 0 && aligned(ptrs);
}

// C (M, N) = act(A (M, K) · B + bias) on the tile kTiles[tile], kAct an
// rvk::Act (none, relu, tanh).  Nothing to compute launches nothing.
template <bool kBKMajor, int kAct>
cudaError_t launch(const float* a, const float* b, const float* bias,
                   float* c, int M, int N, int K, int tile,
                   cudaStream_t stream) {
  if (!takes(K, N, {a, b, bias, c})) return cudaErrorInvalidValue;
  if (M <= 0 || N <= 0) return cudaSuccess;
  return with_tile(tile, [&](auto index) {
    constexpr int i = decltype(index)::value;
    return launch_tile<kTiles[i][0], kTiles[i][1], true, kBKMajor, kAct>(
        a, b, bias, c, nullptr, M, N, K, K, 1, 0, stream);
  });
}

// dw (M, N) = aᵀ · b and db (N,) = colsum(b) in IEEE fp32 (the weight
// gradient of y = a @ w + bias, contracting the batch): a (K, M) and b (K,
// N) row-major fp32, M and N multiples of 4, every pointer 16-byte aligned,
// K > 0 (the batch, any length).  The batch is cut into `split` slices of
// ceil(ceil(K / 64) / split) · 64 rows, which must leave no slice empty
// (ops/tensor_cores.py sgemm_wgrad_plan holds that); with more than one,
// slice s writes its dw and db to `workspace` at s · (M·N + N) (split ·
// (M·N + N) floats, 16-byte aligned) and sum_slices adds them in order.
// Tile kTiles[tile].
inline cudaError_t launch_wgrad(const float* a, const float* b, float* dw,
                                float* db, float* workspace, int M, int N,
                                int K, int tile, int split,
                                cudaStream_t stream) {
  if (M <= 0 || N <= 0) return cudaSuccess;
  const int k_total = cdiv(K, kSliceRows);
  const int steps = split > 0 ? cdiv(k_total, split) : 0;
  if (K <= 0 || M % 4 != 0 || N % 4 != 0 || split < 1 ||
      cdiv(k_total, steps) != split || !aligned({a, b, dw, db, workspace}) ||
      (split > 1 && workspace == nullptr)) {
    return cudaErrorInvalidValue;
  }
  const size_t mn = size_t(M) * N;
  float* c = split == 1 ? dw : workspace;
  float* colsum = split == 1 ? db : workspace + mn;
  const size_t stride = split == 1 ? 0 : mn + N;
  const cudaError_t err = with_tile(tile, [&](auto index) {
    constexpr int i = decltype(index)::value;
    return launch_tile<kTiles[i][0], kTiles[i][1], false, false, kActNone>(
        a, b, nullptr, c, colsum, M, N, K, steps * kSliceRows, split,
        stride, stream);
  });
  if (err != cudaSuccess || split == 1) return err;
  SliceOut out{};
  out.dw[0] = dw;
  out.db[0] = db;
  return add_slices(workspace, out, mn, N, split, 1, stream);
}

// sgemm_heads_kernel on tile BM x BN over `slices` slices of `rows` rows
// of the contraction each.
template <int BM, int BN, int kAct>
cudaError_t launch_heads_tile(const float* a, const Outs& outs, int M, int N,
                              int K, int rows, int slices, size_t stride,
                              cudaStream_t stream) {
  auto kernel = sgemm_heads_kernel<BM, BN, kAct>;
  constexpr int smem = kSmemBytes<BM, BN, true, false>;
  static uint64_t opted_in = 0;
  const cudaError_t err = opt_in(kernel, smem, opted_in);
  if (err != cudaSuccess) return err;
  const dim3 grid(2 * cdiv(N, BN), cdiv(M, BM), slices);
  kernel<<<grid, kThreads, smem, stream>>>(a, outs, M, N, K, rows, stride);
  return cudaGetLastError();
}

// kOuts outputs of one A side by side (1; or 2, the encoder's heads in one
// grid), each C_o (M, N) = act(A (M, K) · B_o (K, N) + bias_o) in IEEE
// fp32: A K-major, B N-major (the linear layer's (in, out) weights), kAct an
// rvk::Act, on the tile kTiles[tile]; k and n multiples of 4, every
// pointer 16-byte aligned.  The contraction is cut into `split` slices of
// ceil(ceil(K / 64) / split) · 64 k, which must leave no slice empty
// (ops/tensor_cores.py sgemm_fwd_plan holds that).  One slice: the bias and
// the activation in the epilogue, straight into C_o (kOuts 1: launch's
// launch).  More (the server's batch of 256 rows is too few tiles to fill
// the card): slice s of output o writes its sums to workspace + (o · split
// + s) · M·N (kOuts · split · M·N floats), then slices_epilogue
// (slices.cuh) adds the slices in order, adds the bias and applies the
// activation.  No atomics: two launches give equal bits.  Nothing to
// compute launches nothing.  TB = int8_t (one output): B is the int8 q (K,
// N) with its column scales outs.scale[0] (N,), dequantized as its slabs
// are read back, the rest as for fp32: a layer of the int8 decoder.
template <int kOuts, int kAct, typename TB = float>
cudaError_t launch_fwd(const float* a, const OutsOf<TB>& outs,
                       float* workspace, int M, int N, int K, int tile,
                       int split, cudaStream_t stream) {
  static_assert(kOuts == 1 || kOuts == 2, "one output, or both heads");
  constexpr bool kQuant = std::is_same<TB, int8_t>::value;
  static_assert(!kQuant || kOuts == 1, "an int8 B has one output");
  if (!takes(K, N, {a, workspace})) return cudaErrorInvalidValue;
  for (int o = 0; o < kOuts; ++o) {
    if (!aligned({outs.b[o], outs.bias[o], outs.c[o]}) ||
        (kQuant && (outs.scale[o] == nullptr || !aligned({outs.scale[o]})))) {
      return cudaErrorInvalidValue;
    }
  }
  const int k_total = cdiv(K, kSliceRows);
  const int steps = split > 0 ? cdiv(k_total, split) : 0;
  if (split < 1 || cdiv(k_total, steps) != split ||
      (split > 1 && workspace == nullptr)) {
    return cudaErrorInvalidValue;
  }
  if (M <= 0 || N <= 0) return cudaSuccess;
  const size_t mn = size_t(M) * N;
  OutsOf<TB> into = outs;
  if (split > 1) {
    for (int o = 0; o < kOuts; ++o) {
      into.c[o] = workspace + o * split * mn;
      into.bias[o] = nullptr;
    }
  }
  const auto product = [&](auto act) {
    constexpr int kA = decltype(act)::value;
    return with_tile(tile, [&](auto index) {
      constexpr int i = decltype(index)::value;
      constexpr int BM = kTiles[i][0], BN = kTiles[i][1];
      const int rows = steps * kSliceRows;
      const size_t stride = split == 1 ? 0 : mn;
      if constexpr (kOuts == 1) {
        return launch_tile<BM, BN, true, false, kA, TB>(
            a, into.b[0], into.bias[0], into.c[0], nullptr, M, N, K, rows,
            split, stride, stream, into.scale[0]);
      } else {
        return launch_heads_tile<BM, BN, kA>(a, into, M, N, K, rows, split,
                                             stride, stream);
      }
    });
  };
  if (split == 1) return product(std::integral_constant<int, kAct>{});
  const cudaError_t err =
      product(std::integral_constant<int, kActNone>{});
  if (err != cudaSuccess) return err;
  SliceAct out{};
  for (int o = 0; o < kOuts; ++o) {
    out.c[o] = outs.c[o];
    out.bias[o] = outs.bias[o];
  }
  return add_slices_act<kAct>(workspace, out, mn, N, split, kOuts, stream);
}

// The fused linear backward's two products (linear_bwd.cu), with the
// cotangent da = act'(y) · dy formed as its slabs are read back (Operand,
// kForm) and never written to device memory.  kDx: dx (M, N) = da · wᵀ, da
// (M, K) the K-major A (formed as it is transposed), w (N, K) the K-major
// B.  Otherwise dW (M, N) = xᵀ · da, x (K, M) the M-major A, da (K, N) the
// N-major B (formed in place in y's ring), and db = colsum(da) summed from
// the formed slabs by the blocks of the first tile row.  The rings: three
// slabs for dx (its A and B are both K-major, and two blocks an SM fit
// only so: 104 KB at 128 x 128), four for dW (96 KB).
template <int BM, int BN, bool kDx>
__global__ void __launch_bounds__(kThreads, 2)
sgemm_fused_kernel(const float* __restrict__ a, const float* __restrict__ a2,
                   const float* __restrict__ b, const float* __restrict__ b2,
                   float* __restrict__ c, float* __restrict__ colsum, int M,
                   int N, int K, int rows, size_t stride, int act) {
  product_tile<BM, BN, kDx, kDx, kActNone, kDx, !kDx, kDx ? 3 : kStages>(
      a, b, nullptr, c, colsum, M, N, K, rows, stride, blockIdx.x * BN, a2,
      b2, act);
}

template <int BM, int BN, bool kDx>
cudaError_t launch_fused_tile(const float* a, const float* a2, const float* b,
                              const float* b2, float* c, float* colsum, int M,
                              int N, int K, int rows, int slices,
                              size_t stride, int act, cudaStream_t stream) {
  auto kernel = sgemm_fused_kernel<BM, BN, kDx>;
  constexpr int smem =
      kSmemBytes<BM, BN, kDx, kDx, kDx, !kDx, kDx ? 3 : kStages>;
  static uint64_t opted_in = 0;
  const cudaError_t err = opt_in(kernel, smem, opted_in);
  if (err != cudaSuccess) return err;
  const dim3 grid(cdiv(N, BN), cdiv(M, BM), slices);
  kernel<<<grid, kThreads, smem, stream>>>(a, a2, b, b2, c, colsum, M, N, K,
                                           rows, stride, act);
  return cudaGetLastError();
}

// The gated input gradients of the primitive backward (bwd.cu
// rvk_matmul_nt_mask, rvk_matmul_nt2_mask): C (M, N) = where(gate > 0, A ·
// Bᵀ, 0), A (M, K) and B (N, K) both K-major, gate (M, N) as C.  kJoin: the
// two heads' dh, A = [a a2] and B = [b b2] joined along k, K = 2 · each
// pair's k: the first pair's k, then the second's, into one accumulator,
// the order of the first version's k-joined View (gemm.cuh).
template <int BM, int BN, bool kJoin>
__global__ void __launch_bounds__(kThreads, 2)
sgemm_gated_kernel(const float* __restrict__ a, const float* __restrict__ b,
                   const float* __restrict__ a2,
                   const float* __restrict__ b2,
                   const float* __restrict__ gate, float* __restrict__ c,
                   int M, int N, int K) {
  product_tile<BM, BN, true, true, kActGate, false, false, kStages, kJoin>(
      a, b, nullptr, c, nullptr, M, N, K, K, 0, blockIdx.x * BN, a2, b2,
      kActNone, gate);
}

// C (M, N) = where(gate > 0, a · bᵀ [+ a2 · b2ᵀ], 0) in IEEE fp32, the gate
// compared in fp32: a and a2 (M, K), b and b2 (N, K), gate and c (M, N),
// all row-major, K and N multiples of 4, every pointer 16-byte aligned; a2
// and b2 null (matmul_nt_mask) or, with kJoin, both set (matmul_nt2_mask:
// one product over 2K joined along k).  Tile kTiles[tile], the whole
// contraction in one slice: two launches give equal bits.  Nothing to
// compute launches nothing.
template <bool kJoin>
cudaError_t launch_gated(const float* a, const float* b, const float* a2,
                         const float* b2, const float* gate, float* c, int M,
                         int N, int K, int tile, cudaStream_t stream) {
  if (!takes(K, N, {a, b, a2, b2, gate, c}) || gate == nullptr ||
      kJoin != (a2 != nullptr) || kJoin != (b2 != nullptr)) {
    return cudaErrorInvalidValue;
  }
  if (M <= 0 || N <= 0) return cudaSuccess;
  return with_tile(tile, [&](auto index) {
    constexpr int i = decltype(index)::value;
    constexpr int BM = kTiles[i][0], BN = kTiles[i][1];
    auto kernel = sgemm_gated_kernel<BM, BN, kJoin>;
    constexpr int smem = kSmemBytes<BM, BN, true, true>;
    static uint64_t opted_in = 0;
    const cudaError_t err = opt_in(kernel, smem, opted_in);
    if (err != cudaSuccess) return err;
    const dim3 grid(cdiv(N, BN), cdiv(M, BM), 1);
    kernel<<<grid, kThreads, smem, stream>>>(a, b, a2, b2, gate, c, M, N,
                                             kJoin ? 2 * K : K);
    return cudaGetLastError();
  });
}

// The same with the activation chosen at run time (an rvk::Act code).
template <bool kBKMajor>
cudaError_t launch_act(const float* a, const float* b, const float* bias,
                       float* c, int M, int N, int K, int act, int tile,
                       cudaStream_t stream) {
  switch (act) {
    case kActNone:
      return launch<kBKMajor, kActNone>(a, b, bias, c, M, N, K, tile, stream);
    case kActRelu:
      return launch<kBKMajor, kActRelu>(a, b, bias, c, M, N, K, tile, stream);
    case kActTanh:
      return launch<kBKMajor, kActTanh>(a, b, bias, c, M, N, K, tile, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace sgemm
}  // namespace rvk
