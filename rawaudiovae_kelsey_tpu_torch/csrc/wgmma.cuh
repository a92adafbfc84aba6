// bf16 tensor-core mainloop for Hopper (sm_90a): the device routine of the
// bf16 forms of rvk_linear_fwd, rvk_linear_ksplit_fwd (linear.cu),
// rvk_matmul_nt, rvk_grad_accum, rvk_grad_accum2, rvk_enc_bwd_dw1 and
// rvk_dec_bwd_fused (bwd.cu), rvk_toeplitz_fwd (toeplitz.cu),
// rvk_encoder_fwd and rvk_decoder_fwd (mlp.cu), rvk_dx_fused and
// rvk_dw_fused (linear_bwd.cu), of both forms of rvk_enc_bwd_full and
// rvk_dec_bwd_full (bf16: bwd.cu; fp32 in three bf16 passes: full.cu), and
// of the `high` tier's 3-pass forms of rvk_encoder_fwd3, rvk_decoder_fwd3
// (mlp.cu), rvk_matmul_nt2_mask3 and rvk_matmul_nt3 (bwd.cu), whose chains
// are in full.cu.
//
//   C[m, n] = epi( sum_k A[m, k] * B[k, n] )
//
// A is (M, K) row-major bf16, the implicit A of the block-Toeplitz product
// (below), or M-major: the transpose of a (K, M) row-major matrix, which
// wgmma transposes as it reads (tnspA = 1; the weight gradients, below).  B
// is bf16 in one of two layouts, a compile-time choice: K-major,
// a (N, K) row-major matrix read by its rows (a @ wᵀ: matmul_nt), or
// N-major, a (K, N) row-major matrix (x @ w: the linear layer, the Toeplitz
// taps), which wgmma transposes as it reads (tnspB = 1): no copy is made of
// either.  The sum is kept in fp32 registers and handed to the epilogue
// functor two adjacent columns at a time: epi.column(n) reads what the
// functor needs for columns n and n + 1 (the bias pair; an Epi::Column of 4
// bytes, fetched for the whole tile while the last products are still in
// flight), and epi.pair<kMode>(column, m, n, v0, v1) does the rest in fp32
// (bias, activation) and returns the pair rounded once to bf16, which the
// mainloop stores to C; a gated functor gets the gate's pair instead of a
// column (below).  An fp32 weight gradient has an epilogue of its own.  kMode is epi.mode() in [0,
// Epi::kModes), turned into a template argument outside the epilogue's
// unrolled loop: a functor that chooses its activation at run time would
// otherwise put every activation's code into each of the 64 unrolled steps.
//
// Which TPU kernels run on it: linear_fwd (_linear_kernel) and
// linear_ksplit_fwd (_linear_ksplit_kernel) of
// rawaudiovae_kelsey_tpu/ops/pallas_linear.py, matmul_nt, encoder_fwd
// (_enc_fwd_kernel), decoder_fwd (_dec_fwd_kernel), grad_accum
// (_grad_accum_kernel), grad_accum2 (_grad_accum2_kernel), enc_bwd_dw1
// (_enc_bwd_dw1_kernel), dec_bwd_fused (_dec_bwd_fused_kernel),
// enc_bwd_full (_enc_bwd_full_kernel) and dec_bwd_full
// (_dec_bwd_full_kernel) of rawaudiovae_kelsey_tpu/ops/pallas_mlp.py and
// toeplitz_fwd (_toeplitz_kernel) of
// rawaudiovae_kelsey_tpu/ops/pallas_toeplitz.py.  The TPU kernels carry
// one fp32 accumulator across the k slices, which their grid visits in
// order; here a block owns an output tile and walks the whole of K itself,
// in order, in one fp32 accumulator: no split over blocks, no workspace, no
// atomics, so two launches give equal bits.
//
// What bounds it.  The deep model's large layers at batch 4096 do
// 2·4096·k·n operations on (4096·k + k·n + 4096·n)·2 bytes: 1365 operations
// a byte at 4096 x 4096 -> 4096, far above the card's 295, so the tensor
// cores are the limit and the design is about keeping them fed.  The
// whole-k layers (512 -> 256 and the like), matmul_nt at its dz shape and
// the Toeplitz layers of the conv1d model are below the ridge: there the
// point is to read the operands once, from as many SMs as there are tiles.
//
// Design.
// * Operands stay bf16.  TMA (cp.async.bulk.tensor) copies a 128 x 64 tile
//   of A and a BN x 64 tile of B into shared memory in the 128-byte swizzled
//   layout that wgmma reads; what lies outside the tensor arrives as zeros,
//   so ragged M, N and K need no masks in the loop, and the TMA store of the
//   epilogue clips what lies outside C.
// * A ring of kStages such stage buffers, each with a "full" mbarrier (the
//   TMA's bytes have landed) and an "empty" one (every consumer warp is
//   done reading).  Warp 8's first lane is the producer: it waits for a
//   stage to be empty, arms the full barrier with the byte count and starts
//   the loads.  Warps 0-7 are two consumer warpgroups of 64 rows each: they
//   wait for a stage to be full, run four wgmma.mma_async m64nBNk16 on it,
//   commit, and release the stage before that one once its group has
//   retired (one group stays in flight).  setmaxnreg moves the producer
//   warpgroup's registers to the consumers (BN = 256 is 128 accumulators a
//   thread).
// * Layouts.  A K-major tile is rows of 128 bytes (64 k), eight rows to a
//   1024-byte swizzle atom: descriptor stride (SBO) 1024, and the next k16
//   is 32 bytes further along the row.  The N-major tile of B is staged as
//   BN / 64 chunks of 64 k-rows x 64 n (the widest box a 128-byte swizzle
//   takes): within a chunk a k-row is 128 bytes, eight k-rows an atom (SBO
//   1024), chunks 8192 bytes apart (LBO), and the next k16 is sixteen
//   k-rows, 2048 bytes, further: k advances by rows of the staged tile, not
//   by columns.
// * The tile walk is a template argument (a "Tiles" type): which box of A a
//   k-step loads into each half of the tile, which k-row of B goes with it,
//   and where each consumer warpgroup's 64 rows of C are stored.
//   MatrixTiles is the plain (M, K) x (K or N, ...) product.  ToeplitzTiles
//   is the block-Toeplitz product y[b, t] = sum_j x[b, t + j - shift] @ w[j]
//   with x (B, nb, G), w (KB, G, N) read as a (KB·G, N) N-major B and y (B,
//   t_out, N): each warpgroup's 64 rows are one box of b_half batch rows x
//   t_half positions (t_half · b_half <= 64, a box never wraps from one
//   batch row into the next), loaded by one 3-D TMA box of x at (g0, t0 -
//   shift + j, b0) for k-step (tap j, channels g0 .. g0 + 63) and stored as
//   one 3-D box of y at (n0, t0, b0).  TMA's zero fill, negative
//   coordinates included, is the SAME padding and the batch edge; its
//   clipping drops rows past t_out or B.  The B k-row of that step is j·G +
//   g0: where G is no multiple of 64 the A box is zero for g >= G, so the
//   rows of the next tap it meets add nothing (finite weights).  Rows of a
//   half past t_half · b_half are computed from stale shared memory and
//   never stored.  The plan (t_half, b_half) comes from the caller
//   (ops/toeplitz.py tile_plan); the consumers never see where a stage came
//   from.
// * A launch may write kOuts outputs side by side (the Tiles type's kOuts):
//   one A map and kOuts (B, C) map pairs, each output N wide, read by the
//   walk as one joined output of kOuts · ceil(N / BN) tile columns.  Tile
//   column tn belongs to output tn / ceil(N / BN): its loads read that
//   output's B, its store writes that output's C, and the epilogue sees the
//   joined column out · N + n (for kOuts = 1, the column of C).  TMA clips
//   and zero-fills at each map's own N, so an N that is no multiple of BN
//   needs no mask.  HeadsTiles is the encoder's two heads, mu = h · W21 and
//   logvar = h · W22: one launch of 2 · ceil(latent / BN) tile columns,
//   where two launches would each leave half the SMs idle at the training
//   microbatch (64 tiles of 128 x 256 for 132 SMs).
// * Two products may be joined along k (JoinedKTiles): C = A1 · B1 + A2 ·
//   B2, the encoder's dh = dmu · W21ᵀ + dlv · W22ᵀ.  The walk's first
//   ceil(K / 64) k-steps read the first (A, B) pair, the next as many the
//   second (Maps<kOuts, true>: a second A map and a second B map), into one
//   fp32 accumulator; TMA zero-fills each pair's columns past K, so any K
//   that is a multiple of 8 adds nothing past it.  No copy joins the
//   operands in memory.
// * Epilogue.  Stores of 4 bytes a thread straight from the accumulator
//   layout, with the bias fetched and the activation chosen inside the
//   unrolled loop, made the first epilogue 8 % of the kernel at 4096 x 4096
//   -> 4096 on an H100 (0.2055 ms against 0.1886 ms with this one).  So
//   each consumer warpgroup rounds its 64 x BN half into a staging buffer in
//   shared memory, in the 128-byte swizzled layout (its threads then hit 32
//   distinct banks), and one thread hands it to TMA as 64 x 64 boxes (or
//   the Toeplitz box); the store drains while the warpgroup is already in
//   the next tile's products, and is waited for only before the staging
//   buffer is written again.
// * Tiles.  128 x BN with BN 256, 128 or 64, chosen by the caller
//   (ops/tensor_cores.py tile_n: the width with the fewest waves of tiles
//   times its width, the wider on a tie; a 3-pass product, below, 128 or
//   64 by the same rule).  One persistent block an SM walks
//   the tiles, eight tile rows to a group so that the blocks running
//   together share operands in L2, and the ring runs on across tiles: the
//   producer loads the next tile while the consumers store this one.
//   Stages: three of 48 KB at 128 x 256 (a fourth does not fit), five of 32
//   KB at 128 x 128 (fewer cost time there; a sixth gained only at 4096 x
//   4096 -> 4096, a shape the rule never gives 128 x 128 tiles), eight of 24
//   KB at 128 x 64 (its layers have few k-steps a tile: the ring reaches
//   into the next tile), beside 64 / 32 / 16 KB of staging, inside the 227
//   KB a block may take.
// * The gate (dh3 = where(h3 > 0, da · W4ᵀ, 0)): h3 is read where the
//   output goes.  The warpgroup's leader has TMA load the gate's 64 x 64
//   boxes of this half tile into the warpgroup's staging buffer, in the
//   swizzled layout the staged store uses, once the last tile's store has
//   read that buffer and right after the tile's first products are issued,
//   behind an mbarrier of its own; each thread then reads its gate pair at
//   the address it is about to overwrite with its result.  h3's 32 MB
//   arrive as whole 128-byte rows, under the products, where 4-byte loads
//   in the epilogue would read 16-byte runs after the products.
// * Weight gradients (dW = Aᵀ · B, the batch the contraction and the row
//   axis of both operands): A is M-major, staged as the N-major B is (64
//   k-rows x 64 m a chunk, a warpgroup's 64 rows one chunk), the
//   instruction's transpose-A bit set; the fp32 sums are stored from the
//   accumulators as float2 pairs, once a tile (the bf16 staging would take
//   128 KB in fp32 at BN = 256).  dW3 at the training microbatch is 256 x
//   2048: 16 to 64 tiles for 132 SMs, each a long walk over 8192 rows.  So
//   the batch is cut into slices (WgradTiles), each slice a whole dW of
//   tiles written to a workspace, and sum_slices (slices.cuh) adds the
//   slices in order: one wave of blocks instead of an eighth of one, and
//   the same bits on every launch (no atomics).  Tiles covering all 256
//   rows (four warpgroups) would read dh3 once, but 256 x 64 tiles give 32
//   blocks: the card stays idle without the split anyway.  The bias gradient,
//   colsum(B), is summed by the tiles of dW's first tile row from the B
//   stages they have in shared memory, in k order, while the products run
//   (add_columns): no second read of B, and TMA's zeros past the batch add
//   nothing.  Two weight gradients that share A (grad_accum2: dW21 = hᵀ dmu
//   and dW22 = hᵀ dlv) are one launch of kOuts = 2 outputs side by side
//   (WgradTiles<2>): tile column tn takes output tn / ceil(N / BN), its B
//   and its (dW, db) pair, and the tiles of each output's first tile row sum
//   that output's B; one read of h for both heads, one wave where two
//   launches would each fill half of one, one sum of the slices.
// * The fused linear backward (linear_bwd.cu: rvk_dx_fused, rvk_dw_fused):
//   A is the cotangent da = act'(y) · dy, formed, never loaded (a walk with
//   kFormed: CotangentRows, CotangentWgrad).  The producer stages y's and
//   dy's boxes where A's box would go, two A tiles a stage.  Each consumer
//   warpgroup reads its 64 rows of both, one k16 fragment at a time, with
//   ldmatrix (.trans for an M-major A: daᵀ, whose rows are da's columns),
//   forms da in fp32 (rvk::cotangent), rounds it to bf16 to nearest even and
//   hands it to wgmma as the register A (m64nBNk16 with A from registers).
//   The products of a k-step read those registers until a later wait
//   retires them, so the k-steps take two sets of fragment registers by
//   turns.  dx = da · wᵀ is the plain walk with w as the K-major B; dW = xᵀ ·
//   da is walked as its transpose, dWᵀ = daᵀ · x (x the N-major B), stored
//   transposed from the accumulators (store_f32_t), the batch cut into
//   slices as the weight gradients' are; db is the row sums of the same
//   rounded daᵀ fragments, summed by the tiles of the first tile column and
//   added across each quad of lanes (finish_rows).  A stage is 16 KB larger
//   than a plain one, so the ring is shallower (Ring): 3 stages at 128 x
//   256 (dx's epilogue then stages its half tile in two parts of 128
//   columns; dW has no staging), 4 at 128 x 128, 5 at 128 x 64.  da is
//   formed once a tile: for dx k / BN times a row block, for dW k / BN
//   times a column block of dW.
// * The 3-pass product (an epilogue with kSplit: SplitRows, SplitWgradOut;
//   the `high` tier's full chains, full.cu): fp32 operands split by the
//   split pass (split.cuh) into bf16 halves, A ≈ A_hi + A_lo and B ≈ B_hi
//   + B_lo, and A·B taken as (A_hi·B_hi + A_hi·B_lo) + A_lo·B_hi, the
//   product of the TPU kernels' _mm at passes = 3.  Each stage holds four
//   boxes (A_hi, A_lo, B_hi, B_lo; the maps of the lo halves in
//   SplitMaps::lo), its full barrier armed with all four; the consumers
//   issue the three products of a stage into three fp32 accumulators in one
//   wgmma group, and the epilogue adds them with IEEE adds in that order
//   before anything else.  One accumulator for all three would let the
//   tensor core's own accumulation, which does not round to nearest, add hl
//   and lh: on operands where every sum has one term (chip_smoke.py
//   exact_split_case) three accumulators each hold one exact product, and
//   the two adds are the plain version's.  The outputs are fp32, stored
//   from the accumulators as the weight gradients' are: dh, dh3, dz and dx
//   with an fp32 gate (h > 0, read at the output's place) or none
//   (SplitRows), the forward's h, mu | logvar, h3 and y with the bias added
//   after the three-pass sum and then the activation (SplitBiasRows, the
//   order of _enc_fwd_kernel and _dec_fwd_kernel; B N-major, x @ w; the
//   encoder's heads as one walk of two outputs, HeadsTiles), and the
//   weight gradients over slices of the batch without column sums (the
//   split pass takes them from the unsplit values).  A stage is twice a
//   plain one and three accumulators take 3 · BN / 2 registers a thread:
//   tiles 128 x 64 (four stages of 48 KB, 96 accumulators) or 128 x 128
//   (three of 64 KB, 192), no staging buffers.
// * The 4-pass Toeplitz product (FourPassRows on ToeplitzTiles; the fp32
//   conv1d layers under the `high` tier, toeplitz.cu): the 3-pass mode's
//   stage of four boxes, A_hi and A_lo the 3-D boxes of x's halves, and
//   FOUR products a stage, hh, ll, hl and lh, into four fp32 accumulators;
//   the epilogue adds them (hh + ll) + (hl + lh) with IEEE adds, then the
//   bias, then the activation, the order of the TPU kernel
//   (_toeplitz_kernel at passes = 4), and stores fp32 y from the
//   accumulators, each row of a half mapped to its (batch row, position)
//   and the rows past t_out or B masked (ToeplitzTiles::out_row).  Four
//   accumulators take 2 · BN registers a thread: tiles 128 x 64 only (128
//   accumulators), four stages of 48 KB.  One accumulator a pair would let
//   the tensor core's accumulation add two passes: the reason above for
//   three.
// * Partial sums (PartialRows; the row-parallel layers of tensor
//   parallelism, mlp.cu and linear.cu rvk_*_partial): a 1-pass product whose
//   sums are added across ranks before its bias and activation.  The fp32
//   sums are stored from the accumulators as the weight gradients' are
//   (store_f32), no staging buffer; the walks are the plain ones
//   (MatrixTiles, HeadsTiles).
// * A barrier that never completes traps after ~2 s instead of hanging the
//   card: the launch then fails with an error the wrapper raises.  The trap
//   ends the process's CUDA context, and a run slowed many times over (a
//   debugger, compute-sanitizer, a card shared with another process) can
//   reach the bound with no fault: build such a run with
//   -DRVK_NO_HANG_TRAP.
#pragma once

#include <cuda.h>

#include "gemm.cuh"
#include "slices.cuh"

namespace rvk {
namespace tc {
namespace {

// the `kernel` code of the C entry points (ops/tensor_cores.py KERNEL_CODES)
enum Kernel : int {
  kCudaCores = 0,    // the first-version kernels: not handled here
  kTensorCores = 1,  // this mainloop, the tile width chosen by shape
  kSgemm = 2,        // the fp32 mainloop of sgemm.cuh, its tile by shape
  kNarrow = 3,       // the narrow-channel Toeplitz form (narrow.cuh)
};

constexpr int kTileM = 128;  // two consumer warpgroups of 64 rows
constexpr int kTileK = 64;   // 128 bytes of bf16: one swizzle row
// the ring's depth by tile width (the header's "Tiles")
constexpr int stages_for(int BN) { return BN == 256 ? 3 : BN == 128 ? 5 : 8; }
constexpr int kConsumerWarps = 8;
constexpr int kBlock = 384;  // 8 consumer warps + the producer's warpgroup
constexpr uint32_t kATileBytes = kTileM * kTileK * 2;
constexpr uint32_t kChunkBytes = 64 * kTileK * 2;  // 64 rows of 128 bytes
// mbar_wait's bound, in clock64 cycles (~2 s); see RVK_NO_HANG_TRAP above
constexpr long long kHangCycles = 4000000000LL;

// ------------------------------------------------------------------- PTX

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Wait until the barrier's phase of this parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
#ifndef RVK_NO_HANG_TRAP
  long long t0 = 0;
#endif
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
#ifndef RVK_NO_HANG_TRAP
    if (t0 == 0) {
      t0 = clock64();
    } else if (clock64() - t0 > kHangCycles) {
      __trap();
    }
#endif
  }
}

// One box of the tensor behind `map`, at (c0 innermost, c1), to shared
// memory; its bytes count on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// The same from a 3-D tensor, at (c0 innermost, c1, c2).
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// One box from shared memory to the tensor behind `map`, at (c0 innermost,
// c1); what lies outside the tensor is not written.  Joins the thread's
// current bulk group.
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src,
                                          int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], "
      "[%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1)
      : "memory");
}
// The same into a 3-D tensor, at (c0 innermost, c1, c2).
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src,
                                          int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group "
      "[%0, {%2, %3, %4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void tma_store_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// Wait until this thread's bulk stores have read their shared memory.
__device__ __forceinline__ void tma_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Barrier `id` (1..15; 0 is __syncthreads) over `threads` threads.
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending)
               : "memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets, all in 16-byte units.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

#define RVK_D8(d, o)                                                      \
  "+f"(d[o]), "+f"(d[o + 1]), "+f"(d[o + 2]), "+f"(d[o + 3]),             \
      "+f"(d[o + 4]), "+f"(d[o + 5]), "+f"(d[o + 6]), "+f"(d[o + 7])
#define RVK_D64(d, o)                                                     \
  RVK_D8(d, o), RVK_D8(d, o + 8), RVK_D8(d, o + 16), RVK_D8(d, o + 24),   \
      RVK_D8(d, o + 32), RVK_D8(d, o + 40), RVK_D8(d, o + 48),            \
      RVK_D8(d, o + 56)

// d (64 x BN, fp32, this warpgroup's) += A (64 x 16) · B (16 x BN); kAT:
// A is M-major in shared memory (aᵀ: the weight gradients' contraction over
// the batch), kBT: B is N-major.  The two transpose bits are the
// instruction's immediates.
#define RVK_REGS_32                                                       \
  "%0, %1, %2, %3, %4, %5, %6, %7, "                                      \
  "%8, %9, %10, %11, %12, %13, %14, %15, "                                \
  "%16, %17, %18, %19, %20, %21, %22, %23, "                              \
  "%24, %25, %26, %27, %28, %29, %30, %31"
#define RVK_REGS_128                                                      \
  "%0, %1, %2, %3, %4, %5, %6, %7, "                                      \
  "%8, %9, %10, %11, %12, %13, %14, %15, "                                \
  "%16, %17, %18, %19, %20, %21, %22, %23, "                              \
  "%24, %25, %26, %27, %28, %29, %30, %31, "                              \
  "%32, %33, %34, %35, %36, %37, %38, %39, "                              \
  "%40, %41, %42, %43, %44, %45, %46, %47, "                              \
  "%48, %49, %50, %51, %52, %53, %54, %55, "                              \
  "%56, %57, %58, %59, %60, %61, %62, %63, "                              \
  "%64, %65, %66, %67, %68, %69, %70, %71, "                              \
  "%72, %73, %74, %75, %76, %77, %78, %79, "                              \
  "%80, %81, %82, %83, %84, %85, %86, %87, "                              \
  "%88, %89, %90, %91, %92, %93, %94, %95, "                              \
  "%96, %97, %98, %99, %100, %101, %102, %103, "                          \
  "%104, %105, %106, %107, %108, %109, %110, %111, "                      \
  "%112, %113, %114, %115, %116, %117, %118, %119, "                      \
  "%120, %121, %122, %123, %124, %125, %126, %127"

template <int BN, bool kAT, bool kBT>
__device__ __forceinline__ void wgmma_k16(float* d, uint64_t da,
                                          uint64_t db) {
  static_assert(BN == 64 || BN == 128 || BN == 256, "m64nBNk16");
  if constexpr (BN == 64) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{" RVK_REGS_32 "}, %32, %33, p, 1, 1, %35, %36;\n"
        "}\n"
        : RVK_D8(d, 0), RVK_D8(d, 8), RVK_D8(d, 16), RVK_D8(d, 24)
        : "l"(da), "l"(db), "r"(1), "n"(int(kAT)), "n"(int(kBT)));
  } else if constexpr (BN == 128) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, %67, %68;\n"
        "}\n"
        : RVK_D64(d, 0)
        : "l"(da), "l"(db), "r"(1), "n"(int(kAT)), "n"(int(kBT)));
  } else {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
        "{" RVK_REGS_128 "}, %128, %129, p, 1, 1, %131, %132;\n"
        "}\n"
        : RVK_D64(d, 0), RVK_D64(d, 64)
        : "l"(da), "l"(db), "r"(1), "n"(int(kAT)), "n"(int(kBT)));
  }
}

// The same with A (64 x 16) from registers: a[0..3] are this thread's
// fragment, each two bf16 of one row (the PTX ISA's register layout of A
// for m64nNk16: a[0] row g, columns 2q and 2q + 1; a[1] row g + 8; a[2] and
// a[3] the same rows, columns 8 further; g = lane / 4 + 16 · warp, q = lane
// % 4).  The registers must hold until the product retires.
template <int BN, bool kBT>
__device__ __forceinline__ void wgmma_k16_ra(float* d, const uint32_t* a,
                                             uint64_t db) {
  static_assert(BN == 64 || BN == 128 || BN == 256, "m64nBNk16");
  if constexpr (BN == 64) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{" RVK_REGS_32 "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n"
        "}\n"
        : RVK_D8(d, 0), RVK_D8(d, 8), RVK_D8(d, 16), RVK_D8(d, 24)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1),
          "n"(int(kBT)));
  } else if constexpr (BN == 128) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n"
        "}\n"
        : RVK_D64(d, 0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1),
          "n"(int(kBT)));
  } else {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
        "{" RVK_REGS_128 "}, {%128, %129, %130, %131}, %132, p, 1, 1, "
        "%134;\n"
        "}\n"
        : RVK_D64(d, 0), RVK_D64(d, 64)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1),
          "n"(int(kBT)));
  }
}

#undef RVK_REGS_128
#undef RVK_REGS_32
#undef RVK_D64
#undef RVK_D8

// The four k16 products of one 64-deep stage, for the warpgroup whose 64
// rows of A start at `a_tile`; `b_tile` is the stage's B.  An M-major A
// (kAT) is staged as the N-major B is, 64 k-rows x 64 m with a k-row of 128
// bytes and eight k-rows to an atom (SBO 1024); a warpgroup's 64 rows are
// one such chunk, so the chunk stride (LBO) is never stepped over.
template <int BN, bool kAT, bool kBT>
__device__ __forceinline__ void stage_product(float* acc, uint32_t a_tile,
                                              uint32_t b_tile) {
  const uint64_t da = kAT ? make_desc(a_tile, kChunkBytes, 1024)
                          : make_desc(a_tile, 16, 1024);
  const uint64_t db = kBT ? make_desc(b_tile, kChunkBytes, 1024)
                          : make_desc(b_tile, 16, 1024);
#pragma unroll
  for (int kk = 0; kk < kTileK / 16; ++kk) {
    // the start address moves (in 16-byte units): 32 bytes along a K-major
    // row, sixteen 128-byte k-rows down an M- or N-major chunk
    wgmma_k16<BN, kAT, kBT>(acc, da + (kAT ? 128 : 2) * kk,
                            db + (kBT ? 128 : 2) * kk);
  }
}

// Four 8 x 8 bf16 matrices from shared memory, each lane giving the
// address of one 16-byte row (lanes 8q .. 8q + 7 matrix q); .trans: each
// matrix transposed.  Lane l receives, of matrix q, row l / 4 (of the
// transpose), columns 2 (l % 4) and the next, in register q.
template <bool kTrans>
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t at) {
  if constexpr (kTrans) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
        "[%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(at));
  } else {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(at));
  }
}

// The cotangent of a bf16 pair: y and dy (two bf16 each, the low half
// first) to fp32, da = act'(y) · dy in fp32 (rvk::cotangent), rounded to
// bf16 to nearest even: the bits of linear_bwd.cu's first version.
template <int kAct>
__device__ __forceinline__ uint32_t cotangent_pair(uint32_t y, uint32_t dy) {
  const __nv_bfloat162 da = __floats2bfloat162_rn(
      cotangent(kAct, __uint_as_float(y << 16), __uint_as_float(dy << 16)),
      cotangent(kAct, __uint_as_float(y & 0xFFFF0000u),
                __uint_as_float(dy & 0xFFFF0000u)));
  return *reinterpret_cast<const uint32_t*>(&da);
}

// The four k16 products of one 64-deep stage with A formed in registers
// (header, "the fused linear backward"): the warpgroup's 64 rows of y and
// dy are staged at y_tile and dy_tile as A would be; each k16 fragment is
// read by one ldmatrix of each (transposed for an M-major A), formed into
// da = act'(y) · dy and rounded to bf16, then multiplied from registers by
// the stage's B.  An M-major A is daᵀ, whose rows are da's columns: with
// `sums`, each thread also adds the rounded values of its two rows (g and g
// + 8 of its warp's 16) into rs0 and rs1, in k order, for the bias
// gradient (finish_rows).  The products read `a` after they are issued: the
// caller hands successive stages different arrays and defines one again only
// once the group that read it has retired (the mainloop's "fragments").
template <int BN, bool kAT, bool kBT, int kAct>
__device__ __forceinline__ void formed_product(
    float* acc, uint32_t (&a)[kTileK / 16][4], uint32_t y_tile,
    uint32_t dy_tile, uint32_t b_tile, bool sums, float& rs0, float& rs1) {
  const int lane = threadIdx.x % 32;
  const int w = (threadIdx.x / 32) % 4;  // the warp's 16 rows of the 64
  const int q = lane / 8, i = lane % 8;  // the matrix and row of its address
#pragma unroll
  for (int kk = 0; kk < kTileK / 16; ++kk) {
    // K-major: matrix q is rows 8 (q % 2) .., k 8 (q / 2) .. of the warp's
    // 16 x 16, row i of it a 16-byte unit of a 128-byte row.  M-major: the
    // same block of daᵀ is k-rows 8 (q / 2) + i of the chunk, m-units 2w +
    // q % 2, read transposed.  Either way the row's index is i modulo 8, the
    // swizzle's XOR.
    uint32_t at;
    if constexpr (kAT) {
      at = (16 * kk + 8 * (q / 2) + i) * 128 + (((2 * w + q % 2) ^ i) << 4);
    } else {
      at = (16 * w + 8 * (q % 2) + i) * 128 + (((2 * kk + q / 2) ^ i) << 4);
    }
    uint32_t y[4], dy[4];
    ldmatrix_x4<kAT>(y, y_tile + at);
    ldmatrix_x4<kAT>(dy, dy_tile + at);
#pragma unroll
    for (int r = 0; r < 4; ++r) a[kk][r] = cotangent_pair<kAct>(y[r], dy[r]);
    if (kAT && sums) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const __nv_bfloat162 v =
            *reinterpret_cast<const __nv_bfloat162*>(&a[kk][r]);
        float& rs = r % 2 == 0 ? rs0 : rs1;
        rs += __low2float(v);
        rs += __high2float(v);
      }
    }
  }
  // every fragment defined before the fence: an instruction that defines
  // one between the fence and the products would make the compiler
  // serialize the products (ptxas: "wgmma.mma_async instructions are
  // serialized due to non wgmma instructions defining input registers")
#pragma unroll
  for (int kk = 0; kk < kTileK / 16; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) asm volatile("" : "+r"(a[kk][r])::"memory");
  }
  wgmma_fence();
  const uint64_t db = kBT ? make_desc(b_tile, kChunkBytes, 1024)
                          : make_desc(b_tile, 16, 1024);
#pragma unroll
  for (int kk = 0; kk < kTileK / 16; ++kk) {
    wgmma_k16_ra<BN, kBT>(acc, a[kk], db + (kBT ? 128 : 2) * kk);
  }
}

// Keep the compiler from moving reads of the accumulators above the wait
// that retires the asynchronous products writing them.
template <int BN>
__device__ __forceinline__ void fence_accumulators(float* acc) {
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) {
    asm volatile("" : "+f"(acc[i])::"memory");
  }
}

// The accumulator layout: thread t of the warpgroup holds, for every eight
// columns j, rows 16·(t / 32) + (t % 32) / 4 and that + 8, columns 8·j +
// 2·(t % 4) and the next, as acc[4·j .. 4·j + 3].

// What a functor or a tile walk declares beyond the basics; left out, it is
// false.  A gated functor (Epi::kGate) finishes a pair from the gate's bf16
// pair at the same place of a gate tensor shaped as C: the mainloop has TMA
// load the gate's boxes into the staging buffer, and each thread reads its
// pair where it is about to stage its result.  A weight-gradient functor
// (Epi::kWgrad) takes the fp32 sums as they are (no staging, no TMA store)
// and the column sums of B (below).  A walk with an M-major A (Tiles::kAT)
// loads A as (m, k) boxes of a (K, M) matrix.
template <typename E, typename = void>
constexpr bool kGated = false;
template <typename E>
constexpr bool kGated<E, std::void_t<decltype(E::kGate)>> = E::kGate;
template <typename E, typename = void>
constexpr bool kWgradOut = false;
template <typename E>
constexpr bool kWgradOut<E, std::void_t<decltype(E::kWgrad)>> = E::kWgrad;
template <typename T, typename = void>
constexpr bool kMMajorA = false;
template <typename T>
constexpr bool kMMajorA<T, std::void_t<decltype(T::kAT)>> = T::kAT;
template <typename T, typename = void>
constexpr bool kJoinedK = false;
template <typename T>
constexpr bool kJoinedK<T, std::void_t<decltype(T::kJoined)>> = T::kJoined;
// A walk whose A is formed (Tiles::kFormed, with Tiles::kAct): the
// cotangent of the fused linear backward, staged as y and dy (header, "the
// fused linear backward").
template <typename T, typename = void>
constexpr bool kFormedA = false;
template <typename T>
constexpr bool kFormedA<T, std::void_t<decltype(T::kFormed)>> = T::kFormed;
// a walk that reads a second A map: the k-joined one, or a formed one (dy)
template <typename T>
constexpr bool kTwoA = kJoinedK<T> || kFormedA<T>;
// A 3-pass functor (Epi::kSplit, header "the 3-pass product"): every
// operand comes as two bf16 halves, multiplied into three accumulators.
template <typename E, typename = void>
constexpr bool kSplitPass = false;
template <typename E>
constexpr bool kSplitPass<E, std::void_t<decltype(E::kSplit)>> = E::kSplit;
// A 4-pass functor (Epi::kPasses == 4, header "the 4-pass Toeplitz
// product"): a 3-pass stage multiplied four ways, into four accumulators.
template <typename E, typename = void>
constexpr bool kFourPass = false;
template <typename E>
constexpr bool kFourPass<E, std::void_t<decltype(E::kPasses)>> =
    E::kPasses == 4;

// A warpgroup's accumulators → its staging buffer (64 rows x BN columns as
// BN / 64 chunks of 64 rows x 128 bytes, 128-byte swizzle: the layout a TMA
// store of 64 x 64 boxes reads).  Only the first `rows` rows of the half
// and the columns below N go through the functor (its bias or gate has
// nothing elsewhere), as rows m0 + r and columns joined + n; zeros are
// staged for the rest and the store clips or skips them.  A gated functor
// reads its gate pair from the same address first (the gate's boxes were
// loaded there in the same layout).
template <int BN, int kMode, typename Epi>
__device__ __forceinline__ void stage_tile(
    float* acc, const Epi& epi, const typename Epi::Column* columns,
    uint32_t staging, int m0, int rows, int n0, int N, int joined) {
  fence_accumulators<BN>(acc);
  const int t = threadIdx.x % 128;
  const int r = 16 * (t / 32) + (t % 32) / 4;  // and r + 8: the same r % 8
  const int col = 2 * (t % 4);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int n = n0 + col + 8 * j;
    const uint32_t at = staging + (j / 8) * kChunkBytes + r * 128 +
                        (((j % 8) ^ (r % 8)) << 4) + 2 * col;
    __nv_bfloat162 lo = __floats2bfloat162_rn(0.f, 0.f), hi = lo;
    if (n < N) {
      if constexpr (kGated<Epi>) {
        uint32_t g0, g1;
        asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(g0) : "r"(at));
        asm volatile("ld.shared.b32 %0, [%1];\n"
                     : "=r"(g1)
                     : "r"(at + 8 * 128));
        if (r < rows) {
          lo = epi.template gated<kMode>(g0, acc[4 * j], acc[4 * j + 1]);
        }
        if (r + 8 < rows) {
          hi = epi.template gated<kMode>(g1, acc[4 * j + 2], acc[4 * j + 3]);
        }
      } else {
        if (r < rows) {
          lo = epi.template pair<kMode>(columns[j], m0 + r, joined + n,
                                        acc[4 * j], acc[4 * j + 1]);
        }
        if (r + 8 < rows) {
          hi = epi.template pair<kMode>(columns[j], m0 + r + 8, joined + n,
                                        acc[4 * j + 2], acc[4 * j + 3]);
        }
      }
    }
    asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(at),
                 "r"(*reinterpret_cast<uint32_t*>(&lo))
                 : "memory");
    asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(at + 8 * 128),
                 "r"(*reinterpret_cast<uint32_t*>(&hi))
                 : "memory");
  }
}

// A warpgroup's fp32 sums straight to `out` (row-major, N wide), float2 a
// column pair: its rows m0 .. m0 + rows - 1, columns n0 .. below N.  A warp's
// store covers eight rows of 32 bytes each, whole sectors; a weight gradient
// is written once per tile after all of its k-steps, so the bf16 staging
// (and its 128 KB at BN = 256 in fp32) is not worth having.  With a `gate`
// (fp32, out's shape: a 3-pass dh or dh3), a value is kept where the gate's
// value at its place is > 0 and is 0 elsewhere, the pair read as one float2
// beside where it goes.  With a `bias` (fp32, (N,): a 3-pass forward), the
// pair's bias is added with IEEE adds; then the activation kAct (an
// rvk::Act: none, relu, tanh) is applied.
template <int BN, int kAct = kActNone>
__device__ __forceinline__ void store_f32(float* acc, float* out, int m0,
                                          int rows, int n0, int N,
                                          const float* gate = nullptr,
                                          const float* bias = nullptr) {
  fence_accumulators<BN>(acc);
  const int t = threadIdx.x % 128;
  const int r = 16 * (t / 32) + (t % 32) / 4;
  const int col = 2 * (t % 4);
  auto put = [&](int row, int n, float v0, float v1) {
    const size_t at = size_t(m0 + row) * N + n;
    if (gate != nullptr) {
      const float2 g = __ldg(reinterpret_cast<const float2*>(gate + at));
      v0 = g.x > 0.f ? v0 : 0.f;
      v1 = g.y > 0.f ? v1 : 0.f;
    }
    if (bias != nullptr) {
      const float2 b = __ldg(reinterpret_cast<const float2*>(bias + n));
      v0 = __fadd_rn(v0, b.x);
      v1 = __fadd_rn(v1, b.y);
    }
    v0 = activate<kAct>(v0);
    v1 = activate<kAct>(v1);
    *reinterpret_cast<float2*>(out + at) = make_float2(v0, v1);
  };
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int n = n0 + col + 8 * j;
    if (n < N) {
      if (r < rows) put(r, n, acc[4 * j], acc[4 * j + 1]);
      if (r + 8 < rows) put(r + 8, n, acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
}

// store_f32 with the bias and the activation for rows that are not
// consecutive: row r of the warpgroup's half goes to row row_of(r) of `out`
// (row-major, N wide), and nowhere where that is negative (the 4-pass
// Toeplitz product's half: ToeplitzTiles::out_row).  N a multiple of 8.
template <int BN, int kAct, typename RowOf>
__device__ __forceinline__ void store_f32_rows(float* acc, float* out,
                                               const RowOf& row_of, int n0,
                                               int N, const float* bias) {
  fence_accumulators<BN>(acc);
  const int t = threadIdx.x % 128;
  const int r = 16 * (t / 32) + (t % 32) / 4;
  const int col = 2 * (t % 4);
  const long long rows[2] = {row_of(r), row_of(r + 8)};
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int n = n0 + col + 8 * j;
    if (n >= N) continue;
    const float2 b = __ldg(reinterpret_cast<const float2*>(bias + n));
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (rows[h] < 0) continue;
      const float v0 = activate<kAct>(__fadd_rn(acc[4 * j + 2 * h], b.x));
      const float v1 =
          activate<kAct>(__fadd_rn(acc[4 * j + 2 * h + 1], b.y));
      *reinterpret_cast<float2*>(out + rows[h] * N + n) = make_float2(v0, v1);
    }
  }
}

// store_f32 into the transpose: the warpgroup's sums are rows m0 .. of a
// (M, N) product whose transpose `out` (N, M) row-major, ld = M, is the
// output: a formed weight gradient computes dWᵀ = daᵀ · x and stores dW.  A
// warp's store covers four rows of 32 bytes each.
template <int BN>
__device__ __forceinline__ void store_f32_t(float* acc, float* out, int m0,
                                            int rows, int n0, int N, int ld) {
  fence_accumulators<BN>(acc);
  const int t = threadIdx.x % 128;
  const int r = 16 * (t / 32) + (t % 32) / 4;
  const int col = 2 * (t % 4);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int n = n0 + col + 8 * j;
    if (n < N) {
      float* at = out + size_t(n) * ld + m0 + r;
      if (r < rows) {
        at[0] = acc[4 * j];
        at[ld] = acc[4 * j + 1];
      }
      if (r + 8 < rows) {
        at[8] = acc[4 * j + 2];
        at[ld + 8] = acc[4 * j + 3];
      }
    }
  }
}

// The row sums of a formed daᵀ (formed_product's rs0, rs1: rows g and g + 8
// of each warp's 16, a quarter of the k-steps' columns each) added across
// the quad of lanes that shares those rows, in one fixed order, and written
// to out[m0 + row] for the warpgroup's first `rows` rows.
__device__ __forceinline__ void finish_rows(float rs0, float rs1, float* out,
                                            int m0, int rows) {
  rs0 += __shfl_xor_sync(0xFFFFFFFFu, rs0, 1);
  rs1 += __shfl_xor_sync(0xFFFFFFFFu, rs1, 1);
  rs0 += __shfl_xor_sync(0xFFFFFFFFu, rs0, 2);
  rs1 += __shfl_xor_sync(0xFFFFFFFFu, rs1, 2);
  const int t = threadIdx.x % 128;
  const int r = 16 * (t / 32) + (t % 32) / 4;
  if (t % 4 == 0) {
    if (r < rows) out[m0 + r] = rs0;
    if (r + 8 < rows) out[m0 + r + 8] = rs1;
  }
}

// The column sums of B, from the staged N-major B (BN / 64 chunks of 64
// k-rows x 128 bytes, 128-byte swizzle) of one stage: the 256 consumer
// threads split the tile's BN / 2 column pairs and its 64 k-rows into
// kGroups = 512 / BN groups of BN / 8 rows; thread t adds pair t % (BN / 2)
// over the rows of group t / (BN / 2), in k order, into (s0, s1).  A warp
// reads 32 pairs of one 128-byte k-row: 32 banks.  The rows past the batch
// are TMA's zeros, so a ragged batch adds nothing.
template <int BN>
__device__ __forceinline__ void add_columns(uint32_t b_tile, float& s0,
                                            float& s1) {
  constexpr int kPairs = BN / 2;
  constexpr int kRows = BN / 8;
  const int t = threadIdx.x;
  const int p = t % kPairs;
  const int r0 = (t / kPairs) * kRows;
  const uint32_t base = b_tile + (p / 32) * kChunkBytes + 4 * (p % 4);
  const int unit = (p % 32) / 4;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = r0 + i;
    uint32_t v;
    asm volatile("ld.shared.b32 %0, [%1];\n"
                 : "=r"(v)
                 : "r"(base + r * 128 + ((unit ^ (r % 8)) << 4)));
    const __nv_bfloat162 h = *reinterpret_cast<__nv_bfloat162*>(&v);
    s0 += __low2float(h);
    s1 += __high2float(h);
  }
}

// The tile's column sums: each thread's (s0, s1) to `scratch` (shared,
// 2 KB), then the threads of group 0 add the groups in order and write
// their pair of columns n0 + 2p below N to `out`.  Barrier 3 spans both
// consumer warpgroups; the second keeps the scratch until it is read.
template <int BN>
__device__ __forceinline__ void finish_columns(float s0, float s1,
                                               uint32_t scratch, float* out,
                                               int n0, int N) {
  constexpr int kPairs = BN / 2;
  constexpr int kGroups = 512 / BN;
  const int t = threadIdx.x;
  asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(scratch + 8 * t),
               "f"(s0), "f"(s1)
               : "memory");
  named_barrier(3, 256);
  if (t < kPairs) {
    float c0 = 0.f, c1 = 0.f;
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      float v0, v1;
      asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
                   : "=f"(v0), "=f"(v1)
                   : "r"(scratch + 8 * (g * kPairs + t))
                   : "memory");
      c0 += v0;
      c1 += v1;
    }
    const int n = n0 + 2 * t;
    if (n < N) *reinterpret_cast<float2*>(out + n) = make_float2(c0, c1);
  }
  named_barrier(3, 256);
}

// f(std::integral_constant<int, epi.mode()>): the functor's run-time mode as
// a compile-time one.
template <typename Epi, typename F>
__device__ __forceinline__ void with_mode(const Epi& epi, F&& f) {
  if constexpr (Epi::kModes == 1) {
    f(std::integral_constant<int, 0>{});
  } else {
    static_assert(Epi::kModes == 3, "a functor has one mode, or three");
    const int mode = epi.mode();
    if (mode == 2) {
      f(std::integral_constant<int, 2>{});
    } else if (mode == 1) {
      f(std::integral_constant<int, 1>{});
    } else {
      f(std::integral_constant<int, 0>{});
    }
  }
}

// Tile `tile` of a tiles_m x tiles_n grid → its row and column: groups of
// eight tile rows, walked down the rows first, so that blocks that run
// together read few distinct tiles of A and B.
__device__ __forceinline__ void tile_origin(int tile, int tiles_m,
                                            int tiles_n, int& tm, int& tn) {
  constexpr int kGroup = 8;
  const int per_group = kGroup * tiles_n;
  const int group = tile / per_group;
  const int first = group * kGroup;
  const int rows = min(tiles_m - first, kGroup);
  const int in_group = tile - group * per_group;
  tm = first + in_group % rows;
  tn = in_group / rows;
}

// ------------------------------------------------------------ tile walks
//
// A Tiles type (the header's "tile walk") answers, for tile row tm of the
// output and k-step kb:
//   tiles_m(), k_steps(tm)      the grid of tile rows and the k-steps of one;
//   a_bytes(tm)                 the bytes the A loads of a stage bring (a box
//                               counts whole where TMA zero-fills it);
//   load_a(dst, map, bar, tm, kb)  those loads, into the 128-row A tile;
//   b_row(tm, kb)               the k-row of B that goes with them;
//   half(tm, wg, m0)            how many of warpgroup wg's 64 rows are
//                               output (0: none, skip the store), and the
//                               row index m0 the functor sees for the first;
//   store(map, src, tm, wg, n)  the TMA store of that half's 64 columns
//                               from n (load_c: the same box, loaded from a
//                               tensor of C's shape, the gate);
//   kOuts                       the outputs written side by side (above);
//   kAT                         (optional) A is M-major;
//   kJoined, second(kb)         (optional) two products joined along k:
//                               k-step kb reads the second (A, B) pair.

// The plain product: A (M, K) row-major, each of the kOuts C (M, N)
// row-major.  MatrixTiles writes one output, HeadsTiles two (the heads).
template <int kOutputs>
struct RowTiles {
  static constexpr int kOuts = kOutputs;
  int M, K;
  __host__ __device__ int tiles_m() const { return (M + kTileM - 1) / kTileM; }
  __device__ int k_steps(int) const { return (K + kTileK - 1) / kTileK; }
  __device__ uint32_t a_bytes(int) const { return kATileBytes; }
  __device__ void load_a(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                         int tm, int kb) const {
    tma_load(dst, map, bar, kb * kTileK, tm * kTileM);
  }
  __device__ int b_row(int, int kb) const { return kb * kTileK; }
  __device__ int half(int tm, int wg, int& m0) const {
    m0 = tm * kTileM + 64 * wg;
    return max(0, min(M - m0, 64));
  }
  __device__ void store(const CUtensorMap* map, uint32_t src, int tm, int wg,
                        int n) const {
    tma_store(map, src, n, tm * kTileM + 64 * wg);
  }
  __device__ void load_c(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                         int tm, int wg, int n) const {
    tma_load(dst, map, bar, n, tm * kTileM + 64 * wg);
  }
};
using MatrixTiles = RowTiles<1>;
using HeadsTiles = RowTiles<2>;

// Two plain products joined along k (header, "joined along k"): C = A1 ·
// B1 + A2 · B2, each A (M, K) row-major and each B read as MatrixTiles
// reads it; K is one product's contraction.  k-steps 0 .. steps() - 1 read
// the first pair, the next steps() the second, each from its column 0.
struct JoinedKTiles : MatrixTiles {
  static constexpr bool kJoined = true;
  __device__ int steps() const { return (K + kTileK - 1) / kTileK; }
  __device__ int k_steps(int) const { return 2 * steps(); }
  __device__ bool second(int kb) const { return kb >= steps(); }
  __device__ void load_a(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                         int tm, int kb) const {
    tma_load(dst, map, bar, b_row(tm, kb), tm * kTileM);
  }
  __device__ int b_row(int, int kb) const {
    return (second(kb) ? kb - steps() : kb) * kTileK;
  }
};

// The block-Toeplitz product (header, "tile walk"): x (B, nb, G) as a 3-D
// map (G, nb, B) with boxes (64, t_half, b_half), y (B, t_out, N) as (N,
// t_out, B) with boxes (64, t_half, b_half).  Half h of the output (tile
// row h / 2, warpgroup h % 2) is positions [tc·t_half, +t_half) of batch
// rows [bg·b_half, +b_half), with tc = h % n_t and bg = h / n_t.
struct ToeplitzTiles {
  static constexpr int kOuts = 1;
  int B, t_out, shift, G, t_half, b_half;
  int n_t;      // ceil(t_out / t_half): halves along a batch row
  int halves;   // n_t · ceil(B / b_half)
  int g_steps;  // ceil(G / 64): k-steps a tap
  int steps;    // KB · g_steps
  __host__ __device__ int tiles_m() const { return (halves + 1) / 2; }
  __device__ int k_steps(int) const { return steps; }
  __device__ uint32_t a_bytes(int tm) const {
    return (2 * tm + 1 < halves ? 2u : 1u) * t_half * b_half * 128u;
  }
  __device__ void load_a(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                         int tm, int kb) const {
    const int j = kb / g_steps;
    const int g0 = (kb - j * g_steps) * kTileK;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int at = 2 * tm + h;
      if (at < halves) {
        const int bg = at / n_t, tc = at - bg * n_t;
        tma_load(dst + h * (kATileBytes / 2), map, bar, g0,
                 tc * t_half - shift + j, bg * b_half);
      }
    }
  }
  __device__ int b_row(int, int kb) const {
    const int j = kb / g_steps;
    return j * G + (kb - j * g_steps) * kTileK;
  }
  __device__ int half(int tm, int wg, int& m0) const {
    m0 = 0;
    return 2 * tm + wg < halves ? t_half * b_half : 0;
  }
  __device__ void store(const CUtensorMap* map, uint32_t src, int tm, int wg,
                        int n) const {
    const int at = 2 * tm + wg;
    const int bg = at / n_t, tc = at - bg * n_t;
    tma_store(map, src, n, tc * t_half, bg * b_half);
  }
  // Row r of that half → its row of y viewed as (B·t_out, N), or -1 where
  // r lies past t_half · b_half or its position past t_out or its batch
  // row past B (the 4-pass form's store from the accumulators, which has
  // no TMA clipping).
  __device__ long long out_row(int tm, int wg, int r) const {
    const int at = 2 * tm + wg;
    const int bg = at / n_t, tc = at - bg * n_t;
    const int b = bg * b_half + r / t_half, t = tc * t_half + r % t_half;
    if (r >= t_half * b_half || b >= B || t >= t_out) return -1;
    return static_cast<long long>(b) * t_out + t;
  }
};

// The weight gradient dW = Aᵀ · B (header, "weight gradients"): A (K, M)
// and B (K, N) row-major, the contraction K (the batch) their row axis, so
// A is read M-major, (64 m x 64 k) boxes at (m, k), and B N-major.  K is cut
// into `slices` runs of `steps` k-steps (the last may be shorter); tile row
// tm is slice tm / m_tiles at rows (tm % m_tiles) · 128 of dW, so a slice's
// tiles are a whole dW and the launch has m_tiles · slices · ceil(N / BN)
// tiles.  Rows past K are TMA's zeros in both operands: a ragged batch adds
// nothing.  kOutputs weight gradients of one A side by side (header,
// "weight gradients"): the walk's tile columns are kOutputs · ceil(N / BN).
template <int kOutputs>
struct WgradTiles {
  static constexpr int kOuts = kOutputs;
  static constexpr bool kAT = true;
  int M, m_tiles, steps, k_total, slices;  // k_total = ceil(K / 64)
  __host__ __device__ int tiles_m() const { return m_tiles * slices; }
  __device__ int slice(int tm) const { return tm / m_tiles; }
  __device__ int k_steps(int tm) const {
    return min(steps, k_total - slice(tm) * steps);
  }
  __device__ uint32_t a_bytes(int) const { return kATileBytes; }
  __device__ void load_a(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                         int tm, int kb) const {
    const int m0 = (tm % m_tiles) * kTileM;
    const int k0 = b_row(tm, kb);
    tma_load(dst, map, bar, m0, k0);
    tma_load(dst + kChunkBytes, map, bar, m0 + 64, k0);
  }
  __device__ int b_row(int tm, int kb) const {
    return (slice(tm) * steps + kb) * kTileK;
  }
  __device__ int half(int tm, int wg, int& m0) const {
    m0 = (tm % m_tiles) * kTileM + 64 * wg;
    return max(0, min(M - m0, 64));
  }
  // the tiles of dW's first tile row also sum B's columns
  __device__ bool sums_columns(int tm) const { return tm % m_tiles == 0; }
};

// The weight gradient's epilogue: slice s of the walk writes output o's
// fp32 dW (M, N) at dw[o] + s · stride and its column sums at db[o] + s ·
// stride; one slice writes the outputs themselves, more write the
// workspace that sum_slices adds up.
struct WgradOut {
  static constexpr bool kWgrad = true;
  float* dw[kMaxOuts];
  float* db[kMaxOuts];
  size_t stride;
};

// The 3-pass epilogues (header, "the 3-pass product"): a weight gradient's
// fp32 dW from the three sums, its db left to the split pass (db unused);
// and a product's fp32 rows C (M, N) row-major, zeroed where `gate` (fp32,
// C's shape) is not > 0 if there is one.
struct SplitWgradOut : WgradOut {
  static constexpr bool kSplit = true;
};
struct SplitRows {
  static constexpr bool kSplit = true;
  float* out;
  const float* gate;
};
// The 3-pass forward's epilogue: output o of the walk to out[o] (M, N)
// fp32 row-major, each value the three sums added, then bias[o] (N,) added
// where it is not null, then the activation kActivation (an rvk::Act:
// none, relu, tanh), one store.
template <int kActivation>
struct SplitBiasRows {
  static constexpr bool kSplit = true;
  static constexpr int kAct = kActivation;
  float* out[kMaxOuts];
  const float* bias[kMaxOuts];
};
template <typename E, typename = void>
constexpr bool kSplitBiasOut = false;
template <typename E>
constexpr bool kSplitBiasOut<E, std::void_t<decltype(E::kAct)>> =
    kSplitPass<E>;
// The 4-pass Toeplitz epilogue (header, "the 4-pass Toeplitz product"): y
// (B, t_out, N) fp32, each value the four sums added (hh + ll) + (hl +
// lh), then bias (N,) fp32, then the activation kActivation (an rvk::Act),
// one store; on ToeplitzTiles only.
template <int kActivation>
struct FourPassRows {
  static constexpr bool kSplit = true;
  static constexpr int kPasses = 4;
  static constexpr int kAct = kActivation;
  float* out;
  const float* bias;
};

// The row-parallel epilogue (header, "partial sums"): a 1-pass product's
// fp32 sums as they are, no bias, no activation, no rounding, output o of
// the walk to out[o], (M, N) row-major.
struct PartialRows {
  static constexpr bool kPartial = true;
  float* out[kMaxOuts];
};
template <typename E, typename = void>
constexpr bool kPartialOut = false;
template <typename E>
constexpr bool kPartialOut<E, std::void_t<decltype(E::kPartial)>> =
    E::kPartial;

// The tensor maps of one launch: A, and a (B, C) pair for each of the
// kOuts outputs, and the gate of a gated functor (C's shape; unused
// otherwise); a k-joined walk's (kJoined) also the second pair's A and B.
// A kernel parameter (__grid_constant__): TMA reads the maps where the
// launch put them.
template <int kOuts, bool kJoined = false>
struct Maps {
  CUtensorMap a;
  CUtensorMap b[kOuts];
  CUtensorMap c[kOuts];
  CUtensorMap gate;
};
template <int kOuts>
struct Maps<kOuts, true> : Maps<kOuts, false> {
  CUtensorMap a2;
  CUtensorMap b2;
};
// A 3-pass launch's: the hi halves' maps as a 1-pass launch has its
// operands', and the lo halves' in `lo` (its c and gate unused).
template <int kOuts, bool kJoined>
struct SplitMaps : Maps<kOuts, kJoined> {
  Maps<kOuts, kJoined> lo;
};
template <typename Tiles, typename Epi>
using KernelMaps =
    std::conditional_t<kSplitPass<Epi>, SplitMaps<Tiles::kOuts, kTwoA<Tiles>>,
                       Maps<Tiles::kOuts, kTwoA<Tiles>>>;

// The shared memory of a launch: kStages stages of A and B (a formed A
// stages y and dy, two A tiles), two staging buffers of 64 rows x
// kStagingCols (none for a formed weight gradient, which stores from the
// accumulators and sums its rows in registers), the barriers.  A formed
// A's stage is 16 KB larger: at 128 x 256 three stages fit only beside
// staging buffers half the tile wide, which the epilogue fills and stores
// twice; at 128 x 128 four, at 128 x 64 five (header, "the fused linear
// backward").  A 3-pass (or 4-pass) stage holds both halves of A and of
// B, twice a plain one, and needs no staging: four stages at 128 x 64,
// three at 128 x 128 (header, "the 3-pass product").
template <int BN, typename Tiles, typename Epi>
struct Ring {
  static constexpr bool kFormed = kFormedA<Tiles>;
  static constexpr bool kSplit = kSplitPass<Epi>;
  static constexpr uint32_t kABytes =
      (kFormed || kSplit ? 2 : 1) * kATileBytes;
  static constexpr uint32_t kBBytes = (kSplit ? 2 : 1) * BN * kTileK * 2;
  static constexpr uint32_t kStageBytes = kABytes + kBBytes;
  static constexpr int kStagingCols = kFormed && BN == 256 ? 128 : BN;
  static constexpr uint32_t kStagingBytes =
      (kFormed && kWgradOut<Epi>) || kSplit || kPartialOut<Epi>
          ? 0
          : 64 * kStagingCols * 2;
  static constexpr int kStages = kSplit      ? (BN == 64 ? 4 : 3)
                                 : !kFormed  ? stages_for(BN)
                                 : BN == 256 ? 3
                                 : BN == 128 ? 4
                                             : 5;
  // the slack to align the ring to 1024 bytes; full and empty a stage, two
  // for a gate
  static constexpr int kSmem = kStages * kStageBytes + 2 * kStagingBytes +
                               1024 + 16 * kStages + 16;
};

// ------------------------------------------------------------ the mainloop

template <int BN, int kStages, bool kBT, typename Epi, typename Tiles>
__global__ void __launch_bounds__(kBlock, 1)
wgmma_gemm_kernel(const __grid_constant__ KernelMaps<Tiles, Epi> maps,
                  const Epi epi, const Tiles tiles, int N) {
  static_assert(BN == 64 || BN == 128 || BN == 256,
                "the tile is 64, 128 or 256 wide");
  // a stage is released one step late (one wgmma group stays in flight)
  static_assert(kStages >= 2, "a ring of one stage would deadlock");
  constexpr bool kAT = kMMajorA<Tiles>;
  constexpr bool kGate = kGated<Epi>;
  constexpr bool kWgrad = kWgradOut<Epi>;
  static_assert(!kWgrad || kBT, "the column sums read an N-major B");
  static_assert(!kGate || Tiles::kOuts == 1, "a gate has C's shape");
  static_assert(!kWgrad || Tiles::kOuts <= kMaxOuts,
                "a weight gradient writes at most kMaxOuts outputs");
  constexpr bool kFormed = kFormedA<Tiles>;
  static_assert(!kFormed || Tiles::kOuts == 1, "one formed output");
  constexpr bool kSplit = kSplitPass<Epi>;
  static_assert(!kSplit || (!kFormed && !kGate && BN <= 128),
                "a 3-pass product: plain operands, 64 or 128 wide");
  constexpr bool kFour = kFourPass<Epi>;
  static_assert(!kFour || (kSplit && BN == 64),
                "a 4-pass product: a 3-pass stage, four accumulators of "
                "128 x 64");
  constexpr uint32_t kBTileBytes = BN * kTileK * 2;
  constexpr uint32_t kABytes = Ring<BN, Tiles, Epi>::kABytes;
  constexpr uint32_t kStageBytes = Ring<BN, Tiles, Epi>::kStageBytes;
  extern __shared__ uint8_t smem_raw[];
  // the swizzle atoms are 1024 bytes: align the ring to that
  const uint32_t ring = (smem_u32(smem_raw) + 1023u) & ~1023u;
  // after the ring, a 64 x BN staging buffer for each consumer warpgroup
  // (a weight gradient uses the first 2 KB for its column sums; a formed
  // one has none)
  constexpr uint32_t kStagingBytes = Ring<BN, Tiles, Epi>::kStagingBytes;
  const uint32_t staging = ring + kStages * kStageBytes;
  const uint32_t full = staging + 2 * kStagingBytes;
  const uint32_t empty = full + 8 * kStages;
  // a gated functor's: the gate's boxes have landed in warpgroup wg's
  // staging buffer
  const uint32_t gate_full = empty + 8 * kStages;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumerWarps);
    }
    mbar_init(gate_full, 1);
    mbar_init(gate_full + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  const int tiles_m = tiles.tiles_m();
  // tile columns an output; the joined output has kOuts times as many
  const int per_out = (N + BN - 1) / BN;
  const int tiles_n = Tiles::kOuts * per_out;
  const int n_tiles = tiles_m * tiles_n;

  if (warp >= kConsumerWarps) {
    // ----- the producer's warpgroup: one lane keeps the loads in flight
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (warp == kConsumerWarps && lane == 0) {
      int s = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        int tm, tn;
        tile_origin(tile, tiles_m, tiles_n, tm, tn);
        const int out = tn / per_out;
        const int n0 = (tn - out * per_out) * BN;
        const CUtensorMap* map_b = &maps.b[out];
        // a formed A's y and dy, a 3-pass stage's two halves of each
        const uint32_t stage_bytes =
            (kFormed || kSplit ? 2 : 1) * tiles.a_bytes(tm) +
            (kSplit ? 2 : 1) * kBTileBytes;
        const int n_kb = tiles.k_steps(tm);
        for (int kb = 0; kb < n_kb; ++kb) {
          // a fresh barrier passes a wait on the parity before its first
          mbar_wait(empty + 8 * s, phase ^ 1);
          const uint32_t bar = full + 8 * s;
          const uint32_t a_tile = ring + s * kStageBytes;
          const uint32_t b_tile = a_tile + kABytes;
          mbar_expect_tx(bar, stage_bytes);
          // a k-joined walk's second product reads the second pair
          const CUtensorMap* step_a = &maps.a;
          const CUtensorMap* step_b = map_b;
          if constexpr (kJoinedK<Tiles>) {
            if (tiles.second(kb)) {
              step_a = &maps.a2;
              step_b = &maps.b2;
            }
          }
          tiles.load_a(a_tile, step_a, bar, tm, kb);
          // a formed A: dy's boxes after y's
          if constexpr (kFormed) {
            tiles.load_a(a_tile + kATileBytes, &maps.a2, bar, tm, kb);
          }
          const int k0 = tiles.b_row(tm, kb);
          auto load_b = [&](uint32_t dst, const CUtensorMap* map) {
            if constexpr (kBT) {
#pragma unroll
              for (int c = 0; c < BN / 64; ++c) {
                tma_load(dst + c * kChunkBytes, map, bar, n0 + 64 * c, k0);
              }
            } else {
              tma_load(dst, map, bar, k0, n0);
            }
          };
          load_b(b_tile, step_b);
          // a 3-pass stage: the lo halves' boxes after the hi ones'
          if constexpr (kSplit) {
            const CUtensorMap* lo_a = &maps.lo.a;
            const CUtensorMap* lo_b = &maps.lo.b[out];
            if constexpr (kJoinedK<Tiles>) {
              if (tiles.second(kb)) {
                lo_a = &maps.lo.a2;
                lo_b = &maps.lo.b2;
              }
            }
            tiles.load_a(a_tile + kATileBytes, lo_a, bar, tm, kb);
            load_b(b_tile + kBTileBytes, lo_b);
          }
          if (++s == kStages) {
            s = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // ----- two consumer warpgroups, 64 rows of the tile each
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int wg = warp / 4;
    const bool leader = threadIdx.x % 128 == 0;
    const uint32_t staged = staging + wg * kStagingBytes;
    float acc[BN / 2];
    // a 3-pass product's A_hi·B_lo and A_lo·B_hi (acc takes A_hi·B_hi), a
    // 4-pass one's A_lo·B_lo too
    float acc_hl[kSplit ? BN / 2 : 1], acc_lh[kSplit ? BN / 2 : 1];
    float acc_ll[kFour ? BN / 2 : 1];
    // a formed A's fragments: two sets, taken by turns (formed_product)
    uint32_t frag[2][kTileK / 16][4];
    int s = 0, prev = 0;
    uint32_t phase = 0, gate_phase = 0;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      int tm, tn;
      tile_origin(tile, tiles_m, tiles_n, tm, tn);
      const int out = tn / per_out;
      const int n0 = (tn - out * per_out) * BN;
      int m0;
      const int rows = tiles.half(tm, wg, m0);
      const int n_kb = tiles.k_steps(tm);
      // a weight gradient's bias gradient: the column sums of B from the
      // first tile row, or a formed one's row sums of daᵀ from the first
      // tile column
      // (a 3-pass one's come from the split pass)
      bool sums = false;
      if constexpr (kWgrad && !kSplit) {
        sums = kFormed ? tn == 0 : tiles.sums_columns(tm);
      }
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
      if constexpr (kSplit) {
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) acc_hl[i] = acc_lh[i] = 0.f;
      }
      if constexpr (kFour) {
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) acc_ll[i] = 0.f;
      }
      // one k-step; a formed A's registers are `a`
      auto k_step = [&](int kb, uint32_t(&a)[kTileK / 16][4]) {
        mbar_wait(full + 8 * s, phase);
        const uint32_t a_tile = ring + s * kStageBytes;
        if constexpr (kFormed) {
          const uint32_t y_tile = a_tile + wg * (kATileBytes / 2);
          formed_product<BN, kAT, kBT, Tiles::kAct>(
              acc, a, y_tile, y_tile + kATileBytes, a_tile + kABytes, sums,
              s0, s1);
        } else {
          const uint32_t a_wg = a_tile + wg * (kATileBytes / 2);
          const uint32_t b_tile = a_tile + kABytes;
          wgmma_fence();
          stage_product<BN, kAT, kBT>(acc, a_wg, b_tile);
          // a 3-pass stage: A_lo after A_hi, B_lo after B_hi; one group
          if constexpr (kSplit) {
            stage_product<BN, kAT, kBT>(acc_hl, a_wg, b_tile + kBTileBytes);
            stage_product<BN, kAT, kBT>(acc_lh, a_wg + kATileBytes, b_tile);
          }
          if constexpr (kFour) {
            stage_product<BN, kAT, kBT>(acc_ll, a_wg + kATileBytes,
                                        b_tile + kBTileBytes);
          }
        }
        wgmma_commit();
        // while the products run: the column sums read the same stage
        if constexpr (kWgrad && !kFormed) {
          if (sums) add_columns<BN>(a_tile + kABytes, s0, s1);
        }
        // the gate's boxes go to the staging buffer once the last tile's
        // store has read it, early enough to land under this tile's
        // products; the half's rows past M and the boxes past N are not
        // loaded (and never read)
        if constexpr (kGate) {
          if (kb == 0 && leader) {
            tma_store_wait_read();
            const uint32_t bar = gate_full + 8 * wg;
            int boxes = 0;
            for (int c = 0; c < BN / 64; ++c) {
              boxes += rows > 0 && n0 + 64 * c < N;
            }
            mbar_expect_tx(bar, boxes * kChunkBytes);
            for (int c = 0; c < BN / 64; ++c) {
              if (rows > 0 && n0 + 64 * c < N) {
                tiles.load_c(staged + c * kChunkBytes, &maps.gate, bar, tm,
                             wg, n0 + 64 * c);
              }
            }
          }
        }
        // the stage before this one is read once its group has retired
        wgmma_wait<1>();
        if (kb > 0 && lane == 0) mbar_arrive(empty + 8 * prev);
        prev = s;
        if (++s == kStages) {
          s = 0;
          phase ^= 1;
        }
      };
      if constexpr (kFormed) {
        // the products of a k-step read its fragments until the next
        // k-step's wait retires them: k-steps take the two sets by turns,
        // each defined again only two k-steps later
        for (int kb = 0; kb < n_kb; kb += 2) {
          k_step(kb, frag[0]);
          if (kb + 1 < n_kb) k_step(kb + 1, frag[1]);
        }
      } else {
        for (int kb = 0; kb < n_kb; ++kb) k_step(kb, frag[0]);
      }
      if constexpr (kSplit) {
        // (hh + hl) + lh with IEEE adds, then the fp32 store: a weight
        // gradient's slice to its place, a product's rows through the gate;
        // four passes (hh + ll) + (hl + lh), the Toeplitz rows
        wgmma_wait<0>();
        if (lane == 0) mbar_arrive(empty + 8 * prev);
        fence_accumulators<BN>(acc);
        fence_accumulators<BN>(acc_hl);
        fence_accumulators<BN>(acc_lh);
        if constexpr (kFour) {
          fence_accumulators<BN>(acc_ll);
#pragma unroll
          for (int i = 0; i < BN / 2; ++i) {
            acc[i] = __fadd_rn(__fadd_rn(acc[i], acc_ll[i]),
                               __fadd_rn(acc_hl[i], acc_lh[i]));
          }
        } else {
#pragma unroll
          for (int i = 0; i < BN / 2; ++i) {
            acc[i] = __fadd_rn(__fadd_rn(acc[i], acc_hl[i]), acc_lh[i]);
          }
        }
        if constexpr (kFour) {
          if (rows > 0) {
            store_f32_rows<BN, Epi::kAct>(
                acc, epi.out,
                [&](int r) { return tiles.out_row(tm, wg, r); }, n0, N,
                epi.bias);
          }
        } else if constexpr (kWgrad) {
          store_f32<BN>(acc,
                        pick(epi.dw, out) + size_t(tiles.slice(tm)) *
                                                epi.stride,
                        m0, rows, n0, N);
        } else if constexpr (kSplitBiasOut<Epi>) {
          store_f32<BN, Epi::kAct>(acc, pick(epi.out, out), m0, rows, n0, N,
                                   nullptr, pick(epi.bias, out));
        } else {
          store_f32<BN>(acc, epi.out, m0, rows, n0, N, epi.gate);
        }
      } else if constexpr (kPartialOut<Epi>) {
        // the partial sums as they are, fp32 from the accumulators
        wgmma_wait<0>();
        if (lane == 0) mbar_arrive(empty + 8 * prev);
        store_f32<BN>(acc, pick(epi.out, out), m0, rows, n0, N);
      } else if constexpr (kWgrad) {
        wgmma_wait<0>();
        if (lane == 0) mbar_arrive(empty + 8 * prev);
        const size_t at = size_t(tiles.slice(tm)) * epi.stride;
        if constexpr (kFormed) {
          store_f32_t<BN>(acc, pick(epi.dw, out) + at, m0, rows, n0, N,
                          tiles.M);
          if (sums) finish_rows(s0, s1, pick(epi.db, out) + at, m0, rows);
        } else {
          store_f32<BN>(acc, pick(epi.dw, out) + at, m0, rows, n0, N);
          if (sums) {
            finish_columns<BN>(s0, s1, staging, pick(epi.db, out) + at, n0,
                               N);
          }
        }
      } else {
        // what the epilogue reads per column pair, fetched while the last
        // products are in flight; the functor sees the joined column
        typename Epi::Column columns[BN / 8] = {};
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int n = n0 + 2 * (lane % 4) + 8 * j;
          if (n < N) columns[j] = epi.column(out * N + n);
        }
        wgmma_wait<0>();
        if (lane == 0) mbar_arrive(empty + 8 * prev);
        // the half tile goes out in parts of kCols columns, the staging
        // buffer's width (Ring: all of BN but for a formed A at 256)
        constexpr int kCols = Ring<BN, Tiles, Epi>::kStagingCols;
        static_assert(!kGate || kCols == BN, "a gate fills the whole buffer");
#pragma unroll
        for (int part = 0; part < BN / kCols; ++part) {
          const int c0 = n0 + part * kCols;
          // the staging buffer is free once the last store has read it
          if (leader) tma_store_wait_read();
          named_barrier(1 + wg, 128);
          if constexpr (kGate) {
            mbar_wait(gate_full + 8 * wg, gate_phase);
            gate_phase ^= 1;
          }
          with_mode(epi, [&](auto mode) {
            stage_tile<kCols, decltype(mode)::value>(
                acc + part * kCols / 2, epi, columns + part * kCols / 8,
                staged, m0, rows, c0, N, out * N);
          });
          // generic-proxy stores, read next by the async proxy
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          named_barrier(1 + wg, 128);
          if (leader && rows > 0) {
#pragma unroll
            for (int c = 0; c < kCols / 64; ++c) {
              if (c0 + 64 * c < N) {
                tiles.store(&maps.c[out], staged + c * kChunkBytes, tm, wg,
                            c0 + 64 * c);
              }
            }
            tma_store_commit();
          }
        }
      }
    }
    // shared memory must outlive the last store's reads
    if (leader) tma_store_wait_read();
  }
}

// ------------------------------------------------------------------- host

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled lives in libcuda; the library links against
// the runtime alone, so the symbol is fetched through it.
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

// The tensor map of a row-major bf16 tensor of `rank` (2 or 3) dims, dims
// innermost first, cut into boxes of `box` (box[0] = 64: 128 bytes),
// 128-byte swizzle, zeros outside.  The base and every pitch must be
// multiples of 16 bytes.
inline cudaError_t box_map(CUtensorMap* map, const bf16* p, int rank,
                           const cuuint64_t* dims, const cuuint32_t* box) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  cuuint64_t pitch[2];
  cuuint64_t bytes = sizeof(bf16);
  for (int i = 0; i + 1 < rank; ++i) {
    bytes *= dims[i];
    pitch[i] = bytes;
  }
  const cuuint32_t step[3] = {1, 1, 1};
  const CUresult rc = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
      const_cast<void*>(static_cast<const void*>(p)), dims, pitch, box, step,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A row-major (outer, inner) matrix in boxes of box_outer x box_inner.
inline cudaError_t matrix_map(CUtensorMap* map, const bf16* p, int outer,
                              int inner, int box_outer, int box_inner) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner),
                              static_cast<cuuint64_t>(outer)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_inner),
                             static_cast<cuuint32_t>(box_outer)};
  return box_map(map, p, 2, dims, box);
}

// A (rows, cols, inner) tensor in boxes of (64, box_cols, box_rows).
inline cudaError_t cube_map(CUtensorMap* map, const bf16* p, int rows,
                            int cols, int inner, int box_cols, int box_rows) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(inner),
                              static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows)};
  return box_map(map, p, 3, dims, box);
}

template <int BN, bool kBT, typename Epi, typename Tiles>
cudaError_t launch_tiles(const KernelMaps<Tiles, Epi>& maps, const Epi& epi,
                         const Tiles& tiles, int N, cudaStream_t stream) {
  using R = Ring<BN, Tiles, Epi>;
  auto kernel = wgmma_gemm_kernel<BN, R::kStages, kBT, Epi, Tiles>;
  const int smem = R::kSmem;
  // above the 48 KB a block gets without opting in: once a device
  static uint64_t opted_in = 0;
  int device = 0;
  cudaGetDevice(&device);
  if (device >= 64 || !(opted_in >> device & 1)) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    if (device < 64) opted_in |= uint64_t{1} << device;
  }
  const int n_tiles = tiles.tiles_m() * Tiles::kOuts * cdiv(N, BN);
  const int blocks = n_tiles < sm_count() ? n_tiles : sm_count();
  kernel<<<blocks, kBlock, smem, stream>>>(maps, epi, tiles, N);
  return cudaGetLastError();
}

// f(std::integral_constant<int, tile_n>) for a tile width of 256, 128 or
// 64 (a 3-pass product, kSplit: 128 or 64); anything else is refused.
template <bool kSplit = false, typename F>
cudaError_t with_width(int tile_n, F&& f) {
  switch (tile_n) {
    case 256:
      if constexpr (kSplit) return cudaErrorInvalidValue;
      else return f(std::integral_constant<int, 256>{});
    case 128:
      return f(std::integral_constant<int, 128>{});
    case 64:
      return f(std::integral_constant<int, 64>{});
    default:
      return cudaErrorInvalidValue;
  }
}

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// C[i] = epi(A · B[i]) for each of the Tiles::kOuts outputs, on the
// tensor cores in 128 x tile_n tiles.  a (M, K) row-major; each b[i] (N, K)
// row-major, or (K, N) row-major with kBT; each c[i] (M, N) row-major; all
// bf16 and 16-byte aligned, K and N multiples of 8 (the caller's dispatch
// holds that, ops/tensor_cores.py).  A gated functor reads `gate`, (M, N)
// row-major bf16 and 16-byte aligned, as C's boxes.
template <bool kBT, typename Tiles, typename Epi>
cudaError_t launch_rows(const bf16* a, const bf16* const* b, bf16* const* c,
                        const Epi& epi, int M, int N, int K, int tile_n,
                        cudaStream_t stream, const bf16* gate = nullptr) {
  constexpr int kOuts = Tiles::kOuts;
  if (M <= 0 || N <= 0) return cudaSuccess;
  if (K <= 0 || K % 8 != 0 || N % 8 != 0 || !aligned16(a) ||
      kGated<Epi> != (gate != nullptr) || !aligned16(gate)) {
    return cudaErrorInvalidValue;
  }
  for (int i = 0; i < kOuts; ++i) {
    if (!aligned16(b[i]) || !aligned16(c[i])) return cudaErrorInvalidValue;
  }
  return with_width(tile_n, [&](auto width) {
    constexpr int BN = decltype(width)::value;
    Maps<kOuts> maps;
    cudaError_t err = matrix_map(&maps.a, a, M, K, kTileM, kTileK);
    for (int i = 0; i < kOuts && err == cudaSuccess; ++i) {
      err = kBT ? matrix_map(&maps.b[i], b[i], K, N, kTileK, 64)
                : matrix_map(&maps.b[i], b[i], N, K, BN, kTileK);
      if (err == cudaSuccess) err = matrix_map(&maps.c[i], c[i], M, N, 64, 64);
    }
    if (err == cudaSuccess && gate != nullptr) {
      err = matrix_map(&maps.gate, gate, M, N, 64, 64);
    }
    if (err != cudaSuccess) return err;
    return launch_tiles<BN, kBT>(maps, epi, Tiles{M, K}, N, stream);
  });
}

// C[o] = A · B[o] in fp32 for each of the Tiles::kOuts outputs, the sums
// as they are (PartialRows: no bias, no activation, no rounding), on the
// tensor cores in 128 x tile_n tiles: a (M, K) row-major, each b[o] (K, N)
// row-major (N-major B), each c[o] (M, N) row-major fp32; all 16-byte
// aligned, K and N multiples of 8.
template <typename Tiles>
cudaError_t launch_partial(const bf16* a, const bf16* const* b,
                           float* const* c, int M, int N, int K, int tile_n,
                           cudaStream_t stream) {
  constexpr int kOuts = Tiles::kOuts;
  if (M <= 0 || N <= 0) return cudaSuccess;
  if (K <= 0 || K % 8 != 0 || N % 8 != 0 || !aligned16(a)) {
    return cudaErrorInvalidValue;
  }
  PartialRows epi{};
  for (int i = 0; i < kOuts; ++i) {
    if (!aligned16(b[i]) || !aligned16(c[i])) return cudaErrorInvalidValue;
    epi.out[i] = c[i];
  }
  return with_width(tile_n, [&](auto width) {
    constexpr int BN = decltype(width)::value;
    Maps<kOuts> maps{};
    cudaError_t err = matrix_map(&maps.a, a, M, K, kTileM, kTileK);
    for (int i = 0; i < kOuts && err == cudaSuccess; ++i) {
      err = matrix_map(&maps.b[i], b[i], K, N, kTileK, 64);
    }
    if (err != cudaSuccess) return err;
    return launch_tiles<BN, true>(maps, epi, Tiles{M, K}, N, stream);
  });
}

// C = epi(A · B): launch_rows with one output (and the gate of a gated
// functor).
template <bool kBT, typename Epi>
cudaError_t launch_wgmma(const bf16* a, const bf16* b, bf16* c,
                         const Epi& epi, int M, int N, int K, int tile_n,
                         cudaStream_t stream, const bf16* gate = nullptr) {
  return launch_rows<kBT, MatrixTiles>(a, &b, &c, epi, M, N, K, tile_n,
                                       stream, gate);
}

// C = epi(a1 · b1ᵀ + a2 · b2ᵀ) on the tensor cores in 128 x tile_n tiles,
// one k-joined walk (JoinedKTiles): a1 and a2 (M, K), b1 and b2 (N, K)
// (K-major, matmul_nt's B), c (M, N), all row-major bf16 and 16-byte
// aligned, K and N multiples of 8.  A gated functor reads `gate`, (M, N)
// row-major bf16 and 16-byte aligned, as C's boxes.
template <typename Epi>
cudaError_t launch_joined(const bf16* a1, const bf16* b1, const bf16* a2,
                          const bf16* b2, bf16* c, const Epi& epi, int M,
                          int N, int K, int tile_n, cudaStream_t stream,
                          const bf16* gate = nullptr) {
  if (M <= 0 || N <= 0) return cudaSuccess;
  if (K <= 0 || K % 8 != 0 || N % 8 != 0 || !aligned16(a1) ||
      !aligned16(b1) || !aligned16(a2) || !aligned16(b2) || !aligned16(c) ||
      kGated<Epi> != (gate != nullptr) || !aligned16(gate)) {
    return cudaErrorInvalidValue;
  }
  return with_width(tile_n, [&](auto width) {
    constexpr int BN = decltype(width)::value;
    Maps<1, true> maps;
    const cudaError_t errs[] = {
        matrix_map(&maps.a, a1, M, K, kTileM, kTileK),
        matrix_map(&maps.a2, a2, M, K, kTileM, kTileK),
        matrix_map(&maps.b[0], b1, N, K, BN, kTileK),
        matrix_map(&maps.b2, b2, N, K, BN, kTileK),
        matrix_map(&maps.c[0], c, M, N, 64, 64),
        gate != nullptr ? matrix_map(&maps.gate, gate, M, N, 64, 64)
                        : cudaSuccess};
    for (const cudaError_t err : errs) {
      if (err != cudaSuccess) return err;
    }
    return launch_tiles<BN, false>(maps, epi, JoinedKTiles{{M, K}}, N,
                                   stream);
  });
}

// The 3-pass product's rows (header, "the 3-pass product"): c (M, N) =
// where(gate > 0, a[0] · b[0]ᵀ [+ a[1] · b[1]ᵀ, kJoined: one walk joined
// along k], 0), fp32, on the tensor cores in 128 x tile_n tiles (128 or
// 64).  Each a[i] (M, K) and b[i] (N, K) row-major are the bf16 halves of
// an fp32 matrix (the split pass's hi and lo); c and the fp32 gate (c's
// shape, or null for none) row-major; all 16-byte aligned, K and N
// multiples of 8.
struct Halves {
  const bf16* hi;
  const bf16* lo;
};
template <bool kJoined>
cudaError_t launch_split_rows(const Halves* a, const Halves* b, float* c,
                              const float* gate, int M, int N, int K,
                              int tile_n, cudaStream_t stream) {
  if (M <= 0 || N <= 0) return cudaSuccess;
  if (K <= 0 || K % 8 != 0 || N % 8 != 0 || !aligned16(c) ||
      !aligned16(gate)) {
    return cudaErrorInvalidValue;
  }
  for (int i = 0; i < (kJoined ? 2 : 1); ++i) {
    if (!aligned16(a[i].hi) || !aligned16(a[i].lo) || !aligned16(b[i].hi) ||
        !aligned16(b[i].lo)) {
      return cudaErrorInvalidValue;
    }
  }
  using Tiles = std::conditional_t<kJoined, JoinedKTiles, MatrixTiles>;
  Tiles tiles{};
  tiles.M = M;
  tiles.K = K;
  return with_width<true>(tile_n, [&](auto width) {
    constexpr int BN = decltype(width)::value;
    KernelMaps<Tiles, SplitRows> maps;
    // the hi halves' maps, then the lo halves'
    Maps<1, kJoined>* const halves[2] = {&maps, &maps.lo};
    for (int h = 0; h < 2; ++h) {
      Maps<1, kJoined>& m = *halves[h];
      cudaError_t e = matrix_map(&m.a, h ? a[0].lo : a[0].hi, M, K, kTileM,
                                 kTileK);
      if (e == cudaSuccess) {
        e = matrix_map(&m.b[0], h ? b[0].lo : b[0].hi, N, K, BN, kTileK);
      }
      if constexpr (kJoined) {
        if (e == cudaSuccess) {
          e = matrix_map(&m.a2, h ? a[1].lo : a[1].hi, M, K, kTileM, kTileK);
        }
        if (e == cudaSuccess) {
          e = matrix_map(&m.b2, h ? b[1].lo : b[1].hi, N, K, BN, kTileK);
        }
      }
      if (e != cudaSuccess) return e;
    }
    return launch_tiles<BN, false>(maps, SplitRows{c, gate}, tiles, N,
                                   stream);
  });
}

// The 3-pass forward product (header, "the 3-pass product"): for each of
// the Tiles::kOuts outputs o (MatrixTiles one, HeadsTiles the encoder's
// two heads in one walk), c[o] (M, N) = act(a · b[o] + bias[o]) in fp32 on
// the tensor cores in 128 x tile_n tiles (128 or 64), the three products'
// sums added (hh + hl) + lh before the bias.  a (M, K) row-major and each
// b[o] (K, N) row-major (N-major B: x @ w) are the bf16 halves of fp32
// matrices (the split pass's hi and lo); c[o] (M, N) and bias[o] (N,) fp32,
// a null bias[o] adding nothing; all 16-byte aligned, K and N multiples of
// 8.
template <typename Tiles, int kAct>
cudaError_t launch_split_fwd(const Halves& a, const Halves* b,
                             float* const* c, const float* const* bias,
                             int M, int N, int K, int tile_n,
                             cudaStream_t stream) {
  constexpr int kOuts = Tiles::kOuts;
  if (M <= 0 || N <= 0) return cudaSuccess;
  if (K <= 0 || K % 8 != 0 || N % 8 != 0 || !aligned16(a.hi) ||
      !aligned16(a.lo)) {
    return cudaErrorInvalidValue;
  }
  SplitBiasRows<kAct> epi{};
  for (int o = 0; o < kOuts; ++o) {
    if (!aligned16(b[o].hi) || !aligned16(b[o].lo) || !aligned16(c[o]) ||
        !aligned16(bias[o])) {
      return cudaErrorInvalidValue;
    }
    epi.out[o] = c[o];
    epi.bias[o] = bias[o];
  }
  return with_width<true>(tile_n, [&](auto width) {
    constexpr int BN = decltype(width)::value;
    KernelMaps<Tiles, SplitBiasRows<kAct>> maps{};
    // the hi halves' maps, then the lo halves'
    Maps<kOuts>* const halves[2] = {&maps, &maps.lo};
    for (int h = 0; h < 2; ++h) {
      cudaError_t e = matrix_map(&halves[h]->a, h ? a.lo : a.hi, M, K,
                                 kTileM, kTileK);
      for (int o = 0; o < kOuts && e == cudaSuccess; ++o) {
        e = matrix_map(&halves[h]->b[o], h ? b[o].lo : b[o].hi, K, N,
                       kTileK, 64);
      }
      if (e != cudaSuccess) return e;
    }
    return launch_tiles<BN, true>(maps, epi, Tiles{M, K}, N, stream);
  });
}

// dw[o] (M, N) = aᵀ · b[o] and db[o] (N,) = colsum(b[o]) for each of the
// kOuts outputs, fp32, on the tensor cores in one launch (WgradTiles<kOuts>):
// a (K, M) and each b[o] (K, N) row-major bf16, 16-byte aligned, M and N
// multiples of 8, K > 0 (the batch, any length).  The batch is cut into
// `split` slices of ceil(ceil(K / 64) / split) k-steps, which must leave
// no slice empty (ops/tensor_cores.py wgrad_plan holds that); with more
// than one, slice s of output o writes its dW and db to `workspace` at (o ·
// split + s) · (M·N + N) (kOuts · split · (M·N + N) floats, 16-byte
// aligned) and sum_slices adds them in order, every output in one launch.
// Tiles 128 x tile_n.  kSplit: the 3-pass weight gradient (header, "the
// 3-pass product") of the fp32 matrices whose halves are a / a_lo and b[o]
// / b_lo[o]; no column sums (db ignored), tiles 128 x 128 or 128 x 64.
template <int kOuts, bool kSplit = false>
cudaError_t launch_wgrad_outs(const bf16* a, const bf16* const* b,
                              float* const* dw, float* const* db,
                              float* workspace, int M, int N, int K,
                              int tile_n, int split, cudaStream_t stream,
                              const bf16* a_lo = nullptr,
                              const bf16* const* b_lo = nullptr) {
  if (M <= 0 || N <= 0) return cudaSuccess;
  const int k_total = cdiv(K, kTileK);
  const int steps = split > 0 ? cdiv(k_total, split) : 0;
  if (K <= 0 || M % 8 != 0 || N % 8 != 0 || split < 1 ||
      cdiv(k_total, steps) != split || !aligned16(a) ||
      (split > 1 && (workspace == nullptr || !aligned16(workspace))) ||
      (kSplit && (a_lo == nullptr || !aligned16(a_lo)))) {
    return cudaErrorInvalidValue;
  }
  for (int o = 0; o < kOuts; ++o) {
    if (!aligned16(b[o]) || !aligned16(dw[o]) ||
        (kSplit ? !aligned16(b_lo[o]) : !aligned16(db[o]))) {
      return cudaErrorInvalidValue;
    }
  }
  const size_t mn = size_t(M) * N;
  using Epi = std::conditional_t<kSplit, SplitWgradOut, WgradOut>;
  Epi epi{};
  SliceOut out{};
  for (int o = 0; o < kOuts; ++o) {
    out.dw[o] = dw[o];
    out.db[o] = kSplit ? nullptr : db[o];
    epi.dw[o] = split == 1 ? dw[o] : workspace + o * split * (mn + N);
    epi.db[o] = kSplit ? nullptr : split == 1 ? db[o] : epi.dw[o] + mn;
  }
  epi.stride = split == 1 ? 0 : mn + N;
  const WgradTiles<kOuts> tiles{M, cdiv(M, kTileM), steps, k_total, split};
  const cudaError_t err = with_width<kSplit>(tile_n, [&](auto width) {
    constexpr int BN = decltype(width)::value;
    KernelMaps<WgradTiles<kOuts>, Epi> maps;
    cudaError_t e = matrix_map(&maps.a, a, K, M, kTileK, 64);
    for (int o = 0; o < kOuts && e == cudaSuccess; ++o) {
      e = matrix_map(&maps.b[o], b[o], K, N, kTileK, 64);
    }
    if constexpr (kSplit) {
      if (e == cudaSuccess) e = matrix_map(&maps.lo.a, a_lo, K, M, kTileK, 64);
      for (int o = 0; o < kOuts && e == cudaSuccess; ++o) {
        e = matrix_map(&maps.lo.b[o], b_lo[o], K, N, kTileK, 64);
      }
    }
    if (e != cudaSuccess) return e;
    return launch_tiles<BN, true>(maps, epi, tiles, N, stream);
  });
  if (err != cudaSuccess || split == 1) return err;
  return add_slices(workspace, out, mn, N, split, kOuts, stream);
}

// dw (M, N) = aᵀ · b and db (N,) = colsum(b): launch_wgrad_outs with one
// output (workspace split · (M·N + N) floats).
inline cudaError_t launch_wgrad(const bf16* a, const bf16* b, float* dw,
                                float* db, float* workspace, int M, int N,
                                int K, int tile_n, int split,
                                cudaStream_t stream) {
  return launch_wgrad_outs<1>(a, &b, &dw, &db, workspace, M, N, K, tile_n,
                              split, stream);
}

// dw1 = aᵀ · b1, db1 = colsum(b1), dw2 = aᵀ · b2, db2 = colsum(b2): the two
// weight gradients of one A in one launch (launch_wgrad_outs with two
// outputs; workspace 2 · split · (M·N + N) floats).
inline cudaError_t launch_wgrad2(const bf16* a, const bf16* b1,
                                 const bf16* b2, float* dw1, float* db1,
                                 float* dw2, float* db2, float* workspace,
                                 int M, int N, int K, int tile_n, int split,
                                 cudaStream_t stream) {
  const bf16* const b[2] = {b1, b2};
  float* const dw[2] = {dw1, dw2};
  float* const db[2] = {db1, db2};
  return launch_wgrad_outs<2>(a, b, dw, db, workspace, M, N, K, tile_n,
                              split, stream);
}

// The encoder's heads in one launch (HeadsTiles): mu = epi(h · w21) and
// logvar = epi(h · w22), h (M, K), w21 and w22 (K, N) row-major (N-major B),
// mu and logvar (M, N); the functor sees the joined column (mu's columns,
// then logvar's).
template <typename Epi>
cudaError_t launch_heads(const bf16* h, const bf16* w21, const bf16* w22,
                         bf16* mu, bf16* logvar, const Epi& epi, int M, int N,
                         int K, int tile_n, cudaStream_t stream) {
  const bf16* const b[2] = {w21, w22};
  bf16* const c[2] = {mu, logvar};
  return launch_rows<true, HeadsTiles>(h, b, c, epi, M, N, K, tile_n, stream);
}

// y = epi(the block-Toeplitz product) on the tensor cores (header, "tile
// walk"): x (B, nb, G), w (KB, G, N), y (B, t_out, N), all bf16 and 16-byte
// aligned, G and N multiples of 8, 0 <= shift < KB; the plan (t_half,
// b_half) has t_half · b_half <= 64 and t_half >= t_out where b_half > 1
// (ops/toeplitz.py tile_plan).
// The walk of a Toeplitz launch of B >= 1 batch rows and t_out >= 1
// positions; false where the shapes or the plan are refused (G and N
// multiples of 8, 0 <= shift < KB, t_half · b_half <= 64 and t_half >=
// t_out where b_half > 1).
inline bool toeplitz_walk(ToeplitzTiles& tiles, int B, int nb, int G, int KB,
                          int N, int t_out, int shift, int t_half,
                          int b_half) {
  if (nb <= 0 || G <= 0 || KB <= 0 || G % 8 != 0 || N % 8 != 0 ||
      shift < 0 || shift >= KB || t_half < 1 || b_half < 1 ||
      t_half * b_half > 64 || (b_half > 1 && t_half < t_out)) {
    return false;
  }
  tiles.B = B;
  tiles.t_out = t_out;
  tiles.shift = shift;
  tiles.G = G;
  tiles.t_half = t_half;
  tiles.b_half = b_half;
  tiles.n_t = cdiv(t_out, t_half);
  tiles.halves = tiles.n_t * cdiv(B, b_half);
  tiles.g_steps = cdiv(G, kTileK);
  tiles.steps = KB * tiles.g_steps;
  return true;
}

template <typename Epi>
cudaError_t launch_toeplitz(const bf16* x, const bf16* w, bf16* y,
                            const Epi& epi, int B, int nb, int G, int KB,
                            int N, int t_out, int shift, int t_half,
                            int b_half, int tile_n, cudaStream_t stream) {
  if (B <= 0 || t_out <= 0 || N <= 0) return cudaSuccess;
  ToeplitzTiles tiles;
  if (!toeplitz_walk(tiles, B, nb, G, KB, N, t_out, shift, t_half, b_half) ||
      !aligned16(x) || !aligned16(w) || !aligned16(y)) {
    return cudaErrorInvalidValue;
  }
  return with_width(tile_n, [&](auto width) {
    constexpr int BN = decltype(width)::value;
    Maps<1> maps;
    cudaError_t err = cube_map(&maps.a, x, B, nb, G, t_half, b_half);
    if (err != cudaSuccess) return err;
    err = matrix_map(&maps.b[0], w, KB * G, N, kTileK, 64);
    if (err != cudaSuccess) return err;
    err = cube_map(&maps.c[0], y, B, t_out, N, t_half, b_half);
    if (err != cudaSuccess) return err;
    return launch_tiles<BN, true>(maps, epi, tiles, N, stream);
  });
}

// The 4-pass Toeplitz product (header, "the 4-pass Toeplitz product"): y
// (B, t_out, N) fp32 = act(Σ_j x[b, t + j - shift] @ w[j] + bias) with
// every product taken (hh + ll) + (hl + lh) over the bf16 halves x_h of x
// (B, nb, G) and w_h of w (KB, G, N) (the split pass's hi and lo), the
// act kAct, on the tensor cores in 128 x 64 tiles; bias (N,) and y fp32;
// every pointer 16-byte aligned, the shapes and the plan as
// launch_toeplitz takes them.
template <int kAct>
cudaError_t launch_toeplitz4(const Halves& x_h, const Halves& w_h, float* y,
                             const float* bias, int B, int nb, int G, int KB,
                             int N, int t_out, int shift, int t_half,
                             int b_half, cudaStream_t stream) {
  if (B <= 0 || t_out <= 0 || N <= 0) return cudaSuccess;
  ToeplitzTiles tiles;
  if (!toeplitz_walk(tiles, B, nb, G, KB, N, t_out, shift, t_half, b_half) ||
      !aligned16(x_h.hi) || !aligned16(x_h.lo) || !aligned16(w_h.hi) ||
      !aligned16(w_h.lo) || !aligned16(y) || bias == nullptr ||
      !aligned16(bias)) {
    return cudaErrorInvalidValue;
  }
  using Epi = FourPassRows<kAct>;
  KernelMaps<ToeplitzTiles, Epi> maps{};
  // the hi halves' maps, then the lo halves'
  Maps<1>* const halves[2] = {&maps, &maps.lo};
  for (int h = 0; h < 2; ++h) {
    cudaError_t err = cube_map(&halves[h]->a, h ? x_h.lo : x_h.hi, B, nb, G,
                               t_half, b_half);
    if (err == cudaSuccess) {
      err = matrix_map(&halves[h]->b[0], h ? w_h.lo : w_h.hi, KB * G, N,
                       kTileK, 64);
    }
    if (err != cudaSuccess) return err;
  }
  return launch_tiles<64, true>(maps, Epi{y, bias}, tiles, N, stream);
}

// The linear layer's epilogue, and the Toeplitz product's: bias and
// activation in fp32 on two adjacent columns of a row, one rounding.  The
// bias pair of columns n and n + 1 (n even, the bias 4-byte aligned) is one
// load.  Its mode is the activation (an rvk::Act: none, relu, tanh).
struct BiasActPair {
  using Column = __nv_bfloat162;
  static constexpr int kModes = 3;
  const bf16* bias;
  int act;
  __device__ __forceinline__ int mode() const { return act; }
  __device__ __forceinline__ Column column(int n) const {
    return *reinterpret_cast<const __nv_bfloat162*>(bias + n);
  }
  template <int kAct>
  __device__ __forceinline__ static float finish(float v) {
    if (kAct == kActRelu) return fmaxf(v, 0.f);
    if (kAct == kActTanh) return tanhf(v);
    return v;
  }
  template <int kAct>
  __device__ __forceinline__ __nv_bfloat162 pair(Column b, int, int, float v0,
                                                 float v1) const {
    return __floats2bfloat162_rn(finish<kAct>(v0 + __low2float(b)),
                                 finish<kAct>(v1 + __high2float(b)));
  }
};

// The encoder heads' epilogue (launch_heads): the bias of the head that
// joined column n belongs to (b21 below N, b22 from it) added in fp32, no
// activation, one rounding.  A pair never straddles the heads (N is even).
struct HeadsBias {
  using Column = __nv_bfloat162;
  static constexpr int kModes = 1;
  const bf16* b21;
  const bf16* b22;
  int N;
  __device__ __forceinline__ int mode() const { return 0; }
  __device__ __forceinline__ Column column(int n) const {
    const bf16* b = n < N ? b21 + n : b22 + (n - N);
    return *reinterpret_cast<const __nv_bfloat162*>(b);
  }
  template <int>
  __device__ __forceinline__ __nv_bfloat162 pair(Column b, int, int, float v0,
                                                 float v1) const {
    return __floats2bfloat162_rn(v0 + __low2float(b), v1 + __high2float(b));
  }
};

// Two adjacent columns of a row, rounded once: the epilogue of a product
// that adds nothing (matmul_nt, dz, the fused backward's dx).
struct RoundPair {
  struct Column {};
  static constexpr int kModes = 1;
  __device__ __forceinline__ Column column(int) const { return Column{}; }
  template <int>
  __device__ __forceinline__ __nv_bfloat162 pair(Column, int, int, float v0,
                                                 float v1) const {
    return __floats2bfloat162_rn(v0, v1);
  }
};

// f(std::integral_constant<int, act>) for an rvk::Act of none, relu or
// tanh; anything else is refused.
template <typename F>
cudaError_t with_act(int act, F&& f) {
  switch (act) {
    case kActNone:
      return f(std::integral_constant<int, kActNone>{});
    case kActRelu:
      return f(std::integral_constant<int, kActRelu>{});
    case kActTanh:
      return f(std::integral_constant<int, kActTanh>{});
    default:
      return cudaErrorInvalidValue;
  }
}

// The fused linear backward's walks (header, "the fused linear backward"):
// the plain product and the weight gradient with A formed from y and dy,
// the cotangent's activation kActivation.
template <int kActivation>
struct CotangentRows : MatrixTiles {
  static constexpr bool kFormed = true;
  static constexpr int kAct = kActivation;
};
template <int kActivation>
struct CotangentWgrad : WgradTiles<1> {
  static constexpr bool kFormed = true;
  static constexpr int kAct = kActivation;
};

}  // namespace
}  // namespace tc
}  // namespace rvk
