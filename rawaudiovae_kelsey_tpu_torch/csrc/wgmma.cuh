// bf16 tensor-core mainloop for Hopper (sm_90a): the device routine of the
// bf16 forms of rvk_linear_ksplit_fwd (linear.cu) and rvk_matmul_nt (bwd.cu).
//
//   C[m, n] = epi( sum_k A[m, k] * B[k, n] )
//
// A is (M, K) row-major bf16.  B is bf16 in one of two layouts, a
// compile-time choice: K-major, a (N, K) row-major matrix read by its rows
// (a @ wᵀ: matmul_nt), or N-major, a (K, N) row-major matrix (x @ w: the
// linear layer), which wgmma transposes as it reads (tnspB = 1): no
// copy is made of either.  The sum is kept in fp32 registers and handed to
// the epilogue functor two adjacent columns at a time: epi.column(n) reads
// what the functor needs for columns n and n + 1 (the bias pair; an
// Epi::Column of 4 bytes, fetched for the whole tile while the last products
// are still in flight), and epi.pair<kMode>(column, m, n, v0, v1) does the
// rest in fp32 (bias, activation, a gate later) and returns the pair rounded
// once to bf16, which the mainloop stores to C (M, N) row-major.  kMode is
// epi.mode() in [0, Epi::kModes), turned into a template argument outside
// the epilogue's unrolled loop: a functor that chooses its activation at run
// time would otherwise put every activation's code into each of the 64
// unrolled steps.
//
// Which TPU kernels run on it: linear_ksplit_fwd (_linear_ksplit_kernel) of
// rawaudiovae_kelsey_tpu/ops/pallas_linear.py and matmul_nt of
// rawaudiovae_kelsey_tpu/ops/pallas_mlp.py.  The TPU kernels carry one fp32
// accumulator across the k slices, which their grid visits in order; here a
// block owns an output tile and walks the whole of K itself, in order, in
// one fp32 accumulator: no split over blocks, no workspace, no atomics, so
// two launches give equal bits.
//
// What bounds it.  The deep model's layers at batch 4096 do 2·4096·k·n
// operations on (4096·k + k·n + 4096·n)·2 bytes: 1365 operations a byte at
// 4096 x 4096 -> 4096, far above the card's 295, so the tensor cores are the
// limit and the design is about keeping them fed.  matmul_nt at its dz
// shape (256 columns out) is below the ridge: there the point is to read a
// once, from as many SMs as there are tiles.
//
// Design.
// * Operands stay bf16.  TMA (cp.async.bulk.tensor.2d) copies a 128 x 64
//   tile of A and a BN x 64 tile of B into shared memory in the 128-byte
//   swizzled layout that wgmma reads; what lies outside the matrix arrives
//   as zeros, so ragged M, N and K need no masks in the loop, and the TMA
//   store of the epilogue clips what lies outside C.
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
// * Epilogue.  Stores of 4 bytes a thread straight from the accumulator
//   layout, with the bias fetched and the activation chosen inside the
//   unrolled loop, made the first epilogue 8 % of the kernel at 4096 x 4096
//   -> 4096 on an H100 (0.2055 ms against 0.1886 ms with this one).  So
//   each consumer warpgroup
//   rounds its 64 x BN half into a staging buffer in shared memory, in the
//   128-byte swizzled layout (its threads then hit 32 distinct banks), and
//   one thread hands it to TMA as 64 x 64 boxes; the store drains while the
//   warpgroup is already in the next tile's products, and is waited for
//   only before the staging buffer is written again.
// * Tiles.  128 x 256 where that gives every SM a tile, else 128 x 128 (the
//   narrow layers and matmul_nt's dz).  One persistent block an SM walks the
//   tiles, eight tile rows to a group so that the blocks running together
//   share operands in L2, and the ring runs on across tiles: the producer
//   loads the next tile while the consumers store this one.  Stages: three
//   of 48 KB at 128 x 256 (a fourth does not fit), five of 32 KB at 128 x
//   128 (fewer cost time there; a sixth gained only at 4096 x 4096 -> 4096,
//   a shape the rule never gives 128 x 128 tiles), beside 64 / 32 KB of
//   staging, inside the 227 KB a block may take.
// * What the other products of bwd.cu will need fits this shape: a gate is
//   an epilogue functor (it sees m, n and both sums before the rounding),
//   and an A joined from two matrices along k is a second pair of tensor
//   maps that the producer switches to at the split; the consumers never
//   see where a stage came from.
// * A barrier that never completes traps after ~2 s instead of hanging the
//   card: the launch then fails with an error the wrapper raises.  The trap
//   ends the process's CUDA context, and a run slowed many times over (a
//   debugger, compute-sanitizer, a card shared with another process) can
//   reach the bound with no fault: build such a run with
//   -DRVK_NO_HANG_TRAP.
#pragma once

#include <cuda.h>

#include "gemm.cuh"

namespace rvk {
namespace tc {
namespace {

// the `kernel` code of the C entry points (ops/tensor_cores.py KERNEL_CODES)
enum Kernel : int {
  kCudaCores = 0,    // the first-version kernels: not handled here
  kTensorCores = 1,  // this mainloop, the tile width chosen by shape
};

constexpr int kTileM = 128;  // two consumer warpgroups of 64 rows
constexpr int kTileK = 64;   // 128 bytes of bf16: one swizzle row
constexpr int kStages128 = 5, kStages256 = 3;
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

// d (64 x BN, fp32, this warpgroup's) += A (64 x 16, K-major) · B (16 x BN);
// kBT: B is N-major in shared memory.
template <int BN, bool kBT>
__device__ __forceinline__ void wgmma_k16(float* d, uint64_t da, uint64_t db);

template <>
__device__ __forceinline__ void wgmma_k16<128, false>(float* d, uint64_t da,
                                                      uint64_t db) {
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
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : RVK_D64(d, 0)
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_k16<128, true>(float* d, uint64_t da,
                                                     uint64_t db) {
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
      "%64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      : RVK_D64(d, 0)
      : "l"(da), "l"(db), "r"(1));
}

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

template <>
__device__ __forceinline__ void wgmma_k16<256, false>(float* d, uint64_t da,
                                                      uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{" RVK_REGS_128 "}, %128, %129, p, 1, 1, 0, 0;\n"
      "}\n"
      : RVK_D64(d, 0), RVK_D64(d, 64)
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_k16<256, true>(float* d, uint64_t da,
                                                     uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{" RVK_REGS_128 "}, %128, %129, p, 1, 1, 0, 1;\n"
      "}\n"
      : RVK_D64(d, 0), RVK_D64(d, 64)
      : "l"(da), "l"(db), "r"(1));
}

#undef RVK_REGS_128
#undef RVK_D64
#undef RVK_D8

// The four k16 products of one 64-deep stage, for the warpgroup whose 64
// rows of A start at `a_tile`; `b_tile` is the stage's B.
template <int BN, bool kBT>
__device__ __forceinline__ void stage_product(float* acc, uint32_t a_tile,
                                              uint32_t b_tile) {
  const uint64_t da = make_desc(a_tile, 16, 1024);
  const uint64_t db = kBT ? make_desc(b_tile, kChunkBytes, 1024)
                          : make_desc(b_tile, 16, 1024);
#pragma unroll
  for (int kk = 0; kk < kTileK / 16; ++kk) {
    // the start address moves (in 16-byte units): 32 bytes along a K-major
    // row, sixteen 128-byte k-rows down an N-major chunk
    wgmma_k16<BN, kBT>(acc, da + 2 * kk, db + (kBT ? 128 : 2) * kk);
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

// A warpgroup's accumulators → its staging buffer (64 rows x BN columns as
// BN / 64 chunks of 64 rows x 128 bytes, 128-byte swizzle: the layout a TMA
// store of 64 x 64 boxes reads).  Outside C the functor is not called
// (its bias or gate has nothing there) and zeros are staged; the store
// clips them.
template <int BN, int kMode, typename Epi>
__device__ __forceinline__ void stage_tile(
    float* acc, const Epi& epi, const typename Epi::Column* columns,
    uint32_t staging, int m0, int n0, int M, int N) {
  fence_accumulators<BN>(acc);
  const int t = threadIdx.x % 128;
  const int r = 16 * (t / 32) + (t % 32) / 4;  // and r + 8: the same r % 8
  const int col = 2 * (t % 4);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int n = n0 + col + 8 * j;
    __nv_bfloat162 lo = __floats2bfloat162_rn(0.f, 0.f), hi = lo;
    if (n < N) {
      if (m0 + r < M) {
        lo = epi.template pair<kMode>(columns[j], m0 + r, n, acc[4 * j],
                                      acc[4 * j + 1]);
      }
      if (m0 + r + 8 < M) {
        hi = epi.template pair<kMode>(columns[j], m0 + r + 8, n,
                                      acc[4 * j + 2], acc[4 * j + 3]);
      }
    }
    const uint32_t at = staging + (j / 8) * kChunkBytes + r * 128 +
                        (((j % 8) ^ (r % 8)) << 4) + 2 * col;
    asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(at),
                 "r"(*reinterpret_cast<uint32_t*>(&lo))
                 : "memory");
    asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(at + 8 * 128),
                 "r"(*reinterpret_cast<uint32_t*>(&hi))
                 : "memory");
  }
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

// ------------------------------------------------------------ the mainloop

template <int BN, int kStages, bool kBT, typename Epi>
__global__ void __launch_bounds__(kBlock, 1)
wgmma_gemm_kernel(const __grid_constant__ CUtensorMap map_a,
                  const __grid_constant__ CUtensorMap map_b,
                  const __grid_constant__ CUtensorMap map_c, const Epi epi,
                  int M, int N, int K) {
  static_assert(BN == 128 || BN == 256, "the tile is 128 or 256 wide");
  // a stage is released one step late (one wgmma group stays in flight)
  static_assert(kStages >= 2, "a ring of one stage would deadlock");
  constexpr uint32_t kBTileBytes = BN * kTileK * 2;
  constexpr uint32_t kStageBytes = kATileBytes + kBTileBytes;
  extern __shared__ uint8_t smem_raw[];
  // the swizzle atoms are 1024 bytes: align the ring to that
  const uint32_t ring = (smem_u32(smem_raw) + 1023u) & ~1023u;
  // after the ring, a 64 x BN staging buffer for each consumer warpgroup
  constexpr uint32_t kStagingBytes = 64 * BN * 2;
  const uint32_t staging = ring + kStages * kStageBytes;
  const uint32_t full = staging + 2 * kStagingBytes;
  const uint32_t empty = full + 8 * kStages;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  const int tiles_m = (M + kTileM - 1) / kTileM;
  const int tiles_n = (N + BN - 1) / BN;
  const int n_tiles = tiles_m * tiles_n;
  const int n_kb = (K + kTileK - 1) / kTileK;

  if (warp >= kConsumerWarps) {
    // ----- the producer's warpgroup: one lane keeps the loads in flight
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (warp == kConsumerWarps && lane == 0) {
      int s = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        int tm, tn;
        tile_origin(tile, tiles_m, tiles_n, tm, tn);
        const int m0 = tm * kTileM, n0 = tn * BN;
        for (int kb = 0; kb < n_kb; ++kb) {
          // a fresh barrier passes a wait on the parity before its first
          mbar_wait(empty + 8 * s, phase ^ 1);
          const uint32_t bar = full + 8 * s;
          const uint32_t a_tile = ring + s * kStageBytes;
          const uint32_t b_tile = a_tile + kATileBytes;
          mbar_expect_tx(bar, kStageBytes);
          tma_load(a_tile, &map_a, bar, kb * kTileK, m0);
          if constexpr (kBT) {
#pragma unroll
            for (int c = 0; c < BN / 64; ++c) {
              tma_load(b_tile + c * kChunkBytes, &map_b, bar, n0 + 64 * c,
                       kb * kTileK);
            }
          } else {
            tma_load(b_tile, &map_b, bar, kb * kTileK, n0);
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
    int s = 0, prev = 0;
    uint32_t phase = 0;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      int tm, tn;
      tile_origin(tile, tiles_m, tiles_n, tm, tn);
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
      for (int kb = 0; kb < n_kb; ++kb) {
        mbar_wait(full + 8 * s, phase);
        const uint32_t a_tile = ring + s * kStageBytes;
        wgmma_fence();
        stage_product<BN, kBT>(acc, a_tile + wg * (kATileBytes / 2),
                               a_tile + kATileBytes);
        wgmma_commit();
        // the stage before this one is read once its group has retired
        wgmma_wait<1>();
        if (kb > 0 && lane == 0) mbar_arrive(empty + 8 * prev);
        prev = s;
        if (++s == kStages) {
          s = 0;
          phase ^= 1;
        }
      }
      // what the epilogue reads per column pair, fetched while the last
      // products are in flight
      const int n0 = tn * BN;
      typename Epi::Column columns[BN / 8] = {};
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int n = n0 + 2 * (lane % 4) + 8 * j;
        if (n < N) columns[j] = epi.column(n);
      }
      wgmma_wait<0>();
      if (lane == 0) mbar_arrive(empty + 8 * prev);
      // the staging buffer is free once the last tile's store has read it
      if (leader) tma_store_wait_read();
      named_barrier(1 + wg, 128);
      const int m0 = tm * kTileM + 64 * wg;
      with_mode(epi, [&](auto mode) {
        stage_tile<BN, decltype(mode)::value>(acc, epi, columns, staged, m0,
                                              n0, M, N);
      });
      // generic-proxy stores, read next by the async proxy
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      named_barrier(1 + wg, 128);
      if (leader && m0 < M) {
#pragma unroll
        for (int c = 0; c < BN / 64; ++c) {
          if (n0 + 64 * c < N) {
            tma_store(&map_c, staged + c * kChunkBytes, n0 + 64 * c, m0);
          }
        }
        tma_store_commit();
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

// The tensor map of a row-major (outer, inner) bf16 matrix cut into boxes
// of box_outer x box_inner (box_inner = 64: 128 bytes), 128-byte swizzle,
// zeros outside.  The base and the row pitch must be multiples of 16 bytes.
inline cudaError_t matrix_map(CUtensorMap* map, const bf16* p, int outer,
                              int inner, int box_outer, int box_inner) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner),
                              static_cast<cuuint64_t>(outer)};
  const cuuint64_t pitch[1] = {static_cast<cuuint64_t>(inner) * sizeof(bf16)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_inner),
                             static_cast<cuuint32_t>(box_outer)};
  const cuuint32_t step[2] = {1, 1};
  const CUresult rc = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
      const_cast<void*>(static_cast<const void*>(p)), dims, pitch, box, step,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int BN, int kStages, bool kBT, typename Epi>
cudaError_t launch_ring(const bf16* a, const bf16* b, bf16* c, const Epi& epi,
                        int M, int N, int K, cudaStream_t stream) {
  CUtensorMap map_a, map_b, map_c;
  cudaError_t err = matrix_map(&map_a, a, M, K, kTileM, kTileK);
  if (err != cudaSuccess) return err;
  err = kBT ? matrix_map(&map_b, b, K, N, kTileK, 64)
            : matrix_map(&map_b, b, N, K, BN, kTileK);
  if (err != cudaSuccess) return err;
  err = matrix_map(&map_c, c, M, N, 64, 64);
  if (err != cudaSuccess) return err;
  auto kernel = wgmma_gemm_kernel<BN, kStages, kBT, Epi>;
  // the ring, the two staging buffers, the slack to align them to 1024
  // bytes, the barriers
  const int smem = kStages * (kATileBytes + BN * kTileK * 2) +
                   kTileM * BN * 2 + 1024 + 16 * kStages;
  // above the 48 KB a block gets without opting in: once a device
  static uint64_t opted_in = 0;
  int device = 0;
  cudaGetDevice(&device);
  if (device >= 64 || !(opted_in >> device & 1)) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    if (device < 64) opted_in |= uint64_t{1} << device;
  }
  const int tiles = cdiv(M, kTileM) * cdiv(N, BN);
  const int blocks = tiles < sm_count() ? tiles : sm_count();
  kernel<<<blocks, kBlock, smem, stream>>>(map_a, map_b, map_c, epi, M, N,
                                           K);
  return cudaGetLastError();
}

// C = epi(A · B) on the tensor cores.  a (M, K) row-major; b (N, K)
// row-major, or (K, N) row-major with kBT; c (M, N) row-major; all bf16 and
// 16-byte aligned, K and N multiples of 8 (the caller's dispatch holds
// that).
// 128 x 256 tiles where that gives every SM one, else 128 x 128.
template <bool kBT, typename Epi>
cudaError_t launch_wgmma(const bf16* a, const bf16* b, bf16* c,
                         const Epi& epi, int M, int N, int K,
                         cudaStream_t stream) {
  if (M <= 0 || N <= 0) return cudaSuccess;
  if (K <= 0 || K % 8 != 0 || N % 8 != 0 ||
      reinterpret_cast<uintptr_t>(a) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(b) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(c) % 16 != 0) {
    return cudaErrorInvalidValue;
  }
  if (cdiv(M, kTileM) * cdiv(N, 256) >= sm_count()) {
    return launch_ring<256, kStages256, kBT>(a, b, c, epi, M, N, K, stream);
  }
  return launch_ring<128, kStages128, kBT>(a, b, c, epi, M, N, K, stream);
}

}  // namespace
}  // namespace tc
}  // namespace rvk
