// The narrow-channel form of the block-Toeplitz product (toeplitz.cu
// rvk_toeplitz_fwd, kernel code 3): a tap width G or an output width N
// below 8, as in the conv1d VAE's first encoder layer (G = 4, N = 32), its
// last decoder layer (G = 32, N = 4) and that layer's dx (G = 4, N = 32),
// fp32 or bf16.
//
//   y[b, t, :] = act( sum_j x[b, t + j - shift, :] @ w[j] + bias )
//
// For those shapes it replaces the TPU kernel toeplitz_fwd
// (_toeplitz_kernel) of rawaudiovae_kelsey_tpu/ops/pallas_toeplitz.py.
//
// What bounds it.  These products are memory-bound, and a GEMM tile is the
// wrong shape for them: the contraction KB·G is 12 at the first layer, the
// output 4 wide at the last.  At batch 4096 the last decoder layer moves
// 75.5 MB of x and y in bf16 (22.5 us at 3.35 TB/s) for 0.8 GFLOP of its
// own multiply-adds (12 us at the fp32 peak).  So x and y must cross
// device memory once, x must be reused across the N outputs of its row, and
// the loads, the FMAs and the stores must overlap.
//
// Design.
// * Work items: 128 consecutive output positions of one batch row.  A
//   block of kPositions = 128 threads owns NC of the output columns (the
//   grid's y walks N in chunks of NC = 4, 8, 16 or 32: ops/toeplitz.py
//   narrow_chunk) and walks the items from blockIdx.x in steps of the
//   grid's x, which holds as many blocks as the card keeps resident at
//   once.  It stages its columns of the whole tap stack, KB·G·NC values as
//   fp32 (zeros past N), and of the bias once.
// * The window of x an item's positions read, input rows [t0 − shift, t0 +
//   128 + KB − 1 − shift) × G, is one contiguous run of the flat batch
//   row.  It is copied as it lies into one of two shared-memory buffers by
//   16-byte cp.async copies on x's own 16-byte grid (the window then starts
//   d < 16 bytes into the buffer), the next item's while this one's FMAs
//   run.  Copies wholly outside the batch row are zero fills (source size
//   0); in the at most two that straddle its ends, the thread that made the
//   copy zeroes the elements outside once it has landed: the SAME padding
//   and the batch edge.
// * Each thread computes the NC outputs of one position, one fp32
//   accumulator each: for k over its window in ascending order (tap-major,
//   channel-minor) it reads x once (16 or 8 bytes at a time where G
//   allows), converts it to fp32 and uses it for its NC columns, whose taps
//   every lane reads at one address (a broadcast).  Lanes stand on
//   consecutive positions, G elements apart; the buffer's 16-byte chunks
//   are XORed within groups of 8 (swizzle) so that at a row of 64 or 128
//   bytes those reads hit distinct banks.
// * Epilogue: + bias, the activation, one rounding to x's dtype.  A row
//   chunk wider than 16 bytes (NC = 32: the first layer's 128 bytes of
//   fp32) written by its own thread would put each store instruction's 32
//   lanes on 32 lines; so such chunks go through shared memory (a pitch of
//   the chunk + 16 bytes, so that the lanes' 16-byte writes hit distinct
//   banks) and out 16 bytes a lane, neighbouring lanes on neighbouring
//   bytes (one run of y where N = NC).  Narrower chunks are stored by
//   their thread, neighbouring rows side by side.
// * Bits.  Each output is one fmaf chain over k = 0 .. KB·G − 1 from +0,
//   the operands converted to fp32 exactly, then + bias and the activation:
//   the first version's (product.cuh) arithmetic, so the two give equal
//   bits.  passes = 4 (fp32): every value is split into its bf16 hi and lo
//   (split_hi_lo; x's as it is read), four chains take hh, ll, hl and lh,
//   added (hh + ll) + (hl + lh): the first version's 4-pass arithmetic, bit
//   for bit.
// * What it takes: x and y on 16-byte boundaries, nb >= 1, and the two
//   window buffers, the taps and the output rows within kSmemLimit bytes of
//   shared memory (ops/toeplitz.py takes_narrow holds the rule; the wrapper
//   checks).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "gemm.cuh"

namespace rvk {
namespace narrow {
namespace {

constexpr int kPositions = 128;        // output positions an item
constexpr int kSmemLimit = 64 * 1024;  // ops/toeplitz.py NARROW_SMEM_BYTES

// a window buffer's 16-byte chunks: the window, (128 + KB − 1)·G elements
// of `esize` bytes from an offset below one chunk, in whole groups of 8
__host__ __device__ inline int window_chunks(int G, int kb, int esize) {
  const int per = 16 / esize;
  const int chunks = ((kPositions + kb - 1) * G + per - 1) / per + 1;
  return (chunks + 7) / 8 * 8;
}

// the dynamic shared memory of a launch, in bytes: the two window buffers;
// the taps as fp32, twice (hi and lo) for passes = 4; the bias chunk; the
// output rows at a pitch of the chunk + 16 bytes (the rows' staging)
__host__ __device__ inline int smem_bytes(int G, int kb, int chunk,
                                          int passes, int esize) {
  return 2 * window_chunks(G, kb, esize) * 16 +
         ((passes == 4 ? 2 : 1) * kb * G * chunk + chunk) * 4 +
         kPositions * (chunk * esize + 16);
}

// a buffer's 16-byte chunk q → where it lies: XORed with bits 3-5 of
// itself, a permutation within groups of 8 chunks
__device__ __forceinline__ int swizzle(int q) { return q ^ ((q >> 3) & 7); }

// the byte of buffer element s (of kSize bytes)
template <int kSize>
__device__ __forceinline__ int byte_of(int s) {
  constexpr int per = 16 / kSize;
  return swizzle(s / per) * 16 + (s % per) * kSize;
}

// one 16-byte copy into shared memory; a source size of 0 zero-fills it
__device__ __forceinline__ void copy16(void* dst, const void* src,
                                       bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// every group of this thread's but the newest kPending has landed
template <int kPending>
__device__ __forceinline__ void wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// bf16 bits → fp32 (exact): the lower and the upper half of a word
__device__ __forceinline__ float lower(uint32_t u) {
  return __uint_as_float(u << 16);
}
__device__ __forceinline__ float upper(uint32_t u) {
  return __uint_as_float(u & 0xFFFF0000u);
}

// U consecutive elements of a buffer from element s (s a multiple of U; U
// 1, 4, or 8 for bf16), in fp32; the last argument names the element type
template <int U>
__device__ __forceinline__ void read(const char* buf, int s, float* f,
                                     const float*) {
  if constexpr (U == 4) {
    const float4 v = *reinterpret_cast<const float4*>(buf + byte_of<4>(s));
    f[0] = v.x, f[1] = v.y, f[2] = v.z, f[3] = v.w;
  } else {
    f[0] = *reinterpret_cast<const float*>(buf + byte_of<4>(s));
  }
}
template <int U>
__device__ __forceinline__ void read(const char* buf, int s, float* f,
                                     const bf16*) {
  if constexpr (U == 8) {
    const uint4 v = *reinterpret_cast<const uint4*>(buf + byte_of<2>(s));
    const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = lower(u[i]);
      f[2 * i + 1] = upper(u[i]);
    }
  } else if constexpr (U == 4) {
    const uint2 v = *reinterpret_cast<const uint2*>(buf + byte_of<2>(s));
    f[0] = lower(v.x), f[1] = upper(v.x);
    f[2] = lower(v.y), f[3] = upper(v.y);
  } else {
    f[0] = lower(*reinterpret_cast<const uint16_t*>(buf + byte_of<2>(s)));
  }
}

// zero the element at byte p of a buffer
__device__ __forceinline__ void zero(char* p, const float*) {
  *reinterpret_cast<float*>(p) = 0.f;
}
__device__ __forceinline__ void zero(char* p, const bf16*) {
  *reinterpret_cast<uint16_t*>(p) = 0;
}

// one staged tap value: as it is, or its hi at i and lo at i + lo
template <bool kSplit>
__device__ __forceinline__ void stage(float* s, int lo, int i, float v) {
  if constexpr (kSplit) {
    split_hi_lo(v, s[i], s[i + lo]);
  } else {
    s[i] = v;
  }
}

// NC outputs of a row, rounded to the output type, at p: `bytes` a store
// (16 or 8; p on such a boundary)
template <int NC>
__device__ __forceinline__ void store_row(float* p, const float (&v)[NC],
                                          int bytes) {
  if (bytes == 16) {
#pragma unroll
    for (int q = 0; q < NC / 4; ++q) {
      reinterpret_cast<float4*>(p)[q] =
          make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
    }
  } else {
#pragma unroll
    for (int q = 0; q < NC / 2; ++q) {
      reinterpret_cast<float2*>(p)[q] = make_float2(v[2 * q], v[2 * q + 1]);
    }
  }
}
__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(a))) |
         static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(b)))
             << 16;
}
template <int NC>
__device__ __forceinline__ void store_row(bf16* p, const float (&v)[NC],
                                          int bytes) {
  uint32_t u[NC / 2];
#pragma unroll
  for (int i = 0; i < NC / 2; ++i) u[i] = pack_bf16(v[2 * i], v[2 * i + 1]);
  if (bytes == 16) {
#pragma unroll
    for (int q = 0; q < NC / 8; ++q) {
      reinterpret_cast<uint4*>(p)[q] =
          make_uint4(u[4 * q], u[4 * q + 1], u[4 * q + 2], u[4 * q + 3]);
    }
  } else {
#pragma unroll
    for (int q = 0; q < NC / 4; ++q) {
      reinterpret_cast<uint2*>(p)[q] = make_uint2(u[2 * q], u[2 * q + 1]);
    }
  }
}

// Where an item's window lies: window element e is flat element origin + e
// of x and element d + e of its buffer (d below one chunk), whose chunk 0 is
// x's chunk cb; window elements [vs, ve) lie inside the batch row b; the
// item's first position is t0.
struct Window {
  long long origin, cb;
  int d, vs, ve, b, t0;
};

template <int kPer>
__device__ __forceinline__ Window window_of(int item, int tiles, int len,
                                            int G, int kb, int shift) {
  static_assert(kPer == 4 || kPer == 8, "a chunk of 4 or 8 elements");
  constexpr int kLog = kPer == 4 ? 2 : 3;
  Window w;
  w.b = item / tiles;
  w.t0 = (item - w.b * tiles) * kPositions;
  const int fs = (w.t0 - shift) * G;
  const int span = (kPositions + kb - 1) * G;
  w.origin = static_cast<long long>(w.b) * len + fs;
  // floor(origin / kPer): origin is negative only in batch row 0
  w.cb = w.origin >> kLog;
  w.d = static_cast<int>(w.origin - (w.cb << kLog));
  w.vs = max(fs, 0) - fs;
  w.ve = max(min(fs + span, len) - fs, w.vs);
  return w;
}

// x (B, nb, G), w (kb, G, N), bias (N,), y (B, t_out, N), all T; act an
// rvk::Act.  Block (i, chunk): the items i, i + gridDim.x, ... (an item is
// positions [tile · 128, +128) of a batch row), columns [chunk · NC, +NC);
// kRows positions a thread (tid, tid + 128 / kRows, ...).
template <typename T, int NC, int kPasses, int kRows>
__global__ void __launch_bounds__(kPositions / kRows)
narrow_kernel(const T* __restrict__ x, const T* __restrict__ w,
              const T* __restrict__ bias, T* __restrict__ y, int B, int nb,
              int G, int kb, int N, int t_out, int shift, int act) {
  constexpr bool kSplit = kPasses == 4;
  constexpr int kThreads = kPositions / kRows;
  constexpr int kSize = static_cast<int>(sizeof(T));
  constexpr int kPer = 16 / kSize;  // elements a chunk
  constexpr int kRowBytes = NC * kSize;
  constexpr int kPitch = kRowBytes + 16;  // a staged output row, bytes
  const T* const tag = nullptr;           // names T to read() and zero()
  extern __shared__ float4 smem4[];
  const int K = kb * G;
  const int chunks = window_chunks(G, kb, kSize);
  char* const sx = reinterpret_cast<char*>(smem4);  // two window buffers
  float* const sw = reinterpret_cast<float*>(sx + 2 * chunks * 16);
  float* const sb = sw + (kSplit ? 2 : 1) * K * NC;
  char* const so = reinterpret_cast<char*>(sb + NC);
  const int tid = threadIdx.x;
  const int n0 = blockIdx.y * NC;
  const int len = nb * G;
  const int tiles = (t_out + kPositions - 1) / kPositions;
  const int items = B * tiles;  // at most B · t_out: an int (the wrapper)
  const int row_bytes = N * kSize;
  const bool staged = kRowBytes > 16 && n0 + NC <= N && row_bytes % 16 == 0;

  // an item's window into buffer `buf`: chunk q from x's chunk cb + q, a
  // zero fill where none of it lies inside the batch row
  const auto issue = [&](const Window& win, char* buf) {
    for (int q = tid; q < chunks; q += kThreads) {
      // window element of its first value; a copy is made where its values
      // meet the batch row's elements [vs, ve), which may be none
      const int lo = q * kPer - win.d;
      const bool valid = max(lo, win.vs) < min(lo + kPer, win.ve);
      copy16(buf + swizzle(q) * 16, valid ? x + (win.cb + q) * kPer : x,
             valid);
    }
    commit();
  };
  // the copies that straddle the batch row's ends (those holding its first
  // and its last element in the window), landed: the thread that made one
  // zeroes its elements outside the row
  const auto trim = [&](const Window& win, char* buf) {
    if (win.ve <= win.vs) return;
    for (const int e : {win.vs, win.ve - 1}) {
      const int q = (e + win.d) / kPer;
      const int lo = q * kPer - win.d;
      if (q % kThreads != tid || (lo >= win.vs && lo + kPer <= win.ve)) {
        continue;
      }
      for (int j = 0; j < kPer; ++j) {
        if (lo + j < win.vs || lo + j >= win.ve) {
          zero(buf + swizzle(q) * 16 + j * kSize, tag);
        }
      }
    }
  };

  int item = blockIdx.x;
  if (item >= items) return;
  issue(window_of<kPer>(item, tiles, len, G, kb, shift), sx);

  // the block's columns of the tap stack, k-major, zeros past N; the bias
  for (int i = tid; i < K * NC; i += kThreads) {
    const int k = i / NC, n = i - k * NC;
    const float v =
        n0 + n < N ? to_f32(w[static_cast<size_t>(k) * N + n0 + n]) : 0.f;
    stage<kSplit>(sw, K * NC, i, v);
  }
  if (tid < NC) sb[tid] = n0 + tid < N ? to_f32(bias[n0 + tid]) : 0.f;

  for (int parity = 0; item < items; item += gridDim.x, parity ^= 1) {
    char* const buf = sx + parity * chunks * 16;
    // the next item's window into the other buffer, in flight through this
    // one's FMAs (an empty group at the last: the wait counts the same)
    const int next = item + gridDim.x;
    if (next < items) {
      issue(window_of<kPer>(next, tiles, len, G, kb, shift),
            sx + (parity ^ 1) * chunks * 16);
    } else {
      commit();
    }
    // (worked out again here rather than kept through the loop: registers)
    const Window cur = window_of<kPer>(item, tiles, len, G, kb, shift);
    wait<1>();
    trim(cur, buf);
    __syncthreads();

    // this thread's positions: item positions tid + r · kThreads
    const int live = min(kPositions, t_out - cur.t0);
    // acc[r][0]: the product (1 pass) or hi·hi; then lo·lo, hi·lo, lo·hi
    float acc[kRows][kPasses][NC];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
#pragma unroll
      for (int p = 0; p < kPasses; ++p) {
#pragma unroll
        for (int n = 0; n < NC; ++n) acc[r][p][n] = 0.f;
      }
    }
    // x's values at window k, one a position, into the positions' chains:
    // each tap read once for all of them
    const auto step = [&](int k, const float (&xv)[kRows]) {
      float xh[kRows], xl[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        xh[r] = xv[r], xl[r] = 0.f;
        if constexpr (kSplit) split_hi_lo(xv[r], xh[r], xl[r]);
      }
      const float* wr = sw + k * NC;
#pragma unroll
      for (int n = 0; n < NC; n += 4) {
        const float4 wh = *reinterpret_cast<const float4*>(wr + n);
        const float h[4] = {wh.x, wh.y, wh.z, wh.w};
        float l[4] = {};
        if constexpr (kSplit) {
          const float4 wl =
              *reinterpret_cast<const float4*>(wr + K * NC + n);
          l[0] = wl.x, l[1] = wl.y, l[2] = wl.z, l[3] = wl.w;
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            acc[r][0][n + j] = fmaf(xh[r], h[j], acc[r][0][n + j]);
            if constexpr (kSplit) {
              acc[r][1][n + j] = fmaf(xl[r], l[j], acc[r][1][n + j]);
              acc[r][2][n + j] = fmaf(xh[r], l[j], acc[r][2][n + j]);
              acc[r][3][n + j] = fmaf(xl[r], h[j], acc[r][3][n + j]);
            }
          }
        }
      }
    };
    // the positions' windows from buffer element d + position · G, U
    // elements a read (positions past the item's last read its zeros)
    const auto walk = [&](auto unit) {
      constexpr int U = decltype(unit)::value;
      const int s0 = cur.d + tid * G;
      for (int k = 0; k < K; k += U) {
        float f[kRows][U];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          read<U>(buf, s0 + r * kThreads * G + k, f[r], tag);
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          float xv[kRows];
#pragma unroll
          for (int r = 0; r < kRows; ++r) xv[r] = f[r][u];
          step(k + u, xv);
        }
      }
    };
    if (tid >= live) {
      // no position: nothing to sum (the barriers below wait for it)
    } else if (kSize == 2 && G % 8 == 0 && cur.d % 8 == 0) {
      walk(std::integral_constant<int, kSize == 2 ? 8 : 4>{});
    } else if (G % 4 == 0 && cur.d % 4 == 0) {
      walk(std::integral_constant<int, 4>{});
    } else {
      walk(std::integral_constant<int, 1>{});
    }

#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int p = tid + r * kThreads;  // the position in the item
      float out[NC];
#pragma unroll
      for (int n = 0; n < NC; ++n) {
        float v = acc[r][0][n];
        if constexpr (kSplit) {
          v = (v + acc[r][1][n]) + (acc[r][2][n] + acc[r][3][n]);
        }
        v += sb[n];
        if (act == kActRelu) {
          v = fmaxf(v, 0.f);
        } else if (act == kActTanh) {
          v = tanhf(v);
        }
        out[n] = v;
      }
      if (p >= live) continue;
      if (staged) {
        store_row<NC>(reinterpret_cast<T*>(so + p * kPitch), out, 16);
      } else {
        T* yr = y + (static_cast<size_t>(cur.b) * t_out + cur.t0 + p) * N +
                n0;
        // whole stores of 16 bytes where the chunk and the row hold them,
        // else of 8
        const int unit = kRowBytes % 16 == 0 && row_bytes % 16 == 0 ? 16 : 8;
        if (n0 + NC <= N && row_bytes % unit == 0) {
          store_row<NC>(yr, out, unit);
        } else {
#pragma unroll
          for (int n = 0; n < NC; ++n) {
            if (n0 + n < N) store_as(yr + n, out[n]);
          }
        }
      }
    }
    // every read of buf (and of the staged rows' last copy-out) done
    __syncthreads();
    if (staged) {
      // the staged rows out to the item's part of y (rows t0 .. t0 + live
      // - 1, columns n0 .. n0 + NC - 1: one run where N = NC) 16 bytes a
      // lane; the next item's barriers come before its rows are staged
      constexpr int kQuads = kRowBytes / 16;  // 16-byte pieces a row
      char* const yb = reinterpret_cast<char*>(
          y + (static_cast<size_t>(cur.b) * t_out + cur.t0) * N + n0);
      for (int c = tid; c < live * kQuads; c += kThreads) {
        const int r = c / kQuads, q = c - r * kQuads;
        *reinterpret_cast<uint4*>(yb + static_cast<size_t>(r) * row_bytes +
                                  q * 16) =
            *reinterpret_cast<const uint4*>(so + r * kPitch + q * 16);
      }
    }
  }
  wait<0>();
}

// narrow_kernel<T, NC, kPasses, kRows> for x (B, nb, G), w (kb, G, N),
// bias (N,) and y (B, t_out, N) of one dtype T, chunk = NC (4, 8, 16 or
// 32), passes 1, or 4 with fp32 operands, rows = kRows positions a thread
// (1, or 2 with one pass); x and y on 16-byte boundaries, nb >= 1, and
// the launch's shared memory (smem_bytes) within kSmemLimit.  The grid
// holds as many blocks as the card keeps resident, or fewer where there
// are fewer items.  Nothing to compute launches nothing.
template <typename T, int NC, int kPasses, int kRows>
cudaError_t launch_chunk(const T* x, const T* w, const T* bias, T* y, int B,
                         int nb, int G, int kb, int N, int t_out, int shift,
                         int act, cudaStream_t stream) {
  auto kernel = narrow_kernel<T, NC, kPasses, kRows>;
  static uint64_t opted_in = 0;  // the devices done, a bit each
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= 64 || !(opted_in >> device & 1)) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
    if (err != cudaSuccess) return err;
    if (device < 64) opted_in |= uint64_t{1} << device;
  }
  const int smem = smem_bytes(G, kb, NC, kPasses, sizeof(T));
  int sms = 0, resident = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &resident, kernel, kPositions / kRows, smem);
  }
  if (err != cudaSuccess) return err;
  const int chunks = (N + NC - 1) / NC;
  const long long items =
      static_cast<long long>(B) * ((t_out + kPositions - 1) / kPositions);
  const long long blocks = std::max<long long>(
      1, std::min<long long>(items, static_cast<long long>(sms) *
                                        std::max(resident, 1) / chunks));
  kernel<<<dim3(static_cast<unsigned>(blocks), chunks), kPositions / kRows,
           smem, stream>>>(x, w, bias, y, B, nb, G, kb, N, t_out, shift,
                           act);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const T* x, const T* w, const T* bias, T* y, int B,
                   int nb, int G, int kb, int N, int t_out, int shift,
                   int act, int passes, int chunk, int rows,
                   cudaStream_t stream) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  if (nb < 1 || G < 1 || kb < 1 || (rows != 1 && rows != 2) ||
      (rows == 2 && passes != 1) ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) % 16 !=
          0 ||
      act < kActNone || act > kActTanh || (passes != 1 && passes != 4) ||
      (passes == 4 && !kF32) ||
      (chunk != 4 && chunk != 8 && chunk != 16 && chunk != 32) ||
      (N + chunk - 1) / chunk > 65535 ||
      smem_bytes(G, kb, chunk, passes, sizeof(T)) > kSmemLimit) {
    return cudaErrorInvalidValue;
  }
  if (B <= 0 || t_out <= 0 || N <= 0) return cudaSuccess;
  const auto with_passes = [&](auto nc) -> cudaError_t {
    constexpr int NC = decltype(nc)::value;
    if constexpr (kF32) {
      if (passes == 4) {
        return launch_chunk<T, NC, 4, 1>(x, w, bias, y, B, nb, G, kb, N,
                                         t_out, shift, act, stream);
      }
    }
    if (rows == 2) {
      return launch_chunk<T, NC, 1, 2>(x, w, bias, y, B, nb, G, kb, N, t_out,
                                       shift, act, stream);
    }
    return launch_chunk<T, NC, 1, 1>(x, w, bias, y, B, nb, G, kb, N, t_out,
                                     shift, act, stream);
  };
  switch (chunk) {
    case 4:
      return with_passes(std::integral_constant<int, 4>{});
    case 8:
      return with_passes(std::integral_constant<int, 8>{});
    case 16:
      return with_passes(std::integral_constant<int, 16>{});
    default:
      return with_passes(std::integral_constant<int, 32>{});
  }
}

}  // namespace
}  // namespace narrow
}  // namespace rvk
