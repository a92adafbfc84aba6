// Adam in one pass over the parameters, with a plain C interface for ctypes
// (ops/_build.py loads the library; ops/adam.py holds the wrappers, the
// plain PyTorch version and the plan of a tree's launches).
//
//   every element:    m ← c1·g + b1·m          (c1 = 1 − b1)
//                     v ← c2·(g·g) + b2·v      (c2 = 1 − b2)
//                     p ← p + (−lr)·((m / bc1) / (√(v / bc2) + eps))
//
// It replaces the TPU kernel _leaf_update (_adam_kernel) of
// benchmarks/adam_fusion_ab.py: p, g, m and v are read once and p, m and v
// written back in place, 28 bytes an element, where the update written as
// separate tensor operations moves each intermediate through device memory.
//
// Two entry points:
//
//   rvk_adam_tree     the whole parameter tree in ONE launch (up to
//                     kMaxLeaves leaves; a larger tree takes consecutive
//                     launches, planned by ops/adam.py tree_plan).  The
//                     work unit is a tile of kTile elements of the flat
//                     element space over all leaves: the table of leaves
//                     (their p, g, m, v, lengths, 16-byte alignment and the
//                     prefix sums of their tiles) travels by value as a
//                     __grid_constant__ kernel parameter (2.1 KB of the 4
//                     KB), so no table is copied to the device, and a block
//                     finds its leaf by a binary search over the prefix
//                     sums, uniform across the block.  Small leaves (the
//                     biases) share the grid with the large ones instead of
//                     a launch each with a partial wave.  A thread issues
//                     all of its tile's 16-byte loads of p, g, m and v
//                     (kVec float4s each) before it computes, as streaming
//                     loads (__ldcs), and stores the same way (__stcs): the
//                     pass is 1.57 GB on the deep model, far beyond the 50
//                     MB L2, and should not evict what can stay there.  A
//                     leaf whose four pointers are not all 16-byte aligned
//                     takes a scalar path, that leaf alone.  One block a
//                     tile (a persistent grid of the blocks that fit on the
//                     SMs, each walking tiles, was 5-7 % slower on the deep
//                     tree on an H100: PERF.md row 20).
//   rvk_leaf_update   the first version: one launch a leaf, a grid-stride
//                     loop of float4s over it.  Kept so that its time can be
//                     measured in turns with the tree; nothing on the path
//                     launches it unless a caller names it.
//
// The bias corrections bc1 = 1 − b1^count and bc2 = 1 − b2^count are
// computed on the host in fp32 (ops/adam.py bias_corrections, optax's
// order).  The whole-tree update passes them to the tree kernel by value:
// no fill of a device scalar, no host-to-device copy, no synchronisation.
// The tree kernel's other form, two pointers to fp32 scalars in device
// memory (read as the TPU kernel reads them from SMEM), exists for
// ops/adam.py leaf_update alone, whose interface takes the corrections as
// 0-d device tensors; the first version reads them so too.  Either way the
// kernel divides by the same fp32 numbers.
//
// Bit-exactness is the contract: the result equals, bit for bit, the update
// of train/optim.py (Adam.update), whose every product, sum, quotient and
// root is a separate fp32 operation rounded to nearest.  nvcc would contract
// a·b + c into one fused multiply-add, which rounds once where the plain
// version rounds twice, so every operation here is a rounding intrinsic
// (__fmul_rn, __fadd_rn, __fdiv_rn, __fsqrt_rn), in the order of
// _adam_kernel: the division by each correction first — the second moment's
// inside the root — then the root, + eps, the quotient, · (−lr), + p.  The
// hyperparameters arrive by value as the fp32 numbers the plain version
// multiplies by.  Elements are independent, so neither the tiles nor the
// grid change a bit.
//
// The TPU kernel reshapes a leaf to two dimensions and tiles its rows to fit
// VMEM, one pallas_call a leaf; none of that exists here.  A leaf is a flat
// contiguous run of fp32 of any length.
//
// What bounds it: bytes.  The deep model's 55,987,712 parameters are 1.568
// GB a step, 0.468 ms at 3.35 TB/s, against ~14 operations an element.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// the tree kernel: leaves a launch, float4s a thread a tile, and the tile
constexpr int kMaxLeaves = 48;
constexpr int kVec = 4;
constexpr int kTile = kThreads * kVec * 4;   // 4096 elements

struct Hyper {
  float c1, b1, c2, b2, eps, neg_lr;
};

__device__ __forceinline__ void adam_one(float& p, float g, float& m,
                                         float& v, float bc1, float bc2,
                                         const Hyper& h) {
  m = __fadd_rn(__fmul_rn(h.c1, g), __fmul_rn(h.b1, m));
  v = __fadd_rn(__fmul_rn(h.c2, __fmul_rn(g, g)), __fmul_rn(h.b2, v));
  const float u = __fdiv_rn(
      __fdiv_rn(m, bc1), __fadd_rn(__fsqrt_rn(__fdiv_rn(v, bc2)), h.eps));
  p = __fadd_rn(p, __fmul_rn(h.neg_lr, u));
}

// n4 float4s from the front of the leaf (0 when a pointer is unaligned),
// then the elements from 4 * n4 to n one by one.
__global__ void __launch_bounds__(kThreads)
leaf_update_kernel(float* __restrict__ p, const float* __restrict__ g,
                   float* __restrict__ m, float* __restrict__ v,
                   const float* __restrict__ bc1_ptr,
                   const float* __restrict__ bc2_ptr, long long n,
                   long long n4, const Hyper h) {
  const float bc1 = *bc1_ptr, bc2 = *bc2_ptr;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long first =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  float4* p4 = reinterpret_cast<float4*>(p);
  const float4* g4 = reinterpret_cast<const float4*>(g);
  float4* m4 = reinterpret_cast<float4*>(m);
  float4* v4 = reinterpret_cast<float4*>(v);
  for (long long i = first; i < n4; i += stride) {
    float4 pp = p4[i], mm = m4[i], vv = v4[i];
    const float4 gg = g4[i];
    adam_one(pp.x, gg.x, mm.x, vv.x, bc1, bc2, h);
    adam_one(pp.y, gg.y, mm.y, vv.y, bc1, bc2, h);
    adam_one(pp.z, gg.z, mm.z, vv.z, bc1, bc2, h);
    adam_one(pp.w, gg.w, mm.w, vv.w, bc1, bc2, h);
    p4[i] = pp;
    m4[i] = mm;
    v4[i] = vv;
  }
  for (long long i = 4 * n4 + first; i < n; i += stride) {
    float pp = p[i], mm = m[i], vv = v[i];
    adam_one(pp, g[i], mm, vv, bc1, bc2, h);
    p[i] = pp;
    m[i] = mm;
    v[i] = vv;
  }
}

// One launch's leaves.  start[l] is the first tile of leaf l, start[leaves]
// the launch's tile count; bit l of vec is set where p, g, m and v of leaf l
// are all 16-byte aligned.
struct Table {
  float* p[kMaxLeaves];
  const float* g[kMaxLeaves];
  float* m[kMaxLeaves];
  float* v[kMaxLeaves];
  long long n[kMaxLeaves];
  int start[kMaxLeaves + 1];
  unsigned long long vec;
  int leaves;
};
static_assert(kMaxLeaves <= 64, "vec holds a bit a leaf");
static_assert(sizeof(Table) + 64 <= 4096, "the table is a kernel parameter");

// count (≤ kTile) elements from p, g, m, v, all 16-byte aligned: every
// load of the tile issued before any arithmetic, then the stores; the last
// count % 4 elements one a thread
__device__ __forceinline__ void vec_tile(float* __restrict__ p,
                                         const float* __restrict__ g,
                                         float* __restrict__ m,
                                         float* __restrict__ v, int count,
                                         float bc1, float bc2,
                                         const Hyper& h) {
  const int n4 = count / 4;
  float4* p4 = reinterpret_cast<float4*>(p);
  const float4* g4 = reinterpret_cast<const float4*>(g);
  float4* m4 = reinterpret_cast<float4*>(m);
  float4* v4 = reinterpret_cast<float4*>(v);
  float4 pp[kVec], gg[kVec], mm[kVec], vv[kVec];
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    const int i = k * kThreads + threadIdx.x;
    if (i < n4) {
      pp[k] = __ldcs(p4 + i);
      gg[k] = __ldcs(g4 + i);
      mm[k] = __ldcs(m4 + i);
      vv[k] = __ldcs(v4 + i);
    }
  }
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    const int i = k * kThreads + threadIdx.x;
    if (i < n4) {
      adam_one(pp[k].x, gg[k].x, mm[k].x, vv[k].x, bc1, bc2, h);
      adam_one(pp[k].y, gg[k].y, mm[k].y, vv[k].y, bc1, bc2, h);
      adam_one(pp[k].z, gg[k].z, mm[k].z, vv[k].z, bc1, bc2, h);
      adam_one(pp[k].w, gg[k].w, mm[k].w, vv[k].w, bc1, bc2, h);
      __stcs(p4 + i, pp[k]);
      __stcs(m4 + i, mm[k]);
      __stcs(v4 + i, vv[k]);
    }
  }
  const int i = 4 * n4 + threadIdx.x;
  if (i < count) {
    float ps = p[i], ms = m[i], vs = v[i];
    adam_one(ps, g[i], ms, vs, bc1, bc2, h);
    p[i] = ps;
    m[i] = ms;
    v[i] = vs;
  }
}

// the same count elements one by one (a leaf with an unaligned pointer)
__device__ __forceinline__ void scalar_tile(float* __restrict__ p,
                                            const float* __restrict__ g,
                                            float* __restrict__ m,
                                            float* __restrict__ v, int count,
                                            float bc1, float bc2,
                                            const Hyper& h) {
  for (int i = threadIdx.x; i < count; i += kThreads) {
    float ps = p[i], ms = m[i], vs = v[i];
    adam_one(ps, g[i], ms, vs, bc1, bc2, h);
    p[i] = ps;
    m[i] = ms;
    v[i] = vs;
  }
}

// one block a tile: block b takes tile b
__global__ void __launch_bounds__(kThreads)
adam_tree_kernel(const __grid_constant__ Table t,
                 const float* __restrict__ bc1_ptr,
                 const float* __restrict__ bc2_ptr, float bc1, float bc2,
                 const Hyper h) {
  if (bc1_ptr != nullptr) {
    bc1 = *bc1_ptr;
    bc2 = *bc2_ptr;
  }
  const int tile = blockIdx.x;
  // the last leaf that starts at or before the tile (an empty leaf starts
  // where the next one does, and is passed over)
  int lo = 0, hi = t.leaves - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (t.start[mid] <= tile) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  const long long first = static_cast<long long>(tile - t.start[lo]) * kTile;
  const long long left = t.n[lo] - first;
  const int count = static_cast<int>(left < kTile ? left : kTile);
  if ((t.vec >> lo) & 1ull) {
    vec_tile(t.p[lo] + first, t.g[lo] + first, t.m[lo] + first,
             t.v[lo] + first, count, bc1, bc2, h);
  } else {
    scalar_tile(t.p[lo] + first, t.g[lo] + first, t.m[lo] + first,
                t.v[lo] + first, count, bc1, bc2, h);
  }
}

bool aligned16(const void* q) {
  return reinterpret_cast<uintptr_t>(q) % 16 == 0;
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0, k = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&k, cudaDevAttrMultiProcessorCount, dev);
    sms = k > 0 ? k : 1;
  }
  return sms;
}

}  // namespace

extern "C" {

// p, g, m, v: n contiguous fp32 each (p, m and v are updated in place); bc1
// and bc2: one fp32 each, in device memory.  c1 = 1 − b1 and c2 = 1 − b2,
// b1, b2, eps and neg_lr = −lr as the fp32 values the plain update uses.
int rvk_leaf_update(float* p, const float* g, float* m, float* v,
                    const float* bc1, const float* bc2, long long n, float c1,
                    float b1, float c2, float b2, float eps, float neg_lr,
                    void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < 0) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const bool vec = aligned16(p) && aligned16(g) && aligned16(m) && aligned16(v);
  const long long n4 = vec ? n / 4 : 0;
  const long long work = n4 > 0 ? n4 : n;
  const long long want = (work + kThreads - 1) / kThreads;
  const long long cap = static_cast<long long>(sm_count()) * 16;
  const unsigned blocks = static_cast<unsigned>(want < cap ? want : cap);
  leaf_update_kernel<<<blocks, kThreads, 0, s>>>(
      p, g, m, v, bc1, bc2, n, n4, Hyper{c1, b1, c2, b2, eps, neg_lr});
  return cudaGetLastError();
}

// One launch of the tree kernel over `leaves` (≤ kMaxLeaves) leaves: p, g,
// m, v the leaves' device pointers (p, m and v are updated in place), n
// their lengths, start the leaves' first tiles of kTile elements and the
// launch's tile count last (leaves + 1 entries, ops/adam.py tree_plan),
// vec 1 where the leaf's four pointers are all 16-byte aligned.  The
// arrays are host memory, read here into the kernel's parameter; one block
// a tile.  bc1_ptr / bc2_ptr: the corrections as fp32 scalars in device
// memory (leaf_update), or both null and bc1 / bc2 by value; the other
// floats as rvk_leaf_update's.
int rvk_adam_tree(void* const* p, void* const* g, void* const* m,
                  void* const* v, const long long* n, const int* start,
                  const int* vec, int leaves,
                  const float* bc1_ptr, const float* bc2_ptr, float bc1,
                  float bc2, float c1, float b1, float c2, float b2,
                  float eps, float neg_lr, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (leaves < 0 || leaves > kMaxLeaves) return cudaErrorInvalidValue;
  if ((bc1_ptr == nullptr) != (bc2_ptr == nullptr)) {
    return cudaErrorInvalidValue;
  }
  if (leaves == 0) return cudaSuccess;
  if (start[0] != 0) return cudaErrorInvalidValue;
  Table t{};
  for (int l = 0; l < leaves; ++l) {
    // a leaf's tiles: ceil(n / kTile), none for an empty leaf
    if (n[l] < 0 || start[l + 1] - start[l] != (n[l] + kTile - 1) / kTile) {
      return cudaErrorInvalidValue;
    }
    t.p[l] = static_cast<float*>(p[l]);
    t.g[l] = static_cast<const float*>(g[l]);
    t.m[l] = static_cast<float*>(m[l]);
    t.v[l] = static_cast<float*>(v[l]);
    t.n[l] = n[l];
    t.start[l] = start[l];
    if (vec[l]) t.vec |= 1ull << l;
  }
  t.start[leaves] = start[leaves];
  t.leaves = leaves;
  const int tiles = start[leaves];
  if (tiles == 0) return cudaSuccess;
  adam_tree_kernel<<<static_cast<unsigned>(tiles), kThreads, 0, s>>>(
      t, bc1_ptr, bc2_ptr, bc1, bc2, Hyper{c1, b1, c2, b2, eps, neg_lr});
  return cudaGetLastError();
}

}  // extern "C"
