// One Adam step of one parameter leaf in one pass, with a plain C interface
// for ctypes (ops/_build.py loads the library; ops/adam.py holds the
// wrapper, the plain PyTorch version and the whole-tree update).
//
//   rvk_leaf_update   m ← c1·g + b1·m          (c1 = 1 − b1)
//                     v ← c2·(g·g) + b2·v      (c2 = 1 − b2)
//                     p ← p + (−lr)·((m / bc1) / (√(v / bc2) + eps))
//
// It replaces the TPU kernel _leaf_update (_adam_kernel) of
// benchmarks/adam_fusion_ab.py: p, g, m and v are read once and p, m and v
// written back in place, 28 bytes an element, where the update written as
// separate tensor operations moves each intermediate through device memory.
// The two bias corrections bc1 = 1 − b1^count and bc2 = 1 − b2^count are
// read from two fp32 scalars in device memory, as the TPU kernel reads them
// from SMEM: the caller fills them on the device and never copies a host
// scalar inside the step.
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
// multiplies by.
//
// The TPU kernel reshapes a leaf to two dimensions and tiles its rows to fit
// VMEM; none of that exists here.  A leaf is a flat contiguous run of fp32
// of any length: a grid-stride loop of 16-byte loads and stores over the
// whole float4s when all four pointers are 16-byte aligned, and a scalar
// loop over what is left (everything, when they are not).  Elements are
// independent, so the grid's size changes no bit.
//
// What bounds it: bytes.  The deep model's 55,987,712 parameters are 1.568
// GB a step, 0.468 ms at 3.35 TB/s, against ~20 operations an element.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

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

}  // extern "C"
