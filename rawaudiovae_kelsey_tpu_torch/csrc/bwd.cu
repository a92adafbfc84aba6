// Dense-VAE backward kernels, fp32 or bf16 operands, fp32 weight and bias
// gradients, with a plain C interface for ctypes (ops/mlp.py holds the
// wrappers, the plain PyTorch versions and the autograd Functions).
//
// They replace the TPU kernels of rawaudiovae_kelsey_tpu/ops/pallas_mlp.py
// that the training step's backward runs.  Its "primitive" backward (fp32
// operands) is built from
//   rvk_matmul_nt        matmul_nt        a Wᵀ             (dz, dx)
//   rvk_matmul_nt_mask   matmul_nt_mask   (a Wᵀ)·(gate>0)  (dh3)
//   rvk_matmul_nt2_mask  matmul_nt2_mask  (a1 W1ᵀ + a2 W2ᵀ)·(gate>0)  (dh)
// and rvk_grad_accum; its "split" backward (bf16 operands) from
//   rvk_grad_accum     grad_accum     dW = aᵀ b, db = colsum(b)
//   rvk_grad_accum2    grad_accum2    the same for two cotangents sharing a
//   rvk_enc_bwd_dw1    enc_bwd_dw1    dh = (dmu W21ᵀ + dlv W22ᵀ)·(h>0), then
//                                     dW1 = xᵀ dh, db1 = colsum(dh)
//   rvk_dec_bwd_fused  dec_bwd_fused  dh3 = (da W4ᵀ)·(h3>0), then dz = dh3 W3ᵀ,
//                                     dW3 = zᵀ dh3, db3 = colsum(dh3)
// and its "full" backward (the `high` tier's: fp32 operands, every product
// in the 3-pass mode of gemm.cuh; also bf16 operands in one pass) from
//   rvk_enc_bwd_full   enc_bwd_full   dh as above, kept for the chain, then
//                                     dW1, db1, dW21, db21, dW22, db22
//   rvk_dec_bwd_full   dec_bwd_full   dh3 as above, then dz, dW3, db3 and
//                                     dW4 = h3ᵀ da, db4 = colsum(da)
//
// The batch contraction.  The TPU kernels walk the batch as a sequential
// grid and add each batch tile into a VMEM-resident dW.  Here every block of
// a weight-gradient GEMM owns one tile of dW and loops over the whole batch
// itself (gemm.cuh with k = batch); the bias gradient is summed by the first
// row of tiles in the same pass, in batch order.  There is no split over the
// batch, no atomics and no second pass: two runs give identical bits.  At
// the shapes of the step (dW1 1024x2048, dW4 2048x1024, dW21/dW22 2048x256
// each, dW3 256x2048) that is 512, 512, 256 and 128 tiles of 64x64, enough
// to fill the 132 SMs without splitting the batch.
//
// The hidden cotangents.  The TPU kernels keep dh / dh3 (batch x 2048) in
// VMEM between the two products that use them.  A block here holds neither
// a row of W4 (2048 x 1024: 4 MB in bf16) nor W21|W22 beside the dW tiles in
// its 227 KB of shared memory, so each of enc_bwd_dw1 and dec_bwd_fused is
// several launches: the first writes dh / dh3 to a scratch buffer the
// wrapper allocates, the next ones read it back (from the 50 MB L2 for a
// microbatch: 8192 x 2048 bf16 is 32 MB).  dh / dh3 are written in the
// operand dtype, rounded exactly where the TPU kernels round them
// (pallas_mlp.py:535, 686), so dW1 / dW3 contract, and db1 / db3 sum, the
// rounded values, as there.
//
// The full chains.  The TPU kernels enc_bwd_full / dec_bwd_full hold all six
// (five) fp32 gradient accumulators of a chain in VMEM, 16.5 / 19 MB, and
// walk the batch once.  That shape does not exist on an SM.  Here one entry
// point issues the chain's launches of the shared GEMM back to back: dh,
// then dW1 | db1, then both head gradients from one read of h (three
// launches); dh3, dz, dW3 | db3, dW4 | db4 (four).  With fp32 operands in
// the 3-pass mode dh / dh3 stay fp32 in the scratch buffer and are split
// again by the products that read them, and every bias gradient sums the
// unsplit fp32 values (pallas_mlp.py:762-775, 859-872); with bf16 operands
// they are rounded to bf16 as in the split kernels (:777, :874).  Three FMAs
// a product on the CUDA cores make the 3-pass chain about three times the
// 1-pass fp32 one; bf16 mma on the split operands is the later step.
//
// The input-gradient products (matmul_nt and its gated forms) have no
// contraction over the batch: each is one launch of the GEMM with both
// operands read along their contiguous axis (a row of a, a row of W), the
// two-head form as one product over [a1 a2] and [W1ᵀ; W2ᵀ] joined along k.
// The gate compares in fp32 and the output is rounded once, to the operand
// dtype, as the TPU kernels do (pallas_mlp.py:359-360, 393-394).  The fused
// kernels above run the same launches for their dh / dh3 / dz.
//
// What bounds them: a microbatch of 8192 at full width is ~150 GFLOP of
// backward products against ~100 MB of operands — far above the fp32 ridge
// (~20 FLOP/byte), so fp32 FMA throughput on the CUDA cores is the limit.
// Tensor cores (mma.sync / wgmma on the bf16 operands) are the later step.

#include "gemm.cuh"

using rvk::dst;
using rvk::Gemm;
using rvk::kKContig;
using rvk::kRContig;
using rvk::launch_gemm;
using rvk::src;
using rvk::View;
using rvk::view;

namespace {

// dw (n, m) = aᵀ b and db (m,) = colsum(b) [and dw2, db2 from b2], fp32.
// a (batch, n), b / b2 (batch, m).
template <typename T, int kPasses = 1>
cudaError_t grad_accum(const T* a, const T* b, const T* b2, float* dw,
                       float* db, float* dw2, float* db2, int batch, int n,
                       int m, cudaStream_t s) {
  Gemm<T, T, float> g = {};
  g.a = view(a, n, batch);
  g.out[0].b = view(b, m, batch);
  g.out[0].c = dw;
  g.out[0].colsum = db;
  if (b2 != nullptr) {
    g.out[1].b = view(b2, m, batch);
    g.out[1].c = dw2;
    g.out[1].colsum = db2;
  }
  g.M = n, g.N = m, g.K = batch;
  g.act = rvk::kActNone;
  return launch_gemm<kRContig, kRContig, kPasses>(
      g, b2 != nullptr ? 2 : 1, s);
}

// out (batch, m) = a @ wᵀ [+ a2 @ w2ᵀ], zeroed where gate <= 0 [if gate],
// in T.  a, a2 (batch, n); w, w2 (m, n); gate (batch, m).  a2 / w2 and gate
// may be null.
template <typename T, int kPasses = 1>
cudaError_t matmul_nt(const T* a, const T* w, const T* a2, const T* w2,
                      const T* gate, T* out, int batch, int n, int m,
                      cudaStream_t s) {
  Gemm<T, T, T> g = {};
  if (a2 != nullptr) {
    g.a = View<T>{a, a2, n, n, n};
    g.out[0].b = View<T>{w, w2, n, n, n};
  } else {
    g.a = view(a, n, n);
    g.out[0].b = view(w, n, n);
  }
  g.out[0].gate = gate;
  g.out[0].c = out;
  g.M = batch, g.N = m, g.K = a2 != nullptr ? 2 * n : n;
  g.act = gate != nullptr ? rvk::kActGate : rvk::kActNone;
  return launch_gemm<kKContig, kKContig, kPasses>(g, 1, s);
}

// dh (batch, units) = ((dmu @ w21ᵀ + dlv @ w22ᵀ) · (h > 0)) in T; then
// dw1 (seg, units) = xᵀ dh and db1 = colsum(dh).
template <typename T>
cudaError_t enc_bwd_dw1(const T* x, const T* h, const T* dmu, const T* dlv,
                        const T* w21, const T* w22, T* dh, float* dw1,
                        float* db1, int batch, int seg, int units, int latent,
                        cudaStream_t s) {
  cudaError_t err =
      matmul_nt<T>(dmu, w21, dlv, w22, h, dh, batch, latent, units, s);
  if (err != cudaSuccess) return err;
  return grad_accum<T>(x, dh, nullptr, dw1, db1, nullptr, nullptr, batch,
                       seg, units, s);
}

// dh3 (batch, units) = ((da @ w4ᵀ) · (h3 > 0)) in T; dz (batch, latent) =
// dh3 @ w3ᵀ in T; dw3 (latent, units) = zᵀ dh3 and db3 = colsum(dh3).
template <typename T>
cudaError_t dec_bwd_fused(const T* da, const T* h3, const T* z, const T* w4,
                          const T* w3, T* dh3, T* dz, float* dw3, float* db3,
                          int batch, int seg, int units, int latent,
                          cudaStream_t s) {
  cudaError_t err = matmul_nt<T>(da, w4, nullptr, nullptr, h3, dh3, batch,
                                 seg, units, s);
  if (err != cudaSuccess) return err;
  err = matmul_nt<T>(dh3, w3, nullptr, nullptr, nullptr, dz, batch, units,
                     latent, s);
  if (err != cudaSuccess) return err;
  return grad_accum<T>(z, dh3, nullptr, dw3, db3, nullptr, nullptr, batch,
                       latent, units, s);
}

// The encoder's whole parameter backward: dh (batch, units) = ((dmu @ w21ᵀ
// + dlv @ w22ᵀ) · (h > 0)) in T; dw1 (seg, units) = xᵀ dh, db1 = colsum(dh);
// dw21, dw22 (units, latent) = hᵀ dmu, hᵀ dlv with their column sums.
template <typename T, int kPasses>
cudaError_t enc_bwd_full(const T* x, const T* h, const T* dmu, const T* dlv,
                         const T* w21, const T* w22, T* dh, float* dw1,
                         float* db1, float* dw21, float* db21, float* dw22,
                         float* db22, int batch, int seg, int units,
                         int latent, cudaStream_t s) {
  cudaError_t err = matmul_nt<T, kPasses>(dmu, w21, dlv, w22, h, dh, batch,
                                          latent, units, s);
  if (err != cudaSuccess) return err;
  err = grad_accum<T, kPasses>(x, dh, nullptr, dw1, db1, nullptr, nullptr,
                               batch, seg, units, s);
  if (err != cudaSuccess) return err;
  return grad_accum<T, kPasses>(h, dmu, dlv, dw21, db21, dw22, db22, batch,
                                units, latent, s);
}

// The decoder's whole backward: dh3 (batch, units) = ((da @ w4ᵀ) · (h3 > 0))
// in T; dz (batch, latent) = dh3 @ w3ᵀ in T; dw3 (latent, units) = zᵀ dh3,
// db3 = colsum(dh3); dw4 (units, seg) = h3ᵀ da, db4 = colsum(da).
template <typename T, int kPasses>
cudaError_t dec_bwd_full(const T* da, const T* h3, const T* z, const T* w4,
                         const T* w3, T* dh3, T* dz, float* dw3, float* db3,
                         float* dw4, float* db4, int batch, int seg,
                         int units, int latent, cudaStream_t s) {
  cudaError_t err = matmul_nt<T, kPasses>(da, w4, nullptr, nullptr, h3, dh3,
                                          batch, seg, units, s);
  if (err != cudaSuccess) return err;
  err = matmul_nt<T, kPasses>(dh3, w3, nullptr, nullptr, nullptr, dz, batch,
                              units, latent, s);
  if (err != cudaSuccess) return err;
  err = grad_accum<T, kPasses>(z, dh3, nullptr, dw3, db3, nullptr, nullptr,
                               batch, latent, units, s);
  if (err != cudaSuccess) return err;
  return grad_accum<T, kPasses>(h3, da, nullptr, dw4, db4, nullptr, nullptr,
                                batch, units, seg, s);
}

// The pass count of a full chain follows from its operand type: fp32
// operands reach the chains only as the `high` tier and take the 3-pass
// product, bf16 operands take one pass.
template <typename T>
constexpr int kFullPasses = std::is_same<T, float>::value ? 3 : 1;

}  // namespace

extern "C" {

// a (batch, n), w (m, n), out (batch, m), all of one dtype.
int rvk_matmul_nt(const void* a, const void* w, void* out, int batch, int n,
                  int m, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return rvk::with_dtype(dtype, [&](auto tag) {
    using T = std::remove_pointer_t<decltype(tag)>;
    return matmul_nt<T>(src<T>(a), src<T>(w), nullptr, nullptr, nullptr,
                        dst<T>(out), batch, n, m, s);
  });
}

// a (batch, n), w (m, n), gate and out (batch, m), all of one dtype.
int rvk_matmul_nt_mask(const void* a, const void* w, const void* gate,
                       void* out, int batch, int n, int m, int dtype,
                       void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return rvk::with_dtype(dtype, [&](auto tag) {
    using T = std::remove_pointer_t<decltype(tag)>;
    return matmul_nt<T>(src<T>(a), src<T>(w), nullptr, nullptr, src<T>(gate),
                        dst<T>(out), batch, n, m, s);
  });
}

// a1 and a2 (batch, n), w1 and w2 (m, n), gate and out (batch, m), all of
// one dtype.
int rvk_matmul_nt2_mask(const void* a1, const void* w1, const void* a2,
                        const void* w2, const void* gate, void* out,
                        int batch, int n, int m, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return rvk::with_dtype(dtype, [&](auto tag) {
    using T = std::remove_pointer_t<decltype(tag)>;
    return matmul_nt<T>(src<T>(a1), src<T>(w1), src<T>(a2), src<T>(w2),
                        src<T>(gate), dst<T>(out), batch, n, m, s);
  });
}

// a (batch, n), b (batch, m) of one dtype; dw (n, m), db (m,) fp32.
int rvk_grad_accum(const void* a, const void* b, float* dw, float* db,
                   int batch, int n, int m, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return rvk::with_dtype(dtype, [&](auto tag) {
    using T = std::remove_pointer_t<decltype(tag)>;
    return grad_accum<T>(src<T>(a), src<T>(b), nullptr, dw, db, nullptr,
                         nullptr, batch, n, m, s);
  });
}

// a (batch, n), b1 and b2 (batch, m) of one dtype; dw1, dw2 (n, m) and
// db1, db2 (m,) fp32.
int rvk_grad_accum2(const void* a, const void* b1, const void* b2, float* dw1,
                    float* db1, float* dw2, float* db2, int batch, int n,
                    int m, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return rvk::with_dtype(dtype, [&](auto tag) {
    using T = std::remove_pointer_t<decltype(tag)>;
    return grad_accum(src<T>(a), src<T>(b1), src<T>(b2), dw1, db1, dw2, db2,
                      batch, n, m, s);
  });
}

// x (batch, seg), h (batch, units), dmu and dlv (batch, latent), w21 and
// w22 (units, latent), scratch dh (batch, units), all of one dtype; dw1
// (seg, units) and db1 (units,) fp32.
int rvk_enc_bwd_dw1(const void* x, const void* h, const void* dmu,
                    const void* dlv, const void* w21, const void* w22,
                    void* dh, float* dw1, float* db1, int batch, int seg,
                    int units, int latent, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return rvk::with_dtype(dtype, [&](auto tag) {
    using T = std::remove_pointer_t<decltype(tag)>;
    return enc_bwd_dw1(src<T>(x), src<T>(h), src<T>(dmu), src<T>(dlv),
                       src<T>(w21), src<T>(w22), dst<T>(dh), dw1, db1, batch,
                       seg, units, latent, s);
  });
}

// da (batch, seg), h3 (batch, units), z (batch, latent), w4 (units, seg),
// w3 (latent, units), scratch dh3 (batch, units), dz (batch, latent), all
// of one dtype; dw3 (latent, units) and db3 (units,) fp32.
int rvk_dec_bwd_fused(const void* da, const void* h3, const void* z,
                      const void* w4, const void* w3, void* dh3, void* dz,
                      float* dw3, float* db3, int batch, int seg, int units,
                      int latent, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return rvk::with_dtype(dtype, [&](auto tag) {
    using T = std::remove_pointer_t<decltype(tag)>;
    return dec_bwd_fused(src<T>(da), src<T>(h3), src<T>(z), src<T>(w4),
                         src<T>(w3), dst<T>(dh3), dst<T>(dz), dw3, db3, batch,
                         seg, units, latent, s);
  });
}

// x (batch, seg), h (batch, units), dmu and dlv (batch, latent), w21 and
// w22 (units, latent), scratch dh (batch, units), all of one dtype; dw1
// (seg, units), db1 (units,), dw21 and dw22 (units, latent), db21 and db22
// (latent,) fp32.  fp32 operands take the 3-pass product, bf16 one pass.
int rvk_enc_bwd_full(const void* x, const void* h, const void* dmu,
                     const void* dlv, const void* w21, const void* w22,
                     void* dh, float* dw1, float* db1, float* dw21,
                     float* db21, float* dw22, float* db22, int batch,
                     int seg, int units, int latent, int dtype,
                     void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return rvk::with_dtype(dtype, [&](auto tag) {
    using T = std::remove_pointer_t<decltype(tag)>;
    return enc_bwd_full<T, kFullPasses<T>>(
        src<T>(x), src<T>(h), src<T>(dmu), src<T>(dlv), src<T>(w21),
        src<T>(w22), dst<T>(dh), dw1, db1, dw21, db21, dw22, db22, batch,
        seg, units, latent, s);
  });
}

// da (batch, seg), h3 (batch, units), z (batch, latent), w4 (units, seg),
// w3 (latent, units), scratch dh3 (batch, units), dz (batch, latent), all
// of one dtype; dw3 (latent, units), db3 (units,), dw4 (units, seg), db4
// (seg,) fp32.  fp32 operands take the 3-pass product, bf16 one pass.
int rvk_dec_bwd_full(const void* da, const void* h3, const void* z,
                     const void* w4, const void* w3, void* dh3, void* dz,
                     float* dw3, float* db3, float* dw4, float* db4,
                     int batch, int seg, int units, int latent, int dtype,
                     void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return rvk::with_dtype(dtype, [&](auto tag) {
    using T = std::remove_pointer_t<decltype(tag)>;
    return dec_bwd_full<T, kFullPasses<T>>(
        src<T>(da), src<T>(h3), src<T>(z), src<T>(w4), src<T>(w3),
        dst<T>(dh3), dst<T>(dz), dw3, db3, dw4, db4, batch, seg, units,
        latent, s);
  });
}

}  // extern "C"
