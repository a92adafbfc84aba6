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
// in three bf16 passes; also, with the switch BWD_FUSION forced, bf16
// operands and fp32 ones in one pass) from
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
// point issues the chain's launches back to back, in one of three forms
// (the kernel code).  With fp32 operands on the tensor cores (code 1,
// full.cu enc_bwd_split / dec_bwd_split): the split pass (split.cuh) makes
// every operand's bf16 halves once, with the bias gradients' fp32 column
// sums of the unsplit values (pallas_mlp.py:762-775, 859-872), and each
// product is one launch of wgmma.cuh's 3-pass mode (three accumulators, (hh
// + hl) + lh); dh / dh3 stay fp32 and are split in turn.  With bf16
// operands on the tensor cores (code 1): the launches of the split
// backward, which computes the same function (pallas_mlp.py:776-787,
// 873-883): tensor_core_enc_bwd_dw1 then both head gradients in one
// launch_wgrad2; tensor_core_dec_bwd then dW4 | db4 on launch_wgrad; dh /
// dh3 rounded to bf16 (:777, :874).  The first version (code 0, every other
// shape): the tiled GEMM of gemm.cuh, dh, then dW1 | db1, then both head
// gradients from one read of h (three launches); dh3, dz, dW3 | db3, dW4 |
// db4 (four); fp32 operands in its 3-pass mode (three FMAs a product on the
// CUDA cores), bf16 in one pass.
//
// The backward-fusion switch.  The JAX package picks the backward mode by
// BWD_FUSION (pallas_mlp.py:993-1011; ops/mlp.py fusion): under "auto"
// the bf16 step "split", the `float32` / `highest` steps "primitive" and
// the `high` step "full", and a forced mode any of the three for every
// tier.  So every kernel above runs in each dtype and pass count the tiers
// give: the primitive and split kernels also in three passes (the "3"
// entry points below; full.cu's parts of the chains on the tensor cores,
// gemm.cuh's 3-pass mode as their first version), and the full chains in
// one fp32 pass under `float32` / `highest` (kernel code 2: sgemm.cuh's
// launches of the split kernels, sgemm_enc_bwd_full / sgemm_dec_bwd_full
// below; the first version at one pass for other widths).
//
// The `high` tier's input gradient (rvk_matmul_nt2_mask3 then
// rvk_matmul_nt3: dh, then dx = dh W1ᵀ; fp32 operands, every product in
// three bf16 passes, as the TPU kernels matmul_nt2_mask and matmul_nt run
// under JAX's ambient `high` tier, pallas_mlp.py:1038-1041): with n and m
// multiples of 8 and 16-byte aligned pointers the chains of full.cu on the
// tensor cores (the split pass, then one 3-pass launch, dh's two products
// joined along k and gated in fp32); everything else the first version in
// gemm.cuh's 3-pass operand mode.  dh stays fp32.
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
// Tensor cores are the later step for all but the entry points
// rvk_matmul_nt, whose bf16 form runs on wgmma.cuh (both operands K-major: a
// block owns a 128-row tile of the output, streams its rows of a once
// through a TMA ring and rounds once from the fp32 accumulators) and whose
// fp32 form runs on the register-tiled mainloop of sgemm.cuh (both operands
// K-major, staged by cp.async and stored k-major in shared memory); its
// gated forms rvk_matmul_nt_mask and rvk_matmul_nt2_mask, whose bf16 forms
// are the launches of dh3 and dh below (the gate in the epilogue; dh's two
// products joined along k) and whose fp32 forms are sgemm.cuh's gated
// product (rvk::sgemm::launch_gated: the gate read where the output goes;
// [a1 a2] and [w1 w2] joined along k as the slabs are copied);
// rvk_dec_bwd_fused, whose bf16 form runs all three of its products on
// wgmma.cuh (tensor_core_dec_bwd below: the gate in dh3's epilogue, the
// weight gradient over slices of the batch); rvk_grad_accum, whose bf16
// form is that weight gradient alone (rvk::tc::launch_wgrad) and whose fp32
// form is sgemm.cuh's (rvk::sgemm::launch_wgrad: aᵀ read M-major as it
// lies, the batch cut into slices added in order, the column sums from the
// staged b); rvk_grad_accum2, whose bf16 form is both heads' weight
// gradients in one launch of that weight gradient (rvk::tc::launch_wgrad2:
// h read once for dW21 and dW22); and rvk_enc_bwd_dw1, whose bf16 form is
// dh as one k-joined product with the gate in its epilogue, then that
// weight gradient (tensor_core_enc_bwd_dw1 below).  The fp32 forms of
// rvk_enc_bwd_dw1, rvk_grad_accum2 and rvk_dec_bwd_fused are sgemm.cuh's
// launches of the entry points above, one after another (sgemm_enc_bwd_dw1,
// sgemm_grad_accum2, sgemm_dec_bwd below): the `float32` and `highest`
// steps run them with BWD_FUSION forced to "split", and the full chains'
// fp32 one-pass form runs them in turn; each computes what those launches
// compute one by one.  At the step's microbatch the bf16 weight gradients are far
// above the ridge (dW1 and dW4: 34 GFLOP on 58 MB of operands and output,
// ~590 FLOP a byte), so the tensor cores bound them.  The template matmul_nt<T> below stays on
// gemm.cuh: the first versions of the entry points above (kernel code 0,
// and every shape their new forms do not take) and the full chains' first
// versions launch it.

#include "gemm.cuh"
#include "sgemm.cuh"
#include "wgmma.cuh"

using rvk::dst;
using rvk::Gemm;
using rvk::kKContig;
using rvk::kRContig;
using rvk::launch_gemm;
using rvk::src;
using rvk::tc::RoundPair;
using rvk::View;
using rvk::view;

namespace rvk {
// the fp32 full chains on the tensor cores (full.cu)
cudaError_t enc_bwd_split(const float* x, const float* h, const float* dmu,
                          const float* dlv, const float* w21,
                          const float* w22, float* dh, float* dw1,
                          float* db1, float* dw21, float* db21, float* dw22,
                          float* db22, void* splits, float* workspace,
                          int batch, int seg, int units, int latent,
                          int tile_dh, int tile_dw1, int split_dw1,
                          int tile_dw2, int split_dw2, cudaStream_t s);
cudaError_t dec_bwd_split(const float* da, const float* h3, const float* z,
                          const float* w4, const float* w3, float* dh3,
                          float* dz, float* dw3, float* db3, float* dw4,
                          float* db4, void* splits, float* workspace,
                          int batch, int seg, int units, int latent,
                          int tile_dh3, int tile_dz, int tile_dw3,
                          int split_dw3, int tile_dw4, int split_dw4,
                          cudaStream_t s);
// their parts, the other 3-pass forms of the `high` backward (full.cu)
cudaError_t enc_bwd_dw1_split(const float* x, const float* h,
                              const float* dmu, const float* dlv,
                              const float* w21, const float* w22, float* dh,
                              float* dw1, float* db1, void* splits,
                              float* workspace, int batch, int seg, int units,
                              int latent, int tile_dh, int tile_dw,
                              int split_dw, cudaStream_t s);
cudaError_t dec_bwd_fused_split(const float* da, const float* h3,
                                const float* z, const float* w4,
                                const float* w3, float* dh3, float* dz,
                                float* dw3, float* db3, void* splits,
                                float* workspace, int batch, int seg,
                                int units, int latent, int tile_dh3,
                                int tile_dz, int tile_dw, int split_dw,
                                cudaStream_t s);
template <int kOuts>
cudaError_t grad_accum_split(const float* a, const float* const* b,
                             float* const* dw, float* const* db, void* splits,
                             float* workspace, int batch, int n, int m,
                             int tile_dw, int slices, cudaStream_t s);
// the `high` tier's input-gradient products on the tensor cores (full.cu)
cudaError_t matmul_nt_split(const float* a1, const float* w1,
                            const float* a2, const float* w2,
                            const float* gate, float* out, void* splits,
                            int batch, int n, int m, int tile_n,
                            cudaStream_t s);
}  // namespace rvk

namespace {

// dw (n, m) = aᵀ b and db (m,) = colsum(b) [and dw2, db2 from b2], fp32.
// a (batch, n), b / b2 (batch, m).  The second output is there when dw2
// is: an empty batch's b2 may come as a null pointer, and its gradients
// are zeros all the same.
template <typename T, int kPasses = 1>
cudaError_t grad_accum(const T* a, const T* b, const T* b2, float* dw,
                       float* db, float* dw2, float* db2, int batch, int n,
                       int m, cudaStream_t s) {
  Gemm<T, T, float> g = {};
  g.a = view(a, n, batch);
  g.out[0].b = view(b, m, batch);
  g.out[0].c = dw;
  g.out[0].colsum = db;
  if (dw2 != nullptr) {
    g.out[1].b = view(b2, m, batch);
    g.out[1].c = dw2;
    g.out[1].colsum = db2;
  }
  g.M = n, g.N = m, g.K = batch;
  g.act = rvk::kActNone;
  return launch_gemm<kRContig, kRContig, kPasses>(
      g, dw2 != nullptr ? 2 : 1, s);
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
template <typename T, int kPasses = 1>
cudaError_t enc_bwd_dw1(const T* x, const T* h, const T* dmu, const T* dlv,
                        const T* w21, const T* w22, T* dh, float* dw1,
                        float* db1, int batch, int seg, int units, int latent,
                        cudaStream_t s) {
  cudaError_t err = matmul_nt<T, kPasses>(dmu, w21, dlv, w22, h, dh, batch,
                                          latent, units, s);
  if (err != cudaSuccess) return err;
  return grad_accum<T, kPasses>(x, dh, nullptr, dw1, db1, nullptr, nullptr,
                                batch, seg, units, s);
}

// dh3 (batch, units) = ((da @ w4ᵀ) · (h3 > 0)) in T; dz (batch, latent) =
// dh3 @ w3ᵀ in T; dw3 (latent, units) = zᵀ dh3 and db3 = colsum(dh3).
template <typename T, int kPasses = 1>
cudaError_t dec_bwd_fused(const T* da, const T* h3, const T* z, const T* w4,
                          const T* w3, T* dh3, T* dz, float* dw3, float* db3,
                          int batch, int seg, int units, int latent,
                          cudaStream_t s) {
  cudaError_t err = matmul_nt<T, kPasses>(da, w4, nullptr, nullptr, h3, dh3,
                                          batch, seg, units, s);
  if (err != cudaSuccess) return err;
  err = matmul_nt<T, kPasses>(dh3, w3, nullptr, nullptr, nullptr, dz, batch,
                              units, latent, s);
  if (err != cudaSuccess) return err;
  return grad_accum<T, kPasses>(z, dh3, nullptr, dw3, db3, nullptr, nullptr,
                                batch, latent, units, s);
}

// The encoder's whole parameter backward: enc_bwd_dw1, then dw21, dw22
// (units, latent) = hᵀ dmu, hᵀ dlv with their column sums, one launch.
template <typename T, int kPasses>
cudaError_t enc_bwd_full(const T* x, const T* h, const T* dmu, const T* dlv,
                         const T* w21, const T* w22, T* dh, float* dw1,
                         float* db1, float* dw21, float* db21, float* dw22,
                         float* db22, int batch, int seg, int units,
                         int latent, cudaStream_t s) {
  const cudaError_t err = enc_bwd_dw1<T, kPasses>(
      x, h, dmu, dlv, w21, w22, dh, dw1, db1, batch, seg, units, latent, s);
  if (err != cudaSuccess) return err;
  return grad_accum<T, kPasses>(h, dmu, dlv, dw21, db21, dw22, db22, batch,
                                units, latent, s);
}

// The decoder's whole backward: dec_bwd_fused, then dw4 (units, seg) = h3ᵀ
// da, db4 = colsum(da).
template <typename T, int kPasses>
cudaError_t dec_bwd_full(const T* da, const T* h3, const T* z, const T* w4,
                         const T* w3, T* dh3, T* dz, float* dw3, float* db3,
                         float* dw4, float* db4, int batch, int seg,
                         int units, int latent, cudaStream_t s) {
  const cudaError_t err = dec_bwd_fused<T, kPasses>(
      da, h3, z, w4, w3, dh3, dz, dw3, db3, batch, seg, units, latent, s);
  if (err != cudaSuccess) return err;
  return grad_accum<T, kPasses>(h3, da, nullptr, dw4, db4, nullptr, nullptr,
                                batch, units, seg, s);
}

// A first version at `passes` passes, 1 or 3 (fp32 only): f(pass count
// tag), any other count refused.
template <typename T, typename F>
cudaError_t with_passes(int passes, F&& f) {
  if (passes == 1) return f(std::integral_constant<int, 1>{});
  if constexpr (std::is_same<T, float>::value) {
    if (passes == 3) return f(std::integral_constant<int, 3>{});
  }
  return cudaErrorInvalidValue;
}

// dh3's epilogue on the tensor cores: where(gate > 0, sum, 0), the gate
// (h3's pair at the same place, which the mainloop has TMA load into the
// staging buffer) compared in fp32 and the pair rounded once
// (pallas_mlp.py:670-672, 686).
struct GatePair {
  struct Column {};
  static constexpr int kModes = 1;
  static constexpr bool kGate = true;
  __device__ __forceinline__ Column column(int) const { return Column{}; }
  template <int>
  __device__ __forceinline__ __nv_bfloat162 gated(uint32_t gate, float v0,
                                                  float v1) const {
    const __nv_bfloat162 g = *reinterpret_cast<const __nv_bfloat162*>(&gate);
    return __floats2bfloat162_rn(__low2float(g) > 0.f ? v0 : 0.f,
                                 __high2float(g) > 0.f ? v1 : 0.f);
  }
};

// The tensor-core form of dec_bwd_fused, bf16 only, three launches in
// stream order (each reads what the one before wrote):
// * dh3 = (da @ w4ᵀ)·(h3 > 0), both operands K-major (row 4's launch) with
//   the gate in the epilogue, rounded to bf16 into the scratch dh3, in tiles
//   128 x tile_dh3;
// * dz = dh3 @ w3ᵀ, row 4's launch as it is, tiles 128 x tile_dz;
// * dw3 = zᵀ dh3 and db3 = colsum(dh3) from the rounded dh3
//   (rvk::tc::launch_wgrad: z read M-major, dh3 N-major, the batch cut into
//   `split` slices added in order through `workspace`), tiles 128 x tile_dw.
// db3 is summed by the dw3 launch from the dh3 stages it has in shared
// memory (the tiles of dW3's first tile row, in k order): it costs no read
// of dh3's 32 MB beyond the one the product makes, and the ragged batch's
// rows are TMA's zeros there.  A separate column reduction in batch order
// would read dh3 again.
int tensor_core_dec_bwd(const void* da, const void* h3, const void* z,
                        const void* w4, const void* w3, void* dh3, void* dz,
                        float* dw3, float* db3, float* workspace, int batch,
                        int seg, int units, int latent, int dtype,
                        int tile_dh3, int tile_dz, int tile_dw, int split,
                        cudaStream_t s) {
  if (dtype != rvk::kBF16 || batch <= 0) return cudaErrorInvalidValue;
  using T = rvk::bf16;
  cudaError_t err = rvk::tc::launch_wgmma<false>(
      src<T>(da), src<T>(w4), dst<T>(dh3), GatePair{}, batch, units, seg,
      tile_dh3, s, src<T>(h3));
  if (err != cudaSuccess) return err;
  err = rvk::tc::launch_wgmma<false>(src<T>(dh3), src<T>(w3), dst<T>(dz),
                                     RoundPair{}, batch, latent, units,
                                     tile_dz, s);
  if (err != cudaSuccess) return err;
  return rvk::tc::launch_wgrad(src<T>(z), src<T>(dh3), dw3, db3, workspace,
                               latent, units, batch, tile_dw, split, s);
}

// The tensor-core form of enc_bwd_dw1, bf16 only, two launches in stream
// order (three with the slices' sum):
// * dh = (dmu @ w21ᵀ + dlv @ w22ᵀ)·(h > 0): one k-joined product
//   (rvk::tc::launch_joined: the first ceil(latent / 64) k-steps read dmu
//   and w21, the next as many dlv and w22, all K-major, into one fp32
//   accumulator) with dh3's gated epilogue, rounded to bf16 into the
//   scratch dh (pallas_mlp.py:535), in tiles 128 x tile_dh;
// * dw1 = xᵀ dh and db1 = colsum(dh) from the rounded dh, as dW3 and db3
//   are (launch_wgrad: x read M-major, dh N-major, `split` slices of the
//   batch added in order through `workspace`), tiles 128 x tile_dw.
// The TPU kernel keeps dh in VMEM between its two products; here it goes
// through the scratch buffer, 32 MB written and read back at the step's
// microbatch.
int tensor_core_enc_bwd_dw1(const void* x, const void* h, const void* dmu,
                            const void* dlv, const void* w21, const void* w22,
                            void* dh, float* dw1, float* db1,
                            float* workspace, int batch, int seg, int units,
                            int latent, int dtype, int tile_dh, int tile_dw,
                            int split, cudaStream_t s) {
  if (dtype != rvk::kBF16 || batch <= 0) return cudaErrorInvalidValue;
  using T = rvk::bf16;
  const cudaError_t err = rvk::tc::launch_joined(
      src<T>(dmu), src<T>(w21), src<T>(dlv), src<T>(w22), dst<T>(dh),
      GatePair{}, batch, units, latent, tile_dh, s, src<T>(h));
  if (err != cudaSuccess) return err;
  return rvk::tc::launch_wgrad(src<T>(x), src<T>(dh), dw1, db1, workspace,
                               seg, units, batch, tile_dw, split, s);
}

// The fp32 form of enc_bwd_dw1 on sgemm.cuh, two launches in stream order
// (three with the slices' sum): dh = (dmu @ w21ᵀ + dlv @ w22ᵀ)·(h > 0) as
// rvk_matmul_nt2_mask's fp32 launch (launch_gated<true>: the pairs joined
// along k as the slabs are copied) on tile kTiles[tile_dh] into the scratch
// dh; then dw1 = xᵀ dh and db1 = colsum(dh) as rvk_grad_accum's
// (launch_wgrad) on kTiles[tile_dw] over `split` slices of the batch.
int sgemm_enc_bwd_dw1(const void* x, const void* h, const void* dmu,
                      const void* dlv, const void* w21, const void* w22,
                      void* dh, float* dw1, float* db1, float* workspace,
                      int batch, int seg, int units, int latent, int dtype,
                      int tile_dh, int tile_dw, int split, cudaStream_t s) {
  if (dtype != rvk::kF32 || batch <= 0) return cudaErrorInvalidValue;
  const cudaError_t err = rvk::sgemm::launch_gated<true>(
      src<float>(dmu), src<float>(w21), src<float>(dlv), src<float>(w22),
      src<float>(h), dst<float>(dh), batch, units, latent, tile_dh, s);
  if (err != cudaSuccess) return err;
  return rvk::sgemm::launch_wgrad(src<float>(x), dst<float>(dh), dw1, db1,
                                  workspace, seg, units, batch, tile_dw,
                                  split, s);
}

// The fp32 form of grad_accum2 on sgemm.cuh: rvk_grad_accum's fp32 launch
// (launch_wgrad) twice, dw1 and db1 from b1, then dw2 and db2 from b2, each
// on kTiles[tile_dw] over `split` slices of the batch through `workspace`
// (the second reuses the first's: stream order).
int sgemm_grad_accum2(const void* a, const void* b1, const void* b2,
                      float* dw1, float* db1, float* dw2, float* db2,
                      float* workspace, int batch, int n, int m, int dtype,
                      int tile_dw, int split, cudaStream_t s) {
  if (dtype != rvk::kF32 || batch <= 0) return cudaErrorInvalidValue;
  const cudaError_t err =
      rvk::sgemm::launch_wgrad(src<float>(a), src<float>(b1), dw1, db1,
                               workspace, n, m, batch, tile_dw, split, s);
  if (err != cudaSuccess) return err;
  return rvk::sgemm::launch_wgrad(src<float>(a), src<float>(b2), dw2, db2,
                                  workspace, n, m, batch, tile_dw, split, s);
}

// The fp32 form of dec_bwd_fused on sgemm.cuh, three launches in stream
// order (four with the slices' sum): dh3 = (da @ w4ᵀ)·(h3 > 0) as
// rvk_matmul_nt_mask's fp32 launch (launch_gated<false>) on
// kTiles[tile_dh3] into the scratch dh3; dz = dh3 @ w3ᵀ as rvk_matmul_nt's
// (sgemm::launch) on kTiles[tile_dz]; dw3 = zᵀ dh3 and db3 = colsum(dh3)
// as rvk_grad_accum's (launch_wgrad) on kTiles[tile_dw] over `split`
// slices of the batch.
int sgemm_dec_bwd(const void* da, const void* h3, const void* z,
                  const void* w4, const void* w3, void* dh3, void* dz,
                  float* dw3, float* db3, float* workspace, int batch,
                  int seg, int units, int latent, int dtype, int tile_dh3,
                  int tile_dz, int tile_dw, int split, cudaStream_t s) {
  if (dtype != rvk::kF32 || batch <= 0) return cudaErrorInvalidValue;
  cudaError_t err = rvk::sgemm::launch_gated<false>(
      src<float>(da), src<float>(w4), nullptr, nullptr, src<float>(h3),
      dst<float>(dh3), batch, units, seg, tile_dh3, s);
  if (err != cudaSuccess) return err;
  err = rvk::sgemm::launch<true, rvk::kActNone>(
      dst<float>(dh3), src<float>(w3), nullptr, dst<float>(dz), batch, latent,
      units, tile_dz, s);
  if (err != cudaSuccess) return err;
  return rvk::sgemm::launch_wgrad(src<float>(z), dst<float>(dh3), dw3, db3,
                                  workspace, latent, units, batch, tile_dw,
                                  split, s);
}

// The fp32 full chains in one IEEE pass on sgemm.cuh (rows 11 and 12 under
// the `float32` and `highest` tiers with BWD_FUSION = "full"): the encoder
// sgemm_enc_bwd_dw1, then sgemm_grad_accum2 for dW21 | db21 and dW22 |
// db22; the decoder sgemm_dec_bwd, then dW4 | db4 on rvk_grad_accum's
// fp32 launch.  One workspace serves every weight gradient in turn.
int sgemm_enc_bwd_full(const void* x, const void* h, const void* dmu,
                       const void* dlv, const void* w21, const void* w22,
                       void* dh, float* dw1, float* db1, float* dw21,
                       float* db21, float* dw22, float* db22,
                       float* workspace, int batch, int seg, int units,
                       int latent, int dtype, int tile_dh, int tile_dw1,
                       int split_dw1, int tile_dw2, int split_dw2,
                       cudaStream_t s) {
  const int err = sgemm_enc_bwd_dw1(x, h, dmu, dlv, w21, w22, dh, dw1, db1,
                                    workspace, batch, seg, units, latent,
                                    dtype, tile_dh, tile_dw1, split_dw1, s);
  if (err != cudaSuccess) return err;
  return sgemm_grad_accum2(h, dmu, dlv, dw21, db21, dw22, db22, workspace,
                           batch, units, latent, dtype, tile_dw2, split_dw2,
                           s);
}

int sgemm_dec_bwd_full(const void* da, const void* h3, const void* z,
                       const void* w4, const void* w3, void* dh3, void* dz,
                       float* dw3, float* db3, float* dw4, float* db4,
                       float* workspace, int batch, int seg, int units,
                       int latent, int dtype, int tile_dh3, int tile_dz,
                       int tile_dw3, int split_dw3, int tile_dw4,
                       int split_dw4, cudaStream_t s) {
  const int err = sgemm_dec_bwd(da, h3, z, w4, w3, dh3, dz, dw3, db3,
                                workspace, batch, seg, units, latent, dtype,
                                tile_dh3, tile_dz, tile_dw3, split_dw3, s);
  if (err != cudaSuccess) return err;
  return rvk::sgemm::launch_wgrad(src<float>(h3), src<float>(da), dw4, db4,
                                  workspace, units, seg, batch, tile_dw4,
                                  split_dw4, s);
}

}  // namespace

extern "C" {

// a (batch, n), w (m, n), out (batch, m), all of one dtype.  kernel (an
// rvk::tc::Kernel): 0, the tiled GEMM on the CUDA cores; 1, the
// tensor-core form, bf16 only, in tiles 128 x tile_n (256, 128 or 64; the
// caller's choice, ops/tensor_cores.py tile_n); 2, the fp32 mainloop of
// sgemm.cuh, fp32 only, n and m multiples of 4, 16-byte aligned pointers,
// on the tile sgemm::kTiles[tile_n] (ops/tensor_cores.py sgemm_tile).  The
// first version ignores tile_n.
int rvk_matmul_nt(const void* a, const void* w, void* out, int batch, int n,
                  int m, int dtype, int tile_n, int kernel, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kernel == rvk::tc::kSgemm) {
    if (dtype != rvk::kF32) return cudaErrorInvalidValue;
    return rvk::sgemm::launch<true, rvk::kActNone>(
        src<float>(a), src<float>(w), nullptr, dst<float>(out), batch, m, n,
        tile_n, s);
  }
  if (kernel != rvk::tc::kCudaCores) {
    if (kernel != rvk::tc::kTensorCores || dtype != rvk::kBF16) {
      return cudaErrorInvalidValue;
    }
    using T = rvk::bf16;
    return rvk::tc::launch_wgmma<false>(src<T>(a), src<T>(w), dst<T>(out),
                                        RoundPair{}, batch, m, n, tile_n, s);
  }
  return rvk::with_dtype(dtype, [&](auto tag) {
    using T = std::remove_pointer_t<decltype(tag)>;
    return matmul_nt<T>(src<T>(a), src<T>(w), nullptr, nullptr, nullptr,
                        dst<T>(out), batch, n, m, s);
  });
}

// a (batch, n), w (m, n), gate and out (batch, m), all of one dtype: out
// = where(gate > 0, a @ wᵀ, 0).  kernel (an rvk::tc::Kernel): 0, the tiled
// GEMM on the CUDA cores with the gate in its epilogue; 1, bf16 only, the
// tensor-core product of rvk_matmul_nt with dh3's gated epilogue (GatePair:
// the gate's boxes TMA-loaded into the staging buffer), in tiles 128 x
// tile_n (ops/tensor_cores.py tile_n); 2, fp32 only, sgemm.cuh's gated
// product (rvk::sgemm::launch_gated: the gate's 16-byte chunk read where
// the output's goes), n and m multiples of 4, 16-byte aligned pointers, on
// the tile sgemm::kTiles[tile_n] (ops/tensor_cores.py sgemm_tile).  The
// first version ignores tile_n.
int rvk_matmul_nt_mask(const void* a, const void* w, const void* gate,
                       void* out, int batch, int n, int m, int dtype,
                       int tile_n, int kernel, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kernel == rvk::tc::kSgemm) {
    if (dtype != rvk::kF32) return cudaErrorInvalidValue;
    return rvk::sgemm::launch_gated<false>(
        src<float>(a), src<float>(w), nullptr, nullptr, src<float>(gate),
        dst<float>(out), batch, m, n, tile_n, s);
  }
  if (kernel != rvk::tc::kCudaCores) {
    if (kernel != rvk::tc::kTensorCores || dtype != rvk::kBF16) {
      return cudaErrorInvalidValue;
    }
    using T = rvk::bf16;
    return rvk::tc::launch_wgmma<false>(src<T>(a), src<T>(w), dst<T>(out),
                                        GatePair{}, batch, m, n, tile_n, s,
                                        src<T>(gate));
  }
  return rvk::with_dtype(dtype, [&](auto tag) {
    using T = std::remove_pointer_t<decltype(tag)>;
    return matmul_nt<T>(src<T>(a), src<T>(w), nullptr, nullptr, src<T>(gate),
                        dst<T>(out), batch, n, m, s);
  });
}

// a1 and a2 (batch, n), w1 and w2 (m, n), gate and out (batch, m), all of
// one dtype: out = where(gate > 0, a1 @ w1ᵀ + a2 @ w2ᵀ, 0), one product
// over [a1 a2] and [w1 w2] joined along k (the first pair's k, then the
// second's, into one fp32 accumulator).  kernel: 0, the tiled GEMM on the
// CUDA cores; 1, bf16 only, enc_bwd_dw1's dh launch (rvk::tc::launch_joined
// with GatePair), in tiles 128 x tile_n; 2, fp32 only, sgemm.cuh's gated
// product with both operands joined (rvk::sgemm::launch_gated), n and m
// multiples of 4, 16-byte aligned pointers, on the tile
// sgemm::kTiles[tile_n].  The first version ignores tile_n.
int rvk_matmul_nt2_mask(const void* a1, const void* w1, const void* a2,
                        const void* w2, const void* gate, void* out,
                        int batch, int n, int m, int dtype, int tile_n,
                        int kernel, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kernel == rvk::tc::kSgemm) {
    if (dtype != rvk::kF32) return cudaErrorInvalidValue;
    return rvk::sgemm::launch_gated<true>(
        src<float>(a1), src<float>(w1), src<float>(a2), src<float>(w2),
        src<float>(gate), dst<float>(out), batch, m, n, tile_n, s);
  }
  if (kernel != rvk::tc::kCudaCores) {
    if (kernel != rvk::tc::kTensorCores || dtype != rvk::kBF16) {
      return cudaErrorInvalidValue;
    }
    using T = rvk::bf16;
    return rvk::tc::launch_joined(src<T>(a1), src<T>(w1), src<T>(a2),
                                  src<T>(w2), dst<T>(out), GatePair{}, batch,
                                  m, n, tile_n, s, src<T>(gate));
  }
  return rvk::with_dtype(dtype, [&](auto tag) {
    using T = std::remove_pointer_t<decltype(tag)>;
    return matmul_nt<T>(src<T>(a1), src<T>(w1), src<T>(a2), src<T>(w2),
                        src<T>(gate), dst<T>(out), batch, n, m, s);
  });
}

// The `high` tier's matmul_nt (above, "the `high` tier's input
// gradient"): a (batch, n), w (m, n), out (batch, m) = a @ wᵀ, all fp32,
// in three bf16 passes.  kernel: 0, the first version (gemm.cuh's 3-pass
// mode; tile_n and splits ignored); 1, the tensor cores, n and m multiples
// of 8, 16-byte aligned pointers, batch > 0 (full.cu matmul_nt_split:
// `splits` the bf16 halves of a and w, 2 · their elements; tiles 128 x
// tile_n, 128 or 64, ops/tensor_cores.py split_tile).
int rvk_matmul_nt3(const void* a, const void* w, void* out, void* splits,
                   int batch, int n, int m, int tile_n, int kernel,
                   void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kernel == rvk::tc::kTensorCores) {
    return rvk::matmul_nt_split(src<float>(a), src<float>(w), nullptr,
                                nullptr, nullptr, dst<float>(out), splits,
                                batch, n, m, tile_n, s);
  }
  if (kernel != rvk::tc::kCudaCores) return cudaErrorInvalidValue;
  return matmul_nt<float, 3>(src<float>(a), src<float>(w), nullptr, nullptr,
                             nullptr, dst<float>(out), batch, n, m, s);
}

// The `high` tier's matmul_nt2_mask: a1, a2 (batch, n), w1, w2 (m, n),
// gate and out (batch, m), all fp32: out = where(gate > 0, a1 @ w1ᵀ + a2 @
// w2ᵀ, 0) in three bf16 passes, the two products joined along k.  kernel
// and tile_n as for rvk_matmul_nt3 (`splits` the halves of a1, w1, a2 and
// w2).
int rvk_matmul_nt2_mask3(const void* a1, const void* w1, const void* a2,
                         const void* w2, const void* gate, void* out,
                         void* splits, int batch, int n, int m, int tile_n,
                         int kernel, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kernel == rvk::tc::kTensorCores) {
    return rvk::matmul_nt_split(src<float>(a1), src<float>(w1),
                                src<float>(a2), src<float>(w2),
                                src<float>(gate), dst<float>(out), splits,
                                batch, n, m, tile_n, s);
  }
  if (kernel != rvk::tc::kCudaCores) return cudaErrorInvalidValue;
  return matmul_nt<float, 3>(src<float>(a1), src<float>(w1), src<float>(a2),
                             src<float>(w2), src<float>(gate),
                             dst<float>(out), batch, n, m, s);
}

// The 3-pass forms of the backward's other kernels ("the parts of the
// chains", full.cu), all operands fp32.  kernel: 0, the first version
// (gemm.cuh's 3-pass mode; the tiles, slices, `splits` and `workspace`
// ignored); 1, the tensor cores, every width a multiple of 8, 16-byte
// aligned pointers, batch > 0: `splits` the bf16 halves full.cu names for
// each, `workspace` the column sums' partials and the weight gradient's
// slices (ops/mlp.py split_workspace), tiles 128 x tile (128 or 64) and
// `split` slices of the batch (ops/tensor_cores.py split_tile and
// split_wgrad).
//
// out (batch, m) = where(gate > 0, a @ wᵀ, 0): a (batch, n), w (m, n),
// gate (batch, m); `splits` the halves of a and w (full.cu matmul_nt_split,
// dh3's launch).
int rvk_matmul_nt_mask3(const void* a, const void* w, const void* gate,
                        void* out, void* splits, int batch, int n, int m,
                        int tile_n, int kernel, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kernel == rvk::tc::kTensorCores) {
    return rvk::matmul_nt_split(src<float>(a), src<float>(w), nullptr,
                                nullptr, src<float>(gate), dst<float>(out),
                                splits, batch, n, m, tile_n, s);
  }
  if (kernel != rvk::tc::kCudaCores) return cudaErrorInvalidValue;
  return matmul_nt<float, 3>(src<float>(a), src<float>(w), nullptr, nullptr,
                             src<float>(gate), dst<float>(out), batch, n, m,
                             s);
}

// dw (n, m) = aᵀ b, both operands split, and db (m,) = colsum(b) of the
// unsplit b: a (batch, n), b (batch, m) (full.cu grad_accum_split<1>).
int rvk_grad_accum3(const void* a, const void* b, float* dw, float* db,
                    void* splits, float* workspace, int batch, int n, int m,
                    int tile_dw, int split, int kernel, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kernel == rvk::tc::kTensorCores) {
    const float* const bs[1] = {src<float>(b)};
    float* const dws[1] = {dw};
    float* const dbs[1] = {db};
    return rvk::grad_accum_split<1>(src<float>(a), bs, dws, dbs, splits,
                                    workspace, batch, n, m, tile_dw, split,
                                    s);
  }
  if (kernel != rvk::tc::kCudaCores) return cudaErrorInvalidValue;
  return grad_accum<float, 3>(src<float>(a), src<float>(b), nullptr, dw, db,
                              nullptr, nullptr, batch, n, m, s);
}

// rvk_grad_accum3 for two cotangents b1, b2 (batch, m) of one a, both in
// one launch (full.cu grad_accum_split<2>; the first version one launch
// carrying both).
int rvk_grad_accum2_3(const void* a, const void* b1, const void* b2,
                      float* dw1, float* db1, float* dw2, float* db2,
                      void* splits, float* workspace, int batch, int n,
                      int m, int tile_dw, int split, int kernel,
                      void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kernel == rvk::tc::kTensorCores) {
    const float* const bs[2] = {src<float>(b1), src<float>(b2)};
    float* const dws[2] = {dw1, dw2};
    float* const dbs[2] = {db1, db2};
    return rvk::grad_accum_split<2>(src<float>(a), bs, dws, dbs, splits,
                                    workspace, batch, n, m, tile_dw, split,
                                    s);
  }
  if (kernel != rvk::tc::kCudaCores) return cudaErrorInvalidValue;
  return grad_accum<float, 3>(src<float>(a), src<float>(b1), src<float>(b2),
                              dw1, db1, dw2, db2, batch, n, m, s);
}

// dh (batch, units) = where(h > 0, dmu @ w21ᵀ + dlv @ w22ᵀ, 0), fp32, into
// the scratch dh; dw1 (seg, units) = xᵀ dh, db1 = colsum(dh) (full.cu
// enc_bwd_dw1_split; dh in 128 x tile_dh, dW1 in 128 x tile_dw over `split`
// slices).
int rvk_enc_bwd_dw1_3(const void* x, const void* h, const void* dmu,
                      const void* dlv, const void* w21, const void* w22,
                      void* dh, float* dw1, float* db1, void* splits,
                      float* workspace, int batch, int seg, int units,
                      int latent, int tile_dh, int tile_dw, int split,
                      int kernel, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kernel == rvk::tc::kTensorCores) {
    return rvk::enc_bwd_dw1_split(
        src<float>(x), src<float>(h), src<float>(dmu), src<float>(dlv),
        src<float>(w21), src<float>(w22), dst<float>(dh), dw1, db1, splits,
        workspace, batch, seg, units, latent, tile_dh, tile_dw, split, s);
  }
  if (kernel != rvk::tc::kCudaCores) return cudaErrorInvalidValue;
  return enc_bwd_dw1<float, 3>(src<float>(x), src<float>(h), src<float>(dmu),
                               src<float>(dlv), src<float>(w21),
                               src<float>(w22), dst<float>(dh), dw1, db1,
                               batch, seg, units, latent, s);
}

// dh3 (batch, units) = where(h3 > 0, da @ w4ᵀ, 0) and dz (batch, latent) =
// dh3 @ w3ᵀ, fp32, into the scratch dh3 and dz; dw3 (latent, units) = zᵀ
// dh3, db3 = colsum(dh3) (full.cu dec_bwd_fused_split; dh3 in 128 x
// tile_dh3, dz in 128 x tile_dz, dW3 in 128 x tile_dw over `split`
// slices).
int rvk_dec_bwd_fused3(const void* da, const void* h3, const void* z,
                       const void* w4, const void* w3, void* dh3, void* dz,
                       float* dw3, float* db3, void* splits, float* workspace,
                       int batch, int seg, int units, int latent,
                       int tile_dh3, int tile_dz, int tile_dw, int split,
                       int kernel, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kernel == rvk::tc::kTensorCores) {
    return rvk::dec_bwd_fused_split(
        src<float>(da), src<float>(h3), src<float>(z), src<float>(w4),
        src<float>(w3), dst<float>(dh3), dst<float>(dz), dw3, db3, splits,
        workspace, batch, seg, units, latent, tile_dh3, tile_dz, tile_dw,
        split, s);
  }
  if (kernel != rvk::tc::kCudaCores) return cudaErrorInvalidValue;
  return dec_bwd_fused<float, 3>(src<float>(da), src<float>(h3),
                                 src<float>(z), src<float>(w4),
                                 src<float>(w3), dst<float>(dh3),
                                 dst<float>(dz), dw3, db3, batch, seg, units,
                                 latent, s);
}

// a (batch, n), b (batch, m) of one dtype; dw (n, m), db (m,) fp32.
// kernel (an rvk::tc::Kernel): 0, the tiled GEMM on the CUDA cores (tile_dw,
// split and workspace ignored); 1, the tensor-core weight gradient
// (rvk::tc::launch_wgrad), bf16 only, n and m multiples of 8, 16-byte
// aligned pointers, batch > 0, in tiles 128 x tile_dw over `split` slices of
// the batch, through `workspace` (split · (n · m + m) floats) when split > 1
// (ops/tensor_cores.py wgrad_plan); 2, the fp32 weight gradient of
// sgemm.cuh (rvk::sgemm::launch_wgrad), fp32 only, n and m multiples of 4,
// 16-byte aligned pointers, batch > 0, on the tile sgemm::kTiles[tile_dw]
// over `split` slices, through `workspace` as above (ops/tensor_cores.py
// sgemm_wgrad_plan).
int rvk_grad_accum(const void* a, const void* b, float* dw, float* db,
                   float* workspace, int batch, int n, int m, int dtype,
                   int tile_dw, int split, int kernel, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kernel == rvk::tc::kSgemm) {
    if (dtype != rvk::kF32 || batch <= 0) return cudaErrorInvalidValue;
    return rvk::sgemm::launch_wgrad(src<float>(a), src<float>(b), dw, db,
                                    workspace, n, m, batch, tile_dw, split,
                                    s);
  }
  if (kernel != rvk::tc::kCudaCores) {
    if (kernel != rvk::tc::kTensorCores || dtype != rvk::kBF16 ||
        batch <= 0) {
      return cudaErrorInvalidValue;
    }
    using T = rvk::bf16;
    return rvk::tc::launch_wgrad(src<T>(a), src<T>(b), dw, db, workspace, n,
                                 m, batch, tile_dw, split, s);
  }
  return rvk::with_dtype(dtype, [&](auto tag) {
    using T = std::remove_pointer_t<decltype(tag)>;
    return grad_accum<T>(src<T>(a), src<T>(b), nullptr, dw, db, nullptr,
                         nullptr, batch, n, m, s);
  });
}

// a (batch, n), b1 and b2 (batch, m) of one dtype; dw1, dw2 (n, m) and
// db1, db2 (m,) fp32.  kernel (an rvk::tc::Kernel): 0, one launch of the
// tiled GEMM on the CUDA cores carrying both products (tile_dw, split and
// workspace ignored); 1, both weight gradients in one launch of the
// tensor-core weight gradient (rvk::tc::launch_wgrad2), bf16 only, n and m
// multiples of 8, 16-byte aligned pointers, batch > 0, in tiles 128 x
// tile_dw over `split` slices of the batch, through `workspace` (2 · split
// · (n · m + m) floats) when split > 1 (ops/tensor_cores.py wgrad_plan
// with two outputs); 2, the fp32 form (sgemm_grad_accum2: rvk_grad_accum's
// fp32 launch for each output), fp32 only, n and m multiples of 4, 16-byte
// aligned pointers, batch > 0, on the tile sgemm::kTiles[tile_dw] over
// `split` slices, through `workspace` (split · (n · m + m) floats at least;
// ops/tensor_cores.py sgemm_wgrad_plan).
int rvk_grad_accum2(const void* a, const void* b1, const void* b2, float* dw1,
                    float* db1, float* dw2, float* db2, float* workspace,
                    int batch, int n, int m, int dtype, int tile_dw,
                    int split, int kernel, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kernel == rvk::tc::kSgemm) {
    return sgemm_grad_accum2(a, b1, b2, dw1, db1, dw2, db2, workspace, batch,
                             n, m, dtype, tile_dw, split, s);
  }
  if (kernel != rvk::tc::kCudaCores) {
    if (kernel != rvk::tc::kTensorCores || dtype != rvk::kBF16 ||
        batch <= 0) {
      return cudaErrorInvalidValue;
    }
    using T = rvk::bf16;
    return rvk::tc::launch_wgrad2(src<T>(a), src<T>(b1), src<T>(b2), dw1,
                                  db1, dw2, db2, workspace, n, m, batch,
                                  tile_dw, split, s);
  }
  return rvk::with_dtype(dtype, [&](auto tag) {
    using T = std::remove_pointer_t<decltype(tag)>;
    return grad_accum(src<T>(a), src<T>(b1), src<T>(b2), dw1, db1, dw2, db2,
                      batch, n, m, s);
  });
}

// x (batch, seg), h (batch, units), dmu and dlv (batch, latent), w21 and
// w22 (units, latent), scratch dh (batch, units), all of one dtype; dw1
// (seg, units) and db1 (units,) fp32.  kernel (an rvk::tc::Kernel): 0, the
// two launches of the tiled GEMM on the CUDA cores (the tile widths, split
// and workspace ignored); 1, the tensor-core form (tensor_core_enc_bwd_dw1),
// bf16 only, seg, units and latent multiples of 8, 16-byte aligned
// pointers, batch > 0: dh in tiles 128 x tile_dh, dw1 and db1 in 128 x
// tile_dw over `split` slices of the batch, through `workspace` (split ·
// (seg · units + units) floats) when split > 1 (ops/tensor_cores.py tile_n
// and wgrad_plan); 2, the fp32 form (sgemm_enc_bwd_dw1), fp32 only, seg,
// units and latent multiples of 4, 16-byte aligned pointers, batch > 0: dh
// on the tile sgemm::kTiles[tile_dh], dw1 and db1 on kTiles[tile_dw] over
// `split` slices, through `workspace` as above (ops/tensor_cores.py
// sgemm_tile and sgemm_wgrad_plan).
int rvk_enc_bwd_dw1(const void* x, const void* h, const void* dmu,
                    const void* dlv, const void* w21, const void* w22,
                    void* dh, float* dw1, float* db1, float* workspace,
                    int batch, int seg, int units, int latent, int dtype,
                    int tile_dh, int tile_dw, int split, int kernel,
                    void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kernel == rvk::tc::kSgemm) {
    return sgemm_enc_bwd_dw1(x, h, dmu, dlv, w21, w22, dh, dw1, db1,
                             workspace, batch, seg, units, latent, dtype,
                             tile_dh, tile_dw, split, s);
  }
  if (kernel != rvk::tc::kCudaCores) {
    if (kernel != rvk::tc::kTensorCores) return cudaErrorInvalidValue;
    return tensor_core_enc_bwd_dw1(x, h, dmu, dlv, w21, w22, dh, dw1, db1,
                                   workspace, batch, seg, units, latent,
                                   dtype, tile_dh, tile_dw, split, s);
  }
  return rvk::with_dtype(dtype, [&](auto tag) {
    using T = std::remove_pointer_t<decltype(tag)>;
    return enc_bwd_dw1(src<T>(x), src<T>(h), src<T>(dmu), src<T>(dlv),
                       src<T>(w21), src<T>(w22), dst<T>(dh), dw1, db1, batch,
                       seg, units, latent, s);
  });
}

// da (batch, seg), h3 (batch, units), z (batch, latent), w4 (units, seg),
// w3 (latent, units), scratch dh3 (batch, units), dz (batch, latent), all
// of one dtype; dw3 (latent, units) and db3 (units,) fp32.  kernel (an
// rvk::tc::Kernel): 0, the three launches of the tiled GEMM on the CUDA
// cores (the tile widths, split and workspace ignored); 1, the tensor-core
// form (tensor_core_dec_bwd), bf16 only, seg, units and latent multiples of
// 8, 16-byte aligned pointers, batch > 0: dh3 in tiles 128 x tile_dh3, dz in
// 128 x tile_dz, dw3 and db3 in 128 x tile_dw over `split` slices of the
// batch, through `workspace` (split · (latent · units + units) floats) when
// split > 1 (ops/tensor_cores.py tile_n and wgrad_plan); 2, the fp32 form
// (sgemm_dec_bwd), fp32 only, seg, units and latent multiples of 4, 16-byte
// aligned pointers, batch > 0: dh3 on the tile sgemm::kTiles[tile_dh3], dz
// on kTiles[tile_dz], dw3 and db3 on kTiles[tile_dw] over `split` slices,
// through `workspace` as above (ops/tensor_cores.py sgemm_tile and
// sgemm_wgrad_plan).
int rvk_dec_bwd_fused(const void* da, const void* h3, const void* z,
                      const void* w4, const void* w3, void* dh3, void* dz,
                      float* dw3, float* db3, float* workspace, int batch,
                      int seg, int units, int latent, int dtype,
                      int tile_dh3, int tile_dz, int tile_dw, int split,
                      int kernel, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kernel == rvk::tc::kSgemm) {
    return sgemm_dec_bwd(da, h3, z, w4, w3, dh3, dz, dw3, db3, workspace,
                         batch, seg, units, latent, dtype, tile_dh3, tile_dz,
                         tile_dw, split, s);
  }
  if (kernel != rvk::tc::kCudaCores) {
    if (kernel != rvk::tc::kTensorCores) return cudaErrorInvalidValue;
    return tensor_core_dec_bwd(da, h3, z, w4, w3, dh3, dz, dw3, db3,
                               workspace, batch, seg, units, latent, dtype,
                               tile_dh3, tile_dz, tile_dw, split, s);
  }
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
// (latent,) fp32.  passes: 1, or 3 with fp32 operands.  kernel (an
// rvk::tc::Kernel): 0, the first version, three launches of the tiled GEMM
// on the CUDA cores in `passes` passes (the tiles, splits, `splits` and
// `workspace` ignored); 1, the tensor cores, seg, units and latent
// multiples of 8, 16-byte aligned pointers, batch > 0: fp32 operands at 3
// passes the 3-pass chain (rvk::enc_bwd_split, full.cu: `splits` the bf16
// halves of dmu, dlv, w21, w22, dh, x and h, `workspace` the column sums'
// partials and the slices), bf16 operands tensor_core_enc_bwd_dw1 then
// launch_wgrad2 (`workspace` the slices); dh in tiles 128 x tile_dh, dW1 in
// 128 x tile_dw1 over split_dw1 slices of the batch, dW21 | dW22 in 128 x
// tile_dw2 over split_dw2 (ops/tensor_cores.py full_plan); 2, fp32
// operands at one pass, seg, units and latent multiples of 4, 16-byte
// aligned pointers, batch > 0: sgemm_enc_bwd_full (dh on the tile
// sgemm::kTiles[tile_dh], dW1 on kTiles[tile_dw1] over split_dw1 slices,
// each head's weight gradient on kTiles[tile_dw2] over split_dw2, one
// `workspace` in turn).
int rvk_enc_bwd_full(const void* x, const void* h, const void* dmu,
                     const void* dlv, const void* w21, const void* w22,
                     void* dh, float* dw1, float* db1, float* dw21,
                     float* db21, float* dw22, float* db22, void* splits,
                     float* workspace, int batch, int seg, int units,
                     int latent, int dtype, int passes, int tile_dh,
                     int tile_dw1, int split_dw1, int tile_dw2,
                     int split_dw2, int kernel, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kernel == rvk::tc::kSgemm) {
    if (dtype != rvk::kF32 || passes != 1 || batch <= 0) {
      return cudaErrorInvalidValue;
    }
    return sgemm_enc_bwd_full(x, h, dmu, dlv, w21, w22, dh, dw1, db1, dw21,
                              db21, dw22, db22, workspace, batch, seg, units,
                              latent, dtype, tile_dh, tile_dw1, split_dw1,
                              tile_dw2, split_dw2, s);
  }
  if (kernel == rvk::tc::kTensorCores &&
      (dtype == rvk::kF32) != (passes == 3)) {
    return cudaErrorInvalidValue;
  }
  if (kernel == rvk::tc::kTensorCores && dtype == rvk::kF32) {
    return rvk::enc_bwd_split(
        src<float>(x), src<float>(h), src<float>(dmu), src<float>(dlv),
        src<float>(w21), src<float>(w22), dst<float>(dh), dw1, db1, dw21,
        db21, dw22, db22, splits, workspace, batch, seg, units, latent,
        tile_dh, tile_dw1, split_dw1, tile_dw2, split_dw2, s);
  }
  if (kernel == rvk::tc::kTensorCores) {
    const int err = tensor_core_enc_bwd_dw1(
        x, h, dmu, dlv, w21, w22, dh, dw1, db1, workspace, batch, seg, units,
        latent, dtype, tile_dh, tile_dw1, split_dw1, s);
    if (err != cudaSuccess) return err;
    using T = rvk::bf16;
    return rvk::tc::launch_wgrad2(src<T>(h), src<T>(dmu), src<T>(dlv), dw21,
                                  db21, dw22, db22, workspace, units, latent,
                                  batch, tile_dw2, split_dw2, s);
  }
  if (kernel != rvk::tc::kCudaCores) return cudaErrorInvalidValue;
  return rvk::with_dtype(dtype, [&](auto tag) {
    using T = std::remove_pointer_t<decltype(tag)>;
    return with_passes<T>(passes, [&](auto count) {
      return enc_bwd_full<T, decltype(count)::value>(
          src<T>(x), src<T>(h), src<T>(dmu), src<T>(dlv), src<T>(w21),
          src<T>(w22), dst<T>(dh), dw1, db1, dw21, db21, dw22, db22, batch,
          seg, units, latent, s);
    });
  });
}

// da (batch, seg), h3 (batch, units), z (batch, latent), w4 (units, seg),
// w3 (latent, units), scratch dh3 (batch, units), dz (batch, latent), all
// of one dtype; dw3 (latent, units), db3 (units,), dw4 (units, seg), db4
// (seg,) fp32.  passes as for rvk_enc_bwd_full.  kernel: 0, the first
// version, four launches of the tiled GEMM in `passes` passes; 1, the
// tensor cores, seg, units and latent multiples of 8, 16-byte aligned
// pointers, batch > 0: fp32 operands at 3 passes the 3-pass chain
// (rvk::dec_bwd_split, full.cu: `splits` the halves of da, w4, dh3, w3, z
// and h3), bf16 operands tensor_core_dec_bwd then dW4 | db4 on
// launch_wgrad; dh3 in tiles 128 x tile_dh3, dz in 128 x tile_dz, dW3 in
// 128 x tile_dw3 over split_dw3 slices, dW4 in 128 x tile_dw4 over
// split_dw4 (ops/tensor_cores.py full_plan); 2, fp32 operands at one pass
// with widths multiples of 4: sgemm_dec_bwd_full (the tiles indices of
// sgemm::kTiles).
int rvk_dec_bwd_full(const void* da, const void* h3, const void* z,
                     const void* w4, const void* w3, void* dh3, void* dz,
                     float* dw3, float* db3, float* dw4, float* db4,
                     void* splits, float* workspace, int batch, int seg,
                     int units, int latent, int dtype, int passes,
                     int tile_dh3, int tile_dz, int tile_dw3, int split_dw3,
                     int tile_dw4, int split_dw4, int kernel, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kernel == rvk::tc::kSgemm) {
    if (dtype != rvk::kF32 || passes != 1 || batch <= 0) {
      return cudaErrorInvalidValue;
    }
    return sgemm_dec_bwd_full(da, h3, z, w4, w3, dh3, dz, dw3, db3, dw4, db4,
                              workspace, batch, seg, units, latent, dtype,
                              tile_dh3, tile_dz, tile_dw3, split_dw3,
                              tile_dw4, split_dw4, s);
  }
  if (kernel == rvk::tc::kTensorCores &&
      (dtype == rvk::kF32) != (passes == 3)) {
    return cudaErrorInvalidValue;
  }
  if (kernel == rvk::tc::kTensorCores && dtype == rvk::kF32) {
    return rvk::dec_bwd_split(
        src<float>(da), src<float>(h3), src<float>(z), src<float>(w4),
        src<float>(w3), dst<float>(dh3), dst<float>(dz), dw3, db3, dw4, db4,
        splits, workspace, batch, seg, units, latent, tile_dh3, tile_dz,
        tile_dw3, split_dw3, tile_dw4, split_dw4, s);
  }
  if (kernel == rvk::tc::kTensorCores) {
    const int err = tensor_core_dec_bwd(
        da, h3, z, w4, w3, dh3, dz, dw3, db3, workspace, batch, seg, units,
        latent, dtype, tile_dh3, tile_dz, tile_dw3, split_dw3, s);
    if (err != cudaSuccess) return err;
    using T = rvk::bf16;
    return rvk::tc::launch_wgrad(src<T>(h3), src<T>(da), dw4, db4, workspace,
                                 units, seg, batch, tile_dw4, split_dw4, s);
  }
  if (kernel != rvk::tc::kCudaCores) return cudaErrorInvalidValue;
  return rvk::with_dtype(dtype, [&](auto tag) {
    using T = std::remove_pointer_t<decltype(tag)>;
    return with_passes<T>(passes, [&](auto count) {
      return dec_bwd_full<T, decltype(count)::value>(
          src<T>(da), src<T>(h3), src<T>(z), src<T>(w4), src<T>(w3),
          dst<T>(dh3), dst<T>(dz), dw3, db3, dw4, db4, batch, seg, units,
          latent, s);
    });
  });
}

}  // extern "C"
