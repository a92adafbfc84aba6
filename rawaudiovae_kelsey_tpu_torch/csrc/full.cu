// The `high` tier's products on the tensor cores, every one in three bf16
// passes: the full backward chains, the fp32 forms of rvk_enc_bwd_full and
// rvk_dec_bwd_full (bwd.cu, kernel code 1); their parts, the 3-pass forms
// of rvk_enc_bwd_dw1_3, rvk_dec_bwd_fused3, rvk_grad_accum3,
// rvk_grad_accum2_3 and rvk_matmul_nt_mask3 (bwd.cu, kernel code 1; below,
// "the parts of the chains"); the forward chains of rvk_encoder_fwd3 and
// rvk_decoder_fwd3 (mlp.cu) and the input-gradient products of
// rvk_matmul_nt2_mask3 and rvk_matmul_nt3 (bwd.cu), kernel code 1 (below,
// "the forward and the input gradient"); and the split pass alone as a C
// entry point (rvk_split_hi_lo; ops/mlp.py split_pass).
//
// They replace the TPU kernels enc_bwd_full (_enc_bwd_full_kernel) and
// dec_bwd_full (_dec_bwd_full_kernel) of
// rawaudiovae_kelsey_tpu/ops/pallas_mlp.py, which split each fp32 operand
// tile into hi and lo bf16 halves in VMEM (_split_hi_lo, _stack_hi_lo) and
// take every product as _mm at passes = 3: (hi·hi + hi·lo) + lo·hi.  Here
// each fp32 operand is split once by the split pass (split.cuh) into two
// bf16 matrices in a scratch buffer the wrapper allocates, and each product
// is one launch of the tensor-core mainloop's 3-pass mode (wgmma.cuh,
// "the 3-pass product": four boxes a stage, three fp32 accumulators added
// (hh + hl) + lh in the epilogue).  A chain is a sequence of launches in
// stream order, each reading what the ones before wrote:
//   encoder  split dmu, dlv (their column sums are db21, db22), w21, w22;
//            dh = where(h > 0, dmu·W21ᵀ + dlv·W22ᵀ, 0), fp32, one k-joined
//            walk with the fp32 gate read at the output's place;
//            split dh (db1) and x; dW1 = xᵀ·dh over slices of the batch;
//            split h; dW21 | dW22 = hᵀ·[dmu dlv] in one two-output launch
//   decoder  split da (db4) and w4; dh3 = where(h3 > 0, da·W4ᵀ, 0), fp32;
//            split dh3 (db3) and w3; dz = dh3·W3ᵀ, fp32; split z; dW3 =
//            zᵀ·dh3; split h3; dW4 = h3ᵀ·da
// dh and dh3 stay fp32 (pallas_mlp.py:762-775, 859-872): the products that
// read them take their halves, and db1 / db3 sum the unsplit values.
//
// The parts of the chains.  With the JAX package's BWD_FUSION forced to
// "split" or "primitive" (pallas_mlp.py:993-1011), the `high` tier's
// backward runs the TPU kernels enc_bwd_dw1, dec_bwd_fused, grad_accum,
// grad_accum2 and matmul_nt_mask at passes = 3 (_grad_accum_kernel splits
// both of its operands, :439-449; dh and dh3 stay fp32, :524-530, 676-684).
// Each is a part of a chain above, with the chain's own launches:
//   enc_bwd_dw1     the encoder's chain up to dW1 (no db21, db22)
//   dec_bwd_fused   the decoder's chain up to dW3 (no db4)
//   grad_accum      split a, and b with its column sums (db); dW = aᵀ·b
//   grad_accum2     the same for two cotangents, both in one launch
//   matmul_nt_mask  dh3's launch (matmul_nt_split with a gate, no a2)
//
// The forward and the input gradient.  Under JAX's ambient `high` tier
// the TPU kernels encoder_fwd (_enc_fwd_kernel), decoder_fwd
// (_dec_fwd_kernel), matmul_nt2_mask and matmul_nt (pallas_mlp.py:167
// _ambient_passes) take every product at passes = 3 too, with the weights
// split outside the kernel (_stack_hi_lo) and the activation tile inside
// it; the bias is added after the three-pass sum, then the activation, and
// h / h3 stay fp32 and are split again for the next product
// (pallas_mlp.py:233-241, 286-291).  Here each chain splits its operands
// once and runs each product as one 3-pass launch:
//   encoder  split x and w1; h = relu(x·W1 + b1), fp32 (SplitBiasRows);
//            split h, w21 and w22; mu | logvar = h·[W21 W22] + [b21 b22] in
//            one two-output walk (HeadsTiles), as the 1-pass bf16 heads
//   decoder  split z and w3; h3 = relu(z·W3 + b3); split h3 and w4; y =
//            tanh(h3·W4 + b4)
//   dh       split dmu, dlv, w21, w22; where(h > 0, dmu·W21ᵀ + dlv·W22ᵀ,
//            0), one k-joined gated walk (SplitRows): the encoder chain's dh
//   dx       split dh and w1; dh·W1ᵀ (SplitRows, no gate)
// The row-parallel forms of tensor parallelism are the same chains with no
// bias on the heads (and no tanh on y): the fp32 partial sums.
//
// What bounds them: operations.  At the stream's batch of 4096 the
// encoder's products are 3 · 34.4 GFLOP on the tensor cores (0.104 ms at
// 989 TFLOP/s), the decoder's 3 · 43.0; the splits move ~150 / ~110 MB
// (~0.05 / ~0.03 ms at 3.35 TB/s).  The splits' and products' order is
// fixed for a shape and nothing is added atomically: two runs give the
// same bits.
#include "split.cuh"
#include "wgmma.cuh"

namespace rvk {
namespace {

using tc::Halves;

// One fp32 matrix's halves in the scratch buffer.
struct Split {
  bf16* hi;
  bf16* lo;
  operator Halves() const { return Halves{hi, lo}; }
};

// The scratch buffer cut into the halves of each matrix, hi then lo, in
// the order taken (ops/mlp.py full_scratch sizes it the same way).  Every
// width is a multiple of 8, so each half starts on a 16-byte boundary.
struct SplitPool {
  bf16* next;
  Split take(int rows, int cols) {
    const size_t n = size_t(rows) * cols;
    const Split s{next, next + n};
    next += 2 * n;
    return s;
  }
};

// v (rows, cols) → its halves, with its column sums into colsum if not null
cudaError_t split(const float* v, const Split& to, float* colsum,
                  float* workspace, int rows, int cols, cudaStream_t s) {
  return split_matrix(v, to.hi, to.lo, colsum, workspace, rows, cols, s);
}

// Run each step in order until one fails.
template <typename... F>
cudaError_t in_order(F&&... steps) {
  cudaError_t err = cudaSuccess;
  ((err = err == cudaSuccess ? steps() : err), ...);
  return err;
}

// dW[o] = aᵀ·b[o] for the outputs of one A, 3-pass, over `slices` slices
// of the batch through `workspace`
template <int kOuts>
cudaError_t wgrad(const Split& a, const Split* b, float* const* dw,
                  float* workspace, int M, int N, int K, int tile,
                  int slices, cudaStream_t s) {
  const bf16* hi[kOuts];
  const bf16* lo[kOuts];
  float* const no_db[kMaxOuts] = {};
  for (int o = 0; o < kOuts; ++o) {
    hi[o] = b[o].hi;
    lo[o] = b[o].lo;
  }
  return tc::launch_wgrad_outs<kOuts, true>(a.hi, hi, dw, no_db, workspace,
                                            M, N, K, tile, slices, s, a.lo,
                                            lo);
}

// The encoder's chain up to dW1 (header), on halves taken from `pool`:
// split dmu and dlv (their column sums into db21 and db22 where those are
// not null), w21 and w22; dh = where(h > 0, dmu·W21ᵀ + dlv·W22ᵀ, 0), fp32,
// one k-joined walk in 128 x tile_dh tiles; split dh (db1) and x; dW1 =
// xᵀ·dh in 128 x tile_dw1 over split_dw1 slices.  dmu's and dlv's halves
// come back in `heads` for the rest of a chain.
cudaError_t enc_dh_dw1(SplitPool& pool, Split* heads, const float* x,
                       const float* h, const float* dmu, const float* dlv,
                       const float* w21, const float* w22, float* dh,
                       float* dw1, float* db1, float* db21, float* db22,
                       float* workspace, int batch, int seg, int units,
                       int latent, int tile_dh, int tile_dw1, int split_dw1,
                       cudaStream_t s) {
  heads[0] = pool.take(batch, latent);
  heads[1] = pool.take(batch, latent);
  const Split s21 = pool.take(units, latent), s22 = pool.take(units, latent),
              sdh = pool.take(batch, units), sx = pool.take(batch, seg);
  const Halves a[2] = {heads[0], heads[1]}, weights[2] = {s21, s22};
  return in_order(
      [&] { return split(dmu, heads[0], db21, workspace, batch, latent, s); },
      [&] { return split(dlv, heads[1], db22, workspace, batch, latent, s); },
      [&] { return split(w21, s21, nullptr, nullptr, units, latent, s); },
      [&] { return split(w22, s22, nullptr, nullptr, units, latent, s); },
      [&] {
        return tc::launch_split_rows<true>(a, weights, dh, h, batch, units,
                                           latent, tile_dh, s);
      },
      [&] { return split(dh, sdh, db1, workspace, batch, units, s); },
      [&] { return split(x, sx, nullptr, nullptr, batch, seg, s); },
      [&] {
        return wgrad<1>(sx, &sdh, &dw1, workspace, seg, units, batch,
                        tile_dw1, split_dw1, s);
      });
}

// The decoder's chain up to dW3 (header), on halves taken from `pool`:
// split da (its column sums into db4 where that is not null) and w4; dh3 =
// where(h3 > 0, da·W4ᵀ, 0), fp32, in 128 x tile_dh3; split dh3 (db3) and
// w3; dz = dh3·W3ᵀ, fp32, in 128 x tile_dz; split z; dW3 = zᵀ·dh3 in 128 x
// tile_dw3 over split_dw3 slices.  da's halves come back in `da_halves`.
cudaError_t dec_dh3_dw3(SplitPool& pool, Split* da_halves, const float* da,
                        const float* h3, const float* z, const float* w4,
                        const float* w3, float* dh3, float* dz, float* dw3,
                        float* db3, float* db4, float* workspace, int batch,
                        int seg, int units, int latent, int tile_dh3,
                        int tile_dz, int tile_dw3, int split_dw3,
                        cudaStream_t s) {
  const Split sda = *da_halves = pool.take(batch, seg);
  const Split s4 = pool.take(units, seg), sdh3 = pool.take(batch, units),
              s3 = pool.take(latent, units), sz = pool.take(batch, latent);
  const Halves da_h = sda, w4_h = s4, dh3_h = sdh3, w3_h = s3;
  return in_order(
      [&] { return split(da, sda, db4, workspace, batch, seg, s); },
      [&] { return split(w4, s4, nullptr, nullptr, units, seg, s); },
      [&] {
        return tc::launch_split_rows<false>(&da_h, &w4_h, dh3, h3, batch,
                                            units, seg, tile_dh3, s);
      },
      [&] { return split(dh3, sdh3, db3, workspace, batch, units, s); },
      [&] { return split(w3, s3, nullptr, nullptr, latent, units, s); },
      [&] {
        return tc::launch_split_rows<false>(&dh3_h, &w3_h, dz, nullptr,
                                            batch, latent, units, tile_dz, s);
      },
      [&] { return split(z, sz, nullptr, nullptr, batch, latent, s); },
      [&] {
        return wgrad<1>(sz, &sdh3, &dw3, workspace, latent, units, batch,
                        tile_dw3, split_dw3, s);
      });
}

}  // namespace

// The encoder's chain (header): x (batch, seg), h (batch, units), dmu and
// dlv (batch, latent), w21 and w22 (units, latent), all fp32; the scratch
// dh (batch, units) fp32; dw1 (seg, units), db1 (units,), dw21 and dw22
// (units, latent), db21 and db22 (latent,) fp32; `splits` the halves of
// dmu, dlv, w21, w22, dh, x and h in that order (bf16, 2 · their elements);
// `workspace` the column sums' partials and the weight gradients' slices,
// fp32, as ops/mlp.py full_scratch sizes it.  dh in 128 x tile_dh tiles;
// dW1 in 128 x tile_dw1 over split_dw1 slices, dW21 | dW22 in 128 x tile_dw2
// over split_dw2 (ops/tensor_cores.py split_tile_n, split_wgrad_plan).
cudaError_t enc_bwd_split(const float* x, const float* h, const float* dmu,
                          const float* dlv, const float* w21,
                          const float* w22, float* dh, float* dw1,
                          float* db1, float* dw21, float* db21, float* dw22,
                          float* db22, void* splits, float* workspace,
                          int batch, int seg, int units, int latent,
                          int tile_dh, int tile_dw1, int split_dw1,
                          int tile_dw2, int split_dw2, cudaStream_t s) {
  if (batch <= 0 || splits == nullptr) return cudaErrorInvalidValue;
  SplitPool pool{static_cast<bf16*>(splits)};
  Split heads[2];
  float* const dw2[2] = {dw21, dw22};
  return in_order(
      [&] {
        return enc_dh_dw1(pool, heads, x, h, dmu, dlv, w21, w22, dh, dw1, db1,
                          db21, db22, workspace, batch, seg, units, latent,
                          tile_dh, tile_dw1, split_dw1, s);
      },
      [&] {
        const Split sh = pool.take(batch, units);
        const cudaError_t err = split(h, sh, nullptr, nullptr, batch, units,
                                      s);
        if (err != cudaSuccess) return err;
        return wgrad<2>(sh, heads, dw2, workspace, units, latent, batch,
                        tile_dw2, split_dw2, s);
      });
}
// The decoder's chain (header): da (batch, seg), h3 (batch, units), z
// (batch, latent), w4 (units, seg), w3 (latent, units), all fp32; the
// scratch dh3 (batch, units) and dz (batch, latent) fp32; dw3 (latent,
// units), db3 (units,), dw4 (units, seg), db4 (seg,) fp32; `splits` the
// halves of da, w4, dh3, w3, z and h3 in that order; `workspace` as for
// the encoder.  dh3 in 128 x tile_dh3 tiles, dz in 128 x tile_dz, dW3 and
// dW4 in 128 x tile_dw3 / tile_dw4 over split_dw3 / split_dw4 slices.
cudaError_t dec_bwd_split(const float* da, const float* h3, const float* z,
                          const float* w4, const float* w3, float* dh3,
                          float* dz, float* dw3, float* db3, float* dw4,
                          float* db4, void* splits, float* workspace,
                          int batch, int seg, int units, int latent,
                          int tile_dh3, int tile_dz, int tile_dw3,
                          int split_dw3, int tile_dw4, int split_dw4,
                          cudaStream_t s) {
  if (batch <= 0 || splits == nullptr) return cudaErrorInvalidValue;
  SplitPool pool{static_cast<bf16*>(splits)};
  Split sda;
  return in_order(
      [&] {
        return dec_dh3_dw3(pool, &sda, da, h3, z, w4, w3, dh3, dz, dw3, db3,
                           db4, workspace, batch, seg, units, latent,
                           tile_dh3, tile_dz, tile_dw3, split_dw3, s);
      },
      [&] {
        const Split sh3 = pool.take(batch, units);
        const cudaError_t err = split(h3, sh3, nullptr, nullptr, batch,
                                      units, s);
        if (err != cudaSuccess) return err;
        return wgrad<1>(sh3, &sda, &dw4, workspace, units, seg, batch,
                        tile_dw4, split_dw4, s);
      });
}

// The parts of the chains (header): the 3-pass forms of enc_bwd_dw1,
// dec_bwd_fused, grad_accum and grad_accum2.  Operands and outputs as the
// chains take them, all fp32.
//   enc_bwd_dw1_split    the encoder's chain up to dW1 (no db21, db22);
//                        `splits` the halves of dmu, dlv, w21, w22, dh, x
//   dec_bwd_fused_split  the decoder's chain up to dW3 (no db4); `splits`
//                        the halves of da, w4, dh3, w3, z
//   grad_accum_split     a (batch, n) and kOuts cotangents b[o] (batch, m):
//                        split a, then each b[o] with its column sums db[o]
//                        of the unsplit values; dW[o] = aᵀ·b[o] in one
//                        launch of kOuts outputs, 128 x tile_dw over
//                        `slices` slices; `splits` the halves of a, b[0][,
//                        b[1]]
cudaError_t enc_bwd_dw1_split(const float* x, const float* h,
                              const float* dmu, const float* dlv,
                              const float* w21, const float* w22, float* dh,
                              float* dw1, float* db1, void* splits,
                              float* workspace, int batch, int seg, int units,
                              int latent, int tile_dh, int tile_dw,
                              int split_dw, cudaStream_t s) {
  if (batch <= 0 || splits == nullptr) return cudaErrorInvalidValue;
  SplitPool pool{static_cast<bf16*>(splits)};
  Split heads[2];
  return enc_dh_dw1(pool, heads, x, h, dmu, dlv, w21, w22, dh, dw1, db1,
                    nullptr, nullptr, workspace, batch, seg, units, latent,
                    tile_dh, tile_dw, split_dw, s);
}

cudaError_t dec_bwd_fused_split(const float* da, const float* h3,
                                const float* z, const float* w4,
                                const float* w3, float* dh3, float* dz,
                                float* dw3, float* db3, void* splits,
                                float* workspace, int batch, int seg,
                                int units, int latent, int tile_dh3,
                                int tile_dz, int tile_dw, int split_dw,
                                cudaStream_t s) {
  if (batch <= 0 || splits == nullptr) return cudaErrorInvalidValue;
  SplitPool pool{static_cast<bf16*>(splits)};
  Split sda;
  return dec_dh3_dw3(pool, &sda, da, h3, z, w4, w3, dh3, dz, dw3, db3,
                     nullptr, workspace, batch, seg, units, latent, tile_dh3,
                     tile_dz, tile_dw, split_dw, s);
}

template <int kOuts>
cudaError_t grad_accum_split(const float* a, const float* const* b,
                             float* const* dw, float* const* db, void* splits,
                             float* workspace, int batch, int n, int m,
                             int tile_dw, int slices, cudaStream_t s) {
  if (batch <= 0 || splits == nullptr) return cudaErrorInvalidValue;
  SplitPool pool{static_cast<bf16*>(splits)};
  const Split sa = pool.take(batch, n);
  Split sb[kOuts];
  cudaError_t err = split(a, sa, nullptr, nullptr, batch, n, s);
  for (int o = 0; o < kOuts && err == cudaSuccess; ++o) {
    sb[o] = pool.take(batch, m);
    err = split(b[o], sb[o], db[o], workspace, batch, m, s);
  }
  if (err != cudaSuccess) return err;
  return wgrad<kOuts>(sa, sb, dw, workspace, n, m, batch, tile_dw, slices,
                      s);
}

template cudaError_t grad_accum_split<1>(const float*, const float* const*,
                                         float* const*, float* const*, void*,
                                         float*, int, int, int, int, int,
                                         cudaStream_t);
template cudaError_t grad_accum_split<2>(const float*, const float* const*,
                                         float* const*, float* const*, void*,
                                         float*, int, int, int, int, int,
                                         cudaStream_t);

// The encoder's forward in three passes (header, "the forward and the
// input gradient"): x (batch, seg), w1 (seg, units), b1 (units,), w21 and
// w22 (units, latent), b21 and b22 (latent,), all fp32; mu and logvar
// (batch, latent), h (batch, units) fp32; `splits` the halves of x, w1,
// w21, w22 and h in that order (bf16, 2 · their elements).  b21 and b22
// null: the heads' fp32 partial sums, no bias (the row-parallel form).  h
// in 128 x tile_hidden tiles, both heads in one launch of 128 x tile_heads
// (ops/tensor_cores.py split_tile).
cudaError_t encoder_split(const float* x, const float* w1, const float* b1,
                          const float* w21, const float* b21,
                          const float* w22, const float* b22, float* mu,
                          float* logvar, float* h, void* splits, int batch,
                          int seg, int units, int latent, int tile_hidden,
                          int tile_heads, cudaStream_t s) {
  if (batch <= 0 || splits == nullptr) return cudaErrorInvalidValue;
  SplitPool pool{static_cast<bf16*>(splits)};
  const Split sx = pool.take(batch, seg), s1 = pool.take(seg, units),
              s21 = pool.take(units, latent), s22 = pool.take(units, latent),
              sh = pool.take(batch, units);
  const Halves w1_h = s1, heads_w[2] = {s21, s22};
  float* const hidden[1] = {h};
  const float* const hidden_bias[1] = {b1};
  float* const heads[2] = {mu, logvar};
  const float* const heads_bias[2] = {b21, b22};
  return in_order(
      [&] { return split(x, sx, nullptr, nullptr, batch, seg, s); },
      [&] { return split(w1, s1, nullptr, nullptr, seg, units, s); },
      [&] {
        return tc::launch_split_fwd<tc::MatrixTiles, kActRelu>(
            sx, &w1_h, hidden, hidden_bias, batch, units, seg, tile_hidden,
            s);
      },
      [&] { return split(h, sh, nullptr, nullptr, batch, units, s); },
      [&] { return split(w21, s21, nullptr, nullptr, units, latent, s); },
      [&] { return split(w22, s22, nullptr, nullptr, units, latent, s); },
      [&] {
        return tc::launch_split_fwd<tc::HeadsTiles, kActNone>(
            sh, heads_w, heads, heads_bias, batch, latent, units, tile_heads,
            s);
      });
}

// The decoder's forward in three passes: z (batch, latent), w3 (latent,
// units), b3 (units,), w4 (units, seg), b4 (seg,), all fp32; y (batch,
// seg), h3 (batch, units) fp32; `splits` the halves of z, w3, w4 and h3 in
// that order.  b4 null: y's fp32 partial sums, no bias, no tanh (the
// row-parallel form).  h3 in 128 x tile_hidden tiles, y in 128 x tile_out.
cudaError_t decoder_split(const float* z, const float* w3, const float* b3,
                          const float* w4, const float* b4, float* y,
                          float* h3, void* splits, int batch, int latent,
                          int units, int seg, int tile_hidden, int tile_out,
                          cudaStream_t s) {
  if (batch <= 0 || splits == nullptr) return cudaErrorInvalidValue;
  SplitPool pool{static_cast<bf16*>(splits)};
  const Split sz = pool.take(batch, latent), s3 = pool.take(latent, units),
              s4 = pool.take(units, seg), sh3 = pool.take(batch, units);
  const Halves w3_h = s3, w4_h = s4;
  float* const hidden[1] = {h3};
  const float* const hidden_bias[1] = {b3};
  float* const out[1] = {y};
  const float* const out_bias[1] = {b4};
  return in_order(
      [&] { return split(z, sz, nullptr, nullptr, batch, latent, s); },
      [&] { return split(w3, s3, nullptr, nullptr, latent, units, s); },
      [&] {
        return tc::launch_split_fwd<tc::MatrixTiles, kActRelu>(
            sz, &w3_h, hidden, hidden_bias, batch, units, latent,
            tile_hidden, s);
      },
      [&] { return split(h3, sh3, nullptr, nullptr, batch, units, s); },
      [&] { return split(w4, s4, nullptr, nullptr, units, seg, s); },
      [&] {
        return b4 != nullptr
                   ? tc::launch_split_fwd<tc::MatrixTiles, kActTanh>(
                         sh3, &w4_h, out, out_bias, batch, seg, units,
                         tile_out, s)
                   : tc::launch_split_fwd<tc::MatrixTiles, kActNone>(
                         sh3, &w4_h, out, out_bias, batch, seg, units,
                         tile_out, s);
      });
}

// An input-gradient product in three passes: out (batch, m) = a1 · w1ᵀ
// [+ a2 · w2ᵀ, one walk joined along k, where a2 is not null], zeroed where
// gate (batch, m) is not > 0 [where gate is not null]; a1, a2 (batch, n),
// w1, w2 (m, n), all fp32; `splits` the halves of a1, w1[, a2, w2] in that
// order.  Tiles 128 x tile_n.
cudaError_t matmul_nt_split(const float* a1, const float* w1,
                            const float* a2, const float* w2,
                            const float* gate, float* out, void* splits,
                            int batch, int n, int m, int tile_n,
                            cudaStream_t s) {
  if (batch <= 0 || splits == nullptr) return cudaErrorInvalidValue;
  SplitPool pool{static_cast<bf16*>(splits)};
  const bool joined = a2 != nullptr;
  const Split sa1 = pool.take(batch, n), sw1 = pool.take(m, n);
  const Split sa2 = joined ? pool.take(batch, n) : sa1;
  const Split sw2 = joined ? pool.take(m, n) : sw1;
  const Halves a[2] = {sa1, sa2}, w[2] = {sw1, sw2};
  return in_order(
      [&] { return split(a1, sa1, nullptr, nullptr, batch, n, s); },
      [&] { return split(w1, sw1, nullptr, nullptr, m, n, s); },
      [&] {
        return joined ? split(a2, sa2, nullptr, nullptr, batch, n, s)
                      : cudaSuccess;
      },
      [&] {
        return joined ? split(w2, sw2, nullptr, nullptr, m, n, s)
                      : cudaSuccess;
      },
      [&] {
        return joined ? tc::launch_split_rows<true>(a, w, out, gate, batch,
                                                    m, n, tile_n, s)
                      : tc::launch_split_rows<false>(a, w, out, gate, batch,
                                                     m, n, tile_n, s);
      });
}

}  // namespace rvk

extern "C" {

// The split pass alone (split.cuh): v (rows, cols) fp32 → hi, lo (rows,
// cols) bf16 and, with `sums`, colsum (cols,) fp32 of v through
// `workspace` (ceil(rows / 64) · cols floats) when rows > 64.  cols a
// multiple of 4, every pointer 16-byte aligned.
int rvk_split_hi_lo(const float* v, void* hi, void* lo, float* colsum,
                    float* workspace, int rows, int cols, int sums,
                    void* stream) {
  return rvk::split_matrix(v, static_cast<rvk::bf16*>(hi),
                           static_cast<rvk::bf16*>(lo),
                           sums ? colsum : nullptr, workspace, rows, cols,
                           static_cast<cudaStream_t>(stream));
}

}  // extern "C"
