// The `high` tier's full backward chains on the tensor cores: the fp32
// forms of rvk_enc_bwd_full and rvk_dec_bwd_full (bwd.cu, kernel code 1),
// every product in three bf16 passes, and the split pass alone as a C entry
// point (rvk_split_hi_lo; ops/mlp.py split_pass).
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

}  // namespace

// The encoder's chain (header): x (batch, seg), h (batch, units), dmu and
// dlv (batch, latent), w21 and w22 (units, latent), all fp32; the scratch
// dh (batch, units) fp32; dw1 (seg, units), db1 (units,), dw21 and dw22
// (units, latent), db21 and db22 (latent,) fp32; `splits` the halves of x,
// h, dmu, dlv, w21, w22 and dh in that order (bf16, 2 · their elements);
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
  const Split sx = pool.take(batch, seg), sh = pool.take(batch, units),
              smu = pool.take(batch, latent), slv = pool.take(batch, latent),
              s21 = pool.take(units, latent), s22 = pool.take(units, latent),
              sdh = pool.take(batch, units);
  const Halves heads[2] = {smu, slv}, weights[2] = {s21, s22};
  const Split heads_b[2] = {smu, slv};
  float* const dw2[2] = {dw21, dw22};
  return in_order(
      [&] { return split(dmu, smu, db21, workspace, batch, latent, s); },
      [&] { return split(dlv, slv, db22, workspace, batch, latent, s); },
      [&] { return split(w21, s21, nullptr, nullptr, units, latent, s); },
      [&] { return split(w22, s22, nullptr, nullptr, units, latent, s); },
      [&] {
        return tc::launch_split_rows<true>(heads, weights, dh, h, batch,
                                           units, latent, tile_dh, s);
      },
      [&] { return split(dh, sdh, db1, workspace, batch, units, s); },
      [&] { return split(x, sx, nullptr, nullptr, batch, seg, s); },
      [&] {
        return wgrad<1>(sx, &sdh, &dw1, workspace, seg, units, batch,
                        tile_dw1, split_dw1, s);
      },
      [&] { return split(h, sh, nullptr, nullptr, batch, units, s); },
      [&] {
        return wgrad<2>(sh, heads_b, dw2, workspace, units, latent, batch,
                        tile_dw2, split_dw2, s);
      });
}

// The decoder's chain (header): da (batch, seg), h3 (batch, units), z
// (batch, latent), w4 (units, seg), w3 (latent, units), all fp32; the
// scratch dh3 (batch, units) and dz (batch, latent) fp32; dw3 (latent,
// units), db3 (units,), dw4 (units, seg), db4 (seg,) fp32; `splits` the
// halves of da, h3, z, w4, w3 and dh3 in that order; `workspace` as for
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
  const Split sda = pool.take(batch, seg), sh3 = pool.take(batch, units),
              sz = pool.take(batch, latent), s4 = pool.take(units, seg),
              s3 = pool.take(latent, units), sdh3 = pool.take(batch, units);
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
      },
      [&] { return split(h3, sh3, nullptr, nullptr, batch, units, s); },
      [&] {
        return wgrad<1>(sh3, &sda, &dw4, workspace, units, seg, batch,
                        tile_dw4, split_dw4, s);
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
