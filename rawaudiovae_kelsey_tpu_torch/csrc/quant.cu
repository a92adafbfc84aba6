// Int8 weight-only dense decoder, with a plain C interface for ctypes
// (ops/quant.py holds the wrapper and the plain PyTorch version).
//
// Replaces the TPU kernel quantized_decoder_fwd (_qdec_kernel) of
// rawaudiovae_kelsey_tpu/ops/quant.py: y = tanh(relu(z @ (q3*s3) + b3) @
// (q4*s4) + b4), per-output-channel symmetric int8 weights.  The TPU kernel
// holds both int8 matrices in VMEM, dequantizes them there, then multiplies
// with fp32 accumulation; here each layer is one launch and h3 goes to a
// scratch buffer the wrapper allocates.  The op order stays
// dequantize-then-multiply: every weight is q · s rounded once in fp32
// (dequantize_weight's bits) before it meets a product.
//
// Which kernel runs it (the caller's `kernel`, ops/tensor_cores.py):
// * with latent, units and seg multiples of 4 and 16-byte aligned
//   pointers, the register-tiled fp32 mainloop of sgemm.cuh with an int8
//   B (launch_fwd<1, act, int8_t>): q is copied into shared memory as it
//   lies, a quarter of the fp32 bytes, and dequantized once a block as
//   each slab is read back, into the fp32 buffers the k-steps read.  Each
//   layer's tile and slices of its contraction are the fp32 decoder's
//   (ops/tensor_cores.py sgemm_fwd_plan): at the server's 256 rows h3
//   whole on 64 x 64 tiles, y cut into slices of k added in order with the
//   bias and the activation after the sum (slices_epilogue).  With the
//   same plan the k order is the fp32 decoder's, so the result equals
//   rvk_decoder_fwd's fp32 form on the dequantized weights bit for bit;
// * everything else (odd widths, unaligned views) runs the first version:
//   two launches of the tiled GEMM of gemm.cuh, which multiplies each int8
//   value by its column's scale as it stages the tile.
//
// What bounds it: at the serving batch (256) the decoder is 1.34 GFLOP on
// 2.6 MB of int8 weights (10.5 MB fp32) — fp32 FMA throughput, not HBM,
// is the limit (0.0200 ms at 67 TFLOP/s); the int8 format saves ≈ 2.4 us
// of weight reads there and more at small batch, where the decoder is
// weight-read bound.  The dequantization adds one multiply an element a
// block, 1/64 of the block's FFMAs at 64 x 64.

#include "gemm.cuh"
#include "sgemm.cuh"
#include "wgmma.cuh"

using rvk::Gemm;
using rvk::kKContig;
using rvk::kRContig;
using rvk::launch_gemm;
using rvk::view;

namespace {

// The first version: h3 = relu(z @ (q3*s3) + b3), then y = tanh(h3 @
// (q4*s4) + b4), each one launch of gemm.cuh (the int8 tile scaled as it is
// staged).
cudaError_t first_version(const float* z, const int8_t* q3, const float* s3,
                          const float* b3, const int8_t* q4, const float* s4,
                          const float* b4, float* y, float* h3, int batch,
                          int latent, int units, int seg, cudaStream_t s) {
  Gemm<float, int8_t, float> hidden = {};
  hidden.a = view(z, latent, latent);
  hidden.out[0].b = view(q3, units, latent);
  hidden.out[0].scale = s3;
  hidden.out[0].bias = b3;
  hidden.out[0].c = h3;
  hidden.M = batch, hidden.N = units, hidden.K = latent;
  hidden.act = rvk::kActRelu;
  cudaError_t err = launch_gemm<kKContig, kRContig>(hidden, 1, s);
  if (err != cudaSuccess) return err;
  Gemm<float, int8_t, float> out = {};
  out.a = view<float>(h3, units, units);
  out.out[0].b = view(q4, seg, units);
  out.out[0].scale = s4;
  out.out[0].bias = b4;
  out.out[0].c = y;
  out.M = batch, out.N = seg, out.K = units;
  out.act = rvk::kActTanh;
  return launch_gemm<kKContig, kRContig>(out, 1, s);
}

// The form on sgemm.cuh: h3 on tile kTiles[tile_hidden] over split_hidden
// slices of latent, then y from h3 on kTiles[tile_out] over split_out
// slices of units, each with the int8 B dequantized as it is read back;
// `workspace` as for rvk_decoder_fwd's fp32 form.
cudaError_t sgemm_decoder(const float* z, const int8_t* q3, const float* s3,
                          const float* b3, const int8_t* q4, const float* s4,
                          const float* b4, float* y, float* h3,
                          float* workspace, int batch, int latent, int units,
                          int seg, int split_hidden, int split_out,
                          int tile_hidden, int tile_out, cudaStream_t s) {
  rvk::sgemm::OutsOf<int8_t> hidden{};
  hidden.b[0] = q3;
  hidden.scale[0] = s3;
  hidden.bias[0] = b3;
  hidden.c[0] = h3;
  const cudaError_t err =
      rvk::sgemm::launch_fwd<1, rvk::kActRelu, int8_t>(
          z, hidden, workspace, batch, units, latent, tile_hidden,
          split_hidden, s);
  if (err != cudaSuccess) return err;
  rvk::sgemm::OutsOf<int8_t> out{};
  out.b[0] = q4;
  out.scale[0] = s4;
  out.bias[0] = b4;
  out.c[0] = y;
  return rvk::sgemm::launch_fwd<1, rvk::kActTanh, int8_t>(
      h3, out, workspace, batch, seg, units, tile_out, split_out, s);
}

}  // namespace

extern "C" {

// z (batch, latent); q3 (latent, units) int8, s3 (units,); q4 (units, seg)
// int8, s4 (seg,); biases b3 (units,), b4 (seg,); y (batch, seg); h3
// (batch, units) scratch; all but q3 and q4 fp32.  kernel (an
// rvk::tc::Kernel): 0, the two launches of the tiled GEMM on the CUDA cores
// (tiles, splits and workspace ignored); 2, the form of sgemm.cuh with an
// int8 B, latent, units and seg multiples of 4, 16-byte aligned pointers:
// h3 on the tile sgemm::kTiles[tile_hidden] over split_hidden slices of
// latent, y on kTiles[tile_out] over split_out slices of units, through
// `workspace` where a split is more than 1 (max(split_hidden · batch ·
// units, split_out · batch · seg) floats; ops/tensor_cores.py
// sgemm_fwd_plan).  Any other code is refused.
int rvk_quantized_decoder_fwd(const float* z, const int8_t* q3,
                              const float* s3, const float* b3,
                              const int8_t* q4, const float* s4,
                              const float* b4, float* y, float* h3,
                              float* workspace, int batch, int latent,
                              int units, int seg, int split_hidden,
                              int split_out, int tile_hidden, int tile_out,
                              int kernel, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kernel == rvk::tc::kSgemm) {
    return sgemm_decoder(z, q3, s3, b3, q4, s4, b4, y, h3, workspace, batch,
                         latent, units, seg, split_hidden, split_out,
                         tile_hidden, tile_out, s);
  }
  if (kernel != rvk::tc::kCudaCores) return cudaErrorInvalidValue;
  return first_version(z, q3, s3, b3, q4, s4, b4, y, h3, batch, latent,
                       units, seg, s);
}

}  // extern "C"
