// Int8 weight-only dense decoder, with a plain C interface for ctypes
// (ops/quant.py holds the wrapper and the plain PyTorch version).
//
// Replaces the TPU kernel quantized_decoder_fwd (_qdec_kernel) of
// rawaudiovae_kelsey_tpu/ops/quant.py: y = tanh(relu(z @ (q3*s3) + b3) @
// (q4*s4) + b4), per-output-channel symmetric int8 weights.  The TPU kernel
// holds both int8 matrices in VMEM and dequantizes them there; here the
// tiled GEMM of gemm.cuh reads int8 tiles (a quarter of the fp32 bytes),
// multiplies each by its column's scale as it stages the tile in shared
// memory, and runs the same fp32 FMA loop.  h3 goes to a scratch buffer the
// wrapper allocates.
//
// What bounds it: at small batch the decoder is weight-read bound (2.6 MB of
// int8 against 10.5 MB fp32), which is what the int8 format buys; at the
// serving batch (256) it is fp32-FMA bound like decoder_fwd, and the
// per-element convert-and-scale adds work to every staged B value.

#include "gemm.cuh"

using rvk::Gemm;
using rvk::kKContig;
using rvk::kRContig;
using rvk::launch_gemm;
using rvk::view;

extern "C" {

// z (batch, latent); q3 (latent, units) int8, s3 (units,); q4 (units, seg)
// int8, s4 (seg,); h3 (batch, units) scratch; y (batch, seg).
int rvk_quantized_decoder_fwd(const float* z, const int8_t* q3,
                              const float* s3, const float* b3,
                              const int8_t* q4, const float* s4,
                              const float* b4, float* y, float* h3, int batch,
                              int latent, int units, int seg, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
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

}  // extern "C"
