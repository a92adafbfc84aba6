// Dense-VAE forward kernels, fp32, with a plain C interface for ctypes
// (ops/_build.py loads the library; ops/mlp.py holds the wrappers and the
// plain PyTorch versions they are checked against).
//
// rvk_encoder_fwd replaces the TPU kernel encoder_fwd (_enc_fwd_kernel) of
// rawaudiovae_kelsey_tpu/ops/pallas_mlp.py; rvk_decoder_fwd replaces
// decoder_fwd (_dec_fwd_kernel) there.  The TPU kernels pin every weight in
// VMEM for the whole batch grid; on this card W1 alone (8 MB fp32) is ~36x
// a block's shared memory, so each chain runs as two launches of the tiled
// GEMM of gemm.cuh, and the hidden activation (h / h3, an output of the
// TPU kernels too) goes through device memory between them.
//
// What bounds them: at the serving batch (256) and full width
// (1024/2048/256) the encoder does 1.61 GFLOP on 12.6 MB of weights, the
// decoder 1.34 GFLOP on 10.5 MB — ~128 FLOP per weight byte against a
// ridge of ~20 (67 TFLOP/s fp32 on the CUDA cores over 3.35 TB/s), so fp32
// FMA throughput, not HBM, is the limit; h is re-read from the 50 MB L2,
// not HBM.  The design's
// answer is register tiling (each shared-memory value feeds 2-4 FMAs) and
// tile sizes that keep every SM busy at batch 256.

#include "gemm.cuh"

using rvk::GemmOuts;
using rvk::launch_gemm;

extern "C" {

const char* rvk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// h = relu(x @ w1 + b1); mu = h @ w21 + b21; logvar = h @ w22 + b22.
// x (batch, seg); w1 (seg, units); w21, w22 (units, latent).
int rvk_encoder_fwd(const float* x, const float* w1, const float* b1,
                    const float* w21, const float* b21, const float* w22,
                    const float* b22, float* mu, float* logvar, float* h,
                    int batch, int seg, int units, int latent, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  GemmOuts<float> hidden = {};
  hidden.out[0] = {w1, nullptr, b1, h};
  cudaError_t err = launch_gemm(x, hidden, 1, batch, units, seg,
                                rvk::kActRelu, s);
  if (err != cudaSuccess) return err;
  GemmOuts<float> heads = {};
  heads.out[0] = {w21, nullptr, b21, mu};
  heads.out[1] = {w22, nullptr, b22, logvar};
  return launch_gemm(h, heads, 2, batch, latent, units, rvk::kActNone, s);
}

// h3 = relu(z @ w3 + b3); y = tanh(h3 @ w4 + b4).
// z (batch, latent); w3 (latent, units); w4 (units, seg).
int rvk_decoder_fwd(const float* z, const float* w3, const float* b3,
                    const float* w4, const float* b4, float* y, float* h3,
                    int batch, int latent, int units, int seg, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  GemmOuts<float> hidden = {};
  hidden.out[0] = {w3, nullptr, b3, h3};
  cudaError_t err = launch_gemm(z, hidden, 1, batch, units, latent,
                                rvk::kActRelu, s);
  if (err != cudaSuccess) return err;
  GemmOuts<float> out = {};
  out.out[0] = {w4, nullptr, b4, y};
  return launch_gemm(h3, out, 1, batch, seg, units, rvk::kActTanh, s);
}

}  // extern "C"
