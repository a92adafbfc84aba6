// Dense-VAE forward kernels, fp32 or bf16 operands, with a plain C
// interface for ctypes (ops/_build.py loads the library; ops/mlp.py holds
// the wrappers and the plain PyTorch versions they are checked against).
//
// rvk_encoder_fwd replaces the TPU kernel encoder_fwd (_enc_fwd_kernel) of
// rawaudiovae_kelsey_tpu/ops/pallas_mlp.py; rvk_decoder_fwd replaces
// decoder_fwd (_dec_fwd_kernel) there.  The TPU kernels pin every weight in
// VMEM for the whole batch grid; on this card W1 alone (8 MB fp32) is ~36x
// a block's shared memory, so each chain runs as two launches, and the
// hidden activation (h / h3, an output of the TPU kernels too) goes through
// device memory between them.
//
// Which kernel runs them (the caller's `kernel`, ops/tensor_cores.py):
// * the encoder's bf16 form, with seg, units and latent multiples of 8 and
//   16-byte aligned pointers, takes the tensor-core mainloop of wgmma.cuh:
//   h = relu(x @ w1 + b1) as one launch of the linear layer's form (bias
//   and ReLU in the epilogue), then BOTH heads in one launch (HeadsTiles:
//   mu's tile columns, then logvar's, each reading its own W and writing
//   its own output, the bias of its head in the epilogue).  At the training
//   microbatch (8192, latent 256) that is 128 tiles of 128 x 256 in one
//   wave of the 132 SMs, where a launch a head would run 64 tiles twice;
// * the decoder's bf16 form, under the same conditions, takes it too: h3 =
//   relu(z @ w3 + b3), then y = tanh(h3 @ w4 + b4), each one launch of the
//   linear layer's form;
// * the fp32 forms, with the widths multiples of 4 and 16-byte aligned
//   pointers, take the register-tiled fp32 mainloop of sgemm.cuh (IEEE
//   FFMAs: the fp32 tiers promise IEEE fp32 products, so no TF32): h =
//   relu(x @ w1 + b1), then both heads in ONE launch whose tile columns run
//   over mu's then logvar's (sgemm_heads_kernel: at the training microbatch
//   one head is 128 tiles of 128 x 128, under half of one wave of two blocks
//   an SM, both heads one wave); h3 = relu(z @ w3 + b3), then y = tanh(h3 @
//   w4 + b4).  Each product's tile and the slices of its contraction are
//   the caller's (ops/tensor_cores.py sgemm_fwd_plan): at the server's 256
//   rows a product may be cut into slices along k, added in order through a
//   workspace with the bias and the activation after the sum
//   (sgemm::launch_fwd); at the training microbatch every product fills the
//   card in one slice;
// * everything else (odd widths, unaligned views) runs the first version:
//   two launches of the tiled GEMM of gemm.cuh on the CUDA cores, the
//   encoder's second computing both heads (Gemm::out[0..1]).
//
// The `high` tier's forms, rvk_encoder_fwd3 and rvk_decoder_fwd3 (fp32
// operands, every product in three bf16 passes, as the TPU kernels run
// under JAX's ambient `high` tier, pallas_mlp.py:167 _ambient_passes):
// with the widths multiples of 8 and 16-byte aligned pointers, the chains
// of full.cu on the tensor cores (the split pass, then each product one
// 3-pass launch of wgmma.cuh with the bias and the activation after the
// three-pass sum, h and h3 fp32 and split again); everything else the
// first version in gemm.cuh's 3-pass operand mode.  Neither takes the IEEE
// fp32 kernel of sgemm.cuh.
//
// Types, as the TPU kernels do them: fp32 accumulation; the bias added and
// the activation applied in fp32; every output (h, mu, logvar, h3, y) in the
// operand dtype, rounded once.  h and h3 are rounded before they feed the
// next layer (pallas_mlp.py:238-242, 289), so the heads and fc4 read the
// same bf16 values the backward later reads back.
//
// What bounds them: at the serving batch (256) and full width
// (1024/2048/256) the encoder does 1.61 GFLOP on 12.6 MB of weights, the
// decoder 1.34 GFLOP on 10.5 MB — ~128 FLOP per weight byte against a
// ridge of ~20 (67 TFLOP/s fp32 on the CUDA cores over 3.35 TB/s), so fp32
// FMA throughput, not HBM, is the limit; h is re-read from the 50 MB L2,
// not HBM.  At the training microbatch (8192, bf16) the FLOPs per byte only
// grow, so the same holds: 51.5 GFLOP for the encoder, 0.052 ms at the
// tensor cores' 989 TFLOP/s.  The first version's answer is register tiling
// (each shared-memory value feeds 2-4 FMAs) and tile sizes that keep every
// SM busy at batch 256.

#include "gemm.cuh"
#include "sgemm.cuh"
#include "wgmma.cuh"

using rvk::dst;
using rvk::Gemm;
using rvk::kKContig;
using rvk::kRContig;
using rvk::launch_gemm;
using rvk::src;
using rvk::view;

namespace rvk {
// the `high` tier's forward chains on the tensor cores (full.cu)
cudaError_t encoder_split(const float* x, const float* w1, const float* b1,
                          const float* w21, const float* b21,
                          const float* w22, const float* b22, float* mu,
                          float* logvar, float* h, void* splits, int batch,
                          int seg, int units, int latent, int tile_hidden,
                          int tile_heads, cudaStream_t s);
cudaError_t decoder_split(const float* z, const float* w3, const float* b3,
                          const float* w4, const float* b4, float* y,
                          float* h3, void* splits, int batch, int latent,
                          int units, int seg, int tile_hidden, int tile_out,
                          cudaStream_t s);
}  // namespace rvk

namespace {

// h = relu(x @ w1 + b1); mu = h @ w21 + b21; logvar = h @ w22 + b22.
template <typename T, int kPasses = 1>
cudaError_t encoder_fwd(const T* x, const T* w1, const T* b1, const T* w21,
                        const T* b21, const T* w22, const T* b22, T* mu,
                        T* logvar, T* h, int batch, int seg, int units,
                        int latent, cudaStream_t s) {
  Gemm<T, T, T> hidden = {};
  hidden.a = view(x, seg, seg);
  hidden.out[0].b = view(w1, units, seg);
  hidden.out[0].bias = b1;
  hidden.out[0].c = h;
  hidden.M = batch, hidden.N = units, hidden.K = seg;
  hidden.act = rvk::kActRelu;
  cudaError_t err = launch_gemm<kKContig, kRContig, kPasses>(hidden, 1, s);
  if (err != cudaSuccess) return err;
  Gemm<T, T, T> heads = {};
  heads.a = view<T>(h, units, units);
  heads.out[0].b = view(w21, latent, units);
  heads.out[0].bias = b21;
  heads.out[0].c = mu;
  heads.out[1].b = view(w22, latent, units);
  heads.out[1].bias = b22;
  heads.out[1].c = logvar;
  heads.M = batch, heads.N = latent, heads.K = units;
  heads.act = rvk::kActNone;
  return launch_gemm<kKContig, kRContig, kPasses>(heads, 2, s);
}

// h3 = relu(z @ w3 + b3); y = tanh(h3 @ w4 + b4).
template <typename T, int kPasses = 1>
cudaError_t decoder_fwd(const T* z, const T* w3, const T* b3, const T* w4,
                        const T* b4, T* y, T* h3, int batch, int latent,
                        int units, int seg, cudaStream_t s) {
  Gemm<T, T, T> hidden = {};
  hidden.a = view(z, latent, latent);
  hidden.out[0].b = view(w3, units, latent);
  hidden.out[0].bias = b3;
  hidden.out[0].c = h3;
  hidden.M = batch, hidden.N = units, hidden.K = latent;
  hidden.act = rvk::kActRelu;
  cudaError_t err = launch_gemm<kKContig, kRContig, kPasses>(hidden, 1, s);
  if (err != cudaSuccess) return err;
  Gemm<T, T, T> out = {};
  out.a = view<T>(h3, units, units);
  out.out[0].b = view(w4, seg, units);
  out.out[0].bias = b4;
  out.out[0].c = y;
  out.M = batch, out.N = seg, out.K = units;
  out.act = rvk::kActTanh;
  return launch_gemm<kKContig, kRContig, kPasses>(out, 1, s);
}

// The tensor-core form of the encoder: bf16 only, the biases 4-byte
// aligned (their pairs are single loads); the hidden product in tiles 128 x
// tile_hidden, the heads in tiles 128 x tile_heads.
int tensor_core_encoder(const void* x, const void* w1, const void* b1,
                        const void* w21, const void* b21, const void* w22,
                        const void* b22, void* mu, void* logvar, void* h,
                        int batch, int seg, int units, int latent, int dtype,
                        int tile_hidden, int tile_heads, cudaStream_t s) {
  if (dtype != rvk::kBF16 ||
      (reinterpret_cast<uintptr_t>(b1) | reinterpret_cast<uintptr_t>(b21) |
       reinterpret_cast<uintptr_t>(b22)) % 4 != 0) {
    return cudaErrorInvalidValue;
  }
  using T = rvk::bf16;
  const cudaError_t err = rvk::tc::launch_wgmma<true>(
      src<T>(x), src<T>(w1), dst<T>(h),
      rvk::tc::BiasActPair{src<T>(b1), rvk::kActRelu}, batch, units, seg,
      tile_hidden, s);
  if (err != cudaSuccess) return err;
  return rvk::tc::launch_heads(
      dst<T>(h), src<T>(w21), src<T>(w22), dst<T>(mu), dst<T>(logvar),
      rvk::tc::HeadsBias{src<T>(b21), src<T>(b22), latent}, batch, latent,
      units, tile_heads, s);
}

// The tensor-core form of the decoder: bf16 only, the biases 4-byte
// aligned; h3 = relu(z @ w3 + b3) in tiles 128 x tile_hidden, then y =
// tanh(h3 @ w4 + b4) from the rounded h3 in tiles 128 x tile_out, both the
// linear layer's launch (w3 and w4 are (in, out): N-major B).  At the
// training microbatch the first product has K = latent = 256, four k-steps a
// tile: the ring runs on across tiles, so the loads of the next tile overlap
// this one's epilogue.
int tensor_core_decoder(const void* z, const void* w3, const void* b3,
                        const void* w4, const void* b4, void* y, void* h3,
                        int batch, int latent, int units, int seg, int dtype,
                        int tile_hidden, int tile_out, cudaStream_t s) {
  if (dtype != rvk::kBF16 ||
      (reinterpret_cast<uintptr_t>(b3) | reinterpret_cast<uintptr_t>(b4)) %
              4 != 0) {
    return cudaErrorInvalidValue;
  }
  using T = rvk::bf16;
  const cudaError_t err = rvk::tc::launch_wgmma<true>(
      src<T>(z), src<T>(w3), dst<T>(h3),
      rvk::tc::BiasActPair{src<T>(b3), rvk::kActRelu}, batch, units, latent,
      tile_hidden, s);
  if (err != cudaSuccess) return err;
  return rvk::tc::launch_wgmma<true>(
      dst<T>(h3), src<T>(w4), dst<T>(y),
      rvk::tc::BiasActPair{src<T>(b4), rvk::kActTanh}, batch, seg, units,
      tile_out, s);
}

// The row-parallel forms (tensor parallelism: parallel/tensor_parallel.py).
// Under the Megatron split the heads and fc4 hold a slice of the hidden
// units' rows, so each rank's product is a partial sum: these forms compute
// the hidden layer as the full forms do (bias and ReLU in its epilogue, one
// rounding to the operand dtype), then the second product's sums in fp32
// as they are, no bias, no activation.  The caller adds the ranks' sums
// (one fp32 all-reduce), then the bias, the activation and the one
// rounding.

// The first version: the hidden layer as encoder_fwd / decoder_fwd's, the
// second product a Gemm with an fp32 output and no bias.
template <typename T, int kPasses = 1>
cudaError_t encoder_fwd_partial(const T* x, const T* w1, const T* b1,
                                const T* w21, const T* w22, float* mu,
                                float* logvar, T* h, int batch, int seg,
                                int units, int latent, cudaStream_t s) {
  Gemm<T, T, T> hidden = {};
  hidden.a = view(x, seg, seg);
  hidden.out[0].b = view(w1, units, seg);
  hidden.out[0].bias = b1;
  hidden.out[0].c = h;
  hidden.M = batch, hidden.N = units, hidden.K = seg;
  hidden.act = rvk::kActRelu;
  cudaError_t err = launch_gemm<kKContig, kRContig, kPasses>(hidden, 1, s);
  if (err != cudaSuccess) return err;
  Gemm<T, T, float> heads = {};
  heads.a = view<T>(h, units, units);
  heads.out[0].b = view(w21, latent, units);
  heads.out[0].c = mu;
  heads.out[1].b = view(w22, latent, units);
  heads.out[1].c = logvar;
  heads.M = batch, heads.N = latent, heads.K = units;
  heads.act = rvk::kActNone;
  return launch_gemm<kKContig, kRContig, kPasses>(heads, 2, s);
}

template <typename T, int kPasses = 1>
cudaError_t decoder_fwd_partial(const T* z, const T* w3, const T* b3,
                                const T* w4, float* y, T* h3, int batch,
                                int latent, int units, int seg,
                                cudaStream_t s) {
  Gemm<T, T, T> hidden = {};
  hidden.a = view(z, latent, latent);
  hidden.out[0].b = view(w3, units, latent);
  hidden.out[0].bias = b3;
  hidden.out[0].c = h3;
  hidden.M = batch, hidden.N = units, hidden.K = latent;
  hidden.act = rvk::kActRelu;
  cudaError_t err = launch_gemm<kKContig, kRContig, kPasses>(hidden, 1, s);
  if (err != cudaSuccess) return err;
  Gemm<T, T, float> out = {};
  out.a = view<T>(h3, units, units);
  out.out[0].b = view(w4, seg, units);
  out.out[0].c = y;
  out.M = batch, out.N = seg, out.K = units;
  out.act = rvk::kActNone;
  return launch_gemm<kKContig, kRContig, kPasses>(out, 1, s);
}

// The tensor-core forms: the hidden layer as tensor_core_encoder /
// tensor_core_decoder launch it, then the heads (HeadsTiles, both in one
// launch) or y (MatrixTiles) with the PartialRows epilogue of wgmma.cuh.
int tensor_core_encoder_partial(const void* x, const void* w1,
                                const void* b1, const void* w21,
                                const void* w22, float* mu, float* logvar,
                                void* h, int batch, int seg, int units,
                                int latent, int dtype, int tile_hidden,
                                int tile_heads, cudaStream_t s) {
  if (dtype != rvk::kBF16 || reinterpret_cast<uintptr_t>(b1) % 4 != 0) {
    return cudaErrorInvalidValue;
  }
  using T = rvk::bf16;
  const cudaError_t err = rvk::tc::launch_wgmma<true>(
      src<T>(x), src<T>(w1), dst<T>(h),
      rvk::tc::BiasActPair{src<T>(b1), rvk::kActRelu}, batch, units, seg,
      tile_hidden, s);
  if (err != cudaSuccess) return err;
  const T* const b[2] = {src<T>(w21), src<T>(w22)};
  float* const c[2] = {mu, logvar};
  return rvk::tc::launch_partial<rvk::tc::HeadsTiles>(
      dst<T>(h), b, c, batch, latent, units, tile_heads, s);
}

int tensor_core_decoder_partial(const void* z, const void* w3,
                                const void* b3, const void* w4, float* y,
                                void* h3, int batch, int latent, int units,
                                int seg, int dtype, int tile_hidden,
                                int tile_out, cudaStream_t s) {
  if (dtype != rvk::kBF16 || reinterpret_cast<uintptr_t>(b3) % 4 != 0) {
    return cudaErrorInvalidValue;
  }
  using T = rvk::bf16;
  const cudaError_t err = rvk::tc::launch_wgmma<true>(
      src<T>(z), src<T>(w3), dst<T>(h3),
      rvk::tc::BiasActPair{src<T>(b3), rvk::kActRelu}, batch, units, latent,
      tile_hidden, s);
  if (err != cudaSuccess) return err;
  const T* const b[1] = {src<T>(w4)};
  float* const c[1] = {y};
  return rvk::tc::launch_partial<rvk::tc::MatrixTiles>(
      dst<T>(h3), b, c, batch, seg, units, tile_out, s);
}

// The fp32 form of the decoder's partial sums on sgemm.cuh: h3 as
// sgemm_decoder computes it, then y's sums with no bias and no activation
// (the encoder's is sgemm_encoder with no head biases: its heads' epilogue
// adds nothing else).
int sgemm_decoder_partial(const void* z, const void* w3, const void* b3,
                          const void* w4, float* y, void* h3,
                          float* workspace, int batch, int latent, int units,
                          int seg, int dtype, int split_hidden,
                          int split_out, int tile_hidden, int tile_out,
                          cudaStream_t s) {
  if (dtype != rvk::kF32) return cudaErrorInvalidValue;
  rvk::sgemm::Outs hidden{};
  hidden.b[0] = src<float>(w3);
  hidden.bias[0] = src<float>(b3);
  hidden.c[0] = dst<float>(h3);
  const cudaError_t err = rvk::sgemm::launch_fwd<1, rvk::kActRelu>(
      src<float>(z), hidden, workspace, batch, units, latent, tile_hidden,
      split_hidden, s);
  if (err != cudaSuccess) return err;
  rvk::sgemm::Outs out{};
  out.b[0] = src<float>(w4);
  out.bias[0] = nullptr;
  out.c[0] = y;
  return rvk::sgemm::launch_fwd<1, rvk::kActNone>(
      dst<float>(h3), out, workspace, batch, seg, units, tile_out, split_out,
      s);
}

// The fp32 form of the encoder on sgemm.cuh: h in one launch on tile
// kTiles[tile_hidden] over split_hidden slices of seg, then both heads in
// one launch on tile kTiles[tile_heads] over split_heads slices of units;
// a split product goes through `workspace` (max(split_hidden · batch ·
// units, 2 · split_heads · batch · latent) floats; null when both are 1).
int sgemm_encoder(const void* x, const void* w1, const void* b1,
                  const void* w21, const void* b21, const void* w22,
                  const void* b22, void* mu, void* logvar, void* h,
                  float* workspace, int batch, int seg, int units, int latent,
                  int dtype, int split_hidden, int split_heads,
                  int tile_hidden, int tile_heads, cudaStream_t s) {
  if (dtype != rvk::kF32) return cudaErrorInvalidValue;
  rvk::sgemm::Outs hidden{};
  hidden.b[0] = src<float>(w1);
  hidden.bias[0] = src<float>(b1);
  hidden.c[0] = dst<float>(h);
  const cudaError_t err = rvk::sgemm::launch_fwd<1, rvk::kActRelu>(
      src<float>(x), hidden, workspace, batch, units, seg, tile_hidden,
      split_hidden, s);
  if (err != cudaSuccess) return err;
  rvk::sgemm::Outs heads{};
  heads.b[0] = src<float>(w21), heads.b[1] = src<float>(w22);
  heads.bias[0] = src<float>(b21), heads.bias[1] = src<float>(b22);
  heads.c[0] = dst<float>(mu), heads.c[1] = dst<float>(logvar);
  return rvk::sgemm::launch_fwd<2, rvk::kActNone>(
      dst<float>(h), heads, workspace, batch, latent, units, tile_heads,
      split_heads, s);
}

// The fp32 form of the decoder on sgemm.cuh: h3 in one launch on tile
// kTiles[tile_hidden] over split_hidden slices of latent, then y from h3 on
// tile kTiles[tile_out] over split_out slices of units, as the first
// version reads it (fp32: no rounding between the layers); `workspace` as
// for the encoder (max(split_hidden · batch · units, split_out · batch ·
// seg) floats).
int sgemm_decoder(const void* z, const void* w3, const void* b3,
                  const void* w4, const void* b4, void* y, void* h3,
                  float* workspace, int batch, int latent, int units,
                  int seg, int dtype, int split_hidden, int split_out,
                  int tile_hidden, int tile_out, cudaStream_t s) {
  if (dtype != rvk::kF32) return cudaErrorInvalidValue;
  rvk::sgemm::Outs hidden{};
  hidden.b[0] = src<float>(w3);
  hidden.bias[0] = src<float>(b3);
  hidden.c[0] = dst<float>(h3);
  const cudaError_t err = rvk::sgemm::launch_fwd<1, rvk::kActRelu>(
      src<float>(z), hidden, workspace, batch, units, latent, tile_hidden,
      split_hidden, s);
  if (err != cudaSuccess) return err;
  rvk::sgemm::Outs out{};
  out.b[0] = src<float>(w4);
  out.bias[0] = src<float>(b4);
  out.c[0] = dst<float>(y);
  return rvk::sgemm::launch_fwd<1, rvk::kActTanh>(
      dst<float>(h3), out, workspace, batch, seg, units, tile_out, split_out,
      s);
}

}  // namespace

extern "C" {

const char* rvk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x (batch, seg); w1 (seg, units); w21, w22 (units, latent); outputs mu,
// logvar (batch, latent) and h (batch, units).  All of one dtype (rvk::DType).
// kernel (an rvk::tc::Kernel): 0, the two launches of the tiled GEMM on the
// CUDA cores (tiles, splits and workspace ignored); 1, the tensor-core
// form, bf16 only, seg, units and latent multiples of 8, 16-byte aligned
// pointers: h in tiles 128 x tile_hidden, both heads in one launch in tiles
// 128 x tile_heads (256, 128 or 64 each; ops/tensor_cores.py tile_n;
// splits and workspace ignored); 2, the fp32 form of sgemm.cuh, fp32 only,
// seg, units and latent multiples of 4, 16-byte aligned pointers: h on the
// tile sgemm::kTiles[tile_hidden] over split_hidden slices of seg, both
// heads in one launch on kTiles[tile_heads] over split_heads slices of
// units, through `workspace` where a split is more than 1 (max(split_hidden
// · batch · units, 2 · split_heads · batch · latent) floats;
// ops/tensor_cores.py sgemm_fwd_plan).
int rvk_encoder_fwd(const void* x, const void* w1, const void* b1,
                    const void* w21, const void* b21, const void* w22,
                    const void* b22, void* mu, void* logvar, void* h,
                    float* workspace, int batch, int seg, int units,
                    int latent, int dtype, int split_hidden, int split_heads,
                    int tile_hidden, int tile_heads, int kernel,
                    void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kernel == rvk::tc::kSgemm) {
    return sgemm_encoder(x, w1, b1, w21, b21, w22, b22, mu, logvar, h,
                         workspace, batch, seg, units, latent, dtype,
                         split_hidden, split_heads, tile_hidden, tile_heads,
                         s);
  }
  if (kernel != rvk::tc::kCudaCores) {
    if (kernel != rvk::tc::kTensorCores) return cudaErrorInvalidValue;
    return tensor_core_encoder(x, w1, b1, w21, b21, w22, b22, mu, logvar, h,
                               batch, seg, units, latent, dtype, tile_hidden,
                               tile_heads, s);
  }
  return rvk::with_dtype(dtype, [&](auto tag) {
    using T = std::remove_pointer_t<decltype(tag)>;
    return encoder_fwd(src<T>(x), src<T>(w1), src<T>(b1), src<T>(w21),
                       src<T>(b21), src<T>(w22), src<T>(b22), dst<T>(mu),
                       dst<T>(logvar), dst<T>(h), batch, seg, units, latent,
                       s);
  });
}

// z (batch, latent); w3 (latent, units); w4 (units, seg); outputs y
// (batch, seg) and h3 (batch, units).  All of one dtype.  kernel: 0, the
// two launches of the tiled GEMM on the CUDA cores (tiles, splits and
// workspace ignored); 1, the tensor-core form, bf16 only, latent, units and
// seg multiples of 8, 16-byte aligned pointers: h3 in tiles 128 x
// tile_hidden, y in tiles 128 x tile_out (ops/tensor_cores.py tile_n;
// splits and workspace ignored); 2, the fp32 form of sgemm.cuh, fp32 only,
// latent, units and seg multiples of 4, 16-byte aligned pointers: h3 on the
// tile sgemm::kTiles[tile_hidden] over split_hidden slices of latent, y on
// kTiles[tile_out] over split_out slices of units, through `workspace`
// where a split is more than 1 (max(split_hidden · batch · units, split_out
// · batch · seg) floats; ops/tensor_cores.py sgemm_fwd_plan).
int rvk_decoder_fwd(const void* z, const void* w3, const void* b3,
                    const void* w4, const void* b4, void* y, void* h3,
                    float* workspace, int batch, int latent, int units,
                    int seg, int dtype, int split_hidden, int split_out,
                    int tile_hidden, int tile_out, int kernel,
                    void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kernel == rvk::tc::kSgemm) {
    return sgemm_decoder(z, w3, b3, w4, b4, y, h3, workspace, batch, latent,
                         units, seg, dtype, split_hidden, split_out,
                         tile_hidden, tile_out, s);
  }
  if (kernel != rvk::tc::kCudaCores) {
    if (kernel != rvk::tc::kTensorCores) return cudaErrorInvalidValue;
    return tensor_core_decoder(z, w3, b3, w4, b4, y, h3, batch, latent,
                               units, seg, dtype, tile_hidden, tile_out, s);
  }
  return rvk::with_dtype(dtype, [&](auto tag) {
    using T = std::remove_pointer_t<decltype(tag)>;
    return decoder_fwd(src<T>(z), src<T>(w3), src<T>(b3), src<T>(w4),
                       src<T>(b4), dst<T>(y), dst<T>(h3), batch, latent,
                       units, seg, s);
  });
}

// The row-parallel form of rvk_encoder_fwd (above, "the row-parallel
// forms"): x (batch, seg); w1 (seg, units) and b1 (units,) a rank's column
// shard, h (batch, units) as rvk_encoder_fwd writes it; w21, w22 (units,
// latent) a rank's row shard; mu and logvar (batch, latent) fp32 partial
// sums h @ w21, h @ w22, no bias.  kernel, tiles, splits and workspace as
// for rvk_encoder_fwd (code 2: no head biases in sgemm_encoder).
int rvk_encoder_fwd_partial(const void* x, const void* w1, const void* b1,
                            const void* w21, const void* w22, float* mu,
                            float* logvar, void* h, float* workspace,
                            int batch, int seg, int units, int latent,
                            int dtype, int split_hidden, int split_heads,
                            int tile_hidden, int tile_heads, int kernel,
                            void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kernel == rvk::tc::kSgemm) {
    return sgemm_encoder(x, w1, b1, w21, nullptr, w22, nullptr, mu, logvar,
                         h, workspace, batch, seg, units, latent, dtype,
                         split_hidden, split_heads, tile_hidden, tile_heads,
                         s);
  }
  if (kernel != rvk::tc::kCudaCores) {
    if (kernel != rvk::tc::kTensorCores) return cudaErrorInvalidValue;
    return tensor_core_encoder_partial(x, w1, b1, w21, w22, mu, logvar, h,
                                       batch, seg, units, latent, dtype,
                                       tile_hidden, tile_heads, s);
  }
  return rvk::with_dtype(dtype, [&](auto tag) {
    using T = std::remove_pointer_t<decltype(tag)>;
    return encoder_fwd_partial(src<T>(x), src<T>(w1), src<T>(b1),
                               src<T>(w21), src<T>(w22), mu, logvar,
                               dst<T>(h), batch, seg, units, latent, s);
  });
}

// The row-parallel form of rvk_decoder_fwd: z (batch, latent); w3 (latent,
// units) and b3 (units,) a rank's column shard, h3 (batch, units) as
// rvk_decoder_fwd writes it; w4 (units, seg) a rank's row shard; y (batch,
// seg) the fp32 partial sums h3 @ w4, no bias, no tanh.  kernel, tiles,
// splits and workspace as for rvk_decoder_fwd.
int rvk_decoder_fwd_partial(const void* z, const void* w3, const void* b3,
                            const void* w4, float* y, void* h3,
                            float* workspace, int batch, int latent,
                            int units, int seg, int dtype, int split_hidden,
                            int split_out, int tile_hidden, int tile_out,
                            int kernel, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kernel == rvk::tc::kSgemm) {
    return sgemm_decoder_partial(z, w3, b3, w4, y, h3, workspace, batch,
                                 latent, units, seg, dtype, split_hidden,
                                 split_out, tile_hidden, tile_out, s);
  }
  if (kernel != rvk::tc::kCudaCores) {
    if (kernel != rvk::tc::kTensorCores) return cudaErrorInvalidValue;
    return tensor_core_decoder_partial(z, w3, b3, w4, y, h3, batch, latent,
                                       units, seg, dtype, tile_hidden,
                                       tile_out, s);
  }
  return rvk::with_dtype(dtype, [&](auto tag) {
    using T = std::remove_pointer_t<decltype(tag)>;
    return decoder_fwd_partial(src<T>(z), src<T>(w3), src<T>(b3),
                               src<T>(w4), y, dst<T>(h3), batch, latent,
                               units, seg, s);
  });
}

// The `high` tier's encoder (above, "the `high` tier's forms"): x (batch,
// seg), w1 (seg, units), b1 (units,), w21, w22 (units, latent), b21, b22
// (latent,), outputs mu, logvar (batch, latent) and h (batch, units), all
// fp32; every product in three bf16 passes, the bias after the three-pass
// sum, then the activation; h stays fp32 and the heads read its halves.
// b21 and b22 null: the row-parallel form (the heads' fp32 partial sums,
// no bias).  kernel: 0, the first version (gemm.cuh's 3-pass mode; tiles
// and splits ignored); 1, the tensor cores, seg, units and latent
// multiples of 8, 16-byte aligned pointers, batch > 0 (full.cu
// encoder_split: `splits` the bf16 halves of x, w1, w21, w22 and h, 2 ·
// their elements; h in tiles 128 x tile_hidden, both heads in one launch
// of 128 x tile_heads, 128 or 64 each, ops/tensor_cores.py split_tile).
int rvk_encoder_fwd3(const void* x, const void* w1, const void* b1,
                     const void* w21, const void* b21, const void* w22,
                     const void* b22, void* mu, void* logvar, void* h,
                     void* splits, int batch, int seg, int units, int latent,
                     int tile_hidden, int tile_heads, int kernel,
                     void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((b21 == nullptr) != (b22 == nullptr)) return cudaErrorInvalidValue;
  if (kernel == rvk::tc::kTensorCores) {
    return rvk::encoder_split(
        src<float>(x), src<float>(w1), src<float>(b1), src<float>(w21),
        src<float>(b21), src<float>(w22), src<float>(b22), dst<float>(mu),
        dst<float>(logvar), dst<float>(h), splits, batch, seg, units, latent,
        tile_hidden, tile_heads, s);
  }
  if (kernel != rvk::tc::kCudaCores) return cudaErrorInvalidValue;
  if (b21 == nullptr) {
    return encoder_fwd_partial<float, 3>(
        src<float>(x), src<float>(w1), src<float>(b1), src<float>(w21),
        src<float>(w22), dst<float>(mu), dst<float>(logvar), dst<float>(h),
        batch, seg, units, latent, s);
  }
  return encoder_fwd<float, 3>(
      src<float>(x), src<float>(w1), src<float>(b1), src<float>(w21),
      src<float>(b21), src<float>(w22), src<float>(b22), dst<float>(mu),
      dst<float>(logvar), dst<float>(h), batch, seg, units, latent, s);
}

// The `high` tier's decoder: z (batch, latent), w3 (latent, units), b3
// (units,), w4 (units, seg), b4 (seg,), outputs y (batch, seg) and h3
// (batch, units), all fp32, in three passes as rvk_encoder_fwd3.  b4 null:
// the row-parallel form (y's fp32 partial sums, no bias, no tanh).
// kernel: 0, the first version; 1, the tensor cores (full.cu
// decoder_split: `splits` the halves of z, w3, w4 and h3; h3 in tiles 128
// x tile_hidden, y in 128 x tile_out), under rvk_encoder_fwd3's conditions.
int rvk_decoder_fwd3(const void* z, const void* w3, const void* b3,
                     const void* w4, const void* b4, void* y, void* h3,
                     void* splits, int batch, int latent, int units, int seg,
                     int tile_hidden, int tile_out, int kernel,
                     void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kernel == rvk::tc::kTensorCores) {
    return rvk::decoder_split(src<float>(z), src<float>(w3), src<float>(b3),
                              src<float>(w4), src<float>(b4), dst<float>(y),
                              dst<float>(h3), splits, batch, latent, units,
                              seg, tile_hidden, tile_out, s);
  }
  if (kernel != rvk::tc::kCudaCores) return cudaErrorInvalidValue;
  if (b4 == nullptr) {
    return decoder_fwd_partial<float, 3>(
        src<float>(z), src<float>(w3), src<float>(b3), src<float>(w4),
        dst<float>(y), dst<float>(h3), batch, latent, units, seg, s);
  }
  return decoder_fwd<float, 3>(src<float>(z), src<float>(w3), src<float>(b3),
                               src<float>(w4), src<float>(b4), dst<float>(y),
                               dst<float>(h3), batch, latent, units, seg, s);
}

}  // extern "C"
