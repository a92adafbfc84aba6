// In-kernel Gaussian sampling for the reparameterization step, with a plain
// C interface for ctypes (ops/rng.py holds the wrapper, the plain PyTorch
// version and the autograd Function).
//
//   rvk_reparameterize   z = mu + eps · exp(0.5 · logvar),  eps ~ N(0, 1)
//                        drawn inside the kernel; eps never reaches memory
//   rvk_philox_words     the two 32-bit words behind each eps, for tests
//
// It replaces the TPU kernel pallas_reparameterize of
// rawaudiovae_kelsey_tpu/ops/rng.py, which seeds the TPU core's hardware
// PRNG once per batch tile.  This card has no such unit, and a stream tied
// to a tiling would change with the launch geometry.  Here the bits come
// from Philox4x32-10 (Salmon et al., "Parallel random numbers: as easy as
// 1, 2, 3", SC'11), a counter-based generator written out below: the key is
// the two seed words, the counter the element's position (column, row, 0,
// 0), so every element's noise is a function of (seed, row, column) alone —
// whatever the grid, the block size or the batch it arrives in.  Words 0
// and 1 of the block of four feed the element's two uniforms.
//
// After the bits the arithmetic is the TPU kernel's: 23 mantissa bits packed
// into [1, 2) and flipped to (0, 1], so log never sees 0; Box-Muller with
// the cosine branch only; fp32 throughout.  logf / cosf / sqrtf / expf are
// the precise ones (this file must not be built with --use_fast_math), and
// the final multiply and add are kept apart (no fused multiply-add), so the
// plain version, which runs the same operations as tensor ops, agrees to the
// last bits of log / cos / exp.
//
// What bounds it: three fp32 values moved per element (12 bytes) against
// ~100 integer operations and four transcendental calls: at (4096, 256) it
// is a few microseconds of either, below the cost of a launch.  One thread
// per element, neighbouring threads on neighbouring columns.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// Philox4x32 constants: the two multipliers and the two Weyl key increments
constexpr uint32_t kM0 = 0xD2511F53u;
constexpr uint32_t kM1 = 0xCD9E8D57u;
constexpr uint32_t kW0 = 0x9E3779B9u;
constexpr uint32_t kW1 = 0xBB67AE85u;

// Ten rounds of Philox4x32 on counter c with key (k0, k1), in place.
__device__ __forceinline__ void philox4x32_10(uint32_t c[4], uint32_t k0,
                                              uint32_t k1) {
#pragma unroll
  for (int round = 0; round < 10; ++round) {
    const uint32_t hi0 = __umulhi(kM0, c[0]), lo0 = kM0 * c[0];
    const uint32_t hi1 = __umulhi(kM1, c[2]), lo1 = kM1 * c[2];
    const uint32_t n0 = hi1 ^ c[1] ^ k0;
    const uint32_t n2 = hi0 ^ c[3] ^ k1;
    c[0] = n0, c[1] = lo1, c[2] = n2, c[3] = lo0;
    k0 += kW0, k1 += kW1;
  }
}

// The words of element (row, col): counter (col, row, 0, 0).
__device__ __forceinline__ void element_words(uint32_t seed0, uint32_t seed1,
                                              uint32_t row, uint32_t col,
                                              uint32_t& w0, uint32_t& w1) {
  uint32_t c[4] = {col, row, 0u, 0u};
  philox4x32_10(c, seed0, seed1);
  w0 = c[0], w1 = c[1];
}

// uint32 → float in (0, 1]: 23 bits into the mantissa of [1, 2), then 2 - v
__device__ __forceinline__ float unit_open(uint32_t bits) {
  return 2.0f - __uint_as_float((bits & 0x007FFFFFu) | 0x3F800000u);
}

__global__ void __launch_bounds__(kThreads)
reparameterize_kernel(uint32_t seed0, uint32_t seed1, const float* mu,
                      const float* logvar, float* z, int batch, int latent) {
  const long long idx =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= static_cast<long long>(batch) * latent) return;
  uint32_t w0, w1;
  element_words(seed0, seed1, static_cast<uint32_t>(idx / latent),
                static_cast<uint32_t>(idx % latent), w0, w1);
  const float u1 = unit_open(w0), u2 = unit_open(w1);
  // Box-Muller, cosine branch
  const float r = sqrtf(-2.0f * logf(u1));
  const float eps = r * cosf(6.283185307179586f * u2);
  const float sd = expf(0.5f * logvar[idx]);
  z[idx] = __fadd_rn(mu[idx], __fmul_rn(eps, sd));
}

__global__ void __launch_bounds__(kThreads)
philox_words_kernel(uint32_t seed0, uint32_t seed1, uint32_t* words,
                    int batch, int latent) {
  const long long idx =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= static_cast<long long>(batch) * latent) return;
  uint32_t w0, w1;
  element_words(seed0, seed1, static_cast<uint32_t>(idx / latent),
                static_cast<uint32_t>(idx % latent), w0, w1);
  words[2 * idx] = w0;
  words[2 * idx + 1] = w1;
}

inline unsigned blocks_for(int batch, int latent) {
  const long long n = static_cast<long long>(batch) * latent;
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

// mu, logvar, z (batch, latent) fp32; the seed's two 32-bit words.
int rvk_reparameterize(unsigned seed0, unsigned seed1, const float* mu,
                       const float* logvar, float* z, int batch, int latent,
                       void* stream) {
  if (batch <= 0 || latent <= 0) return cudaSuccess;
  reparameterize_kernel<<<blocks_for(batch, latent), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      seed0, seed1, mu, logvar, z, batch, latent);
  return cudaGetLastError();
}

// words (batch, latent, 2) uint32: the two words behind each element's eps.
int rvk_philox_words(unsigned seed0, unsigned seed1, unsigned* words,
                     int batch, int latent, void* stream) {
  if (batch <= 0 || latent <= 0) return cudaSuccess;
  philox_words_kernel<<<blocks_for(batch, latent), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      seed0, seed1, words, batch, latent);
  return cudaGetLastError();
}

}  // extern "C"
