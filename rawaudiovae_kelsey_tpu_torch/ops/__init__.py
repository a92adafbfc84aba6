"""Hand-written CUDA kernels for the dense VAE, each beside its plain
PyTorch version (``<op>_ref``) and a launch counter (``<op>.launches``):
the forward kernels of serving and training, the int8 serving decoder, the
backward kernels of the training step (the bf16 "split" set, the fp32
"primitive" set and the 3-pass "full" set of the ``high`` tier), the fused
loss reduction and the in-kernel Gaussian sampler.  Sources in ``csrc/``;
built by ``ops/_build.py``."""

from rawaudiovae_kelsey_tpu_torch.ops.mlp import (  # noqa: F401
    Decode,
    Encode,
    dec_bwd_full,
    dec_bwd_full_ref,
    dec_bwd_fused,
    dec_bwd_fused_ref,
    decode,
    decoder_fwd,
    decoder_fwd_ref,
    enc_bwd_full,
    enc_bwd_full_ref,
    enc_bwd_dw1,
    enc_bwd_dw1_ref,
    encode,
    encoder_fwd,
    encoder_fwd_ref,
    grad_accum,
    grad_accum2,
    grad_accum2_ref,
    grad_accum_ref,
    matmul_nt,
    matmul_nt2_mask,
    matmul_nt2_mask_ref,
    matmul_nt_mask,
    matmul_nt_mask_ref,
    matmul_nt_ref,
)
from rawaudiovae_kelsey_tpu_torch.ops.loss import (  # noqa: F401
    fused_loss,
    fused_loss_components,
    loss_sums,
    loss_sums_ref,
)
from rawaudiovae_kelsey_tpu_torch.ops.quant import (  # noqa: F401
    dequantize_weight,
    quantize_decoder,
    quantize_weight,
    quantized_decode_ref,
    quantized_decoder_fwd,
)

from rawaudiovae_kelsey_tpu_torch.ops.rng import (  # noqa: F401
    reparameterize_prng,
    reparameterize_prng_ref,
)

# the kernels each main path launches, and all of them
SERVING_KERNELS = (encoder_fwd, decoder_fwd, quantized_decoder_fwd)
# the bf16 step ("split" backward)
TRAINING_KERNELS = (encoder_fwd, decoder_fwd, enc_bwd_dw1, grad_accum2,
                    dec_bwd_fused, grad_accum)
# the fp32 step of the float32 / highest tiers ("primitive" backward)
PRIMITIVE_KERNELS = (encoder_fwd, decoder_fwd, matmul_nt2_mask,
                     matmul_nt_mask, matmul_nt, grad_accum)
# the fp32 step of the high tier ("full" backward, 3-pass products)
FULL_KERNELS = (encoder_fwd, decoder_fwd, enc_bwd_full, dec_bwd_full)
KERNEL_WRAPPERS = (encoder_fwd, decoder_fwd, quantized_decoder_fwd,
                   enc_bwd_dw1, grad_accum2, dec_bwd_fused, grad_accum,
                   matmul_nt, matmul_nt_mask, matmul_nt2_mask,
                   reparameterize_prng, enc_bwd_full, dec_bwd_full,
                   loss_sums)
