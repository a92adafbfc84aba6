"""Hand-written CUDA kernels for the dense VAE, each beside its plain
PyTorch version (``<op>_ref``) and a launch counter (``<op>.launches``):
the forward kernels of serving and training, the int8 serving decoder, and
the backward kernels of the training step.  Sources in ``csrc/``; built by
``ops/_build.py``."""

from rawaudiovae_kelsey_tpu_torch.ops.mlp import (  # noqa: F401
    Decode,
    Encode,
    dec_bwd_fused,
    dec_bwd_fused_ref,
    decode,
    decoder_fwd,
    decoder_fwd_ref,
    enc_bwd_dw1,
    enc_bwd_dw1_ref,
    encode,
    encoder_fwd,
    encoder_fwd_ref,
    grad_accum,
    grad_accum2,
    grad_accum2_ref,
    grad_accum_ref,
)
from rawaudiovae_kelsey_tpu_torch.ops.quant import (  # noqa: F401
    dequantize_weight,
    quantize_decoder,
    quantize_weight,
    quantized_decode_ref,
    quantized_decoder_fwd,
)

# the kernels each main path launches, and all of them
SERVING_KERNELS = (encoder_fwd, decoder_fwd, quantized_decoder_fwd)
TRAINING_KERNELS = (encoder_fwd, decoder_fwd, enc_bwd_dw1, grad_accum2,
                    dec_bwd_fused, grad_accum)
KERNEL_WRAPPERS = (encoder_fwd, decoder_fwd, quantized_decoder_fwd,
                   enc_bwd_dw1, grad_accum2, dec_bwd_fused, grad_accum)
