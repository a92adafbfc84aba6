"""Hand-written CUDA kernels for the dense VAE's serving path, each beside
its plain PyTorch version (``<op>_ref``) and a launch counter
(``<op>.launches``).  Sources in ``csrc/``; built by ``ops/_build.py``."""

from rawaudiovae_kelsey_tpu_torch.ops.mlp import (  # noqa: F401
    decode,
    decoder_fwd,
    decoder_fwd_ref,
    encode,
    encoder_fwd,
    encoder_fwd_ref,
)
from rawaudiovae_kelsey_tpu_torch.ops.quant import (  # noqa: F401
    dequantize_weight,
    quantize_decoder,
    quantize_weight,
    quantized_decode_ref,
    quantized_decoder_fwd,
)

KERNEL_WRAPPERS = (encoder_fwd, decoder_fwd, quantized_decoder_fwd)
