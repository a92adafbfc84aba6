"""Hand-written CUDA kernels, each beside its plain PyTorch version
(``<op>_ref``) and a launch counter (``<op>.launches``); while a profiler
records, a wrapper's call, kernel or plain version, is the span
``rvk.rowNN.<op>``, NN its row of PERF.md's kernel table
(``observe/spans.py``).  For the dense VAE: the forward kernels of serving
and training, the int8 serving decoder,
the backward kernels of the training step (the bf16 "split" set, the fp32
"primitive" set and the 3-pass "full" set of the ``high`` tier), the fused
loss reduction and its one-pass gradient (the step's loss under ``backend
= pallas``) and the in-kernel Gaussian sampler.  For the model variants:
the fused linear layer in its whole-k and k-split forms (the deep MLP) and
the block-Toeplitz product with the two convolutions mapped onto it (the
conv1d model).  Beside them the three kernels that no trainer dispatches
and ``probes/`` measures: the fused backward of one linear layer
(``dw_fused``, ``dx_fused``) and the one-pass Adam update of a whole
parameter tree in one launch (``adam_tree``; ``leaf_update`` is the same
launch on one leaf).  ``linear_ksplit_fwd``, ``linear_fwd``, ``matmul_nt``
and ``toeplitz_fwd`` have a first version on the CUDA cores and a bf16
tensor-core kernel; ``linear_fwd`` and ``matmul_nt`` also a register-tiled
fp32 one; ``ops/tensor_cores.py`` chooses by dtype, shape and alignment.
Rows 1, 2, 15 and 16 also have a row-parallel form for tensor parallelism
(``encoder_fwd_partial``, ``decoder_fwd_partial``, ``linear_partial``: fp32
partial sums, no bias, no activation), counted in the row's wrapper.  Rows
1, 2 and 4-10 (and the row-parallel 1 and 2) also have the ``high`` tier's
3-pass form (``passes = 3``, fp32 operands: ``csrc/full.cu``'s chains on
the tensor cores), counted in ``split_launches``, as is row 17's 4-pass
form (``toeplitz_fwd`` at ``passes = 4`` on the tensor cores, the fp32
conv1d layers of a ``high`` op-level step), and the full chains a
one-pass fp32 form; which backward a step runs is the switch
``mlp.BWD_FUSION`` (``mlp.fusion``).  ``encoder_bwd`` / ``decoder_bwd`` are
the primitive backward as plain functions over the wrappers.
Sources in ``csrc/``; built by ``ops/_build.py``."""

from rawaudiovae_kelsey_tpu_torch.ops.mlp import (  # noqa: F401
    Decode,
    Encode,
    dec_bwd_full,
    dec_bwd_full_ref,
    dec_bwd_fused,
    dec_bwd_fused_ref,
    decode,
    decoder_bwd,
    decoder_fwd,
    decoder_fwd_partial,
    decoder_fwd_partial_ref,
    decoder_fwd_ref,
    enc_bwd_full,
    enc_bwd_full_ref,
    enc_bwd_dw1,
    enc_bwd_dw1_ref,
    encode,
    encoder_bwd,
    encoder_fwd,
    encoder_fwd_partial,
    encoder_fwd_partial_ref,
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
    split_pass,
    split_pass_ref,
)
from rawaudiovae_kelsey_tpu_torch.ops.loss import (  # noqa: F401
    fused_loss,
    fused_loss_components,
    loss_grads,
    loss_grads_ref,
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
from rawaudiovae_kelsey_tpu_torch.ops.linear import (  # noqa: F401
    PallasLinear,
    deep_decode_pallas,
    deep_encode_pallas,
    linear_fwd,
    linear_fwd_ref,
    linear_ksplit_fwd,
    linear_ksplit_fwd_ref,
    linear_partial,
    linear_partial_ref,
    pallas_linear,
)
from rawaudiovae_kelsey_tpu_torch.ops.tensor_cores import (  # noqa: F401
    takes_tensor_cores,
)
from rawaudiovae_kelsey_tpu_torch.ops.toeplitz import (  # noqa: F401
    ToeplitzMatmul,
    toeplitz_fwd,
    toeplitz_fwd_ref,
    toeplitz_matmul,
)
from rawaudiovae_kelsey_tpu_torch.ops.conv import (  # noqa: F401
    conv1d_pallas,
    conv1d_transpose_pallas,
    conv_decode_pallas,
    conv_encode_pallas,
)
from rawaudiovae_kelsey_tpu_torch.ops.linear_bwd import (  # noqa: F401
    dw_fused,
    dw_fused_ref,
    dx_fused,
    dx_fused_ref,
    fused_bwd,
    plain_bwd,
)
from rawaudiovae_kelsey_tpu_torch.ops.adam import (  # noqa: F401
    FusedAdam,
    adam_tree,
    fused_adam_apply,
    leaf_update,
    leaf_update_ref,
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
# the deep model's step and server (the backward is plain products)
DEEP_KERNELS = (linear_ksplit_fwd, linear_fwd)
# the conv1d model's op-level step (the heads and dec_in are linear layers)
CONV_KERNELS = (toeplitz_fwd, linear_fwd)
# the probes' kernels (probes/deep_bwd.py, probes/adam_fusion.py)
PROBE_KERNELS = (dw_fused, dx_fused, adam_tree, leaf_update)
KERNEL_WRAPPERS = (encoder_fwd, decoder_fwd, quantized_decoder_fwd,
                   enc_bwd_dw1, grad_accum2, dec_bwd_fused, grad_accum,
                   matmul_nt, matmul_nt_mask, matmul_nt2_mask,
                   reparameterize_prng, enc_bwd_full, dec_bwd_full,
                   loss_sums, loss_grads, linear_ksplit_fwd, linear_fwd,
                   toeplitz_fwd, dw_fused, dx_fused, adam_tree, leaf_update)
