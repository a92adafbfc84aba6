"""Int8 weight-only quantization for the serving path — the CUDA counterpart
of the JAX package's ``ops/quant.py``.

Per-output-channel symmetric int8 (``w ≈ q * scale``, ``q ∈ [-127, 127]``,
scale 1.0 for an all-zero column), with the same rounding as the JAX
package, so both quantize a weight to identical ``q`` and equal ``scale``.
``quantized_decoder_fwd`` is the hand-written kernel (``csrc/quant.cu``):
the fp32 mainloop of ``csrc/sgemm.cuh`` with the int8 weights dequantized
as they are staged, on the fp32 decoder's plans, or the first version's
two launches of ``csrc/gemm.cuh`` for widths it cannot take
(:func:`resolve_quantized_decoder`).  ``quantized_decode_ref`` is its
plain version, in the JAX op order: dequantize, then matmul.  Opt-in:
``InferenceServer(..., quantize=True)``.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from rawaudiovae_kelsey_tpu_torch.observe.spans import spanned
from rawaudiovae_kelsey_tpu_torch.ops import _build, tensor_cores
from rawaudiovae_kelsey_tpu_torch.ops.mlp import (
    cuda_device,
    forward_plans,
    require,
)

Tensor = torch.Tensor


def quantize_weight(w: Tensor) -> Tuple[Tensor, Tensor]:
    """``(in, out)`` weight → int8 ``q`` and fp32 ``scale`` shaped
    ``(1, out)``.  ``torch.round`` rounds half to even, as ``jnp.round``."""
    w = w.to(torch.float32)
    absmax = w.abs().amax(dim=0, keepdim=True)
    scale = torch.where(absmax > 0, absmax / 127.0, torch.ones_like(absmax))
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_weight(q: Tensor, scale: Tensor) -> Tensor:
    return q.to(torch.float32) * scale


def quantize_decoder(params) -> Dict:
    """Quantize the dense decoder (fc3, fc4) for serving; biases stay fp32."""
    q3, s3 = quantize_weight(params["fc3"]["w"])
    q4, s4 = quantize_weight(params["fc4"]["w"])
    return {
        "fc3": {"q": q3, "scale": s3, "b": params["fc3"]["b"]},
        "fc4": {"q": q4, "scale": s4, "b": params["fc4"]["b"]},
    }


def quantized_decode_ref(qparams, z: Tensor) -> Tensor:
    """Plain version of :func:`quantized_decoder_fwd`."""
    w3 = dequantize_weight(qparams["fc3"]["q"], qparams["fc3"]["scale"])
    w4 = dequantize_weight(qparams["fc4"]["q"], qparams["fc4"]["scale"])
    h3 = torch.relu(z.to(torch.float32) @ w3 + qparams["fc3"]["b"])
    return torch.tanh(h3 @ w4 + qparams["fc4"]["b"])


@spanned("rvk.row03.quantized_decoder_fwd")
def quantized_decoder_fwd(qparams, z: Tensor, kernel: str = "auto"
                          ) -> Tensor:
    """Int8-weight decode ``tanh(relu(z@W3+b3)@W4+b4)``, W3/W4 dequantized
    per output column inside the kernel.

    Replaces ``rawaudiovae_kelsey_tpu/ops/quant.py``
    ``quantized_decoder_fwd``.  CUDA, two products (``csrc/quant.cu``), h3
    then y, of one of two hand-written kernels chosen by
    :func:`resolve_quantized_decoder`: fp32 ``z`` with latent, units and seg
    multiples of 4 and 16-byte aligned pointers takes the register-tiled
    fp32 kernel (``csrc/sgemm.cuh``) with each int8 weight copied into
    shared memory as it lies and dequantized, ``q · scale`` rounded once,
    as its slab is read back; each product's tile and slices of its
    contraction are the fp32 decoder's (``tensor_cores.sgemm_fwd_plan``; a
    product cut into slices adds them in order through a workspace
    allocated here), so the result equals
    ``mlp.decoder_fwd(dequantize_weight(q3, s3), b3, dequantize_weight(q4,
    s4), b4, z, kernel="sgemm")`` bit for bit.  Everything else runs the
    first version, the tiled GEMM on the CUDA cores.  ``kernel`` (``"auto"``
    or a key of ``tensor_cores.KERNEL_CODES``) names one instead; a kernel
    named on operands it cannot take raises.  ``z`` is fp32 whichever
    runs.  CPU tensors run the plain version.  One call counts once in
    ``launches``, and in ``sgemm_launches`` too when the fp32 kernel ran
    it."""
    tensor_cores.check_name("quantized_decoder_fwd", kernel)
    if z.device.type == "cpu":
        return quantized_decode_ref(qparams, z)
    dev = cuda_device(z, "quantized_decoder_fwd: z")
    batch, latent = z.shape
    q3, s3, b3 = (qparams["fc3"][k] for k in ("q", "scale", "b"))
    q4, s4, b4 = (qparams["fc4"][k] for k in ("q", "scale", "b"))
    units, seg = q3.shape[1], q4.shape[1]
    code = resolve_quantized_decoder(
        kernel, z.dtype, batch, latent, units, seg,
        tensor_cores.pointers_aligned(z, q3, s3, b3, q4, s4, b4))
    require(z, "z", (batch, latent), dev)
    require(q3, "fc3.q", (latent, units), dev, torch.int8)
    require(s3, "fc3.scale", (1, units), dev)
    require(b3, "fc3.b", (units,), dev)
    require(q4, "fc4.q", (units, seg), dev, torch.int8)
    require(s4, "fc4.scale", (1, seg), dev)
    require(b4, "fc4.b", (seg,), dev)
    y = torch.empty((batch, seg), device=dev, dtype=torch.float32)
    if batch:
        h3 = torch.empty((batch, units), device=dev, dtype=torch.float32)
        (tile_h, split_h), (tile_o, split_o), ws = forward_plans(
            code, dev, batch, ((latent, units, 1), (units, seg, 1)))
        _build.launch("rvk_quantized_decoder_fwd", dev, z, q3, s3, b3,
                      q4, s4, b4, y, h3, ws, batch, latent, units, seg,
                      split_h, split_o, tile_h, tile_o, code)
        quantized_decoder_fwd.launches += 1
        quantized_decoder_fwd.sgemm_launches += code == tensor_cores.SGEMM
    return y


quantized_decoder_fwd.launches = 0
quantized_decoder_fwd.sgemm_launches = 0


def resolve_quantized_decoder(kernel: str, dtype: torch.dtype, batch: int,
                              latent: int, units: int, seg: int,
                              aligned: bool = True) -> int:
    """The kernel code :func:`quantized_decoder_fwd` launches with: the
    fp32 kernel when ``z`` is fp32 and both of its products fit it
    (``tensor_cores.takes_sgemm`` of the hidden layer, contraction
    ``latent`` and width ``units``, and of the output layer, ``units`` and
    ``seg``; ``aligned``: every pointer, the int8 weights' and the scales'
    too, on a 16-byte boundary), else the first version; ``kernel`` names
    one instead (``tensor_cores.resolve``).  It has no tensor-core form:
    naming one raises."""
    return tensor_cores.resolve(
        "quantized_decoder_fwd", kernel, False,
        lambda: f"{dtype}, batch {batch}, latent {latent}, units {units}, "
                f"seg {seg}, aligned = {aligned}",
        tensor_cores.takes_sgemm(dtype, batch, latent, units, aligned)
        and tensor_cores.takes_sgemm(dtype, batch, units, seg),
        takes="no operands: the int8 decoder has no tensor-core form")
