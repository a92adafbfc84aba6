"""Int8 weight-only quantization for the serving path — the CUDA counterpart
of the JAX package's ``ops/quant.py``.

Per-output-channel symmetric int8 (``w ≈ q * scale``, ``q ∈ [-127, 127]``,
scale 1.0 for an all-zero column), with the same rounding as the JAX
package, so both quantize a weight to identical ``q`` and equal ``scale``.
``quantized_decoder_fwd`` is the hand-written kernel (``csrc/quant.cu``);
``quantized_decode_ref`` is its plain version, in the JAX op order:
dequantize, then matmul.  Opt-in: ``InferenceServer(..., quantize=True)``.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from rawaudiovae_kelsey_tpu_torch.ops import _build
from rawaudiovae_kelsey_tpu_torch.ops.mlp import cuda_device, require

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


def quantized_decoder_fwd(qparams, z: Tensor) -> Tensor:
    """Int8-weight decode ``tanh(relu(z@W3+b3)@W4+b4)``, W3/W4 dequantized
    per output column inside the kernel.

    Replaces ``rawaudiovae_kelsey_tpu/ops/quant.py``
    ``quantized_decoder_fwd``.  CPU tensors run the plain version."""
    if z.device.type == "cpu":
        return quantized_decode_ref(qparams, z)
    dev = cuda_device(z, "quantized_decoder_fwd: z")
    batch, latent = z.shape
    q3, s3, b3 = (qparams["fc3"][k] for k in ("q", "scale", "b"))
    q4, s4, b4 = (qparams["fc4"][k] for k in ("q", "scale", "b"))
    units, seg = q3.shape[1], q4.shape[1]
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
        _build.launch("rvk_quantized_decoder_fwd", dev, z, q3, s3, b3,
                      q4, s4, b4, y, h3, batch, latent, units, seg)
        quantized_decoder_fwd.launches += 1
    return y


quantized_decoder_fwd.launches = 0
