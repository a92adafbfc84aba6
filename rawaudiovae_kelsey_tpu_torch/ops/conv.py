"""conv1d / transpose-conv1d on the block-Toeplitz kernel: the counterpart
of the JAX package's ``ops/pallas_conv.py``.

Both directions of the conv1d VAE map onto :func:`ops.toeplitz
.toeplitz_matmul`; the signal is read once as a flat stream, bias and
activation fuse into the product's epilogue, and no im2col patches are
written, forward or backward:

* :func:`conv1d_pallas`: a SAME-padded stride-S convolution through the
  free reshape of ``(B, L, Cin)`` to ``(B, L/S, S·Cin)``.  Window ``t``
  reads flat ``[t·G - lo·Cin, … + K·Cin)`` with ``G = S·Cin``: a run of
  ``KB`` whole blocks starting at block ``t - q``, at constant offset ``r0``
  inside it.  Placing the flattened weight at row ``r0`` of a zero ``(KB,
  G, Cout)`` tap stack makes the convolution a Toeplitz product with
  ``shift = q``, whose nonzero rows are the window ``[r0, r0 + K·Cin)``
  (:func:`conv1d_window`; the fp32 kernel contracts only those).
* :func:`conv1d_transpose_pallas`: the polyphase identity.  Output phase
  ``r`` (``n = t·S + r``) is a unit-stride correlation of the undilated
  input with the taps ``j ≡ (lo - r) (mod S)``.  Packing all S sub-kernels
  into one ``(Kp, Cin, S·Cout)`` weight makes the transpose convolution one
  Toeplitz product with ``G = Cin`` and ``shift = -dmin``, whose ``(B, L,
  S·Cout)`` output is, row-major, the interleaved ``(B, L·S, Cout)``
  result.  The semantics are ``jax.lax.conv_transpose``'s with SAME padding
  (kernel not flipped), those of ``models/variants.py``.

The weight packing is index arithmetic on the host, copied from the JAX
package: it is where the semantics live.  The model registry routes the
conv1d model to the plain convolutions under every backend, as the JAX
registry does; these functions are an explicit op-level API
(:func:`conv_encode_pallas` / :func:`conv_decode_pallas` run the model on
them).  ``passes`` (1, or 4 for the bf16 hi/lo split of fp32 operands) is
passed down explicitly; the two model functions declare the pass count a
train or eval step under ``high`` binds to them (``high_passes``,
``ops/toeplitz.py`` ``HIGH_PASSES``: JAX's ``toeplitz_fwd`` takes four
passes on fp32 operands under that tier), read by ``models/registry.py``
``under_tier``.

A length that the stride does not divide has no block view: that case
takes :func:`_conv1d_im2col`, patches gathered by indexing and the product
through :func:`ops.linear.pallas_linear`.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from rawaudiovae_kelsey_tpu_torch.models.variants import same_pad as _same_pad
from rawaudiovae_kelsey_tpu_torch.ops.linear import pallas_linear
from rawaudiovae_kelsey_tpu_torch.ops.toeplitz import (
    HIGH_PASSES,
    toeplitz_matmul,
)

Tensor = torch.Tensor


def _placement(L: int, K: int, cin: int, stride: int):
    """``(q, r0, KB)``: window t of the strided conv1d reads flat ``[t·G -
    lo·Cin, … + K·Cin)`` (``G = S·Cin``), ``KB`` whole blocks from block ``t
    - q`` at constant offset ``r0`` inside it — the left pad is folded into
    the tap stack's row placement, no padded copy."""
    G = stride * cin
    lo, _ = _same_pad(L, K, stride)
    q = -(-(lo * cin) // G)
    r0 = q * G - lo * cin
    return q, r0, -(-(r0 + K * cin) // G)


def conv1d_window(L: int, K: int, cin: int, stride: int):
    """The rows ``(r0, r0 + K·Cin)`` of :func:`pack_conv1d` 's tap stack,
    viewed as ``(KB·G, Cout)``, that hold the weight: outside them it is
    zero."""
    _, r0, _ = _placement(L, K, cin, stride)
    return r0, r0 + K * cin


def pack_conv1d(x: Tensor, w: Tensor, stride: int):
    """The Toeplitz operands of a SAME-padded strided conv1d whose length
    the stride divides → ``(xf, wpad, t_out, shift)``: the free block view
    of ``x`` and the zero-padded tap stack."""
    B, L, cin = x.shape
    K, _, cout = w.shape
    G = stride * cin
    T = L // stride
    q, r0, KB = _placement(L, K, cin, stride)
    xf = x.reshape(B, T, G)                        # free: row-major
    wpad = F.pad(w.reshape(K * cin, cout),
                 (0, 0, r0, KB * G - r0 - K * cin)).reshape(KB, G, cout)
    return xf, wpad, T, q


def conv1d_pallas(x: Tensor, w: Tensor, b: Tensor, stride: int,
                  act: str = "none", passes: int = 1) -> Tensor:
    """SAME-padded strided conv1d: x ``(B, L, Cin)``, w ``(K, Cin, Cout)``
    → ``(B, ceil(L/stride), Cout)`` with fused bias + activation."""
    if x.shape[1] % stride:              # flat stream not block-viewable
        return _conv1d_im2col(x, w, b, stride, act)
    xf, wpad, T, q = pack_conv1d(x.contiguous(), w, stride)
    return toeplitz_matmul(xf, wpad, b, act, T, q, passes,
                           conv1d_window(x.shape[1], w.shape[0], x.shape[2],
                                         stride))


def _transpose_plan(K: int, stride: int, cin: int, cout: int):
    """Static polyphase placement: tap j of phase r = (lo - j) % S lands at
    combined-weight row δ(r,j) = (r + j - lo)//S (shifted by -δmin)."""
    total_fwd = max(0, K - stride)        # forward SAME pad for L*S → L
    pb = total_fwd // 2
    lo = K - 1 - pb
    rows, phases, taps = [], [], []
    for r in range(stride):
        j0 = (lo - r) % stride
        for j in range(j0, K, stride):
            rows.append((r + j - lo) // stride)
            phases.append(r)
            taps.append(j)
    dmin = min(rows)
    kp = max(rows) - dmin + 1
    rows = np.asarray(rows) - dmin
    return dmin, kp, rows, np.asarray(phases), np.asarray(taps)


def pack_conv1d_transpose(x: Tensor, w: Tensor, b: Tensor, stride: int):
    """The Toeplitz operands of a SAME-padded transpose conv1d → ``(x, wt,
    bt, t_out, shift)``: the polyphase weight ``(Kp, Cin, S·Cout)`` and the
    bias tiled over the phases."""
    L, cin = x.shape[1:]
    K, _, cout = w.shape
    dmin, kp, rows, phases, taps = _transpose_plan(K, stride, cin, cout)
    # window t reads raw x rows [t + dmin, t + dmin + kp); rows out of
    # range contribute zero inside the kernel — no padded copy
    index = [torch.as_tensor(i, device=w.device) for i in (rows, phases)]
    w4 = torch.zeros((kp, stride, cin, cout), dtype=w.dtype,
                     device=w.device).index_put(
                         index, w[torch.as_tensor(taps, device=w.device)])
    wt = w4.permute(0, 2, 1, 3).reshape(kp, cin, stride * cout)
    return x, wt.contiguous(), b.repeat(stride), L, -dmin


def conv1d_transpose_pallas(x: Tensor, w: Tensor, b: Tensor, stride: int,
                            act: str = "none", passes: int = 1) -> Tensor:
    """SAME-padded transpose conv1d matching ``jax.lax.conv_transpose``:
    x ``(B, L, Cin)``, w ``(K, Cin, Cout)`` → ``(B, L*stride, Cout)``."""
    B, L, _ = x.shape
    xc, wt, bt, t_out, shift = pack_conv1d_transpose(x.contiguous(), w, b,
                                                     stride)
    y = toeplitz_matmul(xc, wt, bt, act, t_out, shift, passes)
    return y.reshape(B, L * stride, w.shape[2])


def _conv1d_im2col(x, w, b, stride, act):
    """The patch formulation, for a length the stride does not divide:
    patches ``(B·out, K·Cin)`` gathered by indexing, the product through
    the fused linear layer."""
    B, L, cin = x.shape
    K, _, cout = w.shape
    lo, hi = _same_pad(L, K, stride)
    xp = F.pad(x, (0, 0, lo, hi))
    out_len = -(-L // stride)
    starts = torch.arange(out_len, device=x.device) * stride
    idx = starts[:, None] + torch.arange(K, device=x.device)[None, :]
    patches = xp[:, idx, :]
    flat = patches.reshape(B * out_len, K * cin)
    y = pallas_linear(flat, w.reshape(K * cin, cout).contiguous(), b, act)
    return y.reshape(B, out_len, cout)


def conv_encode_pallas(params, x, stride: int, passes: int = 1
                       ) -> Tuple[Tensor, Tensor]:
    """The conv1d model's encoder (``models/variants.py`` layout) on the
    fused path."""
    h = x[..., None]
    for layer in params["enc"]:
        h = conv1d_pallas(h, layer["w"], layer["b"], stride, "relu", passes)
    h = h.reshape(h.shape[0], -1)
    mu = pallas_linear(h, params["mu_head"]["w"], params["mu_head"]["b"],
                       "none")
    logvar = pallas_linear(h, params["logvar_head"]["w"],
                           params["logvar_head"]["b"], "none")
    return mu, logvar


def conv_decode_pallas(params, z, stride: int, width: int, channels: int,
                       passes: int = 1) -> Tensor:
    h = pallas_linear(z, params["dec_in"]["w"], params["dec_in"]["b"], "relu")
    h = h.reshape(z.shape[0], width, channels)
    for layer in params["dec"][:-1]:
        h = conv1d_transpose_pallas(h, layer["w"], layer["b"], stride, "relu",
                                    passes)
    last = params["dec"][-1]
    h = conv1d_transpose_pallas(h, last["w"], last["b"], stride, "tanh",
                                passes)
    return h[..., 0]


conv_encode_pallas.high_passes = conv_decode_pallas.high_passes = \
    HIGH_PASSES
