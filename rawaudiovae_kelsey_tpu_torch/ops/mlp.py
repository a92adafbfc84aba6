"""Dense-VAE kernels, forward and backward: the CUDA counterparts of the
JAX package's ``ops/pallas_mlp.py``.

Each op has three parts, side by side:

* the plain PyTorch version (``<op>_ref``): the same arithmetic in fp32
  from the operands upcast to fp32, rounded to the operand dtype exactly
  where the TPU kernel rounds;
* the wrapper (``<op>``): for a CPU tensor it runs the plain version; for a
  CUDA tensor it checks device, dtype, shape and contiguity, launches the
  hand-written kernel (``csrc/mlp.cu``, ``csrc/bwd.cu``) on the current
  stream, and counts the launch in ``<op>.launches``.  It never falls back:
  anything the kernel does not take raises;
* the model-level entry points ``encode`` / ``decode``: the
  ``torch.autograd.Function`` s that play the roles of ``pallas_encode`` /
  ``pallas_decode``.  Their backward has the JAX package's three modes
  (``pallas_mlp.py`` ``_fusion``): "split", the bf16 step's — ``enc_bwd_dw1``
  + ``grad_accum2`` for the encoder, ``dec_bwd_fused`` + ``grad_accum`` for
  the decoder; "primitive", the ``float32`` / ``highest`` tiers' —
  ``matmul_nt2_mask`` then three ``grad_accum`` for the encoder,
  ``matmul_nt_mask``, ``matmul_nt`` and two ``grad_accum`` for the decoder;
  and "full", the ``high`` tier's — ``enc_bwd_full`` and ``dec_bwd_full``,
  one call per chain, every product of fp32 operands in three bf16 passes
  (:func:`split_hi_lo`).  The encoder's input gradient is
  ``matmul_nt2_mask`` followed by ``matmul_nt`` in all three.

Layouts are the JAX package's: weights ``(in, out)``, biases ``(out,)``.
Operands are fp32 or bf16, all of one dtype per call; accumulation is fp32;
forward outputs and ``dz`` come in the operand dtype, weight and bias
gradients in fp32 (the autograd Functions cast them to the params' dtype,
as ``pallas_encode``'s backward does).  The kernels mask the ragged batch
edge themselves; nothing is padded.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from rawaudiovae_kelsey_tpu_torch.ops import _build

Tensor = torch.Tensor

# operand dtype → the code the C entry points take (csrc/gemm.cuh DType)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _f(t: Tensor) -> Tensor:
    return t.to(torch.float32)


# ----------------------------------------------------------- plain versions

def encoder_fwd_ref(w1, b1, w21, b21, w22, b22, x
                    ) -> Tuple[Tensor, Tensor, Tensor]:
    """Plain version of :func:`encoder_fwd`."""
    dt = x.dtype
    h = torch.relu(_f(x) @ _f(w1) + _f(b1)).to(dt)
    mu = (_f(h) @ _f(w21) + _f(b21)).to(dt)
    logvar = (_f(h) @ _f(w22) + _f(b22)).to(dt)
    return mu, logvar, h


def decoder_fwd_ref(w3, b3, w4, b4, z) -> Tuple[Tensor, Tensor]:
    """Plain version of :func:`decoder_fwd`."""
    dt = z.dtype
    h3 = torch.relu(_f(z) @ _f(w3) + _f(b3)).to(dt)
    return torch.tanh(_f(h3) @ _f(w4) + _f(b4)).to(dt), h3


def matmul_nt2_mask_ref(a1, w1, a2, w2, gate) -> Tensor:
    """Plain version of :func:`matmul_nt2_mask`."""
    prod = _f(a1) @ _f(w1).t() + _f(a2) @ _f(w2).t()
    return torch.where(_f(gate) > 0, prod, 0.0).to(a1.dtype)


def matmul_nt_mask_ref(a, w, gate) -> Tensor:
    """Plain version of :func:`matmul_nt_mask`."""
    return torch.where(_f(gate) > 0, _f(a) @ _f(w).t(), 0.0).to(a.dtype)


def matmul_nt_ref(a, w) -> Tensor:
    """Plain version of :func:`matmul_nt`."""
    return (_f(a) @ _f(w).t()).to(a.dtype)


def grad_accum_ref(a, b) -> Tuple[Tensor, Tensor]:
    """Plain version of :func:`grad_accum`."""
    return _f(a).t() @ _f(b), _f(b).sum(0)


def grad_accum2_ref(a, b1, b2) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Plain version of :func:`grad_accum2`."""
    return (*grad_accum_ref(a, b1), *grad_accum_ref(a, b2))


def enc_bwd_dw1_ref(x, h, dmu, dlogvar, w21, w22) -> Tuple[Tensor, Tensor]:
    """Plain version of :func:`enc_bwd_dw1`: ``dh`` rounded to the operand
    dtype (``pallas_mlp.py:535``), then ``(xᵀ dh, colsum(dh))``."""
    return grad_accum_ref(x, matmul_nt2_mask_ref(dmu, w21, dlogvar, w22, h))


def dec_bwd_fused_ref(da, h3, z, w4, w3) -> Tuple[Tensor, Tensor, Tensor]:
    """Plain version of :func:`dec_bwd_fused`: ``dh3`` rounded to the
    operand dtype (``pallas_mlp.py:686``), then ``dz = dh3 @ w3ᵀ`` in it and
    ``(zᵀ dh3, colsum(dh3))`` in fp32."""
    dh3 = matmul_nt_mask_ref(da, w4, h3)
    return (matmul_nt_ref(dh3, w3), *grad_accum_ref(z, dh3))


def split_hi_lo(v: Tensor) -> Tuple[Tensor, Tensor]:
    """fp32 → ``(hi, lo)``, both fp32 tensors holding bf16 values, with
    ``v ≈ hi + lo``: the operand split of the 3-pass product.  ``hi`` is
    ``v`` rounded to bf16 by integer arithmetic on its bits, ``(u + 0x8000)
    & 0xFFFF0000`` (round half up on the magnitude, not to even), ``lo``
    is ``v - hi`` rounded to bf16 (to nearest even) — bit for bit
    ``pallas_mlp.py`` ``_split_hi_lo``."""
    u = v.contiguous().view(torch.int32)
    hi = ((u + 0x8000) & -0x10000).view(torch.float32)
    return hi, (v - hi).to(torch.bfloat16).to(torch.float32)


def mm3(a: Tensor, b: Tensor) -> Tensor:
    """``a @ b`` of fp32 matrices as the 3-pass product: ``(hi(a)·hi(b) +
    hi(a)·lo(b)) + lo(a)·hi(b)``, each an fp32 matmul of bf16-valued
    operands (``pallas_mlp.py`` ``_mm`` at ``passes = 3``)."""
    ah, al = split_hi_lo(a)
    bh, bl = split_hi_lo(b)
    return (ah @ bh + ah @ bl) + al @ bh


def _mm(a: Tensor, b: Tensor, passes: int) -> Tensor:
    return mm3(a, b) if passes == 3 else _f(a) @ _f(b)


def check_passes(dtype: torch.dtype, passes: int) -> None:
    """Raise unless ``passes`` is 1, or 3 with fp32 operands."""
    if passes not in (1, 3) or (passes == 3 and dtype != torch.float32):
        raise ValueError(f"passes = {passes} with {dtype} operands: the "
                         "products take 1 pass, or 3 with fp32 operands")


def enc_bwd_full_ref(x, h, dmu, dlogvar, w21, w22, passes: int = 1
                     ) -> Tuple[Tensor, ...]:
    """Plain version of :func:`enc_bwd_full` → ``(dw1, db1, dw21, db21,
    dw22, db22)`` in fp32.  ``passes = 3`` (fp32 operands): every product
    is :func:`mm3`, ``dh`` stays fp32 and the bias gradients sum the
    unsplit values (``pallas_mlp.py:761-775``); ``passes = 1``: ``dh`` is
    rounded to the operand dtype first (``:777``)."""
    check_passes(x.dtype, passes)
    prod = _mm(dmu, w21.t(), passes) + _mm(dlogvar, w22.t(), passes)
    dh = torch.where(_f(h) > 0, prod, 0.0).to(x.dtype)
    return (_mm(x.t(), dh, passes), _f(dh).sum(0),
            _mm(h.t(), dmu, passes), _f(dmu).sum(0),
            _mm(h.t(), dlogvar, passes), _f(dlogvar).sum(0))


def dec_bwd_full_ref(da, h3, z, w4, w3, passes: int = 1
                     ) -> Tuple[Tensor, ...]:
    """Plain version of :func:`dec_bwd_full` → ``(dz, dw3, db3, dw4,
    db4)``: ``dz`` in the operand dtype, the rest fp32; ``passes`` as in
    :func:`enc_bwd_full_ref` (``pallas_mlp.py:858-882``)."""
    check_passes(da.dtype, passes)
    dh3 = torch.where(_f(h3) > 0, _mm(da, w4.t(), passes), 0.0).to(da.dtype)
    return (_mm(dh3, w3.t(), passes).to(da.dtype),
            _mm(z.t(), dh3, passes), _f(dh3).sum(0),
            _mm(h3.t(), da, passes), _f(da).sum(0))


# ------------------------------------------------------------------ checks

def require(t: Tensor, name: str, shape: Tuple[int, ...],
            device: torch.device, dtype: torch.dtype = torch.float32) -> None:
    """Raise unless ``t`` is what a kernel takes: on ``device``, of
    ``dtype``, of ``shape``, contiguous."""
    if not isinstance(t, Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, kernel takes {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def cuda_device(x: Tensor, name: str) -> torch.device:
    """The device a kernel launch for ``x`` runs on; raises for anything
    but a CUDA tensor (CPU tensors never reach here)."""
    if not isinstance(x, Tensor) or x.device.type != "cuda":
        where = x.device if isinstance(x, Tensor) else type(x).__name__
        raise ValueError(f"{name}: the kernel runs on CUDA tensors, got "
                         f"{where}")
    if x.dim() != 2:
        raise ValueError(f"{name}: expected a 2-D batch, got shape "
                         f"{tuple(x.shape)}")
    return x.device


def operand_dtype(x: Tensor, name: str) -> torch.dtype:
    """``x``'s dtype if the kernels take it (fp32 or bf16); raises
    otherwise.  Every other operand of the call must match it."""
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"{name}: dtype {x.dtype}, the kernels take "
                        f"{' or '.join(map(str, DTYPE_CODES))}")
    return x.dtype


# ----------------------------------------------------------- forward kernels

def encoder_fwd(w1, b1, w21, b21, w22, b22, x
                ) -> Tuple[Tensor, Tensor, Tensor]:
    """Fused ``relu(x@W1+b1)`` → ``(mu, logvar, h)``.

    Replaces ``rawaudiovae_kelsey_tpu/ops/pallas_mlp.py`` ``encoder_fwd``.
    CUDA: two launches of the tiled GEMM (``csrc/mlp.cu``), h then both
    heads in one."""
    if x.device.type == "cpu":
        return encoder_fwd_ref(w1, b1, w21, b21, w22, b22, x)
    dev = cuda_device(x, "encoder_fwd: x")
    dt = operand_dtype(x, "encoder_fwd: x")
    batch, seg = x.shape
    units, latent = w1.shape[1], w21.shape[1]
    require(x, "x", (batch, seg), dev, dt)
    require(w1, "w1", (seg, units), dev, dt)
    require(b1, "b1", (units,), dev, dt)
    require(w21, "w21", (units, latent), dev, dt)
    require(b21, "b21", (latent,), dev, dt)
    require(w22, "w22", (units, latent), dev, dt)
    require(b22, "b22", (latent,), dev, dt)
    mu = torch.empty((batch, latent), device=dev, dtype=dt)
    logvar = torch.empty((batch, latent), device=dev, dtype=dt)
    h = torch.empty((batch, units), device=dev, dtype=dt)
    if batch:
        _build.launch("rvk_encoder_fwd", dev, x, w1, b1, w21, b21, w22, b22,
                      mu, logvar, h, batch, seg, units, latent,
                      DTYPE_CODES[dt])
        encoder_fwd.launches += 1
    return mu, logvar, h


encoder_fwd.launches = 0


def decoder_fwd(w3, b3, w4, b4, z) -> Tuple[Tensor, Tensor]:
    """Fused ``tanh(relu(z@W3+b3)@W4+b4)`` → ``(y, h3)``.

    Replaces ``rawaudiovae_kelsey_tpu/ops/pallas_mlp.py`` ``decoder_fwd``.
    CUDA: two launches of the tiled GEMM (``csrc/mlp.cu``), h3 then y."""
    if z.device.type == "cpu":
        return decoder_fwd_ref(w3, b3, w4, b4, z)
    dev = cuda_device(z, "decoder_fwd: z")
    dt = operand_dtype(z, "decoder_fwd: z")
    batch, latent = z.shape
    units, seg = w3.shape[1], w4.shape[1]
    require(z, "z", (batch, latent), dev, dt)
    require(w3, "w3", (latent, units), dev, dt)
    require(b3, "b3", (units,), dev, dt)
    require(w4, "w4", (units, seg), dev, dt)
    require(b4, "b4", (seg,), dev, dt)
    y = torch.empty((batch, seg), device=dev, dtype=dt)
    h3 = torch.empty((batch, units), device=dev, dtype=dt)
    if batch:
        _build.launch("rvk_decoder_fwd", dev, z, w3, b3, w4, b4, y, h3,
                      batch, latent, units, seg, DTYPE_CODES[dt])
        decoder_fwd.launches += 1
    return y, h3


decoder_fwd.launches = 0


# ---------------------------------------------------------- backward kernels

def _grads(dev, *shapes) -> Tuple[Tensor, ...]:
    return tuple(torch.empty(s, device=dev, dtype=torch.float32)
                 for s in shapes)


def matmul_nt(a, w) -> Tensor:
    """``a @ wᵀ``: ``(batch, n) @ (m, n)ᵀ → (batch, m)`` in the operand
    dtype — the input-gradient product (``dz``, ``dx``).

    Replaces ``rawaudiovae_kelsey_tpu/ops/pallas_mlp.py`` ``matmul_nt``.
    CUDA: one launch of the tiled GEMM (``csrc/bwd.cu``), both operands read
    along their rows."""
    if a.device.type == "cpu":
        return matmul_nt_ref(a, w)
    dev = cuda_device(a, "matmul_nt: a")
    dt = operand_dtype(a, "matmul_nt: a")
    batch, n = a.shape
    m = w.shape[0]
    require(a, "a", (batch, n), dev, dt)
    require(w, "w", (m, n), dev, dt)
    out = torch.empty((batch, m), device=dev, dtype=dt)
    if batch:
        _build.launch("rvk_matmul_nt", dev, a, w, out, batch, n, m,
                      DTYPE_CODES[dt])
        matmul_nt.launches += 1
    return out


matmul_nt.launches = 0


def matmul_nt_mask(a, w, gate) -> Tensor:
    """The ReLU-backward step ``(a @ wᵀ) · (gate > 0)``: the decoder's
    ``dh3`` from ``da``, ``W4`` and ``h3``.  The gate compares in fp32; one
    rounding to the operand dtype.

    Replaces ``rawaudiovae_kelsey_tpu/ops/pallas_mlp.py``
    ``matmul_nt_mask``.  CUDA: one launch (``csrc/bwd.cu``), the gate as
    the GEMM's epilogue."""
    if a.device.type == "cpu":
        return matmul_nt_mask_ref(a, w, gate)
    dev = cuda_device(a, "matmul_nt_mask: a")
    dt = operand_dtype(a, "matmul_nt_mask: a")
    batch, n = a.shape
    m = w.shape[0]
    require(a, "a", (batch, n), dev, dt)
    require(w, "w", (m, n), dev, dt)
    require(gate, "gate", (batch, m), dev, dt)
    out = torch.empty((batch, m), device=dev, dtype=dt)
    if batch:
        _build.launch("rvk_matmul_nt_mask", dev, a, w, gate, out, batch, n,
                      m, DTYPE_CODES[dt])
        matmul_nt_mask.launches += 1
    return out


matmul_nt_mask.launches = 0


def matmul_nt2_mask(a1, w1, a2, w2, gate) -> Tensor:
    """The two-head ReLU backward ``(a1 @ w1ᵀ + a2 @ w2ᵀ) · (gate > 0)``:
    the encoder's ``dh`` from ``(dmu, dlogvar)``.  The gate compares in
    fp32; one rounding to the operand dtype.

    Replaces ``rawaudiovae_kelsey_tpu/ops/pallas_mlp.py``
    ``matmul_nt2_mask``.  CUDA: one launch (``csrc/bwd.cu``): one product
    over ``[a1 a2]`` and ``[w1ᵀ; w2ᵀ]`` joined along the contraction."""
    if a1.device.type == "cpu":
        return matmul_nt2_mask_ref(a1, w1, a2, w2, gate)
    dev = cuda_device(a1, "matmul_nt2_mask: a1")
    dt = operand_dtype(a1, "matmul_nt2_mask: a1")
    batch, n = a1.shape
    m = w1.shape[0]
    require(a1, "a1", (batch, n), dev, dt)
    require(w1, "w1", (m, n), dev, dt)
    require(a2, "a2", (batch, n), dev, dt)
    require(w2, "w2", (m, n), dev, dt)
    require(gate, "gate", (batch, m), dev, dt)
    out = torch.empty((batch, m), device=dev, dtype=dt)
    if batch:
        _build.launch("rvk_matmul_nt2_mask", dev, a1, w1, a2, w2, gate, out,
                      batch, n, m, DTYPE_CODES[dt])
        matmul_nt2_mask.launches += 1
    return out


matmul_nt2_mask.launches = 0


def grad_accum(a, b) -> Tuple[Tensor, Tensor]:
    """Weight and bias gradients of ``y = a @ W + bias`` given the
    cotangent ``b``: ``(aᵀ b, colsum(b))`` in fp32, contracting the batch.

    Replaces ``rawaudiovae_kelsey_tpu/ops/pallas_mlp.py`` ``grad_accum``.
    CUDA: one launch (``csrc/bwd.cu``); each block loops over the whole
    batch for its tile of dW, so the result is deterministic."""
    if a.device.type == "cpu":
        return grad_accum_ref(a, b)
    dev = cuda_device(a, "grad_accum: a")
    dt = operand_dtype(a, "grad_accum: a")
    batch, n = a.shape
    m = b.shape[1]
    require(a, "a", (batch, n), dev, dt)
    require(b, "b", (batch, m), dev, dt)
    dw, db = _grads(dev, (n, m), (m,))
    _build.launch("rvk_grad_accum", dev, a, b, dw, db, batch, n, m,
                  DTYPE_CODES[dt])
    grad_accum.launches += 1
    return dw, db


grad_accum.launches = 0


def grad_accum2(a, b1, b2) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Two :func:`grad_accum` s that share ``a``: ``(aᵀ b1, colsum(b1),
    aᵀ b2, colsum(b2))`` — the encoder's two latent heads, both
    contracting ``h``.

    Replaces ``rawaudiovae_kelsey_tpu/ops/pallas_mlp.py`` ``grad_accum2``.
    CUDA: one launch carrying both products (``csrc/bwd.cu``)."""
    if a.device.type == "cpu":
        return grad_accum2_ref(a, b1, b2)
    dev = cuda_device(a, "grad_accum2: a")
    dt = operand_dtype(a, "grad_accum2: a")
    batch, n = a.shape
    m = b1.shape[1]
    require(a, "a", (batch, n), dev, dt)
    require(b1, "b1", (batch, m), dev, dt)
    require(b2, "b2", (batch, m), dev, dt)
    dw1, db1, dw2, db2 = _grads(dev, (n, m), (m,), (n, m), (m,))
    _build.launch("rvk_grad_accum2", dev, a, b1, b2, dw1, db1, dw2, db2,
                  batch, n, m, DTYPE_CODES[dt])
    grad_accum2.launches += 1
    return dw1, db1, dw2, db2


grad_accum2.launches = 0


def enc_bwd_dw1(x, h, dmu, dlogvar, w21, w22) -> Tuple[Tensor, Tensor]:
    """Encoder first-layer gradients: ``dh = (dmu@w21ᵀ +
    dlogvar@w22ᵀ)·(h>0)`` rounded to the operand dtype, then ``(xᵀ dh,
    colsum(dh))`` in fp32.

    Replaces ``rawaudiovae_kelsey_tpu/ops/pallas_mlp.py`` ``enc_bwd_dw1``.
    CUDA: two launches (``csrc/bwd.cu``); ``dh`` goes through a scratch
    buffer between them instead of staying in VMEM."""
    if x.device.type == "cpu":
        return enc_bwd_dw1_ref(x, h, dmu, dlogvar, w21, w22)
    dev = cuda_device(x, "enc_bwd_dw1: x")
    dt = operand_dtype(x, "enc_bwd_dw1: x")
    batch, seg = x.shape
    units, latent = h.shape[1], dmu.shape[1]
    require(x, "x", (batch, seg), dev, dt)
    require(h, "h", (batch, units), dev, dt)
    require(dmu, "dmu", (batch, latent), dev, dt)
    require(dlogvar, "dlogvar", (batch, latent), dev, dt)
    require(w21, "w21", (units, latent), dev, dt)
    require(w22, "w22", (units, latent), dev, dt)
    dh = torch.empty((batch, units), device=dev, dtype=dt)
    dw1, db1 = _grads(dev, (seg, units), (units,))
    _build.launch("rvk_enc_bwd_dw1", dev, x, h, dmu, dlogvar, w21, w22, dh,
                  dw1, db1, batch, seg, units, latent, DTYPE_CODES[dt])
    enc_bwd_dw1.launches += 1
    return dw1, db1


enc_bwd_dw1.launches = 0


def dec_bwd_fused(da, h3, z, w4, w3) -> Tuple[Tensor, Tensor, Tensor]:
    """Decoder backward minus the dW4 product: ``dh3 = (da@w4ᵀ)·(h3>0)``
    rounded to the operand dtype feeds ``dz = dh3@w3ᵀ`` (operand dtype)
    and ``(zᵀ dh3, colsum(dh3))`` (fp32).

    Replaces ``rawaudiovae_kelsey_tpu/ops/pallas_mlp.py``
    ``dec_bwd_fused``.  CUDA: three launches (``csrc/bwd.cu``); ``dh3``
    goes through a scratch buffer instead of staying in VMEM."""
    if da.device.type == "cpu":
        return dec_bwd_fused_ref(da, h3, z, w4, w3)
    dev = cuda_device(da, "dec_bwd_fused: da")
    dt = operand_dtype(da, "dec_bwd_fused: da")
    batch, seg = da.shape
    units, latent = h3.shape[1], z.shape[1]
    require(da, "da", (batch, seg), dev, dt)
    require(h3, "h3", (batch, units), dev, dt)
    require(z, "z", (batch, latent), dev, dt)
    require(w4, "w4", (units, seg), dev, dt)
    require(w3, "w3", (latent, units), dev, dt)
    dh3 = torch.empty((batch, units), device=dev, dtype=dt)
    dz = torch.empty((batch, latent), device=dev, dtype=dt)
    dw3, db3 = _grads(dev, (latent, units), (units,))
    _build.launch("rvk_dec_bwd_fused", dev, da, h3, z, w4, w3, dh3, dz, dw3,
                  db3, batch, seg, units, latent, DTYPE_CODES[dt])
    dec_bwd_fused.launches += 1
    return dz, dw3, db3


dec_bwd_fused.launches = 0


def full_passes(dtype: torch.dtype) -> int:
    """The pass count of a full chain: fp32 operands reach it only as the
    ``high`` tier, whose products are the 3-pass ones; bf16 operands take
    one pass."""
    return 3 if dtype == torch.float32 else 1


def enc_bwd_full(x, h, dmu, dlogvar, w21, w22) -> Tuple[Tensor, ...]:
    """The encoder's whole parameter backward from one call → ``(dw1, db1,
    dw21, db21, dw22, db22)`` in fp32: ``dh = (dmu@w21ᵀ +
    dlogvar@w22ᵀ)·(h>0)`` feeds ``(xᵀ dh, colsum(dh))`` and one read of
    ``h`` feeds both head gradients.  fp32 operands (the ``high`` tier) run
    every product as the bf16 hi/lo 3-pass product with ``dh`` kept in
    fp32; bf16 operands take one pass and round ``dh`` to bf16
    (:func:`full_passes`).

    Replaces ``rawaudiovae_kelsey_tpu/ops/pallas_mlp.py`` ``enc_bwd_full``.
    CUDA: three launches of the tiled GEMM (``csrc/bwd.cu``); ``dh`` goes
    through a scratch buffer instead of staying in VMEM."""
    if x.device.type == "cpu":
        return enc_bwd_full_ref(x, h, dmu, dlogvar, w21, w22,
                                full_passes(x.dtype))
    dev = cuda_device(x, "enc_bwd_full: x")
    dt = operand_dtype(x, "enc_bwd_full: x")
    batch, seg = x.shape
    units, latent = h.shape[1], dmu.shape[1]
    require(x, "x", (batch, seg), dev, dt)
    require(h, "h", (batch, units), dev, dt)
    require(dmu, "dmu", (batch, latent), dev, dt)
    require(dlogvar, "dlogvar", (batch, latent), dev, dt)
    require(w21, "w21", (units, latent), dev, dt)
    require(w22, "w22", (units, latent), dev, dt)
    dh = torch.empty((batch, units), device=dev, dtype=dt)
    grads = _grads(dev, (seg, units), (units,), (units, latent), (latent,),
                   (units, latent), (latent,))
    _build.launch("rvk_enc_bwd_full", dev, x, h, dmu, dlogvar, w21, w22, dh,
                  *grads, batch, seg, units, latent, DTYPE_CODES[dt])
    enc_bwd_full.launches += 1
    return grads


enc_bwd_full.launches = 0


def dec_bwd_full(da, h3, z, w4, w3) -> Tuple[Tensor, ...]:
    """The decoder's whole backward from one call → ``(dz, dw3, db3, dw4,
    db4)``: ``dh3 = (da@w4ᵀ)·(h3>0)`` feeds ``dz = dh3@w3ᵀ`` (operand
    dtype) and ``(zᵀ dh3, colsum(dh3))``; ``(h3ᵀ da, colsum(da))`` comes
    with them (all fp32).  Three passes or one as in :func:`enc_bwd_full`.

    Replaces ``rawaudiovae_kelsey_tpu/ops/pallas_mlp.py`` ``dec_bwd_full``.
    CUDA: four launches of the tiled GEMM (``csrc/bwd.cu``); ``dh3`` goes
    through a scratch buffer instead of staying in VMEM."""
    if da.device.type == "cpu":
        return dec_bwd_full_ref(da, h3, z, w4, w3, full_passes(da.dtype))
    dev = cuda_device(da, "dec_bwd_full: da")
    dt = operand_dtype(da, "dec_bwd_full: da")
    batch, seg = da.shape
    units, latent = h3.shape[1], z.shape[1]
    require(da, "da", (batch, seg), dev, dt)
    require(h3, "h3", (batch, units), dev, dt)
    require(z, "z", (batch, latent), dev, dt)
    require(w4, "w4", (units, seg), dev, dt)
    require(w3, "w3", (latent, units), dev, dt)
    dh3 = torch.empty((batch, units), device=dev, dtype=dt)
    dz = torch.empty((batch, latent), device=dev, dtype=dt)
    grads = _grads(dev, (latent, units), (units,), (units, seg), (seg,))
    _build.launch("rvk_dec_bwd_full", dev, da, h3, z, w4, w3, dh3, dz,
                  *grads, batch, seg, units, latent, DTYPE_CODES[dt])
    dec_bwd_full.launches += 1
    return (dz, *grads)


dec_bwd_full.launches = 0


# ------------------------------------------------------ autograd Functions

# the backward modes of Encode / Decode (the JAX package's ``_fusion``)
BACKWARD_MODES = ("primitive", "split", "full")


def backward_mode(dtype: torch.dtype, fp32_backward: str) -> str:
    """The backward mode for operands of ``dtype``: fp32 takes
    ``fp32_backward`` ("primitive" for the ``float32`` and ``highest``
    tiers, "full" for ``high``, as ``pallas_mlp.py`` ``_fusion`` picks);
    bf16 takes "split" unless "full" is asked for by name (the JAX
    package's ``BWD_FUSION = "full"``)."""
    if fp32_backward not in BACKWARD_MODES:
        raise ValueError(f"unknown backward mode {fp32_backward!r}; "
                         f"expected one of {BACKWARD_MODES}")
    if dtype == torch.float32 or fp32_backward == "full":
        return fp32_backward
    return "split"


def encode_input_grad(h, dmu, dlogvar, w1, w21, w22) -> Tensor:
    """The encoder's input gradient ``dx = dh @ w1ᵀ`` with ``dh`` from
    :func:`matmul_nt2_mask` (``pallas_mlp.py:1038-1041``).  Training never
    asks for it (the JAX package leaves it to dead-code elimination)."""
    return matmul_nt(matmul_nt2_mask(dmu, w21, dlogvar, w22, h), w1)


class Encode(torch.autograd.Function):
    """``(mode, x, w1, b1, w21, b21, w22, b22) → (mu, logvar)`` through
    :func:`encoder_fwd`.  Backward, "split": :func:`enc_bwd_dw1` and
    :func:`grad_accum2`; "primitive": :func:`matmul_nt2_mask` then three
    :func:`grad_accum`; "full": :func:`enc_bwd_full`.  Saves ``(x, h)`` as
    residuals."""

    @staticmethod
    def forward(ctx, mode, x, w1, b1, w21, b21, w22, b22):
        mu, logvar, h = encoder_fwd(w1, b1, w21, b21, w22, b22, x)
        ctx.save_for_backward(x, h, w1, w21, w22)
        ctx.mode = mode
        return mu, logvar

    @staticmethod
    def backward(ctx, dmu, dlogvar):
        x, h, w1, w21, w22 = ctx.saved_tensors
        dmu, dlogvar = dmu.contiguous(), dlogvar.contiguous()
        dx = None
        if ctx.mode == "primitive":
            dh = matmul_nt2_mask(dmu, w21, dlogvar, w22, h)
            dw1, db1 = grad_accum(x, dh)
            dw21, db21 = grad_accum(h, dmu)
            dw22, db22 = grad_accum(h, dlogvar)
            if ctx.needs_input_grad[1]:
                dx = matmul_nt(dh, w1)   # dh is live already: reuse it
        elif ctx.mode == "full":
            dw1, db1, dw21, db21, dw22, db22 = enc_bwd_full(
                x, h, dmu, dlogvar, w21, w22)
            if ctx.needs_input_grad[1]:
                dx = encode_input_grad(h, dmu, dlogvar, w1, w21, w22)
        else:
            dw1, db1 = enc_bwd_dw1(x, h, dmu, dlogvar, w21, w22)
            dw21, db21, dw22, db22 = grad_accum2(h, dmu, dlogvar)
            if ctx.needs_input_grad[1]:
                dx = encode_input_grad(h, dmu, dlogvar, w1, w21, w22)
        dt = w1.dtype
        return (None, dx,
                *(g.to(dt) for g in (dw1, db1, dw21, db21, dw22, db22)))


class Decode(torch.autograd.Function):
    """``(mode, z, w3, b3, w4, b4) → y`` through :func:`decoder_fwd`.
    Backward, "split": :func:`dec_bwd_fused` and :func:`grad_accum`;
    "primitive": :func:`matmul_nt_mask`, :func:`matmul_nt` and two
    :func:`grad_accum`; "full": :func:`dec_bwd_full`.  Saves ``(z, h3, y)``
    as residuals."""

    @staticmethod
    def forward(ctx, mode, z, w3, b3, w4, b4):
        y, h3 = decoder_fwd(w3, b3, w4, b4, z)
        ctx.save_for_backward(z, h3, y, w3, w4)
        ctx.mode = mode
        return y

    @staticmethod
    def backward(ctx, dy):
        z, h3, y, w3, w4 = ctx.saved_tensors
        # tanh derivative: an elementwise pass left to PyTorch, as the JAX
        # package leaves it to XLA; fp32 inside, one rounding
        da = (_f(dy) * (1.0 - _f(y) * _f(y))).to(dy.dtype)
        if ctx.mode == "full":
            dz, dw3, db3, dw4, db4 = dec_bwd_full(da, h3, z, w4, w3)
        elif ctx.mode == "primitive":
            dh3 = matmul_nt_mask(da, w4, h3)
            dz = matmul_nt(dh3, w3)
            dw3, db3 = grad_accum(z, dh3)
            dw4, db4 = grad_accum(h3, da)
        else:
            dz, dw3, db3 = dec_bwd_fused(da, h3, z, w4, w3)
            dw4, db4 = grad_accum(h3, da)
        dt = w3.dtype
        return (None, dz, *(g.to(dt) for g in (dw3, db3, dw4, db4)))


Params = Dict[str, Dict[str, Tensor]]


def encode(params: Params, x: Tensor, fp32_backward: str = "primitive"
           ) -> Tuple[Tensor, Tensor]:
    """``models.vae.encode`` through the kernels (the role of the JAX
    package's ``pallas_encode``).  ``fp32_backward`` is the backward mode
    of fp32 operands (:func:`backward_mode`)."""
    return Encode.apply(
        backward_mode(x.dtype, fp32_backward), x,
        params["fc1"]["w"], params["fc1"]["b"],
        params["fc21"]["w"], params["fc21"]["b"],
        params["fc22"]["w"], params["fc22"]["b"],
    )


def decode(params: Params, z: Tensor, fp32_backward: str = "primitive"
           ) -> Tensor:
    """``models.vae.decode`` through the kernels (the role of the JAX
    package's ``pallas_decode``).  ``fp32_backward`` as in
    :func:`encode`."""
    return Decode.apply(
        backward_mode(z.dtype, fp32_backward), z,
        params["fc3"]["w"], params["fc3"]["b"],
        params["fc4"]["w"], params["fc4"]["b"],
    )
