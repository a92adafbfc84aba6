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
  ``pallas_decode``.  Their backward has the JAX package's three modes,
  chosen by the switch :data:`BWD_FUSION` (:func:`fusion`, the
  counterpart of ``pallas_mlp.py:993-1011``): "split", under "auto" the
  bf16 step's — ``enc_bwd_dw1`` + ``grad_accum2`` for the encoder,
  ``dec_bwd_fused`` + ``grad_accum`` for the decoder; "primitive", under
  "auto" the ``float32`` / ``highest`` tiers' — ``matmul_nt2_mask`` then
  three ``grad_accum`` for the encoder, ``matmul_nt_mask``, ``matmul_nt``
  and two ``grad_accum`` for the decoder; and "full", under "auto" the
  ``high`` tier's — ``enc_bwd_full`` and ``dec_bwd_full``, one call per
  chain.  The encoder's input gradient is ``matmul_nt2_mask`` followed by
  ``matmul_nt`` in all three.  A forced mode applies to every dtype and
  tier, and every call of a mode takes the forward's pass count.

Every kernel takes ``passes``: 1, or 3 with fp32 operands, the TPU
kernels' pass count under JAX's ambient ``high`` tier (``pallas_mlp.py:167``
``_ambient_passes``).  At 3 they launch the ``high`` tier's 3-pass forms
(``csrc/full.cu``'s chains and their parts on the tensor cores, "the
3-pass forms" below) and compute what the TPU kernels compute there; a
train or eval step binds it under ``high`` (``models/registry.py``
``under_tier``), the server and the library path never do.  The full
chains take one fp32 pass too (``float32`` / ``highest`` with "full"
forced: ``csrc/sgemm.cuh``'s launches of the split kernels).

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

from rawaudiovae_kelsey_tpu_torch.observe.spans import spanned
from rawaudiovae_kelsey_tpu_torch.ops import _build, tensor_cores

Tensor = torch.Tensor

# operand dtype → the code the C entry points take (csrc/gemm.cuh DType)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _f(t: Tensor) -> Tensor:
    return t.to(torch.float32)


# ----------------------------------------------------------- plain versions
#
# ``passes`` (1, or 3 with fp32 operands; :func:`check_passes`): the pass
# count of every product, as the TPU kernels read it from JAX's ambient
# precision tier (``pallas_mlp.py:167`` ``_ambient_passes``).  At 3 each
# product is :func:`mm3`, the bias is added after the three-pass sum, then
# the activation (``pallas_mlp.py:233-241``, ``:286-291``); h and h3 stay
# fp32 and the next product splits them again.

def encoder_fwd_ref(w1, b1, w21, b21, w22, b22, x, passes: int = 1
                    ) -> Tuple[Tensor, Tensor, Tensor]:
    """Plain version of :func:`encoder_fwd`."""
    check_passes(x.dtype, passes)
    dt = x.dtype
    h = torch.relu(_mm(x, w1, passes) + _f(b1)).to(dt)
    mu = (_mm(h, w21, passes) + _f(b21)).to(dt)
    logvar = (_mm(h, w22, passes) + _f(b22)).to(dt)
    return mu, logvar, h


def decoder_fwd_ref(w3, b3, w4, b4, z, passes: int = 1
                    ) -> Tuple[Tensor, Tensor]:
    """Plain version of :func:`decoder_fwd`."""
    check_passes(z.dtype, passes)
    dt = z.dtype
    h3 = torch.relu(_mm(z, w3, passes) + _f(b3)).to(dt)
    return torch.tanh(_mm(h3, w4, passes) + _f(b4)).to(dt), h3


def encoder_fwd_partial_ref(w1, b1, w21, w22, x, passes: int = 1
                            ) -> Tuple[Tensor, Tensor, Tensor]:
    """Plain version of :func:`encoder_fwd_partial`: ``h`` as
    :func:`encoder_fwd_ref` rounds it, the heads' fp32 sums as they are."""
    check_passes(x.dtype, passes)
    h = torch.relu(_mm(x, w1, passes) + _f(b1)).to(x.dtype)
    return _mm(h, w21, passes), _mm(h, w22, passes), h


def decoder_fwd_partial_ref(w3, b3, w4, z, passes: int = 1
                            ) -> Tuple[Tensor, Tensor]:
    """Plain version of :func:`decoder_fwd_partial`."""
    check_passes(z.dtype, passes)
    h3 = torch.relu(_mm(z, w3, passes) + _f(b3)).to(z.dtype)
    return _mm(h3, w4, passes), h3


def matmul_nt2_mask_ref(a1, w1, a2, w2, gate, passes: int = 1) -> Tensor:
    """Plain version of :func:`matmul_nt2_mask`: at 3 passes the two
    products' three-pass sums added (``pallas_mlp.py:390-392``)."""
    check_passes(a1.dtype, passes)
    prod = _mm(a1, w1.t(), passes) + _mm(a2, w2.t(), passes)
    return torch.where(_f(gate) > 0, prod, 0.0).to(a1.dtype)


def matmul_nt_mask_ref(a, w, gate, passes: int = 1) -> Tensor:
    """Plain version of :func:`matmul_nt_mask`: at 3 passes the product's
    three-pass sum, gated, kept fp32 (``pallas_mlp.py:357-360``)."""
    check_passes(a.dtype, passes)
    return torch.where(_f(gate) > 0, _mm(a, w.t(), passes),
                       0.0).to(a.dtype)


def matmul_nt_ref(a, w, passes: int = 1) -> Tensor:
    """Plain version of :func:`matmul_nt`."""
    check_passes(a.dtype, passes)
    return _mm(a, w.t(), passes).to(a.dtype)


def grad_accum_ref(a, b, passes: int = 1) -> Tuple[Tensor, Tensor]:
    """Plain version of :func:`grad_accum`: at 3 passes ``aᵀ b`` with both
    operands split and ``colsum(b)`` of the unsplit values
    (``pallas_mlp.py:439-449``)."""
    check_passes(a.dtype, passes)
    return _mm(a.t(), b, passes), _f(b).sum(0)


def grad_accum2_ref(a, b1, b2, passes: int = 1
                    ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Plain version of :func:`grad_accum2`."""
    return (*grad_accum_ref(a, b1, passes), *grad_accum_ref(a, b2, passes))


def enc_bwd_dw1_ref(x, h, dmu, dlogvar, w21, w22, passes: int = 1
                    ) -> Tuple[Tensor, Tensor]:
    """Plain version of :func:`enc_bwd_dw1`: ``dh`` rounded to the operand
    dtype (``pallas_mlp.py:535``; at 3 passes fp32 and unrounded,
    ``:524-530``), then ``(xᵀ dh, colsum(dh))``."""
    return grad_accum_ref(
        x, matmul_nt2_mask_ref(dmu, w21, dlogvar, w22, h, passes), passes)


def dec_bwd_fused_ref(da, h3, z, w4, w3, passes: int = 1
                      ) -> Tuple[Tensor, Tensor, Tensor]:
    """Plain version of :func:`dec_bwd_fused`: ``dh3`` rounded to the
    operand dtype (``pallas_mlp.py:686``; at 3 passes fp32, ``:676-684``),
    then ``dz = dh3 @ w3ᵀ`` in it and ``(zᵀ dh3, colsum(dh3))`` in fp32."""
    dh3 = matmul_nt_mask_ref(da, w4, h3, passes)
    return (matmul_nt_ref(dh3, w3, passes), *grad_accum_ref(z, dh3, passes))


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


def split_pass_ref(v: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """Plain version of :func:`split_pass`: :func:`split_hi_lo` 's halves
    as bf16 tensors, and ``v.sum(0)`` of the unsplit values in fp32."""
    hi, lo = split_hi_lo(v)
    return hi.to(torch.bfloat16), lo.to(torch.bfloat16), _f(v).sum(0)


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
    # one fused test on the launch path; the messages only on a failure
    if (isinstance(t, Tensor) and t.device == device and t.dtype == dtype
            and t.shape == shape and t.is_contiguous()):
        return
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

@spanned("rvk.row01.encoder_fwd")
def encoder_fwd(w1, b1, w21, b21, w22, b22, x, kernel: str = "auto",
                passes: int = 1) -> Tuple[Tensor, Tensor, Tensor]:
    """Fused ``relu(x@W1+b1)`` → ``(mu, logvar, h)``.

    Replaces ``rawaudiovae_kelsey_tpu/ops/pallas_mlp.py`` ``encoder_fwd``.
    CUDA, two products (``csrc/mlp.cu``), h then both heads in one launch,
    of one of three hand-written kernels chosen by :func:`resolve_encoder`:
    bf16 operands with seg, units and latent multiples of 8 and 16-byte
    aligned pointers take the tensor-core kernel (``csrc/wgmma.cuh``; the
    heads as one walk over both outputs); fp32 operands with them multiples
    of 4 and 16-byte aligned pointers the register-tiled fp32 kernel
    (``csrc/sgemm.cuh``: IEEE FFMAs, the heads as one grid over both
    outputs, each product's tile and slices of its contraction from
    ``tensor_cores.sgemm_fwd_plan``; a product cut into slices adds them in
    order through a workspace allocated here, with the bias and the
    activation after the sum); everything else the tiled GEMM on the CUDA
    cores.  ``kernel`` (``"auto"`` or a key of
    ``tensor_cores.KERNEL_CODES``) names one instead; a kernel named on
    operands it cannot take raises.  Either way h, mu and logvar are each
    rounded once to the operand dtype from fp32 sums, and the heads read the
    rounded h.  ``passes = 3`` (fp32 operands; the ``high`` tier of a train
    or eval step, ``models/registry.py`` ``under_tier``) takes the 3-pass
    form instead (:func:`encoder_fwd3`).  One call counts once in
    ``launches``, and in ``tensor_core_launches``, ``sgemm_launches`` or
    ``split_launches`` too when that kernel ran it."""
    tensor_cores.check_name("encoder_fwd", kernel)
    check_passes(x.dtype, passes)
    if x.device.type == "cpu":
        return encoder_fwd_ref(w1, b1, w21, b21, w22, b22, x, passes)
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
    if passes == 3:
        return encoder_fwd3(kernel, dev, x, w1, b1, w21, b21, w22, b22)
    code = resolve_encoder(kernel, dt, batch, seg, units, latent,
                           tensor_cores.pointers_aligned(x, w1, b1, w21, b21,
                                                         w22, b22))
    mu = torch.empty((batch, latent), device=dev, dtype=dt)
    logvar = torch.empty((batch, latent), device=dev, dtype=dt)
    h = torch.empty((batch, units), device=dev, dtype=dt)
    if batch:
        (tile_h, split_h), (tile_o, split_o), ws = forward_plans(
            code, dev, batch, ((seg, units, 1), (units, latent, 2)))
        _build.launch("rvk_encoder_fwd", dev, x, w1, b1, w21, b21, w22, b22,
                      mu, logvar, h, ws, batch, seg, units, latent,
                      DTYPE_CODES[dt], split_h, split_o, tile_h, tile_o, code)
        encoder_fwd.launches += 1
        encoder_fwd.tensor_core_launches += code == tensor_cores.TENSOR_CORES
        encoder_fwd.sgemm_launches += code == tensor_cores.SGEMM
    return mu, logvar, h


encoder_fwd.launches = 0
encoder_fwd.tensor_core_launches = 0
encoder_fwd.sgemm_launches = 0
encoder_fwd.split_launches = 0
encoder_fwd.partial_launches = 0


@spanned("rvk.row01.encoder_fwd")
def encoder_fwd_partial(w1, b1, w21, w22, x, kernel: str = "auto",
                        passes: int = 1) -> Tuple[Tensor, Tensor, Tensor]:
    """The row-parallel form of :func:`encoder_fwd` (tensor parallelism,
    ``parallel/tensor_parallel.py``): ``h = relu(x@W1+b1)`` on a rank's
    column shard of fc1, rounded once to the operand dtype, then ``(h@W21,
    h@W22)`` on its row shard of the heads as fp32 partial sums, no bias →
    ``(mu_part, logvar_part, h)``.  The model group adds the partial sums;
    the heads' biases and the one rounding come after the sum.

    The same kernels as :func:`encoder_fwd`, chosen by
    :func:`resolve_encoder` (``csrc/mlp.cu`` ``rvk_encoder_fwd_partial``):
    on the tensor cores the heads' launch stores the fp32 accumulators
    (``csrc/wgmma.cuh`` ``PartialRows``); the fp32 kernel and the first
    version run their heads with no bias into fp32 outputs; ``passes = 3``
    the 3-pass form with no head biases (:func:`encoder_fwd3`).  A call
    counts in ``encoder_fwd.launches`` and ``encoder_fwd.partial_launches``
    (and the kernel's own counter) — one launch of row 1's kernel."""
    tensor_cores.check_name("encoder_fwd", kernel)
    check_passes(x.dtype, passes)
    if x.device.type == "cpu":
        return encoder_fwd_partial_ref(w1, b1, w21, w22, x, passes)
    dev = cuda_device(x, "encoder_fwd_partial: x")
    dt = operand_dtype(x, "encoder_fwd_partial: x")
    batch, seg = x.shape
    units, latent = w1.shape[1], w21.shape[1]
    require(x, "x", (batch, seg), dev, dt)
    require(w1, "w1", (seg, units), dev, dt)
    require(b1, "b1", (units,), dev, dt)
    require(w21, "w21", (units, latent), dev, dt)
    require(w22, "w22", (units, latent), dev, dt)
    if passes == 3:
        return encoder_fwd3(kernel, dev, x, w1, b1, w21, None, w22, None)
    code = resolve_encoder(kernel, dt, batch, seg, units, latent,
                           tensor_cores.pointers_aligned(x, w1, b1, w21,
                                                         w22))
    mu = torch.empty((batch, latent), device=dev, dtype=torch.float32)
    logvar = torch.empty((batch, latent), device=dev, dtype=torch.float32)
    h = torch.empty((batch, units), device=dev, dtype=dt)
    if batch:
        (tile_h, split_h), (tile_o, split_o), ws = forward_plans(
            code, dev, batch, ((seg, units, 1), (units, latent, 2)))
        _build.launch("rvk_encoder_fwd_partial", dev, x, w1, b1, w21, w22,
                      mu, logvar, h, ws, batch, seg, units, latent,
                      DTYPE_CODES[dt], split_h, split_o, tile_h, tile_o, code)
        _count(encoder_fwd, code)
    return mu, logvar, h


def _count(wrapper, code: int) -> None:
    """One launch of a row-parallel form: ``wrapper``'s counters."""
    wrapper.launches += 1
    wrapper.partial_launches += 1
    wrapper.tensor_core_launches += code == tensor_cores.TENSOR_CORES
    wrapper.sgemm_launches += code == tensor_cores.SGEMM


# --------------------------------------------------- the 3-pass forms (high)
#
# Under JAX's ambient ``high`` tier the dense TPU kernels take every fp32
# product in three bf16 passes (``pallas_mlp.py:167`` ``_ambient_passes``):
# rows 1, 2, 4 and 6 in the ``high`` step, rows 5 and 7-10 with the
# backward-fusion switch forced to "split" or "primitive".  Their
# ``passes = 3`` forms here launch the chains of ``csrc/full.cu`` on the
# tensor cores (the split pass, then each product one 3-pass launch of
# ``csrc/wgmma.cuh``) or, for widths no multiple of 8 and unaligned views,
# the first version's 3-pass operand mode (``csrc/gemm.cuh``); never the
# IEEE fp32 kernel of ``sgemm.cuh``.  A launch counts in its wrapper's
# ``launches`` and, on the tensor cores, ``split_launches`` (and
# ``partial_launches`` for a row-parallel form).

# what a 3-pass form takes, in resolve's errors
TAKES_SPLIT = ("fp32 operands with every width a multiple of "
               f"{tensor_cores.TMA_ALIGN_BF16}, at least one row and 16-byte "
               "aligned pointers")
IEEE_ONLY = "one pass (IEEE fp32; passes = 3 runs on the tensor cores or " \
    "the first version)"


def resolve_split(op: str, kernel: str, batch: int, *widths: int,
                  aligned: bool = True) -> int:
    """The kernel code a 3-pass form of ``op`` launches with: the tensor
    cores when ``tensor_cores.takes_full_chain`` holds for fp32 operands
    (every width a multiple of 8, 16-byte aligned pointers), else the first
    version; ``kernel`` names one instead, and ``"sgemm"`` (IEEE fp32)
    raises."""
    return tensor_cores.resolve(
        op, kernel,
        tensor_cores.takes_full_chain(torch.float32, batch, *widths,
                                      aligned=aligned),
        lambda: f"batch {batch}, widths {widths}, aligned = {aligned}",
        takes=TAKES_SPLIT, takes_sgemm=IEEE_ONLY)


def split_scratch(dev, code: int, *shapes) -> Tensor | None:
    """The bf16 halves (hi then lo) of the fp32 matrices of ``shapes``, in
    that order, that a 3-pass chain on the tensor cores splits into
    (``csrc/full.cu`` ``SplitPool``); None for the first version."""
    if code != tensor_cores.TENSOR_CORES:
        return None
    return torch.empty((2 * sum(r * c for r, c in shapes),), device=dev,
                       dtype=torch.bfloat16)


def split_workspace(dev, batch: int, summed: Tuple[int, ...],
                    slices: Tuple[Tuple[int, int, int, int], ...]
                    ) -> Tensor | None:
    """The fp32 workspace of a chain of launches on one stream, which take
    turns with it: the split pass's column-sum partials of ``batch`` rows
    of each width in ``summed`` (a partial a block of :data:`SPLIT_ROWS`
    rows, ``csrc/split.cuh``), and each weight gradient's slices ``(split,
    m, n, outputs)``: ``outputs · split · (m·n + n)`` floats for a dW
    ``(m, n)`` cut into more than one slice.  None where nothing needs
    it."""
    need = max([outs * split * (m * n + n) for split, m, n, outs in slices
                if split > 1], default=0)
    blocks = -(-batch // SPLIT_ROWS)
    if summed and blocks > 1:
        need = max(need, blocks * max(summed))
    return torch.empty((need,), device=dev) if need else None


def _count3(wrapper, code: int, partial: bool) -> None:
    """One launch of a 3-pass form: ``wrapper``'s counters."""
    wrapper.launches += 1
    wrapper.split_launches += code == tensor_cores.TENSOR_CORES
    if partial:
        wrapper.partial_launches += 1


def encoder_fwd3(kernel: str, dev, x, w1, b1, w21, b21, w22, b22
                 ) -> Tuple[Tensor, Tensor, Tensor]:
    """The 3-pass form of :func:`encoder_fwd` (the ``high`` tier's row 1)
    on operands the wrapper has checked: ``h = relu(x@W1 + b1)``, then
    ``h@W21 + b21`` and ``h@W22 + b22``, each product in three bf16 passes
    with the bias after the three-pass sum, h fp32 and split again for the
    heads.  ``b21`` and ``b22`` None: the row-parallel form (the heads'
    fp32 partial sums, no bias).  One call of ``rvk_encoder_fwd3``: on the
    tensor cores the split pass of x, W1, W21, W22 and h, h as one 3-pass
    launch and both heads in one two-output 3-pass launch
    (``csrc/full.cu`` ``encoder_split``); the first version in
    ``csrc/gemm.cuh`` 's 3-pass mode."""
    batch, seg = x.shape
    units, latent = w1.shape[1], w21.shape[1]
    code = resolve_split("encoder_fwd", kernel, batch, seg, units, latent,
                         aligned=tensor_cores.pointers_aligned(
                             x, w1, b1, w21, w22,
                             *(b for b in (b21, b22) if b is not None)))
    mu = torch.empty((batch, latent), device=dev)
    logvar = torch.empty((batch, latent), device=dev)
    h = torch.empty((batch, units), device=dev)
    if batch:
        splits = split_scratch(dev, code, (batch, seg), (seg, units),
                               (units, latent), (units, latent),
                               (batch, units))
        _build.launch("rvk_encoder_fwd3", dev, x, w1, b1, w21, b21, w22, b22,
                      mu, logvar, h, splits, batch, seg, units, latent,
                      tensor_cores.split_tile(code, dev, batch, units),
                      tensor_cores.split_tile(code, dev, batch, latent, 2),
                      code)
        _count3(encoder_fwd, code, b21 is None)
    return mu, logvar, h


def decoder_fwd3(kernel: str, dev, z, w3, b3, w4, b4
                 ) -> Tuple[Tensor, Tensor]:
    """The 3-pass form of :func:`decoder_fwd` (the ``high`` tier's row 2):
    ``h3 = relu(z@W3 + b3)``, then ``tanh(h3@W4 + b4)``, as
    :func:`encoder_fwd3`; ``b4`` None: the row-parallel form (y's fp32
    partial sums, no bias, no tanh).  One call of ``rvk_decoder_fwd3``
    (``csrc/full.cu`` ``decoder_split``: the split pass of z, W3, W4 and
    h3, then h3 and y each one 3-pass launch)."""
    batch, latent = z.shape
    units, seg = w3.shape[1], w4.shape[1]
    code = resolve_split("decoder_fwd", kernel, batch, latent, units, seg,
                         aligned=tensor_cores.pointers_aligned(
                             z, w3, b3, w4, *(() if b4 is None else (b4,))))
    y = torch.empty((batch, seg), device=dev)
    h3 = torch.empty((batch, units), device=dev)
    if batch:
        splits = split_scratch(dev, code, (batch, latent), (latent, units),
                               (units, seg), (batch, units))
        _build.launch("rvk_decoder_fwd3", dev, z, w3, b3, w4, b4, y, h3,
                      splits, batch, latent, units, seg,
                      tensor_cores.split_tile(code, dev, batch, units),
                      tensor_cores.split_tile(code, dev, batch, seg), code)
        _count3(decoder_fwd, code, b4 is None)
    return y, h3


def forward_plans(code: int, dev, batch: int, products):
    """``(tile, split)`` of each product ``(k, n, outputs)`` of a forward
    kernel launched with ``code`` (``tensor_cores.fwd``), then the fp32
    workspace the split ones share, one after the other: ``split ·
    outputs · batch · n`` floats for the largest, or None where no product
    is split."""
    plans = [tensor_cores.fwd(code, dev, batch, k, n, outputs)
             for k, n, outputs in products]
    size = max((split * outputs * batch * n
                for (_, split), (_, n, outputs) in zip(plans, products)
                if split > 1), default=0)
    ws = torch.empty((size,), device=dev, dtype=torch.float32) \
        if size else None
    return (*plans, ws)


def resolve_encoder(kernel: str, dtype: torch.dtype, batch: int, seg: int,
                    units: int, latent: int, aligned: bool = True) -> int:
    """The kernel code :func:`encoder_fwd` launches with: the tensor cores
    when both of its products fit them (``tensor_cores.takes_tensor_cores``
    of the hidden layer, contraction ``seg`` and width ``units``, and of the
    heads, ``units`` and ``latent``), the fp32 kernel when both fit it
    (``tensor_cores.takes_sgemm``), else the first version; ``kernel``
    names one instead (``tensor_cores.resolve``)."""
    return tensor_cores.resolve(
        "encoder_fwd", kernel,
        tensor_cores.takes_tensor_cores(dtype, batch, seg, units, aligned)
        and tensor_cores.takes_tensor_cores(dtype, batch, units, latent),
        lambda: f"{dtype}, batch {batch}, seg {seg}, units {units}, latent "
                f"{latent}, aligned = {aligned}",
        tensor_cores.takes_sgemm(dtype, batch, seg, units, aligned)
        and tensor_cores.takes_sgemm(dtype, batch, units, latent))


@spanned("rvk.row02.decoder_fwd")
def decoder_fwd(w3, b3, w4, b4, z, kernel: str = "auto", passes: int = 1
                ) -> Tuple[Tensor, Tensor]:
    """Fused ``tanh(relu(z@W3+b3)@W4+b4)`` → ``(y, h3)``.

    Replaces ``rawaudiovae_kelsey_tpu/ops/pallas_mlp.py`` ``decoder_fwd``.
    CUDA, two products (``csrc/mlp.cu``), h3 then y, of one of three
    hand-written kernels chosen by :func:`resolve_decoder`: bf16 operands
    with latent, units and seg multiples of 8 and 16-byte aligned pointers
    take the tensor-core kernel (``csrc/wgmma.cuh``); fp32 operands with
    them multiples of 4 and 16-byte aligned pointers the register-tiled
    fp32 kernel (``csrc/sgemm.cuh``, planned and split as for
    :func:`encoder_fwd`); everything else the tiled GEMM on the CUDA cores.
    ``kernel`` (``"auto"`` or a key of ``tensor_cores.KERNEL_CODES``) names
    one instead; a kernel named on operands it cannot take raises.  Either
    way h3 and y are each rounded once to the operand dtype from fp32 sums,
    and y reads the rounded h3.  ``passes = 3`` (fp32 operands, the
    ``high`` tier of a step) takes the 3-pass form (:func:`decoder_fwd3`).
    One call counts once in ``launches``, and in ``tensor_core_launches``,
    ``sgemm_launches`` or ``split_launches`` too when that kernel ran it."""
    tensor_cores.check_name("decoder_fwd", kernel)
    check_passes(z.dtype, passes)
    if z.device.type == "cpu":
        return decoder_fwd_ref(w3, b3, w4, b4, z, passes)
    dev = cuda_device(z, "decoder_fwd: z")
    dt = operand_dtype(z, "decoder_fwd: z")
    batch, latent = z.shape
    units, seg = w3.shape[1], w4.shape[1]
    require(z, "z", (batch, latent), dev, dt)
    require(w3, "w3", (latent, units), dev, dt)
    require(b3, "b3", (units,), dev, dt)
    require(w4, "w4", (units, seg), dev, dt)
    require(b4, "b4", (seg,), dev, dt)
    if passes == 3:
        return decoder_fwd3(kernel, dev, z, w3, b3, w4, b4)
    code = resolve_decoder(kernel, dt, batch, latent, units, seg,
                           tensor_cores.pointers_aligned(z, w3, b3, w4, b4))
    y = torch.empty((batch, seg), device=dev, dtype=dt)
    h3 = torch.empty((batch, units), device=dev, dtype=dt)
    if batch:
        (tile_h, split_h), (tile_o, split_o), ws = forward_plans(
            code, dev, batch, ((latent, units, 1), (units, seg, 1)))
        _build.launch("rvk_decoder_fwd", dev, z, w3, b3, w4, b4, y, h3, ws,
                      batch, latent, units, seg, DTYPE_CODES[dt], split_h,
                      split_o, tile_h, tile_o, code)
        decoder_fwd.launches += 1
        decoder_fwd.tensor_core_launches += code == tensor_cores.TENSOR_CORES
        decoder_fwd.sgemm_launches += code == tensor_cores.SGEMM
    return y, h3


decoder_fwd.launches = 0
decoder_fwd.tensor_core_launches = 0
decoder_fwd.sgemm_launches = 0
decoder_fwd.split_launches = 0
decoder_fwd.partial_launches = 0


@spanned("rvk.row02.decoder_fwd")
def decoder_fwd_partial(w3, b3, w4, z, kernel: str = "auto",
                        passes: int = 1) -> Tuple[Tensor, Tensor]:
    """The row-parallel form of :func:`decoder_fwd`: ``h3 =
    relu(z@W3+b3)`` on a rank's column shard of fc3, rounded once, then
    ``h3@W4`` on its row shard of fc4 as fp32 partial sums, no bias, no
    tanh → ``(y_part, h3)``; the model group adds the sums, then ``b4``,
    tanh and the one rounding.  The same kernels as :func:`decoder_fwd`
    (``csrc/mlp.cu`` ``rvk_decoder_fwd_partial``; on the tensor cores y's
    launch stores the fp32 accumulators, ``csrc/wgmma.cuh``
    ``PartialRows``; ``passes = 3`` the 3-pass form with no bias and no
    tanh, :func:`decoder_fwd3`), counted as :func:`encoder_fwd_partial`
    is."""
    tensor_cores.check_name("decoder_fwd", kernel)
    check_passes(z.dtype, passes)
    if z.device.type == "cpu":
        return decoder_fwd_partial_ref(w3, b3, w4, z, passes)
    dev = cuda_device(z, "decoder_fwd_partial: z")
    dt = operand_dtype(z, "decoder_fwd_partial: z")
    batch, latent = z.shape
    units, seg = w3.shape[1], w4.shape[1]
    require(z, "z", (batch, latent), dev, dt)
    require(w3, "w3", (latent, units), dev, dt)
    require(b3, "b3", (units,), dev, dt)
    require(w4, "w4", (units, seg), dev, dt)
    if passes == 3:
        return decoder_fwd3(kernel, dev, z, w3, b3, w4, None)
    code = resolve_decoder(kernel, dt, batch, latent, units, seg,
                           tensor_cores.pointers_aligned(z, w3, b3, w4))
    y = torch.empty((batch, seg), device=dev, dtype=torch.float32)
    h3 = torch.empty((batch, units), device=dev, dtype=dt)
    if batch:
        (tile_h, split_h), (tile_o, split_o), ws = forward_plans(
            code, dev, batch, ((latent, units, 1), (units, seg, 1)))
        _build.launch("rvk_decoder_fwd_partial", dev, z, w3, b3, w4, y, h3,
                      ws, batch, latent, units, seg, DTYPE_CODES[dt],
                      split_h, split_o, tile_h, tile_o, code)
        _count(decoder_fwd, code)
    return y, h3


def resolve_decoder(kernel: str, dtype: torch.dtype, batch: int, latent: int,
                    units: int, seg: int, aligned: bool = True) -> int:
    """The kernel code :func:`decoder_fwd` launches with: the tensor cores
    when both of its products fit them (``tensor_cores.takes_tensor_cores``
    of the hidden layer, contraction ``latent`` and width ``units``, and of
    the output layer, ``units`` and ``seg``), the fp32 kernel when both fit
    it (``tensor_cores.takes_sgemm``), else the first version; ``kernel``
    names one instead (``tensor_cores.resolve``)."""
    return tensor_cores.resolve(
        "decoder_fwd", kernel,
        tensor_cores.takes_tensor_cores(dtype, batch, latent, units, aligned)
        and tensor_cores.takes_tensor_cores(dtype, batch, units, seg),
        lambda: f"{dtype}, batch {batch}, latent {latent}, units {units}, "
                f"seg {seg}, aligned = {aligned}",
        tensor_cores.takes_sgemm(dtype, batch, latent, units, aligned)
        and tensor_cores.takes_sgemm(dtype, batch, units, seg))


# ---------------------------------------------------------- backward kernels

def _grads(dev, *shapes) -> Tuple[Tensor, ...]:
    return tuple(torch.empty(s, device=dev, dtype=torch.float32)
                 for s in shapes)


@spanned("rvk.row04.matmul_nt")
def matmul_nt(a, w, kernel: str = "auto", passes: int = 1) -> Tensor:
    """``a @ wᵀ``: ``(batch, n) @ (m, n)ᵀ → (batch, m)`` in the operand
    dtype — the input-gradient product (``dz``, ``dx``).

    Replaces ``rawaudiovae_kelsey_tpu/ops/pallas_mlp.py`` ``matmul_nt``.
    CUDA, one launch of one of three hand-written kernels, both operands
    read along their rows, chosen by ``tensor_cores.resolve_kernel``: bf16
    operands with n and m multiples of 8 and 16-byte aligned pointers take
    the tensor-core kernel (``csrc/wgmma.cuh``); fp32 operands with n and m
    multiples of 4 and 16-byte aligned pointers the register-tiled fp32
    kernel (``csrc/sgemm.cuh``); everything else the tiled GEMM on the CUDA
    cores (``csrc/bwd.cu``).  ``kernel`` names one instead
    (``tensor_cores.KERNEL_CODES``); a kernel named on operands it cannot
    take raises.  The kernels round differently, so the output's bits
    depend on the choice and hence on the pointers' alignment (an unaligned
    contiguous view may differ from the aligned tensor by a bf16 ulp).
    ``passes = 3`` (fp32 operands: ``dx`` under the ``high`` tier) takes
    the 3-pass form: one call of ``rvk_matmul_nt3``, on the tensor cores
    the split pass of a and w, then one 3-pass launch (``csrc/full.cu``
    ``matmul_nt_split``), for widths no multiple of 8 and unaligned views
    the first version's 3-pass mode.  One call counts once in
    ``launches``, whichever ran, and in ``tensor_core_launches``,
    ``sgemm_launches`` or ``split_launches`` too when that one ran."""
    tensor_cores.check_name("matmul_nt", kernel)
    check_passes(a.dtype, passes)
    if a.device.type == "cpu":
        return matmul_nt_ref(a, w, passes)
    dev = cuda_device(a, "matmul_nt: a")
    dt = operand_dtype(a, "matmul_nt: a")
    batch, n = a.shape
    m = w.shape[0]
    require(a, "a", (batch, n), dev, dt)
    require(w, "w", (m, n), dev, dt)
    if passes == 3:
        code = resolve_split("matmul_nt", kernel, batch, n, m,
                             aligned=tensor_cores.pointers_aligned(a, w))
        out = torch.empty((batch, m), device=dev)
        if batch:
            _build.launch("rvk_matmul_nt3", dev, a, w, out,
                          split_scratch(dev, code, (batch, n), (m, n)),
                          batch, n, m,
                          tensor_cores.split_tile(code, dev, batch, m), code)
            _count3(matmul_nt, code, False)
        return out
    code = tensor_cores.resolve_kernel(
        "matmul_nt", kernel, dt, batch, n, m,
        tensor_cores.pointers_aligned(a, w))
    out = torch.empty((batch, m), device=dev, dtype=dt)
    if batch:
        _build.launch("rvk_matmul_nt", dev, a, w, out, batch, n, m,
                      DTYPE_CODES[dt], tensor_cores.tile(code, dev, batch, m),
                      code)
        matmul_nt.launches += 1
        matmul_nt.tensor_core_launches += code == tensor_cores.TENSOR_CORES
        matmul_nt.sgemm_launches += code == tensor_cores.SGEMM
    return out


matmul_nt.launches = 0
matmul_nt.tensor_core_launches = 0
matmul_nt.sgemm_launches = 0
matmul_nt.split_launches = 0


@spanned("rvk.row05.matmul_nt_mask")
def matmul_nt_mask(a, w, gate, kernel: str = "auto", passes: int = 1
                   ) -> Tensor:
    """The ReLU-backward step ``(a @ wᵀ) · (gate > 0)``: the decoder's
    ``dh3`` from ``da``, ``W4`` and ``h3``.  The gate compares in fp32; one
    rounding to the operand dtype.

    Replaces ``rawaudiovae_kelsey_tpu/ops/pallas_mlp.py``
    ``matmul_nt_mask``.  CUDA, one launch (``csrc/bwd.cu``) of one of three
    hand-written kernels, the gate in each one's epilogue, chosen by
    ``tensor_cores.resolve_kernel`` as for :func:`matmul_nt` (every
    operand's pointer, the gate's too, counts for the alignment): bf16
    operands with n and m multiples of 8 take the tensor-core kernel
    (``csrc/wgmma.cuh``, ``dec_bwd_fused`` 's dh3 launch: the gate's boxes
    TMA-loaded where the output goes); fp32 operands with n and m multiples
    of 4 the register-tiled fp32 kernel (``csrc/sgemm.cuh``
    ``launch_gated``: IEEE FFMAs, the gate's 16-byte chunk read where the
    output's goes); everything else the tiled GEMM on the CUDA cores.
    ``kernel`` names one instead; a kernel named on operands it cannot take
    raises.  Every kernel gives equal bits on a second launch.  ``passes =
    3`` (fp32 operands: dh3 under the ``high`` tier with the switch forced
    to "primitive") takes the 3-pass form: one call of
    ``rvk_matmul_nt_mask3``, on the tensor cores the split pass of a and w,
    then dh3's gated 3-pass launch of ``dec_bwd_full`` 's chain
    (``csrc/full.cu`` ``matmul_nt_split``), fp32 out, for widths no multiple
    of 8 and unaligned views the first version's 3-pass mode.  One call
    counts once in ``launches``, and in ``tensor_core_launches``,
    ``sgemm_launches`` or ``split_launches`` too when that one ran."""
    tensor_cores.check_name("matmul_nt_mask", kernel)
    check_passes(a.dtype, passes)
    if a.device.type == "cpu":
        return matmul_nt_mask_ref(a, w, gate, passes)
    dev = cuda_device(a, "matmul_nt_mask: a")
    dt = operand_dtype(a, "matmul_nt_mask: a")
    batch, n = a.shape
    m = w.shape[0]
    require(a, "a", (batch, n), dev, dt)
    require(w, "w", (m, n), dev, dt)
    require(gate, "gate", (batch, m), dev, dt)
    if passes == 3:
        code = resolve_split(
            "matmul_nt_mask", kernel, batch, n, m,
            aligned=tensor_cores.pointers_aligned(a, w, gate))
        out = torch.empty((batch, m), device=dev)
        if batch:
            _build.launch("rvk_matmul_nt_mask3", dev, a, w, gate, out,
                          split_scratch(dev, code, (batch, n), (m, n)),
                          batch, n, m,
                          tensor_cores.split_tile(code, dev, batch, m), code)
            _count3(matmul_nt_mask, code, False)
        return out
    code = tensor_cores.resolve_kernel(
        "matmul_nt_mask", kernel, dt, batch, n, m,
        tensor_cores.pointers_aligned(a, w, gate))
    out = torch.empty((batch, m), device=dev, dtype=dt)
    if batch:
        _build.launch("rvk_matmul_nt_mask", dev, a, w, gate, out, batch, n,
                      m, DTYPE_CODES[dt],
                      tensor_cores.tile(code, dev, batch, m), code)
        matmul_nt_mask.launches += 1
        matmul_nt_mask.tensor_core_launches += \
            code == tensor_cores.TENSOR_CORES
        matmul_nt_mask.sgemm_launches += code == tensor_cores.SGEMM
    return out


matmul_nt_mask.launches = 0
matmul_nt_mask.tensor_core_launches = 0
matmul_nt_mask.sgemm_launches = 0
matmul_nt_mask.split_launches = 0


@spanned("rvk.row06.matmul_nt2_mask")
def matmul_nt2_mask(a1, w1, a2, w2, gate, kernel: str = "auto",
                    passes: int = 1) -> Tensor:
    """The two-head ReLU backward ``(a1 @ w1ᵀ + a2 @ w2ᵀ) · (gate > 0)``:
    the encoder's ``dh`` from ``(dmu, dlogvar)``.  The gate compares in
    fp32; one rounding to the operand dtype.

    Replaces ``rawaudiovae_kelsey_tpu/ops/pallas_mlp.py``
    ``matmul_nt2_mask``.  CUDA, one launch (``csrc/bwd.cu``) of one of three
    hand-written kernels, each one product over ``[a1 a2]`` and ``[w1 w2]``
    joined along the contraction (the first pair's k, then the second's,
    into one fp32 accumulator) with the gate in its epilogue, chosen as for
    :func:`matmul_nt_mask` on a pair's contraction ``n``: bf16 operands
    take the tensor-core kernel (``csrc/wgmma.cuh``, ``enc_bwd_dw1`` 's dh
    launch), fp32 ones the register-tiled fp32 kernel (``csrc/sgemm.cuh``
    ``launch_gated``, both operands joined as their slabs are copied),
    everything else the tiled GEMM on the CUDA cores.  ``kernel``, the
    counters and the bits as for :func:`matmul_nt_mask`.  ``passes = 3``
    (fp32 operands: the encoder's ``dh`` for ``dx`` under the ``high``
    tier) takes the 3-pass form: one call of ``rvk_matmul_nt2_mask3``, on
    the tensor cores the split pass of the four operands, then one 3-pass
    walk joined along k and gated in fp32 (``csrc/full.cu``
    ``matmul_nt_split``, the dh launch of ``enc_bwd_full`` 's chain), for
    widths no multiple of 8 and unaligned views the first version's 3-pass
    mode; counted in ``split_launches`` on the tensor cores."""
    tensor_cores.check_name("matmul_nt2_mask", kernel)
    check_passes(a1.dtype, passes)
    if a1.device.type == "cpu":
        return matmul_nt2_mask_ref(a1, w1, a2, w2, gate, passes)
    dev = cuda_device(a1, "matmul_nt2_mask: a1")
    dt = operand_dtype(a1, "matmul_nt2_mask: a1")
    batch, n = a1.shape
    m = w1.shape[0]
    require(a1, "a1", (batch, n), dev, dt)
    require(w1, "w1", (m, n), dev, dt)
    require(a2, "a2", (batch, n), dev, dt)
    require(w2, "w2", (m, n), dev, dt)
    require(gate, "gate", (batch, m), dev, dt)
    if passes == 3:
        code = resolve_split(
            "matmul_nt2_mask", kernel, batch, n, m,
            aligned=tensor_cores.pointers_aligned(a1, w1, a2, w2, gate))
        out = torch.empty((batch, m), device=dev)
        if batch:
            _build.launch("rvk_matmul_nt2_mask3", dev, a1, w1, a2, w2, gate,
                          out, split_scratch(dev, code, (batch, n), (m, n),
                                             (batch, n), (m, n)),
                          batch, n, m,
                          tensor_cores.split_tile(code, dev, batch, m), code)
            _count3(matmul_nt2_mask, code, False)
        return out
    code = tensor_cores.resolve_kernel(
        "matmul_nt2_mask", kernel, dt, batch, n, m,
        tensor_cores.pointers_aligned(a1, w1, a2, w2, gate))
    out = torch.empty((batch, m), device=dev, dtype=dt)
    if batch:
        _build.launch("rvk_matmul_nt2_mask", dev, a1, w1, a2, w2, gate, out,
                      batch, n, m, DTYPE_CODES[dt],
                      tensor_cores.tile(code, dev, batch, m), code)
        matmul_nt2_mask.launches += 1
        matmul_nt2_mask.tensor_core_launches += \
            code == tensor_cores.TENSOR_CORES
        matmul_nt2_mask.sgemm_launches += code == tensor_cores.SGEMM
    return out


matmul_nt2_mask.launches = 0
matmul_nt2_mask.tensor_core_launches = 0
matmul_nt2_mask.sgemm_launches = 0
matmul_nt2_mask.split_launches = 0


def _workspace(dev, split: int, m: int, n: int, outputs: int = 1):
    """The fp32 workspace of ``outputs`` weight gradients ``(m, n)`` cut
    into ``split`` slices of the batch (each slice's dW and column sums,
    output by output), or None for one slice."""
    if split <= 1:
        return None
    return torch.empty((outputs * split, m * n + n), device=dev,
                       dtype=torch.float32)


@spanned("rvk.row07.grad_accum")
def grad_accum(a, b, kernel: str = "auto", passes: int = 1
               ) -> Tuple[Tensor, Tensor]:
    """Weight and bias gradients of ``y = a @ W + bias`` given the
    cotangent ``b``: ``(aᵀ b, colsum(b))`` in fp32, contracting the batch.

    Replaces ``rawaudiovae_kelsey_tpu/ops/pallas_mlp.py`` ``grad_accum``.
    CUDA: one launch (``csrc/bwd.cu``) of one of three hand-written kernels
    chosen by :func:`resolve_grad_accum`: bf16 operands with n and m
    multiples of 8, 16-byte aligned pointers and at least one row take the
    tensor-core weight gradient (``csrc/wgmma.cuh`` ``launch_wgrad``: the
    batch cut into ``tensor_cores.wgrad_plan`` 's slices, added in order
    through a workspace allocated here; the column sums from the staged
    ``b``); fp32 operands with n and m multiples of 4, 16-byte aligned
    pointers and at least one row the fp32 weight gradient of
    ``csrc/sgemm.cuh`` (``launch_wgrad``: IEEE fp32 FFMAs, ``a`` read as
    its transpose where it lies, the batch cut into
    ``tensor_cores.sgemm_wgrad_plan`` 's slices through a workspace, the
    column sums from the staged ``b``); everything else the tiled GEMM on
    the CUDA cores, each of whose blocks loops over the whole batch for its
    tile of dW.  ``kernel`` names one instead, as for :func:`decoder_fwd`.
    Every kernel gives equal bits on a second launch.  ``passes = 3`` (fp32
    operands: the ``high`` tier with the switch forced to "split" or
    "primitive") takes the 3-pass form, both operands split
    (``pallas_mlp.py:439-449``): one call of ``rvk_grad_accum3``, on the
    tensor cores the split pass of a and of b with db as b's column sums of
    the unsplit values, then one 3-pass weight-gradient launch over
    ``tensor_cores.split_wgrad`` 's slices (``csrc/full.cu``
    ``grad_accum_split``), for widths no multiple of 8 and unaligned views
    the first version's 3-pass mode.  One call counts once in ``launches``,
    and in ``tensor_core_launches``, ``sgemm_launches`` or
    ``split_launches`` too when the tensor cores, the fp32 kernel or the
    3-pass tensor cores ran it."""
    tensor_cores.check_name("grad_accum", kernel)
    check_passes(a.dtype, passes)
    if a.device.type == "cpu":
        return grad_accum_ref(a, b, passes)
    dev = cuda_device(a, "grad_accum: a")
    dt = operand_dtype(a, "grad_accum: a")
    batch, n = a.shape
    m = b.shape[1]
    require(a, "a", (batch, n), dev, dt)
    require(b, "b", (batch, m), dev, dt)
    if passes == 3:
        return grad_accum3(kernel, dev, a, (b,))
    code = resolve_grad_accum(kernel, dt, batch, n, m,
                              tensor_cores.pointers_aligned(a, b))
    dw, db = _grads(dev, (n, m), (m,))
    tile_dw, split = tensor_cores.wgrad(code, dev, n, m, batch)
    _build.launch("rvk_grad_accum", dev, a, b, dw, db,
                  _workspace(dev, split, n, m), batch, n, m, DTYPE_CODES[dt],
                  tile_dw, split, code)
    grad_accum.launches += 1
    grad_accum.tensor_core_launches += code == tensor_cores.TENSOR_CORES
    grad_accum.sgemm_launches += code == tensor_cores.SGEMM
    return dw, db


grad_accum.launches = 0
grad_accum.tensor_core_launches = 0
grad_accum.sgemm_launches = 0
grad_accum.split_launches = 0


def grad_accum3(kernel: str, dev, a, bs) -> Tuple[Tensor, ...]:
    """The 3-pass form of :func:`grad_accum` (one cotangent in ``bs``) or
    :func:`grad_accum2` (two) on operands the wrapper has checked → each
    cotangent's ``(dw, db)`` in turn: one call of ``rvk_grad_accum3`` /
    ``rvk_grad_accum2_3`` (``csrc/full.cu`` ``grad_accum_split``: the halves
    of a and of each b, the column sums of each b, one 3-pass launch of
    ``len(bs)`` outputs; the first version's 3-pass mode)."""
    op = "grad_accum" if len(bs) == 1 else "grad_accum2"
    batch, n = a.shape
    m = bs[0].shape[1]
    code = resolve_split(op, kernel, batch, n, m,
                         aligned=tensor_cores.pointers_aligned(a, *bs))
    grads = _grads(dev, *((n, m), (m,)) * len(bs))
    tile_dw, split = tensor_cores.split_wgrad(code, dev, n, m, batch,
                                              len(bs))
    splits = split_scratch(dev, code, (batch, n), *[(batch, m)] * len(bs))
    ws = None if splits is None else split_workspace(
        dev, batch, (m,), ((split, n, m, len(bs)),))
    _build.launch("rvk_grad_accum3" if len(bs) == 1 else "rvk_grad_accum2_3",
                  dev, a, *bs, *grads, splits, ws, batch, n, m, tile_dw,
                  split, code)
    _count3(grad_accum if len(bs) == 1 else grad_accum2, code, False)
    return grads


def resolve_grad_accum(kernel: str, dtype: torch.dtype, batch: int, n: int,
                       m: int, aligned: bool = True) -> int:
    """The kernel code :func:`grad_accum` launches with: the tensor cores
    when ``tensor_cores.takes_tensor_cores`` holds for ``batch`` rows, ``n``
    and ``m`` (the rows of ``a`` and ``b`` are TMA's 16-byte rows; the
    contraction is the batch, of any length), the fp32 kernel when
    ``tensor_cores.takes_sgemm`` does (16-byte rows of fp32), else the
    first version; ``kernel`` names one instead
    (``tensor_cores.resolve``)."""
    return tensor_cores.resolve(
        "grad_accum", kernel,
        tensor_cores.takes_tensor_cores(dtype, batch, n, m, aligned),
        lambda: f"{dtype}, batch {batch}, n {n}, m {m}, aligned = {aligned}",
        tensor_cores.takes_sgemm(dtype, batch, n, m, aligned))


@spanned("rvk.row09.grad_accum2")
def grad_accum2(a, b1, b2, kernel: str = "auto", passes: int = 1
                ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Two :func:`grad_accum` s that share ``a``: ``(aᵀ b1, colsum(b1),
    aᵀ b2, colsum(b2))`` — the encoder's two latent heads, both
    contracting ``h``.

    Replaces ``rawaudiovae_kelsey_tpu/ops/pallas_mlp.py`` ``grad_accum2``.
    CUDA (``csrc/bwd.cu``), one of three hand-written kernels chosen by
    :func:`resolve_grad_accum2`: bf16 operands with n and m multiples of 8,
    16-byte aligned pointers and at least one row take the tensor-core
    weight gradient with both outputs side by side in one launch
    (``csrc/wgmma.cuh`` ``launch_wgrad2``: ``a`` read once for both, the
    batch cut into ``tensor_cores.wgrad_plan`` 's slices for two outputs,
    added in order through a workspace allocated here); fp32 operands with
    n and m multiples of 4, 16-byte aligned pointers and at least one row
    :func:`grad_accum` 's fp32 launch once for each output
    (``csrc/sgemm.cuh`` ``launch_wgrad``, ``tensor_cores.sgemm_wgrad_plan``
    's slices through one workspace); everything else one launch of the
    tiled GEMM on the CUDA cores carrying both products.  ``kernel`` names
    one instead, as for :func:`decoder_fwd`.  Every kernel gives equal bits
    on a second launch.  ``passes = 3`` (fp32 operands) takes the 3-pass
    form, both heads in one 3-pass launch (:func:`grad_accum3`).  One call
    counts once in ``launches``, and in ``tensor_core_launches``,
    ``sgemm_launches`` or ``split_launches`` too when that kernel ran it."""
    tensor_cores.check_name("grad_accum2", kernel)
    check_passes(a.dtype, passes)
    if a.device.type == "cpu":
        return grad_accum2_ref(a, b1, b2, passes)
    dev = cuda_device(a, "grad_accum2: a")
    dt = operand_dtype(a, "grad_accum2: a")
    batch, n = a.shape
    m = b1.shape[1]
    require(a, "a", (batch, n), dev, dt)
    require(b1, "b1", (batch, m), dev, dt)
    require(b2, "b2", (batch, m), dev, dt)
    if passes == 3:
        return grad_accum3(kernel, dev, a, (b1, b2))
    code = resolve_grad_accum2(kernel, dt, batch, n, m,
                               tensor_cores.pointers_aligned(a, b1, b2))
    dw1, db1, dw2, db2 = _grads(dev, (n, m), (m,), (n, m), (m,))
    tile_dw, split = tensor_cores.wgrad(code, dev, n, m, batch, outputs=2)
    # the tensor cores' two outputs slice into one workspace side by side;
    # the fp32 form's two launches take turns with one output's
    outputs = 2 if code == tensor_cores.TENSOR_CORES else 1
    _build.launch("rvk_grad_accum2", dev, a, b1, b2, dw1, db1, dw2, db2,
                  _workspace(dev, split, n, m, outputs), batch, n, m,
                  DTYPE_CODES[dt], tile_dw, split, code)
    grad_accum2.launches += 1
    grad_accum2.tensor_core_launches += code == tensor_cores.TENSOR_CORES
    grad_accum2.sgemm_launches += code == tensor_cores.SGEMM
    return dw1, db1, dw2, db2


grad_accum2.launches = 0
grad_accum2.tensor_core_launches = 0
grad_accum2.sgemm_launches = 0
grad_accum2.split_launches = 0


def resolve_grad_accum2(kernel: str, dtype: torch.dtype, batch: int, n: int,
                        m: int, aligned: bool = True) -> int:
    """The kernel code :func:`grad_accum2` launches with, as for
    :func:`resolve_grad_accum`: the tensor cores when
    ``tensor_cores.takes_tensor_cores`` holds for ``batch`` rows, ``n`` and
    ``m``, the fp32 kernel when ``tensor_cores.takes_sgemm`` does, else the
    first version; ``kernel`` names one instead
    (``tensor_cores.resolve``)."""
    return tensor_cores.resolve(
        "grad_accum2", kernel,
        tensor_cores.takes_tensor_cores(dtype, batch, n, m, aligned),
        lambda: f"{dtype}, batch {batch}, n {n}, m {m}, aligned = {aligned}",
        tensor_cores.takes_sgemm(dtype, batch, n, m, aligned))


@spanned("rvk.row08.enc_bwd_dw1")
def enc_bwd_dw1(x, h, dmu, dlogvar, w21, w22, kernel: str = "auto",
                passes: int = 1) -> Tuple[Tensor, Tensor]:
    """Encoder first-layer gradients: ``dh = (dmu@w21ᵀ +
    dlogvar@w22ᵀ)·(h>0)`` rounded to the operand dtype, then ``(xᵀ dh,
    colsum(dh))`` in fp32.

    Replaces ``rawaudiovae_kelsey_tpu/ops/pallas_mlp.py`` ``enc_bwd_dw1``.
    CUDA: two launches (``csrc/bwd.cu``) of one of three hand-written
    kernels chosen by :func:`resolve_enc_bwd_dw1`: bf16 operands with seg,
    units and latent multiples of 8, 16-byte aligned pointers and at least
    one row take the tensor-core kernel (``csrc/wgmma.cuh``: dh as one
    product joined along k, dmu and w21 then dlogvar and w22, with the gate
    in its epilogue; then dW1 and db1 as :func:`grad_accum` 's weight
    gradient, through a workspace allocated here); fp32 operands with them
    multiples of 4, 16-byte aligned pointers and at least one row the fp32
    launches of :func:`matmul_nt2_mask` and :func:`grad_accum` one after
    the other (``csrc/sgemm.cuh``, at their plans); everything else the
    tiled GEMM on the CUDA cores.  ``kernel`` names one instead, as for
    :func:`decoder_fwd`.  ``dh`` goes through a scratch buffer between the
    two instead of staying in VMEM: at the step's microbatch 32 MB written
    and read back, ~0.02 ms of an H100's memory time.  Every kernel gives
    equal bits on a second launch.  ``passes = 3`` (fp32 operands: the
    ``high`` tier with the switch forced to "split") takes the 3-pass form,
    dh kept fp32: one call of ``rvk_enc_bwd_dw1_3``, on the tensor cores
    ``enc_bwd_full`` 's chain up to dW1 (``csrc/full.cu``
    ``enc_bwd_dw1_split``: the split pass of dmu, dlv, W21, W22, dh and x,
    db1 as dh's column sums of the unsplit values; dh one k-joined gated
    3-pass launch, dW1 one 3-pass weight gradient), for widths no multiple
    of 8 and unaligned views the first version's 3-pass mode.  One call
    counts once in ``launches``, and in ``tensor_core_launches``,
    ``sgemm_launches`` or ``split_launches`` too when that kernel ran it."""
    tensor_cores.check_name("enc_bwd_dw1", kernel)
    check_passes(x.dtype, passes)
    if x.device.type == "cpu":
        return enc_bwd_dw1_ref(x, h, dmu, dlogvar, w21, w22, passes)
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
    if passes == 3:
        return enc_bwd_dw1_3(kernel, dev, x, h, dmu, dlogvar, w21, w22)
    code = resolve_enc_bwd_dw1(
        kernel, dt, batch, seg, units, latent,
        tensor_cores.pointers_aligned(x, h, dmu, dlogvar, w21, w22))
    dh = torch.empty((batch, units), device=dev, dtype=dt)
    dw1, db1 = _grads(dev, (seg, units), (units,))
    tile_dw, split = tensor_cores.wgrad(code, dev, seg, units, batch)
    _build.launch("rvk_enc_bwd_dw1", dev, x, h, dmu, dlogvar, w21, w22, dh,
                  dw1, db1, _workspace(dev, split, seg, units), batch, seg,
                  units, latent, DTYPE_CODES[dt],
                  tensor_cores.tile(code, dev, batch, units), tile_dw, split,
                  code)
    enc_bwd_dw1.launches += 1
    enc_bwd_dw1.tensor_core_launches += code == tensor_cores.TENSOR_CORES
    enc_bwd_dw1.sgemm_launches += code == tensor_cores.SGEMM
    return dw1, db1


enc_bwd_dw1.launches = 0
enc_bwd_dw1.tensor_core_launches = 0
enc_bwd_dw1.sgemm_launches = 0
enc_bwd_dw1.split_launches = 0


def enc_bwd_dw1_3(kernel: str, dev, x, h, dmu, dlogvar, w21, w22
                  ) -> Tuple[Tensor, Tensor]:
    """The 3-pass form of :func:`enc_bwd_dw1` on operands the wrapper has
    checked (its docstring): dh fp32 into a scratch buffer, then
    ``(dw1, db1)``."""
    batch, seg = x.shape
    units, latent = h.shape[1], dmu.shape[1]
    code = resolve_split("enc_bwd_dw1", kernel, batch, seg, units, latent,
                         aligned=tensor_cores.pointers_aligned(
                             x, h, dmu, dlogvar, w21, w22))
    dh = torch.empty((batch, units), device=dev)
    dw1, db1 = _grads(dev, (seg, units), (units,))
    tile_dw, split = tensor_cores.split_wgrad(code, dev, seg, units, batch)
    splits = split_scratch(dev, code, (batch, latent), (batch, latent),
                           (units, latent), (units, latent), (batch, units),
                           (batch, seg))
    ws = None if splits is None else split_workspace(
        dev, batch, (units,), ((split, seg, units, 1),))
    _build.launch("rvk_enc_bwd_dw1_3", dev, x, h, dmu, dlogvar, w21, w22, dh,
                  dw1, db1, splits, ws, batch, seg, units, latent,
                  tensor_cores.split_tile(code, dev, batch, units), tile_dw,
                  split, code)
    _count3(enc_bwd_dw1, code, False)
    return dw1, db1


def resolve_enc_bwd_dw1(kernel: str, dtype: torch.dtype, batch: int,
                        seg: int, units: int, latent: int,
                        aligned: bool = True) -> int:
    """The kernel code :func:`enc_bwd_dw1` launches with: the tensor cores
    when ``tensor_cores.takes_tensor_cores`` holds for dh (contraction
    ``latent``, width ``units``) and for the rows of ``x`` (``seg``, TMA's
    16-byte rows of the weight gradient's A), the fp32 kernel when
    ``tensor_cores.takes_sgemm`` does for both, else the first version;
    ``kernel`` names one instead (``tensor_cores.resolve``)."""
    return tensor_cores.resolve(
        "enc_bwd_dw1", kernel,
        tensor_cores.takes_tensor_cores(dtype, batch, latent, units, aligned)
        and tensor_cores.takes_tensor_cores(dtype, batch, seg, units),
        lambda: f"{dtype}, batch {batch}, seg {seg}, units {units}, latent "
                f"{latent}, aligned = {aligned}",
        tensor_cores.takes_sgemm(dtype, batch, latent, units, aligned)
        and tensor_cores.takes_sgemm(dtype, batch, seg, units))


@spanned("rvk.row10.dec_bwd_fused")
def dec_bwd_fused(da, h3, z, w4, w3, kernel: str = "auto", passes: int = 1
                  ) -> Tuple[Tensor, Tensor, Tensor]:
    """Decoder backward minus the dW4 product: ``dh3 = (da@w4ᵀ)·(h3>0)``
    rounded to the operand dtype feeds ``dz = dh3@w3ᵀ`` (operand dtype)
    and ``(zᵀ dh3, colsum(dh3))`` (fp32).

    Replaces ``rawaudiovae_kelsey_tpu/ops/pallas_mlp.py``
    ``dec_bwd_fused``.  CUDA: three launches (``csrc/bwd.cu``) of one of
    three hand-written kernels chosen by :func:`resolve_dec_bwd`: bf16
    operands with seg, units and latent multiples of 8, 16-byte aligned
    pointers and at least one row take the tensor-core kernel
    (``csrc/wgmma.cuh``: dh3 with the gate in its epilogue, dz, then dW3
    and db3 over the batch cut into ``tensor_cores.wgrad_plan`` 's slices,
    added in order through a workspace allocated here); fp32 operands with
    them multiples of 4, 16-byte aligned pointers and at least one row the
    fp32 launches of :func:`matmul_nt_mask`, :func:`matmul_nt` and
    :func:`grad_accum` one after the other (``csrc/sgemm.cuh``, at their
    plans); everything else the tiled GEMM on the CUDA cores.  ``kernel``
    names one instead, as for :func:`decoder_fwd`.  ``dh3`` goes through a
    scratch buffer instead of staying in VMEM.  Every kernel gives equal
    bits on a second launch.  ``passes = 3`` (fp32 operands: the ``high``
    tier with the switch forced to "split") takes the 3-pass form, dh3 kept
    fp32 and dz fp32: one call of ``rvk_dec_bwd_fused3``, on the tensor
    cores ``dec_bwd_full`` 's chain up to dW3 (``csrc/full.cu``
    ``dec_bwd_fused_split``: the split pass of da, W4, dh3, W3 and z, db3
    as dh3's column sums; dh3, dz and dW3 each one 3-pass launch), for
    widths no multiple of 8 and unaligned views the first version's 3-pass
    mode.  One call counts once in ``launches``, and in
    ``tensor_core_launches``, ``sgemm_launches`` or ``split_launches`` too
    when that kernel ran it."""
    tensor_cores.check_name("dec_bwd_fused", kernel)
    check_passes(da.dtype, passes)
    if da.device.type == "cpu":
        return dec_bwd_fused_ref(da, h3, z, w4, w3, passes)
    dev = cuda_device(da, "dec_bwd_fused: da")
    dt = operand_dtype(da, "dec_bwd_fused: da")
    batch, seg = da.shape
    units, latent = h3.shape[1], z.shape[1]
    require(da, "da", (batch, seg), dev, dt)
    require(h3, "h3", (batch, units), dev, dt)
    require(z, "z", (batch, latent), dev, dt)
    require(w4, "w4", (units, seg), dev, dt)
    require(w3, "w3", (latent, units), dev, dt)
    if passes == 3:
        return dec_bwd_fused3(kernel, dev, da, h3, z, w4, w3)
    code = resolve_dec_bwd(kernel, dt, batch, seg, units, latent,
                           tensor_cores.pointers_aligned(da, h3, z, w4, w3))
    dh3 = torch.empty((batch, units), device=dev, dtype=dt)
    dz = torch.empty((batch, latent), device=dev, dtype=dt)
    dw3, db3 = _grads(dev, (latent, units), (units,))
    tile_dw, split = tensor_cores.wgrad(code, dev, latent, units, batch)
    _build.launch("rvk_dec_bwd_fused", dev, da, h3, z, w4, w3, dh3, dz, dw3,
                  db3, _workspace(dev, split, latent, units), batch, seg,
                  units, latent, DTYPE_CODES[dt],
                  tensor_cores.tile(code, dev, batch, units),
                  tensor_cores.tile(code, dev, batch, latent), tile_dw,
                  split, code)
    dec_bwd_fused.launches += 1
    dec_bwd_fused.tensor_core_launches += code == tensor_cores.TENSOR_CORES
    dec_bwd_fused.sgemm_launches += code == tensor_cores.SGEMM
    return dz, dw3, db3


dec_bwd_fused.launches = 0
dec_bwd_fused.tensor_core_launches = 0
dec_bwd_fused.sgemm_launches = 0
dec_bwd_fused.split_launches = 0


def dec_bwd_fused3(kernel: str, dev, da, h3, z, w4, w3
                   ) -> Tuple[Tensor, Tensor, Tensor]:
    """The 3-pass form of :func:`dec_bwd_fused` on operands the wrapper
    has checked (its docstring) → ``(dz, dw3, db3)``, dz fp32."""
    batch, seg = da.shape
    units, latent = h3.shape[1], z.shape[1]
    code = resolve_split("dec_bwd_fused", kernel, batch, seg, units, latent,
                         aligned=tensor_cores.pointers_aligned(
                             da, h3, z, w4, w3))
    dh3 = torch.empty((batch, units), device=dev)
    dz = torch.empty((batch, latent), device=dev)
    dw3, db3 = _grads(dev, (latent, units), (units,))
    tile_dw, split = tensor_cores.split_wgrad(code, dev, latent, units, batch)
    splits = split_scratch(dev, code, (batch, seg), (units, seg),
                           (batch, units), (latent, units), (batch, latent))
    ws = None if splits is None else split_workspace(
        dev, batch, (units,), ((split, latent, units, 1),))
    _build.launch("rvk_dec_bwd_fused3", dev, da, h3, z, w4, w3, dh3, dz, dw3,
                  db3, splits, ws, batch, seg, units, latent,
                  tensor_cores.split_tile(code, dev, batch, units),
                  tensor_cores.split_tile(code, dev, batch, latent), tile_dw,
                  split, code)
    _count3(dec_bwd_fused, code, False)
    return dz, dw3, db3


def resolve_dec_bwd(kernel: str, dtype: torch.dtype, batch: int, seg: int,
                    units: int, latent: int, aligned: bool = True) -> int:
    """The kernel code :func:`dec_bwd_fused` launches with: the tensor
    cores when its products fit them (``tensor_cores.takes_tensor_cores`` of
    dh3, contraction ``seg`` and width ``units``, and of dz, ``units`` and
    ``latent``; the weight gradient contracts the batch, of any length,
    with the rows of ``z`` and dh3 as 16-byte TMA rows), the fp32 kernel
    when ``tensor_cores.takes_sgemm`` does for both products, else the
    first version; ``kernel`` names one instead
    (``tensor_cores.resolve``)."""
    return tensor_cores.resolve(
        "dec_bwd_fused", kernel,
        tensor_cores.takes_tensor_cores(dtype, batch, seg, units, aligned)
        and tensor_cores.takes_tensor_cores(dtype, batch, units, latent),
        lambda: f"{dtype}, batch {batch}, seg {seg}, units {units}, latent "
                f"{latent}, aligned = {aligned}",
        tensor_cores.takes_sgemm(dtype, batch, seg, units, aligned)
        and tensor_cores.takes_sgemm(dtype, batch, units, latent))


def full_passes(dtype: torch.dtype) -> int:
    """The pass count of a full chain called with none: three for fp32
    operands (the ``high`` tier's chains, the form the JAX package's "auto"
    switch gives them), one for bf16.  The autograd Functions always pass
    the forward's count (one fp32 pass under ``float32`` / ``highest`` with
    "full" forced)."""
    return 3 if dtype == torch.float32 else 1


# rows a block of the split pass sums (csrc/split.cuh kSplitRows): a column
# sum over more rows goes through one partial a block
SPLIT_ROWS = 64


def split_pass(v: Tensor, sums: bool = False
               ) -> Tuple[Tensor, Tensor, Tensor]:
    """The split pass of the 3-pass product on its own: fp32 ``v`` (rows,
    cols) → ``(hi, lo, colsum)``, ``hi`` and ``lo`` bf16 with the bits of
    :func:`split_hi_lo` 's halves, ``colsum`` the fp32 column sums of the
    unsplit ``v`` (``sums``; None otherwise).  The full chains run it on
    every operand inside their launch (``csrc/full.cu``); this entry point
    holds and times it alone.  CUDA: ``csrc/split.cuh`` through
    ``rvk_split_hi_lo``, ``cols`` a multiple of 4, 16-byte aligned; the
    column sums in a fixed order (a partial a block of
    :data:`SPLIT_ROWS` rows, then the partials in order), equal bits on a
    second launch.  It replaces no TPU kernel of its own (the TPU kernels
    split their tiles in VMEM), so it counts no launches."""
    if v.device.type == "cpu":
        hi, lo, colsum = split_pass_ref(v)
        return hi, lo, colsum if sums else None
    dev = cuda_device(v, "split_pass: v")
    rows, cols = v.shape
    require(v, "v", (rows, cols), dev)
    if cols % 4 or not tensor_cores.pointers_aligned(v):
        raise ValueError(f"split_pass: {cols} columns or an unaligned v; "
                         "the kernel takes 16-byte aligned rows")
    hi = torch.empty((rows, cols), device=dev, dtype=torch.bfloat16)
    lo = torch.empty_like(hi)
    colsum = torch.empty((cols,), device=dev) if sums else None
    blocks = -(-rows // SPLIT_ROWS)
    partial = (torch.empty((blocks * cols,), device=dev)
               if sums and blocks > 1 else None)
    _build.launch("rvk_split_hi_lo", dev, v, hi, lo, colsum, partial, rows,
                  cols, int(sums))
    return hi, lo, colsum


def full_scratch(dev, code: int, dtype: torch.dtype, chain: str, batch: int,
                 seg: int, units: int, latent: int, plan: tuple):
    """``(splits, workspace)`` of a full chain (``chain`` "enc" or "dec")
    launched with ``code`` and ``plan`` (``tensor_cores.full_plan``):
    ``splits`` the bf16 halves of every fp32 operand the 3-pass chain on
    the tensor cores splits, in the order ``csrc/full.cu`` takes them;
    ``workspace`` (:func:`split_workspace`) fp32 room for the largest of the
    weight gradients' slices and, in three passes, the split pass's
    column-sum partials, which run one after another on one stream and
    share it (the fp32 kernel's two head gradients one after the other,
    the tensor cores' side by side).  None where nothing is needed (and for
    the first version)."""
    if code not in (tensor_cores.TENSOR_CORES, tensor_cores.SGEMM):
        return None, None
    if chain == "enc":
        heads = 2 if code == tensor_cores.TENSOR_CORES else 1
        slices = ((plan[2], seg, units, 1), (plan[4], units, latent, heads))
        halves = ((batch, latent), (batch, latent), (units, latent),
                  (units, latent), (batch, units), (batch, seg),
                  (batch, units))
        summed = (latent, units)            # dmu and dlogvar; dh
    else:
        slices = ((plan[3], latent, units, 1), (plan[5], units, seg, 1))
        halves = ((batch, seg), (units, seg), (batch, units),
                  (latent, units), (batch, latent), (batch, units))
        summed = (seg, units)               # da; dh3
    if dtype != torch.float32 or code == tensor_cores.SGEMM:
        return None, split_workspace(dev, batch, (), slices)
    return (split_scratch(dev, code, *halves),
            split_workspace(dev, batch, summed, slices))


def resolve_full(op: str, kernel: str, dtype: torch.dtype, batch: int,
                 seg: int, units: int, latent: int, aligned: bool = True,
                 passes: int | None = None) -> int:
    """The kernel code a full chain (``op``: ``enc_bwd_full`` or
    ``dec_bwd_full``) launches with in ``passes`` passes (None:
    :func:`full_passes`): the tensor cores when
    ``tensor_cores.takes_full_chain`` holds for bf16 operands (the split
    backward's tensor-core launches) or fp32 ones in three passes (the
    3-pass chain of ``csrc/full.cu``); the fp32 kernel for fp32 operands in
    one pass when ``tensor_cores.takes_sgemm`` holds for every product
    (``csrc/sgemm.cuh``, the split kernels' fp32 launches in turn); else
    the first version.  ``kernel`` names one instead
    (``tensor_cores.resolve``)."""
    passes = full_passes(dtype) if passes is None else passes
    ieee = dtype == torch.float32 and passes == 1
    return tensor_cores.resolve(
        op, kernel,
        not ieee and tensor_cores.takes_full_chain(
            dtype, batch, seg, units, latent, aligned=aligned),
        lambda: f"{dtype}, {passes} passes, batch {batch}, seg {seg}, units "
                f"{units}, latent {latent}, aligned = {aligned}",
        ieee and tensor_cores.takes_sgemm(dtype, batch, seg, units, aligned)
        and tensor_cores.takes_sgemm(dtype, batch, units, latent),
        takes="fp32 or bf16 operands (fp32 in three passes) with seg, units "
              f"and latent multiples of {tensor_cores.TMA_ALIGN_BF16}, at "
              "least one row and 16-byte aligned pointers",
        takes_sgemm="fp32 operands in one pass with seg, units and latent "
                    f"multiples of {tensor_cores.SGEMM_ALIGN_F32}, at least "
                    "one row and 16-byte aligned pointers")


@spanned("rvk.row11.enc_bwd_full")
def enc_bwd_full(x, h, dmu, dlogvar, w21, w22, kernel: str = "auto",
                 passes: int | None = None) -> Tuple[Tensor, ...]:
    """The encoder's whole parameter backward from one call → ``(dw1, db1,
    dw21, db21, dw22, db22)`` in fp32: ``dh = (dmu@w21ᵀ +
    dlogvar@w22ᵀ)·(h>0)`` feeds ``(xᵀ dh, colsum(dh))`` and one read of
    ``h`` feeds both head gradients.  ``passes`` (None:
    :func:`full_passes`): 3, fp32 operands (the ``high`` tier), every
    product the bf16 hi/lo 3-pass product with ``dh`` kept in fp32; 1, dh
    rounded to the operand dtype (a no-op for fp32: the ``float32`` /
    ``highest`` tiers with "full" forced, ``pallas_mlp.py:776-785``).

    Replaces ``rawaudiovae_kelsey_tpu/ops/pallas_mlp.py`` ``enc_bwd_full``.
    CUDA: one call of ``rvk_enc_bwd_full`` (``csrc/bwd.cu``), a chain of
    launches of one of two hand-written forms chosen by
    :func:`resolve_full`: with seg, units and latent multiples of 8,
    16-byte aligned pointers and at least one row, the tensor cores — fp32
    operands the 3-pass chain (``csrc/full.cu``: the split pass makes each
    operand's bf16 halves once, with db21, db22 and db1 as fp32 column
    sums of the unsplit values; dh as one k-joined 3-pass product gated in
    fp32, dW1 and dW21 | dW22 on the 3-pass weight gradient, three fp32
    accumulators added ``(hh + hl) + lh``), bf16 operands the split
    backward's launches (:func:`enc_bwd_dw1` 's, then :func:`grad_accum2`
    's), each product's tile and slices from ``tensor_cores.full_plan``
    and the halves and slices in scratch allocated here
    (:func:`full_scratch`); fp32 operands in one pass with the widths
    multiples of 4 and 16-byte aligned pointers the fp32 kernel
    (``csrc/sgemm.cuh``: :func:`enc_bwd_dw1` 's fp32 launches, then
    :func:`grad_accum2` 's, each at its plan from ``tensor_cores.full_plan``;
    the IEEE one-pass chain of rows 6 and 7); everything else the first
    version, three launches of the tiled GEMM on the CUDA cores in
    ``passes`` passes.  ``kernel`` names one instead; naming a kernel for
    operands it cannot take raises.  ``dh`` goes through a scratch buffer
    instead of staying in VMEM.  Every form gives equal bits on a second
    launch.  One call counts once in ``launches``, and in
    ``tensor_core_launches`` or ``sgemm_launches`` too when the tensor cores
    or the fp32 kernel ran it."""
    tensor_cores.check_name("enc_bwd_full", kernel)
    passes = full_passes(x.dtype) if passes is None else passes
    check_passes(x.dtype, passes)
    if x.device.type == "cpu":
        return enc_bwd_full_ref(x, h, dmu, dlogvar, w21, w22, passes)
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
    code = resolve_full(
        "enc_bwd_full", kernel, dt, batch, seg, units, latent,
        tensor_cores.pointers_aligned(x, h, dmu, dlogvar, w21, w22), passes)
    dh = torch.empty((batch, units), device=dev, dtype=dt)
    grads = _grads(dev, (seg, units), (units,), (units, latent), (latent,),
                   (units, latent), (latent,))
    plan = tensor_cores.full_plan(code, dt, dev, "enc", batch, seg, units,
                                  latent)
    splits, workspace = full_scratch(dev, code, dt, "enc", batch, seg, units,
                                     latent, plan)
    _build.launch("rvk_enc_bwd_full", dev, x, h, dmu, dlogvar, w21, w22, dh,
                  *grads, splits, workspace, batch, seg, units, latent,
                  DTYPE_CODES[dt], passes, *plan, code)
    enc_bwd_full.launches += 1
    enc_bwd_full.tensor_core_launches += code == tensor_cores.TENSOR_CORES
    enc_bwd_full.sgemm_launches += code == tensor_cores.SGEMM
    return grads


enc_bwd_full.launches = 0
enc_bwd_full.tensor_core_launches = 0
enc_bwd_full.sgemm_launches = 0


@spanned("rvk.row12.dec_bwd_full")
def dec_bwd_full(da, h3, z, w4, w3, kernel: str = "auto",
                 passes: int | None = None) -> Tuple[Tensor, ...]:
    """The decoder's whole backward from one call → ``(dz, dw3, db3, dw4,
    db4)``: ``dh3 = (da@w4ᵀ)·(h3>0)`` feeds ``dz = dh3@w3ᵀ`` (operand
    dtype) and ``(zᵀ dh3, colsum(dh3))``; ``(h3ᵀ da, colsum(da))`` comes
    with them (all fp32).  Three passes or one as in :func:`enc_bwd_full`.

    Replaces ``rawaudiovae_kelsey_tpu/ops/pallas_mlp.py`` ``dec_bwd_full``.
    CUDA: one call of ``rvk_dec_bwd_full`` (``csrc/bwd.cu``), the forms of
    :func:`enc_bwd_full` chosen the same way: fp32 operands on the tensor
    cores the 3-pass chain (``csrc/full.cu``: da's and dh3's halves with
    db4 and db3 as fp32 column sums; dh3 gated in fp32, dz, dW3 and dW4 as
    3-pass products), bf16 ones the split backward's launches
    (:func:`dec_bwd_fused` 's, then :func:`grad_accum` 's for dW4 and db4);
    fp32 ones in one pass on the fp32 kernel (:func:`dec_bwd_fused` 's fp32
    launches, then :func:`grad_accum` 's: rows 5, 4, 7, 7); everything else
    four launches of the tiled GEMM.  ``dh3`` goes through a scratch buffer
    instead of staying in VMEM.  Counted as :func:`enc_bwd_full` is."""
    tensor_cores.check_name("dec_bwd_full", kernel)
    passes = full_passes(da.dtype) if passes is None else passes
    check_passes(da.dtype, passes)
    if da.device.type == "cpu":
        return dec_bwd_full_ref(da, h3, z, w4, w3, passes)
    dev = cuda_device(da, "dec_bwd_full: da")
    dt = operand_dtype(da, "dec_bwd_full: da")
    batch, seg = da.shape
    units, latent = h3.shape[1], z.shape[1]
    require(da, "da", (batch, seg), dev, dt)
    require(h3, "h3", (batch, units), dev, dt)
    require(z, "z", (batch, latent), dev, dt)
    require(w4, "w4", (units, seg), dev, dt)
    require(w3, "w3", (latent, units), dev, dt)
    code = resolve_full("dec_bwd_full", kernel, dt, batch, seg, units,
                        latent,
                        tensor_cores.pointers_aligned(da, h3, z, w4, w3),
                        passes)
    dh3 = torch.empty((batch, units), device=dev, dtype=dt)
    dz = torch.empty((batch, latent), device=dev, dtype=dt)
    grads = _grads(dev, (latent, units), (units,), (units, seg), (seg,))
    plan = tensor_cores.full_plan(code, dt, dev, "dec", batch, seg, units,
                                  latent)
    splits, workspace = full_scratch(dev, code, dt, "dec", batch, seg, units,
                                     latent, plan)
    _build.launch("rvk_dec_bwd_full", dev, da, h3, z, w4, w3, dh3, dz,
                  *grads, splits, workspace, batch, seg, units, latent,
                  DTYPE_CODES[dt], passes, *plan, code)
    dec_bwd_full.launches += 1
    dec_bwd_full.tensor_core_launches += code == tensor_cores.TENSOR_CORES
    dec_bwd_full.sgemm_launches += code == tensor_cores.SGEMM
    return (dz, *grads)


dec_bwd_full.launches = 0
dec_bwd_full.tensor_core_launches = 0
dec_bwd_full.sgemm_launches = 0


# ------------------------------------------------------ autograd Functions

# the backward modes of Encode / Decode (the JAX package's ``_fusion``)
BACKWARD_MODES = ("primitive", "split", "full")

# The backward-fusion switch, the JAX package's ``pallas_mlp.py:993``
# ``BWD_FUSION``: "auto" (the rule of :func:`fusion`) or one of
# BACKWARD_MODES, forced for every dtype and tier.  JAX reads it when it
# traces a step; here it is read when a step's model is built
# (``models/registry.py`` ``backward_fusion``: ``build_model`` and
# ``parallel/tensor_parallel.py`` ``tensor_parallel_model``), so a step
# keeps the mode it was built with, as a traced JAX step keeps its trace;
# :func:`encode` / :func:`decode` called with no mode read it at the call.
# JAX's "auto" rule is its TPU measurement (``pallas_mlp.py:984-992``),
# kept as it is.
BWD_FUSION = "auto"


def fusion(dtype: torch.dtype, passes: int = 1) -> str:
    """The backward mode for operands of ``dtype`` whose products take
    ``passes`` passes (:func:`check_passes`), as ``pallas_mlp.py:996``
    ``_fusion`` picks it: a forced :data:`BWD_FUSION` as it is; under
    "auto", "full" at three passes (the ``high`` tier), "primitive" for
    fp32 operands in one pass (``float32`` / ``highest``), "split"
    otherwise (bf16)."""
    check_passes(dtype, passes)
    if BWD_FUSION != "auto":
        return check_mode(BWD_FUSION)
    if passes == 3:
        return "full"
    return "primitive" if dtype == torch.float32 else "split"


def check_mode(mode: str) -> str:
    """``mode`` if it is one of :data:`BACKWARD_MODES`; raises otherwise."""
    if mode not in BACKWARD_MODES:
        raise ValueError(f"unknown backward mode {mode!r}; expected one of "
                         f"{BACKWARD_MODES} (or 'auto' for BWD_FUSION)")
    return mode


def encode_input_grad(h, dmu, dlogvar, w1, w21, w22, passes: int = 1
                      ) -> Tensor:
    """The encoder's input gradient ``dx = dh @ w1ᵀ`` with ``dh`` from
    :func:`matmul_nt2_mask` (``pallas_mlp.py:1038-1041``), both in
    ``passes`` passes.  Training never asks for it (the JAX package leaves
    it to dead-code elimination)."""
    return matmul_nt(
        matmul_nt2_mask(dmu, w21, dlogvar, w22, h, passes=passes), w1,
        passes=passes)


def encode_grads(mode: str, passes: int, x, h, dmu, dlogvar, w1, w21, w22,
                 need_dx: bool) -> Tuple[Tensor, ...]:
    """The backward of :class:`Encode` in ``mode`` with every product in
    ``passes`` passes (the forward's; ``pallas_mlp.py:1012-1041`` under the
    ambient tier) → ``(dx, dw1, db1, dw21, db21, dw22, db22)``, the
    gradients in fp32 (``dx`` in the operand dtype, None unless
    ``need_dx``): "split", :func:`enc_bwd_dw1` and :func:`grad_accum2`;
    "primitive", :func:`matmul_nt2_mask` then three :func:`grad_accum`;
    "full", :func:`enc_bwd_full`.  The tensor-parallel encoder
    (``parallel/tensor_parallel.py``) calls it on a rank's shards."""
    dx = None
    if mode == "primitive":
        dh = matmul_nt2_mask(dmu, w21, dlogvar, w22, h, passes=passes)
        dw1, db1 = grad_accum(x, dh, passes=passes)
        dw21, db21 = grad_accum(h, dmu, passes=passes)
        dw22, db22 = grad_accum(h, dlogvar, passes=passes)
        if need_dx:
            dx = matmul_nt(dh, w1, passes=passes)   # dh is live: reuse it
    else:
        if mode == "full":
            dw1, db1, dw21, db21, dw22, db22 = enc_bwd_full(
                x, h, dmu, dlogvar, w21, w22, passes=passes)
        else:
            dw1, db1 = enc_bwd_dw1(x, h, dmu, dlogvar, w21, w22,
                                   passes=passes)
            dw21, db21, dw22, db22 = grad_accum2(h, dmu, dlogvar,
                                                 passes=passes)
        if need_dx:
            dx = encode_input_grad(h, dmu, dlogvar, w1, w21, w22, passes)
    return dx, dw1, db1, dw21, db21, dw22, db22


def tanh_cotangent(dy: Tensor, y: Tensor) -> Tensor:
    """``dy · (1 - y²)``, the cotangent before the decoder's tanh: an
    elementwise pass left to PyTorch, as the JAX package leaves it to XLA;
    fp32 inside, one rounding."""
    return (_f(dy) * (1.0 - _f(y) * _f(y))).to(dy.dtype)


def decode_grads(mode: str, passes: int, da, h3, z, w3, w4
                 ) -> Tuple[Tensor, ...]:
    """The backward of :class:`Decode` in ``mode`` with every product in
    ``passes`` passes, from the cotangent ``da`` before the tanh → ``(dz,
    dw3, db3, dw4, db4)``: "split", :func:`dec_bwd_fused` and
    :func:`grad_accum`; "primitive", :func:`matmul_nt_mask`,
    :func:`matmul_nt` and two :func:`grad_accum`; "full",
    :func:`dec_bwd_full` (``pallas_mlp.py:1074-1091``)."""
    if mode == "full":
        return dec_bwd_full(da, h3, z, w4, w3, passes=passes)
    if mode == "primitive":
        dh3 = matmul_nt_mask(da, w4, h3, passes=passes)
        dz = matmul_nt(dh3, w3, passes=passes)
        dw3, db3 = grad_accum(z, dh3, passes=passes)
        dw4, db4 = grad_accum(h3, da, passes=passes)
        return dz, dw3, db3, dw4, db4
    dz, dw3, db3 = dec_bwd_fused(da, h3, z, w4, w3, passes=passes)
    dw4, db4 = grad_accum(h3, da, passes=passes)
    return dz, dw3, db3, dw4, db4


def encoder_bwd(w1, w21, w22, x, h, dmu, dlogvar, passes: int = 1
                ) -> Tuple[Tensor, ...]:
    """Backward of :func:`encoder_fwd` → ``(dx, dw1, db1, dw21, db21, dw22,
    db22)`` from the primitive kernels alone, every product in ``passes``
    passes: the counterpart of ``pallas_mlp.py:938`` ``encoder_bwd``
    (:func:`matmul_nt2_mask`, :func:`matmul_nt`, three
    :func:`grad_accum`)."""
    dh = matmul_nt2_mask(dmu, w21, dlogvar, w22, h, passes=passes)
    dx = matmul_nt(dh, w1, passes=passes)
    dw1, db1 = grad_accum(x, dh, passes=passes)
    dw21, db21 = grad_accum(h, dmu, passes=passes)
    dw22, db22 = grad_accum(h, dlogvar, passes=passes)
    return dx, dw1, db1, dw21, db21, dw22, db22


def decoder_bwd(w3, w4, z, h3, y, dy, passes: int = 1
                ) -> Tuple[Tensor, ...]:
    """Backward of :func:`decoder_fwd` → ``(dz, dw3, db3, dw4, db4)`` from
    the primitive kernels alone, every product in ``passes`` passes: the
    counterpart of ``pallas_mlp.py:950`` ``decoder_bwd`` (the tanh
    cotangent, :func:`matmul_nt_mask`, :func:`matmul_nt`, two
    :func:`grad_accum`).  The cotangent ``da = dy·(1 - y²)`` is
    :func:`tanh_cotangent` 's: fp32 inside, one rounding to dy's dtype
    (the same values in fp32; JAX's bf16 elementwise pass may round
    between its ops)."""
    da = tanh_cotangent(dy, y)
    dh3 = matmul_nt_mask(da, w4, h3, passes=passes)
    dz = matmul_nt(dh3, w3, passes=passes)
    dw4, db4 = grad_accum(h3, da, passes=passes)
    dw3, db3 = grad_accum(z, dh3, passes=passes)
    return dz, dw3, db3, dw4, db4


class Encode(torch.autograd.Function):
    """``(mode, passes, x, w1, b1, w21, b21, w22, b22) → (mu, logvar)``
    through :func:`encoder_fwd` in ``passes`` passes; backward
    :func:`encode_grads` in ``mode`` and the same passes.  Saves ``(x,
    h)`` as residuals."""

    @staticmethod
    def forward(ctx, mode, passes, x, w1, b1, w21, b21, w22, b22):
        mu, logvar, h = encoder_fwd(w1, b1, w21, b21, w22, b22, x,
                                    passes=passes)
        ctx.save_for_backward(x, h, w1, w21, w22)
        ctx.mode, ctx.passes = mode, passes
        return mu, logvar

    @staticmethod
    def backward(ctx, dmu, dlogvar):
        x, h, w1, w21, w22 = ctx.saved_tensors
        dx, *grads = encode_grads(ctx.mode, ctx.passes, x, h,
                                  dmu.contiguous(), dlogvar.contiguous(),
                                  w1, w21, w22, ctx.needs_input_grad[2])
        dt = w1.dtype
        return (None, None, dx, *(g.to(dt) for g in grads))


class Decode(torch.autograd.Function):
    """``(mode, passes, z, w3, b3, w4, b4) → y`` through
    :func:`decoder_fwd` in ``passes`` passes; backward
    :func:`decode_grads` in ``mode`` and the same passes.  Saves ``(z, h3,
    y)`` as residuals."""

    @staticmethod
    def forward(ctx, mode, passes, z, w3, b3, w4, b4):
        y, h3 = decoder_fwd(w3, b3, w4, b4, z, passes=passes)
        ctx.save_for_backward(z, h3, y, w3, w4)
        ctx.mode, ctx.passes = mode, passes
        return y

    @staticmethod
    def backward(ctx, dy):
        z, h3, y, w3, w4 = ctx.saved_tensors
        dz, *grads = decode_grads(ctx.mode, ctx.passes,
                                  tanh_cotangent(dy, y), h3, z, w3, w4)
        dt = w3.dtype
        return (None, None, dz, *(g.to(dt) for g in grads))


Params = Dict[str, Dict[str, Tensor]]

# the pass count a train or eval step under ``high`` binds to :func:`encode`
# and :func:`decode` (``models/registry.py`` ``under_tier``)
HIGH_PASSES = 3


def encode(params: Params, x: Tensor, mode: str | None = None,
           passes: int = 1) -> Tuple[Tensor, Tensor]:
    """``models.vae.encode`` through the kernels (the role of the JAX
    package's ``pallas_encode``).  ``mode`` the backward mode
    (:data:`BACKWARD_MODES`; a step's model binds it when it is built,
    ``models/registry.py`` ``backward_fusion``), None: :func:`fusion` of
    x's dtype and ``passes``, read at this call; ``passes`` the pass count
    of every product, forward and backward (3: the ``high`` tier inside a
    step, ``models/registry.py`` ``under_tier``)."""
    return Encode.apply(
        fusion(x.dtype, passes) if mode is None else check_mode(mode),
        passes, x,
        params["fc1"]["w"], params["fc1"]["b"],
        params["fc21"]["w"], params["fc21"]["b"],
        params["fc22"]["w"], params["fc22"]["b"],
    )


def decode(params: Params, z: Tensor, mode: str | None = None,
           passes: int = 1) -> Tensor:
    """``models.vae.decode`` through the kernels (the role of the JAX
    package's ``pallas_decode``).  ``mode`` and ``passes`` as in
    :func:`encode`."""
    return Decode.apply(
        fusion(z.dtype, passes) if mode is None else check_mode(mode),
        passes, z,
        params["fc3"]["w"], params["fc3"]["b"],
        params["fc4"]["w"], params["fc4"]["b"],
    )


encode.high_passes = decode.high_passes = HIGH_PASSES
