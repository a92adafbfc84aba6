"""One Adam step of a parameter leaf in one pass: the CUDA counterpart of
``_leaf_update`` of the JAX repository's ``benchmarks/adam_fusion_ab.py``.

``train/optim.py`` writes Adam as a dozen tensor operations a leaf, each a
launch of its own with its result in device memory.  :func:`leaf_update`
does the whole update of one leaf in a single hand-written kernel
(``csrc/adam.cu``): ``p``, ``g``, ``m`` and ``v`` are read once and ``p``,
``m`` and ``v`` written back in place, 28 bytes an element.  The two bias
corrections are 0-d fp32 tensors on the device, never host scalars copied
inside the step.

The contract is bit-exactness: :func:`leaf_update` and
:func:`fused_adam_apply` give, bit for bit, what
``train/optim.py`` ``Adam.update`` gives (params and both moments, over any
number of coupled steps).  The kernel keeps every product, sum, quotient
and root a separately rounded fp32 operation, in that update's order, and
takes the hyperparameters as the fp32 values eager PyTorch multiplies by:
a Python scalar meets an fp32 tensor as the scalar rounded to fp32, so
``1 − b1`` is formed in double and rounded once (:func:`hyper`).

As everywhere in ``ops/``: the plain version :func:`leaf_update_ref` stands
beside the kernel; the wrapper runs it for CPU tensors only, and for CUDA
tensors checks device, dtype, shape and contiguity, launches the kernel and
counts the launch in ``leaf_update.launches``, or raises.
:func:`fused_adam_apply` is the whole-tree update (the probe's
``fused_adam_apply``) and :class:`FusedAdam` an optimizer with ``Adam``'s
interface built on it; neither is wired into the trainers:
``probes/adam_fusion.py`` measures one against the other.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Any, Tuple

import torch

from rawaudiovae_kelsey_tpu_torch.ops import _build
from rawaudiovae_kelsey_tpu_torch.tree import leaves

Tensor = torch.Tensor


def _f32(v: float) -> float:
    """``v`` rounded to fp32 (to nearest), as a Python float."""
    return ctypes.c_float(v).value


def hyper(b1: float, b2: float, eps: float, lr: float
          ) -> Tuple[float, float, float, float, float, float]:
    """``(1 − b1, b1, 1 − b2, b2, eps, −lr)`` as the fp32 values the plain
    update multiplies and adds: each expression evaluated in double, as
    Python does, then rounded once."""
    return (_f32(1 - b1), _f32(b1), _f32(1 - b2), _f32(b2), _f32(eps),
            _f32(-lr))


def bias_corrections(b1: float, b2: float, count: int
                     ) -> Tuple[float, float]:
    """``(1 − b1^count, 1 − b2^count)`` in fp32 arithmetic, as
    ``train/optim.py`` computes them (optax's order)."""
    f32 = torch.float32
    return (float(1.0 - torch.tensor(b1, dtype=f32) ** count),
            float(1.0 - torch.tensor(b2, dtype=f32) ** count))


# ------------------------------------------------------------ plain version

@torch.no_grad()
def leaf_update_ref(p, g, m, v, bc1, bc2, *, b1: float, b2: float,
                    eps: float, lr: float) -> None:
    """Plain version of :func:`leaf_update`: the lines of
    ``train/optim.py`` ``Adam.update`` for one leaf, in place."""
    m.copy_((1 - b1) * g + b1 * m)
    v.copy_((1 - b2) * (g * g) + b2 * v)
    u = (m / bc1) / (torch.sqrt(v / bc2) + eps)
    p.add_(-lr * u)


# ------------------------------------------------------------------ wrapper

def _leaf(t: Any, name: str, device: torch.device, shape) -> None:
    if not isinstance(t, Tensor):
        raise TypeError(f"leaf_update: {name}: expected a tensor, got "
                        f"{type(t).__name__}")
    if t.device != device:
        raise ValueError(f"leaf_update: {name}: on {t.device}, expected "
                         f"{device}")
    if t.dtype != torch.float32:
        raise TypeError(f"leaf_update: {name}: dtype {t.dtype}, the kernel "
                        "takes torch.float32")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"leaf_update: {name}: shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"leaf_update: {name}: must be contiguous")


@torch.no_grad()
def leaf_update(p, g, m, v, bc1, bc2, *, b1: float, b2: float, eps: float,
                lr: float) -> None:
    """One Adam step of the leaf ``p`` from its gradient ``g`` and moments
    ``m``, ``v`` — fp32 tensors of one shape, any rank — with ``p``, ``m``
    and ``v`` updated in place.  ``bc1``, ``bc2``: the bias corrections as
    0-d fp32 tensors on the leaf's device.

    Replaces ``benchmarks/adam_fusion_ab.py`` ``_leaf_update``.  CUDA: one
    launch (``csrc/adam.cu``) over the leaf as a flat run of fp32."""
    if isinstance(p, Tensor) and p.device.type == "cpu":
        return leaf_update_ref(p, g, m, v, bc1, bc2, b1=b1, b2=b2, eps=eps,
                               lr=lr)
    if not isinstance(p, Tensor) or p.device.type != "cuda":
        where = p.device if isinstance(p, Tensor) else type(p).__name__
        raise ValueError(f"leaf_update: p: the kernel runs on CUDA tensors, "
                         f"got {where}")
    for name, t in (("p", p), ("g", g), ("m", m), ("v", v)):
        _leaf(t, name, p.device, p.shape)
    for name, t in (("bc1", bc1), ("bc2", bc2)):
        _leaf(t, name, p.device, ())
    if p.numel():
        _build.launch("rvk_leaf_update", p.device, p, g, m, v, bc1, bc2,
                      p.numel(), *hyper(b1, b2, eps, lr))
        leaf_update.launches += 1


leaf_update.launches = 0


# ------------------------------------------------------- the whole-tree step

@torch.no_grad()
def fused_adam_apply(adam, state, grads) -> None:
    """One Adam update of ``state`` (params, moments, count) from fp32
    ``grads``, in place: the count, the two bias corrections, then one
    :func:`leaf_update` a leaf.  ``adam`` carries ``learning_rate``, ``b1``,
    ``b2`` and ``eps`` (``train/optim.py`` ``Adam``); the result equals its
    ``update`` bit for bit."""
    state.count += 1
    bc1, bc2 = bias_corrections(adam.b1, adam.b2, state.count)
    on_device = {}   # device → the two corrections as 0-d fp32 tensors
    for p, g, m, v in zip(leaves(state.params), leaves(grads),
                          leaves(state.mu), leaves(state.nu)):
        if p.device not in on_device:
            on_device[p.device] = tuple(
                torch.full((), c, dtype=torch.float32, device=p.device)
                for c in (bc1, bc2))
        # a gradient may come out of autograd strided (a convolution's);
        # the state's own tensors never do
        leaf_update(p, g.contiguous(), m, v, *on_device[p.device],
                    b1=adam.b1, b2=adam.b2, eps=adam.eps,
                    lr=adam.learning_rate)


@dataclass(frozen=True)
class FusedAdam:
    """``adam`` with its ``update`` through :func:`fused_adam_apply`: what
    ``parallel/step.py`` ``build_train_step`` takes as ``optimizer``."""

    adam: Any

    def update(self, state, grads) -> None:
        fused_adam_apply(self.adam, state, grads)
