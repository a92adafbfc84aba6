"""Adam in one pass over the parameters: the CUDA counterpart of
``_leaf_update`` of the JAX repository's ``benchmarks/adam_fusion_ab.py``.

``train/optim.py`` writes Adam as a dozen tensor operations a leaf, each a
launch of its own with its result in device memory.  The kernel of
``csrc/adam.cu`` reads ``p``, ``g``, ``m`` and ``v`` once and writes ``p``,
``m`` and ``v`` back in place, 28 bytes an element.  :func:`adam_tree`
updates a whole parameter tree in ONE launch (up to :data:`K_MAX_LEAVES`
leaves; more take one launch each further :data:`K_MAX_LEAVES`), from the
table of leaves that :func:`tree_plan` lays out: tiles of :data:`TILE`
elements over all leaves, so the small leaves share the grid with the large
ones.  :func:`fused_adam_apply` is the whole-tree step on it: one ctypes
call a step, the two bias corrections passed by value (no fill, no copy to
the device).  :func:`leaf_update` is the same launch with a table of one
leaf, its corrections 0-d fp32 tensors on the device; ``kernel="first"``
names the first version instead (``rvk_leaf_update``, one launch a
leaf), and ``fused_adam_apply(..., kernel="first")`` the whole-tree step on
it, a launch a leaf and two filled scalars a step, kept so that the two can
be timed in turns.

The contract is bit-exactness: :func:`adam_tree`, :func:`leaf_update` and
:func:`fused_adam_apply` give, bit for bit, what ``train/optim.py``
``Adam.update`` gives (params and both moments, over any number of coupled
steps).  The kernel keeps every product, sum, quotient and root a
separately rounded fp32 operation, in that update's order, and takes the
hyperparameters as the fp32 values eager PyTorch multiplies by: a Python
scalar meets an fp32 tensor as the scalar rounded to fp32, so ``1 − b1`` is
formed in double and rounded once (:func:`hyper`).

As everywhere in ``ops/``: the plain version :func:`leaf_update_ref` stands
beside the kernel; the wrappers run it for CPU tensors only, and for CUDA
tensors check device, dtype, shape and contiguity, launch the kernel and
count the launch (``adam_tree.launches``, ``leaf_update.launches``), or
raise.  Every leaf is checked every call; a strided gradient is copied
contiguous first.
:class:`FusedAdam` is an optimizer with ``Adam``'s interface on
:func:`fused_adam_apply`; no trainer takes it: ``probes/adam_fusion.py``
measures one against the other.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Any, Sequence, Tuple

import torch

from rawaudiovae_kelsey_tpu_torch.observe.spans import spanned
from rawaudiovae_kelsey_tpu_torch.ops import _build
from rawaudiovae_kelsey_tpu_torch.tree import leaves

Tensor = torch.Tensor

# csrc/adam.cu's kMaxLeaves and kTile: the leaves one launch of the tree
# kernel takes, and the elements of its work unit
K_MAX_LEAVES = 48
TILE = 4096


def _f32(v: float) -> float:
    """``v`` rounded to fp32 (to nearest), as a Python float."""
    return ctypes.c_float(v).value


@functools.lru_cache(maxsize=16)
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
    return (float(1.0 - _f32_scalar(b1) ** count),
            float(1.0 - _f32_scalar(b2) ** count))


@functools.lru_cache(maxsize=16)
def _f32_scalar(b: float) -> Tensor:
    return torch.tensor(b, dtype=torch.float32)


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


# ------------------------------------------------------------ the plan

@dataclass(frozen=True)
class TreeLaunch:
    """One launch of the tree kernel: the tree's leaves it updates (their
    indices), their first tiles with the launch's tile count last, and
    whether each takes the 16-byte path."""

    leaves: Tuple[int, ...]
    start: Tuple[int, ...]
    vec: Tuple[bool, ...]


@functools.lru_cache(maxsize=64)
def tree_plan(sizes: Tuple[int, ...], aligned: Tuple[bool, ...],
              max_leaves: int = K_MAX_LEAVES, tile: int = TILE
              ) -> Tuple[TreeLaunch, ...]:
    """The launches of the tree kernel for leaves of ``sizes`` elements,
    ``aligned`` where all four of a leaf's pointers are 16-byte aligned:
    the non-empty leaves in order, ``max_leaves`` a launch, each leaf
    ``ceil(size / tile)`` tiles; an empty leaf takes no tile and no place
    in a table, and a tree with no element no launch."""
    kept = [i for i, n in enumerate(sizes) if n > 0]
    launches = []
    for at in range(0, len(kept), max_leaves):
        group = tuple(kept[at:at + max_leaves])
        start = [0]
        for i in group:
            start.append(start[-1] + -(-sizes[i] // tile))
        launches.append(TreeLaunch(group, tuple(start),
                                   tuple(bool(aligned[i]) for i in group)))
    return tuple(launches)


@functools.lru_cache(maxsize=64)
def _plan_arrays(sizes: Tuple[int, ...], aligned: Tuple[bool, ...]):
    """:func:`tree_plan` as the ctypes arrays of each launch: (leaves,
    lengths, first tiles, 16-byte flags)."""
    out = []
    for launch in tree_plan(sizes, aligned):
        k = len(launch.leaves)
        out.append((launch.leaves,
                    (ctypes.c_longlong * k)(*(sizes[i]
                                              for i in launch.leaves)),
                    (ctypes.c_int * (k + 1))(*launch.start),
                    (ctypes.c_int * k)(*launch.vec)))
    return out


# ------------------------------------------------------------------ wrapper

def _leaf(t: Any, name: str, device: torch.device, shape,
          op: str = "leaf_update") -> None:
    if not isinstance(t, Tensor):
        raise TypeError(f"{op}: {name}: expected a tensor, got "
                        f"{type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{op}: {name}: on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{op}: {name}: dtype {t.dtype}, the kernel takes "
                        "torch.float32")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{op}: {name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{op}: {name}: must be contiguous")


def _on_cuda(p: Any, op: str) -> None:
    if not isinstance(p, Tensor) or p.device.type != "cuda":
        where = p.device if isinstance(p, Tensor) else type(p).__name__
        raise ValueError(f"{op}: p: the kernel runs on CUDA tensors, got "
                         f"{where}")


def _aligned(*tensors: Tensor) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def _check_kernel(op: str, kernel: str) -> None:
    if kernel not in ("auto", "first"):
        raise ValueError(f"{op}: unknown kernel {kernel!r} (auto, first)")


@torch.no_grad()
@spanned("rvk.row20.leaf_update")
def leaf_update(p, g, m, v, bc1, bc2, *, b1: float, b2: float, eps: float,
                lr: float, kernel: str = "auto") -> None:
    """One Adam step of the leaf ``p`` from its gradient ``g`` and moments
    ``m``, ``v`` — fp32 tensors of one shape, any rank — with ``p``, ``m``
    and ``v`` updated in place.  ``bc1``, ``bc2``: the bias corrections as
    0-d fp32 tensors on the leaf's device.

    Replaces ``benchmarks/adam_fusion_ab.py`` ``_leaf_update``.  CUDA: one
    launch (``csrc/adam.cu``) over the leaf as a flat run of fp32: the tree
    kernel with a table of one leaf, or with ``kernel="first"`` the
    first version."""
    _check_kernel("leaf_update", kernel)
    if isinstance(p, Tensor) and p.device.type == "cpu":
        return leaf_update_ref(p, g, m, v, bc1, bc2, b1=b1, b2=b2, eps=eps,
                               lr=lr)
    _on_cuda(p, "leaf_update")
    for name, t in (("p", p), ("g", g), ("m", m), ("v", v)):
        _leaf(t, name, p.device, p.shape)
    for name, t in (("bc1", bc1), ("bc2", bc2)):
        _leaf(t, name, p.device, ())
    n = p.numel()
    if not n:
        return
    if kernel == "first":
        _build.launch("rvk_leaf_update", p.device, p, g, m, v, bc1, bc2, n,
                      *hyper(b1, b2, eps, lr))
    else:
        ((_, lengths, start, vec),) = _plan_arrays((n,),
                                                   (_aligned(p, g, m, v),))
        ptr = ctypes.c_void_p * 1
        _build.launch("rvk_adam_tree", p.device, ptr(p.data_ptr()),
                      ptr(g.data_ptr()), ptr(m.data_ptr()), ptr(v.data_ptr()),
                      lengths, start, vec, 1, bc1, bc2, 0.0, 0.0,
                      *hyper(b1, b2, eps, lr))
    leaf_update.launches += 1


leaf_update.launches = 0


# ----------------------------------------------------------- the whole tree

@torch.no_grad()
@spanned("rvk.row20.adam_tree")
def adam_tree(ps: Sequence[Tensor], gs: Sequence[Tensor],
              ms: Sequence[Tensor], vs: Sequence[Tensor], bc1: float,
              bc2: float, *, b1: float, b2: float, eps: float, lr: float
              ) -> None:
    """One Adam step of every leaf ``ps[i]`` from its gradient ``gs[i]``
    and moments ``ms[i]``, ``vs[i]`` (fp32, each leaf's four of one shape),
    ``ps``, ``ms`` and ``vs`` updated in place; ``bc1``, ``bc2``: the bias
    corrections as Python floats (:func:`bias_corrections`).

    CUDA: the leaves on one device, :func:`tree_plan`'s launches of the tree
    kernel (``csrc/adam.cu``), one for a tree of up to
    :data:`K_MAX_LEAVES` leaves.  A gradient that is not contiguous is
    copied contiguous first."""
    k = len(ps)
    if not len(gs) == len(ms) == len(vs) == k:
        raise ValueError(f"adam_tree: {k} params, {len(gs)} gradients, "
                         f"{len(ms)} and {len(vs)} moments")
    if not k:
        return
    if isinstance(ps[0], Tensor) and ps[0].device.type == "cpu":
        corrections = [torch.full((), c, dtype=torch.float32)
                       for c in (bc1, bc2)]
        for p, g, m, v in zip(ps, gs, ms, vs):
            leaf_update_ref(p, g, m, v, *corrections, b1=b1, b2=b2, eps=eps,
                            lr=lr)
        return
    _on_cuda(ps[0], "adam_tree")
    dev, f32 = ps[0].device, torch.float32
    ptrs = ([], [], [], [])          # p, g, m, v
    sizes, aligned = [], []
    copies = []     # held until the launches are queued
    for i, (p, g, m, v) in enumerate(zip(ps, gs, ms, vs)):
        # a gradient may come out of autograd strided (a convolution's);
        # the state's own tensors are taken as they are
        if isinstance(g, Tensor) and not g.is_contiguous():
            g = g.contiguous()
            copies.append(g)
        shape = getattr(p, "shape", None)
        at = 0
        for got, t in zip(ptrs, (p, g, m, v)):
            if not (isinstance(t, Tensor) and t.dtype is f32
                    and t.device == dev and t.shape == shape
                    and t.is_contiguous()):
                for name, u in zip("pgmv", (p, g, m, v)):
                    _leaf(u, f"{name}[{i}]", dev, shape, "adam_tree")
            ptr = t.data_ptr()
            got.append(ptr)
            at |= ptr
        sizes.append(p.numel())
        aligned.append(at % 16 == 0)
    hyp = hyper(b1, b2, eps, lr)
    for leaves_, lengths, start, vec in _plan_arrays(tuple(sizes),
                                                     tuple(aligned)):
        n = len(leaves_)
        arrays = [(ctypes.c_void_p * n)(*(got[i] for i in leaves_))
                  for got in ptrs]
        _build.launch("rvk_adam_tree", dev, *arrays, lengths, start, vec, n,
                      None, None, bc1, bc2, *hyp)
        adam_tree.launches += 1


adam_tree.launches = 0


# ------------------------------------------------------- the whole-tree step

@torch.no_grad()
def fused_adam_apply(adam, state, grads, kernel: str = "auto") -> None:
    """One Adam update of ``state`` (params, moments, count) from fp32
    ``grads``, in place: the count, the two bias corrections, then
    :func:`adam_tree` over the whole tree — or, with ``kernel="first"``,
    the two corrections filled on the device and one first-version
    :func:`leaf_update` a leaf.  ``adam`` carries ``learning_rate``,
    ``b1``, ``b2`` and ``eps`` (``train/optim.py`` ``Adam``); the result
    equals its ``update`` bit for bit."""
    _check_kernel("fused_adam_apply", kernel)
    state.count += 1
    bc1, bc2 = bias_corrections(adam.b1, adam.b2, state.count)
    hyper_ = dict(b1=adam.b1, b2=adam.b2, eps=adam.eps,
                  lr=adam.learning_rate)
    if kernel == "auto":
        adam_tree(leaves(state.params), leaves(grads), leaves(state.mu),
                  leaves(state.nu), bc1, bc2, **hyper_)
        return
    on_device = {}   # device → the two corrections as 0-d fp32 tensors
    for p, g, m, v in zip(leaves(state.params), leaves(grads),
                          leaves(state.mu), leaves(state.nu)):
        if p.device not in on_device:
            on_device[p.device] = tuple(
                torch.full((), c, dtype=torch.float32, device=p.device)
                for c in (bc1, bc2))
        leaf_update(p, g.contiguous(), m, v, *on_device[p.device],
                    kernel="first", **hyper_)


@dataclass(frozen=True)
class FusedAdam:
    """``adam`` with its ``update`` through :func:`fused_adam_apply`: what
    ``parallel/step.py`` ``build_train_step`` takes as ``optimizer``."""

    adam: Any

    def update(self, state, grads) -> None:
        fused_adam_apply(self.adam, state, grads)
