"""The tensor-parallel forward and backward: the Megatron split of
``parallel/sharding.py`` run on each rank's shards, with the model group's
collectives where the split needs them.

The JAX package annotates the params and lets GSPMD partition the step;
its Pallas kernels are opaque to XLA, which partitions around them.  Here
every rank of the model group computes on its shards and calls the
collectives itself (``parallel/mesh.py``: ``model_all_reduce``,
``model_all_gather``, ``model_slice``).  The rule of a layer:

* **columns** (fc1, fc3, even-numbered deep layers): the input is
  replicated; the product on the rank's column shard keeps its fused
  epilogue (bias, ReLU), so each rank holds its slice of the output
  columns.  Backward: the weight and bias gradients are the shard's, with
  no collective; the input gradient is a partial sum, added over the model
  group (in fp32);
* **rows** (fc21, fc22, fc4, odd-numbered deep layers, an odd decoder's
  last): the input is the rank's column slice; the kernel runs on the
  shards with its epilogue APART — no bias, no activation, fp32 partial sums
  out (``ops/mlp.py`` ``encoder_fwd_partial`` / ``decoder_fwd_partial``,
  ``ops/linear.py`` ``linear_partial``) — then ONE fp32 all-reduce over
  the model group, then the bias, the activation and one rounding to the
  operand dtype.  Backward: the output is replicated, so its cotangent
  is; the input gradient is the rank's slice (local), the weight gradient
  the shard's, and the replicated bias gets the same gradient on every
  rank (it is added once, after the sum);
* **rows with a replicated input** (the deep decoder's last layer after a
  row-parallel one): the input's columns are sliced locally first, and
  the input gradient's columns are all-gathered in the backward;
* **replicated** (the deep heads after an even encoder, conv1d): as on one
  device.

``build_model`` gives the families; :func:`tensor_parallel_model` wraps a
``ModelDef`` so its ``encode`` / ``decode`` take a rank's shards.  Under
``backend = pallas`` the dense model runs :class:`ShardedEncode` /
:class:`ShardedDecode` (the kernels of ``ops/mlp.py`` on shards, all three
backward modes of ``ops/mlp.py`` ``encode_grads`` / ``decode_grads``) and
the deep model :class:`RowLinear` for its row-parallel layers (the
column-parallel and replicated ones are ``ops/linear.py`` ``PallasLinear``
as on one device, its backward plain PyTorch as the JAX package's is plain
XLA).  Under ``xla`` the same split runs on plain PyTorch ops: the plain
version the tests hold the kernels' route against.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Tuple

import torch

from rawaudiovae_kelsey_tpu_torch.config.schema import Config
from rawaudiovae_kelsey_tpu_torch.models import vae
from rawaudiovae_kelsey_tpu_torch.models.registry import (
    ModelDef,
    backward_fusion,
)
from rawaudiovae_kelsey_tpu_torch.ops import linear as L
from rawaudiovae_kelsey_tpu_torch.ops import mlp
from rawaudiovae_kelsey_tpu_torch.parallel.mesh import (
    Mesh,
    model_all_gather,
    model_all_reduce,
    model_slice,
)
from rawaudiovae_kelsey_tpu_torch.parallel.sharding import (
    COLUMNS,
    ROWS,
    param_specs,
)

Tensor = torch.Tensor
_f = mlp._f


# ------------------------------------------- the model group's collectives

class CopyToModel(torch.autograd.Function):
    """Identity forward; the backward adds the cotangent's partial sums
    over the model group (the input of a column-parallel layer)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x

    @staticmethod
    def backward(ctx, dx):
        (total,) = model_all_reduce([dx], ctx.mesh)
        return total.to(dx.dtype), None


class ReduceFromModel(torch.autograd.Function):
    """The fp32 sum of the partial sums over the model group; the backward
    passes the (replicated) cotangent through."""

    @staticmethod
    def forward(ctx, part, mesh):
        (total,) = model_all_reduce([part], mesh)
        return total

    @staticmethod
    def backward(ctx, d):
        return d, None


class ScatterColumns(torch.autograd.Function):
    """A replicated input's column slice at the rank's model index; the
    backward all-gathers the slices' cotangents."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return model_slice(x, mesh, 1)

    @staticmethod
    def backward(ctx, d):
        return model_all_gather(d, ctx.mesh, 1), None


def copy_to_model(x: Tensor, mesh: Mesh) -> Tensor:
    return CopyToModel.apply(x, mesh) if mesh.model > 1 else x


def reduce_from_model(part: Tensor, mesh: Mesh) -> Tensor:
    return ReduceFromModel.apply(part, mesh)


def scatter_columns(x: Tensor, mesh: Mesh) -> Tensor:
    return ScatterColumns.apply(x, mesh) if mesh.model > 1 else x


# ----------------------------------------------------- the dense model, kernels

class ShardedEncode(torch.autograd.Function):
    """``(mode, passes, mesh, x, w1, b1, w21, b21, w22, b22) → (mu,
    logvar)`` on a rank's shards:
    :func:`~rawaudiovae_kelsey_tpu_torch.ops.mlp.encoder_fwd_partial` in
    ``passes`` passes (h on fc1's column shard, the heads' fp32 partial
    sums), one fp32 all-reduce of both heads, then their biases and one
    rounding.
    Backward: ``ops/mlp.py`` ``encode_grads`` on the shards in ``mode`` and
    ``passes`` passes (dh is local: h is the rank's columns); ``b21`` /
    ``b22`` get the whole cotangent's
    column sums, equal on every rank; ``dx``, where it is asked for, is
    added over the model group."""

    @staticmethod
    def forward(ctx, mode, passes, mesh, x, w1, b1, w21, b21, w22, b22):
        mu_p, lv_p, h = mlp.encoder_fwd_partial(w1, b1, w21, w22, x,
                                                passes=passes)
        mu_p, lv_p = model_all_reduce([mu_p, lv_p], mesh)
        dt = x.dtype
        mu = (mu_p + _f(b21)).to(dt)
        logvar = (lv_p + _f(b22)).to(dt)
        ctx.save_for_backward(x, h, w1, w21, w22)
        ctx.mode, ctx.passes, ctx.mesh = mode, passes, mesh
        return mu, logvar

    @staticmethod
    def backward(ctx, dmu, dlogvar):
        x, h, w1, w21, w22 = ctx.saved_tensors
        dx, *grads = mlp.encode_grads(ctx.mode, ctx.passes, x, h,
                                      dmu.contiguous(), dlogvar.contiguous(),
                                      w1, w21, w22, ctx.needs_input_grad[3])
        if dx is not None:
            (total,) = model_all_reduce([dx], ctx.mesh)
            dx = total.to(x.dtype)
        dt = w1.dtype
        return (None, None, None, dx, *(g.to(dt) for g in grads))


class ShardedDecode(torch.autograd.Function):
    """``(mode, passes, mesh, z, w3, b3, w4, b4) → y`` on a rank's shards:
    :func:`~rawaudiovae_kelsey_tpu_torch.ops.mlp.decoder_fwd_partial` in
    ``passes`` passes (h3 on fc3's column shard, y's fp32 partial sums),
    one fp32 all-reduce,
    then ``b4``, tanh and one rounding.  Backward: ``ops/mlp.py``
    ``decode_grads`` on the shards in ``mode`` and ``passes`` passes from
    the replicated cotangent; ``dz`` is
    a partial sum (z meets fc3's column shard), added over the model group
    in fp32."""

    @staticmethod
    def forward(ctx, mode, passes, mesh, z, w3, b3, w4, b4):
        y_p, h3 = mlp.decoder_fwd_partial(w3, b3, w4, z, passes=passes)
        (y_p,) = model_all_reduce([y_p], mesh)
        y = torch.tanh(y_p + _f(b4)).to(z.dtype)
        ctx.save_for_backward(z, h3, y, w3, w4)
        ctx.mode, ctx.passes, ctx.mesh = mode, passes, mesh
        return y

    @staticmethod
    def backward(ctx, dy):
        z, h3, y, w3, w4 = ctx.saved_tensors
        dz, *grads = mlp.decode_grads(ctx.mode, ctx.passes,
                                      mlp.tanh_cotangent(dy, y), h3, z, w3,
                                      w4)
        (total,) = model_all_reduce([dz], ctx.mesh)
        dt = w3.dtype
        return (None, None, None, total.to(z.dtype),
                *(g.to(dt) for g in grads))


def dense_encode_sharded(params, x: Tensor, mesh: Mesh,
                         mode: str | None = None, passes: int = 1
                         ) -> Tuple[Tensor, Tensor]:
    """The dense encoder on a rank's shards through the kernels, every
    product in ``passes`` passes, the backward in ``mode`` (``ops/mlp.py``
    ``encode``: None reads the switch, ``mlp.fusion``)."""
    return ShardedEncode.apply(
        mlp.fusion(x.dtype, passes) if mode is None else mlp.check_mode(mode),
        passes, mesh, x,
        params["fc1"]["w"], params["fc1"]["b"],
        params["fc21"]["w"], params["fc21"]["b"],
        params["fc22"]["w"], params["fc22"]["b"])


def dense_decode_sharded(params, z: Tensor, mesh: Mesh,
                         mode: str | None = None, passes: int = 1
                         ) -> Tensor:
    """The dense decoder on a rank's shards through the kernels, as
    :func:`dense_encode_sharded`."""
    return ShardedDecode.apply(
        mlp.fusion(z.dtype, passes) if mode is None else mlp.check_mode(mode),
        passes, mesh, z,
        params["fc3"]["w"], params["fc3"]["b"],
        params["fc4"]["w"], params["fc4"]["b"])


# ------------------------------------------------------- the plain route

def row_parallel_plain(x: Tensor, layer, act: str, mesh: Mesh) -> Tensor:
    """A row-parallel layer on plain ops: the fp32 partial product (the
    plain version of the kernels' partial form), the sum over the model
    group, then the bias, the activation and one rounding."""
    part = _f(x) @ _f(layer["w"])
    total = reduce_from_model(part, mesh)
    return L.apply_act(act, total + _f(layer["b"])).to(x.dtype)


def dense_encode_plain(params, x: Tensor, mesh: Mesh
                       ) -> Tuple[Tensor, Tensor]:
    """The dense encoder's Megatron split on plain PyTorch ops."""
    h = torch.relu(vae.linear(params["fc1"], copy_to_model(x, mesh)))
    return (row_parallel_plain(h, params["fc21"], "none", mesh),
            row_parallel_plain(h, params["fc22"], "none", mesh))


def dense_decode_plain(params, z: Tensor, mesh: Mesh) -> Tensor:
    h3 = torch.relu(vae.linear(params["fc3"], copy_to_model(z, mesh)))
    return row_parallel_plain(h3, params["fc4"], "tanh", mesh)


# ------------------------------------------------- the deep model, kernels

class RowLinear(torch.autograd.Function):
    """``(x, w, b, act, ksplit, mesh) → act(Σ_model x @ w + b)``: a
    row-parallel layer of the deep model on the kernels —
    :func:`~rawaudiovae_kelsey_tpu_torch.ops.linear.linear_partial` (the
    k-split form where ``ksplit``) on the rank's input columns and weight
    rows, one fp32 all-reduce, then bias, activation and one rounding.
    Saves ``(x, w, y)``; the backward is ``PallasLinear``'s
    (``ops/linear.py`` ``linear_grads``, plain PyTorch): the input
    gradient is the rank's columns (local), ``b``'s gradient equal on
    every rank."""

    @staticmethod
    def forward(ctx, x, w, b, act, ksplit, mesh):
        part = L.linear_partial(x, w, ksplit)
        (total,) = model_all_reduce([part], mesh)
        y = L.apply_act(act, total + _f(b)).to(x.dtype)
        ctx.save_for_backward(x, w, y)
        ctx.act = act
        return y

    @staticmethod
    def backward(ctx, dy):
        x, w, y = ctx.saved_tensors
        return (*L.linear_grads(ctx.act, x, w, y, dy,
                                ctx.needs_input_grad[0]), None, None, None)


def _deep_layer(x: Tensor, layer, spec: str, act: str, sharded: bool,
                mesh: Mesh, kernels: bool) -> Tuple[Tensor, bool]:
    """One deep layer of spec ``spec`` on input ``x`` (``sharded``: the
    rank's columns of the activation) → ``(y, y is sharded)``."""
    if spec == COLUMNS:
        x = copy_to_model(x, mesh)
        y = (L.pallas_linear(x, layer["w"], layer["b"], act) if kernels
             else L.apply_act(act, vae.linear(layer, x)))
        return y, True
    if spec == ROWS:
        if not sharded:
            x = scatter_columns(x, mesh)
        if kernels:
            ksplit = L.takes_ksplit(x.shape[0], layer["w"].shape[0],
                                    layer["w"].shape[1])
            y = RowLinear.apply(x, layer["w"], layer["b"], act, ksplit, mesh)
        else:
            y = row_parallel_plain(x, layer, act, mesh)
        return y, False
    if sharded:
        raise ValueError("a replicated layer after a column-parallel one: "
                         "the Megatron alternation never gives one")
    y = (L.pallas_linear(x, layer["w"], layer["b"], act) if kernels
         else L.apply_act(act, vae.linear(layer, x)))
    return y, False


def deep_encode_sharded(params, x: Tensor, mesh: Mesh, kernels: bool
                        ) -> Tuple[Tensor, Tensor]:
    """The deep encoder on a rank's shards (``kernels``: rows 15-16 and
    :class:`RowLinear`; else plain ops)."""
    specs = param_specs("deep", params, mesh.model)
    h, sharded = x, False
    for layer, spec in zip(params["enc"], specs["enc"]):
        h, sharded = _deep_layer(h, layer, spec["w"], "relu", sharded, mesh,
                                 kernels)
    out = []
    for head in ("mu_head", "logvar_head"):
        y, _ = _deep_layer(h, params[head], specs[head]["w"], "none",
                           sharded, mesh, kernels)
        out.append(y)
    return out[0], out[1]


def deep_decode_sharded(params, z: Tensor, mesh: Mesh, kernels: bool
                        ) -> Tensor:
    """The deep decoder on a rank's shards."""
    specs = param_specs("deep", params, mesh.model)
    h, sharded = z, False
    last = len(params["dec"]) - 1
    for i, (layer, spec) in enumerate(zip(params["dec"], specs["dec"])):
        h, sharded = _deep_layer(h, layer, spec["w"],
                                 "tanh" if i == last else "relu", sharded,
                                 mesh, kernels)
    return h


# -------------------------------------------------------------- the model

def tensor_parallel_model(model: ModelDef, cfg: Config, mesh: Mesh
                          ) -> ModelDef:
    """``model`` with ``encode`` / ``decode`` (and their plain forms) that
    take a rank's shards (``parallel/sharding.py`` ``shard_params``) and
    give the replicated outputs every rank of the model group shares.
    ``model`` itself where the mesh has one model rank or the family is
    replicated whole (conv1d).  The dense kernels' ``encode`` / ``decode``
    take ``passes`` as ``ops/mlp.py`` ``encode`` does, which a step binds
    (``models/registry.py`` ``under_tier``), and the backward mode of
    ``models/registry.py`` ``backward_fusion``, read here, as
    ``build_model`` reads it."""
    if mesh.model <= 1 or model.name not in ("dense", "deep"):
        return model
    pallas = model.backend == "pallas"
    if model.name == "dense":
        mode = backward_fusion(cfg)

        def plain_enc(p, x):
            return dense_encode_plain(p, x, mesh)

        def plain_dec(p, z):
            return dense_decode_plain(p, z, mesh)

        def enc(p, x, passes=1):
            return dense_encode_sharded(p, x, mesh, mode, passes)

        def dec(p, z, passes=1):
            return dense_decode_sharded(p, z, mesh, mode, passes)

        # a step under ``high`` binds ops/mlp.py encode's pass count
        enc.high_passes = dec.high_passes = mlp.HIGH_PASSES
    else:
        def plain_enc(p, x):
            return deep_encode_sharded(p, x, mesh, False)

        def plain_dec(p, z):
            return deep_decode_sharded(p, z, mesh, False)

        def enc(p, x):
            return deep_encode_sharded(p, x, mesh, True)

        def dec(p, z):
            return deep_decode_sharded(p, z, mesh, True)
    return replace(model, encode=enc if pallas else plain_enc,
                   decode=dec if pallas else plain_dec,
                   plain_encode=plain_enc, plain_decode=plain_dec)

