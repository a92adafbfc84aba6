"""Parameter sharding rules — the JAX package's ``parallel/sharding.py`` on
``torch.distributed``: the Megatron split of the ``model`` axis.

A spec is one of three words a leaf:

* ``"replicated"`` (JAX ``P()``): every rank of the model group holds the
  whole leaf;
* ``"columns"`` (JAX ``P(None, 'model')`` for a weight, ``P('model')`` for
  its bias): a column-parallel layer, each rank holding a contiguous slice
  of the output axis;
* ``"rows"`` (JAX ``P('model', None)``): a row-parallel weight, each rank
  holding a contiguous slice of the input axis (its bias is replicated).

Dense VAE (JAX ``:29-42``)::

    fc1   w (seg, units)    columns    b (units,)  columns
    fc21  w (units, latent) rows       b           replicated
    fc22  w (units, latent) rows       b           replicated
    fc3   w (latent, units) columns    b (units,)  columns
    fc4   w (units, seg)    rows       b           replicated

The deep MLP (JAX ``:57-94``): encoder and decoder chains alternate
columns, rows, columns, rows; an odd decoder's last layer is forced to
rows (it produces the segment axis; its input is then replicated, and the
forward slices it locally); the heads are rows after an odd encoder and
replicated after an even one.  conv1d and anything else: replicated.

Where JAX annotates and GSPMD inserts the collectives, here the layers of
``parallel/tensor_parallel.py`` run on each rank's shards and call them
themselves.  Rank ``r`` of the model group (``Mesh.model_index``) holds
slice ``r`` of every sharded axis: :func:`shard_params` keeps it as a
contiguous copy, :func:`gather_params` puts the leaves back together (a
collective: every rank of the model group calls it).
"""

from __future__ import annotations

from typing import Any

import torch

from rawaudiovae_kelsey_tpu_torch.parallel.mesh import (
    Mesh,
    model_all_gather,
    model_slice,
)
from rawaudiovae_kelsey_tpu_torch.tree import flatten, tree_map, unflatten

REPLICATED, COLUMNS, ROWS = "replicated", "columns", "rows"
SPECS = (REPLICATED, COLUMNS, ROWS)

_DENSE_W_SPECS = {"fc1": COLUMNS, "fc21": ROWS, "fc22": ROWS,
                  "fc3": COLUMNS, "fc4": ROWS}
_DENSE_B_SPECS = {"fc1": COLUMNS, "fc21": REPLICATED, "fc22": REPLICATED,
                  "fc3": COLUMNS, "fc4": REPLICATED}
_COL = {"w": COLUMNS, "b": COLUMNS}      # output sharded
_ROW = {"w": ROWS, "b": REPLICATED}      # input sharded, partial sums added


def dense_param_specs(params: Any) -> Any:
    """The spec tree of the dense VAE params layout."""
    return {name: {"w": _DENSE_W_SPECS[name], "b": _DENSE_B_SPECS[name]}
            for name in params}


def _deep_chain_specs(n: int) -> list:
    """Megatron alternation for a chain of linear layers: columns, rows,
    columns, rows — layer k's sharded output feeds layer k + 1's sharded
    input with no collective between them; one reduction a pair."""
    return [dict(_COL) if i % 2 == 0 else dict(_ROW) for i in range(n)]


def param_specs(model_name: str, params: Any, model_parallel: int) -> Any:
    """The spec tree of any model family (the params' structure, a spec a
    leaf).  With ``model_parallel <= 1`` everything is replicated."""
    if model_parallel <= 1:
        return tree_map(lambda _: REPLICATED, params)
    if model_name == "dense":
        return dense_param_specs(params)
    if model_name == "deep":
        enc = _deep_chain_specs(len(params["enc"]))
        dec = _deep_chain_specs(len(params["dec"]))
        if len(dec) % 2 == 1:
            # the last decoder layer produces the segment axis: rows
            # (replicated output) even where the alternation lands on
            # columns
            dec[-1] = dict(_ROW)
        # the heads read the last encoder activation: rows where it is
        # sharded (the last encoder layer was columns), else replicated
        head = (dict(_ROW) if len(params["enc"]) % 2 == 1
                else {"w": REPLICATED, "b": REPLICATED})
        return {"enc": enc, "dec": dec, "mu_head": dict(head),
                "logvar_head": dict(head)}
    # conv1d and anything else: replicate (small params)
    return tree_map(lambda _: REPLICATED, params)


def spec_axis(ndim: int, spec: str) -> int | None:
    """The axis ``spec`` cuts a leaf of ``ndim`` axes along (None:
    replicated): a column-parallel weight's last, its bias's only, a
    row-parallel weight's first."""
    if spec == REPLICATED:
        return None
    if spec == COLUMNS:
        return ndim - 1
    if spec == ROWS:
        return 0
    raise ValueError(f"unknown spec {spec!r}; expected one of {SPECS}")


def shard_dim(leaf, spec: str) -> int | None:
    """:func:`spec_axis` of a tensor or array."""
    return spec_axis(len(leaf.shape), spec)


def check_divisible(params: Any, specs: Any, model_parallel: int) -> None:
    """Raise ``ValueError`` naming the first leaf whose sharded axis does
    not divide ``model_parallel`` (the kernels take whole, equal shards)."""
    for (name, leaf), (_, spec) in zip(flatten(params), flatten(specs)):
        dim = shard_dim(leaf, spec)
        if dim is not None and leaf.shape[dim] % model_parallel:
            raise ValueError(
                f"{name}: axis {dim} of {tuple(leaf.shape)} does not divide "
                f"the {model_parallel} ranks of the model axis")


def local_slice(full_leaf: torch.Tensor, spec: str, mesh: Mesh
                ) -> torch.Tensor:
    """This rank's shard of a whole leaf: a contiguous copy of slice
    ``mesh.model_index`` along the spec's axis (the leaf itself where it is
    replicated)."""
    dim = shard_dim(full_leaf, spec)
    if dim is None or mesh.model == 1:
        return full_leaf
    return model_slice(full_leaf, mesh, dim)


def shard_params(params: Any, mesh: Mesh, specs: Any) -> Any:
    """Whole leaves → this rank's shards (:func:`local_slice` of each)."""
    check_divisible(params, specs, mesh.model)
    leaves = [local_slice(t, spec, mesh) for (_, t), (_, spec)
              in zip(flatten(params), flatten(specs))]
    return unflatten(params, leaves)


def gather_params(local: Any, mesh: Mesh, specs: Any) -> Any:
    """Shards → whole leaves on every rank of the model group, in the
    leaves' flatten order (a collective: every rank of the group calls it
    with its own shards)."""
    leaves = []
    for (_, t), (_, spec) in zip(flatten(local), flatten(specs)):
        dim = shard_dim(t, spec)
        leaves.append(t if dim is None
                      else model_all_gather(t.detach(), mesh, dim))
    return unflatten(local, leaves)


def global_shape(local_leaf: torch.Tensor, spec: str, model_parallel: int
                 ) -> tuple:
    """The whole leaf's shape from a shard's."""
    shape = list(local_leaf.shape)
    dim = shard_dim(local_leaf, spec)
    if dim is not None:
        shape[dim] *= model_parallel
    return tuple(shape)
