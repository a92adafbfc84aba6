"""Params trees: the one recursive walk every other module calls.

A params tree is what the JAX package keeps as a pytree: nested dicts and
lists (or tuples) whose leaves are tensors or arrays.  The dense model's is
``{"fc1": {"w", "b"}, ...}``; the deep and conv1d models hold lists of
layers (``{"enc": [{"w", "b"}, ...], "mu_head": {...}, ...}``).  The order
of the leaves is ``jax.tree_util``'s: dict keys sorted at every level,
list entries by index — the order of the checkpoint files, so it must not
change.
"""

from __future__ import annotations

from typing import Any, Callable, List, Tuple


def flatten(tree: Any) -> List[Tuple[str, Any]]:
    """``(dotted path, leaf)`` pairs of a tree, in JAX's flatten order
    (``enc.0.w``, ``mu_head.b``: the names of the JAX package's
    ``tree_dotted_names``)."""
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return [("", tree)]
    return [(f"{k}.{path}" if path else k, leaf)
            for k, sub in items for path, leaf in flatten(sub)]


def leaves(tree: Any) -> List[Any]:
    """The leaves of a tree, in :func:`flatten` order (walked without
    forming the names: an optimizer step walks four trees)."""
    out: List[Any] = []
    _collect(tree, out)
    return out


def _collect(tree: Any, out: List[Any]) -> None:
    if isinstance(tree, dict):
        for k in sorted(tree):
            _collect(tree[k], out)
    elif isinstance(tree, (list, tuple)):
        for sub in tree:
            _collect(sub, out)
    else:
        out.append(tree)


def unflatten(template: Any, new_leaves: List[Any]) -> Any:
    """Rebuild ``template``'s structure from ``new_leaves`` (given in
    :func:`flatten` order).  Dicts come back with sorted keys, lists and
    tuples as lists."""
    it = iter(new_leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return [build(v) for v in t]
        return next(it)

    return build(template)


def tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    """``fn`` applied to every leaf, structure (and key order) kept."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)
