"""Nested parameter trees of the port: dicts, lists and tuples (named ones
too) of tensors, the counterpart of ``jax.tree`` for the training modules
(``optim``, ``dist.compress``, ``ckpt``, ``train``).

Flattening order, which checkpoints record: depth first, dict entries in
sorted key order (as ``jax.tree`` orders them), list and tuple entries in
order. ``None`` is an empty subtree, as in ``jax.tree`` (an optimizer
state a step does not use checkpoints as nothing). Anything else that is
not a dict, list or tuple is a leaf.

The LM's parameters unroll the reference's per-layer stack into
``tree["layers"]``, a list of one dict per layer (``models/transformer``).
Where the reference's arithmetic sees a stacked leaf as one tensor (one
int8 scale over all layers, a rank of 2 for a per-layer vector),
:func:`stack_layers` / :func:`unstack_layers` give the stacked view back.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

import torch

Path = Tuple[Any, ...]
LAYERS = "layers"


def _children(tree):
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [(k, tree[k]) for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return list(enumerate(tree))
    return None


def _rebuild(like, values):
    if like is None:
        return None
    if isinstance(like, dict):
        return dict(zip(sorted(like), values))
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*values)
    if isinstance(like, tuple):
        return tuple(values)
    return list(values)


def flatten(tree, prefix: Path = ()) -> List[Tuple[Path, Any]]:
    """``[(path, leaf)]`` in the flattening order."""
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    out = []
    for key, sub in kids:
        out.extend(flatten(sub, prefix + (key,)))
    return out


def leaves(tree) -> List[Any]:
    return [leaf for _, leaf in flatten(tree)]


def unflatten(like, values) -> Any:
    """A tree shaped like ``like`` with ``values`` as its leaves, in the
    flattening order."""
    it = iter(values)

    def build(node):
        kids = _children(node)
        if kids is None:
            return next(it)
        return _rebuild(node, [build(sub) for _, sub in kids])
    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more values than leaves")
    return out


def map_(fn: Callable, tree, *rest) -> Any:
    """``fn(leaf, *leaves of rest)`` over trees of one structure."""
    flat = leaves(tree)
    others = [leaves(r) for r in rest]
    for o in others:
        if len(o) != len(flat):
            raise ValueError(f"trees differ: {len(flat)} and {len(o)} "
                             f"leaves")
    return unflatten(tree, [fn(x, *(o[i] for o in others))
                            for i, x in enumerate(flat)])


def stack_layers(tree) -> Any:
    """The reference's layout of a port tree: ``tree["layers"]`` (a list
    of per-layer trees of one structure) stacked on a new axis 0 into one
    tree. Trees without ``"layers"`` come back as they are."""
    if not (isinstance(tree, dict) and LAYERS in tree):
        return tree
    out = dict(tree)
    out[LAYERS] = map_(lambda *xs: torch.stack(xs), *tree[LAYERS])
    return out


def unstack_layers(tree, like) -> Any:
    """Inverse of :func:`stack_layers` for a port tree shaped like
    ``like``."""
    if not (isinstance(like, dict) and LAYERS in like):
        return tree
    out = dict(tree)
    stacked = tree[LAYERS]
    out[LAYERS] = [map_(lambda x, i=i: x[i], stacked)
                   for i in range(len(like[LAYERS]))]
    return out


def stacked_rank(path: Path, leaf: torch.Tensor) -> int:
    """The rank the leaf at ``path`` has in the reference's stacked layout:
    one more than its own under ``"layers"``."""
    return leaf.dim() + (1 if path and path[0] == LAYERS else 0)
