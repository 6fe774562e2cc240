"""Nested parameter trees of tensors: dicts, lists, tuples and
``core.quant.BlockQuantized`` nodes, with tensors (or any other object) at
the leaves and ``None`` as an empty subtree.

The traversal order and the leaf paths are those of
``jax.tree_util.tree_flatten_with_path``: dict keys in sorted order, list
and tuple items by index, a ``BlockQuantized`` as the two children ``0``
(``q``) and ``1`` (``exp``).  A path joins its keys with ``/``, so the
``(params, opt_state)`` tuple of a ResNet checkpoint has leaves such as
``0/blocks/0/conv0/bn/beta`` and ``1/mu/stem/w`` in both packages.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

from repro_torch.core.quant import BlockQuantized

SEP = "/"


def _children(node) -> List[Tuple[str, Any]]:
    """``(key, child)`` pairs of an inner node, or None for a leaf."""
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return [(str(i), c) for i, c in enumerate(node)]
    if isinstance(node, BlockQuantized):
        return [("0", node.q), ("1", node.exp)]
    return None


def flatten_with_path(tree) -> List[Tuple[str, Any]]:
    """``[(path, leaf), ...]`` in traversal order."""
    out = []
    _flatten(tree, [], out)
    return out


# The walks below are module-level functions, not closures that call
# themselves: a nested recursive function is a reference cycle (it holds
# its own cell), so whatever its frame reaches, the leaves included, would
# outlive the call until the cyclic collector runs.  On the card that
# keeps a model's weights allocated after the caller has dropped them.


def _flatten(node, prefix, out) -> None:
    if node is None:
        return
    kids = _children(node)
    if kids is None:
        out.append((SEP.join(prefix), node))
        return
    for k, c in kids:
        _flatten(c, prefix + [k], out)


def leaves(tree) -> list:
    return [leaf for _, leaf in flatten_with_path(tree)]


def unflatten(tree, new_leaves) -> Any:
    """A tree of ``tree``'s structure with ``new_leaves`` (in traversal
    order) at its leaves."""
    it = iter(new_leaves)
    out = _build(tree, it)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has")
    return out


def _build(node, it):
    if node is None:
        return None
    if isinstance(node, dict):
        # keep the caller's key order; leaves are consumed sorted
        built = {k: _build(node[k], it) for k in sorted(node)}
        return {k: built[k] for k in node}
    if isinstance(node, (list, tuple)):
        return type(node)(_build(c, it) for c in node)
    if isinstance(node, BlockQuantized):
        return BlockQuantized(q=_build(node.q, it), exp=_build(node.exp, it))
    return next(it)


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn(leaf, *leaves_of_rest)`` at every leaf of ``tree``; ``rest``
    are trees that have ``tree``'s structure down to its leaves (a leaf of
    ``tree`` may face a whole subtree of another, e.g. a
    ``BlockQuantized`` moment, which ``fn`` then receives whole)."""
    return _map(fn, tree, list(rest))


def _map(fn, node, others):
    if node is None:
        return None
    if isinstance(node, dict):
        return {k: _map(fn, node[k], [o[k] for o in others]) for k in node}
    if isinstance(node, (list, tuple)):
        return type(node)(_map(fn, c, [o[i] for o in others])
                          for i, c in enumerate(node))
    if isinstance(node, BlockQuantized):
        return BlockQuantized(q=_map(fn, node.q, [o.q for o in others]),
                              exp=_map(fn, node.exp, [o.exp for o in others]))
    return fn(node, *others)
