"""Nested parameter trees of the port, in the JAX package's leaf order.

The port's parameters are plain nested dictionaries and lists with the JAX
pytrees' structure (LM, encoder and seq2seq alike).  These functions walk
them in ``jax.tree_util``'s order: dictionary keys sorted, lists and
tuples in order, ``None`` an empty node, anything else a leaf.  The
optimizer, the checkpoint and the weight conversion share that order, so
a leaf's index means the same on both sides.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, List, Sequence


_END = object()


def _children(tree: Any):
    if isinstance(tree, dict):
        return [tree[k] for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return list(tree)
    return None


def _walk(tree: Any) -> Iterator[Any]:
    if tree is None:
        return
    children = _children(tree)
    if children is None:
        yield tree
        return
    for child in children:
        yield from _walk(child)


def tree_leaves(tree: Any) -> List[Any]:
    """The leaves of ``tree`` in ``jax.tree_util.tree_leaves`` order."""
    return list(_walk(tree))


def tree_unflatten(like: Any, leaves: Sequence[Any]) -> Any:
    """A tree of ``like``'s structure whose leaves are ``leaves``, taken in
    :func:`tree_leaves` order.  Raises ``ValueError`` when their count is
    not ``like``'s."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return type(node)(build(x) for x in node)
        try:
            return next(it)
        except StopIteration:
            raise ValueError("fewer leaves than the tree holds") from None

    out = build(like)
    if next(it, _END) is not _END:
        raise ValueError("more leaves than the tree holds")
    return out


def tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    """``tree`` with ``fn`` applied to every leaf."""
    return tree_unflatten(tree, [fn(x) for x in tree_leaves(tree)])
