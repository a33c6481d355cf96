"""Trees of tensors for the training substrate (the part of jax's pytrees
that ``repro.training`` and ``repro.checkpoint`` use).

A tree is a tensor (or numpy array), or a dict, list or tuple of trees; an
``nn.Module`` stands for the flat dict of its ``named_parameters()``.
Leaves come in jax's order: dict keys sorted, lists and tuples in order, so
a nested dict has the leaf order of the reference's ``tree_flatten``.
"""
from __future__ import annotations

from typing import Any, Callable

from torch import nn


def as_tree(x) -> Any:
    """``x``, or the dict of a module's named parameters."""
    if isinstance(x, nn.Module):
        return dict(x.named_parameters())
    return x


def leaves(tree) -> list:
    """The leaves of ``tree`` (an ``nn.Module``: its parameters) in jax's
    order."""
    tree = as_tree(tree)
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in leaves(v)]
    return [tree]


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``), in the tree's structure."""
    tree = as_tree(tree)
    rest = tuple(as_tree(r) for r in rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def unflatten(like, new_leaves) -> Any:
    """A tree of ``like``'s structure (a module: its parameter dict) whose
    leaves, in jax's order, are ``new_leaves``."""
    it = iter(new_leaves)

    def take():
        try:
            return next(it)
        except StopIteration:
            raise ValueError("unflatten: fewer leaves than the tree has") from None

    def build(node):
        if isinstance(node, dict):
            built = {k: build(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}
        if isinstance(node, (list, tuple)):
            return type(node)([build(v) for v in node])
        return take()

    out = build(as_tree(like))
    if next(it, None) is not None:
        raise ValueError("unflatten: more leaves than the tree has")
    return out
