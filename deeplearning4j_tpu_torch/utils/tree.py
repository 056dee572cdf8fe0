"""Nested dicts of tensors: the port's params, state, gradient and
updater-state trees (the JAX package's pytrees)."""

from __future__ import annotations


def tmap(fn, *trees):
    """``fn`` over the leaves of nested dicts of one structure (the first
    tree's keys), in the first tree's key order."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tmap(fn, *(t[k] for t in trees)) for k in first}
    return fn(*trees)


def leaves(tree):
    """The leaves of a nested dict, in key order."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from leaves(v)
    else:
        yield tree
