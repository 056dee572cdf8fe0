"""Reduction / index / statistics catalog ops.

Port of ``deeplearning4j_tpu/ops/reduce.py``, with the jnp keyword names
(``axis``, ``keepdims``). ``axis`` is None (every dim), an int, or a
sequence of ints (a recorded graph stores a tuple as a list). Integer and
bool inputs of mean/std/var reduce in float32, as jnp does; std and var
are the population statistics (``ddof=0``); argmax and argmin return
int32.
"""

from __future__ import annotations

import torch

from . import register
from .math import _dims, _float, abs_


def _reduce(fn, a, axis, keepdims):
    if axis is None and not keepdims:
        return fn(a)
    return fn(a, dim=_dims(axis, a.dim()), keepdim=keepdims)


def _int32(out, a):
    """torch sums integers (and bools) into int64; jnp without x64 keeps
    them int32."""
    if not a.is_floating_point() and out.dtype == torch.int64 \
            and a.dtype != torch.int64:
        return out.to(torch.int32)
    return out


@register("reduce.sum", category="reduce")
def sum_(a, axis=None, keepdims=False):
    return _int32(_reduce(torch.sum, a, axis, keepdims), a)


@register("reduce.mean", category="reduce")
def mean(a, axis=None, keepdims=False):
    return _reduce(torch.mean, _float(a), axis, keepdims)


@register("reduce.max", category="reduce")
def max_(a, axis=None, keepdims=False):
    return _reduce(torch.amax, a, axis, keepdims)


@register("reduce.min", category="reduce")
def min_(a, axis=None, keepdims=False):
    return _reduce(torch.amin, a, axis, keepdims)


@register("reduce.prod", category="reduce")
def prod(a, axis=None, keepdims=False):
    if axis is None:
        out = torch.prod(a)
        return _int32(out.reshape((1,) * a.dim()) if keepdims else out, a)
    out = a
    for d in sorted(_dims(axis, a.dim()), reverse=True):
        out = torch.prod(out, dim=d, keepdim=keepdims)
    return _int32(out, a)


@register("reduce.std", category="reduce")
def std(a, axis=None, keepdims=False):
    return torch.std(_float(a), dim=None if axis is None
                     else _dims(axis, a.dim()), correction=0,
                     keepdim=keepdims)


@register("reduce.var", category="reduce")
def var(a, axis=None, keepdims=False):
    return torch.var(_float(a), dim=None if axis is None
                     else _dims(axis, a.dim()), correction=0,
                     keepdim=keepdims)


def _ordered(a):
    """A bool tensor as uint8 for argmax/argmin, which torch refuses on
    bools (jnp orders False before True)."""
    return a.to(torch.uint8) if a.dtype == torch.bool else a


@register("reduce.argmax", category="indexreduce", differentiable=False)
def argmax(a, axis=None, keepdims=False):
    return torch.argmax(_ordered(a), dim=axis,
                        keepdim=keepdims).to(torch.int32)


@register("reduce.argmin", category="indexreduce", differentiable=False)
def argmin(a, axis=None, keepdims=False):
    return torch.argmin(_ordered(a), dim=axis,
                        keepdim=keepdims).to(torch.int32)


@register("reduce.cumsum", category="reduce")
def cumsum(a, axis=None):
    if axis is None:
        a, axis = a.reshape(-1), 0
    return _int32(torch.cumsum(a, dim=axis), a)


@register("reduce.norm1", category="reduce")
def norm1(a, axis=None, keepdims=False):
    return _int32(_reduce(torch.sum, abs_(a), axis, keepdims), a)


@register("reduce.norm2", category="reduce")
def norm2(a, axis=None, keepdims=False):
    return torch.sqrt(_reduce(torch.sum, a * a, axis, keepdims))


@register("reduce.normmax", category="reduce")
def normmax(a, axis=None, keepdims=False):
    return _reduce(torch.amax, abs_(a), axis, keepdims)


@register("reduce.logsumexp", category="reduce")
def logsumexp(a, axis=None, keepdims=False):
    dims = _dims(axis, a.dim())
    m = torch.amax(a, dim=dims, keepdim=True)
    out = torch.log(torch.sum(torch.exp(a - m), dim=dims, keepdim=True)) + m
    return out if keepdims else out.reshape(
        [s for i, s in enumerate(out.shape) if i not in dims])
