"""Gradient normalization and clipping.

Port of ``deeplearning4j_tpu/nn/gradnorm.py`` (DL4J's
``GradientNormalization`` modes, applied to the whole gradient tree
before the updater). A "layer" is a top-level key of the tree (a graph
vertex); a "param type" is one leaf tensor. Zero norms are guarded with a
tiny epsilon, as in the JAX package.

``clip_events`` is a 0-dim int32 tensor on the gradients' device (1 when
any clip engaged this step), so computing it makes no host sync; the
divergence sentinel accumulates it.

A ``reducer`` (the ZeRO-1 / tensor-parallel gradient sync of a
``ParallelWrapper`` step, whose ranks each hold a part of the gradient)
gives the global sum of squares of each leaf (``reducer.ssq(tree)``) and
the global "any" of a flag (``reducer.any(flag)``): every norm and every
engaged-flag is then the whole gradient's, as in the JAX package's step,
where GSPMD reduces them over the shards. Without one, each rank's
gradients are whole and everything is local.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from ..utils.tree import leaves as _leaves
from ..utils.tree import tmap as _tmap

MODES = (
    "RenormalizeL2PerLayer",
    "RenormalizeL2PerParamType",
    "ClipElementWiseAbsoluteValue",
    "ClipL2PerLayer",
    "ClipL2PerParamType",
)

_EPS = 1e-12


def validate(mode: Optional[str]) -> None:
    if mode is not None and mode not in MODES:
        raise ValueError(f"unknown GradientNormalization mode {mode!r}; "
                         f"expected one of {MODES}")


def _device(grads):
    for g in _leaves(grads):
        return g.device
    return torch.device("cpu")


def _ssq(tree, reducer=None):
    """Per leaf, its sum of squares (global under a ``reducer``)."""
    if reducer is not None:
        return reducer.ssq(tree)
    return _tmap(lambda g: torch.sum(torch.square(g)), tree)


def _tree_l2(sq):
    """The L2 norm of a tree from its leaves' sums of squares."""
    return torch.sqrt(sum(_leaves(sq)) + 0.0)


def _any(flag, reducer=None):
    return flag if reducer is None else reducer.any(flag)


def _flag(hit, device):
    """A 0-dim int32 0/1 tensor from a bool tensor (or python bool, filled
    on ``device``: a host-to-device copy of it would synchronize)."""
    if isinstance(hit, bool):
        return torch.full((), int(hit), dtype=torch.int32, device=device)
    return hit.to(device=device, dtype=torch.int32)


def clip_engaged(mode: Optional[str], threshold: float, grads,
                 reducer=None):
    """0/1 int32: did this mode's clip engage on ``grads`` (some norm or
    element above the threshold)? The Renormalize modes rescale always and
    never count; mode None is 0."""
    dev = _device(grads)
    if mode is None or mode.startswith("Renormalize"):
        return _flag(False, dev)
    t = float(threshold)
    if mode == "ClipElementWiseAbsoluteValue":
        return value_clip_engaged(grads, t, reducer)
    if mode == "ClipL2PerLayer":
        sq = _ssq(grads, reducer)
        hits = [_tree_l2(v) > t for v in sq.values()]
        return _flag(torch.stack(hits).any() if hits else False, dev)
    if mode == "ClipL2PerParamType":
        hits = [torch.sqrt(s) > t for s in _leaves(_ssq(grads, reducer))]
        return _flag(torch.stack(hits).any() if hits else False, dev)
    validate(mode)
    return _flag(False, dev)


def value_clip_engaged(grads, clip_value: float, reducer=None):
    """0/1 int32: would clipping at ``clip_value`` change any element?"""
    t = float(clip_value)
    hits = [torch.any(torch.abs(g) > t) for g in _leaves(grads)]
    return _any(_flag(torch.stack(hits).any() if hits else False,
                      _device(grads)), reducer)


def l2_clip_engaged(norm, clip_l2: float):
    """0/1 int32: does the global L2 norm exceed the clip threshold?"""
    return _flag(norm > float(clip_l2), norm.device)


def clip_with_events(mode: Optional[str], threshold: float,
                     clip_value: Optional[float], clip_l2: Optional[float],
                     grads, reducer=None):
    """Normalize, then clip by value, then clip the global L2 norm;
    returns ``(grads, clip_events)``."""
    events = clip_engaged(mode, threshold, grads, reducer)
    grads = apply(mode, threshold, grads, reducer)
    if clip_value:
        events = torch.maximum(events, value_clip_engaged(grads, clip_value,
                                                          reducer))
        grads = _tmap(lambda g: torch.clamp(g, -clip_value, clip_value),
                      grads)
    if clip_l2:
        norm = torch.sqrt(sum(_leaves(_ssq(grads, reducer))))
        events = torch.maximum(events, l2_clip_engaged(norm, clip_l2))
        scale = torch.clamp(clip_l2 / (norm + 1e-12), max=1.0)
        grads = _tmap(lambda g: g * scale, grads)
    return grads, events


def apply(mode: Optional[str], threshold: float,
          grads: Dict[str, Any], reducer=None) -> Dict[str, Any]:
    """Normalize the gradient tree ``{layer_key: {param: tensor}}``."""
    if mode is None:
        return grads
    if mode == "RenormalizeL2PerLayer":
        sq, out = _ssq(grads, reducer), {}
        for k, v in grads.items():
            n = torch.clamp(_tree_l2(sq[k]), min=_EPS)
            out[k] = _tmap(lambda g, n=n: g / n, v)
        return out
    if mode == "RenormalizeL2PerParamType":
        return _tmap(lambda g, s: g / torch.clamp(torch.sqrt(s), min=_EPS),
                     grads, _ssq(grads, reducer))
    if mode == "ClipElementWiseAbsoluteValue":
        t = float(threshold)
        return _tmap(lambda g: torch.clamp(g, -t, t), grads)
    if mode == "ClipL2PerLayer":
        t = float(threshold)
        sq, out = _ssq(grads, reducer), {}
        for k, v in grads.items():
            n = _tree_l2(sq[k])
            scale = torch.where(n > t, t / torch.clamp(n, min=_EPS),
                                torch.ones_like(n))
            out[k] = _tmap(lambda g, s=scale: g * s, v)
        return out
    if mode == "ClipL2PerParamType":
        t = float(threshold)

        def clip_one(g, s):
            n = torch.sqrt(s)
            return g * torch.where(n > t, t / torch.clamp(n, min=_EPS),
                                   torch.ones_like(n))
        return _tmap(clip_one, grads, _ssq(grads, reducer))
    validate(mode)
    return grads
