"""Fused epilogues: batch-norm / bias + activation on kernels K1 and K2.

Port of the affine half of ``deeplearning4j_tpu/ops/fused_epilogues.py``:
:func:`bn_act` folds the BN statistics into a per-channel f32 scale and
shift and runs ``y = act(x*scale + shift)``; :func:`bias_act` runs the same
with no scale. Both go through :class:`AffineAct`, a
``torch.autograd.Function`` (the JAX module's custom VJP ``_affine_act``):
K1 forward, K2 backward, on every device. It saves ``(x2, scale, shift)``
only; K2 recomputes ``z``. On the CPU its two bodies are the kernels'
plain versions, so the CPU tests run the wiring the card runs. The
``[C]``-sized prologue (rsqrt, gamma, mean) stays outside the Function, so
autograd carries K2's ``dscale``/``dshift`` into gamma, beta, mean and var.
The activation formulas (``_act_fwd``/``_act_grad`` of the JAX module)
live beside the kernels, in ``kernels.affine_act``.

Dispatch (every call counts exactly one decision in :func:`counters`; the
counters are this package's own):

- ``fused``: a CUDA tensor with a foldable activation — K1 launches with
  the activation folded in (K2 in the backward).
- ``fallback_platform``: a CPU tensor — the kernels' plain versions, the
  same f32 arithmetic.
- ``fallback_act``: an activation K1 does not implement (see
  :func:`foldable_act`) — the Function computes the affine with identity,
  then the catalog activation runs (differentiated by autograd).

``dy``'s layout: K2 reads ``dy`` as ``[rows, C]`` row-major memory. The
gradient autograd hands the Function comes through cuDNN's convolution
backward, the residual add and pooling, and need not be contiguous; the
backward then makes one contiguous copy and counts it in ``dy_copies``
(on every device, so the count is the same on the CPU and the card).

Divergence from the JAX dispatcher: the TPU kernel needed ``rows`` to tile
its row blocks and fell back to ``nnops.batch_norm`` otherwise
(``fallback_shape``); K1 and K2 mask the ragged tail themselves, so there
is no shape fallback. A CUDA tensor of a dtype or layout K1 does not take
raises instead of falling back.
"""

from __future__ import annotations

import collections

import torch

from ..kernels import affine_act as _k1
from . import activations as _activations

# canonical (lowercase, underscore-stripped) names K1 implements
_FOLDABLE = _k1.ACTS

_COUNTER_KEYS = ("fused", "fallback_platform", "fallback_act")
_counts = collections.Counter()

#: contiguous copies of a non-contiguous ``dy`` made by the backward since
#: the last :func:`reset_counters` (a plain integer)
dy_copies = 0


def _canon(act) -> str:
    return str(act).lower().replace("_", "")


def foldable_act(act, alpha=None) -> bool:
    """Can this activation ride the fused epilogue kernel?"""
    return alpha is None and _canon(act) in _FOLDABLE


def reference_act(act, alpha=None):
    """The catalog activation applied after the affine when the
    activation is not foldable."""
    act = _canon(act)
    if act == "geluexact":
        return lambda x: _activations.gelu(x, approximate=False)
    fn = _activations.get(act)
    if alpha is not None:
        return lambda x: fn(x, alpha)
    return fn


def counters() -> dict:
    """Dispatch-decision counts since the last reset (one per call)."""
    return {k: int(_counts[k]) for k in _COUNTER_KEYS}


def reset_counters() -> None:
    """Zero the decision counters and ``dy_copies``."""
    global dy_copies
    _counts.clear()
    dy_copies = 0


def _rows(x):
    """The ``[rows, C]`` row-major reading of a channels-last tensor.

    On the CPU any layout goes (the plain version broadcasts). On the card
    K1 reads raw memory, so ``x`` must be contiguous in its logical
    (channels-last) order: an NHWC view of NCHW-contiguous memory would be
    read as the wrong ``[rows, C]`` matrix, and copying it here would hide
    a layout fault upstream. That raises instead."""
    cols = x.shape[-1]
    if x.device.type == "cpu":
        return x.reshape(-1, cols)
    if not x.is_contiguous():
        raise ValueError(
            "fused epilogue: K1 reads channels-last memory as [rows, C]; got "
            f"shape {tuple(x.shape)} with strides {x.stride()}, which is not "
            "contiguous in that order")
    return x.view(-1, cols)


class AffineAct(torch.autograd.Function):
    """``act(x2*scale + shift)`` on ``[rows, C]``: K1 forward, K2 backward
    (their plain versions on the CPU). ``scale`` may be None."""

    @staticmethod
    def forward(ctx, x2, scale, shift, act):
        ctx.act = act
        ctx.save_for_backward(x2, scale, shift)
        return _k1.affine_act(x2, scale, shift, act)

    @staticmethod
    def backward(ctx, dy):
        global dy_copies
        x2, scale, shift = ctx.saved_tensors
        if not dy.is_contiguous():
            dy = dy.contiguous()
            dy_copies += 1
        dx, dscale, dshift = _k1.affine_act_bwd(x2, scale, shift, dy,
                                                ctx.act)
        return dx, dscale, dshift, None


def _affine(x, scale, shift, act, alpha, axis):
    act_c = _canon(act)
    fold = foldable_act(act, alpha)
    if not fold:
        _counts["fallback_act"] += 1
    elif x.device.type == "cuda":
        _counts["fused"] += 1
    else:
        _counts["fallback_platform"] += 1
    kact = act_c if fold else "identity"
    if x.ndim >= 2 and axis in (-1, x.ndim - 1):
        y = AffineAct.apply(_rows(x), scale, shift, kact).view(x.shape)
    elif x.device.type == "cpu":
        # channels not last (NCHW): the plain versions over a channels-last
        # copy, moved back
        xt = x.movedim(axis, -1)
        y = AffineAct.apply(xt.reshape(-1, xt.shape[-1]), scale, shift,
                            kact).view(xt.shape).movedim(-1, axis)
    else:
        raise ValueError(f"fused epilogue: K1 takes channels-last tensors; "
                         f"channel axis {axis} of shape {tuple(x.shape)}")
    if fold:
        return y
    return reference_act(act, alpha)(y)


def bn_act(x, gamma, beta, mean, var, eps=1e-5, axis=-1, act="identity",
           alpha=None):
    """Batch-norm normalize + activation epilogue over channels-last ``x``.
    The statistics fold into per-channel scale/shift in f32 (as the JAX
    package does; f64 for a float64 ``x``): ``scale = gamma * rsqrt(var +
    eps)``, ``shift = beta - mean * scale``."""
    f = _k1._math_dtype(x.dtype)
    inv = torch.rsqrt(var.to(f) + eps)
    scale = inv if gamma is None else inv * gamma.to(f)
    shift = -mean.to(f) * scale
    if beta is not None:
        shift = beta.to(f) + shift
    return _affine(x, scale.contiguous(), shift.contiguous(), act, alpha,
                   axis)


def bias_act(x, b=None, act="identity", axis=-1, alpha=None):
    """Bias + activation epilogue (the post-conv/post-matmul tail). ``b``
    is a ``[C]`` vector over ``axis``, or None."""
    if b is None and _canon(act) == "identity" and alpha is None:
        return x  # nothing to fuse; keeps the dispatch mix meaningful
    f = _k1._math_dtype(x.dtype)
    shift = torch.zeros(x.shape[axis], dtype=f, device=x.device) \
        if b is None else b.to(f).contiguous()
    return _affine(x, None, shift, act, alpha, axis)
