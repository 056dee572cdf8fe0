"""Fused epilogues: batch-norm / bias + activation on kernels K1 and K2,
LayerNorm + activation on kernels K6 and K7.

Port of ``deeplearning4j_tpu/ops/fused_epilogues.py``:

- :func:`bn_act` folds the BN statistics into a per-channel f32 scale and
  shift and runs ``y = act(x*scale + shift)``; :func:`bias_act` runs the
  same with no scale. Both go through :class:`AffineAct`, a
  ``torch.autograd.Function`` (the JAX module's custom VJP
  ``_affine_act``): K1 forward, K2 backward. It saves ``(x2, scale,
  shift)`` only; K2 recomputes ``z``. The ``[C]``-sized prologue (rsqrt,
  gamma, mean) stays outside the Function, so autograd carries K2's
  ``dscale``/``dshift`` into gamma, beta, mean and var.
- :func:`layer_norm_act` runs LayerNorm over the last axis, the affine
  and the activation through :class:`LayerNormAct` (the JAX module's
  ``_ln_act``): K6 forward, saving ``(x2, gamma, beta, mu, rstd)``, the
  reference's residuals; K7 backward, which gives ``dx`` in x's dtype and
  ``dgamma``/``dbeta`` cast to gamma's and beta's dtypes.
- The catalog ops ``epilogue.layer_norm_act`` and ``epilogue.bias_act``
  are what ``autodiff/fusion.py::fuse_epilogues`` splices into a SameDiff
  graph.

On the CPU the Functions' bodies are the kernels' plain versions, so the
CPU tests run the wiring the card runs. The activation formulas
(``_act_fwd``/``_act_grad`` of the JAX module) live beside the kernels,
in ``kernels.affine_act``.

Dispatch (every call counts exactly one decision in :func:`counters`; the
counters are this package's own):

- ``fused``: a CUDA tensor with a foldable activation — K1 (K6) launches
  with the activation folded in (K2, K7 in the backward).
- ``fallback_platform``: a CPU tensor — the kernels' plain versions, the
  same f32 arithmetic.
- ``fallback_act``: an activation the kernels do not implement (see
  :func:`foldable_act`) — the Function computes the affine (the
  normalization) with identity, then the catalog activation runs
  (differentiated by autograd).
- ``fallback_dtype``: an integer or bool CPU tensor — the JAX
  dispatcher's fallback formula (``x + b``, ``nnops.batch_norm`` or
  ``nnops.layer_norm``, then the catalog activation), which promotes as
  jnp does (``bias_act(int32 x, act="gelu_exact")`` is float32). An
  integer or bool CUDA tensor is cast to the float dtype that formula
  returns (read on meta tensors) and takes the kernels, counted
  ``fused``; where the formula stays integer (``bias_act(int32 x, int32
  b, act="relu")``) it raises, as no kernel computes in integers.

Channels-first ``x`` (``axis`` not last, NCHW): K1 and K2 read its
channels-last view, on the card as on the CPU. A tensor in
``torch.channels_last`` memory gives that view for free; any other takes
one contiguous copy, counted in ``nchw_copies``. cuDNN keeps a
convolution's output in its input's memory format, so after a network's
first copy the layers hand each other channels-last tensors.

``dy``'s layout: K2 and K7 read ``dy`` as ``[rows, C]`` row-major memory.
The gradient autograd hands a Function comes through cuDNN's convolution
backward, the residual add, pooling or a head split, and need not be
contiguous; the backward then makes one contiguous copy and counts it in
``dy_copies`` (on every device, so the count is the same on the CPU and
the card).

Divergences from the JAX dispatcher: the TPU kernels needed ``rows`` to
tile their row blocks and a VMEM budget, and fell back to
``nnops.batch_norm``/``nnops.layer_norm`` otherwise (``fallback_shape``,
``fallback_vmem``); K1, K2, K6 and K7 mask the ragged tail themselves, so
there is no shape or VMEM fallback. A CUDA tensor of a dtype, layout or
width the kernels do not take raises instead of falling back (K6 and K7
take up to ``kernels.layer_norm_act.MAX_COLS`` channels). There is no
``force``/``off`` mode: the tensor's device decides.

The fused master-cast updater's routing (:func:`route_updater`,
:func:`dispatch_updater`, the JAX module's :640-681) counts one decision
a train-step build, ``fused_updater``, ``fallback_updater_dtype`` or
``fallback_updater_penalty``, in :func:`updater_counters`: the JAX
package keeps them in the same counter as the per-call epilogue
decisions, the port apart, so :func:`counters` stays one decision a
call. With no ``off`` mode there is no ``fallback_updater_mode``; a
caller reaches the unfused step with ``fused_cast=False``.
"""

from __future__ import annotations

import collections

import torch

from ..kernels import affine_act as _k1
from ..kernels import layer_norm_act as _k6
from . import activations as _activations
from . import nnops as _nnops
from . import register

# canonical (lowercase, underscore-stripped) names K1 implements
_FOLDABLE = _k1.ACTS

_COUNTER_KEYS = ("fused", "fallback_platform", "fallback_act",
                 "fallback_dtype")
_counts = collections.Counter()
_UPDATER_KEYS = ("fused_updater", "fallback_updater_dtype",
                 "fallback_updater_penalty")
_updater_counts = collections.Counter()

#: contiguous copies of a non-contiguous ``dy`` made by the backward since
#: the last :func:`reset_counters` (a plain integer)
dy_copies = 0
#: channels-last copies of a channels-first ``x`` (NCHW not already in
#: ``torch.channels_last`` memory) made since the last reset (a plain
#: integer)
nchw_copies = 0


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


def updater_counters() -> dict:
    """Fused master-cast updater decisions since the last reset (one per
    train-step build)."""
    return {k: int(_updater_counts[k]) for k in _UPDATER_KEYS}


def reset_counters() -> None:
    """Zero the decision counters (the updater's too), ``dy_copies`` and
    ``nchw_copies``."""
    global dy_copies, nchw_copies
    _counts.clear()
    _updater_counts.clear()
    dy_copies = 0
    nchw_copies = 0


def _rows(x):
    """The ``[rows, C]`` row-major reading of a channels-last tensor.

    On the CPU any layout goes (the plain version broadcasts). On the card
    K1 and K6 read raw memory, so ``x`` must be contiguous in its logical
    (channels-last) order: an NHWC view of NCHW-contiguous memory would be
    read as the wrong ``[rows, C]`` matrix, and copying it here would hide
    a layout fault upstream. That raises instead."""
    cols = x.shape[-1]
    if x.device.type == "cpu":
        return x.reshape(-1, cols)
    if not x.is_contiguous():
        raise ValueError(
            "fused epilogue: the kernels read channels-last memory as [rows, "
            f"C]; got shape {tuple(x.shape)} with strides {x.stride()}, which "
            "is not contiguous in that order")
    return x.view(-1, cols)


def _decide(x, fold: bool) -> None:
    if not fold:
        _counts["fallback_act"] += 1
    elif x.device.type == "cuda":
        _counts["fused"] += 1
    else:
        _counts["fallback_platform"] += 1


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
    global nchw_copies
    act_c = _canon(act)
    fold = foldable_act(act, alpha)
    _decide(x, fold)
    kact = act_c if fold else "identity"
    if x.ndim >= 2 and axis in (-1, x.ndim - 1):
        y = AffineAct.apply(_rows(x), scale, shift, kact).view(x.shape)
    else:
        # channels not last (NCHW): K1 and K2 (or their plain versions)
        # read the channels-last view, moved back after. A tensor already
        # in channels-last memory gives that view for free; any other takes
        # one contiguous copy
        xt = x.movedim(axis, -1)
        if not xt.is_contiguous():
            xt = xt.contiguous()
            nchw_copies += 1
        y = AffineAct.apply(xt.view(-1, xt.shape[-1]), scale, shift,
                            kact).view(xt.shape).movedim(-1, axis)
    if fold:
        return y
    return reference_act(act, alpha)(y)


def _promote(x, plain, *params):
    """``(x, None)`` for a float ``x``. An integer or bool ``x`` (the
    kernels take floats only) promotes as the JAX dispatcher's fallback
    formula ``plain(x, *params)`` does: on the CPU that formula runs
    (``fallback_dtype``) and ``(None, y)`` returns its result; on the card
    its result dtype is read on meta tensors, and ``(x cast to it, None)``
    sends the cast to the kernels. An integer result raises there."""
    if x.is_floating_point():
        return x, None
    if x.device.type == "cpu":
        _counts["fallback_dtype"] += 1
        return None, plain(x, *params)
    f = plain(*(None if t is None else torch.empty(
        t.shape, dtype=t.dtype, device="meta") for t in (x, *params))).dtype
    if not f.is_floating_point:
        raise ValueError(
            f"fused epilogue: a {x.dtype} x gives a {f} result here, and the "
            "kernels compute in float32, bfloat16 or float16 only")
    return x.to(f), None


def _then_act(y, act, alpha=None):
    return y if _canon(act) == "identity" and alpha is None \
        else reference_act(act, alpha)(y)


def bn_act(x, gamma, beta, mean, var, eps=1e-5, axis=-1, act="identity",
           alpha=None):
    """Batch-norm normalize + activation epilogue over channels-last ``x``.
    The statistics fold into per-channel scale/shift in f32 (as the JAX
    package does; f64 for a float64 ``x``): ``scale = gamma * rsqrt(var +
    eps)``, ``shift = beta - mean * scale``."""
    x, y = _promote(x, lambda x, *p: _then_act(
        _nnops.batch_norm(x, *p, eps, axis), act, alpha),
        gamma, beta, mean, var)
    if y is not None:
        return y
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

    def plain(x, b):
        if b is not None:
            shape = [1] * x.ndim
            shape[axis] = b.shape[0]
            x = x + b.reshape(shape)
        return _then_act(x, act, alpha)
    x, y = _promote(x, plain, b)
    if y is not None:
        return y
    f = _k1._math_dtype(x.dtype)
    shift = torch.zeros(x.shape[axis], dtype=f, device=x.device) \
        if b is None else b.to(f).contiguous()
    return _affine(x, None, shift, act, alpha, axis)


class LayerNormAct(torch.autograd.Function):
    """LayerNorm over the rows of ``[rows, C]`` + affine + ``act``: K6
    forward, K7 backward (their plain versions on the CPU). ``gamma`` and
    ``beta`` are ``[C]`` vectors of any float dtype; the kernels take them
    in f32 (f64 for a float64 ``x2``)."""

    @staticmethod
    def forward(ctx, x2, gamma, beta, eps, act):
        f = _k1._math_dtype(x2.dtype)
        g, b = gamma.to(f).contiguous(), beta.to(f).contiguous()
        y, mu, rstd = _k6.layer_norm_act(x2, g, b, eps, act)
        ctx.act = act
        ctx.dtypes = (gamma.dtype, beta.dtype)
        ctx.save_for_backward(x2, g, b, mu, rstd)
        return y

    @staticmethod
    def backward(ctx, dy):
        global dy_copies
        x2, g, b, mu, rstd = ctx.saved_tensors
        if not dy.is_contiguous():
            dy = dy.contiguous()
            dy_copies += 1
        dx, dg, db = _k6.layer_norm_act_bwd(x2, g, b, mu, rstd, dy, ctx.act)
        return dx, dg.to(ctx.dtypes[0]), db.to(ctx.dtypes[1]), None, None


def layer_norm_act(x, gamma, beta, eps=1e-5, act="identity"):
    """LayerNorm over the last axis + affine + activation epilogue (the
    transformer blocks' tail; ``fuse_epilogues`` splices graph-recorded
    decompositions into it): two-pass mean and variance per row,
    ``rstd = rsqrt(var + eps)``, ``act((x - mu)*rstd*gamma + beta)``."""
    x, y = _promote(x, lambda x, g, b: _then_act(
        _nnops.layer_norm(x, g, b, eps, axis=-1), act), gamma, beta)
    if y is not None:
        return y
    fold = foldable_act(act)
    _decide(x, fold)
    x2 = _rows(x)
    y = LayerNormAct.apply(x2, gamma.reshape(-1), beta.reshape(-1),
                           float(eps), _canon(act) if fold else "identity")
    y = y.view(x.shape)
    return y if fold else reference_act(act)(y)


# catalog ops the SameDiff rewrite pass splices in (serde round-trips the
# names and attrs; execution resolves through the registry like every op)

@register("epilogue.layer_norm_act", category="normalization")
def layer_norm_act_op(x, gamma, beta, eps=1e-5, act="identity"):
    return layer_norm_act(x, gamma, beta, eps=eps, act=act)


@register("epilogue.bias_act", category="activation")
def bias_act_op(x, b=None, act="identity"):
    return bias_act(x, b, act=act)


# --------------------------------------------------------------------------
# fused master-cast + updater routing
# --------------------------------------------------------------------------

def route_updater(policy, *, has_penalty: bool = False):
    """None: fold the f32 -> 16-bit master cast into the updater's write
    (``nn/updaters.py`` ``apply_leaf_cast``); otherwise the fallback
    counter key. ``has_penalty``: a step whose loss reads the f32 masters
    for l1/l2 keeps the unfused split."""
    from .. import dtypes as _dt
    if not _dt.is_mixed(policy):
        return "fallback_updater_dtype"
    if has_penalty:
        return "fallback_updater_penalty"
    return None


def dispatch_updater(policy, *, has_penalty: bool = False):
    """Counted :func:`route_updater`: call once a train-step build."""
    reason = route_updater(policy, has_penalty=has_penalty)
    _updater_counts[reason or "fused_updater"] += 1
    return reason
