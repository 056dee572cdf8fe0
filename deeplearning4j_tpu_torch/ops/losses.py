"""Loss functions (the part of the catalog the training slice uses).

Port of ``deeplearning4j_tpu/ops/losses.py``. Contract (DL4J's
``ILossFunction.computeScore``): ``fn(labels, predictions, mask=None,
weights=None)`` -> a scalar, the mean over unmasked examples (or
timesteps) of the per-example loss summed over the output axis.
``predictions`` are post-activation outputs; the output layers call
:func:`softmax_cross_entropy_with_logits` and
:func:`sigmoid_binary_xent_with_logits` on logits instead. Those two are
also SameDiff graph ops, ``loss.softmax_ce_logits`` and
``loss.sigmoid_bce_logits`` (the JAX package's catalog names). Gradients
come from autograd.

Ported so far: ``mcxent``, ``sparse_mcxent``, ``binary_xent``, ``mse``
and the two logits forms. The rest of the JAX catalog (l1, l2, mae,
hinge, squared_hinge, kld, poisson, cosine_proximity, multi_label,
wasserstein, fmeasure, mixture_density, ctc) comes with a later slice
(``ROADMAP.md``); :func:`get` names it when asked.
"""

from __future__ import annotations

import torch

from . import register

LOSSES = {}
EPS = 1e-7

#: losses of the JAX catalog not ported yet
_LATER = ("l1", "l2", "mae", "hinge", "squared_hinge", "kld", "poisson",
          "cosine_proximity", "multi_label", "wasserstein", "fmeasure",
          "mixture_density", "ctc")


def _loss(name):
    def deco(fn):
        LOSSES[name] = fn
        return fn
    return deco


def _per_example(value, mask):
    """Mean over (unmasked) examples of ``value`` ([batch] or [batch,
    time]). DL4J averages over the count of unmasked entries, not the
    batch size. A masked entry contributes 0 even when its loss is not
    finite (``where``, not a product: NaN * 0 is NaN)."""
    if mask is not None:
        mask = torch.as_tensor(mask, dtype=value.dtype,
                               device=value.device).expand(value.shape)
        masked = torch.where(mask > 0, value * mask,
                             torch.zeros((), dtype=value.dtype,
                                         device=value.device))
        return torch.sum(masked) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(value)


def combine_masks(a, b):
    """Intersect two 0/1 loss masks of possibly different ranks (e.g. a
    per-example [B] mask with a per-timestep [B,T] one): leading dims
    align, trailing dims broadcast. None is the identity."""
    if a is None:
        return b
    if b is None:
        return a
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    nd = max(a.ndim, b.ndim)
    a = a.reshape(tuple(a.shape) + (1,) * (nd - a.ndim))
    b = b.reshape(tuple(b.shape) + (1,) * (nd - b.ndim))
    return a * b


def _sum_outputs(elem, weights):
    """Sum the per-element loss over the output axis, with optional
    per-output weights."""
    if weights is not None:
        elem = elem * torch.as_tensor(weights, dtype=elem.dtype,
                                      device=elem.device)
    return torch.sum(elem, dim=-1)


@_loss("mcxent")
def mcxent(labels, predictions, mask=None, weights=None):
    """Multi-class cross entropy on probabilities (LossMCXENT)."""
    p = torch.clamp(predictions, EPS, 1.0 - EPS)
    return _per_example(_sum_outputs(-labels * torch.log(p), weights), mask)


@_loss("sparse_mcxent")
def sparse_mcxent(labels, predictions, mask=None, weights=None):
    """Sparse (integer-label) multi-class cross entropy
    (LossSparseMCXENT); ``weights`` are per-class."""
    logp = torch.log(torch.clamp(predictions, EPS, 1.0 - EPS))
    lab = torch.as_tensor(labels, device=logp.device).long()
    if lab.ndim == logp.ndim:
        lab = lab[..., 0]
    elem = -torch.gather(logp, -1, lab[..., None])[..., 0]
    if weights is not None:
        elem = elem * torch.as_tensor(weights, dtype=elem.dtype,
                                      device=elem.device)[lab]
    return _per_example(elem, mask)


def softmax_cross_entropy_with_logits(labels, logits, mask=None,
                                      weights=None):
    """Softmax + cross entropy on logits, the Output layer's stable path.
    Integer logits go in as float32, as ``jax.nn.log_softmax`` promotes
    them (bool logits raise, as there)."""
    if logits.dtype == torch.bool:
        raise TypeError("softmax_ce_logits: bool logits (jax.nn.log_softmax "
                        "refuses them too)")
    if not logits.is_floating_point():
        logits = logits.float()
    logp = torch.log_softmax(logits, dim=-1)
    return _per_example(_sum_outputs(-labels * logp, weights), mask)


register("loss.softmax_ce_logits", category="loss")(
    softmax_cross_entropy_with_logits)
LOSSES["softmax_ce_logits"] = softmax_cross_entropy_with_logits


@_loss("binary_xent")
def binary_xent(labels, predictions, mask=None, weights=None):
    """Binary cross entropy on probabilities (LossBinaryXENT)."""
    p = torch.clamp(predictions, EPS, 1.0 - EPS)
    elem = -(labels * torch.log(p) + (1.0 - labels) * torch.log1p(-p))
    return _per_example(_sum_outputs(elem, weights), mask)


def sigmoid_binary_xent_with_logits(labels, logits, mask=None, weights=None):
    """Sigmoid + binary cross entropy on logits."""
    elem = torch.clamp(logits, min=0) - logits * labels + torch.log1p(
        torch.exp(-torch.abs(logits)))
    return _per_example(_sum_outputs(elem, weights), mask)


register("loss.sigmoid_bce_logits", category="loss")(
    sigmoid_binary_xent_with_logits)
LOSSES["sigmoid_bce_logits"] = sigmoid_binary_xent_with_logits


@_loss("mse")
def mse(labels, predictions, mask=None, weights=None):
    """DL4J LossMSE = LossL2 / nOut (mean, not sum, over the output
    axis)."""
    elem = torch.square(predictions - labels)
    return _per_example(_sum_outputs(elem, weights) / elem.shape[-1], mask)


def get(name_or_fn):
    """A loss by name (or a callable, returned as it is)."""
    if callable(name_or_fn):
        return name_or_fn
    key = str(name_or_fn).lower()
    if key in _LATER:
        raise NotImplementedError(
            f"loss {key!r} is not ported yet; it comes with a later slice "
            "of the port, the training-breadth slice (ROADMAP.md Queue 1 "
            "item 3)")
    if key not in LOSSES:
        raise ValueError(f"Unknown loss {name_or_fn!r}; known: "
                         f"{sorted(LOSSES)}")
    return LOSSES[key]


def name_of(fn) -> str:
    for k, v in LOSSES.items():
        if v is fn:
            return k
    raise ValueError(f"Unregistered loss {fn}")
