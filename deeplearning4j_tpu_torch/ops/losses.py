"""Loss functions and the ``loss.*`` catalog ops.

Port of ``deeplearning4j_tpu/ops/losses.py``. Contract (DL4J's
``ILossFunction.computeScore``): ``fn(labels, predictions, mask=None,
weights=None)`` -> a scalar, the mean over unmasked examples (or
timesteps) of the per-example loss summed over the output axis.
``predictions`` are post-activation outputs; the output layers call
:func:`softmax_cross_entropy_with_logits` and
:func:`sigmoid_binary_xent_with_logits` on logits instead. Gradients
come from autograd.

Every loss is also a catalog op, ``loss.<name>``, as the JAX package's
``_loss`` decorator registers it; so are the two logits forms
(``loss.softmax_ce_logits``, ``loss.sigmoid_bce_logits``). One name has
two functions there: ``LOSSES["ctc"]`` is :func:`ctc` (labels padded
with negative ids, an input mask; what the loss layers call), while the
catalog's ``loss.ctc`` is :func:`ctc_loss`, the JAX package's
``ops/random.py`` op in optax's convention (logits, labels and 1.0-where-
padded paddings), which replaces the first in its registry once every
ops module is imported. Both run ``F.ctc_loss``.

In a ``ParallelWrapper`` step each rank's mean divides by the GLOBAL
count (:func:`_per_example`). Divergence: :func:`fmeasure`, a batch-level
loss, is evaluated on each rank's rows, and the ranks' values add up
(the JAX step computes one F-beta over the sharded batch).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import register

LOSSES = {}
EPS = 1e-7



def _loss(name):
    def deco(fn):
        LOSSES[name] = fn
        register(f"loss.{name}", category="loss")(fn)
        return fn
    return deco


def _per_example(value, mask):
    """Mean over (unmasked) examples of ``value`` ([batch] or [batch,
    time]). DL4J averages over the count of unmasked entries, not the
    batch size. A masked entry contributes 0 even when its loss is not
    finite (``where``, not a product: NaN * 0 is NaN).

    In a data-parallel step (``parallel.collectives.data_parallel()``) a
    rank holds its rows of the global batch: the loss is its masked sum
    over the GLOBAL count (summed over the data group, clamped after the
    sum), so the ranks' losses and gradients add up to the global ones."""
    from ..parallel import collectives as _coll
    dp = _coll.data_parallel()
    if mask is not None:
        mask = torch.as_tensor(mask, dtype=value.dtype,
                               device=value.device).expand(value.shape)
        masked = torch.where(mask > 0, value * mask,
                             torch.zeros((), dtype=value.dtype,
                                         device=value.device))
        count = torch.sum(mask)
        if dp is not None:
            count = _coll.global_sum(count, dp.data).to(count.dtype)
        return torch.sum(masked) / torch.clamp(count, min=1.0)
    if dp is not None:
        return torch.sum(value) / (value.numel() * dp.data_size)
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


@_loss("l2")
def l2(labels, predictions, mask=None, weights=None):
    """DL4J LossL2: the SUM of squared errors over the output axis."""
    elem = torch.square(predictions - labels)
    return _per_example(_sum_outputs(elem, weights), mask)


@_loss("mae")
def mae(labels, predictions, mask=None, weights=None):
    """DL4J LossMAE = LossL1 / nOut (mean, not sum, over the output
    axis)."""
    elem = torch.abs(predictions - labels)
    return _per_example(_sum_outputs(elem, weights) / elem.shape[-1], mask)


@_loss("l1")
def l1(labels, predictions, mask=None, weights=None):
    """DL4J LossL1: the SUM of absolute errors over the output axis."""
    elem = torch.abs(predictions - labels)
    return _per_example(_sum_outputs(elem, weights), mask)


@_loss("hinge")
def hinge(labels, predictions, mask=None, weights=None):
    """Hinge loss; labels in {-1, +1}."""
    elem = torch.clamp(1.0 - labels * predictions, min=0.0)
    return _per_example(_sum_outputs(elem, weights), mask)


@_loss("squared_hinge")
def squared_hinge(labels, predictions, mask=None, weights=None):
    elem = torch.square(torch.clamp(1.0 - labels * predictions, min=0.0))
    return _per_example(_sum_outputs(elem, weights), mask)


@_loss("kld")
def kld(labels, predictions, mask=None, weights=None):
    """Kullback-Leibler divergence of the predictions from the labels."""
    p = torch.clamp(predictions, EPS, 1.0)
    q = torch.clamp(labels, EPS, 1.0)
    elem = labels * (torch.log(q) - torch.log(p))
    return _per_example(_sum_outputs(elem, weights), mask)


@_loss("poisson")
def poisson(labels, predictions, mask=None, weights=None):
    p = torch.clamp(predictions, min=EPS)
    elem = p - labels * torch.log(p)
    return _per_example(_sum_outputs(elem, weights), mask)


def _unit(v):
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True),
                           min=EPS)


@_loss("cosine_proximity")
def cosine_proximity(labels, predictions, mask=None, weights=None):
    """Minus the cosine similarity of each example's label and prediction
    vectors."""
    if weights is not None:
        raise ValueError("cosine_proximity has no per-output weights "
                         "(loss is a whole-vector similarity)")
    elem = -torch.sum(_unit(labels) * _unit(predictions), dim=-1)
    return _per_example(elem, mask)


@_loss("multi_label")
def multi_label(labels, predictions, mask=None, weights=None):
    """LossMultiLabel: the pairwise ranking loss, ``exp(p_neg - p_pos)``
    summed over every (positive, negative) pair of an example and divided
    by the pair count."""
    if weights is not None:
        raise ValueError("multi_label is a pairwise ranking loss; per-output "
                         "weights are not supported")
    pos = labels > 0.5
    diffs = torch.exp(predictions[..., None, :] - predictions[..., :, None])
    pairs = pos[..., :, None] & ~pos[..., None, :]      # positive i, negative j
    zero = torch.zeros((), dtype=diffs.dtype, device=diffs.device)
    npos = torch.clamp(pos.sum(-1), min=1)
    nneg = torch.clamp((~pos).sum(-1), min=1)
    elem = torch.where(pairs, diffs, zero).sum((-2, -1)) / (npos * nneg)
    return _per_example(elem, mask)


@_loss("wasserstein")
def wasserstein(labels, predictions, mask=None, weights=None):
    """LossWasserstein, the critic form: labels times predictions."""
    return _per_example(_sum_outputs(labels * predictions, weights), mask)


@_loss("fmeasure")
def fmeasure(labels, predictions, mask=None, weights=None, beta=1.0):
    """LossFMeasure: 1 - the soft F_beta of binary predictions, over the
    whole (unmasked) batch at once; a mask weights the counts."""
    if weights is not None:
        raise ValueError("fmeasure is a single-column batch-level loss; "
                         "per-output weights do not apply")
    y = labels[..., -1] if labels.shape[-1] > 1 else labels[..., 0]
    p = predictions[..., -1] if predictions.shape[-1] > 1 \
        else predictions[..., 0]
    if mask is not None:
        m = torch.as_tensor(mask, dtype=y.dtype,
                            device=y.device).expand(y.shape)
        y, p = y * m, p * m
    tp = torch.sum(y * p)
    fp = torch.sum((1.0 - y) * p)
    fn = torch.sum(y * (1.0 - p))
    b2 = beta * beta
    f = (1.0 + b2) * tp / torch.clamp((1.0 + b2) * tp + b2 * fn + fp,
                                      min=EPS)
    return 1.0 - f


@_loss("mixture_density")
def mixture_density(labels, predictions, mask=None, weights=None,
                    num_mixtures=None):
    """LossMixtureDensity: the negative log-likelihood of an isotropic
    Gaussian mixture. The output is ``[alpha (K) | log sigma (K) | mu
    (K*L)]`` for labels ``[.., L]`` (K from the widths when not given);
    sigma is ``exp`` of its block plus EPS."""
    L = labels.shape[-1]
    width = predictions.shape[-1]
    K = num_mixtures or width // (2 + L)
    if K * (2 + L) != width:
        raise ValueError(f"output width {width} != K*(2+L) for labels "
                         f"width {L}")
    alpha = predictions[..., :K]
    sigma = torch.exp(predictions[..., K:2 * K]) + EPS
    mu = predictions[..., 2 * K:].reshape(tuple(predictions.shape[:-1])
                                          + (K, L))
    log_pi = torch.log_softmax(alpha, dim=-1)
    d2 = torch.sum((labels[..., None, :] - mu) ** 2, dim=-1)    # [.., K]
    log_n = (-0.5 * d2 / (sigma ** 2) - L * torch.log(sigma)
             - 0.5 * L * math.log(2.0 * math.pi))
    nll = -torch.logsumexp(log_pi + log_n, dim=-1)
    return _per_example(nll, mask)


def _ctc_nll(logits, labels, input_len, label_len, blank):
    """Per-sequence CTC negative log-likelihood of ``logits`` ``[B, T,
    C]`` (log_softmax applied here) against the first ``label_len`` ids
    of each row of ``labels``, over the first ``input_len`` steps."""
    lp = torch.log_softmax(logits, dim=-1)
    return F.ctc_loss(lp.transpose(0, 1), labels.long().clamp(min=0),
                      input_len.long(), label_len.long(), blank=blank,
                      reduction="none")


@_loss("ctc")
def ctc(labels, predictions, mask=None, weights=None, blank=0):
    """Connectionist Temporal Classification negative log-likelihood.

    ``predictions``: ``[B, T, C]`` LOGITS; ``labels``: ``[B, S]`` class
    ids padded with negative values (a row's length is its count of
    non-negative ids); ``mask``: an optional ``[B, T]`` input mask (input
    lengths are its row sums). The batch MEAN of the per-sequence NLL,
    over the rows with at least one unmasked step when a mask is given:
    a fully masked (pad) row contributes nothing."""
    B, T = predictions.shape[0], predictions.shape[1]
    label_len = (labels >= 0).sum(1)
    if mask is None:
        input_len = torch.full((B,), T, dtype=torch.long,
                               device=predictions.device)
    else:
        input_len = (torch.as_tensor(mask, device=predictions.device)
                     > 0).sum(1)
    # a pad row runs as one step and no labels (a finite NLL), then is
    # masked out of the mean
    pad = input_len == 0
    nll = _ctc_nll(predictions, labels, input_len.masked_fill(pad, 1),
                   label_len.masked_fill(pad, 0), blank)
    if weights is not None:
        nll = nll * torch.as_tensor(weights, dtype=nll.dtype,
                                    device=nll.device)
    return _per_example(nll, (input_len > 0).to(nll.dtype)
                        if mask is not None else None)


@register("loss.ctc", category="loss")
def ctc_loss(log_probs, labels, logit_paddings=None, label_paddings=None,
             blank_id=0):
    """The catalog's ``loss.ctc`` (the JAX package's ``ops/random.py``
    op, optax's convention): ``log_probs`` ``[B, T, C]`` logits, ``labels``
    ``[B, S]`` ids, paddings 1.0 where padded (trailing); the batch mean of
    the per-sequence NLL."""
    B, T = log_probs.shape[0], log_probs.shape[1]
    dev = log_probs.device
    input_len = torch.full((B,), T, dtype=torch.long, device=dev) \
        if logit_paddings is None else \
        T - torch.as_tensor(logit_paddings, device=dev).sum(1).long()
    label_len = torch.full((B,), labels.shape[1], dtype=torch.long,
                           device=dev) if label_paddings is None else \
        labels.shape[1] - torch.as_tensor(label_paddings,
                                          device=dev).sum(1).long()
    return torch.mean(_ctc_nll(log_probs, labels, input_len, label_len,
                               blank_id))


def get(name_or_fn):
    """A loss by name (or a callable, returned as it is)."""
    if callable(name_or_fn):
        return name_or_fn
    key = str(name_or_fn).lower()
    if key not in LOSSES:
        raise ValueError(f"Unknown loss {name_or_fn!r}; known: "
                         f"{sorted(LOSSES)}")
    return LOSSES[key]


def name_of(fn) -> str:
    for k, v in LOSSES.items():
        if v is fn:
            return k
    raise ValueError(f"Unregistered loss {fn}")
