"""Every loss of the port's catalog against the JAX package's, on the CPU:
each ``LOSSES`` entry and each ``loss.*`` catalog op, the value and the
gradient to the predictions, with and without a mask and per-output
weights (where the loss takes them).

The catalog sets are equal (19 names). ``loss.ctc`` has two functions in
both packages: ``LOSSES["ctc"]`` (negative-padded labels, an input mask)
is held against the JAX ``ops/losses.py`` ``ctc``, and the catalog op
(optax's convention) against the JAX ``ops/random.py`` op.

Tolerance: rtol 1e-5, atol 1e-6 (``tests/test_torch_losses.py``: the same
float32 arithmetic, another summation order), except the CTC gradients:
rtol 1e-4, atol 1e-6, the JAX package's own tolerance for its CTC
gradient against ``F.ctc_loss`` (``tests/test_ctc.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import ops as jops
from deeplearning4j_tpu.ops import losses as jlosses
from deeplearning4j_tpu_torch import ops
from deeplearning4j_tpu_torch.ops import losses

B, N = 6, 5


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    """The suite runs in parallel workers: keep this module's torch CPU
    work to two threads, and restore the setting after it."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        yield
    finally:
        torch.set_num_threads(old)


def _softmax(a):
    e = np.exp(a - a.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


def _inputs(name, seed=0):
    """(labels, predictions) for one loss, shaped as its callers feed it."""
    rng = np.random.default_rng(seed)
    raw = (rng.standard_normal((B, N)) * 1.5).astype(np.float32)
    binary = (rng.random((B, N)) > 0.5).astype(np.float32)
    onehot = np.eye(N, dtype=np.float32)[rng.integers(0, N, B)]
    if name in ("mcxent", "kld"):
        labels = onehot if name == "mcxent" else _softmax(
            rng.standard_normal((B, N)).astype(np.float32))
        return labels, _softmax(raw)
    if name == "sparse_mcxent":
        return rng.integers(0, N, B).astype(np.int32), _softmax(raw)
    if name in ("binary_xent", "fmeasure"):
        preds = (1 / (1 + np.exp(-raw))).astype(np.float32)
        if name == "fmeasure":
            return binary[:, :2], preds[:, :2]
        return binary, preds
    if name in ("hinge", "squared_hinge"):
        return binary * 2 - 1, raw
    if name == "poisson":
        return rng.integers(0, 4, (B, N)).astype(np.float32), np.exp(raw)
    if name == "cosine_proximity":
        return rng.standard_normal((B, N)).astype(np.float32), raw
    if name == "mixture_density":     # K = 2 mixtures of L = 3 dimensions
        return (rng.standard_normal((B, 3)).astype(np.float32),
                (rng.standard_normal((B, 10)) * 0.7).astype(np.float32))
    return binary, raw


#: the losses that refuse per-output weights
NO_WEIGHTS = {"cosine_proximity", "multi_label", "fmeasure"}
MASK = np.array([1, 1, 0, 1, 0, 1], np.float32)


def _close(got, want, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=atol)


def _value_and_grad(jfn, pfn, args, preds_at, kwargs_j=None, kwargs_p=None):
    """Both packages' value and gradient to ``args[preds_at]``."""
    jargs = [None if a is None else jnp.asarray(a) for a in args]

    def jloss(p):
        a = list(jargs)
        a[preds_at] = p
        return jfn(*a, **(kwargs_j or {}))

    jv, jg = jax.value_and_grad(jloss)(jargs[preds_at])
    targs = [None if a is None else torch.from_numpy(np.array(a))
             for a in args]
    targs[preds_at].requires_grad_(True)
    pv = pfn(*targs, **(kwargs_p or {}))
    (pg,) = torch.autograd.grad(pv, targs[preds_at])
    return (pv.detach().numpy(), np.asarray(jv)), (pg.numpy(), np.asarray(jg))


PLAIN = sorted(set(jlosses.LOSSES) - {"ctc"})


@pytest.mark.parametrize("name,masked,weighted", [
    (n, m, w) for n in PLAIN for m in (False, True) for w in (False, True)
    if not (w and n in NO_WEIGHTS)])
def test_every_loss_matches_jax(name, masked, weighted):
    labels, preds = _inputs(name, seed=len(name))
    weights = (np.random.default_rng(7).random(N) + 0.5).astype(np.float32)
    args = [labels, preds, MASK if masked else None,
            weights if weighted else None]
    (pv, jv), (pg, jg) = _value_and_grad(jlosses.LOSSES[name],
                                         losses.LOSSES[name], args, 1)
    _close(pv, jv)
    _close(pg, jg)


@pytest.mark.parametrize("name", sorted(NO_WEIGHTS))
def test_losses_without_weights_refuse_them_like_jax(name):
    labels, preds = _inputs(name)
    w = np.ones(preds.shape[-1], np.float32)
    with pytest.raises(ValueError):
        jlosses.LOSSES[name](jnp.asarray(labels), jnp.asarray(preds),
                             None, jnp.asarray(w))
    with pytest.raises(ValueError):
        losses.LOSSES[name](torch.from_numpy(labels),
                            torch.from_numpy(preds), None,
                            torch.from_numpy(w))


def test_the_catalogs_are_equal():
    names = {n for n in ops.all_ops() if n.startswith("loss.")}
    jnames = {n for n in jops.all_ops() if n.startswith("loss.")}
    assert names == jnames
    assert len(names) == 19
    assert set(losses.LOSSES) == set(jlosses.LOSSES)
    for n in names - {"loss.ctc"}:
        assert ops.lookup(n) is losses.LOSSES[n[len("loss."):]]
    assert ops.lookup("loss.ctc") is losses.ctc_loss
    assert losses.LOSSES["ctc"] is losses.ctc
    assert ops.get("loss.l1").category == "loss"


@pytest.mark.parametrize("name", PLAIN)
def test_catalog_op_matches_jax(name):
    """The registered op (what a SameDiff graph records) against the JAX
    registry's, positional as a graph calls it."""
    labels, preds = _inputs(name, seed=3)
    (pv, jv), (pg, jg) = _value_and_grad(
        jops.lookup(f"loss.{name}"), ops.lookup(f"loss.{name}"),
        [labels, preds], 1)
    _close(pv, jv)
    _close(pg, jg)


def test_fmeasure_beta_and_single_column_match_jax():
    labels, preds = _inputs("fmeasure", seed=4)
    for lab, pr in ((labels, preds), (labels[:, :1], preds[:, :1])):
        (pv, jv), (pg, jg) = _value_and_grad(
            jlosses.fmeasure, losses.fmeasure, [lab, pr, MASK], 1,
            {"beta": 2.0}, {"beta": 2.0})
        _close(pv, jv)
        _close(pg, jg)


def test_mixture_density_with_given_mixture_count_matches_jax():
    labels, preds = _inputs("mixture_density", seed=5)
    (pv, jv), (pg, jg) = _value_and_grad(
        jlosses.mixture_density, losses.mixture_density,
        [labels, preds, MASK], 1, {"num_mixtures": 2}, {"num_mixtures": 2})
    _close(pv, jv)
    _close(pg, jg)
    with pytest.raises(ValueError, match="K\\*\\(2\\+L\\)"):
        losses.mixture_density(torch.zeros(2, 3), torch.zeros(2, 11))


# ------------------------------------------------------------------ CTC

T, C, S = 12, 6, 4


def _ctc_inputs(seed):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((B, T, C)).astype(np.float32)
    lens = [4, 3, 1, 2, 4, 0]
    labels = np.full((B, S), -1, np.int32)
    for i, n in enumerate(lens):
        labels[i, :n] = rng.integers(1, C, n)
    labels[0, 1] = labels[0, 0]                 # a repeated label
    steps = [12, 12, 9, 7, 0, 10]               # row 4: a fully masked pad
    mask = (np.arange(T)[None, :] < np.array(steps)[:, None]).astype(
        np.float32)
    return labels, logits, mask


@pytest.mark.parametrize("masked,weighted,blank",
                         [(False, False, 0), (True, False, 0),
                          (True, True, 0), (False, False, C - 1)])
def test_ctc_loss_matches_jax(masked, weighted, blank):
    labels, logits, mask = _ctc_inputs(8)
    if blank:
        labels = np.where(labels >= 0, labels - 1, labels)  # ids 0..C-2
    weights = (np.random.default_rng(9).random(B) + 0.5).astype(np.float32)
    args = [labels, logits, mask if masked else None,
            weights if weighted else None]
    (pv, jv), (pg, jg) = _value_and_grad(
        jlosses.ctc, losses.ctc, args, 1, {"blank": blank},
        {"blank": blank})
    assert np.isfinite(pv) and np.isfinite(pg).all()
    _close(pv, jv)
    _close(pg, jg, rtol=1e-4)
    if masked:  # the pad row gets no gradient
        assert not pg[4].any()


@pytest.mark.parametrize("padded", [False, True])
def test_ctc_catalog_op_matches_jax_optax_form(padded):
    labels, logits, mask = _ctc_inputs(10)
    labels = np.maximum(labels, 1)       # optax reads ids under padding
    label_pad = (np.arange(S)[None, :] >= np.array([4, 3, 1, 2, 4, 2])[
        :, None]).astype(np.float32)
    logit_pad = 1.0 - mask
    logit_pad[4, :5] = 0.0               # every row keeps some steps
    args = [logits, labels] + ([logit_pad, label_pad] if padded else [])
    (pv, jv), (pg, jg) = _value_and_grad(jops.lookup("loss.ctc"),
                                         ops.lookup("loss.ctc"), args, 0)
    _close(pv, jv)
    _close(pg, jg, rtol=1e-4)
