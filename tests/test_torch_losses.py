"""The port's losses and loss heads against the JAX package's, on shared
numpy inputs: the value and the gradient to the predictions (or logits),
with and without a mask and per-output weights.

Tolerance: rtol 1e-5, atol 1e-6. Both sides compute in float32 in the
same order of operations up to the final mean, whose summation order
differs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn.layers import core as jcore
from deeplearning4j_tpu.ops import losses as jlosses
from deeplearning4j_tpu_torch.nn.layers import core
from deeplearning4j_tpu_torch.ops import losses


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


B, N = 6, 5


def _data(seed, kind):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((B, N)) * 2).astype(np.float32)
    if kind == "probs":
        e = np.exp(logits - logits.max(-1, keepdims=True))
        preds = (e / e.sum(-1, keepdims=True)).astype(np.float32)
    elif kind == "sigmoid":
        preds = (1 / (1 + np.exp(-logits))).astype(np.float32)
    else:
        preds = logits
    onehot = np.eye(N, dtype=np.float32)[rng.integers(0, N, B)]
    binary = (rng.random((B, N)) > 0.5).astype(np.float32)
    mask = np.array([1, 1, 0, 1, 0, 1], np.float32)
    weights = (rng.random(N) + 0.5).astype(np.float32)
    return preds, onehot, binary, mask, weights


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), rtol=1e-5,
                               atol=1e-6)


def _both(jfn, pfn, labels, preds, mask, weights):
    jm = None if mask is None else jnp.asarray(mask)
    jw = None if weights is None else jnp.asarray(weights)
    jv, jg = jax.value_and_grad(
        lambda p: jfn(jnp.asarray(labels), p, jm, jw))(jnp.asarray(preds))
    pp = torch.from_numpy(preds).requires_grad_(True)
    pv = pfn(torch.from_numpy(labels), pp,
             None if mask is None else torch.from_numpy(mask),
             None if weights is None else torch.from_numpy(weights))
    pv.backward()
    _close(pv.detach().numpy(), jv)
    _close(pp.grad.numpy(), jg)


CASES = {
    "mcxent": ("probs", "onehot"),
    "binary_xent": ("sigmoid", "binary"),
    "mse": ("raw", "binary"),
    "softmax_ce_logits": ("raw", "onehot"),
    "sigmoid_bce_logits": ("raw", "binary"),
}


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("name", sorted(CASES))
def test_loss_matches_jax(name, masked, weighted):
    kind, lab = CASES[name]
    preds, onehot, binary, mask, weights = _data(1, kind)
    labels = onehot if lab == "onehot" else binary
    _both(jlosses.LOSSES[name], losses.LOSSES[name], labels, preds,
          mask if masked else None, weights if weighted else None)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_sparse_mcxent_matches_jax(masked, weighted):
    preds, onehot, _, mask, weights = _data(2, "probs")
    labels = onehot.argmax(-1).astype(np.int32)
    jm = None if not masked else jnp.asarray(mask)
    jw = None if not weighted else jnp.asarray(weights)
    jv, jg = jax.value_and_grad(lambda p: jlosses.sparse_mcxent(
        jnp.asarray(labels), p, jm, jw))(jnp.asarray(preds))
    pp = torch.from_numpy(preds).requires_grad_(True)
    pv = losses.sparse_mcxent(
        torch.from_numpy(labels), pp,
        None if not masked else torch.from_numpy(mask),
        None if not weighted else torch.from_numpy(weights))
    pv.backward()
    _close(pv.detach().numpy(), jv)
    _close(pp.grad.numpy(), jg)


def test_masked_non_finite_loss_does_not_leak():
    """A fully masked example with a non-finite loss contributes 0 to the
    value and the gradient, as in the JAX package (``where``, not a
    product)."""
    preds, onehot, _, mask, _ = _data(3, "raw")
    preds[2, 0] = np.inf
    pp = torch.from_numpy(preds).requires_grad_(True)
    v = losses.softmax_cross_entropy_with_logits(
        torch.from_numpy(onehot), pp, torch.from_numpy(mask))
    v.backward()
    assert torch.isfinite(v) and torch.isfinite(pp.grad[mask > 0]).all()
    jv = jlosses.softmax_cross_entropy_with_logits(
        jnp.asarray(onehot), jnp.asarray(preds), jnp.asarray(mask))
    _close(v.detach().numpy(), jv)


@pytest.mark.parametrize("a_shape,b_shape", [((4,), (4, 3)), ((4, 3), None),
                                             (None, (4,)), ((4, 1), (4,))])
def test_combine_masks_matches_jax(a_shape, b_shape):
    rng = np.random.default_rng(4)
    a = None if a_shape is None else (rng.random(a_shape) > 0.3).astype(
        np.float32)
    b = None if b_shape is None else (rng.random(b_shape) > 0.3).astype(
        np.float32)
    want = jlosses.combine_masks(None if a is None else jnp.asarray(a),
                                 None if b is None else jnp.asarray(b))
    got = losses.combine_masks(None if a is None else torch.from_numpy(a),
                               None if b is None else torch.from_numpy(b))
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_get_and_name_of():
    for name in ("mcxent", "sparse_mcxent", "binary_xent", "mse"):
        assert losses.get(name) is losses.LOSSES[name]
        assert losses.name_of(losses.get(name)) == name
        assert name in jlosses.LOSSES
    assert losses.get(losses.mse) is losses.mse
    # the whole JAX catalog is ported: no name raises as a later slice's
    for name in jlosses.LOSSES:
        assert losses.name_of(losses.get(name.upper())) == name
    with pytest.raises(ValueError, match="Unknown loss"):
        losses.get("nope")


@pytest.mark.parametrize("act,loss", [("softmax", "mcxent"),
                                      ("softmax", "sparse_mcxent"),
                                      ("sigmoid", "binary_xent"),
                                      ("identity", "mse"),
                                      ("tanh", "mse")])
def test_loss_heads_match_jax(act, loss):
    """OutputLayer (train: logits) and its ``loss_value``, and LossLayer,
    against the JAX package's on the same logits."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((B, 7)).astype(np.float32)
    w = (rng.standard_normal((7, N)) * 0.4).astype(np.float32)
    b = rng.standard_normal(N).astype(np.float32)
    if loss == "sparse_mcxent":
        labels = rng.integers(0, N, B).astype(np.int32)
    elif loss == "mcxent":
        labels = np.eye(N, dtype=np.float32)[rng.integers(0, N, B)]
    else:
        labels = (rng.random((B, N)) > 0.5).astype(np.float32)
    kw = dict(n_out=N, activation=act, loss=loss)
    jl, pl = jcore.OutputLayer(**kw), core.OutputLayer(**kw)

    def jfn(w):
        logits, _, _ = jl.apply({"W": w, "b": jnp.asarray(b)},
                                jnp.asarray(x), {}, train=True)
        return jl.loss_value(logits, jnp.asarray(labels))

    jv, jg = jax.value_and_grad(jfn)(jnp.asarray(w))
    pw = torch.from_numpy(w).requires_grad_(True)
    logits, _, _ = pl.apply({"W": pw, "b": torch.from_numpy(b)},
                            torch.from_numpy(x), {}, train=True)
    pv = pl.loss_value(logits, torch.from_numpy(labels))
    pv.backward()
    _close(pv.detach().numpy(), jv)
    _close(pw.grad.numpy(), jg)
    if loss != "sparse_mcxent":
        lv = core.LossLayer(loss=loss, activation=act).loss_value(
            torch.from_numpy(x @ w + b), torch.from_numpy(labels))
        jlv = jcore.LossLayer(loss=loss, activation=act).loss_value(
            jnp.asarray(x @ w + b), jnp.asarray(labels))
        _close(lv.numpy(), jlv)
    y, _, _ = core.LossLayer(activation=act).apply({}, torch.from_numpy(x),
                                                   {})
    y_train, _, _ = core.LossLayer(activation=act).apply(
        {}, torch.from_numpy(x), {}, train=True)
    assert torch.equal(y_train, torch.from_numpy(x))
    assert y.shape == (B, 7)
