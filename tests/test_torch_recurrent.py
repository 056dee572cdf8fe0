"""The port's recurrent layers against the JAX package's, on the CPU.

``LSTM`` (plain cell and ``use_pallas_cell``, inference and gradient
paths, truncated BPTT), ``LastTimeStep``, ``RnnOutputLayer`` and
``RnnLossLayer``, each given the same numpy weights and inputs on both
sides, with and without a ``[B, T]`` mask (ragged rows and a fully masked
row): float32 outputs within rtol/atol 1e-5 (``tests/test_ops.py``'s
tolerance for the LSTM cell), the same final carry, the same JSON, and
the same gradients through a truncated-BPTT window."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn.layers import base as jbase
from deeplearning4j_tpu.nn.layers import recurrent as jrec
from deeplearning4j_tpu_torch.nn.layers import Layer
from deeplearning4j_tpu_torch.nn.layers import recurrent as rec
from deeplearning4j_tpu_torch.ops import pallas_kernels as pk

B, T, F, U = 3, 6, 5, 4
TOL = dict(rtol=1e-5, atol=1e-5)


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


def _lstm_params(seed=0, f=F, u=U):
    rng = np.random.default_rng(seed)
    return {"W": (rng.standard_normal((f, 4 * u)) * 0.5).astype(np.float32),
            "RW": (rng.standard_normal((u, 4 * u)) * 0.5).astype(np.float32),
            "b": (rng.standard_normal(4 * u) * 0.1).astype(np.float32)}


def _x(seed=1, t=T):
    return np.random.default_rng(seed).standard_normal(
        (B, t, F)).astype(np.float32)


# ragged rows (6, 2) and a fully masked row
MASK = np.array([[1, 1, 1, 1, 1, 1], [1, 1, 0, 0, 0, 0], [0, 0, 0, 0, 0, 0]],
                np.float32)


def _pt(tree):
    return {k: torch.from_numpy(v) for k, v in tree.items()}


def _jx(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("mask", [None, MASK], ids=["nomask", "mask"])
@pytest.mark.parametrize("pallas", [False, True], ids=["lax", "pallas"])
@pytest.mark.parametrize("train", [False, True], ids=["infer", "train"])
def test_lstm_matches_jax(pallas, mask, train):
    kw = dict(n_out=U, forget_bias=1.0, use_pallas_cell=pallas)
    p = _lstm_params()
    x = _x()
    want, _, wmask = jrec.LSTM(**kw).apply(
        _jx(p), jnp.asarray(x), {}, train=train,
        mask=None if mask is None else jnp.asarray(mask))
    pk.reset_counters()
    got, _, gmask = rec.LSTM(**kw).apply(
        _pt(p), torch.from_numpy(x), {}, train=train,
        mask=None if mask is None else torch.from_numpy(mask))
    assert got.shape == (B, T, U)
    _close(got, want)
    assert (gmask is None) == (wmask is None)
    # the fused cell serves inference only
    assert pk.counters()["fallback_platform"] == \
        (T if pallas and not train else 0)
    if mask is not None:
        # a masked step keeps the state: the fully masked row stays 0, the
        # row of length 2 holds its step-2 output
        assert torch.count_nonzero(got[2]) == 0
        assert torch.equal(got[1, 2:], got[1, 1:2].expand(T - 2, U))


@pytest.mark.parametrize("mask", [None, MASK], ids=["nomask", "mask"])
def test_scan_with_state_carries_like_jax(mask):
    """A streaming chunk from a non-zero carry: outputs and the final
    (h, c) agree."""
    p = _lstm_params(2)
    x = _x(3)
    rng = np.random.default_rng(4)
    h0, c0 = (rng.standard_normal((B, U)).astype(np.float32)
              for _ in range(2))
    lay = dict(n_out=U, use_pallas_cell=True)
    want, (wh, wc) = jrec.LSTM(**lay).scan_with_state(
        _jx(p), jnp.asarray(x), (jnp.asarray(h0), jnp.asarray(c0)),
        None if mask is None else jnp.asarray(mask), grad_path=False)
    got, (gh, gc) = rec.LSTM(**lay).scan_with_state(
        _pt(p), torch.from_numpy(x), (torch.from_numpy(h0),
                                      torch.from_numpy(c0)),
        None if mask is None else torch.from_numpy(mask), grad_path=False)
    for g, w in ((got, want), (gh, wh), (gc, wc)):
        _close(g, w)


def test_truncated_bptt_gradients_match_jax():
    """tbptt_length=2: the carry's gradient stops at every window
    boundary, on both sides (``stop_gradient`` there, ``detach`` here)."""
    p = _lstm_params(5)
    x = _x(6)
    lay = dict(n_out=U, tbptt_length=2)

    def jloss(x):
        y, _, _ = jrec.LSTM(**lay).apply(_jx(p), x, {}, train=True)
        return jnp.sum(y[:, -1] ** 2) + jnp.sum(y)

    want = jax.grad(jloss)(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    y, _, _ = rec.LSTM(**lay).apply(_pt(p), xt, {}, train=True)
    (torch.sum(y[:, -1] ** 2) + torch.sum(y)).backward()
    _close(xt.grad, want)
    # the last step's output does not reach the first window
    xt.grad = None
    y, _, _ = rec.LSTM(**lay).apply(_pt(p), xt, {}, train=True)
    y[:, -1].sum().backward()
    assert torch.count_nonzero(xt.grad[:, :4]) == 0


@pytest.mark.parametrize("mask", [None, MASK], ids=["nomask", "mask"])
def test_last_timestep_matches_jax(mask):
    x = _x(7)
    want, _, _ = jrec.LastTimeStep().apply(
        {}, jnp.asarray(x), {}, mask=None if mask is None
        else jnp.asarray(mask))
    got, _, gmask = rec.LastTimeStep().apply(
        {}, torch.from_numpy(x), {}, mask=None if mask is None
        else torch.from_numpy(mask))
    assert gmask is None and got.shape == (B, F)
    _close(got, want)
    if mask is not None:  # the fully masked row gives its last step
        assert torch.equal(got[2], torch.from_numpy(x[2, -1]))


@pytest.mark.parametrize("train", [False, True], ids=["infer", "train"])
def test_rnn_output_layer_matches_jax(train):
    rng = np.random.default_rng(8)
    p = {"W": rng.standard_normal((F, 7)).astype(np.float32),
         "b": rng.standard_normal(7).astype(np.float32)}
    x = _x(9)
    want, _, wm = jrec.RnnOutputLayer(n_out=7).apply(
        _jx(p), jnp.asarray(x), {}, train=train, mask=jnp.asarray(MASK))
    got, _, gm = rec.RnnOutputLayer(n_out=7).apply(
        _pt(p), torch.from_numpy(x), {}, train=train,
        mask=torch.from_numpy(MASK))
    _close(got, want)
    _close(gm, wm)
    labels = np.eye(7, dtype=np.float32)[rng.integers(0, 7, (B, T))]
    wl = jrec.RnnOutputLayer(n_out=7).loss_value(
        jrec.RnnOutputLayer(n_out=7).apply(_jx(p), jnp.asarray(x), {},
                                           train=True)[0],
        jnp.asarray(labels), mask=jnp.asarray(MASK))
    gl = rec.RnnOutputLayer(n_out=7).loss_value(
        rec.RnnOutputLayer(n_out=7).apply(_pt(p), torch.from_numpy(x), {},
                                          train=True)[0],
        torch.from_numpy(labels), mask=torch.from_numpy(MASK))
    np.testing.assert_allclose(float(gl), float(wl), **TOL)


def test_rnn_loss_layer_matches_jax():
    x = _x(10)
    want, _, _ = jrec.RnnLossLayer(activation="softmax").apply(
        {}, jnp.asarray(x), {})
    got, _, _ = rec.RnnLossLayer(activation="softmax").apply(
        {}, torch.from_numpy(x), {})
    _close(got, want)


@pytest.mark.parametrize("layer", [
    jrec.LSTM(n_out=16, forget_bias=0.5, use_pallas_cell=True,
              tbptt_length=8, name="l0"),
    jrec.LastTimeStep(name="last"),
    jrec.RnnOutputLayer(n_out=11, loss="mcxent", name="out"),
    jrec.RnnLossLayer(loss="mse")], ids=lambda l: l.kind)
def test_serde_kinds_match_jax(layer):
    d = layer.to_dict()
    port = Layer.from_dict(d)
    assert port.kind == layer.kind
    assert port.to_dict() == d
    back = jbase.Layer.from_dict(port.to_dict())
    assert dataclasses.asdict(back) == dataclasses.asdict(layer)


def test_initialize_shapes_match_jax():
    lay = rec.LSTM(n_out=U)
    p, s, out = lay.initialize(torch.Generator().manual_seed(0), (-1, F),
                               torch.float32, "cpu")
    jp, js, jout = jrec.LSTM(n_out=U).initialize(jax.random.PRNGKey(0),
                                                 (-1, F), jnp.float32)
    assert out == tuple(jout) and s == js == {}
    assert {k: tuple(v.shape) for k, v in p.items()} == \
        {k: tuple(v.shape) for k, v in jp.items()}
    assert torch.count_nonzero(p["b"]) == 0
    h, c = lay.init_stream_state(p, 2)
    assert h.shape == c.shape == (2, U) and not torch.any(h)
