"""The port's recurrent family against the JAX package's, on the CPU.

``GravesLSTM``, ``GRU`` (reset-after and classic), ``SimpleRnn``,
``Bidirectional`` (all four merge modes, with and without
``return_sequences``), ``ConvLSTM2D`` (``same`` and ``truncate`` input
convolutions, with and without ``return_sequences``),
``RecurrentAttentionLayer``, ``TimeDistributed``, ``RepeatVector``,
``MaskLayer``, ``MaskingLayer``, ``EmbeddingLayer`` and
``EmbeddingSequenceLayer``: each is given the JAX package's initial
parameters and the same numpy input on both sides, with no mask and with
a ``[B, T]`` mask of ragged rows and one fully masked row. Outputs, the
propagated mask, the final carry of a scan from a non-zero carry, and the
gradients of a weighted sum of the output with respect to the input and
every parameter agree within rtol/atol 1e-5 (float32; the same
arithmetic in another library). The JSON kinds round-trip both ways, and
the port's ``initialize`` gives the JAX package's parameter and output
shapes.

The four cells (``graves_lstm_cell``, ``gru_cell`` in both forms,
``simple_rnn_cell``) and ``embedding_lookup`` are catalog ops, held
against JAX in ``tests/test_torch_samediff.py``; their gradients are held
here, through the layers."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn.layers import attention as jatt
from deeplearning4j_tpu.nn.layers import base as jbase
from deeplearning4j_tpu.nn.layers import core as jcore
from deeplearning4j_tpu.nn.layers import recurrent as jrec
from deeplearning4j_tpu.nn.layers import special as jspecial
from deeplearning4j_tpu.nn.layers import wrappers as jwrap
from deeplearning4j_tpu_torch.nn.layers import Layer
from deeplearning4j_tpu_torch.ops import nnops
from deeplearning4j_tpu_torch.ops import pallas_kernels as pk

B, T, F, U = 3, 6, 5, 4
V, D = 9, 4                      # embedding vocabulary and width
H, W, C = 5, 5, 2                # ConvLSTM2D frames
TOL = dict(rtol=1e-5, atol=1e-5)

# ragged rows (6, 2) and a fully masked row
MASK = np.array([[1, 1, 1, 1, 1, 1], [1, 1, 0, 0, 0, 0], [0, 0, 0, 0, 0, 0]],
                np.float32)


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


def _seq(seed, shape=(B, T, F)):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _ids(seed, shape):
    return np.random.default_rng(seed).integers(0, V, shape).astype(
        np.float32)


def _masking_input(seed):
    """A sequence whose steps (0, 3), (1, 1) and (2, *) are all zeros."""
    x = _seq(seed)
    x[0, 3] = 0.0
    x[1, 1] = 0.0
    x[2] = 0.0
    return x


# name -> (JAX layer, input maker, differentiable input, takes a mask)
CASES = {
    "graves_lstm": (jrec.GravesLSTM(n_out=U), lambda: _seq(1), True, True),
    "gru_reset_after": (jrec.GRU(n_out=U), lambda: _seq(2), True, True),
    "gru_classic": (jrec.GRU(n_out=U, reset_after=False), lambda: _seq(3),
                    True, True),
    "simple_rnn": (jrec.SimpleRnn(n_out=U), lambda: _seq(4), True, True),
    "simple_rnn_relu": (jrec.SimpleRnn(n_out=U, activation="relu"),
                        lambda: _seq(5), True, True),
    **{f"bidirectional_{mode}_{'seq' if rs else 'last'}": (
        jrec.Bidirectional(layer=jrec.LSTM(n_out=U, use_pallas_cell=True),
                           mode=mode, return_sequences=rs),
        lambda: _seq(6), True, True)
       for mode in ("concat", "add", "mul", "average")
       for rs in (True, False)},
    "bidirectional_graves": (
        jrec.Bidirectional(layer=jrec.GravesLSTM(n_out=U)), lambda: _seq(7),
        True, True),
    "bidirectional_gru_last": (
        jrec.Bidirectional(layer=jrec.GRU(n_out=U), mode="add",
                           return_sequences=False), lambda: _seq(8), True,
        True),
    "convlstm2d_same": (jrec.ConvLSTM2D(n_out=3),
                        lambda: _seq(9, (B, 4, H, W, C)), True, True),
    "convlstm2d_truncate_last": (
        jrec.ConvLSTM2D(n_out=3, kernel=(2, 3), stride=(2, 1),
                        mode="truncate", return_sequences=False),
        lambda: _seq(10, (B, 4, H, W, C)), True, True),
    "recurrent_attention": (jatt.RecurrentAttentionLayer(n_out=U),
                            lambda: _seq(11), True, True),
    "time_distributed": (
        jwrap.TimeDistributed(layer=jcore.DenseLayer(n_out=3,
                                                     activation="tanh")),
        lambda: _seq(12), True, True),
    "repeat_vector": (jwrap.RepeatVector(n=4), lambda: _seq(13, (B, F)),
                      True, False),
    "mask_layer": (jwrap.MaskLayer(), lambda: _seq(14), True, True),
    "masking": (jcore.MaskingLayer(), lambda: _masking_input(15), True,
                True),
    "masking_value": (jcore.MaskingLayer(mask_value=0.5),
                      lambda: np.where(_seq(16) > 0, 0.5, _seq(16)),
                      True, False),
    "embedding_column": (jcore.EmbeddingLayer(n_in=V, n_out=D),
                         lambda: _ids(17, (B, 1)), False, False),
    "embedding_ids": (jcore.EmbeddingLayer(n_in=V, n_out=D),
                      lambda: _ids(18, (B, T)), False, True),
    "embedding_sequence": (jspecial.EmbeddingSequenceLayer(n_in=V, n_out=D),
                           lambda: _ids(19, (B, T, 1)), False, True),
    "embedding_sequence_2d": (
        jspecial.EmbeddingSequenceLayer(n_in=V, n_out=D),
        lambda: _ids(20, (B, T)), False, True),
}


def _in_shape(name, x):
    """The layer's batch-free input shape, as a builder hands it over."""
    if name.startswith("embedding_sequence"):
        return (x.shape[1], 1) if x.ndim == 3 else (x.shape[1],)
    if name.startswith("embedding"):
        return x.shape[1:]
    return x.shape[1:]


def _jax_init(jl, shape, seed=0):
    p, s, out = jl.initialize(jax.random.PRNGKey(seed), tuple(shape),
                              jnp.float32)
    return jax.tree.map(np.asarray, p), s, tuple(out)


def _jx(tree):
    return jax.tree.map(jnp.asarray, tree)


def _pt(tree):
    if isinstance(tree, dict):
        return {k: _pt(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _close(got, want, what=""):
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            _close(got[k], want[k], f"{what}/{k}")
        return
    np.testing.assert_allclose(
        got.detach().numpy() if torch.is_tensor(got) else np.asarray(got),
        np.asarray(want), err_msg=what, **TOL)


def _port(jl):
    return Layer.from_dict(jl.to_dict())


def _cases_with_masks():
    for name, (_, _, _, masked) in CASES.items():
        yield pytest.param(name, None, id=f"{name}-nomask")
        if masked:
            yield pytest.param(name, MASK, id=f"{name}-mask")


@pytest.mark.parametrize("name,mask", list(_cases_with_masks()))
def test_layer_matches_jax(name, mask):
    """Inference and training outputs, the propagated mask, and the
    gradients of ``sum(y * cot)`` for the input and every parameter."""
    jl, make_x, diff_x, _ = CASES[name]
    pl = _port(jl)
    x = make_x()
    p, _, _ = _jax_init(jl, _in_shape(name, x))
    if mask is not None:
        mask = mask[:, :x.shape[1]]   # ConvLSTM2D runs 4 frames
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else torch.from_numpy(mask)
    pk.reset_counters()
    # none of these layers behaves differently in training on the JAX side
    want, _, wmask = jl.apply(_jx(p), jnp.asarray(x), {}, train=True,
                              mask=jm)
    for train in (False, True):
        got, _, gmask = pl.apply(_pt(p), torch.from_numpy(x), {},
                                 train=train, mask=tm)
        assert tuple(got.shape) == tuple(want.shape), name
        _close(got, want, name)
        assert (gmask is None) == (wmask is None), name
        if wmask is not None:
            _close(gmask, wmask, f"{name} mask")
    # a Bidirectional never asks for the forward-only cell (K8 on the card)
    assert pk.counters() == {"fused": 0, "fallback_platform": 0}
    cot = np.random.default_rng(99).standard_normal(want.shape).astype(
        np.float32)

    def jloss(params, xx):
        y, _, _ = jl.apply(params, xx, {}, train=True, mask=jm)
        return jnp.sum(y * cot)

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(_jx(p), jnp.asarray(x))
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a))
                      .requires_grad_(True), p)
    leaves = jax.tree.leaves(tp)
    xt = torch.from_numpy(x).requires_grad_(diff_x)
    y, _, _ = pl.apply(tp, xt, {}, train=True, mask=tm)
    grads = torch.autograd.grad((y * torch.from_numpy(cot)).sum(),
                                leaves + ([xt] if diff_x else []))
    for g, w, path in zip(grads, jax.tree.leaves(jgp),
                          jax.tree_util.tree_leaves_with_path(jgp)):
        _close(g, w, f"{name} d{jax.tree_util.keystr(path[0])}")
    if diff_x:
        _close(grads[-1], jgx, f"{name} dx")


@pytest.mark.parametrize("name", [
    "graves_lstm", "gru_reset_after", "gru_classic", "simple_rnn",
    "bidirectional_concat_seq", "bidirectional_graves"])
@pytest.mark.parametrize("mask", [None, MASK], ids=["nomask", "mask"])
def test_scan_with_state_carries_like_jax(name, mask):
    """A chunk from a non-zero carry: outputs and the final carry."""
    jl = CASES[name][0]
    pl = _port(jl)
    x = _seq(30)
    p, _, _ = _jax_init(jl, x.shape[1:], seed=3)
    carry = jax.tree.map(
        lambda a: np.random.default_rng(31).standard_normal(a.shape).astype(
            np.float32), jax.tree.map(np.asarray,
                                      jl.init_stream_state(_jx(p), B)))
    want, wc = jl.scan_with_state(_jx(p), jnp.asarray(x), _jx(carry),
                                  None if mask is None else jnp.asarray(mask))
    got, gc = pl.scan_with_state(
        _pt(p), torch.from_numpy(x),
        jax.tree.map(lambda a: torch.from_numpy(a), carry),
        None if mask is None else torch.from_numpy(mask))
    _close(got, want, name)
    for g, w in zip(jax.tree.leaves(gc), jax.tree.leaves(wc)):
        _close(g, w, f"{name} carry")


def test_masked_steps_keep_the_state():
    """The fully masked row stays at its zero carry, the length-2 row
    holds its step-2 output, in every carry-gated layer."""
    for name in ("graves_lstm", "gru_reset_after", "gru_classic",
                 "simple_rnn", "recurrent_attention"):
        jl, make_x, _, _ = CASES[name]
        x = make_x()
        p, _, _ = _jax_init(jl, x.shape[1:])
        y, _, _ = _port(jl).apply(_pt(p), torch.from_numpy(x), {},
                                  mask=torch.from_numpy(MASK))
        assert torch.count_nonzero(y[2]) == 0, name
        assert torch.equal(y[1, 2:], y[1, 1:2].expand(T - 2, U)), name


@pytest.mark.parametrize("name", list(CASES))
def test_serde_and_initialize_match_jax(name):
    """The JSON round-trips both ways; ``initialize`` gives the JAX
    package's parameter shapes and output shape (dynamic T included)."""
    jl, make_x, _, _ = CASES[name]
    d = jl.to_dict()
    pl = Layer.from_dict(d)
    assert pl.kind == jl.kind and pl.to_dict() == d
    back = jbase.Layer.from_dict(pl.to_dict())
    assert back.to_dict() == d
    x = make_x()
    shapes = [_in_shape(name, x)]
    if len(shapes[0]) == 2 and not name.startswith(("repeat", "embedding")):
        shapes.append((-1,) + tuple(shapes[0][1:]))
    for shape in shapes:
        if name.startswith(("masking", "time_distributed", "recurrent_att",
                            "convlstm")) and shape[0] < 0:
            continue
        jp, js, jout = _jax_init(jl, shape)
        tp, ts, tout = pl.initialize(torch.Generator().manual_seed(0),
                                     tuple(shape), torch.float32, "cpu")
        assert tuple(tout) == jout and ts == js == {}, (name, shape)
        assert jax.tree.map(lambda a: tuple(a.shape), _np(tp)) == \
            jax.tree.map(lambda a: tuple(a.shape), jp), name
        for path, t in jax.tree_util.tree_leaves_with_path(_np(tp)):
            key = jax.tree_util.keystr(path)
            if key.endswith(("['b']", "['rb']")):
                assert not np.any(t), (name, key)


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return tree.detach().numpy()


def test_bidirectional_last_takes_each_directions_own_end():
    """``return_sequences=False``: the forward stream's t = T-1 and the
    backward stream's final position, which is the merged sequence's
    backward half at t = 0, not at t = T-1."""
    jl = CASES["bidirectional_concat_seq"][0]
    x = _seq(40)
    p, _, _ = _jax_init(jl, x.shape[1:])
    seq = _port(jl)
    last = dataclasses.replace(seq, return_sequences=False)
    ys, _, _ = seq.apply(_pt(p), torch.from_numpy(x), {})
    yl, _, ml = last.apply(_pt(p), torch.from_numpy(x), {})
    assert ml is None and yl.shape == (B, 2 * U)
    assert torch.equal(yl[:, :U], ys[:, -1, :U])
    assert torch.equal(yl[:, U:], ys[:, 0, U:])


def test_bidirectional_refuses_an_unknown_mode():
    jl = jrec.Bidirectional(layer=jrec.SimpleRnn(n_out=U), mode="max")
    x = _seq(41)
    p, _, _ = _jax_init(dataclasses.replace(jl, mode="add"), x.shape[1:])
    with pytest.raises(ValueError, match="mode"):
        _port(jl).apply(_pt(p), torch.from_numpy(x), {})


def _tbptt_grads(jl, x, loss):
    """The gradients of ``loss(y)`` for the parameters and the input
    under ``train=True``: ``(JAX's, the port's)``, each ``(params, x)``."""
    p, _, _ = _jax_init(jl, x.shape[1:])

    def jloss(pp, xx):
        y, _, _ = jl.apply(pp, xx, {}, train=True)
        return loss(y, jnp)

    want = jax.grad(jloss, argnums=(0, 1))(_jx(p), jnp.asarray(x))
    pt = jax.tree.map(lambda t: t.requires_grad_(True), _pt(p))
    xt = torch.from_numpy(x).requires_grad_(True)
    y, _, _ = _port(jl).apply(pt, xt, {}, train=True)
    loss(y, torch).backward()
    return want, (jax.tree.map(lambda t: t.grad, pt), xt.grad)


def _last_and_all(y, lib):
    return lib.sum(y[:, -1] ** 2) + lib.sum(y)


def test_tbptt_truncates_every_new_layer_like_jax():
    """``tbptt_length=2``: each layer's input and parameter gradients equal
    the JAX package's under the same truncation; and ConvLSTM2D's last
    frame's output does not reach the input before its window."""
    for jl in (jrec.GravesLSTM(n_out=U, tbptt_length=2),
               jrec.GRU(n_out=U, tbptt_length=2),
               jrec.SimpleRnn(n_out=U, tbptt_length=2),
               jrec.Bidirectional(layer=jrec.LSTM(n_out=U, tbptt_length=2)),
               jrec.ConvLSTM2D(n_out=2, tbptt_length=2)):
        x = (_seq(51, (B, 5, H, W, C)) if jl.kind == "convlstm2d"
             else _seq(50))
        (wp, wx), (gp, gx) = _tbptt_grads(jl, x, _last_and_all)
        _close(gx, wx, jl.kind)
        _close(_np(gp), jax.tree.map(np.asarray, wp), jl.kind)
    jl = jrec.ConvLSTM2D(n_out=2, tbptt_length=2)
    x = _seq(51, (B, 5, H, W, C))
    (wp, wx), (gp, gx) = _tbptt_grads(jl, x, lambda y, lib: y[:, -1].sum())
    _close(gx, wx, "convlstm2d last frame")
    _close(_np(gp), jax.tree.map(np.asarray, wp), "convlstm2d last frame")
    assert torch.count_nonzero(gx[:, :4]) == 0
    assert torch.count_nonzero(gx[:, 4]) > 0


def test_embedding_lookup_follows_jnp_take():
    """Negative ids count from the end; ids past the table give NaN rows
    (``jnp.take``'s fill mode); float ids truncate."""
    table = np.arange(12, dtype=np.float32).reshape(4, 3)
    ids = np.array([[-1, 5], [0, 2]], np.int32)
    from deeplearning4j_tpu.ops import nnops as jnnops
    want = np.asarray(jnnops.embedding_lookup(jnp.asarray(table), ids))
    got = nnops.embedding_lookup(torch.from_numpy(table),
                                 torch.from_numpy(ids)).numpy()
    np.testing.assert_array_equal(got, want)
    assert np.isnan(got[0, 1]).all()
    fl = np.array([1.7, 2.2], np.float32)
    np.testing.assert_array_equal(
        nnops.embedding_lookup(torch.from_numpy(table),
                               torch.from_numpy(fl)).numpy(),
        np.asarray(jnnops.embedding_lookup(jnp.asarray(table), fl)))
