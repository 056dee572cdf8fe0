"""Recurrent training in the port against the JAX package, on the CPU.

- The builders: a net-level ``tbptt_length`` is stamped onto recurrent
  layers (a ``Bidirectional``'s wrapped layer too) by the sequential
  builder and by ``GraphBuilder.build``, whose configuration JSON equals
  the JAX package's; ``_auto_flatten`` leaves ``[T, F]`` inputs alone.
- ``fit`` with ``tbptt_length``: a small TextGenerationLSTM (vocab 11,
  units 8, T 12, tbptt 4, ragged feature and label masks) and a
  ComputationGraph with an LSTM vertex give the JAX package's losses
  (rtol 1e-5) and parameters (atol 1e-6 + rtol 1e-4: an Adam step is
  1e-3, and float32 gradient sums in another order move its last digits)
  after 1 and 3 Adam steps, from the JAX package's initial parameters.
  The gradients are the truncated ones: they equal JAX's under the same
  window and differ from full BPTT.
- The golden replay: from the JAX package's initial parameters, the port
  replays ``golden_harness.run_bilstm`` and follows
  ``tests/fixtures/bilstm_golden.json`` within ``golden_harness.compare``'s
  bands (rtol 1e-3, atol 1e-5).
- A net-level l2 adds nothing for a ``Bidirectional`` (no top-level
  ``W``), as in the JAX package.
- ``rnn_time_step`` refuses a ``Bidirectional``.
- ZIPs: a net of each new layer kind, saved by the JAX package after a
  training step (so its Adam state is not zero), loads in the port with
  the same parameters, updater state and outputs (1e-5), and the port's
  ZIP loads back in JAX; ``from_numpy`` carries the nested ``fw``/``bw``
  trees and their updater state.
- ``text_generation_lstm(embedding=8)``: the JAX configuration, the same
  outputs and one ``fit`` step on the same weights.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
from deeplearning4j_tpu.models.zoo import text_generation_lstm as jtgl
from deeplearning4j_tpu.nn import config as jconfig
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.layers import attention as jatt
from deeplearning4j_tpu.nn.layers import core as jcore
from deeplearning4j_tpu.nn.layers import recurrent as jrec
from deeplearning4j_tpu.nn.layers import special as jspecial
from deeplearning4j_tpu.nn.layers import wrappers as jwrap
from deeplearning4j_tpu.nn.model import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.nn.updaters import Adam as JAdam
from deeplearning4j_tpu_torch.data.dataset import DataSet
from deeplearning4j_tpu_torch.models import text_generation_lstm
from deeplearning4j_tpu_torch.nn import config
from deeplearning4j_tpu_torch.nn.graph import (ComputationGraph,
                                               ComputationGraphConfiguration)
from deeplearning4j_tpu_torch.nn.layers import core, recurrent as rec
from deeplearning4j_tpu_torch.nn.model import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.updaters import Adam
from deeplearning4j_tpu_torch.utils.convert import from_numpy

import golden_harness

VOCAB, UNITS, B, T, TBPTT = 11, 8, 4, 12, 4
LOSS_RTOL = 1e-5
PARAM_TOL = dict(rtol=1e-4, atol=1e-6)
TOL = dict(rtol=1e-5, atol=1e-5)
LENGTHS = [12, 7, 3, 10]


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


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy() if torch.is_tensor(tree) \
        else np.asarray(tree)


def _tree_close(got, want, what="", **tol):
    want = _np(want)
    got = _np(got)
    assert set(got) == set(want), what
    for k in want:
        if isinstance(want[k], dict):
            _tree_close(got[k], want[k], f"{what}/{k}", **tol)
        else:
            np.testing.assert_allclose(got[k], want[k], err_msg=f"{what}/{k}",
                                       **(tol or TOL))


def _port_mln(jnet):
    """The port's net on the CPU with the JAX net's configuration,
    parameters, state and updater state."""
    pn = MultiLayerNetwork(config.MultiLayerConfiguration.from_json(
        jnet.conf.to_json())).init(device="cpu")
    pn.params, pn.state, pn.updater_state = from_numpy(
        _np(jnet.params), _np(jnet.state), "cpu",
        updater_state=_np(jnet.updater_state))
    return pn


def _text(seed, b=B, t=T, vocab=VOCAB):
    """One-hot characters, next-character labels, ragged masks."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, (b, t + 1))
    eye = np.eye(vocab, dtype=np.float32)
    mask = (np.arange(t)[None, :] < np.array(LENGTHS[:b])[:, None]).astype(
        np.float32)
    return eye[ids[:, :-1]], eye[ids[:, 1:]], mask


def _tgl(mod, layers_mod, adam, tbptt=TBPTT, **lstm):
    b = (mod.NeuralNetConfiguration.builder().seed(3)
         .updater(adam(learning_rate=1e-3))
         .input_type(mod.InputType.recurrent(VOCAB)))
    if tbptt:
        b = b.tbptt_length(tbptt)
    return b.list(layers_mod.LSTM(n_out=UNITS, **lstm),
                  layers_mod.LSTM(n_out=UNITS, **lstm),
                  layers_mod.RnnOutputLayer(n_out=VOCAB)).build()


# ---------------------------------------------------------- the builders

def _graph_conf(mod, layers_mod, adam, tbptt=TBPTT):
    b = (mod.NeuralNetConfiguration.builder().seed(5)
         .updater(adam(learning_rate=1e-3)))
    if tbptt:
        b = b.tbptt_length(tbptt)
    return (b.graph_builder().add_inputs("in")
            .set_input_types(mod.InputType.recurrent(VOCAB))
            .add_layer("lstm", layers_mod.LSTM(n_out=UNITS), "in")
            .add_layer("bi", layers_mod.Bidirectional(
                layer=layers_mod.LSTM(n_out=UNITS), mode="add"), "lstm")
            .add_layer("out", layers_mod.RnnOutputLayer(n_out=VOCAB), "bi")
            .set_outputs("out").build())


def test_graph_builder_stamps_tbptt_as_jax_does():
    """The LSTM vertex and the LSTM inside the Bidirectional vertex carry
    the window; the JSON equals the JAX package's, and the caller's layer
    objects are not mutated."""
    port = _graph_conf(config, rec, Adam)
    ref = _graph_conf(jconfig, jrec, JAdam)
    layers = {n: v.layer for n, v, _ in port.vertices}
    assert layers["lstm"].tbptt_length == TBPTT
    assert layers["bi"].layer.tbptt_length == TBPTT
    assert json.loads(port.to_json()) == json.loads(ref.to_json())
    back = ComputationGraphConfiguration.from_json(ref.to_json())
    assert json.loads(back.to_json()) == json.loads(ref.to_json())
    lstm = rec.LSTM(n_out=UNITS)
    (config.NeuralNetConfiguration.builder().tbptt_length(3).graph_builder()
     .add_inputs("in").add_layer("l", lstm, "in").set_outputs("l").build())
    assert lstm.tbptt_length is None
    unstamped = _graph_conf(config, rec, Adam, tbptt=None)
    layers = {n: v.layer for n, v, _ in unstamped.vertices}
    assert layers["lstm"].tbptt_length is None
    assert layers["bi"].layer.tbptt_length is None


def test_sequential_builder_stamps_wrapped_layers_and_keeps_t_f():
    """``stamp_tbptt`` reaches a Bidirectional's layer; a layer's own
    window wins; a dense layer after a recurrent one gets no
    FlattenLayer (``[T, F]`` inputs are left alone)."""
    def build(mod, layers_mod, adam):
        return (mod.NeuralNetConfiguration.builder().seed(1)
                .updater(adam(learning_rate=1e-2))
                .input_type(mod.InputType.recurrent(VOCAB, 9))
                .tbptt_length(5)
                .list(layers_mod.Bidirectional(
                    layer=layers_mod.GravesLSTM(n_out=UNITS)),
                      layers_mod.GRU(n_out=UNITS, tbptt_length=2),
                      layers_mod.RnnOutputLayer(n_out=VOCAB))
                .build())

    port = build(config, rec, Adam)
    ref = build(jconfig, jrec, JAdam)
    assert port.layers[0].layer.tbptt_length == 5
    assert port.layers[1].tbptt_length == 2
    assert port.to_json() == ref.to_json()
    dense = (config.NeuralNetConfiguration.builder()
             .input_type(config.InputType.recurrent(VOCAB, 9))
             .list(rec.LSTM(n_out=UNITS), core.DenseLayer(n_out=3),
                   rec.RnnOutputLayer(n_out=2)).build())
    jdense = (jconfig.NeuralNetConfiguration.builder()
              .input_type(jconfig.InputType.recurrent(VOCAB, 9))
              .list(jrec.LSTM(n_out=UNITS), jcore.DenseLayer(n_out=3),
                    jrec.RnnOutputLayer(n_out=2)).build())
    assert [l.kind for l in dense.layers] == [l.kind for l in jdense.layers] \
        == ["lstm", "dense", "rnn_output"]


# ------------------------------------------------------- fit with tbptt

def _fit_steps(jnet, pnet, batches):
    for i, (x, y, m) in enumerate(batches):
        jnet.fit(JDataSet(x, y, m, m))
        pnet.fit(DataSet(x, y, m, m))
        np.testing.assert_allclose(pnet.score(), float(jnet.score()),
                                   rtol=LOSS_RTOL, err_msg=f"step {i}")
        if i in (0, 2):
            _tree_close(pnet.params, jnet.params, f"params after {i + 1}",
                        **PARAM_TOL)
    _tree_close(pnet.updater_state, jnet.updater_state, "adam state",
                **PARAM_TOL)


def test_text_generation_lstm_fit_matches_jax():
    jnet = JMLN(_tgl(jconfig, jrec, JAdam)).init()
    pnet = _port_mln(jnet)
    assert pnet.conf.to_json() == jnet.conf.to_json()
    _fit_steps(jnet, pnet, [_text(s) for s in (1, 2, 3)])
    assert pnet.iteration == jnet.iteration == 3


def test_graph_fit_with_tbptt_matches_jax():
    jnet = JGraph(_graph_conf(jconfig, jrec, JAdam)).init()
    pnet = ComputationGraph(ComputationGraphConfiguration.from_json(
        jnet.conf.to_json())).init(device="cpu")
    pnet.params, pnet.state, pnet.updater_state = from_numpy(
        _np(jnet.params), _np(jnet.state), "cpu",
        updater_state=_np(jnet.updater_state))
    _fit_steps(jnet, pnet, [_text(s) for s in (4, 5, 6)])


def _grads(pnet, x, y, m):
    _, g, _ = pnet._value_and_grad(torch.from_numpy(x), torch.from_numpy(y),
                                   torch.from_numpy(m), torch.from_numpy(m))
    return g


def test_fit_gradients_are_the_truncated_ones():
    """The port's gradient under tbptt 4 equals the JAX package's under
    tbptt 4, and differs from full BPTT's (which equals JAX's full one)."""
    x, y, m = _text(7)
    out = {}
    for tbptt in (TBPTT, None):
        jnet = JMLN(_tgl(jconfig, jrec, JAdam, tbptt=tbptt)).init()
        pnet = _port_mln(jnet)
        lm = jnp.asarray(m)

        def loss(params):
            return jnet._build_loss_fn()(params, jnet.state, None,
                                         jnp.asarray(x), jnp.asarray(y), lm,
                                         lm)[0]

        want = jax.grad(loss)(jnet.params)
        got = _grads(pnet, x, y, m)
        _tree_close(got, want, f"tbptt={tbptt}", rtol=1e-4, atol=1e-6)
        out[tbptt] = got
    diff = max(float((out[TBPTT][k][n] - out[None][k][n]).abs().max())
               for k in out[None] for n in out[None][k])
    assert diff > 1e-3


def test_golden_bilstm_replay_follows_the_fixture():
    """``golden_harness.run_bilstm``'s 8 steps, in the port, from the JAX
    package's initial parameters of the same configuration."""
    jconf = (jconfig.NeuralNetConfiguration.builder().seed(99)
             .updater(JAdam(learning_rate=2e-3))
             .input_type(jconfig.InputType.recurrent(6))
             .list(jrec.Bidirectional(jrec.LSTM(n_out=12, activation="tanh")),
                   jrec.RnnOutputLayer(n_out=4)).build())
    pnet = _port_mln(JMLN(jconf).init())
    rng = np.random.default_rng(20260732)
    losses = []
    for _ in range(golden_harness.STEPS):
        x = rng.normal(size=(golden_harness.BATCH, 10, 6)).astype(np.float32)
        idx = rng.integers(0, 4, (golden_harness.BATCH, 10))
        y = np.eye(4, dtype=np.float32)[idx]
        pnet.fit(DataSet(x, y), epochs=1)
        losses.append(float(pnet.score()))
    params = {}
    for k in sorted(pnet.params, key=int):
        for path, leaf in jax.tree_util.tree_leaves_with_path(
                _np(pnet.params[k])):
            key = "/".join([f"['{k}']"] + [str(p) for p in path])
            a = leaf.astype(np.float64).ravel()
            params[key] = {"mean": float(a.mean()), "std": float(a.std()),
                           "head": [float(v) for v in a[:5]]}
    with open(golden_harness.MODELS["bilstm"][1]) as f:
        golden = json.load(f)
    golden_harness.compare({"steps": len(losses),
                            "batch": golden_harness.BATCH,
                            "losses": losses, "params": params}, golden)


def test_l2_skips_a_bidirectionals_nested_trees():
    def conf(mod, layers_mod, adam):
        return (mod.NeuralNetConfiguration.builder().seed(2).l2(0.5)
                .updater(adam(learning_rate=1e-3))
                .input_type(mod.InputType.recurrent(VOCAB))
                .list(layers_mod.Bidirectional(
                    layer=layers_mod.LSTM(n_out=UNITS)),
                      layers_mod.RnnOutputLayer(n_out=VOCAB)).build())

    jnet = JMLN(conf(jconfig, jrec, JAdam)).init()
    pnet = _port_mln(jnet)
    x, y, m = _text(8)
    assert float(pnet._regularization(pnet.params)) == pytest.approx(
        float(jnet._regularization(jnet.params)), rel=1e-6)
    assert float(pnet._regularization({"0": pnet.params["0"]})) == 0.0
    np.testing.assert_allclose(
        pnet.score(DataSet(x, y, m, m)), float(jnet.score(JDataSet(x, y, m,
                                                                   m))),
        rtol=LOSS_RTOL)


def test_rnn_time_step_refuses_a_bidirectional():
    jnet = JMLN(jconfig.NeuralNetConfiguration.builder()
                .input_type(jconfig.InputType.recurrent(VOCAB))
                .list(jrec.Bidirectional(jrec.LSTM(n_out=UNITS)),
                      jrec.RnnOutputLayer(n_out=VOCAB)).build()).init()
    pnet = _port_mln(jnet)
    x, _, _ = _text(9)
    with pytest.raises(ValueError, match="bidirectional"):
        pnet.rnn_time_step(x)
    with pytest.raises(ValueError, match="bidirectional"):
        jnet.rnn_time_step(x)
    np.testing.assert_allclose(pnet.output(x), np.asarray(jnet.output(x)),
                               **TOL)


# ------------------------------------------------------------------ ZIPs

def _seq_in(n):
    return (jconfig.InputType.recurrent(n),
            lambda rng, b: rng.standard_normal((b, 6, n)).astype(np.float32))


def _rnn_out(n=5):
    return jrec.RnnOutputLayer(n_out=n)


def _zip_nets():
    """name -> (input type, input maker, JAX layers, label maker)."""
    def seq_labels(rng, b, t=6, n=5):
        return np.eye(n, dtype=np.float32)[rng.integers(0, n, (b, t))]

    def ff_labels(rng, b, n=5):
        return np.eye(n, dtype=np.float32)[rng.integers(0, n, b)]

    seq_t, seq_x = _seq_in(4)
    return {
        "bidirectional_graves": (seq_t, seq_x, [
            jrec.Bidirectional(jrec.GravesLSTM(n_out=UNITS), mode="concat"),
            _rnn_out()], seq_labels),
        "graves_lstm": (seq_t, seq_x, [jrec.GravesLSTM(n_out=UNITS),
                                       _rnn_out()], seq_labels),
        "gru": (seq_t, seq_x, [jrec.GRU(n_out=UNITS),
                               jrec.GRU(n_out=UNITS, reset_after=False),
                               _rnn_out()], seq_labels),
        "simple_rnn": (seq_t, seq_x, [jrec.SimpleRnn(n_out=UNITS),
                                      _rnn_out()], seq_labels),
        "convlstm2d": (
            (6, 5, 5, 2),
            lambda rng, b: rng.standard_normal((b, 6, 5, 5, 2)).astype(
                np.float32),
            [jrec.ConvLSTM2D(n_out=3, return_sequences=False),
             jcore.OutputLayer(n_out=5)], ff_labels),
        "recurrent_attention": (
            jconfig.InputType.recurrent(4, 6), seq_x,
            [jatt.RecurrentAttentionLayer(n_out=UNITS), _rnn_out()],
            seq_labels),
        "time_distributed": (
            jconfig.InputType.recurrent(4, 6), seq_x,
            [jwrap.TimeDistributed(jcore.DenseLayer(n_out=UNITS,
                                                    activation="relu")),
             jwrap.MaskLayer(), jcore.MaskingLayer(), _rnn_out()],
            seq_labels),
        "repeat_vector": (
            jconfig.InputType.feed_forward(4),
            lambda rng, b: rng.standard_normal((b, 4)).astype(np.float32),
            [jwrap.RepeatVector(n=6), jrec.LSTM(n_out=UNITS), _rnn_out()],
            seq_labels),
        "embedding": (
            jconfig.InputType.feed_forward(1),
            lambda rng, b: rng.integers(0, 7, (b, 1)).astype(np.float32),
            [jcore.EmbeddingLayer(n_in=7, n_out=UNITS),
             jcore.OutputLayer(n_out=5)], ff_labels),
        "embedding_sequence": (
            jconfig.InputType.recurrent(1, 6),
            lambda rng, b: rng.integers(0, 7, (b, 6, 1)).astype(np.float32),
            [jspecial.EmbeddingSequenceLayer(n_in=7, n_out=UNITS),
             jrec.LSTM(n_out=UNITS), _rnn_out()], seq_labels),
    }


ZIP_NETS = _zip_nets()


@pytest.mark.parametrize("name", list(ZIP_NETS))
def test_jax_zip_loads_in_the_port_and_back(tmp_path, name):
    in_type, make_x, layers, make_y = ZIP_NETS[name]
    jnet = JMLN(jconfig.NeuralNetConfiguration.builder().seed(4)
                .updater(JAdam(learning_rate=1e-2)).input_type(in_type)
                .list(*layers).build()).init()
    rng = np.random.default_rng(11)
    x, y = make_x(rng, 3), make_y(rng, 3)
    jnet.fit(JDataSet(x, y))
    path = str(tmp_path / "jax.zip")
    jnet.save(path)
    pnet = MultiLayerNetwork.load(path, device="cpu")
    assert pnet.conf.to_json() == jnet.conf.to_json()
    _tree_close(pnet.params, jnet.params, "params", rtol=0, atol=0)
    _tree_close(pnet.updater_state, jnet.updater_state, "updater",
                rtol=0, atol=0)
    xp = make_x(rng, 2)
    np.testing.assert_allclose(pnet.output(xp), np.asarray(jnet.output(xp)),
                               **TOL)
    # the port's ZIP (after one more step on each side) loads in JAX
    pnet.fit(DataSet(x, y))
    jnet.fit(JDataSet(x, y))
    back = str(tmp_path / "port.zip")
    pnet.save(back)
    jback = JMLN.load(back)
    _tree_close(jback.params, pnet.params, "params back", rtol=0, atol=0)
    _tree_close(jback.updater_state, pnet.updater_state, "updater back",
                rtol=0, atol=0)
    _tree_close(pnet.params, jnet.params, "second step", **PARAM_TOL)
    np.testing.assert_allclose(np.asarray(jback.output(xp)), pnet.output(xp),
                               **TOL)


def test_from_numpy_carries_nested_trees():
    in_type, make_x, layers, _ = ZIP_NETS["bidirectional_graves"]
    jnet = JMLN(jconfig.NeuralNetConfiguration.builder()
                .updater(JAdam(learning_rate=1e-2)).input_type(in_type)
                .list(*layers).build()).init()
    p, s, u = from_numpy(_np(jnet.params), _np(jnet.state), device="cpu",
                         updater_state=_np(jnet.updater_state))
    assert set(p["0"]) == {"fw", "bw"}
    assert set(p["0"]["fw"]) == {"W", "RW", "PW", "b"}
    assert p["0"]["fw"]["PW"].shape == (3, UNITS)
    assert set(u) == {"m", "v"} and set(u["m"]["0"]) == {"fw", "bw"}


# ------------------------------------------------------------- the zoo

def test_text_generation_lstm_with_embedding_matches_jax():
    pnet = text_generation_lstm(vocab_size=VOCAB, embedding=8, units=UNITS)
    jnet = jtgl(vocab_size=VOCAB, embedding=8, units=UNITS).init()
    assert pnet.conf.to_json() == jnet.conf.to_json()
    assert [l.kind for l in pnet.layers] == [
        "embedding_sequence", "lstm", "lstm", "rnn_output"]
    pnet = _port_mln(jnet)
    rng = np.random.default_rng(12)
    ids = rng.integers(0, VOCAB, (B, T + 1))
    x = ids[:, :-1, None].astype(np.float32)
    y = np.eye(VOCAB, dtype=np.float32)[ids[:, 1:]]
    np.testing.assert_allclose(pnet.output(x), np.asarray(jnet.output(x)),
                               **TOL)
    jnet.fit(JDataSet(x, y))
    pnet.fit(DataSet(x, y))
    np.testing.assert_allclose(pnet.score(), float(jnet.score()),
                               rtol=LOSS_RTOL)
    _tree_close(pnet.params, jnet.params, "after one step", **PARAM_TOL)
