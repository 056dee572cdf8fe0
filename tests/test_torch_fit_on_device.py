"""``fit_on_device`` in the port, on both engines, on the CPU: bit for
bit the per-batch ``fit`` (dropout from the model's generator included,
the sentinel's verdict kept on the device), the JAX package's
``fit_on_device`` from the same weights (the JAX
``tests/test_fit_on_device.py`` nets, :32-72 and :136), several inputs
and outputs, a bf16 network through the fused master-cast updater, a
non-finite batch skipped without a host read, and the ragged tail.

Tolerances: against ``fit``, bit for bit; against the JAX package, losses,
params and BN statistics within 1e-5 (float32 sums in other orders)."""

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn import updaters as jupd
from deeplearning4j_tpu.nn.config import InputType as JInputType
from deeplearning4j_tpu.nn.config import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.layers import conv as jconv
from deeplearning4j_tpu.nn.layers import core as jcore
from deeplearning4j_tpu.nn.model import MultiLayerNetwork as JMLN
from deeplearning4j_tpu_torch.nn import updaters as upd
from deeplearning4j_tpu_torch.nn.config import InputType, NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.layers import conv, core
from deeplearning4j_tpu_torch.nn.model import MultiLayerNetwork
from deeplearning4j_tpu_torch.utils.convert import from_numpy

J = (JConf, JInputType, jcore, jconv, jupd)
P = (NeuralNetConfiguration, InputType, core, conv, upd)
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


def _graph_conf(m, dropout=False, dtype="FLOAT"):
    conf, it, cr, cv, up = m
    g = (conf.builder().seed(7).data_type(dtype)
         .updater(up.Sgd(learning_rate=0.05)).graph_builder()
         .add_inputs("in")
         .set_input_types(it.convolutional(3, 8, 8, data_format="NHWC"))
         .add_layer("c", cv.ConvolutionLayer(n_out=4, kernel=(3, 3),
                                             mode="same", activation="relu",
                                             data_format="NHWC"), "in")
         .add_layer("bn", cv.BatchNormalization(data_format="NHWC"), "c"))
    last = "bn"
    if dropout:
        g = g.add_layer("drop", cr.DropoutLayer(rate=0.3), "bn")
        last = "drop"
    return (g.add_layer("out", cr.OutputLayer(n_out=3), last)
            .set_outputs("out").build())


def _mln_conf(m, dropout=False, dtype="FLOAT"):
    conf, it, cr, cv, up = m
    layers = [cv.ConvolutionLayer(n_out=4, kernel=(3, 3), mode="same",
                                  activation="relu", data_format="NHWC"),
              cv.BatchNormalization(data_format="NHWC")]
    if dropout:
        layers.append(cr.DropoutLayer(rate=0.3))
    layers.append(cr.OutputLayer(n_out=3))
    return (conf.builder().seed(21).data_type(dtype)
            .updater(up.Adam(learning_rate=1e-2))
            .input_type(it.convolutional(3, 8, 8, data_format="NHWC"))
            .list(*layers).build())


def _port(engine, **kw):
    if engine == "sequential":
        return MultiLayerNetwork(_mln_conf(P, **kw)).init(device="cpu")
    return ComputationGraph(_graph_conf(P, **kw)).init(device="cpu")


def _data(n=12, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 8, 8, 3)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, n)]
    return x, y


def _leaves(tree):
    return jax.tree.leaves(tree)


def _same(a, b):
    la, lb = _leaves(a), _leaves(b)
    return len(la) == len(lb) and all(torch.equal(p, q)
                                      for p, q in zip(la, lb))


@pytest.mark.parametrize("dtype", ["FLOAT", "BFLOAT16"])
@pytest.mark.parametrize("engine", ["sequential", "graph"])
def test_fit_on_device_equals_per_batch_fit(engine, dtype):
    """Two epochs of three batches with dropout: the loss history equals
    the per-batch ``fit`` losses, and params, updater state, BN state,
    the generator and the counters are the same, bit for bit (a bf16
    net through the fused master-cast updater too)."""
    x, y = _data()
    a = _port(engine, dropout=True, dtype=dtype)
    b = _port(engine, dropout=True, dtype=dtype)
    losses = a.fit_on_device(x, y, epochs=2, batch_size=4)
    assert losses.shape == (6,) and losses.dtype == np.float32
    want = []
    for _ in range(2):
        for i in range(3):
            b.fit(x[4 * i:4 * i + 4], y[4 * i:4 * i + 4])
            want.append(b.score())
    np.testing.assert_array_equal(losses, np.array(want, np.float32))
    for ta, tb in ((a.params, b.params), (a.updater_state, b.updater_state),
                   (a.state, b.state)):
        assert _same(ta, tb)
    assert torch.equal(a._rng.get_state(), b._rng.get_state())
    assert a.iteration == b.iteration == 6 and a.epoch == 2
    assert a.score() == float(losses[-1])
    assert a.resilience_counters() == b.resilience_counters()
    if dtype == "BFLOAT16":
        assert a.fused_updater_active()
        assert all(t.dtype == torch.float32 for t in _leaves(a.params))


@pytest.mark.parametrize("engine", ["sequential", "graph"])
def test_fit_on_device_matches_jax(engine):
    """The JAX ``tests/test_fit_on_device.py`` nets (no dropout: the
    streams differ) from the same weights: the loss history, params and
    BN running statistics within 1e-5 of the JAX package's
    ``fit_on_device``."""
    x, y = _data()
    if engine == "sequential":
        jnet = JMLN(_mln_conf(J)).init()
    else:
        jnet = JGraph(_graph_conf(J)).init()
    net = _port(engine)
    net.params, net.state, net.updater_state = from_numpy(
        jax.tree.map(np.asarray, jnet.params),
        jax.tree.map(np.asarray, jnet.state), "cpu",
        updater_state=jax.tree.map(np.asarray, jnet.updater_state))
    want = jnet.fit_on_device(x, y, epochs=2, batch_size=4)
    got = net.fit_on_device(x, y, epochs=2, batch_size=4)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    for tree, jtree in ((net.params, jnet.params), (net.state, jnet.state)):
        got_l = jax.tree.leaves(jax.tree.map(lambda t: t.numpy(), tree))
        for g, w in zip(got_l, jax.tree.leaves(jtree)):
            np.testing.assert_allclose(g, np.asarray(w), **TOL)
    assert net.iteration == jnet.iteration == 6


def test_graph_several_inputs_and_outputs():
    """A two-input, two-output graph takes lists of arrays, as the JAX
    engine does, and equals its per-batch ``fit``."""
    def build():
        return ComputationGraph(
            NeuralNetConfiguration.builder().seed(2)
            .updater(upd.Adam(learning_rate=1e-2)).graph_builder()
            .add_inputs("a", "b")
            .set_input_types(InputType.feed_forward(5),
                             InputType.feed_forward(3))
            .add_layer("da", core.DenseLayer(n_out=6, activation="tanh"),
                       "a")
            .add_layer("db", core.DenseLayer(n_out=6, activation="tanh"),
                       "b")
            .add_layer("o1", core.OutputLayer(n_out=2), "da")
            .add_layer("o2", core.OutputLayer(n_out=3), "db")
            .set_outputs("o1", "o2").build()).init(device="cpu")
    rng = np.random.default_rng(4)
    xa = rng.normal(size=(8, 5)).astype(np.float32)
    xb = rng.normal(size=(8, 3)).astype(np.float32)
    y1 = np.eye(2, dtype=np.float32)[rng.integers(0, 2, 8)]
    y2 = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 8)]
    a, b = build(), build()
    losses = a.fit_on_device([xa, xb], [y1, y2], batch_size=4)
    want = []
    for i in range(2):
        s = slice(4 * i, 4 * i + 4)
        b.fit([xa[s], xb[s]], [y1[s], y2[s]])
        want.append(b.score())
    np.testing.assert_array_equal(losses, np.array(want, np.float32))
    assert _same(a.params, b.params)


def test_nonfinite_batch_is_skipped_on_the_device():
    """A batch with a NaN feature: the step is skipped by the device
    verdict (params, updater and BN state kept), the counters say so when
    read, and the next batch trains, as per-batch ``fit`` does."""
    x, y = _data()
    x[4:8] = np.nan
    a, b = _port("graph"), _port("graph")
    losses = a.fit_on_device(x, y, batch_size=4)
    for i in range(3):
        b.fit(x[4 * i:4 * i + 4], y[4 * i:4 * i + 4])
    assert np.isnan(losses[1]) and np.isfinite(losses[[0, 2]]).all()
    assert a.resilience_counters() == b.resilience_counters() == {
        "bad_total": 1, "bad_consec": 0, "clip_events": 0}
    assert _same(a.params, b.params) and _same(a.state, b.state)


@pytest.mark.parametrize("engine", ["sequential", "graph"])
def test_ragged_tail_raises_unless_dropped(engine):
    x, y = _data(10)
    net = _port(engine)
    with pytest.raises(ValueError, match="drop_remainder"):
        net.fit_on_device(x, y, batch_size=4)
    with pytest.raises(ValueError, match="exceeds dataset size"):
        net.fit_on_device(x, y, batch_size=11)
    assert net.iteration == 0
    losses = net.fit_on_device(x, y, batch_size=4, drop_remainder=True)
    assert losses.shape == (2,) and net.iteration == 2
