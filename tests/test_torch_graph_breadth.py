"""The ComputationGraph main path's breadth against the JAX package, on the
CPU: ``evaluate`` (equal ``Evaluation.stats()`` and confusion matrices),
training-mode ``output`` (batch statistics equal to JAX's; dropout by
distribution), ``summary`` (the same text), the builder's ``layer``
alias, and ``params_flat`` / ``set_params_flat`` on both engines: the
port's vector is the JAX package's, element for element, and each loads
the other's.

Both nets are built by each package's own builder from the same
description and the port takes the JAX net's weights (``from_numpy``).
Flat vectors are compared exactly (the same numbers in the same order);
forward outputs to rtol 1e-5, atol 1e-5 (float32 BN moments summed in
another order, as in ``tests/test_torch_training.py``)."""

import types

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.data import dataset as jds
from deeplearning4j_tpu.nn import config as jconfig
from deeplearning4j_tpu.nn import updaters as jupd
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.layers import conv as jconv
from deeplearning4j_tpu.nn.layers import core as jcore
from deeplearning4j_tpu.nn.layers import recurrent as jrec
from deeplearning4j_tpu.nn.model import MultiLayerNetwork as JNet
from deeplearning4j_tpu_torch.data import dataset as pds
from deeplearning4j_tpu_torch.nn import config as pconfig
from deeplearning4j_tpu_torch.nn import updaters as pupd
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph as PGraph
from deeplearning4j_tpu_torch.nn.layers import conv as pconv
from deeplearning4j_tpu_torch.nn.layers import core as pcore
from deeplearning4j_tpu_torch.nn.layers import recurrent as prec
from deeplearning4j_tpu_torch.nn.model import MultiLayerNetwork as PNet
from deeplearning4j_tpu_torch.utils.convert import from_numpy

J = types.SimpleNamespace(conf=jconfig, core=jcore, conv=jconv, rec=jrec,
                          upd=jupd, Net=JNet, Graph=JGraph)
P = types.SimpleNamespace(conf=pconfig, core=pcore, conv=pconv, rec=prec,
                          upd=pupd, Net=PNet, Graph=PGraph)
CLOSE = dict(rtol=1e-5, atol=1e-5)


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


def _pair(build):
    jnet = build(J).init()
    pnet = build(P).init(device="cpu")
    pnet.params, pnet.state = from_numpy(jnet.params, jnet.state, "cpu")
    return jnet, pnet


def _conv_graph(ns, dropout=None, alias=False):
    """conv -> BN -> relu -> [dropout] -> pool -> output, NHWC."""
    g = (ns.conf.NeuralNetConfiguration.builder().seed(3)
         .updater(ns.upd.Adam(learning_rate=0.01))
         .graph_builder().add_inputs("in")
         .set_input_types(ns.conf.InputType.convolutional(
             3, 6, 6, data_format="NHWC")))
    add = g.layer if alias else g.add_layer
    add("c", ns.conv.ConvolutionLayer(n_out=5, kernel=(3, 3),
                                      padding=(1, 1), data_format="NHWC"),
        "in")
    add("bn", ns.conv.BatchNormalization(data_format="NHWC"), "c")
    add("r", ns.core.ActivationLayer(activation="relu"), "bn")
    top = "r"
    if dropout is not None:
        add("drop", ns.core.DropoutLayer(rate=dropout), "r")
        top = "drop"
    add("pool", ns.conv.GlobalPoolingLayer(pool_type="avg",
                                           data_format="NHWC"), top)
    add("out", ns.core.OutputLayer(n_out=4), "pool")
    return ns.Graph(g.set_outputs("out").build())


def _images(n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 6, 6, 3)).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[rng.integers(0, 4, n)]
    return x, y


# -------------------------------------------------------------- evaluate

def test_evaluate_gives_jax_stats():
    jnet, pnet = _pair(_conv_graph)
    x, y = _images(40, seed=1)
    jev = jnet.evaluate(jds.NumpyDataSetIterator(x, y, batch_size=16))
    pev = pnet.evaluate(pds.NumpyDataSetIterator(x, y, batch_size=16))
    np.testing.assert_array_equal(pev.confusion, jev.confusion)
    assert pev.stats() == jev.stats()
    assert pev.accuracy() == jev.accuracy()


def test_evaluate_takes_arrays_and_a_multi_output_index():
    def two_heads(ns):
        g = (ns.conf.NeuralNetConfiguration.builder().seed(4)
             .graph_builder().add_inputs("in")
             .set_input_types(ns.conf.InputType.feed_forward(5)))
        g.add_layer("d", ns.core.DenseLayer(n_out=6, activation="tanh"),
                    "in")
        g.add_layer("o1", ns.core.OutputLayer(n_out=3), "d")
        g.add_layer("o2", ns.core.OutputLayer(n_out=2), "d")
        return ns.Graph(g.set_outputs("o1", "o2").build())

    jnet, pnet = _pair(two_heads)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((12, 5)).astype(np.float32)
    y1 = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 12)]
    y2 = np.eye(2, dtype=np.float32)[rng.integers(0, 2, 12)]
    for k in (0, 1):
        jev = jnet.evaluate([x], [y1, y2], output=k)
        pev = pnet.evaluate([x], [y1, y2], output=k)
        np.testing.assert_array_equal(pev.confusion, jev.confusion)
        assert pev.stats() == jev.stats()


# ------------------------------------------------- training-mode output

def test_training_output_uses_batch_statistics_like_jax():
    jnet, pnet = _pair(_conv_graph)
    x, _ = _images(8, seed=3)
    got = pnet.output(x, train=True)
    np.testing.assert_allclose(got, np.asarray(jnet.output(x, train=True)),
                               **CLOSE)
    # and differs from inference (running statistics, softmax)
    assert np.abs(got - pnet.output(x)).max() > 1e-3
    # the layer state is left as it was
    for k in ("mean", "var"):
        np.testing.assert_array_equal(pnet.state["bn"][k].numpy(),
                                      np.asarray(jnet.state["bn"][k]))


def _dropout_graph(ns):
    g = (ns.conf.NeuralNetConfiguration.builder().seed(5)
         .graph_builder().add_inputs("in")
         .set_input_types(ns.conf.InputType.feed_forward(4000)))
    g.add_layer("drop", ns.core.DropoutLayer(rate=0.3), "in")
    g.add_layer("out", ns.core.LossLayer(loss="mse"), "drop")
    return ns.Graph(g.set_outputs("out").build())


def test_training_output_drops_like_jax_by_distribution():
    """A constant input through DropoutLayer(rate 0.3): the share dropped
    within 4 standard errors of 0.3 in both packages, the kept values
    scaled by 1 / 0.7 in both, two calls drawing different masks (the
    model's generator advances), and inference the identity."""
    jnet, pnet = _pair(_dropout_graph)
    x = np.ones((4, 4000), np.float32)
    p1, p2 = pnet.output(x, train=True), pnet.output(x, train=True)
    j1 = np.asarray(jnet.output(x, train=True))
    bound = 4 * np.sqrt(0.3 * 0.7 / x.size)
    for out in (p1, j1):
        assert abs((out == 0).mean() - 0.3) < bound
        np.testing.assert_allclose(out[out != 0], 1 / 0.7, rtol=1e-6)
    assert not np.array_equal(p1, p2)
    np.testing.assert_array_equal(pnet.output(x), x)


# ------------------------------------------------------- summary, alias

def test_summary_is_the_jax_text():
    jnet, pnet = _pair(lambda ns: _conv_graph(ns, dropout=0.2))
    assert pnet.summary() == jnet.summary()
    assert pnet.summary().splitlines()[-1] == \
        f"total params: {pnet.num_params()}"


def test_builder_layer_alias_builds_the_same_configuration():
    assert _conv_graph(P, alias=True).conf.to_json() == \
        _conv_graph(P).conf.to_json() == _conv_graph(J).conf.to_json()


# ------------------------------------------------------------ params_flat

def _lstm_graph(ns):
    """Every parameter-name order the flat view sorts: W, RW, b (LSTM),
    a Bidirectional's fw/bw trees, gamma/beta, an OIHW conv kernel."""
    g = (ns.conf.NeuralNetConfiguration.builder().seed(6)
         .graph_builder().add_inputs("seq", "img")
         .set_input_types(ns.conf.InputType.recurrent(3, 5),
                          ns.conf.InputType.convolutional(
                              2, 4, 4, data_format="NHWC")))
    g.add_layer("lstm", ns.rec.LSTM(n_out=4), "seq")
    g.add_layer("bi", ns.rec.Bidirectional(
        layer=ns.rec.LSTM(n_out=2), mode="concat"), "lstm")
    g.add_layer("last", ns.rec.LastTimeStep(), "bi")
    g.add_layer("c", ns.conv.ConvolutionLayer(n_out=3, kernel=(2, 2),
                                              data_format="NHWC"), "img")
    g.add_layer("bn", ns.conv.BatchNormalization(data_format="NHWC"), "c")
    g.add_layer("pool", ns.conv.GlobalPoolingLayer(pool_type="max",
                                                   data_format="NHWC"), "bn")
    g.add_layer("o1", ns.core.OutputLayer(n_out=2), "last")
    g.add_layer("o2", ns.core.OutputLayer(n_out=2), "pool")
    return ns.Graph(g.set_outputs("o1", "o2").build())


def _mln(ns):
    return ns.Net(
        ns.conf.NeuralNetConfiguration.builder().seed(8)
        .input_type(ns.conf.InputType.convolutional(1, 6, 6))
        .list(ns.conv.ConvolutionLayer(n_out=3, kernel=(3, 3)),
              ns.conv.BatchNormalization(),
              ns.core.DenseLayer(n_out=5),
              ns.core.OutputLayer(n_out=2)).build())


@pytest.mark.parametrize("build", [_lstm_graph, _conv_graph, _mln],
                         ids=["graph-recurrent", "graph-conv", "mln"])
def test_params_flat_is_the_jax_vector_both_ways(build):
    jnet, pnet = _pair(build)
    vec = pnet.params_flat()
    jvec = np.asarray(jnet.params_flat())
    assert vec.dtype == jvec.dtype and vec.shape == (pnet.num_params(),)
    np.testing.assert_array_equal(vec, jvec)
    # a JAX vector loads in the port, a port vector in JAX
    new = np.random.default_rng(9).standard_normal(vec.size).astype(
        np.float32)
    pnet.set_params_flat(new)
    jnet.set_params_flat(pnet.params_flat())
    np.testing.assert_array_equal(np.asarray(jnet.params_flat()), new)
    back = build(P).init(device="cpu").set_params_flat(jnet.params_flat())
    np.testing.assert_array_equal(back.params_flat(), new)
    for k, tree in jnet.params.items():
        for name, a in tree.items():
            if not isinstance(a, dict):
                np.testing.assert_array_equal(back.params[k][name].numpy(),
                                              np.asarray(a))
    with pytest.raises(ValueError, match="param vector length"):
        pnet.set_params_flat(new[:-1])
