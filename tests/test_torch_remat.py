"""``workspace_mode`` rematerialization in the port (``nn/memory.py``,
``_forward_remat`` on both engines) against the JAX package on the CPU:
the policy registry and ``segment_ranges``, the builders' validation and
the JSON, every mode's loss and gradients bit for bit against ``none``'s
with dropout (the generator replayed in the recompute) and its ``fit``,
every mode's loss and gradients against the JAX package's remat loss,
and the residual bytes ``memory_report`` counts (the JAX
``tests/test_memory_remat.py`` cases, :121-200 and :356).

Tolerances: remat against ``none`` bit for bit; against the JAX package
1e-5 (float32 sums in other orders)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn import memory as jmem
from deeplearning4j_tpu.nn import updaters as jupd
from deeplearning4j_tpu.nn.config import InputType as JInputType
from deeplearning4j_tpu.nn.config import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.layers import conv as jconv
from deeplearning4j_tpu.nn.layers import core as jcore
from deeplearning4j_tpu.nn.model import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.nn import vertices as jvert
from deeplearning4j_tpu_torch.nn import memory as mem
from deeplearning4j_tpu_torch.nn import training
from deeplearning4j_tpu_torch.nn import updaters as upd
from deeplearning4j_tpu_torch.nn import vertices as vert
from deeplearning4j_tpu_torch.nn.config import (InputType,
                                                MultiLayerConfiguration,
                                                NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn.graph import (ComputationGraph,
                                               ComputationGraphConfiguration)
from deeplearning4j_tpu_torch.nn.layers import conv, core, recurrent
from deeplearning4j_tpu_torch.nn.model import MultiLayerNetwork
from deeplearning4j_tpu_torch.utils.convert import from_numpy

MODES = ("none", "full", "dots_saveable", "every_2", "enabled")
J = (JConf, JInputType, jcore, jconv, jupd, jvert)
P = (NeuralNetConfiguration, InputType, core, conv, upd, vert)


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


def _mln_conf(m, mode, dropout=True, bn=False):
    conf, it, cr, cv, up, _ = m
    layers = [cr.DenseLayer(n_out=24, activation="tanh")]
    if dropout:
        layers.append(cr.DropoutLayer(rate=0.25))
    if bn:
        layers.append(cv.BatchNormalization())
    layers += [cr.DenseLayer(n_out=24, activation="relu"),
               cr.DenseLayer(n_out=16, activation="tanh"),
               cr.OutputLayer(n_out=4)]
    return (conf.builder().seed(11).updater(up.Adam(learning_rate=1e-2))
            .input_type(it.feed_forward(8)).workspace_mode(mode)
            .list(*layers).build())


def _graph_conf(m, mode, dropout=True):
    conf, it, cr, cv, up, vt = m
    g = (conf.builder().seed(12).updater(up.Adam(learning_rate=1e-2))
         .workspace_mode(mode).graph_builder().add_inputs("in")
         .set_input_types(it.feed_forward(8))
         .add_layer("d1", cr.DenseLayer(n_out=16, activation="tanh"), "in"))
    prev = "d1"
    if dropout:
        g = g.add_layer("drop", cr.DropoutLayer(rate=0.25), "d1")
        prev = "drop"
    return (g.add_layer("d2", cr.DenseLayer(n_out=16, activation="tanh"),
                        prev)
            .add_layer("bn", cv.BatchNormalization(), "d2")
            .add_layer("d3", cr.DenseLayer(n_out=16, activation="relu"),
                       "bn")
            .add_vertex("res", vt.ElementWiseVertex(op="add"), "d1", "d3")
            .add_layer("out", cr.OutputLayer(n_out=4), "res")
            .set_outputs("out").build())


def _data(n=64, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 8)).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[rng.integers(0, 4, n)]
    return x, y


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port(engine, mode, dropout=True, bn=False):
    if engine == "sequential":
        return MultiLayerNetwork(_mln_conf(P, mode, dropout, bn)).init(
            device="cpu")
    return ComputationGraph(_graph_conf(P, mode, dropout)).init(
        device="cpu")


def _loss_fn(net):
    """``(params, x, y, rng) -> (loss, new_state)`` of either engine."""
    if isinstance(net, MultiLayerNetwork):
        f = net._build_loss_fn()
        return lambda p, x, y, rng: f(p, net.state, x, y, None, None, rng)
    return lambda p, x, y, rng: net._loss(p, net.state, (x,), (y,),
                                          (None,), (None,), rng)


def _equal_trees(a, b):
    la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
    return len(la) == len(lb) and all(torch.equal(p, q)
                                      for p, q in zip(la, lb))


# ---------------------------------------------------------- the registry

@pytest.mark.parametrize("mode", [None, "", "none", "NONE", "full", "FULL",
                                  "enabled", "dots_saveable", "every_1",
                                  "every_3", "Every_12"])
def test_policy_registry_matches_jax(mode):
    got, want = mem.resolve_policy(mode), jmem.resolve_policy(mode)
    assert (got.name, got.remat, got.every) == \
        (want.name, want.remat, want.every)
    assert (got.saveable is None) == (want.saveable is None)
    assert mem.workspace_modes() == jmem.workspace_modes()


@pytest.mark.parametrize("bad", ["bogus", "every_0", "every_x", "every_",
                                 "every_-1"])
def test_unknown_modes_raise_in_both(bad):
    with pytest.raises(ValueError):
        jmem.resolve_policy(bad)
    with pytest.raises(ValueError, match="unknown workspace_mode"):
        mem.resolve_policy(bad)


@pytest.mark.parametrize("n,every", [(5, 2), (3, 1), (0, 4), (7, 3),
                                     (4, 9), (6, 0)])
def test_segment_ranges_match_jax(n, every):
    assert mem.segment_ranges(n, every) == jmem.segment_ranges(n, every)


def test_builders_validate_and_json_keeps_mode():
    for builder in (NeuralNetConfiguration.builder(),
                    JConf.builder()):
        with pytest.raises(ValueError):
            builder.workspace_mode("bogus")
    conf = _mln_conf(P, "every_2")
    assert MultiLayerConfiguration.from_json(
        conf.to_json()).workspace_mode == "every_2"
    assert json.loads(conf.to_json())["workspace_mode"] == \
        json.loads(_mln_conf(J, "every_2").to_json())["workspace_mode"]
    gconf = _graph_conf(P, "dots_saveable")
    assert ComputationGraphConfiguration.from_json(
        gconf.to_json()).workspace_mode == "dots_saveable"
    with pytest.raises(ValueError):
        ComputationGraphConfiguration.from_json(
            gconf.to_json().replace("dots_saveable", "bogus"))
    net = _port("sequential", "none")
    assert net.set_workspace_mode("ENABLED").conf.workspace_mode == "full"
    with pytest.raises(ValueError):
        net.set_workspace_mode("every_0")
    g = _port("graph", "none")
    old = g.conf
    assert g.set_workspace_mode("every_3").conf.workspace_mode == "every_3"
    assert old.workspace_mode == "none"  # copy on write


# --------------------------------------------------- bit for bit vs none

@pytest.mark.parametrize("mode", MODES[1:])
@pytest.mark.parametrize("engine", ["sequential", "graph"])
def test_remat_loss_and_grads_bitwise_with_dropout(engine, mode):
    """Remat on and off give the same loss, gradients and BN state bit
    for bit with dropout drawing from a seeded generator (the recompute
    replays it), and leave the generator where the plain walk does."""
    ref, net = _port(engine, "none"), _port(engine, mode)
    x, y = (torch.from_numpy(a) for a in _data())
    outs, gens = [], []
    for m in (ref, net):
        gen = torch.Generator().manual_seed(5)
        f = _loss_fn(m)
        loss, grads, st = training.value_and_grad(
            m.params, lambda p: f(p, x, y, gen))
        outs.append((loss, grads, st))
        gens.append(gen.get_state())
    assert torch.equal(outs[0][0], outs[1][0])
    assert _equal_trees(outs[0][1], outs[1][1])
    assert _equal_trees(outs[0][2], outs[1][2])
    assert torch.equal(gens[0], gens[1])


@pytest.mark.parametrize("mode", MODES[1:])
@pytest.mark.parametrize("engine", ["sequential", "graph"])
def test_remat_fit_bitwise_with_dropout(engine, mode):
    """Three ``fit`` steps (dropout from the model's generator) and a
    ``fit_on_device`` epoch: losses, params, Adam and BN state bit for
    bit against ``none``."""
    x, y = _data()
    ref, net = _port(engine, "none", bn=True), _port(engine, mode, bn=True)
    for _ in range(3):
        ref.fit(x, y)
        net.fit(x, y)
        assert ref.score() == net.score()
    np.testing.assert_array_equal(
        ref.fit_on_device(x, y, batch_size=16),
        net.fit_on_device(x, y, batch_size=16))
    for a, b in ((ref.params, net.params), (ref.state, net.state),
                 (ref.updater_state, net.updater_state)):
        assert _equal_trees(a, b)


@pytest.mark.parametrize("mode", MODES[1:])
@pytest.mark.parametrize("engine", ["sequential", "graph"])
def test_remat_matches_jax_remat_loss(engine, mode):
    """Every mode's loss, gradients and BN state (dropout off: the JAX
    loss with no key, the port's with no generator) within 1e-5 of the
    JAX package's remat loss from the same weights."""
    if engine == "sequential":
        jnet = JMLN(_mln_conf(J, mode, bn=True)).init()
        net = _port(engine, mode, bn=True)
    else:
        jnet = JGraph(_graph_conf(J, mode)).init()
        net = _port(engine, mode)
    net.params, net.state = from_numpy(_np(jnet.params), _np(jnet.state),
                                       "cpu")
    x, y = _data()
    jf = jnet._build_loss_fn()
    if engine == "sequential":
        jargs = (jnp.asarray(x), jnp.asarray(y), None, None)
    else:
        jargs = ((jnp.asarray(x),), (jnp.asarray(y),), (None,), (None,))
    (jloss, jst), jg = jax.value_and_grad(
        lambda p: jf(p, jnet.state, None, *jargs), has_aux=True)(
        jnet.params)
    f = _loss_fn(net)
    loss, grads, st = training.value_and_grad(
        net.params, lambda p: f(p, torch.from_numpy(x), torch.from_numpy(y),
                                None))
    close = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(loss), float(jloss), **close)
    for tree, want in ((grads, jg), (st, jst)):
        got = jax.tree.map(lambda t: t.detach().numpy(), tree)
        for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(_np(want))):
            np.testing.assert_allclose(g, w, **close)


# ------------------------------------------------------ residual bytes

def _lstm_conf(mode):
    return (NeuralNetConfiguration.builder().seed(3)
            .updater(upd.Adam(learning_rate=1e-2))
            .input_type(InputType.recurrent(6, 12)).workspace_mode(mode)
            .list(recurrent.LSTM(n_out=16),
                  recurrent.RnnOutputLayer(n_out=4)).build())


def test_residual_bytes_fall_under_remat():
    """``memory_report`` counts the forward-to-backward residuals. Torch
    already keeps only what each op's backward reads, so on the JAX test's
    dense nets a one-layer segment keeps about what the plain walk keeps
    (``full`` is no worse), and segments of two layers cut the activation
    bytes by more than 30% (the JAX acceptance bar); where a layer has
    internals of its own (an LSTM's gates at every step), ``full`` cuts
    them by more than 30% too. The compiled fields are None on the CPU."""
    for build in ((lambda m: MultiLayerNetwork(_mln_conf(P, m, False))),
                  (lambda m: ComputationGraph(_graph_conf(P, m, False)))):
        r = {m: build(m).init(device="cpu").memory_report(64)
             for m in ("none", "full", "every_2")}
        assert r["none"]["activation_bytes"] > 0
        assert r["full"]["activation_bytes"] <= \
            r["none"]["activation_bytes"]
        assert r["every_2"]["activation_bytes"] < \
            0.7 * r["none"]["activation_bytes"]
        assert r["full"]["residual_count"] > 0
    rep = {m: MultiLayerNetwork(_lstm_conf(m)).init(
        device="cpu").memory_report(8) for m in ("none", "full")}
    assert rep["full"]["activation_bytes"] < \
        0.7 * rep["none"]["activation_bytes"]
    r0 = rep["none"]
    assert r0["workspace_mode"] == "none" and r0["batch_size"] == 8
    for k in ("temp_bytes", "argument_bytes", "output_bytes",
              "alias_bytes", "generated_code_bytes", "peak_bytes",
              "device"):
        assert r0[k] is None
    assert r0["residual_bytes"] >= r0["activation_bytes"]
    with pytest.raises(ValueError, match="not divisible"):
        MultiLayerNetwork(_lstm_conf("none")).init(
            device="cpu").memory_report(6, accum_steps=4)
