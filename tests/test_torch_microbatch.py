"""Micro-batch accumulation in the port (``nn/microbatch.py``,
``_build_train_step(accum_steps=k)`` on both engines) against the JAX
package's on the CPU: the accumulated step from the same weights, one
accumulated step against one step at the whole batch on a net without
BatchNormalization (the JAX ``tests/test_shard_update.py`` cases), the
indivisible batch, the multi-output weight that never drops a fully
masked output, and the bf16 cast hoist bit for bit against no hoist.

Tolerances: against the JAX package and against the whole-batch step,
losses and params within 1e-5 (float32 sums of the same terms in other
orders); the hoist, bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn import microbatch as jmicro
from deeplearning4j_tpu.nn import updaters as jupd
from deeplearning4j_tpu.nn.config import InputType as JInputType
from deeplearning4j_tpu.nn.config import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.layers import conv as jconv
from deeplearning4j_tpu.nn.layers import core as jcore
from deeplearning4j_tpu.nn.model import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.nn import vertices as jvert
from deeplearning4j_tpu_torch.nn import microbatch as micro
from deeplearning4j_tpu_torch.nn import updaters as upd
from deeplearning4j_tpu_torch.nn import vertices as vert
from deeplearning4j_tpu_torch.nn.config import InputType, NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.layers import conv, core
from deeplearning4j_tpu_torch.nn.model import MultiLayerNetwork
from deeplearning4j_tpu_torch.utils.convert import from_numpy

TOL = dict(rtol=1e-5, atol=1e-5)
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


def _mln_conf(m, bn=True, dtype="FLOAT"):
    conf, it, cr, cv, up, _ = m
    layers = [cr.DenseLayer(n_out=16, activation="tanh")]
    if bn:
        layers.append(cv.BatchNormalization())
    layers += [cr.DenseLayer(n_out=16, activation="relu"),
               cr.OutputLayer(n_out=4)]
    return (conf.builder().seed(11).data_type(dtype)
            .updater(up.Adam(learning_rate=1e-2))
            .input_type(it.feed_forward(8)).list(*layers).build())


def _graph_conf(m, bn=True):
    conf, it, cr, cv, up, vt = m
    g = (conf.builder().seed(12).updater(up.Adam(learning_rate=1e-2))
         .graph_builder().add_inputs("in")
         .set_input_types(it.feed_forward(8))
         .add_layer("d1", cr.DenseLayer(n_out=16, activation="tanh"), "in"))
    last = "d1"
    if bn:
        g = g.add_layer("bn", cv.BatchNormalization(), "d1")
        last = "bn"
    return (g.add_layer("d2", cr.DenseLayer(n_out=16, activation="tanh"),
                        last)
            .add_vertex("res", vt.ElementWiseVertex(op="add"), "d1", "d2")
            .add_layer("out", cr.OutputLayer(n_out=4), "res")
            .set_outputs("out").build())


def _data(n=64, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 8)).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[rng.integers(0, 4, n)]
    return x, y


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _pair(engine, bn=True):
    if engine == "sequential":
        jnet = JMLN(_mln_conf(J, bn)).init()
        net = MultiLayerNetwork(_mln_conf(P, bn)).init(device="cpu")
    else:
        jnet = JGraph(_graph_conf(J, bn)).init()
        net = ComputationGraph(_graph_conf(P, bn)).init(device="cpu")
    net.params, net.state, net.updater_state = from_numpy(
        _np(jnet.params), _np(jnet.state), "cpu",
        updater_state=_np(jnet.updater_state))
    return jnet, net


def _batch(engine, x, y, lm=None):
    t = [torch.from_numpy(a) if a is not None else None for a in (x, y, lm)]
    if engine == "sequential":
        return (t[0], t[1], None, t[2])
    return ((t[0],), (t[1],), (None,), (t[2],))


def _jbatch(engine, x, y, lm=None):
    j = [jnp.asarray(a) if a is not None else None for a in (x, y, lm)]
    if engine == "sequential":
        return (j[0], j[1], None, j[2])
    return ((j[0],), (j[1],), (None,), (j[2],))


def _assert_trees(port, jax_tree, **tol):
    got = jax.tree.map(lambda t: t.detach().numpy(), port)
    want = _np(jax_tree)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(g, w, **tol)


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("engine", ["sequential", "graph"])
def test_accum_matches_jax(engine, masked, k):
    """Two accumulated steps from the same weights (BN running statistics
    threading through the microbatches; a label mask weighting them):
    losses, params, Adam state and BN state within 1e-5 of the JAX
    package's ``_build_train_step(accum_steps=k)``."""
    jnet, net = _pair(engine)
    jstep = jnet._build_train_step(accum_steps=k)
    step = net._build_train_step(accum_steps=k)
    p, o, s = jnet.params, jnet.updater_state, jnet.state
    for i in range(2):
        x, y = _data(32, seed=i)
        lm = None
        if masked:
            lm = (np.random.default_rng(9 + i).random(32) > 0.4).astype(
                np.float32)
            lm[:32 // k] = 0.0  # one microbatch holds no labels
        p, o, s, jloss = jstep(p, o, s, jnp.int32(i),
                               jax.random.PRNGKey(i),
                               *_jbatch(engine, x, y, lm))
        loss = step(*_batch(engine, x, y, lm))
        net.iteration += 1
        np.testing.assert_allclose(float(loss), float(jloss), **TOL)
    _assert_trees(net.params, p, **TOL)
    _assert_trees(net.updater_state, o, **TOL)
    _assert_trees(net.state, s, **TOL)


@pytest.mark.parametrize("engine", ["sequential", "graph"])
def test_accum_matches_one_full_batch_step(engine):
    """Without BatchNormalization, ``accum_steps=4`` on microbatches of
    B/4 is one step at batch B: the mean of equal-size microbatch
    gradients is the whole batch's."""
    _, ref = _pair(engine, bn=False)
    _, net = _pair(engine, bn=False)
    x, y = _data(64)
    whole = ref._build_train_step()
    acc = net._build_train_step(accum_steps=4)
    for _ in range(2):
        np.testing.assert_allclose(float(acc(*_batch(engine, x, y))),
                                   float(whole(*_batch(engine, x, y))),
                                   **TOL)
        ref.iteration += 1
        net.iteration += 1
    for tree, want in ((net.params, ref.params),
                       (net.updater_state, ref.updater_state)):
        _assert_trees(tree, jax.tree.map(lambda t: t.numpy(), want),
                      rtol=0, atol=1e-5)


def test_indivisible_batch_raises():
    x = torch.zeros(10, 3)
    with pytest.raises(ValueError, match="not divisible by accum_steps=4"):
        micro.split_microbatches((x, None), 4)
    with pytest.raises(ValueError, match="not divisible"):
        jmicro.split_microbatches((jnp.zeros((10, 3)),), 4)
    _, net = _pair("sequential")
    x, y = _data(10)
    with pytest.raises(ValueError, match="not divisible by accum_steps=4"):
        net._build_train_step(accum_steps=4)(*_batch("sequential", x, y))
    parts = micro.split_microbatches((torch.arange(12).reshape(6, 2),
                                      (None, torch.arange(6))), 3)
    assert len(parts) == 3 and parts[1][1][0] is None
    assert parts[2][0].tolist() == [[8, 9], [10, 11]]


def test_weights_match_jax():
    lm = np.array([1, 0, 1, 1, 0, 0], np.float32)
    ys = (np.zeros((6, 3), np.float32), np.zeros((6, 2), np.float32))
    assert micro.label_count_weight(None) is None
    assert float(micro.label_count_weight(torch.from_numpy(lm))) == \
        float(jmicro.label_count_weight(jnp.asarray(lm)))
    for lms in ((None, None), (lm, None), (lm, lm), (np.zeros(6,
                                                              np.float32),
                                                     None)):
        want = jmicro.multi_output_weight(
            None, tuple(map(jnp.asarray, ys)), None,
            tuple(None if m is None else jnp.asarray(m) for m in lms))
        got = micro.multi_output_weight(
            None, tuple(map(torch.from_numpy, ys)), None,
            tuple(None if m is None else torch.from_numpy(m) for m in lms))
        assert (got is None) == (want is None)
        if got is not None:
            assert float(got) == float(want)


def _two_heads(m):
    conf, it, cr, _, up, _ = m
    return (conf.builder().seed(5).updater(up.Adam(learning_rate=1e-2))
            .graph_builder().add_inputs("in")
            .set_input_types(it.feed_forward(8))
            .add_layer("d1", cr.DenseLayer(n_out=16, activation="tanh"),
                       "in")
            .add_layer("outA", cr.OutputLayer(n_out=4), "d1")
            .add_layer("outB", cr.OutputLayer(n_out=4), "d1")
            .set_outputs("outA", "outB").build())


def test_multi_output_fully_masked_output_not_dropped():
    """Output A fully masked, output B not: the weight sums the counts
    over both outputs, so B's rows keep their weight and the accumulated
    step equals the whole-batch step (JAX ``tests/test_shard_update.py``
    :304), and the JAX package's accumulated step."""
    jnet = JGraph(_two_heads(J)).init()
    nets = [ComputationGraph(_two_heads(P)).init(device="cpu")
            for _ in range(2)]
    for n in nets:
        n.params, n.state, n.updater_state = from_numpy(
            _np(jnet.params), _np(jnet.state), "cpu",
            updater_state=_np(jnet.updater_state))
    x, ya = _data(32)
    _, yb = _data(32, seed=1)
    mask_a = np.zeros((32,), np.float32)
    batch = ((torch.from_numpy(x),), (torch.from_numpy(ya),
                                      torch.from_numpy(yb)), (None,),
             (torch.from_numpy(mask_a), None))
    ref, net = nets
    init_b = net.params["outB"]["W"].clone()
    for _ in range(2):
        ref._build_train_step()(*batch)
        net._build_train_step(accum_steps=4)(*batch)
        ref.iteration += 1
        net.iteration += 1
    assert not torch.allclose(net.params["outB"]["W"], init_b)
    _assert_trees(net.params, jax.tree.map(lambda t: t.numpy(), ref.params),
                  rtol=0, atol=1e-5)
    jstep = jnet._build_train_step(accum_steps=4)
    p, o, s = jnet.params, jnet.updater_state, jnet.state
    for i in range(2):
        p, o, s, _ = jstep(p, o, s, jnp.int32(i), jax.random.PRNGKey(0),
                           (jnp.asarray(x),), (jnp.asarray(ya),
                                               jnp.asarray(yb)), (None,),
                           (jnp.asarray(mask_a), None))
    _assert_trees(net.params, p, **TOL)


@pytest.mark.parametrize("engine", ["sequential", "graph"])
def test_bf16_cast_hoist_is_bitwise_no_hoist(engine):
    """Under a bf16 policy with no l1/l2 term the accumulated step casts
    the masters once a step and differentiates the compute copies (the
    16-bit gradients promote exactly into the f32 accumulator); the same
    step with the hoist off casts inside every microbatch. Loss, params,
    Adam and BN state bit for bit."""
    def build():
        if engine == "sequential":
            return MultiLayerNetwork(_mln_conf(P, dtype="BFLOAT16")).init(
                device="cpu")
        conf = _graph_conf(P)
        conf.dtype = "BFLOAT16"
        return ComputationGraph(conf).init(device="cpu")
    hoisted, plain = build(), build()
    # the hoist is gated on the net having no l1/l2 term
    plain._uses_regularization = lambda: True
    sh = hoisted._build_train_step(accum_steps=4)
    sp = plain._build_train_step(accum_steps=4)
    x, y = _data(32)
    for _ in range(2):
        assert torch.equal(sh(*_batch(engine, x, y)),
                           sp(*_batch(engine, x, y)))
    for a, b in ((hoisted.params, plain.params),
                 (hoisted.updater_state, plain.updater_state),
                 (hoisted.state, plain.state)):
        la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
        assert len(la) == len(lb)
        assert all(torch.equal(p, q) for p, q in zip(la, lb))
        assert all(p.dtype == torch.float32 for p in la)
