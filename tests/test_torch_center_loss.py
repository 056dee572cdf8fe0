"""CenterLossOutputLayer in the port against the JAX package, on the CPU,
in both engines: the loss (cross entropy plus the center term), its
gradients, the centers after two ``fit`` steps (the EMA rule, outside the
gradient), ``score``, and serde (the centers saved in ``state.npz``, the
stashed features never; ZIPs both ways).

Both nets are built by each package's own builder from the same
description and the port takes the JAX net's weights (``from_numpy``).
Tolerances: losses rtol 1e-5, gradients rtol 1e-5 atol 1e-6, centers and
params after the steps atol 1e-6 plus rtol 1e-4 (as in
``tests/test_torch_training.py``: float32 sums in another order move a
step's last digits)."""

import io
import types
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.data import dataset as jds
from deeplearning4j_tpu.nn import config as jconfig
from deeplearning4j_tpu.nn import updaters as jupd
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.layers import core as jcore
from deeplearning4j_tpu.nn.layers import special as jspecial
from deeplearning4j_tpu.nn.model import MultiLayerNetwork as JNet
from deeplearning4j_tpu_torch.data import dataset as pds
from deeplearning4j_tpu_torch.nn import config as pconfig
from deeplearning4j_tpu_torch.nn import updaters as pupd
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph as PGraph
from deeplearning4j_tpu_torch.nn.layers import core as pcore
from deeplearning4j_tpu_torch.nn.layers import special as pspecial
from deeplearning4j_tpu_torch.nn.model import MultiLayerNetwork as PNet
from deeplearning4j_tpu_torch.utils.convert import from_numpy

J = types.SimpleNamespace(conf=jconfig, core=jcore, special=jspecial,
                          upd=jupd, Net=JNet, Graph=JGraph, ds=jds)
P = types.SimpleNamespace(conf=pconfig, core=pcore, special=pspecial,
                          upd=pupd, Net=PNet, Graph=PGraph, ds=pds)
STEP = dict(rtol=1e-4, atol=1e-6)
C, F = 3, 6


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


def _head(ns):
    return ns.special.CenterLossOutputLayer(n_out=C, alpha=0.3,
                                            lambda_=0.5, l2=1e-3)


def _mln(ns):
    return ns.Net(
        ns.conf.NeuralNetConfiguration.builder().seed(12)
        .updater(ns.upd.Adam(learning_rate=0.05))
        .input_type(ns.conf.InputType.feed_forward(4))
        .list(ns.core.DenseLayer(n_out=F, activation="tanh"), _head(ns))
        .build())


def _graph(ns):
    g = (ns.conf.NeuralNetConfiguration.builder().seed(12)
         .updater(ns.upd.Adam(learning_rate=0.05))
         .graph_builder().add_inputs("in")
         .set_input_types(ns.conf.InputType.feed_forward(4)))
    g.add_layer("d", ns.core.DenseLayer(n_out=F, activation="tanh"), "in")
    g.add_layer("out", _head(ns), "d")
    return ns.Graph(g.set_outputs("out").build())


ENGINES = {"mln": (_mln, "1"), "graph": (_graph, "out")}


def _pair(build):
    jnet = build(J).init()
    pnet = build(P).init(device="cpu")
    pnet.params, pnet.state, pnet.updater_state = from_numpy(
        jnet.params, jnet.state, "cpu", updater_state=jnet.updater_state)
    return jnet, pnet


def _data(seed, n=10):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 4)).astype(np.float32)
    y = np.eye(C, dtype=np.float32)[rng.integers(0, C, n)]
    y[0] = np.eye(C, dtype=np.float32)[0]  # class 2 may be absent;
    return x, y                            # class 0 never is


def _np(t):
    if isinstance(t, dict):
        return {k: _np(v) for k, v in t.items()}
    return t.detach().numpy() if torch.is_tensor(t) else np.asarray(t)


def _close_trees(got, want, **tol):
    got, want = _np(got), _np(want)
    assert set(got) == set(want)
    for k in want:
        if isinstance(want[k], dict):
            _close_trees(got[k], want[k], **tol)
        else:
            np.testing.assert_allclose(got[k], want[k], err_msg=k, **tol)


def _jax_loss_and_grads(jnet, x, y, graph):
    fn = jnet._build_loss_fn()
    if graph:
        def loss(p):
            return fn(p, jnet.state, jax.random.PRNGKey(0), (jnp.asarray(x),),
                      (jnp.asarray(y),), (None,), (None,))
    else:
        def loss(p):
            return fn(p, jnet.state, jax.random.PRNGKey(0), jnp.asarray(x),
                      jnp.asarray(y), None, None)
    return jax.value_and_grad(loss, has_aux=True)(jnet.params)


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_loss_gradients_and_new_centers_match_jax(engine):
    build, key = ENGINES[engine]
    jnet, pnet = _pair(build)
    # start from centers away from zero, as after some training
    centers = np.random.default_rng(1).standard_normal((C, F)).astype(
        np.float32)
    jnet.state = {**jnet.state, key: {"centers": jnp.asarray(centers)}}
    pnet.state = {**pnet.state, key: {"centers": torch.from_numpy(centers)}}
    x, y = _data(2)
    (jl, jst), jg = _jax_loss_and_grads(jnet, x, y, engine == "graph")
    xs, ys = torch.from_numpy(x), torch.from_numpy(y)
    if engine == "graph":
        pl, pg, pst = pnet._value_and_grad((xs,), (ys,), (None,), (None,))
    else:
        pl, pg, pst = pnet._value_and_grad(xs, ys)
    np.testing.assert_allclose(float(pl), float(jl), rtol=1e-5)
    _close_trees(pg, jg, rtol=1e-5, atol=1e-6)
    assert set(pst[key]) == set(jst[key]) == {"centers"}
    _close_trees(pst, jst, rtol=1e-5, atol=1e-6)
    # score(ds) is the fit loop's quantity, center term included
    np.testing.assert_allclose(pnet.score(pds.DataSet(x, y)), float(pl),
                               rtol=1e-6)


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_two_fit_steps_and_score_match_jax(engine):
    build, key = ENGINES[engine]
    jnet, pnet = _pair(build)
    for seed in (3, 4):
        x, y = _data(seed)
        jnet.fit(jds.DataSet(x, y))
        pnet.fit(pds.DataSet(x, y))
    np.testing.assert_allclose(pnet.score(), float(jnet.score()), rtol=1e-5)
    _close_trees(pnet.state, jnet.state, **STEP)
    _close_trees(pnet.params, jnet.params, **STEP)
    assert set(pnet.state[key]) == {"centers"}
    assert pnet.state[key]["centers"].abs().max() > 0
    x, y = _data(5)
    np.testing.assert_allclose(pnet.score(pds.DataSet(x, y)),
                               jnet.score(jds.DataSet(x, y)), rtol=1e-5)
    np.testing.assert_allclose(pnet.output(x), np.asarray(jnet.output(x)),
                               rtol=1e-5, atol=1e-6)


def test_update_centers_moves_only_the_classes_seen():
    layer = pspecial.CenterLossOutputLayer(n_out=C, alpha=0.25)
    jlayer = jspecial.CenterLossOutputLayer(n_out=C, alpha=0.25)
    rng = np.random.default_rng(6)
    centers = rng.standard_normal((C, F)).astype(np.float32)
    feats = rng.standard_normal((5, F)).astype(np.float32)
    labels = np.eye(C, dtype=np.float32)[[0, 0, 1, 0, 1]]
    got = layer.update_centers(torch.from_numpy(centers),
                               torch.from_numpy(feats),
                               torch.from_numpy(labels)).numpy()
    want = np.asarray(jlayer.update_centers(
        jnp.asarray(centers), jnp.asarray(feats), jnp.asarray(labels)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got[2], centers[2])


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_serde_keeps_centers_and_never_the_features(engine, tmp_path):
    build, key = ENGINES[engine]
    jnet, pnet = _pair(build)
    x, y = _data(7)
    jnet.fit(jds.DataSet(x, y))
    pnet.fit(pds.DataSet(x, y))
    ppath, jpath = str(tmp_path / "p.zip"), str(tmp_path / "j.zip")
    pnet.save(ppath)
    jnet.save(jpath)
    for path in (ppath, jpath):
        with zipfile.ZipFile(path) as zf:
            with np.load(io.BytesIO(zf.read("state.npz"))) as z:
                assert f"{key}/centers" in z.files
                assert not [f for f in z.files if "__features__" in f]
        loaded = (PGraph if engine == "graph" else PNet).load(
            path, device="cpu")
        assert loaded.conf.to_json() == jnet.conf.to_json()
    back = (JGraph if engine == "graph" else JNet).load(ppath)
    np.testing.assert_array_equal(np.asarray(back.state[key]["centers"]),
                                  pnet.state[key]["centers"].numpy())
    mine = (PGraph if engine == "graph" else PNet).load(ppath, device="cpu")
    np.testing.assert_array_equal(mine.output(x), pnet.output(x))
