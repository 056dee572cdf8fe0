"""Training a small ComputationGraph through the port's ``fit`` against the
JAX package's, on the CPU: the BatchNormalization train branch, a conv ->
BN -> relu -> pool -> output net with l2, gradient normalization and a
constraint, the divergence sentinel, the updater-state ZIP in both
directions, the data entry points ``fit`` accepts, and what this slice
refuses.

Both nets are built by each package's own builder from the same
description; the port takes the JAX net's weights (``from_numpy``). The
conv has no bias, as in ResNet: before a batch-statistics BN a bias has a
gradient of exactly 0, which float32 computes as rounding noise and Adam
turns into steps of +-lr with the noise's sign, in either package.

Tolerances: BN outputs, running statistics and their gradients rtol 1e-5,
atol 1e-5 (float32 one-pass moments summed in another order); the small
net's losses rtol 1e-5; its params after each Adam step atol 1e-6 plus
rtol 1e-4 (a step is 1e-2; float32 gradient sums in another order move a
step's last digits); a ZIP round trip is bit-exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.data import dataset as jds
from deeplearning4j_tpu.nn import constraints as jcons
from deeplearning4j_tpu.nn import updaters as jupd
from deeplearning4j_tpu.nn.config import InputType as JInputType
from deeplearning4j_tpu.nn.config import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.layers import conv as jconv
from deeplearning4j_tpu.nn.layers import core as jcore
from deeplearning4j_tpu.utils import serializer as jser
from deeplearning4j_tpu_torch.data import dataset as ds
from deeplearning4j_tpu_torch.nn import constraints as cons
from deeplearning4j_tpu_torch.nn import updaters as upd
from deeplearning4j_tpu_torch.nn.config import InputType, NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.layers import conv, core
from deeplearning4j_tpu_torch.utils import serializer
from deeplearning4j_tpu_torch.utils.convert import from_numpy

SHAPE = (8, 8, 3)
CLASSES = 4


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        yield
    finally:
        torch.set_num_threads(old)


# ------------------------------------------------------- BatchNormalization

def _bn_data(seed, shape=(3, 5, 5, 6)):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    x = (rng.standard_normal(shape) * 1.5 + 0.7).astype(np.float32)
    params = {"gamma": (rng.standard_normal(c) * 0.3 + 1).astype(np.float32),
              "beta": rng.standard_normal(c).astype(np.float32)}
    state = {"mean": rng.standard_normal(c).astype(np.float32),
             "var": (rng.random(c) + 0.5).astype(np.float32)}
    w = rng.standard_normal(shape).astype(np.float32)
    return x, params, state, w


@pytest.mark.parametrize("fold_act", [None, "relu"])
@pytest.mark.parametrize("masked", [False, True])
def test_batchnorm_train_branch_matches_jax(masked, fold_act):
    """Batch statistics (mask-aware), the new running statistics, and the
    gradients of sum(y * w) to x, gamma and beta."""
    x, params, state, w = _bn_data(1)
    mask = np.array([1.0, 0.0, 1.0], np.float32) if masked else None
    kw = {} if fold_act is None else {"fold_act": fold_act}
    jl = jconv.BatchNormalization(data_format="NHWC", decay=0.8)
    pl = conv.BatchNormalization(data_format="NHWC", decay=0.8)

    def jfn(x, g, b):
        y, st, _ = jl.apply({"gamma": g, "beta": b}, x,
                            {k: jnp.asarray(v) for k, v in state.items()},
                            train=True,
                            mask=None if mask is None else jnp.asarray(mask),
                            **kw)
        return jnp.sum(y * jnp.asarray(w)), (y, st)

    (_, (jy, jst)), jg = jax.value_and_grad(jfn, argnums=(0, 1, 2),
                                            has_aux=True)(
        jnp.asarray(x), jnp.asarray(params["gamma"]),
        jnp.asarray(params["beta"]))
    px = torch.from_numpy(x).requires_grad_(True)
    pg = torch.from_numpy(params["gamma"]).requires_grad_(True)
    pb = torch.from_numpy(params["beta"]).requires_grad_(True)
    py, pst, _ = pl.apply({"gamma": pg, "beta": pb}, px,
                          {k: torch.from_numpy(v) for k, v in state.items()},
                          train=True,
                          mask=None if mask is None else torch.from_numpy(mask),
                          **kw)
    (py * torch.from_numpy(w)).sum().backward()
    close = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(py.detach().numpy(), np.asarray(jy), **close)
    for k in ("mean", "var"):
        assert not pst[k].requires_grad
        np.testing.assert_allclose(pst[k].numpy(), np.asarray(jst[k]),
                                   **close)
    for got, want in zip((px, pg, pb), jg):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(want),
                                   **close)


def test_batchnorm_train_leaves_its_state_alone():
    x, params, state, _ = _bn_data(2)
    st = {k: torch.from_numpy(v.copy()) for k, v in state.items()}
    before = {k: v.clone() for k, v in st.items()}
    _, new, _ = conv.BatchNormalization(data_format="NHWC").apply(
        {k: torch.from_numpy(v) for k, v in params.items()},
        torch.from_numpy(x), st, train=True)
    assert all(torch.equal(st[k], before[k]) for k in st)
    assert not torch.equal(new["mean"], before["mean"])


# ------------------------------------------------------------- a small net

def _jax_net(**opts):
    b = (JConf.builder().seed(7)
         .updater(opts.get("jupdater", jupd.Adam(learning_rate=1e-2)))
         .l2(1e-3))
    if opts.get("clip"):
        b = b.gradient_normalization("ClipL2PerLayer", 0.5)
    if opts.get("constrain"):
        b = b.constrain_weights(jcons.MaxNormConstraint(max_norm=1.5))
    g = (b.graph_builder().add_inputs("in")
         .set_input_types(JInputType.convolutional(3, 8, 8,
                                                   data_format="NHWC"))
         .add_layer("conv", jconv.ConvolutionLayer(
             n_out=6, kernel=(3, 3), padding=(1, 1), has_bias=False,
             data_format="NHWC"), "in")
         .add_layer("bn", jconv.BatchNormalization(data_format="NHWC"),
                    "conv")
         .add_layer("act", jcore.ActivationLayer(activation="relu"), "bn")
         .add_layer("pool", jconv.GlobalPoolingLayer(pool_type="avg",
                                                     data_format="NHWC"),
                    "act")
         .add_layer("out", jcore.OutputLayer(n_out=CLASSES), "pool")
         .set_outputs("out"))
    return JGraph(g.build()).init()


def _port_net(**opts):
    b = (NeuralNetConfiguration.builder().seed(7)
         .updater(opts.get("updater", upd.Adam(learning_rate=1e-2)))
         .l2(1e-3))
    if opts.get("clip"):
        b = b.gradient_normalization("ClipL2PerLayer", 0.5)
    if opts.get("constrain"):
        b = b.constrain_weights(cons.MaxNormConstraint(max_norm=1.5))
    g = (b.graph_builder().add_inputs("in")
         .set_input_types(InputType.convolutional(3, 8, 8,
                                                  data_format="NHWC"))
         .add_layer("conv", conv.ConvolutionLayer(
             n_out=6, kernel=(3, 3), padding=(1, 1), has_bias=False,
             data_format="NHWC"), "in")
         .add_layer("bn", conv.BatchNormalization(data_format="NHWC"),
                    "conv")
         .add_layer("act", core.ActivationLayer(activation="relu"), "bn")
         .add_layer("pool", conv.GlobalPoolingLayer(pool_type="avg",
                                                    data_format="NHWC"),
                    "act")
         .add_layer("out", core.OutputLayer(n_out=CLASSES), "pool")
         .set_outputs("out"))
    return ComputationGraph(g.build()).init(device="cpu")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _carry(jnet, net):
    net.params, net.state, net.updater_state = from_numpy(
        _np(jnet.params), _np(jnet.state), device="cpu",
        updater_state=_np(jnet.updater_state))
    net.iteration = jnet.iteration
    return net


def _batch(seed, n=6):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n,) + SHAPE).astype(np.float32)
    y = np.eye(CLASSES, dtype=np.float32)[rng.integers(0, CLASSES, n)]
    return x, y


def _assert_trees(port_tree, jax_tree, rtol=1e-4, atol=1e-6):
    want = _np(jax_tree)
    got = jax.tree.map(lambda t: t.detach().numpy(), port_tree)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)


@pytest.mark.parametrize("opts", [{}, {"clip": True, "constrain": True}],
                         ids=["plain", "clip_constrain"])
def test_configuration_json_matches_jax(opts):
    import json
    assert json.loads(_port_net(**opts).conf.to_json()) == \
        json.loads(_jax_net(**opts).conf.to_json())


@pytest.mark.parametrize("opts", [{}, {"clip": True, "constrain": True}],
                         ids=["plain", "clip_constrain"])
def test_three_fit_steps_match_jax(opts):
    """Losses, params, Adam state and BN running statistics after each of
    three steps on three batches."""
    jnet = _jax_net(**opts)
    net = _carry(jnet, _port_net(**opts))
    for step in range(3):
        x, y = _batch(10 + step)
        jnet.fit(x, y)
        net.fit(x, y)
        np.testing.assert_allclose(net.score(), float(jnet.score()),
                                   rtol=1e-5)
        _assert_trees(net.params, jnet.params)
        _assert_trees(net.updater_state, jnet.updater_state, atol=1e-7)
        _assert_trees(net.state, jnet.state, rtol=1e-5, atol=1e-6)
    assert net.iteration == jnet.iteration == 3
    assert net.epoch == jnet.epoch == 3
    assert net.resilience_counters()["bad_total"] == 0
    if opts.get("clip"):
        assert net.resilience_counters()["clip_events"] == \
            int(jnet.resilience_counters()["clip_events"])


def test_score_on_data_matches_jax():
    jnet = _jax_net()
    net = _carry(jnet, _port_net())
    x, y = _batch(20)
    want = float(jnet.score(jds.DataSet(x, y)))
    np.testing.assert_allclose(net.score(ds.DataSet(x, y)), want, rtol=1e-5)
    np.testing.assert_allclose(
        net.score(ds.MultiDataSet([x], [y])), want, rtol=1e-5)


def test_sentinel_skips_a_nan_batch_and_counts_it():
    net = _port_net()
    x, y = _batch(30)
    net.fit(x, y)
    snap = [jax.tree.map(lambda t: t.clone(), tree)
            for tree in (net.params, net.updater_state, net.state)]
    bad = x.copy()
    bad[0, 0, 0, 0] = np.nan
    net.fit(bad, y)
    for before, after in zip(snap, (net.params, net.updater_state,
                                    net.state)):
        for a, b in zip(jax.tree.leaves(before), jax.tree.leaves(after)):
            assert torch.equal(a, b)
    assert net.resilience_counters() == {"bad_total": 1, "bad_consec": 1,
                                         "clip_events": 0}
    assert not np.isfinite(net.score())
    assert net.iteration == 2
    net.fit(x, y)
    assert net.resilience_counters()["bad_consec"] == 0
    assert net.resilience_counters()["bad_total"] == 1
    assert not torch.equal(net.params["conv"]["W"], snap[0]["conv"]["W"])


# ------------------------------------------------------------- data inputs

def test_fit_accepts_every_data_form():
    x, y = _batch(40, n=8)
    forms = {
        "arrays": lambda: (x, y),
        "dataset": lambda: (ds.DataSet(x, y),),
        "multidataset": lambda: (ds.MultiDataSet([x], [y]),),
        "iterator": lambda: (ds.NumpyDataSetIterator(x, y, batch_size=4),),
        "multi_iterator": lambda: (ds.NumpyMultiDataSetIterator(
            [x], [y], batch_size=4),),
        "list": lambda: (ds.ListDataSetIterator(
            [ds.DataSet(x[:4], y[:4]), ds.DataSet(x[4:], y[4:])]),),
    }
    steps = {"arrays": 1, "dataset": 1, "multidataset": 1, "iterator": 2,
             "multi_iterator": 2, "list": 2}
    finals = {}
    for name, make in forms.items():
        net = _port_net()
        net.fit(*make(), epochs=2)
        assert net.iteration == 2 * steps[name] and net.epoch == 2, name
        finals[name] = net.params["out"]["W"]
    assert torch.equal(finals["arrays"], finals["dataset"])
    assert torch.equal(finals["arrays"], finals["multidataset"])
    assert torch.equal(finals["iterator"], finals["list"])
    assert torch.equal(finals["iterator"], finals["multi_iterator"])
    with pytest.raises(TypeError, match="MultiDataSetIterator"):
        _port_net().fit(x)


def test_iterators_match_jax_batches():
    x, y = _batch(41, n=10)
    mine = list(ds.NumpyDataSetIterator(x, y, batch_size=4, shuffle=True,
                                        seed=3))
    theirs = list(jds.NumpyDataSetIterator(x, y, batch_size=4,
                                           shuffle=True, seed=3))
    assert len(mine) == len(theirs) == 3
    for a, b in zip(mine, theirs):
        np.testing.assert_array_equal(a.features, b.features)
    it = ds.NumpyDataSetIterator(x, y, batch_size=4)
    next(iter(it))
    state = it.state()
    rest = [d.features for d in it]
    it2 = ds.NumpyDataSetIterator(x, y, batch_size=4)
    it2.set_state(state)
    for a, b in zip(rest, (d.features for d in it2)):
        np.testing.assert_array_equal(a, b)


# ----------------------------------------------------------- updater state

def test_jax_zip_saved_mid_training_resumes_in_the_port(tmp_path):
    jnet = _jax_net()
    x, y = _batch(50)
    jnet.fit(x, y)
    path = tmp_path / "jax.zip"
    jnet.save(str(path))
    net = serializer.load_model(str(path), device="cpu")
    for mine, theirs in ((net.params, jnet.params),
                         (net.updater_state, jnet.updater_state),
                         (net.state, jnet.state)):
        _assert_trees(mine, theirs, rtol=0, atol=0)
    assert net.iteration == 1
    x2, y2 = _batch(51)
    jnet.fit(x2, y2)
    net.fit(x2, y2)
    _assert_trees(net.params, jnet.params)
    _assert_trees(net.updater_state, jnet.updater_state, atol=1e-7)


def test_port_zip_saved_mid_training_resumes_in_jax(tmp_path):
    jnet = _jax_net()
    net = _carry(jnet, _port_net())
    x, y = _batch(60)
    net.fit(x, y)
    path = tmp_path / "port.zip"
    net.save(str(path))
    back = jser.load_model(str(path))
    for mine, theirs in ((net.params, back.params),
                         (net.updater_state, back.updater_state),
                         (net.state, back.state)):
        _assert_trees(mine, theirs, rtol=0, atol=0)
    assert back.iteration == 1
    x2, y2 = _batch(61)
    back.fit(x2, y2)
    net.fit(x2, y2)
    _assert_trees(net.params, back.params)
    again = serializer.load_model(str(path), device="cpu",
                                  load_updater=False)
    _assert_trees(again.updater_state,
                  jax.tree.map(np.zeros_like, _np(back.updater_state)),
                  rtol=0, atol=0)
    path2 = tmp_path / "no_updater.zip"
    net.save(str(path2), save_updater=False)
    import zipfile
    with zipfile.ZipFile(path2) as zf:
        assert "updaterState.npz" not in zf.namelist()


def test_from_numpy_carries_the_updater_state():
    jnet = _jax_net()
    p, s = from_numpy(_np(jnet.params), _np(jnet.state), device="cpu")
    p3, s3, u3 = from_numpy(_np(jnet.params), _np(jnet.state), device="cpu",
                            updater_state=_np(jnet.updater_state))
    assert set(u3) == {"m", "v"} and set(u3["m"]) == set(p3)
    assert torch.equal(p["conv"]["W"], p3["conv"]["W"])


# ------------------------------------- what an earlier slice refused

@pytest.mark.parametrize("change,match", [
    (lambda c: setattr(c, "workspace_mode", "full"), "workspace_mode"),
    (lambda c: setattr(c, "dtype", "BFLOAT16"), "mixed precision"),
    (lambda c: setattr(c, "dtype", "FLOAT16"), "mixed precision"),
])
def test_out_of_slice_options_raise(change, match):
    """The options an earlier slice refused (``match`` names the refusal)
    train now, the training modes of ``fit``: the step runs under each,
    the loss is finite and the masters stay float32
    (``test_torch_remat.py`` and ``test_torch_mixed_precision.py`` hold
    them against the JAX package)."""
    net = _port_net()
    change(net.conf)
    x, y = _batch(70)
    net.fit(x, y)
    assert np.isfinite(net.score())
    for leaves in net.params.values():
        assert all(t.dtype == torch.float32 for t in leaves.values())


def test_resilience_and_listeners_raise():
    net = _port_net()
    x, y = _batch(71)
    with pytest.raises(NotImplementedError, match="resilience"):
        net.fit(x, y, resilience=object())
    with pytest.raises(NotImplementedError, match="listeners"):
        net.set_listeners(object())
    with pytest.raises(NotImplementedError, match="listeners"):
        net.add_listener(object())
    # training-mode output is ported now (test_torch_graph_breadth.py
    # holds it against JAX): no refusal left there
    assert net.output(x, train=True).shape == (x.shape[0], CLASSES)


def test_fit_without_a_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    net = ComputationGraph(_port_net().conf)
    x, y = _batch(72)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        net.fit(x, y)


def test_builder_takes_an_updater_object_name_or_dict():
    for u in (upd.Nadam(learning_rate=0.02), "nadam",
              {"kind": "nadam", "learning_rate": 0.02}):
        conf = (NeuralNetConfiguration.builder().updater(u).graph_builder()
                .add_inputs("in").set_input_types((4,))
                .add_layer("out", core.OutputLayer(n_out=2), "in")
                .set_outputs("out").build())
        assert isinstance(conf.updater, upd.Nadam)


# ------------------------------------------------- dropout in a graph's fit

def _dropout_graph(conf, input_type, layers_mod, updaters_mod):
    return (conf.builder().seed(4)
            .updater(updaters_mod.Adam(learning_rate=1e-2))
            .graph_builder().add_inputs("in")
            .set_input_types(input_type.feed_forward(12))
            .add_layer("dense", layers_mod.DenseLayer(n_out=256,
                                                      activation="relu"),
                       "in")
            .add_layer("drop", layers_mod.DropoutLayer(rate=0.5), "dense")
            .add_layer("out", layers_mod.OutputLayer(n_out=CLASSES), "drop")
            .set_outputs("out").build())


def test_graph_fit_drops_like_jax():
    """A DropoutLayer vertex drops in the graph's training forward, as the
    JAX package's does (its training loss takes a key for the stochastic
    vertices): half the live units zeroed and the rest doubled; ``score``
    keeps it the identity and equals the JAX package's; a seeded graph
    repeats its step."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((64, 12)).astype(np.float32)
    y = np.eye(CLASSES, dtype=np.float32)[rng.integers(0, CLASSES, 64)]
    jnet = JGraph(_dropout_graph(JConf, JInputType, jcore, jupd)).init()
    jkeyed, _ = jnet._build_loss_fn()(
        jnet.params, jnet.state, jax.random.PRNGKey(0), [jnp.asarray(x)],
        [jnp.asarray(y)], [None], [None])
    jplain = jnet.score(jds.DataSet(x, y))
    assert float(jkeyed) != pytest.approx(jplain, rel=1e-4)

    def port():
        net = ComputationGraph(_dropout_graph(
            NeuralNetConfiguration, InputType, core, upd)).init(device="cpu")
        net.params, net.state = from_numpy(_np(jnet.params),
                                           _np(jnet.state), "cpu")
        return net

    net = port()
    xs, ys = (torch.from_numpy(x),), (torch.from_numpy(y),)
    acts, _, _ = net._forward(net.params, {"in": xs[0]}, net.state,
                              train=True, rng=torch.Generator().manual_seed(1))
    dense, drop = acts["dense"], acts["drop"]
    live = dense != 0
    kept = drop[live] != 0
    assert abs(float(kept.float().mean()) - 0.5) < 0.03
    assert torch.allclose(drop[live][kept], 2 * dense[live][kept])
    plain, _ = net._loss(net.params, net.state, xs, ys, (None,), (None,))
    dropped, _ = net._loss(net.params, net.state, xs, ys, (None,), (None,),
                           torch.Generator().manual_seed(1))
    assert float(dropped) != pytest.approx(float(plain), rel=1e-4)
    assert net.score(ds.DataSet(x, y)) == pytest.approx(jplain, rel=1e-5)
    twin = port()
    net.fit(x, y)
    twin.fit(x, y)
    assert net.score() == twin.score()
    assert net.score() != pytest.approx(float(plain), rel=1e-4)
