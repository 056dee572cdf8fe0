"""16-bit training in the port against the JAX package, on the CPU: the
mixed-precision policy leaf by leaf, f32 masters, updater state, BN
statistics and center-loss centers under a ``BFLOAT16`` network, bf16
activations, 20 steps against the JAX package's bf16 losses, the fused
master-cast updater against the unfused step (bit for bit, both engines),
its routing, and a bf16 net saved by the JAX package resuming in the port.

Both nets of a comparison start from the JAX net's f32 masters
(``from_numpy``). Tolerances: the bf16 trajectories within the JAX
package's own band against its f32 oracle, ``rtol=7e-2, atol=5e-2``
(``tests/test_mixed_precision.py``); fused against unfused, and the
resumed net's first step against the port's own, bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import dtypes as jdt
from deeplearning4j_tpu.nn.config import InputType as JInputType
from deeplearning4j_tpu.nn.config import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.layers import conv as jconv
from deeplearning4j_tpu.nn.layers import core as jcore
from deeplearning4j_tpu.nn.model import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.nn import updaters as jupd
from deeplearning4j_tpu_torch import dtypes
from deeplearning4j_tpu_torch.nn import updaters as upd
from deeplearning4j_tpu_torch.nn.config import InputType, NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.layers import conv, core, special
from deeplearning4j_tpu_torch.nn.model import MultiLayerNetwork
from deeplearning4j_tpu_torch.ops import fused_epilogues as fe
from deeplearning4j_tpu_torch.utils.convert import from_numpy

BAND = dict(rtol=7e-2, atol=5e-2)


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


def _layers(m, l2):
    return [m[0].DenseLayer(n_out=24, activation="relu", l2=l2),
            m[1].BatchNormalization(),
            m[0].DenseLayer(n_out=16, activation="tanh"),
            m[0].OutputLayer(n_out=3, loss="mcxent", activation="softmax")]


def _jnet(dtype, l2=0.0):
    conf = (JConf.builder().seed(7).data_type(dtype)
            .updater(jupd.Adam(learning_rate=1e-2))
            .input_type(JInputType.feed_forward(12))
            .list(*_layers((jcore, jconv), l2)).build())
    return JMLN(conf).init()


def _pnet(dtype, jnet=None, l2=0.0):
    conf = (NeuralNetConfiguration.builder().seed(7).data_type(dtype)
            .updater(upd.Adam(learning_rate=1e-2))
            .input_type(InputType.feed_forward(12))
            .list(*_layers((core, conv), l2)).build())
    net = MultiLayerNetwork(conf).init(device="cpu")
    if jnet is not None:
        net.params, net.state = from_numpy(_np(jnet.params),
                                           _np(jnet.state), "cpu")
    return net


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _data(n=64, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 12)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, n)]
    return x, y


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _equal(a, b):
    la, lb = list(_leaves(a)), list(_leaves(b))
    return len(la) == len(lb) and all(torch.equal(p, q)
                                      for p, q in zip(la, lb))


# ------------------------------------------------------------ the policy

@pytest.mark.parametrize("name", ["FLOAT", "BFLOAT16", "float16", "FLOAT16",
                                  "DOUBLE", "INT32", "bfloat16"])
def test_policy_matches_jax(name):
    assert dtypes.is_mixed(name) == jdt.is_mixed(name)
    assert str(dtypes.param_dtype(name)).replace("torch.", "") == \
        np.dtype(jdt.param_dtype(name)).name


@pytest.mark.parametrize("to", ["BFLOAT16", "FLOAT16", "FLOAT"])
def test_cast_floating_leaf_by_leaf(to):
    """Floating leaves cast, integer and bool leaves pass through, as the
    JAX rule does; a leaf already in the dtype is itself."""
    tree = {"a": np.arange(6, dtype=np.float32).reshape(2, 3) / 7,
            "b": {"h": np.ones(3, np.float16),
                  "i": np.arange(4, dtype=np.int32),
                  "m": np.array([True, False])}}
    want = jdt.cast_floating(jax.tree.map(jnp.asarray, tree), jdt.resolve(to))
    got = dtypes.cast_floating({"a": torch.from_numpy(tree["a"]),
                                "b": {k: torch.from_numpy(v)
                                      for k, v in tree["b"].items()}}, to)
    for g, w in zip(_leaves(got), jax.tree.leaves(want)):
        assert str(g.dtype).replace("torch.", "") == np.dtype(w.dtype).name
        np.testing.assert_array_equal(g.float().numpy() if
                                      g.is_floating_point() else g.numpy(),
                                      np.asarray(w, np.float32) if
                                      jnp.issubdtype(w.dtype, jnp.floating)
                                      else np.asarray(w))
    same = torch.ones(2, dtype=dtypes.resolve(to))
    assert dtypes.cast_floating({"x": same}, to)["x"] is same


@pytest.mark.parametrize("dtype", ["bfloat16", "float16", "float32",
                                   "int32"])
def test_upcast_16_matches_jax(dtype):
    a = np.array([1.5, -2.25, 3.0]).astype(
        jnp.bfloat16 if dtype == "bfloat16" else dtype)
    want = jdt.upcast_16(jnp.asarray(a))
    t = torch.tensor([1.5, -2.25, 3.0]).to(dtypes.resolve(dtype))
    got = dtypes.upcast_16(t)
    assert str(got.dtype).replace("torch.", "") == np.dtype(want.dtype).name


def test_master_cast_updater_matches_jax():
    """``apply_leaf_cast``/``apply_leafwise_cast`` against the JAX
    package's on Adam: the f32 masters and slots as :func:`apply_leaf`
    gives them, bit for bit, and the compute copies their bf16 casts
    (integer leaves untouched); both within 1e-6 of the JAX package's."""
    from deeplearning4j_tpu.nn import updaters as jup
    rng = np.random.default_rng(3)
    p = rng.standard_normal((4, 5)).astype(np.float32)
    g = rng.standard_normal((4, 5)).astype(np.float32)
    adam, jadam = upd.Adam(learning_rate=1e-2), jupd.Adam(learning_rate=1e-2)
    tp, tg = torch.from_numpy(p), torch.from_numpy(g)
    slots = adam.init_state(tp)
    new_p, new_c, new_s = upd.apply_leaf_cast(adam, tg, slots, tp, 0,
                                              torch.bfloat16)
    ref_p, ref_s = upd.apply_leaf(adam, tg, slots, tp, 0)
    assert torch.equal(new_p, ref_p) and new_c.dtype == torch.bfloat16
    assert torch.equal(new_c, ref_p.to(torch.bfloat16))
    assert all(torch.equal(new_s[k], ref_s[k]) for k in ref_s)
    jp, jc, js = jup.apply_leaf_cast(jadam, jnp.asarray(g),
                                     jadam.init_state(jnp.asarray(p)),
                                     jnp.asarray(p), 0, jnp.bfloat16)
    np.testing.assert_allclose(new_p.numpy(), np.asarray(jp), rtol=1e-6,
                               atol=1e-6)
    tp2, tc, _ = upd.apply_leafwise_cast(
        upd.Sgd(learning_rate=0.1), {"a": {"W": tg}}, {}, {"a": {"W": tp}},
        0, torch.bfloat16)
    assert torch.equal(tc["a"]["W"], tp2["a"]["W"].to(torch.bfloat16))
    ints = torch.arange(3)
    assert upd._cast_leaf(ints, torch.bfloat16) is ints


# ------------------------------------------------------------ the engines

def test_bf16_net_keeps_f32_masters_and_bf16_activations():
    net = _pnet("BFLOAT16", _jnet("BFLOAT16"))
    for tree in (net.params, net.updater_state, net.state):
        assert all(t.dtype == torch.float32 for t in _leaves(tree))
    x, _ = _data(8)
    out, _, _ = net._forward(net.params, torch.from_numpy(x), net.state)
    assert out.dtype == torch.bfloat16
    acts = net.feed_forward(x)
    assert all(a.dtype == torch.bfloat16 for a in acts)


def test_bf16_training_tracks_jax():
    """20 steps from the same masters: the port's bf16 losses within the
    JAX band of the JAX package's bf16 losses, and of the f32 oracle's;
    masters, updater state and BN statistics stay f32."""
    x, y = _data(64)
    jmix, jref = _jnet("BFLOAT16"), _jnet("FLOAT")
    mix = _pnet("BFLOAT16", jmix)
    got, want, oracle = [], [], []
    for _ in range(20):
        jmix.fit(x, y)
        jref.fit(x, y)
        mix.fit(x, y)
        got.append(mix.score())
        want.append(float(jmix._score))
        oracle.append(float(jref._score))
    assert got[-1] < got[0] * 0.9
    np.testing.assert_allclose(got, want, **BAND)
    np.testing.assert_allclose(got, oracle, **BAND)
    for tree in (mix.params, mix.updater_state, mix.state):
        assert all(t.dtype == torch.float32 for t in _leaves(tree))
    assert mix.fused_updater_active()


def _graph(m, dtype, l2=0.0):
    conf_mod, input_mod, core_mod, conv_mod, upd_mod = m
    return (conf_mod.builder().seed(3).data_type(dtype)
            .updater(upd_mod.Adam(learning_rate=1e-2)).l2(l2)
            .graph_builder().add_inputs("in")
            .set_input_types(input_mod.feed_forward(10))
            .add_layer("d1", core_mod.DenseLayer(n_out=16,
                                                 activation="relu"), "in")
            .add_layer("bn", conv_mod.BatchNormalization(), "d1")
            .add_layer("out", core_mod.OutputLayer(n_out=4, loss="mcxent",
                                                   activation="softmax"),
                       "bn")
            .set_outputs("out").build())


def _pgraph(dtype, l2=0.0):
    return ComputationGraph(_graph((NeuralNetConfiguration, InputType, core,
                                    conv, upd), dtype, l2)).init(
        device="cpu")


@pytest.mark.parametrize("engine", ["sequential", "graph"])
def test_fused_step_equals_unfused_bitwise(engine):
    """Three steps of the fused master-cast step and of the unfused one
    from the same masters: params, updater state, BN statistics and the
    losses bit for bit; the fused step's carried compute copy is the
    bf16 cast of its masters."""
    x, y = _data(32)
    if engine == "sequential":
        nets = [_pnet("BFLOAT16") for _ in range(2)]
        batch = (torch.from_numpy(x), torch.from_numpy(y), None, None)
    else:
        x = x[:, :10].copy()
        y = np.eye(4, dtype=np.float32)[np.argmax(y, 1)]
        nets = [_pgraph("BFLOAT16") for _ in range(2)]
        batch = ((torch.from_numpy(x),), (torch.from_numpy(y),), (None,),
                 (None,))
    fused, plain = nets
    assert fused.fused_updater_active()
    sf = fused._build_train_step(fused_cast=True)
    su = plain._build_train_step(fused_cast=False)
    for _ in range(3):
        lf, lu = sf(*batch), su(*batch)
        assert torch.equal(lf, lu)
    assert _equal(fused.params, plain.params)
    assert _equal(fused.updater_state, plain.updater_state)
    assert _equal(fused.state, plain.state)
    assert _equal(sf.params_c, dtypes.cast_floating(fused.params,
                                                    torch.bfloat16))
    assert su.params_c is None
    with pytest.raises(ValueError, match="accum_steps"):
        fused._build_train_step(accum_steps=2, fused_cast=True)


@pytest.mark.parametrize("engine", ["sequential", "graph"])
def test_routing_decisions_match_jax(engine):
    """An l2 net routes to ``fallback_updater_penalty``, a float32 net to
    ``fallback_updater_dtype``, a bf16 net without a penalty to
    ``fused_updater``: one decision a step build, as the JAX package
    decides them."""
    from deeplearning4j_tpu.ops import fused_epilogues as jfe
    x, y = _data(16)
    for dtype, l2, want in (("BFLOAT16", 0.0, "fused_updater"),
                            ("BFLOAT16", 1e-3, "fallback_updater_penalty"),
                            ("FLOAT", 0.0, "fallback_updater_dtype")):
        if engine == "sequential":
            net, feats = _pnet(dtype, l2=l2), x
        else:
            net, feats = _pgraph(dtype, l2=l2), x[:, :10].copy()
            y = np.eye(4, dtype=np.float32)[np.argmax(y, 1) % 4]
        fe.reset_counters()
        net.fit(feats, y)
        net.fit(feats, y)
        assert fe.updater_counters()[want] == 1
        assert sum(fe.updater_counters().values()) == 1
        assert net.fused_updater_active() == (want == "fused_updater")
        assert (jfe.route_updater(dtype, has_penalty=bool(l2))
                or "fused_updater") == want
        assert (fe.route_updater(dtype, has_penalty=bool(l2))
                or "fused_updater") == want


def test_bf16_center_loss_centers_stay_f32():
    """A center-loss head under a bf16 policy: its centers move in f32,
    as the BN statistics do."""
    conf = (NeuralNetConfiguration.builder().seed(5).data_type("BFLOAT16")
            .updater(upd.Adam(learning_rate=1e-2))
            .input_type(InputType.feed_forward(12))
            .list(core.DenseLayer(n_out=8, activation="relu"),
                  special.CenterLossOutputLayer(n_out=3))
            .build())
    net = MultiLayerNetwork(conf).init(device="cpu")
    before = net.state["1"]["centers"].clone()
    x, y = _data(16)
    net.fit(x, y)
    c = net.state["1"]["centers"]
    assert c.dtype == torch.float32 and not torch.equal(c, before)
    assert "__features__" not in net.state["1"]
    assert all(t.dtype == torch.float32 for t in _leaves(net.params))


def test_jax_saved_bf16_net_resumes_in_the_port(tmp_path):
    """A bf16 net trained and saved by the JAX package loads in the port
    with f32 masters and updater state and the JAX net's values, serves
    as the JAX net does (within a bf16 ulp of the output's scale), and
    resumes: its next steps track the JAX net's within the band."""
    x, y = _data(32)
    jnet = _jnet("BFLOAT16")
    jnet.fit(x, y)
    path = str(tmp_path / "mix.zip")
    jnet.save(path)
    net = MultiLayerNetwork.load(path, device="cpu")
    assert net.conf.dtype == "BFLOAT16"
    for tree, jtree in ((net.params, jnet.params),
                        (net.updater_state, jnet.updater_state)):
        for g, w in zip(_leaves(tree), jax.tree.leaves(jtree)):
            assert g.dtype == torch.float32
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_allclose(net.output(x[:4]),
                               np.asarray(jnet.output(x[:4]), np.float32),
                               atol=1e-2)
    got, want = [], []
    for _ in range(3):
        net.fit(x, y)
        jnet.fit(x, y)
        got.append(net.score())
        want.append(float(jnet._score))
    np.testing.assert_allclose(got, want, **BAND)
    assert all(t.dtype == torch.float32 for t in _leaves(net.params))
