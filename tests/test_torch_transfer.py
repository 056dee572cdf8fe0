"""Transfer learning in the port against the JAX package, on the CPU: the
cases of the JAX package's ``tests/test_transfer.py`` (freezing ancestors,
re-heading, ``nout_replace``, removing and adding an output layer, the
updater override, the frozen serde round trip, the helper's
``featurize``/``fit_featurized``, ``remove_vertex`` keeping connections,
a replaced output keeping its slot), run on both packages from the same
weights; the fold plans of a transfer graph (ResNet-50 frozen to the end
of its third stage) and of a small conv graph frozen in the middle; and
the gradients of a graph with a frozen layer downstream of a trainable
one.

Both nets are built by each package's own builder from the same
description, and the port takes the JAX net's weights (``from_numpy``).
Frozen parameters and running statistics are compared bit for bit; the
trainable ones after Adam steps to atol 1e-6 plus rtol 1e-4 (as in
``tests/test_torch_training.py``: float32 gradient sums in another order
move a step's last digits); forward outputs to 1e-5; gradients to rtol
1e-5, atol 1e-6. Re-initialized layers come from the port's generator, so
they are checked by distribution."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.data import dataset as jds
from deeplearning4j_tpu.models.resnet import resnet as jresnet
from deeplearning4j_tpu.nn import config as jconfig
from deeplearning4j_tpu.nn import transfer as jtransfer
from deeplearning4j_tpu.nn import updaters as jupd
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.layers import conv as jconv
from deeplearning4j_tpu.nn.layers import core as jcore
from deeplearning4j_tpu.nn.layers import wrappers as jwrap
from deeplearning4j_tpu.nn.model import MultiLayerNetwork as JNet
from deeplearning4j_tpu_torch.data import dataset as pds
from deeplearning4j_tpu_torch.models.resnet import resnet as presnet
from deeplearning4j_tpu_torch.nn import config as pconfig
from deeplearning4j_tpu_torch.nn import transfer as ptransfer
from deeplearning4j_tpu_torch.nn import updaters as pupd
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph as PGraph
from deeplearning4j_tpu_torch.nn.layers import conv as pconv
from deeplearning4j_tpu_torch.nn.layers import core as pcore
from deeplearning4j_tpu_torch.nn.layers import wrappers as pwrap
from deeplearning4j_tpu_torch.nn.model import MultiLayerNetwork as PNet
from deeplearning4j_tpu_torch.utils.convert import from_numpy

J = types.SimpleNamespace(conf=jconfig, core=jcore, conv=jconv, upd=jupd,
                          wrap=jwrap, Net=JNet, Graph=JGraph, ds=jds,
                          tl=jtransfer)
P = types.SimpleNamespace(conf=pconfig, core=pcore, conv=pconv, upd=pupd,
                          wrap=pwrap, Net=PNet, Graph=PGraph, ds=pds,
                          tl=ptransfer)
STEP = dict(rtol=1e-4, atol=1e-6)


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


def _xor(n=64, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, size=(n, 2)).astype(np.float32)
    y = ((x[:, 0] > 0) ^ (x[:, 1] > 0)).astype(np.int64)
    return x, np.eye(2, dtype=np.float32)[y]


def _np_tree(t):
    if isinstance(t, dict):
        return {k: _np_tree(v) for k, v in t.items()}
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def _adopt(pnet, jnet):
    """The port net takes the JAX net's params, state and updater state."""
    pnet.params, pnet.state, pnet.updater_state = from_numpy(
        jnet.params, jnet.state, "cpu", updater_state=jnet.updater_state)
    return pnet


def _pair(build):
    """``build(ns)`` for both packages; the port net on the CPU with the
    JAX net's weights."""
    jnet = build(J).init()
    return jnet, _adopt(build(P).init(device="cpu"), jnet)


def _assert_trees(got, want, exact=False, **tol):
    got, want = _np_tree(got), _np_tree(want)
    assert set(got) == set(want)
    for k in want:
        if isinstance(want[k], dict):
            _assert_trees(got[k], want[k], exact, **tol)
        elif exact:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            np.testing.assert_allclose(got[k], want[k], err_msg=k, **tol)


def _mln(ns, seed=42):
    conf = (ns.conf.NeuralNetConfiguration.builder()
            .seed(seed)
            .updater(ns.upd.Adam(learning_rate=0.05))
            .input_type(ns.conf.InputType.feed_forward(2))
            .list(ns.core.DenseLayer(n_out=16, activation="tanh"),
                  ns.core.DenseLayer(n_out=8, activation="relu"),
                  ns.core.OutputLayer(n_out=2, loss="mcxent",
                                      activation="softmax"))
            .build())
    return ns.Net(conf)


def _graph(ns, depth=2):
    g = (ns.conf.NeuralNetConfiguration.builder()
         .seed(7)
         .updater(ns.upd.Adam(learning_rate=0.05))
         .graph_builder()
         .add_inputs("in")
         .set_input_types(ns.conf.InputType.feed_forward(2))
         .add_layer("d1", ns.core.DenseLayer(n_out=8, activation="tanh"),
                    "in"))
    top = "d1"
    if depth == 2:
        g.add_layer("d2", ns.core.DenseLayer(n_out=8, activation="relu"),
                    "d1")
        top = "d2"
    return ns.Graph(g.add_layer("out", ns.core.OutputLayer(n_out=2), top)
                    .set_outputs("out").build())


def _both_ways(jnet, pnet, make):
    """``make(ns, net)`` (a transfer build) in each package."""
    return make(J, jnet), make(P, pnet)


# ------------------------------------------------------ MultiLayerNetwork

def test_frozen_layer_params_do_not_move_and_the_rest_match_jax():
    x, y = _xor()
    jnet, pnet = _pair(_mln)
    jnew, pnew = _both_ways(
        jnet, pnet, lambda ns, n: ns.tl.TransferLearning.Builder(n)
        .set_feature_extractor(0).build())
    assert isinstance(pnew.layers[0], pwrap.FrozenLayer)
    assert pnew.conf.to_json() == jnew.conf.to_json()
    _adopt(pnew, jnew)
    before = {k: v.clone() for k, v in pnew.params["0"].items()}
    jnew.fit(jds.DataSet(x, y), epochs=3)
    pnew.fit(pds.DataSet(x, y), epochs=3)
    for k, v in before.items():
        assert torch.equal(pnew.params["0"][k], v)  # frozen: bit-exact
    _assert_trees(pnew.params, jnew.params, **STEP)
    assert (pnew.params["1"]["W"] - pnet.params["1"]["W"]).abs().max() > 1e-6
    # a frozen layer's updater slots are left as they were
    assert not pnew.updater_state["m"]["0"]["W"].any()


def test_transfer_copies_trained_params():
    x, y = _xor()
    jnet, pnet = _pair(_mln)
    pnet.fit(pds.DataSet(x, y), epochs=2)
    new = ptransfer.TransferLearning.Builder(pnet).set_feature_extractor(
        0).build()
    assert new.params["0"]["W"] is pnet.params["0"]["W"]
    assert torch.equal(new.params["2"]["b"], pnet.params["2"]["b"])


def test_nout_replace_reinits_the_next_layer_like_jax():
    jnet, pnet = _pair(_mln)
    jnew, pnew = _both_ways(
        jnet, pnet, lambda ns, n: ns.tl.TransferLearning.Builder(n)
        .nout_replace(1, 12).build())
    assert pnew.conf.to_json() == jnew.conf.to_json()
    for k in ("1", "2"):
        for name in ("W", "b"):
            assert tuple(pnew.params[k][name].shape) == \
                jnew.params[k][name].shape
    # layer 0 carried over bit for bit; 1 and 2 drawn anew, checked by
    # distribution: xavier's N(0, 2 / (fan_in + fan_out)) in both
    # packages, the sample std within 4 standard errors (1 / sqrt(2n))
    assert torch.equal(pnew.params["0"]["W"], pnet.params["0"]["W"])
    for k in ("1", "2"):
        got = pnew.params[k]["W"].numpy()
        assert got.shape != pnet.params[k]["W"].shape or \
            not np.array_equal(got, pnet.params[k]["W"].numpy())
        want = np.sqrt(2.0 / sum(got.shape))
        bound = 4 / np.sqrt(2 * got.size)
        for w in (got, np.asarray(jnew.params[k]["W"])):
            assert abs(w.std() / want - 1) < bound


def test_remove_and_add_output_layer_like_jax():
    jnet, pnet = _pair(_mln)
    jnew, pnew = _both_ways(
        jnet, pnet, lambda ns, n: ns.tl.TransferLearning.Builder(n)
        .remove_output_layer()
        .add_layer(ns.core.OutputLayer(n_out=5, loss="mcxent",
                                       activation="softmax")).build())
    assert pnew.conf.to_json() == jnew.conf.to_json()
    _adopt(pnew, jnew)
    x, _ = _xor(3)
    np.testing.assert_allclose(pnew.output(x), np.asarray(jnew.output(x)),
                               rtol=1e-5, atol=1e-6)
    assert pnew.output(x).shape == (3, 5)


def test_add_layer_at_a_conv_dense_seam_inserts_a_flatten_like_jax():
    def conv_net(ns):
        return ns.Net(
            ns.conf.NeuralNetConfiguration.builder().seed(3)
            .updater(ns.upd.Adam(learning_rate=0.01))
            .input_type(ns.conf.InputType.convolutional(2, 6, 6))
            .list(ns.conv.ConvolutionLayer(n_out=3, kernel=(3, 3)),
                  ns.core.DenseLayer(n_out=4),
                  ns.core.OutputLayer(n_out=2)).build())

    jnet, pnet = _pair(conv_net)
    jnew, pnew = _both_ways(
        jnet, pnet, lambda ns, n: ns.tl.TransferLearning.Builder(n)
        .remove_output_layers(2)
        .add_layer(ns.core.OutputLayer(n_out=3)).build())
    assert [l.kind for l in pnew.layers] == [l.kind for l in jnew.layers]
    assert pnew.conf.to_json() == jnew.conf.to_json()


def test_fine_tune_updater_override_like_jax():
    jnet, pnet = _pair(_mln)
    jnew, pnew = _both_ways(
        jnet, pnet, lambda ns, n: ns.tl.TransferLearning.Builder(n)
        .fine_tune_configuration(ns.tl.FineTuneConfiguration(
            updater=ns.upd.Sgd(learning_rate=0.5), l2=1e-3, seed=9))
        .build())
    assert pnew.conf.updater.kind == "sgd"
    assert pnew.conf.updater.learning_rate == 0.5
    assert pnew.conf.to_json() == jnew.conf.to_json()


def test_frozen_serde_round_trips_both_ways(tmp_path):
    jnet, pnet = _pair(_mln)
    jnew, pnew = _both_ways(
        jnet, pnet, lambda ns, n: ns.tl.TransferLearning.Builder(n)
        .set_feature_extractor(0).build())
    _adopt(pnew, jnew)
    x, _ = _xor(8)
    ppath, jpath = str(tmp_path / "p.zip"), str(tmp_path / "j.zip")
    pnew.save(ppath)
    jnew.save(jpath)
    for loaded in (PNet.load(ppath, device="cpu"),
                   PNet.load(jpath, device="cpu")):
        assert isinstance(loaded.layers[0], pwrap.FrozenLayer)
        assert loaded.conf.to_json() == jnew.conf.to_json()
        np.testing.assert_allclose(loaded.output(x), pnew.output(x),
                                   atol=1e-6)
    back = JNet.load(ppath)
    assert isinstance(back.layers[0], jwrap.FrozenLayer)
    np.testing.assert_allclose(np.asarray(back.output(x)), pnew.output(x),
                               atol=1e-6)


def test_transfer_helper_featurize_matches_jax():
    x, y = _xor(32)
    jnet, pnet = _pair(_mln)
    jnew, pnew = _both_ways(
        jnet, pnet, lambda ns, n: ns.tl.TransferLearning.Builder(n)
        .set_feature_extractor(1).build())
    _adopt(pnew, jnew)
    pfeat = ptransfer.TransferLearningHelper(pnew).featurize(
        pds.DataSet(x, y))
    jfeat = jtransfer.TransferLearningHelper(jnew).featurize(
        jds.DataSet(x, y))
    assert pfeat.features.shape == (32, 8)
    np.testing.assert_allclose(pfeat.features, np.asarray(jfeat.features),
                               rtol=1e-5, atol=1e-6)
    tail = ptransfer.TransferLearningHelper(pnew).unfrozen_graph()
    np.testing.assert_allclose(tail.output(pfeat.features), pnew.output(x),
                               atol=1e-5)


def test_transfer_helper_fit_featurized_trains_the_tail_like_jax():
    x, y = _xor()
    jnet, pnet = _pair(_mln)
    jnew, pnew = _both_ways(
        jnet, pnet, lambda ns, n: ns.tl.TransferLearning.Builder(n)
        .set_feature_extractor(0).build())
    _adopt(pnew, jnew)
    w_frozen = pnew.params["0"]["W"].clone()
    ph = ptransfer.TransferLearningHelper(pnew)
    jh = jtransfer.TransferLearningHelper(jnew)
    ph.fit_featurized(ph.featurize(pds.DataSet(x, y)), epochs=3)
    jh.fit_featurized(jh.featurize(jds.DataSet(x, y)), epochs=3)
    assert torch.equal(pnew.params["0"]["W"], w_frozen)
    _assert_trees(pnew.params, jnew.params, **STEP)


def test_frozen_parameters_are_not_moved_by_momentum_or_constraints():
    """The updater and the constraints skip a frozen key: a velocity left
    in its slot moves neither the parameter nor the slot."""
    x, y = _xor()
    _, pnet = _pair(_mln)
    from deeplearning4j_tpu_torch.nn import constraints as pcons
    new = (ptransfer.TransferLearning.Builder(pnet)
           .fine_tune_configuration(ptransfer.FineTuneConfiguration(
               updater=pupd.Nesterovs(learning_rate=0.1, momentum=0.9)))
           .set_feature_extractor(0).build())
    new.conf.constraints = [(pcons.MaxNormConstraint(max_norm=0.01),
                             "weights")]
    new.updater_state["v"]["0"]["W"] += 1.0
    before = {k: v.clone() for k, v in new.params["0"].items()}
    slot = new.updater_state["v"]["0"]["W"].clone()
    new.fit(pds.DataSet(x, y), epochs=2)
    for k, v in before.items():
        assert torch.equal(new.params["0"][k], v)
    assert torch.equal(new.updater_state["v"]["0"]["W"], slot)
    assert new.params["1"]["W"].norm(dim=0).max() <= 0.01 + 1e-6


# ------------------------------------------------------- ComputationGraph

def test_graph_freezes_ancestors_like_jax():
    x, y = _xor()
    jnet, pnet = _pair(_graph)
    jnew, pnew = _both_ways(
        jnet, pnet, lambda ns, n: ns.tl.TransferLearning.GraphBuilder(n)
        .set_feature_extractor("d2").build())
    vmap = {n: v for n, v, _ in pnew.conf.vertices}
    assert isinstance(vmap["d1"].layer, pwrap.FrozenLayer)
    assert isinstance(vmap["d2"].layer, pwrap.FrozenLayer)
    assert not isinstance(vmap["out"].layer, pwrap.FrozenLayer)
    assert pnew.conf.to_json() == jnew.conf.to_json()
    _adopt(pnew, jnew)
    frozen = {k: {n: t.clone() for n, t in pnew.params[k].items()}
              for k in ("d1", "d2")}
    jnew.fit(jds.DataSet(x, y), epochs=2)
    pnew.fit(pds.DataSet(x, y), epochs=2)
    _assert_trees({k: pnew.params[k] for k in frozen}, frozen, exact=True)
    _assert_trees(pnew.params, jnew.params, **STEP)


def test_graph_rehead_carries_trained_params_like_jax():
    x, y = _xor()
    jnet, pnet = _pair(lambda ns: _graph(ns, depth=1))
    jnet.fit(jds.DataSet(x, y), epochs=1)
    _adopt(pnet, jnet)
    jnew, pnew = _both_ways(
        jnet, pnet, lambda ns, n: ns.tl.TransferLearning.GraphBuilder(n)
        .remove_vertex("out")
        .add_layer("newout", ns.core.OutputLayer(n_out=3), "d1")
        .set_outputs("newout").build())
    assert pnew.conf.to_json() == jnew.conf.to_json()
    assert torch.equal(pnew.params["d1"]["W"], pnet.params["d1"]["W"])
    assert pnew.output(np.zeros((4, 2), np.float32)).shape == (4, 3)


def test_graph_remove_vertex_keeps_connections_like_jax():
    jnet, pnet = _pair(_graph)
    jnew, pnew = _both_ways(
        jnet, pnet, lambda ns, n: ns.tl.TransferLearning.GraphBuilder(n)
        .remove_vertex("d1", remove_outputs=False)
        .add_layer("d1", ns.core.DenseLayer(n_out=8, activation="elu"),
                   "in").build())
    assert pnew.conf.to_json() == jnew.conf.to_json()
    vmap = {n: v for n, v, _ in pnew.conf.vertices}
    assert vmap["d1"].layer.activation == "elu"
    assert torch.equal(pnew.params["d2"]["W"], pnet.params["d2"]["W"])
    assert pnew.output(np.zeros((4, 2), np.float32)).shape == (4, 2)
    with pytest.raises(ValueError, match="not re-added"):
        (ptransfer.TransferLearning.GraphBuilder(pnet)
         .remove_vertex("d1", remove_outputs=False).build())
    with pytest.raises(ValueError, match="unknown vertex"):
        ptransfer.TransferLearning.GraphBuilder(pnet).set_feature_extractor(
            "nope").build()


def test_graph_replaced_output_keeps_its_slot_like_jax():
    jnet, pnet = _pair(lambda ns: _graph(ns, depth=1))
    jnew, pnew = _both_ways(
        jnet, pnet, lambda ns, n: ns.tl.TransferLearning.GraphBuilder(n)
        .remove_vertex("out", remove_outputs=False)
        .add_layer("out", ns.core.OutputLayer(n_out=5), "d1").build())
    assert pnew.conf.outputs == jnew.conf.outputs == ["out"]
    assert pnew.output(np.zeros((3, 2), np.float32)).shape == (3, 5)


# ------------------------------------------- fold plans and frozen grads

def _fold_plan(net):
    fold, skip = net._epilogue_fold_plan()
    return dict(fold), set(skip)


def test_resnet50_transfer_graph_fold_plan_equals_jax(monkeypatch):
    """The plan of ResNet-50 frozen to ``s2_b5_out`` and re-headed on
    ``avgpool``: a frozen BN is not folded (the plan tests for
    BatchNormalization, which a FrozenLayer is not), so only stage 4's six
    a/b BNs fold; every one of the 53 BNs still runs the forward epilogue.
    The plan reads only the configuration, so the JAX nets skip their
    (slow) parameter draw here."""
    monkeypatch.setattr(JGraph, "init", lambda self, *a, **k: self)

    def make(ns, n):
        return (ns.tl.TransferLearning.GraphBuilder(n)
                .fine_tune_configuration(ns.tl.FineTuneConfiguration(
                    updater=ns.upd.Adam(learning_rate=1e-3)))
                .set_feature_extractor("s2_b5_out")
                .remove_vertex("fc")
                .add_layer("out", ns.core.OutputLayer(n_out=10), "avgpool")
                .set_outputs("out").build())

    jnew = make(J, jresnet(50, input_shape=(32, 32, 3), num_classes=10))
    pnew = make(P, presnet(50, input_shape=(32, 32, 3),
                           num_classes=10).init(device="cpu"))
    assert pnew.conf.to_json() == jnew.conf.to_json()
    fold, skip = _fold_plan(pnew)
    assert (fold, skip) == _fold_plan(jnew)
    assert sorted(fold) == sorted(f"s3_b{i}_{p}_bn" for i in range(3)
                                  for p in "ab")
    bns = [n for n, v, _ in pnew.conf.vertices
           if isinstance(getattr(getattr(v, "layer", None), "layer",
                                 getattr(v, "layer", None)),
                         pconv.BatchNormalization)]
    trainable = [n for n in bns if n not in pnew._frozen]
    assert len(bns) == 53 and len(trainable) == 10


def _small_conv(ns, freeze_middle):
    """conv -> BN -> relu -> conv -> BN -> relu -> pool -> output; with
    ``freeze_middle`` the second conv and BN are FrozenLayers."""
    wrap = ns.wrap.FrozenLayer if freeze_middle else (lambda layer: layer)
    g = (ns.conf.NeuralNetConfiguration.builder().seed(5)
         .updater(ns.upd.Adam(learning_rate=0.01))
         .graph_builder().add_inputs("in")
         .set_input_types(ns.conf.InputType.convolutional(
             3, 6, 6, data_format="NHWC")))
    top = "in"
    for i in (1, 2):
        fz = wrap if i == 2 else (lambda layer: layer)
        g.add_layer(f"c{i}", fz(layer=ns.conv.ConvolutionLayer(
            n_out=4, kernel=(3, 3), padding=(1, 1), has_bias=False,
            data_format="NHWC")), top)
        g.add_layer(f"bn{i}", fz(layer=ns.conv.BatchNormalization(
            data_format="NHWC")), f"c{i}")
        g.add_layer(f"r{i}", ns.core.ActivationLayer(activation="relu"),
                    f"bn{i}")
        top = f"r{i}"
    g.add_layer("pool", ns.conv.GlobalPoolingLayer(pool_type="avg",
                                                   data_format="NHWC"), top)
    g.add_layer("out", ns.core.OutputLayer(n_out=3), "pool")
    return ns.Graph(g.set_outputs("out").build())


@pytest.mark.parametrize("freeze_middle", [False, True])
def test_small_conv_graph_fold_plan_equals_jax(freeze_middle):
    jnet = _small_conv(J, freeze_middle)
    pnet = _small_conv(P, freeze_middle)
    assert _fold_plan(pnet) == _fold_plan(jnet)
    assert set(_fold_plan(pnet)[0]) == ({"bn1"} if freeze_middle
                                        else {"bn1", "bn2"})


def test_frozen_layer_downstream_of_a_trainable_one_matches_jax_grads():
    """The frozen middle still passes dx back to the trainable first conv
    and BN; its own gradients are zero. Running statistics: the frozen
    BN's stay, the trainable one's move, as in JAX."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((4, 6, 6, 3)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 4)]
    jnet, pnet = _pair(lambda ns: _small_conv(ns, True))
    loss_fn = jnet._build_loss_fn()

    def jloss(p):
        return loss_fn(p, jnet.state, jax.random.PRNGKey(0),
                       (jnp.asarray(x),), (jnp.asarray(y),), (None,),
                       (None,))

    (jl, jst), jg = jax.value_and_grad(jloss, has_aux=True)(jnet.params)
    pl, pg, pst = pnet._value_and_grad((torch.from_numpy(x),),
                                       (torch.from_numpy(y),), (None,),
                                       (None,))
    np.testing.assert_allclose(float(pl), float(jl), rtol=1e-5)
    _assert_trees(pg, jg, rtol=1e-5, atol=1e-6)
    for k in ("c2", "bn2"):
        assert not any(t.any() for t in pg[k].values())
    assert pg["c1"]["W"].abs().max() > 0
    _assert_trees(pst, jst, rtol=1e-5, atol=1e-6)
    assert all(torch.equal(pst["bn2"][k], pnet.state["bn2"][k])
               for k in ("mean", "var"))
    assert not torch.equal(pst["bn1"]["mean"], pnet.state["bn1"]["mean"])
    # the fit: frozen middle and its statistics bit-identical
    frozen = _np_tree({k: pnet.params[k] for k in ("c2", "bn2")})
    stats = _np_tree(pnet.state["bn2"])
    pnet.fit(pds.DataSet(x, y), epochs=2)
    jnet.fit(jds.DataSet(x, y), epochs=2)
    _assert_trees({k: pnet.params[k] for k in ("c2", "bn2")}, frozen,
                  exact=True)
    _assert_trees(pnet.state["bn2"], stats, exact=True)
    _assert_trees(pnet.params, jnet.params, **STEP)
