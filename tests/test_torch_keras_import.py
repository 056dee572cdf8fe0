"""The port's Keras import against the JAX importer, on the CPU.

The same files go through both importers (h5py on the JAX side, the
port's own HDF5 reader on the port's; h5py and Keras are oracles only):

- every committed Keras fixture (4 ``.h5``, 2 ``.keras``): the same
  network kind and configuration JSON, parameters and state equal element
  for element, outputs within 1e-5 of the JAX network's and within the
  JAX tests' tolerances of the recorded outputs (``test_import_smoke.py``
  rtol 1e-4 / atol 1e-4, ``test_import_corpus.py`` rtol 2e-4 / atol
  2e-5);
- the epilogue dispatch count of one forward of ``keras_smoke.h5`` and
  ``keras_sepdw.h5`` equal to the JAX package's ``fused_epilogues``
  counters (the constants ``chip_smoke.py`` asserts as K1 launches);
- an imported LSTM runs the plain cell (no K8) unless its layers opt in
  with ``use_pallas_cell=True``, as in JAX;
- config-only import from a JSON string, a ``.json`` path and an ``.h5``;
  the Keras-1 spellings; ``register_lambda_layer`` and
  ``register_custom_layer``; the loud refusals with the JAX importer's
  exception types; the mappers whose target kind is not ported raising
  ``NotImplementedError`` naming ROADMAP Queue 1 item 10;
- the golden replay of ``golden_harness.run_keras_imported`` at the
  harness's tolerances;
- the committed Keras ResNet-50 configuration at full width (topology
  equal to the JAX import's; every parameter shape, which the input size
  does not change, equal to JAX's at 32x32) and, cut to 32x32 with
  seeded Keras-layout weights given to both importers as a dict, its
  batch-2 output and global-pool activations within 1e-4 of JAX's
  (relative to the largest magnitude: 53 float32 convolutions on two CPU
  libraries).
"""

import json
import pathlib
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.modelimport import keras as jk
from deeplearning4j_tpu.ops import fused_epilogues as jfe
from deeplearning4j_tpu_torch.modelimport import keras as pk
from deeplearning4j_tpu_torch.ops import fused_epilogues as fe
from deeplearning4j_tpu_torch.ops import pallas_kernels as pallas
from deeplearning4j_tpu_torch.tools import keras_golden
from deeplearning4j_tpu_torch.tools import make_keras_config as mk

import golden_harness

FIXTURES = pathlib.Path(__file__).resolve().parent / "fixtures"
SMOKE_TOL = (1e-4, 1e-4)       # test_import_smoke.py (rtol, atol)
CORPUS_TOL = (2e-4, 2e-5)      # test_import_corpus.py
JAX_TOL = 1e-5                 # port output vs the JAX network's
RESNET_TOL = 1e-4              # relative to the largest |value|
#: epilogue dispatches (K1 launches on the card) of one forward; the
#: constants chip_smoke.py asserts: keras_smoke's Conv2D bias+ReLU and its
#: BatchNormalization; keras_sepdw's separable and depthwise convolutions
#: apply their activation as the JAX layers do, outside the epilogue
EPILOGUES_PER_FORWARD = {"keras_smoke.h5": 2, "keras_sepdw.h5": 0}
#: K8 decisions of one keras_lstm.h5 request with use_pallas_cell=True: 2
#: layers x the engine's time bucket 8 for the recorded T = 6
LSTM_K8_PER_REQUEST = 16


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


def _io(name):
    stem = name.rsplit(".", 1)[0]
    if stem == "keras_smoke":
        z = np.load(FIXTURES / "import_smoke_io.npz")
        return z["keras_x"], z["keras_y"], SMOKE_TOL
    z = np.load(FIXTURES / "import_corpus_io.npz")
    return z[stem + "_x"], z[stem + "_y"], CORPUS_TOL


def _np(t):
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def _same_tree(ours, theirs, where):
    assert ours.keys() == theirs.keys(), where
    for k in theirs:
        if isinstance(theirs[k], dict):
            _same_tree(ours[k], theirs[k], f"{where}/{k}")
            continue
        a, b = _np(ours[k]), np.asarray(theirs[k])
        assert a.dtype == b.dtype and a.shape == b.shape, (where, k)
        assert np.array_equal(a, b), (where, k)


def _same_config(ours, theirs):
    assert type(ours).__name__ == type(theirs).__name__
    assert json.loads(ours.conf.to_json()) == json.loads(
        theirs.conf.to_json())


FILES = ["keras_smoke.h5", "keras_lstm.h5", "keras_bigru.h5",
         "keras_sepdw.h5", "keras_v3_lstm.keras",
         "keras_v3_lstm_dropout.keras"]


@pytest.mark.parametrize("name", FILES)
def test_fixture_imports_as_jax_imports_it(name):
    path = str(FIXTURES / name)
    theirs = jk.KerasModelImport.import_keras_model_and_weights(path)
    ours = pk.KerasModelImport.import_keras_model_and_weights(
        path, device="cpu")
    _same_config(ours, theirs)
    _same_tree(ours.params, theirs.params, "params")
    _same_tree(ours.state, theirs.state, "state")
    x, want, (rtol, atol) = _io(name)
    got, ref = ours.output(x), np.asarray(theirs.output(x))
    np.testing.assert_allclose(got, ref, rtol=JAX_TOL, atol=JAX_TOL)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)
    for mod in ("h5py", "keras", "tensorflow"):
        # the oracles may be loaded by the JAX side; the port's modules
        # never name them (tests/test_torch_isolation.py scans them)
        assert mod not in vars(pk) and mod not in vars(pk.hdf5)


@pytest.mark.parametrize("name", sorted(EPILOGUES_PER_FORWARD))
def test_epilogue_dispatches_match_jax(name):
    path = str(FIXTURES / name)
    x = _io(name)[0]
    theirs = jk.KerasModelImport.import_keras_model_and_weights(path)
    ours = pk.KerasModelImport.import_keras_model_and_weights(
        path, device="cpu")
    jfe.reset_counters()
    theirs._forward(theirs.params, jnp.asarray(x), theirs.state,
                    train=False, rng=None)
    fe.reset_counters()
    with torch.no_grad():
        ours._forward(ours.params, torch.from_numpy(x), ours.state)
    n_jax = sum(jfe.counters().values())
    n_port = sum(fe.counters().values())
    assert n_port == n_jax == EPILOGUES_PER_FORWARD[name]
    assert fe.counters()["fallback_platform"] == n_port


def test_imported_lstm_runs_k8_only_when_opted_in():
    path = str(FIXTURES / "keras_lstm.h5")
    x, want, (rtol, atol) = _io("keras_lstm.h5")
    net = pk.KerasModelImport.import_keras_model_and_weights(
        path, device="cpu")
    theirs = jk.KerasModelImport.import_keras_model_and_weights(path)
    lstm = [l for l in net.conf.layers if l.kind == "lstm"]
    assert len(lstm) == 2 and not any(l.use_pallas_cell for l in lstm)
    assert not any(l.use_pallas_cell for l in theirs.conf.layers
                   if l.kind == "lstm")
    pallas.reset_counters()
    plain = net.output(x)
    assert sum(pallas.counters().values()) == 0
    for l in lstm:
        l.use_pallas_cell = True
    pallas.reset_counters()
    got = net.output(x)
    assert pallas.counters() == {"fused": 0,
                                 "fallback_platform": LSTM_K8_PER_REQUEST}
    np.testing.assert_allclose(got, plain, rtol=JAX_TOL, atol=JAX_TOL)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


# --------------------------------------------------------- config-only

def test_config_only_from_json_string_path_and_h5(tmp_path):
    h5 = str(FIXTURES / "keras_smoke.h5")
    with pk.hdf5.File(h5) as f:
        text = f.attrs["model_config"]
    jpath = tmp_path / "model.json"
    jpath.write_text(text)
    for source in (text, str(jpath), h5):
        ours = pk.KerasModelImport.import_keras_model_configuration(
            source, device="cpu")
        theirs = jk.KerasModelImport.import_keras_model_configuration(source)
        _same_config(ours, theirs)
        assert {v: {k: tuple(t.shape) for k, t in p.items()}
                for v, p in ours.params.items()} == \
            {v: {k: tuple(t.shape) for k, t in p.items()}
             for v, p in theirs.params.items()}
    seq = pk.KerasModelImport.import_keras_sequential_configuration(
        text, device="cpu")
    assert type(seq).__name__ == "MultiLayerNetwork"


def _seq(*layers, shape=(None, 8, 8, 3)):
    return {"class_name": "Sequential", "config": {"name": "m", "layers": [
        {"class_name": "InputLayer", "config": {"name": "in",
                                                "batch_shape": list(shape)}},
        *layers]}}


def _layer(cls, name="l", **cfg):
    return {"class_name": cls, "config": {"name": name, **cfg}}


def _tensor(name):
    return {"class_name": "__keras_tensor__",
            "config": {"keras_history": [name, 0, 0]}}


def _functional(layers, inputs=("in",), outputs=("out",),
                shape=(None, 4)):
    ins = [{"class_name": "InputLayer",
            "config": {"name": n, "batch_shape": list(shape)}}
           for n in inputs]
    body = []
    for cls, name, parents, cfg in layers:
        args = [_tensor(p) for p in parents]
        body.append({"class_name": cls, "config": {"name": name, **cfg},
                     "inbound_nodes": [{"args": [args if len(args) > 1
                                                 else args[0]],
                                        "kwargs": {}}]})
    return {"class_name": "Functional", "config": {
        "name": "m", "layers": ins + body,
        "input_layers": [[n, 0, 0] for n in inputs],
        "output_layers": [[n, 0, 0] for n in outputs]}}


KERAS1 = {"class_name": "Sequential", "config": [
    {"class_name": "Convolution2D", "config": {
        "name": "c", "nb_filter": 4, "nb_row": 3, "nb_col": 3,
        "border_mode": "same", "subsample": [1, 1], "activation": "relu",
        "bias": True, "init": "glorot_uniform", "dim_ordering": "tf",
        "batch_input_shape": [None, 8, 8, 3]}},
    {"class_name": "Dropout", "config": {"name": "d", "p": 0.25}},
    {"class_name": "Flatten", "config": {"name": "f"}},
    {"class_name": "Dense", "config": {"name": "o", "output_dim": 3,
                                       "activation": "softmax"}}]}

CONFIGS = {
    "keras1_spellings": KERAS1,
    "functional_merges": _functional([
        ("Dense", "a", ["in"], {"units": 4}),
        ("Dense", "b", ["in"], {"units": 4}),
        ("Add", "add", ["a", "b"], {}),
        ("Subtract", "sub", ["a", "b"], {}),
        ("Multiply", "mul", ["add", "sub"], {}),
        ("Maximum", "max", ["mul", "a"], {}),
        ("Minimum", "min", ["max", "b"], {}),
        ("Average", "avg", ["min", "a"], {}),
        ("Concatenate", "cat", ["avg", "b"], {}),
        ("Dot", "dot", ["a", "b"], {"axes": 1}),
        ("Concatenate", "cat2", ["cat", "dot"], {}),
        ("Dense", "out", ["cat2"], {"units": 2, "activation": "softmax"})]),
    "conv_family": _seq(
        _layer("ZeroPadding2D", "zp", padding=[[0, 1], [1, 2]]),
        _layer("Conv2DTranspose", "ct", filters=3, kernel_size=[2, 2],
               strides=[2, 2], padding="same"),
        _layer("SeparableConv2D", "sc", filters=4, kernel_size=[3, 3],
               padding="same", depth_multiplier=2),
        _layer("DepthwiseConv2D", "dc", kernel_size=[3, 3]),
        _layer("Cropping2D", "cr", cropping=[[1, 0], [0, 1]]),
        _layer("UpSampling2D", "up", size=[2, 2], interpolation="bilinear"),
        _layer("AveragePooling2D", "ap", pool_size=[2, 2]),
        _layer("LocallyConnected2D", "lc", filters=2, kernel_size=[3, 3]),
        _layer("ReLU", "r6", max_value=6.0),
        _layer("Permute", "p", dims=[2, 1, 3]),
        _layer("Reshape", "rs", target_shape=[-1, 2]),
        _layer("Conv1D", "c1", filters=3, kernel_size=2, padding="same"),
        _layer("SeparableConv1D", "s1", filters=3, kernel_size=2),
        _layer("ZeroPadding1D", "z1", padding=[1, 2]),
        _layer("Cropping1D", "cr1", cropping=[1, 1]),
        _layer("UpSampling1D", "u1", size=2),
        _layer("MaxPooling1D", "mp1", pool_size=2),
        _layer("LocallyConnected1D", "l1", filters=2, kernel_size=2),
        _layer("GlobalAveragePooling1D", "g1"),
        _layer("Dense", "out", units=2)),
}


@pytest.mark.parametrize("case", sorted(CONFIGS))
def test_config_only_matches_jax(case):
    text = json.dumps(CONFIGS[case])
    ours = pk.KerasModelImport.import_keras_model_configuration(
        text, device="cpu")
    theirs = jk.KerasModelImport.import_keras_model_configuration(text)
    _same_config(ours, theirs)


def test_lambda_and_custom_layers_register_in_both():
    from deeplearning4j_tpu.nn.layers.core import ActivationLayer as JAct
    from deeplearning4j_tpu_torch.nn.layers.core import ActivationLayer
    cfg = json.dumps(_seq(_layer("Lambda", "lam"), _layer("MyDense", "md",
                                                          units=3),
                          shape=(None, 5)))
    for imp in (pk, jk):
        with pytest.raises(ValueError, match="register_lambda_layer"):
            imp.KerasModelImport.import_keras_model_configuration(
                cfg, **({"device": "cpu"} if imp is pk else {}))
    try:
        pk.register_lambda_layer("lam", ActivationLayer(activation="tanh"))
        jk.register_lambda_layer("lam", JAct(activation="tanh"))
        pk.register_custom_layer("MyDense", pk._map_dense)
        jk.register_custom_layer("MyDense", jk._map_dense)
        ours = pk.KerasModelImport.import_keras_model_configuration(
            cfg, device="cpu")
        theirs = jk.KerasModelImport.import_keras_model_configuration(cfg)
        _same_config(ours, theirs)
        assert [l.kind for l in ours.conf.layers] == ["activation", "output"]
    finally:
        for imp in (pk, jk):
            imp._LAMBDA_LAYERS.pop("lam", None)
            imp._MAPPERS.pop("MyDense", None)


REFUSALS = {
    "unknown_class": _seq(_layer("Foo")),
    "unknown_model_class": {"class_name": "Foo", "config": {}},
    "no_input_shape": {"class_name": "Sequential", "config": {
        "layers": [_layer("Dense", units=2)]}},
    "relu_cap": _seq(_layer("ReLU", max_value=3.0)),
    "relu_slope": _seq(_layer("ReLU", negative_slope=0.1)),
    "activation": _seq(_layer("Activation", activation="exponential")),
    "channels_first": _seq(_layer("Conv2D", filters=2, kernel_size=3,
                                  data_format="channels_first")),
    "conv1d_causal": _seq(_layer("Conv1D", filters=2, kernel_size=2,
                                 padding="causal"), shape=(None, 5, 3)),
    "upsample_bicubic": _seq(_layer("UpSampling2D", size=2,
                                    interpolation="bicubic")),
    "deconv_dilation": _seq(_layer("Conv2DTranspose", filters=2,
                                   kernel_size=2, dilation_rate=2)),
    "lstm_return_state": _seq(_layer("LSTM", units=2, return_state=True),
                              shape=(None, 5, 3)),
    "lstm_backwards": _seq(_layer("LSTM", units=2, go_backwards=True),
                           shape=(None, 5, 3)),
    "lstm_hard_sigmoid": _seq(_layer("LSTM", units=2,
                                     recurrent_activation="hard_sigmoid"),
                              shape=(None, 5, 3)),
    "bidirectional_dense": _seq(_layer("Bidirectional", layer={
        "class_name": "Dense", "config": {"units": 2}}), shape=(None, 5, 3)),
    "time_distributed_lstm": _seq(_layer("TimeDistributed", layer={
        "class_name": "LSTM", "config": {"name": "i", "units": 2}}),
        shape=(None, 5, 3)),
    "keras1_highway": {"class_name": "Sequential", "config": [
        {"class_name": "Highway", "config": {
            "name": "h", "batch_input_shape": [None, 4]}}]},
    "keras1_full": {"class_name": "Sequential", "config": [
        {"class_name": "Convolution2D", "config": {
            "name": "c", "nb_filter": 2, "nb_row": 3, "nb_col": 3,
            "border_mode": "full", "batch_input_shape": [None, 8, 8, 3]}}]},
    "keras1_th": {"class_name": "Sequential", "config": [
        {"class_name": "Convolution2D", "config": {
            "name": "c", "nb_filter": 2, "nb_row": 3, "nb_col": 3,
            "dim_ordering": "th", "batch_input_shape": [None, 8, 8, 3]}}]},
    "dot_normalize": _functional([
        ("Dot", "out", ["in", "in"], {"axes": 1, "normalize": True})]),
    "dot_axes": _functional([
        ("Dot", "out", ["in", "in"], {"axes": [1, 2]})]),
    "functional_lstm_last": _functional([
        ("LSTM", "out", ["in"], {"units": 2})], shape=(None, 5, 3)),
    "cross_attention": _functional([
        ("MultiHeadAttention", "out", ["a", "b"],
         {"num_heads": 2, "key_dim": 2})], inputs=("a", "b"),
        shape=(None, 5, 4)),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_refusals_raise_as_jax_raises(case):
    text = json.dumps(REFUSALS[case])
    with pytest.raises(Exception) as jax_err:
        jk.KerasModelImport.import_keras_model_configuration(text)
    with pytest.raises(jax_err.type):
        pk.KerasModelImport.import_keras_model_configuration(
            text, device="cpu")


def test_grouped_conv2d_is_refused():
    text = json.dumps(_seq(_layer("Conv2D", filters=4, kernel_size=3,
                                  groups=3)))
    with pytest.raises(ValueError, match="groups"):
        pk.KerasModelImport.import_keras_model_configuration(
            text, device="cpu")


#: the Keras classes whose port mapper raises until the port has their
#: target kind
NOT_PORTED = sorted(k for k, m in pk._MAPPERS.items()
                    if m.__qualname__.startswith("_not_ported"))


def test_the_unported_mappers_are_the_roadmaps():
    assert NOT_PORTED == sorted(
        ["Conv3D", "Conv3DTranspose", "Cropping3D", "ZeroPadding3D",
         "UpSampling3D", "MaxPooling3D", "AveragePooling3D",
         "LayerNormalization", "PReLU", "SpatialDropout1D",
         "SpatialDropout2D", "SpatialDropout3D", "GaussianNoise",
         "GaussianDropout", "AlphaDropout"])


@pytest.mark.parametrize("cls", NOT_PORTED)
def test_unported_targets_raise_naming_item_10(cls):
    assert cls in jk._MAPPERS
    text = json.dumps(_seq(_layer(cls, rate=0.1, stddev=0.1),
                           shape=(None, 4, 4, 4, 2)))
    with pytest.raises(NotImplementedError, match="Queue 1 item 10"):
        pk.KerasModelImport.import_keras_model_configuration(
            text, device="cpu")


def test_every_jax_mapper_has_a_port_mapper():
    assert set(pk._MAPPERS) == set(jk._MAPPERS)


# ------------------------------------------------------- golden replay

def test_golden_replay_follows_the_fixture():
    """``golden_harness.run_keras_imported`` in the port: keras_smoke.h5,
    Sgd(0.05), 8 steps of batch 16 from ``default_rng(20260733)``."""
    assert (keras_golden.STEPS, keras_golden.BATCH) == (
        golden_harness.STEPS, golden_harness.BATCH)
    snap = keras_golden.replay(keras_golden.golden_net(device="cpu"))
    with open(keras_golden.GOLDEN) as f:
        golden = json.load(f)
    golden_harness.compare(snap, golden)
    assert keras_golden.band_share(snap, golden) <= 1.0


# ------------------------------------------------ Keras ResNet-50 config

def test_resnet50_full_width_topology_matches_jax(monkeypatch):
    """The configuration at full width equals the JAX import's (the JAX
    graph's ``init`` is patched out: 25.6 M random draws would only be
    thrown away); the parameter shapes, which do not depend on the input
    size, are held to JAX's at 32x32 below."""
    from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
    cfg = mk.config()
    ours = pk._import_model(cfg, None, torch.device("cpu"))
    monkeypatch.setattr(JGraph, "init", lambda self, *a, **k: self)
    theirs = jk._import_functional(cfg, None)
    _same_config(ours, theirs)
    small = pk._import_model(mk.config(hw=32), None, torch.device("cpu"))
    assert {v: {k: tuple(t.shape) for k, t in p.items()}
            for v, p in ours.params.items()} == \
        {v: {k: tuple(t.shape) for k, t in p.items()}
         for v, p in small.params.items()}
    assert sum(t.numel() for p in ours.params.values()
               for t in p.values()) == 25_583_592
    kinds = [v.layer.kind for _, v, _ in ours.conf.vertices
             if hasattr(v, "layer")]
    assert kinds.count("conv2d") == 53 and kinds.count("batchnorm") == 53
    fold, skip = ours._epilogue_fold_plan()
    assert len(fold) == 33 and len(skip) == 33  # the 16 after an Add stay


def test_resnet50_seeded_weights_match_jax_at_32x32():
    cfg = mk.config(hw=32)
    weights = mk.seeded_weights(cfg, seed=0)
    ours = pk._import_model(cfg, weights, torch.device("cpu"))
    theirs = jk._import_functional(cfg, weights)
    # every parameter and its shape equal to JAX's, element for element
    _same_tree(ours.params, theirs.params, "params")
    _same_tree(ours.state, theirs.state, "state")
    x = np.random.default_rng(7).standard_normal((2, 32, 32, 3)).astype(
        np.float32)
    fe.reset_counters()
    got = ours.output(x)
    assert sum(fe.counters().values()) == 106  # 53 bias_act + 53 bn_act
    ref = np.asarray(theirs.output(x))
    assert np.abs(got - ref).max() <= RESNET_TOL * np.abs(ref).max()
    pool = _np(ours.feed_forward(x)["avg_pool"])
    ref_pool = np.asarray(theirs.feed_forward(x)["avg_pool"])
    assert np.abs(pool - ref_pool).max() <= \
        RESNET_TOL * np.abs(ref_pool).max()
    assert "h5py" not in vars(sys.modules[pk.__name__])
