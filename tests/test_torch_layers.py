"""The port's ops and layers against the JAX package's, on the CPU, at
small shapes: conv2d (DL4J truncate and same modes, stride 2, even
kernels), pooling, global pooling, the space-to-depth stem, inference
batch norm with a folded relu, dense/output layers, the activation
catalog, weight-init distributions and layer serde.

Inputs come from ``np.random.default_rng`` and go through both sides.
float32 tolerance 1e-5: the JAX package computes its f32 convs and
matmuls at HIGHEST precision on the CPU, so both sides are plain float32
sums that differ only in summation order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn import weights as jweights
from deeplearning4j_tpu.nn.layers import conv as jconv
from deeplearning4j_tpu.nn.layers import conv_extra as jconv_extra
from deeplearning4j_tpu.nn.layers import core as jcore
from deeplearning4j_tpu.ops import activations as jact
from deeplearning4j_tpu.ops import nnops as jnn
from deeplearning4j_tpu_torch.nn import weights
from deeplearning4j_tpu_torch.nn.layers import LAYERS, Layer
from deeplearning4j_tpu_torch.nn.layers import conv, conv_extra, core
from deeplearning4j_tpu_torch.ops import activations as act
from deeplearning4j_tpu_torch.ops import nnops


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


TOL = dict(rtol=1e-5, atol=1e-5)


def _x(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got.detach() if torch.is_tensor(got)
                                          else got),
                               np.asarray(want), **(tol or TOL))


def _nchw_or_nhwc(shape_nchw, data_format):
    n, c, h, w = shape_nchw
    return shape_nchw if data_format == "NCHW" else (n, h, w, c)


@pytest.mark.parametrize("data_format", ["NCHW", "NHWC"])
@pytest.mark.parametrize("mode,kernel,stride,padding", [
    ("truncate", 3, 2, 1), ("truncate", 1, 1, 0), ("truncate", 7, 2, 3),
    ("same", 3, 2, 0), ("same", 4, 2, 0), ("same", 2, 1, 0),
])
def test_conv2d_matches_jax(data_format, mode, kernel, stride, padding):
    x = _x(0, _nchw_or_nhwc((2, 5, 11, 12), data_format))
    w = _x(1, (6, 5, kernel, kernel)) * 0.3
    b = _x(2, (6,))
    kw = dict(stride=(stride, stride), padding=(padding, padding),
              mode=mode, data_format=data_format)
    want = jnn.conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), **kw)
    got = nnops.conv2d(torch.from_numpy(x), torch.from_numpy(w),
                       torch.from_numpy(b), **kw)
    assert tuple(got.shape) == want.shape
    _close(got, want)


@pytest.mark.parametrize("data_format", ["NCHW", "NHWC"])
@pytest.mark.parametrize("kind", ["max", "avg", "pnorm"])
@pytest.mark.parametrize("mode,padding", [("truncate", 1), ("truncate", 0),
                                          ("same", 0)])
def test_pool_matches_jax(data_format, kind, mode, padding):
    x = _x(3, _nchw_or_nhwc((2, 4, 9, 10), data_format))
    fn = {"max": "max_pool2d", "avg": "avg_pool2d",
          "pnorm": "pnorm_pool2d"}[kind]
    args = ((3, 3), (2, 2), (padding, padding), mode, data_format)
    want = getattr(jnn, fn)(jnp.asarray(x), *args)
    got = getattr(nnops, fn)(torch.from_numpy(x), *args)
    assert tuple(got.shape) == want.shape
    _close(got, want)


def test_avg_pool_window_count_divisor_matches_jax():
    x = _x(4, (2, 9, 9, 3))
    kw = dict(kernel=(3, 3), stride=(2, 2), padding=(1, 1),
              data_format="NHWC", count_include_pad=False)
    _close(nnops.avg_pool2d(torch.from_numpy(x), **kw),
           jnn.avg_pool2d(jnp.asarray(x), **kw))


@pytest.mark.parametrize("data_format", ["NCHW", "NHWC"])
@pytest.mark.parametrize("pool_type", ["max", "avg", "sum", "pnorm"])
def test_global_pool_matches_jax(data_format, pool_type):
    x = _x(5, (3, 4, 5, 6))
    _close(nnops.global_pool(torch.from_numpy(x), pool_type, data_format),
           jnn.global_pool(jnp.asarray(x), pool_type, data_format))


@pytest.mark.parametrize("pool_type", ["avg", "max"])
def test_global_pooling_layer_matches_jax(pool_type):
    x = _x(6, (2, 4, 4, 8))
    want, _, _ = jconv.GlobalPoolingLayer(
        pool_type=pool_type, data_format="NHWC").apply({}, jnp.asarray(x), {})
    got, _, _ = conv.GlobalPoolingLayer(
        pool_type=pool_type, data_format="NHWC").apply({}, torch.from_numpy(x),
                                                       {})
    _close(got, want)


def test_space_to_depth_stem_matches_jax():
    """The port computes the plain 7x7/2 pad-3 conv that the JAX layer
    re-expresses through space-to-depth; same stored OIHW weight."""
    x = _x(7, (2, 16, 18, 3))
    w = _x(8, (8, 3, 7, 7)) * 0.2
    want, _, _ = jconv_extra.SpaceToDepthStemConv(n_out=8).apply(
        {"W": jnp.asarray(w)}, jnp.asarray(x), {})
    got, _, _ = conv_extra.SpaceToDepthStemConv(n_out=8).apply(
        {"W": torch.from_numpy(w)}, torch.from_numpy(x), {})
    assert tuple(got.shape) == want.shape == (2, 8, 9, 8)
    _close(got, want)


def test_space_to_depth_stem_init_shape():
    gen = torch.Generator().manual_seed(0)
    p, s, out = conv_extra.SpaceToDepthStemConv(n_out=64).initialize(
        gen, (32, 32, 3), torch.float32, "cpu")
    assert tuple(p["W"].shape) == (64, 3, 7, 7) and out == (16, 16, 64)
    with pytest.raises(ValueError, match="even spatial"):
        conv_extra.SpaceToDepthStemConv(n_out=4).initialize(
            gen, (7, 8, 3), torch.float32, "cpu")


def _bn_inputs(seed, c):
    rng = np.random.default_rng(seed)
    params = {"gamma": rng.standard_normal(c).astype(np.float32) + 1.0,
              "beta": rng.standard_normal(c).astype(np.float32)}
    state = {"mean": rng.standard_normal(c).astype(np.float32) * 0.5,
             "var": rng.random(c).astype(np.float32) + 0.3}
    return params, state


@pytest.mark.parametrize("fold_act", [None, "relu"])
@pytest.mark.parametrize("data_format,shape", [("NHWC", (2, 5, 5, 16)),
                                               ("NCHW", (2, 16, 5, 5))])
def test_batchnorm_inference_matches_jax(fold_act, data_format, shape):
    x = _x(9, shape)
    params, state = _bn_inputs(10, 16)
    kw = {} if fold_act is None else {"fold_act": fold_act}
    want, _, _ = jconv.BatchNormalization(data_format=data_format).apply(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x),
        {k: jnp.asarray(v) for k, v in state.items()}, **kw)
    got, _, _ = conv.BatchNormalization(data_format=data_format).apply(
        {k: torch.from_numpy(v) for k, v in params.items()},
        torch.from_numpy(x),
        {k: torch.from_numpy(v) for k, v in state.items()}, **kw)
    _close(got, want)


def test_batchnorm_train_branch_waits_for_training_slice():
    """The training slice has come: the train branch normalizes with the
    batch statistics and returns the new running statistics, as the JAX
    package's does (rtol 1e-5: float32 moments summed in another order)."""
    params, state = _bn_inputs(11, 4)
    x = _x(12, (2, 3, 3, 4))
    want, want_st, _ = jconv.BatchNormalization(data_format="NHWC").apply(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x),
        {k: jnp.asarray(v) for k, v in state.items()}, train=True)
    got, got_st, _ = conv.BatchNormalization(data_format="NHWC").apply(
        {k: torch.from_numpy(v) for k, v in params.items()},
        torch.from_numpy(x),
        {k: torch.from_numpy(v) for k, v in state.items()}, train=True)
    _close(got, want)
    for k in ("mean", "var"):
        np.testing.assert_allclose(got_st[k].numpy(), np.asarray(want_st[k]),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("has_bias", [True, False])
@pytest.mark.parametrize("data_format", ["NHWC", "NCHW"])
@pytest.mark.parametrize("activation", ["identity", "relu", "tanh"])
def test_convolution_layer_matches_jax(activation, data_format, has_bias):
    x = _x(12, _nchw_or_nhwc((2, 3, 8, 11), data_format))
    w = _x(13, (5, 3, 3, 3)) * 0.3
    b = _x(14, (5,))
    kw = dict(n_out=5, kernel=(3, 3), stride=(2, 2), padding=(1, 1),
              activation=activation, data_format=data_format,
              has_bias=has_bias)
    jp = {"W": jnp.asarray(w), "b": jnp.asarray(b)} if has_bias \
        else {"W": jnp.asarray(w)}
    pp = {"W": torch.from_numpy(w), "b": torch.from_numpy(b)} if has_bias \
        else {"W": torch.from_numpy(w)}
    want, _, _ = jconv.ConvolutionLayer(**kw).apply(jp, jnp.asarray(x), {})
    got, _, _ = conv.ConvolutionLayer(**kw).apply(pp, torch.from_numpy(x),
                                                  {})
    _close(got, want)


@pytest.mark.parametrize("kind", ["dense", "output"])
def test_dense_and_output_layers_match_jax(kind):
    x = _x(15, (4, 12))
    w = _x(16, (12, 7)) * 0.3
    b = _x(17, (7,))
    jl = {"dense": jcore.DenseLayer(n_out=7, activation="tanh"),
          "output": jcore.OutputLayer(n_out=7)}[kind]
    pl = {"dense": core.DenseLayer(n_out=7, activation="tanh"),
          "output": core.OutputLayer(n_out=7)}[kind]
    want, _, _ = jl.apply({"W": jnp.asarray(w), "b": jnp.asarray(b)},
                          jnp.asarray(x), {})
    got, _, _ = pl.apply({"W": torch.from_numpy(w), "b": torch.from_numpy(b)},
                         torch.from_numpy(x), {})
    _close(got, want)


def test_activation_catalog_names_match_jax():
    assert sorted(act.ACTIVATIONS) == sorted(jact.ACTIVATIONS)


@pytest.mark.parametrize("name", sorted(jact.ACTIVATIONS))
def test_activation_matches_jax(name):
    x = _x(18, (3, 4, 6)) * 3.0
    _close(act.ACTIVATIONS[name](torch.from_numpy(x)),
           jact.ACTIVATIONS[name](jnp.asarray(x)))


@pytest.mark.parametrize("name", ["leakyrelu", "elu", "thresholdedrelu"])
def test_parameterized_activation_matches_jax(name):
    x = _x(19, (5, 6)) * 3.0
    _close(act.get(name)(torch.from_numpy(x), 0.3),
           jact.get(name)(jnp.asarray(x), 0.3))


@pytest.mark.parametrize("init", ["relu", "xavier", "zero", "ones",
                                  "xavier_uniform", "lecun_normal"])
def test_weight_init_distribution_matches_jax(init):
    """Draws differ (torch Philox vs JAX threefry); the moments agree."""
    import jax
    shape, fan_in, fan_out = (64, 32, 3, 3), 32 * 9, 64 * 9
    got = weights.init(init, torch.Generator().manual_seed(0), shape,
                       fan_in, fan_out).numpy()
    want = np.asarray(jweights.init(init, jax.random.PRNGKey(0), shape,
                                    fan_in, fan_out, jnp.float32))
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got.mean(), want.mean(), atol=0.02)
    np.testing.assert_allclose(got.std(), want.std(), rtol=0.05, atol=1e-6)


@pytest.mark.parametrize("kind", sorted(LAYERS))
def test_layer_serde_matches_jax(kind):
    """Every port layer kind writes the JAX package's JSON dict and reads
    it back; a wrapper (``bidirectional``, ``time_distributed``) with a
    nested layer of its own."""
    from deeplearning4j_tpu.nn.layers.base import LAYERS as JLAYERS
    from deeplearning4j_tpu.nn.layers.base import Layer as JLayer
    d = {"kind": kind}
    if hasattr(JLAYERS[kind], "_from_dict_fields"):
        d["layer"] = JLayer.from_dict({"kind": "simple_rnn"}).to_dict()
    jd = JLayer.from_dict(d).to_dict()
    port = Layer.from_dict(d)
    assert port.to_dict() == jd
    assert Layer.from_dict(jd).to_dict() == jd
    if "layer" not in d:
        assert LAYERS[kind]().to_dict() == jd
