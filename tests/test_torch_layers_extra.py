"""The layer and vertex kinds the Keras import needs, against the JAX
package's, on the CPU.

Each kind at a small size, in NHWC and NCHW where the JAX layer takes
both: the same random parameters (shaped by the JAX layer's
``initialize``) and inputs through both layers, outputs within 1e-5
(relative to the largest magnitude) and the same output shape as both
``initialize``s report; the port's gradients by
``torch.autograd.gradcheck`` in float64. Then networks holding every new
kind, saved by the JAX package as ZIPs, load in the port with the same
configuration, parameters and outputs, and the port's ZIPs load back in
the JAX package.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeplearning4j_tpu.nn.layers.conv_extra  # noqa: F401 (registers)
from deeplearning4j_tpu.nn import vertices as jv
from deeplearning4j_tpu.nn.layers import core as jcore
from deeplearning4j_tpu.nn.layers.base import LAYERS as JLAYERS
from deeplearning4j_tpu.utils import serializer as jser
from deeplearning4j_tpu_torch.nn import vertices as pv
from deeplearning4j_tpu_torch.nn.layers.base import LAYERS as PLAYERS
from deeplearning4j_tpu_torch.utils import serializer as pser

TOL = 1e-5


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


def _nhwc(shape):
    """An NCHW (C, H, W) case's shape in NHWC."""
    c, h, w = shape
    return (h, w, c)


def _both(cases):
    """Each 2D case in NCHW and in NHWC."""
    out = []
    for name, kind, kw, shape in cases:
        out.append((f"{name}-NCHW", kind, dict(kw, data_format="NCHW"),
                    shape))
        out.append((f"{name}-NHWC", kind, dict(kw, data_format="NHWC"),
                    _nhwc(shape)))
    return out


LAYER_CASES = _both([
    ("lrn", "lrn", dict(k=2.0, n=3, alpha=0.05, beta=0.75), (6, 4, 5)),
    ("upsampling", "upsampling2d", dict(size=(2, 3)), (3, 4, 5)),
    ("zeropad", "zeropad2d", dict(padding=(1, 2)), (3, 4, 5)),
    ("zeropad_keras", "zeropad2d", dict(padding=((0, 1), (2, 1))),
     (3, 4, 5)),
    ("deconv", "deconv2d", dict(n_out=4, kernel=(3, 3), stride=(2, 2),
                                activation="tanh"), (3, 4, 5)),
    ("deconv_same", "deconv2d", dict(n_out=2, kernel=(2, 2), stride=(2, 2),
                                     mode="same"), (3, 4, 5)),
    ("separable", "separable_conv2d", dict(n_out=4, kernel=(3, 3),
                                           depth_multiplier=2,
                                           activation="tanh"), (3, 6, 5)),
    ("separable_same", "separable_conv2d", dict(n_out=3, kernel=(3, 3),
                                                stride=(2, 2), mode="same"),
     (2, 7, 6)),
    ("depthwise", "depthwise_conv2d", dict(kernel=(3, 3), dilation=(2, 1),
                                           activation="tanh"), (3, 7, 6)),
    ("depthwise_mult", "depthwise_conv2d", dict(kernel=(2, 2),
                                                depth_multiplier=2,
                                                mode="same"), (2, 5, 5)),
    ("cropping", "cropping2d", dict(cropping=(1, 0, 2, 1)), (3, 5, 6)),
    ("space_to_depth", "space_to_depth", dict(block_size=2), (3, 4, 6)),
    ("depth_to_space", "depth_to_space", dict(block_size=2), (8, 3, 2)),
]) + [
    ("upsampling_bilinear-NHWC", "upsampling2d",
     dict(size=(2, 2), interpolation="bilinear", data_format="NHWC"),
     (4, 5, 3)),
    ("conv1d", "conv1d", dict(n_out=4, kernel=3, mode="same",
                              activation="tanh"), (7, 3)),
    ("conv1d_strided", "conv1d", dict(n_out=2, kernel=2, stride=2,
                                      dilation=2), (10, 3)),
    ("subsampling1d_max", "subsampling1d", dict(kernel=2, pool_type="max"),
     (8, 3)),
    ("subsampling1d_avg", "subsampling1d", dict(kernel=3, stride=2,
                                                pool_type="avg",
                                                mode="same"), (7, 3)),
    ("upsampling1d", "upsampling1d", dict(size=3), (4, 3)),
    ("zeropad1d", "zeropad1d", dict(padding=(1, 2)), (4, 3)),
    ("cropping1d", "cropping1d", dict(cropping=(2, 1)), (6, 3)),
    ("separable1d", "separable_conv1d", dict(n_out=4, kernel=3,
                                             depth_multiplier=2,
                                             activation="tanh"), (7, 3)),
    ("locally_connected2d", "locally_connected2d",
     dict(n_out=3, kernel=(3, 2), stride=(1, 2), activation="tanh"),
     (5, 6, 2)),
    ("locally_connected1d", "locally_connected1d",
     dict(n_out=3, kernel=3, stride=2, activation="tanh"), (8, 2)),
    ("permute", "permute", dict(dims=(3, 1, 2)), (3, 4, 5)),
    ("reshape", "reshape", dict(target_shape=(-1, 2)), (3, 4)),
    ("elementwise_mult", "elementwise_mult", dict(activation="tanh"), (5,)),
]


def _params_for(jl, shape, rng):
    """The JAX layer's initial params' shapes, filled with N(0, 0.5)."""
    params, state, out = jl.initialize(jax.random.PRNGKey(0), shape,
                                       jnp.float32)
    params = {k: (rng.standard_normal(np.shape(v)) * 0.5).astype(np.float32)
              for k, v in params.items()}
    return params, out


@pytest.mark.parametrize("name,kind,kw,shape", LAYER_CASES,
                         ids=[c[0] for c in LAYER_CASES])
def test_layer_matches_jax(name, kind, kw, shape):
    rng = np.random.default_rng(len(name))
    jl, pl = JLAYERS[kind](**kw), PLAYERS[kind](**kw)
    params, jout = _params_for(jl, shape, rng)
    _, _, pout = pl.initialize(torch.Generator().manual_seed(0), shape,
                               torch.float32, "cpu")
    x = rng.standard_normal((2,) + tuple(shape)).astype(np.float32)
    ref, _, _ = jl.apply({k: jnp.asarray(v) for k, v in params.items()},
                         jnp.asarray(x), {}, train=False, rng=None)
    got, _, _ = pl.apply({k: torch.from_numpy(v) for k, v in params.items()},
                         torch.from_numpy(x), {}, train=False)
    ref = np.asarray(ref)
    assert got.shape == ref.shape == (2,) + tuple(pout)
    # the JAX initialize ignores dilation (its apply does not): the port's
    # reports what both applies return
    dilated = np.max(kw.get("dilation", 1)) > 1
    assert (tuple(pout) != tuple(jout)) == dilated
    assert np.abs(got.numpy() - ref).max() <= TOL * max(
        1.0, np.abs(ref).max())


@pytest.mark.parametrize("name,kind,kw,shape", LAYER_CASES,
                         ids=[c[0] for c in LAYER_CASES])
def test_layer_gradients_by_gradcheck(name, kind, kw, shape):
    rng = np.random.default_rng(len(name) + 1)
    jl, pl = JLAYERS[kind](**kw), PLAYERS[kind](**kw)
    params, _ = _params_for(jl, shape, rng)
    names = sorted(params)
    x = torch.from_numpy(rng.standard_normal((2,) + tuple(shape))).double()
    ps = [torch.from_numpy(params[n]).double().requires_grad_()
          for n in names]
    if kind == "lrn":  # keep the base of the fractional power positive
        x = x.abs() + 0.1
    x.requires_grad_()

    def f(x, *ps):
        return pl.apply(dict(zip(names, ps)), x, {}, train=False)[0]
    assert torch.autograd.gradcheck(f, (x, *ps), eps=1e-6, atol=1e-5)


VERTEX_CASES = [
    ("merge_ff", "merge", dict(data_format="NCHW"), [(3,), (4,)]),
    ("merge_rnn", "merge", dict(data_format="NCHW"), [(5, 3), (5, 2)]),
    ("merge_nchw", "merge", dict(data_format="NCHW"),
     [(3, 4, 4), (2, 4, 4), (1, 4, 4)]),
    ("merge_nhwc", "merge", dict(data_format="NHWC"),
     [(4, 4, 3), (4, 4, 2)]),
    ("dot_last", "dot_product", dict(axis=-1), [(4,), (4,)]),
    ("dot_axis1", "dot_product", dict(axis=1), [(6,), (6,)]),
]


@pytest.mark.parametrize("name,kind,kw,shapes", VERTEX_CASES,
                         ids=[c[0] for c in VERTEX_CASES])
def test_vertex_matches_jax_with_gradients(name, kind, kw, shapes):
    rng = np.random.default_rng(len(name))
    jvx, pvx = jv.VERTICES[kind](**kw), pv.VERTICES[kind](**kw)
    _, _, jout = jvx.initialize(jax.random.PRNGKey(0), shapes, jnp.float32)
    _, _, pout = pvx.initialize(None, shapes, torch.float32, "cpu")
    assert tuple(pout) == tuple(jout)
    xs = [rng.standard_normal((2,) + s).astype(np.float32) for s in shapes]
    ref, _, _ = jvx.apply({}, [jnp.asarray(x) for x in xs], {})
    got, _, _ = pvx.apply({}, [torch.from_numpy(x) for x in xs], {})
    ref = np.asarray(ref)
    assert got.shape == ref.shape == (2,) + tuple(jout)
    assert np.abs(got.numpy() - ref).max() <= TOL * np.abs(ref).max()
    xd = [torch.from_numpy(x).double().requires_grad_() for x in xs]
    assert torch.autograd.gradcheck(
        lambda *a: pvx.apply({}, list(a), {})[0], tuple(xd))


def test_vertices_refuse_as_jax():
    a = np.ones((2, 3, 4), np.float32)
    for args in ([a, a], [np.ones((2, 4), np.float32),
                          np.ones((2, 5), np.float32)]):
        with pytest.raises(ValueError):
            jv.DotProductVertex().apply({}, [jnp.asarray(t) for t in args],
                                        {})
        with pytest.raises(ValueError):
            pv.DotProductVertex().apply({}, [torch.from_numpy(t)
                                             for t in args], {})
    with pytest.raises(ValueError, match="mismatch"):
        pv.MergeVertex().initialize(None, [(3, 4, 4), (2, 5, 4)],
                                    torch.float32, "cpu")


# ------------------------------------------------------ ZIPs both ways

def _conv_net(J):
    """Every new 2D kind (and the core ones) in one NHWC network, 8x8x3
    in, 3 classes out; ``J`` the package's namespace."""
    L = J.layers
    nhwc = dict(data_format="NHWC")
    return (J.builder().seed(3)
            .input_type(J.InputType.convolutional(3, 8, 8, "NHWC"))
            .list(L.ZeroPadding2D(padding=((0, 1), (1, 0)), **nhwc),
                  L.Deconvolution2D(n_out=4, kernel=(2, 2),
                                    activation="tanh", **nhwc),
                  L.SeparableConvolution2D(n_out=6, kernel=(3, 3),
                                           depth_multiplier=2, **nhwc),
                  L.DepthwiseConvolution2D(kernel=(3, 3), mode="same",
                                           **nhwc),
                  L.Cropping2D(cropping=(1, 1, 0, 2), **nhwc),
                  L.LocalResponseNormalization(n=3, **nhwc),
                  L.SpaceToDepthLayer(block_size=2, **nhwc),
                  L.DepthToSpaceLayer(block_size=2, **nhwc),
                  L.Upsampling2D(size=(2, 2), **nhwc),
                  L.LocallyConnected2D(n_out=2, kernel=(3, 3),
                                       stride=(3, 3)),
                  L.FlattenLayer(),
                  L.ElementWiseMultiplicationLayer(activation="tanh"),
                  L.OutputLayer(n_out=3)).build())


def _seq_net(J):
    """Every new 1D kind, Permute and Reshape, 8 steps x 4 features in."""
    L = J.layers
    return (J.builder().seed(4)
            .input_type(J.InputType.recurrent(4, 8))
            .list(L.Convolution1D(n_out=5, kernel=3, mode="same"),
                  L.ZeroPadding1DLayer(padding=(1, 2)),
                  L.Cropping1D(cropping=(1, 0)),
                  L.Upsampling1D(size=2),
                  L.Subsampling1DLayer(kernel=2, pool_type="avg"),
                  L.SeparableConvolution1D(n_out=4, kernel=3),
                  L.LocallyConnected1D(n_out=3, kernel=2, stride=2),
                  L.PermuteLayer(dims=(2, 1)),
                  L.ReshapeLayer(target_shape=(4, 3)),
                  L.GlobalPoolingLayer(pool_type="avg"),
                  L.OutputLayer(n_out=2)).build())


def _graph_net(J):
    """MergeVertex and DotProductVertex in a two-input graph."""
    L, V = J.layers, J.vertices
    return (J.builder().seed(5).graph_builder()
            .add_inputs("a", "b")
            .set_input_types(J.InputType.feed_forward(4),
                             J.InputType.feed_forward(4))
            .add_layer("a1", L.DenseLayer(n_out=3, activation="tanh"), "a")
            .add_layer("b1", L.DenseLayer(n_out=3), "b")
            .add_vertex("m", V.MergeVertex(), "a1", "b1")
            .add_vertex("d", V.DotProductVertex(axis=-1), "a1", "b1")
            .add_vertex("m2", V.MergeVertex(), "m", "d")
            .add_layer("out", L.OutputLayer(n_out=2), "m2")
            .set_outputs("out").build())


class _Ns:
    def __init__(self, **kw):
        self.__dict__.update(kw)


def _namespaces():
    import deeplearning4j_tpu.nn.layers.conv as jconv
    import deeplearning4j_tpu.nn.layers.conv_extra as jextra
    from deeplearning4j_tpu.nn.config import InputType as JIT
    from deeplearning4j_tpu.nn.config import NeuralNetConfiguration as JNNC
    from deeplearning4j_tpu.nn.graph import ComputationGraph as JCG
    from deeplearning4j_tpu.nn.model import MultiLayerNetwork as JMLN
    from deeplearning4j_tpu_torch.nn import layers as pl
    from deeplearning4j_tpu_torch.nn.config import InputType as PIT
    from deeplearning4j_tpu_torch.nn.config import \
        NeuralNetConfiguration as PNNC
    jlayers = _Ns(**{**vars(jcore), **vars(jconv), **vars(jextra)})
    j = _Ns(layers=jlayers, vertices=jv, InputType=JIT,
            builder=JNNC.builder, MLN=JMLN, CG=JCG)
    p = _Ns(layers=pl, vertices=pv, InputType=PIT, builder=PNNC.builder)
    return j, p


NETS = {"conv": (_conv_net, [(2, 8, 8, 3)]), "seq": (_seq_net, [(2, 8, 4)]),
        "graph": (_graph_net, [(2, 4), (2, 4)])}


@pytest.mark.parametrize("net_name", sorted(NETS))
def test_jax_zip_loads_in_the_port_and_back(net_name, tmp_path):
    make, shapes = NETS[net_name]
    j, p = _namespaces()
    conf = make(j)
    jnet = (j.CG if net_name == "graph" else j.MLN)(conf).init()
    rng = np.random.default_rng(9)
    xs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    ref = np.asarray(jnet.output(*xs))
    jzip = str(tmp_path / "jax.zip")
    jser.save_model(jnet, jzip)
    pnet = pser.load_model(jzip, device="cpu")
    assert json.loads(pnet.conf.to_json()) == json.loads(jnet.conf.to_json())
    assert json.loads(make(p).to_json()) == json.loads(jnet.conf.to_json())
    got = pnet.output(*xs)
    assert np.abs(got - ref).max() <= TOL * max(1.0, np.abs(ref).max())
    pzip = str(tmp_path / "port.zip")
    pser.save_model(pnet, pzip)
    back = jser.load_model(pzip)
    assert json.loads(back.conf.to_json()) == json.loads(jnet.conf.to_json())
    np.testing.assert_array_equal(np.asarray(back.output(*xs)), ref)
