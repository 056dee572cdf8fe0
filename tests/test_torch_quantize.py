"""The port's int8 serving against the JAX package's, on the CPU.

One case (at least) for each test of ``tests/test_quantized_serving.py``
except its fault-site one (the port has no ``serving.quantize`` fault
site yet):

- the primitives bit for bit: per-channel weights (q and scale, a zero
  channel), per-tensor / per-example / per-row activation scales,
  ``int8_matmul`` and ``int8_conv`` outputs for float32 and bfloat16
  inputs (stride, padding modes, dilation, groups, NCHW and NHWC), the
  int32 accumulators, the ``dot`` / ``einsum`` impls bit-identical, the
  CUDA shape rules' zero padding exact, batch invariance, ``qdot``;
- ``quantize_params`` on both engines: the quantized (layer, weight) sets
  equal to JAX's for every layer kind JAX marks quantizable, the values
  bit for bit, the forward against JAX's quantized forward, the 16-bit
  policy leaving the scales f32, the trees' leaf pairs and the carry of a
  JAX ``QuantizedTensor`` tree both ways;
- the engines: quantize-on-warmup with no cold call, requantization after
  ``fit``, ``set_params_flat`` and an in-place write, ``set_quantize``,
  ``memory_report``, the ``DL4J_TPU_QUANT=off`` pin, ``ParallelInference``;
- the int8 KV cache: decode against the full recompute (JAX's bounds:
  tokens equal, relative error <= 0.05) and against JAX's int8 engine,
  ``cache_bytes`` under half, write gating and copy-on-write bit for bit,
  join/leave neighbour parity, ``grow``, a bfloat16 model's f32 scales,
  quantized weights + int8 KV end to end against the JAX batcher, and an
  int8 ``KVShipment`` from JAX to the port and back.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn.config import InputType as JInputType
from deeplearning4j_tpu.nn.config import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.nn.graph import ComputationGraph as JCG
from deeplearning4j_tpu.nn.graph import GraphBuilder as JGB
from deeplearning4j_tpu.nn.layers import attention as jatt
from deeplearning4j_tpu.nn.layers import conv as jconv
from deeplearning4j_tpu.nn.layers import core as jcore
from deeplearning4j_tpu.nn.layers import recurrent as jrec
from deeplearning4j_tpu.nn.model import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.nn.updaters import Adam as JAdam
from deeplearning4j_tpu.ops import quantize as jq
from deeplearning4j_tpu.serving import ContinuousBatcher as JBatcher
from deeplearning4j_tpu.serving import KVShipment as JShipment
from deeplearning4j_tpu.serving import PrefillReplica as JReplica
from deeplearning4j_tpu.serving.engine import GenerativeEngine as JGen
from deeplearning4j_tpu.serving.engine import InferenceEngine as JEngine
from deeplearning4j_tpu_torch import dtypes as dt
from deeplearning4j_tpu_torch.data.dataset import DataSet
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.model import MultiLayerNetwork
from deeplearning4j_tpu_torch.ops import quantize as q
from deeplearning4j_tpu_torch.serving import KVShipment, PrefillReplica
from deeplearning4j_tpu_torch.serving.batcher import (ContinuousBatcher,
                                                      ParallelInference)
from deeplearning4j_tpu_torch.serving.engine import (GenerativeEngine,
                                                     InferenceEngine,
                                                     PagedGenerativeEngine)
from deeplearning4j_tpu_torch.utils import convert, tree

V = 32
#: float32 layer walks of the two packages (tanh, softmax, attention
#: sums in another order) differ by a few ulps; the int8 steps themselves
#: are compared bit for bit
WALK_TOL = dict(rtol=1e-5, atol=1e-6)
#: JAX's own int8-decode bound (tests/test_quantized_serving.py:357-394)
KV_REL = 0.05


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


@pytest.fixture(autouse=True)
def _default_modes():
    yield
    q.set_mode("int8")
    q.set_impl("dot")


def _np(a):
    if torch.is_tensor(a):
        a = a.detach().cpu()
        return (a.float() if a.dtype == torch.bfloat16 else a).numpy()
    a = jnp.asarray(a)
    return np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16
                      else a)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _load(jnet, tmp_path, cls, name="net.zip"):
    path = str(tmp_path / name)
    jnet.save(path)
    return cls.load(path, device="cpu")


# ------------------------------------------------------------- primitives

@pytest.mark.parametrize("shape,axis", [((24, 12), 1), ((24, 12), 0),
                                        ((5, 3, 3, 2), 0), ((7,), 0)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_per_channel_bit_for_bit(rng, shape, axis, dtype):
    w = rng.normal(size=shape).astype(np.float32) * 3
    if len(shape) > 1:
        w[(slice(None),) * axis + (1,)] = 0.0  # an all-zero channel
    jw = jnp.asarray(w, dtype)
    tw = _t(w).to(getattr(torch, dtype))
    jqt, tqt = jq.quantize_per_channel(jw, axis), \
        q.quantize_per_channel(tw, axis)
    assert tqt.q.dtype == torch.int8 and tqt.scale.dtype == torch.float32
    np.testing.assert_array_equal(np.asarray(jqt.q), tqt.q.numpy())
    np.testing.assert_array_equal(np.asarray(jqt.scale), tqt.scale.numpy())
    np.testing.assert_array_equal(_np(jqt.dequantize()),
                                  tqt.dequantize().numpy())
    assert tqt.nbytes == jqt.nbytes and tqt.axis == jqt.axis
    if len(shape) > 1:
        assert float(tqt.scale[1]) == 1.0
        assert not tqt.dequantize().select(axis, 1).any()


@pytest.mark.parametrize("fn", ["quantize_dynamic", "quantize_per_example",
                                "quantize_rows"])
def test_activation_scales_bit_for_bit(rng, fn):
    x = rng.normal(size=(4, 3, 16)).astype(np.float32) * 10
    x[1] = 0.0  # a zero example / rows: unit scale, zero values
    jqx, js = getattr(jq, fn)(x)
    tqx, ts = getattr(q, fn)(_t(x))
    np.testing.assert_array_equal(np.asarray(jqx), tqx.numpy())
    np.testing.assert_array_equal(np.asarray(js), ts.numpy())
    assert tuple(ts.shape) == tuple(np.shape(js))
    err = np.abs(tqx.numpy().astype(np.float32) * ts.numpy() - x)
    assert np.all(err <= ts.numpy() / 2 + 1e-6)


@pytest.mark.parametrize("xshape,wshape", [((6, 64), (64, 32)),
                                           ((2, 5, 48), (48, 24)),
                                           ((64,), (64, 8)),
                                           ((8, 147), (147, 20))])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_matmul_bit_for_bit_and_impl_parity(rng, xshape, wshape, dtype):
    x = rng.normal(size=xshape).astype(np.float32) * 2
    w = rng.normal(size=wshape).astype(np.float32)
    b = rng.normal(size=wshape[1]).astype(np.float32)
    jqt = jq.quantize_per_channel(w, 1)
    tqt = q.quantize_per_channel(_t(w), 1)
    want = jq.int8_matmul(jnp.asarray(x, dtype), jqt.q, jqt.scale, b)
    q.reset_counters()
    got = q.int8_matmul(_t(x).to(getattr(torch, dtype)), tqt.q, tqt.scale,
                        _t(b))
    assert str(got.dtype) == f"torch.{dtype}"
    np.testing.assert_array_equal(_np(want), _np(got))
    q.set_impl("einsum")
    ein = q.int8_matmul(_t(x).to(getattr(torch, dtype)), tqt.q, tqt.scale,
                        _t(b))
    np.testing.assert_array_equal(_np(got), _np(ein))
    assert q.counters() == {"dot": 1, "einsum": 1}
    ref = x @ w + b
    assert np.abs(_np(got) - ref).max() / np.abs(ref).max() < 0.05


@pytest.mark.parametrize("m,k,n", [(8, 256, 256), (3, 147, 64),
                                   (32, 4608, 512), (17, 64, 1000),
                                   (24, 20, 12)])
def test_accumulator_and_cuda_padding_exact(rng, m, k, n):
    """The int32 accumulator of both routes equals JAX's integer
    dot_general; the zero padding to ``torch._int_mm``'s CUDA rules (run
    here on the CPU) is exact and counted; |acc| reaches past 2**24 at
    K = 4608, where a float32 contraction would round."""
    a = rng.integers(-127, 128, (m, k)).astype(np.int8)
    b = rng.integers(-127, 128, (k, n)).astype(np.int8)
    if k == 4608:
        a[0] = 127
        b[:, 0] = 127
    want = np.asarray(jax.lax.dot_general(
        jnp.asarray(a), jnp.asarray(b), (((1,), (0,)), ((), ())),
        preferred_element_type=jnp.int32))
    q.reset_counters()
    for got in (q.int_mm(_t(a), _t(b)), q.int_mm_plain(_t(a), _t(b)),
                q._int_mm_padded(_t(a), _t(b))):
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(want, got.numpy())
    padded = (m <= 16) or k % 8 or n % 8
    assert bool(q.pad_counters()) == bool(padded)
    if k == 4608:
        assert want[0, 0] == 4608 * 127 * 127 > 2 ** 24


def test_per_example_scales_are_batch_invariant(rng):
    x0 = rng.normal(size=(1, 32)).astype(np.float32)
    outlier = rng.normal(size=(3, 32)).astype(np.float32) * 1000.0
    qt = q.quantize_per_channel(_t(rng.normal(size=(32, 8)).astype(
        np.float32)), 1)
    alone = q.int8_matmul(_t(x0), qt.q, qt.scale)
    batched = q.int8_matmul(_t(np.concatenate([x0, outlier])), qt.q,
                            qt.scale)
    assert torch.equal(alone[0], batched[0])
    xc0 = rng.normal(size=(1, 3, 6, 6)).astype(np.float32)
    xco = rng.normal(size=(2, 3, 6, 6)).astype(np.float32) * 1000.0
    wc = q.quantize_per_channel(_t(rng.normal(size=(4, 3, 3, 3)).astype(
        np.float32)), 0)
    c_alone = q.int8_conv(_t(xc0), wc)
    c_batched = q.int8_conv(_t(np.concatenate([xc0, xco])), wc)
    assert torch.equal(c_alone[0], c_batched[0])


def test_qdot_routes_and_validates(rng):
    x = _t(rng.normal(size=(3, 8)).astype(np.float32))
    w = _t(rng.normal(size=(8, 4)).astype(np.float32))
    qt = q.quantize_per_channel(w, 1)
    assert torch.equal(q.qdot(x, qt), q.int8_matmul(x, qt.q, qt.scale))
    assert torch.equal(q.qdot(x, w), torch.matmul(x, w))
    with pytest.raises(ValueError, match="output-channel-last"):
        q.qdot(x, q.quantize_per_channel(w, 0))


CONV_CASES = [
    dict(), dict(stride=(2, 1), padding=(1, 2), dilation=(2, 1)),
    dict(mode="same", stride=(2, 2)), dict(mode="causal", dilation=(1, 2)),
    dict(mode="same", stride=(1, 3), dilation=(2, 2)),
    dict(padding=1, groups=3),
]


@pytest.mark.parametrize("kw", CONV_CASES,
                         ids=[str(i) for i in range(len(CONV_CASES))])
@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_conv_bit_for_bit(rng, kw, fmt, dtype):
    g = kw.get("groups", 1)
    x = rng.normal(size=(2, 6, 10, 9)).astype(np.float32) * 2
    if fmt == "NHWC":
        x = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    w = rng.normal(size=(6, 6 // g, 3, 3)).astype(np.float32)
    b = rng.normal(size=6).astype(np.float32)
    jqt = jq.quantize_per_channel(w, 0)
    tqt = q.quantize_per_channel(_t(w), 0)
    want = jq.int8_conv(jnp.asarray(x, dtype), jqt, b, data_format=fmt,
                        **kw)
    q.reset_counters()
    got = q.int8_conv(_t(x).to(getattr(torch, dtype)), tqt, _t(b),
                      data_format=fmt, **kw)
    assert q.counters() == {"conv": 1}
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_array_equal(_np(want), _np(got))
    q.set_impl("einsum")
    np.testing.assert_array_equal(_np(got), _np(q.int8_conv(
        _t(x).to(getattr(torch, dtype)), tqt, _t(b), data_format=fmt,
        **kw)))
    if dtype == "float32":
        from deeplearning4j_tpu_torch.ops import nnops
        ref = nnops.conv2d(_t(x), _t(w), _t(b), data_format=fmt, **kw)
        assert (got - ref).abs().max() / ref.abs().max() < 0.05


# ------------------------------------------------------------- layer walks

def _mlp_j(seed=0, feat=8):
    conf = (JConf.builder().seed(seed)
            .updater(JAdam(learning_rate=1e-3))
            .input_type(JInputType.feed_forward(feat))
            .list(jcore.DenseLayer(n_out=32, activation="relu"),
                  jcore.DenseLayer(n_out=32, activation="tanh"),
                  jcore.OutputLayer(n_out=5))
            .build())
    return JMLN(conf).init()


def _attn_j(seed=0, heads=2, dtype=None):
    b = JConf.builder().seed(seed)
    if dtype:
        b = b.data_type(dtype)
    conf = (b.input_type(JInputType.recurrent(V, 16))
            .list(jatt.SelfAttentionLayer(n_out=V, n_heads=heads),
                  jcore.DenseLayer(n_out=64, activation="relu"),
                  jcore.DenseLayer(n_out=V, activation="identity"),
                  jcore.OutputLayer(n_out=V, activation="softmax"))
            .build())
    return JMLN(conf).init()


def _every_kind_j():
    """A graph with every layer kind the JAX package marks quantizable
    (dense, output, rnn output, conv, both multi-head attentions) beside
    ones it does not (embedding, batch norm, LSTM)."""
    conf = (JGB().add_inputs("img", "seq")
            .set_input_types((3, 8, 8), (6, 10))
            .layer("conv", jconv.ConvolutionLayer(n_out=4, kernel=(3, 3),
                                                  activation="relu"), "img")
            .layer("bn", jconv.BatchNormalization(), "conv")
            .layer("flat", jcore.FlattenLayer(), "bn")
            .layer("dense", jcore.DenseLayer(n_out=10), "flat")
            .layer("out", jcore.OutputLayer(n_out=5), "dense")
            .layer("sa", jatt.SelfAttentionLayer(n_out=8, n_heads=2,
                                                 has_bias=True), "seq")
            .layer("lsa", jatt.LearnedSelfAttentionLayer(
                n_out=8, n_heads=2, n_queries=3), "sa")
            .layer("lstm", jrec.LSTM(n_out=6), "lsa")
            .layer("rout", jrec.RnnOutputLayer(n_out=4), "lstm")
            .set_outputs("out", "rout").build())
    return JCG(conf).init()


def _site_set(qp):
    return {(k, n) for k, leaves in qp.items() for n, v in leaves.items()
            if getattr(v, "__quantized_tensor__", False)}


def _same_tree(jtree, ttree):
    assert set(jtree) == set(ttree)
    for k in jtree:
        for n, jv in jtree[k].items():
            tv = ttree[k][n]
            if isinstance(jv, jq.QuantizedTensor):
                assert tv.axis == jv.axis
                np.testing.assert_array_equal(np.asarray(jv.q), tv.q.numpy())
                np.testing.assert_array_equal(np.asarray(jv.scale),
                                              tv.scale.numpy())
            else:
                assert tv is not None and not q.is_quantized(tv)


@pytest.mark.parametrize("kind", ["mlp", "attention", "every_kind"])
def test_quantize_params_sites_and_values_equal_jax(rng, tmp_path, kind):
    if kind == "every_kind":
        jn = _every_kind_j()
        pn = _load(jn, tmp_path, ComputationGraph)
        feeds = {"img": rng.normal(size=(2, 3, 8, 8)).astype(np.float32),
                 "seq": rng.normal(size=(2, 6, 10)).astype(np.float32)}
    else:
        jn = _mlp_j() if kind == "mlp" else _attn_j()
        pn = _load(jn, tmp_path, MultiLayerNetwork)
        x = rng.normal(size=(3, 8) if kind == "mlp" else (3, 16, V))
        feeds = x.astype(np.float32)
    jqp, tqp = jn.quantize_params(), pn.quantize_params()
    assert _site_set(tqp) == _site_set(jqp)
    _same_tree(jqp, tqp)
    # the model's own params are untouched
    assert not any(q.is_quantized(v) for p in pn.params.values()
                   for v in p.values())
    if kind == "every_kind":
        assert {k for k, _ in _site_set(tqp)} == {
            "conv", "dense", "out", "sa", "lsa", "rout"}
        ja, _, _ = jn._forward(jqp, {k: jnp.asarray(v)
                                     for k, v in feeds.items()},
                               jn.state, train=False, rng=None)
        ta, _, _ = pn._forward(tqp, {k: _t(v) for k, v in feeds.items()},
                               pn.state)
        for o in ("out", "rout"):
            np.testing.assert_allclose(_np(ta[o]), _np(ja[o]), **WALK_TOL)
        return
    jy = jn._forward(jqp, jnp.asarray(feeds), jn.state, train=False,
                     rng=None)[0]
    ty = pn._forward(tqp, _t(feeds), pn.state)[0]
    np.testing.assert_allclose(_np(ty), _np(jy), **WALK_TOL)
    fy = pn._forward(pn.params, _t(feeds), pn.state)[0]
    assert (ty - fy).abs().max() < 0.05


def test_quantize_params_skips_unmarked_layers(tmp_path):
    conf = (JConf.builder().seed(0)
            .input_type(JInputType.feed_forward(1))
            .list(jcore.EmbeddingLayer(n_in=16, n_out=8),
                  jcore.OutputLayer(n_out=3))
            .build())
    pn = _load(JMLN(conf).init(), tmp_path, MultiLayerNetwork)
    qp = pn.quantize_params()
    assert _site_set(qp) == {("1", "W")}
    with pytest.raises(ValueError, match="quantization mode"):
        pn.quantize_params("int4")


def test_mixed_precision_policy_keeps_scales_f32(tmp_path):
    pn = _load(_mlp_j(), tmp_path, MultiLayerNetwork)
    cast = dt.cast_floating(pn.quantize_params(), torch.bfloat16)
    for si in cast:
        assert cast[si]["W"].scale.dtype == torch.float32
        assert cast[si]["W"].q.dtype == torch.int8
        assert cast[si]["b"].dtype == torch.bfloat16


def test_quantized_tree_walks_and_carry_both_ways(tmp_path):
    """A quantized weight is one leaf pair in the tree walks, and a JAX
    tree of ``QuantizedTensor`` leaves crosses both ways bit for bit."""
    jn = _mlp_j()
    pn = _load(jn, tmp_path, MultiLayerNetwork)
    tqp = pn.quantize_params()
    assert len(list(tree.leaves(tqp))) == len(jax.tree.leaves(
        jn.quantize_params()))
    keys = sorted(tqp)
    flat = tree.flatten_params(tqp, keys)
    jflat = np.concatenate([np.asarray(a, np.float32).ravel() for k in keys
                            for a in (tqp[k]["W"].q, tqp[k]["W"].scale,
                                      tqp[k]["b"])])
    np.testing.assert_array_equal(flat, jflat)
    back = tree.unflatten_params(tqp, keys, flat)
    assert torch.equal(back["0"]["W"].q, tqp["0"]["W"].q)
    moved = tree.tmap(lambda t: t.to("cpu"), tqp)
    assert q.is_quantized(moved["1"]["W"])
    # JAX -> port
    carried, _ = convert.from_numpy(jn.quantize_params(), {}, device="cpu")
    _same_tree(jn.quantize_params(), carried)
    # port -> JAX: the JAX walk serves the carried tree
    out = convert.to_numpy(tqp)
    jtree = {k: {n: (jq.QuantizedTensor(jnp.asarray(v.q),
                                        jnp.asarray(v.scale), v.axis)
                     if isinstance(v, convert.QuantizedArrays)
                     else jnp.asarray(v)) for n, v in p.items()}
             for k, p in out.items()}
    _same_tree(jtree, tqp)
    x = np.random.default_rng(3).normal(size=(4, 8)).astype(np.float32)
    np.testing.assert_allclose(
        _np(jn._forward(jtree, jnp.asarray(x), jn.state, train=False,
                        rng=None)[0]),
        _np(pn._forward(tqp, _t(x), pn.state)[0]), **WALK_TOL)


# --------------------------------------------------------- serving engines

@pytest.fixture
def mlp(tmp_path):
    jn = _mlp_j()
    return jn, _load(jn, tmp_path, MultiLayerNetwork)


def test_engine_quantize_on_warmup(rng, mlp):
    jn, pn = mlp
    eng = InferenceEngine(pn, device="cpu", quantize="int8")
    eng.warmup([1, 2, 4, 8])
    x = rng.normal(size=(5, 8)).astype(np.float32)
    y_q = eng.output(x)
    st = eng.stats()
    assert st["cold_calls"] == 0 and st["quantize"] == "int8"
    assert st["quantized_sites"] == 3 and st["quantized_bytes_saved"] > 0
    assert st["quantize_fallbacks"] == 0 and st["quantize_requants"] == 0
    y_f = InferenceEngine(pn, device="cpu").warmup([8]).output(x)
    assert np.abs(y_q - y_f).max() < 0.05
    assert InferenceEngine(pn, device="cpu").stats()["quantize"] == "off"
    jy = np.asarray(JEngine(jn, quantize="int8").warmup([8]).output(x))
    np.testing.assert_allclose(y_q, jy, **WALK_TOL)


@pytest.mark.parametrize("how", ["fit", "set_params_flat", "in_place",
                                 "sub_dict"])
def test_engine_requantizes_when_params_change(rng, mlp, how):
    """Every way the port changes weights reaches the served int8 twin:
    ``fit`` rebinds the tree, ``set_params_flat`` rebuilds it, an in-place
    write bumps a tensor's version, a sub-dict swap changes a leaf."""
    _, pn = mlp
    eng = InferenceEngine(pn, device="cpu", quantize="int8").warmup([4])
    x = rng.normal(size=(4, 8)).astype(np.float32)
    y0 = eng.output(x)
    assert eng.output(x) is not None and eng.q_requants == 0
    if how == "fit":
        xs = rng.normal(size=(16, 8)).astype(np.float32)
        ys = np.eye(5, dtype=np.float32)[rng.integers(0, 5, 16)]
        pn.fit(DataSet(xs, ys), epochs=1)
    elif how == "set_params_flat":
        pn.set_params_flat(pn.params_flat() * 1.5)
    elif how == "in_place":
        with torch.no_grad():
            pn.params["0"]["W"].mul_(-1.0)
    else:
        pn.params["2"] = {k: v * 2.0 for k, v in pn.params["2"].items()}
    y1 = eng.output(x)
    assert eng.q_requants == 1
    assert eng.stats()["cold_calls"] == 0
    assert not np.array_equal(y0, y1)  # the update is served
    eng.output(x)
    assert eng.q_requants == 1  # and quantized once


def test_set_quantize_records_cause_and_requires_rewarm(rng, mlp):
    _, pn = mlp
    eng = InferenceEngine(pn, device="cpu").warmup([4])
    eng.set_quantize("int8")
    assert eng.invalidations == ["quantize"]
    x = rng.normal(size=(3, 8)).astype(np.float32)
    eng.output(x)
    assert eng.stats()["cold_calls"] == 1
    eng.warmup([4])
    eng.output(x)
    assert eng.stats()["cold_calls"] == 1
    with pytest.raises(ValueError, match="quantize mode"):
        eng.set_quantize("int4")


def test_engine_memory_report_accounts_quantized_bytes(mlp):
    _, pn = mlp
    base = InferenceEngine(pn, device="cpu").memory_report(8)
    quant = InferenceEngine(pn, device="cpu",
                            quantize="int8").memory_report(8)
    assert quant["quantize"] == "int8" and base["quantize"] == "off"
    assert quant["quantized_weight_bytes"] > 0
    assert base["quantized_weight_bytes"] == 0
    assert quant["params_bytes"] < base["params_bytes"]
    assert quant["argument_bytes"] < base["argument_bytes"]
    assert quant["peak_bytes"] is None  # measured on the card only


def test_env_pin_off_serves_f32(rng, mlp):
    _, pn = mlp
    q.set_mode("off")
    eng = InferenceEngine(pn, device="cpu", quantize="int8").warmup([4])
    x = rng.normal(size=(3, 8)).astype(np.float32)
    base = InferenceEngine(pn, device="cpu").warmup([4])
    np.testing.assert_array_equal(eng.output(x), base.output(x))
    assert eng.q_fallbacks == 1
    assert eng.stats()["quantize_fallback"] == "env_off"
    eng.output(x)
    assert eng.q_fallbacks == 1  # sticky


def test_quantize_error_falls_back_to_f32(rng, mlp, monkeypatch):
    _, pn = mlp

    def broken(model):
        raise RuntimeError("quantizer bug")
    monkeypatch.setattr(q, "quantize_model_params", broken)
    eng = InferenceEngine(pn, device="cpu", quantize="int8").warmup([4])
    x = rng.normal(size=(3, 8)).astype(np.float32)
    np.testing.assert_array_equal(
        eng.output(x), InferenceEngine(pn, device="cpu").output(x))
    assert eng.stats()["quantize_fallback"] == "error"
    assert eng.q_fallbacks == 1


def test_parallel_inference_quantize_stats_flow(rng, mlp):
    _, pn = mlp
    pi = ParallelInference(pn, quantize="int8", max_batch_size=8,
                           max_wait_ms=1, warmup=True, device="cpu")
    try:
        pi.output(rng.normal(size=(3, 8)).astype(np.float32))
        st = pi.stats()
        assert st["engine"]["quantize"] == "int8"
        assert st["engine"]["quantized_sites"] == 3
        assert pi.engine is not pn.inference_engine()
    finally:
        pi.shutdown()
    with pytest.raises(ValueError, match="alongside engine="):
        ParallelInference(pn, engine=pn.inference_engine(),
                          quantize="int8", device="cpu")


# --------------------------------------------------- int8 KV-cache decode

@pytest.fixture(scope="module")
def lm(tmp_path_factory):
    jn = _attn_j()
    return jn, _load(jn, tmp_path_factory.mktemp("lm"), MultiLayerNetwork)


def test_int8_kv_decode_matches_full_recompute_and_jax(rng, lm):
    jn, pn = lm
    eng = GenerativeEngine(pn, slots=2, kv_cache="int8", device="cpu")
    eng.warmup([16], [8])
    jeng = JGen(jn, slots=2, kv_cache="int8")
    jeng.warmup([16], [8])
    st, jst = eng.new_state(16), jeng.new_state(16)
    prompt = rng.normal(size=(5, V)).astype(np.float32)
    st, logits = eng.prefill(st, prompt, 5, 0)
    jst, jlogits = jeng.prefill(jst, prompt, 5, 0)
    np.testing.assert_allclose(logits, np.asarray(jlogits), **WALK_TOL)
    toks, outs = [int(np.argmax(logits))], [logits]
    x_t = np.zeros((2, 1, V), np.float32)
    for _ in range(6):
        x_t[0, 0] = np.eye(V, dtype=np.float32)[toks[-1]]
        st, lg = eng.decode(st, x_t, np.array([1, 0], np.int32))
        jst, jlg = jeng.decode(jst, x_t, np.array([1, 0], np.int32))
        np.testing.assert_allclose(lg[0], np.asarray(jlg)[0], **WALK_TOL)
        toks.append(int(np.argmax(lg[0])))
        outs.append(lg[0])
    # the caches themselves: int8 values and f32 scales as JAX's
    for si, c in st.caches.items():
        for key, t in c.items():
            want = np.asarray(jst.caches[si][key])
            assert t.dtype == (torch.float32 if "scale" in key
                               else torch.int8)
            if "scale" in key:
                np.testing.assert_allclose(t.numpy(), want, rtol=1e-5)
            else:
                assert np.abs(t.numpy().astype(int)
                              - want.astype(int)).max() <= 1
    seq = np.zeros((1, 16, V), np.float32)
    seq[0, :5] = prompt
    n = 5
    with torch.no_grad():
        for i in range(7):
            y = pn._full_context(pn.params, _t(seq), pn.state,
                                 torch.tensor([5]), torch.tensor([n]))
            row = y[0, n - 1].numpy()
            t = int(np.argmax(row))
            assert t == toks[i]
            assert np.abs(outs[i] - row).max() / np.abs(row).max() <= KV_REL
            seq[0, n] = np.eye(V, dtype=np.float32)[t]
            n += 1
    assert eng.kv_bytes == eng.cache_bytes(16)


def test_int8_kv_cache_bytes_halved(lm):
    _, pn = lm
    q8 = GenerativeEngine(pn, slots=4, kv_cache="int8", device="cpu")
    f32 = GenerativeEngine(pn, slots=4, device="cpu")
    assert q8.cache_bytes(64) * 2 < f32.cache_bytes(64)
    assert q8.stats()["kv_cache"] == "int8"
    assert f32.stats()["kv_cache"] == "off"
    p8 = PagedGenerativeEngine(pn, slots=2, pages=9, page_size=8,
                               max_cache_len=32, kv_cache="int8",
                               device="cpu")
    pf = PagedGenerativeEngine(pn, slots=2, pages=9, page_size=8,
                               max_cache_len=32, device="cpu")
    assert p8.pool_bytes() * 2 < pf.pool_bytes()


def test_int8_kv_write_gating_and_fork_bit_for_bit(rng, lm):
    _, pn = lm
    eng = GenerativeEngine(pn, slots=2, kv_cache="int8",
                           device="cpu").warmup([16], [8])
    st = eng.new_state(16)
    st, _ = eng.prefill(st, rng.normal(size=(5, V)).astype(np.float32), 5, 0)
    snap = {si: {k: t.clone() for k, t in c.items()}
            for si, c in st.caches.items()}
    x_t = np.zeros((2, 1, V), np.float32)
    x_t[1, 0] = 1.0
    st, _ = eng.decode(st, x_t, np.array([0, 1], np.int32))
    for si, c in st.caches.items():
        for key, t in c.items():
            assert torch.equal(t[0], snap[si][key][0])
    # the paged pool: a gated row and a forked page stay bit for bit
    pg = PagedGenerativeEngine(pn, slots=2, pages=9, page_size=8,
                               max_cache_len=32, kv_cache="int8",
                               device="cpu").warmup([32], [8])
    ps = pg.new_state(32)
    pg.map_pages(ps, 0, pg.pool.alloc(1))
    ps, _ = pg.prefill(ps, rng.normal(size=(5, V)).astype(np.float32), 5, 0)
    page = int(ps.page_table[0, 0])
    pool0 = {si: {k: t.clone() for k, t in c.items()}
             for si, c in ps.caches.items()}
    pg.map_pages(ps, 1, pg.pool.alloc(1))
    ps, _ = pg.decode(ps, x_t, np.array([0, 1], np.int32))
    rows = slice(page * 8, page * 8 + 8)
    for si, c in ps.caches.items():
        for key, t in c.items():
            assert torch.equal(t[rows], pool0[si][key][rows])
    (dst,) = pg.pool.alloc(1)
    pg.fork(ps, [(page, dst)])
    for si, c in ps.caches.items():
        for key, t in c.items():
            assert torch.equal(t[dst * 8:dst * 8 + 8], t[rows])


def test_int8_kv_grow_and_bf16_scales(rng, tmp_path):
    jn = _attn_j(dtype="BFLOAT16")
    pn = _load(jn, tmp_path, MultiLayerNetwork)
    eng = GenerativeEngine(pn, slots=2, kv_cache="int8", device="cpu")
    eng.warmup([8, 16], [8])
    st = eng.new_state(8)
    st, _ = eng.prefill(st, rng.normal(size=(5, V)).astype(np.float32), 5, 1)
    c = next(iter(st.caches.values()))
    assert c["k"].dtype == torch.int8 and c["k_scale"].dtype == torch.float32
    g = eng.grow(st, 16)
    gc = next(iter(g.caches.values()))
    for key in c:
        assert torch.equal(gc[key][:, :, :8], c[key])
        assert not gc[key][:, :, 8:].any()  # zeros, as JAX pads
    jst = JGen(jn, slots=2, kv_cache="int8").new_state(8)
    assert {k: str(v.dtype) for k, v in next(iter(
        jst.caches.values())).items()} == {
        "k": "int8", "v": "int8", "k_scale": "float32",
        "v_scale": "float32"}
    assert eng.kv_bytes == eng.cache_bytes(16)


def _one_hot(toks):
    return np.eye(V, dtype=np.float32)[np.asarray(toks, np.int64)]


def test_int8_kv_join_leave_neighbour_bit_parity(rng, lm):
    _, pn = lm
    prompt_a = _one_hot(rng.integers(0, V, 6))
    prompt_b = _one_hot(rng.integers(0, V, 4))

    def run(submit_b):
        cb = ContinuousBatcher(pn, slots=2, max_cache_len=32,
                               min_cache_len=32, max_new_tokens=8,
                               kv_cache="int8", device="cpu")
        try:
            ha = cb.submit(prompt=prompt_a)
            hb = cb.submit(prompt=prompt_b) if submit_b else None
            res = ha.result(timeout=120)["tokens"]
            if hb is not None:
                hb.result(timeout=120)
            return res
        finally:
            cb.shutdown()

    assert run(False) == run(True)


@pytest.mark.parametrize("paged", [False, True])
def test_quantized_weights_and_kv_end_to_end_vs_jax(rng, lm, paged):
    jn, pn = lm
    prompts = [rng.integers(0, V, n).tolist() for n in (5, 7)]
    kw = dict(slots=2, max_cache_len=32, min_cache_len=32,
              max_new_tokens=6, quantize="int8", kv_cache="int8",
              paged=paged)
    cb = ContinuousBatcher(pn, device="cpu", **kw)
    jcb = JBatcher(jn, **kw)
    try:
        got = [cb.submit(prompt=_one_hot(p)).result(timeout=120)["tokens"]
               for p in prompts]
        want = [jcb.submit(prompt=_one_hot(p)).result(timeout=120)["tokens"]
                for p in prompts]
        st = cb.stats()["engine"]
        assert st["quantize"] == "int8" and st["kv_cache"] == "int8"
        assert st["cold_calls"] == 0 and st["quantize_fallbacks"] == 0
    finally:
        cb.shutdown()
        jcb.shutdown()
    assert got == want
    with pytest.raises(ValueError, match="alongside"):
        ContinuousBatcher(pn, engine=GenerativeEngine(pn, device="cpu"),
                          quantize="int8", device="cpu")


def test_int8_shipment_crosses_both_ways(rng, lm):
    """An int8 ``KVShipment`` (int8 values and f32 scale leaves) written
    by the JAX replica is read by the port, adopted by an int8 decode
    pool and decoded to the JAX batcher's tokens; the port's replica
    writes the same payload bytes for the JAX decode pool."""
    jn, pn = lm
    prompt = _one_hot([3, 1, 4, 1, 5, 9, 2])
    kw = dict(pages=17, page_size=8, max_cache_len=32, prompt_buckets=[8])
    jship = JReplica(jn, kv_cache="int8", quantize="int8", **kw).prefill(
        prompt)
    ship = PrefillReplica(pn, kv_cache="int8", quantize="int8",
                          device="cpu", **kw).prefill(prompt)
    assert ship.kv_quant and jship.kv_quant
    assert set(ship.payload["0"]) == {"k", "v", "k_scale", "v_scale"}
    got = KVShipment.from_bytes(jship.to_bytes())
    for name, t in got.payload["0"].items():
        # the wire carries JAX's leaves bit for bit
        want = np.asarray(jship.payload["0"][name])
        assert str(t.dtype) == f"torch.{want.dtype}"
        np.testing.assert_array_equal(t.numpy(), want)
        # the port's own prefill: the same int8 values up to one step where
        # the two packages' projections straddle a rounding midpoint
        mine = ship.payload["0"][name].numpy()
        if name in ("k", "v"):
            assert np.abs(mine.astype(int) - want.astype(int)).max() <= 1
        else:
            np.testing.assert_allclose(mine, want, rtol=1e-5)
    back = JShipment.from_bytes(got.to_bytes())
    for name in jship.payload["0"]:
        np.testing.assert_array_equal(np.asarray(back.payload["0"][name]),
                                      np.asarray(jship.payload["0"][name]))
    dkw = dict(slots=2, max_cache_len=32, pages=17, page_size=8,
               max_new_tokens=5, paged=True, migrate_buckets=[1],
               kv_cache="int8", quantize="int8")
    dec = ContinuousBatcher(pn, device="cpu", **dkw)
    jdec = JBatcher(jn, **dkw)
    try:
        from_jax = dec.submit_prefilled(got).result(timeout=120)["tokens"]
        from_port = jdec.submit_prefilled(JShipment.from_bytes(
            ship.to_bytes())).result(timeout=120)["tokens"]
        jcol = JBatcher(jn, **{k: v for k, v in dkw.items()
                               if k != "migrate_buckets"})
        try:
            oracle = jcol.submit(prompt=prompt).result(timeout=120)["tokens"]
        finally:
            jcol.shutdown()
    finally:
        dec.shutdown()
        jdec.shutdown()
    assert from_jax == oracle and from_port == oracle


def test_int8_resnet50_epilogue_count_equals_jax(rng):
    """The quantized zoo ResNet-50 (uncut, 32 x 32 inputs on the CPU): its
    convolutions leave ``bias_act`` (they carry no bias; the int8 conv
    adds none), so the epilogue dispatches of one forward are the 53 BN
    epilogues in both packages: the K1 launches a forward the card run
    holds it to. The JAX graph runs the port's weights (its own init and
    quantize walk are not under test here: ``quantize_params`` is held bit
    for bit above), traced once under ``jit``; the outputs agree within
    the float32 walk's noise (a BN epilogue one ulp apart can move an
    activation across a rounding midpoint of its int8 step)."""
    from deeplearning4j_tpu.models.resnet import resnet50 as jresnet50
    from deeplearning4j_tpu.ops import fused_epilogues as jfe
    from deeplearning4j_tpu_torch.models.resnet import resnet50
    from deeplearning4j_tpu_torch.nn.layers.conv import BatchNormalization
    from deeplearning4j_tpu_torch.nn.vertices import LayerVertex
    from deeplearning4j_tpu_torch.ops import fused_epilogues as fe
    pn = resnet50(input_shape=(32, 32, 3), num_classes=10).init(device="cpu")
    jn = jresnet50(input_shape=(32, 32, 3), num_classes=10)
    jn.state = jax.tree.map(jnp.asarray, convert.to_numpy(pn.state))
    tqp = pn.quantize_params()
    jqp = jax.tree.map(
        lambda v: jq.QuantizedTensor(jnp.asarray(v.q), jnp.asarray(v.scale),
                                     v.axis)
        if isinstance(v, convert.QuantizedArrays) else jnp.asarray(v),
        convert.to_numpy(tqp),
        is_leaf=lambda v: isinstance(v, convert.QuantizedArrays))
    # the quantized sites: JAX's quantizable layers and their specs (the
    # s2d stem is not one in either package)
    jsites = {(n, w) for n, (v, _) in jn._vertex_map.items()
              if getattr(getattr(v, "layer", None), "quantizable", False)
              for w in v.layer.quantize_spec({})}
    assert _site_set(tqp) == jsites and len(jsites) == 53
    name, out = pn.conf.inputs[0], pn.conf.outputs[0]
    x = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    jfe.reset_counters()
    jy = jax.jit(lambda p, x: jn._forward(p, {name: x}, jn.state,
                                          train=False, rng=None)[0][out])(
        jqp, jnp.asarray(x))
    fe.reset_counters()
    with torch.no_grad():
        ty = pn._forward(tqp, {name: _t(x)}, pn.state)[0][out]
    bns = sum(isinstance(v, LayerVertex)
              and isinstance(v.layer, BatchNormalization)
              for v, _ in pn._vertex_map.values())
    assert bns == 53
    assert sum(jfe.counters().values()) == sum(fe.counters().values()) == bns
    a, b = _np(ty).astype(np.float64), _np(jy).astype(np.float64)
    assert np.linalg.norm(a - b) / np.linalg.norm(b) < 1e-3
