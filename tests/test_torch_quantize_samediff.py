"""The port's SameDiff weight-quantization rewrite and the quantization
gate against the JAX package's, on the CPU.

- ``autodiff/quantize.quantize_weights`` on one graph.json and value set
  in both packages: the same report (matched, skipped, sites, reasons,
  bytes), the same rewritten op list, the f32 weights dropped for int8
  values and f32 scales equal to JAX's bit for bit, the outputs within
  the float32 walk tolerance, the ``rewrite`` counters; every skip reason
  (shared weight, transpose, rank, dtype, ``min_elements``, no value);
  a tiny BERT in the ``"fusable"`` spelling after ``fuse_attention`` and
  ``fuse_epilogues``: 6 sites a layer, the fused sites untouched;
- serde: a rewritten graph saved by either package loads in the other
  (int8 constants included), and through ``samediff_from_numpy``;
  ``fit`` through a rewritten site raises;
- ``eval/quantization``: the gate passing on a trained LeNet (with labels)
  and on a graph engine and a rewritten SameDiff (label-free), tripping
  on deliberately broken scales, and the same delta as JAX's gate on the
  same predictions.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.autodiff import quantize as jaq
from deeplearning4j_tpu.autodiff.samediff import SameDiff as JSameDiff
from deeplearning4j_tpu.eval import quantization as jgate
from deeplearning4j_tpu_torch.autodiff import quantize as aq
from deeplearning4j_tpu_torch.autodiff.samediff import SameDiff
from deeplearning4j_tpu_torch.eval import quantization as gate
from deeplearning4j_tpu_torch.nn.config import InputType
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph, GraphBuilder
from deeplearning4j_tpu_torch.nn.layers.core import DenseLayer, OutputLayer
from deeplearning4j_tpu_torch.nn.model import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.config import NeuralNetConfiguration
from deeplearning4j_tpu_torch.ops import quantize as q
from deeplearning4j_tpu_torch.utils.convert import samediff_from_numpy

#: the two packages' float32 walks around the bit-equal int8 steps
WALK_TOL = dict(rtol=1e-5, atol=1e-6)


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


def _j_mlp(rng, feat=8, hidden=16, classes=4):
    sd = JSameDiff.create()
    x = sd.placeholder("x", (None, feat))
    w1 = sd.var("w1", rng.normal(size=(feat, hidden)).astype(np.float32))
    b1 = sd.var("b1", np.zeros(hidden, np.float32))
    h = sd.relu(sd.mmul(x, w1) + b1, name="h")
    w2 = sd.var("w2", rng.normal(size=(hidden, classes)).astype(np.float32))
    sd.softmax(sd.mmul(h, w2), name="out")
    return sd


def _port(jsd):
    return samediff_from_numpy(jsd.to_json(), {
        n: np.asarray(v) for n, v in jsd._values.items()}, device="cpu")


def _jax(sd):
    j = JSameDiff.from_json(sd.to_json())
    j._values = {n: jnp.asarray(sd._values[n].numpy()) for n in sd._values}
    return j


def _report(r):
    return (r.matched, r.skipped, r.sites, r.reasons, r.bytes_f32, r.bytes_q)


def _same_values(sd, jsd):
    assert set(sd._values) == set(jsd._values)
    for n, t in sd._values.items():
        want = np.asarray(jsd._values[n])
        assert str(t.dtype) == f"torch.{want.dtype}", n
        np.testing.assert_array_equal(t.numpy(), want)


def test_samediff_quantize_rewrite(rng):
    jsd = _j_mlp(rng)
    sd = _port(jsd)
    x = rng.normal(size=(3, 8)).astype(np.float32)
    y0 = sd.output({"x": x}, ["out"])["out"]
    q.reset_counters()
    rep, jrep = aq.quantize_weights(sd), jaq.quantize_weights(jsd)
    assert _report(rep) == _report(jrep)
    assert rep.matched == 2 and rep.skipped == 0 and rep.bytes_saved > 0
    assert sd.to_json() == jsd.to_json()
    ops = [r.op for r in sd._ops]
    assert ops.count("quantize.int8_mmul") == 2 and "linalg.mmul" not in ops
    assert "w1" not in sd._values and sd._values["w1__q"].dtype == torch.int8
    _same_values(sd, jsd)
    y1 = sd.output({"x": x}, ["out"])["out"]
    np.testing.assert_allclose(y1, np.asarray(jsd.output(
        {"x": x}, ["out"])["out"]), **WALK_TOL)
    assert np.abs(y1 - y0).max() < 0.05
    assert q.rewrite_counters() == {"matched": 2}


def _skip_graphs(rng):
    """``(name, jax graph)`` per skip reason."""
    out = []
    sd = JSameDiff.create()
    x = sd.placeholder("x", (None, 8))
    w = sd.var("w", rng.normal(size=(8, 8)).astype(np.float32))
    sd.call("math.add", sd.mmul(x, w, name="h"), w, name="out")
    out.append(("shared_weight", sd))
    sd = JSameDiff.create()
    x = sd.placeholder("x", (None, 8))
    w = sd.var("w", rng.normal(size=(8, 8)).astype(np.float32))
    sd.call("linalg.mmul", x, w, name="out", transpose_b=True)
    out.append(("transpose", sd))
    sd = JSameDiff.create()
    x = sd.placeholder("x", (2, 3, 8))
    w = sd.var("w", rng.normal(size=(2, 8, 4)).astype(np.float32))
    sd.call("linalg.mmul", x, w, name="out")
    out.append(("rank", sd))
    sd = JSameDiff.create()
    x = sd.placeholder("x", (None, 8))
    w = sd.constant("w", rng.integers(-3, 3, (8, 4)).astype(np.int32))
    sd.call("linalg.mmul", x, w, name="out")
    out.append(("dtype", sd))
    sd = JSameDiff.create()
    x = sd.placeholder("x", (None, 2))
    w = sd.var("w", rng.normal(size=(2, 2)).astype(np.float32))
    big = sd.var("big", rng.normal(size=(2, 8)).astype(np.float32))
    sd.call("linalg.mmul", sd.mmul(x, w, name="h"), big, name="out")
    out.append(("min_elements", sd))
    return out


@pytest.mark.parametrize("reason", ["shared_weight", "transpose", "rank",
                                    "dtype", "min_elements", "no_value"])
def test_samediff_rewrite_skips_equal_jax(rng, reason):
    if reason == "no_value":
        jsd = _j_mlp(rng)
        sd = _port(jsd)
        for s in (sd, jsd):
            del s._values["w2"]
    else:
        jsd = dict(_skip_graphs(rng))[reason]
        sd = _port(jsd)
    kw = {"min_elements": 5} if reason == "min_elements" else {}
    q.reset_counters()
    rep, jrep = aq.quantize_weights(sd, **kw), jaq.quantize_weights(jsd, **kw)
    assert _report(rep) == _report(jrep)
    assert rep.skipped == 1
    assert q.rewrite_counters()[f"skipped_{reason}"] == 1
    assert sd.to_json() == jsd.to_json()


def test_tiny_bert_rewrite_after_fusion_equals_jax():
    """The ``"fusable"`` BERT after both fusion passes: 6 mmul sites a
    layer (q, k, v, attention output, intermediate, output), none skipped,
    the fused attention and epilogue sites untouched, as in JAX."""
    from test_torch_bert_epilogues import TINY, _feeds, _fused_pair
    sd, jsd, _ = _fused_pair()
    before = [r.op for r in sd._ops]
    rep, jrep = aq.quantize_weights(sd), jaq.quantize_weights(jsd)
    layers = TINY["num_hidden_layers"]
    assert _report(rep) == _report(jrep)
    assert (rep.matched, rep.skipped) == (6 * layers, 0)
    after = [r.op for r in sd._ops]
    assert len(after) == len(before)
    for op in ("attention.fused_sdpa", "epilogue.layer_norm_act",
               "epilogue.bias_act"):
        assert after.count(op) == before.count(op)
    assert sd.to_json() == jsd.to_json()
    _same_values(sd, jsd)
    feeds = _feeds(0)
    np.testing.assert_allclose(
        np.asarray(sd.output(feeds, ["last_hidden_state"])[
            "last_hidden_state"]),
        np.asarray(jsd.output(feeds, ["last_hidden_state"])[
            "last_hidden_state"]), rtol=1e-4, atol=1e-5)


def test_samediff_rewrite_serde_both_ways(rng, tmp_path):
    jsd = _j_mlp(rng)
    sd = _port(jsd)
    aq.quantize_weights(sd)
    jaq.quantize_weights(jsd)
    x = rng.normal(size=(2, 8)).astype(np.float32)
    y0 = sd.output({"x": x}, ["out"])["out"]
    sd.save(str(tmp_path / "port.sdz"))
    jsd.save(str(tmp_path / "jax.sdz"))
    again = SameDiff.load(str(tmp_path / "port.sdz"), device="cpu")
    np.testing.assert_array_equal(again.output({"x": x}, ["out"])["out"], y0)
    from_jax = SameDiff.load(str(tmp_path / "jax.sdz"), device="cpu")
    _same_values(from_jax, jsd)
    np.testing.assert_array_equal(from_jax.output({"x": x}, ["out"])["out"],
                                  y0)
    in_jax = JSameDiff.load(str(tmp_path / "port.sdz"))
    np.testing.assert_allclose(np.asarray(in_jax.output(
        {"x": x}, ["out"])["out"]), y0, **WALK_TOL)
    np.testing.assert_array_equal(np.asarray(in_jax._values["w1__q"]),
                                  sd._values["w1__q"].numpy())
    carried = _port(jsd)
    np.testing.assert_array_equal(carried.output({"x": x}, ["out"])["out"],
                                  y0)


def test_fit_through_a_rewritten_site_raises(rng):
    from deeplearning4j_tpu_torch.nn.updaters import Adam
    jsd = _j_mlp(rng)
    sd = _port(jsd)
    y = sd.placeholder("y", (None, 4))
    sd.set_loss(sd.call("reduce.mean", sd.call(
        "math.square", sd.call("math.sub", sd._vars["out"], y)),
        name="loss"))
    sd.set_updater(Adam(learning_rate=1e-3))
    feeds = {"x": rng.normal(size=(3, 8)).astype(np.float32),
             "y": rng.normal(size=(3, 4)).astype(np.float32)}
    sd.fit(feeds)  # the f32 graph trains
    aq.quantize_weights(sd)
    with pytest.raises(RuntimeError, match="inference-only"):
        sd.fit(feeds)


# ------------------------------------------------------------------ gates

def _mlp(seed=0):
    conf = (NeuralNetConfiguration.builder().seed(seed)
            .input_type(InputType.feed_forward(8))
            .list(DenseLayer(n_out=32, activation="relu"),
                  DenseLayer(n_out=32, activation="tanh"),
                  OutputLayer(n_out=5))
            .build())
    return MultiLayerNetwork(conf).init(device="cpu")


def test_gate_passes_on_trained_lenet():
    from deeplearning4j_tpu_torch.data.dataset import DataSet
    from deeplearning4j_tpu_torch.models.lenet import lenet
    rng = np.random.default_rng(20260730)
    net = lenet(seed=777, device="cpu")
    x = rng.normal(size=(16, 1, 28, 28)).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, 16)]
    net.fit(DataSet(x, y), epochs=2)
    xt = rng.normal(size=(8, 1, 28, 28)).astype(np.float32)
    res = gate.quantization_gate(net, xt, labels=rng.integers(0, 10, 8),
                                 max_delta=0.25)
    assert res.passed and res.accuracy_baseline is not None
    assert res.cell_labels.get("engine") is not None
    assert gate.last_delta(**res.cell_labels) == res.delta


def test_gate_passes_on_cg_and_samediff(rng):
    conf = (GraphBuilder().add_inputs("in").set_input_types((8,))
            .layer("d", DenseLayer(n_out=16, activation="relu"), "in")
            .layer("out", OutputLayer(n_out=4), "d")
            .set_outputs("out").build())
    cg = ComputationGraph(conf).init(device="cpu")
    x = rng.normal(size=(4, 8)).astype(np.float32)
    assert gate.quantization_gate(cg, x, max_delta=0.25).passed
    jsd = _j_mlp(rng)
    sd, qsd = _port(jsd), _port(jsd)
    aq.quantize_weights(qsd)
    batches = [rng.normal(size=(4, 8)).astype(np.float32) for _ in range(3)]
    res = gate.accuracy_delta_gate(
        lambda b: sd.output({"x": b}, ["out"])["out"],
        lambda b: qsd.output({"x": b}, ["out"])["out"], batches,
        max_delta=0.25)
    assert res.passed


def test_gate_trips_on_broken_scales_and_agrees_with_jax(rng):
    """Deliberately corrupted scales must fail the gate; both packages'
    gates give the same delta on the same predictions."""
    net = _mlp()
    qp = net.quantize_params()
    broken = {si: {k: (q.QuantizedTensor(v.q, v.scale * 40.0, v.axis)
                       if q.is_quantized(v) else v) for k, v in p.items()}
              for si, p in qp.items()}

    def fwd(params):
        def run(b):
            with torch.no_grad():
                return net._forward(params, torch.from_numpy(b),
                                    net.state)[0].numpy()
        return run
    batches = [rng.normal(size=(8, 8)).astype(np.float32) for _ in range(4)]
    labels = [rng.integers(0, 5, 8) for _ in range(4)]
    fails0 = gate.gate_failures()
    with pytest.raises(gate.QuantizationGateError):
        gate.accuracy_delta_gate(fwd(net.params), fwd(broken), batches,
                                 max_delta=0.05)
    assert gate.gate_failures() == fails0 + 1
    res = gate.accuracy_delta_gate(fwd(net.params), fwd(broken), batches,
                                   max_delta=0.05, raise_on_fail=False)
    assert not res.passed and "FAIL" in repr(res)
    for lab in (None, labels):
        mine = gate.accuracy_delta_gate(fwd(net.params), fwd(qp), batches,
                                        labels=lab, max_delta=1.0)
        theirs = jgate.accuracy_delta_gate(fwd(net.params), fwd(qp),
                                           batches, labels=lab,
                                           max_delta=1.0)
        assert (mine.delta, mine.examples, mine.passed) == \
            (theirs.delta, theirs.examples, theirs.passed)
        assert mine.accuracy_baseline == theirs.accuracy_baseline
