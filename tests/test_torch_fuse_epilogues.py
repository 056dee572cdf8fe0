"""The port's ``fuse_epilogues`` against the JAX package's, on the CPU.

Every spelling of the reference's own tests
(``tests/test_fused_epilogues.py``: ``_record_ln_chain`` in keras' folded
and the plain form, ``_record_gelu_chain`` in groupings a, b and c with and
without the bias, the safety rule, a graph with no anchor), plus the
spellings the matcher must refuse (a StopGradient identity under the
variance, ``axis=(2,)`` on an ARRAY of unrecorded rank), is recorded in
the port, saved, loaded by the JAX ``SameDiff.load`` and fused in both.
The two FusionReports (matched, unmatched, sites, kinds, reasons) and the
fused op lists must be equal, the port's output must not move by more
than the reference's own bound (1e-5 for LayerNorm, 2e-6 for GELU), and
both packages' fused graphs must agree within 1e-5 and load in the other
package (ZIPs both ways)."""

import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deeplearning4j_tpu.autodiff import fusion as jfusion
from deeplearning4j_tpu.autodiff.samediff import SameDiff as JSameDiff
from deeplearning4j_tpu_torch.autodiff import fusion
from deeplearning4j_tpu_torch.autodiff.samediff import SameDiff
from deeplearning4j_tpu_torch.nn.updaters import Sgd
from deeplearning4j_tpu_torch.ops import fused_epilogues as fe

C = 16
PARITY_TOL = 1e-5


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


def _record_ln_chain(sd, x, prefix, rng, form="keras", axis=(-1,),
                     stop_gradient=False):
    """The reference test's two LayerNorm spellings (and, with
    ``stop_gradient``, TF's ``tf.nn.moments`` identity under the
    variance, which the matcher does not see through)."""
    g = sd.var(f"{prefix}_gamma",
               (rng.normal(size=(C,)) + 1.0).astype(np.float32))
    b = sd.var(f"{prefix}_beta", rng.normal(size=(C,)).astype(np.float32))
    eps = sd.constant(f"{prefix}_eps", np.float32(1e-5))
    mean = sd.call("reduce.mean", x, axis=axis, keepdims=True)
    if form == "keras":  # keras-folded: x*inv2 + (beta - mean*inv2)
        m = sd.call("act.identity", mean) if stop_gradient else mean
        sqd = sd.call("math.squared_difference", x, m)
        var = sd.call("reduce.mean", sqd, axis=axis, keepdims=True)
        inv = sd.call("math.rsqrt", sd.call("math.add", var, eps))
        inv2 = sd.call("math.mul", inv, g)
        t1 = sd.call("math.mul", x, inv2)
        t2 = sd.call("math.mul", mean, inv2)
        s = sd.call("math.sub", b, t2)
        return sd.call("math.add", t1, s, name=f"{prefix}_out")
    d = sd.call("math.sub", x, mean)  # plain: ((x-mean)*inv)*gamma + beta
    sq = sd.call("math.square", d)
    var = sd.call("reduce.mean", sq, axis=axis, keepdims=True)
    inv = sd.call("math.rsqrt", sd.call("math.add", var, eps))
    n = sd.call("math.mul", inv, d)
    gm = sd.call("math.mul", n, g)
    return sd.call("math.add", gm, b, name=f"{prefix}_out")


def _record_gelu_chain(sd, x, prefix, rng, grouping="a", bias=False):
    """Exact GELU (erf) as exporters spell it, in 3 multiply groupings."""
    if bias:
        bv = sd.var(f"{prefix}_bias",
                    rng.normal(size=(C,)).astype(np.float32))
        x = sd.call("math.add", x, bv)
    c = sd.constant(f"{prefix}_c", np.float32(0.7071067811865476))
    one = sd.constant(f"{prefix}_one", np.float32(1.0))
    half = sd.constant(f"{prefix}_half", np.float32(0.5))
    e = sd.call("math.erf", sd.call("math.mul", x, c))
    f = sd.call("math.add", one, e)
    if grouping == "a":    # (x*f)*0.5
        return sd.call("math.mul", sd.call("math.mul", x, f), half,
                       name=f"{prefix}_out")
    if grouping == "b":    # (0.5*f)*x
        return sd.call("math.mul", sd.call("math.mul", half, f), x,
                       name=f"{prefix}_out")
    return sd.call("math.mul", f, sd.call("math.mul", half, x),
                   name=f"{prefix}_out")  # f*(0.5*x)


def _ln_graph(form, **kw):
    def build(sd, rng):
        x = sd.placeholder("x", (None, C))
        return [_record_ln_chain(sd, x, "ln", rng, form=form, **kw).name]
    return build


def _gelu_graph(grouping, bias):
    def build(sd, rng):
        x = sd.placeholder("x", (None, C))
        return [_record_gelu_chain(sd, x, "g", rng, grouping, bias).name]
    return build


def _ln_gelu_graph(sd, rng):
    """The reference's serde and train-through graph: LayerNorm, then an
    exact GELU of its output, then a dense layer."""
    x = sd.placeholder("x", (None, C))
    ln = _record_ln_chain(sd, x, "ln", rng, form="keras")
    out = _record_gelu_chain(sd, ln, "g", rng, grouping="a")
    w = sd.var("w", rng.normal(size=(C, 1)).astype(np.float32))
    sd.call("linalg.mmul", out, w, name="pred")
    return [out.name, "pred"]


def _safety_graph(sd, rng):
    """A second consumer of the mean, outside the chain."""
    x = sd.placeholder("x", (None, C))
    out = _record_ln_chain(sd, x, "ln", rng, form="keras")
    mean = next(r.output for r in sd._ops if r.op == "reduce.mean")
    sd.call("math.square", sd._vars[mean], name="outside_sq")
    return [out.name, "outside_sq"]


def _no_anchor_graph(sd, rng):
    a = sd.placeholder("x")
    sd.call("math.mul", a, a, name="sq")
    return ["sq"]


def _axis2_graph(sd, rng):
    """``axis=(2,)`` on an ARRAY (no recorded rank): refused, with a
    reason, in both packages; on the placeholder itself (rank recorded)
    it fuses."""
    x3 = sd.placeholder("x", (None, 4, C))
    h = sd.call("act.tanh", x3)
    a = _record_ln_chain(sd, h, "ln_a", rng, axis=(2,))
    b = _record_ln_chain(sd, x3, "ln_b", rng, axis=(2,))
    return [a.name, b.name]


# name -> (builder, feed shape, (matched, unmatched, kinds))
CASES = {
    "ln-keras": (_ln_graph("keras"), (16, C), (1, 0, ["layer_norm"])),
    "ln-plain": (_ln_graph("plain"), (16, C), (1, 0, ["layer_norm"])),
    **{f"gelu-{g}{'-bias' if b else ''}": (
        _gelu_graph(g, b), (8, C), (1, 0, ["gelu"]))
       for g in "abc" for b in (False, True)},
    "ln-gelu-dense": (_ln_gelu_graph, (8, C), (2, 0, ["layer_norm",
                                                      "gelu"])),
    "safety-rule": (_safety_graph, (8, C), (0, 1, [])),
    "no-anchor": (_no_anchor_graph, (3, 5), (0, 0, [])),
    "stop-gradient": (_ln_graph("keras", stop_gradient=True), (8, C),
                      (0, 0, [])),
    "axis-2": (_axis2_graph, (2, 4, C), (1, 1, ["layer_norm"])),
}


def _report(rep):
    return (rep.matched, rep.unmatched, rep.sites, rep.kinds, rep.reasons)


def _ops(sd):
    """The op list as graph.json stores it."""
    return json.loads(sd.to_json())["ops"]


def _out(sd, feeds, targets):
    got = sd.output(feeds, targets)
    return {t: np.asarray(got[t], np.float32) for t in targets}


@pytest.mark.parametrize("case", list(CASES))
def test_report_and_outputs_match_jax(case, tmp_path):
    build, shape, (matched, unmatched, kinds) = CASES[case]
    sd = SameDiff(device="cpu")
    targets = build(sd, np.random.default_rng(0))
    path = str(tmp_path / "unfused.zip")
    sd.save(path)
    jsd = JSameDiff.load(path)
    feeds = {"x": np.random.default_rng(1).standard_normal(shape)
             .astype(np.float32)}
    before = _out(sd, feeds, targets)

    rep, jrep = fusion.fuse_epilogues(sd), jfusion.fuse_epilogues(jsd)
    assert _report(rep) == _report(jrep)
    assert (rep.matched, rep.unmatched, rep.kinds) == (matched, unmatched,
                                                       kinds), rep.reasons
    assert _ops(sd) == _ops(jsd)
    if unmatched:
        assert rep.reasons and all(":" in r for r in rep.reasons)
    fe.reset_counters()
    after = _out(sd, feeds, targets)
    assert fe.counters()["fallback_platform"] == matched
    want = _out(jsd, feeds, targets)
    tol = 2e-6 if kinds == ["gelu"] else PARITY_TOL
    for t in targets:
        np.testing.assert_allclose(after[t], before[t], atol=tol, rtol=tol)
        np.testing.assert_allclose(after[t], want[t], atol=PARITY_TOL,
                                   rtol=PARITY_TOL)

    # the fused graphs, ZIPs both ways
    sd.save(str(tmp_path / "port.zip"))
    jsd.save(str(tmp_path / "jax.zip"))
    from_port = JSameDiff.load(str(tmp_path / "port.zip"))
    from_jax = SameDiff.load(str(tmp_path / "jax.zip"), device="cpu")
    assert _ops(from_jax) == _ops(sd)
    for t in targets:
        np.testing.assert_allclose(_out(from_port, feeds, targets)[t],
                                   want[t], atol=0, rtol=0)
        np.testing.assert_allclose(_out(from_jax, feeds, targets)[t],
                                   after[t], atol=0, rtol=0)


def test_refused_sites_leave_the_graph_untouched():
    sd = SameDiff(device="cpu")
    targets = _safety_graph(sd, np.random.default_rng(0))
    feeds = {"x": np.random.default_rng(2).standard_normal((8, C))
             .astype(np.float32)}
    before, n_ops = _out(sd, feeds, targets), len(sd._ops)
    rep = fusion.fuse_epilogues(sd)
    assert any("outside consumers" in r for r in rep.reasons), rep.reasons
    assert len(sd._ops) == n_ops
    after = _out(sd, feeds, targets)
    for t in targets:
        np.testing.assert_array_equal(after[t], before[t])


def test_fused_graph_trains_through_the_epilogues_as_in_jax():
    """The reference's train-through test in both packages: SGD(0.05) on
    the fused LayerNorm + GELU + dense graph for 3 epochs, losses and the
    new values within 1e-5 (the epilogues' backward: K7's and K2's plain
    versions in the port, autodiff through the fallback in JAX)."""
    rng = np.random.default_rng(3)
    sd = SameDiff(device="cpu")
    _ln_gelu_graph(sd, rng)
    jsd = JSameDiff.from_json(sd.to_json())
    jsd._values = {n: jnp.asarray(sd.get_value(n)) for n in sd._values}
    assert _report(fusion.fuse_epilogues(sd)) == \
        _report(jfusion.fuse_epilogues(jsd))
    feeds = [{"x": rng.standard_normal((8, C)).astype(np.float32)}]
    for s, upd in ((sd, Sgd(learning_rate=0.05)), (jsd, None)):
        if upd is None:
            from deeplearning4j_tpu.nn.updaters import Sgd as JSgd
            upd = JSgd(learning_rate=0.05)
        s.set_loss(s._vars["pred"].mean())
        s.set_updater(upd)
    hist, jhist = sd.fit(feeds, epochs=3), jsd.fit(feeds, epochs=3)
    np.testing.assert_allclose(hist.losses, jhist.losses, rtol=1e-5,
                               atol=1e-6)
    assert hist.losses[-1] < hist.losses[0]
    for n in sd.variables():
        np.testing.assert_allclose(sd.get_value(n),
                                   np.asarray(jsd.get_value(n)),
                                   rtol=1e-5, atol=1e-6, err_msg=n)
