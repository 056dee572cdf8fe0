"""The port's SameDiff control flow and ``evaluate`` against the JAX
package on the CPU.

1. ``cond``, ``while_loop`` and ``scan`` record the JAX package's
   ``graph.json`` and give its outputs (1e-6: the same float32 ops in
   another library), with either predicate, a captured VARIABLE, a
   multi-output body and an empty scan; the predicate reads are counted.
2. Gradients through ``cond`` (each branch) and ``scan`` equal
   ``jax.grad`` of the JAX graph (1e-5), and ``torch.autograd.gradcheck``
   holds in float64; a gradient through ``while_loop`` raises in both
   packages.
3. ZIPs with control flow saved by each package run in the other.
4. ``evaluate``, with index and one-hot labels, gives the JAX package's
   confusion matrix.
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.autodiff.samediff import SameDiff as JSameDiff
from deeplearning4j_tpu_torch.autodiff.samediff import SameDiff

TOL = 1e-6
GRAD_TOL = 1e-5
_R = np.random.default_rng(0)
W0 = (_R.standard_normal((3, 3)) * 0.5).astype(np.float32)
B0 = _R.standard_normal(3).astype(np.float32)


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


def _build(sd):
    """A graph with each control-flow record: a cond whose branches read a
    captured VARIABLE, a while loop carrying a counter and a value, a scan
    with a carry and per-step outputs, and a loss over all three."""
    x = sd.placeholder("x")
    p = sd.placeholder("p")
    xs = sd.placeholder("xs")
    w = sd.var("w", W0)
    b = sd.var("b", B0)
    (y,) = sd.cond(p, lambda s, a: s.call("act.tanh", a.mmul(w) + b),
                   lambda s, a: s.call("act.sigmoid", a).mmul(w), x,
                   name="y")
    i0 = sd.constant("i0", np.int32(0))
    _, z = sd.while_loop(
        lambda s, i, v: s.call("math.less", i, s._lift(np.int32(3))),
        lambda s, i, v: (i + np.int32(1), v * 1.5 - 0.25), i0, y,
        name="wl")
    (c,), (h, q) = sd.scan(
        lambda s, c, xt: (s.call("act.tanh", c.mmul(w) + xt),
                          s.call("act.sigmoid", c), c * b),
        [y], [xs], name="sc")
    loss = sd.call("math.add",
                   sd.call("reduce.sum", sd.call("math.square", c)),
                   sd.call("reduce.mean", h * q), name="loss")
    sd.call("reduce.sum", z, name="zsum")
    sd.set_loss(loss)
    return sd


def _feeds(pred, steps=4):
    rng = np.random.default_rng(1)
    return {"x": rng.standard_normal((2, 3)).astype(np.float32),
            "p": np.array(pred),
            "xs": rng.standard_normal((steps, 2, 3)).astype(np.float32)}


TARGETS = ["y", "wl", "wl__1", "sc", "sc__1", "sc__2", "loss", "zsum"]


@pytest.mark.parametrize("pred", [True, False])
def test_control_flow_outputs_match_jax(pred):
    sd, jsd = _build(SameDiff(device="cpu")), _build(JSameDiff())
    assert sd.to_json() == jsd.to_json()
    feeds = _feeds(pred)
    got, want = sd.output(feeds, TARGETS), jsd.output(feeds, TARGETS)
    for t in TARGETS:
        assert got[t].shape == np.asarray(want[t]).shape, t
        assert got[t].dtype == np.asarray(want[t]).dtype, t
        np.testing.assert_allclose(got[t], np.asarray(want[t]), rtol=TOL,
                                   atol=TOL, err_msg=t)
    # a cond predicate and four while conditions read on the host
    assert sd.host_syncs == 5
    assert int(got["wl"]) == 3


def test_empty_scan_matches_jax():
    sd, jsd = _build(SameDiff(device="cpu")), _build(JSameDiff())
    feeds = _feeds(True, steps=0)
    got = sd.output(feeds, ["sc", "sc__1", "sc__2"])
    want = jsd.output(feeds, ["sc", "sc__1", "sc__2"])
    for t in got:
        assert got[t].shape == np.asarray(want[t]).shape
        np.testing.assert_allclose(got[t], np.asarray(want[t]), rtol=TOL,
                                   atol=TOL)


@pytest.mark.parametrize("pred", [True, False])
def test_gradients_through_cond_and_scan_match_jax(pred):
    sd, jsd = _build(SameDiff(device="cpu")), _build(JSameDiff())
    feeds = _feeds(pred)
    got, want = sd.grad(feeds), jsd.grad(feeds)
    assert sorted(got) == ["b", "w"]
    for n in got:
        np.testing.assert_allclose(got[n], np.asarray(want[n]),
                                   rtol=GRAD_TOL, atol=GRAD_TOL, err_msg=n)
    # the false branch reads only w: b's gradient comes from the scan alone
    assert np.abs(got["b"]).max() > 0


def test_gradcheck_through_cond_and_scan_in_float64():
    sd = _build(SameDiff(device="cpu"))
    feeds = {k: torch.from_numpy(v).double() if v.dtype == np.float32
             else torch.from_numpy(v) for k, v in _feeds(True).items()}
    ops, _ = sd._needed([sd.loss_name])

    def loss(w, b):
        env = {**{k: t.double() if t.is_floating_point() else t
                  for k, t in sd._values.items()}, **feeds, "w": w, "b": b}
        sd._exec_ops(ops, env)
        return env[sd.loss_name]

    args = (torch.from_numpy(W0).double().requires_grad_(True),
            torch.from_numpy(B0).double().requires_grad_(True))
    assert torch.autograd.gradcheck(loss, args)


def _while_graph(sd):
    x = sd.placeholder("x")
    w = sd.var("w", W0)
    _, z = sd.while_loop(
        lambda s, i, v: s.call("math.less", i, s._lift(np.int32(3))),
        lambda s, i, v: (i + np.int32(1), v.mmul(w)),
        sd.constant("i0", np.int32(0)), x)
    sd.set_loss(sd.call("reduce.sum", z))
    return sd


def test_gradient_through_while_loop_raises_in_both():
    feeds = {"x": _feeds(True)["x"]}
    with pytest.raises(ValueError, match="[Rr]everse-mode"):
        _while_graph(SameDiff(device="cpu")).grad(feeds)
    with pytest.raises(ValueError, match="[Rr]everse-mode"):
        _while_graph(JSameDiff()).grad(feeds)
    # the forward runs
    sd = _while_graph(SameDiff(device="cpu"))
    out = sd.output(feeds, [sd.loss_name])[sd.loss_name]
    want = (feeds["x"] @ W0 @ W0 @ W0).sum()
    np.testing.assert_allclose(out, want, rtol=1e-5)


def test_control_flow_zips_run_in_the_other_package(tmp_path):
    feeds = _feeds(False)
    jsd = _build(JSameDiff())
    jsd.save(str(tmp_path / "j.zip"))
    sd = SameDiff.load(str(tmp_path / "j.zip"), device="cpu")
    assert sd.to_json() == jsd.to_json()
    got, want = sd.output(feeds, TARGETS), jsd.output(feeds, TARGETS)
    for t in TARGETS:
        np.testing.assert_allclose(got[t], np.asarray(want[t]), rtol=TOL,
                                   atol=TOL)
    port = _build(SameDiff(device="cpu"))
    port.save(str(tmp_path / "p.zip"))
    back = JSameDiff.load(str(tmp_path / "p.zip"))
    feeds = _feeds(True)
    got, want = port.output(feeds, TARGETS), back.output(feeds, TARGETS)
    for t in TARGETS:
        np.testing.assert_allclose(got[t], np.asarray(want[t]), rtol=TOL,
                                   atol=TOL)


def _classifier(sd):
    rng = np.random.default_rng(5)
    x = sd.placeholder("x")
    w = sd.var("w", rng.standard_normal((6, 4)).astype(np.float32))
    sd.call("act.softmax", x.mmul(w), name="probs")
    return sd


@pytest.mark.parametrize("one_hot", [False, True])
def test_evaluate_matches_jax(one_hot):
    rng = np.random.default_rng(6)
    batches = []
    for _ in range(3):
        x = rng.standard_normal((16, 6)).astype(np.float32)
        y = rng.integers(0, 4, 16)
        batches.append(({"x": x}, np.eye(4, dtype=np.float32)[y]
                        if one_hot else y))
    ev = _classifier(SameDiff(device="cpu")).evaluate(batches, "probs")
    jev = _classifier(JSameDiff()).evaluate(batches, "probs")
    np.testing.assert_array_equal(ev.confusion, jev.confusion)
    assert ev.accuracy() == pytest.approx(jev.accuracy())
    assert ev.confusion.sum() == 48
