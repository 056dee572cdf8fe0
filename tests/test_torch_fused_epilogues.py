"""The port's BN/bias + activation epilogues (kernel K1's plain version on
the CPU) against the JAX package's real K1 Pallas kernel, run in interpret
mode on the CPU under ``fused_epilogues.set_mode("force")``.

Tolerances: float32 atol 1e-5 (both sides compute ``x*scale + shift`` and
the activation in float32; libm and a possible fused multiply-add differ
by about 1 ulp); bfloat16 one bfloat16 ulp of the larger of the two
values (a 1-ulp float32 difference can round the last bit either way),
with the same 1e-5 absolute floor: in the far negative tail of gelu and
geluexact (|y| < 1e-5) XLA's tanh/erf approximations round to -0.0 where
libm keeps a tiny value, a float32 difference before any rounding."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.ops import fused_epilogues as jfe
from deeplearning4j_tpu.ops import nnops as jnn
from deeplearning4j_tpu_torch.kernels import affine_act as k1
from deeplearning4j_tpu_torch.ops import fused_epilogues as fe
from deeplearning4j_tpu_torch.ops import nnops
from test_torch_flash_attn_kernel import _FakeCuda


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


ACTS = ("identity", "relu", "relu6", "tanh", "sigmoid", "gelu", "geluexact")
DTYPES = ("float32", "bfloat16")


@pytest.fixture
def jax_force():
    """Route the JAX dispatch through its Pallas kernel (interpret)."""
    old = jfe.set_mode("force")
    try:
        yield
    finally:
        jfe.set_mode(old)


def _bf16_round(a: np.ndarray) -> np.ndarray:
    """float32 values exactly representable in bfloat16."""
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


def _inputs(seed, dtype, shape=(2, 4, 4, 24), axis=-1):
    rng = np.random.default_rng(seed)
    c = shape[axis]
    x = (rng.standard_normal(shape) * 2.0).astype(np.float32)
    if dtype == "bfloat16":
        x = _bf16_round(x)
    stats = dict(
        gamma=(rng.standard_normal(c) * 0.5 + 1.0).astype(np.float32),
        beta=rng.standard_normal(c).astype(np.float32),
        mean=(rng.standard_normal(c) * 0.3).astype(np.float32),
        var=(rng.random(c) + 0.5).astype(np.float32))
    return x, stats


def _port(a, dtype):
    t = torch.from_numpy(a)
    return t.to(torch.bfloat16) if dtype == "bfloat16" else t


def _jax(a, dtype):
    return jnp.asarray(a, jnp.bfloat16 if dtype == "bfloat16"
                       else jnp.float32)


def _assert_close(port_y, jax_y, dtype):
    got = port_y.float().numpy()
    want = np.asarray(jax_y, np.float32)
    assert got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
        return
    big = np.maximum(np.abs(got), np.abs(want))
    ulp = np.exp2(np.floor(np.log2(np.maximum(big, 1e-30))) - 7)
    tol = np.maximum(ulp, 1e-5)
    assert np.all(np.abs(got - want) <= tol), \
        float(np.max(np.abs(got - want) / tol))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("act", ACTS)
def test_bn_act_matches_jax_kernel(jax_force, act, dtype):
    x, st = _inputs(0, dtype)
    jfe.reset_counters()
    want = jfe.bn_act(_jax(x, dtype), *(jnp.asarray(st[k]) for k in
                                        ("gamma", "beta", "mean", "var")),
                      1e-5, -1, act=act)
    assert jfe.counters()["fused"] == 1  # the Pallas kernel really ran
    fe.reset_counters()
    got = fe.bn_act(_port(x, dtype), *(torch.from_numpy(st[k]) for k in
                                       ("gamma", "beta", "mean", "var")),
                    1e-5, -1, act=act)
    assert fe.counters()["fallback_platform"] == 1
    assert got.dtype == _port(x, dtype).dtype
    _assert_close(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("act", ACTS)
def test_bias_act_matches_jax_kernel(jax_force, act, dtype):
    x, st = _inputs(1, dtype)
    b = st["beta"]
    if dtype == "bfloat16":
        b = _bf16_round(b)
    jfe.reset_counters()
    want = jfe.bias_act(_jax(x, dtype), _jax(b, dtype), act=act)
    if act != "identity" or b is not None:
        assert jfe.counters()["fused"] == 1
    got = fe.bias_act(_port(x, dtype), _port(b, dtype), act=act)
    _assert_close(got, want, dtype)


def test_bias_act_without_bias_or_activation_launches_nothing():
    x = torch.ones(2, 3, 4)
    fe.reset_counters()
    assert fe.bias_act(x, None, act="identity") is x
    assert sum(fe.counters().values()) == 0


@pytest.mark.parametrize("act,alpha", [("leakyrelu", 0.2), ("elu", None),
                                       ("swish", None)])
def test_unfoldable_activation_counts_fallback_act(act, alpha):
    x, st = _inputs(2, "float32")
    stats = [torch.from_numpy(st[k]) for k in ("gamma", "beta", "mean",
                                               "var")]
    fe.reset_counters()
    got = fe.bn_act(torch.from_numpy(x), *stats, 1e-5, -1, act=act,
                    alpha=alpha)
    assert fe.counters() == {"fused": 0, "fallback_platform": 0,
                             "fallback_act": 1, "fallback_dtype": 0}
    want = jfe.reference_act(act, alpha)(jnn.batch_norm(
        jnp.asarray(x), *(jnp.asarray(st[k]) for k in
                          ("gamma", "beta", "mean", "var")), 1e-5, -1))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_bn_act_channels_first_on_cpu_matches_batch_norm():
    """NCHW (axis=1) takes the broadcast plain version on the CPU."""
    x, st = _inputs(3, "float32", shape=(2, 24, 4, 5), axis=1)
    stats = [torch.from_numpy(st[k]) for k in ("gamma", "beta", "mean",
                                               "var")]
    got = fe.bn_act(torch.from_numpy(x), *stats, 1e-5, 1, act="relu")
    want = torch.relu(nnops.batch_norm(torch.from_numpy(x), *stats, 1e-5, 1))
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)


def _plain(t):
    return None if t is None else t.as_subclass(torch.Tensor)


@pytest.mark.parametrize("memory", ["nchw", "channels_last"])
def test_nchw_epilogues_on_the_card_reach_k1_and_k2(monkeypatch, memory):
    """Channels-first (axis 1) bias_act and bn_act on a CUDA tensor take the
    channels-last route into K1's and K2's wrappers (stubbed here by their
    plain versions): each sees a contiguous [N*H*W, C] CUDA matrix. An
    NCHW-contiguous x costs one counted copy, a channels-last one none.
    The conv tail + BN + ReLU and its input gradient match the JAX
    package's bias_act/bn_act (its fallback at axis 1) within 1e-5."""
    import jax
    calls = []

    def k1_stub(x2, scale, shift, act):
        calls.append(("k1", x2.device.type, x2.is_contiguous()))
        return k1.affine_act_reference(_plain(x2), _plain(scale),
                                       _plain(shift), act).as_subclass(
                                           _FakeCuda)

    def k2_stub(x2, scale, shift, dy, act):
        calls.append(("k2", x2.device.type, x2.is_contiguous()))
        return tuple(None if t is None else t.as_subclass(_FakeCuda)
                     for t in k1.affine_act_bwd_reference(
                         _plain(x2), _plain(scale), _plain(shift),
                         _plain(dy), act))
    monkeypatch.setattr(fe._k1, "affine_act", k1_stub)
    monkeypatch.setattr(fe._k1, "affine_act_bwd", k2_stub)
    rng = np.random.default_rng(12)
    x = rng.standard_normal((2, 6, 5, 4)).astype(np.float32)
    b = rng.standard_normal(6).astype(np.float32)
    gamma, beta, mean = (rng.standard_normal(6).astype(np.float32)
                         for _ in range(3))
    var = rng.uniform(0.5, 2.0, 6).astype(np.float32)
    w = rng.standard_normal(x.shape).astype(np.float32)

    def jax_block(xx):
        y = jfe.bias_act(xx, jnp.asarray(b), act="identity", axis=1)
        return jfe.bn_act(y, jnp.asarray(gamma), jnp.asarray(beta),
                          jnp.asarray(mean), jnp.asarray(var), 1e-5, 1,
                          act="relu")
    want = jax_block(jnp.asarray(x))
    want_dx = jax.grad(lambda xx: jnp.sum(jax_block(xx) * w))(jnp.asarray(x))

    fmt = torch.contiguous_format if memory == "nchw" \
        else torch.channels_last
    tx = torch.from_numpy(x).contiguous(memory_format=fmt).as_subclass(
        _FakeCuda).requires_grad_()
    stats = [torch.from_numpy(a) for a in (gamma, beta, mean, var)]
    fe.reset_counters()
    y = fe.bias_act(tx, torch.from_numpy(b), act="identity", axis=1)
    z = fe.bn_act(y, *stats, 1e-5, 1, act="relu")
    (z * torch.from_numpy(w)).sum().backward()
    assert fe.counters()["fused"] == 2
    assert fe.nchw_copies == (1 if memory == "nchw" else 0)
    assert calls == [("k1", "cuda", True)] * 2 + [("k2", "cuda", True)] * 2
    np.testing.assert_allclose(_plain(z).detach().numpy(), np.asarray(want),
                               atol=1e-5)
    np.testing.assert_allclose(_plain(tx.grad).numpy(), np.asarray(want_dx),
                               atol=1e-5)


def test_integer_x_takes_the_jax_fallback_formula():
    """An int32 x never reaches the kernels: the JAX dispatcher's fallback
    (x + b, then the activation) promotes it, and the decision is counted
    as ``fallback_dtype`` (values: ``test_torch_ops_edge.py``)."""
    x = torch.tensor([[7, -7, 5, 0]], dtype=torch.int32)
    fe.reset_counters()
    y = fe.bias_act(x, torch.ones(4), act="gelu_exact")
    assert y.dtype == torch.float32
    assert fe.counters() == {"fused": 0, "fallback_platform": 0,
                             "fallback_act": 0, "fallback_dtype": 1}


def _stub_kernels(monkeypatch, calls):
    """K1's and K6's wrappers stubbed by their plain versions on the CPU
    data of a ``_FakeCuda`` tensor; each call records (kernel, dtype,
    device)."""
    def k1_stub(x2, scale, shift, act):
        calls.append(("k1", x2.dtype, x2.device.type))
        return k1.affine_act_reference(_plain(x2), _plain(scale),
                                       _plain(shift), act)

    def k6_stub(x2, g, b, eps, act):
        calls.append(("k6", x2.dtype, x2.device.type))
        return fe._k6.layer_norm_act_reference(_plain(x2), _plain(g),
                                               _plain(b), eps, act)
    monkeypatch.setattr(fe._k1, "affine_act", k1_stub)
    monkeypatch.setattr(fe._k6, "layer_norm_act", k6_stub)


@pytest.mark.parametrize("op", ["bias_act", "bn_act", "layer_norm_act"])
def test_integer_x_on_the_card_is_cast_and_takes_the_kernels(monkeypatch,
                                                             op):
    """An int32 CUDA x is cast to the float32 that JAX's fallback formula
    returns and goes through K1 (K6) as a float32 CUDA matrix, counted
    ``fused``; no plain formula runs on the card. The values equal the JAX
    package's within 1e-5 (both compute in float32)."""
    calls = []
    _stub_kernels(monkeypatch, calls)
    rng = np.random.default_rng(5)
    x = rng.integers(-4, 5, (3, 8)).astype(np.int32)
    p = [rng.standard_normal(8).astype(np.float32) for _ in range(3)] + [
        rng.uniform(0.5, 2.0, 8).astype(np.float32)]
    tx = torch.from_numpy(x).as_subclass(_FakeCuda)
    tp = [torch.from_numpy(a) for a in p]
    fe.reset_counters()
    if op == "bias_act":
        got = fe.bias_act(tx, tp[0], act="gelu_exact")
        want = jfe.bias_act(jnp.asarray(x), jnp.asarray(p[0]),
                            act="gelu_exact")
    elif op == "bn_act":
        got = fe.bn_act(tx, *tp, 1e-5, -1, act="relu")
        want = jfe.bn_act(jnp.asarray(x), *map(jnp.asarray, p), 1e-5, -1,
                          act="relu")
    else:
        got = fe.layer_norm_act(tx, tp[0], tp[1], 1e-5, act="tanh")
        want = jfe.layer_norm_act(jnp.asarray(x), jnp.asarray(p[0]),
                                  jnp.asarray(p[1]), 1e-5, act="tanh")
    kernel = "k6" if op == "layer_norm_act" else "k1"
    assert calls == [(kernel, torch.float32, "cuda")]
    assert fe.counters() == {"fused": 1, "fallback_platform": 0,
                             "fallback_act": 0, "fallback_dtype": 0}
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(_plain(got).numpy(), np.asarray(want),
                               atol=1e-5)


@pytest.mark.parametrize("b,act", [(np.ones(4, np.int32), "relu"),
                                   (None, "relu")])
def test_integer_result_on_the_card_raises(monkeypatch, b, act):
    """Where JAX's formula stays integer (int32 x + int32 b, then relu), no
    kernel can compute it: a CUDA x raises and launches nothing."""
    calls = []
    _stub_kernels(monkeypatch, calls)
    tx = torch.tensor([[7, -7, 5, 0]], dtype=torch.int32).as_subclass(
        _FakeCuda)
    with pytest.raises(ValueError, match="float32, bfloat16 or float16"):
        fe.bias_act(tx, None if b is None else torch.from_numpy(b), act=act)
    assert calls == []


def test_foldable_set_matches_jax():
    assert tuple(fe._FOLDABLE) == tuple(jfe._FOLDABLE)
    for act in ACTS + ("leakyrelu", "swish", "Gelu_Exact"):
        assert fe.foldable_act(act) == jfe.foldable_act(act)
        assert fe.foldable_act(act, 0.1) == jfe.foldable_act(act, 0.1)


@pytest.mark.parametrize("act", ACTS)
def test_plain_version_computes_in_f32_and_casts_once(act):
    """affine_act_reference is the kernel's arithmetic: f32 math, one cast
    to x's dtype (not the bf16 math of an unfused bf16 program)."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((16, 8)).astype(np.float32))
    s = torch.from_numpy(rng.random(8).astype(np.float32) + 0.5)
    b = torch.from_numpy(rng.standard_normal(8).astype(np.float32))
    xb = x.to(torch.bfloat16)
    got = k1.affine_act_reference(xb, s, b, act)
    want = k1.act_fwd(act, xb.float() * s + b).to(torch.bfloat16)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want)
