"""The port's attention dispatch and K3's plain version against the JAX
package, on the CPU (K3's wrapper and K3 on the card:
``test_torch_flash_attn_kernel.py``, which imports no JAX).

The same numpy inputs go through the JAX package's
``reference_attention`` and its Pallas flash kernel in interpret mode
(``flash_attention(..., interpret=True)``, and ``_fwd_impl`` for the row
statistics ``m`` and ``l``), and through the port's
``reference_attention``, ``attention`` (the CPU route) and K3's plain
version ``kernels.flash_attention.flash_attention_fwd_reference``.
Tolerances: float32 within 1e-5 absolute (the JAX package's
kernel-vs-reference contract; both compute in f32 in other orders);
bfloat16 within 2 ulps of bfloat16 (``ulp_error``: p and o are rounded
at the same points on both sides, so only a rounding that f32 sum-order
noise flips can differ). Cases: (B, H, Tq, Tk, d) = (2, 3, 16, 16, 8),
Tq != Tk, T = 24; no bias, a ragged key bias, fully masked rows."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.ops import flash_attention as jfa
from deeplearning4j_tpu_torch.kernels import flash_attention as k3
from deeplearning4j_tpu_torch.ops import flash_attention as fa

SHAPES = [(2, 3, 16, 16, 8), (2, 3, 16, 24, 8), (2, 3, 24, 24, 8)]
BIASES = ["none", "ragged", "masked"]
F32_ATOL = 1e-5
ULP_TOL = 2.0
NEG = float(np.finfo(np.float32).min)


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


def _inputs(shape, bias_kind, seed=0):
    B, H, Tq, Tk, d = shape
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, Tq, d)).astype(np.float32)
    k = rng.standard_normal((B, H, Tk, d)).astype(np.float32)
    v = rng.standard_normal((B, H, Tk, d)).astype(np.float32)
    if bias_kind == "none":
        return q, k, v, None
    lengths = rng.integers(1, Tk + 1, B)
    bias = np.where(np.arange(Tk)[None, :] < lengths[:, None], 0.0,
                    -1e30).astype(np.float32)
    if bias_kind == "masked":
        bias[0] = -1e30  # every key of batch row 0 masked
    return q, k, v, bias[:, None, None, :]


def _torch(a, dtype=torch.float32):
    return None if a is None else torch.from_numpy(a).to(dtype)


def _jax(a, dtype=jnp.float32):
    return None if a is None else jnp.asarray(a).astype(dtype)


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@pytest.mark.parametrize("bias_kind", BIASES)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_float32_matches_jax(shape, bias_kind):
    q, k, v, bias = _inputs(shape, bias_kind)
    want_ref = _np(jfa.reference_attention(_jax(q), _jax(k), _jax(v),
                                           _jax(bias)))
    want_kernel = _np(jfa.flash_attention(_jax(q), _jax(k), _jax(v),
                                          _jax(bias), interpret=True))
    tq, tk, tv, tb = (_torch(a) for a in (q, k, v, bias))
    ref = fa.reference_attention(tq, tk, tv, tb).numpy()
    kb = fa._key_bias(tb, shape[0], shape[3])
    plain, m, l = k3.flash_attention_fwd_reference(tq, tk, tv, kb)
    fa.reset_counters()
    routed = fa.attention(tq, tk, tv, tb).numpy()
    assert fa.counters()["fallback_platform"] == 1
    np.testing.assert_allclose(ref, want_ref, atol=F32_ATOL, rtol=0)
    np.testing.assert_allclose(routed, want_ref, atol=F32_ATOL, rtol=0)
    np.testing.assert_allclose(plain.numpy(), want_kernel, atol=F32_ATOL,
                               rtol=0)
    # the row statistics: one key tile on both sides, so m is the same max
    B, H, Tq, Tk, d = shape
    jkb = None if bias is None else jfa._key_bias(_jax(bias), B, Tk)
    _, jm, jl = jfa._fwd_impl(
        _jax(q).reshape(B * H, Tq, d), _jax(k).reshape(B * H, Tk, d),
        _jax(v).reshape(B * H, Tk, d), jkb, 1.0 / np.sqrt(d), H, Tq, Tk,
        True)
    np.testing.assert_allclose(m.numpy(), np.asarray(jm)[..., 0],
                               rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(l.numpy(), np.asarray(jl)[..., 0],
                               rtol=1e-5)
    if bias_kind == "masked":  # a fully masked row attends uniformly
        np.testing.assert_allclose(routed[0], np.broadcast_to(
            v[0].mean(axis=1, keepdims=True), routed[0].shape), atol=1e-5)


@pytest.mark.parametrize("bias_kind", BIASES)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_bfloat16_matches_jax(shape, bias_kind):
    q, k, v, bias = _inputs(shape, bias_kind, seed=1)
    jq, jk, jv = (_jax(a, jnp.bfloat16) for a in (q, k, v))
    want_ref = jfa.reference_attention(jq, jk, jv, _jax(bias))
    want_kernel = jfa.flash_attention(jq, jk, jv, _jax(bias),
                                      interpret=True)
    tq, tk, tv = (_torch(a, torch.bfloat16) for a in (q, k, v))
    tb = _torch(bias)
    ref = fa.reference_attention(tq, tk, tv, tb)
    plain = k3.flash_attention_fwd_reference(
        tq, tk, tv, fa._key_bias(tb, shape[0], shape[3]))[0]
    assert ref.dtype == plain.dtype == torch.bfloat16
    for got, want in ((ref, want_ref), (plain, want_kernel)):
        want_t = torch.from_numpy(_np(want).copy()).to(torch.bfloat16)
        assert k3.ulp_error(got, want_t) <= ULP_TOL


def test_key_bias_reduction_and_clamp():
    b = torch.full((2, 1, 1, 5), -1e38)
    b[1, ..., :3] = 0.0
    kb = fa._key_bias(b * 10, 2, 5)  # -1e39 overflows float32 to -inf
    assert kb.shape == (2, 5) and kb.dtype == torch.float32
    assert float(kb.min()) == NEG and torch.isfinite(kb).all()
    assert fa._key_bias(torch.zeros(1, 1, 1, 5), 3, 5).shape == (3, 5)
    for bad in (torch.zeros(2, 2, 1, 5), torch.zeros(2, 1, 4, 5),
                torch.zeros(2, 5), torch.zeros(3, 1, 1, 5),
                torch.zeros(2, 1, 1, 4)):
        assert fa._key_bias(bad, 2, 5) is None
    jb = np.zeros((2, 1, 1, 5), np.float32)
    jb[0] = -1e30
    np.testing.assert_array_equal(
        fa._key_bias(torch.from_numpy(jb), 2, 5).numpy(),
        np.asarray(jfa._key_bias(jnp.asarray(jb), 2, 5)))


def test_reference_is_differentiable_on_the_cpu():
    q, k, v, bias = _inputs((2, 3, 16, 24, 8), "ragged")
    tq, tk, tv = (_torch(a).requires_grad_() for a in (q, k, v))
    fa.attention(tq, tk, tv, _torch(bias)).sum().backward()
    assert all(t.grad is not None and torch.isfinite(t.grad).all()
               for t in (tq, tk, tv))


# ----------------------------------------------------- routes and counters

class _FakeCuda(torch.Tensor):
    """A CPU tensor that reports a CUDA device: it walks the CUDA routes
    on a machine without a card."""

    @property
    def device(self):
        return torch.device("cuda")


def _fake(t):
    return None if t is None else t.as_subclass(_FakeCuda)


def _plain(t):
    return None if t is None else t.as_subclass(torch.Tensor)


@pytest.fixture
def stub_kernel(monkeypatch):
    """K3's and the backward's wrappers replaced by their plain versions;
    the list records K3's key biases, then "bwd" for the fused backward
    (or "dq" and "dkv" for its dq-only and dk/dv-only calls)."""
    calls = []

    def fwd(q, k, v, kb=None, scale=None):
        calls.append(kb)
        return k3.flash_attention_fwd_reference(
            *map(_plain, (q, k, v, kb)), scale)

    def bwd(name, plain):
        def stub(*args):
            calls.append(name)
            return plain(*map(_plain, args[:-1]), args[-1])
        return stub
    monkeypatch.setattr(k3, "flash_attention_fwd", fwd)
    monkeypatch.setattr(k3, "flash_attention_bwd_dq", bwd(
        "dq", k3.flash_attention_bwd_dq_reference))
    monkeypatch.setattr(k3, "flash_attention_bwd_dkv", bwd(
        "dkv", k3.flash_attention_bwd_dkv_reference))

    def fused(*args):
        plain = [_plain(a) for a in args[:-1]]
        return (bwd("bwd", k3.flash_attention_bwd_dq_reference)(*args),
                *k3.flash_attention_bwd_dkv_reference(*plain, args[-1]))
    monkeypatch.setattr(k3, "flash_attention_bwd", fused)
    return calls


@pytest.fixture
def restore_mode():
    old = fa.mode()
    yield
    fa.set_mode(old)


def test_counters_per_route(stub_kernel, restore_mode):
    q, k, v, bias = _inputs((2, 3, 16, 24, 8), "ragged")
    tq, tk, tv, tb = (_torch(a) for a in (q, k, v, bias))
    want = fa.reference_attention(tq, tk, tv, tb)
    fa.reset_counters()
    fa.attention(tq, tk, tv, tb)                       # CPU
    got = fa.attention(*map(_fake, (tq, tk, tv, tb)))  # card, key bias
    torch.testing.assert_close(got.as_subclass(torch.Tensor), want,
                               atol=F32_ATOL, rtol=0)
    fa.attention(*map(_fake, (tq, tk, tv)))            # card, no bias
    per_query = torch.zeros(2, 1, 16, 24)
    fa.attention(*map(_fake, (tq, tk, tv, per_query)))  # card, not key-wise
    fa.set_mode("off")
    with pytest.raises(ValueError, match="'off'"):    # refused on the card
        fa.attention(*map(_fake, (tq, tk, tv, tb)))
    fa.attention(tq, tk, tv, tb)                       # CPU, mode off
    assert fa.counters() == {"fused": 2, "fallback_mode": 1,
                             "fallback_platform": 1, "fallback_bias": 1}
    assert len(stub_kernel) == 2 and stub_kernel[1] is None
    assert stub_kernel[0].dtype == torch.float32
    assert stub_kernel[0].shape == (2, 24)
    assert float(stub_kernel[0].min()) == float(np.float32(-1e30))
    fa.reset_counters()
    assert not any(fa.counters().values())


def test_modes(restore_mode):
    assert fa.set_mode("off") in ("auto", "off")
    assert fa.mode() == "off"
    for bad in ("force", "on"):
        with pytest.raises(ValueError, match="mode"):
            fa.set_mode(bad)


def test_mode_starts_auto_whatever_the_environment():
    """set_mode is the only switch: no environment variable (such as the
    JAX package's DL4J_TPU_FLASH_ATTENTION) moves the port off K3."""
    code = ("from deeplearning4j_tpu_torch.ops import flash_attention as fa;"
            "print(fa.mode())")
    env = dict(os.environ, DL4J_TPU_FLASH_ATTENTION="off")
    out = subprocess.run([sys.executable, "-c", code], env=env, check=True,
                         capture_output=True, text=True,
                         cwd=os.path.dirname(os.path.dirname(__file__)))
    assert out.stdout.split()[-1] == "auto"


@pytest.mark.parametrize("bias_kind", BIASES)
def test_fused_backward_runs(stub_kernel, bias_kind):
    """The fused route differentiates through one fused K4 + K5 call
    (stubbed by the plain versions): dq, dk and dv match jax.grad of the
    JAX package's flash kernel in interpret mode within 1e-5; the key bias
    gets none."""
    import jax
    q, k, v, bias = _inputs((2, 3, 16, 24, 8), bias_kind, seed=2)
    w = np.random.default_rng(3).standard_normal((2, 3, 16, 8)).astype(
        np.float32)
    want = jax.grad(lambda *a: jnp.sum(jfa.flash_attention(
        *a, _jax(bias), interpret=True) * jnp.asarray(w)), argnums=(0, 1, 2))(
        _jax(q), _jax(k), _jax(v))
    tq, tk, tv = (_fake(_torch(a)).requires_grad_() for a in (q, k, v))
    tb = _fake(_torch(bias))
    if tb is not None:
        tb.requires_grad_()
    fa.reset_counters()
    y = fa.attention(tq, tk, tv, tb)
    (y * _torch(w)).sum().backward()
    assert fa.counters()["fused"] == 1 and fa.do_copies == 0
    assert stub_kernel[1:] == ["bwd"]
    for got, ref in zip((tq, tk, tv), want):
        np.testing.assert_allclose(got.grad.as_subclass(torch.Tensor).numpy(),
                                   _np(ref), atol=F32_ATOL, rtol=0)
    assert tb is None or tb.grad is None


def test_fused_sdpa_is_the_catalog_op():
    from deeplearning4j_tpu_torch import ops
    from deeplearning4j_tpu import ops as jops
    assert ops.lookup("attention.fused_sdpa") is fa.fused_sdpa
    q, k, v, bias = _inputs((2, 3, 16, 24, 8), "masked")
    want = _np(jops.lookup("attention.fused_sdpa")(
        _jax(q), _jax(k), _jax(v), _jax(bias), scale=0.3))
    got = fa.fused_sdpa(_torch(q), _torch(k), _torch(v), _torch(bias),
                        scale=0.3)
    np.testing.assert_allclose(got.numpy(), want, atol=F32_ATOL, rtol=0)
