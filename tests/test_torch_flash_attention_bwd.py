"""K4's and K5's plain versions and the fused route's autograd node
against the JAX package, on the CPU (the kernels themselves on the card:
``test_torch_flash_attn_kernel.py``).

- The plain version ``kernels.flash_attention.flash_attention_bwd_reference``
  against the JAX package's backward Pallas kernels in interpret mode
  (``_bwd_impl(..., interpret=True)``), both fed the same forward: the JAX
  kernel's ``o``, and its ``m`` and ``l`` from ``_fwd_impl(...,
  interpret=True)``, sliced to one lane (the port keeps one value per
  row). Shapes that tile, with no bias, a ragged key bias and a fully
  masked row. float32 within 1e-5 absolute (the JAX package's
  kernel-vs-reference contract; the sums run in other orders); bfloat16
  within 2 ulps of bfloat16 (``ulp_error``), as K3's forward: ds and p
  are rounded to bfloat16 at the same points on both sides, so only a
  rounding that f32 sum-order noise flips can differ.
- Ragged lengths (T = 77, which the JAX kernels do not take): against
  autograd of the port's own ``reference_attention``, within 1e-5.
- The autograd node ``ops.flash_attention._FlashAttention``: on CPU
  tensors its wrappers take the plain versions, so ``gradcheck`` runs on it
  in float64; the key bias gets no gradient; and mode ``off`` is refused
  for (stand-in) CUDA tensors. The node's gradients against ``jax.grad``
  of the JAX flash kernel: ``test_torch_flash_attention.py::
  test_fused_backward_runs``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.ops import flash_attention as jfa
from deeplearning4j_tpu_torch.kernels import flash_attention as k3
from deeplearning4j_tpu_torch.ops import flash_attention as fa

SHAPES = [(2, 3, 16, 16, 8), (1, 2, 32, 24, 16), (2, 2, 24, 24, 64)]
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
    """q, k, v, do and the [B, Tk] key bias (or None) as float32 numpy."""
    B, H, Tq, Tk, d = shape
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, Tq, d)).astype(np.float32)
    k = rng.standard_normal((B, H, Tk, d)).astype(np.float32)
    v = rng.standard_normal((B, H, Tk, d)).astype(np.float32)
    do = rng.standard_normal((B, H, Tq, d)).astype(np.float32)
    if bias_kind == "none":
        return q, k, v, do, None
    lengths = rng.integers(1, Tk + 1, B)
    kb = np.where(np.arange(Tk)[None, :] < lengths[:, None], 0.0,
                  NEG).astype(np.float32)
    if bias_kind == "masked":
        kb[0] = NEG  # every key of batch row 0 masked: uniform rows
    return q, k, v, do, kb


def _jax_backward(q, k, v, do, kb, dtype):
    """The JAX package's forward and backward kernels in interpret mode:
    ``(o, m, l, dq, dk, dv)`` with m and l one lane wide."""
    B, H, Tq, d = q.shape
    Tk = k.shape[2]
    scale = 1.0 / float(np.sqrt(d))
    q3, k3_, v3, do3 = (jnp.asarray(a).astype(dtype).reshape(B * H, -1, d)
                        for a in (q, k, v, do))
    jkb = None if kb is None else jnp.asarray(kb)
    bq, bk = jfa.pick_block(Tq), jfa.pick_block(Tk)
    o, m, l = jfa._fwd_impl(q3, k3_, v3, jkb, scale, H, bq, bk, True)
    di = jnp.sum(o.astype(jnp.float32) * do3.astype(jnp.float32), axis=-1,
                 keepdims=True)
    dq, dk, dv = jfa._bwd_impl(q3, k3_, v3, jkb, m, l,
                               jnp.broadcast_to(di, m.shape), do3, scale, H,
                               bq, bk, True)
    shape = lambda t, T: np.asarray(t.astype(jnp.float32)).reshape(  # noqa
        B, H, T, d)
    return (shape(o, Tq), np.asarray(m)[..., 0], np.asarray(l)[..., 0],
            shape(dq, Tq), shape(dk, Tk), shape(dv, Tk))


@pytest.mark.parametrize("bias_kind", BIASES)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_float32_matches_jax_kernels(shape, bias_kind):
    q, k, v, do, kb = _inputs(shape, bias_kind)
    o, m, l, *want = _jax_backward(q, k, v, do, kb, jnp.float32)
    t = lambda a: None if a is None else torch.from_numpy(np.array(a))  # noqa
    got = k3.flash_attention_bwd_reference(
        t(q), t(k), t(v), t(kb), t(o), t(m), t(l), t(do))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w, atol=F32_ATOL, rtol=0)
    if bias_kind == "masked":
        # batch row 0 attends uniformly: dv of each key is the mean of do
        Tk = shape[3]
        np.testing.assert_allclose(
            got[2][0].numpy(), np.broadcast_to(
                do[0].sum(axis=1, keepdims=True) / Tk, got[2][0].shape),
            atol=F32_ATOL)


@pytest.mark.parametrize("bias_kind", BIASES)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_fused_wrapper_on_cpu_matches_jax_kernels(shape, bias_kind):
    """``flash_attention_bwd`` (the fused K4 + K5 entry) takes the plain
    versions on CPU tensors, launches nothing, and gives the JAX package's
    dq, dk and dv (its kernels in interpret mode) within 1e-5."""
    q, k, v, do, kb = _inputs(shape, bias_kind, seed=6)
    o, m, l, *want = _jax_backward(q, k, v, do, kb, jnp.float32)
    t = lambda a: None if a is None else torch.from_numpy(np.array(a))  # noqa
    di = k3.attention_di(t(o), t(do))
    before = (k3.launches_bwd, k3.launches_dq, k3.launches_dkv)
    got = k3.flash_attention_bwd(t(q), t(k), t(v), t(kb), t(m), t(l), di,
                                 t(do))
    assert (k3.launches_bwd, k3.launches_dq, k3.launches_dkv) == before
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w, atol=F32_ATOL, rtol=0)


@pytest.mark.parametrize("bias_kind", BIASES)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_bfloat16_matches_jax_kernels(shape, bias_kind):
    q, k, v, do, kb = _inputs(shape, bias_kind, seed=1)
    o, m, l, *want = _jax_backward(q, k, v, do, kb, jnp.bfloat16)
    b = lambda a: torch.from_numpy(a).to(torch.bfloat16)  # noqa: E731
    got = k3.flash_attention_bwd_reference(
        b(q), b(k), b(v), None if kb is None else torch.from_numpy(kb),
        b(o), torch.from_numpy(m), torch.from_numpy(l), b(do))
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        assert k3.ulp_error(g, b(w)) <= ULP_TOL


@pytest.mark.parametrize("shape", [(2, 2, 77, 77, 16), (1, 3, 77, 40, 32)],
                         ids=str)
def test_ragged_lengths_match_autograd_of_the_reference(shape):
    q, k, v, do, kb = _inputs(shape, "masked", seed=2)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    bias = torch.from_numpy(kb)[:, None, None, :]
    o = fa.reference_attention(tq, tk, tv, bias)
    want = torch.autograd.grad(o, (tq, tk, tv), torch.from_numpy(do))
    ro, m, l = k3.flash_attention_fwd_reference(
        *(t.detach() for t in (tq, tk, tv)), torch.from_numpy(kb))
    got = k3.flash_attention_bwd_reference(
        tq.detach(), tk.detach(), tv.detach(), torch.from_numpy(kb), ro, m,
        l, torch.from_numpy(do))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=F32_ATOL, rtol=0)


def test_wrappers_split_the_plain_version():
    """The CPU route of the backward's wrappers (fused, dq-only, dk/dv-only)
    is the plain version."""
    q, k, v, do, kb = (None if a is None else torch.from_numpy(a)
                       for a in _inputs((2, 3, 16, 24, 8), "ragged", seed=3))
    o, m, l = k3.flash_attention_fwd_reference(q, k, v, kb)
    di = k3.attention_di(o, do)
    assert di.shape == (6, 16) and di.is_contiguous()
    before = (k3.launches_bwd, k3.launches_dq, k3.launches_dkv)
    dq = k3.flash_attention_bwd_dq(q, k, v, kb, m, l, di, do)
    dk, dv = k3.flash_attention_bwd_dkv(q, k, v, kb, m, l, di, do)
    fused = k3.flash_attention_bwd(q, k, v, kb, m, l, di, do)
    # no launch on CPU
    assert (k3.launches_bwd, k3.launches_dq, k3.launches_dkv) == before
    for g, f, w in zip((dq, dk, dv), fused, k3.flash_attention_bwd_reference(
            q, k, v, kb, o, m, l, do)):
        assert torch.equal(g, w) and torch.equal(f, w)


def test_autograd_node_gradcheck_float64():
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2, 5, 4)))
               .requires_grad_() for _ in range(3))
    kb = torch.from_numpy(np.where(np.arange(5) < 3, 0.0, NEG)[None])
    assert torch.autograd.gradcheck(
        lambda q, k, v: fa._FlashAttention.apply(q, k, v, kb, 0.7),
        (q, k, v))


def test_the_key_bias_gets_no_gradient():
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 2, 6, 4))
                                .astype(np.float32)).requires_grad_()
               for _ in range(3))
    kb = torch.zeros(2, 6, requires_grad=True)
    fa._FlashAttention.apply(q, k, v, kb, None).sum().backward()
    assert kb.grad is None
    assert all(t.grad is not None and torch.isfinite(t.grad).all()
               for t in (q, k, v))


class _FakeCuda(torch.Tensor):
    """A CPU tensor that reports a CUDA device."""

    @property
    def device(self):
        return torch.device("cuda")


def test_mode_off_is_refused_on_the_card():
    q = torch.ones(1, 2, 4, 8).as_subclass(_FakeCuda)
    old = fa.set_mode("off")
    try:
        fa.reset_counters()
        with pytest.raises(ValueError, match="mode 'off'"):
            fa.attention(q, q, q)
        fa.attention(torch.ones(1, 2, 4, 8), torch.ones(1, 2, 4, 8),
                     torch.ones(1, 2, 4, 8))
        assert fa.counters()["fallback_mode"] == 1
        assert fa.counters()["fused"] == 0
    finally:
        fa.set_mode(old)
