"""Kernel K2, the affine-epilogue backward, and the autograd Function that
pairs it with K1.

- K2's plain version (what the wrapper runs on a CPU tensor) against the
  JAX package's real K2 Pallas kernel (``_affine_bwd_impl``) in interpret
  mode, on 7 activations x float32/bfloat16 x with and without ``scale``,
  with exact ties at z == 0 and z == 6 in the data.
- ``fused_epilogues.bn_act``/``bias_act`` differentiated by autograd (K1
  forward, K2 backward through ``AffineAct``) against ``jax.vjp`` of the
  JAX package's ``bn_act``/``bias_act`` in force mode (its custom VJP,
  K1 and K2 in interpret mode).
- The relu/relu6 tie subgradient is 0, the ``dy`` copy counter, K2's grid
  and bound arithmetic and the CUDA branch's checks. The kernel against
  its plain version on the card is in ``test_torch_affine_act.py``
  (marked ``cuda``; that file imports no JAX, so it runs on the card).

Tolerances: ``dx`` float32 atol 1e-5 (both sides compute z, act'(z), dz
and dz*scale in float32; libm and XLA differ by an ulp or two); bfloat16
one bfloat16 ulp of the larger value with a 1e-5 floor (one float32 ulp
can round the last bit either way). ``dscale``/``dshift`` per channel
within 1e-5 x (1 + sum over rows of |term|): float32 sums in another
order (the JAX kernel sums row blocks in sequence). The Function's
gradients to gamma, beta, mean and var pass through the same [C] prologue
on both sides: rtol 1e-4 with atol 1e-5 x (1 + their scale)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.ops import fused_epilogues as jfe
from deeplearning4j_tpu_torch.kernels import _build
from deeplearning4j_tpu_torch.kernels import affine_act as k1
from deeplearning4j_tpu_torch.ops import fused_epilogues as fe


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


ACTS = k1.ACTS
DTYPES = ("float32", "bfloat16")
ROWS, COLS = 32, 24  # rows a multiple of 16: the JAX kernel's row tiling


@pytest.fixture
def jax_force():
    """Route the JAX dispatch through its Pallas kernels (interpret)."""
    old = jfe.set_mode("force")
    try:
        yield
    finally:
        jfe.set_mode(old)


def _bf16_round(a):
    return torch.from_numpy(np.ascontiguousarray(a)).to(
        torch.bfloat16).float().numpy()


def _inputs(seed, dtype, with_ties=True):
    """x, dy [ROWS, COLS], scale, shift [COLS]; columns 0-3 hold exact ties:
    scale 1 (cols 0, 1) or 2 (cols 2, 3), shift 0, and x in {0, 3, 6}, so
    z is exactly 0 or 6 there on both sides."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((ROWS, COLS)) * 2.0).astype(np.float32)
    dy = rng.standard_normal((ROWS, COLS)).astype(np.float32)
    scale = (rng.random(COLS) + 0.5).astype(np.float32)
    shift = rng.standard_normal(COLS).astype(np.float32)
    if with_ties:
        scale[:4] = (1.0, 1.0, 2.0, 2.0)
        shift[:4] = 0.0
        x[0::4, :4] = 0.0
        x[1::4, :2] = 6.0
        x[1::4, 2:4] = 3.0
    if dtype == "bfloat16":
        x, dy = _bf16_round(x), _bf16_round(dy)
    return x, dy, scale, shift


def _port(a, dtype):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(torch.bfloat16) if dtype == "bfloat16" else t


def _jax(a, dtype):
    return jnp.asarray(a, jnp.bfloat16 if dtype == "bfloat16"
                       else jnp.float32)


def _assert_dx(got, want, dtype):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
        return
    big = np.maximum(np.abs(got), np.abs(want))
    ulp = np.exp2(np.floor(np.log2(np.maximum(big, 1e-30))) - 7)
    assert np.all(np.abs(got - want) <= np.maximum(ulp, 1e-5))


def _assert_sum(got, want, terms):
    """Column sums within 1e-5 x (1 + sum over rows of |term|)."""
    got = got.numpy().reshape(-1)
    want = np.asarray(want, np.float32).reshape(-1)
    tol = 1e-5 * (1.0 + np.abs(terms).sum(0))
    assert np.all(np.abs(got - want) <= tol), \
        float(np.max(np.abs(got - want) / tol))


@pytest.mark.parametrize("has_scale", [True, False])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("act", ACTS)
def test_plain_k2_matches_jax_kernel(jax_force, act, dtype, has_scale):
    x, dy, scale, shift = _inputs(3, dtype)
    s = scale if has_scale else None
    dx, ds, db = k1.affine_act_bwd(
        _port(x, dtype), None if s is None else torch.from_numpy(s),
        torch.from_numpy(shift), _port(dy, dtype), act)
    jdx, jds, jdb = jfe._affine_bwd_impl(
        _jax(x, dtype), None if s is None else jnp.asarray(s)[None],
        jnp.asarray(shift)[None], _jax(dy, dtype), act, 16, True)
    assert dx.dtype == (torch.bfloat16 if dtype == "bfloat16"
                        else torch.float32)
    _assert_dx(dx, jdx, dtype)
    # terms of the sums, in float64 from the same inputs
    x64 = x.astype(np.float64)
    z = x64 * (scale if has_scale else 1.0) + shift
    dz = dy * np.asarray(k1.act_grad(act, torch.from_numpy(z)).numpy())
    _assert_sum(db, jdb, dz)
    if has_scale:
        _assert_sum(ds, jds, dz * x64)
    else:
        assert ds is None and jds is None


@pytest.mark.parametrize("act", ["relu", "relu6"])
def test_tie_subgradient_is_zero(act):
    """At z == 0 (relu, relu6) and z == 6 (relu6) the gradient is 0, as in
    the JAX package's ``_act_grad``; ``torch.clamp``'s autograd gives 1."""
    x, dy, scale, shift = _inputs(4, "float32")
    dx, _, _ = k1.affine_act_bwd(torch.from_numpy(x),
                                 torch.from_numpy(scale),
                                 torch.from_numpy(shift),
                                 torch.from_numpy(dy), act)
    z = x[:, :4] * scale[:4] + shift[:4]
    ties = (z == 0.0) | ((z == 6.0) if act == "relu6" else False)
    assert ties.sum() >= 16
    assert np.all(dx.numpy()[:, :4][ties] == 0.0)
    if act == "relu":
        assert np.all(dx.numpy()[:, :4][z == 6.0] != 0.0)
    zt = torch.zeros(3, requires_grad=True)
    torch.clamp(zt, min=0.0).sum().backward()
    assert zt.grad.tolist() == [1.0, 1.0, 1.0]  # why K2's plain version
    assert k1.act_grad("relu", torch.zeros(3)).tolist() == [0.0, 0.0, 0.0]


def _bn_inputs(seed, dtype, shape=(2, 4, 4, COLS)):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    x = (rng.standard_normal(shape) * 2.0).astype(np.float32)
    dy = rng.standard_normal(shape).astype(np.float32)
    if dtype == "bfloat16":
        x, dy = _bf16_round(x), _bf16_round(dy)
    stats = dict(
        gamma=(rng.standard_normal(c) * 0.5 + 1.0).astype(np.float32),
        beta=rng.standard_normal(c).astype(np.float32),
        mean=(rng.standard_normal(c) * 0.3).astype(np.float32),
        var=(rng.random(c) + 0.5).astype(np.float32))
    return x, dy, stats


def _assert_vec_grad(got, want):
    got = got.numpy()
    want = np.asarray(want, np.float32)
    scale = 1.0 + np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * scale)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("act", ACTS)
def test_bn_act_backward_matches_jax_vjp(jax_force, act, dtype):
    x, dy, st = _bn_inputs(5, dtype)
    names = ("gamma", "beta", "mean", "var")

    def jfn(x, g, b, m, v):
        return jfe.bn_act(x, g, b, m, v, 1e-5, -1, act)

    _, vjp = jax.vjp(jfn, _jax(x, dtype),
                     *(jnp.asarray(st[n]) for n in names))
    jgrads = vjp(_jax(dy, dtype))
    px = _port(x, dtype).requires_grad_(True)
    pv = [torch.from_numpy(st[n]).requires_grad_(True) for n in names]
    fe.reset_counters()
    y = fe.bn_act(px, *pv, 1e-5, -1, act=act)
    y.backward(_port(dy, dtype))
    assert fe.counters()["fallback_platform"] == 1 and fe.dy_copies == 0
    _assert_dx(px.grad, jgrads[0], dtype)
    for got, want in zip(pv, jgrads[1:]):
        _assert_vec_grad(got.grad, want)


@pytest.mark.parametrize("act", ["identity", "relu", "gelu"])
def test_bias_act_backward_matches_jax_vjp(jax_force, act):
    x, dy, st = _bn_inputs(6, "float32")
    _, vjp = jax.vjp(lambda x, b: jfe.bias_act(x, b, act), jnp.asarray(x),
                     jnp.asarray(st["beta"]))
    jdx, jdb = vjp(jnp.asarray(dy))
    px = torch.from_numpy(x).requires_grad_(True)
    pb = torch.from_numpy(st["beta"]).requires_grad_(True)
    fe.bias_act(px, pb, act).backward(torch.from_numpy(dy))
    _assert_dx(px.grad, jdx, "float32")
    _assert_vec_grad(pb.grad, jdb)


def test_function_saves_only_its_inputs_and_recomputes_z():
    x, dy, st = _bn_inputs(7, "float32")
    px = torch.from_numpy(x).requires_grad_(True)
    s = torch.from_numpy(st["gamma"]).requires_grad_(True)
    b = torch.from_numpy(st["beta"]).requires_grad_(True)
    x2 = px.reshape(-1, COLS)
    y = fe.AffineAct.apply(x2, s, b, "tanh")
    saved = y.grad_fn.saved_tensors
    assert len(saved) == 3 and torch.equal(saved[0], x2.detach())
    y.backward(torch.from_numpy(dy).reshape(-1, COLS))
    dx, ds, db = k1.affine_act_bwd_reference(
        x2.detach(), s.detach(), b.detach(),
        torch.from_numpy(dy).reshape(-1, COLS), "tanh")
    assert torch.equal(px.grad.reshape(-1, COLS), dx)
    assert torch.equal(s.grad, ds) and torch.equal(b.grad, db)


def test_non_contiguous_dy_is_copied_once_and_counted():
    x, dy, st = _bn_inputs(8, "float32", shape=(2, 3, 5, COLS))
    names = ("gamma", "beta", "mean", "var")

    def grads(expanded):
        px = torch.from_numpy(x).requires_grad_(True)
        y = fe.bn_act(px, *(torch.from_numpy(st[n]) for n in names),
                      act="relu")
        if expanded:  # sum's cotangent reaches the Function as a stride-0
            y.sum().backward()  # view
        else:
            y.backward(torch.ones_like(y))
        return px.grad

    fe.reset_counters()
    plain = grads(False)
    assert fe.dy_copies == 0
    viewed = grads(True)
    assert fe.dy_copies == 1
    assert torch.equal(plain, viewed)
    fe.reset_counters()
    assert fe.dy_copies == 0


def test_nchw_on_cpu_goes_through_the_function():
    """Channels-first on the CPU: the Function over a channels-last copy,
    with the same gradients as the channels-last call."""
    x, dy, st = _bn_inputs(9, "float32")
    names = ("gamma", "beta", "mean", "var")
    out = []
    for nchw in (False, True):
        px = torch.from_numpy(x).requires_grad_(True)
        inp = px.permute(0, 3, 1, 2) if nchw else px
        y = fe.bn_act(inp, *(torch.from_numpy(st[n]) for n in names),
                      axis=1 if nchw else -1, act="relu6")
        (y.permute(0, 2, 3, 1) if nchw else y).backward(
            torch.from_numpy(dy))
        out.append(px.grad)
    torch.testing.assert_close(out[0], out[1], rtol=0, atol=0)


@pytest.mark.parametrize("rows,cols,width,want_tx", [
    (401408, 64, 4, 16), (100352, 256, 4, 32), (1568, 2048, 4, 32),
    (49, 2048, 4, 32), (401408, 64, 8, 8), (7, 3, 1, 4), (1000, 1, 1, 1)])
def test_bwd_grid_adapts_to_both_extremes(rows, cols, width, want_tx):
    sms = 132
    tx, groups = k1.bwd_grid(rows, cols, width, sms)
    assert tx == want_tx
    ty = k1.BWD_THREADS // tx
    tiles = -(-cols // (tx * width))
    assert tx * width * tiles >= cols  # every column covered
    assert 1 <= groups <= 65535
    # many rows: enough blocks for 8 per SM; few rows: no idle groups
    assert groups == min(-(-rows // ty), max(1, (sms * 8) // tiles))
    assert k1.bwd_grid(rows, cols, width, sms) == (tx, groups)


def test_resnet50_step_bound_arithmetic():
    """One batch-32 float32 training step runs K2 over 338,788,352
    elements (the 53 BN outputs of ResNet-50 at 224x224): x and dy read,
    dx written, 12 bytes each, 1.21 ms at 3.35 TB/s."""
    elems = 32 * 10_587_136
    assert elems == 338_788_352
    assert k1.bytes_moved_bwd(elems // 64, 64, 4) == 12 * elems + 16 * 64
    assert abs(k1.bound_ms_bwd(elems // 64, 64, 4, "relu") - 1.2136) < 1e-3
    assert k1.bytes_moved_bwd(10, 8, 2, has_scale=False) == 480 + 64
    assert k1.flops_bwd(10, 8, "relu") == 80 * 8
    assert k1.flops_bwd(10, 8, "identity", has_scale=False) == 80 * 3


def test_build_description_covers_both_kernels_and_the_header():
    assert {"affine_act", "affine_act_bwd"} <= set(_build.sources())
    assert (_build.CSRC / "epilogue_act.cuh").is_file()
    p = _build.library_path("affine_act_bwd")
    assert p.name.startswith("libaffine_act_bwd-") and p.suffix == ".so"
    assert p != _build.library_path("affine_act")


class _FakeCuda(torch.Tensor):
    """A CPU tensor that reports a CUDA device."""

    @property
    def device(self):
        return torch.device("cuda")


def _fake(t):
    return t.as_subclass(_FakeCuda)


@pytest.fixture
def plain_forbidden(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("the plain version was reached")
    monkeypatch.setattr(k1, "affine_act_bwd_reference", boom)
    monkeypatch.setattr(_build, "nvcc", lambda: (_ for _ in ()).throw(
        RuntimeError("nvcc not found")))
    monkeypatch.setattr(_build, "_libs", {})


def test_cuda_tensor_never_reaches_k2s_plain_version(plain_forbidden):
    x, s, b = torch.ones(4, 8), torch.ones(8), torch.zeros(8)
    before = k1.bwd_launches
    with pytest.raises(RuntimeError, match="nvcc"):
        k1.affine_act_bwd(_fake(x), _fake(s), _fake(b), _fake(x), "relu")
    assert k1.bwd_launches == before
    with pytest.raises(ValueError, match="dy must be"):
        k1.affine_act_bwd(_fake(x), _fake(s), _fake(b),
                          _fake(torch.ones(8, 4).t()), "relu")
    with pytest.raises(ValueError, match="dy must be"):
        k1.affine_act_bwd(_fake(x), _fake(s), _fake(b),
                          _fake(x.double()), "relu")
    with pytest.raises(ValueError, match="not in"):
        k1.affine_act_bwd(_fake(x), _fake(s), _fake(b), _fake(x), "swish")
