"""Kernels K6 and K7 (the LayerNorm + activation epilogue and its
backward): their plain versions against the JAX package's real Pallas
kernels in interpret mode (``_ln_fwd_impl`` / ``_ln_bwd_impl`` called
directly with ``interpret=True``) and against ``nnops.layer_norm`` plus
the activation; ``LayerNormAct`` under ``gradcheck`` in float64; the
dispatch decisions; the wrapper's checks, bounds and tolerance; and,
marked ``cuda`` (skipped without a card), K6 and K7 themselves against
their plain versions on the card.

The JAX package is imported inside fixtures only, so ``python3 -m pytest
--noconftest tests/test_torch_layer_norm_act.py -m cuda`` runs on a
machine without JAX.

Tolerances against the JAX kernels: the reference's own
(``tests/test_fused_epilogues.py::test_layer_norm_act_epilogue_parity``):
float32 1e-5 for y, mu and rstd and 1e-4 for dx, dgamma and dbeta;
bfloat16 2e-2 and 1e-1 (y and dx rounded to bfloat16 once, from float32
values that may differ in the last float32 bits). On the card the kernels
are held to ``layer_norm_act.tolerance`` (see there), and a second run
must be bit-equal."""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.kernels import _build
from deeplearning4j_tpu_torch.kernels import layer_norm_act as k6
from deeplearning4j_tpu_torch.ops import fused_epilogues as fe
from deeplearning4j_tpu_torch.ops import nnops

ACTS = k6.ACTS
TOLS = {"float32": (1e-5, 1e-4), "bfloat16": (2e-2, 1e-1)}


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    """The suite runs in parallel workers: keep this module's torch CPU
    work to one thread, and restore the setting after it. One, not two:
    the first ``torch.tanh`` a process runs on more than one intra-op
    thread was seen to return values up to 8.4e-5 off (1 process in 16 to
    24 on the CPU, later calls exact; none in 48 on one thread), which
    failed ``test_plain_forward_matches_the_jax_kernel[tanh-float32]``
    whenever this module was the first of its worker to call it. One
    thread keeps the test away from that error; its cause is not known
    (ROADMAP Queue 3, open fault 1)."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(old)


@pytest.fixture(scope="module")
def jax_ln():
    """The JAX package's LayerNorm-epilogue kernels (interpret mode) and
    jax.numpy, imported here so the card tests need no JAX."""
    import jax.numpy as jnp
    from deeplearning4j_tpu.ops import fused_epilogues as jfe
    return jfe, jnp


def _bf16_round(a):
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


def _inputs(seed, dtype, rows=32, cols=128, offset=0.0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((rows, cols)) * 2.0 + offset).astype(np.float32)
    g = (rng.standard_normal(cols) * 0.5 + 1.0).astype(np.float32)
    b = rng.standard_normal(cols).astype(np.float32)
    dy = rng.standard_normal((rows, cols)).astype(np.float32)
    if dtype == "bfloat16":
        x, g, b, dy = map(_bf16_round, (x, g, b, dy))
    return x, g, b, dy


def _port(a, dtype="float32"):
    t = torch.from_numpy(np.array(a))
    return t.to(torch.bfloat16) if dtype == "bfloat16" else t


def _jax(jnp, a, dtype="float32"):
    return jnp.asarray(a, jnp.bfloat16 if dtype == "bfloat16"
                       else jnp.float32)


def _np(t):
    return np.asarray(t.float().numpy() if isinstance(t, torch.Tensor)
                      else np.asarray(t, np.float32))


def _within(err, bound) -> bool:
    """Every element of ``err`` within ``bound`` (NaN fails)."""
    return bool((err <= bound).all())


def _close(got, want, tol, what):
    got, want = _np(got), np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol, err_msg=what)


def _jax_fwd(jfe, jnp, x, g, b, eps, act, dtype):
    rows, cols = x.shape
    br = jfe.row_block(rows, jfe._row_mult(jnp.bfloat16 if dtype ==
                                           "bfloat16" else jnp.float32))
    return jfe._ln_fwd_impl(_jax(jnp, x, dtype), _jax(jnp, g[None], dtype),
                            _jax(jnp, b[None], dtype), eps, act, br, True), br


# ------------------------------------------- plain versions against JAX

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ACTS)
def test_plain_forward_matches_the_jax_kernel(jax_ln, act, dtype):
    jfe, jnp = jax_ln
    x, g, b, _ = _inputs(1, dtype)
    (jy, jmu, jrs), _ = _jax_fwd(jfe, jnp, x, g, b, 1e-5, act, dtype)
    y, mu, rstd = k6.layer_norm_act_reference(
        _port(x, dtype), _port(g), _port(b), 1e-5, act)
    ftol = TOLS[dtype][0]
    assert y.dtype == (torch.bfloat16 if dtype == "bfloat16"
                       else torch.float32)
    assert mu.dtype == rstd.dtype == torch.float32
    _close(y, jy, ftol, "y")
    # the TPU kernel replicates each row's statistic over 128 lanes
    _close(mu, np.asarray(jmu)[:, 0], 1e-5, "mu")
    _close(rstd, np.asarray(jrs)[:, 0], 1e-5, "rstd")
    assert (np.asarray(jmu) == np.asarray(jmu)[:, :1]).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ACTS)
def test_plain_backward_matches_the_jax_kernel(jax_ln, act, dtype):
    jfe, jnp = jax_ln
    x, g, b, dy = _inputs(2, dtype)
    (_, jmu, jrs), br = _jax_fwd(jfe, jnp, x, g, b, 1e-5, act, dtype)
    jdx, jdg, jdb = jfe._ln_bwd_impl(
        _jax(jnp, x, dtype), _jax(jnp, g[None], dtype),
        _jax(jnp, b[None], dtype), jmu, jrs, _jax(jnp, dy, dtype), 1e-5,
        act, br, True)
    mu = torch.from_numpy(np.asarray(jmu)[:, 0].copy())
    rstd = torch.from_numpy(np.asarray(jrs)[:, 0].copy())
    dx, dg, db = k6.layer_norm_act_bwd_reference(
        _port(x, dtype), _port(g), _port(b), mu, rstd, _port(dy, dtype), act)
    gtol = TOLS[dtype][1]
    assert dx.dtype == _port(x, dtype).dtype
    assert dg.dtype == db.dtype == torch.float32
    _close(dx, jdx, gtol, "dx")
    _close(dg, np.asarray(jdg)[0], gtol, "dgamma")
    _close(db, np.asarray(jdb)[0], gtol, "dbeta")


@pytest.mark.parametrize("act", ACTS)
def test_plain_version_is_layer_norm_then_the_activation(jax_ln, act):
    """K6's plain version against the port's ``nnops.layer_norm`` plus the
    catalog activation, and against the JAX package's (the fallback route
    of its ``layer_norm_act``), at 1e-5."""
    jfe, jnp = jax_ln
    from deeplearning4j_tpu.ops import nnops as jnn
    x, g, b, _ = _inputs(3, "float32", rows=6, cols=40, offset=3.0)
    x3 = x.reshape(2, 3, 40)
    y, _, _ = k6.layer_norm_act_reference(_port(x), _port(g), _port(b),
                                          1e-5, act)
    port = fe.reference_act(act)(nnops.layer_norm(
        _port(x3), _port(g), _port(b), 1e-5, axis=-1))
    want = jfe.reference_act(act)(jnn.layer_norm(
        jnp.asarray(x3), jnp.asarray(g), jnp.asarray(b), 1e-5, axis=-1))
    _close(y.reshape(2, 3, 40), port, 1e-5, "port nnops")
    _close(y.reshape(2, 3, 40), want, 1e-5, "jax nnops")


def test_layer_norm_op_matches_jax_on_another_axis(jax_ln):
    _, jnp = jax_ln
    from deeplearning4j_tpu.ops import nnops as jnn
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 5, 4)).astype(np.float32)
    g, b = rng.standard_normal((2, 5, 1)).astype(np.float32)
    got = nnops.layer_norm(_port(x), _port(g), _port(b), 1e-3, axis=1)
    want = jnn.layer_norm(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b),
                          1e-3, axis=1)
    _close(got, want, 1e-5, "layer_norm axis=1")


# ---------------------------------------------------- the Function, dispatch

@pytest.mark.parametrize("act", ["identity", "gelu", "geluexact", "sigmoid",
                                 "tanh", "elu"])
def test_layer_norm_act_gradcheck_float64(act):
    """LayerNormAct (K6/K7's plain versions in float64), and the
    ``fallback_act`` route (elu after the normalization), under
    ``torch.autograd.gradcheck``, gamma and beta included."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((2, 3, 10)) * 2.0 + 1.0)
    g = torch.from_numpy(rng.standard_normal(10) * 0.5 + 1.0)
    b = torch.from_numpy(rng.standard_normal(10))
    for t in (x, g, b):
        t.requires_grad_(True)
    assert torch.autograd.gradcheck(
        lambda x, g, b: fe.layer_norm_act(x, g, b, 1e-5, act=act), (x, g, b))


def test_backward_casts_the_parameter_gradients_to_their_dtypes():
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.standard_normal((4, 16)).astype(np.float32))
    x = x.to(torch.bfloat16).requires_grad_(True)
    g = torch.ones(16, dtype=torch.bfloat16, requires_grad=True)
    b = torch.zeros(16, dtype=torch.float32, requires_grad=True)
    y = fe.layer_norm_act(x, g, b, 1e-5, act="gelu")
    assert y.dtype == torch.bfloat16
    y.float().sum().backward()
    assert x.grad.dtype == torch.bfloat16
    assert g.grad.dtype == torch.bfloat16 and b.grad.dtype == torch.float32


def test_dispatch_counts_one_decision_per_call():
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((2, 5, 12)).astype(np.float32))
    g, b = torch.rand(12) + 0.5, torch.randn(12)
    fe.reset_counters()
    y = fe.layer_norm_act(x, g, b, 1e-5, act="gelu_exact")
    assert fe.counters() == {"fused": 0, "fallback_platform": 1,
                             "fallback_act": 0, "fallback_dtype": 0}
    want = fe.reference_act("gelu_exact")(nnops.layer_norm(x, g, b, 1e-5))
    torch.testing.assert_close(y, want, atol=1e-5, rtol=1e-5)
    y = fe.layer_norm_act(x, g, b, 1e-5, act="elu")
    assert fe.counters() == {"fused": 0, "fallback_platform": 1,
                             "fallback_act": 1, "fallback_dtype": 0}
    torch.testing.assert_close(
        y, torch.nn.functional.elu(nnops.layer_norm(x, g, b, 1e-5)),
        atol=1e-5, rtol=1e-5)
    # the backward copies a non-contiguous dy once, and counts it
    xt = x.reshape(10, 12).clone().requires_grad_(True)
    out = fe.layer_norm_act(xt, g, b, 1e-5, act="tanh")
    out.backward(torch.ones(12, 10).t())
    assert fe.dy_copies == 1
    fe.reset_counters()
    assert fe.dy_copies == 0


def test_catalog_ops_are_registered():
    from deeplearning4j_tpu_torch import ops
    assert ops.get("epilogue.layer_norm_act").category == "normalization"
    assert ops.get("epilogue.bias_act").category == "activation"
    assert ops.get("layer_norm").category == "normalization"
    x = torch.randn(3, 8)
    torch.testing.assert_close(
        ops.lookup("epilogue.bias_act")(x, torch.ones(8), act="gelu_exact"),
        torch.nn.functional.gelu(x + 1.0), atol=1e-6, rtol=1e-6)


# ------------------------------------------------ wrapper, bounds, tolerance

def test_row_config_and_the_width_limit():
    assert k6.row_config(37) == (8, 1)
    assert k6.row_config(768) == (24, 1)
    assert k6.row_config(1024) == (32, 1)
    assert k6.row_config(1025) == (32, 4)
    assert k6.row_config(k6.MAX_COLS) == (32, 8)
    with pytest.raises(ValueError, match=f"limit of {k6.MAX_COLS}"):
        k6.row_config(k6.MAX_COLS + 1)
    # K7's layout: a function of the shape and the SM count only
    lay = k6.bwd_layout(4096, 768, 132)
    assert (lay["nv"], lay["wpr"], lay["groups"], lay["stages"], lay["ctas"],
            lay["rows_per_cta"]) == (24, 1, 8, 3, 132, 32)
    lay = k6.bwd_layout(5, 37, 132)
    assert (lay["nv"], lay["wpr"], lay["ctas"]) == (8, 1, 1)
    lay = k6.bwd_layout(33, 4096, 132)
    assert (lay["nv"], lay["wpr"], lay["groups"], lay["ctas"]) == (
        32, 4, 2, 17)


#: chip_smoke.py's K6/K7 shapes, and the widest rows K7 takes
LN_SHAPES = ((4096, 768), (256, 768), (128, 768), (77, 768), (4096, 1024),
             (33, 4096), (5, 37))
LAYOUT_SHAPES = LN_SHAPES + ((1, k6.MAX_COLS), (4096, k6.MAX_COLS),
                             (100003, 64), (1, 1), (3000, 1025))
SM_COUNTS = (132, 114, 7, 1, 528)


def _rows_of(lay, rows):
    """The rows each (CTA, group) of K7's layout walks, in the kernel's
    order (``layer_norm_act_bwd_kernel``: CTA b owns rows [b * rpc, ...),
    its groups take them in turn)."""
    rpc, groups = lay["rows_per_cta"], lay["groups"]
    for b in range(lay["ctas"]):
        end = min(rows, (b + 1) * rpc)
        for grp in range(groups):
            yield list(range(b * rpc + grp, end, groups))


@pytest.mark.parametrize("rows,cols", LAYOUT_SHAPES)
@pytest.mark.parametrize("sms", SM_COUNTS)
def test_bwd_layout_covers_every_row_once(rows, cols, sms):
    lay = k6.bwd_layout(rows, cols, sms)
    seen = [r for walk in _rows_of(lay, rows) for r in walk]
    assert sorted(seen) == list(range(rows))


def test_bwd_layout_is_a_function_of_the_shape_and_sm_count():
    import inspect
    assert list(inspect.signature(k6.bwd_layout).parameters) == [
        "rows", "cols", "sms"]
    for rows, cols in LAYOUT_SHAPES:
        for sms in SM_COUNTS:
            assert k6.bwd_layout(rows, cols, sms) == k6.bwd_layout(
                rows, cols, sms)


@pytest.mark.parametrize("rows,cols", LAYOUT_SHAPES)
@pytest.mark.parametrize("sms", SM_COUNTS)
def test_bwd_layout_within_grid_and_smem_limits(rows, cols, sms):
    """The grid fits the card at once (the launch is cooperative), and
    each CTA's shared memory fits its share of an SM in every dtype."""
    lay = k6.bwd_layout(rows, cols, sms)
    ctas = lay["ctas"]
    assert 1 <= ctas <= sms and ctas <= 65535
    assert 2 <= lay["stages"] <= k6.BWD_MAX_STAGES
    assert lay["threads"] == lay["groups"] * 32 * lay["wpr"] == 256
    assert cols <= 32 * lay["wpr"] * lay["nv"]
    budget = k6.SMEM_PER_SM - k6.BWD_SMEM_SLACK
    for itemsize in (4, 2):
        for staged in (True, False):
            assert k6.bwd_smem_bytes(cols, itemsize, lay["threads"],
                                     lay["groups"], lay["stages"],
                                     staged) <= budget
    # each thread's row slots hold whole 16-byte vectors
    assert lay["nv"] % 8 == 0


def test_bounds_from_the_issue_arithmetic():
    """(4096, 768) float32, BERT-base at batch 32 x 128: K6 moves 25.2 MB
    (7.5 us at 3.35 TB/s), K7 37.8 MB (11.3 us)."""
    assert k6.bytes_moved(4096, 768, 4) == 2 * 4096 * 768 * 4 + 2 * 768 * 4 \
        + 2 * 4096 * 4
    assert abs(k6.bound_ms(4096, 768, 4, "identity") - 0.00752) < 1e-4
    assert abs(k6.bytes_moved_bwd(4096, 768, 4) / 1e6 - 37.8) < 0.05
    assert abs(k6.bound_ms_bwd(4096, 768, 4, "identity") - 0.01128) < 1e-4
    assert k6.bound_ms(4096, 768, 2, "relu") < k6.bound_ms(4096, 768, 4,
                                                           "relu")


@pytest.mark.parametrize("cols", [768, 37])
def test_tolerance_rejects_a_one_pass_variance(cols):
    """On rows far from zero (``1000 + N(0, 1)``) the float32 plain version
    is within its own bound, and a one-pass variance misses it by far."""
    x, g, b, _ = _inputs(8, "float32", rows=64, cols=cols, offset=1000.0)
    x = (x - 1000.0) / 2.0 + 1000.0
    for act in ACTS:
        y, mu, rstd = k6.layer_norm_act_reference(
            _port(x), _port(g), _port(b), 1e-12, act)
        bound = k6.y_bound(_port(x), _port(g), _port(b), mu, rstd, y)
        y1 = k6.one_pass_reference(_port(x), _port(g), _port(b), 1e-12, act)
        assert not _within((y1 - y).abs(), bound), act
        assert float(((y1 - y).abs() / bound).max()) > 10.0, act


def test_build_describes_k6_and_k7():
    for name in ("layer_norm_act", "layer_norm_act_bwd"):
        assert name in _build.sources()
        path = _build.library_path(name)
        assert path.parent == _build.BUILD_DIR
        assert path.name.startswith(f"lib{name}-") and path.suffix == ".so"
        assert "epilogue_act.cuh" in _build.sources()[name].read_text()


class _FakeCuda(torch.Tensor):
    """A CPU tensor that reports a CUDA device: it walks the wrappers'
    CUDA branch on a machine without a card."""

    @property
    def device(self):
        return torch.device("cuda")


def _fake(t):
    return t.as_subclass(_FakeCuda)


@pytest.fixture
def plain_forbidden(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("the plain version was reached")
    monkeypatch.setattr(k6, "layer_norm_act_reference", boom)
    monkeypatch.setattr(k6, "layer_norm_act_bwd_reference", boom)
    monkeypatch.setattr(_build, "nvcc", lambda: (_ for _ in ()).throw(
        RuntimeError("nvcc not found")))
    monkeypatch.setattr(_build, "_libs", {})
    k6._kernel.cache_clear()
    k6._kernel_bwd.cache_clear()
    yield
    k6._kernel.cache_clear()
    k6._kernel_bwd.cache_clear()


def test_cuda_tensor_never_reaches_the_plain_versions(plain_forbidden):
    x, g, b = torch.ones(4, 8), torch.ones(8), torch.zeros(8)
    r = torch.ones(4)
    with pytest.raises(RuntimeError, match="nvcc"):
        k6.layer_norm_act(_fake(x), _fake(g), _fake(b), 1e-5, "relu")
    with pytest.raises(RuntimeError, match="nvcc"):
        k6.layer_norm_act_bwd(_fake(x), _fake(g), _fake(b), _fake(r),
                              _fake(r), _fake(x), "relu")
    fe.reset_counters()
    with pytest.raises(RuntimeError, match="nvcc"):
        fe.layer_norm_act(_fake(torch.ones(2, 2, 8)), _fake(g), _fake(b),
                          act="gelu")
    assert fe.counters()["fused"] == 1
    with pytest.raises(ValueError, match="not supported"):
        k6.layer_norm_act(torch.ones(4, 8, device="meta"), g, b, 1e-5)


def test_cuda_wrappers_check_before_launch(plain_forbidden):
    x, g, b = torch.ones(4, 8), torch.ones(8), torch.zeros(8)
    r = torch.ones(4)
    with pytest.raises(TypeError, match="dtype"):
        k6.layer_norm_act(_fake(x.double()), _fake(g), _fake(b), 1e-5)
    with pytest.raises(ValueError, match="contiguous"):
        k6.layer_norm_act(_fake(torch.ones(8, 4).t()), _fake(g), _fake(b),
                          1e-5)
    with pytest.raises(ValueError, match="gamma"):
        k6.layer_norm_act(_fake(x), _fake(torch.ones(7)), _fake(b), 1e-5)
    with pytest.raises(ValueError, match="beta"):
        k6.layer_norm_act(_fake(x), _fake(g), _fake(b.half()), 1e-5)
    with pytest.raises(ValueError, match="not in"):
        k6.layer_norm_act(_fake(x), _fake(g), _fake(b), 1e-5, "swish")
    wide = torch.ones(2, k6.MAX_COLS + 1)
    with pytest.raises(ValueError, match=f"limit of {k6.MAX_COLS}"):
        k6.layer_norm_act(_fake(wide), _fake(torch.ones(k6.MAX_COLS + 1)),
                          _fake(torch.ones(k6.MAX_COLS + 1)), 1e-5)
    with pytest.raises(ValueError, match="dy must be"):
        k6.layer_norm_act_bwd(_fake(x), _fake(g), _fake(b), _fake(r),
                              _fake(r), _fake(x.t().contiguous().t()))
    with pytest.raises(ValueError, match="rstd"):
        k6.layer_norm_act_bwd(_fake(x), _fake(g), _fake(b), _fake(r),
                              _fake(torch.ones(3)), _fake(x))
    # a view of memory that is not channels-last raises, it is not copied
    with pytest.raises(ValueError, match="not contiguous"):
        fe.layer_norm_act(_fake(torch.ones(2, 8, 3).transpose(1, 2)),
                          _fake(torch.ones(3)), _fake(torch.zeros(3)))


def test_cpu_tensor_takes_the_plain_version_uncounted():
    x, g, b, dy = (_port(a) for a in _inputs(9, "float32", rows=5, cols=20))
    k6.launches = k6.bwd_launches = 0
    for act in ACTS:
        got = k6.layer_norm_act(x, g, b, 1e-5, act)
        want = k6.layer_norm_act_reference(x, g, b, 1e-5, act)
        assert all(torch.equal(a, w) for a, w in zip(got, want))
        mu, rstd = got[1:]
        assert all(torch.equal(a, w) for a, w in zip(
            k6.layer_norm_act_bwd(x, g, b, mu, rstd, dy, act),
            k6.layer_norm_act_bwd_reference(x, g, b, mu, rstd, dy, act)))
    assert k6.launches == k6.bwd_launches == 0


# --------------------------------------------------------------- the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("K6 and K7 are CUDA C++ with no CPU mode; need an "
                    "NVIDIA card and nvcc")
    return torch.device("cuda")


def _card_inputs(dev, rows, cols, dtype, seed, offset=0.0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = (torch.randn(rows, cols, generator=gen, device=dev) + offset
         ).to(dtype)
    g = torch.randn(cols, generator=gen, device=dev) * 0.5 + 1.0
    b = torch.randn(cols, generator=gen, device=dev)
    dy = torch.randn(rows, cols, generator=gen, device=dev).to(dtype)
    return x, g, b, dy


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("rows,cols", [(256, 768), (77, 768), (33, 4096),
                                       (5, 37), (64, 1500)])
def test_kernels_match_plain_on_card(cuda_device, rows, cols, dtype):
    x, g, b, dy = _card_inputs(cuda_device, rows, cols, dtype, rows + cols)
    for act in ACTS:
        before = (k6.launches, k6.bwd_launches)
        y, mu, rstd = k6.layer_norm_act(x, g, b, 1e-12, act)
        again = k6.layer_norm_act(x, g, b, 1e-12, act)
        got = k6.layer_norm_act_bwd(x, g, b, mu, rstd, dy, act)
        got2 = k6.layer_norm_act_bwd(x, g, b, mu, rstd, dy, act)
        torch.cuda.synchronize()
        assert (k6.launches, k6.bwd_launches) == (before[0] + 2,
                                                  before[1] + 2)
        assert all(torch.equal(a, c) for a, c in zip((y, mu, rstd), again))
        assert all(torch.equal(a, c) for a, c in zip(got, got2))
        ry, rmu, rrs = k6.layer_norm_act_reference(x, g, b, 1e-12, act)
        assert _within((y.float() - ry.float()).abs(),
                         k6.y_bound(x, g, b, rmu, rrs, ry)), act
        bmu, brs = k6.stats_bound(rmu, rrs)
        assert _within((mu - rmu).abs(), bmu)
        assert _within((rstd - rrs).abs(), brs)
        # the backward on the same mu and rstd
        want = k6.layer_norm_act_bwd_reference(x, g, b, mu, rstd, dy, act)
        assert _within((got[0].float() - want[0].float()).abs(),
                         k6.dx_bound(x, g, b, mu, rstd, dy, want[0], act))
        sg, sb = k6.sum_bound(x, g, b, mu, rstd, dy, act)
        assert _within((got[1] - want[1]).abs(), sg)
        assert _within((got[2] - want[2]).abs(), sb)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,cols", LN_SHAPES)
def test_k7_matches_plain_and_reruns_bit_equal(cuda_device, rows, cols):
    """K7 at every chip_smoke.py shape, 7 activations, 3 dtypes: within
    its tolerance of the plain version, a rerun bit-equal, the grid
    barrier's arrival count back to zero after every call."""
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        x, g, b, dy = _card_inputs(cuda_device, rows, cols, dtype,
                                   rows * 7 + cols)
        _, mu, rstd = k6.layer_norm_act_reference(x, g, b, 1e-12)
        for act in ACTS:
            got = k6.layer_norm_act_bwd(x, g, b, mu, rstd, dy, act)
            got2 = k6.layer_norm_act_bwd(x, g, b, mu, rstd, dy, act)
            torch.cuda.synchronize()
            assert all(torch.equal(a, c) for a, c in zip(got, got2)), act
            want = k6.layer_norm_act_bwd_reference(x, g, b, mu, rstd, dy,
                                                   act)
            assert _within((got[0].float() - want[0].float()).abs(),
                           k6.dx_bound(x, g, b, mu, rstd, dy, want[0],
                                       act)), (dtype, act)
            sg, sb = k6.sum_bound(x, g, b, mu, rstd, dy, act)
            assert _within((got[1] - want[1]).abs(), sg), (dtype, act)
            assert _within((got[2] - want[2]).abs(), sb), (dtype, act)
    for bar, _ in k6._workspaces.values():
        assert int(bar[0]) == 0  # the grid barrier's arrivals


@pytest.mark.cuda
def test_k7_misaligned_rows_take_the_direct_layout(cuda_device):
    """A view one element into its storage is not 16-byte aligned: K7
    reads it without the ring and still matches the plain version."""
    for dtype in (torch.float32, torch.bfloat16):
        x, g, b, dy = _card_inputs(cuda_device, 65, 768, dtype, 5)
        xs = x.flatten()[1:].view(-1)[:64 * 768].view(64, 768)
        dys = dy.flatten()[1:][:64 * 768].view(64, 768)
        assert xs.is_contiguous() and xs.data_ptr() % 16 != 0
        assert not k6.bwd_staged(xs, dys, torch.empty_like(xs))
        _, mu, rstd = k6.layer_norm_act_reference(xs, g, b, 1e-12)
        got = k6.layer_norm_act_bwd(xs, g, b, mu, rstd, dys, "gelu")
        want = k6.layer_norm_act_bwd_reference(xs, g, b, mu, rstd, dys,
                                               "gelu")
        torch.cuda.synchronize()
        assert _within((got[0].float() - want[0].float()).abs(),
                       k6.dx_bound(xs, g, b, mu, rstd, dys, want[0], "gelu"))
        sg, sb = k6.sum_bound(xs, g, b, mu, rstd, dys, "gelu")
        assert _within((got[1] - want[1]).abs(), sg)
        assert _within((got[2] - want[2]).abs(), sb)


@pytest.mark.cuda
def test_k7_is_one_kernel_a_call(cuda_device):
    """One device kernel a call at every chip_smoke.py shape and dtype,
    as torch.profiler records it in a fresh process."""
    from deeplearning4j_tpu_torch.tools import count_kernels
    cases = [["K7", list(s), dt] for s in LN_SHAPES
             for dt in ("float32", "bfloat16", "float16")]
    for _, shape, dtype, _, names in count_kernels.count_in_subprocess(
            cases):
        assert len(names) == 1 and "layer_norm_act_bwd" in names[0], (
            shape, dtype, names)


@pytest.mark.cuda
def test_k7_occupancy_and_floor(cuda_device):
    """The resources the card gives K7's layout: the CTA an SM the
    cooperative grid needs and no spills; and the empty kernel launched the
    same way runs."""
    for rows, cols in ((4096, 768), (4096, k6.MAX_COLS)):
        occ = k6.bwd_occupancy(rows, cols)
        assert occ["ctas_per_sm"] >= 1, occ
        assert occ["local_bytes"] == 0, occ
        k6.bwd_launch_floor(rows, cols)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_tensor_reaches_k6_and_k7(cuda_device):
    x, g, b, _ = _card_inputs(cuda_device, 4 * 16, 96, torch.float32, 3)
    x = x.view(4, 16, 96).requires_grad_(True)
    g.requires_grad_(True)
    fe.reset_counters()
    before = (k6.launches, k6.bwd_launches)
    y = fe.layer_norm_act(x, g, b, 1e-12, act="gelu")
    y.sum().backward()
    torch.cuda.synchronize()
    assert (k6.launches, k6.bwd_launches) == (before[0] + 1, before[1] + 1)
    assert fe.counters() == {"fused": 1, "fallback_platform": 0,
                             "fallback_act": 0, "fallback_dtype": 0}
    assert x.grad is not None and g.grad is not None
