"""K9's module, single-query decode attention, and the decode half of the
attention dispatch, against the JAX package on the CPU, and (marked
``cuda``, skipped without a card) K9 itself against its plain version on
the card.

1. K9's plain version (``kernels/decode_attention.py::
   decode_attention_reference``) against the JAX package's
   ``decode_attention(interpret=True, block_k=32)`` (the Pallas kernel's
   body run by the interpreter, at the plain version's key tile) and
   ``reference_decode_attention``, on the same numpy inputs with ragged
   lengths, ``L = 0`` (uniform weights over the cache) and ``L = C``:
   float32 within 1e-5 (the JAX package's decode kernel-vs-reference
   tolerance); bfloat16 and float16 within ``decode_attention.tolerance``
   (``4 u (sum p |v| / l + |o|)``: p rounded against other maxima, o
   rounded once) of the interpreted kernel, and of the JAX reference
   (which rounds the normalized softmax, not the running p). The
   tolerance rejects a kernel that drops one split's keys.
2. ``length_bias``, ``cache_insert`` (write gating, a ``k > 1`` window,
   the clamp at ``C - k``, a negative start) and
   ``reference_decode_multiquery`` bit for bit against JAX's.
3. The dispatch's decisions on CPU tensors, its refusals on CUDA ones
   (a stand-in tensor that reports a CUDA device), K9's wrapper checks,
   one launch a call with no scratch (the kernel stubbed), the split rule
   and the bound arithmetic.
4. On the card: K9 against its plain version, rerun bitwise equal, one
   kernel a call at split counts 1, 2 and the cluster cap.

JAX is imported only by the tests that compare with it, so ``python3 -m
pytest --noconftest tests/test_torch_decode_attention.py -m cuda`` runs on
a machine with the card and no JAX."""

import types

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.kernels import _build
from deeplearning4j_tpu_torch.kernels import decode_attention as k9
from deeplearning4j_tpu_torch.kernels import multiquery_decode as k10
from deeplearning4j_tpu_torch.ops import flash_attention as fa

DTYPES = (torch.float32, torch.bfloat16, torch.float16)


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


@pytest.fixture
def auto_mode():
    old = fa.set_mode("auto")
    fa.reset_counters()
    yield
    fa.set_mode(old)


def _operands(B, H, C, d, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((B, H, 1, d), (B, H, C, d), (B, H, C, d)))


def _lengths(B, C, seed=0):
    """Ragged lengths with 1, C and 0 (an inactive slot) among them."""
    ln = np.random.default_rng(seed).integers(1, C + 1, B)
    ln[:3] = (1, C, 0)[:B]
    return ln.astype(np.int32)


def _jax(arrays, dtype):
    import jax.numpy as jnp
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
           torch.float16: jnp.float16}[dtype]
    return [jnp.asarray(a).astype(jdt) for a in arrays]


def _from_jax(a):
    import jax.numpy as jnp
    return torch.from_numpy(np.array(jnp.asarray(a, jnp.float32)))


SHAPES = [(3, 2, 64, 16), (4, 4, 96, 32), (5, 1, 40, 8)]


@pytest.mark.parametrize("B,H,C,d", SHAPES, ids=str)
def test_plain_matches_jax_float32(B, H, C, d):
    from deeplearning4j_tpu.ops import flash_attention as jfa
    q, k, v = _operands(B, H, C, d, seed=B * C)
    ln = _lengths(B, C, seed=C)
    got = k9.decode_attention_reference(
        *[torch.from_numpy(a) for a in (q, k, v)], torch.from_numpy(ln))
    kern = jfa.decode_attention(*_jax((q, k, v), torch.float32), ln,
                                block_k=32, interpret=True)
    ref = jfa.reference_decode_attention(*_jax((q, k, v), torch.float32), ln)
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, H, 1, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(kern), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=0)
    # L = 0: uniform weights over all C rows, as the TPU kernel gives them
    np.testing.assert_allclose(got[2].numpy(), v[2].mean(1, keepdims=True),
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=str)
@pytest.mark.parametrize("B,H,C,d", SHAPES, ids=str)
def test_plain_matches_jax_16bit(B, H, C, d, dtype):
    from deeplearning4j_tpu.ops import flash_attention as jfa
    q, k, v = _operands(B, H, C, d, seed=B * C + 1)
    ln = _lengths(B, C, seed=C + 1)
    tq, tk, tv = [torch.from_numpy(a).to(dtype) for a in (q, k, v)]
    got = k9.decode_attention_reference(tq, tk, tv, torch.from_numpy(ln))
    assert got.dtype == dtype
    kern = _from_jax(jfa.decode_attention(*_jax((q, k, v), dtype), ln,
                                          block_k=32, interpret=True))
    ref = _from_jax(jfa.reference_decode_attention(*_jax((q, k, v), dtype),
                                                   ln))
    tl = torch.from_numpy(ln)
    assert k9.max_violation(got, kern.to(dtype), tq, tk, tv, tl) <= 1.0
    assert k9.max_violation(got, ref.to(dtype), tq, tk, tv, tl) <= 1.0


def test_length_bias_matches_jax():
    from deeplearning4j_tpu.ops import flash_attention as jfa
    ln = np.array([0, 3, 8, 11, -2], np.int32)
    got = k9.length_bias(torch.from_numpy(ln), 8)
    want = np.asarray(jfa.length_bias(ln, 8))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    assert fa.length_bias is k9.length_bias


@pytest.mark.parametrize("kw", [1, 3])
def test_cache_insert_matches_jax(kw):
    """Per-row positions, the write gate (gated rows bit for bit), a
    stale length past C (clamped to C - k) and a negative one."""
    from deeplearning4j_tpu.ops import flash_attention as jfa
    rng = np.random.default_rng(kw)
    B, H, C, d = 5, 2, 8, 4
    cache = rng.standard_normal((B, H, C, d)).astype(np.float32)
    new = rng.standard_normal((B, H, kw, d)).astype(np.float32)
    for lengths, write in (([0, 3, 7, 99, -4], None),
                           ([0, 99, 7, 5, 2], [1, 0, 0, 1, 1]),
                           ([6, 6, 6, 6, 6], [0, 1, 0, 1, 0])):
        ln = np.asarray(lengths, np.int32)
        wr = None if write is None else np.asarray(write, np.int32)
        t = torch.from_numpy(cache.copy())
        out = fa.cache_insert(t, torch.from_numpy(new), torch.from_numpy(ln),
                              None if wr is None else torch.from_numpy(wr))
        assert out is t  # in place
        want = np.asarray(jfa.cache_insert(cache, new, ln, wr))
        np.testing.assert_array_equal(out.numpy(), want)
        if wr is not None:
            for b in np.flatnonzero(wr == 0):
                np.testing.assert_array_equal(out[b].numpy(), cache[b])


def test_cache_insert_casts_and_refuses_a_window_too_long():
    cache = torch.zeros(1, 1, 4, 2, dtype=torch.bfloat16)
    fa.cache_insert(cache, torch.full((1, 1, 1, 2), 1.0 / 3), [1])
    assert cache.dtype == torch.bfloat16
    assert float(cache[0, 0, 1, 0]) == float(torch.tensor(
        1.0 / 3).to(torch.bfloat16))
    with pytest.raises(ValueError, match="does not fit"):
        fa.cache_insert(cache, torch.zeros(1, 1, 5, 2), [0])


def test_reference_decode_multiquery_matches_jax():
    from deeplearning4j_tpu.ops import flash_attention as jfa
    rng = np.random.default_rng(5)
    B, H, Tq, C, d = 3, 2, 4, 16, 8
    q = rng.standard_normal((B, H, Tq, d)).astype(np.float32)
    k, v = (rng.standard_normal((B, H, C, d)).astype(np.float32)
            for _ in range(2))
    ln = np.array([0, 5, 12], np.int32)
    got = fa.reference_decode_multiquery(
        *[torch.from_numpy(a) for a in (q, k, v)], torch.from_numpy(ln))
    want = jfa.reference_decode_multiquery(q, k, v, ln)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)
    fa.reset_counters()
    again = fa.decode_multiquery_dispatch(
        *[torch.from_numpy(a) for a in (q, k, v)], torch.from_numpy(ln))
    torch.testing.assert_close(again, got, atol=0, rtol=0)
    assert fa.decode_counters()["decode_multiquery_fallback"] == 1


# ------------------------------------------------------- dispatch decisions

def _cpu_case(B=2, H=2, C=16, d=8, Tq=1):
    q, k, v = _operands(B, H, C, d)
    q = np.repeat(q, Tq, axis=2)
    return [torch.from_numpy(a) for a in (q, k, v)] + [
        torch.tensor([3, 16], dtype=torch.int32)]


def test_cpu_decisions(auto_mode):
    q, k, v, ln = _cpu_case()
    want = fa.reference_decode_attention(q, k, v, ln)
    torch.testing.assert_close(fa.decode_dispatch(q, k, v, ln), want,
                               atol=0, rtol=0)
    assert fa.decode_counters()["decode_fallback_platform"] == 1
    fa.set_mode("off")
    fa.decode_dispatch(q, k, v, ln)
    assert fa.decode_counters()["decode_fallback_mode"] == 1
    fa.set_mode("auto")
    q4, *_ = _cpu_case(Tq=3)  # a query bank: the length-masked reference
    y = fa.decode_dispatch(q4, k, v, ln)
    assert tuple(y.shape) == (2, 2, 3, 8)
    assert fa.decode_counters() == {
        "decode_fused": 0, "decode_fallback_mode": 1,
        "decode_fallback_platform": 1, "decode_fallback_multiquery": 1,
        "decode_multiquery": 0, "decode_multiquery_fallback": 0}
    assert not any(fa.counters().values())  # kept apart from attention's
    with pytest.raises(ValueError, match=r"\[B, H, Tq, d\]"):
        fa.decode_dispatch(q[0], k, v, ln)
    fa.reset_counters()
    assert not any(fa.decode_counters().values())


class _FakeCuda(torch.Tensor):
    """A CPU tensor that reports a CUDA device: it walks the CUDA branch
    on a machine without a card."""

    @property
    def device(self):
        return torch.device("cuda")


def _fake(t):
    return t.as_subclass(_FakeCuda)


@pytest.fixture
def plain_forbidden(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("the plain version was reached")
    monkeypatch.setattr(k9, "decode_attention_reference", boom)
    monkeypatch.setattr(fa, "reference_decode_attention", boom)
    monkeypatch.setattr(_build, "nvcc", lambda: (_ for _ in ()).throw(
        RuntimeError("nvcc not found")))
    monkeypatch.setattr(_build, "_libs", {})
    k9._kernel.cache_clear()
    yield
    k9._kernel.cache_clear()


def test_cuda_query_reaches_k9_or_raises(plain_forbidden, auto_mode):
    q, k, v, ln = _cpu_case()
    with pytest.raises(RuntimeError, match="nvcc"):
        fa.decode_dispatch(_fake(q), _fake(k), _fake(v), _fake(ln))
    assert fa.decode_counters()["decode_fused"] == 1
    fa.set_mode("off")
    with pytest.raises(ValueError, match="'off'"):
        fa.decode_dispatch(_fake(q), _fake(k), _fake(v), _fake(ln))
    # a CUDA verify window reaches K10's wrapper (its build here)
    fa.set_mode("auto")
    k10._kernel.cache_clear()
    with pytest.raises(RuntimeError, match="nvcc"):
        fa.decode_multiquery_dispatch(_fake(q), _fake(k), _fake(v),
                                      _fake(ln))
    assert fa.decode_counters()["decode_multiquery"] == 1


def test_cuda_query_bank_takes_the_counted_plain_route(monkeypatch,
                                                      auto_mode):
    """A query bank (Tq > 1) is the one route on which a CUDA tensor runs
    the plain version, as the JAX package runs it: it never reaches K9's
    wrapper, and each use is counted."""
    seen = []
    monkeypatch.setattr(fa, "reference_decode_attention",
                        lambda q, *a, **kw: seen.append(q.device) or "plain")
    monkeypatch.setattr(k9, "decode_attention", lambda *a, **kw: (
        _ for _ in ()).throw(AssertionError("K9's wrapper was reached")))
    q, k, v, ln = _cpu_case(Tq=3)
    assert fa.decode_dispatch(_fake(q), _fake(k), _fake(v), ln) == "plain"
    assert seen == [torch.device("cuda")]
    assert fa.decode_counters()["decode_fallback_multiquery"] == 1
    assert fa.decode_counters()["decode_fused"] == 0


def test_k9_wrapper_checks_before_launch(plain_forbidden):
    q, k, v, ln = (_fake(t) for t in _cpu_case())
    with pytest.raises(TypeError, match="dtype"):
        k9.decode_attention(_fake(q.double()), _fake(k.double()),
                            _fake(v.double()), ln)
    with pytest.raises(ValueError, match="shapes disagree"):
        k9.decode_attention(q, k[:, :1], v, ln)
    with pytest.raises(ValueError, match=r"\[B, H, 1, d\]"):
        k9.decode_attention(_fake(torch.zeros(2, 2, 2, 8)), k, v, ln)
    with pytest.raises(ValueError, match="lengths"):
        k9.decode_attention(q, k, v, _fake(torch.tensor([3, 16])))
    with pytest.raises(ValueError, match="contiguous last"):
        k9.decode_attention(q, _fake(torch.zeros(2, 2, 8, 16)
                                     .transpose(2, 3)), v, ln)
    big = _fake(torch.zeros(1, 1, 1, 256))
    with pytest.raises(ValueError, match="limit"):
        k9.decode_attention(big, _fake(torch.zeros(1, 1, 4, 256)),
                            _fake(torch.zeros(1, 1, 4, 256)),
                            _fake(torch.tensor([1], dtype=torch.int32)))
    with pytest.raises(ValueError, match="not supported"):
        k9.decode_attention(torch.zeros(1, 1, 1, 8, device="meta"),
                            k, v, ln)


@pytest.fixture
def stub_launch(monkeypatch):
    """K9's and K10's kernel entries replaced by a recorder of their
    arguments (and the CUDA stream by a stand-in): the wrappers' CUDA
    branch without a card."""
    calls = []

    def entry(*args):
        calls.append(args)
        return 0
    monkeypatch.setattr(k9, "_kernel", lambda: entry)
    monkeypatch.setattr(k10, "_kernel", lambda: entry)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None:
                        types.SimpleNamespace(cuda_stream=7))
    return calls


@pytest.mark.parametrize("C", [16, 256], ids=["one-split", "four-splits"])
def test_k9_launches_once_a_call_without_scratch(stub_launch, C):
    """One entry call a wrapper call, whatever the split count, with the
    five operands as its only pointers: no scratch, no combine launch."""
    B, H, d = 2, 2, 8
    q, k, v = (_fake(torch.from_numpy(a)) for a in _operands(B, H, C, d))
    ln = _fake(torch.tensor([3, C], dtype=torch.int32))
    before = k9.launches
    o = k9.decode_attention(q, k, v, ln)
    assert k9.launches == before + 1 and len(stub_launch) == 1
    args = stub_launch[0]
    assert args[:5] == tuple(t.data_ptr() for t in (q, k, v, ln, o))
    splits = k9.num_splits(B, H, C)
    assert splits == (1 if C == 16 else 4)
    assert args[5:11] == (B, H, C, d, splits, k9.cta_threads(B, H, C))
    assert list(args[11]) == [*q.stride()[:2], *k.stride()[:3],
                              *v.stride()[:3], *o.stride()[:2]]
    assert args[12:] == (pytest.approx(d ** -0.5), 1, 0, 7)
    assert tuple(o.shape) == (B, H, 1, d)


def test_cpu_wrapper_runs_the_plain_version_without_a_launch():
    q, k, v, ln = _cpu_case()
    before = k9.launches
    got = k9.decode_attention(q, k, v, ln)
    torch.testing.assert_close(got, k9.decode_attention_reference(
        q, k, v, ln), atol=0, rtol=0)
    assert k9.launches == before


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=str)
def test_tolerance_rejects_a_dropped_split(dtype):
    """A kernel that loses the keys of one of its splits fails the 16-bit
    tolerance in every (b, h) row where that split held some but not all
    of the row's keys."""
    B, H, C, d = 6, 4, 256, 32
    q, k, v = [torch.from_numpy(a).to(dtype)
               for a in _operands(B, H, C, d, seed=3)]
    ln = torch.from_numpy(_lengths(B, C, seed=3))
    ref = k9.decode_attention_reference(q, k, v, ln)
    tol = k9.tolerance(ref, q, k, v, ln)
    splits = k9.num_splits(B, H, C)
    rows = 0
    for which in range(splits):
        bad, partial = k9.dropped_split_reference(q, k, v, ln, which)
        viol = ((bad.double() - ref.double()).abs() / tol).amax((2, 3))
        rows += viol[partial].numel()
        assert (viol[partial] > 1.0).all(), (which, viol)
    # every row but the L = 1 one loses part of its keys to each split
    assert splits == 4 and rows == 4 * (B - 1) * H


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=str)
def test_tolerance_rejects_a_dropped_split_at_the_cap(dtype):
    """As above, at a shape whose rows take the most splits, one cluster
    of ``MAX_SPLITS`` CTAs each."""
    B, H, C, d = 2, 3, 1024, 32
    q, k, v = [torch.from_numpy(a).to(dtype)
               for a in _operands(B, H, C, d, seed=4)]
    ln = torch.from_numpy(_lengths(B, C, seed=4))
    ref = k9.decode_attention_reference(q, k, v, ln)
    tol = k9.tolerance(ref, q, k, v, ln)
    splits = k9.num_splits(B, H, C)
    rows = 0
    for which in range(splits):
        bad, partial = k9.dropped_split_reference(q, k, v, ln, which)
        viol = ((bad.double() - ref.double()).abs() / tol).amax((2, 3))
        rows += viol[partial].numel()
        assert (viol[partial] > 1.0).all(), (which, viol)
    # the L = C row loses part of its keys to each split, the L = 1 row
    # none
    assert splits == k9.MAX_SPLITS and rows == splits * H


def test_split_rule_and_bound():
    # about four CTAs per SM, at least 64 cache rows per split, at most the
    # portable cluster size of 8
    assert k9.MAX_SPLITS == 8
    assert k9.num_splits(8, 4, 128) == 2
    assert k9.num_splits(32, 4, 1024) == 5
    assert k9.num_splits(32, 12, 4096) == 2
    assert k9.num_splits(4, 8, 2048) == 8
    assert k9.num_splits(1, 1, 1 << 20) == k9.MAX_SPLITS
    assert k9.num_splits(512, 16, 64) == 1
    # 256 threads a CTA below two CTAs an SM, else 128
    assert k9.cta_threads(8, 4, 128) == 256        # 64 CTAs
    assert k9.cta_threads(4, 8, 2048) == 256       # 256 CTAs
    assert k9.cta_threads(32, 4, 1024) == 128      # 640 CTAs
    assert k9.cta_threads(32, 12, 4096) == 128     # 768 CTAs
    ln = [0, 5, 300]  # L = 0 reads all C rows; L past C reads C
    assert k9.bytes_moved(ln, 2, 128, 64, 4) == \
        2 * (128 + 5 + 128) * 2 * 64 * 4 + 2 * 3 * 2 * 64 * 4 + 4 * 3
    assert k9.flops(ln, 2, 128, 64) == 4 * 261 * 2 * 64
    ms, by = k9.bound_ms(ln, 2, 128, 64, 4)
    assert by == "bytes"
    assert ms == pytest.approx(1e3 * k9.bytes_moved(ln, 2, 128, 64, 4)
                               / k9.H100_BYTES_PER_S)


def test_vec_ok_takes_16_byte_rows_only():
    """K9 and K10 copy k and v 16 bytes at a time only where d, the
    pointers and the strides fall on 16 bytes; the card tests' d = 6 case
    takes the element path in every dtype."""
    for dtype, n in ((torch.float32, 4), (torch.bfloat16, 8),
                     (torch.float16, 8)):
        k = torch.zeros(3 * 2 * 100 * n + 1, dtype=dtype)
        rows = k[:-1].view(3, 2, 100, n)
        assert k9._vec_ok(rows, rows)
        shifted = k[1:].view(3, 2, 100, n)  # one element off 16 bytes
        assert not k9._vec_ok(rows, shifted)
        six = torch.zeros(3, 2, 100, 6, dtype=dtype)
        assert not k9._vec_ok(six, six)


def test_build_lists_the_decode_source():
    assert "decode_attn" in _build.sources()
    assert _build.library_path("decode_attn").name.startswith(
        "libdecode_attn-")


# ------------------------------------------------------------- on the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("K9 is CUDA C++ with no CPU mode; needs an NVIDIA card "
                    "and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("B,H,C,d", [(8, 4, 128, 64), (32, 12, 512, 64),
                                     (4, 8, 2048, 128), (3, 2, 200, 32),
                                     (2, 1, 1, 8), (3, 2, 100, 6)], ids=str)
def test_k9_matches_plain_on_card(cuda_device, B, H, C, d, dtype):
    q, k, v = [torch.from_numpy(a).to(cuda_device, dtype)
               for a in _operands(B, H, C, d)]
    ln = torch.from_numpy(_lengths(B, C)).to(cuda_device)
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for heads in (False, True):
            qq = q
            if heads:  # the head split of a [B, 1, H*d] projection
                qq = q.transpose(1, 2).reshape(B, 1, H * d).view(
                    B, 1, H, d).transpose(1, 2)
            before = k9.launches
            got = k9.decode_attention(qq, k, v, ln)
            again = k9.decode_attention(qq, k, v, ln)
            torch.cuda.synchronize()
            assert k9.launches == before + 2
            assert torch.equal(got, again)
            ref = k9.decode_attention_reference(qq, k, v, ln)
            assert k9.max_violation(got, ref, qq, k, v, ln) <= 1.0
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


#: (B, H, C, d, splits): one split, two, and the cluster cap
SPLIT_CASES = [(32, 12, 64, 64, 1), (8, 4, 128, 64, 2), (2, 3, 1024, 64, 8)]


@pytest.fixture(scope="module")
def kernels_a_call():
    """``{(shape, dtype name): device kernels of one call}`` for every
    SPLIT_CASES shape and dtype, from ``torch.profiler`` in a fresh process
    (``tools/count_kernels.py`` says why)."""
    if not torch.cuda.is_available():
        pytest.skip("K9 is CUDA C++ with no CPU mode; needs an NVIDIA card "
                    "and nvcc")
    from deeplearning4j_tpu_torch.tools import count_kernels
    got = count_kernels.count_in_subprocess(
        [["K9", list(c[:4]), str(dt)[6:]] for c in SPLIT_CASES
         for dt in DTYPES])
    return {(tuple(shape), dtype): names for _, shape, dtype, _, names in got}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("B,H,C,d,splits", SPLIT_CASES, ids=str)
def test_k9_one_kernel_at_each_split_count(cuda_device, kernels_a_call, B, H,
                                           C, d, splits, dtype):
    """One split, two, and the cluster cap: K9 against its plain version,
    and ``torch.profiler`` sees one kernel a call."""
    assert k9.num_splits(B, H, C) == splits
    names = kernels_a_call[((B, H, C, d), str(dtype)[6:])]
    assert len(names) == 1 and "decode_attn_kernel" in names[0], names
    q, k, v = [torch.from_numpy(a).to(cuda_device, dtype)
               for a in _operands(B, H, C, d, seed=5)]
    ln = torch.from_numpy(_lengths(B, C, seed=5)).to(cuda_device)
    before = k9.launches
    got = k9.decode_attention(q, k, v, ln)
    torch.cuda.synchronize()
    assert k9.launches == before + 1
    ref = k9.decode_attention_reference(q, k, v, ln)
    assert k9.max_violation(got, ref, q, k, v, ln) <= 1.0
