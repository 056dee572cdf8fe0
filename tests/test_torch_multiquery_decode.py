"""K10's module, multi-query (speculative verify) decode attention, and the
multi-query dispatch, against the JAX package on the CPU, and (marked
``cuda``, skipped without a card) K10 itself against its plain version on
the card.

1. K10's plain version (``kernels/multiquery_decode.py::
   multiquery_decode_reference``) against the JAX package's
   ``decode_multiquery_attention(interpret=True, block_k=32)`` (the Pallas
   kernel's body run by the interpreter, at the plain version's key tile
   where it divides C) and ``reference_decode_multiquery``, on the same
   numpy inputs, windows of k = 2, 4 and 8, ragged lengths with 0, C - k
   and a negative one (a fully masked first query: uniform weights over
   the cache), and a C that is not a power of two: float32 within 1e-5
   (the JAX package's kernel-vs-reference tolerance); bfloat16 and float16
   within ``multiquery_decode.tolerance`` (K9's ``4 u (sum p |v| / l +
   |o|)`` over each query's own window) of the interpreted kernel and of
   the JAX reference.
2. The JAX suite's verify case (``tests/test_paged_kv.py:100-124``): query
   i equals a single-query decode at ``lengths + 1 + i``, and rows past a
   query's window (poisoned with +-999) change nothing.
3. The tolerance rejects a kernel that drops one split's keys in every
   affected (b, h, query) row, also at the cluster cap of 8 splits.
4. The dispatch's decisions on CPU tensors, its route on CUDA ones (a
   stand-in tensor that reports a CUDA device reaches K10's wrapper and
   never its plain version; mode ``off`` raises), the wrapper's limits
   (a window above 16 rows, a head dimension above 128, another dtype:
   ValueErrors naming the limit), one launch a call with no scratch (the
   kernel stubbed) and the bound arithmetic.
5. On the card: K10 against its plain version, rerun bitwise equal, one
   kernel a call at split counts 1, 2 and the cluster cap.

JAX is imported only by the tests that compare with it, so ``python3 -m
pytest --noconftest tests/test_torch_multiquery_decode.py -m cuda`` runs on
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


def _operands(B, H, Tq, C, d, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((B, H, Tq, d), (B, H, C, d), (B, H, C, d)))


def _lengths(B, Tq, C, seed=0):
    """Ragged lengths BEFORE the window, with 0, C - k and -2 (the first
    queries of that row fully masked) among them."""
    ln = np.random.default_rng(seed).integers(0, C - Tq + 1, B)
    ln[:3] = (0, C - Tq, -2)[:B]
    return ln.astype(np.int32)


def _jax(arrays, dtype):
    import jax.numpy as jnp
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
           torch.float16: jnp.float16}[dtype]
    return [jnp.asarray(a).astype(jdt) for a in arrays]


def _from_jax(a):
    import jax.numpy as jnp
    return torch.from_numpy(np.array(jnp.asarray(a, jnp.float32)))


# (B, H, Tq, C, d): windows of 2, 4 and 8; C = 200 is not a power of two
SHAPES = [(3, 2, 4, 64, 16), (4, 4, 2, 96, 32), (5, 1, 8, 200, 8)]


@pytest.mark.parametrize("B,H,Tq,C,d", SHAPES, ids=str)
def test_plain_matches_jax_float32(B, H, Tq, C, d):
    from deeplearning4j_tpu.ops import flash_attention as jfa
    q, k, v = _operands(B, H, Tq, C, d, seed=B * C)
    ln = _lengths(B, Tq, C, seed=C)
    got = k10.multiquery_decode_reference(
        *[torch.from_numpy(a) for a in (q, k, v)], torch.from_numpy(ln))
    kern = jfa.decode_multiquery_attention(
        *_jax((q, k, v), torch.float32), ln, block_k=32, interpret=True)
    ref = jfa.reference_decode_multiquery(*_jax((q, k, v), torch.float32),
                                          ln)
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, H, Tq, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(kern), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=0)
    # L = -2: queries 0 and 1 see no column, uniform weights over all C
    np.testing.assert_allclose(got[2, :, :2].numpy(),
                               np.repeat(v[2].mean(1, keepdims=True), 2, 1),
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=str)
@pytest.mark.parametrize("B,H,Tq,C,d", SHAPES, ids=str)
def test_plain_matches_jax_16bit(B, H, Tq, C, d, dtype):
    from deeplearning4j_tpu.ops import flash_attention as jfa
    q, k, v = _operands(B, H, Tq, C, d, seed=B * C + 1)
    ln = _lengths(B, Tq, C, seed=C + 1)
    tq, tk, tv = [torch.from_numpy(a).to(dtype) for a in (q, k, v)]
    got = k10.multiquery_decode_reference(tq, tk, tv, torch.from_numpy(ln))
    assert got.dtype == dtype
    kern = _from_jax(jfa.decode_multiquery_attention(
        *_jax((q, k, v), dtype), ln, block_k=32, interpret=True))
    ref = _from_jax(jfa.reference_decode_multiquery(*_jax((q, k, v), dtype),
                                                    ln))
    tl = torch.from_numpy(ln)
    assert k10.max_violation(got, kern.to(dtype), tq, tk, tv, tl) <= 1.0
    assert k10.max_violation(got, ref.to(dtype), tq, tk, tv, tl) <= 1.0


def test_each_query_is_a_single_query_decode_and_sees_only_its_window():
    """``tests/test_paged_kv.py:100-124``: query i equals a single-query
    decode over ``lengths + 1 + i`` rows, and poisoned rows past every
    query's window change nothing."""
    from deeplearning4j_tpu.ops import flash_attention as jfa
    B, H, Tq, C, d = 2, 2, 4, 32, 8
    q, k, v = _operands(B, H, Tq, C, d, seed=21)
    ln = np.array([5, 20], np.int32)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    y = fa.decode_multiquery_dispatch(tq, tk, tv, torch.from_numpy(ln))
    for i in range(Tq):
        yi = k9.decode_attention_reference(tq[:, :, i:i + 1], tk, tv,
                                           torch.from_numpy(ln + 1 + i))
        np.testing.assert_allclose(y[:, :, i:i + 1].numpy(), yi.numpy(),
                                   atol=1e-5, rtol=0)
    # row 0's last query sees columns < 5 + 1 + 3 = 9
    k2, v2 = k.copy(), v.copy()
    k2[0, :, 9:] = 999.0
    v2[0, :, 9:] = -999.0
    ln2 = np.array([5, 3], np.int32)
    y2 = fa.decode_multiquery_dispatch(tq, torch.from_numpy(k2),
                                       torch.from_numpy(v2),
                                       torch.from_numpy(ln2))
    y3 = jfa.reference_decode_multiquery(q, k2, v2, ln2)
    np.testing.assert_allclose(y2.numpy(), np.asarray(y3), atol=1e-5,
                               rtol=0)
    clean = fa.decode_multiquery_dispatch(tq, tk, tv, torch.from_numpy(ln2))
    np.testing.assert_array_equal(y2[0].numpy(), clean[0].numpy())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=str)
def test_tolerance_rejects_a_dropped_split(dtype):
    """A kernel that loses the keys of one of its splits fails the 16-bit
    tolerance in every (b, h, query) row whose window held some but not
    all of the dropped keys."""
    B, H, Tq, C, d = 6, 4, 4, 256, 32
    q, k, v = [torch.from_numpy(a).to(dtype)
               for a in _operands(B, H, Tq, C, d, seed=3)]
    ln = torch.tensor([0, 250, -2, 100, 37, 190], dtype=torch.int32)
    ref = k10.multiquery_decode_reference(q, k, v, ln)
    tol = k10.tolerance(ref, q, k, v, ln)
    splits = k9.num_splits(B, H, C)
    rows = 0
    for which in range(splits):
        bad, partial = k10.dropped_split_reference(q, k, v, ln, which)
        viol = ((bad.double() - ref.double()).abs() / tol).amax(-1)
        sel = partial[:, None, :].expand(B, H, Tq)
        rows += int(sel.sum())
        assert (viol[sel] > 1.0).all(), (which, viol)
    assert splits == 4 and rows > 0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=str)
def test_tolerance_rejects_a_dropped_split_at_the_cap(dtype):
    """As above, at a shape whose rows take the most splits, one cluster
    of ``MAX_SPLITS`` CTAs each."""
    B, H, Tq, C, d = 3, 2, 4, 1024, 32
    q, k, v = [torch.from_numpy(a).to(dtype)
               for a in _operands(B, H, Tq, C, d, seed=4)]
    ln = torch.tensor([1020, 500, -2], dtype=torch.int32)
    ref = k10.multiquery_decode_reference(q, k, v, ln)
    tol = k10.tolerance(ref, q, k, v, ln)
    splits = k9.num_splits(B, H, C)
    rows = 0
    for which in range(splits):
        bad, partial = k10.dropped_split_reference(q, k, v, ln, which)
        viol = ((bad.double() - ref.double()).abs() / tol).amax(-1)
        sel = partial[:, None, :].expand(B, H, Tq)
        rows += int(sel.sum())
        assert (viol[sel] > 1.0).all(), (which, viol)
    assert splits == k9.MAX_SPLITS and rows > 0


def test_window_mask_and_valid_rows():
    keep, uniform = k10.window_mask(torch.tensor([0, 5, -2]), 3, 8)
    assert keep.shape == (3, 3, 8) and uniform.shape == (3, 3)
    assert keep[1, 2].tolist() == [True] * 8  # 5 + 1 + 2 = 8 columns
    assert keep[0, 0].sum() == 1 and keep[0, 2].sum() == 3
    assert uniform[2].tolist() == [True, True, False]
    assert keep[2, 2].sum() == 1
    # a row whose first query is fully masked reads all C rows
    assert k10.valid_rows([0, 5, -2, 300], 3, 8).tolist() == [3, 8, 8, 8]


# ------------------------------------------------------- dispatch decisions

def _cpu_case(B=2, H=2, Tq=3, C=16, d=8):
    q, k, v = _operands(B, H, Tq, C, d)
    return [torch.from_numpy(a) for a in (q, k, v)] + [
        torch.tensor([3, 12], dtype=torch.int32)]


def test_cpu_decisions(auto_mode):
    q, k, v, ln = _cpu_case()
    want = k10.multiquery_decode_reference(q, k, v, ln)
    before = k10.launches
    torch.testing.assert_close(fa.decode_multiquery_dispatch(q, k, v, ln),
                               want, atol=0, rtol=0)
    fa.set_mode("off")
    torch.testing.assert_close(fa.decode_multiquery_dispatch(q, k, v, ln),
                               want, atol=0, rtol=0)
    assert fa.decode_counters()["decode_multiquery_fallback"] == 2
    assert fa.decode_counters()["decode_multiquery"] == 0
    assert k10.launches == before
    assert fa.reference_decode_multiquery is \
        k10.multiquery_decode_reference
    with pytest.raises(ValueError, match=r"\[B, H, k, d\]"):
        fa.decode_multiquery_dispatch(q[0], k, v, ln)


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
    monkeypatch.setattr(k10, "multiquery_decode_reference", boom)
    monkeypatch.setattr(k10, "_attend", boom)
    monkeypatch.setattr(fa, "reference_decode_multiquery", boom)
    monkeypatch.setattr(_build, "nvcc", lambda: (_ for _ in ()).throw(
        RuntimeError("nvcc not found")))
    monkeypatch.setattr(_build, "_libs", {})
    k10._kernel.cache_clear()
    yield
    k10._kernel.cache_clear()


def test_cuda_verify_reaches_k10_or_raises(plain_forbidden, auto_mode):
    q, k, v, ln = _cpu_case()
    with pytest.raises(RuntimeError, match="nvcc"):
        fa.decode_multiquery_dispatch(_fake(q), _fake(k), _fake(v),
                                      _fake(ln))
    assert fa.decode_counters()["decode_multiquery"] == 1
    assert fa.decode_counters()["decode_multiquery_fallback"] == 0
    fa.set_mode("off")
    with pytest.raises(ValueError, match="'off'"):
        fa.decode_multiquery_dispatch(_fake(q), _fake(k), _fake(v), ln)
    assert fa.decode_counters()["decode_multiquery"] == 1


def test_k10_wrapper_limits_raise_before_launch(plain_forbidden):
    q, k, v, ln = (_fake(t) for t in _cpu_case())
    with pytest.raises(ValueError, match="float32, bfloat16, float16"):
        k10.multiquery_decode(_fake(q.double()), _fake(k.double()),
                              _fake(v.double()), ln)
    with pytest.raises(ValueError, match="limit 1..16"):
        k10.multiquery_decode(_fake(torch.zeros(2, 2, 17, 8)), k, v, ln)
    with pytest.raises(ValueError, match="limit 128"):
        k10.multiquery_decode(_fake(torch.zeros(1, 1, 2, 256)),
                              _fake(torch.zeros(1, 1, 4, 256)),
                              _fake(torch.zeros(1, 1, 4, 256)),
                              _fake(torch.tensor([1], dtype=torch.int32)))
    with pytest.raises(ValueError, match="shapes disagree"):
        k10.multiquery_decode(q, k[:, :1], v, ln)
    with pytest.raises(ValueError, match="lengths"):
        k10.multiquery_decode(q, k, v, _fake(torch.tensor([3, 12])))
    with pytest.raises(ValueError, match="contiguous last"):
        k10.multiquery_decode(q, _fake(torch.zeros(2, 2, 8, 16)
                                       .transpose(2, 3)), v, ln)
    with pytest.raises(ValueError, match="not supported"):
        k10.multiquery_decode(torch.zeros(1, 1, 2, 8, device="meta"),
                              k, v, ln)


@pytest.fixture
def stub_launch(monkeypatch):
    """K10's kernel entry replaced by a recorder of its arguments (and the
    CUDA stream by a stand-in): the wrapper's CUDA branch without a card."""
    calls = []

    def entry(*args):
        calls.append(args)
        return 0
    monkeypatch.setattr(k10, "_kernel", lambda: entry)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None:
                        types.SimpleNamespace(cuda_stream=7))
    return calls


@pytest.mark.parametrize("C", [16, 256], ids=["one-split", "four-splits"])
def test_k10_launches_once_a_call_without_scratch(stub_launch, C):
    """One entry call a wrapper call, whatever the split count, with the
    five operands as its only pointers: no scratch, no combine launch."""
    B, H, Tq, d = 2, 2, 3, 8
    q, k, v = (_fake(torch.from_numpy(a))
               for a in _operands(B, H, Tq, C, d))
    ln = _fake(torch.tensor([3, C - Tq], dtype=torch.int32))
    before = k10.launches
    o = k10.multiquery_decode(q, k, v, ln)
    assert k10.launches == before + 1 and len(stub_launch) == 1
    args = stub_launch[0]
    assert args[:5] == tuple(t.data_ptr() for t in (q, k, v, ln, o))
    splits = k9.num_splits(B, H, C)
    assert splits == (1 if C == 16 else 4)
    assert args[5:11] == (B, H, C, d, Tq, splits)
    assert list(args[11]) == [s for t in (q, k, v, o) for s in t.stride()[:3]]
    assert args[12:] == (pytest.approx(d ** -0.5), 1, 0, 7)
    assert tuple(o.shape) == (B, H, Tq, d)
    assert not hasattr(k10, "combine_launches")


def test_bound_arithmetic():
    ln = [0, 5, 300, -3]  # L + k rows; past C reads C; a masked query: C
    rows = 4 + 9 + 128 + 128
    assert k10.bytes_moved(ln, 2, 4, 128, 64, 4) == \
        2 * rows * 2 * 64 * 4 + 2 * 4 * 2 * 4 * 64 * 4 + 4 * 4
    assert k10.flops(ln, 2, 4, 128, 64) == 4 * 4 * 64 * rows * 2
    ms, by = k10.bound_ms(ln, 2, 4, 128, 64, 4)
    assert by == "bytes"
    assert ms == pytest.approx(1e3 * k10.bytes_moved(ln, 2, 4, 128, 64, 4)
                               / k10.H100_BYTES_PER_S)


def test_build_lists_the_verify_source():
    assert "mq_decode_attn" in _build.sources()
    assert _build.library_path("mq_decode_attn").name.startswith(
        "libmq_decode_attn-")


# ------------------------------------------------------------- on the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("K10 is CUDA C++ with no CPU mode; needs an NVIDIA card "
                    "and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("B,H,Tq,C,d", [(8, 4, 4, 128, 64),
                                        (32, 4, 4, 1024, 64),
                                        (4, 8, 8, 2048, 128),
                                        (3, 2, 2, 200, 32),
                                        (2, 1, 16, 24, 8),
                                        (3, 2, 4, 100, 6)], ids=str)
def test_k10_matches_plain_on_card(cuda_device, B, H, Tq, C, d, dtype):
    q, k, v = [torch.from_numpy(a).to(cuda_device, dtype)
               for a in _operands(B, H, Tq, C, d)]
    ln = torch.from_numpy(_lengths(B, Tq, C)).to(cuda_device)
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for heads in (False, True):
            qq = q
            if heads:  # the head split of a [B, k, H*d] projection
                qq = q.transpose(1, 2).reshape(B, Tq, H * d).view(
                    B, Tq, H, d).transpose(1, 2)
            before = k10.launches
            got = k10.multiquery_decode(qq, k, v, ln)
            again = k10.multiquery_decode(qq, k, v, ln)
            torch.cuda.synchronize()
            assert k10.launches == before + 2
            assert torch.equal(got, again)
            ref = k10.multiquery_decode_reference(qq, k, v, ln)
            assert k10.max_violation(got, ref, qq, k, v, ln) <= 1.0
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


#: (B, H, k, C, d, splits): one split, two, and the cluster cap (the last
#: at the kernel's largest shared memory, 16 queries of d = 128)
SPLIT_CASES = [(32, 12, 4, 64, 64, 1), (8, 4, 4, 128, 64, 2),
               (2, 3, 4, 1024, 64, 8), (2, 3, 16, 1024, 128, 8)]


@pytest.fixture(scope="module")
def kernels_a_call():
    """``{(shape, dtype name): device kernels of one call}`` for every
    SPLIT_CASES shape and dtype, from ``torch.profiler`` in a fresh process
    (``tools/count_kernels.py`` says why)."""
    if not torch.cuda.is_available():
        pytest.skip("K10 is CUDA C++ with no CPU mode; needs an NVIDIA card "
                    "and nvcc")
    from deeplearning4j_tpu_torch.tools import count_kernels
    got = count_kernels.count_in_subprocess(
        [["K10", list(c[:5]), str(dt)[6:]] for c in SPLIT_CASES
         for dt in DTYPES])
    return {(tuple(shape), dtype): names for _, shape, dtype, _, names in got}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("B,H,Tq,C,d,splits", SPLIT_CASES, ids=str)
def test_k10_one_kernel_at_each_split_count(cuda_device, kernels_a_call, B, H,
                                            Tq, C, d, splits, dtype):
    """One split, two, and the cluster cap: K10 against its plain version,
    and ``torch.profiler`` sees one kernel a call."""
    assert k9.num_splits(B, H, C) == splits
    names = kernels_a_call[((B, H, Tq, C, d), str(dtype)[6:])]
    assert len(names) == 1 and "mq_decode_kernel" in names[0], names
    q, k, v = [torch.from_numpy(a).to(cuda_device, dtype)
               for a in _operands(B, H, Tq, C, d, seed=5)]
    ln = torch.from_numpy(_lengths(B, Tq, C, seed=5)).to(cuda_device)
    before = k10.launches
    got = k10.multiquery_decode(q, k, v, ln)
    torch.cuda.synchronize()
    assert k10.launches == before + 1
    ref = k10.multiquery_decode_reference(q, k, v, ln)
    assert k10.max_violation(got, ref, q, k, v, ln) <= 1.0
