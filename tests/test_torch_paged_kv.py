"""The port's paged KV cache, prefix sharing and speculative decoding
against the JAX package's, on the CPU, on a tiny attention language model
like ``tests/test_torch_generate.py``'s (one-hot tokens, V = 16, two
``SelfAttentionLayer(n_heads=2)`` blocks with a dense layer between, a
softmax ``OutputLayer``) saved by the JAX package and loaded by the port,
and a second one from another seed as the draft.

- ``paged_positions``, ``paged_gather``, ``paged_insert`` (the write gate,
  clamped positions, the zero page untouched) and ``page_rows`` bit for
  bit against JAX's.
- ``PagedKVPool``: one sequence of alloc, release, retain, register,
  lookup and fork notes, drawn by hypothesis, gives the same page ids,
  refcounts, ``PoolExhausted`` and ``stats()`` as the JAX pool; eviction
  under pressure.
- ``PagedGenerativeEngine``: prefill, decode, verify and ``pdecode_multi``
  logits against the JAX paged engine on the same page tables within
  1e-5 (float32; sums in another order move them by ~1e-7); ``grow`` makes
  no device copy; ``fork`` copies exactly the pairs; random
  join/leave/grow/fork sequences give the contiguous engine's logits bit
  for bit (``tests/test_paged_kv.py:179-290``).
- ``ContinuousBatcher(paged=True)``: the prefix mix's streams and
  ``page_pool`` stats (hits, misses, forks, peak) equal the JAX paged
  batcher's; the speculative streams, with the target as its own draft
  and with an other-seed draft, equal the JAX batcher's and the plain
  greedy stream, with the same ``proposed`` and ``accepted`` counts; the
  config refusals of ``tests/test_paged_kv.py:468-509``; POST /generate
  through a paged, speculative server. Streams part from JAX's only at a
  near-tie (the port's teacher-forced top-2 gap below ``TIE_TOL`` of the
  top), as in ``tests/test_torch_generate.py``."""

import itertools
import json
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from deeplearning4j_tpu.nn.config import InputType as JInputType
from deeplearning4j_tpu.nn.config import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.nn.layers import attention as jatt
from deeplearning4j_tpu.nn.layers.core import DenseLayer as JDense
from deeplearning4j_tpu.nn.layers.core import OutputLayer as JOutput
from deeplearning4j_tpu.nn.model import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.ops import flash_attention as jfa
from deeplearning4j_tpu.serving import ContinuousBatcher as JBatcher
from deeplearning4j_tpu.serving import PagedGenerativeEngine as JPaged
from deeplearning4j_tpu.serving.kv_pool import PagedKVPool as JPool
from deeplearning4j_tpu.serving.kv_pool import PoolExhausted as JExhausted
from deeplearning4j_tpu_torch.nn.layers import attention as att
from deeplearning4j_tpu_torch.nn.model import MultiLayerNetwork
from deeplearning4j_tpu_torch.ops import flash_attention as fa
from deeplearning4j_tpu_torch.serving.batcher import ContinuousBatcher
from deeplearning4j_tpu_torch.serving.engine import (GenerativeEngine,
                                                     PagedGenerativeEngine)
from deeplearning4j_tpu_torch.serving.kv_pool import (PagedKVPool,
                                                      PoolExhausted,
                                                      prompt_key)
from deeplearning4j_tpu_torch.serving.server import JsonModelServer

V = 16
TOL = 1e-5
TIE_TOL = 1e-5
P = 8
#: the prefix mix: one 11-token system prompt (not page-aligned) on five
#: streams, two slots
SYS = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5]
PAGED = dict(slots=2, max_cache_len=32, min_cache_len=32, max_new_tokens=5,
             paged=True, page_size=P)
SPEC_PROMPTS = [[1, 2, 3], [4, 5, 6, 7], [8, 9], [10, 11, 12, 13, 14]]
SPEC_NEW = 6


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


def _jax_lm(seed):
    conf = (JConf.builder().seed(seed).input_type(JInputType.recurrent(V, 8))
            .list(jatt.SelfAttentionLayer(n_out=V, n_heads=2),
                  JDense(n_out=24, activation="relu"),
                  jatt.SelfAttentionLayer(n_out=24, n_heads=2),
                  JOutput(n_out=V, activation="softmax"))
            .build())
    return JMLN(conf).init()


@pytest.fixture(scope="module")
def nets(tmp_path_factory):
    """``{"jax": (target, draft), "port": (target, draft)}``: the port's
    nets loaded on the CPU from the JAX nets' ZIPs."""
    d = tmp_path_factory.mktemp("paged")
    out = {"jax": [], "port": []}
    for seed in (0, 99):
        jn = _jax_lm(seed)
        path = str(d / f"lm{seed}.zip")
        jn.save(path)
        out["jax"].append(jn)
        out["port"].append(MultiLayerNetwork.load(path, device="cpu"))
    return out


def _one_hot(tokens):
    return np.eye(V, dtype=np.float32)[np.asarray(tokens) % V]


def _teacher_forced_agrees(pn, prompt, ours, theirs):
    """True when the streams are equal, or part only at a near-tie of the
    port's teacher-forced logits (see the module docstring)."""
    if ours == theirs:
        return True
    j = next(i for i, (a, b) in enumerate(zip(ours, theirs)) if a != b)
    seq = _one_hot(list(prompt) + ours[:j])[None]
    with torch.inference_mode():
        y = pn._full_context(pn.params, torch.from_numpy(seq), pn.state,
                             torch.tensor([len(prompt)]),
                             torch.tensor([seq.shape[1]])).numpy()
    top = np.sort(y[0, -1])[-2:]
    return float(top[1] - top[0]) < TIE_TOL * float(top[1])


# ------------------------------------------------------------------ ops

def test_paged_ops_match_jax_bit_for_bit():
    rng = np.random.default_rng(12)
    H, d, NP = 2, 4, 6
    pool = rng.standard_normal((NP * P, H, d)).astype(np.float32)
    pool[:P] = 0.0  # the zero page
    pt = np.array([[1, 2, 0], [3, 4, 5], [0, 0, 0]], np.int32)
    pos = np.array([[0, 7, 8, 30], [-1, 9, 23, 24], [0, 1, 2, 3]], np.int32)
    tpt = torch.from_numpy(pt)
    np.testing.assert_array_equal(
        fa.paged_positions(tpt, torch.from_numpy(pos), P).numpy(),
        np.asarray(jfa.paged_positions(jnp.asarray(pt), pos, P)))
    np.testing.assert_array_equal(
        fa.paged_gather(torch.from_numpy(pool), tpt, P).numpy(),
        np.asarray(jfa.paged_gather(jnp.asarray(pool), jnp.asarray(pt), P)))
    np.testing.assert_array_equal(
        fa.page_rows(torch.tensor([0, 3, 5]), P).numpy(),
        np.asarray(jfa.page_rows(np.array([0, 3, 5]), P)))
    new = rng.standard_normal((3, H, 3, d)).astype(np.float32)
    # a clamped write past the table, a stale length on a gated row, and
    # (last) a gated row over the zero page beside active rows on their
    # own pages, which leaves the zero page zero
    for lengths, write in (([0, 5, 2], None), ([22, 99, 1], [1, 0, 0]),
                           ([6, 20, 40], [1, 1, 0])):
        ln = np.asarray(lengths, np.int32)
        wr = None if write is None else np.asarray(write, np.int32)
        t = torch.from_numpy(pool.copy())
        out = fa.paged_insert(t, torch.from_numpy(new), torch.from_numpy(ln),
                              tpt, P,
                              None if wr is None else torch.from_numpy(wr))
        assert out is t  # in place
        want = np.asarray(jfa.paged_insert(jnp.asarray(pool), new, ln,
                                           jnp.asarray(pt), P, wr))
        np.testing.assert_array_equal(out.numpy(), want)
    assert not out[:P].any()


# ----------------------------------------------------------------- pool

_OPS = st.lists(st.one_of(
    st.tuples(st.just("alloc"), st.integers(1, 3)),
    st.tuples(st.just("release"), st.integers(0, 7)),
    st.tuples(st.just("retain"), st.integers(0, 7)),
    st.tuples(st.just("register"), st.integers(0, 3), st.integers(0, 7)),
    st.tuples(st.just("lookup"), st.integers(0, 3)),
    st.tuples(st.just("fork"), st.integers(0, 2)),
    st.tuples(st.just("adopt"), st.integers(1, 3)),
    st.tuples(st.just("peek"), st.integers(0, 3))), min_size=1, max_size=40)


_POOL_IDS = itertools.count()


@settings(max_examples=60, deadline=None, derandomize=True, database=None)
@given(ops=_OPS)
def test_pool_matches_jax(ops):
    """The same operations on the port's pool and the JAX pool hand out
    the same pages and fail alike; refcounts and stats agree after every
    step."""
    ours = PagedKVPool(7, P)
    # the JAX pool's counters live in a process-wide registry under its
    # engine id: a fresh id per example
    theirs = JPool(7, P, engine_id=f"torch-port-parity-{next(_POOL_IDS)}")
    held = []  # page lists a caller holds a reference on (both pools)
    for op in ops:
        if op[0] in ("alloc", "adopt"):
            try:
                a = getattr(ours, op[0])(op[1])
            except PoolExhausted:
                with pytest.raises(JExhausted):
                    getattr(theirs, op[0])(op[1])
                continue
            assert getattr(theirs, op[0])(op[1]) == a
            held.append(a)
        elif op[0] == "peek":
            assert ours.peek_prefix(f"k{op[1]}") == \
                theirs.peek_prefix(f"k{op[1]}")
        elif op[0] == "release" and held:
            pages = held.pop(op[1] % len(held))
            ours.release(pages)
            theirs.release(pages)
        elif op[0] == "retain" and held:
            pages = list(held[op[1] % len(held)])
            ours.retain(pages)
            theirs.retain(pages)
            held.append(pages)
        elif op[0] == "register" and held:
            pages = held[op[2] % len(held)]
            logits = np.full(4, float(op[1]))
            ours.register_prefix(f"k{op[1]}", pages, 5, logits)
            theirs.register_prefix(f"k{op[1]}", pages, 5, logits)
        elif op[0] == "lookup":
            e, je = ours.lookup_prefix(f"k{op[1]}"), \
                theirs.lookup_prefix(f"k{op[1]}")
            assert (e is None) == (je is None)
            if e is not None:
                assert e.pages == je.pages and e.plen == je.plen
                np.testing.assert_array_equal(e.logits, je.logits)
                held.append(list(e.pages))
        elif op[0] == "fork":
            ours.note_fork(op[1])
            theirs.note_fork(op[1])
        np.testing.assert_array_equal(ours.ref_snapshot(),
                                      theirs.ref_snapshot())
        assert ours.stats() == theirs.stats()
        for p in range(7):
            assert ours.shared(p) == theirs.shared(p)


def test_pool_eviction_under_pressure():
    """A full free list evicts registry entries least recently used
    first; only live-pinned pages raise PoolExhausted."""
    pool = PagedKVPool(5, 8)
    a = pool.alloc(2)
    pool.register_prefix("p0", a, 10, np.zeros(4))
    pool.release(a)               # now only the registry pins them
    b = pool.alloc(2)
    assert pool.pages_free() == 0
    got = pool.alloc(2)           # pressure: evicts the registered prefix
    assert sorted(got) == sorted(a)
    assert pool.stats()["evictions"] == 1
    assert pool.lookup_prefix("p0") is None
    with pytest.raises(PoolExhausted):
        pool.alloc(1)
    pool.release(b)
    assert pool.pages_free() == 2
    with pytest.raises(ValueError, match="zero page"):
        PagedKVPool(1, 8)
    # adopt allocates as alloc does (evicting under pressure, all or
    # nothing) and counts the adopted pages apart; peek_prefix counts
    # nothing
    pool.register_prefix("p1", got, 10, np.zeros(4))
    pool.release(got)
    hits = dict(pool.stats())
    assert pool.peek_prefix("p1") and not pool.peek_prefix("p0")
    assert pool.stats() == hits
    adopted = pool.adopt(3)       # the 2 free pages and "p1"'s, evicted
    assert len(set(adopted)) == 3 and pool.stats()["adoptions"] == 3
    assert pool.stats()["evictions"] == 2 and not pool.peek_prefix("p1")
    with pytest.raises(PoolExhausted):
        pool.adopt(2)
    assert pool.stats()["adoptions"] == 3 and pool.pages_free() == 1


def test_prompt_key_is_the_jax_key():
    from deeplearning4j_tpu.serving.kv_pool import prompt_key as jkey
    x = _one_hot(SYS)
    assert prompt_key(x, 11) == jkey(x, 11)
    assert prompt_key(x, 10) != prompt_key(x, 11)


# --------------------------------------------------------------- engine

def _engines(nets, slots=3, max_cache=32, speculate=(3,)):
    pages = 1 + slots * (max_cache // P)
    jn, pn = nets["jax"][0], nets["port"][0]
    je = JPaged(jn, slots=slots, pages=pages, page_size=P,
                max_cache_len=max_cache)
    pe = PagedGenerativeEngine(pn, slots=slots, pages=pages, page_size=P,
                               max_cache_len=max_cache, device="cpu")
    je.warmup([8, 16, 32], [8, 16], speculate=speculate)
    pe.warmup([8, 16, 32], [8, 16], speculate=speculate)
    return je, pe


def test_paged_engine_matches_jax(nets):
    """Prefill, decode, verify and a paged horizon on the same page
    tables: the logits within TOL, the tables and lengths equal."""
    je, pe = _engines(nets)
    js, ps = je.new_state(8), pe.new_state(8)
    S = 3
    prompts = {0: [2, 7, 1, 8, 2, 8, 1, 8, 2, 8], 2: [5, 5, 3]}
    for slot, toks in prompts.items():
        n = -(-len(toks) // P)
        pj, pp = je.pool.alloc(n), pe.pool.alloc(n)
        assert pj == pp
        je.map_pages(js, slot, pj)
        pe.map_pages(ps, slot, pp)
        js, jl = je.prefill(js, _one_hot(toks), len(toks), slot)
        ps, pl = pe.prefill(ps, _one_hot(toks), len(toks), slot)
        np.testing.assert_allclose(pl, np.asarray(jl), atol=TOL, rtol=0)
    active = np.array([1, 0, 1], np.int32)
    rng = np.random.default_rng(3)

    def cow(n):
        pairs_j, pairs_p = [], []
        for s in (0, 2):
            pairs_j += je.prepare_write(js, s, n)
            pairs_p += pe.prepare_write(ps, s, n)
        assert pairs_j == pairs_p
        return je.fork(js, pairs_j), pe.fork(ps, pairs_p)

    for _ in range(3):  # single-token decode steps
        x = _one_hot(rng.integers(0, V, S))[:, None, :]
        js, ps = cow(1)
        js, jy = je.decode(js, x, active)
        ps, py = pe.decode(ps, x, active)
        np.testing.assert_allclose(py[[0, 2]], np.asarray(jy)[[0, 2]],
                                   atol=TOL, rtol=0)
    np.testing.assert_array_equal(ps.lengths, js.lengths)
    # a verify window of 3 across the first page boundary of slot 0
    js, ps = cow(3)
    x = _one_hot(rng.integers(0, V, (S, 3)))
    js, jy = je.verify(js, x, active)
    ps, py = pe.verify(ps, x, active)
    assert py.shape == (S, 3, V)
    np.testing.assert_allclose(py[[0, 2]], np.asarray(jy)[[0, 2]], atol=TOL,
                               rtol=0)
    np.testing.assert_array_equal(ps.lengths, js.lengths)  # not advanced
    # a paged horizon of 3 from the same state
    js, ps = cow(3)
    x = _one_hot(rng.integers(0, V, S))[:, None, :]
    js, jr = je.pdecode_multi(js, x, active, 3)
    ps, pr = pe.pdecode_multi(ps, x, active, 3)
    jt, jlg, jem = jr.fetch()
    pt, plg, pem = pr.fetch()
    np.testing.assert_array_equal(pem, jem)
    np.testing.assert_allclose(plg[:, [0, 2]], jlg[:, [0, 2]], atol=TOL,
                               rtol=0)
    np.testing.assert_array_equal(pt[:, [0, 2]], jt[:, [0, 2]])
    np.testing.assert_array_equal(ps.page_table, js.page_table)
    st = pe.stats()
    # the horizon was not warmed (warm-up ran the single-token steps)
    assert st["cold_calls"] == 1
    # one warm-up verify per table-width bucket (1, 2 and 4 pages), one here
    assert st["verify_steps"] == 3 + 1 and st["paged"] == je.pool.stats()


def test_grow_copies_nothing_and_fork_copies_the_pairs(nets):
    _, pe = _engines(nets)
    st = pe.new_state(8)
    assert st.mp == 1 and st.cache_len == 8
    leaves = [t for lv in st.caches.values() for t in lv.values()]
    with torch.inference_mode():  # the pools are inference tensors
        for t in leaves:  # distinct page contents
            t.copy_(torch.randn(t.shape, generator=torch.Generator()
                                .manual_seed(t.numel())))
        before = [t.clone() for t in leaves]
    grown = pe.grow(st, 17)
    assert grown.mp == 4 and grown.cache_len == 32
    assert grown.caches is st.caches and grown.page_table is st.page_table
    assert pe.grow(grown, 9) is grown
    assert pe.grow(grown, 1000).mp == pe.max_pages_per_slot
    calls = pe.stats()["fork_calls"]
    pe.fork(st, [(2, 5), (3, 7)])
    for t, b in zip(leaves, before):
        want = b.clone()
        want[5 * P:6 * P] = b[2 * P:3 * P]
        want[7 * P:8 * P] = b[3 * P:4 * P]
        assert torch.equal(t, want)
    assert pe.fork(st, []) is st and pe.stats()["fork_calls"] == calls + 1
    with pytest.raises(ValueError, match="max_cache_len"):
        pe.prepare_write(st, 0, 33)
    # page export and import: whole pages in page order, one gather a
    # chunk and leaf, bucketed as the JAX engine buckets (3 pages over no
    # warmed bucket: one call of 4; then 6 pages over the bucket 4 that
    # ran: 4 + 2)
    now = [t.clone() for t in leaves]
    calls = pe.stats()["calls"]
    payload = pe.export_pages(st, [5, 7, 1])
    assert pe.stats()["calls"] == calls + 1
    flat = [t for lv in payload.values() for t in lv.values()]
    for t, b in zip(flat, now):
        assert t.device.type == "cpu" and t.dtype == b.dtype
        assert torch.equal(t, torch.cat([b[5 * P:6 * P], b[7 * P:8 * P],
                                         b[P:2 * P]]))
    pe.import_pages(st, [2, 9, 4], payload)
    assert pe.stats()["calls"] == calls + 2
    for t, b in zip(leaves, now):
        want = b.clone()
        want[2 * P:3 * P] = b[5 * P:6 * P]
        want[9 * P:10 * P] = b[7 * P:8 * P]
        want[4 * P:5 * P] = b[P:2 * P]
        assert torch.equal(t, want)          # the zero page untouched
    six = pe.export_pages(st, [1, 2, 3, 4, 5, 6])
    assert pe.stats()["calls"] == calls + 4
    assert all(torch.equal(t[:P], b[P:2 * P]) for t, b in zip(
        [t for lv in six.values() for t in lv.values()], leaves))
    with pytest.raises(ValueError, match="one or more page ids"):
        pe.export_pages(st, [0])
    with pytest.raises(ValueError, match="head-count"):
        pe.import_pages(st, [2], payload)   # 3 pages of rows for 1 page
    # the ops against JAX's, bit for bit: padding rows (page 0) gated off
    pool = leaves[0].clone()
    rows = fa.page_rows(torch.tensor([3, 0, 0]), P)
    gate = torch.repeat_interleave(torch.tensor([True, False, False]), P)
    pay = torch.randn((3 * P,) + tuple(pool.shape[1:]),
                      generator=torch.Generator().manual_seed(3))
    np.testing.assert_array_equal(
        fa.page_export(pool, rows).numpy(),
        np.asarray(jfa.page_export(jnp.asarray(pool.numpy()),
                                   jnp.asarray(rows.numpy()))))
    want = np.asarray(jfa.page_import(
        jnp.asarray(pool.numpy()), jnp.asarray(rows.numpy()),
        jnp.asarray(pay.numpy()), jnp.asarray(gate.numpy())))
    assert fa.page_import(pool, rows, pay, gate) is pool   # in place
    np.testing.assert_array_equal(pool.numpy(), want)
    assert torch.equal(pool[:P], leaves[0][:P])      # page 0 as it was


def test_paged_engine_equals_the_contiguous_one_bit_for_bit(nets):
    """``tests/test_paged_kv.py:179-290`` in the port: random join, leave,
    step and growth with a shared-then-forked prefix give the contiguous
    engine's logits bit for bit."""
    pn = nets["port"][0]
    slots, max_cache = 3, 32
    ce = GenerativeEngine(pn, slots=slots, device="cpu").warmup(
        [8, 16, 32], [8])
    pe = PagedGenerativeEngine(pn, slots=slots,
                               pages=1 + slots * (max_cache // P) + 2,
                               page_size=P, max_cache_len=max_cache,
                               device="cpu").warmup([8, 16, 32], [8])
    cs, ps = ce.new_state(8), pe.new_state(8)
    rng = np.random.default_rng(4)
    prompts = [_one_hot(rng.integers(0, V, n)) for n in (3, 5, 6)]
    ops = [("admit", 0), ("step",), ("admit", 0), ("step",), ("step",)]
    for _ in range(16):
        roll = rng.random()
        ops.append(("admit", int(rng.integers(0, 3))) if roll < 0.3 else
                   ("leave", int(rng.integers(0, 3))) if roll < 0.45 else
                   ("step",))
    live, pending = [False] * slots, [0] * slots
    lengths = np.zeros(slots, np.int64)
    for op in ops:
        if op[0] == "admit":
            free = [i for i in range(slots) if not live[i]]
            if not free:
                continue
            slot, prompt = free[0], prompts[op[1]]
            cs, cl = ce.prefill(cs, prompt, len(prompt), slot)
            hit = pe.pool.lookup_prefix(f"p{op[1]}")
            if hit is not None:
                pe.map_pages(ps, slot, hit.pages)
                ps.lengths[slot] = len(prompt)
                pl = hit.logits.copy()
            else:
                pages = pe.pool.alloc(-(-len(prompt) // P))
                pe.map_pages(ps, slot, pages)
                ps, pl = pe.prefill(ps, prompt, len(prompt), slot)
                pe.pool.register_prefix(f"p{op[1]}", pages, len(prompt), pl)
            np.testing.assert_array_equal(cl, pl)
            live[slot], lengths[slot] = True, len(prompt)
            pending[slot] = int(np.argmax(pl))
        elif op[0] == "leave":
            slot = op[1] % slots
            if live[slot]:
                live[slot], lengths[slot] = False, 0
                pe.pool.release(pe.release_slot(ps, slot))
        else:
            cur = [i for i in range(slots) if live[i]]
            if not cur:
                continue
            if int(lengths[cur].max()) + 1 > cs.cache_len:
                cs = ce.grow(cs, cs.cache_len + 1)
                ps = pe.grow(ps, ps.cache_len + 1)
            assert cs.cache_len == ps.cache_len
            active = np.array(live, np.int32)
            x = np.zeros((slots, 1, V), np.float32)
            for i in cur:
                x[i, 0] = _one_hot(pending[i])
            cs, cl = ce.decode(cs, x, active)
            pairs = []
            for i in cur:
                pairs += pe.prepare_write(ps, i, 1)
            ps = pe.fork(ps, pairs)
            ps, pl = pe.decode(ps, x, active)
            for i in cur:
                np.testing.assert_array_equal(cl[i], pl[i])
                lengths[i] += 1
                pending[i] = int(np.argmax(pl[i]))
    st = pe.pool.stats()
    assert st["prefix_hits"] >= 1 and st["forks"] >= 1


# -------------------------------------------------------------- batcher

def _serve(cb, prompts, max_new):
    """The streams of ``prompts`` submitted at once, and the front's stats
    with the prefills the port's engine ran for them (``prefills_served``,
    warm-up excluded; the JAX engine counts no prefills)."""
    p0 = getattr(cb.engine, "prefill_runs", 0)
    try:
        hs = [cb.submit(tokens=p, max_new_tokens=n)
              for p, n in zip(prompts, max_new)]
        out = [h.result(timeout=300)["tokens"] for h in hs]
        st = cb.stats()
        st["prefills_served"] = getattr(cb.engine, "prefill_runs", 0) - p0
        return out, st
    finally:
        cb.shutdown()


def test_prefix_mix_matches_jax_and_the_contiguous_batcher(nets):
    """Five streams of one system prompt on two slots: prefilled once,
    mapped four times, the partial page forked once per stream; the
    streams equal the JAX paged batcher's and the port's contiguous
    batcher's, and the pool's counters equal JAX's."""
    pn = nets["port"][0]
    prompts, new = [SYS] * 5, [5] * 5
    theirs, jst = _serve(JBatcher(nets["jax"][0], **PAGED), prompts, new)
    ours, st = _serve(ContinuousBatcher(pn, device="cpu", **PAGED),
                      prompts, new)
    contiguous, _ = _serve(ContinuousBatcher(
        pn, device="cpu", **{k: v for k, v in PAGED.items()
                             if k not in ("paged", "page_size")}),
        prompts, new)
    for a, b in zip(ours, theirs):
        assert _teacher_forced_agrees(pn, SYS, a, b), (a, b)
    assert ours == contiguous
    keys = ("prefix_hits", "prefix_misses", "forks", "pages_peak",
            "pages_in_use", "prefix_entries", "pages_total")
    assert {k: st["page_pool"][k] for k in keys} == \
        {k: jst["page_pool"][k] for k in keys}
    assert st["page_pool"]["prefix_misses"] == 1
    assert st["page_pool"]["prefix_hits"] == 4
    assert st["page_pool"]["forks"] == 5
    # the system prompt was prefilled once; the hits skipped prefill
    assert st["prefills_served"] == 1
    assert st["engine"]["cold_calls"] == 0


@pytest.mark.parametrize("draft", ["target", "other_seed"])
def test_speculative_streams_match_jax_and_greedy(nets, draft):
    """Draft and verify emit the target's greedy stream whatever the
    draft; the proposed and accepted counts equal the JAX batcher's."""
    pn = nets["port"][0]
    pd = pn if draft == "target" else nets["port"][1]
    jd = nets["jax"][0] if draft == "target" else nets["jax"][1]
    kw = dict(PAGED, max_new_tokens=SPEC_NEW, speculate_k=3)
    new = [SPEC_NEW] * len(SPEC_PROMPTS)
    greedy, _ = _serve(ContinuousBatcher(
        pn, device="cpu", **{k: v for k, v in kw.items()
                             if k not in ("paged", "page_size",
                                          "speculate_k")}),
        SPEC_PROMPTS, new)
    theirs, jst = _serve(JBatcher(nets["jax"][0], draft_model=jd, **kw),
                         SPEC_PROMPTS, new)
    fa.reset_counters()
    ours, st = _serve(ContinuousBatcher(pn, device="cpu", draft_model=pd,
                                        **kw), SPEC_PROMPTS, new)
    for p, a, b, g in zip(SPEC_PROMPTS, ours, theirs, greedy):
        assert len(a) == SPEC_NEW
        assert _teacher_forced_agrees(pn, p, a, b), (a, b)
        assert _teacher_forced_agrees(pn, p, a, g), (a, g)
    sp = st["speculative"]
    assert {k: sp[k] for k in ("k", "proposed", "accepted")} == \
        {k: jst["speculative"][k] for k in ("k", "proposed", "accepted")}
    if draft == "target":
        assert sp["accept_rate"] == 1.0
    else:
        assert sp["accept_rate"] < 1.0
    assert st["dispatch_decisions"]["speculative"] >= 1
    assert st["dispatch_decisions"]["on_device"] == 0
    # every verify window took the multi-query route, counted (two
    # attention layers per verify step)
    verify_steps = st["engine"]["verify_steps"]
    assert fa.decode_counters()["decode_multiquery_fallback"] == \
        2 * verify_steps and verify_steps >= 1
    assert fa.decode_counters()["decode_multiquery"] == 0
    assert st["engine"]["cold_calls"] == 0


def test_config_refusals(nets):
    """``tests/test_paged_kv.py:468-509``: a draft needs the paged engine,
    greedy tokens and ``speculate_k >= 2``; an explicit paged engine caps
    the batcher's cache bound."""
    pn = nets["port"][0]
    base = dict(slots=1, max_new_tokens=2, warmup=False, device="cpu")
    with pytest.raises(ValueError, match="paged"):
        ContinuousBatcher(pn, draft_model=pn, **base)
    with pytest.raises(ValueError, match="sample_fn"):
        ContinuousBatcher(pn, paged=True, draft_model=pn,
                          sample_fn=lambda lg: 0, **base)
    with pytest.raises(ValueError, match="speculate_k"):
        ContinuousBatcher(pn, paged=True, draft_model=pn, speculate_k=1,
                          **base)
    eng = PagedGenerativeEngine(pn, slots=1, pages=4, page_size=8,
                                max_cache_len=16, device="cpu")
    with pytest.raises(ValueError, match="max_cache_len"):
        ContinuousBatcher(pn, max_cache_len=64, engine=eng, warmup=False,
                          device="cpu")
    with pytest.raises(ValueError, match="engine"):
        ContinuousBatcher(pn, paged=True, engine=eng, warmup=False,
                          device="cpu")
    cb = ContinuousBatcher(pn, max_cache_len=16, min_cache_len=16,
                           max_new_tokens=2, engine=eng, warmup=False,
                           device="cpu")
    try:
        assert cb.paged and cb.stats()["page_pool"]["pages_total"] == 3
        with pytest.raises(ValueError, match="slack"):
            ContinuousBatcher(pn, max_cache_len=8, min_cache_len=8,
                              paged=True, draft_model=pn, speculate_k=2,
                              warmup=False, device="cpu").submit(
                tokens=[1, 2, 3], max_new_tokens=4)
    finally:
        cb.shutdown()
    # migrate_buckets warms each page count's export and import, rounded
    # up to a power of two
    cb = ContinuousBatcher(pn, paged=True, migrate_buckets=[1, 3],
                           max_cache_len=16, min_cache_len=16,
                           **dict(base, warmup=True))
    try:
        assert {("pexport", 1), ("pimport", 1), ("pexport", 4),
                ("pimport", 4)} <= cb.engine._warmed
        assert cb.stats()["pool"] == "default"
    finally:
        cb.shutdown()


def test_learned_attention_refuses_a_verify_window():
    lyr = att.LearnedSelfAttentionLayer(n_out=8, n_heads=2, n_queries=2)
    params, state, _ = lyr.initialize(torch.Generator().manual_seed(0),
                                      (8, V), torch.float32, "cpu")
    cache = {n: torch.zeros(s.shape) for n, s in
             lyr.decode_cache_spec(params, 2, 16, torch.float32).items()}
    with pytest.raises(ValueError, match="multi-token"):
        lyr.decode_step(params, torch.zeros(2, 3, V), state, cache=cache,
                        lengths=torch.tensor([1, 1]))


def test_an_exhausted_pool_fails_the_admission_and_leaks_nothing(nets):
    """A pool too small for a prompt fails that admission (the JAX
    package's ``serving.page_pool`` path, here without a fault site); the
    batcher then serves the next request and reclaims every page."""
    pn = nets["port"][0]
    cb = ContinuousBatcher(pn, slots=2, max_cache_len=32, min_cache_len=32,
                           max_new_tokens=3, paged=True, page_size=P,
                           pages=3, device="cpu")
    try:
        with pytest.raises(PoolExhausted):
            cb.generate(tokens=list(range(1, 16)) + [1, 2, 3])
        res = cb.generate(tokens=[1, 2], max_new_tokens=3)
        assert len(res["tokens"]) == 3
        st = cb.stats()
        assert st["failures"] >= 1
        assert st["page_pool"]["pages_in_use"] == 1  # the registered prompt
    finally:
        cb.shutdown()


def test_post_generate_through_a_paged_speculative_server(nets):
    pn = nets["port"][0]
    srv = JsonModelServer(pn, device="cpu", generate=dict(
        slots=2, max_cache_len=16, min_cache_len=16, max_new_tokens=3,
        paged=True, page_size=8, draft_model=pn, speculate_k=2))
    port = srv.start()
    try:
        body = json.dumps({"tokens": [1, 2, 3], "stream": True}).encode()
        with urllib.request.urlopen(urllib.request.Request(
                f"http://127.0.0.1:{port}/generate", data=body),
                timeout=120) as r:
            lines = [json.loads(x) for x in r.read().decode().splitlines()
                     if x]
        want = srv.generator.generate(tokens=[1, 2, 3])["tokens"]
        assert [x["token"] for x in lines[:-1]] == want
        assert lines[-1]["done"] and lines[-1]["tokens"] == want
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/stats",
                                    timeout=30) as r:
            gen = json.loads(r.read())["generate"]
        assert gen["page_pool"]["prefix_hits"] >= 1
        assert gen["speculative"]["k"] == 2
        assert gen["speculative"]["proposed"] > 0
    finally:
        srv.stop()
