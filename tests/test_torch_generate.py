"""The port's generative serving path against the JAX package's, on the
CPU, on a tiny attention language model like
``tests/test_generative_decode.py::_lm`` (one-hot tokens, V = 16, two
``SelfAttentionLayer(n_heads=2)`` blocks with a dense layer between, a
softmax ``OutputLayer``), saved by the JAX package and loaded by the port.

- ``output``, ``_prefill`` and N ``_decode_step`` calls agree with the JAX
  package's within 2e-5 (float32, the JAX suite's decode-parity
  tolerance), and with the port's own ``_full_context`` (the prefix-LM
  oracle); ``LearnedSelfAttentionLayer``'s decode too; an LSTM stack
  refuses the decode walk.
- ``GenerativeEngine.grow`` keeps the state bit for bit; ``decode``
  leaves an inactive slot's cache rows bit for bit.
- ``ContinuousBatcher``'s greedy token streams equal the JAX package's
  ``ContinuousBatcher`` on the same weights and prompts, on the horizon
  front and on the host loop. Both run float32 on the CPU in other sum
  orders, so a stream may part from JAX's only at a near-tie: where the
  two differ, the port's teacher-forced top-2 gap there must be below
  ``TIE_TOL`` of the top probability.
- Join and leave mid-batch, EOS (emitted, then the slot freezes),
  ``max_new_tokens``, both deadline semantics (enqueue -> admission;
  restarted at admission), shedding, a raising ``sample_fn``, and POST
  /generate's NDJSON stream.
- ``sampling.greedy`` equals ``jnp.argmax`` and ``np.argmax`` (first
  maximum on ties); ``categorical`` and ``top_k`` draw from the softmax
  of the (filtered) logits over many draws (the random streams differ
  from JAX's, so only distributions are compared)."""

import json
import time
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn.config import InputType as JInputType
from deeplearning4j_tpu.nn.config import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.nn.layers import attention as jatt
from deeplearning4j_tpu.nn.layers.core import DenseLayer as JDense
from deeplearning4j_tpu.nn.layers.core import OutputLayer as JOutput
from deeplearning4j_tpu.nn.model import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.ops import sampling as jsmp
from deeplearning4j_tpu.serving import ContinuousBatcher as JBatcher
from deeplearning4j_tpu_torch.models import text_generation_lstm
from deeplearning4j_tpu_torch.nn.layers import attention as att
from deeplearning4j_tpu_torch.nn.model import MultiLayerNetwork
from deeplearning4j_tpu_torch.ops import flash_attention as fa
from deeplearning4j_tpu_torch.ops import sampling as smp
from deeplearning4j_tpu_torch.serving.batcher import (ContinuousBatcher,
                                                      DeadlineExceeded,
                                                      QueueFull)
from deeplearning4j_tpu_torch.serving.engine import GenerativeEngine
from deeplearning4j_tpu_torch.serving.server import JsonModelServer

V = 16
TOL = 2e-5
#: a stream may part from JAX's only where the port's top-2 gap is below
#: this share of the top probability (float32 sums in another order move
#: the outputs by ~1e-7 of their size)
TIE_TOL = 1e-5
PROMPTS = [[1, 2, 3], [4, 5], [6, 7, 8, 9, 10], [11], [12, 13, 14, 15]]
MAX_NEW = [4, 3, 5, 2, 4]
BATCH = dict(slots=2, max_cache_len=16, min_cache_len=8, max_new_tokens=4)


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


def _jax_lm():
    conf = (JConf.builder().seed(0).input_type(JInputType.recurrent(V, 8))
            .list(jatt.SelfAttentionLayer(n_out=V, n_heads=2),
                  JDense(n_out=24, activation="relu"),
                  jatt.SelfAttentionLayer(n_out=24, n_heads=2),
                  JOutput(n_out=V, activation="softmax"))
            .build())
    return JMLN(conf).init()


@pytest.fixture(scope="module")
def nets(tmp_path_factory):
    """(the JAX net, the port's net loaded from the JAX net's ZIP on the
    CPU)."""
    jn = _jax_lm()
    path = str(tmp_path_factory.mktemp("lm") / "lm.zip")
    jn.save(path)
    return jn, MultiLayerNetwork.load(path, device="cpu")


@pytest.fixture(scope="module")
def jax_streams(nets):
    """The JAX package's ContinuousBatcher's greedy streams on PROMPTS."""
    cb = JBatcher(nets[0], **BATCH)
    try:
        hs = [cb.submit(tokens=p, max_new_tokens=n)
              for p, n in zip(PROMPTS, MAX_NEW)]
        return [h.result(timeout=300)["tokens"] for h in hs]
    finally:
        cb.shutdown()


def _prompts(B, lo=2, hi=7, seed=7):
    rng = np.random.default_rng(seed)
    plens = rng.integers(lo, hi, B)
    x = np.zeros((B, 8, V), np.float32)
    for b in range(B):
        x[b, :plens[b]] = np.eye(V, dtype=np.float32)[
            rng.integers(0, V, plens[b])]
    return x, plens


def _one_hot(tokens):
    return np.eye(V, dtype=np.float32)[np.asarray(tokens) % V]


# ------------------------------------------------------------- decode walk

def test_output_matches_jax(nets):
    jn, pn = nets
    x, _ = _prompts(3)
    np.testing.assert_allclose(pn.output(x), np.asarray(jn.output(x)),
                               atol=TOL, rtol=0)


def test_prefill_and_decode_steps_match_jax_and_full_context(nets):
    jn, pn = nets
    B, C, steps = 4, 16, 6
    x, plens = _prompts(B)
    jc = jn.init_decode_cache(B, C)
    jy, jc = jn._prefill(jn.params, jnp.asarray(x), jn.state, jc, plens)
    pc = pn.init_decode_cache(B, C)
    with torch.inference_mode():
        py, pc = pn._prefill(pn.params, torch.from_numpy(x), pn.state, pc,
                             torch.from_numpy(plens))
    np.testing.assert_allclose(py.numpy(), np.asarray(jy), atol=TOL, rtol=0)
    for si in pc:  # the prompt's rows, bucket padding included
        for name in ("k", "v"):
            np.testing.assert_allclose(pc[si][name].numpy(),
                                       np.asarray(jc[si][name]), atol=TOL,
                                       rtol=0)
    lengths = plens.copy()
    seq = np.zeros((B, C, V), np.float32)
    seq[:, :8] = x
    y = py.numpy()
    for step in range(steps):
        last = y[np.arange(B), lengths - 1] if step == 0 else y[:, 0]
        x_t = _one_hot(np.argmax(last, -1))[:, None, :]
        jy, jc = jn._decode_step(jn.params, jnp.asarray(x_t), jn.state, jc,
                                 jnp.asarray(lengths))
        with torch.inference_mode():
            py, pc = pn._decode_step(
                pn.params, torch.from_numpy(x_t), pn.state, pc,
                torch.from_numpy(lengths.astype(np.int32)))
        y = py.numpy()
        np.testing.assert_allclose(y, np.asarray(jy), atol=TOL, rtol=0)
        for b in range(B):
            seq[b, lengths[b]] = x_t[b, 0]
        lengths = lengths + 1
        with torch.inference_mode():
            full = pn._full_context(
                pn.params, torch.from_numpy(seq[:, :int(lengths.max())]),
                pn.state, torch.from_numpy(plens),
                torch.from_numpy(lengths)).numpy()
        np.testing.assert_allclose(y[:, 0], full[np.arange(B), lengths - 1],
                                   atol=TOL, rtol=0)


def test_the_ports_zip_loads_in_the_jax_package(nets, tmp_path):
    jn, pn = nets
    path = str(tmp_path / "port.zip")
    pn.save(path)
    back = JMLN.load(path)
    x, _ = _prompts(2, seed=5)
    np.testing.assert_array_equal(np.asarray(back.output(x)),
                                  np.asarray(jn.output(x)))


def test_learned_self_attention_decode_matches_jax():
    jl = jatt.LearnedSelfAttentionLayer(n_out=8, n_heads=2, n_queries=3)
    jp, js, _ = jl.initialize(jax.random.PRNGKey(0), (8, V), jnp.float32)
    pl = att.LearnedSelfAttentionLayer(n_out=8, n_heads=2, n_queries=3)
    pp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    B, C = 2, 16
    plens = np.array([3, 5])
    x, _ = _prompts(B, seed=3)
    mask = (np.arange(8)[None] < plens[:, None]).astype(np.float32)
    jc = jax.tree.map(lambda a: jnp.zeros(a.shape, a.dtype),
                      jl.decode_cache_spec(jp, B, C, jnp.float32))
    _, jc = jl.prefill(jp, jnp.asarray(x), js, cache=jc,
                       lengths=jnp.asarray(plens), mask=mask)
    pc = {n: torch.zeros(s.shape) for n, s in
          pl.decode_cache_spec(pp, B, C, torch.float32).items()}
    fa.reset_counters()
    with torch.inference_mode():
        _, pc = pl.prefill(pp, torch.from_numpy(x), {}, cache=pc,
                           lengths=torch.from_numpy(plens),
                           mask=torch.from_numpy(mask))
        lengths = plens.copy()
        seq = np.zeros((B, C, V), np.float32)
        seq[:, :8] = x
        for step in range(3):
            x_t = np.random.default_rng(step).standard_normal(
                (B, 1, V)).astype(np.float32)
            jy, jc = jl.decode_step(jp, jnp.asarray(x_t), js, cache=jc,
                                    lengths=jnp.asarray(lengths))
            py, pc = pl.decode_step(pp, torch.from_numpy(x_t), {}, cache=pc,
                                    lengths=torch.from_numpy(lengths))
            np.testing.assert_allclose(py.numpy(), np.asarray(jy), atol=TOL,
                                       rtol=0)
            for b in range(B):
                seq[b, lengths[b]] = x_t[b, 0]
            lengths = lengths + 1
            t = int(lengths.max())
            m2 = (np.arange(t)[None] < lengths[:, None]).astype(np.float32)
            ref, _, _ = pl.apply(pp, torch.from_numpy(seq[:, :t]), {},
                                 mask=torch.from_numpy(m2))
            np.testing.assert_allclose(py.numpy(), ref.numpy(), atol=TOL,
                                       rtol=0)
    # three query rows: the length-masked reference on every device
    assert fa.decode_counters()["decode_fallback_multiquery"] == 3


def test_an_lstm_stack_refuses_the_decode_walk():
    net = text_generation_lstm(vocab_size=V, units=8).init(device="cpu")
    with pytest.raises(ValueError, match="decode"):
        net.decode_cache_spec(2, 16)
    with pytest.raises(ValueError, match="decode"):
        GenerativeEngine(net, slots=2, device="cpu")


def test_decode_token_features_equal_the_host_one_hot(nets):
    pn = nets[1]
    toks = torch.tensor([0, 5, 15, 16, 37, -1], dtype=torch.int32)
    got = pn.decode_token_features(toks)
    assert got.dtype == torch.float32 and tuple(got.shape) == (6, 1, V)
    want = np.stack([np.eye(V, dtype=np.float32)[int(t) % V]
                     for t in toks])[:, None, :]
    np.testing.assert_array_equal(got.numpy(), want)


def test_paged_and_int8_raise(nets):
    """The int8 KV cache, contiguous or paged, is ported (int8 values and
    f32 per-row scales, ``tests/test_torch_quantize.py``); an unknown kv
    mode raises, as in the JAX package."""
    pn = nets[1]
    spec = pn.decode_cache_spec(2, 8, kv_quant=True)
    for leaves in spec.values():
        assert leaves["k"].dtype == torch.int8
        assert leaves["k_scale"].dtype == torch.float32
        assert tuple(leaves["k_scale"].shape) == \
            tuple(leaves["k"].shape[:3]) + (1,)
    pool = pn.init_paged_cache(4, 8, kv_quant=True)
    assert all(tuple(t["v_scale"].shape)[-1] == 1 for t in pool.values())
    assert pn.paged_cache_spec(4, 8, kv_quant=True).keys() == pool.keys()
    for call in (lambda: GenerativeEngine(pn, kv_cache="int4", device="cpu"),
                 lambda: ContinuousBatcher(pn, paged=True, kv_cache="fp8",
                                           device="cpu")):
        with pytest.raises(ValueError, match="kv_cache"):
            call()


# ------------------------------------------------------------------ engine

def test_grow_preserves_the_state_bit_for_bit(nets):
    pn = nets[1]
    eng = GenerativeEngine(pn, slots=2, device="cpu").warmup([8, 16], [8])
    x, plens = _prompts(1, 4, 6)

    def gen(c0, steps):
        st = eng.new_state(c0)
        st, logits = eng.prefill(st, x[0], int(plens[0]), 0)
        toks = [int(np.argmax(logits))]
        x_t = np.zeros((2, 1, V), np.float32)
        active = np.array([1, 0], np.int32)
        length = int(plens[0])
        for _ in range(steps - 1):
            x_t[0, 0] = _one_hot(toks[-1])
            if length >= st.cache_len:
                st = eng.grow(st, st.cache_len + 1)
            st, lg = eng.decode(st, x_t, active)
            length += 1
            toks.append(int(np.argmax(lg[0])))
        return toks, st

    small, st_small = gen(8, 10)  # plen 4..5 + 9 tokens crosses 8 -> 16
    big, _ = gen(16, 10)
    assert small == big and st_small.cache_len == 16
    st = eng.new_state(8)
    st, _ = eng.prefill(st, x[0], int(plens[0]), 0)
    grown = eng.grow(st, 16)
    assert grown.cache_len == 16 and eng.grow(grown, 9) is grown
    for si in st.caches:
        for name in ("k", "v"):
            a, b = grown.caches[si][name], st.caches[si][name]
            assert a.shape[2] == 16
            assert torch.equal(a[:, :, :8], b)
            assert not a[:, :, 8:].any()
    assert eng.stats()["cold_calls"] == 0
    # 2 slots x 2 heads x 16 rows x (8 + 12 head columns) x (k, v) x f32
    assert eng.cache_bytes(9) == 2 * 2 * 16 * (8 + 12) * 2 * 4


def test_inactive_slot_rows_stay_bit_for_bit(nets):
    """Slot 0 decodes alone, then beside a neighbour that joins in slot 1
    and leaves: slot 0's logits and cache rows are the same bit for bit,
    and the gated slot's rows never change."""
    pn = nets[1]
    eng = GenerativeEngine(pn, slots=2, device="cpu").warmup([16], [8])
    x, plens = _prompts(2, 3, 6, seed=11)

    def run(neighbour):
        st = eng.new_state(16)
        st, lg = eng.prefill(st, x[0], int(plens[0]), 0)
        if neighbour:
            st, _ = eng.prefill(st, x[1], int(plens[1]), 1)
        x_t = np.zeros((2, 1, V), np.float32)
        x_t[:, 0] = _one_hot([3, 7])
        logits = []
        for step in range(4):
            active = np.array([1, 1 if neighbour and step < 2 else 0])
            frozen = {si: {n: t[1].clone() for n, t in lv.items()}
                      for si, lv in st.caches.items()}
            st, lg = eng.decode(st, x_t, active)
            logits.append(lg[0])
            if not active[1]:
                for si, lv in st.caches.items():
                    for n, t in lv.items():
                        assert torch.equal(t[1], frozen[si][n])
        return np.stack(logits), {si: {n: t[0].clone() for n, t in
                                       lv.items()}
                                  for si, lv in st.caches.items()}

    alone, rows_alone = run(False)
    crowded, rows_crowded = run(True)
    np.testing.assert_array_equal(alone, crowded)
    for si in rows_alone:
        for n in ("k", "v"):
            assert torch.equal(rows_alone[si][n], rows_crowded[si][n])


# ----------------------------------------------------------------- batcher

def _teacher_forced_agrees(pn, prompt, ours, theirs):
    """True when the streams are equal, or part only at a near-tie: at
    the first position they differ, the port's teacher-forced logits have
    their top two within TIE_TOL."""
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


@pytest.mark.parametrize("front", ["horizon", "host_loop"])
def test_batcher_streams_equal_jax(nets, jax_streams, front):
    pn = nets[1]
    kw = {} if front == "horizon" else {
        "sample_fn": lambda logits: int(np.argmax(logits))}
    fa.reset_counters()
    cb = ContinuousBatcher(pn, device="cpu", **BATCH, **kw)
    try:
        hs = [cb.submit(tokens=p, max_new_tokens=n)
              for p, n in zip(PROMPTS, MAX_NEW)]
        ours = [h.result(timeout=120)["tokens"] for h in hs]
        st = cb.stats()
    finally:
        cb.shutdown()
    for p, n, a, b in zip(PROMPTS, MAX_NEW, ours, jax_streams):
        assert len(a) == n
        assert _teacher_forced_agrees(pn, p, a, b), (p, a, b)
    key = "on_device" if front == "horizon" else "host_loop"
    other = "host_loop" if front == "horizon" else "on_device"
    assert st["dispatch_decisions"][key] >= 1
    assert st["dispatch_decisions"][other] == 0
    assert st["tokens_generated"] == sum(MAX_NEW)
    assert st["engine"]["cold_calls"] == 0
    assert st["ttft_ms_p50"] is not None and st["tpot_ms_p99"] is not None
    assert fa.decode_counters()["decode_fallback_platform"] >= 1


def test_join_and_leave_do_not_perturb_a_stream(nets):
    pn = nets[1]
    cb = ContinuousBatcher(pn, slots=4, max_cache_len=16, min_cache_len=16,
                           max_new_tokens=8, device="cpu")
    try:
        tok_a = [3, 1, 4, 1, 5]
        alone = cb.submit(tokens=tok_a, max_new_tokens=8).result(
            timeout=120)
        h_a = cb.submit(tokens=tok_a, max_new_tokens=8)
        stream = h_a.tokens(timeout=120)
        first = next(stream)
        h_b = cb.submit(tokens=[9, 2], max_new_tokens=2)
        h_c = cb.submit(tokens=[6, 5, 3, 5, 8, 9], max_new_tokens=3)
        crowded = [first] + list(stream)
        assert h_b.result(timeout=120)["tokens"]
        assert h_c.result(timeout=120)["tokens"]
        res = h_a.result(timeout=1)
        assert crowded == alone["tokens"] == res["tokens"]
        np.testing.assert_array_equal(res["logits"], alone["logits"])
    finally:
        cb.shutdown()


@pytest.mark.parametrize("front", ["horizon", "host_loop"])
def test_eos_is_emitted_then_the_slot_stops(nets, front):
    pn = nets[1]
    kw = {} if front == "horizon" else {
        "sample_fn": lambda logits: int(np.argmax(logits))}
    cb = ContinuousBatcher(pn, device="cpu", **BATCH, **kw)
    try:
        prompt = [2, 9, 4]
        full = cb.generate(tokens=prompt, max_new_tokens=6)["tokens"]
        assert len(full) == 6  # max_new_tokens caps the stream
        j = max(i for i, t in enumerate(full) if t not in full[:i])
        stopped = cb.generate(tokens=prompt, max_new_tokens=6,
                              eos_id=full[j])["tokens"]
        assert stopped == full[:j + 1]
        other = cb.submit(tokens=[7, 7], max_new_tokens=5)
        assert len(other.result(timeout=120)["tokens"]) == 5
    finally:
        cb.shutdown()


def _slow_argmax(delay):
    def sample(logits):
        time.sleep(delay)
        return int(np.argmax(logits))
    return sample


def test_admission_deadline_expires_in_the_queue(nets):
    cb = ContinuousBatcher(nets[1], slots=1, max_cache_len=32,
                           min_cache_len=32, max_new_tokens=20,
                           sample_fn=_slow_argmax(0.01), device="cpu")
    try:
        blocker = cb.submit(tokens=[1, 2], max_new_tokens=20)
        starved = cb.submit(tokens=[3, 4], max_new_tokens=2,
                            deadline_ms=1.0)
        with pytest.raises(DeadlineExceeded):
            starved.result(timeout=120)
        assert len(blocker.result(timeout=120)["tokens"]) == 20
        st = cb.stats()
        assert st["deadline_expired"] == 1 and st["health"] == "DEGRADED"
    finally:
        cb.shutdown()


def test_admission_deadline_restarts_at_admission(nets):
    """An admitted generation is never expired: 20 tokens of at least
    20 ms each run far past the 150 ms deadline and complete."""
    cb = ContinuousBatcher(nets[1], slots=1, max_cache_len=32,
                           min_cache_len=32, max_new_tokens=20,
                           deadline_ms=150.0, sample_fn=_slow_argmax(0.02),
                           device="cpu")
    try:
        res = cb.submit(tokens=[1, 2, 3], max_new_tokens=20).result(
            timeout=120)
        assert len(res["tokens"]) == 20
        assert cb.stats()["deadline_expired"] == 0
    finally:
        cb.shutdown()


def test_shedding_rejects_in_the_callers_thread(nets):
    cb = ContinuousBatcher(nets[1], slots=1, max_cache_len=32,
                           min_cache_len=32, max_new_tokens=16,
                           shed_queue_depth=1, sample_fn=_slow_argmax(0.02),
                           device="cpu")
    try:
        cb.submit(tokens=[1], max_new_tokens=16)
        for _ in range(500):  # until the blocker owns the one slot
            if cb.active_slots() == 1:
                break
            time.sleep(0.005)
        cb.submit(tokens=[2], max_new_tokens=2)  # waits in the queue
        with pytest.raises(QueueFull):
            for _ in range(50):
                cb.submit(tokens=[3], max_new_tokens=2)
                time.sleep(0.002)
        st = cb.stats()
        assert st["shed"] >= 1 and st["health"] == "SHEDDING"
    finally:
        cb.shutdown()


def test_a_raising_sample_fn_does_not_kill_the_worker(nets):
    calls = {"n": 0}

    def flaky(logits):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("bad sampler")
        return int(np.argmax(logits))

    cb = ContinuousBatcher(nets[1], device="cpu", sample_fn=flaky, **BATCH)
    try:
        h1 = cb.submit(tokens=[1, 2], max_new_tokens=3)
        with pytest.raises(RuntimeError, match="bad sampler"):
            h1.result(timeout=120)
        with pytest.raises(RuntimeError, match="bad sampler"):
            list(h1.tokens(timeout=10))
        res = cb.submit(tokens=[3, 4], max_new_tokens=3).result(timeout=120)
        assert len(res["tokens"]) == 3
        assert cb.active_slots() == 0 and cb.stats()["failures"] >= 1
    finally:
        cb.shutdown()


def test_a_failed_decode_fails_the_live_requests_and_recovers(nets,
                                                              monkeypatch):
    """A decode that raises part-way leaves a consumed state: every live
    request gets the error, the batcher rebuilds a fresh state, and the
    next request is served exactly as before."""
    pn = nets[1]
    cb = ContinuousBatcher(pn, device="cpu", **BATCH)
    try:
        want = cb.generate(tokens=[5, 6], max_new_tokens=3)["tokens"]
        eng = cb.engine
        real = eng._decode_multi_into

        def broken(*a, **k):
            raise RuntimeError("device lost")
        monkeypatch.setattr(eng, "_decode_multi_into", broken)
        with pytest.raises(RuntimeError, match="device lost"):
            cb.generate(tokens=[1, 2], max_new_tokens=3)
        monkeypatch.setattr(eng, "_decode_multi_into", real)
        assert cb.generate(tokens=[5, 6], max_new_tokens=3)["tokens"] == want
        assert cb.stats()["failures"] >= 1
    finally:
        cb.shutdown()


def test_submit_validates_in_the_callers_thread(nets):
    cb = ContinuousBatcher(nets[1], device="cpu", **BATCH)
    try:
        with pytest.raises(ValueError, match="features"):
            cb.submit(prompt=np.zeros((3, V + 1), np.float32))
        with pytest.raises(ValueError, match="max_cache_len"):
            cb.submit(tokens=[1] * 10, max_new_tokens=10)
    finally:
        cb.shutdown()


def test_generate_route_streams_ndjson(nets):
    pn = nets[1]
    srv = JsonModelServer(pn, device="cpu", generate=BATCH)
    port = srv.start()
    try:
        for prompt in ([1, 2, 3], [8], [4, 4, 9, 2]):
            body = json.dumps({"tokens": prompt, "max_new_tokens": 4,
                               "stream": True}).encode()
            r = urllib.request.urlopen(urllib.request.Request(
                f"http://127.0.0.1:{port}/generate", data=body), timeout=60)
            assert r.headers["Content-Type"] == "application/x-ndjson"
            lines = [json.loads(x) for x in r.read().decode().splitlines()
                     if x]
            assert lines[-1]["done"] is True
            assert [x["index"] for x in lines[:-1]] == [0, 1, 2, 3]
            want = srv.generator.generate(tokens=prompt,
                                          max_new_tokens=4)["tokens"]
            assert [x["token"] for x in lines[:-1]] == \
                lines[-1]["tokens"] == want
        body = json.dumps({"tokens": [5], "max_new_tokens": 2}).encode()
        r = urllib.request.urlopen(urllib.request.Request(
            f"http://127.0.0.1:{port}/generate", data=body), timeout=60)
        assert len(json.loads(r.read())["tokens"]) == 2
        stats = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{port}/stats", timeout=60).read())
        assert stats["generate"]["tokens_generated"] >= 3 * 4 * 2 + 2
        bad = json.dumps({"tokens": [1] * 30}).encode()
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(urllib.request.Request(
                f"http://127.0.0.1:{port}/generate", data=bad), timeout=60)
        assert err.value.code == 400
    finally:
        srv.stop()


def test_generate_route_turns_a_mid_stream_failure_into_an_error_line(nets):
    calls = {"n": 0}

    def second_token_fails(logits):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("sampler broke")
        return int(np.argmax(logits))

    srv = JsonModelServer(nets[1], device="cpu",
                          generate=dict(BATCH, sample_fn=second_token_fails))
    port = srv.start()
    try:
        body = json.dumps({"tokens": [1, 2], "max_new_tokens": 4,
                           "stream": True}).encode()
        r = urllib.request.urlopen(urllib.request.Request(
            f"http://127.0.0.1:{port}/generate", data=body), timeout=60)
        lines = [json.loads(x) for x in r.read().decode().splitlines() if x]
        assert lines[0] == {"index": 0, "token": lines[0]["token"]}
        assert lines[-1] == {"error": "RuntimeError: sampler broke"}
        # the front keeps serving
        body = json.dumps({"tokens": [3], "max_new_tokens": 2}).encode()
        r = urllib.request.urlopen(urllib.request.Request(
            f"http://127.0.0.1:{port}/generate", data=body), timeout=60)
        assert len(json.loads(r.read())["tokens"]) == 2
    finally:
        srv.stop()


# ---------------------------------------------------------------- sampling

def test_greedy_is_bit_exact_with_jax_and_numpy():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((64, 33)).astype(np.float32)
    logits[::3, 5] = logits[::3, 20] = 9.0  # ties: the first maximum wins
    got = smp.greedy(torch.from_numpy(logits))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.argmax(logits, -1))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jsmp.greedy(jnp.asarray(logits))))
    assert (got.numpy()[::3] == 5).all()


def _draws(fn, logits, n=20000):
    gen = torch.Generator().manual_seed(0)
    x = torch.from_numpy(np.repeat(logits[None], n, 0))
    return np.bincount(fn(x, gen).numpy(), minlength=logits.shape[0]) / n


def test_categorical_and_top_k_draw_from_the_softmax():
    logits = np.array([1.0, 0.5, -0.3, 2.0, 0.0], np.float32)
    for t in (1.0, 0.5):
        p = np.exp(logits / t)
        p /= p.sum()
        freq = _draws(lambda x, g: smp.categorical(x, g, t), logits)
        np.testing.assert_allclose(freq, p, atol=0.015)
    freq = _draws(lambda x, g: smp.top_k(x, g, 2, 1.0), logits)
    p = np.where(np.isin(np.arange(5), [0, 3]), np.exp(logits), 0.0)
    np.testing.assert_allclose(freq, p / p.sum(), atol=0.015)
    spec = smp.SamplingSpec("top_k", temperature=0.7, k=3)
    assert spec.stochastic and spec.static_key() == ("top_k", 3)
    assert not smp.GREEDY.stochastic
    with pytest.raises(ValueError):
        smp.SamplingSpec("top_k")
    toks = torch.tensor([3, 5, 1], dtype=torch.int32)
    eos = torch.tensor([3, -1, 2], dtype=torch.int32)
    np.testing.assert_array_equal(
        smp.eos_hit(toks, eos).numpy(),
        np.asarray(jsmp.eos_hit(jnp.asarray(toks.numpy()),
                                jnp.asarray(eos.numpy()))))
