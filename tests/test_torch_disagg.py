"""The port's disaggregated generative serving against the JAX package's,
on the CPU, on the tiny language model of ``tests/test_disagg.py:40-77``
(one-hot tokens, V = 16, ``SelfAttentionLayer(n_heads=2)``, a dense layer,
a softmax ``OutputLayer``; pages of 8 rows, caches of 32) saved by the JAX
package and loaded by the port.

- ``PagedGenerativeEngine.export_pages`` / ``import_pages`` bit for bit
  against the JAX engine's on the same pool contents.
- The wire form (version 1) bit for bit through a ``socket.socketpair()``:
  every payload leaf, the logits, the features and the metadata; a
  bfloat16 payload as its raw words, read by the JAX package as
  ``ml_dtypes`` bfloat16 with the same bits and back.
- Shipments cross the packages: one written by the JAX ``PrefillReplica``
  is adopted by the port's decode batcher, and one written by the port's
  replica by the JAX decode batcher; both give the JAX colocated
  oracle's tokens.
- Migrated tokens equal the colocated oracles' (the port's and JAX's);
  copy-on-write forks survive migration; mismatched shipments (page size,
  kv mode, layer tree, heads, dtype, page count, wire version) are refused
  before anything queues; the deadline re-arms after a slow handoff but
  still expires a queued migrated request; the router migrates once,
  then routes the repeat to the resident replica; per-pool health;
  an int8 replica's shipment is refused by an f32 decode pool and the
  other way round (int8 shipments: ``tests/test_torch_quantize.py``)."""

import socket
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn.config import InputType as JInputType
from deeplearning4j_tpu.nn.config import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.nn.layers.attention import SelfAttentionLayer as JSA
from deeplearning4j_tpu.nn.layers.core import DenseLayer as JDense
from deeplearning4j_tpu.nn.layers.core import OutputLayer as JOutput
from deeplearning4j_tpu.nn.model import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.serving import ContinuousBatcher as JBatcher
from deeplearning4j_tpu.serving import KVShipment as JShipment
from deeplearning4j_tpu.serving import PagedGenerativeEngine as JPaged
from deeplearning4j_tpu.serving import PrefillReplica as JReplica
from deeplearning4j_tpu_torch.nn.model import MultiLayerNetwork
from deeplearning4j_tpu_torch.serving import (DisaggRouter, KVShipment,
                                              PrefillReplica, read_msg,
                                              write_msg)
from deeplearning4j_tpu_torch.serving.batcher import (ContinuousBatcher,
                                                      DeadlineExceeded)
from deeplearning4j_tpu_torch.serving.engine import PagedGenerativeEngine

V = 16
PAGE = 8
CACHE = 32
PROMPTS = ([3, 1, 4, 1, 5, 9], [2, 7, 1, 8, 2, 8, 1, 8, 2])


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


def _jax_lm(seed=0, heads=2):
    conf = (JConf.builder().seed(seed)
            .input_type(JInputType.recurrent(V, 8))
            .list(JSA(n_out=V, n_heads=heads),
                  JDense(n_out=24, activation="relu"),
                  JOutput(n_out=V, activation="softmax"))
            .build())
    return JMLN(conf).init()


@pytest.fixture(scope="module")
def nets(tmp_path_factory):
    """``{"jax": net, "port": net, "port4": a 4-head port net}``: the
    port's nets loaded on the CPU from the JAX nets' ZIPs."""
    d = tmp_path_factory.mktemp("disagg")
    out = {}
    for name, heads in (("", 2), ("4", 4)):
        jn = _jax_lm(heads=heads)
        path = str(d / f"lm{heads}.zip")
        jn.save(path)
        out["jax" + name] = jn
        out["port" + name] = MultiLayerNetwork.load(path, device="cpu")
    return out


def _prompt(toks):
    return np.eye(V, dtype=np.float32)[np.asarray(toks, np.int64)]


def _replica(net, **kw):
    kw.setdefault("pages", 32)
    kw.setdefault("page_size", PAGE)
    kw.setdefault("max_cache_len", CACHE)
    kw.setdefault("prompt_buckets", [16])
    return PrefillReplica(net, device="cpu", **kw)


def _decoder(net, pool_label="decode", **kw):
    kw.setdefault("slots", 2)
    kw.setdefault("max_cache_len", CACHE)
    kw.setdefault("pages", 32)
    kw.setdefault("page_size", PAGE)
    kw.setdefault("max_new_tokens", 6)
    kw.setdefault("migrate_buckets", [1, 2])
    return ContinuousBatcher(net, paged=True, pool_label=pool_label,
                             device="cpu", **kw)


def _jax_kw():
    return dict(slots=2, max_cache_len=CACHE, pages=32, page_size=PAGE,
                max_new_tokens=6, paged=True, migrate_buckets=[1, 2])


@pytest.fixture(scope="module")
def jax_side(nets):
    """The JAX replica, its decode batcher and its colocated oracle's
    streams of ``PROMPTS``."""
    jn = nets["jax"]
    pre = JReplica(jn, pages=32, page_size=PAGE, max_cache_len=CACHE,
                   prompt_buckets=[16])
    dec = JBatcher(jn, pool_label="decode", **_jax_kw())
    oracle = JBatcher(jn, pool_label="colocated", **_jax_kw())
    try:
        want = [oracle.submit(prompt=_prompt(t)).result()["tokens"]
                for t in PROMPTS]
    finally:
        oracle.shutdown()
    yield {"pre": pre, "dec": dec, "want": want}
    dec.shutdown()


def _leaves(payload):
    return {(str(l), n): a for l, lv in payload.items() for n, a in lv.items()}


# ------------------------------------------------------------ the engine

def test_export_import_bit_for_bit_against_jax(nets):
    jn, pn = nets["jax"], nets["port"]
    je = JPaged(jn, slots=1, pages=12, page_size=PAGE, max_cache_len=CACHE)
    pe = PagedGenerativeEngine(pn, slots=1, pages=12, page_size=PAGE,
                               max_cache_len=CACHE, device="cpu")
    js, ps = je.new_state(CACHE), pe.new_state(CACHE)
    rng = np.random.default_rng(4)
    fill = {}
    with torch.inference_mode():
        for si, lv in ps.caches.items():
            for n, t in lv.items():
                a = rng.standard_normal(tuple(t.shape)).astype(np.float32)
                a[:PAGE] = 0.0
                t.copy_(torch.from_numpy(a))
                fill[(si, n)] = a
    js.caches = {si: {n: jnp.asarray(fill[(si, n)]) for n in lv}
                 for si, lv in js.caches.items()}
    pages = [7, 2, 9]
    got, want = _leaves(pe.export_pages(ps, pages)), \
        _leaves(je.export_pages(js, pages))
    assert set(got) == set(want)
    for k, t in got.items():
        np.testing.assert_array_equal(t.numpy(), want[k])
    # the JAX engine's payload into other pages of both pools
    jpay = je.export_pages(js, [1, 4])
    for k, t in _leaves(pe.export_pages(ps, [1, 4])).items():
        np.testing.assert_array_equal(t.numpy(), _leaves(jpay)[k])
    ps = pe.import_pages(ps, [3, 11], jpay)
    js = je.import_pages(js, [3, 11], jpay)
    for si, lv in ps.caches.items():
        for n, t in lv.items():
            np.testing.assert_array_equal(t.numpy(),
                                          np.asarray(js.caches[si][n]))
    # the same number of device calls on the same sequence
    assert pe.stats()["calls"] == je.stats()["calls"] == 3


# -------------------------------------------------------------- the wire

def _through_socket(blob):
    a, b = socket.socketpair()
    try:
        t = threading.Thread(target=write_msg, args=(a, blob))
        t.start()
        got = read_msg(b)
        t.join()
    finally:
        a.close()
        b.close()
    return got


def test_wire_round_trip_bit_for_bit(nets):
    pre = _replica(nets["port"], ship_features=True)
    ship = pre.prefill(_prompt(PROMPTS[1]))
    blob = ship.to_bytes()
    back = KVShipment.from_bytes(_through_socket(blob))
    assert back.to_bytes() == blob
    for f in ("page_size", "plen", "pages", "kv_quant", "prefix_key",
              "trace_id", "elapsed_s", "phase_total_s"):
        assert getattr(back, f) == getattr(ship, f), f
    assert back.plen == 9 and len(back.pages) == 2
    np.testing.assert_array_equal(back.logits, ship.logits)
    np.testing.assert_array_equal(back.x, ship.x)
    got, want = _leaves(back.payload), _leaves(ship.payload)
    assert set(got) == set(want) and all(
        torch.equal(got[k], want[k]) and got[k].dtype == torch.float32
        for k in got)
    # a torn frame fails loudly
    a, b = socket.socketpair()
    a.sendall(blob[:20])
    a.close()
    with pytest.raises(ConnectionError):
        read_msg(b)
    b.close()


def test_bfloat16_payload_crosses_as_raw_words():
    rng = np.random.default_rng(5)
    leaf = torch.from_numpy(rng.standard_normal((16, 2, 8)).astype(
        np.float32)).to(torch.bfloat16)
    ship = KVShipment(8, 11, [3, 5], {"0": {"k": leaf, "v": -leaf}},
                      np.zeros(4, np.float32), prefix_key="p")
    blob = ship.to_bytes()
    theirs = JShipment.from_bytes(blob)
    arr = theirs.payload["0"]["k"]
    assert arr.dtype.name == "bfloat16"
    np.testing.assert_array_equal(arr.view(np.uint16),
                                  leaf.view(torch.int16).numpy()
                                  .view(np.uint16))
    back = KVShipment.from_bytes(theirs.to_bytes())
    assert back.to_bytes() == blob
    assert back.payload["0"]["v"].dtype == torch.bfloat16
    assert torch.equal(back.payload["0"]["v"], -leaf)


# ------------------------------------------------------ across packages

def test_a_jax_shipment_is_adopted_by_the_port(nets, jax_side):
    dec = _decoder(nets["port"])
    warm = dec.stats()["engine"]["prefill_runs"]
    try:
        for toks, want in zip(PROMPTS, jax_side["want"]):
            ship = KVShipment.from_bytes(
                jax_side["pre"].prefill(_prompt(toks)).to_bytes())
            assert dec.submit_prefilled(ship).result()["tokens"] == want
        st = dec.stats()
        assert st["pool"] == "decode"
        assert st["engine"]["paged"]["adoptions"] == 3
        assert st["engine"]["prefill_runs"] == warm   # none decode-side
        assert st["engine"]["cold_calls"] == 0
    finally:
        dec.shutdown()


def test_a_port_shipment_is_adopted_by_jax(nets, jax_side):
    pre = _replica(nets["port"])
    for toks, want in zip(PROMPTS, jax_side["want"]):
        ship = JShipment.from_bytes(pre.prefill(_prompt(toks)).to_bytes())
        got = jax_side["dec"].submit_prefilled(ship).result()["tokens"]
        assert got == want


def test_migrated_tokens_match_the_colocated_oracles(nets, jax_side):
    pn = nets["port"]
    pre = _replica(pn)
    dec = _decoder(pn)
    oracle = _decoder(pn, pool_label="colocated", migrate_buckets=[])
    try:
        for toks, want in zip(PROMPTS, jax_side["want"]):
            x = _prompt(toks)
            ours = oracle.submit(prompt=x).result()["tokens"]
            got = dec.submit_prefilled(pre.prefill(x)).result()["tokens"]
            assert got == ours == want and len(got) == 6
        assert dec.stats()["engine"]["paged"]["adoptions"] == 3
        assert pre.stats()["engine"]["prefill_runs"] == 2 + 1  # + warm-up
    finally:
        dec.shutdown()
        oracle.shutdown()


def test_forks_survive_migration(nets, jax_side):
    """Two streams decoding off the SAME migrated prefix each fork the
    shared tail page privately, and draining every stream leaves only the
    registry's references (``tests/test_disagg.py:139-169``)."""
    pn = nets["port"]
    pre = _replica(pn)
    dec = _decoder(pn)
    x = _prompt(PROMPTS[0])
    want = jax_side["want"][0]
    try:
        ship = pre.prefill(x)
        assert dec.submit_prefilled(ship).result()["tokens"] == want
        h1, h2 = dec.submit(prompt=x), dec.submit(prompt=x)
        assert h1.result()["tokens"] == want == h2.result()["tokens"]
        ps = dec.engine.pool.stats()
        assert ps["prefix_hits"] >= 2 and ps["forks"] >= 2
        assert ps["adoptions"] == len(ship.pages)
        assert ps["pages_in_use"] == len(ship.pages)
    finally:
        dec.shutdown()
    assert pre.stats()["engine"]["paged"]["prefix_entries"] == 1


# ------------------------------------------------------------- refusals

def test_mismatched_shipments_are_refused_loudly(nets):
    pn = nets["port"]
    pre = _replica(pn)
    ship = pre.prefill(_prompt([1, 2, 3, 4, 5]))
    dec = _decoder(pn, warmup=False)
    wrong_page = _decoder(pn, page_size=16, warmup=False)
    wrong_heads = _decoder(nets["port4"], warmup=False)
    try:
        with pytest.raises(ValueError, match="page-size mismatch"):
            wrong_page.submit_prefilled(ship)
        with pytest.raises(ValueError, match="head-count"):
            wrong_heads.submit_prefilled(ship)

        def variant(**kw):
            args = dict(page_size=ship.page_size, plen=ship.plen,
                        pages=ship.pages, payload=ship.payload,
                        logits=ship.logits)
            args.update(kw)
            return KVShipment(**args)

        layer = next(iter(ship.payload))
        cases = [
            (variant(kv_quant=True), "quantization modes"),
            (variant(payload={}), "layer tree"),
            (variant(payload={layer: {"k": ship.payload[layer]["k"]}}),
             "layer tree"),
            (variant(payload={"7": ship.payload[layer]}), "layer tree"),
            (variant(payload={layer: {n: t.double() for n, t in
                                      ship.payload[layer].items()}}),
             "dtype"),
            (variant(plen=ship.plen + ship.page_size), "pages for plen"),
        ]
        for bad, match in cases:
            with pytest.raises(ValueError, match=match):
                dec.submit_prefilled(bad)
        assert dec.stats()["requests"] == 0       # nothing queued
        assert dec.engine.pool.stats()["adoptions"] == 0
    finally:
        for cb in (dec, wrong_page, wrong_heads):
            cb.shutdown()
    blob = bytearray(ship.to_bytes())
    header = bytes(blob[8:8 + int.from_bytes(blob[:8], "little")])
    blob[8:8 + len(header)] = header.replace(b'"v": 1', b'"v": 2')
    with pytest.raises(ValueError, match="wire version"):
        KVShipment.from_bytes(bytes(blob))
    blob = bytearray(ship.to_bytes())
    blob[8:9] = b"x"                              # a corrupt header
    with pytest.raises(Exception):
        KVShipment.from_bytes(bytes(blob))
    with pytest.raises(ValueError, match="truncated"):
        KVShipment.from_bytes(ship.to_bytes()[:-4])


def test_only_a_plain_paged_front_adopts(nets):
    pn = nets["port"]
    ship = _replica(pn).prefill(_prompt([1, 2, 3]))
    plain = ContinuousBatcher(pn, slots=1, max_cache_len=CACHE,
                              warmup=False, device="cpu")
    spec = ContinuousBatcher(pn, slots=1, max_cache_len=CACHE, paged=True,
                             page_size=PAGE, draft_model=pn, speculate_k=2,
                             warmup=False, device="cpu")
    try:
        with pytest.raises(ValueError, match="paged engine"):
            plain.submit_prefilled(ship)
        with pytest.raises(ValueError, match="draft"):
            spec.submit_prefilled(ship)
    finally:
        plain.shutdown()
        spec.shutdown()
    with pytest.raises(ValueError, match="max_cache_len"):
        dec = _decoder(pn, warmup=False)
        try:
            dec.submit_prefilled(ship, max_new_tokens=CACHE)
        finally:
            dec.shutdown()


def test_int8_raises_naming_its_item(nets):
    """int8 pools are ported (item 7): a shipment crosses only between
    pools of the same kv mode, refused before anything queues."""
    pn = nets["port"]
    ship8 = _replica(pn, kv_cache="int8").prefill(_prompt([1, 2, 3]))
    ship = _replica(pn).prefill(_prompt([1, 2, 3]))
    assert ship8.kv_quant and not ship.kv_quant
    dec8 = _decoder(pn, kv_cache="int8", warmup=False)
    dec = _decoder(pn, warmup=False)
    try:
        for d, s in ((dec, ship8), (dec8, ship)):
            with pytest.raises(ValueError, match="quantization modes"):
                d.submit_prefilled(s)
    finally:
        dec8.shutdown()
        dec.shutdown()


# ------------------------------------------------------------- deadlines

def test_deadline_rearms_after_a_slow_handoff(nets):
    """A handoff far longer than ``deadline_ms`` does not expire the
    request (the decode pool's clock starts at ``submit_prefilled``), and
    TTFT still spans it; the re-armed clock still bounds the decode-queue
    wait: a migrated request queued behind a busy slot expires."""
    pn = nets["port"]
    pre = _replica(pn)
    dec = _decoder(pn, slots=1)
    x = _prompt(PROMPTS[0])
    try:
        ship = pre.prefill(x)
        time.sleep(0.25)                  # a handoff 5x the budget
        ship.elapsed_s += 0.25
        out = dec.submit_prefilled(ship, deadline_ms=50.0).result()
        assert len(out["tokens"]) == 6
        assert dec.stats()["ttft_ms_p50"] >= 250.0
        ship2 = pre.prefill(_prompt([2, 7, 1, 8, 2]))
        stall = dec.submit(prompt=x, max_new_tokens=24)
        h = dec.submit_prefilled(ship2, deadline_ms=1.0)
        with pytest.raises(DeadlineExceeded):
            h.result()
        stall.result()
        assert dec.stats()["deadline_expired"] >= 1
    finally:
        dec.shutdown()


# ---------------------------------------------------------------- router

def test_router_migrates_once_then_hits_the_resident_replica(nets,
                                                              jax_side):
    pn = nets["port"]
    pre = _replica(pn)
    d0, d1 = _decoder(pn), _decoder(pn)
    warm = [d.stats()["engine"]["prefill_runs"] for d in (d0, d1)]
    x = _prompt(PROMPTS[0])
    want = jax_side["want"][0]
    try:
        with DisaggRouter([pre], [d0, d1], max_new_tokens=6) as router:
            assert router.generate(prompt=x)["tokens"] == want
            st = router.stats()
            assert (st["migrations"], st["routed_prefill"],
                    st["routed_prefix_hit"]) == (1, 1, 0)
            # the same prompt again: its resident decode replica, no
            # prefill, no second migration
            assert router.generate(tokens=PROMPTS[0])["tokens"] == want
            st = router.stats()
            assert (st["migrations"], st["routed_prefill"],
                    st["routed_prefix_hit"]) == (1, 1, 1)
            assert sum(d.stats()["engine"]["paged"]["adoptions"]
                       for d in (d0, d1)) == 1
            assert [d.stats()["engine"]["prefill_runs"]
                    for d in (d0, d1)] == warm
            health = router.health()
            assert set(health) == {"router", "prefill", "decode"}
            assert all(v == "HEALTHY" for v in health.values())
            # an expired router deadline fails in the router's queue
            h = router.submit(prompt=_prompt([5, 5]), deadline_ms=-1.0)
            with pytest.raises(DeadlineExceeded):
                h.result(timeout=30)
            assert router.health()["router"] == "DEGRADED"
    finally:
        d0.shutdown()
        d1.shutdown()
