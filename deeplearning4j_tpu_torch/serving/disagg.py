"""Disaggregated generative serving: a PREFILL pool and a DECODE pool
joined by KV-page migration, with a router that owns admission.

Port of ``deeplearning4j_tpu/serving/disagg.py``. Prefill (bound by
compute, bursty, long) and decode (bound by memory, steady, short) stall
each other in a colocated batcher: one long prefill delays every decode
iteration admitted behind it. Here each phase runs in its own pool:

- :class:`PrefillReplica` runs ``PagedGenerativeEngine`` prefill ONLY (K3
  in each attention layer on the card) and ships the prompt's pages as a
  :class:`KVShipment`: one ``[n_pages * page_size, H, d]`` block of token
  rows per layer leaf, the page handoff, the prefill logits and the
  prefix-registry key.
- The decode pool's ``ContinuousBatcher.submit_prefilled`` ADOPTS the
  shipment: its pool hands out fresh pages (``PagedKVPool.adopt``), the
  payload scatters in bucketed calls (``import_pages``), and the prompt
  registers under the SHIPPED key, so the next identical prompt on that
  pool reuses the migrated pages.
- :class:`DisaggRouter` owns admission: a prompt resident in a decode
  pool's registry (``peek_prefix``, which counts nothing) goes straight
  to that replica; any other prompt prefills on the prefill replica with
  the most headroom and is adopted by the decode replica with the most
  free pages, read from ONE ``ref_snapshot()`` per decode pool per
  routing round.
- Deadlines: the router's ``deadline_ms`` bounds submit -> prefill
  admission; the decode pool RE-ARMS its clock at ``submit_prefilled``,
  so a slow handoff never expires prefill work already paid for.

The wire form is pickle-free and the JAX package's, version 1: a JSON
header and the raw buffers (:meth:`KVShipment.to_bytes` /
:meth:`KVShipment.from_bytes`), framed for a stream socket by
:func:`write_msg` / :func:`read_msg`. A shipment written by either package
is read by the other. Payload leaves are CPU tensors in the pool's dtype;
a bfloat16 pool (which numpy cannot hold) travels as its raw 2-byte words
under the header dtype ``"bfloat16"``, the name the JAX package's
``ml_dtypes`` arrays carry. An int8 pool (``kv_cache="int8"``) ships its
int8 value leaves and its f32 per-row ``k_scale``/``v_scale`` leaves, with
``kv_quant`` in the header; a pool of the other mode refuses the shipment
in :meth:`KVShipment.validate_for`.

Divergences from the JAX module:

- Counters are plain integers (the port has no telemetry registry yet,
  ROADMAP.md Queue 1 item 9), so there are no ``serving.disagg.*`` cells.
- There is no request trace (item 9): ``trace_id`` is carried as a field
  of the shipment, and ``phase_total_s`` is the sum of the replica's own
  phase timings (queue, prefill, export).
- ``attribution_report`` is not ported (item 9): ``_report_fractions``
  returns None, and scoring takes the JAX module's own fallback of 0.5.
- ``PrefillReplica.prefill`` runs on the caller's thread (the router's
  admission thread), which sets the engine's card itself, as the
  batcher's worker does.
"""

from __future__ import annotations

import contextlib
import json
import queue
import struct
import threading
import time
import uuid
from collections import deque
from concurrent.futures import Future
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .batcher import DeadlineExceeded, HealthState, QueueFull, ShutdownError
from .engine import (PagedGenerativeEngine, _dtype_name, _host_tensor,
                     next_bucket)
from .kv_pool import prompt_key


# --------------------------------------------------------------------- wire

def write_msg(sock, data: bytes) -> None:
    """One length-prefixed frame on a stream socket (the shipment
    channel)."""
    sock.sendall(struct.pack("<Q", len(data)) + data)


def read_msg(sock) -> bytes:
    """Read one :func:`write_msg` frame; raises ConnectionError on EOF
    mid-frame (a torn shipment fails loudly, never truncates)."""
    buf = b""
    while len(buf) < 8:
        chunk = sock.recv(8 - len(buf))
        if not chunk:
            raise ConnectionError("channel closed reading frame header")
        buf += chunk
    (n,) = struct.unpack("<Q", buf)
    parts: List[bytes] = []
    got = 0
    while got < n:
        chunk = sock.recv(min(1 << 20, n - got))
        if not chunk:
            raise ConnectionError(
                f"channel closed mid-frame ({got}/{n} bytes)")
        parts.append(chunk)
        got += len(chunk)
    return b"".join(parts)


def _leaf_bytes(t: torch.Tensor) -> bytes:
    """The raw buffer of a CPU tensor (bfloat16 as its 2-byte words)."""
    t = t.contiguous()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy().tobytes()


def _leaf_from(buf: bytes, shape, dtype: str) -> torch.Tensor:
    """A CPU tensor from a raw buffer and the header's dtype name."""
    if dtype == "bfloat16":
        a = np.frombuffer(buf, np.int16).reshape(shape).copy()
        return torch.from_numpy(a).view(torch.bfloat16)
    return torch.from_numpy(np.frombuffer(buf, dtype).reshape(shape).copy())


class KVShipment:
    """One migrated prompt's KV pages and handoff metadata.

    ``payload`` mirrors the engine's ``paged_cache_spec``: ``{layer:
    {name: [n_pages * page_size, H, d]}}`` in the page order of ``pages``,
    held as CPU tensors (numpy arrays given here are wrapped).
    ``elapsed_s`` is the origin-side wall time from the origin submit to
    the shipment and back-dates the decode pool's ``t_enqueue``;
    ``phase_total_s`` is the sum of the origin's phase timings."""

    __slots__ = ("page_size", "plen", "pages", "payload", "logits",
                 "prefix_key", "x", "kv_quant", "trace_id", "elapsed_s",
                 "phase_total_s")

    def __init__(self, page_size: int, plen: int, pages: Sequence[int],
                 payload, logits, prefix_key: Optional[str] = None,
                 x=None, kv_quant: bool = False,
                 trace_id: Optional[str] = None,
                 elapsed_s: float = 0.0, phase_total_s: float = 0.0):
        self.page_size = int(page_size)
        self.plen = int(plen)
        self.pages = [int(p) for p in pages]
        self.payload = {layer: {name: _host_tensor(a)
                                for name, a in leaves.items()}
                        for layer, leaves in payload.items()} \
            if isinstance(payload, dict) else payload
        self.logits = np.asarray(logits)
        self.prefix_key = prefix_key
        self.x = None if x is None else np.asarray(x, np.float32)
        self.kv_quant = bool(kv_quant)
        self.trace_id = trace_id
        self.elapsed_s = float(elapsed_s)
        self.phase_total_s = float(phase_total_s)

    # ------------------------------------------------------------ validation
    def validate_for(self, engine: PagedGenerativeEngine) -> None:
        """Loud structural rejection BEFORE the request queues: a
        page-size, quantization-mode, layer-tree, head-count or dtype
        mismatch between pools, or a page count that does not cover
        ``plen``, raises ValueError here, not inside a device scatter."""
        if self.page_size != int(engine.page_size):
            raise ValueError(
                f"page-size mismatch: shipment pages are {self.page_size} "
                f"tokens, receiving pool uses {engine.page_size}")
        if self.kv_quant != bool(engine._kv_quant):
            raise ValueError(
                "kv_cache quantization modes disagree across pools: "
                f"shipment int8={self.kv_quant}, receiving engine "
                f"int8={bool(engine._kv_quant)}")
        engine.check_payload(self.payload, len(self.pages))
        if -(-self.plen // self.page_size) != len(self.pages):
            raise ValueError(
                f"shipment carries {len(self.pages)} pages for plen "
                f"{self.plen} (page_size {self.page_size})")

    # --------------------------------------------------------- serialization
    def _leaf_iter(self):
        # layer keys stay exactly as the pool spec spells them (strings)
        for layer in sorted(self.payload, key=str):
            for name in sorted(self.payload[layer]):
                yield layer, name, self.payload[layer][name]

    def to_bytes(self) -> bytes:
        """The wire form (version 1, the JAX package's): an 8-byte header
        length, the JSON header, then the raw buffers of the logits, the
        optional prompt features and every payload leaf in sorted (layer,
        name) order."""
        leaves = []
        bufs = [np.ascontiguousarray(self.logits).tobytes()]
        if self.x is not None:
            bufs.append(np.ascontiguousarray(self.x).tobytes())
        for layer, name, t in self._leaf_iter():
            leaves.append({"layer": layer, "name": name,
                           "shape": list(t.shape), "dtype": _dtype_name(t)})
            bufs.append(_leaf_bytes(t))
        header = {
            "v": 1,
            "page_size": self.page_size,
            "plen": self.plen,
            "pages": self.pages,
            "kv_quant": self.kv_quant,
            "prefix_key": self.prefix_key,
            "trace_id": self.trace_id,
            "elapsed_s": self.elapsed_s,
            "phase_total_s": self.phase_total_s,
            "logits": {"shape": list(self.logits.shape),
                       "dtype": np.dtype(self.logits.dtype).name},
            "x": None if self.x is None else
                 {"shape": list(self.x.shape), "dtype": "float32"},
            "leaves": leaves,
        }
        hj = json.dumps(header).encode("utf-8")
        return struct.pack("<Q", len(hj)) + hj + b"".join(bufs)

    @classmethod
    def from_bytes(cls, data: bytes) -> "KVShipment":
        (hn,) = struct.unpack("<Q", data[:8])
        header = json.loads(data[8:8 + hn].decode("utf-8"))
        if header.get("v") != 1:
            raise ValueError(f"unknown KVShipment wire version "
                             f"{header.get('v')!r}")
        off = 8 + hn

        def take(shape, dtype):
            nonlocal off
            size = 2 if dtype == "bfloat16" else np.dtype(dtype).itemsize
            n = int(np.prod(shape or [1])) * size
            if off + n > len(data):
                raise ValueError("KVShipment truncated: the header names "
                                 "more bytes than the message holds")
            t = _leaf_from(data[off:off + n], shape, dtype)
            off += n
            return t

        lg = take(header["logits"]["shape"], header["logits"]["dtype"])
        logits = (lg.float() if lg.dtype == torch.bfloat16 else lg).numpy()
        x = None
        if header["x"] is not None:
            x = take(header["x"]["shape"], header["x"]["dtype"]).numpy()
        payload: Dict[str, Dict[str, torch.Tensor]] = {}
        for leaf in header["leaves"]:
            payload.setdefault(leaf["layer"], {})[leaf["name"]] = \
                take(leaf["shape"], leaf["dtype"])
        return cls(header["page_size"], header["plen"], header["pages"],
                   payload, logits, prefix_key=header["prefix_key"],
                   x=x, kv_quant=header["kv_quant"],
                   trace_id=header["trace_id"],
                   elapsed_s=header["elapsed_s"],
                   phase_total_s=header["phase_total_s"])


def _new_trace_id() -> str:
    return uuid.uuid4().hex[:16]


class PrefillReplica:
    """A prefill-pool replica: ``PagedGenerativeEngine`` prefill ONLY, and
    the prompt's pages shipped. Its own prefix registry makes a repeated
    prompt free on this side too: a registered prompt exports its resident
    pages without prefilling again.

    ``prompt_buckets`` set both the warmed prefills and the warmed
    migration page counts. ``device`` follows the port's rule (``cuda``
    unless the caller asks for ``cpu``) and must be the model's."""

    def __init__(self, model, pages: int = 64, page_size: int = 16,
                 max_cache_len: int = 256,
                 prompt_buckets: Optional[Sequence[int]] = None,
                 quantize: Optional[str] = None,
                 kv_cache: Optional[str] = None,
                 prefix_cache: bool = True,
                 ship_features: bool = False,
                 pool_label: str = "prefill", device=None):
        self.engine = PagedGenerativeEngine(
            model, slots=1, pages=pages, page_size=page_size,
            max_cache_len=max_cache_len, quantize=quantize,
            kv_cache=kv_cache, device=device, pool_label=pool_label)
        self.pool_label = str(pool_label)
        self.prefix_cache = bool(prefix_cache)
        self.ship_features = bool(ship_features)
        P = self.engine.page_size
        pb = sorted({next_bucket(int(t)) for t in
                     (prompt_buckets or [max_cache_len])})
        self.engine.warmup(
            [max_cache_len], pb,
            migrate_buckets=sorted({-(-t // P) for t in pb}))
        self._state = self.engine.new_state(max_cache_len)
        self._lock = threading.Lock()
        self._inflight = 0
        self._events: deque = deque(maxlen=1024)
        dev = self.engine.device
        self._cuda_index = None if dev.type != "cuda" else (
            dev.index if dev.index is not None
            else torch.cuda.current_device())

    def note(self, kind: str) -> None:
        self._events.append((time.perf_counter(), kind))

    def health(self, window_s: float = 5.0) -> str:
        now = time.perf_counter()
        recent = {k for t, k in list(self._events) if now - t <= window_s}
        if "shed" in recent:
            return HealthState.SHEDDING
        if recent & {"failure", "retry", "deadline"}:
            return HealthState.DEGRADED
        return HealthState.HEALTHY

    def queue_depth(self) -> int:
        return self._inflight

    def prefill(self, prompt, plen: Optional[int] = None,
                t_origin: Optional[float] = None) -> KVShipment:
        """Prefill one prompt (or hit this replica's registry) and export
        its pages as a :class:`KVShipment`. Synchronous, on the caller's
        thread; ``t_origin`` is the origin submit's ``perf_counter``, so
        the shipment's elapsed time spans any router queue wait."""
        prompt = np.asarray(prompt, np.float32)
        if prompt.ndim == 3 and prompt.shape[0] == 1:
            prompt = prompt[0]
        plen = int(plen) if plen is not None else int(prompt.shape[0])
        eng = self.engine
        P = eng.page_size
        n_pages = -(-plen // P)
        t0 = time.perf_counter()
        origin = t_origin if t_origin is not None else t0
        phases = {"queue": t0 - origin}
        key = prompt_key(prompt, plen) if self.prefix_cache else None
        dev = contextlib.nullcontext() if self._cuda_index is None \
            else torch.cuda.device(self._cuda_index)
        self._inflight += 1
        try:
            with self._lock, dev:
                hit = eng.pool.lookup_prefix(key) \
                    if key is not None else None
                if hit is not None:
                    pages = list(hit.pages)
                    logits = hit.logits.copy()
                else:
                    t1 = time.perf_counter()
                    pages = eng.pool.alloc(n_pages)
                    try:
                        eng.map_pages(self._state, 0, pages)
                        self._state, logits = eng.prefill(
                            self._state, prompt, plen, 0)
                    except BaseException:
                        self._state.page_table[0, :] = 0
                        eng.pool.release(pages)
                        self.note("failure")
                        raise
                    if key is not None:
                        eng.pool.register_prefix(key, pages, plen, logits)
                    phases["prefill"] = time.perf_counter() - t1
                t2 = time.perf_counter()
                payload = eng.export_pages(self._state, pages)
                phases["export"] = time.perf_counter() - t2
                if hit is not None:
                    # lookup_prefix took a stream reference for us
                    eng.pool.release(pages)
                else:
                    # the registry's own reference keeps the pages
                    # resident; drop the stream's (an unregistered
                    # prompt's pages go back entirely)
                    eng.release_slot(self._state, 0)
                    eng.pool.release(pages)
        finally:
            self._inflight -= 1
        return KVShipment(
            P, plen, pages, payload, logits, prefix_key=key,
            x=prompt if self.ship_features else None,
            kv_quant=bool(eng._kv_quant),
            trace_id=_new_trace_id(), elapsed_s=time.perf_counter() - origin,
            phase_total_s=sum(phases.values()))

    def stats(self) -> dict:
        return {"pool": self.pool_label, "health": self.health(),
                "inflight": self._inflight,
                "engine": self.engine.stats()}


class RouterHandle:
    """The router's answer to ``GenerationHandle``: resolves to the decode
    pool's handle once routing lands; ``result()`` and ``tokens()``
    delegate. A routing failure (shed, deadline, structural rejection)
    surfaces through :meth:`result` as a batcher failure does."""

    def __init__(self):
        self._inner: Future = Future()
        self.trace_id: Optional[str] = None

    def _bind(self, handle, trace_id: Optional[str] = None) -> None:
        self.trace_id = trace_id
        self._inner.set_result(handle)

    def _fail(self, err: BaseException) -> None:
        if not self._inner.done():
            self._inner.set_exception(err)

    def result(self, timeout: Optional[float] = None) -> dict:
        return self._inner.result(timeout=timeout).result(timeout=timeout)

    def tokens(self, timeout: Optional[float] = None):
        handle = self._inner.result(timeout=timeout)
        return handle.tokens(timeout=timeout)


class _RouteRequest:
    __slots__ = ("prompt", "plen", "max_new", "deadline_ms", "eos_id",
                 "handle", "t_enqueue", "deadline")

    def __init__(self, prompt, plen, max_new, deadline_ms, eos_id):
        self.prompt = prompt
        self.plen = int(plen)
        self.max_new = max_new
        self.deadline_ms = deadline_ms
        self.eos_id = eos_id
        self.handle = RouterHandle()
        self.t_enqueue = time.perf_counter()
        # the ROUTER deadline bounds submit -> prefill admission; the
        # decode pool re-arms its own at submit_prefilled
        self.deadline = None if deadline_ms is None \
            else self.t_enqueue + deadline_ms / 1e3


class DisaggRouter:
    """Admission for a disaggregated topology: N prefill replicas and M
    decode replicas (paged ``ContinuousBatcher`` fronts).

    Per request:

    1. Probe every decode replica's registry (``peek_prefix``): a
       resident prompt goes to that replica's ordinary ``submit`` (its
       admission maps the resident pages; no prefill, no migration).
    2. Otherwise prefill on the prefill replica with the most headroom
       (queue depth breaks ties), then adopt on the decode replica with
       the most free pages less a queue-depth penalty, SHEDDING replicas
       left out.

    The admission thread drains up to ``round_limit`` queued requests a
    round and takes ONE ``ref_snapshot()`` per decode pool for the whole
    round. A stale snapshot can mis-rank a replica by a few pages, never
    corrupt admission (the batcher allocates under its own lock).
    ``health()`` reports the prefill pool, the decode pool and the router
    apart."""

    def __init__(self, prefills: Sequence[PrefillReplica],
                 decodes: Sequence, max_new_tokens: int = 32,
                 deadline_ms: Optional[float] = None,
                 shed_queue_depth: Optional[int] = None,
                 queue_limit: int = 256,
                 round_limit: int = 8,
                 health_window_s: float = 5.0):
        if not prefills or not decodes:
            raise ValueError("DisaggRouter needs >= 1 prefill and >= 1 "
                             "decode replica")
        self.prefills = list(prefills)
        self.decodes = list(decodes)
        for cb in self.decodes:
            if not getattr(cb, "paged", False):
                raise ValueError("decode replicas must serve paged engines "
                                 "(KV pages migrate)")
        self.max_new_tokens = int(max_new_tokens)
        self.deadline_ms = deadline_ms
        self.shed_queue_depth = None if shed_queue_depth is None \
            else int(shed_queue_depth)
        self.round_limit = max(1, int(round_limit))
        self.health_window = float(health_window_s)
        self._q: "queue.Queue[_RouteRequest]" = queue.Queue(
            maxsize=queue_limit)
        self._shutdown = threading.Event()
        self._events: deque = deque(maxlen=1024)
        self._counts = {"migrations": 0, "routed_prefill": 0,
                        "routed_prefix_hit": 0}
        self._worker = threading.Thread(target=self._loop, daemon=True,
                                        name="DisaggRouter-admission")
        self._worker.start()

    # ------------------------------------------------------------- admission
    def submit(self, prompt=None, tokens=None, plen: Optional[int] = None,
               max_new_tokens: Optional[int] = None,
               deadline_ms: Optional[float] = None,
               eos_id: Optional[int] = None) -> RouterHandle:
        """Enqueue one generation into the topology. Sheds in the caller's
        thread (``QueueFull``) at ``shed_queue_depth``, as the member
        fronts do."""
        if self._shutdown.is_set():
            raise ShutdownError("DisaggRouter is shut down")
        if tokens is not None:
            t2f = self.decodes[0].token_to_features
            prompt = np.stack([t2f(t) for t in tokens])
        prompt = np.asarray(prompt, np.float32)
        if prompt.ndim == 3 and prompt.shape[0] == 1:
            prompt = prompt[0]
        plen = int(plen) if plen is not None else int(prompt.shape[0])
        if self.shed_queue_depth is not None and \
                self._q.qsize() >= self.shed_queue_depth:
            self._note("shed")
            raise QueueFull(
                f"router queue depth {self._q.qsize()} at/above shedding "
                f"threshold {self.shed_queue_depth}")
        dl = self.deadline_ms if deadline_ms is None else deadline_ms
        req = _RouteRequest(prompt, plen,
                            max_new_tokens if max_new_tokens is not None
                            else self.max_new_tokens, dl, eos_id)
        self._q.put(req)
        return req.handle

    def generate(self, prompt=None, tokens=None, **kw) -> dict:
        return self.submit(prompt=prompt, tokens=tokens, **kw).result()

    def _note(self, kind: str) -> None:
        self._events.append((time.perf_counter(), kind))

    def _loop(self):
        while not self._shutdown.is_set():
            try:
                first = self._q.get(timeout=0.05)
            except queue.Empty:
                continue
            batch = [first]
            while len(batch) < self.round_limit:
                try:
                    batch.append(self._q.get_nowait())
                except queue.Empty:
                    break
            # ONE snapshot a routing round: refcounts -> free pages for
            # every decode candidate, no pool lock per request
            snaps = [cb.engine.pool.ref_snapshot() for cb in self.decodes]
            free = [int(np.count_nonzero(s[1:] == 0)) for s in snaps]
            for req in batch:
                try:
                    self._route_one(req, free)
                except BaseException as e:
                    self._note("failure")
                    req.handle._fail(e)

    def _route_one(self, req: _RouteRequest, pages_free: List[int]):
        t0 = time.perf_counter()
        if req.deadline is not None and t0 > req.deadline:
            self._note("deadline")
            req.handle._fail(DeadlineExceeded(
                "request expired in the router queue before prefill "
                "admission"))
            return
        key = prompt_key(req.prompt, req.plen)
        # 1) a resident prompt: its decode replica, no migration
        for cb in self.decodes:
            if cb.prefix_cache and cb.engine.pool.peek_prefix(key):
                self._counts["routed_prefix_hit"] += 1
                req.handle._bind(cb.submit(
                    prompt=req.prompt, plen=req.plen,
                    max_new_tokens=req.max_new,
                    deadline_ms=req.deadline_ms, eos_id=req.eos_id))
                return
        # 2) prefill where there is headroom, adopt where pages are free
        pre = self.prefills[self._pick_prefill()]
        ship = pre.prefill(req.prompt, plen=req.plen,
                           t_origin=req.t_enqueue)
        self._counts["routed_prefill"] += 1
        di = self._pick_decode(pages_free, len(ship.pages))
        cb = self.decodes[di]
        pages_free[di] -= len(ship.pages)   # keep the round's view honest
        self._counts["migrations"] += 1
        # the deadline re-arms at the decode pool
        req.handle._bind(cb.submit_prefilled(
            ship, max_new_tokens=req.max_new,
            deadline_ms=req.deadline_ms, eos_id=req.eos_id),
            trace_id=ship.trace_id)

    # --------------------------------------------------------------- scoring
    def _report_fractions(self, idx, engine, cache_len: int):
        """A replica's attribution fractions: None in the port, whose
        engines have no ``attribution_report`` yet (ROADMAP.md Queue 1
        item 9); scoring then falls back to 0.5, as the JAX router does
        for an engine it cannot attribute."""
        return None

    def _pick_prefill(self) -> int:
        best, best_score = 0, None
        for i, pre in enumerate(self.prefills):
            if pre.health(self.health_window) == HealthState.SHEDDING:
                continue
            fr = self._report_fractions(("p", i), pre.engine,
                                        pre.engine.max_cache_len)
            headroom = 1.0 - float(fr["compute"]) if fr else 0.5
            score = headroom - 0.25 * pre.queue_depth()
            if best_score is None or score > best_score:
                best, best_score = i, score
        return best

    def _pick_decode(self, pages_free: List[int], need: int) -> int:
        best, best_score = 0, None
        for i, cb in enumerate(self.decodes):
            if cb.health() == HealthState.SHEDDING:
                continue
            fr = self._report_fractions(("d", i), cb.engine,
                                        cb.max_cache_len)
            # free pages over the pool's size, less memory-boundedness
            # and queue depth
            total = max(1, cb.engine.pages - 1)
            score = pages_free[i] / total \
                - 0.1 * (float(fr["memory"]) if fr else 0.5) \
                - 0.05 * cb.queue_depth()
            if pages_free[i] < need:
                score -= 1.0    # would force eviction on arrival
            if best_score is None or score > best_score:
                best, best_score = i, score
        return best

    # ---------------------------------------------------------------- health
    def health(self) -> dict:
        """The worst member state of each pool, and the router's own over
        its shed and deadline window."""
        def worst(states):
            order = [HealthState.HEALTHY, HealthState.DEGRADED,
                     HealthState.SHEDDING]
            return max(states, key=order.index) if states else \
                HealthState.HEALTHY
        now = time.perf_counter()
        recent = {k for t, k in list(self._events)
                  if now - t <= self.health_window}
        if "shed" in recent or (
                self.shed_queue_depth is not None
                and self._q.qsize() >= self.shed_queue_depth):
            router = HealthState.SHEDDING
        elif recent & {"failure", "deadline"}:
            router = HealthState.DEGRADED
        else:
            router = HealthState.HEALTHY
        return {
            "router": router,
            "prefill": worst([p.health(self.health_window)
                              for p in self.prefills]),
            "decode": worst([cb.health() for cb in self.decodes]),
        }

    def stats(self) -> dict:
        return {
            "health": self.health(),
            "queue_depth": self._q.qsize(),
            "migrations": self._counts["migrations"],
            "routed_prefill": self._counts["routed_prefill"],
            "routed_prefix_hit": self._counts["routed_prefix_hit"],
            "prefill": [p.stats() for p in self.prefills],
            "decode": [cb.stats() for cb in self.decodes],
        }

    def shutdown(self):
        self._shutdown.set()
        if self._worker:
            self._worker.join(timeout=10)
        err = ShutdownError("DisaggRouter shut down before the request "
                            "was routed")
        while True:
            try:
                req = self._q.get_nowait()
            except queue.Empty:
                break
            req.handle._fail(err)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()
