"""ParallelInference: dynamic micro-batching dispatcher for serving.

Port of ``ParallelInference`` from ``deeplearning4j_tpu/serving/batcher.py``
in its BATCHED mode: a bounded request queue plus a dispatcher thread that
coalesces concurrent requests up to ``max_batch_size`` rows or
``max_wait_ms`` of linger into ONE :class:`InferenceEngine` call (padded to
a bucket), then scatters the rows back and resolves per-request futures.

Not ported yet for ``ParallelInference`` (they come with the runtime
slice): the SEQUENTIAL mode, deadlines, load shedding, transient retries,
the health state machine, SLOs and request tracing.

:class:`ContinuousBatcher` is the port of the JAX module's generative
front (``GenerationHandle`` :821, ``_GenRequest`` :856,
``ContinuousBatcher`` :911) over the contiguous
:class:`~.engine.GenerativeEngine`: requests join the decode batch at
token boundaries when a slot frees up (their prompts prefill between
decode iterations, ``prefill_per_iter`` per iteration) and leave the
moment they finish, without perturbing the other slots. The default front
decodes in horizons of up to ``max_horizon`` tokens sampled on the device
(``on_device`` decisions), the next horizon dispatched from the last
one's device-carried chain before the last one is read back; a custom
``sample_fn`` or ``token_to_features`` runs the per-token host loop
(``host_loop`` decisions). ``deadline_ms`` bounds enqueue -> admission (a
request still queued when it expires fails with ``DeadlineExceeded`` and
never prefills; an admitted generation is never expired);
``shed_queue_depth`` rejects in the caller's thread with ``QueueFull``;
``health()`` is the HEALTHY / DEGRADED / SHEDDING state machine over the
recent events; ``stats()`` reports TTFT and TPOT percentiles and the
decision mix. The worker thread sets the engine's device in its thread
and hands every exception to the requests' handles; a failed decode
fails the in-flight requests and rebuilds a fresh state
(``_fail_active``).

With ``paged=True`` the front runs over the
:class:`~.engine.PagedGenerativeEngine` (the JAX module's :985-1014): the
slots' caches are pages of one pool, an identical prompt (keyed by its
full digest, ``kv_pool.prompt_key``) maps the pages a first admission
prefilled and registered, and a shared page is forked on its first write
(``_paged_admit``, the paged branches of the horizon loop). With
``draft_model=`` (paged only, greedy only, ``speculate_k >= 2``) every
iteration is a speculative one (``_speculative_iter``, :1991-2070): a
contiguous :class:`~.engine.GenerativeEngine` over the draft proposes k
tokens, the target verifies the window ``[pending, d_1 .. d_{k-1}]`` in
ONE step (K10 in each attention layer on the card), the draft's tokens
are accepted while they equal the target's argmax, the target's
correction is emitted, and the rollback truncates the lengths. The
emitted stream is the target's own greedy stream whatever the draft.
``stats()`` then carries ``page_pool`` and ``speculative`` blocks.

A paged front also takes prompts prefilled in another pool
(:meth:`ContinuousBatcher.submit_prefilled`, the JAX module's :1264, for
disaggregated serving, ``serving/disagg.py``): admission ADOPTS the
shipment's pages into this engine's pool (``_adopt_admit``, :1595)
instead of prefilling, a registry hit on the shipped prompt key maps the
pages an earlier migration adopted, and the first token comes from the
shipped logits. ``migrate_buckets=`` warms the page export and import for
those page counts; ``pool_label=`` names the pool in ``stats()``.

``quantize="int8"`` and ``kv_cache="int8"`` pass to the engine the front
builds (int8 weights, int8 KV cache); beside ``engine=`` they raise
``ValueError``, as in the JAX package. The draft engine serves f32.

Divergences: no ``serving.decode`` or ``serving.page_pool`` fault site,
retries, SLO or request trace (the runtime slice), so a migrated request
carries no trace phases; the
draft's k proposals read back one step at a time and the verify's logits
once per window (the JAX batcher does the same through its executables);
stochastic sampling draws from a ``torch.Generator`` seeded with
``seed``.
"""

from __future__ import annotations

import queue
import threading
import time
from collections import deque
from concurrent.futures import Future, TimeoutError as _FutTimeout
from typing import List, Optional, Sequence

import numpy as np
import torch

from .. import environment as _env
from ..ops import sampling as _smp
from .engine import (GenerativeEngine, InferenceEngine,
                     PagedGenerativeEngine, default_buckets, next_bucket)
from .kv_pool import prompt_key


class InferenceMode:
    BATCHED = "batched"


class ShutdownError(RuntimeError):
    """The front was shut down before the request was served."""


class DeadlineExceeded(Exception):
    """A generation request's admission deadline expired in the queue."""


class QueueFull(Exception):
    """The generation queue is at its load-shedding threshold."""


class HealthState:
    HEALTHY = "HEALTHY"
    DEGRADED = "DEGRADED"
    SHEDDING = "SHEDDING"


class _Request:
    __slots__ = ("x", "future", "t_enqueue")

    def __init__(self, x):
        self.x = x
        self.future: Future = Future()
        self.t_enqueue = time.perf_counter()


class ParallelInference:
    """Thread-safe inference front over a model's forward pass.

    Usage::

        pi = ParallelInference(net, max_batch_size=32, max_wait_ms=5)
        y = pi.output(x)          # blocking, callable from many threads
        f = pi.submit(x)          # non-blocking -> concurrent Future
        pi.stats()                # p50/p99 latency, batches, buckets
        pi.shutdown()

    ``device`` follows the port's rule (``cuda`` unless the caller asks for
    ``cpu``) and must be the model's device; the front then shares the
    model's engine, so ``net.output()`` and the front hit the same warmed
    buckets. ``quantize="int8"`` builds the front its own int8 engine."""

    def __init__(self, model, mode: str = InferenceMode.BATCHED,
                 max_batch_size: int = 32, max_wait_ms: float = 5.0,
                 queue_limit: int = 256,
                 engine: Optional[InferenceEngine] = None,
                 warmup: bool = False, quantize: Optional[str] = None,
                 device=None):
        if mode != InferenceMode.BATCHED:
            raise NotImplementedError(
                f"inference mode {mode!r}: the port serves BATCHED only "
                "until the runtime slice")
        if engine is not None and quantize is not None:
            # a dropped quantize= would serve f32 while the deploy config
            # believes it is int8
            raise ValueError("pass quantize= on the engine you build "
                             "(InferenceEngine(model, quantize=...)), "
                             "not alongside engine=")
        if engine is None:
            device = _env.resolve_device(device)
            if model.device is None or \
                    torch.device(model.device).type != device.type:
                raise ValueError(f"the model lives on {model.device}; this "
                                 f"front was asked for {device}")
            engine = InferenceEngine(model, device=device,
                                     quantize=quantize) \
                if quantize is not None else model.inference_engine()
        self.model = model
        self.mode = mode
        self.engine = engine
        self.max_batch_size = int(max_batch_size)
        self.max_wait = max_wait_ms / 1e3
        if warmup:
            # every bucket a coalesced batch can land on: the dispatcher
            # caps totals at max_batch_size
            engine.warmup(default_buckets(
                next_bucket(self.max_batch_size, engine.min_bucket),
                minimum=engine.min_bucket))
        self._q: "queue.Queue[_Request]" = queue.Queue(maxsize=queue_limit)
        self._shutdown = threading.Event()
        self._lock = threading.Lock()
        self._requests = 0
        self._batches = 0
        self._failures = 0
        self._latency = deque(maxlen=4096)   # seconds, submit -> resolve
        self._rows = deque(maxlen=4096)      # rows per engine call
        self._worker = threading.Thread(
            target=self._dispatcher, daemon=True,
            name="ParallelInference-dispatcher")
        self._worker.start()

    # ---- public ------------------------------------------------------------
    def submit(self, x) -> Future:
        """Enqueue one request; resolves to the unpadded output rows.
        Requests larger than ``max_batch_size`` are split into capped
        chunks and rejoined."""
        if self._shutdown.is_set():
            raise ShutdownError("ParallelInference is shut down")
        x = self._validate(np.asarray(x))
        with self._lock:
            self._requests += 1
        if x.shape[0] > self.max_batch_size:
            return self._submit_chunked(x)
        return self._enqueue(_Request(x))

    def _enqueue(self, req: _Request) -> Future:
        self._q.put(req)
        # a shutdown() racing this put may already have drained the queue
        # and joined the dispatcher: fail the future rather than strand it
        if self._shutdown.is_set() and not req.future.done():
            req.future.set_exception(ShutdownError(
                "ParallelInference shut down before the request was served"))
        return req.future

    def _submit_chunked(self, x) -> Future:
        m = self.max_batch_size
        subs = [_Request(x[i:i + m]) for i in range(0, x.shape[0], m)]
        parent: Future = Future()
        left = [len(subs)]
        plock = threading.Lock()

        def on_done(f: Future):
            with plock:
                if parent.done():
                    return
                err = f.exception()
                if err is not None:
                    parent.set_exception(err)
                    return
                left[0] -= 1
                if left[0]:
                    return
                results = [s.future.result() for s in subs]
                if isinstance(results[0], list):  # multi-output graph
                    parent.set_result([
                        np.concatenate([r[k] for r in results])
                        for k in range(len(results[0]))])
                else:
                    parent.set_result(np.concatenate(results))

        for s in subs:
            s.future.add_done_callback(on_done)
        for s in subs:
            self._enqueue(s)
        return parent

    def output(self, x) -> np.ndarray:
        """Blocking convenience over :meth:`submit`."""
        return self.wait(self.submit(x))

    def wait(self, fut: Future, timeout: Optional[float] = None):
        """Block on one submitted future, re-checking shutdown so a racing
        ``shutdown()`` cannot strand the caller; ``timeout`` (seconds)
        raises ``TimeoutError`` when it passes."""
        t_end = None if timeout is None else time.perf_counter() + timeout
        while True:
            try:
                return fut.result(timeout=0.2)
            except _FutTimeout:
                if self._shutdown.is_set() and not fut.done():
                    raise ShutdownError(
                        "ParallelInference shut down before the request "
                        "was served") from None
                if t_end is not None and time.perf_counter() > t_end:
                    raise TimeoutError("request not served in "
                                       f"{timeout} s") from None

    def stats(self) -> dict:
        """Request latency percentiles (ms), coalesced batch sizes, the
        counters and the engine's bucket counters."""
        with self._lock:
            lat = np.asarray(self._latency, dtype=np.float64)
            rows = np.asarray(self._rows, dtype=np.float64)
            out = {"mode": self.mode, "requests": self._requests,
                   "batches": self._batches, "failures": self._failures}
        out.update({
            "queue_depth": self._q.qsize(),
            "latency_ms_p50": float(np.percentile(lat, 50) * 1e3)
            if lat.size else None,
            "latency_ms_p99": float(np.percentile(lat, 99) * 1e3)
            if lat.size else None,
            "batch_rows_mean": float(rows.mean()) if rows.size else None,
            "batch_rows_max": int(rows.max()) if rows.size else None,
            "engine": self.engine.stats(),
        })
        return out

    def shutdown(self):
        """Stop the dispatcher and FAIL every queued future with
        :class:`ShutdownError`: an unresolved future strands its caller."""
        self._shutdown.set()
        self._worker.join(timeout=30)
        while True:
            try:
                req = self._q.get_nowait()
            except queue.Empty:
                break
            if not req.future.done():
                req.future.set_exception(ShutdownError(
                    "ParallelInference shut down before the request "
                    "was served"))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()

    # ---- internals ---------------------------------------------------------
    def _validate(self, x: np.ndarray) -> np.ndarray:
        """Reject a bad shape HERE, in the caller's thread: inside a
        coalesced batch it would fail everyone. One example without its
        batch dim gets one."""
        shapes = self.engine._input_shapes
        if len(shapes) == 1:
            in_shape = shapes[0]
            if x.ndim == len(in_shape):
                x = x[None]
            if tuple(x.shape[1:]) != tuple(in_shape):
                raise ValueError(f"input shape {tuple(x.shape[1:])} does "
                                 f"not match model input {tuple(in_shape)}")
        return x

    def _dispatcher(self):
        pending: Optional[_Request] = None  # carry-over, never overshoot
        while not self._shutdown.is_set():
            if pending is not None:
                first, pending = pending, None
            else:
                try:
                    first = self._q.get(timeout=0.05)
                except queue.Empty:
                    continue
            batch: List[_Request] = [first]
            total = first.x.shape[0]
            deadline = time.perf_counter() + self.max_wait
            while total < self.max_batch_size:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                try:
                    r = self._q.get(timeout=remaining)
                except queue.Empty:
                    break
                if total + r.x.shape[0] > self.max_batch_size:
                    # would overshoot the cap (and the warmed buckets):
                    # lead the NEXT batch with it instead
                    pending = r
                    break
                batch.append(r)
                total += r.x.shape[0]
            self._run(batch, total)
        if pending is not None and not pending.future.done():
            pending.future.set_exception(ShutdownError(
                "ParallelInference shut down before the request was served"))

    def _run(self, batch: List[_Request], total: int):
        try:
            x = np.concatenate([r.x for r in batch], axis=0)
            out = self.engine.output(x)
        except Exception as e:  # the dispatcher keeps serving; every waiter
            with self._lock:    # of this batch gets the error
                self._failures += len(batch)
            for r in batch:
                if not r.future.done():
                    r.future.set_exception(e)
            return
        outs = out if isinstance(out, list) else [out]
        i = 0
        done_t = time.perf_counter()
        for r in batch:
            n = r.x.shape[0]
            rows = [o[i:i + n] for o in outs]
            i += n
            if not r.future.done():  # a shutdown race may have failed it
                r.future.set_result(rows if len(rows) > 1 else rows[0])
        with self._lock:
            self._batches += 1
            self._rows.append(total)
            self._latency.extend(done_t - r.t_enqueue for r in batch)


# ===========================================================================
# Continuous batching for autoregressive decode
# ===========================================================================



def _percentile(values, q):
    return float(np.percentile(np.asarray(values, np.float64), q)) \
        if len(values) else None


class GenerationHandle:
    """One in-flight generation: a ``Future`` resolving to ``{"tokens":
    [ids], "logits": last-step logits}``, and :meth:`tokens`, which yields
    the token ids as they are produced (what POST /generate streams)."""

    def __init__(self):
        self.future: Future = Future()
        self._stream: "queue.Queue" = queue.Queue()

    def _emit(self, index: int, token: int):
        self._stream.put((index, int(token)))

    def _finish(self, err: Optional[BaseException] = None):
        self._stream.put(None)
        if err is not None and not self.future.done():
            self.future.set_exception(err)

    def tokens(self, timeout: Optional[float] = None):
        """Yield the generated token ids in order as they are produced; a
        terminal failure is raised to the consumer too."""
        while True:
            item = self._stream.get(timeout=timeout)
            if item is None:
                err = self.future.exception() if self.future.done() \
                    else None
                if err is not None:
                    raise err
                return
            yield item[1]

    def result(self, timeout: Optional[float] = None) -> dict:
        return self.future.result(timeout=timeout)


class _GenRequest:
    __slots__ = ("x", "plen", "max_new", "eos_id", "handle", "t_enqueue",
                 "deadline", "t_admitted", "tokens", "emitted",
                 "t_first_token", "shipment")

    def __init__(self, x, plen, max_new, eos_id, deadline, shipment=None):
        self.x = x                    # [T, F] prompt features (host)
        self.plen = int(plen)
        self.max_new = int(max_new)
        self.eos_id = eos_id
        self.handle = GenerationHandle()
        self.t_enqueue = time.perf_counter()
        self.deadline = deadline      # absolute admission deadline or None
        self.t_admitted = None
        self.tokens: List[int] = []
        self.emitted = 0
        self.t_first_token = None
        # a migrated prompt (serving.disagg.KVShipment): admission adopts
        # its pages in place of a prefill; the deadline above was re-armed
        # at submit_prefilled, and t_enqueue is back-dated by the
        # shipment's origin-side elapsed time, so TTFT spans both pools
        self.shipment = shipment

    def expired(self, now=None) -> bool:
        return self.deadline is not None and \
            (now if now is not None else time.perf_counter()) > self.deadline


class _Horizon:
    """One dispatched horizon and its host bookkeeping: the slots live at
    dispatch and each one's token budget left after it lands."""

    __slots__ = ("res", "live", "k", "budget_after")

    def __init__(self, res, live, k, budget_after):
        self.res = res
        self.live = list(live)
        self.k = int(k)
        self.budget_after = dict(budget_after)


class ContinuousBatcher:
    """Token-boundary continuous batching over a
    :class:`~.engine.GenerativeEngine` slot set (see the module
    docstring). ``device`` follows the port's rule (``cuda`` unless the
    caller asks for ``cpu``) and must be the model's."""

    def __init__(self, model, slots: int = 4, max_cache_len: int = 256,
                 min_cache_len: int = 16,
                 prompt_buckets: Optional[Sequence[int]] = None,
                 max_new_tokens: int = 32, queue_limit: int = 256,
                 deadline_ms: Optional[float] = None,
                 shed_queue_depth: Optional[int] = None,
                 prefill_per_iter: int = 1, eos_id: Optional[int] = None,
                 token_to_features=None, sample_fn=None, engine=None,
                 warmup: bool = True, quantize: Optional[str] = None,
                 kv_cache: Optional[str] = None, paged: bool = False,
                 page_size: int = 16, pages: Optional[int] = None,
                 prefix_cache: bool = True, draft_model=None,
                 speculate_k: int = 4, migrate_buckets: Sequence[int] = (),
                 max_horizon: int = 8,
                 sampling: Optional[_smp.SamplingSpec] = None,
                 seed: int = 0, pool_label: str = "default", device=None):
        self.pool_label = str(pool_label)
        self._migrate_buckets = tuple(int(n) for n in migrate_buckets)
        if engine is not None and (quantize is not None
                                   or kv_cache is not None
                                   or paged or pages is not None):
            raise ValueError("pass quantize=/kv_cache=/paged config on "
                             "the engine you build (GenerativeEngine / "
                             "PagedGenerativeEngine), not alongside "
                             "engine=")
        self.model = model
        self.max_cache_len = next_bucket(max_cache_len)
        self.min_cache_len = next_bucket(min_cache_len)
        if engine is None:
            if paged:
                # the default pool holds every slot at its full bucket (no
                # pressure); a capacity-bound deployment sizes ``pages``
                # down and leans on sharing and eviction
                psz = next_bucket(page_size)
                n_pages = int(pages) if pages is not None else \
                    1 + int(slots) * max(1, self.max_cache_len // psz)
                engine = PagedGenerativeEngine(
                    model, slots=slots, pages=n_pages, page_size=psz,
                    max_cache_len=self.max_cache_len, quantize=quantize,
                    kv_cache=kv_cache, device=device,
                    pool_label=self.pool_label)
            else:
                engine = GenerativeEngine(model, slots=slots,
                                          quantize=quantize,
                                          kv_cache=kv_cache, device=device,
                                          pool_label=self.pool_label)
        self.engine = engine
        self.paged = isinstance(engine, PagedGenerativeEngine)
        if self.paged and self.max_cache_len > engine.max_cache_len:
            # the engine's table caps a slot's pages: admitting what it
            # cannot hold would overflow map_pages and leak the allocation
            raise ValueError(
                f"batcher max_cache_len {self.max_cache_len} exceeds the "
                f"paged engine's max_cache_len {engine.max_cache_len}; "
                "size the engine (or the batcher bound) to match")
        self.prefix_cache = bool(prefix_cache) and self.paged
        self.slots = self.engine.slots
        self.max_new_tokens = int(max_new_tokens)
        self.deadline_ms = deadline_ms
        self.shed_queue_depth = None if shed_queue_depth is None \
            else int(shed_queue_depth)
        self.prefill_per_iter = max(1, int(prefill_per_iter))
        self.eos_id = eos_id
        self._f = self.engine._feature_dim()
        # a custom sample_fn / token_to_features cannot run inside the
        # device horizon: those callers keep the per-token host loop
        self._custom_host_loop = (sample_fn is not None
                                  or token_to_features is not None)
        if sampling is not None and sample_fn is not None:
            raise ValueError("sampling= configures the on-device sampler; "
                             "a host sample_fn bypasses it: pass one of "
                             "the two")
        self._sampling = sampling if sampling is not None else _smp.GREEDY
        self.max_horizon = max(1, int(max_horizon))
        # the adaptive horizon's ramp: powers of two up to max_horizon
        ladder, h = [], 1
        while h < self.max_horizon:
            ladder.append(h)
            h <<= 1
        ladder.append(self.max_horizon)
        self._ladder = tuple(ladder)
        self.token_to_features = token_to_features or self._one_hot
        self.sample_fn = sample_fn or (lambda logits: int(np.argmax(logits)))
        # speculative decoding: a draft engine proposes k tokens, the target
        # verifies all k in ONE window step
        self.speculate_k = int(speculate_k)
        self.draft = None
        if draft_model is not None:
            if not self.paged:
                raise ValueError("speculative decoding rides the paged "
                                 "engine's verify; pass paged=True (or a "
                                 "PagedGenerativeEngine)")
            if sample_fn is not None:
                raise ValueError("speculative decoding verifies GREEDY "
                                 "tokens; a custom sample_fn cannot be "
                                 "teacher-forced: drop one of the two")
            if self._sampling.stochastic:
                raise ValueError("speculative decoding verifies GREEDY "
                                 "tokens; stochastic on-device sampling "
                                 "cannot be teacher-forced")
            if self.speculate_k < 2:
                raise ValueError("speculate_k must be >= 2 (k=1 is plain "
                                 "decode)")
            self.draft = GenerativeEngine(draft_model, slots=self.slots,
                                          device=self.engine.device,
                                          pool_label=self.pool_label)
            if self.draft._feature_dim() != self._f:
                raise ValueError(
                    f"draft model feature dim {self.draft._feature_dim()} "
                    f"!= target {self._f}: the draft must share the token "
                    "feature space")
        if warmup:
            cb, b = [], self.min_cache_len
            while b <= self.max_cache_len:
                cb.append(b)
                b <<= 1
            pb = list(prompt_buckets) if prompt_buckets else cb
            horizons = () if (self._custom_host_loop
                              or self.draft is not None) \
                else (self.max_horizon,)
            if self.paged:
                self.engine.warmup(
                    cb, pb, speculate=(self.speculate_k,)
                    if self.draft is not None else (),
                    migrate_buckets=self._migrate_buckets,
                    horizons=horizons, sampling=self._sampling)
            else:
                self.engine.warmup(cb, pb, horizons=horizons,
                                   sampling=self._sampling)
            if self.draft is not None:
                self.draft.warmup(cb, pb)
        # live decode state and its host mirrors (the worker's own)
        self._state = self.engine.new_state(self.min_cache_len)
        self._slot_req: List[Optional[_GenRequest]] = [None] * self.slots
        self._lengths = np.zeros((self.slots,), np.int64)
        self._x_t = np.zeros((self.slots, 1, self._f), np.float32)
        if self.draft is not None:
            self._dstate = self.draft.new_state(self.min_cache_len)
            self._dlengths = np.zeros((self.slots,), np.int64)
        self._inflight: Optional[_Horizon] = None
        self._h_streak = 0
        self._gen = torch.Generator(device=self.engine.device).manual_seed(
            int(seed))
        self._token_times: deque = deque(maxlen=4096)
        self._q: "queue.Queue[_GenRequest]" = queue.Queue(maxsize=queue_limit)
        self._shutdown = threading.Event()
        self._lock = threading.Lock()
        self._counts = {k: 0 for k in (
            "requests", "tokens_generated", "failures", "shed",
            "deadline_expired", "on_device", "host_loop", "speculative",
            "proposed", "accepted")}
        self._ttft = deque(maxlen=4096)
        self._tpot = deque(maxlen=4096)
        self.health_window = 5.0
        self._events = deque(maxlen=1024)
        # the worker drives the engine's card: its index, resolved here
        # (a bare "cuda" means the current device of this thread)
        dev = self.engine.device
        self._cuda_index = None if dev.type != "cuda" else (
            dev.index if dev.index is not None
            else torch.cuda.current_device())
        self._worker = threading.Thread(target=self._loop, daemon=True,
                                        name="ContinuousBatcher-decode")
        self._worker.start()

    def _bump(self, key: str, n: int = 1):
        with self._lock:
            self._counts[key] += n

    def _note(self, kind: str):
        self._events.append((time.perf_counter(), kind))

    def health(self) -> str:
        """HEALTHY / DEGRADED / SHEDDING over the recent event window."""
        now = time.perf_counter()
        recent = {k for t, k in list(self._events)
                  if now - t <= self.health_window}
        if "shed" in recent or (
                self.shed_queue_depth is not None
                and self._q.qsize() >= self.shed_queue_depth):
            return HealthState.SHEDDING
        if recent & {"failure", "deadline"}:
            return HealthState.DEGRADED
        return HealthState.HEALTHY

    # ---- public ------------------------------------------------------------
    def _one_hot(self, token: int) -> np.ndarray:
        f = np.zeros((self._f,), np.float32)
        f[int(token) % self._f] = 1.0
        return f

    def submit(self, prompt=None, tokens=None, plen: Optional[int] = None,
               max_new_tokens: Optional[int] = None,
               deadline_ms: Optional[float] = None,
               eos_id: Optional[int] = None) -> GenerationHandle:
        """Enqueue one generation: ``prompt`` ``[T, F]`` features, or
        ``tokens`` (ids through ``token_to_features``). Returns a
        :class:`GenerationHandle` at once; tokens stream as they
        decode."""
        if self._shutdown.is_set():
            raise ShutdownError("ContinuousBatcher is shut down")
        if tokens is not None:
            prompt = np.stack([self.token_to_features(t) for t in tokens])
        prompt = np.asarray(prompt, np.float32)
        if prompt.ndim == 3 and prompt.shape[0] == 1:
            prompt = prompt[0]
        if prompt.ndim != 2 or prompt.shape[1] != self._f:
            raise ValueError(f"prompt must be [T, {self._f}] features; got "
                             f"{prompt.shape}")
        plen = int(plen) if plen is not None else prompt.shape[0]
        max_new = int(max_new_tokens) if max_new_tokens is not None \
            else self.max_new_tokens
        # a verify window caches up to k - 1 rejected rows past the live
        # sequence: reserve that slack at admission
        slack = self.speculate_k if self.draft is not None else 0
        if next_bucket(plen + max_new + slack) > self.max_cache_len:
            raise ValueError(
                f"prompt ({plen}) + max_new_tokens ({max_new})"
                + (f" + speculative slack ({slack})" if slack else "")
                + f" exceeds max_cache_len {self.max_cache_len}")
        self._shed_check()
        dl = self.deadline_ms if deadline_ms is None else deadline_ms
        deadline = None if dl is None else time.perf_counter() + dl / 1e3
        req = _GenRequest(prompt, plen, max_new,
                          self.eos_id if eos_id is None else eos_id,
                          deadline)
        return self._enqueue(req)

    def _shed_check(self) -> None:
        """Reject in the caller's thread at the shedding threshold."""
        if self.shed_queue_depth is not None and \
                self._q.qsize() >= self.shed_queue_depth:
            self._bump("shed")
            self._note("shed")
            raise QueueFull(f"generation queue depth {self._q.qsize()} "
                            f"at/above shedding threshold "
                            f"{self.shed_queue_depth}")

    def _enqueue(self, req: _GenRequest) -> GenerationHandle:
        self._bump("requests")
        self._q.put(req)
        if self._shutdown.is_set() and not req.handle.future.done():
            req.handle._finish(ShutdownError(
                "ContinuousBatcher shut down before the request was served"))
        return req.handle

    def generate(self, prompt=None, tokens=None, **kw) -> dict:
        """Blocking convenience over :meth:`submit`."""
        return self.submit(prompt=prompt, tokens=tokens, **kw).result()

    def submit_prefilled(self, shipment,
                         max_new_tokens: Optional[int] = None,
                         deadline_ms: Optional[float] = None,
                         eos_id: Optional[int] = None) -> GenerationHandle:
        """Enqueue a generation whose prompt was prefilled in ANOTHER pool:
        the request carries a :class:`~.disagg.KVShipment`, admission
        adopts its pages into this engine's pool in place of a prefill,
        and the first token comes from the shipped logits. The shipment is
        checked against this pool (``validate_for``) before it queues.

        ``deadline_ms`` RE-ARMS here: it bounds decode-pool enqueue ->
        admission from this call, never from the origin submit, so a slow
        handoff cannot expire prefill work the other pool already paid
        for. TTFT still spans the whole request: ``t_enqueue`` is
        back-dated by the shipment's origin-side ``elapsed_s``."""
        if self._shutdown.is_set():
            raise ShutdownError("ContinuousBatcher is shut down")
        if not self.paged:
            raise ValueError("submit_prefilled needs a paged engine: KV "
                             "pages migrate, contiguous buckets do not")
        if self.draft is not None:
            raise ValueError("speculative decoding cannot adopt a migrated "
                             "prompt: the draft engine has no KV for it "
                             "(route speculative traffic to a colocated "
                             "replica)")
        shipment.validate_for(self.engine)
        plen = int(shipment.plen)
        max_new = int(max_new_tokens) if max_new_tokens is not None \
            else self.max_new_tokens
        if next_bucket(plen + max_new) > self.max_cache_len:
            raise ValueError(
                f"prompt ({plen}) + max_new_tokens ({max_new}) exceeds "
                f"max_cache_len {self.max_cache_len}")
        self._shed_check()
        dl = self.deadline_ms if deadline_ms is None else deadline_ms
        # re-armed: from now (the decode-pool submit), not from the
        # back-dated origin enqueue below
        deadline = None if dl is None else time.perf_counter() + dl / 1e3
        x = shipment.x if shipment.x is not None \
            else np.zeros((plen, self._f), np.float32)
        req = _GenRequest(x, plen, max_new,
                          self.eos_id if eos_id is None else eos_id,
                          deadline, shipment=shipment)
        req.t_enqueue = time.perf_counter() - float(shipment.elapsed_s)
        return self._enqueue(req)

    def active_slots(self) -> int:
        return sum(1 for r in self._slot_req if r is not None)

    def queue_depth(self) -> int:
        return self._q.qsize()

    def stats(self) -> dict:
        """Counters, TTFT/TPOT percentiles (ms), the windowed token rate
        and the decision mix."""
        now = time.perf_counter()
        tps = sum(1 for t in list(self._token_times)
                  if now - t <= self.health_window) / self.health_window
        with self._lock:
            c = dict(self._counts)
            ttft, tpot = list(self._ttft), list(self._tpot)

        def ms(v, q):
            p = _percentile(v, q)
            return None if p is None else p * 1e3

        out = {
            "slots": self.slots, "pool": self.pool_label,
            "health": self.health(), "slots_active": self.active_slots(),
            "queue_depth": self._q.qsize(), "requests": c["requests"],
            "tokens_generated": c["tokens_generated"],
            "failures": c["failures"], "shed": c["shed"],
            "deadline_expired": c["deadline_expired"], "retries": 0,
            "cache_len": self._state.cache_len,
            "ttft_ms_p50": ms(ttft, 50), "ttft_ms_p99": ms(ttft, 99),
            "tpot_ms_p50": ms(tpot, 50), "tpot_ms_p99": ms(tpot, 99),
            "tokens_per_s": tps, "max_horizon": self.max_horizon,
            "dispatch_decisions": {"on_device": c["on_device"],
                                   "host_loop": c["host_loop"],
                                   "speculative": c["speculative"]},
            "engine": self.engine.stats(),
        }
        if self.paged:
            out["page_pool"] = self.engine.pool.stats()
        if self.draft is not None:
            prop, acc = c["proposed"], c["accepted"]
            out["speculative"] = {"k": self.speculate_k, "proposed": prop,
                                  "accepted": acc,
                                  "accept_rate": acc / prop if prop
                                  else None}
        return out

    def shutdown(self):
        self._shutdown.set()
        if self._worker:
            self._worker.join(timeout=30)
        err = ShutdownError(
            "ContinuousBatcher shut down before the request was served")
        while True:
            try:
                req = self._q.get_nowait()
            except queue.Empty:
                break
            req.handle._finish(err)
        for i, req in enumerate(self._slot_req):
            if req is not None:
                req.handle._finish(err)
            self._slot_req[i] = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()

    # ---- worker internals (one thread owns _state and the mirrors) --------
    def _free_slot(self) -> Optional[int]:
        for i, r in enumerate(self._slot_req):
            if r is None:
                return i
        return None

    def _loop(self):
        if self._cuda_index is not None:
            torch.cuda.set_device(self._cuda_index)
        while not self._shutdown.is_set():
            try:
                if self._inflight is not None:
                    # a horizon is in flight: chain its successor, then
                    # land it (one readback) and emit its tokens
                    self._consume_horizon()
                    continue
                admitted = self._admit()
                if any(r is not None for r in self._slot_req):
                    if self._custom_host_loop or self.draft is not None:
                        self._decode_iter()
                    else:
                        self._dispatch_horizon()
                elif not admitted:
                    time.sleep(0.002)  # idle: no queue, no active slots
            except Exception as e:
                # a raising sample_fn / token_to_features or an engine
                # error must not kill the worker and strand every future
                self._fail_active(e)

    def _fail_active(self, e: BaseException):
        """Fail every in-flight request with ``e``, rebuild a fresh decode
        state (the engine updates the state in place, so a failed call
        may leave it half written; with every slot freed, zeros are the
        right state), and keep the worker alive."""
        self._inflight = None
        self._h_streak = 0
        live = [i for i, r in enumerate(self._slot_req) if r is not None]
        self._bump("failures", max(1, len(live)))
        self._note("failure")
        for i in live:
            self._slot_req[i].handle._finish(e)
            self._slot_req[i] = None
        self._lengths[:] = 0
        self._x_t[:] = 0.0
        if self.paged:
            # every mapped page back, and the registry forgotten: the pool
            # is rebuilt, so a registered prefix no longer holds its rows
            for s in range(self.slots):
                self.engine.pool.release(
                    self.engine.release_slot(self._state, s))
            self.engine.pool.clear_prefixes()
        self._state = self.engine.new_state(self.min_cache_len)
        if self.draft is not None:
            self._dstate = self.draft.new_state(self.min_cache_len)
            self._dlengths[:] = 0

    def _admit(self) -> int:
        """Prefill up to ``prefill_per_iter`` queued requests into free
        slots, between decode iterations."""
        n = 0
        while n < self.prefill_per_iter:
            slot = self._free_slot()
            if slot is None:
                break
            try:
                req = self._q.get(timeout=0.02 if n == 0 and not any(
                    r is not None for r in self._slot_req) else 0.0)
            except queue.Empty:
                break
            # the admission deadline is checked here, against the enqueue
            # clock; an admitted generation restarts its clock
            if req.expired():
                self._bump("deadline_expired")
                self._note("deadline")
                req.handle._finish(DeadlineExceeded(
                    "generation request expired before admission"))
                continue
            try:
                self._prefill(req, slot)
                n += 1
            except Exception as e:
                self._bump("failures")
                self._note("failure")
                req.handle._finish(e)
                if self._slot_req[slot] is req:
                    self._slot_req[slot] = None
                self._reset_slot(slot)
        return n

    def _prefill(self, req: _GenRequest, slot: int):
        need_c = next_bucket(max(req.plen + 1, next_bucket(req.x.shape[0])))
        if need_c > self._state.cache_len:
            self._state = self.engine.grow(self._state, need_c)
        req.t_admitted = time.perf_counter()
        if req.shipment is not None:
            logits = self._adopt_admit(req, slot)
        elif self.paged:
            logits = self._paged_admit(req, slot)
        else:
            self._state, logits = self.engine.prefill(self._state, req.x,
                                                      req.plen, slot)
        if self.draft is not None:
            # the draft's contiguous caches are private per slot: they
            # always prefill
            if need_c > self._dstate.cache_len:
                self._dstate = self.draft.grow(self._dstate, need_c)
            self._dstate, _ = self.draft.prefill(self._dstate, req.x,
                                                 req.plen, slot)
            self._dlengths[slot] = req.plen
        self._slot_req[slot] = req
        self._lengths[slot] = req.plen
        self._emit_token(slot, logits)

    def _paged_admit(self, req: _GenRequest, slot: int) -> np.ndarray:
        """Paged admission with prefix sharing: a registry hit on the FULL
        prompt's key maps the SAME pages into this slot (refcounted: the
        prompt was prefilled once) and reuses the recorded logits; a miss
        allocates pages, prefills and registers them. A shared page forks
        on first write (``prepare_write``). Only identical prompts share:
        the prompt attends bidirectionally over itself (prefix-LM), so the
        deep layers' k/v of a common prefix differ under other
        suffixes."""
        eng = self.engine
        key = None
        if self.prefix_cache:
            key = prompt_key(req.x, req.plen)
            hit = eng.pool.lookup_prefix(key)
            if hit is not None:
                eng.map_pages(self._state, slot, hit.pages)
                self._state.lengths[slot] = req.plen
                return hit.logits.copy()
        pages = eng.pool.alloc(-(-req.plen // eng.page_size))
        try:
            eng.map_pages(self._state, slot, pages)
            self._state, logits = eng.prefill(self._state, req.x, req.plen,
                                              slot)
        except BaseException:
            # reclaim the allocation exactly once: clear the table row
            # first so _reset_slot cannot release the pages again
            self._state.page_table[slot, :] = 0
            eng.pool.release(pages)
            raise
        if key is not None:
            eng.pool.register_prefix(key, pages, req.plen, logits)
            # the registry keeps `logits`; the caller gets its own copy
            return logits.copy()
        return logits

    def _adopt_admit(self, req: _GenRequest, slot: int) -> np.ndarray:
        """Admission of a migrated request: a registry hit on the shipped
        key maps pages already resident here (the same prompt migrated
        here before, or was prefilled here); a miss adopts fresh pages,
        imports the shipped payload into them and registers the prefix,
        so the next identical prompt on this pool hits without migrating
        again."""
        sh = req.shipment
        eng = self.engine
        if self.prefix_cache and sh.prefix_key is not None:
            hit = eng.pool.lookup_prefix(sh.prefix_key)
            if hit is not None:
                eng.map_pages(self._state, slot, hit.pages)
                self._state.lengths[slot] = req.plen
                return hit.logits.copy()
        pages = eng.pool.adopt(len(sh.pages))
        try:
            self._state = eng.import_pages(self._state, pages, sh.payload)
            eng.map_pages(self._state, slot, pages)
            self._state.lengths[slot] = req.plen
        except BaseException:
            # reclaim the pages once: clear the row before releasing so
            # _reset_slot cannot release them again
            self._state.page_table[slot, :] = 0
            eng.pool.release(pages)
            raise
        logits = np.asarray(sh.logits)
        if self.prefix_cache and sh.prefix_key is not None:
            eng.pool.register_prefix(sh.prefix_key, pages, req.plen, logits)
            return logits.copy()
        return logits

    def _reset_slot(self, slot: int):
        """Reclaim one slot's host mirrors and (paged) its pages (a normal
        leave, a failed admission and the failure sweep alike)."""
        self._lengths[slot] = 0
        self._x_t[slot] = 0.0
        if self.paged:
            self.engine.pool.release(
                self.engine.release_slot(self._state, slot))
        if self.draft is not None:
            self._dlengths[slot] = 0

    def _emit_token(self, slot: int, logits: np.ndarray):
        self._emit_known(slot, self.sample_fn(logits), logits)

    def _emit_known(self, slot: int, tok: int, logits: np.ndarray) -> bool:
        """Emit one decided token; True when the request finished and the
        slot was reclaimed."""
        req = self._slot_req[slot]
        tok = int(tok)
        req.tokens.append(tok)
        req.emitted += 1
        self._bump("tokens_generated")
        req.handle._emit(req.emitted - 1, tok)
        now = time.perf_counter()
        self._token_times.append(now)
        if req.t_first_token is None:
            # TTFT: submit -> first emitted token, queue and prefill in
            req.t_first_token = now
            with self._lock:
                self._ttft.append(now - req.t_enqueue)
        done = req.emitted >= req.max_new or \
            (req.eos_id is not None and tok == req.eos_id)
        if done:
            if req.emitted > 1:
                with self._lock:
                    self._tpot.append((now - req.t_first_token)
                                      / (req.emitted - 1))
            if not req.handle.future.done():
                req.handle.future.set_result(
                    {"tokens": list(req.tokens), "logits": logits})
            req.handle._finish()
            self._slot_req[slot] = None
            self._reset_slot(slot)
        else:
            self._x_t[slot, 0] = self.token_to_features(tok)
        return done

    # ---- device horizons ---------------------------------------------------
    def _pick_horizon(self, live) -> int:
        """k = 1 while requests wait (joins stay at token boundaries),
        else up the ramp toward ``max_horizon``; never past the smallest
        remaining token budget of the live slots."""
        if self.max_horizon <= 1 or not self._q.empty():
            self._h_streak = 0
            k = 1
        else:
            k = self._ladder[min(self._h_streak, len(self._ladder) - 1)]
            self._h_streak += 1
        budget = min(self._slot_req[s].max_new - self._slot_req[s].emitted
                     for s in live)
        return max(1, min(k, budget))

    def _eos_vec(self, live) -> np.ndarray:
        eos = np.full((self.slots,), -1, np.int32)
        for s in live:
            e = self._slot_req[s].eos_id
            if e is not None:
                eos[s] = int(e)
        return eos

    def _cow(self, slots, n_tokens: int):
        """Copy-on-write before a paged dispatch: every position the next
        ``n_tokens`` of ``slots`` write lands on an exclusively owned page
        (one refcount snapshot, one batched fork)."""
        snap = self.engine.pool.ref_snapshot()
        pairs = []
        for s in slots:
            pairs += self.engine.prepare_write(self._state, s, n_tokens,
                                               ref_snapshot=snap)
        if pairs:
            self._state = self.engine.fork(self._state, pairs)

    def _dispatch_horizon(self):
        """Dispatch one horizon without reading it back."""
        active = np.array([1 if r is not None else 0
                           for r in self._slot_req], np.int32)
        live = [i for i in range(self.slots) if active[i]]
        k = self._pick_horizon(live)
        need = int(self._lengths[live].max()) + k
        if need > self._state.cache_len:
            self._state = self.engine.grow(self._state, need)
        try:
            if self.paged:
                self._cow(live, k)
                dispatch = self.engine.pdecode_multi
            else:
                dispatch = self.engine.decode_multi
            self._state, res = dispatch(
                self._state, self._x_t, active, k,
                eos_ids=self._eos_vec(live), sampling=self._sampling,
                generator=self._gen)
        except Exception as e:
            self._fail_active(e)
            return
        self._bump("on_device")
        self._inflight = _Horizon(res, live, k, {
            s: self._slot_req[s].max_new - self._slot_req[s].emitted - k
            for s in live})

    def _maybe_chain(self, h: _Horizon):
        """Dispatch horizon i+1 from horizon i's device-carried chain
        before horizon i is read back. It yields to admission (a queued
        request and a free slot) and to growth (a bigger cache bucket
        copies the caches: read back first)."""
        if self.max_horizon <= 1:
            return
        if not self._q.empty() and self._free_slot() is not None:
            return
        cont = [s for s in h.live if h.budget_after.get(s, 0) > 0
                and self._slot_req[s] is not None]
        if not cont:
            return
        budget = min(h.budget_after[s] for s in cont)
        k2 = self._ladder[min(self._h_streak, len(self._ladder) - 1)]
        k2 = max(1, min(k2, budget))
        # lengths after horizon i are at most mirror + h.k (an EOS freeze
        # advances less, and its rows are gated off)
        need = max(int(self._lengths[s]) + h.k for s in cont) + k2
        if not self.paged and need > self._state.cache_len:
            return  # contiguous growth copies the caches: consume first
        cap = np.zeros((self.slots,), np.int32)
        cap[cont] = 1
        if self.paged:
            if need > self._state.cache_len:
                self._state = self.engine.grow(self._state, need)
            # copy-on-write for the chained horizon, planned against the
            # ASSUMED lengths after horizon i (mirror + h.k); the mirror is
            # restored at once and advanced by the real counts on consume
            saved = self._state.lengths.copy()
            try:
                for s in cont:
                    self._state.lengths[s] = saved[s] + h.k
                self._cow(cont, k2)
            finally:
                self._state.lengths[:] = saved
            dispatch = self.engine.pdecode_multi
        else:
            dispatch = self.engine.decode_multi
        self._state, res = dispatch(
            self._state, None, None, k2, eos_ids=self._eos_vec(cont),
            active_cap=cap, sampling=self._sampling, chain=h.res.chain)
        self._h_streak += 1
        self._bump("on_device")
        self._inflight = _Horizon(
            res, cont, k2, {s: h.budget_after[s] - k2 for s in cont})

    def _consume_horizon(self):
        """Land the in-flight horizon: chain its successor first, then one
        readback, then the per-token host work (emission, slot reclaim)."""
        h = self._inflight
        self._inflight = None
        self._maybe_chain(h)
        toks, logits, emitted = h.res.fetch()
        for s in h.live:
            if self._slot_req[s] is None:
                continue
            m = int(emitted[:, s].sum())
            for j in range(m):
                self._lengths[s] += 1
                if self.paged:
                    self._state.lengths[s] += 1
                if self._emit_known(s, int(toks[j, s]), logits[j, s]):
                    break

    def _decode_iter(self):
        """The per-token host loop (a custom ``sample_fn`` or
        ``token_to_features``): one decode, then host sampling."""
        active = np.array([1 if r is not None else 0
                           for r in self._slot_req], np.int32)
        live = [i for i in range(self.slots) if active[i]]
        if int(self._lengths[live].max()) >= self._state.cache_len:
            self._state = self.engine.grow(self._state,
                                           self._state.cache_len + 1)
        try:
            if self.draft is not None:
                self._bump("speculative")
                self._speculative_iter(active, live)
                return
            self._bump("host_loop")
            if self.paged:
                self._cow(live, 1)
            self._state, logits = self.engine.decode(self._state, self._x_t,
                                                     active)
        except Exception as e:
            self._fail_active(e)
            return
        self._lengths[live] += 1
        for i in live:
            self._emit_token(i, logits[i])

    def _speculative_iter(self, active, live):
        """Draft-propose, target-verify: the draft engine decodes k
        single-token steps; the target verifies all k in ONE window step.
        Greedy teacher forcing makes the emitted stream the target's own
        greedy stream: an accepted draft token equals the target's argmax
        given exactly the accepted prefix, and the first mismatch emits the
        target's correction. The rollback truncates the lengths: the
        rejected rows' pages stay mapped and the next window overwrites
        them. Raises on a failed dispatch (the caller fails the live
        requests)."""
        k, S = self.speculate_k, self.slots
        need = int(self._lengths[live].max()) + k
        if need > self._state.cache_len:
            self._state = self.engine.grow(self._state, need)
        if need > self._dstate.cache_len:
            self._dstate = self.draft.grow(self._dstate, need)
        # 1) the draft proposes k tokens from its host-owned lengths (the
        # rollback below truncates them)
        with torch.inference_mode():
            self._dstate.lengths.copy_(torch.from_numpy(
                self._dlengths.astype(np.int32)))
        props = np.zeros((S, k), np.int64)
        x_d = self._x_t.copy()
        for j in range(k):
            self._dstate, dlg = self.draft.decode(self._dstate, x_d, active)
            for s in live:
                t = int(np.argmax(dlg[s]))
                props[s, j] = t
                x_d[s, 0] = self.token_to_features(t)
        self._bump("proposed", k * len(live))
        # 2) the target verifies the window [pending, d_1 .. d_{k-1}]
        x_seq = np.zeros((S, k, self._f), np.float32)
        x_seq[:, 0] = self._x_t[:, 0]
        for s in live:
            for i in range(1, k):
                x_seq[s, i] = self.token_to_features(int(props[s, i - 1]))
        self._cow(live, k)
        self._state, vlg = self.engine.verify(self._state, x_seq, active)
        # 3) accept while draft == target argmax; the first mismatch emits
        # the target's correction; the rollback truncates the lengths
        for s in live:
            g = np.argmax(vlg[s], axis=-1)
            accepted, emitted = 0, []
            for i in range(k):
                emitted.append(int(g[i]))
                if int(props[s, i]) != int(g[i]):
                    break
                accepted += 1
            self._bump("accepted", accepted)
            l0 = int(self._lengths[s])
            done = False
            for j, tok in enumerate(emitted):
                done = self._emit_known(s, tok, vlg[s, j])
                if done:
                    break
            if not done:
                new_l = l0 + len(emitted)
                self._lengths[s] = new_l
                self._state.lengths[s] = new_l
                self._dlengths[s] = new_l
