"""Paged KV-cache pool: the host-side page allocator and the prefix
registry.

Port of ``deeplearning4j_tpu/serving/kv_pool.py``. The device holds ONE
pool of fixed-size pages per attention layer (``[n_pages * page_size, H,
d]`` token rows, ``nn.model.MultiLayerNetwork.paged_cache_spec``);
everything that decides WHICH page holds WHAT lives here, in plain host
Python:

- the allocator: a free list over page ids with per-page reference
  counts; page 0 is reserved as the zero page (unallocated page-table
  entries point there, and gated writes are no-ops against it);
- the prefix registry: an admitted prompt registers its pages under
  :func:`prompt_key`, the digest of the FULL prompt (the stack's prefix-LM
  prompts attend bidirectionally over themselves, so a shared token
  prefix under another suffix has other deep-layer k/v; only identical
  prompts share pages), with the prefill's logits; an identical later
  prompt maps the SAME pages (refcounted) and reuses the logits;
- copy-on-write: a page with refcount > 1 is never written; the engine
  forks it on first write (``PagedGenerativeEngine.prepare_write`` and
  ``fork``). This module answers :meth:`PagedKVPool.shared`, hands out
  :meth:`PagedKVPool.ref_snapshot` and counts forks;
- eviction under pressure: when the free list runs dry, registry entries
  are dropped least recently used first (their pages return once no live
  stream holds them); only a pool whose every page is pinned by a LIVE
  stream raises :class:`PoolExhausted`.

Divergences from the JAX module: the counters are plain integers (the
port has no telemetry registry yet, so there are no ``serving.page_pool.*``
gauges or counters to scrape, and no ``engine_id`` / ``pool_label`` to
label them with); there is no ``serving.page_pool`` fault site
(``runtime/faults.py`` comes with the runtime slice, ROADMAP.md Queue 1).

Thread-safety: one decode worker owns admission and release; ``stats()``
may be read from any thread; all state mutates under one lock.
"""

from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence

import numpy as np


def prompt_key(x, plen: int) -> str:
    """Content key of one FULL prompt: its length and its float32 feature
    bytes through blake2b (the JAX package's key, bit for bit)."""
    h = hashlib.blake2b(digest_size=16)
    h.update(np.int64(int(plen)).tobytes())
    h.update(np.ascontiguousarray(np.asarray(x)[:int(plen)],
                                  dtype=np.float32).tobytes())
    return h.hexdigest()


class PoolExhausted(RuntimeError):
    """Every page is pinned by a live stream: the admission fails, as a
    full queue fails a submit."""


class _PrefixEntry:
    __slots__ = ("pages", "plen", "logits")

    def __init__(self, pages: List[int], plen: int, logits: np.ndarray):
        self.pages = list(pages)
        self.plen = int(plen)
        self.logits = np.asarray(logits).copy()


class PagedKVPool:
    """Host bookkeeping for one engine's device page pool. ``n_pages``
    counts ALL physical pages, the reserved zero page included, as the
    device pool of ``model.paged_cache_spec(n_pages, page_size)`` does:
    ``n_pages - 1`` are allocatable."""

    def __init__(self, n_pages: int, page_size: int):
        if n_pages < 2:
            raise ValueError("paged pool needs >= 2 pages (page 0 is the "
                             "reserved zero page)")
        self.n_pages = int(n_pages)
        self.page_size = int(page_size)
        self._lock = threading.RLock()
        self._free: List[int] = list(range(self.n_pages - 1, 0, -1))
        self._ref = np.zeros(self.n_pages, np.int64)
        self._prefix: "OrderedDict[str, _PrefixEntry]" = OrderedDict()
        self.pages_peak = 0
        self._hits = self._misses = self._evictions = self._forks = 0
        self._adoptions = 0

    # ----------------------------------------------------------- allocator
    def _note_free(self):
        in_use = (self.n_pages - 1) - len(self._free)
        if in_use > self.pages_peak:
            self.pages_peak = in_use

    def alloc(self, n: int = 1) -> List[int]:
        """``n`` fresh pages at refcount 1. Under pressure, evicts registry
        entries least recently used first; raises :class:`PoolExhausted`
        only when live streams pin everything. All or nothing: a failed
        alloc takes no page."""
        with self._lock:
            while len(self._free) < n and self._evict_one():
                pass
            if len(self._free) < n:
                raise PoolExhausted(
                    f"paged KV pool exhausted: need {n} pages, "
                    f"{len(self._free)} free of {self.n_pages - 1} "
                    "(every page pinned by live streams)")
            out = [self._free.pop() for _ in range(n)]
            for p in out:
                self._ref[p] = 1
            self._note_free()
            return out

    def retain(self, pages: Sequence[int]) -> None:
        with self._lock:
            for p in pages:
                if p:
                    self._ref[p] += 1

    def _unref_locked(self, pages: Sequence[int]) -> None:
        for p in pages:
            if not p:
                continue
            self._ref[p] -= 1
            if self._ref[p] <= 0:
                self._ref[p] = 0
                self._free.append(int(p))
        self._note_free()

    def release(self, pages: Sequence[int]) -> None:
        """Drop one reference per page; a page at refcount 0 returns to the
        free list (a registered prefix's pages live on through the
        registry's own reference)."""
        with self._lock:
            self._unref_locked(pages)

    def shared(self, page: int) -> bool:
        """True when a write to ``page`` would be seen through another
        reference (another stream or the registry): the copy-on-write
        trigger."""
        with self._lock:
            return bool(page) and self._ref[page] > 1

    def ref_snapshot(self) -> np.ndarray:
        """One locked copy of the refcounts: the batcher takes it once per
        round and probes it in place of :meth:`shared` per page. Only the
        calling decode worker raises a refcount, so a stale entry can at
        worst cause a needless fork, never lose one."""
        with self._lock:
            return self._ref.copy()

    def note_fork(self, n: int = 1) -> None:
        with self._lock:
            self._forks += int(n)

    def adopt(self, n: int = 1) -> List[int]:
        """Fresh pages for MIGRATED contents: allocated as :meth:`alloc`
        allocates (refcount 1, the adopting stream's reference; the caller
        registers a migrated prefix for the registry's own reference), but
        counted apart so the pool's stats split locally prefilled pages
        from adopted ones."""
        out = self.alloc(n)
        with self._lock:
            self._adoptions += len(out)
        return out

    # ------------------------------------------------------ prefix registry
    def lookup_prefix(self, key: str) -> Optional[_PrefixEntry]:
        """Map a registered prompt: one more reference on each of its
        pages for the new stream, LRU recency refreshed, a hit counted.
        None (a counted miss) for an unknown key."""
        with self._lock:
            e = self._prefix.get(key)
            if e is None:
                self._misses += 1
                return None
            self._prefix.move_to_end(key)
            for p in e.pages:
                self._ref[p] += 1
            self._hits += 1
            return e

    def peek_prefix(self, key: str) -> bool:
        """True when ``key`` is registered here. Bumps no refcount or LRU
        recency and counts no hit or miss: the disaggregated router probes
        every decode replica for every prompt, and a counted miss per
        probe would poison the pool's hit rate."""
        with self._lock:
            return key in self._prefix

    def register_prefix(self, key: str, pages: Sequence[int], plen: int,
                        logits) -> None:
        """Record a freshly prefilled prompt's pages and logits. The
        registry holds its OWN reference on each page, so the prefix
        outlives the stream that paid for the prefill."""
        with self._lock:
            if key in self._prefix:
                return
            e = _PrefixEntry(list(pages), plen, logits)
            for p in e.pages:
                self._ref[p] += 1
            self._prefix[key] = e

    def _evict_one(self) -> bool:
        if not self._prefix:
            return False
        _key, e = self._prefix.popitem(last=False)
        self._evictions += 1
        self._unref_locked(e.pages)
        return True

    def clear_prefixes(self) -> None:
        """Forget every registered prefix (the pool's contents were
        rebuilt, so registered pages no longer hold their prompts)."""
        with self._lock:
            while self._prefix:
                _key, e = self._prefix.popitem(last=False)
                self._unref_locked(e.pages)

    # ----------------------------------------------------------------- view
    def pages_free(self) -> int:
        with self._lock:
            return len(self._free)

    def stats(self) -> Dict:
        """The JAX pool's keys (``kv_pool.py:286-300``)."""
        with self._lock:
            return {
                "page_size": self.page_size,
                "pages_total": self.n_pages - 1,
                "pages_free": len(self._free),
                "pages_in_use": (self.n_pages - 1) - len(self._free),
                "pages_peak": self.pages_peak,
                "prefix_entries": len(self._prefix),
                "prefix_hits": self._hits,
                "prefix_misses": self._misses,
                "evictions": self._evictions,
                "forks": self._forks,
                "adoptions": self._adoptions,
            }
