"""SameDiff KV-cache decode rewrite: decode graphs for a fused
transformer.

Port of ``deeplearning4j_tpu/autodiff/decode.py``. ``fusion.fuse_attention``
turns an imported transformer's attention chains into
``attention.fused_sdpa`` sites; this pass clones the graph and swaps every
fused site for ``attention.cached_sdpa`` (or, paged,
``attention.paged_sdpa``, ``ops/flash_attention.py``): the one-token
decode op that appends this step's (k, v) into per-site cache
placeholders and attends the query over the valid prefix. So a SameDiff
transformer takes and returns per-site ``(k, v, length)`` cache state
without touching importer code:

- **prefill** runs the ORIGINAL graph once over the (padded) prompt (K3
  at each fused site on the card) and takes each site's ``k``/``v`` as
  extra targets, so the prompt's cache rows come from the same run that
  computes the prompt's outputs;
- **decode_step** runs the REWRITTEN graph on sequence-length-1 feeds
  (K9 at each site on the card; a paged window of ``Tq > 1`` rows runs
  K10): each site reads ``<site>__k_cache`` / ``<site>__v_cache`` (paged:
  ``__k_pool`` / ``__v_pool`` and the shared ``__page_table__``) and the
  shared ``__cache_lengths__``, and emits its updated caches as extra
  outputs.

Constraints (raised loudly):

- the graph must already be fused (run ``fusion.fuse_attention`` first);
- every op between input and output must be polymorphic over the
  sequence axis (dense, layer norm and activation chains are; a reshape
  that bakes in T is not);
- the fused site's mask bias is DROPPED in the decode replay: the cache
  lengths subsume the prompt's key mask;
- ``decode_step`` refuses a full cache on the host: the ops' insert
  clamps an out-of-range position onto the last row.

Semantics are the engines': prefix-LM (the prompt attends bidirectionally
over itself, generated tokens causally), so N decode steps equal the
full-prefix recompute within the dtype's tolerance.

Divergence from the JAX module: the caches are tensors on the SameDiff's
device (the JAX prefill hands numpy arrays to its jitted replay), so a
decode loop on the card copies nothing to the host but each step's
output; the paged prefill scatters the prompt's rows on the device. The
page table stays a host int32 array, as in JAX.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from .samediff import ARRAY, PLACEHOLDER, SameDiff, _OpRecord, _to_numpy

#: the shared per-row valid-length placeholder of the decode replay
LENGTHS = "__cache_lengths__"
#: the shared page-table placeholder of the PAGED decode replay
PAGE_TABLE = "__page_table__"


@dataclasses.dataclass
class _Site:
    """One rewritten attention site."""
    name: str          # the fused op's output name (kept by the rewrite)
    q: str
    k: str
    v: str
    scale: float
    k_cache: str       # decode-graph placeholder names
    v_cache: str
    k_out: str         # decode-graph cache output names
    v_out: str


class DecodeGraph:
    """A SameDiff graph pair ready for KV-cached generation.

    ``prefill(feeds, lengths, cache_len)`` -> ``(out, caches)`` and
    ``decode_step(feeds, caches, lengths)`` -> ``(out, caches')``: the
    caches are ``{site: {"k": [B, H, C, d], "v": ...}}`` tensors on the
    graph's device (paged: ``[n_pages * page_size, H, d]`` pools, and the
    host page table under ``"__page_table__"``); ``out`` is numpy, as
    ``SameDiff.output`` returns it."""

    def __init__(self, base: SameDiff, decode: SameDiff,
                 sites: List[_Site], output: str,
                 paged: bool = False, page_size: int = 16):
        self.base = base
        self.decode = decode
        self.sites = sites
        self.output = output
        self.paged = bool(paged)
        self.page_size = int(page_size)

    def site_names(self) -> List[str]:
        return [s.name for s in self.sites]

    def prefill(self, feeds: Dict, lengths, cache_len: int):
        """One run of the ORIGINAL (fused) graph over the prompt feeds;
        returns ``(out, caches)`` with each site's prompt k/v in
        zero-padded ``cache_len`` rows. ``lengths`` ``[B]``: the true
        prompt lengths (rows past a row's length hold values the decode
        side's length mask hides).

        Paged graphs: each site's cache is a ``[n_pages * page_size, H,
        d]`` pool instead, its rows mapped through a linear page table
        (row b owns pages ``1 + b * MP ..``; page 0 is the zero page) kept
        in ``caches["__page_table__"]``: a demonstration allocator, where
        a serving deployment owns the refcounted one
        (``serving.kv_pool.PagedKVPool``)."""
        targets = [self.output]
        for s in self.sites:
            targets += [s.k, s.v]
        res = self.base._run(feeds, targets)
        caches = {}
        page_table = None
        for s in self.sites:
            k, v = res[s.k], res[s.v]
            if k.dim() != 4:
                raise ValueError(
                    f"site {s.name!r}: cached decode needs [B,H,T,d] k/v "
                    f"projections, got {tuple(k.shape)}")
            t = k.shape[2]
            if t > cache_len:
                raise ValueError(f"prompt length {t} exceeds cache_len "
                                 f"{cache_len}")
            if self.paged:
                P = self.page_size
                if cache_len % P:
                    raise ValueError(f"cache_len {cache_len} is not a "
                                     f"multiple of page_size {P}")
                B, H, _, d = k.shape
                mp = cache_len // P
                if page_table is None:
                    page_table = (1 + np.arange(B * mp, dtype=np.int32)
                                  ).reshape(B, mp)
                pos = np.arange(t)
                rows = torch.from_numpy(
                    (page_table[:, pos // P].astype(np.int64) * P
                     + pos % P).reshape(-1)).to(k.device)
                pools = {}
                for name, a in (("k", k), ("v", v)):
                    pool = a.new_zeros(((1 + B * mp) * P, H, d))
                    pool[rows] = a.permute(0, 2, 1, 3).reshape(B * t, H, d)
                    pools[name] = pool
                caches[s.name] = pools
            else:
                pad = (0, 0, 0, cache_len - t)
                caches[s.name] = {"k": torch.nn.functional.pad(k, pad),
                                  "v": torch.nn.functional.pad(v, pad)}
        if self.paged:
            caches[PAGE_TABLE] = page_table
        return _to_numpy(res[self.output]), caches

    def _cache_len(self, caches: Dict) -> int:
        if self.paged:
            return caches[PAGE_TABLE].shape[1] * self.page_size
        return next(c["k"].shape[2] for n, c in caches.items()
                    if n != PAGE_TABLE)

    def decode_step(self, feeds: Dict, caches: Dict, lengths):
        """One token (paged: a window of ``Tq`` tokens) through the
        REWRITTEN graph: ``feeds`` are the one-token placeholder feeds;
        returns ``(out, new_caches)``. The caller advances ``lengths``
        afterwards, as the layer walk's callers do."""
        full = dict(feeds)
        full[LENGTHS] = np.asarray(lengths, np.int32)
        # the ops' insert CLAMPS an out-of-range position: without this
        # host check a full cache would overwrite its last row every step
        c = self._cache_len(caches)
        if int(np.max(full[LENGTHS])) >= c:
            raise ValueError(
                f"cache full (lengths {int(np.max(full[LENGTHS]))} >= "
                f"cache_len {c}): re-bucket (contiguous: zero-pad axis 2; "
                "paged: widen the page table) before the next decode_step")
        if self.paged:
            full[PAGE_TABLE] = np.asarray(caches[PAGE_TABLE], np.int32)
        for s in self.sites:
            full[s.k_cache] = caches[s.name]["k"]
            full[s.v_cache] = caches[s.name]["v"]
        targets = [self.output]
        for s in self.sites:
            targets += [s.k_out, s.v_out]
        res = self.decode._run(full, targets)
        new_caches = {s.name: {"k": res[s.k_out], "v": res[s.v_out]}
                      for s in self.sites}
        if self.paged:
            new_caches[PAGE_TABLE] = caches[PAGE_TABLE]
        return _to_numpy(res[self.output]), new_caches

    def generate(self, prompt_feeds: Dict, lengths, cache_len: int,
                 steps: int, next_feeds):
        """Greedy convenience loop: prefill, then ``steps`` decode
        iterations; ``next_feeds(out, step)`` maps the last output to the
        next one-token feeds. Yields each step's output."""
        out, caches = self.prefill(prompt_feeds, lengths, cache_len)
        lengths = np.asarray(lengths).copy()
        for i in range(steps):
            feeds = next_feeds(out, i)
            out, caches = self.decode_step(feeds, caches, lengths)
            lengths = lengths + 1
            yield out


def rewrite_for_decode(sd: SameDiff, output: Optional[str] = None,
                       paged: bool = False,
                       page_size: int = 16) -> DecodeGraph:
    """The decode twin of a fused SameDiff graph.

    The original graph is untouched (it stays the prefill program); the
    clone has every top-level ``attention.fused_sdpa`` record replaced by
    ``attention.cached_sdpa``, or with ``paged=True`` by
    ``attention.paged_sdpa`` reading per-site token-row pools and the
    shared ``__page_table__``, with per-site cache placeholders and the
    shared ``__cache_lengths__``. Raises when the graph has no fused site
    (run ``fusion.fuse_attention(sd)`` first: this pass relies on its
    safety checks)."""
    fused_idx = [i for i, r in enumerate(sd._ops)
                 if r.op == "attention.fused_sdpa"]
    if not fused_idx:
        raise ValueError(
            "graph has no attention.fused_sdpa sites; run "
            "autodiff.fusion.fuse_attention(sd) before rewrite_for_decode")
    if output is None:
        if sd.loss_name:
            output = sd.loss_name
        else:
            raise ValueError("pass output=<variable name> (graph has no "
                             "loss to default to)")
    dec = SameDiff.from_json(sd.to_json(), device=sd.device)
    dec._values = dict(sd._values)
    dec._register(LENGTHS, PLACEHOLDER)
    if paged:
        dec._register(PAGE_TABLE, PLACEHOLDER)
    sites: List[_Site] = []
    for idx in fused_idx:
        rec = dec._ops[idx]
        q, k, v = rec.inputs[:3]   # an optional 4th input (the mask bias)
        #                            is dropped: lengths subsume it
        o = rec.output
        suffix = "pool" if paged else "cache"
        kc, vc = f"{o}__k_{suffix}", f"{o}__v_{suffix}"
        ko, vo = f"{o}__k_{suffix}_out", f"{o}__v_{suffix}_out"
        dec._register(kc, PLACEHOLDER)
        dec._register(vc, PLACEHOLDER)
        dec._register(ko, ARRAY)
        dec._register(vo, ARRAY)
        scale = float(rec.attrs.get("scale", 1.0))
        if paged:
            dec._ops[idx] = _OpRecord(
                "attention.paged_sdpa",
                [q, k, v, kc, vc, PAGE_TABLE, LENGTHS],
                [o, ko, vo],
                {"scale": scale, "page_size": int(page_size)})
        else:
            dec._ops[idx] = _OpRecord(
                "attention.cached_sdpa", [q, k, v, kc, vc, LENGTHS],
                [o, ko, vo], {"scale": scale})
        sites.append(_Site(name=o, q=q, k=k, v=v, scale=scale,
                           k_cache=kc, v_cache=vc, k_out=ko, v_out=vo))
    return DecodeGraph(sd, dec, sites, output, paged=paged,
                       page_size=page_size)
