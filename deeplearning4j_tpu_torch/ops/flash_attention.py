"""Attention dispatch and the ``attention.fused_sdpa`` catalog op.

Port of the dispatch half of ``deeplearning4j_tpu/ops/flash_attention.py``:

- :func:`reference_attention`: the quadratic path with the kernel's
  numerics (f32 scores, f32 softmax, p cast to v's dtype, f32
  accumulation, output in q's dtype);
- :func:`attention`: the dispatcher the SameDiff ``attention.fused_sdpa``
  op enters. It routes to K3 (``kernels/flash_attention.py``) for CUDA
  tensors when the bias reduces to one row per key, else to the reference
  path, and counts every decision in :func:`counters`;
- ``_FlashAttention``, the autograd node of the fused route (the JAX
  package's ``_flash`` custom VJP): its forward launches K3 and saves q,
  k, v, the key bias, o, m and l; its backward computes ``di =
  rowsum(o * do)`` in f32 with a torch op and launches the fused
  backward (K4 + K5) once for dq, dk and dv (or for dq alone, or dk and
  dv alone, when only those are needed).

Decisions (one per call; the counters are this package's own):

- ``fused``: a CUDA tensor in mode ``auto`` with no bias or a key-reducible
  one (``[B or 1, 1, 1, Tk]``): K3 runs, and the fused K4 + K5 in the
  backward.
- ``fallback_mode``: mode ``off`` on CPU tensors (the reference path). On
  CUDA tensors mode ``off`` raises a ValueError: the card has no route
  around K3/K4/K5 but the bias one below.
- ``fallback_platform``: a CPU tensor: the reference path.
- ``fallback_bias``: a bias that varies over heads or queries: the
  reference path, differentiated by autograd. The only card route away
  from the kernels.

Divergences from the JAX dispatcher, by design:

- No ``fallback_shape``, ``fallback_dtype`` or ``fallback_vmem``: K3 masks
  ragged sequence lengths itself and has no VMEM budget. A CUDA input K3
  cannot take (a dtype other than f32/bf16/f16, a head dimension above
  ``kernels.flash_attention.MAX_HEAD_DIM``, shapes that are not
  ``[B, H, T, d]``) raises instead of running the reference path.
- Decisions are counted once per call: the port runs eagerly, there is no
  trace to count once.
- There is no ``force`` mode: it ran the Pallas kernel in interpret mode
  on the CPU, and a CUDA kernel has no such mode.
- Mode ``off`` is refused for CUDA tensors (the JAX package runs its
  reference path there), by the decode dispatch too.
- The key bias gets no gradient (None), as the JAX package's zero
  cotangent: it is a mask-derived constant on this route. A learned bias
  that varies over heads or queries takes ``fallback_bias``, where autograd
  differentiates it.

The decode half (the JAX module's :556-1051, without the tensor-parallel
branch):

- :func:`length_bias` (:556) and :func:`reference_decode_attention`
  (:567), both K9's module's (``kernels/decode_attention.py``): the length
  mask and K9's plain version, K3's at any number of query rows;
  :func:`cache_insert` (:622); :func:`reference_decode_multiquery`
  (:747), K10's plain version (``kernels/multiquery_decode.py``);
- :func:`decode_dispatch` (:1027), the entry of the KV-cached attention
  layers' ``decode_step``. Its decisions, read through
  :func:`decode_counters` (one per call):

  - ``decode_fused``: a CUDA ``q`` of one query row in mode ``auto``: K9
    (``kernels/decode_attention.py``) with the lengths as int32;
  - ``decode_fallback_platform``: a CPU tensor: K9's wrapper, which runs
    its plain version there;
  - ``decode_fallback_mode``: mode ``off`` on CPU tensors, the same plain
    version (on CUDA tensors it raises, as :func:`attention` does);
  - ``decode_fallback_multiquery``: a query bank of ``Tq > 1`` rows with
    uniform visibility over the valid cache
    (``LearnedSelfAttentionLayer`` with ``n_queries > 1``): the
    length-masked plain version on both devices, as in the JAX package,
    which has no kernel for it either. It is the one route on which a
    CUDA tensor runs plain torch ops and neither a kernel nor a refusal
    (``ROADMAP.md`` Queue 3); the counter shows each use.

  A ``q`` that is not ``[B, H, Tq, d]`` raises: there is no
  ``decode_fallback_shape``, ``_dtype`` or ``_vmem`` (K9 takes every cache
  length; the dtype and head-dimension limits raise in its wrapper).
- :func:`decode_multiquery_dispatch` (:1091), the speculative verify
  window (``Tq = k`` queries, window-causal): K10's wrapper
  (``kernels/multiquery_decode.py``), counted ``decode_multiquery`` for a
  CUDA ``q`` in mode ``auto`` (K10 runs) and ``decode_multiquery_fallback``
  for a CPU one (the wrapper's plain version, as the JAX package runs its
  reference off the TPU); mode ``off`` runs the plain version on CPU
  tensors and raises on CUDA ones. There is no tensor-parallel branch.

The paged half (the JAX module's :652-711), over one layer's pool of
``[NP * P, H, d]`` token rows and a ``[S, MP]`` page table (page 0 is the
reserved zero page):

- :func:`paged_positions` (:665): logical positions to pool rows, the
  page index clamped to the table's last entry (XLA's gather clamp);
- :func:`paged_gather` (:677): the per-slot caches ``[S, H, MP*P, d]``;
- :func:`paged_insert` (:691): a window's rows scattered through the
  table IN PLACE, with the write gate (gated rows write back what they
  gathered, a no-op even on the zero page);
- :func:`page_rows` (:711): the rows of whole pages;
- :func:`page_export` / :func:`page_import` (:721-737): the KV-page
  migration of disaggregated serving, one gather or one gated scatter a
  call. The JAX package leaves both to XLA outside any Pallas kernel, so
  they are torch indexing here, as :func:`paged_insert` is.

The SameDiff decode graphs' catalog ops (the JAX module's :1126-1182,
the rewrite targets of ``autodiff/decode.py``), inference-only:

- ``attention.cached_sdpa``: one decode step over a contiguous cache;
  :func:`cache_insert`, then :func:`decode_dispatch` (K9 on the card);
- ``attention.paged_sdpa``: one window over a paged pool;
  :func:`paged_insert` and :func:`paged_gather`, then
  :func:`decode_dispatch` for ``Tq = 1`` (K9) or
  :func:`decode_multiquery_dispatch` for ``Tq > 1`` (K10).

Both return ``(y, cache_k', cache_v')`` as new tensors, as the JAX ops do:
the graph threads the caches through its replay, and the caller's feeds
stay untouched (the engines' in-place updates are theirs alone).

``cache_insert`` keeps ``dynamic_update_slice``'s semantics: a start index
past ``C - k`` clamps to ``C - k`` (a negative one counts from the end
first, as JAX indexes), and rows with ``write == 0`` write back the values
they gathered, so they stay bit for bit. Unlike the JAX function it
updates ``cache`` IN PLACE and returns it: the caller owns the cache (the
JAX engines donate theirs, which XLA turns into the same in-place
update).

The decode decisions are kept apart from :func:`counters` (read through
:func:`decode_counters`); :func:`reset_counters` zeroes both.
"""

from __future__ import annotations

import collections
import math
from typing import Optional

import torch

from . import register
from ..kernels import decode_attention as _k9
from ..kernels import flash_attention as _k3
from ..kernels import multiquery_decode as _k10

_NEG = float(torch.finfo(torch.float32).min)
_MODES = ("auto", "off")
_COUNTER_KEYS = ("fused", "fallback_mode", "fallback_platform",
                 "fallback_bias")
_DECODE_KEYS = ("decode_fused", "decode_fallback_mode",
                "decode_fallback_platform", "decode_fallback_multiquery",
                "decode_multiquery", "decode_multiquery_fallback")
_counts = collections.Counter()
_state = {"mode": "auto"}

#: output gradients copied to a contiguous last dimension before K4/K5
#: (a plain integer; set it to 0). The BERT path's head merge hands the
#: backward row-contiguous views, so it stays 0 there.
do_copies = 0


def reference_attention(q, k, v, bias=None, scale: Optional[float] = None):
    """Quadratic attention with the kernel's numerics: scores in f32 (f64
    for f64 inputs), softmax in f32, ``p @ v`` accumulated in f32, output
    in q's dtype. q: ``[..., Tq, d]``; k, v: ``[..., Tk, d]``; bias
    broadcastable to ``[..., Tq, Tk]`` (additive, large-negative masks),
    clamped to ``finfo(float32).min``."""
    d = q.shape[-1]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    ct = torch.promote_types(q.dtype, torch.float32)
    s = torch.matmul(q.to(ct), k.to(ct).transpose(-1, -2)) * scale
    if bias is not None:
        s = s + torch.clamp(bias.to(ct), min=_NEG)
    p = torch.softmax(s, dim=-1)
    y = torch.matmul(p.to(v.dtype).to(ct), v.to(ct))
    return y.to(q.dtype)


def _key_bias(bias, batch, tk):
    """Reduce an additive bias broadcastable to ``[B, H, Tq, Tk]`` to the
    per-(batch, key) form ``[B, Tk]`` K3 reads, or None when the bias
    varies over heads or queries."""
    if bias is None:
        return None
    if bias.dim() != 4 or bias.shape[1] != 1 or bias.shape[2] != 1:
        return None
    if bias.shape[0] not in (1, batch) or bias.shape[3] != tk:
        return None
    kb = torch.broadcast_to(bias[:, 0, 0, :], (batch, tk))
    return torch.clamp(kb.float(), min=_NEG).contiguous()


def mode() -> str:
    return _state["mode"]


def set_mode(m: str) -> str:
    """``auto`` (CUDA tensors run K3, CPU tensors the reference path) or
    ``off`` (the reference path everywhere). Returns the previous mode.
    The mode starts at ``auto`` and changes only here."""
    if m not in _MODES:
        raise ValueError(f"flash attention mode {m!r} not in {_MODES} (the "
                         "port has no interpret mode, so no 'force')")
    old = _state["mode"]
    _state["mode"] = m
    return old


def counters() -> dict:
    """Dispatch-decision counts since the last reset (one per call)."""
    return {k: int(_counts[k]) for k in _COUNTER_KEYS}


def decode_counters() -> dict:
    """Decode dispatch-decision counts since the last reset (one per
    call)."""
    return {k: int(_counts[k]) for k in _DECODE_KEYS}


def reset_counters() -> None:
    """Zero the decision counters (the decode ones too) and
    ``do_copies``."""
    global do_copies
    _counts.clear()
    do_copies = 0


def _route(q, k, v, bias) -> Optional[str]:
    """None = fuse; otherwise the fallback counter key."""
    if _state["mode"] == "off":
        if q.device.type == "cuda":
            raise ValueError(
                "flash attention mode 'off' is refused for CUDA tensors: "
                "on the card attention runs K3 forward and K4/K5 backward "
                "(set_mode('auto'))")
        return "fallback_mode"
    if q.device.type != "cuda":
        return "fallback_platform"
    if bias is not None and (q.dim() != 4 or k.dim() != 4 or _key_bias(
            bias, q.shape[0], k.shape[2]) is None):
        return "fallback_bias"
    return None


class _FlashAttention(torch.autograd.Function):
    """The fused route as an autograd node: K3 forward, the fused K4 + K5
    backward (the JAX package's ``_flash_fwd``/``_flash_bwd``)."""

    @staticmethod
    def forward(ctx, q, k, v, kb, scale):
        o, m, l = _k3.flash_attention_fwd(q, k, v, kb, scale)
        ctx.save_for_backward(q, k, v, kb, o, m, l)
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, do):
        global do_copies
        q, k, v, kb, o, m, l = ctx.saved_tensors
        if do.stride(-1) != 1:  # the kernel reads rows in place
            do = do.contiguous()
            do_copies += 1
        di = _k3.attention_di(o, do)
        args = (q, k, v, kb, m, l, di, do, ctx.scale)
        want_dq = ctx.needs_input_grad[0]
        want_dkv = ctx.needs_input_grad[1] or ctx.needs_input_grad[2]
        dq = dk = dv = None
        if want_dq and want_dkv:  # one launch for all three
            dq, dk, dv = _k3.flash_attention_bwd(*args)
        elif want_dq:
            dq = _k3.flash_attention_bwd_dq(*args)
        elif want_dkv:
            dk, dv = _k3.flash_attention_bwd_dkv(*args)
        # the key bias is a mask-derived constant: no gradient
        return dq, dk, dv, None, None


def attention(q, k, v, bias=None, scale: Optional[float] = None):
    """Guarded attention dispatch: K3 when the route is clear, the
    f32-softmax reference path otherwise. q: ``[B, H, Tq, d]``; k, v:
    ``[B, H, Tk, d]``; bias broadcastable to ``[B, H, Tq, Tk]``."""
    reason = _route(q, k, v, bias)
    if reason is None:
        _counts["fused"] += 1
        kb = _key_bias(bias, q.shape[0], k.shape[2])
        return _FlashAttention.apply(q, k, v, kb, scale)
    _counts[reason] += 1
    return reference_attention(q, k, v, bias, scale)


@register("attention.fused_sdpa", category="attention")
def fused_sdpa(q, k, v, bias=None, scale: float = 1.0):
    """Fused scaled-dot-product attention graph op, the rewrite target of
    ``autodiff.fusion.fuse_attention``: ``softmax((q @ k^T) * scale +
    bias, axis=-1) @ v`` with the softmax in f32."""
    return attention(q, k, v, bias=bias, scale=float(scale))


# --------------------------------------------------------------------------
# autoregressive decode: one new-token query over a bucketed KV cache
# --------------------------------------------------------------------------

#: the JAX module's names for K9's length mask and plain version
length_bias = _k9.length_bias
reference_decode_attention = _k9.decode_attention_reference


#: K10's plain version under the JAX module's name
reference_decode_multiquery = _k10.multiquery_decode_reference


def cache_insert(cache, new, lengths, write=None):
    """Append one token window's K or V rows into a bucketed cache, IN
    PLACE: ``cache`` ``[B, H, C, d]``, ``new`` ``[B, H, k, d]`` (k = 1 for
    plain decode, k > 1 for a verify window) written at positions
    ``lengths[b] .. lengths[b] + k - 1``; returns ``cache``.

    ``dynamic_update_slice`` semantics as JAX applies them: a negative
    start counts from the end (``+ C``), then the start clamps to ``[0,
    C - k]``. ``write`` ``[B]`` (optional 0/1):
    rows with ``write == 0`` write back the values gathered at the
    (clamped) positions, so they stay bit-identical, and a freed slot's
    stale length can never touch a neighbour's rows."""
    B, H, C, d = cache.shape
    kw = new.shape[2]
    if new.shape != (B, H, kw, d) or kw > C:
        raise ValueError(f"cache_insert: window {tuple(new.shape)} does not "
                         f"fit the cache {tuple(cache.shape)}")
    start = torch.as_tensor(lengths).to(cache.device).to(torch.int64)
    start = torch.clamp(torch.where(start < 0, start + C, start), 0, C - kw)
    pos = start[:, None] + torch.arange(kw, device=cache.device)[None, :]
    rows = torch.arange(B, device=cache.device)[:, None].expand(B, kw)
    view = cache.transpose(1, 2)                       # [B, C, H, d]
    upd = new.to(cache.dtype).transpose(1, 2)          # [B, k, H, d]
    if write is not None:
        keep = torch.as_tensor(write).to(cache.device).to(torch.bool)
        upd = torch.where(keep[:, None, None, None], upd, view[rows, pos])
    view[rows, pos] = upd
    return cache


def _route_decode(q) -> str:
    """The decode decision for a ``[B, H, Tq, d]`` query."""
    if q.dim() != 4 or q.shape[2] < 1:
        raise ValueError(f"decode attention wants q [B, H, Tq, d]; got "
                         f"{tuple(q.shape)}")
    if q.shape[2] > 1:
        return "decode_fallback_multiquery"
    if _state["mode"] == "off":
        if q.device.type == "cuda":
            raise ValueError(
                "flash attention mode 'off' is refused for CUDA tensors: "
                "on the card decode attention runs K9 (set_mode('auto'))")
        return "decode_fallback_mode"
    if q.device.type != "cuda":
        return "decode_fallback_platform"
    return "decode_fused"


def decode_dispatch(q, k, v, lengths, scale: Optional[float] = None):
    """Guarded decode dispatch: K9's wrapper for a ``q`` of one query row
    (K9 on a CUDA tensor, its plain version on a CPU one), the
    length-masked plain version for a query bank (see the module
    docstring). ``q`` ``[B, H, Tq, d]``; ``k``, ``v`` ``[B, H, C, d]``;
    ``lengths`` ``[B]``: the valid cache entries, the just-appended
    token included."""
    reason = _route_decode(q)
    _counts[reason] += 1
    if reason == "decode_fallback_multiquery":
        return reference_decode_attention(q, k, v, lengths, scale=scale)
    if reason == "decode_fused":
        lengths = torch.as_tensor(lengths)
        if lengths.device != q.device or lengths.dtype != torch.int32:
            lengths = lengths.to(device=q.device, dtype=torch.int32)
        lengths = lengths.contiguous()
    return _k9.decode_attention(q, k, v, lengths, scale)


def decode_multiquery_dispatch(q, k, v, lengths,
                               scale: Optional[float] = None):
    """Guarded multi-query dispatch (the speculative verify window):
    K10's wrapper, which launches K10 on a CUDA ``q`` in mode ``auto``
    (counted ``decode_multiquery``) and runs its plain version on a CPU
    one (``decode_multiquery_fallback``). Mode ``off`` on a CUDA tensor
    raises. ``q`` ``[B, H, k, d]``; ``k``, ``v`` ``[B, H, C, d]``;
    ``lengths`` ``[B]`` counts the valid entries BEFORE the window (its
    own rows are already inserted at ``lengths .. lengths + k - 1``)."""
    if q.dim() != 4 or q.shape[2] < 1:
        raise ValueError(f"decode_multiquery wants q [B, H, k, d]; got "
                         f"{tuple(q.shape)}")
    if q.device.type == "cuda":
        if _state["mode"] == "off":
            raise ValueError(
                "flash attention mode 'off' is refused for CUDA tensors: "
                "on the card the verify window runs K10 (set_mode('auto'))")
        _counts["decode_multiquery"] += 1
        lengths = torch.as_tensor(lengths)
        if lengths.device != q.device or lengths.dtype != torch.int32:
            lengths = lengths.to(device=q.device, dtype=torch.int32)
        lengths = lengths.contiguous()
    else:
        _counts["decode_multiquery_fallback"] += 1
    return _k10.multiquery_decode(q, k, v, lengths, scale)


# --------------------------------------------------------------------------
# paged KV cache: page-table gather and scatter over a pool of token rows
# --------------------------------------------------------------------------

def paged_positions(page_table, positions, page_size: int):
    """Pool rows of logical positions: ``page_table`` ``[S, MP]`` int,
    ``positions`` ``[S, k]`` -> ``[S, k]`` int64. A position past the
    table clamps to its last entry (XLA's gather clamp); callers gate
    those writes."""
    P = int(page_size)
    positions = torch.as_tensor(positions).to(page_table.device) \
        .to(torch.int64)
    pi = torch.clamp(torch.div(positions, P, rounding_mode="floor"), 0,
                     page_table.shape[1] - 1)
    page = torch.gather(page_table.to(torch.int64), 1, pi)
    return page * P + torch.remainder(positions, P)


def paged_gather(pool, page_table, page_size: int):
    """The per-slot caches from the pool: ``pool`` ``[NP*P, H, d]``,
    ``page_table`` ``[S, MP]`` -> ``[S, H, MP*P, d]`` (a new tensor: only
    the pool persists)."""
    P = int(page_size)
    S, MP = page_table.shape
    idx = (page_table.to(torch.int64)[:, :, None] * P
           + torch.arange(P, device=pool.device)[None, None, :]
           ).reshape(S, MP * P)
    return pool[idx].permute(0, 2, 1, 3)


def paged_insert(pool, new, lengths, page_table, page_size: int,
                 write=None):
    """Append a window's K or V rows into the pool IN PLACE: ``new`` ``[S,
    H, k, d]`` written at logical positions ``lengths[s] + i`` through the
    page table; returns ``pool``. ``write`` ``[S]`` (optional 0/1) gates
    rows as :func:`cache_insert` does: a gated row writes back the value
    it gathered, a no-op even on the clamped or zero page."""
    S, H, kw, d = new.shape
    ln = torch.as_tensor(lengths).to(pool.device).to(torch.int64)
    pos = ln[:, None] + torch.arange(kw, device=pool.device)[None, :]
    rows = paged_positions(page_table, pos, page_size).reshape(S * kw)
    upd = new.to(pool.dtype).permute(0, 2, 1, 3).reshape(S * kw, H, d)
    if write is not None:
        keep = torch.as_tensor(write).to(pool.device).to(torch.bool)
        upd = torch.where(keep.repeat_interleave(kw)[:, None, None], upd,
                          pool[rows])
    pool[rows] = upd
    return pool


def page_rows(pages, page_size: int):
    """Pool rows covering WHOLE pages: ``pages`` ``[n]`` page ids ->
    ``[n * page_size]`` int64 rows (page 0 resolves to the zero page)."""
    P = int(page_size)
    pages = torch.as_tensor(pages).to(torch.int64)
    return (pages[:, None] * P
            + torch.arange(P, device=pages.device)[None, :]).reshape(-1)


def page_export(pool, rows):
    """Whole pages out of one layer's pool in ONE gather: ``pool`` ``[NP*P,
    H, d]``, ``rows`` ``[n*P]`` (:func:`page_rows`) -> the ``[n*P, H, d]``
    payload block (a new tensor; never a copy page by page)."""
    return pool[torch.as_tensor(rows).to(pool.device).to(torch.int64)]


def page_import(pool, rows, payload, gate):
    """Whole pages into one layer's pool in ONE scatter, IN PLACE; returns
    ``pool``. ``gate`` ``[n*P]`` (bool or 0/1) follows
    :func:`paged_insert`'s write gate: a gated-off row (bucket padding that
    points at the zero page) writes back the value it gathered, so an
    import never corrupts the zero page or a page another stream holds.
    Padding repeats page 0's rows within one index; the scatter is sound
    only because every such duplicate writes the same gathered value."""
    rows = torch.as_tensor(rows).to(pool.device).to(torch.int64)
    keep = torch.as_tensor(gate).to(pool.device).to(torch.bool)
    upd = torch.where(keep[:, None, None], payload.to(pool.dtype),
                      pool[rows])
    pool[rows] = upd
    return pool


# --------------------------------------------------------------------------
# the SameDiff decode graphs' attention ops
# --------------------------------------------------------------------------

@register("attention.cached_sdpa", category="attention",
          differentiable=False)
def cached_sdpa(q, k_new, v_new, k_cache, v_cache, lengths,
                scale: float = 1.0):
    """KV-cached decode-step attention graph op, the rewrite target of
    ``autodiff.decode.rewrite_for_decode``: appends ``k_new``/``v_new``
    (``[B, H, 1, d]``) at position ``lengths`` (``[B]``, the valid entries
    BEFORE this token) of copies of ``k_cache``/``v_cache`` (``[B, H, C,
    d]``), attends ``q`` over the ``lengths + 1`` valid entries (K9 on the
    card) and returns ``(y, k_cache', v_cache')``. The caller keeps
    ``lengths < C``: an insert past the end clamps onto the last row
    (``DecodeGraph.decode_step`` refuses a full cache on the host)."""
    lengths = torch.as_tensor(lengths).to(q.device)
    kc = cache_insert(k_cache.clone(), k_new, lengths)
    vc = cache_insert(v_cache.clone(), v_new, lengths)
    y = decode_dispatch(q, kc, vc, lengths + 1, scale=float(scale))
    return y, kc, vc


@register("attention.paged_sdpa", category="attention",
          differentiable=False)
def paged_sdpa(q, k_new, v_new, k_pool, v_pool, page_table, lengths,
               scale: float = 1.0, page_size: int = 16):
    """The paged twin of ``attention.cached_sdpa``: ``q``/``k_new``/
    ``v_new`` ``[B, H, Tq, d]``, token-row pools ``[NP * P, H, d]``, the
    page table ``[B, MP]`` and ``lengths`` ``[B]`` (the valid entries
    BEFORE this window). The window's rows are scattered through the table
    into copies of the pools, the per-slot caches gathered, and ``q``
    attends single-query (K9) for ``Tq = 1`` or window-causal (K10) for
    ``Tq > 1``. Returns ``(y, k_pool', v_pool')``; the caller keeps
    ``lengths + Tq <= MP * P`` and forks shared pages first."""
    lengths = torch.as_tensor(lengths).to(q.device)
    kp = paged_insert(k_pool.clone(), k_new, lengths, page_table, page_size)
    vp = paged_insert(v_pool.clone(), v_new, lengths, page_table, page_size)
    kf = paged_gather(kp, page_table, page_size)
    vf = paged_gather(vp, page_table, page_size)
    if q.shape[2] == 1:
        y = decode_dispatch(q, kf, vf, lengths + 1, scale=float(scale))
    else:
        y = decode_multiquery_dispatch(q, kf, vf, lengths,
                                       scale=float(scale))
    return y, kp, vp
