"""Attention layers: SelfAttentionLayer, LearnedSelfAttentionLayer and
RecurrentAttentionLayer.

Port of ``deeplearning4j_tpu/nn/layers/attention.py`` (the helpers
:37-138, ``SelfAttentionLayer`` :179, ``LearnedSelfAttentionLayer``
:283, ``RecurrentAttentionLayer`` :381), with the same JSON kinds
(``self_attention``, ``learned_self_attention``, ``recurrent_attention``),
fields and parameter names (``Wq``, ``Wk``, ``Wv``, ``Wo``, the optional
biases, the learned query bank ``Q``; ``Wx``, ``Wr``, ``Wc``, ``Wa``,
``b``), so a ZIP the JAX package saved loads unchanged. Layout ``[B, T, F]``; the
heads are the view ``[B, H, T, hs]`` of a ``[B, T, H*hs]`` projection.

``apply`` and ``prefill`` go through ``ops.flash_attention.attention``
with the ``[B, 1, 1, T]`` key mask (K3 on the card, the reference path on
the CPU). The KV-cached decode follows prefix-LM semantics: the prompt
attends bidirectionally over itself; each generated token attends over
everything before it and itself. ``decode_step`` appends the window's k/v
with ``cache_insert`` (in place) and runs ``decode_dispatch`` (K9 on the
card) with ``lengths + 1`` for one token, or ``decode_multiquery_dispatch``
(K10 on the card) with ``lengths`` (the rows BEFORE the window) for a
speculative verify window of ``Tq = k`` tokens; ``full_context`` is the
quadratic oracle with an explicit prefix-LM bias. The prompt's
bucket-padded rows land in the cache too; the decode side's lengths mask
them.

With ``page_table`` / ``page_size`` the cache is one layer's paged pool
(``[NP * P, H, d]`` token rows): ``_paged_cache_append`` (the JAX module's
:141) scatters the window's rows through the table with ``paged_insert``
(in place, write-gated) and gathers the per-slot ``[S, H, MP*P, d]``
caches the attention kernels read with ``paged_gather``.

Every projection goes through ``ops.quantize.qdot``: a quantized
params tree (int8 serving) takes the int8 matmul with no change here.
With ``kv_quant`` the caches (contiguous or paged) hold int8 values and
per-row f32 scales (``k_scale``, ``v_scale``: ``[B, H, C, 1]``, or ``[NP *
P, H, 1]`` in a pool) that append through ``cache_insert`` /
``paged_insert`` as ``d = 1`` caches; the window quantizes on append and
the kernels read the dequantized cache (the JAX module's :83-170).

Divergence: the caches and pools are updated in place (the JAX engines
donate theirs).
"""

from __future__ import annotations

from typing import Optional

import torch

from ...ops import activations as _act
from ...ops import flash_attention as _fa
from ...ops import quantize as _q
from .. import weights as _winit
from .base import CacheSpec, Layer, layer

_NEG = float(torch.finfo(torch.float32).min)


def _heads_split(x, n_heads):
    B, T, D = x.shape
    return x.reshape(B, T, n_heads, D // n_heads).transpose(1, 2)


def _heads_join(x):
    B, H, T, hs = x.shape
    return x.transpose(1, 2).reshape(B, T, H * hs)


def _key_mask(mask):
    """``[B, T]`` keep-mask -> additive f32 bias ``[B, 1, 1, T]``."""
    if mask is None:
        return None
    return torch.where(mask[:, None, None, :] > 0,
                       torch.tensor(0.0, device=mask.device),
                       torch.tensor(_NEG, device=mask.device))


def _proj(x, w, b=None):
    return _q.qdot(x, w, b)


#: the four projection weights each multi-head layer quantizes (per output
#: channel, axis 1); the learned queries and the biases stay as they are
_MHA_QUANT_SPEC = {"Wq": 1, "Wk": 1, "Wv": 1, "Wo": 1}


def _qkv(x_q, x_kv, params, n_heads):
    q = _heads_split(_proj(x_q, params["Wq"], params.get("bq")), n_heads)
    k = _heads_split(_proj(x_kv, params["Wk"], params.get("bk")), n_heads)
    v = _heads_split(_proj(x_kv, params["Wv"], params.get("bv")), n_heads)
    return q, k, v


def _mha(x_q, x_kv, params, n_heads, mask):
    q, k, v = _qkv(x_q, x_kv, params, n_heads)
    y = _fa.attention(q, k, v, bias=_key_mask(mask))
    return _proj(_heads_join(y), params["Wo"], params.get("bo"))


def _kv_cache_spec(params, n_heads, batch, cache_len, dtype, kv_quant):
    proj = params["Wk"].shape[1]
    shape = (int(batch), int(n_heads), int(cache_len), proj // n_heads)
    if kv_quant:
        scale = shape[:3] + (1,)
        return {"k": CacheSpec(shape, torch.int8),
                "v": CacheSpec(shape, torch.int8),
                "k_scale": CacheSpec(scale, torch.float32),
                "v_scale": CacheSpec(scale, torch.float32)}
    return {"k": CacheSpec(shape, dtype), "v": CacheSpec(shape, dtype)}


def _cache_fill_prompt(cache, k, v):
    """Write the prompt's k/v into cache positions ``[0, T)``, in place,
    quantized per row when the cache is int8."""
    T = k.shape[2]
    if "k_scale" in cache:
        (k, ks), (v, vs) = _q.quantize_rows(k), _q.quantize_rows(v)
        cache["k_scale"][:, :, :T] = ks
        cache["v_scale"][:, :, :T] = vs
    cache["k"][:, :, :T] = k
    cache["v"][:, :, :T] = v
    return cache


def _paged_cache_append(cache, k_new, v_new, lengths, write, page_table,
                        page_size):
    """Scatter the window's k/v rows into the pool leaves through the page
    table (in place, write-gated), then gather the per-slot ``[B, H, C,
    d]`` caches for the attention kernel; returns ``(cache, k, v)``. An
    int8 pool quantizes the rows on the way in and hands back the gathered
    caches dequantized to the window's dtype."""
    if "k_scale" in cache:
        (kq, ks), (vq, vs) = _q.quantize_rows(k_new), _q.quantize_rows(v_new)
        full = []
        for name, new in (("k", kq), ("v", vq), ("k_scale", ks),
                          ("v_scale", vs)):
            pool = _fa.paged_insert(cache[name], new, lengths, page_table,
                                    page_size, write)
            full.append(_fa.paged_gather(pool, page_table, page_size))
        dt = k_new.dtype
        return (cache, _q.dequantize_rows(full[0], full[2], dt),
                _q.dequantize_rows(full[1], full[3], dt))
    kc = _fa.paged_insert(cache["k"], k_new, lengths, page_table, page_size,
                          write)
    vc = _fa.paged_insert(cache["v"], v_new, lengths, page_table, page_size,
                          write)
    return (cache, _fa.paged_gather(kc, page_table, page_size),
            _fa.paged_gather(vc, page_table, page_size))


def _cache_append(cache, k_new, v_new, lengths, write, page_table=None,
                  page_size=0):
    """Append one window's k/v (in place); returns ``(cache, k, v)``: the
    contiguous caches themselves (dequantized when int8), or the paged
    pool's gathered ones."""
    if page_table is not None:
        return _paged_cache_append(cache, k_new, v_new, lengths, write,
                                   page_table, page_size)
    if "k_scale" in cache:
        (kq, ks), (vq, vs) = _q.quantize_rows(k_new), _q.quantize_rows(v_new)
        kc = _fa.cache_insert(cache["k"], kq, lengths, write)
        vc = _fa.cache_insert(cache["v"], vq, lengths, write)
        ksc = _fa.cache_insert(cache["k_scale"], ks, lengths, write)
        vsc = _fa.cache_insert(cache["v_scale"], vs, lengths, write)
        dt = k_new.dtype
        return (cache, _q.dequantize_rows(kc, ksc, dt),
                _q.dequantize_rows(vc, vsc, dt))
    kc = _fa.cache_insert(cache["k"], k_new, lengths, write)
    vc = _fa.cache_insert(cache["v"], v_new, lengths, write)
    return cache, kc, vc


def _query_bank(params, batch):
    return params["Q"][None].expand((batch,) + tuple(params["Q"].shape))


@layer("self_attention")
class SelfAttentionLayer(Layer):
    """DL4J SelfAttentionLayer: multi-head scaled-dot self-attention with
    input projections; output ``[B, T, n_out]``. ``n_out=0`` resolves to
    the input feature size at init; ``has_bias`` adds a bias to each
    projection (DL4J's layer has none, the default)."""
    quantizable = True
    n_out: int = 0
    n_heads: int = 1
    head_size: Optional[int] = None
    weight_init: str = "xavier"
    has_bias: bool = False
    l1: float = 0.0
    l2: float = 0.0
    name: Optional[str] = None

    def initialize(self, gen, input_shape, dtype, device):
        t, f = int(input_shape[0]), int(input_shape[-1])
        n_out = self.n_out or f
        hs = self.head_size or (n_out // self.n_heads)
        proj = self.n_heads * hs

        def w(shape, fi, fo):
            return _winit.init(self.weight_init, gen, shape, fi, fo, dtype,
                               device)

        params = {"Wq": w((f, proj), f, proj), "Wk": w((f, proj), f, proj),
                  "Wv": w((f, proj), f, proj),
                  "Wo": w((proj, n_out), proj, n_out)}
        if self.has_bias:
            for name, n in (("bq", proj), ("bk", proj), ("bv", proj),
                            ("bo", n_out)):
                params[name] = torch.zeros(n, dtype=dtype, device=device)
        return params, {}, (t, n_out)

    def apply(self, params, x, state, *, train=False, mask=None):
        y = _mha(x, x, params, self.n_heads, mask)
        if mask is not None:
            y = y * mask[..., None]  # masked steps emit zeros (DL4J)
        return y, state, mask

    def quantize_spec(self, params):
        return dict(_MHA_QUANT_SPEC)

    def decode_cache_spec(self, params, batch, cache_len, dtype,
                          kv_quant=False):
        return _kv_cache_spec(params, self.n_heads, batch, cache_len,
                              dtype, kv_quant)

    def prefill(self, params, x, state, *, cache, lengths, mask=None):
        q, k, v = _qkv(x, x, params, self.n_heads)
        y = _fa.attention(q, k, v, bias=_key_mask(mask))
        y = _proj(_heads_join(y), params["Wo"], params.get("bo"))
        if mask is not None:
            y = y * mask[..., None]
        return y, _cache_fill_prompt(cache, k, v)

    def decode_step(self, params, x, state, *, cache, lengths, write=None,
                    page_table=None, page_size=0):
        """One decode window ``x`` ``[B, Tq, F]``: Tq = 1 for plain decode
        (K9), Tq = k for a speculative verify window (window-causal: token
        i sees the prefix and the window up to itself; K10).
        ``page_table`` / ``page_size`` switch the cache to the paged pool
        form."""
        q, k_new, v_new = _qkv(x, x, params, self.n_heads)
        cache, kf, vf = _cache_append(cache, k_new, v_new, lengths, write,
                                      page_table, page_size)
        if x.shape[1] == 1:
            y = _fa.decode_dispatch(q, kf, vf, lengths + 1)
        else:
            y = _fa.decode_multiquery_dispatch(q, kf, vf, lengths)
        return _proj(_heads_join(y), params["Wo"], params.get("bo")), cache

    def full_context(self, params, x, state, *, bias, key_bias):
        """The full-recompute oracle: an explicit ``[B, 1, T, T]`` bias
        (the prefix-LM mask) through the reference path (a per-query bias
        is not key-reducible: ``fallback_bias`` on the card)."""
        q, k, v = _qkv(x, x, params, self.n_heads)
        y = _fa.attention(q, k, v, bias=bias)
        return _proj(_heads_join(y), params["Wo"], params.get("bo"))


@layer("learned_self_attention")
class LearnedSelfAttentionLayer(Layer):
    """DL4J LearnedSelfAttentionLayer: ``n_queries`` learned query vectors
    attend over the sequence; output ``[B, n_queries, n_out]``."""
    quantizable = True
    n_out: int = 0
    n_heads: int = 1
    n_queries: int = 1
    head_size: Optional[int] = None
    weight_init: str = "xavier"
    l1: float = 0.0
    l2: float = 0.0
    name: Optional[str] = None

    def initialize(self, gen, input_shape, dtype, device):
        f = int(input_shape[-1])
        hs = self.head_size or (self.n_out // self.n_heads)
        proj = self.n_heads * hs

        def w(shape, fi, fo):
            return _winit.init(self.weight_init, gen, shape, fi, fo, dtype,
                               device)

        params = {"Q": w((self.n_queries, f), f, f),
                  "Wq": w((f, proj), f, proj), "Wk": w((f, proj), f, proj),
                  "Wv": w((f, proj), f, proj),
                  "Wo": w((proj, self.n_out), proj, self.n_out)}
        return params, {}, (self.n_queries, self.n_out)

    def apply(self, params, x, state, *, train=False, mask=None):
        q = _query_bank(params, x.shape[0])
        y = _mha(q, x, params, self.n_heads, mask)
        return y, state, None  # n_queries steps: no time mask any more

    # the query bank re-attends over the growing cache each step; the
    # learned queries are not positions, so only key validity masks apply
    def quantize_spec(self, params):
        return dict(_MHA_QUANT_SPEC)

    def decode_cache_spec(self, params, batch, cache_len, dtype,
                          kv_quant=False):
        return _kv_cache_spec(params, self.n_heads, batch, cache_len,
                              dtype, kv_quant)

    def _bank_q(self, params, batch):
        return _heads_split(_proj(_query_bank(params, batch), params["Wq"]),
                            self.n_heads)

    def prefill(self, params, x, state, *, cache, lengths, mask=None):
        q = self._bank_q(params, x.shape[0])
        k = _heads_split(_proj(x, params["Wk"]), self.n_heads)
        v = _heads_split(_proj(x, params["Wv"]), self.n_heads)
        y = _fa.attention(q, k, v, bias=_key_mask(mask))
        return (_proj(_heads_join(y), params["Wo"]),
                _cache_fill_prompt(cache, k, v))

    def decode_step(self, params, x, state, *, cache, lengths, write=None,
                    page_table=None, page_size=0):
        if x.shape[1] != 1:
            raise ValueError(
                "learned_self_attention cannot verify a multi-token "
                "window (its output is a query-bank summary, not "
                "per-token); use a self-attention stack for speculative "
                "decoding")
        q = self._bank_q(params, x.shape[0])
        k_new = _heads_split(_proj(x, params["Wk"]), self.n_heads)
        v_new = _heads_split(_proj(x, params["Wv"]), self.n_heads)
        cache, kf, vf = _cache_append(cache, k_new, v_new, lengths, write,
                                      page_table, page_size)
        # n_queries > 1: decode_dispatch takes the length-masked reference
        # (decode_fallback_multiquery), uniform visibility over the cache
        y = _fa.decode_dispatch(q, kf, vf, lengths + 1)
        return _proj(_heads_join(y), params["Wo"]), cache

    def full_context(self, params, x, state, *, bias, key_bias):
        q = self._bank_q(params, x.shape[0])
        k = _heads_split(_proj(x, params["Wk"]), self.n_heads)
        v = _heads_split(_proj(x, params["Wv"]), self.n_heads)
        y = _fa.attention(q, k, v, bias=key_bias)
        return _proj(_heads_join(y), params["Wo"])


@layer("recurrent_attention")
class RecurrentAttentionLayer(Layer):
    """DL4J RecurrentAttentionLayer: an RNN whose step attends over the
    whole input sequence with the previous hidden state as the query,
    ``h_t = act(x_t Wx + h_{t-1} Wr + attention(h_{t-1}, X) Wc + b)``.
    Scores and softmax are float32, masked keys score
    ``finfo(float32).min``, and a masked step keeps ``h``. The scan is a
    Python loop over T; no truncated BPTT (the JAX layer has none)."""
    n_out: int = 0
    activation: str = "tanh"
    weight_init: str = "xavier"
    l1: float = 0.0
    l2: float = 0.0
    name: Optional[str] = None

    def initialize(self, gen, input_shape, dtype, device):
        t, f = int(input_shape[0]), int(input_shape[-1])
        u = self.n_out

        def w(shape, fi, fo):
            return _winit.init(self.weight_init, gen, shape, fi, fo, dtype,
                               device)

        params = {"Wx": w((f, u), f, u), "Wr": w((u, u), u, u),
                  "Wc": w((f, u), f, u), "Wa": w((u, f), u, f),
                  "b": torch.zeros((u,), dtype=dtype, device=device)}
        return params, {}, (t, u)

    def apply(self, params, x, state, *, train=False, mask=None):
        act = _act.get(self.activation)
        B, T, F = x.shape
        wx, wr, wc, wa, b = (params[k] for k in ("Wx", "Wr", "Wc", "Wa",
                                                 "b"))
        xf = x.float()
        scale = float(F) ** 0.5
        h = x.new_zeros((B, self.n_out))
        ys = []
        for t in range(T):
            q = torch.matmul(h, wa)                               # [B, F]
            scores = torch.einsum("bf,btf->bt", q.float(), xf) / scale
            if mask is not None:
                scores = torch.where(mask > 0, scores,
                                     torch.full_like(scores, _NEG))
            w = torch.softmax(scores, dim=-1).to(x.dtype)
            ctx = torch.einsum("bt,btf->bf", w, x)
            h_new = act(torch.matmul(x[:, t], wx) + torch.matmul(h, wr)
                        + torch.matmul(ctx, wc) + b)
            if mask is not None:
                h_new = torch.where(mask[:, t, None] > 0, h_new, h)
            h = h_new
            ys.append(h)
        if not ys:
            return x.new_empty((B, 0, self.n_out)), state, mask
        return torch.stack(ys, dim=1), state, mask
