"""K9, single-query decode attention: ``o = softmax(q k[:L]^T * scale)
v[:L]`` per (batch, head) over a KV cache whose rows past ``L =
lengths[b]`` are masked.

Wrapper of ``csrc/decode_attn.cu``, which replaces the JAX package's
``ops/flash_attention.py::decode_attention`` (:576): the flash forward
kernel run at ``bq = 1`` through ``_fwd_impl`` (:616) with
``length_bias`` (:556) as the key bias. ``q`` is ``[B, H, 1, d]``, ``k``
and ``v`` ``[B, H, C, d]``, in f32, bf16 or f16, each a strided view with
a contiguous last dimension (``q`` may be the head split of a ``[B, 1,
H*d]`` projection, read in place); ``lengths`` is int32 ``[B]``: the
valid cache entries of each row, the just-appended token included. The
output is ``[B, H, 1, d]`` in q's dtype, contiguous.

- A row with ``L <= 0`` (an inactive slot, a fresh state) gets uniform
  weights over all ``C`` rows, as the TPU kernel gives it (every score
  there is the clamped bias ``finfo(float32).min``); ``L >= C`` reads all
  ``C`` rows.
- A CPU tensor takes the plain version, :func:`decode_attention_reference`:
  K3's plain version at ``Tq = 1`` (key tile by key tile, the same
  online-softmax rescaling, p rounded to v's dtype before ``p v``, ``o``
  rounded once) with :func:`length_bias` as the key bias, which gives the
  ``L <= 0`` rule by itself.
- A CUDA tensor launches K9, or raises: a dtype other than f32/bf16/f16,
  a head dimension above ``MAX_HEAD_DIM``, mismatched shapes or dtypes,
  ``lengths`` that is not int32 ``[B]`` on the same device, a last
  dimension that is not contiguous, a failed build or a refused launch. No
  CUDA call gives way to the plain version.

K9 splits each row's valid keys over :func:`num_splits` CTAs, which form
one thread-block cluster; each pushes its partial softmax state into rank
0's shared memory and rank 0 merges them in rank order. One kernel a call,
no scratch in device memory, no atomics: a rerun is bitwise equal. In f32
it agrees with the plain version within ``F32_TOL``; in 16-bit within
:func:`tolerance`, ``4 u (sum p |v| / l + |o|)`` per element (p is rounded
against each split's running max, not the plain version's, so bitwise
equality is not expected there).

``launches`` counts wrapper calls that launched K9. :func:`launch_floor`
launches an empty kernel the way K9 is launched, for timing beside it.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from . import _build
from .affine_act import (H100_16BIT_FLOPS_PER_S, H100_BYTES_PER_S,
                         H100_F32_FLOPS_PER_S)
from .flash_attention import MAX_HEAD_DIM, flash_attention_fwd_reference

#: SMs of an H100 SXM; :func:`num_splits` aims at four CTAs on each
SMS = 132
#: the fewest cache rows (of C) one split is given, and the most splits:
#: the splits of a row form one cluster, at most the portable 8 CTAs
MIN_KEYS_PER_SPLIT = 64
MAX_SPLITS = 8
#: a grid of fewer CTAs than this takes 256 threads a CTA, else 128
WIDE_BELOW = 2 * SMS
#: K9 against its plain version in float32: within F32_TOL x max(1,
#: |ref|) (the JAX package's decode kernel-vs-reference contract is 1e-5;
#: the sums run in another order and expf may differ by an ulp)
F32_TOL = 2e-5
_NEG = float(torch.finfo(torch.float32).min)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

#: Kernel launches since the last reset (a plain integer; set it to 0).
launches = 0


def length_bias(lengths, cache_len: int):
    """Per-row valid-length mask in key-bias form: ``[B, C]`` f32, 0 where
    ``position < lengths[b]`` and ``finfo(float32).min`` elsewhere (the
    JAX package's ``length_bias``, :556)."""
    lengths = torch.as_tensor(lengths)
    pos = torch.arange(int(cache_len), device=lengths.device)
    return torch.where(pos[None, :] < lengths[:, None].to(torch.int64),
                       torch.tensor(0.0, device=lengths.device),
                       torch.tensor(_NEG, device=lengths.device))


def decode_attention_reference(q, k, v, lengths, scale=None):
    """K9's plain version: K3's plain version at ``Tq = 1`` with
    :func:`length_bias` as the key bias. A row with ``L <= 0`` has every
    score at the clamped bias, so ``p = 1`` for every key: uniform
    weights over all ``C`` rows, the TPU kernel's rule. Runs wherever its
    tensors are."""
    kb = length_bias(torch.as_tensor(lengths).to(q.device), k.shape[2])
    return flash_attention_fwd_reference(q, k, v, kb, scale)[0]


def num_splits(B: int, H: int, C: int) -> int:
    """The CTAs (one cluster) each (batch, head) row's keys are split
    over: enough for about four CTAs on each of the ``SMS`` SMs, at least
    ``MIN_KEYS_PER_SPLIT`` of the ``C`` cache rows each, at most
    ``MAX_SPLITS``. Picked from the cache length, an upper bound of every
    row's L, so the host reads no length off the device."""
    want = -(-4 * SMS // max(1, B * H))
    return max(1, min(want, -(-C // MIN_KEYS_PER_SPLIT), MAX_SPLITS))


def cta_threads(B: int, H: int, C: int) -> int:
    """Threads a K9 CTA: 256 where the grid of ``B H num_splits`` CTAs
    has fewer than ``WIDE_BELOW`` (each CTA then walks its chunk in fewer
    rounds), else 128."""
    return 256 if B * H * num_splits(B, H, C) < WIDE_BELOW else 128


def _check(q, k, v, lengths):
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"decode_attention: dtype {q.dtype} not supported "
                        "(float32, bfloat16, float16)")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 or q.shape[2] != 1:
        raise ValueError("decode_attention: q must be [B, H, 1, d] and k, v "
                         f"[B, H, C, d]; got {tuple(q.shape)} "
                         f"{tuple(k.shape)} {tuple(v.shape)}")
    B, H, _, d = q.shape
    C = k.shape[2]
    if k.shape != (B, H, C, d) or v.shape != k.shape:
        raise ValueError(f"decode_attention: q/cache shapes disagree: "
                         f"{tuple(q.shape)} {tuple(k.shape)} "
                         f"{tuple(v.shape)}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"decode_attention: q/k/v dtypes disagree: "
                        f"{q.dtype} {k.dtype} {v.dtype}")
    if d > MAX_HEAD_DIM:
        raise ValueError(f"decode_attention: head dimension {d} is above "
                         f"the kernel's limit {MAX_HEAD_DIM}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1 or t.device != q.device:
            raise ValueError(f"decode_attention: {name} must lie on "
                             f"{q.device} with a contiguous last dimension,"
                             f" got strides {t.stride()} on {t.device}")
    if lengths.dtype != torch.int32 or lengths.shape != (B,) \
            or lengths.device != q.device or not lengths.is_contiguous():
        raise ValueError(f"decode_attention: lengths must be a contiguous "
                         f"int32 [{B}] tensor on {q.device}, got "
                         f"{lengths.dtype} {tuple(lengths.shape)} on "
                         f"{lengths.device}")


@functools.lru_cache(maxsize=None)
def _kernel():
    lib = _build.load("decode_attn")
    fn = lib.dl4j_decode_attn
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p, ctypes.c_float, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _vec_ok(k, v) -> bool:
    """16-byte loads of k and v: d, the base pointers and the (batch, head,
    row) strides all fall on 16 bytes."""
    n = 16 // k.element_size()
    return all(t.data_ptr() % 16 == 0 and t.shape[-1] % n == 0
               and all(s % n == 0 for s in t.stride()[:3]) for t in (k, v))


def decode_attention(q, k, v, lengths, scale=None):
    """K9 on CUDA tensors, the plain version on CPU tensors: ``o`` ``[B,
    H, 1, d]`` (see the module docstring)."""
    if q.device.type == "cpu":
        return decode_attention_reference(q, k, v, lengths, scale)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: tensors on {q.device} are not "
                         "supported (cuda or cpu)")
    global launches
    _check(q, k, v, lengths)
    fn = _kernel()
    B, H, _, d = q.shape
    C = k.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    o = q.new_empty((B, H, 1, d))
    if o.numel() == 0 or C == 0:  # the plain version's 0 / 1
        return o.zero_()
    strides = (ctypes.c_longlong * 10)(
        q.stride(0), q.stride(1), *k.stride()[:3], *v.stride()[:3],
        o.stride(0), o.stride(1))
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
            o.data_ptr(), B, H, C, d, num_splits(B, H, C),
            cta_threads(B, H, C), strides, float(scale),
            int(_vec_ok(k, v)), _DTYPE_CODES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: CUDA "
                           f"error {rc}")
    launches += 1
    return o


def launch_floor(B: int, H: int, C: int, d: int, dtype=torch.float32,
                 device=None) -> None:
    """Launch an empty kernel with K9's grid, threads, cluster and shared
    memory at this shape on the current stream: the fixed cost of one K9
    launch, for timing beside it. Not counted in ``launches``."""
    fn = _build.load("decode_attn").dl4j_decode_attn_floor
    fn.argtypes = [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rc = fn(B, H, C, d, num_splits(B, H, C), cta_threads(B, H, C),
            _DTYPE_CODES[dtype], torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"decode_attention floor launch failed: CUDA "
                           f"error {rc}")


def _valid_rows(lengths, C: int) -> np.ndarray:
    """Cache rows each batch row reads: ``C`` for ``L <= 0`` (the uniform
    rule), else ``min(L, C)``."""
    ln = np.asarray(lengths, np.int64)
    return np.where(ln <= 0, C, np.minimum(ln, C))


def bytes_moved(lengths, H: int, C: int, d: int, itemsize: int) -> int:
    """Least device-memory traffic of one call on these ``lengths``: the
    valid k and v rows, q and lengths read once, o written once."""
    rows = int(_valid_rows(lengths, C).sum())
    B = len(np.asarray(lengths))
    return 2 * rows * H * d * itemsize + 2 * B * H * d * itemsize + 4 * B


def flops(lengths, H: int, C: int, d: int) -> int:
    """Operations of one call on these ``lengths``: the multiply-adds of
    ``q k^T`` and ``p v`` over the valid rows, ``4 H d`` per row. The
    softmax's few operations per key are left out, so the bound stays a
    lower bound."""
    return 4 * int(_valid_rows(lengths, C).sum()) * H * d


def bound_ms(lengths, H: int, C: int, d: int, itemsize: int) -> tuple:
    """``(ms, "bytes" or "operations")``: the least time an H100 SXM could
    take for one call on these ``lengths``, the larger of bytes over the
    memory rate and the operations over the peak rate of the input type
    (the f32 rate for f32, the tensor-core rate for 16-bit inputs)."""
    rate = H100_F32_FLOPS_PER_S if itemsize == 4 else H100_16BIT_FLOPS_PER_S
    t_bytes = bytes_moved(lengths, H, C, d, itemsize) / H100_BYTES_PER_S
    t_ops = flops(lengths, H, C, d) / rate
    return 1e3 * max(t_bytes, t_ops), \
        "bytes" if t_bytes >= t_ops else "operations"


def tolerance(ref, q, k, v, lengths, scale=None) -> torch.Tensor:
    """The per-element bound on ``|kernel - plain|`` for the output
    ``ref`` of ``(q, k, v, lengths)``: ``F32_TOL x max(1, |ref|)`` in
    float32. For a 16-bit output, ``4 u (A + |ref|)`` (u the dtype's unit
    roundoff, 2^-8 for bf16, 2^-11 for f16), or the float32 bound where it
    is larger. ``A = sum_j p_j |v_j| / l`` over the row's valid keys (the
    plain version's weights applied to ``|v|``, in f32): the two round each
    p to v's dtype against different maxima (up to ``u p_j`` each, so ``2 u
    A`` in all) and o once each (up to ``u |o|`` each). In float16 a p
    below 2^-14 is subnormal, rounded to within 2^-25 absolute: ``4 x
    2^-25 sum_j |v_j| / l`` more. The factor 4 is twice the bound."""
    r = ref.detach().double()
    f32 = F32_TOL * torch.clamp(r.abs(), min=1.0)
    if ref.dtype == torch.float32:
        return f32
    u = {torch.bfloat16: 2.0 ** -8, torch.float16: 2.0 ** -11}[ref.dtype]
    B, H, C, _ = k.shape
    lengths = torch.as_tensor(lengths).to(q.device)
    kb = length_bias(lengths, C)
    va = v.detach().float().abs()
    a, _, l = flash_attention_fwd_reference(
        q.detach().float(), k.detach().float(), va, kb, scale)
    tol = 4 * u * (a.double().to(r.device) + r.abs())
    if ref.dtype == torch.float16:
        keys = (torch.arange(C, device=q.device)[None, :]
                < lengths[:, None].to(torch.int64)) | (lengths[:, None] <= 0)
        s = (va * keys[:, None, :, None]).sum(2, keepdim=True).double()
        tol = tol + 4 * 2.0 ** -25 * (s / l.double().reshape(B, H, 1, 1)
                                      ).to(r.device)
    return torch.maximum(tol, f32)


def dropped_split_reference(q, k, v, lengths, which: int):
    """What a K9 that loses the keys of split ``which`` would give: the
    plain version with that chunk of each row's valid keys masked (the
    chunks :func:`num_splits` gives the CTAs). Returns it and the ``[B]``
    rows whose dropped chunk held some of their keys but not all: there
    :func:`tolerance` must reject it (the tests and ``chip_smoke.py`` hold
    it to that)."""
    B, H, C, _ = k.shape
    splits = num_splits(B, H, C)
    lengths = torch.as_tensor(lengths).to(q.device).to(torch.int64)
    L = torch.where(lengths <= 0, C, lengths.clamp(max=C))
    chunk = (L + splits - 1) // splits
    lo, hi = chunk * which, torch.minimum(chunk * (which + 1), L)
    pos = torch.arange(C, device=q.device)[None, :]
    keep = (pos < L[:, None]) & ~((pos >= lo[:, None]) & (pos < hi[:, None]))
    kb = torch.where(keep, 0.0, _NEG)
    return flash_attention_fwd_reference(q, k, v, kb)[0], \
        (hi > lo) & (hi - lo < L)


def max_violation(got, ref, q, k, v, lengths, scale=None) -> float:
    """The largest ``|got - ref|`` in units of :func:`tolerance` (at most
    1 passes)."""
    tol = tolerance(ref, q, k, v, lengths, scale)
    diff = (got.detach().double().to(tol.device) - ref.detach().double()
            .to(tol.device)).abs()
    return float((diff / tol).max()) if diff.numel() else 0.0
