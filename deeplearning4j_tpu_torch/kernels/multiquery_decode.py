"""K10, multi-query decode attention: the speculative verify window.

``o[b, h, i] = softmax(q[b, h, i] k[b, h, :L+1+i]^T * scale)
v[b, h, :L+1+i]`` for the ``Tq = k`` queries of one verify window over a
KV cache, ``L = lengths[b]`` the rows cached BEFORE the window (the
window's own rows are already inserted at ``L .. L+k-1``): query i sees
the prefix and the window up to itself.

Wrapper of ``csrc/mq_decode_attn.cu``, which replaces the JAX package's
``ops/flash_attention.py::_mq_decode_kernel`` (:220; its ``pallas_call``
at :398 through ``_mq_impl`` :388 and ``decode_multiquery_attention``
:763). ``q`` is ``[B, H, k, d]`` (a strided view with a contiguous last
dimension: the head split of a ``[B, k, H*d]`` projection is read in
place), ``k`` and ``v`` ``[B, H, C, d]`` (the caches ``paged_gather``
gives), in f32, bf16 or f16; ``lengths`` int32 ``[B]``. The output is
``[B, H, k, d]`` in q's dtype, contiguous.

- A query whose window is fully masked (``L + 1 + i <= 0``) gets uniform
  weights over all ``C`` rows, as the TPU kernel gives it (every score
  there is ``finfo(float32).min``), and as K9's ``L <= 0`` rows do.
- A CPU tensor takes the plain version, :func:`multiquery_decode_reference`:
  K3's tiled plain version with the per-(query, key) window mask (the
  same online-softmax rescaling, p rounded to v's dtype before ``p v``,
  ``o`` rounded once).
- A CUDA tensor launches K10, or raises. The limits raise; nothing falls
  back: a window of more than ``MAX_QUERIES`` rows, a head dimension
  above ``MAX_HEAD_DIM`` or a dtype other than f32/bf16/f16 raises a
  ValueError naming the limit; so do mismatched shapes, ``lengths`` that
  is not int32 ``[B]`` on the same device, a last dimension that is not
  contiguous, a failed build or a refused launch.

K10 splits each row's keys over :func:`num_splits` CTAs (K9's count, from
the cache length and never from the lengths, so the host reads nothing
off the device), which form one thread-block cluster. Each CTA walks its
chunk in tiles of k and v staged in shared memory by asynchronous copies
(a double buffer), one thread per (query, key) dot product; the CTAs push
their per-query softmax states into rank 0's shared memory, which merges
them in rank order. One kernel a call, no scratch in device memory, no
atomics: a rerun is bitwise equal. In f32 it agrees with the plain version
within ``F32_TOL``; in 16-bit within :func:`tolerance`, K9's ``4 u (sum p
|v| / l + |o|)`` per element taken over each query row's own window.

``launches`` counts wrapper calls that launched K10. :func:`launch_floor`
launches an empty kernel the way K10 is launched, for timing beside it;
:func:`smem_bytes` is one CTA's shared memory.
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
from .decode_attention import _vec_ok, num_splits
from .flash_attention import KEY_TILE, MAX_HEAD_DIM

#: the most query rows one window may have (the batcher's speculate_k)
MAX_QUERIES = 16
#: K10 against its plain version in float32: within F32_TOL x max(1,
#: |ref|) (K9's; the JAX package's kernel-vs-reference contract is 1e-5)
F32_TOL = 2e-5
_NEG = float(torch.finfo(torch.float32).min)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

#: Kernel launches since the last reset (a plain integer; set it to 0).
launches = 0


def window_mask(lengths, n_queries: int, cache_len: int):
    """``(keep [B, Tq, C] bool, uniform [B, Tq] bool)``: query i of row b
    may attend column c iff ``c < lengths[b] + 1 + i``; a query with
    ``lengths[b] + 1 + i <= 0`` sees no column and takes uniform weights
    over all ``C``."""
    ln = torch.as_tensor(lengths).to(torch.int64)
    bound = ln[:, None] + 1 + torch.arange(n_queries, device=ln.device)
    col = torch.arange(int(cache_len), device=ln.device)
    return col[None, None, :] < bound[:, :, None], bound <= 0


def _attend(q, k, v, keep, uniform, scale):
    """The plain version's core, tile by tile as K3's plain version: ``(o,
    l)``. ``keep`` ``[B, Tq, C]`` admits a (query, key) pair; a ``uniform``
    query scores every key 0 (uniform weights over the kept ones)."""
    B, H, Tq, d = q.shape
    C = k.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    ct = torch.promote_types(q.dtype, torch.float32)
    qf, kf, vf = q.to(ct), k.to(ct), v.to(ct)
    bias = torch.where(keep, 0.0, _NEG).to(ct)[:, None]       # [B,1,Tq,C]
    uni = uniform[:, None, :, None]
    m = torch.full((B, H, Tq), -math.inf, dtype=ct, device=q.device)
    l = torch.zeros((B, H, Tq), dtype=ct, device=q.device)
    acc = torch.zeros((B, H, Tq, d), dtype=ct, device=q.device)
    for j0 in range(0, C, KEY_TILE):
        j1 = min(j0 + KEY_TILE, C)
        s = torch.matmul(qf, kf[:, :, j0:j1].transpose(-1, -2)) * scale
        s = torch.where(uni, torch.zeros((), dtype=ct, device=q.device), s)
        s = s + bias[..., j0:j1]
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.matmul(
            p.to(v.dtype).to(ct), vf[:, :, j0:j1])
        m = m_new
    safe = torch.where(l == 0, torch.ones_like(l), l)
    return (acc / safe[..., None]).to(q.dtype), safe


def multiquery_decode_reference(q, k, v, lengths, scale=None):
    """K10's plain version (the JAX ``reference_decode_multiquery``
    numerics, tile by tile): ``o`` ``[B, H, Tq, d]``. Runs wherever its
    tensors are."""
    keep, uniform = window_mask(torch.as_tensor(lengths).to(q.device),
                                q.shape[2], k.shape[2])
    return _attend(q, k, v, keep, uniform, scale)[0]


def _check(q, k, v, lengths):
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"multiquery_decode: dtype {q.dtype} is not one the "
                         "kernel takes (float32, bfloat16, float16)")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("multiquery_decode: q must be [B, H, k, d] and k, v "
                         f"[B, H, C, d]; got {tuple(q.shape)} "
                         f"{tuple(k.shape)} {tuple(v.shape)}")
    B, H, Tq, d = q.shape
    C = k.shape[2]
    if not 1 <= Tq <= MAX_QUERIES:
        raise ValueError(f"multiquery_decode: a window of {Tq} query rows is "
                         f"outside the kernel's limit 1..{MAX_QUERIES}")
    if k.shape != (B, H, C, d) or v.shape != k.shape:
        raise ValueError(f"multiquery_decode: q/cache shapes disagree: "
                         f"{tuple(q.shape)} {tuple(k.shape)} "
                         f"{tuple(v.shape)}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"multiquery_decode: q/k/v dtypes disagree: "
                         f"{q.dtype} {k.dtype} {v.dtype}")
    if d > MAX_HEAD_DIM:
        raise ValueError(f"multiquery_decode: head dimension {d} is above "
                         f"the kernel's limit {MAX_HEAD_DIM}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1 or t.device != q.device:
            raise ValueError(f"multiquery_decode: {name} must lie on "
                             f"{q.device} with a contiguous last dimension,"
                             f" got strides {t.stride()} on {t.device}")
    if lengths.dtype != torch.int32 or lengths.shape != (B,) \
            or lengths.device != q.device or not lengths.is_contiguous():
        raise ValueError(f"multiquery_decode: lengths must be a contiguous "
                         f"int32 [{B}] tensor on {q.device}, got "
                         f"{lengths.dtype} {tuple(lengths.shape)} on "
                         f"{lengths.device}")


@functools.lru_cache(maxsize=None)
def _kernel():
    lib = _build.load("mq_decode_attn")
    fn = lib.dl4j_mq_decode_attn
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p, ctypes.c_float, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def multiquery_decode(q, k, v, lengths, scale=None):
    """K10 on CUDA tensors, the plain version on CPU tensors: ``o`` ``[B,
    H, Tq, d]`` (see the module docstring)."""
    if q.device.type == "cpu":
        return multiquery_decode_reference(q, k, v, lengths, scale)
    if q.device.type != "cuda":
        raise ValueError(f"multiquery_decode: tensors on {q.device} are not "
                         "supported (cuda or cpu)")
    global launches
    _check(q, k, v, lengths)
    fn = _kernel()
    B, H, Tq, d = q.shape
    C = k.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    o = q.new_empty((B, H, Tq, d))
    if o.numel() == 0 or C == 0:  # the plain version's 0 / 1
        return o.zero_()
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3])
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
            o.data_ptr(), B, H, C, d, Tq, num_splits(B, H, C), strides,
            float(scale), int(_vec_ok(k, v)), _DTYPE_CODES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"multiquery_decode kernel launch failed: CUDA "
                           f"error {rc}")
    launches += 1
    return o


def launch_floor(B: int, H: int, Tq: int, C: int, d: int,
                 dtype=torch.float32, device=None) -> None:
    """Launch an empty kernel with K10's grid, threads, cluster and shared
    memory at this shape on the current stream: the fixed cost of one K10
    launch, for timing beside it. Not counted in ``launches``."""
    fn = _build.load("mq_decode_attn").dl4j_mq_decode_attn_floor
    fn.argtypes = [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rc = fn(B, H, C, d, Tq, num_splits(B, H, C), _DTYPE_CODES[dtype],
            torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"multiquery_decode floor launch failed: CUDA "
                           f"error {rc}")


def smem_bytes(B: int, H: int, Tq: int, C: int, d: int,
               dtype=torch.float32) -> int:
    """The shared memory of one K10 CTA at this shape, as the compiled
    library reckons it."""
    fn = _build.load("mq_decode_attn").dl4j_mq_decode_attn_smem
    fn.argtypes = [ctypes.c_int] * 6
    fn.restype = ctypes.c_longlong
    return int(fn(B, H, d, Tq, num_splits(B, H, C), _DTYPE_CODES[dtype]))


def valid_rows(lengths, n_queries: int, C: int) -> np.ndarray:
    """Cache rows each batch row's window reads: all ``C`` when a query is
    fully masked (``L + 1 <= 0``), else ``min(C, L + k)``."""
    ln = np.asarray(lengths, np.int64)
    return np.where(ln + 1 <= 0, C, np.minimum(ln + n_queries, C))


def bytes_moved(lengths, H: int, n_queries: int, C: int, d: int,
                itemsize: int) -> int:
    """Least device-memory traffic of one call on these ``lengths``: the
    valid k and v rows, q and lengths read once, o written once."""
    rows = int(valid_rows(lengths, n_queries, C).sum())
    B = len(np.asarray(lengths))
    return (2 * rows * H * d * itemsize
            + 2 * B * H * n_queries * d * itemsize + 4 * B)


def flops(lengths, H: int, n_queries: int, C: int, d: int) -> int:
    """Operations of one call: ``4 k d`` per valid row and head (the
    multiply-adds of ``q k^T`` and ``p v`` for each of the k queries; the
    window mask is not subtracted and the softmax is left out, as for
    K9)."""
    rows = int(valid_rows(lengths, n_queries, C).sum())
    return 4 * n_queries * d * rows * H


def bound_ms(lengths, H: int, n_queries: int, C: int, d: int,
             itemsize: int) -> tuple:
    """``(ms, "bytes" or "operations")``: the least time an H100 SXM could
    take for one call, the larger of bytes over the memory rate and the
    operations over the peak rate of the input type."""
    rate = H100_F32_FLOPS_PER_S if itemsize == 4 else H100_16BIT_FLOPS_PER_S
    t_bytes = bytes_moved(lengths, H, n_queries, C, d,
                          itemsize) / H100_BYTES_PER_S
    t_ops = flops(lengths, H, n_queries, C, d) / rate
    return 1e3 * max(t_bytes, t_ops), \
        "bytes" if t_bytes >= t_ops else "operations"


def tolerance(ref, q, k, v, lengths, scale=None) -> torch.Tensor:
    """The per-element bound on ``|kernel - plain|`` for the output ``ref``
    of ``(q, k, v, lengths)``: K9's form (``kernels/decode_attention.py::
    tolerance``) over each query row's own window. ``F32_TOL x max(1,
    |ref|)`` in float32; for 16-bit, ``4 u (A + |ref|)`` or the float32
    bound where larger, with ``A = sum_j p_j |v_j| / l`` over the keys
    query i admits (the plain version's weights on ``|v|``, in f32), plus
    ``4 x 2^-25 sum_j |v_j| / l`` over them in float16 (p below 2^-14 is
    subnormal there)."""
    r = ref.detach().double()
    f32 = F32_TOL * torch.clamp(r.abs(), min=1.0)
    if ref.dtype == torch.float32:
        return f32
    u = {torch.bfloat16: 2.0 ** -8, torch.float16: 2.0 ** -11}[ref.dtype]
    B, H, Tq, _ = q.shape
    keep, uniform = window_mask(torch.as_tensor(lengths).to(q.device), Tq,
                                k.shape[2])
    va = v.detach().float().abs()
    a, l = _attend(q.detach().float(), k.detach().float(), va, keep,
                   uniform, scale)
    tol = 4 * u * (a.double().to(r.device) + r.abs())
    if ref.dtype == torch.float16:
        seen = (keep | uniform[:, :, None]).float()            # [B, Tq, C]
        s = torch.einsum("bqc,bhcd->bhqd", seen, va).double()
        tol = tol + 4 * 2.0 ** -25 * (s / l.double()[..., None]).to(r.device)
    return torch.maximum(tol, f32)


def max_violation(got, ref, q, k, v, lengths, scale=None) -> float:
    """The largest ``|got - ref|`` in units of :func:`tolerance` (at most
    1 passes)."""
    tol = tolerance(ref, q, k, v, lengths, scale)
    diff = (got.detach().double().to(tol.device) - ref.detach().double()
            .to(tol.device)).abs()
    return float((diff / tol).max()) if diff.numel() else 0.0


def dropped_split_reference(q, k, v, lengths, which: int):
    """What a K10 that loses the keys of split ``which`` would give: the
    plain version with that chunk of each row's valid rows (the chunks
    :func:`num_splits` gives the CTAs) taken out of every query's window.
    Returns it and the ``[B, Tq]`` (row, query) pairs whose window held
    some of the dropped keys but not all: there :func:`tolerance` must
    reject it (``chip_smoke.py`` holds it to that)."""
    B, H, Tq, _ = q.shape
    C = k.shape[2]
    splits = num_splits(B, H, C)
    ln = torch.as_tensor(lengths).to(q.device).to(torch.int64)
    rows = torch.where(ln + 1 <= 0, C, torch.clamp(ln + Tq, max=C))
    chunk = (rows + splits - 1) // splits
    lo = torch.minimum(chunk * which, rows)
    hi = torch.minimum(lo + chunk, rows)
    keep, uniform = window_mask(ln, Tq, C)
    seen = keep | uniform[:, :, None]
    col = torch.arange(C, device=q.device)[None, None, :]
    drop = (col >= lo[:, None, None]) & (col < hi[:, None, None])
    n_seen = seen.sum(-1)
    n_drop = (seen & drop).sum(-1)
    bad = _attend(q, k, v, seen & ~drop, uniform, None)[0]
    return bad, (n_drop > 0) & (n_drop < n_seen)
