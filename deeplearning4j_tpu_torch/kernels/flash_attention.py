"""K3, the flash-attention forward: ``(o, m, l)`` of
``softmax(q k^T * scale + kb) v``; K4 + K5, its backward fused into one
kernel: ``dq``, ``dk`` and ``dv``.

Wrappers of ``csrc/flash_attn_fwd.cu`` (K3), which replaces the JAX
package's ``ops/flash_attention.py::_fwd_kernel``, and of
``csrc/flash_attn_bwd.cu`` (K4 + K5), which replaces both
``_bwd_dq_kernel`` and ``_bwd_dkv_kernel``. ``q`` is ``[B, H, Tq, d]``,
``k`` and ``v`` ``[B, H, Tk, d]``, in f32, bf16 or f16, each a strided
view with a contiguous last dimension (the head split of a ``[B, T, H*d]``
projection is read in place). ``kb`` is an optional f32 key bias
``[B, Tk]`` shared by the heads of a batch row (the reduced mask; the
caller clamps it to ``finfo(float32).min``). The outputs are ``o`` in
q's dtype and layout and f32 ``m`` and ``l`` of shape ``[B*H, Tq]``: the
row max of the scores and the row sum of ``exp(s - m)`` (1 where that
sum is 0). The TPU kernel kept ``m`` and ``l`` replicated over 128 lanes;
these are one value per row.

K3 runs one CTA of ``FWD_THREADS`` threads per (batch*head, block of
``FWD_QUERY_ROWS`` query rows) and walks the keys in tiles of
:func:`key_tile` keys, staged by ``cp.async`` into a double buffer; each
thread holds a register tile of scores and of ``o`` (bf16/f16: ``p v`` on
the tensor cores). :func:`fwd_geometry` states the tiles and the shared
memory, :func:`fwd_occupancy` what the card makes of them.

- A CPU tensor takes the plain version, :func:`flash_attention_fwd_reference`:
  the kernel's arithmetic in PyTorch, key tile by key tile (the kernel's
  :func:`key_tile`), with the same online-softmax rescaling and the same
  roundings (p rounded to v's dtype before ``p v``, ``o`` rounded once),
  so the two differ only in the order of f32 sums.
- A CUDA tensor launches K3, or raises: a dtype other than f32/bf16/f16,
  a head dimension above ``MAX_HEAD_DIM``, mismatched shapes, a last
  dimension that is not contiguous, a failed build or a refused launch.
  No CUDA call gives way to the plain version.

The backward takes the forward's ``m`` and ``l``, the output gradient
``do`` (q's shape and dtype, any strides with a contiguous last dimension)
and ``di = rowsum(o * do)`` in f32 ``[B*H, Tq]``, which the caller
computes, as the JAX package does. One kernel, ``csrc/flash_attn_bwd.cu``
(K4 + K5 fused), recomputes ``p = exp(s - m) * (1 / l)`` from the scores
and ``ds = p * (dp - di) * scale`` with ``dp = do v^T`` once and gives
``dq = ds k`` in q's layout, ``dk = ds^T q`` and ``dv = p^T do`` in k's
and v's layouts. ds is rounded to the input dtype and p to do's before the
products, as on the TPU. :func:`flash_attention_bwd` asks it for all three
in one launch; :func:`flash_attention_bwd_dq` for dq alone (it skips the
``p^T do`` and ``ds^T q`` products) and :func:`flash_attention_bwd_dkv`
for dk and dv alone (it skips ``ds k``). When Tk is above one CTA's key
block (128 keys, 64 at d > 64), dq is summed from per-block f32 partials
in a workspace by a second, fixed-order kernel, so reruns are bit-equal.
The same CPU/CUDA rule holds: CPU tensors take the plain versions
(:func:`flash_attention_bwd_dq_reference` and
:func:`flash_attention_bwd_dkv_reference`;
:func:`flash_attention_bwd_reference` computes all three from ``o``),
CUDA tensors launch the kernel or raise.

``launches`` counts wrapper calls that launched K3 and ``launches_bwd``
those that launched the fused backward; of the latter, ``launches_dq``
counts the launches that wrote dq (K4's output) and ``launches_dkv`` those
that wrote dk and dv (K5's). ``bf16_launches`` and ``bf16_launches_bwd``
count the bfloat16 launches of K3 and of the fused backward among them.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import _build
from .affine_act import (H100_16BIT_FLOPS_PER_S, H100_BYTES_PER_S,
                         H100_F32_FLOPS_PER_S)

#: keys per tile of the backward's plain versions and of K10's
KEY_TILE = 32
#: the largest head dimension the kernel takes
MAX_HEAD_DIM = 128
#: K3's CTA: threads, and query rows it covers
FWD_THREADS = 256
FWD_QUERY_ROWS = 64
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

#: Kernel launches since the last reset (plain integers; set them to 0):
#: K3; the fused backward; of those, the ones that wrote dq (K4's output)
#: and the ones that wrote dk and dv (K5's).
launches = 0
launches_bwd = 0
launches_dq = 0
launches_dkv = 0
bf16_launches = 0
bf16_launches_bwd = 0


def key_tile(d: int) -> int:
    """Keys per tile of K3 at head dimension ``d``: 64, or 32 above 64 so
    that two CTAs still fit one SM."""
    return 64 if d <= 64 else 32


def _padded_head_dim(d: int) -> int:
    """The head dimension K3 is compiled for: 32, 64 or 128."""
    if not 0 < d <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head dimension {d} is outside "
                         f"1..{MAX_HEAD_DIM}, the kernel's limit")
    return 32 if d <= 32 else 64 if d <= 64 else 128


def fwd_geometry(d: int, dtype=torch.float32) -> dict:
    """K3's tiles and shared memory at head dimension ``d`` (its
    ``Layout``): threads and query rows a CTA, keys a tile, and the
    dynamic shared-memory bytes of one CTA. float32: q, two buffers of k
    and of v and the p tile, all f32; 16 bits: f32 copies of q and of one
    k tile for the scores, 16-bit q, two buffers of 16-bit k and v, the
    16-bit p tile, and two f32 rows (alpha, l). Both: two buffers of the
    key bias. Rows are padded (f32 by 4 floats, 16-bit by 8 elements) so
    that 16-byte reads spread over the banks."""
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"flash_attention: dtype {dtype} not supported "
                        "(float32, bfloat16, float16)")
    D = _padded_head_dim(d)
    bk = key_tile(d)
    f32 = dtype == torch.float32
    fs, hs = D + 4, D + 8
    ps = bk + 16 if f32 else bk + 8
    q_rows = FWD_QUERY_ROWS
    n = 4 * q_rows * fs + 4 * bk * fs * (2 if f32 else 1)
    if f32:
        n += 4 * 2 * bk * fs
    else:
        n += 2 * q_rows * hs + 2 * (2 * 2 * bk * hs)
    n += (4 if f32 else 2) * q_rows * ps + 4 * 2 * bk \
        + (0 if f32 else 4 * 2 * q_rows)
    return {"threads": FWD_THREADS, "query_rows": q_rows, "key_tile": bk,
            "head_dim": D, "smem_bytes": n}


def flash_attention_fwd_reference(q, k, v, kb=None, scale=None):
    """K3's plain version: ``(o, m, l)`` computed tile by tile as the
    kernel does (:func:`key_tile` keys a tile, so a 16-bit p is rounded
    against the same running max), in f32 (f64 for f64 inputs). Runs
    wherever its tensors are; matmuls follow the global TF32 switch, so
    hold it against the kernel with TF32 off."""
    B, H, Tq, d = q.shape
    Tk = k.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    ct = torch.promote_types(q.dtype, torch.float32)
    qf, kf, vf = q.to(ct), k.to(ct), v.to(ct)
    m = torch.full((B, H, Tq), -math.inf, dtype=ct, device=q.device)
    l = torch.zeros((B, H, Tq), dtype=ct, device=q.device)
    acc = torch.zeros((B, H, Tq, d), dtype=ct, device=q.device)
    bk = key_tile(d)
    for j0 in range(0, Tk, bk):
        j1 = min(j0 + bk, Tk)
        s = torch.matmul(qf, kf[:, :, j0:j1].transpose(-1, -2)) * scale
        if kb is not None:
            s = s + kb[:, None, None, j0:j1].to(ct)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.matmul(
            p.to(v.dtype).to(ct), vf[:, :, j0:j1])
        m = m_new
    safe = torch.where(l == 0, torch.ones_like(l), l)
    o = (acc / safe[..., None]).to(q.dtype)
    return o, m.reshape(B * H, Tq), safe.reshape(B * H, Tq)


def _bwd_tiles(q, k, v, kb, m, l, di, do, scale):
    """The backward's key tiles as the kernels compute them: yields ``(j0,
    j1, p, ds)`` for each ``KEY_TILE`` keys, with ``p = exp(s - m) * (1 /
    l)`` and ``ds = p * (dp - di) * scale`` in f32 (f64 for f64 inputs)."""
    B, H, Tq, d = q.shape
    Tk = k.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    ct = torch.promote_types(q.dtype, torch.float32)
    qf, kf, vf, dof = q.to(ct), k.to(ct), v.to(ct), do.to(ct)
    m, inv_l, di = (t.reshape(B, H, Tq, 1).to(ct) for t in (m, 1.0 / l, di))
    for j0 in range(0, Tk, KEY_TILE):
        j1 = min(j0 + KEY_TILE, Tk)
        s = torch.matmul(qf, kf[:, :, j0:j1].transpose(-1, -2)) * scale
        if kb is not None:
            s = s + kb[:, None, None, j0:j1].to(ct)
        p = torch.exp(s - m) * inv_l
        dp = torch.matmul(dof, vf[:, :, j0:j1].transpose(-1, -2))
        yield j0, j1, p, p * (dp - di) * scale


def flash_attention_bwd_dq_reference(q, k, v, kb, m, l, di, do, scale=None):
    """K4's plain version: ``dq = sum over key tiles of ds k``, ds rounded
    to k's dtype, accumulated in f32 (f64 for f64 inputs), rounded once to
    q's dtype."""
    ct = torch.promote_types(q.dtype, torch.float32)
    kf = k.to(ct)
    dq = torch.zeros(q.shape, dtype=ct, device=q.device)
    for j0, j1, _, ds in _bwd_tiles(q, k, v, kb, m, l, di, do, scale):
        dq = dq + torch.matmul(ds.to(k.dtype).to(ct), kf[:, :, j0:j1])
    return dq.to(q.dtype)


def flash_attention_bwd_dkv_reference(q, k, v, kb, m, l, di, do,
                                      scale=None):
    """K5's plain version: per key tile, ``dv = p^T do`` (p rounded to do's
    dtype) and ``dk = ds^T q`` (ds rounded to q's dtype), summed over the
    queries in f32 (f64 for f64 inputs), rounded once."""
    ct = torch.promote_types(q.dtype, torch.float32)
    qf, dof = q.to(ct), do.to(ct)
    dk, dv = [], []
    for _, _, p, ds in _bwd_tiles(q, k, v, kb, m, l, di, do, scale):
        dv.append(torch.matmul(p.to(do.dtype).to(ct).transpose(-1, -2), dof))
        dk.append(torch.matmul(ds.to(q.dtype).to(ct).transpose(-1, -2), qf))
    return torch.cat(dk, 2).to(k.dtype), torch.cat(dv, 2).to(v.dtype)


def attention_di(o, do):
    """``di = rowsum(o * do)`` in f32 (f64 for f64 inputs) as ``[B*H, Tq]``,
    the row term of the backward that the JAX package also computes
    outside its kernels."""
    B, H, Tq, _ = o.shape
    ct = torch.promote_types(o.dtype, torch.float32)
    di = torch.sum(o.to(ct) * do.to(ct), dim=-1)
    return di.reshape(B * H, Tq).contiguous()


def flash_attention_bwd_reference(q, k, v, kb, o, m, l, do, scale=None):
    """The fused backward's plain version: ``(dq, dk, dv)`` from the
    forward's ``o``, ``m`` and ``l`` and the output gradient ``do``."""
    di = attention_di(o, do)
    dq = flash_attention_bwd_dq_reference(q, k, v, kb, m, l, di, do, scale)
    dk, dv = flash_attention_bwd_dkv_reference(q, k, v, kb, m, l, di, do,
                                               scale)
    return dq, dk, dv


def _check(q, k, v, kb):
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"flash_attention: dtype {q.dtype} not supported "
                        "(float32, bfloat16, float16)")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention: q, k, v must be [B, H, T, d]; "
                         f"got {tuple(q.shape)} {tuple(k.shape)} "
                         f"{tuple(v.shape)}")
    B, H, _, d = q.shape
    Tk = k.shape[2]
    if k.shape != (B, H, Tk, d) or v.shape != k.shape:
        raise ValueError(f"flash_attention: q/k/v shapes disagree: "
                         f"{tuple(q.shape)} {tuple(k.shape)} "
                         f"{tuple(v.shape)}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: q/k/v dtypes disagree: "
                        f"{q.dtype} {k.dtype} {v.dtype}")
    if d > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head dimension {d} is above "
                         f"the kernel's limit {MAX_HEAD_DIM}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1 or t.device != q.device:
            raise ValueError(f"flash_attention: {name} must lie on "
                             f"{q.device} with a contiguous last dimension,"
                             f" got strides {t.stride()} on {t.device}")
    if kb is not None and (kb.dtype != torch.float32 or kb.shape != (B, Tk)
                           or not kb.is_contiguous()
                           or kb.device != q.device):
        raise ValueError(f"flash_attention: kb must be a contiguous float32 "
                         f"[{B}, {Tk}] tensor on {q.device}")


@functools.lru_cache(maxsize=None)
def _kernel():
    lib = _build.load("flash_attn_fwd")
    fn = lib.dl4j_flash_attn_fwd
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check_bwd(q, k, v, kb, m, l, di, do):
    _check(q, k, v, kb)
    if do.shape != q.shape or do.dtype != q.dtype or do.stride(-1) != 1 \
            or do.device != q.device:
        raise ValueError(f"flash_attention backward: do must be a "
                         f"{q.dtype} {tuple(q.shape)} tensor on {q.device} "
                         f"with a contiguous last dimension")
    rows = (q.shape[0] * q.shape[1], q.shape[2])
    for name, t in (("m", m), ("l", l), ("di", di)):
        if t.dtype != torch.float32 or t.shape != rows \
                or not t.is_contiguous() or t.device != q.device:
            raise ValueError(f"flash_attention backward: {name} must be a "
                             f"contiguous float32 {list(rows)} tensor on "
                             f"{q.device}")


@functools.lru_cache(maxsize=None)
def _bwd_kernels():
    """The fused backward's entry and its key-block query."""
    lib = _build.load("flash_attn_bwd")
    fn = lib.dl4j_flash_attn_bwd
    fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p, ctypes.c_float, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    kblock = lib.dl4j_flash_attn_bwd_key_block
    kblock.argtypes = [ctypes.c_int, ctypes.c_int]
    kblock.restype = ctypes.c_int
    return fn, kblock


def _rows_aligned(ts) -> bool:
    """True when every tensor's rows start on 16-byte boundaries: base
    pointer and (batch, head, row) strides. The kernels then stage inputs
    with 16-byte ``cp.async`` copies and store f32 outputs 16 bytes at a
    time (else element by element). The backward is given this choice; K3
    makes the same one itself from its pointers and strides."""
    return all(t.data_ptr() % 16 == 0 and all(
        s * t.element_size() % 16 == 0 for s in t.stride()[:3]) for t in ts)


def _like(t):
    """An empty tensor in ``t``'s layout (the head split stays one)."""
    out = torch.empty_like(t)
    if out.stride(-1) != 1:  # a layout empty_like does not keep
        out = torch.empty(t.shape, dtype=t.dtype, device=t.device)
    return out


def _route_bwd(q, k, v, kb, m, l, di, do):
    """True for CUDA tensors (after the checks), False for CPU ones."""
    if q.device.type == "cpu":
        return False
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: tensors on {q.device} are not "
                         "supported (cuda or cpu)")
    _check_bwd(q, k, v, kb, m, l, di, do)
    return True


def _bwd_launch(q, k, v, kb, m, l, di, do, scale, want_dq, want_dkv):
    """One launch of the fused backward for ``dq`` and/or ``(dk, dv)``
    (None where not asked for); checked CUDA tensors."""
    global launches_bwd, launches_dq, launches_dkv, bf16_launches_bwd
    fn, kblock = _bwd_kernels()
    B, H, Tq, d = q.shape
    Tk = k.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    dq = _like(q) if want_dq else None
    dk, dv = (_like(k), _like(v)) if want_dkv else (None, None)
    if q.numel() == 0 or k.numel() == 0:  # nothing to sum over
        return tuple(None if t is None else t.zero_() for t in (dq, dk, dv))
    code = _DTYPE_CODES[q.dtype]
    nkb = -(-Tk // kblock(d, code))
    ws = torch.empty((nkb, B * H, Tq, d), dtype=torch.float32,
                     device=q.device) if want_dq and nkb > 1 else None
    strides = (ctypes.c_longlong * 21)(*[
        s for t in (q, k, v, do, dq, dk, dv)
        for s in ((0, 0, 0) if t is None else t.stride()[:3])])

    def ptr(t):
        return None if t is None else t.data_ptr()
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), ptr(kb), m.data_ptr(),
            l.data_ptr(), di.data_ptr(), do.data_ptr(), ptr(dq), ptr(dk),
            ptr(dv), ptr(ws), B, H, Tq, Tk, d, strides, float(scale), code,
            int(_rows_aligned((q, k, v, do)))
            | int(want_dkv and _rows_aligned((dk, dv))) << 1,
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention backward kernel launch failed: "
                           f"CUDA error {rc}")
    launches_bwd += 1
    bf16_launches_bwd += q.dtype == torch.bfloat16
    launches_dq += int(want_dq)
    launches_dkv += int(want_dkv)
    return dq, dk, dv


def _occupancy(lib: str, fn: str, d: int, dtype) -> dict:
    f = getattr(_build.load(lib), fn)
    f.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    f.restype = ctypes.c_int
    out = (ctypes.c_int * 5)()
    rc = f(int(d), _DTYPE_CODES[dtype], out)
    if rc != 0:
        raise RuntimeError(f"flash_attention occupancy query ({fn}) failed:"
                           f" CUDA error {rc}")
    return dict(zip(("registers", "threads", "smem_bytes", "local_bytes",
                     "ctas_per_sm"), out))


def fwd_occupancy(d: int, dtype=torch.float32) -> dict:
    """K3's resources on the current card at head dimension ``d``:
    registers and local (spill) bytes a thread, threads and shared-memory
    bytes a CTA, and the CTAs one SM holds at once (CUDA's occupancy
    calculator). Needs the card."""
    return _occupancy("flash_attn_fwd", "dl4j_flash_attn_fwd_occupancy", d,
                      dtype)


def bwd_occupancy(d: int, dtype=torch.float32) -> dict:
    """The fused backward kernel's resources on the current card at head
    dimension ``d``: registers and local (spill) bytes a thread, threads
    and shared-memory bytes a CTA, and the CTAs one SM holds at once
    (CUDA's occupancy calculator). Needs the card."""
    return _occupancy("flash_attn_bwd", "dl4j_flash_attn_bwd_occupancy", d,
                      dtype)


def flash_attention_bwd(q, k, v, kb, m, l, di, do, scale=None):
    """The fused backward on CUDA tensors, the plain versions on CPU
    tensors: ``(dq, dk, dv)`` in q's, k's and v's layouts from one launch
    (see the module docstring)."""
    if not _route_bwd(q, k, v, kb, m, l, di, do):
        return (flash_attention_bwd_dq_reference(q, k, v, kb, m, l, di, do,
                                                 scale),
                *flash_attention_bwd_dkv_reference(q, k, v, kb, m, l, di, do,
                                                   scale))
    return _bwd_launch(q, k, v, kb, m, l, di, do, scale, True, True)


def flash_attention_bwd_dq(q, k, v, kb, m, l, di, do, scale=None):
    """The fused backward asked for ``dq`` alone on CUDA tensors (K4's
    output), its plain version on CPU tensors (see the module
    docstring)."""
    if not _route_bwd(q, k, v, kb, m, l, di, do):
        return flash_attention_bwd_dq_reference(q, k, v, kb, m, l, di, do,
                                                scale)
    return _bwd_launch(q, k, v, kb, m, l, di, do, scale, True, False)[0]


def flash_attention_bwd_dkv(q, k, v, kb, m, l, di, do, scale=None):
    """The fused backward asked for ``(dk, dv)`` alone on CUDA tensors
    (K5's outputs), its plain version on CPU tensors (see the module
    docstring)."""
    if not _route_bwd(q, k, v, kb, m, l, di, do):
        return flash_attention_bwd_dkv_reference(q, k, v, kb, m, l, di, do,
                                                 scale)
    return _bwd_launch(q, k, v, kb, m, l, di, do, scale, False, True)[1:]


def flash_attention_fwd(q, k, v, kb=None, scale=None):
    """K3 on CUDA tensors, the plain version on CPU tensors: ``(o, m, l)``
    (see the module docstring)."""
    if q.device.type == "cpu":
        return flash_attention_fwd_reference(q, k, v, kb, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: tensors on {q.device} are not "
                         "supported (cuda or cpu)")
    global launches, bf16_launches
    _check(q, k, v, kb)
    fn = _kernel()
    B, H, Tq, d = q.shape
    Tk = k.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    o = _like(q)
    m = torch.empty((B * H, Tq), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    if q.numel() == 0:
        return o, m, l
    strides = (ctypes.c_longlong * 12)(*[
        s for t in (q, k, v, o) for s in t.stride()[:3]])
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if kb is None else kb.data_ptr(), o.data_ptr(),
            m.data_ptr(), l.data_ptr(), B, H, Tq, Tk, d, strides,
            float(scale), _DTYPE_CODES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {rc}")
    launches += 1
    bf16_launches += q.dtype == torch.bfloat16
    return o, m, l


def bytes_moved(B: int, H: int, Tq: int, Tk: int, d: int, itemsize: int,
                has_bias: bool = True) -> int:
    """Least device-memory traffic of one call: q, k, v and kb read once;
    o, m and l written once."""
    G = B * H
    return (2 * G * Tq * d + 2 * G * Tk * d) * itemsize + 2 * G * Tq * 4 \
        + (B * Tk * 4 if has_bias else 0)


def flops(B: int, H: int, Tq: int, Tk: int, d: int) -> int:
    """Operations of one call: the multiply-adds of ``q k^T`` and of
    ``p v``, 4 G Tq Tk d. The softmax's few operations per score (under
    2% more at d = 64) are left out, so the bound stays a lower bound."""
    return 4 * B * H * Tq * Tk * d


def bound_ms(B: int, H: int, Tq: int, Tk: int, d: int, itemsize: int,
             has_bias: bool = True) -> tuple:
    """``(ms, "bytes" or "operations")``: the least time an H100 SXM could
    take for one call, the larger of bytes over the memory rate and the
    operations over the peak rate of the input type (the f32 rate for
    f32, the tensor-core rate for 16-bit inputs)."""
    rate = H100_F32_FLOPS_PER_S if itemsize == 4 else H100_16BIT_FLOPS_PER_S
    t_bytes = bytes_moved(B, H, Tq, Tk, d, itemsize, has_bias) \
        / H100_BYTES_PER_S
    t_ops = flops(B, H, Tq, Tk, d) / rate
    return 1e3 * max(t_bytes, t_ops), \
        "bytes" if t_bytes >= t_ops else "operations"


_BWD_KERNELS = ("dq", "dkv", "fused")


def _bwd_kernel_name(kernel: str) -> str:
    if kernel not in _BWD_KERNELS:
        raise ValueError(f"kernel {kernel!r} is 'dq' (K4's work), 'dkv' "
                         "(K5's) or 'fused' (both in one launch)")
    return kernel


def bytes_moved_bwd(B: int, H: int, Tq: int, Tk: int, d: int, itemsize: int,
                    kernel: str, has_bias: bool = True) -> int:
    """Least device-memory traffic of one backward call for dq
    (``kernel="dq"``), for dk and dv (``"dkv"``) or for all three
    (``"fused"``): q, k, v, do, m, l, di and kb read once; the outputs
    written once."""
    kernel = _bwd_kernel_name(kernel)
    G = B * H
    reads = (2 * G * Tq * d + 2 * G * Tk * d) * itemsize + 3 * G * Tq * 4 \
        + (B * Tk * 4 if has_bias else 0)
    writes = (G * Tq * d * (kernel != "dkv")
              + 2 * G * Tk * d * (kernel != "dq")) * itemsize
    return reads + writes


def flops_bwd(B: int, H: int, Tq: int, Tk: int, d: int, kernel: str) -> int:
    """Operations of one backward call: the multiply-adds of ``q k^T``,
    ``do v^T`` and ``ds k`` for dq (``"dq"``, 6 G Tq Tk d); of ``q k^T``,
    ``do v^T``, ``p^T do`` and ``ds^T q`` for dk and dv (``"dkv"``, 8 G Tq
    Tk d); of the five products once for all three (``"fused"``, 10 G Tq
    Tk d). The few elementwise operations per score are left out, so the
    bound stays a lower bound."""
    per = {"dq": 6, "dkv": 8, "fused": 10}[_bwd_kernel_name(kernel)]
    return per * B * H * Tq * Tk * d


def bound_ms_bwd(B: int, H: int, Tq: int, Tk: int, d: int, itemsize: int,
                 kernel: str, has_bias: bool = True) -> tuple:
    """``(ms, "bytes" or "operations")`` for one backward call (``"dq"``,
    ``"dkv"`` or ``"fused"``), as :func:`bound_ms` for K3."""
    rate = H100_F32_FLOPS_PER_S if itemsize == 4 else H100_16BIT_FLOPS_PER_S
    t_bytes = bytes_moved_bwd(B, H, Tq, Tk, d, itemsize, kernel, has_bias) \
        / H100_BYTES_PER_S
    t_ops = flops_bwd(B, H, Tq, Tk, d, kernel) / rate
    return 1e3 * max(t_bytes, t_ops), \
        "bytes" if t_bytes >= t_ops else "operations"


def ulp_error(got, want) -> float:
    """The largest difference of two tensors of a 16-bit dtype in units of
    the output dtype's ulp at the reference value, the ulp taken no finer
    than at 2^-10 of the largest reference magnitude (an output near 0 is
    judged on the scale of the row sums it came from)."""
    mant = {torch.bfloat16: 7, torch.float16: 10}[want.dtype]
    w = want.double()
    floor = max(float(w.abs().max()) * 2.0 ** -10, 1e-30)
    mag = torch.clamp(w.abs(), min=floor)
    ulp = torch.pow(2.0, torch.floor(torch.log2(mag)) - mant)
    return float(((got.double() - w).abs() / ulp).max())
