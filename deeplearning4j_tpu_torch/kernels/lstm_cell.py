"""K8, one LSTM step: ``(h', c')`` from ``(x, h, c, W, RW, b)``, gate
order [i, f, o, g].

Wrapper of ``csrc/lstm_cell.cu``, which replaces the JAX package's
``ops/pallas_kernels.py::_lstm_kernel``. ``x`` is ``[B, F]``, ``h`` and
``c`` ``[B, U]``, each with a contiguous last dimension and any row
stride (``x[:, t, :]`` of a ``[B, T, F]`` sequence is read in place);
``W`` is a contiguous ``[F, 4U]``, ``RW`` a contiguous ``[U, 4U]`` and
``b`` a contiguous ``[4U]``; all in one of f32, bf16 or f16. The products
and the gates are f32, ``forget_bias`` is added to the f gate's
pre-activation, and ``h'`` and ``c'`` come back contiguous in x's dtype,
each rounded once. Forward only, as on the TPU.

- A CPU tensor takes the plain version, :func:`lstm_cell_reference`: the
  kernel's arithmetic in PyTorch, at its rounding points.
- A CUDA tensor launches K8, or raises: on another dtype (float64
  included), mixed dtypes or devices, a weight or bias that is not
  contiguous, a last dimension that is not contiguous, mismatched shapes,
  a failed build or a refused launch. No CUDA call gives way to the plain
  version.

K8 runs as thread-block clusters (:func:`geometry`): a cluster of 1-8
CTAs owns ``UNIT_TILE`` units and up to 32 batch rows, each CTA stages its
slice of the reduction axis ``[x | h]`` and of the weights in one round of
``cp.async`` copies (16 bytes a copy when :func:`vec_flags` allows, else 4),
and the slices' partial sums meet through distributed shared memory in
rank order. :func:`occupancy` and :func:`launch_floor` (an empty kernel
launched the same way) read the card.

``launches`` counts wrapper calls that launched K8.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import _build
from .affine_act import (H100_16BIT_FLOPS_PER_S, H100_BYTES_PER_S,
                         H100_F32_FLOPS_PER_S)

#: units per cluster of the kernel (its kUnits)
UNIT_TILE = 8
#: the kernel's threads a CTA, the reduction elements a CTA aims at, the
#: largest (portable) cluster, and the dynamic shared memory a CTA may use
#: on an H100
THREADS = 256
SLICE_TARGET = 128
MAX_CLUSTER = 8
SMEM_LIMIT = 232448
#: (row group, column group) tiles of a sub-slice; a CTA's 256 threads
#: take THREADS // PAIRS sub-slices of its slice
PAIRS = 64
#: K8 against its plain version: float32 within F32_TOL x max(1, |ref|)
#: (sums of up to F + U products in another order; expf and tanhf may
#: differ from PyTorch's by an ulp)
F32_TOL = 2e-5
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

#: Kernel launches since the last reset (a plain integer; set it to 0).
launches = 0


def lstm_cell_reference(x, h, c, w, rw, b, forget_bias=0.0):
    """K8's plain version: ``z = x W + h RW + b`` in f32 (f64 for f64
    inputs), the gates in f32, ``c`` read as f32, ``h'`` and ``c'`` cast
    once to x's dtype: the TPU kernel's arithmetic. Runs wherever its
    tensors are; the matmuls follow the global TF32 switch, so hold it
    against the kernel with TF32 off."""
    ct = torch.promote_types(x.dtype, torch.float32)
    z = (torch.matmul(x.to(ct), w.to(ct)) + torch.matmul(h.to(ct), rw.to(ct))
         + b.to(ct))
    i, f, o, g = torch.chunk(z, 4, dim=-1)
    f = torch.sigmoid(f + forget_bias)
    c_new = f * c.to(ct) + torch.sigmoid(i) * torch.tanh(g)
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    return h_new.to(x.dtype), c_new.to(x.dtype)


def geometry(B: int, F: int, U: int, itemsize: int) -> dict:
    """K8's launch at this shape (the kernel's ``geometry``): the cluster
    size (the fewest CTAs, a power of two up to ``MAX_CLUSTER``, that cut
    the reduction axis of ``F + U`` into slices of at most
    ``SLICE_TARGET``), the slice each CTA reduces over (a multiple of 16,
    so that each of its 4 sub-slices is read 4 elements at a time), the
    batch rows a CTA takes (8 when ``B <= 8``, else 32), the grid
    (clusters x unit tiles, row tiles), the CTAs, and the dynamic shared
    memory of a CTA: the rows of ``[x | h]`` (padded by 16 bytes), the
    weight rows, the partial sums of the 4 sub-slices and the rank's sum
    (rows x units x 4 gates in f32 each). Raises ValueError for a shape
    whose slice does not fit in a CTA's shared memory or whose row tiles
    overflow the grid."""
    if B <= 0 or F < 0 or U <= 0:
        raise ValueError(f"lstm_cell: shape (B={B}, F={F}, U={U}) is empty")
    K = F + U
    cs = 1
    while cs < MAX_CLUSTER and -(-K // cs) > SLICE_TARGET:
        cs *= 2
    ks = -(-(-(-K // cs)) // 16) * 16
    rt = 8 if B <= 8 else 32
    smem = rt * (ks + 16 // itemsize) * itemsize + ks * 4 * UNIT_TILE \
        * itemsize + (THREADS // PAIRS + 1) * rt * UNIT_TILE * 16
    grid = (cs * -(-U // UNIT_TILE), -(-B // rt))
    if smem > SMEM_LIMIT or grid[1] > 65535:
        raise ValueError(f"lstm_cell: (B={B}, F={F}, U={U}) needs {smem} "
                         f"bytes of shared memory a CTA and {grid[1]} row "
                         f"tiles; the kernel's limit is {SMEM_LIMIT} bytes "
                         "and 65535 row tiles")
    return {"cluster": cs, "slice": ks, "row_tile": rt, "grid": grid,
            "ctas": grid[0] * grid[1], "smem_bytes": smem}


def _aligned(t, n: int) -> bool:
    return t.data_ptr() % 16 == 0 and n * t.element_size() % 16 == 0


def vec_flags(x, h, w, rw) -> int:
    """The kernel's copy widths: bit 0 when the rows of ``[x | h]`` go by
    16-byte copies (x and h start on 16 bytes, and their row strides and F
    are multiples of 16 bytes, so no copy straddles x and h), bit 1 when
    the weight rows do (W and RW start on 16 bytes and U is a multiple of
    16 bytes, so each gate's columns start on 16 bytes). Else 4-byte copies
    (f32) or element loads (16 bits)."""
    F, U = x.shape[1], rw.shape[0]
    xh = (_aligned(x, x.stride(0)) and _aligned(h, h.stride(0))
          and F * x.element_size() % 16 == 0)
    wv = _aligned(w, U) and _aligned(rw, U)
    return int(xh) | int(wv) << 1


def _check(x, h, c, w, rw, b):
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"lstm_cell: dtype {x.dtype} not supported "
                        "(float32, bfloat16, float16)")
    named = (("h", h), ("c", c), ("W", w), ("RW", rw), ("b", b))
    for name, t in named:
        if t.dtype != x.dtype or t.device != x.device:
            raise TypeError(f"lstm_cell: {name} is {t.dtype} on {t.device}; "
                            f"every operand must be {x.dtype} on {x.device}")
    if x.dim() != 2 or w.dim() != 2 or rw.dim() != 2 or b.dim() != 1:
        raise ValueError("lstm_cell: x, W, RW must be 2-D and b 1-D")
    B, F = x.shape
    U = rw.shape[0]
    want = {"h": (B, U), "c": (B, U), "W": (F, 4 * U), "RW": (U, 4 * U),
            "b": (4 * U,)}
    for name, t in named:
        if tuple(t.shape) != want[name]:
            raise ValueError(f"lstm_cell: {name} has shape "
                             f"{tuple(t.shape)}, expected {want[name]}")
    for name, t in (("x", x), ("h", h), ("c", c)):
        if t.shape[1] > 1 and t.stride(1) != 1:
            raise ValueError(f"lstm_cell: {name} needs a contiguous last "
                             f"dimension, got strides {t.stride()}")
    for name, t in (("W", w), ("RW", rw), ("b", b)):
        if not t.is_contiguous():
            raise ValueError(f"lstm_cell: {name} must be contiguous, got "
                             f"strides {t.stride()}")


@functools.lru_cache(maxsize=None)
def _kernel():
    lib = _build.load("lstm_cell")
    fn = lib.dl4j_lstm_cell
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _query(name: str, n: int, B: int, F: int, U: int, dtype) -> list:
    """One of the library's shape queries (``dl4j_lstm_cell_<name>``),
    its ``n`` integers."""
    fn = getattr(_build.load("lstm_cell"), f"dl4j_lstm_cell_{name}")
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * n)()
    rc = fn(B, F, U, _DTYPE_CODES[dtype], out)
    if rc != 0:
        raise RuntimeError(f"lstm_cell {name} query failed: CUDA error {rc}")
    return list(out)


def kernel_geometry(B: int, F: int, U: int, dtype=torch.float32) -> dict:
    """:func:`geometry` as the compiled library computes it (a card test
    holds the two equal)."""
    cs, ks, rt, gx, gy, smem = _query("geometry", 6, B, F, U, dtype)
    return {"cluster": cs, "slice": ks, "row_tile": rt, "grid": (gx, gy),
            "ctas": gx * gy, "smem_bytes": smem}


def occupancy(B: int, F: int, U: int, dtype=torch.float32) -> dict:
    """K8's resources on the current card at this shape: registers and
    local (spill) bytes a thread, threads and shared-memory bytes a CTA,
    the CTAs one SM holds at once and the clusters the card holds at once
    (CUDA's occupancy calculator). Needs the card."""
    return dict(zip(("registers", "threads", "smem_bytes", "local_bytes",
                     "ctas_per_sm", "clusters"),
                    _query("occupancy", 6, B, F, U, dtype)))


def launch_floor(B: int, F: int, U: int, dtype=torch.float32,
                 device=None) -> None:
    """Launch an empty kernel with K8's grid, threads, cluster and shared
    memory at this shape on the current stream: the fixed cost of one K8
    launch, for timing beside it. Not counted in ``launches``."""
    fn = _build.load("lstm_cell").dl4j_lstm_cell_floor
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rc = fn(B, F, U, _DTYPE_CODES[dtype],
            torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"lstm_cell floor launch failed: CUDA error {rc}")


def lstm_cell(x, h, c, w, rw, b, forget_bias=0.0):
    """K8 on CUDA tensors, the plain version on CPU tensors."""
    if x.device.type == "cpu":
        return lstm_cell_reference(x, h, c, w, rw, b, forget_bias)
    if x.device.type != "cuda":
        raise ValueError(f"lstm_cell: tensors on {x.device} are not "
                         "supported (cuda or cpu)")
    global launches
    _check(x, h, c, w, rw, b)
    B, F = x.shape
    U = rw.shape[0]
    h_new = x.new_empty((B, U))
    c_new = torch.empty_like(h_new)
    if B == 0 or U == 0:
        return h_new, c_new
    geometry(B, F, U, x.element_size())  # raises beyond the kernel's limits
    fn = _kernel()
    rc = fn(x.data_ptr(), x.stride(0), h.data_ptr(), h.stride(0),
            c.data_ptr(), c.stride(0), w.data_ptr(), rw.data_ptr(),
            b.data_ptr(), h_new.data_ptr(), c_new.data_ptr(), B, F, U,
            float(forget_bias), _DTYPE_CODES[x.dtype],
            vec_flags(x, h, w, rw),
            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"lstm_cell kernel launch failed: CUDA error {rc}")
    launches += 1
    return h_new, c_new


def bytes_moved(B: int, F: int, U: int, itemsize: int) -> int:
    """Least device-memory traffic of one call: x, h, c, W, RW and b read
    once, h' and c' written once."""
    return itemsize * (B * F + 2 * B * U + 4 * U * (F + U) + 4 * U
                       + 2 * B * U)


def flops(B: int, F: int, U: int) -> int:
    """Operations of one call: the multiply-adds of ``x W`` and ``h RW``,
    ``8 B U (F + U)``. The gate chain's few operations per unit (under 1%
    more at F + U = 333) are left out, so the bound stays a lower bound."""
    return 8 * B * U * (F + U)


def bound_ms(B: int, F: int, U: int, itemsize: int) -> tuple:
    """``(ms, "bytes" or "operations")``: the least time an H100 SXM could
    take for one call, the larger of bytes over the memory rate and the
    operations over the peak rate of the input type (the f32 rate for
    f32, the tensor-core rate for 16-bit inputs)."""
    rate = H100_F32_FLOPS_PER_S if itemsize == 4 else H100_16BIT_FLOPS_PER_S
    t_bytes = bytes_moved(B, F, U, itemsize) / H100_BYTES_PER_S
    t_ops = flops(B, F, U) / rate
    return 1e3 * max(t_bytes, t_ops), \
        "bytes" if t_bytes >= t_ops else "operations"


def tolerance(ref) -> np.ndarray:
    """The per-element bound on ``|kernel - plain|``, as float64 numpy:
    F32_TOL x max(1, |ref|) in float32; for a 16-bit output one ulp of its
    dtype at the reference value, or that float32 bound where it is larger
    (near 0 the f32 sums' order noise is larger than a 16-bit ulp). The
    ulp is exact (``frexp``/``ldexp``), so a difference of one ulp gives
    exactly 1."""
    r = np.abs(ref.detach().double().cpu().numpy())
    f32 = F32_TOL * np.maximum(r, 1.0)
    if ref.dtype == torch.float32:
        return f32
    mant = {torch.bfloat16: 7, torch.float16: 10}[ref.dtype]
    _, e = np.frexp(r)  # r = m * 2**e, 0.5 <= m < 1
    ulp = np.where(r > 0, np.ldexp(1.0, e - 1 - mant), 0.0)
    return np.maximum(ulp, f32)


def max_violation(got, ref) -> float:
    """The largest ``|got - ref|`` in units of :func:`tolerance` (at most
    1 passes)."""
    diff = np.abs(got.detach().double().cpu().numpy()
                  - ref.detach().double().cpu().numpy())
    return float((diff / tolerance(ref)).max(initial=0.0))


def torch_lstm_cell_operands(w, rw, b, forget_bias=0.0):
    """``(w_ih, w_hh, b_ih, b_hh)`` for ``torch.lstm_cell``, which
    computes the same step with gate order [i, f, g, o], weights as
    ``[4U, in]`` and no forget bias: the gates reordered, W and RW
    transposed, ``forget_bias`` folded into the f gate's bias. The port
    never calls ``torch.lstm_cell``; the card run times it beside K8."""
    U = rw.shape[0]
    order = torch.cat([torch.arange(0, 2 * U), torch.arange(3 * U, 4 * U),
                       torch.arange(2 * U, 3 * U)]).to(w.device)
    bias = b.clone()
    bias[U:2 * U] += forget_bias
    return (w.t()[order].contiguous(), rw.t()[order].contiguous(),
            bias[order].contiguous(), torch.zeros_like(bias))
