"""K1 and K2, the affine + activation epilogue and its backward.

- K1, ``y = act(x * scale + shift)``: wrapper of ``csrc/affine_act.cu``,
  which replaces the JAX package's
  ``ops/fused_epilogues.py::_fused_epilogue_affine_fwd``.
- K2, ``(dx, dscale, dshift)`` of K1 given ``dy``: wrapper of
  ``csrc/affine_act_bwd.cu``, which replaces
  ``ops/fused_epilogues.py::_fused_epilogue_affine_bwd``. It recomputes
  ``z`` from x, scale and shift and differentiates the activation with
  :func:`act_grad` (relu' is 0 at z == 0, relu6' 0 at 0 and 6, as in the
  JAX package; ``torch.clamp``'s autograd would give 1 there).

``x2`` and ``dy`` are ``[rows, C]`` in f32, bf16 or f16; ``scale``
(optional) and ``shift`` are f32 ``[C]``. The math is f32; ``y`` and
``dx`` have x's dtype, ``dscale`` and ``dshift`` are f32. The plain
versions also take float64 (a ``DOUBLE`` network on the CPU) and then
compute in float64, as the JAX package's fallback does for a dtype its
kernels do not take; the kernels refuse float64.

- A CPU tensor takes the plain version (:func:`affine_act_reference`,
  :func:`affine_act_bwd_reference`).
- A CUDA tensor launches the kernel, or raises: on an unsupported dtype,
  layout or activation, on a failed build and on a refused launch. No
  CUDA call ever gives way to the plain version.

``launches`` and ``bwd_launches`` count wrapper calls that launched K1 and
K2 (plain-version calls are not counted; one K2 call is two CUDA kernels,
the partial sums and their fixed-order total); ``bf16_launches`` and
``bf16_bwd_launches`` count those of them on a bfloat16 ``x2``.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import _build

#: Activations K1 implements; the index is the kernel's ``act`` code.
ACTS = ("identity", "relu", "relu6", "tanh", "sigmoid", "gelu", "geluexact")
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

_SQRT_2_OVER_PI = 0.7978845608028654
_GELU_A = 0.044715
_INV_SQRT2 = 0.7071067811865476
_INV_SQRT_2PI = 0.3989422804014327

#: Kernel launches since the last reset (plain integers; set them to 0 to
#: reset).
launches = 0
bwd_launches = 0
bf16_launches = 0
bf16_bwd_launches = 0


def act_fwd(act: str, z):
    """act(z) on an f32 tensor, the same formulas the kernel uses."""
    if act == "identity":
        return z
    if act == "relu":
        return torch.clamp(z, min=0.0)
    if act == "relu6":
        return torch.clamp(z, 0.0, 6.0)
    if act == "tanh":
        return torch.tanh(z)
    if act == "sigmoid":
        return torch.sigmoid(z)
    if act == "gelu":  # tanh approximation (DL4J GELU)
        u = _SQRT_2_OVER_PI * (z + _GELU_A * z * z * z)
        return 0.5 * z * (1.0 + torch.tanh(u))
    if act == "geluexact":  # erf form (ONNX Gelu)
        return 0.5 * z * (1.0 + torch.erf(z * _INV_SQRT2))
    raise ValueError(f"unfoldable activation {act!r}")


def act_grad(act: str, z):
    """d act / d z on an f32 tensor, recomputed from the pre-activation:
    the JAX package's ``_act_grad`` and the kernel's, ties included."""
    if act == "identity":
        return torch.ones_like(z)
    if act == "relu":
        return (z > 0.0).to(z.dtype)
    if act == "relu6":
        return ((z > 0.0) & (z < 6.0)).to(z.dtype)
    if act == "tanh":
        t = torch.tanh(z)
        return 1.0 - t * t
    if act == "sigmoid":
        s = torch.sigmoid(z)
        return s * (1.0 - s)
    if act == "gelu":
        u = _SQRT_2_OVER_PI * (z + _GELU_A * z * z * z)
        t = torch.tanh(u)
        du = _SQRT_2_OVER_PI * (1.0 + 3.0 * _GELU_A * z * z)
        return 0.5 * (1.0 + t) + 0.5 * z * (1.0 - t * t) * du
    if act == "geluexact":
        cdf = 0.5 * (1.0 + torch.erf(z * _INV_SQRT2))
        pdf = _INV_SQRT_2PI * torch.exp(-0.5 * z * z)
        return cdf + z * pdf
    raise ValueError(f"unfoldable activation {act!r}")


def _math_dtype(dtype):
    """f32 for the kernels' dtypes, f64 for f64."""
    return torch.promote_types(dtype, torch.float32)


def affine_act_reference(x2, scale, shift, act="identity"):
    """The plain version: f32 math, one cast back to x's dtype — the TPU
    kernel's arithmetic."""
    z = x2.to(_math_dtype(x2.dtype))
    z = z * scale + shift if scale is not None else z + shift
    return act_fwd(act, z).to(x2.dtype)


def affine_act_bwd_reference(x2, scale, shift, dy, act="identity"):
    """K2's plain version on ``[rows, C]`` tensors: ``(dx, dscale,
    dshift)``, f32 math, dx cast once to x's dtype; ``dscale`` is None when
    ``scale`` is."""
    x = x2.to(_math_dtype(x2.dtype))
    z = x * scale + shift if scale is not None else x + shift
    dz = dy.to(x.dtype) * act_grad(act, z)
    dx = (dz * scale if scale is not None else dz).to(x2.dtype)
    dscale = (dz * x).sum(0) if scale is not None else None
    return dx, dscale, dz.sum(0)


def _check(x2, scale, shift, act):
    if act not in ACTS:
        raise ValueError(f"affine_act: activation {act!r} not in {ACTS}")
    if x2.dtype not in _DTYPE_CODES:
        raise TypeError(f"affine_act: dtype {x2.dtype} not supported "
                        "(float32, bfloat16, float16)")
    if x2.dim() != 2 or not x2.is_contiguous():
        raise ValueError("affine_act: x must be a contiguous row-major "
                         f"[rows, C] tensor, got shape {tuple(x2.shape)} "
                         f"strides {x2.stride()}")
    cols = x2.shape[1]
    for name, v in (("scale", scale), ("shift", shift)):
        if v is None and name == "scale":
            continue
        if v is None or v.dtype != torch.float32 or v.dim() != 1 \
                or v.shape[0] != cols or not v.is_contiguous() \
                or v.device != x2.device:
            raise ValueError(f"affine_act: {name} must be a contiguous "
                             f"float32 [{cols}] tensor on {x2.device}")


@functools.lru_cache(maxsize=None)
def _kernel():
    lib = _build.load("affine_act")
    fn = lib.dl4j_affine_act
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _kernel_bwd():
    lib = _build.load("affine_act_bwd")
    fn = lib.dl4j_affine_act_bwd
    fn.argtypes = [ctypes.c_void_p] * 8 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _max_blocks(device_index: int) -> int:
    # a grid-stride loop: enough 256-thread blocks to fill every SM
    return _sm_count(device_index) * 8


def _device_index(t) -> int:
    return t.device.index if t.device.index is not None \
        else torch.cuda.current_device()


def affine_act(x2, scale, shift, act="identity"):
    """K1 on a CUDA tensor, the plain version on a CPU tensor."""
    if x2.device.type == "cpu":
        return affine_act_reference(x2, scale, shift, act)
    if x2.device.type != "cuda":
        raise ValueError(f"affine_act: tensors on {x2.device} are not "
                         "supported (cuda or cpu)")
    global launches, bf16_launches
    _check(x2, scale, shift, act)
    y = torch.empty_like(x2)
    rows, cols = x2.shape
    if rows == 0 or cols == 0:
        return y
    fn = _kernel()
    width = 16 // x2.element_size()
    vec = int(cols % width == 0 and x2.data_ptr() % 16 == 0
              and y.data_ptr() % 16 == 0)
    dev = _device_index(x2)
    rc = fn(x2.data_ptr(), None if scale is None else scale.data_ptr(),
            shift.data_ptr(), y.data_ptr(), rows, cols, ACTS.index(act),
            _DTYPE_CODES[x2.dtype], vec, _max_blocks(dev),
            torch.cuda.current_stream(x2.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"affine_act kernel launch failed: CUDA error {rc}")
    launches += 1
    bf16_launches += x2.dtype == torch.bfloat16
    return y


#: threads of one K2 block (the kernel's kThreads)
BWD_THREADS = 256


def bwd_grid(rows: int, cols: int, vec_width: int, sms: int) -> tuple:
    """K2's first-stage layout ``(tx, groups)`` for a ``[rows, cols]``
    call: ``tx`` threads per block along the columns (the least power of
    two, at most 32, that covers ``cols`` in ``vec_width``-element
    vectors; the other ``256 / tx`` threads walk rows), and ``groups`` row
    groups, enough blocks for 8 per SM over the column tiles, but no more
    groups than the rows fill. A function of the shape and the card only,
    so the reduction order, and the sums, are the same on every run."""
    lanes = -(-cols // vec_width)
    tx = 1
    while tx < lanes and tx < 32:
        tx *= 2
    ty = BWD_THREADS // tx
    tiles = -(-cols // (tx * vec_width))
    groups = min(-(-rows // ty), (sms * 8) // tiles, 65535)
    return tx, max(1, groups)


def _check_bwd(x2, scale, shift, dy, act):
    _check(x2, scale, shift, act)
    if dy.dtype != x2.dtype or dy.shape != x2.shape \
            or not dy.is_contiguous() or dy.device != x2.device:
        raise ValueError(
            f"affine_act_bwd: dy must be a contiguous {x2.dtype} "
            f"{tuple(x2.shape)} tensor on {x2.device}, got {dy.dtype} "
            f"{tuple(dy.shape)} strides {dy.stride()} on {dy.device}")


def affine_act_bwd(x2, scale, shift, dy, act="identity"):
    """K2 on CUDA tensors, the plain version on CPU tensors: ``(dx,
    dscale, dshift)`` (``dscale`` None when ``scale`` is)."""
    if x2.device.type == "cpu":
        return affine_act_bwd_reference(x2, scale, shift, dy, act)
    if x2.device.type != "cuda":
        raise ValueError(f"affine_act_bwd: tensors on {x2.device} are not "
                         "supported (cuda or cpu)")
    global bwd_launches, bf16_bwd_launches
    _check_bwd(x2, scale, shift, dy, act)
    fn = _kernel_bwd()
    rows, cols = x2.shape
    f32 = dict(dtype=torch.float32, device=x2.device)
    dx = torch.empty_like(x2)
    if rows == 0 or cols == 0:
        return (dx, None if scale is None else torch.zeros(cols, **f32),
                torch.zeros(cols, **f32))
    dscale = None if scale is None else torch.empty(cols, **f32)
    dshift = torch.empty(cols, **f32)
    width = 16 // x2.element_size()
    vec = int(cols % width == 0 and all(
        t.data_ptr() % 16 == 0 for t in (x2, dy, dx)))
    tx, groups = bwd_grid(rows, cols, width if vec else 1,
                          _sm_count(_device_index(x2)))
    partials = torch.empty((2, groups, cols), **f32)
    rc = fn(x2.data_ptr(), None if scale is None else scale.data_ptr(),
            shift.data_ptr(), dy.data_ptr(), dx.data_ptr(),
            None if dscale is None else dscale.data_ptr(),
            dshift.data_ptr(), partials.data_ptr(), rows, cols,
            ACTS.index(act), _DTYPE_CODES[x2.dtype], vec, tx, groups,
            torch.cuda.current_stream(x2.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"affine_act_bwd kernel launch failed: CUDA error {rc}")
    bwd_launches += 1
    bf16_bwd_launches += x2.dtype == torch.bfloat16
    return dx, dscale, dshift


def bytes_moved(rows: int, cols: int, itemsize: int,
                has_scale: bool = True) -> int:
    """Least device-memory traffic of one call: x read once, y written
    once, scale and shift read once."""
    return 2 * rows * cols * itemsize + (2 if has_scale else 1) * cols * 4


def flops(rows: int, cols: int, act: str, has_scale: bool = True) -> int:
    """f32 operations of one call: the affine (multiply and add) plus a
    per-activation count (transcendentals counted as one)."""
    per = {"identity": 0, "relu": 1, "relu6": 2, "tanh": 1, "sigmoid": 3,
           "gelu": 8, "geluexact": 5}[act]
    return rows * cols * ((2 if has_scale else 1) + per)


#: Published peaks of one H100 SXM (NVIDIA's data sheet, at 700 W): the
#: device-memory rate, the float32 rate outside the tensor cores and the
#: dense bf16/f16 tensor-core rate.
H100_BYTES_PER_S = 3.35e12
H100_F32_FLOPS_PER_S = 67e12
H100_16BIT_FLOPS_PER_S = 989e12


def bound_ms(rows: int, cols: int, itemsize: int, act: str) -> float:
    """The least time an H100 SXM could take for one call: the larger of
    bytes over the memory rate and f32 operations over the f32 rate."""
    return 1e3 * max(bytes_moved(rows, cols, itemsize) / H100_BYTES_PER_S,
                     flops(rows, cols, act) / H100_F32_FLOPS_PER_S)


def bytes_moved_bwd(rows: int, cols: int, itemsize: int,
                    has_scale: bool = True) -> int:
    """Least device-memory traffic of one K2 call: x and dy read once, dx
    written once; scale and shift read, dscale and dshift written once."""
    return 3 * rows * cols * itemsize + (4 if has_scale else 2) * cols * 4


def flops_bwd(rows: int, cols: int, act: str, has_scale: bool = True) -> int:
    """f32 operations of one K2 call per element: the recomputed affine,
    act'(z) (transcendentals counted as one), dz, dx and the two column
    sums (a multiply-add and an add)."""
    per = {"identity": 0, "relu": 1, "relu6": 2, "tanh": 3, "sigmoid": 5,
           "gelu": 14, "geluexact": 10}[act]
    base = 7 if has_scale else 3
    return rows * cols * (base + per)


def bound_ms_bwd(rows: int, cols: int, itemsize: int, act: str,
                 has_scale: bool = True) -> float:
    """The least time an H100 SXM could take for one K2 call: the larger
    of bytes over the memory rate and f32 operations over the f32 rate."""
    return 1e3 * max(
        bytes_moved_bwd(rows, cols, itemsize, has_scale) / H100_BYTES_PER_S,
        flops_bwd(rows, cols, act, has_scale) / H100_F32_FLOPS_PER_S)


def ulp_tolerance(dtype) -> tuple:
    """(atol, rtol) for holding K1 (and K2's dx) against its plain
    version: f32 differs by the card's libm ulps (about 1e-6 relative); a
    16-bit output may then round the other way, one ulp of the output
    dtype."""
    if dtype == torch.float32:
        return 1e-5, 1e-5
    mant = {torch.bfloat16: 7, torch.float16: 10}[dtype]
    return 1e-5, math.ldexp(1.0, -mant)
