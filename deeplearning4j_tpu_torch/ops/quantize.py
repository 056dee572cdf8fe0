"""Int8 post-training quantization primitives.

Port of ``deeplearning4j_tpu/ops/quantize.py``: per-channel symmetric int8
weights (:class:`QuantizedTensor`, one f32 scale per OUTPUT channel, range
±127), dynamic activation scales computed per call (per example, so a
request's answer never depends on its batch neighbours), the fused
:func:`int8_matmul` / :func:`int8_conv` (quantize the activation, contract
int8 x int8 into an int32 accumulator, dequantize in the epilogue), the
per-row int8 KV-cache codec (:func:`quantize_rows` /
:func:`dequantize_rows`), the params-tree walk behind
``quantize_params`` and the serving engines, and the
``quantize.int8_mmul`` catalog op (the SameDiff rewrite's target).

The contraction. ``impl()`` ``"dot"`` is the card's int8 route:
``torch._int_mm`` (cuBLASLt's int8 GEMM with an int32 accumulator). On
CUDA it wants the right operand column-major, more than 16 rows and K and
N multiples of 8; the wrapper lays the operand out so and zero-pads rows
and columns to those rules (exact for integers), counting each padded
call in :func:`pad_counters`, not as a fallback. ``"einsum"`` is the plain
integer contraction in float64 (exact: every partial sum of int8 products
stays far below 2**53; CUDA has no integer matmul). On the CPU "dot" is
``torch._int_mm`` too. The two impls are bit-identical. The convolution has no int8
library call on CUDA: :func:`int8_conv` lowers to im2col (a strided view
of the int8 activation) + the same contraction, one per group.

Rounding and order follow the JAX module bit for bit: scales are
``amax / 127`` in f32, an IEEE division on either device (unit scale at
``amax <= 1e-12``), values are
``round(x32 / scale)`` half-to-even and clipped to ±127, and the
epilogues are ``acc * x_scale * w_scale`` (matmul) or
``acc * (x_scale * w_scale)`` (conv), then ``+ bias``, then the cast to the
input's floating dtype (float32 for integer inputs).

Pins: ``DL4J_TPU_QUANT`` (``int8`` | ``off``; ``off`` makes every engine's
``quantize="int8"`` serve f32, counted as a fallback) and
``DL4J_TPU_QUANT_IMPL`` (``dot`` | ``einsum``). :func:`counters` counts
the dispatch decisions under the JAX names (``dot``, ``einsum``,
``conv``) and :func:`rewrite_counters` the SameDiff rewrite's; both are
plain integers, not the JAX telemetry registry.
"""

from __future__ import annotations

import os
import threading
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import register

#: symmetric range: ±127, so q == -q is representable
QMAX = 127.0
#: scale floor for all-zero channels and tensors (unit scale below it)
_EPS = 1e-12

_lock = threading.Lock()
_DISPATCH: dict = {}
_REWRITE: dict = {}
_PAD: dict = {}

_state = {
    "mode": os.environ.get("DL4J_TPU_QUANT", "int8"),
    "impl": os.environ.get("DL4J_TPU_QUANT_IMPL", "dot"),
}


def _bump(table: dict, key: str) -> None:
    with _lock:
        table[key] = table.get(key, 0) + 1


def mode() -> str:
    """``int8`` (quantization honored when an engine asks for it) or
    ``off`` (the ``DL4J_TPU_QUANT=off`` pin: every engine-level quantize
    request serves f32 instead, counted as a fallback)."""
    return _state["mode"]


def set_mode(m: str) -> str:
    if m not in ("int8", "off"):
        raise ValueError(f"quantize mode {m!r} not in ('int8', 'off')")
    old = _state["mode"]
    _state["mode"] = m
    return old


def impl() -> str:
    return _state["impl"]


def set_impl(i: str) -> str:
    """``dot`` (``torch._int_mm``, the card's int8 GEMM) or ``einsum``
    (the plain integer contraction). Bit-identical; returns the old
    one."""
    if i not in ("dot", "einsum"):
        raise ValueError(f"quantize impl {i!r} not in ('dot', 'einsum')")
    old = _state["impl"]
    _state["impl"] = i
    return old


# --------------------------------------------------------------------------
# quantized weight container
# --------------------------------------------------------------------------

class QuantizedTensor:
    """Per-channel symmetric int8 weight: ``q`` int8 with the original
    shape, ``scale`` f32 ``[channels]`` along ``axis`` (the OUTPUT channel
    axis). The tree walks of ``utils/tree.py`` see it as one leaf pair
    (``q``, ``scale``); ``dtypes.cast_floating`` leaves it whole (its scales
    stay f32 under a 16-bit policy)."""

    __slots__ = ("q", "scale", "axis")

    #: duck-type marker shared with the JAX package's class
    __quantized_tensor__ = True

    def __init__(self, q, scale, axis: int):
        self.q = q
        self.scale = scale
        self.axis = int(axis)

    @property
    def shape(self):
        return self.q.shape

    @property
    def dtype(self):
        return self.q.dtype

    @property
    def nbytes(self) -> int:
        return _nbytes(self.q) + _nbytes(self.scale)

    def to(self, device) -> "QuantizedTensor":
        return QuantizedTensor(self.q.to(device), self.scale.to(device),
                               self.axis)

    def _bcast_scale(self):
        shape = [1] * self.q.dim()
        shape[self.axis] = self.q.shape[self.axis]
        return self.scale.to(torch.float32).reshape(shape)

    def dequantize(self, dtype=torch.float32):
        return (self.q.to(torch.float32) * self._bcast_scale()).to(dtype)

    def __repr__(self):
        return (f"QuantizedTensor(int8 {tuple(self.q.shape)}, "
                f"axis={self.axis})")


def is_quantized(a) -> bool:
    return getattr(a, "__quantized_tensor__", False)


def _nbytes(a) -> int:
    return int(a.numel()) * a.element_size()


_QMAX_ON: dict = {}


def _qmax_on(device) -> torch.Tensor:
    """127.0 as a 0-d float32 tensor on ``device``, made once: divided by a
    Python float, a CUDA tensor is multiplied by its reciprocal, one bit
    off the IEEE division the JAX package and the CPU make; a fresh tensor
    a call would copy host to device each time."""
    t = _QMAX_ON.get(device)
    if t is None:
        with torch.inference_mode(False):
            t = _QMAX_ON.setdefault(device,
                                    torch.tensor(QMAX, device=device))
    return t


def _scale_of(amax):
    return torch.where(amax <= _EPS, torch.ones_like(amax),
                       amax / _qmax_on(amax.device))


def _round_clip(x32, scale):
    return torch.clamp(torch.round(x32 / scale), -QMAX, QMAX).to(torch.int8)


def quantize_per_channel(w, axis: int) -> QuantizedTensor:
    """Symmetric per-channel int8 quantization of a weight: one f32 scale
    per slice along ``axis`` (``absmax / 127``), values rounded
    half-to-even and clipped to ±127; an all-zero channel gets a unit
    scale."""
    w = torch.as_tensor(w)
    axis = axis % w.dim()
    w32 = w.detach().to(torch.float32)
    reduce_axes = tuple(i for i in range(w.dim()) if i != axis)
    amax = torch.amax(torch.abs(w32), dim=reduce_axes) if reduce_axes \
        else torch.abs(w32)
    scale = _scale_of(amax)
    shape = [1] * w.dim()
    shape[axis] = w.shape[axis]
    q = _round_clip(w32, scale.reshape(shape))
    if q.dim() == 2 and axis == 1:
        # a [in, out] matmul weight is held column-major: the layout the
        # card's int8 GEMM takes its right operand in, so no call copies it
        q = q.t().contiguous().t()
    return QuantizedTensor(q, scale, axis)


def quantize_dynamic(x) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor dynamic activation quantization: ``(q int8, scale f32
    scalar)`` from this call's absmax."""
    x32 = torch.as_tensor(x).to(torch.float32)
    scale = _scale_of(torch.amax(torch.abs(x32)))
    return _round_clip(x32, scale), scale


def quantize_per_example(x) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-example dynamic activation quantization: one scale per
    leading-axis row (``scale`` f32 ``[B, 1, ..., 1]``), so every row's
    quantization is a function of that row alone (batch invariance)."""
    x32 = torch.as_tensor(x).to(torch.float32)
    axes = tuple(range(1, x32.dim()))
    amax = torch.amax(torch.abs(x32), dim=axes, keepdim=True)
    scale = _scale_of(amax)
    return _round_clip(x32, scale), scale


# --------------------------------------------------------------------------
# the int8 contraction
# --------------------------------------------------------------------------

def _ceil8(n: int) -> int:
    return -(-n // 8) * 8


def int_mm(a, b):
    """int8 ``a`` ``[M, K]`` times int8 ``b`` ``[K, N]`` into int32 ``[M,
    N]``: on CUDA ``torch._int_mm`` (cuBLASLt's int8 GEMM), which takes
    ``b`` column-major only, with ``M > 16`` and ``K`` and ``N`` multiples
    of 8: the wrapper lays ``b`` out so and zero-pads rows and columns to
    those rules (exact for integers), then slices back; each padded call
    is counted in :func:`pad_counters`. On the CPU ``torch._int_mm`` takes
    any shape."""
    if a.device.type != "cuda":
        return torch._int_mm(a.contiguous(), b.contiguous())
    return _int_mm_padded(a, b)


def _int_mm_padded(a, b):
    """:func:`int_mm` with the CUDA rules applied on any device."""
    M, K = a.shape
    N = b.shape[1]
    Mp = M if M > 16 else 24
    Kp, Np = _ceil8(K), _ceil8(N)
    for axis, was, now in (("rows", M, Mp), ("k", K, Kp), ("n", N, Np)):
        if now != was:
            _bump(_PAD, axis)
    if (Mp, Kp) != (M, K):
        a = F.pad(a, (0, Kp - K, 0, Mp - M))
    bt = b.t()                                   # [N, K]
    if (Np, Kp) != (N, K):
        bt = F.pad(bt, (0, Kp - K, 0, Np - N))
    acc = torch._int_mm(a.contiguous(), bt.contiguous().t())
    return acc[:M, :N] if (Mp, Np) != (M, N) else acc


def int_mm_plain(a, b):
    """The plain integer contraction, in float64 on either device (CUDA
    has no integer matmul; every partial sum of int8 products is an
    integer below 2**53, so float64 is exact), cast back to int32."""
    return torch.matmul(a.to(torch.float64),
                        b.to(torch.float64)).to(torch.int32)


def _contract(a, b):
    """``[M, K] x [K, N]`` int8 -> int32 through :func:`impl`'s route."""
    return int_mm_plain(a, b) if _state["impl"] == "einsum" \
        else int_mm(a, b)


def _int8_contract(xq, wq):
    """int8 ``xq`` ``[..., K]`` x int8 ``wq`` ``[K, N]`` -> int32 ``[...,
    N]``, the decision counted."""
    _bump(_DISPATCH, _state["impl"])
    acc = _contract(xq.reshape(-1, xq.shape[-1]), wq)
    return acc.reshape(tuple(xq.shape[:-1]) + (wq.shape[1],))


def _out_dtype(x):
    return x.dtype if x.is_floating_point() else torch.float32


def int8_matmul(x, wq, w_scale, bias=None, out_dtype=None):
    """Fused quantized matmul: quantize ``x`` per example (per tensor when
    1-D), contract in int8 into an int32 accumulator, dequantize by
    ``x_scale[row] * w_scale[out]``, add ``bias`` in f32. ``wq`` int8
    ``[in, out]``, ``w_scale`` f32 ``[out]``; output in ``x``'s floating
    dtype."""
    x = torch.as_tensor(x)
    out_dtype = out_dtype or _out_dtype(x)
    if x.dim() >= 2:
        xq, xs = quantize_per_example(x)
    else:
        xq, xs = quantize_dynamic(x)
    acc = _int8_contract(xq, wq)
    y = acc.to(torch.float32) * xs * w_scale.to(torch.float32)
    if bias is not None:
        y = y + bias.to(torch.float32)
    return y.to(out_dtype)


def qdot(x, w, bias=None):
    """``x @ w + bias`` that routes a :class:`QuantizedTensor` ``w``
    through :func:`int8_matmul`: the one call site the dense, output and
    attention-projection layers use. Mixed float operands promote, as
    ``jnp.dot``'s do (a bfloat16 decode walk meets float32 masks)."""
    if is_quantized(w):
        if w.axis != w.q.dim() - 1:
            raise ValueError(
                f"qdot needs output-channel-last quantization (axis="
                f"{w.q.dim() - 1}); got axis={w.axis}")
        return int8_matmul(x, w.q, w.scale, bias)
    if x.dtype != w.dtype:
        dt = torch.promote_types(x.dtype, w.dtype)
        x, w = x.to(dt), w.to(dt)
    y = torch.matmul(x, w)
    return y if bias is None else y + bias


def _pair(v):
    return (int(v), int(v)) if isinstance(v, int) else tuple(
        int(i) for i in v)


def _im2col(xq, kh, kw, stride, dilation, pads):
    """int8 NHWC ``xq`` -> ``([N*OH*OW, kh*kw*C], (N, OH, OW))``, the
    patches as a strided view copied once."""
    (pt, pb), (pl, pr) = pads
    if pt or pb or pl or pr:
        xq = F.pad(xq, (0, 0, pl, pr, pt, pb))
    dh, dw = dilation
    keh, kew = (kh - 1) * dh + 1, (kw - 1) * dw + 1
    u = xq.unfold(1, keh, stride[0]).unfold(2, kew, stride[1])
    if dh > 1 or dw > 1:
        u = u[..., ::dh, ::dw]
    N, OH, OW, C = u.shape[:4]
    return (u.permute(0, 1, 2, 4, 5, 3).reshape(N * OH * OW, kh * kw * C),
            (N, OH, OW))


def int8_conv(x, w: QuantizedTensor, b=None, stride=(1, 1), padding=0,
              dilation=(1, 1), mode="truncate", data_format="NCHW",
              groups: int = 1):
    """Fused quantized 2D convolution (OIHW weights quantized per OUTPUT
    channel, ``axis=0``): quantize ``x`` per example, im2col + the int8
    contraction into an int32 accumulator (one per group), dequantize per
    output channel, add ``b`` in f32. Pads exactly as ``nnops.conv2d``
    (``_spatial_pads``)."""
    from .nnops import _spatial_pads
    if w.axis != 0:
        raise ValueError(f"int8_conv wants per-output-channel (axis=0) "
                         f"quantization; got axis={w.axis}")
    if data_format not in ("NCHW", "NHWC"):
        raise ValueError(f"Unknown data_format {data_format}")
    x = torch.as_tensor(x)
    out_dtype = _out_dtype(x)
    stride, dilation = _pair(stride), _pair(dilation)
    O, Ig, kh, kw = (int(s) for s in w.q.shape)
    xq, xs = quantize_per_example(x)            # [N, 1, 1, 1]
    if data_format == "NCHW":
        xq = xq.permute(0, 2, 3, 1)
    k_eff = ((kh - 1) * dilation[0] + 1, (kw - 1) * dilation[1] + 1)
    pads = _spatial_pads(mode, padding, tuple(xq.shape[1:3]), k_eff, stride)
    _bump(_DISPATCH, "conv")
    Og = O // int(groups)
    # OIHW -> [kh*kw*I, O] in _im2col's column order, column-major (the
    # card's int8 GEMM takes its right operand so)
    wk = w.q.permute(0, 2, 3, 1).reshape(O, kh * kw * Ig).t()
    accs = []
    for g in range(int(groups)):
        cols, (N, OH, OW) = _im2col(xq[..., g * Ig:(g + 1) * Ig], kh, kw,
                                    stride, dilation, pads)
        acc = _contract(cols, wk[:, g * Og:(g + 1) * Og])
        accs.append(acc.reshape(N, OH, OW, Og))
    acc = accs[0] if len(accs) == 1 else torch.cat(accs, dim=-1)
    chan = w.scale.to(torch.float32).reshape(1, 1, 1, -1)
    y = acc.to(torch.float32) * (xs * chan)
    if b is not None:
        y = y + b.to(torch.float32).reshape(1, 1, 1, -1)
    y = y.to(out_dtype)
    return y.permute(0, 3, 1, 2) if data_format == "NCHW" else y


# --------------------------------------------------------------------------
# int8 KV cache: per-row scales beside the caches
# --------------------------------------------------------------------------

def quantize_rows(x) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row KV quantization: ``x`` ``[..., d]`` -> ``(q int8, scale f32
    [..., 1])``: one scale per (slot, head, position), appended through
    ``cache_insert`` / ``paged_insert`` as a ``d = 1`` cache."""
    x32 = torch.as_tensor(x).to(torch.float32)
    scale = _scale_of(torch.amax(torch.abs(x32), dim=-1, keepdim=True))
    return _round_clip(x32, scale), scale


def dequantize_rows(q, scale, dtype):
    """Inverse of :func:`quantize_rows`: int8 cache + its scales -> the
    compute-dtype cache the decode kernels read."""
    return (q.to(torch.float32) * scale.to(torch.float32)).to(dtype)


# --------------------------------------------------------------------------
# params-tree walk (MLN / CG quantize_params and the engines)
# --------------------------------------------------------------------------

class QuantizeReport:
    """What a params-tree quantization pass did: ``sites`` weights
    quantized, ``skipped`` candidates left f32 (with ``reasons``), and the
    byte accounting."""

    def __init__(self):
        self.sites = 0
        self.skipped = 0
        self.reasons = []
        self.bytes_f32 = 0
        self.bytes_q = 0

    @property
    def bytes_saved(self) -> int:
        return max(0, self.bytes_f32 - self.bytes_q)

    def __str__(self):
        return (f"quantize: {self.sites} weights -> int8 "
                f"({self.bytes_f32} -> {self.bytes_q} bytes), "
                f"{self.skipped} skipped")


def quantize_layer_params(layer, params, report: Optional[QuantizeReport]
                          = None) -> dict:
    """Quantize one layer's weights per its ``quantize_spec``: the named
    leaves become :class:`QuantizedTensor`, everything else stays as it
    is. The ``quantizable`` class flag gates the spec."""
    if not params or not getattr(layer, "quantizable", False):
        return params
    spec = layer.quantize_spec(params)
    if not spec:
        return params
    new = dict(params)
    for name, axis in spec.items():
        w = new.get(name)
        if w is None or is_quantized(w):
            continue
        qt = quantize_per_channel(w, axis)
        if report is not None:
            report.sites += 1
            report.bytes_f32 += _nbytes(w)
            report.bytes_q += qt.nbytes
        new[name] = qt
    return new


def quantize_model_params(model) -> Tuple[dict, QuantizeReport]:
    """The layer walk of ``quantize_params`` for MultiLayerNetwork and
    ComputationGraph: a NEW params tree with every opted-in weight
    quantized; the model's own params are untouched."""
    report = QuantizeReport()
    out = {}
    with torch.no_grad():
        if hasattr(model.conf, "inputs"):          # ComputationGraph
            from ..nn.vertices import LayerVertex
            for name, (v, _ins) in model._vertex_map.items():
                p = model.params.get(name)
                if p is None:
                    continue
                lyr = v.layer if isinstance(v, LayerVertex) else None
                out[name] = quantize_layer_params(lyr, p, report) \
                    if lyr is not None else p
        else:                                      # MultiLayerNetwork
            for i, layer in enumerate(model.layers):
                si = str(i)
                p = model.params.get(si)
                if p is None:
                    continue
                out[si] = quantize_layer_params(layer, p, report)
    return out, report


def quantized_bytes(tree) -> Tuple[int, int]:
    """``(total_bytes, int8_bytes)`` of a params tree (a quantized leaf
    counts its values and its scales)."""
    from ..utils.tree import leaves
    total = q = 0
    for leaf in leaves(tree):
        n = _nbytes(leaf)
        total += n
        if leaf.dtype == torch.int8:
            q += n
    return total, q


# --------------------------------------------------------------------------
# graph op (the SameDiff rewrite target, autodiff/quantize.py)
# --------------------------------------------------------------------------

@register("quantize.int8_mmul", category="quantize", differentiable=False)
def int8_mmul(x, wq, w_scale):
    """Quantized-weight matmul graph op: ``wq`` int8 ``[in, out]``,
    ``w_scale`` f32 ``[out]``; the activation quantizes per call.
    Inference only: a gradient asked through it raises (rounding has no
    useful gradient)."""
    if torch.is_grad_enabled() and torch.is_tensor(x) and x.requires_grad:
        raise RuntimeError(
            "quantize.int8_mmul is inference-only (a weight-quantized "
            "SameDiff graph serves; fit or differentiate the f32 graph)")
    return int8_matmul(x, wq, w_scale)


def counters() -> dict:
    """Dispatch decisions (``dot``, ``einsum``, ``conv``) as plain
    integers."""
    with _lock:
        return dict(_DISPATCH)


def rewrite_counters() -> dict:
    """The SameDiff rewrite's decisions (``matched``,
    ``skipped_<reason>``)."""
    with _lock:
        return dict(_REWRITE)


def pad_counters() -> dict:
    """Contractions zero-padded to ``torch._int_mm``'s CUDA shape rules, by
    the axis padded (``rows``, ``k``, ``n``)."""
    with _lock:
        return dict(_PAD)


def reset_counters() -> None:
    with _lock:
        _DISPATCH.clear()
        _REWRITE.clear()
        _PAD.clear()
