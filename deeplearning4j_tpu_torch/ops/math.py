"""Elementwise / pairwise / shape / linalg / scatter / sort catalog ops.

Port of ``deeplearning4j_tpu/ops/math.py``: thin named registrations over
torch. Each op takes the keyword names of the jnp/lax function the JAX
package registers under the same name (``shape.gather`` is
``jnp.take(a, indices, axis=)``, ``shape.reshape`` is
``jnp.reshape(a, shape)``, ``shape.transpose`` is
``jnp.transpose(a, axes)``), because a recorded ``graph.json`` stores
attributes under those names. Semantics follow jnp where torch differs:
true division of integers, ``jnp.take``'s wrap of negative indices and
fill of out-of-range ones, population (not sample) variance, int32 index
outputs, ``jnp.split`` sections, negative slice steps.

``linalg.mmul`` and the other contractions run under the caller's
precision policy (``environment.precision``): SameDiff.output applies it
around the whole graph. They promote their operands to one dtype as jnp
does, and bools contract to bool.

Integer and bool inputs follow jnp's promotions: ``linalg.norm``,
``det``, ``inverse``, ``solve`` and ``cholesky`` (which factors the
symmetric part, as jnp does) compute in float32; ``linalg.trace`` of
bools and narrow integers is int32; ``math.pow`` and ``math.fmod`` take
bools as int32 (``fmod`` of integers by zero is 0; of two bools by zero,
XLA's dividend); ``scatter.segment_max``/``segment_min`` of bools are
any/all; ``sort.top_k`` and ``sort.in_top_k`` order ties as
``lax.top_k`` does (the lower index first) and take bools.

Recorded divergences, the other way: where jnp raises TypeError on an
integer or bool input, these ops accept it. ``math.rsqrt`` and
``act.sigmoid`` (int32 and bool), and ``act.softmax``,
``act.logsoftmax``, ``act.softmax_onnx_legacy`` and ``act.rationaltanh``
(bool) promote it to float32, as the activations promote integer and
bool inputs as a class; ``math.sign`` of bools returns
them; ``scatter.add``, ``scatter.segment_sum`` and
``scatter.segment_mean`` take bool data (any, and a float32 mean);
``nnops.lstm_cell`` takes int32 operands. None of them is reached from a
float graph.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from . import register
from .. import dtypes as _dt


def _t(x, like: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A tensor for ``x`` (python numbers as 0-dim tensors on ``like``'s
    device)."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(x, device=None if like is None else like.device)


def _dims(axis, ndim: int):
    """jnp's ``axis`` (None, int, sequence) as a tuple of non-negative
    dims (None: every dim)."""
    if axis is None:
        return tuple(range(ndim))
    if isinstance(axis, (list, tuple)):
        return tuple(int(a) % ndim if ndim else 0 for a in axis)
    return (int(axis) % ndim if ndim else 0,)


def _float(x: torch.Tensor) -> torch.Tensor:
    """jnp promotes integer and bool inputs of a float-valued function to
    float32 (the package runs without x64)."""
    return x if x.is_floating_point() or x.is_complex() else x.float()


# -- pairwise arithmetic (broadcasting) ---------------------------------------
register("math.add", category="pairwise")(torch.add)
register("math.sub", category="pairwise")(torch.sub)
register("math.mul", category="pairwise")(torch.mul)


@register("math.div", category="pairwise")
def div(x, y):
    """True division (``jnp.divide``): integers divide to float32."""
    return torch.true_divide(x, y)


def _int_operands(x, y):
    """Integer or bool operands in their common integer dtype (two bools
    become int32, as jnp promotes them), a zero mask of the divisor, and
    the divisor with its zeros replaced by 1: torch's integer division by
    zero raises on the CPU and is undefined on a CUDA tensor."""
    dt = torch.result_type(x, y)
    if dt == torch.bool:
        dt = torch.int32
    x, y = x.to(dt), y.to(dt)
    zero = y == 0
    return x, zero, torch.where(zero, torch.ones_like(y), y)


@register("math.floordiv", category="pairwise")
def floordiv(x, y):
    """``jnp.floor_divide``: integers floor-divide as torch does, and by
    zero give XLA's defined value (-1 for a zero dividend, -2 for any
    other signed one, all ones for an unsigned type); floats take jnp's
    divmod, ``round((x - fmod(x, y)) / y)`` less 1 where the remainder's
    sign differs from y's, so a division by zero (or of an infinity)
    gives NaN where torch's ``floor(x / y)`` gives +-inf."""
    x = _t(x, y if isinstance(y, torch.Tensor) else None)
    y = _t(y, x)
    if not (x.is_floating_point() or y.is_floating_point()):
        x, zero, safe = _int_operands(x, y)
        q = torch.floor_divide(x, safe)
        info = torch.iinfo(x.dtype)
        if info.min == 0:
            by_zero = torch.full_like(q, info.max)
        else:  # -1 - (x != 0): -1 for 0, -2 otherwise, in x's dtype
            by_zero = -1 - (x != 0).to(x.dtype)
        return torch.where(zero, by_zero, q)
    mod = torch.fmod(x, y)
    div = (x - mod) / y
    fix = (mod != 0) & (torch.sign(y) != torch.sign(mod))
    div = torch.where(fix, div - 1, div)
    # lax.round rounds halves away from zero; torch.round to even
    trunc = torch.trunc(div)
    return torch.where((div - trunc).abs() == 0.5, trunc + torch.sign(div),
                       torch.round(div))


@register("math.mod", category="pairwise")
def mod(x, y):
    """Python-style modulo (the sign of the divisor), as ``jnp.mod``;
    integers and bools modulo zero give 0 (the remainder by the safe
    divisor 1), as jnp does."""
    x = _t(x, y if isinstance(y, torch.Tensor) else None)
    y = _t(y, x)
    if not (x.is_floating_point() or y.is_floating_point()):
        x, _, safe = _int_operands(x, y)
        return torch.remainder(x, safe)
    return torch.remainder(x, y)


@register("math.pow", category="pairwise")
def pow_(x, y):
    """``jnp.power``: a bool operand counts as int32 (two bools give int32;
    torch has no bool power)."""
    x = _int32(x) if isinstance(x, torch.Tensor) else x
    y = _int32(y) if isinstance(y, torch.Tensor) else y
    return torch.pow(x, y)
register("math.maximum", category="pairwise")(torch.maximum)
register("math.minimum", category="pairwise")(torch.minimum)


@register("math.atan2", category="pairwise")
def atan2(x1, x2):
    return torch.atan2(_float(x1), _float(x2))


@register("math.rsub", category="pairwise")
def rsub(a, b):
    """DL4J rsub: b - a (reversed operand order)."""
    return b - a


@register("math.rdiv", category="pairwise")
def rdiv(a, b):
    """DL4J rdiv: b / a (reversed operand order)."""
    return b / a


@register("math.squared_difference", category="pairwise")
def squared_difference(a, b):
    d = a - b
    return d * d


@register("math.fmod", category="pairwise")
def fmod(a, b):
    """``jnp.fmod`` (the sign of the dividend); integers by zero give 0, as
    jnp does (the remainder by the safe divisor 1), where torch raises.
    Two bools are not integers to jnp: they skip that replacement, and
    XLA's remainder by zero is the dividend (in int32)."""
    a = _t(a, b if isinstance(b, torch.Tensor) else None)
    b = _t(b, a)
    if not (a.is_floating_point() or b.is_floating_point()):
        bools = a.dtype == torch.bool and b.dtype == torch.bool
        a, zero, safe = _int_operands(a, b)
        r = torch.fmod(a, safe)
        return torch.where(zero, a, r) if bools else r
    return torch.fmod(a, b)


# -- elementwise transforms ---------------------------------------------------
def _int32(x: torch.Tensor) -> torch.Tensor:
    """A bool tensor as int32: jnp's arithmetic on bools gives int32 where
    torch's gives int64 (or refuses)."""
    return x.to(torch.int32) if x.dtype == torch.bool else x


def _bool_kept(fn):
    """``fn`` for numbers, the identity for bools (``jnp.abs``,
    ``jnp.floor`` and ``jnp.ceil`` return a bool input as it is)."""
    return lambda x: x if x.dtype == torch.bool else fn(x)


def _sign(x):
    """``jnp.sign``: NaN stays NaN and -0.0 stays -0.0 (``torch.sign``
    gives 0 and +0.0)."""
    if not x.is_floating_point():
        return torch.sign(x)
    return torch.where(torch.isnan(x) | (x == 0), x, torch.sign(x))


def _unary(name, fn, differentiable=True, promote=True):
    def op(x):
        return fn(_float(x) if promote else x)
    op.__name__ = name.split(".")[-1]
    register(name, category="transform", differentiable=differentiable)(op)
    return op


neg = _unary("math.neg", torch.neg, promote=False)
abs_ = _unary("math.abs", _bool_kept(torch.abs), promote=False)
sqrt = _unary("math.sqrt", torch.sqrt)
square = _unary("math.square", lambda x: torch.square(_int32(x)),
                promote=False)
exp = _unary("math.exp", torch.exp)
expm1 = _unary("math.expm1", torch.expm1)
log = _unary("math.log", torch.log)
log1p = _unary("math.log1p", torch.log1p)
log2 = _unary("math.log2", torch.log2)
sin = _unary("math.sin", torch.sin)
cos = _unary("math.cos", torch.cos)
tan = _unary("math.tan", torch.tan)
asin = _unary("math.asin", torch.asin)
acos = _unary("math.acos", torch.acos)
atan = _unary("math.atan", torch.atan)
sinh = _unary("math.sinh", torch.sinh)
cosh = _unary("math.cosh", torch.cosh)
floor = _unary("math.floor", _bool_kept(torch.floor), False,
               promote=False)
ceil = _unary("math.ceil", _bool_kept(torch.ceil), False,
              promote=False)
round_ = _unary("math.round", torch.round, False, promote=False)
sign = _unary("math.sign", _sign, False, promote=False)
reciprocal = _unary("math.reciprocal", torch.reciprocal)
rsqrt = _unary("math.rsqrt", torch.rsqrt)
erf = _unary("math.erf", torch.erf)
erfc = _unary("math.erfc", torch.erfc)


@register("math.clip", category="transform")
def clip(a, min_value, max_value):
    """DL4J clipbyvalue."""
    return torch.clamp(a, min_value, max_value)


@register("math.clip_by_norm", category="transform")
def clip_by_norm(a, clip_norm, axis=None):
    sq = a * a
    norm = torch.sqrt(sq.sum() if axis is None
                      else sq.sum(dim=_dims(axis, a.dim()), keepdim=True))
    scale = torch.clamp(clip_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return a * scale


# -- comparisons / logic (non-differentiable) ---------------------------------
for _name, _fn in (("equal", torch.eq), ("not_equal", torch.ne),
                   ("greater", torch.gt), ("greater_equal", torch.ge),
                   ("less", torch.lt), ("less_equal", torch.le),
                   ("logical_and", torch.logical_and),
                   ("logical_or", torch.logical_or),
                   ("logical_not", torch.logical_not),
                   ("logical_xor", torch.logical_xor),
                   ("isnan", torch.isnan), ("isinf", torch.isinf)):
    register(f"math.{_name}", category="compare", differentiable=False)(_fn)


@register("math.where", category="compare")
def where(condition, x, y):
    return torch.where(condition.bool(), x, y)


# -- blas / linalg ------------------------------------------------------------
def _contract(fn, *operands):
    """``fn`` (a matmul, tensordot or einsum) over operands promoted to one
    dtype as jnp promotes them; bools contract to bool (any nonzero
    product, summed exactly in float32)."""
    dt = operands[0].dtype
    for t in operands[1:]:
        dt = torch.promote_types(dt, t.dtype)
    if dt == torch.bool:
        return fn(*(t.float() for t in operands)) != 0
    return fn(*(t.to(dt) for t in operands))


@register("linalg.mmul", category="blas")
def mmul(a, b, transpose_a=False, transpose_b=False):
    """DL4J mmul (gemm), batched over leading dims as ``jnp.matmul``."""
    if transpose_a:
        a = a.transpose(-1, -2)
    if transpose_b:
        b = b.transpose(-1, -2)
    return _contract(torch.matmul, a, b)


@register("linalg.tensordot", category="blas")
def tensordot(a, b, axes=2):
    if isinstance(axes, (list, tuple)):
        axes = [list(x) if isinstance(x, (list, tuple)) else [x]
                for x in axes]
    return _contract(lambda x, y: torch.tensordot(x, y, dims=axes), a, b)


@register("linalg.einsum", category="blas")
def einsum(*operands, equation):
    return _contract(lambda *ts: torch.einsum(equation, *ts), *operands)


register("linalg.outer", category="blas")(torch.outer)
register("linalg.diag", category="linalg")(torch.diag)


@register("linalg.diag_part", category="linalg")
def diag_part(a, offset=0, axis1=0, axis2=1):
    return torch.diagonal(a, offset=offset, dim1=axis1, dim2=axis2)


@register("linalg.trace", category="linalg")
def trace(a, offset=0, axis1=0, axis2=1):
    """``jnp.trace``: bool and narrow integer traces sum in int32 (torch's
    sum widens them to int64)."""
    out = torch.diagonal(a, offset=offset, dim1=axis1, dim2=axis2).sum(-1)
    if a.dtype in (torch.bool, torch.int8, torch.int16, torch.int32):
        return out.to(torch.int32)
    return out


@register("linalg.inverse", category="linalg")
def inverse(a):
    """``jnp.linalg.inv``: a singular matrix gives the infinities and NaNs
    of its LU solve, where ``torch.linalg.inv`` raises."""
    return torch.linalg.inv_ex(_float(a)).inverse


@register("linalg.cholesky", category="linalg")
def cholesky(a):
    """``jnp.linalg.cholesky``, which factors the symmetric part ``(a +
    a^T) / 2`` (torch reads the lower triangle alone). A matrix that is
    not positive definite gives NaN in its lower triangle and zeros above
    it, as there, where ``torch.linalg.cholesky`` raises."""
    a = _float(a)
    low, info = torch.linalg.cholesky_ex((a + a.mT) / 2)
    bad = (info != 0)[..., None, None]
    nan_low = torch.full_like(low, float("nan")).tril()
    return torch.where(bad, nan_low, low)


@register("linalg.solve", category="linalg")
def solve(a, b):
    """``jnp.linalg.solve``: a singular system gives NaN, where
    ``torch.linalg.solve`` raises."""
    return torch.linalg.solve_ex(_float(a), _float(b)).result


@register("linalg.det", category="linalg")
def det(a):
    return torch.linalg.det(_float(a))


@register("linalg.norm", category="linalg")
def norm(x, ord=None, axis=None, keepdims=False):
    if isinstance(axis, list):
        axis = tuple(axis)
    return torch.linalg.norm(_float(x), ord=ord, dim=axis, keepdim=keepdims)


# -- shape / structural -------------------------------------------------------
@register("shape.reshape", category="shape")
def reshape(a, shape):
    return torch.reshape(a, tuple(int(s) for s in shape))


@register("shape.reshape_onnx", category="shape")
def reshape_onnx(x, shape, allowzero=0):
    """ONNX Reshape: a 0 entry copies the input dim at that position
    (unless ``allowzero``), -1 infers as usual."""
    shape = [int(s) for s in shape]
    if not allowzero:
        shape = [x.shape[i] if s == 0 else s for i, s in enumerate(shape)]
    return torch.reshape(x, shape)


@register("shape.transpose", category="shape")
def transpose(a, axes=None):
    if axes is None:
        return a.permute(*reversed(range(a.dim())))
    return a.permute(*[int(x) for x in axes])


register("shape.permute", category="shape")(transpose)  # DL4J name


@register("shape.squeeze", category="shape")
def squeeze(a, axis=None):
    if axis is None:
        return torch.squeeze(a)
    return torch.squeeze(a, dim=_dims(axis, a.dim()))


@register("shape.expand_dims", category="shape")
def expand_dims(a, axis):
    axes = axis if isinstance(axis, (list, tuple)) else (axis,)
    out_nd = a.dim() + len(axes)
    new = sorted(int(x) % out_nd for x in axes)
    shape, src = [], iter(a.shape)
    for i in range(out_nd):
        shape.append(1 if i in new else next(src))
    return a.reshape(shape)


@register("shape.concat", category="shape")
def concat(arrays, axis=0):
    return torch.cat(list(arrays), dim=axis)


@register("shape.stack", category="shape")
def stack(arrays, axis=0):
    return torch.stack(list(arrays), dim=axis)


@register("shape.concat_v", category="shape")
def concat_v(*arrays, axis=0):
    """Variadic concat: inputs as separate positional args (the graph
    calling convention)."""
    return torch.cat(arrays, dim=axis)


@register("shape.stack_v", category="shape")
def stack_v(*arrays, axis=0):
    return torch.stack(arrays, dim=axis)


@register("shape.flatten2d", category="shape")
def flatten2d(x):
    """[B, ...] -> [B, prod(...)]."""
    return x.reshape(x.shape[0], -1)


@register("shape.split", category="shape")
def split(ary, indices_or_sections, axis=0):
    """``jnp.split``: an int splits into that many equal parts (raises if
    they are not equal), a sequence at those indices."""
    n = ary.shape[axis]
    if isinstance(indices_or_sections, int) and n % indices_or_sections:
        raise ValueError(f"array split does not result in an equal "
                         f"division: {n} into {indices_or_sections}")
    return tuple(torch.tensor_split(
        ary, indices_or_sections if isinstance(indices_or_sections, int)
        else [int(i) for i in indices_or_sections], dim=axis))


@register("shape.unstack", category="shape")
def unstack(x, axis=0):
    return tuple(torch.unbind(x, dim=axis))


@register("shape.tile", category="shape")
def tile(A, reps):
    return torch.tile(A, tuple(reps) if isinstance(reps, (list, tuple))
                      else (reps,))


@register("shape.repeat", category="shape")
def repeat(a, repeats, axis=None):
    return torch.repeat_interleave(a, repeats, dim=axis)


@register("shape.flip", category="shape")
def flip(m, axis=None):
    return torch.flip(m, dims=_dims(axis, m.dim()))


@register("shape.roll", category="shape")
def roll(a, shift, axis=None):
    if axis is None:
        return torch.roll(a, shifts=shift)
    shift = tuple(shift) if isinstance(shift, (list, tuple)) else shift
    axis = tuple(axis) if isinstance(axis, (list, tuple)) else axis
    return torch.roll(a, shifts=shift, dims=axis)


@register("shape.pad", category="shape")
def pad(array, pad_width, mode="constant", constant_values=0):
    """``jnp.pad`` in its constant mode: ``pad_width`` an int, a pair, or
    one pair per axis."""
    if mode != "constant":
        raise NotImplementedError(f"shape.pad mode {mode!r}: the port has "
                                  "the constant mode only; the others come "
                                  "with the SameDiff-import slice of the "
                                  "port (ROADMAP.md Queue 1 item 4)")
    nd = array.dim()
    pw = pad_width
    if isinstance(pw, int):
        pairs = [(pw, pw)] * nd
    elif len(pw) and isinstance(pw[0], int):
        pairs = [tuple(pw)] * nd if len(pw) == 2 else [(pw[0], pw[0])] * nd
    else:
        pairs = [tuple(p) for p in pw]
        if len(pairs) == 1:
            pairs = pairs * nd
    flat = []
    for before, after in reversed(pairs):
        flat += [int(before), int(after)]
    return F.pad(array, flat, value=float(constant_values))


@register("shape.broadcast_to", category="shape")
def broadcast_to(array, shape):
    return torch.broadcast_to(_t(array), tuple(int(s) for s in shape))


def _fill_value(dtype: torch.dtype):
    """``jnp.take``'s fill for an out-of-range index: NaN for floats, the
    most negative value for signed integers, the largest for unsigned,
    True for bool."""
    if dtype.is_floating_point or dtype.is_complex:
        return float("nan")
    if dtype == torch.bool:
        return True
    info = torch.iinfo(dtype)
    return info.max if info.min == 0 else info.min


def _wrap_index(idx: torch.Tensor, n: int):
    """(in-range index, valid mask) of ``jnp.take``'s index rule: a
    negative index counts from the end; one outside ``[-n, n)`` is
    invalid. Int32 indices stay int32."""
    idx = torch.where(idx < 0, idx + n, idx)
    valid = (idx >= 0) & (idx < n)
    return idx.clamp(0, max(n - 1, 0)), valid


@register("shape.gather", category="shape")
def gather(a, indices, axis=None, mode=None, fill_value=None):
    """``jnp.take(a, indices, axis)``: out-of-range indices give the
    fill value (``mode="clip"`` clamps instead)."""
    indices = _t(indices, a)
    if axis is None:
        a, axis = a.reshape(-1), 0
    axis = int(axis) % a.dim()
    n = a.shape[axis]
    idx, valid = _wrap_index(indices, n)
    if mode == "clip":
        idx = indices.clamp(0, n - 1)
    out = torch.index_select(a, axis, idx.reshape(-1)).reshape(
        a.shape[:axis] + indices.shape + a.shape[axis + 1:])
    if mode == "clip":
        return out
    fill = _fill_value(a.dtype) if fill_value is None else fill_value
    mask = valid.reshape((1,) * axis + tuple(indices.shape)
                         + (1,) * (a.dim() - axis - 1))
    return torch.where(mask, out, torch.as_tensor(fill, dtype=a.dtype,
                                                  device=a.device))


@register("shape.take_along_axis", category="shape")
def take_along_axis(arr, indices, axis):
    axis = int(axis) % arr.dim()
    idx, valid = _wrap_index(indices, arr.shape[axis])
    out = torch.take_along_dim(arr, idx.long(), dim=axis)
    return torch.where(valid, out, torch.as_tensor(
        _fill_value(arr.dtype), dtype=arr.dtype, device=arr.device))


@register("shape.tril", category="shape")
def tril(m, k=0):
    return torch.tril(m, diagonal=k)


@register("shape.triu", category="shape")
def triu(m, k=0):
    return torch.triu(m, diagonal=k)


def _apply_index(a: torch.Tensor, idx: Sequence):
    """numpy basic indexing (slices, ints, None, Ellipsis) on a tensor;
    a slice with a negative step is taken with ``index_select``."""
    if not any(isinstance(i, slice) and i.step is not None and i.step < 0
               for i in idx):
        return a[tuple(idx)]
    # expand the ellipsis, then walk the dims one by one
    n_real = sum(1 for i in idx if i is not None and i is not Ellipsis)
    out_idx = []
    for i in idx:
        if i is Ellipsis:
            out_idx += [slice(None)] * (a.dim() - n_real)
        else:
            out_idx.append(i)
    out_idx += [slice(None)] * (a.dim() - sum(
        1 for i in out_idx if i is not None))
    dim = 0
    for i in out_idx:
        if i is None:
            a = a.unsqueeze(dim)
            dim += 1
        elif isinstance(i, int):
            a = a.select(dim, i)
        else:
            rng = range(*i.indices(a.shape[dim]))
            a = torch.index_select(a, dim, torch.tensor(
                list(rng), dtype=torch.long, device=a.device))
            dim += 1
    return a


@register("shape.strided_slice", category="shape", differentiable=False)
def strided_slice(a, begin, end, strides=None):
    idx = [slice(b, e, s) for b, e, s in
           zip(begin, end, strides or [1] * len(begin))]
    return _apply_index(a, idx)


@register("shape.strided_slice_v2", category="shape")
def strided_slice_v2(a, spec):
    """numpy-style indexing from a serializable per-dim spec::

        ["slice", begin|None, end|None, stride]   # a[b:e:s]
        ["index", i]                              # a[i] (shrink axis)
        ["newaxis"]                               # a[None]
        ["ellipsis"]                              # a[...]
    """
    idx = []
    for ent in spec:
        kind = ent[0]
        if kind == "slice":
            idx.append(slice(ent[1], ent[2], ent[3]))
        elif kind == "index":
            idx.append(int(ent[1]))
        elif kind == "newaxis":
            idx.append(None)
        elif kind == "ellipsis":
            idx.append(Ellipsis)
        else:
            raise ValueError(f"bad strided-slice spec entry {ent!r}")
    return _apply_index(a, idx)


@register("math.cast", category="math")
def cast(a, dtype="float32"):
    """Explicit dtype conversion; ``dtype`` is the string the graph
    records (``"float32"``, ``"int32"``, ``"bfloat16"``, ...). A float
    cast to an integer type saturates as XLA's convert does: NaN to 0,
    values beyond the type's range (infinities included) to its ends;
    torch's ``.to`` leaves those undefined."""
    a, dt = _t(a), _dt.resolve(dtype)
    if not a.is_floating_point() or dt.is_floating_point \
            or dt.is_complex or dt == torch.bool:
        return a.to(dt)
    info = torch.iinfo(dt)
    x = torch.nan_to_num(a.double(), nan=0.0)
    lo, hi = float(info.min), float(info.max)
    return torch.where(x >= hi, info.max, torch.where(
        x <= lo, info.min, x.clamp(lo, hi).to(dt))).to(dt)


@register("shape.shape_of", category="shape", differentiable=False)
def shape_of(a):
    """TF Shape: the shape as an int32 vector."""
    return torch.tensor(list(a.shape), dtype=torch.int32, device=a.device)


@register("shape.one_hot", category="shape", differentiable=False)
def one_hot(indices, depth, dtype="float32"):
    """``jax.nn.one_hot``: an index outside ``[0, depth)`` gives a zero
    row."""
    ar = torch.arange(int(depth), device=indices.device)
    return (indices.long().unsqueeze(-1) == ar).to(_dt.resolve(dtype))


# -- sort / search / scatter --------------------------------------------------
@register("sort.sort", category="sort")
def sort(a, axis=-1):
    if axis is None:
        return torch.sort(a.reshape(-1)).values
    return torch.sort(a, dim=axis, stable=True).values


@register("sort.argsort", category="sort", differentiable=False)
def argsort(a, axis=-1):
    if axis is None:
        a, axis = a.reshape(-1), 0
    return torch.argsort(a, dim=axis, stable=True).to(torch.int32)


def _top_k(a, k: int):
    """The k largest along the last axis in ``lax.top_k``'s order: a stable
    descending sort, so equal values keep the lower index first
    (``torch.topk`` orders ties arbitrarily and refuses bools on the CPU)."""
    v, i = torch.sort(a, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


@register("sort.top_k", category="sort", differentiable=False)
def top_k(a, k):
    """values, int32 indices of the k largest along the last axis."""
    v, i = _top_k(a, int(k))
    return v, i.to(torch.int32)


@register("sort.in_top_k", category="sort", differentiable=False)
def in_top_k(predictions, targets, k):
    _, idx = _top_k(predictions, int(k))
    return (idx == targets.long().unsqueeze(-1)).any(dim=-1)


def _rows(indices, n: int):
    idx = indices.long()
    return torch.where(idx < 0, idx + n, idx)


@register("scatter.update", category="scatter")
def scatter_update(a, indices, updates):
    out = a.clone()
    out[_rows(indices, a.shape[0])] = updates.to(a.dtype)
    return out


@register("scatter.add", category="scatter")
def scatter_add(a, indices, updates):
    return a.index_put((_rows(indices, a.shape[0]),), updates.to(a.dtype),
                       accumulate=True)


@register("scatter.mul", category="scatter")
def scatter_mul(a, indices, updates):
    return a.index_reduce(0, _rows(indices, a.shape[0]).reshape(-1),
                          updates.to(a.dtype).reshape(-1, *a.shape[1:]),
                          "prod")


@register("scatter.max", category="scatter")
def scatter_max(a, indices, updates):
    return a.index_reduce(0, _rows(indices, a.shape[0]).reshape(-1),
                          updates.to(a.dtype).reshape(-1, *a.shape[1:]),
                          "amax")


def _segment(data, segment_ids, num_segments, reduce: str):
    """jax.ops.segment_*: ids outside ``[0, num_segments)`` are dropped;
    an empty segment holds the reduction's identity."""
    ids = segment_ids.long()
    keep = (ids >= 0) & (ids < num_segments)
    ids, data = ids[keep], data[keep]
    shape = (int(num_segments),) + tuple(data.shape[1:])
    if reduce == "sum":
        return torch.zeros(shape, dtype=data.dtype,
                           device=data.device).index_add_(0, ids, data)
    if data.dtype == torch.bool and reduce in ("amax", "amin"):
        # bool max / min are any / all; an empty segment is the identity
        return _segment(data.to(torch.uint8), ids, num_segments,
                        reduce).bool()
    if data.is_floating_point():
        init = {"amax": float("-inf"), "amin": float("inf"),
                "prod": 1.0}[reduce]
    else:
        info = torch.iinfo(data.dtype)
        init = {"amax": info.min, "amin": info.max, "prod": 1}[reduce]
    out = torch.full(shape, init, dtype=data.dtype, device=data.device)
    return out.index_reduce_(0, ids, data, reduce, include_self=True)


@register("scatter.segment_sum", category="scatter")
def segment_sum(data, segment_ids, num_segments):
    return _segment(data, segment_ids, num_segments, "sum")


@register("scatter.segment_mean", category="scatter")
def segment_mean(data, segment_ids, num_segments):
    s = _segment(data, segment_ids, num_segments, "sum")
    n = _segment(torch.ones(data.shape[:1], dtype=data.dtype,
                            device=data.device), segment_ids,
                 num_segments, "sum")
    return s / torch.clamp(n, min=1).reshape((-1,) + (1,) * (data.dim() - 1))


@register("scatter.segment_max", category="scatter")
def segment_max(data, segment_ids, num_segments):
    return _segment(data, segment_ids, num_segments, "amax")


@register("scatter.segment_min", category="scatter")
def segment_min(data, segment_ids, num_segments):
    return _segment(data, segment_ids, num_segments, "amin")


@register("scatter.segment_prod", category="scatter")
def segment_prod(data, segment_ids, num_segments):
    return _segment(data, segment_ids, num_segments, "prod")


@register("math.cumprod", category="reduce")
def cumprod(a, axis=None):
    """``jnp.cumprod``: int32 and bool inputs multiply in int32 (torch
    widens them to int64)."""
    if axis is None:
        a, axis = a.reshape(-1), 0
    keep = not a.is_floating_point() and a.dtype != torch.int64
    return torch.cumprod(a, dim=axis, dtype=torch.int32 if keep else None)
