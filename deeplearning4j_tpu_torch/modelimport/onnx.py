"""ONNX model import into a SameDiff graph.

Port of ``deeplearning4j_tpu/modelimport/onnx.py``: a per-op-type
registry (``onnx_op``) maps each node into catalog ops recorded on the
port's :class:`~deeplearning4j_tpu_torch.autodiff.samediff.SameDiff`, by
the JAX package's op names and attributes. A handler is chosen by the
model's declared ``ai.onnx`` opset (the largest ``since`` version not
above it; opset 13 when the model declares none). Initializers become
VARIABLEs (fine-tunable), graph inputs placeholders; ``sd.onnx_inputs``
and ``sd.onnx_outputs`` keep the graph's declared input and output
names. Unsupported op types raise with the name.

The model is read by the port's own wire reader (``proto/wire.py``, the
schema of the JAX package's ``proto/onnx_min.proto``), never by the
protobuf runtime; a protobuf object is read through its
``SerializeToString()``. Its tensors follow the JAX importer's rule
(``wire.onnx_to_array``). The entry points take ``device`` (``cuda``
unless the caller asks for ``cpu``).
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from ..autodiff.samediff import SameDiff, SDVariable
from .proto import wire

_DTYPES = wire.ONNX_DTYPES
_tensor_to_np = wire.onnx_to_array


def _attrs(node) -> Dict[str, object]:
    out = {}
    for a in node.attribute:
        if a.type == 1:      # FLOAT
            out[a.name] = float(a.f)
        elif a.type == 2:    # INT
            out[a.name] = int(a.i)
        elif a.type == 3:    # STRING
            out[a.name] = a.s.decode()
        elif a.type == 4:    # TENSOR
            out[a.name] = _tensor_to_np(a.t)
        elif a.type == 6:    # FLOATS
            out[a.name] = [float(v) for v in a.floats]
        elif a.type == 7:    # INTS
            out[a.name] = [int(v) for v in a.ints]
        else:
            out[a.name] = None
    return out


class _Ctx:
    def __init__(self, sd: SameDiff):
        self.sd = sd
        self.vars: Dict[str, SDVariable] = {}
        self.consts: Dict[str, np.ndarray] = {}
        self.opset = 1

    def get(self, name: str) -> SDVariable:
        if name not in self.vars:
            raise ValueError(f"reference to unknown tensor {name!r}")
        return self.vars[name]


#: op_type -> [(since_version, handler)] sorted newest-first: the handler
#: with the largest since_version <= the model's declared ai.onnx opset
#: wins (the JAX importer's ``_select_handler``).
_M: Dict[str, list] = {}


def onnx_op(*types, since: int = 1):
    def deco(fn):
        for t in types:
            _M.setdefault(t, []).append((since, fn))
            _M[t].sort(key=lambda p: -p[0])
        return fn
    return deco


def _select_handler(op_type: str, opset: int):
    for since, fn in _M[op_type]:
        if since <= opset:
            return fn
    raise ValueError(
        f"ONNX op {op_type!r}: no handler for opset {opset} (handlers start "
        f"at opset {_M[op_type][-1][0]})")


_UNARY = {"Relu": "act.relu", "Sigmoid": "act.sigmoid", "Tanh": "act.tanh",
          "Softplus": "act.softplus", "Softsign": "act.softsign",
          "Elu": "act.elu", "Selu": "act.selu", "Exp": "math.exp",
          "Log": "math.log", "Sqrt": "math.sqrt", "Abs": "math.abs",
          "Neg": "math.neg", "Floor": "math.floor", "Ceil": "math.ceil",
          "Round": "math.round", "Erf": "math.erf", "Sin": "math.sin",
          "Cos": "math.cos", "Identity": "act.identity",
          "Reciprocal": "math.reciprocal", "Sign": "math.sign"}
_BINARY = {"Add": "math.add", "Sub": "math.sub", "Mul": "math.mul",
           "Div": "math.div", "Pow": "math.pow", "Max": "math.maximum",
           "Min": "math.minimum", "Greater": "math.greater",
           "Less": "math.less", "Equal": "math.equal"}


@onnx_op("Gemm")
def _gemm(node, ctx, at):
    a, b = ctx.get(node.input[0]), ctx.get(node.input[1])
    alpha, beta = at.get("alpha", 1.0), at.get("beta", 1.0)
    y = ctx.sd.call("linalg.mmul", a, b,
                    attrs={"transpose_a": bool(at.get("transA", 0)),
                           "transpose_b": bool(at.get("transB", 0))})
    if alpha != 1.0:
        y = ctx.sd.call("math.mul", y, ctx.sd._lift(np.float32(alpha)))
    if len(node.input) > 2:
        c = ctx.get(node.input[2])
        if beta != 1.0:
            c = ctx.sd.call("math.mul", c, ctx.sd._lift(np.float32(beta)))
        y = ctx.sd.call("math.add", y, c, name=node.output[0])
    else:
        y = ctx.sd.call("act.identity", y, name=node.output[0])
    return y


@onnx_op("MatMul")
def _matmul(node, ctx, at):
    return ctx.sd.call("linalg.mmul", ctx.get(node.input[0]),
                       ctx.get(node.input[1]), name=node.output[0])


@onnx_op("Conv")
def _conv(node, ctx, at):
    # ONNX is NCHW with kernel OIHW == our storage layout directly
    kernel_shape = at.get("kernel_shape")
    strides = at.get("strides", [1, 1])
    dil = at.get("dilations", [1, 1])
    pads = at.get("pads", [0, 0, 0, 0])
    auto = at.get("auto_pad", "NOTSET")
    groups = int(at.get("group", 1))
    if auto in ("SAME_UPPER", "SAME_LOWER"):
        mode, pad = "same", (0, 0)
    else:
        if len(pads) == 4 and (pads[0] != pads[2] or pads[1] != pads[3]):
            raise ValueError("asymmetric Conv pads not supported")
        mode, pad = "truncate", (int(pads[0]), int(pads[1]))
    args = [ctx.get(node.input[0]), ctx.get(node.input[1])]
    if len(node.input) > 2:
        args.append(ctx.get(node.input[2]))
    # ONNX grouped weight layout [M, C/g, kH, kW] == our conv2d contract
    # (depthwise/MobileNet and ResNeXt exports)
    return ctx.sd.call("conv2d", *args, name=node.output[0],
                       attrs={"stride": tuple(int(s) for s in strides),
                              "padding": pad, "mode": mode,
                              "dilation": tuple(int(d) for d in dil),
                              "data_format": "NCHW", "groups": groups})


@onnx_op("MaxPool", "AveragePool")
def _pool(node, ctx, at):
    op = "maxpool2d" if node.op_type == "MaxPool" else "avgpool2d"
    pads = at.get("pads", [0, 0, 0, 0])
    auto = at.get("auto_pad", "NOTSET")
    if auto in ("SAME_UPPER", "SAME_LOWER"):
        mode, pad = "same", (0, 0)
    else:
        if len(pads) == 4 and (pads[0] != pads[2] or pads[1] != pads[3]):
            raise ValueError(f"asymmetric {node.op_type} pads {pads} not "
                             "supported (end-side padding would be dropped)")
        mode, pad = "truncate", (int(pads[0]), int(pads[1]))
    attrs = {"kernel": tuple(int(k) for k in at["kernel_shape"]),
             "stride": tuple(int(s) for s in at.get("strides", at["kernel_shape"])),
             "padding": pad, "mode": mode,
             "data_format": "NCHW"}
    if op == "avgpool2d":
        # ONNX default count_include_pad=0: padded cells are EXCLUDED from
        # the divisor, unlike DL4J truncate-mode avg pool.
        cip = bool(at.get("count_include_pad", 0))
        if cip and mode == "same":
            raise ValueError(
                "AveragePool auto_pad=SAME with count_include_pad=1 not "
                "supported (our same-mode divisor always excludes padding)")
        attrs["count_include_pad"] = cip
    return ctx.sd.call(op, ctx.get(node.input[0]), name=node.output[0],
                       attrs=attrs)


@onnx_op("LeakyRelu")
def _leaky_onnx(node, ctx, at):
    return ctx.sd.call("act.leakyrelu", ctx.get(node.input[0]),
                       name=node.output[0],
                       attrs={"alpha": float(at.get("alpha", 0.01))})


@onnx_op("PRelu")
def _prelu_onnx(node, ctx, at):
    # slope broadcasts per ONNX; a scalar/1-elem slope == leakyrelu,
    # a [C] slope multiplies the negative part elementwise
    x = ctx.get(node.input[0])
    slope = ctx.get(node.input[1])
    neg = ctx.sd.call("math.minimum", x, ctx.sd._lift(np.float32(0.0)))
    pos = ctx.sd.call("math.maximum", x, ctx.sd._lift(np.float32(0.0)))
    scaled = ctx.sd.call("math.mul", neg, slope)
    return ctx.sd.call("math.add", pos, scaled, name=node.output[0])


def _emit_clip(node, ctx, lo, hi):
    # Absent bounds mean "no bound" (not ±3.4e38, which would clip
    # legitimate float64 values).
    if lo is None and hi is None:
        return ctx.sd.call("act.identity", ctx.get(node.input[0]),
                           name=node.output[0])
    lo = -np.inf if lo is None else lo
    hi = np.inf if hi is None else hi
    return ctx.sd.call("math.clip", ctx.get(node.input[0]),
                       name=node.output[0],
                       attrs={"min_value": lo, "max_value": hi})


@onnx_op("Clip")  # opset 1-10: min/max as attributes
def _clip_onnx_attrs(node, ctx, at):
    if len(node.input) > 1:
        # converter bumped opset_import without rewriting the node (or
        # vice versa) — the bounds live in inputs; honor them
        return _clip_onnx_inputs(node, ctx, at)
    lo = float(at["min"]) if "min" in at else None
    hi = float(at["max"]) if "max" in at else None
    return _emit_clip(node, ctx, lo, hi)


@onnx_op("Clip", since=11)  # opset 11+: min/max as optional inputs
def _clip_onnx_inputs(node, ctx, at):
    # runtime (non-initializer) bounds are unsupported and must raise the
    # named error, not a bare KeyError
    def bound(idx, attr):
        if len(node.input) > idx and node.input[idx]:
            name = node.input[idx]
            if name not in ctx.consts:
                raise ValueError(
                    f"Clip with runtime (non-initializer) {attr} input "
                    f"{name!r} not supported")
            return float(np.asarray(ctx.consts[name]).reshape(()))
        # attribute-form bounds on an opset-11+ node: converter artifact,
        # the intent is unambiguous — honor rather than silently drop
        return float(at[attr]) if attr in at else None
    return _emit_clip(node, ctx, bound(1, "min"), bound(2, "max"))


@onnx_op("ConvTranspose")
def _conv_transpose(node, ctx, at):
    """torchvision FCN/DeepLab-style deconv. ONNX weight layout is IOHW
    ([Cin, Cout/g, kH, kW]) vs our deconv2d's OIHW — permuted in-graph so
    the weight stays a trainable VARIABLE."""
    if at.get("group", 1) != 1:
        raise ValueError("grouped ConvTranspose not supported")
    if any(int(v) for v in at.get("output_padding", [])):
        raise ValueError("ConvTranspose output_padding not supported")
    if at.get("output_shape"):
        # spec derives effective pads from output_shape; defaulting pads
        # to 0 would silently mis-size the deconv
        raise ValueError("ConvTranspose output_shape not supported "
                         "(re-export with explicit pads)")
    if at.get("auto_pad", "NOTSET") not in ("NOTSET", "VALID"):
        raise ValueError("ConvTranspose auto_pad SAME not supported")
    pads = at.get("pads", [0, 0, 0, 0])
    if len(pads) == 4 and (pads[0] != pads[2] or pads[1] != pads[3]):
        raise ValueError("asymmetric ConvTranspose pads not supported")
    w = ctx.sd.call("shape.permute", ctx.get(node.input[1]),
                    attrs={"axes": (1, 0, 2, 3)})
    args = [ctx.get(node.input[0]), w]
    if len(node.input) > 2:
        args.append(ctx.get(node.input[2]))
    return ctx.sd.call(
        "deconv2d", *args, name=node.output[0],
        attrs={"stride": tuple(int(s) for s in at.get("strides", [1, 1])),
               "padding": (int(pads[0]), int(pads[1])),
               "dilation": tuple(int(d) for d in at.get("dilations", [1, 1])),
               "mode": "truncate", "data_format": "NCHW"})


@onnx_op("Resize", since=11)
def _resize_onnx(node, ctx, at):
    """Resize for the cases real exports hit: torch Upsample(nearest) =
    asymmetric+floor with integer scales, and bilinear half_pixel
    (align_corners=False). The resize ops sample half-pixel centers;
    nearest with integer upscale is identical under both grids."""
    mode = at.get("mode", "nearest")
    ctm = at.get("coordinate_transformation_mode", "half_pixel")
    x = ctx.get(node.input[0])
    if mode == "nearest":
        if ctm not in ("asymmetric", "half_pixel"):
            raise ValueError(f"Resize nearest with {ctm!r} not supported")
        method, sized_op = "nearest", "image.resize_nearest"
    elif mode == "linear":
        if ctm not in ("half_pixel", "pytorch_half_pixel"):
            raise ValueError(f"Resize linear with {ctm!r} not supported "
                             "(align_corners differs from half-pixel)")
        method, sized_op = "bilinear", "image.resize_bilinear"
    else:
        raise ValueError(f"Resize mode {mode!r} not supported")
    # opset 11/13 layout: X, roi, scales, sizes (trailing inputs optional)
    if len(node.input) > 3 and node.input[3]:
        nm = node.input[3]
        if nm not in ctx.consts:
            raise ValueError(f"Resize with runtime sizes {nm!r} not supported")
        sz = [int(v) for v in np.asarray(ctx.consts[nm]).ravel()]
        attrs = {"size": (sz[2], sz[3]), "data_format": "NCHW",
                 # batch/channel sizes can't be checked at import (input
                 # shape unknown) — the op asserts them at trace time
                 "expect_leading": (sz[0], sz[1])}
        if mode == "nearest" and ctm == "asymmetric":
            # floor-grid == half-pixel-grid only for integer upscales;
            # shapes are unknown at import, so the op checks at trace time
            attrs["require_integer_upscale"] = True
        return ctx.sd.call(sized_op, x, name=node.output[0], attrs=attrs)
    if len(node.input) > 2 and node.input[2]:
        nm = node.input[2]
        if nm not in ctx.consts:
            raise ValueError(
                f"Resize with runtime scales {nm!r} not supported")
        sc = [float(v) for v in np.asarray(ctx.consts[nm]).ravel()]
        if len(sc) == 4:
            if sc[0] != 1.0 or sc[1] != 1.0:
                raise ValueError("Resize scaling batch/channel dims "
                                 "not supported")
            if mode == "nearest" and ctm == "asymmetric" and (
                    sc[2] != int(sc[2]) or sc[3] != int(sc[3])):
                raise ValueError(
                    "Resize nearest asymmetric supports integer upscales "
                    "only (fractional grids differ from half-pixel "
                    "sampling)")
            return ctx.sd.call("image.resize_scale", x, name=node.output[0],
                               attrs={"scale": (sc[2], sc[3]),
                                      "method": method,
                                      "data_format": "NCHW"})
    raise ValueError("Resize needs constant scales or sizes")


@onnx_op("LayerNormalization", since=17)
def _layer_norm_onnx(node, ctx, at):
    """Opset-17 transformer exports. Single-output form (the training
    mean/invstd outputs are not produced)."""
    axis = int(at.get("axis", -1))
    if axis not in (-1,):
        raise ValueError("LayerNormalization axis != -1 not supported")
    if len(node.output) > 1 and any(node.output[1:]):
        raise ValueError(
            "LayerNormalization mean/invstd outputs not supported")
    x = ctx.get(node.input[0])
    scale = ctx.get(node.input[1])
    if len(node.input) > 2 and node.input[2]:
        bias = ctx.get(node.input[2])
    else:
        bias = ctx.sd._lift(np.float32(0.0))
    return ctx.sd.call("layer_norm", x, scale, bias, name=node.output[0],
                       attrs={"eps": float(at.get("epsilon", 1e-5)),
                              "axis": -1})


@onnx_op("InstanceNormalization")
def _instance_norm_onnx(node, ctx, at):
    """Per-instance per-channel normalization (NCHW); scale/bias stay
    trainable VARIABLEs for fine-tuning."""
    return ctx.sd.call("instance_norm", ctx.get(node.input[0]),
                       ctx.get(node.input[1]), ctx.get(node.input[2]),
                       name=node.output[0],
                       attrs={"eps": float(at.get("epsilon", 1e-5))})


@onnx_op("Gelu", since=20)
def _gelu_onnx(node, ctx, at):
    approx = at.get("approximate", "none")
    return ctx.sd.call("act.gelu", ctx.get(node.input[0]),
                       name=node.output[0],
                       attrs={"approximate": approx == "tanh"})


@onnx_op("GlobalMaxPool")
def _gmp(node, ctx, at):
    return ctx.sd.call("reduce.max", ctx.get(node.input[0]),
                       name=node.output[0],
                       attrs={"axis": (2, 3), "keepdims": True})


@onnx_op("GlobalAveragePool")
def _gap(node, ctx, at):
    return ctx.sd.call("reduce.mean", ctx.get(node.input[0]),
                       name=node.output[0],
                       attrs={"axis": (2, 3), "keepdims": True})


@onnx_op("BatchNormalization")
def _bn(node, ctx, at):
    return ctx.sd.call("batch_norm", ctx.get(node.input[0]),
                       ctx.get(node.input[1]), ctx.get(node.input[2]),
                       ctx.get(node.input[3]), ctx.get(node.input[4]),
                       name=node.output[0],
                       attrs={"eps": float(at.get("epsilon", 1e-5)),
                              "axis": 1})


@onnx_op("Reshape")
def _reshape(node, ctx, at):
    shape = ctx.consts.get(node.input[1]) if len(node.input) > 1 else \
        np.asarray(at.get("shape", []))
    if shape is None:
        raise ValueError("Reshape with dynamic shape input not supported")
    # ONNX semantics: 0 copies the input dim (allowzero=0 default) —
    # resolved at trace time by the catalog's reshape_onnx lowering
    return ctx.sd.call("shape.reshape_onnx", ctx.get(node.input[0]),
                       name=node.output[0],
                       attrs={"shape": [int(s) for s in
                                        np.asarray(shape).tolist()],
                              "allowzero": int(at.get("allowzero", 0))})


@onnx_op("Flatten")
def _flatten(node, ctx, at):
    axis = at.get("axis", 1)
    if axis != 1:
        raise ValueError("Flatten axis != 1 not supported")
    return ctx.sd.call("shape.flatten2d", ctx.get(node.input[0]),
                       name=node.output[0])


@onnx_op("Softmax", "LogSoftmax")
def _softmax_legacy(node, ctx, at):
    """Opset 1-12 semantics: flatten to 2D at ``axis`` (default 1), softmax
    over the SECOND dim, reshape back — implemented by a trace-time op
    (intermediate shapes are unknown at import, so an import-time rank
    guard cannot work)."""
    return ctx.sd.call("act.softmax_onnx_legacy", ctx.get(node.input[0]),
                       name=node.output[0],
                       attrs={"axis": int(at.get("axis", 1)),
                              "log": node.op_type == "LogSoftmax"})


@onnx_op("Softmax", "LogSoftmax", since=13)
def _softmax13(node, ctx, at):
    op = "act.softmax" if node.op_type == "Softmax" else "act.logsoftmax"
    return ctx.sd.call(op, ctx.get(node.input[0]), name=node.output[0],
                       attrs={"axis": int(at.get("axis", -1))})


@onnx_op("Concat")
def _concat(node, ctx, at):
    if all(i in ctx.consts for i in node.input):
        # shape-arithmetic fold: torch RNN exports build initial-state
        # shapes via Shape->Gather->Unsqueeze->Concat->Expand; Expand
        # needs the concatenated shape as a known const
        ctx.consts[node.output[0]] = np.concatenate(
            [np.asarray(ctx.consts[i]) for i in node.input],
            axis=int(at["axis"]))
    return ctx.sd.call("shape.concat_v", *[ctx.get(i) for i in node.input],
                       name=node.output[0], attrs={"axis": int(at["axis"])})


@onnx_op("Transpose")
def _transpose(node, ctx, at):
    perm = [int(p) for p in at.get("perm", [])]
    v = ctx.sd.call("shape.transpose", ctx.get(node.input[0]),
                    name=node.output[0], attrs={"axes": perm})
    # propagate the static shape: torch RNN exports take Shape() of a
    # transposed input to build initial states — without this the
    # downstream Shape->...->Expand chain cannot const-fold
    src = ctx.get(node.input[0])
    if src.shape is not None and all(s is not None for s in src.shape):
        order = perm or list(range(len(src.shape)))[::-1]
        v.shape = tuple(src.shape[p] for p in order)
    return v


@onnx_op("Unsqueeze")
def _unsqueeze(node, ctx, at):
    axes = at.get("axes")
    if axes is None and len(node.input) > 1:
        axes = ctx.consts[node.input[1]].tolist()
    if node.input[0] in ctx.consts:  # shape-arithmetic fold (see Concat)
        v = np.asarray(ctx.consts[node.input[0]])
        # ONNX Unsqueeze axes refer to the OUTPUT rank; normalize negatives
        # against it before sorting — raw mixed axes like [-3, 1] would
        # sort as [-3, 1] and misplace dims or raise AxisError
        out_rank = v.ndim + len(axes)
        for a in sorted(int(a) % out_rank for a in axes):
            v = np.expand_dims(v, a)
        ctx.consts[node.output[0]] = v
    return ctx.sd.call("shape.expand_dims", ctx.get(node.input[0]),
                       name=node.output[0],
                       attrs={"axis": tuple(int(a) for a in axes)})


@onnx_op("Squeeze")
def _squeeze(node, ctx, at):
    axes = at.get("axes")
    if axes is None and len(node.input) > 1:
        axes = ctx.consts[node.input[1]].tolist()
    attrs = {"axis": tuple(int(a) for a in axes)} if axes else {}
    return ctx.sd.call("shape.squeeze", ctx.get(node.input[0]),
                       name=node.output[0], attrs=attrs)


@onnx_op("Shape")
def _shape(node, ctx, at):
    """Static fold when the producer's shape is known (placeholders with
    full shapes, initializers); else a runtime shape_of (const-consuming
    downstream nodes will raise the usual named error)."""
    name = node.input[0]
    var = ctx.get(name)
    if name in ctx.consts:
        val = np.asarray(np.asarray(ctx.consts[name]).shape, np.int64)
        ctx.consts[node.output[0]] = val
        ctx.vars[node.output[0]] = ctx.sd.constant(node.output[0], val)
        return ctx.vars[node.output[0]]
    if var.shape is not None and all(s is not None for s in var.shape):
        val = np.asarray(var.shape, np.int64)
        ctx.consts[node.output[0]] = val
        ctx.vars[node.output[0]] = ctx.sd.constant(node.output[0], val)
        return ctx.vars[node.output[0]]
    return ctx.sd.call("shape.shape_of", var, name=node.output[0])


@onnx_op("Gather")
def _gather(node, ctx, at):
    axis = int(at.get("axis", 0))
    if node.input[0] in ctx.consts and node.input[1] in ctx.consts:
        ctx.consts[node.output[0]] = np.take(
            np.asarray(ctx.consts[node.input[0]]),
            np.asarray(ctx.consts[node.input[1]]).astype(np.int64),
            axis=axis)
    return ctx.sd.call("shape.gather", ctx.get(node.input[0]),
                       ctx.get(node.input[1]), name=node.output[0],
                       attrs={"axis": axis})


@onnx_op("Cast")
def _cast(node, ctx, at):
    np_dt = _DTYPES.get(int(at.get("to", 1)))
    if np_dt is None:
        raise ValueError(f"Cast to unsupported ONNX dtype {at.get('to')}")
    if node.input[0] in ctx.consts:
        ctx.consts[node.output[0]] = np.asarray(
            ctx.consts[node.input[0]]).astype(np_dt)
    return ctx.sd.call("math.cast", ctx.get(node.input[0]),
                       name=node.output[0],
                       attrs={"dtype": np.dtype(np_dt).name})


@onnx_op("Slice")
def _slice(node, ctx, at):
    """Opset-10+ form (starts/ends/axes/steps as const inputs) and the
    opset-1 attribute form."""
    if len(node.input) > 1:
        starts = np.asarray(ctx.consts[node.input[1]]).tolist()
        ends = np.asarray(ctx.consts[node.input[2]]).tolist()
        axes = np.asarray(ctx.consts[node.input[3]]).tolist() \
            if len(node.input) > 3 and node.input[3] else \
            list(range(len(starts)))
        steps = np.asarray(ctx.consts[node.input[4]]).tolist() \
            if len(node.input) > 4 and node.input[4] else [1] * len(starts)
    else:
        starts = at["starts"]
        ends = at["ends"]
        axes = at.get("axes", list(range(len(starts))))
        steps = [1] * len(starts)
    if any(int(a) < 0 for a in axes):
        # negative axes are spec-legal; normalize against the input rank
        var = ctx.get(node.input[0])
        if node.input[0] in ctx.consts:
            rank = np.asarray(ctx.consts[node.input[0]]).ndim
        elif var.shape is not None:
            rank = len(var.shape)
        else:
            raise ValueError(
                "Slice with negative axes needs a known input rank")
        axes = [int(a) % rank for a in axes]
    by_axis = {int(a): (int(s), int(e), int(st))
               for a, s, e, st in zip(axes, starts, ends, steps)}
    max_axis = max(by_axis) if by_axis else -1
    INT_MAX = 2 ** 31 - 1
    spec = []
    for ax in range(max_axis + 1):
        if ax in by_axis:
            s, e, st = by_axis[ax]
            # ONNX clamps out-of-range ends; huge sentinels -> None
            spec.append(["slice", None if abs(s) >= INT_MAX else s,
                         None if abs(e) >= INT_MAX else e, st])
        else:
            spec.append(["slice", None, None, 1])
    if node.input[0] in ctx.consts:
        idx = tuple(slice(e[1], e[2], e[3]) for e in spec)
        ctx.consts[node.output[0]] = np.asarray(
            ctx.consts[node.input[0]])[idx]
    return ctx.sd.call("shape.strided_slice_v2", ctx.get(node.input[0]),
                       name=node.output[0], attrs={"spec": spec})


@onnx_op("Expand")
def _expand(node, ctx, at):
    shape = [int(s) for s in
             np.asarray(ctx.consts[node.input[1]]).tolist()]
    if node.input[0] in ctx.consts:
        # fold: torch RNN exports Expand a zero scalar into the initial
        # state; the LSTM/GRU handler's zero-state check reads consts
        ctx.consts[node.output[0]] = np.broadcast_to(
            np.asarray(ctx.consts[node.input[0]]), shape)
    return ctx.sd.call("shape.broadcast_to", ctx.get(node.input[0]),
                       name=node.output[0], attrs={"shape": shape})


@onnx_op("Where")
def _where(node, ctx, at):
    return ctx.sd.call("math.where", ctx.get(node.input[0]),
                       ctx.get(node.input[1]), ctx.get(node.input[2]),
                       name=node.output[0])


@onnx_op("ConstantOfShape")
def _const_of_shape(node, ctx, at):
    shape = [int(s) for s in
             np.asarray(ctx.consts[node.input[0]]).tolist()]
    value = at.get("value")
    fill = np.asarray(value).reshape(-1)[0] if value is not None else \
        np.float32(0.0)
    arr = np.full(shape, fill)
    ctx.consts[node.output[0]] = arr
    ctx.vars[node.output[0]] = ctx.sd.constant(node.output[0], arr)
    return ctx.vars[node.output[0]]


@onnx_op("Split")
def _split_onnx(node, ctx, at):
    axis = int(at.get("axis", 0))
    sizes = at.get("split")
    if sizes is None and len(node.input) > 1 and node.input[1]:
        sizes = np.asarray(ctx.consts[node.input[1]]).tolist()
    x = ctx.get(node.input[0])
    n_out = len(node.output)
    if sizes:
        cuts = np.cumsum([int(s) for s in sizes])[:-1].tolist()
        attrs = {"indices_or_sections": [int(c) for c in cuts],
                 "axis": axis}
    else:
        attrs = {"indices_or_sections": n_out, "axis": axis}
    vs = ctx.sd.call_multi("shape.split", x, n_outputs=n_out,
                           name=list(node.output), attrs=attrs)
    for out_name, v in zip(node.output, vs):
        ctx.vars[out_name] = v
    return vs[0]


@onnx_op("Tile")
def _tile_onnx(node, ctx, at):
    reps = [int(r) for r in np.asarray(ctx.consts[node.input[1]]).tolist()]
    return ctx.sd.call("shape.tile", ctx.get(node.input[0]),
                       name=node.output[0], attrs={"reps": reps})


@onnx_op("Pad")
def _pad_onnx(node, ctx, at):
    mode = at.get("mode", "constant")
    if mode not in ("constant", b"constant"):
        raise ValueError(f"Pad mode {mode!r} not supported")
    if len(node.input) > 1:
        pads = np.asarray(ctx.consts[node.input[1]]).tolist()
        value = float(np.asarray(
            ctx.consts[node.input[2]]).reshape(-1)[0]) \
            if len(node.input) > 2 and node.input[2] else 0.0
    else:
        pads = at["pads"]
        value = float(at.get("value", 0.0))
    n = len(pads) // 2
    widths = [(int(pads[i]), int(pads[i + n])) for i in range(n)]
    return ctx.sd.call("shape.pad", ctx.get(node.input[0]),
                       name=node.output[0],
                       attrs={"pad_width": widths,
                              "constant_values": value})


def _rnn_optional(ctx, node, idx):
    """Optional ONNX input: returns the tensor name or None for ''/absent."""
    if len(node.input) > idx and node.input[idx]:
        return node.input[idx]
    return None


def _rnn_check_initial(ctx, name, what):
    if name is None:
        return
    if name in ctx.consts and not np.any(ctx.consts[name]):
        return  # zero initial state == our default
    raise ValueError(f"{what} with non-zero initial state not supported")


@onnx_op("LSTM", "GRU")
def _rnn(node, ctx, at):
    """ONNX LSTM/GRU -> onnx_lstm/onnx_gru catalog ops (multi-output:
    Y/Y_h[/Y_c]). Default activations, layout=0, zero initial state,
    no sequence_lens (matches torch.onnx.export of nn.LSTM/nn.GRU)."""
    kind = node.op_type
    if at.get("layout"):
        raise ValueError(f"{kind} layout=1 not supported (re-export with "
                         "the default seq-major layout)")
    if at.get("clip"):
        raise ValueError(f"{kind} clip not supported")
    if at.get("activations"):
        raise ValueError(f"{kind} custom activations not supported")
    hidden = int(at["hidden_size"])
    direction = at.get("direction", "forward")
    n_dirs = 2 if direction == "bidirectional" else 1
    x = ctx.get(node.input[0])
    w = ctx.get(node.input[1])
    r = ctx.get(node.input[2])
    b_name = _rnn_optional(ctx, node, 3)
    if b_name is None:
        width = 8 * hidden if kind == "LSTM" else 6 * hidden
        b = ctx.sd._lift(np.zeros((n_dirs, width), np.float32))
    else:
        b = ctx.get(b_name)
    seq_lens = _rnn_optional(ctx, node, 4)
    if seq_lens is not None:
        raise ValueError(f"{kind} sequence_lens not supported "
                         "(pad to a fixed length)")
    _rnn_check_initial(ctx, _rnn_optional(ctx, node, 5), f"{kind} initial_h")
    if kind == "LSTM":
        _rnn_check_initial(ctx, _rnn_optional(ctx, node, 6),
                           "LSTM initial_c")
        names = [node.output[k] if len(node.output) > k and node.output[k]
                 else None for k in range(3)]
        vs = ctx.sd.call_multi(
            "onnx_lstm", x, w, r, b, n_outputs=3, name=names,
            attrs={"direction": direction, "hidden_size": hidden})
    else:
        names = [node.output[k] if len(node.output) > k and node.output[k]
                 else None for k in range(2)]
        vs = ctx.sd.call_multi(
            "onnx_gru", x, w, r, b, n_outputs=2, name=names,
            attrs={"direction": direction, "hidden_size": hidden,
                   "linear_before_reset": int(
                       at.get("linear_before_reset", 0))})
    for out_name, v in zip(node.output, vs):
        if out_name:
            ctx.vars[out_name] = v
    return vs[0]


@onnx_op("ReduceMean", "ReduceSum", "ReduceMax", "ReduceMin")
def _reduce(node, ctx, at):
    op = {"ReduceMean": "reduce.mean", "ReduceSum": "reduce.sum",
          "ReduceMax": "reduce.max", "ReduceMin": "reduce.min"}[node.op_type]
    axes = at.get("axes")
    if axes is None and len(node.input) > 1:
        axes = ctx.consts[node.input[1]].tolist()
    return ctx.sd.call(op, ctx.get(node.input[0]), name=node.output[0],
                       attrs={"axis": tuple(int(a) for a in axes) if axes else None,
                              "keepdims": bool(at.get("keepdims", 1))})


class OnnxFrameworkImporter:
    """The JAX package's entry point (``OnnxFrameworkImporter``)."""

    @staticmethod
    def import_file(path: str, device=None) -> SameDiff:
        with open(path, "rb") as f:
            return OnnxFrameworkImporter.import_model_proto(f.read(),
                                                            device=device)

    @staticmethod
    def import_model_proto(data, device=None) -> SameDiff:
        """An ONNX ``ModelProto`` (serialized bytes, or a protobuf object)
        as a SameDiff on ``device``."""
        model = wire.parse_onnx_model(data)
        g = model.graph
        sd = SameDiff(device)
        ctx = _Ctx(sd)
        # the declared ai.onnx opset drives each handler's since_version;
        # a model with no declaration is read as opset 13
        opset = 0
        for oi in model.opset_import:
            if oi.domain in ("", "ai.onnx"):
                opset = max(opset, int(oi.version))
        ctx.opset = opset = opset or 13
        for init in g.initializer:
            value = _tensor_to_np(init)
            ctx.consts[init.name] = value
            ctx.vars[init.name] = sd.var(init.name, value)
        for vi in g.input:
            if vi.name in ctx.vars:
                continue  # an initializer doubling as an input (pre-IR4)
            shape = None
            tt = vi.type.tensor_type
            if tt.shape.dim:
                shape = tuple(d.dim_value if d.dim_value else None
                              for d in tt.shape.dim)
            ctx.vars[vi.name] = sd.placeholder(vi.name, shape)
        for node in g.node:
            at = _attrs(node)
            if node.op_type == "Constant":
                value = at.get("value")
                ctx.consts[node.output[0]] = np.asarray(value)
                ctx.vars[node.output[0]] = sd.constant(node.output[0], value)
            elif node.op_type in _UNARY:
                ctx.vars[node.output[0]] = sd.call(
                    _UNARY[node.op_type], ctx.get(node.input[0]),
                    name=node.output[0])
            elif node.op_type in _BINARY:
                ctx.vars[node.output[0]] = sd.call(
                    _BINARY[node.op_type], ctx.get(node.input[0]),
                    ctx.get(node.input[1]), name=node.output[0])
            elif node.op_type in _M:
                fn = _select_handler(node.op_type, opset)
                ctx.vars[node.output[0]] = fn(node, ctx, at)
            else:
                raise ValueError(
                    f"unsupported ONNX op {node.op_type!r} (node "
                    f"{node.name!r}) — extend modelimport/onnx.py")
        sd.onnx_outputs = [vi.name for vi in g.output]
        # the declared graph-input order (initializers excluded): the
        # validation runner feeds its positional torch oracle so
        sd.onnx_inputs = [vi.name for vi in g.input
                          if vi.name not in ctx.consts]
        return sd
