"""TF ``GraphDef`` import into a SameDiff graph.

Port of ``deeplearning4j_tpu/modelimport/tensorflow.py``: walk the frozen
GraphDef in node order and map each TF op through a per-op-type registry
(``tf_op``) into catalog ops recorded on the port's
:class:`~deeplearning4j_tpu_torch.autodiff.samediff.SameDiff`, by the JAX
package's op names and attributes, so the recorded ``graph.json`` is the
JAX import's. Frozen inference graphs (variables folded to ``Const``);
``trainable=True`` turns the non-scalar float constants (the weights) into
VARIABLEs, so the import fine-tunes with ``SameDiff.fit``. TF passes
reduction axes, target shapes and permutations as ``Const`` inputs: they
are resolved at import time and baked into op attributes (with numpy
const-folding of shape arithmetic). Functional control flow
(``StatelessIf``/``If``, ``StatelessWhile``/``While``) imports the
branch, cond and body ``FunctionDef``s of ``graph_def.library`` as
SameDiff ``cond``/``while_loop`` subgraphs. Unsupported op types raise
with the op's name.

Divergences from the JAX importer, none in what a graph records:

- The GraphDef is read by the port's own wire reader
  (``proto/wire.py``), never by TensorFlow or protobuf; a protobuf
  object is read through its ``SerializeToString()``. Its tensors go
  through ``wire.make_ndarray`` (``tensor_util.MakeNdarray``'s rule).
- A multi-output node's FunctionDef-style output names (``node:arg:k``)
  come from :data:`_OUTPUT_ARGS`, the output arguments of the op types
  mapped here as TF's op registry lists them, where the JAX importer asks
  that registry.
- A ``DT_BFLOAT16`` constant is recorded as a bfloat16 value; its
  import-time copy for const folding is the float32 array of the same
  values (numpy has no bfloat16 without ``ml_dtypes``).
- The entry points take ``device`` (``cuda`` unless the caller asks for
  ``cpu``), and ``import_file`` takes ``trainable`` too.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..autodiff.samediff import SameDiff, SDVariable
from .proto import wire

#: output argument names of the multi-output op types mapped here, from
#: TF's op registry (``op_def.output_arg``): an If/While returns one list
#: argument, so its named keys exist only for a single output, as with
#: the registry
_OUTPUT_ARGS = {"TopKV2": ("values", "indices"), "Split": ("output",),
                "SplitV": ("output",), "Unpack": ("output",),
                "If": ("output",), "StatelessIf": ("output",),
                "While": ("output",), "StatelessWhile": ("output",)}


class _Ctx:
    def __init__(self, sd: SameDiff, library: Optional[Dict] = None,
                 prefix: str = ""):
        self.sd = sd
        self.vars: Dict[str, SDVariable] = {}     # tf tensor name -> SDVar
        self.consts: Dict[str, np.ndarray] = {}   # tf node name -> value
        self.library = library or {}              # FunctionDef name -> def
        self.prefix = prefix                      # graph-name prefix (fn bodies)

    def get(self, ref: str) -> SDVariable:
        parts = ref.split(":")
        if len(parts) == 3:
            # FunctionDef-body ref 'node:out_arg_name:k' — k indexes WITHIN
            # the named output arg, so the flat slot needs the producing
            # op's output-arg table (bind_outputs registers these keys)
            named = f"{parts[0]}:{parts[1]}:{parts[2]}"
            if named in self.vars:
                return self.vars[named]
        name, idx = _split_ref(ref)
        if idx and f"{name}:{idx}" in self.vars:
            return self.vars[f"{name}:{idx}"]
        if name not in self.vars:
            raise ValueError(f"reference to unknown tensor {ref!r}")
        if idx:
            raise ValueError(
                f"reference {ref!r} wants output slot {idx} of a "
                "single-output mapping")
        return self.vars[name]

    def const_value(self, ref: str) -> np.ndarray:
        name = _strip(ref)
        if name not in self.consts:
            raise ValueError(
                f"op needs a static value but input {ref!r} is not Const")
        return self.consts[name]

    def local_key(self, node_name: str) -> str:
        """Graph names inside function bodies are prefixed (``fn/node``);
        tensor refs within the body use the unprefixed name."""
        if self.prefix and node_name.startswith(self.prefix):
            return node_name[len(self.prefix):]
        return node_name

    def set_const(self, node_name: str, value) -> None:
        self.consts[self.local_key(node_name)] = value

    def bind_outputs(self, node_name: str, vs,
                     op_type: Optional[str] = None) -> SDVariable:
        """Register the extra output slots of a multi-output node. With
        ``op_type``, also register FunctionDef-style named-arg keys
        (``node:out_arg:k``) from :data:`_OUTPUT_ARGS`: refs inside
        If/While bodies use that spelling, and resolving only the trailing
        integer would alias every arg's slot 0."""
        key = self.local_key(node_name)
        for k, v in enumerate(vs):
            if k:
                self.vars[f"{key}:{k}"] = v
        args = _OUTPUT_ARGS.get(op_type, ())
        if len(args) == len(vs):
            # one tensor per output arg (TopKV2; a single-output list)
            for arg, v in zip(args, vs):
                self.vars[f"{key}:{arg}:0"] = v
        return vs[0]


def _strip(ref: str) -> str:
    """'node:0' -> 'node'; control deps '^node' are filtered earlier."""
    return ref.split(":")[0]


def _split_ref(ref: str):
    """GraphDef 'node:1' / FunctionDef 'node:out_name:1' -> (node, 1)."""
    parts = ref.split(":")
    idx = int(parts[-1]) if len(parts) > 1 and parts[-1].isdigit() else 0
    return parts[0], idx


def _attr(node, key, default=None):
    if key not in node.attr:
        return default
    a = node.attr[key]
    field = a.WhichOneof("value")
    v = getattr(a, field)
    if field == "list":
        for f in ("i", "f", "b", "s"):
            items = list(getattr(v, f))
            if items:
                return items
        return []
    if field == "s":
        return v.decode()
    return v


def _pair_from(v, layout="NHWC"):
    """ksize/strides attr [1,h,w,1] (NHWC) -> (h, w)."""
    v = list(v)
    if len(v) == 4:
        return (int(v[1]), int(v[2])) if layout == "NHWC" else (int(v[2]), int(v[3]))
    if len(v) == 2:
        return (int(v[0]), int(v[1]))
    return (int(v[0]),) * 2


_MAPPERS: Dict[str, Callable] = {}


def tf_op(*types):
    def deco(fn):
        for t in types:
            _MAPPERS[t] = fn
        return fn
    return deco


# ---- elementwise / unary ----------------------------------------------------
_UNARY = {"Relu": "act.relu", "Relu6": "act.relu6", "Elu": "act.elu",
          "Selu": "act.selu", "Sigmoid": "act.sigmoid", "Tanh": "act.tanh",
          "Softmax": "act.softmax", "LogSoftmax": "act.logsoftmax",
          "Softplus": "act.softplus", "Softsign": "act.softsign",
          "Exp": "math.exp", "Log": "math.log", "Log1p": "math.log1p",
          "Sqrt": "math.sqrt", "Rsqrt": "math.rsqrt", "Square": "math.square",
          "Abs": "math.abs", "Neg": "math.neg", "Sign": "math.sign",
          "Floor": "math.floor", "Ceil": "math.ceil", "Round": "math.round",
          "Erf": "math.erf", "Sin": "math.sin", "Cos": "math.cos",
          "Tan": "math.tan", "Sinh": "math.sinh", "Cosh": "math.cosh",
          "Asin": "math.asin", "Acos": "math.acos", "Atan": "math.atan",
          "Reciprocal": "math.reciprocal", "Expm1": "math.expm1",
          "IsNan": "math.isnan", "IsInf": "math.isinf",
          "Erfc": "math.erfc",
          "LogicalNot": "math.logical_not"}

_BINARY = {"Add": "math.add", "AddV2": "math.add",
           "Sub": "math.sub", "Mul": "math.mul", "RealDiv": "math.div",
           "Div": "math.div", "FloorDiv": "math.floordiv",
           "Maximum": "math.maximum", "Minimum": "math.minimum",
           "Pow": "math.pow", "SquaredDifference": "math.squared_difference",
           "FloorMod": "math.mod", "Atan2": "math.atan2",
           "Greater": "math.greater", "GreaterEqual": "math.greater_equal",
           "Less": "math.less", "LessEqual": "math.less_equal",
           "Equal": "math.equal", "NotEqual": "math.not_equal",
           "LogicalAnd": "math.logical_and", "LogicalOr": "math.logical_or"}


def _map_unary(node, ctx, ins):
    return ctx.sd.call(_UNARY[node.op], ctx.get(ins[0]), name=node.name)


# numpy equivalents for import-time const-folding: TF shape arithmetic
# (Shape -> StridedSlice -> Mul/Pack -> Reshape) must stay statically
# resolvable for const-consuming mappers like Reshape/Tile/Fill
_NP_BINARY = {"Add": np.add, "AddV2": np.add, "Sub": np.subtract,
              "Mul": np.multiply, "RealDiv": np.divide, "Div": np.divide,
              "FloorDiv": np.floor_divide, "Maximum": np.maximum,
              "Minimum": np.minimum, "FloorMod": np.mod}


def _map_binary(node, ctx, ins):
    if node.op in _NP_BINARY and all(_strip(i) in ctx.consts for i in ins):
        ctx.set_const(node.name, _NP_BINARY[node.op](
            np.asarray(ctx.consts[_strip(ins[0])]),
            np.asarray(ctx.consts[_strip(ins[1])])))
    return ctx.sd.call(_BINARY[node.op], ctx.get(ins[0]), ctx.get(ins[1]),
                       name=node.name)


@tf_op("AddN")
def _add_n(node, ctx, ins):
    out = ctx.get(ins[0])
    for i in ins[1:-1]:
        out = ctx.sd.call("math.add", out, ctx.get(i))
    if len(ins) > 1:
        out = ctx.sd.call("math.add", out, ctx.get(ins[-1]),
                          name=node.name)
        return out
    return ctx.sd.call("act.identity", out, name=node.name)


@tf_op("MatMul")
def _matmul(node, ctx, ins):
    return ctx.sd.call("linalg.mmul", ctx.get(ins[0]), ctx.get(ins[1]),
                       name=node.name,
                       attrs={"transpose_a": bool(_attr(node, "transpose_a", False)),
                              "transpose_b": bool(_attr(node, "transpose_b", False))})


@tf_op("Einsum")
def _einsum(node, ctx, ins):
    return ctx.sd.call("linalg.einsum", *[ctx.get(i) for i in ins],
                       name=node.name,
                       attrs={"equation": _attr(node, "equation")})


@tf_op("BatchMatMul", "BatchMatMulV2", "BatchMatMulV3")
def _batch_matmul(node, ctx, ins):
    # adjoint == transpose for real tensors (our import surface is real)
    return ctx.sd.call("linalg.mmul", ctx.get(ins[0]), ctx.get(ins[1]),
                       name=node.name,
                       attrs={"transpose_a": bool(_attr(node, "adj_x", False)),
                              "transpose_b": bool(_attr(node, "adj_y", False))})


@tf_op("BiasAdd")
def _bias_add(node, ctx, ins):
    # NCHW BiasAdd would need the [C] bias broadcast over axis 1, not the
    # trailing axis plain add gives — reject it like the Conv2D/pool guards.
    if _attr(node, "data_format", "NHWC") != "NHWC":
        raise ValueError("BiasAdd NCHW graphs not supported (convert to NHWC)")
    return ctx.sd.call("math.add", ctx.get(ins[0]), ctx.get(ins[1]),
                       name=node.name)


@tf_op("Conv2D")
def _conv2d(node, ctx, ins):
    if _attr(node, "data_format", "NHWC") != "NHWC":
        raise ValueError("Conv2D NCHW graphs not supported (convert to NHWC)")
    pad = _attr(node, "padding", "VALID")
    if pad == "EXPLICIT":
        raise ValueError("Conv2D padding=EXPLICIT not supported "
                         "(explicit_paddings would be silently dropped)")
    # TF kernel layout HWIO; our conv2d stores OIHW
    w = ctx.sd.call("shape.transpose", ctx.get(ins[1]),
                    attrs={"axes": [3, 2, 0, 1]})
    return ctx.sd.call(
        "conv2d", ctx.get(ins[0]), w, name=node.name,
        attrs={"stride": _pair_from(_attr(node, "strides", [1, 1, 1, 1])),
               "dilation": _pair_from(_attr(node, "dilations", [1, 1, 1, 1])),
               "mode": "same" if pad == "SAME" else "truncate",
               "data_format": "NHWC"})


@tf_op("MaxPool", "AvgPool")
def _pool(node, ctx, ins):
    op = "maxpool2d" if node.op == "MaxPool" else "avgpool2d"
    if _attr(node, "data_format", "NHWC") != "NHWC":
        raise ValueError(f"{node.op} NCHW graphs not supported "
                         "(convert to NHWC)")
    pad = _attr(node, "padding", "VALID")
    if pad == "EXPLICIT":
        raise ValueError(f"{node.op} padding=EXPLICIT not supported")
    return ctx.sd.call(
        op, ctx.get(ins[0]), name=node.name,
        attrs={"kernel": _pair_from(_attr(node, "ksize", [1, 2, 2, 1])),
               "stride": _pair_from(_attr(node, "strides", [1, 2, 2, 1])),
               "mode": "same" if pad == "SAME" else "truncate",
               "data_format": "NHWC"})


@tf_op("DepthwiseConv2dNative")
def _depthwise_conv(node, ctx, ins):
    if _attr(node, "data_format", "NHWC") != "NHWC":
        raise ValueError("DepthwiseConv2dNative NCHW not supported")
    pad = _attr(node, "padding", "VALID")
    if pad == "EXPLICIT":
        raise ValueError("DepthwiseConv2dNative padding=EXPLICIT "
                         "not supported")
    # TF kernel [kH, kW, C, mult] -> our depthwise storage [C*mult, 1, kH, kW]
    w = ctx.sd.call("shape.transpose", ctx.get(ins[1]),
                    attrs={"axes": [2, 3, 0, 1]})      # [C, mult, kH, kW]
    w = ctx.sd.call("shape.reshape", w,
                    attrs={"shape": list(_depthwise_out_shape(ctx, ins[1]))})
    return ctx.sd.call(
        "depthwise_conv2d", ctx.get(ins[0]), w, name=node.name,
        attrs={"stride": _pair_from(_attr(node, "strides", [1, 1, 1, 1])),
               "dilation": _pair_from(_attr(node, "dilations", [1, 1, 1, 1])),
               "mode": "same" if pad == "SAME" else "truncate",
               "data_format": "NHWC"})


def _depthwise_out_shape(ctx, wref):
    """[C*mult, 1, kH, kW] target shape from the (const or shaped) kernel."""
    name = _strip(wref)
    if name in ctx.consts:
        kh, kw, c, mult = np.asarray(ctx.consts[name]).shape
    else:
        var = ctx.get(wref)
        if var.shape is None or any(s is None for s in var.shape):
            raise ValueError("DepthwiseConv2dNative needs a static kernel "
                             "shape")
        kh, kw, c, mult = var.shape
    return [c * mult, 1, kh, kw]


@tf_op("ResizeBilinear", "ResizeNearestNeighbor")
def _resize(node, ctx, ins):
    # the resize ops sample half-pixel centers — the TF2 convention
    # (tf.image.resize sets half_pixel_centers=True). The TF1 legacy grid
    # (half_pixel_centers=False / align_corners) is a different sampling
    # lattice; mapping it silently would be numerically wrong everywhere.
    if _attr(node, "align_corners", False):
        raise ValueError(f"{node.op} align_corners=True not supported")
    if not _attr(node, "half_pixel_centers", False):
        raise ValueError(
            f"{node.op} with the TF1 legacy grid (half_pixel_centers=False) "
            "not supported — re-export with tf.image.resize (TF2)")
    size = [int(s) for s in
            np.asarray(ctx.const_value(ins[1])).reshape(-1).tolist()]
    op = ("image.resize_bilinear" if node.op == "ResizeBilinear"
          else "image.resize_nearest")
    return ctx.sd.call(op, ctx.get(ins[0]), name=node.name,
                       attrs={"size": size, "data_format": "NHWC"})


@tf_op("FusedBatchNorm", "FusedBatchNormV2", "FusedBatchNormV3")
def _fused_bn(node, ctx, ins):
    if _attr(node, "is_training", False):
        raise ValueError("FusedBatchNorm training mode not supported "
                         "(freeze the graph for inference import)")
    return ctx.sd.call("batch_norm", ctx.get(ins[0]), ctx.get(ins[1]),
                       ctx.get(ins[2]), ctx.get(ins[3]), ctx.get(ins[4]),
                       name=node.name,
                       attrs={"eps": float(_attr(node, "epsilon", 1e-3)),
                              "axis": -1})


@tf_op("Mean", "Sum", "Max", "Min", "Prod")
def _reduce(node, ctx, ins):
    op = {"Mean": "reduce.mean", "Sum": "reduce.sum", "Max": "reduce.max",
          "Min": "reduce.min", "Prod": "reduce.prod"}[node.op]
    axes = ctx.const_value(ins[1]).tolist()
    axes = axes if isinstance(axes, list) else [axes]
    keep = bool(_attr(node, "keep_dims", False))
    if _strip(ins[0]) in ctx.consts:  # tf.reduce_prod(shape) etc.
        np_red = {"Mean": np.mean, "Sum": np.sum, "Max": np.max,
                  "Min": np.min, "Prod": np.prod}[node.op]
        ctx.set_const(node.name, np_red(
            np.asarray(ctx.consts[_strip(ins[0])]),
            axis=tuple(int(a) for a in axes) or None, keepdims=keep))
    return ctx.sd.call(op, ctx.get(ins[0]), name=node.name,
                       attrs={"axis": tuple(int(a) for a in axes),
                              "keepdims": keep})


@tf_op("ArgMax", "ArgMin")
def _argreduce(node, ctx, ins):
    op = "reduce.argmax" if node.op == "ArgMax" else "reduce.argmin"
    axis = int(np.asarray(ctx.const_value(ins[1])))
    return ctx.sd.call(op, ctx.get(ins[0]), name=node.name,
                       attrs={"axis": axis})


@tf_op("Reshape")
def _reshape(node, ctx, ins):
    shape = [int(s) for s in ctx.const_value(ins[1]).tolist()]
    return ctx.sd.call("shape.reshape", ctx.get(ins[0]), name=node.name,
                       attrs={"shape": shape})


@tf_op("Transpose")
def _transpose(node, ctx, ins):
    perm = [int(p) for p in ctx.const_value(ins[1]).tolist()]
    return ctx.sd.call("shape.transpose", ctx.get(ins[0]), name=node.name,
                       attrs={"axes": perm})


@tf_op("ExpandDims")
def _expand(node, ctx, ins):
    axis = int(np.asarray(ctx.const_value(ins[1])))
    return ctx.sd.call("shape.expand_dims", ctx.get(ins[0]), name=node.name,
                       attrs={"axis": axis})


@tf_op("Squeeze")
def _squeeze(node, ctx, ins):
    dims = _attr(node, "squeeze_dims", []) or None
    attrs = {"axis": tuple(int(d) for d in dims)} if dims else {}
    return ctx.sd.call("shape.squeeze", ctx.get(ins[0]), name=node.name,
                       attrs=attrs)


@tf_op("ConcatV2")
def _concat(node, ctx, ins):
    axis = int(np.asarray(ctx.const_value(ins[-1])))
    return ctx.sd.call("shape.concat_v",
                       *[ctx.get(i) for i in ins[:-1]], name=node.name,
                       attrs={"axis": axis})


@tf_op("Pack")
def _pack(node, ctx, ins):
    axis = int(_attr(node, "axis", 0))
    if all(_strip(i) in ctx.consts for i in ins):
        ctx.set_const(node.name, np.stack(
            [np.asarray(ctx.consts[_strip(i)]) for i in ins], axis=axis))
    return ctx.sd.call("shape.stack_v", *[ctx.get(i) for i in ins],
                       name=node.name, attrs={"axis": axis})


@tf_op("GatherV2", "Gather")
def _gather(node, ctx, ins):
    axis = 0
    if len(ins) > 2:
        axis = int(np.asarray(ctx.const_value(ins[2])))
    return ctx.sd.call("shape.gather", ctx.get(ins[0]), ctx.get(ins[1]),
                       name=node.name, attrs={"axis": axis})


@tf_op("Pad", "PadV2")
def _pad(node, ctx, ins):
    widths = [(int(a), int(b)) for a, b in ctx.const_value(ins[1]).tolist()]
    return ctx.sd.call("shape.pad", ctx.get(ins[0]), name=node.name,
                       attrs={"pad_width": widths})


@tf_op("Tile")
def _tile(node, ctx, ins):
    reps = [int(r) for r in ctx.const_value(ins[1]).tolist()]
    return ctx.sd.call("shape.tile", ctx.get(ins[0]), name=node.name,
                       attrs={"reps": reps})


@tf_op("Cast")
def _cast(node, ctx, ins):
    """``Cast``: ``math.cast`` to ``DstT``'s dtype name."""
    name, np_dt = wire.tf_dtype(int(_attr(node, "DstT")))
    if _strip(ins[0]) in ctx.consts:
        # const-fold so shape-arithmetic chains stay statically resolvable
        value = np.asarray(ctx.consts[_strip(ins[0])])
        ctx.set_const(node.name, _bf16_round(value) if name == "bfloat16"
                      else value.astype(np_dt))
    return ctx.sd.call("math.cast", ctx.get(ins[0]), name=node.name,
                       attrs={"dtype": name})


def _bf16_round(value) -> np.ndarray:
    """float32 values rounded to bfloat16's (the folded copy of a cast to
    bfloat16; see the module docstring)."""
    return torch.from_numpy(np.asarray(value, np.float32)).to(
        torch.bfloat16).float().numpy()


@tf_op("Shape")
def _shape_op(node, ctx, ins):
    """Static fold when the producer's shape is fully known (placeholders
    and constants record shapes); otherwise a shape_of op — any consumer
    that needs it as a STATIC value will raise the usual const error."""
    var = ctx.get(ins[0])
    if var.shape is not None and all(s is not None for s in var.shape):
        val = np.asarray(var.shape, np.int32)
        ctx.set_const(node.name, val)
        return ctx.sd.constant(node.name, val)
    return ctx.sd.call("shape.shape_of", var, name=node.name)


@tf_op("StridedSlice")
def _strided_slice(node, ctx, ins):
    """Full StridedSlice: begin/end/ellipsis/new-axis/shrink-axis masks are
    lowered to a numpy-style per-dim spec (shape.strided_slice_v2)."""
    begin = np.asarray(ctx.const_value(ins[1])).reshape(-1).tolist()
    end = np.asarray(ctx.const_value(ins[2])).reshape(-1).tolist()
    strides = np.asarray(ctx.const_value(ins[3])).reshape(-1).tolist() \
        if len(ins) > 3 else [1] * len(begin)
    bm = int(_attr(node, "begin_mask", 0))
    em = int(_attr(node, "end_mask", 0))
    el = int(_attr(node, "ellipsis_mask", 0))
    na = int(_attr(node, "new_axis_mask", 0))
    sh = int(_attr(node, "shrink_axis_mask", 0))
    spec = []
    for i in range(len(begin)):
        if (el >> i) & 1:
            spec.append(["ellipsis"])
        elif (na >> i) & 1:
            spec.append(["newaxis"])
        elif (sh >> i) & 1:
            spec.append(["index", int(begin[i])])
        else:
            spec.append(["slice",
                         None if (bm >> i) & 1 else int(begin[i]),
                         None if (em >> i) & 1 else int(end[i]),
                         int(strides[i])])
    if _strip(ins[0]) in ctx.consts:
        idx = tuple(slice(e[1], e[2], e[3]) if e[0] == "slice"
                    else int(e[1]) if e[0] == "index"
                    else None if e[0] == "newaxis" else Ellipsis
                    for e in spec)
        ctx.set_const(node.name, np.asarray(
            ctx.consts[_strip(ins[0])])[idx])
    return ctx.sd.call("shape.strided_slice_v2", ctx.get(ins[0]),
                       name=node.name, attrs={"spec": spec})


@tf_op("Split")
def _split(node, ctx, ins):
    axis = int(np.asarray(ctx.const_value(ins[0])))
    num = int(_attr(node, "num_split"))
    vs = ctx.sd.call_multi("shape.split", ctx.get(ins[1]), n_outputs=num,
                           name=node.name,
                           attrs={"indices_or_sections": num, "axis": axis})
    return ctx.bind_outputs(node.name, vs, op_type=node.op)


@tf_op("SplitV")
def _split_v(node, ctx, ins):
    sizes = np.asarray(ctx.const_value(ins[1])).reshape(-1).tolist()
    axis = int(np.asarray(ctx.const_value(ins[2])))
    if any(s < 0 for s in sizes):
        raise ValueError("SplitV with -1 (inferred) size not supported")
    cuts = np.cumsum(sizes)[:-1].tolist()
    vs = ctx.sd.call_multi("shape.split", ctx.get(ins[0]),
                           n_outputs=len(sizes), name=node.name,
                           attrs={"indices_or_sections": [int(c) for c in cuts],
                                  "axis": axis})
    return ctx.bind_outputs(node.name, vs, op_type=node.op)


@tf_op("Unpack")
def _unpack(node, ctx, ins):
    num = int(_attr(node, "num"))
    axis = int(_attr(node, "axis", 0))
    vs = ctx.sd.call_multi("shape.unstack", ctx.get(ins[0]), n_outputs=num,
                           name=node.name, attrs={"axis": axis})
    return ctx.bind_outputs(node.name, vs, op_type=node.op)


@tf_op("TopKV2")
def _topk(node, ctx, ins):
    k = int(np.asarray(ctx.const_value(ins[1])))
    vs = ctx.sd.call_multi("sort.top_k", ctx.get(ins[0]), n_outputs=2,
                           name=node.name, attrs={"k": k})
    return ctx.bind_outputs(node.name, vs, op_type=node.op)


def _import_function(ctx, fn_name: str, formals, sd):
    """Trace a GraphDef library FunctionDef as a SameDiff subgraph body.
    ``formals`` are the subgraph's formal SDVariables (one per signature
    input); returns the function's result SDVariables."""
    if fn_name not in ctx.library:
        raise ValueError(f"function {fn_name!r} not in graph library")
    fdef = ctx.library[fn_name]
    sub = _Ctx(sd, library=ctx.library, prefix=f"{ctx.prefix}{fn_name}/")
    args = list(fdef.signature.input_arg)
    if len(args) != len(formals):
        raise ValueError(f"function {fn_name!r} takes {len(args)} args, "
                         f"got {len(formals)}")
    for arg, var in zip(args, formals):
        sub.vars[arg.name] = var
    _map_nodes(fdef.node_def, sub, trainable=False)
    return [sub.get(fdef.ret[o.name]) for o in fdef.signature.output_arg]


@tf_op("StatelessIf", "If")
def _if(node, ctx, ins):
    """tf.cond: branch FunctionDefs become SameDiff cond subgraphs."""
    then_fn = _attr(node, "then_branch").name
    else_fn = _attr(node, "else_branch").name
    operands = [ctx.get(i) for i in ins[1:]]

    def mk(fname):
        def body(sd, *formals):
            return tuple(_import_function(ctx, fname, formals, sd))
        return body

    vs = ctx.sd.cond(ctx.get(ins[0]), mk(then_fn), mk(else_fn), *operands,
                     name=node.name)
    return ctx.bind_outputs(node.name, vs, op_type=node.op)


@tf_op("StatelessWhile", "While")
def _while(node, ctx, ins):
    """tf.while_loop: cond/body FunctionDefs become while subgraphs."""
    cond_fn = _attr(node, "cond").name
    body_fn = _attr(node, "body").name
    loop_vars = [ctx.get(i) for i in ins]

    def mk(fname):
        def body(sd, *formals):
            return tuple(_import_function(ctx, fname, formals, sd))
        return body

    vs = ctx.sd.while_loop(mk(cond_fn), mk(body_fn), *loop_vars,
                           name=node.name)
    return ctx.bind_outputs(node.name, vs, op_type=node.op)


@tf_op("StopGradient", "Identity", "PreventGradient", "CheckNumerics")
def _identity(node, ctx, ins):
    return ctx.sd.call("act.identity", ctx.get(ins[0]), name=node.name)


@tf_op("Select", "SelectV2")
def _select(node, ctx, ins):
    return ctx.sd.call("math.where", ctx.get(ins[0]), ctx.get(ins[1]),
                       ctx.get(ins[2]), name=node.name)


@tf_op("ClipByValue")
def _clip(node, ctx, ins):
    lo = float(np.asarray(ctx.const_value(ins[1])))
    hi = float(np.asarray(ctx.const_value(ins[2])))
    return ctx.sd.call("math.clip", ctx.get(ins[0]), name=node.name,
                       attrs={"min_value": lo, "max_value": hi})


@tf_op("LeakyRelu")
def _leaky(node, ctx, ins):
    alpha = float(_attr(node, "alpha", 0.2))
    return ctx.sd.call("act.leakyrelu", ctx.get(ins[0]), name=node.name,
                       attrs={"alpha": alpha})


@tf_op("Fill")
def _fill(node, ctx, ins):
    dims = [int(d) for d in np.asarray(ctx.const_value(ins[0])).tolist()]
    return ctx.sd.call("shape.broadcast_to", ctx.get(ins[1]),
                       name=node.name, attrs={"shape": dims})


@tf_op("Range")
def _range(node, ctx, ins):
    start = np.asarray(ctx.const_value(ins[0]))
    limit = np.asarray(ctx.const_value(ins[1]))
    delta = np.asarray(ctx.const_value(ins[2]))
    value = np.arange(start, limit, delta)
    ctx.set_const(node.name, value)
    return ctx.sd.constant(node.name, value)


@tf_op("All", "Any")
def _reduce_bool(node, ctx, ins):
    # feeds Asserts in frozen graphs; map faithfully anyway. Lowered via
    # reduce.min/max on the bool array (catalog has no reduce.all);
    # min==True iff all True, max==True iff any True
    axes = np.asarray(ctx.const_value(ins[1])).reshape(-1).tolist()
    red = "reduce.min" if node.op == "All" else "reduce.max"
    return ctx.sd.call(red, ctx.get(ins[0]), name=node.name,
                       attrs={"axis": tuple(int(a) for a in axes),
                              "keepdims": bool(_attr(node, "keep_dims",
                                                     False))})


@tf_op("Slice")
def _slice(node, ctx, ins):
    begin = [int(v) for v in np.asarray(ctx.const_value(ins[1])).tolist()]
    size = [int(v) for v in np.asarray(ctx.const_value(ins[2])).tolist()]
    end = [b + s if s != -1 else None for b, s in zip(begin, size)]
    # lower to strided_slice with unit strides
    return ctx.sd.call("shape.strided_slice", ctx.get(ins[0]),
                       name=node.name,
                       attrs={"begin": begin,
                              "end": [e if e is not None else 2**31 - 1
                                      for e in end]})


@tf_op("OneHot")
def _one_hot(node, ctx, ins):
    depth = int(np.asarray(ctx.const_value(ins[1])))
    return ctx.sd.call("shape.one_hot", ctx.get(ins[0]), name=node.name,
                       attrs={"depth": depth})


class _Renamed:
    """Node shim that presents a prefixed graph name (function-body nodes
    must not collide with main-graph names) while passing everything else
    through to the proto node."""

    def __init__(self, node, name):
        self._node = node
        self.name = name

    def __getattr__(self, attr):
        return getattr(self._node, attr)


def _map_nodes(nodes, ctx: _Ctx, trainable: bool):
    """Map a node list (GraphDef.node or FunctionDef.node_def) into
    ``ctx.sd``. ``ctx.vars``/``ctx.consts`` are keyed by the LOCAL (tf)
    names; SameDiff graph names carry ``ctx.prefix``."""
    sd = ctx.sd
    for node in nodes:
        key = node.name
        if ctx.prefix:
            node = _Renamed(node, ctx.prefix + node.name)
        ins = [i for i in node.input if not i.startswith("^")]
        if node.op == "Const":
            tensor = node.attr["value"].tensor
            value = wire.make_ndarray(tensor)
            ctx.consts[key] = value
            if value.dtype == np.object_ or value.dtype.kind == "U":
                continue  # string consts (Assert messages): attr-only
            stored = (torch.from_numpy(value).to(torch.bfloat16)
                      if wire.is_bfloat16(tensor) else value)
            if trainable and value.dtype.kind == "f" and value.ndim >= 1:
                ctx.vars[key] = sd.var(node.name, stored)
            else:
                ctx.vars[key] = sd.constant(node.name, stored)
        elif node.op in ("Placeholder", "PlaceholderV2"):
            ctx.vars[key] = sd.placeholder(node.name, _attr_shape(node))
        elif node.op in ("NoOp", "Assert"):
            continue  # control-flow only; referenced via ^control deps
        elif node.op in _UNARY:
            ctx.vars[key] = _map_unary(node, ctx, ins)
        elif node.op in _BINARY:
            ctx.vars[key] = _map_binary(node, ctx, ins)
        elif node.op in _MAPPERS:
            ctx.vars[key] = _MAPPERS[node.op](node, ctx, ins)
        elif node.op in ("Switch", "Merge", "Enter", "Exit",
                         "NextIteration", "LoopCond"):
            raise ValueError(
                f"v1-style dataflow control flow ({node.op!r}, node "
                f"{node.name!r}) is not supported — re-freeze with "
                "convert_variables_to_constants_v2(..., "
                "lower_control_flow=False) to keep functional "
                "StatelessIf/StatelessWhile nodes, which import as "
                "SameDiff cond/while subgraphs")
        else:
            raise ValueError(
                f"unsupported TF op type {node.op!r} (node "
                f"{node.name!r}) — extend modelimport/tensorflow.py")


class TensorflowFrameworkImporter:
    """The JAX package's entry point (``TensorflowFrameworkImporter``)."""

    @staticmethod
    def import_graph_def(graph_def, trainable: bool = False,
                         device=None) -> SameDiff:
        """A frozen GraphDef (serialized bytes, or a protobuf object) as a
        SameDiff on ``device``. Placeholders become SameDiff placeholders:
        run it with ``sd.output({placeholder: value}, [output_names])``.
        ``trainable=True`` imports the non-scalar float constants as
        VARIABLEs (scalars and integer constants stay constant)."""
        gd = wire.parse_graph_def(graph_def)
        sd = SameDiff(device)
        library = {f.signature.name: f for f in gd.library.function} \
            if gd.HasField("library") else {}
        ctx = _Ctx(sd, library=library)
        _map_nodes(gd.node, ctx, trainable)
        return sd

    @staticmethod
    def import_file(path: str, trainable: bool = False,
                    device=None) -> SameDiff:
        with open(path, "rb") as f:
            return TensorflowFrameworkImporter.import_graph_def(
                f.read(), trainable=trainable, device=device)


def _attr_shape(node):
    if "shape" not in node.attr:
        return None
    dims = [d.size for d in node.attr["shape"].shape.dim]
    return tuple(None if d == -1 else int(d) for d in dims) or None
