"""A protobuf wire-format reader with no dependency, and the two tensor
rules the importers need.

The JAX package parses a TF ``GraphDef`` through
``tensorflow.core.framework.graph_pb2``, decodes its tensors with
``tensor_util.MakeNdarray`` (``modelimport/tensorflow.py:760,780``) and
parses ONNX through its generated ``proto/onnx_min_pb2.py`` on the
protobuf runtime (``modelimport/onnx.py:787``). The card's machine has
neither TensorFlow nor protobuf, so the port reads the wire format itself:

- the four wire types: varint (a negative int32 or int64 is ten bytes),
  fixed64, length-delimited and fixed32; repeated scalars packed or not,
  as the decoder of any protobuf runtime accepts both; map fields (a
  repeated entry message of ``key`` = 1, ``value`` = 2) as dicts;
  unknown fields skipped;
- schema tables (:data:`TF`, :data:`ONNX`) that name exactly the fields
  the JAX importers read, by field number: TF's ``GraphDef``,
  ``NodeDef``, ``AttrValue`` (with ``ListValue`` and ``NameAttrList``),
  ``TensorProto``, ``TensorShapeProto``, ``FunctionDefLibrary``,
  ``FunctionDef`` and ``OpDef.ArgDef``; every message and field of the
  JAX package's ``proto/onnx_min.proto``.

:func:`parse` returns light :class:`Message` objects that spell fields as
the generated classes do (``node.attr["T"].type``,
``graph_def.library.function``, ``model.graph.initializer``), with
proto3 defaults for absent fields and ``HasField``/``WhichOneof``. A
caller may hand a protobuf object instead of bytes, as the JAX API
allows: its ``SerializeToString()`` is read by the same decoder.

:func:`make_ndarray` is ``tensor_util.MakeNdarray``'s rule and
:func:`onnx_to_array` the JAX importer's ``_tensor_to_np``
(``modelimport/onnx.py:29``). numpy has no bfloat16 without
``ml_dtypes``, which the port does not use: a bfloat16 TF tensor comes
out as the float32 array of the same values (:func:`is_bfloat16` tells
the caller), a recorded divergence from ``MakeNdarray``'s bfloat16 array.
"""

from __future__ import annotations

import struct
from typing import Dict, Optional, Tuple

import numpy as np

__all__ = ["Message", "parse", "parse_graph_def", "parse_onnx_model",
           "make_ndarray", "is_bfloat16", "onnx_to_array", "TF", "ONNX",
           "TF_DTYPES"]

# field kinds -> wire type of one element
_VARINT_KINDS = ("int32", "int64", "uint32", "uint64", "bool", "enum")
_WIRE = {**{k: 0 for k in _VARINT_KINDS}, "double": 1, "float": 5,
         "string": 2, "bytes": 2, "message": 2, "map": 2}
_DEFAULT = {"int32": 0, "int64": 0, "uint32": 0, "uint64": 0, "enum": 0,
            "bool": False, "float": 0.0, "double": 0.0, "string": "",
            "bytes": b""}
_PACKED_FMT = {"float": "<f", "double": "<d"}


class _Field:
    """One schema entry. ``message`` names the type of a message field or
    of a map's values (None: the map's values are ``map_value``
    scalars); ``oneof`` the group the field belongs to."""
    __slots__ = ("number", "name", "kind", "repeated", "message",
                 "map_value", "oneof")

    def __init__(self, number, name, kind, repeated=False, message=None,
                 map_value=None, oneof=None):
        self.number, self.name, self.kind = number, name, kind
        self.repeated, self.message = repeated, message
        self.map_value, self.oneof = map_value, oneof


def _f(number, name, kind, **kw) -> _Field:
    return _Field(number, name, kind, **kw)


def _rep(number, name, kind, **kw) -> _Field:
    return _Field(number, name, kind, repeated=True, **kw)


def _table(*fields) -> Dict[int, _Field]:
    return {f.number: f for f in fields}


#: TF's messages (tensorflow/core/framework/*.proto), the fields the JAX
#: importer and ``MakeNdarray`` read
TF: Dict[str, Dict[int, _Field]] = {
    "GraphDef": _table(
        _rep(1, "node", "message", message="NodeDef"),
        _f(2, "library", "message", message="FunctionDefLibrary")),
    "NodeDef": _table(
        _f(1, "name", "string"), _f(2, "op", "string"),
        _rep(3, "input", "string"),
        _f(5, "attr", "map", message="AttrValue")),
    "AttrValue": _table(
        _f(1, "list", "message", message="ListValue", oneof="value"),
        _f(2, "s", "bytes", oneof="value"),
        _f(3, "i", "int64", oneof="value"),
        _f(4, "f", "float", oneof="value"),
        _f(5, "b", "bool", oneof="value"),
        _f(6, "type", "enum", oneof="value"),
        _f(7, "shape", "message", message="TensorShapeProto",
           oneof="value"),
        _f(8, "tensor", "message", message="TensorProto", oneof="value"),
        _f(9, "placeholder", "string", oneof="value"),
        _f(10, "func", "message", message="NameAttrList", oneof="value")),
    "ListValue": _table(
        _rep(2, "s", "bytes"), _rep(3, "i", "int64"),
        _rep(4, "f", "float"), _rep(5, "b", "bool")),
    "NameAttrList": _table(_f(1, "name", "string")),
    "TensorShapeProto": _table(
        _rep(2, "dim", "message", message="TensorShapeProto.Dim")),
    "TensorShapeProto.Dim": _table(_f(1, "size", "int64")),
    "TensorProto": _table(
        _f(1, "dtype", "enum"),
        _f(2, "tensor_shape", "message", message="TensorShapeProto"),
        _f(4, "tensor_content", "bytes"),
        _rep(5, "float_val", "float"), _rep(6, "double_val", "double"),
        _rep(7, "int_val", "int32"), _rep(8, "string_val", "bytes"),
        _rep(9, "scomplex_val", "float"), _rep(10, "int64_val", "int64"),
        _rep(11, "bool_val", "bool"), _rep(12, "dcomplex_val", "double"),
        _rep(13, "half_val", "int32"), _rep(16, "uint32_val", "uint32"),
        _rep(17, "uint64_val", "uint64")),
    "FunctionDefLibrary": _table(
        _rep(1, "function", "message", message="FunctionDef")),
    "FunctionDef": _table(
        _f(1, "signature", "message", message="OpDef"),
        _rep(3, "node_def", "message", message="NodeDef"),
        _f(4, "ret", "map", map_value="string")),
    "OpDef": _table(
        _f(1, "name", "string"),
        _rep(2, "input_arg", "message", message="OpDef.ArgDef"),
        _rep(3, "output_arg", "message", message="OpDef.ArgDef")),
    "OpDef.ArgDef": _table(_f(1, "name", "string")),
}

#: the JAX package's ``modelimport/proto/onnx_min.proto``, every message
#: and field
ONNX: Dict[str, Dict[int, _Field]] = {
    "AttributeProto": _table(
        _f(1, "name", "string"), _f(2, "f", "float"), _f(3, "i", "int64"),
        _f(4, "s", "bytes"),
        _f(5, "t", "message", message="TensorProto"),
        _f(6, "g", "message", message="GraphProto"),
        _rep(7, "floats", "float"), _rep(8, "ints", "int64"),
        _rep(9, "strings", "bytes"),
        _rep(10, "tensors", "message", message="TensorProto"),
        _rep(11, "graphs", "message", message="GraphProto"),
        _f(20, "type", "int32")),
    "ValueInfoProto": _table(
        _f(1, "name", "string"),
        _f(2, "type", "message", message="TypeProto")),
    "NodeProto": _table(
        _rep(1, "input", "string"), _rep(2, "output", "string"),
        _f(3, "name", "string"), _f(4, "op_type", "string"),
        _rep(5, "attribute", "message", message="AttributeProto"),
        _f(7, "domain", "string")),
    "ModelProto": _table(
        _f(1, "ir_version", "int64"), _f(2, "producer_name", "string"),
        _f(3, "producer_version", "string"), _f(4, "domain", "string"),
        _f(5, "model_version", "int64"), _f(6, "doc_string", "string"),
        _f(7, "graph", "message", message="GraphProto"),
        _rep(8, "opset_import", "message", message="OperatorSetIdProto")),
    "OperatorSetIdProto": _table(
        _f(1, "domain", "string"), _f(2, "version", "int64")),
    "GraphProto": _table(
        _rep(1, "node", "message", message="NodeProto"),
        _f(2, "name", "string"),
        _rep(5, "initializer", "message", message="TensorProto"),
        _f(10, "doc_string", "string"),
        _rep(11, "input", "message", message="ValueInfoProto"),
        _rep(12, "output", "message", message="ValueInfoProto"),
        _rep(13, "value_info", "message", message="ValueInfoProto")),
    "TensorProto": _table(
        _rep(1, "dims", "int64"), _f(2, "data_type", "int32"),
        _rep(4, "float_data", "float"), _rep(5, "int32_data", "int32"),
        _rep(6, "string_data", "bytes"), _rep(7, "int64_data", "int64"),
        _f(8, "name", "string"), _f(9, "raw_data", "bytes"),
        _rep(10, "double_data", "double")),
    "TensorShapeProto": _table(
        _rep(1, "dim", "message", message="TensorShapeProto.Dimension")),
    "TensorShapeProto.Dimension": _table(
        _f(1, "dim_value", "int64", oneof="value"),
        _f(2, "dim_param", "string", oneof="value")),
    "TypeProto": _table(
        _f(1, "tensor_type", "message", message="TypeProto.Tensor",
           oneof="value")),
    "TypeProto.Tensor": _table(
        _f(1, "elem_type", "int32"),
        _f(2, "shape", "message", message="TensorShapeProto")),
}


class Message:
    """One decoded message: its fields as attributes under the schema's
    names. An absent field reads as proto3's default (0, "", b"", False,
    an empty list or dict, an empty message)."""

    def __init__(self, schema: Dict[str, Dict[int, _Field]], mtype: str):
        object.__setattr__(self, "_schema", schema)
        object.__setattr__(self, "_type", mtype)
        object.__setattr__(self, "_set", [])

    def _field(self, name) -> Optional[_Field]:
        for f in self._schema[self._type].values():
            if f.name == name:
                return f
        return None

    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)
        f = self._field(name)
        if f is None:
            raise AttributeError(f"{self._type} has no field {name!r}")
        if f.kind == "map":
            value = {}
        elif f.repeated:
            value = []
        elif f.kind == "message":
            value = Message(self._schema, f.message)
        else:
            return _DEFAULT[f.kind]
        object.__setattr__(self, name, value)  # mutable defaults stay put
        return value

    def HasField(self, name) -> bool:
        """Was the singular field ``name`` on the wire?"""
        f = self._field(name)
        if f is None or f.repeated or f.kind == "map":
            raise ValueError(f"{self._type}.{name} is not a singular field")
        return name in self._set

    def WhichOneof(self, group) -> Optional[str]:
        """The field of oneof ``group`` that was set last, or None."""
        names = [f.name for f in self._schema[self._type].values()
                 if f.oneof == group]
        if not names:
            raise ValueError(f"{self._type} has no oneof {group!r}")
        for name in reversed(self._set):
            if name in names:
                return name
        return None

    def ListFields(self):
        """``[(name, value)]`` of the fields present on the wire."""
        return [(n, getattr(self, n)) for n in
                dict.fromkeys(self._set)]

    def __repr__(self):
        return f"<{self._type} {dict(self.ListFields())!r}>"


# ----------------------------------------------------------------- decoding

def _varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = shift = 0
    while True:
        if pos >= len(buf):
            raise ValueError("truncated varint")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift >= 70:
            raise ValueError("varint longer than ten bytes")


def _scalar(kind: str, v: int):
    """A varint's value as ``kind`` (two's complement for the signed)."""
    v &= (1 << 64) - 1
    if kind == "int64":
        return v - (1 << 64) if v >> 63 else v
    if kind in ("int32", "enum"):
        v &= 0xFFFFFFFF
        return v - (1 << 32) if v >> 31 else v
    if kind == "uint32":
        return v & 0xFFFFFFFF
    if kind == "bool":
        return v != 0
    return v  # uint64


def _skip(buf: bytes, pos: int, wire: int) -> int:
    if wire == 0:
        return _varint(buf, pos)[1]
    if wire == 1:
        return pos + 8
    if wire == 5:
        return pos + 4
    if wire == 2:
        n, pos = _varint(buf, pos)
        return pos + n
    raise ValueError(f"unsupported wire type {wire} (groups are not read)")


def _packed(kind: str, data: bytes) -> list:
    fmt = _PACKED_FMT.get(kind)
    if fmt is not None:
        return [v for (v,) in struct.iter_unpack(fmt, data)]
    out, pos = [], 0
    while pos < len(data):
        v, pos = _varint(data, pos)
        out.append(_scalar(kind, v))
    return out


def _element(schema, f: _Field, wire: int, buf: bytes, pos: int):
    """One element of field ``f`` at ``pos``: ``(value, new pos)``."""
    if wire == 0:
        v, pos = _varint(buf, pos)
        return _scalar(f.kind, v), pos
    if wire == 5:
        return struct.unpack_from("<f", buf, pos)[0], pos + 4
    if wire == 1:
        return struct.unpack_from("<d", buf, pos)[0], pos + 8
    n, pos = _varint(buf, pos)
    data = buf[pos:pos + n]
    if len(data) != n:
        raise ValueError(f"truncated field {f.name!r}")
    pos += n
    if f.kind == "string":
        return data.decode("utf-8"), pos
    if f.kind == "bytes":
        return bytes(data), pos
    if f.kind == "message":
        return _decode(schema, f.message, data), pos
    raise ValueError(f"field {f.name!r} ({f.kind}) on wire type 2")


def _map_entry(schema, f: _Field, data: bytes):
    key, value, pos = "", None, 0
    while pos < len(data):
        tag, pos = _varint(data, pos)
        num, wire = tag >> 3, tag & 7
        if num == 1 and wire == 2:
            n, pos = _varint(data, pos)
            key = data[pos:pos + n].decode("utf-8")
            pos += n
        elif num == 2 and wire == 2:
            n, pos = _varint(data, pos)
            raw = data[pos:pos + n]
            pos += n
            value = raw.decode("utf-8") if f.map_value == "string" \
                else _decode(schema, f.message, raw)
        else:
            pos = _skip(data, pos, wire)
    if value is None:
        value = "" if f.map_value == "string" else Message(schema, f.message)
    return key, value


def _decode(schema, mtype: str, buf: bytes) -> Message:
    table = schema[mtype]
    msg = Message(schema, mtype)
    seen = msg._set
    pos, end = 0, len(buf)
    while pos < end:
        tag, pos = _varint(buf, pos)
        num, wire = tag >> 3, tag & 7
        if num == 0:
            raise ValueError(f"{mtype}: field number 0")
        f = table.get(num)
        if f is None:
            pos = _skip(buf, pos, wire)
            continue
        if f.kind == "map":
            if wire != 2:
                raise ValueError(f"{mtype}.{f.name}: map entry on wire "
                                 f"type {wire}")
            n, pos = _varint(buf, pos)
            k, v = _map_entry(schema, f, buf[pos:pos + n])
            pos += n
            getattr(msg, f.name)[k] = v
            seen.append(f.name)
            continue
        if f.repeated and wire == 2 and _WIRE[f.kind] != 2:
            n, pos = _varint(buf, pos)
            getattr(msg, f.name).extend(_packed(f.kind, buf[pos:pos + n]))
            pos += n
            seen.append(f.name)
            continue
        if wire != _WIRE[f.kind]:
            raise ValueError(f"{mtype}.{f.name}: wire type {wire} for a "
                             f"{f.kind} field")
        value, pos = _element(schema, f, wire, buf, pos)
        if f.repeated:
            getattr(msg, f.name).append(value)
            seen.append(f.name)
            continue
        if f.kind == "message" and f.name in msg.__dict__:
            value = _merge(msg.__dict__[f.name], value)
        object.__setattr__(msg, f.name, value)
        if f.oneof is not None:  # setting one member clears the others
            for other in table.values():
                if other.oneof == f.oneof and other is not f:
                    msg.__dict__.pop(other.name, None)
                    while other.name in seen:
                        seen.remove(other.name)
        seen.append(f.name)
    if pos != end:
        raise ValueError(f"{mtype}: truncated message")
    return msg


def _merge(old: Message, new: Message) -> Message:
    """A singular message field seen twice: protobuf merges the second
    into the first (repeated fields appended, scalars replaced)."""
    for name, value in new.ListFields():
        if isinstance(value, list):
            getattr(old, name).extend(value)
        elif isinstance(value, dict):
            getattr(old, name).update(value)
        elif isinstance(value, Message) and name in old.__dict__:
            object.__setattr__(old, name, _merge(old.__dict__[name], value))
        else:
            object.__setattr__(old, name, value)
        old._set.append(name)
    return old


def _as_bytes(data) -> bytes:
    if isinstance(data, (bytes, bytearray, memoryview)):
        return bytes(data)
    serialize = getattr(data, "SerializeToString", None)
    if serialize is None:
        raise TypeError(f"expected bytes or a protobuf message, got "
                        f"{type(data).__name__}")
    return serialize()


def parse(data, mtype: str, schema=None) -> Message:
    """Decode ``data`` (bytes, or a protobuf object whose serialized
    bytes are read) as message ``mtype`` of ``schema`` (TF's unless the
    type is only ONNX's)."""
    if schema is None:
        schema = TF if mtype in TF else ONNX
    return _decode(schema, mtype, _as_bytes(data))


def parse_graph_def(data) -> Message:
    """A TF ``GraphDef``."""
    return parse(data, "GraphDef", TF)


def parse_onnx_model(data) -> Message:
    """An ONNX ``ModelProto``."""
    return parse(data, "ModelProto", ONNX)


# --------------------------------------------------------------- tensors

#: TF DataType -> (name, numpy dtype, value field); bfloat16 comes out as
#: float32 (module docstring)
TF_DTYPES = {
    1: ("float32", np.float32, "float_val"),
    2: ("float64", np.float64, "double_val"),
    3: ("int32", np.int32, "int_val"),
    4: ("uint8", np.uint8, "int_val"),
    5: ("int16", np.int16, "int_val"),
    6: ("int8", np.int8, "int_val"),
    7: ("string", np.object_, "string_val"),
    8: ("complex64", np.complex64, "scomplex_val"),
    9: ("int64", np.int64, "int64_val"),
    10: ("bool", np.bool_, "bool_val"),
    14: ("bfloat16", np.float32, "half_val"),
    17: ("uint16", np.uint16, "int_val"),
    18: ("complex128", np.complex128, "dcomplex_val"),
    19: ("float16", np.float16, "half_val"),
    22: ("uint32", np.uint32, "uint32_val"),
    23: ("uint64", np.uint64, "uint64_val"),
}
_DT_BFLOAT16 = 14


def tf_dtype(enum: int) -> Tuple[str, type]:
    """``(name, numpy dtype)`` of a TF DataType enum (a reference type,
    ``enum + 100``, is its base type)."""
    enum = int(enum)
    entry = TF_DTYPES.get(enum - 100 if enum > 100 else enum)
    if entry is None:
        raise TypeError(f"unsupported TF dtype {enum}")
    return entry[0], entry[1]


def is_bfloat16(tensor) -> bool:
    return int(tensor.dtype) == _DT_BFLOAT16


def _bf16_bits_to_f32(bits: np.ndarray) -> np.ndarray:
    return (bits.astype(np.uint32) << 16).view(np.float32)


def make_ndarray(tensor) -> np.ndarray:
    """``tensor_util.MakeNdarray`` of a TF ``TensorProto``: the
    ``tensor_content`` bytes when present, else the dtype's typed
    ``*_val`` field, its last value repeated to fill the shape (one value
    broadcast, as TF stores a splat), zeros when it is empty; float16 and
    bfloat16 values are 16-bit patterns in ``half_val``."""
    shape = [int(d.size) for d in tensor.tensor_shape.dim]
    n = int(np.prod(shape, dtype=np.int64))
    enum = int(tensor.dtype)
    _, dtype = tf_dtype(enum)
    field = TF_DTYPES[enum - 100 if enum > 100 else enum][2]
    bf16 = enum == _DT_BFLOAT16
    if tensor.tensor_content:
        raw = tensor.tensor_content
        if bf16:
            return _bf16_bits_to_f32(np.frombuffer(raw, np.uint16)).reshape(
                shape)
        return np.frombuffer(raw, dtype=dtype).copy().reshape(shape)
    values = getattr(tensor, field)
    if dtype is np.object_:
        values = list(values)
        if n > len(values):
            values += [values[-1] if values else b""] * (n - len(values))
        out = np.empty(len(values), dtype=np.object_)
        out[:] = values
        return out.reshape(shape)
    if field == "half_val":
        bits = np.asarray(values, dtype=np.int64).astype(np.uint16)
        arr = _bf16_bits_to_f32(bits) if bf16 else bits.view(np.float16)
    elif field in ("scomplex_val", "dcomplex_val"):
        pairs = np.asarray(values, dtype=np.float64).reshape(-1, 2)
        arr = (pairs[:, 0] + 1j * pairs[:, 1]).astype(dtype)
    else:
        arr = np.fromiter(values, dtype=dtype, count=len(values))
    if arr.size == 0:
        return np.zeros(shape, dtype)
    if arr.size != n:
        arr = np.pad(arr, (0, n - arr.size), "edge")
    return arr.reshape(shape)


#: ONNX TensorProto.DataType -> numpy dtype: the JAX importer's ``_DTYPES``
ONNX_DTYPES = {1: np.float32, 2: np.uint8, 3: np.int8, 5: np.int16,
               6: np.int32, 7: np.int64, 9: np.bool_, 10: np.float16,
               11: np.float64}


def onnx_to_array(t) -> np.ndarray:
    """An ONNX ``TensorProto`` as numpy, the JAX importer's rule: ``raw_data``
    first, else the first non-empty typed field (``float_data``,
    ``int64_data``, ``int32_data`` (float16 bit patterns there), then
    ``double_data``), else zeros."""
    dims = tuple(int(d) for d in t.dims)
    dt = ONNX_DTYPES.get(int(t.data_type))
    if dt is None:
        raise ValueError(f"unsupported ONNX tensor dtype {t.data_type}")
    if t.raw_data:
        a = np.frombuffer(t.raw_data, dtype=dt)
    elif t.float_data:
        a = np.asarray(list(t.float_data), dtype=dt)
    elif t.int64_data:
        a = np.asarray(list(t.int64_data), dtype=dt)
    elif t.int32_data:
        if int(t.data_type) == 10:  # float16 payloads are bit patterns
            a = np.asarray(list(t.int32_data), dtype=np.uint16).view(
                np.float16)
        else:
            a = np.asarray(list(t.int32_data), dtype=dt)
    elif t.double_data:
        a = np.asarray(list(t.double_data), dtype=dt)
    else:
        a = np.zeros(dims, dtype=dt)
    return a.reshape(dims)
