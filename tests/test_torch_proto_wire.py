"""The port's protobuf wire reader (``modelimport/proto/wire.py``) against
protobuf's own parse, and its tensor rules against TensorFlow's and the
JAX importer's.

1. Every committed ``tf_*.pb`` and ``onnx_*.onnx`` fixture: the reader's
   message equals protobuf's parse (``graph_pb2`` / the JAX package's
   ``onnx_min_pb2``) field by field over every field the schema tables
   name, ``HasField`` and ``WhichOneof`` included.
2. Hand-made wire bytes: negative int64 and int32 varints (ten bytes),
   packed and unpacked repeated fields, unknown fields of each wire type
   (skipped), a map entry, a message field seen twice (merged), truncated
   input (refused), each against protobuf's parse of the same bytes.
3. ``make_ndarray`` against ``tensor_util.MakeNdarray`` over TF's
   ``make_tensor_proto`` for each dtype the importer accepts: content
   bytes, typed values, one value broadcast, float16 and bfloat16 bit
   patterns, bool and string; ``onnx_to_array`` against the JAX
   importer's ``_tensor_to_np``.
4. A fresh interpreter that imports the port's ``modelimport`` and
   imports fixtures loads neither TensorFlow, protobuf, h5py nor JAX.
"""

import glob
import os
import struct
import subprocess
import sys

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.modelimport.onnx import _tensor_to_np
from deeplearning4j_tpu.modelimport.proto import onnx_min_pb2 as P
from deeplearning4j_tpu_torch.modelimport.proto import wire

tf = pytest.importorskip("tensorflow")
from tensorflow.core.framework import (attr_value_pb2,  # noqa: E402
                                       graph_pb2, node_def_pb2, tensor_pb2)
from tensorflow.python.framework import tensor_util  # noqa: E402

HERE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    """The suite runs in parallel workers: keep this module's torch CPU
    work to two threads, and restore the setting after it."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        yield
    finally:
        torch.set_num_threads(old)


def same(ours, pb, schema, mtype, path=""):
    """Field by field over the schema's fields; returns the count."""
    n = 0
    for f in schema[mtype].values():
        a, b = getattr(ours, f.name), getattr(pb, f.name)
        where = f"{path}.{f.name}"
        if f.kind == "map":
            assert set(a) == set(b), where
            for k in a:
                if f.map_value == "string":
                    assert a[k] == b[k], where
                else:
                    n += same(a[k], b[k], schema, f.message, f"{where}[{k}]")
        elif f.repeated:
            b = list(b)
            assert len(a) == len(b), where
            for i, (x, y) in enumerate(zip(a, b)):
                if f.kind == "message":
                    n += same(x, y, schema, f.message, f"{where}[{i}]")
                else:
                    assert x == y and type(x) is type(y), (where, x, y)
        elif f.kind == "message":
            assert ours.HasField(f.name) == pb.HasField(f.name), where
            n += same(a, b, schema, f.message, where)
        else:
            assert a == b and type(a) is type(b), (where, a, b)
        n += 1
    groups = {f.oneof for f in schema[mtype].values() if f.oneof}
    for g in groups:
        assert ours.WhichOneof(g) == pb.WhichOneof(g), path
    return n


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(
    HERE, "tf_*.pb"))), ids=os.path.basename)
def test_graph_def_fixture_equals_protobuf(path):
    data = open(path, "rb").read()
    pb = graph_pb2.GraphDef()
    pb.ParseFromString(data)
    ours = wire.parse_graph_def(data)
    assert same(ours, pb, wire.TF, "GraphDef") > len(pb.node)
    assert ours.HasField("library") == pb.HasField("library")
    # a protobuf object is read through its bytes
    assert same(wire.parse_graph_def(pb), pb, wire.TF, "GraphDef")


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(
    HERE, "onnx_*.onnx"))), ids=os.path.basename)
def test_onnx_fixture_equals_protobuf(path):
    data = open(path, "rb").read()
    pb = P.ModelProto()
    pb.ParseFromString(data)
    ours = wire.parse_onnx_model(data)
    assert same(ours, pb, wire.ONNX, "ModelProto") > len(pb.graph.node)
    for t, tp in zip(ours.graph.initializer, pb.graph.initializer):
        np.testing.assert_array_equal(wire.onnx_to_array(t),
                                      _tensor_to_np(tp))


def test_every_onnx_min_field_is_in_the_schema():
    """The ONNX tables are the whole of ``onnx_min.proto``."""
    for name, table in wire.ONNX.items():
        desc = P.DESCRIPTOR.message_types_by_name.get(name) or \
            P.DESCRIPTOR.message_types_by_name[name.split(".")[0]] \
            .nested_types_by_name[name.split(".")[1]]
        assert {f.number: f.name for f in desc.fields} == \
            {n: f.name for n, f in table.items()}, name


# ------------------------------------------------------- hand-made bytes

def _varint(v):
    v &= (1 << 64) - 1
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        out.append(b | (0x80 if v else 0))
        if not v:
            return bytes(out)


def _tag(num, wire_type):
    return _varint(num << 3 | wire_type)


def _len(num, payload):
    return _tag(num, 2) + _varint(len(payload)) + payload


def test_negative_varints_and_unpacked_repeats():
    # AttrValue.i = -5 (ten bytes); ListValue.i unpacked and packed mixed
    attr = _tag(3, 0) + _varint(-5)
    assert len(_varint(-5)) == 10
    pb = attr_value_pb2.AttrValue()
    pb.ParseFromString(attr)
    ours = wire.parse(attr, "AttrValue")
    assert ours.i == pb.i == -5 and ours.WhichOneof("value") == "i"
    lst = (_tag(3, 0) + _varint(-1) + _len(3, _varint(7) + _varint(-2 ** 40))
           + _tag(4, 5) + struct.pack("<f", 1.5)
           + _len(4, struct.pack("<2f", -0.25, 3.0))
           + _len(5, bytes([1, 0, 1])) + _len(2, b"ab") + _len(2, b""))
    pb = attr_value_pb2.AttrValue.ListValue()
    pb.ParseFromString(lst)
    ours = wire.parse(lst, "ListValue")
    assert ours.i == list(pb.i) == [-1, 7, -2 ** 40]
    assert ours.f == list(pb.f) == [1.5, -0.25, 3.0]
    assert ours.b == list(pb.b) == [True, False, True]
    assert ours.s == list(pb.s) == [b"ab", b""]
    # int32 (TensorProto.int_val): a negative is sign-extended to ten bytes
    t = _tag(1, 0) + _varint(3) + _len(7, _varint(-3) + _varint(2 ** 31 - 1))
    pb = tensor_pb2.TensorProto()
    pb.ParseFromString(t)
    ours = wire.parse(t, "TensorProto")
    assert ours.int_val == list(pb.int_val) == [-3, 2 ** 31 - 1]
    assert ours.dtype == pb.dtype == 3


def test_unknown_fields_skipped_and_messages_merged():
    # NodeDef with unknown fields of all four wire types, a map entry and a
    # device string (not in the schema), then the same attr key twice
    val = _len(1, _len(3, _varint(4)))          # AttrValue.list.i = [4]
    node = (_len(1, b"n") + _tag(99, 0) + _varint(-7) + _tag(98, 1)
            + b"\0" * 8 + _tag(97, 5) + b"\0" * 4 + _len(96, b"junk")
            + _len(4, b"/cpu:0") + _len(5, _len(1, b"k") + _len(2, val))
            + _len(2, b"Op") + _len(5, _len(1, b"k") + _len(
                2, _tag(3, 0) + _varint(9))))
    pb = node_def_pb2.NodeDef()
    pb.ParseFromString(node)
    ours = wire.parse(node, "NodeDef")
    same(ours, pb, wire.TF, "NodeDef")
    assert ours.attr["k"].i == 9 and ours.attr["k"].WhichOneof("value") == \
        "i"
    # a singular message field seen twice is merged
    gd = _len(2, _len(1, _len(1, _len(1, b"f1")))) + \
        _len(2, _len(1, _len(1, _len(1, b"f2"))))
    pb = graph_pb2.GraphDef()
    pb.ParseFromString(gd)
    ours = wire.parse_graph_def(gd)
    same(ours, pb, wire.TF, "GraphDef")
    assert [f.signature.name for f in ours.library.function] == ["f1", "f2"]
    with pytest.raises(ValueError):
        wire.parse_graph_def(gd[:-1])
    with pytest.raises(ValueError):
        wire.parse(_tag(1, 0) + b"\x80", "NodeDef")
    with pytest.raises(TypeError):
        wire.parse_graph_def(3)


# --------------------------------------------------------------- tensors

TF_VALUES = {
    "float32": np.array([[1.5, -2.0, 3.25], [0.0, 1e-30, -7.0]], np.float32),
    "float64": np.array([1.0, -2.5e300, 3.0]),
    "int32": np.array([[-3, 2 ** 31 - 1], [0, -2 ** 31]], np.int32),
    "int64": np.array([-2 ** 62, 5, 0], np.int64),
    "int16": np.array([-300, 12], np.int16),
    "int8": np.array([-128, 127, 3], np.int8),
    "uint8": np.array([0, 255, 7], np.uint8),
    "uint16": np.array([65535, 1], np.uint16),
    "uint32": np.array([2 ** 32 - 1, 3], np.uint32),
    "uint64": np.array([2 ** 64 - 1, 9], np.uint64),
    "bool": np.array([[True, False], [False, True]]),
    "float16": np.array([1.0, -2.5, 65504.0, 6e-8], np.float16),
    "complex64": np.array([1 + 2j, -3.5j], np.complex64),
    "complex128": np.array([2 - 1j], np.complex128),
}


def _check_tensor(proto):
    want = tensor_util.MakeNdarray(proto)
    got = wire.make_ndarray(wire.parse(proto.SerializeToString(),
                                       "TensorProto"))
    assert got.shape == want.shape
    if want.dtype.name == "bfloat16":
        assert wire.is_bfloat16(proto) and got.dtype == np.float32
        np.testing.assert_array_equal(got, want.astype(np.float32))
    elif want.dtype == object:
        assert got.dtype == object and list(got.ravel()) == list(
            want.ravel())
    else:
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", sorted(TF_VALUES))
def test_make_ndarray_matches_tensorflow(dtype):
    v = TF_VALUES[dtype]
    # content bytes (TF's default for arrays), then the typed field
    _check_tensor(tf.make_tensor_proto(v))
    typed = tf.make_tensor_proto(v)
    typed.ClearField("tensor_content")
    field = wire.TF_DTYPES[typed.dtype][2]
    if len(getattr(typed, field)):
        pass  # TF wrote the typed field itself
    elif field == "half_val":
        typed.half_val.extend(int(b) for b in v.view(np.uint16).ravel())
    elif field in ("scomplex_val", "dcomplex_val"):
        getattr(typed, field).extend(
            x for c in v.ravel() for x in (c.real, c.imag))
    else:
        getattr(typed, field).extend(v.ravel().tolist())
    _check_tensor(typed)
    # one value broadcast over the shape, and an empty typed field (zeros)
    splat = tf.make_tensor_proto(v.ravel()[0], shape=[2, 3])
    _check_tensor(splat)
    empty = tensor_pb2.TensorProto(dtype=typed.dtype)
    empty.tensor_shape.dim.add().size = 3
    _check_tensor(empty)


def test_make_ndarray_bfloat16_and_strings():
    bf = tf.constant([1.0, -2.5, 3.140625, 1e30], tf.bfloat16)
    _check_tensor(tf.make_tensor_proto(bf))
    halfs = tensor_pb2.TensorProto(dtype=14)
    halfs.tensor_shape.dim.add().size = 3
    halfs.half_val.extend([0x3F80, 0xC020])   # 1.0, -2.5, then edge-padded
    _check_tensor(halfs)
    _check_tensor(tf.make_tensor_proto([b"a", b"bc"], shape=[2, 2]))
    _check_tensor(tf.make_tensor_proto(b"msg"))


def _onnx_tensor(dtype, field, values, dims):
    t = P.TensorProto(data_type=dtype, dims=dims)
    getattr(t, field).extend(values)
    return t


@pytest.mark.parametrize("case", ["raw", "float", "int64", "int32",
                                  "fp16_bits", "double", "empty"])
def test_onnx_to_array_matches_the_jax_rule(case):
    a = np.arange(6, dtype=np.float32).reshape(2, 3) - 2.5
    t = {"raw": P.TensorProto(data_type=1, dims=[2, 3],
                              raw_data=a.tobytes()),
         "float": _onnx_tensor(1, "float_data", a.ravel(), [2, 3]),
         "int64": _onnx_tensor(7, "int64_data", [-2 ** 40, 3], [2]),
         "int32": _onnx_tensor(6, "int32_data", [-7, 9, 1], [3]),
         "fp16_bits": _onnx_tensor(10, "int32_data", [
             int(b) for b in np.float16([1.0, -2.5]).view(np.uint16)], [2]),
         "double": _onnx_tensor(11, "double_data", [1e300, -0.5], [2]),
         "empty": P.TensorProto(data_type=9, dims=[2, 2])}[case]
    got = wire.onnx_to_array(wire.parse(t.SerializeToString(),
                                        "TensorProto", wire.ONNX))
    want = _tensor_to_np(t)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------ isolation

def test_modelimport_loads_no_tensorflow_protobuf_h5py_or_jax():
    code = f"""
import sys
sys.path.insert(0, {REPO!r})
import deeplearning4j_tpu_torch.modelimport as mi
from deeplearning4j_tpu_torch.modelimport.validation import ValidationReport
import numpy as np
h = {HERE!r}
for n in ("tf_smoke", "tf_convstack", "tf_while"):
    sd = mi.TensorflowFrameworkImporter.import_file(
        h + "/" + n + ".pb", trainable=True, device="cpu")
for n in ("onnx_smoke", "onnx_lstm_corpus", "onnx_transformer_block"):
    sd = mi.OnnxFrameworkImporter.import_file(h + "/" + n + ".onnx",
                                              device="cpu")
    x = np.load(h + "/import_corpus_io.npz")["onnx_transformer_block_x"]
sd.output({{"x": x}}, sd.onnx_outputs)
bad = [m for m in ("tensorflow", "google.protobuf", "h5py", "jax")
       if m in sys.modules]
print("LOADED", bad)
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": REPO})
    assert out.returncode == 0, out.stderr[-2000:]
    assert "LOADED []" in out.stdout, out.stdout
