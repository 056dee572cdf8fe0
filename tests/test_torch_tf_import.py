"""The port's TF GraphDef importer (``modelimport/tensorflow.py`` on the
port's wire reader) against the JAX package's on the CPU. The one port
test file that imports TensorFlow.

1. Every committed ``tf_*.pb`` fixture, ``trainable`` off and on: the port
   records the JAX import's ``graph.json`` (op names, attributes, the
   VARIABLE / CONSTANT split), the same values bit for bit, and outputs
   equal to the recorded ones at the JAX tests' tolerances
   (``test_import_corpus.py`` RTOL 2e-4 / ATOL 2e-5, ``test_import_smoke
   .py`` 1e-4 / 1e-4); ``tf_while.pb`` runs its loop.
2. The in-test graphs of ``tests/test_tf_import_controlflow.py`` and
   ``tests/test_tf_onnx_import.py`` (TF's and ONNX's): each JAX test runs
   as it is with the JAX importers' entry points spied
   (``test_torch_onnx_import.ImportSpy``), and every graph it imports is
   imported by the port too and held to the JAX import, errors included.
3. ``TensorflowGraphRunner`` and ``validate_tf_import`` (TensorFlow is
   the oracle there).
"""

import os

import numpy as np
import pytest
import torch

pytest.importorskip("tensorflow")

from deeplearning4j_tpu.modelimport.onnx import \
    OnnxFrameworkImporter as JOnnx  # noqa: E402
from deeplearning4j_tpu.modelimport.tensorflow import \
    TensorflowFrameworkImporter as JTF  # noqa: E402
from deeplearning4j_tpu_torch.modelimport import (  # noqa: E402
    OnnxFrameworkImporter, TensorflowFrameworkImporter)
from deeplearning4j_tpu_torch.modelimport.validation import (  # noqa: E402
    TensorflowGraphRunner, validate_tf_import)
from test_torch_onnx_import import (RTOL, ATOL, SMOKE_ATOL,  # noqa: E402
                                    SMOKE_RTOL, ImportSpy, _np,
                                    _run_jax_test, _jax_tests, same_graph)

HERE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
TF_FIXTURES = ("tf_smoke", "tf_convstack", "tf_while")


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


def _io(name):
    if name == "tf_smoke":
        d = np.load(os.path.join(HERE, "import_smoke_io.npz"))
        return (d["tf_x"], str(d["tf_in"]), str(d["tf_out"]), d["tf_y"],
                SMOKE_RTOL, SMOKE_ATOL)
    d = np.load(os.path.join(HERE, "import_corpus_io.npz"))
    return (d[name + "_x"], str(d[name + "_in"]), str(d[name + "_out"]),
            d[name + "_y"], RTOL, ATOL)


@pytest.mark.parametrize("trainable", [False, True])
@pytest.mark.parametrize("name", TF_FIXTURES)
def test_tf_fixture_matches_jax(name, trainable):
    data = open(os.path.join(HERE, name + ".pb"), "rb").read()
    sd = TensorflowFrameworkImporter.import_graph_def(
        data, trainable=trainable, device="cpu")
    jsd = JTF.import_graph_def(data, trainable=trainable)
    same_graph(sd, jsd.to_json(), {n: _np(v) for n, v in
                                   jsd._values.items()})
    assert sd.variables() == jsd.variables()
    if trainable and name != "tf_while":
        assert sd.variables()  # the weights became VARIABLEs
    x, i, o, y, rtol, atol = _io(name)
    got = sd.output({i: x}, [o])[o]
    np.testing.assert_allclose(got, y, rtol=rtol, atol=atol)
    np.testing.assert_allclose(got, np.asarray(jsd.output({i: x}, [o])[o]),
                               rtol=RTOL, atol=ATOL)
    if name == "tf_while":
        # the loop ran on the host's reads of its condition
        assert sd.host_syncs > 1
        assert "__while__" in {r.op for r in sd._ops}


def test_import_file_and_protobuf_objects_read_as_bytes():
    from tensorflow.core.framework import graph_pb2
    path = os.path.join(HERE, "tf_convstack.pb")
    gd = graph_pb2.GraphDef()
    gd.ParseFromString(open(path, "rb").read())
    a = TensorflowFrameworkImporter.import_graph_def(gd, device="cpu")
    b = TensorflowFrameworkImporter.import_file(path, device="cpu")
    assert a.to_json() == b.to_json() == JTF.import_file(path).to_json()


@pytest.mark.parametrize("module,name",
                         _jax_tests("test_tf_import_controlflow")
                         + _jax_tests("test_tf_onnx_import"))
def test_jax_tf_tests_graphs_match(module, name, monkeypatch, tmp_path):
    tf_spy = ImportSpy(monkeypatch, JTF, "import_graph_def")
    onnx_spy = ImportSpy(monkeypatch, JOnnx, "import_model_proto")
    _run_jax_test(module, name, tmp_path)
    if tf_spy.records:
        tf_spy.check(TensorflowFrameworkImporter.import_graph_def)
    if onnx_spy.records:
        onnx_spy.check(OnnxFrameworkImporter.import_model_proto)
    assert tf_spy.records or onnx_spy.records or name == \
        "test_onnx_fp16_int32data_bit_reinterpreted"


def test_validate_tf_import_against_tensorflow():
    data = open(os.path.join(HERE, "tf_convstack.pb"), "rb").read()
    x, i, o, _, _, _ = _io("tf_convstack")
    ref = TensorflowGraphRunner(data, [i], [o]).run({i: x})[o]
    rep = validate_tf_import(data, {i: x}, [o], device="cpu")
    assert rep.ok, rep.summary()
    assert rep.shapes[o] == ref.shape
    assert rep.max_abs_diff[o] < 1e-4
