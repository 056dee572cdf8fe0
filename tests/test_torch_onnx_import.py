"""The port's ONNX importer (``modelimport/onnx.py`` on the port's wire
reader) against the JAX package's on the CPU.

1. Every committed ``onnx_*.onnx`` fixture: the port records the JAX
   import's ``graph.json`` (op names, attributes, VARIABLE / CONSTANT /
   PLACEHOLDER kinds), the same values bit for bit and the same
   ``onnx_inputs`` / ``onnx_outputs``; its outputs equal the recorded
   ones at the JAX corpus test's tolerances (``test_import_corpus.py``
   RTOL 2e-4 / ATOL 2e-5; ``test_import_smoke.py`` 1e-4 / 1e-4).
2. The in-test graphs of ``tests/test_onnx_rnn_import.py`` and
   ``tests/test_onnx_import_r4.py``: each JAX test runs as it is, with the
   JAX importer's entry point spied; every model it imports is imported
   by the port too and held to the JAX import (the same records and
   values; the outputs the test read, at the corpus tolerances; the same
   error where the JAX import refuses the model).
3. ``fuse_attention`` on the imported transformer block: the JAX
   package's report.
4. ``validate_onnx_import`` against the torch module that made a model.

The TF-built graphs and ``tests/test_tf_onnx_import.py`` (which imports
TensorFlow) are held in ``test_torch_tf_import.py``, the one port test
file that imports TensorFlow.
"""

import os
import sys

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.autodiff import fusion as jfusion
from deeplearning4j_tpu.modelimport.onnx import \
    OnnxFrameworkImporter as JOnnx
from deeplearning4j_tpu_torch.autodiff import fusion
from deeplearning4j_tpu_torch.modelimport import OnnxFrameworkImporter
from deeplearning4j_tpu_torch.modelimport.validation import \
    validate_onnx_import

HERE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
RTOL, ATOL = 2e-4, 2e-5          # tests/test_import_corpus.py
SMOKE_RTOL, SMOKE_ATOL = 1e-4, 1e-4   # tests/test_import_smoke.py
ONNX_FIXTURES = ("onnx_groupedconv", "onnx_lstm_corpus", "onnx_bigru",
                 "onnx_clipsoftmax_op9", "onnx_clipsoftmax_op13",
                 "onnx_transformer_block")


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


@pytest.fixture
def _onnx_stub_removed_after():
    """``tests/test_onnx_import_r4.py`` exports with torch's exporter
    through the JAX package's ``onnx`` module stub: take the stub out of
    ``sys.modules`` again after the test, so it leaks into no other test
    of the worker."""
    had = sys.modules.get("onnx")
    yield
    if had is None:
        sys.modules.pop("onnx", None)
    else:
        sys.modules["onnx"] = had


def _np(v):
    a = np.asarray(v)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def same_graph(sd, jsd_json, jsd_values):
    """The port's import records the JAX import's graph and values."""
    assert sd.to_json() == jsd_json
    assert sorted(sd._values) == sorted(jsd_values)
    for n, v in jsd_values.items():
        got = sd.get_value(n)
        assert got.shape == v.shape, n
        np.testing.assert_array_equal(got, v, err_msg=n)


class ImportSpy:
    """Wraps the JAX importer entry point ``cls.attr`` for one test: it
    records every import (its arguments, and the JAX graph's
    ``graph.json`` and values at import, or the error) and every
    ``output`` call the test makes on that graph before a ``fit``.
    :meth:`check` imports each recorded model with ``port_import`` and
    holds it to the record."""

    def __init__(self, monkeypatch, cls, attr):
        self.records = []
        orig = getattr(cls, attr)

        def spy(data, *args, **kwargs):
            rec = {"data": data, "args": args, "kwargs": kwargs,
                   "outputs": []}
            self.records.append(rec)
            try:
                sd = orig(data, *args, **kwargs)
            except Exception as e:
                rec["error"] = e
                raise
            rec["json"] = sd.to_json()
            rec["values"] = {n: _np(v) for n, v in sd._values.items()}
            output, fit = sd.output, sd.fit

            def spied_output(feeds, targets):
                res = output(feeds, targets)
                if not rec.get("fitted"):
                    rec["outputs"].append((dict(feeds), list(targets), {
                        k: _np(v) for k, v in res.items()}))
                return res

            def spied_fit(*a, **k):
                rec["fitted"] = True
                return fit(*a, **k)
            sd.output, sd.fit = spied_output, spied_fit
            return sd
        monkeypatch.setattr(cls, attr, staticmethod(spy))

    def check(self, port_import, rtol=RTOL, atol=ATOL):
        assert self.records, "the JAX test imported nothing"
        for rec in self.records:
            if "error" in rec:
                with pytest.raises(type(rec["error"])) as got:
                    port_import(rec["data"], *rec["args"], **rec["kwargs"],
                                device="cpu")
                assert str(got.value) == str(rec["error"])
                continue
            sd = port_import(rec["data"], *rec["args"], **rec["kwargs"],
                             device="cpu")
            same_graph(sd, rec["json"], rec["values"])
            for feeds, targets, want in rec["outputs"]:
                got = sd.output(feeds, targets)
                for t in targets:
                    assert got[t].shape == want[t].shape, t
                    np.testing.assert_allclose(got[t], want[t], rtol=rtol,
                                               atol=atol, err_msg=t)
        return len(self.records)


# ------------------------------------------------------------- fixtures

def _import(name):
    path = os.path.join(HERE, name + ".onnx")
    return (OnnxFrameworkImporter.import_file(path, device="cpu"),
            JOnnx.import_file(path))


@pytest.mark.parametrize("name", ONNX_FIXTURES)
def test_onnx_fixture_matches_jax(name):
    sd, jsd = _import(name)
    same_graph(sd, jsd.to_json(), {n: _np(v) for n, v in
                                   jsd._values.items()})
    assert sd.onnx_inputs == jsd.onnx_inputs
    assert sd.onnx_outputs == jsd.onnx_outputs
    io_ = np.load(os.path.join(HERE, "import_corpus_io.npz"))
    out = sd.onnx_outputs[-1]
    got = sd.output({"x": io_[name + "_x"]}, [out])[out]
    want = io_[name + "_y"]
    jgot = np.asarray(jsd.output({"x": io_[name + "_x"]}, [out])[out])
    np.testing.assert_allclose(got, jgot, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.reshape(want.shape), want, rtol=RTOL,
                               atol=ATOL)


def test_onnx_smoke_fixture_matches_jax():
    sd, jsd = _import("onnx_smoke")
    same_graph(sd, jsd.to_json(), {n: _np(v) for n, v in
                                   jsd._values.items()})
    io_ = np.load(os.path.join(HERE, "import_smoke_io.npz"))
    out = sd.onnx_outputs[0]
    got = sd.output({"x": io_["onnx_x"]}, [out])[out]
    np.testing.assert_allclose(got, io_["onnx_y"], rtol=SMOKE_RTOL,
                               atol=SMOKE_ATOL)
    # the initializers are VARIABLEs, the inputs placeholders
    assert sd.variables() == jsd.variables() and sd.variables()


def test_protobuf_object_reads_as_its_bytes():
    from deeplearning4j_tpu.modelimport.proto import onnx_min_pb2 as P
    data = open(os.path.join(HERE, "onnx_smoke.onnx"), "rb").read()
    model = P.ModelProto()
    model.ParseFromString(data)
    a = OnnxFrameworkImporter.import_model_proto(model, device="cpu")
    b = OnnxFrameworkImporter.import_model_proto(data, device="cpu")
    assert a.to_json() == b.to_json()


def test_fuse_attention_on_the_transformer_block_matches_jax():
    sd, jsd = _import("onnx_transformer_block")
    rep, jrep = fusion.fuse_attention(sd), jfusion.fuse_attention(jsd)
    assert (rep.matched, rep.unmatched) == (jrep.matched, jrep.unmatched)
    assert rep.reasons == jrep.reasons
    assert sd.to_json() == jsd.to_json()
    x = np.load(os.path.join(HERE, "import_corpus_io.npz"))[
        "onnx_transformer_block_x"]
    out = sd.onnx_outputs[-1]
    np.testing.assert_allclose(sd.output({"x": x}, [out])[out],
                               np.asarray(jsd.output({"x": x}, [out])[out]),
                               rtol=RTOL, atol=ATOL)


# ------------------------------------------------------- in-test graphs

def _jax_tests(module):
    import importlib
    mod = importlib.import_module(module)
    return [(module, n) for n in sorted(dir(mod)) if n.startswith("test_")]


def _run_jax_test(module, name, tmp_path):
    import importlib
    import inspect
    fn = getattr(importlib.import_module(module), name)
    marks = {m.name: m for m in getattr(fn, "pytestmark", [])}
    if "parametrize" in marks:
        argname, values = marks["parametrize"].args[:2]
        for v in values:
            fn(**{argname: v})
        return
    params = inspect.signature(fn).parameters
    fn(**({"tmp_path": tmp_path} if "tmp_path" in params else {}))


@pytest.mark.parametrize("module,name", _jax_tests("test_onnx_rnn_import")
                         + _jax_tests("test_onnx_import_r4"))
def test_jax_onnx_tests_graphs_match(module, name, monkeypatch, tmp_path,
                                     _onnx_stub_removed_after):
    spy = ImportSpy(monkeypatch, JOnnx, "import_model_proto")
    _run_jax_test(module, name, tmp_path)
    spy.check(OnnxFrameworkImporter.import_model_proto)


# ---------------------------------------------------------- validation

def test_validate_onnx_import_against_the_torch_module(
        _onnx_stub_removed_after):
    """``validate_onnx_import`` with the torch module that made the model
    as its oracle (``tests/test_onnx_import_r4.py``'s export)."""
    from test_onnx_import_r4 import _export
    torch.manual_seed(7)
    net = torch.nn.Sequential(torch.nn.Conv2d(3, 4, 3, padding=1),
                              torch.nn.ReLU(), torch.nn.Flatten(),
                              torch.nn.Linear(4 * 6 * 6, 5)).eval()
    x = np.random.default_rng(0).normal(size=(2, 3, 6, 6)).astype(
        np.float32)
    data = _export(net, torch.from_numpy(x), 13)
    rep = validate_onnx_import(data, net, {"x": x}, device="cpu")
    assert rep.ok, rep.summary()
    assert max(rep.max_abs_diff.values()) < 1e-5
    bad = validate_onnx_import(data, torch.nn.Identity(), {"x": x},
                               device="cpu")
    assert not bad.ok
    assert bad.summary().startswith(("MISMATCH", "FAILED"))
