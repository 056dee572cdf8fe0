"""Import validation: run the source framework's model and diff our
import against it.

Port of ``deeplearning4j_tpu/modelimport/validation.py``:

- :func:`validate_onnx_import` imports ONNX bytes and diffs the outputs
  against the torch module that produced them (the oracle; there is no
  onnxruntime);
- :class:`TensorflowGraphRunner` runs a frozen GraphDef under TensorFlow
  and :func:`validate_tf_import` diffs our import against it. TensorFlow
  is imported inside those calls only, and a missing TensorFlow raises
  ``ImportError`` saying so: nothing else of the port reaches it (the
  importers read GraphDefs with ``proto/wire.py``).

Usage::

    from deeplearning4j_tpu_torch.modelimport.validation import (
        validate_onnx_import, validate_tf_import)

    report = validate_tf_import(graph_def, {"x": x}, ["out"], device="cpu")
    assert report.ok, report.summary()
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np


@dataclass
class ValidationReport:
    """Per-output numeric diff between the source framework and our import."""
    ok: bool
    max_abs_diff: Dict[str, float] = field(default_factory=dict)
    max_rel_diff: Dict[str, float] = field(default_factory=dict)
    shapes: Dict[str, tuple] = field(default_factory=dict)
    atol: float = 1e-4
    rtol: float = 1e-4
    error: Optional[str] = None

    def summary(self) -> str:
        if self.error:
            return f"FAILED: {self.error}"
        lines = [f"{'OK' if self.ok else 'MISMATCH'} "
                 f"(atol={self.atol}, rtol={self.rtol})"]
        for name in self.max_abs_diff:
            lines.append(
                f"  {name}: shape={self.shapes.get(name)} "
                f"max_abs={self.max_abs_diff[name]:.3e} "
                f"max_rel={self.max_rel_diff[name]:.3e}")
        return "\n".join(lines)


def _tensorflow():
    try:
        import tensorflow as tf
    except ImportError as e:
        raise ImportError(
            "TensorflowGraphRunner and validate_tf_import run the GraphDef "
            "under TensorFlow as the oracle, and TensorFlow is not "
            "installed; the port's importers themselves need no "
            "TensorFlow") from e
    return tf


class TensorflowGraphRunner:
    """Run a frozen TF GraphDef under TensorFlow (nd4j-tensorflow's
    ``GraphRunner``). Raises ImportError without TensorFlow."""

    def __init__(self, graph_def, input_names: Sequence[str],
                 output_names: Sequence[str]):
        tf = _tensorflow()
        if isinstance(graph_def, (bytes, bytearray)):
            from tensorflow.core.framework import graph_pb2
            gd = graph_pb2.GraphDef()
            gd.ParseFromString(bytes(graph_def))
            graph_def = gd
        self._tf = tf
        self.graph_def = graph_def
        self.input_names = list(input_names)
        self.output_names = list(output_names)

        def _import():
            self._tf.graph_util.import_graph_def(self.graph_def, name="")

        def tensor_name(n: str) -> str:
            # bare op names address output 0; "op:1"-style names pass
            # through so non-default outputs stay reachable
            return n if ":" in n else f"{n}:0"

        wrapped = tf.compat.v1.wrap_function(_import, [])
        self._fn = wrapped.prune(
            [tensor_name(n) for n in self.input_names],
            [tensor_name(n) for n in self.output_names])

    def run(self, feeds: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        args = [self._tf.constant(feeds[n]) for n in self.input_names]
        outs = self._fn(*args)
        return {n: np.asarray(o)
                for n, o in zip(self.output_names, outs)}


def _diff(ref: Dict[str, np.ndarray], got: Dict[str, np.ndarray],
          atol: float, rtol: float) -> ValidationReport:
    rep = ValidationReport(ok=True, atol=atol, rtol=rtol)
    for name, r in ref.items():
        g = np.asarray(got[name])
        r = np.asarray(r)
        rep.shapes[name] = tuple(g.shape)
        if g.shape != r.shape:
            rep.ok = False
            rep.error = (f"{name}: shape mismatch ours {g.shape} "
                         f"vs source {r.shape}")
            return rep
        ad = np.abs(g.astype(np.float64) - r.astype(np.float64))
        rep.max_abs_diff[name] = float(ad.max()) if ad.size else 0.0
        denom = np.maximum(np.abs(r.astype(np.float64)), 1e-12)
        rep.max_rel_diff[name] = float((ad / denom).max()) if ad.size else 0.0
        if not np.allclose(g, r, atol=atol, rtol=rtol):
            rep.ok = False
    return rep


def validate_tf_import(graph_def, feeds: Dict[str, np.ndarray],
                       output_names: Sequence[str], atol: float = 1e-4,
                       rtol: float = 1e-4, device=None) -> ValidationReport:
    """Import a GraphDef with our TF importer (on ``device``) and run it
    under TensorFlow; diff every requested output. Raises ImportError
    without TensorFlow."""
    from .tensorflow import TensorflowFrameworkImporter
    _tensorflow()
    try:
        runner = TensorflowGraphRunner(graph_def, list(feeds), output_names)
        ref = runner.run(feeds)
        sd = TensorflowFrameworkImporter.import_graph_def(runner.graph_def,
                                                          device=device)
        got = sd.output(feeds, list(output_names))
        return _diff(ref, got, atol, rtol)
    except Exception as e:
        return ValidationReport(ok=False, atol=atol, rtol=rtol,
                                error=f"{type(e).__name__}: {e}")


def validate_onnx_import(onnx_bytes, torch_module, feeds: Dict[str, np.ndarray],
                         atol: float = 1e-4, rtol: float = 1e-4,
                         device=None) -> ValidationReport:
    """Import ONNX bytes with our importer (on ``device``) and diff
    against the producing torch module's forward on the CPU (torch is the
    oracle; there is no onnxruntime)."""
    import torch
    from .onnx import OnnxFrameworkImporter
    try:
        sd = OnnxFrameworkImporter.import_model_proto(onnx_bytes,
                                                      device=device)
        out_names = list(sd.onnx_outputs)
        got = sd.output(feeds, out_names)
        # feed the torch oracle in the ONNX graph's declared input order,
        # not the feeds dict's insertion order
        args = [torch.from_numpy(np.asarray(feeds[n]))
                for n in sd.onnx_inputs]
        with torch.no_grad():
            ref_t = torch_module(*args)
        if isinstance(ref_t, (tuple, list)):
            ref_vals = [np.asarray(r) for r in ref_t]
        else:
            ref_vals = [ref_t.numpy()]
        if len(ref_vals) != len(out_names):
            return ValidationReport(
                ok=False, atol=atol, rtol=rtol,
                error=f"oracle returned {len(ref_vals)} outputs, ONNX "
                      f"graph declares {len(out_names)} ({out_names})")
        ref = dict(zip(out_names, ref_vals))
        return _diff(ref, got, atol, rtol)
    except Exception as e:
        return ValidationReport(ok=False, atol=atol, rtol=rtol,
                                error=f"{type(e).__name__}: {e}")
