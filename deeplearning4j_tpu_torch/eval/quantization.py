"""The quantization accuracy-delta gate.

Port of ``deeplearning4j_tpu/eval/quantization.py``. Int8 serving changes
the numbers, so the gate measures what it costs before an int8 engine
takes traffic: with labels, the ACCURACY delta (baseline - quantized)
through two :class:`~.evaluation.Evaluation` accumulators; without, the
top-1 DISAGREEMENT rate of the two predictors. A failing gate raises
:class:`QuantizationGateError` unless the caller asks for the result
(``raise_on_fail=False``); a deliberately broken quantizer trips it.

Divergence: the JAX module writes the delta to the
``serving.quantize.gate_delta`` gauge and counts failures in
``serving.quantize.gate_failures``; the port has no telemetry registry
(ROADMAP.md Queue 1 item 9), so the last delta and the failure count are
the plain module values :func:`last_delta` and :func:`gate_failures`, by
``cell_labels``.
"""

from __future__ import annotations

import threading
from typing import Callable, Optional, Sequence

import numpy as np

_lock = threading.Lock()
_DELTAS: dict = {}
_FAILURES: dict = {}


def _cell(labels: dict) -> tuple:
    return tuple(sorted(labels.items()))


def last_delta(**labels) -> Optional[float]:
    """The last delta a gate measured under ``labels`` (None: none
    yet)."""
    with _lock:
        return _DELTAS.get(_cell(labels))


def gate_failures(**labels) -> int:
    """Gate failures under ``labels``; with no labels, over all cells."""
    with _lock:
        if not labels:
            return sum(_FAILURES.values())
        return _FAILURES.get(_cell(labels), 0)


class QuantizationGateError(AssertionError):
    """The quantized engine's accuracy delta exceeded the gate."""


class GateResult:
    """What the gate measured: ``delta`` is accuracy_baseline -
    accuracy_quantized with labels, else the top-1 disagreement rate;
    ``passed`` is ``delta <= max_delta``."""

    def __init__(self, delta: float, max_delta: float, n: int,
                 accuracy_baseline: Optional[float] = None,
                 accuracy_quantized: Optional[float] = None,
                 cell_labels: Optional[dict] = None):
        self.delta = float(delta)
        self.max_delta = float(max_delta)
        self.examples = int(n)
        self.accuracy_baseline = accuracy_baseline
        self.accuracy_quantized = accuracy_quantized
        self.cell_labels = dict(cell_labels or {})

    @property
    def passed(self) -> bool:
        return self.delta <= self.max_delta

    def __repr__(self):
        verdict = "PASS" if self.passed else "FAIL"
        return (f"GateResult({verdict}: delta={self.delta:.4f} vs "
                f"max {self.max_delta:.4f} over {self.examples} examples)")


def accuracy_delta_gate(predict_baseline: Callable, predict_quantized:
                        Callable, batches: Sequence, labels:
                        Optional[Sequence] = None, max_delta: float = 0.01,
                        raise_on_fail: bool = True,
                        cell_labels: Optional[dict] = None) -> GateResult:
    """Run both predictors over ``batches`` (each a features array; the
    predictors return class scores ``[B, ..., C]``) and compare: the
    accuracy delta with ``labels`` (one-hot or index per batch), else the
    top-1 disagreement rate."""
    from .evaluation import Evaluation
    ev_b, ev_q = Evaluation(), Evaluation()
    agree = total = 0
    for i, x in enumerate(batches):
        out_b = np.asarray(predict_baseline(x))
        out_q = np.asarray(predict_quantized(x))
        top_b = np.argmax(out_b, axis=-1)
        top_q = np.argmax(out_q, axis=-1)
        agree += int(np.sum(top_b == top_q))
        total += int(top_b.size)
        if labels is not None:
            y = np.asarray(labels[i])
            if y.ndim == out_b.ndim - 1:  # index labels -> one-hot
                y = np.eye(out_b.shape[-1], dtype=np.float32)[
                    y.astype(int)]
            ev_b.eval(y, out_b)
            ev_q.eval(y, out_q)
    cl = dict(cell_labels or {})
    if labels is not None:
        acc_b, acc_q = ev_b.accuracy(), ev_q.accuracy()
        result = GateResult(acc_b - acc_q, max_delta, total,
                            accuracy_baseline=acc_b,
                            accuracy_quantized=acc_q, cell_labels=cl)
    else:
        delta = 1.0 - (agree / total if total else 1.0)
        result = GateResult(delta, max_delta, total, cell_labels=cl)
    with _lock:
        _DELTAS[_cell(cl)] = result.delta
        if not result.passed:
            _FAILURES[_cell(cl)] = _FAILURES.get(_cell(cl), 0) + 1
    if not result.passed and raise_on_fail:
        raise QuantizationGateError(
            f"quantized accuracy delta {result.delta:.4f} exceeds the "
            f"gate {max_delta:.4f} ({result.examples} examples)")
    return result


def quantization_gate(model, features, labels=None, max_delta: float = 0.01,
                      buckets: Optional[Sequence[int]] = None,
                      raise_on_fail: bool = True) -> GateResult:
    """Gate one model's int8 engine (``InferenceEngine(quantize="int8")``)
    against its f32 engine, both warmed on the same buckets, on the
    model's device. ``features``: one array or a list of batch arrays;
    ``labels`` optional (accuracy delta), else top-1 agreement."""
    from ..serving.engine import InferenceEngine, next_bucket
    batches = features if isinstance(features, (list, tuple)) \
        else [features]
    if labels is not None and not isinstance(labels, (list, tuple)):
        labels = [labels]
    if buckets is None:
        buckets = sorted({next_bucket(np.asarray(b).shape[0])
                          for b in batches})
    dev = model.device
    base = InferenceEngine(model, device=dev).warmup(buckets)
    quant = InferenceEngine(model, device=dev,
                            quantize="int8").warmup(buckets)
    return accuracy_delta_gate(base.output, quant.output, batches,
                               labels=labels, max_delta=max_delta,
                               raise_on_fail=raise_on_fail,
                               cell_labels={"engine": str(id(quant)),
                                            "pool": "default"})
