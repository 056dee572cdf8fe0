"""Evaluation (port of ``deeplearning4j_tpu/eval``): classification and
regression metrics, and the int8 quantization gate."""

from .evaluation import Evaluation, RegressionEvaluation
from .quantization import (GateResult, QuantizationGateError,
                           accuracy_delta_gate, quantization_gate)

__all__ = ["Evaluation", "RegressionEvaluation", "GateResult",
           "QuantizationGateError", "accuracy_delta_gate",
           "quantization_gate"]
