"""Evaluation (port of ``deeplearning4j_tpu/eval``): classification and
regression metrics."""

from .evaluation import Evaluation, RegressionEvaluation

__all__ = ["Evaluation", "RegressionEvaluation"]
