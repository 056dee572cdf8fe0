"""Network configuration DSL: ``InputType`` and the builder.

Port of the parts of ``deeplearning4j_tpu/nn/config.py`` that the
ComputationGraph path uses. The updater is an ``nn.updaters.Updater``
(the builder also takes an updater's name, or its serialized dict as a
JAX ``configuration.json`` holds it).
"""

from __future__ import annotations

from typing import Tuple

from . import gradnorm as _gn
from . import updaters as _upd


class InputType:
    """DL4J InputType equivalent: shape WITHOUT batch dim (the
    convolutional kind; the others come with the slices that use them)."""

    @staticmethod
    def convolutional(channels: int, height: int, width: int,
                      data_format: str = "NCHW") -> Tuple[int, ...]:
        return (channels, height, width) if data_format == "NCHW" else \
               (height, width, channels)


class NeuralNetConfiguration:
    """Builder (DL4J ``new NeuralNetConfiguration.Builder()``), the subset a
    ComputationGraph needs: seed, data type, updater, l1/l2, gradient
    normalization and clipping, constraints, ``tbptt_length`` and
    ``workspace_mode`` (the last two are refused by ``fit`` in this
    slice)."""

    def __init__(self):
        self._seed = 1234
        self._dtype = "FLOAT"
        self._updater = _upd.Sgd(learning_rate=0.1)
        self._l1 = 0.0
        self._l2 = 0.0
        self._clip_value = None
        self._clip_l2 = None
        self._grad_norm = None
        self._grad_norm_threshold = 1.0
        self._tbptt = None
        self._constraints = []
        self._workspace_mode = "none"

    @staticmethod
    def builder() -> "NeuralNetConfiguration":
        return NeuralNetConfiguration()

    def seed(self, s: int):
        self._seed = int(s)
        return self

    def data_type(self, dtype: str):
        self._dtype = dtype
        return self

    def updater(self, u):
        """An :class:`~.updaters.Updater`, an updater's name, or its
        serialized dict (``{"kind": "adam", ...}``)."""
        if isinstance(u, dict):
            u = _upd.Updater.from_dict(u)
        self._updater = _upd.get(u)
        return self

    def l1(self, v: float):
        self._l1 = v
        return self

    def l2(self, v: float):
        self._l2 = v
        return self

    def gradient_clip_value(self, v: float):
        self._clip_value = v
        return self

    def gradient_clip_l2(self, v: float):
        self._clip_l2 = v
        return self

    def gradient_normalization(self, mode: str, threshold: float = 1.0):
        """A DL4J GradientNormalization mode (``gradnorm.MODES``);
        ``threshold`` feeds the Clip* modes."""
        _gn.validate(mode)
        self._grad_norm = mode
        self._grad_norm_threshold = float(threshold)
        return self

    def tbptt_length(self, n: int):
        self._tbptt = n
        return self

    def workspace_mode(self, mode: str):
        self._workspace_mode = str(mode).strip().lower()
        return self

    def constrain_weights(self, *cs):
        """Constraints on the weight params after every update (DL4J
        ``constrainWeights``)."""
        self._constraints.extend((c, "weights") for c in cs)
        return self

    def constrain_bias(self, *cs):
        self._constraints.extend((c, "bias") for c in cs)
        return self

    def constrain_all_parameters(self, *cs):
        self._constraints.extend((c, "all") for c in cs)
        return self

    def graph_builder(self):
        """DAG config builder carrying this builder's seed/updater/etc.
        (DL4J ``.graphBuilder()``)."""
        from .graph import GraphBuilder
        return GraphBuilder(self)
