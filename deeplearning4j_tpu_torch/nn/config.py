"""Network configuration DSL: ``InputType``, ``MultiLayerConfiguration``
and the builder.

Port of ``deeplearning4j_tpu/nn/config.py``: the ``InputType`` kinds, the
sequential ``MultiLayerConfiguration`` with its JSON both ways (the same
keys, so a JAX ``configuration.json`` loads unchanged), and the builder's
``list(...)``/``build()`` (with the net-level ``tbptt_length`` stamped onto
the recurrent layers) and ``graph_builder()``. The updater is an
``nn.updaters.Updater`` (the builder also takes an updater's name, or its
serialized dict as a JAX ``configuration.json`` holds it).

``build()`` inserts a ``FlattenLayer`` at every convolution -> dense seam
of a sequential network (DL4J's CnnToFeedForwardPreProcessor, the JAX
package's ``_auto_flatten``), propagating the shape through each layer's
own ``initialize`` on the ``meta`` device.

The builder's ``optimization_algo(name, iterations=,
max_line_search_iterations=)`` picks the SGD step or a solver of
``optimize/solvers.py`` (a sequential network's only: ``graph_builder()``
refuses a solver, as the JAX builder does), and ``workspace_mode`` a
rematerialization policy of ``nn/memory.py``, validated as it is set.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, List, Optional, Tuple

import torch

from . import constraints as _constraints
from . import gradnorm as _gn
from . import updaters as _upd
from .layers.base import Layer
from .layers.core import DenseLayer, FlattenLayer, OutputLayer


class InputType:
    """DL4J InputType equivalent: shape WITHOUT batch dim."""

    @staticmethod
    def feed_forward(n: int) -> Tuple[int, ...]:
        return (n,)

    @staticmethod
    def convolutional(channels: int, height: int, width: int,
                      data_format: str = "NCHW") -> Tuple[int, ...]:
        return (channels, height, width) if data_format == "NCHW" else \
               (height, width, channels)

    @staticmethod
    def convolutional3d(channels: int, depth: int, height: int, width: int,
                        data_format: str = "NCDHW") -> Tuple[int, ...]:
        return ((channels, depth, height, width) if data_format == "NCDHW"
                else (depth, height, width, channels))

    @staticmethod
    def recurrent(n_features: int,
                  timesteps: Optional[int] = None) -> Tuple[int, ...]:
        # timesteps None -> dynamic; shape convention [T, F]
        return (timesteps or -1, n_features)


@dataclasses.dataclass
class MultiLayerConfiguration:
    """Immutable sequential network description (the thing that
    serializes), field for field the JAX package's."""
    layers: List[Layer]
    input_shape: Optional[Tuple[int, ...]] = None
    seed: int = 1234
    dtype: str = "FLOAT"
    updater: Any = None                     # Updater instance
    l1: float = 0.0                         # net-level defaults
    l2: float = 0.0
    gradient_clip_value: Optional[float] = None
    gradient_clip_l2: Optional[float] = None
    gradient_normalization: Optional[str] = None
    gradient_normalization_threshold: float = 1.0
    tbptt_length: Optional[int] = None
    constraints: Any = None                 # [(BaseConstraint, scope)]
    optimization_algo: str = "SGD"
    solver_iterations: int = 5
    max_line_search_iterations: int = 5
    workspace_mode: str = "none"

    def to_json(self) -> str:
        d = {
            "format_version": 1,
            "model_class": "MultiLayerNetwork",
            "seed": self.seed,
            "dtype": self.dtype,
            "input_shape": list(self.input_shape) if self.input_shape
            else None,
            "updater": self.updater.to_dict() if self.updater else None,
            "l1": self.l1,
            "l2": self.l2,
            "gradient_clip_value": self.gradient_clip_value,
            "gradient_clip_l2": self.gradient_clip_l2,
            "gradient_normalization": self.gradient_normalization,
            "gradient_normalization_threshold":
                self.gradient_normalization_threshold,
            "tbptt_length": self.tbptt_length,
            "constraints": _constraints.encode_constraints(self.constraints),
            "optimization_algo": self.optimization_algo,
            "solver_iterations": self.solver_iterations,
            "max_line_search_iterations": self.max_line_search_iterations,
            "workspace_mode": self.workspace_mode,
            "layers": [l.to_dict() for l in self.layers],
        }
        return json.dumps(d, indent=2)

    @staticmethod
    def from_json(s: str) -> "MultiLayerConfiguration":
        d = json.loads(s)
        return MultiLayerConfiguration(
            layers=[Layer.from_dict(ld) for ld in d["layers"]],
            input_shape=tuple(d["input_shape"]) if d.get("input_shape")
            else None,
            seed=d.get("seed", 1234),
            dtype=d.get("dtype", "FLOAT"),
            updater=_upd.Updater.from_dict(d["updater"])
            if d.get("updater") else None,
            l1=d.get("l1", 0.0),
            l2=d.get("l2", 0.0),
            gradient_clip_value=d.get("gradient_clip_value"),
            gradient_clip_l2=d.get("gradient_clip_l2"),
            gradient_normalization=d.get("gradient_normalization"),
            gradient_normalization_threshold=d.get(
                "gradient_normalization_threshold", 1.0),
            tbptt_length=d.get("tbptt_length"),
            constraints=_constraints.decode_constraints(
                d.get("constraints")),
            optimization_algo=d.get("optimization_algo", "SGD"),
            solver_iterations=d.get("solver_iterations", 5),
            max_line_search_iterations=d.get("max_line_search_iterations",
                                             5),
            workspace_mode=d.get("workspace_mode", "none"),
        )


class NeuralNetConfiguration:
    """Builder (DL4J ``new NeuralNetConfiguration.Builder()``): seed, data
    type, updater, l1/l2, gradient normalization and clipping,
    constraints, ``tbptt_length``, ``workspace_mode``, the input type and
    the layer list; ``build()`` gives a :class:`MultiLayerConfiguration`,
    ``graph_builder()`` a ComputationGraph builder."""

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
        self._opt_algo = "SGD"
        self._solver_iterations = 5
        self._max_ls_iterations = 5
        self._layers: List[Layer] = []
        self._input_shape = None

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

    def optimization_algo(self, name: str, iterations: int = 5,
                          max_line_search_iterations: int = 5):
        """DL4J ``optimizationAlgo(OptimizationAlgorithm.X)``: SGD (the
        default step of ``fit``) or LBFGS / CONJUGATE_GRADIENT /
        LINE_GRADIENT_DESCENT (``Solver.optimize`` a batch)."""
        name = str(name).upper()
        if name not in ("SGD", "STOCHASTIC_GRADIENT_DESCENT"):
            from ..optimize.solvers import get_solver
            get_solver(name, iterations, max_line_search_iterations)
            self._opt_algo = name
        else:
            self._opt_algo = "SGD"
        self._solver_iterations = int(iterations)
        self._max_ls_iterations = int(max_line_search_iterations)
        return self

    def workspace_mode(self, mode: str):
        """The rematerialization policy of the train step (DL4J
        ``trainingWorkspaceMode``/``cacheMode``): ``none``, ``full``,
        ``dots_saveable``, ``every_<k>`` (``enabled`` is ``full``); see
        ``nn/memory.py``."""
        from . import memory as _memory
        _memory.resolve_policy(mode)  # validate at build time
        self._workspace_mode = str(mode).strip().lower()
        return self

    # DL4J spelling
    def training_workspace_mode(self, mode: str):
        return self.workspace_mode(mode)

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

    def input_type(self, shape: Tuple[int, ...]):
        self._input_shape = tuple(shape)
        return self

    def layer(self, l: Layer):
        self._layers.append(l)
        return self

    def layers(self, ls: List[Layer]):
        self._layers.extend(ls)
        return self

    # DL4J spelling
    def list(self, *ls: Layer):
        self._layers.extend(ls)
        return self

    def graph_builder(self):
        """DAG config builder carrying this builder's seed/updater/etc.
        (DL4J ``.graphBuilder()``)."""
        if self._opt_algo != "SGD":
            # a silent SGD fallback would betray the configured solver
            raise ValueError(
                f"optimization_algo({self._opt_algo!r}) is not supported on "
                "the ComputationGraph engine (MultiLayerNetwork only); use "
                "SGD or the sequential engine")
        from .graph import GraphBuilder
        return GraphBuilder(self)

    def build(self) -> MultiLayerConfiguration:
        shape = self._input_shape
        layers = _auto_flatten(self._layers, shape)
        if self._tbptt:
            layers = [stamp_tbptt(l, self._tbptt) for l in layers]
        return MultiLayerConfiguration(
            layers=layers, input_shape=shape, seed=self._seed,
            dtype=self._dtype, updater=self._updater, l1=self._l1,
            l2=self._l2, gradient_clip_value=self._clip_value,
            gradient_clip_l2=self._clip_l2,
            gradient_normalization=self._grad_norm,
            gradient_normalization_threshold=self._grad_norm_threshold,
            tbptt_length=self._tbptt, constraints=self._constraints or None,
            optimization_algo=self._opt_algo,
            solver_iterations=self._solver_iterations,
            max_line_search_iterations=self._max_ls_iterations,
            workspace_mode=self._workspace_mode)


def _auto_flatten(layers: List[Layer], input_shape) -> List[Layer]:
    """Insert a FlattenLayer at every CNN -> dense seam (DL4J's
    CnnToFeedForwardPreProcessor auto-add): before a Dense or Output layer
    whose input is rank 3 (``[C, H, W]`` or ``[H, W, C]``). Recurrent
    ``[T, F]`` inputs keep per-step dense application. The shape is
    propagated through each layer's own ``initialize``."""
    if input_shape is None:
        return list(layers)
    out: List[Layer] = []
    shape: Optional[Tuple[int, ...]] = tuple(input_shape)
    for l in layers:
        if (isinstance(l, (DenseLayer, OutputLayer)) and shape is not None
                and len(shape) == 3):
            fl = FlattenLayer()
            out.append(fl)
            shape = _infer_shape(fl, shape)
        out.append(l)
        shape = _infer_shape(l, shape) if shape is not None else None
    return out


def _infer_shape(layer: Layer, input_shape, dtype="FLOAT"):
    """The output shape of ``layer`` on ``input_shape`` (no batch axis),
    from the layer's own ``initialize`` with its parameters made on the
    ``meta`` device (drawn from a throwaway generator), or None where a
    dimension is dynamic (-1, a recurrent input of unknown length). A
    layer whose ``initialize`` fails on a static shape is a configuration
    error and raises here, at ``build()``."""
    if input_shape is None or any(int(s) < 0 for s in input_shape):
        return None
    from .. import dtypes as _dt
    _, _, out = layer.initialize(torch.Generator(), tuple(input_shape),
                                 _dt.param_dtype(dtype),
                                 torch.device("meta"))
    return tuple(int(s) for s in out)


def stamp_tbptt(layer: Layer, tbptt: int) -> Layer:
    """Copy-on-write stamp of the net-level truncated-BPTT window onto
    recurrent layers that didn't set their own (DL4J:
    backpropType(TruncatedBPTT) + tBPTTLength is a net-level knob the RNN
    layers consume). Recurses into wrappers holding a nested ``layer``;
    never mutates caller-owned configs."""
    inner = getattr(layer, "layer", None)
    if isinstance(inner, Layer):
        stamped = stamp_tbptt(inner, tbptt)
        if stamped is not inner:
            layer = dataclasses.replace(layer, layer=stamped)
    if getattr(layer, "tbptt_length", False) is None:
        layer = dataclasses.replace(layer, tbptt_length=tbptt)
    return layer
