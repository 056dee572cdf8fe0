"""ComputationGraph: the DAG network engine.

Port of ``deeplearning4j_tpu/nn/graph.py``: the configuration with its JSON
round-trip, the builder (``layer`` is DL4J's spelling of ``add_layer``),
and the engine's ``init``, ``summary``, eager topological forward walk
with the BN + activation fold plan (the same plan in training and
inference; a ``FrozenLayer`` BN is not folded, as there), ``feed_forward``,
``output`` (through the bucketed :class:`InferenceEngine`; ``train=True``
runs the training forward), ``predict``, ``evaluate``, ``fit``, ``score``,
the flat parameter view ``params_flat``/``set_params_flat`` and
``save``/``load`` with the updater state.

Parameters and state are dicts of tensors keyed by vertex name and then by
parameter name, exactly as the JAX package keys ``net.params`` and
``net.state``, so its ``coefficients.npz`` loads unchanged; the updater
state is keyed by slot, then the same way (``updaterState.npz``).

A training step (``fit``) runs eagerly inside one
``environment.precision(device)`` context: the forward with batch
statistics, the loss (a center-loss head's with its centers moved),
``torch.autograd.grad`` (K2 is the backward of every BN epilogue autograd
records: a frozen stack that only frozen layers feed records none), l1/l2,
gradient normalization and clipping, the divergence sentinel (one host
sync for its verdict), the updater and the constraints, which skip the
FrozenLayer vertices. A bad step leaves params, updater state and BN
state as they were.

A net-level ``tbptt_length`` is stamped by ``GraphBuilder.build`` onto
the recurrent layers of the layer vertices (wrapped ones included), as
the JAX builder does: ``fit`` makes one update a batch, and the layers'
scans detach the carry every ``tbptt_length`` steps (truncated BPTT, the
JAX package's rule rather than DL4J's chunked fitting).

The training modes of ``fit`` (the JAX module's :348-865), as in the
sequential engine: 16-bit training with f32 masters and the fused
master-cast updater (``fused_updater_active``), micro-batch accumulation
(``_build_train_step(accum_steps=k)``, weighted by
``microbatch.multi_output_weight``), ``workspace_mode`` rematerialization
over topological segments pruned to their live activations
(``_forward_remat``, ``set_workspace_mode``, ``memory_report``) and
``fit_on_device``. The graph engine has no solver path, as in the JAX
package (its builder refuses one).

Not in this slice (each raises ``NotImplementedError`` when asked for):
the resilience policy of ``fit`` and the training listeners, which come
with the runtime slice (``ROADMAP.md`` Queue 1 item 9).
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import dtypes as _dt
from .. import environment as _env
from ..data.dataset import (DataSet, DataSetIterator, MultiDataSet,
                            MultiDataSetIterator, NumpyMultiDataSetIterator)
from ..ops import losses as _loss
from ..parallel.collectives import HeldShards
from ..runtime import sentinel as _sent
from ..utils import tree as _tree
from . import constraints as _constraints
from . import gradnorm as _gn
from . import training as _training
from . import updaters as _upd
from .layers.wrappers import is_loss_head
from .vertices import GraphVertex, LayerVertex

#: the slice of the port that brings what this one leaves out
_RUNTIME = "the runtime slice of the port (ROADMAP.md Queue 1 item 9)"


class ComputationGraphConfiguration:
    """Immutable DAG description (the thing that serializes).

    ``updater`` is an :class:`~.updaters.Updater` (a serialized dict is
    accepted too); ``constraints`` a list of ``(constraint, scope)``."""

    def __init__(self, *, inputs: List[str], outputs: List[str],
                 vertices: List[Tuple[str, GraphVertex, List[str]]],
                 input_shapes: Optional[Dict[str, Tuple[int, ...]]] = None,
                 seed: int = 1234, dtype: str = "FLOAT",
                 updater: Any = None, l1: float = 0.0,
                 l2: float = 0.0, gradient_clip_value: Optional[float] = None,
                 gradient_clip_l2: Optional[float] = None,
                 gradient_normalization: Optional[str] = None,
                 gradient_normalization_threshold: float = 1.0,
                 tbptt_length: Optional[int] = None,
                 constraints: Optional[list] = None,
                 workspace_mode: str = "none"):
        self.inputs = list(inputs)
        self.outputs = list(outputs)
        self.vertices = list(vertices)  # [(name, vertex, [input names])]
        self.input_shapes = dict(input_shapes or {})
        self.seed = seed
        self.dtype = dtype
        self.updater = _upd.Updater.from_dict(updater) \
            if isinstance(updater, dict) else updater
        self.l1 = l1
        self.l2 = l2
        self.gradient_clip_value = gradient_clip_value
        self.gradient_clip_l2 = gradient_clip_l2
        _gn.validate(gradient_normalization)
        self.gradient_normalization = gradient_normalization
        self.gradient_normalization_threshold = \
            gradient_normalization_threshold
        self.tbptt_length = tbptt_length
        self.constraints = list(constraints or [])
        from . import memory as _memory
        _memory.resolve_policy(workspace_mode)  # validate at build time
        self.workspace_mode = str(workspace_mode).strip().lower()
        self._validate()

    def _validate(self):
        declared = {n for n, _, _ in self.vertices}
        names = set(self.inputs)
        for name, _, ins in self.vertices:
            if name in names:
                raise ValueError(f"duplicate vertex name {name!r}")
            for i in ins:
                if i not in names and i not in declared:
                    raise ValueError(
                        f"vertex {name!r} input {i!r} is not a network input "
                        "or a declared vertex")
            names.add(name)
        for o in self.outputs:
            if o not in names:
                raise ValueError(f"output {o!r} is not a declared vertex")

    def topo_order(self) -> List[str]:
        """Kahn topological order over vertex names (inputs excluded)."""
        ins = {name: set(i for i in inp if i not in self.inputs)
               for name, _, inp in self.vertices}
        dependents: Dict[str, List[str]] = {}
        for name, _, inp in self.vertices:
            for i in set(inp):  # a vertex may consume an input twice
                dependents.setdefault(i, []).append(name)
        ready = [n for n, deps in ins.items() if not deps]
        order: List[str] = []
        while ready:
            n = ready.pop(0)
            order.append(n)
            for d in dependents.get(n, []):
                ins[d].discard(n)
                if not ins[d]:
                    ready.append(d)
        if len(order) != len(self.vertices):
            cyc = sorted(set(ins) - set(order))
            raise ValueError(f"graph has a cycle involving {cyc}")
        return order

    # ------------------------------------------------------------------ serde
    def to_json(self) -> str:
        return json.dumps({
            "format_version": 1,
            "model_class": "ComputationGraph",
            "seed": self.seed,
            "dtype": self.dtype,
            "updater": self.updater.to_dict() if self.updater else None,
            "l1": self.l1, "l2": self.l2,
            "gradient_clip_value": self.gradient_clip_value,
            "gradient_clip_l2": self.gradient_clip_l2,
            "gradient_normalization": self.gradient_normalization,
            "gradient_normalization_threshold":
                self.gradient_normalization_threshold,
            "tbptt_length": self.tbptt_length,
            "constraints": _constraints.encode_constraints(
                self.constraints),
            "workspace_mode": self.workspace_mode,
            "network_inputs": self.inputs,
            "network_outputs": self.outputs,
            "input_shapes": {k: list(v)
                             for k, v in self.input_shapes.items()},
            "vertices": [{"name": n, "inputs": list(i), "vertex": v.to_dict()}
                         for n, v, i in self.vertices],
        }, indent=2)

    @staticmethod
    def from_json(s: str) -> "ComputationGraphConfiguration":
        d = json.loads(s)
        return ComputationGraphConfiguration(
            inputs=d["network_inputs"],
            outputs=d["network_outputs"],
            vertices=[(vd["name"], GraphVertex.from_dict(vd["vertex"]),
                       list(vd["inputs"])) for vd in d["vertices"]],
            input_shapes={k: tuple(v)
                          for k, v in d.get("input_shapes", {}).items()},
            seed=d.get("seed", 1234), dtype=d.get("dtype", "FLOAT"),
            updater=d.get("updater"),
            l1=d.get("l1", 0.0), l2=d.get("l2", 0.0),
            gradient_clip_value=d.get("gradient_clip_value"),
            gradient_clip_l2=d.get("gradient_clip_l2"),
            gradient_normalization=d.get("gradient_normalization"),
            gradient_normalization_threshold=d.get(
                "gradient_normalization_threshold", 1.0),
            tbptt_length=d.get("tbptt_length"),
            constraints=_constraints.decode_constraints(
                d.get("constraints")),
            workspace_mode=d.get("workspace_mode", "none"))


class GraphBuilder:
    """DL4J ``NeuralNetConfiguration.Builder().graphBuilder()`` equivalent."""

    def __init__(self, base=None):
        # base: a NeuralNetConfiguration builder carrying seed/updater/etc.
        self._base = base
        self._inputs: List[str] = []
        self._outputs: List[str] = []
        self._vertices: List[Tuple[str, GraphVertex, List[str]]] = []
        self._input_shapes: Dict[str, Tuple[int, ...]] = {}

    def add_inputs(self, *names: str) -> "GraphBuilder":
        self._inputs.extend(names)
        return self

    def set_input_types(self, *shapes) -> "GraphBuilder":
        """Shapes (batch-free, InputType.* values) aligned with add_inputs
        order."""
        if len(shapes) != len(self._inputs):
            raise ValueError(f"{len(self._inputs)} inputs declared, "
                             f"{len(shapes)} input types given")
        for name, s in zip(self._inputs, shapes):
            self._input_shapes[name] = tuple(s)
        return self

    def add_layer(self, name: str, layer, *inputs: str) -> "GraphBuilder":
        self._vertices.append((name, LayerVertex(layer=layer), list(inputs)))
        return self

    # DL4J spelling
    def layer(self, name: str, layer, *inputs: str) -> "GraphBuilder":
        return self.add_layer(name, layer, *inputs)

    def add_vertex(self, name: str, vertex: GraphVertex,
                   *inputs: str) -> "GraphBuilder":
        self._vertices.append((name, vertex, list(inputs)))
        return self

    def set_outputs(self, *names: str) -> "GraphBuilder":
        self._outputs = list(names)
        return self

    def build(self) -> ComputationGraphConfiguration:
        """The configuration, with the net-level truncated-BPTT window
        stamped (copy-on-write) onto every layer vertex's layer and the
        layers they wrap, as ``NeuralNetConfiguration.build`` does."""
        b = self._base
        vertices = self._vertices
        if b and b._tbptt:
            from .config import stamp_tbptt
            vertices = [
                (n, LayerVertex(layer=stamp_tbptt(v.layer, b._tbptt))
                 if isinstance(v, LayerVertex) else v, ins)
                for n, v, ins in vertices]
        return ComputationGraphConfiguration(
            inputs=self._inputs, outputs=self._outputs,
            vertices=vertices, input_shapes=self._input_shapes,
            seed=b._seed if b else 1234,
            dtype=b._dtype if b else "FLOAT",
            updater=b._updater if b else None,
            l1=b._l1 if b else 0.0, l2=b._l2 if b else 0.0,
            gradient_clip_value=b._clip_value if b else None,
            gradient_clip_l2=b._clip_l2 if b else None,
            gradient_normalization=b._grad_norm if b else None,
            gradient_normalization_threshold=(
                b._grad_norm_threshold if b else 1.0),
            tbptt_length=b._tbptt if b else None,
            constraints=(b._constraints or None) if b else None,
            workspace_mode=b._workspace_mode if b else "none")


class ComputationGraph(HeldShards):
    """DAG network engine (DL4J ``ComputationGraph``)."""

    def __init__(self, conf: ComputationGraphConfiguration):
        self.conf = conf
        self._vertex_map: Dict[str, Tuple[GraphVertex, List[str]]] = {
            n: (v, ins) for n, v, ins in conf.vertices}
        self._topo = conf.topo_order()
        self.params: Dict[str, Dict[str, torch.Tensor]] = {}
        self.state: Dict[str, Dict[str, torch.Tensor]] = {}
        self.updater_state: dict = {}
        self.iteration = 0
        self.epoch = 0
        self.device: Optional[torch.device] = None
        self._shapes: Dict[str, Tuple[int, ...]] = {}
        self._inference_engine = None
        self._epilogue_fold = None
        self._score = float("nan")
        self._sentinel = _sent.Sentinel()
        self._rng = None
        self._train_step = None
        # the loss heads of the network outputs (duck-typed, a FrozenLayer
        # unwrapped to probe it, as the sequential engine does)
        self._out_layers = {
            o: self._vertex_map[o][0].layer for o in conf.outputs
            if isinstance(self._vertex_map[o][0], LayerVertex)
            and is_loss_head(self._vertex_map[o][0].layer)}
        self._frozen = frozenset(
            n for n, v, _ in conf.vertices
            if isinstance(v, LayerVertex) and getattr(v.layer, "frozen",
                                                      False))

    # ------------------------------------------------------------------ init
    def init(self, device=None) -> "ComputationGraph":
        """Draw the parameters from ``conf.seed`` onto ``device`` (``cuda``
        unless the caller asks for ``cpu``; raises without CUDA), and zero
        the updater state. The draws come from one CPU
        ``torch.Generator``, so a seed gives the same weights on every
        device (not the JAX package's threefry values)."""
        device = _env.resolve_device(device)
        if set(self.conf.input_shapes) != set(self.conf.inputs):
            missing = set(self.conf.inputs) - set(self.conf.input_shapes)
            raise ValueError(
                f"set_input_types missing for inputs {sorted(missing)}")
        # mixed precision: 16-bit net dtypes keep f32 master params (cast
        # to the compute dtype inside _forward)
        dtype = _dt.param_dtype(self.conf.dtype)
        shapes: Dict[str, Tuple[int, ...]] = {
            k: tuple(v) for k, v in self.conf.input_shapes.items()}
        gen = torch.Generator().manual_seed(int(self.conf.seed))
        params, state = {}, {}
        for name in self._topo:
            v, ins = self._vertex_map[name]
            p, s, out_shape = v.initialize(gen, [shapes[i] for i in ins],
                                           dtype, device)
            if p:
                params[name] = p
            if s:
                state[name] = s
            shapes[name] = tuple(out_shape)
        self.params = params
        self.state = state
        self.updater_state = self.conf.updater.init_state(params) \
            if self.conf.updater else {}
        self._shapes = shapes
        self.device = device
        self._inference_engine = None
        self._rng = None
        self._train_step = None
        return self

    def num_params(self) -> int:
        return sum(int(t.numel()) for t in _tree.leaves(self.params))

    def summary(self) -> str:
        """One row a vertex in topological order (name, kind, inputs, output
        shape, parameter count) and the total: the JAX package's text."""
        lines = [f"{'vertex':<24}{'type':<22}{'inputs':<30}"
                 f"{'out shape':<18}params"]
        for name in self._topo:
            v, ins = self._vertex_map[name]
            kind = (f"layer[{v.layer.kind}]" if isinstance(v, LayerVertex)
                    else v.kind)
            n = sum(int(t.numel())
                    for t in _tree.leaves(self.params.get(name, {})))
            shape = self._shapes.get(name, "?")
            lines.append(f"{name:<24}{kind:<22}{','.join(ins):<30}"
                         f"{str(shape):<18}{n}")
        lines.append(f"total params: {self.num_params()}")
        return "\n".join(lines)

    # ------------------------------------------------- flat parameter view
    def params_flat(self) -> np.ndarray:
        """Every parameter as one numpy vector: vertices in topological
        order, each vertex's tensors in DL4J's name order. The port keeps
        the JAX package's layouts (OIHW convolution kernels, ``[nIn,
        nOut]`` dense weights), so the vector is the JAX package's and
        loads there unchanged, and the other way round."""
        return _tree.flatten_params(self.params, self._topo)

    def set_params_flat(self, vec) -> "ComputationGraph":
        """Load a :meth:`params_flat` vector (from either package)."""
        self.params = _tree.unflatten_params(self.params, self._topo, vec)
        return self

    # --------------------------------------------------------------- forward
    def _forward(self, params, inputs: Dict[str, torch.Tensor], state, *,
                 train=False, masks: Optional[Dict[str, Any]] = None,
                 fold_epilogues=True, rng=None, remat_policy=None):
        """Eager topological walk. Returns ({vertex: activation},
        new_state, {vertex: mask}); the network inputs are in the
        activations too. In training, BN vertices normalize with batch
        statistics and ``new_state`` holds their new running statistics
        (``state`` itself is not modified), and ``rng`` (a
        ``torch.Generator`` on the device) feeds the stochastic layers
        (dropout). Under a 16-bit policy the f32 masters are cast to the
        compute dtype here (the fused step's copies pass as they are).
        ``remat_policy`` (``nn/memory.py``; the train step's loss only)
        runs the walk in checkpointed segments; the dicts it returns then
        hold the network outputs only."""
        dt = _dt.resolve(self.conf.dtype)
        if dt.is_floating_point:
            inputs = {k: (v.to(dt) if v.is_floating_point() and v.dtype != dt
                          else v) for k, v in inputs.items()}
        if _dt.is_mixed(self.conf.dtype):
            params = _dt.cast_floating(params, dt)
        if remat_policy is not None and remat_policy.remat:
            return self._forward_remat(params, inputs, state, train=train,
                                       masks=masks, rng=rng,
                                       policy=remat_policy)
        fold, skip = self._epilogue_fold_plan() if fold_epilogues \
            else ({}, frozenset())
        acts, mks, ns = self._walk(self._topo, params, dict(inputs),
                                   dict(masks or {}), state, train, rng,
                                   fold, skip)
        return acts, {**state, **ns}, mks

    def _walk(self, names, params, acts, mks, state, train, rng, fold,
              skip):
        """The vertices ``names`` in turn, reading and extending ``acts``
        and ``mks`` in place: ``(acts, mks, their new state)``."""
        ns = {}
        for name in names:
            v, ins = self._vertex_map[name]
            if name in skip:  # folded act vertex: value passes through
                acts[name] = acts[ins[0]]
                mks[name] = mks.get(ins[0])
                continue
            kw = {"fold_act": fold[name]} if name in fold else {}
            if rng is not None and getattr(v, "needs_rng", False):
                kw["rng"] = rng
            y, s_new, m = v.apply(params.get(name, {}),
                                  [acts[i] for i in ins],
                                  state.get(name, {}), train=train,
                                  masks=[mks.get(i) for i in ins], **kw)
            acts[name] = y
            mks[name] = m
            if s_new:
                ns[name] = s_new
        return acts, mks, ns

    def _forward_remat(self, params, inputs, state, *, train, masks, rng,
                       policy):
        """The same walk in segments of ``policy.every`` vertices, each
        under ``memory.checkpoint``. At every boundary the activations are
        pruned to the live set (names a later vertex reads, and the
        network outputs): those are what the backward keeps; a skip
        connection across segments rides through as a segment input. The
        dropout generator is replayed in the recompute, so the numbers are
        the plain walk's."""
        from . import memory as _memory
        topo = self._topo
        bounds = _memory.segment_ranges(len(topo), policy.every)
        # needed_after[j]: names read by any vertex of bounds[j:], plus
        # the network outputs (one right-to-left pass)
        needed_after = [set(self.conf.outputs)]
        for s, e in reversed(bounds):
            nxt = set(needed_after[-1])
            for n in topo[s:e]:
                nxt.update(self._vertex_map[n][1])
            needed_after.append(nxt)
        needed_after.reverse()
        fold, skip = self._epilogue_fold_plan()
        acts, mks = dict(inputs), dict(masks or {})
        new_state = dict(state)
        for j, (s, e) in enumerate(bounds):
            names = tuple(topo[s:e])
            live = tuple(sorted((set(acts) | set(names))
                                & needed_after[j + 1]))

            def seg_fn(seg_params, seg_state, a, m, _names=names,
                       _live=live):
                a, m, ns = self._walk(_names, seg_params, dict(a), dict(m),
                                      seg_state, train, rng, fold, skip)
                return ({n: a[n] for n in _live},
                        {n: m.get(n) for n in _live}, ns)
            acts, mks, ns = _memory.checkpoint(seg_fn, policy, rng)(
                {n: params[n] for n in names if n in params},
                {n: state[n] for n in names if n in state}, acts, mks)
            new_state.update(ns)
        return acts, new_state, mks

    def _epilogue_fold_plan(self):
        """Static BN + activation fold plan over the vertex graph: a
        LayerVertex(BatchNormalization) whose output is consumed ONLY by a
        LayerVertex(ActivationLayer) with a K1-foldable activation (and is
        not itself a network output) gets the activation folded into its
        ``bn_act`` epilogue; the activation vertex becomes a pass-through.
        The same plan as the JAX package's, vertex for vertex."""
        if self._epilogue_fold is not None:
            return self._epilogue_fold
        from ..ops import fused_epilogues as _fe
        from .layers.conv import BatchNormalization
        from .layers.core import ActivationLayer
        consumers: Dict[str, list] = {}
        for name in self._topo:
            _, ins = self._vertex_map[name]
            for i in ins:
                consumers.setdefault(i, []).append(name)
        outputs = set(self.conf.outputs)
        fold, skip = {}, set()
        for name in self._topo:
            v, _ = self._vertex_map[name]
            if not (isinstance(v, LayerVertex)
                    and isinstance(v.layer, BatchNormalization)):
                continue
            if name in outputs or len(consumers.get(name, [])) != 1:
                continue
            nxt = consumers[name][0]
            nv, _ = self._vertex_map[nxt]
            if (isinstance(nv, LayerVertex)
                    and type(nv.layer) is ActivationLayer
                    and _fe.foldable_act(nv.layer.activation,
                                         nv.layer.alpha)):
                fold[name] = nv.layer.activation
                skip.add(nxt)
        self._epilogue_fold = (fold, frozenset(skip))
        return self._epilogue_fold

    def _tensor(self, a) -> torch.Tensor:
        """An input array as a tensor on the model's device. float64 comes
        in as float32 unless the network is ``DOUBLE``, as in the JAX
        package (64-bit values need its x64 mode, which a ``DOUBLE``
        network needs anyway)."""
        t = a if torch.is_tensor(a) else torch.as_tensor(np.asarray(a))
        if t.dtype == torch.float64 and \
                _dt.resolve(self.conf.dtype) != torch.float64:
            t = t.float()
        return t.to(self.device)

    def _as_inputs(self, inputs) -> Dict[str, torch.Tensor]:
        if len(inputs) != len(self.conf.inputs):
            raise ValueError(
                f"the graph takes {len(self.conf.inputs)} inputs "
                f"({self.conf.inputs}), got {len(inputs)}")
        return {n: self._tensor(x) for n, x in zip(self.conf.inputs, inputs)}

    # -------------------------------------------------------------- training
    def _regularization(self, params):
        """The l1/l2 penalty over every layer's ``W`` (the layer's own
        coefficient, else the network's)."""
        return _training.regularization(self.conf, (
            (v.layer if isinstance(v, LayerVertex) else None,
             params.get(name, {}))
            for name in self._topo
            for v in (self._vertex_map[name][0],)))

    def _check_trainable(self):
        """Raise for what ``fit`` cannot do."""
        if set(self._out_layers) != set(self.conf.outputs):
            bad = sorted(set(self.conf.outputs) - set(self._out_layers))
            raise ValueError(
                f"output vertices {bad} are not Output/Loss layers; fit() "
                "needs a loss head on every network output")
        if self.conf.updater is None:
            raise ValueError("fit() needs an updater in the configuration")

    def _loss(self, params, state, xs, ys, fms, lms, rng=None):
        """``(loss, new BN state)`` of one batch: the training forward
        (dropout from ``rng``; None: the identity; under the
        configuration's ``workspace_mode``), the loss heads' losses summed
        over the outputs (a center-loss head's with its center term, its
        centers moved in the new state), plus l1/l2."""
        from . import memory as _memory
        inputs = dict(zip(self.conf.inputs, xs))
        masks = {n: m for n, m in zip(self.conf.inputs, fms)
                 if m is not None}
        acts, new_state, mks = self._forward(
            params, inputs, state, train=True, masks=masks, rng=rng,
            remat_policy=_memory.resolve_policy(self.conf.workspace_mode))
        total = 0.0
        for o, y, lm in zip(self.conf.outputs, ys, lms):
            m = _loss.combine_masks(lm, mks.get(o))
            loss, new_state = _training.head_loss(
                self._out_layers[o], acts[o], y, m, state, new_state, o)
            total = total + loss
        return total + self._regularization(params), new_state

    def _uses_regularization(self) -> bool:
        """Any l1/l2 term configured? (See the sequential engine's.)"""
        return _training.uses_regularization(
            self.conf, [v.layer for _, v, _ in self.conf.vertices
                        if isinstance(v, LayerVertex)])

    def fused_updater_active(self) -> bool:
        """The fused master-cast updater's gate (see
        ``MultiLayerNetwork.fused_updater_active``)."""
        return _training.fused_cast_active(self)

    def _value_and_grad(self, xs, ys, fms, lms):
        """``(loss, grads, new BN state)`` at the current params: one
        training forward and ``torch.autograd.grad``. ``grads`` is keyed
        like ``params``; a param the loss does not reach gets zeros."""
        return _training.value_and_grad(
            self.params,
            lambda p: self._loss(p, self.state, xs, ys, fms, lms))

    def _build_train_step(self, accum_steps: int = 1,
                          fused_cast: bool = False):
        """The eager step ``(xs, ys, fms, lms, on_device=False) -> loss``
        (tuples by network input and output): ``nn/training.py``'s step on
        :meth:`_loss` with the model's generator. ``accum_steps`` and
        ``fused_cast`` as in ``MultiLayerNetwork._build_train_step``; the
        microbatch weight is ``microbatch.multi_output_weight``."""
        from . import microbatch as _micro

        def vg(p, state, rng, xs, ys, fms, lms):
            return _training.value_and_grad(
                p, lambda q: self._loss(q, state, xs, ys, fms, lms, rng))
        return _training.step_fn(self, vg, accum_steps, fused_cast,
                                 _micro.multi_output_weight)

    def _fit_step(self):
        """The step ``fit`` and ``fit_on_device`` run, built once per model
        (its routing decision counted once), with no compute copy carried
        into a new call."""
        if self._train_step is None:
            from ..ops import fused_epilogues as _fe
            fused = self.fused_updater_active()
            _fe.dispatch_updater(self.conf.dtype,
                                 has_penalty=self._uses_regularization())
            self._train_step = self._build_train_step(fused_cast=fused)
        self._train_step.params_c = None
        return self._train_step

    def fit(self, data, labels=None, epochs: int = 1,
            resilience=None) -> "ComputationGraph":
        """Train on a MultiDataSetIterator, MultiDataSet, DataSetIterator,
        DataSet, or (features, labels) arrays, for ``epochs`` passes. An
        uninitialized net is initialized on ``cuda`` first."""
        if resilience is not None:
            raise NotImplementedError(
                f"fit(resilience=...) comes with {_RUNTIME}")
        self._check_trainable()
        if not self.params and not self.state:
            self.init()
        step = self._fit_step()
        it = _as_multi_iterator(data, labels)
        for _ in range(epochs):
            for mds in it:
                xs = tuple(self._tensor(f) for f in mds.features)
                ys = tuple(self._tensor(y) for y in mds.labels)
                fms = tuple(None if m is None else self._tensor(m)
                            for m in mds.features_masks)
                lms = tuple(None if m is None else self._tensor(m)
                            for m in mds.labels_masks)
                self._score = step(xs, ys, fms, lms)
                self.iteration += 1
            self.epoch += 1
            it = _as_multi_iterator(data, labels)
        return self

    def fit_on_device(self, features, labels, epochs: int = 1,
                      batch_size: Optional[int] = None,
                      drop_remainder: bool = False) -> np.ndarray:
        """Training on a dataset uploaded once (the JAX engine's compiled
        epoch loop): ``features``/``labels`` are arrays, or lists of them
        for several inputs or outputs, reshaped to ``[n_batches, B, ...]``
        on the model's device; each epoch is one loop of ``fit``'s step
        with no host sync inside it. Returns the loss history ``[epochs *
        n_batches]``, the values per-batch ``fit`` gives. A dataset size
        not divisible by the batch raises unless ``drop_remainder=True``;
        masked data must use ``fit()``."""
        self._check_trainable()
        if not self.params and not self.state:
            self.init()
        xs, ys = _training.stack_dataset(
            self, *([a] if not isinstance(a, (list, tuple)) else list(a)
                    for a in (features, labels)), batch_size, drop_remainder)
        none_x, none_y = (None,) * len(xs), (None,) * len(ys)
        return _training.device_epochs(
            self, self._fit_step(), epochs, xs[0].shape[0],
            lambda i: (tuple(x[i] for x in xs), tuple(y[i] for y in ys),
                       none_x, none_y))

    def score(self, data=None) -> float:
        """The loss of the last ``fit`` batch, or of the given (Multi)
        DataSet (with batch statistics, as DL4J scores); both include the
        l1/l2 term."""
        if data is None:
            if torch.is_tensor(self._score):
                self._score = float(self._score)
            return self._score
        self._require_init()
        mds = data if isinstance(data, MultiDataSet) else \
            MultiDataSet.from_dataset(data)
        with torch.no_grad(), _env.precision(self.device):
            loss, _ = self._loss(
                self.params, self.state,
                tuple(self._tensor(f) for f in mds.features),
                tuple(self._tensor(y) for y in mds.labels),
                tuple(None if m is None else self._tensor(m)
                      for m in mds.features_masks),
                tuple(None if m is None else self._tensor(m)
                      for m in mds.labels_masks))
        return float(loss)

    # --------------------------------------------- workspace mode, memory
    def set_workspace_mode(self, mode: str) -> "ComputationGraph":
        """Switch the rematerialization policy (``nn/memory.py``) in place,
        copy on write: the next step is built under it."""
        import copy
        from . import memory as _memory
        policy = _memory.resolve_policy(mode)  # validate before mutating
        self.conf = copy.copy(self.conf)
        self.conf.workspace_mode = policy.name
        self._train_step = None
        return self

    def memory_report(self, batch_size: int, accum_steps: int = 1,
                      seq_len=None) -> dict:
        """The train step's memory at ``batch_size``, measured (see
        ``MultiLayerNetwork.memory_report``)."""
        from . import memory as _memory
        return _memory.memory_report(self, batch_size,
                                     accum_steps=accum_steps,
                                     seq_len=seq_len)

    def _memory_probe(self, batch: int, seq_len) -> dict:
        """Residual bytes of one training forward and backward at
        ``batch`` on zero inputs (labels shaped by an inference forward);
        nothing is applied."""
        from . import memory as _memory
        dt = _dt.resolve(self.conf.dtype)
        xs = tuple(_memory.probe_batch(self.conf.input_shapes[n], batch,
                                       seq_len, dt, self.device)
                   for n in self.conf.inputs)
        with torch.no_grad(), _env.precision(self.device):
            acts, _, _ = self._forward(self.params,
                                       dict(zip(self.conf.inputs, xs)),
                                       self.state)
        ys = tuple(torch.zeros(acts[o].shape, dtype=torch.float32,
                               device=self.device)
                   for o in self.conf.outputs)
        none_x, none_y = (None,) * len(xs), (None,) * len(ys)
        with _memory.count_residuals((self.params, xs, ys)) as res, \
                _env.precision(self.device):
            _training.value_and_grad(
                self.params, lambda p: self._loss(p, self.state, xs, ys,
                                                  none_x, none_y))
        return res.report()

    def resilience_counters(self) -> dict:
        """The divergence sentinel's counters (skipped steps in total and
        in a row, clip events)."""
        return self._sentinel.to_host()

    def set_listeners(self, *listeners):
        raise NotImplementedError(f"training listeners come with {_RUNTIME}")

    def add_listener(self, listener):
        raise NotImplementedError(f"training listeners come with {_RUNTIME}")

    # ------------------------------------------------------------- inference
    def feed_forward(self, *inputs, train: bool = False):
        """All vertex activations for the given inputs (DL4J
        ``ComputationGraph.feedForward()``): {vertex_name: tensor}. No
        epilogue fold here: feedForward exposes every vertex's true
        activation (the fold would show the BN vertex post-activation)."""
        self._require_init()
        with torch.inference_mode(), _env.precision(self.device):
            acts, _, _ = self._forward(self.params, self._as_inputs(inputs),
                                       self.state, train=train,
                                       fold_epilogues=False)
        return acts

    def quantize_params(self, mode: str = "int8") -> dict:
        """Post-training per-channel int8 quantization of the opted-in
        layer vertices' weights (``quantize_spec``): a NEW params tree; the
        merge, norm and embedding vertices stay as they are, and the
        model's own params are untouched."""
        if mode != "int8":
            raise ValueError(f"unknown quantization mode {mode!r} "
                             "(expected 'int8')")
        from ..ops import quantize as _q
        self._require_init()
        return _q.quantize_model_params(self)[0]

    def inference_engine(self, **kwargs):
        """The model's serving engine, created lazily on the model's device;
        ``output()`` routes through it."""
        if self._inference_engine is None:
            from ..serving.engine import InferenceEngine
            self._require_init()
            self._inference_engine = InferenceEngine(
                self, device=self.device, **kwargs)
        elif kwargs:
            raise ValueError("inference engine already built; call "
                             "inference_engine() without kwargs, or build "
                             "an InferenceEngine directly")
        return self._inference_engine

    def output(self, *inputs, train: bool = False):
        """Output activations (numpy) for the network outputs: one array
        when the graph has one output, else a list (DL4J ``output()``).
        Ragged batch sizes pad to the engine's power-of-two buckets.
        ``train=True`` runs the training forward (batch statistics, the
        stochastic layers drawing from the model's generator; the loss
        heads give their pre-activation, as in the JAX package) and leaves
        the layer state as it was."""
        if not train:
            return self.inference_engine().output(*inputs)
        self._require_init()
        with torch.inference_mode(), _env.precision(self.device):
            acts, _, _ = self._forward(self.params, self._as_inputs(inputs),
                                       self.state, train=True,
                                       rng=_training.generator(self))
            outs = [acts[o].float().cpu().numpy()
                    if acts[o].dtype in (torch.bfloat16, torch.float16)
                    else acts[o].cpu().numpy() for o in self.conf.outputs]
        return outs[0] if len(outs) == 1 else outs

    def evaluate(self, data, labels=None, output: int = 0):
        """Classification evaluation of one network output over an
        iterator (DL4J ``evaluate()``), through :meth:`output`."""
        from ..eval.evaluation import Evaluation
        ev = Evaluation()
        for mds in _as_multi_iterator(data, labels):
            out = self.output(*mds.features)
            if isinstance(out, list):
                out = out[output]
            ev.eval(mds.labels[output], out, mask=mds.labels_masks[output])
        return ev

    def predict(self, *inputs):
        out = self.output(*inputs)
        if isinstance(out, list):
            return [np.argmax(o, axis=-1) for o in out]
        return np.argmax(out, axis=-1)

    def _require_init(self):
        if self.device is None:
            raise RuntimeError("call init() (or load a model) first")

    # ------------------------------------------------------------------ serde
    def save(self, path, save_updater: bool = True):
        from ..utils.serializer import save_model
        save_model(self, path, save_updater=save_updater)

    @staticmethod
    def load(path, device=None, load_updater: bool = True
             ) -> "ComputationGraph":
        from ..utils.serializer import load_model
        return load_model(path, device=device, load_updater=load_updater)


def _as_multi_iterator(data, labels=None) -> MultiDataSetIterator:
    if isinstance(data, MultiDataSetIterator):
        return data
    if isinstance(data, MultiDataSet):
        return _SingleMultiIterator(data)
    if isinstance(data, DataSet):
        return _SingleMultiIterator(MultiDataSet.from_dataset(data))
    if isinstance(data, DataSetIterator):
        return _DataSetIteratorAdapter(data)
    if labels is not None:
        f = [np.asarray(a) for a in (data if isinstance(data, (list, tuple))
                                     else [data])]
        lab = [np.asarray(a) for a in (labels
                                       if isinstance(labels, (list, tuple))
                                       else [labels])]
        return NumpyMultiDataSetIterator(f, lab, batch_size=f[0].shape[0])
    raise TypeError(f"cannot make a MultiDataSetIterator from {type(data)}")


class _SingleMultiIterator(MultiDataSetIterator):
    def __init__(self, mds: MultiDataSet):
        self._mds = mds

    def batch_size(self):
        return self._mds.num_examples()

    def __iter__(self):
        yield self._mds


class _DataSetIteratorAdapter(MultiDataSetIterator):
    """DL4J MultiDataSetIteratorAdapter: DataSetIterator -> MultiDataSet."""

    def __init__(self, it: DataSetIterator):
        self._it = it

    def batch_size(self):
        return self._it.batch_size()

    def reset(self):
        self._it.reset()

    def __iter__(self):
        for ds in self._it:
            yield MultiDataSet.from_dataset(ds)
