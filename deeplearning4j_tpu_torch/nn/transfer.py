"""Transfer learning: freeze, re-head and fine-tune trained models.

Port of ``deeplearning4j_tpu/nn/transfer.py`` (DL4J's
``TransferLearning``, ``FineTuneConfiguration`` and
``TransferLearningHelper``). Surgery happens on the configuration (layers
are immutable dataclasses); then a fresh network is initialized on the old
network's device and the surviving parameters and state are carried over
by index or vertex name, unchanged. Re-initialized layers draw from the
port's seeded ``torch.Generator`` (``init``), not the JAX package's
threefry stream. Freezing wraps layers in :class:`FrozenLayer`, whose
detached parameters keep autograd from recording the frozen stack's
backward at all.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Set, Tuple

import torch

from .. import environment as _env
from .config import MultiLayerConfiguration, _infer_shape
from .graph import ComputationGraph, ComputationGraphConfiguration
from .layers.base import Layer
from .layers.core import DenseLayer, FlattenLayer, OutputLayer
from .layers.wrappers import FrozenLayer
from .model import MultiLayerNetwork
from .vertices import LayerVertex


@dataclasses.dataclass
class FineTuneConfiguration:
    """Overrides applied to the transferred net (DL4J
    ``FineTuneConfiguration``): anything left None keeps the original."""
    updater: Any = None
    l1: Optional[float] = None
    l2: Optional[float] = None
    seed: Optional[int] = None
    gradient_clip_value: Optional[float] = None
    gradient_clip_l2: Optional[float] = None

    def _apply(self, kw: Dict[str, Any]) -> Dict[str, Any]:
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if v is not None:
                kw[f.name] = v
        return kw


def _freeze(l: Layer) -> Layer:
    return l if isinstance(l, FrozenLayer) or not l.has_params() \
        else FrozenLayer(layer=l)


class TransferLearning:
    """DL4J's namespace: ``TransferLearning.Builder`` for a
    MultiLayerNetwork, ``TransferLearning.GraphBuilder`` for a
    ComputationGraph."""

    class Builder:
        def __init__(self, model: MultiLayerNetwork):
            self._model = model
            self._ftc = FineTuneConfiguration()
            self._freeze_until = -1          # inclusive layer index
            self._nout_replaced: Dict[int, Tuple[int, Optional[str]]] = {}
            self._remove_from_output = 0
            self._added: List[Layer] = []

        def fine_tune_configuration(self, ftc: FineTuneConfiguration):
            self._ftc = ftc
            return self

        def set_feature_extractor(self, layer_idx: int):
            """Freeze layers 0..layer_idx inclusive."""
            self._freeze_until = int(layer_idx)
            return self

        def nout_replace(self, layer_idx: int, nout: int,
                         weight_init: Optional[str] = None):
            """Change a layer's output width; its parameters AND the next
            parameterized layer's are re-initialized (the fan-in changed),
            as DL4J's nOutReplace does."""
            self._nout_replaced[int(layer_idx)] = (int(nout), weight_init)
            return self

        def remove_output_layers(self, n: int = 1):
            self._remove_from_output = int(n)
            return self

        # DL4J spelling
        def remove_output_layer(self):
            return self.remove_output_layers(1)

        def add_layer(self, l: Layer):
            self._added.append(l)
            return self

        def build(self) -> MultiLayerNetwork:
            old = self._model
            conf = old.conf
            layers = list(conf.layers)
            if self._remove_from_output:
                layers = layers[:len(layers) - self._remove_from_output]

            # src[i]: the old layer whose parameters layer i inherits, or
            # None for a re-initialized layer
            src: List[Optional[int]] = list(range(len(layers)))

            for idx, (nout, winit) in sorted(self._nout_replaced.items()):
                l = layers[idx]
                if not hasattr(l, "n_out"):
                    raise ValueError(f"layer {idx} ({l.kind}) has no n_out")
                kw = {"n_out": nout}
                if winit is not None and hasattr(l, "weight_init"):
                    kw["weight_init"] = winit
                layers[idx] = dataclasses.replace(l, **kw)
                src[idx] = None
                for j in range(idx + 1, len(layers)):  # fan-in changed
                    if layers[j].has_params():
                        src[j] = None
                        break

            for i in range(min(self._freeze_until + 1, len(layers))):
                layers[i] = _freeze(layers[i])

            # the new head; a Flatten goes in at a conv -> dense seam, as
            # the configuration builder's _auto_flatten would put it
            if self._added:
                shape = conf.input_shape
                for l in layers:
                    shape = _infer_shape(l, shape) if shape is not None \
                        else None
                for l in self._added:
                    if (isinstance(l, (DenseLayer, OutputLayer))
                            and shape is not None and len(shape) == 3):
                        fl = FlattenLayer()
                        layers.append(fl)
                        src.append(None)
                        shape = _infer_shape(fl, shape)
                    layers.append(l)
                    src.append(None)
                    shape = _infer_shape(l, shape) if shape is not None \
                        else None

            kw = dict(layers=layers, input_shape=conf.input_shape,
                      seed=conf.seed, dtype=conf.dtype, updater=conf.updater,
                      l1=conf.l1, l2=conf.l2,
                      gradient_clip_value=conf.gradient_clip_value,
                      gradient_clip_l2=conf.gradient_clip_l2,
                      tbptt_length=conf.tbptt_length,
                      constraints=conf.constraints)
            new_conf = MultiLayerConfiguration(**self._ftc._apply(kw))
            net = MultiLayerNetwork(new_conf).init(device=old.device)
            params, state = dict(net.params), dict(net.state)
            for i, s in enumerate(src):
                if s is None:
                    continue
                si, so = str(i), str(s)
                if so in old.params:
                    params[si] = old.params[so]
                if so in old.state:
                    state[si] = old.state[so]
            net.params, net.state = params, state
            net.updater_state = new_conf.updater.init_state(params) \
                if new_conf.updater else {}
            return net

    class GraphBuilder:
        def __init__(self, graph: ComputationGraph):
            self._graph = graph
            self._ftc = FineTuneConfiguration()
            self._frozen_roots: List[str] = []
            self._removed: Dict[str, bool] = {}  # name -> remove_outputs
            self._added: List[Tuple[str, Any, List[str]]] = []
            self._outputs: Optional[List[str]] = None

        def fine_tune_configuration(self, ftc: FineTuneConfiguration):
            self._ftc = ftc
            return self

        def set_feature_extractor(self, *vertex_names: str):
            """Freeze the named vertices and everything upstream of
            them."""
            self._frozen_roots.extend(vertex_names)
            return self

        def remove_vertex(self, name: str, remove_outputs: bool = True):
            """``remove_outputs=True`` drops the vertex AND everything
            downstream (DL4J ``removeVertexAndConnections``); False drops
            only the vertex and keeps its consumers wired to the name
            (``removeVertexKeepConnections``): add a replacement under the
            SAME name before ``build()``, which rejects a dangling
            reference."""
            self._removed[name] = bool(remove_outputs)
            return self

        def add_layer(self, name: str, l: Layer, *inputs: str):
            self._added.append((name, LayerVertex(layer=l), list(inputs)))
            return self

        def add_vertex(self, name: str, vertex, *inputs: str):
            self._added.append((name, vertex, list(inputs)))
            return self

        def set_outputs(self, *names: str):
            self._outputs = list(names)
            return self

        def build(self) -> ComputationGraph:
            old = self._graph
            conf = old.conf
            producers = {n: ins for n, _, ins in conf.vertices}
            frozen: Set[str] = set()

            def mark(n: str):
                if n in frozen or n in conf.inputs:
                    return
                frozen.add(n)
                for i in producers.get(n, []):
                    mark(i)

            for r in self._frozen_roots:
                if r not in producers:
                    raise ValueError(f"unknown vertex {r!r}")
                mark(r)

            # drop cascade-removed vertices and everything downstream of
            # them; keep-connections removals drop only the vertex itself
            cascade = {n for n, ro in self._removed.items() if ro}
            keep_conn = {n for n, ro in self._removed.items() if not ro}
            dropped: Set[str] = set()
            changed = True
            names_in_order = [n for n, _, _ in conf.vertices]
            while changed:
                changed = False
                for n in names_in_order:
                    if n in dropped:
                        continue
                    if n in cascade or any(i in dropped
                                           for i in producers[n]):
                        dropped.add(n)
                        changed = True
            dropped |= keep_conn

            vertices: List[Tuple[str, Any, List[str]]] = []
            copy_names: Set[str] = set()
            for n, v, ins in conf.vertices:
                if n in dropped:
                    continue
                if n in frozen and isinstance(v, LayerVertex) and \
                        v.has_params():
                    v = LayerVertex(layer=_freeze(v.layer))
                vertices.append((n, v, list(ins)))
                copy_names.add(n)
            vertices.extend(self._added)

            avail = set(conf.inputs) | {n for n, _, _ in vertices}
            for n, _, ins in vertices:
                for i in ins:
                    if i not in avail:
                        raise ValueError(
                            f"vertex {n!r} consumes {i!r}, which was removed "
                            "(remove_outputs=False) and not re-added — "
                            "add_layer/add_vertex a replacement with that "
                            "name")

            # default outputs: the old ones that survive the surgery (a
            # keep-connections removal re-added under its name keeps its
            # output slot)
            final_names = {n for n, _, _ in vertices}
            outputs = self._outputs if self._outputs is not None else \
                [o for o in conf.outputs if o in final_names]
            if not outputs:
                raise ValueError("transfer result has no outputs; call "
                                 "set_outputs(...)")

            kw = dict(inputs=conf.inputs, outputs=outputs, vertices=vertices,
                      input_shapes=conf.input_shapes, seed=conf.seed,
                      dtype=conf.dtype, updater=conf.updater, l1=conf.l1,
                      l2=conf.l2,
                      gradient_clip_value=conf.gradient_clip_value,
                      gradient_clip_l2=conf.gradient_clip_l2,
                      tbptt_length=conf.tbptt_length,
                      constraints=conf.constraints)
            new_conf = ComputationGraphConfiguration(**self._ftc._apply(kw))
            net = ComputationGraph(new_conf).init(device=old.device)
            params, state = dict(net.params), dict(net.state)
            for n in copy_names:
                if n in old.params:
                    params[n] = old.params[n]
                if n in old.state:
                    state[n] = old.state[n]
            net.params, net.state = params, state
            net.updater_state = new_conf.updater.init_state(params) \
                if new_conf.updater else {}
            return net


class TransferLearningHelper:
    """Featurize once (DL4J ``TransferLearningHelper``): run the frozen
    prefix of a MultiLayerNetwork once per dataset and train only the
    unfrozen tail on the cached features."""

    def __init__(self, net: MultiLayerNetwork):
        self.net = net
        self._split = max((int(k) + 1 for k in net._frozen), default=0)

    def featurize(self, ds):
        """A DataSet of the frozen prefix's activations (numpy)."""
        from ..data.dataset import DataSet
        net = self.net
        x = net._tensor(ds.features)
        mask = None if ds.features_mask is None else \
            net._tensor(ds.features_mask)
        with torch.inference_mode(), _env.precision(net.device):
            for i in range(self._split):
                x, _, mask = net.layers[i].apply(
                    net.params.get(str(i), {}), x, net.state.get(str(i), {}),
                    train=False, mask=mask)
            feats = x.cpu().numpy()
            fmask = None if mask is None else mask.cpu().numpy()
        return DataSet(feats, ds.labels, features_mask=fmask,
                       labels_mask=ds.labels_mask)

    def unfrozen_graph(self) -> MultiLayerNetwork:
        """The trainable tail as its own network, sharing the parameter
        tensors."""
        conf = self.net.conf
        tail = conf.layers[self._split:]
        shape = conf.input_shape
        for l in conf.layers[:self._split]:
            shape = _infer_shape(l, shape) if shape is not None else None
        new_conf = MultiLayerConfiguration(
            layers=tail, input_shape=shape, seed=conf.seed, dtype=conf.dtype,
            updater=conf.updater, l1=conf.l1, l2=conf.l2,
            gradient_clip_value=conf.gradient_clip_value,
            gradient_clip_l2=conf.gradient_clip_l2,
            tbptt_length=conf.tbptt_length)
        n = len(conf.layers)
        net = MultiLayerNetwork(new_conf)
        net.params = {str(i - self._split): self.net.params[str(i)]
                      for i in range(self._split, n)
                      if str(i) in self.net.params}
        net.state = {str(i - self._split): self.net.state[str(i)]
                     for i in range(self._split, n)
                     if str(i) in self.net.state}
        net.updater_state = new_conf.updater.init_state(net.params) \
            if new_conf.updater else {}
        net.device = self.net.device
        return net

    def fit_featurized(self, ds, epochs: int = 1):
        """Train the tail on featurized data, then write the tail's
        parameters and state back into the full net."""
        tail = self.unfrozen_graph()
        tail.fit(ds, epochs=epochs)
        for i in range(self._split, len(self.net.conf.layers)):
            si = str(i - self._split)
            if si in tail.params:
                self.net.params[str(i)] = tail.params[si]
            if si in tail.state:
                self.net.state[str(i)] = tail.state[si]
        return self.net
