"""Graph vertices for the ComputationGraph engine.

Port of ``GraphVertex``, ``LayerVertex``, ``MergeVertex`` (:154),
``ElementWiseVertex`` and ``DotProductVertex`` (:228) from
``deeplearning4j_tpu/nn/vertices.py``; the JAX package's other vertex
kinds are not ported yet (ROADMAP Queue 1 item 10). A vertex is a config dataclass;
its ``apply`` runs eagerly on tensors.

Protocol (the multi-input form of the Layer protocol):

- ``initialize(gen, input_shapes, dtype, device) -> (params, state,
  output_shape)``; shapes exclude the batch dim.
- ``apply(params, xs, state, *, train=False, masks=None) -> (y,
  new_state, out_mask)``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from .layers import DenseLayer, Layer, OutputLayer

VERTICES: Dict[str, type] = {}


def vertex(kind: str):
    """Class decorator: dataclass vertex registered for serde."""
    def deco(cls):
        cls = dataclasses.dataclass(cls)
        cls.kind = kind
        VERTICES[kind] = cls
        return cls
    return deco


class GraphVertex:
    kind = "base"

    def initialize(self, gen, input_shapes, dtype, device):
        """-> (params, state, output_shape)"""
        return {}, {}, tuple(input_shapes[0])

    def apply(self, params, xs, state, *, train=False, masks=None):
        """-> (y, new_state, out_mask)"""
        raise NotImplementedError

    def has_params(self) -> bool:
        return False

    def to_dict(self) -> Dict[str, Any]:
        d = {"kind": self.kind}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            d[f.name] = list(v) if isinstance(v, tuple) else v
        return d

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "GraphVertex":
        d = dict(d)
        kind = d.pop("kind")
        if kind == "layer":
            return LayerVertex(layer=Layer.from_dict(d["layer"]))
        if kind not in VERTICES:
            raise ValueError(f"Unknown vertex kind {kind!r}; known: "
                             f"{sorted(VERTICES)}")
        cls = VERTICES[kind]
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: (tuple(v) if isinstance(v, list) else v)
                      for k, v in d.items() if k in names})


def _first_mask(masks):
    for m in masks or ():
        if m is not None:
            return m
    return None


@vertex("layer")
class LayerVertex(GraphVertex):
    """Wraps a Layer as a single-input vertex (DL4J ``LayerVertex``).

    Auto-flatten: a Dense/Output layer fed a rank-3 CNN shape flattens its
    input first (DL4J's CnnToFeedForwardPreProcessor). The decision is
    made at initialize() from the propagated shape and not serialized."""
    layer: Layer = None

    def __post_init__(self):
        self._flatten = False

    def has_params(self) -> bool:
        return self.layer.has_params()

    @property
    def needs_rng(self) -> bool:
        """The wrapped layer takes the model's generator (dropout)."""
        return getattr(self.layer, "needs_rng", False)

    def initialize(self, gen, input_shapes, dtype, device):
        if len(input_shapes) != 1:
            raise ValueError(f"LayerVertex({self.layer.kind}) takes one "
                             f"input, got {len(input_shapes)}")
        shape = tuple(input_shapes[0])
        self._flatten = (isinstance(self.layer, (DenseLayer, OutputLayer))
                         and len(shape) == 3)
        if self._flatten:
            flat = 1
            for s in shape:
                flat *= int(s)
            shape = (flat,)
        return self.layer.initialize(gen, shape, dtype, device)

    def apply(self, params, xs, state, *, train=False, masks=None,
              fold_act=None, rng=None):
        x = xs[0]
        if self._flatten:
            x = x.reshape(x.shape[0], -1)
        mask = _first_mask(masks)
        if fold_act is not None:  # BN + activation epilogue fold
            return self.layer.apply(params, x, state, train=train,
                                    mask=mask, fold_act=fold_act)
        kw = {"rng": rng} if rng is not None else {}
        return self.layer.apply(params, x, state, train=train, mask=mask,
                                **kw)

    def to_dict(self):
        return {"kind": "layer", "layer": self.layer.to_dict()}


@vertex("merge")
class MergeVertex(GraphVertex):
    """Concatenate along the feature/channel axis (DL4J ``MergeVertex``):
    [B,F] -> 1; recurrent [B,T,F] -> 2; CNN -> 1 for NCHW, the last for
    NHWC."""
    data_format: str = "NCHW"

    def _axis(self, ndim):
        if ndim <= 3:
            return ndim - 1
        return 1 if self.data_format == "NCHW" else ndim - 1

    def initialize(self, gen, input_shapes, dtype, device):
        shapes = [tuple(s) for s in input_shapes]
        for s in shapes[1:]:
            if len(s) != len(shapes[0]):
                raise ValueError(f"merge rank mismatch: {shapes}")
        ax = self._axis(len(shapes[0]) + 1) - 1  # shapes exclude the batch
        for s in shapes[1:]:
            for d in range(len(s)):
                if d != ax and int(s[d]) != int(shapes[0][d]):
                    raise ValueError(
                        f"merge non-concat dim {d} mismatch: {shapes}")
        merged = list(shapes[0])
        merged[ax] = sum(int(s[ax]) for s in shapes)
        return {}, {}, tuple(merged)

    def apply(self, params, xs, state, *, train=False, masks=None):
        return (torch.cat(list(xs), dim=self._axis(xs[0].ndim)), state,
                _first_mask(masks))


@vertex("elementwise")
class ElementWiseVertex(GraphVertex):
    """Pointwise combine: Add/Subtract/Product/Average/Max/Min
    (DL4J ``ElementWiseVertex``). The residual-connection workhorse."""
    op: str = "add"

    def initialize(self, gen, input_shapes, dtype, device):
        return {}, {}, tuple(input_shapes[0])

    def apply(self, params, xs, state, *, train=False, masks=None):
        op = self.op.lower()
        if op == "add":
            y = xs[0]
            for x in xs[1:]:
                y = y + x
        elif op == "subtract":
            if len(xs) != 2:
                raise ValueError("subtract takes exactly 2 inputs")
            y = xs[0] - xs[1]
        elif op in ("product", "mult"):
            y = xs[0]
            for x in xs[1:]:
                y = y * x
        elif op in ("average", "avg"):
            y = sum(xs) / len(xs)
        elif op == "max":
            y = xs[0]
            for x in xs[1:]:
                y = torch.maximum(y, x)
        elif op == "min":
            y = xs[0]
            for x in xs[1:]:
                y = torch.minimum(y, x)
        else:
            raise ValueError(f"unknown elementwise op {self.op!r}")
        return y, state, _first_mask(masks)


@vertex("dot_product")
class DotProductVertex(GraphVertex):
    """Batch dot product of two equal-shape ``[B, n]`` inputs along
    ``axis`` (Keras ``Dot(axes=k)``), the axis kept as length 1."""
    axis: int = -1

    def initialize(self, gen, input_shapes, dtype, device):
        a = list(input_shapes[0])
        ax = self.axis
        # shapes exclude the batch; axis counts it as 0, as Keras does
        a[(ax - 1) if ax > 0 else (len(a) + ax)] = 1
        return {}, {}, tuple(a)

    def apply(self, params, xs, state, *, train=False, masks=None):
        if len(xs) != 2:
            raise ValueError("Dot takes exactly 2 inputs")
        a, b = xs
        if a.shape != b.shape:
            raise ValueError(
                f"Dot supports equal-shape inputs, got {tuple(a.shape)} vs "
                f"{tuple(b.shape)} (matmul-style axes pairs not supported)")
        if a.ndim > 2:
            # Keras batch_dot on rank >= 3 is a matmul-style contraction
            raise ValueError(
                f"Dot supports one non-batch dim, got rank {a.ndim} "
                "(batch_dot matmul semantics not implemented)")
        return (torch.sum(a * b, dim=self.axis, keepdim=True), state,
                _first_mask(masks))
