"""Wrapper layers: RepeatVector, TimeDistributed, MaskLayer.

Port of those layers of ``deeplearning4j_tpu/nn/layers/wrappers.py``
(``RepeatVector`` :77, ``TimeDistributed`` :97, ``MaskLayer`` :137), with
the same JSON kinds and fields; a ``TimeDistributed`` serializes its
inner layer under ``layer`` and holds that layer's parameters as its
own.

Not in this slice: ``FrozenLayer`` (:28), which comes with the
training-breadth slice of the port (``ROADMAP.md`` Queue 1 item 3).
"""

from __future__ import annotations

from typing import Any, Optional

from .base import Layer, layer


@layer("repeat_vector")
class RepeatVector(Layer):
    """``[B, F] -> [B, n, F]`` (DL4J ``RepeatVector``): a feed-forward
    encoding fed to a recurrent decoder. The new time axis has no mask."""
    n: int = 1
    name: Optional[str] = None

    def has_params(self):
        return False

    def initialize(self, gen, input_shape, dtype, device):
        if len(input_shape) != 1:
            raise ValueError(f"RepeatVector expects [F], got {input_shape}")
        return {}, {}, (self.n, int(input_shape[0]))

    def apply(self, params, x, state, *, train=False, mask=None):
        return x[:, None, :].expand(-1, self.n, -1), {}, None


@layer("time_distributed")
class TimeDistributed(Layer):
    """A feed-forward layer at every step of ``[B, T, F]`` (DL4J
    ``TimeDistributed``), with time folded into the batch: one call on
    ``[B*T, F]``. The per-step mask passes through unchanged."""
    layer: Any = None
    name: Optional[str] = None

    @property
    def needs_rng(self):
        return getattr(self.layer, "needs_rng", False)

    def has_params(self):
        return self.layer.has_params()

    def initialize(self, gen, input_shape, dtype, device):
        if len(input_shape) != 2:
            raise ValueError(
                f"TimeDistributed expects [T,F], got {input_shape}")
        t, f = input_shape
        p, s, out = self.layer.initialize(gen, (f,), dtype, device)
        return p, s, (t,) + tuple(out)

    def apply(self, params, x, state, *, train=False, mask=None, rng=None):
        b, t = x.shape[0], x.shape[1]
        kw = {"rng": rng} if self.needs_rng else {}
        y, s_new, _ = self.layer.apply(
            params, x.reshape((b * t,) + tuple(x.shape[2:])), state,
            train=train, mask=None, **kw)
        return y.reshape((b, t) + tuple(y.shape[1:])), s_new, mask

    def to_dict(self):
        return {"kind": "time_distributed", "layer": self.layer.to_dict(),
                "name": self.name}

    @staticmethod
    def _from_dict_fields(d):
        return {"layer": Layer.from_dict(d["layer"]), "name": d.get("name")}


@layer("mask_layer")
class MaskLayer(Layer):
    """Zero the activations at masked steps (DL4J ``MaskLayer``), so what
    follows sees hard zeros there; the mask passes through."""
    name: Optional[str] = None

    def has_params(self):
        return False

    def apply(self, params, x, state, *, train=False, mask=None):
        if mask is None:
            return x, {}, None
        m = mask
        while m.dim() < x.dim():
            m = m[..., None]
        return x * m.to(x.dtype), {}, mask
