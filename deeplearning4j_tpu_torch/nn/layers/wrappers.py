"""Wrapper layers: FrozenLayer, RepeatVector, TimeDistributed, MaskLayer.

Port of ``deeplearning4j_tpu/nn/layers/wrappers.py`` (``FrozenLayer``
:28, ``RepeatVector`` :77, ``TimeDistributed`` :97, ``MaskLayer`` :137),
with the same JSON kinds and fields; a wrapper serializes its inner layer
under ``layer`` and holds that layer's parameters as its own.

Freezing is functional, as there: ``FrozenLayer.apply`` detaches the
wrapped layer's parameters (the counterpart of ``lax.stop_gradient``), so
autograd records nothing for a frozen stack that only frozen layers feed,
and the wrapped layer always runs as at inference (BN on its running
statistics, which therefore never move, dropout off). The engines skip
frozen layers in the l1/l2 penalty, the updater and the constraints
(``nn/training.py``), so a frozen parameter stays bit-identical through
``fit``.
"""

from __future__ import annotations

from typing import Any, Optional

from ...utils.tree import tmap
from .base import Layer, layer


def _detached(params):
    return tmap(lambda t: t.detach(), params)


@layer("frozen")
class FrozenLayer(Layer):
    """Wraps any layer; its parameters are excluded from training."""
    layer: Any = None
    name: Optional[str] = None

    frozen = True

    @property
    def needs_rng(self):
        return getattr(self.layer, "needs_rng", False)

    def has_params(self):
        return self.layer.has_params()

    def initialize(self, gen, input_shape, dtype, device):
        return self.layer.initialize(gen, input_shape, dtype, device)

    def apply(self, params, x, state, *, train=False, mask=None, rng=None):
        # train=False inside the frozen stack: BN uses running statistics
        # and dropout is off (DL4J: a frozen layer behaves as at inference
        # even during fit)
        kw = {"rng": rng} if self.needs_rng else {}
        return self.layer.apply(_detached(params), x, state, train=False,
                                mask=mask, **kw)

    # the recurrent protocol (a frozen LSTM still streams)
    def is_recurrent(self):
        return getattr(self.layer, "is_recurrent", lambda: False)()

    @property
    def supports_streaming(self):
        return getattr(self.layer, "supports_streaming", True)

    def init_stream_state(self, params, batch):
        return self.layer.init_stream_state(params, batch)

    def scan_with_state(self, params, x, carry, mask=None, grad_path=True):
        return self.layer.scan_with_state(_detached(params), x, carry, mask,
                                          grad_path=grad_path)

    def loss_value(self, out, y, mask=None, weights=None):
        return self.layer.loss_value(out, y, mask=mask, weights=weights)

    def to_dict(self):
        return {"kind": "frozen", "layer": self.layer.to_dict(),
                "name": self.name}

    @staticmethod
    def _from_dict_fields(d):
        return {"layer": Layer.from_dict(d["layer"]), "name": d.get("name")}


def is_loss_head(l) -> bool:
    """True when the (FrozenLayer-unwrapped) layer really implements
    ``loss_value``: a FrozenLayer delegates it whatever it wraps, so the
    wrapped layer is probed (the JAX ``nn/model.py`` ``_is_loss_head``)."""
    while getattr(l, "frozen", False) and getattr(l, "layer", None) \
            is not None:
        l = l.layer
    return hasattr(l, "loss_value")


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
