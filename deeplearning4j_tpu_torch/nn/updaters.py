"""Gradient updaters (optimizers).

Port of ``deeplearning4j_tpu/nn/updaters.py``: Sgd, Nesterovs, AdaGrad,
RmsProp, AdaDelta, Adam, AdaMax, AMSGrad, Nadam and NoOp, with the same
algebra, defaults, JSON (``to_dict``/``from_dict``) and state layout:
``state[slot]`` is a tree keyed like the params (``{"m": {"fc": {"W":
...}}, "v": ...}``), so the JAX package's ``updaterState.npz`` loads
unchanged and the port's loads there.

``apply`` returns the DELTA to subtract (DL4J's ``params.subi(update)``).
Every updater is elementwise. The step is a Python int (the port steps on
the host), so the learning rate and the bias corrections are host
scalars, computed in float32 as the JAX package computes them on the
device (numpy float32 arithmetic). Updates run under ``torch.no_grad`` in
the caller.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from ..utils.tree import tmap as _tmap
from . import schedules as _sched

UPDATERS = {}


def _upd(name):
    def deco(cls):
        cls = dataclasses.dataclass(cls)
        cls.kind = name
        UPDATERS[name] = cls
        return cls
    return deco


def _zeros(params):
    return _tmap(torch.zeros_like, params)


def _f32(v):
    return np.float32(v)


def _decay(beta, t):
    """``1 - beta**t`` in float32."""
    return _f32(1) - _f32(beta) ** _f32(t)


def _adam_rate(lr, b1, b2, t) -> float:
    """DL4J's Adam rate, the bias correction folded into the lr:
    ``lr * sqrt(1 - b2**t) / (1 - b1**t)`` in float32."""
    return float(_f32(lr) * np.sqrt(_decay(b2, t)) / _decay(b1, t))


class Updater:
    kind = "base"
    elementwise = True
    learning_rate: Any = 1e-3

    def lr_at(self, step: int) -> float:
        """The learning rate at ``step``, rounded to float32."""
        return float(_f32(_sched.resolve(self.learning_rate).value_at(step)))

    def init_state(self, params) -> dict:
        return {}

    def apply(self, grads, state, params, step: int):
        """-> (delta_to_subtract, new_state)"""
        raise NotImplementedError

    def to_dict(self) -> Dict:
        d = {"kind": self.kind}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, _sched.Schedule):
                v = v.to_dict()
            d[f.name] = v
        return d

    @staticmethod
    def from_dict(d) -> "Updater":
        d = dict(d)
        cls = UPDATERS[d.pop("kind")]
        if isinstance(d.get("learning_rate"), dict):
            d["learning_rate"] = _sched.Schedule.from_dict(d["learning_rate"])
        return cls(**d)


def get(name_or_updater, **kwargs) -> Updater:
    if isinstance(name_or_updater, Updater):
        return name_or_updater
    key = str(name_or_updater).lower()
    if key not in UPDATERS:
        raise ValueError(f"Unknown updater {name_or_updater!r}; known: "
                         f"{sorted(UPDATERS)}")
    return UPDATERS[key](**kwargs)


@_upd("sgd")
class Sgd(Updater):
    learning_rate: Any = 0.1

    def apply(self, grads, state, params, step):
        lr = self.lr_at(step)
        return _tmap(lambda g: lr * g, grads), state


@_upd("nesterovs")
class Nesterovs(Updater):
    """SGD with Nesterov momentum (DL4J NesterovsUpdater):
    v' = mu*v - lr*g; delta = -(mu*v' - lr*g)."""
    learning_rate: Any = 0.1
    momentum: float = 0.9

    def init_state(self, params):
        return {"v": _zeros(params)}

    def apply(self, grads, state, params, step):
        lr, mu = self.lr_at(step), self.momentum
        v_new = _tmap(lambda v, g: mu * v - lr * g, state["v"], grads)
        delta = _tmap(lambda vn, g: -(mu * vn - lr * g), v_new, grads)
        return delta, {"v": v_new}


@_upd("adagrad")
class AdaGrad(Updater):
    learning_rate: Any = 1e-1
    epsilon: float = 1e-6

    def init_state(self, params):
        return {"h": _zeros(params)}

    def apply(self, grads, state, params, step):
        lr = self.lr_at(step)
        h = _tmap(lambda h, g: h + g * g, state["h"], grads)
        delta = _tmap(lambda h, g: lr * g / (torch.sqrt(h) + self.epsilon),
                      h, grads)
        return delta, {"h": h}


@_upd("rmsprop")
class RmsProp(Updater):
    learning_rate: Any = 1e-1
    decay: float = 0.95
    epsilon: float = 1e-8

    def init_state(self, params):
        return {"g2": _zeros(params)}

    def apply(self, grads, state, params, step):
        lr = self.lr_at(step)
        g2 = _tmap(lambda a, g: self.decay * a + (1 - self.decay) * g * g,
                   state["g2"], grads)
        delta = _tmap(lambda a, g: lr * g / torch.sqrt(a + self.epsilon),
                      g2, grads)
        return delta, {"g2": g2}


@_upd("adadelta")
class AdaDelta(Updater):
    # AdaDelta has no learning rate (kept for interface uniformity)
    learning_rate: Any = 1.0
    rho: float = 0.95
    epsilon: float = 1e-6

    def init_state(self, params):
        return {"msg": _zeros(params), "msdx": _zeros(params)}

    def apply(self, grads, state, params, step):
        rho, eps = self.rho, self.epsilon
        msg = _tmap(lambda a, g: rho * a + (1 - rho) * g * g, state["msg"],
                    grads)
        delta = _tmap(lambda a, dx, g: torch.sqrt(dx + eps)
                      / torch.sqrt(a + eps) * g, msg, state["msdx"], grads)
        msdx = _tmap(lambda dx, d: rho * dx + (1 - rho) * d * d,
                     state["msdx"], delta)
        return delta, {"msg": msg, "msdx": msdx}


@_upd("adam")
class Adam(Updater):
    learning_rate: Any = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8

    def init_state(self, params):
        return {"m": _zeros(params), "v": _zeros(params)}

    def apply(self, grads, state, params, step):
        lr, t = self.lr_at(step), step + 1
        b1, b2 = self.beta1, self.beta2
        m = _tmap(lambda m, g: b1 * m + (1 - b1) * g, state["m"], grads)
        v = _tmap(lambda v, g: b2 * v + (1 - b2) * g * g, state["v"], grads)
        a = _adam_rate(lr, b1, b2, t)
        delta = _tmap(lambda m, v: a * m / (torch.sqrt(v) + self.epsilon),
                      m, v)
        return delta, {"m": m, "v": v}


@_upd("adamax")
class AdaMax(Updater):
    learning_rate: Any = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8

    def init_state(self, params):
        return {"m": _zeros(params), "u": _zeros(params)}

    def apply(self, grads, state, params, step):
        lr, t, b1 = self.lr_at(step), step + 1, self.beta1
        m = _tmap(lambda m, g: b1 * m + (1 - b1) * g, state["m"], grads)
        u = _tmap(lambda u, g: torch.maximum(self.beta2 * u, torch.abs(g)),
                  state["u"], grads)
        a = float(_f32(lr) / _decay(b1, t))
        delta = _tmap(lambda m, u: a * m / (u + self.epsilon), m, u)
        return delta, {"m": m, "u": u}


@_upd("amsgrad")
class AMSGrad(Updater):
    learning_rate: Any = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8

    def init_state(self, params):
        return {"m": _zeros(params), "v": _zeros(params),
                "vhat": _zeros(params)}

    def apply(self, grads, state, params, step):
        lr, t = self.lr_at(step), step + 1
        b1, b2 = self.beta1, self.beta2
        m = _tmap(lambda m, g: b1 * m + (1 - b1) * g, state["m"], grads)
        v = _tmap(lambda v, g: b2 * v + (1 - b2) * g * g, state["v"], grads)
        vhat = _tmap(torch.maximum, state["vhat"], v)
        a = _adam_rate(lr, b1, b2, t)
        delta = _tmap(lambda m, vh: a * m / (torch.sqrt(vh) + self.epsilon),
                      m, vhat)
        return delta, {"m": m, "v": v, "vhat": vhat}


@_upd("nadam")
class Nadam(Updater):
    learning_rate: Any = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8

    def init_state(self, params):
        return {"m": _zeros(params), "v": _zeros(params)}

    def apply(self, grads, state, params, step):
        lr, t = self.lr_at(step), step + 1
        b1, b2 = self.beta1, self.beta2
        m = _tmap(lambda m, g: b1 * m + (1 - b1) * g, state["m"], grads)
        v = _tmap(lambda v, g: b2 * v + (1 - b2) * g * g, state["v"], grads)
        mc, vc = float(_decay(b1, t)), float(_decay(b2, t))
        delta = _tmap(
            lambda m, v, g: lr / (torch.sqrt(v / vc) + self.epsilon)
            * (b1 * m / mc + (1 - b1) * g / mc), m, v, grads)
        return delta, {"m": m, "v": v}


@_upd("noop")
class NoOp(Updater):
    learning_rate: Any = 0.0

    def apply(self, grads, state, params, step):
        return _tmap(torch.zeros_like, grads), state


def apply_leaf(updater, grad, slots, param, step):
    """One tensor's update: ``slots`` is its slice of the updater state
    (``{"m": m, "v": v}`` for Adam); returns ``(new_param, new_slots)``."""
    delta, new_slots = updater.apply(grad, slots, param, step)
    return param - delta, new_slots


def apply_leafwise(updater, grads, state, params, step):
    """The updater over the whole params tree: ``(new_params,
    new_state)``."""
    delta, new_state = updater.apply(grads, state, params, step)
    return _tmap(lambda p, d: p - d, params, delta), new_state


def _cast_leaf(p, compute_dtype):
    """One leaf of ``dtypes.cast_floating``: a floating tensor to the
    compute dtype, anything else untouched, so the fused outputs are
    exactly what a ``cast_floating`` sweep over the new params gives."""
    if isinstance(p, torch.Tensor) and p.is_floating_point():
        return p.to(compute_dtype)
    return p


def apply_leaf_cast(updater, grad, slots, param, step, compute_dtype):
    """:func:`apply_leaf` with the mixed-precision master cast folded into
    the parameter write: ``(new_param, new_param_compute, new_slots)``.
    The f32 master arithmetic is :func:`apply_leaf`'s, bit for bit, and
    the compute copy is the f32 -> 16-bit rounding of the new master, so
    a fused trajectory equals the unfused one bit for bit. Eager torch
    has no fusion to ride: the cast is one more elementwise kernel a
    tensor, made where the master is written instead of in a sweep at
    the top of the next forward."""
    new_param, new_slots = apply_leaf(updater, grad, slots, param, step)
    return new_param, _cast_leaf(new_param, compute_dtype), new_slots


def apply_leafwise_cast(updater, grads, state, params, step, compute_dtype):
    """Tree-level :func:`apply_leaf_cast`, the form the fused train step
    uses: ``(new_params, new_params_compute, new_state)``."""
    new_params, new_state = apply_leafwise(updater, grads, state, params,
                                           step)
    new_params_c = _tmap(lambda p: _cast_leaf(p, compute_dtype), new_params)
    return new_params, new_params_c, new_state
