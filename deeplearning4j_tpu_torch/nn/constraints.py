"""Parameter constraints, applied after each update step.

Port of ``deeplearning4j_tpu/nn/constraints.py`` (DL4J's MaxNorm,
MinMaxNorm, UnitNorm and NonNegative constraints). Scope mirrors DL4J's
``constrainWeights``/``constrainBias``/``constrainAllParameters``:
'W'-named params, 'b'-named params, or all. The norm is taken over every
axis except the output-unit axis (the last for ``[in, out]`` dense
weights, the first for OIHW conv kernels). JSON round-trips as the JAX
package's (``encode_constraints``/``decode_constraints``).
"""

from __future__ import annotations

import dataclasses

import torch

CONSTRAINTS = {}


def _constraint(kind):
    def deco(cls):
        cls = dataclasses.dataclass(cls)
        cls.kind = kind
        CONSTRAINTS[kind] = cls
        return cls
    return deco


def _unit_axes(a):
    """Every axis but the output-unit axis (None: the whole vector)."""
    if a.ndim <= 1:
        return None
    if a.ndim == 2:
        return (0,)
    return tuple(range(1, a.ndim))


class BaseConstraint:
    kind = "base"

    def apply(self, a):
        raise NotImplementedError

    def to_dict(self):
        d = {"kind": self.kind}
        for f in dataclasses.fields(self):
            d[f.name] = getattr(self, f.name)
        return d

    @staticmethod
    def from_dict(d):
        d = dict(d)
        cls = CONSTRAINTS[d.pop("kind")]
        return cls(**d)


def _norms(a):
    axes = _unit_axes(a)
    if axes is None:
        n = torch.sqrt(torch.sum(a * a))
    else:
        n = torch.sqrt(torch.sum(a * a, dim=axes, keepdim=True))
    return torch.clamp(n, min=1e-12)


@_constraint("max_norm")
class MaxNormConstraint(BaseConstraint):
    max_norm: float = 2.0

    def apply(self, a):
        return a * torch.clamp(self.max_norm / _norms(a), max=1.0)


@_constraint("min_max_norm")
class MinMaxNormConstraint(BaseConstraint):
    min_norm: float = 0.5
    max_norm: float = 2.0
    rate: float = 1.0  # 1.0 = hard projection (DL4J default)

    def apply(self, a):
        n = _norms(a)
        clipped = torch.clamp(n, self.min_norm, self.max_norm)
        target = self.rate * clipped + (1.0 - self.rate) * n
        return a * (target / n)


@_constraint("unit_norm")
class UnitNormConstraint(BaseConstraint):
    def apply(self, a):
        return a / _norms(a)


@_constraint("non_negative")
class NonNegativeConstraint(BaseConstraint):
    def apply(self, a):
        return torch.clamp(a, min=0.0)


_SCOPE_W = ("W", "RW", "PW", "dW", "pW", "Wq", "Wk", "Wv", "Wo", "Wx", "Wr",
            "Wc", "Wa")


def apply_constraints(constraints, params, skip=()):
    """Every (constraint, scope) pair over the params tree; ``scope`` is
    "weights", "bias" or "all". ``skip``: top-level keys left untouched
    (frozen layers)."""
    if not constraints:
        return params
    skip = set(skip)

    def transform(name, leaf):
        out = leaf
        for c, scope in constraints:
            if scope == "all" or \
                    (scope == "weights" and name in _SCOPE_W) or \
                    (scope == "bias" and name == "b"):
                out = c.apply(out)
        return out

    def walk(node):
        return {k: walk(v) if isinstance(v, dict) else transform(k, v)
                for k, v in node.items()}

    return {k: (v if k in skip else
                (walk(v) if isinstance(v, dict) else transform(k, v)))
            for k, v in params.items()}


def encode_constraints(constraints):
    return [[c.to_dict(), scope] for c, scope in constraints or []]


def decode_constraints(data):
    return [(BaseConstraint.from_dict(d), scope) for d, scope in data or []]
