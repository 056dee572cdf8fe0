"""Learning-rate (and value) schedules.

Port of ``deeplearning4j_tpu/nn/schedules.py`` (DL4J's ``ISchedule``
family). A schedule maps the iteration to a value. The port steps on the
host, so ``value_at`` takes the iteration as a Python int and returns a
Python float: no device value, no host sync. JSON round-trips through
``to_dict``/``from_dict`` exactly as the JAX package's.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict

_SCHEDULES = {}


def _sched(name):
    def deco(cls):
        cls = dataclasses.dataclass(cls)
        cls.kind = name
        _SCHEDULES[name] = cls
        return cls
    return deco


class Schedule:
    kind = "base"

    def value_at(self, iteration: int, epoch: int = 0) -> float:
        raise NotImplementedError

    def to_dict(self) -> Dict:
        d = {"kind": self.kind}
        d.update(dataclasses.asdict(self))
        return d

    @staticmethod
    def from_dict(d):
        if d is None:
            return None
        d = dict(d)
        cls = _SCHEDULES[d.pop("kind")]
        return cls(**d)


def resolve(value) -> Schedule:
    """A float (fixed) or a Schedule -> a Schedule."""
    if isinstance(value, Schedule):
        return value
    return Fixed(float(value))


@_sched("fixed")
class Fixed(Schedule):
    value: float = 1e-3

    def value_at(self, iteration, epoch=0):
        return self.value


@_sched("exponential")
class ExponentialSchedule(Schedule):
    """value * gamma^iter (DL4J ExponentialSchedule)."""
    initial_value: float = 1e-3
    gamma: float = 0.99

    def value_at(self, iteration, epoch=0):
        return self.initial_value * self.gamma ** iteration


@_sched("inverse")
class InverseSchedule(Schedule):
    """value / (1 + gamma*iter)^power (DL4J InverseSchedule)."""
    initial_value: float = 1e-3
    gamma: float = 0.99
    power: float = 1.0

    def value_at(self, iteration, epoch=0):
        return self.initial_value / (1.0 + self.gamma * iteration) \
            ** self.power


@_sched("poly")
class PolySchedule(Schedule):
    """value * (1 - iter/maxIter)^power (DL4J PolySchedule)."""
    initial_value: float = 1e-3
    power: float = 1.0
    max_iter: int = 10000

    def value_at(self, iteration, epoch=0):
        frac = min(iteration / self.max_iter, 1.0)
        return self.initial_value * (1.0 - frac) ** self.power


@_sched("sigmoid")
class SigmoidSchedule(Schedule):
    """value / (1 + exp(-gamma*(iter-stepSize))) (DL4J SigmoidSchedule)."""
    initial_value: float = 1e-3
    gamma: float = 0.99
    step_size: int = 1000

    def value_at(self, iteration, epoch=0):
        return self.initial_value / (
            1.0 + math.exp(-self.gamma * (iteration - self.step_size)))


@_sched("step")
class StepSchedule(Schedule):
    """value * decayRate^floor(iter/step) (DL4J StepSchedule)."""
    initial_value: float = 1e-3
    decay_rate: float = 0.1
    step: float = 1000.0

    def value_at(self, iteration, epoch=0):
        return self.initial_value * self.decay_rate ** math.floor(
            iteration / self.step)


@_sched("cosine")
class CosineSchedule(Schedule):
    """Cosine annealing to min_value over max_iter."""
    initial_value: float = 1e-3
    min_value: float = 0.0
    max_iter: int = 10000

    def value_at(self, iteration, epoch=0):
        frac = min(iteration / self.max_iter, 1.0)
        return self.min_value + 0.5 * (self.initial_value - self.min_value) \
            * (1.0 + math.cos(math.pi * frac))


@_sched("warmup_linear")
class WarmupLinearSchedule(Schedule):
    """Linear warmup then linear decay (the BERT fine-tune shape)."""
    peak_value: float = 1e-4
    warmup_iters: int = 100
    max_iter: int = 10000

    def value_at(self, iteration, epoch=0):
        if iteration < self.warmup_iters:
            return self.peak_value * iteration / max(self.warmup_iters, 1)
        return self.peak_value * max(0.0, (self.max_iter - iteration) / max(
            self.max_iter - self.warmup_iters, 1))


@_sched("map")
class MapSchedule(Schedule):
    """Piecewise-constant by iteration breakpoints (DL4J MapSchedule):
    ``values`` maps an iteration to the value that holds from it on."""
    values: Dict[int, float] = dataclasses.field(default_factory=dict)

    def value_at(self, iteration, epoch=0):
        items = sorted((int(k), float(v)) for k, v in self.values.items())
        out = items[0][1]
        for it, v in items:
            if iteration >= it:
                out = v
        return out
