"""Sampling primitives of the generative decode loop.

Port of ``deeplearning4j_tpu/ops/sampling.py``. They run on the logits'
device, so a multi-token decode horizon samples without a host readback:

- :func:`greedy`: argmax over the vocabulary axis, the first maximum on
  ties (``torch.argmax``'s documented rule on every device), so it equals
  the host oracle ``np.argmax`` bit for bit;
- :func:`categorical`: temperature softmax sampling by the Gumbel-max
  trick;
- :func:`top_k`: top-k filtered temperature sampling;
- :func:`eos_hit`: per-slot EOS detection for the write gate.

:class:`SamplingSpec` holds the method and k; temperature stays a runtime
scalar.

Divergences: a ``torch.Generator`` on the logits' device takes the place
of the JAX package's threaded PRNG key (the two streams differ, so the
draws agree only in distribution), and the primitives are not catalog
ops (the port's SameDiff records no decode graph yet).
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["greedy", "categorical", "top_k", "eos_hit", "SamplingSpec",
           "GREEDY"]

_TEMP_FLOOR = 1e-6


def greedy(logits):
    """Greedy token selection: argmax over the last axis -> int32."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def categorical(logits, generator, temperature=1.0):
    """Temperature softmax sampling by the Gumbel-max trick:
    ``argmax(logits / T + G)`` with ``G = -log(E)``, ``E ~ Exp(1)`` drawn
    from ``generator``, is a draw from ``softmax(logits / T)``."""
    t = max(float(temperature), _TEMP_FLOOR)
    e = torch.empty(logits.shape, dtype=torch.float32,
                    device=logits.device).exponential_(generator=generator)
    g = -torch.log(e)
    return torch.argmax(logits.float() / t + g, dim=-1).to(torch.int32)


def top_k(logits, generator, k, temperature=1.0):
    """Top-k filtered temperature sampling: logits below the k-th largest
    of their row are set to ``finfo.min`` before :func:`categorical`."""
    k = int(k)
    if k <= 0:
        raise ValueError("top_k requires k >= 1")
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    neg = torch.finfo(logits.dtype).min
    masked = torch.where(logits < kth, torch.full_like(logits, neg), logits)
    return categorical(masked, generator, temperature)


def eos_hit(tokens, eos_ids):
    """Per-slot EOS detection: int32 1 where the sampled token ends its
    stream; ``eos_ids`` holds one id per slot, -1 for none."""
    return ((eos_ids >= 0) & (tokens == eos_ids)).to(torch.int32)


@dataclasses.dataclass(frozen=True)
class SamplingSpec:
    """Sampling configuration: ``method`` is ``greedy``, ``categorical`` or
    ``top_k``; ``temperature`` is read at every call."""

    method: str = "greedy"
    temperature: float = 1.0
    k: int = 0

    def __post_init__(self):
        if self.method not in ("greedy", "categorical", "top_k"):
            raise ValueError(f"unknown sampling method {self.method!r}")
        if self.method == "top_k" and self.k <= 0:
            raise ValueError("top_k sampling requires k >= 1")

    @property
    def stochastic(self):
        return self.method != "greedy"

    def static_key(self):
        return (self.method, int(self.k))

    def build(self):
        """``fn(logits, generator, temperature) -> int32 tokens``."""
        if self.method == "greedy":
            return lambda logits, generator, temperature: greedy(logits)
        if self.method == "categorical":
            return categorical
        k = int(self.k)
        return lambda logits, generator, temperature: top_k(
            logits, generator, k, temperature)


GREEDY = SamplingSpec()
