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

:func:`greedy`, :func:`categorical` and :func:`top_k` are the catalog ops
``sampling.greedy``, ``sampling.categorical`` and ``sampling.top_k``
(non-differentiable), as in the JAX package.

Divergence: a ``torch.Generator`` on the logits' device takes the place
of the JAX package's threaded PRNG key (the two streams differ, so the
draws agree only in distribution). Where a key arrives instead (a graph
recorded by the JAX package feeds one as an array), a fresh generator is
seeded from its words, so one key gives one draw, as in JAX.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import register

__all__ = ["greedy", "categorical", "top_k", "eos_hit", "SamplingSpec",
           "GREEDY"]

_TEMP_FLOOR = 1e-6


def _generator(key, device):
    """``key`` as a ``torch.Generator``: a generator (or None, the global
    stream) as it is; a key array or integer seeds a fresh generator on
    ``device`` from its words."""
    if key is None or isinstance(key, torch.Generator):
        return key
    words = np.asarray(key.cpu() if torch.is_tensor(key) else key)
    seed = 0
    for w in words.astype(np.uint64).ravel():
        seed = (seed * (1 << 32) + int(w)) % (1 << 63)
    return torch.Generator(device=device).manual_seed(seed)


@register("sampling.greedy", "sampling", differentiable=False)
def greedy(logits):
    """Greedy token selection: argmax over the last axis -> int32."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


@register("sampling.categorical", "sampling", differentiable=False)
def categorical(logits, generator, temperature=1.0):
    """Temperature softmax sampling by the Gumbel-max trick:
    ``argmax(logits / T + G)`` with ``G = -log(E)``, ``E ~ Exp(1)`` drawn
    from ``generator`` (a ``torch.Generator``, or a key to seed one), is a
    draw from ``softmax(logits / T)``."""
    generator = _generator(generator, logits.device)
    t = max(float(temperature), _TEMP_FLOOR)
    e = torch.empty(logits.shape, dtype=torch.float32,
                    device=logits.device).exponential_(generator=generator)
    g = -torch.log(e)
    return torch.argmax(logits.float() / t + g, dim=-1).to(torch.int32)


@register("sampling.top_k", "sampling", differentiable=False)
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
