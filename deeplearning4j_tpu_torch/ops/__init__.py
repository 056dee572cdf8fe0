"""Tensor ops of the port and its op catalog.

Port of the catalog in ``deeplearning4j_tpu/ops/__init__.py``: every graph
op a SameDiff records is a function registered here under the JAX
package's name (``math.add``, ``linalg.mmul``, ``attention.fused_sdpa``,
...), with the keyword names of the JAX function it mirrors, so a
``graph.json`` written by either package runs in the other. This registry
is the port's own: nothing here reads or writes the JAX package's.

Besides the catalog the package holds the nn ops, the losses (two of
which are catalog ops too) and the fused epilogues the ComputationGraph
path calls directly (``epilogue.layer_norm_act`` and ``epilogue.bias_act``
are catalog ops too: ``fuse_epilogues`` records them).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional


@dataclasses.dataclass
class OpDef:
    name: str
    fn: Callable
    category: str = "misc"
    differentiable: bool = True


_REGISTRY: Dict[str, OpDef] = {}
_FWD_TESTED: set = set()
_GRAD_TESTED: set = set()


def register(name: str, category: str = "misc", differentiable: bool = True):
    """Decorator: register an op in the catalog."""

    def deco(fn):
        _REGISTRY[name] = OpDef(name=name, fn=fn, category=category,
                                differentiable=differentiable)
        return fn

    return deco


def get(name: str) -> OpDef:
    return _REGISTRY[name]


def lookup(name: str) -> Optional[Callable]:
    od = _REGISTRY.get(name)
    return od.fn if od else None


def all_ops() -> Dict[str, OpDef]:
    return dict(_REGISTRY)


def mark_fwd_tested(name: str) -> None:
    _FWD_TESTED.add(name)


def mark_grad_tested(name: str) -> None:
    _GRAD_TESTED.add(name)


def fwd_tested() -> set:
    return set(_FWD_TESTED & set(_REGISTRY))


def grad_tested() -> set:
    return set(_GRAD_TESTED & set(_REGISTRY))


# Import the catalog modules so registration runs at package import.
from . import activations  # noqa: E402,F401
from . import math  # noqa: E402,F401
from . import reduce  # noqa: E402,F401
from . import flash_attention  # noqa: E402,F401  (attention.fused_sdpa)
from . import losses  # noqa: E402,F401  (loss.softmax_ce_logits, ...)
from . import nnops  # noqa: E402,F401  (conv2d, layer_norm, lstm_cell, ...)
from . import random  # noqa: E402,F401  (image.resize_*)
from . import fused_epilogues  # noqa: E402,F401  (epilogue.*)
from . import sampling  # noqa: E402,F401  (sampling.*)
from . import quantize  # noqa: E402,F401  (quantize.int8_mmul)
