"""SameDiff graph rewrite: post-training int8 weight quantization.

Port of ``deeplearning4j_tpu/autodiff/quantize.py``. Every ``linalg.mmul``
record whose RIGHT operand is a stored 2-D weight (VARIABLE or CONSTANT:
the dense projections of an imported transformer) becomes one
``quantize.int8_mmul`` record (``ops/quantize.py``): the weight becomes an
int8 CONSTANT (``<name>__q``) with an f32 per-output-channel scale
CONSTANT beside it (``<name>__scale``), and the activation quantizes per
example in each call. The record's OUTPUT name is kept, so every consumer
downstream, the fused attention and epilogue sites included, is untouched.

A candidate site is skipped, and counted with its reason, unless ALL of
these hold (the JAX pass's rules and slugs):

- the weight has a stored value (``no_value``), is 2-D (``rank``), has
  at least ``min_elements`` elements (``min_elements``) and is floating
  (``dtype``); a per-call placeholder is not a candidate at all;
- the mmul carries no transpose flags (``transpose``);
- the weight is read ONLY by mmul records this pass rewrites
  (``shared_weight``: a tied embedding keeps its f32 value).

The f32 values of rewritten weights leave the value store (the variable
stays, as a value-less ARRAY marker). Each decision counts in
``ops.quantize.rewrite_counters()`` (``matched``, ``skipped_<slug>``).

The rewrite is for deployment: ``quantize.int8_mmul`` is registered
non-differentiable, and a gradient asked through it raises (so ``fit`` or
``grad`` through a rewritten site raises). The JAX package's jax.grad
runs through such a site and differentiates the dynamic activation scale;
the port refuses instead.
"""

from __future__ import annotations

import dataclasses
from collections import Counter
from typing import List

import torch

from ..ops import quantize as _q
from .samediff import ARRAY, CONSTANT, SameDiff, VARIABLE, _OpRecord


@dataclasses.dataclass
class QuantizeGraphReport:
    """``matched`` mmul sites swapped for ``quantize.int8_mmul``;
    ``skipped`` candidate sites left f32, with ``reasons``; ``bytes_f32`` /
    ``bytes_q`` the value-store weight bytes before and after."""
    matched: int = 0
    skipped: int = 0
    sites: List[str] = dataclasses.field(default_factory=list)
    reasons: List[str] = dataclasses.field(default_factory=list)
    bytes_f32: int = 0
    bytes_q: int = 0

    @property
    def bytes_saved(self) -> int:
        return max(0, self.bytes_f32 - self.bytes_q)

    def __str__(self):
        return (f"weight quantization: {self.matched} mmul sites -> int8 "
                f"({self.bytes_f32} -> {self.bytes_q} weight bytes), "
                f"{self.skipped} skipped")


def _skip(report: QuantizeGraphReport, rec: _OpRecord, slug: str,
          reason: str):
    report.skipped += 1
    report.reasons.append(f"{rec.output}: {reason}")
    _q._bump(_q._REWRITE, "skipped_" + slug)


def quantize_weights(sd: SameDiff, min_elements: int = 1
                     ) -> QuantizeGraphReport:
    """Rewrite every safe stored-weight ``linalg.mmul`` in ``sd`` to one
    ``quantize.int8_mmul`` op, in place; returns a
    :class:`QuantizeGraphReport`. Run it after ``fuse_attention`` and
    ``fuse_epilogues`` (their sites read the mmuls' outputs, which keep
    their names)."""
    report = QuantizeGraphReport()
    consumers: Counter = Counter()
    for rec in sd._ops:
        consumers.update(rec.referenced())

    sites = []          # (record, weight_name)
    per_weight = {}     # weight_name -> [records]
    for rec in sd._ops:
        if rec.op != "linalg.mmul" or len(rec.inputs) != 2:
            continue
        w_name = rec.inputs[1]
        var = sd._vars.get(w_name)
        if var is None or var.kind not in (VARIABLE, CONSTANT):
            continue  # activation @ activation, or a per-call feed
        val = sd._values.get(w_name)
        if val is None:
            _skip(report, rec, "no_value", "weight has no stored value")
            continue
        if val.dim() != 2:
            _skip(report, rec, "rank", f"weight rank {val.dim()} != 2")
            continue
        if val.numel() < int(min_elements):
            _skip(report, rec, "min_elements",
                  f"weight below min_elements ({val.numel()})")
            continue
        if not val.is_floating_point():
            _skip(report, rec, "dtype",
                  f"weight dtype {str(val.dtype).replace('torch.', '')} "
                  "not floating")
            continue
        if rec.attrs.get("transpose_a") or rec.attrs.get("transpose_b"):
            _skip(report, rec, "transpose", "transpose flags set")
            continue
        sites.append((rec, w_name))
        per_weight.setdefault(w_name, []).append(rec)

    blocked = set()
    for w_name, recs in per_weight.items():
        if consumers[w_name] != len(recs):
            blocked.add(w_name)
            for rec in recs:
                _skip(report, rec, "shared_weight",
                      f"weight {w_name!r} has "
                      f"{consumers[w_name] - len(recs)} non-mmul consumers")
    sites = [(rec, w) for rec, w in sites if w not in blocked]
    if not sites:
        return report

    quantized = {}  # weight_name -> (q_name, scale_name)
    replace = {}    # id(old record) -> new record
    with torch.no_grad():
        for rec, w_name in sites:
            if w_name not in quantized:
                val = sd._values[w_name]
                report.bytes_f32 += _q._nbytes(val)
                qt = _q.quantize_per_channel(val, axis=1)
                q_name, s_name = f"{w_name}__q", f"{w_name}__scale"
                sd._register(q_name, CONSTANT, tuple(qt.q.shape))
                sd._register(s_name, CONSTANT, tuple(qt.scale.shape))
                sd._values[q_name] = qt.q
                sd._values[s_name] = qt.scale
                report.bytes_q += qt.nbytes
                quantized[w_name] = (q_name, s_name)
            q_name, s_name = quantized[w_name]
            replace[id(rec)] = _OpRecord(
                "quantize.int8_mmul", [rec.inputs[0], q_name, s_name],
                rec.output, {})
            report.matched += 1
            report.sites.append(rec.output)
            _q._bump(_q._REWRITE, "matched")
    sd._ops = [replace.get(id(r), r) for r in sd._ops]
    for w_name in quantized:
        sd._values.pop(w_name, None)
        sd._vars[w_name].kind = ARRAY
    return report
