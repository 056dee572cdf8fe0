"""Workspace-mode rematerialization for SameDiff graphs.

Port of ``deeplearning4j_tpu/autodiff/remat.py``. The nn engines apply
the ``workspace_mode`` checkpoint policy block by block
(``nn/memory.py``); a SameDiff graph has only its recorded op list. This
module segments that list into transformer-block chunks anchored at
attention sites: ``attention.fused_sdpa`` records (after
``fusion.fuse_attention``) or raw softmax-anchored chains recognized by
``fusion._match_site``, the matcher the fusion pass trusts. Each segment
runs under ``nn/memory.py::checkpoint`` (``torch.utils.checkpoint``), so
the backward keeps one set of boundary activations per block and
recomputes the interior. A graph with no anchor falls back to
sqrt-sized uniform chunks.

Liveness is exact and the JAX module's: a segment receives exactly the
names it reads that were produced or stored before it (weights included:
a checkpoint's inputs are kept, not recomputed) and returns exactly the
names later segments or the targets read. :func:`segment_bounds` and
:func:`plan_segments` give the JAX module's segments for the same graph.

Divergences: :func:`compute_with_remat` runs only the records the
targets need (the port runs what the targets need, where ``jax.jit``
drops the rest), and a recomputed segment launches its kernels again in
the backward, so the launch counts and dispatch counters see the
recompute (``nn/memory.py``).
"""

from __future__ import annotations

import math
from collections import Counter
from typing import List, Optional, Sequence, Tuple

from ..nn import memory as _memory

#: op names that anchor a transformer block (one anchor, one block)
ANCHOR_OPS = ("attention.fused_sdpa",)


def attention_anchors(sd) -> List[int]:
    """Indices of the records that anchor a transformer block: fused
    attention records, and for each raw attention chain ``_match_site``
    recognizes, the chain's earliest record (the scores mmul: cutting
    there keeps the quadratic scores inside one segment). A stray
    softmax does not cut a block."""
    from .fusion import _match_site

    anchors = [i for i, r in enumerate(sd._ops) if r.op in ANCHOR_OPS]
    soft = [i for i, r in enumerate(sd._ops) if r.op == "act.softmax"]
    if soft:
        consumers: Counter = Counter()
        for rec in sd._ops:
            consumers.update(rec.referenced())
        producers = {o: r for r in sd._ops for o in r.outputs}
        idx_of = {id(r): i for i, r in enumerate(sd._ops)}
        for idx in soft:
            site, _reason = _match_site(sd, producers, consumers, idx)
            if site is not None:
                anchors.append(min(idx_of[id(r)] for r in site["remove"]))
    return sorted(anchors)


def segment_bounds(sd, policy) -> List[Tuple[int, int]]:
    """``[(start, end), ...]`` record ranges covering the op list: with
    anchors, one segment per ``policy.every`` consecutive anchors, cut at
    the anchor (the head joins the first segment, the tail the last);
    without, uniform chunks of ``isqrt(n)`` records."""
    n = len(sd._ops)
    if n == 0:
        return []
    anchors = attention_anchors(sd)
    if anchors:
        bounds, prev = [], 0
        for c in anchors[policy.every::policy.every]:
            bounds.append((prev, c))
            prev = c
        bounds.append((prev, n))
        return bounds
    return _memory.segment_ranges(n, max(1, math.isqrt(n)))


def plan_segments(sd, targets: Sequence[str], policy):
    """``[(records, in_names, out_names), ...]`` for a rematerialized run
    toward ``targets``: ``in_names`` what a segment reads from before it
    (stored values, feeds, earlier segments' outputs), ``out_names`` what
    later segments or the targets read of what it produces."""
    ops = sd._ops
    bounds = segment_bounds(sd, policy)
    available = {n for n, v in sd._vars.items() if v.kind != "ARRAY"}
    needed_after = [set(targets)]  # needed_after[j]: reads of ops[e_j:]
    for s, e in reversed(bounds):
        nxt = set(needed_after[0])
        for rec in ops[s:e]:
            nxt.update(rec.referenced())
        needed_after.insert(0, nxt)
    plan = []
    for j, (s, e) in enumerate(bounds):
        seg_ops = ops[s:e]
        produced = {o for rec in seg_ops for o in rec.outputs}
        reads = set()
        for rec in seg_ops:
            reads.update(rec.referenced())
        plan.append((tuple(seg_ops), tuple(sorted((reads - produced)
                                                  & available)),
                     tuple(sorted(produced & needed_after[j + 1]))))
        available |= produced
    return plan


def compute_with_remat(sd, env, targets: Sequence[str], policy,
                       needed: Optional[set] = None):
    """Run the planned segments into ``env`` (the stored values and the
    feeds, by name), each under ``nn/memory.py::checkpoint`` with the
    policy: the training path's counterpart of ``SameDiff._exec_ops``.
    ``needed``: the ``id``s of the records the targets need (the others
    are not run). Returns ``env`` holding the targets and every segment
    boundary."""
    for seg_ops, in_names, out_names in plan_segments(sd, targets, policy):
        if needed is not None:
            seg_ops = tuple(r for r in seg_ops if id(r) in needed)
            if not seg_ops:
                continue
            made = {o for r in seg_ops for o in r.outputs}
            out_names = tuple(n for n in out_names if n in made)
            in_names = tuple(n for n in in_names if n in env)

        def seg_fn(env_in, _ops=seg_ops, _outs=out_names):
            e = dict(env_in)
            sd._exec_ops(list(_ops), e)
            return {n: e[n] for n in _outs}

        env.update(_memory.checkpoint(seg_fn, policy)(
            {n: env[n] for n in in_names}))
    return env
