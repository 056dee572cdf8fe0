"""SameDiff graph rewrite: attention-pattern fusion.

Port of ``fuse_attention`` in ``deeplearning4j_tpu/autodiff/fusion.py``.
TF-imported transformer graphs (HF TFBert among them) spell attention as
the raw chain

    linalg.mmul(q, k, transpose_b=True)      # BatchMatMul(adj_y=True)
      -> math.div / math.mul (scalar const)  # 1/sqrt(head) scale
      -> math.add (mask bias)                # extended attention mask
      -> act.softmax
      -> linalg.mmul(probs, v)               # BatchMatMul

:func:`fuse_attention` matches that chain on the recorded op list and
rewrites it to ONE ``attention.fused_sdpa`` op (``ops/flash_attention.py``:
K3 on the card, the f32-softmax reference path on the CPU). The scale and
the mask add may come in either order and are optional; scalar-constant
adds (HF's softmax epsilon) are absorbed, since softmax is
shift-invariant; ``act.identity`` links (frozen dropout) between the
softmax and the context mmul are absorbed; a scalar scale of q upstream of
the scores mmul is absorbed into the fused op's scale.

Safety rules (a site is skipped, and counted unmatched with its reason,
unless ALL hold): every intermediate has exactly ONE consumer in the whole
graph; no intermediate is the loss; the scale operand is a scalar
CONSTANT; the mmuls carry the exact transpose flags above. The rewrite
keeps the chain's output name (the context mmul's), so downstream
consumers and serde are untouched; intermediate names leave the variable
registry. The rules, the matching and the report are the JAX package's,
so both packages fuse the same sites of the same graph.
"""

from __future__ import annotations

import dataclasses
from collections import Counter
from typing import List, Optional

import numpy as np

from .samediff import ARRAY, CONSTANT, SameDiff, _OpRecord


@dataclasses.dataclass
class FusionReport:
    """matched = sites rewritten; unmatched = anchor ops that started a
    candidate chain but failed a safety check, with the reasons; sites =
    fused output names; kinds = what each site fused to (parallel to
    ``sites``; the JAX package's ``fuse_epilogues`` fills it, and
    ``fuse_attention`` leaves it empty in both packages)."""
    matched: int = 0
    unmatched: int = 0
    sites: List[str] = dataclasses.field(default_factory=list)
    reasons: List[str] = dataclasses.field(default_factory=list)
    kinds: List[str] = dataclasses.field(default_factory=list)

    def __str__(self):
        return (f"fusion: {self.matched} matched, "
                f"{self.unmatched} unmatched")


def _scalar_const(sd: SameDiff, name: str) -> Optional[float]:
    var = sd._vars.get(name)
    if var is None or var.kind != CONSTANT:
        return None
    val = np.asarray(sd.get_value(name))
    if val.size != 1:
        return None
    return float(val.reshape(()))


def _match_site(sd, producers, consumers, soft_idx):
    """Try to anchor a fusable chain at the act.softmax record at
    ``soft_idx``. Returns (site dict, None) or (None, skip-reason);
    reason None means 'not even a candidate'."""
    ops = sd._ops
    soft = ops[soft_idx]
    axis = soft.attrs.get("axis", -1)
    if axis not in (-1,):
        return None, "softmax axis not -1"

    # downstream: softmax output reaches exactly one plain batched mmul as
    # the LEFT operand (probs @ v), possibly through act.identity links —
    # frozen-graph dropout / StopGradient import as identities
    chain = [soft]
    cur_out = soft.output
    ctx_idx = None
    for _ in range(4):
        nxt_idx = None
        for idx in range(soft_idx + 1, len(ops)):
            if cur_out in ops[idx].referenced():
                nxt_idx = idx
                break
        if nxt_idx is None:
            return None, None
        rec = ops[nxt_idx]
        if rec.op == "act.identity" and consumers[cur_out] == 1:
            chain.append(rec)
            cur_out = rec.output
            continue
        if (rec.op == "linalg.mmul" and rec.inputs[0] == cur_out
                and not rec.attrs.get("transpose_a")
                and not rec.attrs.get("transpose_b")):
            ctx_idx = nxt_idx
        break
    if ctx_idx is None:
        return None, None

    # upstream: [mask add], [scalar scale], and any scalar-const adds
    # (softmax is shift-invariant — HF stable_softmax's +eps absorbs away),
    # in any order, then the transposed-key scores mmul
    cur = soft.inputs[0]
    bias_name = None
    scale = 1.0
    for _ in range(4):
        rec = producers.get(cur)
        if rec is None or rec.op not in ("math.add", "math.mul", "math.div"):
            break
        if rec.op == "math.add":
            a, b = rec.inputs
            if _scalar_const(sd, b) is not None:
                pass                      # epsilon add: softmax(x+c)==softmax(x)
            elif _scalar_const(sd, a) is not None:
                a = b                     # epsilon add, operands flipped
            elif bias_name is None:
                nxt = a if _chain_like(producers.get(a)) else b
                if nxt is b and not _chain_like(producers.get(b)):
                    return None, "mask-add has no upstream mmul/scale operand"
                bias_name = b if nxt is a else a
                a = nxt
            else:
                return None, "more than one non-scalar mask add"
            chain.append(rec)
            cur = a
        elif scale == 1.0:
            a, b = rec.inputs
            c = _scalar_const(sd, b)
            if c is None and rec.op == "math.mul":
                c = _scalar_const(sd, a)
                if c is not None:
                    a = b
            if c is None:
                return None, "scale operand is not a scalar constant"
            scale = c if rec.op == "math.mul" else 1.0 / c
            chain.append(rec)
            cur = a
        else:
            return None, "more than one scale op"
    scores = producers.get(cur)
    if scores is None or scores.op != "linalg.mmul":
        return None, None
    if scores.attrs.get("transpose_a") or not scores.attrs.get("transpose_b"):
        return None, "scores mmul transpose flags are not (False, True)"
    chain.append(scores)

    # pre-scaled query (r12 coverage gap): PyTorch->ONNX and some TF
    # exports scale q BEFORE the scores mmul (q/sqrt(d) @ k^T) instead of
    # scaling the scores. Absorb a single-consumer scalar div/mul feeding
    # the mmul's LEFT input into the fused op's scale — without this the
    # site still fused but left the q-sized elementwise op (a full
    # [B,H,T,d] HBM round-trip) in the graph.
    q_name = scores.inputs[0]
    if scale == 1.0:
        qrec = producers.get(q_name)
        if qrec is not None and qrec.op in ("math.mul", "math.div") \
                and len(qrec.outputs) == 1 and consumers[q_name] == 1:
            a, b = qrec.inputs
            c = _scalar_const(sd, b)
            if c is None and qrec.op == "math.mul":
                c = _scalar_const(sd, a)
                if c is not None:
                    a = b
            if c is not None:
                scale = c if qrec.op == "math.mul" else 1.0 / c
                q_name = a
                chain.append(qrec)

    # single-consumer + not-the-loss safety net over every intermediate
    for rec in chain:
        out = rec.output
        if consumers[out] != 1:
            return None, f"intermediate {out!r} has {consumers[out]} consumers"
        if out == sd.loss_name:
            return None, f"intermediate {out!r} is the loss"
        if len(rec.outputs) != 1 or sd._vars[out].kind != ARRAY:
            return None, f"intermediate {out!r} is not a plain ARRAY output"

    ctx = ops[ctx_idx]
    if len(ctx.outputs) != 1:
        return None, "context mmul is not single-output"
    return {
        "remove": chain,       # softmax, [add], [scale], scores mmul,
        "ctx": ctx,            # [pre-scale of q]
        "q": q_name, "k": scores.inputs[1], "v": ctx.inputs[1],
        "bias": bias_name, "scale": float(scale), "out": ctx.output,
    }, None


def _chain_like(rec) -> bool:
    return rec is not None and rec.op in ("linalg.mmul", "math.mul",
                                          "math.div", "math.add")


def fuse_attention(sd: SameDiff, verbose: bool = False) -> FusionReport:
    """Rewrite every safe ``mmul -> [scale] -> [mask add] -> softmax ->
    mmul`` chain in ``sd`` to one ``attention.fused_sdpa`` op, in place.
    Returns a :class:`FusionReport` with matched/unmatched site counts."""
    report = FusionReport()
    consumers: Counter = Counter()
    for rec in sd._ops:
        consumers.update(rec.referenced())
    producers = {out: rec for rec in sd._ops for out in rec.outputs}

    sites = []
    for idx, rec in enumerate(sd._ops):
        if rec.op != "act.softmax":
            continue
        site, reason = _match_site(sd, producers, consumers, idx)
        if site is not None:
            sites.append(site)
        elif reason is not None:
            report.unmatched += 1
            report.reasons.append(f"{rec.output}: {reason}")

    for site in sites:
        inputs = [site["q"], site["k"], site["v"]]
        if site["bias"] is not None:
            inputs.append(site["bias"])
        fused = _OpRecord("attention.fused_sdpa", inputs, site["out"],
                          {"scale": site["scale"]})
        # splice by record identity — indices go stale after the first site
        removed = set(id(r) for r in site["remove"])
        sd._ops = [fused if r is site["ctx"] else r
                   for r in sd._ops if id(r) not in removed]
        for rec in site["remove"]:
            del sd._vars[rec.output]
        report.matched += 1
        report.sites.append(site["out"])

    if verbose:
        print(report)
        for r in report.reasons:
            print(" unmatched:", r)
    return report
