"""SameDiff graph rewrites: attention and epilogue fusion.

Port of ``fuse_attention`` and ``fuse_epilogues`` in
``deeplearning4j_tpu/autodiff/fusion.py``.
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

:func:`fuse_epilogues` splices each safe LayerNorm chain (keras' folded
form or the plain one, last-axis keepdims reductions) into one
``epilogue.layer_norm_act`` op (K6 forward, K7 backward on the card) and
each safe exact-GELU chain (``math.erf`` of ``x / sqrt(2)``, any of three
multiply groupings), with a rank-1 bias add under it, into one
``epilogue.bias_act(act="gelu_exact")`` op (K1, K2). Its rules are the
JAX package's as they are, with the order in which sites are claimed; in
particular it does not see through an ``act.identity`` (TF's
StopGradient) under the variance, does not take ``math.erfc`` as the GELU
anchor and does not infer shapes to confirm a non-negative axis: the JAX
package fuses none of those, and neither does the port
(``models/bert.py``'s ``"tf"`` spelling matches no site in either).
"""

from __future__ import annotations

import dataclasses
from collections import Counter
from typing import List, Optional

import numpy as np

from .samediff import ARRAY, CONSTANT, VARIABLE, SameDiff, _OpRecord


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


# ---------------------------------------------------------------------------
# normalization / activation epilogue fusion
# ---------------------------------------------------------------------------
#
# TF/keras-imported transformer blocks spell LayerNormalization and exact
# GELU as raw op chains:
#
#   mean = reduce.mean(x, axis=-1, keepdims)
#   var  = reduce.mean(squared_difference(x, mean), axis=-1, keepdims)
#   inv  = math.rsqrt(var + eps)
#   # keras folded form:            # plain form:
#   inv2 = inv * gamma              # y = ((x - mean) * inv) * gamma + beta
#   y    = x*inv2 + (beta - mean*inv2)
#
#   u = x * 0.7071067811  (or x / 1.4142135623)
#   g = 0.5 * x * (1 + math.erf(u))      # operand groupings vary by export
#
# Each chain re-reads the activation multiple times; on the BERT bench the
# row-stat reductions and the erf tail show up as distinct HBM sweeps.
# ``fuse_epilogues`` pattern-matches both shapes and splices in ONE catalog
# op each — ``epilogue.layer_norm_act`` / ``epilogue.bias_act`` (``ops/
# fused_epilogues.py``): K6/K7 and K1/K2 on the card, their plain versions
# on the CPU. A rank-1 bias add directly under a
# gelu chain is absorbed into the ``epilogue.bias_act`` record. Same safety
# and splice discipline as ``fuse_attention``: every removed intermediate
# must be consumed only inside the matched chain, must not be the loss, and
# must be a plain single-output ARRAY; the chain's OUTPUT name survives so
# downstream consumers and serde are untouched.

_SQRT_2 = 1.4142135623730951
_INV_SQRT_2 = 0.7071067811865476


def _approx(val, target, rtol=1e-4):
    return val is not None and abs(val - target) <= rtol * abs(target)


def _single_axis(attrs):
    ax = attrs.get("axis")
    if isinstance(ax, (tuple, list)):
        if len(ax) != 1:
            return None
        ax = ax[0]
    return int(ax) if ax is not None else None


def _last_axis_ok(sd, x_name, ax):
    """Is ``ax`` the LAST axis of ``x``? -1 always is; a non-negative
    axis (TF imports record concrete indices) verifies against the
    variable's recorded rank when known, else the site is rejected —
    fusing a non-last-axis normalization would be wrong."""
    if ax == -1:
        return True
    if ax is None or ax < 0:
        return False
    shape = sd._vars.get(x_name).shape if x_name in sd._vars else None
    return shape is not None and ax == len(shape) - 1


def _vector_var(sd, name):
    """gamma/beta/bias operand: a rank-1 VARIABLE/CONSTANT with a known
    shape (the fused kernel reshapes it to [1, C])."""
    var = sd._vars.get(name)
    return (var is not None and var.kind in (VARIABLE, CONSTANT)
            and var.shape is not None and len(var.shape) == 1)


def _chain_safe(sd, consumers, remove, keep_out):
    """The fuse_attention safety net generalized to chains with internal
    fan-out (the keras folded LN reads inv*gamma twice): every removed
    record's outputs may only be consumed by OTHER REMOVED records, must
    not be the loss, and must be plain single-output ARRAYs. ``keep_out``
    (the final record's output) is exempt — it survives the splice."""
    remove = list({id(r): r for r in remove}.values())  # plain-form LN lists
    internal = Counter()                                # sub(x, mean) twice
    for rec in remove:
        internal.update(rec.referenced())
    for rec in remove:
        if len(rec.outputs) != 1:
            return f"intermediate {rec.output!r} is not single-output"
        out = rec.output
        if out == keep_out:
            continue
        if out == sd.loss_name:
            return f"intermediate {out!r} is the loss"
        if sd._vars[out].kind != ARRAY:
            return f"intermediate {out!r} is not a plain ARRAY output"
        if consumers[out] != internal[out]:
            return (f"intermediate {out!r} has "
                    f"{consumers[out] - internal[out]} outside consumers")
    return None


def _binop(producers, name, op):
    rec = producers.get(name)
    return rec if rec is not None and rec.op == op else None


def _split_scalar(sd, rec):
    """(other_operand, scalar_value) for a binary record with one scalar-
    const operand, else (None, None)."""
    a, b = rec.inputs
    c = _scalar_const(sd, b)
    if c is not None:
        return a, c
    c = _scalar_const(sd, a)
    if c is not None:
        return b, c
    return None, None


def _match_ln_site(sd, producers, consumers, rsqrt_idx):
    """Anchor a layer-norm chain at the math.rsqrt record. Returns
    (site, None), (None, reason), or (None, None) = not a candidate."""
    ops = sd._ops
    inv_rec = ops[rsqrt_idx]

    # upstream: rsqrt(var + eps), var/mean last-axis keepdims reductions
    add_rec = _binop(producers, inv_rec.inputs[0], "math.add")
    if add_rec is None:
        return None, None
    var_name, eps = _split_scalar(sd, add_rec)
    if var_name is None:
        return None, None
    var_rec = _binop(producers, var_name, "reduce.mean")
    if var_rec is None:
        return None, None
    if not var_rec.attrs.get("keepdims"):
        return None, "variance reduction lacks keepdims"
    ax = _single_axis(var_rec.attrs)

    sq_rec = producers.get(var_rec.inputs[0])
    if sq_rec is None:
        return None, None
    chain = [inv_rec, add_rec, var_rec, sq_rec]
    if sq_rec.op == "math.squared_difference":
        cand = list(sq_rec.inputs)
    elif sq_rec.op == "math.square":
        sub_rec = _binop(producers, sq_rec.inputs[0], "math.sub")
        if sub_rec is None:
            return None, None
        chain.append(sub_rec)
        cand = list(sub_rec.inputs)
    elif sq_rec.op == "math.mul" and sq_rec.inputs[0] == sq_rec.inputs[1]:
        sub_rec = _binop(producers, sq_rec.inputs[0], "math.sub")
        if sub_rec is None:
            return None, None
        chain.append(sub_rec)
        cand = list(sub_rec.inputs)
    else:
        return None, None
    mean_rec = None
    for i, nm in enumerate(cand):
        r = _binop(producers, nm, "reduce.mean")
        if r is not None and r.attrs.get("keepdims") \
                and _single_axis(r.attrs) == ax:
            mean_rec, x_name = r, cand[1 - i]
            break
    if mean_rec is None or mean_rec.inputs[0] != x_name:
        return None, None
    chain.append(mean_rec)
    if not _last_axis_ok(sd, x_name, ax):
        return None, f"cannot verify axis {ax} is the last axis of x"
    mean_name = mean_rec.output

    # downstream of inv: keras folded or plain affine
    inv_name = inv_rec.output
    inv_users = [r for r in ops if inv_name in r.referenced()]

    def _mul_with(rec, name):
        """other operand if rec is a mul touching ``name``, else None."""
        if rec is None or rec.op != "math.mul" or name not in rec.inputs:
            return None
        a, b = rec.inputs
        return b if a == name else a

    site = None
    if len(inv_users) == 1 and inv_users[0].op == "math.mul":
        g_name = _mul_with(inv_users[0], inv_name)
        inv2 = inv_users[0]
        if g_name is not None and _vector_var(sd, g_name):
            # keras folded: x*(inv*g) + (beta - mean*(inv*g))
            inv2_users = [r for r in ops if inv2.output in r.referenced()]
            t_x = t_mu = None
            for r in inv2_users:
                other = _mul_with(r, inv2.output)
                if other == x_name:
                    t_x = r
                elif other == mean_name:
                    t_mu = r
            if t_x is not None and t_mu is not None and len(inv2_users) == 2:
                sub_rec = None
                for r in ops:
                    if r.op == "math.sub" and r.inputs[1] == t_mu.output:
                        sub_rec = r
                        break
                if sub_rec is not None and _vector_var(sd, sub_rec.inputs[0]):
                    b_name = sub_rec.inputs[0]
                    out_rec = None
                    for r in ops:
                        if r.op == "math.add" and set(r.inputs) == {
                                t_x.output, sub_rec.output}:
                            out_rec = r
                            break
                    if out_rec is not None:
                        site = {"remove": chain + [inv2, t_x, t_mu, sub_rec,
                                                   out_rec],
                                "final": out_rec, "x": x_name,
                                "gamma": g_name, "beta": b_name,
                                "eps": float(eps), "out": out_rec.output}
        if site is None and g_name is not None and not _vector_var(sd, g_name):
            # plain: ((x - mean) * inv) * gamma + beta
            d_rec = _binop(producers, g_name, "math.sub")
            if d_rec is not None and d_rec.inputs[0] == x_name \
                    and d_rec.inputs[1] == mean_name:
                n_rec = inv_users[0]
                g_rec = None
                for r in ops:
                    other = _mul_with(r, n_rec.output)
                    if other is not None and _vector_var(sd, other):
                        g_rec, gamma = r, other
                        break
                if g_rec is not None:
                    out_rec = None
                    for r in ops:
                        if r.op == "math.add" and g_rec.output in r.inputs:
                            other = (r.inputs[1] if r.inputs[0] == g_rec.output
                                     else r.inputs[0])
                            if _vector_var(sd, other):
                                out_rec, beta = r, other
                                break
                    if out_rec is not None:
                        site = {"remove": chain + [d_rec, n_rec, g_rec,
                                                   out_rec],
                                "final": out_rec, "x": x_name,
                                "gamma": gamma, "beta": beta,
                                "eps": float(eps), "out": out_rec.output}
    if site is None:
        return None, "normalization tail shape not recognized"
    reason = _chain_safe(sd, consumers, site["remove"], site["out"])
    if reason is not None:
        return None, reason
    return site, None


def _match_gelu_site(sd, producers, consumers, erf_idx):
    """Anchor an exact-GELU chain at the math.erf record."""
    ops = sd._ops
    erf_rec = ops[erf_idx]

    # upstream: u = x * (1/sqrt 2)  or  x / sqrt 2
    u_rec = producers.get(erf_rec.inputs[0])
    if u_rec is None or u_rec.op not in ("math.mul", "math.div"):
        return None, None
    x_name, c = _split_scalar(sd, u_rec)
    if x_name is None:
        return None, None
    if u_rec.op == "math.mul" and not _approx(c, _INV_SQRT_2):
        return None, f"erf prescale {c} is not 1/sqrt(2)"
    if u_rec.op == "math.div":
        if u_rec.inputs[0] != x_name or not _approx(c, _SQRT_2):
            return None, f"erf prescale divisor {c} is not sqrt(2)"

    # downstream: (1 + erf), then 0.5 and x multiplied in, any grouping
    f_rec = None
    for r in ops:
        if r.op == "math.add" and erf_rec.output in r.inputs:
            other = (r.inputs[1] if r.inputs[0] == erf_rec.output
                     else r.inputs[0])
            if _approx(_scalar_const(sd, other), 1.0, rtol=1e-9):
                f_rec = r
                break
    if f_rec is None:
        return None, "no (1 + erf) add"
    chain = [u_rec, erf_rec, f_rec]

    def _users(name):
        return [r for r in ops if name in r.referenced()]

    # multiply f by x and 0.5 in either grouping (three export shapes)
    fu = _users(f_rec.output)
    site = None
    if len(fu) == 1 and fu[0].op == "math.mul":
        m1 = fu[0]
        other = m1.inputs[1] if m1.inputs[0] == f_rec.output else m1.inputs[0]
        if other == x_name:                      # (x*f) * 0.5
            m2 = next((r for r in _users(m1.output)
                       if r.op == "math.mul"), None)
            if m2 is not None:
                o2 = (m2.inputs[1] if m2.inputs[0] == m1.output
                      else m2.inputs[0])
                if _approx(_scalar_const(sd, o2), 0.5, rtol=1e-9):
                    site = {"remove": chain + [m1, m2], "final": m2,
                            "x": x_name, "out": m2.output}
        elif _approx(_scalar_const(sd, other), 0.5, rtol=1e-9):  # (0.5*f)*x
            m2 = next((r for r in _users(m1.output)
                       if r.op == "math.mul" and x_name in r.inputs), None)
            if m2 is not None:
                site = {"remove": chain + [m1, m2], "final": m2,
                        "x": x_name, "out": m2.output}
        else:                                    # f * (0.5*x)
            hx = producers.get(other)
            if hx is not None and hx.op == "math.mul":
                hx_x, hc = _split_scalar(sd, hx)
                if hx_x == x_name and _approx(hc, 0.5, rtol=1e-9):
                    site = {"remove": chain + [hx, m1], "final": m1,
                            "x": x_name, "out": m1.output}
    if site is None:
        return None, "gelu multiply tail shape not recognized"

    # absorb a rank-1 bias add feeding x (matmul -> bias -> gelu tail)
    site["bias"] = None
    b_rec = producers.get(x_name)
    if b_rec is not None and b_rec.op == "math.add":
        pre, bias = b_rec.inputs
        if not _vector_var(sd, bias) and _vector_var(sd, pre):
            pre, bias = bias, pre
        if _vector_var(sd, bias):
            trial = site["remove"] + [b_rec]
            if _chain_safe(sd, consumers, trial, site["out"]) is None:
                site = {**site, "remove": trial, "x": pre, "bias": bias}
    reason = _chain_safe(sd, consumers, site["remove"], site["out"])
    if reason is not None:
        return None, reason
    return site, None


def fuse_epilogues(sd: SameDiff, verbose: bool = False) -> FusionReport:
    """Rewrite every safe decomposed LayerNorm chain to one
    ``epilogue.layer_norm_act`` op and every safe exact-GELU chain to one
    ``epilogue.bias_act(act='gelu_exact')`` op, in place.
    Returns a :class:`FusionReport`; ``kinds[i]`` says what ``sites[i]``
    fused to (``layer_norm`` / ``gelu``)."""
    report = FusionReport()
    consumers: Counter = Counter()
    for rec in sd._ops:
        consumers.update(rec.referenced())
    producers = {out: rec for rec in sd._ops for out in rec.outputs}

    sites = []
    for idx, rec in enumerate(sd._ops):
        if rec.op == "math.rsqrt":
            site, reason = _match_ln_site(sd, producers, consumers, idx)
            kind = "layer_norm"
        elif rec.op == "math.erf":
            site, reason = _match_gelu_site(sd, producers, consumers, idx)
            kind = "gelu"
        else:
            continue
        if site is not None:
            site["kind"] = kind
            sites.append(site)
        elif reason is not None:
            report.unmatched += 1
            report.reasons.append(f"{rec.output}: {reason}")

    claimed = set()
    for site in sites:
        site["remove"] = list({id(r): r for r in site["remove"]}.values())
        ids = set(id(r) for r in site["remove"])
        if ids & claimed:  # overlapping matches: first anchor wins
            continue
        claimed |= ids
        if site["kind"] == "layer_norm":
            fused = _OpRecord(
                "epilogue.layer_norm_act",
                [site["x"], site["gamma"], site["beta"]], site["out"],
                {"eps": site["eps"], "act": "identity"})
        else:
            inputs = [site["x"]]
            if site["bias"] is not None:
                inputs.append(site["bias"])
            fused = _OpRecord("epilogue.bias_act", inputs, site["out"],
                              {"act": "gelu_exact"})
        removed = set(id(r) for r in site["remove"])
        sd._ops = [fused if r is site["final"] else r
                   for r in sd._ops if id(r) not in removed or r is site["final"]]
        for rec in site["remove"]:
            if rec is not site["final"]:
                del sd._vars[rec.output]
        report.matched += 1
        report.sites.append(site["out"])
        report.kinds.append(site["kind"])

    if verbose:
        print(report)
        for r in report.reasons:
            print(" unmatched:", r)
    return report
