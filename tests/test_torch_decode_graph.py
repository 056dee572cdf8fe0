"""The port's SameDiff decode graphs and its sampling catalog ops against
the JAX package's, on the CPU.

1. ``attention.cached_sdpa`` and ``attention.paged_sdpa`` (``Tq = 1`` and
   a window of ``Tq = 4``) against the JAX ops on the same numpy inputs:
   the output within atol 1e-5 (float32; the port runs K9's and K10's
   plain versions here, the JAX package its reference path), the updated
   caches bit for bit, the feeds untouched.
2. ``rewrite_for_decode`` on the mini transformer of
   ``tests/test_generative_decode.py::_mini_sd_transformer`` (two blocks
   here, so the second site reads the first's output), built from the same
   weights in both packages: the prefill and every decode step within
   1e-5 of the JAX ``DecodeGraph``'s and of the port's base graph
   recomputed over the full prefix (``tests/test_generative_decode.py:
   584-627``); the paged replay equals the cached one bit for bit, a
   window of 4 rows through ``paged_sdpa`` equals 4 single steps
   (``tests/test_paged_kv.py::test_samediff_paged_rewrite_parity``, :546).
3. The refusals: an unfused graph, a full cache.
4. ``sampling.greedy`` equals ``np.argmax`` and the JAX op exactly;
   ``sampling.categorical`` and ``sampling.top_k`` pass a chi-square test
   (p > 1e-3) of 20 000 seeded draws against ``softmax(logits / T)`` (top
   k: renormalized over the k largest); a key array seeds the draw as in
   JAX (one key, one draw)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from deeplearning4j_tpu import ops as jops
from deeplearning4j_tpu.autodiff import fuse_attention as jfuse
from deeplearning4j_tpu.autodiff.decode import \
    rewrite_for_decode as jrewrite
from deeplearning4j_tpu.autodiff.samediff import SameDiff as JSameDiff
from deeplearning4j_tpu_torch import ops
from deeplearning4j_tpu_torch.autodiff.decode import (PAGE_TABLE,
                                                      rewrite_for_decode)
from deeplearning4j_tpu_torch.autodiff.fusion import fuse_attention
from deeplearning4j_tpu_torch.autodiff.samediff import SameDiff
from deeplearning4j_tpu_torch.ops import sampling as smp

NEG = np.float32(np.finfo(np.float32).min)
TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    """The suite runs in parallel workers: keep this module's torch CPU
    work to two threads, and restore the setting after it."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        yield
    finally:
        torch.set_num_threads(old)


def _t(a):
    return torch.from_numpy(np.array(a))


# ------------------------------------------------------------------- ops

def _decode_inputs(rng, B=3, H=2, C=16, d=8, tq=1):
    f = np.float32
    return (rng.standard_normal((B, H, tq, d)).astype(f),
            rng.standard_normal((B, H, tq, d)).astype(f),
            rng.standard_normal((B, H, tq, d)).astype(f),
            rng.standard_normal((B, H, C, d)).astype(f),
            rng.standard_normal((B, H, C, d)).astype(f),
            np.array([0, 7, C - 1], np.int32))


def test_cached_sdpa_matches_jax():
    args = _decode_inputs(np.random.default_rng(1))
    kept = [a.copy() for a in args]
    targs = [_t(a) for a in args]
    y, kc, vc = ops.lookup("attention.cached_sdpa")(*targs, scale=0.4)
    jy, jkc, jvc = jops.lookup("attention.cached_sdpa")(
        *[jnp.asarray(a) for a in args], scale=0.4)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=TOL, rtol=0)
    np.testing.assert_array_equal(kc.numpy(), np.asarray(jkc))
    np.testing.assert_array_equal(vc.numpy(), np.asarray(jvc))
    for t, a in zip(targs, kept):  # the feeds stay as they were
        np.testing.assert_array_equal(t.numpy(), a)
    assert not ops.get("attention.cached_sdpa").differentiable


@pytest.mark.parametrize("tq", [1, 4])
def test_paged_sdpa_matches_jax(tq):
    rng = np.random.default_rng(2 + tq)
    B, H, d, P, MP = 3, 2, 8, 4, 4
    q, kn, vn, _, _, _ = _decode_inputs(rng, B, H, 16, d, tq)
    NP = 1 + B * MP
    kp = rng.standard_normal((NP * P, H, d)).astype(np.float32)
    vp = rng.standard_normal((NP * P, H, d)).astype(np.float32)
    kp[:P] = vp[:P] = 0.0                      # the zero page
    pt = rng.permutation(np.arange(1, NP)).reshape(B, MP).astype(np.int32)
    ln = np.array([0, 5, MP * P - tq], np.int32)
    args = (q, kn, vn, kp, vp, pt, ln)
    y, kp2, vp2 = ops.lookup("attention.paged_sdpa")(
        *[_t(a) for a in args], scale=0.3, page_size=P)
    jy, jkp, jvp = jops.lookup("attention.paged_sdpa")(
        *[jnp.asarray(a) for a in args], scale=0.3, page_size=P)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=TOL, rtol=0)
    np.testing.assert_array_equal(kp2.numpy(), np.asarray(jkp))
    np.testing.assert_array_equal(vp2.numpy(), np.asarray(jvp))
    assert not kp2[:P].any()
    assert not ops.get("attention.paged_sdpa").differentiable


# --------------------------------------------------------------- rewrite

def _transformer(sd, weights, blocks=2, d=8):
    """``_mini_sd_transformer`` of ``tests/test_generative_decode.py``,
    stacked ``blocks`` times on [B, H, T, d] hidden states; the same
    recording calls record it in either package."""
    x = sd.placeholder("x")
    mask = sd.placeholder("mask")
    dk = sd.constant("dk", np.float32(np.sqrt(d)))
    for i in range(blocks):
        wq, wk, wv, wo = (sd.var(f"{n}{i}", weights[f"{n}{i}"])
                          for n in ("Wq", "Wk", "Wv", "Wo"))
        q = sd.call("linalg.mmul", x, wq, name=f"q{i}")
        k = sd.call("linalg.mmul", x, wk, name=f"k{i}")
        v = sd.call("linalg.mmul", x, wv, name=f"v{i}")
        scores = sd.call("linalg.mmul", q, k, name=f"scores{i}",
                         attrs={"transpose_b": True})
        scaled = sd.call("math.div", scores, dk, name=f"scaled{i}")
        masked = sd.call("math.add", scaled, mask, name=f"masked{i}")
        probs = sd.call("act.softmax", masked, name=f"probs{i}")
        ctx = sd.call("linalg.mmul", probs, v, name=f"ctx{i}")
        x = sd.call("linalg.mmul", ctx, wo,
                    name="out" if i == blocks - 1 else f"h{i}")
    return sd


def _weights(rng, blocks=2, d=8):
    return {f"{n}{i}": rng.normal(size=(d, d)).astype(np.float32) * 0.3
            for i in range(blocks) for n in ("Wq", "Wk", "Wv", "Wo")}


def _prefix_bias(plens, lengths, t):
    """The prefix-LM mask of the full-prefix recompute: the prompt
    bidirectional over itself, generated rows causal."""
    ii, jj = np.arange(t)[:, None], np.arange(t)[None, :]
    allowed = ((jj < plens[:, None, None]) | (jj <= ii)) \
        & (jj < lengths[:, None, None])
    return np.where(allowed[:, None], 0.0, NEG).astype(np.float32)


def test_rewrite_parity_with_jax_and_the_full_prefix():
    rng = np.random.default_rng(5)
    B, H, d, Tp, C = 2, 2, 8, 8, 16
    w = _weights(rng)
    sd = _transformer(SameDiff(device="cpu"), w)
    jsd = _transformer(JSameDiff(), w)
    assert fuse_attention(sd).matched == jfuse(jsd).matched == 2
    dg = rewrite_for_decode(sd, output="out")
    jdg = jrewrite(jsd, output="out")
    assert dg.site_names() == jdg.site_names() == ["ctx0", "ctx1"]
    assert [r.op for r in dg.decode._ops] == [r.op for r in jdg.decode._ops]
    assert [r.op for r in sd._ops].count("attention.fused_sdpa") == 2

    plens = np.array([5, 3])
    xp = rng.normal(size=(B, H, Tp, d)).astype(np.float32) * 0.5
    kb = np.where(np.arange(Tp)[None, None, None, :] <
                  plens[:, None, None, None], 0.0, NEG).astype(np.float32)
    y, caches = dg.prefill({"x": xp, "mask": kb}, plens, C)
    jy, jcaches = jdg.prefill({"x": xp, "mask": kb}, plens, C)
    np.testing.assert_allclose(y, np.asarray(jy), atol=TOL, rtol=0)
    assert tuple(caches["ctx0"]["k"].shape) == (B, H, C, d)
    for site in ("ctx0", "ctx1"):
        for n in ("k", "v"):
            np.testing.assert_allclose(caches[site][n].numpy(),
                                       np.asarray(jcaches[site][n]),
                                       atol=TOL, rtol=0)
    lengths = plens.copy()
    seq = np.zeros((B, H, C, d), np.float32)
    seq[:, :, :Tp] = xp
    m1 = np.zeros((B, 1, 1, 1), np.float32)
    for _ in range(3):
        x_t = rng.normal(size=(B, H, 1, d)).astype(np.float32) * 0.5
        y, caches = dg.decode_step({"x": x_t, "mask": m1}, caches, lengths)
        jy, jcaches = jdg.decode_step({"x": x_t, "mask": m1}, jcaches,
                                      lengths)
        np.testing.assert_allclose(y, np.asarray(jy), atol=TOL, rtol=0)
        for b in range(B):
            seq[b, :, lengths[b]] = x_t[b, :, 0]
        lengths = lengths + 1
        t = int(lengths.max())
        ref = dg.base.output({"x": seq[:, :, :t],
                              "mask": _prefix_bias(plens, lengths, t)},
                             ["out"])["out"]
        np.testing.assert_allclose(y[:, :, 0],
                                   ref[np.arange(B), :, lengths - 1],
                                   atol=TOL, rtol=0)


def test_paged_replay_equals_the_cached_one():
    rng = np.random.default_rng(6)
    B, H, d, Tp, C, P = 2, 2, 8, 4, 16, 4
    w = _weights(rng)
    sdc = _transformer(SameDiff(device="cpu"), w)
    sdp = _transformer(SameDiff(device="cpu"), w)
    fuse_attention(sdc)
    fuse_attention(sdp)
    dgc = rewrite_for_decode(sdc, output="out")
    dgp = rewrite_for_decode(sdp, output="out", paged=True, page_size=P)
    assert dgp.paged and dgp.site_names() == ["ctx0", "ctx1"]
    assert {r.op for r in dgp.decode._ops} >= {"attention.paged_sdpa"}
    jsd = _transformer(JSameDiff(), w)
    jfuse(jsd)
    jdgp = jrewrite(jsd, output="out", paged=True, page_size=P)

    plens = np.array([3, 4])
    xp = rng.normal(size=(B, H, Tp, d)).astype(np.float32) * 0.5
    kb = np.where(np.arange(Tp)[None, None, None, :] <
                  plens[:, None, None, None], 0.0, NEG).astype(np.float32)
    y1, c1 = dgc.prefill({"x": xp, "mask": kb}, plens, C)
    y2, c2 = dgp.prefill({"x": xp, "mask": kb}, plens, C)
    _, jc2 = jdgp.prefill({"x": xp, "mask": kb}, plens, C)
    np.testing.assert_array_equal(y1, y2)
    np.testing.assert_array_equal(c2[PAGE_TABLE], jc2[PAGE_TABLE])
    assert c2[PAGE_TABLE].shape == (B, C // P)
    lengths = plens.copy()
    m1 = np.zeros((B, 1, 1, 1), np.float32)
    start = (c2, lengths.copy())
    steps = []
    for _ in range(4):
        x_t = rng.normal(size=(B, H, 1, d)).astype(np.float32) * 0.5
        o1, c1 = dgc.decode_step({"x": x_t, "mask": m1}, c1, lengths)
        o2, c2 = dgp.decode_step({"x": x_t, "mask": m1}, c2, lengths)
        jo2, jc2 = jdgp.decode_step({"x": x_t, "mask": m1}, jc2, lengths)
        np.testing.assert_array_equal(o1, o2)
        np.testing.assert_allclose(o2, np.asarray(jo2), atol=TOL, rtol=0)
        steps.append(x_t)
        lengths = lengths + 1
    # a window of the same 4 rows through paged_sdpa (Tq = 4, K10's
    # route) from the prefilled pools: window-causal, so its rows are the
    # 4 single steps'
    xw = np.concatenate(steps, axis=2)
    ow, cw = dgp.decode_step({"x": xw, "mask": m1}, start[0], start[1])
    np.testing.assert_allclose(ow[:, :, -1], o2[:, :, 0], atol=TOL, rtol=0)
    for site in ("ctx0", "ctx1"):
        for n in ("k", "v"):
            np.testing.assert_allclose(cw[site][n].numpy(),
                                       c2[site][n].numpy(), atol=TOL,
                                       rtol=0)


def test_refusals():
    sd = SameDiff(device="cpu")
    sd.placeholder("x")
    with pytest.raises(ValueError, match="fused_sdpa"):
        rewrite_for_decode(sd, output="x")
    rng = np.random.default_rng(7)
    B, H, d, Tp, C = 1, 1, 8, 4, 4
    sd = _transformer(SameDiff(device="cpu"), _weights(rng, 1), blocks=1)
    fuse_attention(sd)
    with pytest.raises(ValueError, match="output="):
        rewrite_for_decode(sd)
    dg = rewrite_for_decode(sd, output="out")
    xp = rng.normal(size=(B, H, Tp, d)).astype(np.float32)
    kb = np.zeros((B, 1, 1, Tp), np.float32)
    _, caches = dg.prefill({"x": xp, "mask": kb}, np.array([4]), C)
    with pytest.raises(ValueError, match="cache full"):
        dg.decode_step({"x": xp[:, :, :1],
                        "mask": np.zeros((B, 1, 1, 1), np.float32)},
                       caches, np.array([4]))
    with pytest.raises(ValueError, match="exceeds cache_len"):
        dg.prefill({"x": xp, "mask": kb}, np.array([4]), 2)
    pdg = rewrite_for_decode(sd, output="out", paged=True, page_size=4)
    with pytest.raises(ValueError, match="multiple of page_size"):
        pdg.prefill({"x": xp, "mask": kb}, np.array([4]), 6)


# -------------------------------------------------------------- sampling

def test_greedy_is_exact():
    rng = np.random.default_rng(8)
    logits = rng.normal(size=(64, 33)).astype(np.float32)
    logits[0, [3, 9]] = 5.0                        # a tie: the first wins
    got = ops.lookup("sampling.greedy")(torch.from_numpy(logits))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.argmax(logits, -1))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jops.lookup("sampling.greedy")(logits)))
    for name in ("sampling.greedy", "sampling.categorical", "sampling.top_k"):
        assert ops.get(name).category == "sampling"
        assert not ops.get(name).differentiable


N_DRAWS = 20000


def _chi2_p(draws, probs):
    counts = np.bincount(draws, minlength=probs.size)
    probs = probs.astype(np.float64) / probs.sum()
    keep = probs > 0
    assert counts[~keep].sum() == 0                # nothing off the support
    return stats.chisquare(counts[keep], N_DRAWS * probs[keep]).pvalue


@pytest.mark.parametrize("temperature", [1.0, 0.5])
def test_categorical_by_distribution(temperature):
    logits = np.linspace(-1.0, 1.5, 8).astype(np.float32)
    gen = torch.Generator().manual_seed(11)
    draws = smp.categorical(torch.from_numpy(np.tile(logits, (N_DRAWS, 1))),
                            gen, temperature).numpy()
    z = np.exp(logits.astype(np.float64) / temperature)
    assert _chi2_p(draws, z / z.sum()) > 1e-3


def test_top_k_by_distribution():
    logits = np.array([0.3, 2.0, -1.0, 1.2, 0.9, -0.5], np.float32)
    gen = torch.Generator().manual_seed(12)
    draws = smp.top_k(torch.from_numpy(np.tile(logits, (N_DRAWS, 1))),
                      gen, 3, 2.0).numpy()
    z = np.where(logits >= np.sort(logits)[-3],
                 np.exp(logits.astype(np.float64) / 2.0), 0.0)
    assert _chi2_p(draws, z / z.sum()) > 1e-3
    with pytest.raises(ValueError, match="k >= 1"):
        smp.top_k(torch.from_numpy(logits), gen, 0)


def test_a_key_seeds_the_draw():
    """A graph recorded by the JAX package feeds a key array: one key, one
    draw; another key, another stream; a cold temperature is the
    argmax."""
    rng = np.random.default_rng(13)
    logits = torch.from_numpy(rng.normal(size=(256, 16)).astype(np.float32))
    key = np.array([0, 7], np.uint32)
    a = smp.categorical(logits, key, 1.0)
    b = smp.categorical(logits, torch.from_numpy(key), 1.0)
    c = smp.categorical(logits, np.array([0, 8], np.uint32), 1.0)
    assert torch.equal(a, b) and not torch.equal(a, c)
    cold = smp.categorical(logits, key, 1e-6)
    np.testing.assert_array_equal(cold.numpy(), logits.argmax(-1).numpy())
