"""The port's SameDiff 16-bit fit policy, workspace-mode remat and
``memory_report`` against the JAX package's on the CPU.

1. ``set_dtype("BFLOAT16")``: ``fit``'s losses within the JAX band of the
   float32 oracle (``tests/test_samediff_bf16.py:42``: rtol 0.05, atol
   0.02) and of the JAX package's own bf16 losses; masters and updater
   state stay float32; ``output`` keeps the recorded dtype; the fused
   master-cast updater's routing counted once a step build; the compute
   copies' gradients upcast exactly (the fused step's loss and gradients
   equal differentiating the masters through the cast, bit for bit).
2. Remat: ``attention_anchors``, ``segment_bounds`` and ``plan_segments``
   equal the JAX module's for the same graph, with and without fused
   attention and with no anchor (``tests/test_memory_remat.py:275-346``);
   every mode's losses equal "none"'s (the JAX test's atol 1e-6) and the
   JAX package's remat losses (1e-5: float32 sums in other orders); the
   mode survives serde both ways.
3. ``memory_report``: the JAX report's keys, the compiled fields None, and
   fewer activation bytes kept under "full" than under "none".
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.autodiff import fusion as jfusion
from deeplearning4j_tpu.autodiff import remat as jremat
from deeplearning4j_tpu.autodiff.samediff import SameDiff as JSameDiff
from deeplearning4j_tpu.nn import memory as jmem
from deeplearning4j_tpu.nn import updaters as jupd
from deeplearning4j_tpu_torch.autodiff import fusion, remat
from deeplearning4j_tpu_torch.autodiff.samediff import SameDiff
from deeplearning4j_tpu_torch.nn import memory as mem
from deeplearning4j_tpu_torch.nn import updaters as upd
from deeplearning4j_tpu_torch.ops import fused_epilogues as fe

BAND = dict(rtol=0.05, atol=0.02)
ATOL = 1e-6
JAX_TOL = 1e-5
MODES = ("full", "dots_saveable", "every_2")


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


def _port():
    return SameDiff(device="cpu")


# ------------------------------------------------------ the 16-bit policy

def _mlp(sd, up, seed=0, lr=0.2, l2=0.0):
    """The JAX bf16 test's MLP (``tests/test_samediff_bf16.py:_mlp``)."""
    rng = np.random.default_rng(seed)
    x = sd.placeholder("x")
    y = sd.placeholder("y")
    w1 = sd.var("w1", rng.normal(0, 0.4, (8, 16)).astype(np.float32))
    b1 = sd.var("b1", np.zeros(16, np.float32))
    w2 = sd.var("w2", rng.normal(0, 0.4, (16, 3)).astype(np.float32))
    b2 = sd.var("b2", np.zeros(3, np.float32))
    h = sd.call("act.tanh", x.mmul(w1) + b1)
    logits = h.mmul(w2) + b2
    sd.set_loss(sd.call("loss.softmax_ce_logits", y, logits))
    sd.set_training_config(updater=up.Sgd(learning_rate=lr), l2=l2)
    return sd


def _mlp_feeds(seed=1, n=6):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        x = rng.normal(size=(32, 8)).astype(np.float32)
        y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 32)]
        out.append({"x": x, "y": y})
    return out


@pytest.mark.parametrize("l2", [0.0, 1e-3])
def test_bf16_policy_tracks_the_f32_oracle_and_jax(l2):
    feeds = _mlp_feeds()
    f32 = _mlp(_port(), upd, l2=l2).fit(feeds, epochs=4)
    sd = _mlp(_port(), upd, l2=l2).set_dtype("BFLOAT16")
    b16 = sd.fit(feeds, epochs=4)
    jb16 = _mlp(JSameDiff(), jupd, l2=l2).set_dtype("BFLOAT16").fit(
        feeds, epochs=4)
    assert f32.losses[-1] < f32.losses[0]
    assert b16.losses[-1] < b16.losses[0]
    np.testing.assert_allclose(b16.losses[-1], f32.losses[-1], **BAND)
    np.testing.assert_allclose(b16.losses, jb16.losses, **BAND)
    # the policy computed in bf16: the curve is not float32's
    assert b16.losses != f32.losses
    for n in ("w1", "w2", "b1", "b2"):
        assert sd._values[n].dtype == torch.float32, n


def test_bf16_policy_keeps_masters_and_state_float32():
    feeds = _mlp_feeds(n=2)
    sd = _mlp(_port(), upd).set_dtype("BFLOAT16")
    sd.set_updater(upd.Adam(learning_rate=1e-2))
    names = sd.variables()
    carry = sd._fit_carry({n: sd._values[n] for n in names})
    masters, copies = carry
    assert all(copies[n].dtype == torch.bfloat16 for n in names)
    state = sd.updater.init_state(masters)
    loss, carry, state = sd._fit_step(carry, state, sd._cast_other_vals(
        {n: v for n, v in sd._values.items() if n not in names}), feeds[0])
    for tree in (carry[0], state["m"], state["v"]):
        assert all(t.dtype == torch.float32 for t in tree.values())
    # the new compute copies are the new masters rounded once
    for n in names:
        torch.testing.assert_close(carry[1][n], carry[0][n].to(
            torch.bfloat16), rtol=0, atol=0)
    assert loss.dtype == torch.float32
    # output and grad stay in the recorded dtype
    out = sd.output(feeds[0], [sd.loss_name])[sd.loss_name]
    assert out.dtype == np.float32
    assert all(g.dtype == np.float32 for g in sd.grad(feeds[0]).values())


def test_bf16_compute_copy_gradients_upcast_exactly():
    """The fused step differentiates the bf16 copies and upcasts their
    gradients: bit for bit what differentiating the f32 masters through
    the cast gives (the cast's transpose is exact)."""
    feeds = _mlp_feeds(n=1)[0]
    sd = _mlp(_port(), upd).set_dtype("BFLOAT16")
    names = sd.variables()
    masters, copies = sd._fit_carry({n: sd._values[n] for n in names})
    other = sd._cast_other_vals({n: v for n, v in sd._values.items()
                                 if n not in names})
    loss, grads = sd._value_and_grad(feeds, masters, penalty=False,
                                     compute=copies, other=other)
    leaves = {n: t.detach().requires_grad_(True) for n, t in masters.items()}
    env = {**other, **{n: t.to(torch.bfloat16) for n, t in leaves.items()},
           **{k: torch.from_numpy(v).to(torch.bfloat16)
              for k, v in feeds.items()}}
    ops, _ = sd._needed([sd.loss_name])
    sd._exec_ops(ops, env)
    ref = torch.autograd.grad(env[sd.loss_name].float(),
                              list(leaves.values()))
    assert float(loss) == float(env[sd.loss_name].detach().float())
    for n, g in zip(leaves, ref):
        assert grads[n].dtype == torch.float32
        torch.testing.assert_close(grads[n], g, rtol=0, atol=0)


def test_bf16_routing_counted_once_a_step_build():
    feeds = _mlp_feeds(n=2)
    sd = _mlp(_port(), upd).set_dtype("BFLOAT16")
    fe.reset_counters()
    sd.fit(feeds)
    sd.fit(feeds)
    assert fe.updater_counters() == {"fused_updater": 1,
                                     "fallback_updater_dtype": 0,
                                     "fallback_updater_penalty": 0}
    assert sd.fused_updater_active()
    sd.set_dtype("FLOAT")
    sd.fit(feeds)
    assert not sd.fused_updater_active()
    assert fe.updater_counters()["fallback_updater_dtype"] == 1
    with pytest.raises(ValueError, match="dtype"):
        sd.set_dtype("BFLOAT17")
    fe.reset_counters()


# ------------------------------------------------------------------ remat

def _mini_transformer(sd, up, mode, blocks=3, d=32, seed=3):
    """The JAX remat test's graph (``tests/test_memory_remat.py:80``)."""
    rng = np.random.default_rng(seed)
    x = sd.placeholder("x")
    h = x
    for i in range(blocks):
        wq = sd.var(f"wq{i}", rng.normal(0, 0.1, (d, d)).astype(np.float32))
        wk = sd.var(f"wk{i}", rng.normal(0, 0.1, (d, d)).astype(np.float32))
        wv = sd.var(f"wv{i}", rng.normal(0, 0.1, (d, d)).astype(np.float32))
        wf = sd.var(f"wf{i}",
                    rng.normal(0, 0.1, (d, 4 * d)).astype(np.float32))
        wo = sd.var(f"wo{i}",
                    rng.normal(0, 0.1, (4 * d, d)).astype(np.float32))
        q, k, v = h.mmul(wq), h.mmul(wk), h.mmul(wv)
        s = sd.call("linalg.mmul", q, k, attrs={"transpose_b": True})
        s = s / float(np.sqrt(d))
        p = sd.softmax(s)
        ctx = sd.call("linalg.mmul", p, v)
        ff = sd.relu(ctx.mmul(wf))
        h = h + ff.mmul(wo)
    pooled = h.mean(axis=1)
    wc = sd.var("wc", rng.normal(0, 0.1, (d, 4)).astype(np.float32))
    y = sd.placeholder("y")
    sd.set_loss(sd.call("loss.softmax_ce_logits", y, pooled.mmul(wc)))
    sd.set_updater(up.Adam(learning_rate=1e-3))
    sd.set_workspace_mode(mode)
    return sd


def _tx_feeds(batch=8, t=16, d=32, seed=0):
    rng = np.random.default_rng(seed)
    return {"x": rng.normal(size=(batch, t, d)).astype(np.float32),
            "y": np.eye(4, dtype=np.float32)[rng.integers(0, 4, batch)]}


def _plain(sd):
    x = sd.placeholder("x")
    out = x.mmul(sd.var("w", np.ones((4, 4), np.float32)))
    for _ in range(6):
        out = sd.relu(out)
    return sd


def _plan_names(plan):
    return [([r.outputs for r in ops], ins, outs) for ops, ins, outs in plan]


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_segments_equal_jax(mode, fused):
    sd = _mini_transformer(_port(), upd, mode)
    jsd = _mini_transformer(JSameDiff(), jupd, mode)
    if fused:
        assert fusion.fuse_attention(sd).matched == 3
        assert jfusion.fuse_attention(jsd).matched == 3
    assert sd.to_json() == jsd.to_json()
    assert remat.attention_anchors(sd) == jremat.attention_anchors(jsd)
    assert len(remat.attention_anchors(sd)) == 3
    policy, jpolicy = mem.resolve_policy(mode), jmem.resolve_policy(mode)
    assert remat.segment_bounds(sd, policy) == \
        jremat.segment_bounds(jsd, jpolicy)
    targets = (sd.loss_name,)
    assert _plan_names(remat.plan_segments(sd, targets, policy)) == \
        _plan_names(jremat.plan_segments(jsd, targets, jpolicy))


def test_anchorless_segments_equal_jax():
    sd, jsd = _plain(_port()), _plain(JSameDiff())
    policy, jpolicy = mem.resolve_policy("full"), jmem.resolve_policy("full")
    bounds = remat.segment_bounds(sd, policy)
    assert bounds == jremat.segment_bounds(jsd, jpolicy)
    assert bounds[0][0] == 0 and bounds[-1][1] == len(sd._ops)
    assert remat.attention_anchors(sd) == []
    assert remat.segment_bounds(_port(), policy) == []


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_remat_losses_equal_none_and_jax(mode, fused):
    feeds = _tx_feeds()
    ref = _mini_transformer(_port(), upd, "none")
    sd = _mini_transformer(_port(), upd, mode)
    jsd = _mini_transformer(JSameDiff(), jupd, mode)
    if fused:
        fusion.fuse_attention(ref)
        fusion.fuse_attention(sd)
        jfusion.fuse_attention(jsd)
    want = ref.fit([feeds], epochs=3).losses
    got = sd.fit([feeds], epochs=3).losses
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got, jsd.fit([feeds], epochs=3).losses,
                               rtol=JAX_TOL, atol=JAX_TOL)
    for n in sd.variables():
        np.testing.assert_allclose(sd.get_value(n), ref.get_value(n),
                                   rtol=0, atol=ATOL)


def test_workspace_mode_survives_serde_both_ways(tmp_path):
    sd = _mini_transformer(_port(), upd, "every_2")
    sd.save(str(tmp_path / "p.zip"))
    assert JSameDiff.load(str(tmp_path / "p.zip")).workspace_mode == \
        "every_2"
    jsd = _mini_transformer(JSameDiff(), jupd, "full")
    jsd.save(str(tmp_path / "j.zip"))
    back = SameDiff.load(str(tmp_path / "j.zip"), device="cpu")
    assert back.workspace_mode == "full"
    assert SameDiff.load(str(tmp_path / "p.zip"),
                         device="cpu").workspace_mode == "every_2"
    assert sd.set_workspace_mode("ENABLED").workspace_mode == "full"
    with pytest.raises(ValueError):
        sd.set_workspace_mode("bogus")
    assert sd.workspace_mode == "full"


# ---------------------------------------------------------- memory_report

def test_memory_report_fields_and_remat_saving():
    feeds = _tx_feeds()
    reports = {m: _mini_transformer(_port(), upd, m).memory_report(feeds)
               for m in ("none", "full")}
    jrep = _mini_transformer(JSameDiff(), jupd, "none").memory_report(feeds)
    for m, r in reports.items():
        assert set(r) == set(jrep)
        assert r["workspace_mode"] == m and r["batch_size"] == 8
        for k in ("temp_bytes", "argument_bytes", "output_bytes",
                  "alias_bytes", "generated_code_bytes", "peak_bytes",
                  "device"):
            assert r[k] is None, k  # no compile to ask; no card here
        assert r["residual_bytes"] >= r["activation_bytes"] > 0
        assert r["residual_count"] > 0
    assert reports["full"]["activation_bytes"] < \
        reports["none"]["activation_bytes"]
    # the report trains nothing
    sd = _mini_transformer(_port(), upd, "full")
    before = {n: sd.get_value(n) for n in sd.variables()}
    sd.memory_report(feeds)
    for n, v in before.items():
        np.testing.assert_array_equal(sd.get_value(n), v)
    bf = _mlp(_port(), upd).set_dtype("BFLOAT16")
    bf.set_updater(upd.Adam(learning_rate=1e-2))
    rep = bf.memory_report(_mlp_feeds(n=1)[0])
    assert rep["batch_size"] == 32 and rep["residual_bytes"] > 0


# ------------------------------------------- the fused BERT slice, tiny

TINY = dict(vocab_size=200, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=2, intermediate_size=64,
            max_position_embeddings=32)
SEQ = 8


def _tiny_fused_bert():
    """The chip's [bert-bf16-fit] and [bert-remat] graph at tiny size:
    ``spelling="fusable"``, ``fuse_attention``, ``fuse_epilogues``, the
    fine-tune head; and its JAX copy."""
    import jax.numpy as jnp
    from deeplearning4j_tpu_torch.models.bert import (
        BertConfig, attach_classifier_head, bert)
    sd = bert(BertConfig(**TINY), seed=3, device="cpu", seq_len=SEQ,
              spelling="fusable")
    assert fusion.fuse_attention(sd).matched == 2
    assert fusion.fuse_epilogues(sd).unmatched == 0
    attach_classifier_head(sd, seed=0)
    jsd = JSameDiff.from_json(sd.to_json())
    jsd._values = {n: jnp.asarray(sd.get_value(n)) for n in sd._values}
    return sd, jsd


def _tiny_feeds(seed):
    from deeplearning4j_tpu_torch.models.bert import fine_tune_feeds
    return fine_tune_feeds(np.random.default_rng(seed), 4, SEQ,
                           vocab=TINY["vocab_size"])


def test_fused_bert_bf16_fit_tracks_jax():
    feeds = [_tiny_feeds(1), _tiny_feeds(2)]
    sd, jsd = _tiny_fused_bert()
    sd.set_dtype("BFLOAT16")
    jsd.set_dtype("BFLOAT16")
    got = sd.fit(feeds, epochs=2).losses
    np.testing.assert_allclose(got, jsd.fit(feeds, epochs=2).losses, **BAND)
    f32, _ = _tiny_fused_bert()
    np.testing.assert_allclose(got, f32.fit(feeds, epochs=2).losses, **BAND)
    assert all(sd._values[n].dtype == torch.float32 for n in sd.variables())


@pytest.mark.parametrize("mode", ["full", "every_2"])
def test_fused_bert_remat_equals_none_and_jax_segments(mode):
    feeds = [_tiny_feeds(3)]
    ref, _ = _tiny_fused_bert()
    sd, jsd = _tiny_fused_bert()
    sd.set_workspace_mode(mode)
    policy = mem.resolve_policy(mode)
    assert remat.segment_bounds(sd, policy) == jremat.segment_bounds(
        jsd, jmem.resolve_policy(mode))
    assert len(remat.attention_anchors(sd)) == 2
    want = ref.fit(feeds, epochs=2).losses
    np.testing.assert_allclose(sd.fit(feeds, epochs=2).losses, want,
                               rtol=0, atol=ATOL)
    r_none, r_mode = ref.memory_report(feeds[0]), sd.memory_report(feeds[0])
    assert r_mode["activation_bytes"] < r_none["activation_bytes"]
