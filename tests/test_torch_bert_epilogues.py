"""The LayerNorm-epilogue slice at tiny size, on the CPU: a two-layer BERT
(hidden 32, 4 heads, intermediate 64, sequence 16) recorded by the port in
both spellings of ``models.bert.bert``, handed to the JAX package as the
same graph.json and values, and fused in both packages.

- ``spelling="fusable"``: ``fuse_attention`` then ``fuse_epilogues``
  report 5 ``layer_norm`` sites (the embeddings', two per layer) and 2
  ``gelu`` sites, 0 unmatched, in both packages, with equal reports and
  fused op lists; ``last_hidden_state`` agrees with the JAX package's in
  its auto mode (the fallback formulas) and in its force mode (the Pallas
  LayerNorm and affine kernels in interpret mode) within 1e-5;
- the fine-tune head's loss and every VARIABLE's gradient (``sd.grad``)
  within the JAX package's SameDiff gradient tolerance (rtol 1e-4, atol
  1e-6), and so the values after one Adam step;
- ``spelling="tf"`` (the default, the TF importer's graph) matches no
  epilogue site in either package, as before;
- unfused, the two spellings compute the same encoder (erf of ``u``
  against erfc of ``-u``) within 1e-6, and a fused graph loads in the
  other package."""

import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deeplearning4j_tpu.autodiff import fusion as jfusion
from deeplearning4j_tpu.autodiff.samediff import SameDiff as JSameDiff
from deeplearning4j_tpu.ops import fused_epilogues as jfe
from deeplearning4j_tpu_torch.autodiff import fusion
from deeplearning4j_tpu_torch.autodiff.samediff import SameDiff
from deeplearning4j_tpu_torch.models.bert import (
    ATTENTION_MASK, INPUT_IDS, OUTPUT, BertConfig, attach_classifier_head,
    bert, fine_tune_feeds)
from deeplearning4j_tpu_torch.ops import fused_epilogues as fe

TINY = dict(vocab_size=200, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=64,
            max_position_embeddings=32)
SEQ = 16
BATCH = 4
PARITY_TOL = 1e-5
BERT_RTOL, BERT_ATOL = 1e-4, 1e-6


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


def _feeds(seed, labels=False):
    f = fine_tune_feeds(np.random.default_rng(seed), BATCH, SEQ,
                        vocab=TINY["vocab_size"])
    return f if labels else {k: f[k] for k in (INPUT_IDS, ATTENTION_MASK)}


def _jax_copy(sd):
    j = JSameDiff.from_json(sd.to_json())
    j._values = {n: jnp.asarray(sd.get_value(n)) for n in sd._values}
    return j


def _report(rep):
    return (rep.matched, rep.unmatched, rep.sites, rep.kinds, rep.reasons)


def _fused_pair(spelling="fusable", head=False):
    """The port's graph and the JAX package's copy, both fused."""
    sd = bert(BertConfig(**TINY), seed=3, device="cpu", seq_len=SEQ,
              spelling=spelling)
    if head:
        attach_classifier_head(sd, seed=0)
    jsd = _jax_copy(sd)
    reps = []
    for s, fu in ((sd, fusion), (jsd, jfusion)):
        att = fu.fuse_attention(s)
        assert (att.matched, att.unmatched) == (TINY["num_hidden_layers"], 0)
        reps.append(fu.fuse_epilogues(s))
    return sd, jsd, reps


def _out(sd, feeds=None, name=OUTPUT):
    return np.asarray(sd.output(feeds or _feeds(0), [name])[name])


def test_fusable_spelling_fuses_every_site_in_both_packages():
    sd, jsd, (rep, jrep) = _fused_pair()
    layers = TINY["num_hidden_layers"]
    assert _report(rep) == _report(jrep)
    assert (rep.matched, rep.unmatched) == (3 * layers + 1, 0), rep.reasons
    assert rep.kinds.count("layer_norm") == 2 * layers + 1
    assert rep.kinds.count("gelu") == layers
    assert rep.sites[0] == "bert/embeddings/LayerNorm/batchnorm/add_1"
    assert "bert/encoder/layer_._0/intermediate/Gelu/mul_2" in rep.sites
    assert json.loads(sd.to_json())["ops"] == json.loads(jsd.to_json())["ops"]
    ops = [r.op for r in sd._ops]
    assert ops.count("epilogue.layer_norm_act") == 2 * layers + 1
    assert ops.count("epilogue.bias_act") == layers
    assert not {"math.rsqrt", "math.erf", "math.squared_difference"} \
        & set(ops)
    gelu = [r for r in sd._ops if r.op == "epilogue.bias_act"]
    assert all(r.attrs == {"act": "gelu_exact"} and len(r.inputs) == 2
               and r.inputs[1].endswith("intermediate/dense/bias")
               for r in gelu)


def test_fused_output_matches_jax_auto_and_force():
    sd, jsd, _ = _fused_pair()
    fe.reset_counters()
    got = _out(sd)
    layers = TINY["num_hidden_layers"]
    assert fe.counters() == {"fused": 0,
                             "fallback_platform": 3 * layers + 1,
                             "fallback_act": 0, "fallback_dtype": 0}
    assert got.shape == (BATCH, SEQ, TINY["hidden_size"])
    np.testing.assert_allclose(got, _out(jsd), atol=PARITY_TOL,
                               rtol=PARITY_TOL)
    old = jfe.set_mode("force")
    try:
        jsd._fn_cache.clear()
        forced = _out(jsd)
    finally:
        jfe.set_mode(old)
        jsd._fn_cache.clear()
    np.testing.assert_allclose(got, forced, atol=PARITY_TOL, rtol=PARITY_TOL)


def test_spellings_compute_the_same_encoder():
    tf = bert(BertConfig(**TINY), seed=3, device="cpu", seq_len=SEQ)
    fu = bert(BertConfig(**TINY), seed=3, device="cpu", seq_len=SEQ,
              spelling="fusable")
    assert tf.variables() == fu.variables()
    for n in tf.variables():
        np.testing.assert_array_equal(tf.get_value(n), fu.get_value(n))
    np.testing.assert_allclose(_out(tf), _out(fu), atol=1e-6, rtol=1e-6)
    fusion.fuse_attention(fu)
    fusion.fuse_epilogues(fu)
    np.testing.assert_allclose(_out(tf), _out(fu), atol=PARITY_TOL,
                               rtol=PARITY_TOL)
    with pytest.raises(ValueError, match="spelling"):
        bert(BertConfig(**TINY), device="cpu", seq_len=SEQ, spelling="keras")


def test_tf_spelling_matches_no_epilogue_site_in_either_package():
    sd, jsd, (rep, jrep) = _fused_pair(spelling="tf")
    assert _report(rep) == _report(jrep) == (0, 0, [], [], [])
    ops = [r.op for r in sd._ops]
    assert "math.erfc" in ops and "math.erf" not in ops
    assert ops.count("act.identity") > 0


def test_fine_tune_gradients_and_one_adam_step_match_jax():
    sd, jsd, _ = _fused_pair(head=True)
    feeds = _feeds(1, labels=True)
    loss = sd.loss_name
    np.testing.assert_allclose(sd.output(feeds, [loss])[loss],
                               np.asarray(jsd.output(feeds, [loss])[loss]),
                               rtol=PARITY_TOL)
    got, want = sd.grad(feeds), jsd.grad(feeds)
    assert set(got) == set(want) == set(sd.variables())
    for n in want:
        np.testing.assert_allclose(got[n], np.asarray(want[n]),
                                   rtol=BERT_RTOL, atol=BERT_ATOL, err_msg=n)
    # the LayerNorm gammas and betas get K7's (plain) column sums
    assert np.abs(got["bert/embeddings/LayerNorm/gamma"]).sum() > 0
    hist, jhist = sd.fit(feeds), jsd.fit(feeds)
    np.testing.assert_allclose(hist.losses, jhist.losses, rtol=BERT_RTOL)
    for n in sd.variables():
        np.testing.assert_allclose(sd.get_value(n),
                                   np.asarray(jsd.get_value(n)),
                                   rtol=BERT_RTOL, atol=BERT_ATOL, err_msg=n)


def test_fused_bert_loads_in_the_other_package(tmp_path):
    sd, jsd, _ = _fused_pair()
    sd.save(str(tmp_path / "port.zip"))
    jsd.save(str(tmp_path / "jax.zip"))
    want = _out(sd)
    np.testing.assert_allclose(
        _out(JSameDiff.load(str(tmp_path / "port.zip"))), want,
        atol=PARITY_TOL, rtol=PARITY_TOL)
    np.testing.assert_array_equal(
        _out(SameDiff.load(str(tmp_path / "jax.zip"), device="cpu")), want)
