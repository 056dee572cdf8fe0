"""The port's BERT serving path against the JAX package and TensorFlow, on
the CPU, at a tiny configuration (2 layers, hidden 32, 2 heads,
intermediate 64, vocab 200; batch 4, sequence 8, ragged masks).

(a) ``models.bert``'s graph, carried by ``to_json`` and its values into the
    JAX package's ``SameDiff.from_json``: both packages fuse the same 2
    attention sites and give the same ``last_hidden_state`` within 1e-5,
    before and after fusing.
(b) With ``transformers`` present: a frozen HF ``TFBertModel`` (ids and
    mask inputs) imported by the JAX package and saved; the port's
    ``SameDiff.load`` of that ZIP gives the JAX output within 1e-5, before
    and after ``fuse_attention`` (the same report in both packages).
(c) ``models.bert`` given that TF model's weights gives TF's own
    ``last_hidden_state`` within 1e-4 (the tolerance of the JAX package's
    TF-import test), and records as many compute ops of each kind
    (``linalg.mmul``, ``attention.fused_sdpa``, ``reduce.mean``,
    ``math.rsqrt``, ``math.erfc``, ``shape.gather``) as the JAX import.

All values are float32; the tolerances cover summation order only (the
CPU, XLA and TensorFlow sum each product in their own order).

The TF-dependent tests share one frozen model (a module fixture) and sit
together in this file."""

import collections
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.autodiff import fusion as jfusion
from deeplearning4j_tpu.autodiff.samediff import SameDiff as JSameDiff
from deeplearning4j_tpu_torch.autodiff import fusion
from deeplearning4j_tpu_torch.autodiff.samediff import SameDiff
from deeplearning4j_tpu_torch.models.bert import (ATTENTION_MASK, INPUT_IDS,
                                                  OUTPUT, BertConfig, bert,
                                                  weight_shapes)

TINY = dict(vocab_size=200, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=2, intermediate_size=64,
            max_position_embeddings=32)
BATCH, SEQ = 4, 8
PARITY_TOL = 1e-5
TF_TOL = 1e-4
COMPUTE_OPS = ("linalg.mmul", "attention.fused_sdpa", "reduce.mean",
               "math.rsqrt", "math.erfc", "shape.gather")


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


def _feeds(seed=0):
    rng = np.random.default_rng(seed)
    lengths = np.array([8, 5, 1, 3])
    mask = (np.arange(SEQ)[None, :] < lengths[:, None]).astype(np.int32)
    ids = rng.integers(1, TINY["vocab_size"], (BATCH, SEQ)).astype(np.int32)
    return {INPUT_IDS: ids * mask, ATTENTION_MASK: mask}


def _jax_copy(sd):
    j = JSameDiff.from_json(sd.to_json())
    j._values = {n: jnp.asarray(sd.get_value(n)) for n in sd._values}
    return j


def _counts(ops):
    return collections.Counter(r.op for r in ops if r.op in COMPUTE_OPS)


def _out(sd, name=OUTPUT, feeds=None):
    return np.asarray(sd.output(feeds or _feeds(), [name])[name])


# ------------------------------------------------------------ (a) no TF

def test_a_port_graph_runs_in_jax():
    sd = bert(BertConfig(**TINY), seed=3, device="cpu", seq_len=SEQ)
    jsd = _jax_copy(sd)
    np.testing.assert_allclose(_out(sd), _out(jsd), atol=PARITY_TOL,
                               rtol=PARITY_TOL)
    rep, jrep = fusion.fuse_attention(sd), jfusion.fuse_attention(jsd)
    assert (rep.matched, rep.unmatched, rep.sites, rep.reasons) == \
        (jrep.matched, jrep.unmatched, jrep.sites, jrep.reasons) == \
        (2, 0, ["bert/encoder/layer_._0/attention/self/MatMul_1",
                "bert/encoder/layer_._1/attention/self/MatMul_1"], [])
    assert sd.to_json() == jsd.to_json()
    got = _out(sd)
    assert got.shape == (BATCH, SEQ, TINY["hidden_size"])
    np.testing.assert_allclose(got, _out(jsd), atol=PARITY_TOL,
                               rtol=PARITY_TOL)


def test_a_one_graph_serves_every_batch_size():
    sd = bert(BertConfig(**TINY), seed=3, device="cpu", seq_len=SEQ)
    fusion.fuse_attention(sd)
    full = _out(sd)
    for rows in ([0], [1, 2], [3, 0, 2]):
        feeds = {k: v[rows] for k, v in _feeds().items()}
        np.testing.assert_allclose(_out(sd, feeds=feeds), full[rows],
                                   atol=1e-6, rtol=1e-6)


def test_a_weights_from_the_seed():
    cfg = BertConfig(**TINY)
    shapes = weight_shapes(cfg)
    assert len(shapes) == 5 + 16 * cfg.num_hidden_layers
    a = bert(cfg, seed=0, device="cpu", seq_len=SEQ)
    b = bert(cfg, seed=0, device="cpu", seq_len=SEQ)
    c = bert(cfg, seed=1, device="cpu", seq_len=SEQ)
    word = "bert/embeddings/word_embeddings/weight"
    assert np.array_equal(a.get_value(word), b.get_value(word))
    assert not np.array_equal(a.get_value(word), c.get_value(word))
    assert abs(float(a.get_value(word).std()) - 0.02) < 0.002
    assert set(a.variables()) == set(shapes)
    gamma = "bert/encoder/layer_._1/output/LayerNorm/gamma"
    assert np.array_equal(a.get_value(gamma), np.ones(32, np.float32))


def test_a_builder_checks_its_inputs():
    cfg = BertConfig(**TINY)
    with pytest.raises(ValueError, match="seq_len"):
        bert(cfg, device="cpu", seq_len=33)
    with pytest.raises(KeyError, match="lack"):
        bert(cfg, weights={}, device="cpu", seq_len=SEQ)
    weights = {f"m/{n}:0": np.zeros(s, np.float32)
               for n, s in weight_shapes(cfg).items()}
    weights["m/bert/embeddings/LayerNorm/beta:0"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="shape"):
        bert(cfg, weights=weights, device="cpu", seq_len=SEQ)


def test_a_bert_base_geometry():
    cfg = BertConfig()
    assert (cfg.vocab_size, cfg.hidden_size, cfg.num_hidden_layers,
            cfg.num_attention_heads, cfg.intermediate_size,
            cfg.max_position_embeddings, cfg.layer_norm_eps) == \
        (30522, 768, 12, 12, 3072, 512, 1e-12)
    n = sum(int(np.prod(s)) for s in weight_shapes(cfg).values())
    assert n == 108_891_648  # BERT-base without its pooler


# --------------------------------------------------------- (b), (c): TF

@pytest.fixture(scope="module")
def tf_bert():
    """A tiny HF TFBertModel frozen with ids and mask inputs [4, 8], its
    weights, the frozen graph's input/output names and TF's own
    ``last_hidden_state`` on ``_feeds()``."""
    os.environ.setdefault("TRANSFORMERS_OFFLINE", "1")
    pytest.importorskip("transformers")
    import tensorflow as tf
    from tensorflow.python.framework.convert_to_constants import (
        convert_variables_to_constants_v2)
    from transformers import BertConfig as HFBertConfig
    from transformers import TFBertModel

    tf.random.set_seed(0)
    model = TFBertModel(HFBertConfig(**TINY))

    @tf.function
    def f(ids, mask):
        return model(input_ids=ids, attention_mask=mask).last_hidden_state

    conc = f.get_concrete_function(
        tf.TensorSpec([BATCH, SEQ], tf.int32, name=INPUT_IDS),
        tf.TensorSpec([BATCH, SEQ], tf.int32, name=ATTENTION_MASK))
    frozen = convert_variables_to_constants_v2(conc)
    feeds = _feeds()
    ref = f(tf.constant(feeds[INPUT_IDS]),
            tf.constant(feeds[ATTENTION_MASK])).numpy()
    return {
        "graph_def": frozen.graph.as_graph_def(),
        "inputs": [t.name.split(":")[0] for t in frozen.inputs],
        "output": frozen.outputs[0].name.split(":")[0],
        "weights": {w.name: w.numpy() for w in model.weights},
        "ref": ref,
    }


@pytest.fixture(scope="module")
def jax_import(tf_bert):
    from deeplearning4j_tpu.modelimport.tensorflow import (
        TensorflowFrameworkImporter)
    assert tf_bert["inputs"] == [INPUT_IDS, ATTENTION_MASK]
    return TensorflowFrameworkImporter.import_graph_def(tf_bert["graph_def"])


def test_b_jax_import_loads_in_the_port(tf_bert, jax_import, tmp_path):
    path = str(tmp_path / "bert.zip")
    jax_import.save(path)
    jsd = JSameDiff.load(path)
    sd = SameDiff.load(path, device="cpu")
    out = tf_bert["output"]
    want = _out(jsd, out)
    np.testing.assert_allclose(want, tf_bert["ref"], atol=TF_TOL,
                               rtol=TF_TOL)
    np.testing.assert_allclose(_out(sd, out), want, atol=PARITY_TOL,
                               rtol=PARITY_TOL)
    rep, jrep = fusion.fuse_attention(sd), jfusion.fuse_attention(jsd)
    assert (rep.matched, rep.unmatched, rep.sites, rep.reasons) == \
        (jrep.matched, jrep.unmatched, jrep.sites, jrep.reasons)
    assert (rep.matched, rep.unmatched) == (2, 0)
    np.testing.assert_allclose(_out(sd, out), _out(jsd, out),
                               atol=PARITY_TOL, rtol=PARITY_TOL)


def test_b_jax_fuse_epilogues_matches_no_site(jax_import, tf_bert,
                                              tmp_path):
    """The JAX package's LayerNorm/GELU fusion finds nothing to fuse on
    TF-imported HF BERT: its LayerNorm anchor does not see through the
    act.identity of TF's StopGradient, and its GELU anchor is math.erf
    where HF spells math.erfc. So K6/K7 are not on this path."""
    path = str(tmp_path / "bert.zip")
    jax_import.save(path)
    jsd = JSameDiff.load(path)
    jfusion.fuse_attention(jsd)
    rep = jfusion.fuse_epilogues(jsd)
    assert rep.matched == 0
    ops = [r.op for r in jsd._ops]
    assert "math.erfc" in ops and "math.erf" not in ops
    assert ops.count("act.identity") > 0


def test_c_builder_with_tf_weights_matches_tf(tf_bert, jax_import):
    cfg = BertConfig(**TINY)
    sd = bert(cfg, weights=tf_bert["weights"], device="cpu", seq_len=SEQ)
    np.testing.assert_allclose(_out(sd), tf_bert["ref"], atol=TF_TOL,
                               rtol=TF_TOL)
    rep = fusion.fuse_attention(sd)
    assert (rep.matched, rep.unmatched) == (2, 0)
    np.testing.assert_allclose(_out(sd), tf_bert["ref"], atol=TF_TOL,
                               rtol=TF_TOL)
    # the same compute ops as the JAX import, fused alike
    jsd = JSameDiff.from_json(jax_import.to_json())
    jsd._values = dict(jax_import._values)
    jfusion.fuse_attention(jsd)
    assert _counts(sd._ops) == _counts(jsd._ops)
    assert _counts(sd._ops)["attention.fused_sdpa"] == 2


def test_c_port_output_on_the_card_path_is_numpy(tf_bert):
    """``output`` hands back numpy float32 of the TF output's shape."""
    sd = bert(BertConfig(**TINY), weights=tf_bert["weights"], device="cpu",
              seq_len=SEQ)
    got = sd.output(_feeds(), [OUTPUT])[OUTPUT]
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    assert got.shape == tf_bert["ref"].shape
    assert isinstance(sd._values["bert/embeddings/LayerNorm/gamma"],
                      torch.Tensor)
