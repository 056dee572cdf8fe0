"""The port's SameDiff training (``grad``, ``set_training_config``, ``fit``)
and the BERT fine-tune slice against the JAX package, on the CPU.

1. A small graph recorded with the builder API both packages share. The
   JAX package runs the same graph and values (``SameDiff.from_json`` of
   the port's graph.json, the port's values): ``grad``; ``fit`` with Adam,
   l2 and ``gradient_clip_l2`` over a list of feeds in one call (each call
   starts Adam afresh, in both packages); the losses, the new values, the
   second step's loss, ``History``, ``iteration``, ``epoch`` and the
   listener callbacks; a step with a NaN feed that the divergence sentinel
   skips and counts. Within 1e-5 relative (the same float32 arithmetic in
   another library).
2. The slice at tiny size: a two-layer ``bert(BertConfig(**TINY))``,
   ``fuse_attention``, ``attach_classifier_head``, two ``fit`` steps; the
   same graph and values in the JAX package. Losses, every VARIABLE's
   gradient from ``grad`` and the values after the steps, within the JAX
   package's own SameDiff gradient tolerance (rtol 1e-4, atol 1e-6,
   ``tests/test_samediff.py::test_grad_matches_fd``).
3. The head: ``attach_classifier_head`` records ``bench.py`` ``_bert_sd``'s
   ops in its order, with its names and updater, checked on graph.json,
   and the JAX package runs that graph.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.autodiff import fusion as jfusion
from deeplearning4j_tpu.autodiff.samediff import SameDiff as JSameDiff
from deeplearning4j_tpu_torch.autodiff import fusion
from deeplearning4j_tpu_torch.autodiff.samediff import History, SameDiff
from deeplearning4j_tpu_torch.models.bert import (
    LABELS, BertConfig, attach_classifier_head, bert, fine_tune_feeds)
from deeplearning4j_tpu_torch.nn.updaters import Adam

TINY = dict(vocab_size=200, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=2, intermediate_size=64,
            max_position_embeddings=32)
SEQ = 8
SMALL_TOL = 1e-5
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


def _jax_copy(sd):
    j = JSameDiff.from_json(sd.to_json())
    j._values = {n: jnp.asarray(sd.get_value(n)) for n in sd._values}
    return j


class Recorder:
    """A listener that records its callbacks."""

    def __init__(self):
        self.calls = []

    def iteration_done(self, model, iteration, epoch):
        self.calls.append(("iteration", iteration, epoch,
                           float(model.score())))

    def on_epoch_end(self, model):
        self.calls.append(("epoch", model.iteration, model.epoch))


# ------------------------------------------------------------ small graph

def _small_graph():
    rng = np.random.default_rng(0)
    sd = SameDiff(device="cpu")
    x = sd.placeholder("x")
    labels = sd.placeholder("labels")
    w = sd.var("w", rng.standard_normal((3, 5)).astype(np.float32))
    b = sd.var("b", rng.standard_normal(5).astype(np.float32))
    w2 = sd.var("w2", rng.standard_normal((5, 2)).astype(np.float32))
    sd.var("unused", np.ones(4, np.float32))  # the loss does not reach it
    h = sd.tanh(x.mmul(w) + b)
    sd.set_loss(sd.call("loss.softmax_ce_logits", labels, h.mmul(w2)))
    sd.set_training_config(updater=Adam(learning_rate=0.05), l2=1e-2,
                           gradient_clip_l2=0.5)
    return sd


def _small_feeds(seed, n=6):
    rng = np.random.default_rng(seed)
    return {"x": rng.standard_normal((n, 3)).astype(np.float32),
            "labels": np.eye(2, dtype=np.float32)[rng.integers(0, 2, n)]}


def _assert_values(sd, jsd, names, rtol, atol):
    for n in names:
        np.testing.assert_allclose(sd.get_value(n),
                                   np.asarray(jsd.get_value(n)), rtol=rtol,
                                   atol=atol, err_msg=n)


def test_small_graph_grad_matches_jax():
    sd = _small_graph()
    jsd = _jax_copy(sd)
    got, want = sd.grad(_small_feeds(1)), jsd.grad(_small_feeds(1))
    assert set(got) == set(want) == {"w", "b", "w2", "unused"}
    for n in want:
        np.testing.assert_allclose(got[n], np.asarray(want[n]),
                                   rtol=SMALL_TOL, atol=1e-7, err_msg=n)
    assert not got["unused"].any()
    only = sd.grad(_small_feeds(1), wrt=["w2"])
    assert list(only) == ["w2"]
    np.testing.assert_array_equal(only["w2"], got["w2"])


def test_small_graph_fit_matches_jax():
    sd = _small_graph()
    jsd = _jax_copy(sd)
    assert jsd.train_config == sd.train_config
    feeds = [_small_feeds(2), _small_feeds(3)]
    rec, jrec = Recorder(), Recorder()
    hist = sd.fit(feeds, epochs=2, listeners=[rec])
    jhist = jsd.fit(feeds, epochs=2, listeners=[jrec])
    assert isinstance(hist, History) and len(hist) == 4
    np.testing.assert_allclose(hist.losses, jhist.losses, rtol=SMALL_TOL)
    np.testing.assert_allclose(hist.epoch_losses, jhist.epoch_losses,
                               rtol=SMALL_TOL)
    assert hist.losses[1] != hist.losses[3]  # the values moved
    assert (sd.iteration, sd.epoch) == (jsd.iteration, jsd.epoch) == (4, 2)
    assert sd.score() == pytest.approx(jsd.score(), rel=SMALL_TOL)
    assert [c[:3] for c in rec.calls] == [c[:3] for c in jrec.calls] == [
        ("iteration", 1, 0), ("iteration", 2, 0), ("epoch", 2, 1),
        ("iteration", 3, 1), ("iteration", 4, 1), ("epoch", 4, 2)]
    _assert_values(sd, jsd, ["w", "b", "w2", "unused"], SMALL_TOL, 1e-7)
    # the clip engaged (norms above 0.5) in both
    assert sd.resilience_counters() == {
        "bad_total": 0, "bad_consec": 0,
        "clip_events": jsd.resilience_counters()["clip_events"]}
    # a second fit call starts Adam afresh in both packages
    again, jagain = sd.fit(feeds[0]), jsd.fit(feeds[0])
    np.testing.assert_allclose(again.losses, jagain.losses, rtol=SMALL_TOL)
    _assert_values(sd, jsd, ["w", "b", "w2"], SMALL_TOL, 1e-7)


def test_nan_feed_step_is_skipped_and_counted_as_in_jax():
    sd = _small_graph()
    jsd = _jax_copy(sd)
    bad = _small_feeds(4)
    bad["x"][0, 0] = np.nan
    feeds = [_small_feeds(2), bad, _small_feeds(3)]
    hist, jhist = sd.fit(feeds), jsd.fit(feeds)
    assert np.isnan(hist.losses[1]) and np.isnan(jhist.losses[1])
    np.testing.assert_allclose(hist.losses[::2], jhist.losses[::2],
                               rtol=SMALL_TOL)
    _assert_values(sd, jsd, ["w", "b", "w2"], SMALL_TOL, 1e-7)
    got, want = sd.resilience_counters(), jsd.resilience_counters()
    assert (got["bad_total"], got["bad_consec"]) == \
        (want["bad_total"], want["bad_consec"]) == (1, 0)
    assert all(np.isfinite(sd.get_value(n)).all() for n in ("w", "b", "w2"))
    sd.reset_resilience_counters()
    assert sd.resilience_counters()["bad_total"] == 0


def test_training_config_checks_and_serde():
    sd = _small_graph()
    with pytest.raises(ValueError, match="GradientNormalization"):
        sd.set_training_config(gradient_normalization="PerLayerish")
    sd.set_training_config(gradient_normalization="ClipL2PerLayer",
                           gradient_normalization_threshold=0.1, l1=1e-3)
    jsd = _jax_copy(sd)
    assert json.loads(sd.to_json())["training_config"] == jsd.train_config
    feeds = [_small_feeds(5), _small_feeds(6)]
    np.testing.assert_allclose(sd.fit(feeds).losses, jsd.fit(feeds).losses,
                               rtol=SMALL_TOL)
    _assert_values(sd, jsd, ["w", "b", "w2"], SMALL_TOL, 1e-7)
    with pytest.raises(ValueError, match="set_loss"):
        SameDiff(device="cpu").grad({})
    with pytest.raises(ValueError, match="missing placeholder"):
        sd.grad({"x": _small_feeds(1)["x"]})


# ---------------------------------------------------------- the BERT slice

def _tiny_fine_tune(seed=3):
    sd = bert(BertConfig(**TINY), seed=seed, device="cpu", seq_len=SEQ)
    rep = fusion.fuse_attention(sd)
    assert (rep.matched, rep.unmatched) == (2, 0)
    return attach_classifier_head(sd, seed=0)


def _tiny_feeds(seed):
    return fine_tune_feeds(np.random.default_rng(seed), 4, SEQ,
                           vocab=TINY["vocab_size"])


def test_tiny_bert_fine_tune_matches_jax():
    sd = _tiny_fine_tune()
    jsd = _jax_copy(sd)
    feeds = [_tiny_feeds(1), _tiny_feeds(2)]
    got, want = sd.grad(feeds[0]), jsd.grad(feeds[0])
    assert set(got) == set(want) == set(sd.variables())
    for n in want:
        np.testing.assert_allclose(got[n], np.asarray(want[n]),
                                   rtol=BERT_RTOL, atol=BERT_ATOL, err_msg=n)
    hist, jhist = sd.fit(feeds), jsd.fit(feeds)
    np.testing.assert_allclose(hist.losses, jhist.losses, rtol=BERT_RTOL)
    assert all(np.isfinite(hist.losses))
    _assert_values(sd, jsd, sd.variables(), BERT_RTOL, BERT_ATOL)


def test_head_records_the_bench_ops():
    sd = _tiny_fine_tune()
    graph = json.loads(sd.to_json())
    head = graph["ops"][-4:]
    assert [o["op"] for o in head] == ["reduce.mean", "linalg.mmul",
                                       "math.add", "loss.softmax_ce_logits"]
    assert head[0]["inputs"] == ["last_hidden_state"]
    assert head[0]["attrs"] == {"axis": 1, "keepdims": False}
    assert head[1]["inputs"][1] == "cls_W" and head[2]["inputs"][1] == "cls_b"
    assert head[3]["inputs"] == [LABELS, head[2]["outputs"][0]]
    assert graph["loss"] == head[3]["outputs"][0]
    assert graph["updater"]["kind"] == "adam"
    assert graph["updater"]["learning_rate"] == 2e-5
    assert sd.get_value("cls_W").shape == (TINY["hidden_size"], 2)
    np.testing.assert_array_equal(
        sd.get_value("cls_W"), np.random.default_rng(0).normal(
            0, 0.02, (TINY["hidden_size"], 2)).astype(np.float32))
    assert not sd.get_value("cls_b").any()
    # the JAX package records the same head with bench.py's code on the
    # same encoder graph, and runs the port's graph.json
    jsd = _jax_copy(bert(BertConfig(**TINY), seed=3, device="cpu",
                         seq_len=SEQ))
    jfusion.fuse_attention(jsd)
    hidden = jsd._vars["last_hidden_state"]
    w = jsd.var("cls_W", np.random.default_rng(0).normal(
        0, 0.02, (TINY["hidden_size"], 2)).astype(np.float32))
    b = jsd.var("cls_b", np.zeros((2,), np.float32))
    logits = hidden.mean(axis=1).mmul(w) + b
    jsd.set_loss(jsd.call("loss.softmax_ce_logits",
                          jsd.placeholder("labels"), logits))
    from deeplearning4j_tpu.nn.updaters import Adam as JAdam
    jsd.set_updater(JAdam(learning_rate=2e-5))
    jgraph = json.loads(jsd.to_json())
    named = {"last_hidden_state", "cls_W", "cls_b", LABELS}

    def shape(ops):  # fresh names differ with the recording history
        return [(o["op"], o["attrs"], [i if i in named else "*"
                                       for i in o["inputs"]]) for o in ops]
    assert shape(jgraph["ops"][-4:]) == shape(head)
    assert jgraph["updater"] == graph["updater"]
    feeds = _tiny_feeds(7)
    loss = sd.loss_name
    np.testing.assert_allclose(sd.output(feeds, [loss])[loss],
                               np.asarray(_jax_copy(sd).output(
                                   feeds, [loss])[loss]), rtol=1e-5)


def test_fine_tune_feeds_follow_bench_bert():
    f = fine_tune_feeds(np.random.default_rng(0), 5, 16)
    ids, mask, y = f["input_ids"], f["attention_mask"], f[LABELS]
    assert ids.dtype == mask.dtype == np.int32 and y.dtype == np.float32
    assert ids.shape == mask.shape == (5, 16) and y.shape == (5, 2)
    assert (ids[mask == 0] == 0).all() and (ids[mask == 1] > 0).all()
    assert (mask[:, 0] == 1).all()  # every row keeps at least one token
    np.testing.assert_array_equal(y.argmax(axis=1), ids.sum(axis=1) % 2)
