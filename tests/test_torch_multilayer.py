"""The port's MultiLayerNetwork serving half against the JAX package's, on
the CPU, on a tiny TextGenerationLSTM (vocab 11, two ``LSTM(16,
use_pallas_cell=True)``, ``RnnOutputLayer(11)``): the layer list the zoo
builds, with the fused cell switched on as a JAX user would.

Both sides run the same weights (the JAX package's, carried with
``utils.convert.from_numpy`` or through a saved ZIP) on the same numpy
one-hot sequences. ``output`` (ragged ``lengths``: the time axis padded
to its bucket and masked), ``rnn_time_step`` (chunks and single steps,
then ``rnn_clear_previous_state``), ``feed_forward`` and ``predict``
agree within 1e-5 (float32; the cell's sums run in another order). A ZIP
saved by either package loads in the other. What the slice leaves out
raises ``NotImplementedError``."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models.zoo import text_generation_lstm as jtgl
from deeplearning4j_tpu.nn import config as jconfig
from deeplearning4j_tpu.nn.layers import recurrent as jrec
from deeplearning4j_tpu.nn.model import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.nn.updaters import Adam as JAdam
from deeplearning4j_tpu_torch.models import text_generation_lstm
from deeplearning4j_tpu_torch.nn import config
from deeplearning4j_tpu_torch.nn.layers import recurrent as rec
from deeplearning4j_tpu_torch.nn.layers.core import DenseLayer
from deeplearning4j_tpu_torch.nn.model import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.updaters import Adam
from deeplearning4j_tpu_torch.ops import pallas_kernels as pk
from deeplearning4j_tpu_torch.utils.convert import from_numpy

VOCAB, UNITS, B, T = 11, 16, 3, 7
TOL = dict(rtol=1e-5, atol=1e-5)
LENGTHS = [7, 3, 5]


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


def _jax_net():
    conf = jtgl(vocab_size=VOCAB, units=UNITS).conf
    layers = [dataclasses.replace(l, use_pallas_cell=True)
              if l.kind == "lstm" else l for l in conf.layers]
    return JMLN(dataclasses.replace(conf, layers=layers)).init()


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def nets():
    """(JAX net, the port's net on the CPU with the JAX weights)."""
    jn = _jax_net()
    pn = MultiLayerNetwork(config.MultiLayerConfiguration.from_json(
        jn.conf.to_json())).init(device="cpu")
    pn.params, pn.state = from_numpy(_np_tree(jn.params),
                                     _np_tree(jn.state), "cpu")
    return jn, pn


def _seqs(seed=0, b=B, t=T):
    ids = np.random.default_rng(seed).integers(0, VOCAB, (b, t))
    return np.eye(VOCAB, dtype=np.float32)[ids]


def test_zoo_config_matches_jax():
    assert text_generation_lstm().conf.to_json() == jtgl().conf.to_json()
    net = text_generation_lstm().init(device="cpu")
    assert net.num_params() == 887_117  # vocab 77, 2 x LSTM(256), RNN out
    # the EmbeddingSequenceLayer front is ported too
    assert text_generation_lstm(embedding=8).conf.to_json() == \
        jtgl(embedding=8).conf.to_json()


def test_builder_matches_jax_with_tbptt_stamping():
    def build(mod, adam, lstm, out):
        return (mod.NeuralNetConfiguration.builder().seed(7)
                .updater(adam(learning_rate=1e-2))
                .input_type(mod.InputType.recurrent(VOCAB, 20))
                .tbptt_length(5)
                .list(lstm(n_out=UNITS, use_pallas_cell=True),
                      lstm(n_out=UNITS, tbptt_length=3), out(n_out=VOCAB))
                .build())

    port = build(config, Adam, rec.LSTM, rec.RnnOutputLayer)
    ref = build(jconfig, JAdam, jrec.LSTM, jrec.RnnOutputLayer)
    assert [l.tbptt_length for l in port.layers[:2]] == [5, 3]
    assert port.to_json() == ref.to_json()
    back = config.MultiLayerConfiguration.from_json(port.to_json())
    assert back.to_json() == port.to_json()
    assert config.InputType.feed_forward(5) == jconfig.InputType.feed_forward(5)


def test_build_refuses_a_conv_input_into_dense_layers():
    """Since the LeNet slice, ``build()`` no longer refuses a convolutional
    input into dense layers: it puts a FlattenLayer at the seam, as the
    JAX package's builder does."""
    from deeplearning4j_tpu.nn import config as jcfg
    from deeplearning4j_tpu.nn.layers.core import DenseLayer as JDense
    b = (config.NeuralNetConfiguration.builder()
         .input_type(config.InputType.convolutional(1, 28, 28))
         .list(DenseLayer(n_out=10)))
    kinds = [l.kind for l in b.build().layers]
    assert kinds == ["flatten", "dense"]
    assert kinds == [l.kind for l in (
        jcfg.NeuralNetConfiguration.builder()
        .input_type(jcfg.InputType.convolutional(1, 28, 28))
        .list(JDense(n_out=10)).build().layers)]


def test_output_with_ragged_lengths_matches_jax(nets):
    jn, pn = nets
    x = _seqs(1)
    want = np.asarray(jn.inference_engine().output(x, lengths=LENGTHS))
    pk.reset_counters()
    got = pn.inference_engine().output(x, lengths=LENGTHS)
    assert got.shape == (B, T, VOCAB)
    np.testing.assert_allclose(got, want, **TOL)
    # 2 layers x the time bucket 8, every step through the fused cell
    assert pk.counters() == {"fused": 0, "fallback_platform": 2 * 8}
    # the plain output() (no lengths: every real step counts)
    np.testing.assert_allclose(pn.output(x), np.asarray(jn.output(x)), **TOL)
    np.testing.assert_array_equal(pn.predict(x), np.asarray(jn.predict(x)))


def test_feed_forward_matches_jax(nets):
    jn, pn = nets
    x = _seqs(2)
    want = jn.feed_forward(x)
    got = pn.feed_forward(x)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_rnn_time_step_matches_jax(nets):
    jn, pn = nets
    x = _seqs(3, t=9)
    for n in (jn, pn):
        n.rnn_clear_previous_state()
    chunks = [x[:, :3], x[:, 3], x[:, 4:8], x[:, 8]]
    streamed = []
    for chunk in chunks:
        want = np.asarray(jn.rnn_time_step(chunk))
        got = pn.rnn_time_step(chunk)
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, **TOL)
        streamed.append(got if got.ndim == 3 else got[:, None])
    # streaming over the chunks is output() on their concatenation
    np.testing.assert_allclose(np.concatenate(streamed, axis=1),
                               pn.output(x), rtol=1e-6, atol=1e-6)
    # a cleared stream starts from zeros again
    for n in (jn, pn):
        n.rnn_clear_previous_state()
    np.testing.assert_allclose(pn.rnn_time_step(x[:, :2]),
                               np.asarray(jn.rnn_time_step(x[:, :2])), **TOL)
    pn.rnn_clear_previous_state()
    np.testing.assert_allclose(pn.rnn_time_step(x[:, :2]), pn.output(
        x[:, :2]), rtol=1e-6, atol=1e-6)


def test_engine_buckets_and_stats(nets):
    _, pn = nets
    eng = pn.inference_engine()
    eng.warmup([4], seq_buckets=[7])
    x = _seqs(4)
    before = eng.stats()
    eng.output(x, lengths=LENGTHS)
    st = eng.stats()
    assert 4 in st["warmed_buckets"] and 8 in st["warmed_seq_buckets"]
    assert st["calls"] == before["calls"] + 1
    assert st["hits"] == before["hits"] + 1
    assert st["padded_rows"] == before["padded_rows"] + 1
    assert any(k.startswith("[(4, 8, 11)") for k in st["bucket_hits"])
    with pytest.raises(ValueError, match="dynamic sequence length"):
        eng.warmup([1])


def test_jax_zip_loads_in_the_port(tmp_path, nets):
    jn, _ = nets
    path = str(tmp_path / "jax.zip")
    jn.save(path)
    pn = MultiLayerNetwork.load(path, device="cpu")
    assert pn.conf.to_json() == jn.conf.to_json()
    x = _seqs(5)
    np.testing.assert_allclose(pn.output(x), np.asarray(jn.output(x)), **TOL)
    assert set(pn.updater_state) == set(jn.updater_state)


def test_port_zip_loads_in_jax(tmp_path, nets):
    _, pn = nets
    path = str(tmp_path / "port.zip")
    pn.save(path)
    jn = JMLN.load(path)
    x = _seqs(6)
    np.testing.assert_allclose(np.asarray(jn.output(x)), pn.output(x), **TOL)
    for si, leaves in pn.params.items():
        for k, t in leaves.items():
            np.testing.assert_array_equal(np.asarray(jn.params[si][k]),
                                          t.numpy())


def test_what_the_slice_leaves_out_raises(nets):
    """What later slices bring raises, naming the slice (``fit``,
    ``score``, ``evaluate`` and training-mode ``output`` came with the
    LeNet slice, ``tests/test_torch_lenet.py``; ``fit_on_device`` and
    accumulation with the training-modes slice; ``quantize_params`` with
    the int8-serving slice, ``tests/test_torch_quantize.py``)."""
    _, pn = nets
    x = _seqs(7)
    for call in (lambda: pn.fit(x, x, resilience=object()),
                 lambda: pn.set_listeners(object())):
        with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1"):
            call()
    # int8 serving is ported: the output head's W is quantized, the LSTM
    # layers (not quantizable, as in the JAX package) keep theirs
    qp = pn.quantize_params()
    last = str(len(pn.layers) - 1)
    assert type(qp[last]["W"]).__name__ == "QuantizedTensor"
    assert qp["0"]["W"] is pn.params["0"]["W"]
    # on-device epochs and accumulation are ported (the training-modes
    # slice): a ragged dataset still raises before anything moves
    assert callable(pn._build_train_step(accum_steps=4))
    with pytest.raises(ValueError, match="not divisible"):
        pn.fit_on_device(x, x, batch_size=len(x) - 1)
    # the decode walk and the paged pool are ported; an LSTM stack refuses
    # both, as in the JAX package
    with pytest.raises(ValueError, match="decode"):
        pn.decode_cache_spec(1, 8)
    with pytest.raises(ValueError, match="decode"):
        pn.paged_cache_spec(4, 8)


def test_engine_masks_a_graph_sequence_input_as_jax_does():
    """The engine's sequence buckets and masks serve a ComputationGraph
    with a recurrent input too, as the JAX engine does."""
    from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph

    def build(mod, lstm, out):
        return (mod.NeuralNetConfiguration.builder().seed(3).graph_builder()
                .add_inputs("chars")
                .set_input_types(mod.InputType.recurrent(VOCAB))
                .add_layer("lstm", lstm(n_out=UNITS, use_pallas_cell=True),
                           "chars")
                .add_layer("out", out(n_out=VOCAB), "lstm")
                .set_outputs("out").build())

    jg = JGraph(build(jconfig, jrec.LSTM, jrec.RnnOutputLayer)).init()
    pg = ComputationGraph(build(config, rec.LSTM, rec.RnnOutputLayer)).init(
        device="cpu")
    pg.params, pg.state = from_numpy(_np_tree(jg.params), _np_tree(jg.state),
                                     "cpu")
    x = _seqs(8)
    want = np.asarray(jg.inference_engine().output(x, lengths=LENGTHS))
    got = pg.inference_engine().output(x, lengths=LENGTHS)
    assert got.shape == (B, T, VOCAB)
    np.testing.assert_allclose(got, want, **TOL)


def test_profile_lstm_drives_the_card_path_on_the_cpu():
    """``tools/profile_lstm``'s network, requests and greedy generation
    (what ``chip_smoke.py`` [lstm-serve] runs on the card), at the zoo's
    width on the CPU with a few steps: streaming equals ``output()`` on the
    generated text."""
    from deeplearning4j_tpu_torch.tools import profile_lstm as pl
    net = pl.build(seed=0, device="cpu")
    assert net.num_params() == 887_117
    # the zoo's layer list, with the fused cell switched on
    assert [dataclasses.replace(l, use_pallas_cell=False)
            if l.kind == "lstm" else l for l in net.conf.layers] == \
        text_generation_lstm(seed=0).conf.layers
    assert all(l.use_pallas_cell for l in net.conf.layers[:2])
    x, lengths = pl.request(np.random.default_rng(0), 3, seq_len=6)
    assert x.shape == (3, 6, pl.VOCAB) and lengths[0] == 6
    assert 1 <= lengths.min() and lengths.max() <= 6
    prompt = pl.one_hot(np.random.default_rng(1).integers(0, pl.VOCAB,
                                                          (2, 4)))
    outs, ins = pl.generate(net, prompt, 3)
    assert outs.shape == ins.shape == (2, 7, pl.VOCAB)
    assert len(pl.generate.step_ms) == 3
    np.testing.assert_array_equal(ins[:, 4:].argmax(-1),
                                  outs[:, 3:6].argmax(-1))
    np.testing.assert_allclose(outs, net.output(ins), rtol=1e-6, atol=1e-6)


def test_profile_lstm_retakes_windows_without_device_time():
    """A profiled window in which the tracer recorded no device time is
    taken again, up to ``PROFILE_ATTEMPTS`` windows, then the split gives
    up; on the CPU no window has device time. Every call of the profiled
    function is counted, so a caller can hold its launches exactly."""
    from deeplearning4j_tpu_torch.tools import profile_lstm as pl
    calls = []
    with pytest.raises(RuntimeError, match="no device time"):
        pl._profiled(lambda: calls.append(1), reps=2)
    assert len(calls) == pl.PROFILE_ATTEMPTS * (1 + 2)

