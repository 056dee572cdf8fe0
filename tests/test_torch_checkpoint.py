"""The port's ``TrainingCheckpointer`` (its own format: npz leaves, a JSON
meta file and an atomically written sha256 manifest) and the engines'
``warmup(checkpoint=)``, against the JAX package's checkpoint tests, on
the CPU.

Kill-and-resume is bit-exact: a restored run continues the exact example
sequence (iterator cursor), the updater state, the dropout generator and
the counters. Multi-rank cases run in rank subprocesses over gloo
(``multihost_sim.run_scenarios``); no process group is made in the
pytest worker. The JAX package's orbax directories need orbax, so its
weights come across through the ZIP: a JAX ``ParallelWrapper`` run saves
one, the port continues it under its own wrapper, held to the JAX
continuation at the JAX tests' tolerance (rtol 1e-4, atol 1e-5).
"""

import json
import os

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
from deeplearning4j_tpu.data.dataset import \
    NumpyDataSetIterator as JNumpyIt
from deeplearning4j_tpu.nn.config import InputType as JIT
from deeplearning4j_tpu.nn.config import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.nn.layers import core as jcore
from deeplearning4j_tpu.nn.model import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.nn import updaters as jupd
from deeplearning4j_tpu.parallel.data_parallel import \
    ParallelWrapper as JPW
from deeplearning4j_tpu.utils import serializer as jser
from deeplearning4j_tpu_torch.data.dataset import (AsyncDataSetIterator,
                                                   DataSet,
                                                   ListDataSetIterator,
                                                   NumpyDataSetIterator,
                                                   NumpyMultiDataSetIterator)
from deeplearning4j_tpu_torch.nn.config import (InputType,
                                                NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn.layers.attention import SelfAttentionLayer
from deeplearning4j_tpu_torch.nn.layers.core import DenseLayer, OutputLayer
from deeplearning4j_tpu_torch.nn.layers.core import DropoutLayer
from deeplearning4j_tpu_torch.nn.model import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.updaters import Adam
from deeplearning4j_tpu_torch.parallel import checkpoint as ckmod
from deeplearning4j_tpu_torch.parallel import multihost_sim as sim
from deeplearning4j_tpu_torch.parallel.checkpoint import (
    MANIFEST, CorruptCheckpoint, TrainingCheckpointer)
from deeplearning4j_tpu_torch.parallel.multihost_sim import _flat
from deeplearning4j_tpu_torch.serving.engine import (GenerativeEngine,
                                                     InferenceEngine,
                                                     PagedGenerativeEngine)


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        yield
    finally:
        torch.set_num_threads(old)


def _conf(seed=7, dropout=False):
    layers = [DenseLayer(n_out=8, activation="tanh")]
    if dropout:
        layers.append(DropoutLayer(rate=0.3))
    layers.append(OutputLayer(n_out=3))
    return (NeuralNetConfiguration.builder().seed(seed)
            .updater(Adam(learning_rate=0.01))
            .input_type(InputType.feed_forward(4)).list(*layers).build())


def _net(seed=7, dropout=False):
    return MultiLayerNetwork(_conf(seed, dropout)).init(device="cpu")


def _data(n=60, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 4)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, n)]
    return x, y


def _collect(it, k=None):
    out = []
    for ds in it:
        out.append(np.asarray(ds.features))
        if k is not None and len(out) == k:
            break
    return out


def _equal_trees(a, b):
    np.testing.assert_array_equal(_flat(a), _flat(b))


# ------------------------------------------------ restorable cursors
def test_numpy_iterator_mid_epoch_resume_matches_jax():
    x, y = _data()
    it = NumpyDataSetIterator(x, y, batch_size=8, shuffle=True, seed=5)
    first3 = _collect(it, 3)
    it2 = NumpyDataSetIterator(x, y, batch_size=8, shuffle=True, seed=5)
    it2.set_state(it.state())
    rest = _collect(it2)
    full = _collect(JNumpyIt(x, y, batch_size=8, shuffle=True, seed=5))
    assert len(first3) + len(rest) == len(full)
    for a, b in zip(first3 + rest, full):
        np.testing.assert_array_equal(a, b)


def test_numpy_iterator_epoch_boundary_and_seed_mismatch():
    x, y = _data()
    it = NumpyDataSetIterator(x, y, batch_size=10, shuffle=True, seed=9)
    _collect(it)
    e1 = _collect(it)
    it2 = NumpyDataSetIterator(x, y, batch_size=10, shuffle=True, seed=9)
    it2.set_state({"epoch": 1, "pos": 0, "seed": 9})
    for a, b in zip(_collect(it2), e1):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        NumpyDataSetIterator(x, y, batch_size=10, seed=1).set_state(
            {"epoch": 0, "pos": 0, "seed": 2})
    m = np.arange(40, dtype=np.float32).reshape(20, 2)
    st = NumpyMultiDataSetIterator([m], [m], batch_size=4, shuffle=True,
                                   seed=1).state()
    with pytest.raises(ValueError, match="seed"):
        NumpyMultiDataSetIterator([m], [m], batch_size=4, shuffle=True,
                                  seed=2).set_state(st)


def test_list_and_async_iterator_resume():
    x, y = _data(n=24)
    batches = [DataSet(x[i:i + 6], y[i:i + 6]) for i in range(0, 24, 6)]
    it = ListDataSetIterator(batches)
    _collect(it, 2)
    it2 = ListDataSetIterator(batches)
    it2.set_state(it.state())
    rest = _collect(it2)
    assert len(rest) == 2
    np.testing.assert_array_equal(rest[0], batches[2].features)
    x, y = _data()
    it = AsyncDataSetIterator(NumpyDataSetIterator(x, y, batch_size=6,
                                                   shuffle=True, seed=3),
                              queue_size=4)
    first2 = _collect(it, 2)
    st = it.state()
    assert st["consumed"] == 2
    it2 = AsyncDataSetIterator(NumpyDataSetIterator(x, y, batch_size=6,
                                                    shuffle=True, seed=3),
                               queue_size=4)
    it2.set_state(st)
    full = _collect(NumpyDataSetIterator(x, y, batch_size=6, shuffle=True,
                                         seed=3))
    for a, b in zip(first2 + _collect(it2), full):
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------- kill-and-resume
@pytest.mark.parametrize("async_save", [False, True])
def test_kill_and_resume_bitexact(tmp_path, async_save):
    """Uninterrupted 2 epochs == 1 epoch, checkpoint, a fresh model (other
    seed) restored, 1 more epoch: params, updater state, counters and the
    dropout stream bit for bit."""
    x, y = _data(n=80, seed=11)
    a = _net(dropout=True)
    a.fit(NumpyDataSetIterator(x, y, batch_size=16, shuffle=True, seed=21),
          epochs=2)
    b = _net(dropout=True)
    it_b = NumpyDataSetIterator(x, y, batch_size=16, shuffle=True, seed=21)
    b.fit(it_b, epochs=1)
    with TrainingCheckpointer(str(tmp_path / "ck"), max_to_keep=2,
                              async_save=async_save) as ck:
        ck.save(b, iterator=it_b)
        c = MultiLayerNetwork(_conf(99, dropout=True))
        it_c = NumpyDataSetIterator(x, y, batch_size=16, shuffle=True,
                                    seed=21)
        assert ck.restore(c, iterator=it_c, device="cpu") == b.iteration
        assert it_c.state() == it_b.state()
    c.fit(it_c, epochs=1)
    _equal_trees(a.params, c.params)
    _equal_trees(a.updater_state, c.updater_state)
    assert (c.iteration, c.epoch) == (a.iteration, a.epoch)


def test_restore_without_checkpoint_returns_none(tmp_path):
    with TrainingCheckpointer(str(tmp_path / "empty")) as ck:
        assert ck.restore(_net()) is None
        assert ck.latest_step() is None


def test_rotation_keeps_last_k(tmp_path):
    net = _net()
    x, y = _data(n=16)
    with TrainingCheckpointer(str(tmp_path / "rot"), max_to_keep=2) as ck:
        for _ in range(4):
            net.fit(DataSet(x, y))
            ck.save(net)
        assert ck.all_steps() == [3, 4] and ck.latest_step() == 4
        assert ck.verified_steps() == [4, 3]


def test_format_is_npz_json_and_manifest(tmp_path):
    """No pickle: npz leaves under their path keys, a JSON meta file, the
    manifest over both; a bfloat16 leaf travels as raw 16-bit words."""
    net = _net()
    net.state = {"9": {"bf": torch.arange(6, dtype=torch.bfloat16) / 7}}
    with TrainingCheckpointer(str(tmp_path / "f")) as ck:
        ck.save(net, step=5)
        d = ck._step_dir(5)
        names = sorted(os.listdir(d))
        assert names == sorted(["params.npz", "state.npz", "updater.npz",
                                "meta.json", MANIFEST])
        with np.load(os.path.join(d, "params.npz"),
                     allow_pickle=False) as z:
            assert set(z.files) == {"0/W", "0/b", "1/W", "1/b"}
        meta = json.load(open(os.path.join(d, "meta.json")))
        assert meta["format"] == ckmod.FORMAT and meta["step"] == 5
        back = _net(seed=3)
        ck.restore(back)
    assert back.state["9"]["bf"].dtype == torch.bfloat16
    assert torch.equal(back.state["9"]["bf"], net.state["9"]["bf"])
    _equal_trees(back.params, net.params)


def test_torn_newest_falls_back_and_all_torn_raises(tmp_path):
    net = _net()
    x, y = _data(n=16)
    with TrainingCheckpointer(str(tmp_path / "t"), max_to_keep=3) as ck:
        for _ in range(3):
            net.fit(DataSet(x, y))
            ck.save(net)
        p = os.path.join(ck._step_dir(3), "params.npz")
        with open(p, "r+b") as f:
            f.truncate(os.path.getsize(p) // 2)
        assert ck.scan_steps() == {"verified": [2, 1], "torn": [3],
                                   "unverified": []}
        back = _net(seed=5)
        assert ck.restore(back) == 2
        assert ck.restore_fallbacks == 1
        with pytest.raises(CorruptCheckpoint):
            ck.restore(back, step=3)
        with pytest.raises(ValueError, match="not found"):
            ck.restore(back, step=9)
        for s in (1, 2):
            with open(os.path.join(ck._step_dir(s), "meta.json"), "a") as f:
                f.write(" ")
        with pytest.raises(CorruptCheckpoint):
            ck.restore(back)


def test_single_writer_manifest(tmp_path, monkeypatch):
    net = _net()
    ck = TrainingCheckpointer(str(tmp_path / "ck"))
    monkeypatch.setattr(ckmod, "_primary_host", lambda: False)
    ck.save(net, step=1)
    assert ck._step_dir(1) is None  # rank > 0 writes nothing
    monkeypatch.setattr(ckmod, "_primary_host", lambda: True)
    ck.save(net, step=2)
    os.remove(os.path.join(ck._step_dir(2), MANIFEST))
    assert ck.verify(2) is None  # unverified, not corrupt
    ck.save(net, step=3)
    assert ck.verified_steps() == [3]
    assert ck.quiesce() == []
    ck.reopen()
    back = _net(seed=1)
    assert ck.restore(back) == 3
    ck.close()


def test_config_mismatch_and_wrong_class_refused(tmp_path):
    with TrainingCheckpointer(str(tmp_path / "c")) as ck:
        ck.save(_net(), step=1)
        other = MultiLayerNetwork(
            NeuralNetConfiguration.builder().seed(7)
            .updater(Adam(learning_rate=0.01))
            .input_type(InputType.feed_forward(4))
            .list(DenseLayer(n_out=9), OutputLayer(n_out=3)).build()
        ).init(device="cpu")
        with pytest.raises(ValueError, match="configuration"):
            ck.restore(other)


# ------------------------------------------ warmup(checkpoint=)
def _attn_net(seed):
    conf = (NeuralNetConfiguration.builder().seed(seed)
            .input_type(InputType.recurrent(16, 8))
            .list(SelfAttentionLayer(n_out=32, n_heads=4),
                  DenseLayer(n_out=32, activation="relu"),
                  OutputLayer(n_out=16, activation="softmax")).build())
    return MultiLayerNetwork(conf).init(device="cpu")


@pytest.mark.parametrize("engine", ["inference", "generative", "paged"])
def test_engine_warmup_restores_checkpoint(tmp_path, engine):
    src, dst = _attn_net(5), _attn_net(6)
    with TrainingCheckpointer(str(tmp_path / "e")) as ck:
        ck.save(src, step=0)
    x = np.eye(16, dtype=np.float32)[np.random.default_rng(1).integers(
        0, 16, (3, 8))]
    if engine == "inference":
        eng = InferenceEngine(dst, device="cpu").warmup(
            [4], checkpoint=str(tmp_path / "e"))
        np.testing.assert_array_equal(eng.output(x), src.output(x))
    elif engine == "generative":
        GenerativeEngine(dst, slots=2, device="cpu").warmup(
            [16], [8], checkpoint=str(tmp_path / "e"))
    else:
        PagedGenerativeEngine(dst, slots=2, pages=8, page_size=8,
                              max_cache_len=16, device="cpu").warmup(
            [16], [8], checkpoint=str(tmp_path / "e"))
    _equal_trees(dst.params, src.params)


# ------------------------------------------------------- across ranks
def _jconf():
    return (JConf.builder().seed(11).updater(jupd.Adam(learning_rate=1e-2))
            .input_type(JIT.feed_forward(8))
            .list(jcore.DenseLayer(n_out=16, activation="tanh"),
                  jcore.DenseLayer(n_out=16, activation="relu"),
                  jcore.OutputLayer(n_out=4)).build())


@pytest.fixture(scope="module")
def rank_runs(tmp_path_factory):
    """One 2-rank spawn: ZeRO-1 training saving (async) at steps 2 and 4
    with a ZIP at step 2, restores of a checkpoint saved under one
    ``shard_update`` setting under the other, and the continuation of a
    JAX ParallelWrapper ZIP; then one 1-rank spawn restoring the 2-rank
    checkpoint (2 -> 1 topology)."""
    root = tmp_path_factory.mktemp("ckpt")
    rng = np.random.default_rng(0)
    x = rng.normal(size=(64, 8)).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[rng.integers(0, 4, 64)]
    data = str(root / "data.npz")
    np.savez(data, x=x, y=y)
    jnet = JMLN(_jconf()).init()
    start = str(root / "start.zip")
    jser.save_model(jnet, start)
    JPW(jnet).fit(JDataSet(x, y), epochs=2)  # the JAX run to carry over
    carried = str(root / "carried.zip")
    jser.save_model(jnet, carried)
    JPW(jnet).fit(JDataSet(x, y), epochs=2)  # the JAX continuation
    ck = str(root / "ck")
    zip2 = str(root / "step2.zip")
    scs = [{"name": "train", "model": {"zip": start}, "batch": 16,
            "steps": [0, 1, 2, 3], "wrapper": {"shard_update": True,
                                              "overlap_grads": True},
            "checkpoint": {"dir": ck, "async": True, "save_at": [2, 4],
                           "zip_at": 2, "zip": zip2}}]
    for save in (True, False):
        d = str(root / f"su{int(save)}")
        scs.append({"name": f"save_su{int(save)}", "model": {"zip": start},
                    "batch": 64, "steps": [0, 0],
                    "wrapper": {"shard_update": save},
                    "checkpoint": {"dir": d, "save_at": [2]}})
        for restore in (True, False):
            scs.append({"name": f"rs{int(save)}{int(restore)}",
                        "model": {"zip": start}, "batch": 64, "steps": [0],
                        "restore": {"dir": d, "expect": 2},
                        "wrapper": {"shard_update": restore}})
    scs.append({"name": "carry", "model": {"zip": start}, "batch": 64,
                "steps": [0, 0], "restore": {"zip": carried},
                "wrapper": {"shard_update": True}})
    two = sim.run_scenarios({"data": data, "scenarios": scs},
                            str(root / "r2"), 2, timeout=240, nice=19)
    one = sim.run_scenarios({"data": data, "scenarios": [
        {"name": "resume", "model": {"zip": start}, "batch": 16,
         "steps": [2, 3], "restore": {"dir": ck, "step": 2, "expect": 2},
         "wrapper": {}},
        {"name": "from_zip", "model": {"zip": start}, "batch": 16,
         "steps": [2, 3], "restore": {"zip": zip2}, "wrapper": {}}]},
        str(root / "r1"), 1, timeout=240, nice=19)
    load = lambda d, n: dict(np.load(root / d / f"scn_{n}.npz"))  # noqa
    return {"two": [r["scenarios"] for r in two],
            "one": one[0]["scenarios"], "load": load, "ck": ck,
            "jax": jnet}


def test_async_saves_and_ranks_agree(rank_runs):
    rec = rank_runs["two"]
    assert rec[0]["train"]["digests"] == rec[1]["train"]["digests"]
    ck = TrainingCheckpointer(rank_runs["ck"])
    assert ck.verified_steps() == [4, 2]
    assert rec[0]["train"]["save_bytes"] > 0
    assert rec[1]["train"]["save_latency_s"] == []  # rank 1 writes nothing


@pytest.mark.parametrize("save", [True, False])
@pytest.mark.parametrize("restore", [True, False])
def test_checkpoint_roundtrip_across_shard_update(rank_runs, save, restore):
    """Saved under one ``shard_update`` setting, restored under either
    (at 2 ranks the two settings step bit for bit alike): the continued
    runs agree bit for bit."""
    rec = rank_runs["two"][0]
    a = rec[f"rs{int(save)}{int(restore)}"]
    b = rec[f"rs{int(save)}{int(not restore)}"]
    saved = rec[f"save_su{int(save)}"]
    assert a["start_digest"] == saved["digests"][-1]
    assert a["start_updater_digest"] == saved["updater_digest"]
    assert a["digests"] == b["digests"]
    assert a["updater_digest"] == b["updater_digest"]


def test_topology_change_restore_is_bitexact(rank_runs):
    """The 2-rank ZeRO-1 checkpoint at step 2 restores in one rank, and 2
    more steps equal, bit for bit, the same 2 steps from the step-2 state
    carried by a ZIP."""
    one = rank_runs["one"]
    assert one["resume"]["digests"] == one["from_zip"]["digests"]
    assert one["resume"]["updater_digest"] == \
        one["from_zip"]["updater_digest"]
    a, b = rank_runs["load"]("r1", "resume"), rank_runs["load"]("r1",
                                                                "from_zip")
    np.testing.assert_array_equal(a["params"], b["params"])


def test_jax_parallel_wrapper_zip_continues_under_the_port(rank_runs):
    got = rank_runs["load"]("r2", "carry")["params_flat"]
    np.testing.assert_allclose(got, rank_runs["jax"].params_flat(),
                               rtol=1e-4, atol=1e-5)


def test_async_iterator_epoch_boundary_and_abandon():
    """A cursor taken at an epoch boundary resumes at the NEXT epoch (not a
    replay of the finished one); breaking out mid-epoch loses none of the
    producer's prefetched batches."""
    x, y = _data(n=30)
    it = AsyncDataSetIterator(NumpyDataSetIterator(x, y, batch_size=10,
                                                   shuffle=True, seed=8))
    e0 = _collect(it)
    it2 = AsyncDataSetIterator(NumpyDataSetIterator(x, y, batch_size=10,
                                                    shuffle=True, seed=8))
    it2.set_state(it.state())
    e1 = _collect(it2)
    assert len(e1) == len(e0) == 3
    ref = NumpyDataSetIterator(x, y, batch_size=10, shuffle=True, seed=8)
    _collect(ref)
    for a, b in zip(e1, _collect(ref)):
        np.testing.assert_array_equal(a, b)
    x, y = _data(n=60)
    it = AsyncDataSetIterator(NumpyDataSetIterator(x, y, batch_size=6,
                                                   shuffle=True, seed=2),
                              queue_size=4)
    seen = []
    for ds in it:
        seen.append(np.asarray(ds.features))
        if len(seen) == 3:
            break
    seen += _collect(it)
    full = _collect(NumpyDataSetIterator(x, y, batch_size=6, shuffle=True,
                                         seed=2))
    assert len(seen) == len(full)
    for a, b in zip(seen, full):
        np.testing.assert_array_equal(a, b)
