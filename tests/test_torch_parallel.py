"""The port's data-parallel training (``deeplearning4j_tpu_torch.parallel``:
the launcher, meshes, placement, ``ParallelWrapper``, the bucketed and
overlapped gradient collectives, and the layers' and losses' global
reductions) against the JAX package, on the CPU.

The port runs one process per rank: every scenario below runs in rank
subprocesses joined by ``torch.distributed`` over gloo (``file://``
rendezvous under ``tmp_path``, one torch thread each), at 2 and at 4
ranks, through the port's own runner (``multihost_sim.run_scenarios``);
no process group is ever made in the pytest worker. Each scenario starts
from the JAX net's weights (its ZIP) on seeded numpy data. The JAX side
runs here, on the conftest's 8 virtual CPU devices: its single-device
``fit`` and its 8-device ``ParallelWrapper``.

Tolerances: JAX's own (``tests/test_parallel.py:49``): params rtol 1e-4,
atol 1e-5 against either JAX run; BatchNorm running statistics rtol 1e-5,
atol 1e-6; tensor parallelism against data parallelism rtol 2e-5, atol
2e-6. Between the port's own forms: at 2 ranks every gradient sum is one
``a + b``, so the replicated and the ZeRO-1 update, and overlap on and
off, agree BIT for bit; at 4 ranks a reduce-scatter and an all-reduce may
add in different orders, so replicated vs ZeRO-1 agree to atol 1e-6 (the
JAX test's bar) while overlap on and off, the same collectives in the
same order, stay bit for bit. Micro-accumulation reorders the sums:
atol 1e-5, as in JAX.
"""

import json
import os
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
from deeplearning4j_tpu.data.dataset import MultiDataSet as JMultiDataSet
from deeplearning4j_tpu.data.dataset import NumpyDataSetIterator as JNumpyIt
from deeplearning4j_tpu.nn.config import InputType as JIT
from deeplearning4j_tpu.nn.config import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.layers import conv as jconv
from deeplearning4j_tpu.nn.layers import core as jcore
from deeplearning4j_tpu.nn.model import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.nn import updaters as jupd
from deeplearning4j_tpu.nn.vertices import ElementWiseVertex as JEWV
from deeplearning4j_tpu.parallel import launcher as jlauncher
from deeplearning4j_tpu.parallel import overlap as jov
from deeplearning4j_tpu.parallel import placement as jpl
from deeplearning4j_tpu.parallel.data_parallel import \
    ParallelWrapper as JPW
from deeplearning4j_tpu.parallel.data_parallel import \
    make_dp_tp_mesh as jmake_dp_tp_mesh
from deeplearning4j_tpu.parallel.data_parallel import make_mesh as jmake_mesh
from deeplearning4j_tpu.utils import serializer as jser
from deeplearning4j_tpu_torch.data.dataset import (DataSet,
                                                   NumpyDataSetIterator)
from deeplearning4j_tpu_torch.nn import updaters as upd
from deeplearning4j_tpu_torch.parallel import collectives as coll
from deeplearning4j_tpu_torch.parallel import data_parallel as dp
from deeplearning4j_tpu_torch.parallel import launcher
from deeplearning4j_tpu_torch.parallel import multihost_sim as sim
from deeplearning4j_tpu_torch.parallel import overlap
from deeplearning4j_tpu_torch.parallel import placement
from deeplearning4j_tpu_torch.utils import serializer

RTOL, ATOL = 1e-4, 1e-5
RANKS = (2, 4)
#: the rank processes' niceness (they yield the cores to the suite)
NICE = 19
UPDATERS = {"adam": "Adam", "rmsprop": "RmsProp", "amsgrad": "AMSGrad",
            "nesterovs": "Nesterovs"}


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        yield
    finally:
        torch.set_num_threads(old)


# ------------------------------------------------------------ JAX confs
def _sgd_conf(seed=42, lr=0.01):
    return (JConf.builder().seed(seed).updater(jupd.Sgd(learning_rate=lr))
            .input_type(JIT.feed_forward(4))
            .list(jcore.DenseLayer(n_out=8, activation="tanh"),
                  jcore.OutputLayer(n_out=2)).build())


def _su_conf(updater="Adam", seed=11):
    u = getattr(jupd, updater)(learning_rate=1e-2)
    return (JConf.builder().seed(seed).updater(u)
            .input_type(JIT.feed_forward(8))
            .list(jcore.DenseLayer(n_out=16, activation="tanh"),
                  jcore.DenseLayer(n_out=16, activation="relu"),
                  jcore.OutputLayer(n_out=4)).build())


def _graph_conf(seed=12, sgd=False):
    u = jupd.Sgd(learning_rate=0.05) if sgd else jupd.Adam(learning_rate=1e-2)
    n_in = 4 if sgd else 8
    n_out = 2 if sgd else 4
    return (JConf.builder().seed(seed).updater(u).graph_builder()
            .add_inputs("in").set_input_types(JIT.feed_forward(n_in))
            .add_layer("d1", jcore.DenseLayer(n_out=8 if sgd else 16,
                                              activation="tanh"), "in")
            .add_layer("d2", jcore.DenseLayer(n_out=8 if sgd else 16,
                                              activation="tanh"), "d1")
            .add_vertex("res", JEWV(op="add"), "d1", "d2")
            .add_layer("out", jcore.OutputLayer(n_out=n_out), "res")
            .set_outputs("out").build())


def _two_out_conf():
    return (JConf.builder().seed(5).updater(jupd.Adam(learning_rate=1e-2))
            .graph_builder().add_inputs("in")
            .set_input_types(JIT.feed_forward(8))
            .add_layer("d1", jcore.DenseLayer(n_out=16, activation="tanh"),
                       "in")
            .add_layer("outA", jcore.OutputLayer(n_out=4), "d1")
            .add_layer("outB", jcore.OutputLayer(n_out=4), "d1")
            .set_outputs("outA", "outB").build())


def _fm_conf():
    return (JConf.builder().seed(4).updater(jupd.Sgd(learning_rate=0.05))
            .input_type(JIT.recurrent(3, 5))
            .list(jcore.DenseLayer(n_out=6, activation="tanh"),
                  jconv.GlobalPoolingLayer(pool_type="avg"),
                  jcore.OutputLayer(n_out=2)).build())


def _bn_conf():
    return (JConf.builder().seed(3).updater(jupd.Sgd(learning_rate=0.1))
            .input_type(JIT.convolutional(3, 8, 8, data_format="NHWC"))
            .list(jconv.ConvolutionLayer(n_out=4, kernel=(3, 3), mode="same",
                                         data_format="NHWC"),
                  jconv.BatchNormalization(data_format="NHWC"),
                  jcore.OutputLayer(n_out=2)).build())


def _tp_conf():
    return (JConf.builder().seed(9).updater(jupd.Adam(learning_rate=1e-2))
            .input_type(JIT.feed_forward(6))
            .list(jcore.DenseLayer(n_out=16, activation="tanh"),
                  jcore.DenseLayer(n_out=8, activation="relu"),
                  jcore.OutputLayer(n_out=4)).build())


def _mh_conf(adam=False):
    u = jupd.Adam(learning_rate=1e-2) if adam else jupd.Sgd(learning_rate=0.1)
    return (JConf.builder().seed(0).updater(u)
            .input_type(JIT.feed_forward(6))
            .list(jcore.DenseLayer(n_out=16, activation="tanh"),
                  jcore.OutputLayer(n_out=3)).build())


# ------------------------------------------------------------------ data
def _cls(n, nin, nout, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, nin)).astype(np.float32)
    y = np.eye(nout, dtype=np.float32)[rng.integers(0, nout, n)]
    return x, y


def _sign_data(n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 4)).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[(x.sum(1) > 0).astype(int)]
    return x, y


def _data_arrays():
    d = {}
    d["s64_x"], d["s64_y"] = _sign_data(64)
    d["s37_x"], d["s37_y"] = _sign_data(37)
    d["s256_x"], d["s256_y"] = _sign_data(256, seed=3)
    d["c64_x"], d["c64_y"] = _cls(64, 8, 4)
    _, d["c64_yb"] = _cls(64, 8, 4, seed=1)
    d["maskA"] = np.zeros((64,), np.float32)
    d["c16_x"], d["c16_y"] = _cls(16, 6, 4)
    d["m64_x"], d["m64_y"] = _cls(64, 6, 3)
    rng = np.random.default_rng(8)
    d["fm_x"] = rng.normal(size=(37, 5, 3)).astype(np.float32)
    fm = (rng.random((37, 5)) > 0.3).astype(np.float32)
    fm[:, 0] = 1.0
    d["fm_fm"] = fm
    d["fm_y"] = np.eye(2, dtype=np.float32)[rng.integers(0, 2, 37)]
    rng = np.random.default_rng(0)
    d["bn_x"] = rng.normal(size=(5, 8, 8, 3)).astype(np.float32)
    d["bn_y"] = np.eye(2, dtype=np.float32)[rng.integers(0, 2, 5)]
    return d


# --------------------------------------------------------- the scenarios
def _scn(name, model, x, y, wrapper=None, batch=None, steps=None, **kw):
    sc = {"name": name, "model": {"zip": model}, "x": x, "y": y,
          "wrapper": wrapper}
    if batch is not None:
        sc["batch"] = batch
    if steps is not None:
        sc["steps"] = steps
    sc.update(kw)
    return sc


def _scenarios(z):
    """z: conf name -> ZIP path."""
    S = []
    S.append(_scn("sgd_dp", z["sgd"], "s64_x", "s64_y", {}, 64, [0, 0, 0]))
    S.append(_scn("sgd_conv", z["sgd_conv"], "s256_x", "s256_y", {}, 32,
                  list(range(8)) * 20, ranks=[2]))
    S.append(_scn("ragged37", z["sgd"], "s37_x", "s37_y", {}, 37, [0]))
    S.append(_scn("graph_ragged", z["graph_sgd"], "s37_x", "s37_y", {}, 37,
                  [0, 0, 0]))
    S.append(_scn("fm_ragged", z["fm"], "fm_x", "fm_y", {}, 37, [0],
                  fm="fm_fm"))
    S.append(_scn("bn_ragged", z["bn"], "bn_x", "bn_y", {}, 5, [0]))
    S.append(_scn("tp", z["tp"], "c16_x", "c16_y",
                  {"mesh": "TP", "model_axis": "model"}, 16, [0, 0]))
    S.append(_scn("tp_dp", z["tp"], "c16_x", "c16_y", {}, 16, [0, 0]))
    for u in UPDATERS:
        S.append(_scn(f"su_repl_{u}", z[f"su_{u}"], "c64_x", "c64_y", {},
                      64, [0] * 5))
        S.append(_scn(f"su_shard_{u}", z[f"su_{u}"], "c64_x", "c64_y",
                      {"shard_update": True}, 64, [0] * 5))
    S.append(_scn("g_repl", z["graph"], "c64_x", "c64_y", {}, 64, [0] * 5))
    S.append(_scn("g_shard", z["graph"], "c64_x", "c64_y",
                  {"shard_update": True}, 64, [0] * 5))
    for g in ("", "g_"):
        m = z["graph" if g else "su_adam"]
        S.append(_scn(f"{g}tp_repl", m, "c64_x", "c64_y",
                      {"mesh": "TP", "model_axis": "model"}, 64, [0] * 3))
        S.append(_scn(f"{g}tp_shard", m, "c64_x", "c64_y",
                      {"mesh": "TP", "model_axis": "model",
                       "shard_update": True}, 64, [0] * 3))
    S.append(_scn("acc_repl", z["su_adam"], "c64_x", "c64_y", {}, 64, [0, 0]))
    S.append(_scn("acc4", z["su_adam"], "c64_x", "c64_y",
                  {"accum_steps": 4}, 64, [0, 0]))
    S.append(_scn("acc4_shard", z["su_adam"], "c64_x", "c64_y",
                  {"accum_steps": 4, "shard_update": True}, 64, [0, 0]))
    S.append(_scn("g_acc_repl", z["graph"], "c64_x", "c64_y", {}, 64,
                  [0, 0]))
    S.append(_scn("g_acc4", z["graph"], "c64_x", "c64_y",
                  {"accum_steps": 4}, 64, [0, 0]))
    S.append(_scn("acc2_r50", z["su_adam"], "c64_x", "c64_y",
                  {"accum_steps": 2}, 50, [0], rows=50))
    S.append(_scn("acc4_r9", z["su_adam"], "c64_x", "c64_y",
                  {"accum_steps": 4}, 9, [0], rows=9))
    S.append(_scn("g_acc4_r9", z["graph"], "c64_x", "c64_y",
                  {"accum_steps": 4, "shard_update": True}, 9, [0], rows=9))
    S.append(_scn("two_out", z["two_out"], "c64_x", "c64_y", {}, 32,
                  [0, 0], rows=32, ys=["c64_y", "c64_yb"],
                  lms=["maskA", None]))
    S.append(_scn("two_out_acc4", z["two_out"], "c64_x", "c64_y",
                  {"accum_steps": 4}, 32, [0, 0], rows=32,
                  ys=["c64_y", "c64_yb"], lms=["maskA", None]))
    for acc in (1, 2):
        for ov in (False, True):
            S.append(_scn(f"ov{int(ov)}_acc{acc}", z["su_adam"], "c64_x",
                          "c64_y", {"shard_update": True, "accum_steps": acc,
                                    "overlap_grads": ov,
                                    "overlap_bucket_mb": 0.001},
                          64, [0] * 3))
    for ov in (False, True):
        S.append(_scn(f"ov{int(ov)}_tp", z["su_adam"], "c64_x", "c64_y",
                      {"mesh": "TP", "model_axis": "model",
                       "shard_update": True, "overlap_grads": ov,
                       "overlap_bucket_mb": 0.001}, 64, [0, 0]))
    S.append(_scn("mh_sgd", z["mh_sgd"], "m64_x", "m64_y", {},
                  iterate={"batch": 16, "shuffle": True, "seed": 4,
                           "epochs": 2, "host_sharded": True}))
    for rep in ("a", "b"):
        S.append(_scn(f"mh_det_{rep}", z["mh_adam"], "m64_x", "m64_y",
                      {"mesh": "pod", "shard_update": True,
                       "overlap_grads": True},
                      iterate={"batch": 16, "shuffle": True, "seed": 4,
                               "epochs": 2, "host_sharded": True}))
    for rep in ("a", "b"):
        S.append(_scn(f"hier_{rep}", z["su_adam"], "c64_x", "c64_y",
                      {"mesh": "pod", "pod": {"hosts": 2},
                       "shard_update": True, "overlap_grads": True,
                       "dcn_hosts": 2}, 64, [0, 0], ranks=[4]))
    S.append(_scn("flat_ov", z["su_adam"], "c64_x", "c64_y",
                  {"mesh": "pod", "shard_update": True,
                   "overlap_grads": True}, 64, [0, 0], ranks=[4]))
    S.append(_scn("pod_tp", z["su_adam"], "c64_x", "c64_y",
                  {"mesh": "pod", "pod": {"model": 2, "hosts": 2},
                   "model_axis": "model"}, 64, [0], ranks=[4]))
    return S


def _tp_dims(n):
    return [n // 2, 2]


def _jax_nets():
    """conf name -> JAX conf factory."""
    c = {"sgd": _sgd_conf, "sgd_conv": lambda: _sgd_conf(lr=0.1),
         "graph_sgd": lambda: _graph_conf(seed=9, sgd=True),
         "fm": _fm_conf, "bn": _bn_conf, "tp": _tp_conf,
         "graph": _graph_conf, "two_out": _two_out_conf,
         "mh_sgd": _mh_conf, "mh_adam": lambda: _mh_conf(adam=True)}
    for u, cls in UPDATERS.items():
        c[f"su_{u}"] = (lambda cls=cls: _su_conf(cls))
    return c


def _jnet(factory):
    conf = factory()
    return (JGraph if hasattr(conf, "vertices") else JMLN)(conf).init()


def _jax_refs(D):
    """The JAX package's runs the port is held to."""
    f = _jax_nets()
    R = {}

    def single(name, conf, data, epochs=1):
        net = _jnet(f[conf])
        net.fit(data, epochs=epochs)
        R[name] = net
        return net

    def pw(name, conf, data, epochs=1, **kw):
        net = _jnet(f[conf])
        JPW(net, **kw).fit(data, epochs=epochs)
        R[name] = net
        return net

    s64 = JDataSet(D["s64_x"], D["s64_y"])
    single("sgd_single", "sgd", s64, 3)
    pw("sgd_pw", "sgd", s64, 3)
    single("ragged37", "sgd", JDataSet(D["s37_x"], D["s37_y"]))
    single("graph_ragged", "graph_sgd", JDataSet(D["s37_x"], D["s37_y"]), 3)
    single("fm_ragged", "fm", JDataSet(D["fm_x"], D["fm_y"],
                                       features_mask=D["fm_fm"]))
    single("bn_ragged", "bn", JDataSet(D["bn_x"], D["bn_y"]))
    c16 = JDataSet(D["c16_x"], D["c16_y"])
    pw("tp_dp", "tp", c16, 2, mesh=jmake_mesh())
    c64 = JDataSet(D["c64_x"], D["c64_y"])
    for u in UPDATERS:
        pw(f"su_{u}", f"su_{u}", c64, 5)
    pw("g_su", "graph", c64, 5)
    pw("tp_su", "su_adam", c64, 3, mesh=jmake_dp_tp_mesh(2, 4),
       model_axis="model")
    pw("g_tp_su", "graph", c64, 3, mesh=jmake_dp_tp_mesh(2, 4),
       model_axis="model")
    pw("acc", "su_adam", c64, 2)
    pw("g_acc", "graph", c64, 2)
    single("r9", "su_adam", JDataSet(D["c64_x"][:9], D["c64_y"][:9]))
    single("g_r9", "graph", JDataSet(D["c64_x"][:9], D["c64_y"][:9]))
    mds = JMultiDataSet([D["c64_x"][:32]],
                        [D["c64_y"][:32], D["c64_yb"][:32]],
                        labels_masks=[D["maskA"][:32], None])
    pw("two_out", "two_out", mds, 2)
    for conf in ("mh_sgd", "mh_adam"):
        net = _jnet(f[conf])
        it = JNumpyIt(D["m64_x"], D["m64_y"], batch_size=16, shuffle=True,
                      seed=4)
        net.fit(it, epochs=2)
        R[conf] = net
    return R


def _write_jax_refs(data, out):
    """The JAX runs of :func:`_jax_refs` on the arrays in ``data``, saved
    under ``out`` as ZIPs with their scores beside them (run in a
    subprocess by the ``runs`` fixture)."""
    refs = _jax_refs(dict(np.load(data)))
    for name, net in refs.items():
        jser.save_model(net, os.path.join(out, f"ref_{name}.zip"))
    with open(os.path.join(out, "ref_scores.json"), "w") as f:
        json.dump({k: float(v.score()) for k, v in refs.items()}, f)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("parallel")
    D = _data_arrays()
    data = str(root / "data.npz")
    np.savez(data, **D)
    zips = {}
    for name, factory in _jax_nets().items():
        zips[name] = str(root / f"{name}.zip")
        jser.save_model(_jnet(factory), zips[name])
    # the JAX side and the spawns run at low priority, the JAX side in its
    # own process (on the conftest's 8 virtual devices, which the
    # environment carries) beside the first spawn: the suite's
    # latency-sensitive tests share the cores
    here = os.path.dirname(os.path.abspath(__file__))
    jax_side = subprocess.Popen(
        ["nice", "-n", str(NICE), sys.executable, "-c",
         f"import sys; sys.path[:0] = [{here!r}, {os.path.dirname(here)!r}]"
         f"; import test_torch_parallel as t; "
         f"t._write_jax_refs({data!r}, {str(root)!r})"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    out = {"zips": zips, "data": D, "results": {}, "flat": {}}
    try:
        for n in RANKS:
            scs = _scenarios(zips)
            for sc in scs:
                if sc.get("wrapper") and sc["wrapper"].get("mesh") == "TP":
                    sc["wrapper"]["mesh"] = _tp_dims(n)
            res = sim.run_scenarios(
                {"data": data, "scenarios": scs}, str(root / f"r{n}"), n,
                timeout=240, nice=NICE)
            out["results"][n] = [r["scenarios"] for r in res]
            out["flat"][n] = {
                name: dict(np.load(root / f"r{n}" / f"scn_{name}.npz"))
                for name in res[0]["scenarios"]}
        log = jax_side.communicate(timeout=240)[0]
    finally:
        jax_side.kill()
    assert jax_side.returncode == 0, log.decode()[-4000:]
    with open(root / "ref_scores.json") as f:
        out["ref_scores"] = json.load(f)
    out["refs"] = {name: jser.load_model(str(root / f"ref_{name}.zip"))
                   for name in out["ref_scores"]}
    out["smoke"] = sim.run_smoke(str(root / "smoke"), nice=NICE)["losses"]
    return out


def _port(runs, n, name):
    return runs["flat"][n][name]


def _rec(runs, n, name, rank=0):
    return runs["results"][n][rank][name]


def _close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), rtol=rtol,
                               atol=atol)


def _jflat(tree):
    return np.concatenate([np.asarray(a, np.float64).ravel()
                           for a in jax.tree.leaves(tree)])


def _same_bits(runs, n, a, b):
    ra, rb = _rec(runs, n, a), _rec(runs, n, b)
    assert ra["digests"] == rb["digests"], (a, b)
    assert ra["updater_digest"] == rb["updater_digest"], (a, b)


# ================================================= tests/test_parallel.py
@pytest.mark.parametrize("n", RANKS)
def test_every_rank_ends_every_step_with_the_same_bits(runs, n):
    """Replicas run in the same step: the params and layer state of every
    rank after every call are bit-identical, in every scenario."""
    per_rank = runs["results"][n]
    for name, rec in per_rank[0].items():
        for other in per_rank[1:]:
            assert other[name]["digests"] == rec["digests"], name


@pytest.mark.parametrize("n", RANKS)
def test_mesh_covers_every_rank(runs, n):
    assert _rec(runs, n, "sgd_dp")["mesh_shape"] == {"data": n}
    assert _rec(runs, n, "tp")["mesh_shape"] == {"data": n // 2, "model": 2}
    assert dp.make_mesh().size == 1  # no process group here: one rank


@pytest.mark.parametrize("n", RANKS)
def test_dp_step_matches_single_device(runs, n):
    got = _port(runs, n, "sgd_dp")["params_flat"]
    _close(got, runs["refs"]["sgd_single"].params_flat())
    _close(got, runs["refs"]["sgd_pw"].params_flat())
    assert _rec(runs, n, "sgd_dp")["losses"][-1] == pytest.approx(
        runs["ref_scores"]["sgd_single"], rel=1e-3)


def test_dp_convergence(runs):
    net = serializer.load_model(runs["zips"]["sgd_conv"], device="cpu")
    net.set_params_flat(_port(runs, 2, "sgd_conv")["params_flat"])
    D = runs["data"]
    acc = net.evaluate(NumpyDataSetIterator(D["s256_x"], D["s256_y"],
                                            batch_size=64)).accuracy()
    assert acc > 0.9


@pytest.mark.parametrize("n", RANKS)
@pytest.mark.parametrize("case", ["ragged37", "graph_ragged", "fm_ragged"])
def test_dp_pads_ragged_tail(runs, n, case):
    """A batch the data axis does not divide is padded and masked and
    makes the same update as the unpadded single-device fit (the feature
    mask's synthesized pad rows intersect a propagated sequence mask)."""
    assert _rec(runs, n, case)["iteration"] >= 1
    _close(_port(runs, n, case)["params_flat"],
           runs["refs"][case].params_flat())


@pytest.mark.parametrize("n", RANKS)
def test_ragged_tail_bn_stats_match_unpadded_step(runs, n):
    """5 rows over 2 or 4 ranks (at 4, one rank holds only padding): the
    global BatchNorm moments, with the count clamped after the
    all-reduce, give the unpadded single-device step's running statistics
    and params."""
    got, ref = _port(runs, n, "bn_ragged"), runs["refs"]["bn_ragged"]
    _close(got["state"], _jflat(ref.state), rtol=1e-5, atol=1e-6)
    _close(got["params_flat"], ref.params_flat())


@pytest.mark.parametrize("n", RANKS)
def test_tensor_parallel_dense_matches_data_parallel_only(runs, n):
    got = _port(runs, n, "tp")["params_flat"]
    _close(got, _port(runs, n, "tp_dp")["params_flat"], 2e-5, 2e-6)
    _close(got, runs["refs"]["tp_dp"].params_flat(), 2e-5, 2e-6)


# ============================================== tests/test_shard_update.py
@pytest.mark.parametrize("n", RANKS)
@pytest.mark.parametrize("u", list(UPDATERS))
def test_shard_update_matches_replicated_mln(runs, n, u):
    a, b = f"su_shard_{u}", f"su_repl_{u}"
    if n == 2:
        _same_bits(runs, n, a, b)
    pa, pb = _port(runs, n, a), _port(runs, n, b)
    _close(pa["params"], pb["params"], 0, 1e-6)
    _close(pa["updater"], pb["updater"], 0, 1e-6)
    ref = runs["refs"][f"su_{u}"]
    _close(pa["params_flat"], ref.params_flat())
    _close(pa["updater"], _jflat(ref.updater_state))


@pytest.mark.parametrize("n", RANKS)
def test_shard_update_matches_replicated_graph(runs, n):
    if n == 2:
        _same_bits(runs, n, "g_shard", "g_repl")
    pa, pb = _port(runs, n, "g_shard"), _port(runs, n, "g_repl")
    _close(pa["params"], pb["params"], 0, 1e-6)
    _close(pa["params_flat"], runs["refs"]["g_su"].params_flat())
    _close(pa["updater"], _jflat(runs["refs"]["g_su"].updater_state))


@pytest.mark.parametrize("n", RANKS)
@pytest.mark.parametrize("g", ["", "g_"])
def test_shard_update_composes_with_tensor_parallelism(runs, n, g):
    pa, pb = _port(runs, n, f"{g}tp_shard"), _port(runs, n, f"{g}tp_repl")
    _close(pa["params"], pb["params"], 0, 1e-6)
    _close(pa["updater"], pb["updater"], 0, 1e-6)
    ref = runs["refs"][f"{g}tp_su"]
    _close(pa["params_flat"], ref.params_flat())
    c = _rec(runs, n, f"{g}tp_shard")["counters"]
    assert c["calls"]["all_gather"] > 0  # the column gathers ran


@pytest.mark.parametrize("n", RANKS)
def test_updater_state_is_sharded_between_steps(runs, n):
    """Each rank holds 1/n of the Adam state (every leaf of this net has a
    dimension n divides), kept in the model between fit calls (a read of
    the trees gathers the full values: the updater digests above); the
    replicated run holds no shares, tensor parallelism holds its own."""
    shard = _rec(runs, n, "su_shard_adam")["counters"]
    repl = _rec(runs, n, "su_repl_adam")["counters"]
    assert shard["updater_state_bytes_per_rank"] * n == \
        repl["updater_state_bytes_per_rank"]
    assert shard["calls"]["reduce_scatter"] == 5  # one bucket a step
    assert repl["calls"]["reduce_scatter"] == 0
    assert shard["backend"] == repl["backend"] == "gloo"
    assert _rec(runs, n, "su_shard_adam")["held"] == [True] * 5
    assert _rec(runs, n, "su_repl_adam")["held"] == [False] * 5
    assert _rec(runs, n, "tp_repl")["held"] == [True] * 3


def _port_net(runs, name):
    return serializer.load_model(runs["zips"][name], device="cpu")


def test_shard_update_rejects_non_elementwise_updater(runs):
    net = _port_net(runs, "su_adam")
    net.conf.updater.elementwise = False
    try:
        with pytest.raises(ValueError, match="elementwise"):
            dp.ParallelWrapper(net, shard_update=True)
    finally:
        net.conf.updater.elementwise = True


@pytest.mark.parametrize("u", list(UPDATERS))
def test_apply_leaf_shard_equals_full_update(u):
    """The property ZeRO-1 rests on: the port's updater on a 1/N slice of
    (grad, state, param) is exactly that slice of the full update."""
    updater = getattr(upd, UPDATERS[u])(learning_rate=1e-2)
    rng = np.random.default_rng(7)
    t = lambda a: torch.as_tensor(a.astype(np.float32))  # noqa: E731
    p, g = t(rng.normal(size=(16, 8))), t(rng.normal(size=(16, 8)))
    slots = {k: t(rng.normal(size=(16, 8)) ** 2)
             for k in updater.init_state(p)}
    p_full, s_full = upd.apply_leaf(updater, g, slots, p, 3)
    for dim in (0, 1):
        half = {k: v.chunk(2, dim)[1] for k, v in slots.items()}
        p_half, s_half = upd.apply_leaf(updater, g.chunk(2, dim)[1], half,
                                        p.chunk(2, dim)[1], 3)
        assert torch.equal(p_half, p_full.chunk(2, dim)[1])
        for k in s_full:
            assert torch.equal(s_half[k], s_full[k].chunk(2, dim)[1])


@pytest.mark.parametrize("n", RANKS)
@pytest.mark.parametrize("case,ref", [
    ("acc4", "acc_repl"), ("acc4_shard", "acc_repl"),
    ("g_acc4", "g_acc_repl")])
def test_accum_steps_matches_full_batch(runs, n, case, ref):
    assert _rec(runs, n, case)["iteration"] == 2  # one update a batch
    a, b = _port(runs, n, case), _port(runs, n, ref)
    _close(a["params"], b["params"], 0, 1e-5)
    _close(a["updater"], b["updater"], 0, 1e-5)
    jref = runs["refs"]["g_acc" if case.startswith("g_") else "acc"]
    _close(a["params_flat"], jref.params_flat())


@pytest.mark.parametrize("n", RANKS)
def test_accum_pads_ragged_tail_to_microbatch_granularity(runs, n):
    assert _rec(runs, n, "acc2_r50")["iteration"] == 1


@pytest.mark.parametrize("n", RANKS)
@pytest.mark.parametrize("case,ref", [("acc4_r9", "r9"),
                                      ("g_acc4_r9", "g_r9")])
def test_accum_ragged_tail_matches_unpadded_step(runs, n, case, ref):
    """9 rows padded to 4n microbatch rows (whole microbatches of padding
    on some ranks): the globally weighted mean reproduces the unpadded
    single-device step."""
    a, jref = _port(runs, n, case), runs["refs"][ref]
    _close(a["params_flat"], jref.params_flat(), 0, 1e-5)
    _close(a["updater"], _jflat(jref.updater_state), 0, 1e-5)


@pytest.mark.parametrize("n", RANKS)
def test_accum_multi_output_fully_masked_output_not_dropped(runs, n):
    init = _port_net(runs, "two_out").params["outB"]["W"].numpy()
    a = _port(runs, n, "two_out_acc4")
    net = _port_net(runs, "two_out")
    net.set_params_flat(a["params_flat"])
    assert not np.allclose(net.params["outB"]["W"].numpy(), init)
    _close(a["params"], _port(runs, n, "two_out")["params"], 0, 1e-5)
    _close(a["params_flat"], runs["refs"]["two_out"].params_flat())


def test_accum_factory_direct_and_indivisible_batch(runs):
    """The engine's own step honours accum_steps (no wrapper), and refuses
    a batch it does not divide."""
    D = runs["data"]
    x, y = torch.as_tensor(D["c64_x"][:32]), torch.as_tensor(D["c64_y"][:32])
    a, b = _port_net(runs, "su_adam"), _port_net(runs, "su_adam")
    la = a._build_train_step()(x, y, None, None)
    lb = b._build_train_step(accum_steps=4)(x, y, None, None)
    assert float(la) == pytest.approx(float(lb), abs=1e-6)
    _close(a.params_flat(), b.params_flat(), 0, 1e-6)
    with pytest.raises(ValueError, match="accum_steps"):
        b._build_train_step(accum_steps=4)(x[:30], y[:30], None, None)


@pytest.mark.parametrize("conf", ["su_adam", "graph", "tp", "bn"])
def test_update_spec_matches_jax(runs, conf):
    """``_update_spec`` and ``_param_spec`` pick the JAX package's
    dimension for every leaf, on 1-D and 2-D meshes (the port's meshes
    are made here over virtual ranks: no process group)."""
    jnet = _jnet(_jax_nets()[conf])
    net = _port_net(runs, conf)
    for (d, m) in ((8, 1), (4, 2), (2, 4)):
        jmesh = jmake_mesh() if m == 1 else jmake_dp_tp_mesh(d, m)
        pmesh = dp.make_mesh(range(8)) if m == 1 else \
            dp.make_dp_tp_mesh(d, m, range(8))
        axis = None if m == 1 else "model"
        jw = JPW(jnet, jmesh, model_axis=axis, shard_update=True)
        pw = dp.ParallelWrapper(net, pmesh, model_axis=axis,
                                shard_update=True)
        for (path, leaf) in placement.flatten_paths(net.params):
            jleaf = jnet.params[path[0]][path[1]]
            want_p = tuple(jw._param_spec(path, jleaf))
            if "model" in want_p and leaf.shape[want_p.index("model")] % m:
                # the recorded divergence: GSPMD pads an uneven model-axis
                # shard, the port replicates the leaf
                assert pw._param_spec(path, leaf) == ()
                continue
            assert pw._update_spec(path, leaf) == tuple(
                jw._update_spec(path, jleaf)), (conf, d, m, path)
            assert pw._param_spec(path, leaf) == want_p, (conf, d, m, path)


# ======================================= tests/test_autotune_overlap.py
@pytest.mark.parametrize("conf,cap", [("su_adam", 600), ("graph", 600),
                                      ("su_adam", 1), ("graph", 1 << 30),
                                      ("tp", 300)])
def test_make_buckets_matches_jax(runs, conf, cap):
    """The same buckets in the same order as JAX for the same tree; every
    leaf in exactly one; the output layer first."""
    jnet, net = _jnet(_jax_nets()[conf]), _port_net(runs, conf)
    got = overlap.make_buckets(net.params, cap)
    want = jov.make_buckets(jnet.params, cap)
    assert [list(map(tuple, b)) for b in got] == \
        [list(map(tuple, b)) for b in want]
    leaf_paths = {p for p, _ in placement.flatten_paths(net.params)}
    flat = [p for b in got for p in b]
    assert set(flat) == leaf_paths and len(flat) == len(leaf_paths)
    with pytest.raises(ValueError, match="positive"):
        overlap.make_buckets(net.params, 0)


def test_overlap_requires_shard_update_and_set_overlap(runs):
    net = _port_net(runs, "su_adam")
    with pytest.raises(ValueError, match="shard_update"):
        dp.ParallelWrapper(net, overlap_grads=True)
    pw = dp.ParallelWrapper(net, shard_update=True)
    pw.fit(DataSet(*_cls(16, 8, 4)))
    assert pw._step is not None
    pw.set_overlap(True, bucket_mb=0.001)
    assert pw._step is None and pw.overlap_grads
    pw.fit(DataSet(*_cls(16, 8, 4)))
    assert pw.counters()["buckets"] >= 1
    pw.set_overlap(True)
    assert pw._step is not None  # no change keeps the step
    pw.set_accum_steps(1)
    assert pw._step is not None
    pw.set_accum_steps(2)
    assert pw._step is None and pw.accum_steps == 2
    with pytest.raises(ValueError, match="accum_steps"):
        pw.set_accum_steps(0)
    with pytest.raises(ValueError, match="shard_update"):
        dp.ParallelWrapper(net).set_overlap(True)


@pytest.mark.parametrize("n", RANKS)
@pytest.mark.parametrize("acc", [1, 2])
def test_overlap_bit_equivalence(runs, n, acc):
    _same_bits(runs, n, f"ov1_acc{acc}", f"ov0_acc{acc}")
    c = _rec(runs, n, f"ov1_acc{acc}")["counters"]
    assert c["buckets"] > 1


class _Refusing:
    """A ``torch.distributed`` whose every op refuses the operands."""

    def __getattr__(self, op):
        def refuse(*args, **kwargs):
            raise RuntimeError(f"{op}: no support for these tensors")
        return refuse


@pytest.mark.parametrize("op", coll.OPS)
def test_refused_collective_raises_naming_backend_and_device(monkeypatch,
                                                             op):
    """An op the backend does not run on the operands' device raises,
    naming the op, the backend and the device; nothing is staged."""
    comm = coll.Comm(None, "cpu")
    comm.size, comm.backend = 2, "gloo"
    monkeypatch.setattr(coll, "_dist", lambda: _Refusing())
    t = torch.ones(4)
    call = {"all_reduce": lambda: comm.all_reduce(t),
            "reduce_scatter": lambda: comm.reduce_scatter(torch.empty(2), t),
            "all_gather": lambda: comm.all_gather(torch.empty(8), t),
            "broadcast": lambda: comm.broadcast(t)}[op]
    with pytest.raises(RuntimeError,
                       match=f"{op} on backend gloo with cpu tensors"):
        call()
    assert comm.counters.calls[op] == 1


@pytest.mark.parametrize("n", RANKS)
def test_overlap_bit_equivalence_with_model_axis(runs, n):
    _same_bits(runs, n, "ov1_tp", "ov0_tp")


# ==================== tests/test_multihost.py, test_multihost_pod.py:452
def test_two_process_data_parallel(runs):
    """Two ranks read their halves of the same shuffled stream through a
    HostShardedIterator; replicas bit-identical, equal to one device."""
    for n in RANKS:
        rec = runs["results"][n]
        assert all(r["mh_sgd"]["digests"] == rec[0]["mh_sgd"]["digests"]
                   for r in rec)
        _close(_port(runs, n, "mh_sgd")["params_flat"],
               runs["refs"]["mh_sgd"].params_flat(), 2e-5, 1e-6)


def test_zero1_overlap_cross_process_determinism(runs):
    """ZeRO-1 + overlap on a pod mesh: bit-equal across repeated runs of a
    fixed topology, and equal to one device within the JAX test's bound
    (gloo sums in another order)."""
    for n in RANKS:
        _same_bits(runs, n, "mh_det_a", "mh_det_b")
        _close(_port(runs, n, "mh_det_a")["params_flat"],
               runs["refs"]["mh_adam"].params_flat(), 2e-5, 1e-7)


def test_hierarchical_overlap_deterministic_and_close(runs):
    """4 ranks as 2 virtual hosts of 2: the two-stage (within-host, then
    cross-host) reduce-scatter is deterministic and equal to the flat one
    within rounding; the pod mesh keeps the model axis inside a host."""
    _same_bits(runs, 4, "hier_a", "hier_b")
    _close(_port(runs, 4, "hier_a")["params"],
           _port(runs, 4, "flat_ov")["params"], 2e-5, 1e-7)
    assert _rec(runs, 4, "pod_tp")["mesh_devices"] == [[0, 1], [2, 3]]
    assert _rec(runs, 4, "pod_tp")["iteration"] == 1


def test_multihost_smoke_spawn_two_steps_shutdown(runs):
    losses = runs["smoke"]
    assert len(losses) == 2 and losses[0] == losses[1]
    assert np.isfinite(losses).all()


# =============================================== launcher, in-process
def test_host_sharded_iterator_matches_jax():
    """Each rank's rows of a ragged global batch (and the synthesized masks
    on every rank) equal the JAX iterator's, bit for bit; a non-ragged
    batch synthesizes none."""
    x, y = _cls(21, 8, 3)
    for n in (2, 4):
        for p in range(n):
            got = list(launcher.HostShardedIterator(
                NumpyDataSetIterator(x, y, batch_size=21), process_id=p,
                num_processes=n))[0]
            want = list(jlauncher.HostShardedIterator(
                JNumpyIt(x, y, batch_size=21), process_id=p,
                num_processes=n))[0]
            for f in ("features", "labels", "features_mask", "labels_mask"):
                np.testing.assert_array_equal(np.asarray(getattr(got, f)),
                                              np.asarray(getattr(want, f)))
    x2, y2 = _cls(24, 8, 3)
    ds = list(launcher.HostShardedIterator(
        NumpyDataSetIterator(x2, y2, batch_size=24), process_id=0,
        num_processes=2))[0]
    assert ds.labels_mask is None and ds.features_mask is None


def test_pad_and_mask_matches_jax():
    from deeplearning4j_tpu.parallel.data_parallel import \
        _pad_and_mask as jpad
    x, y = _cls(21, 8, 3)
    for a, b in zip(dp._pad_and_mask(x, y, None, None, 3),
                    jpad(x, y, None, None, 3)):
        np.testing.assert_array_equal(a, b)


def test_unreachable_coordinator_is_fast_and_clear():
    t0 = time.monotonic()
    with pytest.raises(ConnectionError, match="unreachable"):
        launcher.initialize("127.0.0.1:9", 2, 1, device="cpu", timeout=1.0)
    assert time.monotonic() - t0 < 10.0
    assert not launcher._initialized


def test_noop_without_coordinator_and_shutdown_idempotent(monkeypatch):
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
              launcher.ADDRESS_ENV):
        monkeypatch.delenv(k, raising=False)
    launcher.initialize(device="cpu")
    assert not launcher._initialized and launcher.process_count() == 1
    launcher.shutdown()
    assert not launcher.reinitialize()


def test_malformed_address_and_timeout_env(monkeypatch):
    with pytest.raises(ConnectionError, match="no usable port"):
        launcher.initialize("coord-host", 2, 1, device="cpu", timeout=0.5)
    monkeypatch.setenv(launcher.TIMEOUT_ENV, "0.2")
    t0 = time.monotonic()
    with pytest.raises(ConnectionError):
        launcher.initialize("127.0.0.1:9", 2, 1, device="cpu")
    assert time.monotonic() - t0 < 5.0
    monkeypatch.setenv(launcher.TIMEOUT_ENV, "not-a-number")
    assert launcher._coordinator_timeout() == launcher.DEFAULT_TIMEOUT_S


def test_pod_mesh_rules():
    """Layout rules of pod_mesh over virtual ranks (one process: the
    subgroups are not made)."""
    m = launcher.pod_mesh(model=2, devices=range(8), hosts=2)
    assert m.axis_names == ("data", "model") and m.shape == {"data": 4,
                                                            "model": 2}
    assert m.devices.tolist() == [[0, 1], [2, 3], [4, 5], [6, 7]]
    assert launcher.pod_mesh(devices=range(8), hosts=2).shape == {"data": 8}
    with pytest.raises(ValueError, match="must divide"):
        launcher.pod_mesh(model=3, devices=range(8), hosts=2)
    with pytest.raises(ValueError, match="equal virtual hosts"):
        launcher.pod_mesh(devices=range(8), hosts=3)
    h = overlap.host_hierarchy(m, dcn_hosts=2)
    assert h.hosts == 2 and h.local == 2
    assert h.split((None, "data")) == ((None, "ici"), (None, ("dcn", "ici")))
    assert h.split(()) == (None, None)
    with pytest.raises(ValueError, match="does not split"):
        overlap.host_hierarchy(m, dcn_hosts=3)


def test_split_dcn_chains_matches_jax(runs):
    jnet = _jnet(_jax_nets()["tp"])
    net = _port_net(runs, "tp")
    jpw = JPW(jnet, jlauncher.pod_mesh(hosts=2), shard_update=True,
              dcn_hosts=2)
    pw = dp.ParallelWrapper(net, dp.make_mesh(range(8)), shard_update=True)
    specs = placement.map_paths(pw._update_spec, net.params)
    for cap in (1, 300):
        got = overlap.split_dcn_chains(overlap.make_buckets(net.params, cap),
                                       specs)
        want = jov.split_dcn_chains(
            jov.make_buckets(jnet.params, cap),
            jpw._update_shardings(jnet.params))
        assert [[list(map(tuple, b)) for b in c] for c in got] == \
            [[list(map(tuple, b)) for b in c] for c in want]


def test_tp_param_spec_matches_jax(runs):
    net = _port_net(runs, "tp")
    jnet = _jnet(_jax_nets()["tp"])
    keys = placement.dense_tp_keys(net)
    assert keys == jpl.dense_tp_keys(jnet)
    for path, leaf in placement.flatten_paths(net.params):
        for tp in (1, 2, 4):
            jleaf = jnet.params[path[0]][path[1]]
            assert placement.tp_param_spec(path, leaf, "model", tp, keys) \
                == tuple(jpl.tp_param_spec(path, jleaf, "model", tp, keys))
    with pytest.raises(NotImplementedError, match="8"):
        placement.tp_param_spec(("0", "W"), net.params["0"]["W"], "model",
                                2, keys, attn_heads={"0": 2})


def test_global_array_and_put_tree_keep_this_ranks_share():
    """One process over a virtual 8-rank mesh is rank 0: its rows of a
    batch and its shard of a tensor-parallel tree."""
    rows = np.arange(32, dtype=np.float32).reshape(16, 2)
    mesh = dp.make_dp_tp_mesh(4, 2, range(8))
    np.testing.assert_array_equal(
        launcher.make_global_array(rows, mesh, ("data",)).numpy(), rows[:4])
    np.testing.assert_array_equal(
        launcher.make_global_array(rows, mesh, ()).numpy(), rows)
    with pytest.raises(ValueError, match="do not split"):
        launcher.make_global_array(rows[:15], mesh, ("data",))
    tree = {"0": {"W": torch.arange(12.).reshape(3, 4),
                  "b": torch.arange(4.)}}
    specs = {"0": {"W": (None, "model"), "b": ("model",)}}
    got = placement.put_tree(tree, specs, mesh)
    assert torch.equal(got["0"]["W"], tree["0"]["W"][:, :2])
    assert torch.equal(got["0"]["b"], tree["0"]["b"][:2])


def test_mesh_keys_and_bytes(runs):
    m = dp.make_dp_tp_mesh(2, 4, range(8))
    assert placement.mesh_key(m) == "2x4"
    assert placement.mesh_suffix(m, "model") == "mesh=2x4:tp4"
    net = _port_net(runs, "tp")
    specs = placement.map_paths(
        lambda p, t: placement.tp_param_spec(p, t, "model", 4,
                                             placement.dense_tp_keys(net)),
        net.params)
    full = sum(t.numel() * 4 for _, t in placement.flatten_paths(net.params))
    assert placement.tree_bytes_per_device(net.params, specs, m) == full // 4


def test_wrapper_refuses_out_of_slice_calls(runs):
    pw = dp.ParallelWrapper(_port_net(runs, "su_adam"))
    for call, match in ((lambda: pw.tune_schedule(32), "item 9"),
                        (lambda: pw.attribution_report(32), "item 9"),
                        (pw.on_host_loss, "item 9"),
                        (pw.serving_engine, "item 8"),
                        (lambda: pw.fit(None, resilience=object()),
                         "item 9")):
        with pytest.raises(NotImplementedError, match=match):
            call()


def test_memory_report_of_the_wrapper(runs):
    """Measured as the model's report is (one forward and backward of a
    rank's rows), with this placement's per-rank bytes: on one rank the
    whole tree; a ZeRO-1 placement over a 4-wide data axis holds a
    quarter of the Adam state."""
    net = _port_net(runs, "su_adam")
    rep = dp.ParallelWrapper(net, shard_update=True).memory_report(16)
    full = sum(t.numel() * 4 for _, t in placement.flatten_paths(net.params))
    assert rep["rows_per_rank"] == 16 and rep["residual_bytes"] > 0
    assert rep["params_bytes_per_rank"] == full
    assert rep["updater_state_bytes_per_rank"] == 2 * full
    wide = dp.ParallelWrapper(net, dp.make_mesh(range(4)), shard_update=True)
    specs = placement.map_paths(wide._update_spec, net.params)
    assert sum(placement.tree_bytes_per_device(t, specs, wide.mesh)
               for t in net.updater_state.values()) == 2 * full // 4
