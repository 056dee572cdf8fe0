"""The port's ResNet-18 and ResNet-50 against the JAX package's, on the
CPU, at 32x32x3 input and 10 classes, batch 2.

Each JAX net gets random BatchNormalization parameters and running
statistics (so no BN is the identity), then its weights are carried into
the port twice: by ``utils.convert.from_numpy`` on ``net.params`` /
``net.state``, and by the ZIP that the JAX package's ``save()`` writes,
read with the port's ``load_model``. ``output()`` and the ``avgpool``
activation must agree within 1e-4 relative (Frobenius) error: both sides
are float32 (the JAX package computes convs at HIGHEST precision on the
CPU) and differ only in the summation order of each convolution."""

import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models.resnet import resnet as jresnet
from deeplearning4j_tpu.utils import serializer as jser
from deeplearning4j_tpu_torch.models import resnet
from deeplearning4j_tpu_torch.nn.graph import ComputationGraphConfiguration
from deeplearning4j_tpu_torch.utils import serializer
from deeplearning4j_tpu_torch.utils.convert import from_numpy

REL_TOL = 1e-4
SHAPE = (32, 32, 3)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


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


@pytest.fixture(scope="module", params=[18, 50], ids=["resnet18",
                                                      "resnet50"])
def ref(request, tmp_path_factory):
    depth = request.param
    jnet = jresnet(depth, input_shape=SHAPE, num_classes=10).init()
    rng = np.random.default_rng(depth)
    for name, p in list(jnet.params.items()):
        if "gamma" in p:
            c = p["gamma"].shape[0]
            jnet.params[name] = {
                "gamma": jnp.asarray(rng.uniform(0.5, 1.5, c), jnp.float32),
                "beta": jnp.asarray(rng.normal(0, 0.2, c), jnp.float32)}
            jnet.state[name] = {
                "mean": jnp.asarray(rng.normal(0, 0.2, c), jnp.float32),
                "var": jnp.asarray(rng.uniform(0.5, 2.0, c), jnp.float32)}
    x = rng.standard_normal((2,) + SHAPE).astype(np.float32)
    zip_path = tmp_path_factory.mktemp(f"resnet{depth}") / "model.zip"
    jnet.save(str(zip_path))
    return {
        "depth": depth, "jnet": jnet, "x": x, "zip": zip_path,
        "out": np.asarray(jnet.output(x)),
        "avgpool": np.asarray(jnet.feed_forward(x)["avgpool"]),
        "params": jax.tree.map(np.asarray, jnet.params),
        "state": jax.tree.map(np.asarray, jnet.state),
    }


@pytest.fixture(scope="module")
def carried(ref):
    net = resnet(ref["depth"], input_shape=SHAPE,
                 num_classes=10).init(device="cpu")
    net.params, net.state = from_numpy(ref["params"], ref["state"],
                                       device="cpu")
    return net


@pytest.fixture(scope="module")
def loaded(ref):
    return serializer.load_model(str(ref["zip"]), device="cpu")


@pytest.mark.parametrize("via", ["from_numpy", "zip"])
def test_output_matches_jax(ref, carried, loaded, via):
    net = carried if via == "from_numpy" else loaded
    out = net.output(ref["x"])
    assert out.shape == (2, 10) and out.dtype == np.float32
    assert _rel(out, ref["out"]) < REL_TOL


@pytest.mark.parametrize("via", ["from_numpy", "zip"])
def test_avgpool_matches_jax(ref, carried, loaded, via):
    net = carried if via == "from_numpy" else loaded
    pool = net.feed_forward(ref["x"])["avgpool"].numpy()
    assert pool.shape == ref["avgpool"].shape
    assert _rel(pool, ref["avgpool"]) < REL_TOL


def test_predict_is_argmax(ref, carried):
    np.testing.assert_array_equal(carried.predict(ref["x"]),
                                  np.argmax(ref["out"], axis=-1))


def test_fold_plan_matches_jax(ref, carried):
    assert carried._epilogue_fold_plan() == \
        ref["jnet"]._epilogue_fold_plan()


def test_every_bn_launches_one_epilogue(ref, carried):
    from deeplearning4j_tpu_torch.ops import fused_epilogues as fe
    n_bn = sum(1 for p in ref["params"].values() if "gamma" in p)
    fe.reset_counters()
    carried.output(ref["x"])
    assert fe.counters() == {"fused": 0, "fallback_platform": n_bn,
                             "fallback_act": 0, "fallback_dtype": 0}


def test_configuration_json_round_trips(ref, loaded):
    jd = json.loads(ref["jnet"].conf.to_json())
    conf = ComputationGraphConfiguration.from_json(
        ref["jnet"].conf.to_json())
    assert json.loads(conf.to_json()) == jd
    assert json.loads(loaded.conf.to_json()) == jd


def test_port_builder_writes_the_jax_configuration(ref):
    port = resnet(ref["depth"], input_shape=SHAPE, num_classes=10)
    assert json.loads(port.conf.to_json()) == \
        json.loads(ref["jnet"].conf.to_json())


def test_port_zip_loads_in_jax(ref, carried, tmp_path):
    path = tmp_path / "port.zip"
    carried.save(str(path))
    back = jser.load_model(str(path))
    assert back.conf.to_json() == ref["jnet"].conf.to_json()
    for tree, want in ((back.params, ref["params"]),
                       (back.state, ref["state"])):
        got = jax.tree.map(np.asarray, tree)
        assert jax.tree.structure(got) == jax.tree.structure(want)
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            np.testing.assert_array_equal(a, b)


def test_bfloat16_carrier_reads_both_ways():
    """The JAX package stores bfloat16 as a uint16 view plus a dtype map;
    the port reads and writes it without ml_dtypes."""
    rng = np.random.default_rng(5)
    vals = rng.standard_normal((3, 4)).astype(np.float32)
    jtree = {"v": {"W": jnp.asarray(vals, jnp.bfloat16),
                   "b": jnp.asarray(vals[0])}}
    got = serializer._npz_bytes_to_tree(jser._tree_to_npz_bytes(jtree),
                                        "cpu")
    assert got["v"]["W"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        got["v"]["W"].float().numpy(),
        np.asarray(jtree["v"]["W"].astype(jnp.float32)))
    np.testing.assert_array_equal(got["v"]["b"].numpy(), vals[0])
    back = jser._npz_bytes_to_tree(serializer._tree_to_npz_bytes(got))
    assert back["v"]["W"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(back["v"]["W"]),
                                  np.asarray(jtree["v"]["W"]))
    with np.load(io.BytesIO(serializer._tree_to_npz_bytes(got))) as z:
        assert z["v/W"].dtype == np.uint16
