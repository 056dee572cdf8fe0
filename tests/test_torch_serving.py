"""The port's serving fronts on the CPU (``device="cpu"``): InferenceEngine
bucket padding and unpadding, ParallelInference coalescing and chunking,
and a JsonModelServer round trip. Every wait has a timeout and every
front is closed by its context manager, so no test can hang the suite."""

import json
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.serving import engine as jengine
from deeplearning4j_tpu_torch.models import resnet
from deeplearning4j_tpu_torch.serving.batcher import (ParallelInference,
                                                      ShutdownError)
from deeplearning4j_tpu_torch.serving.engine import (InferenceEngine,
                                                     default_buckets,
                                                     next_bucket)
from deeplearning4j_tpu_torch.serving.server import JsonModelServer


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


SHAPE = (16, 16, 3)
WAIT_S = 60


@pytest.fixture(scope="module")
def net():
    return resnet(18, input_shape=SHAPE, num_classes=5).init(device="cpu")


def _x(seed, n):
    return np.random.default_rng(seed).standard_normal(
        (n,) + SHAPE).astype(np.float32)


def _direct(net, x):
    """The unbatched, unpadded forward (feed_forward walks no engine)."""
    return net.feed_forward(x)["fc"].numpy()


def test_buckets_match_jax():
    for n in range(1, 70):
        for m in (1, 2, 4):
            assert next_bucket(n, m) == jengine.next_bucket(n, m)
    for top in (1, 7, 32, 64):
        assert default_buckets(top) == jengine.default_buckets(top)
        assert default_buckets(top, 2) == jengine.default_buckets(top, 2)


def test_engine_pads_to_bucket_and_unpads(net):
    eng = InferenceEngine(net, device="cpu")
    eng.warmup([1, 2, 4, 8])
    x = _x(0, 3)
    out = eng.output(x)
    assert out.shape == (3, 5) and out.dtype == np.float32
    np.testing.assert_allclose(out, _direct(net, x), rtol=1e-5, atol=1e-6)
    eng.output(_x(1, 16))  # beyond the warmed buckets: served, counted
    st = eng.stats()
    assert st["calls"] == 2 and st["hits"] == 1 and st["cold_calls"] == 1
    assert st["padded_rows"] == 1
    assert st["warmed_buckets"] == [1, 2, 4, 8]
    assert st["bucket_hits"] == {"[(4, 16, 16, 3)]": 1,
                                 "[(16, 16, 16, 3)]": 1}


def test_padding_rows_never_touch_real_rows(net):
    eng = InferenceEngine(net, device="cpu")
    x = _x(2, 5)
    np.testing.assert_allclose(eng.output(x[:3]), eng.output(x)[:3],
                               rtol=1e-5, atol=1e-6)


def test_graph_output_routes_through_its_engine(net):
    x = _x(3, 2)
    before = net.inference_engine().stats()["calls"]
    np.testing.assert_allclose(net.output(x), _direct(net, x), rtol=1e-5,
                               atol=1e-6)
    assert net.inference_engine().stats()["calls"] == before + 1


def test_parallel_inference_coalesces_concurrent_requests(net):
    with ParallelInference(net, device="cpu", max_batch_size=8,
                           max_wait_ms=500) as pi:
        xs = [_x(10 + i, n) for i, n in enumerate((1, 2, 3))]
        futs = [pi.submit(x) for x in xs]
        outs = [f.result(timeout=WAIT_S) for f in futs]
        st = pi.stats()
    for x, out in zip(xs, outs):
        np.testing.assert_allclose(out, _direct(net, x), rtol=1e-5,
                                   atol=1e-6)
    assert st["requests"] == 3 and st["batches"] == 1
    assert st["batch_rows_max"] == 6 and st["failures"] == 0
    assert st["latency_ms_p50"] is not None


def test_parallel_inference_splits_oversized_requests(net):
    with ParallelInference(net, device="cpu", max_batch_size=4,
                           max_wait_ms=1) as pi:
        x = _x(20, 10)
        out = pi.wait(pi.submit(x), timeout=WAIT_S)
        st = pi.stats()
    np.testing.assert_allclose(out, _direct(net, x), rtol=1e-5, atol=1e-6)
    assert st["batches"] == 3 and st["batch_rows_max"] == 4


def test_parallel_inference_single_example_and_bad_shape(net):
    with ParallelInference(net, device="cpu", max_wait_ms=1) as pi:
        x = _x(21, 1)
        out = pi.wait(pi.submit(x[0]), timeout=WAIT_S)  # no batch dim
        assert out.shape == (1, 5)
        with pytest.raises(ValueError, match="does not match"):
            pi.submit(np.zeros((2, 8, 8, 3), np.float32))


def test_parallel_inference_rejects_after_shutdown(net):
    pi = ParallelInference(net, device="cpu", max_wait_ms=1)
    pi.shutdown()
    assert not pi._worker.is_alive()
    with pytest.raises(ShutdownError):
        pi.submit(_x(22, 1))


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=WAIT_S) as r:
        return r.status, json.loads(r.read())


def test_json_server_round_trip(net):
    with JsonModelServer(net, device="cpu", max_wait_ms=1) as srv:
        url = f"http://127.0.0.1:{srv.port}"
        with urllib.request.urlopen(url + "/health", timeout=WAIT_S) as r:
            assert json.loads(r.read()) == {"status": "ok"}
        for seed, n in ((30, 1), (31, 2)):
            x = _x(seed, n)
            code, body = _post(url + "/predict", {"data": x.tolist()})
            assert code == 200
            np.testing.assert_allclose(np.asarray(body["output"]),
                                       net.output(x), rtol=1e-6, atol=1e-7)
        with urllib.request.urlopen(url + "/stats", timeout=WAIT_S) as r:
            st = json.loads(r.read())
        assert st["requests"] == 2 and st["batches"] == 2
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(url + "/predict", {"data": [[1.0, 2.0]]})
        assert e.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(url + "/nope", timeout=WAIT_S)
        assert e.value.code == 404
    assert not srv._thread.is_alive()
    assert not srv.inference._worker.is_alive()
