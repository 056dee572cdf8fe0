"""The port's AsyncDataSetIterator against plain iteration and against the
JAX package's, on the CPU: the order and the values of the batches
(bit-identical), ``device_prefetch`` (tensors on the device, the
preprocessor run before the copy), ``reset``, resume by the consumed
count (mid-epoch, after abandoning a pass, and at an epoch's end),
``max_bad_records`` (skip-and-log, then abort past the cap), ``fit``
through it, and no producer thread left behind."""

import threading

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.data import dataset as jds
from deeplearning4j_tpu_torch.data import dataset as pds
from deeplearning4j_tpu_torch.data.normalizers import NormalizerStandardize
from deeplearning4j_tpu_torch.models.lenet import lenet


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


@pytest.fixture(autouse=True)
def _no_leaked_producer():
    """Every test leaves no producer thread running."""
    yield
    alive = [t for t in threading.enumerate()
             if t.name == "AsyncDataSetIterator" and t.is_alive()]
    assert not alive


def _arrays(n=50):
    rng = np.random.default_rng(0)
    return (rng.standard_normal((n, 3)).astype(np.float32),
            np.eye(2, dtype=np.float32)[rng.integers(0, 2, n)])


def _base(pkg=pds, **kw):
    x, y = _arrays()
    return pkg.NumpyDataSetIterator(x, y, batch_size=8, shuffle=True,
                                    seed=5, **kw)


def _host(a):
    return a.numpy() if torch.is_tensor(a) else np.asarray(a)


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_host(g.features), _host(w.features))
        np.testing.assert_array_equal(_host(g.labels), _host(w.labels))


@pytest.mark.parametrize("queue_size", [1, 4])
def test_batches_are_plain_iteration_bit_for_bit(queue_size):
    plain = list(_base())
    it = pds.AsyncDataSetIterator(_base(), queue_size=queue_size)
    _same(list(it), plain)
    _same(list(it), _second_epoch())  # the base's next epoch


def _second_epoch():
    b = _base()
    list(b)
    return list(b)


def test_batches_equal_the_jax_iterator():
    jit = jds.AsyncDataSetIterator(_base(jds), queue_size=2)
    pit = pds.AsyncDataSetIterator(_base(), queue_size=2)
    for _ in range(2):  # two epochs: the shuffle moves with the epoch
        _same(list(pit), list(jit))


def test_device_prefetch_gives_tensors_after_the_preprocessor():
    norm = NormalizerStandardize()
    x, y = _arrays()
    norm.fit(pds.DataSet(x, y))
    plain = _base().set_pre_processor(norm)
    it = pds.AsyncDataSetIterator(_base(), device_prefetch=True,
                                  device="cpu").set_pre_processor(norm)
    got = list(it)
    assert all(torch.is_tensor(b.features) and torch.is_tensor(b.labels)
               for b in got)
    _same(got, list(plain))


def test_device_prefetch_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("the card is there: the default is allowed")
    with pytest.raises(RuntimeError):
        pds.AsyncDataSetIterator(_base(), device_prefetch=True)


def test_reset_starts_over():
    it = pds.AsyncDataSetIterator(_base())
    for i, _ in enumerate(it):
        if i == 2:
            break
    it.reset()
    _same(list(it), list(_base()))


def test_resume_by_the_consumed_count_like_jax():
    """Consume 3 batches, save the cursor, resume in a new iterator: the
    rest of the epoch, as the JAX iterator resumes."""
    results = []
    for pkg in (pds, jds):
        it = pkg.AsyncDataSetIterator(_base(pkg), queue_size=3)
        head = []
        for b in it:
            head.append(b)
            if len(head) == 3:
                break
        state = it.state()
        assert state["consumed"] == 3
        again = pkg.AsyncDataSetIterator(_base(pkg), queue_size=3)
        again.set_state(state)
        results.append((head, list(again), list(again)))
    (ph, pr, pn), (jh, jr, jn) = results
    _same(ph + pr, list(_base()))
    _same(pr, jr)
    _same(pn, jn)
    _same(pn, _second_epoch())


def test_abandoned_pass_rewinds_to_what_was_consumed():
    it = pds.AsyncDataSetIterator(_base(), queue_size=4)
    head = []
    for b in it:
        head.append(b)
        if len(head) == 2:
            break
    _same(head + list(it), list(_base()))
    assert it.state()["consumed"] == 0  # the epoch ended cleanly


class _Flaky(pds.DataSetIterator):
    """A resumable base whose batches ``bad`` raise once when read."""

    def __init__(self, bad):
        self._bad, self._pos, self._raised = set(bad), 0, set()
        self._x, self._y = _arrays(40)

    def batch_size(self):
        return 8

    def state(self):
        return {"pos": self._pos}

    def set_state(self, state):
        self._pos = int(state.get("pos", 0))

    def reset(self):
        self._pos = 0

    def __iter__(self):
        while self._pos < 5:
            i = self._pos
            self._pos += 1
            if i in self._bad and i not in self._raised:
                self._raised.add(i)
                raise IOError(f"bad batch {i}")
            yield pds.DataSet(self._x[8 * i:8 * i + 8],
                              self._y[8 * i:8 * i + 8])
        self._pos = 0


def test_max_bad_records_skips_and_counts_then_aborts(caplog):
    it = pds.AsyncDataSetIterator(_Flaky({1, 3}), max_bad_records=2)
    got = list(it)
    assert len(got) == 3
    x, _ = _arrays(40)
    for b, i in zip(got, (0, 2, 4)):
        np.testing.assert_array_equal(b.features, x[8 * i:8 * i + 8])
    assert it.stats() == {"bad_records": 2, "max_bad_records": 2}
    assert "skipping bad record" in caplog.text
    with pytest.raises(IOError, match="bad batch 1"):
        list(pds.AsyncDataSetIterator(_Flaky({1}), max_bad_records=0))


def test_fit_through_it_equals_plain_fit():
    """Three LeNet steps of ``fit`` through the prefetching iterator give
    the plain iterator's parameters exactly."""
    rng = np.random.default_rng(1)
    x = rng.random((24, 1, 28, 28)).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, 24)]
    nets = [lenet(device="cpu"), lenet(device="cpu")]
    nets[0].fit(pds.NumpyDataSetIterator(x, y, batch_size=8))
    nets[1].fit(pds.AsyncDataSetIterator(
        pds.NumpyDataSetIterator(x, y, batch_size=8), device_prefetch=True,
        device="cpu"))
    for k, tree in nets[0].params.items():
        for name, t in tree.items():
            assert torch.equal(nets[1].params[k][name], t)


def test_evaluate_through_it_equals_plain():
    """``evaluate`` reads the prefetched batches' tensor labels as it reads
    numpy ones."""
    rng = np.random.default_rng(2)
    x = rng.random((20, 1, 28, 28)).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, 20)]
    net = lenet(device="cpu")
    plain = net.evaluate(pds.NumpyDataSetIterator(x, y, batch_size=8))
    fetched = net.evaluate(pds.AsyncDataSetIterator(
        pds.NumpyDataSetIterator(x, y, batch_size=8), device_prefetch=True,
        device="cpu"))
    np.testing.assert_array_equal(fetched.confusion, plain.confusion)
