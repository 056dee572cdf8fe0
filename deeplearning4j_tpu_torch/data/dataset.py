"""DataSet / MultiDataSet and the iterators ``fit`` accepts.

Port of the in-memory part of ``deeplearning4j_tpu/data/dataset.py``:
:class:`DataSet`, :class:`MultiDataSet`, the iterator protocols
(:class:`DataSetIterator`, :class:`MultiDataSetIterator`) and their numpy
and list implementations, with the same resumable ``(epoch, pos)`` cursor.
Data stays host-side numpy until the training step moves a batch to the
model's device, or until :class:`AsyncDataSetIterator` with
``device_prefetch=True`` copies it there ahead of the step (a DataSet
then holds tensors). A :class:`DataSetIterator` takes a per-batch
preprocessor (a normalizer of ``data/normalizers.py``) as in the JAX
package. DataSet's split/shuffle helpers come with a later slice.
"""

from __future__ import annotations

import logging
import queue
import threading
from typing import Iterator, List, Sequence

import numpy as np
import torch

from .. import environment as _env

log = logging.getLogger(__name__)


def _array(a):
    """A field of a DataSet: a tensor stays one (a batch already on its
    device), anything else becomes a numpy array."""
    return a if torch.is_tensor(a) else np.asarray(a)


class DataSet:
    """features/labels (+ optional masks), one minibatch (or the full set)."""

    def __init__(self, features, labels, features_mask=None, labels_mask=None):
        self.features = _array(features)
        self.labels = _array(labels) if labels is not None else None
        self.features_mask = None if features_mask is None else \
            _array(features_mask)
        self.labels_mask = None if labels_mask is None else \
            _array(labels_mask)

    def num_examples(self) -> int:
        return int(self.features.shape[0])

    def copy(self) -> "DataSet":
        """Shallow copy: a new DataSet over the same arrays (normalizers
        reassign fields, they do not write into the arrays)."""
        return DataSet(self.features, self.labels, self.features_mask,
                       self.labels_mask)


class MultiDataSet:
    """Multi-input/multi-output minibatch (nd4j ``MultiDataSet``) — the
    ComputationGraph feeding format. Every field is a LIST of arrays (or
    None-per-slot for masks), one per network input/output."""

    def __init__(self, features, labels, features_masks=None, labels_masks=None):
        self.features = [_array(f) for f in _as_list(features)]
        self.labels = ([_array(l) for l in _as_list(labels)]
                       if labels is not None else [])
        self.features_masks = _mask_list(features_masks, len(self.features))
        self.labels_masks = _mask_list(labels_masks, len(self.labels))

    def num_examples(self) -> int:
        return int(self.features[0].shape[0])

    @staticmethod
    def from_dataset(ds: "DataSet") -> "MultiDataSet":
        has_labels = ds.labels is not None
        return MultiDataSet([ds.features],
                            [ds.labels] if has_labels else None,
                            [ds.features_mask],
                            [ds.labels_mask] if has_labels else None)


def _as_list(x):
    if isinstance(x, (list, tuple)):
        return list(x)
    return [x]


def _mask_list(masks, n):
    if masks is None:
        return [None] * n
    out = [None if m is None else _array(m) for m in _as_list(masks)]
    if len(out) != n:
        raise ValueError(f"expected {n} masks, got {len(out)}")
    return out


class MultiDataSetIterator:
    """Iterator protocol over MultiDataSet minibatches (DL4J
    ``MultiDataSetIterator``)."""

    def __iter__(self) -> Iterator[MultiDataSet]:
        raise NotImplementedError

    def reset(self):
        pass

    def batch_size(self) -> int:
        raise NotImplementedError


class NumpyMultiDataSetIterator(MultiDataSetIterator):
    """Mini-batches over in-memory multi-input/-output arrays. Resumable via
    the same ``(epoch, pos)`` cursor contract as :class:`NumpyDataSetIterator`."""

    def __init__(self, features, labels, batch_size: int, shuffle: bool = False,
                 seed: int = 123):
        self._f = [np.asarray(a) for a in _as_list(features)]
        self._l = [np.asarray(a) for a in _as_list(labels)]
        self._bs = batch_size
        self._shuffle = shuffle
        self._seed = seed
        self._epoch = 0
        self._pos = 0

    def batch_size(self) -> int:
        return self._bs

    def reset(self):
        self._epoch = 0
        self._pos = 0

    def state(self) -> dict:
        return {"epoch": self._epoch, "pos": self._pos, "seed": self._seed}

    def set_state(self, state: dict):
        if state.get("seed", self._seed) != self._seed:
            raise ValueError(
                f"iterator state was captured with seed {state['seed']}, "
                f"this iterator has seed {self._seed}")
        self._epoch = int(state.get("epoch", 0))
        self._pos = int(state.get("pos", 0))

    def __iter__(self):
        n = self._f[0].shape[0]
        idx = (np.random.default_rng((self._seed, self._epoch)).permutation(n)
               if self._shuffle else np.arange(n))
        while self._pos < n:
            j = idx[self._pos:self._pos + self._bs]
            self._pos += self._bs
            yield MultiDataSet([a[j] for a in self._f], [a[j] for a in self._l])
        self._epoch += 1
        self._pos = 0


class DataSetIterator:
    """Iterator protocol (DL4J DataSetIterator): iterable of DataSet
    minibatches with reset semantics, plus a restorable cursor:
    ``state()`` returns a small JSON-able dict and ``set_state()`` resumes
    iteration exactly there."""

    pre_processor = None  # a normalizer, applied to every batch

    def __iter__(self) -> Iterator[DataSet]:
        raise NotImplementedError

    def reset(self):
        pass

    def batch_size(self) -> int:
        raise NotImplementedError

    def set_pre_processor(self, pp) -> "DataSetIterator":
        """Attach a per-batch preprocessor (DL4J ``setPreProcessor``): each
        yielded DataSet passes through ``pp.transform`` first."""
        self.pre_processor = pp
        return self

    def _pp(self, ds: DataSet) -> DataSet:
        if self.pre_processor is not None:
            self.pre_processor.transform(ds)
        return ds

    def state(self) -> dict:
        """Restorable cursor. Default: empty (non-resumable iterators)."""
        return {}

    def set_state(self, state: dict):
        pass


class NumpyDataSetIterator(DataSetIterator):
    """Mini-batches over in-memory arrays (ListDataSetIterator equivalent).

    Resumable: the epoch-``e`` shuffle permutation is derived from
    ``(seed, e)`` rather than a progressively-consumed generator, so the
    cursor is fully described by ``{epoch, pos}`` — two ints — and restoring
    it reproduces the exact remaining batch sequence.
    """

    def __init__(self, features, labels, batch_size: int, shuffle: bool = False,
                 seed: int = 123, drop_last: bool = False,
                 features_mask=None, labels_mask=None):
        self._f = np.asarray(features)
        self._l = np.asarray(labels) if labels is not None else None
        self._fm = None if features_mask is None else np.asarray(features_mask)
        self._lm = None if labels_mask is None else np.asarray(labels_mask)
        self._bs = batch_size
        self._shuffle = shuffle
        self._seed = seed
        self._drop_last = drop_last
        self._epoch = 0
        self._pos = 0  # example index within the current epoch's permutation

    def batch_size(self) -> int:
        return self._bs

    def num_examples(self) -> int:
        return int(self._f.shape[0])

    def reset(self):
        self._epoch = 0
        self._pos = 0

    def state(self) -> dict:
        return {"epoch": self._epoch, "pos": self._pos, "seed": self._seed}

    def set_state(self, state: dict):
        if state.get("seed", self._seed) != self._seed:
            raise ValueError(
                f"iterator state was captured with seed {state['seed']}, "
                f"this iterator has seed {self._seed}")
        self._epoch = int(state.get("epoch", 0))
        self._pos = int(state.get("pos", 0))

    def _perm(self, epoch: int):
        if not self._shuffle:
            return np.arange(self._f.shape[0])
        return np.random.default_rng((self._seed, epoch)).permutation(
            self._f.shape[0])

    def __iter__(self):
        n = self._f.shape[0]
        idx = self._perm(self._epoch)
        end = (n // self._bs) * self._bs if self._drop_last else n
        while self._pos < end:
            j = idx[self._pos:self._pos + self._bs]
            self._pos += self._bs
            yield self._pp(DataSet(
                self._f[j],
                None if self._l is None else self._l[j],
                None if self._fm is None else self._fm[j],
                None if self._lm is None else self._lm[j]))
        self._epoch += 1
        self._pos = 0


class ListDataSetIterator(DataSetIterator):
    """Iterate a pre-built list of DataSet batches (DL4J ListDataSetIterator)."""

    def __init__(self, batches: Sequence[DataSet]):
        self._batches = list(batches)
        self._pos = 0

    def batch_size(self) -> int:
        return self._batches[0].num_examples() if self._batches else 0

    def reset(self):
        self._pos = 0

    def state(self) -> dict:
        return {"pos": self._pos}

    def set_state(self, state: dict):
        self._pos = int(state.get("pos", 0))

    def __iter__(self):
        while self._pos < len(self._batches):
            b = self._batches[self._pos]
            self._pos += 1
            yield self._pp(b.copy()) if self.pre_processor is not None \
                else b
        self._pos = 0


def _to_device(a, device):
    """One host array on ``device``: from pinned memory and without
    blocking the host when ``device`` is a card (the copy is ordered
    before later work on the same stream), else a plain tensor."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _device_batch(ds: DataSet, device) -> DataSet:
    return DataSet(*(None if a is None else _to_device(a, device)
                     for a in (ds.features, ds.labels, ds.features_mask,
                               ds.labels_mask)))


class AsyncDataSetIterator(DataSetIterator):
    """Background-thread prefetch wrapper (DL4J AsyncDataSetIterator), the
    JAX package's (``data/dataset.py`` :349): a producer thread fills a
    queue of ``queue_size`` batches while the consumer trains.

    Resume: the producer runs ahead of the consumer, so the cursor is the
    base iterator's state at the start of the pass plus the count of
    batches consumed; ``set_state`` replays the base from there and skips
    that many. Abandoning a pass mid-epoch stops the producer and rewinds
    the base to what was consumed. A pass that ends cleanly rolls the
    snapshot forward to the next epoch.

    ``device_prefetch=True`` copies each batch to ``device`` (``cuda``
    unless the caller asks for ``cpu``) in the producer, from pinned host
    memory without blocking, so the copy overlaps the step; the values are
    bit-identical to plain iteration, and any ``pre_processor`` runs on the
    host arrays before the copy.

    ``max_bad_records=N``: a reader or preprocessor exception on one batch
    is logged and counted (``bad_records``, :meth:`stats`) instead of
    ending the epoch; the ``N+1``-th aborts. After a base-iterator failure
    the base is re-entered from its own cursor, so a bad batch costs one
    batch (a base with no cursor fails at once). The default 0 fails fast.

    Not in the port: the JAX package's ``data.record`` fault site and its
    telemetry counter, which come with the runtime slice (``ROADMAP.md``
    Queue 1 item 9).
    """

    def __init__(self, base: DataSetIterator, queue_size: int = 4,
                 device_prefetch: bool = False, device=None,
                 max_bad_records: int = 0):
        self._base = base
        self._qsize = queue_size
        self._device = _env.resolve_device(device) if device_prefetch \
            else None
        self._max_bad = int(max_bad_records)
        self.bad_records = 0  # cumulative across epochs (stats())
        self._start_state: dict = {}
        self._consumed = 0
        self._skip = 0

    def batch_size(self) -> int:
        return self._base.batch_size()

    def reset(self):
        self._base.reset()
        self._consumed = 0
        self._skip = 0

    def state(self) -> dict:
        return {"base": self._start_state, "consumed": self._consumed}

    def set_state(self, state: dict):
        self._base.set_state(state.get("base", {}))
        self._skip = int(state.get("consumed", 0))
        self._start_state = self._base.state()
        self._consumed = self._skip

    def stats(self) -> dict:
        """The ``max_bad_records`` ledger."""
        return {"bad_records": self.bad_records,
                "max_bad_records": self._max_bad}

    def _tolerate(self, e: BaseException) -> bool:
        """Skip and log one bad batch; False when over the cap."""
        if self.bad_records >= self._max_bad:
            return False
        self.bad_records += 1
        log.warning("AsyncDataSetIterator: skipping bad record/batch %d/%d "
                    "(%s: %s)", self.bad_records, self._max_bad,
                    type(e).__name__, e)
        return True

    def __iter__(self):
        self._start_state = self._base.state()
        self._consumed = 0
        q: "queue.Queue" = queue.Queue(maxsize=self._qsize)
        end, skipped = object(), object()  # in-stream markers
        err: List[BaseException] = []
        stop = threading.Event()

        def put(item) -> bool:
            """A bounded put that gives up once the consumer went away."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            try:
                bit = iter(self._base)
                while True:
                    try:
                        ds = next(bit)
                    except StopIteration:
                        break
                    except BaseException as e:
                        # the base generator is dead; its cursor lives on
                        # the iterator object, so re-enter from there (a
                        # cursorless base would retry the same batch)
                        if not self._base.state() or not self._tolerate(e):
                            raise
                        bit = iter(self._base)
                        put(skipped)
                        continue
                    try:
                        if self._device is not None:
                            if self.pre_processor is not None:
                                ds = self._pp(ds.copy())
                            ds = _device_batch(ds, self._device)
                    except BaseException as e:
                        if not self._tolerate(e):
                            raise
                        put(skipped)  # in order: the cursor counts it
                        continue
                    if not put(ds):
                        return
            except BaseException as e:  # raised in the consumer
                err.append(e)
            finally:
                put(end)

        t = threading.Thread(target=produce, daemon=True,
                             name="AsyncDataSetIterator")
        t.start()
        clean = False
        try:
            while True:
                item = q.get()
                if item is skipped:
                    # a dropped batch held one base-cursor position
                    self._consumed += 1
                    if self._skip > 0:
                        self._skip -= 1
                    continue
                if item is end:
                    if err:
                        raise err[0]
                    self._start_state = self._base.state()
                    self._consumed = 0
                    clean = True
                    return
                self._consumed += 1
                if self._skip > 0:
                    self._skip -= 1
                    continue
                # copy, then transform: a base may re-yield stored batches
                yield self._pp(item.copy()) \
                    if self.pre_processor is not None \
                    and self._device is None else item
        finally:
            if not clean:
                # abandoned mid-epoch: stop the producer, then rewind the
                # base to what was consumed (it ran ahead)
                stop.set()
                t.join(timeout=5.0)
                if self._base.state():
                    self._base.set_state(self._start_state)
                    self._skip = self._consumed
            t.join(timeout=5.0)
