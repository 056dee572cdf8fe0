"""DataSet / MultiDataSet and the iterators ``fit`` accepts.

Port of the in-memory part of ``deeplearning4j_tpu/data/dataset.py``:
:class:`DataSet`, :class:`MultiDataSet`, the iterator protocols
(:class:`DataSetIterator`, :class:`MultiDataSetIterator`) and their numpy
and list implementations, with the same resumable ``(epoch, pos)`` cursor.
Data stays host-side numpy until the training step moves a batch to the
model's device. A :class:`DataSetIterator` takes a per-batch
preprocessor (a normalizer of ``data/normalizers.py``) as in the JAX
package. The prefetching ``AsyncDataSetIterator`` and DataSet's
split/shuffle helpers come with a later slice.
"""

from __future__ import annotations

from typing import Iterator, Sequence

import numpy as np


class DataSet:
    """features/labels (+ optional masks), one minibatch (or the full set)."""

    def __init__(self, features, labels, features_mask=None, labels_mask=None):
        self.features = np.asarray(features)
        self.labels = np.asarray(labels) if labels is not None else None
        self.features_mask = None if features_mask is None else np.asarray(features_mask)
        self.labels_mask = None if labels_mask is None else np.asarray(labels_mask)

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
        self.features = [np.asarray(f) for f in _as_list(features)]
        self.labels = ([np.asarray(l) for l in _as_list(labels)]
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
    out = [None if m is None else np.asarray(m) for m in _as_list(masks)]
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
