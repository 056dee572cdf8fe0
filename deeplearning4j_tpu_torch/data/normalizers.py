"""Data normalizers.

Port of ``deeplearning4j_tpu/data/normalizers.py`` (numpy only, so the port
keeps its own copy): nd4j's ``NormalizerStandardize``,
``NormalizerMinMaxScaler`` and ``ImagePreProcessingScaler``. As in DL4J,
``fit(iterator_or_dataset)`` learns the statistics, ``transform(ds)``
normalizes a DataSet (reassigning its features) and ``revert_features``
undoes it; ``to_state``/``from_state`` give the statistics as a JSON-able
dict. Attach one to an iterator with ``set_pre_processor``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .dataset import DataSet, DataSetIterator

NORMALIZERS = {}


def _norm(name):
    def deco(cls):
        cls.kind = name
        NORMALIZERS[name] = cls
        return cls
    return deco


class Normalizer:
    kind = "base"

    def fit(self, data):
        raise NotImplementedError

    def transform(self, ds: DataSet) -> DataSet:
        raise NotImplementedError

    def revert_features(self, f: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def to_state(self) -> dict:
        raise NotImplementedError

    def load_state(self, d: dict):
        raise NotImplementedError

    @staticmethod
    def from_state(d: dict) -> "Normalizer":
        cls = NORMALIZERS[d["kind"]]
        n = cls()
        n.load_state(d)
        return n

    # helpers
    @staticmethod
    def _feature_stream(data):
        if isinstance(data, DataSet):
            yield data.features
        elif isinstance(data, DataSetIterator):
            for ds in data:
                yield ds.features
        else:
            yield np.asarray(data)


@_norm("standardize")
class NormalizerStandardize(Normalizer):
    """Per-feature z-score over the fitted data (DL4J NormalizerStandardize).

    For 4-d image tensors, statistics are per-channel (DL4J semantics).
    DL4J is NCHW-only; our image pipeline (datavec/image.py, data/cifar.py)
    emits NHWC, so the channel axis is a constructor choice — pass
    ``data_format="NHWC"`` for those producers or the stats silently come
    out per-height-row instead of per-channel.
    """

    def __init__(self, data_format: str = "NCHW"):
        self.mean: Optional[np.ndarray] = None
        self.std: Optional[np.ndarray] = None
        self.data_format = data_format

    def _axes(self, f):
        if f.ndim == 4:
            # reduce everything except the channel axis
            return (0, 2, 3) if self.data_format == "NCHW" else (0, 1, 2)
        if f.ndim == 3:
            return (0, 1)     # [B,T,F] per-feature
        return (0,)

    def fit(self, data):
        # two-pass streaming: sum/count then var
        tot, tot2, cnt = None, None, 0
        shape_axes = None
        for f in self._feature_stream(data):
            f = np.asarray(f, dtype=np.float64)
            axes = self._axes(f)
            shape_axes = axes
            s = f.sum(axis=axes)
            s2 = (f ** 2).sum(axis=axes)
            n = f.size / s.size
            tot = s if tot is None else tot + s
            tot2 = s2 if tot2 is None else tot2 + s2
            cnt += n
        mean = tot / cnt
        var = np.maximum(tot2 / cnt - mean ** 2, 1e-12)
        self.mean = mean.astype(np.float32)
        self.std = np.sqrt(var).astype(np.float32)
        return self

    def _bshape(self, f):
        shape = [1] * f.ndim
        if f.ndim == 4 and self.data_format == "NCHW":
            shape[1] = -1
        else:
            shape[-1] = -1
        return shape

    def transform(self, ds: DataSet) -> DataSet:
        sh = self._bshape(ds.features)
        ds.features = ((ds.features - self.mean.reshape(sh)) /
                       self.std.reshape(sh)).astype(np.float32)
        return ds

    def revert_features(self, f):
        sh = self._bshape(f)
        return f * self.std.reshape(sh) + self.mean.reshape(sh)

    def to_state(self):
        return {"kind": self.kind, "mean": self.mean.tolist(),
                "std": self.std.tolist(), "data_format": self.data_format}

    def load_state(self, d):
        self.mean = np.asarray(d["mean"], dtype=np.float32)
        self.std = np.asarray(d["std"], dtype=np.float32)
        self.data_format = d.get("data_format", "NCHW")


@_norm("minmax")
class NormalizerMinMaxScaler(Normalizer):
    """Scale features to [min_range, max_range] (DL4J NormalizerMinMaxScaler)."""

    def __init__(self, min_range: float = 0.0, max_range: float = 1.0):
        self.min_range = min_range
        self.max_range = max_range
        self.data_min: Optional[np.ndarray] = None
        self.data_max: Optional[np.ndarray] = None

    def fit(self, data):
        lo, hi = None, None
        for f in self._feature_stream(data):
            fmin = f.min(axis=0)
            fmax = f.max(axis=0)
            lo = fmin if lo is None else np.minimum(lo, fmin)
            hi = fmax if hi is None else np.maximum(hi, fmax)
        self.data_min = np.asarray(lo, dtype=np.float32)
        self.data_max = np.asarray(hi, dtype=np.float32)
        return self

    def transform(self, ds: DataSet) -> DataSet:
        rng = np.maximum(self.data_max - self.data_min, 1e-12)
        scaled = (ds.features - self.data_min) / rng
        ds.features = (scaled * (self.max_range - self.min_range) +
                       self.min_range).astype(np.float32)
        return ds

    def revert_features(self, f):
        rng = np.maximum(self.data_max - self.data_min, 1e-12)
        return (f - self.min_range) / (self.max_range - self.min_range) * rng + self.data_min

    def to_state(self):
        return {"kind": self.kind, "min_range": self.min_range,
                "max_range": self.max_range,
                "data_min": self.data_min.tolist(),
                "data_max": self.data_max.tolist()}

    def load_state(self, d):
        self.min_range = d["min_range"]
        self.max_range = d["max_range"]
        self.data_min = np.asarray(d["data_min"], dtype=np.float32)
        self.data_max = np.asarray(d["data_max"], dtype=np.float32)


@_norm("image_scaler")
class ImagePreProcessingScaler(Normalizer):
    """Pixel scaling [0,maxPixel] -> [a,b] (DL4J ImagePreProcessingScaler);
    stateless fit."""

    def __init__(self, a: float = 0.0, b: float = 1.0, max_pixel: float = 255.0):
        self.a = a
        self.b = b
        self.max_pixel = max_pixel

    def fit(self, data):
        return self

    def transform(self, ds: DataSet) -> DataSet:
        ds.features = (ds.features / self.max_pixel * (self.b - self.a) +
                       self.a).astype(np.float32)
        return ds

    def revert_features(self, f):
        return (f - self.a) / (self.b - self.a) * self.max_pixel

    def to_state(self):
        return {"kind": self.kind, "a": self.a, "b": self.b,
                "max_pixel": self.max_pixel}

    def load_state(self, d):
        self.a = d["a"]
        self.b = d["b"]
        self.max_pixel = d["max_pixel"]
