"""Classification and regression evaluation.

Port of ``deeplearning4j_tpu/eval/evaluation.py`` (numpy only, so the port
keeps its own copy): nd4j's ``Evaluation`` (a confusion matrix accumulated
on the host over evaluation batches; accuracy, and precision, recall and
F1 macro-averaged over the classes with at least one true or predicted
example; ``stats()`` a DL4J-style report) and ``RegressionEvaluation``
(per-column MSE, MAE, RMSE, R^2 and Pearson correlation). Labels and
masks may come as tensors (a batch an ``AsyncDataSetIterator`` already
put on the card); they are read back to the host.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def _host(a):
    """numpy for an array or a tensor on any device."""
    return a.detach().cpu().numpy() if hasattr(a, "detach") else \
        np.asarray(a)


class Evaluation:
    def __init__(self, num_classes: Optional[int] = None, labels=None):
        self.num_classes = num_classes
        self.label_names = labels
        self.confusion: Optional[np.ndarray] = None

    def _ensure(self, k: int):
        if self.confusion is None:
            n = self.num_classes or k
            self.confusion = np.zeros((n, n), dtype=np.int64)
        elif self.confusion.shape[0] < k:
            n = k
            c = np.zeros((n, n), dtype=np.int64)
            c[:self.confusion.shape[0], :self.confusion.shape[1]] = self.confusion
            self.confusion = c

    def eval(self, labels, predictions, mask=None):
        """labels: one-hot or int; predictions: prob/logit rows or int."""
        labels = _host(labels)
        predictions = _host(predictions)
        if labels.ndim > 1 and labels.shape[-1] > 1:
            true = labels.argmax(-1)
        else:
            true = labels.reshape(labels.shape[0], -1)[:, 0].astype(np.int64) \
                if labels.ndim > 1 else labels.astype(np.int64)
        pred = predictions.argmax(-1) if predictions.ndim > 1 else \
            predictions.astype(np.int64)
        true = true.ravel()
        pred = pred.ravel()
        if mask is not None:
            m = _host(mask).ravel().astype(bool)
            true, pred = true[m], pred[m]
        k = int(max(true.max(initial=0), pred.max(initial=0))) + 1
        self._ensure(k)
        np.add.at(self.confusion, (true, pred), 1)
        return self

    # -- metrics ------------------------------------------------------------
    def _tp(self):
        return np.diag(self.confusion)

    def accuracy(self) -> float:
        c = self.confusion
        return float(np.trace(c) / max(c.sum(), 1))

    def precision(self, cls: Optional[int] = None) -> float:
        c = self.confusion
        col = c.sum(axis=0)
        with np.errstate(divide="ignore", invalid="ignore"):
            per = np.where(col > 0, np.diag(c) / np.maximum(col, 1), np.nan)
        if cls is not None:
            return float(per[cls])
        valid = ~np.isnan(per)
        return float(np.nanmean(per)) if valid.any() else 0.0

    def recall(self, cls: Optional[int] = None) -> float:
        c = self.confusion
        row = c.sum(axis=1)
        with np.errstate(divide="ignore", invalid="ignore"):
            per = np.where(row > 0, np.diag(c) / np.maximum(row, 1), np.nan)
        if cls is not None:
            return float(per[cls])
        valid = ~np.isnan(per)
        return float(np.nanmean(per)) if valid.any() else 0.0

    def f1(self, cls: Optional[int] = None) -> float:
        p = self.precision(cls)
        r = self.recall(cls)
        return 0.0 if (p + r) == 0 else 2 * p * r / (p + r)

    def stats(self) -> str:
        c = self.confusion
        n = c.shape[0]
        names = self.label_names or [str(i) for i in range(n)]
        lines = ["========================Evaluation Metrics========================",
                 f" # of classes:    {n}",
                 f" Accuracy:        {self.accuracy():.4f}",
                 f" Precision:       {self.precision():.4f}",
                 f" Recall:          {self.recall():.4f}",
                 f" F1 Score:        {self.f1():.4f}",
                 "",
                 "=========================Confusion Matrix=========================="]
        header = "     " + " ".join(f"{m:>6}" for m in names)
        lines.append(header)
        for i in range(n):
            lines.append(f"{names[i]:>4} " + " ".join(f"{c[i, j]:>6}" for j in range(n)))
        return "\n".join(lines)


class RegressionEvaluation:
    """DL4J RegressionEvaluation: per-column MSE/MAE/RMSE/R^2/correlation."""

    def __init__(self, n_columns: Optional[int] = None):
        self.n = n_columns
        self._sum_sq = None
        self._sum_abs = None
        self._sum_l = None
        self._sum_p = None
        self._sum_ll = None
        self._sum_pp = None
        self._sum_lp = None
        self._count = 0

    def eval(self, labels, predictions, mask=None):
        l = np.asarray(labels, dtype=np.float64).reshape(-1, np.asarray(labels).shape[-1])
        p = np.asarray(predictions, dtype=np.float64).reshape(l.shape)
        if mask is not None:
            m = np.asarray(mask).ravel().astype(bool)
            l, p = l[m], p[m]
        if self._sum_sq is None:
            k = l.shape[-1]
            z = np.zeros(k)
            self._sum_sq, self._sum_abs = z.copy(), z.copy()
            self._sum_l, self._sum_p = z.copy(), z.copy()
            self._sum_ll, self._sum_pp, self._sum_lp = z.copy(), z.copy(), z.copy()
        d = p - l
        self._sum_sq += (d ** 2).sum(0)
        self._sum_abs += np.abs(d).sum(0)
        self._sum_l += l.sum(0)
        self._sum_p += p.sum(0)
        self._sum_ll += (l * l).sum(0)
        self._sum_pp += (p * p).sum(0)
        self._sum_lp += (l * p).sum(0)
        self._count += l.shape[0]
        return self

    def mse(self, col=None):
        v = self._sum_sq / self._count
        return float(v.mean() if col is None else v[col])

    def mae(self, col=None):
        v = self._sum_abs / self._count
        return float(v.mean() if col is None else v[col])

    def rmse(self, col=None):
        v = np.sqrt(self._sum_sq / self._count)
        return float(v.mean() if col is None else v[col])

    def r2(self, col=None):
        n = self._count
        ss_tot = self._sum_ll - self._sum_l ** 2 / n
        ss_res = self._sum_sq
        v = 1.0 - ss_res / np.maximum(ss_tot, 1e-12)
        return float(v.mean() if col is None else v[col])

    def pearson(self, col=None):
        n = self._count
        cov = self._sum_lp - self._sum_l * self._sum_p / n
        vl = self._sum_ll - self._sum_l ** 2 / n
        vp = self._sum_pp - self._sum_p ** 2 / n
        v = cov / np.maximum(np.sqrt(vl * vp), 1e-12)
        return float(v.mean() if col is None else v[col])

    def stats(self) -> str:
        return (f"MSE: {self.mse():.6f}  MAE: {self.mae():.6f}  "
                f"RMSE: {self.rmse():.6f}  R^2: {self.r2():.4f}  "
                f"Pearson: {self.pearson():.4f}")
