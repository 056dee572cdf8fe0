"""MNIST dataset iterator.

Port of ``deeplearning4j_tpu/data/mnist.py`` (numpy only, so the port keeps
its own copy; the JAX package's is the reference the tests hold it to):
DL4J's ``MnistDataSetIterator`` over the IDX files when they are present
(``$MNIST_DIR`` or ``~/.deeplearning4j_tpu/mnist``, optionally ``.gz``),
else the offline synthetic renderer :func:`_render_synthetic` (digit glyphs
with a random scale, shear, placement, intensity, smoothing and noise),
bit for bit the JAX package's for the same seed. ``source`` says which
path was taken ("idx" or "synthetic"). Features are ``[B, 1, 28, 28]``
float32 in [0, 1] (``flatten=True``: ``[B, 784]``), labels one-hot
``[B, 10]``; the training split is shuffled per epoch.
"""

from __future__ import annotations

import gzip
import os
import struct
from typing import Optional, Tuple

import numpy as np

from .dataset import NumpyDataSetIterator

# 5x7 pixel digit glyphs (classic font) — basis for the synthetic renderer
_GLYPHS = {
    0: ["01110", "10001", "10011", "10101", "11001", "10001", "01110"],
    1: ["00100", "01100", "00100", "00100", "00100", "00100", "01110"],
    2: ["01110", "10001", "00001", "00010", "00100", "01000", "11111"],
    3: ["11111", "00010", "00100", "00010", "00001", "10001", "01110"],
    4: ["00010", "00110", "01010", "10010", "11111", "00010", "00010"],
    5: ["11111", "10000", "11110", "00001", "00001", "10001", "01110"],
    6: ["00110", "01000", "10000", "11110", "10001", "10001", "01110"],
    7: ["11111", "00001", "00010", "00100", "01000", "01000", "01000"],
    8: ["01110", "10001", "10001", "01110", "10001", "10001", "01110"],
    9: ["01110", "10001", "10001", "01111", "00001", "00010", "01100"],
}


def _read_idx(path: str) -> np.ndarray:
    op = gzip.open if path.endswith(".gz") else open
    with op(path, "rb") as f:
        magic = struct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        shape = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        return np.frombuffer(f.read(), dtype=np.uint8).reshape(shape)


def _find_idx_files(root: str, train: bool) -> Optional[Tuple[str, str]]:
    img = "train-images-idx3-ubyte" if train else "t10k-images-idx3-ubyte"
    lab = "train-labels-idx1-ubyte" if train else "t10k-labels-idx1-ubyte"
    for suffix in ("", ".gz"):
        ip = os.path.join(root, img + suffix)
        lp = os.path.join(root, lab + suffix)
        if os.path.exists(ip) and os.path.exists(lp):
            return ip, lp
    return None


def _render_synthetic(n: int, seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """Deterministic MNIST-like digits: glyph -> random affine -> noise."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 10, size=n).astype(np.int32)
    imgs = np.zeros((n, 28, 28), dtype=np.float32)
    glyphs = {d: np.array([[int(c) for c in row] for row in g], dtype=np.float32)
              for d, g in _GLYPHS.items()}
    for i in range(n):
        g = glyphs[int(labels[i])]
        # random scale 2.2-3.2x, so glyph spans ~11-22 px
        scale = rng.uniform(2.2, 3.2)
        h, w = int(7 * scale), int(5 * scale)
        ys = (np.arange(h) / scale).astype(int).clip(0, 6)
        xs = (np.arange(w) / scale).astype(int).clip(0, 4)
        big = g[np.ix_(ys, xs)]
        # random small rotation via shear approximation
        angle = rng.uniform(-0.25, 0.25)
        sheared = np.zeros_like(big)
        for r in range(h):
            shift = int(round((r - h / 2) * angle))
            sheared[r] = np.roll(big[r], shift)
        big = sheared
        # random placement
        oy = rng.integers(1, max(2, 28 - h - 1))
        ox = rng.integers(1, max(2, 28 - w - 1))
        img = np.zeros((28, 28), dtype=np.float32)
        img[oy:oy + h, ox:ox + w] = big
        # intensity variation + blur-ish smoothing + noise
        img *= rng.uniform(0.7, 1.0)
        img = img + 0.25 * np.roll(img, 1, 0) + 0.25 * np.roll(img, 1, 1)
        img = np.clip(img, 0, 1)
        img += rng.normal(0, 0.02, size=img.shape).astype(np.float32)
        imgs[i] = np.clip(img, 0, 1)
    return (imgs * 255).astype(np.uint8), labels


class MnistDataSetIterator(NumpyDataSetIterator):
    """DL4J-style: ``MnistDataSetIterator(batch, train=True)``.

    Features: [B, 1, 28, 28] float32 in [0,1]; labels one-hot [B, 10].
    ``.source`` is "idx" (real files) or "synthetic".
    """

    def __init__(self, batch_size: int, train: bool = True, seed: int = 6,
                 num_examples: Optional[int] = None, flatten: bool = False,
                 data_dir: Optional[str] = None):
        root = data_dir or os.environ.get(
            "MNIST_DIR", os.path.expanduser("~/.deeplearning4j_tpu/mnist"))
        found = _find_idx_files(root, train) if os.path.isdir(root) else None
        if found:
            imgs = _read_idx(found[0])
            labels = _read_idx(found[1]).astype(np.int32)
            self.source = "idx"
        else:
            n = num_examples or (60000 if train else 10000)
            # cap synthetic size (rendering is host-side python)
            n = min(n, 20000 if train else 4000)
            imgs, labels = _render_synthetic(n, seed if train else seed + 1)
            self.source = "synthetic"
        if num_examples:
            imgs, labels = imgs[:num_examples], labels[:num_examples]
        f = imgs.astype(np.float32) / 255.0
        f = f.reshape(len(f), -1) if flatten else f.reshape(len(f), 1, 28, 28)
        onehot = np.zeros((len(labels), 10), dtype=np.float32)
        onehot[np.arange(len(labels)), labels] = 1.0
        super().__init__(f, onehot, batch_size, shuffle=train, seed=seed)
