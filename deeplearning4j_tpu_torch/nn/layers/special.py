"""Special layers: EmbeddingSequenceLayer, CenterLossOutputLayer.

Port of ``EmbeddingSequenceLayer`` (:356) and ``CenterLossOutputLayer``
(:262) from ``deeplearning4j_tpu/nn/layers/special.py``, with the same
JSON kinds (``embedding_sequence``, ``center_loss_output``), fields,
parameters (``W`` ``[nIn, nOut]``, ``b``) and state (the class centers
``[nOut, nIn]``). The module's other layers (the YOLO head,
LayerNormalization, the CNN and 3-D losses, capsules, ...) come with the
slices that need them (``ROADMAP.md`` Queue 1).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ... import dtypes as _dt
from ...ops import activations as _act
from ...ops import nnops
from .. import weights as _winit
from .base import Layer, layer
from .core import _BaseOutput, _dense


@layer("embedding_sequence")
class EmbeddingSequenceLayer(Layer):
    """DL4J EmbeddingSequenceLayer: ``[B, T]`` integer ids (or the ``[B, T,
    1]`` column form a recurrent input type of width 1 gives) to ``[B, T,
    nOut]``, through ``nnops.embedding_lookup``. Float ids truncate to
    int."""
    n_in: int = 0
    n_out: int = 0
    weight_init: str = "xavier"
    name: Optional[str] = None

    def initialize(self, gen, input_shape, dtype, device):
        w = _winit.init(self.weight_init, gen, (self.n_in, self.n_out),
                        self.n_in, self.n_out, dtype, device)
        t = int(input_shape[0]) if input_shape else -1
        return {"W": w}, {}, (t, self.n_out)

    def apply(self, params, x, state, *, train=False, mask=None):
        ids = x[..., 0] if x.dim() == 3 and x.shape[-1] == 1 else x
        return nnops.embedding_lookup(params["W"], ids), state, mask


@layer("center_loss_output")
class CenterLossOutputLayer(Layer, _BaseOutput):
    """DL4J CenterLossOutputLayer: softmax cross entropy plus ``0.5 *
    lambda_ * mean ||f - c_y||^2``, with one feature center a class. The
    centers live in the layer's STATE, outside the gradient: in training
    ``apply`` returns the logits and stashes its input features in the
    state under ``__features__``; the engines' loss pops them (they never
    reach the committed state or ``save()``) and moves the centers by the
    EMA rule of :meth:`update_centers`."""
    n_out: int = 0
    alpha: float = 0.05
    lambda_: float = 2e-4
    loss: str = "mcxent"
    activation: str = "softmax"
    weight_init: str = "xavier"
    loss_weights: Optional[Tuple[float, ...]] = None
    l1: float = 0.0
    l2: float = 0.0
    name: Optional[str] = None

    def initialize(self, gen, input_shape, dtype, device):
        n_in = int(input_shape[-1])
        w = _winit.init(self.weight_init, gen, (n_in, self.n_out), n_in,
                        self.n_out, dtype, device)
        params = {"W": w,
                  "b": torch.zeros((self.n_out,), dtype=dtype, device=device)}
        state = {"centers": torch.zeros((self.n_out, n_in), dtype=dtype,
                                        device=device)}
        return params, state, tuple(input_shape[:-1]) + (self.n_out,)

    def apply(self, params, x, state, *, train=False, mask=None):
        logits = _dense(x, params["W"], params["b"])
        if train:
            return logits, {**state, "__features__": x}, mask
        return _act.get(self.activation)(logits), state, mask

    def loss_value(self, logits, labels, mask=None, weights=None,
                   features=None, centers=None):
        ce = _BaseOutput.loss_value(self, logits, labels, mask, weights)
        if features is None or centers is None:
            return ce
        features = _dt.upcast_16(features)
        labels = _dt.upcast_16(labels)
        cls_centers = torch.matmul(labels, centers)  # the one-hot pick
        center_term = torch.mean(torch.sum((features - cls_centers) ** 2,
                                           dim=-1))
        return ce + 0.5 * self.lambda_ * center_term

    def update_centers(self, centers, features, labels):
        """The EMA center update (DL4J's alpha rule): each class seen in
        the batch moves ``alpha`` of the way to its features' mean. The
        product promotes as jnp's does (bf16 features with f32 labels, a
        16-bit network's, sum in f32)."""
        counts = labels.sum(0)[:, None]                         # [C, 1]
        dt = torch.promote_types(labels.dtype, features.dtype)
        means = torch.matmul(labels.T.to(dt), features.to(dt)) / \
            torch.clamp(counts, min=1.0)
        return torch.where(counts > 0, (1 - self.alpha) * centers
                           + self.alpha * means, centers)
