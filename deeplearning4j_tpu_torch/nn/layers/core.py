"""Core feed-forward layers: Dense, Activation, Dropout, Flatten, Masking,
Embedding, Output, Loss.

Port of ``DenseLayer``, ``ActivationLayer``, ``DropoutLayer``,
``FlattenLayer``, ``PermuteLayer`` (:121), ``ReshapeLayer`` (:147),
``MaskingLayer`` (:183), ``EmbeddingLayer`` (:209),
``ElementWiseMultiplicationLayer`` (:230), ``OutputLayer`` and
``LossLayer`` from ``deeplearning4j_tpu/nn/layers/core.py``, the pointwise
ones marked ``decode_pointwise`` as there (:35, :65, :83, :233, :276,
:309). Parameter names and layouts
follow DL4J: ``W`` is ``[nIn, nOut]``, ``b`` is ``[nOut]``. In training
the loss heads return their pre-activation and
:meth:`_BaseOutput.loss_value` computes the loss from it.

A layer with ``needs_rng = True`` (Dropout) takes the model's
``torch.Generator`` as ``rng`` in ``apply``; the others take no rng.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ... import dtypes as _dt
from ...ops import activations as _act
from ...ops import losses as _loss
from ...ops import nnops
from ...ops.quantize import qdot as _dense
from .. import weights as _winit
from .base import Layer, layer


@layer("dense")
class DenseLayer(Layer):
    """Fully connected layer (DL4J DenseLayer). W:[nIn,nOut] b:[nOut]; a
    quantized ``W`` takes the int8 matmul (``ops.quantize.qdot``)."""
    decode_pointwise = True  # y_t depends only on x_t
    quantizable = True
    n_out: int = 0
    n_in: Optional[int] = None  # inferred from input_shape when None
    activation: str = "identity"
    weight_init: str = "xavier"
    bias_init: float = 0.0
    l1: float = 0.0
    l2: float = 0.0
    name: Optional[str] = None

    def initialize(self, gen, input_shape, dtype, device):
        n_in = self.n_in or int(input_shape[-1])
        w = _winit.init(self.weight_init, gen, (n_in, self.n_out), n_in,
                        self.n_out, dtype, device)
        b = torch.full((self.n_out,), self.bias_init, dtype=dtype,
                       device=device)
        return {"W": w, "b": b}, {}, tuple(input_shape[:-1]) + (self.n_out,)

    def quantize_spec(self, params):
        return {"W": 1}  # [nIn, nOut]: one scale per output channel

    def apply(self, params, x, state, *, train=False, mask=None):
        y = _tp_dense(x, params["W"], params["b"], self.n_out)
        return _act.get(self.activation)(y), state, mask


def _tp_dense(x, w, b, n_out: int):
    """``x @ w + b``; when this rank's kernel holds a model-axis shard of
    the columns (tensor parallelism in a ``ParallelWrapper`` step,
    ``placement.tp_param_spec``) the product runs on the shard and every
    model rank's columns are gathered."""
    from ...parallel import collectives as _coll
    ctx = _coll.current()
    cols = w.shape[-1]
    if ctx is None or ctx.model_size == 1 or cols == n_out:
        return _dense(x, w, b)
    if cols * ctx.model_size != n_out:
        raise ValueError(f"dense kernel of {cols} columns is neither the "
                         f"layer's {n_out} nor a 1/{ctx.model_size} "
                         "model-axis shard of them")
    y = _dense(_coll.model_region(x, ctx.model), w, b)
    return _coll.gather_columns(y, ctx.model)


@layer("activation")
class ActivationLayer(Layer):
    decode_pointwise = True
    activation: str = "relu"
    # parameter for parameterized activations (leakyrelu slope, elu alpha,
    # thresholdedrelu theta); None = the activation's own default
    alpha: Optional[float] = None
    name: Optional[str] = None

    def has_params(self):
        return False

    def apply(self, params, x, state, *, train=False, mask=None):
        fn = _act.get(self.activation)
        if self.alpha is not None:
            return fn(x, self.alpha), state, mask
        return fn(x), state, mask


@layer("dropout")
class DropoutLayer(Layer):
    """DL4J DropoutLayer. As in the JAX package, ``rate`` is the DROP rate
    (DL4J's config value is the retain probability). Training with a
    generator drops; inference, or no generator, is the identity."""
    decode_pointwise = True  # inference identity
    needs_rng = True
    rate: float = 0.5
    name: Optional[str] = None

    def has_params(self):
        return False

    def apply(self, params, x, state, *, train=False, mask=None, rng=None):
        if not train or rng is None:
            return x, state, mask
        return nnops.dropout(x, self.rate, rng), state, mask


@layer("flatten")
class FlattenLayer(Layer):
    """DL4J's CnnToFeedForwardPreProcessor as a layer (the builder inserts
    it at a convolution -> dense seam): ``[B, ...]`` to ``[B, prod(...)]``
    in the logical order of the input's axes (C, H, W for NCHW), whatever
    its memory layout (a channels-last tensor is copied, not viewed)."""
    name: Optional[str] = None

    def has_params(self):
        return False

    def initialize(self, gen, input_shape, dtype, device):
        flat = 1
        for s in input_shape:
            flat *= int(s)
        return {}, {}, (flat,)

    def apply(self, params, x, state, *, train=False, mask=None):
        return x.reshape(x.shape[0], -1), state, mask


@layer("permute")
class PermuteLayer(Layer):
    """Permute the non-batch axes (Keras ``Permute``). ``dims`` are the
    1-indexed input axes in output order, the batch excluded: (2, 1) swaps
    the two non-batch axes. The mask is dropped."""
    dims: Tuple[int, ...] = ()
    name: Optional[str] = None

    def has_params(self):
        return False

    def initialize(self, gen, input_shape, dtype, device):
        if sorted(self.dims) != list(range(1, len(input_shape) + 1)):
            raise ValueError(
                f"Permute dims {self.dims} must be a permutation of "
                f"1..{len(input_shape)} for input {input_shape}")
        return {}, {}, tuple(input_shape[d - 1] for d in self.dims)

    def apply(self, params, x, state, *, train=False, mask=None):
        return x.permute((0,) + tuple(self.dims)), state, None


@layer("reshape")
class ReshapeLayer(Layer):
    """Reshape the non-batch axes (Keras ``Reshape``). ``target_shape``
    excludes the batch dim; one entry may be -1. The mask is dropped."""
    target_shape: Tuple[int, ...] = ()
    name: Optional[str] = None

    def has_params(self):
        return False

    def initialize(self, gen, input_shape, dtype, device):
        tgt = [int(t) for t in self.target_shape]
        total = 1
        for s in input_shape:
            total *= int(s)
        if -1 in tgt:
            known = 1
            for t in tgt:
                if t != -1:
                    known *= t
            tgt[tgt.index(-1)] = total // known
        prod = 1
        for t in tgt:
            prod *= t
        if prod != total:
            raise ValueError(
                f"Reshape target {self.target_shape} incompatible with "
                f"input {input_shape}")
        return {}, {}, tuple(tgt)

    def apply(self, params, x, state, *, train=False, mask=None):
        tgt = tuple(int(t) for t in self.target_shape)
        return x.reshape((x.shape[0],) + tgt), state, None


@layer("masking")
class MaskingLayer(Layer):
    """Keras ``Masking``: a step whose features all equal ``mask_value`` is
    masked out. Emits the step mask (times the incoming one) and zeroes the
    masked steps."""
    mask_value: float = 0.0
    name: Optional[str] = None

    def has_params(self):
        return False

    def initialize(self, gen, input_shape, dtype, device):
        if len(input_shape) != 2:
            raise ValueError(f"Masking expects [T,F], got {input_shape}")
        return {}, {}, tuple(input_shape)

    def apply(self, params, x, state, *, train=False, mask=None):
        new_mask = torch.any(x != self.mask_value, dim=-1).to(x.dtype)
        if mask is not None:
            new_mask = new_mask * mask.to(x.dtype)
        return x * new_mask[..., None], state, new_mask


@layer("embedding")
class EmbeddingLayer(Layer):
    """DL4J EmbeddingLayer: integer ids to rows of ``W`` ``[nIn, nOut]``
    (``nnops.embedding_lookup``); a ``[B, 1]`` column of ids gives ``[B,
    D]`` (the ``[B, 1, D]`` lookup squeezed)."""
    n_in: int = 0        # vocab size
    n_out: int = 0       # embedding dim
    weight_init: str = "xavier"
    name: Optional[str] = None

    def initialize(self, gen, input_shape, dtype, device):
        w = _winit.init(self.weight_init, gen, (self.n_in, self.n_out),
                        self.n_in, self.n_out, dtype, device)
        return {"W": w}, {}, tuple(input_shape) + (self.n_out,)

    def apply(self, params, x, state, *, train=False, mask=None):
        y = nnops.embedding_lookup(params["W"], x)
        if y.dim() >= 3 and y.shape[-2] == 1:
            y = y.squeeze(-2)
        return y, state, mask


@layer("elementwise_mult")
class ElementWiseMultiplicationLayer(Layer):
    """DL4J ElementWiseMultiplicationLayer: y = act(x * W + b), W, b: [nIn]."""
    decode_pointwise = True
    activation: str = "identity"
    weight_init: str = "ones"
    name: Optional[str] = None

    def initialize(self, gen, input_shape, dtype, device):
        n = int(input_shape[-1])
        w = _winit.init(self.weight_init, gen, (n,), n, n, dtype, device)
        return ({"W": w, "b": torch.zeros(n, dtype=dtype, device=device)},
                {}, tuple(input_shape))

    def apply(self, params, x, state, *, train=False, mask=None):
        return (_act.get(self.activation)(x * params["W"] + params["b"]),
                state, mask)


class _BaseOutput:
    """Loss plumbing shared by the loss heads. softmax + mcxent (or
    sparse_mcxent) and sigmoid + binary_xent take the stable loss on
    logits; every other pair applies the activation, then the loss."""

    def loss_value(self, logits, labels, mask=None, weights=None):
        logits = _dt.upcast_16(logits)  # loss math in f32
        labels = _dt.upcast_16(labels)
        act, lname = self.activation, self.loss
        if act == "softmax" and lname in ("mcxent", "sparse_mcxent"):
            if lname == "sparse_mcxent":
                labels = torch.nn.functional.one_hot(
                    labels.long().reshape(labels.shape[:logits.ndim - 1]),
                    logits.shape[-1]).to(logits.dtype)
            return _loss.softmax_cross_entropy_with_logits(
                labels, logits, mask, weights)
        if act == "sigmoid" and lname == "binary_xent":
            return _loss.sigmoid_binary_xent_with_logits(labels, logits,
                                                         mask, weights)
        preds = _act.get(act)(logits)
        return _loss.get(lname)(labels, preds, mask, weights)


@layer("output")
class OutputLayer(Layer, _BaseOutput):
    """DenseLayer + loss head (DL4J OutputLayer). Inference applies the
    activation to the logits; training returns the logits."""
    decode_pointwise = True
    quantizable = True
    n_out: int = 0
    n_in: Optional[int] = None
    loss: str = "mcxent"
    activation: str = "softmax"
    weight_init: str = "xavier"
    bias_init: float = 0.0
    loss_weights: Optional[Tuple[float, ...]] = None
    l1: float = 0.0
    l2: float = 0.0
    name: Optional[str] = None

    def initialize(self, gen, input_shape, dtype, device):
        n_in = self.n_in or int(input_shape[-1])
        w = _winit.init(self.weight_init, gen, (n_in, self.n_out), n_in,
                        self.n_out, dtype, device)
        b = torch.full((self.n_out,), self.bias_init, dtype=dtype,
                       device=device)
        return {"W": w, "b": b}, {}, tuple(input_shape[:-1]) + (self.n_out,)

    def quantize_spec(self, params):
        return {"W": 1}

    def apply(self, params, x, state, *, train=False, mask=None):
        y = _tp_dense(x, params["W"], params["b"], self.n_out)
        if train:
            return y, state, mask  # the loss consumes the logits
        return _act.get(self.activation)(y), state, mask


@layer("loss")
class LossLayer(Layer, _BaseOutput):
    """Loss head with no params (DL4J LossLayer)."""
    decode_pointwise = True
    loss: str = "mse"
    activation: str = "identity"
    loss_weights: Optional[Tuple[float, ...]] = None
    name: Optional[str] = None

    def has_params(self):
        return False

    def apply(self, params, x, state, *, train=False, mask=None):
        if train:
            return x, state, mask
        return _act.get(self.activation)(x), state, mask
