"""Convolution, pooling and batch-norm layers.

Port of ``ConvolutionLayer``, ``SubsamplingLayer``, ``BatchNormalization``,
``LocalResponseNormalization`` (:249), ``GlobalPoolingLayer``,
``Upsampling2D`` (:321) and ``ZeroPadding2D`` (:355) from
``deeplearning4j_tpu/nn/layers/conv.py``.
Weights are OIHW (``W``) plus ``b`` for every ``data_format``, as in the
JAX package. The convolution is ``F.conv2d``; its bias + activation tail
and the batch-norm normalize + activation run through
``ops.fused_epilogues`` (kernel K1 on the card). A quantized ``W`` (int8
serving) takes ``ops.quantize.int8_conv``, bias in its epilogue, then the
catalog activation: no ``bias_act``, as in the JAX layer.

Batch norm normalizes with the running statistics at inference and with
the batch's (one-pass f32 moments, mask-aware) in training, where it also
returns the new running statistics.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ... import dtypes as _dt
from ...ops import activations as _act
from ...ops import fused_epilogues as _fe
from ...ops import nnops
from ...ops import quantize as _q
from .. import weights as _winit
from .base import Layer, layer


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def _conv_out(size, k, s, p, mode):
    if mode == "same":
        return -(-size // s)  # ceil
    return (size + 2 * p - k) // s + 1


@layer("conv2d")
class ConvolutionLayer(Layer):
    """DL4J ConvolutionLayer (2D). W: [nOut, nIn, kH, kW] (OIHW)."""
    quantizable = True
    n_out: int = 0
    kernel: Tuple[int, int] = (3, 3)
    stride: Tuple[int, int] = (1, 1)
    padding: Tuple[int, int] = (0, 0)
    dilation: Tuple[int, int] = (1, 1)
    mode: str = "truncate"          # DL4J ConvolutionMode: truncate|same|causal
    activation: str = "identity"
    weight_init: str = "relu"
    bias_init: float = 0.0
    has_bias: bool = True
    data_format: str = "NCHW"
    l1: float = 0.0
    l2: float = 0.0
    name: Optional[str] = None

    def _cin(self, input_shape):
        return int(input_shape[0] if self.data_format == "NCHW"
                   else input_shape[-1])

    def initialize(self, gen, input_shape, dtype, device):
        kh, kw = _pair(self.kernel)
        c_in = self._cin(input_shape)
        w = _winit.init(self.weight_init, gen, (self.n_out, c_in, kh, kw),
                        c_in * kh * kw, self.n_out * kh * kw, dtype, device)
        params = {"W": w}
        if self.has_bias:
            params["b"] = torch.full((self.n_out,), self.bias_init,
                                     dtype=dtype, device=device)
        sh, sw = _pair(self.stride)
        ph, pw = _pair(self.padding)
        dh, dw = _pair(self.dilation)
        ke_h, ke_w = (kh - 1) * dh + 1, (kw - 1) * dw + 1
        if self.data_format == "NCHW":
            h, wd = int(input_shape[1]), int(input_shape[2])
            out = (self.n_out, _conv_out(h, ke_h, sh, ph, self.mode),
                   _conv_out(wd, ke_w, sw, pw, self.mode))
        else:
            h, wd = int(input_shape[0]), int(input_shape[1])
            out = (_conv_out(h, ke_h, sh, ph, self.mode),
                   _conv_out(wd, ke_w, sw, pw, self.mode), self.n_out)
        return params, {}, out

    def quantize_spec(self, params):
        return {"W": 0}  # OIHW: one scale per output channel

    def apply(self, params, x, state, *, train=False, mask=None):
        if _q.is_quantized(params["W"]):
            y = _q.int8_conv(x, params["W"], params.get("b"),
                             stride=self.stride, padding=self.padding,
                             dilation=self.dilation, mode=self.mode,
                             data_format=self.data_format)
            return _act.get(self.activation)(y), state, mask
        y = nnops.conv2d(x, params["W"], None, stride=self.stride,
                         padding=self.padding, dilation=self.dilation,
                         mode=self.mode, data_format=self.data_format)
        caxis = 1 if self.data_format == "NCHW" else -1
        return (_fe.bias_act(y, params.get("b"), act=self.activation,
                             axis=caxis), state, mask)


@layer("subsampling2d")
class SubsamplingLayer(Layer):
    """DL4J SubsamplingLayer: max/avg/pnorm pooling, no params."""
    kernel: Tuple[int, int] = (2, 2)
    stride: Optional[Tuple[int, int]] = None  # None = kernel
    padding: Tuple[int, int] = (0, 0)
    pool_type: str = "max"          # max|avg|pnorm
    pnorm: float = 2.0
    mode: str = "truncate"
    data_format: str = "NCHW"
    name: Optional[str] = None

    def has_params(self):
        return False

    def initialize(self, gen, input_shape, dtype, device):
        kh, kw = _pair(self.kernel)
        sh, sw = _pair(self.stride or self.kernel)
        ph, pw = _pair(self.padding)
        if self.data_format == "NCHW":
            c, h, w = (int(s) for s in input_shape)
            out = (c, _conv_out(h, kh, sh, ph, self.mode),
                   _conv_out(w, kw, sw, pw, self.mode))
        else:
            h, w, c = (int(s) for s in input_shape)
            out = (_conv_out(h, kh, sh, ph, self.mode),
                   _conv_out(w, kw, sw, pw, self.mode), c)
        return {}, {}, out

    def apply(self, params, x, state, *, train=False, mask=None):
        k = _pair(self.kernel)
        s = _pair(self.stride or self.kernel)
        if self.pool_type == "max":
            y = nnops.max_pool2d(x, k, s, self.padding, self.mode,
                                 self.data_format)
        elif self.pool_type == "avg":
            y = nnops.avg_pool2d(x, k, s, self.padding, self.mode,
                                 self.data_format)
        elif self.pool_type == "pnorm":
            y = nnops.pnorm_pool2d(x, k, s, self.padding, self.mode,
                                   self.data_format, self.pnorm)
        else:
            raise ValueError(self.pool_type)
        return y, state, mask


@layer("batchnorm")
class BatchNormalization(Layer):
    """DL4J BatchNormalization. Params gamma/beta; state mean/var (running
    statistics, updated in training as
    running = decay*running + (1-decay)*batch)."""
    decay: float = 0.9
    eps: float = 1e-5
    lock_gamma_beta: bool = False
    data_format: str = "NCHW"
    name: Optional[str] = None

    def _caxis(self, ndim):
        return 1 if (self.data_format == "NCHW" and ndim == 4) else -1

    def initialize(self, gen, input_shape, dtype, device):
        n = int(input_shape[0] if (self.data_format == "NCHW"
                                   and len(input_shape) == 3)
                else input_shape[-1])
        params = {} if self.lock_gamma_beta else {
            "gamma": torch.ones(n, dtype=dtype, device=device),
            "beta": torch.zeros(n, dtype=dtype, device=device)}
        state = {"mean": torch.zeros(n, dtype=dtype, device=device),
                 "var": torch.ones(n, dtype=dtype, device=device)}
        return params, state, tuple(input_shape)

    def _batch_moments(self, x, axis, mask):
        """One-pass f32 moments ``E[x^2] - mean^2`` over every axis but the
        channel axis, as the JAX package computes them (one sweep of x for
        both sums); with a ``[B]`` or ``[B, T]`` mask, over the unmasked
        positions only.

        In a data-parallel step the moments are the GLOBAL batch's (the
        JAX step's ``jnp.mean`` over the sharded batch): ``(s1, s2, cnt)``
        are summed over the data group in one differentiable all-reduce
        (its backward is the same all-reduce), and the count is clamped
        after the sum (a rank whose rows are all padding counts 0)."""
        from ...parallel import collectives as _coll
        dp = _coll.data_parallel()
        xs = _dt.upcast_16(x)
        dims = tuple(i for i in range(x.ndim) if i != axis % x.ndim)
        if mask is not None:
            m = mask.to(xs.dtype)
            while m.ndim < xs.ndim:
                m = m[..., None]
            cnt = torch.sum(m.expand(xs.shape), dim=dims)
            s1 = torch.sum(xs * m, dim=dims)
            s2 = torch.sum(torch.square(xs) * m, dim=dims)
        else:
            cnt = 1
            for i in dims:
                cnt *= x.shape[i]
            s1 = torch.sum(xs, dim=dims)
            s2 = torch.sum(torch.square(xs), dim=dims)
        if dp is not None:
            c = s1.shape[0]
            cnt_t = cnt if torch.is_tensor(cnt) else torch.full(
                (c,), float(cnt), dtype=s1.dtype, device=s1.device)
            tot = _coll.all_reduce_sum(torch.cat([s1, s2, cnt_t]), dp.data)
            s1, s2, cnt = tot[:c], tot[c:2 * c], tot[2 * c:]
        if torch.is_tensor(cnt):
            cnt = torch.clamp(cnt, min=1.0)
        mean = s1 / cnt
        var = torch.clamp(s2 / cnt - torch.square(mean), min=0.0)
        return mean, var

    def apply(self, params, x, state, *, train=False, mask=None,
              fold_act=None):
        """``fold_act``: the activation the graph's fold plan merged into
        this epilogue (the following ActivationLayer passes through).

        Training normalizes with the batch statistics (the gradient flows
        through them into x) and returns the new running statistics,
        computed outside autograd; the caller commits them."""
        axis = self._caxis(x.ndim)
        act = fold_act or "identity"
        if not train:
            y = _fe.bn_act(x, params.get("gamma"), params.get("beta"),
                           state["mean"].to(x.dtype),
                           state["var"].to(x.dtype), self.eps, axis, act=act)
            return y, state, mask
        mean, var = self._batch_moments(x, axis, mask)
        d = self.decay
        with torch.no_grad():
            new_state = {
                "mean": (d * state["mean"] + (1 - d) * mean).to(
                    state["mean"].dtype),
                "var": (d * state["var"] + (1 - d) * var).to(
                    state["var"].dtype)}
        y = _fe.bn_act(x, params.get("gamma"), params.get("beta"),
                       mean.to(x.dtype), var.to(x.dtype), self.eps, axis,
                       act=act)
        return y, new_state, mask


@layer("lrn")
class LocalResponseNormalization(Layer):
    """DL4J LocalResponseNormalization (AlexNet-era), cross-channel."""
    k: float = 2.0
    n: int = 5
    alpha: float = 1e-4
    beta: float = 0.75
    data_format: str = "NCHW"
    name: Optional[str] = None

    def has_params(self):
        return False

    def apply(self, params, x, state, *, train=False, mask=None):
        y = nnops.local_response_normalization(x, self.k, self.n, self.alpha,
                                               self.beta, self.data_format)
        return y, state, mask


@layer("global_pool")
class GlobalPoolingLayer(Layer):
    """DL4J GlobalPoolingLayer: collapse spatial/time dims; mask-aware for
    time series. ``pnorm`` is the p exponent for pool_type="pnorm"."""
    pool_type: str = "max"
    data_format: str = "NCHW"
    pnorm: float = 2.0
    name: Optional[str] = None

    def has_params(self):
        return False

    def initialize(self, gen, input_shape, dtype, device):
        if len(input_shape) == 4:  # CNN3D
            n = int(input_shape[0] if self.data_format in ("NCHW", "NCDHW")
                    else input_shape[-1])
        elif len(input_shape) == 3:  # CNN
            n = int(input_shape[0] if self.data_format == "NCHW"
                    else input_shape[-1])
        else:  # RNN [T, F]
            n = int(input_shape[-1])
        return {}, {}, (n,)

    def apply(self, params, x, state, *, train=False, mask=None):
        if x.ndim == 3:  # time series [B,T,F], optional mask [B,T]
            m = torch.ones(x.shape[:2], dtype=x.dtype, device=x.device) \
                if mask is None else mask.to(x.dtype)
            m = m[..., None]
            if self.pool_type == "avg":
                y = torch.sum(x * m, dim=1) / torch.clamp(
                    torch.sum(m, dim=1), min=1.0)
            elif self.pool_type == "max":
                neg = torch.finfo(x.dtype).min
                y = torch.amax(torch.where(m > 0, x, torch.full_like(x, neg)),
                               dim=1)
            elif self.pool_type == "pnorm":
                y = nnops._safe_root(torch.sum((torch.abs(x) * m)
                                               ** self.pnorm, dim=1),
                                     self.pnorm)
            else:
                y = torch.sum(x * m, dim=1)
            return y, state, None
        y = nnops.global_pool(x, self.pool_type, self.data_format,
                              p=self.pnorm)
        return y, state, None


@layer("upsampling2d")
class Upsampling2D(Layer):
    """``interpolation``: "nearest" (DL4J Upsampling2D, repetition) or
    "bilinear" (the Keras UpSampling2D option: ``image.resize_scale``'s
    half-pixel bilinear resize, as ``jax.image.resize`` samples)."""
    size: Tuple[int, int] = (2, 2)
    data_format: str = "NCHW"
    interpolation: str = "nearest"
    name: Optional[str] = None

    def has_params(self):
        return False

    def initialize(self, gen, input_shape, dtype, device):
        sh, sw = _pair(self.size)
        if self.data_format == "NCHW":
            c, h, w = (int(s) for s in input_shape)
            return {}, {}, (c, h * sh, w * sw)
        h, w, c = (int(s) for s in input_shape)
        return {}, {}, (h * sh, w * sw, c)

    def apply(self, params, x, state, *, train=False, mask=None):
        if self.interpolation not in ("nearest", "bilinear"):
            raise ValueError(
                f"Upsampling2D interpolation={self.interpolation!r} not "
                "supported (nearest | bilinear)")
        if self.interpolation == "bilinear":
            from ...ops.random import resize_scale
            y = resize_scale(x, _pair(self.size), method="bilinear",
                             data_format=self.data_format)
            return y, state, mask
        return nnops.upsampling2d(x, self.size, self.data_format), state, mask


@layer("zeropad2d")
class ZeroPadding2D(Layer):
    """``padding``: (pad_h, pad_w) symmetric, or the Keras asymmetric form
    ((top, bottom), (left, right))."""
    padding: Tuple = (1, 1)
    data_format: str = "NCHW"
    name: Optional[str] = None

    def has_params(self):
        return False

    def initialize(self, gen, input_shape, dtype, device):
        pt, pb, pl, pr = nnops._pads4(self.padding)
        if self.data_format == "NCHW":
            c, h, w = (int(s) for s in input_shape)
            return {}, {}, (c, h + pt + pb, w + pl + pr)
        h, w, c = (int(s) for s in input_shape)
        return {}, {}, (h + pt + pb, w + pl + pr, c)

    def apply(self, params, x, state, *, train=False, mask=None):
        return (nnops.zero_padding2d(x, self.padding, self.data_format),
                state, mask)
