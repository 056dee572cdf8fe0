"""The extended convolution family: the ResNet space-to-depth stem,
transposed, separable and depthwise convolution, crop and space/depth
rearrangements, the 1D stack and the locally connected layers.

Port of ``SpaceToDepthStemConv``, ``Deconvolution2D`` (:33),
``SeparableConvolution2D`` (:82), ``DepthwiseConvolution2D`` (:133),
``Cropping2D`` (:179), ``SpaceToDepthLayer`` (:208),
``DepthToSpaceLayer`` (:233), the 1D stack (:258-485: ``Convolution1D``,
``Subsampling1DLayer``, ``Upsampling1D``, ``ZeroPadding1DLayer``,
``Cropping1D``, ``SeparableConvolution1D``) and ``LocallyConnected2D``
and ``LocallyConnected1D`` (:488-543) from
``deeplearning4j_tpu/nn/layers/conv_extra.py``. Weights keep the JAX
package's layouts (OIHW for the convolutions), so its ZIPs load here.

1D convention: recurrent activations are ``[B, T, F]``; the 1D stack
runs the 2D ops on ``[B, 1, T, F]`` NHWC, as the JAX package does.
These layers apply their activation with the catalog function, not the
K1 epilogue, as in the JAX package. Divergence: the dilated convolutions'
``initialize`` reports the output size of the dilated kernel (the JAX
layers' reports the bare kernel's, which their own ``apply`` does not
produce where dilation > 1).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ...ops import activations as _act
from ...ops import nnops
from .. import weights as _winit
from .base import Layer, layer
from .conv import _conv_out, _pair


def _cin(input_shape, data_format):
    return int(input_shape[0] if data_format == "NCHW" else input_shape[-1])


def _hw(input_shape, data_format):
    if data_format == "NCHW":
        return int(input_shape[1]), int(input_shape[2])
    return int(input_shape[0]), int(input_shape[1])


def _chw(c, h, w, data_format):
    return (c, h, w) if data_format == "NCHW" else (h, w, c)


@layer("s2d_stem_conv")
class SpaceToDepthStemConv(Layer):
    """The ResNet stem, a 7x7 stride-2 pad-3 conv over NHWC input, with the
    stored weight ``W: [nOut, nIn, 7, 7]`` (OIHW) of the JAX package's
    layer of the same kind.

    Divergence: the JAX layer computes this conv through a 2x2
    space-to-depth rearrangement (4x4 kernel over ``[B, H/2, W/2, 4C]``),
    which fed the TPU's 128-lane contraction 12 channels instead of 3. The
    port computes the plain 7x7/2 pad-3 conv it re-expresses (numerically
    the same function) and leaves the choice of algorithm to cuDNN.
    """
    n_out: int = 0
    activation: str = "identity"
    weight_init: str = "relu"
    bias_init: float = 0.0
    has_bias: bool = False
    l1: float = 0.0
    l2: float = 0.0
    name: Optional[str] = None

    def initialize(self, gen, input_shape, dtype, device):
        h, w, c_in = (int(s) for s in input_shape)
        if h % 2 or w % 2:
            raise ValueError(
                f"SpaceToDepthStemConv needs even spatial dims, got {h}x{w}")
        params = {"W": _winit.init(self.weight_init, gen,
                                   (self.n_out, c_in, 7, 7), c_in * 49,
                                   self.n_out * 49, dtype, device)}
        if self.has_bias:
            params["b"] = torch.full((self.n_out,), self.bias_init,
                                     dtype=dtype, device=device)
        return params, {}, (h // 2, w // 2, self.n_out)

    def apply(self, params, x, state, *, train=False, mask=None):
        y = nnops.conv2d(x, params["W"], params.get("b"), stride=(2, 2),
                         padding=(3, 3), mode="truncate", data_format="NHWC")
        return _act.get(self.activation)(y), state, mask


@layer("deconv2d")
class Deconvolution2D(Layer):
    """DL4J Deconvolution2D (transposed conv). W: [nOut, nIn, kH, kW]."""
    n_out: int = 0
    kernel: Tuple[int, int] = (2, 2)
    stride: Tuple[int, int] = (1, 1)
    padding: Tuple[int, int] = (0, 0)
    dilation: Tuple[int, int] = (1, 1)
    mode: str = "truncate"
    activation: str = "identity"
    weight_init: str = "relu"
    has_bias: bool = True
    data_format: str = "NCHW"
    l1: float = 0.0
    l2: float = 0.0
    name: Optional[str] = None

    def initialize(self, gen, input_shape, dtype, device):
        kh, kw = _pair(self.kernel)
        c_in = _cin(input_shape, self.data_format)
        params = {"W": _winit.init(self.weight_init, gen,
                                   (self.n_out, c_in, kh, kw), c_in * kh * kw,
                                   self.n_out * kh * kw, dtype, device)}
        if self.has_bias:
            params["b"] = torch.zeros(self.n_out, dtype=dtype, device=device)
        sh, sw = _pair(self.stride)
        ph, pw = _pair(self.padding)

        def out_size(size, k, s, p):
            if self.mode == "same":
                return size * s
            return s * (size - 1) + k - 2 * p
        h, wd = _hw(input_shape, self.data_format)
        return params, {}, _chw(self.n_out, out_size(h, kh, sh, ph),
                                out_size(wd, kw, sw, pw), self.data_format)

    def apply(self, params, x, state, *, train=False, mask=None):
        y = nnops.deconv2d(x, params["W"], params.get("b"), self.stride,
                           self.padding, self.dilation, self.mode,
                           self.data_format)
        return _act.get(self.activation)(y), state, mask


class _DilatedConv(Layer):
    def _out_hw(self, input_shape):
        """The output's spatial size, under the dilated kernel's extent
        (the JAX layers' ``initialize`` uses the bare kernel, so it
        reports a wrong size where dilation > 1; their ``apply`` is
        right)."""
        (kh, kw), (dh, dw) = _pair(self.kernel), _pair(self.dilation)
        sh, sw = _pair(self.stride)
        ph, pw = _pair(self.padding)
        h, wd = _hw(input_shape, self.data_format)
        return (_conv_out(h, (kh - 1) * dh + 1, sh, ph, self.mode),
                _conv_out(wd, (kw - 1) * dw + 1, sw, pw, self.mode))


@layer("separable_conv2d")
class SeparableConvolution2D(_DilatedConv):
    """DL4J SeparableConvolution2D: depthwise then 1x1 pointwise.
    Params: dW [C*mult, 1, kH, kW], pW [nOut, C*mult, 1, 1], b [nOut]."""
    n_out: int = 0
    kernel: Tuple[int, int] = (3, 3)
    stride: Tuple[int, int] = (1, 1)
    padding: Tuple[int, int] = (0, 0)
    dilation: Tuple[int, int] = (1, 1)
    depth_multiplier: int = 1
    mode: str = "truncate"
    activation: str = "identity"
    weight_init: str = "relu"
    has_bias: bool = True
    data_format: str = "NCHW"
    l1: float = 0.0
    l2: float = 0.0
    name: Optional[str] = None

    def initialize(self, gen, input_shape, dtype, device):
        kh, kw = _pair(self.kernel)
        cm = _cin(input_shape, self.data_format) * self.depth_multiplier
        params = {
            "dW": _winit.init(self.weight_init, gen, (cm, 1, kh, kw),
                              kh * kw, kh * kw * self.depth_multiplier,
                              dtype, device),
            "pW": _winit.init(self.weight_init, gen, (self.n_out, cm, 1, 1),
                              cm, self.n_out, dtype, device)}
        if self.has_bias:
            params["b"] = torch.zeros(self.n_out, dtype=dtype, device=device)
        return params, {}, _chw(self.n_out, *self._out_hw(input_shape),
                                self.data_format)

    def apply(self, params, x, state, *, train=False, mask=None):
        y = nnops.separable_conv2d(x, params["dW"], params["pW"],
                                   params.get("b"), self.stride, self.padding,
                                   self.dilation, self.mode, self.data_format)
        return _act.get(self.activation)(y), state, mask


@layer("depthwise_conv2d")
class DepthwiseConvolution2D(_DilatedConv):
    """DL4J DepthwiseConvolution2D. W: [C*mult, 1, kH, kW]."""
    kernel: Tuple[int, int] = (3, 3)
    stride: Tuple[int, int] = (1, 1)
    padding: Tuple[int, int] = (0, 0)
    dilation: Tuple[int, int] = (1, 1)
    depth_multiplier: int = 1
    mode: str = "truncate"
    activation: str = "identity"
    weight_init: str = "relu"
    has_bias: bool = True
    data_format: str = "NCHW"
    l1: float = 0.0
    l2: float = 0.0
    name: Optional[str] = None

    def initialize(self, gen, input_shape, dtype, device):
        kh, kw = _pair(self.kernel)
        cm = _cin(input_shape, self.data_format) * self.depth_multiplier
        params = {"W": _winit.init(self.weight_init, gen, (cm, 1, kh, kw),
                                   kh * kw, kh * kw * self.depth_multiplier,
                                   dtype, device)}
        if self.has_bias:
            params["b"] = torch.zeros(cm, dtype=dtype, device=device)
        return params, {}, _chw(cm, *self._out_hw(input_shape),
                                self.data_format)

    def apply(self, params, x, state, *, train=False, mask=None):
        y = nnops.depthwise_conv2d(x, params["W"], params.get("b"),
                                   self.stride, self.padding, self.dilation,
                                   self.mode, self.data_format)
        return _act.get(self.activation)(y), state, mask


class _NoParams(Layer):
    def has_params(self):
        return False


@layer("cropping2d")
class Cropping2D(_NoParams):
    """DL4J Cropping2D: crop (top, bottom, left, right)."""
    cropping: Tuple[int, int, int, int] = (0, 0, 0, 0)
    data_format: str = "NCHW"
    name: Optional[str] = None

    def initialize(self, gen, input_shape, dtype, device):
        t, b, l, r = self.cropping
        h, w = _hw(input_shape, self.data_format)
        return {}, {}, _chw(_cin(input_shape, self.data_format), h - t - b,
                            w - l - r, self.data_format)

    def apply(self, params, x, state, *, train=False, mask=None):
        t, b, l, r = self.cropping
        if self.data_format == "NCHW":
            y = x[:, :, t:x.shape[2] - b, l:x.shape[3] - r]
        else:
            y = x[:, t:x.shape[1] - b, l:x.shape[2] - r, :]
        return y, state, mask


@layer("space_to_depth")
class SpaceToDepthLayer(_NoParams):
    """DL4J SpaceToDepthLayer (block rearrange HxW -> channels)."""
    block_size: int = 2
    data_format: str = "NCHW"
    name: Optional[str] = None

    def initialize(self, gen, input_shape, dtype, device):
        bs = self.block_size
        h, w = _hw(input_shape, self.data_format)
        return {}, {}, _chw(_cin(input_shape, self.data_format) * bs * bs,
                            h // bs, w // bs, self.data_format)

    def apply(self, params, x, state, *, train=False, mask=None):
        return (nnops.space_to_depth(x, self.block_size, self.data_format),
                state, mask)


@layer("depth_to_space")
class DepthToSpaceLayer(_NoParams):
    block_size: int = 2
    data_format: str = "NCHW"
    name: Optional[str] = None

    def initialize(self, gen, input_shape, dtype, device):
        bs = self.block_size
        h, w = _hw(input_shape, self.data_format)
        return {}, {}, _chw(_cin(input_shape, self.data_format) // (bs * bs),
                            h * bs, w * bs, self.data_format)

    def apply(self, params, x, state, *, train=False, mask=None):
        return (nnops.depth_to_space(x, self.block_size, self.data_format),
                state, mask)


# ---- 1D stack over [B, T, F] ------------------------------------------------

class _Conv1DBase(Layer):
    """Shared [B,T,F] <-> [B,1,T,F]-NHWC plumbing."""

    def _to2d(self, x):
        return x[:, None, :, :]

    def _from2d(self, y):
        return y[:, 0, :, :]


def _t_out(t, k, s, p, mode):
    return _conv_out(t, k, s, p, mode) if t > 0 else t


@layer("conv1d")
class Convolution1D(_Conv1DBase):
    """DL4J Convolution1DLayer over [B,T,F]. W: [nOut, nIn, 1, k]."""
    n_out: int = 0
    kernel: int = 3
    stride: int = 1
    padding: int = 0
    dilation: int = 1
    mode: str = "truncate"
    activation: str = "identity"
    weight_init: str = "relu"
    has_bias: bool = True
    l1: float = 0.0
    l2: float = 0.0
    name: Optional[str] = None

    def initialize(self, gen, input_shape, dtype, device):
        t, f = int(input_shape[0]), int(input_shape[1])
        k = int(self.kernel)
        params = {"W": _winit.init(self.weight_init, gen, (self.n_out, f, 1, k),
                                   f * k, self.n_out * k, dtype, device)}
        if self.has_bias:
            params["b"] = torch.zeros(self.n_out, dtype=dtype, device=device)
        return params, {}, (_t_out(t, (k - 1) * self.dilation + 1, self.stride,
                                   self.padding, self.mode), self.n_out)

    def apply(self, params, x, state, *, train=False, mask=None):
        y = nnops.conv2d(self._to2d(x), params["W"], params.get("b"),
                         stride=(1, self.stride), padding=(0, self.padding),
                         dilation=(1, self.dilation), mode=self.mode,
                         data_format="NHWC")
        y = _act.get(self.activation)(self._from2d(y))
        keep = mask is not None and self.stride == 1 and self.mode == "same"
        return y, state, mask if keep else None


@layer("subsampling1d")
class Subsampling1DLayer(_Conv1DBase):
    kernel: int = 2
    stride: Optional[int] = None
    padding: int = 0
    pool_type: str = "max"
    mode: str = "truncate"
    name: Optional[str] = None

    def has_params(self):
        return False

    def initialize(self, gen, input_shape, dtype, device):
        t, f = int(input_shape[0]), int(input_shape[1])
        s = self.stride or self.kernel
        return {}, {}, (_t_out(t, self.kernel, s, self.padding, self.mode), f)

    def apply(self, params, x, state, *, train=False, mask=None):
        s = self.stride or self.kernel
        fn = nnops.max_pool2d if self.pool_type == "max" else nnops.avg_pool2d
        y = fn(self._to2d(x), (1, self.kernel), (1, s), (0, self.padding),
               self.mode, "NHWC")
        # the mask is dropped, as the JAX layer drops it
        return self._from2d(y), state, None


@layer("upsampling1d")
class Upsampling1D(_Conv1DBase):
    size: int = 2
    name: Optional[str] = None

    def has_params(self):
        return False

    def initialize(self, gen, input_shape, dtype, device):
        t, f = int(input_shape[0]), int(input_shape[1])
        return {}, {}, (t * self.size if t > 0 else t, f)

    def apply(self, params, x, state, *, train=False, mask=None):
        return torch.repeat_interleave(x, self.size, dim=1), state, None


@layer("zeropad1d")
class ZeroPadding1DLayer(_Conv1DBase):
    padding: Tuple[int, int] = (1, 1)
    name: Optional[str] = None

    def has_params(self):
        return False

    def initialize(self, gen, input_shape, dtype, device):
        t, f = int(input_shape[0]), int(input_shape[1])
        lo, hi = _pair(self.padding)
        return {}, {}, (t + lo + hi if t > 0 else t, f)

    def apply(self, params, x, state, *, train=False, mask=None):
        lo, hi = _pair(self.padding)
        y = torch.nn.functional.pad(x, (0, 0, lo, hi))
        new_mask = None
        if mask is not None and mask.ndim == 2:
            new_mask = torch.nn.functional.pad(mask, (lo, hi))
        return y, state, new_mask


@layer("cropping1d")
class Cropping1D(_Conv1DBase):
    cropping: Tuple[int, int] = (1, 1)
    name: Optional[str] = None

    def has_params(self):
        return False

    def initialize(self, gen, input_shape, dtype, device):
        t, f = int(input_shape[0]), int(input_shape[1])
        lo, hi = _pair(self.cropping)
        return {}, {}, (t - lo - hi if t > 0 else t, f)

    def apply(self, params, x, state, *, train=False, mask=None):
        lo, hi = _pair(self.cropping)
        y = x[:, lo:x.shape[1] - hi, :]
        new_mask = None
        if mask is not None and mask.ndim == 2:
            new_mask = mask[:, lo:mask.shape[1] - hi]
        return y, state, new_mask


@layer("separable_conv1d")
class SeparableConvolution1D(_Conv1DBase):
    """Depthwise-then-pointwise conv over [B,T,F] (Keras ``SeparableConv1D``)
    through the 2D separable op with a height-1 axis. Params: dW [F*mult,
    1, 1, k], pW [nOut, F*mult, 1, 1], b [nOut]."""
    n_out: int = 0
    kernel: int = 3
    stride: int = 1
    padding: int = 0
    dilation: int = 1
    depth_multiplier: int = 1
    mode: str = "truncate"
    activation: str = "identity"
    weight_init: str = "relu"
    has_bias: bool = True
    l1: float = 0.0
    l2: float = 0.0
    name: Optional[str] = None

    def initialize(self, gen, input_shape, dtype, device):
        t, f = int(input_shape[0]), int(input_shape[1])
        k = int(self.kernel)
        cm = f * self.depth_multiplier
        params = {
            "dW": _winit.init(self.weight_init, gen, (cm, 1, 1, k), k,
                              k * self.depth_multiplier, dtype, device),
            "pW": _winit.init(self.weight_init, gen, (self.n_out, cm, 1, 1),
                              cm, self.n_out, dtype, device)}
        if self.has_bias:
            params["b"] = torch.zeros(self.n_out, dtype=dtype, device=device)
        return params, {}, (_t_out(t, (k - 1) * self.dilation + 1, self.stride,
                                   self.padding, self.mode), self.n_out)

    def apply(self, params, x, state, *, train=False, mask=None):
        y = nnops.separable_conv2d(
            self._to2d(x), params["dW"], params["pW"], params.get("b"),
            (1, self.stride), (0, self.padding), (1, self.dilation),
            self.mode, "NHWC")
        y = _act.get(self.activation)(self._from2d(y))
        keep = mask is not None and self.stride == 1 and self.mode == "same"
        return y, state, mask if keep else None


# ---- locally connected ------------------------------------------------------

@layer("locally_connected2d")
class LocallyConnected2D(Layer):
    """DL4J LocallyConnected2D: a convolution with weights of its own at
    every output position. W: [H_out*W_out, kH*kW*nIn, nOut] (patches in
    (kh, kw, c) order), b: [H_out*W_out, nOut]. NHWC only."""
    n_out: int = 0
    kernel: Tuple[int, int] = (3, 3)
    stride: Tuple[int, int] = (1, 1)
    activation: str = "identity"
    weight_init: str = "xavier"
    has_bias: bool = True
    l1: float = 0.0
    l2: float = 0.0
    name: Optional[str] = None

    def _out(self, h, w):
        kh, kw = _pair(self.kernel)
        sh, sw = _pair(self.stride)
        return (h - kh) // sh + 1, (w - kw) // sw + 1

    def initialize(self, gen, input_shape, dtype, device):
        h, w, c = (int(s) for s in input_shape)
        kh, kw = _pair(self.kernel)
        ho, wo = self._out(h, w)
        fan_in = c * kh * kw
        params = {"W": _winit.init(self.weight_init, gen,
                                   (ho * wo, fan_in, self.n_out), fan_in,
                                   self.n_out, dtype, device)}
        if self.has_bias:
            params["b"] = torch.zeros(ho * wo, self.n_out, dtype=dtype,
                                      device=device)
        return params, {}, (ho, wo, self.n_out)

    def apply(self, params, x, state, *, train=False, mask=None):
        kh, kw = _pair(self.kernel)
        sh, sw = _pair(self.stride)
        B, H, W, C = x.shape
        ho, wo = self._out(H, W)
        # [B, ho, wo, C, kh, kw] windows -> [B, P, kh*kw*C]
        p = x.unfold(1, kh, sh).unfold(2, kw, sw)
        p = p.permute(0, 1, 2, 4, 5, 3).reshape(B, ho * wo, kh * kw * C)
        y = torch.einsum("bpf,pfo->bpo", p, params["W"])
        if "b" in params:
            y = y + params["b"][None]
        y = y.reshape(B, ho, wo, self.n_out)
        return _act.get(self.activation)(y), state, mask


@layer("locally_connected1d")
class LocallyConnected1D(_Conv1DBase):
    """DL4J LocallyConnected1D over [B,T,F]: filters of its own at every
    output step. W: [T_out, k*F, nOut], b: [T_out, nOut]."""
    n_out: int = 0
    kernel: int = 3
    stride: int = 1
    activation: str = "identity"
    weight_init: str = "xavier"
    has_bias: bool = True
    l1: float = 0.0
    l2: float = 0.0
    name: Optional[str] = None

    def initialize(self, gen, input_shape, dtype, device):
        t, f = int(input_shape[0]), int(input_shape[1])
        k, s = int(self.kernel), int(self.stride)
        to = (t - k) // s + 1
        params = {"W": _winit.init(self.weight_init, gen,
                                   (to, f * k, self.n_out), f * k,
                                   self.n_out, dtype, device)}
        if self.has_bias:
            params["b"] = torch.zeros(to, self.n_out, dtype=dtype,
                                      device=device)
        return params, {}, (to, self.n_out)

    def apply(self, params, x, state, *, train=False, mask=None):
        k, s = int(self.kernel), int(self.stride)
        B, T, F = x.shape
        to = (T - k) // s + 1
        # [B, to, F, k] windows -> [B, to, k*F]
        p = x.unfold(1, k, s).permute(0, 1, 3, 2).reshape(B, to, k * F)
        y = torch.einsum("btf,tfo->bto", p, params["W"])
        if "b" in params:
            y = y + params["b"][None]
        return _act.get(self.activation)(y), state, None
