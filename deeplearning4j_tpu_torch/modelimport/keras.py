"""Keras model import: ``.h5`` (Keras 2 and the Keras 3 legacy writer),
the ``.keras`` v3 archive, and config-only import.

Port of ``deeplearning4j_tpu/modelimport/keras.py``. The same two-stage
contract as DL4J's ``KerasModelImport``: (1) the ``model_config`` JSON
maps through a per-class mapper registry (``_MAPPERS``, the JAX module's
:580-671) into the port's layer configs, a Sequential to a
MultiLayerNetwork and a Functional model to a ComputationGraph; (2) the
weights are copied layer by layer, with the layout transposes of the JAX
mappers. The model stays NHWC (channels_last), as in the JAX package.

The files are read by the port's own HDF5 reader (``hdf5.py``), not
h5py: importing loads neither h5py, Keras nor TensorFlow. The entry
points build the network on ``device`` (``cuda`` unless the caller
passes ``device="cpu"``; they raise without CUDA).

A mapper whose target layer kind the port does not have yet (the 3D
convolution family, ``LayerNormalization``, ``PReLU`` and the noise and
spatial dropout layers) raises ``NotImplementedError`` naming ROADMAP
Queue 1 item 10 and the kind; it never maps to another layer. Every
refusal of the JAX importer (an unsupported class, activation or
configuration) is raised here with the same exception type. One refusal
is the port's own: a grouped ``Conv2D`` (``groups`` > 1), which the JAX
mapper does not check.
"""

from __future__ import annotations

import json
import os
import re
import zipfile
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import environment as _env
from ..nn.config import InputType, NeuralNetConfiguration
from ..nn.layers.conv import (BatchNormalization, ConvolutionLayer,
                              GlobalPoolingLayer, SubsamplingLayer,
                              Upsampling2D, ZeroPadding2D)
from ..nn.layers.core import (ActivationLayer, DenseLayer, DropoutLayer,
                              EmbeddingLayer, FlattenLayer)
from ..nn.layers.recurrent import GRU, LSTM, Bidirectional, SimpleRnn
from ..utils.convert import tensor_from_numpy
from . import hdf5

_ACT = {"linear": "identity", "relu": "relu", "relu6": "relu6",
        "tanh": "tanh", "sigmoid": "sigmoid", "hard_sigmoid": "hardsigmoid",
        "softmax": "softmax", "softplus": "softplus", "softsign": "softsign",
        "elu": "elu", "selu": "selu", "gelu": "gelu", "swish": "swish",
        "silu": "swish", "mish": "mish", "exponential": None, "None": "identity"}


def _act(name: Optional[str]) -> str:
    if name is None:
        return "identity"
    mapped = _ACT.get(str(name))
    if mapped is None:
        raise ValueError(f"unsupported Keras activation {name!r}")
    return mapped


def _pair(v) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def _one(v):
    return v[0] if isinstance(v, (list, tuple)) else v


def _padding_mode(cfg, cls) -> str:
    pad = cfg.get("padding", "valid")
    if pad not in ("valid", "same"):
        raise ValueError(f"{cls} padding={pad!r} not supported")
    return "same" if pad == "same" else "truncate"


def _check_channels_last(cfg: dict, cls: str):
    df = cfg.get("data_format", "channels_last")
    if df not in (None, "channels_last"):
        raise ValueError(
            f"{cls} with data_format={df!r}: only channels_last imports "
            "(NHWC); convert the model or permute inputs")


def _not_ported(cls: str, kind: str):
    """The mapper of a Keras class whose target layer kind the port lacks."""
    def mapper(cfg):
        raise NotImplementedError(
            f"Keras {cls}: its target layer kind {kind!r} is not in the "
            "PyTorch port yet (ROADMAP Queue 1 item 10)")
    return mapper


class _Mapped:
    """One imported layer: the port's layer object, plus how to map its
    Keras weight list into the port's param dict, and the structural
    marker of a recurrent layer (``("lstm" | "rnn", kwargs)``)."""

    def __init__(self, layer=None, weights: Optional[Callable] = None,
                 vertex: Optional[tuple] = None):
        self.layer = layer
        self.weights = weights          # fn(list[np.ndarray]) -> params dict
        self.vertex = vertex


def _bias_out(cfg, ws, out, i):
    if cfg.get("use_bias", True):
        out["b"] = ws[i]
    return out


def _map_dense(cfg) -> _Mapped:
    lyr = DenseLayer(n_out=int(cfg["units"]),
                     activation=_act(cfg.get("activation")))

    def w(ws):
        if cfg.get("use_bias", True):
            k, b = ws
        else:
            (k,), b = ws, np.zeros(cfg["units"], np.float32)
        return {"W": k, "b": b}  # Keras kernel [in, out] is the port's
    return _Mapped(lyr, w)


def _map_conv2d(cfg) -> _Mapped:
    _check_channels_last(cfg, "Conv2D")
    if int(cfg.get("groups", 1)) != 1:
        # the JAX mapper ignores groups (a grouped kernel then fails its
        # shape check or imports wrong); the port refuses it
        raise ValueError(f"Conv2D groups={cfg['groups']} not supported")
    same = cfg.get("padding", "valid") == "same"
    lyr = ConvolutionLayer(
        n_out=int(cfg["filters"]), kernel=_pair(cfg["kernel_size"]),
        stride=_pair(cfg.get("strides", 1)),
        dilation=_pair(cfg.get("dilation_rate", 1)),
        mode="same" if same else "truncate",
        activation=_act(cfg.get("activation")),
        has_bias=cfg.get("use_bias", True), data_format="NHWC")
    # HWIO -> OIHW
    return _Mapped(lyr, lambda ws: _bias_out(
        cfg, ws, {"W": ws[0].transpose(3, 2, 0, 1)}, 1))


def _map_pool(cfg, pool_type: str) -> _Mapped:
    _check_channels_last(cfg, "Pooling2D")
    same = cfg.get("padding", "valid") == "same"
    k = _pair(cfg.get("pool_size", 2))
    s = _pair(cfg["strides"]) if cfg.get("strides") else k
    return _Mapped(SubsamplingLayer(kernel=k, stride=s, pool_type=pool_type,
                                    mode="same" if same else "truncate",
                                    data_format="NHWC"))


def _map_bn(cfg) -> _Mapped:
    lyr = BatchNormalization(eps=float(cfg.get("epsilon", 1e-3)),
                             decay=float(cfg.get("momentum", 0.99)),
                             data_format="NHWC")
    scale = cfg.get("scale", True)
    center = cfg.get("center", True)

    def w(ws):
        ws = list(ws)
        params = {"gamma": ws.pop(0) if scale else np.ones_like(ws[-1]),
                  "beta": ws.pop(0) if center else np.zeros_like(ws[-1])}
        return {"__params__": params,
                "__state__": {"mean": ws[0], "var": ws[1]}}
    return _Mapped(lyr, w)


def _check_go_backwards(cfg, cls):
    # a standalone reversed layer has no forward twin to pair with
    if cfg.get("go_backwards"):
        raise ValueError(
            f"standalone {cls} with go_backwards=True not supported "
            "(wrap in Bidirectional or reverse the time axis upstream)")


def _keras_gates(m):
    """Keras gate order [i, f, c(g), o] -> the port's [i, f, o, g]."""
    blocks = np.split(np.asarray(m), 4, axis=-1)
    return np.concatenate([blocks[0], blocks[1], blocks[3], blocks[2]],
                          axis=-1)


def _map_lstm(cfg) -> _Mapped:
    if cfg.get("return_state"):
        raise ValueError("LSTM return_state not supported in import")
    _check_go_backwards(cfg, "LSTM")
    if _act(cfg.get("activation", "tanh")) != "tanh" or \
            cfg.get("recurrent_activation", "sigmoid") != "sigmoid":
        raise ValueError("only tanh/sigmoid LSTM variants import")
    # the Keras bias already holds unit_forget_bias: no runtime forget bias
    u = int(cfg["units"])
    lyr = LSTM(n_out=u, forget_bias=0.0)

    def w(ws):
        b = ws[2] if len(ws) > 2 else np.zeros(4 * u, np.float32)
        return {"W": _keras_gates(ws[0]), "RW": _keras_gates(ws[1]),
                "b": _keras_gates(b)}
    return _Mapped(lyr, w, vertex=("lstm", {
        "return_sequences": bool(cfg.get("return_sequences", False))}))


def _map_gru(cfg) -> _Mapped:
    if cfg.get("return_state"):
        raise ValueError("GRU return_state not supported in import")
    _check_go_backwards(cfg, "GRU")
    if _act(cfg.get("activation", "tanh")) != "tanh" or \
            cfg.get("recurrent_activation", "sigmoid") != "sigmoid":
        raise ValueError("only tanh/sigmoid GRU variants import")
    reset_after = bool(cfg.get("reset_after", True))
    u = int(cfg["units"])
    lyr = GRU(n_out=u, reset_after=reset_after)

    def w(ws):
        k, rk = ws[0], ws[1]  # Keras gate order [z, r, h] is the port's
        if reset_after:
            b = ws[2] if len(ws) > 2 else np.zeros((2, 3 * u), np.float32)
            b = np.asarray(b).reshape(2, 3 * u)
            return {"W": k, "RW": rk, "b": b[0], "rb": b[1]}
        b = ws[2] if len(ws) > 2 else np.zeros(3 * u, np.float32)
        return {"W": k, "RW": rk, "b": b}

    return _Mapped(lyr, w, vertex=("rnn", {
        "return_sequences": bool(cfg.get("return_sequences", False))}))


def _map_bidirectional(cfg) -> _Mapped:
    inner_cfg = cfg["layer"]
    inner_cls = inner_cfg["class_name"]
    if inner_cls not in ("LSTM", "GRU", "SimpleRNN"):
        raise ValueError(
            f"Bidirectional around {inner_cls!r} not supported")
    fwd_cfg = dict(inner_cfg["config"])
    if fwd_cfg.get("go_backwards"):
        # the forward layer reversed would swap the output streams
        raise ValueError(
            "Bidirectional with go_backwards=True on the forward layer "
            "not supported")
    bwd = cfg.get("backward_layer")
    if bwd is not None:
        # Keras 3 always writes the backward copy: only the mirrored
        # default (the same config up to name and go_backwards) imports
        def norm(c):
            c = dict(c)
            c.pop("name", None)
            c.pop("go_backwards", None)
            return c
        bwd_cfg = dict(bwd.get("config", {}))
        if (bwd.get("class_name") != inner_cls
                or not bwd_cfg.get("go_backwards", False)
                or norm(bwd_cfg) != norm(fwd_cfg)):
            raise ValueError(
                "Bidirectional with a non-mirrored backward_layer config "
                "is not supported (only the default mirrored form)")
    inner_imp = dict(fwd_cfg)
    inner_imp.pop("go_backwards", None)  # the wrapper owns the direction
    inner = _MAPPERS[inner_cls](inner_imp)
    merge = {"concat": "concat", "sum": "add", "mul": "mul",
             "ave": "average"}.get(cfg.get("merge_mode", "concat"))
    if merge is None:
        raise ValueError(
            f"Bidirectional merge_mode={cfg.get('merge_mode')!r} "
            "not supported (concat/sum/mul/ave)")
    # return_sequences=False lives on the wrapper: each direction's own
    # last step is merged
    rs = bool(inner_cfg["config"].get("return_sequences", False))
    lyr = Bidirectional(layer=inner.layer, mode=merge, return_sequences=rs)

    def w(ws):
        ws = list(ws)
        if len(ws) % 2:
            raise ValueError(
                f"Bidirectional expects paired fw/bw weights, got {len(ws)}")
        half = len(ws) // 2
        return {"fw": inner.weights(ws[:half]),
                "bw": inner.weights(ws[half:])}

    return _Mapped(lyr, w, vertex=("rnn", {"return_sequences": True}))


def _map_simple_rnn(cfg) -> _Mapped:
    _check_go_backwards(cfg, "SimpleRNN")
    u = int(cfg["units"])
    lyr = SimpleRnn(n_out=u, activation=_act(cfg.get("activation", "tanh")))

    def w(ws):
        b = ws[2] if len(ws) > 2 else np.zeros(u, np.float32)
        return {"W": ws[0], "RW": ws[1], "b": b}
    return _Mapped(lyr, w, vertex=("rnn", {
        "return_sequences": bool(cfg.get("return_sequences", False))}))


def _map_cudnn_lstm(cfg) -> _Mapped:
    """tf.compat.v1 CuDNNLSTM: an LSTM whose double bias (input and
    recurrent halves, [2, 4u] or flat [8u]) sums into one."""
    cfg = dict(cfg)
    cfg.setdefault("activation", "tanh")
    cfg.setdefault("recurrent_activation", "sigmoid")
    base = _map_lstm(cfg)
    u = int(cfg["units"])

    def w(ws):
        ws = list(ws)
        if len(ws) > 2 and np.asarray(ws[2]).size == 8 * u:
            b2 = np.asarray(ws[2]).reshape(2, 4 * u)
            ws[2] = b2[0] + b2[1]
        return base.weights(ws)

    return _Mapped(base.layer, w, vertex=base.vertex)


def _map_cudnn_gru(cfg) -> _Mapped:
    """tf.compat.v1 CuDNNGRU: GRU(reset_after=True), its double bias
    already in the [2, 3u] layout."""
    cfg = dict(cfg)
    cfg.setdefault("activation", "tanh")
    cfg.setdefault("recurrent_activation", "sigmoid")
    cfg["reset_after"] = True
    return _map_gru(cfg)


def _map_conv1d(cfg) -> _Mapped:
    from ..nn.layers.conv_extra import Convolution1D
    if cfg.get("data_format", "channels_last") != "channels_last":
        raise ValueError("Conv1D channels_first not supported")
    lyr = Convolution1D(
        n_out=int(cfg["filters"]), kernel=int(_one(cfg["kernel_size"])),
        stride=int(_one(cfg.get("strides", 1))),
        dilation=int(_one(cfg.get("dilation_rate", 1))),
        mode=_padding_mode(cfg, "Conv1D"),
        activation=_act(cfg.get("activation")),
        has_bias=bool(cfg.get("use_bias", True)))

    def w(ws):
        # Keras kernel [k, in, out] -> [out, in, 1, k]
        out = {"W": np.transpose(np.asarray(ws[0]), (2, 1, 0))[:, :, None, :]}
        if len(ws) > 1:
            out["b"] = ws[1]
        return out

    return _Mapped(lyr, w)


def _map_conv2d_transpose(cfg) -> _Mapped:
    from ..nn.layers.conv_extra import Deconvolution2D
    _check_channels_last(cfg, "Conv2DTranspose")
    mode = _padding_mode(cfg, "Conv2DTranspose")
    if tuple(_pair(cfg.get("dilation_rate", 1))) != (1, 1):
        raise ValueError("Conv2DTranspose dilation != 1 not supported")
    if cfg.get("output_padding") not in (None,):
        raise ValueError("Conv2DTranspose explicit output_padding "
                         "not supported")
    lyr = Deconvolution2D(
        n_out=int(cfg["filters"]), kernel=_pair(cfg["kernel_size"]),
        stride=_pair(cfg.get("strides", 1)), mode=mode,
        activation=_act(cfg.get("activation")),
        has_bias=bool(cfg.get("use_bias", True)), data_format="NHWC")

    def w(ws):
        # Keras kernel [kH, kW, out, in] -> [out, in, kH, kW]
        out = {"W": np.transpose(np.asarray(ws[0]), (2, 3, 0, 1))}
        if len(ws) > 1:
            out["b"] = ws[1]
        return out

    return _Mapped(lyr, w)


def _map_multi_head_attention(cfg) -> _Mapped:
    """Keras MultiHeadAttention in the self-attention arrangement (query,
    value and key the same tensor), onto SelfAttentionLayer with
    per-projection biases."""
    from ..nn.layers.attention import SelfAttentionLayer
    heads = int(cfg["num_heads"])
    key_dim = int(cfg["key_dim"])
    if cfg.get("value_dim") not in (None, key_dim):
        raise ValueError("MultiHeadAttention value_dim != key_dim "
                         "not supported")
    if cfg.get("attention_axes") not in (None, [1], (1,)):
        raise ValueError("MultiHeadAttention attention_axes beyond the "
                         "time axis not supported")
    use_bias = bool(cfg.get("use_bias", True))
    oshape = cfg.get("output_shape")
    if isinstance(oshape, (list, tuple)):
        oshape = oshape[-1] if oshape else None
    # n_out=0: the input feature dim at init (Keras' default)
    lyr = SelfAttentionLayer(n_out=int(oshape) if oshape else 0,
                             n_heads=heads, head_size=key_dim,
                             has_bias=use_bias)

    def w(ws):
        ws = [np.asarray(a) for a in ws]
        if use_bias:
            kq, bq, kk, bk, kv, bv, ko, bo = ws
        else:
            kq, kk, kv, ko = ws
        f = kq.shape[0]
        proj = heads * key_dim
        out = {"Wq": kq.reshape(f, proj), "Wk": kk.reshape(f, proj),
               "Wv": kv.reshape(f, proj),
               "Wo": ko.reshape(proj, ko.shape[-1])}
        if use_bias:
            out.update({"bq": bq.reshape(proj), "bk": bk.reshape(proj),
                        "bv": bv.reshape(proj), "bo": bo.reshape(-1)})
        return out

    return _Mapped(lyr, w)


def _map_pool1d(cfg, pool_type: str) -> _Mapped:
    from ..nn.layers.conv_extra import Subsampling1DLayer
    mode = _padding_mode(cfg, "Pooling1D")
    return _Mapped(Subsampling1DLayer(
        kernel=int(_one(cfg.get("pool_size", 2))),
        stride=int(_one(cfg.get("strides") or cfg.get("pool_size", 2))),
        pool_type=pool_type, mode=mode))


#: name -> Layer instance; Keras Lambdas serialize arbitrary Python, so
#: the user registers the equivalent layer under the Lambda layer's name
#: (DL4J's KerasLayer.registerLambdaLayer)
_LAMBDA_LAYERS: Dict[str, Any] = {}


def register_lambda_layer(name: str, layer) -> None:
    _LAMBDA_LAYERS[name] = layer


def register_custom_layer(class_name: str, mapper: Callable) -> None:
    """Register an import mapper for a custom Keras layer class
    (``KerasLayer.registerCustomLayer``): ``mapper(config_dict) ->
    _Mapped`` (or anything exposing ``.layer``/``.weights``/``.vertex``)."""
    _MAPPERS[class_name] = mapper


def _map_lambda(cfg) -> _Mapped:
    name = cfg.get("name")
    if name in _LAMBDA_LAYERS:
        return _Mapped(_LAMBDA_LAYERS[name])
    raise ValueError(
        f"Lambda layer {name!r}: Keras Lambdas serialize arbitrary Python "
        "and cannot be imported mechanically — call "
        "modelimport.keras.register_lambda_layer({name!r}, <equivalent "
        "Layer>) before importing (reference: KerasLayer."
        "registerLambdaLayer)")


def _map_relu(cfg) -> _Mapped:
    mv = cfg.get("max_value")
    if cfg.get("negative_slope") or cfg.get("threshold"):
        raise ValueError("ReLU with negative_slope/threshold not supported — "
                         "import as LeakyReLU/ThresholdedReLU instead")
    if mv in (None, 0):
        return _Mapped(ActivationLayer(activation="relu"))
    if float(mv) == 6.0:
        return _Mapped(ActivationLayer(activation="relu6"))
    raise ValueError(f"ReLU max_value={mv} not supported (only None/6.0)")


def _upsample_interp(cfg) -> str:
    interp = cfg.get("interpolation", "nearest")
    if interp not in ("nearest", "bilinear"):
        raise ValueError(
            f"UpSampling2D interpolation={interp!r} not supported")
    return interp


def _map_zeropad(cfg) -> _Mapped:
    p = cfg["padding"]
    if isinstance(p, int):
        pad = (p, p)
    else:
        ph, pw = p
        if isinstance(ph, (list, tuple)):
            # ((top, bottom), (left, right)): legacy ResNet/Inception
            # exports pad (0, 1)
            pad = ((int(ph[0]), int(ph[1])), (int(pw[0]), int(pw[1])))
        else:
            pad = (int(ph), int(pw))
    return _Mapped(ZeroPadding2D(padding=pad, data_format="NHWC"))


def _map_embedding(cfg) -> _Mapped:
    lyr = EmbeddingLayer(n_in=int(cfg["input_dim"]),
                         n_out=int(cfg["output_dim"]))
    return _Mapped(lyr, lambda ws: {"W": ws[0]})


def _map_structural(cls_name: str, **kw) -> _Mapped:
    from ..nn.layers import core as _core_layers
    return _Mapped(getattr(_core_layers, cls_name)(**kw))


def _map_wrapper(cls_name: str, **kw) -> _Mapped:
    from ..nn.layers import wrappers as _wrap
    return _Mapped(getattr(_wrap, cls_name)(**kw))


def _map_time_distributed(cfg) -> _Mapped:
    from ..nn.layers.wrappers import TimeDistributed
    inner_cfg = cfg["layer"]
    inner_cls = inner_cfg["class_name"]
    if inner_cls not in _MAPPERS:
        raise ValueError(
            f"TimeDistributed around unmapped layer {inner_cls!r}")
    inner = _MAPPERS[inner_cls](inner_cfg["config"])
    if inner.vertex is not None:
        raise ValueError(
            f"TimeDistributed around recurrent layer {inner_cls!r} "
            "not supported")
    return _Mapped(TimeDistributed(layer=inner.layer), inner.weights)


def _map_convlstm2d(cfg) -> _Mapped:
    from ..nn.layers.recurrent import ConvLSTM2D
    _check_go_backwards(cfg, "ConvLSTM2D")
    if cfg.get("data_format", "channels_last") != "channels_last":
        raise ValueError("ConvLSTM2D channels_first not supported")
    if cfg.get("stateful"):
        raise ValueError("stateful ConvLSTM2D not supported in import")
    if tuple(_pair(cfg.get("dilation_rate", 1))) != (1, 1):
        raise ValueError("dilated ConvLSTM2D not supported")
    if cfg.get("return_state"):
        raise ValueError("ConvLSTM2D return_state not supported in import")
    act = _act(cfg.get("activation", "tanh"))
    gate = {"sigmoid": "sigmoid", "hard_sigmoid": "hardsigmoid"}.get(
        cfg.get("recurrent_activation", "hard_sigmoid"))
    if act != "tanh" or gate is None:
        raise ValueError("only tanh/(hard_)sigmoid ConvLSTM2D variants "
                         "import")
    mode = _padding_mode(cfg, "ConvLSTM2D")
    f = int(cfg["filters"])
    lyr = ConvLSTM2D(
        n_out=f, kernel=_pair(cfg["kernel_size"]),
        stride=_pair(cfg.get("strides", 1)), mode=mode,
        return_sequences=bool(cfg.get("return_sequences", False)),
        activation="tanh", gate_activation=gate)

    def w(ws):
        # [kh, kw, cin, 4f] -> OIHW [4f, cin, kh, kw]
        k = np.transpose(_keras_gates(ws[0]), (3, 2, 0, 1))
        rk = np.transpose(_keras_gates(ws[1]), (3, 2, 0, 1))
        b = _keras_gates(ws[2]) if len(ws) > 2 \
            else np.zeros(4 * f, np.float32)
        return {"W": k, "RW": rk, "b": b}
    return _Mapped(lyr, w)


def _map_separable1d(cfg) -> _Mapped:
    from ..nn.layers.conv_extra import SeparableConvolution1D
    if cfg.get("data_format", "channels_last") != "channels_last":
        raise ValueError("SeparableConv1D channels_first not supported")
    mode = _padding_mode(cfg, "SeparableConv1D")
    lyr = SeparableConvolution1D(
        n_out=int(cfg["filters"]), kernel=int(_one(cfg["kernel_size"])),
        stride=int(_one(cfg.get("strides", 1))),
        dilation=int(_one(cfg.get("dilation_rate", 1))),
        depth_multiplier=int(cfg.get("depth_multiplier", 1)), mode=mode,
        activation=_act(cfg.get("activation")),
        has_bias=bool(cfg.get("use_bias", True)))

    def w(ws):
        dk = np.asarray(ws[0])             # [k, cin, mult]
        k, cin, mult = dk.shape
        dw = dk.transpose(1, 2, 0).reshape(cin * mult, 1, 1, k)
        pw = np.asarray(ws[1]).transpose(2, 1, 0)[:, :, :, None]
        return _bias_out(cfg, ws, {"dW": dw, "pW": pw}, 2)
    return _Mapped(lyr, w)


def _map_crop1d(cfg) -> _Mapped:
    from ..nn.layers.conv_extra import Cropping1D
    cr = cfg["cropping"]
    lo, hi = (cr, cr) if isinstance(cr, int) else (int(cr[0]), int(cr[1]))
    return _Mapped(Cropping1D(cropping=(lo, hi)))


def _map_pad1d(cfg) -> _Mapped:
    from ..nn.layers.conv_extra import ZeroPadding1DLayer
    p = cfg["padding"]
    lo, hi = (p, p) if isinstance(p, int) else (int(p[0]), int(p[1]))
    return _Mapped(ZeroPadding1DLayer(padding=(lo, hi)))


def _map_upsampling1d(cfg) -> _Mapped:
    from ..nn.layers.conv_extra import Upsampling1D
    return _Mapped(Upsampling1D(size=int(cfg.get("size", 2))))


def _map_locally_connected2d(cfg) -> _Mapped:
    from ..nn.layers.conv_extra import LocallyConnected2D
    if cfg.get("data_format", "channels_last") != "channels_last":
        raise ValueError("LocallyConnected2D channels_first not supported")
    if cfg.get("padding", "valid") != "valid":
        raise ValueError("LocallyConnected2D padding='same' not supported "
                         "(Keras only supports 'valid' either)")
    lyr = LocallyConnected2D(
        n_out=int(cfg["filters"]), kernel=_pair(cfg["kernel_size"]),
        stride=_pair(cfg.get("strides", 1)),
        activation=_act(cfg.get("activation")),
        has_bias=bool(cfg.get("use_bias", True)))

    def w(ws):
        out = {"W": np.asarray(ws[0])}   # [P, khkwC, F] is the port's
        if cfg.get("use_bias", True):
            out["b"] = np.asarray(ws[1]).reshape(-1, out["W"].shape[-1])
        return out
    return _Mapped(lyr, w)


def _map_locally_connected1d(cfg) -> _Mapped:
    from ..nn.layers.conv_extra import LocallyConnected1D
    if cfg.get("padding", "valid") != "valid":
        raise ValueError("LocallyConnected1D padding='same' not supported")
    lyr = LocallyConnected1D(
        n_out=int(cfg["filters"]), kernel=int(_one(cfg["kernel_size"])),
        stride=int(_one(cfg.get("strides", 1))),
        activation=_act(cfg.get("activation")),
        has_bias=bool(cfg.get("use_bias", True)))

    def w(ws):
        out = {"W": np.asarray(ws[0])}   # [To, k*F, F_out] is the port's
        if cfg.get("use_bias", True):
            out["b"] = np.asarray(ws[1])
        return out
    return _Mapped(lyr, w)


def _map_separable(cfg) -> _Mapped:
    from ..nn.layers.conv_extra import SeparableConvolution2D
    _check_channels_last(cfg, "SeparableConv2D")
    same = cfg.get("padding", "valid") == "same"
    lyr = SeparableConvolution2D(
        n_out=int(cfg["filters"]), kernel=_pair(cfg["kernel_size"]),
        stride=_pair(cfg.get("strides", 1)),
        dilation=_pair(cfg.get("dilation_rate", 1)),
        depth_multiplier=int(cfg.get("depth_multiplier", 1)),
        mode="same" if same else "truncate",
        activation=_act(cfg.get("activation")),
        has_bias=cfg.get("use_bias", True), data_format="NHWC")

    def w(ws):
        # depthwise [kh, kw, cin, mult] -> [cin*mult, 1, kh, kw]; pointwise
        # [1, 1, cin*mult, out] -> [out, cin*mult, 1, 1]
        dk = ws[0]
        kh, kw, cin, mult = dk.shape
        dw = dk.transpose(2, 3, 0, 1).reshape(cin * mult, 1, kh, kw)
        return _bias_out(cfg, ws, {"dW": dw,
                                   "pW": ws[1].transpose(3, 2, 0, 1)}, 2)
    return _Mapped(lyr, w)


def _map_depthwise(cfg) -> _Mapped:
    from ..nn.layers.conv_extra import DepthwiseConvolution2D
    _check_channels_last(cfg, "DepthwiseConv2D")
    same = cfg.get("padding", "valid") == "same"
    lyr = DepthwiseConvolution2D(
        kernel=_pair(cfg["kernel_size"]), stride=_pair(cfg.get("strides", 1)),
        dilation=_pair(cfg.get("dilation_rate", 1)),
        depth_multiplier=int(cfg.get("depth_multiplier", 1)),
        mode="same" if same else "truncate",
        activation=_act(cfg.get("activation")),
        has_bias=cfg.get("use_bias", True), data_format="NHWC")

    def w(ws):
        dk = ws[0]
        kh, kw, cin, mult = dk.shape
        return _bias_out(cfg, ws, {"W": dk.transpose(2, 3, 0, 1).reshape(
            cin * mult, 1, kh, kw)}, 1)
    return _Mapped(lyr, w)


def _map_cropping(cfg) -> _Mapped:
    from ..nn.layers.conv_extra import Cropping2D
    cr = cfg["cropping"]
    if isinstance(cr, int):
        t = b = l = r = cr
    else:
        (t, b), (l, r) = cr
    return _Mapped(Cropping2D(cropping=(int(t), int(b), int(l), int(r)),
                              data_format="NHWC"))


_MAPPERS: Dict[str, Callable[[dict], _Mapped]] = {
    "Dense": _map_dense,
    "Conv2D": _map_conv2d,
    "MaxPooling2D": lambda c: _map_pool(c, "max"),
    "AveragePooling2D": lambda c: _map_pool(c, "avg"),
    "GlobalAveragePooling2D": lambda c: _Mapped(
        GlobalPoolingLayer(pool_type="avg", data_format="NHWC")),
    "GlobalMaxPooling2D": lambda c: _Mapped(
        GlobalPoolingLayer(pool_type="max", data_format="NHWC")),
    "BatchNormalization": _map_bn,
    "Dropout": lambda c: _Mapped(DropoutLayer(rate=float(c["rate"]))),
    "Flatten": lambda c: _Mapped(FlattenLayer()),
    "Activation": lambda c: _Mapped(
        ActivationLayer(activation=_act(c["activation"]))),
    "ReLU": _map_relu,
    "LeakyReLU": lambda c: _Mapped(ActivationLayer(
        activation="leakyrelu",
        alpha=float(c.get("negative_slope", c.get("alpha", 0.3))))),
    "Softmax": lambda c: _Mapped(ActivationLayer(activation="softmax")),
    "ZeroPadding2D": _map_zeropad,
    "UpSampling2D": lambda c: _Mapped(Upsampling2D(
        size=_pair(c.get("size", 2)), data_format="NHWC",
        interpolation=_upsample_interp(c))),
    "Embedding": _map_embedding,
    "LSTM": _map_lstm,
    "GRU": _map_gru,
    "SimpleRNN": _map_simple_rnn,
    "Bidirectional": _map_bidirectional,
    "Conv1D": _map_conv1d,
    "Conv2DTranspose": _map_conv2d_transpose,
    "Conv3DTranspose": _not_ported("Conv3DTranspose", "deconv3d"),
    "Conv3D": _not_ported("Conv3D", "conv3d"),
    # legacy tf.compat.v1 cuDNN-pinned RNNs: the same cells with double
    # (input + recurrent) biases
    "CuDNNLSTM": _map_cudnn_lstm,
    "CuDNNGRU": _map_cudnn_gru,
    "MultiHeadAttention": _map_multi_head_attention,
    "MaxPooling1D": lambda c: _map_pool1d(c, "max"),
    "AveragePooling1D": lambda c: _map_pool1d(c, "avg"),
    "GlobalAveragePooling1D": lambda c: _Mapped(
        GlobalPoolingLayer(pool_type="avg")),
    "GlobalMaxPooling1D": lambda c: _Mapped(
        GlobalPoolingLayer(pool_type="max")),
    "Lambda": _map_lambda,
    "LayerNormalization": _not_ported("LayerNormalization", "layer_norm"),
    "ELU": lambda c: _Mapped(ActivationLayer(
        activation="elu", alpha=float(c.get("alpha", 1.0)))),
    "SeparableConv2D": _map_separable,
    "DepthwiseConv2D": _map_depthwise,
    "PReLU": _not_ported("PReLU", "prelu"),
    "SpatialDropout2D": _not_ported("SpatialDropout2D", "spatial_dropout"),
    "GaussianNoise": _not_ported("GaussianNoise", "gaussian_noise"),
    "GaussianDropout": _not_ported("GaussianDropout", "gaussian_dropout"),
    "Cropping2D": _map_cropping,
    "Permute": lambda c: _map_structural(
        "PermuteLayer", dims=tuple(int(d) for d in c["dims"])),
    "Reshape": lambda c: _map_structural(
        "ReshapeLayer", target_shape=tuple(int(t) for t in c["target_shape"])),
    "Masking": lambda c: _map_structural(
        "MaskingLayer", mask_value=float(c.get("mask_value", 0.0))),
    "RepeatVector": lambda c: _map_wrapper("RepeatVector", n=int(c["n"])),
    "TimeDistributed": _map_time_distributed,
    "ConvLSTM2D": _map_convlstm2d,
    "SeparableConv1D": _map_separable1d,
    "AlphaDropout": _not_ported("AlphaDropout", "alpha_dropout"),
    "ThresholdedReLU": lambda c: _Mapped(ActivationLayer(
        activation="thresholdedrelu", alpha=float(c.get("theta", 1.0)))),
    "SpatialDropout1D": _not_ported("SpatialDropout1D", "spatial_dropout"),
    "SpatialDropout3D": _not_ported("SpatialDropout3D", "spatial_dropout"),
    "Cropping1D": _map_crop1d,
    "ZeroPadding1D": _map_pad1d,
    "UpSampling1D": _map_upsampling1d,
    "Cropping3D": _not_ported("Cropping3D", "cropping3d"),
    "ZeroPadding3D": _not_ported("ZeroPadding3D", "zeropad3d"),
    "UpSampling3D": _not_ported("UpSampling3D", "upsampling3d"),
    "MaxPooling3D": _not_ported("MaxPooling3D", "subsampling3d"),
    "AveragePooling3D": _not_ported("AveragePooling3D", "subsampling3d"),
    "GlobalAveragePooling3D": lambda c: _Mapped(
        GlobalPoolingLayer(pool_type="avg", data_format="NDHWC")),
    "GlobalMaxPooling3D": lambda c: _Mapped(
        GlobalPoolingLayer(pool_type="max", data_format="NDHWC")),
    "LocallyConnected1D": _map_locally_connected1d,
    "LocallyConnected2D": _map_locally_connected2d,
}

def _input_type_from_batch_shape(shape) -> tuple:
    dims = list(shape[1:])
    if len(dims) == 1:
        return InputType.feed_forward(int(dims[0]))
    if len(dims) == 2:
        t, f = dims
        return InputType.recurrent(int(f), None if t is None else int(t))
    if len(dims) == 3:
        h, w, c = dims
        return InputType.convolutional(int(c), int(h), int(w),
                                       data_format="NHWC")
    if len(dims) == 4:
        d, h, w, c = dims
        return InputType.convolutional3d(int(c), int(d), int(h), int(w),
                                         data_format="NDHWC")
    raise ValueError(f"unsupported input shape {shape}")


# the canonical rank of each weight within a layer, for the Keras 2 h5
# groups without a weight_names attribute: visititems yields in name
# order, and beta < gamma would swap same-shaped BN params
_WEIGHT_RANK = {"kernel": 0, "embeddings": 0, "gamma": 0,
                "depthwise_kernel": 0, "recurrent_kernel": 1,
                "pointwise_kernel": 1, "beta": 1,
                "bias": 2, "moving_mean": 2, "moving_variance": 3}


def _h5_weights(f, layer_name: str) -> List[np.ndarray]:
    """The Keras weight list of ``layer_name``, from an open ``.h5`` (its
    ``model_weights`` group) or from a dict of precomputed lists (the
    ``.keras`` path, or a caller's arrays)."""
    if isinstance(f, dict):
        return f.get(layer_name, [])
    mw = f["model_weights"]
    if layer_name not in mw:
        return []
    g = mw[layer_name]
    names = [n.decode() if isinstance(n, bytes) else n
             for n in g.attrs.get("weight_names", [])]
    if not names:  # Keras 2 nests one more level without weight_names
        out = []

        def visit(path, obj):
            if isinstance(obj, hdf5.Dataset):
                leaf = path.split("/")[-1].split(":")[0]
                out.append((_WEIGHT_RANK.get(leaf, 99), np.array(obj)))
        g.visititems(visit)
        return [a for _, a in sorted(out, key=lambda kv: kv[0])]
    return [np.array(g[n]) for n in names]


def _snake(name: str) -> str:
    """keras.src.utils.naming.to_snake_case: the second pattern is [a-z]
    without digits (Conv2D -> conv2d, not conv2_d)."""
    s = re.sub(r"\W+", "", name)
    s = re.sub(r"(.)([A-Z][a-z]+)", r"\1_\2", s)
    return re.sub(r"([a-z])([A-Z])", r"\1_\2", s).lower()


# wrapper stores flattened in legacy-h5 weight order, and state-only
# groups that hold no trainable weight (an LSTM(dropout=...) keeps RNG
# state under seed_generator beside cell/vars)
_WRAPPER_CHILDREN = ("cell", "forward_layer", "backward_layer", "layer")
_STATE_CHILDREN = ("seed_generator",)


def _collect_vars(g, key="?") -> List[np.ndarray]:
    """Flatten a ``.keras`` layer store depth first: its own ``vars``, then
    the known wrapper stores in that order. A weight under an unknown child
    group raises rather than being misassigned."""
    out: List[np.ndarray] = []
    if "vars" in g and len(g["vars"]) > 0:
        vs = g["vars"]
        out += [np.array(vs[k]) for k in sorted(vs.keys(), key=int)]
    for k in _WRAPPER_CHILDREN:
        if k in g and hasattr(g[k], "keys"):
            out += _collect_vars(g[k], key=f"{key}/{k}")
    for k in g.keys():
        if k == "vars" or k in _WRAPPER_CHILDREN or k in _STATE_CHILDREN:
            continue
        child = g[k]
        if hasattr(child, "keys") and _collect_vars(child, key=f"{key}/{k}"):
            raise ValueError(
                f".keras layer store {key!r} has weights under an "
                f"unrecognized child group {k!r} — store layout out "
                "of sync with this keras version; save as legacy "
                ".h5 instead")
    return out


def _import_keras_v3(path: str, device):
    """Keras 3 ``.keras`` archive: zip{config.json, model.weights.h5}. The
    store keys layers by snake-cased class name with an occurrence
    counter ("dense", "dense_1", ...) in declaration order, so the keys
    are rebuilt from the config's layer list."""
    with zipfile.ZipFile(path) as z:
        cfg = json.loads(z.read("config.json"))
        weights_data = z.read("model.weights.h5")

    layers_cfg = cfg["config"]["layers"] if isinstance(cfg["config"], dict) \
        else cfg["config"]
    counters: Dict[str, int] = {}
    by_config_name: Dict[str, str] = {}
    for lcfg in layers_cfg:
        cls = lcfg["class_name"]
        if cls == "InputLayer":
            continue
        # structural layers (Add, Concatenate, ...) take store keys too
        key = _snake(cls)
        n = counters.get(key, 0)
        counters[key] = n + 1
        by_config_name[lcfg["config"]["name"]] = key if n == 0 \
            else f"{key}_{n}"

    weights: Dict[str, List[np.ndarray]] = {}
    with hdf5.File(weights_data) as f:
        store = f["layers"] if "layers" in f else f
        keys = set(by_config_name.values())
        unconsumed = {k for k in store.keys()
                      if k not in keys and _collect_vars(store[k])}
        if unconsumed:
            # a key-derivation mismatch would leave layers on their random
            # init silently; empty groups of structural layers are fine
            raise ValueError(
                f".keras weight store entries {sorted(unconsumed)} match "
                "no config layer — store-key derivation out of sync with "
                "this keras version")
        for cfg_name, store_key in by_config_name.items():
            if store_key not in store:
                continue
            ws = _collect_vars(store[store_key])
            if ws:
                weights[cfg_name] = ws
    return _import_model(cfg, weights, device)


def _inbound_parents(node_spec) -> List[str]:
    """Parent layer names from inbound_nodes, Keras 2 and 3 formats."""
    out: List[str] = []

    def walk(o):
        if isinstance(o, dict):
            if o.get("class_name") == "__keras_tensor__":
                out.append(o["config"]["keras_history"][0])
            else:
                for v in o.values():
                    walk(v)
        elif isinstance(o, (list, tuple)):
            if (len(o) >= 3 and isinstance(o[0], str)
                    and isinstance(o[1], int) and isinstance(o[2], int)):
                out.append(o[0])  # Keras 2 ["name", node_idx, tensor_idx, {}]
            else:
                for v in o:
                    walk(v)

    walk(node_spec)
    return out


def _import_model(cfg: dict, f, device):
    """A Sequential config to a MultiLayerNetwork, a Functional one to a
    ComputationGraph, on ``device``, weights from ``f`` (an open ``.h5``,
    a ``{layer name: [arrays]}`` dict, or None for config-only)."""
    cls = cfg["class_name"]
    if cls == "Sequential":
        return _import_sequential(cfg, f, device)
    if cls in ("Functional", "Model"):
        return _import_functional(cfg, f, device)
    raise ValueError(f"unsupported Keras model class {cls!r}")


class KerasModelImport:
    """Entry points mirroring DL4J's static methods. Each builds the
    network on ``device``: ``cuda`` unless the caller passes ``"cpu"``;
    without CUDA they raise."""

    @staticmethod
    def import_keras_sequential_model_and_weights(
            path: str, enforce_training_config: bool = False, device=None):
        model = KerasModelImport.import_keras_model_and_weights(
            path, device=device)
        from ..nn.model import MultiLayerNetwork
        if not isinstance(model, MultiLayerNetwork):
            raise TypeError("model in file is not Sequential")
        return model

    @staticmethod
    def import_keras_model_and_weights(path: str, device=None):
        """``.h5`` or ``.keras`` -> MultiLayerNetwork (Sequential) or
        ComputationGraph (Functional), weights copied."""
        device = _env.resolve_device(device)
        if str(path).lower().endswith(".keras"):
            return _import_keras_v3(path, device)
        with hdf5.File(path) as f:
            cfg = json.loads(f.attrs["model_config"])
            return _import_model(cfg, f, device)

    @staticmethod
    def import_keras_model_configuration(source: str, device=None):
        """Config-only import (DL4J ``importKerasModelConfiguration``):
        ``source`` is a model-config JSON string, a path to a .json file,
        or a .h5 whose config attribute is read without its weights. The
        network keeps its fresh (random) parameters."""
        device = _env.resolve_device(device)
        if source.lstrip().startswith("{"):
            cfg = json.loads(source)
        elif os.path.splitext(source)[1].lower() in (".h5", ".hdf5"):
            with hdf5.File(source) as f:
                cfg = json.loads(f.attrs["model_config"])
        else:
            with open(source) as f:
                cfg = json.load(f)
        return _import_model(cfg, None, device)

    @staticmethod
    def import_keras_sequential_configuration(source: str, device=None):
        model = KerasModelImport.import_keras_model_configuration(
            source, device=device)
        from ..nn.model import MultiLayerNetwork
        if not isinstance(model, MultiLayerNetwork):
            raise TypeError("configuration is not Sequential")
        return model


# Keras-1 spellings (DL4J's KerasLayerConfiguration carries both
# generations of field names): class renames and config key translations,
# applied before the mapper
_KERAS1_CLASS = {"Convolution2D": "Conv2D", "Convolution1D": "Conv1D",
                 "Convolution3D": "Conv3D", "Deconvolution2D":
                 "Conv2DTranspose", "Highway": None, "MaxoutDense": None}
_KERAS1_KEYS = {"output_dim": "units", "nb_filter": "filters",
                "subsample": "strides", "subsample_length": "strides",
                "border_mode": "padding", "inner_activation":
                "recurrent_activation", "p": "rate", "bias": "use_bias",
                "nb_units": "units"}
_KERAS1_DROPOUTS = ("Dropout", "SpatialDropout1D", "SpatialDropout2D",
                    "SpatialDropout3D", "AlphaDropout", "GaussianDropout")


def _normalize_keras1(lcfg: dict) -> dict:
    """A Keras-1 layer config in the Keras-2 spellings the mappers read.
    No-op for modern configs, and for Embedding, whose input_dim and
    output_dim are modern in every Keras generation."""
    cls = lcfg["class_name"]
    if cls == "Embedding":
        return lcfg
    c = lcfg.get("config", {})
    legacy = (cls in _KERAS1_CLASS
              or any(k in c for k in ("nb_filter", "output_dim",
                                      "border_mode", "nb_row"))
              # 'bias' alone is ambiguous: legacy only without 'use_bias'
              or ("bias" in c and "use_bias" not in c)
              # Keras-1 dropouts spell rate as "p" with no other marker
              or (cls in _KERAS1_DROPOUTS and "p" in c
                  and "rate" not in c))
    if not legacy:
        return lcfg
    if cls in _KERAS1_CLASS and _KERAS1_CLASS[cls] is None:
        raise ValueError(f"Keras-1 layer {cls!r} has no modern equivalent "
                         "to map onto")
    c = dict(c)
    for old, new in _KERAS1_KEYS.items():
        if old in c and new not in c:
            c[new] = c.pop(old)
    if "nb_row" in c:  # Convolution2D kernel spelling
        c.setdefault("kernel_size", (int(c.pop("nb_row")),
                                     int(c.pop("nb_col"))))
    if "filter_length" in c:  # Convolution1D
        c.setdefault("kernel_size", int(c.pop("filter_length")))
    if c.get("padding") == "full":
        raise ValueError("Keras-1 border_mode='full' is not supported")
    if c.get("dim_ordering") == "th":
        raise ValueError("Keras-1 dim_ordering='th' (channels_first) is "
                         "not supported — NHWC imports only")
    c.pop("dim_ordering", None)
    c.pop("init", None)  # the weights come from the file
    return {**lcfg, "class_name": _KERAS1_CLASS.get(cls, cls), "config": c}


def _map_layer(lcfg: dict) -> _Mapped:
    lcfg = _normalize_keras1(lcfg)
    cls = lcfg["class_name"]
    if cls not in _MAPPERS:
        raise ValueError(
            f"unsupported Keras layer class {cls!r} (layer "
            f"{lcfg.get('config', {}).get('name')!r}) — extend "
            "modelimport/keras.py:_MAPPERS")
    return _MAPPERS[cls](lcfg["config"])


def _as_tensor(val, like, device) -> torch.Tensor:
    """A Keras array as a tensor on ``device``: in the dtype of the
    parameter it replaces, else float64 as float32 (as ``jnp.asarray``
    without x64 keeps it)."""
    t = tensor_from_numpy(np.asarray(val), device)
    if like is not None and t.is_floating_point():
        return t.to(like.dtype)
    return t.float() if t.dtype == torch.float64 else t


def _set_params(model_params, model_state, key: str, mapped: _Mapped,
                kws: List[np.ndarray], device):
    if mapped.weights is None or not kws:
        return
    out = mapped.weights(kws)
    params = out.get("__params__", out if "__state__" not in out else {})
    state = out.get("__state__")

    def merge(tgt, src, path):
        for name, val in src.items():
            if isinstance(val, dict):  # nested (Bidirectional fw/bw)
                tgt[name] = merge(dict(tgt.get(name, {})), val,
                                  f"{path}/{name}")
                continue
            have = tgt.get(name)
            if have is not None and tuple(have.shape) != tuple(
                    np.asarray(val).shape):
                raise ValueError(
                    f"shape mismatch importing {path}/{name}: "
                    f"ours {tuple(have.shape)} vs h5 "
                    f"{tuple(np.asarray(val).shape)}")
            tgt[name] = _as_tensor(val, have, device)
        return tgt

    model_params[key] = merge(dict(model_params.get(key, {})), params, key)
    if state:
        st = model_state.get(key, {})
        for name, val in state.items():
            st[name] = _as_tensor(val, st.get(name), device)
        model_state[key] = st


def _import_sequential(cfg: dict, f, device):
    from ..nn.layers.core import OutputLayer
    from ..nn.layers.recurrent import LastTimeStep
    from ..nn.model import MultiLayerNetwork

    lcfgs = cfg["config"]["layers"] if isinstance(cfg["config"], dict) \
        else cfg["config"]  # Keras 1 stored a bare list
    input_type = None
    ours: List[Tuple[str, _Mapped]] = []
    for lcfg in lcfgs:
        cls = lcfg["class_name"]
        c = lcfg["config"]
        if cls == "InputLayer":
            shape = c.get("batch_shape") or c.get("batch_input_shape")
            input_type = _input_type_from_batch_shape(shape)
            continue
        if input_type is None and ("batch_input_shape" in c or
                                   "batch_shape" in c):
            shape = c.get("batch_shape") or c.get("batch_input_shape")
            input_type = _input_type_from_batch_shape(shape)
        mapped = _map_layer(lcfg)
        ours.append((c["name"], mapped))
        if mapped.vertex and mapped.vertex[0] in ("lstm", "rnn") and \
                not mapped.vertex[1]["return_sequences"]:
            ours.append((c["name"] + "_last", _Mapped(LastTimeStep())))
    if input_type is None:
        raise ValueError("model has no input shape; cannot import")

    # a final Dense becomes an OutputLayer so the net is trainable: the
    # loss from the head activation (the same forward)
    if ours and isinstance(ours[-1][1].layer, DenseLayer):
        d = ours[-1][1].layer
        loss = {"softmax": "mcxent", "sigmoid": "xent"}.get(
            d.activation, "mse")
        ours[-1][1].layer = OutputLayer(n_out=d.n_out,
                                        activation=d.activation, loss=loss)

    b = (NeuralNetConfiguration.builder().input_type(input_type)
         .list(*[m.layer for _, m in ours]))
    net = MultiLayerNetwork(b.build()).init(device=device)
    if f is not None:  # config-only import keeps the random init
        for i, (kname, mapped) in enumerate(ours):
            _set_params(net.params, net.state, str(i), mapped,
                        _h5_weights(f, kname), net.device)
    return net


def _io_names(spec) -> List[str]:
    """input_layers/output_layers spellings across Keras versions: a flat
    ["name", 0, 0] triple (single io), a list of such triples, a list of
    names, or keras-tensor dicts."""
    if (isinstance(spec, list) and len(spec) == 3 and isinstance(spec[0], str)
            and isinstance(spec[1], int)):
        return [spec[0]]
    out: List[str] = []
    for x in spec:
        if isinstance(x, str):
            out.append(x)
        elif isinstance(x, list) and x and isinstance(x[0], str):
            out.append(x[0])
        elif isinstance(x, dict) and x.get("class_name") == "__keras_tensor__":
            out.append(x["config"]["keras_history"][0])
        else:
            raise ValueError(f"unrecognized io spec entry {x!r}")
    return out


def _has_truthy(o, key) -> bool:
    if isinstance(o, dict):
        return bool(o.get(key)) or any(_has_truthy(v, key)
                                       for v in o.values())
    if isinstance(o, (list, tuple)):
        return any(_has_truthy(v, key) for v in o)
    return False


#: the Keras merge layers and the ElementWiseVertex op of each
_ELEMENTWISE = {"Add": "add", "Subtract": "subtract", "Multiply": "product",
                "Maximum": "max", "Average": "average", "Minimum": "min"}


def _import_functional(cfg: dict, f, device):
    from ..nn.graph import ComputationGraph
    from ..nn.vertices import (DotProductVertex, ElementWiseVertex,
                               MergeVertex)

    c = cfg["config"]
    input_names = _io_names(c["input_layers"])
    output_names = _io_names(c["output_layers"])

    gb = NeuralNetConfiguration.builder().graph_builder()
    input_types = []
    mapped_by_name: Dict[str, _Mapped] = {}
    for lcfg in c["layers"]:
        cls = lcfg["class_name"]
        lc = lcfg["config"]
        name = lc["name"]
        if cls == "InputLayer":
            shape = lc.get("batch_shape") or lc.get("batch_input_shape")
            input_types.append(_input_type_from_batch_shape(shape))
            continue
        parents = _inbound_parents(lcfg.get("inbound_nodes", []))
        if cls == "MultiHeadAttention":
            # self-attention passes one tensor as query, value (and key);
            # distinct parents are cross-attention
            uniq = sorted(set(parents))
            if len(uniq) > 1:
                raise ValueError(
                    "MultiHeadAttention with distinct query/value/key "
                    "parents (cross-attention) is not supported in import")
            parents = uniq
            # a causal mask at call time would be imported as full
            # attention
            for bad in ("use_causal_mask", "attention_mask"):
                if _has_truthy(lcfg.get("inbound_nodes", []), bad):
                    raise ValueError(
                        f"MultiHeadAttention called with {bad} is not "
                        "supported in import (would silently import as "
                        "full bidirectional attention)")
        if cls in _ELEMENTWISE:
            gb.add_vertex(name, ElementWiseVertex(op=_ELEMENTWISE[cls]),
                          *parents)
            continue
        if cls == "Concatenate":
            gb.add_vertex(name, MergeVertex(data_format="NHWC"), *parents)
            continue
        if cls == "Dot":
            axes = lc.get("axes", -1)
            if lc.get("normalize"):
                raise ValueError("Dot(normalize=True) not supported")
            if isinstance(axes, (list, tuple)):
                if len(axes) != 2 or axes[0] != axes[1]:
                    raise ValueError(
                        f"Dot with differing axes {axes} not supported "
                        "(contracts different dims of each input)")
                axes = axes[0]
            gb.add_vertex(name, DotProductVertex(axis=int(axes)), *parents)
            continue
        mapped = _map_layer(lcfg)
        mapped_by_name[name] = mapped
        gb.add_layer(name, mapped.layer, *parents)
        if mapped.vertex and mapped.vertex[0] in ("lstm", "rnn") and \
                not mapped.vertex[1]["return_sequences"]:
            raise ValueError(
                "Functional LSTM with return_sequences=False: wrap with "
                "LastTimeStep manually (Sequential import handles it)")

    gb.add_inputs(*input_names)
    gb.set_input_types(*input_types)
    gb.set_outputs(*output_names)
    net = ComputationGraph(gb.build()).init(device=device)
    if f is not None:  # config-only import keeps the random init
        for name, mapped in mapped_by_name.items():
            _set_params(net.params, net.state, name, mapped,
                        _h5_weights(f, name), net.device)
    return net
