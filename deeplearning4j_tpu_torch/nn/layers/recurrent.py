"""Recurrent layers: LSTM, GravesLSTM, GRU, SimpleRnn, ConvLSTM2D, the
Bidirectional wrapper, LastTimeStep, RnnOutputLayer, RnnLossLayer.

Port of ``deeplearning4j_tpu/nn/layers/recurrent.py``, with the same JSON
kinds, fields and parameter layouts: activations are ``[B, T, F]`` (time
second); an LSTM's ``W`` is ``[nIn, 4u]``, ``RW`` ``[u, 4u]`` and ``b``
``[4u]``, gate order [i, f, o, g]; GravesLSTM adds its peepholes as
``PW`` ``[3, u]``; a GRU's gates are [z, r, h~] in ``W`` ``[nIn, 3u]``,
``RW`` ``[u, 3u]``, ``b`` ``[3u]`` and, in the reset-after form, the
recurrent bias ``rb`` ``[3u]``; ConvLSTM2D runs on ``[B, T, H, W, C]``
(NHWC steps) with OIHW ``W`` ``[4f, C, kh, kw]`` and ``RW`` ``[4f, f, kh,
kw]``; a Bidirectional keeps its two directions' trees under ``fw`` and
``bw``.

The scan over time is a Python loop (the JAX package's ``lax.scan``): step
t reads ``x[:, t, :]``, a row-strided view, without a copy. Masking is
carry gating, ``h_t = m_t*h_new + (1-m_t)*h_prev`` in that arithmetic
form, as in the JAX package, so a masked step keeps the previous state.
Truncated BPTT detaches the carry every ``tbptt_length`` steps. Streaming
state (``rnnTimeStep``) lives outside params and state, with the model.

``LSTM(use_pallas_cell=True)`` runs its inference and streaming steps
(``apply(train=False)`` and the model's ``rnn_time_step``) through
``ops.pallas_kernels.lstm_cell_fused``: K8 on the card. The gradient path
(``train=True``) always runs the plain ``nnops.lstm_cell``, as in the JAX
package (K8 is forward only). A ``Bidirectional`` never asks its
directions for the forward-only path (the JAX module's :439-452), so an
``LSTM(use_pallas_cell=True)`` inside one runs the plain cell, in
inference too; and it cannot stream (``supports_streaming = False``, as
ConvLSTM2D), so ``rnn_time_step`` refuses it.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from ...ops import activations as _act
from ...ops import nnops
from ...ops import pallas_kernels as _pk
from .. import weights as _winit
from .base import Layer, layer
from .conv import _conv_out
from .core import LossLayer, OutputLayer


def _scan_time(step, carry0, x, mask, tbptt):
    """Run ``step`` over the time axis of x ``[B, T, F]``.

    step: ``(carry, (x_t, m_t, t)) -> (carry, y_t)``, with ``x_t`` the view
    ``x[:, t, :]`` and ``m_t`` the ``[B]`` mask slice (None without a
    mask); mask gating happens inside ``step``. tbptt: detach the carry
    every ``tbptt`` steps (window boundary), or None for full BPTT.
    Returns ``(final carry, ys [B, T, u])``."""
    carry = carry0
    ys = []
    for t in range(x.shape[1]):
        if tbptt and t % tbptt == 0:
            carry = tuple(c.detach() for c in carry)
        m_t = None if mask is None else mask[:, t]
        carry, y = step(carry, (x[:, t], m_t, t))
        ys.append(y)
    if not ys:
        h = carry[0]
        return carry, h.new_empty((h.shape[0], 0) + tuple(h.shape[1:]))
    return carry, torch.stack(ys, dim=1)


def _gate(m_t, new, prev):
    """Carry gating: masked steps keep the previous state."""
    m = m_t[:, None].to(new.dtype)
    return m * new + (1.0 - m) * prev


def _scan_ret(step, carry, x, mask, tbptt):
    """(final_carry, ys) -> (ys, final_carry) in layer return order."""
    final, ys = _scan_time(step, carry, x, mask, tbptt)
    return ys, final


class _RecurrentLayer(Layer):
    """Shared streaming/scan plumbing for recurrent layers."""

    supports_streaming = True

    def is_recurrent(self) -> bool:
        return True

    def init_stream_state(self, params, batch: int):
        raise NotImplementedError

    def scan_with_state(self, params, x, carry, mask=None, grad_path=True):
        """``(y [B, T, u], final_carry)``: used by ``apply`` (zero carry)
        and by the model's ``rnn_time_step`` (persisted carry).
        ``grad_path=False`` marks calls that are never differentiated
        (inference, streaming), letting layers pick forward-only kernels."""
        raise NotImplementedError

    def apply(self, params, x, state, *, train=False, mask=None):
        carry = self.init_stream_state(params, x.shape[0])
        # train=True is the gradient path: a forward-only cell (K8) only
        # serves inference and streaming
        y, _ = self.scan_with_state(params, x, carry, mask, grad_path=train)
        return y, state, mask


@layer("lstm")
class LSTM(_RecurrentLayer):
    """Standard (non-peephole) LSTM (DL4J LSTM).

    ``use_pallas_cell=True`` opts the inference and streaming paths into
    the fused cell (K8 on the card; its plain version on the CPU); the
    training path keeps ``nnops.lstm_cell``."""
    n_out: int = 0
    n_in: Optional[int] = None
    activation: str = "tanh"            # DL4J exposes it; cell uses tanh
    forget_bias: float = 1.0            # DL4J LSTM forgetGateBiasInit default
    weight_init: str = "xavier"
    tbptt_length: Optional[int] = None  # stamped from conf by the builder
    use_pallas_cell: bool = False
    l1: float = 0.0
    l2: float = 0.0
    name: Optional[str] = None

    def initialize(self, gen, input_shape, dtype, device):
        n_in = self.n_in or int(input_shape[-1])
        u = self.n_out
        w = _winit.init(self.weight_init, gen, (n_in, 4 * u), n_in, u, dtype,
                        device)
        rw = _winit.init(self.weight_init, gen, (u, 4 * u), u, u, dtype,
                         device)
        b = torch.zeros((4 * u,), dtype=dtype, device=device)
        return ({"W": w, "RW": rw, "b": b}, {},
                tuple(input_shape[:-1]) + (u,))

    def init_stream_state(self, params, batch):
        w = params["W"]
        u = params["RW"].shape[0]
        return (w.new_zeros((batch, u)), w.new_zeros((batch, u)))

    def _cell(self, grad_path: bool):
        if not grad_path and self.use_pallas_cell:
            return _pk.lstm_cell_fused
        return nnops.lstm_cell

    def scan_with_state(self, params, x, carry, mask=None, grad_path=True):
        w, rw, b = params["W"], params["RW"], params["b"]
        fb = self.forget_bias
        cell = self._cell(grad_path)

        def step(carry, inp):
            x_t, m_t, _ = inp
            h, c = carry
            h_new, c_new = cell(x_t, h, c, w, rw, b, forget_bias=fb)
            if m_t is not None:
                h_new = _gate(m_t, h_new, h)
                c_new = _gate(m_t, c_new, c)
            return (h_new, c_new), h_new

        return _scan_ret(step, carry, x, mask, self.tbptt_length)


@layer("convlstm2d")
class ConvLSTM2D(_RecurrentLayer):
    """Convolutional LSTM over ``[B, T, H, W, C]`` NHWC sequences (Keras
    ``ConvLSTM2D``): ``z = conv(x_t, W) + conv(h_{t-1}, RW, same) + b``,
    gate order [i, f, o, g]. ``W`` ``[4f, C, kh, kw]``, ``RW`` ``[4f, f, kh,
    kw]`` (OIHW), ``b`` ``[4f]``. The recurrent conv is always ``same``
    over the output's spatial size; ``return_sequences=False`` gives the
    final state ``[B, H', W', f]``. The input convolutions of all steps
    run as one batched ``nnops.conv2d``."""
    n_out: int = 0                      # filters
    kernel: Tuple[int, int] = (3, 3)
    stride: Tuple[int, int] = (1, 1)
    mode: str = "same"                  # input conv padding: same|truncate
    return_sequences: bool = True
    activation: str = "tanh"            # cell/output transform
    gate_activation: str = "sigmoid"    # Keras recurrent_activation
    weight_init: str = "xavier"
    tbptt_length: Optional[int] = None
    l1: float = 0.0
    l2: float = 0.0
    name: Optional[str] = None

    supports_streaming = False

    def initialize(self, gen, input_shape, dtype, device):
        t, h, w, c = (int(s) for s in input_shape)
        kh, kw = int(self.kernel[0]), int(self.kernel[1])
        sh, sw = int(self.stride[0]), int(self.stride[1])
        f = self.n_out
        wk = _winit.init(self.weight_init, gen, (4 * f, c, kh, kw),
                         c * kh * kw, f * kh * kw, dtype, device)
        rwk = _winit.init(self.weight_init, gen, (4 * f, f, kh, kw),
                          f * kh * kw, f * kh * kw, dtype, device)
        b = torch.zeros((4 * f,), dtype=dtype, device=device)
        ho = _conv_out(h, kh, sh, 0, self.mode) if h > 0 else h
        wo = _conv_out(w, kw, sw, 0, self.mode) if w > 0 else w
        out = (t, ho, wo, f) if self.return_sequences else (ho, wo, f)
        return {"W": wk, "RW": rwk, "b": b}, {}, out

    def apply(self, params, x, state, *, train=False, mask=None):
        wk, rwk, b = params["W"], params["RW"], params["b"]
        B, T = x.shape[0], x.shape[1]
        # every step's input conv at once (time-invariant, so hoisted)
        zx = nnops.conv2d(x.reshape((B * T,) + tuple(x.shape[2:])), wk,
                          None, stride=self.stride, padding=(0, 0),
                          mode=self.mode, data_format="NHWC")
        zx = zx.reshape((B, T) + tuple(zx.shape[1:]))
        gate = _act.get(self.gate_activation)
        act = _act.get(self.activation)
        h0 = x.new_zeros((B,) + tuple(zx.shape[2:4]) + (self.n_out,))

        def step(carry, inp):
            zx_t, m_t, _ = inp
            hprev, cprev = carry
            z = zx_t + nnops.conv2d(hprev, rwk, None, stride=(1, 1),
                                    padding=(0, 0), mode="same",
                                    data_format="NHWC") + b
            i, fg, o, g = torch.chunk(z, 4, dim=-1)
            c_new = gate(fg) * cprev + gate(i) * act(g)
            h_new = gate(o) * act(c_new)
            if m_t is not None:
                m = m_t[:, None, None, None].to(h_new.dtype)
                h_new = m * h_new + (1.0 - m) * hprev
                c_new = m * c_new + (1.0 - m) * cprev
            return (h_new, c_new), h_new

        (h_fin, _), ys = _scan_time(step, (h0, h0), zx, mask,
                                    self.tbptt_length)
        if not self.return_sequences:
            return h_fin, state, None
        return ys, state, mask


@layer("graves_lstm")
class GravesLSTM(_RecurrentLayer):
    """Peephole LSTM (DL4J GravesLSTM): peepholes on i and f from
    ``c_{t-1}``, on o from ``c_t``, stored as ``PW`` ``[3, u]`` (the JAX
    package's recorded divergence: DL4J appends them to RW)."""
    n_out: int = 0
    n_in: Optional[int] = None
    activation: str = "tanh"
    weight_init: str = "xavier"
    tbptt_length: Optional[int] = None
    l1: float = 0.0
    l2: float = 0.0
    name: Optional[str] = None

    def initialize(self, gen, input_shape, dtype, device):
        n_in = self.n_in or int(input_shape[-1])
        u = self.n_out
        w = _winit.init(self.weight_init, gen, (n_in, 4 * u), n_in, u, dtype,
                        device)
        rw = _winit.init(self.weight_init, gen, (u, 4 * u), u, u, dtype,
                         device)
        pw = _winit.init(self.weight_init, gen, (3, u), u, u, dtype, device)
        b = torch.zeros((4 * u,), dtype=dtype, device=device)
        return ({"W": w, "RW": rw, "PW": pw, "b": b}, {},
                tuple(input_shape[:-1]) + (u,))

    def init_stream_state(self, params, batch):
        w = params["W"]
        u = params["RW"].shape[0]
        return (w.new_zeros((batch, u)), w.new_zeros((batch, u)))

    def scan_with_state(self, params, x, carry, mask=None, grad_path=True):
        w, rw, pw, b = params["W"], params["RW"], params["PW"], params["b"]

        def step(carry, inp):
            x_t, m_t, _ = inp
            h, c = carry
            h_new, c_new = nnops.graves_lstm_cell(x_t, h, c, w, rw, b, pw)
            if m_t is not None:
                h_new = _gate(m_t, h_new, h)
                c_new = _gate(m_t, c_new, c)
            return (h_new, c_new), h_new

        return _scan_ret(step, carry, x, mask, self.tbptt_length)


@layer("gru")
class GRU(_RecurrentLayer):
    """GRU, gate order [z, r, h~] (Keras/CuDNN; DL4J has none).
    ``reset_after=True`` (the Keras v2 default) keeps the recurrent bias
    ``rb`` and applies the reset gate after the recurrent matmul; False is
    the classic form."""
    n_out: int = 0
    n_in: Optional[int] = None
    reset_after: bool = True
    weight_init: str = "xavier"
    tbptt_length: Optional[int] = None
    l1: float = 0.0
    l2: float = 0.0
    name: Optional[str] = None

    def initialize(self, gen, input_shape, dtype, device):
        n_in = self.n_in or int(input_shape[-1])
        u = self.n_out
        w = _winit.init(self.weight_init, gen, (n_in, 3 * u), n_in, u, dtype,
                        device)
        rw = _winit.init(self.weight_init, gen, (u, 3 * u), u, u, dtype,
                         device)
        params = {"W": w, "RW": rw,
                  "b": torch.zeros((3 * u,), dtype=dtype, device=device)}
        if self.reset_after:
            params["rb"] = torch.zeros((3 * u,), dtype=dtype, device=device)
        return params, {}, tuple(input_shape[:-1]) + (u,)

    def init_stream_state(self, params, batch):
        return (params["W"].new_zeros((batch, params["RW"].shape[0])),)

    def scan_with_state(self, params, x, carry, mask=None, grad_path=True):
        w, rw, b = params["W"], params["RW"], params["b"]
        rb = params.get("rb")

        def step(carry, inp):
            x_t, m_t, _ = inp
            (h,) = carry
            h_new = nnops.gru_cell(x_t, h, w, rw, b, rb)
            if m_t is not None:
                h_new = _gate(m_t, h_new, h)
            return (h_new,), h_new

        return _scan_ret(step, carry, x, mask, self.tbptt_length)


@layer("simple_rnn")
class SimpleRnn(_RecurrentLayer):
    """Elman RNN: ``h_t = act(x W + h_{t-1} RW + b)`` (DL4J SimpleRnn)."""
    n_out: int = 0
    n_in: Optional[int] = None
    activation: str = "tanh"
    weight_init: str = "xavier"
    tbptt_length: Optional[int] = None
    l1: float = 0.0
    l2: float = 0.0
    name: Optional[str] = None

    def initialize(self, gen, input_shape, dtype, device):
        n_in = self.n_in or int(input_shape[-1])
        u = self.n_out
        w = _winit.init(self.weight_init, gen, (n_in, u), n_in, u, dtype,
                        device)
        rw = _winit.init(self.weight_init, gen, (u, u), u, u, dtype, device)
        b = torch.zeros((u,), dtype=dtype, device=device)
        return ({"W": w, "RW": rw, "b": b}, {},
                tuple(input_shape[:-1]) + (u,))

    def init_stream_state(self, params, batch):
        return (params["W"].new_zeros((batch, params["RW"].shape[0])),)

    def scan_with_state(self, params, x, carry, mask=None, grad_path=True):
        w, rw, b = params["W"], params["RW"], params["b"]
        act = _act.get(self.activation)

        def step(carry, inp):
            x_t, m_t, _ = inp
            (h,) = carry
            h_new = nnops.simple_rnn_cell(x_t, h, w, rw, b, activation=act)
            if m_t is not None:
                h_new = _gate(m_t, h_new, h)
            return (h_new,), h_new

        return _scan_ret(step, carry, x, mask, self.tbptt_length)


def _merge(mode, a, b):
    """Merge the forward and backward streams (Bidirectional modes)."""
    if mode == "concat":
        return torch.cat([a, b], dim=-1)
    if mode == "add":
        return a + b
    if mode == "mul":
        return a * b
    if mode == "average":
        return (a + b) / 2
    raise ValueError(f"unknown Bidirectional mode {mode!r}")


@layer("bidirectional")
class Bidirectional(_RecurrentLayer):
    """Bidirectional wrapper around a recurrent layer config (DL4J
    ``Bidirectional(Mode, layer)``). Modes: concat|add|mul|average.

    The backward direction runs on the time-flipped input; carry gating
    keeps end-padded (masked) steps from moving the state, so the flip is
    mask-correct. ``return_sequences=False`` gives each direction's last
    output merged: the forward stream's t = T-1 and the backward stream's
    own final position (its state after the original t = 0)."""
    layer: Any = None           # the wrapped recurrent Layer config
    mode: str = "concat"
    return_sequences: bool = True
    name: Optional[str] = None

    # the backward direction needs the whole future: DL4J throws too
    supports_streaming = False

    def initialize(self, gen, input_shape, dtype, device):
        p_fw, _, out = self.layer.initialize(gen, input_shape, dtype, device)
        p_bw, _, _ = self.layer.initialize(gen, input_shape, dtype, device)
        out = tuple(out)
        if self.mode == "concat":
            out = out[:-1] + (out[-1] * 2,)
        if not self.return_sequences:
            out = (out[-1],)
        return {"fw": p_fw, "bw": p_bw}, {}, out

    def init_stream_state(self, params, batch):
        return (self.layer.init_stream_state(params["fw"], batch),
                self.layer.init_stream_state(params["bw"], batch))

    def _directions(self, params, x, carry, mask, grad_path=True):
        y_fw, c_fw = self.layer.scan_with_state(params["fw"], x, carry[0],
                                                mask, grad_path=grad_path)
        m_rev = None if mask is None else torch.flip(mask, dims=(1,))
        y_bw, c_bw = self.layer.scan_with_state(
            params["bw"], torch.flip(x, dims=(1,)), carry[1], m_rev,
            grad_path=grad_path)
        return y_fw, y_bw, (c_fw, c_bw)

    def apply(self, params, x, state, *, train=False, mask=None):
        # never the forward-only path, as in the JAX package (:439-452)
        carry = self.init_stream_state(params, x.shape[0])
        y_fw, y_bw, _ = self._directions(params, x, carry, mask)
        if self.return_sequences:
            y = _merge(self.mode, y_fw, torch.flip(y_bw, dims=(1,)))
            return y, state, mask
        return _merge(self.mode, y_fw[:, -1], y_bw[:, -1]), state, None

    def scan_with_state(self, params, x, carry, mask=None, grad_path=True):
        y_fw, y_bw, c = self._directions(params, x, carry, mask, grad_path)
        return _merge(self.mode, y_fw, torch.flip(y_bw, dims=(1,))), c

    def to_dict(self):
        return {"kind": "bidirectional", "mode": self.mode,
                "return_sequences": self.return_sequences,
                "layer": self.layer.to_dict(), "name": self.name}

    @staticmethod
    def _from_dict_fields(d):
        return {"mode": d.get("mode", "concat"),
                "return_sequences": d.get("return_sequences", True),
                "layer": Layer.from_dict(d["layer"]), "name": d.get("name")}


@layer("last_timestep")
class LastTimeStep(Layer):
    """[B, T, F] -> [B, F]: the last unmasked timestep of each row (DL4J
    ``LastTimeStep``); a fully masked row gives its last step, as in the
    JAX package."""
    name: Optional[str] = None

    def has_params(self):
        return False

    def initialize(self, gen, input_shape, dtype, device):
        return {}, {}, (int(input_shape[-1]),)

    def apply(self, params, x, state, *, train=False, mask=None):
        if mask is None:
            return x[:, -1, :], state, None
        # argmax gives the first maximum, 0 for a row with none
        first = (torch.flip(mask, dims=(1,)) > 0).to(torch.int32).argmax(1)
        idx = x.shape[1] - 1 - first
        return x[torch.arange(x.shape[0], device=x.device), idx], state, None


@layer("rnn_output")
class RnnOutputLayer(OutputLayer):
    """Per-timestep dense + loss head on [B, T, F] (DL4J RnnOutputLayer):
    the last-axis matmul is already time-distributed."""


@layer("rnn_loss")
class RnnLossLayer(LossLayer):
    """Param-free per-timestep loss head (DL4J RnnLossLayer)."""
