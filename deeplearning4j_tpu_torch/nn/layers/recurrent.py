"""Recurrent layers: LSTM, LastTimeStep, RnnOutputLayer, RnnLossLayer.

Port of those layers of ``deeplearning4j_tpu/nn/layers/recurrent.py``,
with the same JSON kinds, fields and parameter layouts: activations are
``[B, T, F]`` (time second), ``W`` is ``[nIn, 4u]``, ``RW`` ``[u, 4u]`` and
``b`` ``[4u]``, gate order [i, f, o, g].

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
package (K8 is forward only).

Not in this slice: ``GravesLSTM``, ``GRU``, ``SimpleRnn``,
``Bidirectional`` and ``ConvLSTM2D`` (``ROADMAP.md`` Queue 1).
"""

from __future__ import annotations

from typing import Optional

import torch

from ...ops import nnops
from ...ops import pallas_kernels as _pk
from .. import weights as _winit
from .base import Layer, layer
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
