"""The fused LSTM step's dispatch (K8).

Port of ``deeplearning4j_tpu/ops/pallas_kernels.py``; the name is kept so
a reader finds it. The recurrent layers call :func:`lstm_cell_fused` on
their inference and streaming paths when ``use_pallas_cell`` is set
(``nn/layers/recurrent.py``); it counts one decision per call in
:func:`counters` (the counters are this package's own):

- ``fused``: a CUDA tensor: K8 (``kernels/lstm_cell.py``) runs;
- ``fallback_platform``: a CPU tensor: K8's plain version runs.

A CUDA input K8 cannot take (float64, mixed dtypes, a weight that is not
contiguous) raises; it never falls back.

Divergences from the JAX package, by design:

- No shape fallback and no VMEM budget. The reference's ``fits_vmem``
  holds the operands to 8 MB of TPU VMEM and above it quietly runs
  ``nnops.lstm_cell``; K8 tiles its operands itself, so every step the
  flag routes here runs K8, at any batch and width.
- No ``available()`` switch: the device of the tensors decides, and a CPU
  tensor runs K8's plain version (the JAX layer runs ``nnops.lstm_cell``
  off the TPU), which rounds at the kernel's points for 16-bit inputs.
"""

from __future__ import annotations

import collections

from ..kernels import lstm_cell as _k8

_COUNTER_KEYS = ("fused", "fallback_platform")
_counts = collections.Counter()


def counters() -> dict:
    """Dispatch-decision counts since the last reset (one per call)."""
    return {k: int(_counts[k]) for k in _COUNTER_KEYS}


def reset_counters() -> None:
    _counts.clear()


def lstm_cell_fused(x, h, c, w_ih, w_hh, b, forget_bias: float = 0.0):
    """Fused LSTM step (gate order [i,f,o,g], matching ``nnops.lstm_cell``):
    ``(h', c')`` in x's dtype, both products accumulated in f32 and the
    whole gate chain in f32. K8 for a CUDA tensor, its plain version for a
    CPU tensor."""
    kind = x.device.type
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"lstm_cell_fused: tensors on {x.device} are not "
                         "supported (cuda or cpu)")
    _counts["fused" if kind == "cuda" else "fallback_platform"] += 1
    return _k8.lstm_cell(x, h, c, w_ih, w_hh, b, forget_bias)
