"""Carry the JAX package's parameter and state trees into the port.

The JAX package keys ``net.params``/``net.state`` by vertex name, then by
parameter name (``{"stem_conv": {"W": ...}, "stem_bn": {"gamma": ...}}``),
with the same layouts the port uses (OIHW conv weights, Dense ``W`` as
``[nIn, nOut]``); a MultiLayerNetwork's are keyed by layer index (``{"0":
{"W": ..., "RW": ..., "b": ...}}``), LSTM gates in the same [i, f, o, g]
order on both sides, so nothing is reordered. :func:`from_numpy` turns such a tree of numpy arrays
(or of anything ``np.asarray`` accepts) into the port's tree of tensors;
it carries the updater state tree too (``net.updater_state``, keyed by
slot and then the same way), so both packages can start from the same
Adam m and v. :func:`samediff_from_numpy` does the same for a SameDiff
graph: its ``graph.json`` and its values by graph name.

A quantized weight of the JAX package (its ``ops.quantize.QuantizedTensor``,
or anything with ``q``, ``scale`` and ``axis`` and the
``__quantized_tensor__`` marker, such as :class:`QuantizedArrays`) becomes
the port's ``QuantizedTensor``; :func:`to_numpy` carries the port's trees
back as numpy, a quantized weight as :class:`QuantizedArrays`.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import environment as _env


def tensor_from_numpy(a, device="cpu") -> torch.Tensor:
    """One array as a tensor on ``device``. A bfloat16 array (numpy's
    ``ml_dtypes`` extension type, or its uint16 carrier) is reinterpreted
    bit for bit as ``torch.bfloat16``; the port never imports
    ``ml_dtypes``."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        a = a.view(np.uint16)
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16).to(device)
    # np.array, not np.ascontiguousarray: that one makes a 0-d array 1-d
    return torch.from_numpy(np.array(a, order="C", copy=True)).to(device)


class QuantizedArrays(NamedTuple):
    """A quantized weight as host arrays: int8 ``q``, f32 ``scale`` along
    ``axis``; the JAX package builds its own ``QuantizedTensor(q, scale,
    axis)`` from these three."""
    q: np.ndarray
    scale: np.ndarray
    axis: int

    __quantized_tensor__ = True


def _tree(node, device):
    if isinstance(node, dict):
        return {k: _tree(v, device) for k, v in node.items()}
    if getattr(node, "__quantized_tensor__", False):
        from ..ops.quantize import QuantizedTensor
        return QuantizedTensor(tensor_from_numpy(node.q, device),
                               tensor_from_numpy(node.scale, device),
                               int(node.axis))
    return tensor_from_numpy(node, device)


def to_numpy(tree):
    """The port's tree of tensors as numpy arrays (a 16-bit tensor as
    float32), each quantized weight as :class:`QuantizedArrays`."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if getattr(tree, "__quantized_tensor__", False):
        return QuantizedArrays(to_numpy(tree.q), to_numpy(tree.scale),
                               int(tree.axis))
    t = tree.detach().cpu()
    if t.dtype in (torch.bfloat16, torch.float16):
        t = t.float()
    return t.numpy()


def from_numpy(params: dict, state: dict, device=None, *,
               updater_state=None):
    """``(params, state)`` of the JAX package, keyed exactly as its
    ``net.params``/``net.state``, as the port's trees of tensors on
    ``device`` (``cuda`` unless the caller asks for ``cpu``). Given
    ``updater_state`` (its ``net.updater_state``), returns ``(params,
    state, updater_state)``."""
    device = _env.resolve_device(device)
    out = (_tree(params, device), _tree(state, device))
    if updater_state is None:
        return out
    return out + (_tree(updater_state, device),)


def samediff_from_numpy(graph_json: str, values: dict, device=None):
    """The port's SameDiff for a JAX SameDiff's ``to_json()`` and its
    values (``{name: array}``, e.g. ``{n: np.asarray(v) for n, v in
    sd._values.items()}``), on ``device`` (``cuda`` unless the caller asks
    for ``cpu``)."""
    from ..autodiff.samediff import SameDiff
    sd = SameDiff.from_json(graph_json, device)
    for name, value in values.items():
        if name not in sd._vars:
            raise ValueError(f"value {name!r} names no variable of the graph")
        sd._values[name] = tensor_from_numpy(value, sd.device)
    return sd
