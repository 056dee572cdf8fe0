"""Model save/load in the JAX package's ZIP format.

Port of ``save_model``/``load_model`` from
``deeplearning4j_tpu/utils/serializer.py``, for a ComputationGraph or a
MultiLayerNetwork (``model_class`` in the configuration). The archive
holds:

- ``configuration.json``: the network config (the same JSON);
- ``coefficients.npz``: params, keys ``"vertex/param"`` (a
  MultiLayerNetwork's vertex is its layer index);
- ``state.npz``: layer state (BN running statistics);
- ``updaterState.npz``: the updater state (Adam's m and v, keys
  ``"slot/vertex/param"``), when there is one and it is saved;
- ``meta.json``: iteration/epoch counters.

Layers round-trip by their JSON kind and parameter names, so a
MultiLayerNetwork with attention layers (``self_attention``,
``learned_self_attention``) saved by the JAX package loads here, and the
port's ZIP loads there (``tests/test_torch_generate.py`` serves one).

bfloat16 arrays are stored as their uint16 view, with the true dtype in a
``__dtypes__`` JSON entry inside the npz (numpy cannot save the extension
type). The port reads and writes that carrier without ``ml_dtypes``: the
uint16 view is reinterpreted as ``torch.bfloat16``. A ZIP the JAX
package saved mid-training resumes in the port, and the port's loads
there.
"""

from __future__ import annotations

import io
import json
import zipfile

import numpy as np
import torch

from .. import dtypes as _dt
from .. import environment as _env
from .convert import tensor_from_numpy

_CARRIER = {torch.bfloat16: "bfloat16"}


def _tree_to_npz_bytes(tree: dict) -> bytes:
    flat, true_dtypes = {}, {}

    def walk(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(f"{prefix}/{k}" if prefix else k, v)
            return
        t = node.detach().cpu()
        if t.dtype in _CARRIER:
            true_dtypes[prefix] = _CARRIER[t.dtype]
            flat[prefix] = t.view(torch.int16).numpy().view(np.uint16)
        else:
            flat[prefix] = t.numpy()

    walk("", tree)
    if true_dtypes:
        flat["__dtypes__"] = np.frombuffer(
            json.dumps(true_dtypes).encode(), dtype=np.uint8)
    buf = io.BytesIO()
    np.savez(buf, **flat)
    return buf.getvalue()


def _npz_bytes_to_tree(data: bytes, device) -> dict:
    tree: dict = {}
    with np.load(io.BytesIO(data)) as z:
        true_dtypes = {}
        if "__dtypes__" in z.files:
            true_dtypes = json.loads(z["__dtypes__"].tobytes().decode())
        for key in z.files:
            if key == "__dtypes__":
                continue
            a = z[key]
            kind = true_dtypes.get(key)
            if kind is None:
                t = tensor_from_numpy(a, device)
            elif kind == "bfloat16":
                t = torch.from_numpy(a.view(np.int16).copy()).view(
                    torch.bfloat16).to(device)
            else:
                raise ValueError(f"{key}: stored dtype {kind!r} is not "
                                 "supported by the port")
            parts = key.split("/")
            node = tree
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = t
    return tree


def save_model(model, path, save_updater: bool = True) -> None:
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as zf:
        zf.writestr("configuration.json", model.conf.to_json())
        zf.writestr("coefficients.npz", _tree_to_npz_bytes(model.params))
        zf.writestr("state.npz", _tree_to_npz_bytes(model.state))
        if save_updater and model.updater_state:
            zf.writestr("updaterState.npz",
                        _tree_to_npz_bytes(model.updater_state))
        zf.writestr("meta.json", json.dumps(
            {"iteration": model.iteration, "epoch": model.epoch,
             "format": "deeplearning4j_tpu", "version": 1}))


def load_model(path, device=None, load_updater: bool = True):
    """A ComputationGraph or MultiLayerNetwork (``model_class`` in its
    ``configuration.json``) from a ZIP written by either package, on
    ``device`` (``cuda`` unless the caller asks for ``cpu``), with its
    updater state when the ZIP holds one (else a fresh one)."""
    from ..nn.config import MultiLayerConfiguration
    from ..nn.graph import ComputationGraph, ComputationGraphConfiguration
    from ..nn.model import MultiLayerNetwork

    device = _env.resolve_device(device)
    with zipfile.ZipFile(path, "r") as zf:
        conf_json = zf.read("configuration.json").decode()
        model_class = json.loads(conf_json).get("model_class",
                                                "MultiLayerNetwork")
        if model_class == "ComputationGraph":
            model = ComputationGraph(
                ComputationGraphConfiguration.from_json(conf_json))
        else:
            model = MultiLayerNetwork(
                MultiLayerConfiguration.from_json(conf_json))
        model.init(device=device)  # builds structure; then overwrite
        # masters are f32 under the mixed-precision policy
        pdt = _dt.param_dtype(model.conf.dtype)
        model.params = _dt.cast_floating(
            _npz_bytes_to_tree(zf.read("coefficients.npz"), device), pdt)
        model.state = _npz_bytes_to_tree(zf.read("state.npz"), device)
        if load_updater and "updaterState.npz" in zf.namelist():
            model.updater_state = _dt.cast_floating(
                _npz_bytes_to_tree(zf.read("updaterState.npz"), device), pdt)
        if "meta.json" in zf.namelist():
            meta = json.loads(zf.read("meta.json"))
            model.iteration = meta.get("iteration", 0)
            model.epoch = meta.get("epoch", 0)
    return model
