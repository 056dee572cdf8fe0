"""Parameter placement over a mesh of ranks, and the serving engines'
quantize-on-warmup params source.

Port of ``deeplearning4j_tpu/parallel/placement.py``: its training half
and ``QuantizedParamsMixin``.

**Training half** (:94-337). Specs are tuples of mesh-axis names (or
None) per dimension, the JAX ``PartitionSpec``'s entries; ``()`` is
replicated.

- :func:`tp_param_spec` (:142): the dense family's tensor-parallel rule
  (``W [in, out]`` shards its out dim over the model axis, ``b [out]``
  follows; everything else replicates). The attention family is the
  serving part of ROADMAP.md Queue 1 item 8 and raises here. Divergence:
  a dense layer whose out dim the model axis does not divide stays
  replicated (GSPMD pads an uneven shard; the port's column gather wants
  equal shards).
- :func:`put_full` / :func:`put_tree` (:230-267) give "this rank's shard
  of the full value": every rank holds the full value and keeps the slice
  its mesh coordinates own.
- :func:`tree_bytes_per_device` (:303), :func:`mesh_key` /
  :func:`mesh_suffix` (:281-294), :func:`load_checkpoint` (:324) as in
  JAX.
- :func:`flatten_paths` walks a tree in the JAX pytree order (dict keys
  sorted at every level), so bucketing and update specs see the leaves
  in the order the JAX package does.

**Quantize-on-warmup** (:340-460). With ``quantize="int8"``,
:meth:`QuantizedParamsMixin._serving_params` hands the forward a
per-channel int8 twin of ``model.params``, quantized once (at warm-up)
and again whenever the params change. The JAX mixin keys its cache on the
identity of ``model.params``, which ``fit`` rebinds; a port tree can also
change in place (an in-place tensor write, a sub-dict replaced), so the
key here is the params dict together with every leaf tensor's identity
and version counter (``Tensor._version``). The ``DL4J_TPU_QUANT=off``
pin, and a quantization error, degrade to f32 serving, sticky and counted
(``q_fallbacks``); a requantization is counted in ``q_requants``.
Counters are plain integers.

Divergence: no ``serving.quantize`` fault site (the runtime slice, ROADMAP
Queue 1 item 9). Serving placement over a mesh (``ParamsPlacement``,
``cache_sharding_tree``, ``attention_tp_heads``) is the serving part of
item 8.
"""

from __future__ import annotations

import logging
from typing import Dict, Optional, Set, Tuple

import torch

from ..ops import quantize as _q
from ..utils.tree import get_path, leaves

log = logging.getLogger(__name__)

_SERVING = "the serving part of ROADMAP.md Queue 1 item 8"


# ------------------------------------------------------ training placement
def path_names(path) -> Tuple[str, ...]:
    """A tree path as the tuple of its key names."""
    return tuple(str(k) for k in path)


def flatten_paths(tree, prefix=()):
    """``[(path, leaf)]`` in the JAX pytree order: dict keys sorted at
    every level (how ``tree_flatten_with_path`` walks a dict)."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(flatten_paths(tree[k], prefix + (str(k),)))
        return out
    return [(prefix, tree)]


def map_paths(fn, tree, prefix=()):
    """``fn(path, leaf)`` over a nested dict, keeping its structure."""
    if isinstance(tree, dict):
        return {k: map_paths(fn, v, prefix + (str(k),))
                for k, v in tree.items()}
    return fn(prefix, tree)


def _iter_layers(model):
    """(top-level param key, layer) pairs for both engines."""
    from ..nn.vertices import LayerVertex
    verts = getattr(model.conf, "vertices", None)
    if verts is not None:
        for name, v, _ in verts:
            if isinstance(v, LayerVertex):
                yield str(name), v.layer
        return
    for i, lyr in enumerate(model.layers):
        yield str(i), lyr


def dense_tp_keys(model) -> Set[str]:
    """Top-level param keys whose layer is in the dense family (dense,
    output, loss): the only layers tensor parallelism shards. Matching the
    leaf name ``W`` alone would also catch embedding tables and recurrent
    input kernels."""
    from ..nn.layers.core import DenseLayer, LossLayer, OutputLayer
    dense = (DenseLayer, OutputLayer, LossLayer)
    return {key for key, lyr in _iter_layers(model) if isinstance(lyr, dense)}


def tp_param_spec(names: Tuple[str, ...], leaf, model_axis: Optional[str],
                  tp: int, dense_keys: Set[str],
                  attn_heads: Optional[Dict[str, int]] = None) -> tuple:
    """Spec of one parameter leaf under tensor parallelism: the dense
    family only (the training contract)."""
    if attn_heads:
        raise NotImplementedError(
            f"attention tensor parallelism comes with {_SERVING}")
    if model_axis is None or tp <= 1 or not names:
        return ()
    if _q.is_quantized(leaf):
        leaf = leaf.q
    top, name = str(names[0]), str(names[-1])
    shape = tuple(getattr(leaf, "shape", ()))
    if top in dense_keys and shape and shape[-1] % tp == 0:
        if name == "W" and len(shape) == 2:
            return (None, model_axis)
        if name == "b" and len(shape) == 1:
            return (model_axis,)
    return ()


def shard_of(value, spec: tuple, mesh) -> torch.Tensor:
    """This rank's shard of the full ``value`` under ``spec`` on ``mesh``
    (each named dimension split into equal chunks along its axis)."""
    for dim, ax in enumerate(tuple(spec)):
        if ax is None:
            continue
        for a in (ax if isinstance(ax, tuple) else (ax,)):
            n = mesh.shape[a]
            if n > 1:
                value = value.chunk(n, dim=dim)[mesh.index(a)]
    return value


def put_full(value, spec: tuple, mesh, device=None) -> torch.Tensor:
    """Place one FULL value (every rank holds it whole) under ``spec``:
    this rank keeps its shard, on ``device`` when given."""
    t = value if torch.is_tensor(value) else torch.as_tensor(value)
    if device is not None:
        t = t.to(device)
    return shard_of(t, spec, mesh).contiguous()


def put_tree(tree, specs, mesh, device=None):
    """Per-leaf :func:`put_full` over matching trees."""
    if isinstance(tree, dict):
        return {k: put_tree(v, specs[k], mesh, device)
                for k, v in tree.items()}
    return put_full(tree, specs, mesh, device)


def mesh_key(mesh) -> str:
    """The mesh shape as ``"2x4"``."""
    return "x".join(str(s) for s in mesh.devices.shape)


def mesh_suffix(mesh, model_axis: Optional[str] = None) -> str:
    """Mesh shape and model-axis size, as the attribution cache keys a
    program placed on a mesh."""
    tp = int(mesh.shape[model_axis]) \
        if model_axis and model_axis in mesh.axis_names else 1
    return f"mesh={mesh_key(mesh)}:tp{tp}"


def tree_bytes_per_device(tree, specs, mesh) -> int:
    """Per-rank bytes of a tree placed under ``specs``: each leaf's bytes
    over the product of the axis sizes its spec splits."""
    total = 0
    for (path, leaf) in flatten_paths(tree):
        spec = get_path(specs, path) if isinstance(specs, dict) else specs
        nbytes = int(leaf.numel()) * leaf.element_size()
        denom = 1
        for ax in tuple(spec):
            if ax is None:
                continue
            for a in (ax if isinstance(ax, tuple) else (ax,)):
                denom *= int(mesh.shape[a])
        total += -(-nbytes // denom)
    return total


def load_checkpoint(model, directory: str, device=None):
    """Restore ``model`` in place from a ``TrainingCheckpointer``
    directory (gather-on-save makes it topology-independent); the engines'
    ``warmup(checkpoint=)`` rides this. Returns the restored step (None on
    an empty directory: the model keeps its parameters)."""
    from .checkpoint import TrainingCheckpointer
    ck = TrainingCheckpointer(directory)
    try:
        return ck.restore(model, device=device)
    finally:
        ck.close()


def _version(t) -> Optional[int]:
    try:
        return t._version
    except (AttributeError, RuntimeError):  # an inference-mode tensor
        return None


def params_key(params) -> list:
    """What decides whether a quantized twin of ``params`` is current: the
    dict itself and each leaf with its version counter (strong
    references, compared with ``is``: a freed tensor's address may be
    reused)."""
    return [params] + [(t, _version(t)) for t in leaves(params)]


def same_key(a, b) -> bool:
    if a is None or b is None or len(a) != len(b) or a[0] is not b[0]:
        return False
    return all(x[0] is y[0] and x[1] == y[1] for x, y in zip(a[1:], b[1:]))


def _check_mode(quantize):
    if quantize not in (None, "int8"):
        raise ValueError(f"unknown quantize mode {quantize!r} "
                         "(expected None or 'int8')")


class QuantizedParamsMixin:
    """Quantize-on-warmup params source shared by the serving engines.
    The host class has ``model``, ``_lock`` and ``_warmed``."""

    def _init_quantize(self, quantize: Optional[str]):
        _check_mode(quantize)
        self.quantize = quantize
        self._qparams = None
        self._qparams_key = None
        self._q_report = None
        self._q_disabled: Optional[str] = None   # sticky fallback reason
        #: requantizations after a params change, and f32 fallbacks
        self.q_requants = 0
        self.q_fallbacks = 0
        #: invalidation causes, in order (``set_quantize``: "quantize")
        self.invalidations = []

    def _serving_params(self):
        """The params tree the forward runs: the model's own, or its
        quantized twin, requantized when the params changed."""
        if self.quantize is None or self._q_disabled is not None:
            return self.model.params
        key = params_key(self.model.params)
        if same_key(key, self._qparams_key):
            return self._qparams
        if _q.mode() == "off" and self._qparams is None:
            self._q_disabled = "env_off"
            self.q_fallbacks += 1
            log.warning("DL4J_TPU_QUANT=off: engine quantize=%r request "
                        "serves f32", self.quantize)
            return self.model.params
        try:
            qparams, report = _q.quantize_model_params(self.model)
        except Exception as e:
            self.q_fallbacks += 1
            if self._qparams is not None:
                # a requantization failed after warm-up: keep serving the
                # previous quantized tree; the next params change retries
                log.warning("weight requantization failed (%s: %s); "
                            "serving the previous quantized params",
                            type(e).__name__, e)
                self._qparams_key = key
                return self._qparams
            self._q_disabled = "error"
            log.warning("weight quantization failed (%s: %s); serving "
                        "f32", type(e).__name__, e)
            return self.model.params
        if self._qparams_key is not None:
            self.q_requants += 1
        self._qparams = qparams
        self._qparams_key = key
        self._q_report = report
        return qparams

    def _invalidate(self, cause: str) -> None:
        """Forget every warmed bucket: the next call on each is cold until
        a re-warm."""
        with self._lock:
            self._warmed.clear()
            self.invalidations.append(cause)

    def set_quantize(self, quantize: Optional[str]):
        """Flip the engine's quantization mode; the warmed buckets are
        invalidated with cause ``quantize``: re-warm before traffic."""
        _check_mode(quantize)
        self.quantize = quantize
        self._qparams = None
        self._qparams_key = None
        self._q_report = None
        self._q_disabled = None
        self._invalidate("quantize")
        return self

    def _quantize_stats(self) -> dict:
        out = {"quantize": self.quantize or "off",
               "quantize_requants": self.q_requants,
               "quantize_fallbacks": self.q_fallbacks}
        if self._q_disabled is not None:
            out["quantize_fallback"] = self._q_disabled
        if self._q_report is not None:
            out["quantized_sites"] = self._q_report.sites
            out["quantized_bytes_saved"] = self._q_report.bytes_saved
            out["quantized_weight_bytes"] = _q.quantized_bytes(
                self._qparams)[1]
        return out
