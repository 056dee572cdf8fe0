"""Layer base protocol and registry.

Port of ``deeplearning4j_tpu/nn/layers/base.py``. A layer IS its config (a
dataclass registered under its JSON ``kind``); parameters and state live
in dicts of tensors owned by the model, keyed by parameter name as in the
JAX package, so its ``configuration.json`` and ``coefficients.npz`` load
unchanged.

Protocol:

- ``initialize(gen, input_shape, dtype, device) -> (params, state,
  output_shape)``; ``input_shape`` excludes the batch dim and ``gen`` is a
  CPU ``torch.Generator``.
- ``apply(params, x, state, *, train=False, mask=None) -> (y, new_state,
  new_mask)``;
- the autoregressive decode protocol (the JAX module's :56, :83-137):
  ``decode_pointwise``, ``decode_cache_spec``, ``prefill`` and
  ``decode_step``. A cache spec is a dict of :class:`CacheSpec` (shape and
  dtype) where the JAX package returns ``jax.ShapeDtypeStruct``s.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

LAYERS: Dict[str, type] = {}


def layer(kind: str):
    """Class decorator: make a dataclass layer and register it for serde."""
    def deco(cls):
        cls = dataclasses.dataclass(cls)
        cls.kind = kind
        LAYERS[kind] = cls
        return cls
    return deco


class CacheSpec(NamedTuple):
    """Shape and dtype of one decode-cache tensor."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


class Layer:
    kind = "base"
    name: Optional[str] = None

    #: True when ``apply``'s output at time step t depends only on the
    #: input at step t (dense, activation and output heads): such a layer
    #: runs unchanged on a ``[B, 1, F]`` slice in the decode walk. A layer
    #: with temporal state carries a KV cache (``decode_cache_spec``
    #: returns a spec) or cannot decode (recurrent and conv stacks: the
    #: walk raises). Default False: a layer opts in.
    decode_pointwise = False

    #: True when the layer's matmul/conv weights may be quantized to
    #: per-channel int8 for serving (dense, output, conv and the attention
    #: projections, as in the JAX package); norms, embeddings and recurrent
    #: cells stay as they are
    quantizable = False

    def quantize_spec(self, params):
        """``{param_name: output_channel_axis}`` for the weights the
        post-training quantization walk (``ops/quantize.py``) turns into
        ``QuantizedTensor``; consulted only when ``quantizable``."""
        return {}

    def initialize(self, gen, input_shape, dtype, device):
        """-> (params: dict, state: dict, output_shape: tuple)"""
        return {}, {}, tuple(input_shape)

    def apply(self, params, x, state, *, train=False, mask=None):
        """-> (y, new_state, out_mask)"""
        raise NotImplementedError

    # -- autoregressive decode protocol (KV-cache serving) -----------------
    def decode_cache_spec(self, params, batch, cache_len, dtype,
                          kv_quant: bool = False):
        """The layer's decode cache as ``{name: CacheSpec}`` (``{"k": ...,
        "v": ...}`` for attention), or None when it carries none."""
        return None

    def prefill(self, params, x, state, *, cache, lengths, mask=None):
        """Prompt phase: fill ``cache`` from the end-padded prompt ``x``
        ``[B, T, F]`` and return ``(y, cache)``. Default (no cache): the
        inference ``apply`` with the prompt key mask."""
        y, _, _ = self.apply(params, x, state, train=False, mask=mask)
        return y, cache

    def decode_step(self, params, x, state, *, cache, lengths, write=None):
        """One decode token: ``x`` ``[B, 1, F]``, ``lengths`` ``[B]`` the
        tokens already cached, ``write`` ``[B]`` the optional gate of the
        rows whose caches this token enters. Returns ``(y, cache)``.
        Default: a time-pointwise layer re-runs ``apply`` on the slice;
        any other raises."""
        if not self.decode_pointwise:
            raise ValueError(
                f"layer kind {self.kind!r} cannot run in the "
                "autoregressive decode walk: it is neither time-pointwise "
                "nor KV-cached (set decode_pointwise=True or implement "
                "decode_cache_spec/prefill/decode_step)")
        y, _, _ = self.apply(params, x, state, train=False, mask=None)
        return y, cache

    def has_params(self) -> bool:
        return True

    def to_dict(self) -> Dict[str, Any]:
        d = {"kind": self.kind}
        for f in dataclasses.fields(self):
            d[f.name] = _encode(getattr(self, f.name))
        return d

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "Layer":
        d = dict(d)
        kind = d.pop("kind")
        if kind not in LAYERS:
            raise ValueError(f"Unknown layer kind {kind!r}; known: "
                             f"{sorted(LAYERS)}")
        cls = LAYERS[kind]
        if hasattr(cls, "_from_dict_fields"):  # wrappers of a nested layer
            return cls(**cls._from_dict_fields(d))
        field_names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: _decode(v) for k, v in d.items()
                      if k in field_names})


def _encode(v):
    if isinstance(v, tuple):
        return list(v)
    return v


def _decode(v):
    if isinstance(v, list):
        return tuple(v)
    return v
