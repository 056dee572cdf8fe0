"""The serving engines' params source: quantize-on-warmup int8 serving.

Port of ``QuantizedParamsMixin`` from
``deeplearning4j_tpu/parallel/placement.py`` (:340-460). With
``quantize="int8"``, :meth:`QuantizedParamsMixin._serving_params` hands the
forward a per-channel int8 twin of ``model.params``, quantized once (at
warm-up) and again whenever the params change. The JAX mixin keys its
cache on the identity of ``model.params``, which ``fit`` rebinds; a port
tree can also change in place (an in-place tensor write, a sub-dict
replaced), so the key here is the params dict together with every leaf
tensor's identity and version counter (``Tensor._version``). The
``DL4J_TPU_QUANT=off`` pin, and a quantization error, degrade to f32
serving, sticky and counted (``q_fallbacks``); a requantization is counted
in ``q_requants``. Counters are plain integers.

Divergence: no ``serving.quantize`` fault site (the runtime slice, ROADMAP
Queue 1 item 9). Meshes and parameter placement come with item 8.
"""

from __future__ import annotations

import logging
from typing import Optional

from ..ops import quantize as _q
from ..utils.tree import leaves

log = logging.getLogger(__name__)


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
