"""InferenceEngine: bucketed inference for serving.

Port of ``InferenceEngine`` from ``deeplearning4j_tpu/serving/engine.py``,
over a ComputationGraph or a MultiLayerNetwork. The batch dimension of
every request pads up to a power-of-two bucket, so the device sees a
small, fixed set of shapes (on the card: a bounded set of cuDNN algorithm
choices and kernel shapes, all exercised by :meth:`InferenceEngine.warmup`
before traffic); padded rows never influence real rows (inference is per
example) and are sliced off.

Sequence inputs (an input type ``[T, F]``, ``InputType.recurrent``) are
detected as the JAX engine detects them: the time axis of such an input
pads to ``next_bucket(T)`` on every request, with a ``[B, T_bucket]``
float mask (1 for a real step, 0 for padding and padded rows), from
``lengths`` when the caller gives each row's true length. Per-timestep
outputs are sliced back to T exactly (``_unpad``).

``quantize="int8"`` serves a per-channel int8 twin of the params
(``parallel/placement.QuantizedParamsMixin``): quantized once at
``warmup``, again after any change to the model's params, with the
activations quantized per example inside each forward (``ops/quantize.py``:
``torch._int_mm`` on the card). ``eval.quantization.quantization_gate``
holds it against the f32 engine.

Divergences from the JAX engine: there is no ahead-of-time compile, so
``warmup`` runs one eager forward per bucket and the counter the JAX
engine calls ``compiles`` is ``cold_calls`` here (requests that landed on
a bucket not warmed); ``memory_report`` measures one forward (its peak on
the card) instead of reading a compiled program. Meshes and tensor
parallelism wait for their slice.

:class:`GenerativeEngine` is the port of the JAX module's
``GenerativeEngine`` (:921) with :class:`DecodeState` (:848) and
:class:`HorizonChain`/:class:`HorizonResult` (:862-920): KV-cached
autoregressive decode for one MultiLayerNetwork over a fixed slot batch.
``prefill`` fills one slot from a prompt padded to the smallest warmed
prompt bucket (K3 in each attention layer on the card); ``decode`` runs
one token for the whole slot batch with ``write = active`` (K9 in each
attention layer); ``decode_multi`` runs a horizon of ``k <= kmax`` decode
steps with on-device sampling, featurization and EOS freezing, and one
host readback per horizon (:meth:`HorizonResult.fetch`); ``grow``
re-buckets the caches by zero padding along the cache axis.

Divergences from the JAX engine, by design:

- Eager execution: no executables. ``warmup`` runs one prefill per
  (prompt bucket, cache bucket) and one decode (or one horizon) per cache
  bucket on a scratch state, and ``cold_calls`` stands in for
  ``compiles``. The horizon is a Python loop of eager steps; ``k`` is
  any runtime value.
- The state is updated IN PLACE: ``prefill``, ``decode`` and
  ``decode_multi`` write the passed state's caches and lengths and
  return it (the JAX engine donates the caches, so there too the passed
  state is consumed). A call that raises part-way leaves a consumed
  state: the continuous batcher rebuilds a fresh one.
- A ``torch.Generator`` on the engine's device takes the place of the
  threaded PRNG key (stochastic sampling agrees in distribution only).
- ``mesh=`` raises ``NotImplementedError`` naming its slice (item 8b of
  ``ROADMAP.md`` Queue 1, tensor-parallel serving); ``warmup(checkpoint=dir)``
  restores the model from a ``TrainingCheckpointer`` directory first
  (``parallel.placement.load_checkpoint``); ``attribution_report`` and
  ``decode_multi_traceable`` (the MFU attribution and the static-check
  probe) come with the runtime slice.

:class:`PagedGenerativeEngine` (the JAX module's :1645-2396) with
:class:`PagedDecodeState` (:1620) keeps the slots' caches as pages of one
pool per layer, owned by ``kv_pool.PagedKVPool``: ``prefill`` scatters a
prompt through the slot's page-table row, ``decode`` / ``verify`` /
``pdecode_multi`` run one token, a speculative window of k tokens (K10 in
each attention layer on the card) or a horizon over the pool, ``grow``
widens the table on the host, and ``prepare_write`` / ``fork`` make a
shared page private before it is written. ``export_pages`` /
``import_pages`` (the JAX module's :2027-2242) move whole pages between
two pools for disaggregated serving (``serving/disagg.py``): one gather
or one gated scatter per page-count bucket and layer leaf, one host copy
per leaf, chunked over the warmed ``migrate_buckets`` as the JAX engine
chunks over its compiled ones.

``quantize="int8"`` runs every prefill and decode over the int8 params
twin; ``kv_cache="int8"`` keeps the caches (pools too) as int8 values with
per-row f32 scales beside them, quantized on append and read dequantized
by K9/K10, which halves ``cache_bytes``.

``pool_label`` names the engine's pool (``"prefill"``, ``"decode"``,
``"default"``) in ``stats()``; the JAX engines label their telemetry
cells with it, and the port has no telemetry registry yet.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import dtypes as _dt
from .. import environment as _env
from ..ops import flash_attention as _fa
from ..ops import quantize as _q
from ..ops import sampling as _smp
from ..parallel import placement as _pl
from ..parallel.placement import QuantizedParamsMixin
from ..utils.convert import tensor_from_numpy
from ..utils.tree import leaves as _leaves


def _dtype_name(a) -> str:
    """The numpy-style name of a payload leaf's dtype (``"float32"``,
    ``"bfloat16"``), for a torch tensor or a numpy array alike."""
    if isinstance(a.dtype, torch.dtype):
        return str(a.dtype).replace("torch.", "")
    return np.dtype(a.dtype).name


def _layout(tree) -> dict:
    """``{layer: [leaf names]}`` of a payload or pool spec, for messages."""
    if not isinstance(tree, dict):
        return type(tree).__name__
    return {k: sorted(v) if isinstance(v, dict) else type(v).__name__
            for k, v in tree.items()}


def _host_tensor(a) -> torch.Tensor:
    """A payload leaf as a CPU tensor: a tensor moves to the host, a numpy
    array is copied in (a numpy bfloat16, as the JAX package holds it,
    from its raw 2-byte words)."""
    return a.cpu() if torch.is_tensor(a) else tensor_from_numpy(a)


def next_bucket(n: int, minimum: int = 1) -> int:
    """Smallest power of two >= n (and >= minimum)."""
    b = max(1, int(minimum))
    while b < n:
        b <<= 1
    return b


def default_buckets(max_batch: int = 64, minimum: int = 1) -> List[int]:
    """Power-of-two ladder [minimum..max_batch]."""
    out, b = [], max(1, int(minimum))
    while b <= max_batch:
        out.append(b)
        b <<= 1
    return out


class InferenceEngine(QuantizedParamsMixin):
    """Bucketed ``output()`` for one ComputationGraph or
    MultiLayerNetwork.

    Usage::

        eng = InferenceEngine(net, device="cuda")
        eng.warmup([1, 2, 4, 8, 16, 32])   # every bucket runs once
        y = eng.output(x)                  # any batch size, numpy out
        y = eng.output(seqs, lengths=[...])  # ragged sequences, masked
        eng.stats()                        # calls / hits / padded rows

    ``device`` must be the model's device (``cuda`` unless the caller asks
    for ``cpu``; raises without CUDA). ``quantize="int8"`` serves the int8
    params twin (quantized at ``warmup``)."""

    def __init__(self, model, device=None, min_bucket: int = 1,
                 quantize: Optional[str] = None):
        device = _env.resolve_device(device)
        if model.device is None:
            raise RuntimeError("the model is not initialized; call "
                               "init(device=...) first")
        if torch.device(model.device).type != device.type:
            raise ValueError(f"the model lives on {model.device}; this "
                             f"engine was asked for {device}")
        self.model = model
        self.device = device
        self.min_bucket = max(1, int(min_bucket))
        conf = model.conf
        self._is_graph = hasattr(conf, "inputs")
        if self._is_graph:
            self._names = list(conf.inputs)
            self._input_shapes = [tuple(conf.input_shapes[n])
                                  for n in self._names]
        else:
            self._names = ["input"]
            self._input_shapes = [tuple(conf.input_shape)]
        # [T, F] input convention (InputType.recurrent) => the runtime
        # tensor is [B, T, F] and axis 1 is a bucketed sequence
        self._seq_input = [len(s) == 2 for s in self._input_shapes]
        self._lock = threading.Lock()
        self._warmed: set = set()
        self._calls = 0
        self._hits = 0
        self._cold = 0
        self._padded = 0
        self._bucket_hits: Dict[str, int] = {}
        self._init_quantize(quantize)

    def _label(self, key: Tuple) -> str:
        b, t = key
        return str([(b,) + ((t,) + s[1:] if q else s)
                    for s, q in zip(self._input_shapes, self._seq_input)])

    def _run(self, xs: List[torch.Tensor], masks: List[Optional[torch.Tensor]]):
        model = self.model
        params = self._serving_params()
        with torch.inference_mode(), _env.precision(self.device):
            if not self._is_graph:
                out, _, _ = model._forward(params, xs[0], model.state,
                                           train=False, mask=masks[0])
                return [out]
            acts, _, _ = model._forward(
                params, dict(zip(self._names, xs)), model.state,
                train=False, masks={n: m for n, m in zip(self._names, masks)
                                    if m is not None})
        return [acts[o] for o in model.conf.outputs]

    def _zero_batch(self, b: int, t: Optional[int]):
        """Zero inputs (and full masks) at batch bucket ``b`` and sequence
        bucket ``t``, in the network's floating dtype."""
        dt = _dt.resolve(self.model.conf.dtype)
        if not dt.is_floating_point:
            dt = torch.float32
        xs, masks = [], []
        for s, q in zip(self._input_shapes, self._seq_input):
            xs.append(torch.zeros((b,) + ((t,) + s[1:] if q else s),
                                  dtype=dt, device=self.device))
            masks.append(torch.ones((b, t), device=self.device)
                         if q else None)
        return xs, masks

    def _seq_buckets(self, seq_buckets) -> List[Optional[int]]:
        if not any(self._seq_input):
            return [None]
        if seq_buckets:
            return sorted(set(next_bucket(t) for t in seq_buckets))
        ts = [s[0] for s, q in zip(self._input_shapes, self._seq_input) if q]
        if any(t is None or t <= 0 for t in ts):
            raise ValueError("model has dynamic sequence length: pass "
                             "warmup(seq_buckets=[...])")
        return sorted(set(next_bucket(t) for t in ts))

    def warmup(self, buckets: Optional[Sequence[int]] = None,
               seq_buckets: Optional[Sequence[int]] = None,
               checkpoint: Optional[str] = None) -> "InferenceEngine":
        """Run one forward at every (batch bucket x sequence bucket) now
        (zeros in, full masks), so the first request that lands on it meets
        warm library state (cuDNN algorithm choice, the kernel libraries
        built). ``seq_buckets`` applies to sequence inputs; it defaults to
        the configured T when that is static and is required when it is
        dynamic (-1). ``checkpoint=<dir>``: restore the model from a
        ``TrainingCheckpointer`` directory first (the JAX engine's
        :425-443)."""
        if checkpoint is not None:
            _pl.load_checkpoint(self.model, checkpoint, device=self.device)
        if not buckets:
            buckets = default_buckets(max(64, self.min_bucket),
                                      minimum=self.min_bucket)
        for b in sorted(set(next_bucket(b, self.min_bucket)
                            for b in buckets)):
            for t in self._seq_buckets(seq_buckets):
                self._run(*self._zero_batch(b, t))
                with self._lock:
                    self._warmed.add((b, t))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self

    def output(self, *inputs, lengths=None):
        """Run inference on a ragged-size request batch: one array (numpy
        or tensor) per model input, batch first. ``lengths``: optional
        per-row true sequence lengths ``[B]`` for sequence inputs (rows
        end-padded to a common T): the padded steps are masked out of the
        computation exactly. Returns the unpadded output as numpy (a list
        when a graph has several outputs); 16-bit outputs come back as
        float32, numpy having no bfloat16."""
        if len(inputs) != len(self._names):
            raise ValueError(f"model takes {len(self._names)} inputs, got "
                             f"{len(inputs)}")
        xs = [x if torch.is_tensor(x) else torch.from_numpy(
            np.ascontiguousarray(x)) for x in inputs]
        n = int(xs[0].shape[0])
        b = next_bucket(n, self.min_bucket)
        dt = _dt.resolve(self.model.conf.dtype)
        xs_p, masks, seq_lens = [], [], []
        for x, is_seq in zip(xs, self._seq_input):
            if x.is_floating_point() and dt.is_floating_point \
                    and x.dtype != dt:
                x = x.to(dt)
            mask = None
            if is_seq:
                t = int(x.shape[1])
                tb = next_bucket(t)
                ln = torch.full((n,), t) if lengths is None \
                    else torch.as_tensor(np.asarray(lengths))
                mask = (torch.arange(tb)[None, :]
                        < ln[:, None]).to(torch.float32)
                if tb != t:
                    x = torch.cat([x, x.new_zeros(
                        (n, tb - t) + tuple(x.shape[2:]))], dim=1)
                if b != n:
                    mask = torch.cat([mask, mask.new_zeros((b - n, tb))])
                seq_lens.append((t, tb))
                mask = mask.to(self.device)
            else:
                seq_lens.append(None)
            if b != n:
                x = torch.cat([x, x.new_zeros((b - n,) + tuple(x.shape[1:]))])
            xs_p.append(x.to(self.device))
            masks.append(mask)
        key = (b, next((p[1] for p in seq_lens if p is not None), None))
        with self._lock:
            self._calls += 1
            self._padded += b - n
            if key in self._warmed:
                self._hits += 1
            else:
                self._cold += 1
            label = self._label(key)
            self._bucket_hits[label] = self._bucket_hits.get(label, 0) + 1
        outs = self._run(xs_p, masks)
        res = [self._unpad(o, n, seq_lens) for o in outs]
        return res if len(res) > 1 else res[0]

    @staticmethod
    def _unpad(out: torch.Tensor, n: int, seq_lens) -> np.ndarray:
        out = out[:n]
        # slice the time axis back only for per-timestep outputs whose dim
        # 1 matches the padded bucket EXACTLY ([B, T_bucket, ...]); pooled
        # heads ([B, C]) keep their shape. With several sequence inputs of
        # different lengths the alignment is ambiguous: keep the padded
        # time axis rather than guess, as the JAX engine does.
        pairs = {p for p in seq_lens if p is not None}
        if len(pairs) == 1:
            t, tb = next(iter(pairs))
            if t != tb and out.dim() >= 3 and out.shape[1] == tb:
                out = out[:, :t]
        if out.dtype in (torch.bfloat16, torch.float16):
            out = out.float()
        return out.cpu().numpy()

    def memory_report(self, bucket: int, seq_buckets=None) -> dict:
        """The bytes of ONE serving bucket: the params split (``params_bytes``
        and the int8 ``quantized_weight_bytes`` of the tree the forward
        runs), what a forward is fed (``argument_bytes``: params, state and
        inputs) and returns, and on the card the peak allocation of one
        measured forward (``peak_bytes``; None on the CPU). The JAX engine
        reads these from its compiled program; here one forward runs."""
        b = next_bucket(int(bucket), self.min_bucket)
        t = self._seq_buckets(seq_buckets)[0]
        params = self._serving_params()
        total, qbytes = _q.quantized_bytes(params)
        state_bytes = sum(a.numel() * a.element_size()
                          for a in _leaves(self.model.state))
        xs, masks = self._zero_batch(b, t)
        in_bytes = sum(x.numel() * x.element_size() for x in xs)
        cuda = self.device.type == "cuda"
        if cuda:
            torch.cuda.synchronize(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)
            base = torch.cuda.memory_allocated(self.device)
        outs = self._run(xs, masks)
        out_bytes = sum(o.numel() * o.element_size() for o in outs)
        peak = None
        if cuda:
            torch.cuda.synchronize(self.device)
            peak = torch.cuda.max_memory_allocated(self.device)
        arg = total + state_bytes + in_bytes
        return {"bucket": b, "seq_len": t,
                "quantize": self.quantize or "off",
                "params_bytes": total, "params_bytes_per_device": total,
                "quantized_weight_bytes": qbytes,
                "argument_bytes": arg, "output_bytes": out_bytes,
                "peak_bytes": peak,
                "temp_bytes": None if peak is None
                else max(0, peak - base - out_bytes)}

    def stats(self) -> dict:
        with self._lock:
            out = {
                "calls": self._calls,
                "hits": self._hits,
                "cold_calls": self._cold,
                "padded_rows": self._padded,
                "warmed_buckets": sorted({b for b, _ in self._warmed}),
                "warmed_seq_buckets": sorted({t for _, t in self._warmed
                                              if t is not None}),
                "bucket_hits": dict(self._bucket_hits),
            }
        out.update(self._quantize_stats())
        return out


# ===========================================================================
# Autoregressive decode: GenerativeEngine
# ===========================================================================

_PARALLEL = ("tensor-parallel serving, the serving part of the parallel "
             "slice (ROADMAP.md Queue 1 item 8b)")


class DecodeState:
    """The live state of one decode batch: per-layer KV caches at the
    current cache bucket and the per-slot valid lengths (int32 on the
    device). The continuous batcher owns it; the engine updates it in
    place."""

    __slots__ = ("caches", "lengths", "cache_len")

    def __init__(self, caches, lengths, cache_len: int):
        self.caches = caches          # {layer: {"k": [S,H,C,d], "v": ...}}
        self.lengths = lengths        # [S] int32 on the device
        self.cache_len = int(cache_len)


class HorizonChain:
    """What the next horizon needs from the last one: the next-step
    features and the live mask on the device, and the sampling generator;
    on the paged engine also the device-carried lengths (the contiguous
    engine advances them in its state)."""

    __slots__ = ("x_t", "active", "generator", "lengths")

    def __init__(self, x_t, active, generator, lengths=None):
        self.x_t = x_t
        self.active = active
        self.generator = generator
        self.lengths = lengths


class HorizonResult:
    """One dispatched multi-token decode horizon: ``toks`` ``[kmax, S]``,
    ``logits`` ``[kmax, S, V]`` and ``actives`` ``[kmax, S]`` (rows ``>= k``
    are zero); ``actives[j, s] == 1`` iff slot ``s`` really emitted token
    j (an EOS mid-horizon, or ``j >= k``, freezes the tail, so per-slot
    emission is a prefix). On the card the three are copied to pinned host
    memory behind the horizon's kernels as it is dispatched, and
    :meth:`fetch` waits for that copy alone: the horizon's one readback,
    which a horizon dispatched after it does not delay."""

    __slots__ = ("k", "chain", "_host", "_event", "_cached")

    def __init__(self, toks, logits, actives, chain, k):
        if logits.dtype in (torch.bfloat16, torch.float16):
            logits = logits.float()
        self._event = None
        if toks.device.type == "cuda":
            self._host = tuple(t.to("cpu", non_blocking=True)
                               for t in (toks, logits, actives))
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host = (toks, logits, actives)
        self.chain = chain
        self.k = int(k)
        self._cached = None

    def fetch(self):
        """Host ``(toks [kmax, S], logits [kmax, S, V], actives [kmax,
        S])`` numpy, once the horizon's device work is done. Idempotent."""
        if self._cached is None:
            if self._event is not None:
                self._event.synchronize()
            self._cached = tuple(t.numpy() for t in self._host)
        return self._cached


class GenerativeEngine(QuantizedParamsMixin):
    """Bucketed KV-cached autoregressive decode for one MultiLayerNetwork
    (the JAX package's ``GenerativeEngine``), eager.

    - ``slots``: the decode batch; every decode runs the full slot batch,
      so requests join and leave at token boundaries without changing a
      shape (slot rows are independent).
    - :meth:`prefill`: one request's prompt fills its slot's cache rows
      and returns the last valid position's logits (the first generated
      token's distribution).
    - :meth:`decode`: one token for every slot; the ``active`` mask gates
      the cache writes, so an inactive slot stays bit for bit.
    - :meth:`decode_multi`: a horizon of ``k`` tokens with on-device
      sampling and one readback.
    - :meth:`grow`: a larger power-of-two cache bucket by zero padding,
      entries preserved bit for bit.

    ``quantize="int8"`` runs over the int8 params twin; ``kv_cache="int8"``
    keeps int8 caches with per-row f32 scales. ``device`` must be the
    model's (``cuda`` unless the caller asks for ``cpu``)."""

    def __init__(self, model, slots: int = 8, quantize: Optional[str] = None,
                 kv_cache: Optional[str] = None, mesh=None, device=None,
                 pool_label: str = "default"):
        if kv_cache not in (None, "int8"):
            raise ValueError(f"unknown kv_cache mode {kv_cache!r} "
                             "(expected None or 'int8')")
        if mesh is not None:
            raise NotImplementedError(f"a tensor-parallel mesh comes with "
                                      f"{_PARALLEL}")
        device = _env.resolve_device(device)
        if model.device is None:
            raise RuntimeError("the model is not initialized; call "
                               "init(device=...) first")
        if torch.device(model.device).type != device.type:
            raise ValueError(f"the model lives on {model.device}; this "
                             f"engine was asked for {device}")
        self.model = model
        self.device = device
        self.slots = int(slots)
        self.pool_label = str(pool_label)
        self._lock = threading.Lock()
        self._warmed: set = set()
        self._calls = 0
        self._hits = 0
        self._cold = 0
        #: prefills and decode steps run (warm-up included; plain
        #: integers): each attention layer launches K3 once per prefill
        #: and K9 once per decode step on the card
        self.prefill_runs = 0
        self.decode_steps = 0
        self._init_quantize(quantize)
        # the DL4J_TPU_QUANT=off pin turns the int8 cache off with the
        # weights, counted; frozen here: the cache layout must not flap
        self.kv_cache = kv_cache
        self._kv_quant = kv_cache == "int8" and _q.mode() != "off"
        if kv_cache == "int8" and not self._kv_quant:
            self.q_fallbacks += 1
        #: decode-cache bytes of the newest state (the JAX engine's
        #: serving.quantize.kv_bytes gauge)
        self.kv_bytes = 0
        # an un-decodable stack fails here, not at the first request
        model.decode_cache_spec(1, 8, kv_quant=self._kv_quant)

    # ----------------------------------------------------------- state
    def _feature_dim(self) -> int:
        shape = self.model.conf.input_shape
        if shape is None or len(shape) != 2:
            raise ValueError("generative serving needs a recurrent "
                             "([T, F]) input_type on the model config")
        return int(shape[1])

    def _dtype(self) -> torch.dtype:
        return _dt.resolve(self.model.conf.dtype)

    def cache_bytes(self, cache_len: int) -> int:
        """Decode-cache bytes at one bucket for the full slot batch (the
        quantity ``kv_cache="int8"`` halves)."""
        spec = self.model.decode_cache_spec(self.slots,
                                            next_bucket(cache_len),
                                            kv_quant=self._kv_quant)
        return sum(int(np.prod(a.shape)) * a.dtype.itemsize
                   for leaves in spec.values() for a in leaves.values())

    def new_state(self, cache_len: int) -> DecodeState:
        """A fresh zeroed decode state at the cache bucket of
        ``cache_len``."""
        c = next_bucket(cache_len)
        with torch.inference_mode():
            caches = self.model.init_decode_cache(self.slots, c,
                                                  kv_quant=self._kv_quant)
            lengths = torch.zeros((self.slots,), dtype=torch.int32,
                                  device=self.device)
        self.kv_bytes = self.cache_bytes(c)
        return DecodeState(caches, lengths, c)

    def grow(self, state: DecodeState, cache_len: int) -> DecodeState:
        """Re-bucket the caches to the larger power-of-two length of
        ``cache_len`` by zero padding along the cache axis (axis 2), int8
        values and their scales alike (zeros, as the JAX engine pads); the
        existing entries are preserved bit for bit. A bucket that is not
        larger returns ``state``."""
        c2 = next_bucket(cache_len)
        if c2 <= state.cache_len:
            return state
        with torch.inference_mode():
            caches = {}
            for si, leaves in state.caches.items():
                caches[si] = {}
                for name, a in leaves.items():
                    g = a.new_zeros(a.shape[:2] + (c2,) + a.shape[3:])
                    g[:, :, :a.shape[2]] = a
                    caches[si][name] = g
        self.kv_bytes = self.cache_bytes(c2)
        return DecodeState(caches, state.lengths, c2)

    # ---------------------------------------------------------- warm-up
    def _count(self, key) -> None:
        with self._lock:
            self._calls += 1
            if key in self._warmed:
                self._hits += 1
            else:
                self._cold += 1

    def warmup(self, cache_buckets: Sequence[int],
               prompt_buckets: Sequence[int],
               checkpoint: Optional[str] = None,
               horizons: Sequence[int] = (),
               sampling: _smp.SamplingSpec = _smp.GREEDY
               ) -> "GenerativeEngine":
        """Run every (prompt bucket x cache bucket) prefill and every
        cache bucket's decode once on a scratch state, outside traffic;
        with ``horizons``, one horizon per (cache bucket x capacity)
        under ``sampling`` in place of the single-step decode (a horizon
        front never runs it). ``checkpoint=<dir>``: restore the model from
        a ``TrainingCheckpointer`` directory first."""
        if checkpoint is not None:
            _pl.load_checkpoint(self.model, checkpoint, device=self.device)
        cs = sorted(set(next_bucket(c) for c in cache_buckets))
        tps = sorted(set(next_bucket(t) for t in prompt_buckets))
        hs = sorted({int(h) for h in horizons if int(h) >= 1})
        f, S = self._feature_dim(), self.slots
        for c in cs:
            scratch = self.new_state(c)
            for tp in tps:
                if tp <= c:
                    self._prefill_into(scratch, np.zeros((1, tp, f)), 1, 0)
                    self._warmed.add(("prefill", tp, c))
            x0 = np.zeros((S, 1, f), np.float32)
            idle = np.zeros((S,), np.int32)
            if not hs:
                self._decode_into(scratch, x0, idle)
                self._warmed.add(("decode", c))
            for h in hs:
                _, res = self._decode_multi_into(
                    scratch, x0, idle, 1, h, None, None, sampling,
                    torch.Generator(device=self.device).manual_seed(0),
                    None)
                res.fetch()
                self._warmed.add(("decode_multi", c, h)
                                 + sampling.static_key())
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self

    # --------------------------------------------------------- dispatch
    def _tensor(self, a, dtype=None):
        t = a if torch.is_tensor(a) else torch.from_numpy(
            np.ascontiguousarray(a))
        return t.to(device=self.device, dtype=dtype)

    def _prefill_into(self, state, x, plen, slot):
        m = self.model
        x = self._tensor(x, self._dtype() if np.issubdtype(
            np.asarray(x).dtype, np.floating) else None)
        with torch.inference_mode(), _env.precision(self.device):
            mini = {si: {name: a[slot:slot + 1].zero_()
                         for name, a in leaves.items()}
                    for si, leaves in state.caches.items()}
            plen_t = torch.full((1,), int(plen), dtype=torch.int32,
                                device=self.device)
            y, _ = m._prefill(self._serving_params(), x, m.state, mini,
                              plen_t)
            self.prefill_runs += 1
            state.lengths[slot] = int(plen)
            logits = y[0, int(plen) - 1]
            if logits.dtype in (torch.bfloat16, torch.float16):
                logits = logits.float()
            return logits.cpu().numpy()

    def prefill(self, state: DecodeState, x, plen: int, slot: int):
        """Fill ``slot`` from one request's prompt ``x`` (``[T, F]`` or
        ``[1, T, F]``, host array), end-padded here to the smallest warmed
        prompt bucket of this cache bucket (``next_bucket(T)`` when none
        fits); ``plen`` is the true prompt length. Returns ``(state, logits
        [V])``: the logits of the first generated token."""
        x = np.asarray(x)
        if x.ndim == 2:
            x = x[None]
        with self._lock:
            warmed = sorted(k[1] for k in self._warmed
                            if k[0] == "prefill" and k[2] == state.cache_len
                            and k[1] >= x.shape[1])
        tp = warmed[0] if warmed else next_bucket(x.shape[1])
        if tp > state.cache_len:
            raise ValueError(f"prompt bucket {tp} exceeds the cache bucket "
                             f"{state.cache_len}; grow() first")
        if tp != x.shape[1]:
            x = np.concatenate(
                [x, np.zeros((1, tp - x.shape[1]) + x.shape[2:], x.dtype)],
                axis=1)
        self._count(("prefill", tp, state.cache_len))
        return state, self._prefill_into(state, x, plen, slot)

    def _decode_into(self, state, x_t, active):
        m = self.model
        with torch.inference_mode(), _env.precision(self.device):
            x = self._tensor(x_t, self._dtype())
            a = self._tensor(np.asarray(active, np.int32))
            y, _ = m._decode_step(self._serving_params(), x, m.state,
                                  state.caches, state.lengths, write=a)
            self.decode_steps += 1
            state.lengths += a
            logits = y[:, 0]
            if logits.dtype in (torch.bfloat16, torch.float16):
                logits = logits.float()
            return logits.cpu().numpy()

    def decode(self, state: DecodeState, x_t, active):
        """One token for every slot: ``x_t`` ``[S, 1, F]`` (inactive rows
        are ignored), ``active`` ``[S]`` 0/1. Returns ``(state, logits [S,
        V])``; inactive rows' logits are garbage by contract."""
        self._count(("decode", state.cache_len))
        return state, self._decode_into(state, x_t, active)

    def _horizon(self, caches, lengths, x, a, k, kmax, eos, sampling, gen,
                 page_table=None, page_size=0):
        """The horizon loop: ``k`` decode steps from features ``x`` and the
        live mask ``a`` (device tensors), ``lengths`` advanced IN PLACE on
        the device. Returns ``(x, a, toks, logits, emitted)``."""
        m = self.model
        S, dt = self.slots, self._dtype()
        sample = sampling.build()
        temp = float(sampling.temperature)
        toks = torch.zeros((kmax, S), dtype=torch.int32, device=self.device)
        emitted = torch.zeros((kmax, S), dtype=torch.int32,
                              device=self.device)
        logits_buf = None
        params = self._serving_params()
        for i in range(int(k)):
            y, _ = m._decode_step(params, x, m.state, caches, lengths,
                                  write=a, page_table=page_table,
                                  page_size=page_size)
            self.decode_steps += 1
            logits = y[:, 0]
            if logits_buf is None:
                logits_buf = logits.new_zeros((kmax,) + logits.shape)
            tok = sample(logits, gen, temp)
            emitted[i] = a
            lengths += a
            # an EOS freezes its slot for the rest of the horizon; the EOS
            # token itself is emitted
            a = a * (1 - _smp.eos_hit(tok, eos))
            x = m.decode_token_features(tok, dtype=dt)
            toks[i] = tok
            logits_buf[i] = logits
        return x, a, toks, logits_buf, emitted

    def _horizon_inputs(self, x_t, active, eos_ids, active_cap, chain,
                        generator):
        """The device inputs of a horizon: ``(x, live mask with the budget
        gate ANDed in, eos, generator)``, from the chain when there is
        one."""
        S = self.slots
        if chain is not None:
            x, a, gen = chain.x_t, chain.active, chain.generator
        else:
            x = self._tensor(x_t, self._dtype())
            a = self._tensor(np.asarray(active, np.int32))
            gen = generator
        cap = np.ones((S,), np.int32) if active_cap is None \
            else np.asarray(active_cap, np.int32)
        eos = np.full((S,), -1, np.int32) if eos_ids is None \
            else np.asarray(eos_ids, np.int32)
        # the host-known budget gate, ANDed once for the horizon
        return x, a * self._tensor(cap), self._tensor(eos), gen

    def _decode_multi_into(self, state, x_t, active, k, kmax, eos_ids,
                           active_cap, sampling, generator, chain):
        with torch.inference_mode(), _env.precision(self.device):
            x, a, eos, gen = self._horizon_inputs(x_t, active, eos_ids,
                                                  active_cap, chain,
                                                  generator)
            x, a, toks, logits, emitted = self._horizon(
                state.caches, state.lengths, x, a, k, kmax, eos, sampling,
                gen)
            res = HorizonResult(toks, logits, emitted,
                                HorizonChain(x, a, gen), k)
        return state, res

    def decode_multi(self, state: DecodeState, x_t, active, k: int, *,
                     eos_ids=None, active_cap=None,
                     sampling: _smp.SamplingSpec = _smp.GREEDY,
                     generator: Optional[torch.Generator] = None,
                     chain: Optional[HorizonChain] = None):
        """``k`` tokens for every slot, sampled, featurized and
        EOS-frozen on the device; returns ``(state, HorizonResult)``
        without a readback (``result.fetch()`` is the one per horizon).
        ``eos_ids`` ``[S]`` per-slot EOS (-1: none); ``active_cap`` ``[S]``
        0/1 the host-known budget gate ANDed into the live mask; ``chain``
        takes the previous horizon's device-carried features, live mask
        and generator in place of ``x_t``/``active``/``generator``. The
        output buffers have the capacity ``kmax`` of the smallest warmed
        horizon ``>= k`` (``k`` when none is)."""
        k = int(k)
        if k < 1:
            raise ValueError(f"a horizon takes k >= 1 tokens, got {k}")
        with self._lock:
            warmed = sorted(
                kk[2] for kk in self._warmed
                if kk[0] == "decode_multi" and kk[1] == state.cache_len
                and kk[2] >= k and tuple(kk[3:]) == sampling.static_key())
        kmax = warmed[0] if warmed else k
        self._count(("decode_multi", state.cache_len, kmax)
                    + sampling.static_key())
        if generator is None and chain is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        return self._decode_multi_into(state, x_t, active, k, kmax,
                                       eos_ids, active_cap, sampling,
                                       generator, chain)

    def stats(self) -> dict:
        with self._lock:
            return {"calls": self._calls, "hits": self._hits,
                    "cold_calls": self._cold,
                    "warmed_buckets": len(self._warmed),
                    "prefill_runs": self.prefill_runs,
                    "decode_steps": self.decode_steps,
                    "slots": self.slots,
                    "kv_cache": self.kv_cache if self._kv_quant else "off",
                    "kv_bytes": self.kv_bytes,
                    "pool": self.pool_label, **self._quantize_stats()}


# ===========================================================================
# Paged KV pool, prefix sharing and speculative verify
# ===========================================================================

class PagedDecodeState:
    """The live state of one paged decode batch: the per-layer page POOLS
    on the device, and on the host the per-slot lengths and the page
    table, which the one decode worker owns. Every engine call uploads the
    table's bucketed width as a small int32 tensor, so growth is a host
    array write and copies nothing on the device."""

    __slots__ = ("caches", "lengths", "page_table", "mp", "page_size")

    def __init__(self, caches, lengths, page_table, mp: int,
                 page_size: int):
        self.caches = caches            # {layer: {"k": [NP*P, H, d], ...}}
        self.lengths = lengths          # np [S] int64 (host)
        self.page_table = page_table    # np [S, MP] int32 (host)
        self.mp = int(mp)               # the table-width bucket in use
        self.page_size = int(page_size)

    @property
    def cache_len(self) -> int:
        """The logical cache bucket the decode steps see (``mp *
        page_size``), as ``DecodeState.cache_len``."""
        return self.mp * self.page_size


class PagedGenerativeEngine(GenerativeEngine):
    """Paged-pool generative engine (the JAX package's
    ``PagedGenerativeEngine``, :1645): the slot caches become fixed-size
    pages of one device pool per layer, owned by a
    :class:`~.kv_pool.PagedKVPool`, and the attention layers read them
    through the page table.

    - :meth:`new_state` builds ONE pool of ``pages`` physical pages per
      layer (page 0 is the zero page).
    - :meth:`prefill` scatters the prompt's rows through the slot's table
      row (gated past the true prompt length).
    - :meth:`decode` / :meth:`verify` run the layer walk with the page
      table as an argument: one token (K9 in each attention layer) or a
      window of k tokens (K10); :meth:`pdecode_multi` runs a horizon of
      single-token steps as ``decode_multi`` does.
    - :meth:`grow` widens the table-width bucket: host only, no device
      copy.
    - copy-on-write: the caller asks :meth:`prepare_write` before a
      dispatch, and shared pages are copied by ONE :meth:`fork` call.

    Divergences from the JAX engine: eager, so ``warmup`` runs each
    (table-width bucket, window), each prompt bucket's prefill and the
    fork and each ``migrate_buckets`` page count's export and import once
    on a scratch state, and ``cold_calls`` stands in for ``compiles``;
    the pools are updated IN PLACE, by ``import_pages`` too; ``mesh=``
    raises ``NotImplementedError`` naming its slice, and
    ``warmup(checkpoint=)`` restores the model first."""

    def __init__(self, model, slots: int = 8, pages: int = 64,
                 page_size: int = 16, max_cache_len: int = 256,
                 quantize: Optional[str] = None,
                 kv_cache: Optional[str] = None, mesh=None, device=None,
                 pool_label: str = "default"):
        from .kv_pool import PagedKVPool
        super().__init__(model, slots=slots, quantize=quantize,
                         kv_cache=kv_cache, mesh=mesh, device=device,
                         pool_label=pool_label)
        self.page_size = next_bucket(page_size)
        self.max_cache_len = max(next_bucket(max_cache_len), self.page_size)
        self.max_pages_per_slot = self.max_cache_len // self.page_size
        self.pages = int(pages)
        self.pool = PagedKVPool(self.pages, self.page_size)
        #: verify windows and fork calls run (plain integers): each
        #: attention layer launches K10 once per verify on the card
        self.verify_steps = 0
        self.fork_calls = 0
        #: page-count buckets each migration family has run (warmed or
        #: not): the JAX engine chunks over its compiled executables, and
        #: a cold bucket stays compiled there
        self._mig_ran = {"pexport": set(), "pimport": set()}
        #: host seconds of each export_pages and import_pages call (the
        #: JAX engine's kv export/import histograms); on the card an
        #: import's scatter may still run after its call returns
        self.migrate_s = {"export": deque(maxlen=4096),
                          "import": deque(maxlen=4096)}

    # ------------------------------------------------------------ state
    def _pool_spec(self):
        return self.model.paged_cache_spec(self.pages, self.page_size,
                                           kv_quant=self._kv_quant)

    def pool_bytes(self) -> int:
        """Device bytes of the paged KV pool: the FIXED number a per-GB
        stream count divides into."""
        return sum(int(np.prod(a.shape)) * a.dtype.itemsize
                   for leaves in self._pool_spec().values()
                   for a in leaves.values())

    def bytes_per_token(self) -> int:
        return self.pool_bytes() // (self.pages * self.page_size)

    def new_state(self, cache_len: int = 0) -> PagedDecodeState:
        """A fresh zeroed pool and an empty page table; ``cache_len`` picks
        the first table-width bucket (one page by default)."""
        with torch.inference_mode():
            caches = self.model.init_paged_cache(self.pages, self.page_size,
                                                 kv_quant=self._kv_quant)
        self.kv_bytes = self.pool_bytes()
        return PagedDecodeState(
            caches, np.zeros((self.slots,), np.int64),
            np.zeros((self.slots, self.max_pages_per_slot), np.int32),
            self._mp_bucket(cache_len), self.page_size)

    def _mp_bucket(self, cache_len: int) -> int:
        c = next_bucket(max(int(cache_len), 1))
        mp = max(1, c // self.page_size)
        return min(next_bucket(mp), self.max_pages_per_slot)

    def grow(self, state: PagedDecodeState,
             cache_len: int) -> PagedDecodeState:
        """Widen the table-width bucket the decode steps see: host only
        (the full-width table already exists), no device copy."""
        mp2 = self._mp_bucket(cache_len)
        if mp2 <= state.mp:
            return state
        return PagedDecodeState(state.caches, state.lengths,
                                state.page_table, mp2, state.page_size)

    # ------------------------------------------------- page-table plumbing
    def map_pages(self, state: PagedDecodeState, slot: int,
                  pages: Sequence[int]) -> None:
        """Install a slot's (fresh or prefix-shared) pages into its table
        row from logical page 0."""
        for j, p in enumerate(pages):
            state.page_table[slot, j] = int(p)

    def slot_pages(self, state: PagedDecodeState, slot: int) -> list:
        return [int(p) for p in state.page_table[slot] if p]

    def release_slot(self, state: PagedDecodeState, slot: int) -> list:
        """Clear a leaving slot's table row and length; returns its page
        ids for the caller to ``pool.release`` (shared pages live on
        through their other references)."""
        pages = self.slot_pages(state, slot)
        state.page_table[slot, :] = 0
        state.lengths[slot] = 0
        return pages

    def prepare_write(self, state: PagedDecodeState, slot: int,
                      n_tokens: int, ref_snapshot=None) -> list:
        """Make positions ``[lengths[slot], + n_tokens)`` exclusively
        writable: allocate the missing pages and plan a copy-on-write fork
        of each shared one (refcount > 1). Returns the ``(src, dst)`` page
        pairs for ONE :meth:`fork` call; raises on a write past
        ``max_cache_len``. The allocation is all or nothing.

        ``ref_snapshot``: a ``pool.ref_snapshot()`` taken once per round by
        the caller, probed in place of ``pool.shared`` and updated in place
        so repeated calls in one round agree. Only the calling decode
        worker raises a refcount, so a stale snapshot can at worst fork
        needlessly, never lose a fork."""
        l = int(state.lengths[slot])
        P = self.page_size
        j_last = (l + int(n_tokens) - 1) // P
        if j_last >= self.max_pages_per_slot:
            raise ValueError(
                f"slot {slot} write of {n_tokens} at length {l} exceeds "
                f"max_cache_len {self.max_cache_len}")
        snap = ref_snapshot
        plan = []  # (logical page, shared page to fork or 0)
        for j in range(l // P, j_last + 1):
            page = int(state.page_table[slot, j])
            if page == 0:
                plan.append((j, 0))
            elif (int(snap[page]) > 1 if snap is not None
                  else self.pool.shared(page)):
                plan.append((j, page))
        if not plan:
            return []
        fresh_pages = self.pool.alloc(len(plan))
        forks, released = [], []
        for (j, old), fresh in zip(plan, fresh_pages):
            state.page_table[slot, j] = fresh
            if snap is not None:
                snap[fresh] = 1
            if old:
                forks.append((old, fresh))
                released.append(old)
                if snap is not None:
                    snap[old] -= 1
        if released:
            self.pool.release(released)
        if forks:
            self.pool.note_fork(len(forks))
        return forks

    # ---------------------------------------------------------- warm-up
    def warmup(self, cache_buckets: Sequence[int],
               prompt_buckets: Sequence[int],
               speculate: Sequence[int] = (),
               checkpoint: Optional[str] = None,
               migrate_buckets: Sequence[int] = (),
               horizons: Sequence[int] = (),
               sampling: _smp.SamplingSpec = _smp.GREEDY
               ) -> "PagedGenerativeEngine":
        """Run each table-width bucket's single-token decode (or one
        horizon per capacity in ``horizons``), a ``Tq = k`` verify per
        ``speculate`` window, each prompt bucket's prefill, the page fork
        and, per page count in ``migrate_buckets`` (rounded up to a power
        of two), one page export and one page import once on a scratch
        state, outside traffic. Disaggregated replicas pass the page
        counts their prompt buckets imply. ``checkpoint=<dir>``: restore
        the model from a ``TrainingCheckpointer`` directory first."""
        if checkpoint is not None:
            _pl.load_checkpoint(self.model, checkpoint, device=self.device)
        mps = sorted({self._mp_bucket(c) for c in cache_buckets})
        tps = sorted({next_bucket(t) for t in prompt_buckets})
        hs = sorted({int(h) for h in horizons if int(h) >= 1})
        f, S = self._feature_dim(), self.slots
        scratch = self.new_state(max(mps, default=1) * self.page_size)
        idle = np.zeros((S,), np.int32)
        for mp in mps:
            scratch.mp = mp
            if not hs:
                self._window_into(scratch, np.zeros((S, 1, f), np.float32),
                                  idle)
                self._warmed.add(("pdecode", 1, mp))
            for h in hs:
                _, res = self._pdecode_multi_into(
                    scratch, np.zeros((S, 1, f), np.float32), idle, 1, h,
                    None, None, sampling,
                    torch.Generator(device=self.device).manual_seed(0),
                    None)
                res.fetch()
                self._warmed.add(("pdecode_multi", h, mp)
                                 + sampling.static_key())
            for kq in speculate:
                if int(kq) > 1:
                    self._window_into(
                        scratch, np.zeros((S, int(kq), f), np.float32), idle)
                    self._warmed.add(("pdecode", int(kq), mp))
        for tp in tps:
            self._prefill_rows(scratch, np.zeros((1, tp, f), np.float32), 1,
                               0)
            self._warmed.add(("pprefill", tp))
        self._fork_into(scratch, [(0, 0)])
        self._warmed.add(("pfork",))
        for npg in sorted({next_bucket(max(1, int(n)))
                           for n in migrate_buckets}):
            ids = np.zeros((npg,), np.int64)
            self._export_chunk(scratch, ids, 0)
            self._import_chunk(scratch, ids, {
                si: {n: torch.zeros((npg * self.page_size,)
                                    + tuple(a.shape[1:]), dtype=a.dtype)
                     for n, a in leaves.items()}
                for si, leaves in scratch.caches.items()})
            self._warmed.add(("pexport", npg))
            self._warmed.add(("pimport", npg))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self

    # --------------------------------------------------------- dispatch
    def _table(self, state: PagedDecodeState) -> torch.Tensor:
        return self._tensor(np.ascontiguousarray(
            state.page_table[:, :state.mp], dtype=np.int32))

    def _prefill_rows(self, state, x, plen, slot):
        """The prompt through the layer walk on a scratch cache of the
        prompt bucket, then its rows scattered through the slot's table
        row, rows past ``plen`` gated (they may point at the zero page or a
        shared page). Returns the logits of the last prompt position."""
        m = self.model
        tp, P = x.shape[1], self.page_size
        pos = np.arange(tp)
        pages = state.page_table[slot, np.minimum(
            pos // P, self.max_pages_per_slot - 1)].astype(np.int64)
        rows = np.where(pages > 0, pages * P + pos % P, 0)
        with torch.inference_mode(), _env.precision(self.device):
            xt = self._tensor(x, self._dtype())
            mini = m.init_decode_cache(1, tp, kv_quant=self._kv_quant)
            plen_t = torch.full((1,), int(plen), dtype=torch.int32,
                                device=self.device)
            y, mini = m._prefill(self._serving_params(), xt, m.state, mini,
                                 plen_t)
            self.prefill_runs += 1
            rows_t = self._tensor(rows)
            gate = (torch.arange(tp, device=self.device)
                    < int(plen))[:, None, None]
            for si, leaves in state.caches.items():
                for name, pool in leaves.items():
                    upd = mini[si][name][0].transpose(0, 1).to(pool.dtype)
                    pool[rows_t] = torch.where(gate, upd, pool[rows_t])
            logits = y[0, int(plen) - 1]
            if logits.dtype in (torch.bfloat16, torch.float16):
                logits = logits.float()
            return logits.cpu().numpy()

    def prefill(self, state: PagedDecodeState, x, plen: int, slot: int):
        """Fill ``slot``'s pages from one request's prompt (``[T, F]`` or
        ``[1, T, F]``, host array, end-padded to the smallest warmed prompt
        bucket). The slot's table row must already hold ``ceil(plen /
        page_size)`` pages (the batcher allocates them at admission).
        Returns ``(state, logits [V])``."""
        x = np.asarray(x)
        if x.ndim == 2:
            x = x[None]
        with self._lock:
            warmed = sorted(k[1] for k in self._warmed
                            if k[0] == "pprefill" and k[1] >= x.shape[1])
        tp = warmed[0] if warmed else next_bucket(x.shape[1])
        if tp != x.shape[1]:
            x = np.concatenate(
                [x, np.zeros((1, tp - x.shape[1]) + x.shape[2:], x.dtype)],
                axis=1)
        self._count(("pprefill", tp))
        logits = self._prefill_rows(state, x, plen, slot)
        state.lengths[slot] = int(plen)
        return state, logits

    def _window_into(self, state, x, active):
        """One window of ``Tq`` tokens per slot through the layer walk
        over the pool: logits ``[S, Tq, V]`` on the host."""
        m = self.model
        with torch.inference_mode(), _env.precision(self.device):
            xt = self._tensor(x, self._dtype())
            a = self._tensor(np.asarray(active, np.int32))
            ln = self._tensor(state.lengths.astype(np.int32))
            y, _ = m._decode_step(self._serving_params(), xt, m.state,
                                  state.caches, ln,
                                  write=a, page_table=self._table(state),
                                  page_size=self.page_size)
            if xt.shape[1] == 1:
                self.decode_steps += 1
            else:
                self.verify_steps += 1
            if y.dtype in (torch.bfloat16, torch.float16):
                y = y.float()
            return y.cpu().numpy()

    def decode(self, state: PagedDecodeState, x_t, active):
        """One token for every slot over the pool; advances the host
        ``lengths`` of the active rows. Returns ``(state, logits [S,
        V])``."""
        self._count(("pdecode", 1, state.mp))
        y = self._window_into(state, x_t, active)
        state.lengths += np.asarray(active, np.int64)
        return state, y[:, 0]

    def verify(self, state: PagedDecodeState, x_seq, active):
        """Speculative verify: ``x_seq`` ``[S, k, F]`` (the pending token,
        then k - 1 draft tokens) in ONE window step (K10 in each attention
        layer on the card). ``lengths`` are NOT advanced: the caller
        truncates them to the accepted count (the rollback), which also
        retires the rejected rows. Returns ``(state, logits [S, k,
        V])``."""
        x_seq = np.asarray(x_seq)
        self._count(("pdecode", int(x_seq.shape[1]), state.mp))
        return state, self._window_into(state, x_seq, active)

    def _pdecode_multi_into(self, state, x_t, active, k, kmax, eos_ids,
                            active_cap, sampling, generator, chain):
        with torch.inference_mode(), _env.precision(self.device):
            x, a, eos, gen = self._horizon_inputs(x_t, active, eos_ids,
                                                  active_cap, chain,
                                                  generator)
            ln = chain.lengths if chain is not None else self._tensor(
                state.lengths.astype(np.int32))
            x, a, toks, logits, emitted = self._horizon(
                state.caches, ln, x, a, k, kmax, eos, sampling, gen,
                page_table=self._table(state), page_size=self.page_size)
            res = HorizonResult(toks, logits, emitted,
                                HorizonChain(x, a, gen, lengths=ln), k)
        return state, res

    def pdecode_multi(self, state: PagedDecodeState, x_t, active, k: int,
                      *, eos_ids=None, active_cap=None,
                      sampling: _smp.SamplingSpec = _smp.GREEDY,
                      generator: Optional[torch.Generator] = None,
                      chain: Optional[HorizonChain] = None):
        """A paged horizon of ``k`` tokens, the contract of
        :meth:`GenerativeEngine.decode_multi`. The host ``lengths`` are NOT
        advanced: the caller advances them by the fetched emit counts; the
        device lengths ride ``result.chain``. The caller must
        ``prepare_write(..., k)`` and ``fork`` before, so every page the
        horizon can touch is exclusively writable."""
        k = int(k)
        if k < 1:
            raise ValueError(f"a horizon takes k >= 1 tokens, got {k}")
        with self._lock:
            warmed = sorted(
                kk[1] for kk in self._warmed
                if kk[0] == "pdecode_multi" and kk[2] == state.mp
                and kk[1] >= k and tuple(kk[3:]) == sampling.static_key())
        kmax = warmed[0] if warmed else k
        self._count(("pdecode_multi", kmax, state.mp)
                    + sampling.static_key())
        if generator is None and chain is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        return self._pdecode_multi_into(state, x_t, active, k, kmax,
                                        eos_ids, active_cap, sampling,
                                        generator, chain)

    def _fork_into(self, state, pairs):
        P = self.page_size
        with torch.inference_mode():
            src = self._tensor(np.asarray([s for s, _ in pairs], np.int64))
            dst = self._tensor(np.asarray([d for _, d in pairs], np.int64))
            offs = torch.arange(P, device=self.device)[None, :]
            rows_s = (src[:, None] * P + offs).reshape(-1)
            rows_d = (dst[:, None] * P + offs).reshape(-1)
            for leaves in state.caches.values():
                for pool in leaves.values():
                    pool[rows_d] = pool[rows_s]
        self.fork_calls += 1

    def fork(self, state: PagedDecodeState, pairs) -> PagedDecodeState:
        """Copy-on-write page copies: ONE batched copy of every ``(src,
        dst)`` pair in every layer's pool."""
        if not pairs:
            return state
        self._count(("pfork",))
        self._fork_into(state, pairs)
        return state

    # ------------------------------------------------ KV-page migration
    def _migrate_chunks(self, kind: str, n: int):
        """Chunk an ``n``-page migration over the page-count buckets of
        ``kind`` (``"pexport"`` or ``"pimport"``) that were warmed or have
        run: ``(bucket, take)`` pairs, one device call each and never one
        a page; ``next_bucket`` of the rest when there are none (the JAX
        engine's rule over its compiled executables)."""
        with self._lock:
            known = sorted({k[1] for k in self._warmed if k[0] == kind}
                           | self._mig_ran[kind])
        i = 0
        while i < n:
            rem = n - i
            if known:
                fits = [b for b in known if b >= rem]
                bucket = fits[0] if fits else known[-1]
            else:
                bucket = next_bucket(rem)
            take = min(bucket, rem)
            yield bucket, take
            i += take

    def _migrated_pages(self, pages) -> List[int]:
        """``pages`` as ints; raises unless there is at least one and each
        is an allocatable page (not the zero page, inside the pool)."""
        pages = [int(p) for p in pages]
        if not pages or any(p <= 0 or p >= self.pages for p in pages):
            raise ValueError(f"a migration takes one or more page ids in "
                             f"[1, {self.pages}); got {pages}")
        return pages

    def _export_chunk(self, state, ids, take):
        """ONE gather of the pages ``ids`` (``[bucket]``, padded with page
        0) per pool leaf; the first ``take`` pages' rows stay on the
        device."""
        P = self.page_size
        with torch.inference_mode():
            rows = _fa.page_rows(self._tensor(ids), P)
            return {si: {n: _fa.page_export(pool, rows)[:take * P]
                         for n, pool in leaves.items()}
                    for si, leaves in state.caches.items()}

    def _import_chunk(self, state, ids, blocks):
        """ONE host-to-device copy and ONE gated scatter per pool leaf of
        the host ``blocks`` (``[bucket * P, H, d]``) into the pages
        ``ids``; rows of padding entries (page 0) are gated off."""
        P = self.page_size
        with torch.inference_mode():
            ids_t = self._tensor(ids)
            rows = _fa.page_rows(ids_t, P)
            gate = torch.repeat_interleave(ids_t > 0, P)
            for si, leaves in state.caches.items():
                for n, pool in leaves.items():
                    _fa.page_import(pool, rows,
                                    blocks[si][n].to(self.device), gate)

    def export_pages(self, state: PagedDecodeState,
                     pages: Sequence[int]) -> Dict[str, Dict[str,
                                                             torch.Tensor]]:
        """Whole pages as HOST payload blocks (the sending side of a
        migration): ``{layer: {name: [len(pages) * page_size, H, d]}}``,
        CPU tensors in the pool's dtype (bfloat16 included, which numpy
        cannot hold), rows in page order. One gather per chunk and leaf,
        then one device-to-host copy per leaf."""
        pages = self._migrated_pages(pages)
        t0 = time.perf_counter()
        chunks, i = [], 0
        for bucket, take in self._migrate_chunks("pexport", len(pages)):
            ids = np.zeros((bucket,), np.int64)
            ids[:take] = pages[i:i + take]
            self._count(("pexport", bucket))
            chunks.append(self._export_chunk(state, ids, take))
            with self._lock:
                self._mig_ran["pexport"].add(bucket)
            i += take
        with torch.inference_mode():
            out = {si: {n: (torch.cat([c[si][n] for c in chunks])
                            if len(chunks) > 1 else chunks[0][si][n]).cpu()
                        for n in leaves}
                   for si, leaves in chunks[0].items()}
        self.migrate_s["export"].append(time.perf_counter() - t0)
        return out

    def check_payload(self, payload, n_pages: int) -> None:
        """Raise ValueError unless ``payload`` matches this engine's pool
        layout for ``n_pages`` pages: the same layers (the pool spec's
        string keys) and leaf names, ``[n_pages * page_size, H, d]``
        blocks and the pool's dtype."""
        spec = self._pool_spec()
        if not (isinstance(payload, dict) and set(payload) == set(spec)
                and all(isinstance(payload[si], dict)
                        and set(payload[si]) == set(spec[si])
                        for si in spec)):
            raise ValueError(
                "migrated payload layer tree does not match the receiving "
                f"pool's cache layout: {_layout(payload)} vs "
                f"{_layout(spec)}")
        rows = int(n_pages) * self.page_size
        for si, leaves in spec.items():
            for n, a in leaves.items():
                blk = payload[si][n]
                shape = (rows,) + tuple(a.shape[1:])
                if tuple(blk.shape) != shape:
                    raise ValueError(
                        f"migrated payload block {tuple(blk.shape)} != "
                        f"{shape} (page_size/head-count/head-dim mismatch "
                        "between pools)")
                if _dtype_name(blk) != _dtype_name(a):
                    raise ValueError(
                        f"migrated payload dtype {_dtype_name(blk)} != pool "
                        f"dtype {_dtype_name(a)}")

    def import_pages(self, state: PagedDecodeState, pages: Sequence[int],
                     payload) -> PagedDecodeState:
        """Install migrated payload blocks into freshly allocated pages
        (the receiving side), IN PLACE; returns ``state``. The payload's
        structure is checked against this engine's pool layout before any
        device work (:meth:`check_payload`); then each chunk takes one
        host-to-device copy and one gated scatter per leaf."""
        pages = self._migrated_pages(pages)
        self.check_payload(payload, len(pages))
        t0 = time.perf_counter()
        P = self.page_size
        host = {si: {n: _host_tensor(b) for n, b in leaves.items()}
                for si, leaves in payload.items()}
        i = 0
        for bucket, take in self._migrate_chunks("pimport", len(pages)):
            ids = np.zeros((bucket,), np.int64)
            ids[:take] = pages[i:i + take]
            blocks = {}
            for si, leaves in host.items():
                blocks[si] = {}
                for n, b in leaves.items():
                    b = b[i * P:(i + take) * P]
                    if bucket > take:
                        b = torch.cat([b, b.new_zeros(
                            ((bucket - take) * P,) + tuple(b.shape[1:]))])
                    blocks[si][n] = b
            self._count(("pimport", bucket))
            self._import_chunk(state, ids, blocks)
            with self._lock:
                self._mig_ran["pimport"].add(bucket)
            i += take
        self.migrate_s["import"].append(time.perf_counter() - t0)
        return state

    # ---------------------------------------------------------------- admin
    def stats(self) -> dict:
        out = super().stats()
        out["verify_steps"] = self.verify_steps
        out["fork_calls"] = self.fork_calls
        out["paged"] = self.pool.stats()
        out["pool_bytes"] = self.pool_bytes()
        return out
