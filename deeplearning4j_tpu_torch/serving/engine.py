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

Divergences from the JAX engine: there is no ahead-of-time compile, so
``warmup`` runs one eager forward per bucket and the counter the JAX
engine calls ``compiles`` is ``cold_calls`` here (requests that landed on
a bucket not warmed). Meshes, tensor parallelism and int8 quantization
wait for their slices.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import dtypes as _dt
from .. import environment as _env


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


class InferenceEngine:
    """Bucketed ``output()`` for one ComputationGraph or
    MultiLayerNetwork.

    Usage::

        eng = InferenceEngine(net, device="cuda")
        eng.warmup([1, 2, 4, 8, 16, 32])   # every bucket runs once
        y = eng.output(x)                  # any batch size, numpy out
        y = eng.output(seqs, lengths=[...])  # ragged sequences, masked
        eng.stats()                        # calls / hits / padded rows

    ``device`` must be the model's device (``cuda`` unless the caller asks
    for ``cpu``; raises without CUDA)."""

    def __init__(self, model, device=None, min_bucket: int = 1):
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

    def _label(self, key: Tuple) -> str:
        b, t = key
        return str([(b,) + ((t,) + s[1:] if q else s)
                    for s, q in zip(self._input_shapes, self._seq_input)])

    def _run(self, xs: List[torch.Tensor], masks: List[Optional[torch.Tensor]]):
        model = self.model
        with torch.inference_mode(), _env.precision(self.device):
            if not self._is_graph:
                out, _, _ = model._forward(model.params, xs[0], model.state,
                                           train=False, mask=masks[0])
                return [out]
            acts, _, _ = model._forward(
                model.params, dict(zip(self._names, xs)), model.state,
                train=False, masks={n: m for n, m in zip(self._names, masks)
                                    if m is not None})
        return [acts[o] for o in model.conf.outputs]

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
               seq_buckets: Optional[Sequence[int]] = None
               ) -> "InferenceEngine":
        """Run one forward at every (batch bucket x sequence bucket) now
        (zeros in, full masks), so the first request that lands on it meets
        warm library state (cuDNN algorithm choice, the kernel libraries
        built). ``seq_buckets`` applies to sequence inputs; it defaults to
        the configured T when that is static and is required when it is
        dynamic (-1)."""
        if not buckets:
            buckets = default_buckets(max(64, self.min_bucket),
                                      minimum=self.min_bucket)
        dt = _dt.resolve(self.model.conf.dtype)
        if not dt.is_floating_point:
            dt = torch.float32
        for b in sorted(set(next_bucket(b, self.min_bucket)
                            for b in buckets)):
            for t in self._seq_buckets(seq_buckets):
                xs, masks = [], []
                for s, q in zip(self._input_shapes, self._seq_input):
                    shape = (b,) + ((t,) + s[1:] if q else s)
                    xs.append(torch.zeros(shape, dtype=dt,
                                          device=self.device))
                    masks.append(torch.ones((b, t), device=self.device)
                                 if q else None)
                self._run(xs, masks)
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

    def stats(self) -> dict:
        with self._lock:
            return {
                "calls": self._calls,
                "hits": self._hits,
                "cold_calls": self._cold,
                "padded_rows": self._padded,
                "warmed_buckets": sorted({b for b, _ in self._warmed}),
                "warmed_seq_buckets": sorted({t for _, t in self._warmed
                                              if t is not None}),
                "bucket_hits": dict(self._bucket_hits),
            }
