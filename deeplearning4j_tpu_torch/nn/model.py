"""MultiLayerNetwork: the sequential network engine.

Port of ``deeplearning4j_tpu/nn/model.py``: ``init``, ``num_params``, the
eager layer walk ``_forward`` (with the mask, the BN + activation fold
plan, the same plan the JAX package makes, and the model's dropout
generator in training), ``feed_forward``, ``output`` (through the bucketed
:class:`~..serving.engine.InferenceEngine`, with sequence buckets and
masks; ``train=True`` runs the training forward, dropout included),
``predict``, the training half (``fit``, ``score``, ``evaluate``: the
loss of ``_build_loss_fn`` with the l1/l2 term, the step of
``_build_train_step`` with clipping, the divergence sentinel, the updater
and the constraints, shared with ``ComputationGraph`` through
``nn/training.py``; a center-loss head's centers move in the step, and a
FrozenLayer's parameters are skipped), the flat parameter view
``params_flat``/``set_params_flat``, the streaming ``rnn_time_step``
/ ``rnn_clear_previous_state``, ``save``/``load``, and the
autoregressive decode walk of the generative-serving slice (the JAX
module's :880-1053): ``decode_cache_spec``, ``init_decode_cache``,
``decode_token_features`` (on the device, bit-identical to the host
one-hot ``f[token % F] = 1``), ``_prefill``, ``_decode_step`` (with the
``write`` gate, and with ``page_table`` / ``page_size`` over the paged
pool) and ``_full_context``, the prefix-LM oracle; and the paged pool of
the paged and speculative slice, ``paged_cache_spec`` /
``init_paged_cache`` (:923-944). The caches and pools are updated in
place (the JAX engines donate theirs).

Parameters and state are dicts of tensors keyed by layer index (as a
string) and then by parameter name, exactly as the JAX package keys
``net.params`` and ``net.state``, so its ``coefficients.npz`` loads
unchanged; the updater state is keyed by slot, then the same way.

The dropout generator is a ``torch.Generator`` on the model's device
seeded from ``conf.seed``: its masks are not the JAX package's threefry
bits (the tests compare dropout by distribution).

Recurrent training is the JAX package's, not DL4J's: a net-level
``tbptt_length`` is stamped onto the recurrent layers by the builder, and
``fit`` makes one update a batch while the layers' scans detach the carry
every ``tbptt_length`` steps (the JAX ``nn/layers/recurrent.py:45-69``);
``RnnOutputLayer``'s per-step label mask meets the propagated feature
mask in ``losses.combine_masks``. ``_regularization`` reads each layer's
top-level ``W`` only, so a ``Bidirectional`` (its trees under ``fw`` and
``bw``) adds no l1/l2, as in the JAX package.

The training modes of ``fit`` (the JAX module's :114-158, :220-262,
:340-759): 16-bit training (a ``BFLOAT16``/``HALF`` network keeps f32
masters, updater state, BN statistics and center-loss centers, and
trains through the fused master-cast updater when it has no l1/l2 term,
``fused_updater_active``), micro-batch accumulation
(``_build_train_step(accum_steps=k)``, ``nn/microbatch.py``),
``workspace_mode`` rematerialization (``_forward_remat``,
``set_workspace_mode``, ``memory_report``; ``nn/memory.py``),
``fit_on_device`` (the dataset uploaded once, no host sync inside an
epoch) and the solver path (``optimization_algo("LBFGS" |
"CONJUGATE_GRADIENT" | "LINE_GRADIENT_DESCENT")``, ``optimize/
solvers.py``).

``quantize_params`` (int8 serving) returns a new params tree with every
opted-in weight quantized per output channel (``ops/quantize.py``); the
decode caches take ``kv_quant`` (int8 values and per-row f32 scales).

Not in this slice (each raises ``NotImplementedError`` naming the
``ROADMAP.md`` Queue 1 slice that ports it): ``fit(resilience=...)`` and
the training listeners (the runtime slice, item 9).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from .. import dtypes as _dt
from .. import environment as _env
from ..data.dataset import DataSet, DataSetIterator, NumpyDataSetIterator
from ..ops import losses as _loss
from ..parallel.collectives import HeldShards
from ..runtime import sentinel as _sent
from ..utils import tree as _tree
from . import training as _training
from .config import MultiLayerConfiguration

_RUNTIME = "the runtime slice of the port (ROADMAP.md Queue 1 item 9)"


class MultiLayerNetwork(HeldShards):
    """Sequential network engine (DL4J ``MultiLayerNetwork``)."""

    def __init__(self, conf: MultiLayerConfiguration):
        self.conf = conf
        self.layers = conf.layers
        self.params: Dict[str, Dict[str, torch.Tensor]] = {}
        self.state: Dict[str, Dict[str, torch.Tensor]] = {}
        self.updater_state: dict = {}
        self.iteration = 0
        self.epoch = 0
        self.device: Optional[torch.device] = None
        self._inference_engine = None
        self._epilogue_fold = None
        self._rnn_step_fn = None
        self._rnn_stream = None
        self._decode_plan = None
        self._score = None
        self._sentinel = _sent.Sentinel()
        self._rng = None
        self._train_step = None
        self._solver = None
        # the parameter keys of the FrozenLayers
        self._frozen = frozenset(str(i) for i, l in enumerate(self.layers)
                                 if getattr(l, "frozen", False))

    # ------------------------------------------------------------------ init
    def init(self, device=None) -> "MultiLayerNetwork":
        """Draw the parameters from ``conf.seed`` onto ``device`` (``cuda``
        unless the caller asks for ``cpu``; raises without CUDA), and zero
        the updater state. The draws come from one CPU ``torch.Generator``,
        so a seed gives the same weights on every device (not the JAX
        package's threefry values)."""
        if self.conf.input_shape is None:
            raise ValueError("config needs input_type(...) to initialize")
        device = _env.resolve_device(device)
        # mixed precision: 16-bit net dtypes keep f32 master params (cast
        # to the compute dtype inside _forward)
        dtype = _dt.param_dtype(self.conf.dtype)
        shape = tuple(self.conf.input_shape)
        gen = torch.Generator().manual_seed(int(self.conf.seed))
        params, state = {}, {}
        for i, layer in enumerate(self.layers):
            p, s, shape = layer.initialize(gen, shape, dtype, device)
            if p:
                params[str(i)] = p
            if s:
                state[str(i)] = s
        self.params = params
        self.state = state
        self.updater_state = self.conf.updater.init_state(params) \
            if self.conf.updater else {}
        self.device = device
        self._inference_engine = None
        self._rng = None
        self._train_step = None
        self._solver = None
        self.rnn_clear_previous_state()
        return self

    def num_params(self) -> int:
        return sum(int(t.numel()) for t in _tree.leaves(self.params))

    # ------------------------------------------------- flat parameter view
    def _flat_keys(self):
        return [str(i) for i in range(len(self.layers))]

    def params_flat(self) -> np.ndarray:
        """Every parameter as one numpy vector in DL4J's layer and name
        order: the JAX package's vector (the port keeps its layouts), so
        it loads there unchanged, and the other way round."""
        return _tree.flatten_params(self.params, self._flat_keys())

    def set_params_flat(self, vec) -> "MultiLayerNetwork":
        """Load a :meth:`params_flat` vector (from either package)."""
        self.params = _tree.unflatten_params(self.params, self._flat_keys(),
                                             vec)
        return self

    # --------------------------------------------------------------- forward
    def _forward(self, params, x, state, *, train=False, mask=None,
                 collect=False, rng=None, remat_policy=None):
        """The eager layer walk. Returns ``(out, new_state, mask)``, or
        ``(acts, new_state, mask)`` with ``collect=True`` (``acts`` is
        ``[input, layer0_out, ...]``, feedForward semantics, with no
        epilogue fold). ``rng``, a ``torch.Generator`` on x's device, feeds
        the stochastic layers (dropout) in training. Under a 16-bit policy
        the f32 masters are cast to the compute dtype here (leaves already
        in it, the fused step's copies, pass as they are).
        ``remat_policy`` (``nn/memory.py``, the train step's loss only)
        runs the walk in checkpointed segments."""
        dt = _dt.resolve(self.conf.dtype)
        if dt.is_floating_point and x.is_floating_point() and x.dtype != dt:
            x = x.to(dt)  # cast inputs to the network dtype (DL4J)
        if _dt.is_mixed(self.conf.dtype):
            params = _dt.cast_floating(params, dt)
        if remat_policy is not None and remat_policy.remat and not collect:
            return self._forward_remat(params, x, state, train=train,
                                       mask=mask, rng=rng,
                                       policy=remat_policy)
        acts = [x] if collect else None
        fold, skip = ({}, frozenset()) if collect \
            else self._epilogue_fold_plan()
        x, ns, mask = self._walk(range(len(self.layers)), params, x, state,
                                 train, mask, rng, fold, skip, acts)
        return (acts if collect else x), {**state, **ns}, mask

    def _walk(self, indices, params, x, state, train, mask, rng, fold, skip,
              acts=None):
        """The layers ``indices`` in turn: ``(x, their new state, mask)``;
        each output is appended to ``acts`` when given."""
        ns = {}
        for i in indices:
            if i in skip:
                continue  # activation folded into the previous BN
            layer, si = self.layers[i], str(i)
            kw = {"fold_act": fold[i]} if i in fold else {}
            if getattr(layer, "needs_rng", False):
                kw["rng"] = rng
            x, s_new, mask = layer.apply(params.get(si, {}), x,
                                         state.get(si, {}), train=train,
                                         mask=mask, **kw)
            if acts is not None:
                acts.append(x)
            if s_new:
                ns[si] = s_new
        return x, ns, mask

    def _forward_remat(self, params, x, state, *, train, mask, rng, policy):
        """The same walk in segments of ``policy.every`` layers, each under
        ``memory.checkpoint``: the backward keeps the segment boundaries
        (and what the policy saves) and recomputes the rest, the dropout
        generator replayed, so the numbers are the plain walk's."""
        from . import memory as _memory
        fold, skip = self._epilogue_fold_plan()
        new_state = dict(state)
        for s, e in _memory.segment_ranges(len(self.layers), policy.every):
            keys = [str(i) for i in range(s, e)]

            def seg_fn(seg_params, seg_state, x, mask, _idx=range(s, e)):
                return self._walk(_idx, seg_params, x, seg_state, train,
                                  mask, rng, fold, skip)
            x, ns, mask = _memory.checkpoint(seg_fn, policy, rng)(
                {k: params[k] for k in keys if k in params},
                {k: state[k] for k in keys if k in state}, x, mask)
            new_state.update(ns)
        return x, new_state, mask

    def _epilogue_fold_plan(self):
        """Static BN + activation fold plan: every BatchNormalization
        immediately followed by a parameter-free ActivationLayer with a
        K1-foldable activation gets the activation folded into its
        ``bn_act`` epilogue (``fold -> {bn_index: act}``), and the
        ActivationLayer becomes a pass-through (``skip``). The JAX
        package's plan, layer for layer."""
        if self._epilogue_fold is not None:
            return self._epilogue_fold
        from ..ops import fused_epilogues as _fe
        from .layers.conv import BatchNormalization
        from .layers.core import ActivationLayer
        fold, skip = {}, set()
        for i, layer in enumerate(self.layers[:-1]):
            nxt = self.layers[i + 1]
            if (isinstance(layer, BatchNormalization)
                    and type(nxt) is ActivationLayer
                    and _fe.foldable_act(nxt.activation, nxt.alpha)):
                fold[i] = nxt.activation
                skip.add(i + 1)
        self._epilogue_fold = (fold, frozenset(skip))
        return self._epilogue_fold

    def _tensor(self, a) -> torch.Tensor:
        """An input array as a tensor on the model's device; float64 comes
        in as float32 unless the network is ``DOUBLE``."""
        t = a if torch.is_tensor(a) else torch.as_tensor(np.asarray(a))
        if t.dtype == torch.float64 and \
                _dt.resolve(self.conf.dtype) != torch.float64:
            t = t.float()
        return t.to(self.device)

    def _ensure_init(self):
        """An uninitialized net is initialized on ``cuda`` first (raises
        without CUDA; a CPU run calls ``init(device="cpu")``)."""
        if self.device is None:
            self.init()

    # ------------------------------------------------------------- inference
    def feed_forward(self, x, train: bool = False, rng=None):
        """Per-layer activations for input ``x`` (DL4J ``feedForward()``):
        the input first, then every layer's output, as tensors. ``rng`` (a
        ``torch.Generator`` on the model's device) feeds dropout when
        ``train=True``; None keeps it the identity."""
        self._ensure_init()
        with torch.inference_mode(), _env.precision(self.device):
            acts, _, _ = self._forward(self.params, self._tensor(x),
                                       self.state, train=train,
                                       collect=True, rng=rng)
        return acts

    def inference_engine(self, **kwargs):
        """The model's serving engine, created lazily on the model's
        device; ``output()`` routes through it."""
        if self._inference_engine is None:
            from ..serving.engine import InferenceEngine
            self._ensure_init()
            self._inference_engine = InferenceEngine(
                self, device=self.device, **kwargs)
        elif kwargs:
            raise ValueError("inference engine already built; call "
                             "inference_engine() without kwargs, or build "
                             "an InferenceEngine directly")
        return self._inference_engine

    def output(self, x, train: bool = False):
        """Output activations as numpy (DL4J ``output()``), through the
        bucketed engine: ragged batch sizes pad to power-of-two buckets,
        and a sequence input's time axis to its power-of-two bucket with
        the padded steps masked. ``train=True`` runs the training forward
        (batch statistics, dropout from the model's generator) and leaves
        the layer state as it was."""
        if not train:
            return self.inference_engine().output(x)
        self._ensure_init()
        with torch.inference_mode(), _env.precision(self.device):
            out, _, _ = self._forward(self.params, self._tensor(x),
                                      self.state, train=True,
                                      rng=_training.generator(self))
            if out.dtype in (torch.bfloat16, torch.float16):
                out = out.float()
            return out.cpu().numpy()

    def predict(self, x) -> np.ndarray:
        """Class indices (DL4J ``predict()``)."""
        return np.argmax(self.output(x), axis=-1)

    # ----------------------------------------------------- rnnTimeStep state
    def rnn_time_step(self, x):
        """Stateful streaming inference (DL4J ``rnnTimeStep()``): feed
        ``[B, T, F]`` (or ``[B, F]`` for a single step) chunks; the
        recurrent layers' state persists across calls until
        :meth:`rnn_clear_previous_state`. Returns numpy (``[B, out]`` for a
        single step)."""
        self._ensure_init()
        x = self._tensor(x)
        single = x.dim() == 2
        if single:
            x = x[:, None, :]  # [B, 1, F]
        if self._rnn_stream is None:
            self._rnn_stream = {}
        if self._rnn_step_fn is None:
            self._rnn_step_fn = self._build_rnn_step()
        with torch.inference_mode(), _env.precision(self.device):
            out, self._rnn_stream = self._rnn_step_fn(
                self.params, self.state, x, self._rnn_stream)
            if out.dtype in (torch.bfloat16, torch.float16):
                out = out.float()
            out = out.cpu().numpy()
        return out[:, -1, :] if (single and out.ndim == 3) else out

    def rnn_clear_previous_state(self):
        self._rnn_stream = None

    def _build_rnn_step(self):
        """The streaming walk ``(params, state, x, stream) -> (out,
        new_stream)``: recurrent layers continue from their carry in
        ``stream`` (keyed by layer index) with ``grad_path=False``, the
        others apply in inference mode. Raises for a layer that cannot
        stream."""
        recurrent = {str(i): l for i, l in enumerate(self.layers)
                     if getattr(l, "is_recurrent", lambda: False)()}
        for si, l in recurrent.items():
            if not getattr(l, "supports_streaming", True):
                raise ValueError(
                    f"rnnTimeStep() is not supported with layer {si} "
                    f"({l.kind}): bidirectional layers need the full future "
                    "sequence (DL4J throws here too); use output() instead")

        def step(params, state, x, stream):
            dt = _dt.resolve(self.conf.dtype)
            if _dt.is_mixed(self.conf.dtype):
                params = _dt.cast_floating(params, dt)
            if dt.is_floating_point and x.is_floating_point() \
                    and x.dtype != dt:
                x = x.to(dt)  # match _forward's input cast
            new_stream = dict(stream)
            for i, layer in enumerate(self.layers):
                si = str(i)
                p = params.get(si, {})
                if si in recurrent:
                    carry = stream.get(si)
                    if carry is None:
                        carry = layer.init_stream_state(p, x.shape[0])
                    x, carry = layer.scan_with_state(p, x, carry,
                                                     grad_path=False)
                    new_stream[si] = carry
                else:
                    x, _, _ = layer.apply(p, x, state.get(si, {}),
                                          train=False)
            return x, new_stream

        return step

    # --------------------------------------------------------------- training
    @property
    def _out_layer(self):
        """The loss head (the last layer, a FrozenLayer unwrapped to probe
        it), or None."""
        from .layers.wrappers import is_loss_head
        last = self.layers[-1] if self.layers else None
        return last if last is not None and is_loss_head(last) else None

    def _regularization(self, params):
        """Per-layer l1/l2 on ``W`` (DL4J regularizes W, not b)."""
        return _training.regularization(
            self.conf, ((layer, params.get(str(i), {}))
                        for i, layer in enumerate(self.layers)))

    def _clip(self, grads):
        """Gradient normalization and clipping: ``(grads, clip_events)``."""
        return _training.clip(self.conf, grads)

    def _build_loss_fn(self):
        """The training loss ``(params, state, x, y, fmask, lmask, rng) ->
        (loss, new_state)``: the training forward (under the
        configuration's ``workspace_mode``), the output layer's loss on
        the combined label and propagated masks (a center-loss head's
        with its center term, its centers moved in ``new_state``), plus
        l1/l2."""
        from . import memory as _memory
        out_layer = self._out_layer
        key = str(len(self.layers) - 1)
        policy = _memory.resolve_policy(self.conf.workspace_mode)

        def loss_fn(params, state, x, y, fmask, lmask, rng):
            out, new_state, out_mask = self._forward(
                params, x, state, train=True, mask=fmask, rng=rng,
                remat_policy=policy)
            lm = _loss.combine_masks(lmask, out_mask)
            data_loss, new_state = _training.head_loss(
                out_layer, out, y, lm, state, new_state, key)
            return data_loss + self._regularization(params), new_state

        return loss_fn

    def _uses_regularization(self) -> bool:
        """Any l1/l2 term configured? Gates the fused master-cast updater
        and the accumulation's cast hoist: the term reads the params the
        loss is handed, which must then be the f32 masters."""
        return _training.uses_regularization(self.conf, self.layers)

    def fused_updater_active(self) -> bool:
        """Does the train step fold the per-step f32 -> compute master
        cast into the updater's write? True under a 16-bit policy with no
        l1/l2 term; the step then carries the compute copy between steps
        and the cast at the top of the forward is an identity."""
        return _training.fused_cast_active(self)

    def _check_trainable(self):
        """Raise for what ``fit`` cannot do."""
        if self._out_layer is None:
            raise ValueError("last layer must be an OutputLayer/LossLayer "
                             "to fit()")
        if self.conf.updater is None and not self._solver_algo():
            raise ValueError("fit() needs an updater in the configuration")

    def _solver_algo(self):
        """The configured solver's name, or None for the SGD path."""
        algo = (self.conf.optimization_algo or "SGD").upper()
        return None if algo in ("SGD", "STOCHASTIC_GRADIENT_DESCENT") \
            else algo

    def _build_train_step(self, accum_steps: int = 1,
                          fused_cast: bool = False):
        """The eager step ``(x, y, fmask, lmask, on_device=False) ->
        loss`` (a device tensor): ``nn/training.py``'s step on
        :meth:`_build_loss_fn` with the model's generator.
        ``accum_steps=k`` accumulates the gradient over k microbatches
        before the one update (``nn/microbatch.py``; the weight is the
        label count), the masters cast once a step under a 16-bit policy
        with no l1/l2 term. ``fused_cast=True`` (the caller gates on
        :meth:`fused_updater_active`) is the fused master-cast step; its
        parameters and updater state equal the unfused step's bit for
        bit."""
        from . import microbatch as _micro
        loss_fn = self._build_loss_fn()

        def vg(p, state, rng, x, y, fmask, lmask):
            return _training.value_and_grad(
                p, lambda q: loss_fn(q, state, x, y, fmask, lmask, rng))
        return _training.step_fn(
            self, vg, accum_steps, fused_cast,
            lambda x, y, fm, lm: _micro.label_count_weight(lm))

    def _fit_step(self):
        """The step ``fit`` and ``fit_on_device`` run, built once per model
        (its routing decision counted once) and carrying no compute copy
        into a new call."""
        if self._train_step is None:
            from ..ops import fused_epilogues as _fe
            fused = self.fused_updater_active()
            _fe.dispatch_updater(self.conf.dtype,
                                 has_penalty=self._uses_regularization())
            self._train_step = self._build_train_step(fused_cast=fused)
        self._train_step.params_c = None
        return self._train_step

    def _value_and_grad(self, x, y, fmask=None, lmask=None, rng=None):
        """``(loss, grads, new_state)`` at the current params: one training
        forward (dropout from ``rng``, None: the identity) and
        ``torch.autograd.grad``."""
        loss_fn = self._build_loss_fn()
        with _env.precision(self.device):
            return _training.value_and_grad(
                self.params, lambda p: loss_fn(p, self.state, x, y, fmask,
                                               lmask, rng))

    def fit(self, data, labels=None, epochs: int = 1,
            resilience=None) -> "MultiLayerNetwork":
        """DL4J ``fit()`` on a DataSetIterator, a DataSet, or (features,
        labels) arrays, for ``epochs`` passes. An uninitialized net is
        initialized on ``cuda`` first. A solver ``optimization_algo``
        runs :class:`~..optimize.solvers.Solver` a batch."""
        if resilience is not None:
            raise NotImplementedError(
                f"fit(resilience=...) comes with {_RUNTIME}")
        if not self.params and not self.state:
            self.init()
        self._check_trainable()
        if self._solver_algo():
            return self._fit_with_solver(data, labels, epochs)
        step = self._fit_step()
        for _ in range(epochs):
            for ds in _as_iterator(data, labels):
                self._score = step(
                    self._tensor(ds.features), self._tensor(ds.labels),
                    None if ds.features_mask is None
                    else self._tensor(ds.features_mask),
                    None if ds.labels_mask is None
                    else self._tensor(ds.labels_mask))
                self.iteration += 1
            self.epoch += 1
        return self

    def fit_on_device(self, features, labels, epochs: int = 1,
                      batch_size: Optional[int] = None,
                      drop_remainder: bool = False) -> np.ndarray:
        """Training on a dataset uploaded once (the JAX engine's compiled
        epoch loop): the arrays are reshaped to ``[n_batches, B, ...]`` on
        the model's device, and each epoch is one loop of ``fit``'s step
        with no host sync inside it (the sentinel's verdict stays on the
        device). Returns the loss history ``[epochs * n_batches]``, the
        same values per-batch ``fit`` gives. A dataset size not divisible
        by the batch raises unless ``drop_remainder=True``; masked data
        must use ``fit()``."""
        if not self.params and not self.state:
            self.init()
        self._check_trainable()
        (x,), (y,) = _training.stack_dataset(self, [features], [labels],
                                             batch_size, drop_remainder)
        return _training.device_epochs(
            self, self._fit_step(), epochs, x.shape[0],
            lambda i: (x[i], y[i], None, None))

    def _fit_with_solver(self, data, labels, epochs: int
                         ) -> "MultiLayerNetwork":
        """DL4J's ``Solver.optimize`` path: LBFGS, conjugate gradient or
        line-search gradient descent on each batch instead of the SGD
        step (``optimize/solvers.py``)."""
        from ..optimize.solvers import Solver
        if self._solver is None:
            self._solver = Solver(
                self, self.conf.optimization_algo,
                iterations=self.conf.solver_iterations,
                max_line_search_iterations=(
                    self.conf.max_line_search_iterations))
        for _ in range(epochs):
            for ds in _as_iterator(data, labels):
                self._score = self._solver.optimize(
                    self._tensor(ds.features), self._tensor(ds.labels),
                    None if ds.features_mask is None
                    else self._tensor(ds.features_mask),
                    None if ds.labels_mask is None
                    else self._tensor(ds.labels_mask))
                self.iteration += 1
            self.epoch += 1
        return self

    # --------------------------------------------- workspace mode, memory
    def set_workspace_mode(self, mode: str) -> "MultiLayerNetwork":
        """Switch the rematerialization policy (``nn/memory.py``) in place;
        the next step is built under it."""
        from . import memory as _memory
        policy = _memory.resolve_policy(mode)  # validate before mutating
        self.conf = dataclasses.replace(self.conf,
                                        workspace_mode=policy.name)
        self._train_step = None
        return self

    def memory_report(self, batch_size: int, accum_steps: int = 1,
                      seq_len=None) -> dict:
        """The train step's memory at ``batch_size``, measured
        (``nn/memory.py``: residual bytes everywhere, the peak on the
        card; the compiled fields of the JAX report are None)."""
        from . import memory as _memory
        return _memory.memory_report(self, batch_size,
                                     accum_steps=accum_steps,
                                     seq_len=seq_len)

    def _memory_probe(self, batch: int, seq_len) -> dict:
        """Residual bytes of one training forward and backward at
        ``batch`` on zero inputs (labels shaped by an inference forward);
        nothing is applied."""
        from . import memory as _memory
        x = _memory.probe_batch(self.conf.input_shape, batch, seq_len,
                                _dt.resolve(self.conf.dtype), self.device)
        with torch.no_grad(), _env.precision(self.device):
            out, _, _ = self._forward(self.params, x, self.state)
        y = torch.zeros(out.shape, dtype=torch.float32, device=self.device)
        loss_fn = self._build_loss_fn()
        with _memory.count_residuals((self.params, x, y)) as res, \
                _env.precision(self.device):
            _training.value_and_grad(
                self.params,
                lambda p: loss_fn(p, self.state, x, y, None, None, None))
        return res.report()

    def score(self, ds: Optional[DataSet] = None) -> float:
        """The loss of the last ``fit`` batch, or of ``ds`` (the training
        forward with batch statistics and no dropout, as DL4J scores);
        both include the l1/l2 term."""
        if ds is None:
            if torch.is_tensor(self._score):
                self._score = float(self._score)  # the only sync, on demand
            return self._score
        self._ensure_init()
        loss_fn = self._build_loss_fn()
        with torch.no_grad(), _env.precision(self.device):
            loss, _ = loss_fn(
                self.params, self.state, self._tensor(ds.features),
                self._tensor(ds.labels),
                None if ds.features_mask is None
                else self._tensor(ds.features_mask),
                None if ds.labels_mask is None
                else self._tensor(ds.labels_mask), None)
        return float(loss)

    def evaluate(self, data, labels=None):
        """Classification evaluation over an iterator (DL4J
        ``evaluate()``), through :meth:`output`."""
        from ..eval.evaluation import Evaluation
        ev = Evaluation()
        for ds in _as_iterator(data, labels):
            ev.eval(ds.labels, self.output(ds.features),
                    mask=ds.labels_mask)
        return ev

    def resilience_counters(self) -> dict:
        """The divergence sentinel's counters (skipped steps in total and
        in a row, clip events)."""
        return self._sentinel.to_host()

    def set_listeners(self, *listeners):
        raise NotImplementedError(f"training listeners come with {_RUNTIME}")

    def add_listener(self, listener):
        raise NotImplementedError(f"training listeners come with {_RUNTIME}")

    # ------------------------------------------------------ int8 serving
    def quantize_params(self, mode: str = "int8") -> dict:
        """Post-training per-channel int8 quantization of the opted-in
        weights (``quantize_spec``): a NEW params tree with those leaves
        as ``ops.quantize.QuantizedTensor``; the model's own params are
        untouched, so training and f32 serving go on as before."""
        if mode != "int8":
            raise ValueError(f"unknown quantization mode {mode!r} "
                             "(expected 'int8')")
        from ..ops import quantize as _q
        self._ensure_init()
        return _q.quantize_model_params(self)[0]

    # ------------------------------------------- autoregressive decode walk
    # Prefill and one-token decode walks over the layer stack, threading
    # per-layer (k, v) caches and per-row lengths. Prefix-LM semantics: the
    # prompt attends bidirectionally over itself (prefill = one pass of
    # the attention dispatch, K3 on the card), every generated token
    # attends over everything before it and itself (K9 on the card).
    # ``serving.engine.GenerativeEngine`` drives them; the tests hold N
    # decode steps against :meth:`_full_context`.
    def _decode_layer_plan(self, params):
        """``(layer, "cache" | "pointwise")`` per layer, worked out once
        per model (the layer list never changes); raises for a layer that
        can be neither: the decode walk is exact, not best-effort."""
        if self._decode_plan is not None:
            return self._decode_plan
        plan = []
        for i, layer in enumerate(self.layers):
            p = params.get(str(i), {})
            if layer.decode_cache_spec(p, 1, 8, torch.float32) is not None:
                plan.append((layer, "cache"))
            elif getattr(layer, "decode_pointwise", False):
                plan.append((layer, "pointwise"))
            else:
                raise ValueError(
                    f"layer {i} ({layer.kind!r}) cannot run in the "
                    "autoregressive decode walk (neither KV-cached nor "
                    "time-pointwise)")
        self._decode_plan = plan
        return plan

    def decode_cache_spec(self, batch: int, cache_len: int,
                          kv_quant: bool = False) -> dict:
        """``{layer_index: {"k": CacheSpec, "v": CacheSpec}}`` for the
        KV-cached layers, in the compute dtype; with ``kv_quant`` int8
        ``k``/``v`` and f32 ``k_scale``/``v_scale`` ``[B, H, C, 1]``."""
        self._ensure_init()
        dt = _dt.resolve(self.conf.dtype)
        spec = {}
        for i, layer in enumerate(self.layers):
            s = layer.decode_cache_spec(self.params.get(str(i), {}),
                                        batch, cache_len, dt,
                                        kv_quant=kv_quant)
            if s is not None:
                spec[str(i)] = s
        if not spec:
            raise ValueError("model has no KV-cached layers; nothing to "
                             "decode incrementally")
        return spec

    def init_decode_cache(self, batch: int, cache_len: int,
                          kv_quant: bool = False) -> dict:
        """Zeroed decode caches for one slot batch, on the model's
        device."""
        return {si: {name: torch.zeros(a.shape, dtype=a.dtype,
                                       device=self.device)
                     for name, a in leaves.items()}
                for si, leaves in self.decode_cache_spec(
                    batch, cache_len, kv_quant=kv_quant).items()}

    def paged_cache_spec(self, n_pages: int, page_size: int,
                         kv_quant: bool = False) -> dict:
        """The paged twin of :meth:`decode_cache_spec`: ``{layer_index:
        {"k": CacheSpec([n_pages * page_size, H, d]), "v": ...}}``, each
        KV-cached layer's cache as a pool of token rows that the serving
        page allocator owns."""
        base = self.decode_cache_spec(1, 1, kv_quant=kv_quant)
        rows = int(n_pages) * int(page_size)
        return {si: {name: type(a)((rows, a.shape[1], a.shape[3]), a.dtype)
                     for name, a in leaves.items()}
                for si, leaves in base.items()}

    def init_paged_cache(self, n_pages: int, page_size: int,
                         kv_quant: bool = False) -> dict:
        """A zeroed paged pool on the model's device (page 0 is the zero
        page the allocator points unallocated table entries at)."""
        return {si: {name: torch.zeros(a.shape, dtype=a.dtype,
                                       device=self.device)
                     for name, a in leaves.items()}
                for si, leaves in self.paged_cache_spec(
                    n_pages, page_size, kv_quant=kv_quant).items()}

    def decode_token_features(self, tokens, dtype=None):
        """Token ids ``[B]`` -> the next decode input ``[B, 1, F]``, on the
        tokens' device: the one-hot ``f[token % F] = 1``, bit-identical
        to the serving front's host featurizer."""
        shape = self.conf.input_shape
        if not (isinstance(shape, (tuple, list)) and len(shape) == 2):
            raise ValueError(
                "decode_token_features needs a recurrent [T, F] input "
                f"type; model input_shape is {shape!r}")
        f = int(shape[1])
        dt = _dt.resolve(self.conf.dtype) if dtype is None else dtype
        toks = torch.as_tensor(tokens).to(torch.int64) % f
        out = torch.zeros((toks.shape[0], f), dtype=dt, device=toks.device)
        return out.scatter_(1, toks[:, None], 1.0)[:, None, :]

    def _decode_cast(self, params, x):
        dt = _dt.resolve(self.conf.dtype)
        x = torch.as_tensor(x)
        if dt.is_floating_point and x.is_floating_point() and x.dtype != dt:
            x = x.to(dt)
        if _dt.is_mixed(self.conf.dtype):
            params = _dt.cast_floating(params, dt)
        return params, x

    def _prefill(self, params, x, state, caches, lengths):
        """Prompt phase: ``x`` ``[B, T, F]`` end-padded, ``lengths`` ``[B]``
        the true prompt lengths. Fills the caches' positions ``[0, T)`` in
        place (rows past a length are masked by the decode side) and
        returns ``(y [B, T, out], caches)``."""
        params, x = self._decode_cast(params, x)
        T = x.shape[1]
        lengths = torch.as_tensor(lengths).to(x.device)
        mask = (torch.arange(T, device=x.device)[None, :]
                < lengths[:, None]).to(torch.float32)
        new_caches = {}
        for i, (layer, kind) in enumerate(self._decode_layer_plan(params)):
            si = str(i)
            p, s = params.get(si, {}), state.get(si, {})
            if kind == "cache":
                x, new_caches[si] = layer.prefill(
                    p, x, s, cache=caches[si], lengths=lengths, mask=mask)
            else:
                x, _, _ = layer.apply(p, x, s, train=False, mask=mask)
        return x, new_caches

    def _decode_step(self, params, x, state, caches, lengths, write=None,
                     page_table=None, page_size=0):
        """One decode window ``x`` ``[B, Tq, F]``; ``lengths`` ``[B]`` the
        tokens cached BEFORE it. Appends the window's k/v at ``lengths``
        onward in place (rows with ``write == 0`` keep their caches bit for
        bit) and returns ``(y [B, Tq, out], caches)``; the caller advances
        ``lengths``. With ``page_table`` ``[B, MP]`` and ``page_size`` the
        caches are the paged pools (:meth:`init_paged_cache`)."""
        params, x = self._decode_cast(params, x)
        if page_table is not None:
            page_table = torch.as_tensor(page_table).to(x.device)
        lengths = torch.as_tensor(lengths).to(x.device)
        new_caches = {}
        for i, (layer, kind) in enumerate(self._decode_layer_plan(params)):
            si = str(i)
            p, s = params.get(si, {}), state.get(si, {})
            if kind == "cache":
                x, new_caches[si] = layer.decode_step(
                    p, x, s, cache=caches[si], lengths=lengths, write=write,
                    page_table=page_table, page_size=page_size)
            else:
                x, _ = layer.decode_step(p, x, s, cache=None,
                                         lengths=lengths)
        return x, new_caches

    def _full_context(self, params, x, state, prompt_lengths, lengths):
        """The full-recompute oracle: one quadratic forward over the whole
        running sequence under the prefix-LM mask: position j is visible
        to position i iff ``j < prompt_len`` or ``j <= i``, and ``j`` is
        within the row's ``lengths``."""
        params, x = self._decode_cast(params, x)
        T, dev = x.shape[1], x.device
        prompt_lengths = torch.as_tensor(prompt_lengths).to(dev)
        lengths = torch.as_tensor(lengths).to(dev)
        ii = torch.arange(T, device=dev)[:, None]
        jj = torch.arange(T, device=dev)[None, :]
        allowed = ((jj < prompt_lengths[:, None, None]) | (jj <= ii)) \
            & (jj < lengths[:, None, None])
        zero = torch.tensor(0.0, device=dev)
        neg = torch.tensor(torch.finfo(torch.float32).min, device=dev)
        bias = torch.where(allowed[:, None], zero, neg)        # [B,1,T,T]
        key_bias = torch.where(torch.arange(T, device=dev)[None, None, None,
                                                          :]
                               < lengths[:, None, None, None], zero, neg)
        for i, (layer, kind) in enumerate(self._decode_layer_plan(params)):
            si = str(i)
            p, s = params.get(si, {}), state.get(si, {})
            if kind == "cache":
                x = layer.full_context(p, x, s, bias=bias,
                                       key_bias=key_bias)
            else:
                x, _, _ = layer.apply(p, x, s, train=False, mask=None)
        return x

    # ------------------------------------------------------------------ serde
    def save(self, path, save_updater: bool = True):
        from ..utils.serializer import save_model
        save_model(self, path, save_updater=save_updater)

    @staticmethod
    def load(path, device=None, load_updater: bool = True
             ) -> "MultiLayerNetwork":
        from ..utils.serializer import load_model
        model = load_model(path, device=device, load_updater=load_updater)
        if not isinstance(model, MultiLayerNetwork):
            raise TypeError(f"{path} holds a {type(model).__name__}, "
                            "not a MultiLayerNetwork")
        return model


def _as_iterator(data, labels=None) -> DataSetIterator:
    if isinstance(data, DataSetIterator):
        return data
    if isinstance(data, DataSet):
        return _SingleIterator(data)
    if labels is not None:
        return NumpyDataSetIterator(data, labels,
                                    batch_size=len(np.asarray(data)))
    raise TypeError(f"cannot make a DataSetIterator from {type(data)}")


class _SingleIterator(DataSetIterator):
    def __init__(self, ds: DataSet):
        self._ds = ds

    def batch_size(self):
        return self._ds.num_examples()

    def __iter__(self):
        yield self._ds
