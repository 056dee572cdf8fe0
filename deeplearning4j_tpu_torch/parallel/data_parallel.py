"""Data-parallel (and dense tensor-parallel) training over a mesh of ranks.

Port of ``deeplearning4j_tpu/parallel/data_parallel.py``, DL4J's
``ParallelWrapper``. In the JAX package one compiled program runs over a
device mesh and GSPMD inserts the collectives; the port runs one process
per rank (torch's idiom, a deliberate divergence: one process drives one
card), each stepping eagerly on its rows of every batch, with explicit
``torch.distributed`` collectives (``collectives.py``, ``overlap.py``).
The contract kept: replicas run in the same step from rank 0's
parameters (broadcast when a fit begins on parameters the wrapper did not
leave), the update is deterministic, and every rank ends a step with the
same parameters, bit for bit.

- **The batch.** Each rank reads the same global batch and takes its
  rows of the batch padded to the data axis (times ``accum_steps``); a
  :class:`~.launcher.HostShardedIterator` hands a rank its rows directly.
  Padded rows get a zero loss weight and a zero feature mask, so
  train-mode BatchNorm leaves them out of its moments.
- **The step** is the engines' own (``nn/training.py``) inside a step
  context (``collectives.step_context``): BatchNorm moments are the
  global batch's (one all-reduce of ``(s1, s2, cnt)`` a layer), each
  rank's loss is its masked sum over the global label count, the l1/l2
  term counts once, and the gradients are summed over the data axis in
  size-capped buckets (``overlap.make_buckets``).
- **``shard_update=True``** (ZeRO-1, Xu et al. 2020): each parameter leaf's
  update is split over the data axis along the dimension ``_update_spec``
  picks (the JAX rule: the largest free dimension the data axis divides);
  the bucket collective is a reduce-scatter, the updater runs on this
  rank's chunks of the gradient, the parameter and its updater state, and
  the new chunks are all-gathered. Only an elementwise updater keeps the
  shard of the update equal to the update of the shard; another is
  refused.
- **``overlap_grads=True``** (needs ``shard_update``): the bucket
  collectives start async from gradient hooks as the backward makes
  them, in bucket order (``overlap.py``).
- **``accum_steps=k``**: the rows of a rank split into k microbatches
  weighted by their global label count (``nn/microbatch.py``), one update.
- **``model_axis``** (a ``make_dp_tp_mesh`` mesh): the dense family's
  kernels ``W [in, out]`` keep a 1/tp share of their columns on each model
  rank (``placement.tp_param_spec``), ``b`` follows, and the layer gathers
  its output columns (``collectives.gather_columns``). Gradient
  collectives run over the data axis (the model ranks of one data index
  read the same rows).

Between ``fit`` calls each rank keeps only its shares, as the JAX
package's sharded global arrays stay sharded: the tensor-parallel
columns and the ZeRO-1 updater-state chunks stay in the model, and the
next ``fit`` steps on them as they are. The first read of the model's
``params`` or ``updater_state`` from outside the step (a checkpoint, a
ZIP, ``output``, a plain ``fit``) gathers the full values back
(``collectives.HeldShards``): a collective, so every rank reads them.

Each wrapper counts its collectives (calls and bytes by op, and the
backend; ``counters()``).

Not here: ``tune_schedule``, ``attribution_report``, ``on_host_loss`` and
``fit(resilience=)`` come with ROADMAP.md Queue 1 item 9 (the runtime
slice); ``serving_engine`` with item 8's serving part.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from .. import environment as _env
from ..utils import tree as _tree
from . import collectives as _coll
from . import launcher as _launcher
from . import overlap as _overlap
from . import placement as _pl

_RUNTIME = "the runtime slice of the port (ROADMAP.md Queue 1 item 9)"
_SERVING = "the serving part of ROADMAP.md Queue 1 item 8"


def make_mesh(devices: Optional[Sequence] = None, axis: str = "data"
              ) -> "_launcher.Mesh":
    """A 1-axis mesh over ``devices`` (ranks; default every rank)."""
    ranks = list(devices) if devices is not None else \
        list(range(_launcher.process_count()))
    return _launcher.Mesh(np.asarray(ranks), (axis,))


def make_dp_tp_mesh(data: int, model: int,
                    devices: Optional[Sequence] = None) -> "_launcher.Mesh":
    """2-axis ``('data', 'model')`` mesh for data + tensor parallelism;
    model-axis neighbours are consecutive ranks."""
    ranks = list(devices) if devices is not None else \
        list(range(_launcher.process_count()))
    if data * model != len(ranks):
        raise ValueError(f"data*model = {data * model} != {len(ranks)} "
                         "ranks")
    return _launcher.Mesh(np.asarray(ranks).reshape(data, model),
                          ("data", "model"))


class ParallelWrapper:
    """Data-parallel ``fit`` over a mesh of ranks (DL4J's name)::

        launcher.initialize()             # one process per rank
        pw = ParallelWrapper(net)         # mesh over every rank
        pw.fit(iterator, epochs=2)

    With no process group it trains as a mesh of one rank. ``device``:
    the rank's device (default the model's; ``cuda`` for an uninitialized
    model, which raises without a card unless the caller asks for
    ``cpu``)."""

    def __init__(self, model, mesh=None, model_axis: Optional[str] = None,
                 shard_update: bool = False, accum_steps: int = 1,
                 overlap_grads: bool = False,
                 overlap_bucket_mb: Optional[float] = None,
                 dcn_hosts: Optional[int] = None, device=None):
        self.device = _env.resolve_device(
            device if device is not None else model.device)
        self.model = model
        self.mesh = mesh if mesh is not None else make_mesh()
        self.model_axis = model_axis
        if model_axis is not None and model_axis not in self.mesh.axis_names:
            raise ValueError(f"model_axis {model_axis!r} not in mesh axes "
                             f"{self.mesh.axis_names}")
        self.shard_update = bool(shard_update)
        if accum_steps < 1:
            raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
        self.accum_steps = int(accum_steps)
        if self.shard_update:
            if "data" not in self.mesh.axis_names:
                raise ValueError(
                    "shard_update needs a 'data' mesh axis to shard over; "
                    f"mesh has {self.mesh.axis_names}")
            if model_axis == "data":
                raise ValueError("model_axis cannot be the 'data' axis the "
                                 "sharded update partitions over")
            upd = getattr(model.conf, "updater", None)
            if upd is not None and not getattr(upd, "elementwise", True):
                raise ValueError(
                    f"shard_update requires an elementwise updater; "
                    f"{type(upd).__name__} is not")
        if overlap_grads and not self.shard_update:
            raise ValueError("overlap_grads=True requires shard_update=True "
                             "(it pipelines the ZeRO-1 collectives)")
        self.overlap_grads = bool(overlap_grads)
        self.overlap_bucket_bytes = int(
            (overlap_bucket_mb or _overlap.DEFAULT_BUCKET_MB) * (1 << 20))
        self.dcn_hosts = dcn_hosts
        self._is_graph = hasattr(model.conf, "vertices")
        self._dense_key_cache = None
        self._counters = _coll.Counters()
        self._comms = None       # (data, model, world) Comms, made once
        self._hierarchy = None
        self._step = None        # (model step, GradientSync, StepContext)
        self._synced = None      # the params dict the last fit left
        self._held = None        # (GradientSync, tp) of the held shares
        self._stats = {"steps": 0, "buckets": 0,
                       "updater_state_bytes_per_rank": 0,
                       "params_bytes_per_rank": 0}

    # ------------------------------------------------------------ knobs
    def set_overlap(self, on: bool, bucket_mb: Optional[float] = None
                    ) -> "ParallelWrapper":
        """Toggle the gradient-collective overlap in place (the next step
        is built with it)."""
        on = bool(on)
        if on and not self.shard_update:
            raise ValueError("overlap_grads=True requires shard_update=True")
        changed = on != self.overlap_grads
        if bucket_mb is not None:
            nb = int(float(bucket_mb) * (1 << 20))
            if nb != self.overlap_bucket_bytes:
                self.overlap_bucket_bytes = nb
                changed = True
        self.overlap_grads = on
        if changed:
            self._step = None
        return self

    def set_accum_steps(self, k: int) -> "ParallelWrapper":
        """Change the micro-accumulation factor in place (equal to
        ``accum_steps=1`` to float tolerance, not bit for bit)."""
        k = int(k)
        if k < 1:
            raise ValueError(f"accum_steps must be >= 1, got {k}")
        if k != self.accum_steps:
            self.accum_steps = k
            self._step = None
        return self

    def tune_schedule(self, *args, **kwargs):
        raise NotImplementedError(f"tune_schedule comes with {_RUNTIME}")

    def attribution_report(self, *args, **kwargs):
        raise NotImplementedError(
            f"attribution_report comes with {_RUNTIME}")

    def on_host_loss(self):
        raise NotImplementedError(f"on_host_loss comes with {_RUNTIME}")

    def serving_engine(self, **kwargs):
        raise NotImplementedError(
            f"serving over a mesh comes with {_SERVING}")

    # ------------------------------------------------------------ specs
    def _dense_keys(self) -> set:
        return _pl.dense_tp_keys(self.model)

    def _param_spec(self, path: tuple, arr) -> tuple:
        """Spec of one parameter leaf under tensor parallelism (the dense
        family only)."""
        if self.model_axis is None:
            return ()
        if self._dense_key_cache is None:
            self._dense_key_cache = self._dense_keys()
        return _pl.tp_param_spec(
            tuple(str(p) for p in path), arr, self.model_axis,
            int(self.mesh.shape[self.model_axis]), self._dense_key_cache)

    def _update_spec(self, path: tuple, arr) -> tuple:
        """Spec of one updater-state leaf under ZeRO-1: on top of the
        parameter's own spec, the largest still-free dimension the data
        axis divides goes to ``'data'``; a leaf with none keeps the base
        spec (its update stays replicated)."""
        base = self._param_spec(path, arr)
        n = self.mesh.shape["data"]
        shape = tuple(arr.shape)
        ndim = len(shape)
        if n <= 1 or ndim == 0:
            return base
        taken = {i for i, ax in enumerate(base) if ax is not None}
        free = [d for d in range(ndim) if d not in taken]
        for d in sorted(free, key=lambda d: -shape[d]):
            if shape[d] % n == 0:
                spec = list(base) + [None] * (ndim - len(base))
                spec[d] = "data"
                return tuple(spec)
        return base

    # ------------------------------------------------------------- setup
    def _ensure_comms(self):
        if self._comms is not None:
            return self._comms
        dev = self.device
        c = self._counters
        axes = self.mesh.axis_names
        dg, dr = self.mesh.group("data") if "data" in axes else (None, [0])
        mg, mr = self.mesh.group(self.model_axis) \
            if self.model_axis is not None else (None, [0])
        data = _coll.Comm(dg, dev, c, dr)
        model = _coll.Comm(mg, dev, c, mr)
        if _launcher.process_count() > 1:
            import torch.distributed as dist
            world = _coll.Comm(dist.group.WORLD, dev, c,
                               range(_launcher.process_count()))
        else:
            world = _coll.Comm(None, dev, c)
        hier = _overlap.host_hierarchy(self.mesh, self.dcn_hosts)
        self._hierarchy = None if hier is None else hier.connect(dev, c)
        self._comms = (data, model, world)
        return self._comms

    def _plan(self, params):
        """``(tp paths with their column dim, zero paths with their dim,
        update specs)`` for the model's full parameter tree."""
        tp, zero, specs = {}, {}, {}
        for path, leaf in _pl.flatten_paths(params):
            spec = self._param_spec(path, leaf)
            if self.model_axis in tuple(spec):
                tp[path] = tuple(spec).index(self.model_axis)
            uspec = self._update_spec(path, leaf) if self.shard_update \
                else spec
            specs[path] = uspec
            d = _overlap.zero_dim(uspec)
            if d is not None:
                zero[path] = d
        return tp, zero, specs

    def _build(self):
        data, model, _ = self._ensure_comms()
        m = self.model
        tp, zero, specs = self._plan(m.params)
        local = self._tp_local(m.params, tp)
        buckets = _overlap.make_buckets(local, self.overlap_bucket_bytes)
        chains = None
        if self._hierarchy is not None:
            spec_tree = _pl.map_paths(lambda p, _: specs[p], m.params)
            chains = _overlap.split_dcn_chains(buckets, spec_tree)
        sync = _overlap.GradientSync(
            local, buckets, zero, tp, data, model,
            hierarchy=self._hierarchy, chains=chains,
            overlap=self.overlap_grads)
        ctx = _coll.StepContext(data, model, sync)
        self._stats["buckets"] = len(buckets) if self.overlap_grads else 0
        self._tp = tp
        self._step = (m._build_train_step(self.accum_steps), sync, ctx)
        return self._step

    def _tp_local(self, tree, tp):
        """This model rank's share of a full params-shaped tree (the
        model-axis part of each leaf's spec)."""
        if not tp:
            return tree
        return _pl.map_paths(
            lambda p, t: _pl.put_full(t, self._param_spec(p, t), self.mesh)
            if p in tp else t, tree)

    def _tp_full(self, tree, tp):
        if not tp:
            return tree
        model = self._comms[1]
        return _pl.map_paths(
            lambda p, t: model.gather_dim(t, tp[p]) if p in tp else t, tree)

    def _broadcast_from_rank0(self):
        """Every rank takes rank 0's parameters, layer state and updater
        state (one broadcast per dtype and tree)."""
        world = self._comms[2]
        if world.size == 1:
            return
        m = self.model
        for tree in (m.params, m.state, m.updater_state):
            by_dtype = {}
            for _, t in _pl.flatten_paths(tree):
                by_dtype.setdefault(t.dtype, []).append(t)
            for ts in by_dtype.values():
                flat = torch.cat([t.reshape(-1) for t in ts])
                world.broadcast(flat, src=0)
                off = 0
                for t in ts:
                    t.copy_(flat[off:off + t.numel()].view(t.shape))
                    off += t.numel()

    def _seed_stream(self):
        """Data ranks draw dropout from distinct streams (the model ranks
        of one data index, which read the same rows, share theirs)."""
        data = self._comms[0]
        m = self.model
        if data.rank > 0 and m._rng is None:
            m._rng = torch.Generator(device=self.device).manual_seed(
                int(m.conf.seed) + 1_000_003 * data.rank)

    # --------------------------------------------------------------- fit
    def fit(self, data, epochs: int = 1, resilience=None):
        if resilience is not None:
            raise NotImplementedError(
                f"fit(resilience=...) comes with {_RUNTIME}")
        m = self.model
        holder = m._holder
        if holder is not None and (holder is not self or self._step is None
                                   or self._held[0] is not self._step[1]):
            holder.release(m)  # shares laid out for another step
        if m._holder is self:  # this wrapper's shares, still in place
            m._holder = None
            step, sync, ctx = self._step
            tp = self._tp
        else:
            if not m.params and not m.state:
                m.init(device=self.device)
            m._check_trainable()
            self._ensure_comms()
            step, sync, ctx = self._step if self._step is not None \
                else self._build()
            tp = self._tp
            with torch.no_grad():
                if self._synced is None or m._params is not self._synced:
                    self._broadcast_from_rank0()
                m._params = self._tp_local(m._params, tp)
                m._updater_state = {
                    slot: sync.shard_tree(self._tp_local(t, tp))
                    for slot, t in m._updater_state.items()}
        self._seed_stream()
        self._stats["updater_state_bytes_per_rank"] = _bytes(
            m._updater_state)
        self._stats["params_bytes_per_rank"] = _bytes(m._params)
        hook = sync.hook if self.overlap_grads and self.accum_steps == 1 \
            else None
        try:
            for _ in range(epochs):
                for batch in self._batches(data):
                    args = self._rank_batch(batch)
                    sync.begin()
                    ctx.grad_hook = hook
                    with _coll.step_context(ctx):
                        m._score = step(*args)
                    m.iteration += 1
                    self._stats["steps"] += 1
                m.epoch += 1
        finally:
            ctx.grad_hook = None
            # the shares stay in the model until a read of its trees
            # gathers them (collectives.HeldShards)
            if tp or sync.zero:
                self._held = (sync, tp)
                m._holder = self
            else:
                self._synced = m._params
        return m

    def holds(self, tree: str) -> bool:
        """Whether the shares left in the model include ``tree``'s
        (``"params"``: only under tensor parallelism)."""
        return tree != "params" or bool(self._held[1])

    def release(self, m=None) -> None:
        """Gather the shares this wrapper left in the model back into full
        params and updater state (one all-gather a bucket and a model-axis
        gather a sharded leaf; every rank calls it). A no-op when the
        model holds none of them."""
        m = self.model if m is None else m
        if m._holder is not self:
            return
        sync, tp = self._held
        m._holder = None
        with torch.no_grad():
            m._updater_state = {
                slot: self._tp_full(sync.gather_tree(t), tp)
                for slot, t in m._updater_state.items()}
            m._params = self._tp_full(m._params, tp)
        self._synced = m._params

    def counters(self) -> dict:
        """The wrapper's collectives (calls and bytes by op, collective
        seconds when timed), the backend, and the step statistics."""
        out = self._counters.as_dict()
        out.update(self._stats)
        data = None if self._comms is None else self._comms[0]
        out["backend"] = None if data is None else data.backend
        out["backend_choice"] = _launcher.backend_choice
        return out

    def time_collectives(self, on: bool = True) -> "ParallelWrapper":
        """Bracket every collective with device synchronizations and add
        its host wall time to ``counters()["collective_s"]`` (a
        measurement mode: it serializes the overlap)."""
        self._counters.timed = bool(on)
        return self

    def memory_report(self, batch_size: int, seq_len=None) -> dict:
        """The step's memory at the GLOBAL ``batch_size``, measured as the
        model's ``memory_report`` measures it (one forward and backward
        of this rank's rows, inside the step context: a collective, so
        every rank calls it), with the per-rank parameter and updater
        bytes of this wrapper's placement."""
        m = self.model
        if not m.params:
            m.init(device=self.device)
        data, _, _ = self._ensure_comms()
        if self._step is None:
            self._build()
        _, sync, ctx = self._step
        rows = max(1, batch_size // data.size)
        with _coll.step_context(_coll.StepContext(ctx.data, ctx.model)):
            rep = m.memory_report(rows, accum_steps=self.accum_steps,
                                  seq_len=seq_len)
        tp, zero, specs = self._plan(m.params)
        spec_tree = _pl.map_paths(lambda p, _: specs[p], m.params)
        rep.update({
            "batch_size": int(batch_size), "rows_per_rank": rows,
            "accum_steps": self.accum_steps,
            "shard_update": self.shard_update,
            "devices": self.mesh.size,
            "params_bytes_per_rank": _pl.tree_bytes_per_device(
                m.params, _pl.map_paths(
                    lambda p, t: self._param_spec(p, t), m.params),
                self.mesh),
            "updater_state_bytes_per_rank": sum(
                _pl.tree_bytes_per_device(t, spec_tree, self.mesh)
                for t in m.updater_state.values())})
        return rep

    # ----------------------------------------------------------- batches
    def _pad_granularity(self, host_sharded: bool = False) -> int:
        """Rows a batch must divide into: the data axis's extent (one for
        rows a HostShardedIterator already split) times ``accum_steps``."""
        n = 1 if host_sharded else self.mesh.shape.get("data",
                                                       self.mesh.size)
        return max(1, n) * self.accum_steps

    def _batches(self, data):
        """Yield ``(x, y, fm, lm)`` numpy batches (tuples of arrays for the
        graph engine), padded to the granularity and masked."""
        host = isinstance(data, _launcher.HostShardedIterator)
        n = self._pad_granularity(host)
        if self._is_graph:
            from ..nn.graph import _as_multi_iterator
            for mds in _as_multi_iterator(data):
                fs = [np.asarray(a) for a in mds.features]
                ls = [np.asarray(a) for a in mds.labels]
                fms = [None if a is None else np.asarray(a)
                       for a in mds.features_masks]
                lms = [None if a is None else np.asarray(a)
                       for a in mds.labels_masks]
                rem = fs[0].shape[0] % n
                if rem:
                    fs, ls, fms, lms = _pad_and_mask_multi(
                        fs, ls, fms, lms, n - rem)
                yield (tuple(fs), tuple(ls), tuple(fms), tuple(lms)), host
        else:
            from ..nn.model import _as_iterator
            for ds in _as_iterator(data):
                x = np.asarray(ds.features)
                y = np.asarray(ds.labels)
                fm = None if ds.features_mask is None else \
                    np.asarray(ds.features_mask)
                lm = None if ds.labels_mask is None else \
                    np.asarray(ds.labels_mask)
                rem = x.shape[0] % n
                if rem:
                    x, y, fm, lm = _pad_and_mask(x, y, fm, lm, n - rem)
                yield (x, y, fm, lm), host

    def _rank_batch(self, item):
        """This rank's rows of one padded batch, as tensors on its
        device (rows a HostShardedIterator split are this rank's
        already)."""
        batch, host = item
        m = self.model
        n = 1 if host else self.mesh.shape.get("data", 1)
        i = 0 if host else self.mesh.index("data")

        def rows(a):
            if a is None:
                return None
            if isinstance(a, tuple):
                return tuple(rows(v) for v in a)
            k = a.shape[0] // n
            return m._tensor(np.ascontiguousarray(a[i * k:(i + 1) * k]))
        return tuple(rows(a) for a in batch)


def _bytes(tree) -> int:
    return sum(int(t.numel()) * t.element_size() for t in _tree.leaves(tree))


def _synth_pad_feature_mask(x, pad):
    """Pad feature mask so mask-aware layers (train-mode BatchNorm moments)
    exclude the padded rows: per-timestep [B,T] for sequence inputs,
    per-example [B] otherwise. ``x`` is already zero-padded by ``pad``."""
    fm = np.ones(x.shape[:2] if x.ndim == 3 else (x.shape[0],), np.float32)
    if pad:  # fm[-0:] would zero the ENTIRE mask
        fm[-pad:] = 0.0
    return fm


def _pad_and_mask(x, y, fm, lm, pad):
    """Zero-pad ``pad`` examples onto the batch and mask them out of the
    loss (zero label weight) and of the BatchNorm moments (zero feature
    mask)."""
    def zpad(a):
        return np.pad(a, [(0, pad)] + [(0, 0)] * (a.ndim - 1))

    x, y = zpad(x), zpad(y)
    fm = zpad(fm) if fm is not None else _synth_pad_feature_mask(x, pad)
    if lm is not None:
        lm = zpad(lm)
    else:
        # a per-example pad mask; the loss INTERSECTS it with any
        # network-propagated mask (ops/losses.combine_masks)
        lm = np.ones((y.shape[0],), dtype=np.float32)
        lm[-pad:] = 0.0
    return x, y, fm, lm


def _pad_and_mask_multi(fs, ls, fms, lms, pad):
    """Multi-input/-output :func:`_pad_and_mask` for the graph engine."""
    def zpad(a):
        return np.pad(a, [(0, pad)] + [(0, 0)] * (a.ndim - 1))

    fs = [zpad(a) for a in fs]
    ls = [zpad(a) for a in ls]
    fms = [zpad(m) if m is not None else _synth_pad_feature_mask(x, pad)
           for x, m in zip(fs, fms)]
    out_lms = []
    for y, m in zip(ls, lms):
        if m is not None:
            out_lms.append(zpad(m))
        else:
            lm = np.ones((y.shape[0],), dtype=np.float32)
            lm[-pad:] = 0.0
            out_lms.append(lm)
    return fs, ls, fms, out_lms
