"""The eager training step both network engines share.

``MultiLayerNetwork`` and ``ComputationGraph`` train the same way: a
training forward and loss at the current parameters, ``torch.autograd.grad``
(the kernels' backwards where the forward ran them), the l1/l2 penalty
over each layer's ``W``, gradient normalization and clipping, the
divergence sentinel's verdict, then the updater and the constraints. A
step the sentinel rejects leaves parameters, updater state and layer
state as they were. A FrozenLayer's parameters get zero gradients (its
``apply`` detaches them) and are skipped by the l1/l2 penalty, the
updater and the constraints. The engines differ only in their loss and
in how they pair layers with parameters, which they hand in; both draw
dropout from ``generator``.

The training modes of ``fit`` meet here too:

- **16-bit training** (a ``BFLOAT16``/``HALF`` network): the masters and
  the updater state are f32; the loss differentiates compute-dtype
  copies and the gradients come back upcast to f32 (exactly: the
  transpose of the f32 -> 16-bit cast). Under the fused master-cast
  updater (:func:`train_step`'s ``params_c``) the step carries the
  compute copy between steps and the updater writes the next one beside
  each master (``updaters.apply_leafwise_cast``); the unfused step casts
  the masters at the top of every forward. Both give the same bits.
- **micro-batch accumulation**: the engine's value-and-grad is
  ``nn/microbatch.py``'s loop; this step sees one gradient as before.
- **no host sync** (``on_device=True``, ``fit_on_device``): the
  sentinel's verdict stays a device bool and selects between the new and
  the old trees with ``torch.where``, bit for bit what the host verdict
  applies.
- **a data-parallel step** (inside a ``ParallelWrapper`` step, whose
  context ``parallel.collectives.current()`` returns): each rank's loss is
  its masked sum over the GLOBAL label count (``ops/losses.py``), the
  l1/l2 term is added on data rank 0 only (so it counts once), the
  gradients go through the context's ``sync`` (the bucketed all-reduce, or
  the ZeRO-1 reduce-scatter that leaves each rank its chunk of each
  sharded leaf), clipping and the sentinel reduce their norms over the
  shards, and under ZeRO-1 the updater runs on this rank's chunks of the
  parameters and the updater state, the new parameters all-gathered
  after it.
"""

from __future__ import annotations

import torch

from .. import dtypes as _dt
from .. import environment as _env
from ..parallel import collectives as _coll
from ..utils import tree as _tree
from . import constraints as _constraints
from . import gradnorm as _gn
from . import updaters as _upd


def generator(net) -> torch.Generator:
    """``net``'s dropout generator on its device, seeded from
    ``conf.seed`` at first use after ``init`` (``net._rng``; ``init``
    resets it)."""
    if net._rng is None:
        net._rng = torch.Generator(device=net.device).manual_seed(
            int(net.conf.seed))
    return net._rng


def head_loss(layer, out, y, mask, state, new_state, key):
    """``(loss, new_state)`` of the loss head ``layer`` (the vertex or layer
    index ``key``) on its output ``out``. A center-loss head
    (``update_centers``) stashed its input features in ``new_state[key]``:
    they are popped there (they must not persist), its loss takes them and
    the current centers, and its centers move by the EMA rule outside the
    gradient, as in the JAX engines."""
    weights = getattr(layer, "loss_weights", None)
    if not hasattr(layer, "update_centers"):
        return layer.loss_value(out, y, mask=mask, weights=weights), \
            new_state
    st = dict(new_state[key])
    feats = st.pop("__features__")
    centers = state[key]["centers"]
    with torch.no_grad():
        st["centers"] = layer.update_centers(centers, feats.detach(), y)
    loss = layer.loss_value(out, y, mask=mask, weights=weights,
                            features=feats, centers=centers.detach())
    return loss, {**new_state, key: st}


def regularization(conf, pairs):
    """The l1/l2 penalty over ``(layer, params)`` pairs: each pair's ``W``
    with the layer's own coefficient, else the network's (DL4J regularizes
    W, not b); ``layer`` may be None (the network's coefficients), and a
    frozen layer has none. In a data-parallel step only data rank 0 adds
    it (the ranks' losses and gradients are summed)."""
    total = 0.0
    ctx = _coll.current()
    if ctx is not None and ctx.data_rank != 0:
        return total
    for layer, params in pairs:
        if getattr(layer, "frozen", False):
            continue
        l1 = getattr(layer, "l1", 0.0) or conf.l1
        l2 = getattr(layer, "l2", 0.0) or conf.l2
        w = params.get("W")
        if not (l1 or l2) or w is None:
            continue
        if l1:
            total = total + l1 * torch.sum(torch.abs(w))
        if l2:
            total = total + 0.5 * l2 * torch.sum(torch.square(w))
    return total


def clip(conf, grads, reducer=None):
    """Gradient normalization and clipping: ``(grads, clip_events)``;
    ``reducer`` gives the norms of sharded gradients (see
    ``gradnorm.clip_with_events``)."""
    return _gn.clip_with_events(
        conf.gradient_normalization, conf.gradient_normalization_threshold,
        conf.gradient_clip_value, conf.gradient_clip_l2, grads,
        reducer=reducer)


def value_and_grad(params, loss_fn):
    """``(loss, grads, aux)`` of ``loss_fn(params) -> (loss, aux)`` at
    ``params``: one forward and ``torch.autograd.grad``. ``grads`` is keyed
    like ``params``; a parameter the loss does not reach gets zeros. In a
    wrapper step whose context has a ``grad_hook`` (the overlapped
    gradient collectives), each parameter's gradient is handed to it, with
    the parameter's path, as soon as autograd makes it."""
    from ..parallel.placement import map_paths
    leaves = []
    ctx = _coll.current()
    hook = None if ctx is None else ctx.grad_hook

    def track(path, t):
        t = t.detach()
        if t.is_floating_point():
            t.requires_grad_(True)
            leaves.append(t)
            if hook is not None:
                t.register_hook(lambda g, _p=path: hook(_p, g))
        return t

    tracked = map_paths(track, params)
    loss, aux = loss_fn(tracked)
    found = iter(torch.autograd.grad(loss, leaves, allow_unused=True))

    def grad_of(t):
        if not t.is_floating_point():
            return torch.zeros_like(t)
        g = next(found)
        return torch.zeros_like(t) if g is None else g

    return loss.detach(), _tree.tmap(grad_of, tracked), aux


def _without(tree, keys):
    return {k: v for k, v in tree.items() if k not in keys}


def apply_updater(updater, grads, updater_state, params, step, frozen=(),
                  compute_dtype=None, params_c=None):
    """The updater over every parameter outside the top-level keys
    ``frozen``: ``(new_params, new_updater_state)``. A frozen key's
    parameters and its updater slots are left as they are, bit for bit
    (no momentum, no weight decay: the JAX package's zero gradient moves
    neither on a fresh updater state). With ``compute_dtype`` (the fused
    master-cast updater) it returns ``(new_params, new_params_c,
    new_updater_state)``, the live keys' compute copies written beside
    their masters, the frozen keys' taken from ``params_c``."""
    args = (updater, _without(grads, frozen),
            {slot: _without(t, frozen) for slot, t in updater_state.items()},
            _without(params, frozen), step)
    if compute_dtype is None:
        live, live_state = _upd.apply_leafwise(*args)
    else:
        live, live_c, live_state = _upd.apply_leafwise_cast(*args,
                                                            compute_dtype)
    new_params = {k: live.get(k, v) for k, v in params.items()}
    new_state = {slot: {**updater_state.get(slot, {}), **t}
                 for slot, t in live_state.items()}
    if compute_dtype is None:
        return new_params, new_state
    return (new_params, {k: live_c.get(k, v) for k, v in params_c.items()},
            new_state)


def _select(ok, new, old):
    return _tree.tmap(lambda a, b: torch.where(ok, a, b), new, old)


def train_step(net, vg, params_c=None, on_device=False):
    """One step of ``net`` (its ``params``, ``state``, ``updater_state``,
    ``conf``, ``iteration``, ``_sentinel``, ``_frozen`` and ``device``) on
    ``vg(params) -> (loss, grads, new_state)``, inside one precision
    context; the top-level parameter keys ``net._frozen`` (FrozenLayers)
    are skipped by the updater and the constraints.

    ``params_c``: the fused master-cast updater's compute copy of the
    masters, which ``vg`` differentiates in their place; the step returns
    the next one. ``on_device``: the sentinel's verdict is not read on the
    host. Returns ``(loss, params_c)`` (the loss a device tensor)."""
    conf = net.conf
    ctx = _coll.current()
    sync = None if ctx is None else ctx.sync
    with _env.precision(net.device):
        loss, grads, new_state = vg(net.params if params_c is None
                                    else params_c)
        with torch.no_grad():
            # 16-bit gradients (the fused step's, the hoisted accumulation's)
            # upcast exactly to the masters' dtype
            grads = _dt.cast_floating(grads, _dt.param_dtype(conf.dtype))
            if sync is not None:
                loss, grads = sync.reduce(loss, grads)
            reducer = sync if sync is not None and sync.sharded else None
            grads, clip_events = clip(conf, grads, reducer)
            ok = net._sentinel.verdict(loss, grads, clip_events,
                                       on_device=on_device, reducer=reducer)
            if ok is False:
                return loss, params_c
            if params_c is None and sync is not None and sync.zero:
                # ZeRO-1: the updater on this rank's chunks, then the new
                # parameters all-gathered
                shards, upd_state = apply_updater(
                    conf.updater, grads, net.updater_state,
                    sync.shard_tree(net.params), net.iteration, net._frozen)
                params = sync.gather_tree(shards)
                new_c = None
            elif params_c is None:
                params, upd_state = apply_updater(
                    conf.updater, grads, net.updater_state, net.params,
                    net.iteration, net._frozen)
                new_c = None
            else:
                cdt = _dt.resolve(conf.dtype)
                params, new_c, upd_state = apply_updater(
                    conf.updater, grads, net.updater_state, net.params,
                    net.iteration, net._frozen, cdt, params_c)
            if conf.constraints:
                params = _constraints.apply_constraints(
                    conf.constraints, params, skip=net._frozen)
                if new_c is not None:
                    # the constraints rewrite the masters after the update,
                    # so the compute copy is re-derived from them
                    new_c = _dt.cast_floating(params, cdt)
            if ok is not True:  # a device verdict: select, no sync
                params = _select(ok, params, net.params)
                upd_state = _select(ok, upd_state, net.updater_state)
                new_state = _select(ok, new_state, net.state)
                if new_c is not None:
                    new_c = _select(ok, new_c, params_c)
            net.params, net.updater_state, net.state = \
                params, upd_state, new_state
    return loss, new_c


def fused_cast_active(net) -> bool:
    """Does ``net``'s step fold the f32 -> compute master cast into the
    updater's write? A 16-bit policy with no l1/l2 term (the penalty reads
    the masters the loss is handed)."""
    from ..ops import fused_epilogues as _fe
    return _fe.route_updater(
        net.conf.dtype, has_penalty=net._uses_regularization()) is None


def uses_regularization(conf, layers) -> bool:
    """Any l1/l2 term configured, net-level or on a layer?"""
    if conf.l1 or conf.l2:
        return True
    return any((getattr(l, "l1", 0.0) or getattr(l, "l2", 0.0))
               for l in layers)


def step_fn(net, vg_of_batch, accum_steps: int, fused_cast: bool,
            weight_fn):
    """The engines' train step ``(batch, on_device=False) -> loss`` for
    ``_build_train_step``: ``vg_of_batch(params, state, rng, *batch) ->
    (loss, grads, new_state)`` is the engine's value-and-grad of one
    batch. ``accum_steps > 1`` accumulates it over microbatches
    (``nn/microbatch.py``), the masters cast to the compute dtype once a
    step under a 16-bit policy with no l1/l2 term (the cast hoist, bit
    for bit the per-microbatch cast). ``fused_cast`` carries the compute
    copy in ``step.params_c`` (None: cast the masters at the next call;
    ``fit`` resets it once a call, as the JAX ``fit`` casts once a
    call)."""
    from . import microbatch as _micro
    if fused_cast and accum_steps != 1:
        raise ValueError("fused_cast requires accum_steps == 1 "
                         "(the microbatch loop has its own hoist)")
    cdt = _dt.resolve(net.conf.dtype)
    hoist = (accum_steps > 1 and _dt.is_mixed(net.conf.dtype)
             and not net._uses_regularization())

    def step(*batch, on_device=False):
        rng = generator(net)
        if accum_steps == 1:
            def vg(p):
                return vg_of_batch(p, net.state, rng, *batch)
        else:
            def vg(p):
                return _micro.accumulate_gradients(
                    lambda q, s, *mb: vg_of_batch(q, s, rng, *mb),
                    _dt.cast_floating(p, cdt) if hoist else p, net.state,
                    accum_steps, batch, weight_fn=weight_fn)
        if fused_cast and step.params_c is None:
            step.params_c = _dt.cast_floating(net.params, cdt)
        loss, params_c = train_step(
            net, vg, step.params_c if fused_cast else None, on_device)
        if fused_cast:
            step.params_c = params_c
        return loss

    step.params_c = None
    return step


def stack_dataset(net, features, labels, batch_size, drop_remainder):
    """``fit_on_device``'s upload: each array of ``features`` and
    ``labels`` (lists, one per network input and output) reshaped to
    ``[n_batches, B, ...]`` on ``net``'s device in one copy, the features
    cast to the network dtype (as the forward would cast them), the
    labels kept (the loss computes in f32 under a 16-bit policy). Raises
    for a ragged tail unless ``drop_remainder``."""
    n = len(features[0])
    b = batch_size or n
    nb = n // b
    if nb == 0:
        raise ValueError(f"batch_size {b} exceeds dataset size {n}")
    if n % b and not drop_remainder:
        raise ValueError(
            f"dataset size {n} is not divisible by batch_size {b}: the "
            f"on-device loop would drop {n % b} examples. Pass "
            "drop_remainder=True to accept that, or use fit() which "
            "pads and masks the tail")
    dt = _dt.resolve(net.conf.dtype)

    def stack(a, cast):
        t = net._tensor(a[:nb * b])
        if cast and t.is_floating_point() and dt.is_floating_point:
            t = t.to(dt)
        return t.reshape((nb, b) + tuple(t.shape[1:]))
    return ([stack(a, True) for a in features],
            [stack(a, False) for a in labels])


def device_epochs(net, step, epochs: int, n_batches: int, batch_at):
    """``epochs`` passes of ``step(*batch_at(i), on_device=True)`` over
    the ``n_batches`` stacked batches, with no host sync inside an epoch;
    the loss history as one numpy vector, read once at the end."""
    history = []
    for _ in range(epochs):
        losses = []
        for i in range(n_batches):
            losses.append(step(*batch_at(i), on_device=True))
            net.iteration += 1
        net.epoch += 1
        net._score = losses[-1]
        history.append(torch.stack(losses))
    out = torch.cat(history).float().cpu().numpy()
    net._score = float(out[-1])
    return out
