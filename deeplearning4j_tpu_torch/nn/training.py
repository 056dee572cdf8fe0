"""The eager training step both network engines share.

``MultiLayerNetwork`` and ``ComputationGraph`` train the same way: a
training forward and loss at the current parameters, ``torch.autograd.grad``
(the kernels' backwards where the forward ran them), the l1/l2 penalty
over each layer's ``W``, gradient normalization and clipping, the
divergence sentinel's verdict (one host sync), then the updater and the
constraints. A step the sentinel rejects leaves parameters, updater state
and layer state as they were. A FrozenLayer's parameters get zero
gradients (its ``apply`` detaches them) and are skipped by the l1/l2
penalty, the updater and the constraints. The engines differ only in
their loss and in how they pair layers with parameters, which they hand
in; both draw dropout from ``generator``.
"""

from __future__ import annotations

import torch

from .. import environment as _env
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
    frozen layer has none."""
    total = 0.0
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


def clip(conf, grads):
    """Gradient normalization and clipping: ``(grads, clip_events)``."""
    return _gn.clip_with_events(
        conf.gradient_normalization, conf.gradient_normalization_threshold,
        conf.gradient_clip_value, conf.gradient_clip_l2, grads)


def value_and_grad(params, loss_fn):
    """``(loss, grads, aux)`` of ``loss_fn(params) -> (loss, aux)`` at
    ``params``: one forward and ``torch.autograd.grad``. ``grads`` is keyed
    like ``params``; a parameter the loss does not reach gets zeros."""
    leaves = []

    def track(t):
        t = t.detach()
        if t.is_floating_point():
            t.requires_grad_(True)
            leaves.append(t)
        return t

    tracked = _tree.tmap(track, params)
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


def apply_updater(updater, grads, updater_state, params, step, frozen=()):
    """The updater over every parameter outside the top-level keys
    ``frozen``: ``(new_params, new_updater_state)``. A frozen key's
    parameters and its updater slots are left as they are, bit for bit
    (no momentum, no weight decay: the JAX package's zero gradient moves
    neither on a fresh updater state)."""
    live, live_state = _upd.apply_leafwise(
        updater, _without(grads, frozen),
        {slot: _without(t, frozen) for slot, t in updater_state.items()},
        _without(params, frozen), step)
    return ({k: live.get(k, v) for k, v in params.items()},
            {slot: {**updater_state.get(slot, {}), **t}
             for slot, t in live_state.items()})


def train_step(net, loss_fn):
    """One step of ``net`` (its ``params``, ``state``, ``updater_state``,
    ``conf``, ``iteration``, ``_sentinel``, ``_frozen`` and ``device``) on
    ``loss_fn(params) -> (loss, new_state)``, inside one precision
    context; the top-level parameter keys ``net._frozen`` (FrozenLayers)
    are skipped by the updater and the constraints. Returns the loss (a
    device tensor)."""
    with _env.precision(net.device):
        loss, grads, new_state = value_and_grad(net.params, loss_fn)
        with torch.no_grad():
            grads, clip_events = clip(net.conf, grads)
            if net._sentinel.verdict(loss, grads, clip_events):
                params, net.updater_state = apply_updater(
                    net.conf.updater, grads, net.updater_state, net.params,
                    net.iteration, net._frozen)
                net.params = _constraints.apply_constraints(
                    net.conf.constraints, params, skip=net._frozen)
                net.state = new_state
    return loss
