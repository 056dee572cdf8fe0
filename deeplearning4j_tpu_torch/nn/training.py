"""The eager training step both network engines share.

``MultiLayerNetwork`` and ``ComputationGraph`` train the same way: a
training forward and loss at the current parameters, ``torch.autograd.grad``
(the kernels' backwards where the forward ran them), the l1/l2 penalty
over each layer's ``W``, gradient normalization and clipping, the
divergence sentinel's verdict (one host sync), then the updater and the
constraints. A step the sentinel rejects leaves parameters, updater state
and layer state as they were. The engines differ only in their loss and in
how they pair layers with parameters, which they hand in; both draw
dropout from ``generator``.
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


def train_step(net, loss_fn):
    """One step of ``net`` (its ``params``, ``state``, ``updater_state``,
    ``conf``, ``iteration``, ``_sentinel`` and ``device``) on
    ``loss_fn(params) -> (loss, new_state)``, inside one precision
    context. Returns the loss (a device tensor)."""
    with _env.precision(net.device):
        loss, grads, new_state = value_and_grad(net.params, loss_fn)
        with torch.no_grad():
            grads, clip_events = clip(net.conf, grads)
            if net._sentinel.verdict(loss, grads, clip_events):
                params, net.updater_state = _upd.apply_leafwise(
                    net.conf.updater, grads, net.updater_state, net.params,
                    net.iteration)
                net.params = _constraints.apply_constraints(
                    net.conf.constraints, params)
                net.state = new_state
    return loss
