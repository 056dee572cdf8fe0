"""The divergence sentinel of the train step.

Port of ``deeplearning4j_tpu/runtime/sentinel.py``. A step whose loss or
global gradient sum of squares is not finite is skipped: params, updater
state and BN state keep their pre-step values, and the counters say so
(DL4J raises from the updater instead; the JAX package skips, and so does
the port).

Divergence from the JAX package: there the verdict is a ``lax.cond``
inside the compiled step and the counters live on the device. The port
steps eagerly, so :meth:`Sentinel.verdict` reads the verdict on the host:
ONE host sync per training step, the only one the step makes on purpose.
``clip_events`` stays a device tensor (no further sync) until
:meth:`Sentinel.to_host`. ``fit_on_device`` asks for the verdict with
``on_device=True``: it stays a device bool, the counters become device
tensors, and nothing is read until :meth:`Sentinel.to_host`.
"""

from __future__ import annotations

import torch

from ..utils.tree import leaves as _leaves

#: - bad_total:   skipped (non-finite) steps over the model's life
#: - bad_consec:  consecutive skipped steps (a good step resets it)
#: - clip_events: steps on which gradient clipping engaged
COUNTERS = ("bad_total", "bad_consec", "clip_events")


def finite_ok(loss, grads, reducer=None):
    """A 0-dim bool tensor: are the loss and the global gradient sum of
    squares (accumulated in f32) both finite? An f32 overflow of the sum
    flags the step bad, which is the intended reading. A ``reducer`` (a
    ``ParallelWrapper`` step whose ranks each hold part of the gradient)
    sums the parts over the ranks, so every rank reads the same verdict."""
    if reducer is not None:
        gss = sum(_leaves(reducer.ssq(grads)))
    else:
        gss = sum(torch.sum(torch.square(g.float())) for g in _leaves(grads))
    return torch.isfinite(loss) & torch.isfinite(torch.as_tensor(gss))


class Sentinel:
    """The counters of one model."""

    def __init__(self):
        self.bad_total = 0
        self.bad_consec = 0
        self.clip_events = 0  # an int, or a 0-dim device tensor

    def verdict(self, loss, grads, clip_events=None, on_device=False,
                reducer=None):
        """Whether this step may be applied (reads one bool from the
        device; with ``on_device`` a 0-dim device bool, read by no one);
        counts the verdict and the clip events."""
        ok = finite_ok(loss, grads, reducer)
        if on_device:
            bad = (~ok).to(torch.int64)
            self.bad_total = self.bad_total + bad
            self.bad_consec = (self.bad_consec + bad) * bad
        else:
            ok = bool(ok)
            self.bad_total += 0 if ok else 1
            self.bad_consec = 0 if ok else self.bad_consec + 1
        if clip_events is not None:
            self.clip_events = self.clip_events + clip_events
        return ok

    def to_host(self) -> dict:
        return {"bad_total": int(self.bad_total),
                "bad_consec": int(self.bad_consec),
                "clip_events": int(self.clip_events)}

