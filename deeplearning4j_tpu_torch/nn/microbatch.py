"""Gradient micro-accumulation: one optimizer step over k microbatches.

Port of ``deeplearning4j_tpu/nn/microbatch.py``, shared by both engines'
``_build_train_step(accum_steps=k)``: the batch ``[B, ...]`` is split
into k microbatches of ``B/k`` and a Python loop (the JAX module's
``lax.scan``) accumulates the gradient into an f32 accumulator before the
single updater application. Only one microbatch's activations are alive
at a time, so the global batch can outgrow device memory.

Exactness contract: losses are means over the (unmasked) batch, so the
accumulator combines microbatches as a WEIGHTED mean: each microbatch's
loss and gradient weighted by its unmasked label count (the engine's
``weight_fn``; equal weights when there is no label mask). With that
weighting, ``accum_steps=k`` at microbatch B/k matches one step at batch B
to float tolerance even when masked rows are spread unevenly (a fully
masked microbatch has weight 0, as if it were never seen).

Recorded divergences (approximate, not exact), as in the JAX package:

- **batch-global losses**: the weighted-mean recombination is exact only
  for losses that are (masked) MEANS over examples. ``fmeasure`` (F-beta
  over whole-batch tp/fp/fn sums) is evaluated per microbatch and
  averaged under ``accum_steps=k``: a close but different objective, and
  no error is raised. Use ``accum_steps=1`` when it matters.
- **propagated feature masks**: the loss intersects the explicit label
  mask with the network-propagated mask (``ops/losses.combine_masks``);
  the weight only sees the label mask, so counts that differ through the
  propagated part make the weighting proportional, not exact.
- **multi-output graphs with differing per-output masks**: one scalar
  weight per microbatch (the combined count over all outputs,
  :func:`multi_output_weight`) cannot match every output's own count
  when those are not proportional; no output's real rows are ever
  dropped, but their relative weighting is approximate.
- **train-mode BatchNorm**: batch moments are per microbatch (B/k), not
  full-batch, as in k real steps at B/k; the running statistics thread
  through the microbatches in order.
- **stochastic layers**: each microbatch draws its dropout from the
  model's generator in turn (``nn/training.py::generator``; JAX:
  ``fold_in(key, i)``), so the noise differs from one full-batch draw,
  and from the JAX package's streams, as everywhere in the port. The
  steps of ``fit_on_device`` draw the same way (JAX's epoch scan folds
  the step index into its key), which keeps them bit for bit those of
  per-batch ``fit``.

The regularization term is added inside every microbatch loss; the
weighted MEAN counts it exactly once in the loss and the gradient.

In a ``ParallelWrapper`` step each rank accumulates over its rows of the
microbatches, and a microbatch's weight is its label count summed over
the data group, so the ranks' weighted means add up to the global one.
"""

from __future__ import annotations

import torch

from ..utils.tree import tmap as _tmap


def split_microbatches(batch, k: int):
    """Every tensor ``[B, ...]`` of a nest of tuples (None leaves pass
    through) as a list of k nests of ``[B/k, ...]`` views. Raises when the
    batch dimension is not divisible by ``k`` (a silent drop or pad would
    corrupt the weighted mean)."""
    def split(a):
        if a is None:
            return [None] * k
        if isinstance(a, (tuple, list)):
            parts = [split(v) for v in a]
            return [tuple(p[i] for p in parts) for i in range(k)]
        b = a.shape[0]
        if b % k:
            raise ValueError(
                f"batch size {b} is not divisible by accum_steps={k}")
        return list(a.reshape((k, b // k) + tuple(a.shape[1:])).unbind(0))
    return split(batch)


def _acc_dtype(a):
    # the accumulator always carries full mantissa: 16-bit gradients (the
    # engines' hoisted mixed-precision path differentiates compute-dtype
    # copies) promote exactly into an f32 accumulator
    return torch.float32 if a.dtype in (torch.bfloat16, torch.float16) \
        else a.dtype


def accumulate_gradients(value_and_grad_fn, params, state, k: int, batch,
                         weight_fn=None):
    """``value_and_grad_fn(params, state, *microbatch) -> (loss, grads,
    new_state)`` over the k microbatches of ``batch`` in turn (the state
    threading through), returning ``(loss, grads, final_state)``: the same
    contract as one call on the whole batch. ``weight_fn(*microbatch)``
    gives a microbatch's weight, or None (equal weights)."""
    from ..parallel import collectives as _coll
    dp = _coll.data_parallel()
    g_acc, l_acc, w_acc = None, 0.0, 0.0
    for mb in split_microbatches(batch, k):
        loss, g, state = value_and_grad_fn(params, state, *mb)
        w_val = None if weight_fn is None else weight_fn(*mb)
        if dp is not None and w_val is not None:
            # a data-parallel step weighs a microbatch by its GLOBAL count
            w_val = _coll.global_sum(w_val, dp.data)
        w = 1.0 if w_val is None else w_val
        if g_acc is None:
            g_acc = _tmap(lambda a: torch.zeros(a.shape, dtype=_acc_dtype(a),
                                                device=a.device), g)
        g_acc = _tmap(lambda a, b: a + w * b.to(a.dtype), g_acc, g)
        l_acc = l_acc + w * loss
        w_acc = w_acc + w
    # an all-masked batch: weight 0 everywhere gives zeros, not NaN
    w_tot = torch.clamp(torch.as_tensor(w_acc, dtype=torch.float32),
                        min=1e-8) if torch.is_tensor(w_acc) \
        else max(float(w_acc), 1e-8)
    return l_acc / w_tot, _tmap(lambda g: g / w_tot, g_acc), state


def label_count_weight(lm):
    """The standard weight: the unmasked label count, or None (equal
    weights) when there is no label mask."""
    if lm is None:
        return None
    return torch.sum(lm.to(torch.float32))


def multi_output_weight(xs, ys, fms, lms):
    """The graph engine's weight: the combined unmasked count over ALL
    outputs, an unmasked output counting every example, so a microbatch
    with real data in ANY output keeps a nonzero weight (taking one
    output's count could drop another output's rows). None when no output
    is masked."""
    if all(lm is None for lm in lms):
        return None
    total = torch.zeros((), dtype=torch.float32, device=ys[0].device)
    for y, lm in zip(ys, lms):
        total = total + (float(y.shape[0]) if lm is None
                         else torch.sum(lm.to(torch.float32)))
    return total
