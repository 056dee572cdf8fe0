"""Workspace-mode rematerialization and the train step's memory report.

Port of ``deeplearning4j_tpu/nn/memory.py`` :60-140 and ``memory_report``
(:295-360), the DL4J ``WorkspaceMode``/``CacheMode`` role: a training
configuration's ``workspace_mode`` chooses which forward activations the
backward keeps and which it recomputes, block by block (a layer of a
MultiLayerNetwork, a vertex of a ComputationGraph):

- ``none``: keep everything (``""`` and None too).
- ``full``: checkpoint every block; only block boundaries are kept, the
  rest is recomputed in the backward (``enabled`` is DL4J's
  ``WorkspaceMode.ENABLED`` spelling of it).
- ``dots_saveable``: checkpoint every block but keep the outputs of
  matrix products and convolutions (a selective-checkpoint policy,
  ``torch.utils.checkpoint.create_selective_checkpoint_contexts``), so
  only the cheap elementwise tail is recomputed.
- ``every_<k>``: checkpoint segments of ``k`` consecutive blocks.

A segment runs under ``torch.utils.checkpoint.checkpoint(use_reentrant=
False)``. Its dropout draws come from the model's own ``torch.Generator``,
which ``preserve_rng_state`` does not cover: :func:`checkpoint` records
the generator's state before the segment and replays the recompute from
it (then puts the generator back), so remat on and off are bit-equal with
dropout too, the JAX contract. A recompute's BN statistics and center-loss
features are discarded: the engines commit the first forward's.

Recorded divergences from the JAX package:

- **The dispatch counters see the recompute.** JAX counts a dispatch
  decision at trace time, where remat adds nothing; the port counts each
  call, so a rematerialized step counts (and launches) each recomputed
  epilogue again: K1 runs once in the forward and once more in the
  backward for every BatchNormalization of a recomputed segment, K2
  once. Under ``full`` and ``every_<k>`` every segment holding a
  BatchNormalization is recomputed, so a ResNet-50 step makes 53 + 53
  K1 and 53 K2 launches.
- **``memory_report`` measures instead of compiling.** JAX lowers and
  compiles the step ahead of time and reads XLA's ``memory_analysis()``
  without running it. Torch has no such compile: the port runs one
  forward and backward of the training loss at the batch (its update is
  not applied, the model does not change) and reports the
  forward-to-backward residual bytes counted by
  ``torch.autograd.graph.saved_tensors_hooks`` (and each checkpointed
  segment's inputs, which the recompute keeps) on every device, and the
  peak of ``torch.cuda.max_memory_allocated`` over it on the card. The
  compiled fields (``temp_bytes``, ``argument_bytes``, ``output_bytes``,
  ``alias_bytes``, ``generated_code_bytes``) are None.
- **``max_batch`` is not ported**: it is an AOT compile search in JAX
  (no OOM probing), which torch cannot do (ROADMAP.md Queue 1 item 9).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Callable, List, Optional, Tuple

import torch


# ---------------------------------------------------------------- policies

@dataclasses.dataclass(frozen=True)
class RematPolicy:
    """A resolved workspace mode: ``remat=False`` is off; ``every`` is the
    segment size in blocks; ``saveable`` the selective-checkpoint policy
    inside a segment (None: save nothing, recompute all)."""
    name: str
    remat: bool
    every: int = 1
    saveable: Optional[Callable] = None


def _save_products(ctx, op, *args, **kwargs):
    """``dots_saveable``: keep matrix-product and convolution outputs,
    recompute the rest."""
    from torch.utils.checkpoint import CheckpointPolicy
    return CheckpointPolicy.MUST_SAVE if op in _products() \
        else CheckpointPolicy.PREFER_RECOMPUTE


@functools.lru_cache(maxsize=1)
def _products():
    a = torch.ops.aten
    return frozenset((a.mm.default, a.addmm.default, a.bmm.default,
                      a.baddbmm.default, a.convolution.default))


_FIXED = {
    "none": RematPolicy("none", remat=False),
    "full": RematPolicy("full", remat=True, every=1),
    "dots_saveable": RematPolicy("dots_saveable", remat=True, every=1,
                                 saveable=_save_products),
}

# DL4J spelling: WorkspaceMode.ENABLED
_ALIASES = {"enabled": "full"}


def workspace_modes() -> List[str]:
    """The registry's names (``every_<k>`` is the parameterized fourth
    family)."""
    return sorted(_FIXED) + ["every_<k>"]


def resolve_policy(mode) -> RematPolicy:
    """A workspace-mode string (any case; None or "" is none) as a
    :class:`RematPolicy`; raises ValueError for an unknown name."""
    if mode is None or mode == "":
        return _FIXED["none"]
    if isinstance(mode, RematPolicy):
        return mode
    name = str(mode).strip().lower()
    name = _ALIASES.get(name, name)
    if name in _FIXED:
        return _FIXED[name]
    if name.startswith("every_"):
        tail = name[len("every_"):]
        if tail.isdigit() and int(tail) >= 1:
            return RematPolicy(name, remat=True, every=int(tail))
    raise ValueError(
        f"unknown workspace_mode {mode!r} — expected one of: "
        f"{', '.join(workspace_modes())} (e.g. 'every_2'), or 'enabled' "
        "(DL4J WorkspaceMode parity alias for 'full')")


def segment_ranges(n: int, every: int) -> List[Tuple[int, int]]:
    """[(start, end), ...] covering ``range(n)`` in chunks of ``every``."""
    every = max(1, int(every))
    return [(s, min(s + every, n)) for s in range(0, n, every)]


# the residual counter of a memory_report while one runs
_counting = None


def checkpoint(fn: Callable, policy: RematPolicy,
               rng: Optional[torch.Generator] = None) -> Callable:
    """``fn`` under ``torch.utils.checkpoint.checkpoint`` with the
    policy's selective rule (``fn`` itself when the policy is off).
    ``rng``, the generator ``fn`` draws from, is replayed from its state
    at this call for the recompute and restored after it."""
    if not policy.remat:
        return fn
    start = None if rng is None else rng.get_state()
    runs = []

    def replayed(*args):
        runs.append(None)
        if start is None or len(runs) == 1:
            return fn(*args)
        now = rng.get_state()
        rng.set_state(start)
        try:
            return fn(*args)
        finally:
            rng.set_state(now)

    kw = {}
    if policy.saveable is not None:
        from torch.utils.checkpoint import \
            create_selective_checkpoint_contexts
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, policy.saveable)

    def run(*args):
        if _counting is not None:
            # the recompute keeps the segment's inputs alive, the tensors
            # nested in its dicts too (autograd saves only direct ones)
            for t in _tensors(args):
                _counting.add(t)
        return torch.utils.checkpoint.checkpoint(
            replayed, *args, use_reentrant=False, **kw)
    return run


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


# ------------------------------------------------------- residual counting

class _Residuals:
    """Distinct storages kept from forward to backward; those of the
    arguments (parameters, inputs) apart, as JAX splits ``from the
    argument`` residuals from computed ones."""

    def __init__(self, arguments):
        self.arguments = {self._key(t) for t in _tensors(arguments)}
        self.seen = {}

    @staticmethod
    def _key(t):
        return t.untyped_storage().data_ptr()

    def add(self, t):
        if t.device.type == "meta":
            return
        k = self._key(t)
        if k not in self.seen:
            self.seen[k] = t.untyped_storage().nbytes()

    def report(self) -> dict:
        act = sum(n for k, n in self.seen.items() if k not in self.arguments)
        return {"residual_bytes": sum(self.seen.values()),
                "activation_bytes": act, "residual_count": len(self.seen)}


@contextlib.contextmanager
def count_residuals(arguments):
    """Count what autograd saves for the backward inside the block, and
    the inputs of each checkpointed segment (what its recompute keeps;
    what it recomputes is not kept); yields the counter, whose
    ``report()`` gives ``residual_bytes``, ``activation_bytes`` (those not
    stored in ``arguments``) and ``residual_count``."""
    global _counting
    res = _Residuals(arguments)

    def pack(t):
        res.add(t)
        return t

    prev, _counting = _counting, res
    try:
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            yield res
    finally:
        _counting = prev


# --------------------------------------------------------- the report

def device_memory_stats(device) -> Optional[dict]:
    """The card's allocator counters (bytes in use, the peak since the last
    reset, the card's total), or None on the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return {"bytes_in_use": int(torch.cuda.memory_allocated(device)),
            "peak_bytes_in_use": int(torch.cuda.max_memory_allocated(device)),
            "bytes_limit": int(torch.cuda.get_device_properties(
                device).total_memory)}


def memory_report(model, batch_size: int, accum_steps: int = 1,
                  seq_len: Optional[int] = None) -> dict:
    """The model's training memory at ``batch_size``, measured: one forward
    and backward of its training loss (under its ``workspace_mode``; one
    microbatch of ``batch_size // accum_steps`` when ``accum_steps > 1``)
    on zero inputs, no update applied. Keys as the JAX report's; the
    compiled fields are None (module docstring)."""
    if not model.params and not model.state:
        model.init()
    report = {
        "workspace_mode": str(getattr(model.conf, "workspace_mode", "none")),
        "batch_size": int(batch_size), "accum_steps": int(accum_steps),
        "temp_bytes": None, "argument_bytes": None, "output_bytes": None,
        "alias_bytes": None, "generated_code_bytes": None,
        "peak_bytes": None, "residual_bytes": None,
        "activation_bytes": None, "residual_count": None,
        "device": None,
    }
    if batch_size % accum_steps:
        raise ValueError(f"batch size {batch_size} is not divisible by "
                         f"accum_steps={accum_steps}")
    dev = model.device
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.synchronize(dev)
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    counted = model._memory_probe(batch_size // accum_steps, seq_len)
    report.update(counted)
    if on_card:
        torch.cuda.synchronize(dev)
        report["peak_bytes"] = int(torch.cuda.max_memory_allocated(dev)
                                   - base)
        report["device"] = device_memory_stats(dev)
    return report


def probe_batch(shape, batch: int, seq_len, dtype, device):
    """A zero input of ``(batch,) + shape`` (a dynamic recurrent length
    taken from ``seq_len``)."""
    shape = tuple(int(s) for s in shape)
    if len(shape) == 2 and shape[0] <= 0:
        if not seq_len:
            raise ValueError("model has dynamic sequence length: pass "
                             "seq_len= to memory_report")
        shape = (int(seq_len), shape[1])
    dt = dtype if dtype.is_floating_point else torch.float32
    return torch.zeros((batch,) + shape, dtype=dt, device=device)
