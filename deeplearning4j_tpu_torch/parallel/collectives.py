"""The collectives of the port's parallel training, on ``torch.distributed``.

The JAX package never calls a collective: GSPMD inserts them into the one
compiled step (``data_parallel.py:10-14``). The port steps eagerly, one
process per rank, so they are explicit here, and each goes through
:class:`Comm`, which counts it.

Each op calls ``torch.distributed`` on the operands where they lie. An op
the backend does not run on that device raises, naming the backend and
the device: nothing is staged or rewritten behind the caller's back.

**The step context.** A ``ParallelWrapper`` step runs inside
:func:`step_context`; the layers, the losses and the gradient code read it
through :func:`current` (the way the JAX package's attention reads its
``tp_shard_context``):

- train-mode BatchNormalization sums ``(s1, s2, cnt)`` over the data group
  with :func:`all_reduce_sum`, whose backward is the same all-reduce;
- a loss divides its masked sum by the global label count
  (:func:`global_sum`), clamped after the reduction;
- a dense layer whose kernel holds a model-axis shard of its columns
  takes its input through :func:`model_region` (the identity; backward:
  the input gradient summed over the model group) and gathers its output
  columns with :func:`gather_columns` (backward: the own slice of the
  incoming gradient);
- ``nn/training.py`` hands the gradients to the context's ``sync`` (the
  wrapper's bucketed all-reduce or ZeRO-1 reduce-scatter).

Counters are plain integers and floats.
"""

from __future__ import annotations

import contextlib
import contextvars
import time
from typing import Optional

import torch

OPS = ("all_reduce", "reduce_scatter", "all_gather", "broadcast")

_CTX: contextvars.ContextVar = contextvars.ContextVar(
    "dl4j_torch_parallel_step", default=None)


def _dist():
    import torch.distributed as dist
    return dist


class Counters:
    """What the collectives of one wrapper did: calls and bytes by op and
    (when ``timed``) the host wall time of the collectives, each
    bracketed by device synchronizations."""

    def __init__(self):
        self.calls = {op: 0 for op in OPS}
        self.bytes = {op: 0 for op in OPS}
        self.seconds = 0.0
        self.timed = False

    def as_dict(self) -> dict:
        return {"calls": dict(self.calls), "bytes": dict(self.bytes),
                "collective_s": self.seconds}


class _Done:
    """The handle of a collective that already completed."""

    def wait(self):
        return True


class _Then:
    """An async collective and what to do once it completes."""

    def __init__(self, work, after):
        self._work, self._after = work, after

    def wait(self):
        self._work.wait()
        if self._after is not None:
            self._after()
            self._after = None
        return True


class Comm:
    """Collectives over one process group (``None``: a group of one rank,
    where every collective is the identity). ``device`` is where the
    operands live; ``counters`` is shared by the groups of one wrapper."""

    def __init__(self, group, device, counters: Optional[Counters] = None,
                 ranks=None):
        self.group = group
        self.device = torch.device(device)
        self.counters = counters if counters is not None else Counters()
        # group ranks follow the sorted global ranks (new_group sorts)
        self.ranks = sorted(ranks) if ranks is not None else [0]
        if group is None:
            self.size, self.rank = 1, 0
            self.backend = None
            return
        dist = _dist()
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.backend = str(dist.get_backend(group))

    def _run(self, op, fn, async_op):
        """Call ``fn(async_op)`` (a ``torch.distributed`` op on this
        group); a refusal is raised again naming the backend and device.
        Timed, the op runs synchronously between two device syncs."""
        async_op = async_op and not self.counters.timed
        try:
            with self._clock():
                work = fn(async_op)
        except (RuntimeError, NotImplementedError, ValueError) as e:
            raise RuntimeError(
                f"{op} on backend {self.backend} with {self.device} "
                f"tensors failed: {e}") from e
        return work if async_op and work is not None else _Done()

    def _account(self, op, nbytes):
        c = self.counters
        c.calls[op] += 1
        c.bytes[op] += int(nbytes)

    @contextlib.contextmanager
    def _clock(self):
        c = self.counters
        if not c.timed:
            yield
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        yield
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        c.seconds += time.perf_counter() - t0

    # ------------------------------------------------------------- ops
    def all_reduce(self, t: torch.Tensor, async_op: bool = False):
        """Sum ``t`` over the group, in place."""
        if self.size == 1:
            return _Done()
        self._account("all_reduce", t.numel() * t.element_size())
        return self._run("all_reduce", lambda a: _dist().all_reduce(
            t, group=self.group, async_op=a), async_op)

    def reduce_scatter(self, out: torch.Tensor, inp: torch.Tensor,
                       async_op: bool = False):
        """``out`` (1-D, ``n`` elements) gets this rank's chunk of the sum
        over the group of ``inp`` (1-D, ``size * n`` elements)."""
        if self.size == 1:
            out.copy_(inp)
            return _Done()
        self._account("reduce_scatter", inp.numel() * inp.element_size())
        return self._run("reduce_scatter", lambda a: _dist().reduce_scatter(
            out, list(inp.chunk(self.size)), group=self.group, async_op=a),
            async_op)

    def all_gather(self, out: torch.Tensor, inp: torch.Tensor,
                   async_op: bool = False):
        """``out`` (1-D, ``size * n``) gets every rank's ``inp`` (1-D,
        ``n``), in rank order."""
        if self.size == 1:
            out.copy_(inp)
            return _Done()
        self._account("all_gather", out.numel() * out.element_size())
        return self._run("all_gather", lambda a: _dist().all_gather(
            list(out.chunk(self.size)), inp, group=self.group, async_op=a),
            async_op)

    def broadcast(self, t: torch.Tensor, src: int = 0):
        """``t`` on every rank becomes group rank ``src``'s, in place."""
        if self.size == 1:
            return
        self._account("broadcast", t.numel() * t.element_size())
        self._run("broadcast", lambda a: _dist().broadcast(
            t, src=self.ranks[src], group=self.group, async_op=a), False)

    # ------------------------------------------------------- tensor forms
    def gather_dim(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's ``t`` concatenated along ``dim`` in rank order."""
        if self.size == 1:
            return t
        flat = t.contiguous().reshape(-1)
        out = torch.empty(self.size * flat.numel(), dtype=t.dtype,
                          device=t.device)
        self.all_gather(out, flat)
        parts = out.view((self.size,) + tuple(t.shape)).unbind(0)
        return torch.cat(parts, dim=dim)


class HeldShards:
    """The engines' ``params`` and ``updater_state``, as properties over
    ``_params`` and ``_updater_state``. Between ``fit`` calls a
    ``ParallelWrapper`` under ZeRO-1 or tensor parallelism leaves each
    rank's shares in them and itself in ``_holder``; the first write of
    either tree, or read of one it holds shares of, from outside its step
    gathers the full values back (``_holder.release``). That gather is a collective, so every
    rank reads the trees alike, as reading a sharded global array is on
    the JAX package's multi-host runs."""

    _holder = None

    @property
    def params(self):
        if self._holder is not None and self._holder.holds("params"):
            self._holder.release(self)
        return self._params

    @params.setter
    def params(self, value):
        if self._holder is not None:
            self._holder.release(self)
        self._params = value

    @property
    def updater_state(self):
        if self._holder is not None:
            self._holder.release(self)
        return self._updater_state

    @updater_state.setter
    def updater_state(self, value):
        if self._holder is not None:
            self._holder.release(self)
        self._updater_state = value


class StepContext:
    """What a layer, a loss and the gradient code read while a wrapper
    step runs: the data-axis and model-axis groups (``Comm``s), this
    rank's index on each, and ``sync``, the gradient synchronization of
    ``nn/training.py``'s step (None: the gradients stay local).
    ``grad_hook(path, grad)``, when set, is called by
    ``training.value_and_grad`` as each parameter's gradient is made."""

    def __init__(self, data: Comm, model: Comm, sync=None):
        self.data = data
        self.model = model
        self.sync = sync
        self.grad_hook = None

    @property
    def data_size(self) -> int:
        return self.data.size

    @property
    def data_rank(self) -> int:
        return self.data.rank

    @property
    def model_size(self) -> int:
        return self.model.size

    @property
    def model_rank(self) -> int:
        return self.model.rank


def current() -> Optional[StepContext]:
    """The step context of the running wrapper step, or None."""
    return _CTX.get()


@contextlib.contextmanager
def step_context(ctx: StepContext):
    token = _CTX.set(ctx)
    try:
        yield ctx
    finally:
        _CTX.reset(token)


def data_parallel() -> Optional[StepContext]:
    """The step context when its data axis has more than one rank."""
    ctx = _CTX.get()
    return ctx if ctx is not None and ctx.data.size > 1 else None


class _AllReduceSum(torch.autograd.Function):
    """Sum over a group; the backward sums the incoming gradients over
    the same group (every rank's loss reads the summed value)."""

    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        y = x.detach().clone()
        comm.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.detach().clone()
        ctx.comm.all_reduce(g)
        return g, None


def all_reduce_sum(x: torch.Tensor, comm: Comm) -> torch.Tensor:
    """Differentiable sum of ``x`` over ``comm``'s group."""
    if comm.size == 1:
        return x
    return _AllReduceSum.apply(x, comm)


def global_sum(x, comm: Comm):
    """The (non-differentiable) sum of a count over ``comm``'s group."""
    if comm.size == 1:
        return x
    t = torch.as_tensor(x).detach().clone().to(comm.device)
    if not t.is_floating_point():
        t = t.to(torch.float32)
    comm.all_reduce(t)
    return t


class _GatherColumns(torch.autograd.Function):
    """Every model-axis rank's output columns, concatenated along the last
    dim; the backward keeps this rank's slice of the incoming gradient
    (every model rank computes the same downstream from the gathered
    value, so the gradient of the full value is the same on each)."""

    @staticmethod
    def forward(ctx, y, comm):
        ctx.comm = comm
        ctx.width = y.shape[-1]
        return comm.gather_dim(y, y.dim() - 1)

    @staticmethod
    def backward(ctx, g):
        r, w = ctx.comm.rank, ctx.width
        return g[..., r * w:(r + 1) * w].contiguous(), None


def gather_columns(y: torch.Tensor, comm: Comm) -> torch.Tensor:
    if comm.size == 1:
        return y
    return _GatherColumns.apply(y, comm)


class _ModelRegion(torch.autograd.Function):
    """The input of a column-sharded product: the identity forward; the
    backward sums the input gradient over the model group (each rank's
    columns contribute their part of it)."""

    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.detach().clone()
        ctx.comm.all_reduce(g)
        return g, None


def model_region(x: torch.Tensor, comm: Comm) -> torch.Tensor:
    if comm.size == 1:
        return x
    return _ModelRegion.apply(x, comm)
