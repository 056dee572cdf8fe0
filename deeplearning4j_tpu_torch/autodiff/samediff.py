"""SameDiff: the define-then-run graph, served and trained eagerly on the
device.

Port of ``deeplearning4j_tpu/autodiff/samediff.py`` (the graph container,
its variables, op records, control flow, inference, training, evaluation,
the memory report and serde). A graph records catalog ops
(``deeplearning4j_tpu_torch.ops``) by the JAX package's names; the
``graph.json`` (format version 2) and the ZIP of ``graph.json``,
``value_names.json`` and ``values.npz`` are the JAX package's, so a graph
saved by either package loads in the other.

Execution: :meth:`SameDiff.output` runs the recorded ops eagerly, in
recording order, under the precision policy (``environment.precision``)
and without autograd, with every value on the SameDiff's device; it
returns numpy arrays, as the JAX package does. Where the JAX package hands
the whole program to ``jax.jit`` (whose compiler drops ops the targets do
not need), the port runs only the ops the targets need.

Control flow (:meth:`cond`, :meth:`while_loop`, :meth:`scan`) records
traced subgraphs as the JAX package does and runs them eagerly where JAX
lowers them to ``lax.cond``/``lax.while_loop``/``lax.scan``: a ``cond``
reads its predicate on the host, and a ``while_loop`` its condition at
every turn (each read one sync, counted in ``host_syncs``); ``while_loop``
and ``scan`` are Python loops over the recorded sub-op lists, a ``scan``
stacking its per-step outputs. Gradients flow through ``cond`` (the taken
branch) and ``scan``; one through a ``while_loop`` raises, as JAX's
reverse mode does.

Training: :meth:`SameDiff.grad` runs the ops the loss needs eagerly under
``torch.enable_grad()`` and the precision policy, with leaf copies of the
VARIABLEs, and returns numpy gradients by name. :meth:`SameDiff.fit` is
the JAX package's fit step, taken one step at a time: the loss plus the
l1/l2 terms of :meth:`set_training_config`, its gradient, the clip
pipeline of ``nn/gradnorm.py`` (per VARIABLE where a mode says per
layer), the divergence sentinel's verdict (one host sync per step; a
non-finite step is skipped and counted), then the updater over the
name-keyed tree. Each ``fit`` call starts the updater state afresh, as
the JAX package's does; ``iteration`` and ``epoch`` run on across calls.
Listeners get ``iteration_done`` and ``on_epoch_end``.

- **The 16-bit policy** (:meth:`set_dtype` ``"BFLOAT16"``/``"HALF"``)
  acts on ``fit`` only: the VARIABLEs stay f32 masters, the updater
  state f32, and the graph runs in the compute dtype, matmuls included.
  The step carries compute copies of the masters (cast once a ``fit``
  call; the non-trainable values and the feeds' floats are cast too),
  differentiates them, upcasts their gradients exactly to f32, and the
  fused master-cast updater (``updaters.apply_leafwise_cast``) writes
  the next copy beside each master; l1/l2 terms read the f32 masters.
  Its routing is counted once a step build in
  ``fused_epilogues.updater_counters()``, as the nn engines count it.
  ``output`` and ``grad`` stay in the recorded dtypes.
- **Remat** (:meth:`set_workspace_mode`, ``nn/memory.py``'s modes): the
  loss's ops run in the segments of ``autodiff/remat.py``, each under
  ``torch.utils.checkpoint``; a recomputed segment's kernels run (and
  are counted) again in the backward.
- :meth:`memory_report` measures one forward and backward of the fit
  loss as ``nn/memory.py`` does (residual bytes by
  ``saved_tensors_hooks`` and each checkpointed segment's inputs, the
  card's peak); the compiled fields are None.

Divergence: ``fit`` has no fault-injection sites (the JAX package trips
``train.step`` and ``train.nonfinite`` there; ``runtime/faults.py`` is not
ported: ROADMAP Queue 1 item 9).

The constructor, :meth:`SameDiff.load` and :meth:`SameDiff.from_json` put
values on ``cuda`` unless the caller passes ``device="cpu"``, and raise
without a CUDA device.
"""

from __future__ import annotations

import json
import zipfile
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import environment as _env
from .. import ops as _catalog
from ..nn import gradnorm as _gn
from ..runtime import sentinel as _sent
from ..utils.convert import tensor_from_numpy

VARIABLE = "VARIABLE"
PLACEHOLDER = "PLACEHOLDER"
CONSTANT = "CONSTANT"
ARRAY = "ARRAY"


class _WhileGrad(torch.autograd.Function):
    """Passes a ``while_loop``'s outputs through and refuses their
    gradient, as JAX's reverse mode does for ``lax.while_loop``."""

    @staticmethod
    def forward(ctx, *outs):
        return tuple(o.clone() for o in outs)

    @staticmethod
    def backward(ctx, *grads):
        raise ValueError(
            "Reverse-mode differentiation does not work for a SameDiff "
            "while_loop (lax.while_loop's rule): use scan for a "
            "differentiable loop")


class SDVariable:
    """Symbolic handle into a SameDiff graph (nd4j ``SDVariable``)."""

    def __init__(self, sd: "SameDiff", name: str, kind: str,
                 shape: Optional[Tuple[int, ...]] = None):
        self.sd = sd
        self.name = name
        self.kind = kind
        self.shape = tuple(shape) if shape is not None else None

    # ---- operator sugar (each records a graph op) --------------------------
    def _bin(self, op, other, swap=False):
        other = self.sd._lift(other)
        a, b = (other, self) if swap else (self, other)
        return self.sd.call(op, a, b)

    def __add__(self, o):
        return self._bin("math.add", o)

    def __radd__(self, o):
        return self._bin("math.add", o, swap=True)

    def __sub__(self, o):
        return self._bin("math.sub", o)

    def __rsub__(self, o):
        return self._bin("math.sub", o, swap=True)

    def __mul__(self, o):
        return self._bin("math.mul", o)

    def __rmul__(self, o):
        return self._bin("math.mul", o, swap=True)

    def __truediv__(self, o):
        return self._bin("math.div", o)

    def __rtruediv__(self, o):
        return self._bin("math.div", o, swap=True)

    def __pow__(self, o):
        return self._bin("math.pow", o)

    def __neg__(self):
        return self.sd.call("math.neg", self)

    def __matmul__(self, o):
        return self._bin("linalg.mmul", o)

    # ---- common graph methods ------------------------------------------------
    def mmul(self, other, **kw):
        return self.sd.call("linalg.mmul", self, self.sd._lift(other), **kw)

    def add(self, other):
        return self.__add__(other)

    def sub(self, other):
        return self.__sub__(other)

    def mul(self, other):
        return self.__mul__(other)

    def div(self, other):
        return self.__truediv__(other)

    def reshape(self, *shape):
        return self.sd.call("shape.reshape", self, attrs={"shape": list(shape)})

    def transpose(self, *axes):
        return self.sd.call("shape.transpose", self,
                            attrs={"axes": list(axes)} if axes else {})

    def sum(self, axis=None, keepdims=False):
        return self.sd.call("reduce.sum", self,
                            attrs={"axis": axis, "keepdims": keepdims})

    def mean(self, axis=None, keepdims=False):
        return self.sd.call("reduce.mean", self,
                            attrs={"axis": axis, "keepdims": keepdims})

    def max(self, axis=None, keepdims=False):
        return self.sd.call("reduce.max", self,
                            attrs={"axis": axis, "keepdims": keepdims})

    def std(self, axis=None, keepdims=False):
        return self.sd.call("reduce.std", self,
                            attrs={"axis": axis, "keepdims": keepdims})

    def eval(self, feeds: Optional[Dict[str, Any]] = None):
        """Evaluate just this variable."""
        return self.sd.output(feeds or {}, [self.name])[self.name]


class _OpRecord:
    """One recorded op application; ``outputs`` is a list (multi-output
    ops bind each element of the returned tuple to its own name).
    Control-flow records carry their subgraphs in ``attrs``."""
    __slots__ = ("op", "inputs", "outputs", "attrs")

    def __init__(self, op: str, inputs: List[str], outputs,
                 attrs: Dict[str, Any]):
        self.op = op
        self.inputs = inputs
        self.outputs = [outputs] if isinstance(outputs, str) else list(outputs)
        self.attrs = attrs

    @property
    def output(self) -> str:
        return self.outputs[0]

    def referenced(self) -> List[str]:
        """All graph names this record reads: its inputs plus, for control
        flow, everything its subgraphs read."""
        names = list(self.inputs)
        for key in ("true", "false", "cond", "body"):
            sub = self.attrs.get(key)
            if isinstance(sub, _Subgraph):
                for rec in sub.ops:
                    names.extend(rec.referenced())
        return names


class _Subgraph:
    """A traced control-flow sub-program: formal parameters, results and
    its op list."""
    __slots__ = ("params", "results", "ops")

    def __init__(self, params: List[str], results: List[str],
                 ops: List[_OpRecord]):
        self.params = list(params)
        self.results = list(results)
        self.ops = list(ops)

    def to_dict(self):
        return {"params": self.params, "results": self.results,
                "ops": [_op_to_dict(r) for r in self.ops]}

    @staticmethod
    def from_dict(d):
        return _Subgraph(d["params"], d["results"],
                         [_op_from_dict(od) for od in d["ops"]])


def _as_tensor(value, device) -> torch.Tensor:
    """A value as a tensor on ``device`` with the JAX package's dtype
    rules without x64: float64 becomes float32 and int64 int32, as
    ``jnp.asarray`` makes them."""
    if isinstance(value, torch.Tensor):
        t = value.to(device)
    else:
        t = tensor_from_numpy(np.asarray(value), device)
    if t.dtype == torch.float64:
        t = t.float()
    elif t.dtype == torch.int64:
        t = t.to(torch.int32)
    return t


class SameDiff:
    """The graph container and its inference session (nd4j ``SameDiff``)."""

    def __init__(self, device=None):
        self.device = _env.resolve_device(device)
        self._vars: Dict[str, SDVariable] = {}
        self._values: Dict[str, torch.Tensor] = {}   # VARIABLE + CONSTANT
        self._ops: List[_OpRecord] = []              # creation order == topo
        self._counter = 0
        self.updater = None
        self.loss_name: Optional[str] = None
        self.train_config: Dict[str, Any] = {}
        self.dtype = "FLOAT"
        self.workspace_mode = "none"
        self._listeners: List[Any] = []
        self.iteration = 0
        self.epoch = 0
        self._score = float("nan")
        self._sentinel = _sent.Sentinel()
        #: predicates and loop conditions read on the host (cond, while)
        self.host_syncs = 0
        self._last_fit_spec = None

    @staticmethod
    def create(device=None) -> "SameDiff":
        return SameDiff(device)

    # listener-facing Model protocol
    def score(self) -> float:
        """The loss of the last ``fit`` step."""
        return self._score

    def set_listeners(self, *listeners) -> "SameDiff":
        self._listeners = list(listeners)
        return self

    def add_listener(self, listener) -> "SameDiff":
        self._listeners.append(listener)
        return self

    def resilience_counters(self) -> dict:
        """The divergence sentinel's counters: skipped steps in total and
        in a row, clip events."""
        return self._sentinel.to_host()

    def reset_resilience_counters(self) -> "SameDiff":
        self._sentinel = _sent.Sentinel()
        return self

    # ------------------------------------------------------------ variables
    def _fresh(self, base: str) -> str:
        self._counter += 1
        name = f"{base}_{self._counter}"
        while name in self._vars:
            self._counter += 1
            name = f"{base}_{self._counter}"
        return name

    def _register(self, name, kind, shape=None) -> SDVariable:
        if name in self._vars:
            raise ValueError(f"variable {name!r} already exists")
        v = SDVariable(self, name, kind, shape)
        self._vars[name] = v
        return v

    def placeholder(self, name: str, shape=None, dtype=None) -> SDVariable:
        return self._register(name, PLACEHOLDER, shape)

    def var(self, name: str, value) -> SDVariable:
        """Trainable VARIABLE with an initial value."""
        t = _as_tensor(value, self.device)
        v = self._register(name, VARIABLE, t.shape)
        self._values[name] = t
        return v

    def constant(self, name: str, value) -> SDVariable:
        t = _as_tensor(value, self.device)
        v = self._register(name, CONSTANT, t.shape)
        self._values[name] = t
        return v

    def _lift(self, value) -> SDVariable:
        """Lift a python/numpy scalar or array into a CONSTANT."""
        if isinstance(value, SDVariable):
            return value
        return self.constant(self._fresh("const"), value)

    # ----------------------------------------------------------------- ops
    def call(self, op_name: str, *inputs: SDVariable,
             name: Optional[str] = None,
             attrs: Optional[Dict[str, Any]] = None,
             **kw_attrs) -> SDVariable:
        """Record a catalog op application; returns the output SDVariable."""
        if _catalog.lookup(op_name) is None:
            raise ValueError(f"unknown op {op_name!r} (not in the catalog)")
        attrs = dict(attrs or {})
        attrs.update(kw_attrs)
        for v in inputs:
            if v.name not in self._vars:
                raise ValueError(f"input {v.name!r} is not in this graph")
        out = name or self._fresh(op_name.split(".")[-1])
        v = self._register(out, ARRAY)
        self._ops.append(_OpRecord(op_name, [i.name for i in inputs], out,
                                   attrs))
        return v

    def call_multi(self, op_name: str, *inputs: SDVariable, n_outputs: int,
                   name=None, attrs: Optional[Dict[str, Any]] = None,
                   **kw_attrs) -> Tuple[SDVariable, ...]:
        """Record a MULTI-OUTPUT catalog op. ``name`` is a base string
        (outputs ``<base>``, ``<base>__k``) or ``n_outputs`` explicit names
        (None entries get generated names)."""
        if _catalog.lookup(op_name) is None:
            raise ValueError(f"unknown op {op_name!r} (not in the catalog)")
        if n_outputs < 1:
            raise ValueError("n_outputs must be >= 1")
        attrs = dict(attrs or {})
        attrs.update(kw_attrs)
        for v in inputs:
            if v.name not in self._vars:
                raise ValueError(f"input {v.name!r} is not in this graph")
        if isinstance(name, (list, tuple)):
            if len(name) != n_outputs:
                raise ValueError(
                    f"{len(name)} output names for n_outputs={n_outputs}")
            outs = [n or self._fresh(op_name.split(".")[-1]) for n in name]
        else:
            base = name or self._fresh(op_name.split(".")[-1])
            outs = [base if k == 0 else f"{base}__{k}"
                    for k in range(n_outputs)]
        vs = tuple(self._register(o, ARRAY) for o in outs)
        self._ops.append(_OpRecord(op_name, [i.name for i in inputs], outs,
                                   attrs))
        return vs

    # ------------------------------------------------------------ control flow
    def _trace_subgraph(self, fn, formals: Sequence[SDVariable]):
        """Run a builder ``fn(sd, *formals)`` while recording into a fresh
        op list (constants and captured names land in the shared
        registry); it returns one SDVariable or a tuple."""
        outer_ops = self._ops
        self._ops = []
        try:
            res = fn(self, *formals)
        finally:
            sub_ops, self._ops = self._ops, outer_ops
        res_vars = list(res) if isinstance(res, (tuple, list)) else [res]
        return _Subgraph([f.name for f in formals],
                         [r.name for r in res_vars], sub_ops), res_vars

    def cond(self, pred: SDVariable, true_fn, false_fn,
             *operands: SDVariable, name: Optional[str] = None
             ) -> Tuple[SDVariable, ...]:
        """A ``lax.cond`` record (nd4j If): both branch builders get
        ``(sd, *formal_operands)`` and return matching outputs. Returns
        the output SDVariables (a tuple, even for one output)."""
        formals = [self._register(self._fresh("cond_arg"), ARRAY)
                   for _ in operands]
        sub_t, res_t = self._trace_subgraph(true_fn, formals)
        formals_f = [self._register(self._fresh("cond_arg"), ARRAY)
                     for _ in operands]
        sub_f, res_f = self._trace_subgraph(false_fn, formals_f)
        if len(res_t) != len(res_f):
            raise ValueError(
                f"cond branches return {len(res_t)} vs {len(res_f)} outputs")
        base = name or self._fresh("cond")
        outs = [base if k == 0 else f"{base}__{k}" for k in range(len(res_t))]
        vs = tuple(self._register(o, ARRAY) for o in outs)
        self._ops.append(_OpRecord(
            "__cond__", [pred.name] + [o.name for o in operands], outs,
            {"true": sub_t, "false": sub_f}))
        return vs

    def while_loop(self, cond_fn, body_fn, *loop_vars: SDVariable,
                   name: Optional[str] = None) -> Tuple[SDVariable, ...]:
        """A ``lax.while_loop`` record (nd4j While): ``cond_fn`` returns a
        scalar bool, ``body_fn`` the new loop variables. Not
        differentiable (JAX's rule); use :meth:`scan`."""
        formals_c = [self._register(self._fresh("while_arg"), ARRAY)
                     for _ in loop_vars]
        sub_c, res_c = self._trace_subgraph(cond_fn, formals_c)
        if len(res_c) != 1:
            raise ValueError("while_loop cond_fn must return one scalar bool")
        formals_b = [self._register(self._fresh("while_arg"), ARRAY)
                     for _ in loop_vars]
        sub_b, res_b = self._trace_subgraph(body_fn, formals_b)
        if len(res_b) != len(loop_vars):
            raise ValueError(
                f"while_loop body returns {len(res_b)} values for "
                f"{len(loop_vars)} loop vars")
        base = name or self._fresh("while")
        outs = [base if k == 0 else f"{base}__{k}"
                for k in range(len(loop_vars))]
        vs = tuple(self._register(o, ARRAY) for o in outs)
        self._ops.append(_OpRecord("__while__", [o.name for o in loop_vars],
                                   outs, {"cond": sub_c, "body": sub_b}))
        return vs

    def scan(self, body_fn, carry: Sequence[SDVariable],
             xs: Sequence[SDVariable], name: Optional[str] = None
             ) -> Tuple[Tuple[SDVariable, ...], Tuple[SDVariable, ...]]:
        """A ``lax.scan`` record: ``body_fn(sd, *carry, *x_slices)``
        returns ``(*new_carry, *y_slices)``, ``xs`` scanned over their
        leading axis. Returns ``(final_carry, stacked_ys)``;
        differentiable."""
        carry, xs = list(carry), list(xs)
        formals = [self._register(self._fresh("scan_arg"), ARRAY)
                   for _ in range(len(carry) + len(xs))]
        sub, res = self._trace_subgraph(body_fn, formals)
        n_carry = len(carry)
        n_ys = len(res) - n_carry
        if n_ys < 0:
            raise ValueError("scan body must return at least the new carry")
        base = name or self._fresh("scan")
        outs = [base if k == 0 else f"{base}__{k}"
                for k in range(n_carry + n_ys)]
        vs = tuple(self._register(o, ARRAY) for o in outs)
        self._ops.append(_OpRecord(
            "__scan__", [c.name for c in carry] + [x.name for x in xs], outs,
            {"body": sub, "n_carry": n_carry}))
        return vs[:n_carry], vs[n_carry:]

    # nd4j namespace sugar
    def relu(self, x, name=None):
        return self.call("act.relu", x, name=name)

    def sigmoid(self, x, name=None):
        return self.call("act.sigmoid", x, name=name)

    def tanh(self, x, name=None):
        return self.call("act.tanh", x, name=name)

    def softmax(self, x, name=None):
        return self.call("act.softmax", x, name=name)

    def mmul(self, a, b, name=None):
        return self.call("linalg.mmul", a, b, name=name)

    # ------------------------------------------------------------ execution
    def _exec_ops(self, ops: List[_OpRecord], env: Dict[str, torch.Tensor]):
        """Execute a recorded op list into ``env`` (the recursion point of
        control flow)."""
        for rec in ops:
            if rec.op == "__cond__":
                res = self._run_cond(rec, env)
            elif rec.op == "__while__":
                res = self._run_while(rec, env)
            elif rec.op == "__scan__":
                res = self._run_scan(rec, env)
            else:
                fn = _catalog.get(rec.op).fn
                args = [env[i] for i in rec.inputs]
                attrs = {k: _attr_in(v) for k, v in rec.attrs.items()}
                res = fn(*args, **attrs)
            if len(rec.outputs) == 1:
                env[rec.outputs[0]] = res if not isinstance(
                    res, (tuple, list)) else res[0]
            else:
                if not isinstance(res, (tuple, list)) or \
                        len(res) != len(rec.outputs):
                    got = (len(res) if isinstance(res, (tuple, list))
                           else type(res).__name__)
                    raise ValueError(
                        f"op {rec.op!r} bound to {len(rec.outputs)} outputs "
                        f"but returned {got}")
                for o, r in zip(rec.outputs, res):
                    env[o] = r

    def _subgraph_fn(self, sub: _Subgraph, parent_env):
        """A callable over a tuple of operand values. The subgraph's
        environment starts from a snapshot of the parent's, so captured
        names (constants, variables, earlier results) resolve."""
        captured = dict(parent_env)

        def run(operand_vals):
            env = dict(captured)
            env.update(zip(sub.params, operand_vals))
            self._exec_ops(sub.ops, env)
            return tuple(env[r] for r in sub.results)
        return run

    def _host_bool(self, t) -> bool:
        """A predicate read on the host: one sync, counted."""
        self.host_syncs += 1
        return bool(torch.as_tensor(t).to(torch.bool).reshape(()).item())

    def _run_cond(self, rec: _OpRecord, env):
        operands = tuple(env[i] for i in rec.inputs[1:])
        branch = rec.attrs["true"] if self._host_bool(env[rec.inputs[0]]) \
            else rec.attrs["false"]
        return self._subgraph_fn(branch, env)(operands)

    def _run_while(self, rec: _OpRecord, env):
        vals = tuple(env[i] for i in rec.inputs)
        cf = self._subgraph_fn(rec.attrs["cond"], env)
        bf = self._subgraph_fn(rec.attrs["body"], env)
        while self._host_bool(cf(vals)[0]):
            vals = bf(vals)
        if torch.is_grad_enabled() and any(
                isinstance(v, torch.Tensor) and v.requires_grad
                for v in vals):
            vals = _WhileGrad.apply(*vals)
        return vals

    def _run_scan(self, rec: _OpRecord, env):
        n_carry = int(rec.attrs["n_carry"])
        carry = tuple(env[i] for i in rec.inputs[:n_carry])
        xs = tuple(env[i] for i in rec.inputs[n_carry:])
        bf = self._subgraph_fn(rec.attrs["body"], env)
        length = int(xs[0].shape[0]) if xs else 0
        ys = []
        for i in range(length):
            out = bf(carry + tuple(x[i] for x in xs))
            carry, y = tuple(out[:n_carry]), out[n_carry:]
            ys.append(y)
        if ys:
            stacked = tuple(torch.stack(parts) for parts in zip(*ys))
        else:  # no steps: the per-step outputs' shapes from a dry run
            with torch.no_grad():
                dry = bf(carry + tuple(x.new_zeros(x.shape[1:])
                                       for x in xs))[n_carry:]
            stacked = tuple(y.new_zeros((0,) + tuple(y.shape)) for y in dry)
        return carry + stacked

    def _needed(self, targets) -> Tuple[List[_OpRecord], set]:
        """The records the targets depend on, in recording order, and the
        placeholders they read (backward reachability)."""
        producers = {o: r for r in self._ops for o in r.outputs}
        recs, seen, stack = {}, set(), list(targets)
        while stack:
            n = stack.pop()
            if n in seen:
                continue
            seen.add(n)
            rec = producers.get(n)
            if rec is not None and id(rec) not in recs:
                recs[id(rec)] = rec
                stack.extend(rec.referenced())
        placeholders = {n for n in seen if n in self._vars
                        and self._vars[n].kind == PLACEHOLDER}
        return [r for r in self._ops if id(r) in recs], placeholders

    def output(self, feeds: Dict[str, Any],
               targets: Sequence[str]) -> Dict[str, np.ndarray]:
        """Evaluate target variables under the given placeholder feeds;
        returns numpy arrays."""
        return {t: _to_numpy(v) for t, v in self._run(feeds, targets).items()}

    def _run(self, feeds: Dict[str, Any],
             targets: Sequence[str]) -> Dict[str, torch.Tensor]:
        """:meth:`output` without the host copy: the targets as tensors on
        the SameDiff's device (the decode graphs thread their caches
        through it, ``autodiff/decode.py``)."""
        unknown = [t for t in targets if t not in self._vars]
        if unknown:
            raise ValueError(f"unknown targets: {unknown}")
        ops, needed = self._needed(targets)
        env = self._feed_env(feeds, needed)
        with torch.no_grad(), _env.precision(self.device):
            self._exec_ops(ops, env)
        return {t: env[t] for t in targets}

    # ------------------------------------------------------------- training
    def set_loss(self, loss: SDVariable) -> "SameDiff":
        self.loss_name = loss.name
        return self

    def set_updater(self, updater) -> "SameDiff":
        self.updater = updater
        return self

    def set_dtype(self, dtype) -> "SameDiff":
        """The training dtype policy, the nn engines' ``dtype``: under a
        16-bit policy ``fit`` keeps f32 masters and updater state and runs
        the graph in the compute dtype (module docstring); ``output`` and
        ``grad`` stay in the recorded dtypes."""
        from .. import dtypes as _dt
        _dt.resolve(dtype)  # validate early
        self.dtype = dtype
        return self

    def set_workspace_mode(self, mode) -> "SameDiff":
        """The activation-checkpoint policy of ``fit`` (``nn/memory.py``'s
        modes): the op list is segmented at attention anchors
        (``autodiff/remat.py``) and each segment is recomputed in the
        backward. ``output`` and ``grad`` never rematerialize."""
        from ..nn import memory as _memory
        self.workspace_mode = _memory.resolve_policy(mode).name
        return self

    def set_training_config(self, updater=None, l1: float = 0.0,
                            l2: float = 0.0,
                            gradient_clip_value: Optional[float] = None,
                            gradient_clip_l2: Optional[float] = None,
                            gradient_normalization: Optional[str] = None,
                            gradient_normalization_threshold: float = 1.0
                            ) -> "SameDiff":
        """nd4j ``TrainingConfig``: the updater, l1/l2 over the VARIABLEs,
        gradient clipping and normalization, applied in every ``fit`` step.
        A normalization mode "per layer" acts per VARIABLE (a SameDiff has
        no layers), as in the JAX package."""
        _gn.validate(gradient_normalization)
        if updater is not None:
            self.updater = updater
        self.train_config = {
            "l1": float(l1), "l2": float(l2),
            "clip_value": gradient_clip_value,
            "clip_l2": gradient_clip_l2,
            "grad_norm": gradient_normalization,
            "grad_norm_threshold": float(gradient_normalization_threshold),
        }
        return self

    def _feed_env(self, feeds, needed, values=None):
        """The environment of a run: the stored values (or ``values``) and
        the feeds the needed ops read, on the device."""
        missing = sorted(needed - set(feeds))
        if missing:
            raise ValueError(f"missing placeholder feeds: {missing}")
        env: Dict[str, torch.Tensor] = dict(
            self._values if values is None else values)
        env.update({k: _as_tensor(v, self.device) for k, v in feeds.items()
                    if k in needed})
        return env

    def _fit_loss(self, env, ops, penalty_leaves, remat: bool):
        """The training loss over ``env``: the loss's ops (in remat
        segments under the workspace mode when ``remat``), cast to f32
        under a 16-bit policy, plus the l1/l2 terms over
        ``penalty_leaves``."""
        from .. import dtypes as _dt
        from ..nn import memory as _memory
        policy = _memory.resolve_policy(self.workspace_mode)
        if remat and policy.remat:
            from . import remat as _remat
            _remat.compute_with_remat(self, env, (self.loss_name,), policy,
                                      needed={id(r) for r in ops})
        else:
            self._exec_ops(ops, env)
        total = env[self.loss_name]
        if _dt.is_mixed(self.dtype):  # the penalties and score in f32
            total = total.float()
        tc = self.train_config
        if tc.get("l1"):
            total = total + tc["l1"] * sum(
                torch.sum(torch.abs(t)) for t in penalty_leaves.values())
        if tc.get("l2"):
            total = total + 0.5 * tc["l2"] * sum(
                torch.sum(torch.square(t)) for t in penalty_leaves.values())
        return total

    def _value_and_grad(self, feeds, wrt: Dict[str, torch.Tensor],
                        penalty: bool, compute=None, other=None,
                        remat: bool = False):
        """``(loss, {name: gradient})`` with the values ``wrt`` (by name) in
        place of the stored ones: the ops the loss needs, run eagerly with
        autograd on leaf copies of ``wrt`` under the precision policy; with
        ``penalty`` the l1/l2 terms of the training config are added over
        ``wrt``. ``compute``: the compute-dtype copies of ``wrt`` the
        forward reads instead (a 16-bit ``fit``), with ``other`` the other
        values cast alike and the feeds' floats cast to their dtype; their
        gradients come back upcast to ``wrt``'s dtype and summed with the
        penalties'. A value the loss does not reach gets a zero
        gradient."""
        from .. import dtypes as _dt
        if self.loss_name is None:
            raise ValueError("set_loss(...) first")
        ops, needed = self._needed([self.loss_name])
        env = self._feed_env(feeds, needed, None if other is None
                             else {**other, **wrt})
        leaves = {n: t.detach().requires_grad_(True) for n, t in wrt.items()}
        fwd = leaves
        if compute is not None:
            cdt = _dt.resolve(self.dtype)
            env.update(_dt.cast_floating(
                {k: env[k] for k in feeds if k in needed}, cdt))
            fwd = {n: t.detach().requires_grad_(True)
                   for n, t in compute.items()}
        env.update(fwd)
        with torch.enable_grad(), _env.precision(self.device):
            total = self._fit_loss(env, ops, leaves if penalty else {}, remat)
            params = list(leaves.values())
            if fwd is not leaves:
                params += list(fwd.values())
            found = torch.autograd.grad(total, params, allow_unused=True)
        grads = {}
        for i, (n, t) in enumerate(leaves.items()):
            g = found[i]
            if fwd is not leaves:
                gc = found[len(leaves) + i]
                if gc is not None:
                    gc = gc.to(t.dtype)  # the cast's transpose: exact
                    g = gc if g is None else g + gc
            grads[n] = torch.zeros_like(t) if g is None else g
        return total.detach(), grads

    def grad(self, feeds: Dict[str, Any],
             wrt: Optional[Sequence[str]] = None) -> Dict[str, np.ndarray]:
        """Gradients of the loss with respect to ``wrt`` (every VARIABLE by
        default), as numpy arrays keyed by name."""
        wrt = {n: self._values[n] for n in (wrt or self.variables())}
        _, grads = self._value_and_grad(feeds, wrt, penalty=False)
        return {n: _to_numpy(g) for n, g in grads.items()}

    # ----------------------------------------------- the fit step's build
    def fused_updater_active(self) -> bool:
        """Does ``fit`` take the fused master-cast updater? Under a 16-bit
        policy, always: the SameDiff step differentiates the penalties
        against the masters itself, so l1/l2 never forces the unfused
        split (the JAX package's rule)."""
        from ..ops import fused_epilogues as _fe
        return _fe.route_updater(self.dtype) is None

    def _fit_spec(self) -> tuple:
        """What a fit step is built from: a change of any of it counts a
        new routing decision (the JAX package's retrace)."""
        return ("fit", self.loss_name,
                json.dumps(self.updater.to_dict(), sort_keys=True,
                           default=str),
                json.dumps(self.train_config, sort_keys=True, default=str),
                str(self.dtype), str(self.workspace_mode),
                str(_env.Environment.instance().f32_matmul_precision),
                tuple(self.variables()), self.fused_updater_active())

    def _fit_step_build(self) -> None:
        """Count the updater's routing once a step build: when the spec
        changed since the last build (the JAX package counts at each
        compile of the fit step)."""
        from ..ops import fused_epilogues as _fe
        spec = self._fit_spec()
        if spec != self._last_fit_spec:
            _fe.dispatch_updater(self.dtype)
            self._last_fit_spec = spec

    def _cast_other_vals(self, other):
        """The non-trainable values in the compute dtype, cast once a
        ``fit`` call under a 16-bit policy (identity otherwise)."""
        from .. import dtypes as _dt
        if not _dt.is_mixed(self.dtype):
            return other
        return _dt.cast_floating(other, _dt.resolve(self.dtype))

    def _fit_carry(self, train):
        """The step's carry for the masters ``train``: ``(masters,
        compute copies)`` when the fused updater is active (the one cast
        a ``fit`` call), else the bare masters."""
        if not self.fused_updater_active():
            return train
        from .. import dtypes as _dt
        return train, _dt.cast_floating(train, _dt.resolve(self.dtype))

    @staticmethod
    def _carry_masters(carry):
        """The f32 masters of a step carry (either form)."""
        return carry[0] if isinstance(carry, tuple) else carry

    def _fit_step(self, carry, opt_state, other, feeds):
        """One training step: ``(loss, new carry, new updater state)``; a
        step the sentinel refuses returns the carry and state it got."""
        from .. import dtypes as _dt
        from ..nn import updaters as _upd
        tc = self.train_config
        fused = isinstance(carry, tuple)
        train, copies = carry if fused else (carry, None)
        loss, grads = self._value_and_grad(
            feeds, train, penalty=True, compute=copies, other=other,
            remat=True)
        with torch.no_grad(), _env.precision(self.device):
            # the engines' clip pipeline with each VARIABLE as its own layer
            wrapped, events = _gn.clip_with_events(
                tc.get("grad_norm"), tc.get("grad_norm_threshold", 1.0),
                tc.get("clip_value"), tc.get("clip_l2"),
                {n: {"g": g} for n, g in grads.items()})
            grads = {n: w["g"] for n, w in wrapped.items()}
            if self._sentinel.verdict(loss, grads, events):
                if fused:
                    train, copies, opt_state = _upd.apply_leafwise_cast(
                        self.updater, grads, opt_state, train,
                        self.iteration, _dt.resolve(self.dtype))
                    carry = (train, copies)
                else:
                    delta, opt_state = self.updater.apply(
                        grads, opt_state, train, self.iteration)
                    carry = {n: p - delta[n] for n, p in train.items()}
        return loss, carry, opt_state

    def fit(self, feeds_iter, epochs: int = 1,
            listeners: Optional[List] = None) -> "History":
        """Minibatch training over a feed dict or an iterable of them, for
        ``epochs`` passes; returns a :class:`History`. ``listeners`` (and
        those of :meth:`set_listeners`) get ``iteration_done(sd, iteration,
        epoch)`` after each step and ``on_epoch_end(sd)`` after each
        pass."""
        if self.loss_name is None or self.updater is None:
            raise ValueError("set_loss(...) and set_updater(...) first")
        feeds_list = [feeds_iter] if isinstance(feeds_iter, dict) \
            else list(feeds_iter)
        self._fit_step_build()
        names = self.variables()
        carry = self._fit_carry({n: self._values[n] for n in names})
        other = self._cast_other_vals({n: v for n, v in self._values.items()
                                       if n not in names})
        opt_state = self.updater.init_state(self._carry_masters(carry))
        cbs = list(self._listeners) + list(listeners or [])
        history = History()
        for _ in range(epochs):
            epoch_losses = []
            for feeds in feeds_list:
                loss, carry, opt_state = self._fit_step(carry, opt_state,
                                                        other, feeds)
                loss = float(loss)
                history.losses.append(loss)
                epoch_losses.append(loss)
                self._score = loss
                self.iteration += 1
                if cbs:  # listeners may read or save the values
                    self._values.update(self._carry_masters(carry))
                for cb in cbs:
                    cb.iteration_done(self, self.iteration, self.epoch)
            self.epoch += 1
            history.epoch_losses.append(
                sum(epoch_losses) / max(1, len(epoch_losses)))
            if cbs:
                self._values.update(self._carry_masters(carry))
            for cb in cbs:
                cb.on_epoch_end(self)
        self._values.update(self._carry_masters(carry))
        return history

    def evaluate(self, data_iter, output_name: str, evaluation=None):
        """nd4j ``SameDiff.evaluate``: run ``output_name`` over an iterable
        of ``(feeds, labels)`` pairs and accumulate a classification
        Evaluation (labels one-hot or class indices)."""
        from ..eval.evaluation import Evaluation
        ev = evaluation or Evaluation()
        for feeds, labels in data_iter:
            out = self.output(feeds, [output_name])[output_name]
            labels = np.asarray(labels)
            if labels.ndim == out.ndim - 1:  # index labels -> one-hot
                labels = np.eye(out.shape[-1],
                                dtype=np.float32)[labels.astype(int)]
            ev.eval(labels, out)
        return ev

    # ---------------------------------------------------- memory accounting
    def memory_report(self, feeds: Dict[str, Any]) -> dict:
        """The fit step's memory for one example feed dict, measured as
        ``nn/memory.py::memory_report`` measures: one forward and backward
        of the fit loss (under the dtype policy and the workspace mode; no
        update applied, the values do not change). ``residual_bytes``,
        ``activation_bytes`` and ``residual_count`` count what autograd
        keeps for the backward (``saved_tensors_hooks``) and each
        checkpointed segment's inputs; ``peak_bytes`` is the card's peak
        above what was in use before (None on the CPU). The JAX report's
        compiled fields (``temp_bytes``, ``argument_bytes``,
        ``output_bytes``, ``alias_bytes``, ``generated_code_bytes``) are
        None: torch has no ahead-of-time compile to ask."""
        if self.loss_name is None or self.updater is None:
            raise ValueError("set_loss(...) and set_updater(...) first")
        from ..nn import memory as _memory
        names = self.variables()
        carry = self._fit_carry({n: self._values[n] for n in names})
        other = self._cast_other_vals({n: v for n, v in self._values.items()
                                       if n not in names})
        train = self._carry_masters(carry)
        copies = carry[1] if isinstance(carry, tuple) else None
        shapes = [np.shape(v) for v in feeds.values()]
        report = {
            "workspace_mode": str(self.workspace_mode),
            "batch_size": next((int(s[0]) for s in shapes if len(s)), None),
            "temp_bytes": None, "argument_bytes": None, "output_bytes": None,
            "alias_bytes": None, "generated_code_bytes": None,
            "peak_bytes": None, "residual_bytes": None,
            "activation_bytes": None, "residual_count": None,
            "device": None,
        }
        on_card = self.device.type == "cuda"
        if on_card:
            torch.cuda.synchronize(self.device)
            base = torch.cuda.memory_allocated(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)
        feeds = {k: _as_tensor(v, self.device) for k, v in feeds.items()}
        args = {**train, **other, **(copies or {}), **feeds}
        with _memory.count_residuals(args) as res:
            self._value_and_grad(feeds, train, penalty=True, compute=copies,
                                 other=other, remat=True)
        report.update(res.report())
        if on_card:
            torch.cuda.synchronize(self.device)
            report["peak_bytes"] = int(
                torch.cuda.max_memory_allocated(self.device) - base)
            report["device"] = _memory.device_memory_stats(self.device)
        return report

    # ------------------------------------------------------------ accessors
    def get_value(self, name: str) -> np.ndarray:
        return _to_numpy(self._values[name])

    def set_value(self, name: str, value) -> None:
        if self._vars[name].kind not in (VARIABLE, CONSTANT):
            raise ValueError(f"{name} has no stored value")
        self._values[name] = _as_tensor(value, self.device)

    def variables(self) -> List[str]:
        return [n for n, v in self._vars.items() if v.kind == VARIABLE]

    # ------------------------------------------------------------ serde
    def to_json(self) -> str:
        return json.dumps({
            "format_version": 2,
            "model_class": "SameDiff",
            "variables": [{"name": v.name, "kind": v.kind,
                           "shape": list(v.shape) if v.shape else None}
                          for v in self._vars.values()],
            "ops": [_op_to_dict(r) for r in self._ops],
            "loss": self.loss_name,
            "updater": self.updater.to_dict() if self.updater else None,
            "training_config": self.train_config or None,
            "workspace_mode": self.workspace_mode,
        }, indent=2)

    @staticmethod
    def from_json(s: str, device=None) -> "SameDiff":
        """The graph of a ``graph.json`` (values not included), on
        ``device``."""
        from ..nn import updaters as _upd
        d = json.loads(s)
        sd = SameDiff(device)
        for vd in d["variables"]:
            if vd["name"] in sd._vars:
                continue
            sd._register(vd["name"], vd["kind"],
                         tuple(vd["shape"]) if vd.get("shape") else None)
        for od in d["ops"]:
            sd._ops.append(_op_from_dict(od))
        sd.loss_name = d.get("loss")
        if d.get("updater"):
            sd.updater = _upd.Updater.from_dict(d["updater"])
        sd.train_config = d.get("training_config") or {}
        sd.workspace_mode = d.get("workspace_mode", "none")
        return sd

    def save(self, path: str) -> None:
        """graph.json + value_names.json + values.npz in a ZIP. Values are
        stored under positional npz keys with a JSON name table (graph names
        are flat and full of slashes)."""
        from ..utils.serializer import _tree_to_npz_bytes
        names = list(self._values.keys())
        with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as zf:
            zf.writestr("graph.json", self.to_json())
            zf.writestr("value_names.json", json.dumps(names))
            zf.writestr("values.npz", _tree_to_npz_bytes(
                {f"v{i}": self._values[n] for i, n in enumerate(names)}))

    @staticmethod
    def load(path: str, device=None) -> "SameDiff":
        """A SameDiff from a ZIP written by either package, on ``device``
        (``cuda`` unless the caller asks for ``cpu``)."""
        from ..utils.serializer import _npz_bytes_to_tree
        device = _env.resolve_device(device)
        with zipfile.ZipFile(path, "r") as zf:
            sd = SameDiff.from_json(zf.read("graph.json").decode(), device)
            tree = _npz_bytes_to_tree(zf.read("values.npz"), device)
            if "value_names.json" in zf.namelist():
                names = json.loads(zf.read("value_names.json").decode())
                sd._values = {n: tree[f"v{i}"] for i, n in enumerate(names)}
            else:  # an older artifact: flat keys, no slashes in names
                sd._values = dict(tree)
        return sd


class History:
    """Training history (nd4j ``History``): the loss of every iteration and
    the mean loss of every epoch; iterable and indexable as the loss
    list."""

    def __init__(self):
        self.losses: List[float] = []
        self.epoch_losses: List[float] = []

    def loss_curve(self) -> List[float]:
        return list(self.losses)

    def __len__(self):
        return len(self.losses)

    def __iter__(self):
        return iter(self.losses)

    def __getitem__(self, i):
        return self.losses[i]


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A value as numpy; a bfloat16 tensor comes out as float32 (numpy
    has no bfloat16 without ``ml_dtypes``, which the port does not use)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def _attr_out(v):
    if isinstance(v, tuple):
        return list(v)
    if isinstance(v, _Subgraph):
        return {"__subgraph__": v.to_dict()}
    return v


def _attr_in(v):
    if isinstance(v, list):
        return tuple(v)
    return v


def _op_to_dict(r: _OpRecord) -> Dict[str, Any]:
    return {"op": r.op, "inputs": r.inputs, "outputs": list(r.outputs),
            "attrs": {k: _attr_out(v) for k, v in r.attrs.items()}}


def _op_from_dict(od: Dict[str, Any]) -> _OpRecord:
    attrs = {}
    for k, v in dict(od.get("attrs", {})).items():
        if isinstance(v, dict) and "__subgraph__" in v:
            v = _Subgraph.from_dict(v["__subgraph__"])
        attrs[k] = v
    outs = od["outputs"] if "outputs" in od else od["output"]  # v1 compat
    return _OpRecord(od["op"], list(od["inputs"]), outs, attrs)
