"""SameDiff: the define-then-run graph, served eagerly on the device.

Port of ``deeplearning4j_tpu/autodiff/samediff.py`` (the graph container,
its variables, op records, inference and serde). A graph records catalog
ops (``deeplearning4j_tpu_torch.ops``) by the JAX package's names; the
``graph.json`` (format version 2) and the ZIP of ``graph.json``,
``value_names.json`` and ``values.npz`` are the JAX package's, so a graph
saved by either package loads in the other.

Execution: :meth:`SameDiff.output` runs the recorded ops eagerly, in
recording order, under the precision policy (``environment.precision``)
and without autograd, with every value on the SameDiff's device; it
returns numpy arrays, as the JAX package does. Where the JAX package hands
the whole program to ``jax.jit`` (whose compiler drops ops the targets do
not need), the port runs only the ops the targets need.

Training: :meth:`SameDiff.grad` runs the ops the loss needs eagerly under
``torch.enable_grad()`` and the precision policy, with leaf copies of the
VARIABLEs, and returns numpy gradients by name. :meth:`SameDiff.fit` is
the JAX package's plain fit step, taken one step at a time: the loss plus
the l1/l2 terms of :meth:`set_training_config`, its gradient, the clip
pipeline of ``nn/gradnorm.py`` (per VARIABLE where a mode says per
layer), the divergence sentinel's verdict (one host sync per step; a
non-finite step is skipped and counted), then the updater over the
name-keyed tree and ``p - delta``. Each ``fit`` call starts the updater
state afresh, as the JAX package's does; ``iteration`` and ``epoch`` run
on across calls. Listeners get ``iteration_done`` and ``on_epoch_end``.
Divergence: ``fit`` has no fault-injection sites (the JAX package trips
``train.step`` and ``train.nonfinite`` there; ``runtime/faults.py`` is
not ported).

Not in this port yet, and raising ``NotImplementedError`` that names
ROADMAP Queue 1: control flow (``cond``, ``while_loop``, ``scan``; a graph
holding their records loads and saves, but does not run), ``evaluate``,
``memory_report``, the 16-bit dtype policy (``set_dtype("BFLOAT16")``)
and activation checkpointing (``set_workspace_mode``).

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

_CONTROL_FLOW = ("__cond__", "__while__", "__scan__")


def _not_ported(what: str):
    return NotImplementedError(
        f"SameDiff {what} is not in the PyTorch port yet (ROADMAP Queue 1: "
        "the port serves and trains SameDiff graphs; control flow, "
        "evaluate, memory_report, the 16-bit dtype policy and remat come "
        "in later slices)")


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
    """A traced control-flow sub-program (formal parameters, results, op
    list). The port reads and writes it; running one is not ported."""
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

    def cond(self, *args, **kwargs):
        raise _not_ported("control flow (cond)")

    def while_loop(self, *args, **kwargs):
        raise _not_ported("control flow (while_loop)")

    def scan(self, *args, **kwargs):
        raise _not_ported("control flow (scan)")

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
        """Execute a recorded op list into ``env``."""
        for rec in ops:
            if rec.op in _CONTROL_FLOW:
                raise _not_ported(f"control flow ({rec.op})")
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
        unknown = [t for t in targets if t not in self._vars]
        if unknown:
            raise ValueError(f"unknown targets: {unknown}")
        ops, needed = self._needed(targets)
        missing = sorted(needed - set(feeds))
        if missing:
            raise ValueError(f"missing placeholder feeds: {missing}")
        env: Dict[str, torch.Tensor] = dict(self._values)
        env.update({k: _as_tensor(v, self.device) for k, v in feeds.items()
                    if k in needed})
        with torch.no_grad(), _env.precision(self.device):
            self._exec_ops(ops, env)
        return {t: _to_numpy(env[t]) for t in targets}

    # ------------------------------------------------------------- training
    def set_loss(self, loss: SDVariable) -> "SameDiff":
        self.loss_name = loss.name
        return self

    def set_updater(self, updater) -> "SameDiff":
        self.updater = updater
        return self

    def set_dtype(self, dtype) -> "SameDiff":
        from .. import dtypes as _dt
        if _dt.is_mixed(dtype):
            raise _not_ported(f"dtype policy {dtype!r}")
        self.dtype = dtype
        return self

    def set_workspace_mode(self, mode) -> "SameDiff":
        if str(mode).lower() != "none":
            raise _not_ported(f"workspace_mode {mode!r}")
        self.workspace_mode = "none"
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

    def _value_and_grad(self, feeds, wrt: Dict[str, torch.Tensor],
                        penalty: bool):
        """``(loss, {name: gradient})`` with the values ``wrt`` (by name) in
        place of the stored ones: the ops the loss needs, run eagerly with
        autograd on leaf copies of ``wrt`` under the precision policy; with
        ``penalty`` the l1/l2 terms of the training config are added over
        ``wrt``. A value the loss does not reach gets a zero gradient."""
        if self.loss_name is None:
            raise ValueError("set_loss(...) first")
        ops, needed = self._needed([self.loss_name])
        missing = sorted(needed - set(feeds))
        if missing:
            raise ValueError(f"missing placeholder feeds: {missing}")
        env: Dict[str, torch.Tensor] = dict(self._values)
        env.update({k: _as_tensor(v, self.device) for k, v in feeds.items()
                    if k in needed})
        leaves = {n: t.detach().requires_grad_(True) for n, t in wrt.items()}
        env.update(leaves)
        tc = self.train_config if penalty else {}
        with torch.enable_grad(), _env.precision(self.device):
            self._exec_ops(ops, env)
            total = env[self.loss_name]
            if tc.get("l1"):
                total = total + tc["l1"] * sum(
                    torch.sum(torch.abs(t)) for t in leaves.values())
            if tc.get("l2"):
                total = total + 0.5 * tc["l2"] * sum(
                    torch.sum(torch.square(t)) for t in leaves.values())
            found = torch.autograd.grad(total, list(leaves.values()),
                                        allow_unused=True)
        grads = {n: torch.zeros_like(t) if g is None else g
                 for (n, t), g in zip(leaves.items(), found)}
        return total.detach(), grads

    def grad(self, feeds: Dict[str, Any],
             wrt: Optional[Sequence[str]] = None) -> Dict[str, np.ndarray]:
        """Gradients of the loss with respect to ``wrt`` (every VARIABLE by
        default), as numpy arrays keyed by name."""
        wrt = {n: self._values[n] for n in (wrt or self.variables())}
        _, grads = self._value_and_grad(feeds, wrt, penalty=False)
        return {n: _to_numpy(g) for n, g in grads.items()}

    def _fit_step(self, train, opt_state, feeds):
        """One training step: ``(loss, new values, new updater state)``; a
        step the sentinel refuses returns the values and state it got."""
        tc = self.train_config
        loss, grads = self._value_and_grad(feeds, train, penalty=True)
        with torch.no_grad(), _env.precision(self.device):
            # the engines' clip pipeline with each VARIABLE as its own layer
            wrapped, events = _gn.clip_with_events(
                tc.get("grad_norm"), tc.get("grad_norm_threshold", 1.0),
                tc.get("clip_value"), tc.get("clip_l2"),
                {n: {"g": g} for n, g in grads.items()})
            grads = {n: w["g"] for n, w in wrapped.items()}
            if self._sentinel.verdict(loss, grads, events):
                delta, opt_state = self.updater.apply(
                    grads, opt_state, train, self.iteration)
                train = {n: p - delta[n] for n, p in train.items()}
        return loss, train, opt_state

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
        train = {n: self._values[n] for n in self.variables()}
        opt_state = self.updater.init_state(train)
        cbs = list(self._listeners) + list(listeners or [])
        history = History()
        for _ in range(epochs):
            epoch_losses = []
            for feeds in feeds_list:
                loss, train, opt_state = self._fit_step(train, opt_state,
                                                        feeds)
                loss = float(loss)
                history.losses.append(loss)
                epoch_losses.append(loss)
                self._score = loss
                self.iteration += 1
                if cbs:  # listeners may read or save the values
                    self._values.update(train)
                for cb in cbs:
                    cb.iteration_done(self, self.iteration, self.epoch)
            self.epoch += 1
            history.epoch_losses.append(
                sum(epoch_losses) / max(1, len(epoch_losses)))
            if cbs:
                self._values.update(train)
            for cb in cbs:
                cb.on_epoch_end(self)
        self._values.update(train)
        return history

    def evaluate(self, *args, **kwargs):
        raise _not_ported("evaluate (eval/evaluation.py)")

    def memory_report(self, *args, **kwargs):
        raise _not_ported("memory_report")

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
