"""Multi-process runner of the port's parallel training: real subprocesses
joined by ``torch.distributed`` (one process per rank), for the CPU tests
and ``chip_smoke.py``.

Port of the training half of ``deeplearning4j_tpu/parallel/
multihost_sim.py``. Workers re-enter this module through ``python -m``;
every rank of a phase is one process, joined through a ``file://``
rendezvous under the output directory (no port races between concurrent
runs), with a bounded timeout on the group. A rank that fails, or that
outlives its timeout, fails the run (every rank is killed).

Phases of :func:`run_simulation` (the JAX matrix without ``hostloss``,
which comes with the resilience policy of ROADMAP.md Queue 1 item 9):

- ``timing1`` / ``timing2``: ZeRO-1 + overlap training of a small MLP on
  1 and 2 ranks, warm per-step times;
- ``train``: the 2-rank run with a ``TrainingCheckpointer`` save every 2
  iterations and at each epoch's end (rank 0 writes the manifests);
- ``restore1``: one rank (the 2 -> 1 topology change) restores
  ``train``'s checkpoint through the verified walk, must equal its final
  parameters bit for bit, and trains on.

:func:`run_smoke` is the tier-1 contract: 2 ranks, 2 steps, a clean
shutdown. :func:`run_scenarios` runs the ``scenarios`` phase: a JSON spec
of training runs (a model from a ZIP or the zoo, data from an npz, a
``ParallelWrapper`` configuration or a plain ``fit``, checkpoints,
restores), each rank writing its results, so a caller holds several
configurations against a reference with one spawn.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time
import uuid
from typing import Dict, List, Optional

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
MODULE = "deeplearning4j_tpu_torch.parallel.multihost_sim"


# --------------------------------------------------------------- worker
def _build_net(in_dim: int, seed: int = 0, device="cpu"):
    from ..nn.config import InputType, NeuralNetConfiguration
    from ..nn.layers.core import DenseLayer, OutputLayer
    from ..nn.model import MultiLayerNetwork
    from ..nn.updaters import Adam

    conf = (NeuralNetConfiguration.builder()
            .seed(seed).updater(Adam(learning_rate=1e-3))
            .input_type(InputType.feed_forward(in_dim))
            .list(DenseLayer(n_out=128, activation="tanh"),
                  DenseLayer(n_out=128, activation="relu"),
                  OutputLayer(n_out=8))
            .build())
    return MultiLayerNetwork(conf).init(device=device)


def _make_stream(global_batch: int, steps: int, in_dim: int):
    """The SAME global batch stream on every rank; a HostShardedIterator
    takes each rank's slice."""
    import numpy as np

    from ..data.dataset import NumpyDataSetIterator
    rng = np.random.default_rng(7)
    n = global_batch * steps
    x = rng.normal(size=(n, in_dim)).astype(np.float32)
    y = np.eye(8, dtype=np.float32)[rng.integers(0, 8, n)]
    return NumpyDataSetIterator(x, y, batch_size=global_batch, shuffle=False)


def _flat_params(net):
    """Every parameter as one vector, leaves in sorted path order."""
    import numpy as np

    from .placement import flatten_paths
    return np.concatenate([t.detach().float().cpu().numpy().ravel()
                           for _, t in flatten_paths(net.params)])


def _flat(tree):
    """Every leaf of a tree as one numpy vector in sorted path order (16-bit
    leaves as float32)."""
    import numpy as np
    import torch

    from .placement import flatten_paths
    leaves = [(t.float() if t.dtype in (torch.bfloat16, torch.float16)
               else t).detach().cpu().numpy().ravel()
              for _, t in flatten_paths(tree)]
    return np.concatenate(leaves) if leaves else np.zeros(0)


def _digest(*trees) -> str:
    """sha256 of the raw bytes of every leaf (bit identity across ranks)."""
    from .placement import flatten_paths
    h = hashlib.sha256()
    for tree in trees:
        for path, t in flatten_paths(tree):
            h.update("/".join(path).encode())
            h.update(t.detach().contiguous().cpu().reshape(-1).view(
                _bytes_dtype(t)).numpy().tobytes())
    return h.hexdigest()


def _bytes_dtype(t):
    import torch
    return {1: torch.uint8, 2: torch.int16, 4: torch.int32,
            8: torch.int64}[t.element_size()]


def _init_group(args):
    from . import launcher
    if args.nprocs > 1:
        launcher.initialize(args.rdv, args.nprocs, args.pid,
                            backend=args.backend, device=args.device,
                            timeout=args.group_timeout)
    elif args.backend == "nccl":
        # one rank over NCCL: the path of a user with one card
        launcher.initialize(args.rdv, 1, 0, backend="nccl",
                            device=args.device, timeout=args.group_timeout)
    return launcher


def _worker(args) -> None:
    """One phase, inside a subprocess. Writes ``result_<phase>_<pid>.json``
    (and npy/npz files) into ``--outdir`` and exits 0 on success."""
    import torch
    t_worker = time.time()
    torch.set_num_threads(args.threads)
    launcher = _init_group(args)
    assert launcher.process_count() == max(1, args.nprocs) or \
        args.backend == "nccl", "the process group did not form"
    if args.phase == "scenarios":
        result = _scenarios(args)
    else:
        result = _training_phase(args, launcher)
    result["t_worker"] = t_worker  # after the imports (wall clock)
    with open(os.path.join(args.outdir,
                           f"result_{args.phase}_{args.pid}.json"), "w") as f:
        json.dump(result, f)
    launcher.shutdown()
    print(f"phase {args.phase} pid {args.pid}: ok", flush=True)


def _training_phase(args, launcher) -> dict:
    import numpy as np

    from .checkpoint import TrainingCheckpointer
    from .data_parallel import ParallelWrapper

    in_dim, phase = 64, args.phase
    net = _build_net(in_dim, device=args.device)
    base = _make_stream(args.global_batch, args.steps, in_dim)
    it = launcher.HostShardedIterator(base)
    mesh = launcher.pod_mesh()
    pw = ParallelWrapper(net, mesh, shard_update=True, overlap_grads=True)
    result: Dict = {"phase": phase, "pid": args.pid, "nprocs": args.nprocs,
                    "mesh_shape": mesh.shape,
                    "global_batch": args.global_batch}
    if phase == "smoke":
        pw.fit(it, epochs=1)
        assert np.isfinite(float(net.score()))
        result["loss"] = float(net.score())
    elif phase in ("timing1", "timing2"):
        pw.fit(it, epochs=1)                       # warm-up
        float(net.score())
        per_step: List[float] = []
        for _ in range(args.epochs):
            for ds in base:  # a global batch: the wrapper takes the rows
                t0 = time.perf_counter()
                pw.fit(ds, epochs=1)
                float(net.score())
                per_step.append(time.perf_counter() - t0)
        result["per_step_s"] = per_step
        result["warm_step_s"] = float(np.median(per_step))
        result["overlap_buckets"] = pw.counters()["buckets"]
    elif phase == "train":
        ck = TrainingCheckpointer(os.path.join(args.outdir, "ckpt_train"))
        for _ in range(args.epochs):
            for ds in base:  # a global batch: the wrapper takes the rows
                pw.fit(ds, epochs=1)
                if net.iteration % 2 == 0:
                    ck.save(net, iterator=base)
            ck.save(net, iterator=base)
        ck.close()
        assert np.isfinite(float(net.score()))
        result["loss"] = float(net.score())
        result["iteration"] = int(net.iteration)
        np.save(os.path.join(args.outdir, f"params_{phase}_{args.pid}.npy"),
                _flat_params(net))
    elif phase == "restore1":
        ck = TrainingCheckpointer(os.path.join(args.outdir, "ckpt_train"))
        verified = ck.verified_steps()
        assert verified, "no manifest-verified steps in the 2-rank dir"
        step = ck.restore(net, iterator=base)
        assert step == max(verified), (step, verified)
        result["restored_step"] = int(step)
        result["verified_steps"] = verified
        np.save(os.path.join(args.outdir, f"params_{phase}_{args.pid}.npy"),
                _flat_params(net))
        base.reset()
        pw1 = ParallelWrapper(net, launcher.pod_mesh(), shard_update=True,
                              overlap_grads=True)
        pw1.fit(it, epochs=1)
        assert np.isfinite(float(net.score()))
        result["continued_loss"] = float(net.score())
    else:
        raise SystemExit(f"unknown phase {phase!r}")
    return result


# ------------------------------------------------------------ scenarios
def _build_model(model, precision, device):
    from .. import environment as _env
    if precision:
        _env.Environment.instance().f32_matmul_precision = precision
    if "zip" in model:
        from ..utils.serializer import load_model
        return load_model(model["zip"], device=device)
    from .. import models
    kw = dict(model.get("kwargs", {}))
    if isinstance(kw.get("updater"), dict):
        from ..nn.updaters import Updater
        kw["updater"] = Updater.from_dict(kw["updater"])
    net = getattr(models, model["zoo"])(seed=int(model.get("seed", 0)),
                                        **kw)
    net.init(device=device)
    if model.get("dtype"):
        # the same initial weights (drawn in float32) in another network
        # dtype, e.g. a float64 reference of a float32 run
        from .. import dtypes as _dt
        conf = type(net.conf).from_json(json.dumps(
            {**json.loads(net.conf.to_json()), "dtype": model["dtype"]}))
        ref = type(net)(conf).init(device=device)
        dt = _dt.param_dtype(model["dtype"])
        ref.params = _dt.cast_floating(net.params, dt)
        ref.state = _dt.cast_floating(net.state, dt)
        ref.updater_state = conf.updater.init_state(ref.params)
        net = ref
    return net


def _mesh_of(kw):
    from . import launcher
    from .data_parallel import make_dp_tp_mesh, make_mesh
    dims = kw.pop("mesh", None)
    if dims == "pod":
        return launcher.pod_mesh(**kw.pop("pod", {}))
    return make_dp_tp_mesh(*dims) if dims else make_mesh()


def _scenario_data(sc, data):
    import numpy as np
    arrays = [None if sc.get(k) is None and k in ("fm", "lm")
              else data[sc.get(k, k)] for k in ("x", "y", "fm", "lm")]
    rows = sc.get("rows")
    if rows is not None:
        arrays = [None if a is None else a[:rows] for a in arrays]
    return [None if a is None else np.asarray(a) for a in arrays]


def _one_scenario(sc, spec, args, torch, np):
    from ..data.dataset import DataSet, NumpyDataSetIterator
    from . import launcher
    from .checkpoint import TrainingCheckpointer
    from .data_parallel import ParallelWrapper
    cuda = args.device.startswith("cuda")
    if cuda:
        from ..kernels import affine_act as k1
        from ..ops import fused_epilogues as fe
    net = _build_model(sc.get("model", spec.get("model")),
                       spec.get("precision"), args.device)
    r = sc.get("restore")
    if r and "zip" in r:
        from ..utils.serializer import load_model
        net = load_model(r["zip"], device=args.device)
    elif r:
        with TrainingCheckpointer(r["dir"]) as ck:
            got = ck.restore(net, step=r.get("step"))
        if got != r.get("expect", got):
            raise AssertionError(f"restored step {got}, expected "
                                 f"{r['expect']}")
    pw = None
    if sc.get("wrapper") is not None:
        kw = dict(sc["wrapper"])
        timed = kw.pop("time_collectives", False)
        pw = ParallelWrapper(net, _mesh_of(kw), device=args.device, **kw)
        pw.time_collectives(timed)
    x, y, fm, lm = _scenario_data(sc, np.load(sc.get("data", spec["data"])))
    rec = {"losses": [], "digests": [], "step_ms": [], "launches": [],
           "held": [], "fit_calls": [],
           "decisions": [], "start_digest": _digest(net.params, net.state),
           "start_updater_digest": _digest(net.updater_state)}
    if pw is not None:
        rec["mesh_shape"] = pw.mesh.shape
        rec["mesh_devices"] = pw.mesh.devices.tolist()
    fit = pw.fit if pw is not None else net.fit
    it = sc.get("iterate")
    if it is not None:
        base = NumpyDataSetIterator(x, y, batch_size=it["batch"],
                                    shuffle=it.get("shuffle", False),
                                    seed=it.get("seed", 123),
                                    features_mask=fm, labels_mask=lm)
        data = launcher.HostShardedIterator(base) \
            if it.get("host_sharded") else base
        fit(data, epochs=it.get("epochs", 1))
        rec["losses"].append(float(net.score()))
        rec["digests"].append(_digest(net.params, net.state))
        calls = []
    else:
        b = int(sc.get("batch", x.shape[0]))
        calls = [i * b for i in sc.get(
            "steps", range(-(-x.shape[0] // b)))]
    ck = None
    c = sc.get("checkpoint")
    if c:
        ck = TrainingCheckpointer(c["dir"], max_to_keep=c.get("keep", 3),
                                  async_save=c.get("async", False))
    multi = None
    if sc.get("ys") is not None:
        d = np.load(sc.get("data", spec["data"]))
        multi = ([d[k] for k in sc["ys"]],
                 [None if k is None else d[k] for k in sc["lms"]])
    for lo in calls:
        hi = lo + int(sc.get("batch", x.shape[0]))
        if multi is not None:
            from ..data.dataset import MultiDataSet
            ds = MultiDataSet([x[lo:hi]], [a[lo:hi] for a in multi[0]],
                              labels_masks=[None if a is None else a[lo:hi]
                                            for a in multi[1]])
        else:
            ds = DataSet(x[lo:hi], y[lo:hi],
                         None if fm is None else fm[lo:hi],
                         None if lm is None else lm[lo:hi])
        if cuda:
            torch.cuda.synchronize()
            k1.launches = k1.bwd_launches = 0
            fe.reset_counters()
        before = pw.counters()["calls"] if pw is not None else None
        t0 = time.perf_counter()
        fit(ds)
        if pw is not None:  # the collectives of this fit call alone
            after = pw.counters()["calls"]
            rec["fit_calls"].append({k: after[k] - before[k] for k in after})
        if cuda:
            torch.cuda.synchronize()
            rec["launches"].append([k1.launches, k1.bwd_launches])
            rec["decisions"].append(fe.counters())
        rec["step_ms"].append((time.perf_counter() - t0) * 1e3)
        rec["held"].append(pw is not None and net._holder is pw)
        rec["losses"].append(float(net.score()))
        rec["digests"].append(_digest(net.params, net.state))
        if ck is not None:
            if net.iteration in c.get("save_at", []):
                t1 = time.perf_counter()
                ck.save(net)
                rec.setdefault("save_call_ms", []).append(
                    (time.perf_counter() - t1) * 1e3)
            if net.iteration == c.get("zip_at"):
                if pw is not None:
                    pw.release()  # the gather is every rank's
                if args.pid == 0:
                    net.save(c["zip"])
    if ck is not None:
        ck.close()
        rec["save_latency_s"] = list(ck.save_latencies)
        rec["save_bytes"] = ck.last_save_bytes
    if pw is not None:
        rec["counters"] = pw.counters()
    rec["updater_digest"] = _digest(net.updater_state)
    rec["iteration"] = int(net.iteration)
    if args.pid == 0:
        np.savez(os.path.join(args.outdir, f"scn_{sc['name']}.npz"),
                 params=_flat(net.params), state=_flat(net.state),
                 updater=_flat(net.updater_state),
                 params_flat=net.params_flat())
    return rec


def _scenarios(args) -> dict:
    """Run the spec's scenarios in order (see :func:`run_scenarios`)."""
    import numpy as np
    import torch

    from . import launcher
    with open(args.spec) as f:
        spec = json.load(f)
    if spec.get("deterministic"):
        # cuDNN's default convolution backward adds with atomics, so two
        # runs of the same step differ in the last bits; the bit-for-bit
        # comparisons between runs ask for its deterministic algorithms
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
        torch.use_deterministic_algorithms(True, warn_only=True)
    out = {"phase": "scenarios", "pid": args.pid, "scenarios": {}}
    for sc in spec["scenarios"]:
        ranks = sc.get("ranks")
        if ranks is not None and launcher.process_count() not in ranks:
            continue
        t_begin = time.time()
        rec = out["scenarios"][sc["name"]] = _one_scenario(sc, spec, args,
                                                           torch, np)
        rec["t_begin"], rec["t_end"] = t_begin, time.time()
    return out


# ---------------------------------------------------------- orchestrator
def _env_for(device: str, extra_env: Optional[dict] = None) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = _REPO_ROOT + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    env.update(extra_env or {})
    return env


class Run:
    """The processes of one phase, started together (see :func:`start`)."""

    def __init__(self, phase, procs, outdir, timeout, logs):
        self.phase, self.procs = phase, procs
        self.outdir, self.timeout = outdir, timeout
        self.logs = logs
        self.t0 = time.monotonic()

    def wait(self) -> List[dict]:
        """Wait for every rank; raise (after killing them all) when one
        fails or outlives the timeout. The per-rank result dicts."""
        try:
            for i, p in enumerate(self.procs):
                left = self.timeout - (time.monotonic() - self.t0)
                try:
                    p.wait(timeout=max(1.0, left))
                except subprocess.TimeoutExpired:
                    raise RuntimeError(
                        f"phase {self.phase}: rank {i} outlived its "
                        f"{self.timeout:.0f} s timeout") from None
                if p.returncode != 0:
                    raise RuntimeError(
                        f"phase {self.phase} rank {i} rc={p.returncode}:\n"
                        + self._tail(i))
        finally:
            self.kill()
        results = []
        for i in range(len(self.procs)):
            with open(os.path.join(self.outdir,
                                   f"result_{self.phase}_{i}.json")) as f:
                results.append(json.load(f))
        return results

    def kill(self) -> None:
        """Kill every rank still running (a caller that gives up)."""
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in self.logs:
            f.close()

    def _tail(self, i) -> str:
        with open(self.logs[i].name, errors="replace") as f:
            return f.read()[-4000:]


def start(phase: str, nprocs: int, outdir: str, steps: int = 4,
          epochs: int = 1, global_batch: int = 16, timeout: float = 300.0,
          device: str = "cpu", backend: Optional[str] = None,
          spec: Optional[str] = None, threads: int = 1,
          extra_env: Optional[dict] = None, nice: int = 0) -> Run:
    """Start one phase on ``nprocs`` ranks (``backend="nccl"`` with one rank
    runs a one-rank NCCL group) and return at once. ``nice`` lowers the
    ranks' scheduling priority (a test suite's latency-sensitive tests
    sharing the cores keep theirs)."""
    os.makedirs(outdir, exist_ok=True)
    rdv = os.path.join(os.path.abspath(outdir),
                       f"rdv_{phase}_{uuid.uuid4().hex}")
    cmd = [sys.executable, "-m", MODULE, "--worker", "--phase", phase,
           "--rdv", f"file://{rdv}", "--nprocs", str(nprocs),
           "--outdir", outdir, "--steps", str(steps), "--epochs",
           str(epochs), "--global-batch", str(global_batch),
           "--device", device, "--threads", str(threads),
           "--group-timeout", str(timeout)]
    if backend:
        cmd += ["--backend", backend]
    if spec:
        cmd += ["--spec", spec]
    env = _env_for(device, extra_env)
    if nice:
        cmd = ["nice", "-n", str(int(nice))] + cmd
    procs, logs = [], []
    for i in range(nprocs):
        log_f = open(os.path.join(outdir, f"log_{phase}_{i}.txt"), "w")
        logs.append(log_f)
        procs.append(subprocess.Popen(cmd + ["--pid", str(i)], env=env,
                                      stdout=log_f,
                                      stderr=subprocess.STDOUT))
    return Run(phase, procs, outdir, timeout, logs)


def _spawn(phase: str, nprocs: int, outdir: str, steps: int, epochs: int,
           global_batch: int, timeout: float, **kw) -> List[dict]:
    """Run one phase on ``nprocs`` ranks and return the per-rank results."""
    return start(phase, nprocs, outdir, steps, epochs, global_batch, timeout,
                 **kw).wait()


def run_scenarios(spec: dict, outdir: str, nprocs: int,
                  timeout: float = 300.0, device: str = "cpu",
                  backend: Optional[str] = None, threads: int = 1,
                  wait: bool = True, tag: str = "scenarios",
                  extra_env: Optional[dict] = None, nice: int = 0):
    """Run a scenario spec on ``nprocs`` ranks. Spec keys: ``model``
    (``{"zip": path}`` or ``{"zoo": name, "seed": s, "kwargs": {...}}``,
    an ``updater`` kwarg as ``Updater.to_dict()``),
    ``data`` (an npz path), ``precision``, and ``scenarios``: a list of
    dicts with ``name``; ``model`` / ``data`` (override the spec's);
    ``x``, ``y``, ``fm``, ``lm`` (npz keys; ``rows`` keeps the first
    rows); ``wrapper`` (``ParallelWrapper`` kwargs, ``mesh`` as ``[data,
    model]`` or ``"pod"`` with ``pod`` kwargs; None: a plain ``fit``);
    either ``batch`` and ``steps`` (batch indices, one ``fit`` call each)
    or ``iterate`` (``{"batch", "shuffle", "seed", "epochs",
    "host_sharded"}``: one ``fit`` over an iterator); ``restore``
    (``{"dir", "step", "expect"}`` or ``{"zip"}``); ``checkpoint``
    (``{"dir", "async", "keep", "save_at", "zip_at", "zip"}``); ``ranks``
    (the world sizes that run it). ``deterministic`` (spec level) asks
    for cuDNN's deterministic algorithms (with ``extra_env``
    ``CUBLAS_WORKSPACE_CONFIG``), for comparisons between runs bit for
    bit. Rank 0 writes ``scn_<name>.npz``
    (params, layer state and updater state as vectors in sorted path
    order, and ``params_flat``); every rank reports losses, digests
    of params and state after each call, step times, K1/K2 launches on a
    card, and the wrapper's counters. With ``wait=False`` returns the
    running :class:`Run`."""
    os.makedirs(outdir, exist_ok=True)
    path = os.path.join(outdir, f"spec_{tag}.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    run = start("scenarios", nprocs, outdir, timeout=timeout, device=device,
                backend=backend, spec=path, threads=threads,
                extra_env=extra_env, nice=nice)
    return run.wait() if wait else run


def run_smoke(outdir: str, timeout: float = 240.0, device: str = "cpu",
              nice: int = 0) -> dict:
    """Tier-1 smoke: 2 ranks form a group, train 2 ZeRO-1 + overlap steps,
    and shut down cleanly."""
    res = _spawn("smoke", 2, outdir, steps=2, epochs=1, global_batch=16,
                 timeout=timeout, device=device, nice=nice)
    return {"ok": True, "losses": [r["loss"] for r in res],
            "mesh_shape": res[0]["mesh_shape"]}


def run_simulation(outdir: str, steps: int = 4, epochs: int = 2,
                   global_batch_per_host: int = 16,
                   artifact_path: Optional[str] = None,
                   timeout: float = 420.0, device: str = "cpu") -> dict:
    """The training matrix (module doc). Weak scaling: the per-rank batch
    is constant, so ``scaling_efficiency = t_1rank / t_2ranks`` is 1.0 at
    ideal scaling."""
    import numpy as np

    os.makedirs(outdir, exist_ok=True)
    t_begin = time.time()
    t1 = _spawn("timing1", 1, outdir, steps, epochs, global_batch_per_host,
                timeout, device=device)[0]
    t2 = _spawn("timing2", 2, outdir, steps, epochs,
                2 * global_batch_per_host, timeout, device=device)
    _spawn("train", 2, outdir, steps, max(2, epochs),
           2 * global_batch_per_host, timeout, device=device)
    restore1 = _spawn("restore1", 1, outdir, steps, 1, global_batch_per_host,
                      timeout, device=device)[0]
    p_train = [np.load(os.path.join(outdir, f"params_train_{i}.npy"))
               for i in range(2)]
    p_restore = np.load(os.path.join(outdir, "params_restore1_0.npy"))
    step1 = float(t1["warm_step_s"])
    step2 = float(np.median([r["warm_step_s"] for r in t2]))
    artifact = {
        "metric": "multihost_scaling",
        "value": step1 / step2,
        "unit": "x_scaling_efficiency_1to2_ranks_weak",
        "ranks": 2, "device": device,
        "parallelism": "ZeRO-1 shard_update + overlap_grads",
        "overlap_buckets": t2[0].get("overlap_buckets", 0),
        "step_time_ms_1rank": step1 * 1e3,
        "step_time_ms_2ranks": step2 * 1e3,
        "cross_rank_params_bit_equal": bool((p_train[0] == p_train[1]).all()),
        "topology_restore_2to1_bit_equal": bool(
            (p_restore == p_train[0]).all()),
        "restore1_verified_steps": restore1["verified_steps"],
        "elapsed_s": time.time() - t_begin,
    }
    if artifact_path:
        with open(artifact_path, "w") as f:
            json.dump(artifact, f, indent=1)
    return artifact


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--worker", action="store_true")
    ap.add_argument("--phase", default="smoke")
    ap.add_argument("--rdv", default=None)
    ap.add_argument("--pid", type=int, default=0)
    ap.add_argument("--nprocs", type=int, default=1)
    ap.add_argument("--outdir", default="multihost_sim_out")
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--global-batch", type=int, default=32)
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--backend", default=None)
    ap.add_argument("--spec", default=None)
    ap.add_argument("--threads", type=int, default=1)
    ap.add_argument("--group-timeout", type=float, default=300.0)
    ap.add_argument("--artifact", default=None)
    args = ap.parse_args(argv)
    if args.worker:
        _worker(args)
        return
    art = run_simulation(args.outdir, steps=args.steps, epochs=args.epochs,
                         artifact_path=args.artifact, device=args.device)
    print(json.dumps(art, indent=1))


if __name__ == "__main__":
    main()
