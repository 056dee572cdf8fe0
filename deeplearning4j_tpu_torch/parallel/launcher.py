"""Multi-process control plane: ``torch.distributed`` start-up, meshes of
ranks, and per-rank data sharding.

Port of ``deeplearning4j_tpu/parallel/launcher.py``. The JAX package is one
controller per host over that host's devices, joined by
``jax.distributed``; the port is one process per rank, torch's idiom (a
deliberate divergence: one process drives one card). So:

- :func:`initialize` (:96) is ``torch.distributed.init_process_group``.
  With no coordinator anywhere (no argument, no ``MASTER_ADDR``/
  ``WORLD_SIZE`` or ``DL4J_TPU_COORDINATOR_ADDRESS`` in the environment)
  it is a no-op, as in JAX, so one script runs on one rank and on many.
  A configured coordinator that does not answer raises
  ``ConnectionError`` within the bounded timeout
  (``DL4J_TPU_COORDINATOR_TIMEOUT_S``, default 60 s), not a hang, and the
  timeout also bounds every collective, so a dead rank fails the job.
  ``backend=`` defaults to NCCL on CUDA and gloo on the CPU. Several
  ranks that share one card must ask for ``backend="gloo"`` (NCCL refuses
  two ranks on one GPU): the backend is never picked silently.
- :class:`Mesh` is the ranks of the default process group viewed as named
  axes (``("data",)`` or ``("data", "model")``), with a process subgroup
  along each axis through every rank. ``devices`` is the array of ranks,
  laid out as the JAX mesh lays out devices. :func:`global_mesh` and
  :func:`pod_mesh` (:263-366) keep the host-major data axis (ranks are
  grouped by host name, or into ``hosts`` equal blocks).
- :func:`make_global_array` (:368) becomes "this rank's shard of the full
  value": a rank holds its rows of a batch, not a global array.
- :class:`HostShardedIterator` (:386) hands each rank its rows of every
  global batch, padding a ragged batch to equal shares and masking the
  pad rows out of the loss and the BatchNorm moments.

Not ported: the JAX client teardown (``_clear_backends``) and the TPU pod
environment detection; ``reinitialize`` tears the process group down and
brings it up again with the same arguments.
"""

from __future__ import annotations

import datetime
import logging
import os
import socket
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from .. import environment as _env
from ..data.dataset import DataSet, DataSetIterator

log = logging.getLogger(__name__)

_initialized = False
_init_kwargs: Optional[dict] = None
#: the backend :func:`initialize` chose and why ("nccl" / "gloo", and
#: whether the caller named it)
backend_choice: Optional[dict] = None

#: bounded coordinator-connect (and collective) budget in seconds
TIMEOUT_ENV = "DL4J_TPU_COORDINATOR_TIMEOUT_S"
DEFAULT_TIMEOUT_S = 60.0
ADDRESS_ENV = "DL4J_TPU_COORDINATOR_ADDRESS"


def _coordinator_timeout() -> float:
    try:
        return float(os.environ.get(TIMEOUT_ENV, DEFAULT_TIMEOUT_S))
    except ValueError:
        return DEFAULT_TIMEOUT_S


def _check_coordinator_reachable(address: str, timeout: float) -> None:
    """Bounded TCP pre-check of ``host:port`` for the non-zero ranks (rank
    0 hosts the store). Raises ``ConnectionError``, which a supervisor
    may retry."""
    host, _, port = address.rpartition(":")
    try:
        port_no = int(port)
    except ValueError:
        raise ConnectionError(
            f"coordinator address {address!r} has no usable port "
            "(expected host:port)") from None
    deadline = time.monotonic() + timeout
    last: Optional[BaseException] = None
    while time.monotonic() < deadline:
        try:
            with socket.create_connection(
                    (host or "127.0.0.1", port_no),
                    timeout=min(2.0, max(0.1, deadline - time.monotonic()))):
                return
        except OSError as e:
            last = e
            time.sleep(min(0.25, max(0.0, deadline - time.monotonic())))
    raise ConnectionError(
        f"coordinator at {address!r} unreachable after {timeout:.1f}s "
        f"(last error: {last}); is rank 0 up, and is the address routable "
        "from this host?")


def _env_int(*names) -> Optional[int]:
    for n in names:
        v = os.environ.get(n)
        if v is not None and v.strip().lstrip("-").isdigit():
            return int(v)
    return None


def _env_address() -> Optional[str]:
    if os.environ.get(ADDRESS_ENV):
        return os.environ[ADDRESS_ENV]
    if os.environ.get("MASTER_ADDR") and os.environ.get("MASTER_PORT"):
        return f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    return None


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None,
               device=None,
               timeout: Optional[float] = None) -> None:
    """Bring up the default process group (idempotent).

    ``coordinator_address`` is ``host:port`` (a TCP store that rank 0
    hosts), or a ``tcp://`` / ``file://`` init URL; it defaults to
    ``DL4J_TPU_COORDINATOR_ADDRESS`` or ``MASTER_ADDR:MASTER_PORT``.
    ``num_processes`` / ``process_id`` default to ``WORLD_SIZE`` /
    ``RANK``. ``device`` (``cuda`` unless the caller asks for ``cpu``;
    raises without CUDA) picks the default backend: NCCL on CUDA, gloo on
    the CPU; ``backend=`` overrides it and is recorded in
    :data:`backend_choice`."""
    global _initialized, _init_kwargs, backend_choice
    dev = _env.resolve_device(device)
    if _initialized:
        return
    addr = coordinator_address or _env_address()
    n = num_processes if num_processes is not None else _env_int(
        "WORLD_SIZE")
    if addr is None and n is None:
        return  # one process: nothing to initialize
    if addr is None or n is None:
        raise ValueError("a process group needs both a coordinator address "
                         "and a process count")
    pid = process_id if process_id is not None else _env_int("RANK")
    if pid is None:
        raise ValueError("a process group needs this process's rank "
                         "(process_id= or RANK)")
    timeout = _coordinator_timeout() if timeout is None else float(timeout)
    if addr.startswith("file://"):
        url = addr
    else:
        hostport = addr[len("tcp://"):] if addr.startswith("tcp://") \
            else addr
        if pid != 0:
            _check_coordinator_reachable(hostport, timeout)
        elif not hostport.rpartition(":")[2].isdigit():
            raise ConnectionError(
                f"coordinator address {addr!r} has no usable port "
                "(expected host:port)")
        url = f"tcp://{hostport}"
    chosen = backend or ("nccl" if dev.type == "cuda" else "gloo")
    import torch.distributed as dist
    kw = dict(backend=chosen, init_method=url, world_size=int(n),
              rank=int(pid), timeout=datetime.timedelta(seconds=timeout))
    if dev.type == "cuda":
        torch.cuda.set_device(local_device(int(pid)))
    dist.init_process_group(**kw)
    _initialized = True
    _init_kwargs = kw
    backend_choice = {"backend": chosen, "named": backend is not None,
                      "device": dev.type}


def local_device(rank: Optional[int] = None) -> int:
    """The CUDA device index a rank drives: ``LOCAL_RANK`` when set, else
    the rank modulo the visible cards (several ranks share a card when
    there are more ranks than cards)."""
    lr = _env_int("LOCAL_RANK")
    if lr is None:
        lr = process_index() if rank is None else rank
    return lr % max(1, torch.cuda.device_count())


def shutdown() -> None:
    global _initialized, backend_choice
    if _initialized:
        import torch.distributed as dist
        if dist.is_initialized():
            dist.destroy_process_group()
        _initialized = False
        backend_choice = None


def reinitialize() -> bool:
    """Tear the process group down and bring it up again with the same
    arguments (every surviving rank at the same point). Returns True when
    a group was cycled, False for a single process."""
    global _initialized
    if not _initialized or _init_kwargs is None:
        return False
    import torch.distributed as dist
    try:
        dist.destroy_process_group()
    except (RuntimeError, ValueError) as e:
        log.warning("reinitialize: teardown failed (%s: %s); re-initializing",
                    type(e).__name__, e)
    _initialized = False
    dist.init_process_group(**_init_kwargs)
    _initialized = True
    return True


def _dist_ready() -> bool:
    import torch.distributed as dist
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    if not _dist_ready():
        return 0
    import torch.distributed as dist
    return dist.get_rank()


def process_count() -> int:
    if not _dist_ready():
        return 1
    import torch.distributed as dist
    return dist.get_world_size()


def is_multi_host() -> bool:
    return process_count() > 1


def host_names() -> List[str]:
    """Every rank's host name, in rank order (a collective)."""
    if process_count() == 1:
        return [socket.gethostname()]
    import torch.distributed as dist
    out: List[Optional[str]] = [None] * process_count()
    dist.all_gather_object(out, socket.gethostname())
    return [str(h) for h in out]


class Mesh:
    """Ranks viewed as named axes. ``devices`` is the numpy array of
    ranks (the JAX mesh's device array); ``shape`` maps axis to size.
    Building one makes the process subgroup along every axis through
    every rank (a collective: every rank builds the same meshes in the
    same order); :meth:`group` gives this rank's."""

    def __init__(self, ranks, axis_names: Sequence[str],
                 hosts: Optional[Sequence] = None):
        self.devices = np.asarray(ranks, dtype=np.int64)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"mesh of shape {self.devices.shape} needs "
                             f"{self.devices.ndim} axis names, got "
                             f"{self.axis_names}")
        flat = sorted(int(r) for r in self.devices.flat)
        if flat != list(range(process_count())) and process_count() > 1:
            raise ValueError(f"a mesh covers every rank of the process "
                             f"group once; got {flat}")
        #: per rank, the id of its host (a hostname, or a virtual block)
        self.hosts = list(hosts) if hosts is not None else None
        self._groups = {}
        if process_count() > 1:
            import torch.distributed as dist
            me = process_index()
            for i, ax in enumerate(self.axis_names):
                moved = np.moveaxis(self.devices, i, -1).reshape(
                    -1, self.devices.shape[i])
                for row in moved:
                    ranks_ = [int(r) for r in row]
                    g = dist.new_group(ranks_)
                    if me in ranks_:
                        self._groups[ax] = (g, ranks_)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def group(self, axis: str):
        """``(process group, its ranks in axis order)`` along ``axis``
        through this rank; ``(None, [0])`` in a single process."""
        if axis not in self.axis_names:
            raise ValueError(f"axis {axis!r} not in mesh axes "
                             f"{self.axis_names}")
        return self._groups.get(axis, (None, [0]))

    def index(self, axis: str) -> int:
        """This rank's index along ``axis``."""
        me = process_index()
        pos = np.argwhere(self.devices == me)
        if not len(pos):
            return 0
        return int(pos[0][self.axis_names.index(axis)])

    def __repr__(self):
        return f"Mesh({self.shape})"


def global_mesh(axis: str = "data", devices: Optional[Sequence] = None
                ) -> Mesh:
    """A 1-axis mesh over every rank."""
    from .data_parallel import make_mesh
    return make_mesh(devices, axis)


def _group_by_host(ranks, hosts: Optional[int] = None,
                   names: Optional[Sequence[str]] = None):
    """``[[host0 ranks...], ...]`` in host order. ``hosts=`` carves the
    ranks into that many equal contiguous blocks (virtual hosts)."""
    ranks = list(ranks)
    if hosts is not None and hosts >= 1:
        if len(ranks) % hosts:
            raise ValueError(f"{len(ranks)} ranks do not split into "
                             f"{hosts} equal virtual hosts")
        per = len(ranks) // hosts
        return [ranks[h * per:(h + 1) * per] for h in range(hosts)]
    names = names if names is not None else host_names()
    by_host: dict = {}
    for r in ranks:
        by_host.setdefault(names[r], []).append(r)
    return [by_host[h] for h in sorted(by_host,
                                       key=lambda h: min(by_host[h]))]


def pod_mesh(model: int = 1, devices: Optional[Sequence] = None,
             hosts: Optional[int] = None, model_span: str = "host") -> Mesh:
    """2-D ``('data', 'model')`` mesh with a host-major data axis (the JAX
    rule, :287): the model axis runs over consecutive ranks of one host,
    the data axis host by host. ``model`` must divide each host's rank
    count (``model_span="pod"``: the total). ``model=1`` gives a 1-axis
    ``('data',)`` mesh. ``hosts=`` carves the ranks into virtual hosts."""
    if model_span not in ("host", "pod"):
        raise ValueError(f"model_span={model_span!r} not in ('host', 'pod')")
    ranks = list(devices) if devices is not None else \
        list(range(process_count()))
    groups = _group_by_host(ranks, hosts)
    locals_ = {len(g) for g in groups}
    if len(locals_) != 1:
        raise ValueError(
            f"ragged pod: per-host rank counts differ "
            f"({sorted(len(g) for g in groups)}); a mesh needs equal hosts")
    local = locals_.pop()
    host_of = {}
    for h, g in enumerate(groups):
        for r in g:
            host_of[r] = h
    if model_span == "pod":
        total = len(groups) * local
        if model < 1 or total % model:
            raise ValueError(
                f"model={model} must divide the pod rank count {total} "
                "when model_span='pod'")
        flat = [r for g in groups for r in g]
        arr = np.asarray(flat).reshape(total // model, model)
    else:
        if model < 1 or local % model:
            raise ValueError(
                f"model={model} must divide the per-host rank count "
                f"{local}: the model axis must stay inside one host "
                "(serve a too-big-for-one-host model with model_span='pod')")
        arr = np.asarray([g[i * model:(i + 1) * model] for g in groups
                          for i in range(local // model)])
    hosts_list = [host_of[r] for r in sorted(host_of)]
    if model == 1:
        return Mesh(arr[:, 0], ("data",), hosts=hosts_list)
    return Mesh(arr, ("data", "model"), hosts=hosts_list)


def make_global_array(local_data, mesh: Mesh, spec=()):
    """This rank's shard of a value: with ``spec=("data",)`` the caller's
    ``local_data`` is the full global batch and the rank keeps its
    contiguous rows (the data axis's share, host-major); with ``spec=()``
    the value is replicated and returned whole. A torch tensor on the
    CPU (the caller moves it to its device)."""
    arr = np.asarray(local_data)
    if not tuple(spec):
        return torch.as_tensor(arr)
    if tuple(spec)[0] != "data":
        raise ValueError(f"make_global_array shards the batch over 'data' "
                         f"only; got spec {spec}")
    n = mesh.shape["data"]
    if arr.shape[0] % n:
        raise ValueError(f"{arr.shape[0]} rows do not split over a data "
                         f"axis of {n}")
    k = arr.shape[0] // n
    i = mesh.index("data")
    return torch.as_tensor(arr[i * k:(i + 1) * k])


class HostShardedIterator(DataSetIterator):
    """Each rank sees its contiguous 1/N slice of every global batch.

    The base iterator is the same on every rank (same seed, same order),
    and rank ``p`` takes rows ``[p*k, (p+1)*k)``. A ragged batch is padded
    to equal shares, and EVERY rank then synthesizes its masks (zero loss
    weight and a zero feature mask on the pad rows), so every rank runs the
    same collectives. The restorable cursor delegates to the base."""

    def __init__(self, base: DataSetIterator,
                 process_id: Optional[int] = None,
                 num_processes: Optional[int] = None):
        self._base = base
        self._pid = process_index() if process_id is None else process_id
        self._n = process_count() if num_processes is None else num_processes

    def batch_size(self) -> int:
        return max(1, self._base.batch_size() // self._n)

    def reset(self):
        self._base.reset()

    def state(self) -> dict:
        return self._base.state()

    def set_state(self, state: dict):
        self._base.set_state(state)

    @staticmethod
    def _slice(a, lo, hi):
        return None if a is None else np.asarray(a)[lo:hi]

    def __iter__(self):
        from .data_parallel import _synth_pad_feature_mask
        for ds in self._base:
            b = ds.num_examples()
            k = (b + self._n - 1) // self._n
            ragged = k * self._n != b
            lo, hi = min(self._pid * k, b), min((self._pid + 1) * k, b)
            feats = np.asarray(ds.features)[lo:hi]
            labels = self._slice(ds.labels, lo, hi)
            fm = self._slice(ds.features_mask, lo, hi)
            lm = self._slice(ds.labels_mask, lo, hi)
            short = k - feats.shape[0]
            if short:
                def zpad(a):
                    if a is None:
                        return None
                    return np.pad(a, [(0, short)] + [(0, 0)] * (a.ndim - 1))
                feats, labels, fm, lm = (zpad(feats), zpad(labels),
                                         zpad(fm), zpad(lm))
            if ragged:
                if lm is None:
                    lm = np.ones((k,), dtype=np.float32)
                    if short:
                        lm[-short:] = 0.0
                if fm is None:
                    fm = _synth_pad_feature_mask(feats, short)
            yield self._pp(DataSet(feats, labels, fm, lm))
