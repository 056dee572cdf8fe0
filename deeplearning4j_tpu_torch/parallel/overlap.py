"""Bucketed gradient collectives, their overlap with the backward pass,
and the two-stage (intra-host, cross-host) reduction.

Port of ``deeplearning4j_tpu/parallel/overlap.py``. In the JAX package the
collectives are GSPMD's; the module pins each gradient bucket to the
ZeRO-1 update sharding at gradient-production time and chains the buckets
with ``optimization_barrier`` so that XLA starts the reduce-scatters in
bucket order while the backward still runs. In the port they are
``torch.distributed`` calls, made by :class:`GradientSync`:

- :func:`make_buckets` (:103) is the JAX function: the same buckets in
  the same order for the same tree (size-capped, reverse top-level key
  order, the keys walked in the JAX pytree order).
- Every bucket is ONE collective over the data group: the flattened
  gradients of its leaves whose update is sharded (ZeRO-1,
  ``shard_update=True``) are reduce-scattered, each rank receiving its
  chunk of every leaf along the leaf's update dimension; the leaves whose
  update is replicated (no dimension divides the data axis, or
  ``shard_update=False``) are all-reduced.
- With ``overlap=True`` (``overlap_transform``, :240) the step arms a
  gradient hook on every parameter (``training.value_and_grad`` calls it
  as each gradient is made); a bucket's collective starts, async, once
  all its leaves have their gradients, in bucket order, and the updater
  waits on it. ``torch.autograd.grad`` accumulates no ``.grad``, so the
  hook is a tensor hook (``Tensor.register_hook``), not a post-accumulate
  one. Under ``accum_steps > 1`` the gradient of a leaf is final only
  after the last microbatch, so the buckets start after the accumulation
  (still bucketed and async).
- :class:`HostHierarchy` / :func:`host_hierarchy` (:131-209) view the
  host-major data axis as (host, rank within the host) with a subgroup
  for each: a sharded bucket is reduce-scattered within the host first
  and then across hosts over 1/local of the bytes (each rank ends with
  exactly its ZeRO-1 chunk); a replicated one is all-reduced within the
  host, then across hosts.
- :func:`split_dcn_chains` (:211) is the JAX function; the chains order
  the start of the buckets within each (all of one group's collectives
  still run in the order they start).

Numerics. Overlap is scheduling only: the same collectives on the same
values, bit-equivalent to overlap off. At two ranks every sum is one
``a + b``, so the bucketed all-reduce, the ZeRO-1 reduce-scatter and
their overlapped forms agree bit for bit. At four ranks a reduce-scatter
and an all-reduce may add in different orders and agree to rounding: a
recorded divergence from the JAX package, whose GSPMD forms are
bit-equivalent there (:62-66). The two-stage form is a different
summation tree, deterministic for a fixed configuration (as in JAX).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .collectives import Comm, _Then
from ..utils.tree import get_path
from .placement import flatten_paths

#: default bucket size cap in MiB (``overlap_bucket_mb=`` overrides it)
DEFAULT_BUCKET_MB = 4.0


def make_buckets(params, bucket_bytes: int) -> List[List[Tuple[str, ...]]]:
    """Partition the parameter-leaf paths into size-capped buckets in
    reverse top-level (layer/vertex) order. Every leaf lands in exactly one
    bucket; a leaf bigger than the cap gets its own bucket."""
    if bucket_bytes <= 0:
        raise ValueError(f"bucket_bytes must be positive, got {bucket_bytes}")
    groups: Dict[str, List] = {}
    for path, leaf in flatten_paths(params):
        groups.setdefault(path[0] if path else "", []).append((path, leaf))
    buckets: List[List[Tuple[str, ...]]] = []
    cur: List[Tuple[str, ...]] = []
    cur_bytes = 0
    for key in reversed(list(groups)):
        for path, leaf in groups[key]:
            nbytes = int(np.prod(tuple(leaf.shape))) * _itemsize(leaf)
            if cur and cur_bytes + nbytes > bucket_bytes:
                buckets.append(cur)
                cur, cur_bytes = [], 0
            cur.append(path)
            cur_bytes += nbytes
    if cur:
        buckets.append(cur)
    return buckets


def _itemsize(leaf) -> int:
    if torch.is_tensor(leaf):
        return leaf.element_size()
    return np.dtype(leaf.dtype).itemsize


class HostHierarchy:
    """The data axis of a host-major mesh as (``dcn``: the host, ``ici``:
    the rank within the host); :meth:`connect` makes this rank's subgroup
    along each."""

    def __init__(self, mesh, hosts: int):
        devs = mesh.devices
        data = devs.shape[0]
        if hosts < 2 or data % hosts:
            raise ValueError(f"data axis {data} does not split over "
                             f"{hosts} hosts")
        self.hosts = int(hosts)
        self.local = data // hosts
        self.mesh = mesh
        self.ici: Optional[Comm] = None
        self.dcn: Optional[Comm] = None

    def connect(self, device, counters=None) -> "HostHierarchy":
        """Make this rank's intra-host and cross-host groups (a
        collective: every rank makes every subgroup)."""
        from . import launcher
        devs = self.mesh.devices.reshape(self.mesh.devices.shape[0], -1)
        me = launcher.process_index()
        found = {}
        ready = launcher.process_count() > 1
        if ready:
            import torch.distributed as dist
        for col in range(devs.shape[1]):
            axis = devs[:, col].reshape(self.hosts, self.local)
            for name, rows in (("ici", axis), ("dcn", axis.T)):
                for row in rows:
                    ranks = [int(r) for r in row]
                    g = dist.new_group(ranks) if ready else None
                    if me in ranks:
                        found[name] = (g, ranks)
        for name in ("ici", "dcn"):
            g, ranks = found.get(name, (None, [0]))
            setattr(self, name, Comm(g, device, counters, ranks))
        return self

    @staticmethod
    def _map_spec(spec, data_to):
        return tuple(data_to if ax == "data" else ax for ax in spec)

    def split(self, spec: tuple):
        """``(intra, full)`` specs for one leaf's update spec: the data
        dimension over ``ici`` only, then over ``("dcn", "ici")``; a leaf
        whose update is not sharded gives ``(None, None)``."""
        if "data" not in tuple(spec):
            return None, None
        return (self._map_spec(spec, "ici"),
                self._map_spec(spec, ("dcn", "ici")))


def host_hierarchy(mesh, dcn_hosts: Optional[int] = None
                   ) -> Optional[HostHierarchy]:
    """The mesh's host hierarchy, or None (one host, or a data axis that
    does not split). ``dcn_hosts`` overrides the detection from the
    mesh's host map (virtual hosts); detection checks that the data axis
    is host-major."""
    devs = mesh.devices
    data = devs.shape[0]
    if dcn_hosts is None:
        hosts_of = getattr(mesh, "hosts", None)
        if not hosts_of:
            return None
        procs = [hosts_of[int(r)] for r in devs.flat]
        hosts = len(set(procs))
        if hosts <= 1 or data % hosts:
            return None
        per = data // hosts
        rows = devs.reshape(data, -1)
        for b in range(hosts):
            block = {hosts_of[int(r)]
                     for r in rows[b * per:(b + 1) * per].flat}
            if len(block) != 1:
                raise ValueError(
                    "mesh data axis is not host-major (block %d spans hosts "
                    "%s); build the mesh with launcher.pod_mesh" % (
                        b, sorted(block)))
        return HostHierarchy(mesh, hosts)
    if dcn_hosts <= 1:
        return None
    return HostHierarchy(mesh, dcn_hosts)


def split_dcn_chains(buckets, specs) -> List[List[List[Tuple[str, ...]]]]:
    """Split the buckets into two chains, each in production order: the
    buckets holding a leaf whose update is not sharded (a full
    all-reduce, the heavier cross-host hop) and the rest."""
    spec_by_path = dict(flatten_paths(specs)) if isinstance(specs, dict) \
        else {}

    def heavy(bucket) -> bool:
        for p in bucket:
            sp = spec_by_path.get(tuple(p))
            if sp is None or "data" not in tuple(sp):
                return True
        return False

    chains = [[b for b in buckets if heavy(b)],
              [b for b in buckets if not heavy(b)]]
    return [c for c in chains if c]


def zero_dim(spec: tuple) -> Optional[int]:
    """The dimension an update spec splits over ``data``, or None."""
    for d, ax in enumerate(tuple(spec)):
        if ax == "data" or (isinstance(ax, tuple) and "data" in ax):
            return d
    return None


class GradientSync:
    """The gradient collectives of one wrapper step (see the module doc).

    ``params``: the local parameter tree (shapes and dtypes); ``buckets``:
    :func:`make_buckets`' paths; ``zero``: ``{path: dim}`` of the leaves
    whose update is sharded over the data axis (empty: replicated
    update); ``tp``: the paths split over the model axis; ``data`` /
    ``model``: the Comms of this rank's data-axis and model-axis groups;
    ``hierarchy``: a :class:`HostHierarchy` with its groups, or None;
    ``chains``: bucket chains (default one chain)."""

    def __init__(self, params, buckets, zero: Dict, tp, data: Comm,
                 model: Comm, hierarchy: Optional[HostHierarchy] = None,
                 chains=None, overlap: bool = False):
        self.buckets = [[tuple(p) for p in b] for b in buckets]
        self.zero = {tuple(p): d for p, d in zero.items() if d is not None}
        self.tp = {tuple(p) for p in tp}
        self.data, self.model = data, model
        self.hierarchy = hierarchy
        self.overlap = bool(overlap)
        index = {tuple(b[0]): i for i, b in enumerate(self.buckets) if b}
        chains = chains or [self.buckets]
        self.chains = [[index[tuple(b[0])] for b in c] for c in chains]
        self._bucket_of = {p: i for i, b in enumerate(self.buckets)
                           for p in b}
        self._shapes = {tuple(p): tuple(t.shape)
                        for p, t in flatten_paths(params)}
        self.sharded = bool(self.zero) or bool(self.tp)
        self.begin()

    # ------------------------------------------------------------ layout
    def shard_shape(self, path) -> tuple:
        shape = list(self._shapes[path])
        d = self.zero.get(path)
        if d is not None:
            shape[d] //= self.data.size
        return tuple(shape)

    def _chunk(self, t, path, r):
        d = self.zero[path]
        return t.chunk(self.data.size, dim=d)[r]

    def shard_tree(self, tree):
        """Each ZeRO-1 leaf of a params-shaped tree as this rank's chunk
        (a copy: the full tensor is not kept alive); the rest as is."""
        from .placement import map_paths
        r = self.data.rank

        def one(path, t):
            if path in self.zero and tuple(t.shape) == self._shapes[path]:
                return self._chunk(t, path, r).clone()
            return t
        return map_paths(one, tree)

    def gather_tree(self, tree):
        """The full values of a tree of ZeRO-1 chunks, one all-gather a
        bucket."""
        from .placement import map_paths
        full = {}
        n = self.data.size
        for bucket in self.buckets:
            paths = [p for p in bucket if p in self.zero]
            if not paths:
                continue
            parts = [get_path(tree, p).contiguous().reshape(-1)
                     for p in paths]
            flat = torch.cat(parts)
            out = torch.empty(n * flat.numel(), dtype=flat.dtype,
                              device=flat.device)
            self.data.all_gather(out, flat)
            rows = out.view(n, -1)
            off = 0
            for p, part in zip(paths, parts):
                k = part.numel()
                chunks = [rows[r, off:off + k].view(self.shard_shape(p))
                          for r in range(n)]
                full[p] = torch.cat(chunks, dim=self.zero[p])
                off += k
        return map_paths(lambda path, t: full.get(path, t), tree)

    # --------------------------------------------------------- the step
    def begin(self):
        """Reset the per-step state (the wrapper calls it before a step)."""
        self._got: Dict[tuple, torch.Tensor] = {}
        self._handles: Dict[int, tuple] = {}
        self._next = [0] * len(self.chains)

    def hook(self, path, grad):
        """A parameter's gradient is made: keep it, and start every bucket
        at the head of its chain whose leaves are all here."""
        path = tuple(path)
        self._got[path] = grad.detach()
        b = self._bucket_of.get(path)
        if b is not None:
            self._start_ready()

    def _start_ready(self):
        for c, chain in enumerate(self.chains):
            while self._next[c] < len(chain):
                b = chain[self._next[c]]
                if not all(p in self._got for p in self.buckets[b]):
                    break
                self._handles[b] = self._start(b)
                self._next[c] += 1

    def _start(self, b):
        bucket = self.buckets[b]
        n = self.data.size
        grads = [self._got[p].reshape(self._shapes[p]) for p in bucket]
        sharded = [(p, g) for p, g in zip(bucket, grads) if p in self.zero]
        whole = [(p, g) for p, g in zip(bucket, grads) if p not in self.zero]
        handles = []
        rs_out = None
        if sharded:
            h = self.hierarchy
            if h is not None and h.ici is not None:
                L, H = h.local, h.hosts
                order = [hh * L + i for i in range(L) for hh in range(H)]
            else:
                order = list(range(n))
            send = torch.cat([self._chunk(g, p, r).reshape(-1)
                              for r in order for p, g in sharded])
            numel = send.numel() // n
            rs_out = torch.empty(numel, dtype=send.dtype, device=send.device)
            handles.append(self._reduce_scatter(rs_out, send))
        ar_buf = None
        if whole:
            ar_buf = torch.cat([g.reshape(-1) for _, g in whole])
            handles.append(self._all_reduce(ar_buf))
        return handles, sharded, whole, rs_out, ar_buf

    def _reduce_scatter(self, out, send):
        h = self.hierarchy
        if h is None or h.ici is None:
            return self.data.reduce_scatter(out, send, async_op=self.overlap)
        mid = torch.empty(out.numel() * h.hosts, dtype=out.dtype,
                          device=out.device)
        work = h.ici.reduce_scatter(mid, send, async_op=self.overlap)
        return _Then(work, lambda: h.dcn.reduce_scatter(out, mid))

    def _all_reduce(self, buf):
        h = self.hierarchy
        if h is None or h.ici is None:
            return self.data.all_reduce(buf, async_op=self.overlap)
        work = h.ici.all_reduce(buf, async_op=self.overlap)
        return _Then(work, lambda: h.dcn.all_reduce(buf))

    def reduce(self, loss, grads):
        """``(global loss, gradients)`` for the updater: every bucket's
        collective started (those the hooks did not start yet, in chain
        order), waited on, and unpacked: ZeRO-1 leaves as this rank's
        chunk of the summed gradient, the others whole."""
        from .placement import map_paths
        loss = loss.detach().clone()
        self.data.all_reduce(loss)
        for path, g in flatten_paths(grads):
            self._got.setdefault(tuple(path), g)
        self._start_ready()
        out = {}
        for b in range(len(self.buckets)):
            handles, sharded, whole, rs_out, ar_buf = self._handles[b]
            for w in handles:
                w.wait()
            off = 0
            for p, _ in sharded:
                shape = self.shard_shape(p)
                k = int(np.prod(shape))
                out[p] = rs_out[off:off + k].view(shape)
                off += k
            off = 0
            for p, g in whole:
                k = g.numel()
                out[p] = ar_buf[off:off + k].view(self._shapes[p])
                off += k
        self.begin()
        return loss, map_paths(lambda path, t: out.get(path, t), grads)

    # ------------------------------------------- global norms of shards
    def ssq(self, grads):
        """Per leaf, the global sum of squares of the gradient this rank
        holds a part of (one all-reduce over the data group and one over
        the model group): a ZeRO-1 chunk or a model-axis shard adds its
        part, a whole leaf counts on one rank of its axis only."""
        from .placement import map_paths
        paths = flatten_paths(grads)
        parts = []
        for path, g in paths:
            s = torch.sum(torch.square(g.float()))
            if (path not in self.zero and self.data.rank != 0) or \
                    (path not in self.tp and self.model.rank != 0):
                s = torch.zeros_like(s)
            parts.append(s)
        vec = torch.stack(parts)
        self.data.all_reduce(vec)
        self.model.all_reduce(vec)
        table = {tuple(p): vec[i] for i, (p, _) in enumerate(paths)}
        return map_paths(lambda path, t: table[path], grads)

    def any(self, flag):
        """A 0/1 flag that is 1 when it is 1 on any rank."""
        f = flag.to(torch.float32).clone()
        self.data.all_reduce(f)
        self.model.all_reduce(f)
        return (f > 0).to(flag.dtype)


def overlap_transform(params, buckets, zero, tp, data, model,
                      hierarchy=None, chains=None) -> GradientSync:
    """The overlapped :class:`GradientSync` (the JAX function returns the
    gradient transform its step applies; here the step calls the hooks)."""
    return GradientSync(params, buckets, zero, tp, data, model,
                        hierarchy=hierarchy, chains=chains, overlap=True)
