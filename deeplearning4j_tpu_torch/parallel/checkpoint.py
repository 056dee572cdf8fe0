"""Resumable training checkpoints, verified by a checksum manifest.

Port of ``deeplearning4j_tpu/parallel/checkpoint.py`` without orbax (the
card's machine has none), in the port's own format. A checkpoint is
``{params, layer state, updater state, dropout generator, counters,
iterator cursor}``: restore continues the exact example sequence, bit for
bit.

**Format.** Each step is a directory ``<step>/`` holding:

- ``params.npz``, ``state.npz`` and (when there is one) ``updater.npz``:
  one npz leaf per tensor under its path key (``"vertex/param"``,
  ``"slot/vertex/param"``), a bfloat16 leaf as its raw 16-bit words with
  the true dtype in a ``__dtypes__`` header, as the ZIP format and the KV
  shipments carry them (``utils/serializer.py``); no pickle anywhere;
- ``meta.json``: step, iteration, epoch, model class, configuration, the
  iterator cursor, the sentinel counters and the dropout generator's
  state (base64 of ``torch.Generator.get_state()``);
- ``manifest.sha256.json``: the sha256 and size of every other file,
  written last and atomically (tmp file, fsync, rename, directory fsync).
  A step with no manifest is "unverified" (its writer died before the
  manifest: restore takes it only when nothing verifies); a mismatch is a
  torn write, never restored.

The files are written into ``<step>.partial-<pid>/`` and renamed into
place, so a reader never sees half a directory; a step that already
exists is kept as it is (the JAX manager skips it too).

**Gather-on-save.** ``ParallelWrapper`` hands the model back with full
values when ``fit`` returns (its tensor-parallel shards and ZeRO-1
updater-state chunks gathered), so rank 0, the single writer, holds the
whole state and a checkpoint restores on any topology and under either
``shard_update`` setting. Ranks other than 0 write nothing; every rank
calls ``save`` (and ``close``) at the same points, and a process group's
ranks meet at a barrier once a synchronous save is written, or at
``wait_until_finished`` after async ones, so a step any rank saw saved
is there for every rank to restore.

``async_save=True`` snapshots the tensors on the device (a copy enqueued
behind the running step, no host sync) and writes on one long-lived
worker thread; ``wait_until_finished`` joins it and re-raises its first
failure. ``max_to_keep`` rotates old steps away. Counters are plain
(``last_save_latency_s``, ``save_latencies``, ``last_save_bytes``,
``restore_count``, ``restore_fallbacks``).

**From the JAX package.** Its checkpoints are orbax directories, which
need orbax to read. The bridge is the ZIP (``utils/serializer.py``): a
JAX ``ParallelWrapper`` run saves one with ``net.save``, the port loads it
(``load_model``) and continues under its own wrapper.

Not here: the ``checkpoint.write`` fault site (ROADMAP.md Queue 1 item 9).
"""

from __future__ import annotations

import base64
import hashlib
import json
import logging
import os
import queue
import shutil
import threading
import time
from collections import deque
from typing import List, Optional

import torch

from .. import dtypes as _dt
from .. import environment as _env
from ..utils.serializer import _npz_bytes_to_tree, _tree_to_npz_bytes

log = logging.getLogger(__name__)

MANIFEST = "manifest.sha256.json"
FORMAT = "deeplearning4j_tpu_torch.parallel.checkpoint"


class CorruptCheckpoint(RuntimeError):
    """Every checkpoint in the directory failed manifest verification, or
    the one asked for did."""


def _primary_host() -> bool:
    """Rank 0 is the single writer (a seam, so tests can play another
    rank)."""
    from . import launcher
    return launcher.process_index() == 0


def _barrier() -> None:
    """Every rank of the process group waits for the others (a saved step
    is visible to every rank once its save returns, as orbax's commit
    barrier makes it in the JAX package); nothing in one process."""
    from . import launcher
    if launcher.process_count() > 1:
        import torch.distributed as dist
        dist.barrier()


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _fsync_dir(d: str) -> None:
    fd = os.open(d, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _config_equivalent(stored_json, live_json) -> bool:
    """Architecture equality modulo the init seed and the learning rate
    (every stored tensor overwrites the fresh init)."""
    if stored_json is None:
        return True
    a, b = json.loads(stored_json), json.loads(live_json)
    for d in (a, b):
        d.pop("seed", None)
        if isinstance(d.get("updater"), dict):
            d["updater"] = dict(d["updater"])
            d["updater"].pop("learning_rate", None)
    return a == b


def _snapshot(tree):
    if isinstance(tree, dict):
        return {k: _snapshot(v) for k, v in tree.items()}
    return tree.detach().clone()


class TrainingCheckpointer:
    """Rotating, resumable training checkpoints for both engines::

        ckpt = TrainingCheckpointer(dir, max_to_keep=3)
        ckpt.save(net, iterator=it)              # inside the train loop
        step = ckpt.restore(net, iterator=it)  # after a restart; or None
    """

    def __init__(self, directory: str, max_to_keep: int = 3,
                 async_save: bool = False):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self._max_to_keep = max_to_keep
        self.async_save = bool(async_save)
        self._finalize_q: "queue.Queue" = queue.Queue()
        self._worker: Optional[threading.Thread] = None
        self._bg_errors: List[BaseException] = []
        self.restore_count = 0
        self.restore_fallbacks = 0
        self.last_save_latency_s: Optional[float] = None
        self.last_save_bytes: Optional[int] = None
        self.save_latencies = deque(maxlen=512)
        # async saves this rank has not met the other ranks after yet
        self._unsynced = False

    # -------------------------------------------------------------- save
    def save(self, model, iterator=None, step: Optional[int] = None,
             wait: bool = False) -> int:
        """Checkpoint the full training state at ``step`` (default: the
        model's iteration counter). With ``async_save`` the write runs on
        the worker thread (``wait=True`` blocks until it is durable);
        otherwise it is durable when this returns."""
        step = int(model.iteration if step is None else step)
        # every rank reads the trees: a ParallelWrapper's held shares are
        # gathered here, a collective (collectives.HeldShards)
        trees = {"params": model.params, "state": model.state}
        if model.updater_state:
            trees["updater"] = model.updater_state
        if not _primary_host():
            if self.async_save and not wait:
                self._unsynced = True
            else:
                _barrier()  # rank 0's write is visible when this returns
            return step
        t0 = time.perf_counter()
        gen = getattr(model, "_rng", None)
        meta = {"step": step, "iteration": int(model.iteration),
                "epoch": int(model.epoch),
                "model_class": type(model).__name__,
                "configuration": model.conf.to_json(),
                "iterator": dict(iterator.state()) if iterator is not None
                else None,
                "generator": None if gen is None else {
                    "device": str(gen.device),
                    "state": base64.b64encode(
                        gen.get_state().numpy().tobytes()).decode()},
                "format": FORMAT, "version": 1}
        sentinel = getattr(model, "_sentinel", None)
        if self.async_save and not wait:
            trees = {k: _snapshot(v) for k, v in trees.items()}

            def job():
                if sentinel is not None:
                    meta["resilience"] = sentinel.to_host()
                self._write(step, trees, meta, t0)
            self._enqueue(job)
            self._unsynced = True
            return step
        self._finalize_q.join()
        if sentinel is not None:
            meta["resilience"] = sentinel.to_host()
        self._write(step, trees, meta, t0)
        _barrier()
        return step

    def _write(self, step: int, trees: dict, meta: dict, t0: float):
        final = os.path.join(self.directory, str(step))
        if os.path.isdir(final):
            log.warning("checkpoint step %d already exists; its bytes and "
                        "manifest are kept", step)
            return
        part = os.path.join(self.directory, f"{step}.partial-{os.getpid()}")
        os.makedirs(part, exist_ok=True)
        nbytes = 0
        for name, tree in trees.items():
            data = _tree_to_npz_bytes(tree)
            nbytes += len(data)
            with open(os.path.join(part, f"{name}.npz"), "wb") as f:
                f.write(data)
                f.flush()
                os.fsync(f.fileno())
        with open(os.path.join(part, "meta.json"), "w") as f:
            json.dump(meta, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(part, final)
        _fsync_dir(self.directory)
        self._write_manifest(step)
        self._rotate()
        latency = time.perf_counter() - t0
        self.last_save_latency_s = latency
        self.last_save_bytes = nbytes
        self.save_latencies.append(latency)

    def _rotate(self):
        steps = self.all_steps()
        for s in steps[:-self._max_to_keep] if self._max_to_keep else []:
            shutil.rmtree(os.path.join(self.directory, str(s)),
                          ignore_errors=True)

    def _enqueue(self, job):
        if self._worker is None or not self._worker.is_alive():
            self._worker = threading.Thread(
                target=self._worker_loop, daemon=True,
                name="TrainingCheckpointer-writer")
            self._worker.start()
        self._finalize_q.put(job)

    def _worker_loop(self):
        while True:
            job = self._finalize_q.get()
            try:
                job()
            except BaseException as e:  # surfaced by wait_until_finished
                self._bg_errors.append(e)
            finally:
                self._finalize_q.task_done()

    # --------------------------------------------- manifest / verification
    def _step_dir(self, step: int) -> Optional[str]:
        d = os.path.join(self.directory, str(step))
        return d if os.path.isdir(d) else None

    def _write_manifest(self, step: int):
        d = self._step_dir(step)
        if d is None:
            return
        files = {}
        for name in sorted(os.listdir(d)):
            p = os.path.join(d, name)
            if name == MANIFEST or name.endswith(".tmp") or \
                    not os.path.isfile(p):
                continue
            files[name] = {"sha256": _sha256(p), "bytes": os.path.getsize(p)}
        payload = json.dumps({"step": int(step), "files": files},
                             sort_keys=True).encode()
        tmp = os.path.join(d, MANIFEST + ".tmp")
        with open(tmp, "wb") as fh:
            fh.write(payload)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, os.path.join(d, MANIFEST))
        _fsync_dir(d)

    def verify(self, step: int) -> Optional[bool]:
        """True: the files match the manifest; False: a file is missing,
        short or different (a torn write), or the step is absent; None: no
        manifest."""
        d = self._step_dir(step)
        if d is None:
            return False
        mpath = os.path.join(d, MANIFEST)
        if not os.path.exists(mpath):
            return None
        try:
            with open(mpath) as fh:
                files = json.load(fh)["files"]
        except (ValueError, KeyError, OSError):
            return False
        for rel, want in files.items():
            p = os.path.join(d, rel)
            if not os.path.exists(p) or \
                    os.path.getsize(p) != want["bytes"] or \
                    _sha256(p) != want["sha256"]:
                return False
        return True

    def all_steps(self) -> List[int]:
        """The steps on disk, oldest first."""
        if not os.path.isdir(self.directory):
            return []
        return sorted(int(n) for n in os.listdir(self.directory)
                      if n.isdigit() and
                      os.path.isdir(os.path.join(self.directory, n)))

    def verified_steps(self) -> List[int]:
        """Steps whose manifest verifies, newest first."""
        return [s for s in reversed(self.all_steps())
                if self.verify(s) is True]

    def scan_steps(self) -> dict:
        """Every step on disk as ``verified``, ``torn`` or ``unverified``,
        newest first (re-read from the directory at each call)."""
        out = {"verified": [], "torn": [], "unverified": []}
        for s in reversed(self.all_steps()):
            v = self.verify(s)
            out["verified" if v is True else
                ("torn" if v is False else "unverified")].append(s)
        return out

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    # ------------------------------------------------------------ restore
    def restore(self, model, iterator=None, step: Optional[int] = None,
                device=None) -> Optional[int]:
        """Restore ``model`` (and ``iterator``'s cursor) in place from
        ``step`` (default: the newest verified one, falling back past torn
        writes; :class:`CorruptCheckpoint` when none verifies). Returns the
        step, or None when the directory has no checkpoint. An
        uninitialized model is initialized on ``device`` first (``cuda``
        unless the caller asks for ``cpu``; raises without a card)."""
        self.wait_until_finished()
        if step is None:
            steps = list(reversed(self.all_steps()))
            if not steps:
                return None
            step = first_unverified = None
            for s in steps:
                v = self.verify(s)
                if v is True:
                    step = s
                    break
                if v is None and first_unverified is None:
                    first_unverified = s
            if step is None and first_unverified is not None:
                step = first_unverified
            if step is None:
                raise CorruptCheckpoint(
                    f"all {len(steps)} checkpoints in {self.directory} "
                    "failed manifest verification")
            skipped = steps.index(step)
            if skipped:
                log.warning("checkpoint(s) %s skipped (torn write or missing "
                            "manifest); falling back to step %d",
                            steps[:skipped], step)
                self.restore_fallbacks += skipped
        elif self._step_dir(step) is None:
            raise ValueError(f"checkpoint step {step} not found in "
                             f"{self.directory} (available: "
                             f"{self.all_steps()})")
        elif self.verify(step) is False:
            raise CorruptCheckpoint(f"checkpoint {step} in {self.directory} "
                                    "failed manifest verification")
        d = self._step_dir(step)
        with open(os.path.join(d, "meta.json")) as f:
            meta = json.load(f)
        if meta["model_class"] != type(model).__name__:
            raise ValueError(f"checkpoint holds a {meta['model_class']}, "
                             f"restoring into a {type(model).__name__}")
        if not _config_equivalent(meta.get("configuration"),
                                  model.conf.to_json()):
            raise ValueError(
                "checkpoint configuration does not match the model being "
                "restored into; rebuild the model from the same config "
                "(the stored JSON is in meta.json)")
        if model.device is None:
            model.init(device=_env.resolve_device(device))
        dev = model.device

        def read(name):
            with open(os.path.join(d, f"{name}.npz"), "rb") as f:
                return _npz_bytes_to_tree(f.read(), dev)
        pdt = _dt.param_dtype(model.conf.dtype)
        model.params = _dt.cast_floating(read("params"), pdt)
        model.state = read("state")
        if os.path.exists(os.path.join(d, "updater.npz")):
            model.updater_state = _dt.cast_floating(read("updater"), pdt)
        gen = meta.get("generator")
        if gen is not None:
            g = torch.Generator(device=dev)
            g.set_state(torch.frombuffer(
                bytearray(base64.b64decode(gen["state"])), dtype=torch.uint8))
            model._rng = g
        else:
            model._rng = None
        model.iteration = int(meta["iteration"])
        model.epoch = int(meta["epoch"])
        rc = meta.get("resilience")
        if rc is not None and getattr(model, "_sentinel", None) is not None:
            for k, v in rc.items():
                setattr(model._sentinel, k, int(v))
        if iterator is not None and meta.get("iterator") is not None:
            iterator.set_state(meta["iterator"])
        for attr in ("_train_step", "_inference_engine"):
            if hasattr(model, attr):
                setattr(model, attr, None)
        self.restore_count += 1
        return step

    # ------------------------------------------------------------ lifetime
    def wait_until_finished(self):
        """Block until every queued save is durable (and, after async
        saves in a process group, until every rank is here); re-raise the
        first background failure."""
        self._finalize_q.join()
        if self._unsynced:
            self._unsynced = False
            _barrier()
        if self._bg_errors:
            raise self._bg_errors.pop(0)

    def quiesce(self) -> List[BaseException]:
        """Wait for queued saves and hand back (instead of raising) their
        failures, for recovery paths."""
        self._finalize_q.join()
        swallowed = list(self._bg_errors)
        self._bg_errors.clear()
        for e in swallowed:
            log.warning("checkpoint quiesce swallowed %s: %s",
                        type(e).__name__, e)
        return swallowed

    def reopen(self) -> None:
        """Quiesce and start afresh on the same directory (the on-disk
        state is untouched)."""
        self.quiesce()
        os.makedirs(self.directory, exist_ok=True)

    def close(self):
        self.wait_until_finished()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
