"""Build and load the hand-written CUDA kernels.

Every ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, ``build/lib<name>-<digest>.so``,
and loaded with ctypes. The digest covers the source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source builds anew and an
unchanged one is reused. Builds run at
first use (or all together through :func:`build_all`, one ``nvcc`` per
source started at once); nothing is built or loaded at import time.

Only the repository's own sources are compiled. A failed build raises:
there is no fallback to a plain PyTorch path for a CUDA tensor.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Optional

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def sources() -> Dict[str, Path]:
    """Kernel library name -> its CUDA source."""
    return {p.stem: p for p in sorted(CSRC.glob("*.cu"))}


def nvcc() -> str:
    """Path of nvcc: ``$CUDA_HOME/bin``, ``/usr/local/cuda/bin`` or PATH."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file():
            return str(c)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA "
                           "kernels cannot be built")
    return found


def library_path(name: str) -> Path:
    """The library's path; its digest covers the source, every shared
    header (``csrc/*.cuh``) and the flags."""
    h = hashlib.sha256(sources()[name].read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Compile the named kernel libraries (default: every source) that are
    not built yet, one nvcc process per source, all started together.
    Returns ``{name: compiler output}`` for the ones built now (ptxas
    reports registers, shared memory and spills there); raises with the
    compiler's output when any build fails."""
    srcs = sources()
    names = list(srcs) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen(
            [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(srcs[name])],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{name} (rc {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or none
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The kernel library ``name``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = library_path(name)
            if not path.exists():
                build_all([name])
            lib = _libs[name] = ctypes.CDLL(str(path))
        return lib
