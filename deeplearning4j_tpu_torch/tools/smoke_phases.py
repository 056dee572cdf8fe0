"""Seconds per phase of ``chip_smoke.py``, for one checkout or for several
in turns on one card.

    python3 -m deeplearning4j_tpu_torch.tools.smoke_phases [DIR ...]

Each DIR (default: this checkout) is a checkout of the repository, for
instance the parent commit unpacked with ``git archive``. Its
``chip_smoke.py`` runs in a fresh process started in DIR, so that it
imports DIR's own package and builds DIR's own kernels, with each of its
``phase_*`` functions timed on the host clock as ``main`` calls it (a
phase called from inside another counts in the outer one). The script's
own output passes through. After each DIR, one line ``[smoke-phases]``
and a JSON object: DIR, the exit code, the seconds from the start of the
process to its end, those of ``main``, and those of each phase in the
order ``main`` called them, with the card's name and power limit as
``nvidia-smi`` gives them. Exits with the first non-zero code. Needs one
CUDA card.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

#: run in DIR: import its chip_smoke, time its phases, run its main, and
#: write {"main_seconds", "phases"} to the file named by argv[1]
_CHILD = r'''
import json, os, sys, time
sys.path.insert(0, os.getcwd())
import chip_smoke
phases, depth = {}, [0]

def timed(name, fn):
    def run(*args, **kwargs):
        depth[0] += 1
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            depth[0] -= 1
            if depth[0] == 0:
                phases[name] = (phases.get(name, 0.0)
                                + time.perf_counter() - t0)
    return run

for name, fn in list(vars(chip_smoke).items()):
    if name.startswith("phase_") and callable(fn):
        setattr(chip_smoke, name, timed(name, fn))
t0, rc = time.perf_counter(), 1
try:
    rc = chip_smoke.main()
finally:
    with open(sys.argv[1], "w") as f:
        json.dump({"main_seconds": time.perf_counter() - t0,
                   "phases": phases}, f)
sys.exit(rc)
'''


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]


def run(checkout: str) -> dict:
    """One run of ``checkout``'s chip_smoke.py with its phases timed."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        t0 = time.perf_counter()
        rc = subprocess.run([sys.executable, "-c", _CHILD, path],
                            cwd=checkout).returncode
        seconds = time.perf_counter() - t0
        with open(path) as f:
            timed = json.load(f) if os.path.getsize(path) else {}
    finally:
        os.unlink(path)
    return {"dir": checkout, "rc": rc, "seconds": seconds,
            "main_seconds": timed.get("main_seconds"),
            "phases": timed.get("phases", {}), "card": smi_line()}


def main(argv=None) -> int:
    dirs = (sys.argv[1:] if argv is None else argv) or [
        os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))]
    first_bad = 0
    for d in dirs:
        row = run(os.path.abspath(d))
        print("[smoke-phases] " + json.dumps(row), flush=True)
        first_bad = first_bad or row["rc"]
    return first_bad


if __name__ == "__main__":
    sys.exit(main())
