"""The device kernels one call of K9's or K10's wrapper launches, as
``torch.profiler`` records them, in a process of its own.

    python3 -m deeplearning4j_tpu_torch.tools.count_kernels CASES

CASES is a JSON list of ``[kernel, shape, dtype]``: ``"K9"`` with (B, H,
C, d) or ``"K10"`` with (B, H, k, C, d), and ``"float32"``,
``"bfloat16"`` or ``"float16"``. For each case the process makes random
operands (seed 0) with ragged lengths, calls the wrapper once to load its
kernel, then profiles one more call (CPU and CUDA activities) and lists
the names of the device kernels that call launched. It prints one JSON
line: a list of ``[kernel, shape, dtype, splits, names]``.

Why a process of its own: in a process that ran other work first
(``chip_smoke.py`` after its earlier phases, a pytest run of the card
tests) the profiler was seen to record none of these wrappers' kernels,
while in a fresh process it recorded every one. Needs one CUDA card.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import torch

from ..kernels import decode_attention as k9
from ..kernels import multiquery_decode as k10


def _call(kernel: str, shape, dtype, gen):
    """A wrapper call on random operands of ``shape`` and ``dtype``."""
    dev = torch.device("cuda")
    multi = kernel == "K10"
    B, H = shape[:2]
    C, d = shape[-2:]
    Tq = shape[2] if multi else 1
    q, k, v = (torch.randn(B, H, T, d, generator=gen, device=dev).to(dtype)
               for T in (Tq, C, C))
    top = C - Tq if multi else C
    ln = torch.randint(0, top + 1, (B,), generator=gen, device=dev).to(
        torch.int32)
    if multi:
        return lambda: k10.multiquery_decode(q, k, v, ln)
    return lambda: k9.decode_attention(q, k, v, ln)


def kernels_of(fn) -> list:
    """The names of the device kernels one call of ``fn`` launches."""
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def count(cases) -> list:
    """``[kernel, shape, dtype, splits, names]`` for each case, here."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = []
    for kernel, shape, dtype in cases:
        fn = _call(kernel, shape, getattr(torch, dtype), gen)
        fn()
        names = kernels_of(fn)
        B, H = shape[:2]
        out.append([kernel, list(shape), dtype,
                    k9.num_splits(B, H, shape[-2]), names])
    return out


def count_in_subprocess(cases, timeout: float = 600) -> list:
    """:func:`count` run by ``python3 -m`` this module in a fresh
    process."""
    out = subprocess.run(
        [sys.executable, "-m", __spec__.name, json.dumps(cases)],
        cwd=Path(__file__).resolve().parents[2], check=True,
        capture_output=True, text=True, timeout=timeout)
    return json.loads(out.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        raise SystemExit("count_kernels needs a CUDA card")
    print(json.dumps(count(json.loads(argv[0]))), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
