"""The device kernels one call of K7's, K9's or K10's wrapper launches, as
``torch.profiler`` records them, in a process of its own.

    python3 -m deeplearning4j_tpu_torch.tools.count_kernels CASES

CASES is a JSON list of ``[kernel, shape, dtype]``: ``"K7"`` with (rows,
C), ``"K9"`` with (B, H, C, d) or ``"K10"`` with (B, H, k, C, d), and
``"float32"``, ``"bfloat16"`` or ``"float16"``. For each case the process
makes random operands (seed 0; ragged lengths for K9 and K10; K7 fed K6's
mu and rstd, made before the profiled window) and calls the wrapper once
to load its kernel; then one profiler session (CPU and CUDA activities)
records one more call of every case, each after a marker kernel
(``torch.cuda._sleep``), and the device kernels between two markers are
that call's. It prints one JSON line: a list of ``[kernel, shape, dtype,
splits, names]`` (``splits`` is K9's split count, or K7's CTA count).

Why a process of its own and one session: in a process that ran other
work first (``chip_smoke.py`` after its earlier phases, a pytest run of
the card tests), or in a later profiler session of the same process, the
profiler was seen to record none of these wrappers' kernels, while the
first session of a fresh process recorded every one. Needs one CUDA
card.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import torch

from ..kernels import decode_attention as k9
from ..kernels import layer_norm_act as k6
from ..kernels import multiquery_decode as k10


def _call(kernel: str, shape, dtype, gen):
    """A wrapper call on random operands of ``shape`` and ``dtype``."""
    dev = torch.device("cuda")
    if kernel == "K7":
        rows, cols = shape
        x, dy = (torch.randn(rows, cols, generator=gen, device=dev).to(dtype)
                 for _ in range(2))
        g = torch.randn(cols, generator=gen, device=dev) * 0.5 + 1.0
        b = torch.randn(cols, generator=gen, device=dev)
        _, mu, rstd = k6.layer_norm_act(x, g, b, 1e-12)
        return lambda: k6.layer_norm_act_bwd(x, g, b, mu, rstd, dy)
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


#: the kernel torch.cuda._sleep launches: the marker between two calls
MARKER = "spin_kernel"


def count(cases) -> list:
    """``[kernel, shape, dtype, splits, names]`` for each case, here: every
    case's call (each loaded by one call first) in ONE profiler session,
    a marker kernel before each and after the last, the device kernels
    split at the markers in the order they ran. (Sessions after the first
    in a process were seen to record no kernels at all.)"""
    gen = torch.Generator(device="cuda").manual_seed(0)
    calls = []
    for kernel, shape, dtype in cases:
        fn = _call(kernel, shape, getattr(torch, dtype), gen)
        fn()
        calls.append(fn)
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA]) as prof:
        for fn in calls:
            torch.cuda._sleep(1000)
            fn()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
    ran = sorted((e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA),
                 key=lambda e: e.time_range.start)
    per_call, current = [], None
    for e in ran:
        if MARKER in e.name:
            if current is not None:
                per_call.append(current)
            current = []
        elif current is not None:
            current.append(e.name)
    if len(per_call) != len(cases):
        raise RuntimeError(f"the profiler recorded {len(per_call) + 1} of "
                           f"{len(cases) + 1} marker kernels")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = []
    for (kernel, shape, dtype), names in zip(cases, per_call):
        if kernel == "K7":
            splits = k6.bwd_layout(*shape, sms)["ctas"]
        else:
            splits = k9.num_splits(shape[0], shape[1], shape[-2])
        out.append([kernel, list(shape), dtype, splits, names])
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
