"""Where a ResNet-50 serving request spends its time on the card.

    python3 -m deeplearning4j_tpu_torch.tools.profile_serving

Builds the full-width ResNet-50 (224x224x3, 1000 classes, float32, seed
0, random weights) on ``cuda`` and, for each precision policy and request
size, prints one JSON line: the request's wall time through
``net.output`` (median of 10, host clock, the copy back to the host
included), the device time of the kernels it ran (``torch.profiler``
over 5 requests, after one profiled request that pays the tracer's
start-up), the device's busy share (device time over the unprofiled wall
time), K1's device time, and the kernels that took the most device time.
Needs one CUDA card.
"""

from __future__ import annotations

import json
import statistics
import sys
import time

import numpy as np
import torch

from .. import environment as env
from ..kernels import affine_act as k1
from ..models import resnet50

REQUESTS = (1, 32)
PRECISIONS = ("auto", "highest")


def device_us(evt) -> float:
    """A profiler event's own device time in microseconds (the attribute
    is named differently across PyTorch versions)."""
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def profile(net, n: int, reps: int = 5) -> dict:
    x = np.random.default_rng(n).standard_normal(
        (n, 224, 224, 3), dtype=np.float32)
    walls = []
    for _ in range(10):
        t0 = time.perf_counter()
        net.output(x)
        walls.append((time.perf_counter() - t0) * 1e3)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts):
        net.output(x)
    before = k1.launches
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            net.output(x)
    if k1.launches - before != 53 * reps:
        raise AssertionError("the profiled requests did not run K1 53 times "
                             "each")
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and device_us(e) > 0]
    dev = sum(device_us(e) for e in kernels) / 1e3 / reps
    k1_ms = sum(device_us(e) for e in kernels
                if "affine_act_kernel" in e.key) / 1e3 / reps
    top = sorted(kernels, key=device_us, reverse=True)[:8]
    wall = statistics.median(walls)
    return {
        "request_images": n,
        "wall_ms_median": wall,
        "device_ms": dev if kernels else None,
        "device_busy_share": dev / wall if kernels else None,
        "k1_device_ms": k1_ms if kernels else None,
        "images_per_s": n * 1e3 / wall,
        "top_kernels_ms": [[e.key[:70], device_us(e) / 1e3 / reps,
                            e.count // reps] for e in top],
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_serving: no CUDA device", file=sys.stderr)
        return 1
    net = resnet50(seed=0).init(device="cuda")
    net.inference_engine().warmup(REQUESTS)
    old = env.Environment.instance().f32_matmul_precision
    try:
        for mode in PRECISIONS:
            env.Environment.instance().f32_matmul_precision = mode
            for n in REQUESTS:
                row = profile(net, n)
                row["precision"] = mode
                row["card"] = torch.cuda.get_device_name(0)
                print(json.dumps(row), flush=True)
    finally:
        env.Environment.instance().f32_matmul_precision = old
    return 0


if __name__ == "__main__":
    sys.exit(main())
