"""The ResNet-50 training step's wall time on the card, and one fused
attention backward launch for a kernel profiler.

    python3 -m deeplearning4j_tpu_torch.tools.profile_train [--steps N]
    python3 -m deeplearning4j_tpu_torch.tools.profile_train --attn-bwd

The first builds the full-width ResNet-50 as ``chip_smoke.py``'s [train]
does (224x224x3, 1000 classes, float32, precision ``highest``,
``Adam(1e-3)``, seed 0, random weights; one fixed batch of 32 from numpy
seed 2) and prints one JSON line: the median over ``--steps`` calls of
``net.fit`` on that batch (host clock, each call ended by a synchronize,
after 2 warm-up calls), every step's time, and the K1 and K2 launches a
step. Run it from two checkouts in turns to compare them on one card.

The second launches the fused flash-attention backward (K4 + K5) once
at BERT-base's fine-tune shape (32, 12, 128, 128, 64), float32, after
one warm-up launch, and prints the kernel's resources from CUDA's
occupancy calculator: a process to hand to a kernel profiler. Needs one
CUDA card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time

import numpy as np
import torch

from .. import environment as env
from ..kernels import affine_act as k1
from ..models import resnet50

BATCH = 32
WARM = 2
ATTN_SHAPE = (32, 12, 128, 128, 64)


def card() -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip()


def train_steps(steps: int) -> dict:
    env.Environment.instance().f32_matmul_precision = "highest"
    rng = np.random.default_rng(2)
    net = resnet50(seed=0).init(device="cuda")
    x = rng.standard_normal((BATCH, 224, 224, 3), dtype=np.float32)
    y = np.eye(1000, dtype=np.float32)[rng.integers(0, 1000, BATCH)]
    for _ in range(WARM):
        net.fit(x, y)
    torch.cuda.synchronize()
    k1.launches = 0
    k1.bwd_launches = 0
    step_ms = []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        net.fit(x, y)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    return {"cell": "resnet50_fit", "batch": BATCH,
            "step_ms_median": statistics.median(step_ms),
            "step_ms": step_ms,
            "k1_per_step": k1.launches / steps,
            "k2_per_step": k1.bwd_launches / steps,
            "loss": float(net.score()), "card": card()}


def attn_bwd_once() -> dict:
    from ..kernels import flash_attention as k3
    B, H, Tq, Tk, d = ATTN_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(5)
    q, k, v, do = (torch.randn(B, H, T, d, generator=gen, device="cuda")
                   for T in (Tq, Tk, Tk, Tq))
    kb = torch.zeros(B, Tk, device="cuda")
    o, m, l = k3.flash_attention_fwd(q, k, v, kb)
    di = k3.attention_di(o, do)
    for _ in range(2):
        k3.flash_attention_bwd(q, k, v, kb, m, l, di, do)
    torch.cuda.synchronize()
    return {"kernel": "flash_attn_bwd (fused K4+K5)", "shape": ATTN_SHAPE,
            "dtype": "float32", "launches": k3.launches_bwd,
            "resources": k3.bwd_occupancy(d, torch.float32),
            "resources_bfloat16": k3.bwd_occupancy(d, torch.bfloat16),
            "card": card()}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=15)
    ap.add_argument("--attn-bwd", action="store_true")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_train needs a CUDA card")
    print(json.dumps(attn_bwd_once() if a.attn_bwd
                     else train_steps(a.steps)), flush=True)


if __name__ == "__main__":
    main()
