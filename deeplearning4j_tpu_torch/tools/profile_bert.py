"""Where a BERT-base serving request spends its time on the card.

    python3 -m deeplearning4j_tpu_torch.tools.profile_bert

Builds BERT-base (HF ``BertConfig()`` geometry, float32, random weights
from seed 0, sequence length 128) as a SameDiff graph on ``cuda``, fuses
its 12 attention sites (``fuse_attention``) and, for requests of 1, 8 and
32 sequences with ragged attention masks drawn from the seed, prints one
JSON line each: the wall time of one ``sd.output`` (median of 10, host
clock, the copy of the result back to the host included), the device time
of the kernels it ran (``torch.profiler`` over 3 requests, after one
profiled request that pays the tracer's start-up), the device's busy
share (device time over the unprofiled wall time), K3's device time and
launches, and the kernels that took the most device time. Precision
``highest`` (TF32 off). Needs one CUDA card.
"""

from __future__ import annotations

import json
import statistics
import sys
import time

import numpy as np
import torch

from .. import environment as env
from ..autodiff.fusion import fuse_attention
from ..kernels import flash_attention as k3
from ..models.bert import ATTENTION_MASK, INPUT_IDS, OUTPUT, bert_base
from .profile_serving import device_us

REQUESTS = (1, 8, 32)
SEQ_LEN = 128


def request(rng, n: int, seq_len: int = SEQ_LEN, vocab: int = 30522) -> dict:
    """``n`` sequences of ``seq_len`` ids with ragged valid lengths
    (uniform in 1..seq_len, padding id 0 past them) and their masks."""
    lengths = rng.integers(1, seq_len + 1, n)
    mask = (np.arange(seq_len)[None, :] < lengths[:, None]).astype(np.int32)
    ids = rng.integers(1, vocab, (n, seq_len)).astype(np.int32) * mask
    return {INPUT_IDS: ids, ATTENTION_MASK: mask}


def profile(sd, feeds: dict, reps: int = 3, walls: int = 10) -> dict:
    """The serving time split of ``sd.output(feeds, [OUTPUT])`` on the
    card (see the module docstring)."""
    n = feeds[INPUT_IDS].shape[0]
    ts = []
    for _ in range(walls):
        t0 = time.perf_counter()
        sd.output(feeds, [OUTPUT])
        ts.append((time.perf_counter() - t0) * 1e3)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts):
        sd.output(feeds, [OUTPUT])
    before = k3.launches
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            sd.output(feeds, [OUTPUT])
    launches = (k3.launches - before) / reps
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and device_us(e) > 0]
    dev = sum(device_us(e) for e in kernels) / 1e3 / reps
    k3_ms = sum(device_us(e) for e in kernels
                if "flash_attn_fwd_kernel" in e.key) / 1e3 / reps
    top = sorted(kernels, key=device_us, reverse=True)[:8]
    wall = statistics.median(ts)
    return {
        "request_sequences": n,
        "seq_len": int(feeds[INPUT_IDS].shape[1]),
        "wall_ms_median": wall,
        "device_ms": dev if kernels else None,
        "device_busy_share": dev / wall if kernels else None,
        "k3_device_ms": k3_ms if kernels else None,
        "k3_launches_per_request": launches,
        "sequences_per_s": n * 1e3 / wall,
        "top_kernels_ms": [[e.key[:70], device_us(e) / 1e3 / reps,
                            e.count // reps] for e in top],
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_bert: no CUDA device", file=sys.stderr)
        return 1
    old = env.Environment.instance().f32_matmul_precision
    env.Environment.instance().f32_matmul_precision = "highest"
    try:
        sd = bert_base(seed=0, device="cuda", seq_len=SEQ_LEN)
        report = fuse_attention(sd)
        rng = np.random.default_rng(0)
        for n in REQUESTS:
            row = profile(sd, request(rng, n))
            row["fusion"] = str(report)
            row["card"] = torch.cuda.get_device_name(0)
            print(json.dumps(row), flush=True)
    finally:
        env.Environment.instance().f32_matmul_precision = old
    return 0


if __name__ == "__main__":
    sys.exit(main())
