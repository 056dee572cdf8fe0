"""Where a BERT-base serving request and a fine-tune step spend their time
on the card.

    python3 -m deeplearning4j_tpu_torch.tools.profile_bert [--spelling fusable]

Builds BERT-base (HF ``BertConfig()`` geometry, float32, random weights
from seed 0, sequence length 128) as a SameDiff graph on ``cuda``, fuses
its 12 attention sites (``fuse_attention``) and, for requests of 1, 8 and
32 sequences with ragged attention masks drawn from the seed, prints one
JSON line each: the wall time of one ``sd.output`` (median of 10, host
clock, the copy of the result back to the host included), the device time
of the kernels it ran (``torch.profiler`` over 3 requests, after one
profiled request that pays the tracer's start-up), the device's busy
share (device time over the unprofiled wall time), K3's device time and
launches, and the kernels that took the most device time. Then it
attaches the fine-tune head (``models.bert.attach_classifier_head``: mean
pool, 2 classes, softmax cross entropy, Adam(2e-5)) and prints one more
line for a ``sd.fit`` step on one fixed batch of 32 sequences
(``fine_tune_feeds``): the step's wall time (median of 11 after one
warm-up step, host clock between the steps of one ``fit`` call, each
ending in a synchronize), sequences per second, the device time per step
and busy share (``torch.profiler`` over 3 steps), the device time and
launches of K3 and of the fused backward (K4 + K5, one launch writing dq,
dk and dv), and the top kernels. Precision ``highest``
(TF32 off). Needs one CUDA card.

``--spelling fusable`` records the graph in the spelling
``fuse_epilogues`` rewrites (``models.bert.bert(..., spelling=
"fusable")``), runs ``fuse_attention`` and ``fuse_epilogues`` and prints
both FusionReports; each line then also splits out the device time and
launches of K6 and K1 (a request: 25 and 12) and of K7 and K2 (a fine-tune
step: 25 and 12, beside 25 K6 and 12 K1).
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import numpy as np
import torch

from .. import environment as env
from ..autodiff.fusion import fuse_attention, fuse_epilogues
from ..kernels import affine_act as k1
from ..kernels import flash_attention as k3
from ..kernels import layer_norm_act as k6
from ..models.bert import (ATTENTION_MASK, INPUT_IDS, OUTPUT,
                           attach_classifier_head, bert_base,
                           fine_tune_feeds)
from .profile_serving import device_us

REQUESTS = (1, 8, 32)
SEQ_LEN = 128
FIT_BATCH = 32
#: the hand-written kernels of the BERT paths, by the name of their CUDA
#: functions (K2 and K7 are two functions each: partial sums and total;
#: "bwd" is the fused flash-attention backward, K4 + K5 in one kernel)
KERNELS = {"k3": ("flash_attn_fwd_kernel",),
           "bwd": ("flash_attn_bwd_",),
           "k6": ("layer_norm_act_kernel",),
           "k7": ("layer_norm_act_bwd_",),
           "k1": ("affine_act_kernel",),
           "k2": ("affine_act_bwd_",)}


def launch_counts() -> dict:
    """The wrappers' launch counters, by kernel: ``bwd`` counts launches of
    the fused flash-attention backward, ``k4`` and ``k5`` those of them
    that wrote dq, and dk and dv."""
    return {"k3": k3.launches, "bwd": k3.launches_bwd, "k4": k3.launches_dq,
            "k5": k3.launches_dkv, "k6": k6.launches, "k7": k6.bwd_launches,
            "k1": k1.launches, "k2": k1.bwd_launches}


def build(spelling: str = "tf", seed: int = 0, seq_len: int = SEQ_LEN):
    """BERT-base on ``cuda`` in ``spelling``, fused: ``(sd, reports)``,
    the FusionReports of ``fuse_attention`` and, for ``"fusable"``,
    ``fuse_epilogues``."""
    sd = bert_base(seed=seed, device="cuda", seq_len=seq_len,
                   spelling=spelling)
    reports = {"attention": fuse_attention(sd)}
    if spelling == "fusable":
        reports["epilogues"] = fuse_epilogues(sd)
    return sd, reports


def request(rng, n: int, seq_len: int = SEQ_LEN, vocab: int = 30522) -> dict:
    """``n`` sequences of ``seq_len`` ids with ragged valid lengths
    (uniform in 1..seq_len, padding id 0 past them) and their masks: the
    inputs of :func:`fine_tune_feeds` without its labels."""
    feeds = fine_tune_feeds(rng, n, seq_len, vocab)
    return {INPUT_IDS: feeds[INPUT_IDS], ATTENTION_MASK: feeds[ATTENTION_MASK]}


def _kernel_split(prof, reps):
    """Device ms per step: all kernels, each of :data:`KERNELS`, the top
    8."""
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and device_us(e) > 0]
    dev = sum(device_us(e) for e in kernels) / 1e3 / reps
    split = {k: sum(device_us(e) for e in kernels
                    if any(n in e.key for n in names)) / 1e3 / reps
             for k, names in KERNELS.items()}
    top = sorted(kernels, key=device_us, reverse=True)[:8]
    return dev, split, [[e.key[:70], device_us(e) / 1e3 / reps,
                         e.count // reps] for e in top]


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
    before = launch_counts()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            sd.output(feeds, [OUTPUT])
    launches = {k: (v - before[k]) / reps for k, v in launch_counts().items()}
    dev, split, top = _kernel_split(prof, reps)
    wall = statistics.median(ts)
    row = {
        "request_sequences": n,
        "seq_len": int(feeds[INPUT_IDS].shape[1]),
        "wall_ms_median": wall,
        "device_ms": dev if top else None,
        "device_busy_share": dev / wall if top else None,
        "sequences_per_s": n * 1e3 / wall,
        "top_kernels_ms": top,
    }
    for k in ("k3", "k6", "k1"):
        row[f"{k}_device_ms"] = split[k] if top else None
        row[f"{k}_launches_per_request"] = launches[k]
    return row


class StepTimer:
    """A ``fit`` listener: synchronizes the card after each step and keeps
    the host clock, so consecutive readings bracket one whole step."""

    def __init__(self):
        self.marks = [time.perf_counter()]

    def iteration_done(self, model, iteration, epoch):
        torch.cuda.synchronize()
        self.marks.append(time.perf_counter())

    def on_epoch_end(self, model):
        pass

    def step_ms(self):
        return [(b - a) * 1e3 for a, b in zip(self.marks, self.marks[1:])]


def profile_fit(sd, feeds: dict, reps: int = 3, walls: int = 11,
                listeners=()) -> dict:
    """The time split of one ``sd.fit`` step on ``feeds`` (see the module
    docstring); ``sd`` has its loss and updater set. Trains ``sd``: one
    ``fit`` call of ``walls + 1`` steps (``listeners`` see those), then
    ``1 + reps`` profiled steps."""
    n = feeds[INPUT_IDS].shape[0]
    timer = StepTimer()
    torch.cuda.synchronize()
    timer.marks = [time.perf_counter()]
    losses = sd.fit(feeds, epochs=walls + 1,
                    listeners=[timer, *listeners]).losses
    wall = statistics.median(timer.step_ms()[1:])
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts):
        sd.fit(feeds)
    before = launch_counts()
    with torch.profiler.profile(activities=acts) as prof:
        sd.fit(feeds, epochs=reps)
        torch.cuda.synchronize()
    launches = {k: (v - before[k]) / reps for k, v in launch_counts().items()}
    dev, split, top = _kernel_split(prof, reps)
    row = {
        "fit_batch": n,
        "seq_len": int(feeds[INPUT_IDS].shape[1]),
        "step_ms_median": wall,
        "sequences_per_s": n * 1e3 / wall,
        "device_ms": dev,
        "device_busy_share": dev / wall,
        "launches_per_step": launches,
        "losses": losses,
        "top_kernels_ms": top,
    }
    for k in KERNELS:
        row[f"{k}_device_ms"] = split[k]
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--spelling", choices=("tf", "fusable"), default="tf",
                    help="the graph's spelling (models.bert.bert); "
                         "'fusable' also runs fuse_epilogues")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_bert: no CUDA device", file=sys.stderr)
        return 1
    old = env.Environment.instance().f32_matmul_precision
    env.Environment.instance().f32_matmul_precision = "highest"
    try:
        sd, reports = build(args.spelling)
        fusion = {k: {"report": str(r), "kinds": dict(
            (kind, r.kinds.count(kind)) for kind in sorted(set(r.kinds)))}
            for k, r in reports.items()}
        rng = np.random.default_rng(0)
        for n in REQUESTS:
            row = profile(sd, request(rng, n))
            row["spelling"] = args.spelling
            row["fusion"] = fusion
            row["card"] = torch.cuda.get_device_name(0)
            print(json.dumps(row), flush=True)
        attach_classifier_head(sd, seed=0)
        row = profile_fit(sd, fine_tune_feeds(rng, FIT_BATCH, SEQ_LEN))
        row["spelling"] = args.spelling
        row["card"] = torch.cuda.get_device_name(0)
        print(json.dumps(row), flush=True)
    finally:
        env.Environment.instance().f32_matmul_precision = old
    return 0


if __name__ == "__main__":
    sys.exit(main())
