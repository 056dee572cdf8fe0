"""The device kernels one call of K1's, K2's, K7's, K9's or K10's wrapper,
or one ResNet-50 training step, launches, as ``torch.profiler`` records
them, in a process of its own.

    python3 -m deeplearning4j_tpu_torch.tools.count_kernels CASES

CASES is a JSON list of ``[kernel, shape, dtype]``: ``"K1"``, ``"K2"`` or
``"K7"`` with (rows, C), ``"K9"`` with (B, H, C, d), ``"K10"`` with (B, H,
k, C, d), ``"resnet50_fit"`` with (batch,), or ``"bert_fit"`` with (batch,
seq), and ``"float32"``, ``"bfloat16"`` or ``"float16"``. For each case the process makes random
operands (seed 0; ragged lengths for K9 and K10; K7 fed K6's mu and rstd,
made before the profiled window; K1 and K2 with scale and relu) and calls
the wrapper once to load its kernel, or, for ``resnet50_fit``, builds the
full-width ResNet-50 as ``tools/profile_train.py`` does and takes two
``fit`` steps on one random batch (for ``bert_fit``, the fused BERT-base
fine-tune of ``tools/profile_bert.py`` with ``set_dtype`` the case's
dtype); then one profiler session (CPU and
CUDA activities) records one more call of every case (one more ``fit``
step), each after a marker kernel (``torch.cuda._sleep``), and the device
kernels between two markers are that call's. It prints one JSON line: a
list of ``[kernel, shape, dtype, splits, names]`` (``splits`` is K9's
split count, K7's or K1's/K2's CTA count, and the batch of a step; a
step's ``names`` is ``{kernel name: launches}``, sorted by name).

Why a process of its own and one session: in a process that ran other
work first (``chip_smoke.py`` after its earlier phases, a pytest run of
the card tests), or in a later profiler session of the same process, the
profiler was seen to record none of these wrappers' kernels, while the
first session of a fresh process recorded every one. Needs one CUDA
card.
"""

from __future__ import annotations

import collections
import json
import subprocess
import sys
from pathlib import Path

import torch

from ..kernels import affine_act as k1
from ..kernels import decode_attention as k9
from ..kernels import layer_norm_act as k6
from ..kernels import multiquery_decode as k10


def _call(kernel: str, shape, dtype, gen):
    """A wrapper call on random operands of ``shape`` and ``dtype``."""
    dev = torch.device("cuda")
    if kernel == "resnet50_fit":
        return _fit_step(shape[0], dtype)
    if kernel == "bert_fit":
        return _bert_fit_step(*shape, dtype)
    if kernel in ("K1", "K2"):
        rows, cols = shape
        x, dy = (torch.randn(rows, cols, generator=gen, device=dev).to(dtype)
                 for _ in range(2))
        s = torch.rand(cols, generator=gen, device=dev) + 0.5
        b = torch.randn(cols, generator=gen, device=dev)
        if kernel == "K1":
            return lambda: k1.affine_act(x, s, b, "relu")
        return lambda: k1.affine_act_bwd(x, s, b, dy, "relu")
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


def _fit_step(batch: int, dtype):
    """One ``fit`` step of the full-width ResNet-50 (``profile_train``'s
    build: seed 0, precision ``highest``) on a random batch, after two."""
    import numpy as np
    from .. import environment as env
    from ..models import resnet50
    env.Environment.instance().f32_matmul_precision = "highest"
    dt = {torch.float32: "FLOAT", torch.bfloat16: "BFLOAT16"}[dtype]
    net = resnet50(seed=0, dtype=dt).init(device="cuda")
    rng = np.random.default_rng(2)
    x = rng.standard_normal((batch, 224, 224, 3), dtype=np.float32)
    y = np.eye(1000, dtype=np.float32)[rng.integers(0, 1000, batch)]
    for _ in range(2):
        net.fit(x, y)
    return lambda: net.fit(x, y)


def _bert_fit_step(batch: int, seq: int, dtype):
    """One ``SameDiff.fit`` step of the fused BERT-base fine-tune
    (``profile_bert.build("fusable")`` with the classifier head, seed 0,
    precision ``highest``) under ``set_dtype`` of ``dtype``, on one
    seeded batch, after two."""
    import numpy as np
    from .. import environment as env
    from ..models.bert import attach_classifier_head, fine_tune_feeds
    from . import profile_bert
    env.Environment.instance().f32_matmul_precision = "highest"
    sd, _ = profile_bert.build("fusable")
    attach_classifier_head(sd, seed=0)
    sd.set_dtype({torch.float32: "FLOAT", torch.bfloat16: "BFLOAT16"}[dtype])
    feeds = fine_tune_feeds(np.random.default_rng(7), batch, seq)
    sd.fit(feeds, epochs=2)
    return lambda: sd.fit(feeds)


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
        if kernel in ("resnet50_fit", "bert_fit"):
            splits = shape[0]
            names = dict(sorted(collections.Counter(names).items()))
        elif kernel in ("K1", "K2"):
            lay = k1.layout(*shape, k1.vector_width(getattr(torch, dtype)),
                            sms, backward=kernel == "K2")
            splits = lay["tiles"] * lay["groups"]
        elif kernel == "K7":
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
