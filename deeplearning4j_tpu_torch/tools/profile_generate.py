"""Where a generative serving run spends its time on the card.

    python3 -m deeplearning4j_tpu_torch.tools.profile_generate

Builds the JAX package's generative-serving model (``bench.py::
bench_generative_serving``: one-hot tokens, V = 256, three
``SelfAttentionLayer(n_out=256, n_heads=4)`` blocks, the first two each
followed by ``DenseLayer(512, relu)`` and ``DenseLayer(256)``, the last by
``OutputLayer(256, softmax)``; float32, random weights from seed 0) as a
MultiLayerNetwork on ``cuda`` and serves five request mixes through
``ContinuousBatcher``, printing one JSON line each:

- ``bench``: 8 slots, cache bucket 128, the bench's 8 prompts of 56-64
  tokens (numpy seed 0), 48 new tokens each;
- ``grow``: 32 slots, cache buckets 256 to 1024, 32 prompts of 200-480
  tokens (numpy seed 1), 256 new tokens each, so the caches grow 256 ->
  512 -> 1024 while the batch decodes;
- ``paged``: the bench's paged prefix-sharing mix (``bench.py:1738-1763``):
  ``paged=True, page_size=16`` (65 pages), 8 streams of ONE 90-token
  system prompt (drawn after the bench's prompts from the same seed), 16
  new tokens each: the first admission prefills and registers the prompt,
  the others map its pages and fork the partial last page;
- ``spec``: the bench's speculative mix (``bench.py:1788-1793``), the
  paged mix with ``draft_model=net, speculate_k=4`` (the target is its own
  draft);
- ``spec_grow``: the growth mix made paged and speculative
  (``page_size=16``, ``speculate_k=4``, the target as its own draft).

Each line holds the wall time of serving the whole mix (host clock from
the first submit to the last result, median of 3), generated tokens per
second, TTFT and TPOT p50/p99 (ms) over those runs, the engine's prefills,
decode and verify steps and the draft's decode steps per run, the page
pool's and the speculation's counters where the mix has them, and for one
more run under ``torch.profiler``: the device time, the busy share (device
time over the median wall), the device time of K9 (``csrc/decode_attn.cu``),
of K10 (``csrc/mq_decode_attn.cu``) and of K3 (``csrc/flash_attn_fwd.cu``),
one kernel a call each, and the kernels that took the most device time.
Precision ``highest`` (TF32 off). Needs one CUDA card.
"""

from __future__ import annotations

import json
import statistics
import sys
import time

import numpy as np
import torch

from .. import environment as env
from ..nn.config import InputType, NeuralNetConfiguration
from ..nn.layers.attention import SelfAttentionLayer
from ..nn.layers.core import DenseLayer, OutputLayer
from ..nn.model import MultiLayerNetwork
from .profile_serving import device_us

VOCAB = 256
HEADS = 4
#: the bench's mix (bench.py:1645-1661)
BENCH = dict(slots=8, max_cache_len=128, min_cache_len=128,
             max_new_tokens=48)
BENCH_PROMPTS = (8, 56, 65, 0)   # (count, low, high + 1, numpy seed)
#: the growth mix
GROW = dict(slots=32, max_cache_len=1024, min_cache_len=256,
            max_new_tokens=256)
GROW_PROMPTS = (32, 200, 481, 1)
#: the bench's paged prefix mix (bench.py:1738-1763) and its system prompt
PAGED = dict(BENCH, max_new_tokens=16, paged=True, page_size=16)
SYSTEM_PROMPT_LEN = 90
#: the window a draft proposes and the target verifies (bench.py:1792)
SPECULATE_K = 4
#: the growth mix made paged and speculative
GROW_PAGED = dict(GROW, paged=True, page_size=16)
#: K9's, K10's and K3's CUDA kernels
K9_KERNEL = "decode_attn_kernel"
K10_KERNEL = "mq_decode_kernel"
K3_KERNEL = "flash_attn_fwd_kernel"
#: a greedy card token may differ from the CPU's argmax only where the
#: CPU's top two probabilities are closer than this share of the top one:
#: the card's probabilities differ from the CPU's by about 1e-7 of their
#: size (float32 on both, sums in other orders), and with random weights
#: the 256 outputs are nearly uniform, so the gaps themselves are small
TIE_TOL = 1e-5


def build(seed: int = 0, device=None) -> MultiLayerNetwork:
    """The bench's generative model (``bench.py:1645-1656``), initialized
    on ``device`` (``cuda`` unless asked for ``cpu``)."""
    conf = (NeuralNetConfiguration.builder().seed(seed)
            .input_type(InputType.recurrent(VOCAB, 32))
            .list(SelfAttentionLayer(n_out=VOCAB, n_heads=HEADS),
                  DenseLayer(n_out=512, activation="relu"),
                  DenseLayer(n_out=VOCAB, activation="identity"),
                  SelfAttentionLayer(n_out=VOCAB, n_heads=HEADS),
                  DenseLayer(n_out=512, activation="relu"),
                  DenseLayer(n_out=VOCAB, activation="identity"),
                  SelfAttentionLayer(n_out=VOCAB, n_heads=HEADS),
                  OutputLayer(n_out=VOCAB, activation="softmax"))
            .build())
    return MultiLayerNetwork(conf).init(device=device)


def prompts(count: int, low: int, high: int, seed: int) -> list:
    """``count`` one-hot prompts ``[plen, VOCAB]``, plen uniform in [low,
    high), tokens uniform; the bench's draw order (``bench.py:1658-1661``)."""
    rng = np.random.default_rng(seed)
    plens = rng.integers(low, high, count)
    eye = np.eye(VOCAB, dtype=np.float32)
    return [eye[rng.integers(0, VOCAB, int(p))] for p in plens]


def system_prompt_mix() -> list:
    """The paged mix's 8 copies of one 90-token system prompt: drawn with
    the bench's generator after its 8 prompts (``bench.py:1658-1661``,
    :1745-1746)."""
    count, low, high, seed = BENCH_PROMPTS
    rng = np.random.default_rng(seed)
    plens = rng.integers(low, high, count)
    for p in plens:
        rng.integers(0, VOCAB, int(p))
    prompt = np.eye(VOCAB, dtype=np.float32)[
        rng.integers(0, VOCAB, SYSTEM_PROMPT_LEN)]
    return [prompt] * count


def mixes(net) -> dict:
    """``{name: (ContinuousBatcher keyword arguments, prompts)}`` of the
    five mixes; the speculative ones draft with the target itself."""
    spec = dict(draft_model=net, speculate_k=SPECULATE_K)
    grow = prompts(*GROW_PROMPTS)
    return {"bench": (BENCH, prompts(*BENCH_PROMPTS)),
            "grow": (GROW, grow),
            "paged": (PAGED, system_prompt_mix()),
            "spec": (dict(PAGED, **spec), system_prompt_mix()),
            "spec_grow": (dict(GROW_PAGED, **spec), grow)}


def serve(cb, mix) -> tuple:
    """Submit every prompt of ``mix`` at once and wait for all: ``(token
    streams, last-step logits, wall seconds)``."""
    t0 = time.perf_counter()
    handles = [cb.submit(prompt=p) for p in mix]
    res = [h.result(timeout=300) for h in handles]
    wall = time.perf_counter() - t0
    return [r["tokens"] for r in res], [r["logits"] for r in res], wall


def _kernel_split(prof):
    """Device ms of all kernels, of K9, of K10, of K3, and the top 8."""
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and device_us(e) > 0]

    def ms(name):
        return sum(device_us(e) for e in kernels if name in e.key) / 1e3

    top = sorted(kernels, key=device_us, reverse=True)[:8]
    return (sum(device_us(e) for e in kernels) / 1e3, ms(K9_KERNEL),
            ms(K10_KERNEL), ms(K3_KERNEL),
            [[e.key[:70], device_us(e) / 1e3, e.count] for e in top])


def profile(cb, mix, runs: int = 3) -> dict:
    """The time split of serving ``mix`` through ``cb`` (see the module
    docstring). Returns the streams of the first run too."""
    eng, draft = cb.engine, cb.draft
    walls, streams, logits = [], None, None
    p0, d0 = eng.prefill_runs, eng.decode_steps
    v0 = getattr(eng, "verify_steps", 0)
    dd0 = draft.decode_steps if draft is not None else 0
    for _ in range(runs):
        s, lg, wall = serve(cb, mix)
        if streams is None:
            streams, logits = s, lg
        elif s != streams:
            raise AssertionError("greedy streams differ between runs")
        walls.append(wall)
    prefills = (eng.prefill_runs - p0) / runs
    steps = (eng.decode_steps - d0) / runs
    verify = (getattr(eng, "verify_steps", 0) - v0) / runs
    draft_steps = ((draft.decode_steps if draft is not None else 0)
                   - dd0) / runs
    st = cb.stats()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts):
        serve(cb, mix[:1])  # the tracer's start-up
    with torch.profiler.profile(activities=acts) as prof:
        serve(cb, mix)
    dev, k9, k10, k3, top = _kernel_split(prof)
    wall = statistics.median(walls)
    tokens = sum(len(t) for t in streams)
    return {
        "slots": cb.slots, "requests": len(mix),
        "prompt_tokens": [int(min(len(p) for p in mix)),
                          int(max(len(p) for p in mix))],
        "new_tokens": tokens, "final_cache_len": cb.stats()["cache_len"],
        "wall_ms_median": wall * 1e3, "walls_ms": [w * 1e3 for w in walls],
        "tokens_per_s": tokens / wall,
        "ttft_ms_p50": st["ttft_ms_p50"], "ttft_ms_p99": st["ttft_ms_p99"],
        "tpot_ms_p50": st["tpot_ms_p50"], "tpot_ms_p99": st["tpot_ms_p99"],
        "prefills_per_run": prefills, "decode_steps_per_run": steps,
        "verify_steps_per_run": verify, "draft_steps_per_run": draft_steps,
        "dispatch_decisions": st["dispatch_decisions"],
        "page_pool": st.get("page_pool"),
        "speculative": st.get("speculative"),
        "device_ms": dev if top else None,
        "device_busy_share": dev / (wall * 1e3) if top else None,
        "k9_device_ms": k9 if top else None,
        "k10_device_ms": k10 if top else None,
        "k3_device_ms": k3 if top else None,
        "top_kernels_ms": top,
        "streams": streams, "last_logits": logits,
    }


def teacher_forced(cpu_net, prompt, tokens, last_logits) -> dict:
    """Feed the card's stream to the CPU plain path (one full-context
    forward under the prefix-LM mask): ``violations`` counts the card
    tokens that are not the CPU's argmax where the CPU's top-2 gap is at
    least ``TIE_TOL`` of the top probability (0 passes), ``near_ties`` the
    steps below it, and ``last_rel_err`` compares the card's last-step
    probabilities with the CPU's (max |diff| / max |cpu|)."""
    eye = np.eye(VOCAB, dtype=np.float32)
    plen, n = len(prompt), len(tokens)
    seq = np.concatenate([prompt, eye[np.asarray(tokens[:-1], np.int64)]])
    with torch.inference_mode():
        y = cpu_net._full_context(
            cpu_net.params, torch.from_numpy(seq[None]), cpu_net.state,
            torch.tensor([plen]), torch.tensor([len(seq)]))[0].numpy()
    steps = y[plen - 1:plen - 1 + n]
    top2 = np.sort(steps, axis=-1)[:, -2:]
    gap = (top2[:, 1] - top2[:, 0]) / np.abs(top2[:, 1])
    wrong = np.asarray(tokens) != steps.argmax(-1)
    last = np.asarray(last_logits, np.float64)
    return {"violations": int((wrong & (gap >= TIE_TOL)).sum()),
            "near_ties": int((gap < TIE_TOL).sum()),
            "min_gap": float(gap.min()),
            "last_rel_err": float(np.abs(last - steps[-1]).max()
                                  / np.abs(steps[-1]).max())}


def cpu_copy(net) -> MultiLayerNetwork:
    """The same weights in a MultiLayerNetwork on the CPU (the plain
    path)."""
    cpu = MultiLayerNetwork(net.conf).init(device="cpu")
    cpu.params = {v: {k: t.cpu() for k, t in p.items()}
                  for v, p in net.params.items()}
    return cpu


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_generate needs a CUDA card", file=sys.stderr)
        return 1
    from ..serving.batcher import ContinuousBatcher
    env.Environment.instance().f32_matmul_precision = "highest"
    net = build(seed=0, device="cuda")
    for name, (kw, mix) in mixes(net).items():
        cb = ContinuousBatcher(net, **kw)
        try:
            row = profile(cb, mix)
        finally:
            cb.shutdown()
        row.pop("streams")
        row.pop("last_logits")
        print(json.dumps({"mix": name, **row}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
