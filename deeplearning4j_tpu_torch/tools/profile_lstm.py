"""Where a TextGenerationLSTM serving request, a generated character and
a training step spend their time on the card.

    python3 -m deeplearning4j_tpu_torch.tools.profile_lstm

Builds TextGenerationLSTM at the zoo's width (vocab 77, two
``LSTM(256, use_pallas_cell=True)``, ``RnnOutputLayer(77)``, float32,
random weights from seed 0) as a MultiLayerNetwork on ``cuda`` and, for
requests of 1, 8 and 32 one-hot sequences of 200 characters with ragged
lengths drawn from the seed (time bucket 256), prints one JSON line each:
the wall time of one ``InferenceEngine.output`` (median of 10, host clock,
the copy of the result back to the host included), sequences and
characters per second, the device time of the kernels it ran
(``torch.profiler`` over 3 requests, after one profiled request that pays
the tracer's start-up), the device's busy share (device time over the
unprofiled wall time), K8's device time and launches, and the kernels
that took the most device time. Then one more line for greedy generation
through ``rnn_time_step``: 8 streams after a 50-character prompt, the wall
time of one generated character (median over 300), characters per second
and the same device split over 20 characters. Then one line for
training: the same net built with the truncated-BPTT window of DL4J's
zoo ``TextGenerationLSTM.java`` (``tbptt_length(50)``) and trained through
``MultiLayerNetwork.fit`` on batches of 32 x 200 one-hot characters of an
order-2 Markov text drawn from the seed (``markov_text``): the wall time
of one step (median, host clock, ``score()``'s sync included), characters
per second, the device time of a step and its busy share, and the kernels
that took the most device time. Precision ``highest`` (TF32 off). Needs
one CUDA card.
"""

from __future__ import annotations

import json
import statistics
import sys
import time

import numpy as np
import torch

from .. import environment as env
from ..kernels import lstm_cell as k8
from ..nn.config import InputType, NeuralNetConfiguration
from ..nn.layers.recurrent import LSTM, RnnOutputLayer
from ..nn.model import MultiLayerNetwork
from ..nn.updaters import Adam
from .profile_serving import device_us

VOCAB = 77
UNITS = 256
REQUESTS = (1, 8, 32)
SEQ_LEN = 200
STREAMS = 8
PROMPT = 50
GEN_STEPS = 300
#: K8's CUDA function
K8_KERNEL = "lstm_cell_kernel"
#: training: DL4J's zoo TextGenerationLSTM.java truncated-BPTT window, the
#: batch of fit steps, and the Markov text's successors per context
TBPTT = 50
FIT_BATCH = 32
FIT_STEPS = 30
SUCCESSORS = 4


def build(seed: int = 0, device=None, tbptt=None) -> MultiLayerNetwork:
    """TextGenerationLSTM's layer list (``models.zoo.text_generation_lstm``)
    with the fused cell switched on, as a user of the JAX package writes
    it, initialized on ``device`` (``cuda`` unless asked for ``cpu``).
    ``tbptt`` is the truncated-BPTT window: None to serve, ``TBPTT`` (DL4J
    zoo ``TextGenerationLSTM.java``: tBPTTForwardLength 50) to train."""
    conf = (NeuralNetConfiguration.builder().seed(seed)
            .updater(Adam(learning_rate=1e-3))
            .input_type(InputType.recurrent(VOCAB))
            .tbptt_length(tbptt)
            .list(LSTM(n_out=UNITS, use_pallas_cell=True),
                  LSTM(n_out=UNITS, use_pallas_cell=True),
                  RnnOutputLayer(n_out=VOCAB))
            .build())
    return MultiLayerNetwork(conf).init(device=device)


def markov_text(seed: int, batches: int):
    """``batches`` training batches ``(x, y)`` of ``FIT_BATCH`` one-hot
    sequences of ``SEQ_LEN`` characters and their next characters: each
    row is a stream of an order-2 Markov chain over the ``VOCAB`` symbols
    (every pair of symbols has ``SUCCESSORS`` successors, drawn with Zipf
    weights over the symbols, taken with probabilities 0.7, 0.15, 0.1 and
    0.05), so the loss has to fall from ln(77)."""
    rng = np.random.default_rng(seed)
    zipf = 1.0 / np.arange(1, VOCAB + 1)
    succ = np.stack([rng.choice(VOCAB, SUCCESSORS, replace=False,
                                p=zipf / zipf.sum())
                     for _ in range(VOCAB * VOCAB)])
    cum = np.cumsum([0.7, 0.15, 0.1, 0.05])
    n = batches * SEQ_LEN + 1
    ids = np.empty((FIT_BATCH, n), np.int64)
    ids[:, :2] = rng.integers(0, VOCAB, (FIT_BATCH, 2))
    draws = np.searchsorted(cum, rng.random((FIT_BATCH, n)) * cum[-1])
    for t in range(2, n):
        ids[:, t] = succ[ids[:, t - 2] * VOCAB + ids[:, t - 1],
                         draws[:, t]]
    eye = np.eye(VOCAB, dtype=np.float32)
    return [(eye[ids[:, i * SEQ_LEN:(i + 1) * SEQ_LEN]],
             eye[ids[:, i * SEQ_LEN + 1:(i + 1) * SEQ_LEN + 1]])
            for i in range(batches)]


def one_hot(ids) -> np.ndarray:
    return np.eye(VOCAB, dtype=np.float32)[np.asarray(ids)]


def request(rng, n: int, seq_len: int = SEQ_LEN):
    """``(x, lengths)``: ``n`` one-hot sequences of ``seq_len`` characters
    (drawn uniformly, end padding included) and their true lengths,
    uniform in 1..seq_len with the first row full."""
    x = one_hot(rng.integers(0, VOCAB, (n, seq_len)))
    lengths = rng.integers(1, seq_len + 1, n)
    lengths[0] = seq_len
    return x, lengths


def generate(net, prompt: np.ndarray, steps: int):
    """Greedy generation through ``rnn_time_step`` from a cleared stream:
    the prompt ``[B, T0, VOCAB]`` as one chunk, then ``steps`` single
    characters, each the argmax of the previous output. Returns ``(outputs
    [B, T0 + steps, VOCAB], inputs [B, T0 + steps, VOCAB])``; the wall
    times of the single steps are in ``generate.step_ms``."""
    net.rnn_clear_previous_state()
    outs = [net.rnn_time_step(prompt)]
    ins = [prompt]
    step_ms = []
    nxt = one_hot(outs[0][:, -1].argmax(-1))
    for _ in range(steps):
        t0 = time.perf_counter()
        y = net.rnn_time_step(nxt)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        ins.append(nxt[:, None])
        outs.append(y[:, None])
        nxt = one_hot(y.argmax(-1))
    generate.step_ms = step_ms
    return np.concatenate(outs, axis=1), np.concatenate(ins, axis=1)


def _device_kernels(prof):
    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and device_us(e) > 0]


def _kernel_split(prof, reps):
    """Device ms per repetition: all kernels, K8, the top 8."""
    kernels = _device_kernels(prof)
    dev = sum(device_us(e) for e in kernels) / 1e3 / reps
    lstm = sum(device_us(e) for e in kernels if K8_KERNEL in e.key) \
        / 1e3 / reps
    top = sorted(kernels, key=device_us, reverse=True)[:8]
    return dev, lstm, [[e.key[:70], device_us(e) / 1e3 / reps,
                        e.count // reps] for e in top]


#: profiled windows tried before a split is given up: the tracer has been
#: seen to return a window with no device records
PROFILE_ATTEMPTS = 3


def _profiled(fn, reps):
    """``(profile, K8 launches per call, calls of fn made)``: one call under
    a profiler that pays the tracer's start-up, then ``reps`` calls under
    the one that is read. A window with no device records is taken again,
    up to ``PROFILE_ATTEMPTS`` times; raises if none has any."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    calls = 0
    for _ in range(PROFILE_ATTEMPTS):
        with torch.profiler.profile(activities=acts):
            fn()
        before = k8.launches
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(reps):
                fn()
        calls += 1 + reps
        if any(e.device_type == torch.autograd.DeviceType.CUDA
               and device_us(e) > 0 for e in prof.key_averages()):
            return prof, (k8.launches - before) / reps, calls
    raise RuntimeError(f"torch.profiler recorded no device time in "
                       f"{PROFILE_ATTEMPTS} windows")


def profile(net, x, lengths, reps: int = 3, walls: int = 10) -> dict:
    """The serving time split of one ``InferenceEngine.output(x,
    lengths=)`` on the card (see the module docstring)."""
    eng = net.inference_engine()
    ts = []
    for _ in range(walls):
        t0 = time.perf_counter()
        eng.output(x, lengths=lengths)
        ts.append((time.perf_counter() - t0) * 1e3)
    prof, launches, calls = _profiled(lambda: eng.output(x, lengths=lengths),
                                      reps)
    dev, lstm, top = _kernel_split(prof, reps)
    wall = statistics.median(ts)
    n = x.shape[0]
    return {
        "request_sequences": n,
        "seq_len": int(x.shape[1]),
        "characters": int(np.sum(lengths)),
        "wall_ms_median": wall,
        "device_ms": dev if top else None,
        "device_busy_share": dev / wall if top else None,
        "k8_device_ms": lstm if top else None,
        "k8_launches_per_request": launches,
        "requests_run": walls + calls,
        "sequences_per_s": n * 1e3 / wall,
        "characters_per_s": float(np.sum(lengths)) * 1e3 / wall,
        "top_kernels_ms": top,
    }


def profile_generation(net, prompt: np.ndarray, steps: int = GEN_STEPS,
                       reps: int = 20) -> dict:
    """The time split of one generated character per stream (see the
    module docstring). Leaves the stream after ``steps`` characters."""
    generate(net, prompt, steps)
    wall = statistics.median(generate.step_ms)
    nxt = one_hot(np.zeros(prompt.shape[0], np.int64))
    prof, launches, _ = _profiled(lambda: net.rnn_time_step(nxt), reps)
    dev, lstm, top = _kernel_split(prof, reps)
    return {
        "streams": int(prompt.shape[0]),
        "prompt": int(prompt.shape[1]),
        "steps": steps,
        "step_wall_ms_median": wall,
        "characters_per_s": prompt.shape[0] * 1e3 / wall,
        "device_ms": dev if top else None,
        "device_busy_share": dev / wall if top else None,
        "k8_device_ms": lstm if top else None,
        "k8_launches_per_step": launches,
        "top_kernels_ms": top,
    }


def profile_fit(net, batches, reps: int = 3) -> dict:
    """The time split of one ``fit`` step on ``(x, y)`` batches (see the
    module docstring): the wall time and loss of a step on each of
    ``batches`` (the first step left out of the median), then the device
    split of ``reps`` more steps under the profiler."""
    from ..data.dataset import DataSet
    sets = [DataSet(x, y) for x, y in batches]
    ts, losses = [], []
    for ds in sets:
        t0 = time.perf_counter()
        net.fit(ds)
        losses.append(net.score())  # the host sync of a step
        ts.append((time.perf_counter() - t0) * 1e3)
    wall = statistics.median(ts[1:] if len(ts) > 1 else ts)
    prof, launches, _ = _profiled(lambda: (net.fit(sets[0]), net.score()),
                                  reps)
    dev, lstm, top = _kernel_split(prof, reps)
    chars = sets[0].features.shape[0] * sets[0].features.shape[1]
    return {
        "batch": int(sets[0].features.shape[0]),
        "seq_len": int(sets[0].features.shape[1]),
        "tbptt_length": net.conf.tbptt_length,
        "steps": len(ts),
        "losses": losses,
        "step_wall_ms_median": wall,
        "characters_per_s": chars * 1e3 / wall,
        "device_ms": dev if top else None,
        "device_busy_share": dev / wall if top else None,
        "device_kernels_per_step": sum(
            e.count for e in _device_kernels(prof)) / reps,
        "k8_launches_per_step": launches,
        "top_kernels_ms": top,
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_lstm needs a CUDA card", file=sys.stderr)
        return 1
    env.Environment.instance().f32_matmul_precision = "highest"
    net = build(seed=0, device="cuda")
    rng = np.random.default_rng(0)
    net.inference_engine().warmup(REQUESTS, seq_buckets=[SEQ_LEN])
    for n in REQUESTS:
        x, lengths = request(rng, n)
        print(json.dumps(profile(net, x, lengths)), flush=True)
    prompt = one_hot(rng.integers(0, VOCAB, (STREAMS, PROMPT)))
    print(json.dumps(profile_generation(net, prompt)), flush=True)
    fit_net = build(seed=0, device="cuda", tbptt=TBPTT)
    print(json.dumps(profile_fit(fit_net, markov_text(0, 8))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
