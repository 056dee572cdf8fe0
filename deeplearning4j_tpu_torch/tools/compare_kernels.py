"""K3, K7, K8, K9 and K10 of this checkout against those of another
checkout, timed in turns on one card.

    python3 -m deeplearning4j_tpu_torch.tools.compare_kernels --other DIR

DIR is another checkout of the repository (for instance the parent commit
unpacked with ``git archive``). Its ``csrc/flash_attn_fwd.cu``,
``csrc/layer_norm_act_bwd.cu``, ``csrc/lstm_cell.cu``,
``csrc/decode_attn.cu`` and ``csrc/mq_decode_attn.cu`` are compiled with
this checkout's ``nvcc`` flags into ``build/other/`` and loaded beside this
checkout's kernels. Then, on the same inputs (seed 0; TF32 off):

- K3 at BERT-base batch 32, (B, H, Tq, Tk, d) = (32, 12, 128, 128, 64),
  head-split operands and a ragged key bias, in float32 and bfloat16;
- K7 at ``chip_smoke.py``'s LayerNorm shapes [rows, C], identity (the
  fused BERT path's activation), fed K6's mu and rstd: the path's (4096,
  768) in float32 and bfloat16, the other six in float32, each line with
  an empty kernel launched as this checkout's K7 is (``floor_ms``) and, at
  the path's shape, ``native_layer_norm_backward`` on the same inputs
  (``library_ms``);
- K8 at TextGenerationLSTM's two layers at batch 32, (B, F, U) = (32, 77,
  256) and (32, 256, 256), float32, x read through a row stride, and the
  empty kernel launched as K8 (``lstm_cell.launch_floor``);
- K9 at ``chip_smoke.py``'s decode shapes (B, H, C, d), head-split q: the
  generative path's (8, 4, 128, 64) at the lengths of a decode step
  halfway through the bench's mix and the long (32, 12, 4096, 64) in
  float32 and bfloat16, the other five in float32;
- K10 at its verify shapes (B, H, k, C, d): the speculative mix's (8, 4,
  4, 128, 64), the speculative growth mix's (32, 4, 4, 1024, 64) and the
  long (32, 12, 4, 4096, 64) in float32 and bfloat16, the other four in
  float32;

each case is timed as other, this, this, other, ``--rounds`` times (CUDA
events around each call, calls queued behind a sleep kernel, median of
``--reps``), and printed as one JSON line with the card's name and power
limit, every reading, the two kernels' medians and their largest output
difference; K9 and K10 lines also carry the empty kernel launched as this
checkout's is (``floor_ms``) and, at the path shapes in float32,
``scaled_dot_product_attention`` with the same float mask (``sdpa_ms``).
A checkout from before K8's cluster design (no
``dl4j_lstm_cell_geometry``) takes a row tile where this one takes its copy
widths; one from before the one-launch K9 and K10 (no
``dl4j_decode_attn_floor``) takes f32 scratch for its split states and
its own split rule (at most 64 splits); one from before the one-launch K7
(no ``dl4j_layer_norm_act_bwd_floor``) takes its two-kernel grid
(``OLD_BWD_BLOCKS_PER_SM`` blocks an SM) and f32 partials. Needs one CUDA
card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import statistics
import subprocess
import time
from pathlib import Path

import torch

from ..kernels import _build
from ..kernels import decode_attention as k9
from ..kernels import layer_norm_act as k6
from ..kernels import lstm_cell as k8
from ..kernels import multiquery_decode as k10
from . import profile_generate as pg

ATTN_SHAPE = (32, 12, 128, 128, 64)
LSTM_SHAPES = ((32, 77, 256), (32, 256, 256))
FORGET_BIAS = 1.0
#: chip_smoke.py's K9 shapes (B, H, C, d) and K10 shapes (B, H, k, C, d);
#: the first of each is the path's, and the named ones run in bfloat16 too
DECODE_SHAPES = ((8, 4, 128, 64), (32, 4, 1024, 64), (32, 12, 512, 64),
                 (32, 12, 4096, 64), (4, 8, 2048, 128), (3, 2, 200, 32),
                 (32, 12, 64, 64))
DECODE_PATH_SHAPE, DECODE_LONG_SHAPE = DECODE_SHAPES[0], DECODE_SHAPES[3]
MQ_SHAPES = ((8, 4, 4, 128, 64), (32, 4, 4, 1024, 64), (32, 12, 4, 4096, 64),
             (8, 4, 2, 512, 64), (8, 4, 8, 512, 64), (3, 2, 4, 200, 32),
             (32, 12, 4, 64, 64))
MQ_PATH_SHAPE, MQ_GROW_SHAPE, MQ_LONG_SHAPE = MQ_SHAPES[:3]
#: a checkout from before the one-launch K9 and K10: its split cap
OLD_MAX_SPLITS = 64
#: chip_smoke.py's K6/K7 shapes [rows, C]; the first is the path's
LN_SHAPES = ((4096, 768), (256, 768), (128, 768), (77, 768), (4096, 1024),
             (33, 4096), (5, 37))
LN_EPS = 1e-12
#: a checkout from before the one-launch K7: its first stage's blocks an SM
OLD_BWD_BLOCKS_PER_SM = 4
_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


KERNEL_LIBS = ("flash_attn_fwd", "layer_norm_act_bwd", "lstm_cell",
               "decode_attn", "mq_decode_attn")


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]


def time_ms(fn, reps: int, warm: int = 3) -> float:
    """The median device time of one call of ``fn`` over ``reps`` calls
    (CUDA events around each; the calls are queued behind a sleep kernel,
    so the events bracket the device's work and not the host's)."""
    for _ in range(warm):
        fn()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)
    for a, b in ev:
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in ev)


#: the library each kernel's comparison needs
LIB_OF = {"K3": "flash_attn_fwd", "K7": "layer_norm_act_bwd",
          "K8": "lstm_cell", "K9": "decode_attn", "K10": "mq_decode_attn"}


def build_other(root: Path, names=KERNEL_LIBS) -> dict:
    """The other checkout's libraries ``names`` (default: K3's, K7's,
    K8's, K9's and K10's), built into build/other/."""
    out = _build.BUILD_DIR / "other"
    out.mkdir(parents=True, exist_ok=True)
    libs, procs = {}, []
    for name in names:
        src = root / "deeplearning4j_tpu_torch" / "csrc" / f"{name}.cu"
        lib = out / f"lib{name}-{time.time_ns()}.so"
        procs.append((name, lib, subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    for name, lib, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the other {name}:\n{log}")
        libs[name] = ctypes.CDLL(str(lib))
    return libs


def attn_fn(lib, q, k, v, kb, scale):
    """A call of ``lib``'s K3 entry (the signature both checkouts share)
    returning ``(o, m, l)``."""
    fn = lib.dl4j_flash_attn_fwd
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    B, H, Tq, d = q.shape
    Tk = k.shape[2]
    o = torch.empty_like(q)
    m = torch.empty((B * H, Tq), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    strides = (ctypes.c_longlong * 12)(*[
        s for t in (q, k, v, o) for s in t.stride()[:3]])
    code = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}[q.dtype]
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), kb.data_ptr(),
                o.data_ptr(), m.data_ptr(), l.data_ptr(), B, H, Tq, Tk, d,
                strides, scale, code, stream)
        if rc != 0:
            raise RuntimeError(f"K3 launch failed: CUDA error {rc}")
        return o, m, l
    return call


def ln_bwd_fn(lib, x, g, b, mu, rstd, dy):
    """A call of ``lib``'s K7 entry (identity) returning ``(dx, dgamma,
    dbeta)``: this checkout's one-launch layout and a workspace of its own
    where the library has a launch floor, else the two-kernel grid of a
    checkout from before the one-launch design (``blocks`` partial rows of
    f32)."""
    fn = lib.dl4j_layer_norm_act_bwd
    rows, cols = x.shape
    dev = x.device
    dx = torch.empty_like(x)
    dg, db = (torch.empty(cols, dtype=torch.float32, device=dev)
              for _ in range(2))
    ptrs = [x.data_ptr(), g.data_ptr(), b.data_ptr(), mu.data_ptr(),
            rstd.data_ptr(), dy.data_ptr(), dx.data_ptr(), dg.data_ptr(),
            db.data_ptr()]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    if hasattr(lib, "dl4j_layer_norm_act_bwd_floor"):
        lay = k6.bwd_layout(rows, cols, sms)
        bar = torch.zeros(2, dtype=torch.int32, device=dev)
        part = torch.empty(2 * lay["ctas"] * cols, dtype=torch.float32,
                           device=dev)
        ptrs += [part.data_ptr(), bar.data_ptr()]
        ints = list(k6._layout_args(rows, cols, "identity", x.dtype, lay,
                                    k6.bwd_staged(x, dy, dx)))
        fn.argtypes = [ctypes.c_void_p] * len(ptrs) \
            + k6._LAYOUT_ARGTYPES + [ctypes.c_void_p]
        keep = (bar, part)
    else:
        nv, wpr = k6.row_config(cols)
        blocks = max(1, min(-(-rows // max(4 // wpr, 1)),
                            OLD_BWD_BLOCKS_PER_SM * sms, 65535))
        part = torch.empty((2, blocks, cols), dtype=torch.float32,
                           device=dev)
        ptrs += [part.data_ptr()]
        ints = [rows, cols, 0, _CODES[x.dtype], nv, wpr, blocks]
        fn.argtypes = [ctypes.c_void_p] * len(ptrs) + [
            ctypes.c_longlong] + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        keep = (part,)
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        rc = fn(*ptrs, *ints, stream)
        if rc != 0:
            raise RuntimeError(f"K7 launch failed: CUDA error {rc}")
        return dx, dg, db
    call.workspace = keep  # alive as long as the call
    return call


def lstm_fn(lib, x, h, c, w, rw, b):
    """A call of ``lib``'s K8 entry returning ``(h', c')``: its last int
    is the copy widths (``lstm_cell.vec_flags``), or for a library from
    before the cluster design, the row tile (the least power of two that
    covers B, at most 8)."""
    fn = lib.dl4j_lstm_cell
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong] * 3 + [
        ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    B, F = x.shape
    U = rw.shape[0]
    if hasattr(lib, "dl4j_lstm_cell_geometry"):
        last = k8.vec_flags(x, h, w, rw)
    else:
        last = min(8, 1 << max(0, math.ceil(math.log2(B))))
    h_new = torch.empty((B, U), dtype=x.dtype, device=x.device)
    c_new = torch.empty_like(h_new)
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        rc = fn(x.data_ptr(), x.stride(0), h.data_ptr(), h.stride(0),
                c.data_ptr(), c.stride(0), w.data_ptr(), rw.data_ptr(),
                b.data_ptr(), h_new.data_ptr(), c_new.data_ptr(), B, F, U,
                FORGET_BIAS, 0, last, stream)
        if rc != 0:
            raise RuntimeError(f"K8 launch failed: CUDA error {rc}")
        return h_new, c_new
    return call


def decode_fn(lib, q, k, v, lengths, multi: bool):
    """A call of ``lib``'s K9 entry (``multi`` False) or K10 entry
    returning ``(o,)``. A library with a launch floor is the one-launch
    design (this checkout's signature and split rule); one without takes
    f32 scratch for its split states and splits a row over at most 64
    CTAs."""
    name = "dl4j_mq_decode_attn" if multi else "dl4j_decode_attn"
    fn = getattr(lib, name)
    one_launch = hasattr(lib, "dl4j_decode_attn_floor") or hasattr(
        lib, "dl4j_mq_decode_attn_floor")
    B, H, Tq, d = q.shape
    C = k.shape[2]
    o = torch.empty((B, H, Tq, d), dtype=q.dtype, device=q.device)
    if multi:
        strides = [s for t in (q, k, v, o) for s in t.stride()[:3]]
    else:
        strides = [*q.stride()[:2], *k.stride()[:3], *v.stride()[:3],
                   *o.stride()[:2]]
    st = (ctypes.c_longlong * len(strides))(*strides)
    head = [q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
            o.data_ptr()]
    shape = [B, H, C, d] + ([Tq] if multi else [])
    if one_launch:
        splits = k9.num_splits(B, H, C)
        ints = shape + [splits] + ([] if multi else
                                   [k9.cta_threads(B, H, C)])
        ptrs = head
    else:
        want = -(-4 * k9.SMS // (B * H))
        splits = max(1, min(want, -(-C // k9.MIN_KEYS_PER_SPLIT),
                            OLD_MAX_SPLITS))
        n = B * H * splits * (Tq if multi else 1)
        scratch = torch.empty(n * (d + 2), dtype=torch.float32,
                              device=q.device)
        acc, m, l = scratch.split((n * d, n, n))
        ints = shape + [splits]
        ptrs = head + [m.data_ptr(), l.data_ptr(), acc.data_ptr()]
    fn.argtypes = [ctypes.c_void_p] * len(ptrs) + [ctypes.c_int] * len(
        ints) + [ctypes.c_void_p, ctypes.c_float, ctypes.c_int,
                 ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream().cuda_stream
    vec = int(k9._vec_ok(k, v))

    def call():
        rc = fn(*ptrs, *ints, st, 1.0 / math.sqrt(d), vec, _CODES[q.dtype],
                stream)
        if rc != 0:
            raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
        return (o,)
    return call


def decode_cases(gen, dev) -> list:
    """``(kernel, shape, dtype, lengths)`` of the K9 and K10 cases: the
    path shapes at the lengths of a step halfway through their mixes (as
    ``chip_smoke.py`` times them), the others at lengths drawn from
    ``gen`` in [C/2, C] (before the window for K10)."""
    path = {
        DECODE_PATH_SHAPE: [len(p) + pg.BENCH["max_new_tokens"] // 2 + 1
                            for p in pg.prompts(*pg.BENCH_PROMPTS)],
        MQ_PATH_SHAPE: [pg.SYSTEM_PROMPT_LEN
                        + pg.PAGED["max_new_tokens"] // 2] * MQ_PATH_SHAPE[0],
        MQ_GROW_SHAPE: [len(p) + pg.GROW["max_new_tokens"] // 2
                        for p in pg.prompts(*pg.GROW_PROMPTS)]}
    named = (DECODE_PATH_SHAPE, DECODE_LONG_SHAPE, MQ_PATH_SHAPE,
             MQ_GROW_SHAPE, MQ_LONG_SHAPE)
    cases = []
    for kernel, shapes in (("K9", DECODE_SHAPES), ("K10", MQ_SHAPES)):
        for shape in shapes:
            B, C = shape[0], shape[-2]
            top = C if kernel == "K9" else C - shape[2]
            ln = path.get(shape) or torch.randint(
                C // 2, top + 1, (B,), generator=gen, device=dev).tolist()
            ln = torch.tensor(ln, dtype=torch.int32, device=dev)
            for dtype in (torch.float32, torch.bfloat16):
                if dtype == torch.float32 or shape in named:
                    cases.append((kernel, shape, dtype, ln))
    return cases


def sdpa_ms(q, k, v, lengths, multi: bool, reps: int) -> float:
    """``scaled_dot_product_attention`` on the same q, k, v with the
    float length (K9) or window (K10) mask, as ``chip_smoke.py`` times
    it."""
    import torch.nn.functional as F
    C = k.shape[2]
    if multi:
        keep, uniform = k10.window_mask(lengths, q.shape[2], C)
        keep = keep | uniform[:, :, None]
    else:
        keep = (torch.arange(C, device=q.device)[None, :]
                < lengths[:, None])[:, None, :]
    mask = torch.where(keep, 0.0, float(torch.finfo(torch.float32).min))
    mask = mask[:, None].to(q.dtype)
    return time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask), reps)


def in_turns(other, this, rounds: int, reps: int) -> dict:
    """other, this, this, other, ``rounds`` times; the largest difference of
    the two kernels' outputs."""
    got = {"other": [], "this": []}
    for _ in range(rounds):
        for who in ("other", "this", "this", "other"):
            got[who].append(time_ms(other if who == "other" else this, reps))
    diff = max(float((a.float() - b.float()).abs().max())
               for a, b in zip(other(), this()))
    return {"other_ms": got["other"], "this_ms": got["this"],
            "other_median_ms": statistics.median(got["other"]),
            "this_median_ms": statistics.median(got["this"]),
            "max_abs_diff": diff}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True, type=Path)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--kernels", default=",".join(LIB_OF),
                    help="the kernels to compare, comma-separated "
                    "(default: all of K3, K7, K8, K9, K10)")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("compare_kernels needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    name = card()
    wanted = [k.strip() for k in a.kernels.split(",") if k.strip()]
    bad = sorted(set(wanted) - set(LIB_OF))
    if bad:
        raise SystemExit(f"unknown kernels {bad}: choose from {list(LIB_OF)}")
    libs = [LIB_OF[k] for k in LIB_OF if k in wanted]
    other = build_other(a.other.resolve(), libs)
    this = {n: _build.load(n) for n in libs}
    gen = torch.Generator(device=dev).manual_seed(0)
    if "K3" in wanted:
        compare_k3(other, this, gen, dev, name, a)
    if "K7" in wanted:
        compare_k7(other, this, gen, dev, name, a)
    if "K8" in wanted:
        compare_k8(other, this, gen, dev, name, a)
    if "K9" in wanted or "K10" in wanted:
        compare_decode(other, this, gen, dev, name, a, wanted)
    return 0


def compare_k3(other, this, gen, dev, name, a) -> None:
    B, H, Tq, Tk, d = ATTN_SHAPE
    lengths = torch.randint(1, Tk + 1, (B,), generator=gen, device=dev)
    kb = torch.where(torch.arange(Tk, device=dev)[None, :] < lengths[:, None],
                     0.0, float(torch.finfo(torch.float32).min)).contiguous()
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = (torch.randn(B, T, H, d, generator=gen, device=dev)
                   .to(dtype).transpose(1, 2) for T in (Tq, Tk, Tk))
        row = in_turns(attn_fn(other["flash_attn_fwd"], q, k, v, kb,
                               1.0 / math.sqrt(d)),
                       attn_fn(this["flash_attn_fwd"], q, k, v, kb,
                               1.0 / math.sqrt(d)), a.rounds, a.reps)
        print(json.dumps({"kernel": "K3", "shape": ATTN_SHAPE,
                          "dtype": str(dtype)[6:], "layout": "heads",
                          "card": name, **row}), flush=True)



def compare_k7(other, this, gen, dev, name, a) -> None:
    for rows, cols in LN_SHAPES:
        g = torch.randn(cols, generator=gen, device=dev) * 0.5 + 1.0
        b = torch.randn(cols, generator=gen, device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            if dtype != torch.float32 and (rows, cols) != LN_SHAPES[0]:
                continue
            x = torch.randn(rows, cols, generator=gen, device=dev).to(dtype)
            dy = torch.randn(rows, cols, generator=gen, device=dev).to(dtype)
            _, mu, rstd = k6.layer_norm_act(x, g, b, LN_EPS)
            row = in_turns(ln_bwd_fn(other["layer_norm_act_bwd"], x, g, b,
                                     mu, rstd, dy),
                           ln_bwd_fn(this["layer_norm_act_bwd"], x, g, b,
                                     mu, rstd, dy), a.rounds, a.reps)
            floor = time_ms(lambda: k6.bwd_launch_floor(rows, cols, dtype),
                            a.reps)
            extra = {}
            if (rows, cols) == LN_SHAPES[0]:
                gt, bt = g.to(dtype), b.to(dtype)
                extra["library_ms"] = time_ms(
                    lambda: torch.ops.aten.native_layer_norm_backward(
                        dy, x, [cols], mu[:, None], rstd[:, None], gt, bt,
                        [True, True, True]), a.reps)
            print(json.dumps({"kernel": "K7", "shape": (rows, cols),
                              "dtype": str(dtype)[6:], "act": "identity",
                              "bound_ms": k6.bound_ms_bwd(
                                  rows, cols, x.element_size(), "identity"),
                              "card": name, "floor_ms": floor, **extra,
                              **row}), flush=True)


def compare_k8(other, this, gen, dev, name, a) -> None:
    for B, F, U in LSTM_SHAPES:
        seq = torch.rand(B, 3, F, generator=gen, device=dev) * 2 - 1
        x = seq[:, 1]
        h = torch.rand(B, U, generator=gen, device=dev) * 2 - 1
        c = torch.randn(B, U, generator=gen, device=dev)
        w = torch.randn(F, 4 * U, generator=gen, device=dev) \
            * (2.0 / (F + U)) ** 0.5
        rw = torch.randn(U, 4 * U, generator=gen, device=dev) \
            * (1.0 / U) ** 0.5
        b = torch.randn(4 * U, generator=gen, device=dev) * 0.1
        row = in_turns(lstm_fn(other["lstm_cell"], x, h, c, w, rw, b),
                       lstm_fn(this["lstm_cell"], x, h, c, w, rw, b),
                       a.rounds, a.reps)
        floor = time_ms(lambda: k8.launch_floor(B, F, U), a.reps)
        print(json.dumps({"kernel": "K8", "shape": (B, F, U),
                          "dtype": "float32", "layout": "strided",
                          "card": name, "floor_ms": floor, **row}),
              flush=True)


def compare_decode(other, this, gen, dev, name, a, wanted) -> None:
    for kernel, shape, dtype, ln in decode_cases(gen, dev):
        if kernel not in wanted:
            continue
        multi = kernel == "K10"
        B, H = shape[:2]
        C, d = shape[-2:]
        Tq = shape[2] if multi else 1
        q = torch.randn(B, Tq, H, d, generator=gen, device=dev).to(
            dtype).transpose(1, 2)
        k, v = (torch.randn(B, H, C, d, generator=gen, device=dev)
                .to(dtype) for _ in range(2))
        lib = "mq_decode_attn" if multi else "decode_attn"
        row = in_turns(decode_fn(other[lib], q, k, v, ln, multi),
                       decode_fn(this[lib], q, k, v, ln, multi),
                       a.rounds, a.reps)
        if multi:
            floor = time_ms(lambda: k10.launch_floor(B, H, Tq, C, d, dtype),
                            a.reps)
        else:
            floor = time_ms(lambda: k9.launch_floor(B, H, C, d, dtype),
                            a.reps)
        extra = {}
        if shape in (DECODE_PATH_SHAPE, MQ_PATH_SHAPE) \
                and dtype == torch.float32:
            extra["sdpa_ms"] = sdpa_ms(q, k, v, ln, multi, a.reps)
        print(json.dumps({"kernel": kernel, "shape": shape,
                          "dtype": str(dtype)[6:], "layout": "heads",
                          "splits": k9.num_splits(B, H, C),
                          "lengths": [int(ln.min()), int(ln.max())],
                          "card": name, "floor_ms": floor, **extra, **row}),
              flush=True)


if __name__ == "__main__":
    raise SystemExit(main())
