"""K6 and K7, the LayerNorm + affine + activation epilogue and its backward.

- K6, ``(y, mu, rstd)`` with ``y = act((x - mu) * rstd * gamma + beta)``
  over each row of ``[rows, C]``: wrapper of ``csrc/layer_norm_act.cu``,
  which replaces the JAX package's
  ``ops/fused_epilogues.py::_fused_epilogue_ln_fwd``. The mean and the
  variance are two passes over the row (never ``E[x^2] - E[x]^2``), and
  ``rstd = rsqrt(var + eps)``.
- K7, ``(dx, dgamma, dbeta)`` of K6 given ``dy`` and the forward's ``mu``
  and ``rstd``: wrapper of ``csrc/layer_norm_act_bwd.cu``, which replaces
  ``ops/fused_epilogues.py::_fused_epilogue_ln_bwd``. It recomputes
  ``xhat`` and ``z`` and differentiates the activation with
  ``affine_act.act_grad`` (K2's ties).

``x2`` and ``dy`` are ``[rows, C]`` in f32, bf16 or f16, ``gamma`` and
``beta`` f32 ``[C]``. The math is f32; ``y`` and ``dx`` have x's dtype;
``mu``, ``rstd`` (one f32 per row: the TPU kernel replicated each over
128 lanes), ``dgamma`` and ``dbeta`` are f32. The plain versions also take
float64 (on the CPU) and then compute in float64; the kernels refuse it.

- A CPU tensor takes the plain version (:func:`layer_norm_act_reference`,
  :func:`layer_norm_act_bwd_reference`).
- A CUDA tensor launches the kernel, or raises: on a dtype, layout or
  activation it does not take, on ``C`` above :data:`MAX_COLS`, on a failed
  build and on a refused launch. No CUDA call gives way to the plain
  version.

``launches`` and ``bwd_launches`` count wrapper calls that launched K6 and
K7 (plain-version calls are not counted; one K7 call is one CUDA kernel,
its column sums merged inside the launch behind a grid barrier).
:func:`bwd_layout` is K7's launch layout, :func:`bwd_occupancy` what the
card makes of it and :func:`bwd_launch_floor` an empty kernel launched
the same way.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import torch

from . import _build
from .affine_act import (_DTYPE_CODES, ACTS, H100_BYTES_PER_S,
                         H100_F32_FLOPS_PER_S, _device_index, _math_dtype,
                         _sm_count, act_fwd, act_grad)

#: The widest row the kernels take: a row lives in the registers of one
#: group of 256 threads, 32 values each.
MAX_COLS = 8192

#: Kernel launches since the last reset (plain integers; set them to 0 to
#: reset), and the bfloat16 ones among them.
launches = 0
bwd_launches = 0
bf16_launches = 0
bf16_bwd_launches = 0


def row_config(cols: int) -> tuple:
    """``(nv, wpr)`` for a row of ``cols``: a group of ``32 * wpr``
    threads holds it, ``nv`` values a thread (one warp up to 1024, then 4
    or 8 warps); the kernels are compiled for these pairs only."""
    for nv, wpr in ((8, 1), (16, 1), (24, 1), (32, 1), (32, 4), (32, 8)):
        if cols <= 32 * wpr * nv:
            return nv, wpr
    raise ValueError(f"layer_norm_act: C = {cols} is above the kernels' "
                     f"limit of {MAX_COLS} columns")


def layer_norm_act_reference(x2, gamma, beta, eps, act="identity"):
    """K6's plain version: ``(y, mu, rstd)``, f32 math (f64 for f64), two
    passes over each row, one cast of y back to x's dtype."""
    f = _math_dtype(x2.dtype)
    x = x2.to(f)
    mu = x.mean(1, keepdim=True)
    xc = x - mu
    rstd = torch.rsqrt((xc * xc).mean(1, keepdim=True) + eps)
    z = xc * rstd * gamma.to(f) + beta.to(f)
    return act_fwd(act, z).to(x2.dtype), mu[:, 0], rstd[:, 0]


def layer_norm_act_bwd_reference(x2, gamma, beta, mu, rstd, dy,
                                 act="identity"):
    """K7's plain version: ``(dx, dgamma, dbeta)``, f32 math (f64 for
    f64), dx cast once to x's dtype."""
    f = _math_dtype(x2.dtype)
    rs = rstd.to(f)[:, None]
    xhat = (x2.to(f) - mu.to(f)[:, None]) * rs
    g = gamma.to(f)
    dz = dy.to(f) * act_grad(act, xhat * g + beta.to(f))
    dxh = dz * g
    m1 = dxh.mean(1, keepdim=True)
    m2 = (dxh * xhat).mean(1, keepdim=True)
    dx = ((dxh - m1 - xhat * m2) * rs).to(x2.dtype)
    return dx, (dz * xhat).sum(0), dz.sum(0)


def _check(x2, gamma, beta, act):
    if act not in ACTS:
        raise ValueError(f"layer_norm_act: activation {act!r} not in {ACTS}")
    if x2.dtype not in _DTYPE_CODES:
        raise TypeError(f"layer_norm_act: dtype {x2.dtype} not supported "
                        "(float32, bfloat16, float16)")
    if x2.dim() != 2 or not x2.is_contiguous():
        raise ValueError("layer_norm_act: x must be a contiguous row-major "
                         f"[rows, C] tensor, got shape {tuple(x2.shape)} "
                         f"strides {x2.stride()}")
    cols = x2.shape[1]
    row_config(cols)  # raises above MAX_COLS
    for name, v in (("gamma", gamma), ("beta", beta)):
        if v.dtype != torch.float32 or v.dim() != 1 or v.shape[0] != cols \
                or not v.is_contiguous() or v.device != x2.device:
            raise ValueError(f"layer_norm_act: {name} must be a contiguous "
                             f"float32 [{cols}] tensor on {x2.device}")


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = _build.load("layer_norm_act").dl4j_layer_norm_act
    fn.argtypes = [ctypes.c_void_p] * 6 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


#: K7's layout arguments: rows, cols, act, dtype, nv, wpr, stages, ctas,
#: rows_per_cta, staged
_LAYOUT_ARGTYPES = [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                    ctypes.c_int, ctypes.c_longlong, ctypes.c_int]


@functools.lru_cache(maxsize=None)
def _kernel_bwd(entry="dl4j_layer_norm_act_bwd"):
    fn = getattr(_build.load("layer_norm_act_bwd"), entry)
    head = {"dl4j_layer_norm_act_bwd": [ctypes.c_void_p] * 11}.get(entry, [])
    tail = {"dl4j_layer_norm_act_bwd_occupancy": [ctypes.c_void_p]}.get(
        entry, [ctypes.c_void_p])
    fn.argtypes = head + _LAYOUT_ARGTYPES + tail
    fn.restype = ctypes.c_int
    return fn


def _on_card(x2, name):
    if x2.device.type == "cpu":
        return False
    if x2.device.type != "cuda":
        raise ValueError(f"{name}: tensors on {x2.device} are not "
                         "supported (cuda or cpu)")
    return True


def layer_norm_act(x2, gamma, beta, eps, act="identity"):
    """K6 on a CUDA tensor, the plain version on a CPU tensor: ``(y, mu,
    rstd)``."""
    if not _on_card(x2, "layer_norm_act"):
        return layer_norm_act_reference(x2, gamma, beta, eps, act)
    global launches, bf16_launches
    _check(x2, gamma, beta, act)
    fn = _kernel()
    rows, cols = x2.shape
    f32 = dict(dtype=torch.float32, device=x2.device)
    y = torch.empty_like(x2)
    mu, rstd = torch.empty(rows, **f32), torch.empty(rows, **f32)
    if rows == 0:
        return y, mu, rstd
    nv, wpr = row_config(cols)
    rc = fn(x2.data_ptr(), gamma.data_ptr(), beta.data_ptr(), y.data_ptr(),
            mu.data_ptr(), rstd.data_ptr(), rows, cols, float(eps),
            ACTS.index(act), _DTYPE_CODES[x2.dtype], nv, wpr,
            torch.cuda.current_stream(x2.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"layer_norm_act kernel launch failed: CUDA error {rc}")
    launches += 1
    bf16_launches += x2.dtype == torch.bfloat16
    return y, mu, rstd


#: K7's deepest ring of staged rows, and its CTA (one an SM)
BWD_MAX_STAGES = 3
BWD_THREADS = 256
#: shared memory an SM has for its CTAs, and what the card reserves a CTA
#: (H100)
SMEM_PER_SM = 228 * 1024
SMEM_RESERVED_PER_CTA = 1024
#: what a K7 CTA leaves of its share for the card's reservation and the
#: kernel's static shared memory
BWD_SMEM_SLACK = 2 * SMEM_RESERVED_PER_CTA


def bwd_smem_bytes(cols: int, itemsize: int, threads: int, groups: int,
                   stages: int, staged: bool) -> int:
    """K7's dynamic shared memory a CTA (``smem_bytes`` in the source):
    gamma and beta, each thread's (mu, rstd) slot of every stage, and the
    larger of the row ring and the groups' column sums; at least a float a
    thread (the merge's warp sums)."""
    gb = 8 * cols
    mr = 8 * threads * stages if staged else 0
    ring = groups * stages * 2 * cols * itemsize if staged else 0
    red = 8 * groups * cols if groups > 1 else 0
    return max(gb + mr + max(ring, red), 4 * threads)


def bwd_layout(rows: int, cols: int, sms: int) -> dict:
    """K7's launch layout for a ``[rows, cols]`` call on a card of ``sms``
    SMs; a function of these three alone, so the sum order, and the sums,
    are the same on every run.

    - ``nv``, ``wpr``: :func:`row_config`'s row layout; ``groups`` =
      rows in flight in a CTA of ``threads`` = 256;
    - ``stages``: the ring's depth, the most (2 or 3) whose float32 rows
      fit one CTA an SM;
    - ``ctas``: one CTA for each ``groups`` rows, at most one an SM (the
      launch is cooperative: every CTA resident at once), each owning
      ``rows_per_cta`` consecutive rows (the last ones fewer or none)."""
    nv, wpr = row_config(cols)
    groups = BWD_THREADS // (32 * wpr)
    budget = SMEM_PER_SM - BWD_SMEM_SLACK
    stages = next((s for s in range(BWD_MAX_STAGES, 2, -1)
                   if bwd_smem_bytes(cols, 4, BWD_THREADS, groups, s, True)
                   <= budget), 2)
    ctas = max(1, min(-(-rows // groups), sms))
    return {"nv": nv, "wpr": wpr, "threads": BWD_THREADS, "groups": groups,
            "stages": stages, "ctas": ctas,
            "rows_per_cta": max(1, -(-rows // ctas))}


def bwd_staged(x2, dy, dx) -> bool:
    """Whether K7 stages rows through its shared-memory ring: a row's
    bytes a multiple of 16 and x, dy and dx 16-byte aligned."""
    return (x2.shape[1] * x2.element_size()) % 16 == 0 and all(
        t.data_ptr() % 16 == 0 for t in (x2, dy, dx))


def _layout_args(rows, cols, act, dtype, lay, staged) -> tuple:
    return (rows, cols, ACTS.index(act), _DTYPE_CODES[dtype], lay["nv"],
            lay["wpr"], lay["stages"], lay["ctas"], lay["rows_per_cta"],
            int(staged))


_workspaces: dict = {}
_workspaces_lock = threading.Lock()


def _workspace(device, stream, ctas: int, cols: int):
    """K7's per-(device, stream) workspace, reused across calls: the grid
    barrier's two counters (int32, the first zero between calls) and at
    least ``ctas * 2 * cols`` floats of the CTAs' column sums."""
    key = (device, stream)
    need = 2 * ctas * cols
    with _workspaces_lock:
        ws = _workspaces.get(key)
        if ws is None or ws[1].numel() < need:
            bar = ws[0] if ws is not None else torch.zeros(
                2, dtype=torch.int32, device=device)
            ws = _workspaces[key] = (bar, torch.empty(
                need, dtype=torch.float32, device=device))
        return ws


def _check_bwd(x2, gamma, beta, mu, rstd, dy, act):
    _check(x2, gamma, beta, act)
    if dy.dtype != x2.dtype or dy.shape != x2.shape \
            or not dy.is_contiguous() or dy.device != x2.device:
        raise ValueError(
            f"layer_norm_act_bwd: dy must be a contiguous {x2.dtype} "
            f"{tuple(x2.shape)} tensor on {x2.device}, got {dy.dtype} "
            f"{tuple(dy.shape)} strides {dy.stride()} on {dy.device}")
    rows = x2.shape[0]
    for name, v in (("mu", mu), ("rstd", rstd)):
        if v.dtype != torch.float32 or v.shape != (rows,) \
                or not v.is_contiguous() or v.device != x2.device:
            raise ValueError(f"layer_norm_act_bwd: {name} must be a "
                             f"contiguous float32 [{rows}] tensor on "
                             f"{x2.device}")


def layer_norm_act_bwd(x2, gamma, beta, mu, rstd, dy, act="identity"):
    """K7 on CUDA tensors, the plain version on CPU tensors: ``(dx,
    dgamma, dbeta)``."""
    if not _on_card(x2, "layer_norm_act_bwd"):
        return layer_norm_act_bwd_reference(x2, gamma, beta, mu, rstd, dy,
                                            act)
    global bwd_launches, bf16_bwd_launches
    _check_bwd(x2, gamma, beta, mu, rstd, dy, act)
    fn = _kernel_bwd()
    rows, cols = x2.shape
    f32 = dict(dtype=torch.float32, device=x2.device)
    dx = torch.empty_like(x2)
    if rows == 0:
        return dx, torch.zeros(cols, **f32), torch.zeros(cols, **f32)
    dgamma, dbeta = torch.empty(cols, **f32), torch.empty(cols, **f32)
    lay = bwd_layout(rows, cols, _sm_count(_device_index(x2)))
    stream = torch.cuda.current_stream(x2.device).cuda_stream
    bar, part = _workspace(x2.device, stream, lay["ctas"], cols)
    rc = fn(
        x2.data_ptr(), gamma.data_ptr(), beta.data_ptr(), mu.data_ptr(),
        rstd.data_ptr(), dy.data_ptr(), dx.data_ptr(), dgamma.data_ptr(),
        dbeta.data_ptr(), part.data_ptr(), bar.data_ptr(),
        *_layout_args(rows, cols, act, x2.dtype, lay,
                      bwd_staged(x2, dy, dx)), stream)
    if rc != 0:
        raise RuntimeError(
            f"layer_norm_act_bwd kernel launch failed: CUDA error {rc}")
    bwd_launches += 1
    bf16_bwd_launches += x2.dtype == torch.bfloat16
    return dx, dgamma, dbeta


def _staged_for(cols: int, dtype) -> bool:
    """Whether K7 stages rows of ``cols`` values of ``dtype`` (16-byte
    aligned tensors, as the caching allocator gives them)."""
    return (cols * _ITEMSIZE[dtype]) % 16 == 0


_ITEMSIZE = {torch.float32: 4, torch.bfloat16: 2, torch.float16: 2}


def bwd_occupancy(rows: int, cols: int, dtype=torch.float32,
                  act: str = "identity") -> dict:
    """K7's resources on the current card at this shape: registers and
    local (spill) bytes a thread, threads and shared-memory bytes a CTA and
    the CTAs one SM holds at once (CUDA's occupancy calculator), beside
    :func:`bwd_layout`. Needs the card."""
    lay = bwd_layout(rows, cols, _sm_count(torch.cuda.current_device()))
    staged = _staged_for(cols, dtype)
    out = (ctypes.c_int * 5)()
    rc = _kernel_bwd("dl4j_layer_norm_act_bwd_occupancy")(
        *_layout_args(rows, cols, act, dtype, lay, staged), out)
    if rc != 0:
        raise RuntimeError(f"layer_norm_act_bwd occupancy query failed: "
                           f"CUDA error {rc}")
    return {**dict(zip(("registers", "threads", "smem_bytes", "local_bytes",
                        "ctas_per_sm"), out)), "layout": lay}


def bwd_launch_floor(rows: int, cols: int, dtype=torch.float32,
                     act: str = "identity") -> None:
    """Launch an empty kernel with K7's grid, threads, cooperative launch
    and shared memory at this shape on the current stream: the fixed cost
    of one K7 launch, for timing beside it. Not counted in
    ``bwd_launches``."""
    lay = bwd_layout(rows, cols, _sm_count(torch.cuda.current_device()))
    staged = _staged_for(cols, dtype)
    rc = _kernel_bwd("dl4j_layer_norm_act_bwd_floor")(
        *_layout_args(rows, cols, act, dtype, lay, staged),
        torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"layer_norm_act_bwd floor launch failed: CUDA "
                           f"error {rc}")


# ----------------------------------------------------------------- bounds

def bytes_moved(rows: int, cols: int, itemsize: int) -> int:
    """Least device-memory traffic of one K6 call: x read once, y written
    once, gamma and beta read once, mu and rstd written once."""
    return 2 * rows * cols * itemsize + 2 * cols * 4 + 2 * rows * 4


_ACT_FLOPS = {"identity": 0, "relu": 1, "relu6": 2, "tanh": 1, "sigmoid": 3,
              "gelu": 8, "geluexact": 5}
_ACT_GRAD_FLOPS = {"identity": 0, "relu": 1, "relu6": 2, "tanh": 3,
                   "sigmoid": 5, "gelu": 14, "geluexact": 10}


def flops(rows: int, cols: int, act: str) -> int:
    """f32 operations of one K6 call per element: the sum, x - mu, its
    square and sum, xhat, the affine, and a per-activation count
    (transcendentals counted as one)."""
    return rows * cols * (7 + _ACT_FLOPS[act])


def bound_ms(rows: int, cols: int, itemsize: int, act: str) -> float:
    """The least time an H100 SXM could take for one K6 call: the larger
    of bytes over the memory rate and f32 operations over the f32 rate."""
    return 1e3 * max(bytes_moved(rows, cols, itemsize) / H100_BYTES_PER_S,
                     flops(rows, cols, act) / H100_F32_FLOPS_PER_S)


def bytes_moved_bwd(rows: int, cols: int, itemsize: int) -> int:
    """Least device-memory traffic of one K7 call: x and dy read once, dx
    written once; gamma, beta, mu and rstd read, dgamma and dbeta written
    once."""
    return 3 * rows * cols * itemsize + 4 * cols * 4 + 2 * rows * 4


def flops_bwd(rows: int, cols: int, act: str) -> int:
    """f32 operations of one K7 call per element: xhat, z, act'(z)
    (transcendentals counted as one), dz, dxh, the two column sums, the
    two row sums and dx."""
    return rows * cols * (14 + _ACT_GRAD_FLOPS[act])


def bound_ms_bwd(rows: int, cols: int, itemsize: int, act: str) -> float:
    """The least time an H100 SXM could take for one K7 call: the larger
    of bytes over the memory rate and f32 operations over the f32 rate."""
    return 1e3 * max(bytes_moved_bwd(rows, cols, itemsize) / H100_BYTES_PER_S,
                     flops_bwd(rows, cols, act) / H100_F32_FLOPS_PER_S)


# -------------------------------------------------------------- tolerance

def tolerance(dtype) -> dict:
    """What holds a kernel to its plain version on the same inputs.

    - ``rel``: the f32 math's allowance, 32 units of 2^-24 on each term's
      scale (the means and the variance are sums in another order, and
      rsqrtf, tanhf, erff and expf differ from PyTorch's by an ulp or two);
    - ``out``: one ulp of the output dtype relative to the output (a
      16-bit y or dx may then round the other way; 0 for float32);
    - ``abs``: an absolute floor for values that round to zero;
    - ``sum``: dgamma and dbeta within this share of each column's sum of
      |term| (f32 sums of the same terms in another order; K2's rule).

    :func:`y_bound`, :func:`stats_bound` and :func:`dx_bound` turn these
    into per-element bounds. In float32 a one-pass variance misses them by
    orders of magnitude on rows far from zero (``x = 1000 + N(0, 1)``), and
    a kernel that drops a ragged tail misses them in every row."""
    out = {torch.float32: 0.0, torch.bfloat16: 2.0 ** -7,
           torch.float16: 2.0 ** -10}[dtype]
    return {"rel": 32 * 2.0 ** -24, "out": out, "abs": 1e-6, "sum": 1e-4}


def y_bound(x2, gamma, beta, mu, rstd, y_ref):
    """Per-element allowed ``|y - y_ref|`` for K6 on ``x2``, given the
    plain version's ``mu``, ``rstd`` and ``y_ref``: the f32 allowance on
    the affine's terms (``|xhat*gamma| + |beta|``), on the mean's scale
    carried through (``(|mu|*rstd + 1)*|gamma|``) and on y, then one ulp of
    y's dtype."""
    tol = tolerance(x2.dtype)
    rs = rstd.float()[:, None]
    g = gamma.float().abs()
    xhat = (x2.float() - mu.float()[:, None]) * rs
    yr = y_ref.float().abs()
    scale = (xhat.abs() * g + beta.float().abs()
             + (mu.float().abs()[:, None] * rs + 1.0) * g + yr)
    return tol["rel"] * scale + tol["out"] * yr + tol["abs"]


def stats_bound(mu, rstd):
    """Per-row allowed ``(|mu - mu_ref|, |rstd - rstd_ref|)`` given the
    plain version's ``mu`` and ``rstd``: the f32 allowance on the mean's
    scale (``|mu|`` and one standard deviation) and on rstd."""
    rel = tolerance(torch.float32)["rel"]
    return (rel * (mu.abs() + 1.0 / rstd) + 1e-12, rel * rstd.abs())


def dx_bound(x2, gamma, beta, mu, rstd, dy, dx_ref, act):
    """Per-element allowed ``|dx - dx_ref|`` for K7: the f32 allowance on
    each term of ``(dxh - mean(dxh) - xhat*mean(dxh*xhat)) * rstd`` (the
    row means over |term|), then one ulp of dx's dtype."""
    tol = tolerance(x2.dtype)
    rs = rstd.float()[:, None]
    xhat = (x2.float() - mu.float()[:, None]) * rs
    g = gamma.float()
    dz = dy.float() * act_grad(act, xhat * g + beta.float())
    dxh = (dz * g).abs()
    m1 = dxh.mean(1, keepdim=True)
    m2 = (dxh * xhat.abs()).mean(1, keepdim=True)
    scale = (dxh + m1 + xhat.abs() * m2) * rs
    return tol["rel"] * scale + tol["out"] * dx_ref.float().abs() + tol["abs"]


def sum_bound(x2, gamma, beta, mu, rstd, dy, act):
    """Per-column allowed ``(|dgamma - ref|, |dbeta - ref|)``: ``sum`` of
    :func:`tolerance` times each column's sum of |term|."""
    tol = tolerance(x2.dtype)
    rs = rstd.float()[:, None]
    xhat = (x2.float() - mu.float()[:, None]) * rs
    dz = (dy.float() * act_grad(act, xhat * gamma.float()
                                + beta.float())).abs()
    return (tol["sum"] * (dz * xhat.abs()).sum(0) + tol["abs"],
            tol["sum"] * dz.sum(0) + tol["abs"])


def one_pass_reference(x2, gamma, beta, eps, act="identity"):
    """K6's arithmetic with a one-pass variance, ``E[x^2] - E[x]^2`` in
    f32: not a version of K6, but what the tolerance must reject (on rows
    far from zero it loses the variance to cancellation)."""
    x = x2.float()
    mu = x.mean(1, keepdim=True)
    var = (x * x).mean(1, keepdim=True) - mu * mu
    rstd = torch.rsqrt(var.clamp(min=0.0) + eps)
    z = (x - mu) * rstd * gamma.float() + beta.float()
    return act_fwd(act, z).to(x2.dtype)
