"""Neural-network ops: convolution, pooling, batch and layer norm, dropout,
the embedding lookup and the recurrent cells.

Port of the ``deeplearning4j_tpu/ops/nnops.py`` ops that ResNet serving
and the recurrent layers use; ``layer_norm``, ``embedding_lookup`` and
the four cells (``lstm_cell``, ``graves_lstm_cell``, ``gru_cell``,
``simple_rnn_cell``) are catalog ops, registered under the JAX package's
names. The ops the imported layer kinds need (``separable_conv2d``,
``local_response_normalization``, ``upsampling2d``, ``zero_padding2d``,
``space_to_depth``, ``depth_to_space``) are plain functions here, not
catalog ops (ROADMAP Queue 1 item 4 keeps them). The convolution
stays ``F.conv2d`` (cuDNN on the card), as the JAX package leaves it to
XLA.

Layouts match the JAX package at every public function: ``data_format``
"NCHW" or "NHWC" for activations, OIHW weights for both. An NHWC tensor is
handed to ``F.conv2d`` as a permuted NCHW *view*, so its memory is
channels-last and cuDNN answers in channels-last memory too: the result,
permuted back, is a contiguous NHWC tensor the epilogue kernel reads as
``[N*H*W, C]`` without a copy.

Padding parity with DL4J ConvolutionMode: ``truncate`` is explicit
symmetric padding with floor division; ``same`` is XLA's SAME (output
``ceil(in/stride)``, padding split with the extra cell at the end — so an
even kernel pads asymmetrically); ``causal`` left-pads ``(k-1)*d``.
Torch's ``padding='same'`` refuses stride > 1, so SAME is an explicit
``F.pad``.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from . import register


def _pair(v) -> Tuple[int, int]:
    if isinstance(v, (tuple, list)):
        return (int(v[0]), int(v[1]))
    return (int(v), int(v))


def _safe_root(s, p):
    """s ** (1/p), 0 where s == 0."""
    pos = s > 0
    return torch.where(pos, torch.where(pos, s, torch.ones_like(s))
                       ** (1.0 / p), torch.zeros_like(s))


def _same_pads(size: int, k_eff: int, stride: int) -> Tuple[int, int]:
    """XLA SAME padding (lo, hi) for one spatial dim."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k_eff - size, 0)
    return total // 2, total - total // 2


def _spatial_pads(mode, padding, hw, k_eff, stride):
    """[(lo, hi), (lo, hi)] for H and W under a DL4J ConvolutionMode."""
    if mode == "same":
        return [_same_pads(hw[i], k_eff[i], stride[i]) for i in range(2)]
    if mode == "causal":
        return [(k_eff[0] - 1, 0), (k_eff[1] - 1, 0)]
    ph, pw = _pair(padding)
    return [(ph, ph), (pw, pw)]


def _to_nchw(x, data_format):
    if data_format == "NCHW":
        return x
    if data_format == "NHWC":
        # a contiguous NHWC tensor permuted is channels-last NCHW memory;
        # cuDNN then answers in channels-last memory too
        return x.contiguous().permute(0, 3, 1, 2)
    raise ValueError(f"Unknown data_format {data_format}")


def _from_nchw(y, data_format):
    return y if data_format == "NCHW" else y.permute(0, 2, 3, 1)


@register("conv2d", category="cnn")
def conv2d(x, w, b=None, stride=(1, 1), padding=0, dilation=(1, 1),
           mode="truncate", data_format="NCHW", groups=1):
    """2D convolution. x: [N,C,H,W] or [N,H,W,C]; w: [O,I/g,kH,kW] (OIHW)
    for either data_format; b: [O] or None."""
    stride, dilation = _pair(stride), _pair(dilation)
    kh, kw = int(w.shape[2]), int(w.shape[3])
    xn = _to_nchw(x, data_format)
    k_eff = ((kh - 1) * dilation[0] + 1, (kw - 1) * dilation[1] + 1)
    (pt, pb), (pl, pr) = _spatial_pads(mode, padding, xn.shape[2:], k_eff,
                                       stride)
    if pt == pb and pl == pr:
        y = F.conv2d(xn, w, None, stride, (pt, pl), dilation, groups)
    else:
        y = F.conv2d(F.pad(xn, (pl, pr, pt, pb)), w, None, stride, 0,
                     dilation, groups)
    y = _from_nchw(y, data_format)
    if b is not None:
        y = y + (b.reshape(1, -1, 1, 1) if data_format == "NCHW"
                 else b.reshape(1, 1, 1, -1))
    return y


def _transpose_pads(k_eff: int, stride: int, mode, pad: int):
    """``lax.conv_transpose``'s (lo, hi) padding of the input-dilated
    convolution it runs: SAME (output ``in * stride``) or the explicit
    forward padding ``pad`` (output ``(in-1)*stride + k_eff - 2*pad``)."""
    if mode == "same":
        total = k_eff + stride - 2
        lo = k_eff - 1 if stride > k_eff - 1 else -(-total // 2)
        return lo, total - lo
    return k_eff - 1 - pad, k_eff - 1 - pad


@register("deconv2d", category="cnn")
def deconv2d(x, w, b=None, stride=(1, 1), padding=0, dilation=(1, 1),
             mode="truncate", data_format="NCHW"):
    """Transposed 2D convolution (the JAX module's :94, DL4J's deconv
    weight layout ``w`` [O, I, kH, kW], O the output channels). The full
    ``F.conv_transpose2d`` (no padding) is cropped, or padded with zeros,
    to ``lax.conv_transpose``'s window: explicit ``padding`` p gives
    ``(in-1)*s + k_eff - 2p``, ``mode="same"`` gives ``in * s``."""
    stride, dilation = _pair(stride), _pair(dilation)
    kh, kw = int(w.shape[2]), int(w.shape[3])
    k_eff = ((kh - 1) * dilation[0] + 1, (kw - 1) * dilation[1] + 1)
    p = _pair(padding)
    xn = _to_nchw(x, data_format)
    full = F.conv_transpose2d(xn, w.transpose(0, 1), None, stride, 0, 0, 1,
                              dilation)
    (ht, hb), (wl, wr) = (_transpose_pads(k_eff[i], stride[i], mode, p[i])
                          for i in range(2))
    # the full output is the window of pads (k_eff - 1, k_eff - 1)
    y = F.pad(full, (wl - (k_eff[1] - 1), wr - (k_eff[1] - 1),
                     ht - (k_eff[0] - 1), hb - (k_eff[0] - 1)))
    y = _from_nchw(y, data_format)
    if b is not None:
        y = y + (b.reshape(1, -1, 1, 1) if data_format == "NCHW"
                 else b.reshape(1, 1, 1, -1))
    return y


@register("depthwise_conv2d", category="cnn")
def depthwise_conv2d(x, w, b=None, stride=(1, 1), padding=0,
                     dilation=(1, 1), mode="truncate", data_format="NCHW"):
    """Depthwise convolution, ``w`` [C*mult, 1, kH, kW]: ``conv2d`` with
    one group a channel (the JAX module's :125)."""
    c = x.shape[1] if data_format == "NCHW" else x.shape[3]
    return conv2d(x, w, b, stride, padding, dilation, mode, data_format,
                  groups=int(c))


def _pool(x, kind, kernel, stride, padding, mode, data_format, pnorm_p=2.0,
          count_include_pad=True):
    kh, kw = _pair(kernel)
    sh, sw = _pair(stride)
    xn = _to_nchw(x, data_format)
    (pt, pb), (pl, pr) = _spatial_pads(mode, padding, xn.shape[2:],
                                       (kh, kw), (sh, sw))
    pads = (pl, pr, pt, pb)
    explicit_pad = any(pads)
    if kind == "max":
        xp = F.pad(xn, pads, value=float("-inf")) if explicit_pad else xn
        y = F.max_pool2d(xp, (kh, kw), (sh, sw))
    elif kind == "avg":
        xp = F.pad(xn, pads) if explicit_pad else xn
        # DL4J avg pool divides by the full kernel size (padding cells
        # included) in Truncate mode, and by the real window count with
        # SAME; count_include_pad=False forces the window count for
        # explicit padding too (ONNX AveragePool default)
        if explicit_pad and (mode == "same" or not count_include_pad):
            s = F.avg_pool2d(xp, (kh, kw), (sh, sw), divisor_override=1)
            ones = F.pad(torch.ones_like(xn[:1, :1]), pads)
            cnt = F.avg_pool2d(ones, (kh, kw), (sh, sw), divisor_override=1)
            y = s / cnt
        else:
            y = F.avg_pool2d(xp, (kh, kw), (sh, sw))
    elif kind == "pnorm":
        xp = F.pad(xn, pads) if explicit_pad else xn
        s = F.avg_pool2d(torch.abs(xp) ** pnorm_p, (kh, kw), (sh, sw),
                         divisor_override=1)
        y = _safe_root(s, pnorm_p)
    else:
        raise ValueError(kind)
    return _from_nchw(y, data_format)


@register("maxpool2d", category="cnn")
def max_pool2d(x, kernel, stride=None, padding=0, mode="truncate",
               data_format="NCHW"):
    """Max pooling (SubsamplingLayer PoolingType.MAX)."""
    return _pool(x, "max", kernel, stride or kernel, padding, mode,
                 data_format)


@register("avgpool2d", category="cnn")
def avg_pool2d(x, kernel, stride=None, padding=0, mode="truncate",
               data_format="NCHW", count_include_pad=True):
    return _pool(x, "avg", kernel, stride or kernel, padding, mode,
                 data_format, count_include_pad=count_include_pad)


def pnorm_pool2d(x, kernel, stride=None, padding=0, mode="truncate",
                 data_format="NCHW", p=2.0):
    return _pool(x, "pnorm", kernel, stride or kernel, padding, mode,
                 data_format, p)


def global_pool(x, pool_type="max", data_format="NCHW", keepdims=False,
                p=2.0):
    """GlobalPoolingLayer: pool over all spatial (or time) dims."""
    if x.ndim == 5:
        dims = (2, 3, 4) if data_format in ("NCHW", "NCDHW") else (1, 2, 3)
    elif x.ndim == 4:
        dims = (2, 3) if data_format == "NCHW" else (1, 2)
    else:
        dims = (2,) if data_format == "NCHW" else (1,)
    if pool_type == "max":
        return torch.amax(x, dim=dims, keepdim=keepdims)
    if pool_type == "avg":
        return torch.mean(x, dim=dims, keepdim=keepdims)
    if pool_type == "sum":
        return torch.sum(x, dim=dims, keepdim=keepdims)
    if pool_type == "pnorm":
        return _safe_root(torch.sum(torch.abs(x) ** p, dim=dims,
                                    keepdim=keepdims), p)
    raise ValueError(pool_type)


@register("batch_norm", category="normalization")
def batch_norm(x, gamma, beta, mean, var, eps=1e-5, axis=1):
    """Batch-norm normalize step with given statistics, in x's dtype.
    ``axis`` is the channel axis (1 for NCHW, -1 for NHWC)."""
    shape = [1] * x.ndim
    shape[axis] = x.shape[axis]
    inv = torch.rsqrt(var.reshape(shape) + eps)
    y = (x - mean.reshape(shape)) * inv
    if gamma is not None:
        y = y * gamma.reshape(shape)
    if beta is not None:
        y = y + beta.reshape(shape)
    return y


@register("instance_norm", category="normalization")
def instance_norm(x, gamma, beta, eps=1e-5):
    """Per-instance, per-channel normalization over the spatial dims of
    ``[N, C, D1..Dn]`` (ONNX InstanceNormalization; the JAX module's
    :249): two passes, as ``jnp.var`` takes them."""
    dims = tuple(range(2, x.ndim))
    mean = x.mean(dims, keepdim=True)
    d = x - mean
    var = (d * d).mean(dims, keepdim=True)
    cshape = (1, x.shape[1]) + (1,) * len(dims)
    return d * torch.rsqrt(var + eps) * gamma.reshape(cshape) \
        + beta.reshape(cshape)


@register("layer_norm", category="normalization")
def layer_norm(x, gamma, beta, eps=1e-5, axis=-1):
    """LayerNorm over ``axis``: the mean and the variance in two passes,
    ``(x - mean) * rsqrt(var + eps)``, then ``* gamma + beta``, in x's
    dtype (the JAX package's formula; ``jnp.var`` is two-pass too). A
    graph records it for a plain LayerNorm (ONNX imports it so). The JAX
    package falls back to it from ``layer_norm_act``; the port's
    ``fused_epilogues.layer_norm_act`` runs K6 or its plain version
    instead, and the tests hold both to this op. An integer or bool ``x``
    normalizes in float32, as jnp's mean promotes it."""
    if not x.is_floating_point():
        x = x.float()
    mean = x.mean(axis, keepdim=True)
    d = x - mean
    var = (d * d).mean(axis, keepdim=True)
    return d * torch.rsqrt(var + eps) * gamma + beta


def dropout(x, rate, generator=None, deterministic=False):
    """Inverted dropout with the DROP rate ``rate`` (the JAX package's
    ``dropout``, :277): each element is kept with probability ``1 - rate``
    and scaled by ``1 / (1 - rate)``. The mask comes from
    ``torch.rand(..., generator=generator)`` on ``x``'s device, so a seeded
    generator repeats it; its bits are not the JAX package's threefry
    bits. Not a catalog op here: the JAX catalog's takes a JAX key."""
    if deterministic or rate == 0.0:
        return x
    keep = 1.0 - rate
    u = torch.rand(x.shape, generator=generator, device=x.device)
    return torch.where(u < keep, x / keep, torch.zeros_like(x))


@register("embedding_lookup", category="embedding")
def embedding_lookup(table, ids):
    """Rows of ``table`` ``[V, D]`` at the integer ``ids`` (any shape; float
    ids truncate to int, as ``jnp.asarray(ids, int32)`` does):
    EmbeddingLayer's and EmbeddingSequenceLayer's lookup (the JAX module's
    :287). ``jnp.take``'s rules: a negative id counts from the end, and an
    id outside ``[-V, V)`` gives a row of NaN (the type's minimum for a
    signed integer table)."""
    ids = torch.as_tensor(ids, device=table.device).to(torch.int64)
    v = table.shape[0]
    ids = torch.where(ids < 0, ids + v, ids)
    ok = (ids >= 0) & (ids < v)
    rows = table[torch.where(ok, ids, torch.zeros_like(ids))]
    fill = (float("nan") if table.is_floating_point()
            else torch.iinfo(table.dtype).min)
    return torch.where(ok[..., None], rows, torch.full_like(rows, fill))


# -- recurrence ---------------------------------------------------------------

@register("lstm_cell", category="rnn")
def lstm_cell(x, h, c, w_ih, w_hh, b, forget_bias=0.0):
    """Standard LSTM cell, gate order [i, f, o, g] (DL4J LSTMBlockCell
    order), in the inputs' dtype: ``z = x @ w_ih + h @ w_hh + b``,
    ``c' = sigmoid(f + forget_bias) * c + sigmoid(i) * tanh(g)``, ``h' =
    sigmoid(o) * tanh(c')``. The recurrent layers' gradient path; the
    inference path may take K8 (``ops/pallas_kernels.py``), which rounds
    at other points for 16-bit inputs."""
    z = torch.matmul(x, w_ih) + torch.matmul(h, w_hh) + b
    i, f, o, g = torch.chunk(z, 4, dim=-1)
    f = torch.sigmoid(f + forget_bias)
    c_new = f * c + torch.sigmoid(i) * torch.tanh(g)
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    return h_new, c_new


@register("graves_lstm_cell", category="rnn")
def graves_lstm_cell(x, h, c, w_ih, w_hh, b, w_peep):
    """Graves (peephole) LSTM cell (DL4J GravesLSTM; the JAX module's
    :315): gate order [i, f, o, g], peepholes ``w_peep`` ``[3, u]`` on i
    and f from ``c_{t-1}`` and on o from ``c_t``."""
    z = torch.matmul(x, w_ih) + torch.matmul(h, w_hh) + b
    i, f, o, g = torch.chunk(z, 4, dim=-1)
    i = torch.sigmoid(i + w_peep[0] * c)
    f = torch.sigmoid(f + w_peep[1] * c)
    c_new = f * c + i * torch.tanh(g)
    o = torch.sigmoid(o + w_peep[2] * c_new)
    return o * torch.tanh(c_new), c_new


@register("gru_cell", category="rnn")
def gru_cell(x, h, w_ih, w_hh, b, rb=None):
    """GRU cell, gate order [z, r, h~] (the JAX module's :331). With the
    recurrent bias ``rb`` ``[3u]``: the reset-after form (Keras
    ``reset_after=True``, CuDNN), candidate ``tanh(xh + r * (h @ RWh +
    rb_h))``; without: the classic form, candidate ``tanh(xh + (r * h) @
    RWh)``."""
    xz, xr, xh = torch.chunk(torch.matmul(x, w_ih) + b, 3, dim=-1)
    if rb is not None:
        hz, hr, hh = torch.chunk(torch.matmul(h, w_hh) + rb, 3, dim=-1)
        z = torch.sigmoid(xz + hz)
        r = torch.sigmoid(xr + hr)
        n = torch.tanh(xh + r * hh)
    else:
        u = w_hh.shape[0]
        z = torch.sigmoid(xz + torch.matmul(h, w_hh[:, :u]))
        r = torch.sigmoid(xr + torch.matmul(h, w_hh[:, u:2 * u]))
        n = torch.tanh(xh + torch.matmul(r * h, w_hh[:, 2 * u:]))
    return z * h + (1.0 - z) * n


@register("simple_rnn_cell", category="rnn")
def simple_rnn_cell(x, h, w_ih, w_hh, b, activation=torch.tanh):
    """Elman step ``activation(x @ W + h @ RW + b)`` (the JAX module's
    :360)."""
    return activation(torch.matmul(x, w_ih) + torch.matmul(h, w_hh) + b)


def _onnx_dirs(direction, n_dirs):
    if direction in ("forward", "reverse"):
        want = 1
    elif direction == "bidirectional":
        want = 2
    else:
        raise ValueError(f"ONNX RNN direction {direction!r} not supported")
    if n_dirs != want:
        raise ValueError(f"direction={direction!r} expects {want} weight "
                         f"slice(s), got {n_dirs}")


def _onnx_rnn(x, w, direction, run_dir):
    """Run ``run_dir(d, reverse)`` for each direction of an ONNX RNN node;
    ``(Y [T, D, B, H], [finals each [D, B, H]])``."""
    n_dirs = int(w.shape[0])
    _onnx_dirs(direction, n_dirs)
    outs = [run_dir(d, direction == "reverse" or d == 1)
            for d in range(n_dirs)]
    y = torch.stack([o[0] for o in outs], dim=1)
    finals = [torch.stack([o[k] for o in outs], dim=0)
              for k in range(1, len(outs[0]))]
    return y, finals


@register("onnx_lstm", category="rnn")
def onnx_lstm(x, w, r, b, direction="forward", hidden_size=0):
    """ONNX ``LSTM`` (default activations, layout 0, zero initial state;
    the JAX module's :380): x [T, B, I], w [D, 4H, I] and r [D, 4H, H] in
    ONNX's gate order [i, o, f, c], b [D, 8H] (Wb then Rb). The weights
    are reordered in the graph to ``lstm_cell``'s [i, f, o, g] (so their
    gradients reach the ONNX layout), then a time loop of ``lstm_cell``
    where JAX scans. Returns (Y [T, D, B, H], Y_h [D, B, H], Y_c)."""
    H = int(hidden_size)

    def reorder(m):  # [4H, K] rows iofc -> [K, 4H] columns ifoc
        return torch.cat([m[0:H], m[2 * H:3 * H], m[H:2 * H],
                          m[3 * H:4 * H]], dim=0).t()

    def run_dir(d, rev):
        w2, r2 = reorder(w[d]), reorder(r[d])
        bb = b[d][:4 * H] + b[d][4 * H:]
        b2 = torch.cat([bb[0:H], bb[2 * H:3 * H], bb[H:2 * H],
                        bb[3 * H:4 * H]])
        xs = torch.flip(x, (0,)) if rev else x
        h = torch.zeros((x.shape[1], H), dtype=x.dtype, device=x.device)
        c = torch.zeros_like(h)
        ys = []
        for t in range(xs.shape[0]):
            h, c = lstm_cell(xs[t], h, c, w2, r2, b2)
            ys.append(h)
        ys = torch.stack(ys) if ys else xs.new_zeros((0, x.shape[1], H))
        return (torch.flip(ys, (0,)) if rev else ys), h, c

    y, (y_h, y_c) = _onnx_rnn(x, w, direction, run_dir)
    return y, y_h, y_c


@register("onnx_gru", category="rnn")
def onnx_gru(x, w, r, b, direction="forward", hidden_size=0,
             linear_before_reset=0):
    """ONNX ``GRU`` (default activations, layout 0; the JAX module's
    :430): x [T, B, I], w [D, 3H, I] and r [D, 3H, H] in the gate order
    [z, r, h] (``gru_cell``'s), b [D, 6H] (Wb then Rb);
    ``linear_before_reset=1`` is ``gru_cell``'s reset-after form with the
    recurrent bias apart. Returns (Y [T, D, B, H], Y_h [D, B, H])."""
    H = int(hidden_size)

    def run_dir(d, rev):
        w2, r2 = w[d].t(), r[d].t()
        wb, rb = b[d][:3 * H], b[d][3 * H:]
        xs = torch.flip(x, (0,)) if rev else x
        h = torch.zeros((x.shape[1], H), dtype=x.dtype, device=x.device)
        ys = []
        for t in range(xs.shape[0]):
            h = (gru_cell(xs[t], h, w2, r2, wb, rb) if linear_before_reset
                 else gru_cell(xs[t], h, w2, r2, wb + rb, None))
            ys.append(h)
        ys = torch.stack(ys) if ys else xs.new_zeros((0, x.shape[1], H))
        return (torch.flip(ys, (0,)) if rev else ys), h

    y, (y_h,) = _onnx_rnn(x, w, direction, run_dir)
    return y, y_h


# -- the plain ops of the imported layers (not catalog ops) ------------------

def separable_conv2d(x, w_depth, w_point, b=None, stride=(1, 1), padding=0,
                     dilation=(1, 1), mode="truncate", data_format="NCHW"):
    """Depthwise then 1x1 pointwise convolution (the JAX module's :134)."""
    y = depthwise_conv2d(x, w_depth, None, stride, padding, dilation, mode,
                         data_format)
    return conv2d(y, w_point, b, (1, 1), 0, (1, 1), "truncate", data_format)


def local_response_normalization(x, k=2.0, n=5, alpha=1e-4, beta=0.75,
                                 data_format="NCHW"):
    """Cross-channel LRN (the JAX module's :262): ``x / (k + alpha *
    s)**beta``, ``s`` the sum of squares over a window of ``n`` channels
    padded ``n // 2`` each side (the JAX ``reduce_window``)."""
    caxis = 1 if data_format == "NCHW" else 3
    sq = torch.movedim(torch.square(x), caxis, -1)
    half = n // 2
    padded = F.pad(sq, (half, half))
    width = padded.shape[-1] - n + 1
    s = padded[..., 0:width]
    for j in range(1, n):
        s = s + padded[..., j:j + width]
    return x / torch.pow(k + alpha * torch.movedim(s, -1, caxis), beta)


def upsampling2d(x, size, data_format="NCHW"):
    """Nearest upsampling by repetition (the JAX module's :492)."""
    sh, sw = _pair(size)
    hax = 2 if data_format == "NCHW" else 1
    return torch.repeat_interleave(torch.repeat_interleave(x, sh, dim=hax),
                                   sw, dim=hax + 1)


def _pads4(padding):
    """``(top, bottom, left, right)`` of ``(h, w)`` or ``((t, b), (l,
    r))``."""
    if isinstance(padding, int):
        return (padding,) * 4
    if isinstance(padding[0], (tuple, list)):
        (pt, pb), (pl, pr) = padding
    else:
        pt = pb = int(padding[0])
        pl = pr = int(padding[1])
    return int(pt), int(pb), int(pl), int(pr)


def zero_padding2d(x, padding, data_format="NCHW"):
    """Zero padding of the spatial dims (the JAX module's :500):
    ``padding`` (pad_h, pad_w) symmetric, or ((top, bottom), (left,
    right))."""
    pt, pb, pl, pr = _pads4(padding)
    if data_format == "NCHW":
        return F.pad(x, (pl, pr, pt, pb))
    return F.pad(x, (0, 0, pl, pr, pt, pb))


def space_to_depth(x, block_size, data_format="NCHW"):
    """Blocks of ``block_size`` x ``block_size`` pixels into channels (the
    JAX module's :526)."""
    b = block_size
    if data_format == "NCHW":
        n, c, h, w = x.shape
        x = x.reshape(n, c, h // b, b, w // b, b).permute(0, 3, 5, 1, 2, 4)
        return x.reshape(n, c * b * b, h // b, w // b)
    n, h, w, c = x.shape
    x = x.reshape(n, h // b, b, w // b, b, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, h // b, w // b, c * b * b)


def depth_to_space(x, block_size, data_format="NCHW"):
    """The inverse of :func:`space_to_depth` (the JAX module's :540)."""
    b = block_size
    if data_format == "NCHW":
        n, c, h, w = x.shape
        x = x.reshape(n, b, b, c // (b * b), h, w).permute(0, 3, 4, 1, 5, 2)
        return x.reshape(n, c // (b * b), h * b, w * b)
    n, h, w, c = x.shape
    x = x.reshape(n, h, w, b, b, c // (b * b)).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, h * b, w * b, c // (b * b))
