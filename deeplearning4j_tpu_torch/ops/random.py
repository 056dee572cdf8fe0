"""The image resize ops of the catalog.

Port of the three resize ops of ``deeplearning4j_tpu/ops/random.py``
(:53-110), the ones the graph importers record (TF ``ResizeBilinear`` and
``ResizeNearestNeighbor``, ONNX ``Resize``). The JAX package computes
them with ``jax.image.resize``, in XLA, outside any Pallas kernel; here
they are plain torch with the same sampling:

- **nearest**: half-pixel centers, source index ``floor((i + 0.5) * in /
  out)`` computed in float32, as ``jax.image.resize`` does;
- **bilinear**: ``jax.image.resize``'s ``scale_and_translate`` with the
  triangle kernel and its default ``antialias=True``: a weight matrix per
  spatial dim (the kernel widened by ``in / out`` when downsampling,
  each output's weights normalized to sum to 1, zero where the sample
  falls outside the input), contracted with the input in its dtype
  (integer inputs in float32).

The random distributions, the other image ops and ``random.*`` take a
JAX key or are not on a ported path: ROADMAP Queue 1 item 10.
"""

from __future__ import annotations

import math

import torch

from . import register


def _spatial(x, data_format):
    """The (H, W) axes and sizes and the (batch, channel) sizes."""
    if data_format == "NHWC":
        return (1, 2), (x.shape[1], x.shape[2]), (x.shape[0], x.shape[3])
    return (2, 3), (x.shape[2], x.shape[3]), (x.shape[0], x.shape[1])


def _check_leading(expect_leading, leading):
    if expect_leading is not None and tuple(expect_leading) != tuple(leading):
        raise ValueError(
            f"resize: node requested leading dims {tuple(expect_leading)} "
            f"but input has {tuple(leading)} (batch/channel resize "
            "unsupported)")


def _nearest(x, axes, size):
    for ax, n in zip(axes, size):
        m = x.shape[ax]
        if m == n:
            continue
        pos = (torch.arange(n, dtype=torch.float32) + 0.5) * float(m) / float(n)
        idx = torch.floor(pos).to(torch.int64).to(x.device)
        x = torch.index_select(x, ax, idx)
    return x


def _linear_weights(m: int, n: int, device) -> torch.Tensor:
    """``jax.image``'s ``compute_weight_mat`` for the triangle kernel with
    antialiasing, scale ``n / m``: ``[m, n]`` in float32."""
    inv_scale = 1.0 / (n / m)
    kernel_scale = max(inv_scale, 1.0)
    sample = (torch.arange(n, dtype=torch.float32) + 0.5) * inv_scale \
        - 0.0 * inv_scale - 0.5
    dist = (sample[None, :] - torch.arange(m, dtype=torch.float32)[:, None]
            ).abs() / kernel_scale
    w = torch.clamp(1.0 - dist, min=0.0)
    total = w.sum(0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(torch.finfo(torch.float32)
                                                  .eps),
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= m - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w)).to(device)


def _bilinear(x, axes, size):
    if not x.is_floating_point():
        x = x.float()
    for ax, n in zip(axes, size):
        m = x.shape[ax]
        if m == n:
            continue
        w = _linear_weights(m, n, x.device).to(x.dtype)
        x = torch.movedim(torch.tensordot(torch.movedim(x, ax, -1), w,
                                          dims=([x.ndim - 1], [0])), -1, ax)
    return x


@register("image.resize_bilinear", category="image")
def resize_bilinear(x, size, data_format="NHWC", expect_leading=None):
    """Resize the spatial dims of [B, H, W, C] (or [B, C, H, W]) to
    ``size`` (h, w), bilinear with antialiasing (``jax.image.resize``'s
    ``"bilinear"``)."""
    axes, _, leading = _spatial(x, data_format)
    _check_leading(expect_leading, leading)
    return _bilinear(x, axes, tuple(int(s) for s in size))


@register("image.resize_nearest", category="image")
def resize_nearest(x, size, data_format="NHWC", require_integer_upscale=False,
                   expect_leading=None):
    """Nearest-neighbour resize to ``size`` on half-pixel centers. The two
    guards are the importers': the batch and channel sizes an ONNX node
    named, and an integer upscale where the node's asymmetric-floor grid
    equals half-pixel sampling only then."""
    axes, (xh, xw), leading = _spatial(x, data_format)
    h, w = (int(s) for s in size)
    _check_leading(expect_leading, leading)
    if require_integer_upscale and (h % xh or w % xw):
        raise ValueError(
            f"nearest resize {xh}x{xw} -> {h}x{w}: asymmetric-floor grid "
            "only matches half-pixel sampling for integer upscales")
    return _nearest(x, axes, (h, w))


@register("image.resize_scale", category="image")
def resize_scale(x, scale, method="nearest", data_format="NHWC"):
    """Resize the spatial dims by ``scale`` (sh, sw): ``floor(in * s)``
    each (ONNX ``Resize``'s output size), ``method`` "nearest" or
    "bilinear"."""
    axes, (xh, xw), _ = _spatial(x, data_format)
    size = (int(math.floor(xh * scale[0])), int(math.floor(xw * scale[1])))
    if method == "nearest":
        return _nearest(x, axes, size)
    if method in ("bilinear", "linear"):
        return _bilinear(x, axes, size)
    raise ValueError(f"resize method {method!r} not supported")
