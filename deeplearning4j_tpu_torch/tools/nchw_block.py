"""LeNet's first convolution and a batch norm in NCHW, forward and backward.

The check that channels-first epilogues reach K1 and K2 on the card:
``chip_smoke.py`` ([nchw]) and the card test of
``tests/test_torch_affine_act.py`` run :func:`nchw_block` on ``cuda`` and
hold it against the same call on the CPU (float32 and float64).
"""

from __future__ import annotations

import torch

from ..nn.layers.conv import BatchNormalization, ConvolutionLayer


def nchw_block(x, params, device):
    """LeNet's first convolution in DL4J's NCHW layout (the JAX package's
    ``models/lenet.py``: 20 x 5x5, padding 2, bias and ReLU), then
    BatchNormalization in training mode with a ReLU folded in, through the
    port's layers on ``device``. ``params`` holds ``W``, ``b``, ``gamma``
    and ``beta``. Returns the output and the gradients of ``sum(out * w)``
    (``w`` a fixed ramp) with respect to x and every parameter. (The ReLU
    before the batch norm keeps the bias gradient from vanishing.)"""
    conv = ConvolutionLayer(n_out=params["W"].shape[0], kernel=(5, 5),
                            padding=(2, 2), activation="relu")
    bn = BatchNormalization()
    leaves = {k: v.to(device).requires_grad_() for k, v in params.items()}
    xd = x.to(device).requires_grad_()
    y = conv.apply({"W": leaves["W"], "b": leaves["b"]}, xd, {},
                   train=True)[0]
    n = y.shape[1]
    state = {"mean": torch.zeros(n, device=device),
             "var": torch.ones(n, device=device)}
    z = bn.apply({"gamma": leaves["gamma"], "beta": leaves["beta"]}, y,
                 state, train=True, fold_act="relu")[0]
    w = torch.linspace(-1.0, 1.0, z.numel(), device=device).reshape(z.shape)
    grads = torch.autograd.grad((z * w).sum(), [xd, *leaves.values()])
    return z.detach(), dict(zip(["x", *leaves], grads))
