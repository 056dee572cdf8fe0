"""Activation functions (the DL4J ``Activation`` catalog).

Port of ``deeplearning4j_tpu/ops/activations.py``. Names are the strings
used in config JSON; :func:`get` resolves them case-insensitively with
underscores stripped, as the JAX package does. Each is also in the op
catalog as ``act.<name>`` (the names a SameDiff graph records), with the
JAX function's keyword names (``act.softmax(x, axis=-1)``). Integer and
bool inputs give jnp's dtypes: float32 from the float-valued functions,
int32 from ``relu`` and ``cube`` of bools.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import register
from .math import _float, _int32

# name -> callable; populated by _act
ACTIVATIONS = {}


def _act(name):
    def deco(fn):
        ACTIVATIONS[name] = fn
        register(f"act.{name}", category="activation")(fn)
        return fn
    return deco


@_act("identity")
def identity(x):
    return x


@_act("relu")
def relu(x):
    return torch.relu(_int32(x))


@_act("relu6")
def relu6(x):
    return torch.clamp(relu(x), max=6.0)


@_act("leakyrelu")
def leakyrelu(x, alpha=0.01):
    # DL4J LeakyReLU default alpha = 0.01
    return torch.where(x >= 0, x, alpha * x)


@_act("thresholdedrelu")
def thresholdedrelu(x, theta=1.0):
    # jnp.where(x > theta, x, 0.0): integer and bool inputs give float32
    x = _float(x)
    return torch.where(x > theta, x, torch.zeros_like(x))


@_act("elu")
def elu(x, alpha=1.0):
    return F.elu(_float(x), alpha)


@_act("selu")
def selu(x):
    return F.selu(_float(x))


@_act("gelu")
def gelu(x, approximate=True):
    # DL4J GELU is the tanh approximation; ONNX Gelu is the erf form.
    # +inf passes through, as in jax.nn.gelu (torch's erf form gives NaN)
    x = _float(x)
    y = F.gelu(x, approximate="tanh" if approximate else "none")
    return torch.where(x == float("inf"), x, y)


@_act("swish")
def swish(x):
    return F.silu(x)


@_act("mish")
def mish(x):
    x = _float(x)
    return x * torch.tanh(F.softplus(x))


@_act("sigmoid")
def sigmoid(x):
    return torch.sigmoid(x)


@_act("hardsigmoid")
def hardsigmoid(x):
    # DL4J HardSigmoid: clamp(0.2*x + 0.5, 0, 1)
    return torch.clamp(0.2 * x + 0.5, 0.0, 1.0)


@_act("tanh")
def tanh(x):
    return torch.tanh(x)


@_act("hardtanh")
def hardtanh(x):
    return torch.clamp(x, -1.0, 1.0)


@_act("rationaltanh")
def rationaltanh(x):
    # DL4J RationalTanh: 1.7159 * sgn(x) * (1 - 1/(1 + |c| + c^2 + 1.41645 c^4)),
    # c = 2x/3
    cx = torch.abs(2.0 * x / 3.0)
    a = 1.0 + cx + cx * cx + 1.41645 * cx ** 4
    return 1.7159 * torch.sign(x) * (1.0 - 1.0 / a)


@_act("recttanh")
def recttanh(x):
    return torch.clamp(torch.tanh(x), min=0.0)


@_act("softmax")
def softmax(x, axis=-1):
    return torch.softmax(_float(x), dim=axis)


@_act("logsoftmax")
def logsoftmax(x, axis=-1):
    return torch.log_softmax(_float(x), dim=axis)


@_act("softmax_onnx_legacy")
def softmax_onnx_legacy(x, axis=1, log=False):
    """ONNX opset<13 Softmax: flatten to 2D at ``axis``, softmax over the
    second dim, reshape back."""
    shape = x.shape
    ax = axis if axis >= 0 else len(shape) + axis
    lead = 1
    for s in shape[:ax]:
        lead *= int(s)
    flat = _float(x).reshape(lead, -1)
    y = torch.log_softmax(flat, dim=-1) if log else torch.softmax(flat, dim=-1)
    return y.reshape(shape)


@_act("softplus")
def softplus(x):
    return F.softplus(_float(x))


@_act("softsign")
def softsign(x):
    return F.softsign(_float(x))


@_act("cube")
def cube(x):
    return _int32(x) ** 3


@_act("rrelu")
def rrelu(x, lower=1.0 / 8.0, upper=1.0 / 3.0, generator=None):
    """Randomized leaky ReLU: negative slope drawn U(lower, upper) per
    element when a ``torch.Generator`` is given (training mode), the mean
    slope otherwise (inference)."""
    if generator is None:
        alpha = (lower + upper) / 2.0
    else:
        alpha = torch.empty(x.shape, dtype=x.dtype, device=x.device)
        alpha.uniform_(lower, upper, generator=generator)
    return torch.where(x >= 0, x, alpha * x)


def get(name_or_fn):
    """Resolve an activation by DL4J-style name (case-insensitive) or pass
    a callable through."""
    if callable(name_or_fn):
        return name_or_fn
    key = str(name_or_fn).lower().replace("_", "")
    if key not in ACTIVATIONS:
        raise ValueError(f"Unknown activation {name_or_fn!r}; known: "
                         f"{sorted(ACTIVATIONS)}")
    return ACTIVATIONS[key]


def name_of(fn) -> str:
    for k, v in ACTIVATIONS.items():
        if v is fn:
            return k
    raise ValueError(f"Unregistered activation {fn}")
