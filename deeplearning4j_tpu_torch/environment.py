"""Runtime environment: the f32 precision policy and the device policy.

Port of ``deeplearning4j_tpu/environment.py``. Nothing here changes a
process-wide torch setting at import time; the precision policy is applied
around each forward, and around each whole training step (forward,
backward and update), by :func:`precision` and restored afterwards. A
backward run after the context has exited would run its cuDNN/cuBLAS
kernels under whatever the global switches are (cuDNN's TF32 defaults to
on), so the training step keeps its backward inside the context.

Precision (``DL4J_TPU_F32_MATMUL_PRECISION`` or
``Environment.instance().f32_matmul_precision``):

- ``auto``: on CUDA, TF32 is allowed for f32 matmuls and cuDNN convs (the
  analogue of the JAX package's single-bf16-pass DEFAULT on the TPU); on
  the CPU, full f32 (TF32 does not exist there).
- ``highest``: full f32 everywhere. Turns off BOTH
  ``torch.backends.cuda.matmul.allow_tf32`` and
  ``torch.backends.cudnn.allow_tf32`` (cuDNN convs default to TF32).
- ``high`` / ``default``: TF32 allowed on CUDA.

Device: :func:`resolve_device` maps ``None`` to ``cuda`` and raises when
CUDA is requested but absent. An entry point never carries on silently on
the CPU.
"""

from __future__ import annotations

import contextlib
import os

import torch

_PRECISIONS = ("auto", "highest", "high", "default")


class Environment:
    _instance = None

    def __init__(self):
        self.f32_matmul_precision = os.environ.get(
            "DL4J_TPU_F32_MATMUL_PRECISION", "auto")
        if self.f32_matmul_precision not in _PRECISIONS:
            raise ValueError(
                f"DL4J_TPU_F32_MATMUL_PRECISION={self.f32_matmul_precision!r}"
                f" — expected one of: {', '.join(_PRECISIONS)}")

    @classmethod
    def instance(cls) -> "Environment":
        if cls._instance is None:
            cls._instance = cls()
        return cls._instance


def allow_tf32(device) -> bool:
    """Whether f32 matmuls/convs on ``device`` may use TF32 under the
    current policy (re-read per call so callers can flip the policy)."""
    mode = Environment.instance().f32_matmul_precision
    if mode not in _PRECISIONS:
        raise ValueError(f"f32_matmul_precision={mode!r} — expected one of: "
                         f"{', '.join(_PRECISIONS)}")
    return torch.device(device).type == "cuda" and mode != "highest"


@contextlib.contextmanager
def precision(device):
    """Apply the precision policy for one forward or one training step on
    ``device``; both TF32 switches are restored on exit."""
    tf32 = allow_tf32(device)
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for another. Raises when the resolved device is CUDA and no CUDA
    device is present — there is no silent CPU fallback."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; expected cuda or cpu")
    return dev
