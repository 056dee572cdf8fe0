"""The port's ``math.*``, ``act.*`` and ``reduce.*`` ops against the JAX
package's on edge inputs, on the CPU: NaN, signed zeros, infinities,
division by zero, and integer and bool inputs. ``test_torch_samediff.py``
holds every catalog op on ordinary values; these are the inputs where the
two libraries' defaults part (ROADMAP Queue 3, "Repaired").

Each case runs the JAX op and the port's op on the same numpy input. The
result must have JAX's dtype (JAX runs without x64, so integer results are
int32) and its values: integers and bools equal, floats within rtol 1e-5
and atol 1e-6 (the catalog test's tolerance: the same arithmetic in
another library), NaN where JAX has NaN,
and the sign of a zero as JAX gives it where that is the point (``sign``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deeplearning4j_tpu import ops as jops
from deeplearning4j_tpu_torch import ops

EDGE = np.array([1.0, -1.0, 0.0, -0.0, np.nan, np.inf, -np.inf, 2.5, -7.5,
                 3.0], np.float32)
I32 = np.array([[-3, 0, 2], [5, -1, 7]], np.int32)
BOOL = np.array([[True, False, True], [False, False, True]])
# integer dividends against divisors with zeros in them
DIVIDEND = np.array([-7, -1, 0, 1, 7, 5, -6, 3, 0, 100], np.int64)
DIVISOR = np.array([0, 2, 0, -3, 0, 0, 4, -1, 5, 0], np.int64)
# every (x, y) pair of the edge values: y = 0, -0, inf, NaN included
FX, FY = (a.ravel() for a in np.meshgrid(EDGE, EDGE))

CASES = [
    # 1. sign keeps NaN (torch.sign gives 0) and -0.0
    ("math.sign", (EDGE,), {}),
    # 2. floor division of floats: by zero and of infinities gives NaN
    ("math.floordiv", (FX, FY), {}),
    ("math.floordiv", (np.float32([7.0, -7.0, 7.0, -7.0, 0.5]),
                       np.float32([2.0, 2.0, -2.0, -2.0, 0.25])), {}),
    ("math.floordiv", (I32, np.int32(2)), {}),
] + [
    # 2b. integer and bool floor division and modulo by zero: XLA's values
    # (floordiv -1 for a zero dividend, -2 for another signed one, all
    # ones for uint8; mod 0) where torch raises
    (name, (x, y), {})
    for name in ("math.floordiv", "math.mod")
    for x, y in [(a.astype(dt), b.astype(dt))
                 for a, b in ((DIVIDEND, DIVISOR), (DIVIDEND, DIVISOR[::-1]))
                 for dt in (np.int8, np.int16, np.int32)]
    + [(np.abs(DIVIDEND).astype(np.uint8), DIVISOR.astype(np.uint8)),
       (np.abs(DIVIDEND).astype(np.uint8), np.uint8(0)),
       (DIVIDEND.astype(np.int32), np.int32(0)),
       (DIVIDEND != 0, DIVISOR != 0), (BOOL, np.zeros_like(BOOL))]
] + [
    # 3. integer and bool inputs stay int32
    ("math.cumprod", (I32,), {"axis": 1}),
    ("math.cumprod", (I32,), {}),
    ("math.cumprod", (BOOL,), {"axis": 0}),
    ("math.square", (BOOL,), {}),
    ("act.cube", (BOOL,), {}),
    ("act.cube", (I32,), {}),
] + [
    # 4a. integer (and bool) inputs of float-valued activations: float32
    (name, (x,), attrs)
    for name, attrs in (("act.softmax", {}), ("act.logsoftmax", {}),
                        ("act.softmax_onnx_legacy", {"axis": 1}),
                        ("act.gelu", {}), ("act.gelu", {"approximate": False}),
                        ("act.elu", {}), ("act.selu", {}),
                        ("act.softplus", {}), ("act.mish", {}))
    for x in ((I32,) if "softmax" in name else (I32, BOOL))
] + [
    # 4b. bool inputs the port refused
    (name, (BOOL,), attrs)
    for name, attrs in (("act.relu", {}), ("act.relu6", {}),
                        ("act.softsign", {}), ("math.abs", {}),
                        ("math.floor", {}), ("math.ceil", {}),
                        ("reduce.argmax", {}), ("reduce.argmax", {"axis": 1}),
                        ("reduce.argmin", {}), ("reduce.argmin", {"axis": 0}),
                        ("reduce.norm1", {}), ("reduce.norm1", {"axis": 0}),
                        ("reduce.normmax", {}),
                        ("reduce.normmax", {"axis": 1}))
] + [
    # 4c. thresholdedrelu of integers and bools: jnp.where(x > t, x, 0.0)
    ("act.thresholdedrelu", (I32,), {}),
    ("act.thresholdedrelu", (I32,), {"theta": 0.5}),
    ("act.thresholdedrelu", (BOOL,), {"theta": 0.0}),
    # and the float values they must not change
    ("act.relu", (EDGE,), {}), ("act.relu6", (I32,), {}),
    ("math.abs", (EDGE,), {}), ("math.floor", (EDGE,), {}),
    ("math.ceil", (EDGE,), {}), ("reduce.normmax", (I32,), {}),
]


def _dtype(x) -> str:
    if isinstance(x, torch.Tensor):
        return str(x.dtype).replace("torch.", "")
    return np.dtype(x.dtype).name


@pytest.mark.parametrize("name,args,attrs", CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(CASES)])
def test_edge_input_matches_jax(name, args, attrs):
    want = jops.lookup(name)(*[jnp.asarray(a) for a in args], **attrs)
    got = ops.lookup(name)(*[torch.from_numpy(np.array(a)) for a in args],
                           **attrs)
    assert _dtype(got) == _dtype(want), name
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape
    if np.issubdtype(want.dtype, np.floating):
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        if name == "math.sign":
            np.testing.assert_array_equal(np.signbit(got), np.signbit(want))
    else:
        np.testing.assert_array_equal(got, want)
