"""The port's ``math.*``, ``act.*`` and ``reduce.*`` ops against the JAX
package's on edge inputs, on the CPU: NaN, signed zeros, infinities,
division by zero, and integer and bool inputs. ``test_torch_samediff.py``
holds every catalog op on ordinary values; these are the inputs where the
two libraries' defaults part (ROADMAP Queue 3, "Repaired"), the
``epilogue.*`` ops on integer and bool inputs among them, and ties in
``sort.top_k``/``sort.in_top_k``. The last test pins the divergences the
port keeps on purpose (``ops/math.py``'s docstring): inputs JAX refuses
that the port promotes.

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


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    """The suite runs in parallel workers: keep this module's torch CPU
    work to two threads, and restore the setting after it."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        yield
    finally:
        torch.set_num_threads(old)


EDGE = np.array([1.0, -1.0, 0.0, -0.0, np.nan, np.inf, -np.inf, 2.5, -7.5,
                 3.0], np.float32)
I32 = np.array([[-3, 0, 2], [5, -1, 7]], np.int32)
BOOL = np.array([[True, False, True], [False, False, True]])
# integer dividends against divisors with zeros in them
DIVIDEND = np.array([-7, -1, 0, 1, 7, 5, -6, 3, 0, 100], np.int64)
DIVISOR = np.array([0, 2, 0, -3, 0, 0, 4, -1, 5, 0], np.int64)
# square int32 and bool matrices for the linalg ops (the bool one's
# symmetric part is positive definite)
SQ_I32 = np.array([[2, 1], [1, 3]], np.int32)
SQ_BOOL = np.array([[True, False], [True, True]])
# the ROADMAP's integer epilogue input
EPI_I32 = np.array([[7, -7, 5, 0], [1, 2, -3, 4]], np.int32)
# float values no integer type holds, and a fraction
CAST_IN = np.float32([np.nan, np.inf, -np.inf, 300, -300, 3e9, 2.7])
SINGULAR = np.float32([[1, 2], [2, 4]])
NOT_PD = np.float32([[1, 2], [2, 1]])
SPD = np.float32([[4, 2], [2, 3]])
GELU_IN = np.float32([np.nan, np.inf, -np.inf, -0.0])
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
] + [
    # 5. integer and bool fmod by zero gives 0 (torch raises), and bools
    # fmod in int32
    ("math.fmod", (x, y), {})
    for x, y in [(a.astype(dt), b.astype(dt))
                 for a, b in ((DIVIDEND, DIVISOR), (DIVIDEND, DIVISOR[::-1]))
                 for dt in (np.int8, np.int16, np.int32)]
    + [(np.abs(DIVIDEND).astype(np.uint8), DIVISOR.astype(np.uint8)),
       (DIVIDEND.astype(np.int32), np.int32(0)),
       (DIVIDEND != 0, DIVISOR != 0), (BOOL, np.int32(2))]
] + [
    # 6. traces of int32, int8 and bool are int32 (torch sums into int64)
    ("linalg.trace", (SQ_I32,), {}), ("linalg.trace", (SQ_BOOL,), {}),
    ("linalg.trace", (I32,), {"offset": 1}),
    ("linalg.trace", (np.ones((2, 3, 3), np.int8),), {}),
] + [
    # 7. integer and bool inputs JAX promotes to float32
    (name, (x,), attrs)
    for name, attrs in (("linalg.norm", {}), ("linalg.norm", {"ord": 1,
                                                              "axis": 0}),
                        ("linalg.det", {}), ("linalg.inverse", {}),
                        ("linalg.cholesky", {}))
    for x in (SQ_I32, SQ_BOOL)
] + [
    ("linalg.norm", (I32[0],), {"ord": np.inf}),
    ("linalg.cholesky", (np.float32([[4, 1], [3, 5]]),), {}),  # (a + a^T)/2
    ("linalg.solve", (SQ_I32, SQ_I32), {}),
    ("linalg.solve", (SQ_BOOL, SQ_BOOL), {}),
    ("layer_norm", (I32, np.ones(3, np.float32), np.zeros(3, np.float32)),
     {}),
    ("layer_norm", (BOOL, np.ones(3, np.float32), np.zeros(3, np.float32)),
     {}),
    ("layer_norm", (I32, np.int32([1, 2, 3]), np.int32([0, 1, 0])), {}),
    ("loss.softmax_ce_logits", (np.float32([[1, 0, 0], [0, 0, 1]]), I32),
     {}),
    ("loss.softmax_ce_logits", (np.int32([[1, 0, 0], [0, 0, 1]]), I32), {}),
] + [
    # 8. bool contractions, powers and segment max/min that torch refuses
    ("linalg.mmul", (SQ_BOOL, SQ_BOOL), {}),
    ("linalg.mmul", (SQ_BOOL, SQ_I32), {}),
    ("linalg.mmul", (BOOL, BOOL), {"transpose_b": True}),
    ("linalg.tensordot", (SQ_BOOL, SQ_BOOL), {"axes": 1}),
    ("linalg.einsum", (SQ_BOOL, SQ_BOOL), {"equation": "ij,jk->ik"}),
    ("linalg.einsum", (SQ_BOOL, SQ_I32), {"equation": "ij,jk->ik"}),
    ("math.pow", (BOOL, BOOL), {}), ("math.pow", (BOOL, np.int32(3)), {}),
    ("math.pow", (I32, BOOL), {}),
] + [
    (name, (np.array([True, False, True, False]), np.int32([0, 0, 1, 3])),
     {"num_segments": 3})
    for name in ("scatter.segment_max", "scatter.segment_min")
] + [
    # 9. the epilogue ops on integer and bool x: JAX's fallback formula,
    # which promotes (torch computed in float32 and cast back to int32)
    ("epilogue.bias_act", (EPI_I32, np.ones(4, np.float32)),
     {"act": "gelu_exact"}),
    ("epilogue.bias_act", (EPI_I32, np.ones(4, np.int32)),
     {"act": "gelu_exact"}),
    ("epilogue.bias_act", (EPI_I32, np.ones(4, np.int32)), {"act": "relu"}),
    ("epilogue.bias_act", (EPI_I32, np.float32([0.5, 1, 2, 3])),
     {"act": "sigmoid"}),
    ("epilogue.bias_act", (BOOL,), {"act": "relu"}),
    ("epilogue.layer_norm_act", (EPI_I32, np.ones(4, np.float32),
                                 np.zeros(4, np.float32)), {"act": "gelu"}),
    ("epilogue.layer_norm_act", (EPI_I32 > 0, np.ones(4, np.float32),
                                 np.zeros(4, np.float32)), {}),
    # float -> integer casts saturate: NaN to 0, out of range to the ends
    *[("math.cast", (CAST_IN,), {"dtype": d})
      for d in ("int8", "uint8", "int16", "int32")],
    # singular and not positive definite matrices, alone and in a batch
    # beside a good one: infinities and NaNs where torch would raise
    ("linalg.inverse", (SINGULAR,), {}),
    ("linalg.inverse", (np.stack([SPD, SINGULAR]),), {}),
    ("linalg.solve", (SINGULAR, np.float32([1, 2])), {}),
    ("linalg.solve", (np.stack([SPD, SINGULAR]), np.float32([[1], [2]])),
     {}),
    ("linalg.cholesky", (NOT_PD,), {}),
    ("linalg.cholesky", (np.stack([SPD, NOT_PD]),), {}),
    # the exact GELU at +inf
    ("act.gelu", (GELU_IN,), {"approximate": False}),
    ("act.gelu", (GELU_IN,), {"approximate": True}),
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


TOP_K_CASES = [
    (np.float32([3, 3, 3, 0, 0, 3, 1]), 2),  # JAX: indices [0, 1]
    (np.maximum(np.random.default_rng(0).standard_normal((64, 100)), 0)
     .astype(np.float32), 60),               # ReLU rows: ties at 0
    (np.array([[True, False, True, True], [False, False, True, False]]), 3),
    (np.int32([[5, 1, 5, 5, 2], [0, 0, 0, 0, 0]]), 4),
    (np.float32([[1, np.nan, 2, np.nan]]), 3),
]


@pytest.mark.parametrize("a,k", TOP_K_CASES,
                         ids=[f"top_k-{i}" for i in range(len(TOP_K_CASES))])
def test_top_k_orders_ties_as_jax(a, k):
    """``lax.top_k`` puts the lower index first among equal values;
    ``torch.topk`` orders them arbitrarily (and refuses bools)."""
    want = jops.lookup("sort.top_k")(jnp.asarray(a), k=k)
    got = ops.lookup("sort.top_k")(torch.from_numpy(a), k=k)
    for g, w in zip(got, want):
        assert _dtype(g) == _dtype(w)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("preds,targets,k", [
    (np.float32([[2, 2, 0, 0]]), np.int32([1]), 1),  # JAX: False
    (np.float32([[2, 2, 0, 0]]), np.int32([0]), 1),
    (np.float32([[1, 3, 3, 3], [0, 0, 0, 0]]), np.int32([3, 2]), 2),
    (np.maximum(np.random.default_rng(1).standard_normal((64, 100)), 0)
     .astype(np.float32), np.random.default_rng(2).integers(0, 100, 64)
     .astype(np.int32), 60),
], ids=["tie-lower-wins", "tie-first", "ties-k2", "relu-rows"])
def test_in_top_k_orders_ties_as_jax(preds, targets, k):
    want = jops.lookup("sort.in_top_k")(jnp.asarray(preds),
                                        jnp.asarray(targets), k=k)
    got = ops.lookup("sort.in_top_k")(torch.from_numpy(preds),
                                      torch.from_numpy(targets), k=k)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("name,args,attrs", [
    ("math.rsqrt", (I32,), {}), ("math.rsqrt", (BOOL,), {}),
    ("act.sigmoid", (I32,), {}), ("act.sigmoid", (BOOL,), {}),
    ("act.softmax", (BOOL,), {}), ("act.logsoftmax", (BOOL,), {}),
    ("act.softmax_onnx_legacy", (BOOL,), {"axis": 1}),
    ("act.rationaltanh", (BOOL,), {}),
])
def test_recorded_divergence_promotes_what_jax_refuses(name, args, attrs):
    """Where jnp raises TypeError on an integer or bool input, these port
    ops promote it to float32 instead, a divergence recorded in
    ``ops/math.py``'s docstring (the activations promote integer and bool
    inputs as a class)."""
    with pytest.raises(TypeError):
        jops.lookup(name)(*[jnp.asarray(a) for a in args], **attrs)
    got = ops.lookup(name)(*[torch.from_numpy(np.array(a)) for a in args],
                           **attrs)
    assert got.dtype == torch.float32
    want = ops.lookup(name)(*[torch.from_numpy(np.array(a)).float()
                              for a in args], **attrs)
    torch.testing.assert_close(got, want, equal_nan=True)
