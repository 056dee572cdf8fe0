"""K8's module, the fused LSTM step, against the JAX package on the CPU,
and (marked ``cuda``, skipped without a card) K8 itself against its plain
version on the card.

1. K8's plain version (``kernels/lstm_cell.py::lstm_cell_reference``)
   against the JAX package's ``lstm_cell_fused(interpret=True)`` (the
   Pallas kernel's body run by the interpreter) and ``nnops.lstm_cell``,
   on the same numpy inputs: float32 within rtol/atol 1e-5 (the tolerance
   of ``tests/test_ops.py:479-482``); bfloat16 and float16 within
   ``lstm_cell.tolerance``: one ulp of the output dtype at the reference
   value, or the float32 bound where that is larger (near 0, where the two
   libraries' f32 sums in another order differ by more than a 16-bit
   ulp).
2. The wrapper's CPU route (the plain version, no launch counted), the
   dispatch's counted decisions, the bound arithmetic, the grid, the
   ``torch.lstm_cell`` operand reordering, and the build description.
3. On the card: K8 against its plain version (the same tolerance), read
   through a row stride, rerun bitwise equal, and what it refuses.

JAX is imported only by the tests that compare with it, so ``python3 -m
pytest --noconftest tests/test_torch_lstm_cell.py -m cuda`` runs on a
machine with the card and no JAX."""

import pathlib

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.kernels import _build
from deeplearning4j_tpu_torch.kernels import lstm_cell as k8
from deeplearning4j_tpu_torch.ops import nnops
from deeplearning4j_tpu_torch.ops import pallas_kernels as pk

ROOT = pathlib.Path(__file__).resolve().parent.parent


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


def _operands(B, F, U, seed=0):
    """float32 numpy operands of one step: x, h in [-1, 1), c ~ N(0, 1),
    W and RW at the xavier scale, b ~ N(0, 0.1)."""
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1, 1, (B, F)).astype(np.float32),
            rng.uniform(-1, 1, (B, U)).astype(np.float32),
            rng.standard_normal((B, U)).astype(np.float32),
            (rng.standard_normal((F, 4 * U)) * np.sqrt(2 / (F + U))
             ).astype(np.float32),
            (rng.standard_normal((U, 4 * U)) * np.sqrt(1 / U)
             ).astype(np.float32),
            (rng.standard_normal(4 * U) * 0.1).astype(np.float32))


def _torch(arrays, dtype):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


def _jax_dtype(dtype):
    import jax.numpy as jnp
    return {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
            torch.float16: jnp.float16}[dtype]


def _jax(arrays, dtype):
    import jax.numpy as jnp
    return [jnp.asarray(a).astype(_jax_dtype(dtype)) for a in arrays]


def _from_jax(a):
    import jax.numpy as jnp
    return torch.from_numpy(np.array(jnp.asarray(a, jnp.float32)))


SHAPES = [(1, 5, 4), (3, 7, 8), (8, 11, 16), (5, 16, 12)]


@pytest.mark.parametrize("forget_bias", [0.0, 1.0])
@pytest.mark.parametrize("B,F,U", SHAPES, ids=str)
def test_plain_matches_jax_interpret_float32(B, F, U, forget_bias):
    from deeplearning4j_tpu.ops import nnops as jnnops
    from deeplearning4j_tpu.ops import pallas_kernels as jpk
    ops = _operands(B, F, U, seed=B * F * U)
    got = k8.lstm_cell_reference(*_torch(ops, torch.float32),
                                 forget_bias=forget_bias)
    want = jpk.lstm_cell_fused(*_jax(ops, torch.float32),
                               forget_bias=forget_bias, interpret=True)
    lax_cell = jnnops.lstm_cell(*_jax(ops, torch.float32),
                                forget_bias=forget_bias)
    for g, w, l in zip(got, want, lax_cell):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(g.numpy(), np.asarray(l), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16],
                         ids=str)
@pytest.mark.parametrize("forget_bias", [0.0, 1.0])
@pytest.mark.parametrize("B,F,U", SHAPES, ids=str)
def test_plain_matches_jax_interpret_16bit(B, F, U, forget_bias, dtype):
    from deeplearning4j_tpu.ops import pallas_kernels as jpk
    ops = _operands(B, F, U, seed=B + F + U)
    got = k8.lstm_cell_reference(*_torch(ops, dtype),
                                 forget_bias=forget_bias)
    want = jpk.lstm_cell_fused(*_jax(ops, dtype), forget_bias=forget_bias,
                               interpret=True)
    for g, w in zip(got, want):
        assert g.dtype == dtype and w.dtype == _jax_dtype(dtype)
        assert k8.max_violation(g, _from_jax(w).to(dtype)) <= 1.0


def test_plain_rounds_once_at_the_kernel_points():
    """bfloat16 inputs: z and the gates stay float32 (the products of
    16-bit values are exact there); only h' and c' are rounded."""
    ops = _torch(_operands(4, 6, 8, seed=1), torch.bfloat16)
    h, c = k8.lstm_cell_reference(*ops, forget_bias=1.0)
    h32, c32 = k8.lstm_cell_reference(*[t.float() for t in ops],
                                      forget_bias=1.0)
    assert torch.equal(h, h32.to(torch.bfloat16))
    assert torch.equal(c, c32.to(torch.bfloat16))


def test_plain_takes_float64_for_a_double_network():
    ops = _torch(_operands(3, 4, 5), torch.float64)
    h, c = k8.lstm_cell_reference(*ops)
    assert h.dtype == c.dtype == torch.float64
    want = nnops.lstm_cell(*ops)
    torch.testing.assert_close(h, want[0])
    torch.testing.assert_close(c, want[1])


def test_cpu_wrapper_takes_the_plain_version_uncounted():
    ops = _torch(_operands(3, 7, 8), torch.float32)
    k8.launches = 0
    got = k8.lstm_cell(*ops, forget_bias=1.0)
    want = k8.lstm_cell_reference(*ops, forget_bias=1.0)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert k8.launches == 0


def test_dispatch_counts_one_decision_per_call():
    ops = _torch(_operands(2, 3, 4), torch.float32)
    pk.reset_counters()
    for _ in range(3):
        pk.lstm_cell_fused(*ops, forget_bias=1.0)
    assert pk.counters() == {"fused": 0, "fallback_platform": 3}
    pk.reset_counters()
    assert pk.counters() == {"fused": 0, "fallback_platform": 0}
    with pytest.raises(ValueError, match="not supported"):
        pk.lstm_cell_fused(*[t.to("meta") for t in ops])
    assert pk.counters()["fallback_platform"] == 0


def test_strided_x_gives_the_contiguous_result():
    seq = torch.from_numpy(np.random.default_rng(2).uniform(
        -1, 1, (3, 5, 7)).astype(np.float32))
    _, h, c, w, rw, b = _torch(_operands(3, 7, 8), torch.float32)
    x_t = seq[:, 2]
    assert x_t.stride() == (35, 1)
    got = k8.lstm_cell(x_t, h, c, w, rw, b)
    want = k8.lstm_cell(x_t.contiguous(), h, c, w, rw, b)
    assert all(torch.equal(g, v) for g, v in zip(got, want))


def test_torch_lstm_cell_operands_compute_the_same_step():
    ops = _torch(_operands(4, 9, 6, seed=3), torch.float32)
    x, h, c, w, rw, b = ops
    want = k8.lstm_cell_reference(*ops, forget_bias=1.0)
    got = torch.lstm_cell(x, (h, c), *k8.torch_lstm_cell_operands(
        w, rw, b, forget_bias=1.0))
    for g, v in zip(got, want):
        torch.testing.assert_close(g, v, rtol=1e-5, atol=1e-6)


def test_tolerance():
    ref = torch.tensor([1.0, 0.25, 3e-3, 0.0])
    np.testing.assert_allclose(k8.tolerance(ref), [2e-5] * 4)
    bf = ref.to(torch.bfloat16)
    tol = k8.tolerance(bf)
    assert tol[0] == 2.0 ** -7          # one bf16 ulp at 1.0
    assert tol[1] == 2.0 ** -9          # at 0.25
    assert tol[3] == 2e-5               # the f32 bound near 0
    assert k8.tolerance(torch.tensor([1.5], dtype=torch.float16))[0] == \
        2.0 ** -10
    one_up = torch.tensor([1.0 + 2 ** -7, 0.75], dtype=torch.bfloat16)
    want = torch.tensor([1.0, 0.75 - 2 ** -8], dtype=torch.bfloat16)
    assert k8.max_violation(one_up, want) == 1.0


def test_bound_arithmetic():
    """TextGenerationLSTM's two layers at batch 32 in float32: layer 1
    (F = 77) moves 1,508,992 bytes and does 21,823,488 operations, layer
    2 (F = 256) 2,265,088 bytes and 33,554,432 operations; both are bound
    by the bytes (0.4504 and 0.6762 us at 3.35 TB/s)."""
    assert k8.bytes_moved(32, 77, 256, 4) == 1_508_992
    assert k8.flops(32, 77, 256) == 21_823_488
    assert k8.bytes_moved(32, 256, 256, 4) == 2_265_088
    assert k8.flops(32, 256, 256) == 33_554_432
    ms, by = k8.bound_ms(32, 77, 256, 4)
    assert abs(ms - 1_508_992 / 3.35e9) < 1e-9 and by == "bytes"
    ms, by = k8.bound_ms(32, 256, 256, 4)
    assert abs(ms - 2_265_088 / 3.35e9) < 1e-9 and by == "bytes"
    # 16-bit: half the bytes, the tensor-core rate; at (512, 512, 512)
    # the 2.15 GFLOP outweigh the 6.8 MB
    assert k8.bytes_moved(512, 512, 512, 2) == 6_819_840
    ms, by = k8.bound_ms(512, 512, 512, 2)
    assert by == "operations" and abs(
        ms - k8.flops(512, 512, 512) / 989e9) < 1e-9


def test_grid_spreads_the_serving_shapes():
    assert [k8.row_tile(b) for b in (1, 2, 3, 8, 32, 512)] == \
        [1, 2, 4, 8, 8, 8]
    assert k8.grid(32, 256) == (32, 4)      # 128 blocks
    assert k8.grid(1, 256) == (32, 1)
    assert k8.grid(3, 100) == (13, 1)


def test_build_describes_k8():
    assert "lstm_cell" in _build.sources()
    path = _build.library_path("lstm_cell")
    assert path.parent == _build.BUILD_DIR
    assert path.name.startswith("liblstm_cell-") and path.suffix == ".so"
    assert (_build.CSRC / "lstm_cell.cu").is_file()
    ignored = (ROOT / ".gitignore").read_text().split()
    assert "deeplearning4j_tpu_torch/build/" in ignored


# ------------------------------------------------------------- on the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("K8 is CUDA C++ with no CPU mode; needs an NVIDIA card "
                    "and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16], ids=str)
@pytest.mark.parametrize("B,F,U", [(32, 77, 256), (32, 256, 256),
                                   (1, 77, 256), (3, 50, 100)], ids=str)
def test_k8_matches_plain_on_card(cuda_device, B, F, U, dtype):
    ops = [t.to(cuda_device) for t in _torch(_operands(B, F, U), dtype)]
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for strided in (False, True):
            x = ops[0]
            if strided:  # x[:, t, :] of a [B, 3, F] sequence
                x = torch.stack([x, x, x], dim=1)[:, 1]
            before = k8.launches
            got = k8.lstm_cell(x, *ops[1:], forget_bias=1.0)
            again = k8.lstm_cell(x, *ops[1:], forget_bias=1.0)
            torch.cuda.synchronize()
            assert k8.launches == before + 2
            assert all(torch.equal(a, b) for a, b in zip(got, again))
            want = k8.lstm_cell_reference(*ops, forget_bias=1.0)
            for g, w in zip(got, want):
                assert g.dtype == dtype and g.is_contiguous()
                assert k8.max_violation(g, w) <= 1.0
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


@pytest.mark.cuda
def test_k8_refuses_what_it_cannot_take_on_card(cuda_device):
    ops = [t.to(cuda_device) for t in _torch(_operands(2, 3, 4),
                                             torch.float32)]
    with pytest.raises(TypeError, match="dtype"):
        k8.lstm_cell(*[t.double() for t in ops])
    x, h, c, w, rw, b = ops
    with pytest.raises(ValueError, match="contiguous"):
        k8.lstm_cell(x, h, c, w.t().contiguous().t(), rw, b)
    with pytest.raises(TypeError, match="every operand"):
        k8.lstm_cell(x, h, c, w, rw, b.half())
    pk.reset_counters()
    pk.lstm_cell_fused(*ops)
    torch.cuda.synchronize()
    assert pk.counters() == {"fused": 1, "fallback_platform": 0}
