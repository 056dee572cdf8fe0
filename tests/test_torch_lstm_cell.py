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
   dispatch's counted decisions, the bound arithmetic, the cluster
   geometry, the shared-memory budget, the copy widths (``vec_flags``), the
   limits that raise, the ``torch.lstm_cell`` operand reordering, and the
   build description.
3. On the card: K8 against its plain version (the same tolerance), read
   through a row stride, rerun bitwise equal, the kernel's own geometry
   and resources, the empty-kernel floor, the copy widths giving the same
   bits, and what it refuses.

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
    """At TextGenerationLSTM's shapes a cluster of 4 CTAs splits the
    reduction axis (333 -> slices of 96, 512 -> 128) and 32 unit tiles x 4
    ranks give 128 CTAs, one per SM, with all 32 rows in one CTA, so each
    weight is read once a step; (512, 512, 512) takes clusters of 8 and 16
    row tiles."""
    g = k8.geometry(32, 256, 256, 4)
    assert (g["cluster"], g["slice"], g["row_tile"]) == (4, 128, 32)
    assert g["grid"] == (128, 1) and g["ctas"] == 128
    g = k8.geometry(32, 77, 256, 4)
    assert (g["cluster"], g["slice"], g["row_tile"]) == (4, 96, 32)
    assert g["grid"] == (128, 1) and g["ctas"] == 128
    g = k8.geometry(512, 512, 512, 4)
    assert (g["cluster"], g["slice"], g["row_tile"]) == (8, 128, 32)
    assert g["grid"] == (512, 16) and g["ctas"] == 8192
    assert k8.geometry(1, 77, 256, 4)["row_tile"] == 8
    assert k8.geometry(8, 256, 256, 2)["grid"] == (128, 1)
    g = k8.geometry(3, 50, 100, 4)
    assert (g["cluster"], g["slice"], g["grid"]) == (2, 80, (26, 1))


@pytest.mark.parametrize("K,cluster", [(1, 1), (128, 1), (129, 2),
                                       (256, 2), (333, 4), (512, 4),
                                       (513, 8), (1024, 8), (4000, 8)])
def test_cluster_cuts_the_reduction_into_slices(K, cluster):
    """The fewest CTAs (a power of two, at most 8) whose slices are at most
    128 long; each slice a multiple of 16 elements (4 sub-slices read 4
    at a time), all of them covering F + U."""
    g = k8.geometry(32, K // 2, K - K // 2, 4)
    assert g["cluster"] == cluster
    assert g["slice"] % 16 == 0 and g["cluster"] * g["slice"] >= K
    assert g["slice"] - 16 < -(-K // g["cluster"]) <= g["slice"]
    if cluster < k8.MAX_CLUSTER:
        assert g["slice"] <= k8.SLICE_TARGET


def test_shared_memory_budget():
    """A CTA's shared memory: the [x | h] rows padded by 16 bytes, the
    weight rows of 4 x 8 columns, the partial sums of 4 sub-slices and the
    rank's sum (4 gates f32 per row and unit each). Layer 2 of the path in
    float32 (slice 128, 32 rows): 16,896 + 16,384 + 16,384 + 4,096
    bytes."""
    assert k8.geometry(32, 256, 256, 4)["smem_bytes"] == \
        32 * 132 * 4 + 128 * 32 * 4 + 5 * 32 * 8 * 16 == 53_760
    assert k8.geometry(32, 77, 256, 4)["smem_bytes"] == \
        32 * 100 * 4 + 96 * 32 * 4 + 5 * 32 * 8 * 16
    assert k8.geometry(8, 77, 256, 2)["smem_bytes"] == \
        8 * 104 * 2 + 96 * 32 * 2 + 5 * 8 * 8 * 16
    for shape in ((32, 6000, 520), (32, 6000, 528)):  # slices of 816
        assert k8.geometry(*shape, 4)["smem_bytes"] <= k8.SMEM_LIMIT


@pytest.mark.parametrize("shape,itemsize,match", [
    ((32, 6000, 1024), 4, "shared memory"),
    ((32, 6000, 540), 4, "shared memory"),       # slices of 832
    ((32, 12000, 4096), 2, "shared memory"),
    ((32 * 65536, 77, 256), 4, "row tiles"),
    ((0, 77, 256), 4, "empty"),
    ((4, 3, 0), 4, "empty"),
])
def test_geometry_raises_beyond_the_kernels_limits(shape, itemsize, match):
    with pytest.raises(ValueError, match=match):
        k8.geometry(*shape, itemsize)


class _FakeCuda(torch.Tensor):
    """A CPU tensor that reports a CUDA device: it walks the wrapper's
    CUDA branch on a machine without a card."""

    @property
    def device(self):
        return torch.device("cuda")


def test_cuda_wrapper_raises_beyond_the_limits_before_a_launch(monkeypatch):
    monkeypatch.setattr(k8, "_kernel", lambda: (_ for _ in ()).throw(
        AssertionError("the kernel was reached")))
    B, F, U = 32, 6000, 1024  # slices of 880: 246,272 bytes a CTA
    ops = [torch.empty(*shape) for shape in (
        (B, F), (B, U), (B, U), (F, 4 * U), (U, 4 * U), (4 * U,))]
    with pytest.raises(ValueError, match="shared memory"):
        k8.lstm_cell(*[t.as_subclass(_FakeCuda) for t in ops])


@pytest.mark.parametrize("B,F,U,dtype,strided,flags", [
    (32, 77, 256, torch.float32, True, 0b10),    # F = 77: 4-byte copies
    (32, 256, 256, torch.float32, True, 0b11),   # x[:, t] of [B, 3, 256]
    (32, 256, 256, torch.float32, False, 0b11),
    (8, 77, 256, torch.bfloat16, False, 0b10),   # 154 bytes a row
    (8, 256, 256, torch.float16, True, 0b11),
    (3, 50, 100, torch.float32, False, 0b10),    # 200-byte rows of x
    (3, 48, 100, torch.bfloat16, False, 0b00),   # U = 100: 200 bytes
    (3, 48, 100, torch.float32, False, 0b11),    # U = 100: 400 bytes
])
def test_vec_flags_choose_the_copy_width(B, F, U, dtype, strided, flags):
    x, h, c, w, rw, b = _torch(_operands(B, F, U), dtype)
    if strided:
        x = torch.stack([x, x, x], dim=1)[:, 1]
    assert k8.vec_flags(x, h, w, rw) == flags


def test_vec_flags_see_an_offset_start():
    x, h, c, w, rw, b = _torch(_operands(4, 64, 64), torch.float32)
    assert k8.vec_flags(x, h, w, rw) == 0b11
    shifted = torch.zeros(4, 65)[:, 1:]
    shifted.copy_(x)
    assert k8.vec_flags(shifted, h, w, rw) == 0b10
    w_shifted = torch.zeros(64 * 256 + 1)[1:].view(64, 256)
    assert k8.vec_flags(x, h, w_shifted, rw) == 0b01


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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16], ids=str)
@pytest.mark.parametrize("B,F,U", [(32, 77, 256), (32, 256, 256),
                                   (8, 77, 256), (1, 77, 256), (3, 50, 100),
                                   (512, 512, 512), (32, 6000, 520)],
                         ids=str)
def test_k8_geometry_matches_the_kernel_on_card(cuda_device, B, F, U,
                                                dtype):
    """The compiled kernel computes geometry() as the host does, launches
    at that shape, and the card holds its CTAs and clusters."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    assert k8.kernel_geometry(B, F, U, dtype) == k8.geometry(B, F, U,
                                                             itemsize)
    occ = k8.occupancy(B, F, U, dtype)
    assert occ["threads"] == k8.THREADS
    assert occ["smem_bytes"] == k8.geometry(B, F, U, itemsize)["smem_bytes"]
    assert occ["ctas_per_sm"] >= 1 and occ["clusters"] >= 1


@pytest.mark.cuda
def test_k8_floor_launches_uncounted_on_card(cuda_device):
    before = k8.launches
    for shape in ((32, 77, 256), (32, 256, 256), (512, 512, 512)):
        k8.launch_floor(*shape)
    torch.cuda.synchronize()
    assert k8.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_k8_copy_widths_give_the_same_bits_on_card(cuda_device, dtype):
    """x and the weights whose rows do not start on 16 bytes take 4-byte
    copies (f32) or element loads (16 bits); the result is bit for bit that
    of the 16-byte copies."""
    ops = [t.to(cuda_device) for t in _torch(_operands(32, 256, 256), dtype)]
    x, h, c, w, rw, b = ops
    x_off = torch.zeros(32, 257, dtype=dtype, device=cuda_device)[:, 1:]
    x_off.copy_(x)
    w_off = torch.zeros(256 * 1024 + 8, dtype=dtype,
                        device=cuda_device)[1:256 * 1024 + 1].view(256, 1024)
    w_off.copy_(w)
    assert k8.vec_flags(x, h, w, rw) == 0b11
    assert k8.vec_flags(x_off, h, w_off, rw) == 0b00
    want = k8.lstm_cell(x, h, c, w, rw, b, forget_bias=1.0)
    got = k8.lstm_cell(x_off, h, c, w_off, rw, b, forget_bias=1.0)
    torch.cuda.synchronize()
    assert all(torch.equal(g, v) for g, v in zip(got, want))


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
    B, F, U = 32, 6000, 1024
    big = [torch.empty(*shape, device=cuda_device) for shape in (
        (B, F), (B, U), (B, U), (F, 4 * U), (U, 4 * U), (4 * U,))]
    with pytest.raises(ValueError, match="shared memory"):
        k8.lstm_cell(*big)
    pk.reset_counters()
    pk.lstm_cell_fused(*ops)
    torch.cuda.synchronize()
    assert pk.counters() == {"fused": 1, "fallback_platform": 0}
