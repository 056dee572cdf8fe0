"""Kernel K1's module: its plain version, its bound arithmetic, its build
description, and (marked ``cuda``, skipped without a card) K1 and K2
themselves against their plain versions on the card. This file imports
no JAX, so ``pytest --noconftest tests/test_torch_affine_act.py -m cuda``
runs on the card's machine.

The card test's tolerance is ``affine_act.ulp_tolerance``: float32 atol
and rtol 1e-5 (the kernel computes ``x*scale + shift`` with the plain
version's two roundings, but the card's tanhf/erff/expf differ from
PyTorch's by an ulp or two); a 16-bit output one ulp of its type on
top. K2's dx takes the same tolerance; its dscale and dshift must be
within 1e-4 of each channel's sum over rows of |term| (float32 sums of
the same terms in another order), and a second run bit-equal."""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.kernels import _build
from deeplearning4j_tpu_torch.kernels import affine_act as k1
from deeplearning4j_tpu_torch.tools.nchw_block import nchw_block


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("act", k1.ACTS)
def test_reference_formulas(act, dtype):
    rng = np.random.default_rng(0)
    z64 = rng.standard_normal((6, 10)) * 3.0
    x = torch.from_numpy(z64.astype(np.float32)).to(dtype)
    s = torch.ones(10)
    b = torch.zeros(10)
    z = x.double()
    want = {
        "identity": z, "relu": z.clamp(min=0), "relu6": z.clamp(0, 6),
        "tanh": torch.tanh(z), "sigmoid": torch.sigmoid(z),
        "gelu": torch.nn.functional.gelu(z, approximate="tanh"),
        "geluexact": torch.nn.functional.gelu(z),
    }[act]
    got = k1.affine_act_reference(x, s, b, act)
    assert got.dtype == dtype
    atol, rtol = k1.ulp_tolerance(dtype)
    torch.testing.assert_close(got.double(), want.to(dtype).double(),
                               atol=max(atol, 1e-6), rtol=2 * rtol)


def test_reference_without_scale_is_bias_add():
    x = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    b = torch.tensor([1.0, -2.0, 0.5, 0.0])
    assert torch.equal(k1.affine_act_reference(x, None, b, "identity"),
                       x + b)


def test_resnet50_bound_from_the_issue_arithmetic():
    """ResNet-50 at 224x224: 10,587,136 K1 elements per image; in float32
    at batch 32 that is 2.71 GB read + written, 0.81 ms at 3.35 TB/s."""
    per_image = 10_587_136
    assert k1.bytes_moved(32 * per_image, 1, 4, has_scale=False) == \
        2 * 4 * 32 * per_image + 4
    t = k1.bound_ms(32 * per_image // 64, 64, 4, "relu")
    assert abs(t - 0.809) < 0.001
    assert abs(k1.bound_ms(32 * per_image // 64, 64, 2, "relu")
               - t / 2) < 1e-4


def test_ulp_tolerance():
    assert k1.ulp_tolerance(torch.float32) == (1e-5, 1e-5)
    assert k1.ulp_tolerance(torch.bfloat16)[1] == 2.0 ** -7
    assert k1.ulp_tolerance(torch.float16)[1] == 2.0 ** -10


def test_build_description():
    assert "affine_act" in _build.sources()
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    path = _build.library_path("affine_act")
    assert path.parent == _build.BUILD_DIR
    assert path.name.startswith("libaffine_act-") and path.suffix == ".so"
    assert _build.library_path("affine_act") == path  # content digest


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("K1 and K2 are CUDA C++ with no CPU mode; need an "
                    "NVIDIA card and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("rows,cols", [(49, 2048), (1568, 512), (7, 3),
                                       (100, 64)])
def test_kernel_matches_plain_on_card(cuda_device, rows, cols, dtype):
    gen = torch.Generator(device=cuda_device).manual_seed(rows * cols)
    x = torch.randn(rows, cols, generator=gen, device=cuda_device).to(dtype)
    s = torch.rand(cols, generator=gen, device=cuda_device) + 0.5
    b = torch.randn(cols, generator=gen, device=cuda_device)
    atol, rtol = k1.ulp_tolerance(dtype)
    for act in k1.ACTS:
        for scale in (s, None):
            before = k1.launches
            y = k1.affine_act(x, scale, b, act)
            torch.cuda.synchronize()
            assert k1.launches == before + 1
            ref = k1.affine_act_reference(x, scale, b, act)
            torch.testing.assert_close(y.float(), ref.float(), atol=atol,
                                       rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("rows,cols", [(49, 2048), (1568, 512), (7, 3),
                                       (4000, 64)])
def test_k2_matches_plain_on_card(cuda_device, rows, cols, dtype):
    gen = torch.Generator(device=cuda_device).manual_seed(rows + cols)
    x = torch.randn(rows, cols, generator=gen, device=cuda_device).to(dtype)
    dy = torch.randn(rows, cols, generator=gen, device=cuda_device).to(dtype)
    s = torch.rand(cols, generator=gen, device=cuda_device) + 0.5
    b = torch.randn(cols, generator=gen, device=cuda_device)
    atol, rtol = k1.ulp_tolerance(dtype)
    for act in k1.ACTS:
        for scale in (s, None):
            before = k1.bwd_launches
            got = k1.affine_act_bwd(x, scale, b, dy, act)
            again = k1.affine_act_bwd(x, scale, b, dy, act)
            torch.cuda.synchronize()
            assert k1.bwd_launches == before + 2
            want = k1.affine_act_bwd_reference(x, scale, b, dy, act)
            torch.testing.assert_close(got[0].float(), want[0].float(),
                                       atol=atol, rtol=rtol)
            # the sums' scale: the same sums over |term|
            xf = x.float()
            z = xf * scale + b if scale is not None else xf + b
            dz = (dy.float() * k1.act_grad(act, z)).abs()
            mags = (None if scale is None else (dz * xf.abs()).sum(0),
                    dz.sum(0))
            for g, a, w, mag in zip(got[1:], again[1:], want[1:], mags):
                if w is None:
                    assert g is None
                    continue
                assert torch.equal(g, a)  # deterministic
                assert bool(((g - w).abs() <= 1e-4 * mag + 1e-6).all())


@pytest.mark.cuda
def test_nchw_conv_bn_relu_runs_k1_k2_on_card(cuda_device):
    """Channels-first conv (+ ReLU) and batch norm (+ ReLU) run K1 and K2
    on the card (two K1 launches forward, two K2 backward, one counted
    channels-last copy: the conv's NCHW output; BN then gets channels-last
    memory) and match the CPU plain path: the output within 1e-4 of max
    |ref| (float32 with TF32 off; cuDNN and the CPU sum the convolution in
    other orders); each gradient, against a CPU float64 copy, within
    max(1e-3, 2 x the CPU float32 error), the card gates' rule (cuDNN may
    take a transform-based algorithm for the weight gradient)."""
    from deeplearning4j_tpu_torch.ops import fused_epilogues as fe
    gen = torch.Generator().manual_seed(3)
    params = {"W": torch.randn(20, 1, 5, 5, generator=gen) * 0.2,
              "b": torch.randn(20, generator=gen),
              "gamma": torch.rand(20, generator=gen) + 0.5,
              "beta": torch.randn(20, generator=gen)}
    x = torch.randn(16, 1, 28, 28, generator=gen)
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        fe.reset_counters()
        before = (k1.launches, k1.bwd_launches)
        z, grads = nchw_block(x, params, cuda_device)
        torch.cuda.synchronize()
        assert (k1.launches - before[0], k1.bwd_launches - before[1]) == (2, 2)
        assert fe.counters()["fused"] == 2 and fe.nchw_copies == 1
        want_z, want_grads = nchw_block(x, params, "cpu")
        _, grads64 = nchw_block(x.double(), {k: v.double() for k, v in
                                              params.items()}, "cpu")
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old
    assert float((z.cpu() - want_z).abs().max() / want_z.abs().max()) <= 1e-4

    def rel(a, b):
        return float((a.double() - b).norm() / b.norm())
    for k, g64 in grads64.items():
        assert rel(grads[k].cpu(), g64) <= max(1e-3,
                                               2 * rel(want_grads[k], g64))


def test_nchw_block_on_the_cpu_follows_float64():
    """The NCHW check block's CPU plain path (the reference of its card
    test): float32 output within 1e-5 of max |float64|, and every
    gradient present and within 1e-4 relative of float64's."""
    gen = torch.Generator().manual_seed(3)
    params = {"W": torch.randn(4, 1, 5, 5, generator=gen) * 0.2,
              "b": torch.randn(4, generator=gen),
              "gamma": torch.rand(4, generator=gen) + 0.5,
              "beta": torch.randn(4, generator=gen)}
    x = torch.randn(2, 1, 8, 8, generator=gen)
    z, grads = nchw_block(x, params, "cpu")
    z64, grads64 = nchw_block(x.double(), {k: v.double() for k, v in
                                           params.items()}, "cpu")
    assert z.shape == (2, 4, 8, 8) and set(grads) == {"x", *params}
    assert float((z.double() - z64).abs().max() / z64.abs().max()) <= 1e-5
    for k, g64 in grads64.items():
        assert float((grads[k].double() - g64).norm() / g64.norm()) <= 1e-4


@pytest.mark.cuda
def test_integer_x_on_card_is_cast_into_k1(cuda_device):
    """An int32 CUDA x goes through K1 as float32, the dtype the plain
    formula returns (one launch, counted ``fused``), and equals the CPU
    route within 1e-6; an x whose formula stays integer raises."""
    from deeplearning4j_tpu_torch.ops import fused_epilogues as fe
    x = torch.arange(-12, 12, dtype=torch.int32).reshape(4, 6)
    b = torch.linspace(-1.0, 1.0, 6)
    fe.reset_counters()
    before = k1.launches
    got = fe.bias_act(x.to(cuda_device), b.to(cuda_device),
                      act="gelu_exact")
    torch.cuda.synchronize()
    assert k1.launches - before == 1 and fe.counters()["fused"] == 1
    want = fe.bias_act(x, b, act="gelu_exact")
    assert got.dtype == want.dtype == torch.float32
    assert float((got.cpu() - want).abs().max()) <= 1e-6
    with pytest.raises(ValueError, match="float32, bfloat16 or float16"):
        fe.bias_act(x.to(cuda_device), torch.ones(6, dtype=torch.int32,
                                                  device=cuda_device),
                    act="relu")
