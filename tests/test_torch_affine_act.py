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
