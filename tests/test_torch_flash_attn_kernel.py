"""K3's module without JAX: its wrapper's checks on a machine without a
card, its bound arithmetic, its build description, and (marked ``cuda``,
skipped without a card) K3 against its plain version on the card. This
file imports no JAX, so ``pytest --noconftest
tests/test_torch_flash_attn_kernel.py -m cuda`` runs on the card's
machine.

The card tests hold ``o`` within 2e-5 absolute in float32 (the JAX
package's kernel contract is ~1e-5; the sums run in another order and
expf may differ from PyTorch's exp by an ulp) and within 2 ulps of the
output dtype in bfloat16 and float16 (``ulp_error``: p and o are rounded
at the same points in the kernel and its plain version); ``m`` within
2e-5 of max(1, |m|) and ``l`` within 2e-5 relative; a second run
bit-equal."""

import pytest
import torch

from deeplearning4j_tpu_torch.kernels import _build
from deeplearning4j_tpu_torch.kernels import flash_attention as k3

NEG = float(torch.finfo(torch.float32).min)
ULP_TOL = 2.0


class _FakeCuda(torch.Tensor):
    """A CPU tensor that reports a CUDA device: it walks the wrapper's
    CUDA branch on a machine without a card."""

    @property
    def device(self):
        return torch.device("cuda")


def _fake(t):
    return None if t is None else t.as_subclass(_FakeCuda)


@pytest.fixture
def plain_forbidden(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("the plain version was reached")
    monkeypatch.setattr(k3, "flash_attention_fwd_reference", boom)
    monkeypatch.setattr(_build, "nvcc", lambda: (_ for _ in ()).throw(
        RuntimeError("nvcc not found")))
    monkeypatch.setattr(_build, "_libs", {})
    k3._kernel.cache_clear()
    yield
    k3._kernel.cache_clear()


def test_cuda_tensor_never_reaches_the_plain_version(plain_forbidden):
    q = _fake(torch.ones(1, 2, 4, 8))
    with pytest.raises(RuntimeError, match="nvcc"):
        k3.flash_attention_fwd(q, q, q)
    with pytest.raises(ValueError, match="not supported"):
        k3.flash_attention_fwd(*(torch.ones(1, 2, 4, 8, device="meta"),) * 3)


@pytest.mark.parametrize("make,err,match", [
    (lambda: [torch.ones(1, 2, 4, 8, dtype=torch.float64)] * 3, TypeError,
     "dtype"),
    (lambda: [torch.ones(1, 2, 4, 256)] * 3, ValueError, "limit 128"),
    (lambda: [torch.ones(1, 2, 4, 8), torch.ones(1, 2, 5, 8),
              torch.ones(1, 2, 6, 8)], ValueError, "disagree"),
    (lambda: [torch.ones(2, 4, 8)] * 3, ValueError, r"\[B, H, T, d\]"),
    (lambda: [torch.ones(1, 2, 8, 4).transpose(-1, -2)] * 3, ValueError,
     "contiguous last"),
])
def test_cuda_wrapper_raises_on_what_k3_cannot_take(plain_forbidden, make,
                                                    err, match):
    with pytest.raises(err, match=match):
        k3.flash_attention_fwd(*map(_fake, make()))


def test_cuda_wrapper_checks_the_key_bias(plain_forbidden):
    q = _fake(torch.ones(2, 2, 4, 8))
    for kb in (torch.zeros(2, 5), torch.zeros(2, 4, dtype=torch.float64),
               torch.zeros(4, 2).t()):
        with pytest.raises(ValueError, match="kb"):
            k3.flash_attention_fwd(q, q, q, _fake(kb))


def test_bound_from_the_issue_arithmetic():
    """BERT-base batch 32 (G = 384, T = 128, d = 64) in float32: 1.61
    GFLOP is 0.0240 ms at 67 TFLOP/s; q, k, v and o are 50.3 MB, 0.0150
    ms at 3.35 TB/s; so 0.0240 ms per launch, bound by operations."""
    assert k3.flops(32, 12, 128, 128, 64) == 4 * 384 * 128 * 128 * 64
    qkvo = 4 * 384 * 128 * 64 * 4
    assert abs(qkvo / 1e6 - 50.3) < 0.05
    assert k3.bytes_moved(32, 12, 128, 128, 64, 4, has_bias=False) == \
        qkvo + 2 * 384 * 128 * 4
    ms, by = k3.bound_ms(32, 12, 128, 128, 64, 4)
    assert abs(ms - 0.0240) < 0.0001 and by == "operations"
    assert abs(12 * ms - 0.288) < 0.001


def test_build_describes_k3():
    assert "flash_attn_fwd" in _build.sources()
    path = _build.library_path("flash_attn_fwd")
    assert path.parent == _build.BUILD_DIR
    assert path.name.startswith("libflash_attn_fwd-") and path.suffix == ".so"


def test_ulp_error_counts_ulps():
    want = torch.tensor([1.0, 0.5, -2.0, 0.0], dtype=torch.bfloat16)
    assert k3.ulp_error(want, want) == 0.0
    one_up = torch.tensor([1.0 + 2 ** -7, 0.5, -2.0, 0.0],
                          dtype=torch.bfloat16)
    assert k3.ulp_error(one_up, want) == 1.0


# ------------------------------------------------------------- on the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("K3 is CUDA C++ with no CPU mode; needs an NVIDIA card "
                    "and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("shape", [(2, 12, 128, 128, 64),
                                   (2, 12, 77, 77, 64),
                                   (2, 4, 200, 200, 128),
                                   (3, 2, 16, 24, 32), (1, 1, 1, 1, 1)],
                         ids=str)
def test_k3_matches_plain_on_card(cuda_device, shape, dtype):
    B, H, Tq, Tk, d = shape
    gen = torch.Generator(device=cuda_device).manual_seed(sum(shape))
    q = torch.randn(B, H, Tq, d, generator=gen, device=cuda_device).to(dtype)
    k = torch.randn(B, H, Tk, d, generator=gen, device=cuda_device).to(dtype)
    v = torch.randn(B, H, Tk, d, generator=gen, device=cuda_device).to(dtype)
    lengths = torch.randint(1, Tk + 1, (B,), generator=gen,
                            device=cuda_device)
    kb = torch.where(torch.arange(Tk, device=cuda_device)[None, :]
                     < lengths[:, None], 0.0, NEG).contiguous()
    kb[0] = NEG
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for bias in (None, kb):
            before = k3.launches
            o, m, l = k3.flash_attention_fwd(q, k, v, bias)
            again = k3.flash_attention_fwd(q, k, v, bias)
            torch.cuda.synchronize()
            assert k3.launches == before + 2
            assert all(torch.equal(a, b) for a, b in zip((o, m, l), again))
            ro, rm, rl = k3.flash_attention_fwd_reference(q, k, v, bias)
            if dtype == torch.float32:
                assert float((o - ro).abs().max()) <= 2e-5
            else:
                assert k3.ulp_error(o, ro) <= ULP_TOL
            assert float(((m - rm).abs() / rm.abs().clamp(min=1)).max()) \
                <= 2e-5
            assert float(((l - rl).abs() / rl).max()) <= 2e-5
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


@pytest.mark.cuda
def test_k3_reads_strided_head_views_on_card(cuda_device):
    """The head split of a [B, T, H*d] projection, read in place: the
    output keeps q's layout and matches a contiguous call."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn(3, 2, 40, 4, 32, generator=gen, device=cuda_device)
    q, k, v = (x[i].transpose(1, 2) for i in range(3))  # [2, 4, 40, 32]
    o = k3.flash_attention_fwd(q, k, v)[0]
    torch.cuda.synchronize()
    assert o.stride() == q.stride()
    want = k3.flash_attention_fwd(q.contiguous(), k.contiguous(),
                                  v.contiguous())[0]
    assert torch.equal(o, want)


@pytest.mark.cuda
def test_k3_raises_on_card(cuda_device):
    q = torch.ones(1, 2, 4, 8, device=cuda_device, dtype=torch.float64)
    with pytest.raises(TypeError, match="dtype"):
        k3.flash_attention_fwd(q, q, q)
    q = torch.ones(1, 2, 4, 160, device=cuda_device)
    with pytest.raises(ValueError, match="limit"):
        k3.flash_attention_fwd(q, q, q)
