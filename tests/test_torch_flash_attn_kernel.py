"""K3's and the fused backward's (K4 + K5) module without JAX: the
wrappers' checks on a machine without a card, the bound arithmetic, the
build description, and (marked ``cuda``, skipped without a card) the
kernels against their plain versions on the card. This file imports no JAX, so ``pytest --noconftest
tests/test_torch_flash_attn_kernel.py -m cuda`` runs on the card's
machine.

The card tests hold ``o`` within 2e-5 absolute in float32 (the JAX
package's kernel contract is ~1e-5; the sums run in another order and
expf may differ from PyTorch's exp by an ulp) and within 2 ulps of the
output dtype in bfloat16 and float16 (``ulp_error``: p and o are rounded
at the same points in the kernel and its plain version); ``m`` within
2e-5 of max(1, |m|) and ``l`` within 2e-5 relative; a second run
bit-equal. The fused backward (dq, dk, dv; and its dq-only and dk/dv-only
calls, bit-equal to the fused one) is held to the same bounds: 2e-5
absolute in float32 (the magnitudes are O(1) at these inputs; the sums
run in other orders) and 2 ulps in bfloat16 and float16 (ds and p are
rounded at the same points in the kernel and the plain versions)."""

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
    for name in ("flash_attention_fwd_reference",
                 "flash_attention_bwd_dq_reference",
                 "flash_attention_bwd_dkv_reference"):
        monkeypatch.setattr(k3, name, boom)
    monkeypatch.setattr(_build, "nvcc", lambda: (_ for _ in ()).throw(
        RuntimeError("nvcc not found")))
    monkeypatch.setattr(_build, "_libs", {})
    k3._kernel.cache_clear()
    k3._bwd_kernels.cache_clear()
    yield
    k3._kernel.cache_clear()
    k3._bwd_kernels.cache_clear()


BWD_WRAPPERS = ["flash_attention_bwd", "flash_attention_bwd_dq",
                "flash_attention_bwd_dkv"]


def _bwd_args(B=1, H=2, Tq=4, Tk=4, d=8, **over):
    """Arguments of the backward's wrappers as stand-in CUDA tensors, with
    any of them replaced."""
    args = {"q": torch.ones(B, H, Tq, d), "k": torch.ones(B, H, Tk, d),
            "v": torch.ones(B, H, Tk, d), "kb": None,
            "m": torch.zeros(B * H, Tq), "l": torch.ones(B * H, Tq),
            "di": torch.zeros(B * H, Tq), "do": torch.ones(B, H, Tq, d)}
    args.update(over)
    return [_fake(args[n]) for n in ("q", "k", "v", "kb", "m", "l", "di",
                                     "do")]


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


@pytest.mark.parametrize("fn", BWD_WRAPPERS)
def test_cuda_backward_never_reaches_the_plain_version(plain_forbidden, fn):
    with pytest.raises(RuntimeError, match="nvcc"):
        getattr(k3, fn)(*_bwd_args())


@pytest.mark.parametrize("over,match", [
    ({"do": torch.ones(1, 2, 5, 8)}, "do must be"),
    ({"do": torch.ones(1, 2, 4, 8, dtype=torch.float16)}, "do must be"),
    ({"do": torch.ones(1, 2, 8, 4).transpose(-1, -2)}, "do must be"),
    ({"m": torch.zeros(2, 5)}, "m must be"),
    ({"l": torch.ones(2, 4, dtype=torch.float64)}, "l must be"),
    ({"di": torch.zeros(4, 2).t()}, "di must be"),
    ({"kb": torch.zeros(1, 3)}, "kb must be"),
    ({"q": torch.ones(1, 2, 4, 256), "k": torch.ones(1, 2, 4, 256),
      "v": torch.ones(1, 2, 4, 256), "do": torch.ones(1, 2, 4, 256)},
     "limit 128"),
])
def test_cuda_backward_raises_on_what_k4_k5_cannot_take(plain_forbidden,
                                                        over, match):
    for fn in BWD_WRAPPERS:
        with pytest.raises((TypeError, ValueError), match=match):
            getattr(k3, fn)(*_bwd_args(**over))


def test_backward_bound_from_the_issue_arithmetic():
    """BERT-base batch 32 in float32: K4 does 6 G T^2 d = 2.42 GFLOP,
    0.036 ms at 67 TFLOP/s; K5 8 G T^2 d = 3.22 GFLOP, 0.048 ms; both
    bound by operations (their bytes take 0.019 and 0.023 ms)."""
    G = 384
    assert k3.flops_bwd(32, 12, 128, 128, 64, "dq") == 6 * G * 128 * 128 * 64
    assert abs(k3.flops_bwd(32, 12, 128, 128, 64, "dq") / 1e9 - 2.42) < 0.01
    assert abs(k3.flops_bwd(32, 12, 128, 128, 64, "dkv") / 1e9 - 3.22) < 0.01
    qkvdo = 4 * G * 128 * 64 * 4
    rows = 3 * G * 128 * 4
    assert k3.bytes_moved_bwd(32, 12, 128, 128, 64, 4, "dq", False) == \
        qkvdo + rows + G * 128 * 64 * 4
    assert k3.bytes_moved_bwd(32, 12, 128, 128, 64, 4, "dkv") == \
        qkvdo + rows + 32 * 128 * 4 + 2 * G * 128 * 64 * 4
    ms, by = k3.bound_ms_bwd(32, 12, 128, 128, 64, 4, "dq")
    assert abs(ms - 0.0361) < 0.0001 and by == "operations"
    ms, by = k3.bound_ms_bwd(32, 12, 128, 128, 64, 4, "dkv")
    assert abs(ms - 0.0481) < 0.0001 and by == "operations"
    with pytest.raises(ValueError, match="dkv"):
        k3.flops_bwd(1, 1, 1, 1, 1, "dk")


def test_fused_backward_bound_arithmetic():
    """The fused kernel at BERT-base batch 32: 10 G T^2 d = 4.027 GFLOP,
    0.0601 ms a launch at 67 TFLOP/s and 0.721 ms for the 12 launches of a
    fine-tune step (operations; its 88.7 MB take 0.0265 ms at 3.35 TB/s);
    in bf16 the 44.7 MB bound it at 0.0133 ms."""
    G = 384
    assert k3.flops_bwd(32, 12, 128, 128, 64, "fused") == \
        10 * G * 128 * 128 * 64
    assert abs(k3.flops_bwd(32, 12, 128, 128, 64, "fused") / 1e9 - 4.027) \
        < 0.001
    qkvdo = 4 * G * 128 * 64
    rows = 3 * G * 128 * 4
    outs = 3 * G * 128 * 64
    for itemsize, mb in ((4, 88.69), (2, 44.65)):
        got = k3.bytes_moved_bwd(32, 12, 128, 128, 64, itemsize, "fused")
        assert got == (qkvdo + outs) * itemsize + rows + 32 * 128 * 4
        assert abs(got / 1e6 - mb) < 0.01
    ms, by = k3.bound_ms_bwd(32, 12, 128, 128, 64, 4, "fused")
    assert abs(ms - 0.0601) < 0.0001 and by == "operations"
    assert abs(12 * ms - 0.721) < 0.001
    bytes_ms = k3.bytes_moved_bwd(32, 12, 128, 128, 64, 4, "fused") \
        / k3.H100_BYTES_PER_S * 1e3
    assert abs(bytes_ms - 0.0265) < 0.0001
    ms, by = k3.bound_ms_bwd(32, 12, 128, 128, 64, 2, "fused")
    assert abs(ms - 0.0133) < 0.0001 and by == "bytes"
    # the fused launch's bytes are the two kernels' less the shared reads
    assert k3.bytes_moved_bwd(2, 3, 16, 24, 8, 4, "fused", False) == \
        k3.bytes_moved_bwd(2, 3, 16, 24, 8, 4, "dq", False) \
        + 2 * 6 * 24 * 8 * 4


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


@pytest.mark.parametrize("name", ["flash_attn_fwd", "flash_attn_bwd"])
def test_build_describes_k3_k4_k5(name):
    assert name in _build.sources()
    path = _build.library_path(name)
    assert path.parent == _build.BUILD_DIR
    assert path.name.startswith(f"lib{name}-") and path.suffix == ".so"
    # the digest covers the score routine the three kernels share
    assert (_build.CSRC / "flash_attn_common.cuh").is_file()


@pytest.mark.parametrize("d,dtype,key_tile,smem", [
    (64, torch.float32, 64, 108032), (64, torch.bfloat16, 64, 91136),
    (32, torch.float32, 64, 67072), (48, torch.float16, 64, 91136),
    (128, torch.float32, 32, 113920), (96, torch.bfloat16, 32, 108800)])
def test_fwd_geometry_keeps_two_ctas_an_sm(d, dtype, key_tile, smem):
    """K3's tiles and shared memory: 256 threads and 64 query rows a CTA,
    key tiles of 64 (32 above d = 64), and a layout two CTAs of which fit
    one SM (BERT-base's d = 64 in float32: q, two buffers of k and of v,
    p and two of the bias, 17,408 + 34,816 + 34,816 + 20,480 + 512 =
    108,032 bytes)."""
    g = k3.fwd_geometry(d, dtype)
    assert (g["threads"], g["query_rows"]) == (256, 64)
    assert g["key_tile"] == key_tile == k3.key_tile(d)
    assert g["smem_bytes"] == smem
    # an H100 SM has 233,472 bytes; CUDA keeps 1,024 back per CTA
    assert 2 * (smem + 1024) <= 233472


def test_fwd_geometry_refuses_what_k3_cannot_take():
    for d in (0, 129):
        with pytest.raises(ValueError, match="1..128"):
            k3.fwd_geometry(d)
    with pytest.raises(TypeError, match="dtype"):
        k3.fwd_geometry(64, torch.float64)


def _tiled_bf16(q, k, v, tile):
    """The online softmax over key tiles of ``tile`` keys, p rounded to
    bfloat16 before p v (scale 1, no bias)."""
    B, H, Tq, d = q.shape
    m = torch.full((B, H, Tq), -float("inf"))
    l = torch.zeros(B, H, Tq)
    acc = torch.zeros(B, H, Tq, d)
    for j0 in range(0, k.shape[2], tile):
        s = torch.matmul(q.float(), k[:, :, j0:j0 + tile].float()
                         .transpose(-1, -2))
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.matmul(
            p.to(torch.bfloat16).float(), v[:, :, j0:j0 + tile].float())
        m = m_new
    return (acc / l[..., None]).to(torch.bfloat16)


def test_plain_version_walks_the_kernels_key_tiles():
    """The plain version rounds a 16-bit p against the running max of the
    kernel's key tiles (64 keys at d = 64): keys 32-39 raise the max, so
    tiles of 32 would round p of keys 0-31 against another max and give
    other bits."""
    q = torch.zeros(1, 1, 4, 64, dtype=torch.bfloat16)
    q[..., 0] = torch.tensor([1.0, 2.0, 3.0, 0.5])
    k = torch.zeros(1, 1, 40, 64, dtype=torch.bfloat16)
    k[0, 0, 32:, 0] = 1.0
    v = torch.randn(1, 1, 40, 64,
                    generator=torch.Generator().manual_seed(0)).to(
        torch.bfloat16)
    o = k3.flash_attention_fwd_reference(q, k, v, scale=1.0)[0]
    assert k3.key_tile(64) == 64
    assert torch.equal(o, _tiled_bf16(q, k, v, 64))
    assert not torch.equal(o, _tiled_bf16(q, k, v, 32))


@pytest.mark.parametrize("make,aligned", [
    (lambda: torch.ones(2, 3, 5, 8), True),                  # rows of 32 B
    (lambda: torch.ones(2, 5, 3 * 64).view(2, 5, 3, 64).transpose(1, 2),
     True),                                                  # head split
    (lambda: torch.ones(2, 3, 5, 6), False),                 # rows of 24 B
    (lambda: torch.ones(2, 3, 5, 9)[..., 1:], False),        # offset start
    (lambda: torch.ones(2, 3, 5, 8, dtype=torch.bfloat16), True),
    (lambda: torch.ones(2, 3, 5, 4, dtype=torch.float16), False),
])
def test_rows_aligned_chooses_the_copy_width(make, aligned):
    """16-byte copies only when every row starts on 16 bytes (base pointer
    and the batch, head and row strides); else element by element. K3
    applies the same rule to q, k and v inside its entry point."""
    t = make()
    assert k3._rows_aligned((t,)) is aligned
    assert k3._rows_aligned((torch.ones(1, 1, 2, 4), t)) is aligned


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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("d", [32, 64, 128])
def test_k3_resources_match_its_geometry_on_card(cuda_device, d, dtype):
    """The compiled kernel's threads and shared memory are fwd_geometry's,
    it keeps within the registers of two CTAs an SM, and the card holds
    two of its CTAs an SM."""
    occ = k3.fwd_occupancy(d, dtype)
    g = k3.fwd_geometry(d, dtype)
    assert occ["threads"] == g["threads"]
    assert occ["smem_bytes"] == g["smem_bytes"]
    assert occ["registers"] <= 128
    assert occ["ctas_per_sm"] >= 2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k3_element_path_gives_the_copy_path_bits_on_card(cuda_device,
                                                          dtype):
    """Operands whose rows do not start on 16 bytes take the element path;
    its output is bit for bit that of the 16-byte copies."""
    gen = torch.Generator(device=cuda_device).manual_seed(11)
    x = torch.randn(3, 2, 4, 150, 65, generator=gen,
                    device=cuda_device).to(dtype)
    q, k, v = (x[i, ..., 1:] for i in range(3))  # rows start 1 element in
    kb = torch.zeros(2, 150, device=cuda_device)
    kb[1, 100:] = NEG
    assert not k3._rows_aligned((q,))
    got = k3.flash_attention_fwd(q, k, v, kb)
    want = k3.flash_attention_fwd(q.contiguous(), k.contiguous(),
                                  v.contiguous(), kb)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.cuda
def test_k3_raises_on_card(cuda_device):
    q = torch.ones(1, 2, 4, 8, device=cuda_device, dtype=torch.float64)
    with pytest.raises(TypeError, match="dtype"):
        k3.flash_attention_fwd(q, q, q)
    q = torch.ones(1, 2, 4, 160, device=cuda_device)
    with pytest.raises(ValueError, match="limit"):
        k3.flash_attention_fwd(q, q, q)


def _bwd_case(gen, dev, shape, dtype, layout):
    """q, k, v, do on the card (packed, or the head split of a [B, T, H*d]
    projection) and a key bias with ragged lengths and batch row 0 fully
    masked."""
    B, H, Tq, Tk, d = shape

    def operand(T):
        if layout == "packed":
            return torch.randn(B, H, T, d, generator=gen, device=dev).to(dtype)
        return torch.randn(B, T, H, d, generator=gen,
                           device=dev).to(dtype).transpose(1, 2)
    q, k, v, do = operand(Tq), operand(Tk), operand(Tk), operand(Tq)
    lengths = torch.randint(1, Tk + 1, (B,), generator=gen, device=dev)
    kb = torch.where(torch.arange(Tk, device=dev)[None, :]
                     < lengths[:, None], 0.0, NEG).contiguous()
    kb[0] = NEG
    return q, k, v, do, kb


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["packed", "heads"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("shape", [(2, 12, 128, 128, 64),
                                   (2, 12, 77, 77, 64),
                                   (2, 4, 200, 200, 128),
                                   (3, 2, 16, 24, 32), (1, 1, 1, 1, 1),
                                   (2, 3, 40, 300, 64), (2, 3, 50, 70, 48),
                                   (1, 2, 33, 150, 96)],
                         ids=str)
def test_k4_k5_match_plain_on_card(cuda_device, shape, dtype, layout):
    """The fused backward, twice (bit-equal), against the plain versions;
    its dq-only and dk/dv-only calls give the same bits. (2, 4, 200, 200,
    128), (2, 3, 40, 300, 64) and (1, 2, 33, 150, 96) span several key
    blocks, so dq is summed from per-block partials; d = 48 and 96 leave
    the kernel's padded columns empty."""
    gen = torch.Generator(device=cuda_device).manual_seed(sum(shape) + 1)
    q, k, v, do, kb = _bwd_case(gen, cuda_device, shape, dtype, layout)
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for bias in (None, kb):
            o, m, l = k3.flash_attention_fwd(q, k, v, bias)
            di = k3.attention_di(o, do)
            args = (q, k, v, bias, m, l, di, do)
            before = (k3.launches_bwd, k3.launches_dq, k3.launches_dkv)
            got = k3.flash_attention_bwd(*args)
            again = k3.flash_attention_bwd(*args)
            alone = (k3.flash_attention_bwd_dq(*args),
                     *k3.flash_attention_bwd_dkv(*args))
            torch.cuda.synchronize()
            assert (k3.launches_bwd, k3.launches_dq, k3.launches_dkv) == (
                before[0] + 4, before[1] + 3, before[2] + 3)
            assert all(torch.equal(a, b) for a, b in zip(got, again))
            assert all(torch.equal(a, b) for a, b in zip(got, alone))
            assert [t.stride() for t in got] == [q.stride(), k.stride(),
                                                 v.stride()]
            want = (k3.flash_attention_bwd_dq_reference(*args),
                    *k3.flash_attention_bwd_dkv_reference(*args))
            for g, w in zip(got, want):
                if dtype == torch.float32:
                    assert float((g - w).abs().max()) <= 2e-5
                else:
                    assert k3.ulp_error(g, w) <= ULP_TOL
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


@pytest.mark.cuda
def test_fused_attention_trains_on_card(cuda_device):
    """The dispatcher's fused route end to end on the card: one K3 and
    one fused backward launch (writing dq, dk and dv), gradients as the
    plain versions give them, no gradient for the key bias, and mode 'off'
    refused."""
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    q, k, v, do, kb = _bwd_case(gen, cuda_device, (2, 4, 40, 40, 32),
                                torch.float32, "heads")
    q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
    bias = kb[:, None, None, :].clone().requires_grad_()
    before = (k3.launches, k3.launches_bwd, k3.launches_dq, k3.launches_dkv)
    fa.attention(q, k, v, bias).backward(do)
    torch.cuda.synchronize()
    assert (k3.launches, k3.launches_bwd, k3.launches_dq,
            k3.launches_dkv) == tuple(b + 1 for b in before)
    assert bias.grad is None
    o, m, l = k3.flash_attention_fwd_reference(q, k, v, kb)
    want = k3.flash_attention_bwd_reference(q.detach(), k.detach(),
                                            v.detach(), kb, o, m, l, do)
    for t, w in zip((q, k, v), want):
        assert float((t.grad - w).abs().max()) <= 2e-5
    old = fa.set_mode("off")
    try:
        with pytest.raises(ValueError, match="'off'"):
            fa.attention(q, k, v)
    finally:
        fa.set_mode(old)
