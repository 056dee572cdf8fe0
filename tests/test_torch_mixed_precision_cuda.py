"""bfloat16 training on the card (marked ``cuda``, skipped without one):
K2 on bfloat16 inputs at every ResNet-50 epilogue shape of a batch-32
step, element by element against its plain version, and a small bf16
network's fused master-cast step against its unfused step on the card.
This file imports no JAX, so ``pytest --noconftest
tests/test_torch_mixed_precision_cuda.py -m cuda`` runs on the card's
machine.

Tolerances: dx within ``affine_act.ulp_tolerance(bfloat16)`` (one
bfloat16 ulp over the float32 tolerance), dscale and dshift within 1e-4
of each channel's sum over rows of |term| (float32 sums of up to 401,408
bfloat16-rounded terms in another order), a second run bit-equal; the
fused step within the spread of two unfused runs (bit for bit when those
repeat)."""

import pytest
import torch

from deeplearning4j_tpu_torch.kernels import affine_act as k1

#: ResNet-50's distinct K1/K2 [rows, C] shapes at batch 32 (224x224)
RESNET50_SHAPES = ((401408, 64), (100352, 64), (100352, 256),
                   (25088, 128), (25088, 512), (6272, 256), (6272, 1024),
                   (1568, 512), (1568, 2048))
K2_SUM_TOL = 1e-4


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("K1 and K2 are CUDA C++ with no CPU mode; need an "
                    "NVIDIA card and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("act", ["identity", "relu"])
@pytest.mark.parametrize("rows,cols", RESNET50_SHAPES)
def test_bf16_k2_at_resnet50_shapes(cuda_device, rows, cols, act):
    gen = torch.Generator(device=cuda_device).manual_seed(rows + cols)
    x = torch.randn(rows, cols, generator=gen,
                    device=cuda_device).to(torch.bfloat16)
    dy = torch.randn(rows, cols, generator=gen,
                     device=cuda_device).to(torch.bfloat16)
    scale = torch.rand(cols, generator=gen, device=cuda_device) + 0.5
    shift = torch.randn(cols, generator=gen, device=cuda_device)
    before = k1.bf16_bwd_launches
    got = k1.affine_act_bwd(x, scale, shift, dy, act)
    again = k1.affine_act_bwd(x, scale, shift, dy, act)
    torch.cuda.synchronize()
    assert k1.bf16_bwd_launches == before + 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    want = k1.affine_act_bwd_reference(x, scale, shift, dy, act)
    assert got[0].dtype == torch.bfloat16
    atol, rtol = k1.ulp_tolerance(torch.bfloat16)
    torch.testing.assert_close(got[0].float(), want[0].float(), atol=atol,
                               rtol=rtol)
    xf = x.float()
    dz = (dy.float() * k1.act_grad(act, xf * scale + shift)).abs()
    for g, w, mag in ((got[1], want[1], (dz * xf.abs()).sum(0)),
                      (got[2], want[2], dz.sum(0))):
        assert g.dtype == torch.float32
        assert bool(((g - w).abs() <= K2_SUM_TOL * mag + 1e-6).all())


@pytest.mark.cuda
def test_bf16_fused_step_on_card(cuda_device):
    """A small conv -> BN -> ReLU -> pool -> output net in bfloat16: one
    bf16 K1 a forward and one bf16 K2 a step; three fused steps against
    three unfused ones from the same masters."""
    from deeplearning4j_tpu_torch.nn import updaters as upd
    from deeplearning4j_tpu_torch.nn.config import (InputType,
                                                    NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.nn.layers import conv, core

    def build():
        return ComputationGraph(
            NeuralNetConfiguration.builder().seed(3).data_type("BFLOAT16")
            .updater(upd.Adam(learning_rate=1e-3)).graph_builder()
            .add_inputs("in")
            .set_input_types(InputType.convolutional(8, 16, 16,
                                                     data_format="NHWC"))
            .add_layer("c", conv.ConvolutionLayer(
                n_out=32, kernel=(3, 3), padding=(1, 1), has_bias=False,
                data_format="NHWC"), "in")
            .add_layer("bn", conv.BatchNormalization(data_format="NHWC"),
                       "c")
            .add_layer("act", core.ActivationLayer(activation="relu"), "bn")
            .add_layer("pool", conv.GlobalPoolingLayer(pool_type="avg",
                                                       data_format="NHWC"),
                       "act")
            .add_layer("out", core.OutputLayer(n_out=4), "pool")
            .set_outputs("out").build()).init(device=cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn(8, 16, 16, 8, generator=gen, device=cuda_device)
    y = torch.eye(4, device=cuda_device)[torch.arange(8) % 4]
    batch = ((x,), (y,), (None,), (None,))
    runs = []
    for fused in (False, False, True):
        net = build()
        step = net._build_train_step(fused_cast=fused)
        before = (k1.bf16_launches, k1.bf16_bwd_launches)
        for _ in range(3):
            step(*batch)
            net.iteration += 1
        torch.cuda.synchronize()
        assert (k1.bf16_launches - before[0],
                k1.bf16_bwd_launches - before[1]) == (3, 3)
        runs.append(torch.cat([t.flatten() for t in
                               _leaves(net.params)
                               + _leaves(net.updater_state)]))
    spread = (runs[0] - runs[1]).abs()
    assert bool(((runs[2] - runs[0]).abs() <= spread).all())


def _leaves(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    return [tree]
