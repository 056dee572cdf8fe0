"""Truncated-BPTT training on the card against the CPU (needs an NVIDIA
card; skips without one).

A tiny TextGenerationLSTM (vocab 11, two ``LSTM(16,
use_pallas_cell=True)``, ``RnnOutputLayer(11)``, ``tbptt_length(4)``,
``Adam(1e-2)``, float32, TF32 off) is built from one seed on ``cuda``
and on the CPU (the same weights: the draws come from one CPU
generator) and takes 3 ``fit`` steps on the same batches with ragged
masks. The losses agree within 1e-5 relative and the parameters within
atol 1e-6 + rtol 1e-4 (an Adam step is 1e-2; cuBLAS and the CPU sum in
other orders); ``fit`` launches no K8 (the gradient path keeps the plain
cell); the trained net's ``output`` runs 2 x its time bucket K8 launches
and agrees with the CPU's within 1e-5. This module imports no JAX, so
it runs on a machine without it."""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch import environment as env
from deeplearning4j_tpu_torch.data.dataset import DataSet
from deeplearning4j_tpu_torch.kernels import lstm_cell as k8
from deeplearning4j_tpu_torch.nn.config import (InputType,
                                                NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn.layers import LSTM, RnnOutputLayer
from deeplearning4j_tpu_torch.nn.model import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.updaters import Adam

VOCAB, UNITS, B, T = 11, 16, 4, 10


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("K8 is CUDA C++ with no CPU mode; needs an NVIDIA card "
                    "and nvcc")
    return torch.device("cuda")


def _net(device):
    conf = (NeuralNetConfiguration.builder().seed(13)
            .updater(Adam(learning_rate=1e-2))
            .input_type(InputType.recurrent(VOCAB)).tbptt_length(4)
            .list(LSTM(n_out=UNITS, use_pallas_cell=True),
                  LSTM(n_out=UNITS, use_pallas_cell=True),
                  RnnOutputLayer(n_out=VOCAB)).build())
    return MultiLayerNetwork(conf).init(device=device)


def _batch(seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, VOCAB, (B, T + 1))
    eye = np.eye(VOCAB, dtype=np.float32)
    mask = (np.arange(T)[None, :] < np.array([T, 7, 3, 1])[:, None]).astype(
        np.float32)
    return DataSet(eye[ids[:, :-1]], eye[ids[:, 1:]], mask, mask)


@pytest.mark.cuda
def test_tbptt_fit_on_card_matches_cpu(cuda_device):
    env.Environment.instance().f32_matmul_precision = "highest"
    card, cpu = _net(cuda_device), _net("cpu")
    for v, p in cpu.params.items():
        for k, t in p.items():
            assert torch.equal(card.params[v][k].cpu(), t)
    before = k8.launches
    for seed in (1, 2, 3):
        ds = _batch(seed)
        card.fit(ds)
        cpu.fit(ds)
        np.testing.assert_allclose(card.score(), cpu.score(), rtol=1e-5)
    assert k8.launches == before
    for v, p in cpu.params.items():
        for k, t in p.items():
            np.testing.assert_allclose(card.params[v][k].cpu().numpy(),
                                       t.numpy(), rtol=1e-4, atol=1e-6,
                                       err_msg=f"{v}/{k}")
    x = _batch(4).features
    got = card.output(x)
    assert k8.launches == before + 2 * 16  # time bucket 16
    np.testing.assert_allclose(got, cpu.output(x), rtol=1e-5, atol=1e-5)
