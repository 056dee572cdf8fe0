"""The port's ResNet-50 training loss and gradients against the JAX
package's, on the CPU, at 32x32x3 input, 10 classes, batch 2, from the
same weights (``from_numpy``), in float64: both packages run the
``DOUBLE`` network (the JAX package under ``jax.enable_x64``, a context
that restores the setting).

Why float64: at 32x32 the last stage is 1x1 spatially, so with batch 2
each of its BatchNormalizations normalizes 2 values per channel (stage 2:
8), and the two examples' features are close after 40 layers at random
init. Each such BN multiplies the relative error by about 10 (measured in
float64 from another random init: 5e-11 entering stage 3, 2e-9 after two
of its BNs; there the float32 loss differed from the float64 one by 1%
in the JAX package and 5% in the port), so a float32 comparison would
compare rounding noise. The float32 path is the same code on float32
tensors; here it must give a finite loss and finite gradients of the
right shapes.

Tolerances (float64, whole-tensor relative norms): loss 1e-4, every
gradient 2e-3, every new BN running statistic 1e-4 (measured: 1.2e-5,
1.9e-4 and 1.7e-6 at most, the amplified float64 rounding above)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models.resnet import resnet as jresnet
from deeplearning4j_tpu_torch.models import resnet
from deeplearning4j_tpu_torch.utils.convert import from_numpy

SHAPE = (32, 32, 3)
BATCH = 2


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        yield
    finally:
        torch.set_num_threads(old)


@pytest.fixture(scope="module")
def run():
    rng = np.random.default_rng(50)
    x = rng.standard_normal((BATCH,) + SHAPE)
    y = np.eye(10)[rng.integers(0, 10, BATCH)]
    with jax.enable_x64(True):
        jnet = jresnet(50, input_shape=SHAPE, num_classes=10,
                       dtype="DOUBLE").init()
        vg = jax.jit(jax.value_and_grad(jnet._build_loss_fn(),
                                        has_aux=True))
        (jloss, jbn), jgrads = vg(jnet.params, jnet.state,
                                  jax.random.PRNGKey(0), (jnp.asarray(x),),
                                  (jnp.asarray(y),), (None,), (None,))
        params = jax.tree.map(np.asarray, jnet.params)
        state = jax.tree.map(np.asarray, jnet.state)
        want = {"loss": float(jloss), "grads": jax.tree.map(np.asarray,
                                                           jgrads),
                "bn": jax.tree.map(np.asarray, jbn)}
    assert params["fc"]["W"].dtype == np.float64
    net = resnet(50, input_shape=SHAPE, num_classes=10,
                 dtype="DOUBLE").init(device="cpu")
    net.params, net.state = from_numpy(params, state, device="cpu")
    loss, grads, bn = net._value_and_grad(
        (torch.from_numpy(x),), (torch.from_numpy(y),), (None,), (None,))
    net32 = resnet(50, input_shape=SHAPE, num_classes=10).init(device="cpu")
    net32.params, net32.state = from_numpy(
        jax.tree.map(lambda a: a.astype(np.float32), params),
        jax.tree.map(lambda a: a.astype(np.float32), state), device="cpu")
    f32 = net32._value_and_grad(
        (torch.from_numpy(x.astype(np.float32)),),
        (torch.from_numpy(y.astype(np.float32)),), (None,), (None,))
    return {"jax": want, "port": {"loss": float(loss), "grads": grads,
                                  "bn": bn}, "f32": f32, "params": params}


def test_loss_matches_jax_in_float64(run):
    got, want = run["port"]["loss"], run["jax"]["loss"]
    assert abs(got - want) <= 1e-4 * abs(want)


def test_every_gradient_matches_jax_in_float64(run):
    want, got = run["jax"]["grads"], run["port"]["grads"]
    assert set(got) == set(want) and len(want) == 107
    for v in want:
        assert set(got[v]) == set(want[v])
        for k in want[v]:
            assert got[v][k].dtype == torch.float64
            assert _rel(got[v][k].numpy(), want[v][k]) <= 2e-3, (v, k)


def test_new_bn_state_matches_jax_in_float64(run):
    want, got = run["jax"]["bn"], run["port"]["bn"]
    assert len(want) == 53
    for v in want:
        for k in ("mean", "var"):
            assert _rel(got[v][k].numpy(), want[v][k]) <= 1e-4, (v, k)


def test_float32_step_is_finite(run):
    loss, grads, bn = run["f32"]
    assert loss.dtype == torch.float32 and torch.isfinite(loss)
    for v, leaves in run["params"].items():
        for k, p in leaves.items():
            g = grads[v][k]
            assert g.dtype == torch.float32 and tuple(g.shape) == p.shape
            assert bool(torch.isfinite(g).all()), (v, k)
    assert len(bn) == 53
