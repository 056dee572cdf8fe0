"""Training the port's ResNet-18 against the JAX package's, on the CPU, at
32x32x3 input, 10 classes, batch 4: the loss, every parameter gradient
and the new BN running statistics of one step, then two ``fit`` steps.

The port takes the JAX net's weights and Adam state (``from_numpy``).

Tolerances (whole-tensor relative norms):

- loss 1e-4; every gradient 1e-3 and every new BN running statistic
  1e-4: both sides are float32 and differ in the summation order of each
  convolution and its two gradients (measured: 3.9e-6, 1.3e-4 and
  7.0e-6). The JAX package against itself, with its BN on the Pallas
  kernels (interpret) instead of the plain XLA ops, differs by 7e-5 in
  the gradients.
- two ``fit`` steps, each from the same starting point (the second
  starts both packages from the JAX package's params, BN state and Adam
  state after the first): each step's update and Adam's m and v 1e-2,
  the BN running statistics 1e-4, each step's loss 1e-4 (measured:
  5.8e-4, 2.2e-4, 7.0e-6 and 1.2e-5 at most). A wrong bias correction,
  step count or moment would move an update by tens of percent.

The nets use Adam with epsilon 1e-3. With the zoo's 1e-8 a first step is
lr * sign(g) for every |g| >> 1e-8, so the elements whose gradient is
below the gradients' rounding noise step with the noise's sign, and even
the JAX package against itself then differs by 5% in the updates. With
epsilon 1e-3 the update is a smooth function of the gradient. The zoo
updater's own arithmetic is held to the JAX package's in
``test_torch_updaters.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models.resnet import resnet as jresnet
from deeplearning4j_tpu.nn.updaters import Adam as JAdam
from deeplearning4j_tpu_torch.models import resnet
from deeplearning4j_tpu_torch.nn.updaters import Adam
from deeplearning4j_tpu_torch.utils.convert import from_numpy

SHAPE = (32, 32, 3)
BATCH = 4
EPS = 1e-3


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


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
    """Both packages from the same weights: one step's loss, gradients and
    BN state, then two fit steps."""
    rng = np.random.default_rng(18)
    x = rng.standard_normal((BATCH,) + SHAPE).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, BATCH)]
    jnet = jresnet(18, input_shape=SHAPE, num_classes=10,
                   updater=JAdam(learning_rate=1e-3, epsilon=EPS)).init()
    p0, s0, u0 = _np(jnet.params), _np(jnet.state), _np(jnet.updater_state)
    vg = jax.jit(jax.value_and_grad(jnet._build_loss_fn(), has_aux=True))
    (jloss, jbn), jgrads = vg(jnet.params, jnet.state,
                              jax.random.PRNGKey(0), (jnp.asarray(x),),
                              (jnp.asarray(y),), (None,), (None,))
    net = resnet(18, input_shape=SHAPE, num_classes=10,
                 updater=Adam(learning_rate=1e-3, epsilon=EPS)).init(
                     device="cpu")
    net.params, net.state, net.updater_state = from_numpy(
        p0, s0, device="cpu", updater_state=u0)
    loss, grads, bn = net._value_and_grad(
        (torch.from_numpy(x),), (torch.from_numpy(y),), (None,), (None,))
    steps = []
    for step in range(2):
        if step:  # start the port where the JAX package stands
            net.params, net.state, net.updater_state = from_numpy(
                _np(jnet.params), _np(jnet.state), device="cpu",
                updater_state=_np(jnet.updater_state))
        start = _np(jnet.params)
        jnet.fit(x, y)
        net.fit(x, y)
        steps.append({
            "start": start, "scores": (net.score(), float(jnet.score())),
            "jax": {"params": _np(jnet.params), "state": _np(jnet.state),
                    "opt": _np(jnet.updater_state)},
            "port": jax.tree.map(lambda t: t.numpy(), {
                "params": net.params, "state": net.state,
                "opt": net.updater_state})})
    return {"jax": {"loss": float(jloss), "grads": _np(jgrads),
                    "bn": _np(jbn), "iteration": jnet.iteration},
            "port": {"loss": float(loss), "grads": grads, "bn": bn,
                     "iteration": net.iteration}, "steps": steps}


def test_loss_matches_jax(run):
    assert abs(run["port"]["loss"] - run["jax"]["loss"]) \
        <= 1e-4 * abs(run["jax"]["loss"])


def test_every_gradient_matches_jax(run):
    want, got = run["jax"]["grads"], run["port"]["grads"]
    assert set(got) == set(want)
    for v in want:
        assert set(got[v]) == set(want[v])
        for k in want[v]:
            assert _rel(got[v][k].numpy(), want[v][k]) <= 1e-3, (v, k)


def test_new_bn_state_matches_jax(run):
    want, got = run["jax"]["bn"], run["port"]["bn"]
    assert set(got) == set(want) and len(want) == 21
    for v in want:
        for k in ("mean", "var"):
            assert _rel(got[v][k].numpy(), want[v][k]) <= 1e-4, (v, k)


@pytest.mark.parametrize("step", [0, 1])
def test_two_adam_steps_match_jax_fit(run, step):
    assert run["port"]["iteration"] == run["jax"]["iteration"] == 2
    st = run["steps"][step]
    got, want, p0 = st["port"], st["jax"], st["start"]
    for v in p0:
        for k in p0[v]:
            assert _rel(got["params"][v][k] - p0[v][k],
                        want["params"][v][k] - p0[v][k]) <= 1e-2, (v, k)
            for m in ("m", "v"):
                assert _rel(got["opt"][m][v][k], want["opt"][m][v][k]) \
                    <= 1e-2, (m, v, k)
    for v in want["state"]:
        for k in ("mean", "var"):
            assert _rel(got["state"][v][k], want["state"][v][k]) <= 1e-4
    port_score, jax_score = st["scores"]
    assert abs(port_score - jax_score) <= 1e-4 * abs(jax_score)
    if step:
        assert port_score < run["steps"][0]["scores"][0]
