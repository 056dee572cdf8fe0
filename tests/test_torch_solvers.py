"""The solver path in the port (``optimize/solvers.py``,
``optimization_algo``) against the JAX package on the CPU: the JAX
``tests/test_solvers.py`` cases (:33-135) case for case on torch vectors,
the same quadratics driven through both packages' solvers, LBFGS,
conjugate gradient and line gradient descent ``fit`` on tiny nets from
the same weights, evaluation by evaluation against the JAX solver, the
configuration's JSON, and what the solver path refuses.

Tolerances: the convex cases as the JAX tests state them; the nets'
per-evaluation losses within 1e-4 of the JAX package's (both walk the
same Armijo branches: the losses differ in float32 summation order
only)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
from deeplearning4j_tpu.nn.config import InputType as JInputType
from deeplearning4j_tpu.nn.config import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.nn.layers import core as jcore
from deeplearning4j_tpu.nn.model import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.optimize import solvers as jsol
from deeplearning4j_tpu_torch.data.dataset import DataSet
from deeplearning4j_tpu_torch.nn.config import (InputType,
                                                MultiLayerConfiguration,
                                                NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn.layers import core, special
from deeplearning4j_tpu_torch.nn.model import MultiLayerNetwork
from deeplearning4j_tpu_torch.optimize.solvers import (BackTrackLineSearch,
                                                       ConjugateGradient,
                                                       LBFGS,
                                                       LineGradientDescent,
                                                       get_solver)
from deeplearning4j_tpu_torch.utils.convert import from_numpy


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


def _quadratic(n=12, seed=0, cond=30.0):
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    A = (q * np.linspace(1.0, cond, n)) @ q.T
    b = rng.normal(size=(n,))
    At = torch.tensor(A, dtype=torch.float32)
    bt = torch.tensor(b, dtype=torch.float32)

    def f(x):
        return 0.5 * x @ At @ x - bt @ x, At @ x - bt

    return f, np.linalg.solve(A, b)


def test_line_search_armijo_decrease():
    f, _ = _quadratic()
    x = torch.zeros(12)
    fx, g = f(x)
    step, _, f_new, _ = BackTrackLineSearch().search(f, x, float(fx), g, -g)
    assert step > 0.0 and f_new < float(fx)


def test_line_search_rejects_ascent_direction():
    f, _ = _quadratic()
    x = torch.zeros(12)
    fx, g = f(x)
    step, *_ = BackTrackLineSearch().search(f, x, float(fx), g, g)
    assert step == 0.0


def test_lbfgs_converges_on_quadratic():
    f, x_star = _quadratic()
    x, _ = LBFGS(iterations=60, memory=10).minimize(f, torch.zeros(12))
    np.testing.assert_allclose(x.numpy(), x_star, rtol=1e-3, atol=1e-3)


def test_cg_converges_on_quadratic():
    f, x_star = _quadratic()
    x, _ = ConjugateGradient(iterations=120).minimize(f, torch.zeros(12))
    np.testing.assert_allclose(x.numpy(), x_star, rtol=1e-2, atol=1e-2)


def test_lbfgs_beats_plain_gd_on_ill_conditioned():
    f, x_star = _quadratic(cond=300.0, seed=3)
    lb, _ = LBFGS(iterations=40).minimize(f, torch.zeros(12))
    gd, _ = LineGradientDescent(iterations=40).minimize(f, torch.zeros(12))
    assert np.linalg.norm(lb.numpy() - x_star) < \
        0.5 * np.linalg.norm(gd.numpy() - x_star)


def test_lbfgs_rosenbrock():
    def f(x):
        x = x.detach().requires_grad_(True)
        v = (1 - x[0]) ** 2 + 100.0 * (x[1] - x[0] ** 2) ** 2
        g, = torch.autograd.grad(v, x)
        return v.detach(), g

    x, _ = LBFGS(iterations=200).minimize(f, torch.tensor([-1.2, 1.0]))
    np.testing.assert_allclose(x.numpy(), [1.0, 1.0], atol=2e-2)


@pytest.mark.parametrize("name", ["LBFGS", "CONJUGATE_GRADIENT",
                                  "LINE_GRADIENT_DESCENT"])
def test_solvers_follow_jax_on_the_quadratic(name):
    """The same solver on the same quadratic in both packages: the
    accepted loss after every iteration within 1e-4 relative."""
    f, _ = _quadratic(seed=1)
    rng = np.random.default_rng(1)
    q, _ = np.linalg.qr(rng.normal(size=(12, 12)))
    A = jnp.asarray((q * np.linspace(1.0, 30.0, 12)) @ q.T, jnp.float32)
    b = jnp.asarray(rng.normal(size=(12,)), jnp.float32)

    def jf(x):
        return 0.5 * x @ A @ x - b @ x, A @ x - b

    opt = get_solver(name, iterations=7)
    opt.minimize(f, torch.zeros(12))
    assert opt.history
    for i, v in enumerate(opt.history):
        _, jfx = jsol.get_solver(name, iterations=i + 1).minimize(
            jf, jnp.zeros(12))
        np.testing.assert_allclose(v, float(jfx), rtol=1e-4, atol=1e-6)


def test_get_solver_validates():
    for name in ("NEWTON", "sgd"):
        with pytest.raises(ValueError, match="optimization_algo"):
            get_solver(name)
        with pytest.raises(ValueError, match="optimization_algo"):
            jsol.get_solver(name)
    with pytest.raises(ValueError, match="optimization_algo"):
        NeuralNetConfiguration.builder().optimization_algo("NEWTON")


# ------------------------------------------------------------ the nets

def _conf(m, algo, iterations, seed, n_in, hidden, act, n_out):
    conf, it, cr = m
    return (conf.builder().seed(seed)
            .optimization_algo(algo, iterations=iterations)
            .input_type(it.feed_forward(n_in))
            .list(cr.DenseLayer(n_out=hidden, activation=act),
                  cr.OutputLayer(n_out=n_out, loss="mcxent"))
            .build())


CASES = {
    "LBFGS": ("LBFGS", 8, 2, 6, 12, "tanh", 3),
    "CONJUGATE_GRADIENT": ("CONJUGATE_GRADIENT", 6, 4, 5, 8, "relu", 2),
    "LINE_GRADIENT_DESCENT": ("LINE_GRADIENT_DESCENT", 5, 3, 6, 10, "tanh",
                              3),
}


def _pair(case):
    algo, iters, seed, n_in, hidden, act, n_out = CASES[case]
    jnet = JMLN(_conf((JConf, JInputType, jcore), algo, iters, seed, n_in,
                      hidden, act, n_out)).init()
    net = MultiLayerNetwork(_conf((NeuralNetConfiguration, InputType, core),
                                  algo, iters, seed, n_in, hidden, act,
                                  n_out)).init(device="cpu")
    net.params, net.state = from_numpy(
        jax.tree.map(np.asarray, jnet.params),
        jax.tree.map(np.asarray, jnet.state), "cpu")
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(64, n_in)).astype(np.float32)
    w = rng.normal(size=(n_in, n_out)).astype(np.float32)
    y = np.eye(n_out, dtype=np.float32)[np.argmax(x @ w, axis=1)]
    return jnet, net, x, y


def _jax_fx(jnet0, case, iterations, x, y):
    """The JAX solver's loss after ``iterations`` iterations on one batch,
    from ``jnet0``'s weights."""
    algo = CASES[case][0]
    jnet = JMLN(jnet0.conf).init()
    jnet.params, jnet.state = jnet0.params, jnet0.state
    return jsol.Solver(jnet, algo, iterations=iterations).optimize(
        jnp.asarray(x), jnp.asarray(y))


@pytest.mark.parametrize("case", sorted(CASES))
def test_solver_fit_follows_jax(case):
    """``fit`` on a first batch from the same weights: the loss after each
    solver iteration within 1e-4 of the JAX solver's after as many
    iterations; the function evaluations a K1/K2 count is read against
    are recorded; on two more batches each batch's loss falls."""
    jnet, net, x, y = _pair(case)
    s0 = net.score(DataSet(x, y))
    assert s0 == pytest.approx(float(jnet.score(JDataSet(x, y))), rel=1e-5)
    xb, yb = x[:16], y[:16]
    net.fit(xb, yb)
    hist = net._solver.opt.history
    assert hist and len(net._solver.evaluations) > len(hist)
    for i, v in enumerate(hist):
        np.testing.assert_allclose(v, float(_jax_fx(jnet, case, i + 1,
                                                    xb, yb)),
                                   rtol=0, atol=1e-4)
    for i in (1, 2):
        net.fit(x[i * 16:(i + 1) * 16], y[i * 16:(i + 1) * 16])
        assert net.score() < net._solver.evaluations[0]
    assert net.iteration == 3


def test_lbfgs_fit_learns_and_json_round_trips():
    """The JAX package's LBFGS fit case: the loss at least halves over 6
    fits; the configuration's JSON keeps the solver, and equals the JAX
    package's."""
    jnet, net, x, y = _pair("LBFGS")
    cfg = net.conf
    assert cfg.optimization_algo == "LBFGS" and cfg.solver_iterations == 8
    cfg2 = MultiLayerConfiguration.from_json(cfg.to_json())
    assert (cfg2.optimization_algo, cfg2.solver_iterations,
            cfg2.max_line_search_iterations) == ("LBFGS", 8, 5)
    import json
    assert json.loads(cfg.to_json()) == json.loads(jnet.conf.to_json())
    s0 = net.score(DataSet(x, y))
    for _ in range(6):
        net.fit(x, y)
    assert net.score(DataSet(x, y)) < 0.5 * s0


def test_what_the_solver_path_refuses():
    """Gradient clipping or normalization, a center-loss head, and a
    solver on the graph builder raise, as in the JAX package."""
    x, y = np.zeros((4, 6), np.float32), np.eye(3, dtype=np.float32)[
        [0, 1, 2, 0]]
    conf = (NeuralNetConfiguration.builder().optimization_algo("LBFGS")
            .gradient_normalization("ClipL2PerLayer", 1.0)
            .input_type(InputType.feed_forward(6))
            .list(core.OutputLayer(n_out=3)).build())
    with pytest.raises(ValueError, match="clipping"):
        MultiLayerNetwork(conf).init(device="cpu").fit(x, y)
    conf = (NeuralNetConfiguration.builder().optimization_algo("LBFGS")
            .input_type(InputType.feed_forward(6))
            .list(special.CenterLossOutputLayer(n_out=3)).build())
    with pytest.raises(ValueError, match="CenterLossOutputLayer"):
        MultiLayerNetwork(conf).init(device="cpu").fit(x, y)
    with pytest.raises(ValueError, match="ComputationGraph"):
        NeuralNetConfiguration.builder().optimization_algo(
            "LBFGS").graph_builder()
