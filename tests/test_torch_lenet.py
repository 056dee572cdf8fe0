"""The port's LeNet training slice against the JAX package, on the CPU.

Zoo ``lenet()`` at full width (conv 5x5 (20) -> max pool -> conv 5x5 (50)
-> max pool -> dense 500 -> softmax 10, NCHW, ``Adam(1e-3)``, ``l2(5e-5)``,
float32), both packages on the same parameters (the JAX package's, through
a saved ZIP or ``utils.convert.from_numpy``) and the same numpy batches:

- ``build()`` puts a FlattenLayer at index 4 in both, and a JAX-saved
  LeNet ZIP loads into the port with the same layer list and outputs;
- the forward, the loss with its l2 term, every gradient and one Adam step
  agree (float32 on two CPU convolution libraries: 1e-5 relative for
  outputs and the loss, 1e-4 of each gradient's largest magnitude; after
  a step each parameter within 1e-6 plus what that gradient error can move
  Adam's first step, ``lr * g / (|g| + eps)``: ``lr * min(2, 1e-4 *
  max|g| / (|g| + eps))``);
- the golden replay: from the JAX ``lenet(seed=777)`` parameters, the
  port's 8 Adam steps on ``golden_harness.run_reference_training``'s
  batches follow ``tests/fixtures/lenet_golden.json`` within
  ``golden_harness.compare``'s bands (rtol 1e-3, atol 1e-5);
- ``Evaluation``, ``RegressionEvaluation``, the normalizers and the
  synthetic MNIST renderer give what the JAX copies give (the renderer and
  the iterator's batches bit for bit);
- dropout by distribution (its generator is not JAX's): the kept share
  within 5 binomial standard deviations, kept values scaled by 1 / (1 -
  rate), a seeded generator repeating its mask;
- what the slice leaves out raises ``NotImplementedError``.
"""

import json

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.data import mnist as jmnist
from deeplearning4j_tpu.data import normalizers as jnorm
from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
from deeplearning4j_tpu.eval import evaluation as jeval
from deeplearning4j_tpu.models.lenet import lenet as jlenet
from deeplearning4j_tpu_torch.data import mnist
from deeplearning4j_tpu_torch.data import normalizers as norm
from deeplearning4j_tpu_torch.data.dataset import DataSet, NumpyDataSetIterator
from deeplearning4j_tpu_torch.eval import evaluation
from deeplearning4j_tpu_torch.models import lenet, lenet_config
from deeplearning4j_tpu_torch.nn import config
from deeplearning4j_tpu_torch.nn.layers.core import DropoutLayer, FlattenLayer
from deeplearning4j_tpu_torch.nn.model import MultiLayerNetwork
from deeplearning4j_tpu_torch.ops import nnops
from deeplearning4j_tpu_torch.utils.convert import from_numpy

import golden_harness

B = 8
OUT_RTOL = 1e-5
GRAD_TOL = 1e-4
STEP_ATOL = 1e-6


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


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _port_of(jnet):
    """The port's LeNet on the CPU with ``jnet``'s configuration and
    parameters."""
    net = MultiLayerNetwork(config.MultiLayerConfiguration.from_json(
        jnet.conf.to_json())).init(device="cpu")
    net.params, net.state = from_numpy(_np_tree(jnet.params),
                                       _np_tree(jnet.state), "cpu")
    return net


@pytest.fixture(scope="module")
def nets():
    jn = jlenet(seed=5)
    return jn, _port_of(jn)


def _batch(seed, n=B):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 1, 28, 28)).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, n)]
    return x, y


def _close(got, want, rtol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= rtol, f"{what}: {err:.3g} of max |ref| > {rtol}"


# ------------------------------------------------------ the configuration

def test_build_puts_a_flatten_at_the_seam_as_jax_does():
    kinds = [l.kind for l in lenet_config().layers]
    assert kinds == [l.kind for l in jlenet(seed=1).conf.layers]
    assert kinds == ["conv2d", "subsampling2d", "conv2d", "subsampling2d",
                     "flatten", "dense", "output"]
    assert isinstance(lenet_config().layers[4], FlattenLayer)
    # a JAX configuration.json's "flatten" layer reads back as the port's
    conf = config.MultiLayerConfiguration.from_json(
        jlenet(seed=1).conf.to_json())
    assert isinstance(conf.layers[4], FlattenLayer)
    assert json.loads(conf.to_json())["layers"] == json.loads(
        jlenet(seed=1).conf.to_json())["layers"]
    # NHWC: the same seam
    assert lenet_config(data_format="NHWC").layers[4].kind == "flatten"


def test_jax_saved_lenet_zip_loads_with_the_same_outputs(tmp_path, nets):
    jn, _ = nets
    path = str(tmp_path / "lenet.zip")
    jn.save(path)
    pn = MultiLayerNetwork.load(path, device="cpu")
    assert [l.kind for l in pn.layers] == [l.kind for l in jn.layers]
    assert isinstance(pn.layers[4], FlattenLayer)
    x, _ = _batch(1)
    _close(pn.output(x), np.asarray(jn.output(x)), OUT_RTOL, "output")
    # and back: the port's ZIP loads in the JAX package
    back = str(tmp_path / "port.zip")
    pn.save(back)
    from deeplearning4j_tpu.nn.model import MultiLayerNetwork as JMLN
    jb = JMLN.load(back)
    _close(np.asarray(jb.output(x)), np.asarray(jn.output(x)), OUT_RTOL,
           "round trip")


# ---------------------------------------------------------- one step

def test_forward_loss_and_gradients_match_jax(nets):
    jn, pn = nets
    x, y = _batch(2)
    acts = pn.feed_forward(x)
    jacts = jn.feed_forward(x)
    assert len(acts) == len(jacts) == 8
    for i, (a, b) in enumerate(zip(acts, jacts)):
        assert tuple(a.shape) == tuple(np.asarray(b).shape), i
        _close(a.numpy(), np.asarray(b), OUT_RTOL, f"activation {i}")
    # the loss with the l2 term (the score of a DataSet)
    _close(pn.score(DataSet(x, y)), jn.score(JDataSet(x, y)), OUT_RTOL,
           "score")
    assert float(pn._regularization(pn.params)) > 0.0
    _close(float(pn._regularization(pn.params)),
           float(jn._regularization(jn.params)), OUT_RTOL, "l2 term")
    # gradients
    jloss = jn._build_loss_fn()
    (jl, _), jg = jax.value_and_grad(jloss, has_aux=True)(
        jn.params, jn.state, None, x, y, None, None)
    loss, grads, _ = pn._value_and_grad(torch.from_numpy(x),
                                        torch.from_numpy(y))
    _close(float(loss), float(jl), OUT_RTOL, "loss")
    jg = _np_tree(jg)
    assert grads.keys() == jg.keys()
    for k in jg:
        for name in jg[k]:
            _close(grads[k][name].numpy(), jg[k][name], GRAD_TOL,
                   f"grad {k}/{name}")


def test_one_adam_step_matches_jax():
    jn = jlenet(seed=9)
    pn = _port_of(jn)
    x, y = _batch(3)
    _, jg = jax.value_and_grad(jn._build_loss_fn(), has_aux=True)(
        jn.params, jn.state, None, x, y, None, None)
    jg = _np_tree(jg)
    jn.fit(JDataSet(x, y))
    pn.fit(DataSet(x, y))
    assert pn.iteration == jn.iteration == 1
    _close(pn.score(), jn.score(), OUT_RTOL, "fit score")
    jp = _np_tree(jn.params)
    upd = jn.conf.updater
    for k in jp:
        for name in jp[k]:
            g = np.abs(jg[k][name])
            allowed = STEP_ATOL + upd.learning_rate * np.minimum(
                2.0, GRAD_TOL * g.max() / (g + upd.epsilon))
            err = np.abs(pn.params[k][name].numpy() - jp[k][name])
            assert np.all(err <= allowed), (k, name, float(err.max()))
    for slot, tree in _np_tree(jn.updater_state).items():
        for k in tree:
            for name in tree[k]:
                _close(pn.updater_state[slot][k][name].numpy(),
                       tree[k][name], GRAD_TOL, f"{slot} {k}/{name}")


def test_golden_replay_follows_the_fixture():
    """``run_reference_training``'s 8 steps, in the port, from the JAX
    ``lenet(seed=777)`` parameters."""
    pn = _port_of(jlenet(seed=777))
    rng = np.random.default_rng(20260730)
    losses = []
    for _ in range(golden_harness.STEPS):
        x = rng.normal(size=(golden_harness.BATCH, 1, 28, 28)).astype(
            np.float32)
        y = np.eye(10, dtype=np.float32)[rng.integers(
            0, 10, golden_harness.BATCH)]
        pn.fit(DataSet(x, y), epochs=1)
        losses.append(float(pn.score()))
    params = {}
    for k in sorted(pn.params, key=int):
        for name in sorted(pn.params[k]):
            a = pn.params[k][name].double().numpy().ravel()
            params[f"['{k}']/['{name}']"] = {
                "mean": float(a.mean()), "std": float(a.std()),
                "head": [float(v) for v in a[:5]]}
    with open(golden_harness.FIXTURE) as f:
        golden = json.load(f)
    golden_harness.compare({"steps": len(losses),
                            "batch": golden_harness.BATCH,
                            "losses": losses, "params": params}, golden)


# ----------------------------------------------------- training surface

def test_fit_output_and_evaluate_on_synthetic_mnist():
    """Two epochs on 500 synthetic digits lower the loss; ``evaluate``
    goes through ``output`` and gives the accuracy of its argmax."""
    net = lenet(device="cpu", seed=3)
    it = mnist.MnistDataSetIterator(50, num_examples=500)
    assert it.source == "synthetic"
    first = DataSet(*next((d.features, d.labels) for d in it))
    it.reset()
    before = net.score(first)
    net.fit(it, epochs=2)
    assert net.iteration == 20 and net.epoch == 2
    assert net.score(first) < before
    test = mnist.MnistDataSetIterator(100, train=False, num_examples=200)
    ev = net.evaluate(test)
    xs, ys = zip(*((d.features, d.labels) for d in test))
    pred = np.argmax(net.output(np.concatenate(xs)), -1)
    assert ev.accuracy() == pytest.approx(
        float(np.mean(pred == np.argmax(np.concatenate(ys), -1))))
    # training-mode output: the training forward, state left alone
    out = net.output(np.concatenate(xs)[:4], train=True)
    assert out.shape == (4, 10) and np.all(np.isfinite(out))


def test_what_later_slices_bring_raises():
    """The resilience policy and the listeners raise, naming their slice;
    the training modes an earlier slice refused (on-device epochs,
    accumulation, a solver, remat, bfloat16) run."""
    net = lenet(device="cpu")
    x, y = _batch(4, 2)
    with pytest.raises(NotImplementedError, match="resilience"):
        net.fit(DataSet(x, y), resilience=object())
    with pytest.raises(NotImplementedError, match="listeners"):
        net.set_listeners(object())
    losses = net.fit_on_device(x, y)
    assert losses.shape == (1,) and np.isfinite(losses).all()
    net._build_train_step(accum_steps=2)(
        net._tensor(x), net._tensor(y), None, None)
    for field, value, match in (("optimization_algo", "LBFGS", "solver"),
                                ("workspace_mode", "full", "workspace"),
                                ("dtype", "BFLOAT16", "mixed precision")):
        conf = lenet_config()
        setattr(conf, field, value)
        trained = MultiLayerNetwork(conf).init(device="cpu").fit(
            DataSet(x, y))
        assert np.isfinite(trained.score()), match


# --------------------------------------------------------------- dropout

def test_dropout_by_distribution():
    rate, n = 0.3, 200_000
    x = torch.ones(n)
    gen = torch.Generator().manual_seed(11)
    y = nnops.dropout(x, rate, gen)
    kept = y != 0
    share, keep = float(kept.float().mean()), 1.0 - rate
    sigma = (keep * rate / n) ** 0.5
    assert abs(share - keep) <= 5 * sigma, (share, keep, sigma)
    assert torch.all(y[kept] == 1.0 / keep)
    again = nnops.dropout(x, rate, torch.Generator().manual_seed(11))
    assert torch.equal(y, again)
    assert nnops.dropout(x, 0.0, gen) is x
    assert nnops.dropout(x, rate, gen, deterministic=True) is x
    layer = DropoutLayer(rate=rate)
    assert layer.apply({}, x, {}, train=False, rng=gen)[0] is x
    assert layer.apply({}, x, {}, train=True, rng=None)[0] is x
    assert not torch.equal(layer.apply({}, x, {}, train=True, rng=gen)[0], x)


def test_dropout_in_a_network_trains_and_serves():
    """A Dense -> Dropout -> Output net: the dropout layer round-trips the
    JAX configuration, drops in training only, and a seeded model repeats
    its training step."""
    from deeplearning4j_tpu_torch.nn.layers.core import DenseLayer, \
        OutputLayer
    from deeplearning4j_tpu_torch.nn.updaters import Adam

    def make():
        return MultiLayerNetwork(
            config.NeuralNetConfiguration.builder().seed(4)
            .updater(Adam(learning_rate=1e-2))
            .input_type(config.InputType.feed_forward(12))
            .list(DenseLayer(n_out=64, activation="relu"),
                  DropoutLayer(rate=0.5), OutputLayer(n_out=3))
            .build()).init(device="cpu")
    from deeplearning4j_tpu.nn.config import MultiLayerConfiguration as JC
    net = make()
    assert JC.from_json(net.conf.to_json()).layers[1].kind == "dropout"
    rng = np.random.default_rng(0)
    x = rng.normal(size=(16, 12)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 16)]
    np.testing.assert_array_equal(net.output(x), net.output(x))
    assert not np.array_equal(net.output(x, train=True),
                              net.output(x, train=True))
    # two fresh nets of one seed take the same masks, hence the same steps
    net, other = make(), make()
    net.fit(DataSet(x, y), epochs=3)
    other.fit(DataSet(x, y), epochs=3)
    assert net.score() == other.score()


# ----------------------------------------------- numpy-only copies vs JAX

def test_synthetic_renderer_and_iterator_bit_for_bit():
    imgs, labels = mnist._render_synthetic(64, 6)
    jimgs, jlabels = jmnist._render_synthetic(64, 6)
    np.testing.assert_array_equal(imgs, jimgs)
    np.testing.assert_array_equal(labels, jlabels)
    it = mnist.MnistDataSetIterator(32, num_examples=96, seed=3)
    jit_ = jmnist.MnistDataSetIterator(32, num_examples=96, seed=3)
    assert it.source == jit_.source == "synthetic"
    for _ in range(2):  # two epochs: the per-epoch shuffle too
        for a, b in zip(it, jit_):
            np.testing.assert_array_equal(a.features, b.features)
            np.testing.assert_array_equal(a.labels, b.labels)
    test, jtest = (m.MnistDataSetIterator(50, train=False, num_examples=50)
                   for m in (mnist, jmnist))
    np.testing.assert_array_equal(next(iter(test)).features,
                                  next(iter(jtest)).features)


def test_evaluation_matches_jax():
    rng = np.random.default_rng(7)
    labels = np.eye(10, dtype=np.float32)[rng.integers(0, 10, 300)]
    preds = rng.random((300, 10)).astype(np.float32)
    mask = rng.random(300) > 0.1
    ev = evaluation.Evaluation().eval(labels[:150], preds[:150])
    ev.eval(labels[150:], preds[150:], mask=mask[150:])
    jev = jeval.Evaluation().eval(labels[:150], preds[:150])
    jev.eval(labels[150:], preds[150:], mask=mask[150:])
    np.testing.assert_array_equal(ev.confusion, jev.confusion)
    for m in ("accuracy", "precision", "recall", "f1"):
        assert getattr(ev, m)() == getattr(jev, m)(), m
    assert ev.precision(3) == jev.precision(3)
    assert ev.stats() == jev.stats()
    # integer labels and predictions
    ints = rng.integers(0, 4, 50)
    assert evaluation.Evaluation().eval(ints, ints[::-1]).accuracy() == \
        jeval.Evaluation().eval(ints, ints[::-1]).accuracy()
    lab = rng.normal(size=(40, 3))
    pr = lab + rng.normal(scale=0.3, size=(40, 3))
    rv = evaluation.RegressionEvaluation().eval(lab, pr)
    jrv = jeval.RegressionEvaluation().eval(lab, pr)
    for m in ("mse", "mae", "rmse", "r2", "pearson"):
        assert getattr(rv, m)() == getattr(jrv, m)(), m
    assert rv.stats() == jrv.stats()


def test_normalizers_match_jax():
    rng = np.random.default_rng(8)
    f = rng.normal(2.0, 3.0, size=(64, 2, 5, 5)).astype(np.float32) * 40
    y = np.zeros((64, 1), np.float32)
    cases = ((norm.NormalizerStandardize(), jnorm.NormalizerStandardize()),
             (norm.NormalizerMinMaxScaler(-1, 1),
              jnorm.NormalizerMinMaxScaler(-1, 1)),
             (norm.ImagePreProcessingScaler(),
              jnorm.ImagePreProcessingScaler()))
    for ours, theirs in cases:
        ours.fit(NumpyDataSetIterator(f, y, batch_size=16))
        theirs.fit(JDataSet(f, y))
        a = ours.transform(DataSet(f, y)).features
        b = theirs.transform(JDataSet(f, y)).features
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(ours.revert_features(a), f, rtol=1e-4,
                                   atol=1e-3)
        again = norm.Normalizer.from_state(
            json.loads(json.dumps(ours.to_state())))
        np.testing.assert_array_equal(again.transform(DataSet(f, y)).features,
                                      a)
    # as an iterator's preprocessor
    it = NumpyDataSetIterator(f, y, batch_size=32).set_pre_processor(
        norm.ImagePreProcessingScaler())
    np.testing.assert_allclose(next(iter(it)).features, f[:32] / 255.0,
                               rtol=1e-6)
