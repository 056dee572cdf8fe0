"""The port's updaters, schedules, gradient normalization and constraints
against the JAX package's, on shared numpy trees.

Tolerances: updaters rtol 1e-4, atol 5e-6 (1e-4 of a step: the learning
rates are 0.05 and the params of order 1). Both sides run the same
float32 elementwise arithmetic in the same order with float32 scalar
coefficients, but the bias corrections ``1 - beta**t`` cancel: near t = 1
one ulp of ``beta**t`` (XLA's pow and numpy's differ by one) is 6e-5 of
the difference, so the Adam family may differ by that much; a schedule's
learning rate is also computed in float64 and rounded once in the port,
in float32 in the JAX package. Schedules rtol 1e-6 on the float32-rounded
value; the norms of gradient normalization and the constraints rtol 1e-5
(float32 sums in another order)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn import constraints as jcons
from deeplearning4j_tpu.nn import gradnorm as jgn
from deeplearning4j_tpu.nn import schedules as jsched
from deeplearning4j_tpu.nn import updaters as jupd
from deeplearning4j_tpu_torch.nn import constraints as cons
from deeplearning4j_tpu_torch.nn import gradnorm as gn
from deeplearning4j_tpu_torch.nn import schedules as sched
from deeplearning4j_tpu_torch.nn import updaters as upd


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


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"conv": {"W": (rng.standard_normal((4, 3, 3, 3)) * scale
                           ).astype(np.float32),
                     "b": (rng.standard_normal(4) * scale).astype(np.float32)},
            "fc": {"W": (rng.standard_normal((6, 5)) * scale
                         ).astype(np.float32),
                   "b": (rng.standard_normal(5) * scale).astype(np.float32)}}


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _t(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _assert_tree(got, want, rtol=1e-4, atol=5e-6):
    want = jax.tree.map(np.asarray, want)
    got = jax.tree.map(lambda t: t.numpy(), got)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)


UPDATERS = {
    "sgd": {}, "nesterovs": {"momentum": 0.8}, "adagrad": {},
    "rmsprop": {"decay": 0.9}, "adadelta": {}, "adam": {},
    "adamax": {}, "amsgrad": {}, "nadam": {}, "noop": {},
}


def _schedule_pair(kind):
    if kind == "fixed":
        return 0.05, 0.05
    if kind == "exponential":
        return (jsched.ExponentialSchedule(initial_value=0.05, gamma=0.9),
                sched.ExponentialSchedule(initial_value=0.05, gamma=0.9))
    return (jsched.StepSchedule(initial_value=0.05, decay_rate=0.5, step=1),
            sched.StepSchedule(initial_value=0.05, decay_rate=0.5, step=1))


@pytest.mark.parametrize("lr", ["fixed", "exponential", "step"])
@pytest.mark.parametrize("name", sorted(UPDATERS))
def test_updater_steps_match_jax(name, lr):
    """Three steps from zero state (bias corrections at t = 1, 2, 3, and a
    learning-rate schedule), param and state trees compared each step."""
    jlr, plr = _schedule_pair(lr)
    ju = jupd.UPDATERS[name](learning_rate=jlr, **UPDATERS[name])
    pu = upd.UPDATERS[name](learning_rate=plr, **UPDATERS[name])
    params = _tree(1)
    jp, pp = _j(params), _t(params)
    js, ps = ju.init_state(jp), pu.init_state(pp)
    _assert_tree(ps, js)
    for step in range(3):
        g = _tree(10 + step, scale=0.1)
        jp, js = jupd.apply_leafwise(ju, _j(g), js, jp, jnp.int32(step))
        pp, ps = upd.apply_leafwise(pu, _t(g), ps, pp, step)
        _assert_tree(pp, jp)
        _assert_tree(ps, js)


def test_apply_leaf_matches_the_tree_form():
    u = upd.Adam(learning_rate=0.01)
    p, g = _t(_tree(2)), _t(_tree(3, 0.1))
    s = u.init_state(p)
    tree_p, tree_s = upd.apply_leafwise(u, g, s, p, 4)
    leaf_p, leaf_s = upd.apply_leaf(
        u, g["fc"]["W"], {k: v["fc"]["W"] for k, v in s.items()},
        p["fc"]["W"], 4)
    assert torch.equal(leaf_p, tree_p["fc"]["W"])
    assert torch.equal(leaf_s["m"], tree_s["m"]["fc"]["W"])


@pytest.mark.parametrize("name", sorted(UPDATERS))
def test_updater_json_matches_jax(name):
    j = jupd.UPDATERS[name](learning_rate=jsched.ExponentialSchedule(
        initial_value=0.1, gamma=0.5), **UPDATERS[name])
    p = upd.UPDATERS[name](learning_rate=sched.ExponentialSchedule(
        initial_value=0.1, gamma=0.5), **UPDATERS[name])
    assert json.dumps(p.to_dict()) == json.dumps(j.to_dict())
    back = upd.Updater.from_dict(j.to_dict())
    assert type(back) is type(p) and back.to_dict() == p.to_dict()
    assert jupd.Updater.from_dict(p.to_dict()).to_dict() == j.to_dict()
    assert upd.get(name).kind == name
    with pytest.raises(ValueError, match="Unknown updater"):
        upd.get("lbfgs")


SCHEDULES = [
    ("fixed", {"value": 0.3}),
    ("exponential", {"initial_value": 0.1, "gamma": 0.9}),
    ("inverse", {"initial_value": 0.1, "gamma": 0.5, "power": 2.0}),
    ("poly", {"initial_value": 0.1, "power": 2.0, "max_iter": 10}),
    ("sigmoid", {"initial_value": 0.1, "gamma": 0.5, "step_size": 4}),
    ("step", {"initial_value": 0.1, "decay_rate": 0.5, "step": 3.0}),
    ("cosine", {"initial_value": 0.1, "min_value": 0.01, "max_iter": 10}),
    ("warmup_linear", {"peak_value": 0.1, "warmup_iters": 3,
                       "max_iter": 10}),
    ("map", {"values": {0: 0.1, 3: 0.05, 7: 0.01}}),
]


@pytest.mark.parametrize("kind,kw", SCHEDULES, ids=[k for k, _ in SCHEDULES])
def test_schedule_values_match_jax(kind, kw):
    j = jsched._SCHEDULES[kind](**kw)
    p = sched._SCHEDULES[kind](**kw)
    for it in (0, 1, 2, 3, 5, 7, 10, 12):
        want = float(np.float32(j.value_at(jnp.int32(it))))
        assert abs(float(np.float32(p.value_at(it))) - want) \
            <= 1e-6 * abs(want) + 1e-9
    assert p.to_dict() == j.to_dict()
    assert sched.Schedule.from_dict(j.to_dict()) == p
    assert sched.resolve(0.5).value_at(3) == 0.5


@pytest.mark.parametrize("clip_l2", [None, 0.5])
@pytest.mark.parametrize("clip_value", [None, 0.05])
@pytest.mark.parametrize("mode", [None] + list(jgn.MODES))
def test_clip_with_events_matches_jax(mode, clip_value, clip_l2):
    g = _tree(4, scale=0.2)
    jg, jev = jgn.clip_with_events(mode, 0.3, clip_value, clip_l2, _j(g))
    pg, pev = gn.clip_with_events(mode, 0.3, clip_value, clip_l2, _t(g))
    _assert_tree(pg, jg, rtol=1e-5, atol=1e-8)
    assert pev.dtype == torch.int32 and int(pev) == int(jev)


def test_clip_events_count_only_engaged_clips():
    small = _tree(5, scale=1e-4)
    for mode in ("ClipL2PerLayer", "ClipL2PerParamType",
                 "ClipElementWiseAbsoluteValue"):
        assert int(gn.clip_engaged(mode, 10.0, _t(small))) == 0
        assert int(gn.clip_engaged(mode, 1e-9, _t(small))) == 1
    assert int(gn.clip_engaged("RenormalizeL2PerLayer", 1e-9,
                               _t(small))) == 0
    with pytest.raises(ValueError, match="unknown GradientNormalization"):
        gn.validate("ClipEverything")


CONSTRAINTS = [("max_norm", {"max_norm": 0.8}),
               ("min_max_norm", {"min_norm": 0.5, "max_norm": 0.9,
                                 "rate": 0.7}),
               ("unit_norm", {}), ("non_negative", {})]


@pytest.mark.parametrize("scope", ["weights", "bias", "all"])
@pytest.mark.parametrize("kind,kw", CONSTRAINTS,
                         ids=[k for k, _ in CONSTRAINTS])
def test_constraints_match_jax(kind, kw, scope):
    params = _tree(6)
    jc = [(jcons.CONSTRAINTS[kind](**kw), scope)]
    pc = [(cons.CONSTRAINTS[kind](**kw), scope)]
    want = jcons.apply_constraints(jc, _j(params), skip=("fc",))
    got = cons.apply_constraints(pc, _t(params), skip=("fc",))
    _assert_tree(got, want, rtol=1e-5, atol=1e-7)
    np.testing.assert_array_equal(got["fc"]["W"].numpy(), params["fc"]["W"])
    assert cons.encode_constraints(pc) == jcons.encode_constraints(jc)
    back = cons.decode_constraints(jcons.encode_constraints(jc))
    assert cons.encode_constraints(back) == cons.encode_constraints(pc)
