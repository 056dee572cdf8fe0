"""Line-search solvers: BackTrackLineSearch, LBFGS, ConjugateGradient,
LineGradientDescent.

Port of ``deeplearning4j_tpu/optimize/solvers.py`` (DL4J's
``optimize/solvers`` stack). The solvers are host-side control loops over
one value-and-grad of the network loss on a flat parameter vector:
``params_flat``'s layout, kept on the model's device (``utils.tree.
ravel``). Each function evaluation is one training forward and
``torch.autograd.grad`` (the kernels and their backwards where the
forward runs them); the line search's Armijo test and the curvature
updates read scalars on the host, one sync an evaluation. DL4J runs its
solver per minibatch inside ``Solver.optimize``; ``MultiLayerNetwork.
fit`` routes here when the configuration says ``optimization_algo(
"LBFGS" | "CONJUGATE_GRADIENT" | "LINE_GRADIENT_DESCENT")``. The
ComputationGraph engine has no solver path, as in the JAX package.

Recorded divergences, as in the JAX package: BatchNorm running averages
are not refreshed by solver iterations (DL4J's computeGradientAndScore
refreshes them); CenterLossOutputLayer is unsupported under solvers;
dropout draws ONE mask per ``optimize()`` call (each evaluation replays
the model generator's state from the start of the call, so the line
search sees one deterministic objective), where the JAX package holds
one key per call: the masks differ from its, as everywhere in the port;
gradient clipping and normalization RAISE (clipped gradients would
poison the LBFGS curvature pairs), while weight constraints are projected
after each ``optimize()`` as on the SGD path.

The Armijo constants are the JAX package's. The solver branches on f32
loss comparisons, so the card and the CPU may take different branches
on near-ties; ``Solver.evaluations`` (the loss of every evaluation of
the last ``optimize()``) and each solver's ``history`` (the accepted loss
after every iteration) let a caller see where.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch


def _dot(a, b) -> float:
    return float(torch.dot(a, b))


class BackTrackLineSearch:
    """Armijo backtracking (DL4J BackTrackLineSearch: sufficient decrease
    with geometric step contraction; DL4J's default maxIterations=5)."""

    def __init__(self, max_iterations: int = 5, c1: float = 1e-4,
                 contraction: float = 0.5, initial_step: float = 1.0,
                 min_step: float = 1e-12):
        self.max_iterations = int(max_iterations)
        self.c1 = float(c1)
        self.contraction = float(contraction)
        self.initial_step = float(initial_step)
        self.min_step = float(min_step)

    def search(self, f: Callable, x: torch.Tensor, fx: float,
               g: torch.Tensor, direction: torch.Tensor,
               initial: Optional[float] = None):
        """-> (step, new_x, new_f, new_g); step 0.0 means no acceptable
        point was found (the caller falls back to the plain gradient).
        ``initial`` overrides the first trial step. When the first trial
        already satisfies Armijo, the step doubles while it keeps
        satisfying it (pure backtracking stalls nonlinear CG on
        anisotropic bowls)."""
        slope = _dot(g, direction)
        if slope >= 0:  # not a descent direction
            return 0.0, x, fx, g
        step = float(initial) if initial else self.initial_step

        def trial(s):
            x_n = x + s * direction
            f_n, g_n = f(x_n)
            return float(f_n), x_n, g_n

        f_new, x_new, g_new = trial(step)
        if np.isfinite(f_new) and f_new <= fx + self.c1 * step * slope:
            # expansion: accept the largest doubling that still satisfies
            for _ in range(self.max_iterations):
                f2, x2, g2 = trial(step * 2.0)
                if not (np.isfinite(f2)
                        and f2 <= fx + self.c1 * step * 2.0 * slope
                        and f2 < f_new):
                    break
                step *= 2.0
                f_new, x_new, g_new = f2, x2, g2
            return step, x_new, f_new, g_new
        # backtracking runs to min_step whatever max_iterations says: a
        # stiff direction may need a tiny step (~40 trials at worst)
        while True:
            step *= self.contraction
            if step < self.min_step:
                break
            f_new, x_new, g_new = trial(step)
            if np.isfinite(f_new) and f_new <= fx + self.c1 * step * slope:
                return step, x_new, f_new, g_new
        return 0.0, x, fx, g


class LBFGS:
    """Limited-memory BFGS, two-loop recursion (DL4J LBFGS; memory m=10,
    DL4J's default)."""

    def __init__(self, iterations: int = 5, memory: int = 10,
                 line_search: Optional[BackTrackLineSearch] = None,
                 tolerance: float = 1e-8):
        self.iterations = int(iterations)
        self.memory = int(memory)
        self.line_search = line_search or BackTrackLineSearch()
        self.tolerance = float(tolerance)
        self.history = []

    def minimize(self, f, x0) -> Tuple[torch.Tensor, float]:
        x = x0
        fx, g = f(x)
        fx = float(fx)
        self.history = []
        s_hist, y_hist, rho = [], [], []
        for _ in range(self.iterations):
            # two-loop recursion
            q = g
            alphas = []
            for s, y, r in zip(reversed(s_hist), reversed(y_hist),
                               reversed(rho)):
                a = r * _dot(s, q)
                alphas.append(a)
                q = q - a * y
            if y_hist:
                ys = _dot(s_hist[-1], y_hist[-1])
                yy = _dot(y_hist[-1], y_hist[-1])
                q = q * (ys / max(yy, 1e-20))
            for (s, y, r), a in zip(zip(s_hist, y_hist, rho),
                                    reversed(alphas)):
                b = r * _dot(y, q)
                q = q + (a - b) * s
            direction = -q
            step, x_new, f_new, g_new = self.line_search.search(
                f, x, fx, g, direction)
            if step == 0.0:
                # fall back to steepest descent once; stop if that fails too
                step, x_new, f_new, g_new = self.line_search.search(
                    f, x, fx, g, -g)
                if step == 0.0:
                    break
            s = x_new - x
            y = g_new - g
            sy = _dot(s, y)
            if sy > 1e-10:  # curvature condition: keep the pair
                s_hist.append(s)
                y_hist.append(y)
                rho.append(1.0 / sy)
                if len(s_hist) > self.memory:
                    s_hist.pop(0)
                    y_hist.pop(0)
                    rho.pop(0)
            done = abs(fx - f_new) < self.tolerance
            x, fx, g = x_new, f_new, g_new
            self.history.append(fx)
            if done:
                break
        return x, fx


class ConjugateGradient:
    """Nonlinear CG, Polak-Ribiere+ with automatic restart (DL4J
    ConjugateGradient)."""

    def __init__(self, iterations: int = 5,
                 line_search: Optional[BackTrackLineSearch] = None,
                 tolerance: float = 1e-8):
        self.iterations = int(iterations)
        self.line_search = line_search or BackTrackLineSearch()
        self.tolerance = float(tolerance)
        self.history = []

    def minimize(self, f, x0) -> Tuple[torch.Tensor, float]:
        x = x0
        fx, g = f(x)
        fx = float(fx)
        self.history = []
        d = -g
        prev_step = None
        for _ in range(self.iterations):
            step, x_new, f_new, g_new = self.line_search.search(
                f, x, fx, g, d, initial=prev_step)
            if step == 0.0:
                break
            prev_step = step
            gg = _dot(g, g)
            beta = max(0.0, _dot(g_new, g_new - g) / max(gg, 1e-20))
            d = -g_new + beta * d  # PR+ (restart on negative)
            done = abs(fx - f_new) < self.tolerance
            x, fx, g = x_new, f_new, g_new
            self.history.append(fx)
            if done:
                break
        return x, fx


class LineGradientDescent:
    """Steepest descent with line search (DL4J LineGradientDescent)."""

    def __init__(self, iterations: int = 5,
                 line_search: Optional[BackTrackLineSearch] = None):
        self.iterations = int(iterations)
        self.line_search = line_search or BackTrackLineSearch()
        self.history = []

    def minimize(self, f, x0) -> Tuple[torch.Tensor, float]:
        x = x0
        fx, g = f(x)
        fx = float(fx)
        self.history = []
        for _ in range(self.iterations):
            step, x, fx, g = self.line_search.search(f, x, fx, g, -g)
            if step == 0.0:
                break
            self.history.append(fx)
        return x, fx


_SOLVERS = {
    "LBFGS": LBFGS,
    "CONJUGATE_GRADIENT": ConjugateGradient,
    "LINE_GRADIENT_DESCENT": LineGradientDescent,
}


def get_solver(name: str, iterations: int = 5,
               max_line_search_iterations: int = 5):
    key = str(name).upper()
    if key not in _SOLVERS:
        raise ValueError(f"unknown optimization_algo {name!r}; known: "
                         f"SGD (default fit path) + {sorted(_SOLVERS)}")
    return _SOLVERS[key](
        iterations=iterations,
        line_search=BackTrackLineSearch(
            max_iterations=max_line_search_iterations))


class Solver:
    """DL4J ``Solver``: the flat value-and-grad of a model's loss and the
    configured algorithm, run per minibatch."""

    def __init__(self, model, algo: str, iterations: int = 5,
                 max_line_search_iterations: int = 5):
        conf = model.conf
        if (conf.gradient_normalization or conf.gradient_clip_value
                or conf.gradient_clip_l2):
            # clipped gradients would poison the LBFGS curvature pairs:
            # refuse rather than silently ignore the configuration
            raise ValueError(
                "gradient clipping/normalization is not supported with "
                f"optimization_algo({algo!r}); remove it or use SGD")
        if hasattr(model._out_layer, "update_centers"):
            # its features/centers plumbing is the SGD step's; bare
            # cross-entropy would be a different loss
            raise ValueError(
                "CenterLossOutputLayer is not supported with solver "
                "optimization_algo; use SGD")
        self.model = model
        self.opt = get_solver(algo, iterations, max_line_search_iterations)
        #: the loss of every function evaluation of the last optimize()
        self.evaluations = []

    def _objective(self, x, y, fm, lm, unravel):
        """``f(vec) -> (loss, grad)`` on this batch: the training forward
        at ``unravel(vec)``, the head's loss plus l1/l2, and its gradient
        as a vector of ``vec``'s layout. The model generator replays its
        state from the start of the call at every evaluation."""
        from ..environment import precision
        from ..nn import training as _training
        from ..ops import losses as _loss
        model = self.model
        head = model._out_layer
        rng = _training.generator(model)
        start = rng.get_state()

        def f(vec):
            vec = vec.detach().requires_grad_(True)
            params = unravel(vec)
            rng.set_state(start)
            with precision(model.device):
                out, _, out_mask = model._forward(
                    params, x, model.state, train=True, mask=fm, rng=rng)
                loss = head.loss_value(
                    out, y, mask=_loss.combine_masks(lm, out_mask),
                    weights=getattr(head, "loss_weights", None)) \
                    + model._regularization(params)
                g, = torch.autograd.grad(loss, vec)
            loss = loss.detach()
            self.evaluations.append(float(loss))
            return loss, g
        return f

    def optimize(self, x, y, fm=None, lm=None) -> float:
        """One DL4J ``Solver.optimize`` call: the algorithm's iterations on
        this batch, the result written back into the model (weight
        constraints projected after, FrozenLayers exempt). Returns the
        final loss."""
        from ..nn import constraints as _constraints
        from ..utils.tree import ravel
        model = self.model
        self.evaluations = []
        vec0, unravel = ravel(model.params, model._flat_keys())
        vec, fx = self.opt.minimize(
            self._objective(x, y, fm, lm, unravel), vec0)
        model.params = _constraints.apply_constraints(
            model.conf.constraints, unravel(vec.detach()),
            skip=model._frozen)
        return fx
