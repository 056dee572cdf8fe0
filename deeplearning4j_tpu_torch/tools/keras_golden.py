"""The Keras-imported golden replay in the port: ``keras_smoke.h5``
imported, then STEPS ``Sgd(0.05)`` steps of batch BATCH drawn from
``default_rng(20260733)``, summarised as ``tests/fixtures/
keras_imported_golden.json`` records it (the losses; each parameter's
mean, std and first five values, keyed ``['<layer>']/['<name>']``).

    net = golden_net(device="cpu")
    snap = replay(net)
    band_share(snap, golden)   # <= 1 inside the record's bands

The record's own harness, ``tests/golden_harness.py``, makes the file
from the reference package; this module imports none of it.
"""

from __future__ import annotations

import os

import numpy as np

FIXTURES = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "tests", "fixtures")
GOLDEN = os.path.join(FIXTURES, "keras_imported_golden.json")
STEPS = 8
BATCH = 16
SEED = 20260733
LEARNING_RATE = 0.05
#: the record's tolerance bands (``golden_harness.compare``'s defaults)
RTOL, ATOL = 1e-3, 1e-5


def golden_net(device=None):
    """``keras_smoke.h5`` imported on ``device`` (``cuda`` unless the
    caller asks for ``cpu``) with the replay's Sgd updater."""
    from ..modelimport import KerasModelImport
    from ..nn.updaters import Sgd
    net = KerasModelImport.import_keras_model_and_weights(
        os.path.join(FIXTURES, "keras_smoke.h5"), device=device)
    net.conf.updater = Sgd(learning_rate=LEARNING_RATE)
    net.updater_state = net.conf.updater.init_state(net.params)
    return net


def snapshot(net, losses) -> dict:
    """The record's summary of ``net`` after the steps that gave
    ``losses``."""
    params = {}
    for k in sorted(net.params, key=int):
        for name in sorted(net.params[k]):
            a = net.params[k][name].detach().double().cpu().numpy().ravel()
            params[f"['{k}']/['{name}']"] = {
                "mean": float(a.mean()), "std": float(a.std()),
                "head": [float(v) for v in a[:5]]}
    return {"steps": len(losses), "batch": BATCH, "losses": losses,
            "params": params}


def replay(net, on_step=None) -> dict:
    """Train ``net`` the record's STEPS steps and return its snapshot;
    ``on_step()`` is called after each step."""
    from ..data.dataset import DataSet
    rng = np.random.default_rng(SEED)
    batches = []
    for _ in range(STEPS):
        x = rng.normal(size=(BATCH, 8, 8, 3)).astype(np.float32)
        y = np.eye(5, dtype=np.float32)[rng.integers(0, 5, BATCH)]
        batches.append(DataSet(x, y))
    losses = []
    for ds in batches:
        net.fit(ds, epochs=1)
        losses.append(float(net.score()))
        if on_step is not None:
            on_step()
    return snapshot(net, losses)


def band_share(snap: dict, golden: dict) -> float:
    """The largest ``|got - want| / (ATOL + RTOL |want|)`` over the losses
    and every parameter summary: at most 1 inside the record's bands.
    Raises ValueError when the parameter keys differ."""
    if snap["params"].keys() != golden["params"].keys() or \
            len(snap["losses"]) != len(golden["losses"]):
        raise ValueError("the parameter tree or the loss curve's length "
                         "differs from the record's")
    pairs = list(zip(snap["losses"], golden["losses"]))
    for key, g in golden["params"].items():
        s = snap["params"][key]
        pairs += zip([s["mean"], s["std"]] + s["head"],
                     [g["mean"], g["std"]] + g["head"])
    return max(abs(a - b) / (ATOL + RTOL * abs(b)) for a, b in pairs)
