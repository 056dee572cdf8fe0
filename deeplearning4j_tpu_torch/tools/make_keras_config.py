"""The Keras ResNet-50 the Keras import is driven with at full width:
its configuration, ``tests/fixtures/keras_resnet50_config.json``, and
seeded weights in Keras layout.

    python3 -m deeplearning4j_tpu_torch.tools.make_keras_config [OUT]

writes the configuration: ``keras.applications.ResNet50(weights=None)
.to_json()`` (no download: ``weights=None`` builds the architecture
only) to OUT (default the fixture path). That needs Keras, which the port
itself never imports; the committed file came from Keras 3.13.1 (177
layers, 25,583,592 trainable parameters).

:func:`config` reads the committed file (its input optionally cut to
``hw`` x ``hw``), :func:`seeded_weights` draws a ``{layer name: [arrays]}``
dict in Keras layout (Conv2D kernel HWIO and bias; BatchNormalization
gamma, beta, moving_mean, moving_variance; Dense kernel [in, out] and
bias) from a numpy seed, and :func:`import_resnet50` imports the
configuration with those weights through the importer's own weight path
(``_h5_weights`` takes the dict as it takes an open ``.h5``).
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

CONFIG = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "tests", "fixtures",
    "keras_resnet50_config.json")


def config(hw=None) -> dict:
    """The committed Keras ResNet-50 configuration, its input cut to
    ``hw`` x ``hw`` when given (the layers' widths are unchanged)."""
    with open(CONFIG) as f:
        cfg = json.load(f)
    if hw is not None:
        for lcfg in cfg["config"]["layers"]:
            if lcfg["class_name"] == "InputLayer":
                lcfg["config"]["batch_shape"] = [None, hw, hw, 3]
    return cfg


def seeded_weights(cfg: dict, seed: int = 0) -> dict:
    """Keras-layout weights for every Conv2D, BatchNormalization and Dense
    layer of ``cfg``, drawn in layer order from ``default_rng(seed)``:
    He-normal kernels, biases N(0, 0.01), gamma U(0.2, 0.6), beta
    N(0, 0.05), moving means N(0, 0.1) and variances U(0.5, 1.5)."""
    rng = np.random.default_rng(seed)
    channels = {}
    out = {}
    f32 = np.float32
    for lcfg in cfg["config"]["layers"]:
        cls, c = lcfg["class_name"], lcfg["config"]
        name = c["name"]
        if cls == "InputLayer":
            shape = c.get("batch_shape") or c.get("batch_input_shape")
            channels[name] = int(shape[-1])
            continue
        parents = [n["args"][0] for n in lcfg["inbound_nodes"]]
        first = parents[0][0] if isinstance(parents[0], list) \
            else parents[0]
        cin = channels[first["config"]["keras_history"][0]]
        if cls == "Conv2D":
            kh, kw = c["kernel_size"]
            n = int(c["filters"])
            k = rng.standard_normal((kh, kw, cin, n), dtype=f32) * f32(
                np.sqrt(2.0 / (kh * kw * cin)))
            out[name] = [k, rng.normal(0, 0.01, n).astype(f32)]
            cin = n
        elif cls == "BatchNormalization":
            out[name] = [rng.uniform(0.2, 0.6, cin).astype(f32),
                         rng.normal(0, 0.05, cin).astype(f32),
                         rng.normal(0, 0.1, cin).astype(f32),
                         rng.uniform(0.5, 1.5, cin).astype(f32)]
        elif cls == "Dense":
            n = int(c["units"])
            k = rng.standard_normal((cin, n), dtype=f32) * f32(
                np.sqrt(1.0 / cin))
            out[name] = [k, rng.normal(0, 0.01, n).astype(f32)]
            cin = n
        channels[name] = cin
    return out


def import_resnet50(device=None, hw=None, seed: int = 0):
    """The Keras ResNet-50 imported with :func:`seeded_weights` on
    ``device`` (``cuda`` unless the caller asks for ``cpu``)."""
    from .. import environment as _env
    from ..modelimport import keras as _keras
    device = _env.resolve_device(device)
    cfg = config(hw)
    return _keras._import_model(cfg, seeded_weights(cfg, seed), device)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    out = argv[0] if argv else CONFIG
    import keras  # only here: the port never imports Keras
    model = keras.applications.ResNet50(weights=None)
    cfg = json.loads(model.to_json())
    cfg["keras_version"] = keras.__version__
    with open(out, "w") as f:
        json.dump(cfg, f)
        f.write("\n")
    print(f"{out}: {len(cfg['config']['layers'])} layers, "
          f"{int(sum(w.numpy().size for w in model.trainable_weights))} "
          f"trainable parameters, keras {keras.__version__}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
