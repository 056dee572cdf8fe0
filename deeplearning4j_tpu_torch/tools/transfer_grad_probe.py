"""How ``chip_smoke.py``'s [transfer] gradient gate reads across trained
weights and batches, on one CUDA card.

    python3 -m deeplearning4j_tpu_torch.tools.transfer_grad_probe [FITS]

[train]'s fit as ``chip_smoke.py`` runs it (ResNet-50 seed 0, Adam(1e-3),
float32, TF32 off, one fixed batch of 32 drawn as [train] draws it, its
12 timed steps and the profiler's 4) is repeated FITS times (default 5)
from the same start. Each trained net goes through [transfer]'s
``TransferLearning.GraphBuilder`` and the float64 rule of [transfer]'s
gate (``chip_smoke.grad_ratios``: the card and the CPU float32 plain
path against the CPU float64 one) is read on [transfer]'s first batch
cut to 4 rows, on each of its first TRANSFER_GRAD_BATCHES batches of 32
alone, and on those batches together, as the gate reads it. One line
``[transfer-grad]`` and a JSON object per fit: each reading's worst
card/allowed ratio, the pooled reading's worst leaf with its card and
CPU float32 errors, and the largest absolute difference of the fit's
trained parameters from the first fit's. The card's name and power
limit come first, as ``nvidia-smi`` gives them. Run from the repository
root (it imports ``chip_smoke``).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import torch

#: [train]'s steps before [transfer] takes its net: 12 timed, then one
#: that starts the profiler and 3 profiled
TRAIN_FIT_STEPS = 16


def trained_resnet(cs, models):
    """A ResNet-50 through [train]'s fit: the same seed, batch and steps."""
    net = models.resnet50(seed=0).init(device="cuda")
    rng = np.random.default_rng(2)
    cs._batch(rng, cs.PARITY_BATCH)  # [train]'s parity batch comes first
    x, y = cs._batch(rng, cs.TRAIN_BATCH)
    for _ in range(TRAIN_FIT_STEPS):
        net.fit(x, y)
    torch.cuda.synchronize()
    return net


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    fits = int(argv[0]) if argv else 5
    if not torch.cuda.is_available():
        print("transfer_grad_probe: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from deeplearning4j_tpu_torch import environment as env
    from deeplearning4j_tpu_torch import models
    from deeplearning4j_tpu_torch.nn import graph
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip(), flush=True)
    env.Environment.instance().f32_matmul_precision = "highest"
    first = None
    batches = cs.transfer_batches()[:cs.TRANSFER_GRAD_BATCHES]
    for fit in range(fits):
        net = trained_resnet(cs, models)
        params = {f"{v}/{k}": t.detach().cpu()
                  for v, p in net.params.items() for k, t in p.items()}
        if first is None:
            first = params
        drift = max(float((t - first[n]).abs().max())
                    for n, t in params.items())
        new = cs.transfer_graph(net)
        twins = (new, cs.cpu_twin(graph, new),
                 cs.cpu_twin(graph, new, "DOUBLE", lambda t: t.double()))

        def grads(x, y):
            return [cs.graph_loss_grads(env, m, x, y)[1] for m in twins]

        small = cs.grad_ratios(*([g] for g in grads(
            batches[0].features[:4], batches[0].labels[:4])), new._frozen)
        per_batch = [grads(b.features, b.labels) for b in batches]
        alone = [cs.grad_ratios(*([g] for g in gs), new._frozen)[0][0]
                 for gs in per_batch]
        pooled = cs.grad_ratios(*(list(g) for g in zip(*per_batch)),
                                new._frozen)[0]
        print("[transfer-grad] " + json.dumps({
            "fit": fit, "batch4_first": small[0][0],
            "batch32_alone": alone, "batch32_pooled": pooled[0],
            "pooled_worst_leaf": pooled[1],
            "pooled_card_err": pooled[2], "pooled_cpu_f32_err": pooled[3],
            "trained_params_max_abs_diff_from_fit_0": drift}), flush=True)
        del net, new, twins, per_batch
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
