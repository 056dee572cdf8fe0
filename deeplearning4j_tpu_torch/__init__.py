"""deeplearning4j_tpu_torch: the PyTorch/CUDA port of ``deeplearning4j_tpu``.

The JAX package beside this one is the reference; this package mirrors its
module layout (``nn/graph.py``, ``ops/fused_epilogues.py``, ...) so every
port module has an obvious counterpart. It imports ``torch`` and numpy and
nothing of JAX or of the JAX package.

Entry points (``ComputationGraph.init``, ``fit`` on an uninitialized
net, ``load_model``, the serving fronts, ``SameDiff`` and its loaders,
the BERT builders) run on ``cuda`` unless the caller passes
``device="cpu"``; without a CUDA device and without that explicit
request they raise.

Every TPU kernel on a ported path is a hand-written Hopper kernel under
``csrc/`` with its plain PyTorch version beside its wrapper in
``kernels/``. The ported paths serve ResNet through
``ComputationGraph.output``, train it through ``ComputationGraph.fit``,
and serve BERT-base as a SameDiff graph through ``SameDiff.output``;
their kernels are the BN-affine + activation epilogue (K1) and its
backward (K2), in ``kernels/affine_act.py``, and the flash-attention
forward (K3), in ``kernels/flash_attention.py``.
"""

__version__ = "0.1.0"
