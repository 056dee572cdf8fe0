"""Special layers: EmbeddingSequenceLayer.

Port of ``EmbeddingSequenceLayer`` from
``deeplearning4j_tpu/nn/layers/special.py`` (:356), with the same JSON
kind (``embedding_sequence``), fields and parameter (``W`` ``[nIn,
nOut]``). The module's other layers (the YOLO head, LayerNormalization,
the CNN and 3-D losses, capsules, ...) come with the slices that need them
(``ROADMAP.md`` Queue 1).
"""

from __future__ import annotations

from typing import Optional

from ...ops import nnops
from .. import weights as _winit
from .base import Layer, layer


@layer("embedding_sequence")
class EmbeddingSequenceLayer(Layer):
    """DL4J EmbeddingSequenceLayer: ``[B, T]`` integer ids (or the ``[B, T,
    1]`` column form a recurrent input type of width 1 gives) to ``[B, T,
    nOut]``, through ``nnops.embedding_lookup``. Float ids truncate to
    int."""
    n_in: int = 0
    n_out: int = 0
    weight_init: str = "xavier"
    name: Optional[str] = None

    def initialize(self, gen, input_shape, dtype, device):
        w = _winit.init(self.weight_init, gen, (self.n_in, self.n_out),
                        self.n_in, self.n_out, dtype, device)
        t = int(input_shape[0]) if input_shape else -1
        return {"W": w}, {}, (t, self.n_out)

    def apply(self, params, x, state, *, train=False, mask=None):
        ids = x[..., 0] if x.dim() == 3 and x.shape[-1] == 1 else x
        return nnops.embedding_lookup(params["W"], ids), state, mask
