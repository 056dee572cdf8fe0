"""Sequential models of the zoo.

Port of the ``deeplearning4j_tpu/models/zoo.py`` entries whose layers the
port has: ``text_generation_lstm``. The others wait for their layers
(``ROADMAP.md`` Queue 1).
"""

from __future__ import annotations

from typing import Optional

from ..nn.config import InputType, NeuralNetConfiguration
from ..nn.layers.recurrent import LSTM, RnnOutputLayer
from ..nn.model import MultiLayerNetwork
from ..nn.updaters import Adam


def _builder(seed, updater):
    return (NeuralNetConfiguration.builder().seed(seed)
            .updater(updater or Adam(learning_rate=1e-3)))


def text_generation_lstm(vocab_size: int = 77, embedding: Optional[int] = None,
                         units: int = 256, timesteps: Optional[int] = None,
                         seed: int = 42, updater=None) -> MultiLayerNetwork:
    """TextGenerationLSTM (zoo ``TextGenerationLSTM.java``: stacked LSTM
    char model with per-timestep softmax): one-hot ``[T, vocab]`` input,
    two ``LSTM(units)`` and an ``RnnOutputLayer(vocab)``. The
    ``embedding`` front (an ``EmbeddingSequenceLayer``) is not in the
    port yet and raises."""
    if embedding:
        raise NotImplementedError(
            "text_generation_lstm(embedding=...) needs the "
            "EmbeddingSequenceLayer, which is not ported yet (ROADMAP.md "
            "Queue 1)")
    conf = (_builder(seed, updater)
            .input_type(InputType.recurrent(vocab_size, timesteps))
            .list(LSTM(n_out=units), LSTM(n_out=units),
                  RnnOutputLayer(n_out=vocab_size))
            .build())
    return MultiLayerNetwork(conf)
