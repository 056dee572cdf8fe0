"""Sequential models of the zoo.

Port of the ``deeplearning4j_tpu/models/zoo.py`` entries whose layers the
port has: ``text_generation_lstm`` (:194-209), with its
``EmbeddingSequenceLayer`` front. The zoo's other sequential models wait
for their layers (``ROADMAP.md`` Queue 1 item 10).
"""

from __future__ import annotations

from typing import Optional

from ..nn.config import InputType, NeuralNetConfiguration
from ..nn.layers.recurrent import LSTM, RnnOutputLayer
from ..nn.layers.special import EmbeddingSequenceLayer
from ..nn.model import MultiLayerNetwork
from ..nn.updaters import Adam


def _builder(seed, updater):
    return (NeuralNetConfiguration.builder().seed(seed)
            .updater(updater or Adam(learning_rate=1e-3)))


def text_generation_lstm(vocab_size: int = 77, embedding: Optional[int] = None,
                         units: int = 256, timesteps: Optional[int] = None,
                         seed: int = 42, updater=None) -> MultiLayerNetwork:
    """TextGenerationLSTM (zoo ``TextGenerationLSTM.java``: stacked LSTM
    char model with per-timestep softmax): two ``LSTM(units)`` and an
    ``RnnOutputLayer(vocab)`` over one-hot ``[T, vocab]`` input, or, with
    ``embedding``, over ``[T, 1]`` character ids through an
    ``EmbeddingSequenceLayer(vocab, embedding)``."""
    layers = []
    if embedding:
        layers.append(EmbeddingSequenceLayer(n_in=vocab_size,
                                             n_out=embedding))
        in_type = InputType.recurrent(1, timesteps)
    else:
        in_type = InputType.recurrent(vocab_size, timesteps)
    layers += [LSTM(n_out=units), LSTM(n_out=units),
               RnnOutputLayer(n_out=vocab_size)]
    conf = (_builder(seed, updater).input_type(in_type)
            .list(*layers).build())
    return MultiLayerNetwork(conf)
