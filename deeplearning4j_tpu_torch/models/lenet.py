"""LeNet (zoo ``LeNet.java``), the port's first MultiLayerNetwork to train.

Port of ``deeplearning4j_tpu/models/lenet.py``, layer for layer: conv 5x5
(20, ReLU) -> max pool 2 -> conv 5x5 (50, ReLU) -> max pool 2 -> dense
500 (ReLU) -> softmax output (mcxent), with ``Adam(1e-3)`` and ``l2(5e-5)``;
``build()`` puts a ``FlattenLayer`` at the convolution -> dense seam (layer
4). ``data_format`` is NCHW by default (DL4J's), "NHWC" otherwise. Each
convolution ends in the K1 epilogue (``bias_act``), so a training step on
the card runs two K1 and two K2 launches.
"""

from __future__ import annotations

from ..nn.config import InputType, NeuralNetConfiguration
from ..nn.layers.conv import ConvolutionLayer, SubsamplingLayer
from ..nn.layers.core import DenseLayer, OutputLayer
from ..nn.model import MultiLayerNetwork
from ..nn.updaters import Adam


def lenet_config(num_classes: int = 10, in_channels: int = 1, height: int = 28,
                 width: int = 28, seed: int = 123, updater=None,
                 data_format: str = "NCHW"):
    return (NeuralNetConfiguration.builder()
            .seed(seed)
            .updater(updater or Adam(learning_rate=1e-3))
            .l2(5e-5)
            .input_type(InputType.convolutional(in_channels, height, width,
                                                data_format))
            .list(
                ConvolutionLayer(n_out=20, kernel=(5, 5), stride=(1, 1),
                                 padding=(2, 2), activation="relu",
                                 weight_init="relu", data_format=data_format),
                SubsamplingLayer(kernel=(2, 2), stride=(2, 2),
                                 pool_type="max", data_format=data_format),
                ConvolutionLayer(n_out=50, kernel=(5, 5), stride=(1, 1),
                                 padding=(2, 2), activation="relu",
                                 weight_init="relu", data_format=data_format),
                SubsamplingLayer(kernel=(2, 2), stride=(2, 2),
                                 pool_type="max", data_format=data_format),
                DenseLayer(n_out=500, activation="relu", weight_init="relu"),
                OutputLayer(n_out=num_classes, loss="mcxent",
                            activation="softmax", weight_init="xavier"),
            )
            .build())


def lenet(num_classes: int = 10, device=None, **kwargs) -> MultiLayerNetwork:
    """LeNet initialized from its seed on ``device`` (``cuda`` unless the
    caller asks for ``cpu``; raises without CUDA)."""
    return MultiLayerNetwork(lenet_config(num_classes, **kwargs)).init(device)
