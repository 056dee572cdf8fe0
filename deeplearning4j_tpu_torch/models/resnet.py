"""ResNet family as ComputationGraph configs.

Port of ``deeplearning4j_tpu/models/resnet.py`` (DL4J zoo ResNet50): the
same vertex names, layer configs and JSON, so a net built here and one
built by the JAX package serialize identically. NHWC activations, OIHW
weights, He/ReLU weight init and BN decay 0.9, as in the JAX package.
"""

from __future__ import annotations

from typing import Tuple

from ..nn.config import InputType, NeuralNetConfiguration
from ..nn.graph import ComputationGraph, GraphBuilder
from ..nn.layers.conv import (BatchNormalization, ConvolutionLayer,
                              GlobalPoolingLayer, SubsamplingLayer)
from ..nn.layers.conv_extra import SpaceToDepthStemConv
from ..nn.layers.core import ActivationLayer, OutputLayer
from ..nn.updaters import Adam
from ..nn.vertices import ElementWiseVertex

# (block counts, bottleneck?) per standard depth
_SPECS = {
    18: ((2, 2, 2, 2), False),
    34: ((3, 4, 6, 3), False),
    50: ((3, 4, 6, 3), True),
    101: ((3, 4, 23, 3), True),
    152: ((3, 8, 36, 3), True),
}
_STAGE_CHANNELS = (64, 128, 256, 512)


def _conv_bn(g: GraphBuilder, name: str, inp: str, n_out: int, kernel,
             stride, padding=(0, 0), act: str = "identity") -> str:
    g.add_layer(f"{name}_conv",
                ConvolutionLayer(n_out=n_out, kernel=kernel, stride=stride,
                                 padding=padding, activation="identity",
                                 weight_init="relu", has_bias=False,
                                 data_format="NHWC"), inp)
    g.add_layer(f"{name}_bn", BatchNormalization(data_format="NHWC"),
                f"{name}_conv")
    if act != "identity":
        g.add_layer(f"{name}_act", ActivationLayer(activation=act),
                    f"{name}_bn")
        return f"{name}_act"
    return f"{name}_bn"


def _bottleneck(g: GraphBuilder, name: str, inp: str, channels: int,
                stride: int, project: bool) -> str:
    """1x1 -> 3x3 -> 1x1(x4) bottleneck with identity/projection shortcut."""
    out_ch = channels * 4
    a = _conv_bn(g, f"{name}_a", inp, channels, (1, 1), (stride, stride),
                 act="relu")
    b = _conv_bn(g, f"{name}_b", a, channels, (3, 3), (1, 1), (1, 1),
                 act="relu")
    c = _conv_bn(g, f"{name}_c", b, out_ch, (1, 1), (1, 1))
    if project:
        sc = _conv_bn(g, f"{name}_proj", inp, out_ch, (1, 1),
                      (stride, stride))
    else:
        sc = inp
    g.add_vertex(f"{name}_add", ElementWiseVertex(op="add"), c, sc)
    g.add_layer(f"{name}_out", ActivationLayer(activation="relu"),
                f"{name}_add")
    return f"{name}_out"


def _basic(g: GraphBuilder, name: str, inp: str, channels: int,
           stride: int, project: bool) -> str:
    """3x3 -> 3x3 basic block (ResNet-18/34)."""
    a = _conv_bn(g, f"{name}_a", inp, channels, (3, 3), (stride, stride),
                 (1, 1), act="relu")
    b = _conv_bn(g, f"{name}_b", a, channels, (3, 3), (1, 1), (1, 1))
    if project:
        sc = _conv_bn(g, f"{name}_proj", inp, channels, (1, 1),
                      (stride, stride))
    else:
        sc = inp
    g.add_vertex(f"{name}_add", ElementWiseVertex(op="add"), b, sc)
    g.add_layer(f"{name}_out", ActivationLayer(activation="relu"),
                f"{name}_add")
    return f"{name}_out"


def resnet(depth: int = 50, *, num_classes: int = 1000,
           input_shape: Tuple[int, int, int] = (224, 224, 3),
           updater=None, seed: int = 1234,
           dtype: str = "FLOAT", s2d_stem: bool = True) -> ComputationGraph:
    """Build a ResNet ComputationGraph (not yet initialized; call
    ``init(device=...)``). ``input_shape`` is NHWC-style (H, W, C);
    ``updater`` defaults to the zoo's ``Adam(learning_rate=1e-3)``."""
    if depth not in _SPECS:
        raise ValueError(f"depth must be one of {sorted(_SPECS)}")
    blocks, bottleneck = _SPECS[depth]
    h, w, c = input_shape

    base = (NeuralNetConfiguration.builder().seed(seed).data_type(dtype)
            .updater(updater or Adam(learning_rate=1e-3)))
    g = (base.graph_builder()
         .add_inputs("in")
         .set_input_types(InputType.convolutional(c, h, w,
                                                  data_format="NHWC")))

    # stem: 7x7/2 conv + BN + relu + 3x3/2 maxpool. The stem conv keeps the
    # JAX package's s2d_stem_conv kind (same config and stored weight)
    if s2d_stem and h % 2 == 0 and w % 2 == 0:
        g.add_layer("stem_conv", SpaceToDepthStemConv(n_out=64,
                                                      weight_init="relu"),
                    "in")
        g.add_layer("stem_bn", BatchNormalization(data_format="NHWC"),
                    "stem_conv")
        g.add_layer("stem_act", ActivationLayer(activation="relu"),
                    "stem_bn")
        top = "stem_act"
    else:
        top = _conv_bn(g, "stem", "in", 64, (7, 7), (2, 2), padding=(3, 3),
                       act="relu")
    g.add_layer("stem_pool", SubsamplingLayer(kernel=(3, 3), stride=(2, 2),
                                              padding=(1, 1),
                                              pool_type="max",
                                              data_format="NHWC"),
                top)
    top = "stem_pool"

    block_fn = _bottleneck if bottleneck else _basic
    for stage, (n_blocks, ch) in enumerate(zip(blocks, _STAGE_CHANNELS)):
        for i in range(n_blocks):
            stride = 2 if (stage > 0 and i == 0) else 1
            project = (i == 0)
            top = block_fn(g, f"s{stage}_b{i}", top, ch, stride, project)

    g.add_layer("avgpool", GlobalPoolingLayer(pool_type="avg",
                                              data_format="NHWC"), top)
    g.add_layer("fc", OutputLayer(n_out=num_classes, weight_init="xavier"),
                "avgpool")
    g.set_outputs("fc")
    return ComputationGraph(g.build())


def resnet50(**kw) -> ComputationGraph:
    """The DL4J zoo model (ResNet50), NHWC, ImageNet head by default."""
    return resnet(50, **kw)
