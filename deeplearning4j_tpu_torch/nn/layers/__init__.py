"""Layers of the port. Importing this package registers every layer kind
for ``Layer.from_dict``."""

from .attention import (LearnedSelfAttentionLayer,  # noqa: F401
                        SelfAttentionLayer)
from .base import LAYERS, CacheSpec, Layer, layer  # noqa: F401
from .conv import (BatchNormalization, ConvolutionLayer,  # noqa: F401
                   GlobalPoolingLayer, SubsamplingLayer)
from .conv_extra import SpaceToDepthStemConv  # noqa: F401
from .core import (ActivationLayer, DenseLayer, DropoutLayer,  # noqa: F401
                   FlattenLayer, LossLayer, OutputLayer)
from .recurrent import (LSTM, LastTimeStep, RnnLossLayer,  # noqa: F401
                        RnnOutputLayer)
