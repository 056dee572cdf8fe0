"""Layers of the port. Importing this package registers every layer kind
for ``Layer.from_dict``."""

from .attention import (LearnedSelfAttentionLayer,  # noqa: F401
                        RecurrentAttentionLayer, SelfAttentionLayer)
from .base import LAYERS, CacheSpec, Layer, layer  # noqa: F401
from .conv import (BatchNormalization, ConvolutionLayer,  # noqa: F401
                   GlobalPoolingLayer, SubsamplingLayer)
from .conv_extra import SpaceToDepthStemConv  # noqa: F401
from .core import (ActivationLayer, DenseLayer, DropoutLayer,  # noqa: F401
                   EmbeddingLayer, FlattenLayer, LossLayer, MaskingLayer,
                   OutputLayer)
from .recurrent import (GRU, LSTM, Bidirectional, ConvLSTM2D,  # noqa: F401
                        GravesLSTM, LastTimeStep, RnnLossLayer,
                        RnnOutputLayer, SimpleRnn)
from .special import (CenterLossOutputLayer,  # noqa: F401
                      EmbeddingSequenceLayer)
from .wrappers import (FrozenLayer, MaskLayer, RepeatVector,  # noqa: F401
                       TimeDistributed)
