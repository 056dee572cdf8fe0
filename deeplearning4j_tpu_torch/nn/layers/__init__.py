"""Layers of the port. Importing this package registers every layer kind
for ``Layer.from_dict``."""

from .attention import (LearnedSelfAttentionLayer,  # noqa: F401
                        RecurrentAttentionLayer, SelfAttentionLayer)
from .base import LAYERS, CacheSpec, Layer, layer  # noqa: F401
from .conv import (BatchNormalization, ConvolutionLayer,  # noqa: F401
                   GlobalPoolingLayer, LocalResponseNormalization,
                   SubsamplingLayer, Upsampling2D, ZeroPadding2D)
from .conv_extra import (Convolution1D, Cropping1D,  # noqa: F401
                         Cropping2D, Deconvolution2D,
                         DepthToSpaceLayer, DepthwiseConvolution2D,
                         LocallyConnected1D, LocallyConnected2D,
                         SeparableConvolution1D, SeparableConvolution2D,
                         SpaceToDepthLayer, SpaceToDepthStemConv,
                         Subsampling1DLayer, Upsampling1D,
                         ZeroPadding1DLayer)
from .core import (ActivationLayer, DenseLayer, DropoutLayer,  # noqa: F401
                   ElementWiseMultiplicationLayer, EmbeddingLayer,
                   FlattenLayer, LossLayer, MaskingLayer, OutputLayer,
                   PermuteLayer, ReshapeLayer)
from .recurrent import (GRU, LSTM, Bidirectional, ConvLSTM2D,  # noqa: F401
                        GravesLSTM, LastTimeStep, RnnLossLayer,
                        RnnOutputLayer, SimpleRnn)
from .special import (CenterLossOutputLayer,  # noqa: F401
                      EmbeddingSequenceLayer)
from .wrappers import (FrozenLayer, MaskLayer, RepeatVector,  # noqa: F401
                       TimeDistributed)
