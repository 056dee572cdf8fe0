"""Model zoo of the port: the ResNet family (ComputationGraph), the BERT
encoder (a SameDiff graph), and LeNet and TextGenerationLSTM
(MultiLayerNetworks)."""

from .bert import (BertConfig, attach_classifier_head, bert,  # noqa: F401
                   bert_base, fine_tune_feeds)
from .lenet import lenet, lenet_config  # noqa: F401
from .resnet import resnet, resnet50  # noqa: F401
from .zoo import text_generation_lstm  # noqa: F401
