"""Model zoo of the port: the ResNet family (ComputationGraph) and the
BERT encoder (a SameDiff graph)."""

from .bert import (BertConfig, attach_classifier_head, bert,  # noqa: F401
                   bert_base, fine_tune_feeds)
from .resnet import resnet, resnet50  # noqa: F401
