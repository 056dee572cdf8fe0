"""Model zoo of the port: the ResNet family (ComputationGraph) and the
BERT encoder (a SameDiff graph)."""

from .bert import BertConfig, bert, bert_base  # noqa: F401
from .resnet import resnet, resnet50  # noqa: F401
