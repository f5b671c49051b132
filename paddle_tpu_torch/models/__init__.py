"""Models of the port."""

from paddle_tpu_torch.models.bert import (BertConfig, BertForPretraining,
                                          BertModel)
from paddle_tpu_torch.models.resnet import (ResNet, resnet18, resnet34,
                                            resnet50, resnet101, resnet152)
from paddle_tpu_torch.models.transformer import (Transformer,
                                                 TransformerConfig,
                                                 greedy_decode_cached)

__all__ = ["BertConfig", "BertForPretraining", "BertModel", "ResNet",
           "Transformer", "TransformerConfig", "greedy_decode_cached",
           "resnet18", "resnet34", "resnet50", "resnet101", "resnet152"]
