"""Layers and attention of the serving, training and ResNet paths."""

from paddle_tpu_torch.nn.attention import (MultiHeadAttention,
                                           scaled_dot_product_attention)
from paddle_tpu_torch.nn.layers import (BatchNorm, Conv2D, Dropout, Embedding,
                                        LayerNorm, Linear, Pool2D)

__all__ = ["BatchNorm", "Conv2D", "Dropout", "Embedding", "LayerNorm",
           "Linear", "Pool2D",
           "MultiHeadAttention", "scaled_dot_product_attention"]
