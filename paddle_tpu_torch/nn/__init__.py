"""Layers and attention of the serving path."""

from paddle_tpu_torch.nn.attention import (MultiHeadAttention,
                                           scaled_dot_product_attention)
from paddle_tpu_torch.nn.layers import Dropout, Embedding, LayerNorm, Linear

__all__ = ["Dropout", "Embedding", "LayerNorm", "Linear",
           "MultiHeadAttention", "scaled_dot_product_attention"]
