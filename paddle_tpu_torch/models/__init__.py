"""Models of the port."""

from paddle_tpu_torch.models.transformer import (Transformer,
                                                 TransformerConfig,
                                                 greedy_decode_cached)

__all__ = ["Transformer", "TransformerConfig", "greedy_decode_cached"]
