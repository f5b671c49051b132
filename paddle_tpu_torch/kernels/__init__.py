"""Hand-written Hopper kernels with their wrappers and plain versions."""

from paddle_tpu_torch.kernels.attention import (flash_attention,
                                                flash_attention_reference)
from paddle_tpu_torch.kernels.embedding_pool import embedding_seqpool
from paddle_tpu_torch.kernels.layer_norm import (fused_layer_norm,
                                                 fused_layer_norm_reference)
from paddle_tpu_torch.kernels.pool_fused import (max_pool2d_fused,
                                                 set_pool_fused)

__all__ = ["flash_attention", "flash_attention_reference",
           "embedding_seqpool", "fused_layer_norm",
           "fused_layer_norm_reference", "max_pool2d_fused", "set_pool_fused"]
