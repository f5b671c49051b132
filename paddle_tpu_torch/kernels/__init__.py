"""Hand-written Hopper kernels with their wrappers and plain versions."""

from paddle_tpu_torch.kernels.attention import (flash_attention,
                                                flash_attention_reference)
from paddle_tpu_torch.kernels.embedding_pool import embedding_seqpool
from paddle_tpu_torch.kernels.pool_fused import (max_pool2d_fused,
                                                 set_pool_fused)

__all__ = ["flash_attention", "flash_attention_reference",
           "embedding_seqpool", "max_pool2d_fused", "set_pool_fused"]
