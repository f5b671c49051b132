"""Hand-written Hopper kernels with their wrappers and plain versions."""

from paddle_tpu_torch.kernels.attention import (flash_attention,
                                                flash_attention_reference)

__all__ = ["flash_attention", "flash_attention_reference"]
