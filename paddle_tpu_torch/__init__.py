"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu for one NVIDIA H100.

The JAX package ``paddle_tpu`` is the reference; this package imports
nothing of it. Slice 1 serves greedy Transformer-base decode
(``inference.Generator`` behind ``inference.BatchingGeneratorServer``) with
the attention forward as a hand-written CUDA kernel (``csrc/flash_fwd.cu``).
Entry points run on the card (``device="cuda"``) unless the caller passes
``device="cpu"``.
"""

from paddle_tpu_torch.core.device import resolve_device, strict_float32

strict_float32()

__all__ = ["resolve_device", "strict_float32"]
