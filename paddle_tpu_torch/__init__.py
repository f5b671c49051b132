"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu for one NVIDIA H100.

The JAX package ``paddle_tpu`` is the reference; this package imports
nothing of it. Slice 1 serves greedy Transformer-base decode
(``inference.Generator`` behind ``inference.BatchingGeneratorServer``) with
the attention forward as a hand-written CUDA kernel (``csrc/flash_fwd.cu``).
Slice 2 trains the long-context Transformer (``models.Transformer.loss``,
per-layer remat, ``optimizer.Adam``) with the attention backward
(``csrc/flash_bwd.cu``) and the one-pass optimizer update
(``csrc/fused_update.cu``) as hand-written kernels too.
Slice 3 trains ResNet-50 as ``bench.py`` does (``paddle_tpu_torch/bench.py``)
with every conv outside the stem in hand-written kernels: the 1x1 convs'
blocked GEMM (``csrc/brgemm.cu``) and the 3x3 convs' implicit GEMM
(``csrc/conv_kxk.cu``), forward, dx and dw.
Entry points run on the card (``device="cuda"``) unless the caller passes
``device="cpu"``.
"""

from paddle_tpu_torch.core.device import resolve_device, strict_float32

strict_float32()

__all__ = ["resolve_device", "strict_float32"]
