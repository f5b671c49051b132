"""Gradient clipping by global norm (counterpart of
``paddle_tpu/optimizer/clip.py:39-55``) on dicts of tensors. The leaves are
taken in the dict's order, which the port keeps equal to the JAX tree's
(sorted paths), so the norm is summed in the same order. The reduction
and the factor are the ones the fused update folds into its kernel."""

from __future__ import annotations

from paddle_tpu_torch.kernels import fused_update as _fu


def global_norm(grads):
    """sqrt of the sum over leaves, in order, of sum(g.float() ** 2)."""
    return _fu.global_norm(list(grads.values()))


class GradientClipByGlobalNorm:
    def __init__(self, clip_norm):
        self.clip_norm = clip_norm

    def apply(self, grads):
        factor = _fu.clip_factor(global_norm(grads), self.clip_norm)
        return {k: (g * factor).to(g.dtype) for k, g in grads.items()}
