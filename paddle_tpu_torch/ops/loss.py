"""Loss ops of the training path (counterpart of ``paddle_tpu/ops/loss.py``):
``token_softmax_cross_entropy``."""

from __future__ import annotations

import torch


def _token_xent_impl(logits, labels, eps):
    l32 = logits.float()
    m = l32.amax(dim=-1)
    lse = torch.log(torch.exp(l32 - m[..., None]).sum(dim=-1)) + m
    # gather, where the JAX function sums a one-hot mask: the same value
    label_logit = torch.gather(l32, -1, labels.long()[..., None])[..., 0]
    nll = lse - label_logit
    if eps > 0.0:
        smooth = lse - l32.mean(dim=-1)
        nll = (1.0 - eps) * nll + eps * smooth
    return nll, lse


class _TokenXent(torch.autograd.Function):
    """The JAX custom VJP (``paddle_tpu/ops/loss.py:56-75``): residuals
    (logits, labels, lse); the backward recomputes the softmax from the
    logits and returns the gradient in the logits' dtype."""

    @staticmethod
    def forward(ctx, logits, labels, eps):
        nll, lse = _token_xent_impl(logits, labels, eps)
        ctx.save_for_backward(logits, labels, lse)
        ctx.eps = eps
        return nll

    @staticmethod
    def backward(ctx, g):
        logits, labels, lse = ctx.saved_tensors
        eps = ctx.eps
        v = logits.shape[-1]
        p = torch.exp(logits.float() - lse[..., None])
        onehot = torch.zeros_like(p).scatter_(-1, labels.long()[..., None],
                                              1.0)
        grad = p - (1.0 - eps) * onehot - (eps / v)
        return (grad * g[..., None]).to(logits.dtype), None, None


def token_softmax_cross_entropy(logits, labels, label_smooth=0.0):
    """Per-token label-smoothed softmax CE in logsumexp form:
    ``-logp[y] = lse - logits[y]`` and ``-mean(logp) = lse - mean(logits)``,
    so the float32 log-prob tensor over the vocab is never stored. Returns
    the float32 nll with the leading shape of ``labels``."""
    return _TokenXent.apply(logits, labels, float(label_smooth))
