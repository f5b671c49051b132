"""Multi-head attention of the serving and training paths (counterpart of
``paddle_tpu/nn/attention.py``): ``scaled_dot_product_attention`` with its
flash route and its dense route (whose softmax keeps the low-precision
probs as its only residual, ``_softmax_lowp``), and ``MultiHeadAttention``
with ``forward``, ``init_cache``, ``kv`` and the one-token ``step``. The
paged and staged methods come with the paged-server slice.

The self-attention KV cache is written in place at ``cache_index`` (the
JAX version returns an updated copy); ``step`` still returns the cache so
callers read the same as in the JAX package.
"""

from __future__ import annotations

import torch
from torch import nn

from paddle_tpu_torch.kernels.attention import MASK_VALUE, flash_attention
from paddle_tpu_torch.nn.layers import Dropout, Linear
from paddle_tpu_torch.ops.math import matmul


class _SoftmaxLowp(torch.autograd.Function):
    """Softmax over the last dim (float32 logits) cast to ``dtype``, whose
    residual is the low-precision probs tensor, not the float32 logits;
    the backward computes ``p * (g - <p, g>)`` in float32
    (``paddle_tpu/nn/attention.py:53-76``)."""

    @staticmethod
    def forward(ctx, logits, dtype):
        p = torch.softmax(logits, dim=-1).to(dtype)
        ctx.save_for_backward(p)
        return p

    @staticmethod
    def backward(ctx, g):
        (p,) = ctx.saved_tensors
        p32, g32 = p.float(), g.float()
        dot = (p32 * g32).sum(dim=-1, keepdim=True)
        return p32 * (g32 - dot), None


def _softmax_lowp(logits, dtype):
    return _SoftmaxLowp.apply(logits, dtype)


def scaled_dot_product_attention(q, k, v, mask=None, scale=None,
                                 causal=False, use_flash=False):
    """q,k,v: ``[B, H, T, Dh]``. mask: broadcastable to ``[B, H, Tq, Tk]``
    (True = attend). Softmax accumulates in float32 whatever the input
    dtype (``paddle_tpu/nn/attention.py:22``).

    With ``use_flash``, no mask or a ``[B|1, 1, 1, Tk]`` padding mask folds
    into ``flash_attention``'s ``[B, Tk]`` kv mask; per-head or
    ``[Tq, Tk]`` masks take the plain path below, as in the JAX package."""
    if use_flash:
        if mask is None:
            return flash_attention(q, k, v, causal=causal, scale=scale,
                                   device=q.device)
        if mask.dim() == 4 and mask.shape[-2] == 1 and mask.shape[1] == 1:
            kv_mask = mask[:, 0, 0, :].expand(q.shape[0],
                                              mask.shape[-1]).contiguous()
            return flash_attention(q, k, v, causal=causal, scale=scale,
                                   kv_mask=kv_mask, device=q.device)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        tq, tk = logits.shape[-2], logits.shape[-1]
        cmask = torch.ones((tq, tk), dtype=torch.bool,
                           device=q.device).tril(diagonal=tk - tq)
        logits = logits.masked_fill(~cmask, MASK_VALUE)
    if mask is not None:
        logits = logits.masked_fill(~mask, MASK_VALUE)
    probs = _softmax_lowp(logits, q.dtype)
    return matmul(probs, v)


class MultiHeadAttention(nn.Module):
    """Standard MHA with separate q/k/v/out projections (parameter names
    as in the JAX module)."""

    def __init__(self, embed_dim, num_heads, dropout=0.0, use_flash=False,
                 generator=None):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError(f"embed_dim {embed_dim} is not a multiple of "
                             f"num_heads {num_heads}")
        self.d, self.h = embed_dim, num_heads
        self.dh = embed_dim // num_heads
        self.use_flash = use_flash
        self.q_proj = Linear(embed_dim, embed_dim, generator=generator)
        self.k_proj = Linear(embed_dim, embed_dim, generator=generator)
        self.v_proj = Linear(embed_dim, embed_dim, generator=generator)
        self.out_proj = Linear(embed_dim, embed_dim, generator=generator)
        self.drop = Dropout(dropout)

    def _split(self, x):
        """``[B, T, D]`` -> contiguous ``[B, H, T, Dh]`` (the kernel reads
        dense rows)."""
        b, t, _ = x.shape
        return x.reshape(b, t, self.h, self.dh).transpose(1, 2).contiguous()

    def _merge(self, out):
        b, h, t, dh = out.shape
        return self.drop(self.out_proj(
            out.transpose(1, 2).reshape(b, t, h * dh)))

    def forward(self, query, key=None, value=None, mask=None, causal=False):
        key = query if key is None else key
        value = key if value is None else value
        q = self._split(self.q_proj(query))
        k = self._split(self.k_proj(key))
        v = self._split(self.v_proj(value))
        if mask is not None and mask.dim() == 2:   # [B, Tk] padding mask
            mask = mask[:, None, None, :]
        out = scaled_dot_product_attention(q, k, v, mask, causal=causal,
                                           use_flash=self.use_flash)
        return self._merge(out)

    # -- incremental decoding (KV cache) --------------------------------

    def init_cache(self, batch, max_len, dtype=torch.float32):
        """Empty self-attention cache: {"k","v"} ``[B, H, T_max, Dh]``."""
        shape = (batch, self.h, max_len, self.dh)
        device = self.q_proj.weight.device
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}

    def kv(self, key_input):
        """Project cross-attention K/V once (encoder output prefill)."""
        return (self._split(self.k_proj(key_input)),
                self._split(self.v_proj(key_input)))

    def step(self, query_t, cache=None, cache_index=None, static_kv=None,
             kv_mask=None):
        """One-token attention. query_t: ``[B, 1, D]``.

        Self-attention: pass ``cache`` + ``cache_index``; the token's K/V
        are written in place at that index and attention spans positions
        <= cache_index. Returns (out ``[B, 1, D]``, cache).
        Cross-attention: pass ``static_kv`` (from ``kv``) + optional
        ``kv_mask`` ``[B, Tk]``; returns (out, None)."""
        q = self._split(self.q_proj(query_t))          # [B, H, 1, Dh]
        if static_kv is not None:
            k, v = static_kv
            mask = None if kv_mask is None else kv_mask[:, None, None, :]
            out = scaled_dot_product_attention(q, k, v, mask,
                                               use_flash=self.use_flash)
            return self._merge(out), None
        if query_t.shape[1] != 1:
            raise ValueError("cached self-attention step() is single-query; "
                             f"got t_q={query_t.shape[1]}")
        k_new = self._split(self.k_proj(query_t))
        v_new = self._split(self.v_proj(query_t))
        cache["k"][:, :, cache_index] = k_new[:, :, 0].to(cache["k"].dtype)
        cache["v"][:, :, cache_index] = v_new[:, :, 0].to(cache["v"].dtype)
        t_max = cache["k"].shape[2]
        mask = (torch.arange(t_max, device=q.device)
                <= cache_index)[None, None, None, :]
        out = scaled_dot_product_attention(q, cache["k"], cache["v"], mask,
                                           use_flash=self.use_flash)
        return self._merge(out), cache
