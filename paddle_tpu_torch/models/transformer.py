"""Transformer-base encoder-decoder for serving (counterpart of
``paddle_tpu/models/transformer.py``).

Ported: ``sinusoid_position_encoding``, ``FeedForward``, ``EncoderLayer``,
``DecoderLayer`` (``forward``/``step``/``cross_kv``), ``TransformerConfig``
(``base``/``big``/``tiny``), ``Transformer`` (``encode``, ``decode``,
``init_decode_state``, ``decode_step``, ``forward``) and
``greedy_decode_cached``. MoE, remat, paged, speculative and beam decode
come with later slices; their config knobs are not accepted here.

Activations run in ``cfg.dtype``; parameters are float32 (``Generator``'s
``use_bf16`` casts them once). The model is built on the CPU from a seeded
``torch.Generator`` and then moved to ``device``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from paddle_tpu_torch.core.device import DEFAULT_DEVICE, resolve_device
from paddle_tpu_torch.core.dtypes import convert_dtype
from paddle_tpu_torch.nn.attention import MultiHeadAttention
from paddle_tpu_torch.nn.layers import Dropout, Embedding, LayerNorm, Linear
from paddle_tpu_torch.ops.math import stable_argmax


def sinusoid_position_encoding(max_len: int, d_model: int,
                               dtype=torch.float32):
    """Fixed sinusoid table: all sines, then all cosines, along the last
    dim (not interleaved), as ``paddle_tpu/models/transformer.py:33``."""
    pos = torch.arange(max_len, dtype=torch.float32)[:, None]
    dim = torch.arange(d_model // 2, dtype=torch.float32)[None, :]
    inv = torch.exp(-math.log(10000.0) * 2.0 * dim / d_model)
    ang = pos * inv
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


class FeedForward(nn.Module):
    def __init__(self, d_model, d_inner, dropout=0.1, generator=None):
        super().__init__()
        self.fc1 = Linear(d_model, d_inner, act="relu", generator=generator)
        self.drop = Dropout(dropout)
        self.fc2 = Linear(d_inner, d_model, generator=generator)

    def forward(self, x):
        return self.fc2(self.drop(self.fc1(x)))


class EncoderLayer(nn.Module):
    """pre-LN encoder layer: normalize, sublayer, dropout + residual."""

    def __init__(self, d_model, n_head, d_inner, dropout=0.1,
                 use_flash=False, generator=None):
        super().__init__()
        self.ln1 = LayerNorm(d_model)
        self.attn = MultiHeadAttention(d_model, n_head, dropout=dropout,
                                       use_flash=use_flash,
                                       generator=generator)
        self.drop1 = Dropout(dropout)
        self.ln2 = LayerNorm(d_model)
        self.ffn = FeedForward(d_model, d_inner, dropout, generator=generator)
        self.drop2 = Dropout(dropout)

    def forward(self, x, mask=None):
        x = x + self.drop1(self.attn(self.ln1(x), mask=mask))
        return x + self.drop2(self.ffn(self.ln2(x)))


class DecoderLayer(nn.Module):
    def __init__(self, d_model, n_head, d_inner, dropout=0.1,
                 use_flash=False, generator=None):
        super().__init__()
        self.ln1 = LayerNorm(d_model)
        self.self_attn = MultiHeadAttention(d_model, n_head, dropout=dropout,
                                            use_flash=use_flash,
                                            generator=generator)
        self.drop1 = Dropout(dropout)
        self.ln2 = LayerNorm(d_model)
        self.cross_attn = MultiHeadAttention(d_model, n_head,
                                             dropout=dropout,
                                             use_flash=use_flash,
                                             generator=generator)
        self.drop2 = Dropout(dropout)
        self.ln3 = LayerNorm(d_model)
        self.ffn = FeedForward(d_model, d_inner, dropout, generator=generator)
        self.drop3 = Dropout(dropout)

    def forward(self, x, enc_out, self_mask=None, cross_mask=None):
        x = x + self.drop1(self.self_attn(self.ln1(x), mask=self_mask,
                                          causal=self_mask is None))
        x = x + self.drop2(self.cross_attn(self.ln2(x), enc_out, enc_out,
                                           mask=cross_mask))
        return x + self.drop3(self.ffn(self.ln3(x)))

    def step(self, x_t, cache, cache_index, cross_kv, src_mask):
        """One-token decode with KV cache. x_t: ``[B, 1, D]``."""
        a, cache = self.self_attn.step(self.ln1(x_t), cache=cache,
                                       cache_index=cache_index)
        x_t = x_t + self.drop1(a)
        c, _ = self.cross_attn.step(self.ln2(x_t), static_kv=cross_kv,
                                    kv_mask=src_mask)
        x_t = x_t + self.drop2(c)
        return x_t + self.drop3(self.ffn(self.ln3(x_t))), cache

    def cross_kv(self, enc_out):
        return self.cross_attn.kv(enc_out)


class TransformerConfig:
    """transformer-base hyperparams (dist_transformer.py ModelHyperParams).
    ``dtype`` is the activation dtype: a ``torch.dtype`` or its name."""

    def __init__(self, src_vocab_size=32000, trg_vocab_size=32000,
                 max_length=256, d_model=512, d_inner=2048, n_head=8,
                 n_layer=6, dropout=0.1, share_embedding=True,
                 dtype=torch.float32, use_flash=False):
        self.src_vocab_size = src_vocab_size
        self.trg_vocab_size = trg_vocab_size
        self.max_length = max_length
        self.d_model = d_model
        self.d_inner = d_inner
        self.n_head = n_head
        self.n_layer = n_layer
        self.dropout = dropout
        self.share_embedding = share_embedding
        self.dtype = convert_dtype(dtype)
        self.use_flash = use_flash

    @classmethod
    def base(cls, **kw):
        return cls(**kw)

    @classmethod
    def big(cls, **kw):
        kw.setdefault("d_model", 1024)
        kw.setdefault("d_inner", 4096)
        kw.setdefault("n_head", 16)
        return cls(**kw)

    @classmethod
    def tiny(cls, **kw):
        """For tests."""
        kw.setdefault("src_vocab_size", 128)
        kw.setdefault("trg_vocab_size", 128)
        kw.setdefault("d_model", 64)
        kw.setdefault("d_inner", 128)
        kw.setdefault("n_head", 4)
        kw.setdefault("n_layer", 2)
        kw.setdefault("max_length", 32)
        return cls(**kw)


class Transformer(nn.Module):
    """Encoder-decoder transformer; returns logits over the target vocab.

    Random weights come from ``torch.Generator().manual_seed(seed)`` with
    the JAX model's distributions (the streams differ); load the JAX
    package's weights with ``paddle_tpu_torch.convert.from_jax_variables``.
    """

    def __init__(self, cfg: TransformerConfig, device=DEFAULT_DEVICE,
                 seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        g = torch.Generator().manual_seed(seed)
        std = cfg.d_model ** -0.5
        self.src_emb = Embedding(cfg.src_vocab_size, cfg.d_model, std=std,
                                 generator=g)
        # one module under both names: tied source/target embedding
        self.trg_emb = (self.src_emb if cfg.share_embedding else
                        Embedding(cfg.trg_vocab_size, cfg.d_model, std=std,
                                  generator=g))
        self.enc_drop = Dropout(cfg.dropout)
        self.dec_drop = Dropout(cfg.dropout)
        self.enc_layers = nn.ModuleList(
            EncoderLayer(cfg.d_model, cfg.n_head, cfg.d_inner, cfg.dropout,
                         use_flash=cfg.use_flash, generator=g)
            for _ in range(cfg.n_layer))
        self.dec_layers = nn.ModuleList(
            DecoderLayer(cfg.d_model, cfg.n_head, cfg.d_inner, cfg.dropout,
                         use_flash=cfg.use_flash, generator=g)
            for _ in range(cfg.n_layer))
        self.enc_ln = LayerNorm(cfg.d_model)
        self.dec_ln = LayerNorm(cfg.d_model)
        self.proj = Linear(cfg.d_model, cfg.trg_vocab_size, bias=False,
                           generator=g)
        self.register_buffer(
            "pos_enc", sinusoid_position_encoding(cfg.max_length,
                                                  cfg.d_model),
            persistent=False)
        self.eval()
        self.to(dev)

    @property
    def device(self) -> torch.device:
        return self.proj.weight.device

    # -- pieces ----------------------------------------------------------

    def _emb_scale(self, dtype):
        # sqrt(d_model) rounded to the activation dtype, as jnp.asarray does
        return float(torch.tensor(math.sqrt(self.cfg.d_model), dtype=dtype))

    def _embed(self, emb, ids, dtype):
        x = emb(ids).to(dtype) * self._emb_scale(dtype)
        return x + self.pos_enc.to(dtype)[None, :ids.shape[1]]

    @torch.no_grad()
    def encode(self, src_ids, src_mask=None):
        dtype = self.cfg.dtype
        if src_mask is None:
            src_mask = src_ids != 0
        x = self.enc_drop(self._embed(self.src_emb, src_ids, dtype))
        attn_mask = src_mask[:, None, None, :]
        for layer in self.enc_layers:
            x = layer(x, mask=attn_mask)
        return self.enc_ln(x)

    @torch.no_grad()
    def decode(self, trg_ids, enc_out, src_mask=None, trg_mask=None):
        dtype = self.cfg.dtype
        x = self.dec_drop(self._embed(self.trg_emb, trg_ids, dtype))
        L = trg_ids.shape[1]
        self_mask = torch.ones((L, L), dtype=torch.bool,
                               device=x.device).tril()[None, None]
        if trg_mask is not None:
            self_mask = self_mask & trg_mask[:, None, None, :]
        cross_mask = None if src_mask is None else src_mask[:, None, None, :]
        for layer in self.dec_layers:
            x = layer(x, enc_out, self_mask=self_mask, cross_mask=cross_mask)
        return self.proj(self.dec_ln(x))

    # -- incremental decoding (KV cache) ---------------------------------

    @torch.no_grad()
    def init_decode_state(self, enc_out, max_len):
        """Prefill: per-layer empty self-attn caches + precomputed
        cross-attention K/V from the encoder output."""
        b = enc_out.shape[0]
        caches = [layer.self_attn.init_cache(b, max_len, enc_out.dtype)
                  for layer in self.dec_layers]
        cross_kvs = [layer.cross_kv(enc_out) for layer in self.dec_layers]
        return caches, cross_kvs

    @torch.no_grad()
    def decode_step(self, tok_t, idx, caches, cross_kvs, src_mask):
        """One decode step. tok_t: ``[B]`` int token at position idx.
        Returns (logits ``[B, V]``, caches), the caches updated in place."""
        dtype = self.cfg.dtype
        x = self.trg_emb(tok_t).to(dtype)[:, None, :] * self._emb_scale(dtype)
        x = x + self.pos_enc.to(dtype)[idx][None, None]
        new_caches = []
        for layer, cache, ckv in zip(self.dec_layers, caches, cross_kvs):
            x, cache = layer.step(x, cache, idx, ckv, src_mask)
            new_caches.append(cache)
        return self.proj(self.dec_ln(x))[:, 0], new_caches

    def forward(self, src_ids, trg_ids, src_mask=None, trg_mask=None):
        if src_mask is None:
            src_mask = src_ids != 0
        enc_out = self.encode(src_ids, src_mask)
        return self.decode(trg_ids, enc_out, src_mask, trg_mask)


@torch.no_grad()
def greedy_decode_cached(model: Transformer, src_ids, bos_id=1, eos_id=2,
                         max_len: Optional[int] = None, row_mask=None):
    """KV-cached greedy decode (``paddle_tpu/models/transformer.py:920``).

    The JAX while_loop becomes a Python loop that stops after
    ``max_len - 1`` steps or once every row has emitted eos (one host
    read of the finished flags per step). ``row_mask`` ([B] bool, True =
    real row) marks batch-padding rows as already finished."""
    max_len = max_len or model.cfg.max_length
    dev = model.device
    src_ids = src_ids.to(dev)
    b = src_ids.shape[0]
    src_mask = src_ids != 0
    enc_out = model.encode(src_ids, src_mask)
    caches, cross_kvs = model.init_decode_state(enc_out, max_len)
    tokens = torch.zeros((b, max_len), dtype=torch.int32, device=dev)
    tokens[:, 0] = bos_id
    finished = (torch.zeros(b, dtype=torch.bool, device=dev)
                if row_mask is None else ~row_mask.to(dev))
    i = 0
    while i < max_len - 1 and not bool(finished.all()):
        logits, caches = model.decode_step(tokens[:, i], i, caches,
                                           cross_kvs, src_mask)
        nxt = stable_argmax(logits, dim=-1)
        nxt = torch.where(finished, torch.zeros_like(nxt), nxt)
        tokens[:, i + 1] = nxt
        finished = finished | (nxt == eos_id)
        i += 1
    return tokens
