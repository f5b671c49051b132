"""BERT pretraining model (counterpart of ``paddle_tpu/models/bert.py``,
``BASELINE.json`` config 3): ``BertConfig`` (``base``, ``large``,
``tiny``), ``BertEmbeddings``, the post-LN ``BertLayer``, ``BertModel``
and ``BertForPretraining`` with its MLM and NSP heads and ``loss``.

Parameter names follow the JAX tree (``bert/layers_3/attn/q_proj/weight``
is ``bert.layers.3.attn.q_proj.weight``), so ``convert.from_jax_variables``
carries its weights across. Parameters are float32; activations run in
``cfg.dtype`` from the embedding LayerNorm's output on. With
``use_pallas`` every attention takes the flash op with the ``[B, T]`` kv
mask of ``input_ids != 0``, and the LayerNorms are built with
``use_pallas`` as in the reference; they see ``[B, T, H]`` inputs, so
they take the plain route and the row-norm kernel is never launched by
this model (``nn_ops.layer_norm``).

The model is built on the CPU from ``torch.Generator().manual_seed(seed)``
with the JAX model's distributions (the streams differ) and moved to
``device``. It starts in eval mode, where dropout is the identity, as the
JAX ``apply`` defaults to ``training=False``; ``train()`` turns dropout on.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from paddle_tpu_torch import initializer as I
from paddle_tpu_torch.core.device import DEFAULT_DEVICE, resolve_device
from paddle_tpu_torch.core.dtypes import convert_dtype
from paddle_tpu_torch.nn.attention import MultiHeadAttention
from paddle_tpu_torch.nn.layers import Dropout, Embedding, LayerNorm, Linear
from paddle_tpu_torch.ops.loss import token_softmax_cross_entropy


class BertConfig:
    def __init__(self, vocab_size=30522, hidden_size=768, num_layers=12,
                 num_heads=12, intermediate_size=3072, max_position=512,
                 type_vocab_size=2, dropout=0.1, dtype=torch.float32,
                 use_pallas=False):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.intermediate_size = intermediate_size
        self.max_position = max_position
        self.type_vocab_size = type_vocab_size
        self.dropout = dropout
        self.dtype = convert_dtype(dtype)
        self.use_pallas = use_pallas

    @classmethod
    def base(cls, **kw):
        return cls(**kw)

    @classmethod
    def large(cls, **kw):
        kw.setdefault("hidden_size", 1024)
        kw.setdefault("num_layers", 24)
        kw.setdefault("num_heads", 16)
        kw.setdefault("intermediate_size", 4096)
        return cls(**kw)

    @classmethod
    def tiny(cls, **kw):
        kw.setdefault("vocab_size", 128)
        kw.setdefault("hidden_size", 64)
        kw.setdefault("num_layers", 2)
        kw.setdefault("num_heads", 4)
        kw.setdefault("intermediate_size", 128)
        kw.setdefault("max_position", 64)
        return cls(**kw)


class BertEmbeddings(nn.Module):
    def __init__(self, cfg: BertConfig, generator=None):
        super().__init__()
        init = I.TruncatedNormal(scale=0.02)
        h = cfg.hidden_size
        self.word = Embedding(cfg.vocab_size, h, weight_init=init,
                              generator=generator)
        self.position = Embedding(cfg.max_position, h, weight_init=init,
                                  generator=generator)
        self.token_type = Embedding(cfg.type_vocab_size, h,
                                    weight_init=init, generator=generator)
        self.ln = LayerNorm(h, epsilon=1e-12, use_pallas=cfg.use_pallas)
        self.drop = Dropout(cfg.dropout)
        self.dtype = cfg.dtype

    def forward(self, input_ids, token_type_ids=None):
        pos = torch.arange(input_ids.shape[1],
                           device=input_ids.device)[None]
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        x = (self.word(input_ids) + self.position(pos)
             + self.token_type(token_type_ids))
        return self.drop(self.ln(x)).to(self.dtype)


class BertLayer(nn.Module):
    """post-LN encoder layer (original BERT)."""

    def __init__(self, cfg: BertConfig, generator=None):
        super().__init__()
        h = cfg.hidden_size
        self.attn = MultiHeadAttention(h, cfg.num_heads, dropout=cfg.dropout,
                                       use_flash=cfg.use_pallas,
                                       generator=generator)
        self.attn_drop = Dropout(cfg.dropout)
        self.attn_ln = LayerNorm(h, epsilon=1e-12, use_pallas=cfg.use_pallas)
        self.fc1 = Linear(h, cfg.intermediate_size, act="gelu",
                          generator=generator)
        self.fc2 = Linear(cfg.intermediate_size, h, generator=generator)
        self.out_drop = Dropout(cfg.dropout)
        self.out_ln = LayerNorm(h, epsilon=1e-12, use_pallas=cfg.use_pallas)

    def forward(self, x, mask=None):
        x = self.attn_ln(x + self.attn_drop(self.attn(x, mask=mask)))
        return self.out_ln(x + self.out_drop(self.fc2(self.fc1(x))))


class BertModel(nn.Module):
    """Encoder stack; returns (sequence_output, pooled_output)."""

    def __init__(self, cfg: BertConfig, generator=None):
        super().__init__()
        self.cfg = cfg
        self.embeddings = BertEmbeddings(cfg, generator)
        self.layers = nn.ModuleList(BertLayer(cfg, generator)
                                    for _ in range(cfg.num_layers))
        self.pooler = Linear(cfg.hidden_size, cfg.hidden_size, act="tanh",
                             generator=generator)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        if attention_mask is None:
            attention_mask = input_ids != 0
        mask = attention_mask.bool()[:, None, None, :]
        x = self.embeddings(input_ids, token_type_ids)
        for layer in self.layers:
            x = layer(x, mask=mask)
        return x, self.pooler(x[:, 0])


class _MlmLogits(torch.autograd.Function):
    """``(h @ emb.T + bias).to(h.dtype)`` with the product of the
    low-precision operands summed in float32 and added to the float32
    bias before the one rounding, as the reference's ``jnp.matmul(...,
    preferred_element_type=float32) + mlm_bias`` then ``astype``
    (``paddle_tpu/models/bert.py:160-162``). A bf16 ``torch.matmul``
    would round the product to bf16 first.

    The forward multiplies float32 copies of the operands (each product of
    two bf16 values is exact in float32). The backward is the reference's
    transpose: ``dh = g @ emb`` and ``demb = g.T @ h`` in the operands'
    dtype (a float32 sum, rounded once) and ``dbias`` the float32 sum of g
    over the tokens; g is already in the operands' dtype, since the logits
    are cast to it."""

    @staticmethod
    def forward(ctx, h, emb, bias):
        ctx.save_for_backward(h, emb)
        acc = torch.matmul(h.float(), emb.float().t())
        return (acc + bias).to(h.dtype)

    @staticmethod
    def backward(ctx, g):
        h, emb = ctx.saved_tensors
        dh = torch.matmul(g, emb)
        demb = torch.matmul(g.reshape(-1, g.shape[-1]).t(),
                            h.reshape(-1, h.shape[-1]))
        dbias = g.float().reshape(-1, g.shape[-1]).sum(0)
        return dh, demb, dbias


def mlm_decode(h, emb, bias):
    """MLM decoder: h ``[..., H]`` against the word table ``emb [V, H]``
    (cast to h's dtype) plus the float32 ``bias [V]``; float32 h takes a
    plain float32 product."""
    if h.dtype == torch.float32:
        return torch.matmul(h, emb.t()) + bias
    return _MlmLogits.apply(h, emb.to(h.dtype), bias)


class BertForPretraining(nn.Module):
    """MLM + NSP heads; ``loss`` mirrors standard BERT pretraining. The MLM
    decoder is the word-embedding table (``bert.embeddings.word.weight``,
    tied) with the top-level ``mlm_bias``."""

    def __init__(self, cfg: BertConfig, device=DEFAULT_DEVICE,
                 seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        g = torch.Generator().manual_seed(seed)
        self.bert = BertModel(cfg, g)
        self.mlm_transform = Linear(cfg.hidden_size, cfg.hidden_size,
                                    act="gelu", generator=g)
        self.mlm_ln = LayerNorm(cfg.hidden_size, epsilon=1e-12)
        self.nsp = Linear(cfg.hidden_size, 2, generator=g)
        self.mlm_bias = nn.Parameter(torch.zeros(cfg.vocab_size))
        self.eval()
        self.to(dev)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                masked_positions=None):
        """Returns (MLM logits ``[B, T or M, V]`` in ``cfg.dtype``, NSP
        logits ``[B, 2]`` float32). ``masked_positions [B, M]`` gathers
        only those slots before the MLM head."""
        seq, pooled = self.bert(input_ids, token_type_ids, attention_mask)
        h = seq
        if masked_positions is not None:
            idx = masked_positions.long()[..., None].expand(
                -1, -1, seq.shape[-1])
            h = torch.gather(seq, 1, idx)
        h = self.mlm_ln(self.mlm_transform(h))
        logits = mlm_decode(h, self.bert.embeddings.word.weight,
                            self.mlm_bias)
        return logits, self.nsp(pooled).float()

    @staticmethod
    def loss(mlm_logits, nsp_logits, mlm_labels, mlm_weights, nsp_labels):
        """(MLM weighted mean NLL + NSP mean NLL, {"mlm_loss",
        "nsp_loss"}), float32 (``paddle_tpu/models/bert.py:167-177``)."""
        nll = token_softmax_cross_entropy(mlm_logits, mlm_labels)
        w = mlm_weights.float()
        mlm_loss = (nll * w).sum() / w.sum().clamp(min=1.0)
        nsp_logp = F.log_softmax(nsp_logits, dim=-1)
        nsp_loss = -torch.gather(nsp_logp, -1,
                                 nsp_labels.long()[..., None])[..., 0].mean()
        return mlm_loss + nsp_loss, {"mlm_loss": mlm_loss,
                                     "nsp_loss": nsp_loss}
