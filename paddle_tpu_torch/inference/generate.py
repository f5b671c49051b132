"""Serving-side batched greedy generation (counterpart of
``paddle_tpu/inference/generate.py``).

Requests are padded up to the nearest (batch, source-length) bucket, as in
the JAX package, so a stream of requests reuses a few shapes. PyTorch
compiles nothing per shape; the buckets keep the kernels' shapes, and so
the path's timings, the same as the JAX package's. Padding is inert:
padded source positions are masked out of the encoder and the
cross-attention (src_mask = ids != pad), padded batch rows start finished
and are sliced off before returning.
"""

from __future__ import annotations

import copy
import dataclasses
import time
from typing import Optional, Sequence

import numpy as np
import torch

from paddle_tpu_torch.core.device import DEFAULT_DEVICE, resolve_device
from paddle_tpu_torch.models import transformer as T


@dataclasses.dataclass
class GenerationConfig:
    """Knobs of the serving decode loop (contrib/decoder config analog)."""
    max_len: int = 64               # generated-sequence cap (incl. bos)
    beam_size: int = 1              # 1 = greedy; beam search is not ported
    bos_id: int = 1
    eos_id: int = 2
    pad_id: int = 0
    batch_buckets: Sequence[int] = (1, 4, 16, 64)
    src_len_buckets: Sequence[int] = (16, 32, 64, 128, 256)
    use_bf16: bool = False          # cast params once at construction


class Generator:
    """Batched greedy ``generate()`` over a seq2seq Transformer with
    KV-cached decode.

    >>> gen = Generator(model, GenerationConfig(max_len=64))
    >>> toks = gen.generate(src_batch)          # [B, max_len] int32

    ``model`` must live on ``device``. With ``use_bf16`` the generator
    decodes with a bfloat16 copy of the model's parameters and leaves the
    caller's model as it was, as the JAX generator casts its own copy of
    the variables."""

    def __init__(self, model, config: Optional[GenerationConfig] = None,
                 device=DEFAULT_DEVICE):
        self.cfg = config or GenerationConfig()
        self.device = resolve_device(device)
        if model.device.type != self.device.type:
            raise ValueError(f"model is on {model.device}, generator "
                             f"device is {self.device}")
        if self.cfg.beam_size != 1:
            raise NotImplementedError(
                "beam search is not ported yet; use beam_size=1")
        if self.cfg.pad_id != 0:
            raise NotImplementedError(
                "the decode paths derive src_mask as (ids != 0); pad_id "
                f"must be 0, got {self.cfg.pad_id}")
        if self.cfg.max_len > model.cfg.max_length:
            raise ValueError(
                f"max_len {self.cfg.max_len} exceeds the model's "
                f"positional-encoding table (max_length="
                f"{model.cfg.max_length})")
        too_long = [L for L in self.cfg.src_len_buckets
                    if L > model.cfg.max_length]
        if too_long:
            raise ValueError(f"src_len_buckets {too_long} exceed the "
                             f"model max_length {model.cfg.max_length}")
        if self.cfg.use_bf16:
            model = copy.deepcopy(model)
            for p in model.parameters():
                if p.dtype.is_floating_point:
                    p.data = p.data.to(torch.bfloat16)
        self.model = model
        self._seen = set()          # bucket pairs run at least once
        self.last_latency_ms: Optional[float] = None
        self.last_tokens_per_s: Optional[float] = None

    @staticmethod
    def _fit(n: int, buckets: Sequence[int]) -> int:
        for b in sorted(buckets):
            if b >= n:
                return b
        # oversize request: round up to the next power of two
        p = 1
        while p < n:
            p *= 2
        return p

    def generate(self, src_ids):
        """src_ids: ``[B, L]`` int (pad with cfg.pad_id). Returns tokens
        ``[B, max_len]`` int32 as a numpy array. Updates last_latency_ms /
        last_tokens_per_s; the first call at a bucket pair (kernel build,
        library warm-up) leaves both None."""
        src = np.asarray(src_ids, np.int32)
        b, L = src.shape
        if L > self.model.cfg.max_length:
            raise ValueError(
                f"source length {L} exceeds the model's positional table "
                f"(max_length={self.model.cfg.max_length})")
        bb = self._fit(b, self.cfg.batch_buckets)
        lb = min(self._fit(L, self.cfg.src_len_buckets),
                 self.model.cfg.max_length)
        padded = np.full((bb, lb), self.cfg.pad_id, np.int32)
        padded[:b, :L] = src
        row_mask = torch.from_numpy(np.arange(bb) < b)  # padding rows: done

        cold = (bb, lb) not in self._seen
        self._seen.add((bb, lb))
        t0 = time.perf_counter()
        out = T.greedy_decode_cached(
            self.model, torch.from_numpy(padded).to(self.device),
            bos_id=self.cfg.bos_id, eos_id=self.cfg.eos_id,
            max_len=self.cfg.max_len, row_mask=row_mask)
        toks = out.cpu().numpy()[:b]           # waits for the device
        dt = time.perf_counter() - t0
        self.last_latency_ms = None if cold else dt * 1e3
        n_gen = int((toks[:, 1:] != self.cfg.pad_id).sum())
        self.last_tokens_per_s = None if cold else (
            n_gen / dt if dt > 0 else None)
        return toks
