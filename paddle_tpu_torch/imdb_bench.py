"""IMDB sentiment classifier training throughput on one card (counterpart of
the ``imdb_real`` workload, ``benchmark/run_benchmarks.py:564-633``).

    python3 -m paddle_tpu_torch.imdb_bench               # batch 256 x 256
    python3 -m paddle_tpu_torch.imdb_bench --device cpu  # batch 8 x 32

The step: ``pooled = embedding_seqpool(ids, table, mean=True)``, the logit
``pooled @ w + b``, the mean log-sigmoid binary cross-entropy, ``Adam(1e-3)``
through ``Optimizer.minimize``. The table is ``[5148 + 1, dim]`` float32,
sized from the canonical IMDB dictionary as the JAX benchmark sizes it from
its word dict; ``table``, ``w`` and ``b`` are drawn from a seeded
``torch.Generator`` with the JAX benchmark's distributions (normal * 0.1,
zeros). The batch is the first ``batch`` samples of the synthetic IMDB
reader (``data/datasets.imdb``, seed ``--seed``) padded with 0 to
``max_len``: the real corpus the JAX workload reads from ``--data-dir`` is
not in the repository, and its reader is not ported.

Sizes: batch 256, max_len 256, dim 128 on the card; ``--device cpu`` runs
the JAX workload's tiny size, batch 8, max_len 32, dim 16 (the table keeps
the dictionary's 5149 rows). ``PADDLE_TPU_FUSED_OPT`` set, not empty and
not "0" routes the update through the fused optimizer kernel, by the rule of
``paddle_tpu_torch/bench.py`` (its ``fused_opt_from_env``), which is not
the JAX benchmark's: there any non-empty value, "0" included, turns the
fused update on (``benchmark/run_benchmarks.py:940-950``).

Prints one JSON line: samples/s (the batch times the timed steps over their
summed wall time), the last loss, and on the card its name and power limit
as ``nvidia-smi`` gives them.
"""

from __future__ import annotations

import argparse
import json
import time

import torch
import torch.nn.functional as F

from paddle_tpu_torch.data.datasets import IMDB_VOCAB, collate, imdb
from paddle_tpu_torch.kernels.embedding_pool import embedding_seqpool

SIZES = {"cuda": (256, 256, 128), "cpu": (8, 32, 16)}   # batch, max_len, dim
LR = 1e-3


def batch_of(batch, max_len, seed=0):
    """(ids int32 [batch, max_len], labels float32 [batch]) as numpy: the
    first ``batch`` samples of the synthetic reader, collated."""
    it = imdb("train", vocab_size=IMDB_VOCAB, max_len=max_len, seed=seed)()
    return collate([next(it) for _ in range(batch)], max_len)


def build(batch, max_len, dim, device, seed=0):
    """(params, optimizer, state, ids, labels): params ``{"b", "table",
    "w"}`` (the JAX tree's leaf order) as leaf tensors on ``device``,
    Adam(1e-3) and its state, and one collated batch."""
    from paddle_tpu_torch import optimizer
    gen = torch.Generator().manual_seed(seed)
    vocab = IMDB_VOCAB + 1
    params = {"b": torch.zeros(1),
              "table": torch.randn(vocab, dim, generator=gen) * 0.1,
              "w": torch.randn(dim, 1, generator=gen) * 0.1}
    params = {k: v.to(device).requires_grad_() for k, v in params.items()}
    opt = optimizer.Adam(learning_rate=LR)
    state = opt.init(params)
    ids, labels = batch_of(batch, max_len, seed)
    return (params, opt, state, torch.from_numpy(ids).to(device),
            torch.from_numpy(labels).to(device))


def loss_fn(params, ids, labels):
    """The mean log-sigmoid binary cross-entropy of the classifier's
    logit (``run_benchmarks.py:618-623``)."""
    pooled = embedding_seqpool(ids, params["table"], True)
    logit = (pooled @ params["w"] + params["b"])[:, 0]
    return -torch.mean(labels * F.logsigmoid(logit)
                       + (1 - labels) * F.logsigmoid(-logit))


def train_step(params, opt, state, ids, labels, fused=False):
    """One Adam step in place; returns the loss (a device scalar)."""
    loss, _, _, _ = opt.minimize(loss_fn, params, state, ids, labels,
                                 fused=fused)
    return loss


def run(device="cuda", steps=None, seed=0):
    """Build, warm up, time ``steps`` steps; returns the result dict."""
    from paddle_tpu_torch.bench import fused_opt_from_env
    from paddle_tpu_torch.core.device import (card_name_and_power,
                                              resolve_device)
    dev = resolve_device(device)
    on_gpu = dev.type == "cuda"
    batch, max_len, dim = SIZES[dev.type]
    steps = steps or (20 if on_gpu else 3)
    fused = fused_opt_from_env()
    params, opt, state, ids, labels = build(batch, max_len, dim, dev, seed)

    def sync():
        if on_gpu:
            torch.cuda.synchronize(dev)

    float(train_step(params, opt, state, ids, labels, fused))
    sync()
    t0 = time.perf_counter()
    for _ in range(steps):
        loss = train_step(params, opt, state, ids, labels, fused)
    final_loss = float(loss)
    sync()
    dt = time.perf_counter() - t0
    if final_loss != final_loss:
        raise RuntimeError("NaN loss")
    result = {"metric": "imdb_train_samples_per_sec",
              "value": batch * steps / dt, "unit": "samples/s",
              "batch": batch, "max_len": max_len, "dim": dim,
              "vocab": IMDB_VOCAB + 1, "steps": steps, "fused_opt": fused,
              "final_loss": final_loss}
    if on_gpu:
        result["device"] = torch.cuda.get_device_name(dev)
        result["nvidia_smi"] = card_name_and_power()
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    print(json.dumps(run(args.device, args.steps, args.seed)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
