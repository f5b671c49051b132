"""BERT-base pretraining throughput on one card (counterpart of the ``bert``
workload, ``benchmark/run_benchmarks.py:404-451``, ``BASELINE.json``
config 3).

    python3 -m paddle_tpu_torch.bert_bench                # batch 32 x 128
    python3 -m paddle_tpu_torch.bert_bench --use-pallas   # flash attention
    python3 -m paddle_tpu_torch.bert_bench --device cpu   # tiny, 8 x 32

The step: ``BertForPretraining(BertConfig.base(dtype=bfloat16))`` (vocab
30522, hidden 768, 12 layers, 12 heads, FFN 3072) in eval mode, so dropout
is the identity as in the JAX step's ``apply`` (``training=False``); ids
all ones, MLM labels 0, MLM weights 1, NSP labels 0, no masked positions
(the MLM head runs over every position); ``BertForPretraining.loss`` (MLM +
NSP); ``AdamW(1e-4, weight_decay=0.01)`` through ``Optimizer.minimize``,
unfused as in the JAX benchmark. ``--use-pallas`` builds the model with
``use_pallas=True``: every attention takes the flash kernels with the kv
mask of ``input_ids != 0`` (12 forward, 12 dQ and 12 dK/dV launches a
step); its LayerNorms see ``[B, T, H]`` inputs and take the plain route.
The bench's own configuration (``use_pallas=False``) launches none of the
port's kernels. ``--device cpu`` runs the JAX benchmark's tiny size:
``BertConfig.tiny()`` in float32, batch 8 x 32. No environment variable is
read.

Prints one JSON line: tokens/s (``batch * seqlen`` times the timed steps
over their summed wall time, after two warm-up steps), the last loss, and
on the card MFU, its name and its power limit as ``nvidia-smi`` gives
them. MFU takes ``estimate_transformer_flops`` (a copy of
``run_benchmarks.py:216-233``, ``n_enc=12, n_dec=0``: 2.72e12 FLOPs a step
at the base size) over the card's dense bf16 peak
(``paddle_tpu_torch/bench.py``'s ``peak_for``).
"""

from __future__ import annotations

import argparse
import json
import time

import torch

SIZES = {"cuda": (32, 128), "cpu": (8, 32)}        # batch, seqlen
LR, WEIGHT_DECAY = 1e-4, 0.01
WARMUP = 2


def estimate_transformer_flops(*, n_enc, n_dec, d_model, d_inner, vocab,
                               batch, seqlen):
    """Train-step FLOPs of an encoder-decoder transformer: 2 a MAC over
    the matmul parameters (attention projections, FFN, the vocab
    projection) and the attention score/value products, times 3 for the
    backward (``benchmark/run_benchmarks.py:216-233``)."""
    enc = n_enc * (4 * d_model ** 2 + 2 * d_model * d_inner)
    dec = n_dec * (8 * d_model ** 2 + 2 * d_model * d_inner)
    per_token = 2.0 * (enc + dec + d_model * vocab)
    attn = (n_enc + 2 * n_dec) * 4.0 * seqlen * d_model
    return 3.0 * batch * seqlen * (per_token + attn)


def step_flops(cfg, batch, seqlen):
    return estimate_transformer_flops(
        n_enc=cfg.num_layers, n_dec=0, d_model=cfg.hidden_size,
        d_inner=cfg.intermediate_size, vocab=cfg.vocab_size, batch=batch,
        seqlen=seqlen)


def config(device_type, use_pallas=False):
    """BERT-base in bf16 on the card; ``BertConfig.tiny()`` (float32) on
    the CPU, as the JAX benchmark's tiny mode."""
    from paddle_tpu_torch.models import BertConfig
    if device_type == "cuda":
        return BertConfig.base(dtype=torch.bfloat16, use_pallas=use_pallas)
    return BertConfig.tiny(use_pallas=use_pallas)


def build(cfg, batch, seqlen, device, seed=0):
    """(model, params, optimizer, state, batch) of the benchmark's step:
    the model (eval mode), its parameter tree, AdamW and its state, and
    (ids, mlm_labels, mlm_weights, nsp_labels) as the JAX step makes
    them."""
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.convert import param_tree
    from paddle_tpu_torch.models import BertForPretraining
    model = BertForPretraining(cfg, device=device, seed=seed)
    params = param_tree(model)
    opt = optimizer.AdamW(learning_rate=LR, weight_decay=WEIGHT_DECAY)
    state = opt.init(params)
    data = (torch.ones(batch, seqlen, dtype=torch.int32, device=device),
            torch.zeros(batch, seqlen, dtype=torch.int32, device=device),
            torch.ones(batch, seqlen, dtype=torch.float32, device=device),
            torch.zeros(batch, dtype=torch.int32, device=device))
    return model, params, opt, state, data


def loss_fn(model):
    """``loss(params, ids, mlm_labels, mlm_weights, nsp_labels)``: the MLM
    + NSP loss of the model, whose parameters are the ones in
    ``params``."""
    def fn(params, ids, mlm_labels, mlm_weights, nsp_labels):
        mlm, nsp = model(ids)
        return model.loss(mlm, nsp, mlm_labels, mlm_weights, nsp_labels)[0]
    return fn


def train_step(model, params, opt, state, data):
    """One unfused AdamW step in place; returns the loss (a device
    scalar)."""
    loss, _, _, _ = opt.minimize(loss_fn(model), params, state, *data)
    return loss


def run(device="cuda", use_pallas=False, steps=None, seed=0):
    """Build, warm up, time ``steps`` steps; returns the result dict."""
    from paddle_tpu_torch.bench import peak_for
    from paddle_tpu_torch.core.device import (card_name_and_power,
                                              resolve_device)
    dev = resolve_device(device)
    on_gpu = dev.type == "cuda"
    batch, seqlen = SIZES[dev.type]
    steps = steps or (20 if on_gpu else 3)
    cfg = config(dev.type, use_pallas)
    model, params, opt, state, data = build(cfg, batch, seqlen, dev, seed)

    def sync():
        if on_gpu:
            torch.cuda.synchronize(dev)

    for _ in range(WARMUP):
        float(train_step(model, params, opt, state, data))
    sync()
    t0 = time.perf_counter()
    for _ in range(steps):
        loss = train_step(model, params, opt, state, data)
    final_loss = float(loss)
    sync()
    dt = time.perf_counter() - t0
    if final_loss != final_loss:
        raise RuntimeError("NaN loss")
    result = {"metric": "bert_train_tokens_per_sec",
              "value": batch * seqlen * steps / dt, "unit": "tokens/s",
              "batch": batch, "seqlen": seqlen, "steps": steps,
              "use_pallas": use_pallas, "dtype": str(cfg.dtype)[6:],
              "flops_per_step": step_flops(cfg, batch, seqlen),
              "final_loss": final_loss}
    if on_gpu:
        name = torch.cuda.get_device_name(dev)
        part, peak = peak_for(name)
        result["device"] = name
        result["nvidia_smi"] = card_name_and_power()
        if peak is not None:
            result["mfu"] = result["flops_per_step"] * steps / dt / peak
            result["peak_part"] = part
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--use-pallas", action="store_true")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    print(json.dumps(run(args.device, args.use_pallas, args.steps,
                         args.seed)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
