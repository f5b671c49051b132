#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``paddle_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py          # one card; exits 0 only if all pass

Phases, each of which fails the run (non-zero exit) on its own:

1. build    every kernel of the paths from ``paddle_tpu_torch/csrc`` (one
            ``nvcc`` per source, all started together);

Then the ResNet-50 path (``paddle_tpu_torch/bench.py``'s step with the conv
kernels on: ``csrc/brgemm.cu`` for the 1x1 convs, ``csrc/conv_kxk.cu`` for
the 3x3 ones, forward, dx and dw):

R1. kernels  each conv kernel against its plain version at every distinct
             conv shape of ResNet-50 at 224 (batch 8), forward, dx and dw,
             in float32 and bfloat16, plus the epilogue (scale, bias,
             residual, relu) and the cotangent fold at a strided 1x1 and a
             strided 3x3; max-pool ties on NHWC CUDA tensors;
R2. train    float32 ResNet-50 at batch 32 x 224 (full width and depth):
             two Momentum steps through the kernels and through their plain
             versions from the same state, and both again with the batch
             permuted (the rounding floor: the same function, its batch
             sums in another order); the first loss, every first-step
             gradient leaf, the BN running stats and the last loss gated
             (a fixed tolerance, or twice the floor); 108 brgemm and 16 of
             each 3x3 kernel launched a step;
R3. bench    the bf16 bench step at batch 256 x 224 in the lowp default and
             in pure bf16: the main path's counted step (launches as in
             R2), timed steps (imgs/s over all of them), one profiled step
             each (device busy time, idle share over its own wall time),
             and in pure bf16 an eval forward through
             the conv+BN+relu epilogue (36 + 16 launches);
R4. numbers  each conv kernel's device time a launch, from its own launches
             in the profiled lowp step, beside the mean over the step's
             launches of its bound, its plain version and a library call
             (``torch.matmul``, cuDNN) that the port never calls.

Then the serving path:

2. kernels  the flash forward, through the wrapper the model calls, against
            its plain PyTorch version on the card, at the serving path's
            shapes, in float32 (TF32 off) and bfloat16, with a fully
            masked row and a causal case;
3. serving  Transformer-base (full width, 6+6 layers, bf16, flash
            attention, random weights from ``--seed``) behind
            ``BatchingGeneratorServer(max_batch=64)``: a few dozen requests
            of 8-64 tokens from several threads, one ``max_new`` request
            and one that expires under ``ttl``; the flash kernel's launch
            count over this phase must equal 6 per batch plus 12 per
            decode step;
4. e2e      the same model in float32: one ``generate()`` of a 64x64 batch
            through the kernel and through its plain version must give
            identical tokens; in bf16 the per-step logit difference and the
            token agreement are reported;
5. numbers  the forward kernel's device time (torch.profiler), its plain
            version's, and
            ``torch.nn.functional.scaled_dot_product_attention``'s as a
            yardstick (the port never calls it), at each path shape,
            beside the least time the card could take for the work these
            inputs need (masked keys excluded); the same calls timed
            with their launch cost (CUDA events); a steady-state 64x64
            ``generate()``: latency, tokens/s, the device's busy time and
            idle share, and the kernels that take the time.

Then the training path, ``transformer_long`` at full width and depth
(vocab 8192, 6+6 layers, d_model 512, 8 heads, remat saving the flash
outputs, flash attention, batch 4 x 4096, Adam):

T1. kernels  the flash backward's dq and dk/dv kernels against their plain
             version at the path's flash shape [4*8, 4096, 4096, 64], at a
             ragged masked shape and at a causal one, in float32 and
             bfloat16 (and the forward at the path's shape); the fused
             optimizer update against the plain unfused sweep (Adam on the
             transformer_long parameters, SGD, Momentum with a global-norm
             clip and AdamW on a small tree): moments bitwise, parameters
             within 4 ulp;
T2. train    three Adam steps in float32 with the fused update, three with
             the unfused one, and three through the kernels' plain
             versions, from the same state: every loss within 1e-4
             relative of the plain route's; the first gradients (leaf by
             leaf) and the parameters after step 3 within ``NOISE_FACTOR``
             times the difference that reordering the keys makes in both
             routes (two more runs), the key biases within
             ``ADAM_PAIR_BOUND``; the parameters after step 1 equal
             wherever the two gradients agree; kernel launches counted per
             step (12
             flash forward, 12 dq, 12 dk/dv, one fused update); loss and
             gradients of remat "save_flash", "none" (24 forward launches)
             and no remat held equal; three bf16 steps reported;
T3. numbers  one profiled bf16 training step: step time, tokens/s, device
             busy time and idle share, top kernels, and each kernel's
             device time at the path's shape; beside it its bound, and its
             plain version and a library yardstick that the port never
             calls (SDPA forward and backward,
             ``torch.optim.Adam(fused=True)``) timed with CUDA events.

The last lines are the ``{"kernels": [...]}`` object, the card's name and
power limit as ``nvidia-smi`` gives them, and the result object
``{"ok": true, "device": {...}}``. A full report goes to
``chip_smoke_out/chip_smoke.json`` (``--out-dir``). Without a CUDA device,
or without the ``paddle_tpu_torch`` package beside this file, the script
exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import subprocess
import sys
import threading
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))

# Published H100 SXM rates (NVIDIA data sheet): HBM bandwidth and dense
# peaks per input type (bf16 on the tensor cores, float32 off them).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

KERNELS = {
    "flash_fwd": {
        "route": "cuda",
        "source": "paddle_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "paddle_tpu/kernels/attention.py:272",
    },
    "flash_bwd_dq": {
        "route": "cuda",
        "source": "paddle_tpu_torch/csrc/flash_bwd.cu",
        "replaces": "paddle_tpu/kernels/attention.py:345",
    },
    "flash_bwd_dkv": {
        "route": "cuda",
        "source": "paddle_tpu_torch/csrc/flash_bwd.cu",
        "replaces": "paddle_tpu/kernels/attention.py:367",
    },
    "fused_update": {
        "route": "cuda",
        "source": "paddle_tpu_torch/csrc/fused_update.cu",
        "replaces": "paddle_tpu/kernels/fused_update.py:200",
    },
    "brgemm": {
        "route": "cuda",
        "source": "paddle_tpu_torch/csrc/brgemm.cu",
        "replaces": "paddle_tpu/kernels/tiles.py:359",
    },
    "convkxk": {
        "route": "cuda",
        "source": "paddle_tpu_torch/csrc/conv_kxk.cu",
        "replaces": "paddle_tpu/kernels/conv_fused.py:241",
    },
    "convkxk_dx": {
        "route": "cuda",
        "source": "paddle_tpu_torch/csrc/conv_kxk.cu",
        "replaces": "paddle_tpu/kernels/conv_fused.py:425",
    },
    "convkxk_dw": {
        "route": "cuda",
        "source": "paddle_tpu_torch/csrc/conv_kxk.cu",
        "replaces": "paddle_tpu/kernels/conv_fused.py:506",
    },
}
# csrc/<name>.cu of every kernel above, one nvcc each
SOURCES = sorted({os.path.basename(m["source"])[:-3]
                  for m in KERNELS.values()})

# (name, b, h, tq, tk, d, causal, mask): the serving path's attention shapes
# at Transformer-base with 64x64 buckets, plus a causal Tq == Tk case
PATH_SHAPES = [
    ("encoder_self", 64, 8, 64, 64, 64, False, "padding"),
    ("decoder_cross", 64, 8, 1, 64, 64, False, "padding"),
    ("decoder_self", 64, 8, 1, 64, 64, False, "prefix"),
]
CHECK_SHAPES = PATH_SHAPES + [
    ("causal", 64, 8, 64, 64, 64, True, None),
    ("causal_ragged", 3, 2, 40, 40, 16, True, None),
    ("ragged_d100", 3, 2, 5, 70, 100, False, "padding"),
]
TOLERANCE = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


def log(*parts):
    print(*parts, flush=True)


def fail(phase, msg):
    raise SystemExit(f"chip_smoke: phase {phase} FAILED: {msg}")


# -- inputs -----------------------------------------------------------------

def make_mask(kind, b, tk, gen, dev):
    """padding: random source lengths 8..tk with row 0 all pad (as the
    Generator's padded batch rows); prefix: a decode cache filled to half;
    all: every key kept (the training path's source mask); ragged: random
    lengths 1..tk, so every row keeps a key."""
    if kind is None:
        return None
    if kind == "all":
        return torch.ones(b, tk, dtype=torch.bool, device=dev)
    if kind == "ragged":
        lens = torch.randint(1, tk + 1, (b,), generator=gen, device=dev)
        return torch.arange(tk, device=dev)[None] < lens[:, None]
    if kind == "prefix":
        return (torch.arange(tk, device=dev) <= tk // 2)[None].expand(
            b, tk).contiguous()
    lens = torch.randint(min(8, tk), tk + 1, (b,), generator=gen,
                         device=dev)
    lens[0] = 0
    return torch.arange(tk, device=dev)[None] < lens[:, None]


def make_qkv(shape, dtype, dev, seed):
    _, b, h, tq, tk, d, causal, mask_kind = shape
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn(b, h, t, d, device=dev, generator=g).to(dtype)
               for t in (tq, tk, tk))
    return q, k, v, make_mask(mask_kind, b, tk, g, dev)


def make_src(b, rs, max_len=64, min_len=8, vocab=32000):
    src = np.zeros((b, max_len), np.int32)
    for i in range(b):
        n = rs.randint(min_len, max_len + 1)
        src[i, :n] = rs.randint(3, vocab, n)
    return src


# -- phase 1 ----------------------------------------------------------------

def phase_build():
    from paddle_tpu_torch.core import native_build
    t0 = time.perf_counter()
    native_build.build(SOURCES)
    seconds = time.perf_counter() - t0
    log(f"[build] {len(SOURCES)} kernel sources built in parallel in "
        f"{seconds:.2f} s")
    for name, info in native_build.build_info.items():
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")
    return {"seconds": seconds,
            "per_kernel": {n: i["seconds"]
                           for n, i in native_build.build_info.items()}}


# -- phase 2 ----------------------------------------------------------------

def phase_kernels(dev, seed):
    from paddle_tpu_torch.kernels.attention import (flash_attention,
                                                    flash_attention_reference,
                                                    flash_fwd_cuda)
    results, worst = [], {}
    for dtype in (torch.float32, torch.bfloat16):
        for shape in CHECK_SHAPES:
            name, b, h, tq, tk, d, causal, _ = shape
            q, k, v, m = make_qkv(shape, dtype, dev, seed)
            before = flash_attention.launches
            o = flash_attention(q, k, v, causal, d ** -0.5, kv_mask=m,
                                device=dev)
            if flash_attention.launches != before + 1:
                fail(2, f"flash_attention did not launch the kernel ({name})")
            _, lse = flash_fwd_cuda(q, k, v, causal, d ** -0.5, m)
            torch.cuda.synchronize()
            ro, rl = flash_attention_reference(q, k, v, causal, d ** -0.5, m)
            torch.cuda.synchronize()
            diff = (o.float() - ro.float()).abs()
            o_err = (diff / (1 + ro.float().abs())).max().item()
            lse_err = ((lse - rl).abs() / rl.abs().clamp(min=1)).max().item()
            ok = (bool(torch.isfinite(o).all()) and
                  bool(torch.isfinite(lse).all()) and
                  o_err <= TOLERANCE[dtype] and lse_err <= 1e-5)
            if m is not None and not bool(m[0].any()):
                # the fully masked row: uniform mean of V, lse ~ -1e30
                mean_v = v[0].float().mean(dim=1, keepdim=True).to(dtype)
                row_err = (o[0].float() - mean_v.float()).abs().max().item()
                ok = ok and row_err <= TOLERANCE[dtype] * (
                    1 + mean_v.float().abs().max().item()) and \
                    bool((lse[0] < -1e29).all())
            rec = {"case": name, "dtype": str(dtype).split(".")[-1],
                   "shape": [b, h, tq, tk, d], "causal": causal,
                   "max_abs_err": diff.max().item(), "rel_err": o_err,
                   "lse_rel_err": lse_err, "ok": ok}
            results.append(rec)
            log(f"[kernels] flash_fwd {rec['dtype']:>8} {name:<14} "
                f"[{b},{h},{tq},{tk},{d}] max|o-plain| "
                f"{rec['max_abs_err']:.3e}"
                f" rel {o_err:.3e} lse rel {lse_err:.3e} "
                f"(tol {TOLERANCE[dtype]:g}) {'ok' if ok else 'MISMATCH'}")
            if not ok:
                fail(2, f"flash_fwd {rec}")
            if dtype == torch.bfloat16 and shape in PATH_SHAPES:
                worst["flash_fwd"] = max(worst.get("flash_fwd", 0.0),
                                         rec["max_abs_err"])
    return results, worst


# -- phase 3 ----------------------------------------------------------------

def full_width_model(dtype, dev, seed):
    from paddle_tpu_torch.models import Transformer, TransformerConfig
    cfg = TransformerConfig.base(dropout=0.0, dtype=dtype, use_flash=True)
    return Transformer(cfg, device=dev, seed=seed)


def generator_for(model, dev, max_len=64, bucket=64):
    from paddle_tpu_torch.inference import GenerationConfig, Generator
    return Generator(model, GenerationConfig(
        max_len=max_len, batch_buckets=(bucket,), src_len_buckets=(bucket,)),
        device=dev)


def phase_serving(model, dev, seed, n_first=64, n_second=20, threads=4):
    from paddle_tpu_torch.inference import (BatchingGeneratorServer,
                                            RequestExpired)
    from paddle_tpu_torch.kernels.attention import flash_attention
    cfg = model.cfg
    gen = generator_for(model, dev)
    rs = np.random.RandomState(seed)
    gen.generate(make_src(64, rs, vocab=cfg.src_vocab_size))  # warm-up

    # count what the main path runs: generate calls and decode steps
    busy, counts = threading.Event(), {"batches": 0, "steps": 0}
    run_generate, run_step = gen.generate, model.decode_step

    def generate(src):
        counts["batches"] += 1
        busy.set()
        return run_generate(src)

    def decode_step(*a, **kw):
        counts["steps"] += 1
        return run_step(*a, **kw)

    gen.generate, model.decode_step = generate, decode_step
    reqs = [make_src(1, rs, vocab=cfg.src_vocab_size)[0]
            for _ in range(n_first + n_second)]
    reqs = [r[r != 0] for r in reqs]
    srv = BatchingGeneratorServer(gen, max_batch=64, max_wait_ms=20,
                                  device=dev)
    futs = [None] * len(reqs)

    def post(idx):
        for i in idx:
            futs[i] = srv.submit(reqs[i])

    def wave(lo, hi):
        ts = [threading.Thread(target=post, args=(range(lo + t, hi, threads),))
              for t in range(threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)

    flash_attention.launches = 0
    t0 = time.perf_counter()
    try:
        wave(0, n_first)
        if not busy.wait(timeout=120):
            fail(3, "the server never started a batch")
        # the worker is decoding the first batch: this one waits past its ttl
        expiring = srv.submit(reqs[0], ttl=1e-3)
        trimmed = srv.submit(reqs[1], max_new=5)
        wave(n_first, n_first + n_second)
        rows = [f.result(timeout=600) for f in futs]
        trimmed_row = trimmed.result(timeout=600)
        try:
            expiring.result(timeout=600)
            fail(3, "the ttl request was decoded instead of expiring")
        except RequestExpired:
            pass
        wall = time.perf_counter() - t0
    finally:
        srv.stop()
        del gen.generate, model.decode_step   # back to the class methods
    launches = flash_attention.launches
    vocab = cfg.trg_vocab_size
    for r in rows + [trimmed_row]:
        if (r.shape != (64,) or r[0] != 1 or (r < 0).any()
                or (r >= vocab).any()):
            fail(3, f"bad row {r}")
    if (trimmed_row[5:] != 0).any():
        fail(3, "max_new=5 did not trim the row")
    expected = (cfg.n_layer * counts["batches"]
                + 2 * cfg.n_layer * counts["steps"])
    if launches == 0 or launches != expected:
        fail(3, f"flash_fwd launches {launches}, expected {expected} "
                f"({counts['batches']} batches, {counts['steps']} steps)")
    n_tok = int(sum((r[1:] != 0).sum() for r in rows + [trimmed_row]))
    out = {"requests": len(rows) + 2, "batches": counts["batches"],
           "decode_steps": counts["steps"], "flash_fwd_launches": launches,
           "generated_tokens": n_tok, "wall_s": wall,
           "tokens_per_s": n_tok / wall}
    log(f"[serving] {out['requests']} requests (1 expired as asked, 1 "
        f"trimmed) in {counts['batches']} batches, {counts['steps']} decode "
        f"steps; flash_fwd launches {launches} = 6 x batches + 12 x steps; "
        f"{n_tok} tokens in {wall:.3f} s = {out['tokens_per_s']:.1f} tokens/s")
    return out


# -- phase 4 ----------------------------------------------------------------

@torch.no_grad()
def step_logits(model, src, tokens):
    """Logits of every decode step, teacher-forced on ``tokens``."""
    dev = model.device
    src_t = torch.from_numpy(src).to(dev)
    mask = src_t != 0
    enc = model.encode(src_t, mask)
    caches, ckv = model.init_decode_state(enc, tokens.shape[1])
    tok = torch.from_numpy(tokens).to(dev)
    out = []
    for i in range(tokens.shape[1] - 1):
        logits, caches = model.decode_step(tok[:, i], i, caches, ckv, mask)
        out.append(logits.float())
    return out


def phase_e2e(model_bf16, dev, seed):
    from paddle_tpu_torch.kernels.attention import flash_attention
    rs = np.random.RandomState(seed + 1)
    src = make_src(64, rs, vocab=model_bf16.cfg.src_vocab_size)
    result = {}
    model32 = full_width_model(torch.float32, dev, seed)
    for label, model in (("float32", model32), ("bfloat16", model_bf16)):
        gen = generator_for(model, dev)
        before = flash_attention.launches
        t_kernel = gen.generate(src)
        launched = flash_attention.launches - before
        with plain_kernels():
            t_plain = gen.generate(src)
        if flash_attention.launches != before + launched or launched == 0:
            fail(4, "the kernel run did not launch, or the plain run did")
        same = float((t_kernel == t_plain).mean())
        rows_same = int((t_kernel == t_plain).all(axis=1).sum())
        lk = step_logits(model, src, t_kernel)
        with plain_kernels():
            lp = step_logits(model, src, t_kernel)
        diffs = [(a - b).abs().max().item() for a, b in zip(lk, lp)]
        finite = all(bool(torch.isfinite(a).all()) for a in lk)
        result[label] = {"token_agreement": same, "rows_identical": rows_same,
                         "logit_max_abs_diff_per_step": diffs,
                         "logits_finite": finite}
        log(f"[e2e] {label}: 64x64 generate through flash_fwd vs its plain "
            f"version: token agreement {same:.6f}, {rows_same}/64 rows "
            f"identical; per-step max|logit diff| max {max(diffs):.3e} "
            f"mean {sum(diffs) / len(diffs):.3e} first {diffs[0]:.3e}")
        if not finite:
            fail(4, f"{label} logits are not finite")
        if label == "float32" and same != 1.0:
            fail(4, "float32 tokens differ between the kernel and its plain "
                    "version")
    del model32
    torch.cuda.empty_cache()
    return result


# -- phase 5 ----------------------------------------------------------------

def time_ms(fn, arg_sets, iters):
    """Time per call including its launch from Python (CUDA events around
    a loop of calls), cycling through ``arg_sets`` so the inputs come from
    HBM rather than L2."""
    for a in arg_sets:
        fn(*a)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*arg_sets[i % len(arg_sets)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def attention_bound(q, k, mask, causal):
    """Least time of one call on these inputs: the bytes it must move over
    HBM, or its flops over the peak for the input type, whichever is
    larger. Only what the output depends on counts: a key that a query
    masks needs neither its K row nor its V row nor a score. A query with
    no key kept returns the mean of V, so it needs all of V's rows, no K
    and no scores. Bytes: q, the K and V rows some query needs, o, lse and
    the mask, each once; flops: 4 * D per kept score (q.k and p.v) and D
    per V row averaged."""
    b, h, tq, d = q.shape
    tk = k.shape[2]
    keep = torch.ones(b, tq, tk, dtype=torch.bool, device=q.device)
    if causal:
        keep &= torch.ones(tq, tk, dtype=torch.bool, device=q.device).tril()
    if mask is not None:
        keep &= mask.bool()[:, None, :]
    kept = keep.sum(-1)                                   # [b, tq]
    empty = kept == 0
    k_rows = keep.any(1).sum(-1)                          # [b]
    v_rows = torch.where(empty.any(1), tk, k_rows)
    nbytes = (q.element_size() * h * d * (2 * b * tq + int(k_rows.sum())
                                          + int(v_rows.sum()))
              + 4 * b * h * tq + (mask.numel() * mask.element_size()
                                  if mask is not None else 0))
    flops = h * d * (4 * int(kept.sum()) + tk * int(empty.sum()))
    return nbytes, flops


def bound_ms(nbytes, flops, dtype):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _device_us(entry):
    return getattr(entry, "self_device_time_total",
                   getattr(entry, "self_cuda_time_total", 0.0))


def profiled(fn, label):
    """Run ``fn()`` under torch.profiler; returns (device time in ms summed
    over every kernel and copy, [(name, count, device ms)] by time, the
    wall time of the profiled call in ms). A session without device
    activity is logged; the caller fails."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    rows = [(e.key, e.count, _device_us(e) / 1e3) for e in events
            if e.device_type == DeviceType.CUDA and _device_us(e) > 0]
    if not rows:
        log(f"[profile] the session of {label} recorded no device activity "
            f"({len(events)} event kinds, device types "
            f"{sorted({str(e.device_type) for e in events})})")
    rows.sort(key=lambda r: -r[2])
    return sum(r[2] for r in rows), rows, wall_ms


def device_ms(fn, arg_sets, iters, label):
    """Device time of one call (all its kernels), from the profiler."""
    def run():
        for i in range(iters):
            fn(*arg_sets[i % len(arg_sets)])
    total, _, _ = profiled(run, label)
    if total <= 0:
        fail(5, f"torch.profiler recorded no device time for {label}")
    return total / iters


def phase_numbers(dev, seed, iters=200):
    """Per path shape: device time per call (profiler) of the kernel, its
    plain version and SDPA, and the same calls' time per call with the
    host's launch cost included (CUDA events around a loop of calls)."""
    from paddle_tpu_torch.kernels.attention import (flash_attention_reference,
                                                    flash_fwd_cuda)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        for shape in PATH_SHAPES:
            name, b, h, tq, tk, d, causal, _ = shape
            base = make_qkv(shape, dtype, dev, seed)
            per_call = sum(t.numel() * t.element_size()
                           for t in base[:3])
            copies = max(2, min(32, math.ceil(120e6 / per_call)))
            sets = [make_qkv(shape, dtype, dev, seed + i)
                    for i in range(copies)]
            lib_sets = [(q, k, v, m[:, None, None, :]) for q, k, v, m in sets]
            scale = d ** -0.5
            fns = {
                "kernel": (lambda q, k, v, m: flash_fwd_cuda(
                    q, k, v, causal, scale, m), sets),
                "plain": (lambda q, k, v, m: flash_attention_reference(
                    q, k, v, causal, scale, m), sets),
                "library": (lambda q, k, v, m: sdpa(
                    q, k, v, attn_mask=m, scale=scale), lib_sets),
            }
            call = {k: time_ms(f, a, iters) for k, (f, a) in fns.items()}
            t = {k: device_ms(f, a, iters, f"{name} {k}")
                 for k, (f, a) in fns.items()}
            # the calls cycle through the sets: the bound of the mean call
            work = [attention_bound(q, k, m, causal) for q, k, _, m in sets]
            nbytes = sum(w[0] for w in work) / len(work)
            flops = sum(w[1] for w in work) / len(work)
            bound, bound_by = bound_ms(nbytes, flops, dtype)
            rec = {"case": name, "dtype": str(dtype).split(".")[-1],
                   "shape": [b, h, tq, tk, d],
                   "ms": t["kernel"], "plain_ms": t["plain"],
                   "library_ms": t["library"], "bound_ms": bound,
                   "bound_by": bound_by, "bytes": nbytes, "flops": flops,
                   "bound_share": bound / t["kernel"],
                   "call_ms": call["kernel"], "plain_call_ms": call["plain"],
                   "library_call_ms": call["library"]}
            rows.append(rec)
            log(f"[numbers] flash_fwd {rec['dtype']:>8} {name:<14} "
                f"[{b},{h},{tq},{tk},{d}] device time: kernel "
                f"{t['kernel'] * 1e3:.2f} us, plain {t['plain'] * 1e3:.2f} "
                f"us, sdpa {t['library'] * 1e3:.2f} us; bound "
                f"{bound * 1e3:.2f} us ({bound_by}) = "
                f"{rec['bound_share'] * 100:.1f}% of the kernel's time; per "
                f"call with launch: kernel {call['kernel'] * 1e3:.2f} us, "
                f"plain {call['plain'] * 1e3:.2f} us, sdpa "
                f"{call['library'] * 1e3:.2f} us")
    return rows


def phase_generate_profile(model, dev, seed, use_bf16, repeats=3):
    """Steady-state ``generate()`` of a 64x64 batch: host-clock latency
    and tokens/s, then one profiled run for the device's busy time (the
    idle share is over that run's own wall time) and the kernels that
    take it. ``use_bf16`` casts the weights once
    instead of at every Linear call."""
    from paddle_tpu_torch.inference import GenerationConfig, Generator
    from paddle_tpu_torch.kernels.attention import flash_attention
    gen = Generator(model, GenerationConfig(
        max_len=64, batch_buckets=(64,), src_len_buckets=(64,),
        use_bf16=use_bf16), device=dev)
    src = make_src(64, np.random.RandomState(seed + 2),
                   vocab=model.cfg.src_vocab_size)
    gen.generate(src)
    lat, tps = [], []
    for _ in range(repeats):
        gen.generate(src)
        lat.append(gen.last_latency_ms)
        tps.append(gen.last_tokens_per_s)
    before = flash_attention.launches
    busy, kernels, wall = profiled(lambda: gen.generate(src), "generate()")
    launches = flash_attention.launches - before
    if busy <= 0:
        fail(5, "torch.profiler recorded no device time for generate()")
    flash = [r for r in kernels if "flash_fwd_kernel" in r[0]]
    flash_ms = sum(r[2] for r in flash)
    out = {"use_bf16": use_bf16, "latency_ms": lat, "tokens_per_s": tps,
           "device_busy_ms": busy,
           "idle_share": 1.0 - busy / wall, "flash_fwd_device_ms": flash_ms,
           "flash_fwd_launches": launches,
           "top_kernels": [{"name": n[:120], "count": c, "device_ms": t}
                           for n, c, t in kernels[:12]]}
    log(f"[numbers] generate 64x64 bf16 (use_bf16={use_bf16}), max_len 64: "
        f"latency "
        f"{', '.join(f'{x:.1f}' for x in lat)} ms; "
        f"{', '.join(f'{x:.1f}' for x in tps)} tokens/s; device busy "
        f"{busy:.2f} ms of {wall:.1f} ms (idle share "
        f"{out['idle_share']:.3f}); "
        f"flash_fwd {flash_ms:.2f} ms in {launches} launches")
    for n, c, t in kernels[:12]:
        log(f"[numbers]   {t:9.3f} ms {c:6d}x  {n[:100]}")
    return out


# -- training phases T1-T3 --------------------------------------------------
#
# transformer_long (benchmark/run_benchmarks.py:298-309) at full width and
# depth: vocab 8192, 6+6 layers of d_model 512, d_inner 2048, 8 heads of 64,
# per-layer remat saving the flash outputs, flash attention, batch 4 x 4096,
# Adam(1e-3); label smoothing 0.1 (the config's default), dropout 0.

LONG_CFG = dict(src_vocab_size=8192, trg_vocab_size=8192, max_length=4096,
                d_model=512, d_inner=2048, n_head=8, n_layer=6, dropout=0.0,
                remat=True, use_flash=True)
LONG_BATCH, LONG_LEN, LR, STEPS = 4, 4096, 1e-3, 3
# the path's flash shape (encoder self- and cross-attention), every key kept
TRAIN_FLASH = ("train", 4, 8, 4096, 4096, 64, False, "all")
BWD_CHECK_SHAPES = [
    TRAIN_FLASH,
    ("masked_ragged", 3, 4, 200, 300, 64, False, "ragged"),
    ("causal", 2, 8, 512, 512, 64, True, None),
]
# relative to (1 + |plain|): float32 sums of up to 4096 terms in another
# order; bfloat16 outputs round once more (2^-8 relative)
BWD_TOLERANCE = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
ADAM_FLOPS_PER_ELEMENT = 14     # the kernel's Adam expression, per element
# T2's float32 gates, kernel route against the plain route. The routes
# differ only in the order of the attention's float32 sums, and a leaf's
# gradient sums the terms of 16384 tokens, whose signs cancel: a rounding
# of 1e-7 a term shows as ~1e-4 of the leaf. So the difference is held
# against the same routes run with the keys in another order (the same
# attention, its sums reordered), leaf by leaf: at most NOISE_FACTOR times
# sqrt(|kernel - kernel'|^2 + |plain - plain'|^2), about 0.7 of it if the
# routes differ by rounding alone.
NOISE_FACTOR = 2.0
# The key projections' biases have a true gradient of 0 (softmax ignores a
# shift of every key's score), so each route's is rounding noise, held
# below this share of its key weight's gradient norm:
KEY_BIAS, KEY_BIAS_TOL = "k_proj/bias", 1e-4
# After step 1: Adam's first step is lr * g / (|g| + eps), so an element
# whose two gradients agree within STEP1_GRAD_AGREE (relative) moves by the
# same amount within lr * STEP1_GRAD_AGREE / 4 plus a rounding of p:
STEP1_GRAD_AGREE, STEP1_PARAM_TOL = 1e-3, 1e-6
# After step 3, Adam steps about lr whatever a gradient's size, so small
# gradients part first: the parameters other than the key biases are held
# to NOISE_FACTOR as the gradients are (whole tree); the key biases, whose
# gradient is all noise, may part by ADAM_PAIR_BOUND * lr a step (each run
# moves by at most 1.004 lr a step in the first three, by Cauchy-Schwarz on
# the bias-corrected moments).
ADAM_PAIR_BOUND = 2.02


_COUNTED = {}


def counted_wrappers():
    """The wrapper that counts each kernel's launches, taken once, before
    ``plain_kernels`` swaps any of them out."""
    if not _COUNTED:
        from paddle_tpu_torch.kernels import attention as A
        from paddle_tpu_torch.kernels import fused_update as FU
        _COUNTED.update(flash_fwd=A.flash_attention,
                        flash_bwd_dq=A.flash_bwd_dq_cuda,
                        flash_bwd_dkv=A.flash_bwd_dkv_cuda,
                        fused_update=FU.fused_update_step)
    return _COUNTED


def train_counts():
    return {k: f.launches for k, f in counted_wrappers().items()}


def zero_counts():
    for f in counted_wrappers().values():
        f.launches = 0


class plain_kernels:
    """Route the flash kernels to their plain versions, behind the same
    wrappers, autograd op and remat policy."""

    def __enter__(self):
        from paddle_tpu_torch.kernels import attention as A
        counted_wrappers()
        self.A = A
        self.saved = (A.flash_fwd_cuda, A.flash_bwd_dq_cuda,
                      A.flash_bwd_dkv_cuda)
        A.flash_fwd_cuda = A.flash_attention_reference
        A.flash_bwd_dq_cuda = \
            lambda *a: A.flash_attention_bwd_reference(*a)[0]
        A.flash_bwd_dkv_cuda = \
            lambda *a: A.flash_attention_bwd_reference(*a)[1:]
        return self

    def __exit__(self, *exc):
        (self.A.flash_fwd_cuda, self.A.flash_bwd_dq_cuda,
         self.A.flash_bwd_dkv_cuda) = self.saved


class permuted_keys:
    """Feed the trainable flash op, whichever route it takes (kernels or
    their plain versions), the keys, values and key mask in a fixed random
    order; autograd puts dk and dv back. The same attention with its
    float32 sums taken in another order. Non-causal calls only, as on the
    training path."""

    def __init__(self, seed):
        self.seed = seed

    def __enter__(self):
        from paddle_tpu_torch.kernels import attention as A
        self.A, self.op = A, A.flash_attn_op

        def op_p(q, k, v, kv_mask, causal, scale):
            # one order for every call, so a remat recompute sees the
            # inputs of the forward whose outputs it reuses
            assert not causal
            gen = torch.Generator().manual_seed(self.seed)
            p = torch.randperm(k.shape[2], generator=gen).to(k.device)
            return self.op(q, k[:, :, p].contiguous(), v[:, :, p].contiguous(),
                           None if kv_mask is None else
                           kv_mask[:, p].contiguous(), causal, scale)

        A.flash_attn_op = op_p
        return self

    def __exit__(self, *exc):
        self.A.flash_attn_op = self.op


def bwd_inputs(shape, dtype, dev, seed):
    """q, k, v, mask, the output cotangent do, and the forward's lse and
    dvec = sum_d(do * o), as the autograd route feeds the kernels."""
    from paddle_tpu_torch.kernels.attention import flash_fwd_cuda
    q, k, v, m = make_qkv(shape, dtype, dev, seed)
    g = torch.Generator(device=dev).manual_seed(seed + 7)
    do = torch.randn(q.shape, device=dev, generator=g).to(dtype)
    o, lse = flash_fwd_cuda(q, k, v, shape[6], q.shape[-1] ** -0.5, m)
    dvec = (do.float() * o.float()).sum(-1)
    return q, k, v, m, do, lse, dvec


def phase_train_kernels(dev, seed):
    """T1a: dq and dkv against the plain version of the backward, and the
    forward at the training shape against its plain version."""
    from paddle_tpu_torch.kernels.attention import (
        flash_attention_bwd_reference, flash_attention_reference,
        flash_bwd_dkv_cuda, flash_bwd_dq_cuda, flash_fwd_cuda)
    results, worst = [], {}
    for dtype in (torch.float32, torch.bfloat16):
        for shape in BWD_CHECK_SHAPES:
            name, b, h, tq, tk, d, causal, _ = shape
            q, k, v, m, do, lse, dvec = bwd_inputs(shape, dtype, dev, seed)
            scale = d ** -0.5
            if shape is TRAIN_FLASH:
                o, _ = flash_fwd_cuda(q, k, v, causal, scale, m)
                ro, rl = flash_attention_reference(q, k, v, causal, scale, m)
                diff = (o.float() - ro.float()).abs()
                o_err = (diff / (1 + ro.float().abs())).max().item()
                lse_err = ((lse - rl).abs() / rl.abs().clamp(min=1)).max()
                ok = o_err <= TOLERANCE[dtype] and lse_err.item() <= 1e-5
                log(f"[T1] flash_fwd {str(dtype)[6:]:>8} {name:<14} "
                    f"[{b},{h},{tq},{tk},{d}] max|o-plain| "
                    f"{diff.max().item():.3e} rel {o_err:.3e} lse rel "
                    f"{lse_err.item():.3e} {'ok' if ok else 'MISMATCH'}")
                if not ok:
                    fail("T1", f"flash_fwd at the training shape: o {o_err}, "
                               f"lse {lse_err.item()}")
                if dtype == torch.bfloat16:
                    worst["flash_fwd"] = diff.max().item()
                del o, ro, rl, diff
            dq = flash_bwd_dq_cuda(q, k, v, do, lse, dvec, causal, scale, m)
            dk, dv = flash_bwd_dkv_cuda(q, k, v, do, lse, dvec, causal, scale,
                                        m)
            torch.cuda.synchronize()
            want = flash_attention_bwd_reference(q, k, v, do, lse, dvec,
                                                 causal, scale, m)
            rec = {"case": name, "dtype": str(dtype).split(".")[-1],
                   "shape": [b, h, tq, tk, d], "causal": causal}
            ok = True
            for nm, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
                diff = (got.float() - ref.float()).abs()
                rel = (diff / (1 + ref.float().abs())).max().item()
                rec[nm] = {"max_abs_err": diff.max().item(), "rel_err": rel}
                ok = ok and bool(torch.isfinite(got).all()) and \
                    rel <= BWD_TOLERANCE[dtype]
            rec["ok"] = ok
            results.append(rec)
            log(f"[T1] flash_bwd {rec['dtype']:>8} {name:<14} "
                f"[{b},{h},{tq},{tk},{d}] max|kernel-plain| dq "
                f"{rec['dq']['max_abs_err']:.3e} dk "
                f"{rec['dk']['max_abs_err']:.3e} dv "
                f"{rec['dv']['max_abs_err']:.3e}; rel "
                f"{max(rec[n]['rel_err'] for n in ('dq', 'dk', 'dv')):.3e} "
                f"(tol {BWD_TOLERANCE[dtype]:g}) {'ok' if ok else 'MISMATCH'}")
            if not ok:
                fail("T1", f"flash_bwd {rec}")
            if dtype == torch.bfloat16 and shape is TRAIN_FLASH:
                worst["flash_bwd_dq"] = rec["dq"]["max_abs_err"]
                worst["flash_bwd_dkv"] = max(rec["dk"]["max_abs_err"],
                                             rec["dv"]["max_abs_err"])
            del q, k, v, do, dq, dk, dv, want
            torch.cuda.empty_cache()
    return results, worst


def small_tree(dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    shapes = [(300, 7), (70000,), (5,), (1, 131073)]
    return {f"p{i}": torch.randn(s, device=dev, generator=g)
            for i, s in enumerate(shapes)}


def random_grads(params, seed):
    g = torch.Generator(device=next(iter(params.values())).device)
    g.manual_seed(seed)
    return {k: torch.randn(p.shape, device=p.device, generator=g)
            for k, p in params.items()}


def phase_update_kernel(long_params, dev, seed):
    """T1b: the fused update against the plain unfused sweep of the same
    optimizer, two steps from the same state and gradients: moments
    bitwise, parameters within 4 ulp. Adam on the transformer_long tree;
    SGD, Momentum with a global-norm clip and AdamW on a small tree."""
    from paddle_tpu_torch import optimizer as popt
    small = small_tree(dev, seed)
    cases = [
        ("adam", popt.Adam(LR), long_params),
        ("sgd", popt.SGD(0.1), small),
        ("momentum_clip", popt.Momentum(0.1, 0.9, grad_clip=(
            popt.GradientClipByGlobalNorm(1.0))), small),
        ("adamw", popt.AdamW(LR, weight_decay=0.01), small),
    ]
    results, worst = [], None
    for name, opt, tree in cases:
        runs = {}
        for fused in (True, False):
            params = {k: t.detach().clone() for k, t in tree.items()}
            state = opt.init(params)
            for step in range(2):
                opt.apply_gradients(params, random_grads(params, seed + step),
                                    state, fused=fused)
            runs[fused] = (params, state)
        torch.cuda.synchronize()
        (fp, fs), (pp, ps) = runs[True], runs[False]
        accs = [nm for nm in fs if nm != "step"]
        acc_equal = all(torch.equal(fs[nm][k], ps[nm][k])
                        for nm in accs for k in fp)
        ulp = max((fp[k].view(torch.int32).long()
                   - pp[k].view(torch.int32).long()).abs().max().item()
                  for k in fp)
        err = max((fp[k] - pp[k]).abs().max().item() for k in fp)
        n = sum(p.numel() for p in fp.values())
        rec = {"case": name, "elements": n, "moments_bitwise": acc_equal,
               "max_param_ulp": ulp, "max_abs_err": err,
               "ok": acc_equal and ulp <= 4}
        results.append(rec)
        log(f"[T1] fused_update {name:<14} {n} elements, 2 steps vs the "
            f"plain sweep: moments bitwise {acc_equal}, params max {ulp} "
            f"ulp (max|diff| {err:.3e}) {'ok' if rec['ok'] else 'MISMATCH'}")
        if not rec["ok"]:
            fail("T1", f"fused_update {rec}")
        if name == "adam":
            worst = err
        del runs, fp, fs, pp, ps
    torch.cuda.empty_cache()
    return results, worst


def long_model(dtype, dev, seed):
    from paddle_tpu_torch.models import Transformer, TransformerConfig
    model = Transformer(TransformerConfig(dtype=dtype, **LONG_CFG),
                        device=dev, seed=seed)
    return model.train()


def long_batch(dev, seed):
    """src, trg and labels: token ids in 3..8191 from the seed; every
    position real (all-true source and label masks)."""
    rs = np.random.RandomState(seed)
    ids = [torch.from_numpy(rs.randint(3, LONG_CFG["src_vocab_size"],
                                       (LONG_BATCH, LONG_LEN))
                            .astype(np.int32)).to(dev) for _ in range(3)]
    lmask = torch.ones(LONG_BATCH, LONG_LEN, dtype=torch.bool, device=dev)
    return (*ids, lmask)


def loss_fn_for(model, batch):
    src, trg, labels, lmask = batch
    return lambda params: model.loss(model(src, trg), labels, lmask)


def train_steps(model, batch, steps, fused, expect):
    """``steps`` Adam steps through ``Optimizer.minimize``; every step's
    kernel launches must equal ``expect``. Returns (losses, a copy of the
    parameters after each step)."""
    from paddle_tpu_torch import optimizer as popt
    from paddle_tpu_torch.convert import param_tree
    params = param_tree(model)
    opt = popt.Adam(LR)
    state = opt.init(params)
    loss_fn = loss_fn_for(model, batch)
    losses, snaps = [], []
    for i in range(steps):
        before = train_counts()
        loss, _, _, _ = opt.minimize(loss_fn, params, state, fused=fused)
        losses.append(loss.item())
        got = {k: v - before[k] for k, v in train_counts().items()}
        if got != expect:
            fail("T2", f"step {i} launched {got}, expected {expect}")
        if not math.isfinite(losses[-1]):
            fail("T2", f"step {i} loss {losses[-1]}")
        snaps.append({k: p.detach().clone() for k, p in params.items()})
    return losses, snaps


class cfg_override:
    """Run the model with some config fields changed."""

    def __init__(self, model, **kw):
        self.model, self.kw = model, kw

    def __enter__(self):
        import copy
        self.saved = self.model.cfg
        self.model.cfg = copy.copy(self.saved)
        vars(self.model.cfg).update(self.kw)

    def __exit__(self, *exc):
        self.model.cfg = self.saved


def route(name, seed):
    """The flash route of a T2 run: "kernel" or "plain", and either with
    "_perm" (keys in another order)."""
    stack = contextlib.ExitStack()
    if name.startswith("plain"):
        stack.enter_context(plain_kernels())
    if name.endswith("_perm"):
        stack.enter_context(permuted_keys(seed))
    return stack


def initial_grads(model32, init, batch, per_step, calls, seed):
    """Loss and gradients at the initial state under each remat policy and
    through each route, kernel launches checked. Returns them and the
    launches of the main path's runs (the remat policies)."""
    from paddle_tpu_torch.convert import param_tree
    grads, counts = {}, {k: 0 for k in per_step}
    for name, kw, rt, fwd in (
            ("save_flash", {}, "kernel", calls),
            ("none", {"remat_policy": "none"}, "kernel", 2 * calls),
            ("no_remat", {"remat": False}, "kernel", calls),
            ("kernel_perm", {}, "kernel_perm", calls),
            ("plain", {}, "plain", 0),
            ("plain_perm", {}, "plain_perm", 0)):
        model32.load_state_dict(init)
        with cfg_override(model32, **kw), route(rt, seed):
            params = param_tree(model32)
            before = train_counts()
            loss = loss_fn_for(model32, batch)(params)
            g = torch.autograd.grad(loss, list(params.values()))
            got = {k: v - before[k] for k, v in train_counts().items()}
        expect = dict(per_step, flash_fwd=fwd, fused_update=0) if fwd else \
            {k: 0 for k in per_step}
        if got != expect:
            fail("T2", f"gradients {name}: launched {got}, expected {expect}")
        if name in ("save_flash", "none", "no_remat"):
            for k, v in got.items():
                counts[k] += v
        grads[name] = (loss.detach(), dict(zip(params, g)))
        log(f"[T2] gradients {name}: loss {loss.item():.6f}, launches {got}")
    return grads, counts


def tree_dist(a, b, keys):
    return math.sqrt(sum((a[k] - b[k]).double().square().sum().item()
                         for k in keys))


def check_grads(grads):
    """T2's gradient gate: every leaf's kernel-vs-plain difference within
    NOISE_FACTOR of the reordered runs' (see there); the key biases, whose
    true gradient is 0, below KEY_BIAS_TOL of their weights'."""
    gk, gk2, gp, gp2 = (grads[n][1] for n in
                        ("save_flash", "kernel_perm", "plain", "plain_perm"))
    ratio, rel, key_bias = {}, {}, {}
    for k in gp:
        if k.endswith(KEY_BIAS):
            w = k[:-len("bias")] + "weight"
            key_bias[k] = max((g[k].norm() / g[w].norm()).item()
                              for g in (gk, gp))
            continue
        d = tree_dist(gk, gp, [k])
        noise = math.hypot(tree_dist(gk, gk2, [k]), tree_dist(gp, gp2, [k]))
        ratio[k] = d / max(noise, 1e-30)
        rel[k] = d / max(gp[k].norm().item(), 1e-30)
    worst = max(ratio, key=ratio.get)
    worst_kb = max(key_bias, key=key_bias.get)
    out = {"worst_leaf": worst, "worst_noise_ratio": ratio[worst],
           "median_noise_ratio": float(np.median(list(ratio.values()))),
           "worst_rel_diff": max(rel.values()),
           "median_rel_diff": float(np.median(list(rel.values()))),
           "key_bias_worst_leaf": worst_kb,
           "key_bias_over_weight": key_bias[worst_kb],
           "leaves": {k: [rel[k], ratio[k]] for k in rel}}
    log(f"[T2] float32 gradients at the initial state, kernel vs plain "
        f"route, leaf by leaf: |dg|/|g| median {out['median_rel_diff']:.2e}, "
        f"worst {out['worst_rel_diff']:.2e}; against the reordered runs' "
        f"difference median {out['median_noise_ratio']:.2f}, worst "
        f"{ratio[worst]:.2f} ({worst}; tol {NOISE_FACTOR:g}); key biases "
        f"|g|/|g_weight| at most {key_bias[worst_kb]:.2e} (tol "
        f"{KEY_BIAS_TOL:g})")
    if ratio[worst] > NOISE_FACTOR or key_bias[worst_kb] > KEY_BIAS_TOL:
        fail("T2", f"gradients of the kernel route disagree with the plain "
                   f"route: {worst} {ratio[worst]}, {worst_kb} "
                   f"{key_bias[worst_kb]}")
    return out


def compare_params(runs, kernel, gk, gp):
    """T2's parameter gates for the kernel route ``runs[kernel]`` against
    the plain route (see STEP1_* and ADAM_PAIR_BOUND), and where the
    elements that part by more than 1e-5 after the last step lie: by
    leaf, and by the size of their first gradient against their leaf's
    rms."""
    snaps, plain = runs[kernel][1], runs["plain"][1]
    p1, pp1, p3, pp3 = snaps[0], plain[0], snaps[-1], plain[-1]
    unexplained = noisy = step1_apart = 0
    for k in gp:
        d = (p1[k] - pp1[k]).abs()
        settled = (gk[k] - gp[k]).abs() <= STEP1_GRAD_AGREE * gp[k].abs()
        unexplained += int((settled & (d > STEP1_PARAM_TOL)).sum())
        noisy += int((~settled).sum())
        step1_apart += int((d > STEP1_PARAM_TOL).sum())
    n = sum(p.numel() for p in gp.values())
    apart, small, small_all, key_bias_max = {}, 0, 0, 0.0
    for k in gp:
        d = (p3[k] - pp3[k]).abs()
        far = d > 1e-5
        apart[k] = int(far.sum())
        r = gp[k].abs() < 0.1 * gp[k].square().mean().sqrt()
        small += int((far & r).sum())
        small_all += int(r.sum())
        if k.endswith(KEY_BIAS):
            key_bias_max = max(key_bias_max, d.max().item())
    rest = [k for k in gp if not k.endswith(KEY_BIAS)]
    noise = math.hypot(tree_dist(runs["kernel_perm"][1][-1], runs[True][1][-1],
                                 rest),
                       tree_dist(runs["plain_perm"][1][-1], pp3, rest))
    total = sum(apart.values())
    top = sorted(apart, key=apart.get, reverse=True)[:5]
    return {
        "step1": {"elements_apart": step1_apart,
                  "noisy_grad_elements": noisy, "unexplained": unexplained},
        "share_above_1e-5": total / n,
        "max_abs_diff": max((p3[k] - pp3[k]).abs().max().item() for k in gp),
        "key_bias_max_abs_diff": key_bias_max,
        "key_bias_share_of_apart": sum(v for k, v in apart.items()
                                       if k.endswith(KEY_BIAS))
        / max(total, 1),
        "noise_ratio": tree_dist(p3, pp3, rest) / max(noise, 1e-30),
        "top_leaves_apart": {k: apart[k] / p3[k].numel() for k in top},
        "small_grad_share_of_apart": small / max(total, 1),
        "small_grad_share_of_all": small_all / n}


def phase_train(model32, dev, seed):
    """T2: training end to end at full width and depth."""
    batch = long_batch(dev, seed)
    init = {k: v.detach().clone() for k, v in model32.state_dict().items()}
    # one flash call per encoder layer and per cross-attention: 12
    calls = 2 * LONG_CFG["n_layer"]
    per_step = {"flash_fwd": calls, "flash_bwd_dq": calls,
                "flash_bwd_dkv": calls, "fused_update": 1}
    zero_counts()
    out, runs = {}, {}
    for fused in (True, False):
        model32.load_state_dict(init)
        runs[fused] = train_steps(model32, batch, STEPS, fused,
                                  dict(per_step, fused_update=int(fused)))
    path_counts = train_counts()
    for name, fused in (("plain", False), ("kernel_perm", True),
                        ("plain_perm", False)):
        model32.load_state_dict(init)
        with route(name, seed):
            runs[name] = train_steps(
                model32, batch, STEPS, fused, per_step if fused else
                {k: 0 for k in per_step})
    grads, counts = initial_grads(model32, init, batch, per_step, calls, seed)
    for k, v in counts.items():
        path_counts[k] += v
    gk, gp = grads["save_flash"][1], grads["plain"][1]
    out["grads"] = check_grads(grads)
    plain_losses = runs["plain"][0]
    for fused in (True, False):
        losses = runs[fused][0]
        rel = [abs(a - b) / abs(b) for a, b in zip(losses, plain_losses)]
        label = "fused" if fused else "unfused"
        rec = {"losses": losses, "plain_losses": plain_losses,
               "loss_rel_diff": rel, **compare_params(runs, fused, gk, gp)}
        out[f"f32_{label}"] = rec
        log(f"[T2] float32 {label}: losses "
            f"{', '.join(f'{x:.6f}' for x in losses)} vs the plain route "
            f"{', '.join(f'{x:.6f}' for x in plain_losses)} (max rel diff "
            f"{max(rel):.2e}, tol 1e-4)")
        log(f"[T2]   after step 1: {rec['step1']['elements_apart']} "
            f"elements apart by more than {STEP1_PARAM_TOL:g}, "
            f"{rec['step1']['noisy_grad_elements']} whose gradients differ "
            f"by more than {STEP1_GRAD_AGREE:g} relative, "
            f"{rec['step1']['unexplained']} apart without that (must be 0)")
        log(f"[T2]   after step {STEPS}: share above 1e-5 "
            f"{rec['share_above_1e-5']:.3e} (key biases "
            f"{rec['key_bias_share_of_apart']:.2%} of it; first gradient "
            f"under 0.1 rms for {rec['small_grad_share_of_apart']:.2%} of it, "
            f"{rec['small_grad_share_of_all']:.2%} of all elements), max "
            f"|diff| {rec['max_abs_diff']:.3e}; key biases max |diff| "
            f"{rec['key_bias_max_abs_diff']:.3e} (bound "
            f"{ADAM_PAIR_BOUND * LR * STEPS:g}); the rest against the "
            f"reordered runs' difference {rec['noise_ratio']:.2f} (tol "
            f"{NOISE_FACTOR:g}); most apart: {rec['top_leaves_apart']}")
        if max(rel) > 1e-4 or rec["step1"]["unexplained"] or \
                rec["key_bias_max_abs_diff"] > ADAM_PAIR_BOUND * LR * STEPS \
                or rec["noise_ratio"] > NOISE_FACTOR:
            fail("T2", f"{label} route disagrees with the plain route")
    out["reordered_losses"] = {n: runs[n][0]
                               for n in ("kernel_perm", "plain_perm")}
    del runs

    ref_loss, ref_g = grads["save_flash"]
    remat = {}
    for name in ("none", "no_remat"):
        loss, g = grads[name]
        bitwise = torch.equal(loss, ref_loss) and all(
            torch.equal(g[k], ref_g[k]) for k in g)
        worst = max(((g[k] - ref_g[k]).abs().max()
                     / ref_g[k].abs().max().clamp(min=1e-30)).item()
                    for k in g)
        remat[name] = {"bitwise": bitwise, "max_rel_grad_diff": worst,
                       "loss_diff": abs(loss.item() - ref_loss.item())}
        log(f"[T2] remat {name} vs save_flash: bitwise {bitwise}, max "
            f"|dg|/max|g| {worst:.2e}, |dloss| "
            f"{remat[name]['loss_diff']:.2e}")
        # identical arithmetic; only a reordered float32 sum (a library
        # choosing another algorithm) may move the last bits
        if not bitwise and (worst > 1e-5 or
                            remat[name]["loss_diff"] > 1e-6 * ref_loss.abs()):
            fail("T2", f"remat {name} disagrees with save_flash: "
                       f"{remat[name]}")
    out["remat"] = remat
    del grads, ref_g, gk, gp
    torch.cuda.empty_cache()

    model_bf = long_model(torch.bfloat16, dev, seed)
    model_bf.load_state_dict(init)
    before = train_counts()
    losses, _ = train_steps(model_bf, batch, STEPS, True, per_step)
    for k, v in train_counts().items():
        path_counts[k] += v - before[k]
    out["bf16_losses"] = losses
    log(f"[T2] bfloat16 fused: losses {', '.join(f'{x:.6f}' for x in losses)}")
    out["launches"] = path_counts
    for k, v in path_counts.items():
        if v == 0:
            fail("T2", f"{k} was never launched on the training path")
    log(f"[T2] training path launches: {path_counts}")
    return out, model_bf, batch


def attention_bwd_bound(q, k, mask, causal, which):
    """Least work of the dq (``which`` "dq") or dk/dv sweep: q, do, lse and
    dvec of every row, the K and V rows some query keeps and the mask read
    once, the outputs written once; 6 D (dq: q.k, do.v, ds.k) or 8 D (dkv:
    q.k, do.v, p.do, ds.q) flops per kept score."""
    b, h, tq, d = q.shape
    tk = k.shape[2]
    keep = torch.ones(b, tq, tk, dtype=torch.bool, device=q.device)
    if causal:
        keep &= torch.ones(tq, tk, dtype=torch.bool, device=q.device).tril()
    if mask is not None:
        keep &= mask.bool()[:, None, :]
    kv_rows = int(keep.any(1).sum())
    es = q.element_size()
    rows_out = b * tq if which == "dq" else 2 * b * tk
    nbytes = (es * h * d * (2 * b * tq + 2 * kv_rows + rows_out)
              + 8 * b * h * tq
              + (mask.numel() * mask.element_size() if mask is not None
                 else 0))
    flops = h * d * (6 if which == "dq" else 8) * int(keep.sum())
    return nbytes, flops


# the kernels' names in a profile
KERNEL_SYMBOLS = {"flash_fwd": "flash_fwd_kernel",
                  "flash_bwd_dq": "flash_bwd_dq_kernel",
                  "flash_bwd_dkv": "flash_bwd_dkv_kernel",
                  "fused_update": "fused_update_kernel"}


def phase_train_numbers(model32, model_bf, batch, dev, seed):
    """T3: two timed bf16 training steps (tokens/s over both), then one
    profiled step: device busy time and idle share over its own wall
    time, top kernels, and each new kernel's device time at the path's
    shape (its launches in that step). Beside each, its
    bound, its plain version and a library yardstick that the port never
    calls, timed with CUDA events around back-to-back calls on the same
    inputs (device time plus any gaps between launches). The step is the
    run's only profiler session after the serving phases: on the H100,
    short sessions late in a full run of this script recorded no device
    activity."""
    from paddle_tpu_torch import optimizer as popt
    from paddle_tpu_torch.convert import param_tree
    from paddle_tpu_torch.kernels import attention as A
    from paddle_tpu_torch.kernels import fused_update as FU
    params = param_tree(model_bf)
    opt = popt.Adam(LR)
    state = opt.init(params)
    loss_fn = loss_fn_for(model_bf, batch)

    def step():
        opt.minimize(loss_fn, params, state, fused=True)

    step()
    torch.cuda.synchronize()
    wall = []
    for _ in range(2):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
    busy, kernels, prof_ms = profiled(step, "the training step")
    step_ms = sum(wall) / len(wall)
    by_kernel = {}
    for key, sym in KERNEL_SYMBOLS.items():
        rows = [r for r in kernels if sym in r[0]]
        by_kernel[key] = {"count": sum(r[1] for r in rows),
                          "device_ms": sum(r[2] for r in rows)}
        if by_kernel[key]["count"] == 0:
            fail("T3", f"the profile of the step shows no {sym}")
    step_rec = {"wall_ms": wall, "step_ms": step_ms,
                "tokens_per_s": LONG_BATCH * LONG_LEN / step_ms * 1e3,
                "device_busy_ms": busy, "profiled_wall_ms": prof_ms,
                "idle_share": 1.0 - busy / prof_ms,
                "kernels_in_step": by_kernel,
                "top_kernels": [{"name": n[:120], "count": c, "device_ms": t}
                                for n, c, t in kernels[:15]]}
    log(f"[T3] bf16 training step (batch {LONG_BATCH} x {LONG_LEN}): "
        f"{', '.join(f'{x:.1f}' for x in wall)} ms, "
        f"{step_rec['tokens_per_s']:.0f} tokens/s over them; profiled step: "
        f"device busy {busy:.1f} of {prof_ms:.1f} ms (idle share "
        f"{step_rec['idle_share']:.3f})")
    for n, c, t in kernels[:15]:
        log(f"[T3]   {t:9.3f} ms {c:6d}x  {n[:100]}")
    del params, opt, state
    torch.cuda.empty_cache()

    numbers = {k: {"ms": v["device_ms"] / v["count"],
                   "launches_per_step": v["count"]}
               for k, v in by_kernel.items()}
    # the flash kernels at the path's shape, bf16
    _, b, h, tq, tk, d, causal, _ = TRAIN_FLASH
    q, k, v, m, do, lse, dvec = bwd_inputs(TRAIN_FLASH, torch.bfloat16, dev,
                                           seed)
    scale = d ** -0.5
    sdpa = torch.nn.functional.scaled_dot_product_attention
    ql, kl, vl = (x.detach().clone().requires_grad_() for x in (q, k, v))
    lib_o = sdpa(ql, kl, vl, scale=scale)       # every key kept: no mask
    bwd_args = (q, k, v, do, lse, dvec, causal, scale, m)
    plain_bwd = time_ms(lambda: A.flash_attention_bwd_reference(*bwd_args),
                        [()], 2)
    lib_bwd = time_ms(lambda: torch.autograd.grad(
        lib_o, (ql, kl, vl), do, retain_graph=True), [()], 3)
    bnd = bound_ms(*attention_bound(q, k, m, causal), torch.bfloat16)
    numbers["flash_fwd"].update(
        plain_ms=time_ms(lambda: A.flash_attention_reference(
            q, k, v, causal, scale, m), [()], 2),
        library_ms=time_ms(lambda: sdpa(q, k, v, scale=scale), [()], 3),
        bound_ms=bnd[0], bound_by=bnd[1])
    for key, which in (("flash_bwd_dq", "dq"), ("flash_bwd_dkv", "dkv")):
        bnd = bound_ms(*attention_bwd_bound(q, k, m, causal, which),
                       torch.bfloat16)
        # the plain version computes dq, dk and dv in one pass; no library
        # call computes dq or dk/dv alone, SDPA's backward computes all
        numbers[key].update(plain_ms=plain_bwd, library_ms=None,
                            library_pair_ms=lib_bwd, bound_ms=bnd[0],
                            bound_by=bnd[1])
    del q, k, v, do, ql, kl, vl, lib_o
    torch.cuda.empty_cache()

    # the fused update on the transformer_long parameters, float32
    tree = {key: p.detach().clone() for key, p in param_tree(model32).items()}
    grads = random_grads(tree, seed)
    acc = {nm: {key: torch.zeros_like(p) for key, p in tree.items()}
           for nm in ("m", "v")}
    n = sum(p.numel() for p in tree.values())
    hyper = dict(momentum=0.9, nesterov=False, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, weight_decay=0.0)
    scal = FU.step_scalars(LR, 0, "adam", device=dev)

    def plain_upd():
        for key, p in tree.items():
            FU.update_reference("adam", p, grads[key],
                                [acc["m"][key], acc["v"][key]], scal, hyper)
    lib_params = [p.clone() for p in tree.values()]
    for p, g in zip(lib_params, grads.values()):
        p.grad = g
    lib_opt = torch.optim.Adam(lib_params, lr=LR, fused=True)
    n_chunks = sum(-(-p.numel() // FU.CHUNK) for p in tree.values())
    bnd = bound_ms(28 * n + 40 * n_chunks + 16,
                   ADAM_FLOPS_PER_ELEMENT * n, torch.float32)
    numbers["fused_update"].update(
        plain_ms=time_ms(plain_upd, [()], 5),
        library_ms=time_ms(lib_opt.step, [()], 20),
        bound_ms=bnd[0], bound_by=bnd[1], elements=n)
    for key, r in numbers.items():
        lib = (f"library {r['library_ms']:.3f} ms" if r["library_ms"]
               else f"library (dq+dk+dv in one SDPA backward) "
                    f"{r['library_pair_ms']:.3f} ms")
        log(f"[T3] {key} at the path's shape: kernel {r['ms']:.3f} ms "
            f"(device, {r['launches_per_step']} a step), plain "
            f"{r['plain_ms']:.3f} ms, {lib} (CUDA events); bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}) = "
            f"{r['bound_ms'] / r['ms'] * 100:.2f}% of the kernel's time")
    return step_rec, numbers


# -- ResNet-50 (R1-R4) ----------------------------------------------------------

RESNET_KERNELS = ("brgemm", "convkxk", "convkxk_dx", "convkxk_dw")
# launches of a bf16 training step of ResNet-50 (36 1x1 convs: forward, dx
# and dw each; 16 3x3 convs) and of an eval forward
R_PER_STEP = {"brgemm": 108, "convkxk": 16, "convkxk_dx": 16,
              "convkxk_dw": 16}
R_EVAL = {"brgemm": 36, "convkxk": 16, "convkxk_dx": 0, "convkxk_dw": 0}
# (forward, backward) gates, relative to the output's largest magnitude
R_TOL = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (2e-2, 2e-2)}
R_SIZE, R1_BATCH, R2_BATCH, R3_BATCH = 224, 8, 32, 256
R2_STEPS, R3_TIMED = 2, 3
# the profiled kernels' names: each kernel's loader type is in its
# template arguments (the split-K reductions carry it too)
R_SYMBOLS = {"brgemm": "DenseA", "convkxk": "XRows", "convkxk_dx": "DyRows",
             "convkxk_dw": "XCols"}


def resnet50_conv_shapes(size=R_SIZE):
    """Every non-stem conv of ResNet-50 at ``size`` x ``size``, in forward
    order: (h, c, o, k, stride), h the input's height and width (the stem
    and max pool take 224 to 56)."""
    shapes, h, in_ch = [], size // 4, 64
    for i, (n, ch) in enumerate(zip((3, 4, 6, 3), (64, 128, 256, 512))):
        for j in range(n):
            s = (1 if i == 0 else 2) if j == 0 else 1
            h2 = (h - 1) // s + 1
            shapes += [(h, in_ch, ch, 1, 1), (h, ch, ch, 3, s),
                       (h2, ch, ch * 4, 1, 1)]
            if s != 1 or in_ch != ch * 4:
                shapes.append((h, in_ch, ch * 4, 1, s))
            h, in_ch = h2, ch * 4
    return shapes


def conv_work(shape, batch, esize):
    """(bytes, flops) of one conv call (forward, dx or dw alike): x, w and
    the output each moved once (a strided 1x1 reads only the sliced x), 2
    flops a multiply-add of the real conv (taps in the padding, and the
    zeros between a strided dx's outputs, excluded)."""
    h, c, o, k, s = shape
    oh = (h - 1) // s + 1
    m = batch * oh * oh
    x_elems = m * c if k == 1 else batch * h * h * c
    nbytes = esize * (x_elems + o * c * k * k + m * o)
    if k == 1:
        return nbytes, 2 * m * c * o
    taps = 0                       # real taps over the output rows/cols
    for i in range(oh):
        for kk in range(k):
            taps += 0 <= i * s - 1 + kk < h
    return nbytes, 2 * batch * taps * taps * c * o


def r_counts():
    from paddle_tpu_torch.kernels import conv_fused as cf
    from paddle_tpu_torch.kernels import tiles
    return {"brgemm": tiles.brgemm.launches, "convkxk": cf.convkxk.launches,
            "convkxk_dx": cf.convkxk_dx.launches,
            "convkxk_dw": cf.convkxk_dw.launches}


def zero_r_counts():
    from paddle_tpu_torch.kernels import conv_fused as cf
    from paddle_tpu_torch.kernels import tiles
    for f in (tiles.brgemm, cf.convkxk, cf.convkxk_dx, cf.convkxk_dw):
        f.launches = 0


class plain_conv_kernels:
    """Route the conv kernels' wrappers to their plain versions."""
    SWAPS = (("tiles", "brgemm_cuda", "brgemm_reference"),
             ("cf", "convkxk_cuda", "convkxk_reference"),
             ("cf", "convkxk_dx_cuda", "convkxk_dx_reference"),
             ("cf", "convkxk_dw_cuda", "convkxk_dw_reference"))

    def __enter__(self):
        from paddle_tpu_torch.kernels import conv_fused as cf
        from paddle_tpu_torch.kernels import tiles
        self.mods = {"tiles": tiles, "cf": cf}
        self.saved = []
        for mod, name, plain in self.SWAPS:
            m = self.mods[mod]
            self.saved.append((m, name, getattr(m, name)))
            setattr(m, name, getattr(m, plain))
        return self

    def __exit__(self, *exc):
        for m, name, fn in self.saved:
            setattr(m, name, fn)


def r_inputs(shape, batch, dtype, dev, seed):
    """x, w (He-scaled) and an output cotangent g for one conv shape."""
    h, c, o, k, s = shape
    oh = (h - 1) // s + 1
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(batch, h, h, c, device=dev, generator=gen).to(dtype)
    w = (torch.randn(o, c, k, k, device=dev, generator=gen)
         * (c * k * k) ** -0.5).to(dtype)
    g = torch.randn(batch, oh, oh, o, device=dev, generator=gen).to(dtype)
    return x, w, g


def conv_calls(shape, x, w, g, extra=None):
    """{kernel: (cuda call, plain call)} of one conv shape: the three
    calls a training step makes (1x1: brgemm forward, dx, dw). ``extra``
    adds the epilogue to the forward and the fold to the backward:
    (scale, bias, residual, saved output)."""
    from paddle_tpu_torch.kernels import conv_fused as cf
    from paddle_tpu_torch.kernels import tiles
    h, c, o, k, s = shape
    n, dtype = x.shape[0], x.dtype
    ep_kw, fold = {}, (None, None)
    if extra is not None:
        scale, bias, res, out = extra
        ep_kw = dict(scale=scale, bias=bias, residual=res, relu=True)
        fold = (out, scale)
    if k == 1:
        xs = x[:, ::s, ::s, :]
        m = xs.shape[0] * xs.shape[1] * xs.shape[2]
        x2 = xs.reshape(m, c).contiguous()
        g2 = g.reshape(m, o)
        mask2 = None if fold[0] is None else fold[0].reshape(m, o)
        fwd = dict(a=x2, b=w.reshape(o, c).t().contiguous(), mode="nn",
                   **dict(ep_kw, residual=None if extra is None else
                          ep_kw["residual"].reshape(m, o)))
        dx = dict(a=g2, b=w.reshape(o, c).contiguous(), mode="nn",
                  fold_on="a", fold_mask=mask2, fold_scale=fold[1])
        dw = dict(a=x2, b=g2, mode="tn", fold_on="b", fold_mask=mask2,
                  fold_scale=fold[1])
        return {f"brgemm_{d}": (lambda kw=kw: tiles.brgemm_cuda(**kw),
                                lambda kw=kw: tiles.brgemm_reference(**kw))
                for d, kw in (("fwd", fwd), ("dx", dx), ("dw", dw))}
    geo = ((s, s), ((1, 1), (1, 1)), (1, 1))
    fwd = (x, w, ep_kw.get("scale"), ep_kw.get("bias"),
           ep_kw.get("residual"), bool(ep_kw), *geo)
    bwd_dx = (g, fold[0], fold[1], w, x.shape, dtype, *geo)
    bwd_dw = (g, fold[0], fold[1], x, w.shape, dtype, *geo)
    return {"convkxk": (lambda: cf.convkxk_cuda(*fwd),
                        lambda: cf.convkxk_reference(*fwd)),
            "convkxk_dx": (lambda: cf.convkxk_dx_cuda(*bwd_dx),
                           lambda: cf.convkxk_dx_reference(*bwd_dx)),
            "convkxk_dw": (lambda: cf.convkxk_dw_cuda(*bwd_dw),
                           lambda: cf.convkxk_dw_reference(*bwd_dw))}


def phase_resnet_kernels(dev, seed):
    """R1: every kernel against its plain version at every distinct conv
    shape of ResNet-50 at 224 (batch 8), forward, dx and dw, in float32
    and bfloat16; the epilogue and the fold at a strided 1x1 and a strided
    3x3; max-pool ties on NHWC CUDA tensors."""
    results, worst = [], {}
    distinct = sorted(set(resnet50_conv_shapes()))
    extra_shapes = [(56, 256, 512, 1, 2), (56, 128, 128, 3, 2)]
    for dtype in (torch.float32, torch.bfloat16):
        f_tol, b_tol = R_TOL[dtype]
        for case, shapes in (("path", distinct), ("epilogue+fold",
                                                  extra_shapes)):
            for shape in shapes:
                x, w, g = r_inputs(shape, R1_BATCH, dtype, dev, seed)
                extra = None
                if case != "path":
                    gen = torch.Generator(device=dev).manual_seed(seed + 1)
                    o = shape[2]
                    extra = (torch.rand(o, device=dev, generator=gen) + 0.5,
                             torch.randn(o, device=dev, generator=gen),
                             torch.randn(g.shape, device=dev,
                                         generator=gen).to(dtype),
                             torch.relu(torch.randn(g.shape, device=dev,
                                                    generator=gen)).to(dtype))
                for name, (kern, plain) in conv_calls(shape, x, w, g,
                                                      extra).items():
                    got = kern()
                    torch.cuda.synchronize()
                    ref = plain()
                    diff = (got.float() - ref.float()).abs().max().item()
                    rel = diff / max(ref.float().abs().max().item(), 1e-30)
                    tol = f_tol if name in ("brgemm_fwd", "convkxk") \
                        else b_tol
                    ok = bool(torch.isfinite(got).all()) and rel <= tol \
                        and got.dtype == ref.dtype and got.shape == ref.shape
                    rec = {"kernel": name, "case": case,
                           "dtype": str(dtype).split(".")[-1],
                           "shape": list(shape), "max_abs_err": diff,
                           "rel_err": rel, "ok": ok}
                    results.append(rec)
                    if not ok:
                        fail("R1", f"{rec}")
                    key = "brgemm" if name.startswith("brgemm") else name
                    if dtype == torch.bfloat16 and case == "path":
                        worst[key] = max(worst.get(key, 0.0), diff)
                del x, w, g, extra
        torch.cuda.empty_cache()
    summary = {}
    for r in results:
        key = (r["kernel"], r["dtype"], r["case"])
        n, w = summary.get(key, (0, 0.0))
        summary[key] = (n + 1, max(w, r["rel_err"]))
    for (name, dt, case), (n, w) in summary.items():
        log(f"[R1] {name:<11} {dt:>8} {case:<13} {n:2d} shapes, every one "
            f"within its gate; worst |kernel-plain| / max|plain| {w:.3e}")
    results.append(maxpool_ties(dev, seed))
    return results, worst


def maxpool_ties(dev, seed):
    """The stem's max pool on NHWC CUDA tensors with windows of ties (zeros
    after the relu, and equal values): forward and gradient equal to the
    CPU's, where the first maximum of a window takes the gradient, as in
    the JAX reference."""
    from paddle_tpu_torch.ops import nn_ops
    gen = torch.Generator().manual_seed(seed)
    x = torch.relu(torch.randn(8, 112, 112, 64, generator=gen))
    x[:, 10:40, 10:40, :] = 0.0
    x[:, 50:60, 50:60, :] = 1.0
    x = x.to(torch.bfloat16)
    outs = []
    for d in ("cpu", dev):
        leaf = x.to(d).requires_grad_()
        out = nn_ops.pool2d(leaf, 3, "max", 2, 1, data_format="NHWC")
        cot = torch.arange(out.numel(), device=d).reshape(out.shape) % 7
        (grad,) = torch.autograd.grad(out, leaf, cot.to(out.dtype))
        outs.append((out.float().cpu(), grad.float().cpu()))
    ok = torch.equal(outs[0][0], outs[1][0]) and \
        torch.equal(outs[0][1], outs[1][1])
    log(f"[R1] max pool ties on NHWC bf16 CUDA tensors: forward and gradient "
        f"{'equal to the CPU' if ok else 'DIFFER from the CPU'}")
    if not ok:
        fail("R1", "the max pool's tie-breaking differs on the card")
    return {"kernel": "max_pool_ties", "ok": ok}


def resnet_step_grads(model, params, opt, state, x, labels):
    """One step as ``bench.train_step`` takes it, keeping the gradients."""
    from paddle_tpu_torch import bench
    loss = bench.loss_fn(model)(params, x, labels)
    grads = torch.autograd.grad(loss, list(params.values()))
    opt.apply_gradients(params, dict(zip(params, grads)), state)
    return loss, grads


def r2_run(model, params, opt, init, x, labels, plain, perm):
    """Two Momentum steps from ``init`` through the kernels or (``plain``)
    their plain versions, with the batch in its order or permuted
    (``perm``): the same function, its batch sums taken in another order.
    Returns the losses, the launches a step, the first step's gradients
    and the BN running stats after the last step."""
    from paddle_tpu_torch.convert import state_tree
    model.load_state_dict(init)
    state = opt.init(params)
    if perm is not None:
        x, labels = x[perm], labels[perm]
    losses, counts, first = [], [], None
    with plain_conv_kernels() if plain else contextlib.nullcontext():
        for _ in range(R2_STEPS):
            zero_r_counts()
            loss, grads = resnet_step_grads(model, params, opt, state, x,
                                            labels)
            torch.cuda.synchronize()
            counts.append(r_counts())
            losses.append(loss.item())
            if first is None:
                first = {k: g.detach().clone() for k, g in zip(params, grads)}
    return {"losses": losses, "counts": counts, "grads": first,
            "stats": {k: b.detach().clone()
                      for k, b in state_tree(model).items()}}


def r2_gate(name, runs, get, tol):
    """Kernel route vs plain route, for each leaf that ``get`` takes out of
    a run: within ``tol`` relative L2, or within NOISE_FACTOR times the
    rounding floor (the distance each route moves when only the order of
    its batch sums changes). Returns the record; fails the phase."""
    k, p = get(runs["kernel"]), get(runs["plain"])
    kp, pp = get(runs["kernel_perm"]), get(runs["plain_perm"])
    ratios, worst, rel_all = [], (None, 0.0), []
    for leaf, ref in p.items():
        norm = max(ref.norm().item(), 1e-30)
        diff = (k[leaf] - ref).norm().item()
        floor = math.hypot((k[leaf] - kp[leaf]).norm().item(),
                           (ref - pp[leaf]).norm().item())
        rel_all.append(diff / norm)
        ok = diff <= tol * norm or diff <= NOISE_FACTOR * floor
        ratio = diff / max(floor, 1e-30)
        ratios.append(ratio)
        if not ok:
            fail("R2", f"{name} {leaf}: kernel vs plain {diff / norm:.3e} "
                       f"relative, {ratio:.2f}x the rounding floor "
                       f"({floor / norm:.3e} relative)")
        if diff / norm > worst[1]:
            worst = (leaf, diff / norm)
    rec = {"rel_median": float(np.median(rel_all)), "rel_worst": worst[1],
           "worst_leaf": worst[0],
           "floor_ratio_median": float(np.median(ratios)),
           "floor_ratio_worst": max(ratios)}
    log(f"[R2] {name}: kernel vs plain rel L2 median {rec['rel_median']:.3e}"
        f", worst {worst[1]:.3e} ({worst[0]}); x the rounding floor: median "
        f"{rec['floor_ratio_median']:.2f}, worst {rec['floor_ratio_worst']:.2f}"
        f" (gate: {tol:g} relative or {NOISE_FACTOR:g}x the floor)")
    return rec


def phase_resnet_train(dev, seed):
    """R2: float32 training of ResNet-50 at batch 32 x 224 (full width and
    depth), random labels, two Momentum(0.1, 0.9) steps through the
    kernels and through their plain versions from the same state, and the
    same two runs with the batch permuted (the rounding floor: the same
    function with its batch sums in another order). Gates: the first loss
    within 1e-4 relative; each first-step gradient leaf within 1e-3
    relative L2, each leaf of BN running stats within 1e-4 and the last
    loss within 1e-4 relative, or any of them within NOISE_FACTOR times
    its floor; 108/16/16/16 launches a step through the kernels, none
    through the plain versions."""
    from paddle_tpu_torch import bench
    from paddle_tpu_torch.ops import nn_ops
    nn_ops.set_conv_fused(True)
    model, params, opt, _, x, _ = bench.build(
        R2_BATCH, R_SIZE, "", dev, seed, dtype=torch.float32)
    gen = torch.Generator(device=dev).manual_seed(seed)
    # random labels: with the bench's labels (all 0) the loss is ~0 from
    # the second step on, and the parity check would see nothing
    labels = torch.randint(0, 1000, (R2_BATCH,), device=dev, generator=gen)
    perm = torch.randperm(R2_BATCH, device=dev, generator=gen)
    init = {k: v.detach().clone() for k, v in model.state_dict().items()}
    runs = {}
    for route in ("kernel", "plain", "kernel_perm", "plain_perm"):
        runs[route] = r2_run(model, params, opt, init, x, labels,
                             route.startswith("plain"),
                             perm if route.endswith("perm") else None)
        log(f"[R2] {route:<11} losses "
            f"{', '.join(f'{v:.6f}' for v in runs[route]['losses'])}; "
            f"launches a step {runs[route]['counts'][0]}")
    for route, run in runs.items():
        want = R_PER_STEP if route.startswith("kernel") else \
            {k: 0 for k in R_PER_STEP}
        if any(c != want for c in run["counts"]):
            fail("R2", f"{route}: launches a step {run['counts']}, "
                       f"expected {want}")
        if not all(math.isfinite(v) for v in run["losses"]):
            fail("R2", f"{route}: non-finite loss {run['losses']}")
    first = abs(runs["kernel"]["losses"][0] - runs["plain"]["losses"][0]) \
        / abs(runs["plain"]["losses"][0])
    log(f"[R2] first loss: kernel vs plain {first:.3e} relative (gate 1e-4)")
    if first > 1e-4:
        fail("R2", f"first loss parts by {first:.3e}")
    rec = {"losses": {r: v["losses"] for r, v in runs.items()},
           "first_loss_rel": first,
           "launches_per_step": runs["kernel"]["counts"][0],
           "grads": r2_gate("first-step gradients", runs,
                            lambda r: r["grads"], 1e-3),
           "bn_stats": r2_gate("BN running stats after 2 steps", runs,
                               lambda r: r["stats"], 1e-4),
           "last_loss": r2_gate("last loss", runs, lambda r: {
               "loss": torch.tensor([r["losses"][-1]], dtype=torch.float64)},
               1e-4)}
    del model, params, opt, x, runs, init
    torch.cuda.empty_cache()
    return rec


def phase_resnet_bench(dev, seed):
    """R3 + R4: the bench step (``paddle_tpu_torch/bench.py``) at batch
    256 x 224 in bf16, lowp default then ``lowp=""``. In each: a warm-up
    step; the counted step of the main path (counts set to 0 just before,
    read just after: 108/16/16/16); three timed steps (imgs/s over all
    three); one profiled step (device busy time, idle share over its own
    wall time, and in the lowp default
    each kernel's device time from its own launches). In ``lowp=""`` an
    eval forward with the conv+BN+relu epilogue: 36 brgemm and 16 convkxk
    launches, finite logits."""
    from paddle_tpu_torch import bench
    from paddle_tpu_torch.ops import nn_ops
    nn_ops.set_conv_fused(True)
    out = {}
    for lowp in (bench.DEFAULT_LOWP, ""):
        label = lowp or "bf16"
        model, params, opt, state, x, labels = bench.build(
            R3_BATCH, R_SIZE, lowp, dev, seed)

        def step():
            return bench.train_step(model, params, opt, state, x, labels)

        losses = [step().item()]
        torch.cuda.synchronize()
        zero_r_counts()
        losses.append(step().item())               # the main path's step
        torch.cuda.synchronize()
        counts = r_counts()
        if counts != R_PER_STEP:
            fail("R3", f"{label}: launches in the step {counts}, expected "
                       f"{R_PER_STEP}")
        wall = []
        for _ in range(R3_TIMED):
            t0 = time.perf_counter()
            loss = step()
            torch.cuda.synchronize()
            wall.append((time.perf_counter() - t0) * 1e3)
            losses.append(loss.item())
        busy, kernels, prof_ms = profiled(step,
                                          f"the ResNet-50 step ({label})")
        step_ms = sum(wall) / len(wall)
        if not all(math.isfinite(v) for v in losses):
            fail("R3", f"{label}: non-finite loss {losses}")
        rec = {"losses": losses, "launches": counts, "wall_ms": wall,
               "step_ms": step_ms, "imgs_per_s": R3_BATCH / step_ms * 1e3,
               "device_busy_ms": busy or None, "profiled_wall_ms": prof_ms,
               "idle_share": (1.0 - busy / prof_ms) if busy else None,
               "top_kernels": [{"name": n[:120], "count": c, "device_ms": t}
                               for n, c, t in kernels[:15]]}
        if kernels:
            rec["kernels_in_step"] = {
                key: {"count": sum(r[1] for r in kernels if sym in r[0]),
                      "device_ms": sum(r[2] for r in kernels
                                       if sym in r[0])}
                for key, sym in R_SYMBOLS.items()}
        log(f"[R3] {label}: losses {', '.join(f'{v:.4f}' for v in losses)}; "
            f"launches a step {counts}; step "
            f"{', '.join(f'{t:.1f}' for t in wall)} ms, "
            f"{rec['imgs_per_s']:.1f} imgs/s over them; profiled step: "
            f"device busy {busy:.1f} of {prof_ms:.1f} ms (idle share "
            f"{rec['idle_share'] if busy else float('nan'):.3f})")
        for n, c, t in kernels[:12]:
            log(f"[R3]   {t:9.3f} ms {c:6d}x  {n[:100]}")
        if lowp == "":
            model.eval()
            zero_r_counts()
            with torch.no_grad():
                logits = model(x)
            torch.cuda.synchronize()
            ev = r_counts()
            ok = ev == R_EVAL and bool(torch.isfinite(logits).all()) and \
                tuple(logits.shape) == (R3_BATCH, 1000)
            rec["eval"] = {"launches": ev, "ok": ok}
            log(f"[R3] eval forward (conv+BN+relu epilogue): launches {ev}, "
                f"logits {tuple(logits.shape)} finite: {ok}")
            if not ok:
                fail("R3", f"eval forward: launches {ev}, expected {R_EVAL}")
        out[label] = rec
        del model, params, opt, state, x
        torch.cuda.empty_cache()
    if "kernels_in_step" not in out["grad+out+blk+stem+bnres"]:
        fail("R4", "the profiled step recorded no device activity")
    return out


def library_call(name, shape, x, w, g):
    """One PyTorch call computing what a kernel call computes, as a
    yardstick the port never calls: ``torch.matmul`` for the 1x1 GEMMs,
    cuDNN through ``F.conv2d`` / ``convolution_backward`` in channels_last
    for the 3x3 ones."""
    h, c, o, k, s = shape
    if k == 1:
        xs = x[:, ::s, ::s, :]
        m = xs.shape[0] * xs.shape[1] * xs.shape[2]
        x2, g2 = xs.reshape(m, c).contiguous(), g.reshape(m, o)
        w2 = w.reshape(o, c)
        return {"brgemm_fwd": lambda: torch.matmul(x2, w2.t()),
                "brgemm_dx": lambda: torch.matmul(g2, w2),
                "brgemm_dw": lambda: torch.matmul(x2.t(), g2)}[name]
    xn = x.permute(0, 3, 1, 2)
    gn = g.permute(0, 3, 1, 2)
    wn = w.contiguous(memory_format=torch.channels_last)
    if name == "convkxk":
        return lambda: torch.nn.functional.conv2d(xn, wn, stride=s,
                                                  padding=1)
    mask = [name == "convkxk_dx", name == "convkxk_dw", False]
    return lambda: torch.ops.aten.convolution_backward(
        gn, xn, wn, None, [s, s], [1, 1], [1, 1], False, [0, 0], 1, mask)


def phase_resnet_numbers(step_rec, dev, seed, iters=3):
    """R4: per kernel, its device time a launch in the profiled bf16 step
    (the lowp default), beside the mean over the step's launches of its
    bound (the larger of bytes / HBM rate and flops / bf16 peak), of its
    plain version and of a library call (CUDA events, ``iters`` calls a
    distinct shape, weighted by how often the step runs it)."""
    shapes = resnet50_conv_shapes()
    counts = {}
    for sh in shapes:
        counts[sh] = counts.get(sh, 0) + 1
    acc = {k: {"bound_ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
               "bytes_bound": 0, "n": 0} for k in RESNET_KERNELS}
    for shape, mult in counts.items():
        x, w, g = r_inputs(shape, R3_BATCH, torch.bfloat16, dev, seed)
        nbytes, flops = conv_work(shape, R3_BATCH, 2)
        b_ms, by = bound_ms(nbytes, flops, torch.bfloat16)
        for name, (_, plain) in conv_calls(shape, x, w, g).items():
            key = "brgemm" if name.startswith("brgemm") else name
            a = acc[key]
            a["n"] += mult
            a["bound_ms"] += mult * b_ms
            a["bytes_bound"] += mult * (by == "bytes")
            a["plain_ms"] += mult * time_ms(plain, [()], iters)
            a["library_ms"] += mult * time_ms(
                library_call(name, shape, x, w, g), [()], iters)
        del x, w, g
        torch.cuda.empty_cache()
    numbers = {}
    in_step = step_rec["kernels_in_step"]
    for key, a in acc.items():
        launches = R_PER_STEP[key]
        if a["n"] != launches:
            fail("R4", f"{key}: {a['n']} calls in the shape table, "
                       f"{launches} a step")
        ms = in_step[key]["device_ms"] / launches
        rec = {"ms": ms, "launches_per_step": launches,
               "bound_ms": a["bound_ms"] / launches,
               "bound_by": "bytes" if a["bytes_bound"] * 2 > launches
               else "operations",
               "plain_ms": a["plain_ms"] / launches,
               "library_ms": a["library_ms"] / launches,
               "device_ms_in_step": in_step[key]["device_ms"],
               "profiled_kernels_in_step": in_step[key]["count"]}
        numbers[key] = rec
        log(f"[R4] {key} (bf16, mean over the step's {launches} launches): "
            f"kernel {ms:.3f} ms (device), plain {rec['plain_ms']:.3f} ms, "
            f"library {rec['library_ms']:.3f} ms (CUDA events); bound "
            f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}) = "
            f"{rec['bound_ms'] / ms * 100:.2f}% of the kernel's time")
    return numbers


def gpu_name_and_power():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else \
        "nvidia-smi gave no output"


# -- main -------------------------------------------------------------------

def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out-dir",
                    default=os.path.join(HERE, "chip_smoke_out"))
    args = ap.parse_args(argv)

    sys.path.insert(0, HERE)
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script measures "
                         "the port on the card and has no CPU fallback")
    import paddle_tpu_torch  # noqa: F401  (sets float32 matmuls to strict)
    from paddle_tpu_torch.kernels.attention import flash_attention

    dev = torch.device("cuda")
    card = gpu_name_and_power()
    log(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}; nvidia-smi: {card}")
    t_start = time.perf_counter()
    report = {"card": card, "seed": args.seed}
    report["build"] = phase_build()
    report["resnet_kernels"], r_worst = phase_resnet_kernels(dev, args.seed)
    report["resnet_train"] = phase_resnet_train(dev, args.seed)
    report["resnet_bench"] = phase_resnet_bench(dev, args.seed)
    r_main = report["resnet_bench"]["grad+out+blk+stem+bnres"]
    report["resnet_numbers"] = phase_resnet_numbers(r_main, dev, args.seed)
    report["kernels"], worst = phase_kernels(dev, args.seed)
    model_bf16 = full_width_model(torch.bfloat16, dev, args.seed)
    report["serving"] = phase_serving(model_bf16, dev, args.seed)
    serving_launches = flash_attention.launches
    report["e2e"] = phase_e2e(model_bf16, dev, args.seed)
    report["numbers"] = phase_numbers(dev, args.seed)
    report["generate"] = [
        phase_generate_profile(model_bf16, dev, args.seed, use_bf16)
        for use_bf16 in (False, True)]
    del model_bf16
    torch.cuda.empty_cache()

    from paddle_tpu_torch.convert import param_tree
    report["train_kernels"], train_worst = phase_train_kernels(dev, args.seed)
    model32 = long_model(torch.float32, dev, args.seed)
    report["update_kernel"], worst["fused_update"] = phase_update_kernel(
        param_tree(model32), dev, args.seed)
    worst["flash_fwd"] = max(worst["flash_fwd"], train_worst.pop("flash_fwd"))
    worst.update(train_worst)
    report["train"], model_bf, batch = phase_train(model32, dev, args.seed)
    report["train_step"], train_numbers = phase_train_numbers(
        model32, model_bf, batch, dev, args.seed)
    report["train_numbers"] = train_numbers
    report["seconds"] = time.perf_counter() - t_start

    launches = dict(report["train"]["launches"])
    launches["flash_fwd"] += serving_launches
    # the conv kernels: the counted step of the bench (lowp default)
    launches.update(r_main["launches"])
    worst.update(r_worst)
    # flash_fwd's times are the serving decoder shape's (12 of every 12
    # launches per decode step); its other shapes, the training one
    # included, are in "shapes"
    main = next(r for r in report["numbers"]
                if r["case"] == "decoder_self" and r["dtype"] == "bfloat16")
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels_line = []
    for name, meta in KERNELS.items():
        rec = {"name": name, **meta, "launches": launches[name],
               "max_abs_err": worst[name]}
        if name == "flash_fwd":
            rec.update({k: main[k] for k in keys})
            rec["launches_by_path"] = {
                "serving": serving_launches,
                "training": report["train"]["launches"]["flash_fwd"]}
            rec["shapes"] = [
                {k: r[k] for k in ("case", "dtype", "shape", "ms", "plain_ms",
                                   "bound_ms", "bound_by", "library_ms",
                                   "call_ms")}
                for r in report["numbers"]] + [
                dict({k: train_numbers[name][k] for k in keys},
                     case="train", dtype="bfloat16",
                     shape=list(TRAIN_FLASH[1:6]))]
        elif name in RESNET_KERNELS:
            rec.update({k: report["resnet_numbers"][name][k] for k in keys})
        else:
            rec.update(train_numbers[name])
        kernels_line.append(rec)
    os.makedirs(args.out_dir, exist_ok=True)
    with open(os.path.join(args.out_dir, "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)
    log(f"[done] all phases passed in {report['seconds']:.1f} s")
    log(json.dumps({"kernels": kernels_line}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
