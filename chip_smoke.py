#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``paddle_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py          # one card; exits 0 only if all pass

Phases, each of which fails the run (non-zero exit) on its own:

1. build    every kernel of the path from ``paddle_tpu_torch/csrc`` (one
            ``nvcc`` per source, all started together);
2. kernels  each kernel, through the wrapper the model calls, against its
            plain PyTorch version on the card, at the serving path's
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
5. numbers  the kernel's device time (torch.profiler), its plain
            version's, and
            ``torch.nn.functional.scaled_dot_product_attention``'s as a
            yardstick (the port never calls it), at each path shape,
            beside the least time the card could take for the work these
            inputs need (masked keys excluded); the same calls timed
            with their launch cost (CUDA events); a steady-state 64x64
            ``generate()``: latency, tokens/s, the device's busy time and
            idle share, and the kernels that take the time.

The last lines are the ``{"kernels": [...]}`` object, the card's name and
power limit as ``nvidia-smi`` gives them, and the result object
``{"ok": true, "device": {...}}``. A full report goes to
``chip_smoke_out/chip_smoke.json`` (``--out-dir``). Without a CUDA device, or without the
``paddle_tpu_torch`` package beside this file, the script exits non-zero
and prints no result.
"""

from __future__ import annotations

import argparse
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
}

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
    Generator's padded batch rows); prefix: a decode cache filled to half."""
    if kind is None:
        return None
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
    native_build.build(list(KERNELS))
    seconds = time.perf_counter() - t0
    log(f"[build] {len(KERNELS)} kernel source(s) built in {seconds:.2f} s")
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

class plain_attention:
    """Route the model's flash attention to the kernel's plain version."""

    def __enter__(self):
        from paddle_tpu_torch.kernels.attention import \
            flash_attention_reference
        from paddle_tpu_torch.nn import attention as nn_attention
        self.mod, self.saved = nn_attention, nn_attention.flash_attention

        def plain(q, k, v, causal=False, scale=None, kv_mask=None,
                  device=None):
            return flash_attention_reference(q, k, v, causal, scale,
                                             kv_mask)[0]
        nn_attention.flash_attention = plain
        return self

    def __exit__(self, *exc):
        self.mod.flash_attention = self.saved


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
        with plain_attention():
            t_plain = gen.generate(src)
        if flash_attention.launches != before + launched or launched == 0:
            fail(4, "the kernel run did not launch, or the plain run did")
        same = float((t_kernel == t_plain).mean())
        rows_same = int((t_kernel == t_plain).all(axis=1).sum())
        lk = step_logits(model, src, t_kernel)
        with plain_attention():
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


def profiled(fn):
    """Run ``fn()`` under torch.profiler; returns (device time in ms summed
    over every kernel and copy, [(name, count, device ms)] by time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [(e.key, e.count, _device_us(e) / 1e3)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and _device_us(e) > 0]
    rows.sort(key=lambda r: -r[2])
    return sum(r[2] for r in rows), rows


def device_ms(fn, arg_sets, iters):
    """Device time of one call (all its kernels), from the profiler."""
    def run():
        for i in range(iters):
            fn(*arg_sets[i % len(arg_sets)])
    total, _ = profiled(run)
    if total <= 0:
        fail(5, "torch.profiler recorded no device time")
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
            t = {k: device_ms(f, a, iters) for k, (f, a) in fns.items()}
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
    and tokens/s, then one profiled run for the device's busy time and
    the kernels that take it. ``use_bf16`` casts the weights once
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
    busy, kernels = profiled(lambda: gen.generate(src))
    launches = flash_attention.launches - before
    if busy <= 0:
        fail(5, "torch.profiler recorded no device time for generate()")
    wall = sorted(lat)[len(lat) // 2]
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
    report["kernels"], worst = phase_kernels(dev, args.seed)
    model_bf16 = full_width_model(torch.bfloat16, dev, args.seed)
    report["serving"] = phase_serving(model_bf16, dev, args.seed)
    launches = {"flash_fwd": flash_attention.launches}
    report["e2e"] = phase_e2e(model_bf16, dev, args.seed)
    report["numbers"] = phase_numbers(dev, args.seed)
    report["generate"] = [
        phase_generate_profile(model_bf16, dev, args.seed, use_bf16)
        for use_bf16 in (False, True)]
    report["seconds"] = time.perf_counter() - t_start

    kernels_line = []
    for name, meta in KERNELS.items():
        # the line's times are the decoder shape's (12 of every 12 launches
        # per decode step); all path shapes are in "shapes"
        main = next(r for r in report["numbers"]
                    if r["case"] == "decoder_self"
                    and r["dtype"] == "bfloat16")
        kernels_line.append({
            "name": name, **meta, "launches": launches[name],
            "max_abs_err": worst[name], "ms": main["ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": main["library_ms"],
            "shapes": [{k: r[k] for k in ("case", "dtype", "shape", "ms",
                                          "plain_ms", "bound_ms",
                                          "bound_by", "library_ms",
                                          "call_ms")}
                       for r in report["numbers"]]})
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
