#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``paddle_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py          # one card; exits 0 only if all pass

Phases, each of which fails the run (non-zero exit) on its own:

1. build    every kernel of the paths from ``paddle_tpu_torch/csrc`` (one
            ``nvcc`` per source, all started together); ``cuobjdump -sass``
            must find wgmma (``HGMMA``) in every function of the
            tensor-core flash forward, of the tensor-core dQ and dK/dV
            backward, of the tensor-core 3x3 forward and of the
            tensor-core weight gradient;

Then the ResNet-50 path (``paddle_tpu_torch/bench.py``'s step with the conv
kernels on: ``csrc/brgemm.cu`` for the 1x1 convs, ``csrc/conv_kxk.cu`` for
the 3x3 ones, forward, dx and dw, where ``conv_fused.kxk_fwd_route`` sends
every bf16 3x3 forward of ResNet-50 to ``csrc/conv_kxk_fwd_tc.cu`` (wgmma)
and ``conv_fused.dw_route`` every bf16 weight gradient to
``csrc/conv_kxk_dw_tc.cu`` (wgmma), the float32 ones to the SIMT
``conv_kxk_fwd`` and ``conv_kxk_dw``; ``conv_fused.dx_route`` sends every
bf16 3x3 dx without a fold to the tensor-core forward, at stride 1 at the
geometry of the stride-1 forward conv it is (flipped taps, C and O
swapped), at stride 2 as one such conv of g a phase of dx
(``conv_fused.dx_phases``: four zero-free convs, each writing its rows and
columns of dx from its epilogue), the float32 ones to the SIMT
``conv_kxk_dx``;
``tiles.gemm_route`` sends every bf16 1x1 forward and dx (mode "nn", no
fold: the step's convs have no relu or scale in their epilogue) to the
same tensor-core forward and every bf16 1x1 weight gradient (mode "tn")
to the same tensor-core weight gradient, each at a 1x1 geometry, the
float32 ones to ``csrc/brgemm.cu``; and with
``PADDLE_TPU_POOL_FUSED`` set, the stem's max pool in
``csrc/pool_fused.cu``, forward and backward):

R1. kernels  each conv kernel against its plain version at every distinct
             conv shape of ResNet-50 at 224 (batch 8), forward, dx and dw,
             in float32 and bfloat16, plus the epilogue (scale, bias,
             residual, relu) and the cotangent fold at a strided 1x1, a
             strided 3x3 and a stride-1 3x3, each call on the route the
             rules name
             (``want_route``: tensor cores in bf16, SIMT in float32 and for
             a dx that folds; the worst error logged by route); the
             tensor-core dx also dilated, with an uneven padding whose low
             pad of g is negative, at an M that is no multiple of its tile
             and with a float32 output, and by phases at stride 2 and
             (2, 1) at a ragged M, an odd H and a float32 output, at stride
             3, with a phase no tap reaches and at O = C = 192; the
             tensor-core forward also
             dilated, at an M that is no multiple of its tile, at O = 192,
             with a float32 output and with the eval chain (scale, bias,
             relu); the tensor-core weight gradient also dilated, at a K
             that is no multiple of its K step, and forced to one split and
             to the most splits; max-pool ties on NHWC CUDA tensors (knob
             off);
R2. train    float32 ResNet-50 at batch 32 x 224 (full width and depth),
             the pool knob on: two Momentum steps through the kernels and
             through their plain versions from the same state, and both
             again with the batch permuted (the rounding floor: the same
             function, its batch sums in another order); the first loss,
             every first-step gradient leaf, the BN running stats and the
             last loss gated (a fixed tolerance, or twice the floor); 108
             brgemm (all on SIMT), 16 of each 3x3 kernel (all on the SIMT
             kernels) and one pool forward and one pool backward (on the
             tile kernel) launched a step;
P1. pool     the pool kernels against their plain versions at the stem's
             shape (bf16 at batch 256, float32 at batch 8), at odd planes,
             on windows of ties, on NaN / -inf / finfo.min entries, at
             2x2/s2/p0 and at C = 3: out and idx equal, dx bit for bit,
             the backward on the route ``pool_fused.bwd_route`` names (the
             tile kernel, ``pool_bwd_tile_kernel``, but at C = 3, which
             takes the gather, ``pool_bwd_kernel``) and, where that is the
             tile kernel, the gather on the same inputs bit for bit too;
             ``nn_ops.pool2d`` with the knob on, forward and backward at
             C = 64 and C = 3 (one backward on each route, counted); the
             forward's and both backward kernels' times, the plain
             versions' and ``F.max_pool2d``'s (and its backward's) beside
             the bound;

Then the sentiment classifier (``paddle_tpu_torch/imdb_bench.py``, the
``imdb_real`` step: ``csrc/seqpool.cu`` for the embedding lookup and mean
pool, Adam):

E1. kernels  seqpool against its plain version, sum and mean, float32 and
             bf16, at the classifier's shape ([256, 256] ids into a
             [5149, 128] table) and at kernel_bench.py:98's ([1024, 16]
             into [500000, 128]), ids out of range included; the kernel's,
             the plain version's and ``F.embedding_bag``'s times at both;
E2. train    three float32 Adam steps at full size through the kernels
             (fused and unfused update) and through the plain versions,
             and again permuted: losses within 1e-5 relative, the
             parameters within twice the permutation's floor, untouched
             table rows unmoved, one seqpool launch a step; then the main
             path, 20 counted and timed steps unfused and 20 fused
             (samples/s), and one profiled step (idle share, the kernel's
             device time) beside its bound and yardsticks;

Then the row LayerNorm (``csrc/layer_norm.cu``, forward only, behind
``nn_ops.layer_norm(use_pallas=True)`` on ``[N, D]`` and the
``LayerNorm(use_pallas=True)`` layer) and BERT-base pretraining
(``paddle_tpu_torch/bert_bench.py``). They run after E2: in a run that
put them first, E2's profiler session, the next one, recorded no device
activity on the H100 machine:

L1. kernels  the row LayerNorm through the op against its plain version at
             kernel_bench.py:43-60's bf16 [32768, 1024] (scale ones, bias
             zeros) and its float32 twin, bf16 [4096, 768] with eps 1e-12
             (affine, and scale and shift off) and odd shapes in float32,
             bf16 and float16: float32 within 1e-5 of max |y|, bf16 and
             float16 within one ulp (beyond the float32 gate); one launch
             a call; the layer launches it once on a 2-D input, never on a
             3-D one, and its backward raises;
L2. numbers  the main path (the kernel_bench twin: the layer on bf16
             [32768, 1024], 50 counted calls), then the kernel's device
             time, its byte bound, its plain version's and
             ``F.layer_norm``'s time at bf16 [32768, 1024], float32
             [32768, 1024] and bf16 [4096, 768];
B1. train    BERT-base float32 at full width and depth, batch 8 x 128,
             random ids with pads, MLM labels and weights, NSP labels: 3
             unfused AdamW steps with ``use_pallas=True`` through the flash
             kernels and through their plain versions, and with
             ``use_pallas=False`` (dense), each again with the attention's
             keys reordered (the rounding floor); losses within 1e-4
             relative, the first gradients leaf by leaf and the parameters
             after step 3 within twice the floor; launches counted a step;
B2. bench    the bench step at batch 32 x 128 bf16 as the bench defines it
             (``use_pallas=False``: no kernel of the port) and with
             ``use_pallas=True`` (12 flash forward, dQ and dK/dV a step, the
             forward and dK/dV on the tensor cores, no row LayerNorm, no
             fused update): 2 warm-up and 10 timed steps
             each, tokens/s and MFU, the forward and backward and the
             update timed apart, one profiled step each (idle share, top
             kernels).

Back on the ResNet-50 path:

R3. bench    the bf16 bench step at batch 256 x 224 in the lowp default and
             in pure bf16, the pool knob on: the main path's counted step
             (launches as in R2, every 3x3 forward, dx and weight gradient
             on the tensor cores, the 3 stride-2 dx by phases, the 1x1
             GEMMs 72 on the tensor-core
             forward and 36 on the tensor-core weight gradient), timed
             steps (imgs/s over all of them), one profiled step each
             (device busy time, idle share over its own wall time; its own
             count of 113 tensor-core forwards, 4 of them a stride-2 dx,
             52 tensor-core weight
             gradients and no SIMT conv kernel, and of one pool forward,
             one tile pool backward and no gather, gated); in the
             lowp default a counted step with the pool knob off (no pool
             launch) and timed steps with the knob off and on in turns; in
             pure bf16 an eval forward through the conv+BN+relu epilogue
             (36 + 16 conv launches, one pool_fwd; the stem's BatchNorm,
             whose running stats are float32, hands the convs a float32
             activation, so all 52 take SIMT, as the rules say);
R4. numbers  each conv and pool kernel row's device time a launch beside
             the mean over the step's launches of its bound, its plain
             version and a library call (``torch.matmul``, cuDNN,
             ``F.max_pool2d``) that the port never calls: the pool
             forward and the tile backward from their own launches in the
             profiled lowp step, the gather (no step launches it) from
             P1's calls;
             each conv kernel's rows (the tensor-core ones share their
             kernels between 1x1 and 3x3 convs and the 3x3 dx) from the
             step's calls at batch 256 in bf16 launched on each route in
             four profiled sessions, each tensor-core row beside its SIMT
             twin on the same calls (``simt_ms``), the dx at stride 1 and
             at stride 2 apart on either route, and cuDNN's stride-2 input
             gradient on the phases' calls by its device time too, in a
             session of its own.

Then the serving path:

2. kernels  the flash forward, through the wrapper the model calls, against
            its plain PyTorch version on the card, at the serving path's
            shapes and BERT's, in float32 (TF32 off) and bfloat16, with a
            fully masked row, causal cases (one at Tq = Tk = 512 without a
            mask: the tile skip), ragged edges and D = 100 and 128. The
            route counters must show the kernel ``fwd_route`` names: the
            tensor cores (``csrc/flash_fwd_tc.cu``) for bf16 with D a
            multiple of 16 and Tq >= 16, the SIMT kernel
            (``csrc/flash_fwd.cu``) for float32, decode and D = 100;
3. serving  Transformer-base (full width, 6+6 layers, bf16, flash
            attention, random weights from ``--seed``) behind
            ``BatchingGeneratorServer(max_batch=64)``: a few dozen requests
            of 8-64 tokens from several threads, one ``max_new`` request
            and one that expires under ``ttl``; the flash kernel's launch
            count over this phase must equal 6 per batch (the encoder, on
            the tensor cores) plus 12 per decode step (on the SIMT kernel);
4. e2e      the same model in float32: one ``generate()`` of a 64x64 batch
            through the kernel and through its plain version must give
            identical tokens; in bf16 the per-step logit difference and the
            token agreement are reported;
5. numbers  the forward kernel's device time (torch.profiler) at each path
            shape and BERT's, on the route the shape takes (the SIMT
            kernel's beside the tensor-core kernel's), its plain
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

T1. kernels  the flash forward (route counted) and then the backward's dq
             and dk/dv kernels, fed that forward's o and lse, against their
             plain versions at the path's flash shape [4*8, 4096, 4096, 64],
             at BERT's, at a ragged masked shape, at a causal one (the
             tensor-core dK/dV skips the query tiles before a key tile),
             causal with a kv mask (no skip), at D = 16 and 32 and at
             D = 128, in float32 and bfloat16, the dQ and dK/dV routes
             counted: ``bwd_route``'s tensor cores
             (``csrc/flash_bwd_dq_tc.cu``, ``csrc/flash_bwd_dkv_tc.cu``)
             for bf16 with D <= 64, the SIMT kernels for float32 and
             D = 128; the fused
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
             step (12 flash forward, 12 dq and 12 dk/dv, each on its SIMT
             kernel in float32 and on the tensor cores in bf16, one fused
             update); loss and gradients of remat "save_flash", "none"
             (24 forward launches) and no remat held equal; three bf16
             steps reported;
T3. numbers  one profiled bf16 training step: step time, tokens/s, device
             busy time and idle share, top kernels (12 tensor-core
             forward, dq and dk/dv launches each, no SIMT one of any), and
             each kernel's device time at the path's shape; beside it its
             bound, and its plain version and a library yardstick that the
             port never calls (SDPA forward and backward,
             ``torch.optim.Adam(fused=True)``) timed with CUDA events, and
             the SIMT forward, dq and dk/dv on the same inputs.

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
import sys
import threading
import time
from typing import NamedTuple

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
    # the same TPU kernel's second implementation: bf16 on the tensor cores
    "flash_fwd_tc": {
        "route": "cuda",
        "source": "paddle_tpu_torch/csrc/flash_fwd_tc.cu",
        "replaces": "paddle_tpu/kernels/attention.py:272",
    },
    "flash_bwd_dq": {
        "route": "cuda",
        "source": "paddle_tpu_torch/csrc/flash_bwd.cu",
        "replaces": "paddle_tpu/kernels/attention.py:345",
    },
    # the same TPU kernel's second implementation: bf16 on the tensor cores
    "flash_bwd_dq_tc": {
        "route": "cuda",
        "source": "paddle_tpu_torch/csrc/flash_bwd_dq_tc.cu",
        "replaces": "paddle_tpu/kernels/attention.py:345",
    },
    "flash_bwd_dkv": {
        "route": "cuda",
        "source": "paddle_tpu_torch/csrc/flash_bwd.cu",
        "replaces": "paddle_tpu/kernels/attention.py:367",
    },
    # the same TPU kernel's second implementation: bf16 on the tensor cores
    "flash_bwd_dkv_tc": {
        "route": "cuda",
        "source": "paddle_tpu_torch/csrc/flash_bwd_dkv_tc.cu",
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
    # the same TPU kernel's tensor-core routes: the tensor-core conv
    # forward at a 1x1 geometry (mode "nn" without a fold) and the
    # tensor-core conv weight gradient at a 1x1 geometry (mode "tn")
    "brgemm_tc_fwd": {
        "route": "cuda",
        "source": "paddle_tpu_torch/csrc/conv_kxk_fwd_tc.cu",
        "replaces": "paddle_tpu/kernels/tiles.py:359",
    },
    "brgemm_tc_dw": {
        "route": "cuda",
        "source": "paddle_tpu_torch/csrc/conv_kxk_dw_tc.cu",
        "replaces": "paddle_tpu/kernels/tiles.py:359",
    },
    "convkxk": {
        "route": "cuda",
        "source": "paddle_tpu_torch/csrc/conv_kxk.cu",
        "replaces": "paddle_tpu/kernels/conv_fused.py:241",
    },
    # the same TPU kernel's second implementation: bf16 on the tensor cores
    "convkxk_tc": {
        "route": "cuda",
        "source": "paddle_tpu_torch/csrc/conv_kxk_fwd_tc.cu",
        "replaces": "paddle_tpu/kernels/conv_fused.py:241",
    },
    "convkxk_dx": {
        "route": "cuda",
        "source": "paddle_tpu_torch/csrc/conv_kxk.cu",
        "replaces": "paddle_tpu/kernels/conv_fused.py:425",
    },
    # the same TPU kernel's tensor-core route: the tensor-core conv forward
    # at the geometry of the stride-1 forward conv a dx without a fold is
    "convkxk_dx_tc": {
        "route": "cuda",
        "source": "paddle_tpu_torch/csrc/conv_kxk_fwd_tc.cu",
        "replaces": "paddle_tpu/kernels/conv_fused.py:425",
    },
    # and its route at a stride above 1: the same kernel's phase
    # instantiation, one zero-free conv of g a phase of dx
    "convkxk_dx_tc_phase": {
        "route": "cuda",
        "source": "paddle_tpu_torch/csrc/conv_kxk_fwd_tc.cu",
        "replaces": "paddle_tpu/kernels/conv_fused.py:425",
    },
    "convkxk_dw": {
        "route": "cuda",
        "source": "paddle_tpu_torch/csrc/conv_kxk.cu",
        "replaces": "paddle_tpu/kernels/conv_fused.py:506",
    },
    # the same TPU kernel's second implementation: bf16 on the tensor cores
    "convkxk_dw_tc": {
        "route": "cuda",
        "source": "paddle_tpu_torch/csrc/conv_kxk_dw_tc.cu",
        "replaces": "paddle_tpu/kernels/conv_fused.py:506",
    },
    "pool_fwd": {
        "route": "cuda",
        "source": "paddle_tpu_torch/csrc/pool_fused.cu",
        "replaces": "paddle_tpu/kernels/pool_fused.py:110",
    },
    # the pool backward's two kernels, ``pool_fused.bwd_route``'s routes:
    # the gather, and bands of dx rows summed from g and idx rows staged in
    # shared memory by bulk asynchronous copies
    "pool_bwd_gather": {
        "route": "cuda",
        "source": "paddle_tpu_torch/csrc/pool_fused.cu",
        "replaces": "paddle_tpu/kernels/pool_fused.py:184",
    },
    "pool_bwd_tile": {
        "route": "cuda",
        "source": "paddle_tpu_torch/csrc/pool_fused.cu",
        "replaces": "paddle_tpu/kernels/pool_fused.py:184",
    },
    "seqpool": {
        "route": "cuda",
        "source": "paddle_tpu_torch/csrc/seqpool.cu",
        "replaces": "paddle_tpu/kernels/embedding_pool.py:101",
    },
    "layer_norm": {
        "route": "cuda",
        "source": "paddle_tpu_torch/csrc/layer_norm.cu",
        "replaces": "paddle_tpu/kernels/tiles.py:468",
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
# BERT-base's attention on B2's use_pallas path: batch 32 x 128, 12 heads of
# 64, BERT's kv mask (input_ids != 0) with padded rows
BERT_FLASH = ("bert", 32, 12, 128, 128, 64, False, "padding")
CHECK_SHAPES = PATH_SHAPES + [
    BERT_FLASH,
    ("causal", 64, 8, 64, 64, 64, True, None),
    ("causal_ragged", 3, 2, 40, 40, 16, True, None),
    ("ragged_d100", 3, 2, 5, 70, 100, False, "padding"),
    # the tensor-core kernel's second column block, with padded rows
    ("d128", 2, 4, 256, 256, 128, False, "padding"),
    # causal without a mask: the tensor-core kernel skips future K/V tiles
    ("causal_512", 2, 8, 512, 512, 64, True, None),
]
TOLERANCE = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


def expect_route(dtype, tq, d):
    """The forward kernel a check must see launched (contiguous, aligned
    inputs): the tensor-core kernel for bf16 with D a multiple of 16 and
    Tq >= 16; the SIMT kernel for float32, decode (Tq = 1) and D = 100."""
    return "tc" if dtype == torch.bfloat16 and d % 16 == 0 and tq >= 16 \
        else "simt"


def expect_bwd_route(dtype, d):
    """The dQ and the dK/dV kernel a check must see launched (contiguous,
    aligned inputs): the tensor-core kernels for bf16 with D a multiple of
    16 in 16..64; the SIMT kernels for float32 and D = 128."""
    return "tc" if dtype == torch.bfloat16 and d % 16 == 0 and \
        16 <= d <= 64 else "simt"


def route_counts(kernel="flash_fwd"):
    """The launches of ``kernel`` ("flash_fwd", "flash_bwd_dq" or
    "flash_bwd_dkv") so far, by route."""
    counts = train_counts()
    return {"tc": counts[f"{kernel}_tc"], "simt": counts[f"{kernel}_simt"]}


def check_route(phase, name, before, want, calls=1, kernel="flash_fwd"):
    """Fail unless the ``calls`` launches of ``kernel`` since ``before`` (a
    ``route_counts(kernel)``) all took route ``want``."""
    after = route_counts(kernel)
    got = {r: after[r] - before[r] for r in after}
    if got != {r: calls if r == want else 0 for r in got}:
        fail(phase, f"{name}: {kernel} launches by route {got}, expected "
                    f"{calls} on {want}")


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
    paths = native_build.build(SOURCES)
    seconds = time.perf_counter() - t0
    log(f"[build] {len(SOURCES)} kernel sources built in parallel in "
        f"{seconds:.2f} s")
    for name, info in native_build.build_info.items():
        log(f"[build] {name}: {info['seconds']:.2f} s")
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line or "C75" in line:
                log(f"[build] {name}: {line.strip()}")
    return {"seconds": seconds,
            "per_kernel": {n: i["seconds"]
                           for n, i in native_build.build_info.items()},
            "sass": {name: sass_check(paths[name], f"{name}_kernel", "HGMMA")
                     for name in ("flash_fwd_tc", "flash_bwd_dq_tc",
                                  "flash_bwd_dkv_tc", "conv_kxk_fwd_tc",
                                  "conv_kxk_dw_tc")}}


def sass_check(lib, symbol, opcode):
    """Count ``opcode`` in the SASS of every function of ``lib`` whose name
    holds ``symbol`` (``cuobjdump -sass``); fail unless each has some."""
    import shutil
    import subprocess
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    res = subprocess.run([tool, "-sass", lib], capture_output=True,
                         text=True, timeout=300)
    if res.returncode != 0:
        fail(1, f"cuobjdump -sass {lib} failed: {res.stderr[-2000:]}")
    counts = {}
    for part in res.stdout.split("Function : ")[1:]:
        name = part.split(None, 1)[0]
        if symbol in name:
            counts[name] = part.count(opcode)
    log(f"[build] SASS of {symbol}: {opcode} per function {counts}")
    if not counts or not all(counts.values()):
        fail(1, f"{symbol} has no {opcode} in its SASS: {counts}")
    return counts


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
            routes = route_counts()
            want = expect_route(dtype, tq, d)
            o = flash_attention(q, k, v, causal, d ** -0.5, kv_mask=m,
                                device=dev)
            if flash_attention.launches != before + 1:
                fail(2, f"flash_attention did not launch the kernel ({name})")
            _, lse = flash_fwd_cuda(q, k, v, causal, d ** -0.5, m)
            torch.cuda.synchronize()
            check_route(2, f"{name} {dtype}", routes, want, calls=2)
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
                   "route": want, "max_abs_err": diff.max().item(),
                   "rel_err": o_err, "lse_rel_err": lse_err, "ok": ok}
            results.append(rec)
            log(f"[kernels] flash_fwd {want:>4} {rec['dtype']:>8} {name:<14} "
                f"[{b},{h},{tq},{tk},{d}] max|o-plain| "
                f"{rec['max_abs_err']:.3e}"
                f" rel {o_err:.3e} lse rel {lse_err:.3e} "
                f"(tol {TOLERANCE[dtype]:g}) {'ok' if ok else 'MISMATCH'}")
            if not ok:
                fail(2, f"flash_fwd {rec}")
            if dtype == torch.bfloat16 and (shape in PATH_SHAPES or
                                            shape is BERT_FLASH):
                key = "flash_fwd_tc" if want == "tc" else "flash_fwd"
                worst[key] = max(worst.get(key, 0.0), rec["max_abs_err"])
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
    routes = route_counts()
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
    by_route = {r: n - routes[r] for r, n in route_counts().items()}
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
    # the encoder's self-attention (bf16, Tq = 64) on the tensor cores, the
    # decode steps' (Tq = 1) on the SIMT kernel
    want = {"tc": cfg.n_layer * counts["batches"],
            "simt": 2 * cfg.n_layer * counts["steps"]}
    if by_route != want:
        fail(3, f"forward launches by route {by_route}, expected {want}")
    n_tok = int(sum((r[1:] != 0).sum() for r in rows + [trimmed_row]))
    out = {"requests": len(rows) + 2, "batches": counts["batches"],
           "decode_steps": counts["steps"], "flash_fwd_launches": launches,
           "launches_by_route": by_route,
           "generated_tokens": n_tok, "wall_s": wall,
           "tokens_per_s": n_tok / wall}
    log(f"[serving] {out['requests']} requests (1 expired as asked, 1 "
        f"trimmed) in {counts['batches']} batches, {counts['steps']} decode "
        f"steps; flash_fwd launches {launches} = 6 x batches + 12 x steps "
        f"(tensor cores {by_route['tc']}, SIMT {by_route['simt']}); "
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


PROFILE_SESSIONS = 3


def profiled(fn, label, expect=None):
    """Run ``fn()`` under torch.profiler; returns (device time in ms summed
    over every kernel and copy, [(name, count, device ms)] by time, the
    wall time of the profiled call in ms). A session without device
    activity is logged; the caller fails. ``expect`` maps a kernel symbol
    to the launches ``fn()`` makes of it (its counter says so): CUPTI can
    drop an activity record (an H100 run once profiled 49 of 50 identical
    launches), so a session that counts other numbers is logged and ``fn``
    profiled again, up to PROFILE_SESSIONS sessions in all. The last
    session is returned either way, and the caller's own gate on the
    counts decides."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for session in range(1, PROFILE_SESSIONS + 1):
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
            log(f"[profile] the session of {label} recorded no device "
                f"activity ({len(events)} event kinds, device types "
                f"{sorted({str(e.device_type) for e in events})})")
        rows.sort(key=lambda r: -r[2])
        got = {sym: sum(r[1] for r in rows if sym in r[0])
               for sym in (expect or {})}
        if got == (expect or {}):
            break
        log(f"[profile] session {session} of {label} counted {got}, "
            f"expected {expect}"
            + ("; profiling again" if session < PROFILE_SESSIONS else ""))
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
    """Per path shape (the serving shapes, and BERT's in bf16): device time
    per call (profiler) of the kernel the route takes, its plain version
    and SDPA, and the same calls' time per call with the host's launch cost
    included (CUDA events around a loop of calls). Where the route is the
    tensor cores, the SIMT kernel at the same inputs too."""
    from paddle_tpu_torch.kernels.attention import (flash_attention_reference,
                                                    flash_fwd_cuda,
                                                    flash_fwd_launch)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        shapes = PATH_SHAPES + ([BERT_FLASH] if dtype == torch.bfloat16
                                else [])
        for shape in shapes:
            name, b, h, tq, tk, d, causal, _ = shape
            route = expect_route(dtype, tq, d)
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
            if route == "tc":
                fns["simt"] = (lambda q, k, v, m: flash_fwd_launch(
                    "simt", q, k, v, causal, scale, m), sets)
            routes = route_counts()
            call = {k: time_ms(f, a, iters) for k, (f, a) in fns.items()}
            t = {k: device_ms(f, a, iters, f"{name} {k}")
                 for k, (f, a) in fns.items()}
            # the kernel's calls: time_ms's warm-up and iters, device_ms's
            check_route(5, f"{name} {dtype}", routes, route,
                        calls=len(sets) + 2 * iters)
            # the calls cycle through the sets: the bound of the mean call
            work = [attention_bound(q, k, m, causal) for q, k, _, m in sets]
            nbytes = sum(w[0] for w in work) / len(work)
            flops = sum(w[1] for w in work) / len(work)
            bound, bound_by = bound_ms(nbytes, flops, dtype)
            rec = {"case": name, "dtype": str(dtype).split(".")[-1],
                   "shape": [b, h, tq, tk, d], "route": route,
                   "simt_ms": t.get("simt"),
                   "ms": t["kernel"], "plain_ms": t["plain"],
                   "library_ms": t["library"], "bound_ms": bound,
                   "bound_by": bound_by, "bytes": nbytes, "flops": flops,
                   "bound_share": bound / t["kernel"],
                   "call_ms": call["kernel"], "plain_call_ms": call["plain"],
                   "library_call_ms": call["library"]}
            rows.append(rec)
            simt = (f" (the SIMT kernel {t['simt'] * 1e3:.2f} us)"
                    if "simt" in t else "")
            log(f"[numbers] flash_fwd {rec['dtype']:>8} {name:<14} "
                f"[{b},{h},{tq},{tk},{d}] device time: kernel ({route}) "
                f"{t['kernel'] * 1e3:.2f} us{simt}, plain "
                f"{t['plain'] * 1e3:.2f} "
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
    flash = [r for r in kernels if any(
        KERNEL_SYMBOLS[key] in r[0] for key in ("flash_fwd",
                                                "flash_fwd_tc"))]
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
# BERT's shape with every row keeping a key, as BERT's batches do (training
# declares an all-pad row unsupported)
BERT_TRAIN_FLASH = BERT_FLASH[:-1] + ("ragged",)
BWD_CHECK_SHAPES = [
    TRAIN_FLASH,
    BERT_TRAIN_FLASH,
    ("masked_ragged", 3, 4, 200, 300, 64, False, "ragged"),
    ("causal", 2, 8, 512, 512, 64, True, None),
    # the tensor-core dK/dV's other padded widths (Tq, Tk off its tiles),
    # causal with a kv mask (no query tile skipped), D = 128, whose bf16
    # dK/dV takes the SIMT kernel, and a batch entry whose keys are all
    # masked (p = 1 on every key: dS = dP - dvec, undamped)
    ("d16", 2, 4, 100, 130, 16, False, None),
    ("d32_causal", 2, 4, 256, 256, 32, True, None),
    ("causal_masked", 2, 4, 300, 300, 64, True, "ragged"),
    ("d128", 2, 4, 200, 200, 128, False, "ragged"),
    ("all_pad_causal", 2, 4, 130, 150, 64, True, "padding"),
]
# relative to (1 + |plain|): float32 sums of up to 4096 terms in another
# order; bfloat16 outputs round once more (2^-8 relative)
BWD_TOLERANCE = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# and relative to the plain gradient's own size, max|kernel - plain| /
# max|plain|: where the gradient's elements are far below 1 (dK and dV at
# the training shape, each key's p ~ 1/4096) the gate above is near an
# absolute 2e-2, as large as the values, and passes a kernel that drops a
# query tile or a share of its sums; this one does not. Limits: bf16 about
# twice the worst reading of the sound kernels on an H100 (7.2e-3, dv at
# the causal 512 shape; PERF.md §6); float32 read 0 (the SIMT kernels
# equal plain), held at the size of float32 sums taken in another order.
BWD_SCALED_TOLERANCE = {torch.float32: 1e-5, torch.bfloat16: 1.5e-2}
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
    """(wrapper, attribute) that counts each kernel's launches, taken once,
    before ``plain_kernels`` swaps any of them out: every forward launch,
    each forward route's, the backward kernels' (every dQ and every dK/dV
    launch, and each route's) and the fused update's."""
    if not _COUNTED:
        from paddle_tpu_torch.kernels import attention as A
        from paddle_tpu_torch.kernels import fused_update as FU
        _COUNTED.update(
            flash_fwd=(A.flash_attention, "launches"),
            flash_fwd_tc=(A.flash_fwd_cuda, "tc_launches"),
            flash_fwd_simt=(A.flash_fwd_cuda, "simt_launches"),
            flash_bwd_dq=(A.flash_bwd_dq_cuda, "launches"),
            flash_bwd_dq_tc=(A.flash_bwd_dq_cuda, "tc_launches"),
            flash_bwd_dq_simt=(A.flash_bwd_dq_cuda, "simt_launches"),
            flash_bwd_dkv=(A.flash_bwd_dkv_cuda, "launches"),
            flash_bwd_dkv_tc=(A.flash_bwd_dkv_cuda, "tc_launches"),
            flash_bwd_dkv_simt=(A.flash_bwd_dkv_cuda, "simt_launches"),
            fused_update=(FU.fused_update_step, "launches"))
    return _COUNTED


def train_counts():
    return {k: getattr(f, a) for k, (f, a) in counted_wrappers().items()}


def zero_counts():
    for f, a in counted_wrappers().values():
        setattr(f, a, 0)


FLASH_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")


def route_split(n, dtype, kernel):
    """The counts of ``kernel`` (one of ``FLASH_KERNELS``) for ``n`` calls
    at shapes whose bf16 route is the tensor cores (the training paths'):
    all on that route in bf16, all on the SIMT kernel in float32."""
    tc = n if dtype == torch.bfloat16 else 0
    return {kernel: n, f"{kernel}_tc": tc, f"{kernel}_simt": n - tc}


def flash_counts(n, dtype):
    """The counts of the forward, dQ and dK/dV, ``n`` calls each, by
    route (``route_split``)."""
    return {key: c for kernel in FLASH_KERNELS
            for key, c in route_split(n, dtype, kernel).items()}


class plain_kernels:
    """Route the flash kernels to their plain versions, behind the same
    wrappers, autograd op and remat policy: the forward, dQ and dK/dV
    (both routes of each, which ``flash_bwd_dq_cuda`` and
    ``flash_bwd_dkv_cuda`` pick between) count no launch."""

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
    """Feed every attention of the model (``MultiHeadAttention``'s call of
    ``scaled_dot_product_attention``, above the split into the flash and
    the dense route, and so whichever route the flash op takes: kernels
    or their plain versions) its keys, values and mask in a fixed random
    order; autograd puts dk and dv back. The same attention, its sums over
    the keys taken in another order, so every activation moves by rounding
    alone. The floor of T2's and B1's gates. Non-causal calls only (a
    causal mask passed as a tensor is permuted with the keys), as on both
    training paths."""

    def __init__(self, seed):
        self.seed = seed

    def __enter__(self):
        from paddle_tpu_torch.nn import attention as NA
        self.NA, self.fn = NA, NA.scaled_dot_product_attention

        def fn_p(q, k, v, mask=None, scale=None, causal=False,
                 use_flash=False):
            # one order for every call, so a remat recompute sees the
            # inputs of the forward whose outputs it reuses
            assert not causal
            gen = torch.Generator().manual_seed(self.seed)
            p = torch.randperm(k.shape[2], generator=gen).to(k.device)
            return self.fn(q, k[:, :, p].contiguous(),
                           v[:, :, p].contiguous(),
                           None if mask is None else mask[..., p], scale,
                           causal, use_flash)

        NA.scaled_dot_product_attention = fn_p
        return self

    def __exit__(self, *exc):
        self.NA.scaled_dot_product_attention = self.fn


def bwd_inputs(shape, dtype, dev, seed):
    """q, k, v, mask, the output cotangent do, and the forward's o, lse and
    dvec = sum_d(do * o), as the autograd route feeds the kernels (the
    forward kernel of the route its inputs take)."""
    from paddle_tpu_torch.kernels.attention import flash_fwd_cuda
    q, k, v, m = make_qkv(shape, dtype, dev, seed)
    g = torch.Generator(device=dev).manual_seed(seed + 7)
    do = torch.randn(q.shape, device=dev, generator=g).to(dtype)
    o, lse = flash_fwd_cuda(q, k, v, shape[6], q.shape[-1] ** -0.5, m)
    dvec = (do.float() * o.float()).sum(-1)
    return q, k, v, m, do, o, lse, dvec


def bwd_errors(got, ref):
    """A gradient against its plain version: the largest difference, that
    difference relative to (1 + |plain|) element by element, and relative
    to the largest |plain|."""
    diff = (got.float() - ref.float()).abs()
    top = diff.max().item()
    return {"max_abs_err": top,
            "rel_err": (diff / (1 + ref.float().abs())).max().item(),
            "scaled_err": top / max(ref.float().abs().max().item(), 1e-30)}


def bwd_within(err, dtype):
    """Both of T1's backward gates, on a ``bwd_errors`` record."""
    return err["rel_err"] <= BWD_TOLERANCE[dtype] and \
        err["scaled_err"] <= BWD_SCALED_TOLERANCE[dtype]


def phase_train_kernels(dev, seed):
    """T1a: the forward (on the route its inputs take, counted) against its
    plain version at every shape, then dq and dkv, fed that forward's o and
    lse, against the plain version of the backward."""
    from paddle_tpu_torch.kernels.attention import (
        flash_attention_bwd_reference, flash_attention_reference,
        flash_bwd_dkv_cuda, flash_bwd_dq_cuda)
    results, worst = [], {}
    for dtype in (torch.float32, torch.bfloat16):
        for shape in BWD_CHECK_SHAPES:
            name, b, h, tq, tk, d, causal, _ = shape
            routes = route_counts()
            want = expect_route(dtype, tq, d)
            q, k, v, m, do, o, lse, dvec = bwd_inputs(shape, dtype, dev,
                                                      seed)
            check_route("T1", f"{name} {dtype}", routes, want)
            scale = d ** -0.5
            ro, rl = flash_attention_reference(q, k, v, causal, scale, m)
            diff = (o.float() - ro.float()).abs()
            o_err = (diff / (1 + ro.float().abs())).max().item()
            lse_err = ((lse - rl).abs() / rl.abs().clamp(min=1)).max()
            ok = o_err <= TOLERANCE[dtype] and lse_err.item() <= 1e-5
            log(f"[T1] flash_fwd {want:>4} {str(dtype)[6:]:>8} {name:<14} "
                f"[{b},{h},{tq},{tk},{d}] max|o-plain| "
                f"{diff.max().item():.3e} rel {o_err:.3e} lse rel "
                f"{lse_err.item():.3e} {'ok' if ok else 'MISMATCH'}")
            if not ok:
                fail("T1", f"flash_fwd {name} {dtype}: o {o_err}, lse "
                           f"{lse_err.item()}")
            if dtype == torch.bfloat16 and shape is TRAIN_FLASH:
                worst["flash_fwd_tc"] = diff.max().item()
            del o, ro, rl, diff
            bwd_route = expect_bwd_route(dtype, d)
            dq_routes = route_counts("flash_bwd_dq")
            dq = flash_bwd_dq_cuda(q, k, v, do, lse, dvec, causal, scale, m)
            dkv_routes = route_counts("flash_bwd_dkv")
            dk, dv = flash_bwd_dkv_cuda(q, k, v, do, lse, dvec, causal, scale,
                                        m)
            torch.cuda.synchronize()
            for kernel, before in (("flash_bwd_dq", dq_routes),
                                   ("flash_bwd_dkv", dkv_routes)):
                check_route("T1", f"{name} {dtype}", before, bwd_route,
                            kernel=kernel)
            want = flash_attention_bwd_reference(q, k, v, do, lse, dvec,
                                                 causal, scale, m)
            rec = {"case": name, "dtype": str(dtype).split(".")[-1],
                   "shape": [b, h, tq, tk, d], "causal": causal,
                   "bwd_route": bwd_route}
            ok = True
            for nm, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
                rec[nm] = bwd_errors(got, ref)
                ok = ok and bool(torch.isfinite(got).all()) and \
                    bwd_within(rec[nm], dtype)
            rec["ok"] = ok
            results.append(rec)
            log(f"[T1] flash_bwd {rec['dtype']:>8} {name:<14} "
                f"[{b},{h},{tq},{tk},{d}] dq, dk/dv on {bwd_route}; "
                f"max|kernel-plain| dq "
                f"{rec['dq']['max_abs_err']:.3e} dk "
                f"{rec['dk']['max_abs_err']:.3e} dv "
                f"{rec['dv']['max_abs_err']:.3e}; rel "
                f"{max(rec[n]['rel_err'] for n in ('dq', 'dk', 'dv')):.3e} "
                f"(tol {BWD_TOLERANCE[dtype]:g}); of max|plain| dq "
                f"{rec['dq']['scaled_err']:.3e} dk "
                f"{rec['dk']['scaled_err']:.3e} dv "
                f"{rec['dv']['scaled_err']:.3e} "
                f"(tol {BWD_SCALED_TOLERANCE[dtype]:g}) "
                f"{'ok' if ok else 'MISMATCH'}")
            if not ok:
                fail("T1", f"flash_bwd {rec}")
            # the kernels line's errors at the paths' shapes, dQ and dK/dV
            # by route: the tensor cores' in bf16 and the SIMT kernels' in
            # float32, the paths where their route still runs
            if shape is TRAIN_FLASH or shape is BERT_TRAIN_FLASH:
                tc = "_tc" if bwd_route == "tc" else ""
                for key, errs in (("flash_bwd_dq", ("dq",)),
                                  ("flash_bwd_dkv", ("dk", "dv"))):
                    worst[key + tc] = max(
                        [worst.get(key + tc, 0.0)]
                        + [rec[nm]["max_abs_err"] for nm in errs])
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
        expect = dict(per_step, **route_split(fwd, torch.float32, "flash_fwd"),
                      fused_update=0) if fwd else {k: 0 for k in per_step}
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
    per_step = {**flash_counts(calls, torch.float32), "fused_update": 1}
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
    losses, _ = train_steps(model_bf, batch, STEPS, True, dict(
        per_step, **flash_counts(calls, torch.bfloat16)))
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
                  "flash_fwd_tc": "flash_fwd_tc_kernel",
                  "flash_bwd_dq": "flash_bwd_dq_kernel",
                  "flash_bwd_dq_tc": "flash_bwd_dq_tc_kernel",
                  "flash_bwd_dkv": "flash_bwd_dkv_kernel",
                  "flash_bwd_dkv_tc": "flash_bwd_dkv_tc_kernel",
                  "fused_update": "fused_update_kernel"}
# the kernels of a bf16 transformer_long step (its forward, dQ and dK/dV on
# the tensor cores)
T3_KERNELS = ("flash_fwd_tc", "flash_bwd_dq_tc", "flash_bwd_dkv_tc",
              "fused_update")
# each flash kernel on the tensor cores and its SIMT twin
FLASH_TC_TWIN = {"flash_fwd_tc": "flash_fwd",
                 "flash_bwd_dq_tc": "flash_bwd_dq",
                 "flash_bwd_dkv_tc": "flash_bwd_dkv"}


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
    calls = 2 * LONG_CFG["n_layer"]
    expect = {}
    for tc, simt in FLASH_TC_TWIN.items():
        expect.update({KERNEL_SYMBOLS[tc]: calls, KERNEL_SYMBOLS[simt]: 0})
    busy, kernels, prof_ms = profiled(step, "the training step",
                                      expect=expect)
    step_ms = sum(wall) / len(wall)
    by_kernel = {}
    for key in T3_KERNELS:
        sym = KERNEL_SYMBOLS[key]
        rows = [r for r in kernels if sym in r[0]]
        by_kernel[key] = {"count": sum(r[1] for r in rows),
                          "device_ms": sum(r[2] for r in rows)}
        if by_kernel[key]["count"] == 0:
            fail("T3", f"the profile of the step shows no {sym}")
    for tc, simt in FLASH_TC_TWIN.items():
        n_tc = by_kernel[tc]["count"]
        n_simt = sum(r[1] for r in kernels if KERNEL_SYMBOLS[simt] in r[0])
        if n_tc != calls or n_simt:
            fail("T3", f"the bf16 step ran {n_tc} tensor-core and {n_simt} "
                       f"SIMT {simt} launches, expected {calls} and 0")
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
    q, k, v, m, do, _, lse, dvec = bwd_inputs(TRAIN_FLASH, torch.bfloat16,
                                              dev, seed)
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
    numbers["flash_fwd_tc"].update(
        plain_ms=time_ms(lambda: A.flash_attention_reference(
            q, k, v, causal, scale, m), [()], 2),
        library_ms=time_ms(lambda: sdpa(q, k, v, scale=scale), [()], 3),
        bound_ms=bnd[0], bound_by=bnd[1])
    # the SIMT kernel on the same inputs, the route this shape took before
    # the tensor-core kernel (CUDA events: 13 ms calls, no launch cost)
    simt = {"ms": time_ms(lambda: A.flash_fwd_launch(
        "simt", q, k, v, causal, scale, m), [()], 2),
        "plain_ms": numbers["flash_fwd_tc"]["plain_ms"],
        "library_ms": numbers["flash_fwd_tc"]["library_ms"],
        "bound_ms": bnd[0], "bound_by": bnd[1]}
    for key, which in (("flash_bwd_dq_tc", "dq"),
                       ("flash_bwd_dkv_tc", "dkv")):
        bnd = bound_ms(*attention_bwd_bound(q, k, m, causal, which),
                       torch.bfloat16)
        # the plain version computes dq, dk and dv in one pass; no library
        # call computes dq or dk/dv alone, SDPA's backward computes all
        numbers[key].update(plain_ms=plain_bwd, library_ms=None,
                            library_pair_ms=lib_bwd, bound_ms=bnd[0],
                            bound_by=bnd[1])
    # the SIMT dQ and dK/dV on the same inputs, the route this shape took
    # before the tensor-core kernels (CUDA events: 16-20 ms calls, no
    # launch cost)
    simt_recs = {"flash_fwd": simt}
    for name, launch in (("flash_bwd_dq", A.flash_bwd_dq_launch),
                         ("flash_bwd_dkv", A.flash_bwd_dkv_launch)):
        tc = numbers[name + "_tc"]
        tc["simt_ms"] = time_ms(lambda: launch("simt", *bwd_args), [()], 2)
        simt_recs[name] = dict({key: tc[key] for key in (
            "plain_ms", "library_ms", "library_pair_ms", "bound_ms",
            "bound_by")}, ms=tc["simt_ms"])
    del q, k, v, do, ql, kl, vl, lib_o
    torch.cuda.empty_cache()
    for name, rec in simt_recs.items():
        log(f"[T3] {name} (SIMT) at the path's shape, same inputs: "
            f"{rec['ms']:.3f} ms (CUDA events) against the tensor-core "
            f"kernel's {numbers[name + '_tc']['ms']:.3f} ms (device)")

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
    numbers.update(simt_recs)
    return step_rec, numbers


# -- ResNet-50 (R1-R4) ----------------------------------------------------------

RESNET_KERNELS = ("brgemm", "brgemm_tc_fwd", "brgemm_tc_dw", "convkxk",
                  "convkxk_tc", "convkxk_dx", "convkxk_dx_tc",
                  "convkxk_dx_tc_phase", "convkxk_dw", "convkxk_dw_tc")
# each tensor-core row's SIMT twin: the same function, by another route. A
# row is named <twin>_<route>, the route the wrapper's rule names
# (``tiles.gemm_route``, ``conv_fused.kxk_fwd_route``, ``dx_route``,
# ``dw_route``) and counts in ``<wrapper>.<route>_launches``
TC_TWIN = {"convkxk_tc": "convkxk", "convkxk_dx_tc": "convkxk_dx",
           "convkxk_dx_tc_phase": "convkxk_dx",
           "convkxk_dw_tc": "convkxk_dw", "brgemm_tc_fwd": "brgemm",
           "brgemm_tc_dw": "brgemm"}
# launches of a bf16 training step of ResNet-50 with the conv and pool
# knobs on (36 1x1 convs: forward, dx and dw each; 16 3x3 convs; the stem's
# max pool) and of an eval forward
# ("pool_bwd" counts every pool backward; "pool_bwd_tile" and
# "pool_bwd_gather" the launches of each route, whose kernel rows have the
# same names: the stem's, C = 64 in float32 and bf16, takes the tile kernel)
R_PER_STEP = {"brgemm": 108, "convkxk": 16, "convkxk_dx": 16,
              "convkxk_dw": 16, "pool_fwd": 1, "pool_bwd": 1,
              "pool_bwd_tile": 1, "pool_bwd_gather": 0}
R_EVAL = {"brgemm": 36, "convkxk": 16, "convkxk_dx": 0, "convkxk_dw": 0,
          "pool_fwd": 1, "pool_bwd": 0, "pool_bwd_tile": 0,
          "pool_bwd_gather": 0}
# of those, the launches each tensor-core row takes when the convs see
# bf16: every 3x3 forward, dx and weight gradient (the 13 stride-1 dx as
# one conv, the 3 stride-2 dx, in the first bottleneck of stages 2-4, by
# phases); the 1x1 forwards and dx are mode "nn" without a fold (no conv
# of the training step has a relu or a scale in its epilogue: BatchNorm
# runs apart from it, so no dx folds), their weight gradients mode "tn"
TC_PER_STEP = {"convkxk_tc": 16, "convkxk_dx_tc": 13,
               "convkxk_dx_tc_phase": 3, "convkxk_dw_tc": 16,
               "brgemm_tc_fwd": 72, "brgemm_tc_dw": 36}
TC_EVAL = {"convkxk_tc": 16, "convkxk_dx_tc": 0, "convkxk_dx_tc_phase": 0,
           "convkxk_dw_tc": 0, "brgemm_tc_fwd": 36, "brgemm_tc_dw": 0}
# the kernel launches one call of a tensor-core row makes where it is not
# one: a stride-2 3x3 dx (padding 1) by phases runs its 4 phases, each with
# taps (``conv_fused.dx_phases``)
TC_RECORDS = {"convkxk_dx_tc_phase": 4}
# the step with the pool knob off
R_POOL_OFF = dict(R_PER_STEP, pool_fwd=0, pool_bwd=0, pool_bwd_tile=0)
# the pool kernel rows, each counted under its own name in R_PER_STEP
POOL_ROWS = ("pool_fwd", "pool_bwd_tile", "pool_bwd_gather")
# the dtype the eval forward's convs see in the pure bf16 model: the stem's
# BatchNorm (float32 running stats) promotes the activation to float32
EVAL_DTYPE = torch.float32
# (forward, backward) gates, relative to the output's largest magnitude
R_TOL = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (2e-2, 2e-2)}
R_SIZE, R1_BATCH, R2_BATCH, R3_BATCH = 224, 8, 32, 256
R2_STEPS, R3_TIMED = 2, 3
# the profiled kernels' names: each SIMT kernel's loader type is in its
# template arguments (the split-K reductions carry it too); the tensor-core
# forward's kernel holds "conv_kxk_fwd_tc", the tensor-core weight
# gradient's kernel and its reduction's tag "conv_kxk_dw_tc", at a 3x3
# geometry, at a 3x3 dx's and at brgemm's 1x1 one alike
R_SYMBOLS = {"brgemm": "DenseA", "brgemm_tc_fwd": "conv_kxk_fwd_tc",
             "brgemm_tc_dw": "conv_kxk_dw_tc", "convkxk": "XRows",
             "convkxk_tc": "conv_kxk_fwd_tc", "convkxk_dx": "DyRows",
             "convkxk_dx_tc": "conv_kxk_fwd_tc",
             "convkxk_dx_tc_phase": "conv_kxk_fwd_tc",
             "convkxk_dw": "XCols", "convkxk_dw_tc": "conv_kxk_dw_tc",
             "pool_fwd": "pool_fwd_kernel",
             "pool_bwd_gather": "pool_bwd_kernel",
             "pool_bwd_tile": "pool_bwd_tile_kernel"}
# the tensor-core forward's kernel (one a launch)
FWD_TC_KERNEL = "conv_kxk_fwd_tc_kernel"
# the tensor-core weight gradient's GEMM alone (one a launch)
DW_TC_KERNEL = "conv_kxk_dw_tc_kernel"
# each tensor-core row's kernel, one a launch
TC_KERNEL = {"convkxk_tc": FWD_TC_KERNEL, "convkxk_dx_tc": FWD_TC_KERNEL,
             "convkxk_dx_tc_phase": FWD_TC_KERNEL,
             "brgemm_tc_fwd": FWD_TC_KERNEL, "convkxk_dw_tc": DW_TC_KERNEL,
             "brgemm_tc_dw": DW_TC_KERNEL}
# a profiled bf16 step's count of each: the 16 3x3 forwards, 13 stride-1
# 3x3 dx, 3 x 4 phases of the stride-2 ones and 72 1x1 "nn" GEMMs on the
# tensor-core forward (113), the 16 3x3 and 36 1x1 weight gradients on the
# tensor-core weight gradient; each SIMT twin the launches its tensor-core
# rows leave it (none)
TC_IN_STEP = {**{sym: sum(n * TC_RECORDS.get(r, 1)
                          for r, n in TC_PER_STEP.items()
                          if TC_KERNEL[r] == sym)
                 for sym in (FWD_TC_KERNEL, DW_TC_KERNEL)},
              **{R_SYMBOLS[simt]: R_PER_STEP[simt] - sum(
                  TC_PER_STEP[r] for r, twin in TC_TWIN.items()
                  if twin == simt)
                 for simt in TC_TWIN.values()}}


def tc_rows(name):
    """The tensor-core rows of the SIMT kernel ``name`` (``TC_TWIN``)."""
    return [r for r, twin in TC_TWIN.items() if twin == name]


def routes(dtype, base=R_PER_STEP, names=tuple(dict.fromkeys(
        TC_TWIN.values())), tc=TC_PER_STEP):
    """``base``'s launches with each named kernel's count split by route,
    as ``r_counts()`` reads them: each of its tensor-core rows takes its
    count in ``tc`` when the convs see bf16 and none in float32,
    ``<name>_simt`` the rest (every conv of ResNet-50 has C and O
    multiples of 64, so only the dtype and, for brgemm, the mode and the
    fold, decide)."""
    out = dict(base)
    for name in names:
        rows = tc_rows(name)
        for r in rows:
            out[r] = tc[r] if dtype == torch.bfloat16 else 0
        out[f"{name}_simt"] = base[name] - sum(out[r] for r in rows)
    return out


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


_R_COUNTED = {}


def r_counters():
    """(wrapper, attribute) that counts each ResNet kernel's launches, and
    brgemm's and each 3x3 kernel's by route, taken
    once, before ``plain_conv_kernels`` swaps any wrapper out."""
    if not _R_COUNTED:
        from paddle_tpu_torch.kernels import conv_fused as cf
        from paddle_tpu_torch.kernels import pool_fused as pf
        from paddle_tpu_torch.kernels import tiles
        _R_COUNTED.update(
            brgemm=(tiles.brgemm, "launches"),
            brgemm_tc_fwd=(tiles.brgemm_cuda, "tc_fwd_launches"),
            brgemm_tc_dw=(tiles.brgemm_cuda, "tc_dw_launches"),
            brgemm_simt=(tiles.brgemm_cuda, "simt_launches"),
            convkxk=(cf.convkxk, "launches"),
            convkxk_tc=(cf.convkxk_cuda, "tc_launches"),
            convkxk_simt=(cf.convkxk_cuda, "simt_launches"),
            convkxk_dx=(cf.convkxk_dx, "launches"),
            convkxk_dx_tc=(cf.convkxk_dx_cuda, "tc_launches"),
            convkxk_dx_tc_phase=(cf.convkxk_dx_cuda, "tc_phase_launches"),
            convkxk_dx_simt=(cf.convkxk_dx_cuda, "simt_launches"),
            convkxk_dw=(cf.convkxk_dw, "launches"),
            convkxk_dw_tc=(cf.convkxk_dw_cuda, "tc_launches"),
            convkxk_dw_simt=(cf.convkxk_dw_cuda, "simt_launches"),
            pool_fwd=(pf.pool_fwd, "launches"),
            pool_bwd=(pf.pool_bwd, "launches"),
            pool_bwd_tile=(pf.pool_bwd, "tile_launches"),
            pool_bwd_gather=(pf.pool_bwd, "gather_launches"))
    return _R_COUNTED


def r_counts():
    return {k: getattr(f, a) for k, (f, a) in r_counters().items()}


def zero_r_counts():
    for f, a in r_counters().values():
        setattr(f, a, 0)


def set_resnet_knobs(pool=True):
    """The conv kernels on, the stem's max pool on the fused kernels or
    not, as ``bench.run`` sets them from the environment."""
    from paddle_tpu_torch.kernels import pool_fused as pf
    from paddle_tpu_torch.ops import nn_ops
    nn_ops.set_conv_fused(True)
    pf.set_pool_fused(pool)


class plain_conv_kernels:
    """Route the conv and pool kernels' wrappers to their plain versions."""
    SWAPS = (("tiles", "brgemm_cuda", "brgemm_reference"),
             ("cf", "convkxk_cuda", "convkxk_reference"),
             ("cf", "convkxk_dx_cuda", "convkxk_dx_reference"),
             ("cf", "convkxk_dw_cuda", "convkxk_dw_reference"),
             ("pf", "pool_fwd_cuda", "pool_fwd_reference"),
             ("pf", "pool_bwd_cuda", "pool_bwd_reference"))

    def __enter__(self):
        from paddle_tpu_torch.kernels import conv_fused as cf
        from paddle_tpu_torch.kernels import pool_fused as pf
        from paddle_tpu_torch.kernels import tiles
        r_counters()
        self.mods = {"tiles": tiles, "cf": cf, "pf": pf}
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


def conv_calls(shape, x, w, g, extra=None, route=None):
    """{kernel: (cuda call, plain call)} of one conv shape: the three
    calls a training step makes (1x1: brgemm forward, dx, dw). ``extra``
    adds the epilogue to the forward and the fold to the backward:
    (scale, bias, residual, saved output). ``route`` ({call: route})
    makes the named calls launch that route's kernel uncounted
    (``brgemm_launch``, ``convkxk_launch``, ``convkxk_dx_launch``,
    ``convkxk_dw_launch``) in place of the counted wrapper and its rule."""
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
        out = {f"brgemm_{d}": (lambda kw=kw: tiles.brgemm_cuda(**kw),
                               lambda kw=kw: tiles.brgemm_reference(**kw))
               for d, kw in (("fwd", fwd), ("dx", dx), ("dw", dw))}
        for d, kw in (("fwd", fwd), ("dx", dx), ("dw", dw)):
            r = (route or {}).get(f"brgemm_{d}")
            if r is not None:
                out[f"brgemm_{d}"] = (
                    lambda kw=kw, r=r: tiles.brgemm_launch(r, **kw),
                    out[f"brgemm_{d}"][1])
        return out
    geo = ((s, s), ((1, 1), (1, 1)), (1, 1))
    fwd = (x, w, ep_kw.get("scale"), ep_kw.get("bias"),
           ep_kw.get("residual"), bool(ep_kw), *geo)
    bwd_dx = (g, fold[0], fold[1], w, x.shape, dtype, *geo)
    bwd_dw = (g, fold[0], fold[1], x, w.shape, dtype, *geo)
    out = {"convkxk": (lambda: cf.convkxk_cuda(*fwd),
                       lambda: cf.convkxk_reference(*fwd)),
           "convkxk_dx": (lambda: cf.convkxk_dx_cuda(*bwd_dx),
                          lambda: cf.convkxk_dx_reference(*bwd_dx)),
           "convkxk_dw": (lambda: cf.convkxk_dw_cuda(*bwd_dw),
                          lambda: cf.convkxk_dw_reference(*bwd_dw))}
    for name, launch, args in (("convkxk", cf.convkxk_launch, fwd),
                               ("convkxk_dx", cf.convkxk_dx_launch, bwd_dx),
                               ("convkxk_dw", cf.convkxk_dw_launch, bwd_dw)):
        r = (route or {}).get(name)
        if r is not None:
            out[name] = (lambda launch=launch, r=r, args=args:
                         launch(r, *args), out[name][1])
    return out


def route_taken(before, name):
    """The route of the one launch of ``name`` (``"brgemm"``,
    ``"convkxk"``, ``"convkxk_dx"`` or ``"convkxk_dw"``) since ``before`` (an
    ``r_counts()``), or None when it was not exactly one launch."""
    after = r_counts()
    got = {r: after[r] - before[r] for r in (*tc_rows(name), f"{name}_simt")}
    taken = [r for r, n in got.items() if n]
    if len(taken) != 1 or got[taken[0]] != 1:
        return None
    return taken[0][len(name) + 1:]


def want_route(call, dtype, folded, stride):
    """The route the port's rules name for one of ``conv_calls``' calls at
    a ResNet-50 shape (C and O multiples of 64) with the conv's ``stride``:
    float32 on SIMT; in bf16 the 3x3 forward and weight gradient on the
    tensor cores, the 1x1 forward and weight gradient on the tensor-core
    conv kernels, the 1x1 dx with them too and the 3x3 dx on the
    tensor-core forward unless it folds the cotangent (``folded``: a relu
    mask or a scale), at ``stride`` 1 as one conv, at 2 by phases; a
    folding dx stays on SIMT."""
    if dtype != torch.bfloat16:
        return "simt"
    return {"convkxk": "tc", "convkxk_dw": "tc", "brgemm_fwd": "tc_fwd",
            "brgemm_dx": "simt" if folded else "tc_fwd",
            "convkxk_dx": "simt" if folded else
            "tc" if stride == 1 else "tc_phase",
            "brgemm_dw": "tc_dw"}[call]


# R1's further tensor-core forward cases (bf16): (case, shape (h, c, o, k,
# stride), batch, dilation, epilogue, out_dtype): a dilated conv (padding
# 2), an M that is no multiple of the 128-row tile (3 x 5 x 5 = 75), O =
# 192 (three 64-column tiles), a float32 output, and the eval chain
# (scale, bias, relu; no residual) at the last stage's shape
R1_FWD_TC_CASES = [
    ("dilated", (28, 64, 64, 3, 1), R1_BATCH, 2, False, None),
    ("ragged_m", (9, 64, 64, 3, 2), 3, 1, False, None),
    ("o192", (14, 64, 192, 3, 1), R1_BATCH, 1, False, None),
    ("f32_out", (28, 128, 128, 3, 1), R1_BATCH, 1, False, torch.float32),
    ("eval_chain", (7, 512, 512, 3, 1), R1_BATCH, 1, True, None),
]


def fwd_tc_cases(dev, seed):
    """R1's further bf16 cases of the tensor-core forward through
    ``convkxk_cuda`` (route asserted) against the plain version, at the
    forward's gate."""
    from paddle_tpu_torch.kernels import conv_fused as cf
    f_tol, _ = R_TOL[torch.bfloat16]
    out = []
    for case, shape, batch, dil, epi, out_dtype in R1_FWD_TC_CASES:
        h, c, o, k, s = shape
        x, w, _ = r_inputs(shape, batch, torch.bfloat16, dev, seed)
        pad = dil * (k - 1) // 2
        scale = bias = None
        if epi:
            gen = torch.Generator(device=dev).manual_seed(seed + 3)
            scale = torch.rand(o, device=dev, generator=gen) + 0.5
            bias = torch.randn(o, device=dev, generator=gen)
        args = (x, w, scale, bias, None, epi, (s, s),
                ((pad, pad), (pad, pad)), (dil, dil), out_dtype)
        before = r_counts()
        got = cf.convkxk_cuda(*args)
        torch.cuda.synchronize()
        route = route_taken(before, "convkxk")
        ref = cf.convkxk_reference(*args)
        diff = (got.float() - ref.float()).abs().max().item()
        rel = diff / max(ref.float().abs().max().item(), 1e-30)
        ok = route == "tc" and bool(torch.isfinite(got).all()) and \
            rel <= f_tol and got.dtype == ref.dtype and \
            got.shape == ref.shape
        rec = {"kernel": "convkxk", "route": route, "case": case,
               "dtype": "bfloat16", "shape": list(shape), "batch": batch,
               "dilation": dil, "epilogue": epi,
               "out_dtype": str(got.dtype).split(".")[-1],
               "max_abs_err": diff, "rel_err": rel, "ok": ok}
        out.append(rec)
        log(f"[R1] convkxk {route} bfloat16 {case:<10} {shape} batch {batch} "
            f"dilation {dil} epilogue {epi} out {rec['out_dtype']}: "
            f"|kernel-plain| / max|plain| {rel:.3e} (gate {f_tol:g}) "
            f"{'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail("R1", f"{rec}")
    return out


# R1's further tensor-core weight-gradient cases (bf16): (case, shape (h,
# c, o, k, stride), batch, dilation, fold, splits): a dilated conv (padding
# 2, as M2's ASPP would send), a K that is no multiple of the K step, and
# one split and the most splits (one K step each), so both store paths run
R1_DW_TC_CASES = [
    ("dilated", (28, 64, 64, 3, 1), R1_BATCH, 2, True, None),
    ("ragged_k", (9, 64, 64, 3, 2), 3, 1, False, None),
    ("one_split", (28, 128, 128, 3, 1), R1_BATCH, 1, False, 1),
    ("most_splits", (28, 128, 128, 3, 1), R1_BATCH, 1, True, "most"),
]


def dw_tc_cases(dev, seed):
    """R1's further bf16 cases of the tensor-core weight gradient against
    the plain version: the dilated and ragged ones through
    ``convkxk_dw_cuda`` (route asserted), the forced split counts through
    ``convkxk_dw_launch("tc", ..., splits=)``."""
    from paddle_tpu_torch.kernels import conv_fused as cf
    _, b_tol = R_TOL[torch.bfloat16]
    out = []
    for case, shape, batch, dil, fold, splits in R1_DW_TC_CASES:
        h, c, o, k, s = shape
        x, w, _ = r_inputs(shape, batch, torch.bfloat16, dev, seed)
        pad = dil * (k - 1) // 2
        oh = (h + 2 * pad - dil * (k - 1) - 1) // s + 1
        gen = torch.Generator(device=dev).manual_seed(seed + 2)
        g = torch.randn(batch, oh, oh, o, device=dev,
                        generator=gen).to(torch.bfloat16)
        mask = scale = None
        if fold:
            scale = torch.rand(o, device=dev, generator=gen) + 0.5
            mask = torch.relu(torch.randn(g.shape, device=dev,
                                          generator=gen)).to(torch.bfloat16)
        args = (g, mask, scale, x, w.shape, torch.bfloat16, (s, s),
                ((pad, pad), (pad, pad)), (dil, dil))
        before = r_counts()
        if splits is None:
            got = cf.convkxk_dw_cuda(*args)
            torch.cuda.synchronize()
            route = route_taken(before, "convkxk_dw")
        else:
            k_len = batch * oh * oh
            n_split = -(-k_len // 64) if splits == "most" else splits
            got = cf.convkxk_dw_launch("tc", *args, splits=n_split)
            torch.cuda.synchronize()
            route = "tc" if r_counts() == before else None
        ref = cf.convkxk_dw_reference(*args)
        diff = (got.float() - ref.float()).abs().max().item()
        rel = diff / max(ref.float().abs().max().item(), 1e-30)
        ok = route == "tc" and bool(torch.isfinite(got).all()) and \
            rel <= b_tol and got.dtype == ref.dtype and \
            got.shape == ref.shape
        rec = {"kernel": "convkxk_dw", "route": route, "case": case,
               "dtype": "bfloat16", "shape": list(shape), "batch": batch,
               "dilation": dil, "fold": fold, "splits": splits,
               "max_abs_err": diff, "rel_err": rel, "ok": ok}
        out.append(rec)
        log(f"[R1] convkxk_dw {route} bfloat16 {case:<11} {shape} batch "
            f"{batch} dilation {dil} fold {fold} splits {splits}: "
            f"|kernel-plain| / max|plain| {rel:.3e} (gate {b_tol:g}) "
            f"{'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail("R1", f"{rec}")
    return out


# R1's further tensor-core dx cases (bf16, no fold): (case, x's (h, w, c),
# o, batch, padding, dilation, x_dtype, stride, the route ``dx_route``
# names): a dilated conv (padding 2), an uneven padding whose low pad of g
# is negative (3 - 2 = 1 row past the top of x: (k - 1) * d - p0 = -1)
# with C != O, an M that is no multiple of the 128-row tile (3 x 9 x 9 =
# 243), and a float32 dx; by phases at stride 2 a ragged M (3 x 5 x 5 =
# 75 a phase), an odd H with C != O, a stride of (2, 1), a float32 dx, a
# dilation of 2 (padding 2), whose phases but (0, 0) no tap reaches, and O
# = C = 192 (the 64-column tile); at stride 3 with C != O
R1_DX_TC_CASES = [
    ("dilated", (28, 28, 64), 64, R1_BATCH, ((2, 2), (2, 2)), 2, None,
     (1, 1), "tc"),
    ("uneven_pad", (14, 13, 64), 128, R1_BATCH, ((3, 0), (0, 2)), 1, None,
     (1, 1), "tc"),
    ("ragged_m", (9, 9, 64), 64, 3, ((1, 1), (1, 1)), 1, None, (1, 1),
     "tc"),
    ("f32_out", (28, 28, 128), 128, R1_BATCH, ((1, 1), (1, 1)), 1,
     torch.float32, (1, 1), "tc"),
    ("s2_ragged_m", (9, 9, 64), 64, 3, ((1, 1), (1, 1)), 1, None, (2, 2),
     "tc_phase"),
    ("s2_odd_h", (27, 27, 128), 64, R1_BATCH, ((1, 1), (1, 1)), 1, None,
     (2, 2), "tc_phase"),
    ("s21", (14, 14, 64), 128, R1_BATCH, ((1, 1), (1, 1)), 1, None, (2, 1),
     "tc_phase"),
    ("s2_f32_out", (28, 28, 128), 128, R1_BATCH, ((1, 1), (1, 1)), 1,
     torch.float32, (2, 2), "tc_phase"),
    ("s2_empty_phase", (28, 28, 64), 64, R1_BATCH, ((2, 2), (2, 2)), 2,
     None, (2, 2), "tc_phase"),
    ("s2_o192", (14, 14, 192), 192, R1_BATCH, ((1, 1), (1, 1)), 1, None,
     (2, 2), "tc_phase"),
    ("s3", (20, 21, 64), 128, R1_BATCH, ((1, 1), (1, 1)), 1, None, (3, 3),
     "tc_phase"),
]


def dx_tc_cases(dev, seed):
    """R1's further bf16 cases of the tensor-core dx through
    ``convkxk_dx_cuda`` (the route each case names asserted) against the
    plain version, at the backward's gate, at each case's stride."""
    from paddle_tpu_torch.kernels import conv_fused as cf
    _, b_tol = R_TOL[torch.bfloat16]
    out = []
    for case, (h, wd, c), o, batch, pad, dil, x_dtype, stride, want in \
            R1_DX_TC_CASES:
        gen = torch.Generator(device=dev).manual_seed(seed + 4)
        x_shape = (batch, h, wd, c)
        w = (torch.randn(o, c, 3, 3, device=dev, generator=gen)
             * (9 * o) ** -0.5).to(torch.bfloat16)
        geo = cf.geometry(x_shape, w.shape, stride, pad, (dil, dil))
        g = torch.randn(batch, geo[7], geo[8], o, device=dev,
                        generator=gen).to(torch.bfloat16)
        args = (g, None, None, w, x_shape, x_dtype or torch.bfloat16, stride,
                pad, (dil, dil))
        before = r_counts()
        got = cf.convkxk_dx_cuda(*args)
        torch.cuda.synchronize()
        route = route_taken(before, "convkxk_dx")
        ref = cf.convkxk_dx_reference(*args)
        diff = (got.float() - ref.float()).abs().max().item()
        rel = diff / max(ref.float().abs().max().item(), 1e-30)
        ok = route == want and bool(torch.isfinite(got).all()) and \
            rel <= b_tol and got.dtype == ref.dtype and \
            got.shape == ref.shape
        rec = {"kernel": "convkxk_dx", "route": route, "case": case,
               "dtype": "bfloat16", "x_shape": list(x_shape), "o": o,
               "padding": [list(p) for p in pad], "dilation": dil,
               "stride": list(stride),
               "out_dtype": str(got.dtype).split(".")[-1],
               "max_abs_err": diff, "rel_err": rel, "ok": ok}
        out.append(rec)
        log(f"[R1] convkxk_dx {route} bfloat16 {case:<11} x {x_shape} O {o} "
            f"stride {stride} padding {pad} dilation {dil} out "
            f"{rec['out_dtype']}: |kernel-plain| / max|plain| {rel:.3e} "
            f"(gate {b_tol:g}) {'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail("R1", f"{rec}")
    return out


def phase_resnet_kernels(dev, seed):
    """R1: every kernel against its plain version at every distinct conv
    shape of ResNet-50 at 224 (batch 8), forward, dx and dw, in float32
    and bfloat16; the epilogue and the fold at a strided 1x1, a strided
    3x3 and a stride-1 3x3; each call on the route ``gemm_route``,
    ``kxk_fwd_route``, ``dx_route`` and ``dw_route`` name (``want_route``:
    the tensor cores in bf16, SIMT in float32 and for a dx that folds) and
    the 3x3 tensor-core kernels' further cases
    (``fwd_tc_cases``, ``dx_tc_cases``, ``dw_tc_cases``); max-pool ties on
    NHWC CUDA tensors."""
    results, worst = [], {}
    distinct = sorted(set(resnet50_conv_shapes()))
    extra_shapes = [(56, 256, 512, 1, 2), (56, 128, 128, 3, 2),
                    (28, 128, 128, 3, 1)]
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
                    before = r_counts()
                    got = kern()
                    torch.cuda.synchronize()
                    kernel = "brgemm" if name.startswith("brgemm") else name
                    route = want_route(name, dtype, extra is not None,
                                       shape[4])
                    taken = route_taken(before, kernel)
                    if taken != route:
                        fail("R1", f"{name} {shape} {dtype}: route "
                                   f"{taken}, expected {route}")
                    ref = plain()
                    diff = (got.float() - ref.float()).abs().max().item()
                    rel = diff / max(ref.float().abs().max().item(), 1e-30)
                    tol = f_tol if name in ("brgemm_fwd", "convkxk") \
                        else b_tol
                    ok = bool(torch.isfinite(got).all()) and rel <= tol \
                        and got.dtype == ref.dtype and got.shape == ref.shape
                    rec = {"kernel": name, "route": route, "case": case,
                           "dtype": str(dtype).split(".")[-1],
                           "shape": list(shape), "max_abs_err": diff,
                           "rel_err": rel, "ok": ok}
                    results.append(rec)
                    if not ok:
                        fail("R1", f"{rec}")
                    # each kernel row's error on the path's calls it takes:
                    # a SIMT twin's float32 ones (R2), a tensor-core row's
                    # bf16 ones (R3)
                    key = kernel if route == "simt" else f"{kernel}_{route}"
                    if case == "path":
                        worst[key] = max(worst.get(key, 0.0), diff)
                del x, w, g, extra
        torch.cuda.empty_cache()
    results += fwd_tc_cases(dev, seed)
    results += dx_tc_cases(dev, seed)
    results += dw_tc_cases(dev, seed)
    summary = {}
    for r in results:
        key = (r["kernel"], r["route"] or "", r["dtype"], r["case"])
        n, w = summary.get(key, (0, 0.0))
        summary[key] = (n + 1, max(w, r["rel_err"]))
    for (name, route, dt, case), (n, w) in summary.items():
        log(f"[R1] {name:<11} {route:>6} {dt:>8} {case:<13} {n:2d} shapes, "
            f"every one within its gate; worst |kernel-plain| / max|plain| "
            f"{w:.3e}")
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
    its floor; 108/16/16/16 conv and 1/1 pool launches a step through the
    kernels (the pool knob is on, so the fused max pool sits inside the
    same gates), every 1x1 GEMM and 3x3 forward and weight gradient on the
    SIMT kernels (float32), none through the plain versions."""
    from paddle_tpu_torch import bench
    set_resnet_knobs(pool=True)
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
        want = routes(torch.float32)
        if not route.startswith("kernel"):
            want = {k: 0 for k in want}
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
           # over the kernel runs' steps: the SIMT forward's and weight
           # gradient's main path since the bf16 step takes the tensor cores
           "launches": {k: sum(c[k] for r in ("kernel", "kernel_perm")
                               for c in runs[r]["counts"])
                        for k in runs["kernel"]["counts"][0]},
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
    256 x 224 in bf16 with the conv and pool knobs on
    (``PADDLE_TPU_POOL_FUSED`` set), lowp default then ``lowp=""``. In
    each: a warm-up step; the counted step of the main path (counts set to
    0 just before, read just after: 108/16/16/16 conv, the 16 3x3
    forwards, the 16 3x3 dx (13 at stride 1 as one conv, 3 at stride 2 by
    phases) and the 16 weight gradients
    on the tensor cores, the 108 1x1 GEMMs 72 on the tensor-core forward
    and 36 on the tensor-core weight gradient (``routes``), 1/1 pool);
    timed steps (imgs/s over all of them); one profiled step (device busy
    time, idle share over its own wall time, ``TC_IN_STEP``'s 113
    tensor-core forwards, 52 tensor-core weight-gradient GEMMs and no
    SIMT brgemm, 3x3 forward, dx or weight gradient in its own count,
    and in the lowp default each
    kernel's device time from its own launches). In the lowp default also
    a counted step with the pool knob off (no pool launch) and timed steps
    with the knob off and on in turns (off, on, on, off, ...). In
    ``lowp=""`` an eval forward with the conv+BN+relu epilogue: 36 brgemm,
    16 convkxk and 1 pool_fwd launches, finite logits. It is float32 from
    the stem's BatchNorm on (float32 running stats promote the bf16
    activation), so its 16 3x3 forwards and 36 1x1 ones take the SIMT
    kernels (``EVAL_DTYPE``)."""
    from paddle_tpu_torch import bench
    set_resnet_knobs(pool=True)
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
        if counts != routes(torch.bfloat16):
            fail("R3", f"{label}: launches in the step {counts}, expected "
                       f"{routes(torch.bfloat16)}")
        rec = {}
        if lowp:
            set_resnet_knobs(pool=False)
            zero_r_counts()
            losses.append(step().item())
            torch.cuda.synchronize()
            rec["launches_pool_off"] = r_counts()
            want = routes(torch.bfloat16, R_POOL_OFF)
            if rec["launches_pool_off"] != want:
                fail("R3", f"{label}, pool knob off: launches "
                           f"{rec['launches_pool_off']}, expected {want}")
        walls = {True: [], False: []}
        # knob off and on in turns, R3_TIMED steps each, in the lowp default
        turns = [False, True, True, False, False, True] if lowp else \
            [True] * R3_TIMED
        for pool in turns:
            set_resnet_knobs(pool=pool)
            t0 = time.perf_counter()
            loss = step()
            torch.cuda.synchronize()
            walls[pool].append((time.perf_counter() - t0) * 1e3)
            losses.append(loss.item())
        set_resnet_knobs(pool=True)
        wall = walls[True]
        # the profile's own count of the kernels the gates count: the
        # pool kernels (the backward on the tile kernel, none on the
        # gather), the tensor-core conv kernels and the SIMT twins
        expect = {R_SYMBOLS[row]: R_PER_STEP[row] for row in POOL_ROWS}
        expect.update(TC_IN_STEP)
        busy, kernels, prof_ms = profiled(
            step, f"the ResNet-50 step ({label})", expect=expect)
        step_ms = sum(wall) / len(wall)
        if not all(math.isfinite(v) for v in losses):
            fail("R3", f"{label}: non-finite loss {losses}")
        if walls[False]:
            off_ms = sum(walls[False]) / len(walls[False])
            rec.update(wall_ms_pool_off=walls[False], step_ms_pool_off=off_ms,
                       imgs_per_s_pool_off=R3_BATCH / off_ms * 1e3)
        rec.update(
            losses=losses, launches=counts, wall_ms=wall, step_ms=step_ms,
            imgs_per_s=R3_BATCH / step_ms * 1e3,
            device_busy_ms=busy or None, profiled_wall_ms=prof_ms,
            idle_share=(1.0 - busy / prof_ms) if busy else None,
            top_kernels=[{"name": n[:120], "count": c, "device_ms": t}
                         for n, c, t in kernels[:15]])
        if kernels:
            rec["kernels_in_step"] = {
                key: {"count": sum(r[1] for r in kernels if sym in r[0]),
                      "device_ms": sum(r[2] for r in kernels
                                       if sym in r[0])}
                for key, sym in R_SYMBOLS.items()}
            tc = {sym: sum(r[1] for r in kernels if sym in r[0])
                  for sym in TC_IN_STEP}
            rec["tc_kernels_in_step"] = tc
            if tc != TC_IN_STEP:
                fail("R3", f"{label}: the profiled step ran the conv "
                           f"kernels {tc}, expected {TC_IN_STEP}: every 3x3 "
                           f"forward, dx and weight gradient and every 1x1 "
                           f"GEMM on the tensor cores")
            pools = {row: rec["kernels_in_step"][row]["count"]
                     for row in POOL_ROWS}
            if pools != {row: R_PER_STEP[row] for row in POOL_ROWS}:
                fail("R3", f"{label}: the profiled step ran the pool "
                           f"kernels {pools}: expected one forward and the "
                           f"one backward on the tile kernel, none on the "
                           f"gather")
        log(f"[R3] {label}: losses {', '.join(f'{v:.4f}' for v in losses)}; "
            f"launches a step {counts}; pool knob on: step "
            f"{', '.join(f'{t:.1f}' for t in wall)} ms, "
            f"{rec['imgs_per_s']:.1f} imgs/s over them; profiled step: "
            f"device busy {busy:.1f} of {prof_ms:.1f} ms (idle share "
            f"{rec['idle_share'] if busy else float('nan'):.3f})")
        if walls[False]:
            log(f"[R3] {label}: pool knob off: launches "
                f"{rec['launches_pool_off']}; step "
                f"{', '.join(f'{t:.1f}' for t in walls[False])} ms, "
                f"{rec['imgs_per_s_pool_off']:.1f} imgs/s over them (on/off "
                f"{rec['imgs_per_s'] / rec['imgs_per_s_pool_off']:.4f})")
        for n, c, t in kernels[:12]:
            log(f"[R3]   {t:9.3f} ms {c:6d}x  {n[:100]}")
        if lowp == "":
            model.eval()
            zero_r_counts()
            with torch.no_grad():
                logits = model(x)
            torch.cuda.synchronize()
            ev = r_counts()
            want = routes(EVAL_DTYPE, R_EVAL, tc=TC_EVAL)
            finite = bool(torch.isfinite(logits).all())
            ok = ev == want and finite and \
                tuple(logits.shape) == (R3_BATCH, 1000)
            rec["eval"] = {"launches": ev, "logits_dtype": str(logits.dtype),
                           "finite": finite, "ok": ok}
            log(f"[R3] eval forward (conv+BN+relu epilogue): launches {ev}, "
                f"logits {tuple(logits.shape)} {logits.dtype} finite: "
                f"{finite}")
            if not ok:
                fail("R3", f"eval forward: launches {ev}, expected {want}; "
                           f"logits finite: {finite}")
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


# R4's timed parts: (row, route, the ``conv_calls`` calls it launches on
# that route) over the bf16 step's calls, and the four profiled sessions
# that run them, in each of which no part's kernel symbol repeats. A
# tensor-core row shares its kernel with another (the 3x3 forward's runs
# the 1x1 "nn" GEMMs and the 3x3 dx, the weight gradient's the "tn" ones),
# so the step's own profile cannot time it apart
R4_PARTS = {
    "brgemm_nn": ("brgemm", "simt", ("brgemm_fwd", "brgemm_dx")),
    "brgemm_tn": ("brgemm", "simt", ("brgemm_dw",)),
    "brgemm_tc_fwd": ("brgemm_tc_fwd", "tc_fwd", ("brgemm_fwd",
                                                  "brgemm_dx")),
    "brgemm_tc_dw": ("brgemm_tc_dw", "tc_dw", ("brgemm_dw",)),
    "convkxk": ("convkxk", "simt", ("convkxk",)),
    "convkxk_tc": ("convkxk_tc", "tc", ("convkxk",)),
    "convkxk_dx_s1": ("convkxk_dx", "simt", ("convkxk_dx",)),
    "convkxk_dx_s2": ("convkxk_dx", "simt", ("convkxk_dx",)),
    "convkxk_dx_tc_s1": ("convkxk_dx_tc", "tc", ("convkxk_dx",)),
    "convkxk_dx_tc_phase": ("convkxk_dx_tc_phase", "tc_phase",
                            ("convkxk_dx",)),
    "convkxk_dw": ("convkxk_dw", "simt", ("convkxk_dw",)),
    "convkxk_dw_tc": ("convkxk_dw_tc", "tc", ("convkxk_dw",)),
}
# the conv strides whose calls a part takes (all where it is not named):
# the dx is timed at stride 1 and at stride 2 apart on every route
R4_STRIDES = {"convkxk_dx_s1": (1,), "convkxk_dx_s2": (2,),
              "convkxk_dx_tc_s1": (1,), "convkxk_dx_tc_phase": (2,)}
R4_SESSIONS = (("brgemm_nn", "convkxk_tc", "convkxk_dw_tc", "convkxk",
                "convkxk_dw", "convkxk_dx_s1"),
               ("brgemm_tn", "brgemm_tc_fwd", "brgemm_tc_dw"),
               ("convkxk_dx_tc_s1", "convkxk_dx_s2"),
               ("convkxk_dx_tc_phase",))
# the rows whose library call R4 also times by device time, on the row's
# own calls in a session of its own (its CUDA-events time counts the
# host's gaps in), and the symbol of the library's kernel, one record a
# call: the stride-2 dx, whose cuDNN call runs one implicit-GEMM dgrad
# kernel (beside a memset of dx, under a microsecond, not counted)
R4_LIBRARY_SYMBOL = {"convkxk_dx_tc_phase": "dgrad"}


# throwaway kernels launched at the start of each R4 session
R4_LEAD_IN = 8


def part_takes(part, call, stride):
    """Whether the R4 part ``part`` launches ``call`` of a conv of
    ``stride``."""
    return call in R4_PARTS[part][2] and \
        stride in R4_STRIDES.get(part, (stride,))


def r4_row_parts(key):
    """The R4 parts whose calls row ``key``'s numbers are means over: all
    of the row's, so a tensor-core row's are the calls a bf16 step
    launches on it and a SIMT twin's, which the step launches nowhere, all the step's calls of its
    kernel."""
    return [p for p in R4_PARTS if R4_PARTS[p][0] == key]


def r4_lead_in(dev):
    """Throwaway kernels at the start of an R4 session: a session's first
    kernel records go missing (on the H100: its first three, in every
    retry)."""
    lead = torch.zeros(R4_LEAD_IN, device=dev)
    for _ in range(R4_LEAD_IN):
        lead.add_(1)


def library_device(calls, symbol, dev, label):
    """The mean device time a call of the library calls ``calls``, from
    the records of its kernel ``symbol`` (one a call) in a profiled R4
    session that runs them; None, logged, where the last session kept
    another count of them (a library picks its kernels itself: it is a
    yardstick, not a gate)."""
    def run():
        r4_lead_in(dev)
        for fn in calls:
            fn()

    run()
    _, rows, _ = profiled(run, label, expect={symbol: len(calls)})
    got = [r for r in rows if symbol in r[0]]
    if sum(r[1] for r in got) != len(calls):
        log(f"[R4] {label}: {sum(r[1] for r in got)} records of {symbol} "
            f"for {len(calls)} calls, its kernels {rows[:4]}; no device "
            f"time kept")
        return None
    return sum(r[2] for r in got) / len(calls)


def r4_records(call, route, shape, batch, dev):
    """Kernel records a profile shows for one launch of ``call`` on
    ``route``: a weight gradient whose K is split adds its reduction; a dx
    by phases has one a phase with taps."""
    h, c, o, k, s = shape
    if route == "tc_phase":
        from paddle_tpu_torch.kernels import conv_fused as cf
        return sum(p.runs for p in cf.dx_phases(
            (batch, h, h, c), (o, c, k, k), (s, s), ((1, 1), (1, 1)),
            (1, 1)))
    if not call.endswith("_dw"):
        return 1
    oh = (h - 1) // s + 1
    m, kk = c * k * k, batch * oh * oh
    from paddle_tpu_torch.kernels import tiles
    if route == "simt":
        splits = tiles.split_k(m, o, kk, dev)[0]
    else:
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        splits = tiles.split_k_tc(m, o, kk, sms)[0]
    return 1 + (splits > 1)


def phase_resnet_numbers(step_rec, dev, seed, iters=3):
    """R4: per kernel row, its device time a launch beside the mean over
    the bf16 step's calls of its bound (the larger of bytes / HBM rate and
    flops / bf16 peak), of its plain version and of a library call (CUDA
    events, ``iters`` calls a distinct shape, weighted by how often the
    step runs it). Every conv kernel's rows are timed on the step's own
    calls at batch 256 in bf16, each route through its launch function
    (``R4_PARTS``, four profiled sessions, ``R4_SESSIONS``): the
    tensor-core rows, whose kernels the 1x1 and 3x3 convs and the 3x3 dx
    share, and the SIMT twins, which the bf16 step launches nowhere
    (``launches_per_step`` 0, ``timed_on``). A row's time is its parts',
    each part apart in ``parts_ms`` and ``parts`` (with each part's own
    bound, plain and library means and worst error); a row of
    ``R4_LIBRARY_SYMBOL`` also carries its library call's device time on
    its calls as ``library_device_ms`` (``library_device``; None where no
    record of its kernel came). Each tensor-core row
    also carries its twin's time on the same calls as ``simt_ms``. Each
    tensor-core call is held against its plain version on those inputs
    (``R_TOL``'s bf16 gates). A part fails unless its session keeps every
    record."""
    shapes = resnet50_conv_shapes()
    counts = {}
    for sh in shapes:
        counts[sh] = counts.get(sh, 0) + 1
    keys = ("bound_ms", "plain_ms", "library_ms")
    acc = {k: dict(dict.fromkeys(keys, 0.0), bytes_bound=0, n=0)
           for k in (*RESNET_KERNELS, *R4_PARTS)}
    parts = {p: [] for p in R4_PARTS}
    records = dict.fromkeys(R4_PARTS, 0)
    lib_calls = {row: [] for row in R4_LIBRARY_SYMBOL}
    by_shape, checked, part_err = {}, {}, {}
    for shape, mult in counts.items():
        x, w, g = r_inputs(shape, R3_BATCH, torch.bfloat16, dev, seed)
        nbytes, flops = conv_work(shape, R3_BATCH, 2)
        b_ms, by = bound_ms(nbytes, flops, torch.bfloat16)
        for name, (_, plain) in conv_calls(shape, x, w, g).items():
            # the parts that launch this call; it is in their means and in
            # their rows'
            takers = [p for p in R4_PARTS if part_takes(p, name, shape[4])]
            t_plain = time_ms(plain, [()], iters)
            lib = library_call(name, shape, x, w, g)
            t_lib = time_ms(lib, [()], iters)
            for row in {R4_PARTS[p][0] for p in takers}:
                if row in lib_calls:
                    lib_calls[row] += [lib] * mult
            for k in {R4_PARTS[p][0] for p in takers}.union(takers):
                a = acc[k]
                a["n"] += mult
                a["bound_ms"] += mult * b_ms
                a["bytes_bound"] += mult * (by == "bytes")
                a["plain_ms"] += mult * t_plain
                a["library_ms"] += mult * t_lib
        for part, (row, route, calls) in R4_PARTS.items():
            on = conv_calls(shape, x, w, g, route=dict.fromkeys(calls, route))
            for call in calls:
                if call not in on or not part_takes(part, call, shape[4]):
                    continue
                parts[part] += [on[call][0]] * mult
                records[part] += mult * r4_records(call, route, shape,
                                                   R3_BATCH, dev)
                if route == "simt":
                    continue
                # the tensor-core call against its plain version on the
                # step's own inputs (its split of K, its grid)
                got, ref = on[call][0](), on[call][1]()
                rel = (got.float() - ref.float()).abs().max().item() / max(
                    ref.float().abs().max().item(), 1e-30)
                tol = R_TOL[torch.bfloat16][call not in ("brgemm_fwd",
                                                         "convkxk")]
                if not (bool(torch.isfinite(got).all()) and rel <= tol):
                    fail("R4", f"{call} {shape} on {route} at batch "
                               f"{R3_BATCH}: |kernel-plain| / max|plain| "
                               f"{rel:.3e} against its {tol:g} gate")
                checked[row] = max(checked.get(row, 0.0), rel)
                part_err[part] = max(part_err.get(part, 0.0), rel)
                del got, ref
                if row.startswith("brgemm"):
                    # each 1x1 tensor-core call by shape, launch cost in
                    # (CUDA events): the C = 64 cases among them
                    by_shape.setdefault(row, []).append({
                        "call": call, "route": route,
                        "shape": list(shape), "per_step": mult,
                        "call_ms": time_ms(on[call][0], [()], iters),
                        "bound_ms": b_ms})
        del x, w, g

    totals = {}
    for session in R4_SESSIONS:
        def run(session=session):
            r4_lead_in(dev)
            for part in session:
                for fn in parts[part]:
                    fn()

        run()
        # the sessions are retried until every part's records are all
        # there: its time is their sum
        expect = {R_SYMBOLS[R4_PARTS[p][0]]: records[p] for p in session}
        _, rows, _ = profiled(run, f"R4's parts {session}", expect=expect)
        for p in session:
            sym = R_SYMBOLS[R4_PARTS[p][0]]
            got = [r for r in rows if sym in r[0]]
            seen = sum(r[1] for r in got)
            if seen != records[p]:
                fail("R4", f"{p}: the last of {PROFILE_SESSIONS} sessions "
                           f"kept {seen} of {records[p]} {sym} records")
            totals[p] = sum(r[2] for r in got)
            if not totals[p]:
                fail("R4", f"the session of {p} recorded no time for the "
                           f"{sym} kernel it launched")
    lib_device = {row: library_device(calls, R4_LIBRARY_SYMBOL[row], dev,
                                      f"R4's library calls of {row}")
                  for row, calls in lib_calls.items()}
    del parts, lib_calls
    torch.cuda.empty_cache()
    numbers = {}
    in_step = step_rec["kernels_in_step"]
    step = routes(torch.bfloat16)
    for key in RESNET_KERNELS:
        a = acc[key]
        # the bf16 step's own launches of this row, and the calls its
        # numbers are means over: those, or all the step's calls of a
        # SIMT twin the step launches nowhere
        launches = step[key] if key in TC_TWIN else step[f"{key}_simt"]
        calls = launches or R_PER_STEP[key]
        if a["n"] != calls:
            fail("R4", f"{key}: {a['n']} calls of its parts in the shape "
                       f"table, {calls} in a bf16 step")
        mine = r4_row_parts(key)
        ms = sum(totals[p] for p in mine) / calls
        rec = {"ms": ms, "launches_per_step": launches,
               "bound_ms": a["bound_ms"] / calls,
               "bound_by": "bytes" if a["bytes_bound"] * 2 > calls
               else "operations",
               "plain_ms": a["plain_ms"] / calls,
               "library_ms": a["library_ms"] / calls,
               # the step's total of the row's kernel symbol (shared by
               # the two rows of one tensor-core kernel)
               "device_ms_in_step": in_step[key]["device_ms"],
               "profiled_kernels_in_step": in_step[key]["count"],
               "parts_ms": {p: totals[p] / acc[p]["n"] for p in mine},
               # each part's own calls: their count, strides, means and
               # worst error at batch 256 (a tensor-core part's)
               "parts": {p: dict(
                   {k: acc[p][k] / acc[p]["n"] for k in keys},
                   calls=acc[p]["n"], route=R4_PARTS[p][1],
                   strides=list(R4_STRIDES.get(p, (1, 2))),
                   rel_err_at_batch=part_err.get(p)) for p in mine}}
        if not launches:
            rec["timed_on"] = "bf16, the step's calls, on the SIMT route"
        if key in lib_device:
            rec["library_device_ms"] = lib_device[key]
        if key in by_shape:
            rec["by_shape"] = by_shape[key]
            for r in by_shape[key]:
                if 64 in r["shape"][1:3]:
                    log(f"[R4] {key} {r['call']} {r['shape']} x"
                        f"{r['per_step']}: {r['call_ms']:.3f} ms a call "
                        f"(CUDA events) against a {r['bound_ms']:.4f} ms "
                        f"bound")
        if key in TC_TWIN:
            # the SIMT parts over the same calls as this row's kernel parts
            twin = [q for p in mine
                    for q, (row, _, cs) in R4_PARTS.items()
                    if row == TC_TWIN[key] and cs == R4_PARTS[p][2]
                    and R4_STRIDES.get(q) == R4_STRIDES.get(p)]
            rec["simt_ms"] = sum(totals[p] for p in twin) / calls
            rec["rel_err_at_batch"] = checked[key]
        numbers[key] = rec
        where = (f"the {calls} calls the step launches on it" if launches
                 else f"the step's {calls} calls, none launched on it")
        log(f"[R4] {key} (bf16, mean over {where}): "
            f"kernel {ms:.3f} ms (device), plain {rec['plain_ms']:.3f} ms, "
            f"library {rec['library_ms']:.3f} ms (CUDA events); bound "
            f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}) = "
            f"{rec['bound_ms'] / ms * 100:.2f}% of the kernel's time"
            + (f"; SIMT on the same calls {rec['simt_ms']:.3f} ms (device)"
               f"; worst |kernel-plain| / max|plain| on them "
               f"{rec['rel_err_at_batch']:.3e}" if key in TC_TWIN else "")
            + (f"; library by device time on them "
               f"{rec['library_device_ms']:.4f} ms, the kernel "
               f"{ms / rec['library_device_ms']:.2f}x it"
               if rec.get("library_device_ms") else ""))
        if len(mine) > 1:
            for p in mine:
                q = rec["parts"][p]
                log(f"[R4]   {key} part {p} ({q['route']}, strides "
                    f"{q['strides']}): {rec['parts_ms'][p]:.4f} ms a call "
                    f"over "
                    f"{q['calls']}; bound {q['bound_ms']:.4f} ms, plain "
                    f"{q['plain_ms']:.3f} ms, library {q['library_ms']:.3f}"
                    f" ms a call on them"
                    + ("" if q["rel_err_at_batch"] is None else
                       f"; worst |kernel-plain| / max|plain| "
                       f"{q['rel_err_at_batch']:.3e}"))

    def kernel_ms(row):
        # a tensor-core row's kernel time over the bf16 step's calls
        return sum(totals[p] for p in r4_row_parts(row))

    for sym in (FWD_TC_KERNEL, DW_TC_KERNEL):
        rows = [r for r in TC_KERNEL if TC_KERNEL[r] == sym]
        log(f"[R4] {sym}: {in_step[rows[0]]['device_ms']:.3f} ms over "
            f"{in_step[rows[0]]['count']} records in the profiled step; "
            f"timed apart: " + ", ".join(
                f"{r} {kernel_ms(r):.3f} ms" for r in rows))
    return numbers


# -- the fused max pool (P1) ----------------------------------------------------

POOL_CFG = (3, 2, 1)            # the stem's Pool2D(3, "max", 2, 1)
class PoolCase(NamedTuple):
    """A pool call of P1: its input ([batch, h, w, c] in ``dtype``, drawn
    as ``kind`` says), its (pool size, stride, padding) and the backward's
    route, as ``pool_fused.bwd_route`` must name it."""
    name: str
    batch: int
    h: int
    w: int
    c: int
    dtype: torch.dtype
    kind: str
    cfg: tuple
    route: str


# the stem's shape in bf16 at the bench's batch and in float32 at R1's,
# odd planes, windows of ties, NaN / -inf / finfo.min entries (which the
# kernel never picks), all on the backward's tile route; 2x2/s2/p0 on the
# tile route; C = 3, which the rule sends to the gather
P1_CASES = [
    PoolCase("stem", R3_BATCH, 112, 112, 64, torch.bfloat16, "randn",
             POOL_CFG, "tile"),
    PoolCase("stem", R1_BATCH, 112, 112, 64, torch.float32, "randn",
             POOL_CFG, "tile"),
    PoolCase("odd", 3, 37, 29, 24, torch.float32, "randn", POOL_CFG, "tile"),
    PoolCase("odd", 3, 37, 29, 24, torch.bfloat16, "randn", POOL_CFG,
             "tile"),
    PoolCase("ties", R1_BATCH, 112, 112, 64, torch.bfloat16, "ties",
             POOL_CFG, "tile"),
    PoolCase("specials", 2, 15, 17, 8, torch.float32, "specials", POOL_CFG,
             "tile"),
    PoolCase("k2s2p0", R1_BATCH, 112, 112, 64, torch.bfloat16, "randn",
             (2, 2, 0), "tile"),
    PoolCase("c3", R1_BATCH, 112, 112, 3, torch.bfloat16, "randn", POOL_CFG,
             "gather"),
]


def pool_input(case, dev, seed):
    """P1's input of ``case`` (a ``PoolCase``), from ``seed``."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(case.batch, case.h, case.w, case.c, device=dev,
                    generator=gen)
    kind = case.kind
    if kind == "ties":                  # post-relu values on a few levels
        x = torch.relu(torch.round(x * 2) / 2)
    elif kind == "specials":
        flat = x.view(-1)
        flat[::7] = float("nan")
        flat[3::11] = float("-inf")
        flat[5::13] = torch.finfo(torch.float32).min
        x[0, :2, :2, :] = float("-inf")   # windows with nothing to pick
    return x.to(case.dtype)


def bits(t):
    """The raw bits of a float32 or bf16 tensor, for bitwise equality."""
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def pool_work(geo, esize):
    """(bytes, operations) of one pool call, forward or backward alike: the
    forward reads x and writes out and the int32 idx, the backward reads g
    and idx and writes dx, each once; one float32 compare per window tap
    of each output."""
    n, h, w, c, oh, ow, kh, kw = geo[:8]
    x_el, o_el = n * h * w * c, n * oh * ow * c
    return esize * (x_el + o_el) + 4 * o_el, o_el * kh * kw


def pool_routes():
    """The pool backward's launches so far by route: (tile, gather)."""
    from paddle_tpu_torch.kernels import pool_fused as pf
    return pf.pool_bwd.tile_launches, pf.pool_bwd.gather_launches


def pool_entry_path(dev, seed):
    """P1's path through the entry point a model calls: ``nn_ops.pool2d``
    with the pool knob on, forward and backward through autograd, at the
    stem's shape in bf16 at batch 8 with C = 64 (the tile kernel) and with
    C = 3 (the gather); the counts set to 0 just before and read just
    after. Out and dx bit for bit against ``max_pool2d_fused_reference``
    on the same inputs. Returns the counts."""
    from paddle_tpu_torch.kernels import pool_fused as pf
    from paddle_tpu_torch.ops import nn_ops
    xs = [pool_input(PoolCase("entry", R1_BATCH, 112, 112, c, torch.bfloat16,
                              "randn", POOL_CFG, route), dev,
                     seed).requires_grad_()
          for c, route in ((64, "tile"), (3, "gather"))]
    gen = torch.Generator(device=dev).manual_seed(seed + 2)
    saved = pf.POOL_FUSED
    pf.set_pool_fused(True)
    try:
        zero_r_counts()
        outs = []
        for x in xs:
            out = nn_ops.pool2d(x, 3, "max", 2, 1, data_format="NHWC")
            cot = torch.randn(out.shape, device=dev, generator=gen).to(
                x.dtype)
            outs.append((out, cot, torch.autograd.grad(out, x, cot)[0]))
        torch.cuda.synchronize()
        counts = r_counts()
    finally:
        pf.set_pool_fused(saved)
    want = {k: 0 for k in counts}
    want.update(pool_fwd=2, pool_bwd=2, pool_bwd_tile=1, pool_bwd_gather=1)
    if counts != want:
        fail("P1", f"pool2d's forward and backward launched {counts}, "
                   f"expected {want}")
    for x, (out, cot, dx) in zip(xs, outs):
        leaf = x.detach().requires_grad_()
        ref = pf.max_pool2d_fused_reference(leaf, 3, 2, 1)
        (ref_dx,) = torch.autograd.grad(ref, leaf, cot)
        if not (torch.equal(bits(out.detach()), bits(ref.detach()))
                and torch.equal(bits(dx), bits(ref_dx))):
            fail("P1", f"pool2d at C = {x.shape[-1]}: out or dx differs "
                       f"from the plain version's")
    log(f"[P1] pool2d (knob on), forward and backward at C = 64 and C = 3: "
        f"launches {({k: v for k, v in counts.items() if v})}, out and dx "
        f"bit-identical to the plain route's")
    return {k: counts[k] for k in ("pool_fwd", "pool_bwd", "pool_bwd_tile",
                                   "pool_bwd_gather")}


def phase_pool(dev, seed):
    """P1: the pool kernels against their plain versions (out and idx
    equal, dx bit for bit) on every case of P1_CASES, one launch of each a
    call, the backward on the route ``bwd_route`` names (and, where that
    is the tile kernel, the gather on the same inputs, uncounted, bit for
    bit too); the entry point's path (``pool_entry_path``); then at the
    stem's shape in bf16 (batch 256), the bound, the plain versions' and
    the library's times (``F.max_pool2d(..., return_indices=True)`` on the
    channels_last view, and its backward), and each kernel's own time a
    call (CUDA events), the backward on both routes."""
    from paddle_tpu_torch.kernels import pool_fused as pf
    results = []
    for case in P1_CASES:
        route = case.route
        x = pool_input(case, dev, seed)
        geo = pf.geometry(x.shape, *case.cfg)
        if pf.bwd_route(x.dtype, geo, True) != route:
            fail("P1", f"{case}: bwd_route names "
                       f"{pf.bwd_route(x.dtype, geo, True)}, not {route}")
        before = (pf.pool_fwd.launches, pf.pool_bwd.launches)
        routes_before = pool_routes()
        out, idx = pf.pool_fwd_cuda(x, geo)
        gen = torch.Generator(device=dev).manual_seed(seed + 1)
        g = torch.randn(out.shape, device=dev, generator=gen).to(x.dtype)
        dx = pf.pool_bwd_cuda(g, idx, geo, x.dtype)
        torch.cuda.synchronize()
        launched = (pf.pool_fwd.launches - before[0],
                    pf.pool_bwd.launches - before[1])
        by_route = tuple(a - b for a, b in zip(pool_routes(), routes_before))
        ref_out, ref_idx = pf.pool_fwd_reference(x, geo)
        ref_dx = pf.pool_bwd_reference(g, ref_idx, geo, x.dtype)
        rec = {"case": case.name, "dtype": str(x.dtype).split(".")[-1],
               "shape": list(x.shape), "pool": list(case.cfg),
               "route": route, "launches_by_route": by_route,
               "out_equal": torch.equal(out, ref_out),
               "idx_equal": torch.equal(idx, ref_idx),
               "dx_bitwise": torch.equal(bits(dx), bits(ref_dx)),
               "out_max_abs_err": (out.float() - ref_out.float()).abs()
               .max().item(),
               "max_abs_err": (dx.float() - ref_dx.float()).abs().max()
               .item(), "unpicked_windows": int((idx == -1).sum()),
               "launches": launched}
        if route == "tile":
            other = pf.pool_bwd_launch("gather", g, idx, geo, x.dtype)
            torch.cuda.synchronize()
            rec["gather_bitwise"] = torch.equal(bits(other), bits(ref_dx))
            rec["gather_max_abs_err"] = (other.float() - ref_dx.float()) \
                .abs().max().item()
            del other
        rec["ok"] = rec["out_equal"] and rec["idx_equal"] and \
            rec["dx_bitwise"] and rec.get("gather_bitwise", True) and \
            launched == (1, 1) and \
            by_route == ((1, 0) if route == "tile" else (0, 1))
        results.append(rec)
        log(f"[P1] {rec['case']:<8} {rec['dtype']:>8} {rec['shape']} "
            f"{'x'.join(map(str, case.cfg))}: out "
            f"{'equal' if rec['out_equal'] else 'DIFFERS'}, idx "
            f"{'equal' if rec['idx_equal'] else 'DIFFERS'}, dx on {route} "
            f"{'bit-identical' if rec['dx_bitwise'] else 'DIFFERS'} (max "
            f"|kernel - plain| {rec['max_abs_err']:.3e})"
            + (f", on the gather "
               f"{'bit-identical' if rec['gather_bitwise'] else 'DIFFERS'}"
               if route == "tile" else "")
            + f"; windows with nothing to pick {rec['unpicked_windows']}; "
            f"launches {launched}, backward (tile, gather) {by_route}")
        if not rec["ok"]:
            fail("P1", f"{rec}")
        del x, out, idx, g, dx, ref_out, ref_idx, ref_dx
    torch.cuda.empty_cache()
    path = pool_entry_path(dev, seed)

    x = pool_input(P1_CASES[0], dev, seed)
    geo = pf.geometry(x.shape, *POOL_CFG)
    out, idx = pf.pool_fwd_cuda(x, geo)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    g = torch.randn(out.shape, device=dev, generator=gen).to(x.dtype)
    xn, gn = x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)
    _, lib_idx = torch.nn.functional.max_pool2d(xn, 3, 2, 1,
                                                return_indices=True)
    bnd = bound_ms(*pool_work(geo, x.element_size()), torch.float32)

    def bwd_lib():
        return torch.ops.aten.max_pool2d_with_indices_backward(
            gn, xn, [3, 3], [2, 2], [1, 1], [1, 1], False, lib_idx)

    def bwd_plain():
        return pf.pool_bwd_reference(g, idx, geo, x.dtype)

    numbers = {}
    for key, kern, plain, lib in (
            ("pool_fwd", lambda: pf.pool_fwd_cuda(x, geo),
             lambda: pf.pool_fwd_reference(x, geo),
             lambda: torch.nn.functional.max_pool2d(
                 xn, 3, 2, 1, return_indices=True)),
            ("pool_bwd_gather", lambda: pf.pool_bwd_launch(
                "gather", g, idx, geo, x.dtype), bwd_plain, bwd_lib),
            ("pool_bwd_tile", lambda: pf.pool_bwd_launch("tile", g, idx, geo,
                                                         x.dtype),
             bwd_plain, bwd_lib)):
        numbers[key] = {"call_ms": time_ms(kern, [()], 20),
                        "plain_ms": time_ms(plain, [()], 3),
                        "library_ms": time_ms(lib, [()], 20),
                        "bound_ms": bnd[0], "bound_by": bnd[1],
                        "bytes": pool_work(geo, x.element_size())[0]}
        r = numbers[key]
        log(f"[P1] {key} bf16 {list(x.shape)} 3x3/s2/p1: kernel "
            f"{r['call_ms']:.4f} ms, plain {r['plain_ms']:.3f} ms, library "
            f"{r['library_ms']:.4f} ms (CUDA events); bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}, {r['bytes']} bytes)")
    # the gather has no launch in a step: its time a launch is P1's
    numbers["pool_bwd_gather"]["ms"] = numbers["pool_bwd_gather"]["call_ms"]
    tile_ms, gather_ms = (numbers[k]["call_ms"]
                          for k in ("pool_bwd_tile", "pool_bwd_gather"))
    log(f"[P1] pool_bwd on the tile kernel {tile_ms:.4f} ms against the "
        f"gather's {gather_ms:.4f} ms a call on the same inputs "
        f"({gather_ms / tile_ms:.2f}x)")
    del x, out, idx, g, xn, gn, lib_idx
    torch.cuda.empty_cache()
    return results, numbers, path


# -- the IMDB sentiment classifier (E1, E2) -------------------------------------

# (case, batch, seq, vocab, dim): the classifier's lookups (imdb_real at
# full size) and kernel_bench.py:98's, a 256 MB table larger than the L2
E_SHAPES = [("imdb", 256, 256, 5149, 128),
            ("kernel_bench", 1024, 16, 500000, 128)]
# max |kernel - plain| / max |plain|: float32 sums in another order
# (tests/test_kernels_interpret.py:55-67 holds 1e-5); bf16 outputs round
# once more
E_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
E_STEPS, E_TIMED = 3, 20
E_FLOOR_FACTOR = 2.0


def seqpool_work(ids, d, esize):
    """(bytes, operations) of one seqpool call on these (clamped) ids: the
    distinct table rows they name, the int32 ids and the output, each
    moved once; one float32 add per id and column."""
    b, s = ids.shape
    rows = torch.unique(ids).numel()
    return esize * d * (rows + b) + 4 * b * s, b * s * d


def e_counts():
    from paddle_tpu_torch.kernels import embedding_pool as ep
    from paddle_tpu_torch.kernels import fused_update as fu
    return {"seqpool": ep.seqpool.launches,
            "fused_update": fu.fused_update_step.launches}


def zero_e_counts():
    from paddle_tpu_torch.kernels import embedding_pool as ep
    from paddle_tpu_torch.kernels import fused_update as fu
    ep.seqpool.launches = 0
    fu.fused_update_step.launches = 0


@contextlib.contextmanager
def plain_seqpool():
    """Route the seqpool wrapper to its plain version."""
    from paddle_tpu_torch.kernels import embedding_pool as ep
    saved = ep.seqpool_cuda
    ep.seqpool_cuda = ep.seqpool_reference
    try:
        yield
    finally:
        ep.seqpool_cuda = saved


def seqpool_yardsticks(ids, table, mean=True):
    """The kernel's, its plain version's and ``F.embedding_bag``'s time a
    call (CUDA events) on these clamped ids."""
    from paddle_tpu_torch.kernels import embedding_pool as ep
    ids32, ids64 = ids.to(torch.int32).contiguous(), ids.long()
    mode = "mean" if mean else "sum"
    return {"call_ms": time_ms(lambda: ep.seqpool_cuda(ids32, table, mean),
                               [()], 50),
            "plain_ms": time_ms(lambda: ep.seqpool_reference(ids32, table,
                                                             mean), [()], 20),
            "library_ms": time_ms(lambda: torch.nn.functional.embedding_bag(
                ids64, table, mode=mode), [()], 50)}


def phase_seqpool_kernels(dev, seed):
    """E1: the seqpool kernel through ``embedding_seqpool`` against its
    plain version, sum and mean, float32 and bf16, at E_SHAPES with ids
    out of range on both sides; one launch a call. Then, in float32 with
    the mean, the kernel, plain and ``F.embedding_bag`` times and the
    bound at each shape, so that a routing rule for this card can be
    chosen from its own numbers."""
    from paddle_tpu_torch.kernels import embedding_pool as ep
    results, worst, shapes = [], 0.0, []
    for name, b, s, v, d in E_SHAPES:
        gen = torch.Generator(device=dev).manual_seed(seed)
        table32 = torch.randn(v, d, device=dev, generator=gen)
        ids = torch.randint(-3, v + 3, (b, s), device=dev, generator=gen,
                            dtype=torch.int32)
        for dtype in (torch.float32, torch.bfloat16):
            table = table32.to(dtype)
            for mean in (False, True):
                before = ep.seqpool.launches
                got = ep.embedding_seqpool(ids, table, mean)
                torch.cuda.synchronize()
                launched = ep.seqpool.launches - before
                ref = ep.seqpool_reference(ids, table, mean)
                diff = (got.float() - ref.float()).abs().max().item()
                rel = diff / max(ref.float().abs().max().item(), 1e-30)
                ok = rel <= E_TOL[dtype] and launched == 1 and \
                    got.dtype == ref.dtype and got.shape == ref.shape
                rec = {"case": name, "dtype": str(dtype).split(".")[-1],
                       "mean": mean, "shape": [b, s, v, d],
                       "max_abs_err": diff, "rel_err": rel, "ok": ok}
                results.append(rec)
                log(f"[E1] seqpool {name:<12} {rec['dtype']:>8} "
                    f"{'mean' if mean else 'sum '} [{b},{s}] into [{v},{d}]"
                    f": max |kernel - plain| {diff:.3e}, relative {rel:.3e} "
                    f"(gate {E_TOL[dtype]:g}); launches {launched}")
                if not ok:
                    fail("E1", f"{rec}")
                if name == "imdb" and dtype == torch.float32:
                    worst = max(worst, diff)
        clamped = ids.clamp(0, v - 1)
        times = seqpool_yardsticks(clamped, table32)
        nbytes, ops = seqpool_work(clamped, d, 4)
        bnd = bound_ms(nbytes, ops, torch.float32)
        shapes.append(dict(times, case=name, shape=[b, s, v, d],
                           dtype="float32", bound_ms=bnd[0],
                           bound_by=bnd[1], bytes=nbytes))
        log(f"[E1] seqpool {name} float32 mean: kernel "
            f"{times['call_ms'] * 1e3:.2f} us, plain "
            f"{times['plain_ms'] * 1e3:.2f} us, F.embedding_bag "
            f"{times['library_ms'] * 1e3:.2f} us (CUDA events); bound "
            f"{bnd[0] * 1e3:.2f} us ({bnd[1]}, {nbytes} bytes)")
        del table32, table, ids, clamped
        torch.cuda.empty_cache()
    return results, worst, shapes


def e_run(init, ids, labels, fused, plain, perm):
    """E_STEPS Adam steps of the classifier from ``init`` through the
    seqpool kernel or (``plain``) its plain version, the update fused or
    not, the batch in its order or permuted (``perm``: the same loss, its
    sums in another order). Returns the losses, the launches a step and
    the parameters after the last step."""
    from paddle_tpu_torch import imdb_bench
    from paddle_tpu_torch import optimizer as popt
    params = {k: v.detach().clone().requires_grad_() for k, v in init.items()}
    opt = popt.Adam(learning_rate=imdb_bench.LR)
    state = opt.init(params)
    if perm is not None:
        ids, labels = ids[perm], labels[perm]
    losses, counts = [], []
    with plain_seqpool() if plain else contextlib.nullcontext():
        for _ in range(E_STEPS):
            zero_e_counts()
            loss = imdb_bench.train_step(params, opt, state, ids, labels,
                                         fused)
            torch.cuda.synchronize()
            counts.append(e_counts())
            losses.append(loss.item())
    return {"losses": losses, "counts": counts,
            "params": {k: p.detach().clone() for k, p in params.items()}}


def tree_norm(tree):
    return math.sqrt(sum(t.double().square().sum().item()
                         for t in tree.values()))


def phase_imdb_train(dev, seed):
    """E2: the ``imdb_real`` classifier step (``paddle_tpu_torch/
    imdb_bench.py``) at full size, float32. Three Adam steps through the
    kernels (fused and unfused update) and through the plain versions, and
    the kernel (fused) and plain runs again with the batch permuted. Gates:
    every loss within 1e-5 relative of the plain route's; the parameters
    after step 3 (whole tree) within E_FLOOR_FACTOR times the rounding
    floor, the distance the permutation moves the kernel and the plain
    runs; table rows that no id names unmoved in every run; launches a
    step ``seqpool: 1``, ``fused_update: 1`` when fused. Then the main
    path: E_TIMED timed steps unfused (the bench's default) and E_TIMED
    fused, counted (samples/s = their samples over their summed wall
    time), and one profiled unfused step (device busy time, idle share
    over its own wall time, the seqpool kernel's device time). Beside it
    the kernel's bound on this batch, its plain version's and
    ``F.embedding_bag``'s time."""
    from paddle_tpu_torch import imdb_bench
    params, _, _, ids, labels = imdb_bench.build(
        *imdb_bench.SIZES["cuda"], dev, seed)
    init = {k: p.detach().clone() for k, p in params.items()}
    b = ids.shape[0]
    perm = torch.randperm(b, device=dev,
                          generator=torch.Generator(device=dev)
                          .manual_seed(seed))
    routes = {"kernel_fused": (True, False, None),
              "kernel": (False, False, None),
              "plain": (False, True, None),
              "kernel_fused_perm": (True, False, perm),
              "plain_perm": (False, True, perm)}
    runs = {}
    for name, (fused, plain, p) in routes.items():
        runs[name] = e_run(init, ids, labels, fused, plain, p)
        log(f"[E2] {name:<17} losses "
            f"{', '.join(f'{v:.7f}' for v in runs[name]['losses'])}; "
            f"launches a step {runs[name]['counts'][0]}")
        want = {"seqpool": 0 if plain else 1, "fused_update": int(fused)}
        if any(c != want for c in runs[name]["counts"]):
            fail("E2", f"{name}: launches {runs[name]['counts']}, expected "
                       f"{want} a step")
        if not all(math.isfinite(v) for v in runs[name]["losses"]):
            fail("E2", f"{name}: non-finite loss {runs[name]['losses']}")
    ref = runs["plain"]
    keys = list(init)

    def dist(a, c):
        return tree_norm({k: a["params"][k] - c["params"][k] for k in keys})

    floor = math.hypot(dist(runs["kernel_fused"], runs["kernel_fused_perm"]),
                       dist(ref, runs["plain_perm"]))
    untouched = torch.ones(init["table"].shape[0], dtype=torch.bool,
                           device=dev)
    untouched[ids.clamp(0, init["table"].shape[0] - 1).long().view(-1)] = \
        False
    rec = {"losses": {n: r["losses"] for n, r in runs.items()},
           "launches_per_step": {n: r["counts"][0] for n, r in runs.items()},
           "floor": floor, "untouched_rows": int(untouched.sum())}
    moved = {n: int((r["params"]["table"][untouched]
                     != init["table"][untouched]).any(1).sum())
             for n, r in runs.items()}
    rec["untouched_rows_moved"] = moved
    for name in ("kernel_fused", "kernel"):
        loss_rel = max(abs(a - c) / abs(c) for a, c in
                       zip(runs[name]["losses"], ref["losses"]))
        d = dist(runs[name], ref)
        rec[name] = {"loss_rel": loss_rel, "params_dist": d,
                     "floor_ratio": d / floor if floor else None}
        log(f"[E2] {name} vs plain: losses within {loss_rel:.3e} relative "
            f"(gate 1e-5); parameters after step {E_STEPS} "
            f"|kernel - plain| {d:.3e} (|plain| {tree_norm(ref['params']):.3e}"
            f"), the permutation's floor {floor:.3e}, ratio "
            f"{d / floor if floor else float('inf'):.3f} (gate "
            f"{E_FLOOR_FACTOR:g})")
        if loss_rel > 1e-5:
            fail("E2", f"{name}: losses part by {loss_rel:.3e} relative")
        if d > E_FLOOR_FACTOR * floor:
            fail("E2", f"{name}: parameters {d:.3e} apart, floor {floor:.3e}")
    log(f"[E2] table rows no id names: {rec['untouched_rows']}; moved in "
        f"any run: {sum(moved.values())} (must be 0)")
    if rec["untouched_rows"] == 0 or any(moved.values()):
        fail("E2", f"untouched table rows {rec['untouched_rows']}, moved "
                   f"{moved}")
    del runs

    # the main path: the bench's step at full size, counted and timed
    for fused in (False, True):
        params, opt, state, ids, labels = imdb_bench.build(
            *imdb_bench.SIZES["cuda"], dev, seed)

        def step():
            return imdb_bench.train_step(params, opt, state, ids, labels,
                                         fused)

        step()
        torch.cuda.synchronize()
        zero_e_counts()
        wall, losses = [], []
        for _ in range(E_TIMED):
            t0 = time.perf_counter()
            loss = step()
            torch.cuda.synchronize()
            wall.append((time.perf_counter() - t0) * 1e3)
            losses.append(loss.item())
        counts = e_counts()
        want = {"seqpool": E_TIMED, "fused_update": E_TIMED * fused}
        if counts != want or not all(math.isfinite(v) for v in losses):
            fail("E2", f"main path (fused={fused}): launches {counts}, "
                       f"expected {want}; losses {losses}")
        label = "fused" if fused else "unfused"
        rec[label] = {"launches": counts, "wall_ms": wall,
                      "samples_per_s": b * E_TIMED / sum(wall) * 1e3,
                      "losses": losses}
        log(f"[E2] main path, {label} update: {E_TIMED} steps, launches "
            f"{counts}, {sum(wall) / E_TIMED:.3f} ms a step, "
            f"{rec[label]['samples_per_s']:.0f} samples/s over them; loss "
            f"{losses[0]:.5f} -> {losses[-1]:.5f}")
        if not fused:
            busy, kernels, prof_ms = profiled(step, "the IMDB step")
            sp = [r for r in kernels if "seqpool_kernel" in r[0]]
            if not sp:
                fail("E2", "the profile of the step shows no seqpool_kernel")
            rec["profile"] = {
                "device_busy_ms": busy, "profiled_wall_ms": prof_ms,
                "idle_share": 1.0 - busy / prof_ms,
                "seqpool_device_ms": sum(r[2] for r in sp),
                "seqpool_count": sum(r[1] for r in sp),
                "top_kernels": [{"name": n[:120], "count": c, "device_ms": t}
                                for n, c, t in kernels[:10]]}
            log(f"[E2] profiled unfused step: device busy {busy:.3f} of "
                f"{prof_ms:.3f} ms (idle share "
                f"{rec['profile']['idle_share']:.3f}); seqpool "
                f"{rec['profile']['seqpool_device_ms'] * 1e3:.2f} us")
            for n, c, t in kernels[:10]:
                log(f"[E2]   {t * 1e3:9.2f} us {c:4d}x  {n[:100]}")
            table = params["table"].detach()
            clamped = ids.clamp(0, table.shape[0] - 1)
            nbytes, ops = seqpool_work(clamped, table.shape[1], 4)
            bnd = bound_ms(nbytes, ops, torch.float32)
            numbers = dict(seqpool_yardsticks(clamped, table),
                           ms=rec["profile"]["seqpool_device_ms"]
                           / rec["profile"]["seqpool_count"],
                           bound_ms=bnd[0], bound_by=bnd[1], bytes=nbytes,
                           launches_per_step=1)
            rec["seqpool_numbers"] = numbers
            log(f"[E2] seqpool on the batch: kernel {numbers['ms'] * 1e3:.2f}"
                f" us (device), {numbers['call_ms'] * 1e3:.2f} us a call; "
                f"plain {numbers['plain_ms'] * 1e3:.2f} us, F.embedding_bag "
                f"{numbers['library_ms'] * 1e3:.2f} us (CUDA events); bound "
                f"{bnd[0] * 1e3:.3f} us ({bnd[1]}, {nbytes} bytes)")
        del params, opt, state
    torch.cuda.empty_cache()
    return rec


# -- the row LayerNorm (L1, L2) and BERT-base (B1, B2) -------------------------

# (case, n, d, dtype, eps, affine): kernel_bench.py:43-60's shape (bf16,
# scale ones, bias zeros) and its float32 twin, BERT-base's width over
# batch x length rows (eps 1e-12, random affine, and scale and shift off),
# and odd shapes in every type: a row narrower than a warp's loads, one
# row, rows too wide for the registers (the streaming kernel), D not a
# multiple of the 16-byte loads
L_SHAPES = [("kernel_bench", 32768, 1024, torch.bfloat16, 1e-5, "ones"),
            ("kernel_bench", 32768, 1024, torch.float32, 1e-5, "ones"),
            ("bert_rows", 4096, 768, torch.bfloat16, 1e-12, "random"),
            ("bert_rows_bare", 4096, 768, torch.bfloat16, 1e-12, None)] + [
    (f"odd_{n}x{d}", n, d, dt, 1e-5, "random")
    for n, d in ((100, 96), (7, 10), (1, 1000), (64, 4096), (33, 301))
    for dt in (torch.float32, torch.bfloat16, torch.float16)]
# float32: max |kernel - plain| / max |plain| (sums in another order,
# tests/test_kernels_interpret.py:22). bf16 / f16: each element within one
# ulp of the plain value (one rounding of float32 results that agree to
# ~1e-7), plus the float32 gate for the values near 0, whose ulp is finer
# than the float32 results' own difference
L_TOL = 1e-5
L_MANTISSA = {torch.bfloat16: 7, torch.float16: 10}
L_ITERS = 50                      # kernel_bench.py:46's iterations
# the timed shapes: (case, n, d, dtype, eps); the first is the main path's
L_TIMED = [("kernel_bench", 32768, 1024, torch.bfloat16, 1e-5),
           ("kernel_bench", 32768, 1024, torch.float32, 1e-5),
           ("bert_rows", 4096, 768, torch.bfloat16, 1e-12)]
LN_FLOPS_PER_ELEMENT = 8          # the kernel's float32 operations

B1_BATCH, B_LEN, B_STEPS, B_TIMED = 8, 128, 3, 10
B_KEYS = ("flash_fwd", "flash_fwd_tc", "flash_fwd_simt", "flash_bwd_dq",
          "flash_bwd_dq_tc", "flash_bwd_dq_simt", "flash_bwd_dkv",
          "flash_bwd_dkv_tc", "flash_bwd_dkv_simt", "layer_norm",
          "fused_update")
B_SYMBOLS = dict(KERNEL_SYMBOLS, layer_norm="layer_norm_kernel")
# the flash kernels of B2's bf16 use_pallas step: 12 launches each, the
# forward, dQ and dK/dV on the tensor cores (their SIMT twins none)
B2_KERNELS = ("flash_fwd_tc", "flash_bwd_dq_tc", "flash_bwd_dkv_tc")


def ln_inputs(n, d, dtype, affine, dev, seed, sets=1):
    """``sets`` x [n, d] inputs (a normal * 3 + 1) in ``dtype``, and the
    float32 scale and bias: ones and zeros, random, or None."""
    g = torch.Generator(device=dev).manual_seed(seed)
    xs = [(torch.randn(n, d, device=dev, generator=g) * 3 + 1).to(dtype)
          for _ in range(sets)]
    if affine == "ones":
        s, b = (torch.ones(d, device=dev), torch.zeros(d, device=dev))
    elif affine == "random":
        s = torch.rand(d, device=dev, generator=g) + 0.5
        b = torch.randn(d, device=dev, generator=g)
    else:
        s = b = None
    return xs, s, b


def ln_error(got, ref):
    """(max |got - ref|, the gate's measure, passed): float32 relative to
    max |ref|; bf16 / f16 the worst element's distance in ulps of ref
    after the float32 allowance."""
    diff = (got.float() - ref.float()).abs()
    amax = ref.float().abs().max().item()
    if got.dtype == torch.float32:
        rel = diff.max().item() / max(amax, 1e-30)
        return diff.max().item(), rel, rel <= L_TOL
    mag = ref.float().abs().clamp(min=torch.finfo(torch.float32).tiny)
    exp = torch.floor(torch.log2(mag))
    if got.dtype == torch.float16:
        exp = exp.clamp(min=-14)              # subnormal spacing
    ulp = torch.pow(2.0, exp - L_MANTISSA[got.dtype])
    ulps = ((diff - L_TOL * amax).clamp(min=0) / ulp).max().item()
    return diff.max().item(), ulps, ulps <= 1.0


def ln_work(n, d, esize, affine):
    """(bytes, operations) of one call: x read and y written once, the
    float32 scale and bias read once; LN_FLOPS_PER_ELEMENT a value."""
    return (2 * n * d * esize + (8 * d if affine else 0),
            LN_FLOPS_PER_ELEMENT * n * d)


def phase_layer_norm_kernels(dev, seed):
    """L1: the row LayerNorm kernel through ``nn_ops.layer_norm(use_pallas=
    True)`` against its plain version at every L_SHAPES case (one launch a
    call); the layer ``LayerNorm(use_pallas=True)`` launches it once on a
    2-D input and not at all on a 3-D one; its backward raises."""
    from paddle_tpu_torch.kernels import layer_norm as LN
    from paddle_tpu_torch.nn.layers import LayerNorm
    from paddle_tpu_torch.ops import nn_ops
    results, worst = [], 0.0
    for case, n, d, dtype, eps, affine in L_SHAPES:
        (x,), s, b = ln_inputs(n, d, dtype, affine, dev, seed)
        before = LN.fused_layer_norm.launches
        got = nn_ops.layer_norm(x, s, b, 1, eps, use_pallas=True)
        torch.cuda.synchronize()
        launched = LN.fused_layer_norm.launches - before
        ref = LN.fused_layer_norm_reference(x, s, b, eps)
        err, measure, ok = ln_error(got, ref)
        ok = ok and launched == 1 and got.dtype == dtype and \
            bool(torch.isfinite(got).all())
        rec = {"case": case, "shape": [n, d], "dtype": str(dtype)[6:],
               "eps": eps, "affine": affine, "max_abs_err": err,
               "gate_measure": measure, "launches": launched, "ok": ok}
        results.append(rec)
        log(f"[L1] layer_norm {case:<14} [{n},{d}] {rec['dtype']:>8} eps "
            f"{eps:g} affine {affine}: max |kernel - plain| {err:.3e}, "
            + (f"relative {measure:.3e} (gate {L_TOL:g})"
               if dtype == torch.float32 else
               f"{measure:.3f} ulp beyond the float32 gate (gate 1)")
            + f"; launches {launched}")
        if not ok:
            fail("L1", f"layer_norm {rec}")
        if case == "kernel_bench" and dtype == torch.bfloat16:
            worst = err
        del x, got, ref
    layer = LayerNorm(768, epsilon=1e-12, use_pallas=True).to(dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    x3 = torch.randn(4, 32, 768, device=dev, generator=g).bfloat16()
    counts = []
    for x in (x3.reshape(-1, 768), x3):
        before = LN.fused_layer_norm.launches
        with torch.no_grad():
            y = layer(x)
        torch.cuda.synchronize()
        counts.append(LN.fused_layer_norm.launches - before)
        if not torch.isfinite(y).all():
            fail("L1", "the layer gave non-finite values")
    x2 = x3.reshape(-1, 768).float().requires_grad_()
    try:
        torch.autograd.grad(layer(x2).square().sum(), x2)
        raised = False
    except RuntimeError:
        raised = True
    log(f"[L1] LayerNorm(768, use_pallas=True): launches on a 2-D input "
        f"{counts[0]} (must be 1), on a 3-D input {counts[1]} (must be 0); "
        f"its backward raises: {raised}")
    if counts != [1, 0] or not raised:
        fail("L1", f"layer launches {counts}, backward raised {raised}")
    torch.cuda.empty_cache()
    return {"cases": results, "layer_launches": counts,
            "backward_raises": raised}, worst


def phase_layer_norm_numbers(dev, seed):
    """L2: the main path, then the numbers. The main path is the twin of
    ``benchmark/kernel_bench.py:43-60``: ``LayerNorm(1024,
    use_pallas=True)`` (scale ones, bias zeros) applied L_ITERS times to
    bf16 [32768, 1024] at inference, counted (counts set to 0 just before,
    read just after) and timed with CUDA events. Then at each L_TIMED
    shape: the kernel's device time (torch.profiler, L_ITERS launches
    cycling through inputs of at least 64 MB, so x comes from HBM), its
    bound, and the plain version's and ``F.layer_norm``'s time a call
    (CUDA events on the same inputs), the latter a yardstick the port
    never calls."""
    import torch.nn.functional as F
    from paddle_tpu_torch.kernels import layer_norm as LN
    from paddle_tpu_torch.nn.layers import LayerNorm
    _, n, d, dtype, eps = L_TIMED[0]
    layer = LayerNorm(d, epsilon=eps, use_pallas=True).to(dev)
    xs, _, _ = ln_inputs(n, d, dtype, None, dev, seed, sets=2)
    with torch.no_grad():
        LN.fused_layer_norm.launches = 0
        path_ms = time_ms(layer, [(x,) for x in xs], L_ITERS)
        launches = LN.fused_layer_norm.launches
    log(f"[L2] main path: LayerNorm({d}, use_pallas=True) on bf16 [{n},{d}] "
        f"x {L_ITERS} (+2 warm-up): {launches} launches, {path_ms * 1e3:.2f} "
        f"us a call (CUDA events)")
    if launches != L_ITERS + len(xs):
        fail("L2", f"the main path launched {launches}, expected "
                   f"{L_ITERS + len(xs)}")
    del xs
    shapes = []
    for case, n, d, dtype, eps in L_TIMED:
        esize = torch.tensor([], dtype=dtype).element_size()
        sets = max(2, -(-64 * 2 ** 20 // (n * d * esize)))
        xs, s, b = ln_inputs(n, d, dtype, "random", dev, seed, sets)
        args = [(x, s, b, eps) for x in xs]
        busy, kernels, _ = profiled(
            lambda: [LN.layer_norm_cuda(*args[i % sets])
                     for i in range(L_ITERS)], f"layer_norm {case}",
            expect={"layer_norm_kernel": L_ITERS})
        rows = [r for r in kernels if "layer_norm_kernel" in r[0]]
        if not rows or sum(r[1] for r in rows) != L_ITERS:
            fail("L2", f"the profile of {case} shows {rows}")
        nbytes, ops = ln_work(n, d, esize, True)
        bnd = bound_ms(nbytes, ops, torch.float32)
        rec = {"case": case, "shape": [n, d], "dtype": str(dtype)[6:],
               "ms": sum(r[2] for r in rows) / L_ITERS,
               "call_ms": time_ms(LN.layer_norm_cuda, args, L_ITERS),
               "plain_ms": time_ms(LN.fused_layer_norm_reference, args, 10),
               "library_ms": time_ms(
                   lambda x, s, b: F.layer_norm(x, (d,), s, b, eps),
                   [(x, s.to(dtype), b.to(dtype)) for x in xs], L_ITERS),
               "bound_ms": bnd[0], "bound_by": bnd[1], "bytes": nbytes}
        shapes.append(rec)
        log(f"[L2] layer_norm {case} [{n},{d}] {rec['dtype']}: kernel "
            f"{rec['ms'] * 1e3:.2f} us (device), {rec['call_ms'] * 1e3:.2f} "
            f"us a call; plain {rec['plain_ms'] * 1e3:.2f} us, F.layer_norm "
            f"{rec['library_ms'] * 1e3:.2f} us (CUDA events); bound "
            f"{bnd[0] * 1e3:.2f} us ({bnd[1]}, {nbytes} bytes) = "
            f"{bnd[0] / rec['ms'] * 100:.1f}% of the kernel's time")
        del xs, args
    torch.cuda.empty_cache()
    return {"launches": launches, "path_call_ms": path_ms, "shapes": shapes}


def b_counts():
    from paddle_tpu_torch.kernels import layer_norm as LN
    return dict(train_counts(), layer_norm=LN.fused_layer_norm.launches)


def zero_b_counts():
    from paddle_tpu_torch.kernels import layer_norm as LN
    zero_counts()
    LN.fused_layer_norm.launches = 0


def b_expect(use_pallas, dtype):
    """Launches of one BERT step: 12 flash forward, 12 dQ and 12 dK/dV
    (each on the tensor cores in bf16, on its SIMT kernel in float32) with
    ``use_pallas``; no row-norm launch (the LayerNorms see [B, T, H]) and
    no fused update (the step is unfused); none without."""
    per = 12 if use_pallas else 0
    return {**flash_counts(per, dtype), "layer_norm": 0, "fused_update": 0}


def bert_batch(batch, vocab, dev, seed):
    """(ids, mlm_labels, mlm_weights, nsp_labels): ids in 1..vocab-1 with
    rows padded by 0 after a random length (row 0 full, no all-pad row),
    random MLM labels, MLM weights 1 on ~15% of the real tokens, random
    NSP labels."""
    rs = np.random.RandomState(seed)
    ids = rs.randint(1, vocab, (batch, B_LEN))
    lens = rs.randint(B_LEN // 4, B_LEN + 1, batch)
    lens[0] = B_LEN
    for i, n in enumerate(lens):
        ids[i, n:] = 0
    weights = (rs.rand(batch, B_LEN) < 0.15) & (ids != 0)
    out = (ids, rs.randint(0, vocab, (batch, B_LEN)), weights,
           rs.randint(0, 2, batch))
    dts = (torch.int32, torch.int32, torch.float32, torch.int32)
    return tuple(torch.from_numpy(np.asarray(a)).to(dev, dt)
                 for a, dt in zip(out, dts))


def b1_run(model, init, data, plain, reorder, seed):
    """B_STEPS unfused AdamW steps of the bench's loss from ``init``,
    through the flash kernels or (``plain``) their plain versions, the
    keys in their order or (``reorder``) reordered. Returns the losses,
    the launches a step, the first step's gradients and the parameters
    after the last step."""
    from paddle_tpu_torch import bert_bench
    from paddle_tpu_torch import optimizer as popt
    from paddle_tpu_torch.convert import param_tree
    model.load_state_dict(init)
    params = param_tree(model)
    opt = popt.AdamW(bert_bench.LR, weight_decay=bert_bench.WEIGHT_DECAY)
    state = opt.init(params)
    loss_fn = bert_bench.loss_fn(model)
    losses, counts, first = [], [], None
    stack = contextlib.ExitStack()
    if plain:
        stack.enter_context(plain_kernels())
    if reorder:
        stack.enter_context(permuted_keys(seed))
    with stack:
        for _ in range(B_STEPS):
            zero_b_counts()
            loss = loss_fn(params, *data)
            grads = torch.autograd.grad(loss, list(params.values()))
            opt.apply_gradients(params, dict(zip(params, grads)), state)
            torch.cuda.synchronize()
            counts.append(b_counts())
            losses.append(loss.item())
            if first is None:
                first = {k: g.detach().clone() for k, g in zip(params, grads)}
    return {"losses": losses, "counts": counts, "grads": first,
            "params": {k: p.detach().clone() for k, p in params.items()}}


def floor_gate(phase, name, runs, a, ref, get):
    """Run ``a`` against run ``ref`` leaf by leaf (what ``get`` takes out of
    a run), each within NOISE_FACTOR times its rounding floor: the
    distance the two runs move when only the order of their attention's
    keys changes (``<run>_perm``). The key projections' biases, whose
    true gradient is 0, are left out (the caller gates them). Fails
    ``phase``."""
    x, r = get(runs[a]), get(runs[ref])
    xp, rp = get(runs[a + "_perm"]), get(runs[ref + "_perm"])
    ratios, rel = {}, {}
    for leaf in r:
        if leaf.endswith(KEY_BIAS):
            continue
        diff = (x[leaf] - r[leaf]).norm().item()
        floor = math.hypot((x[leaf] - xp[leaf]).norm().item(),
                           (r[leaf] - rp[leaf]).norm().item())
        ratios[leaf] = diff / max(floor, 1e-30) if diff else 0.0
        rel[leaf] = diff / max(r[leaf].norm().item(), 1e-30)
    worst = max(ratios, key=ratios.get)
    rec = {"rel_median": float(np.median(list(rel.values()))),
           "rel_worst": max(rel.values()),
           "floor_ratio_median": float(np.median(list(ratios.values()))),
           "floor_ratio_worst": ratios[worst], "worst_leaf": worst}
    log(f"[{phase}] {name}, {a} vs {ref}, leaf by leaf: rel L2 median "
        f"{rec['rel_median']:.2e}, worst {rec['rel_worst']:.2e}; x the "
        f"permuted runs' floor median {rec['floor_ratio_median']:.2f}, worst "
        f"{ratios[worst]:.2f} ({worst}; gate {NOISE_FACTOR:g})")
    if ratios[worst] > NOISE_FACTOR:
        fail(phase, f"{name} {a} vs {ref}: {worst} {ratios[worst]:.2f}x "
                    f"the floor")
    return rec


def phase_bert_train(dev, seed):
    """B1: BERT-base in float32 at full width and depth (batch cut to
    8 x 128 to carry the gates), random ids with pads, MLM labels and
    weights and NSP labels. ``use_pallas=True``: B_STEPS unfused AdamW
    steps through the flash kernels and through their plain versions, both
    again with the attention's keys reordered (``permuted_keys``);
    ``use_pallas=False`` (dense attention) the same two ways. Gates: each
    step's loss within 1e-4 relative of the plain route's (flash kernels)
    and of the flash kernels' (dense); the first gradients leaf by leaf
    and the parameters after step 3 (whole tree) within NOISE_FACTOR times
    the reordered runs' floor; the key
    biases' gradients below KEY_BIAS_TOL of their weights' and their
    parameters within ADAM_PAIR_BOUND * lr a step; launches a step as
    ``b_expect``."""
    from paddle_tpu_torch import bert_bench
    from paddle_tpu_torch.models import BertConfig, BertForPretraining
    cfg = {up: BertConfig.base(use_pallas=up) for up in (True, False)}
    data = bert_batch(B1_BATCH, cfg[True].vocab_size, dev, seed)
    models = {up: BertForPretraining(c, device=dev, seed=seed)
              for up, c in cfg.items()}
    init = {k: v.detach().clone()
            for k, v in models[True].state_dict().items()}
    runs = {}
    for name, up, plain in (("kernel", True, False), ("plain", True, True),
                            ("dense", False, False)):
        for reorder in (False, True):
            key = name + "_perm" if reorder else name
            runs[key] = r = b1_run(models[up], init, data, plain, reorder,
                                   seed)
            want = b_expect(up and not plain, torch.float32)
            log(f"[B1] {key:<12} losses "
                f"{', '.join(f'{v:.7f}' for v in r['losses'])}; launches a "
                f"step {r['counts'][0]}")
            if any(c != want for c in r["counts"]):
                fail("B1", f"{key}: launches {r['counts']}, expected {want}")
            if not all(math.isfinite(v) for v in r["losses"]):
                fail("B1", f"{key}: non-finite loss {r['losses']}")
    del models
    rec = {"losses": {k: r["losses"] for k, r in runs.items()},
           "launches_per_step": runs["kernel"]["counts"][0],
           # the runs through the kernels, float32 (the SIMT routes)
           "launches": {k: sum(c[k] for n in ("kernel", "kernel_perm")
                               for c in runs[n]["counts"])
                        for k in B_KEYS}}
    for a, ref in (("kernel", "plain"), ("dense", "kernel")):
        rel = max(abs(x - y) / abs(y) for x, y in
                  zip(runs[a]["losses"], runs[ref]["losses"]))
        log(f"[B1] losses {a} vs {ref}: max rel diff {rel:.3e} (gate 1e-4)")
        if rel > 1e-4:
            fail("B1", f"losses {a} vs {ref} part by {rel:.3e}")
        kb = {}
        for k, g in runs[a]["grads"].items():
            if k.endswith(KEY_BIAS):
                w = runs[a]["grads"][k[:-len("bias")] + "weight"]
                kb[k] = (g.norm() / w.norm()).item()
        kb_p = max(abs(runs[a]["params"][k] - runs[ref]["params"][k]).max()
                   .item() for k in kb)
        log(f"[B1] key biases ({a}): |g|/|g_weight| at most "
            f"{max(kb.values()):.2e} (gate {KEY_BIAS_TOL:g}); parameters "
            f"vs {ref} max |diff| {kb_p:.3e} (bound "
            f"{ADAM_PAIR_BOUND * bert_bench.LR * B_STEPS:g})")
        if max(kb.values()) > KEY_BIAS_TOL or \
                kb_p > ADAM_PAIR_BOUND * bert_bench.LR * B_STEPS:
            fail("B1", f"key biases {a} vs {ref}")
        rec[f"{a}_vs_{ref}"] = {
            "loss_rel": rel, "key_bias_grad_ratio": max(kb.values()),
            "key_bias_param_diff": kb_p,
            "grads": floor_gate("B1", "first-step gradients", runs, a, ref,
                                lambda r: r["grads"]),
            "params": floor_gate("B1", f"parameters after step {B_STEPS} "
                                       "(whole tree)", runs, a, ref,
                                 lambda r: {"tree": torch.cat(
                                     [v.reshape(-1) for k, v in
                                      r["params"].items()
                                      if not k.endswith(KEY_BIAS)])})}
    del runs
    torch.cuda.empty_cache()
    return rec


def phase_bert_bench(dev, seed):
    """B2: the bench step (``paddle_tpu_torch/bert_bench.py``: BERT-base
    bf16, batch 32 x 128, unfused AdamW) as the bench defines it
    (``use_pallas=False``) and with ``use_pallas=True``. Each: 2 warm-up
    steps, then the main path's B_TIMED steps, each counted (counts set to
    0 just before, read just after; ``b_expect``) and timed to a
    synchronize; tokens/s is their tokens over their summed wall time, MFU
    the estimate's FLOPs at that rate over the card's bf16 peak. Then three
    steps split into the forward and backward and the AdamW update, each
    timed to a synchronize, and one profiled step: device busy time, idle
    share over its own wall time, the top kernels and, with
    ``use_pallas``, each flash kernel's device time at BERT's shape."""
    from paddle_tpu_torch import bert_bench
    from paddle_tpu_torch.bench import peak_for
    _, peak = peak_for(torch.cuda.get_device_name(dev))
    out = {}
    for up in (False, True):
        label = "use_pallas" if up else "bench"
        cfg = bert_bench.config("cuda", up)
        batch, seqlen = bert_bench.SIZES["cuda"]
        model, params, opt, state, data = bert_bench.build(cfg, batch,
                                                           seqlen, dev, seed)

        def step():
            return bert_bench.train_step(model, params, opt, state, data)

        for _ in range(bert_bench.WARMUP):
            step()
        torch.cuda.synchronize()
        wall, losses, counts = [], [], []
        for _ in range(B_TIMED):
            zero_b_counts()
            t0 = time.perf_counter()
            loss = step()
            torch.cuda.synchronize()
            wall.append((time.perf_counter() - t0) * 1e3)
            counts.append(b_counts())
            losses.append(loss.item())
        want = b_expect(up, torch.bfloat16)
        if any(c != want for c in counts) or \
                not all(math.isfinite(v) for v in losses):
            fail("B2", f"{label}: launches {counts}, expected {want} a "
                       f"step; losses {losses}")
        flops = bert_bench.step_flops(cfg, batch, seqlen)
        rate = batch * seqlen * B_TIMED / sum(wall) * 1e3
        rec = {"wall_ms": wall, "step_ms": sum(wall) / B_TIMED,
               "tokens_per_s": rate,
               "mfu": flops * B_TIMED / sum(wall) * 1e3 / peak,
               "flops_per_step": flops, "losses": losses,
               "launches_per_step": counts[0],
               "launches": {k: sum(c[k] for c in counts) for k in B_KEYS}}
        fwd_bwd, update = [], []
        for _ in range(3):
            t0 = time.perf_counter()
            loss = bert_bench.loss_fn(model)(params, *data)
            grads = torch.autograd.grad(loss, list(params.values()))
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            opt.apply_gradients(params, dict(zip(params, grads)), state)
            torch.cuda.synchronize()
            fwd_bwd.append((t1 - t0) * 1e3)
            update.append((time.perf_counter() - t1) * 1e3)
        rec.update(fwd_bwd_ms=sum(fwd_bwd) / 3, update_ms=sum(update) / 3)
        del grads
        busy, kernels, prof_ms = profiled(
            step, f"the BERT step ({label})",
            expect=dict({B_SYMBOLS[k]: 12 for k in B2_KERNELS},
                        **{B_SYMBOLS[k]: 0 for k in FLASH_TC_TWIN.values()})
            if up else None)
        if busy <= 0:
            fail("B2", f"the profiled {label} step recorded no device time")
        rec.update(device_busy_ms=busy, profiled_wall_ms=prof_ms,
                   idle_share=1.0 - busy / prof_ms,
                   top_kernels=[{"name": n[:120], "count": c, "device_ms": t}
                                for n, c, t in kernels[:15]])
        if up:
            rec["kernels_in_step"] = {}
            for key in B2_KERNELS + tuple(FLASH_TC_TWIN.values()):
                rows = [r for r in kernels if B_SYMBOLS[key] in r[0]]
                n = sum(r[1] for r in rows)
                if n != (12 if key in B2_KERNELS else 0):
                    fail("B2", f"the profiled step shows {n} {key}")
                rec["kernels_in_step"][key] = {
                    "count": n, "device_ms": sum(r[2] for r in rows)}
        out[label] = rec
        log(f"[B2] BERT-base bf16 {label} (batch {batch} x {seqlen}): "
            f"{B_TIMED} steps, {rec['step_ms']:.2f} ms a step, "
            f"{rate:.0f} tokens/s, MFU {rec['mfu']:.4f} (estimate "
            f"{flops:.3e} FLOPs a step over {peak / 1e12:g} TFLOP/s); "
            f"launches a step {counts[0]}; loss {losses[0]:.4f} -> "
            f"{losses[-1]:.4f}; forward + backward {rec['fwd_bwd_ms']:.2f} "
            f"ms, AdamW update {rec['update_ms']:.2f} ms (3 steps split, "
            f"each part to a synchronize); profiled step: device busy "
            f"{busy:.2f} of {prof_ms:.2f} ms (idle share "
            f"{rec['idle_share']:.3f})")
        for n, c, t in kernels[:10]:
            log(f"[B2]   {t:8.3f} ms {c:5d}x  {n[:100]}")
        del model, params, opt, state, data
        torch.cuda.empty_cache()
    return out


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
    from paddle_tpu_torch.core.device import card_name_and_power

    dev = torch.device("cuda")
    card = card_name_and_power()
    log(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}; nvidia-smi: {card}")
    t_start = time.perf_counter()
    report = {"card": card, "seed": args.seed}
    report["build"] = phase_build()
    report["resnet_kernels"], r_worst = phase_resnet_kernels(dev, args.seed)
    report["resnet_train"] = phase_resnet_train(dev, args.seed)
    report["pool_kernels"], pool_numbers, report["pool_path"] = \
        phase_pool(dev, args.seed)
    report["seqpool_kernels"], seqpool_worst, report["seqpool_shapes"] = \
        phase_seqpool_kernels(dev, args.seed)
    report["imdb_train"] = phase_imdb_train(dev, args.seed)
    report["layer_norm_kernels"], ln_worst = phase_layer_norm_kernels(
        dev, args.seed)
    report["layer_norm_numbers"] = phase_layer_norm_numbers(dev, args.seed)
    report["bert_train"] = phase_bert_train(dev, args.seed)
    report["bert_bench"] = phase_bert_bench(dev, args.seed)
    report["resnet_bench"] = phase_resnet_bench(dev, args.seed)
    r_main = report["resnet_bench"]["grad+out+blk+stem+bnres"]
    report["resnet_numbers"] = phase_resnet_numbers(r_main, dev, args.seed)
    report["kernels"], worst = phase_kernels(dev, args.seed)
    model_bf16 = full_width_model(torch.bfloat16, dev, args.seed)
    report["serving"] = phase_serving(model_bf16, dev, args.seed)
    serving_launches = report["serving"]["launches_by_route"]
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
    worst["flash_fwd_tc"] = max(worst["flash_fwd_tc"],
                                train_worst.pop("flash_fwd_tc"))
    worst.update(train_worst)
    report["train"], model_bf, batch = phase_train(model32, dev, args.seed)
    report["train_step"], train_numbers = phase_train_numbers(
        model32, model_bf, batch, dev, args.seed)
    report["train_numbers"] = train_numbers
    report["seconds"] = time.perf_counter() - t_start

    # the flash kernels by route: the serving path's (the forward), the
    # training path's (float32 on the SIMT kernels, bf16 on the tensor
    # cores), the BERT bench step's (bf16) and, for dQ and dK/dV, B1's
    # float32 BERT steps; each SIMT row counts its route's launches, not
    # the kernel's total
    launches = dict(report["train"]["launches"])
    bert_launches = dict(report["bert_bench"]["use_pallas"]["launches"])
    b1_launches = dict(report["bert_train"]["launches"])
    for simt in FLASH_TC_TWIN.values():
        for counts in (launches, bert_launches, b1_launches):
            counts[simt] = counts.pop(f"{simt}_simt")
    launches["flash_fwd"] += serving_launches["simt"]
    launches["flash_fwd_tc"] += serving_launches["tc"]
    for key in (*FLASH_TC_TWIN, *FLASH_TC_TWIN.values()):
        launches[key] += bert_launches[key]
        if key.startswith("flash_bwd_"):
            launches[key] += b1_launches[key]
    launches["layer_norm"] = report["layer_norm_numbers"]["launches"]
    # the conv and pool kernels: the counted step of the bench (lowp
    # default), where every 3x3 forward, dx and weight gradient and every
    # 1x1 GEMM takes the tensor cores; the SIMT brgemm, forward, dx and
    # weight gradient: R2's float32 steps (the SIMT dx there alone), and
    # brgemm and the SIMT forward also the (float32) eval forward, each
    # path's count in ``launches_by_path``; seqpool: the classifier's
    # counted unfused run
    launches.update(r_main["launches"])
    route_paths = {
        "resnet_f32_train": report["resnet_train"]["launches"],
        "resnet_bf16_step": r_main["launches"],
        "resnet_eval": report["resnet_bench"]["bf16"]["eval"]["launches"]}
    by_path = {}
    for simt in dict.fromkeys(TC_TWIN.values()):
        launches.pop(f"{simt}_simt")
        for name, key in (*((tc, tc) for tc in tc_rows(simt)),
                          (simt, f"{simt}_simt")):
            by_path[name] = {p: c[key] for p, c in route_paths.items()}
            launches[name] = sum(by_path[name].values())
    launches["seqpool"] = report["imdb_train"]["unfused"]["launches"][
        "seqpool"]
    worst.update(r_worst)
    worst.update(
        layer_norm=ln_worst, seqpool=seqpool_worst,
        pool_fwd=max(r["out_max_abs_err"] for r in report["pool_kernels"]),
        pool_bwd_gather=max(r.get("gather_max_abs_err", r["max_abs_err"])
                            for r in report["pool_kernels"]),
        pool_bwd_tile=max(r["max_abs_err"] for r in report["pool_kernels"]
                          if r["route"] == "tile"))
    # the pool kernels: the forward and the tile backward's device time
    # from their launches in the profiled step; the gather, which no step
    # launches, from P1's calls. Launches: the counted steps of R2 and R3,
    # the eval forward and P1's entry-point path, each in
    # ``launches_by_path``
    pool_paths = dict(route_paths, pool2d_entry=report["pool_path"])
    for row in POOL_ROWS:
        in_step = r_main["kernels_in_step"][row]
        if in_step["count"] != R_PER_STEP[row]:
            fail("R4", f"the profiled step shows {in_step['count']} {row}")
        if in_step["count"]:
            pool_numbers[row]["ms"] = in_step["device_ms"] / in_step["count"]
        by_path[row] = {p: c[row] for p, c in pool_paths.items()}
        launches[row] = sum(by_path[row].values())
    # flash_fwd (SIMT): the serving decoder shape's times (12 of every 12
    # launches per decode step); flash_fwd_tc: the training shape's (12
    # launches a step). Their other shapes are in "shapes", each with the
    # other route's time at the same inputs where it was measured.
    main = next(r for r in report["numbers"]
                if r["case"] == "decoder_self" and r["dtype"] == "bfloat16")
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    shape_keys = ("case", "dtype", "shape", "route", "ms", "simt_ms",
                  "plain_ms", "bound_ms", "bound_by", "library_ms", "call_ms")
    kernels_line = []
    for name, meta in KERNELS.items():
        rec = {"name": name, **meta, "launches": launches[name],
               "max_abs_err": worst[name]}
        if name in ("flash_fwd", "flash_fwd_tc"):
            route = "tc" if name == "flash_fwd_tc" else "simt"
            if route == "simt":
                rec.update({k: main[k] for k in keys})
            else:
                rec.update({k: train_numbers[name][k] for k in keys})
            rec["launches_by_path"] = {
                "serving": serving_launches[route],
                "training": report["train"]["launches"][
                    "flash_fwd_tc" if route == "tc" else "flash_fwd_simt"],
                "bert": bert_launches[name]}
            train = dict({k: train_numbers[name][k] for k in keys},
                         case="train", dtype="bfloat16",
                         shape=list(TRAIN_FLASH[1:6]), route="simt")
            if route == "tc":
                train.update(route="tc",
                             simt_ms=train_numbers["flash_fwd"]["ms"])
            rec["shapes"] = [{k: r.get(k) for k in shape_keys}
                             for r in report["numbers"]
                             if r["route"] == route] + [train]
        elif name.startswith("flash_bwd_"):
            rec.update(train_numbers[name])
            counter = name if name.endswith("_tc") else name + "_simt"
            rec["launches_by_path"] = {
                "training": report["train"]["launches"][counter],
                "bert": bert_launches[name],
                "bert_f32": b1_launches[name]}
        elif name in RESNET_KERNELS:
            rec.update({k: report["resnet_numbers"][name][k] for k in keys})
            if name in by_path:
                rec["launches_by_path"] = by_path[name]
            if name in TC_TWIN:
                rec["simt_ms"] = report["resnet_numbers"][name]["simt_ms"]
            if "library_device_ms" in report["resnet_numbers"][name]:
                rec["library_device_ms"] = \
                    report["resnet_numbers"][name]["library_device_ms"]
        elif name in pool_numbers:
            rec.update({k: pool_numbers[name][k] for k in keys})
            rec["call_ms"] = pool_numbers[name]["call_ms"]
            rec["launches_by_path"] = by_path[name]
        elif name == "seqpool":
            rec.update({k: report["imdb_train"]["seqpool_numbers"][k]
                        for k in keys})
        elif name == "layer_norm":
            rec.update({k: report["layer_norm_numbers"]["shapes"][0][k]
                        for k in keys})
        else:
            rec.update(train_numbers[name])
        if not rec["launches"]:
            fail("main", f"{name} was launched no time on its main paths")
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
