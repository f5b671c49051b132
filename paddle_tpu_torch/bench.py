"""ResNet-50 training throughput on one card (counterpart of the repo's
``bench.py``, its ResNet-50 step: ``bench.py:71-180``).

    python3 -m paddle_tpu_torch.bench            # batch 256 x 224, bf16

The step: ``resnet50(num_classes=1000, lowp=...)`` in training mode on
NHWC bfloat16 input drawn from a normal (seed 0), labels 0,
``log_softmax`` and the mean NLL in float32, ``Momentum(0.1, 0.9)``.
Knobs, read from the environment as the JAX benchmark reads them:

- ``PADDLE_TPU_LOWP``: "0" pure bf16; unset or "1" the shipped default
  "grad+out+blk+stem+bnres"; anything else a literal token string.
- ``PADDLE_TPU_CONV_FUSED``: the fused conv kernels (``nn_ops.CONV_FUSED``).
  On unless set to "0": they are this slice's path (the JAX benchmark
  turns them on when the variable is set at all).
- ``PADDLE_TPU_FUSED_OPT``: set and not "0" routes the update through the
  fused optimizer kernel.
- ``PADDLE_TPU_POOL_FUSED``: set and not "0" routes the stem's max pool
  through the fused max-pool kernels (``pool_fused.POOL_FUSED``); off by
  default, as in the JAX benchmark.

Prints one JSON line with ``bench.py``'s keys (``metric``, ``value``,
``unit``, ``vs_baseline``, ``precision``) plus ``mfu`` and the card. MFU
takes the hand estimate of ``bench.py:175`` (``batch * 3 * 4.1e9`` FLOPs a
step) over the card's dense bf16 tensor-core peak: 989 TFLOP/s for the
H100 SXM part, 756 for the PCIe part (NVIDIA's data sheets), chosen from
the device name. On the CPU (``--device cpu``) the run is the JAX
benchmark's off-TPU size, batch 8 x 64, 3 steps, and reports no MFU.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch
import torch.nn.functional as F

REFERENCE_IMGS_PER_SEC = 84.08  # IntelOptimizedPaddle.md ResNet-50 train
DEFAULT_LOWP = "grad+out+blk+stem+bnres"
FLOPS_PER_IMAGE = 3 * 4.1e9     # forward + backward, bench.py:175
# dense bf16 peaks by part (NVIDIA H100 data sheet); PCIe is tested first
PEAK_BF16 = (("H100 PCIe", "PCIe", 756e12), ("H100", "SXM", 989e12))


def lowp_from_env():
    env = os.environ.get("PADDLE_TPU_LOWP")
    if env == "0":
        return ""
    return DEFAULT_LOWP if env in (None, "", "1") else env


def conv_fused_from_env():
    return os.environ.get("PADDLE_TPU_CONV_FUSED", "1") != "0"


def fused_opt_from_env():
    return os.environ.get("PADDLE_TPU_FUSED_OPT", "0") not in ("", "0")


def pool_fused_from_env():
    return os.environ.get("PADDLE_TPU_POOL_FUSED", "0") not in ("", "0")


def build(batch, size, lowp, device, seed=0, dtype=torch.bfloat16):
    """(model, params, optimizer, state, x, labels) of the benchmark's
    step: ResNet-50 in training mode, its parameter tree, Momentum(0.1,
    0.9) and its state, NHWC input from a normal (seed ``seed``) in
    ``dtype``, labels 0."""
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.convert import param_tree
    from paddle_tpu_torch.models import resnet50
    model = resnet50(num_classes=1000, lowp=lowp, device=device, seed=seed)
    model.train()
    params = param_tree(model)
    opt = optimizer.Momentum(learning_rate=0.1, momentum=0.9)
    state = opt.init(params)
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(batch, size, size, 3, generator=gen,
                    device=device).to(dtype)
    labels = torch.zeros(batch, dtype=torch.long, device=device)
    return model, params, opt, state, x, labels


def loss_fn(model):
    """``loss(params, x, labels)``: log_softmax of the float32 logits,
    mean NLL (``bench.py:104-113``); the model's parameters are the ones
    in ``params``."""
    def fn(params, x, labels):
        logp = F.log_softmax(model(x).float(), dim=-1)
        return -torch.mean(torch.gather(logp, 1, labels[:, None]))
    return fn


def train_step(model, params, opt, state, x, labels, fused=False):
    """One step in place; returns the loss (a device scalar)."""
    loss, _, _, _ = opt.minimize(loss_fn(model), params, state, x, labels,
                                 fused=fused)
    return loss


def peak_for(name):
    """(part, dense bf16 peak FLOP/s) of a card by name, or (None, None)."""
    for key, part, peak in PEAK_BF16:
        if key in name:
            return part, peak
    return None, None


def run(device="cuda", batch=None, size=None, steps=None, seed=0):
    """Build, warm up, time ``steps`` steps; returns the result dict."""
    from paddle_tpu_torch.core.device import resolve_device
    from paddle_tpu_torch.kernels import pool_fused
    from paddle_tpu_torch.ops import nn_ops
    dev = resolve_device(device)
    on_gpu = dev.type == "cuda"
    batch = batch or (256 if on_gpu else 8)
    size = size or (224 if on_gpu else 64)
    steps = steps or (20 if on_gpu else 3)
    lowp = lowp_from_env()
    nn_ops.set_conv_fused(conv_fused_from_env())
    pool_fused.set_pool_fused(pool_fused_from_env())
    fused = fused_opt_from_env()
    model, params, opt, state, x, labels = build(batch, size, lowp, dev,
                                                 seed)

    def sync():
        if on_gpu:
            torch.cuda.synchronize(dev)

    loss = train_step(model, params, opt, state, x, labels, fused)
    float(loss)
    sync()
    t0 = time.perf_counter()
    for _ in range(steps):
        loss = train_step(model, params, opt, state, x, labels, fused)
    final_loss = float(loss)
    sync()
    dt = time.perf_counter() - t0
    if final_loss != final_loss:
        raise RuntimeError("NaN loss")
    imgs_per_sec = batch * steps / dt
    result = {
        "metric": "resnet50_train_imgs_per_sec_per_chip",
        "value": round(imgs_per_sec, 2),
        "unit": "imgs/s",
        "vs_baseline": round(imgs_per_sec / REFERENCE_IMGS_PER_SEC, 3),
        "precision": "bf16+fp8_storage" if lowp else "bf16",
        "batch": batch, "image_size": size, "steps": steps,
        "conv_fused": nn_ops.CONV_FUSED, "pool_fused": pool_fused.POOL_FUSED,
        "fused_opt": fused,
        "final_loss": final_loss,
    }
    if on_gpu:
        name = torch.cuda.get_device_name(dev)
        part, peak = peak_for(name)
        result["device"] = name
        if peak is not None:
            result["mfu"] = round(batch * FLOPS_PER_IMAGE * steps / dt / peak,
                                  4)
            result["peak_part"] = part
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--size", type=int, default=None)
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    print(json.dumps(run(args.device, args.batch, args.size, args.steps,
                         args.seed)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
