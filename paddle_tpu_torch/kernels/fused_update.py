"""One-pass fused optimizer update (counterpart of
``paddle_tpu/kernels/fused_update.py``).

``fused_update_step`` applies clip-scale . SGD / Momentum / Adam / AdamW to
a dict of float32 parameters in place: one read-modify-write of (p, g,
moments) per element. On CUDA tensors it launches ``csrc/fused_update.cu``
once per bucket (a multi-tensor apply over a device table of chunks; it
replaces the Pallas ``_update_kernel``); a failed build or launch raises.
On CPU tensors each parameter takes ``update_reference``, the plain
version: the kernel's elementwise expression one PyTorch operation at a
time. The unfused ``Optimizer`` sweep calls it too, so the optimizer state
stays bit-identical between the routes.

The scalars ``[lr, clip_factor, 1 - b1^t, 1 - b2^t]`` are one float32
device tensor computed once per step (``step_scalars``), as the JAX
function computes them once (``paddle_tpu/kernels/fused_update.py:256``);
the host never reads them. The global-norm clip reduces the gradients
exactly as ``GradientClipByGlobalNorm`` does (same leaf order and casts)
and folds in as a factor, so the clipped gradients are never stored.

Parameters, gradients and moments are float32 (the port's training path
holds float32 weights, as the JAX Transformer does); other dtypes raise.
The EMA operand of the JAX kernel has no caller on the port's path and is
not ported.
"""

from __future__ import annotations

import ctypes

import torch

# kind -> accumulator names (the matching Optimizer's state keys)
ACC_NAMES = {
    "sgd": (),
    "momentum": ("velocity",),
    "adam": ("m", "v"),
    "adamw": ("m", "v"),
}
_KIND_CODES = {"sgd": 0, "momentum": 1, "adam": 2, "adamw": 3}
CHUNK = 1 << 16          # elements per block of the kernel


def global_norm(grads):
    """sqrt of the sum over leaves (in order) of sum(g.float() ** 2), the
    reduction of ``GradientClipByGlobalNorm``."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in grads))


def clip_factor(gnorm, clip_norm):
    """clip_norm / max(gnorm, clip_norm), a true float32 division (Python's
    ``float / tensor`` would multiply by a reciprocal)."""
    c = torch.full((), clip_norm, dtype=torch.float32, device=gnorm.device)
    return c / torch.maximum(gnorm, c)


def step_scalars(lr, step, kind, beta1=0.9, beta2=0.999, factor=None,
                 device=None):
    """float32 device tensor ``[lr, clip_factor, 1 - b1^t, 1 - b2^t]`` with
    t = step + 1 (1.0 where unused)."""
    lr = torch.as_tensor(lr, dtype=torch.float32).to(device)
    one = torch.ones((), dtype=torch.float32, device=device)
    factor = one if factor is None else factor.to(torch.float32)
    if kind in ("adam", "adamw"):
        t1 = (torch.as_tensor(step).to(device) + 1).to(torch.float32)
        c1, c2 = 1 - beta1 ** t1, 1 - beta2 ** t1
    else:
        c1 = c2 = one
    return torch.stack([lr.reshape(()), factor.reshape(()),
                        c1.reshape(()), c2.reshape(())])


@torch.no_grad()
def update_reference(kind, p, g, accs, scal, hyper, has_clip=False):
    """Plain version of the kernel for one parameter, in place: the
    expression of ``_update_kernel`` (``paddle_tpu/kernels/
    fused_update.py:91-142``), one rounded PyTorch operation at a time.
    ``scal`` is ``step_scalars``' tensor; its entries stay 0-dim device
    tensors so every division is a true division."""
    lr, factor, c1, c2 = scal[0], scal[1], scal[2], scal[3]
    if has_clip:
        g = g * factor
    if kind == "sgd":
        p.sub_(lr * g)
    elif kind == "momentum":
        mu = hyper["momentum"]
        v = accs[0]
        v.copy_(v * mu + g)
        step = lr * (g + v * mu) if hyper["nesterov"] else lr * v
        p.sub_(step)
    else:
        b1, b2 = hyper["beta1"], hyper["beta2"]
        m, v = accs
        m.copy_(m * b1 + g * (1 - b1))
        v.copy_(v * b2 + (g * g) * (1 - b2))
        delta = (lr * (m / c1)) / (torch.sqrt(v / c2) + hyper["epsilon"])
        if kind == "adamw":
            decay = (lr * hyper["weight_decay"]) * p
            p.sub_(delta)
            p.sub_(decay)
        else:
            p.sub_(delta)


def _lib():
    from paddle_tpu_torch.core import native_build
    lib = native_build.load("fused_update")
    if not getattr(lib, "_argtypes_set", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.fused_update.argtypes = [p, i, p, i, i, i, f, f, f, f, f, f, f,
                                     p]
        lib.fused_update.restype = ctypes.c_int
        lib._argtypes_set = True
    return lib


def chunk_table(params, grads, accs, device):
    """int64 device table ``[n_chunks, 5]``: (p, g, acc0, acc1, n) per
    chunk of ``CHUNK`` elements, pointers offset to the chunk's start."""
    rows = []
    for i, (p, g) in enumerate(zip(params, grads)):
        a = [acc[i] for acc in accs] + [None] * (2 - len(accs))
        n = p.numel()
        for s in range(0, n, CHUNK):
            off = s * 4
            rows.append([p.data_ptr() + off, g.data_ptr() + off,
                         0 if a[0] is None else a[0].data_ptr() + off,
                         0 if a[1] is None else a[1].data_ptr() + off,
                         min(CHUNK, n - s)])
    return torch.tensor(rows, dtype=torch.int64).to(device)


def fused_update_cuda(kind, params, grads, accs, scal, hyper, has_clip):
    """Launch ``csrc/fused_update.cu`` once over the lists ``params``,
    ``grads`` and ``accs`` (one list per accumulator): contiguous float32
    CUDA tensors of matching shapes on one device. Raises on what the
    kernel does not take and on a launch error."""
    dev = params[0].device
    for name, ts in (("params", params), ("grads", grads),
                     *((f"acc{j}", a) for j, a in enumerate(accs))):
        if len(ts) != len(params):
            raise ValueError(f"{name} has {len(ts)} tensors, params "
                             f"{len(params)}")
        for t, p in zip(ts, params):
            if t.device != dev or t.device.type != "cuda":
                raise ValueError(f"{name} must be CUDA tensors on {dev}")
            if t.dtype != torch.float32:
                raise TypeError(f"fused_update takes float32, {name} has "
                                f"{t.dtype}")
            if not t.is_contiguous() or t.shape != p.shape:
                raise ValueError(f"{name} must be contiguous and shaped "
                                 "as its parameter")
    if len(accs) != len(ACC_NAMES[kind]):
        raise ValueError(f"{kind} takes {len(ACC_NAMES[kind])} "
                         f"accumulators, got {len(accs)}")
    if scal.device != dev or scal.dtype != torch.float32 or \
            scal.shape != (4,) or not scal.is_contiguous():
        raise ValueError("scal must be a contiguous float32 [4] tensor on "
                         "the parameters' device")
    table = chunk_table(params, grads, accs, dev)
    b1, b2 = hyper["beta1"], hyper["beta2"]
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fused_update(
            table.data_ptr(), table.shape[0], scal.data_ptr(),
            _KIND_CODES[kind], int(hyper["nesterov"]), int(has_clip),
            hyper["momentum"], b1, 1 - b1, b2, 1 - b2, hyper["epsilon"],
            hyper["weight_decay"], stream)
    if err != 0:
        raise RuntimeError(f"fused_update launch failed: cudaError_t {err}")
    fused_update_step.launches += 1


@torch.no_grad()
def fused_update_step(params, grads, state, *, kind, lr, step=None,
                      momentum=0.9, nesterov=False, beta1=0.9, beta2=0.999,
                      epsilon=1e-8, weight_decay=0.0, clip_norm=None):
    """Apply one fused optimizer step, in place, to ``params`` (a dict of
    float32 tensors). ``grads`` has the same keys; ``state`` maps each of
    ``ACC_NAMES[kind]`` to a dict of float32 tensors with the same keys;
    ``step`` is the 0-based global step (adam/adamw need it); ``clip_norm``
    folds a global-norm clip into the update.

    Returns ``(params, state, global_norm)``, the first two the same dicts
    updated in place, the norm None without a clip. CUDA tensors take one
    kernel launch per (device) bucket, counted in
    ``fused_update_step.launches``; CPU tensors take ``update_reference``."""
    if kind not in ACC_NAMES:
        raise ValueError(f"kind must be one of {sorted(ACC_NAMES)}, "
                         f"got {kind!r}")
    if kind in ("adam", "adamw") and step is None:
        raise ValueError(f"{kind} needs step= for bias correction")
    keys = list(params)
    if not keys:
        return params, state, None
    p_leaves = [params[k] for k in keys]
    g_leaves = [grads[k] for k in keys]
    for k, p, g in zip(keys, p_leaves, g_leaves):
        if p.dtype != torch.float32 or g.dtype != torch.float32:
            raise TypeError(f"{k}: the port's optimizers take float32 "
                            f"parameters and gradients, not {p.dtype}/"
                            f"{g.dtype}")
    acc_leaves = [[state[nm][k] for k in keys] for nm in ACC_NAMES[kind]]
    device = p_leaves[0].device
    gnorm = factor = None
    if clip_norm is not None:
        gnorm = global_norm(g_leaves)
        factor = clip_factor(gnorm, clip_norm)
    scal = step_scalars(lr, step, kind, beta1, beta2, factor, device)
    hyper = dict(momentum=momentum, nesterov=nesterov, beta1=beta1,
                 beta2=beta2, epsilon=epsilon, weight_decay=weight_decay)
    has_clip = clip_norm is not None
    if device.type == "cuda":
        buckets = {}
        for i, p in enumerate(p_leaves):
            buckets.setdefault(p.device, []).append(i)
        for idxs in buckets.values():
            fused_update_cuda(kind, [p_leaves[i] for i in idxs],
                              [g_leaves[i] for i in idxs],
                              [[a[i] for i in idxs] for a in acc_leaves],
                              scal, hyper, has_clip)
    else:
        for i, (p, g) in enumerate(zip(p_leaves, g_leaves)):
            update_reference(kind, p, g, [a[i] for a in acc_leaves], scal,
                             hyper, has_clip)
    return params, state, gnorm


fused_update_step.launches = 0

