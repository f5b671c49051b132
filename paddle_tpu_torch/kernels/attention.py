"""Flash-attention forward for Hopper (counterpart of
``paddle_tpu/kernels/attention.py``).

``flash_attention`` keeps the JAX function's ``[B, H, T, D]`` signature and
its routing condition (``paddle_tpu/kernels/attention.py:40``): the kernel
runs when ``not causal or tq == tk``; otherwise the plain version runs, as
the XLA scan path does in the JAX package. On a CUDA tensor the kernel is
``csrc/flash_fwd.cu`` (it replaces the Pallas ``_flash_fwd_kernel``); a
failed build or launch raises, nothing falls back. On a CPU tensor the
plain version runs. Like every entry point of the port it takes
``device``, default ``"cuda"``, which must match the tensors.

``flash_attention_reference`` is the plain version: the same function in
PyTorch, with the JAX kernel's masking contract. Scores are float32 after
the upcast with the scale applied to q; masked scores are the finite
``-1e30`` and the running max starts there; ``l`` is clamped at ``1e-30``.
A row whose keys are all masked therefore returns the uniform mean of V
with ``lse ~= -1e30``, never NaN: ``Generator`` pads a batch with all-pad
source rows, and those rows take exactly this path in the encoder and in
the cross-attention.
"""

from __future__ import annotations

import ctypes

import torch

from paddle_tpu_torch.core.device import DEFAULT_DEVICE, resolve_device

MASK_VALUE = -1e30
MAX_HEAD_DIM = 128
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_reference(q, k, v, causal=False, scale=None,
                              kv_mask=None):
    """Plain PyTorch version. q ``[B, H, Tq, D]``, k/v ``[B, H, Tk, D]``,
    kv_mask ``[B, Tk]`` bool (True = attend). Returns (o in q's dtype,
    lse ``[B, H, Tq]`` float32). Causal is top-left aligned: query i sees
    keys at positions <= i, as in the JAX kernel and scan path."""
    d = q.shape[-1]
    tq, tk = q.shape[2], k.shape[2]
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    s = torch.matmul(q.float() * scale, k.float().transpose(-1, -2))
    if causal:
        pos_q = torch.arange(tq, device=q.device)[:, None]
        pos_k = torch.arange(tk, device=q.device)[None, :]
        s = s.masked_fill(pos_q < pos_k, MASK_VALUE)
    if kv_mask is not None:
        s = s.masked_fill(~kv_mask.bool()[:, None, None, :], MASK_VALUE)
    m = s.amax(dim=-1).clamp(min=MASK_VALUE)
    p = torch.exp(s - m[..., None])
    l_safe = p.sum(dim=-1).clamp(min=1e-30)
    o = torch.matmul(p, v.float()) / l_safe[..., None]
    return o.to(q.dtype), m + torch.log(l_safe)


def _lib():
    from paddle_tpu_torch.core import native_build
    lib = native_build.load("flash_fwd")
    if not getattr(lib, "_argtypes_set", False):
        p = ctypes.c_void_p
        lib.flash_fwd.argtypes = [p, p, p, p, p, p, ctypes.c_int, ctypes.c_int,
                                  ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                  ctypes.c_float, ctypes.c_int, ctypes.c_int,
                                  p]
        lib.flash_fwd.restype = ctypes.c_int
        lib._argtypes_set = True
    return lib


def flash_fwd_cuda(q, k, v, causal, scale, kv_mask=None):
    """Launch ``csrc/flash_fwd.cu``. q ``[B, H, Tq, D]``, k/v
    ``[B, H, Tk, D]``, contiguous CUDA tensors of one dtype (float32 or
    bfloat16), D <= 128; kv_mask ``[B, Tk]`` bool/uint8, contiguous.
    Returns (o, lse) as the plain version does. Raises on what the kernel
    does not take and on a launch error."""
    b, h, tq, d = q.shape
    tk = k.shape[2]
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor on {q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q is {q.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"flash_fwd takes float32 or bfloat16, not {q.dtype}")
    if d > MAX_HEAD_DIM or d < 1:
        raise ValueError(f"head dim {d} outside 1..{MAX_HEAD_DIM}")
    if tuple(k.shape) != (b, h, tk, d) or k.shape != v.shape:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    mask_ptr = None
    if kv_mask is not None:
        if tuple(kv_mask.shape) != (b, tk):
            raise ValueError(f"kv_mask {tuple(kv_mask.shape)} is not "
                             f"[{b}, {tk}]")
        if kv_mask.dtype not in (torch.bool, torch.uint8):
            raise TypeError(f"kv_mask must be bool or uint8, not "
                            f"{kv_mask.dtype}")
        if kv_mask.device != q.device or not kv_mask.is_contiguous():
            raise ValueError("kv_mask must be contiguous on q's device")
        mask_ptr = kv_mask.data_ptr()
    lib = _lib()
    o = torch.empty_like(q)
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            mask_ptr, o.data_ptr(), lse.data_ptr(),
                            b * h, h, tq, tk, d, float(scale), int(causal),
                            _DTYPE_CODES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"flash_fwd launch failed: cudaError_t {err}")
    flash_attention.launches += 1
    return o, lse


def flash_attention(q, k, v, causal=False, scale=None, kv_mask=None,
                    device=DEFAULT_DEVICE):
    """q,k,v: ``[B, H, T, D]``; kv_mask: optional ``[B, Tk]`` bool (True =
    attend). Returns o ``[B, H, Tq, D]`` in q's dtype.

    ``device`` is where the caller means to run: the default ``"cuda"``
    raises where no card is present, and q must lie on that device type.
    CUDA tensors with ``not causal or tq == tk`` launch the kernel and
    count one launch in ``flash_attention.launches``; causal with
    ``tq != tk`` takes the plain version, as the JAX package takes its
    scan path there. CPU tensors take the plain version."""
    if resolve_device(device).type != q.device.type:
        raise ValueError(f"q lies on {q.device}, device is {device}")
    tq, tk = q.shape[2], k.shape[2]
    scale = scale if scale is not None else 1.0 / (q.shape[-1] ** 0.5)
    if q.device.type == "cuda" and (not causal or tq == tk):
        return flash_fwd_cuda(q, k, v, causal, scale, kv_mask)[0]
    return flash_attention_reference(q, k, v, causal, scale, kv_mask)[0]


flash_attention.launches = 0
