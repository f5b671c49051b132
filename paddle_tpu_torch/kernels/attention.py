"""Flash attention for Hopper, forward and backward (counterpart of
``paddle_tpu/kernels/attention.py``).

``flash_attention`` keeps the JAX function's ``[B, H, T, D]`` signature and
its routing condition (``paddle_tpu/kernels/attention.py:40``): the kernel
runs when ``not causal or tq == tk``; otherwise the plain version runs, as
the XLA scan path does in the JAX package. On a CUDA tensor the forward is
one of two hand-written kernels, both counterparts of the Pallas
``_flash_fwd_kernel``, chosen by the pure rule ``fwd_route``:
``csrc/flash_fwd_tc.cu`` (wgmma on the tensor cores) for bf16 with D a
multiple of 16 up to 128, Tq >= 16 and 16-byte aligned operands, and
``csrc/flash_fwd.cu`` (float32 SIMT) for the rest: float32, decode (Tq =
1) and other head dims. A failed build or launch of either raises; neither
gives way to the other or to the plain version. On a CPU tensor the plain
version runs. Like every entry point of the port it takes ``device``,
default ``"cuda"``, which must match the tensors.

When autograd records (an input requires grad) the call goes through the
dispatcher op ``paddle_tpu_torch::flash_attn``, the counterpart of
``flash_attention_trainable``: its forward saves (q, k, v, kv_mask, o, lse)
and its backward computes ``dvec = sum_d(do * o)`` in float32 and launches
dQ, then dK/dV (they replace ``_flash_bwd_dq_kernel`` and
``_flash_bwd_dkv_kernel``). Each is one of two kernels, chosen by the one
pure rule ``bwd_route`` that both wrappers call: the tensor cores for
bf16 with D a multiple of 16 in 16..64 and 16-byte aligned operands
(``csrc/flash_bwd_dq_tc.cu`` and ``csrc/flash_bwd_dkv_tc.cu``, wgmma), and
``csrc/flash_bwd.cu``'s SIMT kernels for the rest (float32, other head
dims); as in the forward, a failed build or launch raises and neither
gives way to the other. Being an op, it is what a selective-checkpoint
policy names to keep (o, lse) under remat.

``flash_attention_reference`` and ``flash_attention_bwd_reference`` are
the plain versions: the same functions in PyTorch, with the JAX kernels'
masking contract. Scores are float32 after the upcast with the scale
applied to q; masked scores are the finite ``-1e30`` and the running max
starts there; ``l`` is clamped at ``1e-30``. A row whose keys are all
masked therefore returns the uniform mean of V with ``lse ~= -1e30``, never
NaN: ``Generator`` pads a batch with all-pad source rows, and those rows
take exactly this path in the encoder and in the cross-attention. In the
backward such a row has p = 1 for every key, as on the TPU; training
declares these rows unsupported and has none.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

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


def _tc_lib():
    from paddle_tpu_torch.core import native_build
    lib = native_build.load("flash_fwd_tc")
    if not getattr(lib, "_argtypes_set", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.flash_fwd_tc.argtypes = [p] * 6 + [i] * 5 + [ctypes.c_float, i,
                                                         p]
        lib.flash_fwd_tc.restype = ctypes.c_int
        lib._argtypes_set = True
    return lib


def _check_inputs(q, k, v, kv_mask, extra=()):
    """Raise on what the kernels do not take; returns the mask pointer (or
    None). q ``[B, H, Tq, D]``, k/v ``[B, H, Tk, D]``: contiguous CUDA
    tensors of one dtype (float32 or bfloat16), D <= 128; ``extra`` is
    (name, tensor, shape, dtype or None for q's dtype) of further operands;
    kv_mask ``[B, Tk]`` bool/uint8, contiguous."""
    b, h, tq, d = q.shape
    tk = k.shape[2]
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"flash kernels take float32 or bfloat16, not "
                        f"{q.dtype}")
    if d > MAX_HEAD_DIM or d < 1:
        raise ValueError(f"head dim {d} outside 1..{MAX_HEAD_DIM}")
    if tuple(k.shape) != (b, h, tk, d) or k.shape != v.shape:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    checks = [("q", q, q.shape, q.dtype), ("k", k, k.shape, q.dtype),
              ("v", v, v.shape, q.dtype)]
    checks += [(n, t, shape, dt or q.dtype) for n, t, shape, dt in extra]
    for name, t, shape, dtype in checks:
        if t.device != q.device or t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor on {q.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} is {t.dtype}, expected {dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} is {tuple(t.shape)}, expected "
                             f"{tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if kv_mask is None:
        return None
    if tuple(kv_mask.shape) != (b, tk):
        raise ValueError(f"kv_mask {tuple(kv_mask.shape)} is not "
                         f"[{b}, {tk}]")
    if kv_mask.dtype not in (torch.bool, torch.uint8):
        raise TypeError(f"kv_mask must be bool or uint8, not "
                        f"{kv_mask.dtype}")
    if kv_mask.device != q.device or not kv_mask.is_contiguous():
        raise ValueError("kv_mask must be contiguous on q's device")
    return kv_mask.data_ptr()


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def fwd_route(dtype, tq, d, aligned):
    """The forward kernel a CUDA call takes, by a fixed rule: ``"tc"``
    (``csrc/flash_fwd_tc.cu``, wgmma) for bfloat16 with D a multiple of 16
    up to 128, Tq >= 16 and q/k/v at 16-byte aligned bases (``aligned``; o,
    which the wrapper allocates, always is); ``"simt"``
    (``csrc/flash_fwd.cu``) for everything else: float32, whose
    1e-5 gates no tensor-core input type meets; decode (Tq = 1), where the
    SIMT kernel is load-bound; other head dims."""
    if (dtype == torch.bfloat16 and d % 16 == 0 and 16 <= d <= MAX_HEAD_DIM
            and tq >= 16 and aligned):
        return "tc"
    return "simt"


def flash_fwd_launch(route, q, k, v, causal, scale, kv_mask=None):
    """Launch the forward kernel of ``route`` (``"tc"`` or ``"simt"``) on
    the inputs ``flash_fwd_cuda`` takes; count nothing. Returns (o, lse).
    Raises on what the kernel does not take and on a launch error (the C
    entry of each kernel refuses what it cannot compute)."""
    b, h, tq, d = q.shape
    tk = k.shape[2]
    mask_ptr = _check_inputs(q, k, v, kv_mask)
    if route == "tc" and q.dtype != torch.bfloat16:
        raise TypeError(f"flash_fwd_tc takes bfloat16, not {q.dtype}")
    o = torch.empty_like(q)
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_ptr, o.data_ptr(),
            lse.data_ptr(), b * h, h, tq, tk, d, float(scale), int(causal))
    with torch.cuda.device(q.device):
        if route == "tc":
            err = _tc_lib().flash_fwd_tc(*args, _stream(q))
        elif route == "simt":
            err = _lib().flash_fwd(*args, _DTYPE_CODES[q.dtype], _stream(q))
        else:
            raise ValueError(f"no forward route {route!r}")
    if err != 0:
        name = "flash_fwd_tc" if route == "tc" else "flash_fwd"
        raise RuntimeError(f"{name} launch failed: cudaError_t {err}")
    return o, lse


def flash_fwd_cuda(q, k, v, causal, scale, kv_mask=None):
    """Launch the forward kernel that ``fwd_route`` picks for these
    tensors. q ``[B, H, Tq, D]``, k/v ``[B, H, Tk, D]``, contiguous CUDA
    tensors of one dtype (float32 or bfloat16), D <= 128; kv_mask
    ``[B, Tk]`` bool/uint8, contiguous. Returns (o, lse) as the plain
    version does and counts the launch in ``flash_attention.launches`` and
    in ``flash_fwd_cuda.tc_launches`` or ``.simt_launches``. Raises on what
    the kernel does not take and on a launch error."""
    aligned = all(t.data_ptr() % 16 == 0 for t in (q, k, v))
    route = fwd_route(q.dtype, q.shape[2], q.shape[3], aligned)
    o, lse = flash_fwd_launch(route, q, k, v, causal, scale, kv_mask)
    flash_attention.launches += 1
    if route == "tc":
        flash_fwd_cuda.tc_launches += 1
    else:
        flash_fwd_cuda.simt_launches += 1
    return o, lse


flash_fwd_cuda.tc_launches = 0
flash_fwd_cuda.simt_launches = 0


# -- backward ---------------------------------------------------------------


def flash_attention_bwd_reference(q, k, v, do, lse, dvec, causal=False,
                                  scale=None, kv_mask=None):
    """Plain version of the two backward kernels: the arithmetic of
    ``_flash_train_bwd`` (``paddle_tpu/kernels/attention.py:316``) written
    out. Scores of masked keys are the finite -1e30, p = exp(s - lse) with
    the forward's lse, ds = p * (dp - dvec) with dvec = sum_d(do * o).
    Returns (dq, dk, dv) in the input dtypes. A row whose keys are all
    masked has lse ~= -1e30 and so p = 1 for every key, as in the JAX
    kernels; training declares such rows unsupported."""
    d = q.shape[-1]
    tq, tk = q.shape[2], k.shape[2]
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    qs = q.float() * scale
    kf, vf, dof = k.float(), v.float(), do.float()
    s = torch.matmul(qs, kf.transpose(-1, -2))
    if causal:
        pos_q = torch.arange(tq, device=q.device)[:, None]
        pos_k = torch.arange(tk, device=q.device)[None, :]
        s = s.masked_fill(pos_q < pos_k, MASK_VALUE)
    if kv_mask is not None:
        s = s.masked_fill(~kv_mask.bool()[:, None, None, :], MASK_VALUE)
    p = torch.exp(s - lse[..., None])
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    ds = p * (dp - dvec[..., None])
    dq = torch.matmul(ds, kf) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qs)
    dv = torch.matmul(p.transpose(-1, -2), dof)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _bwd_lib():
    from paddle_tpu_torch.core import native_build
    lib = native_build.load("flash_bwd")
    if not getattr(lib, "_argtypes_set", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        tail = [i, i, i, i, i, ctypes.c_float, i, i, p]
        lib.flash_bwd_dq.argtypes = [p] * 8 + tail
        lib.flash_bwd_dq.restype = ctypes.c_int
        lib.flash_bwd_dkv.argtypes = [p] * 9 + tail
        lib.flash_bwd_dkv.restype = ctypes.c_int
        lib._argtypes_set = True
    return lib


def _bwd_operands(q, k, v, do, lse, dvec, kv_mask):
    b, h, tq, _ = q.shape
    rows = (b, h, tq)
    return _check_inputs(q, k, v, kv_mask, extra=(
        ("do", do, q.shape, None), ("lse", lse, rows, torch.float32),
        ("dvec", dvec, rows, torch.float32)))


def _bwd_tc_lib(name, n_ptrs):
    """The tensor-core backward library ``name``, whose C entry of the
    same name takes ``n_ptrs`` pointers, then the sizes, scale, causal
    flag and stream."""
    from paddle_tpu_torch.core import native_build
    lib = native_build.load(name)
    if not getattr(lib, "_argtypes_set", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        entry = getattr(lib, name)
        entry.argtypes = [p] * n_ptrs + [i] * 5 + [ctypes.c_float, i, p]
        entry.restype = ctypes.c_int
        lib._argtypes_set = True
    return lib


def bwd_route(dtype, d, aligned):
    """The dQ and the dK/dV kernel a CUDA call takes, by one fixed rule:
    ``"tc"`` (``csrc/flash_bwd_dq_tc.cu`` and ``csrc/flash_bwd_dkv_tc.cu``,
    wgmma) for bfloat16 with D a multiple of 16 in 16..64 and q, k, v and
    do at 16-byte aligned bases (``aligned``; the outputs, which the
    wrappers allocate, always are); ``"simt"`` (``csrc/flash_bwd.cu``) for
    everything else: float32, whose 1e-4 gates no tensor-core input type
    meets; D from 80 to 128, whose accumulators do not fit the tensor-core
    kernels' registers; other head dims."""
    if dtype == torch.bfloat16 and d % 16 == 0 and 16 <= d <= 64 and aligned:
        return "tc"
    return "simt"


def _bwd_route_of(q, k, v, do):
    aligned = all(t.data_ptr() % 16 == 0 for t in (q, k, v, do))
    return bwd_route(q.dtype, q.shape[3], aligned)


def _count(wrapper, route):
    wrapper.launches += 1
    if route == "tc":
        wrapper.tc_launches += 1
    else:
        wrapper.simt_launches += 1


def _bwd_launch(kernel, route, out_like, q, k, v, do, lse, dvec, causal,
                scale, kv_mask):
    """Launch backward kernel ``kernel`` (``"flash_bwd_dq"`` or
    ``"flash_bwd_dkv"``) of ``route`` into new tensors shaped as
    ``out_like``; count nothing. Returns the outputs. Raises on what the
    kernel does not take and on a launch error (each C entry refuses what
    it cannot compute)."""
    b, h, tq, d = q.shape
    mask_ptr = _bwd_operands(q, k, v, do, lse, dvec, kv_mask)
    if route == "tc" and q.dtype != torch.bfloat16:
        raise TypeError(f"{kernel}_tc takes bfloat16, not {q.dtype}")
    outs = tuple(torch.empty_like(t) for t in out_like)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), dvec.data_ptr(), mask_ptr,
            *(t.data_ptr() for t in outs), b * h, h, tq, k.shape[2], d,
            float(scale), int(causal))
    with torch.cuda.device(q.device):
        if route == "tc":
            name = f"{kernel}_tc"
            lib = _bwd_tc_lib(name, 7 + len(outs))
            err = getattr(lib, name)(*args, _stream(q))
        elif route == "simt":
            name = kernel
            err = getattr(_bwd_lib(), name)(*args, _DTYPE_CODES[q.dtype],
                                            _stream(q))
        else:
            raise ValueError(f"no {kernel} route {route!r}")
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError_t {err}")
    return outs


def flash_bwd_dq_launch(route, q, k, v, do, lse, dvec, causal, scale,
                        kv_mask=None):
    """Launch the dQ kernel of ``route`` (``"tc"`` or ``"simt"``) on the
    inputs ``flash_bwd_dq_cuda`` takes; count nothing. Returns dq. Raises
    as ``_bwd_launch`` does."""
    return _bwd_launch("flash_bwd_dq", route, (q,), q, k, v, do, lse, dvec,
                       causal, scale, kv_mask)[0]


def flash_bwd_dq_cuda(q, k, v, do, lse, dvec, causal, scale, kv_mask=None):
    """dQ of the attention whose forward gave ``lse``, for the output
    cotangent ``do`` (q's shape and dtype) and ``dvec = sum_d(do * o)``
    (float32 ``[B, H, Tq]``), from the dQ kernel that ``bwd_route`` picks.
    Inputs as ``flash_fwd_cuda`` takes them. Counts the launch in
    ``.launches`` and in ``.tc_launches`` or ``.simt_launches``; raises on
    what the kernel does not take and on a launch error."""
    route = _bwd_route_of(q, k, v, do)
    dq = flash_bwd_dq_launch(route, q, k, v, do, lse, dvec, causal, scale,
                             kv_mask)
    _count(flash_bwd_dq_cuda, route)
    return dq


def flash_bwd_dkv_launch(route, q, k, v, do, lse, dvec, causal, scale,
                         kv_mask=None):
    """Launch the dK/dV kernel of ``route`` (``"tc"`` or ``"simt"``) on the
    inputs ``flash_bwd_dkv_cuda`` takes; count nothing. Returns (dk, dv).
    Raises as ``_bwd_launch`` does."""
    return _bwd_launch("flash_bwd_dkv", route, (k, v), q, k, v, do, lse,
                       dvec, causal, scale, kv_mask)


def flash_bwd_dkv_cuda(q, k, v, do, lse, dvec, causal, scale, kv_mask=None):
    """(dK, dV) from the dK/dV kernel that ``bwd_route`` picks, with the
    inputs of ``flash_bwd_dq_cuda``. Counts the launch in ``.launches``
    and in ``.tc_launches`` or ``.simt_launches``."""
    route = _bwd_route_of(q, k, v, do)
    dk, dv = flash_bwd_dkv_launch(route, q, k, v, do, lse, dvec, causal,
                                  scale, kv_mask)
    _count(flash_bwd_dkv_cuda, route)
    return dk, dv


flash_bwd_dq_cuda.launches = 0
flash_bwd_dq_cuda.tc_launches = 0
flash_bwd_dq_cuda.simt_launches = 0
flash_bwd_dkv_cuda.launches = 0
flash_bwd_dkv_cuda.tc_launches = 0
flash_bwd_dkv_cuda.simt_launches = 0


def flash_attention_bwd(q, k, v, o, lse, do, causal, scale, kv_mask=None):
    """(dq, dk, dv) of the attention that gave (o, lse): dvec in float32,
    then the dQ kernel and the dK/dV kernel of its route on CUDA tensors,
    or their plain version on CPU tensors."""
    do = do.to(q.dtype).contiguous()
    dvec = torch.sum(do.float() * o.float(), dim=-1)
    if q.device.type == "cuda":
        dq = flash_bwd_dq_cuda(q, k, v, do, lse, dvec, causal, scale,
                               kv_mask)
        dk, dv = flash_bwd_dkv_cuda(q, k, v, do, lse, dvec, causal, scale,
                                    kv_mask)
        return dq, dk, dv
    return flash_attention_bwd_reference(q, k, v, do, lse, dvec, causal,
                                         scale, kv_mask)


# The trainable route is a dispatcher op, so that a selective-checkpoint
# policy can name it: under remat_policy="save_flash" its outputs (o, lse)
# are saved and the recompute of a layer returns them without a launch.

@torch.library.custom_op("paddle_tpu_torch::flash_attn", mutates_args=())
def flash_attn_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  kv_mask: Optional[torch.Tensor], causal: bool,
                  scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o, lse): the forward kernel on CUDA tensors, the plain version on
    CPU tensors."""
    if q.device.type == "cuda":
        return flash_fwd_cuda(q, k, v, causal, scale, kv_mask)
    return flash_attention_reference(q, k, v, causal, scale, kv_mask)


def _flash_setup_context(ctx, inputs, output):
    q, k, v, kv_mask, causal, scale = inputs
    o, lse = output
    ctx.mark_non_differentiable(lse)
    ctx.save_for_backward(q, k, v, kv_mask, o, lse)
    ctx.causal, ctx.scale = causal, scale


def _flash_backward(ctx, do, _dlse):
    q, k, v, kv_mask, o, lse = ctx.saved_tensors
    dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, ctx.causal,
                                     ctx.scale, kv_mask)
    return dq, dk, dv, None, None, None


flash_attn_op.register_autograd(_flash_backward,
                                setup_context=_flash_setup_context)


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
    if causal and tq != tk:
        return flash_attention_reference(q, k, v, causal, scale, kv_mask)[0]
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return flash_attn_op(q, k, v, kv_mask, causal, float(scale))[0]
    if q.device.type == "cuda":
        return flash_fwd_cuda(q, k, v, causal, scale, kv_mask)[0]
    return flash_attention_reference(q, k, v, causal, scale, kv_mask)[0]


flash_attention.launches = 0
