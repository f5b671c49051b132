"""Row LayerNorm over ``[N, D]``, forward only (counterpart of
``paddle_tpu/kernels/layer_norm.py``).

``fused_layer_norm(x, scale=None, bias=None, eps=1e-5)``: for each row the
float32 mean, the float32 variance of the centred row (two passes), then
``(x - mean) * rsqrt(var + eps) * scale + bias`` cast to x's dtype. x is
float32, bfloat16 or float16 of any ``[N, D]``; scale and bias ``[D]`` are
cast to float32, and a missing one stands for ones (scale) or zeros
(bias), as in the JAX function (``:35-38``).

On CUDA tensors every call launches ``csrc/layer_norm.cu`` (it replaces the
Pallas kernel that ``row_map`` builds, ``paddle_tpu/kernels/tiles.py:468``)
and counts it in ``fused_layer_norm.launches``; a failed build or launch
raises, nothing falls back. On CPU tensors the plain version
``fused_layer_norm_reference`` runs, the same formula in PyTorch.

The JAX function has no gradient: it has no custom VJP and ``pallas_call``
has no reverse-mode rule, so a JAX gradient through it fails to
linearize. Here it is an ``autograd.Function`` whose backward raises
``RuntimeError`` on either route; it computes no gradient.
"""

from __future__ import annotations

import ctypes

import torch

from paddle_tpu_torch.core.device import DEFAULT_DEVICE, resolve_device
from paddle_tpu_torch.kernels.tiles import check_operand

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def fused_layer_norm_reference(x, scale=None, bias=None, eps=1e-5):
    """Plain version: the kernel's formula in PyTorch, float32 inside, the
    result in x's dtype."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    xc = xf - mean
    var = (xc * xc).mean(dim=-1, keepdim=True)
    y = xc * torch.rsqrt(var + eps)
    if scale is not None:
        y = y * scale.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


def _lib():
    from paddle_tpu_torch.core import native_build
    lib = native_build.load("layer_norm")
    if not getattr(lib, "_argtypes_set", False):
        p = ctypes.c_void_p
        lib.layer_norm_fwd.argtypes = [p, p, p, p, ctypes.c_longlong,
                                       ctypes.c_int, ctypes.c_float,
                                       ctypes.c_int, ctypes.c_int, p]
        lib.layer_norm_fwd.restype = ctypes.c_int
        lib._argtypes_set = True
    return lib


def layer_norm_cuda(x, scale=None, bias=None, eps=1e-5):
    """Launch ``csrc/layer_norm.cu``: x a contiguous CUDA ``[N, D]`` tensor
    of float32, bfloat16 or float16; scale and bias float32 ``[D]`` on its
    device, or None. Returns y in x's dtype."""
    if x.dim() != 2:
        raise ValueError(f"x must be [N, D], not {tuple(x.shape)}")
    dev = x.device
    n, d = x.shape
    check_operand("x", x, (n, d), tuple(DTYPE_CODES), dev)
    for name, t in (("scale", scale), ("bias", bias)):
        if t is not None:
            check_operand(name, t, (d,), (torch.float32,), dev)
    y = torch.empty_like(x)
    vec = 16 // x.element_size()
    if d % vec or any(t.data_ptr() % 16 for t in (x, y, scale, bias)
                      if t is not None):
        vec = 1
    with torch.cuda.device(dev):
        err = _lib().layer_norm_fwd(
            x.data_ptr(), None if scale is None else scale.data_ptr(),
            None if bias is None else bias.data_ptr(), y.data_ptr(), n, d,
            float(eps), DTYPE_CODES[x.dtype], vec,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"layer_norm launch failed: cudaError_t {err}")
    fused_layer_norm.launches += 1
    return y


class _FusedLayerNorm(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        fn = (layer_norm_cuda if x.device.type == "cuda"
              else fused_layer_norm_reference)
        return fn(x, scale, bias, eps)

    @staticmethod
    def backward(ctx, g):
        raise RuntimeError(
            "fused_layer_norm has no gradient: the reference kernel "
            "(paddle_tpu/kernels/layer_norm.py) defines none; take "
            "layer_norm with use_pallas=False to train")


def fused_layer_norm(x, scale=None, bias=None, eps=1e-5, block_rows=256,
                     device=DEFAULT_DEVICE):
    """x ``[N, D]``; scale/bias ``[D]`` or None. Returns y ``[N, D]`` in x's
    dtype.

    ``device`` is where the caller means to run: the default ``"cuda"``
    raises where no card is present, and x must lie on that device type.
    ``block_rows`` is the TPU kernel's row-block size; it is accepted so
    that callers written against the JAX signature work, and ignored (the
    CUDA kernel gives each row a warp)."""
    del block_rows
    if resolve_device(device).type != x.device.type:
        raise ValueError(f"x lies on {x.device}, device is {device}")
    if x.dim() != 2:
        raise ValueError(f"x must be [N, D], not {tuple(x.shape)}")
    scale, bias = (None if t is None else t.to(x.device, torch.float32)
                   .contiguous() for t in (scale, bias))
    return _FusedLayerNorm.apply(x.contiguous(), scale, bias, float(eps))


fused_layer_norm.launches = 0
