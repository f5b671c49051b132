"""Embedding lookup fused with a sequence pool (counterpart of
``paddle_tpu/kernels/embedding_pool.py``).

``embedding_seqpool(ids, table, mean=False)``: ids [B, S] int, table
[V, D] float32 or bfloat16 -> pooled [B, D] in the table's dtype, the sum
(or mean) over S of the rows the ids name, summed in float32. It is an
``autograd.Function`` with respect to the table. The ids are clamped to
``[0, V-1]`` once, before dispatch, and again in the backward, as the JAX
function clamps them (``:66``, ``:148``): an out-of-range id reads, and
takes the gradient of, the edge row.

On CUDA tensors every call launches ``csrc/seqpool.cu`` (it replaces the
Pallas ``_seqpool_kernel``) and counts it in ``seqpool.launches``; a
failed build or launch raises. On CPU tensors the plain version
``seqpool_reference`` runs: ``table[ids]`` summed in float32, divided by S
for the mean, cast to the table's dtype (the JAX ``_seqpool_xla``).

Routing differs from the JAX function on purpose. There, a call takes the
Pallas kernel only when ``d % 128 == 0 and b * s <= 32768`` (else XLA's
gather): Mosaic's 128-lane rows and a timing on a TPU, facts of that chip.
Here a CUDA tensor always takes the kernel; ``chip_smoke.py`` times it
against ``F.embedding_bag`` at the classifier's shape and at a large table
so that a rule for this card can be chosen from its own numbers.

The backward is not a kernel in either package: the JAX function's
scatter-add of the repeated (for the mean, divided by S) float32 cotangent
is ``index_add_`` here, into a float32 table cast to the table's dtype.
The JAX function's ``block_samples`` (a TPU tiling choice) is not ported.
"""

from __future__ import annotations

import ctypes

import torch

from paddle_tpu_torch.kernels.tiles import DTYPE_CODES, check_operand


def _clamp(ids, v):
    return ids.clamp(0, v - 1)


def seqpool_reference(ids, table, mean=False):
    """Plain version of ``seqpool``: ``table[ids]`` summed over S in
    float32, divided by S for the mean, in the table's dtype."""
    pooled = table[_clamp(ids, table.shape[0]).long()].float().sum(1)
    if mean:
        pooled = pooled / ids.shape[1]
    return pooled.to(table.dtype)


def _lib():
    from paddle_tpu_torch.core import native_build
    lib = native_build.load("seqpool")
    if not getattr(lib, "_argtypes_set", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.seqpool.argtypes = [p, p, p, i, i, i, i, i, i, i, p]
        lib.seqpool.restype = ctypes.c_int
        lib._argtypes_set = True
    return lib


def seqpool_cuda(ids, table, mean=False):
    """Launch ``csrc/seqpool.cu``: ids [B, S] int32 and table [V, D]
    float32/bfloat16, contiguous CUDA tensors on one device; returns
    [B, D] in the table's dtype."""
    dev = table.device
    b, s = ids.shape
    v, d = table.shape
    check_operand("ids", ids, (b, s), (torch.int32,), dev)
    check_operand("table", table, (v, d), tuple(DTYPE_CODES), dev)
    out = torch.empty((b, d), dtype=table.dtype, device=dev)
    vec = 16 // table.element_size()
    if d % vec or table.data_ptr() % 16 or out.data_ptr() % 16:
        vec = 1
    with torch.cuda.device(dev):
        err = _lib().seqpool(
            ids.data_ptr(), table.data_ptr(), out.data_ptr(), b, s, v, d,
            int(mean), DTYPE_CODES[table.dtype], vec,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"seqpool launch failed: cudaError_t {err}")
    seqpool.launches += 1
    return out


def seqpool(ids, table, mean=False):
    """The kernel on CUDA tensors, the plain version on CPU tensors."""
    fn = seqpool_cuda if table.device.type == "cuda" else seqpool_reference
    return fn(ids, table, mean)


seqpool.launches = 0


def seqpool_grad(ids, g, table_shape, table_dtype, mean=False):
    """The table's gradient: the float32 cotangent (divided by S for the
    mean) of each sample added to the row of each of its ids, the ids
    clamped as in the forward; cast to ``table_dtype``."""
    b, s = ids.shape
    g32 = g.float()
    if mean:
        g32 = g32 / s
    rows = torch.repeat_interleave(g32, s, dim=0)          # [B*S, D]
    dtable = torch.zeros(table_shape, dtype=torch.float32, device=g.device)
    dtable.index_add_(0, _clamp(ids.reshape(-1), table_shape[0]).long(),
                      rows)
    return dtable.to(table_dtype)


class _EmbeddingSeqpool(torch.autograd.Function):

    @staticmethod
    def forward(ctx, ids, table, mean):
        out = seqpool(ids, table, mean)
        ctx.save_for_backward(ids)
        ctx.cfg = (tuple(table.shape), table.dtype, mean)
        return out

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        shape, dtype, mean = ctx.cfg
        return None, seqpool_grad(ids, g, shape, dtype, mean), None


def embedding_seqpool(ids, table, mean=False):
    """ids [B, S] int, table [V, D] -> pooled [B, D] (sum, or the mean
    over S), differentiable with respect to the table."""
    if ids.dim() != 2 or table.dim() != 2:
        raise ValueError(f"ids must be [B, S] and table [V, D], not "
                         f"{tuple(ids.shape)} and {tuple(table.shape)}")
    ids = _clamp(ids, table.shape[0]).to(torch.int32).contiguous()
    return _EmbeddingSeqpool.apply(ids, table.contiguous(), bool(mean))
