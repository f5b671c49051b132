"""Card-only tests of the port's CUDA kernels (marker ``gpu``): the flash
forward, dQ and dK/dV backward (both routes of each, the SIMT kernel and
the tensor-core kernel, and the rules that pick one), the fused optimizer
update, the conv kernels (the 3x3 forward's and weight gradient's two
routes each, the 3x3 dx's and the 1x1 GEMM's three, and the rules that
pick one among them; the dx's phase entry on its own), the
fused max pool, the embedding seqpool and the row LayerNorm
against their plain versions, and the kernel launches of a tiny BERT
step.

They skip where no CUDA device is present. This file imports neither JAX
nor the JAX package, so it also runs on a GPU machine without JAX:

    python3 -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_gpu.py

Tolerances of the forward: float32 o within 1e-5 of the plain version
(same float32 function, another summation order); bfloat16 o within 1e-2
relative (one bf16 rounding step of an output that differs in float32 by
~1e-7); lse within 1e-5 relative in both. The backward's and the fused
update's are stated beside their tests.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from paddle_tpu_torch.kernels import attention as port

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# (name, b, h, tq, tk, d, causal, masked): the serving path's shapes
# (encoder 64x8x64x64, decode Tq=1), a causal case and ragged edges
SHAPES = [
    ("encoder", 64, 8, 64, 64, 64, False, True),
    ("decode", 64, 8, 1, 64, 64, False, True),
    ("causal", 2, 3, 40, 40, 16, True, False),
    ("ragged", 3, 2, 5, 70, 100, False, True),
    ("d128", 2, 2, 17, 33, 128, False, False),
]


def _inputs(dev, dtype, b, h, tq, tk, d, masked):
    g = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn(b, h, t, d, device=dev, generator=g).to(dtype)
               for t in (tq, tk, tk))
    m = None
    if masked:
        m = torch.rand(b, tk, device=dev, generator=g) > 0.3
        m[0] = False     # a fully masked row
    return q, k, v, m


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", SHAPES, ids=[s[0] for s in SHAPES])
def test_kernel_matches_plain_version(cuda, shape, dtype):
    _, b, h, tq, tk, d, causal, masked = shape
    q, k, v, m = _inputs(cuda, dtype, b, h, tq, tk, d, masked)
    before = port.flash_attention.launches
    o, lse = port.flash_fwd_cuda(q, k, v, causal, d ** -0.5, m)
    torch.cuda.synchronize()
    assert port.flash_attention.launches == before + 1
    ro, rl = port.flash_attention_reference(q, k, v, causal, d ** -0.5, m)
    assert o.dtype == dtype and lse.dtype == torch.float32
    assert torch.isfinite(o).all() and torch.isfinite(lse).all()
    err = ((o.float() - ro.float()).abs() / (1 + ro.float().abs())).max()
    assert err.item() < (1e-5 if dtype == torch.float32 else 1e-2)
    rel = ((lse - rl).abs() / rl.abs().clamp(min=1)).max()
    assert rel.item() < 1e-5
    if masked:   # the fully masked row: uniform mean of V
        np.testing.assert_allclose(
            o[0].float().cpu().numpy(),
            v[0].float().mean(dim=1, keepdim=True).expand_as(o[0])
            .to(dtype).float().cpu().numpy(), rtol=1e-2, atol=1e-5)


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    q = torch.randn(1, 1, 4, 8, device=cuda)
    with pytest.raises(ValueError):
        port.flash_fwd_cuda(q.transpose(2, 3), q.transpose(2, 3),
                            q.transpose(2, 3), False, 1.0)
    big = torch.randn(1, 1, 4, 160, device=cuda)
    with pytest.raises(ValueError):
        port.flash_fwd_cuda(big, big, big, False, 1.0)
    with pytest.raises(TypeError):
        port.flash_fwd_cuda(q, q.half(), q, False, 1.0)
    with pytest.raises(TypeError):
        port.flash_fwd_cuda(q.half(), q.half(), q.half(), False, 1.0)
    with pytest.raises(ValueError):      # a CUDA tensor, device="cpu"
        port.flash_attention(q, q, q, device="cpu")


# -- the tensor-core forward (csrc/flash_fwd_tc.cu) ---------------------------

# (name, b, h, tq, tk, d, causal, masked): BERT-base's and the serving
# encoder's shapes with padding (row 0 all masked), causal without a mask
# (the tile skip), a ragged Tk and Tq, and D = 128
TC_SHAPES = [
    ("bert", 32, 12, 128, 128, 64, False, True),
    ("encoder", 64, 8, 64, 64, 64, False, True),
    ("causal_512", 2, 8, 512, 512, 64, True, False),
    ("causal_masked", 2, 3, 100, 100, 32, True, True),
    ("ragged_tk", 3, 4, 200, 300, 64, False, True),
    ("d128", 2, 4, 256, 256, 128, False, True),
]


def _routes():
    return port.flash_fwd_cuda.tc_launches, port.flash_fwd_cuda.simt_launches


@pytest.mark.parametrize("shape", TC_SHAPES, ids=[s[0] for s in TC_SHAPES])
def test_tc_route_matches_plain_version(cuda, shape):
    _, b, h, tq, tk, d, causal, masked = shape
    q, k, v, m = _inputs(cuda, torch.bfloat16, b, h, tq, tk, d, masked)
    tc, simt = _routes()
    o, lse = port.flash_fwd_cuda(q, k, v, causal, d ** -0.5, m)
    torch.cuda.synchronize()
    assert _routes() == (tc + 1, simt)
    ro, rl = port.flash_attention_reference(q, k, v, causal, d ** -0.5, m)
    assert torch.isfinite(o).all() and torch.isfinite(lse).all()
    err = ((o.float() - ro.float()).abs() / (1 + ro.float().abs())).max()
    assert err.item() < 1e-2
    rel = ((lse - rl).abs() / rl.abs().clamp(min=1)).max()
    assert rel.item() < 1e-5
    if masked:   # the fully masked row: uniform mean of V, lse ~ -1e30
        np.testing.assert_allclose(
            o[0].float().cpu().numpy(),
            v[0].float().mean(dim=1, keepdim=True).expand_as(o[0])
            .to(torch.bfloat16).float().cpu().numpy(), rtol=1e-2, atol=1e-5)
        assert (lse[0] < -1e29).all()


def test_route_counters_follow_the_rule(cuda):
    """bf16 at D % 16 == 0 and Tq >= 16 on aligned inputs takes the tensor
    cores; float32, decode, D = 100 and a base off 16 bytes the SIMT
    kernel. Every launch also counts in ``flash_attention.launches``."""
    bf = torch.bfloat16
    buf = torch.randn(1 + 2 * 1 * 32 * 64, device=cuda).to(bf)
    off = buf[1:].view(2, 1, 32, 64)           # 2 bytes past an aligned base
    cases = [
        (_inputs(cuda, bf, 2, 2, 16, 16, 64, False), "tc"),
        (_inputs(cuda, torch.float32, 2, 2, 64, 64, 64, False), "simt"),
        (_inputs(cuda, bf, 2, 2, 1, 64, 64, True), "simt"),
        (_inputs(cuda, bf, 2, 2, 32, 32, 100, False), "simt"),
        ((off, off, off, None), "simt"),
    ]
    for (q, k, v, m), route in cases:
        tc, simt = _routes()
        n = port.flash_attention.launches
        o, lse = port.flash_fwd_cuda(q, k, v, False, 0.125, m)
        torch.cuda.synchronize()
        assert _routes() == ((tc + 1, simt) if route == "tc"
                             else (tc, simt + 1)), (q.shape, q.dtype)
        assert port.flash_attention.launches == n + 1
        ro, rl = port.flash_attention_reference(q, k, v, False, 0.125, m)
        tol = 1e-5 if q.dtype == torch.float32 else 1e-2
        assert ((o.float() - ro.float()).abs()
                / (1 + ro.float().abs())).max().item() < tol


def test_tc_launch_raises_and_never_falls_back(cuda):
    """The tensor-core kernel's C entry refuses what it cannot compute (a
    base off 16 bytes, D not a multiple of 16) and its wrapper what is not
    bf16: the launch raises, and no other kernel or plain version runs in
    its place."""
    bf = torch.bfloat16
    buf = torch.randn(1 + 32 * 64, device=cuda).to(bf)
    off = buf[1:].view(1, 1, 32, 64)
    q8 = torch.randn(1, 1, 32, 8, device=cuda).to(bf)
    before = _routes(), port.flash_attention.launches
    for q in (off, q8):
        with pytest.raises(RuntimeError, match="flash_fwd_tc launch failed"):
            port.flash_fwd_launch("tc", q, q, q, False, 0.125)
    with pytest.raises(ValueError):
        port.flash_fwd_launch("wgmma", q8, q8, q8, False, 0.125)
    f32 = torch.randn(1, 1, 32, 64, device=cuda)
    with pytest.raises(TypeError):
        port.flash_fwd_launch("tc", f32, f32, f32, False, 0.125)
    assert (_routes(), port.flash_attention.launches) == before


def test_tiny_model_tokens_equal_with_and_without_kernel(cuda):
    from paddle_tpu_torch.inference import GenerationConfig, Generator
    from paddle_tpu_torch.models import Transformer, TransformerConfig
    src = np.random.RandomState(1).randint(3, 100, (3, 7)).astype(np.int32)
    src[2, 4:] = 0
    out = {}
    for use_flash in (False, True):
        model = Transformer(TransformerConfig.tiny(
            n_layer=2, dropout=0.0, use_flash=use_flash), device=cuda,
            seed=3)
        gen = Generator(model, GenerationConfig(
            max_len=12, batch_buckets=(4,), src_len_buckets=(8,)),
            device=cuda)
        before = port.flash_attention.launches
        out[use_flash] = gen.generate(src)
        launched = port.flash_attention.launches - before
        if use_flash:   # 2 encoder layers + 2 x 2 per decode step
            assert launched > 2 and (launched - 2) % 4 == 0
        else:
            assert launched == 0
    np.testing.assert_array_equal(out[True], out[False])


# -- flash backward (csrc/flash_bwd.cu) ---------------------------------------
#
# Tolerance: float32 dq/dk/dv within 1e-4 of the plain version relative to
# (1 + |plain|): the same float32 function summed over up to Tk (dq) or Tq
# (dk, dv) terms in another order; bfloat16 within 2e-2 (the inputs and
# outputs are bfloat16, the sums float32 on both sides).

# (name, b, h, tq, tk, d, causal, masked)
BWD_SHAPES = [
    ("square", 2, 4, 128, 128, 64, False, False),
    ("masked", 3, 2, 50, 70, 64, False, True),
    ("causal", 2, 3, 96, 96, 64, True, False),
    ("causal_ragged", 2, 2, 40, 40, 16, True, True),
    ("d100", 2, 2, 17, 33, 100, False, True),
    ("d128", 1, 2, 33, 65, 128, False, False),
]


def _bwd_inputs(dev, dtype, b, h, tq, tk, d, causal, masked):
    q, k, v, _ = _inputs(dev, dtype, b, h, tq, tk, d, False)
    g = torch.Generator(device=dev).manual_seed(1)
    m = None
    if masked:   # every row keeps at least one key: training has no all-pad
        m = torch.rand(b, tk, device=dev, generator=g) > 0.3
        m[:, 0] = True
    do = torch.randn(b, h, tq, d, device=dev, generator=g).to(dtype)
    o, lse = port.flash_fwd_cuda(q, k, v, causal, d ** -0.5, m)
    dvec = (do.float() * o.float()).sum(-1)
    return q, k, v, m, do, lse, dvec


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", BWD_SHAPES, ids=[s[0] for s in BWD_SHAPES])
def test_bwd_kernels_match_plain_version(cuda, shape, dtype):
    _, b, h, tq, tk, d, causal, masked = shape
    q, k, v, m, do, lse, dvec = _bwd_inputs(cuda, dtype, b, h, tq, tk, d,
                                            causal, masked)
    n_dq = port.flash_bwd_dq_cuda.launches
    n_dkv = port.flash_bwd_dkv_cuda.launches
    dq = port.flash_bwd_dq_cuda(q, k, v, do, lse, dvec, causal, d ** -0.5, m)
    dk, dv = port.flash_bwd_dkv_cuda(q, k, v, do, lse, dvec, causal,
                                     d ** -0.5, m)
    torch.cuda.synchronize()
    assert port.flash_bwd_dq_cuda.launches == n_dq + 1
    assert port.flash_bwd_dkv_cuda.launches == n_dkv + 1
    want = port.flash_attention_bwd_reference(q, k, v, do, lse, dvec, causal,
                                              d ** -0.5, m)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for name, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        assert got.dtype == dtype and got.shape == ref.shape
        assert torch.isfinite(got).all(), name
        err = ((got.float() - ref.float()).abs()
               / (1 + ref.float().abs())).max().item()
        assert err < tol, (name, err)


def test_autograd_route_launches_both_bwd_kernels(cuda):
    q, k, v, m, do, _, _ = _bwd_inputs(cuda, torch.float32, 2, 2, 32, 32, 64,
                                       False, True)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    n = (port.flash_attention.launches, port.flash_bwd_dq_cuda.launches,
         port.flash_bwd_dkv_cuda.launches)
    o = port.flash_attention(*leaves, kv_mask=m, device=cuda)
    grads = torch.autograd.grad(o, leaves, do)
    torch.cuda.synchronize()
    assert (port.flash_attention.launches, port.flash_bwd_dq_cuda.launches,
            port.flash_bwd_dkv_cuda.launches) == (n[0] + 1, n[1] + 1,
                                                  n[2] + 1)
    plain = [t.clone().requires_grad_() for t in (q, k, v)]
    ro = port.flash_attention_reference(*plain, False, None, m)[0]
    want = torch.autograd.grad(ro, plain, do)
    for got, ref in zip(grads, want):
        assert (got - ref).abs().max().item() < 1e-4


# -- the tensor-core dK/dV (csrc/flash_bwd_dkv_tc.cu) --------------------------
#
# Tolerance: within 2e-2 of the plain version relative to (1 + |plain|), as
# the SIMT kernel in bf16: P is rounded to bf16 before its product (one
# rounding, 2^-9 relative, of terms summed in float32), dS is split into
# two bf16 terms, and dk and dv are rounded to bf16 once.

# (name, b, h, tq, tk, d, causal, masked): Tq and Tk off the 64-row tiles,
# causal without a mask (query tiles skipped) and with one (none skipped),
# D = 16, 32 and 64, one query row; every row keeps a key (``_bwd_inputs``)
DKV_TC_SHAPES = [
    ("ragged", 3, 2, 100, 150, 64, False, True),
    ("causal", 2, 3, 200, 200, 64, True, False),
    ("causal_masked", 2, 3, 130, 130, 32, True, True),
    ("d16", 2, 2, 70, 90, 16, False, False),
    ("square", 2, 4, 256, 256, 64, False, False),
    ("one_query", 2, 2, 1, 70, 32, False, True),
]


def _dkv_routes():
    return (port.flash_bwd_dkv_cuda.tc_launches,
            port.flash_bwd_dkv_cuda.simt_launches)


def _dkv_err(got, ref):
    return ((got.float() - ref.float()).abs()
            / (1 + ref.float().abs())).max().item()


@pytest.mark.parametrize("shape", DKV_TC_SHAPES,
                         ids=[s[0] for s in DKV_TC_SHAPES])
def test_dkv_tc_route_matches_plain_version(cuda, shape):
    _, b, h, tq, tk, d, causal, masked = shape
    q, k, v, m, do, lse, dvec = _bwd_inputs(cuda, torch.bfloat16, b, h, tq,
                                            tk, d, causal, masked)
    tc, simt = _dkv_routes()
    dk, dv = port.flash_bwd_dkv_cuda(q, k, v, do, lse, dvec, causal,
                                     d ** -0.5, m)
    torch.cuda.synchronize()
    assert _dkv_routes() == (tc + 1, simt)
    _, rdk, rdv = port.flash_attention_bwd_reference(q, k, v, do, lse, dvec,
                                                     causal, d ** -0.5, m)
    for name, got, ref in (("dk", dk, rdk), ("dv", dv, rdv)):
        assert got.dtype == torch.bfloat16 and got.shape == ref.shape
        assert torch.isfinite(got).all(), name
        assert _dkv_err(got, ref) < 2e-2, (name, _dkv_err(got, ref))


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_dkv_tc_fully_masked_rows_match_plain_version(cuda, causal):
    """Batch entry 0's kv mask keeps no key: each of its rows scores -1e30
    on every key and has lse ~= -1e30, so p = 1 on every key there, in the
    kernel as in the plain version, and dS = dP - dvec is not damped by a
    small p. Held to the gate of the other shapes."""
    b, h, tq, tk, d = 2, 2, 130, 150, 64
    q, k, v, m = _inputs(cuda, torch.bfloat16, b, h, tq, tk, d, True)
    g = torch.Generator(device=cuda).manual_seed(1)
    do = torch.randn(b, h, tq, d, device=cuda, generator=g).to(q.dtype)
    o, lse = port.flash_fwd_cuda(q, k, v, causal, d ** -0.5, m)
    dvec = (do.float() * o.float()).sum(-1)
    assert not m[0].any() and (lse[0] < -1e29).all()
    tc, simt = _dkv_routes()
    dk, dv = port.flash_bwd_dkv_cuda(q, k, v, do, lse, dvec, causal,
                                     d ** -0.5, m)
    torch.cuda.synchronize()
    assert _dkv_routes() == (tc + 1, simt)
    _, rdk, rdv = port.flash_attention_bwd_reference(q, k, v, do, lse, dvec,
                                                     causal, d ** -0.5, m)
    for name, got, ref in (("dk", dk, rdk), ("dv", dv, rdv)):
        assert torch.isfinite(got).all(), name
        assert _dkv_err(got, ref) < 2e-2, (name, _dkv_err(got, ref))


def test_dkv_route_counters_follow_the_rule(cuda):
    """bf16 at D a multiple of 16 in 16..64 on aligned inputs takes the
    tensor cores; float32, D = 128, D = 100 and a base off 16 bytes the
    SIMT kernel. Every launch also counts in ``.launches``."""
    bf = torch.bfloat16
    cases = [((bf, 64), "tc"), ((bf, 16), "tc"),
             ((torch.float32, 64), "simt"), ((bf, 128), "simt"),
             ((bf, 100), "simt")]
    for (dtype, d), route in cases:
        q, k, v, m, do, lse, dvec = _bwd_inputs(cuda, dtype, 2, 2, 40, 70, d,
                                                False, True)
        before, n = _dkv_routes(), port.flash_bwd_dkv_cuda.launches
        dk, dv = port.flash_bwd_dkv_cuda(q, k, v, do, lse, dvec, False, 0.125,
                                         m)
        torch.cuda.synchronize()
        assert _dkv_routes() == ((before[0] + 1, before[1]) if route == "tc"
                                 else (before[0], before[1] + 1)), (dtype, d)
        assert port.flash_bwd_dkv_cuda.launches == n + 1
        _, rdk, rdv = port.flash_attention_bwd_reference(
            q, k, v, do, lse, dvec, False, 0.125, m)
        tol = 1e-4 if dtype == torch.float32 else 2e-2
        assert max(_dkv_err(dk, rdk), _dkv_err(dv, rdv)) < tol
    # do 2 bytes past an aligned base: the SIMT kernel
    q, k, v, m, do, lse, dvec = _bwd_inputs(cuda, bf, 1, 1, 32, 32, 64, False,
                                            False)
    buf = torch.empty(1 + do.numel(), device=cuda, dtype=bf)
    off = buf[1:].view(do.shape)
    off.copy_(do)
    before = _dkv_routes()
    port.flash_bwd_dkv_cuda(q, k, v, off, lse, dvec, False, 0.125)
    torch.cuda.synchronize()
    assert _dkv_routes() == (before[0], before[1] + 1)


def test_dkv_tc_launch_raises_and_never_falls_back(cuda):
    """The tensor-core dK/dV's C entry refuses what it cannot compute (D =
    128, a base off 16 bytes) and its wrapper what is not bf16: the launch
    raises, and no other kernel or plain version runs in its place."""
    bf = torch.bfloat16
    before = _dkv_routes(), port.flash_bwd_dkv_cuda.launches
    q, k, v, _, do, lse, dvec = _bwd_inputs(cuda, bf, 1, 2, 32, 32, 128,
                                            False, False)
    with pytest.raises(RuntimeError, match="flash_bwd_dkv_tc launch failed"):
        port.flash_bwd_dkv_launch("tc", q, k, v, do, lse, dvec, False, 0.125)
    q, k, v, _, do, lse, dvec = _bwd_inputs(cuda, bf, 1, 1, 32, 32, 64,
                                            False, False)
    buf = torch.empty(1 + q.numel(), device=cuda, dtype=bf)
    off = buf[1:].view(q.shape)
    with pytest.raises(RuntimeError, match="flash_bwd_dkv_tc launch failed"):
        port.flash_bwd_dkv_launch("tc", off, k, v, do, lse, dvec, False,
                                  0.125)
    with pytest.raises(ValueError):
        port.flash_bwd_dkv_launch("wgmma", q, k, v, do, lse, dvec, False,
                                  0.125)
    f = [t.float() for t in (q, k, v, do)]
    with pytest.raises(TypeError):
        port.flash_bwd_dkv_launch("tc", *f, lse, dvec, False, 0.125)
    torch.cuda.synchronize()
    assert (_dkv_routes(), port.flash_bwd_dkv_cuda.launches) == before


# -- the tensor-core dQ (csrc/flash_bwd_dq_tc.cu) -----------------------------
#
# Tolerance: chip_smoke.py's T1 gates, unchanged: within BWD_TOLERANCE (bf16
# 2e-2) of the plain version relative to (1 + |plain|), and within
# BWD_SCALED_TOLERANCE (bf16 1.5e-2) of max|plain|. dS is split into two
# bf16 terms, so the products lose no more than the bf16 inputs carry, and
# dq is rounded to bf16 once.

# T1's backward shapes with D <= 64: the training path's, BERT's, ragged
# Tq and Tk, causal with and without a kv mask, D = 16 and 32, and a batch
# entry whose keys are all masked
DQ_TC_SHAPES = [s for s in chip_smoke.BWD_CHECK_SHAPES if s[5] <= 64]


def _dq_routes():
    return (port.flash_bwd_dq_cuda.tc_launches,
            port.flash_bwd_dq_cuda.simt_launches)


@pytest.mark.parametrize("shape", DQ_TC_SHAPES,
                         ids=[s[0] for s in DQ_TC_SHAPES])
def test_dq_tc_route_matches_plain_version(cuda, shape):
    q, k, v, m, do, _, lse, dvec = chip_smoke.bwd_inputs(
        shape, torch.bfloat16, cuda, 0)
    causal, scale = shape[6], shape[5] ** -0.5
    tc, simt = _dq_routes()
    dq = port.flash_bwd_dq_cuda(q, k, v, do, lse, dvec, causal, scale, m)
    torch.cuda.synchronize()
    assert _dq_routes() == (tc + 1, simt)
    ref = port.flash_attention_bwd_reference(q, k, v, do, lse, dvec, causal,
                                             scale, m)[0]
    assert dq.dtype == torch.bfloat16 and dq.shape == ref.shape
    assert torch.isfinite(dq).all()
    err = chip_smoke.bwd_errors(dq, ref)
    assert chip_smoke.bwd_within(err, torch.bfloat16), err


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_dq_tc_fully_masked_rows_match_plain_version(cuda, causal):
    """Batch entry 0's kv mask keeps no key: each of its rows scores -1e30
    on every key and has lse ~= -1e30, so p = 1 on every key there, in the
    kernel as in the plain version, and dS = dP - dvec is not damped by a
    small p. Held to BWD_TOLERANCE, as the other shapes."""
    b, h, tq, tk, d = 2, 2, 130, 150, 64
    q, k, v, m = _inputs(cuda, torch.bfloat16, b, h, tq, tk, d, True)
    g = torch.Generator(device=cuda).manual_seed(1)
    do = torch.randn(b, h, tq, d, device=cuda, generator=g).to(q.dtype)
    o, lse = port.flash_fwd_cuda(q, k, v, causal, d ** -0.5, m)
    dvec = (do.float() * o.float()).sum(-1)
    assert not m[0].any() and (lse[0] < -1e29).all()
    tc, simt = _dq_routes()
    dq = port.flash_bwd_dq_cuda(q, k, v, do, lse, dvec, causal, d ** -0.5, m)
    torch.cuda.synchronize()
    assert _dq_routes() == (tc + 1, simt)
    ref = port.flash_attention_bwd_reference(q, k, v, do, lse, dvec, causal,
                                             d ** -0.5, m)[0]
    assert torch.isfinite(dq).all()
    err = chip_smoke.bwd_errors(dq, ref)["rel_err"]
    assert err < chip_smoke.BWD_TOLERANCE[torch.bfloat16], err


def test_dq_route_counters_follow_the_rule(cuda):
    """bf16 at D a multiple of 16 in 16..64 on aligned inputs takes the
    tensor cores; float32, D = 128, D = 100 and a base off 16 bytes the
    SIMT kernel. Every launch also counts in ``.launches``."""
    bf = torch.bfloat16
    cases = [((bf, 64), "tc"), ((bf, 16), "tc"), ((bf, 48), "tc"),
             ((torch.float32, 64), "simt"), ((bf, 128), "simt"),
             ((bf, 100), "simt")]
    for (dtype, d), route in cases:
        q, k, v, m, do, lse, dvec = _bwd_inputs(cuda, dtype, 2, 2, 40, 70, d,
                                                False, True)
        before, n = _dq_routes(), port.flash_bwd_dq_cuda.launches
        dq = port.flash_bwd_dq_cuda(q, k, v, do, lse, dvec, False, 0.125, m)
        torch.cuda.synchronize()
        assert _dq_routes() == ((before[0] + 1, before[1]) if route == "tc"
                                else (before[0], before[1] + 1)), (dtype, d)
        assert port.flash_bwd_dq_cuda.launches == n + 1
        ref = port.flash_attention_bwd_reference(q, k, v, do, lse, dvec,
                                                 False, 0.125, m)[0]
        err = chip_smoke.bwd_errors(dq, ref)["rel_err"]
        assert err < chip_smoke.BWD_TOLERANCE[dtype], (dtype, d, err)
    # do 2 bytes past an aligned base: the SIMT kernel
    q, k, v, m, do, lse, dvec = _bwd_inputs(cuda, bf, 1, 1, 32, 32, 64, False,
                                            False)
    buf = torch.empty(1 + do.numel(), device=cuda, dtype=bf)
    off = buf[1:].view(do.shape)
    off.copy_(do)
    before = _dq_routes()
    port.flash_bwd_dq_cuda(q, k, v, off, lse, dvec, False, 0.125)
    torch.cuda.synchronize()
    assert _dq_routes() == (before[0], before[1] + 1)


def test_dq_tc_launch_raises_and_never_falls_back(cuda):
    """The tensor-core dQ's C entry refuses what it cannot compute (D =
    128, a base off 16 bytes) and its wrapper what is not bf16: the launch
    raises, and no other kernel or plain version runs in its place."""
    bf = torch.bfloat16
    before = _dq_routes(), port.flash_bwd_dq_cuda.launches
    q, k, v, _, do, lse, dvec = _bwd_inputs(cuda, bf, 1, 2, 32, 32, 128,
                                            False, False)
    with pytest.raises(RuntimeError, match="flash_bwd_dq_tc launch failed"):
        port.flash_bwd_dq_launch("tc", q, k, v, do, lse, dvec, False, 0.125)
    q, k, v, _, do, lse, dvec = _bwd_inputs(cuda, bf, 1, 1, 32, 32, 64,
                                            False, False)
    buf = torch.empty(1 + q.numel(), device=cuda, dtype=bf)
    off = buf[1:].view(q.shape)
    with pytest.raises(RuntimeError, match="flash_bwd_dq_tc launch failed"):
        port.flash_bwd_dq_launch("tc", off, k, v, do, lse, dvec, False,
                                 0.125)
    with pytest.raises(ValueError):
        port.flash_bwd_dq_launch("wgmma", q, k, v, do, lse, dvec, False,
                                 0.125)
    f = [t.float() for t in (q, k, v, do)]
    with pytest.raises(TypeError):
        port.flash_bwd_dq_launch("tc", *f, lse, dvec, False, 0.125)
    torch.cuda.synchronize()
    assert (_dq_routes(), port.flash_bwd_dq_cuda.launches) == before


def test_bwd_wrappers_reject_what_the_kernels_do_not_take(cuda):
    q = torch.randn(1, 1, 4, 8, device=cuda)
    lse = torch.zeros(1, 1, 4, device=cuda)
    with pytest.raises(TypeError):      # lse must be float32
        port.flash_bwd_dq_cuda(q, q, q, q, lse.double(), lse, False, 1.0)
    with pytest.raises(ValueError):     # do has the wrong shape
        port.flash_bwd_dkv_cuda(q, q, q, q[:, :, :2], lse, lse, False, 1.0)


# -- fused optimizer update (csrc/fused_update.cu) ----------------------------
#
# The kernel rounds every operation as the plain version's PyTorch ops do,
# one at a time: moments must be bitwise equal, parameters within 4 ulp.

def _tree(dev, seed, shapes=((300, 7), (70000,), (5,), (1, 131073))):
    g = torch.Generator(device=dev).manual_seed(seed)
    return {f"p{i}": torch.randn(s, device=dev, generator=g)
            for i, s in enumerate(shapes)}


@pytest.mark.parametrize("kind,clip", [("sgd", None), ("momentum", 0.5),
                                       ("adam", None), ("adamw", 1.0)])
def test_fused_update_matches_plain_version(cuda, kind, clip):
    from paddle_tpu_torch.kernels import fused_update as fu
    params = _tree(cuda, 0)
    plain = {k: p.clone() for k, p in params.items()}
    names = fu.ACC_NAMES[kind]
    state = {nm: {k: torch.rand_like(p) for k, p in params.items()}
             for nm in names}
    plain_state = {nm: {k: t.clone() for k, t in d.items()}
                   for nm, d in state.items()}
    hyper = dict(momentum=0.9, nesterov=kind == "momentum", beta1=0.9,
                 beta2=0.999, epsilon=1e-8, weight_decay=0.01)
    for step in range(3):
        grads = _tree(cuda, 10 + step)
        before = fu.fused_update_step.launches
        fu.fused_update_step(params, grads, state, kind=kind, lr=1e-2,
                             step=step, clip_norm=clip, **hyper)
        assert fu.fused_update_step.launches == before + 1
        g_list = [grads[k] for k in plain]
        factor = None
        if clip is not None:
            factor = fu.clip_factor(fu.global_norm(g_list), clip)
        scal = fu.step_scalars(1e-2, step, kind, 0.9, 0.999, factor, cuda)
        for k in plain:
            fu.update_reference(kind, plain[k], grads[k],
                                [plain_state[nm][k] for nm in names], scal,
                                hyper, clip is not None)
    torch.cuda.synchronize()
    for nm in names:
        for k in params:
            assert torch.equal(state[nm][k], plain_state[nm][k]), (nm, k)
    for k in params:
        ulp = (params[k].view(torch.int32).long()
               - plain[k].view(torch.int32).long()).abs().max().item()
        assert ulp <= 4, (k, ulp)


# -- conv kernels (csrc/brgemm.cu, csrc/conv_kxk.cu) -------------------------
#
# Tolerances relative to the plain output's largest magnitude: float32
# forward 1e-5, dx/dw 1e-4 (the same float32 sums in another order);
# bfloat16 2e-2 (bf16 in and out, float32 sums on both sides).

# (h, c, o, k, stride): edges of every kind (M, N and K not multiples of
# the tiles, N = 64, C = 3, odd sizes, strided 1x1 and 3x3)
CONV_SHAPES = [(13, 24, 40, 1, 1), (13, 24, 40, 1, 2), (9, 16, 64, 3, 1),
               (9, 16, 70, 3, 2), (8, 64, 64, 3, 2), (7, 3, 130, 3, 1)]


def _conv_case(dev, shape, dtype, extra):
    import chip_smoke
    x, w, g = chip_smoke.r_inputs(shape, 3, dtype, dev, 0)
    ex = None
    if extra:
        gen = torch.Generator(device=dev).manual_seed(1)
        o = shape[2]
        ex = (torch.rand(o, device=dev, generator=gen) + 0.5,
              torch.randn(o, device=dev, generator=gen),
              torch.randn(g.shape, device=dev, generator=gen).to(dtype),
              torch.relu(torch.randn(g.shape, device=dev,
                                     generator=gen)).to(dtype))
    return chip_smoke.conv_calls(shape, x, w, g, ex)


@pytest.mark.parametrize("extra", [False, True], ids=["path", "epi_fold"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", CONV_SHAPES, ids=str)
def test_conv_kernels_match_plain_versions(cuda, shape, dtype, extra):
    from paddle_tpu_torch.kernels import conv_fused as cf
    from paddle_tpu_torch.kernels import tiles
    counters = {"brgemm": tiles.brgemm, "convkxk": cf.convkxk,
                "convkxk_dx": cf.convkxk_dx, "convkxk_dw": cf.convkxk_dw}
    for name, (kern, plain) in _conv_case(cuda, shape, dtype,
                                          extra).items():
        counter = counters["brgemm" if name.startswith("brgemm") else name]
        before = counter.launches
        got = kern()
        torch.cuda.synchronize()
        assert counter.launches == before + 1, name
        ref = plain()
        assert got.dtype == ref.dtype and got.shape == ref.shape, name
        assert torch.isfinite(got).all(), name
        err = ((got.float() - ref.float()).abs().max()
               / ref.float().abs().max().clamp(min=1e-30)).item()
        fwd = name in ("brgemm_fwd", "convkxk")
        tol = (1e-5 if fwd else 1e-4) if dtype == torch.float32 else 2e-2
        assert err < tol, (name, err)


@pytest.mark.parametrize("k,stride", [(1, 2), (3, 2), (3, 1)])
def test_conv2d_bn_act_launches_forward_dx_dw(cuda, k, stride):
    """The autograd route on the card: one forward and, in the backward,
    one dx and one dw launch; the gradients equal the CPU's plain route."""
    from paddle_tpu_torch.kernels import conv_fused as cf
    from paddle_tpu_torch.kernels import tiles
    gen = torch.Generator().manual_seed(2)
    x = torch.randn(2, 9, 9, 16, generator=gen)
    w = torch.randn(32, 16, k, k, generator=gen) * 0.2
    scale, bias = torch.rand(32, generator=gen) + 0.5, torch.randn(32)
    pad = (k - 1) // 2
    oh = (9 + 2 * pad - k) // stride + 1
    cot = torch.randn(2, oh, oh, 32, generator=gen)
    outs = {}
    for dev in ("cpu", cuda):
        leaves = [t.to(dev).requires_grad_() for t in (x, w, scale, bias)]
        fwd = (tiles.brgemm if k == 1 else cf.convkxk).launches
        out = cf.conv2d_bn_act(*leaves, act="relu", stride=stride,
                               padding=pad)
        grads = torch.autograd.grad(out, leaves, cot.to(dev))
        if dev != "cpu":
            torch.cuda.synchronize()
            # the forward, and dscale's recompute of the raw conv
            assert (tiles.brgemm if k == 1 else cf.convkxk).launches == \
                fwd + (4 if k == 1 else 2)
        outs[str(dev)] = [out] + list(grads)
    for a, b in zip(outs["cpu"], outs[str(cuda)]):
        err = ((b.cpu() - a).abs().max() / a.abs().max()).item()
        assert err < 1e-4, err


def test_conv_wrappers_raise_and_never_fall_back(cuda):
    from paddle_tpu_torch.kernels import conv_fused as cf
    from paddle_tpu_torch.kernels import tiles
    a = torch.randn(8, 16, device=cuda)
    with pytest.raises(TypeError):           # float16: no kernel for it
        tiles.brgemm(a.half(), a.t().contiguous().half())
    with pytest.raises(ValueError):          # not contiguous
        tiles.brgemm_cuda(a.t(), a)
    with pytest.raises(TypeError):           # operands of two dtypes
        tiles.brgemm_cuda(a, a.t().contiguous().bfloat16())
    x = torch.randn(1, 5, 5, 4, device=cuda)
    w = torch.randn(4, 4, 3, 3, device=cuda)
    with pytest.raises(TypeError):
        cf.convkxk(x.half(), w.half())
    with pytest.raises(ValueError):          # the wrong cotangent shape
        cf.convkxk_dx(x, None, None, w, x.shape, x.dtype, (1, 1),
                      ((0, 0), (0, 0)), (1, 1))


# -- the tensor-core weight gradient (csrc/conv_kxk_dw_tc.cu) -----------------

# (h, c, o, stride, dilation, fold, batch): C = O = 64 and 128, stride 1
# and 2, with and without the fold, dilated, a ragged K (3 x 5 x 5 = 75
# positions) and O = 192 (the 64-column tile)
DW_TC_CASES = [(9, 64, 64, 1, 1, False, 2), (9, 64, 64, 2, 1, True, 2),
               (8, 128, 128, 1, 1, True, 2), (8, 128, 128, 2, 1, False, 3),
               (12, 64, 64, 1, 2, True, 2), (9, 64, 64, 2, 1, False, 3),
               (7, 128, 192, 1, 1, True, 2)]


def _dw_case(dev, h, c, o, stride, dil, fold, batch, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    pad = dil
    oh = (h + 2 * pad - 2 * dil - 1) // stride + 1
    x = torch.randn(batch, h, h, c, device=dev, generator=gen).bfloat16()
    g = torch.randn(batch, oh, oh, o, device=dev, generator=gen).bfloat16()
    mask = scale = None
    if fold:
        scale = torch.rand(o, device=dev, generator=gen) + 0.5
        mask = torch.relu(torch.randn(g.shape, device=dev,
                                      generator=gen)).bfloat16()
    return (g, mask, scale, x, (o, c, 3, 3), torch.bfloat16,
            (stride, stride), ((pad, pad), (pad, pad)), (dil, dil))


def _dw_routes(cf):
    return cf.convkxk_dw_cuda.tc_launches, cf.convkxk_dw_cuda.simt_launches


@pytest.mark.parametrize("case", DW_TC_CASES, ids=str)
def test_dw_tc_route_matches_plain_version(cuda, case):
    """bf16 at the gate of chip_smoke's R1 (2e-2 of max |plain|): one
    float32 sum in another order, one bf16 rounding."""
    from paddle_tpu_torch.kernels import conv_fused as cf
    args = _dw_case(cuda, *case)
    before = _dw_routes(cf)
    got = cf.convkxk_dw_cuda(*args)
    torch.cuda.synchronize()
    assert _dw_routes(cf) == (before[0] + 1, before[1])
    ref = cf.convkxk_dw_reference(*args)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    assert torch.isfinite(got).all()
    err = ((got.float() - ref.float()).abs().max()
           / ref.float().abs().max()).item()
    assert err < 2e-2, err
    # one split (the kernel stores through the epilogue) and the most
    # splits (one K step each) compute the same
    k = args[0].shape[0] * args[0].shape[1] * args[0].shape[2]
    for splits in (1, -(-k // 64)):
        forced = cf.convkxk_dw_launch("tc", *args, splits=splits)
        torch.cuda.synchronize()
        err = ((forced.float() - ref.float()).abs().max()
               / ref.float().abs().max()).item()
        assert err < 2e-2, (splits, err)


def test_dw_route_counters_follow_the_rule(cuda):
    """Of CONV_SHAPES' 3x3 convs, (8, 64, 64, 3, 2) takes the tensor cores
    in bf16 and the rest (C = 16 or 3, O = 70 or 130) SIMT; float32 and a
    base off 16 bytes take SIMT. Every launch counts in
    ``convkxk_dw.launches`` too."""
    from paddle_tpu_torch.kernels import conv_fused as cf
    cases = []
    for shape in CONV_SHAPES:
        if shape[3] != 3:
            continue
        for dtype in (torch.float32, torch.bfloat16):
            want = "tc" if dtype == torch.bfloat16 and shape == (
                8, 64, 64, 3, 2) else "simt"
            cases.append((_conv_case(cuda, shape, dtype, False), want))
    for calls, want in cases:
        kern, plain = calls["convkxk_dw"]
        before, n = _dw_routes(cf), cf.convkxk_dw.launches
        got = kern()
        torch.cuda.synchronize()
        assert _dw_routes(cf) == ((before[0] + 1, before[1]) if want == "tc"
                                  else (before[0], before[1] + 1))
        assert cf.convkxk_dw.launches == n + 1
        ref = plain()
        tol = 1e-4 if got.dtype == torch.float32 else 2e-2
        assert ((got.float() - ref.float()).abs().max()
                / ref.float().abs().max()).item() < tol
    args = list(_dw_case(cuda, 8, 64, 64, 1, 1, False, 2))
    buf = torch.empty(args[3].numel() + 1, device=cuda, dtype=torch.bfloat16)
    off = buf[1:].view(args[3].shape)        # 2 bytes past an aligned base
    off.copy_(args[3])
    args[3] = off
    before = _dw_routes(cf)
    cf.convkxk_dw_cuda(*args)
    torch.cuda.synchronize()
    assert _dw_routes(cf) == (before[0], before[1] + 1)


def test_dw_tc_launch_raises_and_never_falls_back(cuda):
    """The tensor-core weight gradient's wrapper refuses float32 and its C
    entry C = 16 and a misaligned base: the launch raises, and no other
    kernel or plain version runs in its place."""
    from paddle_tpu_torch.kernels import conv_fused as cf
    f32 = list(_dw_case(cuda, 8, 64, 64, 1, 1, False, 2))
    f32[0], f32[3], f32[5] = f32[0].float(), f32[3].float(), torch.float32
    c16 = _dw_case(cuda, 8, 16, 64, 1, 1, False, 2)
    before = _dw_routes(cf), cf.convkxk_dw.launches
    with pytest.raises(TypeError):
        cf.convkxk_dw_launch("tc", *f32)
    with pytest.raises(RuntimeError, match="conv_kxk_dw_tc launch failed"):
        cf.convkxk_dw_launch("tc", *c16)
    with pytest.raises(ValueError):
        cf.convkxk_dw_launch("wgmma", *c16)
    assert (_dw_routes(cf), cf.convkxk_dw.launches) == before


# -- the tensor-core 3x3 forward (csrc/conv_kxk_fwd_tc.cu) --------------------

# (h, c, o, stride, dilation, epilogue, batch): C = O = 64 and 128, stride 1
# and 2, with and without the epilogue (scale, bias, residual, relu),
# dilated, a ragged M (3 x 5 x 5 = 75 positions) and O = 192 (three
# 64-column tiles)
FWD_TC_CASES = [(9, 64, 64, 1, 1, False, 2), (9, 64, 64, 2, 1, True, 2),
                (8, 128, 128, 1, 1, True, 2), (8, 128, 128, 2, 1, False, 3),
                (12, 64, 64, 1, 2, True, 2), (9, 64, 64, 2, 1, False, 3),
                (7, 128, 192, 1, 1, True, 2)]


def _fwd_case(dev, h, c, o, stride, dil, epi, batch, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    pad = dil
    oh = (h + 2 * pad - 2 * dil - 1) // stride + 1
    x = torch.randn(batch, h, h, c, device=dev, generator=gen).bfloat16()
    w = (torch.randn(o, c, 3, 3, device=dev, generator=gen)
         * (9 * c) ** -0.5).bfloat16()
    scale = bias = res = None
    if epi:
        scale = torch.rand(o, device=dev, generator=gen) + 0.5
        bias = torch.randn(o, device=dev, generator=gen)
        res = torch.randn(batch, oh, oh, o, device=dev,
                          generator=gen).bfloat16()
    return (x, w, scale, bias, res, epi, (stride, stride),
            ((pad, pad), (pad, pad)), (dil, dil))


def _fwd_routes(cf):
    return cf.convkxk_cuda.tc_launches, cf.convkxk_cuda.simt_launches


def _rel_err(got, ref):
    return ((got.float() - ref.float()).abs().max()
            / ref.float().abs().max()).item()


@pytest.mark.parametrize("case", FWD_TC_CASES, ids=str)
def test_fwd_tc_route_matches_plain_version(cuda, case):
    """bf16 at the gate of chip_smoke's R1 (2e-2 of max |plain|): one
    float32 sum in another order, one bf16 rounding; with a float32
    output too."""
    from paddle_tpu_torch.kernels import conv_fused as cf
    args = _fwd_case(cuda, *case)
    for out_dtype in (None, torch.float32):
        before = _fwd_routes(cf)
        got = cf.convkxk_cuda(*args, out_dtype=out_dtype)
        torch.cuda.synchronize()
        assert _fwd_routes(cf) == (before[0] + 1, before[1])
        ref = cf.convkxk_reference(*args, out_dtype=out_dtype)
        assert got.dtype == ref.dtype and got.shape == ref.shape
        assert torch.isfinite(got).all()
        assert _rel_err(got, ref) < 2e-2, out_dtype


def test_fwd_route_counters_follow_the_rule(cuda):
    """Of CONV_SHAPES' 3x3 convs, (8, 64, 64, 3, 2) takes the tensor cores
    in bf16 and the rest (C = 16 or 3, O = 70 or 130) SIMT; float32 and an
    x off 16 bytes take SIMT. Every launch counts in ``convkxk.launches``
    too."""
    from paddle_tpu_torch.kernels import conv_fused as cf
    cases = []
    for shape in CONV_SHAPES:
        if shape[3] != 3:
            continue
        for dtype in (torch.float32, torch.bfloat16):
            want = "tc" if dtype == torch.bfloat16 and shape == (
                8, 64, 64, 3, 2) else "simt"
            cases.append((_conv_case(cuda, shape, dtype, False), want))
    for calls, want in cases:
        kern, plain = calls["convkxk"]
        before, n = _fwd_routes(cf), cf.convkxk.launches
        got = kern()
        torch.cuda.synchronize()
        assert _fwd_routes(cf) == ((before[0] + 1, before[1]) if want == "tc"
                                   else (before[0], before[1] + 1))
        assert cf.convkxk.launches == n + 1
        ref = plain()
        tol = 1e-5 if got.dtype == torch.float32 else 2e-2
        assert _rel_err(got, ref) < tol
    args = list(_fwd_case(cuda, 8, 64, 64, 1, 1, False, 2))
    buf = torch.empty(args[0].numel() + 1, device=cuda, dtype=torch.bfloat16)
    off = buf[1:].view(args[0].shape)        # 2 bytes past an aligned base
    off.copy_(args[0])
    args[0] = off
    before = _fwd_routes(cf)
    got = cf.convkxk_cuda(*args)
    torch.cuda.synchronize()
    assert _fwd_routes(cf) == (before[0], before[1] + 1)
    assert _rel_err(got, cf.convkxk_reference(*args)) < 2e-2


def test_fwd_tc_launch_raises_and_never_falls_back(cuda):
    """The tensor-core forward's wrapper refuses float32 and its C entry
    C = 16: the launch raises, and no other kernel or plain version runs in
    its place."""
    from paddle_tpu_torch.kernels import conv_fused as cf
    f32 = list(_fwd_case(cuda, 8, 64, 64, 1, 1, False, 2))
    f32[0], f32[1] = f32[0].float(), f32[1].float()
    c16 = _fwd_case(cuda, 8, 16, 64, 1, 1, False, 2)
    before = _fwd_routes(cf), cf.convkxk.launches
    with pytest.raises(TypeError):
        cf.convkxk_launch("tc", *f32)
    with pytest.raises(RuntimeError, match="conv_kxk_fwd_tc launch failed"):
        cf.convkxk_launch("tc", *c16)
    with pytest.raises(ValueError):
        cf.convkxk_launch("wgmma", *c16)
    assert (_fwd_routes(cf), cf.convkxk.launches) == before


# -- the tensor-core 3x3 dx (csrc/conv_kxk_fwd_tc.cu at dx_geometry, and by
# phases at dx_phases) -----------------------------------------------------

# ResNet-50's distinct 3x3 shapes (h, c, o, 3, stride): the step's 16 dx
# launches, 13 at stride 1 (one conv) and 3 at stride 2 (by phases), and an
# odd H at stride 2
DX_TC_SHAPES = sorted({s for s in chip_smoke.resnet50_conv_shapes()
                       if s[3] == 3}) + [(15, 64, 128, 3, 2)]
DX_ROUTES = ("tc", "tc_phase", "simt")


def _dx_routes(cf):
    return tuple(getattr(cf.convkxk_dx_cuda, f"{r}_launches")
                 for r in DX_ROUTES)


def _dx_after(before, route):
    """``_dx_routes`` after one launch on ``route``."""
    return tuple(n + (r == route) for n, r in zip(before, DX_ROUTES))


def _dx_edge_case(dev, case, seed=0):
    """The arguments of one of chip_smoke's R1 tensor-core dx cases."""
    from paddle_tpu_torch.kernels import conv_fused as cf
    _, (h, wd, c), o, batch, pad, dil, x_dtype, stride, _ = case
    gen = torch.Generator(device=dev).manual_seed(seed)
    x_shape = (batch, h, wd, c)
    w = (torch.randn(o, c, 3, 3, device=dev, generator=gen)
         * (9 * o) ** -0.5).bfloat16()
    geo = cf.geometry(x_shape, w.shape, stride, pad, (dil, dil))
    g = torch.randn(batch, geo[7], geo[8], o, device=dev,
                    generator=gen).bfloat16()
    return (g, None, None, w, x_shape, x_dtype or torch.bfloat16, stride, pad,
            (dil, dil))


@pytest.mark.parametrize(
    "case", [("resnet", s) for s in DX_TC_SHAPES]
    + [("edge", c) for c in chip_smoke.R1_DX_TC_CASES],
    ids=[str(s) for s in DX_TC_SHAPES]
    + [c[0] for c in chip_smoke.R1_DX_TC_CASES])
def test_dx_tc_route_matches_plain_version(cuda, case):
    """bf16 at the gate of chip_smoke's R1 (2e-2 of max |plain|), a bf16
    and a float32 dx at ResNet-50's 3x3 shapes, stride 1 (one conv) and 2
    (by phases), and an odd H at stride 2 (batch 2), and R1's cases, each
    on the route it names: dilated, uneven-padding, ragged-M and
    float32-dx ones at stride 1, and by phases at stride 2 and (2, 1), a
    float32 dx, phases no tap reaches, O = C = 192 and stride 3."""
    from paddle_tpu_torch.kernels import conv_fused as cf
    kind, spec = case
    if kind == "resnet":
        x, w, g = chip_smoke.r_inputs(spec, 2, torch.bfloat16, cuda, 0)
        s = spec[4]
        route = "tc" if s == 1 else "tc_phase"
        arg_sets = [(g, None, None, w, x.shape, x_dtype, (s, s),
                     ((1, 1), (1, 1)), (1, 1))
                    for x_dtype in (torch.bfloat16, torch.float32)]
    else:
        route = spec[8]
        arg_sets = [_dx_edge_case(cuda, spec)]
    for args in arg_sets:
        before = _dx_routes(cf), cf.convkxk_dx.launches
        got = cf.convkxk_dx_cuda(*args)
        torch.cuda.synchronize()
        assert (_dx_routes(cf), cf.convkxk_dx.launches) == \
            (_dx_after(before[0], route), before[1] + 1)
        ref = cf.convkxk_dx_reference(*args)
        assert got.dtype == ref.dtype == args[5]
        assert got.shape == ref.shape
        assert torch.isfinite(got).all()
        assert _rel_err(got, ref) < 2e-2, args[5]


def test_dx_route_counters_follow_the_rule(cuda):
    """Of CONV_SHAPES' 3x3 convs only the one at C = O = 64 (stride 2)
    takes the tensor cores (the rest have C = 16 or 3, O = 70 or 130); at
    C = O = 64 bf16 without a fold takes them, as one conv at stride 1 and
    by phases at stride 2, and a fold, float32 and a g off 16 bytes take
    SIMT. Each call counts one on its route and in ``convkxk_dx.launches``,
    and each dx equals its plain version."""
    from paddle_tpu_torch.kernels import conv_fused as cf
    cases = []
    for shape in CONV_SHAPES + [(8, 64, 64, 3, 1)]:
        if shape[3] != 3:
            continue
        for dtype in (torch.float32, torch.bfloat16):
            for extra in (False, True):
                want = ("tc" if shape[4] == 1 else "tc_phase") \
                    if dtype == torch.bfloat16 and not extra and \
                    shape[1:3] == (64, 64) else "simt"
                cases.append((_conv_case(cuda, shape, dtype, extra), want))
    assert {want for _, want in cases} == set(DX_ROUTES)
    for calls, want in cases:
        kern, plain = calls["convkxk_dx"]
        before, n = _dx_routes(cf), cf.convkxk_dx.launches
        got = kern()
        torch.cuda.synchronize()
        assert _dx_routes(cf) == _dx_after(before, want)
        assert cf.convkxk_dx.launches == n + 1
        ref = plain()
        tol = 1e-4 if got.dtype == torch.float32 else 2e-2
        assert _rel_err(got, ref) < tol
    x, w, g = chip_smoke.r_inputs((8, 64, 64, 3, 1), 2, torch.bfloat16, cuda,
                                  0)
    buf = torch.empty(g.numel() + 1, device=cuda, dtype=torch.bfloat16)
    off = buf[1:].view(g.shape)              # 2 bytes past an aligned base
    off.copy_(g)
    args = (off, None, None, w, x.shape, torch.bfloat16, (1, 1),
            ((1, 1), (1, 1)), (1, 1))
    before = _dx_routes(cf)
    got = cf.convkxk_dx_cuda(*args)
    torch.cuda.synchronize()
    assert _dx_routes(cf) == _dx_after(before, "simt")
    assert _rel_err(got, cf.convkxk_dx_reference(*args)) < 2e-2


def test_dx_tc_launch_raises_and_never_falls_back(cuda):
    """The tensor-core dx's wrapper launches ``"tc_phase"`` at stride 1
    (one phase), matching its plain version, and counts nothing;
    ``"tc"`` refuses stride 2 before any launch (the phases take it);
    both refuse a fold and float32 before any launch (``"tc_phase"`` at
    stride 1 and 2), and their C entries C = 16: the launch raises, and no other kernel or
    plain version runs in its place."""
    from paddle_tpu_torch.kernels import conv_fused as cf
    pads = ((1, 1), (1, 1))
    x, w, g = chip_smoke.r_inputs((8, 64, 64, 3, 1), 2, torch.bfloat16, cuda,
                                  0)
    _, _, g2 = chip_smoke.r_inputs((8, 64, 64, 3, 2), 2, torch.bfloat16,
                                   cuda, 0)
    x16, w16, g16 = chip_smoke.r_inputs((8, 16, 64, 3, 1), 2,
                                        torch.bfloat16, cuda, 0)
    mask = torch.relu(g)
    before = _dx_routes(cf), cf.convkxk_dx.launches
    with pytest.raises(ValueError, match="tc_phase"):
        cf.convkxk_dx_launch("tc", g2, None, None, w, x.shape, x.dtype,
                             (2, 2), pads, (1, 1))
    s1 = (g, None, None, w, x.shape, x.dtype, (1, 1), pads, (1, 1))
    got = cf.convkxk_dx_launch("tc_phase", *s1)
    torch.cuda.synchronize()
    assert _rel_err(got, cf.convkxk_dx_reference(*s1)) < 2e-2
    for gs, stride in ((g2, (2, 2)), (g, (1, 1))):
        with pytest.raises(ValueError, match="fold"):
            cf.convkxk_dx_launch("tc_phase", gs, torch.relu(gs), None, w,
                                 x.shape, x.dtype, stride, pads, (1, 1))
        with pytest.raises(TypeError):
            cf.convkxk_dx_launch("tc_phase", gs.float(), None, None,
                                 w.float(), x.shape, torch.float32, stride,
                                 pads, (1, 1))
    with pytest.raises(RuntimeError,
                       match="conv_kxk_dx_phase_tc launch failed"):
        cf.convkxk_dx_launch("tc_phase", g16, None, None, w16, x16.shape,
                             x16.dtype, (1, 1), pads, (1, 1))
    with pytest.raises(ValueError, match="fold"):
        cf.convkxk_dx_launch("tc", g, mask, None, w, x.shape, x.dtype,
                             (1, 1), pads, (1, 1))
    with pytest.raises(ValueError, match="fold"):
        cf.convkxk_dx_launch("tc", g, None, torch.ones(64, device=cuda), w,
                             x.shape, x.dtype, (1, 1), pads, (1, 1))
    with pytest.raises(TypeError):
        cf.convkxk_dx_launch("tc", g.float(), None, None, w.float(),
                             x.shape, torch.float32, (1, 1), pads, (1, 1))
    with pytest.raises(RuntimeError, match="conv_kxk_fwd_tc launch failed"):
        cf.convkxk_dx_launch("tc", g16, None, None, w16, x16.shape,
                             x16.dtype, (1, 1), pads, (1, 1))
    with pytest.raises(ValueError):
        cf.convkxk_dx_launch("wgmma", g, None, None, w, x.shape, x.dtype,
                             (1, 1), pads, (1, 1))
    assert (_dx_routes(cf), cf.convkxk_dx.launches) == before


def test_conv2d_bn_act_3x3_bf16_backward_takes_the_tensor_core_dx(cuda):
    """The autograd route on the card, as a training step calls it (no
    epilogue, so nothing folds): a bf16 3x3 at C = O = 64 takes the
    tensor-core dx, as one conv at stride 1 and by phases at stride 2; the
    gradients equal the CPU's plain route within 2e-2 of their largest
    magnitude."""
    from paddle_tpu_torch.kernels import conv_fused as cf
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(2, 9, 9, 64, generator=gen).bfloat16()
    w = (torch.randn(64, 64, 3, 3, generator=gen) / 24).bfloat16()
    for stride in (1, 2):
        oh = (9 - 1) // stride + 1
        cot = torch.randn(2, oh, oh, 64, generator=gen).bfloat16()
        outs = {}
        for dev in ("cpu", cuda):
            leaves = [t.to(dev).requires_grad_() for t in (x, w)]
            before = _dx_routes(cf)
            out = cf.conv2d_bn_act(*leaves, stride=stride, padding=1)
            grads = torch.autograd.grad(out, leaves, cot.to(dev))
            if dev != "cpu":
                torch.cuda.synchronize()
                assert _dx_routes(cf) == _dx_after(
                    before, "tc" if stride == 1 else "tc_phase")
            outs[str(dev)] = grads
        for a, b in zip(outs["cpu"], outs[str(cuda)]):
            assert _rel_err(b.cpu(), a) < 2e-2, stride


def test_dx_phase_entry_derives_its_phases_and_refuses_what_it_cannot(
        cuda):
    """``conv_kxk_dx_phase_tc`` takes the conv's geometry alone, derives
    its phases as ``dx_phases`` does and reads each one's taps from
    ``phase_weights``' one tensor: at stride 2 it writes every position of
    dx, matching the plain version; where the odd rows and columns have no
    tap (3x3 at dilation 2 and stride 2) it writes the phase that has taps
    and leaves the rest of dx as it was. It returns cudaErrorInvalidValue
    and writes nothing of dx for a g other than bf16, C not a multiple of
    64, a stride of 0 and a dx off 16 bytes."""
    from paddle_tpu_torch.kernels import conv_fused as cf
    from paddle_tpu_torch.kernels import tiles
    bf16 = tiles.DTYPE_CODES[torch.bfloat16]
    shape = (15, 64, 128, 3, 2)
    x, w, g = chip_smoke.r_inputs(shape, 2, torch.bfloat16, cuda, 0)

    def run(geo, wk, in_dt=bf16, off=0):
        buf = torch.full((x.numel() + 8,), 7.0, device=cuda,
                         dtype=torch.bfloat16)
        dx = buf[off:off + x.numel()].view(x.shape)
        err = tiles.fwd_tc_lib().conv_kxk_dx_phase_tc(
            g.data_ptr(), wk.data_ptr(), dx.data_ptr(), tiles.geo_arg(geo),
            in_dt, bf16, torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        return err, dx

    for pad, dil, n_run in ((((1, 1), (1, 1)), (1, 1), 4),
                            (((2, 2), (2, 2)), (2, 2), 1)):
        args = (x.shape, w.shape, (2, 2), pad, dil)
        phases = cf.dx_phases(*args)
        plan = [p for p in phases if p.runs]
        assert len(plan) == n_run
        wk = cf.phase_weights(w, plan)
        err, dx = run(cf.geometry(*args), wk)
        assert err == 0
        ref = cf.convkxk_dx_reference(g, None, None, w, x.shape, x.dtype,
                                      (2, 2), pad, dil)
        for p in phases:
            got = dx[:, p.a::2, p.b::2]
            if p.runs:
                assert _rel_err(got, ref[:, p.a::2, p.b::2]) < 2e-2, p
            else:
                assert bool((got == 7.0).all()), p
    geo = cf.geometry(x.shape, w.shape, (2, 2), ((1, 1), (1, 1)), (1, 1))
    wk = cf.phase_weights(w, [p for p in cf.dx_phases(
        x.shape, w.shape, (2, 2), ((1, 1), (1, 1)), (1, 1)) if p.runs])
    c96 = list(geo)
    c96[3] = 96
    s0 = list(geo)
    s0[9] = 0
    for bad in ({"in_dt": tiles.DTYPE_CODES[torch.float32]},
                {"geo": c96}, {"geo": s0}, {"off": 1}):
        err, dx = run(**{"geo": geo, "wk": wk, **bad})
        assert err == 1, bad
        assert bool((dx == 7.0).all()), bad


# -- brgemm's tensor-core routes (the tensor-core conv kernels at 1x1) ---------

# ResNet-50's distinct 1x1 shapes (h, c, o, 1, stride): C = O = 64 (the
# 64-wide N tile), C = 2048, O = 2048, the strided ones (a sliced x)
BRGEMM_TC_SHAPES = sorted({s for s in chip_smoke.resnet50_conv_shapes()
                           if s[3] == 1})


def _brgemm_routes(tiles):
    c = tiles.brgemm_cuda
    return {"tc_fwd": c.tc_fwd_launches, "tc_dw": c.tc_dw_launches,
            "simt": c.simt_launches}


def _one_more(before, after, route):
    return after == dict(before, **{route: before[route] + 1})


@pytest.mark.parametrize("extra", [False, True], ids=["path", "epi_fold"])
@pytest.mark.parametrize("shape", BRGEMM_TC_SHAPES, ids=str)
def test_brgemm_tc_routes_match_plain_version(cuda, shape, extra):
    """bf16 at each 1x1 shape of ResNet-50 (batch 3), at the gate of
    chip_smoke's R1 (2e-2 of max |plain|): the forward (with the epilogue:
    scale, bias, a bf16 residual, relu) and the dx without a fold on
    ``tc_fwd``, the weight gradient (with the fold: mask and scale) on
    ``tc_dw``, the dx that folds on ``simt``; each counted once, in
    ``brgemm.launches`` too."""
    from paddle_tpu_torch.kernels import tiles
    for name, (kern, plain) in _conv_case(cuda, shape, torch.bfloat16,
                                          extra).items():
        want = chip_smoke.want_route(name, torch.bfloat16, extra, shape[4])
        before, n = _brgemm_routes(tiles), tiles.brgemm.launches
        got = kern()
        torch.cuda.synchronize()
        assert _one_more(before, _brgemm_routes(tiles), want), name
        assert tiles.brgemm.launches == n + 1
        ref = plain()
        assert got.dtype == ref.dtype and got.shape == ref.shape, name
        assert torch.isfinite(got).all(), name
        assert _rel_err(got, ref) < 2e-2, (name, _rel_err(got, ref))


def _gemm_operands(dev, m, k, n, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    a = torch.randn(m, k, device=dev, generator=gen).bfloat16()
    b = (torch.randn(k, n, device=dev, generator=gen) * k ** -0.5).bfloat16()
    return a, b, gen


def test_brgemm_tc_fwd_takes_a_float32_residual_and_output(cuda):
    """The forward's chain with a float32 residual, into a float32 and a
    bf16 output, at a ragged M (3 x 7 x 7 = 147) and O = 192 (three
    64-column tiles)."""
    from paddle_tpu_torch.kernels import tiles
    a, b, gen = _gemm_operands(cuda, 147, 256, 192)
    kw = dict(scale=torch.rand(192, device=cuda, generator=gen) + 0.5,
              bias=torch.randn(192, device=cuda, generator=gen),
              residual=torch.randn(147, 192, device=cuda, generator=gen),
              relu=True)
    for out_dtype in (torch.float32, torch.bfloat16):
        before = _brgemm_routes(tiles)
        got = tiles.brgemm_cuda(a, b, "nn", out_dtype, **kw)
        torch.cuda.synchronize()
        assert _one_more(before, _brgemm_routes(tiles), "tc_fwd")
        ref = tiles.brgemm_reference(a, b, "nn", out_dtype, **kw)
        assert got.dtype == ref.dtype == out_dtype
        assert _rel_err(got, ref) < 2e-2, out_dtype


def test_brgemm_route_counters_follow_the_rule(cuda):
    """float32, a dx that folds (a mask or a scale on a), a weight
    gradient with an epilogue or a float32 mask, a width that is no
    multiple of 64 and a base off 16 bytes take ``simt``; each still
    computes the plain version's result."""
    from paddle_tpu_torch.kernels import tiles
    a, b, gen = _gemm_operands(cuda, 200, 128, 64)
    g = torch.randn(200, 64, device=cuda, generator=gen).bfloat16()
    mask_g = torch.relu(torch.randn(200, 64, device=cuda,
                                    generator=gen)).bfloat16()
    scale = torch.rand(64, device=cuda, generator=gen) + 0.5
    buf = torch.empty(a.numel() + 1, device=cuda, dtype=torch.bfloat16)
    off = buf[1:].view(a.shape)               # 2 bytes past an aligned base
    off.copy_(a)
    wt = b.t().contiguous()                   # [64, 128]
    cases = [
        ("f32", (a.float(), b.float()), {}),
        ("dx_mask", (g, wt), dict(fold_on="a", fold_mask=mask_g)),
        ("dx_scale", (g, wt), dict(fold_on="a", fold_scale=scale)),
        ("nn_k48", (a[:, :48].contiguous(), b[:48].contiguous()), {}),
        ("nn_misaligned", (off, b), {}),
        ("tn_bias", (a, g), dict(mode="tn", bias=scale)),
        ("tn_f32_mask", (a, g), dict(mode="tn", fold_on="b",
                                     fold_mask=mask_g.float())),
        ("tn_fold_a", (a, g), dict(mode="tn", fold_on="a",
                                   fold_scale=torch.ones(
                                       128, device=cuda))),
        ("tn_n48", (a, g[:, :48].contiguous()), dict(mode="tn")),
        ("tn_misaligned", (off, g), dict(mode="tn")),
    ]
    for case, (x, y), kw in cases:
        before = _brgemm_routes(tiles)
        got = tiles.brgemm_cuda(x, y, **kw)
        torch.cuda.synchronize()
        assert _one_more(before, _brgemm_routes(tiles), "simt"), case
        ref = tiles.brgemm_reference(x, y, **kw)
        tol = 1e-5 if x.dtype == torch.float32 else 2e-2
        assert _rel_err(got, ref) < tol, case
    # and their counterparts that fit take the tensor cores
    for case, (x, y), kw, route in (
            ("nn", (a, b), {}, "tc_fwd"),
            ("dx_no_fold", (g, wt), dict(fold_on="a"), "tc_fwd"),
            ("tn_fold_b", (a, g), dict(mode="tn", fold_on="b",
                                       fold_mask=mask_g,
                                       fold_scale=scale), "tc_dw")):
        before = _brgemm_routes(tiles)
        got = tiles.brgemm_cuda(x, y, **kw)
        torch.cuda.synchronize()
        assert _one_more(before, _brgemm_routes(tiles), route), case
        assert _rel_err(got, tiles.brgemm_reference(x, y, **kw)) < 2e-2


def test_brgemm_tc_launch_raises_and_never_falls_back(cuda):
    """A tensor-core route refuses what its kernel does not compute (another
    mode, a fold on a, an epilogue on the weight gradient, float32, a
    float32 mask) in Python and, through its C entry, a width that is no
    multiple of 64: the launch raises, and nothing runs in its place."""
    from paddle_tpu_torch.kernels import tiles
    a, b, gen = _gemm_operands(cuda, 128, 64, 64)
    g = torch.randn(128, 64, device=cuda, generator=gen).bfloat16()
    mask = torch.relu(g.float())
    before = _brgemm_routes(tiles), tiles.brgemm.launches
    launch = tiles.brgemm_launch
    with pytest.raises(TypeError):
        launch("tc_fwd", a.float(), b.float())
    with pytest.raises(TypeError):
        launch("tc_dw", a, g, mode="tn", fold_on="b", fold_mask=mask)
    with pytest.raises(ValueError):
        launch("tc_fwd", a, b, fold_on="a", fold_mask=a)
    with pytest.raises(ValueError):
        launch("tc_fwd", a, g, mode="tn")
    with pytest.raises(ValueError):
        launch("tc_dw", a, b)
    with pytest.raises(ValueError):
        launch("tc_dw", a, g, mode="tn", relu=True)
    with pytest.raises(RuntimeError, match="conv_kxk_fwd_tc launch failed"):
        launch("tc_fwd", a[:, :48].contiguous(), b[:48].contiguous())
    with pytest.raises(RuntimeError, match="conv_kxk_dw_tc launch failed"):
        launch("tc_dw", a[:, :48].contiguous(), g, mode="tn")
    with pytest.raises(ValueError):
        launch("wgmma", a, b)
    assert (_brgemm_routes(tiles), tiles.brgemm.launches) == before


@pytest.mark.parametrize("act", [None, "relu"], ids=["train", "relu_scale"])
def test_conv2d_bn_act_1x1_bf16_takes_the_tensor_core_routes(cuda, act):
    """The autograd route of a bf16 1x1 conv: as a training step calls it
    (no epilogue) the forward and dx take ``tc_fwd`` and the dw ``tc_dw``;
    with a relu and a scale the dx folds and takes ``simt`` (the dscale
    recompute is one more forward). Output and gradients within 2e-2 of
    max |CPU plain route|."""
    from paddle_tpu_torch.kernels import conv_fused as cf
    from paddle_tpu_torch.kernels import tiles
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(2, 9, 9, 64, generator=gen).bfloat16()
    w = (torch.randn(128, 64, 1, 1, generator=gen) * 0.125).bfloat16()
    scale = torch.rand(128, generator=gen) + 0.5 if act else None
    cot = torch.randn(2, 9, 9, 128, generator=gen).bfloat16()
    outs = {}
    for dev in ("cpu", cuda):
        leaves = [t.to(dev).requires_grad_() for t in (x, w)]
        s = None if scale is None else scale.to(dev).requires_grad_()
        before = _brgemm_routes(tiles)
        out = cf.conv2d_bn_act(*leaves, scale=s, act=act)
        grads = torch.autograd.grad(out, leaves + ([s] if act else []),
                                    cot.to(dev))
        if dev != "cpu":
            torch.cuda.synchronize()
            after = _brgemm_routes(tiles)
            got = {r: after[r] - before[r] for r in after}
            assert got == ({"tc_fwd": 2, "tc_dw": 1, "simt": 1} if act else
                           {"tc_fwd": 2, "tc_dw": 1, "simt": 0})
        outs[str(dev)] = [out] + list(grads)
    for a, b in zip(outs["cpu"], outs[str(cuda)]):
        assert _rel_err(b.cpu(), a) < 2e-2


def test_max_pool_ties_on_nhwc_cuda_tensors_take_the_first_max(cuda):
    """channels_last CUDA tensors take another max-pool kernel than the
    CPU's: forward and gradient must still equal the CPU's (the first
    maximum of a window takes the gradient, as in the JAX reference)."""
    from paddle_tpu_torch.ops import nn_ops
    gen = torch.Generator().manual_seed(0)
    x = torch.relu(torch.randn(2, 30, 31, 8, generator=gen))
    x[:, 3:12, 4:10, :] = 0.0
    x[1, 14:20, 14:20, 2] = 1.5
    outs = []
    for dev in ("cpu", cuda):
        for dtype in (torch.float32, torch.bfloat16):
            leaf = x.to(dev, dtype).requires_grad_()
            out = nn_ops.pool2d(leaf, 3, "max", 2, 1, data_format="NHWC")
            cot = (torch.arange(out.numel()) % 5).reshape(out.shape)
            (g,) = torch.autograd.grad(out, leaf, cot.to(dev, dtype))
            outs.append((out.float().cpu(), g.float().cpu()))
    for (o_cpu, g_cpu), (o_gpu, g_gpu) in zip(outs[:2], outs[2:]):
        assert torch.equal(o_cpu, o_gpu)
        assert torch.equal(g_cpu, g_gpu)


def test_float8_casts_on_the_card_equal_the_cpus(cuda):
    from paddle_tpu_torch import amp
    bits = torch.arange(-32768, 32768, dtype=torch.int32).to(torch.int16)
    x = bits.view(torch.bfloat16)
    for fn in (amp.to_e4m3_round_trip, amp.e5m2_grad_store):
        a, b = fn(x), fn(x.to(cuda)).cpu()
        same = (a == b) | (torch.isnan(a) & torch.isnan(b))
        assert bool(same.all()), fn.__name__


# -- the fused max pool and the embedding seqpool ------------------------------

# (shape, pool size, stride, padding, the backward's route in float32 and
# bf16 alike): the stem's 3x3/s2/p1 (at batch 16 every block walks several
# bands, so the ring of stages turns over), at an odd plane, 2x2/s2/p0,
# 3x3/s1/p1 (up to 9 windows sum: the order matters), kh != kw and
# sh != sw, and C that is not a multiple of the 16-byte vector (the gather)
POOL_CASES = [((2, 112, 112, 64), 3, 2, 1, "tile"),
              ((16, 112, 112, 64), 3, 2, 1, "tile"),
              ((3, 37, 29, 24), 3, 2, 1, "tile"),
              ((2, 8, 10, 8), 2, 2, 0, "tile"),
              ((2, 9, 9, 8), 3, 1, 1, "tile"),
              ((2, 11, 13, 16), (3, 2), (2, 1), (1, 0), "tile"),
              ((2, 8, 10, 6), 2, 2, 0, "gather"),
              ((2, 9, 9, 5), 3, 1, 1, "gather")]


def _pool_routes(pf):
    return pf.pool_bwd.tile_launches, pf.pool_bwd.gather_launches


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", POOL_CASES, ids=str)
def test_pool_kernels_match_plain_version(cuda, case, dtype):
    """Windows of ties (post-relu values on a few levels) and NaN entries:
    out and idx equal, dx bit for bit; one launch each, the backward on
    the route ``bwd_route`` names."""
    from paddle_tpu_torch.kernels import pool_fused as pf
    shape, k, s, p, route = case
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = torch.relu(torch.round(torch.randn(shape, device=cuda,
                                           generator=gen) * 2) / 2)
    x.view(-1)[::17] = float("nan")
    x = x.to(dtype)
    geo = pf.geometry(shape, k, s, p)
    assert pf.bwd_route(dtype, geo, True) == route
    before = (pf.pool_fwd.launches, pf.pool_bwd.launches)
    routes = _pool_routes(pf)
    out, idx = pf.pool_fwd_cuda(x, geo)
    g = torch.randn(out.shape, device=cuda, generator=gen).to(dtype)
    dx = pf.pool_bwd_cuda(g, idx, geo, dtype)
    torch.cuda.synchronize()
    assert (pf.pool_fwd.launches, pf.pool_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    tile = route == "tile"
    assert _pool_routes(pf) == (routes[0] + tile, routes[1] + (not tile))
    ref_out, ref_idx = pf.pool_fwd_reference(x, geo)
    ref_dx = pf.pool_bwd_reference(g, ref_idx, geo, dtype)
    assert torch.equal(out, ref_out) and torch.equal(idx, ref_idx)
    assert torch.equal(dx, ref_dx)
    # the other route on the same inputs, uncounted, where it takes them
    if tile:
        other = pf.pool_bwd_launch("gather", g, idx, geo, dtype)
        torch.cuda.synchronize()
        assert torch.equal(other, ref_dx)
    assert _pool_routes(pf) == (routes[0] + tile, routes[1] + (not tile))


def test_pool_bwd_routes_raise_and_never_fall_back(cuda, monkeypatch):
    """The tile kernel's C entry refuses C = 3 and a misaligned base before
    any launch, and its wrapper a geometry with no band that fits; a launch
    error on either route raises from the wrapper the backward calls, and
    neither the other kernel nor the plain version runs in its place.
    Nothing is counted."""
    from paddle_tpu_torch.kernels import pool_fused as pf
    gen = torch.Generator(device=cuda).manual_seed(0)
    inputs = {}
    for c in (3, 8):
        x = torch.randn(2, 9, 9, c, device=cuda, generator=gen).bfloat16()
        geo = pf.geometry(x.shape, 3, 2, 1)
        out, idx = pf.pool_fwd_cuda(x, geo)
        inputs[c] = (out.clone(), idx, geo, torch.bfloat16)
    g8, idx8, geo8, _ = inputs[8]
    buf = torch.empty(g8.numel() + 1, dtype=g8.dtype, device=cuda)
    g_off = buf[1:].view(g8.shape)
    g_off.copy_(g8)
    assert pf.bwd_route(torch.bfloat16, geo8, False) == "gather"
    counts = (pf.pool_bwd.launches, _pool_routes(pf))
    with pytest.raises(RuntimeError, match="pool_bwd_tile launch failed"):
        pf.pool_bwd_launch("tile", *inputs[3])
    with pytest.raises(RuntimeError, match="pool_bwd_tile launch failed"):
        pf.pool_bwd_launch("tile", g_off, idx8, geo8, torch.bfloat16)
    with pytest.raises(ValueError):
        pf.pool_bwd_launch("scatter", *inputs[8])
    # a row of g and idx of 5 MB: no band fits, so the tile route refuses
    wide = torch.randn(1, 4, 20000, 64, device=cuda)
    geo_w = pf.geometry(wide.shape, 2, 2, 0)
    out_w, idx_w = pf.pool_fwd_cuda(wide, geo_w)
    with pytest.raises(ValueError, match="does not fit"):
        pf.pool_bwd_launch("tile", out_w, idx_w, geo_w, torch.float32)

    def no_fallback(*args):
        raise AssertionError("a plain version ran in a kernel's place")

    monkeypatch.setattr(pf, "pool_bwd_reference", no_fallback)
    lib = pf._lib()
    for c, fn in ((8, "pool_bwd_tile"), (3, "pool_bwd")):
        assert pf.bwd_route(torch.bfloat16, inputs[c][2], True) == (
            "tile" if c == 8 else "gather")
        # cudaErrorLaunchFailure from the named kernel's launch
        monkeypatch.setattr(lib, fn, lambda *args: 719)
        with pytest.raises(RuntimeError,
                           match=f"{fn} launch failed: cudaError_t 719"):
            pf.pool_bwd_cuda(*inputs[c])
        monkeypatch.undo()
        monkeypatch.setattr(pf, "pool_bwd_reference", no_fallback)
    assert (pf.pool_bwd.launches, _pool_routes(pf)) == counts


def test_pool_bwd_tile_entry_checks_the_wrappers_stages(cuda):
    """The tile kernel's C entry takes the stage size from ``tile_plan``
    and only checks it: a stage short of the rows it stages, or not a
    multiple of 16 bytes, is cudaErrorInvalidValue, and two stages past
    the shared memory a block may take are refused by the runtime; each
    before any launch, and the next launch at the plan's size still
    equals the plain version."""
    import ctypes
    from paddle_tpu_torch.kernels import pool_fused as pf
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(2, 9, 9, 8, device=cuda, generator=gen).bfloat16()
    geo = pf.geometry(x.shape, 3, 2, 1)
    out, idx = pf.pool_fwd_cuda(x, geo)
    g = torch.randn(out.shape, device=cuda, generator=gen).bfloat16()
    bh, rows, stage_bytes = pf.tile_plan(geo, 2)
    table = pf.tile_table(geo, bh, x.device)
    dx = torch.zeros_like(x)
    lib = pf._lib()

    def launch(size):
        return lib.pool_bwd_tile(
            g.data_ptr(), idx.data_ptr(), dx.data_ptr(),
            (ctypes.c_int * 12)(*geo), table.data_ptr(), bh, rows, size,
            pf.DTYPE_CODES[torch.bfloat16],
            torch.cuda.current_stream().cuda_stream)

    assert launch(stage_bytes - 16) == 1
    assert launch(stage_bytes + 8) == 1
    assert launch(pf.TILE_SMEM_BYTES) != 0
    torch.cuda.synchronize()
    assert not dx.any()
    assert launch(stage_bytes) == 0
    torch.cuda.synchronize()
    ref = pf.pool_bwd_reference(g, idx, geo, torch.bfloat16)
    assert torch.equal(dx, ref)


def test_pool2d_knob_routes_the_stem_pool_to_the_kernels(cuda):
    """With ``POOL_FUSED`` on, the stem's pool2d launches the forward and,
    in the backward, the backward kernel; both equal the CPU's route."""
    from paddle_tpu_torch.kernels import pool_fused as pf
    from paddle_tpu_torch.ops import nn_ops
    gen = torch.Generator().manual_seed(3)
    x = torch.relu(torch.randn(2, 30, 31, 8, generator=gen))
    cot = torch.randn(2, 15, 16, 8, generator=gen)
    outs = []
    pf.set_pool_fused(True)
    try:
        for dev in ("cpu", cuda):
            leaf = x.to(dev).requires_grad_()
            before = (pf.pool_fwd.launches, pf.pool_bwd.launches)
            out = nn_ops.pool2d(leaf, 3, "max", 2, 1, data_format="NHWC")
            (g,) = torch.autograd.grad(out, leaf, cot.to(dev))
            launched = (pf.pool_fwd.launches - before[0],
                        pf.pool_bwd.launches - before[1])
            assert launched == ((0, 0) if dev == "cpu" else (1, 1))
            outs.append((out.detach().cpu(), g.cpu()))
    finally:
        pf.set_pool_fused(False)
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])


@pytest.mark.parametrize("mean", [False, True], ids=["sum", "mean"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [(256, 256, 5149, 128), (5, 7, 30, 13)],
                         ids=["imdb", "ragged_d13"])
def test_seqpool_kernel_matches_plain_version(cuda, shape, dtype, mean):
    """ids out of range on both ends; float32 within 1e-5 of the largest
    output (sums in another order), bf16 within 2e-2 (one more rounding);
    one launch a call."""
    from paddle_tpu_torch.kernels import embedding_pool as ep
    b, s, v, d = shape
    gen = torch.Generator(device=cuda).manual_seed(1)
    table = torch.randn(v, d, device=cuda, generator=gen).to(dtype)
    ids = torch.randint(-3, v + 3, (b, s), device=cuda, generator=gen)
    before = ep.seqpool.launches
    got = ep.embedding_seqpool(ids, table, mean)
    torch.cuda.synchronize()
    assert ep.seqpool.launches == before + 1
    ref = ep.seqpool_reference(ids, table, mean)
    assert got.dtype == ref.dtype == dtype and got.shape == ref.shape
    err = ((got.float() - ref.float()).abs().max()
           / ref.float().abs().max()).item()
    assert err <= (1e-5 if dtype == torch.float32 else 2e-2), err


def test_pool_and_seqpool_wrappers_raise_and_never_fall_back(cuda):
    from paddle_tpu_torch.kernels import embedding_pool as ep
    from paddle_tpu_torch.kernels import pool_fused as pf
    x = torch.randn(1, 6, 6, 8, device=cuda)
    geo = pf.geometry(x.shape, 3, 2, 1)
    with pytest.raises(TypeError):            # float16: no kernel for it
        pf.pool_fwd_cuda(x.half(), geo)
    with pytest.raises(ValueError):           # not contiguous
        pf.pool_fwd_cuda(x.transpose(1, 2), geo)
    out, idx = pf.pool_fwd_cuda(x, geo)
    with pytest.raises(TypeError):            # g not in x's dtype
        pf.pool_bwd_cuda(out.bfloat16(), idx, geo, torch.float32)
    with pytest.raises(ValueError):           # padding as large as the window
        pf.max_pool2d_fused(x, 2, 2, 2)
    table = torch.randn(10, 8, device=cuda)
    ids = torch.zeros(2, 3, dtype=torch.int64, device=cuda)
    with pytest.raises(TypeError):            # the kernel takes int32 ids
        ep.seqpool_cuda(ids, table)
    with pytest.raises(TypeError):
        ep.seqpool_cuda(ids.int(), table.half())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16], ids=["f32", "bf16", "f16"])
@pytest.mark.parametrize("shape", [(4096, 768), (100, 96), (7, 10),
                                   (1, 1000), (64, 4096), (33, 301)],
                         ids=str)
def test_layer_norm_kernel_matches_plain_version(cuda, shape, dtype):
    """float32 within 1e-5 of the largest output (sums in another order);
    bf16 / float16 within one ulp of the plain value plus the float32
    allowance (one rounding of float32 results that agree to ~1e-7); one
    launch a call through the op."""
    from paddle_tpu_torch.kernels import layer_norm as ln
    from paddle_tpu_torch.ops import nn_ops
    gen = torch.Generator(device=cuda).manual_seed(2)
    x = (torch.randn(*shape, device=cuda, generator=gen) * 3 + 1).to(dtype)
    s = torch.rand(shape[1], device=cuda, generator=gen) + 0.5
    b = torch.randn(shape[1], device=cuda, generator=gen)
    before = ln.fused_layer_norm.launches
    got = nn_ops.layer_norm(x, s, b, 1, 1e-12, use_pallas=True)
    torch.cuda.synchronize()
    assert ln.fused_layer_norm.launches == before + 1
    ref = ln.fused_layer_norm_reference(x, s, b, 1e-12)
    assert got.dtype == dtype and got.shape == ref.shape
    diff = (got.float() - ref.float()).abs()
    amax = ref.float().abs().max().item()
    if dtype == torch.float32:
        assert diff.max().item() <= 1e-5 * amax
        return
    mant = 7 if dtype == torch.bfloat16 else 10
    ulp = torch.pow(2.0, torch.floor(torch.log2(
        ref.float().abs().clamp(min=2.0 ** -14))) - mant)
    assert ((diff - 1e-5 * amax).clamp(min=0) <= ulp).all()


def test_layer_norm_routes_and_refuses_a_gradient_on_the_card(cuda):
    """The layer launches the kernel on a 2-D input and not on a 3-D one;
    the kernel route's backward raises; the wrapper refuses what the
    kernel does not take."""
    from paddle_tpu_torch.kernels import layer_norm as ln
    from paddle_tpu_torch.nn.layers import LayerNorm
    layer = LayerNorm(64, epsilon=1e-12, use_pallas=True).to(cuda)
    x = torch.randn(2, 8, 64, device=cuda)
    for inp, n in ((x.reshape(16, 64), 1), (x, 0)):
        before = ln.fused_layer_norm.launches
        with torch.no_grad():
            layer(inp)
        assert ln.fused_layer_norm.launches == before + n
    x2 = x.reshape(16, 64).clone().requires_grad_()
    with pytest.raises(RuntimeError, match="no gradient"):
        torch.autograd.grad(layer(x2).sum(), x2)
    with pytest.raises(TypeError):            # no kernel for float64
        ln.layer_norm_cuda(x.reshape(16, 64).double())
    with pytest.raises(ValueError):           # not contiguous
        ln.layer_norm_cuda(x.reshape(16, 64).t())
    with pytest.raises(TypeError):            # scale must be float32
        ln.layer_norm_cuda(x.reshape(16, 64), torch.ones(
            64, device=cuda, dtype=torch.bfloat16))


def test_bert_flash_step_launches_the_flash_kernels_and_no_row_norm(cuda):
    """A tiny BERT step with ``use_pallas=True`` on the card: one flash
    forward, dQ and dK/dV launch a layer, none of the row LayerNorm."""
    from paddle_tpu_torch.kernels import layer_norm as ln
    from paddle_tpu_torch.models import BertConfig, BertForPretraining
    model = BertForPretraining(BertConfig.tiny(use_pallas=True),
                               device=cuda)
    ids = torch.randint(1, 128, (2, 32), device=cuda)
    ids[1, 20:] = 0
    before = (port.flash_attention.launches, port.flash_bwd_dq_cuda.launches,
              port.flash_bwd_dkv_cuda.launches, ln.fused_layer_norm.launches)
    mlm, nsp = model(ids)
    loss = model.loss(mlm, nsp, ids, torch.ones(2, 32, device=cuda),
                      ids[:, 0] % 2)[0]
    loss.backward()
    torch.cuda.synchronize()
    after = (port.flash_attention.launches, port.flash_bwd_dq_cuda.launches,
             port.flash_bwd_dkv_cuda.launches, ln.fused_layer_norm.launches)
    assert [a - b for a, b in zip(after, before)] == [2, 2, 2, 0]
    assert torch.isfinite(loss)
