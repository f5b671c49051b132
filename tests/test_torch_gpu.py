"""Card-only tests of the port's CUDA kernels (marker ``gpu``): the flash
forward and backward, the fused optimizer update, the conv kernels, the
fused max pool and the embedding seqpool against their plain versions.

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

POOL_CASES = [((2, 112, 112, 64), 3, 2, 1), ((3, 37, 29, 24), 3, 2, 1),
              ((2, 8, 10, 6), 2, 2, 0), ((2, 9, 9, 5), 3, 1, 1)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", POOL_CASES, ids=str)
def test_pool_kernels_match_plain_version(cuda, case, dtype):
    """Windows of ties (post-relu values on a few levels) and NaN entries:
    out and idx equal, dx bit for bit; one launch each."""
    from paddle_tpu_torch.kernels import pool_fused as pf
    shape, k, s, p = case
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = torch.relu(torch.round(torch.randn(shape, device=cuda,
                                           generator=gen) * 2) / 2)
    x.view(-1)[::17] = float("nan")
    x = x.to(dtype)
    geo = pf.geometry(shape, k, s, p)
    before = (pf.pool_fwd.launches, pf.pool_bwd.launches)
    out, idx = pf.pool_fwd_cuda(x, geo)
    g = torch.randn(out.shape, device=cuda, generator=gen).to(dtype)
    dx = pf.pool_bwd_cuda(g, idx, geo, dtype)
    torch.cuda.synchronize()
    assert (pf.pool_fwd.launches, pf.pool_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    ref_out, ref_idx = pf.pool_fwd_reference(x, geo)
    ref_dx = pf.pool_bwd_reference(g, ref_idx, geo, dtype)
    assert torch.equal(out, ref_out) and torch.equal(idx, ref_idx)
    assert torch.equal(dx, ref_dx)


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
