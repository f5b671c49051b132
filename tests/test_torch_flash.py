"""The port's flash attention against the JAX package's, on the CPU.

The port's plain version (``flash_attention_reference``) is held against
the JAX Pallas forward kernel run in interpret mode
(``_flash_call_fwd(..., interpret=True)``: o and lse) and against the scan
path of the JAX ``flash_attention`` (o). The kernel itself runs only on the
card (``tests/test_torch_gpu.py``); here the wrapper must take the plain
version because the tensors lie on the CPU, and count no launch. The
rules that pick a kernel on the card (``fwd_route``, and ``bwd_route``
for both backward wrappers) are pinned by tables.

Tolerance: float32, atol = rtol = 1e-5. Both sides compute the same
float32 function; only the summation order of the two products and the
exp/log implementations differ (observed differences ~5e-7).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels.attention import _flash_call_fwd
from paddle_tpu.kernels.attention import flash_attention as jax_flash
from paddle_tpu_torch.kernels import attention as port
from paddle_tpu_torch.nn.attention import scaled_dot_product_attention

TOL = dict(rtol=1e-5, atol=1e-5)

# (name, b, h, tq, tk, d, causal, masked)
CASES = [
    ("tq_eq_tk", 2, 3, 16, 16, 8, False, False),
    ("tq_eq_tk_masked", 2, 3, 16, 16, 8, False, True),
    ("decode_tq1", 3, 2, 1, 24, 16, False, True),
    ("causal", 2, 2, 16, 16, 8, True, False),
    ("causal_masked", 2, 2, 8, 8, 4, True, True),
]


def _inputs(b, h, tq, tk, d, masked, seed=0):
    rs = np.random.RandomState(seed)
    q = rs.randn(b, h, tq, d).astype(np.float32)
    k = rs.randn(b, h, tk, d).astype(np.float32)
    v = rs.randn(b, h, tk, d).astype(np.float32)
    m = None
    if masked:
        m = rs.rand(b, tk) > 0.3
        m[:, 0] = True   # every row keeps a key, except the one below
        m[-1] = False    # a fully masked row, as an all-pad source row
    return q, k, v, m


def _t(x):
    return None if x is None else torch.from_numpy(x)


def _j(x):
    return None if x is None else jnp.asarray(x)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_plain_matches_pallas_interpret(case):
    _, b, h, tq, tk, d, causal, masked = case
    q, k, v, m = _inputs(b, h, tq, tk, d, masked)
    scale = d ** -0.5
    jo, jl = _flash_call_fwd(_j(q), _j(k), _j(v), _j(m), causal, scale,
                             tq, tk, interpret=True)
    po, pl = port.flash_attention_reference(_t(q), _t(k), _t(v), causal,
                                            scale, _t(m))
    np.testing.assert_allclose(po.numpy(), np.asarray(jo), **TOL)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **TOL)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_plain_matches_scan_path(case):
    _, b, h, tq, tk, d, causal, masked = case
    q, k, v, m = _inputs(b, h, tq, tk, d, masked, seed=1)
    want = jax_flash(_j(q), _j(k), _j(v), causal=causal, kv_mask=_j(m),
                     block_k=8, block_q=8)
    got = port.flash_attention(_t(q), _t(k), _t(v), causal=causal,
                               kv_mask=_t(m), device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_fully_masked_row_is_uniform_mean_of_v():
    q, k, v, m = _inputs(2, 2, 4, 12, 8, masked=True)
    o, lse = port.flash_attention_reference(_t(q), _t(k), _t(v), False,
                                            None, _t(m))
    assert torch.isfinite(o).all() and torch.isfinite(lse).all()
    np.testing.assert_allclose(
        o[-1].numpy(), np.broadcast_to(v[-1].mean(axis=1, keepdims=True),
                                       o[-1].shape), **TOL)
    assert (lse[-1] < -1e29).all()
    assert (lse[0] > -1e29).all()


def test_cpu_wrapper_takes_plain_version_and_counts_no_launch():
    port.flash_attention.launches = 0
    q, k, v, m = _inputs(2, 2, 8, 8, 8, masked=True)
    out = port.flash_attention(_t(q), _t(k), _t(v), kv_mask=_t(m),
                               device="cpu")
    ref, _ = port.flash_attention_reference(_t(q), _t(k), _t(v),
                                            kv_mask=_t(m))
    assert torch.equal(out, ref)
    # the causal Tq != Tk route (plain version on every device)
    q1 = _t(q[:, :, :3])
    port.flash_attention(q1, _t(k), _t(v), causal=True, device="cpu")
    assert port.flash_attention.launches == 0


def test_wrapper_default_device_raises_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    q, k, v, _ = _inputs(1, 1, 4, 4, 8, masked=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.flash_attention(_t(q), _t(k), _t(v))


@pytest.mark.parametrize("mask_kind", ["padding", "decode_cache"])
def test_sdpa_flash_route_matches_plain_route(mask_kind):
    """The [B|1,1,1,Tk] masks that the model passes fold into the kv mask
    and agree with the plain masked-softmax route."""
    q, k, v, m = _inputs(3, 2, 1 if mask_kind == "decode_cache" else 6, 10,
                         8, masked=False, seed=2)
    if mask_kind == "padding":
        mask = torch.from_numpy(np.random.RandomState(3).rand(3, 10) > 0.4)
        mask[:, 0] = True
        mask = mask[:, None, None, :]
    else:
        mask = (torch.arange(10) <= 4)[None, None, None, :]
    flash = scaled_dot_product_attention(_t(q), _t(k), _t(v), mask,
                                         use_flash=True)
    plain = scaled_dot_product_attention(_t(q), _t(k), _t(v), mask,
                                         use_flash=False)
    np.testing.assert_allclose(flash.numpy(), plain.numpy(), **TOL)


# (dtype, tq, d, aligned, route): the forward kernel a CUDA call takes
ROUTES = [
    (torch.bfloat16, 64, 64, True, "tc"),       # serving encoder, BERT
    (torch.bfloat16, 4096, 64, True, "tc"),     # transformer_long
    (torch.bfloat16, 16, 16, True, "tc"),       # smallest tc tile
    (torch.bfloat16, 256, 128, True, "tc"),     # D = 128: two column blocks
    (torch.bfloat16, 40, 48, True, "tc"),       # D padded to 64
    (torch.bfloat16, 15, 64, True, "simt"),     # Tq under 16
    (torch.bfloat16, 1, 64, True, "simt"),      # decode
    (torch.bfloat16, 64, 100, True, "simt"),    # D not a multiple of 16
    (torch.bfloat16, 64, 8, True, "simt"),      # D under 16
    (torch.bfloat16, 64, 144, True, "simt"),    # D over 128
    (torch.bfloat16, 64, 64, False, "simt"),    # a base off 16 bytes
    (torch.float32, 64, 64, True, "simt"),      # float32: 1e-5 gates
    (torch.float32, 4096, 128, True, "simt"),
    (torch.float16, 64, 64, True, "simt"),
]


@pytest.mark.parametrize("dtype,tq,d,aligned,route", ROUTES,
                         ids=[f"{str(r[0])[6:]}_tq{r[1]}_d{r[2]}_"
                              f"{'al' if r[3] else 'unal'}" for r in ROUTES])
def test_fwd_route_is_a_fixed_rule(dtype, tq, d, aligned, route):
    assert port.fwd_route(dtype, tq, d, aligned) == route


def test_cpu_wrapper_counts_no_route_launch():
    tc, simt = (port.flash_fwd_cuda.tc_launches,
                port.flash_fwd_cuda.simt_launches)
    q, k, v, m = _inputs(2, 2, 16, 16, 16, masked=True)
    port.flash_attention(_t(q).bfloat16(), _t(k).bfloat16(),
                         _t(v).bfloat16(), kv_mask=_t(m), device="cpu")
    assert (port.flash_fwd_cuda.tc_launches,
            port.flash_fwd_cuda.simt_launches) == (tc, simt)


# (dtype, d, aligned, route): the dQ and the dK/dV kernel a CUDA call takes
BWD_ROUTES = [
    (torch.bfloat16, 64, True, "tc"),       # transformer_long, BERT
    (torch.bfloat16, 16, True, "tc"),       # smallest tc width
    (torch.bfloat16, 32, True, "tc"),       # D padded to 64
    (torch.bfloat16, 48, True, "tc"),
    (torch.bfloat16, 8, True, "simt"),      # D under 16
    (torch.bfloat16, 80, True, "simt"),     # D past 64: accumulators of
    (torch.bfloat16, 128, True, "simt"),    # 128 columns do not fit
    (torch.bfloat16, 100, True, "simt"),    # D not a multiple of 16
    (torch.bfloat16, 40, True, "simt"),
    (torch.bfloat16, 64, False, "simt"),    # a base off 16 bytes
    (torch.float32, 64, True, "simt"),      # float32: 1e-4 gates
    (torch.float32, 16, True, "simt"),
    (torch.float16, 64, True, "simt"),
]


@pytest.mark.parametrize("dtype,d,aligned,route", BWD_ROUTES,
                         ids=[f"{str(r[0])[6:]}_d{r[1]}_"
                              f"{'al' if r[2] else 'unal'}"
                              for r in BWD_ROUTES])
@pytest.mark.parametrize("kernel", ["dq", "dkv"])
def test_bwd_route_is_a_fixed_rule(monkeypatch, kernel, dtype, d, aligned,
                                   route):
    """``bwd_route`` is one rule, and each backward wrapper launches the
    route it names for its inputs (``do`` off a 16-byte base where
    ``aligned`` is False) and counts that route. The launch is replaced by
    a recorder: no kernel runs on the CPU."""
    assert port.bwd_route(dtype, d, aligned) == route
    wrapper = getattr(port, f"flash_bwd_{kernel}_cuda")
    for attr in ("launches", "tc_launches", "simt_launches"):
        monkeypatch.setattr(wrapper, attr, 0)
    seen = []
    monkeypatch.setattr(port, f"flash_bwd_{kernel}_launch",
                        lambda route, *args: seen.append(route) or
                        (None, None))
    q, k, v = (torch.zeros(1, 1, 4, d, dtype=dtype) for _ in range(3))
    buf = torch.zeros(1 + q.numel(), dtype=dtype)
    do = (buf[:-1] if aligned else buf[1:]).view(q.shape)
    assert (do.data_ptr() % 16 == 0) == aligned
    rows = torch.zeros(1, 1, 4)
    wrapper(q, k, v, do, rows, rows, False, 0.5)
    assert seen == [route]
    assert (wrapper.launches, wrapper.tc_launches, wrapper.simt_launches) \
        == (1, int(route == "tc"), int(route == "simt"))


def test_cpu_backward_counts_no_dkv_route_launch():
    """The autograd route on CPU tensors takes the plain backward: no dK/dV
    and no dQ launch, on either route."""
    wrappers = (port.flash_bwd_dkv_cuda, port.flash_bwd_dq_cuda)
    before = [(w.launches, w.tc_launches, w.simt_launches) for w in wrappers]
    q, k, v, m = _inputs(2, 2, 16, 16, 16, masked=False)
    leaves = [_t(x).bfloat16().requires_grad_() for x in (q, k, v)]
    o = port.flash_attention(*leaves, device="cpu")
    grads = torch.autograd.grad(o.float().sum(), leaves)
    assert all(g.dtype == torch.bfloat16 for g in grads)
    assert [(w.launches, w.tc_launches, w.simt_launches)
            for w in wrappers] == before
