"""The port's flash attention against the JAX package's, on the CPU.

The port's plain version (``flash_attention_reference``) is held against
the JAX Pallas forward kernel run in interpret mode
(``_flash_call_fwd(..., interpret=True)``: o and lse) and against the scan
path of the JAX ``flash_attention`` (o). The kernel itself runs only on the
card (``tests/test_torch_gpu.py``); here the wrapper must take the plain
version because the tensors lie on the CPU, and count no launch.

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
