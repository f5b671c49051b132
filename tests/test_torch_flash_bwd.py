"""The port's flash-attention backward and token loss against the JAX
package's, on the CPU.

The plain version of the two backward kernels
(``flash_attention_bwd_reference``), and the autograd route that takes it
for CPU tensors, are held against ``jax.grad`` of
``flash_attention_trainable`` (its Pallas forward and backward kernels in
interpret mode, as the JAX package's own tests run them) and against
``jax.grad`` of the scan path of the JAX ``flash_attention``. Every query
row keeps at least one key: the training path has no all-pad rows, and the
JAX trainable route declares them unsupported.

Tolerance: float32, atol = rtol = 1e-5 for attention gradients (the same
float32 function; the summation order of the products and the exp
implementation differ, observed differences ~1e-6), 1e-6 for the loss and
its gradient (row reductions over a vocab of 64).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels.attention import flash_attention as jax_flash
from paddle_tpu.kernels.attention import flash_attention_trainable
from paddle_tpu.ops.loss import token_softmax_cross_entropy as jax_xent
from paddle_tpu_torch.kernels import attention as port
from paddle_tpu_torch.ops.loss import token_softmax_cross_entropy

TOL = dict(rtol=1e-5, atol=1e-5)

# (name, b, h, tq, tk, d, causal, masked, block): B=2, H=2, T=16..64
CASES = [
    ("unmasked", 2, 2, 32, 32, 16, False, False, 16),
    ("masked", 2, 2, 16, 48, 8, False, True, 16),
    ("causal", 2, 2, 64, 64, 32, True, False, 32),
    ("causal_masked", 2, 2, 32, 32, 8, True, True, 16),
]


def _inputs(b, h, tq, tk, d, masked, seed=0):
    rs = np.random.RandomState(seed)
    q, do = (rs.randn(b, h, tq, d).astype(np.float32) for _ in range(2))
    k, v = (rs.randn(b, h, tk, d).astype(np.float32) for _ in range(2))
    m = None
    if masked:
        m = rs.rand(b, tk) > 0.4
        m[:, 0] = True     # every query row keeps a key
    return q, k, v, do, m


def _t(x):
    return None if x is None else torch.from_numpy(x)


def _j(x):
    return None if x is None else jnp.asarray(x)


def _jax_grads(fn, q, k, v, do):
    return jax.grad(lambda q, k, v: jnp.sum(fn(q, k, v) * do),
                    argnums=(0, 1, 2))(_j(q), _j(k), _j(v))


def _plain_grads(q, k, v, do, m, causal):
    """The plain version of the kernels, fed as the wrapper feeds them."""
    scale = q.shape[-1] ** -0.5
    o, lse = port.flash_attention_reference(_t(q), _t(k), _t(v), causal,
                                            scale, _t(m))
    dvec = (_t(do) * o).sum(-1)
    return port.flash_attention_bwd_reference(_t(q), _t(k), _t(v), _t(do),
                                              lse, dvec, causal, scale,
                                              _t(m))


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_plain_bwd_matches_pallas_interpret(case):
    _, b, h, tq, tk, d, causal, masked, blk = case
    q, k, v, do, m = _inputs(b, h, tq, tk, d, masked)
    scale = d ** -0.5
    want = _jax_grads(lambda q, k, v: flash_attention_trainable(
        q, k, v, _j(m), causal, scale, blk, blk), q, k, v, do)
    got = _plain_grads(q, k, v, do, m, causal)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_autograd_route_matches_scan_path_grad(case):
    _, b, h, tq, tk, d, causal, masked, blk = case
    q, k, v, do, m = _inputs(b, h, tq, tk, d, masked, seed=1)
    want = _jax_grads(lambda q, k, v: jax_flash(
        q, k, v, causal=causal, kv_mask=_j(m), block_k=blk, block_q=blk),
        q, k, v, do)
    leaves = [_t(x).requires_grad_() for x in (q, k, v)]
    before = port.flash_attention.launches
    o = port.flash_attention(*leaves, causal=causal, kv_mask=_t(m),
                             device="cpu")
    got = torch.autograd.grad(o, leaves, _t(do))
    assert port.flash_attention.launches == before   # plain on the CPU
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_all_masked_row_keeps_the_jax_arithmetic():
    """lse ~= -1e30 (float32 absorbs log Tk), so p = 1 for every key, as
    in the JAX kernels; the row's dq is scale * sum_k ds k with
    ds = dp - dvec."""
    q, k, v, do, m = _inputs(1, 1, 4, 8, 4, masked=True)
    m[0] = False
    scale = 0.5
    o, lse = port.flash_attention_reference(_t(q), _t(k), _t(v), False,
                                            scale, _t(m))
    assert (lse < -1e29).all()
    dvec = (_t(do) * o).sum(-1)
    dq, dk, dv = port.flash_attention_bwd_reference(
        _t(q), _t(k), _t(v), _t(do), lse, dvec, False, scale, _t(m))
    dp = _t(do) @ _t(v).transpose(-1, -2)
    ds = dp - dvec[..., None]
    np.testing.assert_allclose(dq.numpy(), (ds @ _t(k) * scale).numpy(),
                               **TOL)
    np.testing.assert_allclose(dv.numpy(), np.broadcast_to(
        do.sum(axis=2, keepdims=True), dv.shape), **TOL)


@pytest.mark.parametrize("eps", [0.0, 0.1])
def test_token_loss_value_and_grad_match(eps):
    rs = np.random.RandomState(2)
    logits = (rs.randn(3, 5, 64) * 3).astype(np.float32)
    labels = rs.randint(0, 64, (3, 5)).astype(np.int32)
    g = rs.rand(3, 5).astype(np.float32)
    want, vjp = jax.vjp(lambda x: jax_xent(x, jnp.asarray(labels), eps),
                        jnp.asarray(logits))
    (want_grad,) = vjp(jnp.asarray(g))
    x = torch.from_numpy(logits).requires_grad_()
    got = token_softmax_cross_entropy(x, torch.from_numpy(labels), eps)
    (got_grad,) = torch.autograd.grad(got, x, torch.from_numpy(g))
    assert got.dtype == torch.float32 and got.shape == (3, 5)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got_grad.numpy(), np.asarray(want_grad),
                               rtol=1e-6, atol=1e-6)


def test_token_loss_grad_keeps_the_logits_dtype():
    x = torch.randn(2, 3, 16, dtype=torch.bfloat16, requires_grad=True)
    nll = token_softmax_cross_entropy(x, torch.zeros(2, 3, dtype=torch.int32),
                                      0.1)
    (gx,) = torch.autograd.grad(nll.sum(), x)
    assert nll.dtype == torch.float32 and gx.dtype == torch.bfloat16
