"""The port's LayerNorm op, layer and row-norm kernel route against the JAX
package's, on the CPU.

The JAX side runs ``nn_ops.layer_norm`` with ``use_pallas=True`` (the
Pallas row-norm kernel of ``kernels/layer_norm.py``, in interpret mode off
the TPU, as ``tests/test_kernels_interpret.py:11`` runs it) and with
``use_pallas=False`` (the plain route); the port runs the same calls, its
kernel route taking the plain version ``fused_layer_norm_reference`` on
CPU tensors. bf16 runs eagerly on the JAX side.

Tolerances: float32 within 1e-5 (rtol = atol, the tolerance of
``tests/test_kernels_interpret.py:22``); bfloat16 within one bf16 ulp of
the JAX value (both compute the same float32 function, summed in another
order, and round once).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import kernels as jkernels
from paddle_tpu.nn import layers as jlayers
from paddle_tpu.ops import nn_ops as jnn_ops
from paddle_tpu_torch.kernels import layer_norm as pln
from paddle_tpu_torch.nn.layers import LayerNorm
from paddle_tpu_torch.ops import nn_ops

SHAPES = [(4, 10), (32, 64), (100, 96), (7, 10), (1, 1000)]
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(shape, dname, affine, seed=0):
    rs = np.random.RandomState(seed)
    x = (rs.randn(*shape) * 3 + 1).astype(np.float32)
    d = shape[-1]
    s = rs.uniform(0.5, 1.5, d).astype(np.float32) if affine else None
    b = rs.randn(d).astype(np.float32) if affine else None
    jdt, tdt = DTYPES[dname]
    jx = jnp.asarray(x).astype(jdt)
    tx = torch.from_numpy(x).to(tdt)
    js, jb = (None if a is None else jnp.asarray(a) for a in (s, b))
    ts, tb = (None if a is None else torch.from_numpy(a) for a in (s, b))
    return (jx, js, jb), (tx, ts, tb)


def _close(got, want, dname):
    got = got.float().numpy()
    want = np.asarray(want.astype(jnp.float32))
    if dname == "f32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        return
    # one bf16 ulp of the JAX value: 2^(exponent - 7)
    mag = np.maximum(np.abs(want), np.finfo(np.float32).tiny)
    ulp = 2.0 ** (np.floor(np.log2(mag)) - 7)
    assert np.all(np.abs(got - want) <= ulp), np.max(np.abs(got - want)
                                                      / ulp)


@pytest.mark.parametrize("affine", [True, False], ids=["affine", "bare"])
@pytest.mark.parametrize("eps", [1e-5, 1e-12], ids=["eps1e-5", "eps1e-12"])
@pytest.mark.parametrize("dname", ["f32", "bf16"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_op_matches_jax_on_both_routes(shape, dname, eps, affine):
    (jx, js, jb), (tx, ts, tb) = _inputs(shape, dname, affine)
    for use_pallas in (True, False):
        want = jnn_ops.layer_norm(jx, js, jb, 1, eps, use_pallas=use_pallas)
        got = nn_ops.layer_norm(tx, ts, tb, 1, eps, use_pallas=use_pallas)
        assert got.dtype == tx.dtype and got.shape == tx.shape
        _close(got, want, dname)


def test_float16_kernel_route_matches_jax():
    rs = np.random.RandomState(3)
    x = rs.randn(16, 40).astype(np.float16)
    s, b = rs.randn(40).astype(np.float32), rs.randn(40).astype(np.float32)
    want = jkernels.fused_layer_norm(jnp.asarray(x), jnp.asarray(s),
                                     jnp.asarray(b), interpret=True)
    got = pln.fused_layer_norm(torch.from_numpy(x), torch.from_numpy(s),
                               torch.from_numpy(b), device="cpu")
    assert got.dtype == torch.float16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want).astype(np.float32),
                               rtol=1e-3, atol=1e-3)   # one float16 ulp


@pytest.fixture
def routes(monkeypatch):
    """Record which route each side takes: the kernel's entry point
    (JAX ``kernels.fused_layer_norm``, the port's plain version of the
    kernel behind ``fused_layer_norm``) or the op's own plain code."""
    taken = {"jax": 0, "port": 0}
    jreal, preal = jkernels.fused_layer_norm, pln.fused_layer_norm_reference

    def jfake(*a, **kw):
        taken["jax"] += 1
        return jreal(*a, **kw)

    def pfake(*a, **kw):
        taken["port"] += 1
        return preal(*a, **kw)

    monkeypatch.setattr(jkernels, "fused_layer_norm", jfake)
    monkeypatch.setattr(pln, "fused_layer_norm_reference", pfake)
    return taken


@pytest.mark.parametrize("shape,begin,use_pallas,kernel", [
    ((6, 16), 1, True, True),
    ((2, 3, 16), 2, True, False),
    ((6, 16), 1, False, False),
    ((6, 16), 0, True, False),
], ids=["2d_pallas", "3d_pallas", "2d_plain", "2d_begin0"])
def test_routing_follows_the_reference(routes, shape, begin, use_pallas,
                                       kernel):
    rs = np.random.RandomState(1)
    x = rs.randn(*shape).astype(np.float32)
    norm = shape[begin:]
    s = rs.randn(*norm).astype(np.float32)
    want = jnn_ops.layer_norm(jnp.asarray(x), jnp.asarray(s), None, begin,
                              use_pallas=use_pallas)
    got = nn_ops.layer_norm(torch.from_numpy(x), torch.from_numpy(s), None,
                            begin, use_pallas=use_pallas)
    assert routes == {"jax": int(kernel), "port": int(kernel)}
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("scale,shift", [(True, True), (False, True),
                                         (True, False), (False, False)])
def test_layer_matches_jax_layer(routes, scale, shift):
    """Parameter tree (names, float32, ones/zeros, absent when off), the
    epsilon, and the route: a 2-D input takes the kernel's, a 3-D one the
    plain route."""
    jlayer = jlayers.LayerNorm(24, epsilon=1e-12, scale=scale, shift=shift,
                               use_pallas=True)
    rs = np.random.RandomState(2)
    x3 = rs.randn(2, 5, 24).astype(np.float32) * 4
    x2 = x3.reshape(10, 24)
    variables = jlayer.init(jax.random.PRNGKey(0), jnp.asarray(x2))
    jparams = variables["params"]
    layer = LayerNorm(24, epsilon=1e-12, scale=scale, shift=shift,
                      use_pallas=True)
    got_params = dict(layer.named_parameters())
    assert set(got_params) == set(jparams)
    for k, p in got_params.items():
        assert p.dtype == torch.float32
        np.testing.assert_array_equal(p.detach().numpy(),
                                      np.asarray(jparams[k]))
    for x, kernel in ((x2, 1), (x3, 0)):
        before = dict(routes)
        want = jlayer.apply(variables, jnp.asarray(x))
        got = layer(torch.from_numpy(x))
        assert routes["jax"] - before["jax"] == kernel
        assert routes["port"] - before["port"] == kernel
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("wrt", ["x", "scale"])
def test_kernel_route_gradient_is_refused_on_both_sides(wrt):
    rs = np.random.RandomState(4)
    x = rs.randn(8, 32).astype(np.float32)
    s, b = rs.randn(32).astype(np.float32), rs.randn(32).astype(np.float32)
    argnum = 0 if wrt == "x" else 1
    with pytest.raises(ValueError, match="Linearization failed"):
        jax.grad(lambda x, s: jnp.sum(jnn_ops.layer_norm(
            x, s, jnp.asarray(b), use_pallas=True) ** 2),
            argnums=argnum)(jnp.asarray(x), jnp.asarray(s))
    tx = torch.from_numpy(x).requires_grad_(wrt == "x")
    ts = torch.from_numpy(s).requires_grad_(wrt == "scale")
    y = nn_ops.layer_norm(tx, ts, torch.from_numpy(b), use_pallas=True)
    with pytest.raises(RuntimeError, match="no gradient"):
        torch.autograd.grad(y.square().sum(), tx if wrt == "x" else ts)


def test_plain_route_gradients_match_jax():
    """``use_pallas`` on a 3-D input keeps the plain route, which trains:
    the gradients with respect to x, scale and bias within 1e-5."""
    rs = np.random.RandomState(5)
    x = rs.randn(2, 6, 32).astype(np.float32)
    s, b = rs.randn(32).astype(np.float32), rs.randn(32).astype(np.float32)
    w = rs.randn(2, 6, 32).astype(np.float32)

    def jloss(x, s, b):
        return jnp.sum(jnn_ops.layer_norm(x, s, b, 2, 1e-12,
                                          use_pallas=True) * w)

    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (x, s, b)))
    ts = [torch.from_numpy(a).requires_grad_() for a in (x, s, b)]
    out = nn_ops.layer_norm(*ts, 2, 1e-12, use_pallas=True)
    got = torch.autograd.grad((out * torch.from_numpy(w)).sum(), ts)
    for g, r in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=1e-5)


def test_block_rows_is_accepted_and_ignored():
    rs = np.random.RandomState(6)
    x = torch.from_numpy(rs.randn(12, 20).astype(np.float32))
    ref = pln.fused_layer_norm(x, device="cpu")
    assert torch.equal(pln.fused_layer_norm(x, block_rows=4, device="cpu"),
                       ref)
    want = jkernels.fused_layer_norm(jnp.asarray(x.numpy()), block_rows=4,
                                     interpret=True)
    np.testing.assert_allclose(ref.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_cuda_wrapper_raises_on_cpu_tensors_and_bad_operands():
    """The kernel's wrapper never falls back: a CPU tensor, a 3-D x, a
    scale of the wrong size or type are refused before any build; and
    the public entry's default device needs a card."""
    x = torch.randn(4, 8)
    with pytest.raises(ValueError, match="CUDA tensor"):
        pln.layer_norm_cuda(x)
    with pytest.raises(ValueError):
        pln.layer_norm_cuda(x[None])
    with pytest.raises(ValueError):
        pln.fused_layer_norm(x[None], device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pln.fused_layer_norm(x)
    assert pln.fused_layer_norm.launches == 0
