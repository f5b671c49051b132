"""The fp8 storage markers, the BatchNorm of the training path and the
lowp ResNet modules of the port against the JAX package's, on the CPU.

- ``amp.float8_store`` / ``amp.float8_grad_barrier``: bit for bit, forward
  and backward, over every bfloat16 value and a float32 sample, including
  |x| > 448 (where e4m3 saturates or overflows) and inf/NaN; the BN
  residual store, which clips at 448 first, beside it.
- ``nn_ops.batch_norm`` in training mode, with and without a residual,
  relu and the fp8 residual mode: the output, the batch moments, the
  running stats and the VJP.
- The block's ReLU at exact zeros: ``jnp.maximum``'s gradient is 0.5
  there, and so is the port's.
- ``ConvBNLayer`` with the lowp tokens, module by module on identical
  bfloat16 inputs (a 1e-7 difference in a conv sum can flip an e4m3
  rounding, so whole-model checks cannot be exact), and a whole lowp
  ResNet-18 step, held by the share of elements that part.

Tolerances: float32 BN 1e-5 forward (the same one-pass moments, sums in
another order), 1e-4 backward; bfloat16 outputs 2e-2 (an ulp is up to
2^-7 relative); lowp modules 0.1 as ``tests/test_conv_fused.py``'s bf16;
the whole lowp model: at most 2% of the logits and of each gradient
leaf's elements part by more than 0.1 relative to the leaf's largest
magnitude.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from paddle_tpu import amp as jamp
from paddle_tpu import models as jm
from paddle_tpu.models import resnet as jresnet
from paddle_tpu.ops import nn_ops as jn
from paddle_tpu_torch import amp as pamp
from paddle_tpu_torch import models as pm
from paddle_tpu_torch.convert import from_jax_variables, param_tree
from paddle_tpu_torch.models import resnet as presnet
from paddle_tpu_torch.ops import nn_ops as pn


def _all_bf16():
    bits = np.arange(65536, dtype=np.uint16)
    return (bits.view(ml_dtypes.bfloat16),
            torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16))


def _f32_sample():
    rs = np.random.RandomState(0)
    x = (rs.randn(20000) * np.exp(rs.uniform(-12, 8, 20000))).astype(
        np.float32)
    x[:6] = [448.0, 464.0, np.nextafter(np.float32(464), 1e9), -470.0,
             np.inf, np.nan]
    return x, torch.from_numpy(x.copy())


def _same_bits(j, t):
    """Equal values, NaN where NaN, and equal signs (zeros included) where
    not NaN."""
    a = np.asarray(j).astype(np.float32)
    b = t.float().numpy()
    num = ~np.isnan(a)
    return np.array_equal(a, b, equal_nan=True) and \
        np.array_equal(np.signbit(a[num]), np.signbit(b[num]))


@pytest.mark.parametrize("source", ["bf16_all", "f32_sample"])
def test_float8_store_bit_for_bit(source):
    jx, tx = _all_bf16() if source == "bf16_all" else _f32_sample()
    jx = jnp.asarray(jx)
    out, vjp = jax.vjp(jamp.float8_store, jx)
    got = pamp.float8_store(tx)
    assert got.dtype == tx.dtype
    assert _same_bits(out, got)
    # the cotangent: every value again, through e5m2 at scale 256
    (jg,) = vjp(jx)
    leaf = tx.clone().requires_grad_()
    (tg,) = torch.autograd.grad(pamp.float8_store(leaf), leaf, tx)
    assert _same_bits(jg, tg)


def test_float8_grad_barrier_bit_for_bit():
    jx, tx = _all_bf16()
    jx = jnp.asarray(jx)
    _, vjp = jax.vjp(jamp.float8_grad_barrier, jx)
    (jg,) = vjp(jx)
    leaf = tx.clone().requires_grad_()
    y = pamp.float8_grad_barrier(leaf)
    assert torch.equal(y.detach().view(torch.int16), tx.view(torch.int16))
    (tg,) = torch.autograd.grad(y, leaf, tx)
    assert _same_bits(jg, tg)


def test_bn_residual_store_clips_where_float8_store_overflows():
    x = np.array([100.0, 448.0, 460.0, 470.0, -1000.0, 3e4], np.float32)
    j_store = jn._bn_res_store(jnp.asarray(x)).astype(jnp.float32)
    t_store = pn._bn_res_store(torch.from_numpy(x)).float()
    assert _same_bits(j_store, t_store)
    assert t_store.tolist() == [96.0, 448.0, 448.0, 448.0, -448.0, 448.0]
    j_rt = jamp.float8_store(jnp.asarray(x))
    t_rt = pamp.float8_store(torch.from_numpy(x))
    assert _same_bits(j_rt, t_rt)
    assert np.isnan(t_rt[3:].numpy()).all()      # beyond 464: NaN


# -- batch norm --------------------------------------------------------------------


def _bn_case(dt, seed=0):
    rs = np.random.RandomState(seed)
    x = (rs.randn(4, 5, 6, 8) * 3 + 1).astype(np.float32)
    x[0, 0, 0, :] = 0.0
    return (x, (rs.rand(8) + 0.5).astype(np.float32),
            rs.randn(8).astype(np.float32), rs.randn(8).astype(np.float32),
            (rs.rand(8) + 0.5).astype(np.float32),
            rs.randn(4, 5, 6, 8).astype(np.float32),
            rs.randn(4, 5, 6, 8).astype(np.float32))


@pytest.mark.parametrize("lowp", [False, True])
@pytest.mark.parametrize("res", [False, True])
@pytest.mark.parametrize("act", [None, "relu"])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_batch_norm_train_matches_jax(dt, act, res, lowp):
    x, scale, bias, mean, var, r, cot = _bn_case(dt)
    jdt = jnp.float32 if dt == "f32" else jnp.bfloat16
    tdt = torch.float32 if dt == "f32" else torch.bfloat16
    jx, jr, jc = (jnp.asarray(a).astype(jdt) for a in (x, r, cot))
    tx, tr, tc = (torch.from_numpy(np.array(a.astype(jnp.float32))).to(tdt)
                  for a in (jx, jr, jc))

    def jf(x, s, b, rr):
        out, nm, nv = jn.batch_norm(x, s, b, jnp.asarray(mean),
                                    jnp.asarray(var), data_format="NHWC",
                                    act=act, residual=rr if res else None,
                                    lowp_residual=lowp)
        return jnp.sum(out.astype(jnp.float32) * jc.astype(jnp.float32)), \
            (out, nm, nv)

    (_, (jout, jnm, jnv)), jgrads = jax.value_and_grad(
        jf, argnums=(0, 1, 2, 3), has_aux=True)(
        jx, jnp.asarray(scale), jnp.asarray(bias), jr)
    leaves = [t.clone().requires_grad_() for t in
              (tx, torch.from_numpy(scale), torch.from_numpy(bias), tr)]
    out, nm, nv = pn.batch_norm(leaves[0], leaves[1], leaves[2],
                                torch.from_numpy(mean),
                                torch.from_numpy(var), data_format="NHWC",
                                act=act, residual=leaves[3] if res else None,
                                lowp_residual=lowp)
    grads = torch.autograd.grad((out.float() * tc.float()).sum(),
                                leaves if res else leaves[:3])
    f_tol = 1e-5 if dt == "f32" else 2e-2
    b_tol = 1e-4 if dt == "f32" else 2e-2
    assert out.dtype == tdt
    np.testing.assert_allclose(out.float().detach().numpy(),
                               np.asarray(jout.astype(jnp.float32)),
                               rtol=f_tol, atol=f_tol)
    np.testing.assert_allclose(nm.numpy(), np.asarray(jnm), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(nv.numpy(), np.asarray(jnv), rtol=1e-5,
                               atol=1e-5)
    for name, g, jg in zip(("x", "scale", "bias", "residual"), grads,
                           jgrads):
        jg = np.asarray(jnp.asarray(jg).astype(jnp.float32))
        tol = b_tol * max(1.0, np.abs(jg).max())
        np.testing.assert_allclose(g.float().numpy(), jg, rtol=b_tol,
                                   atol=tol, err_msg=name)


def test_batch_norm_inference_branch_matches_jax():
    x, scale, bias, mean, var, r, _ = _bn_case("f32", seed=1)
    ref = jn.batch_norm(jnp.asarray(x), jnp.asarray(scale),
                        jnp.asarray(bias), jnp.asarray(mean),
                        jnp.asarray(var), is_test=True, data_format="NHWC",
                        act="relu", residual=jnp.asarray(r))
    got = pn.batch_norm(torch.from_numpy(x), torch.from_numpy(scale),
                        torch.from_numpy(bias), torch.from_numpy(mean),
                        torch.from_numpy(var), is_test=True,
                        data_format="NHWC", act="relu",
                        residual=torch.from_numpy(r))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_batch_norm_inference_promotes_bfloat16_as_jax_does():
    """A bfloat16 activation through the inference branch with float32
    running stats comes out float32 in both packages (bf16 x minus the
    float32 mean promotes), so an eval forward's later convs see float32
    in the reference as in the port."""
    x, scale, bias, mean, var, _, _ = _bn_case("bf16", seed=2)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    ref = jn.batch_norm(jx, jnp.asarray(scale), jnp.asarray(bias),
                        jnp.asarray(mean), jnp.asarray(var), is_test=True,
                        data_format="NHWC", act="relu")
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).bfloat16()
    got = pn.batch_norm(tx, torch.from_numpy(scale), torch.from_numpy(bias),
                        torch.from_numpy(mean), torch.from_numpy(var),
                        is_test=True, data_format="NHWC", act="relu")
    assert ref.dtype == jnp.float32 and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("lowp", ["", "bnres"])
def test_bnres_token_pins_the_batchnorm_residual_mode(lowp):
    """The "bnres" token turns the layer's BatchNorm to the fp8 residual
    mode and nothing else does: the module's gradient matches JAX's
    ``batch_norm`` with ``lowp_residual`` set as the token says."""
    x, scale, bias, mean, var, _, cot = _bn_case("bf16", seed=2)
    layer = presnet.ConvBNLayer(8, 8, 1, act="relu", lowp=lowp)
    assert layer.bn.lowp_residual == (lowp == "bnres")
    bn = layer.bn
    with torch.no_grad():
        bn.scale.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
        bn.mean.copy_(torch.from_numpy(mean))
        bn.variance.copy_(torch.from_numpy(var))
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    jc = jnp.asarray(cot).astype(jnp.bfloat16)
    jg = jax.grad(lambda a: jnp.sum(jn.batch_norm(
        a, jnp.asarray(scale), jnp.asarray(bias), jnp.asarray(mean),
        jnp.asarray(var), data_format="NHWC", act="relu",
        lowp_residual=lowp == "bnres")[0].astype(jnp.float32)
        * jc.astype(jnp.float32)))(jx)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        torch.bfloat16).requires_grad_()
    tc = torch.from_numpy(np.array(jc.astype(jnp.float32)))
    (tg,) = torch.autograd.grad((bn(tx).float() * tc).sum(), tx)
    jg = np.asarray(jg.astype(jnp.float32))
    np.testing.assert_allclose(tg.float().numpy(), jg, rtol=2e-2,
                               atol=2e-2 * max(1.0, np.abs(jg).max()))


# -- the block's relu ----------------------------------------------------------------


def test_block_relu_gradient_at_exact_zero_is_one_half():
    y = np.array([-1.0, 0.0, 0.0, 2.0], np.float32)
    jg = jax.grad(lambda a: jnp.sum(jnp.maximum(a, 0)))(jnp.asarray(y))
    leaf = torch.from_numpy(y).requires_grad_()
    (tg,) = torch.autograd.grad(presnet._block_relu(leaf).sum(), leaf)
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    assert tg.tolist() == [0.0, 0.5, 0.5, 1.0]


# -- lowp modules ---------------------------------------------------------------------


@pytest.mark.parametrize("lowp", ["grad+out+bnres", "grad", "in+bnres", ""])
@pytest.mark.parametrize("ks,stride", [(1, 1), (3, 2)])
def test_convbn_layer_lowp_matches_jax(ks, stride, lowp):
    """One ConvBNLayer in training mode on identical bfloat16 inputs, the
    fused conv knob on both sides: output, BN running stats and the
    gradients of the input and of every parameter."""
    rs = np.random.RandomState(5)
    x = jnp.asarray(rs.randn(2, 9, 9, 16).astype(np.float32)).astype(
        jnp.bfloat16)
    jmod = jresnet.ConvBNLayer(16, 32, ks, stride=stride, act="relu",
                               lowp=lowp)
    v = jax.tree_util.tree_map(np.asarray,
                               jmod.init(jax.random.PRNGKey(1), x))
    cot = jnp.asarray(rs.randn(2, (9 - 1) // stride + 1,
                               (9 - 1) // stride + 1, 32).astype(
        np.float32)).astype(jnp.bfloat16)

    def jf(p, x):
        out, st = jmod.apply({"params": p, "state": v["state"]}, x,
                             training=True, mutable=True)
        return jnp.sum(out.astype(jnp.float32) *
                       cot.astype(jnp.float32)), (out, st)

    with jn.conv_fused():
        (_, (jout, jst)), (jgp, jgx) = jax.value_and_grad(
            jf, argnums=(0, 1), has_aux=True)(v["params"], x)
    pmod = presnet.ConvBNLayer(16, 32, ks, stride=stride, act="relu",
                               lowp=lowp)
    from_jax_variables(v, pmod)
    pmod.train()
    tx = torch.from_numpy(np.array(x.astype(jnp.float32))).to(
        torch.bfloat16).requires_grad_()
    tcot = torch.from_numpy(np.array(cot.astype(jnp.float32)))
    params = param_tree(pmod)
    with pn.conv_fused():
        out = pmod(tx)
        grads = torch.autograd.grad((out.float() * tcot).sum(),
                                    [tx] + list(params.values()))

    def close(a, b, name):
        b = np.asarray(jnp.asarray(b).astype(jnp.float32))
        np.testing.assert_allclose(a.detach().float().numpy(), b, rtol=0.1,
                                   atol=0.1 * max(1.0, np.abs(b).max()),
                                   err_msg=name)

    close(out, jout, "out")
    close(grads[0], jgx, "dx")
    jflat = {"conv/weight": jgp["conv"]["weight"],
             "bn/scale": jgp["bn"]["scale"], "bn/bias": jgp["bn"]["bias"]}
    for (name, _), g in zip(params.items(), grads[1:]):
        close(g, jflat[name], name)
    close(pmod.bn.mean, jst["bn"]["mean"], "mean")
    close(pmod.bn.variance, jst["bn"]["variance"], "variance")


def test_resnet18_lowp_step_parts_in_few_elements():
    """The shipped lowp default on a whole ResNet-18 in bfloat16: e4m3
    roundings can flip where the two sides' float32 sums differ in the last
    bit, so the step is held by the share of elements that part."""
    lowp = "grad+out+blk+stem+bnres"
    rs = np.random.RandomState(0)
    x = jnp.asarray(rs.randn(2, 64, 64, 3).astype(np.float32)).astype(
        jnp.bfloat16)
    labels = np.array([1, 7])
    jmod = jm.resnet18(num_classes=10, lowp=lowp)
    v = jax.tree_util.tree_map(np.asarray,
                               jmod.init(jax.random.PRNGKey(0), x))

    def jf(p):
        logits, _ = jmod.apply({"params": p, "state": v["state"]}, x,
                               training=True, mutable=True)
        logp = jax.nn.log_softmax(logits.astype(jnp.float32))
        return -jnp.mean(jnp.take_along_axis(
            logp, jnp.asarray(labels)[:, None], axis=-1)), logits

    # op by op, as the port runs: under jit XLA's CPU fusions compute
    # bf16 elementwise chains in float32 and round once at the end
    (jloss, jlogits), jgrads = jax.value_and_grad(jf, has_aux=True)(
        v["params"])
    pmod = pm.resnet18(num_classes=10, lowp=lowp, device="cpu")
    from_jax_variables(v, pmod)
    params = param_tree(pmod)
    tx = torch.from_numpy(np.array(x.astype(jnp.float32))).to(torch.bfloat16)
    with pn.conv_fused():
        logits = pmod(tx)
        logp = torch.log_softmax(logits.float(), dim=-1)
        loss = -logp[torch.arange(2), torch.from_numpy(labels)].mean()
        grads = torch.autograd.grad(loss, list(params.values()))

    def parted(a, b):
        a = a.detach().float().numpy()
        b = np.asarray(jnp.asarray(b).astype(jnp.float32))
        return np.mean(np.abs(a - b) > 0.1 * max(np.abs(b).max(), 1e-30))

    assert np.isfinite(loss.item())
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=0.05)
    assert parted(logits, jlogits) <= 0.02
    jflat = dict((k, v_) for k, v_ in _flat(jgrads))
    shares = {k: parted(g, jflat[k]) for k, g in zip(params, grads)}
    worst = max(shares, key=shares.get)
    assert shares[worst] <= 0.02, (worst, shares[worst])


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), v
