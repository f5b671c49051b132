"""The port's ResNet slice against the JAX package's, on the CPU.

- The ops: ``conv2d_stem_s2d`` (even and odd sizes), ``pool2d`` (max with
  windows of tied values, avg, padding and ceil_mode) and ``conv2d``'s
  routing.
- A ResNet-18 training step, the JAX side under ``conv_fused()`` (its
  Pallas kernels in interpret mode, as ``tests/test_conv_fused.py:224``
  runs them), the port's with ``nn_ops.conv_fused()`` (the kernels' plain
  versions): logits, loss, every gradient leaf, the BN running stats and
  the parameters after one Momentum(0.1, 0.9) step.
- ResNet-50 in float32, ``lowp=""``, the JAX side on its XLA route: the
  same checks.
- The eval forward of ResNet-18 with the knob on (the conv+BN+relu
  epilogue fusion) on both sides.

The JAX weights are carried across with ``convert.from_jax_variables``;
inputs come from numpy with a seed. The training steps use batch 2 x
64x64: at 32x32 the last stage's BatchNorm normalises two values a
channel, and there ResNet-50's last block in the port's float32 parts
from a float64 evaluation of the same network by 0.67 (relative L2;
ill-conditioned for any two implementations); at 64x64 (8 values) by
1.3e-4.

Tolerances (float32): ResNet-18's logits, loss, BN running stats and the
parameters after the step 1e-4; each gradient leaf within 1e-3 of its own
norm (relative L2; the same float32 function with sums in another order,
through ~20 BatchNorms). ResNet-50: 1e-3. At batch 2 its gradients
are ill-conditioned in float32 on both sides, so each leaf is held to a
float64 gradient of the same step computed by a functional network that
shares no code with either side (``_float64_grads``): the port's float32
leaf may lie at most twice as far from it as the JAX leaf does, and the
two sides at most twice their summed distances apart. Measured on the CPU
(median leaf): JAX on its XLA route 3.3e-2 from it (eagerly too, 3.8e-2),
the port 1.2e-2; the worst leaf's ratio is 1.12. Its parameters after
the step part by at most lr times the gradients' difference (Momentum's
first step is p - lr * g on both sides). Eval logits rtol 2e-3, atol 2e-4 as in
``tests/test_conv_fused.py:224``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from paddle_tpu import models as jm
from paddle_tpu import optimizer as jopt
from paddle_tpu.ops import nn_ops as jn
from paddle_tpu_torch import models as pm
from paddle_tpu_torch import optimizer as popt
from paddle_tpu_torch.bench import loss_fn
from paddle_tpu_torch.convert import (from_jax_variables, param_tree,
                                      state_tree)
from paddle_tpu_torch.kernels import conv_fused as pcf
from paddle_tpu_torch.ops import nn_ops as pn


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(v)


def _t(a):
    return torch.from_numpy(np.array(a))


# -- ops ----------------------------------------------------------------------


@pytest.mark.parametrize("hw", [(16, 16), (15, 17)])
def test_conv2d_stem_s2d_matches_jax(hw):
    rs = np.random.RandomState(0)
    x = rs.randn(2, *hw, 3).astype(np.float32)
    w = rs.randn(8, 3, 7, 7).astype(np.float32)
    ref = jn.conv2d_stem_s2d(jnp.asarray(x), jnp.asarray(w))
    got = pn.conv2d_stem_s2d(_t(x), _t(w))
    assert tuple(got.shape) == ref.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    # and it is the 7x7/s2/pad-3 conv
    plain = pn.conv2d(_t(x), _t(w), stride=2, padding=3, data_format="NHWC",
                      use_pallas=False)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=1e-5,
                               atol=1e-5)


def _tied_input():
    """Post-relu activations: windows of exact zeros and repeated values."""
    rs = np.random.RandomState(1)
    x = np.maximum(rs.randn(2, 9, 10, 4), 0).astype(np.float32)
    x[0, 2:5, 2:6, :] = 0.0
    x[1, :3, :3, 1] = 1.5
    return x


@pytest.mark.parametrize("cfg", [
    dict(pool_size=3, pool_type="max", pool_stride=2, pool_padding=1),
    dict(pool_size=2, pool_type="max", pool_stride=2, ceil_mode=True),
    dict(pool_size=3, pool_type="avg", pool_stride=2, pool_padding=1),
    dict(pool_size=3, pool_type="avg", pool_stride=2, pool_padding=1,
         exclusive=False),
    dict(pool_size=2, pool_type="avg", pool_stride=2, ceil_mode=True),
    dict(global_pooling=True, pool_type="avg"),
], ids=["max_resnet", "max_ceil", "avg_excl", "avg_incl", "avg_ceil",
        "global_avg"])
def test_pool2d_matches_jax_with_tied_windows(cfg):
    """Forward and gradient; a max window of ties sends the gradient to
    its first maximum on both sides."""
    x = _tied_input()
    cot = np.random.RandomState(2).randn(
        *np.asarray(jn.pool2d(jnp.asarray(x), data_format="NHWC",
                              **cfg)).shape).astype(np.float32)

    def jf(a):
        return jnp.sum(jn.pool2d(a, data_format="NHWC", **cfg) * cot)

    ref = jn.pool2d(jnp.asarray(x), data_format="NHWC", **cfg)
    jg = jax.grad(jf)(jnp.asarray(x))
    tx = _t(x).requires_grad_()
    got = pn.pool2d(tx, data_format="NHWC", **cfg)
    (tg,) = torch.autograd.grad((got * _t(cot)).sum(), tx)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_conv2d_routing_matches_jax(use_pallas):
    rs = np.random.RandomState(3)
    x = rs.randn(2, 9, 9, 8).astype(np.float32)
    w = rs.randn(16, 8, 3, 3).astype(np.float32)
    b = rs.randn(16).astype(np.float32)
    for pad, stride in (("SAME", 2), (1, 1), ([0, 1, 1, 0], 2)):
        ref = jn.conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                        stride, pad, data_format="NHWC", act="relu",
                        use_pallas=use_pallas)
        got = pn.conv2d(_t(x), _t(w), _t(b), stride, pad,
                        data_format="NHWC", act="relu",
                        use_pallas=use_pallas)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-5)


def test_conv_fused_knob_scopes_like_the_jax_one():
    assert not pn.CONV_FUSED
    with pn.conv_fused():
        assert pn.CONV_FUSED
        pn.set_conv_fused(False)            # the scope outranks the setter
        assert pn.CONV_FUSED
    assert not pn.CONV_FUSED


# -- whole-model steps ------------------------------------------------------------

B, HW, CLASSES = 2, 64, 10
LR = 0.1


def _batch():
    rs = np.random.RandomState(0)
    return rs.randn(B, HW, HW, 3).astype(np.float32), np.array([1, 7])


def _jax_step(model, variables, x, labels, fused):
    opt = jopt.Momentum(learning_rate=LR, momentum=0.9)

    def lf(p):
        logits, ns = model.apply({"params": p, "state": variables["state"]},
                                 x, training=True, mutable=True)
        logp = jax.nn.log_softmax(logits.astype(jnp.float32))
        loss = -jnp.mean(jnp.take_along_axis(logp, labels[:, None], axis=-1))
        return loss, (logits, ns)

    with jn.conv_fused(fused):
        (loss, (logits, ns)), grads = jax.jit(
            jax.value_and_grad(lf, has_aux=True))(variables["params"])
    new_p, _ = opt.apply_gradients(variables["params"], grads,
                                   opt.init(variables["params"]))
    return {"loss": float(loss), "logits": np.asarray(logits),
            "grads": dict(_flat(grads)), "state": dict(_flat(ns)),
            "params": dict(_flat(new_p))}


def _port_step(model, x, labels):
    model.train()
    params = param_tree(model)
    opt = popt.Momentum(learning_rate=LR, momentum=0.9)
    state = opt.init(params)

    def fn(p, x, labels):
        logits = model(x)
        logp = torch.log_softmax(logits.float(), dim=-1)
        return -torch.mean(torch.gather(logp, 1, labels[:, None])), logits

    with pn.conv_fused():
        loss, logits = fn(params, _t(x), torch.from_numpy(labels))
        grads = torch.autograd.grad(loss, list(params.values()))
    opt.apply_gradients(params, dict(zip(params, grads)), state)
    return {"loss": loss.item(), "logits": logits.detach().numpy(),
            "grads": {k: g.numpy() for k, g in zip(params, grads)},
            "state": {k: b.numpy() for k, b in state_tree(model).items()},
            "params": {k: p.detach().numpy() for k, p in params.items()}}


def _run(depth, fused):
    x, labels = _batch()
    jmodel = jm.resnet18(num_classes=CLASSES) if depth == 18 else \
        jm.resnet50(num_classes=CLASSES)
    variables = jax.tree_util.tree_map(
        np.asarray, jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    ref = _jax_step(jmodel, variables, jnp.asarray(x), jnp.asarray(labels),
                    fused)
    pmodel = pm.ResNet(depth, num_classes=CLASSES, device="cpu")
    from_jax_variables(variables, pmodel)
    got = _port_step(pmodel, x, labels)
    return ref, got, variables, pmodel


@pytest.fixture(scope="module")
def resnet18_run():
    return _run(18, fused=True)


@pytest.fixture(scope="module")
def resnet50_run():
    return _run(50, fused=False)


def _rel(a, b):
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _check_step(ref, got, tol, floor=None):
    """Every check of the step at ``tol``; each gradient leaf within 1e-3
    relative L2, or, given ``floor`` (independent float64 gradients of the
    same step), the port's leaf no further from it than twice the JAX
    leaf, and the two within twice their summed distances."""
    assert np.isfinite(got["loss"])
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=tol, atol=tol)
    np.testing.assert_allclose(got["logits"], ref["logits"], rtol=tol,
                               atol=tol)
    assert set(got["grads"]) == set(ref["grads"])
    for k, jg in ref["grads"].items():
        pg = got["grads"][k]
        if floor is None:
            assert _rel(pg, jg) < 1e-3, k
        else:
            j_err, p_err = _rel(jg, floor[k]), _rel(pg, floor[k])
            assert _rel(pg, jg) <= 2 * (j_err + p_err) + 1e-6, k
            assert p_err <= 2 * j_err + 1e-6, k
    assert set(got["state"]) == set(ref["state"])
    for k, v in ref["state"].items():
        np.testing.assert_allclose(got["state"][k], v, rtol=tol, atol=tol,
                                   err_msg=k)
    for k, v in ref["params"].items():
        if floor is None:
            np.testing.assert_allclose(got["params"][k], v, rtol=tol,
                                       atol=tol, err_msg=k)
        else:
            # Momentum's first step is p - lr * g on both sides: the
            # parameters part by lr times the (gated) gradients' difference
            dg = np.abs(got["grads"][k] - ref["grads"][k])
            dp = np.abs(got["params"][k] - v)
            assert np.all(dp <= LR * dg * (1 + 1e-5) + 1e-6), k


def _float64_grads(variables):
    """The gradients of the same ResNet-50 step in float64, from a
    functional network written here with ``torch.nn.functional`` alone
    (NCHW ``F.conv2d``, ``F.batch_norm`` on the batch moments,
    ``F.max_pool2d``) over the JAX parameter tree: it shares no code with
    either side, so a fault in the port's block wiring, BatchNorm or
    strided 1x1 convs moves the port away from it, not it with the
    port."""
    x, labels = _batch()
    p = {k: torch.from_numpy(v.astype(np.float64)).requires_grad_()
         for k, v in _flat(variables["params"])}

    def cbn(h, name, stride, pad, relu):
        h = F.conv2d(h, p[name + "/conv/weight"], stride=stride,
                     padding=pad)
        h = F.batch_norm(h, None, None, p[name + "/bn/scale"],
                         p[name + "/bn/bias"], training=True, eps=1e-5)
        return F.relu(h) if relu else h

    h = torch.from_numpy(x.astype(np.float64)).permute(0, 3, 1, 2)
    h = F.max_pool2d(cbn(h, "stem", 2, 3, True), 3, 2, 1)
    for i, n in enumerate((3, 4, 6, 3)):
        for j in range(n):
            name, st = f"stage{i}_{j}", 2 if i and not j else 1
            s = cbn(h, name + "/short", st, 0, False) \
                if name + "/short/conv/weight" in p else h
            y = cbn(h, name + "/conv0", 1, 0, True)
            y = cbn(y, name + "/conv1", st, 1, True)
            h = F.relu(cbn(y, name + "/conv2", 1, 0, False) + s)
    logits = h.mean(dim=(2, 3)) @ p["head/weight"] + p["head/bias"]
    logp = torch.log_softmax(logits, dim=-1)
    loss = -logp[torch.arange(B), torch.from_numpy(labels)].mean()
    grads = torch.autograd.grad(loss, list(p.values()))
    return {k: g.numpy() for k, g in zip(p, grads)}


def test_resnet18_train_step_matches_jax_conv_fused(resnet18_run):
    ref, got, _, _ = resnet18_run
    _check_step(ref, got, 1e-4)


def test_resnet50_train_step_matches_jax_xla_route(resnet50_run):
    ref, got, variables, _ = resnet50_run
    _check_step(ref, got, 1e-3, floor=_float64_grads(variables))


def test_resnet18_eval_forward_fused_matches_jax(resnet18_run):
    """Inference with the knob on: every non-stem ConvBNLayer fuses its
    BatchNorm's folded affine and relu into the conv's epilogue. The state
    is the one after the training step, so the folding is not trivial."""
    ref, _, variables, pmodel = resnet18_run
    rs = np.random.RandomState(4)
    x = rs.randn(2, 32, 32, 3).astype(np.float32)
    state = {}
    for path, v in ref["state"].items():
        node = state
        *head, leaf = path.split("/")
        for h in head:
            node = node.setdefault(h, {})
        node[leaf] = v
    jmodel = jm.resnet18(num_classes=CLASSES)
    with jn.conv_fused():
        jout = jmodel.apply({"params": variables["params"], "state": state},
                            jnp.asarray(x))
    from_jax_variables({"params": variables["params"], "state": state},
                       pmodel)
    pmodel.eval()
    before = pcf.convkxk.launches
    with pn.conv_fused(), torch.no_grad():
        pout = pmodel(_t(x))
    assert pcf.convkxk.launches == before       # the CPU takes the plain
    np.testing.assert_allclose(pout.numpy(), np.asarray(jout), rtol=2e-3,
                               atol=2e-4)


def test_param_tree_names_follow_the_jax_tree(resnet50_run):
    ref, got, _, pmodel = resnet50_run
    assert list(got["params"]) == sorted(ref["params"])
    assert "stage2_5/conv1/conv/weight" in got["params"]
    assert "stage3_0/short/bn/variance" in got["state"]
    assert sum(p.numel() for p in pmodel.parameters()) == \
        sum(v.size for v in ref["params"].values())


def test_bench_loss_is_the_mean_nll_of_float32_logits():
    model = pm.resnet18(num_classes=CLASSES, device="cpu")
    x, labels = _batch()
    with torch.no_grad():
        loss = loss_fn(model)(None, _t(x), torch.from_numpy(labels))
        logits = model(_t(x)).float()
    ref = -torch.log_softmax(logits, -1)[torch.arange(B),
                                         torch.from_numpy(labels)].mean()
    assert loss.dtype == torch.float32
    np.testing.assert_allclose(loss.item(), ref.item(), rtol=1e-6)
