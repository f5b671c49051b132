"""The port's fused max pool against the JAX package's, on the CPU.

- The plain version (``max_pool2d_fused`` on CPU tensors) against the JAX
  kernel in interpret mode (``_pool_fwd_impl`` / ``max_pool2d_fused(...,
  interpret=True)``, as ``tests/test_kernels_interpret.py:159-177`` runs
  it): out and the int32 argmax exactly, dx within 1e-6 as that test holds
  it. Cases: 3x3/s2/p1 (the ResNet stem's), 2x2/s2/p0, odd H and W, bf16
  and float32, windows of ties, and NaN / -inf / finfo.min entries (which
  the kernel never picks).
- ``pool2d``'s routing as ``tests/test_kernels_interpret.py:179-213``
  holds the JAX op's: the knob on and off, avg and NCHW pools on the
  plain route.
- A ResNet-18 training step at batch 2 x 64x64 with the conv and pool
  knobs on, against JAX under ``conv_fused()`` and ``pool_fused_scope()``
  (its Pallas kernels in interpret mode): logits, loss and the parameters
  after one Momentum(0.1, 0.9) step within 1e-4, each gradient leaf within
  1e-3 of its norm (relative L2), the tolerances of
  ``tests/test_torch_resnet.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import models as jm
from paddle_tpu import optimizer as jopt
from paddle_tpu.kernels import pool_fused as jpf
from paddle_tpu.ops import nn_ops as jn
from paddle_tpu_torch import models as pm
from paddle_tpu_torch import optimizer as popt
from paddle_tpu_torch.convert import from_jax_variables, param_tree
from paddle_tpu_torch.kernels import pool_fused as pf
from paddle_tpu_torch.ops import nn_ops as pn

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _input(shape, kind, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.randn(*shape).astype(np.float32)
    if kind == "ties":
        # a few levels after a relu: windows of equal values and of zeros
        x = np.maximum(np.round(x * 2) / 2, 0)
    elif kind == "specials":
        fmin = np.finfo(np.float32).min
        x.reshape(-1)[::7] = np.nan
        x.reshape(-1)[3::11] = -np.inf
        x.reshape(-1)[5::13] = fmin
        x[0, :3, :3, 0] = -np.inf                # a window with no real max
    return x


def _to_torch(xj):
    arr = np.asarray(jnp.asarray(xj, jnp.float32))
    return torch.from_numpy(arr.copy())


# (shape, pool size, stride, padding, input)
CASES = [
    ((2, 9, 9, 8), 3, 2, 1, "randn"),
    ((2, 8, 10, 4), 2, 2, 0, "randn"),
    ((1, 7, 11, 3), 3, 2, 1, "randn"),
    ((2, 12, 12, 8), 3, 2, 1, "ties"),
    ((1, 9, 10, 4), 3, 2, 1, "specials"),
]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", CASES, ids=lambda c: (
    f"{c[0][1]}x{c[0][2]}_k{c[1]}s{c[2]}p{c[3]}_{c[4]}"))
def test_plain_pool_matches_jax_kernel(case, dtype):
    shape, k, s, p, kind = case
    jdt, tdt = DTYPES[dtype]
    xj = jnp.asarray(_input(shape, kind)).astype(jdt)
    ref_out, ref_idx = jpf._pool_fwd_impl(xj, k, k, s, s, p, p, True)
    cot = np.random.RandomState(1).randn(*ref_out.shape).astype(np.float32)
    cj = jnp.asarray(cot).astype(jdt)
    _, vjp = jax.vjp(lambda a: jpf.max_pool2d_fused(a, k, s, p,
                                                    interpret=True), xj)
    (ref_dx,) = vjp(cj)

    x = _to_torch(xj).to(tdt).requires_grad_()
    out = pf.max_pool2d_fused(x, k, s, p)
    (dx,) = torch.autograd.grad(out, x, _to_torch(cj).to(tdt))
    _, idx = pf.pool_fwd_reference(x.detach(), pf.geometry(shape, k, s, p))
    assert torch.equal(pf.max_pool2d_fused_reference(x.detach(), k, s, p),
                       out.detach())
    assert out.dtype == dx.dtype == tdt and idx.dtype == torch.int32
    np.testing.assert_array_equal(out.detach().float().numpy(),
                                  np.asarray(ref_out.astype(jnp.float32)))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
    np.testing.assert_allclose(dx.float().numpy(),
                               np.asarray(ref_dx.astype(jnp.float32)),
                               rtol=1e-6, atol=1e-6)


def test_pool_fwd_picks_the_first_max_and_never_a_special():
    """Written out by hand: a 2x2/s2 window of ties sends idx to its first
    element in scan order; a window of NaN and -inf gives finfo.min and -1
    and takes no gradient."""
    x = torch.tensor([[1.0, 1.0, float("nan"), float("-inf")],
                      [1.0, 0.5, float("-inf"), float("nan")]])[None, ..., None]
    out, idx = pf.pool_fwd_reference(x, pf.geometry(x.shape, 2, 2, 0))
    fmin = torch.finfo(torch.float32).min
    assert out.flatten().tolist() == [1.0, fmin]
    assert idx.flatten().tolist() == [0, -1]
    dx = pf.pool_bwd_reference(torch.tensor([[[[3.0], [5.0]]]]), idx,
                               pf.geometry(x.shape, 2, 2, 0), torch.float32)
    assert dx.flatten().tolist() == [3.0] + [0.0] * 7


@pytest.mark.parametrize("knob", ["explicit", "default_on", "default_off"])
def test_pool2d_routing_matches_jax(knob, monkeypatch):
    """The fused route takes NHWC float max pools whose padding is smaller
    than the window; avg, NCHW, ceil_mode and global pools stay on the
    plain route. Each result equals the JAX op's under the same knob."""
    calls = []
    real = pf.max_pool2d_fused
    monkeypatch.setattr(pf, "max_pool2d_fused",
                        lambda *a: calls.append(a) or real(*a))
    x = np.random.RandomState(1).randn(2, 8, 8, 4).astype(np.float32)
    use = {"explicit": True, "default_on": None, "default_off": None}[knob]
    on = knob != "default_off"
    pf.set_pool_fused(knob == "default_on")
    try:
        with jpf.pool_fused_scope(knob == "default_on"):
            for cfg, fused in [
                    (dict(pool_size=2, pool_stride=2), True),
                    (dict(pool_size=3, pool_stride=2, pool_padding=1), True),
                    (dict(pool_size=2, pool_padding=2), False),
                    (dict(pool_size=2, pool_type="avg"), False),
                    (dict(pool_size=2, ceil_mode=True, pool_stride=3),
                     False),
                    (dict(global_pooling=True), False)]:
                for fmt in ("NHWC", "NCHW"):
                    xs = x if fmt == "NHWC" else x.transpose(0, 3, 1, 2)
                    before = len(calls)
                    ref = jn.pool2d(jnp.asarray(xs), data_format=fmt,
                                    use_pallas=use, **cfg)
                    got = pn.pool2d(torch.from_numpy(xs.copy()),
                                    data_format=fmt, use_pallas=use, **cfg)
                    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                               rtol=1e-6, atol=1e-6)
                    took = len(calls) > before
                    assert took == (on and fused and fmt == "NHWC"), (cfg,
                                                                      fmt)
    finally:
        pf.set_pool_fused(False)
    assert not pf.POOL_FUSED


def test_bench_reads_the_pool_knob_from_the_environment(monkeypatch):
    from paddle_tpu_torch import bench
    for env, want in ((None, False), ("0", False), ("", False), ("1", True)):
        if env is None:
            monkeypatch.delenv("PADDLE_TPU_POOL_FUSED", raising=False)
        else:
            monkeypatch.setenv("PADDLE_TPU_POOL_FUSED", env)
        assert bench.pool_fused_from_env() is want


# -- ResNet-18 step with the pool knob on ---------------------------------------

B, HW, CLASSES, LR = 2, 64, 10, 0.1


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(v)


def _rel(a, b):
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


@pytest.fixture(scope="module")
def resnet18_pooled():
    rs = np.random.RandomState(0)
    x = rs.randn(B, HW, HW, 3).astype(np.float32)
    labels = np.array([1, 7])
    jmodel = jm.resnet18(num_classes=CLASSES)
    variables = jax.tree_util.tree_map(
        np.asarray, jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    opt = jopt.Momentum(learning_rate=LR, momentum=0.9)

    def lf(p):
        logits, _ = jmodel.apply({"params": p, "state": variables["state"]},
                                 jnp.asarray(x), training=True, mutable=True)
        logp = jax.nn.log_softmax(logits.astype(jnp.float32))
        return -jnp.mean(jnp.take_along_axis(
            logp, jnp.asarray(labels)[:, None], axis=-1)), logits

    with jn.conv_fused(), jpf.pool_fused_scope():
        (loss, logits), grads = jax.jit(jax.value_and_grad(
            lf, has_aux=True))(variables["params"])
    new_p, _ = opt.apply_gradients(variables["params"], grads,
                                   opt.init(variables["params"]))
    ref = {"loss": float(loss), "logits": np.asarray(logits),
           "grads": dict(_flat(grads)), "params": dict(_flat(new_p))}

    model = pm.ResNet(18, num_classes=CLASSES, device="cpu")
    from_jax_variables(variables, model)
    model.train()
    params = param_tree(model)
    popt_ = popt.Momentum(learning_rate=LR, momentum=0.9)
    counts = {"fwd": 0, "bwd": 0}
    real_fwd, real_bwd = pf.pool_fwd_reference, pf.pool_bwd_reference

    def fwd(*a):
        counts["fwd"] += 1
        return real_fwd(*a)

    def bwd(*a):
        counts["bwd"] += 1
        return real_bwd(*a)

    pf.pool_fwd_reference, pf.pool_bwd_reference = fwd, bwd
    pf.set_pool_fused(True)
    try:
        with pn.conv_fused():
            logits_t = model(torch.from_numpy(x))
            logp = torch.log_softmax(logits_t.float(), dim=-1)
            loss_t = -torch.mean(torch.gather(
                logp, 1, torch.from_numpy(labels)[:, None]))
            g = torch.autograd.grad(loss_t, list(params.values()))
    finally:
        pf.set_pool_fused(False)
        pf.pool_fwd_reference, pf.pool_bwd_reference = real_fwd, real_bwd
    popt_.apply_gradients(params, dict(zip(params, g)), popt_.init(params))
    got = {"loss": loss_t.item(), "logits": logits_t.detach().numpy(),
           "grads": {k: v.numpy() for k, v in zip(params, g)},
           "params": {k: p.detach().numpy() for k, p in params.items()}}
    return ref, got, counts


def test_resnet18_step_with_pool_knob_matches_jax(resnet18_pooled):
    ref, got, counts = resnet18_pooled
    assert counts == {"fwd": 1, "bwd": 1}
    assert abs(got["loss"] - ref["loss"]) <= 1e-4 * abs(ref["loss"])
    np.testing.assert_allclose(got["logits"], ref["logits"], rtol=1e-4,
                               atol=1e-4)
    assert set(got["grads"]) == set(ref["grads"])
    worst = max((_rel(got["grads"][k], ref["grads"][k]), k)
                for k in ref["grads"])
    assert worst[0] < 1e-3, worst
    for k, v in ref["params"].items():
        np.testing.assert_allclose(got["params"][k], v, rtol=1e-4,
                                   atol=1e-4, err_msg=k)
