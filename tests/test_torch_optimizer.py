"""The port's optimizers and fused update against the JAX package's, on the
CPU.

On CPU tensors the fused route takes ``update_reference``, the plain
version of ``csrc/fused_update.cu``. It is held against the JAX
``fused_update_step`` (its Pallas kernel in interpret mode) and against the
JAX optimizers' unfused ``apply_gradients``, for SGD, Momentum with a
global-norm clip, Adam and AdamW over three steps, from the same inputs
(numpy, seeded).

Tolerances: port against JAX, rtol 1e-6 and atol 1e-7. The expressions
are the same float32 operations, but XLA may contract a multiply-add into
one FMA and its ``pow`` for the bias correction (0.999 ** t) may differ
from ATen's in the last ulp, so the two are not bitwise equal. Port fused
against port unfused: bitwise, parameters and state (the unfused sweep
and the plain version round every operation the same way).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import optimizer as jopt
from paddle_tpu.kernels import fused_update as jfu
from paddle_tpu_torch import optimizer as popt
from paddle_tpu_torch.kernels import fused_update as pfu

TOL = dict(rtol=1e-6, atol=1e-7)
SHAPES = {"a": (3, 5), "b": {"c": (130,), "d": (2, 2, 3)}}
PATHS = ["a", "b/c", "b/d"]          # the JAX tree's leaf order


def _tree(seed, scale=1.0):
    rs = np.random.RandomState(seed)
    return {"a": rs.randn(3, 5).astype(np.float32) * scale,
            "b": {"c": rs.randn(130).astype(np.float32) * scale,
                  "d": rs.randn(2, 2, 3).astype(np.float32) * scale}}


def _flat(tree):
    return {"a": tree["a"], "b/c": tree["b"]["c"], "b/d": tree["b"]["d"]}


def _port(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in _flat(tree).items()}


def _assert_close(port, jax_tree, **tol):
    for k, v in _flat(jax_tree).items():
        np.testing.assert_allclose(port[k].numpy(), np.asarray(v),
                                   **(tol or TOL), err_msg=k)


# (kind, clip_norm, hyperparameters)
KINDS = [
    ("sgd", None, {}),
    ("momentum", 0.5, {"momentum": 0.9, "nesterov": False}),
    ("momentum_nesterov", None, {"momentum": 0.8, "nesterov": True}),
    ("adam", None, {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}),
    ("adamw", 2.0, {"beta1": 0.85, "beta2": 0.99, "epsilon": 1e-6,
                    "weight_decay": 0.05}),
]


@pytest.mark.parametrize("name,clip,hyper", KINDS, ids=[k[0] for k in KINDS])
def test_plain_fused_update_matches_jax_kernel(name, clip, hyper):
    kind = name.split("_")[0]
    jp, pp = _tree(0), _port(_tree(0))
    js = {nm: jax.tree_util.tree_map(np.zeros_like, jp)
          for nm in jfu.ACC_NAMES[kind]}
    ps = {nm: {k: torch.zeros_like(v) for k, v in pp.items()}
          for nm in pfu.ACC_NAMES[kind]}
    for step in range(3):
        g = _tree(10 + step, scale=2.0)
        jp, js, _, jn = jfu.fused_update_step(
            jp, g, js, kind=kind, lr=0.05, step=step, clip_norm=clip,
            interpret=True, **hyper)
        _, _, pn = pfu.fused_update_step(pp, _port(g), ps, kind=kind,
                                         lr=0.05, step=step, clip_norm=clip,
                                         **hyper)
        if clip is not None:
            np.testing.assert_allclose(pn.numpy(), np.asarray(jn), **TOL)
    _assert_close(pp, jp)
    for nm in ps:
        _assert_close(ps[nm], js[nm])


def _optimizers(name):
    """(JAX optimizer, port optimizer) of one configuration."""
    if name == "sgd":
        return jopt.SGD(0.1), popt.SGD(0.1)
    if name == "momentum_clip":
        return (jopt.Momentum(0.1, 0.9, grad_clip=(
                    jopt.GradientClipByGlobalNorm(0.5))),
                popt.Momentum(0.1, 0.9, grad_clip=(
                    popt.GradientClipByGlobalNorm(0.5))))
    if name == "adam":
        return jopt.Adam(1e-2), popt.Adam(1e-2)
    return (jopt.AdamW(1e-2, weight_decay=0.1, beta2=0.99),
            popt.AdamW(1e-2, weight_decay=0.1, beta2=0.99))


@pytest.mark.parametrize("name", ["sgd", "momentum_clip", "adam", "adamw"])
def test_optimizer_matches_jax_and_fused_equals_unfused(name):
    jo, po = _optimizers(name)
    jp = _tree(1)
    jstate = jo.init(jp)
    routes = {}
    for fused in (False, True):
        pp = _port(_tree(1))
        pstate = po.init(pp)
        for step in range(3):
            g = _tree(20 + step)
            po.apply_gradients(pp, _port(g), pstate, fused=fused)
            if fused:
                jp, jstate = jo.apply_gradients(jp, g, jstate)
        assert pstate["step"] == 3
        routes[fused] = (pp, pstate)
    (pp, pstate), (fp, fstate) = routes[False], routes[True]
    _assert_close(pp, jp)
    for nm in pfu.ACC_NAMES[po._fused_spec()["kind"]]:
        _assert_close(pstate[nm], jstate[nm])
        for k in PATHS:
            assert torch.equal(fstate[nm][k], pstate[nm][k]), (nm, k)
    for k in PATHS:
        assert torch.equal(fp[k], pp[k]), k
    assert int(jstate["step"]) == 3


def test_apply_gradients_fused_flag_routes(monkeypatch):
    calls = []
    real = pfu.fused_update_step
    monkeypatch.setattr(pfu, "fused_update_step",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    opt = popt.Adam(0.1)
    params = _port(_tree(2))
    state = opt.init(params)
    grads = _port(_tree(3))
    opt.apply_gradients(params, grads, state)
    opt.apply_gradients(params, grads, state, fused=False)
    assert calls == []
    opt.apply_gradients(params, grads, state, fused=True)
    assert calls == [1] and state["step"] == 3


def test_learning_rate_schedule_callable_and_minimize():
    opt = popt.SGD(lambda step: 0.5 / (step + 1))
    w = torch.ones(4, requires_grad=True)
    params = {"w": w}
    state = opt.init(params)
    for _ in range(2):
        loss, aux, _, _ = opt.minimize(
            lambda p, x: ((p["w"] * x).sum(), "aux"), params, state,
            torch.arange(4.0), has_aux=True)
        assert aux == "aux" and not loss.requires_grad
    # w -= 0.5 * x, then w -= 0.25 * x
    np.testing.assert_array_equal(w.detach().numpy(),
                                  1 - 0.75 * np.arange(4.0))
    assert w.requires_grad


def test_fused_update_rejects_bad_calls():
    p = {"w": torch.zeros(3)}
    with pytest.raises(ValueError):
        pfu.fused_update_step(p, p, {}, kind="lamb", lr=0.1)
    with pytest.raises(ValueError):
        pfu.fused_update_step(p, p, {"m": p, "v": p}, kind="adam", lr=0.1)
    with pytest.raises(TypeError):
        pfu.fused_update_step({"w": torch.zeros(3, dtype=torch.float64)},
                              p, {}, kind="sgd", lr=0.1)
    with pytest.raises(NotImplementedError):
        popt.SGD(0.1, regularization=object())
