"""The port's BERT pretraining model and step against the JAX package's, on
the CPU.

``BertConfig.tiny()`` (vocab 128, hidden 64, 2 layers, 4 heads, FFN 128,
float32, dropout off as in eval) is initialized in JAX from a seed and its
weights are carried into the port by ``from_jax_variables``; the AdamW
state by ``from_jax_opt_state``. Inputs come from numpy with a seed:
random ids with padding 0s (no all-pad row: training declares those rows
unsupported, ``kernels/attention.py``), random token types, MLM labels,
0/1 MLM weights and NSP labels. Everything runs with ``use_pallas`` off
(dense attention) and on (the flash route: JAX's scan path on the CPU,
the port's flash op with the kernels' plain versions).

Tolerances (float32, rtol = atol): logits 1e-4 and the loss 1e-5, as
``tests/test_torch_transformer.py`` and ``tests/test_torch_training.py``
hold the Transformer (XLA and ATen sum matmuls in another order); the
gradients 1e-4 leaf by leaf; the parameters after one and three
AdamW(1e-4, weight_decay 0.01) steps 1e-5, except the key projections'
biases: their true gradient is 0 (softmax ignores a shift of a query's
scores), both sides compute rounding noise, and Adam turns noise into a
step of about lr, so those are held to 2.02 * lr a step
(``tests/test_torch_training.py``). bfloat16 checks are held to one bf16
ulp of the JAX value (one rounding of the same float32 sum).
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import optimizer as jopt
from paddle_tpu.models import bert as jbert
from paddle_tpu_torch import bert_bench
from paddle_tpu_torch import optimizer as popt
from paddle_tpu_torch.convert import (from_jax_opt_state, from_jax_variables,
                                      param_tree)
from paddle_tpu_torch.kernels import layer_norm as pln
from paddle_tpu_torch.models import bert as pbert

B, T, STEPS, LR, WD = 4, 32, 3, 1e-4, 0.01
TOL = dict(rtol=1e-4, atol=1e-4)
KEY_BIAS = "k_proj/bias"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), v


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _batch(seed=0):
    rs = np.random.RandomState(seed)
    ids = rs.randint(1, 128, (B, T)).astype(np.int32)
    ids[1, 20:] = 0
    ids[2, 5:] = 0
    ids[3, 31:] = 0
    types = rs.randint(0, 2, (B, T)).astype(np.int32)
    mlm_labels = rs.randint(0, 128, (B, T)).astype(np.int32)
    mlm_weights = (rs.rand(B, T) < 0.3).astype(np.float32)
    nsp_labels = rs.randint(0, 2, (B,)).astype(np.int32)
    return ids, types, mlm_labels, mlm_weights, nsp_labels


def _jax_model(use_pallas):
    return jbert.BertForPretraining(jbert.BertConfig.tiny(
        use_pallas=use_pallas))


@pytest.fixture(scope="module", params=[False, True],
                ids=["dense", "pallas"])
def jax_run(request):
    """JAX: initial params and AdamW state, the logits, the first loss
    and gradients, the losses and the params after steps 1 and 3."""
    use_pallas = request.param
    ids, types, labels, weights, nsp = map(jnp.asarray, _batch())
    model = _jax_model(use_pallas)
    params = model.init(jax.random.PRNGKey(0), ids)["params"]
    opt = jopt.AdamW(learning_rate=LR, weight_decay=WD)
    state = opt.init(params)
    init = (_np(params), _np(state))

    def loss_fn(p):
        mlm, nsp_logits = model.apply({"params": p}, ids, types)
        return model.loss(mlm, nsp_logits, labels, weights, nsp)[0]

    logits = _np(model.apply({"params": params}, ids, types))
    value_and_grad = jax.jit(jax.value_and_grad(loss_fn))
    apply_gradients = jax.jit(opt.apply_gradients)
    losses, grads, snaps = [], None, []
    for _ in range(STEPS):
        loss, g = value_and_grad(params)
        losses.append(float(loss))
        grads = grads or dict(_flat(_np(g)))
        params, state = apply_gradients(params, g, state)
        snaps.append(dict(_flat(_np(params))))
    return use_pallas, init, logits, losses, grads, snaps


def _port_model(use_pallas, init):
    model = pbert.BertForPretraining(
        pbert.BertConfig.tiny(use_pallas=use_pallas), device="cpu")
    from_jax_variables(init, model)
    return model


def _loss_fn(model, batch):
    ids, types, labels, weights, nsp = map(torch.from_numpy, batch)

    def fn(params):
        mlm, nsp_logits = model(ids, types)
        return model.loss(mlm, nsp_logits, labels, weights, nsp)[0]
    return fn


def test_converter_copies_every_leaf_of_the_bert_tree(jax_run):
    _, init, *_ = jax_run
    paths = dict(_flat(init[0]))
    model = _port_model(False, init[0])
    params = param_tree(model)
    assert list(params) == sorted(paths)
    for name in ("bert/embeddings/word/weight", "mlm_bias",
                 "bert/layers_1/attn_ln/scale", "bert/layers_1/out_ln/bias",
                 "mlm_ln/scale", "bert/pooler/weight"):
        np.testing.assert_array_equal(params[name].detach().numpy(),
                                      paths[name])
    # the decoder reads the word table itself: one parameter, tied
    assert sum(p is model.bert.embeddings.word.weight
               for p in model.parameters()) == 1


def test_logits_match_jax(jax_run):
    use_pallas, init, (mlm, nsp), *_ = jax_run
    ids, types = map(torch.from_numpy, _batch()[:2])
    model = _port_model(use_pallas, init[0])
    got_mlm, got_nsp = model(ids, types)
    assert got_mlm.shape == (B, T, 128) and got_nsp.dtype == torch.float32
    np.testing.assert_allclose(got_mlm.detach().numpy(), mlm, **TOL)
    np.testing.assert_allclose(got_nsp.detach().numpy(), nsp, **TOL)


def test_loss_gradients_and_adamw_steps_match_jax(jax_run):
    use_pallas, init, _, losses, grads, snaps = jax_run
    model = _port_model(use_pallas, init[0])
    params = param_tree(model)
    assert set(params) == set(grads)
    loss_fn = _loss_fn(model, _batch())
    loss = loss_fn(params)
    np.testing.assert_allclose(loss.item(), losses[0], rtol=1e-5, atol=1e-5)
    got = torch.autograd.grad(loss, list(params.values()))
    for k, g in zip(params, got):
        np.testing.assert_allclose(g.numpy(), grads[k], err_msg=k, **TOL)
    opt = popt.AdamW(learning_rate=LR, weight_decay=WD)
    state = from_jax_opt_state(init[1], params)
    for step in range(STEPS):
        loss, _, _, _ = opt.minimize(loss_fn, params, state)
        np.testing.assert_allclose(loss.item(), losses[step], rtol=1e-5,
                                   atol=1e-5)
        if step in (0, STEPS - 1):
            for k, p in params.items():
                tol = 2.02 * LR * (step + 1) if k.endswith(KEY_BIAS) \
                    else 1e-5
                np.testing.assert_allclose(p.detach().numpy(), snaps[step][k],
                                           rtol=tol, atol=tol,
                                           err_msg=f"step {step + 1} {k}")


def test_masked_positions_match_jax(jax_run):
    use_pallas, init, *_ = jax_run
    ids = _batch()[0]
    pos = np.random.RandomState(7).randint(0, T, (B, 5)).astype(np.int32)
    model = _jax_model(use_pallas)
    want_mlm, want_nsp = model.apply({"params": jax.tree_util.tree_map(
        jnp.asarray, init[0])}, jnp.asarray(ids),
        masked_positions=jnp.asarray(pos))
    got_mlm, got_nsp = _port_model(use_pallas, init[0])(
        torch.from_numpy(ids), masked_positions=torch.from_numpy(pos))
    assert got_mlm.shape == (B, 5, 128)
    np.testing.assert_allclose(got_mlm.detach().numpy(),
                               np.asarray(want_mlm), **TOL)
    np.testing.assert_allclose(got_nsp.detach().numpy(),
                               np.asarray(want_nsp), **TOL)


def test_tied_embedding_gradient_holds_both_uses(jax_run, monkeypatch):
    """The word table's gradient is the lookup's plus the MLM decoder's:
    with the decoder given a separate copy of the table, the two parts
    add up to the tied gradient (and to JAX's)."""
    _, init, _, _, grads, _ = jax_run
    model = _port_model(False, init[0])
    word = model.bert.embeddings.word.weight
    loss_fn = _loss_fn(model, _batch())
    (tied,) = torch.autograd.grad(loss_fn(None), [word])
    copy = word.detach().clone().requires_grad_()
    real = pbert.mlm_decode
    monkeypatch.setattr(pbert, "mlm_decode",
                        lambda h, emb, bias: real(h, copy, bias))
    lookup, decoder = torch.autograd.grad(loss_fn(None), [word, copy])
    assert lookup.abs().sum() > 0 and decoder.abs().sum() > 0
    np.testing.assert_allclose((lookup + decoder).numpy(), tied.numpy(),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tied.numpy(),
                               grads["bert/embeddings/word/weight"], **TOL)


def _bf16_ulp_diff(got, want):
    got = got.float().numpy()
    want = np.asarray(want.astype(jnp.float32))
    mag = np.maximum(np.abs(want), np.finfo(np.float32).tiny)
    return np.abs(got - want) / 2.0 ** (np.floor(np.log2(mag)) - 7)


def test_bf16_mlm_logits_round_once_after_the_bias():
    """The bf16 decoder sums the product in float32, adds the float32
    bias and rounds once (``models/bert.py:160-162``): within one bf16
    ulp of JAX's everywhere, and the same value for all but a few
    elements (a float32 sum in another order lands on the other side of
    a rounding boundary). Rounding the product to bf16 before the bias,
    as a bf16 ``torch.matmul`` would, parts from it much more often. The
    backward (dh, demb, dbias) within one bf16 ulp of JAX's transpose."""
    rs = np.random.RandomState(8)
    h = rs.randn(4, 16, 64).astype(np.float32)
    emb = rs.randn(300, 64).astype(np.float32) * 0.2
    bias = rs.randn(300).astype(np.float32) * 2.0
    g = rs.randn(4, 16, 300).astype(np.float32)
    jh = jnp.asarray(h).astype(jnp.bfloat16)

    def jdecode(h, emb, bias):
        return (jnp.matmul(h, emb.T.astype(h.dtype),
                           preferred_element_type=jnp.float32)
                + bias).astype(h.dtype)

    want, vjp = jax.vjp(jdecode, jh, jnp.asarray(emb), jnp.asarray(bias))
    wants = vjp(jnp.asarray(g).astype(jnp.bfloat16))
    th = torch.from_numpy(h).bfloat16().requires_grad_()
    temb = torch.from_numpy(emb).requires_grad_()
    tbias = torch.from_numpy(bias).requires_grad_()
    got = pbert.mlm_decode(th, temb, tbias)
    assert got.dtype == torch.bfloat16
    ulps = _bf16_ulp_diff(got.detach(), want)
    assert ulps.max() <= 1 and (ulps > 0).mean() < 1e-3
    naive = (torch.matmul(th.detach(), temb.detach().bfloat16().t())
             + tbias.detach()).bfloat16()
    assert (_bf16_ulp_diff(naive, want) > 0).mean() > 0.05
    gots = torch.autograd.grad(got, (th, temb, tbias),
                               torch.from_numpy(g).bfloat16())
    for name, a, w in zip(("dh", "demb", "dbias"), gots, wants):
        assert str(a.dtype) == f"torch.{w.dtype}", name
        assert _bf16_ulp_diff(a, w).max() <= 1, name


def test_bf16_loss_matches_jax_with_bert_weighting():
    """``BertForPretraining.loss`` on bf16 MLM logits ``[B, T, V]``
    (float32 inside, ``token_softmax_cross_entropy``), weighted by 0/1
    MLM weights, plus the NSP term: loss within 1e-6 relative, the bf16
    logits' gradient within one bf16 ulp."""
    rs = np.random.RandomState(9)
    mlm = (rs.randn(3, 10, 500) * 4).astype(np.float32)
    nsp = rs.randn(3, 2).astype(np.float32)
    labels = rs.randint(0, 500, (3, 10)).astype(np.int32)
    weights = (rs.rand(3, 10) < 0.5).astype(np.float32)
    nsp_labels = rs.randint(0, 2, (3,)).astype(np.int32)
    jmlm = jnp.asarray(mlm).astype(jnp.bfloat16)

    def jloss(m, n):
        return jbert.BertForPretraining.loss(
            m, n, jnp.asarray(labels), jnp.asarray(weights),
            jnp.asarray(nsp_labels))[0]

    want, (wg, wn) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jmlm, jnp.asarray(nsp))
    tm = torch.from_numpy(mlm).bfloat16().requires_grad_()
    tn = torch.from_numpy(nsp).requires_grad_()
    got = pbert.BertForPretraining.loss(
        tm, tn, torch.from_numpy(labels), torch.from_numpy(weights),
        torch.from_numpy(nsp_labels))[0]
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    gm, gn = torch.autograd.grad(got, (tm, tn))
    assert gm.dtype == torch.bfloat16
    assert _bf16_ulp_diff(gm, wg).max() <= 1
    np.testing.assert_allclose(gn.numpy(), np.asarray(wn), rtol=1e-5,
                               atol=1e-6)


def test_no_bert_layer_norm_reaches_the_row_norm_kernel(monkeypatch):
    """BERT's LayerNorms see ``[B, T, H]`` inputs, so even with
    ``use_pallas`` the model never takes the row-norm kernel's route."""
    calls = []
    real = pln.fused_layer_norm_reference
    monkeypatch.setattr(pln, "fused_layer_norm_reference",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    model = pbert.BertForPretraining(pbert.BertConfig.tiny(use_pallas=True),
                                     device="cpu")
    ids = torch.from_numpy(_batch()[0])
    mlm, nsp = model(ids)
    model.loss(mlm, nsp, ids, torch.ones(B, T), ids[:, 0] % 2)[0].backward()
    assert calls == []


def test_bench_step_matches_the_jax_benchmark():
    """``bert_bench``'s tiny step against ``run_benchmarks.build_bert``'s
    (``tiny=True``: batch 8 x 32, ids all ones, AdamW(1e-4, 0.01)) from
    the same weights: three losses within 1e-5; the MFU estimate equals
    the JAX benchmark's at both sizes."""
    sys.path.insert(0, os.path.join(ROOT, "benchmark"))
    import run_benchmarks as rb
    spec = rb.build_bert(True, False)
    (params, opt_state), data = spec["carry"], spec["data"]
    step = jax.jit(spec["step"])
    model, pparams, opt, state, pdata = bert_bench.build(
        bert_bench.config("cpu"), *bert_bench.SIZES["cpu"], "cpu")
    from_jax_variables(_np(params), model)
    for p, j in zip(pdata, data):
        np.testing.assert_array_equal(p.numpy(), np.asarray(j))
    for _ in range(3):
        want, params, opt_state = step(params, opt_state, *data)
        got = bert_bench.train_step(model, pparams, opt, state, pdata)
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-5,
                                   atol=1e-5)
    assert bert_bench.step_flops(bert_bench.config("cpu"), 8, 32) == \
        spec["flops_est"]
    cfg = bert_bench.config("cuda")
    assert bert_bench.step_flops(cfg, 32, 128) == \
        rb.estimate_transformer_flops(n_enc=12, n_dec=0, d_model=768,
                                      d_inner=3072, vocab=30522, batch=32,
                                      seqlen=128)
    assert cfg.dtype == torch.bfloat16 and not cfg.use_pallas


@pytest.mark.parametrize("use_pallas", [False, True], ids=["dense", "pallas"])
def test_bench_runs_on_the_cpu(use_pallas):
    out = bert_bench.run("cpu", use_pallas=use_pallas, steps=2)
    assert out["unit"] == "tokens/s" and out["value"] > 0
    assert np.isfinite(out["final_loss"]) and "mfu" not in out
    assert out["use_pallas"] is use_pallas


def test_bert_mask_folds_into_the_flash_kv_mask(monkeypatch):
    """BERT's ``[B, 1, 1, T]`` padding mask reaches the flash op as its
    ``[B, T]`` kv mask, at BERT-base's head dim 64 and T 128: outputs and
    the q, k, v gradients within 1e-4 of JAX's flash route (its scan path
    on the CPU)."""
    from paddle_tpu.nn import attention as jattn
    from paddle_tpu_torch.kernels import attention as pattn
    from paddle_tpu_torch.nn import attention as pnn_attn
    rs = np.random.RandomState(10)
    q, k, v, do = (rs.randn(2, 3, 128, 64).astype(np.float32)
                   for _ in range(4))
    mask = np.ones((2, 1, 1, 128), bool)
    mask[1, ..., 70:] = False

    def jf(q, k, v):
        return jnp.sum(jattn.scaled_dot_product_attention(
            q, k, v, jnp.asarray(mask), use_flash=True) * do)

    want = jax.value_and_grad(jf, argnums=(0, 1, 2))(
        *map(jnp.asarray, (q, k, v)))
    seen = []
    real = pattn.flash_attn_op
    monkeypatch.setattr(pattn, "flash_attn_op", lambda *a: seen.append(
        a[3].clone()) or real(*a))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = pnn_attn.scaled_dot_product_attention(
        tq, tk, tv, torch.from_numpy(mask), use_flash=True)
    loss = (out * torch.from_numpy(do)).sum()
    grads = torch.autograd.grad(loss, (tq, tk, tv))
    assert len(seen) == 1 and torch.equal(seen[0],
                                          torch.from_numpy(mask[:, 0, 0]))
    np.testing.assert_allclose(loss.item(), float(want[0]), rtol=1e-5)
    for g, w in zip(grads, want[1]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
