"""The port's Transformer against the JAX package's, on the CPU.

A tiny model (2+2 layers, d_model 64, 4 heads, vocab 128, float32) is
initialized in JAX from a seed, carried into the port through
``from_jax_variables`` (tied ``trg_emb`` included) and run on the same
inputs, with ``use_flash`` off and on.

Tolerance for logits and activations: float32, rtol = atol = 1e-4. Both
sides run the same float32 arithmetic; the matmul summation order and the
sin/cos/exp implementations differ between XLA and ATen, which moves the
logits by ~1e-6 relative after 4 layers (observed). Greedy tokens must be
identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import models as jm
from paddle_tpu.inference import GenerationConfig as JaxGenConfig
from paddle_tpu.inference import Generator as JaxGenerator
from paddle_tpu.ops.math import stable_argmax as jax_stable_argmax
from paddle_tpu_torch.convert import from_jax_variables
from paddle_tpu_torch.inference import GenerationConfig, Generator
from paddle_tpu_torch.models import transformer as pm
from paddle_tpu_torch.ops import nn_ops
from paddle_tpu_torch.ops.math import stable_argmax

TOL = dict(rtol=1e-4, atol=1e-4)


def _src(seed=1, b=4, L=7):
    src = np.random.RandomState(seed).randint(3, 100, (b, L)).astype(np.int32)
    src[2, 4:] = 0   # a ragged row
    return src


def _pair(use_flash):
    """(JAX model, JAX variables, port model with the same weights)."""
    cfg = jm.TransformerConfig.tiny(n_layer=2, dropout=0.0,
                                    use_flash=use_flash)
    jmodel = jm.Transformer(cfg)
    src = jnp.asarray(_src())
    variables = jmodel.init(jax.random.PRNGKey(1), src, src)
    pmodel = pm.Transformer(pm.TransformerConfig.tiny(
        n_layer=2, dropout=0.0, use_flash=use_flash), device="cpu")
    from_jax_variables(jax.tree_util.tree_map(np.asarray, variables),
                       pmodel)
    return jmodel, variables, pmodel


FLASH = pytest.mark.parametrize("use_flash", [False, True],
                                ids=["plain", "flash"])


def test_converter_ties_embedding_and_copies_every_param():
    jmodel, variables, pmodel = _pair(False)
    params = variables["params"]
    assert "src_emb" not in params and "trg_emb" in params
    assert pmodel.src_emb is pmodel.trg_emb
    np.testing.assert_array_equal(pmodel.src_emb.weight.detach().numpy(),
                                  np.asarray(params["trg_emb"]["weight"]))
    np.testing.assert_array_equal(
        pmodel.dec_layers[1].cross_attn.v_proj.weight.detach().numpy(),
        np.asarray(params["dec_layers_1"]["cross_attn"]["v_proj"]["weight"]))
    n_jax = sum(x.size for x in jax.tree_util.tree_leaves(params))
    assert n_jax == sum(p.numel() for p in pmodel.parameters())


def test_converter_rejects_mismatched_trees():
    _, variables, pmodel = _pair(False)
    tree = jax.tree_util.tree_map(np.asarray, variables["params"])
    bad = dict(tree, proj={"weight": np.zeros((3, 3), np.float32)})
    with pytest.raises(ValueError):
        from_jax_variables(bad, pmodel)
    missing = {k: v for k, v in tree.items() if k != "enc_ln"}
    with pytest.raises(KeyError):
        from_jax_variables(missing, pmodel)
    extra = dict(tree, extra={"weight": np.zeros((1,), np.float32)})
    with pytest.raises(KeyError):
        from_jax_variables(extra, pmodel)


@FLASH
def test_encode_matches(use_flash):
    jmodel, variables, pmodel = _pair(use_flash)
    src = _src()
    want = jmodel.apply_method("encode", variables, jnp.asarray(src),
                               jnp.asarray(src != 0))
    with torch.no_grad():   # encode is differentiable; no graph needed here
        got = pmodel.encode(torch.from_numpy(src))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@FLASH
def test_decode_steps_match(use_flash):
    """Three cached decode steps: logits and the KV caches agree."""
    jmodel, variables, pmodel = _pair(use_flash)
    src = _src()
    mask = src != 0
    enc_j = jmodel.apply_method("encode", variables, jnp.asarray(src),
                                jnp.asarray(mask))
    caches_j, ckv_j = jmodel.apply_method("init_decode_state", variables,
                                          enc_j, 8)
    enc_p = pmodel.encode(torch.from_numpy(src))
    caches_p, ckv_p = pmodel.init_decode_state(enc_p, 8)
    toks = np.array([1, 5, 9, 14], np.int32)
    for i in range(3):
        lj, caches_j = jmodel.apply_method(
            "decode_step", variables, jnp.asarray(toks), i, caches_j, ckv_j,
            jnp.asarray(mask))
        lp, caches_p = pmodel.decode_step(torch.from_numpy(toks), i,
                                          caches_p, ckv_p,
                                          torch.from_numpy(mask))
        np.testing.assert_allclose(lp.numpy(), np.asarray(lj), **TOL)
        toks = np.array(jax_stable_argmax(lj, axis=-1))
    np.testing.assert_allclose(caches_p[1]["k"].numpy(),
                               np.asarray(caches_j[1]["k"]), **TOL)


@FLASH
def test_teacher_forced_forward_matches(use_flash):
    jmodel, variables, pmodel = _pair(use_flash)
    src = _src()
    trg = np.random.RandomState(4).randint(3, 100, (4, 6)).astype(np.int32)
    want = jmodel.apply(variables, jnp.asarray(src), jnp.asarray(trg))
    with torch.no_grad():
        got = pmodel(torch.from_numpy(src), torch.from_numpy(trg))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@FLASH
def test_greedy_decode_cached_token_identical(use_flash):
    jmodel, variables, pmodel = _pair(use_flash)
    src = _src()
    want = np.asarray(jm.greedy_decode_cached(jmodel, variables,
                                              jnp.asarray(src), max_len=12))
    got = pm.greedy_decode_cached(pmodel, torch.from_numpy(src),
                                  max_len=12).numpy()
    assert len(np.unique(want[:, 1:])) > 4   # the tokens are not degenerate
    np.testing.assert_array_equal(got, want)


@FLASH
def test_generator_with_padded_buckets_token_identical(use_flash):
    """Batch 3 -> bucket 4 (one all-pad row), length 7 -> bucket 8."""
    jmodel, variables, pmodel = _pair(use_flash)
    src = _src(seed=2, b=3)
    kw = dict(max_len=10, batch_buckets=(4, 8), src_len_buckets=(8, 16))
    want = JaxGenerator(jmodel, variables, JaxGenConfig(**kw)).generate(src)
    gen = Generator(pmodel, GenerationConfig(**kw), device="cpu")
    got = gen.generate(src)
    assert got.shape == (3, 10)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert gen.last_latency_ms is None          # first call at the bucket
    np.testing.assert_array_equal(gen.generate(src), got)
    assert gen.last_latency_ms is not None
    assert gen.last_tokens_per_s is not None


def test_generator_use_bf16_casts_a_copy():
    _, _, pmodel = _pair(False)
    gen = Generator(pmodel, GenerationConfig(max_len=6, use_bf16=True,
                                            src_len_buckets=(8,)),
                    device="cpu")
    assert gen.model.proj.weight.dtype == torch.bfloat16
    assert pmodel.proj.weight.dtype == torch.float32
    out = gen.generate(_src())
    assert out.shape == (4, 6) and (out >= 0).all() and (out < 128).all()


def test_generator_rejects_beam_and_long_inputs():
    _, _, pmodel = _pair(False)
    with pytest.raises(NotImplementedError):
        Generator(pmodel, GenerationConfig(beam_size=4), device="cpu")
    with pytest.raises(ValueError):
        Generator(pmodel, GenerationConfig(max_len=64), device="cpu")
    gen = Generator(pmodel, GenerationConfig(max_len=8,
                                             src_len_buckets=(16,)),
                    device="cpu")
    with pytest.raises(ValueError):
        gen.generate(np.ones((1, 33), np.int32))


@pytest.mark.parametrize("case", ["ties", "nan", "bf16_collapse"])
def test_stable_argmax_matches(case):
    rs = np.random.RandomState(0)
    x = rs.randn(6, 9).astype(np.float32)
    if case == "ties":
        x[:, 2] = x[:, 7] = x.max(axis=1) + 1.0     # exact tie: lowest wins
    elif case == "nan":
        x[1, 4] = np.nan
        x[3, :] = np.nan
    else:   # distinct in float32, equal after the bf16 collapse
        x[:, 5] = 10.0
        x[:, 1] = 10.0 + 1e-4
    want = np.asarray(jax_stable_argmax(jnp.asarray(x), axis=-1))
    got = stable_argmax(torch.from_numpy(x), dim=-1).numpy()
    np.testing.assert_array_equal(got, want)


def test_sinusoid_table_matches():
    want = jm.sinusoid_position_encoding(32, 64)
    got = pm.sinusoid_position_encoding(32, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_layer_norm_and_embedding_match():
    from paddle_tpu.ops import nn_ops as jax_nn_ops
    rs = np.random.RandomState(0)
    x = rs.randn(3, 5, 16).astype(np.float32) * 3 + 1
    s, b = rs.randn(16).astype(np.float32), rs.randn(16).astype(np.float32)
    want = jax_nn_ops.layer_norm(jnp.asarray(x), jnp.asarray(s),
                                 jnp.asarray(b), begin_norm_axis=2)
    got = nn_ops.layer_norm(torch.from_numpy(x), torch.from_numpy(s),
                            torch.from_numpy(b), begin_norm_axis=2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    table = rs.randn(10, 4).astype(np.float32)
    ids = rs.randint(0, 10, (3, 1)).astype(np.int32)   # trailing 1 squeezes
    want = jax_nn_ops.embedding(jnp.asarray(ids), jnp.asarray(table))
    got = nn_ops.embedding(torch.from_numpy(ids), torch.from_numpy(table))
    assert got.shape == (3, 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
