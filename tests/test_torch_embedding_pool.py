"""The port's embedding seqpool and IMDB classifier step against the JAX
package's, on the CPU.

- ``embedding_seqpool`` (its plain version on CPU tensors) against the JAX
  kernel in interpret mode and against ``_seqpool_xla``: the pooled output
  and the table's gradient within 1e-5 (the tolerance of
  ``tests/test_kernels_interpret.py:55-67``), sum and mean; out-of-range
  ids clamp to the edge rows in the forward and the backward, as
  ``tests/test_fused_train_ops.py:227-260`` checks on the JAX side.
- The synthetic IMDB reader gives the JAX reader's samples for the same
  seed, and the collated batch pads and cuts them as the ``imdb_real``
  benchmark's ``collate`` does.
- The classifier step at the JAX workload's tiny size (batch 8, max_len 32,
  dim 16, the 5149-row table), the weights carried from JAX: three
  Adam(1e-3) steps, the port's unfused and fused updates against the JAX
  step (``run_benchmarks.py:616-629``, the seqpool kernel in interpret
  mode): every loss within 1e-5 relative; the parameters after step 3
  within rtol 1e-5, atol 1e-7 (float32 sums in another order; Adam moves
  each touched element by ~lr a step whatever the rounding), Adam's moments
  within 1e-5 of their leaf's largest (a gradient element that nearly
  cancels parts by more relative to itself); table rows no id names
  unmoved.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import optimizer as jopt
from paddle_tpu.data import datasets as jds
from paddle_tpu.kernels import embedding_pool as jep
from paddle_tpu_torch import imdb_bench
from paddle_tpu_torch import optimizer as popt
from paddle_tpu_torch.convert import from_jax_opt_state
from paddle_tpu_torch.data import datasets as pds
from paddle_tpu_torch.kernels import embedding_pool as pep


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("mean", [False, True], ids=["sum", "mean"])
@pytest.mark.parametrize("shape", [(8, 6, 50, 24), (4, 17, 33, 128)],
                         ids=["d24", "d128"])
def test_seqpool_matches_jax_kernel_and_xla(shape, mean):
    b, s, v, d = shape
    rs = np.random.RandomState(0)
    table = rs.randn(v, d).astype(np.float32)
    ids = rs.randint(0, v, (b, s)).astype(np.int32)
    cot = rs.randn(b, d).astype(np.float32)
    jt, jids = jnp.asarray(table), jnp.asarray(ids)
    ref, vjp = jax.vjp(lambda t: jep.embedding_seqpool(jids, t, mean), jt)
    (ref_g,) = vjp(jnp.asarray(cot))
    xla = jep._seqpool_xla(jids, jt, mean)

    tt = _t(table).requires_grad_()
    got = pep.embedding_seqpool(_t(ids), tt, mean)
    (g,) = torch.autograd.grad(got, tt, _t(cot))
    assert got.dtype == torch.float32 and got.shape == (b, d)
    for r in (ref, xla):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(r),
                                   rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(g.numpy(), np.asarray(ref_g), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("mean", [False, True], ids=["sum", "mean"])
def test_out_of_range_ids_clamp_in_forward_and_backward(mean):
    rs = np.random.RandomState(1)
    v, d = 20, 128
    table = rs.randn(v, d).astype(np.float32)
    ids = np.array([[0, 5, 999], [-3, 19, 2]], np.int32)
    jt = jnp.asarray(table)
    ref = jep.embedding_seqpool(jnp.asarray(ids), jt, mean)
    ref_g = jax.grad(lambda t: jnp.sum(
        jep.embedding_seqpool(jnp.asarray(ids), t, mean)))(jt)
    tt = _t(table).requires_grad_()
    got = pep.embedding_seqpool(_t(ids), tt, mean)
    (g,) = torch.autograd.grad(got.sum(), tt)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               atol=1e-5)
    np.testing.assert_allclose(g.numpy(), np.asarray(ref_g), atol=1e-5)
    # 999 lands on the last row, -3 on the first
    w = 1.0 / 3 if mean else 1.0
    np.testing.assert_allclose(g[[0, v - 1]].numpy(),
                               np.full((2, d), 2 * w, np.float32), atol=1e-6)


@pytest.mark.parametrize("split,max_len,seed", [("train", 256, 0),
                                                ("train", 32, 3),
                                                ("test", 100, 1)])
def test_synthetic_imdb_reader_matches_jax(split, max_len, seed):
    kw = dict(vocab_size=5148, max_len=max_len, seed=seed, num_samples=40)
    ours = list(pds.imdb(split, **kw)())
    theirs = list(jds.imdb(split, **kw)())
    assert len(ours) == len(theirs) == 40
    for (s0, l0), (s1, l1) in zip(ours, theirs):
        assert l0 == l1 and [int(t) for t in s0] == [int(t) for t in s1]
    ids, labels = pds.collate(ours, 24)
    assert ids.dtype == np.int32 and labels.dtype == np.float32
    for row, lab, (seq, l1) in zip(ids, labels, theirs):
        n = min(len(seq), 24)
        assert list(row[:n]) == [int(t) for t in seq[:n]]
        assert not row[n:].any() and lab == l1


def test_real_imdb_corpus_is_not_ported():
    with pytest.raises(NotImplementedError, match="aclImdb_v1.tar.gz"):
        pds.imdb(data_dir="/no/such/dir")


def test_imdb_bench_batch_is_the_readers_first_samples():
    ids, labels = imdb_bench.batch_of(8, 32, seed=0)
    it = jds.imdb("train", vocab_size=5148, max_len=32, seed=0)()
    for row, lab in zip(ids, labels):
        seq, l1 = next(it)
        assert list(row[:len(seq)]) == [int(t) for t in seq] and lab == l1


# -- the classifier step ----------------------------------------------------------

STEPS = 3


def _jax_run(params, ids, labels):
    """The ``imdb_real`` step of ``run_benchmarks.py:616-629``."""
    optimizer = jopt.Adam(learning_rate=1e-3)
    opt_state = optimizer.init(params)

    def loss_fn(p):
        pooled = jep.embedding_seqpool(ids, p["table"], True)
        logit = (pooled @ p["w"] + p["b"])[:, 0]
        z = jax.nn.log_sigmoid
        return -jnp.mean(labels * z(logit) + (1 - labels) * z(-logit))

    losses = []
    for _ in range(STEPS):
        loss, grads = jax.value_and_grad(loss_fn)(params)
        params, opt_state = optimizer.apply_gradients(params, grads,
                                                      opt_state)
        losses.append(float(loss))
    return losses, params, opt_state


@pytest.fixture(scope="module")
def jax_run():
    batch, max_len, dim = imdb_bench.SIZES["cpu"]
    ids, labels = imdb_bench.batch_of(batch, max_len, seed=0)
    key = jax.random.PRNGKey(0)
    vocab = 5148 + 1
    params = {"table": jax.random.normal(key, (vocab, dim)) * 0.1,
              "w": jax.random.normal(key, (dim, 1)) * 0.1,
              "b": jnp.zeros((1,))}
    init = jax.tree_util.tree_map(np.asarray, params)
    return (init, ids, labels,
            _jax_run(params, jnp.asarray(ids), jnp.asarray(labels)))


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_imdb_step_matches_jax(jax_run, fused):
    init, ids, labels, (ref_losses, ref_params, ref_state) = jax_run
    params = {k: _t(init[k]).requires_grad_() for k in ("b", "table", "w")}
    opt = popt.Adam(learning_rate=imdb_bench.LR)
    state = opt.init(params)
    losses = [imdb_bench.train_step(params, opt, state, _t(ids),
                                    _t(labels), fused).item()
              for _ in range(STEPS)]
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-5)
    ref_state = from_jax_opt_state(
        jax.tree_util.tree_map(np.asarray, ref_state), params)
    assert state["step"] == ref_state["step"] == STEPS
    for k, p in params.items():
        np.testing.assert_allclose(p.detach().numpy(),
                                   np.asarray(ref_params[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
        for acc in ("m", "v"):
            ref = ref_state[acc][k].numpy()
            np.testing.assert_allclose(state[acc][k].numpy(), ref,
                                       rtol=1e-5,
                                       atol=1e-5 * np.abs(ref).max(),
                                       err_msg=f"{acc} {k}")
    untouched = np.setdiff1d(np.arange(init["table"].shape[0]), ids)
    assert untouched.size > 0
    np.testing.assert_array_equal(params["table"].detach().numpy()[untouched],
                                  init["table"][untouched])


def test_imdb_bench_runs_on_the_cpu():
    out = imdb_bench.run(device="cpu", steps=2)
    assert out["unit"] == "samples/s" and out["value"] > 0
    assert (out["batch"], out["max_len"], out["dim"], out["vocab"]) == (
        8, 32, 16, 5149)
    assert np.isfinite(out["final_loss"]) and "device" not in out
