"""The port's BatchingGeneratorServer against the JAX package's, on the CPU.

Both servers run over a Generator with the same tiny float32 weights
(initialized in JAX, carried over with ``from_jax_variables``).
Concurrent single requests must resolve to the rows the JAX server
returns for them, token for token; ``max_new`` trims, an expired ``ttl``
raises ``RequestExpired``, and ``stop()`` drains and is idempotent.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import models as jm
from paddle_tpu.inference import BatchingGeneratorServer as JaxServer
from paddle_tpu.inference import GenerationConfig as JaxGenConfig
from paddle_tpu.inference import Generator as JaxGenerator
from paddle_tpu_torch.convert import from_jax_variables
from paddle_tpu_torch.inference import (BatchingGeneratorServer,
                                        GenerationConfig, Generator,
                                        RequestExpired)
from paddle_tpu_torch.models import transformer as pm

GEN_KW = dict(max_len=10, batch_buckets=(1, 4, 8), src_len_buckets=(8,))


def _generators(use_flash=True):
    cfg = jm.TransformerConfig.tiny(n_layer=2, dropout=0.0,
                                    use_flash=use_flash)
    jmodel = jm.Transformer(cfg)
    src = jnp.asarray(np.random.RandomState(1).randint(3, 100, (2, 8)))
    variables = jmodel.init(jax.random.PRNGKey(1), src, src)
    pmodel = pm.Transformer(pm.TransformerConfig.tiny(
        n_layer=2, dropout=0.0, use_flash=use_flash), device="cpu")
    from_jax_variables(jax.tree_util.tree_map(np.asarray, variables),
                       pmodel)
    return (JaxGenerator(jmodel, variables, JaxGenConfig(**GEN_KW)),
            Generator(pmodel, GenerationConfig(**GEN_KW), device="cpu"))


def _requests(n=8, seed=5):
    rs = np.random.RandomState(seed)
    return [rs.randint(3, 100, (int(rs.randint(2, 8)),)).astype(np.int32)
            for _ in range(n)]


def _submit_concurrently(srv, reqs, **kw):
    futs = [None] * len(reqs)

    def post(i):
        futs[i] = srv.submit(reqs[i], **kw)

    threads = [threading.Thread(target=post, args=(i,))
               for i in range(len(reqs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    return futs


def test_concurrent_submits_match_jax_server():
    jgen, pgen = _generators()
    reqs = _requests()
    jsrv = JaxServer(jgen, max_batch=4, max_wait_ms=50)
    psrv = BatchingGeneratorServer(pgen, max_batch=4, max_wait_ms=50,
                                   device="cpu")
    try:
        want = [f.result(timeout=120)
                for f in _submit_concurrently(jsrv, reqs)]
        got = [f.result(timeout=120)
               for f in _submit_concurrently(psrv, reqs)]
    finally:
        jsrv.stop()
        psrv.stop()
    for w, g in zip(want, got):
        assert g.shape == (GEN_KW["max_len"],)
        np.testing.assert_array_equal(g, np.asarray(w))


def test_max_new_trims_the_row():
    _, pgen = _generators()
    srv = BatchingGeneratorServer(pgen, max_batch=4, device="cpu")
    try:
        req = _requests(1)[0]
        full = srv.submit(req).result(timeout=60)
        short = srv.submit(req, max_new=3).result(timeout=60)
    finally:
        srv.stop()
    np.testing.assert_array_equal(short[:3], full[:3])
    assert (short[3:] == 0).all()
    with pytest.raises(ValueError):
        srv.submit(req, max_new=0)


class _GatedGenerator:
    """Holds its first batch until released, so later requests queue."""

    def __init__(self, gen):
        self.gen, self.cfg, self.device = gen, gen.cfg, gen.device
        self.started, self.release = threading.Event(), threading.Event()

    def generate(self, src):
        self.started.set()
        assert self.release.wait(timeout=30)
        return self.gen.generate(src)


def test_ttl_expiry_raises_request_expired():
    _, pgen = _generators()
    gated = _GatedGenerator(pgen)
    srv = BatchingGeneratorServer(gated, max_batch=1, max_wait_ms=1,
                                  device="cpu")
    try:
        first = srv.submit(_requests(1)[0])
        assert gated.started.wait(timeout=30)
        late = srv.submit(_requests(1, seed=6)[0], ttl=0.01)
        kept = srv.submit(_requests(1, seed=7)[0], ttl=60.0)
        threading.Event().wait(0.05)     # let the short ttl pass
        gated.release.set()
        assert first.result(timeout=60).shape == (GEN_KW["max_len"],)
        with pytest.raises(RequestExpired):
            late.result(timeout=60)
        assert kept.result(timeout=60).shape == (GEN_KW["max_len"],)
    finally:
        gated.release.set()
        srv.stop()


def test_stop_drains_and_is_idempotent():
    _, pgen = _generators()
    srv = BatchingGeneratorServer(pgen, max_batch=4, max_wait_ms=20,
                                  device="cpu")
    futs = [srv.submit(r) for r in _requests(6)]
    srv.stop()                           # drain: every queued request served
    assert all(f.done() and not f.cancelled() for f in futs)
    assert all(f.result().shape == (GEN_KW["max_len"],) for f in futs)
    with pytest.raises(RuntimeError):
        srv.submit([5, 6])
    srv.stop()
    srv.stop(drain=False)
    assert not srv._worker.is_alive()


def test_stop_without_drain_cancels_queued_requests():
    _, pgen = _generators()
    gated = _GatedGenerator(pgen)
    srv = BatchingGeneratorServer(gated, max_batch=1, max_wait_ms=1,
                                  device="cpu")
    first = srv.submit(_requests(1)[0])
    assert gated.started.wait(timeout=30)
    queued = [srv.submit(r) for r in _requests(3, seed=8)]
    stopper = threading.Thread(target=srv.stop, kwargs={"drain": False})
    stopper.start()
    threading.Event().wait(0.05)
    gated.release.set()
    stopper.join(timeout=60)
    assert not stopper.is_alive()
    assert first.result(timeout=60).shape == (GEN_KW["max_len"],)
    assert all(f.cancelled() for f in queued)


def test_failed_batch_fails_its_futures():
    _, pgen = _generators()

    class Broken:
        cfg, device = pgen.cfg, pgen.device

        def generate(self, src):
            raise RuntimeError("decode failed")

    srv = BatchingGeneratorServer(Broken(), max_batch=4, device="cpu")
    try:
        fut = srv.submit([5, 6, 7])
        with pytest.raises(RuntimeError, match="decode failed"):
            fut.result(timeout=30)
    finally:
        srv.stop()


def test_server_device_must_match_generator():
    _, pgen = _generators()
    if torch.cuda.is_available():
        with pytest.raises(ValueError):
            BatchingGeneratorServer(pgen, device="cuda")
    else:
        with pytest.raises(RuntimeError):
            BatchingGeneratorServer(pgen)
