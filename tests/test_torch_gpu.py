"""Card-only tests of the port's CUDA kernels (marker ``gpu``).

They skip where no CUDA device is present. This file imports neither JAX
nor the JAX package, so it also runs on a GPU machine without JAX:

    python3 -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_gpu.py

Tolerances: float32 o within 1e-5 of the plain version (same float32
function, another summation order); bfloat16 o within 1e-2 relative
(one bf16 rounding step of an output that differs in float32 by ~1e-7);
lse within 1e-5 relative in both.
"""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.kernels import attention as port

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# (name, b, h, tq, tk, d, causal, masked): the serving path's shapes
# (encoder 64x8x64x64, decode Tq=1), a causal case and ragged edges
SHAPES = [
    ("encoder", 64, 8, 64, 64, 64, False, True),
    ("decode", 64, 8, 1, 64, 64, False, True),
    ("causal", 2, 3, 40, 40, 16, True, False),
    ("ragged", 3, 2, 5, 70, 100, False, True),
    ("d128", 2, 2, 17, 33, 128, False, False),
]


def _inputs(dev, dtype, b, h, tq, tk, d, masked):
    g = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn(b, h, t, d, device=dev, generator=g).to(dtype)
               for t in (tq, tk, tk))
    m = None
    if masked:
        m = torch.rand(b, tk, device=dev, generator=g) > 0.3
        m[0] = False     # a fully masked row
    return q, k, v, m


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", SHAPES, ids=[s[0] for s in SHAPES])
def test_kernel_matches_plain_version(cuda, shape, dtype):
    _, b, h, tq, tk, d, causal, masked = shape
    q, k, v, m = _inputs(cuda, dtype, b, h, tq, tk, d, masked)
    before = port.flash_attention.launches
    o, lse = port.flash_fwd_cuda(q, k, v, causal, d ** -0.5, m)
    torch.cuda.synchronize()
    assert port.flash_attention.launches == before + 1
    ro, rl = port.flash_attention_reference(q, k, v, causal, d ** -0.5, m)
    assert o.dtype == dtype and lse.dtype == torch.float32
    assert torch.isfinite(o).all() and torch.isfinite(lse).all()
    err = ((o.float() - ro.float()).abs() / (1 + ro.float().abs())).max()
    assert err.item() < (1e-5 if dtype == torch.float32 else 1e-2)
    rel = ((lse - rl).abs() / rl.abs().clamp(min=1)).max()
    assert rel.item() < 1e-5
    if masked:   # the fully masked row: uniform mean of V
        np.testing.assert_allclose(
            o[0].float().cpu().numpy(),
            v[0].float().mean(dim=1, keepdim=True).expand_as(o[0])
            .to(dtype).float().cpu().numpy(), rtol=1e-2, atol=1e-5)


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    q = torch.randn(1, 1, 4, 8, device=cuda)
    with pytest.raises(ValueError):
        port.flash_fwd_cuda(q.transpose(2, 3), q.transpose(2, 3),
                            q.transpose(2, 3), False, 1.0)
    big = torch.randn(1, 1, 4, 160, device=cuda)
    with pytest.raises(ValueError):
        port.flash_fwd_cuda(big, big, big, False, 1.0)
    with pytest.raises(TypeError):
        port.flash_fwd_cuda(q, q.half(), q, False, 1.0)
    with pytest.raises(TypeError):
        port.flash_fwd_cuda(q.half(), q.half(), q.half(), False, 1.0)
    with pytest.raises(ValueError):      # a CUDA tensor, device="cpu"
        port.flash_attention(q, q, q, device="cpu")


def test_tiny_model_tokens_equal_with_and_without_kernel(cuda):
    from paddle_tpu_torch.inference import GenerationConfig, Generator
    from paddle_tpu_torch.models import Transformer, TransformerConfig
    src = np.random.RandomState(1).randint(3, 100, (3, 7)).astype(np.int32)
    src[2, 4:] = 0
    out = {}
    for use_flash in (False, True):
        model = Transformer(TransformerConfig.tiny(
            n_layer=2, dropout=0.0, use_flash=use_flash), device=cuda,
            seed=3)
        gen = Generator(model, GenerationConfig(
            max_len=12, batch_buckets=(4,), src_len_buckets=(8,)),
            device=cuda)
        before = port.flash_attention.launches
        out[use_flash] = gen.generate(src)
        launched = port.flash_attention.launches - before
        if use_flash:   # 2 encoder layers + 2 x 2 per decode step
            assert launched > 2 and (launched - 2) % 4 == 0
        else:
            assert launched == 0
    np.testing.assert_array_equal(out[True], out[False])
