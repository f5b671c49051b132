"""The port's conv kernels' plain versions against the JAX package's Pallas
kernels (interpret mode), on the CPU.

- ``tiles.brgemm`` (kernel #4): modes "nn" and "tn", each epilogue link
  (scale, bias, residual, relu) and the cotangent fold (relu mask from a
  saved output, then a per-channel scale) on a and on b.
- ``conv_fused.conv2d_bn_act`` (#4 for 1x1, #6-#8 for KxK): the output and
  the gradients of x, w, scale, bias and residual over the grid of
  ``tests/test_conv_fused.py`` (ks 1/3, stride 1/2, residual, act), odd
  spatial sizes; and the port's plain version (autograd through
  ``conv_epilogue_reference``) against the JAX module's ``CONV_BWD_FUSED``
  off route (autograd through its XLA reference), which the port does not
  carry as a knob.

Inputs come from numpy with a seed and go to both sides. Tolerances are
those of ``tests/test_conv_fused.py``: float32 forward 1e-5, backward
1e-4 (the same float32 sums in another order); a bfloat16 brgemm output
2e-2 (one bf16 rounding of two float32 sums that differ by ~1e-7 can
part by an ulp, 2^-7 relative at most), a bfloat16 conv 0.1 as there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels import conv_fused as jcf
from paddle_tpu.kernels import epilogues as jep
from paddle_tpu.kernels import tiles as jtiles
from paddle_tpu_torch.kernels import conv_fused as pcf
from paddle_tpu_torch.kernels import epilogues as pep
from paddle_tpu_torch.kernels import tiles as ptiles

TORCH_DT = {"f32": torch.float32, "bf16": torch.bfloat16}
JAX_DT = {"f32": jnp.float32, "bf16": jnp.bfloat16}


def _pair(a, dt):
    """The same values for both sides: (jax array, torch tensor)."""
    j = jnp.asarray(a).astype(JAX_DT[dt])
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(
        TORCH_DT[dt])


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(jnp.asarray(t).astype(jnp.float32))


# -- brgemm (#4) ---------------------------------------------------------------

M, K, N = 40, 24, 48

# (id, mode, epilogue links, fold_on, fold links)
BRGEMM_CASES = [
    ("nn_plain", "nn", (), None, ()),
    ("nn_scale", "nn", ("scale",), None, ()),
    ("nn_scale_bias", "nn", ("scale", "bias"), None, ()),
    ("nn_bias_relu", "nn", ("bias", "relu"), None, ()),
    ("nn_residual", "nn", ("residual",), None, ()),
    ("nn_full_chain", "nn", ("scale", "bias", "residual", "relu"), None, ()),
    ("nn_fold_a_mask", "nn", (), "a", ("mask",)),
    ("nn_fold_a_scale", "nn", (), "a", ("scale",)),
    ("nn_fold_a_mask_scale", "nn", (), "a", ("mask", "scale")),
    ("nn_fold_b_mask_scale", "nn", (), "b", ("mask", "scale")),
    ("tn_plain", "tn", (), None, ()),
    ("tn_fold_b_mask_scale", "tn", (), "b", ("mask", "scale")),
    ("tn_fold_b_scale_relu_out", "tn", ("bias", "relu"), "b", ("scale",)),
    ("tn_fold_a_mask", "tn", (), "a", ("mask",)),
]


def _brgemm_inputs(mode, links, fold_on, fold_links, dt, seed=0):
    rs = np.random.RandomState(seed)
    a_shape = (M, K) if mode == "nn" else (K, M)
    a = rs.randn(*a_shape).astype(np.float32)
    b = rs.randn(K, N).astype(np.float32)
    ops = {"scale": rs.rand(N).astype(np.float32) + 0.5,
           "bias": rs.randn(N).astype(np.float32),
           "residual": rs.randn(M, N).astype(np.float32)}
    folded = a if fold_on == "a" else b
    # a saved output with exact zeros and negatives, as a relu output
    # masked by an upstream op would have
    mask = np.where(rs.rand(*folded.shape) < 0.3, 0.0,
                    rs.randn(*folded.shape)).astype(np.float32)
    fscale = rs.rand(folded.shape[-1]).astype(np.float32) + 0.5
    return a, b, ops, mask, fscale


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("case", BRGEMM_CASES, ids=[c[0] for c in
                                                     BRGEMM_CASES])
def test_brgemm_reference_matches_the_jax_kernel(case, dt):
    _, mode, links, fold_on, fold_links = case
    a, b, ops, mask, fscale = _brgemm_inputs(mode, links, fold_on,
                                             fold_links, dt)
    ja, ta = _pair(a, dt)
    jb, tb = _pair(b, dt)
    chain = jep.Epilogue()
    j_ops, kw = [], {}
    for link in links:
        chain = chain + getattr(jep, link)()
        if link == "relu":
            kw["relu"] = True
            continue
        j_ops.append(jnp.asarray(ops[link]))
        kw[link] = torch.from_numpy(ops[link])
    jfold, j_fold_ops = None, []
    if fold_on is not None:
        jfold = jep.Epilogue()
        if "scale" in fold_links:
            jfold = jfold + jep.scale()
        if "mask" in fold_links:
            jfold = jfold + jep.relu()
            jm, tm = _pair(mask, dt)
            j_fold_ops.append(jm)
            kw["fold_mask"] = tm
        if "scale" in fold_links:
            j_fold_ops.append(jnp.asarray(fscale))
            kw["fold_scale"] = torch.from_numpy(fscale)
        kw["fold_on"] = fold_on
    ref = jtiles.brgemm(ja, jb, mode=mode, epilogue=chain or None,
                        epilogue_operands=j_ops, fold=jfold,
                        fold_on=fold_on or "a", fold_operands=j_fold_ops,
                        interpret=True)
    got = ptiles.brgemm(ta, tb, mode=mode, **kw)
    assert got.dtype == TORCH_DT[dt] and tuple(got.shape) == (M, N)
    tol = 1e-5 if dt == "f32" else 2e-2
    np.testing.assert_allclose(_np(got), _np(ref), rtol=tol, atol=tol)


def test_brgemm_out_dtype_and_counts_no_launch_on_cpu():
    a = torch.randn(8, 16)
    b = torch.randn(16, 8)
    before = ptiles.brgemm.launches
    out = ptiles.brgemm(a, b, out_dtype=torch.bfloat16)
    assert out.dtype == torch.bfloat16
    assert ptiles.brgemm.launches == before


def test_fold_cotangent_masks_then_scales_then_rounds():
    g = torch.tensor([[1.0, -2.0, 3.0]], dtype=torch.bfloat16)
    mask = torch.tensor([[0.5, 0.0, -1.0]])
    scale = torch.tensor([3.0, 5.0, 7.0])
    dy = pep.fold_cotangent(g, mask, scale, torch.bfloat16)
    assert dy.dtype == torch.bfloat16
    assert dy.float().tolist() == [[3.0, 0.0, 0.0]]


@pytest.mark.parametrize("m,n,k", [(64, 256, 802816), (512, 2048, 12544),
                                   (4608, 512, 12544), (200000, 64, 64)])
def test_split_k_covers_k_in_steps_of_the_tile(m, n, k, monkeypatch):
    class Props:
        multi_processor_count = 132
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: Props)
    splits, per = ptiles.split_k(m, n, k, "cuda")
    assert per % ptiles.TILE_K == 0 and per >= min(k, 1024)
    assert (splits - 1) * per < k <= splits * per
    assert 1 <= splits <= 256


# -- conv2d_bn_act (#4, #6, #7, #8) ---------------------------------------------


def _conv_inputs(n, hw, c, o, ks, res, dt, stride, pad, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.randn(n, hw, hw, c).astype(np.float32)
    w = (rs.randn(o, c, ks, ks) * 0.1).astype(np.float32)
    scale = (rs.randn(o) * 0.5 + 1.0).astype(np.float32)
    bias = rs.randn(o).astype(np.float32)
    oh = (hw + 2 * pad - ks) // stride + 1
    r = rs.randn(n, oh, oh, o).astype(np.float32) if res else None
    cot = rs.randn(n, oh, oh, o).astype(np.float32)
    return x, w, scale, bias, r, cot


def _conv_pair(args, act, stride, pad, dt, port_plain=False, jax_knob=True):
    """(jax out, jax grads, port out, port grads) of sum(out * cot) with
    respect to every present operand. ``port_plain`` differentiates the
    port's ``conv_epilogue_reference`` instead of its kernel route."""
    x, w, scale, bias, r, cot = args
    present = [v for v in (x, w, scale, bias, r) if v is not None]
    dts = [dt, dt, "f32", "f32", dt][:len(present)]
    jv, tv = zip(*(_pair(v, d) for v, d in zip(present, dts)))
    jcot, tcot = _pair(cot, dt)

    def jf(*a):
        rr = a[4] if len(a) > 4 else None
        out = jcf.conv2d_bn_act(a[0], a[1], a[2], a[3], rr, act, stride,
                                pad, interpret=True)
        return jnp.sum(out.astype(jnp.float32) * jcot.astype(jnp.float32)), \
            out

    with jcf.conv_bwd_fused(jax_knob):
        (_, jout), jgrads = jax.value_and_grad(
            jf, argnums=tuple(range(len(jv))), has_aux=True)(*jv)
    tv = [t.requires_grad_() for t in tv]
    port_fn = pcf.conv_epilogue_reference if port_plain else pcf.conv2d_bn_act
    tout = port_fn(tv[0], tv[1], tv[2], tv[3],
                   tv[4] if len(tv) > 4 else None, act, stride, pad)
    tgrads = torch.autograd.grad((tout.float() * tcot.float()).sum(), tv)
    return jout, jgrads, tout, tgrads


def _assert_pair(jout, jgrads, tout, tgrads, fwd_tol, bwd_tol):
    assert tout.dtype == TORCH_DT["bf16" if jout.dtype == jnp.bfloat16
                                  else "f32"]
    np.testing.assert_allclose(_np(tout), _np(jout), rtol=fwd_tol,
                               atol=fwd_tol)
    names = ["x", "w", "scale", "bias", "residual"]
    for name, jg, tg in zip(names, jgrads, tgrads):
        assert tuple(tg.shape) == tuple(jg.shape), name
        np.testing.assert_allclose(_np(tg), _np(jg), rtol=bwd_tol,
                                   atol=bwd_tol, err_msg=name)


@pytest.mark.parametrize("act", [None, "relu"])
@pytest.mark.parametrize("res", [False, True])
@pytest.mark.parametrize("ks,stride,pad", [(1, 1, 0), (1, 2, 0),
                                           (3, 1, 1), (3, 2, 1)])
def test_conv2d_bn_act_matches_jax_f32(ks, stride, pad, res, act):
    args = _conv_inputs(2, 8, 16, 32, ks, res, "f32", stride, pad)
    _assert_pair(*_conv_pair(args, act, stride, pad, "f32"), 1e-5, 1e-4)


@pytest.mark.parametrize("hw", [7, 9])
@pytest.mark.parametrize("ks,stride,pad", [(1, 2, 0), (3, 2, 1)])
def test_conv2d_bn_act_odd_spatial_sizes(ks, stride, pad, hw):
    """The stride-2 dx is where an off-by-one hides: odd H and W."""
    args = _conv_inputs(2, hw, 8, 16, ks, True, "f32", stride, pad, seed=1)
    _assert_pair(*_conv_pair(args, "relu", stride, pad, "f32"), 1e-5, 1e-4)


@pytest.mark.parametrize("ks,stride,pad", [(1, 2, 0), (3, 2, 1)])
def test_conv_epilogue_reference_matches_jax_bwd_off(ks, stride, pad):
    """The port's plain version against the JAX knob-off route: autograd
    through the reference on both sides."""
    args = _conv_inputs(2, 8, 16, 32, ks, True, "f32", stride, pad, seed=2)
    _assert_pair(*_conv_pair(args, "relu", stride, pad, "f32",
                             port_plain=True, jax_knob=False), 1e-5, 1e-4)


def test_conv_kernel_bwd_matches_reference_autograd():
    """The kernel route's backward against autograd through the port's
    own plain version."""
    args = _conv_inputs(2, 8, 8, 16, 3, False, "f32", 1, 1, seed=3)
    kern = _conv_pair(args, "relu", 1, 1, "f32")
    plain = _conv_pair(args, "relu", 1, 1, "f32", port_plain=True)
    for a, b in zip(kern[3], plain[3]):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("ks,stride,pad", [(1, 1, 0), (3, 2, 1)])
def test_conv2d_bn_act_bf16(ks, stride, pad):
    args = _conv_inputs(2, 8, 16, 32, ks, True, "bf16", stride, pad)
    _assert_pair(*_conv_pair(args, "relu", stride, pad, "bf16"), 0.1, 0.1)


def test_conv2d_bn_act_rejects_what_the_kernels_do_not_take():
    x = torch.randn(1, 4, 4, 8)
    with pytest.raises(ValueError, match="grouped"):
        pcf.conv2d_bn_act(x, torch.randn(4, 4, 3, 3))
    with pytest.raises(ValueError, match="relu"):
        pcf.conv2d_bn_act(x, torch.randn(4, 8, 3, 3), act="sigmoid")


def test_geometry_of_a_strided_padded_conv():
    geo = pcf.geometry((2, 7, 9, 3), (5, 3, 3, 3), (2, 2), ((1, 1), (1, 1)),
                       (1, 1))
    assert geo == (2, 7, 9, 3, 5, 3, 3, 4, 5, 2, 2, 1, 1, 1, 1)


def test_cuda_wrappers_refuse_cpu_tensors():
    """A kernel wrapper never falls back: given CPU tensors it raises."""
    x, w = torch.randn(1, 5, 5, 4), torch.randn(4, 4, 3, 3)
    g = torch.randn(1, 5, 5, 4)
    pads = ((1, 1), (1, 1))
    calls = [
        lambda: ptiles.brgemm_cuda(torch.randn(4, 8), torch.randn(8, 4)),
        lambda: pcf.convkxk_cuda(x, w, padding=pads),
        lambda: pcf.convkxk_dx_cuda(g, None, None, w, x.shape, x.dtype,
                                    (1, 1), pads, (1, 1)),
        lambda: pcf.convkxk_dw_cuda(g, None, None, x, w.shape, x.dtype,
                                    (1, 1), pads, (1, 1)),
    ]
    for call in calls:
        with pytest.raises(ValueError, match="CUDA"):
            call()
