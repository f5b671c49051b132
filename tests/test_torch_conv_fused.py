"""The port's conv kernels' plain versions against the JAX package's Pallas
kernels (interpret mode), on the CPU.

- ``tiles.brgemm`` (kernel #4): modes "nn" and "tn", each epilogue link
  (scale, bias, residual, relu) and the cotangent fold (relu mask from a
  saved output, then a per-channel scale) on a and on b.
- ``conv_fused.kxk_fwd_route``, ``dw_route`` and ``tiles.gemm_route``: the
  rules (one shared test, ``tiles.tc_fits``) that send a bf16 3x3 forward
  and weight gradient, and a bf16 1x1 GEMM, to the tensor-core kernels;
  ``tiles.gemm_geometry``: at its 1x1 geometry the 3x3 kernels' plain
  versions compute the JAX ``brgemm``.
- ``conv_fused.dx_route``, ``dx_geometry`` and ``dx_phases`` (#7): the
  rule that sends a bf16 dx that folds nothing to the tensor-core
  forward, at stride 1 as one conv (``"tc"``, which refuses a larger
  stride) and at a larger stride as one conv a phase of dx
  (``"tc_phase"``), and the geometries they run there: the forward conv
  of g with the taps flipped and C and O swapped (over g dilated by the
  stride, as the reference dilates it), and each phase's conv of g itself
  with the taps that reach the phase, which a brute force over the conv's
  products holds; the plain versions of both compute the JAX
  ``_convkxk_dx``.
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

import itertools
from collections import Counter

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


@pytest.mark.parametrize("dtype,c,o,aligned,route", [
    (torch.bfloat16, 64, 64, True, "tc"),
    (torch.bfloat16, 512, 192, True, "tc"),
    (torch.float32, 64, 64, True, "simt"),
    (torch.bfloat16, 16, 64, True, "simt"),
    (torch.bfloat16, 64, 70, True, "simt"),
    (torch.bfloat16, 64, 64, False, "simt"),
    (None, 64, 64, True, "simt"),
], ids=["bf16_64", "bf16_512_192", "f32", "c16", "o70", "misaligned",
        "mixed_dtypes"])
def test_dw_route_takes_the_tensor_cores_only_where_they_fit(dtype, c, o,
                                                             aligned, route):
    assert pcf.dw_route(dtype, c, o, aligned) == route


@pytest.mark.parametrize("dtype,c,o,aligned,route", [
    (torch.bfloat16, 64, 64, True, "tc"),
    (torch.bfloat16, 512, 512, True, "tc"),
    (torch.float32, 64, 64, True, "simt"),
    (torch.bfloat16, 16, 64, True, "simt"),
    (torch.bfloat16, 64, 70, True, "simt"),
    (None, 64, 64, True, "simt"),
    (torch.bfloat16, 64, 64, False, "simt"),
], ids=["bf16_64", "bf16_512", "f32", "c16", "o70", "f32_w_beside_bf16_x",
        "misaligned"])
def test_kxk_fwd_route_takes_the_tensor_cores_only_where_they_fit(
        dtype, c, o, aligned, route):
    assert pcf.kxk_fwd_route(dtype, c, o, aligned) == route


# (m, n, k) of ResNet-50's 3x3 weight gradients at batch 256 (M = 9C, N = O,
# K = N*OH*OW), and short and ragged K
TC_SPLIT_CASES = [(576, 64, 802816), (1152, 128, 200704), (2304, 256, 50176),
                  (4608, 512, 12544), (576, 64, 75), (576, 64, 3000),
                  (4608, 512, 4097), (64 * 9, 192, 65536)]


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("m,n,k", TC_SPLIT_CASES, ids=str)
def test_split_k_tc_covers_k_in_deep_steps_over_two_waves(m, n, k, sms):
    splits, per = ptiles.split_k_tc(m, n, k, sms)
    assert per % ptiles.TC_TILE_K == 0
    assert (splits - 1) * per < k <= splits * per
    assert splits == 1 or per >= ptiles.TC_MIN_SPLIT
    blocks = -(-m // ptiles.TC_TILE_M) * (n // ptiles.tc_tile_n(n)) * splits
    if k >= 2 * sms * ptiles.TC_MIN_SPLIT:      # deep enough for two waves
        assert blocks >= 2 * sms


# -- brgemm's routes: the tensor-core conv kernels at a 1x1 geometry ------------

# (id, mode, fold, epilogue, dtype, m_or_k, n, aligned, route)
GEMM_ROUTE_CASES = [
    ("nn_bf16_64", "nn", None, False, torch.bfloat16, 64, 64, True,
     "tc_fwd"),
    ("nn_bf16_epilogue", "nn", None, True, torch.bfloat16, 2048, 512, True,
     "tc_fwd"),
    ("nn_fold_a", "nn", "a", False, torch.bfloat16, 256, 64, True, "simt"),
    ("nn_fold_b", "nn", "b", False, torch.bfloat16, 256, 64, True, "simt"),
    ("nn_f32", "nn", None, False, torch.float32, 64, 64, True, "simt"),
    ("nn_mixed", "nn", None, False, None, 64, 64, True, "simt"),
    ("nn_k48", "nn", None, False, torch.bfloat16, 48, 64, True, "simt"),
    ("nn_n70", "nn", None, False, torch.bfloat16, 64, 70, True, "simt"),
    ("nn_misaligned", "nn", None, False, torch.bfloat16, 64, 64, False,
     "simt"),
    ("tn_bf16_64", "tn", None, False, torch.bfloat16, 64, 64, True,
     "tc_dw"),
    ("tn_fold_b", "tn", "b", False, torch.bfloat16, 1024, 2048, True,
     "tc_dw"),
    ("tn_fold_a", "tn", "a", False, torch.bfloat16, 64, 64, True, "simt"),
    ("tn_epilogue", "tn", None, True, torch.bfloat16, 64, 64, True, "simt"),
    ("tn_fold_b_epilogue", "tn", "b", True, torch.bfloat16, 64, 64, True,
     "simt"),
    ("tn_f32", "tn", "b", False, torch.float32, 64, 64, True, "simt"),
    ("tn_mixed_mask", "tn", "b", False, None, 64, 64, True, "simt"),
    ("tn_m16", "tn", None, False, torch.bfloat16, 16, 64, True, "simt"),
    ("tn_n192", "tn", None, False, torch.bfloat16, 64, 192, True, "tc_dw"),
    ("tn_n100", "tn", None, False, torch.bfloat16, 64, 100, True, "simt"),
    ("tn_misaligned", "tn", "b", False, torch.bfloat16, 64, 64, False,
     "simt"),
]


@pytest.mark.parametrize("case", GEMM_ROUTE_CASES,
                         ids=[c[0] for c in GEMM_ROUTE_CASES])
def test_gemm_route_takes_the_tensor_cores_only_where_they_fit(case):
    _, mode, fold, epilogue, dtype, m_or_k, n, aligned, route = case
    assert ptiles.gemm_route(mode, fold, epilogue, dtype, m_or_k, n,
                             aligned) == route


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, None],
                         ids=["bf16", "f32", "mixed"])
def test_the_three_tensor_core_routes_share_one_rule(dtype):
    """``kxk_fwd_route``, ``dw_route`` and ``gemm_route`` (without a fold
    or an epilogue, which only it sees) all take ``tiles.tc_fits``."""
    for c in (16, 48, 64, 70, 128, 192, 512):
        for o in (64, 100, 128, 2048):
            for aligned in (True, False):
                fits = ptiles.tc_fits(dtype, c, o, aligned)
                want = "tc" if fits else "simt"
                assert pcf.kxk_fwd_route(dtype, c, o, aligned) == want
                assert pcf.dw_route(dtype, c, o, aligned) == want
                for mode, tc in (("nn", "tc_fwd"), ("tn", "tc_dw")):
                    assert ptiles.gemm_route(mode, None, False, dtype, c, o,
                                             aligned) == (
                        tc if fits else "simt")


def _gemm_as_conv(mode, a, b, out_dtype=None, scale=None, bias=None,
                  residual=None, relu=False, fold_mask=None,
                  fold_scale=None):
    """What the tensor-core routes compute: the conv kernels' plain
    versions at ``tiles.gemm_geometry``'s 1x1 geometry (checked against
    ``conv_fused.geometry``), reshaped back to the GEMM's [M, N]."""
    one = ((1, 1), ((0, 0), (0, 0)), (1, 1))
    if mode == "nn":
        (m, k), n = a.shape, b.shape[1]
        x, w = a.reshape(m, 1, 1, k), b.t().reshape(n, k, 1, 1)
        assert pcf.geometry(x.shape, w.shape, *one) == \
            ptiles.gemm_geometry("nn", m, n, k)
        res = None if residual is None else residual.reshape(m, 1, 1, n)
        out = pcf.convkxk_reference(x, w, scale, bias, res, relu, *one,
                                    out_dtype=out_dtype or a.dtype)
        return out.reshape(m, n)
    (k, m), n = a.shape, b.shape[1]
    x, g = a.reshape(k, 1, 1, m), b.reshape(k, 1, 1, n)
    assert pcf.geometry(x.shape, (n, m, 1, 1), *one) == \
        ptiles.gemm_geometry("tn", m, n, k)
    mask = None if fold_mask is None else fold_mask.reshape(k, 1, 1, n)
    dw = pcf.convkxk_dw_reference(g, mask, fold_scale, x, (n, m, 1, 1),
                                  out_dtype or a.dtype, *one)
    return dw.reshape(n, m).t()


def test_gemm_geometry_of_both_modes():
    assert ptiles.gemm_geometry("nn", 40, 128, 64) == \
        (40, 1, 1, 64, 128, 1, 1, 1, 1, 1, 1, 0, 0, 1, 1)
    assert ptiles.gemm_geometry("tn", 64, 128, 75) == \
        (75, 1, 1, 64, 128, 1, 1, 1, 1, 1, 1, 0, 0, 1, 1)
    with pytest.raises(ValueError):
        ptiles.gemm_geometry("nt", 1, 1, 1)


# (id, mode, epilogue links, residual dtype, out dtype, fold links): the
# calls the tensor-core routes take, at widths they take (K, M, N
# multiples of 64; M and K of the other mode ragged)
TC_GEMM_CASES = [
    ("nn_plain", "nn", (), None, None, ()),
    ("nn_chain_res_f32", "nn", ("scale", "bias", "residual", "relu"), "f32",
     None, ()),
    ("nn_chain_res_bf16", "nn", ("scale", "bias", "residual", "relu"),
     "bf16", None, ()),
    ("nn_chain_out_f32", "nn", ("scale", "bias", "relu"), None, "f32", ()),
    ("tn_plain", "tn", (), None, None, ()),
    ("tn_mask", "tn", (), None, None, ("mask",)),
    ("tn_scale", "tn", (), None, None, ("scale",)),
    ("tn_mask_scale", "tn", (), None, None, ("mask", "scale")),
]
TC_M, TC_K, TC_N = 40, 64, 128


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("case", TC_GEMM_CASES,
                         ids=[c[0] for c in TC_GEMM_CASES])
def test_gemm_geometry_conv_matches_the_jax_brgemm(case, dt):
    """At ``gemm_geometry``, the 3x3 kernels' plain versions compute the
    JAX ``brgemm`` (interpret mode) and the port's ``brgemm_reference``:
    what ``tc_fwd`` and ``tc_dw`` run on the card is #4's function. Every
    width is a multiple of 64 but the "nn" M and the "tn" K (40)."""
    _, mode, links, res_dt, out_dt, fold_links = case
    rs = np.random.RandomState(7)
    m, k, n = (TC_M, TC_K, TC_N) if mode == "nn" else (TC_K, TC_M, TC_N)
    a = rs.randn(*((m, k) if mode == "nn" else (k, m))).astype(np.float32)
    b = rs.randn(k, n).astype(np.float32)
    ja, ta = _pair(a, dt)
    jb, tb = _pair(b, dt)
    out_dtype = None if out_dt is None else TORCH_DT[out_dt]
    chain, j_ops, kw = jep.Epilogue(), [], {}
    for link in links:
        chain = chain + getattr(jep, link)()
        if link == "relu":
            kw["relu"] = True
        elif link == "residual":
            jr, tr = _pair(rs.randn(m, n).astype(np.float32), res_dt)
            j_ops.append(jr)
            kw["residual"] = tr
        else:
            v = (rs.rand(n) + 0.5 if link == "scale" else
                 rs.randn(n)).astype(np.float32)
            j_ops.append(jnp.asarray(v))
            kw[link] = torch.from_numpy(v)
    jfold, j_fold_ops = None, []
    if fold_links:
        jfold = jep.Epilogue()
        if "scale" in fold_links:
            jfold = jfold + jep.scale()
        if "mask" in fold_links:
            jfold = jfold + jep.relu()
            mask = np.where(rs.rand(k, n) < 0.3, 0.0,
                            rs.randn(k, n)).astype(np.float32)
            jm, kw["fold_mask"] = _pair(mask, dt)
            j_fold_ops.append(jm)
        if "scale" in fold_links:
            fs = (rs.rand(n) + 0.5).astype(np.float32)
            j_fold_ops.append(jnp.asarray(fs))
            kw["fold_scale"] = torch.from_numpy(fs)
    ref = jtiles.brgemm(ja, jb, mode=mode, out_dtype=None if out_dt is None
                        else JAX_DT[out_dt], epilogue=chain or None,
                        epilogue_operands=j_ops, fold=jfold, fold_on="b",
                        fold_operands=j_fold_ops, interpret=True)
    got = _gemm_as_conv(mode, ta, tb, out_dtype, **kw)
    plain = ptiles.brgemm_reference(ta, tb, mode, out_dtype, fold_on="b",
                                    **kw)
    want_dtype = out_dtype or TORCH_DT[dt]
    assert got.dtype == plain.dtype == want_dtype
    assert tuple(got.shape) == (m, n)
    tol = 1e-5 if dt == "f32" and out_dt != "bf16" else 2e-2
    np.testing.assert_allclose(_np(got), _np(ref), rtol=tol, atol=tol)
    np.testing.assert_allclose(_np(got), _np(plain), rtol=tol, atol=tol)


def test_brgemm_on_cpu_counts_no_route_launch():
    """CPU tensors at widths and types that take the tensor cores on the
    card run the plain version: no launch and no route is counted."""
    def counts():
        return (ptiles.brgemm.launches, ptiles.brgemm_cuda.tc_fwd_launches,
                ptiles.brgemm_cuda.tc_dw_launches,
                ptiles.brgemm_cuda.simt_launches)

    a = torch.randn(64, 128).bfloat16()
    b = torch.randn(128, 64).bfloat16()
    before = counts()
    ptiles.brgemm(a, b, mode="nn")
    ptiles.brgemm(a.t().contiguous(), a.t().contiguous(), mode="tn",
                  fold_on="b", fold_mask=torch.ones(128, 64).bfloat16())
    assert counts() == before


# -- #7's routes: a dx without a fold on the tensor-core forward -------------

# (id, dtype, c, o, aligned, stride, folded, route)
DX_ROUTE_CASES = [
    ("bf16_64", torch.bfloat16, 64, 64, True, (1, 1), False, "tc"),
    ("bf16_512", torch.bfloat16, 512, 512, True, (1, 1), False, "tc"),
    ("bf16_c64_o192", torch.bfloat16, 64, 192, True, (1, 1), False, "tc"),
    ("bf16_c192_o64", torch.bfloat16, 192, 64, True, (1, 1), False, "tc"),
    ("stride2", torch.bfloat16, 64, 64, True, (2, 2), False, "tc_phase"),
    ("stride_1x2", torch.bfloat16, 64, 64, True, (1, 2), False,
     "tc_phase"),
    ("folded", torch.bfloat16, 64, 64, True, (1, 1), True, "simt"),
    ("stride2_folded", torch.bfloat16, 64, 64, True, (2, 2), True, "simt"),
    ("f32", torch.float32, 64, 64, True, (1, 1), False, "simt"),
    ("mixed_dtypes", None, 64, 64, True, (1, 1), False, "simt"),
    ("c96", torch.bfloat16, 96, 64, True, (1, 1), False, "simt"),
    ("o96", torch.bfloat16, 64, 96, True, (1, 1), False, "simt"),
    ("misaligned", torch.bfloat16, 64, 64, False, (1, 1), False, "simt"),
]


@pytest.mark.parametrize("case", DX_ROUTE_CASES,
                         ids=[c[0] for c in DX_ROUTE_CASES])
def test_dx_route_takes_the_tensor_cores_only_where_they_fit(case):
    """A dx that folds nothing where ``tc_fits`` takes (O, C) runs on the
    tensor cores: as one conv at stride (1, 1), by phases at any larger
    stride; the rest on SIMT."""
    _, dtype, c, o, aligned, stride, folded, route = case
    assert pcf.dx_route(dtype, c, o, aligned, stride, folded) == route
    tc = ptiles.tc_fits(dtype, o, c, aligned) and not folded
    want = ("tc" if stride == (1, 1) else "tc_phase") if tc else "simt"
    assert route == want


# (id, g dtype, w dtype, x_dtype, stride, fold, g off 16 bytes, route): what
# ``convkxk_dx_cuda`` reads of a call at C = O = 64
DX_CALL_CASES = [
    ("bf16", torch.bfloat16, torch.bfloat16, torch.bfloat16, 1, None, False,
     "tc"),
    ("bf16_f32_dx", torch.bfloat16, torch.bfloat16, torch.float32, 1, None,
     False, "tc"),
    ("stride2", torch.bfloat16, torch.bfloat16, torch.bfloat16, 2, None,
     False, "tc_phase"),
    ("mask", torch.bfloat16, torch.bfloat16, torch.bfloat16, 1, "mask",
     False, "simt"),
    ("scale", torch.bfloat16, torch.bfloat16, torch.bfloat16, 1, "scale",
     False, "simt"),
    ("f32", torch.float32, torch.float32, torch.float32, 1, None, False,
     "simt"),
    ("f16_dx", torch.bfloat16, torch.bfloat16, torch.float16, 1, None, False,
     "simt"),
    ("f32_w", torch.bfloat16, torch.float32, torch.bfloat16, 1, None, False,
     "simt"),
    ("misaligned_g", torch.bfloat16, torch.bfloat16, torch.bfloat16, 1, None,
     True, "simt"),
]


@pytest.mark.parametrize("case", DX_CALL_CASES,
                         ids=[c[0] for c in DX_CALL_CASES])
def test_dx_cuda_reads_the_rules_facts_of_each_call(case, monkeypatch):
    """``convkxk_dx_cuda``'s route (its launch faked by the plain version,
    so its rule and counters run on CPU tensors): the dtypes of g, w and
    dx, the stride, a mask or a scale, and g's base; one count a call in
    the route's counter and in ``convkxk_dx.launches``."""
    _, g_dt, w_dt, x_dt, s, fold, off, route = case
    taken = []

    def launch(r, *args, facts=None):
        taken.append(r)
        return pcf.convkxk_dx_reference(*args)

    monkeypatch.setattr(pcf, "convkxk_dx_launch", launch)
    routes = ("tc", "tc_phase", "simt")
    monkeypatch.setattr(pcf.convkxk_dx, "launches", 0)
    for r in routes:
        monkeypatch.setattr(pcf.convkxk_dx_cuda, f"{r}_launches", 0)
    x_shape = (1, 5, 5, 64)
    oh = (5 - 1) // s + 1
    g = torch.randn(1, oh, oh, 64).to(g_dt)
    if off:
        buf = torch.empty(g.numel() + 1, dtype=g_dt)
        g = buf[1:].view(g.shape).copy_(g)
    mask = torch.randn(g.shape).to(g_dt) if fold == "mask" else None
    scale = torch.rand(64) + 0.5 if fold == "scale" else None
    w = torch.randn(64, 64, 3, 3).to(w_dt)
    pcf.convkxk_dx_cuda(g, mask, scale, w, x_shape, x_dt, (s, s),
                        ((1, 1), (1, 1)), (1, 1))
    assert taken == [route]
    assert pcf.convkxk_dx.launches == 1
    assert {r: getattr(pcf.convkxk_dx_cuda, f"{r}_launches")
            for r in routes} == {r: int(r == route) for r in routes}


# (x_shape, w_shape, padding, dilation, stride): ResNet-50's four stride-1
# 3x3 dx at batch 256, a dilated one, an uneven padding with a negative low
# pad, and ResNet-50's three stride-2 3x3 dx at batch 256 (H = 56, 28, 14:
# even, so the reference's high pad of the dilated g is 2)
DX_GEO_CASES = [
    ((256, 56, 56, 64), (64, 64, 3, 3), ((1, 1), (1, 1)), (1, 1), (1, 1)),
    ((256, 28, 28, 128), (128, 128, 3, 3), ((1, 1), (1, 1)), (1, 1), (1, 1)),
    ((256, 14, 14, 256), (256, 256, 3, 3), ((1, 1), (1, 1)), (1, 1), (1, 1)),
    ((256, 7, 7, 512), (512, 512, 3, 3), ((1, 1), (1, 1)), (1, 1), (1, 1)),
    ((2, 9, 9, 16), (32, 16, 3, 3), ((2, 2), (2, 2)), (2, 2), (1, 1)),
    ((2, 9, 7, 16), (32, 16, 3, 3), ((3, 0), (0, 2)), (1, 1), (1, 1)),
    ((256, 56, 56, 128), (128, 128, 3, 3), ((1, 1), (1, 1)), (1, 1), (2, 2)),
    ((256, 28, 28, 256), (256, 256, 3, 3), ((1, 1), (1, 1)), (1, 1), (2, 2)),
    ((256, 14, 14, 512), (512, 512, 3, 3), ((1, 1), (1, 1)), (1, 1), (2, 2)),
]


def _geo_id(case):
    """A geometry case's test id: its x and w shapes, padding and
    dilation, and the stride where it is not (1, 1)."""
    *rest, stride = case
    return "-".join(map(str, rest)) + \
        ("" if stride == (1, 1) else f"-stride{stride}")


def _dx_pads(x_shape, w_shape, padding, dilation, stride=(1, 1)):
    """The reference's pads of the interior-dilated g for its stride-1 dx,
    ((lo_h, hi_h), (lo_w, hi_w)), as ``paddle_tpu/kernels/conv_fused.py``
    ``_convkxk_dx`` computes them, and g's [OH, OW]."""
    _, h, wd, _ = x_shape
    _, _, kh, kw = w_shape
    (ph0, ph1), (pw0, pw1) = padding
    dh, dwl = dilation
    sh, sw = stride
    eff_h, eff_w = (kh - 1) * dh + 1, (kw - 1) * dwl + 1
    oh = (h + ph0 + ph1 - eff_h) // sh + 1
    ow = (wd + pw0 + pw1 - eff_w) // sw + 1
    lo_h, lo_w = eff_h - 1 - ph0, eff_w - 1 - pw0
    hi_h = h + eff_h - 1 - lo_h - ((oh - 1) * sh + 1)
    hi_w = wd + eff_w - 1 - lo_w - ((ow - 1) * sw + 1)
    return ((lo_h, hi_h), (lo_w, hi_w)), (oh, ow)


@pytest.mark.parametrize(
    "x_shape,w_shape,padding,dilation,stride",
    [pytest.param(*c, id=_geo_id(c)) for c in DX_GEO_CASES])
def test_dx_geometry_pads_g_as_the_reference(x_shape, w_shape, padding,
                                             dilation, stride):
    """The Geo of the stride-1 forward conv a dx runs: g [N, OH, OW, O],
    dilated by the stride, as x with the reference's low pads, the flipped
    weight of O input and C output channels, and the output H x W: the
    forward conv of the dilated g with the reference's pads on both sides,
    the high pad included (the one the output size leaves the kernel)."""
    n, h, wd, c = x_shape
    o, _, kh, kw = w_shape
    (sh, sw), (dh, dwl) = stride, dilation
    pads, (oh, ow) = _dx_pads(x_shape, w_shape, padding, dilation, stride)
    geo = pcf.dx_geometry(x_shape, w_shape, stride, padding, dilation)
    dil_h, dil_w = (oh - 1) * sh + 1, (ow - 1) * sw + 1
    assert geo == (n, dil_h, dil_w, o, c, kh, kw, h, wd, 1, 1, pads[0][0],
                   pads[1][0], *dilation)
    assert pcf.geometry((n, dil_h, dil_w, o), (c, o, kh, kw), (1, 1), pads,
                        dilation) == geo
    # the high pads the output size implies: the last output row's (and
    # column's) last tap past the dilated g
    assert (h - 1 + (kh - 1) * dh - geo[11] - (dil_h - 1),
            wd - 1 + (kw - 1) * dwl - geo[12] - (dil_w - 1)) == \
        (pads[0][1], pads[1][1])
    if stride == (2, 2) and h == 56:
        assert pads == ((1, 2), (1, 2))
    # the same x at stride 2: g of half the size, dilated back
    p2, (oh2, ow2) = _dx_pads(x_shape, w_shape, padding, dilation, (2, 2))
    assert pcf.dx_geometry(x_shape, w_shape, (2, 2), padding, dilation) == \
        (n, 2 * oh2 - 1, 2 * ow2 - 1, o, c, kh, kw, h, wd, 1, 1, p2[0][0],
         p2[1][0], *dilation)
    with pytest.raises(ValueError, match="stride"):
        pcf.dx_geometry(x_shape, w_shape, (0, 1), padding, dilation)


@pytest.mark.parametrize("stride", [(2, 2), (2, 1), (1, 2), (3, 2)], ids=str)
def test_dx_tc_launch_refuses_a_stride_above_1(stride):
    """``convkxk_dx_launch("tc")`` runs one conv of g at stride (1, 1)
    alone: at a larger stride it raises before any launch, naming the
    phase route that takes such a dx."""
    n, h, wd, c, o = 1, 8, 8, 64, 64
    sh, sw = stride
    g = torch.zeros(n, (h - 1) // sh + 1, (wd - 1) // sw + 1, o,
                    dtype=torch.bfloat16)
    w = torch.zeros(o, c, 3, 3, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="tc_phase"):
        pcf.convkxk_dx_launch("tc", g, None, None, w, (n, h, wd, c),
                              torch.bfloat16, stride, ((1, 1), (1, 1)),
                              (1, 1))


def _dilate(g, stride):
    """g with ``stride - 1`` zeros between its rows and its columns, as the
    reference pads it inside (``lax.pad``'s interior padding)."""
    sh, sw = stride
    n, oh, ow, o = g.shape
    out = g.new_zeros((n, (oh - 1) * sh + 1, (ow - 1) * sw + 1, o))
    out[:, ::sh, ::sw] = g
    return out


# (id, x_shape, o, padding, dilation, stride): 3x3 dx at small sizes: C = O
# = 64, C != O, dilated, uneven padding with a negative low pad of g; at
# stride 2 an even H and an odd H, strides (2, 1) and (1, 2), dilated, and
# C != O
DX_TC_CASES = [
    ("c64", (2, 7, 7, 64), 64, ((1, 1), (1, 1)), (1, 1), (1, 1)),
    ("c16_o32", (2, 6, 6, 16), 32, ((1, 1), (1, 1)), (1, 1), (1, 1)),
    ("dilated", (2, 9, 9, 16), 32, ((2, 2), (2, 2)), (2, 2), (1, 1)),
    ("uneven_negative_lo", (2, 7, 6, 16), 32, ((3, 0), (0, 2)), (1, 1),
     (1, 1)),
    ("s2_even_h", (2, 8, 8, 16), 16, ((1, 1), (1, 1)), (1, 1), (2, 2)),
    ("s2_odd_h", (2, 9, 7, 16), 16, ((1, 1), (1, 1)), (1, 1), (2, 2)),
    ("s21", (2, 8, 7, 16), 16, ((1, 1), (1, 1)), (1, 1), (2, 1)),
    ("s12", (2, 7, 8, 16), 16, ((1, 1), (1, 1)), (1, 1), (1, 2)),
    ("s2_dilated", (2, 10, 9, 16), 16, ((2, 2), (2, 2)), (2, 2), (2, 2)),
    ("s2_c16_o32", (2, 8, 8, 16), 32, ((1, 1), (1, 1)), (1, 1), (2, 2)),
]


@pytest.mark.parametrize("dt,x_dt", [("f32", "f32"), ("bf16", "bf16"),
                                     ("bf16", "f32")],
                         ids=["f32", "bf16", "bf16_f32_dx"])
@pytest.mark.parametrize("case", DX_TC_CASES,
                         ids=[c[0] for c in DX_TC_CASES])
def test_dx_as_a_flipped_forward_conv_matches_the_jax_kernel(case, dt, x_dt):
    """The reference's dx, which the ``tc`` route runs on the card at
    stride 1, here in its plain version: g dilated by the stride
    (``_dilate``), then the forward conv of it at ``dx_geometry`` (its pads
    of g on both sides) with the taps flipped and C and O swapped, against
    the JAX ``_convkxk_dx`` in interpret mode (run eagerly) and the port's
    plain dx: float32 within 1e-5, a bf16 operand within 2e-2, of
    max|plain|."""
    _, x_shape, o, padding, dilation, stride = case
    n, h, wd, c = x_shape
    w_shape = (o, c, 3, 3)
    pads, (oh, ow) = _dx_pads(x_shape, w_shape, padding, dilation, stride)
    rs = np.random.RandomState(11)
    jg, tg = _pair(rs.randn(n, oh, ow, o).astype(np.float32), dt)
    jw, tw = _pair((rs.randn(*w_shape) * (9 * c) ** -0.5).astype(np.float32),
                   dt)
    ref = jcf._convkxk_dx(jg, None, None, jw, x_shape, JAX_DT[x_dt], stride,
                          padding, dilation, True)
    geo = pcf.dx_geometry(x_shape, w_shape, stride, padding, dilation)
    assert (geo[11], geo[12]) == (pads[0][0], pads[1][0])
    gd = _dilate(tg, stride)
    assert tuple(gd.shape) == (n, geo[1], geo[2], o)
    got = pcf.convkxk_reference(gd, tw.flip(2, 3).transpose(0, 1),
                                padding=pads, dilation=dilation,
                                out_dtype=TORCH_DT[x_dt])
    plain = pcf.convkxk_dx_reference(tg, None, None, tw, x_shape,
                                     TORCH_DT[x_dt], stride, padding,
                                     dilation)
    assert got.dtype == plain.dtype == TORCH_DT[x_dt]
    assert tuple(got.shape) == tuple(ref.shape) == x_shape
    tol = 1e-5 if dt == "f32" else 2e-2
    scale = np.abs(_np(ref)).max()
    for mine in (got, plain):
        assert np.abs(_np(mine) - _np(ref)).max() <= tol * scale


def _products(x_shape, w_shape, stride, padding, dilation):
    """{dx position (ih, iw): {(kh, kw, oh, ow)}}: the products of the
    forward conv that reach each position of x, from the conv's
    definition."""
    _, h, wd, _, _, kh, kw, oh, ow, sh, sw, ph0, pw0, dh, dw = \
        pcf.geometry(x_shape, w_shape, stride, padding, dilation)
    reach = {}
    for r, q, t, u in itertools.product(range(oh), range(ow), range(kh),
                                        range(kw)):
        ih, iw = r * sh - ph0 + t * dh, q * sw - pw0 + u * dw
        if 0 <= ih < h and 0 <= iw < wd:
            reach.setdefault((ih, iw), set()).add((t, u, r, q))
    return reach


# one axis of a phase-plan case: (size, taps, dilation, padding)
PHASE_AXES = [(7, 3, 1, (1, 1)), (8, 3, 2, (2, 2)), (9, 1, 1, (0, 0)),
              (6, 5, 1, (0, 3)), (10, 4, 3, (4, 1)), (5, 2, 2, (3, 0)),
              (9, 5, 2, (1, 2))]


@pytest.mark.parametrize("stride", [(1, 1), (2, 2), (3, 3), (2, 1), (1, 3),
                                    (3, 2)], ids=str)
def test_dx_phases_cover_every_position_and_product_once(stride):
    """Brute force over the conv's products, for every pair of
    ``PHASE_AXES`` (kernels 1-5, dilations 1-3, uneven paddings, odd and
    even sizes) at ``stride``: the phases come in the order (a, b); each
    covers dx's rows a + sh * i and columns b + sw * j, every position of
    dx in exactly one phase; its conv of g (taps ``taps_h`` x ``taps_w``
    of the weight, from the largest down, at its Geo's padding and
    dilation, a tap past either edge of g reading 0) makes exactly the
    products that reach each of its positions, so a phase without taps is
    one no product reaches; its taps are exactly those whose products
    reach its rows and columns at some output position."""
    sh, sw = stride
    seen_empty = False
    for (h, kh, dh, ph), (wd, kw, dw, pw) in itertools.product(PHASE_AXES,
                                                               repeat=2):
        x_shape, w_shape = (2, h, wd, 16), (32, 16, kh, kw)
        args = (x_shape, w_shape, stride, (ph, pw), (dh, dw))
        geo = pcf.geometry(*args)
        oh, ow = geo[7], geo[8]
        if oh <= 0 or ow <= 0:
            continue
        reach = _products(*args)
        phases = pcf.dx_phases(*args)
        assert [(p.a, p.b) for p in phases] == list(itertools.product(
            range(sh), range(sw)))
        covered = Counter()
        for p in phases:
            (n, gh, gw, o, c, th, tw, rows, cols, s1, s2, lo_h, lo_w, dil_h,
             dil_w) = p.geo
            assert (n, gh, gw, o, c, s1, s2) == (2, oh, ow, 32, 16, 1, 1)
            assert (th, tw) == (len(p.taps_h), len(p.taps_w))
            for taps, a, k, s, p0, d in ((p.taps_h, p.a, kh, sh, ph[0], dh),
                                         (p.taps_w, p.b, kw, sw, pw[0], dw)):
                # output row r's tap t lands on r * s - p0 + t * d: a row
                # of the phase for some r when the rest is a multiple of s
                assert list(taps) == sorted(taps, reverse=True)
                assert set(taps) == {t for t in range(k)
                                     if (t * d - p0 - a) % s == 0}
            assert p.runs == (th * tw * rows * cols > 0)
            seen_empty |= rows * cols > 0 and not p.runs
            for i, j in itertools.product(range(rows), range(cols)):
                pos = (p.a + sh * i, p.b + sw * j)
                covered[pos] += 1
                made = {(p.taps_h[t], p.taps_w[u], i - lo_h + t * dil_h,
                         j - lo_w + u * dil_w)
                        for t, u in itertools.product(range(th), range(tw))}
                made = {m for m in made if 0 <= m[2] < oh and 0 <= m[3] < ow}
                assert made == reach.get(pos, set()), (args, p, pos)
        assert covered == Counter(itertools.product(range(h), range(wd)))
    assert seen_empty == (stride != (1, 1))


def test_dx_phases_at_stride_1_is_the_flipped_forward_conv():
    """At stride (1, 1) a dx has one phase, every tap flipped: the
    conv ``dx_geometry`` gives, the weight ``"tc"`` flips."""
    w = torch.randn(32, 16, 3, 2)
    for pad, dil in ((((1, 1), (0, 1)), (1, 1)), (((3, 0), (2, 2)), (2, 1))):
        args = ((2, 7, 6, 16), w.shape, (1, 1), pad, dil)
        (p,) = pcf.dx_phases(*args)
        assert (p.a, p.b, p.taps_h, p.taps_w) == (0, 0, (2, 1, 0), (1, 0))
        assert p.geo == pcf.dx_geometry(*args)
        assert torch.equal(pcf.phase_weights(w, [p]),
                           w.flip(2, 3).permute(2, 3, 0, 1).reshape(6, 32,
                                                                    16))
    with pytest.raises(ValueError, match="stride"):
        pcf.dx_phases((2, 7, 6, 16), w.shape, (0, 1), ((1, 1), (1, 1)),
                      (1, 1))


def _phased_plain(g, w, x_shape, x_dtype, stride, padding, dilation):
    """What the ``tc_phase`` route runs on the card, in its plain
    version: each phase that runs (``dx_phases``) through the plain forward
    (``convkxk_reference``) at its Geo, its weight read from
    ``phase_weights``' one tensor as the C entry reads it, written into
    dx's rows a::sh and columns b::sw; dx 0 where no phase runs."""
    sh, sw = stride
    phases = pcf.dx_phases(x_shape, w.shape, stride, padding, dilation)
    plan = [p for p in phases if p.runs]
    wk = pcf.phase_weights(w, plan)
    dx = torch.zeros(x_shape, dtype=x_dtype)
    at = 0
    for p in plan:
        _, gh, gw, o, c, th, tw, rows, cols, _, _, lo_h, lo_w, dil_h, dil_w = \
            p.geo
        # [T_h, T_w, O, C] -> the phase conv's OIHW [C, O, T_h, T_w]
        wp = wk[at:at + th * tw].reshape(th, tw, o, c).permute(3, 2, 0, 1)
        at += th * tw
        # the high pads the phase's output size implies
        pads = ((lo_h, rows + (th - 1) * dil_h - gh - lo_h),
                (lo_w, cols + (tw - 1) * dil_w - gw - lo_w))
        out = pcf.convkxk_reference(g, wp, padding=pads,
                                    dilation=(dil_h, dil_w),
                                    out_dtype=x_dtype)
        assert tuple(out.shape) == (g.shape[0], rows, cols, c)
        dx[:, p.a::sh, p.b::sw] = out
    assert at == wk.shape[0]
    return dx


# DX_TC_CASES and a stride of 3 with C != O and an uneven padding, and a
# stride of (2, 1) whose odd rows no tap reaches (dilation 2, padding 2)
DX_PHASE_CASES = DX_TC_CASES + [
    ("s3_uneven", (2, 10, 11, 16), 32, ((2, 0), (1, 1)), (1, 1), (3, 3)),
    ("s21_empty_rows", (2, 9, 8, 16), 16, ((2, 2), (1, 1)), (2, 1),
     (2, 2)),
]


@pytest.mark.parametrize("dt,x_dt", [("f32", "f32"), ("bf16", "bf16"),
                                     ("bf16", "f32")],
                         ids=["f32", "bf16", "bf16_f32_dx"])
@pytest.mark.parametrize("case", DX_PHASE_CASES,
                         ids=[c[0] for c in DX_PHASE_CASES])
def test_dx_by_phases_matches_the_jax_kernel(case, dt, x_dt):
    """The phase route's plain version (``_phased_plain``) against the
    JAX ``_convkxk_dx`` in interpret mode (run eagerly) over the dilated
    g: float32 within 1e-5, a bf16 operand within 2e-2, of max|plain|
    (the tolerances of ``test_dx_as_a_flipped_forward_conv_matches_the_jax
    _kernel``); where a phase has no taps, its positions are 0 in both."""
    _, x_shape, o, padding, dilation, stride = case
    n, h, wd, c = x_shape
    w_shape = (o, c, 3, 3)
    _, (oh, ow) = _dx_pads(x_shape, w_shape, padding, dilation, stride)
    rs = np.random.RandomState(12)
    jg, tg = _pair(rs.randn(n, oh, ow, o).astype(np.float32), dt)
    jw, tw = _pair((rs.randn(*w_shape) * (9 * c) ** -0.5).astype(np.float32),
                   dt)
    ref = jcf._convkxk_dx(jg, None, None, jw, x_shape, JAX_DT[x_dt], stride,
                          padding, dilation, True)
    got = _phased_plain(tg, tw, x_shape, TORCH_DT[x_dt], stride, padding,
                        dilation)
    assert got.dtype == TORCH_DT[x_dt]
    assert tuple(got.shape) == tuple(ref.shape) == x_shape
    tol = 1e-5 if dt == "f32" else 2e-2
    scale = np.abs(_np(ref)).max()
    assert np.abs(_np(got) - _np(ref)).max() <= tol * scale
    for p in pcf.dx_phases(x_shape, w_shape, stride, padding, dilation):
        if not p.runs:
            assert not _np(ref)[:, p.a::stride[0], p.b::stride[1]].any()
            assert not got[:, p.a::stride[0], p.b::stride[1]].any()


def test_dx_on_cpu_counts_no_route_launch():
    """CPU tensors at widths and types that take the tensor cores on the
    card run the plain version: no launch and no route is counted."""
    def counts():
        return (pcf.convkxk_dx.launches, pcf.convkxk_dx_cuda.tc_launches,
                pcf.convkxk_dx_cuda.tc_phase_launches,
                pcf.convkxk_dx_cuda.simt_launches)

    g = torch.randn(2, 5, 5, 64).bfloat16()
    w = torch.randn(64, 64, 3, 3).bfloat16()
    before = counts()
    dx = pcf.convkxk_dx(g, None, None, w, (2, 5, 5, 64), torch.bfloat16,
                        (1, 1), ((1, 1), (1, 1)), (1, 1))
    assert counts() == before
    assert dx.dtype == torch.bfloat16 and tuple(dx.shape) == (2, 5, 5, 64)


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


@pytest.mark.parametrize("stride", [1, 2])
def test_conv2d_bn_act_bf16_at_a_tensor_core_dw_shape(stride):
    """C = O = 64, 3x3, relu and a scale: a shape whose bf16 weight
    gradient takes the tensor cores on the card. Here the port's plain
    version (with the fold) against the JAX ``_convkxk_dw`` in interpret
    mode, with the output and the other gradients."""
    assert pcf.dw_route(torch.bfloat16, 64, 64, True) == "tc"
    args = _conv_inputs(2, 8, 64, 64, 3, False, "bf16", stride, 1, seed=4)
    _assert_pair(*_conv_pair(args, "relu", stride, 1, "bf16"), 0.1, 0.1)


@pytest.mark.parametrize("stride", [1, 2])
def test_conv2d_bn_act_bf16_eval_chain_at_a_tensor_core_fwd_shape(stride):
    """C = O = 64, 3x3, scale, bias, residual and relu: the eval chain at
    a shape whose bf16 forward takes the tensor cores on the card. Here
    the port's forward (and its gradients) against the JAX ``_convkxk``
    in interpret mode."""
    assert pcf.kxk_fwd_route(torch.bfloat16, 64, 64, True) == "tc"
    args = _conv_inputs(2, 8, 64, 64, 3, True, "bf16", stride, 1, seed=5)
    _assert_pair(*_conv_pair(args, "relu", stride, 1, "bf16"), 0.1, 0.1)


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
