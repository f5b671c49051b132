"""The work ``chip_smoke.py`` counts for its bound: only the keys a query
keeps need their K and V rows and their scores; a query with no key kept
needs all of V (it returns V's mean) and no K. Counts are exact
integers, checked against sums written out by hand. Also the script's
shapes, launch counts a step, gates and rounding floors of its phases."""

import contextlib

import pytest
import torch

import chip_smoke


def _mask(rows, tk):
    return torch.tensor([[j < n for j in range(tk)] for n in rows])


# (b, h, tq, tk, d, dtype, causal, kept keys per batch row, bytes, flops)
CASES = [
    # decode, cache filled to 5 of 8: q, 5 K rows, 5 V rows, o (bf16),
    # lse, mask
    (2, 3, 1, 8, 4, torch.bfloat16, False, [5, 5],
     2 * 3 * 4 * (2 * 2 + 10 + 10) + 4 * 2 * 3 + 2 * 8,
     3 * 4 * 4 * 10),
    # row 0 all masked: all 8 V rows, no K rows; row 1 keeps 3
    (2, 3, 1, 8, 4, torch.bfloat16, False, [0, 3],
     2 * 3 * 4 * (2 * 2 + 3 + 11) + 4 * 2 * 3 + 2 * 8,
     3 * 4 * (4 * 3 + 8)),
    # causal 4x4 in float32, no mask: 1 + 2 + 3 + 4 kept scores
    (1, 1, 4, 4, 2, torch.float32, True, None,
     4 * 2 * (2 * 4 + 4 + 4) + 4 * 4,
     2 * 4 * 10),
    # every key kept: the dense count
    (2, 2, 3, 6, 8, torch.float32, False, [6, 6],
     4 * 2 * 2 * 8 * (2 * 3 + 2 * 6) + 4 * 2 * 2 * 3 + 2 * 6,
     4 * 2 * 2 * 3 * 6 * 8),
]


@pytest.mark.parametrize(
    "b,h,tq,tk,d,dtype,causal,rows,nbytes,flops", CASES,
    ids=["prefix", "masked_row", "causal", "dense"])
def test_attention_bound_counts_kept_keys(b, h, tq, tk, d, dtype, causal,
                                          rows, nbytes, flops):
    q = torch.zeros(b, h, tq, d, dtype=dtype)
    k = torch.zeros(b, h, tk, d, dtype=dtype)
    mask = None if rows is None else _mask(rows, tk)
    assert chip_smoke.attention_bound(q, k, mask, causal) == (nbytes, flops)


def test_bound_ms_takes_the_larger_time():
    rate = chip_smoke.HBM_BYTES_PER_S
    peak = chip_smoke.PEAK_FLOPS[torch.bfloat16]
    ms, by = chip_smoke.bound_ms(rate * 1e-3, peak * 1e-4, torch.bfloat16)
    assert (ms, by) == (pytest.approx(1.0), "bytes")
    ms, by = chip_smoke.bound_ms(rate * 1e-4, peak * 1e-3, torch.bfloat16)
    assert (ms, by) == (pytest.approx(1.0), "operations")


# (b, h, tq, tk, d, dtype, causal, kept keys per batch row, which, bytes,
#  flops) of the backward sweeps: q, do, lse, dvec of every row; K and V
# rows some query keeps; the mask; dq (or dk and dv of every key) out
BWD_CASES = [
    # every key kept, bf16: dq 6 D and dkv 8 D flops per score
    (1, 2, 4, 6, 8, torch.bfloat16, False, [6], "dq",
     2 * 2 * 8 * (2 * 4 + 2 * 6 + 4) + 8 * 2 * 4 + 6,
     2 * 8 * 6 * 4 * 6),
    (1, 2, 4, 6, 8, torch.bfloat16, False, [6], "dkv",
     2 * 2 * 8 * (2 * 4 + 2 * 6 + 2 * 6) + 8 * 2 * 4 + 6,
     2 * 8 * 8 * 4 * 6),
    # causal 3x3 in float32, no mask: 6 kept scores, every key kept by a row
    (1, 1, 3, 3, 2, torch.float32, True, None, "dkv",
     4 * 2 * (2 * 3 + 2 * 3 + 2 * 3) + 8 * 3,
     2 * 8 * 6),
    # keys past 2 of 5 masked: their K/V rows are not read
    (2, 1, 2, 5, 4, torch.float32, False, [2, 2], "dq",
     4 * 4 * (2 * 2 * 2 + 2 * 4 + 2 * 2) + 8 * 2 * 2 + 2 * 5,
     4 * 6 * 2 * 2 * 2),
]


@pytest.mark.parametrize(
    "b,h,tq,tk,d,dtype,causal,rows,which,nbytes,flops", BWD_CASES,
    ids=["dq_dense", "dkv_dense", "dkv_causal", "dq_masked"])
def test_attention_bwd_bound_counts_kept_scores(b, h, tq, tk, d, dtype,
                                                causal, rows, which, nbytes,
                                                flops):
    q = torch.zeros(b, h, tq, d, dtype=dtype)
    k = torch.zeros(b, h, tk, d, dtype=dtype)
    mask = None if rows is None else _mask(rows, tk)
    assert chip_smoke.attention_bwd_bound(q, k, mask, causal, which) == (
        nbytes, flops)


def test_training_phase_shapes_are_transformer_long():
    cfg = chip_smoke.LONG_CFG
    assert (cfg["d_model"], cfg["n_head"], cfg["n_layer"], cfg["max_length"],
            cfg["src_vocab_size"]) == (512, 8, 6, 4096, 8192)
    assert cfg["remat"] and cfg["use_flash"]
    _, b, h, tq, tk, d, causal, _ = chip_smoke.TRAIN_FLASH
    assert (b, h, tq, tk, d, causal) == (
        chip_smoke.LONG_BATCH, cfg["n_head"], chip_smoke.LONG_LEN,
        chip_smoke.LONG_LEN, cfg["d_model"] // cfg["n_head"], False)
    assert chip_smoke.SOURCES == ["brgemm", "conv_kxk", "conv_kxk_dw_tc",
                                  "conv_kxk_fwd_tc", "flash_bwd",
                                  "flash_bwd_dkv_tc", "flash_bwd_dq_tc",
                                  "flash_fwd",
                                  "flash_fwd_tc", "fused_update", "layer_norm",
                                  "pool_fused", "seqpool"]


def test_permuted_keys_is_the_same_attention():
    """T2's reordered route: the flash route of the attention, fed the keys,
    values and [B, 1, 1, T] mask in another order, gives the same output
    and the same dq, dk and dv, up to float32 rounding."""
    from paddle_tpu_torch.nn import attention as NA
    g = torch.Generator().manual_seed(0)
    q, k, v, do = (torch.randn(2, 2, t, 8, generator=g)
                   for t in (5, 7, 7, 5))
    mask = _mask([7, 4], 7)[:, None, None, :]
    fn, runs = NA.scaled_dot_product_attention, []
    for reorder in (False, True):
        qkv = [t.clone().requires_grad_() for t in (q, k, v)]
        route = chip_smoke.permuted_keys(seed=3) if reorder else \
            chip_smoke.contextlib.nullcontext()
        with route:
            o = NA.scaled_dot_product_attention(*qkv, mask, use_flash=True)
        runs.append((o, *torch.autograd.grad((o * do).sum(), qkv)))
    assert NA.scaled_dot_product_attention is fn
    for a, b in zip(*runs):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_resnet50_conv_shapes_count_the_steps_launches():
    shapes = chip_smoke.resnet50_conv_shapes(224)
    assert sum(s[3] == 1 for s in shapes) == 36
    assert sum(s[3] == 3 for s in shapes) == 16
    assert shapes[0] == (56, 64, 64, 1, 1)
    assert (56, 128, 128, 3, 2) in shapes and (56, 256, 512, 1, 2) in shapes
    assert shapes[-1] == (7, 512, 2048, 1, 1)
    per_step = chip_smoke.R_PER_STEP
    assert per_step["brgemm"] == 3 * 36 and per_step["convkxk_dw"] == 16


@pytest.mark.parametrize("shape,batch,nbytes,flops", [
    # 3x3, pad 1, stride 1 on 4x4: 2+3+3+2 = 10 real taps a dim
    ((4, 2, 3, 3, 1), 1, 2 * (4 * 4 * 2 + 3 * 2 * 9 + 16 * 3),
     2 * 10 * 10 * 2 * 3),
    # 1x1 stride 2 on 5x5: 3x3 outputs; only the sliced x is read
    ((5, 2, 3, 1, 2), 2, 2 * (18 * 2 + 6 + 18 * 3), 2 * 18 * 2 * 3),
    # 3x3 stride 2 on 5x5: rows 0, 2, 4 -> taps 2 + 3 + 2
    ((5, 1, 1, 3, 2), 1, 2 * (25 + 9 + 9), 2 * 7 * 7),
])
def test_conv_work_counts_real_taps(shape, batch, nbytes, flops):
    assert chip_smoke.conv_work(shape, batch, 2) == (nbytes, flops)


def test_resnet_step_counts_one_launch_of_each_pool_kernel():
    per_step, off = chip_smoke.R_PER_STEP, chip_smoke.R_POOL_OFF
    assert (per_step["pool_fwd"], per_step["pool_bwd"]) == (1, 1)
    assert (off["pool_fwd"], off["pool_bwd"]) == (0, 0)
    assert {k: v for k, v in off.items() if not k.startswith("pool")} == \
        {k: v for k, v in per_step.items() if not k.startswith("pool")}
    assert (chip_smoke.R_EVAL["pool_fwd"], chip_smoke.R_EVAL["pool_bwd"]) \
        == (1, 0)
    # the step's one backward on the tile kernel, none on the gather
    assert (per_step["pool_bwd_tile"], per_step["pool_bwd_gather"]) == (1, 0)
    assert (off["pool_bwd_tile"], off["pool_bwd_gather"]) == (0, 0)
    assert (chip_smoke.R_EVAL["pool_bwd_tile"],
            chip_smoke.R_EVAL["pool_bwd_gather"]) == (0, 0)
    assert set(chip_smoke.KERNELS) >= {"pool_fwd", "pool_bwd_gather",
                                       "seqpool", "layer_norm",
                                       "pool_bwd_tile"}
    # each pool kernel row is counted under its own name
    assert set(chip_smoke.POOL_ROWS) == {
        k for k in chip_smoke.KERNELS if k.startswith("pool")}
    assert set(chip_smoke.POOL_ROWS) <= set(per_step)
    assert len(chip_smoke.KERNELS) == 22


def test_kernels_line_has_the_tile_pool_backward_row():
    """The 21st row: the pool backward's second kernel, in the same source
    as the gather; the profile tells the two apart by symbol, and R3
    expects one tile backward and no gather in a step."""
    row, gather = (chip_smoke.KERNELS["pool_bwd_tile"],
                   chip_smoke.KERNELS["pool_bwd_gather"])
    assert row == gather == {
        "route": "cuda", "source": "paddle_tpu_torch/csrc/pool_fused.cu",
        "replaces": "paddle_tpu/kernels/pool_fused.py:184"}
    sym = chip_smoke.R_SYMBOLS
    assert sym["pool_bwd_tile"] == "pool_bwd_tile_kernel"
    assert sym["pool_bwd_gather"] == "pool_bwd_kernel"
    tile_name = ("void (anonymous namespace)::pool_bwd_tile_kernel<"
                 "__nv_bfloat16, 8>(__nv_bfloat16 const*, int const*, "
                 "__nv_bfloat16*, int2 const*, (anonymous namespace)::Geo, "
                 "int, int)")
    gather_name = ("void (anonymous namespace)::pool_bwd_kernel<"
                   "__nv_bfloat16, 8>(__nv_bfloat16 const*, int const*, "
                   "__nv_bfloat16*, (anonymous namespace)::Geo)")
    assert sym["pool_bwd_gather"] not in tile_name
    assert sym["pool_bwd_tile"] not in gather_name
    assert sym["pool_fwd"] not in tile_name + gather_name
    expect = {sym[r]: chip_smoke.R_PER_STEP[r] for r in chip_smoke.POOL_ROWS}
    assert expect == {"pool_fwd_kernel": 1, "pool_bwd_kernel": 0,
                      "pool_bwd_tile_kernel": 1}


def test_p1_cases_take_the_routes_the_script_asserts():
    """P1's cases on the route ``bwd_route`` names for the aligned tensors
    the kernels allocate: the tile kernel but for C = 3; a 2x2/s2/p0 case
    and the stem's bf16 batch-256 shape first, which P1 times."""
    from paddle_tpu_torch.kernels import pool_fused as pf
    for case in chip_smoke.P1_CASES:
        shape = (case.batch, case.h, case.w, case.c)
        assert pf.bwd_route(case.dtype, pf.geometry(shape, *case.cfg),
                            True) == case.route, case
    assert {case.route for case in chip_smoke.P1_CASES} == {"tile", "gather"}
    assert any(case.cfg == (2, 2, 0) for case in chip_smoke.P1_CASES)
    stem = chip_smoke.P1_CASES[0]
    assert (stem.batch, stem.h, stem.w, stem.c, stem.dtype) == (
        chip_smoke.R3_BATCH, 112, 112, 64, torch.bfloat16)
    assert stem.cfg == chip_smoke.POOL_CFG == (3, 2, 1)


def test_kernels_line_has_the_tensor_core_weight_gradient_row():
    """The 14th row: the second implementation of the TPU kernel that the
    SIMT weight gradient replaces, built from its own source."""
    row, simt = chip_smoke.KERNELS["convkxk_dw_tc"], \
        chip_smoke.KERNELS["convkxk_dw"]
    assert row == {"route": "cuda",
                   "source": "paddle_tpu_torch/csrc/conv_kxk_dw_tc.cu",
                   "replaces": "paddle_tpu/kernels/conv_fused.py:506"}
    assert simt["replaces"] == row["replaces"]
    assert "convkxk_dw_tc" in chip_smoke.RESNET_KERNELS


def test_kernels_line_has_the_tensor_core_forward_row():
    """The 15th row: the second implementation of the TPU kernel that the
    SIMT 3x3 forward replaces, built from its own source, and both rows
    among the ResNet kernels, each the other's twin."""
    row, simt = chip_smoke.KERNELS["convkxk_tc"], chip_smoke.KERNELS["convkxk"]
    assert row == {"route": "cuda",
                   "source": "paddle_tpu_torch/csrc/conv_kxk_fwd_tc.cu",
                   "replaces": "paddle_tpu/kernels/conv_fused.py:241"}
    assert simt["replaces"] == row["replaces"]
    assert {"convkxk", "convkxk_tc"} <= set(chip_smoke.RESNET_KERNELS)
    assert chip_smoke.TC_TWIN == {"convkxk_tc": "convkxk",
                                  "convkxk_dx_tc": "convkxk_dx",
                                  "convkxk_dx_tc_phase": "convkxk_dx",
                                  "convkxk_dw_tc": "convkxk_dw",
                                  "brgemm_tc_fwd": "brgemm",
                                  "brgemm_tc_dw": "brgemm"}
    assert "conv_kxk_fwd_tc" in chip_smoke.SOURCES


def test_profile_symbols_tell_the_forward_routes_apart():
    """The tensor-core forward's symbol names its kernel and nothing of the
    SIMT forward or of either weight gradient; the SIMT forward's loader
    name is in neither tensor-core kernel's name."""
    sym, kern = chip_smoke.R_SYMBOLS["convkxk_tc"], chip_smoke.FWD_TC_KERNEL
    simt = chip_smoke.R_SYMBOLS["convkxk"]
    assert sym == "conv_kxk_fwd_tc" and kern == sym + "_kernel"
    assert simt == "XRows"
    fwd_name = ("void (anonymous namespace)::conv_kxk_fwd_tc_kernel<128, "
                "false>(__nv_bfloat16 const*, __nv_bfloat16 const*)")
    phase_name = fwd_name.replace("false", "true")
    dw_name = ("void (anonymous namespace)::conv_kxk_dw_tc_kernel<128, "
               "false>(__nv_bfloat16 const*)")
    simt_name = ("void igemm::gemm_kernel<128, (anonymous namespace)::XRows"
                 "<__nv_bfloat16>, igemm::DenseB<__nv_bfloat16> >()")
    assert kern in fwd_name and simt not in fwd_name
    assert kern in phase_name and simt not in phase_name
    assert sym not in dw_name + simt_name
    for other in ("convkxk_dx", "convkxk_dw", "convkxk_dw_tc", "brgemm"):
        assert chip_smoke.R_SYMBOLS[other] not in fwd_name + phase_name
    tc_in_step = chip_smoke.TC_IN_STEP
    # the 3x3 forwards, the stride-1 dx, 4 phases a stride-2 dx, the 1x1
    # "nn" GEMMs
    assert tc_in_step == {kern: 16 + 13 + 3 * 4 + 72, simt: 0,
                          chip_smoke.DW_TC_KERNEL: 16 + 36,
                          chip_smoke.R_SYMBOLS["convkxk_dx"]: 0,
                          chip_smoke.R_SYMBOLS["convkxk_dw"]: 0,
                          chip_smoke.R_SYMBOLS["brgemm"]: 0}


@pytest.mark.parametrize("dtype,base,table,tc,simt", [
    (torch.bfloat16, "R_PER_STEP", "TC_PER_STEP", 16, 0),
    (torch.float32, "R_PER_STEP", "TC_PER_STEP", 0, 16),
    (torch.bfloat16, "R_POOL_OFF", "TC_PER_STEP", 16, 0),
    (torch.bfloat16, "R_EVAL", "TC_EVAL", 16, 0),
    (torch.float32, "R_EVAL", "TC_EVAL", 0, 16),
], ids=["bf16_step", "f32_step", "bf16_pool_off", "bf16_eval", "f32_eval"])
def test_fwd_routes_split_the_3x3_forwards_by_dtype(dtype, base, table, tc,
                                                    simt):
    counts, table = getattr(chip_smoke, base), getattr(chip_smoke, table)
    want = chip_smoke.routes(dtype, counts, ("convkxk",), table)
    assert (want["convkxk_tc"], want["convkxk_simt"]) == (tc, simt)
    assert want["convkxk"] == tc + simt
    assert {k: v for k, v in want.items()
            if k not in ("convkxk_tc", "convkxk_simt")} == counts
    every = chip_smoke.routes(dtype, counts, tc=table)
    assert every == dict(chip_smoke.routes(
        dtype, counts, ("convkxk_dx", "convkxk_dw", "brgemm"), table),
        convkxk_tc=tc, convkxk_simt=simt)


def test_eval_forward_reaches_the_3x3_convs_in_float32(monkeypatch):
    """R3's eval gate expects the eval forward's 16 3x3 forwards on the
    SIMT kernel: in the pure bf16 bench model they see float32 (the stem's
    BatchNorm promotes the activation), while the training step's see
    bf16 (the tensor cores)."""
    from paddle_tpu_torch import bench
    from paddle_tpu_torch.kernels import conv_fused as cf
    from paddle_tpu_torch.ops import nn_ops
    monkeypatch.setattr(nn_ops, "CONV_FUSED", True)
    seen, plain = [], cf.convkxk_reference

    def spy(x, w, *args, **kwargs):
        seen.append((x.dtype, w.dtype))
        return plain(x, w, *args, **kwargs)

    monkeypatch.setattr(cf, "convkxk_reference", spy)
    model, params, opt, state, x, labels = bench.build(2, 64, "", "cpu")
    bench.train_step(model, params, opt, state, x, labels)
    assert seen == [(torch.bfloat16, torch.bfloat16)] * 16
    seen.clear()
    model.eval()
    with torch.no_grad():
        model(x)
    assert seen == [(chip_smoke.EVAL_DTYPE, chip_smoke.EVAL_DTYPE)] * 16
    assert cf.kxk_fwd_route(chip_smoke.EVAL_DTYPE, 64, 64, True) == "simt"


def test_resnet_3x3_forwards_take_the_route_the_script_asserts():
    """R1 and R3 assert every 3x3 forward of ResNet-50 on the tensor cores
    in bf16 and on SIMT in float32: the port's rule says so for every 3x3
    shape of the step; the further R1 cases are bf16 tc shapes that cover
    a dilation, an M that is no multiple of the 128-row tile, three
    64-column tiles, a float32 output and the eval chain."""
    from paddle_tpu_torch.kernels.conv_fused import kxk_fwd_route
    for h, c, o, k, s in chip_smoke.resnet50_conv_shapes():
        if k == 3:
            assert kxk_fwd_route(torch.bfloat16, c, o, True) == "tc"
            assert kxk_fwd_route(torch.float32, c, o, True) == "simt"
    cases = {c[0]: c for c in chip_smoke.R1_FWD_TC_CASES}
    assert cases["dilated"][3] == 2
    _, (h, c, o, k, s), batch, _, _, _ = cases["ragged_m"]
    oh = (h - 1) // s + 1
    assert batch * oh * oh % 128 != 0
    assert cases["o192"][1][2] == 192
    assert cases["f32_out"][5] == torch.float32
    assert cases["eval_chain"][4] and cases["eval_chain"][1] == \
        (7, 512, 512, 3, 1)
    for _, (h, c, o, k, s), *_ in cases.values():
        assert kxk_fwd_route(torch.bfloat16, c, o, True) == "tc"


def test_profile_symbols_tell_the_weight_gradient_routes_apart():
    """The tensor-core row's symbol names its GEMM and its reduction's tag,
    the GEMM's own symbol only the GEMM; neither holds the SIMT kernel's
    loader name, nor it theirs."""
    sym, gemm = chip_smoke.R_SYMBOLS["convkxk_dw_tc"], chip_smoke.DW_TC_KERNEL
    simt = chip_smoke.R_SYMBOLS["convkxk_dw"]
    assert sym == "conv_kxk_dw_tc" and gemm == sym + "_kernel"
    assert simt == "XCols"
    gemm_name = ("void (anonymous namespace)::conv_kxk_dw_tc_kernel<128, "
                 "false>(__nv_bfloat16 const*)")
    reduce_name = ("void igemm::splitk_reduce<(anonymous namespace)::"
                   "conv_kxk_dw_tc_split>(float const*, int)")
    assert sym in gemm_name and sym in reduce_name
    assert gemm in gemm_name and gemm not in reduce_name
    assert simt not in gemm_name + reduce_name


@pytest.mark.parametrize("dtype,base,table,tc,simt", [
    (torch.bfloat16, "R_PER_STEP", "TC_PER_STEP", 16, 0),
    (torch.float32, "R_PER_STEP", "TC_PER_STEP", 0, 16),
    (torch.bfloat16, "R_POOL_OFF", "TC_PER_STEP", 16, 0),
    (torch.bfloat16, "R_EVAL", "TC_EVAL", 0, 0),
], ids=["bf16_step", "f32_step", "bf16_pool_off", "eval"])
def test_dw_routes_split_the_weight_gradients_by_dtype(dtype, base, table,
                                                       tc, simt):
    counts, table = getattr(chip_smoke, base), getattr(chip_smoke, table)
    want = chip_smoke.routes(dtype, counts, ("convkxk_dw",), table)
    assert (want["convkxk_dw_tc"], want["convkxk_dw_simt"]) == (tc, simt)
    assert want["convkxk_dw"] == tc + simt
    assert {k: v for k, v in want.items()
            if not k.startswith("convkxk_dw_")} == counts


def test_resnet_3x3_shapes_take_the_route_the_script_asserts():
    """R1 and R3 assert every 3x3 weight gradient of ResNet-50 on the
    tensor cores in bf16 and on SIMT in float32: the port's rule says so
    for every 3x3 shape of the step; the further R1 cases are bf16 tc
    shapes that cover a dilation, a K that is no multiple of the K step,
    and both store paths."""
    from paddle_tpu_torch.kernels import tiles
    from paddle_tpu_torch.kernels.conv_fused import dw_route
    for h, c, o, k, s in chip_smoke.resnet50_conv_shapes():
        if k == 3:
            assert dw_route(torch.bfloat16, c, o, True) == "tc"
            assert dw_route(torch.float32, c, o, True) == "simt"
    cases = {c[0]: c for c in chip_smoke.R1_DW_TC_CASES}
    assert cases["dilated"][3] == 2 and cases["dilated"][4]
    _, (h, c, o, k, s), batch, _, _, _ = cases["ragged_k"]
    oh = (h - 1) // s + 1
    assert batch * oh * oh % tiles.TC_TILE_K != 0
    assert cases["one_split"][5] == 1 and cases["most_splits"][5] == "most"
    for _, (h, c, o, k, s), *_ in cases.values():
        assert dw_route(torch.bfloat16, c, o, True) == "tc"


def test_kernels_line_has_the_tensor_core_dx_row():
    """The 20th row: #7's tensor-core route, the accepted tensor-core
    forward's source at the geometry of the stride-1 forward conv a dx is,
    named after the counter of the wrapper that picks it, with its own
    part in R4 and the forward's kernel symbol in the profile."""
    from paddle_tpu_torch.kernels import conv_fused as cf
    row, simt = chip_smoke.KERNELS["convkxk_dx_tc"], \
        chip_smoke.KERNELS["convkxk_dx"]
    assert row == {"route": "cuda",
                   "source": "paddle_tpu_torch/csrc/conv_kxk_fwd_tc.cu",
                   "replaces": "paddle_tpu/kernels/conv_fused.py:425"}
    assert simt["replaces"] == row["replaces"]
    assert "convkxk_dx_tc" in chip_smoke.RESNET_KERNELS
    assert chip_smoke.tc_rows("convkxk_dx") == ["convkxk_dx_tc",
                                                "convkxk_dx_tc_phase"]
    assert chip_smoke.TC_KERNEL["convkxk_dx_tc"] == chip_smoke.FWD_TC_KERNEL
    assert chip_smoke.R_SYMBOLS["convkxk_dx_tc"] == "conv_kxk_fwd_tc"
    assert hasattr(cf.convkxk_dx_cuda, "tc_launches")
    assert set(chip_smoke.r_counters()) >= {"convkxk_dx_tc",
                                            "convkxk_dx_simt"}


def test_kernels_line_has_the_tensor_core_dx_phase_row():
    """The 22nd row: #7's route at a stride above 1, the tensor-core
    forward's source, named after the counter of the wrapper that picks
    it; the step's profile counts each call's phases with taps
    (``TC_RECORDS``: 4 at every stride-2 3x3 of ResNet-50, as R4's
    ``r4_records`` counts them) under the forward's symbol."""
    from paddle_tpu_torch.kernels import conv_fused as cf
    row = chip_smoke.KERNELS["convkxk_dx_tc_phase"]
    assert row == chip_smoke.KERNELS["convkxk_dx_tc"]
    assert chip_smoke.TC_TWIN["convkxk_dx_tc_phase"] == "convkxk_dx"
    assert chip_smoke.R4_PARTS["convkxk_dx_tc_phase"] == (
        "convkxk_dx_tc_phase", "tc_phase", ("convkxk_dx",))
    assert chip_smoke.TC_KERNEL["convkxk_dx_tc_phase"] == \
        chip_smoke.FWD_TC_KERNEL
    assert chip_smoke.R_SYMBOLS["convkxk_dx_tc_phase"] == "conv_kxk_fwd_tc"
    assert hasattr(cf.convkxk_dx_cuda, "tc_phase_launches")
    assert "convkxk_dx_tc_phase" in chip_smoke.r_counters()
    for shape in chip_smoke.resnet50_conv_shapes():
        h, c, o, k, s = shape
        if k == 3 and s == 2:
            assert chip_smoke.r4_records("convkxk_dx", "tc_phase", shape,
                                         chip_smoke.R3_BATCH, "cpu") == \
                chip_smoke.TC_RECORDS["convkxk_dx_tc_phase"] == 4


def test_r4_parts_time_their_rows_route():
    """Every R4 part launches its row's own route: a tensor-core row's is
    the rest of its name after its SIMT twin's (``TC_TWIN``), a SIMT
    twin's "simt"; no part of a row is a yardstick on another route."""
    for part, (row, route, _) in chip_smoke.R4_PARTS.items():
        twin = chip_smoke.TC_TWIN.get(row)
        assert route == (row[len(twin) + 1:] if twin else "simt"), part


def _fake_profile(monkeypatch, rows):
    """``chip_smoke.profiled`` replaced by one that runs ``fn`` and returns
    ``rows`` as its records; returns the list of the ``expect`` it got."""
    asked = []

    def profiled(fn, label, expect=None):
        fn()
        asked.append(expect)
        return sum(r[2] for r in rows), rows, 1.0

    monkeypatch.setattr(chip_smoke, "profiled", profiled)
    monkeypatch.setattr(chip_smoke, "r4_lead_in", lambda dev: None)
    return asked


def test_r4_library_device_time_is_the_mean_of_its_kernels_records(
        monkeypatch):
    """``library_device`` runs the library calls (twice: once to warm up,
    once profiled), asks the profile for one record of the library's
    kernel a call, and gives the mean of those records' device time a
    call, other records (a memset) left out."""
    ran = []
    calls = [lambda i=i: ran.append(i) for i in range(3)]
    rows = [("sm90_xmma_dgrad_implicit_gemm_indexed_bf16", 3, 0.6),
            ("Memset (Device)", 3, 0.003)]
    asked = _fake_profile(monkeypatch, rows)
    got = chip_smoke.library_device(calls, "dgrad", "cpu", "label")
    assert got == pytest.approx(0.2)
    assert ran == [0, 1, 2, 0, 1, 2]
    assert asked == [{"dgrad": 3}]
    assert set(chip_smoke.R4_LIBRARY_SYMBOL) == {"convkxk_dx_tc_phase"}
    assert set(chip_smoke.R4_LIBRARY_SYMBOL) <= set(
        chip_smoke.RESNET_KERNELS)


@pytest.mark.parametrize("rows", [
    [("Memset (Device)", 3, 0.003)],
    [("sm90_xmma_dgrad_implicit_gemm_indexed_bf16", 2, 0.4)],
    [("sm90_xmma_dgrad_a", 2, 0.4), ("sm90_xmma_dgrad_b", 2, 0.4)],
], ids=["no_kernel_record", "a_record_short", "a_record_over"])
def test_r4_library_device_time_is_none_where_a_record_is_off(monkeypatch,
                                                              rows):
    """Where the profile keeps another count of the library's kernel than
    one a call (the library picked other kernels, or a record went
    missing), ``library_device`` keeps no time: None, not a mean over the
    records it has."""
    _fake_profile(monkeypatch, rows)
    calls = [lambda: None] * 3
    assert chip_smoke.library_device(calls, "dgrad", "cpu", "label") is None


@pytest.mark.parametrize("dtype,base,table,tc,phase,simt", [
    (torch.bfloat16, "R_PER_STEP", "TC_PER_STEP", 13, 3, 0),
    (torch.float32, "R_PER_STEP", "TC_PER_STEP", 0, 0, 16),
    (torch.bfloat16, "R_POOL_OFF", "TC_PER_STEP", 13, 3, 0),
    (torch.bfloat16, "R_EVAL", "TC_EVAL", 0, 0, 0),
], ids=["bf16_step", "f32_step", "bf16_pool_off", "eval"])
def test_dx_routes_split_the_3x3_dx_by_dtype_and_stride(dtype, base, table,
                                                        tc, phase, simt):
    counts, table = getattr(chip_smoke, base), getattr(chip_smoke, table)
    want = chip_smoke.routes(dtype, counts, ("convkxk_dx",), table)
    assert (want["convkxk_dx_tc"], want["convkxk_dx_tc_phase"],
            want["convkxk_dx_simt"]) == (tc, phase, simt)
    assert want["convkxk_dx"] == tc + phase + simt
    assert {k: v for k, v in want.items()
            if not k.startswith("convkxk_dx_")} == counts


def test_resnet_3x3_dx_take_the_route_the_script_asserts():
    """R1, R3 and R4 assert ResNet-50's 16 3x3 dx on the tensor cores in
    bf16, the 13 stride-1 ones as one conv and the 3 stride-2 ones by
    phases, and every float32 one and every one that folds on SIMT: the
    port's rule says so for every 3x3 shape of the step; the further R1
    cases take the route each names: as one conv a dilation, a negative
    low pad of g with C != O, an M that is no multiple of the 128-row tile
    and a float32 dx; by phases at stride 2 a ragged M, an odd H with C !=
    O, a stride of (2, 1), a float32 dx, phases no tap reaches and O = C =
    192, and a stride of 3."""
    from paddle_tpu_torch.kernels.conv_fused import (dx_geometry, dx_phases,
                                                     dx_route)
    strides = [s for h, c, o, k, s in chip_smoke.resnet50_conv_shapes()
               if k == 3]
    assert (strides.count(1), strides.count(2)) == (13, 3)
    per_step = chip_smoke.TC_PER_STEP
    assert (per_step["convkxk_dx_tc"], per_step["convkxk_dx_tc_phase"]) == \
        (strides.count(1), strides.count(2))
    for h, c, o, k, s in chip_smoke.resnet50_conv_shapes():
        if k == 3:
            assert dx_route(torch.bfloat16, c, o, True, (s, s), False) == \
                ("tc" if s == 1 else "tc_phase")
            assert dx_route(torch.float32, c, o, True, (s, s), False) == \
                "simt"
            assert dx_route(torch.bfloat16, c, o, True, (s, s), True) == \
                "simt"
    cases = {c[0]: c for c in chip_smoke.R1_DX_TC_CASES}
    geos, phases = {}, {}
    for name, (h, wd, c), o, batch, pad, dil, _, stride, route in \
            cases.values():
        assert dx_route(torch.bfloat16, c, o, True, stride, False) == route
        args = ((batch, h, wd, c), (o, c, 3, 3), stride, pad, (dil, dil))
        geos[name], phases[name] = dx_geometry(*args), dx_phases(*args)
    assert cases["dilated"][5] == 2
    assert geos["uneven_pad"][11] < 0 and cases["uneven_pad"][1][2] != \
        cases["uneven_pad"][2]
    n, h, wd = geos["ragged_m"][0], geos["ragged_m"][7], geos["ragged_m"][8]
    assert n * h * wd % 128 != 0
    assert all(p.geo[0] * p.geo[7] * p.geo[8] % 128 != 0
               for p in phases["s2_ragged_m"])
    assert cases["f32_out"][6] == cases["s2_f32_out"][6] == torch.float32
    assert cases["s2_odd_h"][1][0] % 2 == 1 and cases["s2_odd_h"][1][2] != \
        cases["s2_odd_h"][2]
    assert cases["s21"][7] == (2, 1)
    assert [p.runs for p in phases["s2_empty_phase"]] == \
        [True, False, False, False]
    assert cases["s2_o192"][1][2] == cases["s2_o192"][2] == 192
    assert len(phases["s3"]) == 9 and all(p.runs for p in phases["s3"])
    assert {c[7] for c in cases.values()} == {(1, 1), (2, 2), (2, 1),
                                              (3, 3)}
    assert all((c[8] == "tc") == (c[7] == (1, 1)) for c in cases.values())


def test_kernels_line_has_the_brgemm_tensor_core_rows():
    """The 18th and 19th rows: #4's tensor-core routes, built from the
    accepted tensor-core conv kernels' sources, named <twin>_<route> after
    the counters of the wrapper that picks them."""
    from paddle_tpu_torch.kernels import tiles
    simt = chip_smoke.KERNELS["brgemm"]
    for row, source in (("brgemm_tc_fwd", "conv_kxk_fwd_tc.cu"),
                        ("brgemm_tc_dw", "conv_kxk_dw_tc.cu")):
        assert chip_smoke.KERNELS[row] == {
            "route": "cuda", "source": "paddle_tpu_torch/csrc/" + source,
            "replaces": simt["replaces"]}
        assert row in chip_smoke.RESNET_KERNELS
        assert chip_smoke.TC_TWIN[row] == "brgemm"
        assert hasattr(tiles.brgemm_cuda, row[len("brgemm_"):] + "_launches")
    assert chip_smoke.tc_rows("brgemm") == ["brgemm_tc_fwd", "brgemm_tc_dw"]
    assert set(chip_smoke.r_counters()) >= {"brgemm_tc_fwd", "brgemm_tc_dw",
                                            "brgemm_simt"}


@pytest.mark.parametrize("dtype,base,table,fwd,dw,simt", [
    (torch.bfloat16, "R_PER_STEP", "TC_PER_STEP", 72, 36, 0),
    (torch.float32, "R_PER_STEP", "TC_PER_STEP", 0, 0, 108),
    (torch.bfloat16, "R_POOL_OFF", "TC_PER_STEP", 72, 36, 0),
    (torch.bfloat16, "R_EVAL", "TC_EVAL", 36, 0, 0),
    (torch.float32, "R_EVAL", "TC_EVAL", 0, 0, 36),
], ids=["bf16_step", "f32_step", "bf16_pool_off", "bf16_eval", "f32_eval"])
def test_brgemm_routes_split_the_1x1_gemms_by_dtype(dtype, base, table, fwd,
                                                    dw, simt):
    counts, table = getattr(chip_smoke, base), getattr(chip_smoke, table)
    want = chip_smoke.routes(dtype, counts, ("brgemm",), table)
    assert (want["brgemm_tc_fwd"], want["brgemm_tc_dw"],
            want["brgemm_simt"]) == (fwd, dw, simt)
    assert want["brgemm"] == fwd + dw + simt


class _FakeLaunches:
    """The wrappers' launch functions replaced by the plain versions, each
    launch's route recorded: the wrappers' rules and counters run on CPU
    tensors as they run on the card."""

    def __init__(self, monkeypatch):
        from paddle_tpu_torch.kernels import conv_fused as cf
        from paddle_tpu_torch.kernels import tiles
        self.routes = []
        for mod, name, plain in (
                (tiles, "brgemm_launch", tiles.brgemm_reference),
                (cf, "convkxk_launch", cf.convkxk_reference),
                (cf, "convkxk_dx_launch", cf.convkxk_dx_reference),
                (cf, "convkxk_dw_launch", cf.convkxk_dw_reference)):
            monkeypatch.setattr(mod, name, self._fake(plain))
        for f, a in chip_smoke.r_counters().values():
            monkeypatch.setattr(f, a, 0)

    def _fake(self, plain):
        def launch(route, *args, facts=None, **kwargs):
            self.routes.append(route)
            return plain(*args, **kwargs)
        return launch


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_conv_calls_take_the_route_the_script_asserts(monkeypatch, dtype):
    """R1's ``want_route`` is what the port's wrappers pick (their rules
    and counters, the launches faked) for every call ``conv_calls`` makes
    at every distinct ResNet-50 shape, with and without the epilogue and
    the fold: in bf16 a dx that folds stays on SIMT, every other call takes
    the tensor cores (the 3x3 dx at stride 2 by phases)."""
    fake = _FakeLaunches(monkeypatch)
    for shape in sorted(set(chip_smoke.resnet50_conv_shapes())):
        x, w, g = chip_smoke.r_inputs(shape, 1, dtype, "cpu", 0)
        o = shape[2]
        extra = (torch.rand(o) + 0.5, torch.randn(o),
                 torch.randn(g.shape).to(dtype),
                 torch.relu(torch.randn(g.shape)).to(dtype))
        for ex in (None, extra):
            for name, (kern, _) in chip_smoke.conv_calls(shape, x, w, g,
                                                         ex).items():
                want = chip_smoke.want_route(name, dtype, ex is not None,
                                             shape[4])
                kernel = "brgemm" if name.startswith("brgemm") else name
                before = chip_smoke.r_counts()
                kern()
                assert chip_smoke.route_taken(before, kernel) == want, \
                    (name, shape)
                assert fake.routes[-1] == want
    assert {"tc_fwd", "tc_dw", "tc", "tc_phase", "simt"} == \
        set(fake.routes) or dtype == torch.float32


@pytest.mark.parametrize("lowp", ["grad+out+blk+stem+bnres", ""],
                         ids=["lowp", "bf16"])
def test_bench_step_counts_the_routes_r3_expects(monkeypatch, lowp):
    """R3's gates on the real model at a small size: a bf16 training step
    through the wrappers (launches faked) counts ``routes(bf16)``, every
    1x1 forward and dx on the tensor-core forward (no conv of the step
    folds: BatchNorm runs apart in training) and every 1x1 weight
    gradient on the tensor-core weight gradient, the 16 3x3 dx on the
    tensor-core forward (13 at stride 1 as one conv, 3 at stride 2 by
    phases); the pure bf16
    model's eval forward counts ``routes(EVAL_DTYPE, R_EVAL)``, all on
    SIMT."""
    from paddle_tpu_torch import bench
    from paddle_tpu_torch.kernels import conv_fused as cf
    from paddle_tpu_torch.kernels import tiles
    from paddle_tpu_torch.ops import nn_ops
    assert lowp == "" or lowp == bench.DEFAULT_LOWP
    _FakeLaunches(monkeypatch)
    monkeypatch.setattr(nn_ops, "CONV_FUSED", True)
    for mod, plain, cuda in ((tiles, "brgemm_reference", tiles.brgemm_cuda),
                             (cf, "convkxk_reference", cf.convkxk_cuda),
                             (cf, "convkxk_dx_reference",
                              cf.convkxk_dx_cuda),
                             (cf, "convkxk_dw_reference",
                              cf.convkxk_dw_cuda)):
        monkeypatch.setattr(mod, plain, cuda)
    model, params, opt, state, x, labels = bench.build(2, 64, lowp, "cpu")

    def routed(counts):
        # the routed kernels' counts (the pool kernels run their plain
        # versions here and count nothing)
        return {k: v for k, v in counts.items() if k.startswith(
            ("brgemm", "convkxk"))}

    chip_smoke.zero_r_counts()
    bench.train_step(model, params, opt, state, x, labels)
    counts = chip_smoke.r_counts()
    assert routed(counts) == routed(chip_smoke.routes(torch.bfloat16))
    assert (counts["convkxk_dx_tc"], counts["convkxk_dx_tc_phase"],
            counts["convkxk_dx_simt"]) == (13, 3, 0)
    if not lowp:
        model.eval()
        chip_smoke.zero_r_counts()
        with torch.no_grad():
            model(x)
        assert routed(chip_smoke.r_counts()) == routed(chip_smoke.routes(
            chip_smoke.EVAL_DTYPE, chip_smoke.R_EVAL, tc=chip_smoke.TC_EVAL))


def test_r4_parts_time_every_routed_row_apart():
    """At every ResNet-50 shape, each call of ``conv_calls`` is launched in
    exactly one SIMT part and, where the bf16 step takes the tensor cores,
    in exactly one kernel part of that route, its row's own: the dx at
    stride 1 and at stride 2 apart on every route, in different sessions.
    No kernel symbol repeats within a session; every tensor-core part has
    a SIMT part over the same calls; every ResNet kernel row has a
    part."""
    parts, sessions = chip_smoke.R4_PARTS, chip_smoke.R4_SESSIONS
    assert sorted(p for s in sessions for p in s) == sorted(parts)
    assert len(sessions) == 4
    for session in sessions:
        syms = [chip_smoke.R_SYMBOLS[parts[p][0]] for p in session]
        assert all(a not in b for a in syms for b in syms if a is not b)
    for shape in sorted(set(chip_smoke.resnet50_conv_shapes())):
        for call in (("brgemm_fwd", "brgemm_dx", "brgemm_dw")
                     if shape[3] == 1 else
                     ("convkxk", "convkxk_dx", "convkxk_dw")):
            kernel = "brgemm" if call.startswith("brgemm") else call
            takers = [p for p in parts
                      if chip_smoke.part_takes(p, call, shape[4])]
            simt = [p for p in takers if parts[p][1] == "simt"]
            assert len(simt) == 1 and parts[simt[0]][0] == kernel
            tc = [p for p in takers if parts[p][1] != "simt"]
            want = chip_smoke.want_route(call, torch.bfloat16, False,
                                         shape[4])
            assert [parts[p][1] for p in tc] == \
                ([] if want == "simt" else [want]), (call, shape)
            for p in tc:
                assert parts[p][0] == f"{kernel}_{want}"
                assert parts[p][2] == parts[simt[0]][2]
                assert chip_smoke.R4_STRIDES.get(p) == \
                    chip_smoke.R4_STRIDES.get(simt[0])
    for by_stride in (("simt", "simt"), ("tc", "tc_phase")):
        dx_s1, dx_s2 = (next(p for p in parts
                             if parts[p][1] == route
                             and parts[p][0].startswith("convkxk_dx")
                             and chip_smoke.part_takes(p, "convkxk_dx", s))
                        for s, route in zip((1, 2), by_stride))
        assert dx_s1 != dx_s2
        assert not any(dx_s1 in s and dx_s2 in s for s in sessions)
    assert set(r for r, _, _ in parts.values()) == \
        set(chip_smoke.RESNET_KERNELS)


@pytest.mark.parametrize("key", chip_smoke.RESNET_KERNELS)
def test_r4_rows_are_means_over_the_calls_the_step_launches_on_them(key):
    """R4's numbers of a row are means over the calls of its parts
    (``r4_row_parts``, all of the row's) at every ResNet-50 conv: the
    calls a bf16 step launches on the row's route, as many as its
    launches there (for the tensor-core dx the 13 stride-1 calls, for the
    dx by phases the 3 stride-2 calls), or, for a
    SIMT twin the step launches nowhere (the SIMT dx too), all the step's
    calls of its kernel."""
    step = chip_smoke.routes(torch.bfloat16)
    launches = step[key] if key in chip_smoke.TC_TWIN else \
        step[f"{key}_simt"]
    parts = chip_smoke.r4_row_parts(key)
    taken = [(shape, call) for shape in chip_smoke.resnet50_conv_shapes()
             for call in (("brgemm_fwd", "brgemm_dx", "brgemm_dw")
                          if shape[3] == 1 else
                          ("convkxk", "convkxk_dx", "convkxk_dw"))
             if any(chip_smoke.part_takes(p, call, shape[4])
                    for p in parts)]
    assert len(taken) == (launches or chip_smoke.R_PER_STEP[key])
    mine = [p for p, (row, _, _) in chip_smoke.R4_PARTS.items()
            if row == key]
    assert parts == mine
    if key.startswith("convkxk_dx"):
        want = {"convkxk_dx": (0, {(3, 1), (3, 2)}),
                "convkxk_dx_tc": (13, {(3, 1)}),
                "convkxk_dx_tc_phase": (3, {(3, 2)})}[key]
        assert (launches, {(shape[3], shape[4]) for shape, call in taken}) \
            == want


@pytest.mark.parametrize("geo,esize,nbytes,ops", [
    # the stem at batch 256 in bf16: x, out and int32 idx (about 719 MB)
    ((256, 112, 112, 64, 56, 56, 3, 3, 2, 2, 1, 1), 2,
     2 * (256 * 112 * 112 * 64 + 256 * 56 * 56 * 64) + 4 * 256 * 56 * 56 * 64,
     9 * 256 * 56 * 56 * 64),
    # 2x2/s2 on a 4x6 float32 plane, 3 channels: 2x3 outputs
    ((1, 4, 6, 3, 2, 3, 2, 2, 2, 2, 0, 0), 4,
     4 * (72 + 18) + 4 * 18, 4 * 18),
])
def test_pool_work_counts_x_out_and_idx_once(geo, esize, nbytes, ops):
    assert chip_smoke.pool_work(geo, esize) == (nbytes, ops)
    assert abs(nbytes - 719e6) < 1e6 or geo[0] != 256


def test_seqpool_work_counts_the_distinct_rows():
    # rows 0, 3 and 7 named (0 three times): 3 rows, 2 outputs of 4 columns
    ids = torch.tensor([[0, 3, 0], [7, 0, 3]])
    assert chip_smoke.seqpool_work(ids, 4, 4) == (
        4 * 4 * (3 + 2) + 4 * 6, 6 * 4)


def test_layer_norm_work_counts_x_y_and_the_affine_once():
    """bf16 [32768, 1024] with scale and bias: x read and y written once
    (134.2 MB) plus the two float32 vectors; 40.07 us at 3.35 TB/s."""
    nbytes, ops = chip_smoke.ln_work(32768, 1024, 2, True)
    assert nbytes == 2 * 32768 * 1024 * 2 + 8 * 1024
    assert ops == chip_smoke.LN_FLOPS_PER_ELEMENT * 32768 * 1024
    ms, by = chip_smoke.bound_ms(nbytes, ops, torch.float32)
    assert by == "bytes" and ms == pytest.approx(0.04007, rel=1e-3)
    assert chip_smoke.ln_work(7, 10, 4, False) == (2 * 7 * 10 * 4,
                                                   8 * 7 * 10)


@pytest.mark.parametrize("dtype,mant", [(torch.bfloat16, 7),
                                        (torch.float16, 10)])
def test_layer_norm_gate_allows_one_ulp_and_no_more(dtype, mant):
    ref = torch.tensor([1.0, -3.0, 0.25, 100.0]).to(dtype)
    ulp = torch.tensor([2.0 ** -mant, 2.0 ** (1 - mant), 2.0 ** (-2 - mant),
                        2.0 ** (6 - mant)])
    one = (ref.float() + ulp).to(dtype)
    two = (ref.float() + 2 * ulp).to(dtype)
    assert chip_smoke.ln_error(ref, ref)[2]
    err, ulps, ok = chip_smoke.ln_error(one, ref)
    assert ok and err == pytest.approx(2.0 ** (6 - mant))
    assert not chip_smoke.ln_error(two, ref)[2]
    f32 = torch.tensor([1.0, 2.0])
    assert chip_smoke.ln_error(f32 * (1 + 1e-6), f32)[2]
    assert not chip_smoke.ln_error(f32 * (1 + 1e-4), f32)[2]


def test_bert_launches_a_step():
    """B1's float32 steps and B2's bf16 ones: the forward, dQ and dK/dV
    split by dtype, the tensor cores in bf16 and the SIMT kernels in
    float32."""
    assert chip_smoke.b_expect(True, torch.bfloat16) == {
        "flash_fwd": 12, "flash_fwd_tc": 12, "flash_fwd_simt": 0,
        "flash_bwd_dq": 12, "flash_bwd_dq_tc": 12, "flash_bwd_dq_simt": 0,
        "flash_bwd_dkv": 12, "flash_bwd_dkv_tc": 12,
        "flash_bwd_dkv_simt": 0, "layer_norm": 0, "fused_update": 0}
    assert chip_smoke.b_expect(True, torch.float32) == dict(
        chip_smoke.b_expect(True, torch.bfloat16), flash_fwd_tc=0,
        flash_fwd_simt=12, flash_bwd_dq_tc=0, flash_bwd_dq_simt=12,
        flash_bwd_dkv_tc=0, flash_bwd_dkv_simt=12)
    for dtype in (torch.float32, torch.bfloat16):
        assert set(chip_smoke.b_expect(False, dtype).values()) == {0}
        assert set(chip_smoke.b_expect(False, dtype)) == set(
            chip_smoke.B_KEYS)


def test_bert_batch_pads_no_row_entirely():
    ids, labels, weights, nsp = chip_smoke.bert_batch(8, 30522, "cpu", 0)
    assert ids.shape == labels.shape == weights.shape == (8, 128)
    assert bool((ids != 0).any(1).all()) and bool((ids[0] != 0).all())
    assert bool((ids == 0).any())
    assert bool((weights[ids == 0] == 0).all()) and weights.sum() > 0
    assert int(ids.max()) < 30522 and set(nsp.tolist()) <= {0, 1}


# B1's dense and flash BERT ([B, 1, 1, T] padding mask) and T2's decoder
# self-attention (a causal [1, 1, T, T] mask, which the flash route hands
# to the dense one)
@pytest.mark.parametrize("use_flash, causal_mask", [
    (False, False), (True, False), (True, True)],
    ids=["dense", "flash", "causal_mask"])
def test_permuted_keys_covers_every_route(use_flash, causal_mask):
    """Every attention of the model fed its keys, values and mask in
    another order gives the same output and input gradients, up to float32
    rounding, on the dense and the flash route."""
    from paddle_tpu_torch.nn import MultiHeadAttention
    gen = torch.Generator().manual_seed(0)
    mha = MultiHeadAttention(32, 4, use_flash=use_flash, generator=gen)
    x = torch.randn(2, 16, 32, generator=gen).requires_grad_()
    if causal_mask:
        mask = torch.ones(16, 16, dtype=torch.bool).tril()[None, None]
    else:
        mask = torch.ones(2, 1, 1, 16, dtype=torch.bool)
        mask[1, ..., 11:] = False
    out = []
    for reorder in (False, True):
        with chip_smoke.permuted_keys(3) if reorder else \
                contextlib.nullcontext():
            y = mha(x, mask=mask)
            (g,) = torch.autograd.grad(y.square().sum(), x)
        out.append((y.detach(), g))
    assert not torch.equal(out[0][0], out[1][0]) or \
        not torch.equal(out[0][1], out[1][1])
    for a, b in zip(*out):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


# every forward shape the script checks, with the route it must see
_FWD_SHAPES = chip_smoke.CHECK_SHAPES + chip_smoke.BWD_CHECK_SHAPES


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", _FWD_SHAPES,
                         ids=[f"{s[0]}_{i}" for i, s in
                              enumerate(_FWD_SHAPES)])
def test_expected_route_is_the_ports_rule(shape, dtype):
    """The route the script asserts, written out, is the one the port's
    ``fwd_route`` picks for contiguous, aligned inputs: the tensor cores
    for bf16 at D % 16 == 0 and Tq >= 16, the SIMT kernel for float32,
    decode and D = 100."""
    from paddle_tpu_torch.kernels.attention import fwd_route
    _, _, _, tq, _, d, _, _ = shape
    want = chip_smoke.expect_route(dtype, tq, d)
    assert fwd_route(dtype, tq, d, True) == want
    assert want == ("simt" if dtype == torch.float32 or tq == 1 or d == 100
                    else "tc")


def test_check_shapes_cover_both_routes_and_the_new_cases():
    names = {s[0]: s for s in chip_smoke.CHECK_SHAPES}
    assert names["d128"][5] == 128 and names["d128"][7] == "padding"
    _, _, _, tq, tk, _, causal, mask = names["causal_512"]
    assert (tq, tk, causal, mask) == (512, 512, True, None)
    routes = {chip_smoke.expect_route(torch.bfloat16, s[3], s[5])
              for s in chip_smoke.CHECK_SHAPES}
    assert routes == {"tc", "simt"}
    assert chip_smoke.KERNELS["flash_fwd_tc"]["replaces"] == \
        chip_smoke.KERNELS["flash_fwd"]["replaces"]
    assert chip_smoke.KERNEL_SYMBOLS["flash_fwd_tc"] not in \
        chip_smoke.KERNEL_SYMBOLS["flash_fwd"]
    assert chip_smoke.KERNEL_SYMBOLS["flash_fwd"] not in \
        chip_smoke.KERNEL_SYMBOLS["flash_fwd_tc"]
    assert chip_smoke.T3_KERNELS[0] == "flash_fwd_tc"


def test_fwd_counts_split_the_forward_by_route():
    assert chip_smoke.route_split(12, torch.bfloat16, "flash_fwd") == {
        "flash_fwd": 12, "flash_fwd_tc": 12, "flash_fwd_simt": 0}
    assert chip_smoke.route_split(24, torch.float32, "flash_fwd") == {
        "flash_fwd": 24, "flash_fwd_tc": 0, "flash_fwd_simt": 24}


@pytest.mark.parametrize("dtype,tc,simt", [(torch.bfloat16, 12, 0),
                                           (torch.float32, 0, 12)],
                         ids=["bf16", "f32"])
def test_dkv_counts_split_the_dkv_by_dtype(dtype, tc, simt):
    """T2's steps and B1/B2's: every dK/dV of a training path (D = 64) on
    the tensor cores in bf16 and on the SIMT kernel in float32, and the
    counters ``counted_wrappers`` reads hold both routes."""
    assert chip_smoke.route_split(12, dtype, "flash_bwd_dkv") == {
        "flash_bwd_dkv": 12, "flash_bwd_dkv_tc": tc,
        "flash_bwd_dkv_simt": simt}
    keys = set(chip_smoke.counted_wrappers())
    assert {"flash_bwd_dkv", "flash_bwd_dkv_tc",
            "flash_bwd_dkv_simt"} <= keys
    assert set(chip_smoke.B_KEYS) == keys | {"layer_norm"}


def test_kernels_line_has_the_tensor_core_dkv_row():
    """The 16th row: the second implementation of the TPU kernel that the
    SIMT dK/dV replaces, built from its own source and checked for HGMMA."""
    row, simt = (chip_smoke.KERNELS["flash_bwd_dkv_tc"],
                 chip_smoke.KERNELS["flash_bwd_dkv"])
    assert row == {"route": "cuda",
                   "source": "paddle_tpu_torch/csrc/flash_bwd_dkv_tc.cu",
                   "replaces": "paddle_tpu/kernels/attention.py:367"}
    assert simt["replaces"] == row["replaces"]
    assert "flash_bwd_dkv_tc" in chip_smoke.SOURCES
    assert chip_smoke.FLASH_TC_TWIN["flash_bwd_dkv_tc"] == "flash_bwd_dkv"


@pytest.mark.parametrize("dtype,tc,simt", [(torch.bfloat16, 12, 0),
                                           (torch.float32, 0, 12)],
                         ids=["bf16", "f32"])
def test_route_split_splits_the_dq_by_dtype(dtype, tc, simt):
    """T2's steps and B1/B2's: every dQ of a training path (D = 64) on the
    tensor cores in bf16 and on the SIMT kernel in float32; the counters
    ``counted_wrappers`` reads hold both routes, and ``flash_counts`` is
    the three flash kernels' counts together."""
    assert chip_smoke.route_split(12, dtype, "flash_bwd_dq") == {
        "flash_bwd_dq": 12, "flash_bwd_dq_tc": tc, "flash_bwd_dq_simt": simt}
    assert {"flash_bwd_dq", "flash_bwd_dq_tc",
            "flash_bwd_dq_simt"} <= set(chip_smoke.counted_wrappers())
    counts = chip_smoke.flash_counts(12, dtype)
    for kernel in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        assert (counts.pop(kernel), counts.pop(f"{kernel}_tc"),
                counts.pop(f"{kernel}_simt")) == (12, tc, simt)
    assert counts == {}


def test_kernels_line_has_the_tensor_core_dq_row():
    """The 17th row: the second implementation of the TPU kernel that the
    SIMT dQ replaces, built from its own source and checked for HGMMA."""
    row, simt = (chip_smoke.KERNELS["flash_bwd_dq_tc"],
                 chip_smoke.KERNELS["flash_bwd_dq"])
    assert row == {"route": "cuda",
                   "source": "paddle_tpu_torch/csrc/flash_bwd_dq_tc.cu",
                   "replaces": "paddle_tpu/kernels/attention.py:345"}
    assert simt["replaces"] == row["replaces"]
    assert len(chip_smoke.KERNELS) == 22
    assert "flash_bwd_dq_tc" in chip_smoke.SOURCES
    assert chip_smoke.FLASH_TC_TWIN == {"flash_fwd_tc": "flash_fwd",
                                        "flash_bwd_dq_tc": "flash_bwd_dq",
                                        "flash_bwd_dkv_tc": "flash_bwd_dkv"}


def test_profile_symbols_tell_the_dq_routes_apart():
    """Neither dQ route's symbol is in the other's kernel name, nor in the
    dK/dV kernels' names, and no other flash symbol is in the dQ kernels'
    names."""
    syms = chip_smoke.KERNEL_SYMBOLS
    tc_name = ("void (anonymous namespace)::flash_bwd_dq_tc_kernel("
               "__nv_bfloat16 const*, __nv_bfloat16 const*)")
    simt_name = ("void (anonymous namespace)::flash_bwd_dq_kernel<"
                 "__nv_bfloat16, 2>(__nv_bfloat16 const*)")
    dkv_names = ("void (anonymous namespace)::flash_bwd_dkv_tc_kernel("
                 "__nv_bfloat16 const*)"
                 "void (anonymous namespace)::flash_bwd_dkv_kernel<"
                 "__nv_bfloat16, 2>(__nv_bfloat16 const*)")
    assert syms["flash_bwd_dq_tc"] in tc_name
    assert syms["flash_bwd_dq_tc"] not in simt_name + dkv_names
    assert syms["flash_bwd_dq"] in simt_name
    assert syms["flash_bwd_dq"] not in tc_name + dkv_names
    for other in ("flash_fwd", "flash_fwd_tc", "flash_bwd_dkv",
                  "flash_bwd_dkv_tc"):
        assert syms[other] not in tc_name + simt_name


def test_profile_symbols_tell_the_dkv_routes_apart():
    """Neither dK/dV route's symbol is in the other's kernel name, nor in
    the dQ kernel's, as the forward's two symbols are kept apart."""
    syms = chip_smoke.KERNEL_SYMBOLS
    tc_name = ("void (anonymous namespace)::flash_bwd_dkv_tc_kernel("
               "__nv_bfloat16 const*, __nv_bfloat16 const*)")
    simt_name = ("void (anonymous namespace)::flash_bwd_dkv_kernel<"
                 "__nv_bfloat16, 2>(__nv_bfloat16 const*)")
    dq_name = ("void (anonymous namespace)::flash_bwd_dq_kernel<"
               "__nv_bfloat16, 2>(__nv_bfloat16 const*)")
    assert syms["flash_bwd_dkv_tc"] in tc_name
    assert syms["flash_bwd_dkv_tc"] not in simt_name + dq_name
    assert syms["flash_bwd_dkv"] in simt_name
    assert syms["flash_bwd_dkv"] not in tc_name + dq_name
    for other in ("flash_fwd", "flash_fwd_tc", "flash_bwd_dq"):
        assert syms[other] not in tc_name + simt_name


def test_t3_and_b2_expect_the_dkv_on_the_tensor_cores():
    """The profiled bf16 training step and B2's use_pallas step count the
    tensor-core dQ and dK/dV, 12 a step each, and gate their SIMT twins
    at 0."""
    assert {"flash_bwd_dq_tc", "flash_bwd_dkv_tc"} <= set(
        chip_smoke.T3_KERNELS)
    assert "flash_bwd_dkv" not in chip_smoke.T3_KERNELS
    assert "flash_bwd_dq" not in chip_smoke.T3_KERNELS
    assert chip_smoke.B2_KERNELS == ("flash_fwd_tc", "flash_bwd_dq_tc",
                                     "flash_bwd_dkv_tc")
    assert set(chip_smoke.FLASH_TC_TWIN.values()).isdisjoint(
        chip_smoke.B2_KERNELS + chip_smoke.T3_KERNELS)


def test_bwd_check_shapes_cover_both_dkv_routes_and_the_new_cases():
    """T1's backward shapes: D = 16 and 32, causal with and without a kv
    mask, ragged Tq and Tk, D = 128 (bf16 on SIMT), and a batch entry
    whose keys are all masked."""
    names = {s[0]: s for s in chip_smoke.BWD_CHECK_SHAPES}
    assert names["d16"][5] == 16 and names["d32_causal"][5] == 32
    _, _, _, tq, tk, _, causal, mask = names["causal_masked"]
    assert causal and mask == "ragged" and tq % 64 and tk % 64
    assert names["causal"][6] and names["causal"][7] is None
    assert names["masked_ragged"][3] % 64 and names["masked_ragged"][4] % 64
    assert names["d128"][5] == 128
    _, b, _, _, tk, _, causal, mask = names["all_pad_causal"]
    m = chip_smoke.make_mask(mask, b, tk, torch.Generator().manual_seed(0),
                             "cpu")
    assert causal and not m[0].any() and m[1:, 0].all()
    assert chip_smoke.expect_bwd_route(torch.bfloat16, 128) == "simt"
    routes = {chip_smoke.expect_bwd_route(dt, s[5])
              for s in chip_smoke.BWD_CHECK_SHAPES
              for dt in (torch.float32, torch.bfloat16)}
    assert routes == {"tc", "simt"}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", chip_smoke.BWD_CHECK_SHAPES,
                         ids=[s[0] for s in chip_smoke.BWD_CHECK_SHAPES])
def test_expected_dkv_route_is_the_ports_rule(shape, dtype):
    """The dQ and dK/dV route T1 asserts, written out, is the one the
    port's ``bwd_route`` picks for contiguous, aligned inputs: the tensor
    cores for bf16 at D <= 64 (``all_pad_causal``, ``d16``,
    ``masked_ragged`` and ``causal_masked`` included), the SIMT kernels
    for float32 and D = 128."""
    from paddle_tpu_torch.kernels.attention import bwd_route
    d = shape[5]
    want = chip_smoke.expect_bwd_route(dtype, d)
    assert bwd_route(dtype, d, True) == want
    assert want == ("tc" if dtype == torch.bfloat16 and d <= 64 else "simt")


class _FakeEvent:
    def __init__(self, key, count, device_us):
        from torch.autograd import DeviceType
        self.key, self.count = key, count
        self.self_device_time_total = device_us
        self.device_type = DeviceType.CUDA


@pytest.mark.parametrize("counts,sessions,last", [
    ([50], 1, 50),                   # the first session counts them all
    ([49, 50], 2, 50),               # a record dropped: profiled again
    ([49, 48, 49], 3, 49),           # never whole: the last is returned
])
def test_profiled_sessions_until_the_counts_agree(monkeypatch, counts,
                                                  sessions, last):
    import torch.profiler as tp
    seen = []

    class _Profile:
        def __init__(self, activities):
            self.n = counts[len(seen)]
            seen.append(self.n)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def key_averages(self):
            return [_FakeEvent("void layer_norm_kernel<float, 4, 8>",
                               self.n, 94.0 * self.n),
                    _FakeEvent("elementwise", 3, 1.0)]

    monkeypatch.setattr(tp, "profile", _Profile)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    calls = []
    busy, rows, _ = chip_smoke.profiled(
        lambda: calls.append(1), "test",
        expect={"layer_norm_kernel": 50})
    assert seen == counts[:sessions] and len(calls) == sessions
    assert rows[0][1] == last and busy == pytest.approx(94e-3 * last + 1e-3)


def test_profiled_without_expect_runs_one_session(monkeypatch):
    import torch.profiler as tp
    sessions = []

    class _Profile:
        def __init__(self, activities):
            sessions.append(1)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def key_averages(self):
            return []

    monkeypatch.setattr(tp, "profile", _Profile)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    busy, rows, _ = chip_smoke.profiled(lambda: None, "test")
    assert sessions == [1] and busy == 0 and rows == []


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_bwd_scaled_gate_fails_a_dropped_query_tile(dtype):
    """At the training shape dK's and dV's elements are far below 1, where
    T1's bf16 gate relative to (1 + |plain|) is near an absolute one: a
    gradient that lost one of its 64 query tiles passes it. The gate
    relative to max|plain| fails it in either dtype, and passes the sums
    rounded once to the dtype."""
    g = torch.Generator().manual_seed(0)
    terms = torch.randn(64, 256, 64, generator=g, dtype=torch.float64) * 1e-3
    ref = terms.sum(0).float()
    lost = chip_smoke.bwd_errors(terms[1:].sum(0).to(dtype), ref)
    if dtype == torch.bfloat16:
        assert lost["rel_err"] <= chip_smoke.BWD_TOLERANCE[dtype]
    assert lost["scaled_err"] > chip_smoke.BWD_SCALED_TOLERANCE[dtype]
    assert not chip_smoke.bwd_within(lost, dtype)
    sound = chip_smoke.bwd_errors(terms.sum(0).to(dtype), ref)
    assert chip_smoke.bwd_within(sound, dtype)
