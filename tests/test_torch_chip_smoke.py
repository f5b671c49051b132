"""The work ``chip_smoke.py`` counts for its bound: only the keys a query
keeps need their K and V rows and their scores; a query with no key kept
needs all of V (it returns V's mean) and no K. Counts are exact
integers, checked against sums written out by hand."""

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
    assert chip_smoke.SOURCES == ["brgemm", "conv_kxk", "flash_bwd",
                                  "flash_fwd", "fused_update", "pool_fused",
                                  "seqpool"]


def test_permuted_keys_is_the_same_attention():
    """T2's reordered route: the trainable flash op fed the keys in another
    order gives the same output and the same dq, dk and dv, up to float32
    rounding."""
    from paddle_tpu_torch.kernels import attention as A
    g = torch.Generator().manual_seed(0)
    q, k, v, do = (torch.randn(2, 2, t, 8, generator=g)
                   for t in (5, 7, 7, 5))
    mask = _mask([7, 4], 7)
    op, runs = A.flash_attn_op, []
    for reorder in (False, True):
        qkv = [t.clone().requires_grad_() for t in (q, k, v)]
        route = chip_smoke.permuted_keys(seed=3) if reorder else \
            chip_smoke.contextlib.nullcontext()
        with route:
            o = A.flash_attention(*qkv, kv_mask=mask, device="cpu")
        runs.append((o, *torch.autograd.grad((o * do).sum(), qkv)))
    assert A.flash_attn_op is op
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
    assert set(chip_smoke.KERNELS) >= {"pool_fwd", "pool_bwd", "seqpool"}
    assert len(chip_smoke.KERNELS) == 11


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
