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
