import json

import pytest

from benchmark.roofline import cm_components, cm_decode, cm_encode, peaks
from benchmark.roofline import sha1_lanes
from cellrun import ROOT


def test_sha1_counts_by_hand():
    # schedule 64 x 4, rounds 20 x 10 + 40 x 8 + 20 x 11, five additions
    assert sha1_lanes.OPS_PER_BLOCK == 256 + 740 + 5
    # padding: a 0x80 byte and a 64-bit length after the message
    assert [sha1_lanes.blocks(n) for n in (0, 55, 56, 64, 119, 120)] == \
        [1, 1, 2, 2, 2, 3]
    ops, nbytes = sha1_lanes.work([{"lengths": [0, 64]}, {"lengths": [56]}],
                                  {})
    assert ops == 1001 * (1 + 2 + 2)
    assert nbytes == (0 + 64 + 56) + 3 * 20


def test_cm_counts_by_hand():
    assert cm_components.ops_per_bit([]) == 12          # coder + bookkeeping
    assert cm_components.ops_per_bit([[1, 0]]) == 12     # CONST
    assert cm_components.ops_per_bit([[2, 20, 0]]) == 27  # CM 5 + 10
    # ICM, then a MIX of 1 input: 8 + 2 and 4 + 4
    assert cm_components.ops_per_bit([[3, 16], [7, 8, 0, 1, 24, 255]]) == \
        12 + 18 + 18
    level4 = json.loads((ROOT / "benchmark" / "configs"
                         / "m4_b1.json").read_text())["components"]
    # ICM, 5 ISSE, MATCH, ICM, ISSE, MIX(9), MIX(10), MIX2, SSE, MIX2
    assert cm_components.ops_per_bit(level4) == 12 + (
        18 + 5 * 28 + 14 + 18 + 28 + (12 + 54) + (12 + 60) + 22 + 28 + 22)
    cfg = {"components": [[2, 20, 0]]}
    launches = [{"in_bytes": [100, 20], "out_bytes": [40, 10]}]
    assert cm_encode.work(launches, cfg) == (8 * 120 * 27, 170)
    assert cm_decode.work(launches, cfg) == (8 * 50 * 27, 170)


def test_bound_is_the_larger_term():
    assert peaks.INT32_OPS_PER_S == pytest.approx(16.727e12, rel=1e-3)
    assert peaks.bound_seconds(peaks.INT32_OPS_PER_S, 0) == 1.0
    assert peaks.bound_seconds(1.0, peaks.HBM_BYTES_PER_S * 2) == 2.0
