"""The table-access microbenchmarks' launch arithmetic on the CPU
(``zpaqfranz_tpu_torch/experiments/mb_access.py`` and ``mb_vmem_probe.py``):
the division-free floor modulo of ``csrc/floor_mod.cuh``, mirrored in numpy
from the wrapper's reciprocal (``mod_plan``) and held against Python's
``%``; the launch plans of kernels A, B, C and P2 (``column_plan``,
``lut_plan``); the kernels' staging loop, which advances rows and units by
increments; and the chase's ring (``chase_ring``, ``chase_end``). The
kernels themselves are held against their plain versions on the card in
``tests/test_torch_card.py``."""

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from zpaqfranz_tpu_torch.experiments import mb_access as mb
from zpaqfranz_tpu_torch.experiments import mb_vmem_probe as mp

INT32_EDGES = np.array([-2**31, -2**31 + 1, -1, 0, 1, 2**31 - 2, 2**31 - 1],
                       np.int64)
# every divisor the scripts take: the tables' S (A, B, C), the LUT (P2) and
# P1's SW - W; and the card tests' sizes: 1, 33, 1000 and the largest S
SCRIPT_DIVISORS = sorted({S for S, _ in mb.A_SHAPES + mb.B_SHAPES
                          + mb.C_SHAPES} | {mp.LUT, mp.SW - mp.W})
EDGE_DIVISORS = [1, 2, 3, 33, 1000, mb.SMEM_MAX // 4, mb.SMEM_MAX,
                 2**31 - 1]


def floor_mod_mirror(x: np.ndarray, p: mb.ModPlan) -> np.ndarray:
    """``floor_mod<POW2>`` of ``csrc/floor_mod.cuh`` in uint64 numpy
    arithmetic on int32 values ``x``: a mask, or the low 31 bits times the
    reciprocal, the sign bit's ``2^31 mod n`` taken off, and ``min(r, r +
    n)`` unsigned."""
    m32 = np.uint64(0xFFFFFFFF)
    ux = x.astype(np.int64).astype(np.uint64) & m32
    if p.pow2:
        return (ux & np.uint64(p.n - 1)).astype(np.int64)
    u = ux & np.uint64(0x7FFFFFFF)
    c = np.where(x < 0, np.uint64(p.k), np.uint64(0))
    q = ((u * np.uint64(p.m)) >> np.uint64(32)) >> np.uint64(p.shift)
    r = (u - c - q * np.uint64(p.n)) & m32
    return np.minimum(r, (r + np.uint64(p.n)) & m32).astype(np.int64)


def _xs(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    near = np.array([q * n + d for q in (-(2**31) // n, -2, -1, 0, 1,
                                         (2**31 - 1) // n)
                     for d in (-1, 0, 1)], np.int64)
    near = near[(near >= -2**31) & (near < 2**31)]
    return np.concatenate([INT32_EDGES, near,
                           rng.integers(-2**31, 2**31, 4000, np.int64)])


@pytest.mark.parametrize("n", SCRIPT_DIVISORS + EDGE_DIVISORS)
def test_floor_mod_mirror_equals_python_modulo(n):
    p = mb.mod_plan(n)
    assert p.pow2 == (n & (n - 1) == 0)
    x = _xs(n, n)
    np.testing.assert_array_equal(floor_mod_mirror(x, p), x % n)


@settings(max_examples=300, deadline=None)
@given(st.integers(1, 2**17),
       st.lists(st.integers(-2**31, 2**31 - 1), min_size=1, max_size=64))
def test_floor_mod_mirror_for_any_divisor(n, values):
    x = np.concatenate([INT32_EDGES, np.array(values, np.int64)])
    np.testing.assert_array_equal(floor_mod_mirror(x, mb.mod_plan(n)),
                                  x % n)


def test_reciprocals_fit_32_bits_and_are_exact_below_2_31():
    """For every divisor up to 2^17 that is not a power of two: m < 2^32,
    a shift of at least 1, and m n - 2^(31 + l) below 2^l, the condition
    under which umulhi(u, m) >> (l - 1) is floor(u / n) for every u <
    2^31."""
    for n in range(3, 2**17 + 1):
        if n & (n - 1) == 0:
            continue
        p = mb.mod_plan(n)
        l = p.shift + 1
        assert 2**31 <= p.m < 2**32 and p.shift >= 1
        assert 0 <= p.m * n - 2**(31 + l) < 2**l
        assert p.k == 2**31 % n


@pytest.mark.parametrize("n", [0, -5, 2**31])
def test_mod_plan_refuses_divisors_outside_int32(n):
    with pytest.raises(ValueError, match="floor modulo"):
        mb.mod_plan(n)


def for_units(S: int, upr: int, nt: int, batch: int) -> list:
    """The ``(row, unit)`` pairs that ``for_units`` of ``csrc/mb_access.cu``
    visits: each thread's ``batch`` cursors start at one divide each, then
    advance by increments, and a round runs while the first is in the
    table."""
    seen = []
    step = batch * nt
    dr, dc = step // upr, step % upr
    for tid in range(nt):
        cur = [divmod(tid + b * nt, upr) for b in range(batch)]
        while cur[0][0] < S:
            seen += [(r, c) for r, c in cur if r < S]
            cur = [(r + dr + (c + dc >= upr), (c + dc) % upr)
                   for r, c in cur]
    return seen


@pytest.mark.parametrize("S", [1, 33, 1000])
@pytest.mark.parametrize("upr,nt", [(1, 32), (3, 128), (16, 128),
                                    (200, 128), (128, 512), (129, 32),
                                    (2000, 512)])
def test_staging_loop_visits_every_unit_once(S, upr, nt):
    seen = for_units(S, upr, nt, 8)
    assert sorted(seen) == [(r, c) for r in range(S) for c in range(upr)]


PLAN_SHAPES = sorted({(S, mb._ESIZE[dt]) for S, dt in mb.A_SHAPES
                      + mb.B_SHAPES + mb.C_SHAPES}
                     | {(S, e) for S in (1, 33, 1000) for e in (1, 4)}
                     | {(mb.SMEM_MAX, 1), (mb.SMEM_MAX // 4, 4)})


@pytest.mark.parametrize("kind", ["gather", "onehot", "selwrite"])
@pytest.mark.parametrize("S,esize", PLAN_SHAPES)
def test_column_plans_fit_and_cover_every_lane_and_row(kind, S, esize):
    for n in (1, 3, 37, mb.L, 130, 1000):
        p = mb.column_plan(kind, S, esize, n)
        assert p.lanes >= 1 and p.blocks * p.lanes >= n
        assert (p.blocks - 1) * p.lanes < n
        assert p.threads % 32 == 0 and p.threads <= 1024
        assert p.smem <= mb.SMEM_MAX
        if kind == "gather":
            assert p.threads == mb.GATHER_THREADS >= p.lanes
            assert p.smem == S * p.lanes * esize
            assert p.pitch == p.lanes * esize
            # a block's row segment is one 16-byte load unless the lanes
            # were cut by the lane count or by shared memory
            assert (p.pitch % mb.VEC_BYTES == 0 or p.lanes == n
                    or (p.lanes + 1) * S * esize > mb.SMEM_MAX)
        else:
            assert p.threads == 32 * p.lanes
            assert p.lanes <= mb.WARP_LANES
            assert p.pitch >= S * esize and p.pitch % 16 == 0
            assert p.smem == p.lanes * p.pitch
            # a warp's threads j take words k0 + 32 u + j, u < 8, for k0
            # in steps of 256: every word of the column once
            words = -(-(S * esize) // 4)
            owned = sorted(k for k0 in range(0, words, 256) for u in range(8)
                           for j in range(32) if (k := k0 + 32 * u + j)
                           < words)
            assert owned == list(range(words))


def test_column_plans_at_the_scripts_shapes():
    """L = 128: A stages 16-byte row segments over 8 blocks (u8) or 32
    (int32); B and C run 4 lanes a block, one warp each, over 32 blocks."""
    assert mb.column_plan("gather", 256, 1, mb.L) == (16, 512, 8, 4096, 16)
    assert mb.column_plan("gather", 8192, 4, mb.L) == (4, 512, 32,
                                                        131072, 16)
    assert mb.column_plan("onehot", 2048, 1, mb.L) == (4, 128, 32, 8192,
                                                        2048)
    assert mb.column_plan("selwrite", 8192, 1, mb.L) == (4, 128, 32,
                                                          32768, 8192)
    assert mb.column_plan("selwrite", 1, 4, 1) == (1, 32, 1, 16, 16)


@pytest.mark.parametrize("n", [1, 3, 128, 132, 133, 200, 20000])
@pytest.mark.parametrize("width", [0, 16, 64, mb.SMEM_MAX // 128 // 16 * 16])
def test_spread_plans_cover_every_lane_and_fit(n, width):
    """D (width 0) and E on a card of 132 SMs: ceil(n / 132) lanes a block,
    at most SPREAD_LANES, in whole warps; E's mbarriers and rows fit."""
    lanes, threads, blocks, smem = mb.spread_plan(n, 132, width)
    assert lanes == min(mb.SPREAD_LANES, -(-n // 132))
    assert blocks * lanes >= n > (blocks - 1) * lanes
    assert threads % 32 == 0 and lanes <= threads <= 1024
    if width:
        assert smem == -(-(8 * lanes) // 16) * 16 + lanes * width
        assert smem <= mb.SMEM_MAX
    else:
        assert smem == 0
    assert mb.spread_plan(mb.L, 132)[:3] == (1, 32, 128)


@pytest.mark.parametrize("n", [1, 33, 1000, mp.LUT, mb.SMEM_MAX // 4])
@pytest.mark.parametrize("lanes", [1, 64, 200])
def test_lut_plan_covers_every_lane_and_the_lut(n, lanes):
    threads, blocks, smem = mp.lut_plan(n, lanes)
    assert threads == mp.LUT_THREADS
    assert blocks * threads >= lanes > (blocks - 1) * threads
    assert 4 * n <= smem <= mb.SMEM_MAX and smem % 16 == 0


@pytest.mark.parametrize("slots", [1, 2, 7, 4096])
def test_chase_ring_is_one_cycle(slots):
    order, nxt = mp.chase_ring(slots, 3, "cpu")
    assert sorted(order.tolist()) == list(range(slots))
    at, walk = 0, []
    for _ in range(slots):
        walk.append(at)
        at = int(nxt[at])
    assert at == 0 and sorted(walk) == list(range(slots))
    for steps in (0, 1, slots - 1, slots, 3 * slots + 2):
        at = 0
        for _ in range(steps):
            at = int(nxt[at])
        assert mp.chase_end(order, steps) == at


def test_chase_rw_steps_split_over_its_words():
    """The "l2_rw" chase gives each of its words an equal share of both
    timed launches' steps, and its words lie in L2-sized memory."""
    words, apart, steps = mp.CHASE_RW
    assert steps % words == 0 and apart % 8 == 0 and apart >= 128
    assert words * apart <= mp.CHASE["l2"][0]


def test_chase_times_only_the_card():
    with pytest.raises(ValueError, match="times the card"):
        mp.chase_ns("shared", "cpu")
