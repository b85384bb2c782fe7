"""The CRC-32 lane kernel's segment plan and GF(2) combine
(``ops/hash_batched.py``: ``crc32_plan``, ``crc32_shift``,
``crc32_combine``, ``crc32_segmented``), in plain torch ops on the CPU at
small segments, against ``zlib.crc32``, ``native.crc32`` and the
reference's ``crc32_lanes`` (JAX on the CPU), bit for bit: CRCs are bits,
so every comparison is exact. The kernel itself is held against
``crc32_plain`` on the card in ``tests/test_torch_card.py``."""

import pathlib
import re
import zlib

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from zpaqfranz_tpu.ops import hash_batched as ref_hb

from zpaqfranz_tpu_torch import native
from zpaqfranz_tpu_torch.ops import hash_batched as hb

M32 = 0xFFFFFFFF
CU = (pathlib.Path(hb.__file__).resolve().parent.parent / "csrc"
      / "crc32_lanes.cu")


def _words(t: torch.Tensor) -> list:
    return [int(c) & M32 for c in t.view(torch.int32).tolist()]


def _edge_spans(seg: int, size: int) -> list:
    """Every offset 0..15 at the segment's edge lengths, and lanes that end
    on the buffer's last byte."""
    spans = [(o, n) for o in range(16)
             for n in (seg - 1, seg, seg + 1, 2 * seg + 15, 0, 1)]
    return spans + [(size - n, n) for n in (1, 15, seg - 1, seg, seg + 1,
                                            2 * seg + 15, size)]


@pytest.mark.parametrize("seg,base", [(64, 0), (64, 5), (64, 63),
                                      (128, 17)])
def test_segmented_matches_zlib_native_and_reference(seg, base):
    rng = np.random.default_rng(seg + base)
    buf = rng.integers(0, 256, 3 * seg + 40, dtype=np.uint8)
    host = buf.tobytes()
    spans = _edge_spans(seg, buf.size)
    data = torch.from_numpy(buf)
    off = torch.tensor([o for o, _ in spans], dtype=torch.int64)
    length = torch.tensor([n for _, n in spans], dtype=torch.int64)
    got = _words(hb.crc32_segmented(data, off, length, seg, base))
    chunks = [host[o:o + n] for o, n in spans]
    assert got == [zlib.crc32(c) for c in chunks]
    assert got == [native.crc32(c) for c in chunks]
    rows, lens = ref_hb.pad_lanes(chunks)
    assert got == [int(c) for c in np.asarray(ref_hb.crc32_lanes(rows,
                                                                 lens))]
    assert got == _words(hb.crc32_plain(data, off, length))


@pytest.mark.parametrize("seg", [64, 256])
def test_segmented_matches_plain_on_random_lanes(seg):
    rng = np.random.default_rng(seg)
    data = torch.from_numpy(rng.integers(0, 256, 5000, dtype=np.uint8))
    length = torch.from_numpy(rng.integers(0, 900, 60))
    off = torch.from_numpy(rng.integers(0, 4100, 60))
    for base in (0, 9):
        assert torch.equal(hb.crc32_segmented(data, off, length, seg, base),
                           hb.crc32_plain(data, off, length))


@pytest.mark.parametrize("base", [0, 3, 16])
def test_plan_cuts_lanes_at_multiples_of_the_segment(base):
    seg = 64
    off = torch.tensor([0, 1, 15, 63, 64, 100, 7, 200], dtype=torch.int64)
    length = torch.tensor([64, 63, 130, 1, 0, 300, 0, 129],
                          dtype=torch.int64)
    nseg, first = hb.crc32_plan(off, length, seg, base)
    want = []
    for o, n in zip(off.tolist(), length.tolist()):
        lo, hi = base + o, base + o + n
        cuts = sorted({lo, hi} | set(range((lo // seg + 1) * seg, hi, seg)))
        segs = list(zip(cuts, cuts[1:])) if n else []
        # every segment within one block of seg bytes; all but the first
        # start on a multiple of seg, all but the last end on one
        assert all(a // seg == (b - 1) // seg for a, b in segs)
        assert all(a % seg == 0 for a, _ in segs[1:])
        assert all(b % seg == 0 for _, b in segs[:-1])
        want.append(len(segs))
    assert nseg.tolist() == want
    assert first.tolist() == [sum(want[:i]) for i in range(len(want))]


def test_shift_is_the_register_after_zero_bytes():
    rng = np.random.default_rng(3)
    regs = [int(x) for x in rng.integers(0, 1 << 32, 12)]
    ns = [0, 1, 2, 3, 15, 16, 64, 1000, 4096, 65537, 1 << 20, 5 << 30]
    got = hb.crc32_shift(torch.tensor(regs), torch.tensor(ns)).tolist()
    # zlib.crc32(zeros, v) runs the register ~v over the zeros
    want = [~zlib.crc32(bytes(n), ~r & M32) & M32 for r, n in zip(regs, ns)]
    assert got == want


@settings(max_examples=150, deadline=None)
@given(st.binary(max_size=300), st.binary(max_size=300))
def test_combine_of_two_crcs_is_the_crc_of_both(a, b):
    got = int(hb.crc32_combine(zlib.crc32(a), zlib.crc32(b), len(b)))
    assert got == zlib.crc32(a + b) == native.crc32(a + b)


def test_kernel_x2n_table_is_the_polynomial_powers():
    """``X2N`` in ``csrc/crc32_lanes.cu`` is x^(2^k) mod P, k = 0..31."""
    body = re.search(r"X2N\[32\] = \{(.*?)\};", CU.read_text(), re.S)
    words = [int(w, 16) for w in re.findall(r"0x([0-9A-F]{8})u",
                                            body.group(1))]
    assert words == hb.X2N and len(words) == 32
    # x^(2^k) squared is x^(2^(k + 1)); x^(2^32) = x
    assert words[0] == 1 << 30                  # x, reflected
    for k in range(32):
        assert hb._multmodp(words[k], words[k]) == words[(k + 1) % 32]


def test_kernel_row_is_the_wrappers():
    """``CRC_ROW`` is a warp's row in ``csrc/crc32_lanes.cu``: 32 threads x
    2^LG_RUN pieces of 16 bytes."""
    lg = int(re.search(r"constexpr int LG_RUN = (\d+);", CU.read_text())
             .group(1))
    assert hb.CRC_ROW == 32 * 16 << lg


def test_group_threads_fold_at_most_16_segments():
    assert [hb.crc32_group(m) for m in (0, 1, 16, 17, 33, 256, 511, 512,
                                        513, 16384)] == [
        1, 1, 1, 2, 4, 16, 32, 32, 32, 32]


def test_crc_launch_takes_only_the_card():
    data = torch.zeros(100, dtype=torch.uint8)
    off = torch.zeros(2, dtype=torch.int64)
    length = torch.tensor([10, 90], dtype=torch.int64)
    with pytest.raises(ValueError):
        hb.CrcLaunch(data, off, length)
    before = hb.launches
    assert _words(hb.crc32_flat(data, off, length)) == [
        zlib.crc32(bytes(10)), zlib.crc32(bytes(90))]
    assert hb.launches == before            # the plain version on the CPU
