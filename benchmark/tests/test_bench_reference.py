"""The reference's own ZPAQ decoder (``reference/zpaqd.c``), without the
port: its tables, and blocks written here by hand from the format."""

import struct

import pytest

from benchmark.reference import archive as ref
from benchmark.reference.codec import Decoder
from cellrun import ROOT


@pytest.fixture(scope="module")
def decoder():
    # loading checks squash() and stretch() against libzpaq's checksums
    return Decoder(ROOT / "bench_cache" / "reference")


def test_state_table_counts(decoder):
    ns = decoder.states()
    counts = [(ns[4 * s + 2], ns[4 * s + 3]) for s in range(256)]
    assert counts[0] == (0, 0)
    assert counts[ns[0]] == (1, 0) and counts[ns[1]] == (0, 1)
    # the count rules give 255 states; state 255 is never entered
    assert max(ns[:255 * 4:4] + ns[1:255 * 4:4]) == 254
    for s in range(255):
        # the next state has seen the bit it was entered on
        assert counts[ns[4 * s]][0] >= 1 and counts[ns[4 * s + 1]][1] >= 1


def block(header: bytes, data: bytes) -> bytes:
    """One block, one segment, its data already coded."""
    return (ref.TAG + b"zPQ\x02\x01" + struct.pack("<H", len(header))
            + header + b"\x01name\x00\x00\x00" + data + b"\x00" * 4
            + b"\xfe\xff")


def stored(payload: bytes) -> bytes:
    return struct.pack(">I", len(payload)) + payload


def test_store_block_passes_its_bytes(decoder):
    header = bytes.fromhex("00000000000000")      # no model, no PCOMP
    payload = b"\x00" + bytes(range(256)) * 3       # 0: no postprocessor
    assert decoder.block(block(header, stored(payload)), 0) == payload[1:]


def test_pcomp_runs_in_the_interpreter(decoder):
    # PCOMP "a+=1 out halt" (opcodes 135 1, 57, 56): every byte plus one,
    # and at the segment's end a run with A = 2^32 - 1, which outputs 0
    pcomp = bytes([135, 1, 57, 56])
    payload = b"\x01" + struct.pack("<H", len(pcomp)) + pcomp + b"abcxyz"
    header = bytes.fromhex("00000000000000")
    assert decoder.block(block(header, stored(payload)), 0) == b"bcdyz{\x00"


def test_damaged_block_raises(decoder):
    header = bytes.fromhex("00000000000000")
    good = block(header, stored(b"\x00hello"))
    with pytest.raises(ValueError):
        decoder.block(good[:-3], 0)
    with pytest.raises(ValueError):
        decoder.block(b"\x00" + good[1:], 0)
