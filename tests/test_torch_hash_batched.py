"""The port's batched-hash lane API (``ops/hash_batched.py``) against the
reference's (JAX on the CPU), ``hashlib`` and ``native.crc32``: SHA-1,
SHA-256 and CRC-32 of seeded lanes, bit for bit, on the CPU (the plain
versions). The CUDA kernel of ``crc32_lanes`` is held against its plain
version on the card in ``tests/test_torch_card.py``."""

import hashlib

import numpy as np
import pytest
import torch

from zpaqfranz_tpu import native as ref_native
from zpaqfranz_tpu.ops import hash_batched as ref_hb

from zpaqfranz_tpu_torch import native
from zpaqfranz_tpu_torch.ops import hash_batched as hb

LENGTHS = (0, 1, 15, 16, 63, 64, 65, 3000, 4096)


def _lanes():
    rng = np.random.default_rng(23)
    return [rng.integers(0, 256, n, dtype=np.uint8).tobytes()
            for n in LENGTHS] + [b"abc", bytes(range(256))]


def test_pad_lanes_is_the_reference_layout():
    chunks = _lanes()
    got, want = hb.pad_lanes(chunks), ref_hb.pad_lanes(chunks)
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1],
                                                               want[1])
    assert got[0].dtype == np.uint8 and got[1].dtype == np.int32


@pytest.mark.parametrize("algo,ref", [("sha1", hashlib.sha1),
                                      ("sha256", hashlib.sha256)])
def test_sha_lanes_match_reference_and_hashlib(algo, ref):
    chunks = _lanes()
    data, lens = hb.pad_lanes(chunks)
    got = getattr(hb, f"{algo}_lanes")(data, lens, device="cpu")
    want = getattr(ref_hb, f"{algo}_lanes")(data, lens)
    assert got.device.type == "cpu" and got.dtype == torch.uint32
    assert np.array_equal(got.view(torch.int32).numpy().view(np.uint32),
                          np.asarray(want))
    assert hb.digest_bytes(got) == [ref(c).digest() for c in chunks]
    assert hb.digest_bytes(np.asarray(want)) == ref_hb.digest_bytes(want)


def test_crc32_lanes_match_reference_and_native():
    chunks = _lanes()
    data, lens = hb.pad_lanes(chunks)
    before = hb.launches
    got = hb.crc32_lanes(torch.from_numpy(data), torch.from_numpy(lens),
                         device="cpu")
    assert hb.launches == before          # the plain version on the CPU
    want = np.asarray(ref_hb.crc32_lanes(data, lens))
    crcs = got.view(torch.int32).numpy().view(np.uint32)
    assert np.array_equal(crcs, want)
    assert [int(c) for c in crcs] == [native.crc32(c) for c in chunks]
    assert [native.crc32(c) for c in chunks] == [ref_native.crc32(c)
                                                 for c in chunks]


def test_crc32_plain_on_the_flat_layout():
    """Lanes at any offset of one buffer, overlapping, and none at all."""
    rng = np.random.default_rng(5)
    buf = rng.integers(0, 256, 700, dtype=np.uint8).tobytes()
    spans = [(o, n) for o in (0, 1, 7, 15, 16, 33) for n in (0, 1, 16, 17,
                                                           300)]
    data = torch.frombuffer(bytearray(buf), dtype=torch.uint8)
    off = torch.tensor([o for o, _ in spans], dtype=torch.int64)
    length = torch.tensor([n for _, n in spans], dtype=torch.int64)
    got = hb.crc32_flat(data, off, length).view(torch.int32).numpy()
    assert [int(c) for c in got.view(np.uint32)] == [
        native.crc32(buf[o:o + n]) for o, n in spans]
    empty = torch.zeros(0, dtype=torch.int64)
    assert hb.crc32_flat(data, empty, empty).shape == (0,)


def test_lanes_are_independent():
    rng = np.random.default_rng(9)
    a = rng.integers(0, 256, 200, dtype=np.uint8).tobytes()
    other = rng.integers(0, 256, 500, dtype=np.uint8).tobytes()
    data, lens = hb.pad_lanes([a, other, a])
    d = hb.digest_bytes(hb.sha1_lanes(data, lens, device="cpu"))
    assert d[0] == d[2] == hashlib.sha1(a).digest()
    c = hb.crc32_lanes(data, lens, device="cpu").view(torch.int32)
    assert int(c[0]) == int(c[2]) and int(c[0]) & 0xFFFFFFFF == \
        native.crc32(a)


def test_lengths_outside_the_rows_raise():
    data, lens = hb.pad_lanes([b"abc"])
    with pytest.raises(ValueError):
        hb.crc32_lanes(data, lens + data.shape[1], device="cpu")
    with pytest.raises(TypeError):
        hb.sha1_lanes(data.astype(np.int32), lens, device="cpu")
