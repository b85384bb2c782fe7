"""The port's SHA-256 lane function against hashlib and the reference Pallas
kernel's block function. As tests/test_hash_pallas.py does, the reference
runs ``_sha256_block`` over ``pack_lanes`` driven by jnp, not through an
interpret-mode ``pallas_call``: the 64-round body under interpret mode sends
XLA's CPU compiler into a compile that grows past 20 GB. On the CPU the
wrapper runs the plain PyTorch version; the CUDA kernel is held against it
in tests/test_torch_card.py."""

import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zpaqfranz_tpu.ops import hash_pallas as hp

from zpaqfranz_tpu_torch.ops import sha1, sha256

# the padding's edge lengths: empty, one block with and without room for
# the length field, and the same around the second block
CASES = [b"", b"abc", b"a" * 55, b"a" * 56, b"a" * 63, b"a" * 64,
         b"x" * 119, b"x" * 120, b"y" * 128, bytes(range(256)) * 2]


def _random_chunks(n=24, top=300):
    rng = np.random.default_rng(9)
    return [rng.integers(0, 256, int(k), dtype=np.uint8).tobytes()
            for k in rng.integers(0, top, n)]


def _reference_kernel(chunks):
    """Digests from the reference kernel's block function over its lane
    tiles (tests/test_hash_pallas.py::test_sha256_matches_hashlib)."""
    data, nblk = hp.pack_lanes(chunks)
    nb = data.shape[1] // 64
    w = data.astype(np.uint32).reshape(-1, nb, 16, 4)
    w = (w[..., 0] << 24) | (w[..., 1] << 16) | (w[..., 2] << 8) | w[..., 3]
    w = w.reshape(1, 8, 128, nb, 16).transpose(0, 3, 4, 1, 2)
    h = tuple(jnp.full((8, 128), hp._SHA256_IV[i], jnp.uint32)
              for i in range(8))
    for b in range(nb):
        hn = hp._sha256_block(h, [jnp.asarray(w[0, b, t])
                                  for t in range(16)])
        live = jnp.asarray(nblk[0] > b)
        h = tuple(jnp.where(live, n, o) for n, o in zip(hn, h))
    flat = np.stack([np.asarray(x) for x in h]).transpose(1, 2, 0).reshape(
        -1, 8)
    return [flat[i].astype(">u4").tobytes() for i in range(len(chunks))]


def test_plain_matches_hashlib_and_reference_kernel():
    chunks = CASES + _random_chunks()
    want = [hashlib.sha256(c).digest() for c in chunks]
    before = sha256.launches
    assert sha1.to_digests(sha256.sha256_lanes(
        *sha1.pack_messages(chunks, "cpu"))) == want
    assert sha256.launches == before      # the CPU ran the plain version
    assert _reference_kernel(chunks) == want


def test_lanes_at_unaligned_offsets_and_in_any_order():
    # lanes are spans of one buffer: odd offsets, overlaps, reversed order
    rng = np.random.default_rng(4)
    buf = rng.integers(0, 256, 700, dtype=np.uint8).tobytes()
    spans = [(1, 0), (3, 55), (0, 700), (5, 64), (130, 120), (1, 57),
             (7, 119), (2, 56)]
    data = torch.from_numpy(np.frombuffer(buf, np.uint8).copy())
    off = torch.tensor([o for o, _ in spans], dtype=torch.int64)
    ln = torch.tensor([n for _, n in spans], dtype=torch.int64)
    got = sha1.to_digests(sha256.sha256_lanes(data, off, ln))
    assert got == [hashlib.sha256(buf[o:o + n]).digest() for o, n in spans]


def test_wrapper_rejects_bad_inputs():
    data = torch.zeros(8, dtype=torch.uint8)
    off = torch.zeros(2, dtype=torch.int64)
    with pytest.raises(TypeError):
        sha256.sha256_lanes(data.long(), off, off)
    with pytest.raises(TypeError):
        sha256.sha256_lanes(data, off.int(), off)
    with pytest.raises(ValueError):
        sha256.sha256_lanes(data, off, off[:1])
    assert sha256.sha256_lanes(data, off[:0], off[:0]).shape == (0, 8)
