"""The hash lane kernels' launch plan and host staging on the CPU
(``ops/sha1.py``: ``plan``, ``stage_bytes``, ``pack_messages``). The CUDA
kernels themselves are held against hashlib in tests/test_torch_card.py."""

import hashlib

import numpy as np
import pytest
import torch

from zpaqfranz_tpu_torch.ops import sha1, sha256

@pytest.mark.parametrize("n,blocks", [(1, 1), (31, 1), (32, 1), (33, 2),
                                      (4096, 128), (16384, 512),
                                      (160_000, 5000)])
def test_plan_gives_one_block_per_32_lanes(n, blocks):
    # the smoke's 4096 lanes: 128 blocks, one per SM of the H100 (blocks
    # of 128 threads, one message each, used 32)
    order, got = sha1.plan(torch.arange(n, dtype=torch.int64))
    assert got == blocks
    assert order.tolist() == list(range(n - 1, -1, -1))


def test_plan_orders_lanes_longest_first():
    length = torch.tensor([5, 0, 700, 5, 64, 0, 700, 1], dtype=torch.int64)
    order, blocks = sha1.plan(length)
    # longest first; equal lengths (lanes of 0 bytes too) in lane order
    assert order.tolist() == [2, 6, 4, 0, 3, 7, 1, 5]
    assert blocks == 1


def _chunks():
    rng = np.random.default_rng(12)
    return [b"", b"abc", bytearray(b"x" * 64), memoryview(b"y" * 65),
            rng.integers(0, 256, 1000, dtype=np.uint8).tobytes(), b"",
            rng.integers(0, 256, 17, dtype=np.uint8)]


def test_stage_bytes_concatenates_any_bytes_like():
    chunks = _chunks()
    flat = sha1.stage_bytes(chunks, "cpu")
    assert flat.dtype == torch.uint8 and flat.dim() == 1
    assert flat.numpy().tobytes() == b"".join(bytes(c) for c in chunks)
    assert sha1.stage_bytes([], "cpu").numel() == 0


@pytest.mark.parametrize("lanes,algo", [(sha1.sha1_lanes, "sha1"),
                                        (sha256.sha256_lanes, "sha256")])
def test_pack_messages_gives_the_joined_bytes_and_digests(lanes, algo):
    msgs = [bytes(c) for c in _chunks()]
    data, off, length = sha1.pack_messages(msgs, "cpu")
    assert data.numpy().tobytes() == b"".join(msgs)
    assert length.tolist() == [len(m) for m in msgs]
    assert off.tolist() == [sum(map(len, msgs[:i])) for i in range(len(msgs))]
    assert sha1.to_digests(lanes(data, off, length)) == [
        hashlib.new(algo, m).digest() for m in msgs]


def test_profile_needs_the_card():
    data, off, length = sha1.pack_messages([b"abc"], "cpu")
    with pytest.raises(ValueError):
        sha1.sha1_lanes(data, off, length, torch.zeros(
            len(sha1.PROFILE), dtype=torch.int64))
