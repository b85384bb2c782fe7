"""Batched hashes over padded lanes: SHA-1, SHA-256 and CRC-32.

The reference package's lane API (``zpaqfranz_tpu/ops/hash_batched.py``):
``data`` is an (L, N) ``uint8`` array of L byte strings, each padded with
zeros to N bytes (``pad_lanes``), ``lengths`` the (L,) true byte counts.
The padded rows are already the flat layout of ``ops/sha1.py``: lane i is
``data[i * N : i * N + lengths[i]]`` of the rows laid end to end, so
``flat_lanes`` repacks them without a copy.

``sha1_lanes`` and ``sha256_lanes`` launch the SHA lane kernels of
``ops/sha1.py`` and ``ops/sha256.py``. ``crc32_lanes`` launches the CUDA
kernel ``csrc/crc32_lanes.cu`` (one thread a lane, a 256-entry table in
shared memory, the lane's bytes read as aligned 16-byte pieces), which
replaces the reference's jnp ``crc32_lanes`` (a ``lax.scan`` over the byte
columns with a 16-entry nibble table). ``crc32_plain`` is that scan's
per-byte step as torch ops over all lanes at once: the kernel's plain
version, which ``crc32_flat`` takes only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises. It is not the card's path: it
would be a few launches per byte.

The three functions run on the card unless the caller passes
``device="cpu"``, and return torch tensors on that device: (L, 5) and
(L, 8) ``uint32`` digest words, (L,) ``uint32`` CRCs.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve
from . import build, sha1, sha256
from .sha1 import check_lanes

__all__ = ["pad_lanes", "flat_lanes", "sha1_lanes", "sha256_lanes",
           "crc32_lanes", "crc32_flat", "crc32_plain", "digest_bytes",
           "launches"]

#: kernel launches made by ``crc32_flat`` in this process
launches = 0

_M32 = 0xFFFFFFFF


def _crc32_nibble_table() -> List[int]:
    tab = []
    for i in range(16):
        c = i
        for _ in range(4):
            c = (c >> 1) ^ (0xEDB88320 if c & 1 else 0)
        tab.append(c)
    return tab


_CRC_TAB = _crc32_nibble_table()


def pad_lanes(chunks: Sequence[bytes], block: int = 64
              ) -> Tuple[np.ndarray, np.ndarray]:
    """Pack byte strings into (L, N) uint8 + (L,) int32 lengths, N the
    longest length rounded up to ``block`` plus one more block (the
    reference's layout, with room for a hash's padding)."""
    maxlen = max((len(c) for c in chunks), default=0)
    n = ((maxlen + 8) // block + 1) * block
    out = np.zeros((len(chunks), n), np.uint8)
    lens = np.zeros((len(chunks),), np.int32)
    for i, c in enumerate(chunks):
        out[i, :len(c)] = np.frombuffer(bytes(c), np.uint8)
        lens[i] = len(c)
    return out, lens


def flat_lanes(data, lengths, device=None) -> Tuple[
        torch.Tensor, torch.Tensor, torch.Tensor]:
    """(L, N) uint8 rows + (L,) lengths (numpy or torch) -> the flat
    ``(data, off, length)`` tensors of ``ops/sha1.py`` on ``device`` (None:
    the card): the rows end to end, lane i at offset i * N."""
    dev = resolve(device)
    rows = torch.as_tensor(data)
    if rows.dtype != torch.uint8 or rows.dim() != 2:
        raise TypeError("data must be an (L, N) uint8 array")
    length = torch.as_tensor(lengths).to(dev, torch.int64)
    L, n = rows.shape
    if length.shape != (L,):
        raise ValueError(f"lengths must have shape ({L},)")
    if L and not bool(((length >= 0) & (length <= n)).all()):
        raise ValueError(f"a length is outside 0..{n}")
    off = torch.arange(L, dtype=torch.int64, device=dev) * n
    return rows.to(dev).contiguous().view(-1), off, length


def sha1_lanes(data, lengths, device=None) -> torch.Tensor:
    """(L, N) u8 + (L,) lengths -> (L, 5) uint32 big-endian digest words."""
    return sha1.sha1_lanes(*flat_lanes(data, lengths, device))


def sha256_lanes(data, lengths, device=None) -> torch.Tensor:
    """(L, N) u8 + (L,) lengths -> (L, 8) uint32 digest words."""
    return sha256.sha256_lanes(*flat_lanes(data, lengths, device))


def crc32_lanes(data, lengths, device=None) -> torch.Tensor:
    """(L, N) u8 + (L,) lengths -> (L,) uint32 CRC-32 (IEEE, reflected)."""
    return crc32_flat(*flat_lanes(data, lengths, device))


def crc32_plain(data: torch.Tensor, off: torch.Tensor, length: torch.Tensor
                ) -> torch.Tensor:
    """Plain PyTorch CRC-32 of every lane ``data[off[i]:off[i] +
    length[i]]``: the reference's per-byte step (two nibble-table steps) as
    torch ops over all lanes, in int64 masked to 32 bits. (N,) uint32."""
    check_lanes(data, off, length)
    dev = data.device
    crc = torch.full(off.shape, _M32, dtype=torch.int64, device=dev)
    tab = torch.tensor(_CRC_TAB, dtype=torch.int64, device=dev)
    last = max(data.numel() - 1, 0)
    for j in range(int(length.max()) if off.numel() else 0):
        byte = data[(off + j).clamp(max=last)].long()
        c = crc ^ byte
        c = (c >> 4) ^ tab[c & 15]
        c = (c >> 4) ^ tab[c & 15]
        crc = torch.where(j < length, c, crc)
    return (crc ^ _M32).to(torch.uint32)


def crc32_flat(data: torch.Tensor, off: torch.Tensor, length: torch.Tensor
               ) -> torch.Tensor:
    """CRC-32 (N,) uint32 of ``data[off[i]:off[i] + length[i]]`` (the flat
    layout of ``ops/sha1.py``): the kernel on the card, ``crc32_plain`` on
    the CPU. No launch for N = 0."""
    global launches
    check_lanes(data, off, length)
    if data.device.type == "cpu":
        return crc32_plain(data, off, length)
    if data.device.type != "cuda":
        raise ValueError(f"no crc32_lanes kernel for device {data.device}")
    n = off.shape[0]
    out = torch.empty(n, dtype=torch.uint32, device=data.device)
    if n == 0:
        return out
    if data.untyped_storage().data_ptr() % 16:
        raise ValueError("data's storage is not 16-byte aligned")
    # one host sync: the least of the lanes' start, length and headroom
    slack = torch.stack([off.min(), length.min(),
                         data.numel() - (off + length).max()]).min()
    if int(slack) < 0:
        raise ValueError("a lane reaches outside data")
    build.call("crc32_lanes", "crc32_lanes_launch", data.device, data, off,
               length, out, n, data.numel())
    launches += 1
    return out


def digest_bytes(words) -> List[bytes]:
    """(L, W) uint32 big-endian words (torch or numpy) -> byte digests."""
    if isinstance(words, torch.Tensor):
        return sha1.to_digests(words)
    return [np.asarray(row, np.uint32).astype(">u4").tobytes()
            for row in np.asarray(words)]
