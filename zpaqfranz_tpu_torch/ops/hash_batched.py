"""Batched hashes over padded lanes: SHA-1, SHA-256 and CRC-32.

The reference package's lane API (``zpaqfranz_tpu/ops/hash_batched.py``):
``data`` is an (L, N) ``uint8`` array of L byte strings, each padded with
zeros to N bytes (``pad_lanes``), ``lengths`` the (L,) true byte counts.
The padded rows are already the flat layout of ``ops/sha1.py``: lane i is
``data[i * N : i * N + lengths[i]]`` of the rows laid end to end, so
``flat_lanes`` repacks them without a copy.

``sha1_lanes`` and ``sha256_lanes`` launch the SHA lane kernels of
``ops/sha1.py`` and ``ops/sha256.py``. ``crc32_lanes`` launches the CUDA
kernel ``csrc/crc32_lanes.cu``, which replaces the reference's jnp
``crc32_lanes`` (a ``lax.scan`` over the byte columns with a 16-entry
nibble table): every lane cut into segments of ``CRC_SEG`` bytes at most
(``crc32_plan``, torch ops on the card), one warp a segment, and the
segments' CRCs combined per lane in GF(2) (``crc32_shift``, zlib's
``crc32_combine``). ``crc32_plain`` is the reference scan's per-byte step
as torch ops over all lanes at once: the kernel's plain version, which
``crc32_flat`` takes only for tensors on the CPU; for CUDA tensors it
launches the kernel or raises. It is not the card's path: it would be a
few launches per byte. ``crc32_segmented`` is the kernel's segments and
combine in plain torch ops, the CPU's check of the plan and the combine.

The three functions run on the card unless the caller passes
``device="cpu"``, and return torch tensors on that device: (L, 5) and
(L, 8) ``uint32`` digest words, (L,) ``uint32`` CRCs.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve
from . import build, sha1, sha256
from .sha1 import check_lanes

__all__ = ["pad_lanes", "flat_lanes", "sha1_lanes", "sha256_lanes",
           "crc32_lanes", "crc32_flat", "crc32_plain", "crc32_plan",
           "crc32_group", "crc32_shift", "crc32_combine", "crc32_segmented",
           "CrcLaunch", "CRC_SEG", "CRC_ROW", "CRC_PROFILE", "digest_bytes",
           "launches"]

#: CRC-32 kernel launches made by ``CrcLaunch.run`` in this process
launches = 0

_M32 = 0xFFFFFFFF
_POLY = 0xEDB88320
#: bytes a segment of the CRC-32 lane kernel covers at most (a power of
#: two; chip_smoke.py times the kernel at several on the card)
CRC_SEG = 8192
#: bytes of a row, the aligned 16-byte pieces one warp of the kernel folds
#: at once (``ROW`` in ``csrc/crc32_lanes.cu``)
CRC_ROW = 1024


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


def _crc_register(data: torch.Tensor, off: torch.Tensor,
                  length: torch.Tensor, init: torch.Tensor) -> torch.Tensor:
    """The CRC register (int64 < 2^32) of every lane after its bytes
    ``data[off[i]:off[i] + length[i]]`` from ``init``: the reference's
    per-byte step (two nibble-table steps) as torch ops over all lanes."""
    dev = data.device
    crc = init.clone()
    tab = torch.tensor(_CRC_TAB, dtype=torch.int64, device=dev)
    last = max(data.numel() - 1, 0)
    for j in range(int(length.max()) if off.numel() else 0):
        byte = data[(off + j).clamp(max=last)].long()
        c = crc ^ byte
        c = (c >> 4) ^ tab[c & 15]
        c = (c >> 4) ^ tab[c & 15]
        crc = torch.where(j < length, c, crc)
    return crc


def crc32_plain(data: torch.Tensor, off: torch.Tensor, length: torch.Tensor
                ) -> torch.Tensor:
    """Plain PyTorch CRC-32 of every lane ``data[off[i]:off[i] +
    length[i]]``: the reference's per-byte step (two nibble-table steps) as
    torch ops over all lanes, in int64 masked to 32 bits. (N,) uint32."""
    check_lanes(data, off, length)
    init = torch.full(off.shape, _M32, dtype=torch.int64, device=data.device)
    return (_crc_register(data, off, length, init) ^ _M32).to(torch.uint32)


def _multmodp(a, b):
    """a * b modulo the CRC-32 polynomial, reflected (zlib's multmodp), for
    ints or int64 tensors below 2^32."""
    p = b & 0
    for i in range(31, -1, -1):
        p = p ^ (b & -((a >> i) & 1))
        b = (b >> 1) ^ (_POLY & -(b & 1))
    return p


def _x2n_table() -> List[int]:
    """x^(2^k) modulo the polynomial, k = 0..31 (zlib's x2n_table; x^(2^32)
    = x, so k counts modulo 32). ``csrc/crc32_lanes.cu`` holds the same
    words as ``X2N``."""
    p, tab = 1 << 30, []
    for _ in range(32):
        tab.append(p)
        p = _multmodp(p, p)
    return tab


X2N = _x2n_table()


def crc32_shift(crc, nbytes) -> torch.Tensor:
    """shift(crc, n) = crc * x^(8n) mod P: the CRC register after ``n``
    zero bytes, by square-and-multiply over ``X2N``. int64 tensors (or
    ints) of registers and byte counts, broadcast."""
    crc = torch.as_tensor(crc, dtype=torch.int64)
    n = torch.as_tensor(nbytes, dtype=torch.int64, device=crc.device)
    x = torch.full(torch.broadcast_shapes(crc.shape, n.shape), 1 << 31,
                   dtype=torch.int64, device=crc.device)
    for k in range(int(n.max()).bit_length() if n.numel() else 0):
        x = torch.where((n >> k) & 1 == 1, _multmodp(X2N[(k + 3) & 31], x),
                        x)
    return _multmodp(x, crc)


def crc32_combine(crc_a, crc_b, len_b) -> torch.Tensor:
    """The CRC-32 of A + B from crc(A), crc(B) and len(B) (zlib's
    crc32_combine): shift(crc(A), len(B)) ^ crc(B)."""
    return crc32_shift(crc_a, len_b) ^ torch.as_tensor(crc_b,
                                                        dtype=torch.int64)


def crc32_plan(off: torch.Tensor, length: torch.Tensor, seg: int,
               base: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """The segment plan of the CRC-32 lane kernel, as torch ops on the
    lanes' device: lane i, at ``base + off[i]`` (``base`` the data's
    address modulo ``seg``), cut at the multiples of ``seg`` bytes, has
    ``nseg[i]`` segments (0 if empty) from segment ``first[i]`` on (an
    exclusive cumsum). Returns ``(nseg, first)``, int64."""
    s = seg.bit_length() - 1
    lo = off + base
    nseg = torch.where(length > 0, ((lo + length - 1) >> s) - (lo >> s) + 1,
                       0)
    return nseg, torch.cumsum(nseg, 0) - nseg


def crc32_group(maxseg: int) -> int:
    """Threads that combine one lane in the kernel: the least power of two
    up to a warp with which no thread folds more than 16 of the longest
    lane's ``maxseg`` segments."""
    g = 1
    while g < 32 and 16 * g < maxseg:
        g *= 2
    return g


def crc32_segmented(data: torch.Tensor, off: torch.Tensor,
                    length: torch.Tensor, seg: int, base: int = 0
                    ) -> torch.Tensor:
    """Plain PyTorch CRC-32 of every lane by the kernel's segments: the
    plan of ``crc32_plan``, each segment's raw CRC (register 0 at its
    start, no final XOR) through the plain byte step, and the combine: crc
    <- shift(crc, len_k) ^ raw_k over the lane's segments in order from
    0xFFFFFFFF, then the final NOT. (N,) uint32, equal to ``crc32_plain``
    for any ``seg`` (a power of two >= 16) and ``base``."""
    check_lanes(data, off, length)
    dev, s = data.device, seg.bit_length() - 1
    nseg, first = crc32_plan(off, length, seg, base)
    total = int(nseg.sum())
    lane = torch.repeat_interleave(
        torch.arange(off.shape[0], device=dev), nseg, output_size=total)
    lo = off[lane] + base
    blk = (lo >> s) + torch.arange(total, device=dev) - first[lane]
    a = torch.maximum(lo, blk << s)
    seg_len = torch.minimum(lo + length[lane], (blk + 1) << s) - a
    raw = _crc_register(data, a - base, seg_len,
                        torch.zeros(total, dtype=torch.int64, device=dev))
    crc = torch.full(off.shape, _M32, dtype=torch.int64, device=dev)
    for k in range(int(nseg.max()) if off.numel() else 0):
        live = k < nseg
        g = torch.where(live, first + k, 0).clamp(max=total - 1)
        crc = torch.where(live, crc32_shift(crc, seg_len[g]) ^ raw[g], crc)
    return (crc ^ _M32).to(torch.uint32)


#: the counters a profiled ``CrcLaunch`` fills: segment 0's clock cycles
#: over its rows of aligned 16-byte pieces (its warp's first thread) and
#: its pieces, lane 0's combine cycles (its first thread) and its segments
CRC_PROFILE = ("seg_cycles", "seg_pieces", "combine_cycles",
               "combine_segments")


class CrcLaunch:
    """One launch of the CRC-32 lane kernel (``csrc/crc32_lanes.cu``) over
    N >= 1 lanes of ``data`` on the card, prepared: inputs checked and the
    segment plan of ``seg`` bytes built on the card (``crc32_plan``, one
    host sync), each segment's lane listed, the combine's group
    (``crc32_group``) chosen, the raw CRCs and the (N,) uint32 CRCs
    allocated. ``run()`` launches the kernel on the current stream and
    returns the CRCs; the split lets a caller time the kernel apart from
    the plan. ``profile``, an int64 tensor of ``len(CRC_PROFILE)`` on the
    card, makes it a profiled launch that fills it."""

    def __init__(self, data: torch.Tensor, off: torch.Tensor,
                 length: torch.Tensor, seg: int = CRC_SEG,
                 profile: Optional[torch.Tensor] = None):
        check_lanes(data, off, length)
        if data.device.type != "cuda":
            raise ValueError(f"no crc32_lanes kernel for device {data.device}")
        n = off.shape[0]
        if n == 0:
            raise ValueError("no lanes to hash")
        if seg < 64 or seg & (seg - 1):
            raise ValueError(f"segment of {seg} bytes: not a power of two "
                             f">= 64")
        if profile is not None and (
                profile.device != data.device or profile.dtype != torch.int64
                or profile.shape != (len(CRC_PROFILE),)):
            raise ValueError(f"profile must be {len(CRC_PROFILE)} int64 on "
                             f"{data.device}")
        nseg, first = crc32_plan(off, length, seg, data.data_ptr() % seg)
        # one host sync: the lanes' least start, length and headroom, the
        # segments and the longest lane's
        lo, least, room, total, most = torch.stack([
            off.min(), length.min(), data.numel() - (off + length).max(),
            nseg.sum(), nseg.max()]).tolist()
        if min(lo, least, room) < 0:
            raise ValueError("a lane reaches outside data")
        dev = data.device
        seg_lane = torch.repeat_interleave(
            torch.arange(n, dtype=torch.int32, device=dev), nseg,
            output_size=total)
        self.segments, self.group = total, crc32_group(most)
        self.out = torch.empty(n, dtype=torch.uint32, device=dev)
        self.dev = dev
        # kept here so that the tensors outlive the launch
        self._args = (data, off, length, first, seg_lane,
                      torch.empty(total, dtype=torch.uint32, device=dev),
                      self.out, n, total, seg.bit_length() - 1, self.group,
                      0 if profile is None else profile)

    def run(self) -> torch.Tensor:
        global launches
        build.call("crc32_lanes", "crc32_lanes_launch", self.dev, *self._args)
        launches += 1
        return self.out


def crc32_flat(data: torch.Tensor, off: torch.Tensor, length: torch.Tensor
               ) -> torch.Tensor:
    """CRC-32 (N,) uint32 of ``data[off[i]:off[i] + length[i]]`` (the flat
    layout of ``ops/sha1.py``): the kernel on the card (``CrcLaunch``),
    ``crc32_plain`` on the CPU. No launch for N = 0."""
    check_lanes(data, off, length)
    if data.device.type == "cpu":
        return crc32_plain(data, off, length)
    if data.device.type == "cuda" and off.shape[0] == 0:
        return torch.empty(0, dtype=torch.uint32, device=data.device)
    return CrcLaunch(data, off, length).run()


def digest_bytes(words) -> List[bytes]:
    """(L, W) uint32 big-endian words (torch or numpy) -> byte digests."""
    if isinstance(words, torch.Tensor):
        return sha1.to_digests(words)
    return [np.asarray(row, np.uint32).astype(">u4").tobytes()
            for row in np.asarray(words)]
