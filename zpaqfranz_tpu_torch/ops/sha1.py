"""Batched SHA-1 over byte strings: the CUDA lane kernel and its plain version.

Replaces the TPU kernel ``zpaqfranz_tpu/ops/hash_pallas.py`` (``sha1_pallas``
over ``_build_call(nstate=5)``). The kernel is ``csrc/sha1_lanes.cu`` on the
lane machinery of ``csrc/hash_lanes.cuh``: one message a lane, a pair of
warps for 32 lanes, the producer warp staging bytes blocks ahead with aligned
16-byte copies at any offset, building the words and the FIPS 180-4 padding
and expanding the message schedule, the consumer warp running the rounds.
Inputs are one flat ``uint8`` tensor of concatenated messages with ``int64``
offsets and lengths; the result is an (N, 5) ``uint32`` state per message,
which ``to_digests`` turns into 20-byte big-endian digests.

``sha1_lanes`` takes the plain PyTorch version only for tensors on the CPU;
for CUDA tensors it launches the kernel or raises. The input checks, the
launch plan, the launch and the packing here serve the SHA-256 lane kernel
too (``ops/sha256.py``).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import build

__all__ = ["sha1_lanes", "sha1_plain", "pack_messages", "stage_bytes",
           "to_digests", "plan", "HashLaunch", "launches", "PROFILE"]

#: kernel launches made by ``sha1_lanes`` in this process
launches = 0

#: a profiled launch's clock counters of the longest lane
#: (``csrc/hash_lanes.cuh`` P_*): the consumer's cycles waiting for a
#: block's schedule and in its rounds, the producer's cycles waiting for a
#: block's bytes and building its words, schedule and next copies; the
#: lane's blocks; all the consumer's cycles
PROFILE = ("wait", "rounds", "bytes", "words", "blocks", "total")
#: data holds at most this many bytes, so that a lane's 16-byte pieces
#: count in 31 bits (``csrc/hash_lanes.cuh``)
MAX_DATA = 1 << 35

_M32 = 0xFFFFFFFF
_IV = (0x67452301, 0xEFCDAB89, 0x98BADCFE, 0x10325476, 0xC3D2E1F0)
_K = (0x5A827999, 0x6ED9EBA1, 0x8F1BBCDC, 0xCA62C1D6)


def check_lanes(data: torch.Tensor, off: torch.Tensor, length: torch.Tensor
                ) -> None:
    if data.dtype != torch.uint8 or data.dim() != 1:
        raise TypeError("data must be a 1-D uint8 tensor")
    for name, t in (("off", off), ("length", length)):
        if t.dtype != torch.int64 or t.dim() != 1:
            raise TypeError(f"{name} must be a 1-D int64 tensor")
        if t.device != data.device:
            raise ValueError(f"{name} is on {t.device}, data on {data.device}")
    if off.shape != length.shape:
        raise ValueError("off and length differ in shape")
    if not (data.is_contiguous() and off.is_contiguous()
            and length.is_contiguous()):
        raise ValueError("inputs must be contiguous")


def _rotl(x: torch.Tensor, k: int) -> torch.Tensor:
    return ((x << k) | (x >> (32 - k))) & _M32


def _compress(st: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """One SHA-1 compression over lanes; st (N, 5), w (N, 16), int64 < 2^32."""
    a, b, c, d, e = st.unbind(1)
    w = list(w.unbind(1))
    for t in range(80):
        if t >= 16:
            w[t & 15] = _rotl(w[(t - 3) & 15] ^ w[(t - 8) & 15]
                              ^ w[(t - 14) & 15] ^ w[t & 15], 1)
        if t < 20:
            f = (b & c) | ((b ^ _M32) & d)
        elif t < 40 or t >= 60:
            f = b ^ c ^ d
        else:
            f = (b & c) | (b & d) | (c & d)
        tmp = (_rotl(a, 5) + f + e + _K[t // 20] + w[t & 15]) & _M32
        e, d, c, b, a = d, c, _rotl(b, 30), a, tmp
    return (st + torch.stack([a, b, c, d, e], 1)) & _M32


def sha1_plain(data: torch.Tensor, off: torch.Tensor, length: torch.Tensor
               ) -> torch.Tensor:
    """Plain PyTorch SHA-1 of every lane. Returns (N, 5) uint32."""
    return plain_lanes(_IV, _compress, data, off, length)


def plain_lanes(iv, compress, data: torch.Tensor, off: torch.Tensor,
                length: torch.Tensor) -> torch.Tensor:
    """A Merkle-Damgard hash of every lane in plain PyTorch, block by block
    in int64 masked to 32 bits (CPU ``uint32`` has no shifts or adds), with
    the FIPS 180-4 padding: ``compress(st, w)`` maps (N, len(iv)) states and
    (N, 16) big-endian words to new states. Returns (N, len(iv)) uint32."""
    check_lanes(data, off, length)
    dev = data.device
    n = off.shape[0]
    if n == 0:
        return torch.empty((0, len(iv)), dtype=torch.uint32, device=dev)
    if data.numel() == 0:
        data = torch.zeros(1, dtype=torch.uint8, device=dev)
    nblk = (length + 9 + 63) // 64
    bits = length * 8
    kk = torch.arange(64, device=dev)
    shifts = torch.arange(24, -1, -8, device=dev)
    len_bytes = (bits[:, None] >> torch.arange(56, -1, -8, device=dev)) & 255
    st = torch.tensor(iv, dtype=torch.int64, device=dev).repeat(n, 1)
    for blk in range(int(nblk.max())):
        pos = blk * 64 + kk[None, :]
        idx = (off[:, None] + pos).clamp(max=data.numel() - 1)
        byte = torch.where(pos < length[:, None], data[idx].long(),
                           (pos == length[:, None]).long() * 0x80)
        last = (nblk - 1 == blk)[:, None]
        byte[:, 56:] = torch.where(last, len_bytes, byte[:, 56:])
        w = (byte.view(n, 16, 4) << shifts).sum(2)
        st = torch.where((blk < nblk)[:, None], compress(st, w), st)
    return st.to(torch.uint32)


def sha1_lanes(data: torch.Tensor, off: torch.Tensor, length: torch.Tensor,
               profile: Optional[torch.Tensor] = None) -> torch.Tensor:
    """SHA-1 state (N, 5) uint32 of ``data[off[i]:off[i] + length[i]]``.
    ``profile``: see ``HashLaunch`` (card only)."""
    global launches
    check_lanes(data, off, length)
    if data.device.type == "cpu" and profile is None:
        return sha1_plain(data, off, length)
    out = launch_lanes("sha1_lanes", 5, data, off, length, profile)
    if off.numel():
        launches += 1
    return out


def plan(length: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """The launch of a hash lane kernel over ``N`` >= 1 lanes of lengths
    ``length``: ``(order, blocks)``.

    ``order`` lists the lanes longest first (ties in lane order), lane t
    of the launch hashing ``order[t]``. A thread block is one pair of
    warps for 32 lanes, so ``blocks`` is N / 32 rounded up. The card
    spreads the blocks over its SMs in order: up to one per SM, each warp
    has a scheduler of its own; beyond that an SM's blocks come from far
    apart in the order, the longest lanes beside shorter ones."""
    order = torch.argsort(length, descending=True, stable=True)
    return order, -(-length.shape[0] // 32)


class HashLaunch:
    """One launch of a hash lane kernel (``csrc/<kernel>.cu``, C symbol
    ``<kernel>_launch``) over N >= 1 lanes, prepared: inputs checked (one
    host sync), the lanes ordered and the blocks counted by ``plan``, the
    (N, nstate) uint32 states allocated. ``run()`` launches the kernel on
    the current stream and returns the states; the split lets a caller time
    the kernel apart from the checks. ``profile``, an int64 tensor of
    ``len(PROFILE)`` on the card, makes it a profiled launch that fills it
    with the longest lane's clock counters."""

    def __init__(self, kernel: str, nstate: int, data: torch.Tensor,
                 off: torch.Tensor, length: torch.Tensor,
                 profile: Optional[torch.Tensor] = None):
        if data.device.type != "cuda":
            raise ValueError(f"no {kernel} kernel for device {data.device}")
        n = off.shape[0]
        if n == 0:
            raise ValueError("no lanes to hash")
        if data.numel() > MAX_DATA:
            raise ValueError(f"data holds more than {MAX_DATA} bytes")
        # a lane's first piece may start below data, in the tensor's storage
        if data.untyped_storage().data_ptr() % 16:
            raise ValueError("data's storage is not 16-byte aligned")
        if profile is not None and (
                profile.device != data.device or profile.dtype != torch.int64
                or profile.shape != (len(PROFILE),)):
            raise ValueError(f"profile must be {len(PROFILE)} int64 on "
                             f"{data.device}")
        # one host sync: the least of the lanes' start, length and headroom
        slack = torch.stack([off.min(), length.min(),
                             data.numel() - (off + length).max()]).min()
        if int(slack) < 0:
            raise ValueError("a lane reaches outside data")
        order, blocks = plan(length)
        self.out = torch.empty((n, nstate), dtype=torch.uint32,
                               device=data.device)
        self.kernel, self.dev = kernel, data.device
        # kept here so that the tensors outlive the launch
        self._args = (data, off, length, order, self.out,
                      0 if profile is None else profile, n, data.numel(),
                      blocks)

    def run(self) -> torch.Tensor:
        build.call(self.kernel, f"{self.kernel}_launch", self.dev,
                   *self._args)
        return self.out


def launch_lanes(kernel: str, nstate: int, data: torch.Tensor,
                 off: torch.Tensor, length: torch.Tensor,
                 profile: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One launch of a hash lane kernel over every lane (``HashLaunch``):
    the (N, nstate) uint32 states. No launch for N = 0."""
    if data.device.type == "cuda" and off.shape[0] == 0:
        return torch.empty((0, nstate), dtype=torch.uint32,
                           device=data.device)
    return HashLaunch(kernel, nstate, data, off, length, profile).run()


def stage_bytes(chunks: Sequence, device) -> torch.Tensor:
    """The concatenated bytes of ``chunks`` (bytes-like) as one flat
    ``uint8`` tensor on ``device``. For a CUDA device the bytes are
    gathered into pinned host memory, which the card copies from without
    blocking the host (the pinned block is not reused before the copy is
    done); for the CPU the gathered tensor itself."""
    dev = torch.device(device)
    pin = dev.type == "cuda"
    host = torch.empty(sum(map(len, chunks)), dtype=torch.uint8,
                       pin_memory=pin)
    flat = host.numpy()
    pos = 0
    for c in chunks:
        k = len(c)
        flat[pos:pos + k] = np.frombuffer(c, np.uint8)
        pos += k
    return host.to(dev, non_blocking=pin)


def pack_messages(messages: Sequence[bytes], device) -> Tuple[
        torch.Tensor, torch.Tensor, torch.Tensor]:
    """Concatenate messages into (data, off, length) tensors on ``device``
    (the bytes staged by ``stage_bytes``)."""
    lens = np.array([len(m) for m in messages], np.int64)
    offs = np.zeros(len(messages), np.int64)
    if len(messages) > 1:
        np.cumsum(lens[:-1], out=offs[1:])
    return (stage_bytes(messages, device), torch.from_numpy(offs).to(device),
            torch.from_numpy(lens).to(device))


def to_digests(state: torch.Tensor) -> List[bytes]:
    """(N, k) uint32 states -> 4k-byte big-endian digests."""
    words = state.view(torch.int32).cpu().numpy().view(np.uint32)
    return [row.astype(">u4").tobytes() for row in words]

