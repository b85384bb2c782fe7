"""Batched SHA-1 over byte strings: the CUDA lane kernel and its plain version.

Replaces the TPU kernel ``zpaqfranz_tpu/ops/hash_pallas.py`` (``sha1_pallas``
over ``_build_call(nstate=5)``). The kernel is ``csrc/sha1_lanes.cu``: one
message per thread, the 64-byte block loop and the FIPS 180-4 padding inside
the thread. Inputs are one flat ``uint8`` tensor of concatenated messages with
``int64`` offsets and lengths; the result is an (N, 5) ``uint32`` state per
message, which ``to_digests`` turns into 20-byte big-endian digests.

``sha1_lanes`` takes the plain PyTorch version only for tensors on the CPU;
for CUDA tensors it launches the kernel or raises. The input checks, the
launch and the packing here serve the SHA-256 lane kernel too
(``ops/sha256.py``).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from . import build

__all__ = ["sha1_lanes", "sha1_plain", "pack_messages", "to_digests",
           "launches"]

#: kernel launches made by ``sha1_lanes`` in this process
launches = 0

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


def sha1_lanes(data: torch.Tensor, off: torch.Tensor, length: torch.Tensor
               ) -> torch.Tensor:
    """SHA-1 state (N, 5) uint32 of ``data[off[i]:off[i] + length[i]]``."""
    global launches
    check_lanes(data, off, length)
    if data.device.type == "cpu":
        return sha1_plain(data, off, length)
    out = launch_lanes("sha1_lanes", 5, data, off, length)
    if off.numel():
        launches += 1
    return out


def launch_lanes(kernel: str, nstate: int, data: torch.Tensor,
                 off: torch.Tensor, length: torch.Tensor) -> torch.Tensor:
    """One launch of a hash lane kernel (``csrc/<kernel>.cu``, C symbol
    ``<kernel>_launch``) over every lane on the current stream; returns the
    (N, nstate) uint32 states. No launch for N = 0."""
    if data.device.type != "cuda":
        raise ValueError(f"no {kernel} kernel for device {data.device}")
    n = off.shape[0]
    out = torch.empty((n, nstate), dtype=torch.uint32, device=data.device)
    if n == 0:
        return out
    if (int(off.min()) < 0 or int(length.min()) < 0
            or int((off + length).max()) > data.numel()):
        raise ValueError("a lane reaches outside data")
    order = torch.argsort(length, descending=True, stable=True)
    build.call(kernel, f"{kernel}_launch", data.device, data, off, length,
               order, out, n)
    return out


def pack_messages(messages: Sequence[bytes], device) -> Tuple[
        torch.Tensor, torch.Tensor, torch.Tensor]:
    """Concatenate messages into (data, off, length) tensors on ``device``."""
    lens = np.array([len(m) for m in messages], np.int64)
    offs = np.zeros(len(messages), np.int64)
    if len(messages) > 1:
        np.cumsum(lens[:-1], out=offs[1:])
    flat = np.frombuffer(b"".join(messages), np.uint8)
    data = torch.from_numpy(flat.copy()).to(device)
    return (data, torch.from_numpy(offs).to(device),
            torch.from_numpy(lens).to(device))


def to_digests(state: torch.Tensor) -> List[bytes]:
    """(N, k) uint32 states -> 4k-byte big-endian digests."""
    words = state.view(torch.int32).cpu().numpy().view(np.uint32)
    return [row.astype(">u4").tobytes() for row in words]

