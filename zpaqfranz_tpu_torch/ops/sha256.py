"""Batched SHA-256 over byte strings: the CUDA lane kernel and its plain
version.

Replaces the TPU kernel ``zpaqfranz_tpu/ops/hash_pallas.py``
(``sha256_pallas`` over ``_build_call(nstate=8)``). The kernel is
``csrc/sha256_lanes.cu``, the twin of ``csrc/sha1_lanes.cu`` with the
FIPS 180-4 SHA-256 body on the same lane machinery (``csrc/hash_lanes.cuh``):
one message per thread, its bytes staged blocks ahead, the 64-byte block
loop and the padding inside the thread, no host window ladder. Inputs, the
launch plan and packing are those of ``ops/sha1.py`` (one flat ``uint8`` tensor with ``int64``
offsets and lengths); the result is an (N, 8) ``uint32`` state per message,
which ``sha1.to_digests`` turns into 32-byte big-endian digests.

``sha256_lanes`` takes the plain PyTorch version only for tensors on the
CPU; for CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from .sha1 import check_lanes, launch_lanes, plain_lanes

__all__ = ["sha256_lanes", "sha256_plain", "launches"]

#: kernel launches made by ``sha256_lanes`` in this process
launches = 0

_M32 = 0xFFFFFFFF
_IV = (0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a, 0x510e527f,
       0x9b05688c, 0x1f83d9ab, 0x5be0cd19)
_K = (
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
    0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
    0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
    0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
    0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2)


def _rotr(x: torch.Tensor, k: int) -> torch.Tensor:
    return ((x >> k) | (x << (32 - k))) & _M32


def _compress(st: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """One SHA-256 compression over lanes; st (N, 8), w (N, 16), int64
    < 2^32 (``hash_pallas._sha256_block``)."""
    a, b, c, d, e, f, g, h = st.unbind(1)
    w = list(w.unbind(1))
    for t in range(64):
        if t >= 16:
            x15, x2 = w[(t - 15) & 15], w[(t - 2) & 15]
            s0 = _rotr(x15, 7) ^ _rotr(x15, 18) ^ (x15 >> 3)
            s1 = _rotr(x2, 17) ^ _rotr(x2, 19) ^ (x2 >> 10)
            w[t & 15] = (w[t & 15] + s0 + w[(t - 7) & 15] + s1) & _M32
        s1 = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
        ch = (e & f) ^ ((e ^ _M32) & g)
        t1 = h + s1 + ch + _K[t] + w[t & 15]
        s0 = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
        maj = (a & b) ^ (a & c) ^ (b & c)
        h, g, f, e = g, f, e, (d + t1) & _M32
        d, c, b, a = c, b, a, (t1 + s0 + maj) & _M32
    return (st + torch.stack([a, b, c, d, e, f, g, h], 1)) & _M32


def sha256_plain(data: torch.Tensor, off: torch.Tensor, length: torch.Tensor
                 ) -> torch.Tensor:
    """Plain PyTorch SHA-256 of every lane. Returns (N, 8) uint32."""
    return plain_lanes(_IV, _compress, data, off, length)


def sha256_lanes(data: torch.Tensor, off: torch.Tensor, length: torch.Tensor,
                 profile: Optional[torch.Tensor] = None) -> torch.Tensor:
    """SHA-256 state (N, 8) uint32 of ``data[off[i]:off[i] + length[i]]``.
    ``profile``: see ``sha1.HashLaunch`` (card only)."""
    global launches
    check_lanes(data, off, length)
    if data.device.type == "cpu" and profile is None:
        return sha256_plain(data, off, length)
    out = launch_lanes("sha256_lanes", 8, data, off, length, profile)
    if off.numel():
        launches += 1
    return out
