"""Device BWT: a prefix-doubling suffix sort in torch ops, on the card.

The port of ``zpaqfranz_tpu/pre/bwt_device.py``. The host engine builds
-m3's BWT with SA-IS (``native.bwt_encode``); this is the device-side
alternative, as in the reference an orphan: ``add -m3`` keeps the host
engine's SA-IS. Each round of prefix doubling sorts the suffixes by the
pair (rank[i], rank[i + k]) as two stable single-key sorts, on the second
key (-1 past the end) and then on the first, and refreshes the ranks from
the sorted pairs (a diff, a cumsum and a scatter). The reference's only
device work here is XLA's sort, with no Pallas kernel, so its counterpart
is ``torch.sort(stable=True)``, the card's radix sort, with no hand kernel.

The emitted stream is byte-identical to the host engine's
``tz_bwt_encode`` (the suffix array of a string with an implicit unique
smallest sentinel is unique):

    out[0]       = in[n-1]                (the sentinel's BWT char)
    out[1..n]    = in[sa[i]-1], 255 at the sa[i]==0 row
    out[n+1..+4] = little-endian index of the sentinel row

which is what the inverse-BWT ZPAQL postprocessor expects. Both entry
points run on the card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..device import resolve

__all__ = ["suffix_array_device", "bwt_encode_device", "prefix_doubling",
           "launches"]

#: calls that ran on the card in this process
launches = 0


def prefix_doubling(x: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """Suffix array (int64) of the uint8 tensor ``x`` and the rounds it
    took.

    The reference runs ceil(log2 n) rounds; this stops as soon as every
    rank is distinct, since a further round sorts the pairs into the same
    order and gives every suffix the same rank again, so the suffix array
    is the same."""
    n = x.numel()
    if n < 2:
        return torch.zeros(n, dtype=torch.int64, device=x.device), 0
    rank = x.to(torch.int32)
    k, rounds = 1, 0
    while k < n:
        key2 = torch.full((n,), -1, dtype=torch.int32, device=x.device)
        key2[:n - k] = rank[k:]
        o1 = torch.sort(key2, stable=True).indices
        order = o1[torch.sort(rank[o1], stable=True).indices]
        r_s, k_s = rank[order], key2[order]
        newr = torch.zeros(n, dtype=torch.int32, device=x.device)
        newr[1:] = torch.cumsum((r_s[1:] != r_s[:-1]) | (k_s[1:] != k_s[:-1]),
                                0, dtype=torch.int32)
        rank = torch.empty_like(rank).scatter_(0, order, newr)
        k, rounds = 2 * k, rounds + 1
        if int(newr[-1]) == n - 1:
            break
    # rank is now the inverse suffix array
    sa = torch.empty(n, dtype=torch.int64, device=x.device)
    sa[rank.long()] = torch.arange(n, device=x.device)
    return sa, rounds


def _on(data: bytes, device) -> torch.Tensor:
    global launches
    dev = resolve(device)
    if dev.type == "cuda":
        launches += 1
    return torch.frombuffer(bytearray(data), dtype=torch.uint8).to(dev)


def suffix_array_device(data: bytes, device=None) -> np.ndarray:
    """Suffix array of ``data`` (implicit unique smallest sentinel), int32."""
    if not data:
        return np.zeros(0, np.int32)
    sa, _ = prefix_doubling(_on(data, device))
    return sa.to(torch.int32).cpu().numpy()


def bwt_encode_device(data: bytes, device=None) -> bytes:
    """BWT stream (n+5 bytes), byte-identical to native.bwt_encode."""
    n = len(data)
    if n == 0:
        return b"\xff" + b"\x00" * 4
    x = _on(data, device)
    sa, _ = prefix_doubling(x)
    prev = torch.where(sa == 0, 255, x[(sa - 1) % n])
    row = int(torch.argmax((sa == 0).to(torch.uint8))) + 1
    return (data[n - 1:] + prev.to(torch.uint8).cpu().numpy().tobytes()
            + row.to_bytes(4, "little"))
