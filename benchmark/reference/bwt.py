"""The reference's BWT of the level-3 stream format (libzpaq's ``-m3``
preprocessor, as the stored PCOMP program of a BWT block inverts it),
written from the format's description in plain Python:

- the rows are the n + 1 suffixes of the block, the empty one (the
  sentinel) first, in sorted order, a suffix that is a prefix of another
  before it;
- the stream is each row's preceding byte (the last column), the row of
  the whole block (whose preceding byte is the sentinel) holding 255, then
  that row's index as 4 bytes, least significant first: n + 5 bytes.

It uses nothing of the archiver. Its suffix sort doubles the compared
prefix each round (O(n log^2 n)): a reference for tests, not a fast path.
"""

from __future__ import annotations

from typing import List


def suffix_array(data: bytes) -> List[int]:
    """The start of each non-empty suffix of ``data``, in sorted order."""
    n = len(data)
    rank = list(data)
    sa = list(range(n))
    k = 1
    while n:
        def key(i: int, rank=rank, k=k):
            return rank[i], rank[i + k] if i + k < n else -1
        sa.sort(key=key)
        new = [0] * n
        for a, b in zip(sa, sa[1:]):
            new[b] = new[a] + (key(a) != key(b))
        rank = new
        if rank[sa[-1]] == n - 1:
            break
        k *= 2
    return sa


def encode(data: bytes) -> bytes:
    """The level-3 BWT stream of ``data``."""
    n = len(data)
    out = bytearray([data[-1] if n else 255])
    idx = 0
    for row, i in enumerate(suffix_array(data), 1):
        if i == 0:
            idx = row
            out.append(255)
        else:
            out.append(data[i - 1])
    return bytes(out) + idx.to_bytes(4, "little")


def decode(stream: bytes) -> bytes:
    """The block whose level-3 BWT stream is ``stream``."""
    n = len(stream) - 5
    if n < 0:
        raise ValueError(f"a BWT stream of {len(stream)} bytes: "
                         "it has at least 5")
    last = stream[:n + 1]
    idx = int.from_bytes(stream[n + 1:], "little")
    if not 0 <= idx <= n or (n and idx == 0):
        raise ValueError(f"sentinel row {idx} outside 1..{n}")
    counts = [0] * 256
    for row, c in enumerate(last):
        if row != idx:
            counts[c] += 1
    # each byte's first row: row 0 is the empty suffix
    first, total = [0] * 256, 1
    for c in range(256):
        first[c], total = total, total + counts[c]
    # lf[row]: the row of the suffix one byte longer than row's
    lf, seen = [0] * (n + 1), [0] * 256
    for row, c in enumerate(last):
        if row != idx:
            lf[row] = first[c] + seen[c]
            seen[c] += 1
    out = bytearray(n)
    row = 0
    for k in range(n - 1, -1, -1):
        out[k] = last[row]
        row = lf[row]
    return bytes(out)
