"""The batched coders: L ZPAQ streams of one model, decoded or encoded.

The port of ``zpaqfranz_tpu/ops/coder_batched.py``'s API, with no second
engine: the reference's ``BatchedDecoder`` / ``BatchedEncoder`` scan one
jnp table operation at a time over the lanes (``ZPAQFRANZ_DEVICE_ENGINE=
batched``), a twin of its arena engine with identical bytes. Here they run
the CM lane kernels, ``ops/cm_decode.cm_decode`` and
``ops/cm_encode.cm_encode``, on the card (their launches count there), and
the kernels' plain coders on the CPU, through ``parallel/engine.py``,
which sizes each launch against the card's free memory.

Inputs are the reference's: (L, N) ``uint8`` rows (numpy or torch), each a
lane's coded segment (decode) or payload with its selector prefix (encode),
padded with zeros. Results are numpy arrays. Where the reference truncates
silently (a lane past ``max_bytes`` or past ``out_cap``) the port raises
``CMDecodeError`` / ``CMEncodeError``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve
from ..parallel import engine
from ..zpaql.header import Model
from .cm_encode import CMEncodeError, lane_cap

__all__ = ["BatchedDecoder", "BatchedEncoder"]


def _rows(data) -> np.ndarray:
    rows = torch.as_tensor(data).cpu().numpy()
    if rows.dtype != np.uint8 or rows.ndim != 2:
        raise TypeError("data must be an (L, N) uint8 array")
    return rows


def _pad(lanes: Sequence[bytes], width: int) -> Tuple[np.ndarray,
                                                       np.ndarray]:
    out = np.zeros((len(lanes), width), np.uint8)
    for i, b in enumerate(lanes):
        out[i, :len(b)] = np.frombuffer(b, np.uint8)
    return out, np.array([len(b) for b in lanes], np.int32)


class BatchedDecoder:
    """Decodes L modeled segment streams on ``device`` (None: the card)."""

    def __init__(self, model: Model, max_hcomp_steps: Optional[int] = None,
                 device=None):
        if model.n == 0:
            raise ValueError("store-mode blocks decode on the host path")
        self.model = model
        self.max_hcomp_steps = max_hcomp_steps
        self.device = resolve(device)

    def decode(self, data, max_bytes: int) -> Tuple[np.ndarray, np.ndarray]:
        """``data`` (L, N): each lane's coded bytes after the segment header.
        Returns (out (L, max_bytes) uint8, lengths (L,) int32): each lane's
        decoded stream, selector prefix included, up to its end-of-segment
        bit; a lane longer than ``max_bytes`` raises."""
        rows = _rows(data)
        lanes = engine.decode_streams(
            self.model, [r.tobytes() for r in rows], [max_bytes] * len(rows),
            self.device, self.max_hcomp_steps) if len(rows) else []
        return _pad(lanes, max_bytes)


class BatchedEncoder:
    """Encodes L byte streams of one model on ``device`` (None: the card).
    ``out_cap``: the width of the coded output (default: the widest lane's
    ``cm_encode.lane_cap``)."""

    def __init__(self, model: Model, out_cap: Optional[int] = None,
                 max_hcomp_steps: Optional[int] = None, device=None):
        if model.n == 0:
            raise ValueError("store-mode blocks encode on the host path")
        self.model = model
        self.out_cap = out_cap
        self.max_hcomp_steps = max_hcomp_steps
        self.device = resolve(device)

    def encode(self, data, lengths) -> Tuple[np.ndarray, np.ndarray]:
        """Lane j codes its first ``lengths[j]`` bytes (the postprocessor
        selector first, as ``codec/writer.BlockWriter`` codes it), then the
        end-of-segment bit. Returns (out (L, out_cap) uint8, counts (L,)
        int32): each lane's coded segment body, without the four zero bytes
        and the end marker."""
        rows = _rows(data)
        lens = np.asarray(torch.as_tensor(lengths).cpu(), np.int64)
        if lens.shape != (len(rows),) or (len(lens) and (
                lens.min() < 0 or lens.max() > rows.shape[1])):
            raise ValueError("lengths must give each row's bytes")
        payloads = [r[:n].tobytes() for r, n in zip(rows, lens)]
        width = self.out_cap if self.out_cap is not None else lane_cap(
            rows.shape[1])
        top = max(map(len, payloads), default=0)
        step = engine.lanes_per_launch(self.model, top + lane_cap(top),
                                       self.device)
        coded: List[bytes] = []
        for s in range(0, len(payloads), step):
            coded += engine.encode_streams(self.model, payloads[s:s + step],
                                           self.device, self.max_hcomp_steps)
        for j, c in enumerate(coded):
            if len(c) > width:
                raise CMEncodeError(f"lane {j} coded {len(c)} bytes, past "
                                    f"out_cap {width}")
        return _pad(coded, width)
