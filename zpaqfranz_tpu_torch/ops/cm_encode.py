"""ZPAQ context-mixing lane encoder: the CUDA kernel and its plain version.

Replaces the TPU device program ``zpaqfranz_tpu/ops/codec_arena.py``
(``ArenaEncoder`` over ``ArenaCoder.byte_step``). The kernel is
``csrc/cm_encode.cu``: one lane (one d block's payload, selector prefix
included) per group of G threads, the whole payload in one launch, each
lane writing through its own output cursor. The model it runs (arena
layout, predictor phases, update, HCOMP, the shared-memory ``Placement``)
is shared with the decoder: ``csrc/cm_model.cuh`` and ``ops/cm_model.py``.

The range coder is libzpaq's ``Encoder``: each byte starts with the
end-of-segment bit 0 at p = 0, the byte's bits go at ``predict() * 2 + 1``,
and after the last byte an end-of-segment bit 1 at p = 0 flushes ``low``.
The coded bytes are the segment's body, without the four zero bytes and
the end marker that ``parallel/engine.assemble_block`` appends.

``cm_encode`` takes the plain version (``cm_model.PlainModel`` with this
range coder) only for tensors on the CPU; for CUDA tensors it launches the
kernel or raises. A lane whose coded bytes would pass its capacity, or
whose HCOMP program faults, raises ``CMEncodeError``; nothing is truncated.
HCOMP runs as in the decoder: specialised when ``ops/hcomp_fast.py``
accepts the program, else interpreted with the ``max_hcomp_steps`` limit.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from ..zpaql.header import Model
from .cm_model import (_M32, ST_CORRUPT, ST_OK, ST_OVERRUN, ST_ZPAQL,
                       LaneLaunch, PlainModel, check_lanes, plain_result,
                       raise_failed)
from .sha1 import pack_messages

__all__ = ["Launch", "cm_encode", "cm_encode_plain", "CMEncodeError",
           "lane_cap", "pack_payloads", "launches", "hcomp_launches"]

#: kernel launches made by ``cm_encode`` in this process
launches = 0
#: ... of them by HCOMP step (``cm_model.HCOMP_STEPS``)
hcomp_launches = {"fast": 0, "interp": 0}

_REASON = {ST_OVERRUN: "coded past its output capacity",
           ST_CORRUPT: "model has an unknown component",
           ST_ZPAQL: "HCOMP program faulted"}


class CMEncodeError(RuntimeError):
    """A lane could not be coded within its capacity or its model failed."""


def lane_cap(n: int) -> int:
    """Coded-byte capacity of a lane of ``n`` payload bytes (the reference
    engine's ``len + len / 2 + 64``)."""
    return n + n // 2 + 64


def cm_encode(model: Model, data: torch.Tensor, in_off: torch.Tensor,
              in_len: torch.Tensor, out_cap: torch.Tensor,
              max_hcomp_steps: Optional[int] = None
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Code every lane ``data[in_off[i]:in_off[i] + in_len[i]]`` (a payload
    with its selector prefix) as one ZPAQ segment body.

    Returns ``(out, out_off, out_len)``: lane i's coded bytes are
    ``out[out_off[i]:out_off[i] + out_len[i]]``, with at most
    ``out_cap[i]`` bytes per lane. ``max_hcomp_steps``: the kernel's limit
    on an interpreted HCOMP run (``cm_model.MAX_HCOMP_STEPS``)."""
    check_lanes(model, data, in_off, in_len, out_cap)
    if data.device.type == "cpu":
        return cm_encode_plain(model, data, in_off, in_len, out_cap)
    return Launch.code(model, data, in_off, in_len, out_cap,
                       max_hcomp_steps=max_hcomp_steps)


class Launch(LaneLaunch):
    """One prepared launch of the encode kernel (``cm_model.LaneLaunch``);
    ``cm_encode`` is ``Launch.code(...)``, ``Launch(...).run().result()``
    under the tracer's spans."""

    kernel = "cm_encode"
    error = CMEncodeError
    reasons = _REASON

    def counted(self) -> None:
        global launches
        launches += 1
        hcomp_launches[self.hcomp] += 1


# ---------------------------------------------------------------------------
# plain PyTorch version


class _PlainEncoder(PlainModel):
    """The plain predictor with libzpaq's range encoder. ``active`` marks
    the lanes that still have bytes to code."""

    def __init__(self, model, data, in_off, in_len, out_cap):
        L = in_off.shape[0]
        super().__init__(model, L, data.device)
        self.data = data if data.numel() else torch.zeros(
            1, dtype=torch.uint8, device=data.device)
        self.in_off, self.in_len = in_off, in_len
        z = torch.zeros(L, dtype=torch.int64, device=data.device)
        self.low = z + 1
        self.high = z + _M32
        self.caps = out_cap.tolist()
        self.outs = [bytearray() for _ in range(L)]

    def emit(self, go: torch.Tensor) -> None:
        byte = (self.high >> 24).tolist()
        over = []
        for k in torch.nonzero(go).flatten().tolist():
            if len(self.outs[k]) >= self.caps[k]:
                over.append(k)
            else:
                self.outs[k].append(byte[k])
        if over:
            mask = torch.zeros_like(go)
            mask[over] = True
            self.fail(mask, ST_OVERRUN)

    def encode_bit(self, y: torch.Tensor, p: torch.Tensor,
                   live: torch.Tensor) -> None:
        mid = (self.low + (((self.high - self.low) & _M32) * p >> 16)) & _M32
        self.high = torch.where(live & (y == 1), mid, self.high)
        self.low = torch.where(live & (y == 0), (mid + 1) & _M32, self.low)
        for _ in range(4):
            go = live & ((self.high ^ self.low) < (1 << 24))
            if not bool(go.any()):
                break
            self.emit(go)
            go = go & (self.status == ST_OK)
            live = live & (self.status == ST_OK)
            self.high = torch.where(go, ((self.high << 8) | 255) & _M32,
                                    self.high)
            low = (self.low << 8) & _M32
            self.low = torch.where(go, low + (low == 0).long(), self.low)

    def run(self) -> None:
        zero = torch.zeros_like(self.low)
        last = self.data.numel() - 1
        for j in range(int(self.in_len.max()) if self.L else 0):
            self.active = self.active & (j < self.in_len)
            self.encode_bit(zero, zero, self.active)
            byte = self.data[(self.in_off + j).clamp(max=last)].long()
            for phase in range(8):
                pr = self.predict(phase) * 2 + 1
                y = (byte >> (7 - phase)) & 1
                self.encode_bit(y, pr, self.active)
                self.update(phase, y)
        self.active = self.status == ST_OK
        self.encode_bit(zero + 1, zero, self.active)


def cm_encode_plain(model: Model, data: torch.Tensor, in_off: torch.Tensor,
                    in_len: torch.Tensor, out_cap: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain PyTorch encoder, same contract as ``cm_encode``."""
    check_lanes(model, data, in_off, in_len, out_cap)
    enc = _PlainEncoder(model, data, in_off, in_len, out_cap)
    enc.run()
    raise_failed(enc.status, CMEncodeError, _REASON)
    return plain_result(enc.outs, out_cap, data.device)


def pack_payloads(payloads: Sequence[bytes], device
                  ) -> Tuple[torch.Tensor, ...]:
    """Concatenate payloads into (data, in_off, in_len, out_cap), each
    lane's capacity ``lane_cap(len)``."""
    return (*pack_messages(payloads, device),
            torch.tensor([lane_cap(len(p)) for p in payloads],
                         dtype=torch.int64).to(device))
