"""ZPAQ context-mixing lane decoder: the CUDA kernel and its plain version.

Replaces the TPU device program ``zpaqfranz_tpu/ops/codec_arena.py``
(``ArenaDecoder`` over ``ArenaCoder.byte_step``) and its HCOMP step
(``ops/hcomp_fast.py`` / ``ops/vm_batched.py``). The kernel is
``csrc/cm_decode.cu``: one lane (one d block's coded segment) per group of
G threads, the whole segment in one launch, HCOMP as the model's program
specialised into straight-line code (``ops/hcomp_fast.py``), or through an
in-kernel ZPAQL interpreter for a program outside that subset. The model
it runs (arena layout, predictor phases, update, HCOMP, the shared-memory
``Placement``) is shared with the encoder: ``csrc/cm_model.cuh`` and
``ops/cm_model.py``.

The plain version is ``cm_model.PlainModel`` with libzpaq's range decoder,
looping over bytes and bits in Python.

``cm_decode`` takes the plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises. A lane that fails (corrupt
stream, input too short, output past its capacity, a ZPAQL fault) raises
``CMDecodeError``; nothing is truncated silently. The kernel also fails a
lane whose interpreted HCOMP run exceeds ``max_hcomp_steps`` instructions
for one byte (2^24 by default), so a runaway program cannot hold the card;
the plain version has no such limit.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from ..errors import ExtractError
from ..zpaql.header import Model
from .cm_model import (_M32, ST_CORRUPT, ST_EOF, ST_OVERRUN, ST_ZPAQL,
                       LaneLaunch, Layout, PlainModel, check_lanes,
                       initial_lane_state, lane_bytes, lanes_to_bytes, lut,
                       plain_result, raise_failed)
from .sha1 import pack_messages

__all__ = ["Layout", "Launch", "lut", "cm_decode", "cm_decode_plain",
           "CMDecodeError", "initial_lane_state", "lane_bytes",
           "pack_streams", "lanes_to_bytes", "launches", "hcomp_launches",
           "combine_launches", "phases_launches"]

#: kernel launches made by ``cm_decode`` in this process
launches = 0
#: ... of them by HCOMP step (``cm_model.HCOMP_STEPS``)
hcomp_launches = {"fast": 0, "interp": 0}
#: ... of them by combine (``cm_model.COMBINE_STEPS``)
combine_launches = {"fast": 0, "generic": 0}
#: ... of them by phases (a) and (c) (``cm_model.PHASES_STEPS``)
phases_launches = {"fast": 0, "generic": 0}

_REASON = {ST_OVERRUN: "decoded past its output capacity",
           ST_CORRUPT: "coded stream is corrupt",
           ST_EOF: "coded stream ends early",
           ST_ZPAQL: "HCOMP program faulted"}


class CMDecodeError(ExtractError):
    """A lane's coded stream does not decode: the block is damaged."""


def cm_decode(model: Model, coded: torch.Tensor, in_off: torch.Tensor,
              in_len: torch.Tensor, out_cap: torch.Tensor,
              max_hcomp_steps: Optional[int] = None
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Decode every lane ``coded[in_off[i]:in_off[i] + in_len[i]]`` (a coded
    segment from its first byte) up to its end-of-segment bit.

    Returns ``(out, out_off, out_len)``: lane i's decoded bytes are
    ``out[out_off[i]:out_off[i] + out_len[i]]``, with at most
    ``out_cap[i]`` bytes per lane. ``max_hcomp_steps``: the kernel's limit
    on an interpreted HCOMP run (``cm_model.MAX_HCOMP_STEPS``)."""
    check_lanes(model, coded, in_off, in_len, out_cap)
    if coded.device.type == "cpu":
        return cm_decode_plain(model, coded, in_off, in_len, out_cap)
    return Launch.code(model, coded, in_off, in_len, out_cap,
                       max_hcomp_steps=max_hcomp_steps)


class Launch(LaneLaunch):
    """One prepared launch of the decode kernel (``cm_model.LaneLaunch``);
    ``cm_decode`` is ``Launch.code(...)``, ``Launch(...).run().result()``
    under the tracer's spans."""

    kernel = "cm_decode"
    error = CMDecodeError
    reasons = _REASON

    def counted(self) -> None:
        global launches
        launches += 1
        hcomp_launches[self.hcomp] += 1
        combine_launches[self.combine] += 1
        phases_launches[self.phases] += 1

    def lane_payload(self) -> torch.Tensor:
        return self.out_len


# ---------------------------------------------------------------------------
# plain PyTorch version


class _PlainDecoder(PlainModel):
    """The plain predictor with libzpaq's range decoder."""

    def __init__(self, model, coded, in_off, in_len, out_cap):
        L = in_off.shape[0]
        super().__init__(model, L, coded.device)
        self.coded = coded if coded.numel() else torch.zeros(
            1, dtype=torch.uint8, device=coded.device)
        self.in_off, self.in_len = in_off, in_len
        z = torch.zeros(L, dtype=torch.int64, device=coded.device)
        self.low = z + 1
        self.high = z + _M32
        self.curr = z.clone()
        self.pos = z.clone()
        self.nout = z.clone()
        self.out_cap = out_cap
        self.outs = [bytearray() for _ in range(L)]

    def read_byte(self) -> torch.Tensor:
        ok = self.pos < self.in_len
        idx = (self.in_off + self.pos).clamp(max=self.coded.numel() - 1)
        return torch.where(ok, self.coded[idx].long(), 0)

    def decode_bit(self, p: torch.Tensor) -> torch.Tensor:
        self.fail((self.curr < self.low) | (self.curr > self.high),
                  ST_CORRUPT)
        mid = (self.low + (((self.high - self.low) & _M32) * p >> 16)) & _M32
        y = self.curr <= mid
        self.high = torch.where(y, mid, self.high)
        self.low = torch.where(y, self.low, (mid + 1) & _M32)
        for _ in range(4):
            go = (self.high ^ self.low) < (1 << 24)
            if not bool(go.any()):
                break
            self.fail(go & (self.pos >= self.in_len), ST_EOF)
            self.high = torch.where(go, ((self.high << 8) | 255) & _M32,
                                    self.high)
            low = (self.low << 8) & _M32
            self.low = torch.where(go, low + (low == 0).long(), self.low)
            self.curr = torch.where(
                go, ((self.curr << 8) | self.read_byte()) & _M32, self.curr)
            self.pos = self.pos + go.long()
        return y.long()

    def run(self) -> None:
        short = self.in_len < 4
        self.fail(short, ST_EOF)
        for _ in range(4):
            self.curr = torch.where(short, 0, (self.curr << 8)
                                    | self.read_byte())
            self.pos = self.pos + 1
        zero = torch.zeros_like(self.low)
        while bool(self.active.any()):
            eos = self.decode_bit(zero).bool() & self.active
            self.fail(eos & (self.curr != 0), ST_CORRUPT)
            self.active = self.active & ~eos
            self.fail(self.nout >= self.out_cap, ST_OVERRUN)
            c = torch.ones_like(self.low)
            for phase in range(8):
                pr = self.predict(phase) * 2 + 1
                y = self.decode_bit(pr)
                c = c * 2 + y
                self.update(phase, y)
            done = self.active.tolist()
            vals = (c - 256).tolist()
            for k in range(self.L):
                if done[k]:
                    self.outs[k].append(vals[k])
            self.nout = self.nout + self.active.long()


def cm_decode_plain(model: Model, coded: torch.Tensor, in_off: torch.Tensor,
                    in_len: torch.Tensor, out_cap: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain PyTorch decoder, same contract as ``cm_decode``."""
    check_lanes(model, coded, in_off, in_len, out_cap)
    dec = _PlainDecoder(model, coded, in_off, in_len, out_cap)
    dec.run()
    raise_failed(dec.status, CMDecodeError, _REASON)
    return plain_result(dec.outs, out_cap, coded.device)


def pack_streams(streams: Sequence[bytes], caps: Sequence[int], device
                 ) -> Tuple[torch.Tensor, ...]:
    """Concatenate coded streams into (coded, in_off, in_len, out_cap)."""
    return (*pack_messages(streams, device),
            torch.tensor(list(caps), dtype=torch.int64).to(device))
