"""Device engine: coded segments as lanes of the CM decode and encode kernels.

The GPU mapping of the reference's one-thread-per-block parallelism: every
modeled block is one lane of ``ops.cm_decode`` or ``ops.cm_encode`` (a
group of CUDA threads), lanes that share a model (the COMP/HCOMP header) go
out in one launch, and each lane runs to its own end. Launches are sized by
``lanes_per_launch`` against the card's free memory. The block framing
helpers (``parse_block_payload``, ``selector``, ``assemble_block``) sit
beside the lanes.

Nothing here knows a jidac block: the add's pipeline (``jidac/add.py``
``code_jobs``: preprocessing, the store test, store blocks) and the block
decode (``jidac/extract.py`` ``decode_jidac_blocks``: block bounds,
postprocessing, store blocks) call down into this module, which imports
nothing from ``jidac/``.
"""

from __future__ import annotations

import math
import sys
from typing import List, Optional, Sequence, Tuple

import torch

from .. import native, trace
from ..codec.container import (TAG, ByteReader, find_block, read_comment,
                               read_filename)
from ..ops import cm_decode as cmd, cm_encode as cme
from ..ops.cm_model import hcomp_step, lane_bytes
from ..zpaql.header import Model

#: pre-postprocessing stream bound over a block's usize: BWT adds 5 bytes
#: and the embedded PCOMP blob, PASS adds 1, LZ77 output is smaller
OUT_SLACK = 8192

#: share of the card's free memory one launch may take
_MEM_SHARE = 0.8


def lanes_per_launch(model: Model, lane_io: int, device: torch.device
                     ) -> int:
    """Lanes that fit one launch: per-lane model state (what a launch with
    the model's HCOMP step allocates) plus ``lane_io`` bytes of coded input
    and output per lane, against the card's free memory. On the CPU the
    plain versions take every lane in one call."""
    if device.type != "cuda":
        return sys.maxsize
    per_lane = lane_bytes(model, hcomp_step(model)) + lane_io
    free, _ = torch.cuda.mem_get_info(device)
    fit = int(free * _MEM_SHARE) // per_lane
    if fit < 1:
        raise MemoryError(f"one lane needs {per_lane} bytes, the card has "
                          f"{free} free")
    return fit


def gate_lanes(model: Model, lanes: int, lane_io: int, device=None) -> int:
    """The lanes in flight of a job of ``lanes`` modeled blocks, as the
    engine gate (``device_policy``) counts them: at most
    ``lanes_per_launch`` on ``device`` (None = the card) where a card is
    present."""
    if not torch.cuda.is_available() or (
            device is not None and torch.device(device).type != "cuda"):
        return lanes
    from ..device import resolve
    return min(lanes, lanes_per_launch(model, lane_io, resolve(device)))


def encode_lane_io(model: Model, max_job: int) -> int:
    """Bytes of input and output a lane of an encode launch holds for a job
    of at most ``max_job`` raw bytes (``lanes_per_launch``'s ``lane_io``):
    the selector prefix and payload, and the coded stream's cap."""
    blob = model.pcomp_bytes()
    max_payload = 1 + (len(blob) if blob else 0) + max_job + OUT_SLACK
    return max_payload + cme.lane_cap(max_payload)


def decode_streams(model: Model, streams: Sequence[bytes],
                   caps: Sequence[int], device: torch.device,
                   max_hcomp_steps: Optional[int] = None) -> List[bytes]:
    """Decode coded segment payloads (post-header bytes, the segment's tail
    included) as lanes on ``device``. Returns each lane's pre-postprocessing
    stream (selector prefix + body); lane i may hold at most ``caps[i]``
    bytes, and a lane that would exceed it raises. ``max_hcomp_steps``: the
    kernel's limit on an interpreted HCOMP run."""
    out: List[bytes] = []
    lane_io = math.ceil((sum(map(len, streams)) + sum(caps)) / len(streams))
    step = lanes_per_launch(model, lane_io, device)
    for s in range(0, len(streams), step):
        with trace.span("engine.pack") as sp:
            packed = cmd.pack_streams(streams[s:s + step], caps[s:s + step],
                                      device)
            sp.add(lanes=len(packed[1]), bytes=packed[0].numel())
        out += _unpack(cmd.cm_decode(model, *packed,
                                     max_hcomp_steps=max_hcomp_steps))
    return out


def _unpack(result) -> List[bytes]:
    """``cm_model.lanes_to_bytes`` under the span ``engine.unpack``."""
    with trace.span("engine.unpack") as sp:
        out = cmd.lanes_to_bytes(*result)
        if trace.enabled():
            sp.add(bytes=sum(map(len, out)))
    return out


def encode_streams(model: Model, payloads: Sequence[bytes],
                   device: torch.device,
                   max_hcomp_steps: Optional[int] = None) -> List[bytes]:
    """Code payloads (selector prefix included) as lanes of one launch on
    ``device``; the caller sizes the batch with ``lanes_per_launch``.
    Returns each lane's coded segment body; lane i may take at most
    ``cm_encode.lane_cap(len(payloads[i]))`` bytes, and a lane that would
    exceed it raises. ``max_hcomp_steps``: the kernel's limit on an
    interpreted HCOMP run."""
    with trace.span("engine.pack") as sp:
        packed = cme.pack_payloads(payloads, device)
        sp.add(lanes=len(payloads), bytes=packed[0].numel())
    return _unpack(cme.cm_encode(model, *packed,
                                 max_hcomp_steps=max_hcomp_steps))


def parse_block_payload(data: bytes, offset: int
                        ) -> Tuple[Model, int, bytes]:
    """At a block's archive offset: parse header + first segment intro;
    return (model, payload_start, payload_bytes-to-end-of-archive)."""
    r = ByteReader(data, offset)
    model = find_block(r)
    if model is None:
        raise RuntimeError(f"no block at offset {offset}")
    read_filename(r)
    read_comment(r)
    return model, r.pos, bytes(r.data[r.pos:])


def selector(model: Model) -> bytes:
    """The selector prefix a coded payload starts with: 1 + the PCOMP
    program when the model has one, else 0."""
    blob = model.pcomp_bytes()
    return b"\x01" + blob if blob else b"\x00"


def coded_stream(model: Model, payload: bytes) -> bytes:
    """The native engine's coded segment of ``payload`` as the decoder
    takes it: the bytes after the segment header, tail included."""
    return parse_block_payload(
        native.compress_block(model, payload, b"t", b"c"), 0)[2]


#: bytes read from a block's start to parse its model: the header (at most
#: 65,537 bytes) and the first segment's name and comment
HEADER_READ = 1 << 17


def assemble_block(model: Model, coded: bytes, name: bytes,
                   comment: bytes) -> bytes:
    """Wrap a coded segment body in the standard tagged block/segment
    framing with no stored SHA-1 (mirror of the native tzc_compress_block
    writer)."""
    return b"".join((TAG, b"zPQ", bytes([1 if model.n else 2, 1]),
                     model.header_bytes(), b"\x01", name, b"\x00", comment,
                     b"\x00\x00", coded, b"\x00\x00\x00\x00\xfe\xff"))
