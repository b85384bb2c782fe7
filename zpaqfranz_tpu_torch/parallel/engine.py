"""Device engine: jidac d blocks as lanes of the CM decode and encode kernels.

The GPU mapping of the reference's one-thread-per-block parallelism: every
modeled d block is one lane of ``ops.cm_decode`` or ``ops.cm_encode`` (a
group of CUDA threads), lanes that share a model (the COMP/HCOMP header) go
out in one launch, and each lane runs to its own end. Launches are sized by
``lanes_per_launch`` against the card's free memory. Preprocessing (LZ77,
BWT, E8E9) and postprocessing (PASS strip, LZ77 and BWT inversion) and store
blocks (``model.n == 0``) stay on the host, in the native engine.

Also holds the host helpers of ``add`` (``prepare_payload``), shared with
the reference, so a device add and a host add write the same archive bytes.
"""

from __future__ import annotations

import bisect
import math
import sys
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

import torch

from .. import native, trace
from ..errors import ExtractError
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


def _block_sizes(src, jd, blocks) -> List[int]:
    """Each block's bytes in ``src``: ``bsize`` from the h block, or for a
    streaming-format block (``bsize`` 0, no stored size) up to the next
    block of ``jd`` or ``blocks`` in the archive, or to its end."""
    starts = sorted({b.offset for b in jd.block} | {b.offset for b in blocks})
    out = []
    for blk in blocks:
        n = blk.bsize
        if not n:
            k = bisect.bisect_right(starts, blk.offset)
            n = (starts[k] if k < len(starts) else src.size()) - blk.offset
        out.append(n)
    return out


def block_models(data, jd, blocks) -> List[Model]:
    """The model each of ``blocks`` was coded with, parsed from the first
    ``HEADER_READ`` bytes of the block (``model.n == 0``: a store block)."""
    from ..jidac.archive_io import as_source
    src = as_source(data)
    return [parse_block_payload(src.read_range(blk.offset,
                                               min(n, HEADER_READ)), 0)[0]
            for blk, n in zip(blocks, _block_sizes(src, jd, blocks))]


def decode_jidac_blocks(data, jd, blocks, device: torch.device
                        ) -> Dict[int, bytes]:
    """Decode jidac d blocks -> {block.offset: concatenated fragment bytes}.

    ``data``: archive bytes or a streaming ArchiveSource; each block's
    bytes are fetched as one bounded range: ``bsize`` from the h block, or
    for a streaming-format block (``bsize`` 0, no stored size) up to the
    next block of ``jd`` or ``blocks`` in the archive, or to its end.
    Modeled blocks run as lanes of the CM decode kernel on ``device``,
    grouped by model header; store blocks decode in the host engine."""
    from ..jidac.archive_io import as_source
    src = as_source(data)
    groups: Dict[bytes, List] = {}
    host_blocks = []
    metas = {}
    for blk, n in zip(blocks, _block_sizes(src, jd, blocks)):
        with trace.span("extract.read", bytes=n):
            model, _, payload = parse_block_payload(
                src.read_range(blk.offset, n), 0)
        metas[blk.offset] = (model, payload)
        if model.n > 0:
            groups.setdefault(model.header_bytes(), []).append(blk)
        else:
            host_blocks.append(blk)

    out: Dict[int, bytes] = {}
    for blks in groups.values():
        model = metas[blks[0].offset][0]
        decoded = decode_streams(model, [metas[b.offset][1] for b in blks],
                                 [b.usize + OUT_SLACK for b in blks], device)
        for b, d in zip(blks, decoded):
            with trace.span("extract.postprocess"):
                res = native.postprocess(model.ph, model.pm, d,
                                         out_hint=b.usize)
            if len(res) < b.usize:
                raise ExtractError(
                    f"block at {b.offset}: {len(res)} < {b.usize} bytes")
            out[b.offset] = res

    for blk in host_blocks:
        with src.stream() as s:
            s.seek(blk.offset)
            segs = s.read_block()
        if not segs:
            raise RuntimeError(f"block at {blk.offset} not found")
        out[blk.offset] = b"".join(seg.data for seg in segs)
    return out


def looks_incompressible(payload: bytes) -> bool:
    """Cheap pre-test before LZ77+model: sampled order-0 entropy as the
    fast gate, then an actual LZ77 probe over a sample window. The entropy
    test alone misclassifies LZ-redundant high-entropy data (e.g. a random
    block repeated twice is 8 bits/byte order-0 but halves under LZ77), so
    high entropy only short-circuits when the LZ probe also finds
    nothing."""
    n = len(payload)
    if n < 1 << 16:
        return False
    import collections
    step = max(1, n // (1 << 16))
    sample = payload[::step][:1 << 16]
    counts = collections.Counter(sample)
    if len(counts) < 256:
        return False
    m = len(sample)
    ent = -sum(c / m * math.log2(c / m) for c in counts.values())
    if ent <= 7.98:
        return False
    # High order-0 entropy: confirm with a real (cheap) LZ77 probe over a
    # contiguous window so long-range duplicates still get compressed.
    probe = payload[: 1 << 18]
    lz = native.lz77_encode(probe, min_match=8, depth_log=1, hash_bits=16)
    return len(lz) >= len(probe) - (len(probe) >> 6)


def prepare_payload(pre, payload: bytes) -> Tuple[bytes, bool]:
    """Apply the method's preprocessor (host side).

    Returns ``(bytes_to_code, store)``. ``store=True`` means the adaptive
    store decision fired: the ORIGINAL payload should be written as a raw
    store block instead of modeling the transformed stream (the reference's
    per-block redundancy test).

    Composite transforms (N2=5/6/7) apply E8E9 BEFORE LZ77/BWT, exactly as
    the reference LZBuffer ctor does."""
    if pre.transform in (1, 2):
        if looks_incompressible(payload):
            return payload, True
        src = native.e8e9_transform(payload) if pre.e8e9 else payload
        rb = max(0, pre.block_bits - 24)
        if pre.min_match2 or pre.lookahead or pre.use_sa or pre.chain:
            # high-ratio settings: scored parse with secondary context /
            # lookahead / suffix-array or chain search (finder 2 = dual
            # hash chains, the level-2 preset)
            lz = native.lz77_parse(
                src, pre.transform,
                min_match=max(4 if pre.transform == 1 else 1,
                              pre.min_match),
                min_match2=pre.min_match2, lookahead=pre.lookahead,
                depth_log=max(1, pre.depth_log),
                hash_bits=max(12, min(pre.hash_bits or 22, 27)),
                use_sa=1 if pre.use_sa else (2 if pre.chain else 0), rb=rb)
        elif pre.transform == 1:
            lz = native.lz77p_encode(
                src, min_match=max(4, pre.min_match),
                depth_log=max(1, pre.depth_log),
                hash_bits=max(12, min(pre.hash_bits or 22, 27)),
                rb=rb)
        else:
            lz = native.lz77_encode(
                src, min_match=max(1, pre.min_match),
                depth_log=max(1, pre.depth_log),
                hash_bits=max(12, min(pre.hash_bits or 22, 27)))
        if len(lz) >= len(payload) - (len(payload) >> 6):
            # post-test: LZ77 found nothing; store beats modeling the
            # expanded literal stream
            return payload, True
        return lz, False
    if pre.transform == 3:
        src = native.e8e9_transform(payload) if pre.e8e9 else payload
        return native.bwt_encode(src), False
    if pre.transform == 0 and pre.e8e9:
        return native.e8e9_transform(payload), False
    return payload, False


def assemble_block(model: Model, coded: bytes, name: bytes,
                   comment: bytes) -> bytes:
    """Wrap a coded segment body in the standard tagged block/segment
    framing with no stored SHA-1 (mirror of the native tzc_compress_block
    writer)."""
    return b"".join((TAG, b"zPQ", bytes([1 if model.n else 2, 1]),
                     model.header_bytes(), b"\x01", name, b"\x00", comment,
                     b"\x00\x00", coded, b"\x00\x00\x00\x00\xfe\xff"))


def encode_jidac_blocks(model: Model, pre, jobs: Iterable, date: int,
                        jdc_name, device: torch.device, max_job: int,
                        verify: bool = False, journal=None
                        ) -> Iterator[bytes]:
    """Compress jidac d-block jobs as lanes of the CM encode kernel on
    ``device``; yields the framed blocks in job order.

    Adaptive store runs per job with the host path's decision function
    (``prepare_payload``), so device adds and host adds of the same tree
    write the same archive bytes: store-chosen jobs become native store
    blocks, the rest are coded as lanes. A launch goes out as soon as the
    pending lanes fill ``lanes_per_launch``, sized once for a job of
    ``max_job`` raw bytes (the largest the planner makes), which bounds the
    payloads held in memory. ``journal`` (``jidac.add.ResumeJournal``)
    supplies blocks coded by an interrupted run and records new ones."""
    from ..jidac.add import _STORE_MODEL, job_bytes, verify_payload
    prefix = selector(model)
    step = lanes_per_launch(model, encode_lane_io(model, max_job), device)
    pending: List[Tuple[object, Optional[bytes], int]] = []
    payloads: List[bytes] = []

    def flush() -> Iterator[bytes]:
        coded = iter(encode_streams(model, payloads, device)
                     if payloads else [])
        for job, block, raw_len in pending:
            if block is None:
                with trace.span("add.assemble"):
                    block = assemble_block(
                        model, next(coded),
                        jdc_name(date, "d", job.first_frag),
                        b"%d jDC\x01" % raw_len)
                if journal is not None:
                    journal.put(job, block)
            yield block
        pending.clear()
        payloads.clear()

    for job in jobs:
        block = journal.get(job) if journal is not None else None
        raw_len = 0
        if block is None:
            with trace.span("add.prepare") as sp:
                raw = job_bytes(job)
                raw_len = len(raw)
                payload, store = prepare_payload(pre, raw)
                sp.add(raw=raw_len, coded=len(payload), store=int(store))
                if store:
                    block = native.compress_block(
                        _STORE_MODEL, raw,
                        jdc_name(date, "d", job.first_frag),
                        b"%d jDC\x01" % raw_len)
                    if journal is not None:
                        journal.put(job, block)
                else:
                    if verify:
                        verify_payload(model, pre, raw, payload,
                                       job.first_frag)
                    payloads.append(prefix + payload)
        pending.append((job, block, raw_len))
        if len(payloads) >= step:
            yield from flush()
    yield from flush()
