"""Jidac extract: decode d blocks, verify fragments, write files.

Mirrors the reference extract loop (reference ZSFX/zsfx.cpp:1647-2281):
label selected files, map fragments to blocks, decode each needed block,
verify every fragment's SHA-1 before writing, then merge consecutive
fragments into file writes and set dates/permissions last.

Blocks decode independently (format guarantee, libzpaq.h:57-59). The
device path (``decode_jidac_blocks``) decodes every modeled block as one
lane of the CUDA CM decode kernel (parallel/engine.py, ops/cm_decode.py)
and ``verify_archive`` hashes every fragment in the CUDA SHA-1 lane kernel
(ops/sha1.py). The host path (``use_device=False``) runs the block loop on
a thread pool of native decodes; ctypes releases the GIL, giving real
block-level parallelism.
``use_device=None`` asks the engine gate (device_policy.py).
"""

from __future__ import annotations

import bisect
import concurrent.futures
import os
import pathlib
from typing import Dict, List, Optional, Sequence, Tuple

from .. import native, trace
from ..errors import ExtractError
from ..zpaql.header import Model
from .archive_io import ArchiveSource, as_source
from .index import Block, Jidac, fragment_to_block

__all__ = ["ExtractError", "decode_fragments", "extract", "select_files",
           "verify_archive"]

#: decoded bytes of whole blocks that ``verify_archive`` hashes in one
#: launch of the SHA-1 lane kernel
VERIFY_BATCH_BYTES = 1 << 30


def _decode_block(src, blk: Block) -> bytes:
    """Decode one d block to its concatenated fragment bytes.

    ``src``: bytes or ArchiveSource. Each call opens its own cursor, so the
    thread pool decodes blocks concurrently with O(block) memory each
    (reference decompressThread keeps a per-thread InputArchive handle,
    zsfx.cpp:1741)."""
    with as_source(src).stream() as s:
        s.seek(blk.offset)
        segs = s.read_block()
    if not segs:
        raise ExtractError(f"block at {blk.offset} not found")
    out = b"".join(seg.data for seg in segs)
    if len(out) < blk.usize:
        raise ExtractError(
            f"block at {blk.offset}: {len(out)} < {blk.usize} bytes")
    return out


def _check_fragments(jd: Jidac, blk: Block, out: bytes) -> None:
    """Verify the block's fragment SHA-1s in one native batched call
    (two-stream SHA-NI over consecutive spans; no per-fragment slicing)."""
    from .. import native
    ends: List[int] = []
    q = 0
    for j in range(blk.start, blk.start + blk.frags):
        q += jd.ht[j].usize
        ends.append(q)
    if q > len(out):
        raise ExtractError(f"block at {blk.offset}: decoded short "
                           f"({len(out)} < {q})")
    digests = native.sha1_spans(out, ends)
    for k, j in enumerate(range(blk.start, blk.start + blk.frags)):
        want = jd.ht[j].sha1
        if want != b"\x00" * 20 and digests[k * 20:(k + 1) * 20] != want:
            raise ExtractError(f"fragment {j}: checksum failed")


def _verify_fragments(jd: Jidac, blk: Block, out: bytes) -> Dict[int, bytes]:
    """Split decoded block bytes into fragments, checking SHA-1s."""
    with trace.span("extract.verify", fragments=blk.frags, bytes=len(out)):
        _check_fragments(jd, blk, out)
        frags: Dict[int, bytes] = {}
        q = 0
        for j in range(blk.start, blk.start + blk.frags):
            usize = jd.ht[j].usize
            frags[j] = out[q:q + usize]
            q += usize
    return frags


def _date_to_unix(date: int) -> float:
    """Decimal YYYYMMDDHHMMSS UT -> unix seconds."""
    import calendar
    s = f"{date:014d}"
    t = (int(s[0:4]), int(s[4:6]), int(s[6:8]),
         int(s[8:10]), int(s[10:12]), int(s[12:14]), 0, 0, 0)
    return calendar.timegm(t)


def select_files(jd: Jidac, patterns: Sequence[str]) -> List[str]:
    """Wildcard selection with the reference's * and ? semantics
    (zsfx.cpp:606-626 ispath)."""
    import fnmatch
    names = [n for n, d in jd.dt.items() if d.date]
    if not patterns:
        return sorted(names)
    out = []
    for n in names:
        for p in patterns:
            if fnmatch.fnmatchcase(n, p) or n == p or n.startswith(p.rstrip("/") + "/"):
                out.append(n)
                break
    return sorted(out)


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
    from ..parallel import engine
    src = as_source(data)
    return [engine.parse_block_payload(
                src.read_range(blk.offset, min(n, engine.HEADER_READ)), 0)[0]
            for blk, n in zip(blocks, _block_sizes(src, jd, blocks))]


def decode_jidac_blocks(data, jd, blocks, device) -> Dict[int, bytes]:
    """Decode jidac d blocks -> {block.offset: concatenated fragment bytes}.

    ``data``: archive bytes or a streaming ArchiveSource; each block's
    bytes are fetched as one bounded range: ``bsize`` from the h block, or
    for a streaming-format block (``bsize`` 0, no stored size) up to the
    next block of ``jd`` or ``blocks`` in the archive, or to its end.
    Modeled blocks run as lanes of the CM decode kernel on ``device``
    (``engine.decode_streams``), grouped by model header; store blocks
    decode in the host engine."""
    from ..parallel import engine
    src = as_source(data)
    groups: Dict[bytes, List] = {}
    host_blocks = []
    metas = {}
    for blk, n in zip(blocks, _block_sizes(src, jd, blocks)):
        with trace.span("extract.read", bytes=n):
            model, _, payload = engine.parse_block_payload(
                src.read_range(blk.offset, n), 0)
        metas[blk.offset] = (model, payload)
        if model.n > 0:
            groups.setdefault(model.header_bytes(), []).append(blk)
        else:
            host_blocks.append(blk)

    out: Dict[int, bytes] = {}
    for blks in groups.values():
        model = metas[blks[0].offset][0]
        decoded = engine.decode_streams(
            model, [metas[b.offset][1] for b in blks],
            [b.usize + engine.OUT_SLACK for b in blks], device)
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


def _decode_on_card(data, jd: Jidac, blocks: List[Block],
                    use_device: Optional[bool], device) -> bool:
    """``use_device`` when forced; for None the engine gate's decision
    (``device_policy``) for decoding ``blocks``: its lanes are the modeled
    blocks among them (at most a launch's), its method the recorded one
    whose model coded most of them."""
    if use_device is not None:
        return use_device
    from .. import device_policy
    from ..codec.methods import make_model
    from ..parallel.engine import OUT_SLACK, gate_lanes
    models = [m for m in block_models(data, jd, blocks) if m.n > 0]
    est = sum(b.usize for b in blocks)
    if not models:
        return device_policy.resolve(None, "codec", est, lanes=0)
    heads = [m.header_bytes() for m in models]
    top = max(set(heads), key=heads.count)
    cal = device_policy.load_calibration()
    method = next((m for m in sorted(cal.get("methods", {}))
                   if make_model(m)[0].header_bytes() == top), None)
    lane_io = max(b.bsize + b.usize for b in blocks) + OUT_SLACK
    lanes = gate_lanes(models[heads.index(top)], len(models), lane_io, device)
    return device_policy.resolve(None, "codec", est, method=method,
                                 lanes=lanes)


def extract(data, jd: Jidac, to_dir: str,
            patterns: Sequence[str] = (), threads: int = 0,
            dry_run: bool = False, use_device: Optional[bool] = True,
            device=None, progress=None, rename=None) -> Tuple[int, int]:
    """Extract selected files under ``to_dir``. Returns (files, bytes).

    ``data``: archive bytes or a streaming ArchiveSource.
    ``use_device``: decode modeled blocks as lanes of the CM decode kernel
    on ``device`` (None = the CUDA card, which must be present; "cpu" = the
    kernel's plain PyTorch version). False = the host engine's thread pool.
    None = the engine gate (``device_policy``) on the needed blocks.
    ``rename``: optional name->name mapping applied to output paths (the
    reference's -find/-replace substitution, CHANGELOG.md v60 t/x)."""
    data = as_source(data)
    names = select_files(jd, patterns)
    needed_blocks: Dict[int, Block] = {}
    for n in names:
        for frag in jd.dt[n].ptr:
            b = fragment_to_block(jd, frag)
            if b is None:
                raise ExtractError(f"{n}: fragment {frag} not in any block")
            needed_blocks[b.offset] = b
    if dry_run:
        return len(names), sum(jd.dt[n].size for n in names)

    blocks = list(needed_blocks.values())
    frag_bytes: Dict[int, bytes] = {}
    threads = threads or min(32, (os.cpu_count() or 4))

    if _decode_on_card(data, jd, blocks, use_device, device):
        from ..device import resolve
        decoded = decode_jidac_blocks(data, jd, blocks, resolve(device))
        for blk in blocks:
            frag_bytes.update(_verify_fragments(jd, blk,
                                                decoded.pop(blk.offset)))
    else:
        def work(blk: Block) -> Dict[int, bytes]:
            return _verify_fragments(jd, blk, _decode_block(data, blk))

        total_u = sum(b.usize for b in blocks) or 1
        done_u = 0
        with concurrent.futures.ThreadPoolExecutor(max_workers=threads) as ex:
            for blk, result in zip(blocks, ex.map(work, blocks)):
                frag_bytes.update(result)
                done_u += blk.usize
                if progress is not None:
                    progress(done_u, total_u)

    root = pathlib.Path(to_dir)
    total = 0
    with trace.span("extract.write", files=len(names)) as sp:
        for n in names:
            d = jd.dt[n]
            out_name = rename(n) if rename else n
            path = root / out_name.lstrip("/")
            path.parent.mkdir(parents=True, exist_ok=True)
            with open(path, "wb") as f:
                for frag in d.ptr:
                    piece = frag_bytes.get(frag)
                    if piece is None:
                        raise ExtractError(f"{n}: fragment {frag} missing")
                    f.write(piece)
                    total += len(piece)
            if d.date > 19000000000000:
                ts = _date_to_unix(d.date)
                os.utime(path, (ts, ts))
            if d.attr and (d.attr & 255) == ord("u"):
                mode = (d.attr >> 8) & 0o7777
                if mode:
                    os.chmod(path, mode)
        sp.add(bytes=total)
    return len(names), total


def verify_archive(data, jd: Jidac, threads: int = 0,
                   use_device: Optional[bool] = True,
                   device=None) -> Tuple[int, int]:
    """Integrity test: decode every block, verify every fragment SHA-1
    (the reference 't' command's phase 1). Returns (blocks, fragments).

    ``use_device`` hashes every fragment in the SHA-1 lane kernel on
    ``device`` (None = the CUDA card; "cpu" = the plain PyTorch version)
    after a host decode, one launch per ``VERIFY_BATCH_BYTES`` of whole
    blocks; False = native decode+hash per block on host threads; None =
    the engine gate (``device_policy``, kind "hash") on the archive's
    bytes."""
    from .. import device_policy
    data = as_source(data)
    threads = threads or min(32, (os.cpu_count() or 4))
    if device_policy.resolve(use_device, "hash",
                             sum(b.usize for b in jd.block)):
        from ..device import resolve
        return _verify_archive_device(data, jd, threads, resolve(device))
    nfrag = 0

    def work(blk: Block) -> int:
        # fully-native decode+hash: one GIL-released call per block, no
        # decoded bytes cross ctypes (the decode -> join -> hash round
        # trip through Python cost two block-sized copies per block)
        ends: List[int] = []
        q = 0
        for j in range(blk.start, blk.start + blk.frags):
            q += jd.ht[j].usize
            ends.append(q)
        with data.stream() as s:
            s.seek(blk.offset)
            _, digests = s.verify_block(ends)
        for k, j in enumerate(range(blk.start, blk.start + blk.frags)):
            want = jd.ht[j].sha1
            if want != b"\x00" * 20 \
                    and digests[k * 20:(k + 1) * 20] != want:
                raise ExtractError(f"fragment {j}: checksum failed")
        return blk.frags

    with concurrent.futures.ThreadPoolExecutor(max_workers=threads) as ex:
        for n in ex.map(work, jd.block):
            nfrag += n
    return len(jd.block), nfrag


def _batches(jd: Jidac) -> List[List[Block]]:
    """The archive's blocks in order, cut into runs of whole blocks whose
    fragments hold at most ``VERIFY_BATCH_BYTES`` (a larger block alone)."""
    out: List[List[Block]] = []
    size = 0
    for blk in jd.block:
        n = sum(jd.ht[j].usize for j in range(blk.start,
                                               blk.start + blk.frags))
        if not out or size + n > VERIFY_BATCH_BYTES:
            out.append([])
            size = 0
        out[-1].append(blk)
        size += n
    return out


def _check_lanes(jd: Jidac, blocks: List[Block], outs: List[bytes],
                 device) -> int:
    """Hash every fragment of ``blocks`` (decoded bytes ``outs``) that has
    a stored SHA-1 as one lane of the SHA-1 kernel on ``device``, in one
    launch: the decoded blocks go over as one flat buffer (staged in pinned
    host memory), each fragment a lane (offset, length) into it. The first
    block decoded short or fragment that fails its checksum raises; returns
    the fragments hashed."""
    import torch

    from ..ops import sha1

    frag_ids: List[int] = []
    offs: List[int] = []
    lens: List[int] = []
    base = 0
    for blk, out in zip(blocks, outs):
        q = base
        for j in range(blk.start, blk.start + blk.frags):
            usize = jd.ht[j].usize
            if jd.ht[j].sha1 != b"\x00" * 20:
                frag_ids.append(j)
                offs.append(q)
                lens.append(usize)
            q += usize
        if q - base > len(out):
            raise ExtractError(f"block at {blk.offset}: fragments incomplete")
        base += len(out)
    with trace.span("verify.stage", pinned=base):
        flat = sha1.stage_bytes(outs, device)
    with trace.span("verify.hash", fragments=len(frag_ids)) as sp:
        if trace.enabled():
            sp.add(bytes=sum(lens))
        states = sha1.sha1_lanes(
            flat, torch.tensor(offs, dtype=torch.int64).to(device),
            torch.tensor(lens, dtype=torch.int64).to(device))
        for j, dig in zip(frag_ids, sha1.to_digests(states)):
            if dig != jd.ht[j].sha1:
                raise ExtractError(f"fragment {j}: checksum failed")
    return len(frag_ids)


def _verify_archive_device(data, jd: Jidac, threads: int,
                           device) -> Tuple[int, int]:
    """Decode blocks on host threads and hash their fragments in the SHA-1
    lane kernel on ``device`` (``_check_lanes``), one launch per batch of
    whole blocks of at most ``VERIFY_BATCH_BYTES``. The next batch decodes
    while the current one hashes, so host memory holds about two batches.
    Blocks and fragments are checked in archive order: the first block that
    fails to decode or fragment that fails its checksum raises."""
    batches = _batches(jd)
    nfrag = 0
    with trace.span("verify", threads=threads, batches=len(batches),
                    blocks=len(jd.block)) as parent, \
            concurrent.futures.ThreadPoolExecutor(max_workers=threads) as ex:
        def decode(blk: Block) -> bytes:
            with trace.span("verify.decode", parent=parent,
                            usize=blk.usize):
                return _decode_block(data, blk)

        pending = ([ex.submit(decode, b) for b in batches[0]]
                   if batches else [])
        for k, blocks in enumerate(batches):
            with trace.span("verify.decode_wait"):
                outs = [f.result() for f in pending]
            pending = ([ex.submit(decode, b) for b in batches[k + 1]]
                       if k + 1 < len(batches) else [])
            try:
                nfrag += _check_lanes(jd, blocks, outs, device)
            except BaseException:
                for f in pending:
                    f.cancel()
                raise
            del outs
    return len(jd.block), nfrag


def decode_fragments(data, jd: Jidac, use_device: Optional[bool] = True,
                     device=None) -> Dict[int, bytes]:
    """Every block of the archive decoded and cut into its fragments, each
    fragment's SHA-1 checked: {fragment id: bytes} (``p`` and ``c``).

    ``use_device``: decode modeled blocks as lanes of the CM decode kernel
    on ``device`` (None = the CUDA card, which must be present; "cpu" = the
    plain PyTorch versions), as ``extract`` does, and hash the fragments in
    the SHA-1 lane kernel, one launch per batch of whole blocks of at most
    ``VERIFY_BATCH_BYTES``, as ``verify_archive`` does. False = the host
    engine, block by block, with the native SHA-1, as the reference's
    ``p``. None = the engine gate (``device_policy``), as ``extract``."""
    data = as_source(data)
    frag_bytes: Dict[int, bytes] = {}
    if not _decode_on_card(data, jd, jd.block, use_device, device):
        for blk in jd.block:
            frag_bytes.update(_verify_fragments(jd, blk,
                                                _decode_block(data, blk)))
        return frag_bytes
    from ..device import resolve
    dev = resolve(device)
    decoded = decode_jidac_blocks(data, jd, jd.block, dev)
    for blocks in _batches(jd):
        outs = [decoded.pop(b.offset) for b in blocks]
        _check_lanes(jd, blocks, outs, dev)
        for blk, out in zip(blocks, outs):
            q = 0
            for j in range(blk.start, blk.start + blk.frags):
                frag_bytes[j] = out[q:q + jd.ht[j].usize]
                q += jd.ht[j].usize
    return frag_bytes
