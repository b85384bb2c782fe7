"""Jidac add: scan, fragment, dedup, compress, append one transaction.

The write path of the journaling archiver (reference behavior reconstructed
from the format written by read_archive/zsfx.cpp:1283-1627 and the add()
call stack in SURVEY.md section 3.1):

  scan filesystem -> diff against the index (date+size) -> CDC fragmenting
  (native rolling hash) -> SHA-1 dedup -> pack new fragments into d blocks
  -> compress blocks -> append  c + d... + h... + i...  as one transaction.

``code_jobs`` codes the d blocks through one ordered window of host
threads: modeled blocks (-m3..-m5) as lanes of the CUDA CM encode kernel
(parallel/engine.py, ops/cm_encode.py) unless the caller, or for an
unforced run the engine gate (device_policy.py), asks for the host engine,
which codes them through the native engine on those threads; both write
the same bytes. Every emitted block is a standard ZPAQ block, so reference
zpaqfranz can list/extract our archives.

The pipeline is factored into stages (open_for_append / diff_index /
FragmentPlanner / build_transaction / commit_transaction).
"""

from __future__ import annotations

import datetime
import math
import os
import pathlib
import struct
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import (Deque, Dict, Iterable, Iterator, List, Optional,
                    Sequence, Tuple)

from .. import native, trace
from ..codec.methods import MethodError, make_model
from ..zpaql.header import Model
from .index import DT, HT, Jidac, read_archive


class AddError(RuntimeError):
    pass


def expand_parts(spec: str) -> Tuple[List[str], "object"]:
    """Multipart archive spec ('*' or '?' wildcards) -> (existing parts in
    order, namer(n) for new parts). Reference semantics: subpart
    (zsfx.cpp:413-421): wildcards are replaced by the part number, padded
    to the wildcard width."""
    import glob
    import re
    m = re.search(r"[*?]+", spec)
    if not m:
        return ([spec] if pathlib.Path(spec).exists() else []), None
    width = len(m.group(0))
    existing = sorted(glob.glob(spec))

    def namer(n: int) -> str:
        num = str(n).zfill(max(width, 1))
        return spec[:m.start()] + num + spec[m.end():]

    return existing, namer


def now_date() -> int:
    """Current UTC time as decimal YYYYMMDDHHMMSS."""
    t = datetime.datetime.now(datetime.timezone.utc)
    return (t.year * 10**10 + t.month * 10**8 + t.day * 10**6
            + t.hour * 10**4 + t.minute * 100 + t.second)


def unix_to_date(ts: float) -> int:
    t = datetime.datetime.fromtimestamp(ts, datetime.timezone.utc)
    return (t.year * 10**10 + t.month * 10**8 + t.day * 10**6
            + t.hour * 10**4 + t.minute * 100 + t.second)


def _file_attr(st: os.stat_result) -> int:
    """'u' + low 16 mode bits, the reference's unix attr encoding."""
    return ord("u") | ((st.st_mode & 0xFFFF) << 8)


def scan_files(paths: Sequence[str]) -> Dict[str, Tuple[int, int, int]]:
    """Recursive scan -> {relative name: (date, size, attr)}."""
    out: Dict[str, Tuple[int, int, int]] = {}
    for p in paths:
        root = pathlib.Path(p)
        if root.is_file():
            st = root.stat()
            out[str(root).replace("\\", "/").lstrip("./")] = (
                unix_to_date(st.st_mtime), st.st_size, _file_attr(st))
        elif root.is_dir():
            for dirpath, dirnames, filenames in os.walk(root):
                dirnames.sort()
                for fn in sorted(filenames):
                    full = pathlib.Path(dirpath) / fn
                    try:
                        st = full.stat()
                    except OSError:
                        continue
                    name = str(full).replace("\\", "/").lstrip("./")
                    out[name] = (unix_to_date(st.st_mtime), st.st_size,
                                 _file_attr(st))
    return out


def _jdc_name(date: int, typ: str, num: int) -> bytes:
    return b"jDC" + f"{date:014d}{typ}{num:010d}".encode()


@dataclass
class _Job:
    """One d block to compress: fragment IDs + concatenated bytes.

    ``data`` holds the bytes on the single-host path; the distributed path
    carries ``spans`` [(file name, start, end)] instead and the compressing
    host materializes the bytes from shared storage."""

    first_frag: int
    frags: List[Tuple[bytes, int]]   # (sha1, usize) per fragment
    data: bytearray
    spans: List[Tuple[str, int, int]] = field(default_factory=list)


_STORE_MODEL = Model(hh=0, hm=0)


def block_model(model: Optional[Model], store: bool) -> Model:
    """The model a block is coded with: the method's, or the store model
    where the store test fired (``prepare_payload``) or the method has
    none."""
    return _STORE_MODEL if store or model is None else model


def verify_payload(model: Optional[Model], pre, raw: bytes, payload: bytes,
                   first_frag: int) -> None:
    """setVerify analog: invert the preprocessor via the SAME stored pcomp
    the decoder will run, and require byte equality with the original."""
    blob = model.pcomp_bytes() if model is not None else b""
    prefix = (b"\x01" + blob) if blob else b"\x00"
    ph = model.ph if model is not None else 0
    pm = model.pm if model is not None else 0
    back = native.postprocess(ph, pm, prefix + payload, out_hint=len(raw))
    if back != raw:
        raise AddError(
            f"verify failed: block at fragment {first_frag} does not "
            f"invert ({len(back)} vs {len(raw)} bytes)")


# ---------------------------------------------------------------------------
# Stage 1: open the archive for append (index load, trim, crypto state)
# ---------------------------------------------------------------------------

@dataclass
class AppendCtx:
    """Everything commit_transaction needs to append one transaction."""

    archive: str
    jd: Jidac
    parts: List[str]
    part_namer: Optional[object]
    path: pathlib.Path
    existing_len: int = 0
    trimmed: int = 0
    salt: Optional[bytes] = None
    key: Optional[str] = None

    @property
    def multipart(self) -> bool:
        return self.part_namer is not None


def open_for_append(archive: str, key: Optional[str] = None,
                    notrim: bool = False,
                    index_path: Optional[str] = None) -> AppendCtx:
    """Load the existing index (trimming a trailing bad transaction per the
    reference default, CHANGELOG.md:360-376) and capture crypto/multipart
    state for the final append.

    The index scan streams through a file-backed source (decrypt-at-offset,
    d blocks skipped via csize jumps), so appending to a TB-scale archive
    needs O(index) memory — the archive is never read into RAM except in
    the rare damaged-tail probe."""
    from ..codec import crypto
    from .archive_io import ArchiveSource
    parts, part_namer = expand_parts(archive)
    multipart = part_namer is not None
    existing_len = sum(os.path.getsize(p) for p in parts)
    path = pathlib.Path(parts[-1]) if parts else pathlib.Path(
        part_namer(1) if multipart else archive)
    salt = None
    if key is not None:
        if existing_len:
            with open(parts[0], "rb") as f:
                salt = f.read(crypto.SALT_LEN)
            if len(salt) < crypto.SALT_LEN:
                raise AddError("archive too short for salt header")
        else:
            salt = crypto.new_salt()
    trimmed = 0
    if existing_len:
        src = ArchiveSource(
            paths=parts,
            key32=crypto.stretch_key(key, salt) if key is not None else None)
        if key is not None:
            head = src.read_range(0, 4)
            ok = (head[:4] == b"7kSt"
                  or (head[:3] == b"zPQ" and len(head) > 3 and head[3] >= 1))
            if not ok:
                raise AddError("password incorrect (bad archive magic)")
        from .index import read_archive_src
        with trace.span("jidac.index") as sp:
            jd = read_archive_src(src)
            sp.add(blocks=len(jd.block), fragments=len(jd.ht))
        plain_len = src.size()
        if not notrim and not multipart:
            # Auto-trim of a trailing bad transaction (reference default,
            # CHANGELOG.md:360-376). Three damage shapes:
            #  - trailing non-block garbage: csize stops short of the end
            #  - truncated/garbled tail blocks: the error consumed the
            #    rest of the stream; cut at the first error IF everything
            #    before it is clean (mid-archive damage is NOT trimmed —
            #    skip-and-continue already read past it)
            #  - a half-written transaction (c/d/h landed, i did not):
            #    drop the dangling version entirely
            cut = min(jd.csize, plain_len)
            needs_probe = (jd.errors and 0 <= jd.first_error < cut) or (
                len(jd.ver) > 1 and jd.ver[-1].csize >= 0
                and jd.ver[-1].updates == 0 and jd.ver[-1].deletes == 0)
            if needs_probe:
                # rare damaged-tail path: probing prefixes needs sliced
                # re-scans, so materialize the plaintext once
                plain = src.bytes()
                if jd.errors and 0 <= jd.first_error < cut:
                    probe = read_archive(plain[:jd.first_error])
                    if probe.errors == 0 and probe.csize == jd.first_error:
                        cut, jd = jd.first_error, probe
                while (len(jd.ver) > 1 and jd.ver[-1].csize >= 0
                       and jd.ver[-1].updates == 0
                       and jd.ver[-1].deletes == 0):
                    cut = jd.ver[-1].offset
                    jd = read_archive(plain[:cut])
            if cut < plain_len:
                trimmed = plain_len - cut
    elif index_path and pathlib.Path(index_path).exists():
        # remote-archive mode: dedup against the detached index alone
        jd = read_archive(pathlib.Path(index_path).read_bytes())
    else:
        jd = Jidac()
    return AppendCtx(archive=archive, jd=jd, parts=parts,
                     part_namer=part_namer, path=path,
                     existing_len=existing_len, trimmed=trimmed,
                     salt=salt, key=key)


# ---------------------------------------------------------------------------
# Stage 2: diff the filesystem against the index
# ---------------------------------------------------------------------------

def diff_index(jd: Jidac, ext: Dict[str, Tuple[int, int, int]],
               files: Sequence[str]) -> Tuple[List[str], List[str]]:
    """-> (changed file names sorted, deleted file names sorted)."""
    changed: List[str] = []
    deleted: List[str] = []
    for name, (fdate, fsize, fattr) in sorted(ext.items()):
        d = jd.dt.get(name)
        if d is None or d.date != fdate or d.size != fsize:
            changed.append(name)
    for name, d in sorted(jd.dt.items()):
        if d.date and name not in ext and _under_any(name, files):
            deleted.append(name)
    return changed, deleted


# ---------------------------------------------------------------------------
# Stage 3: deterministic fragment-ID assignment and d-block packing
# ---------------------------------------------------------------------------

#: room a BWT block (transform 3) leaves below 2^block_bits: its stored
#: postprocessor buffers the n + 5 input bytes in M and 256 + n + 8 cells
#: in H, both of 2^block_bits entries (``bwt_pcomp_source``)
BWT_SLACK = 4096


def block_cap(pre) -> int:
    """Raw bytes at which a d-block job closes. A BWT job closes before it
    would pass the cap, so that its block decodes by its own header
    (``ph = pm = block_bits``); any other job once it reaches the cap."""
    cap = min(1 << pre.block_bits, 1 << 24)
    if pre.transform == 3:
        cap = min(cap, (1 << pre.block_bits) - BWT_SLACK)
    return cap


def max_fragment_bytes(fragment_bits: int) -> int:
    """The native CDC's longest fragment: 8x its mean (2^fragment_bits, at
    least 2^6) plus 4 KiB."""
    return (8 << max(fragment_bits, 6)) + 4096


def max_job_bytes(pre, fragment_bits: int) -> int:
    """Most raw bytes a ``FragmentPlanner`` job can hold: ``block_cap`` for
    a BWT job, else within one fragment past the cap. Raises
    ``MethodError`` for a BWT method whose block a single fragment could
    outgrow (a ``-fragment`` whose largest fragment passes the cap), so an
    add refuses it before anything is written."""
    cap = block_cap(pre)
    if pre.transform == 3:
        if max_fragment_bytes(fragment_bits) > cap:
            raise MethodError(
                f"a fragment of up to {max_fragment_bytes(fragment_bits)} "
                f"bytes does not fit a BWT block of {cap}: use a smaller "
                "-fragment or larger blocks")
        return cap
    return cap - 1 + max_fragment_bytes(fragment_bits)


class FragmentPlanner:
    """Replays the serial dedup/packing decision: fragments are offered in
    global file order; new hashes get ascending IDs; jobs close at the
    method's ``block_cap``. Both the single-host add() and every host of
    the distributed add run this identical logic, which is what makes
    archive bytes host-count invariant (SURVEY.md section 7 hard part 6)."""

    def __init__(self, dedup: Dict[bytes, int], next_frag: int, pre,
                 keep_bytes: bool = True):
        self.dedup = dedup
        self.next_frag = next_frag
        self.block_cap = block_cap(pre)
        self.bounded = pre.transform == 3
        self.keep_bytes = keep_bytes
        self.first_frag = next_frag
        self.new_ht: List[HT] = []
        self.file_ptrs: Dict[str, List[int]] = {}
        self.cur = _Job(first_frag=next_frag, frags=[], data=bytearray())
        self._cur_bytes = 0

    def _close(self) -> _Job:
        job = self.cur
        self.cur = _Job(first_frag=self.next_frag, frags=[], data=bytearray())
        self._cur_bytes = 0
        return job

    def add_file(self, name: str, frags: Sequence[Tuple[bytes, int, int]],
                 data: Optional[bytes]) -> List[_Job]:
        """Offer one file's fragments [(sha1, start, end)]; returns any jobs
        that filled up (caller compresses/queues them)."""
        done: List[_Job] = []
        ptrs: List[int] = []
        for sha, start, end in frags:
            fid = self.dedup.get(sha)
            if fid is None:
                if (self.bounded and self.cur.frags and
                        self._cur_bytes + end - start > self.block_cap):
                    done.append(self._close())
                fid = self.next_frag
                self.next_frag += 1
                self.dedup[sha] = fid
                self.new_ht.append(HT(sha, end - start))
                self.cur.frags.append((sha, end - start))
                if self.keep_bytes:
                    self.cur.data += data[start:end]
                self.cur.spans.append((name, start, end))
                self._cur_bytes += end - start
                if self._cur_bytes >= self.block_cap:
                    done.append(self._close())
            ptrs.append(fid)
        self.file_ptrs[name] = ptrs
        return done

    def finish(self) -> Optional[_Job]:
        return self.cur if self.cur.frags else None


def job_bytes(job: _Job) -> bytes:
    """Materialize a span-carrying job's data from (shared) storage."""
    if job.data:
        return bytes(job.data)
    out = bytearray()
    handles: Dict[str, object] = {}
    try:
        for name, start, end in job.spans:
            f = handles.get(name)
            if f is None:
                f = handles[name] = open(name, "rb")
            f.seek(start)
            out += f.read(end - start)
    finally:
        for f in handles.values():
            f.close()
    return bytes(out)


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


def prepare_payload(pre, payload: bytes, bwt=None) -> Tuple[bytes, bool]:
    """Apply the method's preprocessor.

    Returns ``(bytes_to_code, store)``. ``store=True`` means the adaptive
    store decision fired: the ORIGINAL payload should be written as a raw
    store block instead of modeling the transformed stream (the reference's
    per-block redundancy test).

    Composite transforms (N2=5/6/7) apply E8E9 BEFORE LZ77/BWT, exactly as
    the reference LZBuffer ctor does, on the host. With ``bwt`` (the card
    add's ``pre/bwt_device.BatchedBwt``) the BWT's suffix sort runs on its
    device, else on the host (``native.bwt_encode``); both give the same
    bytes. The ``pre.bwt`` span counts ``card`` (1 on the device), the
    prefix doubling's ``rounds`` and the jobs sorted in its ``batch`` (0
    on the host)."""
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
        with trace.span("pre.bwt", bytes=len(payload)) as sp:
            src = native.e8e9_transform(payload) if pre.e8e9 else payload
            if bwt is None:
                sp.add(card=0, rounds=0, batch=0)
                return native.bwt_encode(src), False
            out, rounds, batch = bwt.encode(src)
            sp.add(card=1, rounds=rounds, batch=batch)
            return out, False
    if pre.transform == 0 and pre.e8e9:
        return native.e8e9_transform(payload), False
    return payload, False


def code_jobs(model: Optional[Model], pre, jobs: Iterable[_Job], date: int,
              device, max_job: int, threads: int, verify: bool = False,
              journal: Optional["ResumeJournal"] = None) -> Iterator[bytes]:
    """Code d-block jobs; yields each job's framed d block in job order.

    Each job is prepared on a pool of ``threads`` workers, at most twice
    that many jobs ahead of the oldest job not yet taken: its bytes
    (``job_bytes``), the preprocessor and the store test
    (``prepare_payload``; on ``device`` a BWT's suffix sort, the jobs
    waiting sorted together) and ``verify`` (``verify_payload``). A store block, and with ``device``
    None every block (the host engine), is coded by the native engine on
    the pool. On ``device`` a modeled job becomes a lane of the CM encode
    kernel: a launch goes out once the pending lanes fill
    ``lanes_per_launch``, sized for a job of ``max_job`` raw bytes (the
    largest the planner makes), which bounds the payloads held in memory.
    Results are taken in job order, so the lanes, the
    launches and every byte written are the same for any pool, and both
    engines write the same bytes; a job's error is raised when it is the
    oldest. ``journal`` supplies blocks coded by an interrupted run and
    records new ones."""
    bwt = None
    if device is not None:
        from ..parallel import engine
        prefix = engine.selector(model)
        step = engine.lanes_per_launch(
            model, engine.encode_lane_io(model, max_job), device)
        if pre.transform == 3:
            from ..pre.bwt_device import BatchedBwt
            bwt = BatchedBwt(device)
    parent = trace.current()
    pool = ThreadPoolExecutor(max_workers=threads)
    # (job, its journal block, else the future of its preparation)
    ahead: Deque[Tuple[_Job, Optional[bytes], Optional[Future]]] = deque()
    # the jobs since the oldest lane not yet coded: (job, block or None,
    # the block's name and comment)
    pending: List[Tuple[_Job, Optional[bytes],
                        Optional[Tuple[bytes, bytes]]]] = []
    payloads: List[bytes] = []

    def prepare(job: _Job) -> Tuple[Tuple[bytes, bytes], bytes, bool]:
        """(the block's name and comment, the block or the lane's payload,
        whether it is the block)"""
        with trace.span("add.prepare", parent=parent) as sp:
            raw = job_bytes(job)
            payload, store = prepare_payload(pre, raw, bwt)
            sp.add(raw=len(raw), coded=len(payload), store=int(store))
            if verify and not store:
                verify_payload(model, pre, raw, payload, job.first_frag)
        label = (_jdc_name(date, "d", job.first_frag),
                 b"%d jDC\x01" % len(raw))
        if store or device is None:
            return label, native.compress_block(
                block_model(model, store), payload, *label), True
        return label, prefix + payload, False

    def take() -> Iterator[bytes]:
        """The oldest job's block, or its lane; a launch once the lanes
        fill one"""
        job, block, fut = ahead.popleft()
        label = None
        if block is None:
            with trace.span("add.prepare_wait", ready=int(fut.done())):
                label, out, is_block = fut.result()
            if is_block:
                block = out
                if journal is not None:
                    journal.put(job, block)
            else:
                payloads.append(out)
        if not payloads:
            yield block
            return
        pending.append((job, block, label))
        if len(payloads) >= step:
            yield from launch()

    def launch() -> Iterator[bytes]:
        coded = iter(engine.encode_streams(model, payloads, device))
        for job, block, label in pending:
            if block is None:
                with trace.span("add.assemble"):
                    block = engine.assemble_block(model, next(coded), *label)
                if journal is not None:
                    journal.put(job, block)
            yield block
        pending.clear()
        payloads.clear()

    def ready() -> bool:
        _job, block, fut = ahead[0]
        return block is not None or fut.done()

    try:
        for job in jobs:
            block = journal.get(job) if journal is not None else None
            ahead.append((job, block, None if block is not None
                          else pool.submit(prepare, job)))
            while ahead and (len(ahead) >= 2 * threads or ready()):
                yield from take()
        while ahead:
            yield from take()
        if payloads:
            yield from launch()
    finally:
        for _job, _block, fut in ahead:
            if fut is not None:
                fut.cancel()
        pool.shutdown(wait=False)


# ---------------------------------------------------------------------------
# Stage 4: transaction assembly (c + d... + h... + i)
# ---------------------------------------------------------------------------

class DBlockSpill:
    """Bounded-RAM d-block staging (reference parity: job threads append
    compressed blocks as they finish — libzpaq.h:57-59 block independence,
    zsfx.cpp:1731-1801 shows the streaming twin on extract. Round-3 review
    flagged that we materialized every d block plus the whole transaction
    in RAM, ~archive-sized for a 100 GB add).

    Compressed d blocks are appended to a sidecar spill file in job order
    and freed immediately; only their lengths stay in memory (the h blocks
    need them). The commit streams c + spill + h + i to the archive in
    chunks, so peak RSS is O(jobs in flight), not O(archive)."""

    def __init__(self, path: pathlib.Path):
        self.path = path
        self._f = open(path, "wb")
        self.lengths: List[int] = []

    def append(self, dblk: bytes) -> None:
        self._f.write(dblk)
        self.lengths.append(len(dblk))

    @property
    def csize(self) -> int:
        return sum(self.lengths)

    def chunks(self, chunk: int = 8 << 20):
        self._f.flush()
        with open(self.path, "rb") as f:
            while True:
                piece = f.read(chunk)
                if not piece:
                    return
                yield piece

    def close(self) -> None:
        try:
            self._f.close()
            self.path.unlink()
        except OSError:
            pass


def stream_transaction(date: int, jobs: Sequence[_Job], spill: DBlockSpill,
                       changed: Sequence[str], deleted: Sequence[str],
                       ext: Dict[str, Tuple[int, int, int]],
                       file_sums: Dict[str, Tuple[int, int]],
                       file_ptrs: Dict[str, List[int]],
                       first_frag: int,
                       franz: str = "xxhash64"):
    """Yield transaction pieces (c, d..., h..., i) without materializing
    the whole transaction; also returns the small index copy (c+h+i, no d)
    via the generator's final attribute — call collect_index() after
    draining. Layouts identical to build_transaction."""
    ix = bytearray()
    store = _STORE_MODEL
    cbody = struct.pack("<q", spill.csize)
    cblk = native.compress_block(
        store, cbody, _jdc_name(date, "c", first_frag),
        b"%d jDC\x01" % len(cbody))
    ix += cblk
    yield cblk
    yield from spill.chunks()
    for job, dlen in zip(jobs, spill.lengths):
        body = bytearray(struct.pack("<I", dlen))
        for sha, usize in job.frags:
            body += sha + struct.pack("<I", usize)
        hblk = native.compress_block(
            store, bytes(body), _jdc_name(date, "h", job.first_frag),
            b"%d jDC\x01" % len(body))
        ix += hblk
        yield hblk
    ibody = bytearray()
    for name in deleted:
        ibody += struct.pack("<q", 0) + name.encode() + b"\x00"
    for name in changed:
        fdate, fsize, fattr = ext[name]
        ibody += struct.pack("<q", fdate) + name.encode() + b"\x00"
        base = bytes([fattr & 255, (fattr >> 8) & 255, (fattr >> 16) & 255])
        if franz == "text":
            base = base.ljust(8, b"\x00")   # text FRANZBLOCK: 8+50 attrs
        attr_bytes = base + _franz_block(franz, file_sums.get(name))
        ibody += struct.pack("<I", len(attr_bytes)) + attr_bytes
        ptrs = file_ptrs[name]
        ibody += struct.pack("<I", len(ptrs))
        ibody += struct.pack(f"<{len(ptrs)}I", *ptrs)
    iblk = native.compress_block(
        store, bytes(ibody), _jdc_name(date, "i", first_frag),
        b"%d jDC\x01" % len(ibody))
    ix += iblk
    yield iblk
    spill.index_bytes = bytes(ix)   # picked up by the caller post-drain


def build_transaction(date: int, jobs: Sequence[_Job],
                      d_blocks: Sequence[bytes],
                      changed: Sequence[str], deleted: Sequence[str],
                      ext: Dict[str, Tuple[int, int, int]],
                      file_sums: Dict[str, Tuple[int, int]],
                      file_ptrs: Dict[str, List[int]],
                      first_frag: int,
                      franz: str = "xxhash64") -> Tuple[bytes, bytes]:
    """-> (transaction bytes, detached-index copy without d blocks)."""
    out = bytearray()
    ix = bytearray()
    csize = sum(len(b) for b in d_blocks)
    cbody = struct.pack("<q", csize)
    cname = _jdc_name(date, "c", first_frag)
    store = _STORE_MODEL
    cblk = native.compress_block(
        store, cbody, cname, b"%d jDC\x01" % len(cbody))
    out += cblk
    ix += cblk
    for b in d_blocks:
        out += b
    for job, dblk in zip(jobs, d_blocks):
        body = bytearray(struct.pack("<I", len(dblk)))
        for sha, usize in job.frags:
            body += sha + struct.pack("<I", usize)
        hname = _jdc_name(date, "h", job.first_frag)
        hblk = native.compress_block(
            store, bytes(body), hname, b"%d jDC\x01" % len(body))
        out += hblk
        ix += hblk
    ibody = bytearray()
    for name in deleted:
        ibody += struct.pack("<q", 0) + name.encode() + b"\x00"
    for name in changed:
        fdate, fsize, fattr = ext[name]
        ibody += struct.pack("<q", fdate) + name.encode() + b"\x00"
        base = bytes([fattr & 255, (fattr >> 8) & 255, (fattr >> 16) & 255])
        if franz == "text":
            base = base.ljust(8, b"\x00")   # text FRANZBLOCK: 8+50 attrs
        attr_bytes = base + _franz_block(franz, file_sums.get(name))
        ibody += struct.pack("<I", len(attr_bytes)) + attr_bytes
        ptrs = file_ptrs[name]
        ibody += struct.pack("<I", len(ptrs))
        ibody += struct.pack(f"<{len(ptrs)}I", *ptrs)
    iname = _jdc_name(date, "i", first_frag)
    iblk = native.compress_block(
        store, bytes(ibody), iname, b"%d jDC\x01" % len(ibody))
    out += iblk
    ix += iblk
    return bytes(out), bytes(ix)


def _franz_block(franz: str, sums: Optional[Tuple[int, int]]) -> bytes:
    """Per-file checksum record appended after the base attr bytes
    (the reference FRANZBLOCK, CHANGELOG.md:670-707; readers that use only
    the low 8 attr bytes skip it, zsfx.cpp:1525-1528 reads-and-ignores).

    Three forms (see FORMAT.md "FRANZBLOCK"):
    - '715': nothing (pure-zpaq output, reference -715, CHANGELOG.md:484)
    - 'xxhash64' (default): compact binary b"fz" + crc32[4 LE] + xxh64[8 LE]
      — this framework's dialect filling the v60 "binary FRANZBLOCK" role
      (the reference v60 byte layout lives only in the stripped
      zpaqfranz.cpp, so it cannot be byte-matched from this snapshot)
    - 'text': the classic v55-era TEXT layout, FRANZOFFSET = 50 bytes:
      40 hex chars of the alt hash (XXHASH64 zero-padded) + NUL +
      8 hex chars of CRC-32 + NUL (40+1+8+1 = 50 exactly — the geometry
      the public FRANZOFFSET constant encodes). The caller pads base
      attrs to 8 bytes first, giving the documented 8+50 attr size."""
    if franz == "715" or sums is None:
        return b""
    crc, xxh = sums
    if franz == "text":
        area = b"%040X\x00%08X\x00" % (xxh, crc)
        assert len(area) == 50
        return area
    return b"fz" + struct.pack("<I", crc) + struct.pack("<Q", xxh)


# ---------------------------------------------------------------------------
# Stage 5: commit (encrypt + write/append)
# ---------------------------------------------------------------------------

def commit_transaction_stream(ctx: AppendCtx, pieces, ix_done,
                              chunk: int = 0, tmp: bool = False,
                              index_path: Optional[str] = None) -> int:
    """Streaming commit: write transaction pieces to the archive in order,
    encrypting chunk-by-chunk at the running absolute offset (CTR is
    position-keyed, so chunking changes nothing). Returns bytes written.

    ``ix_done()`` is called after the pieces are drained and must return
    the detached-index bytes (c+h+i) for -index."""
    from ..codec import crypto
    disk_end = ctx.existing_len - ctx.trimmed
    cipher = None
    if ctx.key is not None:
        cipher = crypto.Cipher.from_password(ctx.key, ctx.salt)

    total = 0

    def encrypted():
        nonlocal total
        if ctx.key is not None and not ctx.existing_len:
            yield ctx.salt
        off = disk_end if ctx.existing_len else crypto.SALT_LEN
        for piece in pieces:
            total += len(piece)
            if cipher is not None:
                piece = cipher.crypt(piece, off)
            off += len(piece)
            yield piece

    if ctx.multipart:
        # one new part per transaction; -chunk caps each part's size,
        # continuing the numbering mid-transaction
        part_no = len(ctx.parts) + 1
        f = open(ctx.part_namer(part_no), "wb")
        written = 0
        try:
            for piece in encrypted():
                while chunk and written + len(piece) > chunk:
                    take = chunk - written
                    f.write(piece[:take])
                    piece = piece[take:]
                    f.close()
                    part_no += 1
                    f = open(ctx.part_namer(part_no), "wb")
                    written = 0
                f.write(piece)
                written += len(piece)
        finally:
            f.close()
    elif not ctx.path.exists():
        target = (ctx.path.with_name(ctx.path.name + ".tmp")
                  if tmp else ctx.path)
        with open(target, "wb") as f:
            for piece in encrypted():
                f.write(piece)
        if tmp:
            target.replace(ctx.path)
    else:
        with open(ctx.path, "r+b") as f:
            if ctx.trimmed:
                f.truncate(disk_end)
            f.seek(0, 2)
            for piece in encrypted():
                f.write(piece)
    if index_path:
        from .index import INDEX_MAGIC
        ipath = pathlib.Path(index_path)
        if not ipath.exists():
            ipath.write_bytes(INDEX_MAGIC)
        with open(ipath, "ab") as f:
            f.write(ix_done())
    return total


def commit_transaction(ctx: AppendCtx, out: bytes, ix: bytes,
                       chunk: int = 0, tmp: bool = False,
                       index_path: Optional[str] = None) -> None:
    from ..codec import crypto
    disk_end = ctx.existing_len - ctx.trimmed
    if ctx.key is not None:
        if not ctx.existing_len:
            payload = ctx.salt + crypto.encrypt_append(
                out, ctx.key, ctx.salt, crypto.SALT_LEN)
        else:
            payload = crypto.encrypt_append(out, ctx.key, ctx.salt, disk_end)
    else:
        payload = out
    if ctx.multipart:
        # one new part per transaction (reference: parts are rsync-friendly
        # append units; `m`/consolidate merges them); -chunk caps each
        # part's size, continuing the numbering mid-transaction
        pieces = ([payload[i:i + chunk] for i in range(0, len(payload),
                                                       chunk)]
                  if chunk else [payload])
        for k, piece in enumerate(pieces):
            with open(ctx.part_namer(len(ctx.parts) + 1 + k), "wb") as f:
                f.write(piece)
    elif not ctx.path.exists():
        if tmp:
            tpath = ctx.path.with_name(ctx.path.name + ".tmp")
            tpath.write_bytes(payload)
            tpath.replace(ctx.path)
        else:
            ctx.path.write_bytes(payload)
    else:
        with open(ctx.path, "r+b") as f:
            if ctx.trimmed:
                f.truncate(disk_end)
            f.seek(0, 2)
            f.write(payload)
    if index_path:
        from .index import INDEX_MAGIC
        ipath = pathlib.Path(index_path)
        if not ipath.exists():
            ipath.write_bytes(INDEX_MAGIC)
        with open(ipath, "ab") as f:
            f.write(ix)


def add_streaming(ctx: AppendCtx, model, pre, changed: Sequence[str],
                  ext: Dict[str, Tuple[int, int, int]], block_cap: int,
                  tmp: bool = False, progress=None) -> Tuple[int, int, int]:
    """Streaming-format (`s` method) archive writes: one ZPAQ block per
    ≤block_cap chunk of each file, the file name in its first segment, no
    jidac c/d/h/i framing or dedup (reference read side zsfx.cpp:1550-1587;
    the zpaq 7.15 streaming format the journaling format is backward-
    compatible with). Deletions are not representable in this format.

    Segment comment is ``"<size> <YYYYMMDDHHMMSS>"`` (decimal uncompressed
    size + file date), the zpaq streaming convention our reader parses
    back. Each block carries the SHA-1 of its decoded bytes."""
    import hashlib

    counts = [0, 0]     # blocks, logical bytes

    def pieces():
        for name in changed:
            fdate = ext[name][0]
            first = True
            with open(name, "rb") as f:
                while True:
                    chunk = f.read(block_cap)
                    if not chunk and not first:
                        break
                    payload, store = (prepare_payload(pre, chunk)
                                      if chunk else (chunk, True))
                    blk = native.compress_block(
                        block_model(model, store), payload,
                        name.encode() if first else b"",
                        b"%d %014d" % (len(chunk), fdate),
                        sha1=hashlib.sha1(chunk).digest())
                    counts[0] += 1
                    counts[1] += len(chunk)
                    if progress is not None:
                        progress(counts[1], sum(ext[n][1] for n in changed))
                    yield blk
                    first = False
                    if len(chunk) < block_cap:
                        break

    nbytes = commit_transaction_stream(ctx, pieces(), lambda: b"", tmp=tmp)
    return len(changed), counts[0], nbytes


def pick_date(jd: Jidac, date: Optional[int]) -> int:
    date = date or now_date()
    if jd.ver[-1].date >= date:
        date = jd.ver[-1].date + 1   # version dates must ascend
    return date


def old_dedup_table(jd: Jidac) -> Dict[bytes, int]:
    """Dedup table over the existing archive's fragments."""
    dedup: Dict[bytes, int] = {}
    for i, h in enumerate(jd.ht):
        if i and h.sha1 != b"\x00" * 20:
            dedup[h.sha1] = i
    return dedup


# ---------------------------------------------------------------------------
# Block-granular encode resume (SURVEY.md section 5 checkpoint/resume:
# "block-granular encode resume (journal of completed blocks)")
# ---------------------------------------------------------------------------

class ResumeJournal:
    """Crash-resumable encode: each compressed d block is appended to a
    sidecar journal keyed by the job's fragment-hash identity. A rerun of
    the same add (same tree, -resume) reuses completed blocks instead of
    recompressing them; the journal is deleted once the transaction
    commits. The archive itself stays untouched until commit, so the
    existing transactional crash-safety is unchanged.

    Record: identity[20] len[8 LE] block bytes. Header: magic, date,
    method (packing must replay identically, so the original date is
    pinned on resume)."""

    MAGIC = b"zTPUresume\x01"

    def __init__(self, path: pathlib.Path, date: int, method: str):
        import threading
        self.path = path
        self.date = date
        self.method = method
        self.cache: Dict[bytes, bytes] = {}
        self._lock = threading.Lock()
        self._f = None

    @classmethod
    def load_or_create(cls, path, date: int, method: str) -> "ResumeJournal":
        path = pathlib.Path(path)
        j = None
        if path.exists():
            try:
                raw = path.read_bytes()
                if raw.startswith(cls.MAGIC):
                    p = len(cls.MAGIC)
                    jdate = struct.unpack("<q", raw[p:p + 8])[0]
                    p += 8
                    mlen = raw[p]
                    jmethod = raw[p + 1:p + 1 + mlen].decode()
                    p += 1 + mlen
                    if jmethod == method:
                        j = cls(path, jdate, method)
                        while p + 28 <= len(raw):
                            ident = raw[p:p + 20]
                            (n,) = struct.unpack("<Q", raw[p + 20:p + 28])
                            p += 28
                            if p + n > len(raw):
                                break      # truncated tail record: drop it
                            j.cache[ident] = raw[p:p + n]
                            p += n
            except (OSError, ValueError, struct.error):
                j = None
        if j is None:
            j = cls(path, date, method)
            mb = method.encode()
            path.write_bytes(cls.MAGIC + struct.pack("<q", date)
                             + bytes([len(mb)]) + mb)
        j._f = open(path, "ab")
        return j

    @staticmethod
    def identity(job: "_Job") -> bytes:
        import hashlib
        h = hashlib.sha1()
        for sha, usize in job.frags:
            h.update(sha)
        return h.digest()

    def get(self, job: "_Job"):
        return self.cache.get(self.identity(job))

    def put(self, job: "_Job", block: bytes) -> None:
        with self._lock:
            self._f.write(self.identity(job) + struct.pack("<Q", len(block))
                          + block)
            self._f.flush()
            os.fsync(self._f.fileno())

    def done(self) -> None:
        try:
            self._f.close()
            self.path.unlink()
        except OSError:
            pass


# ---------------------------------------------------------------------------
# The single-host add pipeline
# ---------------------------------------------------------------------------

def add(archive: str, files: Sequence[str], method: str = "1",
        fragment_bits: int = 16, threads: int = 0,
        date: Optional[int] = None, summary: bool = False,
        key: Optional[str] = None,
        use_device: Optional[bool] = True,
        device=None,
        index_path: Optional[str] = None,
        chunk: int = 0,
        notrim: bool = False,
        tmp: bool = False,
        franz: str = "xxhash64",
        verify: bool = False,
        progress=None,
        resume: bool = False) -> Tuple[int, int, int]:
    """Append one transaction. Returns (files added, frags added, bytes).

    index_path: also append the transaction's c/h/i blocks (no d data) to
    a detached index file (reference -index, CHANGELOG.md:687-717) so
    list/sync/dedup work without reading the archive back.
    chunk: with a multipart spec, cap each written part at this many
    bytes (reference -chunk fixed-size parts, CHANGELOG.md:922-927).
    notrim: keep a trailing incomplete transaction instead of truncating
    it before appending (reference default auto-trim, CHANGELOG.md:360-376).
    tmp: create new files as <name>.tmp then rename into place
    (reference -tmp write-then-rename, CHANGELOG.md:357-359; appends to an
    existing archive stay in-place — crash safety there comes from the
    transactional format + auto-trim).
    franz: per-file checksum record format ('xxhash64' binary record or
    '715' for pure-zpaq attrs, reference -715, CHANGELOG.md:484).
    verify: invert every transformed block through its stored pcomp during
    compression (Compressor::setVerify analog, libzpaq.h:513-531).
    progress: optional callback(bytes_done, bytes_total), called between
    files (the reference's 1-second console progress, zsfx.cpp:1638).
    resume: journal completed d blocks to <archive>.resume so an
    interrupted add continues where it stopped (block-granular encode
    resume; the archive is untouched until the transaction commits).
    use_device: ``code_jobs`` codes modeled d blocks (-m3..-m5) as lanes
    of the CM encode kernel on ``device`` (None = the CUDA card, which must
    be present; "cpu" = the kernel's plain PyTorch version). False = the
    host engine on ``code_jobs``' threads. None = the engine gate
    (``device_policy``) at ``method`` with one lane per d block of the
    changed files' bytes. Both write the same archive bytes; store-coded
    methods (-m0..-m2) and streaming-format adds always use the host
    engine."""
    model, pre = make_model(method)   # raises for not-yet-supported methods
    streaming = method.lstrip().startswith("s")
    if not streaming:
        max_job = max_job_bytes(pre, fragment_bits)  # raises: nothing written
    ctx = open_for_append(archive, key=key, notrim=notrim,
                          index_path=index_path)
    jd = ctx.jd

    coded = not streaming and model is not None and model.n > 0
    dev = None
    if use_device and coded:
        from ..device import resolve
        dev = resolve(device)         # no card: raise before writing

    with trace.span("add.scan") as sp:
        ext = scan_files(files)
        changed, deleted = diff_index(jd, ext, files)
        est_bytes = sum(ext[n][1] for n in changed)
        sp.add(files=len(changed), bytes=est_bytes)
    if use_device is None and coded and changed:
        dev = _gated_device(model, method, est_bytes, block_cap(pre),
                            max_job, device)
    date = pick_date(jd, date)
    journal = None
    if resume:
        journal = ResumeJournal.load_or_create(
            pathlib.Path(str(ctx.path) + ".resume"), date, method)
        date = journal.date          # pin packing to the original run
    if not changed and not deleted:
        if journal is not None:
            journal.done()
        return 0, 0, 0

    if streaming:
        # true streaming-format blocks (`a -m s...`): no dedup/journaling
        return add_streaming(ctx, model, pre, changed, ext, block_cap(pre),
                             tmp=tmp, progress=progress)

    # keep_bytes=False: jobs carry (file, start, end) spans, not bytes —
    # the compressing thread re-materializes from the page cache, so the
    # planner never holds fragment data (bounded-RAM add, VERDICT r3 #4)
    planner = FragmentPlanner(old_dedup_table(jd), len(jd.ht), pre,
                              keep_bytes=False)
    jobs: List[_Job] = []

    # per-file CDC + hashing runs in a thread pool (the native calls
    # release the GIL); the dedup/fragment-ID assignment stays serial in
    # file order so IDs are deterministic (SURVEY.md section 7 hard part 6)
    import concurrent.futures as _fut
    hash_threads = threads or min(16, (os.cpu_count() or 4))

    def _digest_file(name: str, parent):
        with trace.span("add.digest", parent=parent) as sp:
            nbytes, sums, frags = _digest(name)
            sp.add(bytes=nbytes, fragments=len(frags))
        return nbytes, sums, frags

    def _digest(name: str):
        # mmap: the digest kernel reads pages straight from the page cache
        # (no separate Python read pass over the file). The mapping is
        # closed before returning — executor.map runs ahead of the
        # consumer, and queued results must not pin whole-file mappings
        # (that unbounded VmSize growth failed the 1 GB bounded-RAM test)
        import mmap as _mmap
        with open(name, "rb") as f:
            try:
                data = _mmap.mmap(f.fileno(), 0, access=_mmap.ACCESS_READ)
            except ValueError:          # empty file
                data = b""
        try:
            frags, crc, xxh = native.digest_file(data, fragment_bits)
            nbytes = len(data)
        finally:
            if data:
                data.close()
        return nbytes, (crc, xxh), frags

    file_sums: Dict[str, Tuple[int, int]] = {}
    # coding overlaps the digest scan: each d-block job is handed to
    # ``code_jobs`` the moment it fills (the reference's add() gets the
    # same overlap from its per-block worker threads, SURVEY.md section 2.8)
    cx_threads = threads or max(2, min(8, (os.cpu_count() or 4)))
    spill = DBlockSpill(pathlib.Path(str(ctx.path) + ".spill"))
    try:
        def planned_jobs():
            # d-block jobs in order, each as soon as it fills
            done_bytes = 0
            parent = trace.current()
            with _fut.ThreadPoolExecutor(max_workers=hash_threads) as hx:
                with trace.span("add.pool", files=len(changed)):
                    digests = hx.map(_digest_file, changed,
                                     [parent] * len(changed))
                for name in changed:
                    with trace.span("add.digest_wait"):
                        nbytes_f, sums, frags = next(digests)
                    file_sums[name] = sums
                    done_bytes += nbytes_f
                    if progress is not None:
                        progress(done_bytes, est_bytes)
                    with trace.span("add.plan") as sp:
                        filled = planner.add_file(name, frags, None)
                        sp.add(jobs=len(filled))
                    for job in filled:
                        jobs.append(job)
                        yield job
            with trace.span("add.plan") as sp:
                tail = planner.finish()
                sp.add(jobs=int(tail is not None))
            if tail is not None:
                jobs.append(tail)
                yield tail

        for blk in code_jobs(model, pre, planned_jobs(), date, dev, max_job,
                             cx_threads, verify=verify, journal=journal):
            with trace.span("add.spill"):
                spill.append(blk)

        with trace.span("add.commit") as sp:
            pieces = stream_transaction(
                date, jobs, spill, changed, deleted, ext, file_sums,
                planner.file_ptrs, planner.first_frag, franz=franz)
            nbytes = commit_transaction_stream(
                ctx, pieces, lambda: spill.index_bytes, chunk=chunk,
                tmp=tmp, index_path=index_path)
            sp.add(bytes=nbytes)
    finally:
        with trace.span("add.spill"):
            spill.close()
    if journal is not None:
        journal.done()
    return len(changed), len(planner.new_ht), nbytes


def _gated_device(model: Model, method: str, est_bytes: int, cap: int,
                  max_job: int, device):
    """The engine gate's decision for an unforced add of ``est_bytes``
    changed bytes at ``method``: one lane per ``cap`` bytes, at most a
    launch's of jobs of up to ``max_job`` bytes. Returns the card
    (``device``, resolved: raises without one) or None (the host
    engine)."""
    from .. import device_policy
    from ..device import resolve
    from ..parallel.engine import encode_lane_io, gate_lanes
    lanes = gate_lanes(model, -(-est_bytes // cap),
                       encode_lane_io(model, max_job), device)
    if device_policy.resolve(None, "codec", est_bytes, method=method,
                             lanes=lanes):
        return resolve(device)
    return None


def _under_any(name: str, roots: Sequence[str]) -> bool:
    for r in roots:
        rr = str(r).replace("\\", "/").lstrip("./").rstrip("/")
        if name == rr or name.startswith(rr + "/"):
            return True
    return False
