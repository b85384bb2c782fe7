"""The reference's reading of a jidac archive (zpaq 7.15's journaling
format, as zpaqfranz writes it), written from the format's description:

- every block starts with the 13-byte locator tag, ``zPQ``, the level and
  a 1, then ``hsize[2]`` and the header: ``hh hm ph pm n`` components, 0,
  HCOMP, 0;
- a segment is ``1 name 0 comment 0 0 data (254 | 253 sha1[20])`` and a
  block ends with 255; the data of a store block (``n = 0``) is a run of
  ``length[4, big-endian] bytes`` chunks ending with a zero length, and its
  first byte selects the postprocessor (0: none);
- journaling blocks are named ``jDC<date:14><c|d|h|i><number:10>``: a
  transaction is a c block (``csize[8]``, the bytes of the d blocks that
  follow it), the d blocks, one h block per d block (``bsize[4]`` then
  ``sha1[20] usize[4]`` per fragment, numbered from the name's number) and
  an i block (per file ``date[8] name 0 na[4] attr[na] ni[4] ptr[ni][4]``;
  a date of 0 deletes the file).

It decodes d blocks with the decoder of ``codec.py`` and uses nothing of
the archiver.
"""

from __future__ import annotations

import concurrent.futures
import hashlib
import pathlib
import re
import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

TAG = bytes([0x37, 0x6B, 0x53, 0x74, 0xA0, 0x31, 0x83, 0xD3, 0x8C, 0xB2,
             0x28, 0xB0, 0xD3])
JDC = re.compile(rb"jDC(\d{14})([cdhi])(\d{10})")
ZERO_SHA1 = b"\x00" * 20
#: the header (hsize and the model) of a store block without a
#: postprocessor: what zpaq writes for an incompressible d block
STORE_HEADER = bytes.fromhex("0700000000000000")


class FormatError(ValueError):
    pass


@dataclass
class StoreBlock:
    offset: int
    end: int
    name: bytes
    body: bytes                       # decoded data, selector byte removed
    chunks: List[Tuple[int, int, int]]  # (body offset, file offset, bytes)

    def file_offset(self, pos: int) -> int:
        """The archive offset of byte ``pos`` of ``body``."""
        for start, off, n in self.chunks:
            if start <= pos < start + n:
                return off + pos - start
        raise IndexError(pos)


@dataclass
class Fragment:
    sha1: bytes
    usize: int
    block: int                        # index into Archive.blocks


@dataclass
class DBlock:
    offset: int
    bsize: int
    first: int                        # first fragment id
    frags: int


@dataclass
class Archive:
    blocks: List[DBlock] = field(default_factory=list)
    fragments: Dict[int, Fragment] = field(default_factory=dict)
    files: Dict[str, List[int]] = field(default_factory=dict)
    hblocks: List[StoreBlock] = field(default_factory=list)


def block_header(buf: bytes, pos: int) -> Tuple[bytes, int]:
    """The header (``hsize[2]`` and the model) of the block at ``pos`` and
    the offset of its first segment."""
    if buf[pos:pos + 13] != TAG or buf[pos + 13:pos + 16] != b"zPQ":
        raise FormatError(f"no block at {pos}")
    pos += 18
    hsize = buf[pos] | buf[pos + 1] << 8
    return bytes(buf[pos:pos + 2 + hsize]), pos + 2 + hsize


def _cstring(buf: bytes, pos: int) -> Tuple[bytes, int]:
    end = buf.find(b"\x00", pos)
    if end < 0:
        raise FormatError(f"unterminated string at {pos}")
    return bytes(buf[pos:end]), end + 1


def read_store_block(buf: bytes, pos: int) -> StoreBlock:
    """Parse the one-segment store block at ``pos``."""
    header, p = block_header(buf, pos)
    if header[6] != 0:
        raise FormatError(f"block at {pos} is not a store block")
    if buf[p] != 1:
        raise FormatError(f"block at {pos} has no segment")
    name, p = _cstring(buf, p + 1)
    _, p = _cstring(buf, p)
    p += 1                             # reserved
    data = bytearray()
    chunks = []
    while True:
        n = struct.unpack(">I", buf[p:p + 4])[0]
        p += 4
        if n == 0:
            break
        chunks.append((len(data) - 1, p, n))
        data += buf[p:p + n]
        p += n
    marker = buf[p]
    p += 1 + (20 if marker == 253 else 0)
    if marker not in (253, 254) or buf[p] != 255:
        raise FormatError(f"block at {pos}: bad segment end")
    if not data or data[0] != 0:
        raise FormatError(f"block at {pos}: postprocessed store block")
    return StoreBlock(pos, p + 1, name, bytes(data[1:]), chunks)


def read_archive(buf: bytes) -> Archive:
    """Every transaction of the archive: its d blocks, fragment table and
    file index."""
    arc = Archive()
    pos = 0
    while pos < len(buf):
        c = read_store_block(buf, pos)
        m = JDC.fullmatch(c.name)
        if not m or m.group(2) != b"c":
            raise FormatError(f"expected a c block at {pos}")
        csize = struct.unpack("<q", c.body[:8])[0]
        if csize < 0:
            raise FormatError(f"incomplete transaction at {pos}")
        data = c.end
        pos = c.end + csize
        while pos < len(buf):
            blk = read_store_block(buf, pos)
            m = JDC.fullmatch(blk.name)
            if not m or m.group(2) == b"c":
                break
            pos = blk.end
            num = int(m.group(3))
            if m.group(2) == b"h":
                body = blk.body
                if len(body) % 24 != 4:
                    raise FormatError(f"h block at {blk.offset}: size")
                bsize = struct.unpack("<I", body[:4])[0]
                n = (len(body) - 4) // 24
                arc.blocks.append(DBlock(data, bsize, num, n))
                for i in range(n):
                    sha1, usize = struct.unpack(
                        "<20sI", body[4 + 24 * i:28 + 24 * i])
                    arc.fragments[num + i] = Fragment(
                        sha1, usize, len(arc.blocks) - 1)
                arc.hblocks.append(blk)
                data += bsize
            elif m.group(2) == b"i":
                _read_index(blk.body, arc.files)
            else:
                raise FormatError(f"d block at {blk.offset} after h blocks")
        if data != c.end + csize:
            raise FormatError(f"d blocks of {data - c.end} bytes, c block "
                              f"says {csize}")
    return arc


def _read_index(body: bytes, files: Dict[str, List[int]]) -> None:
    p = 0
    while p < len(body):
        date = struct.unpack("<q", body[p:p + 8])[0]
        name, p = _cstring(body, p + 8)
        key = name.decode("utf-8", "surrogateescape")
        if date == 0:
            files.pop(key, None)
            continue
        na = struct.unpack("<I", body[p:p + 4])[0]
        p += 4 + na
        ni = struct.unpack("<I", body[p:p + 4])[0]
        p += 4
        files[key] = list(struct.unpack(f"<{ni}I", body[p:p + 4 * ni]))
        p += 4 * ni


@dataclass
class TreeCheck:
    """What an archive says about a tree, held against the tree's files."""
    files_wrong: int = 0        # missing, extra, or of another size
    fragments_wrong: int = 0    # stored SHA-1 other than the content's
    blocks_misheaded: int = 0   # d blocks not coded with the stated model
    blocks_wrong: int = 0       # sampled d blocks that decode wrong
    fragments_hashed: int = 0   # fragments with a stored SHA-1
    # fragment id -> (file name, offset) of its first occurrence
    where: Dict[int, Tuple[str, int]] = field(default_factory=dict)


def check_tree(arc: Archive, tree: pathlib.Path, names: Sequence[str],
               prefix: str) -> TreeCheck:
    """Hold the index against the tree: every file of ``names`` (under
    ``tree``, stored as ``prefix + name``) is indexed, no other file is,
    its fragments add up to its size and each fragment's stored SHA-1 is
    that of the file's bytes it covers."""
    out = TreeCheck()
    want = {prefix + n: n for n in names}
    out.files_wrong += len(set(arc.files) ^ set(want))
    out.fragments_hashed = sum(1 for f in arc.fragments.values()
                               if f.sha1 != ZERO_SHA1)
    for stored, name in want.items():
        ptrs = arc.files.get(stored)
        if ptrs is None:
            continue
        data = (tree / name).read_bytes()
        pos = 0
        bad = False
        for fid in ptrs:
            frag = arc.fragments.get(fid)
            if frag is None or pos + frag.usize > len(data):
                bad = True
                break
            piece = data[pos:pos + frag.usize]
            if hashlib.sha1(piece).digest() != frag.sha1:
                out.fragments_wrong += 1
            out.where.setdefault(fid, (name, pos))
            pos += frag.usize
        if bad or pos != len(data):
            out.files_wrong += 1
    return out


def check_headers(buf: bytes, arc: Archive, allowed: Sequence[bytes]
                  ) -> int:
    """d blocks whose header is none of ``allowed``."""
    return sum(1 for b in arc.blocks
               if block_header(buf, b.offset)[0] not in allowed)


def check_blocks(buf: bytes, arc: Archive, tree: pathlib.Path,
                 where: Dict[int, Tuple[str, int]], sample: Sequence[int],
                 decoder, threads: int) -> int:
    """Decode the d blocks ``sample`` (indices into ``arc.blocks``) with
    the reference decoder; returns how many differ from the tree's bytes
    of their fragments."""
    def expected(b: DBlock) -> Optional[bytes]:
        parts = []
        for fid in range(b.first, b.first + b.frags):
            if fid not in where:
                return None
            name, pos = where[fid]
            with open(tree / name, "rb") as f:
                f.seek(pos)
                parts.append(f.read(arc.fragments[fid].usize))
        return b"".join(parts)

    def wrong(i: int) -> bool:
        b = arc.blocks[i]
        want = expected(b)
        try:
            got = decoder.block(buf, b.offset)
        except ValueError:
            return True
        return want is None or got[:len(want)] != want \
            or len(got) != len(want)

    with concurrent.futures.ThreadPoolExecutor(threads) as ex:
        return sum(ex.map(wrong, sample))


def check_restored(tree: pathlib.Path, names: Sequence[str],
                   restored: pathlib.Path) -> int:
    """Files of the tree that ``restored`` lacks or holds other bytes of,
    plus files ``restored`` holds that the tree has not."""
    wrong = 0
    for n in names:
        p = restored / n
        if not p.is_file() or p.read_bytes() != (tree / n).read_bytes():
            wrong += 1
    have = {p.relative_to(restored).as_posix()
            for p in restored.rglob("*") if p.is_file()}
    return wrong + len(have - set(names))
