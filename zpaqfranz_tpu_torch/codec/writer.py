"""ZPAQ block/segment writer: arithmetic encoder + container framing.

Mirror of the decode path in ``container.py``.  Stream grammar produced
(ZPAQ L2 spec; decode-side reference: the reference's ZSFX/libzpaq.cpp
Decoder 2082-2173, protocol doc libzpaq.h:426-531):

  tag? "zPQ" level 1 header segment* 255
  segment := 1 filename 0 comment 0 0 data (254 | 253 sha1[20])

Modeled data is the arithmetic-coded bit stream (EOS = bit 1 at p=0,
then four explicit zero bytes); unmodeled data is (count[4 BE] bytes)*
followed by four zero bytes.  The first bytes fed to the coder in each
block select postprocessing: 0 = PASS, or 1 psize[2 LE] pcomp.

The encoder here is the scalar host oracle; the CM lane encoder
(``ops/cm_encode.py``) and the native engine must produce byte-identical
streams. A copy of the reference package's ``codec/writer.py``.
"""

from __future__ import annotations

import hashlib
from typing import Optional

from ..zpaql.header import Model
from ..models.predictor import Predictor
from .container import TAG

M32 = 0xFFFFFFFF


class Encoder:
    """Carry-less binary arithmetic encoder over one segment stream."""

    def __init__(self, pr: Predictor, out: bytearray):
        self.pr = pr
        self.out = out
        self.low, self.high = 1, 0xFFFFFFFF
        self._ubuf = bytearray()  # unmodeled pending bytes

    def init_segment(self) -> None:
        self.low, self.high = 1, 0xFFFFFFFF
        self._ubuf.clear()

    def _encode(self, y: int, p: int) -> None:
        """Encode bit y with probability p/65536 of being 1."""
        low, high = self.low, self.high
        mid = low + (((high - low) * p) >> 16)
        if y:
            high = mid
        else:
            low = mid + 1
        while (high ^ low) < 0x1000000:
            self.out.append(high >> 24)
            high = ((high << 8) | 255) & M32
            low = (low << 8) & M32
            low += low == 0
        self.low, self.high = low, high

    def compress(self, c: int) -> None:
        """Encode one byte, or -1 to end the segment data."""
        if self.pr.is_modeled():
            if c < 0:
                self._encode(1, 0)
            else:
                self._encode(0, 0)
                pr = self.pr
                for i in range(7, -1, -1):
                    p = pr.predict() * 2 + 1
                    y = (c >> i) & 1
                    self._encode(y, p)
                    pr.update(y)
        else:
            if c < 0:
                self._flush_unmodeled()
            else:
                self._ubuf.append(c)
                if len(self._ubuf) >= (1 << 16):
                    self._flush_unmodeled()

    def _flush_unmodeled(self) -> None:
        if self._ubuf:
            self.out += len(self._ubuf).to_bytes(4, "big")
            self.out += self._ubuf
            self._ubuf.clear()


class BlockWriter:
    """Writes one ZPAQ block: header, segments, coded data, trailer.

    Equivalent of the reference Compressor state machine (spec
    libzpaq.h:1340-1371; the implementation lives in the absent
    zpaqfranz.cpp, semantics fixed by the Decompresser in
    libzpaq.cpp:2235-2381 which this writer round-trips against).
    """

    def __init__(self, out: bytearray, model: Model, level: int = 2):
        self.out = out
        self.model = model
        self.level = level
        self._in_block = False
        self._pp_written = False
        self._in_segment = False
        self.pr: Optional[Predictor] = None
        self.enc: Optional[Encoder] = None
        self.verify_sha1 = None  # set per segment if checksums wanted

    def write_tag(self) -> None:
        self.out += TAG

    def start_block(self) -> None:
        assert not self._in_block
        self.out += b"zPQ" + bytes([self.level, 1])
        self.out += self.model.header_bytes()
        self.pr = Predictor(self.model)
        self.enc = Encoder(self.pr, self.out)
        self._in_block = True
        self._pp_written = False

    def start_segment(self, filename: bytes = b"", comment: bytes = b"") -> None:
        assert self._in_block and not self._in_segment
        self.out.append(1)
        self.out += filename + b"\x00"
        self.out += comment + b"\x00\x00"
        self.enc.init_segment()
        self._in_segment = True
        self.verify_sha1 = hashlib.sha1()

    def _post_process(self) -> None:
        """Code the postprocessor selector at the start of the first segment."""
        blob = self.model.pcomp_bytes()
        if blob is None:
            self.enc.compress(0)  # PASS
        else:
            self.enc.compress(1)
            for b in blob:
                self.enc.compress(b)
        self._pp_written = True

    def compress(self, data) -> None:
        assert self._in_segment
        if not self._pp_written:
            self._post_process()
        enc = self.enc
        for b in data:
            enc.compress(b)

    def end_segment(self, sha1: Optional[bytes] = None,
                    store_checksum: bool = True) -> None:
        assert self._in_segment
        if not self._pp_written:
            self._post_process()
        self.enc.compress(-1)
        self.out += b"\x00\x00\x00\x00"
        if sha1 is None and store_checksum and self.verify_sha1 is not None:
            sha1 = self.verify_sha1.digest()
        if sha1 is not None:
            self.out.append(253)
            self.out += sha1
        else:
            self.out.append(254)
        self._in_segment = False

    def compress_checked(self, data) -> None:
        """compress() plus SHA-1 of the *pre-coding* bytes for the trailer.

        Note the checksum covers the original (post-postprocessing) data,
        i.e. what a decoder outputs, not the transformed stream; callers
        compressing transformed data must pass the original's sha1 to
        end_segment explicitly.
        """
        self.verify_sha1.update(bytes(data))
        self.compress(data)

    def end_block(self) -> None:
        assert self._in_block and not self._in_segment
        self.out.append(255)
        self._in_block = False


def compress_block(data: bytes, model: Model, filename: bytes = b"",
                   comment: bytes = b"", sha1: Optional[bytes] = None,
                   tag: bool = True, out: Optional[bytearray] = None) -> bytearray:
    """One-call scalar block compressor (oracle path).

    ``data`` is the byte stream to feed the coder (already transformed if
    the model has a PCOMP); ``sha1`` is the checksum of the *original*
    data to store in the trailer (defaults to sha1(data), correct only
    for PASS models).
    """
    if out is None:
        out = bytearray()
    w = BlockWriter(out, model)
    if tag:
        w.write_tag()
    w.start_block()
    w.start_segment(filename, comment)
    w.compress(data)
    w.end_segment(sha1 if sha1 is not None else hashlib.sha1(data).digest())
    w.end_block()
    return out
