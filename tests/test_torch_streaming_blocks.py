"""Streaming-format blocks (no jidac index, so no stored block size) read a
bounded range: ``decode_jidac_blocks`` fetches each block's bytes up to the
next block's offset, or to the archive's end for the last block, never the
rest of the archive per block. The decoded files equal the data written and
the reference's host-engine extract of the same archive, byte for byte."""

import numpy as np
import torch

from zpaqfranz_tpu.jidac.extract import extract as ref_extract
from zpaqfranz_tpu.jidac.index import read_archive as ref_read

from zpaqfranz_tpu_torch.codec.writer import compress_block
from zpaqfranz_tpu_torch.jidac.archive_io import ArchiveSource
from zpaqfranz_tpu_torch.jidac.extract import decode_jidac_blocks, extract
from zpaqfranz_tpu_torch.jidac.index import read_archive
from zpaqfranz_tpu_torch.ops import cm_decode as cmd
from zpaqfranz_tpu_torch.zpaql.compiler import compile_config

CFG = "comp 1 0 0 0 1  0 cm 12 7  hcomp a<<= 8 *d=a halt post 0 end"
BLOCKS = 8


def _streaming_archive():
    """8 modeled blocks, one named file each, in the streaming format."""
    model, _ = compile_config(CFG)
    rng = np.random.default_rng(17)
    files = {}
    arc = bytearray()
    for k in range(BLOCKS):
        n = int(rng.integers(60, 160))
        body = bytes(rng.integers(97, 100, n, dtype=np.uint8))
        name = f"s/f{k}.txt"
        files[name] = body
        compress_block(body, model, name.encode(),
                       b"%d 20260102030405" % n, out=arc)
    return bytes(arc), files


def test_streaming_blocks_read_a_bounded_range(monkeypatch, tmp_path):
    arc, files = _streaming_archive()
    jd = read_archive(arc)
    assert len(jd.block) == BLOCKS and all(b.bsize == 0 for b in jd.block)
    reads = []
    real = ArchiveSource.read_range

    def recorded(self, offset, n):
        reads.append((offset, n))
        return real(self, offset, n)

    monkeypatch.setattr(ArchiveSource, "read_range", recorded)
    before = cmd.launches
    out = decode_jidac_blocks(arc, jd, jd.block, torch.device("cpu"))
    assert cmd.launches == before          # the plain decoder on the CPU
    ends = [b.offset for b in jd.block[1:]] + [len(arc)]
    assert sorted(o for o, _ in reads) == [b.offset for b in jd.block]
    for (off, n), blk, end in zip(sorted(reads), jd.block, ends):
        assert n <= end - blk.offset
    assert sum(n for _, n in reads) == len(arc)
    assert [out[b.offset] for b in jd.block] == list(files.values())

    # a subset of the blocks reads only its own ranges
    reads.clear()
    some = jd.block[2:5]
    decode_jidac_blocks(arc, jd, some, torch.device("cpu"))
    assert sorted(reads) == [(b.offset, e - b.offset)
                             for b, e in zip(some, ends[2:5])]

    # extract on the lanes (plain versions) and the reference's host engine
    monkeypatch.setattr(ArchiveSource, "read_range", real)
    assert extract(arc, jd, str(tmp_path / "port"), device="cpu") == (
        BLOCKS, sum(map(len, files.values())))
    ref_extract(arc, ref_read(arc), str(tmp_path / "ref"), use_device=False)
    for name, body in files.items():
        assert (tmp_path / "port" / name).read_bytes() == body
        assert (tmp_path / "ref" / name).read_bytes() == body
