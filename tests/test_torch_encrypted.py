"""An encrypted (``-key``) modeled archive through the port's lane path on
the CPU (the plain CM and SHA-1 versions, ``device="cpu"``): ``add`` ->
``extract`` -> ``verify_archive`` restores every byte, as the host engine
does. The same on the card: ``tests/test_torch_card.py``."""

import pytest

from zpaqfranz_tpu_torch.jidac.add import add
from zpaqfranz_tpu_torch.jidac.archive_io import ArchiveSource
from zpaqfranz_tpu_torch.jidac.extract import extract, verify_archive
from zpaqfranz_tpu_torch.jidac.index import read_archive_src
from zpaqfranz_tpu_torch.ops import cm_decode as cmd, cm_encode as cme, sha1

DATE = 20260102030405
KEY = "pw-lanes"


def _files(root):
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


@pytest.mark.parametrize("method", ["3", "4"])
def test_encrypted_modeled_archive_through_the_lanes(tmp_path, monkeypatch,
                                                     method):
    monkeypatch.chdir(tmp_path)
    src = tmp_path / "src"
    src.mkdir()
    (src / "a.txt").write_bytes(b"encrypted lanes " * 12)
    (src / "b.txt").write_bytes(b"a second file, " * 10)
    want = _files(src)
    before = (cme.launches, cmd.launches, sha1.launches)
    for name, kw in (("lanes", {"device": "cpu"}),
                     ("host", {"use_device": False})):
        arc = str(tmp_path / f"{name}.zpaq")
        add(arc, ["src"], method=method, key=KEY, date=DATE, **kw)
        with open(arc, "rb") as f:
            assert b"encrypted lanes" not in f.read()
        srcs = ArchiveSource.from_spec(arc, key=KEY)
        jd = read_archive_src(srcs)
        assert extract(srcs, jd, str(tmp_path / f"out-{name}"), **kw) == \
            (2, sum(map(len, want.values())))
        assert _files(tmp_path / f"out-{name}" / "src") == want
        nblocks, nfrags = verify_archive(srcs, jd, **kw)
        assert nblocks == len(jd.block) and nfrags == len(jd.ht) - 1
    # the plain versions launch nothing
    assert (cme.launches, cmd.launches, sha1.launches) == before
    # each engine's archive restores through the other
    for arc, out, kw in (("lanes", "x1", {"use_device": False}),
                         ("host", "x2", {"device": "cpu"})):
        srcs = ArchiveSource.from_spec(str(tmp_path / f"{arc}.zpaq"), key=KEY)
        extract(srcs, read_archive_src(srcs), str(tmp_path / out), **kw)
        assert _files(tmp_path / out / "src") == want
