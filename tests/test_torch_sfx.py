"""The port's self-extracting builder (``jidac/sfx.py``, ``sfx``): the stub
compiled by g++ from the repository's ``native/src`` into a temporary
directory extracts an archive that the port wrote, and the file is the
reference's format: stub, archive, ``SFX_MAGIC`` and the stub's size as a
little-endian u64. One g++ build in this file (it takes seconds)."""

import pathlib
import shutil
import struct
import subprocess

import pytest

from zpaqfranz_tpu.cli import main as ref_main
from zpaqfranz_tpu.jidac import sfx as ref_sfx

from zpaqfranz_tpu_torch import cli
from zpaqfranz_tpu_torch.jidac import sfx
from zpaqfranz_tpu_torch.jidac.add import add

ROOT = pathlib.Path(__file__).resolve().parent.parent


def test_sfx_extracts_a_port_archive(tmp_path, monkeypatch, capsys):
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    monkeypatch.chdir(tmp_path)
    tree = tmp_path / "tree"
    tree.mkdir()
    (tree / "keep.txt").write_bytes(b"version one " * 500)
    (tree / "gone.txt").write_bytes(b"to be deleted " * 100)
    (tree / "b.bin").write_bytes(bytes(range(256)) * 300)
    add("s.zpaq", ["tree"], method="1", date=20260102030405)
    (tree / "keep.txt").write_bytes(b"version TWO " * 700)
    (tree / "gone.txt").unlink()
    add("s.zpaq", ["tree"], method="1", date=20260102030505)

    archive = (tmp_path / "s.zpaq").read_bytes()
    rc = cli.main(["sfx", "s", "s.sfx"])
    assert rc == 0 and "s.sfx: " in capsys.readouterr().out
    blob = (tmp_path / "s.sfx").read_bytes()
    assert sfx.SFX_MAGIC == ref_sfx.SFX_MAGIC
    stub = struct.unpack("<Q", blob[-8:])[0]
    assert blob[-24:-8] == sfx.SFX_MAGIC
    assert blob[stub:-24] == archive and blob[:4] == b"\x7fELF"
    # the stub and its generated tables were built elsewhere
    for d in (ROOT / "native", ROOT / "native" / "src"):
        assert not (d / "stub").exists()
        assert not (d / "sfx_tables.inc").exists()

    (tmp_path / "out").mkdir()
    r = subprocess.run(["./s.sfx", "out"], capture_output=True, timeout=120)
    assert r.returncode == 0, r.stderr.decode()
    out = tmp_path / "out" / "tree"
    assert sorted(p.name for p in out.iterdir()) == ["b.bin", "keep.txt"]
    for name in ("b.bin", "keep.txt"):
        assert (out / name).read_bytes() == (tree / name).read_bytes()


def test_sfx_without_an_archive(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    assert cli.main(["sfx", "none"]) == ref_main(["sfx", "none"]) == 2
    err = capsys.readouterr().err.splitlines()
    assert len(err) == 2 and err[0] == err[1]
