"""The port's host-utility commands against the reference's CLI: each
command's printed lines and exit code on the same seeded tree, in a working
directory of its own for each package, are the reference's (mirrors
``tests/test_cli_commands.py``)."""

import io
import os
import stat
import sys

import numpy as np

from zpaqfranz_tpu.cli import main as ref_main
from zpaqfranz_tpu.jidac.add import add as ref_add

from zpaqfranz_tpu_torch import cli

DATE = 20260102030405

FAKE_MYSQLDUMP = """#!/usr/bin/env python3
import sys
db = sys.argv[1]
if db == "nodb":
    sys.stderr.write("unknown database\\n")
    sys.exit(2)
sys.stdout.write("-- dump of %s\\n" % db)
for k in range(200):
    sys.stdout.write("INSERT INTO t VALUES (%d, 'row %d');\\n" % (k, k))
"""


def _tree(root):
    """The seeded tree, an archive of it and a mysqldump shim in ``root``."""
    rng = np.random.default_rng(31)
    src = root / "src"
    (src / "sub").mkdir(parents=True)
    (src / "a.txt").write_bytes(b"alpha " * 100)
    (src / "b.txt").write_bytes(b"beta " * 200)
    (src / "sub" / "c.bin").write_bytes(
        rng.integers(0, 256, 5000, dtype=np.uint8).tobytes())
    (src / "sub" / "dup.bin").write_bytes(b"alpha " * 100)
    (root / "x1.bin").write_bytes(b"same-prefix-DIFFER-a" * 3)
    (root / "x2.bin").write_bytes(b"same-prefix-DIFFER-a" * 2
                                  + b"same-prefix-DIFFER-b")
    (root / "big.bin").write_bytes(
        rng.integers(0, 256, 10000, dtype=np.uint8).tobytes())
    (root / "copy.bin").write_bytes((root / "big.bin").read_bytes()[:4000])
    (src / "naïve.txt").write_bytes(b"x")
    shim = root / "mysqldump"
    shim.write_text(FAKE_MYSQLDUMP)
    shim.chmod(shim.stat().st_mode | stat.S_IEXEC)
    os.chdir(root)
    ref_add("arc.zpaq", ["src"], method="1", date=DATE)


SEQUENCE = [
    ["1on1", "x1.bin", "x2.bin"], ["1on1", "x1.bin", "x1.bin"], ["1on1"],
    ["comparehex", "x1.bin", "x2.bin"], ["comparehex", "x1.bin", "x1.bin"],
    ["count"], ["count", "src"], ["count", "src/a.txt", "src/sub"],
    ["s", "src"], ["dirsize", "src", "src/a.txt"],
    ["collision", "src"], ["isopen", "arc"], ["isopen", "none"],
    ["utf", "src"], ["utf", "src", "-fix"], ["utf", "src"],
    ["cp", "big.bin", "copy.bin"], ["cp", "big.bin", "copy.bin"],
    ["cp", "big.bin"],
    ["r", "src", "mirror"], ["rsync", "src", "mirror"],
    ["r", "src", "mirror", "-kill"],
    ["z", "src"], ["z", "src", "-kill"],
    ["rd", "mirror"], ["k", "mirror", "-kill"], ["rd", "mirror", "-kill"],
    ["pause"],
    ["sync", "arc", "src"],
    ["mysqldump", "arc", "shop"], ["mysqldump", "arc", "nodb"],
    ["update"], ["upgrade"], ["download"], ["ads", "x"], ["ntfs"],
    ["drive"], ["work"], ["pakka"], ["kickstart"], ["tui"],
]


def _sequence(root, main, capsys, monkeypatch):
    _tree(root)
    monkeypatch.setenv("ZPAQ_MYSQLDUMP_CMD", str(root / "mysqldump"))
    out = []
    for argv in SEQUENCE:
        if argv[0] == "z":
            (root / "src" / "emptydir").mkdir(exist_ok=True)
        if argv == ["sync", "arc", "src"]:
            (root / "src" / "new.txt").write_bytes(b"n")
            (root / "src" / "a.txt").write_bytes(b"CHANGED" * 50)
            os.remove(root / "src" / "b.txt")
        if argv[:2] == ["r", "src"] and "-kill" in argv:
            (root / "mirror" / "stray.txt").write_bytes(b"x")
        monkeypatch.setattr(sys, "stdin", io.StringIO("\n"))
        capsys.readouterr()
        rc = main(argv)
        res = capsys.readouterr()
        out.append((argv, rc, res.out, res.err))
    out.append(sorted(str(p.relative_to(root)) for p in root.rglob("*")))
    return out


def test_host_commands_equal_the_reference(tmp_path, capsys, monkeypatch):
    cwd = os.getcwd()
    try:
        want = _sequence(tmp_path / "ref", ref_main, capsys, monkeypatch)
        got = _sequence(tmp_path / "port", cli.main, capsys, monkeypatch)
    finally:
        os.chdir(cwd)
    for w, g in zip(want, got):
        assert g == w
    assert len(got) == len(want) == len(SEQUENCE) + 1
    rcs = {tuple(a): rc for a, rc, _, _ in got[:-1]}
    assert rcs[("1on1", "x1.bin", "x2.bin")] == 1
    assert rcs[("sync", "arc", "src")] == 1
    assert rcs[("mysqldump", "arc", "shop")] == 0
    assert all(rc == 2 for a, rc in rcs.items() if a[0] in (
        "update", "ads", "ntfs", "tui", "work"))
    assert "mirror" not in got[-1] and "src/na_ve.txt" in got[-1]
