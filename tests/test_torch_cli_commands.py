"""The port's archive commands against the reference's CLI: the same
printed lines and exit codes on the same archives. ``p``, ``c``,
``backup`` and ``autotest`` code or decode, so they run with ``-notpu``
(the host engine) beside the reference; ``p`` and ``c`` also run through
the lane path on the CPU (the plain versions). Where an add's date would
differ, both packages' ``now_date`` is pinned."""

import re
import shutil

import numpy as np
import pytest
import torch

import zpaqfranz_tpu.jidac.add as ref_add_mod
from zpaqfranz_tpu.cli import main as ref_main
from zpaqfranz_tpu.jidac.add import add as ref_add
from zpaqfranz_tpu.jidac.index import read_archive as ref_read

import zpaqfranz_tpu_torch.jidac.add as port_add_mod
from zpaqfranz_tpu_torch import cli
from zpaqfranz_tpu_torch.ops import cm_decode as cmd, sha1

DATE = 20260102030405


@pytest.fixture()
def tree(tmp_path, monkeypatch):
    """A small tree with a duplicate file, in the working directory; both
    packages' clocks pinned."""
    monkeypatch.chdir(tmp_path)
    for mod in (ref_add_mod, port_add_mod):
        monkeypatch.setattr(mod, "now_date", lambda: DATE + 500)
    rng = np.random.default_rng(7)
    src = tmp_path / "src"
    (src / "sub").mkdir(parents=True)
    (src / "a.txt").write_bytes(b"alpha " * 100)
    (src / "b.txt").write_bytes(b"beta " * 200)
    (src / "sub" / "c.bin").write_bytes(
        rng.integers(0, 256, 5000, dtype=np.uint8).tobytes())
    (src / "sub" / "dup.bin").write_bytes(b"alpha " * 100)
    return tmp_path


def _run(main, argv, capsys):
    capsys.readouterr()
    rc = main(argv)
    out, err = capsys.readouterr()
    return rc, out, err


def _both(argv, capsys, port_argv=None):
    """(rc, stdout) of the reference's CLI and of the port's."""
    want = _run(ref_main, argv, capsys)[:2]
    got = _run(cli.main, port_argv or argv, capsys)[:2]
    return want, got


def _mask(text):
    """``text`` without its timings."""
    return re.sub(r"\bs(econds)?=[0-9.]+", "s=*", text)


def _twin(tree, method="1", name="arc", versions=1):
    """The reference's archive at a pinned date, and a copy for the port:
    ``name``.zpaq and ``name``_p.zpaq."""
    arc = tree / f"{name}.zpaq"
    ref_add(str(arc), ["src"], method=method, date=DATE)
    if versions > 1:
        (tree / "src" / "a.txt").write_bytes(b"alpha changed " * 90)
        (tree / "src" / "new.txt").write_bytes(b"new " * 50)
        ref_add(str(arc), ["src"], method=method, date=DATE + 100)
    shutil.copy(arc, tree / f"{name}_p.zpaq")
    return arc, tree / f"{name}_p.zpaq"


@pytest.mark.parametrize("argv", [
    ["i"], ["info"], ["versions"], ["last"], ["n"], ["last2"], ["versum"],
    ["f", "txt"], ["fzf"], ["find", "sub/*"], ["dir"], ["dump"],
    ["dump", "-stat"], ["versum", "src/sub"]])
def test_index_commands_print_reference_lines(tree, capsys, argv):
    _twin(tree, method="3", versions=2)
    want, got = _both([argv[0], "arc"] + argv[1:], capsys)
    assert want[1]
    # -stat also prints the command's seconds
    assert _mask(got[1]) == _mask(want[1]) and got[0] == want[0]


def test_verify_against_the_tree(tree, capsys):
    _twin(tree)
    assert _both(["v", "arc"], capsys) == ((0, "4 checked, 0 missing, "
                                           "0 differ\n"),) * 2
    (tree / "src" / "b.txt").write_bytes(b"shorter")
    (tree / "src" / "sub" / "c.bin").unlink()
    want, got = _both(["verify", "arc"], capsys)
    assert want[0] == 1 and "missing: src/sub/c.bin" in want[1]
    assert got == want


def test_delete_writes_the_reference_transaction(tree, capsys):
    arc, port_arc = _twin(tree)
    want, got = _both(["d", "arc", "src/sub"], capsys,
                      ["d", "arc_p", "src/sub"])
    assert want == (0, "2 files marked deleted\n") and got == want
    assert port_arc.read_bytes() == arc.read_bytes()
    want, got = _both(["l", "arc"], capsys, ["l", "arc_p"])
    assert "2 files" in want[1] and got == want
    assert _both(["d", "arc"], capsys, ["d", "arc_p"]) == ((2, ""),) * 2
    assert _both(["d", "arc", "nomatch"], capsys,
                 ["d", "arc_p", "nomatch"]) == ((0, "nothing to delete\n"),
                                                ) * 2


def test_merge_multipart_parts(tree, capsys):
    for k in range(2):
        ref_add(str(tree / "part_????????.zpaq"), ["src"], method="1",
                date=DATE + k)
        (tree / "src" / f"more{k}").write_bytes(b"more %d " % k * 40)
    assert len(list(tree.glob("part_*.zpaq"))) == 2
    want, got = _both(["m", "part_????????.zpaq", "merged"], capsys,
                      ["consolidatebackup", "part_????????.zpaq", "mine"])
    assert want[0] == got[0] == 0
    assert got[1] == want[1].replace("into merged", "into mine")
    assert (tree / "mine.zpaq").read_bytes() == \
        (tree / "merged.zpaq").read_bytes()
    assert _both(["m", "part_????????.zpaq"], capsys) == ((2, ""),) * 2


def test_trim_and_crop(tree, capsys):
    arc, port_arc = _twin(tree, versions=2)
    for p in (arc, port_arc):
        p.write_bytes(p.read_bytes() + b"trailing garbage" * 10)
    want, got = _both(["trim", "arc"], capsys, ["trim", "arc_p"])
    assert want[0] == 0 and want[1].startswith("trimmed 160 trailing")
    assert got == want and port_arc.read_bytes() == arc.read_bytes()
    assert _both(["trim", "arc"], capsys, ["trim", "arc_p"]) == \
        ((0, "nothing to trim\n"),) * 2
    assert _both(["crop", "arc"], capsys, ["crop", "arc_p"]) == ((2, ""),) * 2
    # the reference reads the index only up to -until, so it never crops;
    # the port reads it all and cuts after version 1
    two = port_arc.read_bytes()
    want, got = _both(["crop", "arc", "-until", "1"], capsys,
                      ["crop", "arc_p", "-until", "1"])
    assert want == (0, "archive already has 1 versions\n")
    first = ref_read(two).ver[2].offset
    assert got == (0, f"cropped to version 1: {len(two)} -> {first} bytes\n")
    assert port_arc.read_bytes() == two[:first]
    assert _run(cli.main, ["versions", "arc_p"], capsys)[1] == \
        _run(ref_main, ["versions", "arc_p", "-until", "1"], capsys)[1]
    assert _run(cli.main, ["crop", "arc_p", "-until", "1"], capsys)[:2] == \
        (0, "archive already has 1 versions\n")


def test_password_round_trip(tree, capsys):
    """The salt is random, so the encrypted bytes differ; both packages
    read each other's encryption and decrypt back to the plain archive."""
    arc, port_arc = _twin(tree)
    plain = arc.read_bytes()
    want, got = _both(["password", "arc", "s3cret"], capsys,
                      ["password", "arc_p", "s3cret"])
    assert want[0] == got[0] == 0
    assert got[1] == want[1].replace("arc.zpaq", "arc_p.zpaq")
    assert port_arc.read_bytes() != plain
    # each package lists the other's encrypted archive with the key only
    assert _run(ref_main, ["l", "arc_p", "-key", "s3cret"], capsys)[0] == 0
    assert _run(cli.main, ["l", "arc", "-key", "s3cret"], capsys)[0] == 0
    assert _run(cli.main, ["l", "arc_p"], capsys)[0] == 2
    want, got = _both(["password", "arc", "", "-key", "s3cret"], capsys,
                      ["password", "arc_p", "", "-key", "s3cret"])
    assert got[1] == want[1].replace("arc.zpaq", "arc_p.zpaq")
    assert arc.read_bytes() == port_arc.read_bytes() == plain
    assert _both(["password", "arc"], capsys) == ((2, ""),) * 2


@pytest.mark.parametrize("method", ["1", "3"])
def test_paranoid_and_compare_host(tree, capsys, method):
    """``p`` and ``c`` with -notpu (the host engine), against the
    reference's on the same archive, clean and with a changed tree."""
    _twin(tree, method=method, versions=2)
    want, got = _both(["p", "arc"], capsys, ["p", "arc", "-notpu"])
    assert want == (0, "paranoid: 5 files, 2 blocks, 0 errors\n")
    assert got == want
    want, got = _both(["c", "arc"], capsys, ["compare", "arc", "-notpu"])
    assert want == (0, "5 identical, 0 differ, 0 missing\n") and got == want
    (tree / "src" / "b.txt").write_bytes(b"changed")
    (tree / "src" / "new.txt").unlink()
    want, got = _both(["c", "arc", "-only", "src/*.txt"], capsys,
                      ["c", "arc", "-only", "src/*.txt", "-notpu"])
    assert want[0] == 1 and "# differs src/b.txt" in want[1]
    assert got == want


def test_paranoid_detects_a_damaged_block(tree, capsys):
    arc, port_arc = _twin(tree, method="1")
    data = bytearray(arc.read_bytes())
    data[len(data) // 3] ^= 0x20
    arc.write_bytes(bytes(data))
    want, got = _both(["p", "arc"], capsys, ["w", "arc", "-notpu"])
    assert want[0] == got[0] == 2


@pytest.fixture()
def tiny(tmp_path, monkeypatch):
    """A tree the plain CM decoder restores in seconds."""
    monkeypatch.chdir(tmp_path)
    src = tmp_path / "src"
    (src / "sub").mkdir(parents=True)
    (src / "a.txt").write_bytes(b"hello world " * 12)
    (src / "sub" / "c.txt").write_bytes(b"fox " * 30)
    (src / "sub" / "dup.txt").write_bytes(b"fox " * 30)
    ref_add(str(tmp_path / "arc.zpaq"), ["src"], method="3", date=DATE)
    return tmp_path


def test_paranoid_and_compare_lanes(tiny, capsys):
    """``p`` and ``c`` through the lane path on the CPU: CM decode and
    SHA-1 lanes in their plain versions, no kernel launched, the
    reference's lines."""
    before = (cmd.launches, sha1.launches)
    want = _run(ref_main, ["p", "arc"], capsys)[:2]
    assert want == (0, "paranoid: 3 files, 1 blocks, 0 errors\n")
    capsys.readouterr()
    assert cli.cmd_paranoid("arc.zpaq", [], {}, device="cpu") == 0
    assert capsys.readouterr().out == want[1]
    (tiny / "src" / "a.txt").write_bytes(b"other")
    want = _run(ref_main, ["c", "arc"], capsys)[:2]
    assert want[0] == 1
    capsys.readouterr()
    assert cli.cmd_compare("arc.zpaq", [], {}, device="cpu") == 1
    assert capsys.readouterr().out == want[1]
    assert (cmd.launches, sha1.launches) == before


def test_commands_without_card_exit_2(tiny, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    for argv in (["p", "arc"], ["c", "arc"], ["backup", "bk", "src", "-m3"],
                 ["autotest", "-quick"]):
        assert _run(cli.main, argv, capsys)[0] == 2, argv
    # nothing was written by the backup that could not code its blocks
    assert not list(tiny.glob("bk*"))
    assert _run(cli.main, ["p", "arc", "-notpu"], capsys)[0] == 0


def test_backup_and_testbackup(tree, capsys):
    """Two backups (the second after a change: a second part), the index
    lines and part bytes equal the reference's; testbackup passes, then
    finds a damaged and a missing part."""
    (tree / "ref").mkdir()
    (tree / "port").mkdir()
    for step in range(2):
        want, got = _both(["backup", "ref/bk", "src", "-m3"], capsys,
                          ["backup", "port/bk", "src", "-m3", "-notpu"])
        assert want[0] == got[0] == 0
        assert got[1] == want[1].replace("ref/", "port/")
        assert f"{step + 1} parts indexed" in want[1]
        (tree / "src" / "a.txt").write_bytes(b"alpha " * 100 + b"%d" % step)
    assert (tree / "port" / "bk_backup.txt").read_text() == \
        (tree / "ref" / "bk_backup.txt").read_text()
    for part in sorted((tree / "ref").glob("bk_*.zpaq")):
        assert (tree / "port" / part.name).read_bytes() == part.read_bytes()
    want, got = _both(["testbackup", "ref/bk"], capsys,
                      ["testbackup", "port/bk"])
    assert want == (0, "testbackup: 0 bad parts\n") and got == want
    for d in ("ref", "port"):
        first = tree / d / "bk_00000001.zpaq"
        first.write_bytes(first.read_bytes()[:-1] + b"\x00")
        (tree / d / "bk_00000002.zpaq").unlink()
    want, got = _both(["testbackup", "ref/bk"], capsys,
                      ["testbackup", "port/bk"])
    assert want == (2, "part differs: bk_00000001.zpaq\nmissing part "
                       "bk_00000002.zpaq\ntestbackup: 2 bad parts\n")
    assert got == want
    assert _both(["testbackup", "none"], capsys) == ((2, ""),) * 2


@pytest.mark.parametrize("switches", [["-quick"], ["-quick", "-all"]])
def test_autotest_host(tree, capsys, switches):
    """The self-test on the host engine: the reference's lines but the
    seconds, three expected failures detected under -all."""
    want, got = _both(["autotest"] + switches, capsys,
                      ["autotest"] + switches + ["-notpu"])
    assert want[0] == got[0] == 0
    assert _mask(got[1]) == _mask(want[1])
    assert got[1].count("level ") == 6 and "autotest: PASS" in got[1]
    assert got[1].count("expected-failure=detected") == \
        (3 if "-all" in switches else 0)
    assert "golden" not in got[1]


def test_command_table_covers_the_slice():
    """Every command of the reference's CLI, with its plain-path and
    no-archive grammar."""
    from zpaqfranz_tpu import cli as ref_cli
    for name in ("i", "info", "versions", "last", "n", "last2", "v",
                 "versum", "f", "fzf", "d", "m", "consolidatebackup", "dir",
                 "dump", "trim", "crop", "password", "p", "paranoid", "w",
                 "c", "compare", "backup", "testbackup", "autotest"):
        assert name in cli.COMMANDS, name
    assert sorted(cli.COMMANDS) == sorted(ref_cli.COMMANDS)
    assert cli.PLAIN_PATH_COMMANDS == ref_cli.PLAIN_PATH_COMMANDS
    assert cli.NO_ARCHIVE_COMMANDS == ref_cli.NO_ARCHIVE_COMMANDS
    assert "autotest" in cli.NO_ARCHIVE_COMMANDS


def test_autotest_golden_archive(tree, capsys, monkeypatch):
    """``-golden FILE``: every file of the archive is named by the SHA-256
    of its content; a renamed one is a mismatch."""
    import hashlib
    gold = tree / "gold"
    gold.mkdir()
    for k in range(3):
        body = b"golden %d " % k * (50 + k)
        (gold / hashlib.sha256(body).hexdigest().upper()).write_bytes(body)
    monkeypatch.chdir(gold)
    ref_add(str(tree / "g.zpaq"), sorted(p.name for p in gold.iterdir()),
            method="1", date=DATE)
    next(gold.iterdir()).rename(gold / ("0" * 64))
    ref_add(str(tree / "h.zpaq"), sorted(p.name for p in gold.iterdir()),
            method="1", date=DATE)
    monkeypatch.chdir(tree)
    rc, out, _ = _run(cli.main, ["autotest", "-golden", "g.zpaq", "-notpu"],
                      capsys)
    assert rc == 0 and "golden archive: 3 files, 0 errors" in out
    rc, out, _ = _run(cli.main, ["autotest", "-golden", "h.zpaq", "-notpu"],
                      capsys)
    assert rc == 2 and "golden mismatch: " + "0" * 64 in out
    assert "autotest: 1 ERRORS" in out
