"""The port's zfs commands (``jidac/zfs.py`` and the CLI's ``zfs*``)
against the reference's, on a fake ``zfs`` (the shim of
``tests/test_zfs.py`` through ``ZPAQ_ZFS_CMD``, recording every stream that
``zfs receive`` reads): two generations backed up and restored by each
package on a pool of its own with the same files and times give the same
snapshots, the same sent and received streams and the same restored
dataset, on the host engine (``use_device=False``, ``-notpu``) and on the
lanes' plain versions (``device="cpu"``)."""

import os
import stat

import pytest

from zpaqfranz_tpu.cli import main as ref_main
from zpaqfranz_tpu.jidac import zfs as ref_zfs

from zpaqfranz_tpu_torch import cli
from zpaqfranz_tpu_torch.jidac import zfs

from test_zfs import _SHIM

DS = "tank/data"
STAMP = 1_700_000_000

# the shim, also keeping each stream ``zfs receive`` reads
RECORDING_SHIM = _SHIM.replace(
    "        data = sys.stdin.buffer.read()\n",
    "        data = sys.stdin.buffer.read()\n"
    "        rx = POOL / '.received'\n"
    "        rx.mkdir(exist_ok=True)\n"
    "        (rx / str(len(list(rx.iterdir())))).write_bytes(data)\n")


def _pool(root, monkeypatch):
    """A fake pool with an empty dataset under ``root``, the shim on it,
    ``root`` the working directory."""
    pool = root / "pool"
    (pool / DS).mkdir(parents=True)
    shim = root / "zfs"
    shim.write_text(RECORDING_SHIM)
    shim.chmod(shim.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("ZPAQ_ZFS_CMD", str(shim))
    monkeypatch.setenv("FAKE_POOL", str(pool))
    monkeypatch.chdir(root)
    return pool


def _put(pool, name, body, k):
    """Write a dataset file; pin its time and the dataset's, so that both
    packages' send streams (tar archives of a snapshot) agree."""
    path = pool / DS / name
    path.write_bytes(body)
    for p in (path, pool / DS):
        os.utime(p, (STAMP + k, STAMP + k))


def _generations(root, monkeypatch, backup, restore):
    """Two backups and a restore on a pool of its own: what came back."""
    pool = _pool(root, monkeypatch)
    _put(pool, "a.txt", b"zfs dataset content " * 500, 0)
    got = [backup("z.zpaq", DS)]
    _put(pool, "b.txt", b"second generation " * 300, 1)
    got.append(backup("z.zpaq", DS))
    got.append(restore("z.zpaq", DS, to="tank/restored"))
    rx = pool / ".received"
    got.append([(rx / str(i)).read_bytes() for i in range(2)])
    got.append({p.name: p.read_bytes()
                for p in (pool / "tank" / "restored").iterdir()})
    got.append(zfs.our_snapshots(DS))
    return got


@pytest.mark.parametrize("method,kw", [
    ("1", {"use_device": False}), ("4", {"use_device": False}),
    ("1", {"device": "cpu"})], ids=["m1-host", "m4-host", "m1-cpu"])
def test_backup_and_restore_equal_the_reference(tmp_path, monkeypatch,
                                                method, kw):
    want = _generations(
        tmp_path / "ref", monkeypatch,
        lambda a, d: ref_zfs.zfs_backup(a, d, method=method),
        lambda a, d, to: ref_zfs.zfs_restore(a, d, to=to))
    got = _generations(
        tmp_path / "port", monkeypatch,
        lambda a, d: zfs.zfs_backup(a, d, method=method, **kw),
        lambda a, d, to: zfs.zfs_restore(a, d, to=to, **kw))
    assert got == want
    (snap0, n0), (snap1, n1), n, streams, tree, snaps = got
    assert snap0.endswith("@zpaqfranz00000000") and n0 == len(streams[0])
    assert snap1.endswith("@zpaqfranz00000001") and n1 == len(streams[1])
    assert streams[0].startswith(b"FULL ") and streams[1].startswith(
        b"INCR " + snap0.encode())
    assert n == 2 and tree == {"a.txt": b"zfs dataset content " * 500,
                               "b.txt": b"second generation " * 300}
    assert snaps == [snap0, snap1]


def test_purge(tmp_path, monkeypatch):
    pool = _pool(tmp_path, monkeypatch)
    for k in range(3):
        _put(pool, f"f{k}", b"%d" % k, k)
        zfs.zfs_backup("z.zpaq", DS, use_device=False)
    assert len(zfs.our_snapshots(DS)) == 3
    assert zfs.zfs_purge(DS, keep=1) == [f"{DS}@zpaqfranz0000000{k}"
                                         for k in (0, 1)]
    assert zfs.our_snapshots(DS) == [f"{DS}@zpaqfranz00000002"]
    assert zfs.zfs_purge(DS) == [f"{DS}@zpaqfranz00000002"]


def _cli_lines(root, monkeypatch, main, extra):
    pool = _pool(root, monkeypatch)
    _put(pool, "a.txt", b"via the CLI " * 100, 0)
    out = []
    for argv in (["zfsbackup", "z.zpaq", DS], ["zfsadd", "z.zpaq", DS],
                 ["zfslist", DS], ["zfsrestore", "z.zpaq", DS, "-to",
                                   "tank/back"],
                 ["zfsreceive", "z.zpaq", DS], ["zfspurge", DS, "-keep",
                                                "1"],
                 ["zfslist", DS], ["zfsproxbackup", "z.zpaq", DS],
                 ["zfsproxrestore", "z.zpaq"], ["zfsbackup", "z.zpaq"]):
        out.append((main(argv + (extra if argv[0] in (
            "zfsbackup", "zfsadd", "zfsrestore", "zfsreceive") else [])),
            argv))
    return out


def test_cli_commands_equal_the_reference(tmp_path, monkeypatch, capsys):
    want = _cli_lines(tmp_path / "ref", monkeypatch, ref_main, [])
    ref_out = capsys.readouterr()
    got = _cli_lines(tmp_path / "port", monkeypatch, cli.main, ["-notpu"])
    port_out = capsys.readouterr()
    assert got == want
    assert [rc for rc, _ in got] == [0, 0, 0, 0, 0, 0, 0, 2, 2, 2]
    assert port_out.out == ref_out.out
    assert "2 streams received" in port_out.out
    assert port_out.err == ref_out.err


def test_missing_binary(tmp_path, monkeypatch, capsys):
    monkeypatch.delenv("ZPAQ_ZFS_CMD", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(zfs.ZfsError):
        zfs.zfs_cmd()
    monkeypatch.chdir(tmp_path)
    assert cli.main(["zfslist", DS]) == ref_main(["zfslist", DS]) == 2
    err = capsys.readouterr().err
    assert err.count("the zfs utility is not available") == 2
