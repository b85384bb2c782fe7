"""zfs-family commands: snapshot-consistent dataset backup into archives.

The reference's zfs integration (man/zpaqfranz.pod:115-122;
CHANGELOG.md:962-982 `-dataset` snapshot diffing): freeze a dataset with a
snapshot, stream it (`zfs send`, incremental against the previous backed-up
snapshot when one exists) and store the stream inside the journaling
archive; restore pipes the stored streams back through `zfs receive`.

Stream files inside the archive are named ``zfs/<dataset>/NNNNNNNN.zstream``
(monotonic); each carries the snapshot name in its companion
``.snapname`` entry so restores replay them in order and incremental sends
know their base.

The zfs binary is found on PATH or overridden with ZPAQ_ZFS_CMD (the test
suite points it at a shim; real hosts need the actual utility).

A copy of the reference package's ``jidac/zfs.py`` over the port's ``add``
and ``extract``: a modeled method codes and decodes its d blocks on the card
unless the caller passes ``use_device=False`` (the host engine),
``use_device=None`` (the engine gate, ``device_policy``) or
``device="cpu"`` (the plain versions).
"""

from __future__ import annotations

import os
import pathlib
import shutil
import subprocess
import tempfile
from typing import List, Optional, Tuple


class ZfsError(RuntimeError):
    pass


SNAP_PREFIX = "zpaqfranz"


def zfs_cmd() -> str:
    cmd = os.environ.get("ZPAQ_ZFS_CMD") or shutil.which("zfs")
    if not cmd:
        raise ZfsError(
            "the zfs utility is not available on this host "
            "(set ZPAQ_ZFS_CMD to override)")
    return cmd


def _run(args: List[str], **kw) -> subprocess.CompletedProcess:
    r = subprocess.run([zfs_cmd()] + args, capture_output=True, **kw)
    if r.returncode != 0:
        raise ZfsError(f"zfs {' '.join(args)}: "
                       f"{r.stderr.decode(errors='replace').strip()}")
    return r


def list_snapshots(dataset: str) -> List[str]:
    r = _run(["list", "-t", "snapshot", "-H", "-o", "name", "-s",
              "creation", dataset])
    return [ln.strip() for ln in r.stdout.decode().splitlines() if ln.strip()]


def our_snapshots(dataset: str) -> List[str]:
    return [s for s in list_snapshots(dataset)
            if s.split("@", 1)[-1].startswith(SNAP_PREFIX)]


def _stored_streams(jd, dataset: str) -> List[Tuple[int, str, str]]:
    """-> sorted [(seq, stream file name, snapshot name)] in the archive."""
    import re
    base = f"zfs/{dataset}/"
    out = []
    for name, d in jd.dt.items():
        if not d.date or not name.startswith(base):
            continue
        m = re.match(r"(\d+)\.zstream$", name[len(base):])
        if m:
            out.append((int(m.group(1)), name, ""))
    return sorted(out)


def zfs_backup(archive: str, dataset: str, key: Optional[str] = None,
               method: str = "1", full: bool = False,
               use_device: Optional[bool] = True,
               device=None) -> Tuple[str, int]:
    """Snapshot the dataset and append its send stream to the archive.

    Incremental (``zfs send -i``) against the newest previous zpaqfranz
    snapshot unless ``full`` or none exists. Returns (snapshot, bytes)."""
    from .add import add
    from .archive_io import ArchiveSource
    from .index import read_archive_src

    prev = our_snapshots(dataset)
    seq = 0
    if pathlib.Path(archive).exists():
        jd = read_archive_src(ArchiveSource.from_spec(archive, key=key))
        streams = _stored_streams(jd, dataset)
        seq = streams[-1][0] + 1 if streams else 0
    snap = f"{dataset}@{SNAP_PREFIX}{seq:08d}"
    _run(["snapshot", snap])
    base = prev[-1] if (prev and not full and seq > 0) else None
    with tempfile.TemporaryDirectory() as td:
        sdir = pathlib.Path(td) / "zfs" / dataset
        sdir.mkdir(parents=True)
        spath = sdir / f"{seq:08d}.zstream"
        with open(spath, "wb") as f:
            args = ["send"] + (["-i", base] if base else []) + [snap]
            r = subprocess.run([zfs_cmd()] + args, stdout=f,
                               stderr=subprocess.PIPE)
            if r.returncode != 0:
                raise ZfsError(f"zfs send: "
                               f"{r.stderr.decode(errors='replace').strip()}")
        (sdir / f"{seq:08d}.snapname").write_text(
            snap + ("\n" + base if base else ""))
        cwd = os.getcwd()
        os.chdir(td)
        try:
            arc = archive if os.path.isabs(archive) else str(
                pathlib.Path(cwd) / archive)
            # add the NEW stream files explicitly (not the zfs/ root):
            # earlier generations live only in the archive and must not be
            # diffed as deletions
            rel = f"zfs/{dataset}/{seq:08d}"
            add(arc, [rel + ".zstream", rel + ".snapname"],
                method=method, key=key, use_device=use_device,
                device=device)
        finally:
            os.chdir(cwd)
        return snap, spath.stat().st_size


def zfs_restore(archive: str, dataset: str, to: Optional[str] = None,
                key: Optional[str] = None, use_device: Optional[bool] = True,
                device=None) -> int:
    """Replay the archive's send streams through ``zfs receive``.

    Returns the number of streams received. ``to``: target dataset
    (default: the original)."""
    from .archive_io import ArchiveSource
    from .extract import extract
    from .index import read_archive_src

    src = ArchiveSource.from_spec(archive, key=key)
    jd = read_archive_src(src)
    streams = _stored_streams(jd, dataset)
    if not streams:
        raise ZfsError(f"no zfs streams for {dataset!r} in {archive}")
    target = to or dataset
    n = 0
    with tempfile.TemporaryDirectory() as td:
        extract(src, jd, td, patterns=[f"zfs/{dataset}"],
                use_device=use_device, device=device)
        for seq, name, _ in streams:
            spath = pathlib.Path(td) / name
            with open(spath, "rb") as f:
                r = subprocess.run([zfs_cmd(), "receive", "-F", target],
                                   stdin=f, capture_output=True)
            if r.returncode != 0:
                raise ZfsError(
                    f"zfs receive ({name}): "
                    f"{r.stderr.decode(errors='replace').strip()}")
            n += 1
    return n


def zfs_purge(dataset: str, keep: int = 0) -> List[str]:
    """Destroy this tool's snapshots on the dataset (newest ``keep``
    retained). Returns the destroyed names."""
    snaps = our_snapshots(dataset)
    victims = snaps[:-keep] if keep else snaps
    for s in victims:
        _run(["destroy", s])
    return victims
