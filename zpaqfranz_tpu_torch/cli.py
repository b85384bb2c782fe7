"""zpaqfranz_tpu_torch command-line interface: every command of the
reference package's.

Positional grammar matching the reference (man/zpaqfranz.pod:75-131):

    python -m zpaqfranz_tpu_torch.cli <command> <archive>[.zpaq] [files...] [-switches]

Archive commands: a add, x e extract, l ls list, i info, t test, v verify,
p w paranoid, c compare, trim, crop, d delete, m merge consolidatebackup,
backup, testbackup, f find fzf, dir, versions last last2 n, versum, dump,
password, sync, sfx, mysqldump, autotest, b bench; zfsbackup zfsadd,
zfsrestore zfsreceive, zfslist, zfspurge. File commands: sum hash, 1on1,
comparehex, count, s dirsize, collision, isopen, utf, cp, r rsync, z, rd k,
pause. The platform commands (update upgrade download ads ntfs drive work
pakka kickstart tui, zfsproxbackup zfsproxrestore) say why they are out of
scope and exit 2.

Switches: -mN method, -to DIR, -until N|date, -fragment N, -threads N,
-key PW, -only PAT, -not PAT, -summary, -all, -quick, -golden FILE,
-stat, -test, -tpu / -notpu, and for ``sum`` the hash name (-sha1
default, -sha256, -md5, -xxhash64, ...).
``a``/``backup``/``zfsbackup``/``mysqldump`` at -m3..-m5, ``x``,
``zfsrestore``, ``t``, ``p``, ``c``, ``autotest`` and ``sum -sha1/-sha256``
take the CUDA card or the host engine by the engine gate
(``device_policy``: the rates ``b`` recorded for this card, at the job's
method and lane count; no record means the card); ``-tpu`` forces the
card, ``-notpu`` the host engine. ``b`` records the host engine's rates,
and unless ``-notpu`` the card's beside them.
Exit codes follow the reference contract: 0 ok, 1 warnings, 2 errors.
"""

from __future__ import annotations

import hashlib
import pathlib
import sys
import time
from typing import Dict, List, Optional, Sequence

from . import trace


def _fmt_size(n: int) -> str:
    return f"{n:,}"


def _parse_args(argv: Sequence[str]):
    if not argv:
        return None, None, [], {}
    cmd = argv[0]
    archive = None
    files: List[str] = []
    sw: Dict[str, List[str]] = {}
    i = 1
    cur: Optional[str] = None
    for a in argv[1:]:
        if a.startswith("-") and not a[1:2].isdigit():
            cur = a[1:]
            sw[cur] = []
        elif cur is not None:
            sw[cur].append(a)
        elif archive is None:
            archive = a
        else:
            files.append(a)
    return cmd, archive, files, sw


def _archive_path(name: str) -> str:
    if not name.endswith(".zpaq") and "*" not in name and "?" not in name:
        return name + ".zpaq"
    return name


def _read_archive_bytes(archive: str) -> bytes:
    """Read archive bytes; '*'/'?' wildcards concatenate multipart pieces
    (reference subpart semantics, zsfx.cpp:413-421, 502-515)."""
    if "*" in archive or "?" in archive:
        import glob
        parts = sorted(glob.glob(archive))
        if not parts:
            raise FileNotFoundError(archive)
        return b"".join(pathlib.Path(p).read_bytes() for p in parts)
    return pathlib.Path(archive).read_bytes()


def _method(sw) -> str:
    for k in sw:
        if k.startswith("m") and k[1:].isdigit():
            return k[1:]
        if k == "method" and sw[k]:
            return sw[k][0]
    return "1"


def _until(sw) -> Optional[int]:
    if "until" in sw and sw["until"]:
        return int(sw["until"][0].replace("-", "").replace(":", ""))
    return None


def _key(sw) -> Optional[str]:
    if "key" in sw and sw["key"]:
        return sw["key"][0]
    return None


def _use_device(sw) -> Optional[bool]:
    """Engine selection: ``-notpu`` forces the host engine (False),
    ``-tpu`` the CUDA card (True); no switch is None, the engine gate
    (``device_policy.resolve``) of each job."""
    if "notpu" in sw:
        return False
    if "tpu" in sw:
        return True
    return None


def _load_index(archive: str, sw):
    """Open the archive as a streaming source and scan its index.

    Memory is O(index) + O(window) regardless of archive size: the source
    is file-backed (seek + decrypt-at-offset, native FileSource) and the
    scan skips d blocks via the c-block csize jump. Returns
    (ArchiveSource, Jidac); every downstream consumer (extract/verify/
    device decode) pulls block ranges through the source."""
    from .jidac.archive_io import ArchiveSource
    from .jidac.index import read_archive_src
    with trace.span("jidac.index") as sp:
        src = ArchiveSource.from_spec(archive, key=_key(sw))
        jd = read_archive_src(src, until=_until(sw))
        sp.add(blocks=len(jd.block), fragments=len(jd.ht))
    return src, jd


def cmd_add(archive, files, sw) -> int:
    from .jidac.add import add
    method = _method(sw)
    frag = int(sw.get("fragment", ["6"])[0]) + 10
    t0 = time.time()
    chunk_arg = sw.get("chunk", [None])[0]
    chunk = 0
    if chunk_arg:
        mult = {"k": 1 << 10, "m": 1 << 20, "g": 1 << 30}.get(
            chunk_arg[-1].lower(), 1)
        chunk = int(chunk_arg.rstrip("kmgKMG") or 0) * mult
    nfiles, nfrags, nbytes = add(archive, files, method=method,
                                 fragment_bits=frag,
                                 threads=int(sw.get("threads", ["0"])[0]),
                                 key=_key(sw), use_device=_use_device(sw),
                                 index_path=sw.get("index", [None])[0],
                                 chunk=chunk, notrim="notrim" in sw,
                                 tmp="tmp" in sw,
                                 # -715 pure zpaq; explicit -xxhash64 = the
                                 # classic TEXT FRANZBLOCK (reference non-b
                                 # switches, CHANGELOG.md:673-675); default
                                 # = compact binary record (v60 "b" role)
                                 franz=("715" if "715" in sw
                                        else "text" if "xxhash64" in sw
                                        else "xxhash64"),
                                 verify="verify" in sw,
                                 resume="resume" in sw,
                                 progress=(prog := _Progress(sw)))
    prog.finish()
    dt = time.time() - t0
    print(f"{nfiles} files added, {nfrags} fragments, "
          f"{_fmt_size(nbytes)} bytes in {dt:.2f}s")
    if "test" in sw and nfiles:
        from .jidac.extract import verify_archive
        data, jd = _load_index(archive, sw)
        nblocks, nfr = verify_archive(data, jd,
                                      use_device=_use_device(sw))
        print(f"post-add verify: {nblocks} blocks, {nfr} fragments OK")
    return 0


def cmd_extract(archive, files, sw) -> int:
    from .jidac.extract import extract, select_files
    data, jd = _load_index(archive, sw)
    if "only" in sw or "not" in sw:
        files = _apply_filters(select_files(jd, files), sw)
        if not files:
            print("no files selected")
            return 0
    to = sw.get("to", ["."])[0]
    rename = None
    if "find" in sw and sw["find"]:
        find = sw["find"][0]
        repl = sw.get("replace", [""])[0]
        rename = lambda n: n.replace(find, repl)   # noqa: E731
    t0 = time.time()
    nfiles, nbytes = extract(data, jd, to, patterns=files,
                             threads=int(sw.get("threads", ["0"])[0]),
                             use_device=_use_device(sw),
                             progress=(prog := _Progress(sw)),
                             rename=rename)
    prog.finish()
    dt = time.time() - t0
    print(f"{nfiles} files, {_fmt_size(nbytes)} bytes extracted "
          f"in {dt:.2f}s ({nbytes / max(dt, 1e-9) / 1e6:.1f} MB/s)")
    return 0


def _apply_filters(names, sw):
    import fnmatch
    only = sw.get("only", [])
    nots = sw.get("not", [])
    out = []
    for n in names:
        if only and not any(fnmatch.fnmatchcase(n, p) or n.startswith(p.rstrip("/") + "/") for p in only):
            continue
        if nots and any(fnmatch.fnmatchcase(n, p) or n.startswith(p.rstrip("/") + "/") for p in nots):
            continue
        out.append(n)
    return out


def cmd_list(archive, files, sw) -> int:
    from .jidac.extract import select_files
    data, jd = _load_index(archive, sw)
    names = _apply_filters(select_files(jd, files), sw)
    total = 0
    csv = "csv" in sw
    find = sw["find"][0] if ("find" in sw and sw["find"]) else None
    repl = sw.get("replace", [""])[0]
    for n in names:
        d = jd.dt[n]
        shown = n.replace(find, repl) if find else n
        date = f"{d.date:014d}"
        pretty = (f"{date[0:4]}-{date[4:6]}-{date[6:8]} "
                  f"{date[8:10]}:{date[10:12]}:{date[12:14]}")
        if csv:
            print(f'"{pretty}",{d.size},"{shown}"')
        else:
            print(f"- {pretty} {_fmt_size(d.size):>15}  {shown}")
        total += max(d.size, 0)
    stored = data.size()
    warnings = _damage_warnings(jd)
    if not csv:
        print(f"{len(names):,} files, {_fmt_size(total)} bytes "
              f"-> {_fmt_size(stored)} stored"
              + (f" ({stored * 100.0 / total:.1f}%)" if total else ""))
    return _warn(warnings)


def _damage_warnings(jd) -> List[str]:
    """What the error-isolating index scan skipped: a truncated trailing
    transaction, damaged blocks (reference: "Incomplete transaction
    ignored", a warning)."""
    out = []
    if jd.incomplete:
        out.append("warning: incomplete (truncated) trailing transaction "
                   "ignored")
    if jd.errors:
        out.append(f"warning: {jd.errors} damaged block(s) skipped "
                   f"(first at offset {jd.first_error})")
    return out


def _warn(warnings: List[str]) -> int:
    """Print the warnings to stderr; the exit code of the reference
    contract (man:135): 0 ok, 1 warning."""
    for w in warnings:
        print(w, file=sys.stderr)
    return 1 if warnings else 0


def cmd_test(archive, files, sw) -> int:
    from .jidac.extract import verify_archive
    data, jd = _load_index(archive, sw)
    t0 = time.time()
    use_device = _use_device(sw)
    if use_device is None and "ssd" in sw:
        # -ssd: fast storage, so the gate decides without the job floor
        from .device_policy import resolve
        use_device = resolve(None, "hash", 0)
    nblocks, nfrags = verify_archive(
        data, jd, threads=int(sw.get("threads", ["0"])[0]),
        use_device=use_device)
    dt = time.time() - t0
    usize = sum(b.usize for b in jd.block)
    # the surviving data verified, but "all OK" must not hide what the scan
    # skipped
    warnings = _damage_warnings(jd)
    print(f"tested {nblocks} blocks, {nfrags} fragments, "
          f"{_fmt_size(usize)} bytes in {dt:.2f}s: "
          + (f"OK with {len(warnings)} warning(s)" if warnings
             else "all OK"))
    return _warn(warnings)


def cmd_info(archive, files, sw) -> int:
    data, jd = _load_index(archive, sw)
    print(f"{archive}: {len(jd.ver) - 1} versions, "
          f"{sum(1 for d in jd.dt.values() if d.date):,} files, "
          f"{len(jd.ht) - 1:,} fragments, {len(jd.block):,} blocks, "
          f"{_fmt_size(data.size())} bytes")
    return 0


def cmd_versions(archive, files, sw) -> int:
    data, jd = _load_index(archive, sw)
    for i, v in enumerate(jd.ver[1:], 1):
        print(f"{i:6d}  {v.date:014d}  +{v.updates} -{v.deletes} "
              f"frag {v.firstFragment}.. csize {_fmt_size(v.csize)}")
    return 0


def cmd_verify(archive, files, sw) -> int:
    """Compare archive contents against the filesystem (names and sizes)."""
    from .jidac.extract import select_files
    data, jd = _load_index(archive, sw)
    names = select_files(jd, files)
    bad = missing = 0
    for n in names:
        p = pathlib.Path(n)
        if not p.exists():
            missing += 1
            print(f"missing: {n}")
            continue
        if p.stat().st_size != jd.dt[n].size:
            bad += 1
            print(f"size differs: {n}")
    print(f"{len(names)} checked, {missing} missing, {bad} differ")
    return 1 if (bad or missing) else 0


def cmd_paranoid(archive, files, sw, device=None) -> int:
    """Full paranoid test: decode every block, rebuild every file in memory,
    verify fragment SHA-1s plus per-file CRC-32/XXH64 (franz metadata).
    Blocks decode as CM lanes and fragments hash as SHA-1 lanes on
    ``device`` (None = the CUDA card; "cpu" = the plain versions) where
    ``-tpu`` or the engine gate takes the card, else on the host engine;
    the file checksums run on the host."""
    from . import native
    from .jidac.extract import decode_fragments, select_files
    data, jd = _load_index(archive, sw)
    frag_bytes = decode_fragments(data, jd, use_device=_use_device(sw),
                                  device=device)
    bad = 0
    names = select_files(jd, files)
    for n in names:
        d = jd.dt[n]
        content = b"".join(frag_bytes[f] for f in d.ptr)
        if len(content) != d.size:
            print(f"size mismatch: {n}")
            bad += 1
            continue
        if d.crc32 is not None and native.crc32(content) != d.crc32:
            print(f"crc32 mismatch: {n}")
            bad += 1
        elif d.xxh64 is not None and native.xxh64(content) != d.xxh64:
            print(f"xxh64 mismatch: {n}")
            bad += 1
    print(f"paranoid: {len(names)} files, {len(jd.block)} blocks, "
          f"{bad} errors")
    return 2 if bad else 0


def cmd_trim(archive, files, sw) -> int:
    """Remove any trailing data after the last complete transaction."""
    from .codec import crypto
    src, jd = _load_index(archive, sw)
    end = jd.csize
    size = src.size()
    shift = crypto.SALT_LEN if _key(sw) is not None else 0
    if end < size:
        with open(archive, "r+b") as f:
            f.truncate(end + shift)
        print(f"trimmed {size - end} trailing bytes "
              f"({size} -> {end})")
    else:
        print("nothing to trim")
    return 0


def cmd_crop(archive, files, sw) -> int:
    """Truncate the archive to the end of version N (-until N)."""
    until = _until(sw)
    if until is None:
        print("crop requires -until N", file=sys.stderr)
        return 2
    # the whole index: the reference reads it only up to -until, so it
    # never finds a version to cut
    src, jd = _load_index(archive, {k: v for k, v in sw.items()
                                    if k != "until"})
    if until >= len(jd.ver) - 1:
        print(f"archive already has {len(jd.ver) - 1} versions")
        return 0
    from .codec import crypto
    end = jd.ver[until + 1].offset if until + 1 < len(jd.ver) else jd.csize
    shift = crypto.SALT_LEN if _key(sw) is not None else 0
    size = src.size()
    with open(archive, "r+b") as f:
        f.truncate(end + shift)
    print(f"cropped to version {until}: {size} -> {end} bytes")
    return 0


def cmd_find(archive, files, sw) -> int:
    """Find files in the archive by substring or wildcard (reference f)."""
    import fnmatch
    from .jidac.extract import select_files
    data, jd = _load_index(archive, sw)
    pats = files or ["*"]
    shown = 0
    for n in select_files(jd, []):
        if any(p.lower() in n.lower() or fnmatch.fnmatchcase(n, p)
               for p in pats):
            d = jd.dt[n]
            print(f"{d.size:>12}  {n}")
            shown += 1
    print(f"{shown} found")
    return 0


def cmd_compare(archive, files, sw, device=None) -> int:
    """Compare archive contents against the filesystem by content (the
    reference c). Blocks decode and fragments hash as in ``p``."""
    from .jidac.extract import decode_fragments, select_files
    data, jd = _load_index(archive, sw)
    names = _apply_filters(select_files(jd, files), sw)
    frag_bytes = decode_fragments(data, jd, use_device=_use_device(sw),
                                  device=device)
    same = differ = missing = 0
    for n in names:
        p = pathlib.Path(n)
        if not p.exists():
            missing += 1
            print(f"- missing {n}")
            continue
        content = b"".join(frag_bytes[f] for f in jd.dt[n].ptr)
        if p.read_bytes() == content:
            same += 1
        else:
            differ += 1
            print(f"# differs {n}")
    print(f"{same} identical, {differ} differ, {missing} missing")
    return 1 if (differ or missing) else 0


def cmd_delete(archive, files, sw) -> int:
    """Mark files deleted in a new transaction (reference d command)."""
    import struct
    from . import native
    from .jidac.add import _jdc_name, now_date
    from .jidac.extract import select_files
    from .zpaql.header import Model
    if not files:
        print("d requires file patterns", file=sys.stderr)
        return 2
    data, jd = _load_index(archive, sw)
    names = _apply_filters(select_files(jd, files), sw)
    if not names:
        print("nothing to delete")
        return 0
    date = max(now_date(), jd.ver[-1].date + 1)
    store = Model(hh=0, hm=0)
    out = bytearray()
    cbody = struct.pack("<q", 0)
    out += native.compress_block(store, cbody,
                                 _jdc_name(date, "c", len(jd.ht)),
                                 b"%d jDC\x01" % len(cbody))
    ibody = bytearray()
    for n in names:
        ibody += struct.pack("<q", 0) + n.encode() + b"\x00"
    out += native.compress_block(store, bytes(ibody),
                                 _jdc_name(date, "i", len(jd.ht)),
                                 b"%d jDC\x01" % len(ibody))
    with open(archive, "ab") as f:
        f.write(out)
    print(f"{len(names)} files marked deleted")
    return 0


def cmd_merge(archive, files, sw) -> int:
    """Consolidate multipart pieces into one archive (reference m)."""
    if not files:
        print("m requires the output archive name", file=sys.stderr)
        return 2
    data = _read_archive_bytes(archive)
    outp = _archive_path(files[0])
    pathlib.Path(outp).write_bytes(data)
    print(f"merged {len(data):,} bytes into {outp}")
    return 0


def cmd_dir(archive, files, sw) -> int:
    """Directory-style listing with per-directory totals."""
    from .jidac.extract import select_files
    data, jd = _load_index(archive, sw)
    dirs: Dict[str, List[int]] = {}
    for n in select_files(jd, files):
        d = str(pathlib.PurePosixPath(n).parent)
        dirs.setdefault(d, [0, 0])
        dirs[d][0] += 1
        dirs[d][1] += max(jd.dt[n].size, 0)
    for d in sorted(dirs):
        cnt, size = dirs[d]
        print(f"{size:>14,}  {cnt:>6} files  {d}")
    return 0


def cmd_backup(archive, files, sw) -> int:
    """Multipart backup: one new part per run plus a .txt index with
    per-part sizes and hashes (reference backup command semantics,
    CHANGELOG.md:405-442). Modeled blocks take the card or the host engine
    as in ``a``."""
    import glob
    from . import native
    from .jidac.add import add
    base = archive[:-5] if archive.endswith(".zpaq") else archive
    spec = base + "_????????.zpaq"
    nfiles, nfrags, nbytes = add(spec, files, method=_method(sw),
                                 key=_key(sw), use_device=_use_device(sw))
    lines = []
    for p in sorted(glob.glob(spec)):
        d = pathlib.Path(p).read_bytes()
        lines.append(f"{pathlib.Path(p).name} {len(d)} "
                     f"{native.crc32(d):08X} {native.xxh64(d):016X}")
    idx = pathlib.Path(base + "_backup.txt")
    idx.write_text("\n".join(lines) + "\n")
    print(f"{nfiles} files added, {nbytes:,} bytes; "
          f"{len(lines)} parts indexed in {idx}")
    return 0


def cmd_testbackup(archive, files, sw) -> int:
    """Verify every part against the backup index."""
    from . import native
    base = archive[:-5] if archive.endswith(".zpaq") else archive
    idx = pathlib.Path(base + "_backup.txt")
    if not idx.exists():
        print(f"missing {idx}", file=sys.stderr)
        return 2
    bad = 0
    for line in idx.read_text().splitlines():
        name, size, crc, xxh = line.split()
        p = pathlib.Path(idx.parent, name)
        if not p.exists():
            print(f"missing part {name}")
            bad += 1
            continue
        d = p.read_bytes()
        if (len(d) != int(size) or f"{native.crc32(d):08X}" != crc
                or f"{native.xxh64(d):016X}" != xxh):
            print(f"part differs: {name}")
            bad += 1
    print(f"testbackup: {bad} bad parts")
    return 2 if bad else 0


def cmd_versum(archive, files, sw) -> int:
    """Per-file stored checksums (hashdeep-style listing)."""
    from .jidac.extract import select_files
    data, jd = _load_index(archive, sw)
    for n in select_files(jd, files):
        d = jd.dt[n]
        crc = f"{d.crc32:08X}" if d.crc32 is not None else "-"
        xxh = f"{d.xxh64:016X}" if d.xxh64 is not None else "-"
        print(f"{crc}  {xxh}  {d.size:>12}  {n}")
    return 0


def cmd_dump(archive, files, sw) -> int:
    """Dump the archive's block map: jDC names, offsets, sizes, fragment
    ranges (diagnostic; the reference's dump command); -stat adds each
    d block's model."""
    data, jd = _load_index(archive, sw)
    print(f"{data.size():,} bytes, {len(jd.ver) - 1} versions, "
          f"{len(jd.ht) - 1} fragments, {len(jd.block)} d-blocks, "
          f"{sum(1 for d in jd.dt.values() if d.date)} files")
    for vi, v in enumerate(jd.ver[1:], 1):
        print(f"version {vi}: date {v.date} offset {v.offset:,} "
              f"csize {v.csize:,} +{v.updates} -{v.deletes} "
              f"firstfrag {v.firstFragment}")
    stat = "stat" in sw
    comp_names = {1: "CONST", 2: "CM", 3: "ICM", 4: "MATCH", 5: "AVG",
                  6: "MIX2", 7: "MIX", 8: "ISSE", 9: "SSE"}
    for b in jd.block:
        print(f"  d-block @{b.offset:<12,} bsize {b.bsize:<10,} "
              f"frags {b.start}..{b.start + b.frags - 1} "
              f"usize {b.usize:,}")
        if stat:
            # model statistics: the Decompresser::stat analog
            # (libzpaq.h:1256; memory model libzpaq.cpp:978-998)
            from .parallel.engine import parse_block_payload
            try:
                raw = data.read_range(b.offset, min(b.bsize or 4096, 65536))
                model, _start, _pl = parse_block_payload(raw, 0)
                comps = " ".join(
                    f"{comp_names.get(c[0], c[0])}"
                    f"({','.join(map(str, c[1:]))})"
                    for c in model.comps) or "store"
                print(f"    model: n={model.n} [{comps}] "
                      f"decode-mem {model.memory():,} B "
                      f"pcomp {'yes' if model.pcomp else 'no'}")
            except Exception as e:      # noqa: BLE001 - reported per block
                print(f"    model: unreadable ({e})")
    return 0


def cmd_password(archive, files, sw) -> int:
    """Re-encrypt the archive with a new password (reference password).

    -key OLD gives the current password (omit if plaintext); the new
    password is the first positional after the archive ('' = decrypt)."""
    from .codec import crypto
    if not files:
        print("password requires the new password as an argument "
              "(use \"\" to remove encryption)", file=sys.stderr)
        return 2
    new_pw = files[0]
    raw = _read_archive_bytes(archive)
    old_pw = _key(sw)
    plain = crypto.decrypt_archive(raw, old_pw) if old_pw else raw
    if new_pw:
        salt = crypto.new_salt()
        out = salt + crypto.encrypt_append(plain, new_pw, salt,
                                           crypto.SALT_LEN)
    else:
        out = plain
    pathlib.Path(archive).write_bytes(out)
    print(f"{archive}: {'re-encrypted' if new_pw else 'decrypted'} "
          f"({len(out):,} bytes)")
    return 0


def cmd_autotest(archive, files, sw) -> int:
    """Self-test, the analog of the reference's built-in autotest command:
    extract the golden archive named by ``-golden FILE`` (the reference
    zpaqfranz's AUTOTEST/sha256.zpaq, whose file names are the SHA-256 of
    their contents; skipped without it and under ``-quick``) and round-trip
    every compression level on a small mixed tree. Levels 3-5 code and
    decode on the card or the host engine as ``a`` and ``x`` do; ``-all``
    adds the expected-failure cases (``_autotest_all``)."""
    import os
    import random
    import tempfile
    from .jidac.add import add
    from .jidac.extract import extract
    from .jidac.index import read_archive
    use_device = _use_device(sw)
    golden = sw.get("golden", [None])[0]
    errors = 0
    with tempfile.TemporaryDirectory() as td:
        if golden and "quick" not in sw:
            data = pathlib.Path(golden).read_bytes()
            jd = read_archive(data)
            n, total = extract(data, jd, td + "/golden",
                               use_device=use_device)
            for p in pathlib.Path(td, "golden").iterdir():
                if (hashlib.sha256(p.read_bytes()).hexdigest().upper()
                        != p.name.upper()):
                    print(f"golden mismatch: {p.name}")
                    errors += 1
            print(f"golden archive: {n} files, {errors} errors")
        # round-trip every level on a small mixed tree
        src = pathlib.Path(td, "src")
        src.mkdir()
        rng = random.Random(1)
        (src / "text").write_bytes(b"the quick brown fox " * 300)
        (src / "bin").write_bytes(bytes(rng.randrange(256)
                                        for _ in range(4000)))
        (src / "zero").write_bytes(bytes(3000))
        cwd = os.getcwd()
        os.chdir(td)
        try:
            for lvl in "012345":
                arc = pathlib.Path(td, f"t{lvl}.zpaq")
                add(str(arc), ["src"], method=lvl, use_device=use_device)
                data = arc.read_bytes()
                jd = read_archive(data)
                out = pathlib.Path(td, f"out{lvl}")
                extract(data, jd, str(out), use_device=use_device)
                for p in src.iterdir():
                    if (out / "src" / p.name).read_bytes() != p.read_bytes():
                        print(f"level {lvl} mismatch: {p.name}")
                        errors += 1
                print(f"level {lvl}: OK ({arc.stat().st_size:,} bytes)")
        finally:
            os.chdir(cwd)
        if "all" in sw:
            errors += _autotest_all(td, src, use_device)
    print(f"autotest: {'PASS' if errors == 0 else f'{errors} ERRORS'}")
    return 2 if errors else 0


def _autotest_all(td: str, src: pathlib.Path,
                  use_device: Optional[bool]) -> int:
    """Extended self-test (the reference's `autotest -all`,
    CHANGELOG.md:693-697): expected-FAILURE cases (corruption, wrong
    password, garbage input must be *detected*, not crash or silently pass)
    plus per-operation timing (CHANGELOG.md:107-109 times operations).
    Returns the error count; prints |STAT| timing lines. A missing card is
    not a detection: it raises."""
    import io
    import os
    from contextlib import redirect_stderr, redirect_stdout
    from . import native
    from .codec.container import FormatError
    from .device import NoDeviceError
    from .jidac.add import add
    from .jidac.archive_io import ArchiveSource
    from .jidac.extract import ExtractError, extract, verify_archive
    from .jidac.index import read_archive, read_archive_src

    errors = 0

    def expect_fail(name, fn):
        nonlocal errors
        t0 = time.perf_counter()
        buf = io.StringIO()
        try:
            with redirect_stdout(buf), redirect_stderr(buf):
                fn()
        except NoDeviceError:
            raise
        except (FormatError, ExtractError, native.NativeError, ValueError,
                RuntimeError):
            print(f"|STAT| autotest op={name} "
                  f"s={time.perf_counter() - t0:.3f} "
                  f"expected-failure=detected")
            return
        print(f"autotest: {name} should have FAILED but passed")
        errors += 1

    def timed(name, fn):
        nonlocal errors
        t0 = time.perf_counter()
        try:
            fn()
            print(f"|STAT| autotest op={name} "
                  f"s={time.perf_counter() - t0:.3f} ok=1")
        except NoDeviceError:
            raise
        except Exception as e:          # noqa: BLE001 - report, count
            print(f"autotest: {name} FAILED: {type(e).__name__}: {e}")
            errors += 1

    cwd = os.getcwd()
    os.chdir(td)
    try:
        arc = pathlib.Path(td, "all.zpaq")
        timed("add-m2", lambda: add(str(arc), ["src"], method="2"))
        data = bytearray(arc.read_bytes())

        # corruption inside the d block must fail the integrity test
        def verify_corrupt():
            bad = bytes(data[: len(data) // 2]) \
                + bytes([data[len(data) // 2] ^ 0x41]) \
                + bytes(data[len(data) // 2 + 1:])
            verify_archive(bad, read_archive(bad), use_device=use_device)
        expect_fail("verify-corrupt-dblock", verify_corrupt)

        # garbage input is not an archive: the CLI open path rejects it by
        # magic; the tolerant block scanner sees an empty index (both are
        # reference behaviors: zsfx.cpp:1323-1332 magic check vs the
        # error-isolated block scan)
        def open_garbage():
            junk = pathlib.Path(td, "junk.zpaq")
            junk.write_bytes(b"\x00\xffnot-zpaq" * 400)
            ArchiveSource.from_spec(str(junk))
        expect_fail("open-garbage", open_garbage)

        def scan_garbage():
            jd = read_archive(b"\x00\xffnot-zpaq" * 400)
            if jd.block or jd.dt:
                raise RuntimeError("garbage scanned as non-empty archive")
        timed("scan-garbage-empty", scan_garbage)

        # encrypted round-trip, then the wrong password must be rejected
        enc = pathlib.Path(td, "enc.zpaq")
        timed("add-encrypted",
              lambda: add(str(enc), ["src"], method="1", key="pw-ok"))

        def wrong_pw():
            read_archive_src(ArchiveSource.from_spec(str(enc), key="pw-BAD"))
        expect_fail("wrong-password", wrong_pw)

        def right_pw():
            src_ = ArchiveSource.from_spec(str(enc), key="pw-ok")
            extract(src_, read_archive_src(src_),
                    str(pathlib.Path(td, "enc_out")), use_device=use_device)
        timed("extract-encrypted", right_pw)

        # truncation: the incomplete trailing transaction is ignored
        def truncated():
            half = bytes(data[: len(data) // 2])
            jd = read_archive(half)
            if jd.block:
                verify_archive(half, jd, use_device=use_device)
        timed("read-truncated-trims", truncated)

        # streaming-format round-trip
        sarc = pathlib.Path(td, "s.zpaq")
        timed("add-streaming", lambda: add(str(sarc), ["src"], method="s4.0"))

        def s_roundtrip():
            d = sarc.read_bytes()
            extract(d, read_archive(d), str(pathlib.Path(td, "s_out")),
                    use_device=use_device)
            for p in src.iterdir():
                got = pathlib.Path(td, "s_out", "src", p.name).read_bytes()
                if got != p.read_bytes():
                    raise RuntimeError(f"streaming mismatch: {p.name}")
        timed("extract-streaming", s_roundtrip)
    finally:
        os.chdir(cwd)
    return errors


def _hash_one(algo: str, data: bytes) -> str:
    """Hasher zoo dispatch (reference README.md:96-105 enumerates the set).
    All digests native C++ (hashes.cpp)."""
    from . import native
    if algo == "crc32":
        return f"{native.crc32(data):08X}"
    if algo in ("xxhash64", "xxhash", "xx64"):
        return f"{native.xxh64(data):016X}"
    if algo in ("xxh3", "xxh3128", "xx3"):
        return native.xxh3_128(data).hex().upper()
    if algo == "xxh3_64":
        return f"{native.xxh3_64(data):016X}"
    if algo == "wyhash":
        return f"{native.wyhash(data):016X}"
    if algo in ("highway64", "highway"):
        return f"{native.highway64(data):016X}"
    if algo == "highway128":
        return native.highway128(data).hex().upper()
    if algo == "highway256":
        return native.highway256(data).hex().upper()
    if algo in ("zeta", "zetaenc"):
        # zetaenc hashes the on-disk (possibly encrypted) bytes; for a
        # plain file the two coincide (reference CHANGELOG.md:444)
        return f"{native.zeta(data):016X}"
    fn = {"sha1": native.sha1, "sha256": native.sha256,
          "sha3": native.sha3_256, "md5": native.md5,
          "blake3": native.blake3, "whirlpool": native.whirlpool,
          "nilsimsa": native.nilsimsa}[algo]
    return fn(data).hex().upper()


SUM_ALGOS = ("sha1", "sha256", "sha3", "md5", "blake3", "whirlpool",
             "crc32", "xxhash64", "xxhash", "xx64", "xxh3", "xxh3_64",
             "wyhash", "highway64", "highway", "highway128", "highway256",
             "nilsimsa", "zeta", "zetaenc")

#: bytes of file data hashed in one launch of a lane kernel
SUM_BATCH_BYTES = 1 << 30


def sum_lines(paths: Sequence, algo: str, use_device: Optional[bool] = True,
              device=None) -> List[str]:
    """``DIGEST  path`` lines of ``sum`` for ``paths``. SHA-1 and SHA-256
    hash every file as one lane of the SHA-1 / SHA-256 lane kernel on
    ``device`` (None = the CUDA card, which must be present; "cpu" = the
    plain PyTorch versions), in launches of up to ``SUM_BATCH_BYTES``; a
    file larger than a launch takes (``sha1.MAX_DATA``) goes to the native
    hasher, which gives the same digest. ``use_device=False`` and the
    other algorithms use the native hashers; None asks the engine gate
    (``device_policy``, kind "hash") on the files' bytes."""
    if algo in ("sha1", "sha256") and use_device is None:
        from .device_policy import resolve
        use_device = resolve(None, "hash", sum(
            pathlib.Path(p).stat().st_size for p in paths))
    if not (use_device and algo in ("sha1", "sha256")):
        return [f"{_hash_one(algo, pathlib.Path(p).read_bytes())}  {p}"
                for p in paths]
    from .device import resolve
    from .ops import sha1, sha256
    dev = resolve(device)
    lanes = sha1.sha1_lanes if algo == "sha1" else sha256.sha256_lanes
    lines: List[str] = []
    batch: List = []
    datas: List[bytes] = []
    size = 0

    def flush() -> None:
        digests = sha1.to_digests(lanes(*sha1.pack_messages(datas, dev)))
        lines.extend(f"{d.hex().upper()}  {p}" for p, d in zip(batch, digests))
        batch.clear()
        datas.clear()

    for p in paths:
        data = pathlib.Path(p).read_bytes()
        if datas and (size + len(data) > SUM_BATCH_BYTES
                      or len(data) > sha1.MAX_DATA):
            flush()
            size = 0
        if len(data) > sha1.MAX_DATA:
            lines.append(f"{_hash_one(algo, data)}  {p}")
            continue
        batch.append(p)
        datas.append(data)
        size += len(data)
    if batch:
        flush()
    return lines


def cmd_sum(archive, files, sw) -> int:
    algo = "sha1"
    for k in SUM_ALGOS:
        if k in sw:
            algo = k
            break
    targets = [archive] + list(files) if archive else files
    paths = []
    for t in sorted(targets):
        p = pathlib.Path(t)
        if p.is_dir():
            paths += [s for s in sorted(p.rglob("*")) if s.is_file()]
        elif p.is_file():
            paths.append(p)
    if algo in ("zeta", "zetaenc"):
        # The reference's ZETA construction lives only in the missing
        # zpaqfranz.cpp; ours is a documented reconstruction, so digests
        # are NOT interoperable with zpaqfranz's own zeta output.
        print("note: zeta digests are a local dialect "
              "(not bit-compatible with zpaqfranz)")
    for line in sum_lines(paths, algo, use_device=_use_device(sw)):
        print(line)
    return 0


def cmd_bench(archive, files, sw) -> int:
    """Quick host benchmark (the reference's 'b' franzomips analog), then
    the engine gate's calibration (``device_bench.calibrate``): SHA-1 and
    -m3, -m4 and -m5 at 1 lane and a wider lane count, on the card beside
    the host engine, or with ``-notpu`` the host engine alone. Every stage
    goes into the gate's record; then the record and, per method, the
    gate's decision at 1, 8 and 64 lanes.

    Each host primitive is warmed once, then timed best-of-3 over a fixed
    byte budget."""
    import json
    from . import device_policy, native
    from .codec.methods import make_model
    from .parallel import device_bench as db

    def best_of(fn, reps: int = 3) -> float:
        fn()                         # warm caches / allocate tables
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            best = min(best, time.perf_counter() - t0)
        return best

    rng_data = (b"the quick brown fox jumps over the lazy dog " * 3000)
    model, _ = make_model("x4.0ci1")
    sha_t = best_of(lambda: native.sha1(rng_data))
    lz_t = best_of(lambda: native.lz77_encode(rng_data))
    cm_t = best_of(
        lambda: native.compress_block(model, rng_data[:30000], b"b", b"c"))
    mb = len(rng_data) / 1e6
    print(f"sha1 {mb / sha_t:7.1f} MB/s | lz77 {mb / lz_t:7.1f} MB/s | "
          f"cm-encode {0.03 / cm_t:7.2f} MB/s | "
          f"tpu-franzomips {int(mb / sha_t + mb / lz_t + 3000 * 0.03 / cm_t)}")
    host_only = _use_device(sw) is False
    print(f"engine gate calibration: SHA-1 lanes, then -m"
          f"{', -m'.join(db.CAL_METHODS)} at 1 lane and up to "
          f"{db.CAL_WIDE} lanes of {db.CAL_LANE_BYTES:,} bytes, "
          + ("the host engine alone" if host_only
             else "on the card beside the host engine"), flush=True)
    t0 = time.perf_counter()
    for name, st in db.calibrate(host_only=host_only).items():
        print(db.stage_line(name, st), flush=True)
    cal = device_policy.load_calibration()
    print(f"record {device_policy.cal_path()} "
          f"({time.perf_counter() - t0:.1f} s): {json.dumps(cal)}")
    for method in db.CAL_METHODS:
        for lanes in (1, 8, 64):
            d = device_policy.decide("codec", 0, method, lanes)
            print(f"  gate {d.why}")
    return 0


def cmd_1on1(archive, files, sw) -> int:
    """Byte-compare two files, reporting the first difference offset."""
    if not files:
        print("1on1 requires two files", file=sys.stderr)
        return 2
    a, b = pathlib.Path(archive), pathlib.Path(files[0])
    da, db = a.read_bytes(), b.read_bytes()
    if da == db:
        print(f"identical ({len(da):,} bytes)")
        return 0
    n = min(len(da), len(db))
    diff = next((i for i in range(n) if da[i] != db[i]), n)
    print(f"differ at offset {diff:,} "
          f"(sizes {len(da):,} vs {len(db):,})")
    return 1


def cmd_comparehex(archive, files, sw) -> int:
    """Side-by-side hex dump of the first differing region of two files."""
    if not files:
        print("comparehex requires two files", file=sys.stderr)
        return 2
    da = pathlib.Path(archive).read_bytes()
    db = pathlib.Path(files[0]).read_bytes()
    n = min(len(da), len(db))
    diff = next((i for i in range(n) if da[i] != db[i]), None)
    if diff is None and len(da) == len(db):
        print(f"identical ({len(da):,} bytes)")
        return 0
    start = (diff if diff is not None else n) & ~15
    for off in range(start, min(start + 64, max(len(da), len(db))), 16):
        ha = da[off:off + 16].hex(" ")
        hb = db[off:off + 16].hex(" ")
        mark = "  " if ha == hb else "<>"
        print(f"{off:08X} {mark} {ha:<47} | {hb}")
    return 1


def cmd_count(archive, files, sw) -> int:
    """Count files/dirs/bytes under the given paths (reference count)."""
    targets = [archive] + list(files) if archive else ["."]
    nf = nd = nb = 0
    for t in targets:
        p = pathlib.Path(t)
        if p.is_file():
            nf += 1
            nb += p.stat().st_size
            continue
        for sub in p.rglob("*"):
            if sub.is_dir():
                nd += 1
            elif sub.is_file():
                nf += 1
                nb += sub.stat().st_size
    print(f"{nf:,} files, {nd:,} dirs, {nb:,} bytes")
    return 0


def cmd_dirsize(archive, files, sw) -> int:
    """Per-directory recursive sizes (reference s / dirsize)."""
    targets = [archive] + list(files) if archive else ["."]
    for t in sorted(targets):
        p = pathlib.Path(t)
        if not p.is_dir():
            if p.is_file():
                print(f"{p.stat().st_size:>14,}  {t}")
            continue
        total = cnt = 0
        for sub in p.rglob("*"):
            if sub.is_file():
                total += sub.stat().st_size
                cnt += 1
        print(f"{total:>14,}  {cnt:>7} files  {t}")
    return 0


def cmd_collision(archive, files, sw) -> int:
    """Find same-content file groups under the given paths by full hash
    (the reference collision hunts weak-hash collisions; contents are
    compared by SHA-256 so reported groups are true duplicates)."""
    from . import native
    groups: Dict[bytes, List[str]] = {}
    targets = [archive] + list(files) if archive else ["."]
    for t in targets:
        p = pathlib.Path(t)
        it = [p] if p.is_file() else sorted(p.rglob("*"))
        for sub in it:
            if sub.is_file():
                groups.setdefault(native.sha256(sub.read_bytes()),
                                  []).append(str(sub))
    dups = {k: v for k, v in groups.items() if len(v) > 1}
    for k, v in sorted(dups.items()):
        print(f"{k.hex()[:16]}:")
        for name in v:
            print(f"  {name}")
    print(f"{len(dups)} duplicate groups of {len(groups)} distinct contents")
    return 0


def cmd_isopen(archive, files, sw) -> int:
    """Report whether the file can be opened exclusively (reference
    isopen; on POSIX approximated by open-for-append probing)."""
    p = pathlib.Path(archive)
    if not p.exists():
        print(f"{archive}: does not exist")
        return 2
    try:
        with open(p, "ab"):
            pass
        print(f"{archive}: not locked")
        return 0
    except OSError as e:
        print(f"{archive}: locked ({e})")
        return 1


def cmd_utf(archive, files, sw) -> int:
    """List files whose names contain non-ASCII or control characters
    (reference utf); -fix renames them to sanitized ASCII."""
    targets = [archive] + list(files) if archive else ["."]
    fix = "fix" in sw or "force" in sw
    shown = 0
    for t in targets:
        p = pathlib.Path(t)
        it = [p] if p.is_file() else sorted(p.rglob("*"))
        for sub in it:
            name = sub.name
            if all(32 <= ord(ch) < 127 for ch in name):
                continue
            shown += 1
            safe = "".join(ch if 32 <= ord(ch) < 127 else "_"
                           for ch in name)
            print(f"{sub}  ->  {safe}" if fix else f"{sub}")
            if fix:
                sub.rename(sub.with_name(safe))
    print(f"{shown} suspect names{' fixed' if fix else ''}")
    return 0


def cmd_cp(archive, files, sw) -> int:
    """Resumable file copy (reference cp): continues a partial copy by
    appending from the destination's current size after verifying the
    overlap."""
    if not files:
        print("cp requires a destination", file=sys.stderr)
        return 2
    src, dst = pathlib.Path(archive), pathlib.Path(files[0])
    if dst.is_dir():
        dst = dst / src.name
    data = src.read_bytes()
    done = dst.stat().st_size if dst.exists() else 0
    if done:
        if dst.read_bytes() != data[:done]:
            print("destination prefix differs; use a fresh name",
                  file=sys.stderr)
            return 2
        if done >= len(data):
            print(f"already complete ({done:,} bytes)")
            return 0
    with open(dst, "ab") as f:
        f.write(data[done:])
    print(f"copied {len(data) - done:,} bytes "
          f"({'resumed at ' + format(done, ',') if done else 'full'})")
    return 0


def cmd_robocopy(archive, files, sw) -> int:
    """Mirror source dir into destination dirs (reference r): copy new/
    changed files; with -kill also delete extraneous destination files."""
    import shutil
    if not files:
        print("r requires source and destination dirs", file=sys.stderr)
        return 2
    src = pathlib.Path(archive)
    copied = deleted = 0
    for dest in files:
        dst = pathlib.Path(dest)
        dst.mkdir(parents=True, exist_ok=True)
        srcfiles = {p.relative_to(src): p for p in src.rglob("*")
                    if p.is_file()}
        for rel, sp in sorted(srcfiles.items()):
            dp = dst / rel
            if (not dp.exists() or dp.stat().st_size != sp.stat().st_size
                    or dp.stat().st_mtime < sp.stat().st_mtime):
                dp.parent.mkdir(parents=True, exist_ok=True)
                shutil.copy2(sp, dp)
                copied += 1
        if "kill" in sw:
            for dp in sorted(dst.rglob("*"), reverse=True):
                rel = dp.relative_to(dst)
                if dp.is_file() and rel not in srcfiles:
                    dp.unlink()
                    deleted += 1
                elif dp.is_dir() and not any(dp.iterdir()):
                    dp.rmdir()
    print(f"{copied} copied, {deleted} deleted")
    return 0


def cmd_zero(archive, files, sw) -> int:
    """Delete empty directories under the given path (reference z)."""
    removed = 0
    root = pathlib.Path(archive)
    if "force" not in sw and "kill" not in sw:
        for d in sorted(root.rglob("*")):
            if d.is_dir() and not any(d.iterdir()):
                print(f"would remove {d}")
                removed += 1
        print(f"{removed} empty dirs (add -kill to remove)")
        return 0
    for d in sorted(root.rglob("*"), reverse=True):
        if d.is_dir() and not any(d.iterdir()):
            d.rmdir()
            removed += 1
    print(f"{removed} empty dirs removed")
    return 0


def cmd_rd(archive, files, sw) -> int:
    """Remove a directory tree (reference rd). Requires -kill."""
    import shutil
    root = pathlib.Path(archive)
    if "kill" not in sw:
        n = sum(1 for _ in root.rglob("*")) if root.exists() else 0
        print(f"would remove {root} ({n} entries); add -kill to confirm")
        return 0
    if root.exists():
        shutil.rmtree(root)
        print(f"removed {root}")
    return 0


def cmd_pause(archive, files, sw) -> int:
    """Wait for Enter (reference pause; useful at end of scripts)."""
    try:
        input("Press Enter to continue...")
    except EOFError:
        pass
    return 0


def cmd_sync(archive, files, sw) -> int:
    """Report what an 'a' run would change: new/changed/deleted files
    vs the archive index (reference sync, CHANGELOG.md:65-71)."""
    from .jidac.add import scan_files
    data, jd = _load_index(archive, sw)
    ext = scan_files(files or ["."])
    new = changed = deleted = 0
    for name, (fdate, fsize, fattr) in sorted(ext.items()):
        d = jd.dt.get(name)
        if d is None or not d.date:
            new += 1
            print(f"+ {name}")
        elif d.date != fdate or d.size != fsize:
            changed += 1
            print(f"# {name}")
    for name, d in sorted(jd.dt.items()):
        if d.date and name not in ext:
            deleted += 1
            print(f"- {name}")
    print(f"{new} new, {changed} changed, {deleted} deleted")
    return 0 if not (new or changed or deleted) else 1


def cmd_zfsbackup(archive, files, sw) -> int:
    """Snapshot-consistent dataset backup: zfs snapshot + (incremental)
    send stream appended to the archive (reference zfs family,
    man/zpaqfranz.pod:115-122; CHANGELOG.md:962-982)."""
    from .jidac.zfs import zfs_backup
    if not files:
        print("zfsbackup archive dataset [-full] [-key PW]", file=sys.stderr)
        return 2
    snap, nbytes = zfs_backup(archive, files[0], key=_key(sw),
                              method=_method(sw), full="full" in sw,
                              use_device=_use_device(sw))
    print(f"snapshot {snap}: {_fmt_size(nbytes)} stream bytes archived")
    return 0


def cmd_zfsrestore(archive, files, sw) -> int:
    from .jidac.zfs import zfs_restore
    if not files:
        print("zfsrestore archive dataset [-to DATASET] [-key PW]",
              file=sys.stderr)
        return 2
    n = zfs_restore(archive, files[0], to=sw.get("to", [None])[0],
                    key=_key(sw), use_device=_use_device(sw))
    print(f"{n} streams received")
    return 0


def cmd_zfslist(archive, files, sw) -> int:
    """List this tool's snapshots on a dataset (archive arg is the
    dataset, matching the reference's positional grammar)."""
    from .jidac.zfs import our_snapshots
    ds = archive if archive else (files[0] if files else None)
    if ds is None:
        print("zfslist dataset", file=sys.stderr)
        return 2
    ds = ds.removesuffix(".zpaq")
    for s_ in our_snapshots(ds):
        print(s_)
    return 0


def cmd_zfspurge(archive, files, sw) -> int:
    from .jidac.zfs import zfs_purge
    ds = archive if archive else (files[0] if files else None)
    if ds is None:
        print("zfspurge dataset [-keep N]", file=sys.stderr)
        return 2
    ds = ds.removesuffix(".zpaq")
    victims = zfs_purge(ds, keep=int(sw.get("keep", ["0"])[0]))
    print(f"destroyed {len(victims)} snapshots")
    return 0


def cmd_zfsadd(archive, files, sw) -> int:
    """zfsadd = zfsbackup alias (reference keeps both spellings)."""
    return cmd_zfsbackup(archive, files, sw)


def cmd_zfsreceive(archive, files, sw) -> int:
    return cmd_zfsrestore(archive, files, sw)


def _zfs_prox_stub(cmdname: str):
    def fn(archive, files, sw) -> int:
        print(f"{cmdname}: proxmox VM orchestration is out of scope "
              "(reference zfsproxbackup/zfsproxrestore wrap the plain zfs "
              "commands with Proxmox VM metadata; use zfsbackup/zfsrestore "
              "on the VM datasets directly)", file=sys.stderr)
        return 2
    return fn


def cmd_sfx(archive, files, sw) -> int:
    """Build a self-extracting POSIX executable: native engine + mini-jidac
    stub compiled on demand, archive appended with a magic trailer (the
    ELF equivalent of the reference's PE stub mechanism,
    ZSFX/zsfx.cpp:2494-2612). Encrypted archives are embedded decrypted
    (the stub has no scrypt); pass -key to decrypt first."""
    from .jidac.sfx import build_sfx
    src, _jd = _load_index(archive, sw)
    out = files[0] if files else archive.removesuffix(".zpaq") + ".sfx"
    n = build_sfx(src.bytes(), out)
    print(f"{out}: {_fmt_size(n)} bytes (self-extracting, run it to "
          f"unpack into ./ or pass a target dir)")
    return 0


def cmd_mysqldump(archive, files, sw) -> int:
    """Dump a MySQL/MariaDB database (mysqldump subprocess) and append the
    dump to the archive (reference mysqldump command; the dedup layer makes
    daily dumps nearly free). ZPAQ_MYSQLDUMP_CMD overrides the binary."""
    import os
    import shutil as _sh
    import subprocess
    import tempfile
    cmd = os.environ.get("ZPAQ_MYSQLDUMP_CMD") or _sh.which("mysqldump")
    if not cmd:
        print("mysqldump: binary not found (set ZPAQ_MYSQLDUMP_CMD)",
              file=sys.stderr)
        return 2
    db = files[0] if files else "--all-databases"
    from .jidac.add import add
    with tempfile.TemporaryDirectory() as td:
        name = f"mysqldump/{db.strip('-')}.sql"
        out = pathlib.Path(td) / name
        out.parent.mkdir(parents=True)
        with open(out, "wb") as f:
            r = subprocess.run([cmd, db] + files[1:], stdout=f,
                               stderr=subprocess.PIPE)
        if r.returncode != 0:
            print(f"mysqldump failed: {r.stderr.decode()[-500:]}",
                  file=sys.stderr)
            return 2
        cwd = os.getcwd()
        os.chdir(td)
        try:
            arc = archive if os.path.isabs(archive) else str(
                pathlib.Path(cwd) / archive)
            nfiles, _nfrags, nbytes = add(arc, [name], method=_method(sw),
                                          key=_key(sw),
                                          use_device=_use_device(sw))
        finally:
            os.chdir(cwd)
        dumped = out.stat().st_size
    print(f"{name}: {_fmt_size(dumped)} dumped, "
          f"{_fmt_size(nbytes)} archived")
    return 0


def _platform_stub(cmdname: str, why: str):
    def fn(archive, files, sw) -> int:
        print(f"{cmdname}: {why}", file=sys.stderr)
        return 2
    return fn


COMMANDS = {
    "a": cmd_add, "add": cmd_add,
    "x": cmd_extract, "e": cmd_extract, "extract": cmd_extract,
    "l": cmd_list, "ls": cmd_list, "list": cmd_list,
    "i": cmd_info, "info": cmd_info,
    "t": cmd_test, "test": cmd_test,
    "v": cmd_verify, "verify": cmd_verify,
    "versions": cmd_versions, "last": cmd_versions,
    "n": cmd_versions, "last2": cmd_versions,
    "sum": cmd_sum, "hash": cmd_sum,
    "p": cmd_paranoid, "paranoid": cmd_paranoid, "w": cmd_paranoid,
    "trim": cmd_trim,
    "crop": cmd_crop,
    "autotest": cmd_autotest,
    "b": cmd_bench, "bench": cmd_bench,
    "versum": cmd_versum,
    "backup": cmd_backup,
    "testbackup": cmd_testbackup,
    "f": cmd_find, "find": cmd_find, "fzf": cmd_find,
    "c": cmd_compare, "compare": cmd_compare,
    "d": cmd_delete, "delete": cmd_delete,
    "m": cmd_merge, "merge": cmd_merge, "consolidatebackup": cmd_merge,
    "dir": cmd_dir,
    "dump": cmd_dump,
    "password": cmd_password,
    "1on1": cmd_1on1,
    "comparehex": cmd_comparehex,
    "count": cmd_count,
    "s": cmd_dirsize, "dirsize": cmd_dirsize,
    "collision": cmd_collision,
    "isopen": cmd_isopen,
    "utf": cmd_utf,
    "cp": cmd_cp,
    "r": cmd_robocopy, "rsync": cmd_robocopy,
    "z": cmd_zero,
    "rd": cmd_rd, "k": cmd_rd,
    "pause": cmd_pause,
    "sync": cmd_sync,
    "sfx": cmd_sfx,
    "mysqldump": cmd_mysqldump,
    # platform and network services are not ported, as in the reference
    "update": _platform_stub(
        "update", "network self-update is out of scope (SURVEY.md #46); "
        "update the package with git/pip instead"),
    "upgrade": _platform_stub(
        "upgrade", "network self-update is out of scope (SURVEY.md #46)"),
    "download": _platform_stub(
        "download", "network fetch is out of scope (SURVEY.md #46)"),
    "ads": _platform_stub(
        "ads", "NTFS alternate data streams are Windows-only "
        "(SURVEY.md #44)"),
    "ntfs": _platform_stub(
        "ntfs", "NTFS/MFT disk imaging is Windows-only (SURVEY.md #44); "
        "image files archive as ordinary files"),
    "drive": _platform_stub(
        "drive", "Windows drive enumeration is out of scope (SURVEY.md "
        "#44)"),
    "work": _platform_stub(
        "work", "power/turbo management is host-platform tooling; use the "
        "OS governor directly"),
    "pakka": _platform_stub(
        "pakka", "the PAKKA GUI companion is Windows-only"),
    "kickstart": _platform_stub(
        "kickstart", "kickstart bootstraps a Windows install; out of "
        "scope"),
    "tui": _platform_stub(
        "tui", "interactive browser not implemented; use l/find/dir"),
    "zfsadd": cmd_zfsadd, "zfsbackup": cmd_zfsbackup,
    "zfslist": cmd_zfslist, "zfspurge": cmd_zfspurge,
    "zfsreceive": cmd_zfsreceive,
    "zfsrestore": cmd_zfsrestore,
    "zfsproxbackup": _zfs_prox_stub("zfsproxbackup"),
    "zfsproxrestore": _zfs_prox_stub("zfsproxrestore"),
}

# commands whose first positional is a plain file/dir path, not an archive
PLAIN_PATH_COMMANDS = {
    "sum", "hash", "1on1", "comparehex", "count", "s", "dirsize",
    "collision", "utf", "cp", "r", "rsync", "z", "rd", "k", "pause",
}

# commands that need no positional at all (reference: `zpaqfranz autotest`
# and `zpaqfranz b` run bare, man/zpaqfranz.pod:75-78)
NO_ARCHIVE_COMMANDS = {"autotest", "b", "bench"}


class _Progress:
    """1-second cadence progress/ETA line on stderr (the reference's
    print_progress, zsfx.cpp:1638; CHANGELOG.md:78-79). Active on a tty or
    with -verbose; silent under -summary/-terse."""

    def __init__(self, sw):
        self.enabled = (("verbose" in sw)
                        or (sys.stderr.isatty() and "summary" not in sw
                            and "terse" not in sw))
        self.t0 = time.time()
        self.last = 0.0
        self.drawn = False

    def __call__(self, done: int, total: int) -> None:
        now = time.time()
        if not self.enabled or not total or now - self.last < 1.0:
            return
        self.last = now
        rate = done / max(now - self.t0, 1e-9)
        eta = (total - done) / rate if rate > 0 else 0
        print(f"\r{done * 100 // total:3d}% "
              f"{done / 1e6:,.0f}/{total / 1e6:,.0f} MB "
              f"{rate / 1e6:,.1f} MB/s ETA {eta:,.0f}s   ",
              end="", file=sys.stderr)
        self.drawn = True

    def finish(self) -> None:
        if self.drawn:
            print(file=sys.stderr)


def _log_error(sw, msg: str) -> None:
    """Append to -errorlog FILE (reference CHANGELOG.md:480) and stderr."""
    print(msg, file=sys.stderr)
    path = sw.get("errorlog", [None])[0] if sw else None
    if path:
        import datetime
        stamp = datetime.datetime.now().strftime("%Y-%m-%d %H:%M:%S")
        try:
            with open(path, "a") as f:
                f.write(f"{stamp} {msg}\n")
        except OSError:
            pass


def main(argv: Optional[Sequence[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    cmd, archive, files, sw = _parse_args(argv)
    if cmd is None or cmd in ("h", "help", "-h", "--help"):
        print(__doc__)
        return 0
    fn = COMMANDS.get(cmd)
    if fn is None:
        print(f"unknown command {cmd!r}; commands: {' '.join(sorted(set(COMMANDS)))}",
              file=sys.stderr)
        return 2
    plain = cmd in PLAIN_PATH_COMMANDS
    if archive is None and not plain and cmd not in NO_ARCHIVE_COMMANDS:
        print("missing archive name", file=sys.stderr)
        return 2
    # -out FILE redirects stdout; -appendoutput appends
    # (reference CHANGELOG.md:156)
    out_path = sw.get("out", [None])[0]
    saved_stdout = None
    if out_path:
        saved_stdout = sys.stdout
        sys.stdout = open(out_path,
                          "a" if "appendoutput" in sw else "w")
    t0 = time.time()
    try:
        arg0 = archive if plain else (_archive_path(archive)
                                      if archive else None)
        with trace.span("op." + cmd) as op:
            rc = fn(arg0, files, sw)
            op.add(rc=rc)
        if "stat" in sw:
            # greppable stats lines (reference |STAT|, CHANGELOG.md:83-84)
            print(f"|STAT| cmd={cmd} rc={rc} seconds={time.time() - t0:.3f}")
        return rc
    except BrokenPipeError:
        # output piped into head/less that closed early: not an error
        import os
        try:
            sys.stdout.close()
        except Exception:
            pass
        sys.stdout = open(os.devnull, "w")
        return 0
    except FileNotFoundError as e:
        _log_error(sw, f"error: {e}")
        return 2
    except Exception as e:
        if "debug" in sw or "debug2" in sw:
            import traceback
            traceback.print_exc()
        _log_error(sw, f"error: {type(e).__name__}: {e}")
        return 2
    finally:
        if saved_stdout is not None:
            sys.stdout.close()
            sys.stdout = saved_stdout


if __name__ == "__main__":
    sys.exit(main())
