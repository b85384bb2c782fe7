"""zpaqfranz_tpu_torch command-line interface (the ported subset).

Positional grammar matching the reference (man/zpaqfranz.pod:75-131):

    python -m zpaqfranz_tpu_torch.cli <command> <archive>[.zpaq] [files...] [-switches]

Commands: a add, x e extract, l ls list, t test, sum hash, b bench.

Switches: -mN method, -to DIR, -until N|date, -fragment N, -threads N,
-key PW, -only PAT, -not PAT, -summary, -test, -tpu / -notpu, and for
``sum`` the hash name (-sha1 default, -sha256, -md5, -xxhash64, ...).
``a -m3..-m5``, ``x``, ``t``, ``sum -sha1/-sha256`` and the device stages
of ``b`` run on the CUDA card unless ``-notpu`` asks for the host engine
(``-tpu`` is accepted and changes nothing).
Exit codes follow the reference contract: 0 ok, 1 warnings, 2 errors.
"""

from __future__ import annotations

import pathlib
import sys
import time
from typing import Dict, List, Optional, Sequence


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


def _use_device(sw) -> bool:
    """Device-lane selection: ``-notpu`` asks for the host engine, anything
    else (``-tpu`` or no switch) for the CUDA card."""
    return "notpu" not in sw


def _load_index(archive: str, sw):
    """Open the archive as a streaming source and scan its index.

    Memory is O(index) + O(window) regardless of archive size: the source
    is file-backed (seek + decrypt-at-offset, native FileSource) and the
    scan skips d blocks via the c-block csize jump. Returns
    (ArchiveSource, Jidac); every downstream consumer (extract/verify/
    device decode) pulls block ranges through the source."""
    from .jidac.archive_io import ArchiveSource
    from .jidac.index import read_archive_src
    src = ArchiveSource.from_spec(archive, key=_key(sw))
    return src, read_archive_src(src, until=_until(sw))


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
    nblocks, nfrags = verify_archive(
        data, jd, threads=int(sw.get("threads", ["0"])[0]),
        use_device=_use_device(sw))
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


def sum_lines(paths: Sequence, algo: str, use_device: bool = True,
              device=None) -> List[str]:
    """``DIGEST  path`` lines of ``sum`` for ``paths``. SHA-1 and SHA-256
    hash every file as one lane of the SHA-1 / SHA-256 lane kernel on
    ``device`` (None = the CUDA card, which must be present; "cpu" = the
    plain PyTorch versions), in launches of up to ``SUM_BATCH_BYTES``; a
    file larger than a launch takes (``sha1.MAX_DATA``) goes to the native
    hasher, which gives the same digest. ``use_device=False`` and the
    other algorithms use the native hashers."""
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
    the device ladder's first two stages on the card unless ``-notpu``.

    Each host primitive is warmed once, then timed best-of-3 over a fixed
    byte budget."""
    from . import native
    from .codec.methods import make_model

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
    if not _use_device(sw):
        return 0
    from .parallel.device_bench import bootstrap_calibration, stage_line
    print("device bench: SHA-1 lanes, then -m3 at 256 lanes of 4 KiB, on the "
          "card beside the host engine", flush=True)
    for name, st in bootstrap_calibration().items():
        print(stage_line(name, st))
    return 0


COMMANDS = {
    "a": cmd_add, "add": cmd_add,
    "x": cmd_extract, "e": cmd_extract, "extract": cmd_extract,
    "l": cmd_list, "ls": cmd_list, "list": cmd_list,
    "t": cmd_test, "test": cmd_test,
    "sum": cmd_sum, "hash": cmd_sum,
    "b": cmd_bench, "bench": cmd_bench,
}

# commands whose first positional is a plain file/dir path, not an archive
PLAIN_PATH_COMMANDS = {"sum", "hash"}

# commands that need no positional at all (reference: `zpaqfranz b` runs
# bare, man/zpaqfranz.pod:75-78)
NO_ARCHIVE_COMMANDS = {"b", "bench"}


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
        rc = fn(arg0, files, sw)
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
