"""The reference's ZPAQ block decoder: ``zpaqd.c``, written for the
benchmark from the ZPAQ level-2 specification, built with the C compiler
into the benchmark's cache directory on first use.

It shares no code or table with the archiver under test: every HCOMP and
PCOMP program of a block runs in its own ZPAQL interpreter, so the
archive's own header decides what is decoded, and its squash and stretch
tables are held to libzpaq's published checksums when it loads.
"""

from __future__ import annotations

import ctypes as C
import fcntl
import hashlib
import os
import pathlib
import subprocess

SOURCE = pathlib.Path(__file__).resolve().parent / "zpaqd.c"
CFLAGS = ("-O2", "-fPIC", "-shared", "-std=c11", "-fwrapv")


def build(cache: pathlib.Path) -> pathlib.Path:
    """The decoder's library under ``cache``, compiled once (under a file
    lock, into a temporary file renamed into place)."""
    h = hashlib.sha1(" ".join(CFLAGS).encode() + SOURCE.read_bytes())
    so = cache / f"zpaqd-{h.hexdigest()[:12]}.so"
    if so.exists():
        return so
    cache.mkdir(parents=True, exist_ok=True)
    with open(cache / "zpaqd.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not so.exists():
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            subprocess.run([os.environ.get("CC", "cc"), *CFLAGS, "-o",
                            str(tmp), str(SOURCE), "-lm"],
                           check=True, capture_output=True)
            os.replace(tmp, so)
    return so


class Decoder:
    """Decodes whole ZPAQ blocks of an archive held in memory."""

    def __init__(self, cache: pathlib.Path):
        lib = C.CDLL(str(build(cache)))
        lib.zd_init.argtypes = [C.POINTER(C.c_uint32)] * 2
        lib.zd_states.restype = C.POINTER(C.c_ubyte)
        lib.zd_block.argtypes = [C.c_char_p, C.c_size_t, C.c_size_t,
                                 C.POINTER(C.POINTER(C.c_ubyte)),
                                 C.POINTER(C.c_size_t), C.c_char_p]
        lib.zd_free.argtypes = [C.POINTER(C.c_ubyte)]
        sq, st = C.c_uint32(), C.c_uint32()
        if lib.zd_init(C.byref(sq), C.byref(st)):
            raise RuntimeError(f"squash/stretch checksums {sq.value}, "
                               f"{st.value}: not libzpaq's")
        self.lib = lib

    def states(self) -> bytes:
        """The bit-history state table: per state, its next state on a 0
        and on a 1, and its counts of zeros and ones."""
        return C.string_at(self.lib.zd_states(), 1024)

    def block(self, archive: bytes, offset: int) -> bytes:
        """The decoded bytes of every segment of the block at ``offset``
        (ctypes releases the GIL, so threads decode blocks side by side).
        Raises ``ValueError`` on a block that does not decode."""
        out = C.POINTER(C.c_ubyte)()
        n = C.c_size_t()
        err = C.create_string_buffer(160)
        rc = self.lib.zd_block(archive, len(archive), offset,
                               C.byref(out), C.byref(n), err)
        try:
            data = C.string_at(out, n.value) if n.value else b""
        finally:
            self.lib.zd_free(out)
        if rc:
            raise ValueError(f"{err.value.decode()}, after {len(data)} "
                             "bytes")
        return data
