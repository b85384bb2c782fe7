"""ctypes binding for the native tzpaq host engine (native/src, built by
``ensure_built``).

The native engine is the fast scalar path: full-archive decode (the Python
oracle is ~1 KB/s on -m5 models), block compression for the CLI's host mode,
and the hashing hot loops. It must match the Python oracle bit-for-bit; the
format LUTs are installed from ``models.tables`` so there is one source of
truth.
"""

from __future__ import annotations

import ctypes as C
import fcntl
import hashlib
import os
import pathlib
import subprocess
from typing import List, Optional, Tuple

import numpy as np

from .models import tables as T

_ROOT = pathlib.Path(__file__).resolve().parent.parent
_NATIVE_DIR = _ROOT / "native"
_BUILD_DIR = _ROOT / "zpaqfranz_tpu_torch" / "build"
#: the engine's sources and the compiler flags of native/Makefile
SOURCES = ("tzpaq.cpp", "hashes.cpp")
CXXFLAGS = ("-O3", "-march=x86-64-v3", "-funroll-loops", "-fPIC",
            "-std=c++17", "-shared")

_lib = None


class NativeError(RuntimeError):
    pass


def _as_cptr(data):
    """bytes/bytearray pass through; mmap/memoryview/ndarray become a
    zero-copy c_char_p (the caller keeps the owner alive)."""
    if isinstance(data, (bytes, bytearray)):
        return data
    arr = np.frombuffer(data, np.uint8)
    return arr.ctypes.data_as(C.c_char_p)


def _out_buf(cap: int):
    """Uninitialized output buffer (create_string_buffer zero-fills, which
    costs a full memset pass on multi-MB blocks)."""
    arr = np.empty(cap, np.uint8)
    return arr, arr.ctypes.data_as(C.c_char_p)


def ensure_built() -> pathlib.Path:
    """Build the port's copy of the native engine if it is missing; return
    its path.

    The library is compiled from the shared sources under ``native/src``
    with native/Makefile's flags into ``zpaqfranz_tpu_torch/build/``, named
    by a hash of the sources and flags. One process compiles it under an
    exclusive file lock, into a temporary file renamed into place, so no
    process ever loads a library another one is still writing. (The tracked
    ``native/libtzpaq.so`` is rebuilt in place by the reference package's
    ``make`` whenever its sources look newer, which a fresh checkout can
    make true; a process loading it meanwhile fails with "file too
    short".)"""
    src = _NATIVE_DIR / "src"
    h = hashlib.sha1(" ".join(CXXFLAGS).encode())
    for name in SOURCES + ("tzpaq.h",):
        h.update((src / name).read_bytes())
    so = _BUILD_DIR / f"libtzpaq-{h.hexdigest()[:12]}.so"
    if so.exists():
        return so
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(_BUILD_DIR / "libtzpaq.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not so.exists():
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            subprocess.run([os.environ.get("CXX", "g++"), *CXXFLAGS, "-o",
                            str(tmp), *(str(src / n) for n in SOURCES)],
                           check=True, capture_output=True)
            os.replace(tmp, so)
    return so


def _load():
    global _lib
    if _lib is not None:
        return _lib
    lib = C.CDLL(str(ensure_built()))
    lib.tzs_open.restype = C.c_void_p
    lib.tzs_open.argtypes = [C.c_char_p, C.c_size_t]
    lib.tzs_open_paths.restype = C.c_void_p
    lib.tzs_open_paths.argtypes = [C.POINTER(C.c_char_p), C.c_int,
                                   C.c_char_p]
    lib.tzs_open_error.restype = C.c_char_p
    lib.tzs_size.restype = C.c_uint64
    lib.tzs_size.argtypes = [C.c_void_p]
    lib.tzs_read_raw.restype = C.c_size_t
    lib.tzs_read_raw.argtypes = [C.c_void_p, C.c_uint64, C.c_char_p,
                                 C.c_size_t]
    lib.tzs_close.argtypes = [C.c_void_p]
    lib.tzs_error.restype = C.c_char_p
    lib.tzs_error.argtypes = [C.c_void_p]
    lib.tzs_read_block.restype = C.c_long
    lib.tzs_read_block.argtypes = [C.c_void_p]
    lib.tzs_seg_count.restype = C.c_size_t
    lib.tzs_seg_count.argtypes = [C.c_void_p]
    lib.tzs_seg_filename.restype = C.c_char_p
    lib.tzs_seg_filename.argtypes = [C.c_void_p, C.c_size_t]
    lib.tzs_seg_comment.restype = C.c_char_p
    lib.tzs_seg_comment.argtypes = [C.c_void_p, C.c_size_t]
    lib.tzs_seg_data.restype = C.POINTER(C.c_ubyte)
    lib.tzs_seg_data.argtypes = [C.c_void_p, C.c_size_t]
    lib.tzs_seg_size.restype = C.c_size_t
    lib.tzs_seg_size.argtypes = [C.c_void_p, C.c_size_t]
    lib.tzs_seg_sha1.restype = C.c_int
    lib.tzs_seg_sha1.argtypes = [C.c_void_p, C.c_size_t, C.c_char_p]
    lib.tzs_tell.restype = C.c_uint64
    lib.tzs_tell.argtypes = [C.c_void_p]
    lib.tzs_seek.argtypes = [C.c_void_p, C.c_uint64]
    lib.tzs_verify_block.restype = C.c_long
    lib.tzs_verify_block.argtypes = [C.c_void_p, C.POINTER(C.c_uint32),
                                     C.c_size_t, C.c_char_p]
    lib.tzc_compress_block.restype = C.c_long
    lib.tzc_compress_block.argtypes = [
        C.c_char_p, C.c_size_t, C.c_char_p, C.c_size_t,
        C.c_char_p, C.c_size_t, C.c_char_p, C.c_char_p,
        C.c_char_p, C.c_int, C.c_char_p, C.c_size_t]
    lib.tz_sha1.argtypes = [C.c_char_p, C.c_size_t, C.c_char_p]
    lib.tz_sha1_many.argtypes = [C.c_char_p, C.POINTER(C.c_uint32),
                                 C.c_size_t, C.c_char_p]
    lib.tz_e8e9.argtypes = [C.c_char_p, C.c_int64]
    lib.tz_inverse_e8e9.argtypes = [C.c_char_p, C.c_int64]
    lib.tz_postprocess.restype = C.c_long
    lib.tz_postprocess.argtypes = [C.c_int, C.c_int, C.c_char_p, C.c_size_t,
                                   C.c_char_p, C.c_size_t]
    lib.tz_aes_ctr.argtypes = [C.c_char_p, C.c_int, C.c_char_p, C.c_char_p,
                               C.c_size_t, C.c_uint64]
    lib.tz_aes_block.argtypes = [C.c_char_p, C.c_int, C.c_char_p, C.c_char_p]
    lib.tz_bwt_encode.restype = C.c_size_t
    lib.tz_bwt_encode.argtypes = [C.c_char_p, C.c_size_t, C.c_char_p,
                                  C.c_size_t]
    lib.tz_lz77p_encode.restype = C.c_size_t
    lib.tz_lz77p_encode.argtypes = [C.c_char_p, C.c_size_t, C.c_int, C.c_int,
                                    C.c_int, C.c_int, C.c_char_p, C.c_size_t]
    lib.tz_lz77p_decode.restype = C.c_size_t
    lib.tz_lz77p_decode.argtypes = [C.c_char_p, C.c_size_t, C.c_int,
                                    C.c_char_p, C.c_size_t]
    lib.tz_lz77_encode.restype = C.c_size_t
    lib.tz_lz77_encode.argtypes = [C.c_char_p, C.c_size_t, C.c_int, C.c_int,
                                   C.c_int, C.c_char_p, C.c_size_t]
    lib.tz_lz77_parse.restype = C.c_size_t
    lib.tz_lz77_parse.argtypes = [C.c_char_p, C.c_size_t, C.c_int, C.c_int,
                                  C.c_int, C.c_int, C.c_int, C.c_int,
                                  C.c_int, C.c_int, C.c_char_p, C.c_size_t]
    lib.tz_cdc.restype = C.c_size_t
    lib.tz_cdc.argtypes = [C.c_char_p, C.c_size_t, C.c_int,
                           C.POINTER(C.c_uint32), C.c_size_t]
    lib.tz_crc32.restype = C.c_uint32
    lib.tz_crc32.argtypes = [C.c_uint32, C.c_char_p, C.c_size_t]
    lib.tz_xxh64.restype = C.c_uint64
    lib.tz_xxh64.argtypes = [C.c_char_p, C.c_size_t, C.c_uint64]
    lib.tz_digest_file.restype = C.c_size_t
    lib.tz_digest_file.argtypes = [
        C.c_char_p, C.c_size_t, C.c_int, C.POINTER(C.c_uint32), C.c_size_t,
        C.c_char_p, C.POINTER(C.c_uint32), C.POINTER(C.c_uint64)]
    lib.tz_md5.argtypes = [C.c_char_p, C.c_size_t, C.c_char_p]
    lib.tz_sha256.argtypes = [C.c_char_p, C.c_size_t, C.c_char_p]
    lib.tz_sha3_256.argtypes = [C.c_char_p, C.c_size_t, C.c_char_p]
    lib.tz_blake3.argtypes = [C.c_char_p, C.c_size_t, C.c_char_p]
    lib.tz_whirlpool.argtypes = [C.c_char_p, C.c_size_t, C.c_char_p]
    lib.tz_nilsimsa.argtypes = [C.c_char_p, C.c_size_t, C.c_char_p]
    lib.tz_xxh3_64.restype = C.c_uint64
    lib.tz_xxh3_64.argtypes = [C.c_char_p, C.c_size_t]
    lib.tz_xxh3_128.argtypes = [C.c_char_p, C.c_size_t, C.c_char_p]
    lib.tz_wyhash.restype = C.c_uint64
    lib.tz_wyhash.argtypes = [C.c_char_p, C.c_size_t, C.c_uint64]
    lib.tz_highway64.restype = C.c_uint64
    lib.tz_highway64.argtypes = [C.c_char_p, C.c_size_t, C.c_uint64 * 4]
    lib.tz_highway128.argtypes = [C.c_char_p, C.c_size_t, C.c_uint64 * 4,
                                  C.c_char_p]
    lib.tz_highway256.argtypes = [C.c_char_p, C.c_size_t, C.c_uint64 * 4,
                                  C.c_char_p]
    lib.tz_register_pcomp.argtypes = [C.c_char_p, C.c_size_t, C.c_int,
                                      C.c_int, C.c_int]
    lib.tz_register_hcomp.argtypes = [C.c_char_p, C.c_size_t, C.c_int]
    lib.tz_install_tables.argtypes = [C.c_char_p] * 6
    lib.tz_install_tables(
        T.SNS.tobytes(),
        T.CMINIT.astype(np.uint32).tobytes(),
        T.SQUASHT.astype(np.uint16).tobytes(),
        T.STRETCHT.astype(np.int16).tobytes(),
        T.DT.astype(np.int32).tobytes(),
        T.DT2K.astype(np.int32).tobytes(),
    )
    _lib = lib
    # teach the engine this framework's stored pcomp programs so decode of
    # LZ77/BWT/E8E9 blocks runs native inverses instead of the ZPAQL VM
    try:
        from .codec.methods import register_fast_pcomps
        register_fast_pcomps()
    except Exception:
        pass    # VM fallback still decodes everything correctly
    # ... and the standard-level HCOMP context programs, so the per-byte
    # context update runs a specialized native body instead of the
    # bytecode interpreter (host analog of ops/hcomp_fast.py)
    try:
        from .codec.methods import make_model
        for level in ("3", "4", "5"):
            model, _ = make_model(level)
            lib.tz_register_hcomp(model.hcomp, len(model.hcomp), int(level))
    except Exception:
        pass    # interpreter fallback is always correct
    return lib


def register_pcomp(code: bytes, kind: int, p1: int, p2: int) -> None:
    """Register a known PCOMP bytecode for the native fast inverse."""
    _load().tz_register_pcomp(code, len(code), kind, p1, p2)


class NativeSegment:
    __slots__ = ("filename", "comment", "data", "sha1", "offset")

    def __init__(self, filename, comment, data, sha1):
        self.filename = filename
        self.comment = comment
        self.data = data
        self.sha1 = sha1


class NativeStream:
    """Iterates blocks of an archive, decoding each fully.

    Construct over in-memory bytes, or via :meth:`open_paths` over
    (multipart, optionally encrypted) files — the reference InputArchive
    model (zsfx.cpp:401-568): seek-based, O(window) memory, AES-CTR
    decrypted at the absolute offset."""

    def __init__(self, data: Optional[bytes], _h=None):
        self._lib = _load()
        if _h is not None:
            self._buf = None
            self._h = _h
        else:
            self._buf = bytes(data)  # keep alive
            self._h = self._lib.tzs_open(self._buf, len(self._buf))

    @classmethod
    def open_paths(cls, paths, key32: Optional[bytes] = None
                   ) -> "NativeStream":
        """File-backed stream over archive part files in order.
        key32 = stretched 32-byte AES key (codec.crypto.stretch_key)."""
        lib = _load()
        arr = (C.c_char_p * len(paths))(
            *[str(p).encode() for p in paths])
        h = lib.tzs_open_paths(arr, len(paths), key32)
        if not h:
            raise NativeError(lib.tzs_open_error().decode())
        return cls(None, _h=h)

    def size(self) -> int:
        return self._lib.tzs_size(self._h)

    def read_raw(self, pos: int, n: int) -> bytes:
        """Raw (decrypted) archive bytes at an absolute offset."""
        buf = C.create_string_buffer(n)
        got = self._lib.tzs_read_raw(self._h, pos, buf, n)
        return buf.raw[:got]

    def close(self):
        if self._h:
            self._lib.tzs_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def tell(self) -> int:
        return self._lib.tzs_tell(self._h)

    def seek(self, pos: int) -> None:
        self._lib.tzs_seek(self._h, pos)

    def verify_block(self, ends) -> Tuple[int, bytes]:
        """Decode the block at the cursor and SHA-1 its output over
        consecutive spans (span i ends at ends[i]) without the decoded
        bytes ever crossing into Python — the 't' hot path.  Returns
        (decoded_size, count*20 digest bytes); raises on decode error or
        a short block."""
        n = len(ends)
        arr = (C.c_uint32 * max(n, 1))(*ends)
        out = C.create_string_buffer(max(n, 1) * 20)
        r = self._lib.tzs_verify_block(self._h, arr, n, out)
        if r == -2:
            raise NativeError("decoded block shorter than fragment table")
        if r < 0:
            raise NativeError(self._lib.tzs_error(self._h).decode())
        return int(r), out.raw[: n * 20]

    def read_block(self) -> Optional[List[NativeSegment]]:
        """Decode the next block; None at end of archive."""
        n = self._lib.tzs_read_block(self._h)
        if n == 0:
            return None
        if n < 0:
            raise NativeError(self._lib.tzs_error(self._h).decode())
        segs = []
        for i in range(n):
            size = self._lib.tzs_seg_size(self._h, i)
            ptr = self._lib.tzs_seg_data(self._h, i)
            data = C.string_at(ptr, size) if size else b""
            sha = C.create_string_buffer(20)
            has = self._lib.tzs_seg_sha1(self._h, i, sha)
            segs.append(NativeSegment(
                self._lib.tzs_seg_filename(self._h, i),
                self._lib.tzs_seg_comment(self._h, i),
                data, sha.raw if has else None))
        return segs

    def blocks(self):
        while True:
            segs = self.read_block()
            if segs is None:
                return
            yield segs


def decompress_stream(data: bytes) -> List[List[NativeSegment]]:
    """Decode every block of an archive with the native engine."""
    with NativeStream(data) as s:
        return list(s.blocks())


def compress_block(model, data: bytes, filename: bytes = b"",
                   comment: bytes = b"", sha1: Optional[bytes] = None,
                   tag: bool = True) -> bytes:
    """Native one-call block compressor (mirror of codec.writer)."""
    lib = _load()
    header = model.header_bytes()
    ppblob = model.pcomp_bytes() or b""
    cap = len(data) + len(data) // 2 + len(header) + 256
    arr, out = _out_buf(cap)
    rc = lib.tzc_compress_block(
        header, len(header), ppblob, len(ppblob), _as_cptr(data), len(data),
        filename, comment, sha1, 1 if tag else 0, out, cap)
    if rc < -1:
        cap = -rc
        arr, out = _out_buf(cap)
        rc = lib.tzc_compress_block(
            header, len(header), ppblob, len(ppblob), _as_cptr(data),
            len(data), filename, comment, sha1, 1 if tag else 0, out, cap)
    if rc < 0:
        raise NativeError("native compress_block failed")
    return arr[:rc].tobytes()


def sha1(data: bytes) -> bytes:
    lib = _load()
    out = C.create_string_buffer(20)
    lib.tz_sha1(data, len(data), out)
    return out.raw


def sha1_spans(data, ends) -> bytes:
    """SHA-1 of consecutive spans of one buffer (span i ends at ends[i],
    starts at ends[i-1] or 0): count*20 digest bytes in one GIL-released
    call through the two-stream SHA-NI loop (fragment verify hot path)."""
    lib = _load()
    n = len(ends)
    if n == 0:
        return b""
    arr = (C.c_uint32 * n)(*ends)
    out = C.create_string_buffer(n * 20)
    lib.tz_sha1_many(_as_cptr(data), arr, n, out)
    return out.raw


def e8e9_transform(data: bytes) -> bytes:
    lib = _load()
    buf = C.create_string_buffer(bytes(data), len(data))
    lib.tz_e8e9(buf, len(data))
    return buf.raw[:len(data)]


def e8e9_inverse(data: bytes) -> bytes:
    lib = _load()
    buf = C.create_string_buffer(bytes(data), len(data))
    lib.tz_inverse_e8e9(buf, len(data))
    return buf.raw[:len(data)]


def lz77_encode(data: bytes, min_match: int = 6, depth_log: int = 4,
                hash_bits: int = 22) -> bytes:
    """Byte-aligned LZ77 transform (reference level-2 stream format)."""
    lib = _load()
    # generous first-try capacity: incompressible input expands under
    # byte-aligned LZ77 (literal-run headers), and a retry re-encodes
    # the whole block — far costlier than the extra buffer
    cap = len(data) + len(data) // 8 + 1024
    arr, out = _out_buf(cap)
    need = lib.tz_lz77_encode(_as_cptr(data), len(data), min_match,
                              depth_log, hash_bits, out, cap)
    if need > cap:
        arr, out = _out_buf(need)
        need = lib.tz_lz77_encode(_as_cptr(data), len(data), min_match,
                                  depth_log, hash_bits, out, need)
    return arr[:need].tobytes()


def lz77_parse(data: bytes, fmt: int, min_match: int, min_match2: int = 0,
               lookahead: int = 0, depth_log: int = 3, hash_bits: int = 22,
               use_sa: int = 0, rb: int = 0) -> bytes:
    """Scored LZ77 parse: secondary context (N4), lookahead (N7), and the
    finder selector — the reference's high-ratio settings (libzpaq.h:154-175
    semantics). fmt 1 = packed, 2 = byte-aligned.

    use_sa: 0 = tagged hash buckets, 1 (True) = suffix array (N6 == N1+21),
    2 = hash chains (the -m2-class finder: near-SA candidate quality at
    hash-build cost)."""
    lib = _load()
    finder = int(use_sa)
    cap = len(data) + len(data) // 8 + 1024
    arr, out = _out_buf(cap)
    need = lib.tz_lz77_parse(_as_cptr(data), len(data), fmt, min_match,
                             min_match2, lookahead, depth_log, hash_bits,
                             finder, rb, out, cap)
    if need > cap:
        arr, out = _out_buf(need)
        need = lib.tz_lz77_parse(_as_cptr(data), len(data), fmt, min_match,
                                 min_match2, lookahead, depth_log,
                                 hash_bits, finder, rb, out,
                                 need)
    return arr[:need].tobytes()


def lz77p_encode(data: bytes, min_match: int = 5, depth_log: int = 3,
                 hash_bits: int = 22, rb: int = 0) -> bytes:
    """Packed (bit-level) LZ77 transform (reference level-1 stream format).

    ``rb`` = extra low offset bits = max(0, block_bits - 24)
    (libzpaq.cpp:6284 ``rb(args[0]>4 ? args[0]-4 : 0)``)."""
    lib = _load()
    cap = len(data) + len(data) // 16 + 1024
    arr, out = _out_buf(cap)
    need = lib.tz_lz77p_encode(_as_cptr(data), len(data), min_match,
                               depth_log, hash_bits, rb, out, cap)
    if need > cap:
        arr, out = _out_buf(need)
        need = lib.tz_lz77p_encode(_as_cptr(data), len(data), min_match,
                                   depth_log, hash_bits, rb, out, need)
    return arr[:need].tobytes()


def lz77p_decode(data: bytes, rb: int, out_hint: int = 0) -> bytes:
    """Native inverse of the packed LZ77 stream (test oracle / fast path;
    the format's decode-side truth is the stored ZPAQL pcomp)."""
    lib = _load()
    cap = max(out_hint, len(data) * 8 + 1024)
    while True:
        out = C.create_string_buffer(cap)
        n = lib.tz_lz77p_decode(data, len(data), rb, out, cap)
        if n <= cap:
            return out.raw[:n]
        cap = n


def postprocess(ph: int, pm: int, data: bytes, out_hint: int = 0) -> bytes:
    """Run the postprocessor over a decoded stream (selector prefix + body)."""
    lib = _load()
    cap = max(out_hint, len(data) * 4 + 1024)
    out = C.create_string_buffer(cap)
    rc = lib.tz_postprocess(ph, pm, data, len(data), out, cap)
    if rc < -1:
        cap = -rc
        out = C.create_string_buffer(cap)
        rc = lib.tz_postprocess(ph, pm, data, len(data), out, cap)
    if rc < 0:
        raise NativeError("postprocess failed")
    return out.raw[:rc]


def aes_ctr(key: bytes, iv8: bytes, data: bytes, offset: int) -> bytes:
    """AES-CTR keystream XOR at absolute byte offset (reference counter
    layout: iv8 as two MSB words + 64-bit block index)."""
    lib = _load()
    buf = C.create_string_buffer(bytes(data), len(data))
    lib.tz_aes_ctr(key, len(key), iv8, buf, len(data), offset)
    return buf.raw[: len(data)]


def aes_encrypt_block(key: bytes, block16: bytes) -> bytes:
    lib = _load()
    out = C.create_string_buffer(16)
    lib.tz_aes_block(key, len(key), block16, out)
    return out.raw


def bwt_encode(data: bytes) -> bytes:
    """BWT transform (reference level-3 stream format, n+5 bytes out)."""
    lib = _load()
    out = C.create_string_buffer(len(data) + 5)
    n = lib.tz_bwt_encode(data, len(data), out, len(data) + 5)
    return out.raw[:n]


def cdc_boundaries(data: bytes, mean_bits: int = 16) -> List[int]:
    """Content-defined chunk END offsets (exclusive, last == len(data))."""
    if not data:
        return []
    cap = max(16, len(data) // (1 << max(mean_bits - 5, 0)) + 16)
    ends = (C.c_uint32 * cap)()
    n = _load().tz_cdc(data, len(data), mean_bits, ends, cap)
    out = list(ends[:n])
    if not out or out[-1] != len(data):
        out.append(len(data))
    return out


def digest_file(data, mean_bits: int = 16
                ) -> Tuple[List[Tuple[bytes, int, int]], int, int]:
    """One native pass over a file: CDC + per-fragment SHA-1 + CRC-32 +
    XXH64. Returns ([(sha1, start, end) per fragment], crc32, xxh64).
    ``data``: bytes or an mmap/buffer (zero-copy: the kernel reads pages
    straight from the page cache; no Python-side read pass)."""
    lib = _load()
    if not len(data):
        return [], 0, lib.tz_xxh64(b"", 0, 0)
    cap = max(16, len(data) // (1 << max(mean_bits - 5, 0)) + 16)
    ends = (C.c_uint32 * cap)()
    shas = C.create_string_buffer(cap * 20)
    crc = C.c_uint32()
    xxh = C.c_uint64()
    n = lib.tz_digest_file(_as_cptr(data), len(data), mean_bits, ends, cap,
                           shas, C.byref(crc), C.byref(xxh))
    frags: List[Tuple[bytes, int, int]] = []
    start = 0
    raw = shas.raw
    for i in range(n):
        end = ends[i]
        frags.append((raw[i * 20:(i + 1) * 20], start, end))
        start = end
    if start < len(data):
        frags.append((sha1(bytes(data[start:])), start, len(data)))
    return frags, crc.value, xxh.value


def crc32(data: bytes, crc: int = 0) -> int:
    return _load().tz_crc32(crc, data, len(data))


def xxh64(data: bytes, seed: int = 0) -> int:
    return _load().tz_xxh64(data, len(data), seed)


# ---- hasher zoo (reference README.md:96-105; SURVEY.md section 2.7 #42) ----

def _fixed_out(fn_name: str, data: bytes, size: int) -> bytes:
    out = C.create_string_buffer(size)
    getattr(_load(), fn_name)(data, len(data), out)
    return out.raw


def md5(data: bytes) -> bytes:
    return _fixed_out("tz_md5", data, 16)


def sha256(data: bytes) -> bytes:
    return _fixed_out("tz_sha256", data, 32)


def sha3_256(data: bytes) -> bytes:
    return _fixed_out("tz_sha3_256", data, 32)


def blake3(data: bytes) -> bytes:
    return _fixed_out("tz_blake3", data, 32)


def whirlpool(data: bytes) -> bytes:
    return _fixed_out("tz_whirlpool", data, 64)


def nilsimsa(data: bytes) -> bytes:
    """256-bit locality-sensitive trigram hash (similarity semantics per
    the public Nilsimsa algorithm; substitution table reconstructed — see
    native/src/hashes.cpp)."""
    return _fixed_out("tz_nilsimsa", data, 32)


def zeta(data: bytes, chunk: int = 1 << 16) -> int:
    """ZETA: zpaqfranz's 'pseudo XXHASH64' streaming backup hash
    (reference CHANGELOG.md:405-407, 440-444 — computed on-the-fly in
    chunks as parts are written; exact formula lived in the missing
    source). Reconstruction: XXH64 of the stream of per-chunk XXH64
    digests, so it can be produced incrementally during writes."""
    lib = _load()
    acc = b"".join(
        lib.tz_xxh64(data[i:i + chunk], min(chunk, len(data) - i), 0)
        .to_bytes(8, "little")
        for i in range(0, max(len(data), 1), chunk))
    return lib.tz_xxh64(acc, len(acc), len(data) & 0xFFFFFFFF)


def xxh3_64(data: bytes) -> int:
    return _load().tz_xxh3_64(data, len(data))


def xxh3_128(data: bytes) -> bytes:
    """Canonical (big-endian) 16-byte XXH3-128 digest."""
    return _fixed_out("tz_xxh3_128", data, 16)


def wyhash(data: bytes, seed: int = 0) -> int:
    return _load().tz_wyhash(data, len(data), seed)


def _hh_key(key) -> "C.Array":
    arr = (C.c_uint64 * 4)()
    for i, v in enumerate(key or (1, 2, 3, 4)):
        arr[i] = v
    return arr


def highway64(data: bytes, key=None) -> int:
    return _load().tz_highway64(data, len(data), _hh_key(key))


def highway128(data: bytes, key=None) -> bytes:
    out = C.create_string_buffer(16)
    _load().tz_highway128(data, len(data), _hh_key(key), out)
    return out.raw


def highway256(data: bytes, key=None) -> bytes:
    out = C.create_string_buffer(32)
    _load().tz_highway256(data, len(data), _hh_key(key), out)
    return out.raw
