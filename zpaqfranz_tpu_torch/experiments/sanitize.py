"""Hold every CUDA entry point of the port to its exact allocation bounds.

Every kernel of the port launches through ``ops/build.call``. A buffer
there comes from torch's caching allocator, which rounds sizes up and
pools them, so a kernel that reads a few bytes past a tensor, or reads an
output byte that nothing wrote, passes every byte-for-byte check unseen.
This script records launches on the normal path and replays them where
every buffer is exactly its tensor's bytes:

    python -m zpaqfranz_tpu_torch.experiments.sanitize record DIR
    python -m zpaqfranz_tpu_torch.experiments.sanitize replay DIR [--guard end] [--guard start] [--only SYMBOL|CASE]
    compute-sanitizer --tool racecheck python -m zpaqfranz_tpu_torch.experiments.sanitize replay DIR
    python -m zpaqfranz_tpu_torch.experiments.sanitize check DIR
    python -m zpaqfranz_tpu_torch.experiments.sanitize probe

``record`` runs the matrix (``matrix()``: every ``*_launch`` symbol of
``csrc/*.cu`` at its edge cases) through the port's wrappers on the card,
holds each result against the plain version (the native host engine for
the CM coders), and writes each launch to DIR: the build unit, the C
symbol, the built library's path, the int arguments, every tensor
argument's bytes before and after the launch, and the tensors the launch
must write whole (their bytes are not inputs). ``replay`` runs in a
process that never imports torch: it gives each tensor argument a device
allocation of exactly its bytes through the CUDA driver API
(``libcuda.so.1`` by ctypes), copies the recorded inputs in, leaves the
write-only outputs uninitialised, calls the library's entry on the null
stream, synchronises, and requires every tensor to come back byte-equal to
the recording. Any CUDA error raises. Under ``compute-sanitizer`` the tool
sees this process's allocations alone, at their exact sizes. With
``--guard end`` each buffer instead ends against an unmapped granule of
the address space (``cuMemAddressReserve``/``cuMemCreate``/``cuMemMap``),
its start rounded down only to the alignment the launch depends on, and
with ``--guard start`` it begins on a granule after an unmapped one: a
stray access faults at full speed, with no tool. Each pass fills its
memory with its own byte first, so a write-only output that is not
written whole, or a result that reads a byte nothing wrote, differs from
the recording. ``check`` records, then replays in both guard passes and
under each tool, with positive controls (``sanitize_controls.cu``) that
each must catch, and prints a line per entry point and pass. ``probe``
diagnoses whether compute-sanitizer runs on this machine (three small
programs under memcheck, and the versions).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import pathlib
import re
import shutil
import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "build"
ROOT = PKG.parent

#: the alignment a launch depends on by default: 16-byte loads (uint4,
#: cp.async); a buffer keeps its address modulo this in a replay
ALIGN = 16
#: what the recording fills a write-only output with before the launch; a
#: guard pass fills it with its own byte (``GUARD_FILL``), so that a byte
#: the kernel does not write comes back different
SENTINEL = 0xA5
TOOLS = ("memcheck", "racecheck", "synccheck", "initcheck")
#: the byte every guard pass fills its mappings with before the inputs go
#: in: a kernel that reads a byte no one wrote, or that leaves an output
#: byte unwritten, then gives a result that differs between the passes
GUARD_FILL = {"end": 0x5A, "start": 0xC3}
#: a tensor at least this large whose rows all equal its first is
#: recorded as one row (``Arg.rows``)
TILE_BYTES = 1 << 20


# ---------------------------------------------------------------------------
# the catalog: every C entry of csrc/*.cu


def launch_symbols(csrc: pathlib.Path = CSRC) -> Dict[str, str]:
    """``*_launch`` symbol -> source file name, parsed from every
    ``csrc/*.cu``: the functions of ``extern "C"`` blocks and declarations,
    and the names that ``MB_COLUMN_ENTRY(NAME, ...)`` makes."""
    out = {}
    for path in sorted(csrc.glob("*.cu")):
        text = re.sub(r"//[^\n]*", "", path.read_text())
        for name in re.findall(r"\bint\s+(\w+_launch)\s*\(", text):
            out[name] = path.name
        for name in re.findall(r"^\s*MB_COLUMN_ENTRY\s*\(\s*(\w+)\s*,", text,
                               flags=re.M):
            out[name] = path.name
    return out


# ---------------------------------------------------------------------------
# a recorded launch and its on-disk form


@dataclass
class Arg:
    """One argument of a launch: an int, or a tensor. A tensor's address
    keeps its value modulo ``align`` in a replay (``pre`` = the address
    modulo ``align``: the region a replay places starts ``pre`` bytes before
    the tensor), and its ``head`` bytes of storage before its first byte,
    up to the 16-byte piece that holds it, are inputs too (a kernel may
    read that whole piece). ``before`` holds the head and the tensor's bytes
    before the launch (None for a write-only output), ``after`` the same
    bytes after it. ``null``: the tensor had no memory (address 0).
    ``ptr``: its address in the recording; ``points_to``: the index in
    ``args`` of the tensor whose bytes this one's int64 words address
    where they fall in them (-1: none); ``varies``: byte ranges of the
    tensor that differ from run to run and are not compared; ``rows``: if
    not 0, ``before`` holds the first of the tensor's ``rows`` equal rows
    (a lane state broadcast to every lane, stored once)."""

    value: int = 0
    tensor: bool = False
    dtype: str = ""
    shape: Tuple[int, ...] = ()
    head: int = 0
    pre: int = 0
    align: int = ALIGN
    written: bool = False
    null: bool = False
    ptr: int = 0
    points_to: int = -1
    varies: List[Tuple[int, int]] = field(default_factory=list)
    rows: int = 0
    before: Optional[np.ndarray] = None
    after: Optional[np.ndarray] = None

    @property
    def nbytes(self) -> int:
        """Bytes of the tensor itself."""
        return math.prod(self.shape) * np.dtype(self.dtype).itemsize \
            if self.tensor else 0

    def meta(self) -> dict:
        if not self.tensor:
            return {"int": self.value}
        return {"dtype": self.dtype, "shape": list(self.shape),
                "head": self.head, "pre": self.pre, "align": self.align,
                "written": self.written, "null": self.null, "ptr": self.ptr,
                "points_to": self.points_to,
                "varies": [list(v) for v in self.varies],
                "rows": self.rows}


@dataclass
class Launch:
    """One recorded launch: its case, build unit key, C symbol, the built
    library's path, and its arguments in order (the stream not included)."""

    case: str
    unit: str
    symbol: str
    library: str
    args: List[Arg] = field(default_factory=list)

    def save(self, path: pathlib.Path) -> None:
        meta = {"case": self.case, "unit": self.unit, "symbol": self.symbol,
                "library": self.library,
                "args": [a.meta() for a in self.args]}
        arrays = {"meta": np.frombuffer(json.dumps(meta).encode(), np.uint8)}
        for i, a in enumerate(self.args):
            if a.before is not None:
                arrays[f"before{i}"] = a.before
            if a.after is not None:
                arrays[f"after{i}"] = a.after
        with open(path, "wb") as f:
            np.savez(f, **arrays)

    @staticmethod
    def peek(path: pathlib.Path) -> Tuple[str, str]:
        """``(case, symbol)`` of a recorded launch, its bytes unread."""
        with np.load(path, allow_pickle=False) as z:
            meta = json.loads(z["meta"].tobytes())
        return meta["case"], meta["symbol"]

    @classmethod
    def load(cls, path: pathlib.Path) -> "Launch":
        with np.load(path, allow_pickle=False) as z:
            meta = json.loads(z["meta"].tobytes())
            args = []
            for i, m in enumerate(meta["args"]):
                if "int" in m:
                    args.append(Arg(value=int(m["int"])))
                    continue
                args.append(Arg(
                    tensor=True, dtype=m["dtype"], shape=tuple(m["shape"]),
                    head=int(m["head"]), pre=int(m["pre"]),
                    align=int(m["align"]), written=bool(m["written"]),
                    null=bool(m["null"]), ptr=int(m["ptr"]),
                    points_to=int(m["points_to"]),
                    varies=[tuple(v) for v in m["varies"]],
                    rows=int(m["rows"]),
                    before=z[f"before{i}"] if f"before{i}" in z else None,
                    after=z[f"after{i}"] if f"after{i}" in z else None))
        return cls(meta["case"], meta["unit"], meta["symbol"],
                   meta["library"], args)


def launch_files(root: pathlib.Path) -> List[pathlib.Path]:
    return sorted(root.glob("launch-*.npz"))


# ---------------------------------------------------------------------------
# the CUDA driver API, by ctypes (the replay's process never imports torch)


class CudaError(RuntimeError):
    pass


class _Prop(ctypes.Structure):
    """CUmemAllocationProp: pinned device memory on one device."""
    _fields_ = [("type", ctypes.c_int), ("handle_types", ctypes.c_int),
                ("loc_type", ctypes.c_int), ("loc_id", ctypes.c_int),
                ("win32", ctypes.c_void_p), ("compression", ctypes.c_ubyte),
                ("rdma", ctypes.c_ubyte), ("usage", ctypes.c_ushort),
                ("reserved", ctypes.c_ubyte * 4)]


class _Access(ctypes.Structure):
    """CUmemAccessDesc: read and write from one device."""
    _fields_ = [("loc_type", ctypes.c_int), ("loc_id", ctypes.c_int),
                ("flags", ctypes.c_int)]


_LOC_DEVICE, _ALLOC_PINNED, _ACCESS_RW = 1, 1, 3


class Driver:
    """The primary context of device 0, made current on this thread (the
    kernels' libraries use the CUDA runtime, which takes that context),
    and the calls a replay needs. Every failed call raises ``CudaError``."""

    def __init__(self):
        self.cu = ctypes.CDLL("libcuda.so.1")
        self.check("cuInit", 0)
        dev = ctypes.c_int()
        self.check("cuDeviceGet", ctypes.byref(dev), 0)
        self.dev = dev.value
        ctx = ctypes.c_void_p()
        self.check("cuDevicePrimaryCtxRetain", ctypes.byref(ctx), dev)
        self.check("cuCtxSetCurrent", ctx)
        prop = self.prop()
        gran = ctypes.c_size_t()
        self.check("cuMemGetAllocationGranularity", ctypes.byref(gran),
                   ctypes.byref(prop), 0)
        self.granule = gran.value

    def check(self, name: str, *args) -> None:
        rc = getattr(self.cu, name)(*args)
        if rc != 0:
            raise CudaError(f"{name}: {self.error_name(rc)}")

    def error_name(self, rc: int) -> str:
        s = ctypes.c_char_p()
        if self.cu.cuGetErrorName(rc, ctypes.byref(s)) == 0 and s.value:
            return f"{s.value.decode()} ({rc})"
        return f"CUDA error {rc}"

    def prop(self) -> _Prop:
        p = _Prop()
        p.type, p.loc_type, p.loc_id = _ALLOC_PINNED, _LOC_DEVICE, self.dev
        return p

    def alloc(self, n: int) -> int:
        ptr = ctypes.c_uint64()
        self.check("cuMemAlloc_v2", ctypes.byref(ptr), ctypes.c_size_t(n))
        return ptr.value

    def free(self, ptr: int) -> None:
        self.check("cuMemFree_v2", ctypes.c_uint64(ptr))

    def put(self, ptr: int, data: np.ndarray) -> None:
        if data.nbytes:
            data = np.ascontiguousarray(data)
            self.check("cuMemcpyHtoD_v2", ctypes.c_uint64(ptr),
                       data.ctypes.data_as(ctypes.c_void_p),
                       ctypes.c_size_t(data.nbytes))

    def get(self, ptr: int, n: int) -> np.ndarray:
        out = np.empty(n, np.uint8)
        if n:
            self.check("cuMemcpyDtoH_v2", out.ctypes.data_as(ctypes.c_void_p),
                       ctypes.c_uint64(ptr), ctypes.c_size_t(n))
        return out

    def fill(self, ptr: int, value: int, n: int) -> None:
        if n:
            self.check("cuMemsetD8_v2", ctypes.c_uint64(ptr),
                       ctypes.c_ubyte(value), ctypes.c_size_t(n))

    def sync(self) -> None:
        self.check("cuCtxSynchronize")

    def reserve(self, size: int) -> int:
        ptr = ctypes.c_uint64()
        self.check("cuMemAddressReserve", ctypes.byref(ptr),
                   ctypes.c_size_t(size), ctypes.c_size_t(self.granule),
                   ctypes.c_uint64(0), ctypes.c_ulonglong(0))
        return ptr.value

    def map(self, ptr: int, size: int) -> int:
        """Back ``size`` bytes (whole granules) at ``ptr`` with new device
        memory, readable and writable; returns the handle."""
        handle = ctypes.c_ulonglong()
        prop = self.prop()
        self.check("cuMemCreate", ctypes.byref(handle), ctypes.c_size_t(size),
                   ctypes.byref(prop), ctypes.c_ulonglong(0))
        self.check("cuMemMap", ctypes.c_uint64(ptr), ctypes.c_size_t(size),
                   ctypes.c_size_t(0), handle, ctypes.c_ulonglong(0))
        acc = _Access(_LOC_DEVICE, self.dev, _ACCESS_RW)
        self.check("cuMemSetAccess", ctypes.c_uint64(ptr),
                   ctypes.c_size_t(size), ctypes.byref(acc), ctypes.c_size_t(1))
        return handle.value

    def unmap(self, ptr: int, size: int, handle: int) -> None:
        self.check("cuMemUnmap", ctypes.c_uint64(ptr), ctypes.c_size_t(size))
        self.check("cuMemRelease", ctypes.c_ulonglong(handle))

    def release(self, ptr: int, size: int) -> None:
        self.check("cuMemAddressFree", ctypes.c_uint64(ptr),
                   ctypes.c_size_t(size))


# ---------------------------------------------------------------------------
# placing a buffer at its exact bounds


def guard_place(size: int, align: int, granule: int, where: str
                ) -> Tuple[int, int, int, int]:
    """Where a region of ``size`` bytes whose first byte must lie on a
    multiple of ``align`` (a power of two dividing ``granule``) goes in a
    reservation of whole granules, one of them left unmapped as the guard:
    ``(reserved, map_offset, mapped, region_offset)``. ``where="end"``
    maps the first granules and ends the region as close before the
    unmapped last one as the alignment allows (less than ``align`` bytes
    of slack); ``"start"`` leaves the first granule unmapped and starts
    the region on the next one's first byte."""
    if align < 1 or align & (align - 1) or granule % align:
        raise ValueError(f"alignment {align} does not divide {granule}")
    k = max(1, -(-(size + align) // granule))
    if where == "end":
        end = k * granule
        return (k + 1) * granule, 0, k * granule, (end - size) // align * align
    if where == "start":
        return (k + 1) * granule, granule, k * granule, granule
    raise ValueError(f"unknown guard pass {where!r}")


class Buffer:
    """A tensor argument's device memory in a replay: its region (the
    tensor's bytes and the ``pre`` bytes before its address that keep the
    address modulo its alignment) at exact bounds. ``where=None`` takes a
    plain allocation of exactly the region (``cuMemAlloc``: what a
    sanitizer checks); ``"end"`` or ``"start"`` a guard placement
    (``guard_place``), its whole mapping filled with the pass's byte
    (``GUARD_FILL``), so that a write-only output or a byte around the
    region holds other bytes in each pass than in the recording. ``ptr``
    is the address the kernel gets, ``slack`` the mapped or allocated
    bytes after the tensor's end."""

    def __init__(self, drv, nbytes: int, pre: int, align: int,
                 where: Optional[str]):
        self.drv, self.where = drv, where
        size = pre + nbytes
        self._alloc = self._resv = None
        if where is None:
            base = drv.alloc(max(size, 1))
            if base % align:
                # cuMemAlloc aligns to 256 bytes; a larger alignment takes
                # a larger allocation, the region at its first multiple
                drv.free(base)
                base = drv.alloc(size + align)
                self._alloc = base
                base = -(-base // align) * align
                self.slack = self._alloc + size + align - base - size
            else:
                self._alloc = base
                self.slack = max(size, 1) - size
            self.region = base
        else:
            reserved, moff, mapped, roff = guard_place(size, align,
                                                       drv.granule, where)
            base = drv.reserve(reserved)
            self._resv = (base, reserved)
            self._map = (base + moff, mapped, drv.map(base + moff, mapped))
            drv.fill(base + moff, GUARD_FILL[where], mapped)
            self.region = base + roff
            self.slack = base + moff + mapped - (self.region + size)
        self.ptr = self.region + pre

    def close(self) -> None:
        if self._alloc is not None:
            self.drv.free(self._alloc)
        if self._resv is not None:
            self.drv.unmap(*self._map)
            self.drv.release(*self._resv)
        self._alloc = self._resv = None


# ---------------------------------------------------------------------------
# replay (no torch in this process)


class ReplayError(RuntimeError):
    pass


@dataclass
class Tally:
    """One entry point's replay in one pass: launches, cases, seconds, the
    most slack after a tensor's end."""

    launches: int = 0
    cases: set = field(default_factory=set)
    seconds: float = 0.0
    slack: int = 0


def _entry(libs: Dict[str, ctypes.CDLL], rec: Launch):
    lib = libs.get(rec.library)
    if lib is None:
        lib = libs[rec.library] = ctypes.CDLL(rec.library)
    fn = getattr(lib, rec.symbol)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p if a.tensor else ctypes.c_longlong
                   for a in rec.args] + [ctypes.c_void_p]
    return fn


def relocated(data: np.ndarray, head: int, lo: int, hi: int,
              delta: int) -> np.ndarray:
    """``data`` (a tensor's recorded bytes after ``head`` bytes of its
    storage) with each int64 word of the tensor in ``[lo, hi]`` moved by
    ``delta``: addresses into a buffer that the replay put elsewhere."""
    out = data.copy()
    n = (out.size - head) // 8 * 8
    words = out[head:head + n].view(np.uint64)
    hit = (words >= np.uint64(lo)) & (words <= np.uint64(hi))
    words[hit] = (words[hit].astype(np.int64) + delta).astype(np.uint64)
    return out


def replay_one(drv, fn, rec: Launch, where: Optional[str]) -> int:
    """Replay one launch at exact bounds (``Buffer``); returns the most
    slack after a tensor's end. Raises on a CUDA error or a byte that
    differs from the recording."""
    bufs: Dict[int, Optional[Buffer]] = {}
    for i, a in enumerate(rec.args):
        if a.tensor:
            bufs[i] = None if a.null else Buffer(drv, a.nbytes, a.pre,
                                                 a.align, where)

    def moved(a: Arg, data: Optional[np.ndarray]) -> Optional[np.ndarray]:
        if a.points_to < 0 or data is None:
            return data
        t, b = rec.args[a.points_to], bufs[a.points_to]
        return relocated(data, a.head, t.ptr - t.pre, t.ptr + t.nbytes,
                         b.ptr - t.ptr)

    for i, b in bufs.items():
        a = rec.args[i]
        if b is None or a.written:
            continue
        data = moved(a, a.before)
        for r in range(max(a.rows, 1)):
            drv.put(b.ptr - a.head + r * data.size, data)
    rc = fn(*[(None if bufs[i] is None else bufs[i].ptr) if a.tensor
              else a.value for i, a in enumerate(rec.args)], None)
    if rc:
        raise ReplayError(f"{rec.case}: {rec.symbol} refused the launch: "
                          f"CUDA runtime error {rc}")
    try:
        drv.sync()
    except CudaError as e:
        raise ReplayError(f"{rec.case}: {rec.symbol} faulted: {e}") from e
    slack = 0
    for i, b in bufs.items():
        a = rec.args[i]
        if b is None or a.after is None:
            continue
        got, want = drv.get(b.ptr - a.head, a.head + a.nbytes), \
            moved(a, a.after)
        for lo, hi in a.varies:
            got[a.head + lo:a.head + hi] = want[a.head + lo:a.head + hi]
        if not np.array_equal(got, want):
            k = int(np.flatnonzero(got != want)[0]) - a.head
            raise ReplayError(
                f"{rec.case}: {rec.symbol} argument {i} ({a.dtype} "
                f"{list(a.shape)}{', write-only' if a.written else ''}) "
                f"differs from the recording at byte {k}")
        slack = max(slack, b.slack)
    for b in bufs.values():
        if b is not None:
            b.close()
    return slack


def replay(root: pathlib.Path, passes: Sequence[Optional[str]] = (None,),
           only: Sequence[str] = (), log=print
           ) -> Dict[Tuple[Optional[str], str], Tally]:
    """Replay every launch recorded under ``root`` (``replay_one``) in
    order, once in each of ``passes`` (None: exact allocations; "end",
    "start": the guard passes); ``only``: the launches whose symbol or
    case is listed. Returns (pass, symbol) -> ``Tally``."""
    drv = Driver()
    libs: Dict[str, ctypes.CDLL] = {}
    out: Dict[Tuple[Optional[str], str], Tally] = {}
    for path in launch_files(root):
        if only and not set(Launch.peek(path)) & set(only):
            continue
        rec = Launch.load(path)
        fn = _entry(libs, rec)
        for where in passes:
            t = out.setdefault((where, rec.symbol), Tally())
            t0 = time.perf_counter()
            t.slack = max(t.slack, replay_one(drv, fn, rec, where))
            t.seconds += time.perf_counter() - t0
            t.launches += 1
            t.cases.add(rec.case)
    if not out:
        raise ReplayError(f"no launch recorded under {root}")
    for (where, sym), t in out.items():
        mode = f"guard {where}" if where else "exact allocations"
        log(f"replay [{mode}] {sym}: {len(t.cases)} cases, {t.launches} "
            f"launches, 0 faults, {t.seconds:.3f} s, at most {t.slack} B "
            f"after a tensor's end")
    return out


# ---------------------------------------------------------------------------
# record (the normal path on the card)


class Recorder:
    """While entered, every launch through ``ops/build.call`` is saved
    under ``root`` as ``launch-NNNNN.npz`` (``Launch``), named by
    ``self.case``. A write-only output is filled with ``SENTINEL`` before
    its launch, so that its bytes after the launch show what the kernel
    wrote. Tensor arguments must be contiguous and must not overlap."""

    def __init__(self, root: pathlib.Path):
        self.root = pathlib.Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.case = ""
        self.count = len(launch_files(self.root))

    def __enter__(self) -> "Recorder":
        from ..ops import build
        if build.RECORDER is not None:
            raise RuntimeError("a recorder is already set")
        build.RECORDER = self
        return self

    def __exit__(self, *exc) -> None:
        from ..ops import build
        build.RECORDER = None

    def __call__(self, unit, symbol: str, args: Sequence, hints: dict,
                 launch: Callable[[], int]) -> int:
        import torch
        from ..ops import build

        def hint(name: str, t) -> tuple:
            return next((h[1:] for h in hints.get(name, ()) if h[0] is t),
                        ())

        def index(t) -> int:
            return next(i for i, a in enumerate(args) if a is t)

        def region(t, a: Arg):
            """The uint8 view of ``a.head`` storage bytes and ``t``'s."""
            v = torch.empty(0, dtype=torch.uint8, device=t.device)
            return v.set_(t.untyped_storage(),
                          t.storage_offset() * t.element_size() - a.head,
                          (a.head + a.nbytes,), (1,))

        recs, spans = [], []
        for i, t in enumerate(args):
            if not isinstance(t, torch.Tensor):
                recs.append(Arg(value=int(t)))
                continue
            if not t.is_contiguous():
                raise ValueError(f"{symbol}: argument {i} is not contiguous")
            ptr = t.data_ptr()
            align = hint("align", t)
            a = Arg(tensor=True, dtype=str(t.dtype).replace("torch.", ""),
                    shape=tuple(t.shape), align=align[0] if align else ALIGN,
                    written=any(w is t for w in hints.get("written", ())),
                    null=ptr == 0, ptr=ptr,
                    varies=[tuple(h[1:]) for h in hints.get("varies", ())
                            if h[0] is t])
            a.head = min(ptr % ALIGN, t.storage_offset() * t.element_size())
            a.pre = ptr % a.align
            target = hint("relocate", t)
            a.points_to = index(target[0]) if target else -1
            for j, lo, hi in spans:
                if ptr - a.head < hi and lo < ptr + a.nbytes:
                    raise ValueError(f"{symbol}: arguments {j} and {i} "
                                     f"overlap")
            if a.nbytes:
                spans.append((i, ptr - a.head, ptr + a.nbytes))
            recs.append(a)
        views = {i: region(t, recs[i]) for i, t in enumerate(args)
                 if isinstance(t, torch.Tensor) and not recs[i].null}
        for i, v in views.items():
            a, t = recs[i], args[i]
            if a.written:
                v[a.head:].fill_(SENTINEL)
            elif (a.head == 0 and a.nbytes >= TILE_BYTES and t.dim()
                    and t.shape[0] > 1 and torch.equal(t, t[:1].expand_as(t))):
                a.rows = t.shape[0]
                a.before = v[:a.nbytes // a.rows].cpu().numpy()
            else:
                a.before = v.cpu().numpy()
        rc = launch()
        if rc:
            return rc
        torch.cuda.synchronize()
        for i, v in views.items():
            recs[i].after = v.cpu().numpy()
        Launch(self.case, build.unit_key(unit), symbol,
               str(build.build([unit])[build.unit_key(unit)]), recs).save(
            self.root / f"launch-{self.count:05d}.npz")
        self.count += 1
        return rc


# ---------------------------------------------------------------------------
# the matrix: every entry point at its edge cases

#: the hash kernels' edge lengths: the padding's block edges
HASH_EDGES = (0, 1, 55, 56, 63, 64, 65, 119, 120)
#: the CRC-32 kernel's: below, at and above one 16-byte piece
CRC_EDGES = (0, 1, 15, 16, 17)
#: CM payloads: empty, one byte, short and ~2 KiB
CM_SIZES = (0, 1, 37, 2048)
#: the matrix's CM models: -m3, -m4 and -m5 at 1 MiB blocks (their lane
#: state 0.14, 11 and 88 MB), every component type; and one lane of -m4
#: and -m5 at the main path's 16 MiB blocks (129 and 284 MB a lane)
CM_MODELS = ("3", "4.0", "5.0", "all-components")
CM_WIDE = ("4", "5")


class CaseError(AssertionError):
    pass


def expect(cond: bool, what: str) -> None:
    if not cond:
        raise CaseError(what)


@dataclass
class Case:
    """One case of the matrix: the entry point it launches, its name, and
    ``run()``, which launches through the port's wrappers and holds the
    result against the plain version (raising ``CaseError``)."""

    symbol: str
    name: str
    run: Callable[[], None]


def _bytes_on(torch, dev, data: bytes, at: int, mod: int = ALIGN):
    """``data`` on ``dev`` as a uint8 tensor whose address is ``at``
    modulo ``mod`` (a view into a larger buffer)."""
    buf = torch.zeros(len(data) + 2 * mod, dtype=torch.uint8, device=dev)
    k = (at - buf.data_ptr()) % mod
    out = buf[k:k + len(data)]
    if data:
        out.copy_(torch.frombuffer(bytearray(data), dtype=torch.uint8))
    return out


def _lanes_on(torch, dev, offs, lens):
    return (torch.tensor(list(offs), dtype=torch.int64, device=dev),
            torch.tensor(list(lens), dtype=torch.int64, device=dev))


def hash_cases(torch, dev, rng) -> Iterable[Case]:
    """SHA-1 and SHA-256: every edge length at every start offset 0-15,
    each also ending on the last byte of ``data``, which ends on a 16-byte
    boundary (no slack in the guard's end pass) and mid-piece; 1, 31, 33
    and 4096 lanes. Held against hashlib."""
    import hashlib
    from ..ops import sha1, sha256

    def case(algo, data: bytes, offs, lens, head):
        def run():
            fn = sha1.sha1_lanes if algo == "sha1" else sha256.sha256_lanes
            t = _bytes_on(torch, dev, data, head)
            got = sha1.to_digests(fn(t, *_lanes_on(torch, dev, offs, lens)))
            want = [hashlib.new(algo, data[o:o + n]).digest()
                    for o, n in zip(offs, lens)]
            expect(got == want, f"{algo} differs from hashlib")
        return run

    for algo in ("sha1", "sha256"):
        sym = f"{algo}_lanes_launch"
        for head in range(16):
            for n in sorted({256 - head, 256}):
                data = rng.bytes(n)
                offs = [0] * len(HASH_EDGES) + [n - k for k in HASH_EDGES]
                end = "a 16-byte boundary" if (head + n) % 16 == 0 else \
                    "mid-piece"
                yield Case(sym, f"{algo} edge lengths at offset {head}, "
                           f"data ending on {end}",
                           case(algo, data, offs, list(HASH_EDGES) * 2, head))
        for lanes in (1, 31, 33, 4096):
            lens = rng.integers(0, 300, lanes)
            data = rng.bytes(int(lens.sum()) + 16)
            offs = np.cumsum(lens) - lens + rng.integers(0, 16, lanes)
            lens[-1] = len(data) - offs[-1]
            yield Case(sym, f"{algo} {lanes} lanes",
                       case(algo, data, offs.tolist(), lens.tolist(),
                            lanes % 16))


def crc_cases(torch, dev, rng) -> Iterable[Case]:
    """CRC-32: every edge length at every start offset 0-15, each also
    ending on the last byte of ``data``; a lane across a segment's edge;
    one 1 MiB lane; segments of 1 KiB and 16 KiB. The plan cuts lanes at
    the multiples of the segment of the address, and a replay keeps the
    address modulo the segment, so each case runs twice: ``data``
    starting that many bytes past a segment's start (the guard's start
    pass then has no slack before it) and ending on a segment's end (no
    slack after it in the end pass). Held against zlib. On the CPU the
    cases run the kernel's plain version by its segments
    (``crc32_segmented``)."""
    import zlib
    from ..ops import hash_batched as hb

    sym = "crc32_lanes_launch"

    def case(data: bytes, offs, lens, head, seg=hb.CRC_SEG, edge=False,
             ends=False):
        def run():
            t = _bytes_on(torch, dev, data, -len(data) if ends else head,
                          seg)
            o = list(offs)
            if edge:        # the lane's middle on a multiple of seg
                x = -t.data_ptr() % seg
                o[0] = (x if x >= lens[0] else x + seg) - lens[0] // 2
            off, length = _lanes_on(torch, dev, o, lens)
            got = (hb.CrcLaunch(t, off, length, seg=seg).run()
                   if t.is_cuda else hb.crc32_segmented(
                       t, off, length, seg, t.data_ptr() % seg)).tolist()
            want = [zlib.crc32(data[a:a + n]) for a, n in zip(o, lens)]
            expect(got == want, "crc32_lanes differs from zlib")
        return run

    for ends in (False, True):
        at = "ending on a segment's end" if ends else "from a segment's start"
        for head in range(16):
            data = rng.bytes(64 - head if ends else 64)
            n = len(data)
            offs = [0] * len(CRC_EDGES) + [n - k for k in CRC_EDGES]
            yield Case(sym, f"crc32 edge lengths at offset {head}, {at}",
                       case(data, offs, list(CRC_EDGES) * 2, head,
                            ends=ends))
        yield Case(sym, f"crc32 a lane across a segment edge, {at}",
                   case(rng.bytes(2 * hb.CRC_SEG), [0], [300], 0, edge=True,
                        ends=ends))
        yield Case(sym, f"crc32 one 1 MiB lane, {at}",
                   case(rng.bytes(1 << 20), [0], [1 << 20], 0, ends=ends))
        for seg in (1 << 10, 16 << 10):
            lens = rng.integers(0, 40000, 64)
            offs = rng.integers(0, (1 << 20) - 40000, 64)
            yield Case(sym, f"crc32 64 lanes, {seg >> 10} KiB segments, {at}",
                       case(rng.bytes(1 << 20), offs.tolist(), lens.tolist(),
                            5, seg, ends=ends))


def cm_models() -> Dict[str, object]:
    """The matrix's CM models by name: ``CM_MODELS`` and ``CM_WIDE``."""
    from ..codec.methods import ALL_COMPONENTS_CFG, make_model
    from ..zpaql.compiler import compile_config
    out = {m: make_model(m)[0] for m in (*CM_MODELS[:-1], *CM_WIDE)}
    out["all-components"] = compile_config(ALL_COMPONENTS_CFG)[0]
    return out


def cm_units(models) -> list:
    """Every CM build unit the matrix launches: both kernels interpreted,
    and specialised for each model's HCOMP program."""
    from ..ops.hcomp_fast import try_compile
    units = ["cm_decode", "cm_encode"]
    for model in models.values():
        fast = try_compile(model)
        if fast is not None:
            units += [(k, fast.cuda_source())
                      for k in ("cm_decode", "cm_encode")]
    return units


def cm_cases(torch, dev, rng) -> Iterable[Case]:
    """The CM coders at each model of ``CM_MODELS``, with the HCOMP step
    specialised and interpreted: an empty lane and payloads of 0, 1, 37
    and ~2 KiB; one lane; one block's lanes and one more (two blocks); a
    last lane at exactly its output capacity and one byte short of it
    (which must fail); for decode also a truncated and an empty stream
    (which must fail). The two blocks' lanes launch under a CPU profiler,
    so that they write their start and end stamps (``LaneLaunch.stamps``).
    Then one lane of each ``CM_WIDE`` model. Held against the native
    engine."""
    from ..ops import cm_decode as cmd, cm_encode as cme
    from ..ops.cm_model import Placement, hcomp_step
    from ..parallel.engine import coded_stream, selector

    def text(n: int) -> bytes:
        words = (b"the ", b"cat ", b"sat ", b"zpaq ", b"lane ", b"\n")
        out = b"".join(words[i] for i in rng.integers(0, len(words), n))
        return (out + rng.bytes(n))[:n]

    def launched(make, stamped):
        """``make()``'s launch run, under the profiler when ``stamped``."""
        if not stamped:
            return make().run()
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU]):
            return make().run()

    def stamped_in_order(launch, stamped):
        expect((launch.stamps is not None) == stamped,
               f"a launch {'under' if stamped else 'outside'} the profiler "
               f"{'lacks' if stamped else 'has'} stamps")
        if stamped:
            ns = launch.stamps.cpu()
            expect(bool((ns[:, 0] <= ns[:, 1]).all()),
                   "a lane's end stamp is before its start")

    def encode(model, hcomp, pays, tight=None, stamped=False):
        """``tight``: the last lane's capacity is its coded length plus
        ``tight`` (it must fail below its length)."""
        def run():
            sel = selector(model)
            want = [coded_stream(model, p[len(sel):])[:-6] if p else
                    cmd.lanes_to_bytes(*cme.cm_encode_plain(
                        model, *cme.pack_payloads([b""], "cpu")))[0]
                    for p in pays]
            data, off, length, cap = cme.pack_payloads(pays, dev)
            if tight is not None:
                cap[-1] = len(want[-1]) + tight
            launch = launched(lambda: cme.Launch(model, data, off, length,
                                                 cap, hcomp=hcomp), stamped)
            status = launch.status.tolist()
            stamped_in_order(launch, stamped)
            got = cmd.lanes_to_bytes(launch.out, launch.out_off,
                                     launch.out_len)
            for k in range(len(pays)):
                if tight is not None and tight < 0 and k == len(pays) - 1:
                    expect(status[k] != 0, "an overrun lane did not fail")
                    continue
                expect(status[k] == 0 and got[k] == want[k],
                       f"cm_encode lane {k} differs from the native engine")
        return run

    def decode(model, hcomp, pays, damaged=False, tight=None,
               stamped=False):
        """``damaged``: a truncated and an empty stream follow, which must
        fail; ``tight``: the last lane's capacity is its decoded length
        plus ``tight`` (it must fail below its length)."""
        def run():
            sel = selector(model)
            streams = [coded_stream(model, p) for p in pays]
            caps = [len(sel) + len(p) + 64 for p in pays]
            if tight is not None:
                caps[-1] = len(sel) + len(pays[-1]) + tight
            if damaged:
                streams += [streams[-1][:len(streams[-1]) // 2], b""]
                caps += [4096, 64]
            packed = cmd.pack_streams(streams, caps, dev)
            launch = launched(lambda: cmd.Launch(model, *packed,
                                                 hcomp=hcomp), stamped)
            status = launch.status.tolist()
            stamped_in_order(launch, stamped)
            got = cmd.lanes_to_bytes(launch.out, launch.out_off,
                                     launch.out_len)
            good = len(pays) - (tight is not None and tight < 0)
            for k in range(good):
                expect(status[k] == 0 and got[k] == sel + pays[k],
                       f"cm_decode lane {k} does not restore its payload")
            expect(all(status[good:]), "a damaged or overrun lane did not "
                                       "fail")
        return run

    models = cm_models()
    for name in CM_MODELS:
        model = models[name]
        sel = selector(model)
        for hcomp in (None, "interp"):
            step = hcomp_step(model, hcomp)
            per = Placement(model, step).lanes_per_block
            tag = f"-m{name}" if name != "all-components" else name
            tag = f"{tag}, HCOMP {'specialised' if step == 'fast' else step}"
            if hcomp is None and step == "interp":
                tag += " (not specialisable)"
            sizes = [text(n) for n in CM_SIZES]
            many = [text(int(n)) for n in rng.integers(5, 40, per + 1)]
            sz = "/".join(map(str, CM_SIZES))
            yield Case("cm_encode_launch", f"cm_encode {tag}: an empty lane "
                       f"and payloads of {sz} bytes",
                       encode(model, hcomp, [b""] + [sel + p for p in sizes]))
            yield Case("cm_encode_launch", f"cm_encode {tag}: one lane",
                       encode(model, hcomp, [sel + sizes[2]]))
            yield Case("cm_encode_launch", f"cm_encode {tag}: {per + 1} "
                       f"lanes (two blocks), stamped",
                       encode(model, hcomp, [sel + p for p in many],
                              stamped=True))
            two = [sel + sizes[2], sel + sizes[3]]
            for tight, what in ((0, "at exactly"), (-1, "one byte past")):
                yield Case("cm_encode_launch", f"cm_encode {tag}: a lane "
                           f"{what} its capacity",
                           encode(model, hcomp, two, tight))
            yield Case("cm_decode_launch", f"cm_decode {tag}: payloads of "
                       f"{sz} bytes", decode(model, hcomp, sizes))
            yield Case("cm_decode_launch", f"cm_decode {tag}: one lane",
                       decode(model, hcomp, [sizes[2]]))
            yield Case("cm_decode_launch", f"cm_decode {tag}: {per + 1} "
                       f"lanes (two blocks), stamped",
                       decode(model, hcomp, many, stamped=True))
            yield Case("cm_decode_launch", f"cm_decode {tag}: a truncated "
                       f"and an empty lane",
                       decode(model, hcomp, [sizes[2]], damaged=True))
            for tight, what in ((0, "at exactly"), (-1, "one byte past")):
                yield Case("cm_decode_launch", f"cm_decode {tag}: a lane "
                           f"{what} its capacity",
                           decode(model, hcomp, sizes[2:], tight=tight))
    for name in CM_WIDE:
        model, p = models[name], text(37)
        yield Case("cm_encode_launch", f"cm_encode -m{name} (16 MiB blocks)"
                   f", HCOMP specialised: one lane",
                   encode(model, None, [selector(model) + p]))
        yield Case("cm_decode_launch", f"cm_decode -m{name} (16 MiB blocks)"
                   f", HCOMP specialised: one lane", decode(model, None, [p]))


def micro_cases(torch, dev, rng) -> Iterable[Case]:
    """The microbenchmarks at small shapes: A, B and C at a power-of-two
    and an odd S, with 1- and 4-byte elements, over 130 lanes, each table
    one element off a 16-byte boundary; D with 16-byte rows and with
    13-byte rows (byte by byte), E, over 1 and 133 lanes; P1 at a
    power-of-two and an odd floor modulus; P2 at LUTs of 1, 1000 and 4096
    entries; the three chases. Held against the plain versions (the
    chases against the slot their walk must end on)."""
    from . import mb_access as mb, mb_vmem_probe as mp

    def equal(run, plain, *args):
        def go():
            got = run(*args).cpu()
            want = plain(*[a.cpu() for a in args])
            expect(torch.equal(got, want), "kernel differs from its plain "
                                           "version")
        return go

    def ints(shape, hi, dtype):
        return torch.from_numpy(rng.integers(0, hi, shape)).to(dtype)

    lanes = 130
    for kind, mk in (("gather", mb.mk_gather_kernel),
                     ("onehot", mb.mk_onehot_kernel),
                     ("selwrite", mb.mk_selwrite_kernel)):
        for S in (256, 33):
            for dt in (torch.uint8, torch.int32):
                hi = 256 if dt == torch.uint8 else 1 << 30
                flat = ints(S * lanes + 1, hi, dt).to(dev)
                tab = flat[1:].view(S, lanes)
                idx = ints((1, lanes), S, torch.int32).to(dev)
                run = mk(S, dt)
                yield Case(f"mb_{kind}_launch", f"{kind} S={S} "
                           f"{str(dt).replace('torch.', '')} L={lanes}",
                           equal(run, run.plain, tab, idx))
    for (S, W), n in ((x, n) for x in ((2048, 16), (200, 13))
                      for n in (1, 133)):
        run = mb.mk_lane_loop_kernel(S, W)
        step = 16 if W % 16 == 0 else 1
        idx = ints((n, 1), (S - W) // step, torch.int32) * step
        tab = ints((n, S), 256, torch.uint8)
        yield Case("mb_lane_loop_launch", f"lane_loop S={S} W={W} L={n}",
                   equal(run, run.plain, idx.to(dev), tab.to(dev)))
    for n in (1, 133):
        S, W = 4096, 64
        run = mb.mk_dma_kernel(S, W)
        idx = ints((n, 1), (S - W) // 16, torch.int32) * 16
        tab = ints((n, S), 256, torch.uint8)
        yield Case("mb_dma_launch", f"dma S={S} W={W} L={n}",
                   equal(run, run.plain, idx.to(dev), tab.to(dev)))
    for sw in (mp.W + 32, mp.W + 33):
        tab = ints((4, sw), 1 << 20, torch.int32).to(dev)
        yield Case("mb_lane_rw_launch", f"lane_rw L=4 SW={sw} ITERS=8",
                   equal(lambda t: mp.lane_rw_probe(t, 8),
                         lambda t: mp.lane_rw_plain(t, 8), tab))
    for n in (1, 1000, 4096):
        lut = ints((n,), 1 << 20, torch.int32).to(dev)
        yield Case("mb_lut_launch", f"lut n={n} L={lanes} ITERS=4",
                   equal(lambda t: mp.lut_probe(t, lanes, 4),
                         lambda t: mp.lut_plain(t, lanes, 4), lut))

    def shared():
        order, nxt = mp.chase_ring(1000, 1, dev)
        out = torch.zeros(2, dtype=torch.int64, device=dev)
        mp.chase_shared(nxt.to(torch.int32), out, 300)
        expect(out[0].item() == mp.chase_end(order, 300),
               "the shared chase ended on the wrong slot")

    def walk():
        slots, stride = 512, 128
        order, nxt = mp.chase_ring(slots, 2, dev)
        ring = torch.zeros(slots * stride // 8, dtype=torch.int64,
                           device=dev)
        ring[::stride // 8] = ring.data_ptr() + nxt * stride
        out = torch.zeros(2, dtype=torch.int64, device=dev)
        mp.chase_global(ring, mp.chase_end(order, 7) * stride, out, 300)
        expect((out[0].item() - ring.data_ptr()) // stride
               == mp.chase_end(order, 307),
               "the device-memory chase ended on the wrong slot")

    def rw():
        words, apart, rounds = 4, 4224 // 8, 16
        cells = torch.zeros(words * apart, dtype=torch.int64, device=dev)
        out = torch.zeros(2, dtype=torch.int64, device=dev)
        mp.chase_rw(cells, words, apart, out, rounds)
        expect(out[0].item() == words * rounds,
               "the l2_rw chase summed wrong")

    yield Case("mb_chase_shared_launch", "chase shared 1000 slots", shared)
    yield Case("mb_chase_global_launch", "chase global 512 slots", walk)
    yield Case("mb_chase_rw_launch", "chase l2_rw 4 words", rw)


def matrix(torch, dev, seed: int = 12) -> List[Case]:
    """Every case of every entry point, in order."""
    rng = np.random.default_rng(seed)
    return [*hash_cases(torch, dev, rng), *crc_cases(torch, dev, rng),
            *cm_cases(torch, dev, rng), *micro_cases(torch, dev, rng)]


def record(root: pathlib.Path, log=print) -> Dict[str, int]:
    """Run the matrix on the card with a ``Recorder`` on ``root``; returns
    symbol -> cases. Builds every unit first, all at once."""
    import torch
    from ..device import resolve
    from ..ops import build

    dev = resolve(None)
    build.build(list(build.SOURCES) + cm_units(cm_models()))
    cases = matrix(torch, dev)
    counts: Dict[str, int] = {}
    with Recorder(root) as rec:
        for c in cases:
            rec.case = c.name
            t0 = time.perf_counter()
            try:
                c.run()
            except Exception as e:
                raise CaseError(f"{c.name}: {e}") from e
            counts[c.symbol] = counts.get(c.symbol, 0) + 1
            log(f"  recorded {c.name} ({time.perf_counter() - t0:.2f} s)")
    return counts


# ---------------------------------------------------------------------------
# the positive controls, the tools, and the runs


CONTROLS_CU = pathlib.Path(__file__).resolve().parent / "sanitize_controls.cu"


def sanitizer_path() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("compute-sanitizer"),
                 os.path.join(home, "bin", "compute-sanitizer"),
                 os.path.join(home, "compute-sanitizer",
                              "compute-sanitizer")):
        if cand and os.path.isfile(cand):
            return cand
    raise FileNotFoundError("compute-sanitizer not found")


def nvcc(src: pathlib.Path, out: pathlib.Path, shared: bool) -> None:
    """Compile a small program (``shared``: a library) of its own, not a
    kernel of the port's, for this card."""
    from ..ops import build
    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = [build.nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a",
           "-O2", "-o", str(out), str(src)]
    if shared:
        cmd[4:4] = ["-shared", "-Xcompiler", "-fPIC"]
    subprocess.run(cmd, check=True, capture_output=True, text=True)


def _u8(n: int, value: int = 0) -> np.ndarray:
    return np.full(n, value, np.uint8)


def control_records(root: pathlib.Path, library: str
                    ) -> Dict[str, Tuple[str, ...]]:
    """One directory of one recorded launch for each positive control
    (``sanitize_controls.cu``), and how its replay must fail: control
    name -> the guard passes and tools that must catch it."""
    def buf(n: int, written: bool = False, before=None, after=None):
        return Arg(tensor=True, dtype="uint8", shape=(n,), written=written,
                   ptr=1 << 40, before=before, after=after)

    controls = {
        # one byte past the end of 48 (no slack at 16-byte alignment)
        "overrun": ("ctl_touch_launch", [buf(48, before=_u8(48),
                                             after=_u8(48, 1)),
                                         Arg(value=0), Arg(value=49)]),
        # one byte before the start
        "underrun": ("ctl_touch_launch", [buf(48, before=_u8(48),
                                              after=_u8(48, 1)),
                                          Arg(value=-1), Arg(value=48)]),
        "race": ("ctl_race_launch", [buf(4, written=True)]),
        "uninit": ("ctl_uninit_launch", [buf(4, written=True),
                                         buf(4, written=True)]),
    }
    for name, (symbol, args) in controls.items():
        d = root / name
        d.mkdir(parents=True, exist_ok=True)
        Launch(f"control {name}", "controls", symbol, library, args).save(
            d / "launch-00000.npz")
    return {"overrun": ("end", "memcheck"), "underrun": ("start",),
            "race": ("racecheck",), "uninit": ("initcheck",)}


def _replay_cmd(root: pathlib.Path, passes: Sequence[str] = (),
                only: Sequence[str] = ()) -> List[str]:
    cmd = [sys.executable, "-m", "zpaqfranz_tpu_torch.experiments.sanitize",
           "replay", str(root)]
    for where in passes:
        cmd += ["--guard", where]
    for o in only:
        cmd += ["--only", o]
    return cmd


def run_replay(root: pathlib.Path, passes: Sequence[str] = (),
               tool: Optional[str] = None, only: Sequence[str] = (),
               timeout: float = 1800) -> Tuple[int, int, float, str]:
    """Replay ``root`` in a new process, in the guard ``passes`` (none:
    exact allocations), under ``tool`` if given: ``(exit code, errors the
    tool reported, seconds, output)``."""
    cmd = _replay_cmd(root, passes, only)
    if tool:
        cmd = [sanitizer_path(), "--tool", tool, "--error-exitcode", "99",
               *(["--leak-check", "no"] if tool == "memcheck" else []),
               *cmd]
    env = dict(os.environ, PYTHONPATH=str(ROOT) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    try:
        p = subprocess.run(cmd, cwd=str(ROOT), env=env, capture_output=True,
                           text=True, timeout=timeout)
    except subprocess.TimeoutExpired as e:
        out = _text(e.stdout) + _text(e.stderr) + f"\ntimed out after " \
            f"{timeout} s"
        return 124, tool_errors(out), time.perf_counter() - t0, out
    out = p.stdout + p.stderr
    return p.returncode, tool_errors(out), time.perf_counter() - t0, out


def _text(b) -> str:
    return b.decode(errors="replace") if isinstance(b, bytes) else b or ""


def tool_errors(out: str) -> int:
    """The errors compute-sanitizer's summary counts in ``out`` (0 with
    no summary)."""
    n = 0
    for m in re.finditer(r"ERROR SUMMARY: (\d+) error", out):
        n += int(m.group(1))
    for m in re.finditer(r"RACECHECK SUMMARY: \d+ hazards? displayed "
                         r"\((\d+) errors?", out):
        n += int(m.group(1))
    return n


def tail(text: str, lines: int = 12) -> str:
    return "\n".join(text.strip().splitlines()[-lines:])


#: what each tool reports for the fault of its positive control
CAUGHT = {"memcheck": r"Invalid __global__ write", "racecheck": r"Race "
          r"reported|[Hh]azard", "initcheck": r"Uninitialized __global__ "
          r"memory read"}
#: how compute-sanitizer says that it cannot check this device at all
UNAVAILABLE = re.compile(r"=+ Error: (Device not supported[^\n]*)")


def check(root: pathlib.Path, log=print) -> Dict[str, dict]:
    """Record the matrix under ``root``/matrix, then replay it in both
    guard passes (one process) and under each of ``TOOLS`` (a process
    each), and the positive controls alike: each must be caught as
    ``control_records`` says (a guard pass faults; a tool reports the
    fault, ``CAUGHT``); synccheck has none. A tool that cannot check the
    device at all (``UNAVAILABLE``) is reported with its message and
    skipped. Every pass runs; then any fault, error, difference or missed
    control raises, naming them all. Returns pass -> {"seconds",
    "errors", "lines"} or {"unavailable": message}."""
    if root.exists():
        shutil.rmtree(root)
    t0 = time.perf_counter()
    counts = record(root / "matrix", log=lambda m: None)
    log(f"recorded {sum(counts.values())} cases of {len(counts)} entry "
        f"points in {time.perf_counter() - t0:.1f} s")
    lib = BUILD_DIR / "sanitize" / "libcontrols.so"
    nvcc(CONTROLS_CU, lib, shared=True)
    catches = control_records(root / "controls", str(lib))
    out: Dict[str, dict] = {}
    failed: List[str] = []
    for mode in ("guard", *TOOLS):
        passes, tool = (("end", "start"), None) if mode == "guard" else \
            ((), mode)
        rc, errors, sec, text = run_replay(root / "matrix", passes, tool)
        gone = UNAVAILABLE.search(text) if tool else None
        if gone:
            log(f"pass {tool}: cannot run here: {gone.group(1)}")
            out[mode] = {"unavailable": gone.group(1)}
            continue
        lines = [ln for ln in text.splitlines() if ln.startswith("replay [")]
        for ln in lines:
            log(ln + (f" (under {tool})" if tool else ""))
        log(f"pass {mode}: {errors} errors reported, exit {rc}, {sec:.1f} s")
        if rc or errors or not lines:
            log(tail(text, 60))
            failed.append(f"the {mode} pass ({errors} errors, exit {rc})")
        out[mode] = {"seconds": sec, "errors": errors, "lines": lines}
        for name, by in catches.items():
            hit = [w for w in by if w in passes or w == tool]
            if not hit:
                continue
            rc, errors, _, text = run_replay(root / "controls" / name,
                                             (hit[0],) if not tool else (),
                                             tool)
            caught = (bool(re.search(CAUGHT[tool], text)) if tool
                      else rc != 0 and "faulted" in text)
            log(f"  control {name}: {'caught' if caught else 'MISSED'} "
                f"({errors} errors, exit {rc})")
            if not caught:
                log(tail(text, 20))
                failed.append(f"the {mode} pass's {name} control")
    if failed:
        raise ReplayError("failed: " + "; ".join(failed))
    return out


PROBE_A = r"""
#include <cstdio>
__global__ void add_one(int* p) { p[threadIdx.x] += 1; }
int main() {
  int h[32] = {0}, *d = nullptr;
  cudaMalloc(&d, sizeof h);
  cudaMemcpy(d, h, sizeof h, cudaMemcpyHostToDevice);
  add_one<<<1, 32>>>(d);
  cudaMemcpy(h, d, sizeof h, cudaMemcpyDeviceToHost);
  printf("probe a: %s, h[0] = %d\n", cudaGetErrorString(cudaGetLastError()), h[0]);
  return h[0] != 1;
}
"""
PROBE_TORCH = ("import torch; torch.zeros(1, device='cuda'); "
               "torch.cuda.synchronize(); print('probe torch: ok')")


def probe(log=print) -> Dict[str, Tuple[int, int]]:
    """Step one of the diagnosis: the versions, what ``nvidia-smi -q``
    says of virtualization, MIG and confidential computing, the host's
    kernel, whether the driver's debugger library (``libcudadebugger``) is
    installed, then
    three programs under
    ``compute-sanitizer --tool memcheck``: (a) a small CUDA program of its
    own (cudaMalloc, cudaMemcpy, one kernel), (b) torch's first
    allocation on the card, (c) (b) without torch's caching allocator.
    Prints each one's exit code, error count and last lines; returns
    probe -> (exit code, errors)."""
    from ..ops import build
    san = sanitizer_path()
    for cmd in ([san, "--version"],
                ["nvidia-smi", "--query-gpu=name,power.limit,driver_version",
                 "--format=csv,noheader"],
                [build.nvcc_path(), "--version"],
                [sys.executable, "-c", "import torch; print('torch', "
                 "torch.__version__, 'CUDA runtime', torch.version.cuda)"]):
        p = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
        log(f"$ {' '.join(cmd[:2])}\n{tail(p.stdout + p.stderr, 6)}")
    # what the device and the driver's install say about debugging
    p = subprocess.run(["nvidia-smi", "-q"], capture_output=True, text=True,
                       timeout=120)
    log("\n".join(ln.strip() for ln in p.stdout.splitlines() if re.search(
        r"Virtualization|MIG Mode|Current +:|Confidential|CC |Compute Mode|"
        r"Product Name|Driver Version|CUDA Version", ln)))
    log("kernel: " + " ".join(os.uname()[2:4]))
    p = subprocess.run(["ldconfig", "-p"], capture_output=True, text=True,
                       timeout=120)
    log("libcudadebugger: " + (", ".join(
        ln.split("=>")[-1].strip() for ln in p.stdout.splitlines()
        if "libcudadebugger" in ln) or "not in the loader's cache"))
    d = BUILD_DIR / "sanitize"
    d.mkdir(parents=True, exist_ok=True)
    (d / "probe_a.cu").write_text(PROBE_A)
    nvcc(d / "probe_a.cu", d / "probe_a", shared=False)
    runs = {"a": ([str(d / "probe_a")], {}),
            "b": ([sys.executable, "-c", PROBE_TORCH], {}),
            "c": ([sys.executable, "-c", PROBE_TORCH],
                  {"PYTORCH_NO_CUDA_MEMORY_CACHING": "1"})}
    out = {}
    for name, (cmd, env) in runs.items():
        t0 = time.perf_counter()
        try:
            p = subprocess.run([san, "--tool", "memcheck", "--leak-check",
                                "no", *cmd], capture_output=True, text=True,
                               timeout=180, env=dict(os.environ, **env))
            rc, text = p.returncode, p.stdout + p.stderr
        except subprocess.TimeoutExpired as e:
            rc, text = 124, _text(e.stdout) + _text(e.stderr) + "\ntimed out"
        out[name] = (rc, tool_errors(text))
        log(f"probe ({name}) under memcheck: exit {rc}, "
            f"{tool_errors(text)} errors, {time.perf_counter() - t0:.1f} s"
            f"\n{tail(text, 25)}")
    return out


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m zpaqfranz_tpu_torch.experiments.sanitize",
        description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    for name in ("record", "replay", "check"):
        p = sub.add_parser(name)
        p.add_argument("dir", type=pathlib.Path)
        if name == "replay":
            p.add_argument("--only", action="append", default=[],
                           help="a symbol or case name (repeatable)")
            p.add_argument("--guard", action="append", default=[],
                           choices=("end", "start"),
                           help="a guard pass (repeatable); none: exact "
                                "allocations")
    sub.add_parser("probe")
    args = ap.parse_args(argv)
    if args.cmd == "probe":
        probe()
    elif args.cmd == "record":
        counts = record(args.dir)
        print(f"recorded: {counts}")
    elif args.cmd == "replay":
        replay(args.dir, args.guard or (None,), args.only)
    else:
        check(args.dir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
