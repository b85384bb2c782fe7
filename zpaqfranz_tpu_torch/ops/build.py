"""Build and load the port's CUDA kernels.

Each source under ``zpaqfranz_tpu_torch/csrc/`` is compiled by ``nvcc`` into
its own shared library with a plain C interface, loaded with ``ctypes``.
Libraries go to ``zpaqfranz_tpu_torch/build/`` (listed in ``.gitignore``),
named by a hash of their source and the shared headers (``csrc/*.cuh``), so
an edited source or header rebuilds and an unchanged one loads at once.
Nothing is built at import time: a wrapper builds its kernel the first time
it launches it.

The CM kernels are also built once per model whose HCOMP program
``ops/hcomp_fast.py``, whose combine ``ops/combine_fast.py`` or whose phases
(a) and (c) ``ops/phases_fast.py`` specialises: the generated header
(``build/gen-<digest>.cuh``: ``struct HcompFast`` with ``CM_HCOMP_FAST``
defined, ``struct CombineFast`` with ``CM_COMBINE_FAST``, ``struct
PhasesFast`` with ``CM_PHASES_FAST``, whichever the launch runs;
``cm_model.kernel_unit`` writes it) and a
two-line unit that includes it before the kernel's source
(``build/<kernel>-<digest>.cu``) go to the build directory, and the
library's name hashes the source, the headers and the generated text. A
kernel is named by a *unit*: its name, or ``(name, generated header
text)``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time
from typing import Callable, Dict, Iterable, List, Optional, Tuple, Union

import torch

from .. import trace

PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "build"

#: kernel name -> source file under csrc/
SOURCES = {"sha1_lanes": "sha1_lanes.cu", "sha256_lanes": "sha256_lanes.cu",
           "cm_decode": "cm_decode.cu", "cm_encode": "cm_encode.cu",
           "mb_access": "mb_access.cu", "mb_vmem_probe": "mb_vmem_probe.cu",
           "crc32_lanes": "crc32_lanes.cu"}

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
#: seconds and ptxas report of the builds done by this process, by unit key
BUILD_LOG: Dict[str, Dict[str, object]] = {}

#: a kernel's name, or (name, generated header) for a specialised one
Unit = Union[str, Tuple[str, str]]


class KernelBuildError(RuntimeError):
    pass


def nvcc_path() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise KernelBuildError("nvcc not found (set NVCC or CUDA_HOME)")


def _split(unit: Unit) -> Tuple[str, Optional[str]]:
    return (unit, None) if isinstance(unit, str) else unit


def _digest(text: str) -> str:
    return hashlib.sha1(text.encode()).hexdigest()[:12]


def unit_key(unit: Unit) -> str:
    """``name``, or ``name+<digest of the generated header>``."""
    name, gen = _split(unit)
    return name if gen is None else f"{name}+{_digest(gen)}"


def _lib_path(unit: Unit) -> pathlib.Path:
    name, gen = _split(unit)
    h = hashlib.sha1((CSRC / SOURCES[name]).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    if gen is not None:
        h.update(gen.encode())
        name = f"{name}-gen"
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def _write(path: pathlib.Path, text: str) -> None:
    """Write ``text`` through a temporary file renamed into place, so that a
    concurrent build never reads half a file."""
    if path.exists() and path.read_text() == text:
        return
    tmp = path.with_suffix(f"{path.suffix}.{os.getpid()}.tmp")
    tmp.write_text(text)
    os.replace(tmp, path)


def _source(unit: Unit) -> pathlib.Path:
    """The file nvcc compiles: the kernel's source, or for a specialised
    unit the generated header and a unit including it before the source."""
    name, gen = _split(unit)
    if gen is None:
        return CSRC / SOURCES[name]
    d = _digest(gen)
    _write(BUILD_DIR / f"gen-{d}.cuh", gen)
    cu = BUILD_DIR / f"{name}-{d}.cu"
    _write(cu, f'#include "gen-{d}.cuh"\n#include "{SOURCES[name]}"\n')
    return cu


def _command(unit: Unit, out: pathlib.Path) -> List[str]:
    return [nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a",
            "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
            "-Xptxas", "-v", "-I", str(CSRC), "-I", str(BUILD_DIR),
            "-o", str(out), str(_source(unit))]


def build(units: Iterable[Unit] = tuple(SOURCES)
          ) -> Dict[str, pathlib.Path]:
    """Compile the kernels that are not built yet, one ``nvcc`` per unit,
    all started together (a unit named twice builds once). Returns unit
    key -> library path."""
    units = list({unit_key(u): u for u in units}.values())
    paths = {unit_key(u): _lib_path(u) for u in units}
    todo = [u for u in units if not paths[unit_key(u)].exists()]
    if not todo:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.time()
    failed = []
    with trace.span("kernel.build",
                    unit=" ".join(unit_key(u) for u in todo)):
        for u in todo:
            key = unit_key(u)
            tmp = paths[key].with_suffix(f".{os.getpid()}.tmp")
            procs[key] = (tmp, subprocess.Popen(
                _command(u, tmp), stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
        for key, (tmp, proc) in procs.items():
            log, _ = proc.communicate()
            BUILD_LOG[key] = {"seconds": time.time() - t0, "ptxas": log}
            if proc.returncode != 0:
                failed.append(f"{key}:\n{log}")
            else:
                os.replace(tmp, paths[key])
    if failed:
        raise KernelBuildError("nvcc failed for " + "\n".join(failed))
    return paths


def load(unit: Unit) -> ctypes.CDLL:
    """The loaded library of one kernel, built on first use."""
    key = unit_key(unit)
    with _LOCK:
        lib = _LIBS.get(key)
        if lib is None:
            lib = ctypes.CDLL(str(build([unit])[key]))
            _LIBS[key] = lib
        return lib


#: when set, every launch goes through it (``experiments/sanitize.py``'s
#: recorder): ``RECORDER(unit, symbol, args, hints, launch)`` saves the
#: launch and its tensors' bytes around ``launch()``, which launches and
#: returns the C entry's error code
RECORDER: Optional[Callable] = None
#: the hints ``call`` takes
HINTS = frozenset({"written", "align", "relocate", "varies"})


def call(unit: Unit, symbol: str, device: torch.device, *args,
         **hints) -> None:
    """Launch the C entry ``symbol`` of kernel library ``unit`` on the
    current stream of ``device``: every kernel wrapper launches through
    here. Tensors pass as their data pointers, ints as ``long long``, and
    the stream comes last; a CUDA error code other than 0 raises.

    ``hints`` tell the recorder what the bytes alone do not, each a
    sequence: ``written``, the outputs the launch must write whole (their
    bytes before it are no input); ``align``, ``(tensor, power of two)``
    for a tensor whose address the launch depends on modulo more than 16
    bytes; ``relocate``, ``(tensor, target)`` for a tensor whose int64
    words that fall in ``target``'s bytes are addresses; ``varies``,
    ``(tensor, first byte, end byte)`` for bytes of an output that differ
    from run to run (clock counters)."""
    unknown = set(hints) - HINTS
    if unknown:
        raise TypeError(f"unknown launch hints {sorted(unknown)}")
    fn = getattr(load(unit), symbol)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p if isinstance(a, torch.Tensor)
                   else ctypes.c_longlong for a in args] + [ctypes.c_void_p]

    def launch() -> int:
        with torch.cuda.device(device):
            return fn(*[a.data_ptr() if isinstance(a, torch.Tensor)
                        else int(a) for a in args],
                      torch.cuda.current_stream().cuda_stream)

    rc = launch() if RECORDER is None else RECORDER(unit, symbol, args,
                                                    hints, launch)
    if rc != 0:
        raise RuntimeError(f"{symbol} launch failed: CUDA error {rc}")
