"""Build and load the port's CUDA kernels.

Each source under ``zpaqfranz_tpu_torch/csrc/`` is compiled by ``nvcc`` into
its own shared library with a plain C interface, loaded with ``ctypes``.
Libraries go to ``zpaqfranz_tpu_torch/build/`` (listed in ``.gitignore``),
named by a hash of their source and the shared headers (``csrc/*.cuh``), so
an edited source or header rebuilds and an unchanged one loads at once.
Nothing is built at import time: a wrapper builds its kernel the first time
it launches it.
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
from typing import Dict, Iterable, List

import torch

PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "build"

#: kernel name -> source file under csrc/
SOURCES = {"sha1_lanes": "sha1_lanes.cu", "sha256_lanes": "sha256_lanes.cu",
           "cm_decode": "cm_decode.cu", "cm_encode": "cm_encode.cu",
           "mb_access": "mb_access.cu", "mb_vmem_probe": "mb_vmem_probe.cu"}

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
#: seconds and ptxas report of the builds done by this process
BUILD_LOG: Dict[str, Dict[str, object]] = {}


class KernelBuildError(RuntimeError):
    pass


def nvcc_path() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise KernelBuildError("nvcc not found (set NVCC or CUDA_HOME)")


def _lib_path(name: str) -> pathlib.Path:
    h = hashlib.sha1((CSRC / SOURCES[name]).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    digest = h.hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _command(name: str, out: pathlib.Path) -> List[str]:
    return [nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a",
            "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
            "-Xptxas", "-v", "-o", str(out), str(CSRC / SOURCES[name])]


def build(names: Iterable[str] = tuple(SOURCES)) -> Dict[str, pathlib.Path]:
    """Compile the named kernels that are not built yet, one ``nvcc`` per
    source, all started together. Returns name -> library path."""
    names = list(names)
    paths = {n: _lib_path(n) for n in names}
    todo = [n for n in names if not paths[n].exists()]
    if not todo:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.time()
    for n in todo:
        tmp = paths[n].with_suffix(f".{os.getpid()}.tmp")
        procs[n] = (tmp, subprocess.Popen(
            _command(n, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    failed = []
    for n, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOG[n] = {"seconds": time.time() - t0, "ptxas": log}
        if proc.returncode != 0:
            failed.append(f"{n}:\n{log}")
        else:
            os.replace(tmp, paths[n])
    if failed:
        raise KernelBuildError("nvcc failed for " + "\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build([name])[name]))
            _LIBS[name] = lib
        return lib


def call(name: str, symbol: str, device: torch.device, *args) -> None:
    """Launch the C entry ``symbol`` of kernel library ``name`` on the
    current stream of ``device``: every kernel wrapper launches through
    here. Tensors pass as their data pointers, ints as ``long long``, and
    the stream comes last; a CUDA error code other than 0 raises."""
    fn = getattr(load(name), symbol)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p if isinstance(a, torch.Tensor)
                   else ctypes.c_longlong for a in args] + [ctypes.c_void_p]
    with torch.cuda.device(device):
        rc = fn(*[a.data_ptr() if isinstance(a, torch.Tensor) else int(a)
                  for a in args], torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{symbol} launch failed: CUDA error {rc}")
