"""SFX builder: self-extracting POSIX executables.

The reference appends the archive to a prebuilt Windows PE stub with magic
tags (ZSFX/zsfx.cpp:2494-2612); this builds the ELF equivalent on demand:
the native engine plus a mini-jidac main (native/src/sfx_main.cpp) are
compiled with the host g++, the format tables are embedded as generated C
(one source of truth: models/tables.py), and the archive bytes plus a
16-byte magic + offset trailer are appended. The result extracts itself
with no Python or library dependencies on the target host.

A copy of the reference package's ``jidac/sfx.py``: the same stub sources
(the repository's ``native/src``, compiled into a temporary directory) and
the same trailer, so the two packages' executables are alike.
"""

from __future__ import annotations

import pathlib
import struct
import subprocess
import tempfile

import numpy as np

SFX_MAGIC = b"zpaqfranzTPUsfx\x01"

_NATIVE = pathlib.Path(__file__).resolve().parent.parent.parent / "native"


class SfxError(RuntimeError):
    pass


def _emit_tables_inc(path: pathlib.Path) -> None:
    """Generate sfx_tables.inc: the six format LUTs as C arrays plus the
    installer (normally injected from Python via tz_install_tables)."""
    from ..models import tables as T

    def carr(name: str, ctype: str, arr) -> str:
        vals = ",".join(str(int(v)) for v in np.asarray(arr).ravel())
        return f"static const {ctype} {name}[] = {{{vals}}};\n"

    src = [
        "// generated from models/tables.py - do not edit\n",
        carr("SFX_SNS", "unsigned char", T.SNS),
        carr("SFX_CMINIT", "unsigned int", T.CMINIT.astype(np.uint32)),
        carr("SFX_SQUASHT", "unsigned short", T.SQUASHT.astype(np.uint16)),
        carr("SFX_STRETCHT", "short", T.STRETCHT.astype(np.int16)),
        carr("SFX_DT", "int", T.DT.astype(np.int32)),
        carr("SFX_DT2K", "int", T.DT2K.astype(np.int32)),
        'extern "C" void tz_install_tables(const unsigned char*,'
        " const unsigned int*, const unsigned short*, const short*,"
        " const int*, const int*);\n",
        "static void sfx_install_tables() {\n"
        "  tz_install_tables(SFX_SNS, SFX_CMINIT, SFX_SQUASHT,\n"
        "                    SFX_STRETCHT, SFX_DT, SFX_DT2K);\n"
        "}\n",
    ]
    path.write_text("".join(src))


def build_sfx(archive_bytes: bytes, out_path: str) -> int:
    """Compile the stub and append the payload; returns output size."""
    with tempfile.TemporaryDirectory() as td:
        tdp = pathlib.Path(td)
        _emit_tables_inc(tdp / "sfx_tables.inc")
        stub = tdp / "stub"
        cmd = ["g++", "-O2", "-std=c++17", "-I", str(tdp),
               "-I", str(_NATIVE / "src"),
               str(_NATIVE / "src" / "sfx_main.cpp"),
               str(_NATIVE / "src" / "tzpaq.cpp"),
               str(_NATIVE / "src" / "hashes.cpp"),
               "-o", str(stub)]
        r = subprocess.run(cmd, capture_output=True, text=True)
        if r.returncode != 0:
            raise SfxError(f"stub compile failed:\n{r.stderr[-2000:]}")
        stub_bytes = stub.read_bytes()
    out = pathlib.Path(out_path)
    payload = (stub_bytes + archive_bytes + SFX_MAGIC
               + struct.pack("<Q", len(stub_bytes)))
    out.write_bytes(payload)
    out.chmod(0o755)
    return len(payload)
