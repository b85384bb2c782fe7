"""The ZPAQ context-mixing model shared by the CM lane decoder and encoder.

Mirrors ``csrc/cm_model.cuh``: the arena layout of one model (``Layout``, a
copy of ``codec_arena._Layout``), the combined squash/stretch/SNS table,
fresh lane state, the kernels' placement plan (``Placement``: threads per
lane, the lane's shared region, which tables live in shared memory), the
launch of either lane kernel (``LaneLaunch``: both kernels take the same
arguments) and the plain PyTorch predictor (``PlainModel``) that the plain
decoder and encoder extend with their range coders.

HCOMP runs in one of two steps, as in the reference's ``ArenaCoder``: a
program that ``ops/hcomp_fast.try_compile`` accepts runs specialised
(``"fast"``: generated straight-line code in the kernels, the executor over
tensors in the plain predictor; no H and no M), any other through a ZPAQL
interpreter (``"interp"``: in the kernels with a per-launch step limit,
``max_hcomp_steps``, 2^24 instructions for one byte by default; in the
plain predictor the scalar ``zpaql.vm.VM`` per lane, without a limit).

The kernels' combine (phase (b)) runs in one of two ways too: a model whose
combine ``ops/combine_fast.try_compile`` accepts runs it as generated
straight-line code (``"fast"``), any other through the generic walk over
the model's steps (``"generic"``). So do its phases (a) and (c): generated
per model and placement by ``ops/phases_fast.try_compile`` (``"fast"``), or
``phase_a`` / ``phase_c`` reading the model on every bit (``"generic"``).
Each pair gives the same bits. The generated texts of a launch go into one
build unit per kernel and model (``kernel_unit``).

The plain predictor batches lanes in ``int64`` tensors (CPU ``uint32`` has
no arithmetic) and keeps the arenas as ``uint8`` / ``int32`` tensors widened
after each gather.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import trace
from ..models import tables as T
from ..zpaql.header import Model
from ..zpaql.vm import VM, ZPAQLRuntimeError
from . import build, combine_fast, phases_fast
from .hcomp_fast import try_compile

#: held while a launch adds to its kernel's count (``counted``)
_COUNT_LOCK = threading.Lock()

ST_OK, ST_OVERRUN, ST_CORRUPT, ST_EOF, ST_ZPAQL = range(5)

_M32 = 0xFFFFFFFF
_NPAR = 6
#: instructions an interpreted HCOMP run may execute for one byte before
#: the kernels take it as a runaway program and fail the lane
MAX_HCOMP_STEPS = 1 << 24
#: the HCOMP steps of the lane kernels
HCOMP_STEPS = ("fast", "interp")
#: the combines of the lane kernels
COMBINE_STEPS = ("fast", "generic")
#: the phases (a) and (c) of the lane kernels
PHASES_STEPS = ("fast", "generic")

# combined LUT: squash(4096) | stretch(32768) | sns(1024), as codec_arena
SQ_OFF = 0
STR_OFF = 4096
SNS_OFF = 4096 + 32768
_BIGLUT = np.concatenate([T.SQUASHT.astype(np.int32),
                          T.STRETCHT.astype(np.int32),
                          T.SNS.astype(np.int32)]).astype(np.int32)


def lut(device) -> torch.Tensor:
    """The combined squash/stretch/SNS table as an int32 tensor."""
    return torch.from_numpy(_BIGLUT).to(device)


class Layout:
    """Arena segment offsets of one model (``codec_arena._Layout``)."""

    def __init__(self, model: Model):
        self.comps = [tuple(c) for c in model.comps]
        s8 = 0
        s32 = 0
        self.off8: Dict[int, int] = {}
        self.off32: Dict[int, int] = {}
        for i, cp in enumerate(self.comps):
            t = cp[0]
            if t == T.ICM:
                self.off8[i] = s8
                s8 += 64 << cp[1]
                self.off32[i] = s32
                s32 += 256
            elif t == T.ISSE:
                self.off8[i] = s8
                s8 += 64 << cp[1]
                self.off32[i] = s32
                s32 += 512
            elif t == T.MATCH:
                self.off8[i] = s8
                s8 += 1 << cp[2]
                self.off32[i] = s32
                s32 += 1 << cp[1]
            elif t == T.CM:
                self.off32[i] = s32
                s32 += 1 << cp[1]
            elif t == T.MIX:
                self.off32[i] = s32
                s32 += (1 << cp[1]) * cp[3]
            elif t == T.MIX2:
                self.off32[i] = s32
                s32 += 1 << cp[1]
            elif t == T.SSE:
                self.off32[i] = s32
                s32 += 32 << cp[1]
        self.s8 = max(s8, 1)
        self.s32 = max(s32, 1)

    def init_rows(self) -> Tuple[np.ndarray, np.ndarray]:
        """Single-lane initial arena contents (u8 arena, u32 arena)."""
        a8 = np.zeros(self.s8, np.uint8)
        a32 = np.zeros(self.s32, np.uint32)
        isse_wt = np.zeros(512, np.uint32)
        isse_wt[0::2] = 1 << 15
        w1 = np.clip(
            T.STRETCHT[(T.CMINIT >> 8).astype(np.int64)].astype(np.int64)
            * 1024, -(1 << 19), (1 << 19) - 1).astype(np.int32)
        isse_wt[1::2] = w1.view(np.uint32)
        for i, cp in enumerate(self.comps):
            t = cp[0]
            if t == T.CM:
                a32[self.off32[i]: self.off32[i] + (1 << cp[1])] = 0x80000000
            elif t == T.ICM:
                a32[self.off32[i]: self.off32[i] + 256] = \
                    T.CMINIT.astype(np.uint32)
            elif t == T.ISSE:
                a32[self.off32[i]: self.off32[i] + 512] = isse_wt
            elif t == T.MATCH:
                a8[self.off8[i]] = 1
            elif t == T.MIX:
                m = cp[3]
                n = (1 << cp[1]) * m
                a32[self.off32[i]: self.off32[i] + n] = \
                    np.int32(65536 // m).view(np.uint32)
            elif t == T.MIX2:
                a32[self.off32[i]: self.off32[i] + (1 << cp[1])] = 32768
            elif t == T.SSE:
                base = np.array(
                    [(np.uint32(T.SQUASHT[j * 64 - 992 + 2048]) << 17)
                     | np.uint32(cp[3]) for j in range(32)], np.uint32)
                n = 32 << cp[1]
                a32[self.off32[i]: self.off32[i] + n] = np.tile(base, n // 32)
        return a8, a32


def initial_lane_state(model: Model, L: int, device
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                  torch.Tensor]:
    """Fresh model state for ``L`` lanes on ``device``: the u8 arena
    (L, s8) ``uint8``, the u32 arena (L, s32) as ``int32`` bit patterns,
    HCOMP's H (L, 2^hh) ``int32`` and M (L, 2^hm) ``uint8``, all zero but
    the arena rows of ``Layout.init_rows``."""
    a8_row, a32_row = Layout(model).init_rows()
    a8 = torch.from_numpy(a8_row).to(device).expand(L, -1).contiguous()
    a32 = torch.from_numpy(a32_row.view(np.int32)).to(device).expand(
        L, -1).contiguous()
    hmem = torch.zeros((L, 1 << model.hh), dtype=torch.int32, device=device)
    mmem = torch.zeros((L, 1 << model.hm), dtype=torch.uint8, device=device)
    return a8, a32, hmem, mmem


def hcomp_step(model: Model, hcomp: Optional[str] = None) -> str:
    """The HCOMP step a launch of ``model`` runs: ``"fast"`` when
    ``try_compile`` accepts the program, else ``"interp"``; ``hcomp``
    forces one ("fast" raises for a program outside the subset)."""
    fast = try_compile(model) is not None
    if hcomp is None:
        return "fast" if fast else "interp"
    if hcomp not in HCOMP_STEPS:
        raise ValueError(f"hcomp must be one of {HCOMP_STEPS}, not {hcomp!r}")
    if hcomp == "fast" and not fast:
        raise ValueError("the model's HCOMP program is outside the "
                         "specialisable subset")
    return hcomp


def combine_step(model: Model, plan: "Placement",
                 combine: Optional[str] = None) -> str:
    """The combine a launch of ``model`` at placement ``plan`` runs:
    ``"fast"`` when ``combine_fast.try_compile`` accepts the model, else
    ``"generic"``; ``combine`` forces one ("fast" raises for a model the
    generator refuses)."""
    fast = combine_fast.try_compile(model, plan.rows) is not None
    if combine is None:
        return "fast" if fast else "generic"
    if combine not in COMBINE_STEPS:
        raise ValueError(f"combine must be one of {COMBINE_STEPS}, not "
                         f"{combine!r}")
    if combine == "fast" and not fast:
        raise ValueError("the model's combine is outside what the "
                         "generator specialises")
    return combine


def phases_step(model: Model, plan: "Placement",
                phases: Optional[str] = None) -> str:
    """The phases (a) and (c) a launch of ``model`` at placement ``plan``
    runs: ``"fast"`` when ``phases_fast.try_compile`` accepts the model,
    else ``"generic"``; ``phases`` forces one ("fast" raises for a model
    the generator refuses)."""
    fast = phases_fast.try_compile(model, plan, Layout(model)) is not None
    if phases is None:
        return "fast" if fast else "generic"
    if phases not in PHASES_STEPS:
        raise ValueError(f"phases must be one of {PHASES_STEPS}, not "
                         f"{phases!r}")
    if phases == "fast" and not fast:
        raise ValueError("the model's phases are outside what the "
                         "generator specialises")
    return phases


def kernel_unit(kernel: str, model: Model, hcomp: Optional[str] = None,
                combine: Optional[str] = None,
                phases: Optional[str] = None) -> build.Unit:
    """The build unit of ``kernel`` (``"cm_decode"`` or ``"cm_encode"``)
    that a launch of ``model`` runs with HCOMP step ``hcomp``, combine
    ``combine`` and phases ``phases`` (None: each specialised where the
    model allows): the kernel alone, or the kernel with the generated
    header that holds whichever of the specialised HCOMP program, combine
    and phases it runs."""
    hcomp = hcomp_step(model, hcomp)
    plan = Placement(model, hcomp)
    parts = []
    if hcomp == "fast":
        parts += [try_compile(model).cuda_source(), "#define CM_HCOMP_FAST 1"]
    if combine_step(model, plan, combine) == "fast":
        parts += [combine_fast.try_compile(model, plan.rows).cuda_source(),
                  "#define CM_COMBINE_FAST 1"]
    if phases_step(model, plan, phases) == "fast":
        parts += [phases_fast.try_compile(model, plan, Layout(model))
                  .cuda_source(), "#define CM_PHASES_FAST 1"]
    return (kernel, "\n".join(parts) + "\n") if parts else kernel


def lane_bytes(model: Model, hcomp: str = "interp") -> int:
    """Device bytes of one lane's state in a kernel launch with HCOMP step
    ``hcomp``: the u8 arena at the kernel's aligned offsets, the u32 arena,
    and for the interpreter H unless it lives in shared memory, M and ZPAQL
    R (the specialised step allocates none of them)."""
    plan = Placement(model, hcomp)
    base = plan.s8 + 4 * Layout(model).s32
    if hcomp == "fast":
        return base
    h = 0 if plan.geo["ht"] >= 0 else 4 << model.hh
    return base + h + (1 << model.hm) + 1024


# ---------------------------------------------------------------------------
# placement of a model's state for the CUDA kernels


#: shared bytes one thread block may use (H100, sm_90)
SMEM_LIMIT = 232448
#: shared bytes a lane's region may take: tables beyond it stay in device
#: memory, which keeps at least four lanes in a block of the standard models
LANE_BUDGET = 48 << 10
#: threads of a lane's group: at most one warp
MAX_GROUP = 32
#: threads of a block: the kernels are compiled for at most this many
#: (csrc/cm_model.cuh MAX_BLOCK_THREADS, ``__launch_bounds__``), which
#: leaves each thread up to 128 registers (they use about 120)
MAX_BLOCK_THREADS = 512
#: per-component placement columns (csrc/cm_model.cuh CP_*)
_NPLAN = 3
#: the lane region's arrays, in csrc/cm_model.cuh's G_* order
GEO = ("h", "p", "cxt", "wa", "wb", "rowat", "row", "misc", "ht")
#: a profiled launch's clock counters per lane (csrc/cm_model.cuh P_*):
#: cycles of thread 0 in phase (a), waiting for its group, the combine and
#: coder step, the bit's broadcast, phase (c), the bit's tail, MATCH's byte
#: end, HCOMP and the new context hashes; then the coded bits and bytes
PROFILE = ("a", "wait_a", "combine", "wait_b", "c", "tail", "match",
           "hcomp", "hash", "bits", "bytes")


def header_bytes(n: int, hlen: int) -> int:
    """Bytes of a block's shared header (csrc/cm_model.cuh
    ``header_bytes``): squash as int16, the state table, the lower half of
    stretch as int16, the counter steps and MATCH's 2048 / length, the
    combine's steps, the model's offsets, parameters and placement, two
    component lists and HCOMP with a byte of padding."""
    return (4096 * 2 + 1024 + 16384 * 2 + 1024 * 4 + 256 * 2 + 16 * n
            + 16 * n + 4 * _NPAR * n + 4 * _NPLAN * n + 8 * n + 12 + hlen
            + 1 + 15) & ~15


def table_words(cp) -> int:
    """Words of a component's u32 table (``Layout``'s segment)."""
    t = cp[0]
    if t == T.ICM:
        return 256
    if t == T.ISSE:
        return 512
    if t in (T.CM, T.MATCH, T.MIX2):
        return 1 << cp[1]
    if t == T.MIX:
        return (1 << cp[1]) * cp[3]
    if t == T.SSE:
        return 32 << cp[1]
    return 0


def hcomp_bytes(model: Model) -> bytes:
    """The HCOMP bytecode a kernel runs (a lone HALT for none)."""
    return model.hcomp or b"\x38"


class Placement:
    """Where a CUDA launch keeps one model's state, the plan that
    ``csrc/cm_model.cuh`` runs.

    - ``G``: threads that code one lane, the power of two >= n up to 32.
    - The lane's shared region (``lane_words`` words, 16-byte aligned
      pieces): per-component arrays (``geo``), the MIX and SSE row copies
      (``rows``: component -> word offset), thread 0's broadcast words, and
      the tables placed in shared memory (``shared``: component
      -> word offset of its u32 table, -1 -> HCOMP's H), smallest first
      while the region stays within ``LANE_BUDGET``. Every other table
      stays in device memory: the u8 tables always (at ``off8``, 64-byte
      aligned, stride ``s8``), the u32 tables at ``Layout``'s offsets, H in
      its own tensor, and ZPAQL R (which the standard programs never use).
      ``hcomp`` is the launch's HCOMP step: the specialised one (``"fast"``)
      has no H to place.
    - ``lanes_per_block``: lanes whose regions fit one block beside the
      header (``header``), at most ``MAX_BLOCK_THREADS`` threads;
      ``smem``: the block's
      shared bytes."""

    def __init__(self, model: Model, hcomp: str = "interp"):
        n = model.n
        if not 1 <= n <= 256:
            raise ValueError(f"a CM kernel takes 1..256 components, not {n}")
        if hcomp not in HCOMP_STEPS:
            raise ValueError(f"hcomp must be one of {HCOMP_STEPS}")
        self.hcomp = hcomp
        comps = [tuple(c) for c in model.comps]
        self.G = 1
        while self.G < min(n, MAX_GROUP):
            self.G *= 2
        words = 0
        #: (name, word offset, words) of every piece of the lane region
        self.pieces: List[Tuple[object, int, int]] = []

        def take(name, k: int) -> int:
            nonlocal words
            off = words
            words += -(-k // 4) * 4
            self.pieces.append((name, off, k))
            return off

        self.geo = {g: take(g, 2 * n if g == "p" else n) for g in GEO[:6]}
        self.geo["row"] = take("row", 4 * n)
        self.rows: Dict[int, int] = {}
        for i, cp in enumerate(comps):
            if cp[0] in (T.MIX, T.SSE):
                self.rows[i] = take(("rows", i),
                                    cp[3] if cp[0] == T.MIX else 32)
        self.geo["misc"] = take("misc", 4)
        tables = sorted([(1 << model.hh, -1)] * (hcomp == "interp") + [
            (table_words(cp), i) for i, cp in enumerate(comps)
            if table_words(cp)])
        self.shared: Dict[int, int] = {}
        for size, i in tables:
            if 4 * (words + -(-size // 4) * 4) <= LANE_BUDGET:
                self.shared[i] = take(("table", i), size)
        self.geo["ht"] = self.shared.get(-1, -1)
        self.lane_words = words
        self.header = header_bytes(n, len(hcomp_bytes(model)))
        self.lanes_per_block = min((SMEM_LIMIT - self.header)
                                   // (4 * words),
                                   MAX_BLOCK_THREADS // self.G)
        if self.lanes_per_block < 1:
            raise ValueError(f"model with {n} components does not fit a "
                             f"block's shared memory")
        self.smem = self.header + self.lanes_per_block * 4 * words
        self.off8 = [0] * n
        s8 = 0
        for i, cp in enumerate(comps):
            if cp[0] in (T.ICM, T.ISSE, T.MATCH):
                self.off8[i] = s8
                s8 += (64 << cp[1]) if cp[0] != T.MATCH else 1 << cp[2]
                s8 = -(-s8 // 64) * 64
        self.s8 = max(s8, 64)

    def blocks(self, L: int) -> int:
        """Thread blocks of a launch over ``L`` lanes (the kernels' grid)."""
        return -(-L // self.lanes_per_block)

    def cplan(self, model: Model) -> np.ndarray:
        """(n, 3) int32: shared word offset of each u32 table (-1: device
        memory), its words, and the offset of its row copy (-1: none)."""
        out = np.full((model.n, _NPLAN), -1, np.int32)
        for i, cp in enumerate(model.comps):
            out[i, 0] = self.shared.get(i, -1)
            out[i, 1] = table_words(cp)
            out[i, 2] = self.rows.get(i, -1)
        return out

    def geometry(self) -> np.ndarray:
        return np.array([self.geo[g] for g in GEO], np.int32)


def kernel_state(model: Model, plan: Placement, L: int, device
                 ) -> Tuple[torch.Tensor, torch.Tensor,
                            Optional[torch.Tensor], Optional[torch.Tensor]]:
    """Fresh state for ``L`` lanes of a kernel launch: the state of
    ``initial_lane_state`` with the u8 arena at the plan's aligned offsets,
    H only where it lives in device memory (else one unused word) and M;
    for the specialised HCOMP step neither H nor M (None)."""
    a8_row = np.zeros(plan.s8, np.uint8)
    for i, cp in enumerate(model.comps):
        if cp[0] == T.MATCH:
            a8_row[plan.off8[i]] = 1
    a32_row = Layout(model).init_rows()[1]
    a8 = torch.from_numpy(a8_row).to(device).expand(L, -1).contiguous()
    a32 = torch.from_numpy(a32_row.view(np.int32)).to(device).expand(
        L, -1).contiguous()
    if plan.hcomp == "fast":
        return a8, a32, None, None
    hmem = torch.zeros((L, 1 << model.hh) if plan.geo["ht"] < 0 else (1,),
                       dtype=torch.int32, device=device)
    mmem = torch.zeros((L, 1 << model.hm), dtype=torch.uint8, device=device)
    return a8, a32, hmem, mmem


def check_lanes(model: Model, src: torch.Tensor, in_off: torch.Tensor,
                in_len: torch.Tensor, out_cap: torch.Tensor) -> None:
    """Validate a lane kernel's inputs: ``src`` a contiguous 1-D uint8
    tensor, the per-lane spans contiguous 1-D int64 tensors of one shape on
    its device, and a model with components."""
    if model.n == 0:
        raise ValueError("store-mode blocks have no model to code")
    if src.dtype != torch.uint8 or src.dim() != 1:
        raise TypeError("the lanes' bytes must be a 1-D uint8 tensor")
    for name, t in (("in_off", in_off), ("in_len", in_len),
                    ("out_cap", out_cap)):
        if t.dtype != torch.int64 or t.dim() != 1:
            raise TypeError(f"{name} must be a 1-D int64 tensor")
        if t.device != src.device:
            raise ValueError(f"{name} is on {t.device}, the lanes' bytes on "
                             f"{src.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not src.is_contiguous():
        raise ValueError("the lanes' bytes must be contiguous")
    if not in_off.shape == in_len.shape == out_cap.shape:
        raise ValueError("in_off, in_len and out_cap differ in shape")


def raise_failed(status: torch.Tensor, error: type,
                 reasons: Dict[int, str]) -> None:
    """Raise ``error`` naming the first failed lanes, if any failed."""
    bad = torch.nonzero(status).flatten().tolist()
    if bad:
        st = status.tolist()
        raise error("; ".join(
            f"lane {i}: {reasons.get(st[i], f'status {st[i]}')}"
            for i in bad[:4]) + (f" (+{len(bad) - 4} lanes)"
                                 if len(bad) > 4 else ""))


def out_offsets(out_cap: torch.Tensor) -> torch.Tensor:
    off = torch.zeros_like(out_cap)
    if out_cap.numel() > 1:
        off[1:] = torch.cumsum(out_cap, 0)[:-1]
    return off


def plain_result(outs: List[bytearray], out_cap: torch.Tensor, device
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-lane byte strings in the kernels' output layout ``(out, out_off,
    out_len)``: lane i at ``out[out_off[i]:out_off[i] + out_len[i]]``."""
    out_off = out_offsets(out_cap)
    out = torch.zeros(int(out_cap.sum()) or 1, dtype=torch.uint8)
    offs = out_off.tolist()
    for k, b in enumerate(outs):
        if b:
            out[offs[k]: offs[k] + len(b)] = torch.frombuffer(
                bytearray(b), dtype=torch.uint8)
    lens = torch.tensor([len(b) for b in outs], dtype=torch.int64)
    return out.to(device), out_off, lens.to(device)


def lanes_to_bytes(out: torch.Tensor, out_off: torch.Tensor,
                   out_len: torch.Tensor) -> List[bytes]:
    """Split a lane kernel's result into one bytes object per lane."""
    flat = out.cpu().numpy()
    return [flat[o: o + n].tobytes()
            for o, n in zip(out_off.tolist(), out_len.tolist())]


class LaneLaunch:
    """One launch of a CM lane kernel over every lane, prepared: inputs
    checked, the model's tables, its ``Placement`` and fresh lane state on
    the card, outputs allocated. ``run()`` launches the kernel once;
    ``result()`` raises ``error`` for a failed lane and returns ``(out,
    out_off, out_len)``. The split lets a caller time the launch apart from
    the state set-up. ``profile=True`` has thread 0 of every lane count its
    clock cycles per phase (``PROFILE``), read with ``profile()``.
    While the tracer records (``trace.enabled``), it also writes the
    card's nanosecond clock when each lane starts and ends (``stamps``,
    (L, 2) int64), ``code()`` adds the lane state's device bytes
    (``state_bytes``) to its span ``cm.launch``, and ``result()`` adds
    each lane's nanoseconds (``lane_ns``), the launch's, from the first
    start to the last end (``kernel_ns``), and each lane's coded bits
    (``lane_bits``, 8 x ``lane_payload()``) to its span ``cm.wait``; else
    ``stamps`` is None and nothing is counted.

    ``hcomp`` is the HCOMP step (``hcomp_step``): None runs the program
    specialised when ``try_compile`` accepts it, else the interpreter, as
    the reference's ``ArenaCoder`` does; ``"interp"`` forces the
    interpreter, so that the two can be held against each other on the
    card. ``self.hcomp`` records the step. ``combine`` is the combine
    (``combine_step``): None runs the generated one where the generator
    accepts the model, ``"generic"`` forces the generic walk;
    ``self.combine`` records it. ``phases`` are phases (a) and (c)
    (``phases_step``), likewise: None the generated ones where the
    generator accepts the model, ``"generic"`` forces ``phase_a`` /
    ``phase_c``; ``self.phases`` records them. ``max_hcomp_steps`` bounds
    the
    instructions an interpreted run may execute for one byte (default
    ``MAX_HCOMP_STEPS``): past it the lane fails as a runaway program. A
    specialised program has no loops and no limit.

    Subclasses name the kernel (its library under ``csrc/`` and the prefix
    of its ``_launch`` symbol), the error, the reason of each status, the
    payload bytes of each lane (``lane_payload()``), and count their
    launches in ``counted()``."""

    kernel = ""
    error: type = RuntimeError
    reasons: Dict[int, str] = {}

    def __init__(self, model: Model, src: torch.Tensor, in_off: torch.Tensor,
                 in_len: torch.Tensor, out_cap: torch.Tensor,
                 profile: bool = False, hcomp: Optional[str] = None,
                 max_hcomp_steps: Optional[int] = None,
                 combine: Optional[str] = None,
                 phases: Optional[str] = None):
        check_lanes(model, src, in_off, in_len, out_cap)
        if src.device.type != "cuda":
            raise ValueError(f"no {self.kernel} kernel for device "
                             f"{src.device}")
        self.prepare(model, src, in_off, in_len, out_cap, profile, hcomp,
                     max_hcomp_steps, combine, phases)

    @classmethod
    def code(cls, model: Model, src: torch.Tensor, in_off: torch.Tensor,
             in_len: torch.Tensor, out_cap: torch.Tensor,
             max_hcomp_steps: Optional[int] = None
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """``cls(...).run().result()``: the set-up and the launch under the
        span ``cm.launch``, the wait for the kernel under ``cm.wait``."""
        with trace.span("cm.launch", lanes=int(in_off.shape[0])) as sp:
            launch = cls(model, src, in_off, in_len, out_cap,
                         max_hcomp_steps=max_hcomp_steps).run()
            sp.add(hcomp=launch.hcomp, combine=launch.combine,
                   phases=launch.phases)
            if launch.stamps is not None:
                sp.add(state_bytes=launch.state_bytes())
        return launch.result()

    def prepare(self, model: Model, src: torch.Tensor, in_off: torch.Tensor,
                in_len: torch.Tensor, out_cap: torch.Tensor,
                profile: bool = False, hcomp: Optional[str] = None,
                max_hcomp_steps: Optional[int] = None,
                combine: Optional[str] = None,
                phases: Optional[str] = None) -> None:
        """Build the launch's arguments on the inputs' device."""
        dev = src.device
        L = in_off.shape[0]
        if L == 0:
            raise ValueError("no lanes to code")
        steps = MAX_HCOMP_STEPS if max_hcomp_steps is None \
            else int(max_hcomp_steps)
        if not 1 <= steps < 1 << 63:
            raise ValueError("max_hcomp_steps must be at least 1")
        if (int(in_off.min()) < 0 or int(in_len.min()) < 0
                or int((in_off + in_len).max()) > src.numel()
                or int(out_cap.min()) < 0):
            raise ValueError("a lane reaches outside its input, or has a "
                             "negative capacity")
        lay = Layout(model)
        self.hcomp = hcomp_step(model, hcomp)
        self.plan = plan = Placement(model, self.hcomp)
        self.combine = combine_step(model, plan, combine)
        self.phases = phases_step(model, plan, phases)
        #: the build unit: the kernel, or the kernel with the generated code
        self.unit = kernel_unit(self.kernel, model, self.hcomp, self.combine,
                                self.phases)
        comps = np.zeros((model.n, _NPAR), np.int32)
        for i, cp in enumerate(lay.comps):
            comps[i, :len(cp)] = cp
        off32 = np.array([lay.off32.get(i, 0) for i in range(model.n)],
                         np.int64)
        hcomp = np.frombuffer(hcomp_bytes(model), np.uint8).copy()
        self.dev = dev
        t = lambda a: torch.from_numpy(a).to(dev)       # noqa: E731
        # kept here so that the tensors outlive the launch
        self._inputs = (t(comps), t(plan.cplan(model)),
                        t(np.array(plan.off8, np.int64)), t(off32), t(hcomp),
                        t(plan.geometry()), lut(dev))
        self._state = kernel_state(model, plan, L, dev)
        # ZPAQL R, H and M: the interpreter's alone (null pointers else)
        self._rmem = (torch.zeros((L, 256), dtype=torch.int32, device=dev)
                      if self.hcomp == "interp" else None)
        self.in_len = in_len
        self.out_off = out_offsets(out_cap)
        self.out = torch.empty(int(out_cap.sum()) or 1, dtype=torch.uint8,
                               device=dev)
        self.out_len = torch.empty(L, dtype=torch.int64, device=dev)
        self.status = torch.empty(L, dtype=torch.int32, device=dev)
        self.prof = (torch.zeros((L, len(PROFILE)), dtype=torch.int64,
                                 device=dev) if profile else None)
        self.stamps = (torch.empty((L, 2), dtype=torch.int64, device=dev)
                       if trace.enabled() else None)
        t_comps, t_cplan, t_off8, t_off32, t_hcomp, t_geo, t_lut = \
            self._inputs
        a8, a32, hmem, mmem = self._state
        self._args = (
            t_comps, t_cplan, t_off8, t_off32, model.n, t_hcomp, len(hcomp),
            model.hh, model.hm, steps, plan.G, plan.lanes_per_block,
            plan.blocks(L), plan.lane_words, t_geo, t_lut, src, in_off,
            in_len, a8, plan.s8, a32, lay.s32,
            *[0 if t is None else t for t in (hmem, mmem, self._rmem)],
            self.out, self.out_off, out_cap, self.out_len, self.status,
            0 if self.prof is None else self.prof,
            0 if self.stamps is None else self.stamps, L)
        self._ran = False

    def counted(self) -> None:
        raise NotImplementedError

    def lane_payload(self) -> torch.Tensor:
        """(L,) int64 payload bytes of each lane, selector prefix included:
        what an encode lane codes, what a decode lane restores."""
        raise NotImplementedError

    def state_bytes(self) -> int:
        """Device bytes of the launch's lane state: the u8 and u32 arenas,
        and for the interpreter H where it lives in device memory, M and
        ZPAQL R (L x ``lane_bytes`` of the launch's HCOMP step)."""
        a8, a32, hmem, mmem = self._state
        own = [a8, a32, mmem, self._rmem]
        if self.plan.geo["ht"] < 0:
            own.append(hmem)
        return sum(t.numel() * t.element_size() for t in own
                   if t is not None)

    def run(self) -> "LaneLaunch":
        """Launch the kernel on the current stream (once: it consumes the
        fresh lane state)."""
        if self._ran:
            raise RuntimeError(f"a prepared {self.kernel} launch runs once")
        self._ran = True
        stamps = () if self.stamps is None else (self.stamps,)
        build.call(self.unit, f"{self.kernel}_launch", self.dev, *self._args,
                   written=(self.out_len, self.status, *stamps),
                   varies=[(t, 0, t.numel() * 8) for t in stamps])
        with _COUNT_LOCK:         # shards launch from several threads
            self.counted()
        return self

    def profile(self) -> np.ndarray:
        """(L, len(PROFILE)) int64 clock counters of a profiled launch."""
        if self.prof is None or not self._ran:
            raise RuntimeError("not a profiled launch that has run")
        return self.prof.cpu().numpy()

    def result(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        if not self._ran:
            raise RuntimeError(f"the {self.kernel} launch has not run")
        with trace.span("cm.wait") as sp:
            raise_failed(self.status, self.error, self.reasons)
            if self.stamps is not None:
                ns = self.stamps.cpu()
                sp.add(lane_ns=(ns[:, 1] - ns[:, 0]).tolist(),
                       kernel_ns=int(ns[:, 1].max() - ns[:, 0].min()),
                       lane_bits=(8 * self.lane_payload().cpu()).tolist())
        return self.out, self.out_off, self.out_len


# ---------------------------------------------------------------------------
# plain PyTorch predictor


class PlainModel:
    """Lane-batched predictor state and its ``predict`` / ``update``; every
    tensor is (L,) unless noted. The coders add their range coder and set
    ``active`` (lanes still coding) and ``status``."""

    def __init__(self, model: Model, L: int, dev):
        self.model = model
        self.lay = Layout(model)
        self.L = L
        self.dev = dev
        self.lut = lut(dev).long()
        self.ar = torch.arange(L, device=dev)
        self.a8, self.a32, _, _ = initial_lane_state(model, L, dev)
        z = torch.zeros(L, dtype=torch.int64, device=dev)
        # HCOMP: the specialised program over all lanes, else a VM per lane
        self.fh = try_compile(model)
        if self.fh is None:
            self.vms = [VM.for_hcomp(model) for _ in range(L)]
        else:
            self.win = self.fh.init_state(L, dev)["win"]
            self.cc = z.clone()
        self.status = z.clone()
        self.active = torch.ones(L, dtype=torch.bool, device=dev)
        self.c8 = z + 1
        self.hmap4 = z + 1
        n = model.n
        self.h = [z.clone() for _ in range(n)]
        self.p = [z.clone() for _ in range(n)]
        self.cxt = [z.clone() for _ in range(n)]
        self.row = [z.clone() for _ in range(n)]
        self.ma = [z.clone() for _ in range(n)]
        self.mb = [z.clone() for _ in range(n)]
        self.ml = [z.clone() for _ in range(n)]
        self.mc = [z.clone() for _ in range(n)]

    # -- helpers ------------------------------------------------------------
    def fail(self, mask: torch.Tensor, code: int) -> None:
        mask = mask & self.active
        if bool(mask.any()):
            self.status = torch.where(mask, code, self.status)
            self.active = self.active & ~mask

    def g8(self, idx: torch.Tensor) -> torch.Tensor:
        return self.a8[self.ar, idx].long()

    def s8(self, idx: torch.Tensor, val: torch.Tensor) -> None:
        self.a8[self.ar, idx] = val.to(torch.uint8)     # keeps the low byte

    def g32u(self, idx: torch.Tensor) -> torch.Tensor:
        return self.a32[self.ar, idx].long() & _M32

    def g32s(self, idx: torch.Tensor) -> torch.Tensor:
        return self.a32[self.ar, idx].long()

    def s32(self, idx: torch.Tensor, val: torch.Tensor) -> None:
        self.a32[self.ar, idx] = val.to(torch.int32)    # keeps the low 32 bits

    def find(self, i: int, cp, cx: torch.Tensor) -> torch.Tensor:
        size = 64 << cp[1]
        off = self.lay.off8[i]
        chk = (cx >> (cp[1] + 2)) & 255
        h0 = (cx * 16) & (size - 16)
        h1, h2 = h0 ^ 16, h0 ^ 32
        ck = [self.g8(off + h) for h in (h0, h1, h2)]
        pr = [self.g8(off + h + 1) for h in (h0, h1, h2)]
        m0, m1, m2 = (c == chk for c in ck)
        hit = torch.where(m0, h0, torch.where(m1, h1, h2))
        rep = torch.where((pr[0] <= pr[1]) & (pr[0] <= pr[2]), h0,
                          torch.where(pr[1] < pr[2], h1, h2))
        anym = m0 | m1 | m2
        sel = torch.where(anym, hit, rep)
        miss = torch.nonzero(~anym).flatten()
        if miss.numel():
            cols = off + sel[miss, None] + torch.arange(16, device=self.dev)
            fresh = torch.zeros((miss.numel(), 16), dtype=torch.uint8,
                                device=self.dev)
            fresh[:, 0] = chk[miss].to(torch.uint8)
            self.a8[miss[:, None], cols] = fresh
        return sel

    # -- one bit ------------------------------------------------------------
    def predict(self, phase: int) -> torch.Tensor:
        """P(next bit = 1) in 1/4096 units; ``phase`` is the bit's index in
        its byte, from the top."""
        lay, p, L = self.lay, self.p, self.lut
        c8, hmap4 = self.c8, self.hmap4
        for i, cp in enumerate(lay.comps):
            t = cp[0]
            if t == T.CONS:
                p[i] = torch.full_like(c8, (cp[1] - 128) * 4)
            elif t == T.CM:
                self.cxt[i] = (self.h[i] ^ hmap4) & ((1 << cp[1]) - 1)
                p[i] = L[STR_OFF + (self.g32u(lay.off32[i] + self.cxt[i])
                                    >> 17)]
            elif t in (T.ICM, T.ISSE):
                if phase in (0, 4):
                    self.row[i] = self.find(
                        i, cp, (self.h[i] + 16 * c8) & _M32)
                self.cxt[i] = self.g8(lay.off8[i] + self.row[i]
                                      + (hmap4 & 15))
                if t == T.ICM:
                    p[i] = L[STR_OFF + (self.g32u(lay.off32[i] + self.cxt[i])
                                        >> 8)]
                else:
                    base = lay.off32[i] + self.cxt[i] * 2
                    w0, w1 = self.g32s(base), self.g32s(base + 1)
                    p[i] = ((w0 * p[cp[2]] + w1 * 64) >> 16).clamp(-2048,
                                                                    2047)
            elif t == T.MATCH:
                a = self.ma[i]
                on = a != 0
                mask = (1 << cp[2]) - 1
                byte = self.g8(lay.off8[i] + ((self.ml[i] - self.mb[i])
                                              & mask))
                self.mc[i] = torch.where(on, (byte >> (7 - phase)) & 1,
                                         self.mc[i])
                dt2k = 2048 // a.clamp(min=1)
                pm = (dt2k * (self.mc[i] * -2 + 1)) & 32767
                p[i] = torch.where(on, L[STR_OFF + pm], 0)
            elif t == T.AVG:
                p[i] = (p[cp[1]] * cp[3] + p[cp[2]] * (256 - cp[3])) >> 8
            elif t == T.MIX2:
                self.cxt[i] = (self.h[i] + (c8 & cp[5])) & ((1 << cp[1]) - 1)
                w = self.g32s(lay.off32[i] + self.cxt[i])
                p[i] = (w * p[cp[2]] + (65536 - w) * p[cp[3]]) >> 16
            elif t == T.MIX:
                m = cp[3]
                self.cxt[i] = ((self.h[i] + (c8 & cp[5]))
                               & ((1 << cp[1]) - 1)) * m
                cols = (lay.off32[i] + self.cxt[i][:, None]
                        + torch.arange(m, device=self.dev))
                w = self.a32[self.ar[:, None], cols].long()
                x = torch.stack(p[cp[2]: cp[2] + m], 1)
                p[i] = (((w >> 8) * x).sum(1) >> 8).clamp(-2048, 2047)
            elif t == T.SSE:
                mask = (32 << cp[1]) - 1
                cx = ((self.h[i] + c8) * 32) & _M32
                pq = (p[cp[2]] + 992).clamp(0, 1983)
                wt = pq & 63
                cx = (cx + (pq >> 6)) & _M32
                v0 = self.g32u(lay.off32[i] + (cx & mask)) >> 10
                v1 = self.g32u(lay.off32[i] + ((cx + 1) & mask)) >> 10
                p[i] = L[STR_OFF + ((v0 * (64 - wt) + v1 * wt) >> 13)]
                self.cxt[i] = (cx + (wt >> 5)) & _M32
            else:
                raise ValueError(f"unknown component type {t}")
        return L[SQ_OFF + p[-1] + 2048]

    def train(self, idx: torch.Tensor, y: torch.Tensor, limit: int) -> None:
        pn = self.g32u(idx)
        count = pn & 1023
        error = y * 32767 - (pn >> 17)
        dt = ((1 << 17) // (count * 2 + 3)) * 2
        pn = (pn + ((error * dt) & 0xFFFFFC00)) & _M32
        self.s32(idx, pn + (count < limit).long())

    def update(self, phase: int, y: torch.Tensor) -> None:
        lay, p, L = self.lay, self.p, self.lut
        hm4 = self.hmap4 & 15
        for i, cp in enumerate(lay.comps):
            t = cp[0]
            if t == T.CM:
                self.train(lay.off32[i] + self.cxt[i], y, cp[2] * 4)
            elif t == T.ICM:
                idx = lay.off8[i] + self.row[i] + hm4
                self.s8(idx, L[SNS_OFF + self.g8(idx) * 4 + y])
                j = lay.off32[i] + self.cxt[i]
                pn = self.g32u(j)
                self.s32(j, pn + ((y * 32767 - (pn >> 8)) >> 2))
            elif t == T.MATCH:
                self.update_match(i, cp, phase, y)
            elif t == T.MIX2:
                err = ((y * 32767 - L[SQ_OFF + p[i] + 2048]) * cp[4]) >> 5
                j = lay.off32[i] + self.cxt[i]
                w = self.g32s(j) + ((err * (p[cp[2]] - p[cp[3]]) + (1 << 12))
                                    >> 13)
                self.s32(j, w.clamp(0, 65535))
            elif t == T.MIX:
                m = cp[3]
                err = ((y * 32767 - L[SQ_OFF + p[i] + 2048]) * cp[4]) >> 4
                cols = (lay.off32[i] + self.cxt[i][:, None]
                        + torch.arange(m, device=self.dev))
                w = self.a32[self.ar[:, None], cols].long()
                x = torch.stack(p[cp[2]: cp[2] + m], 1)
                w = (w + ((err[:, None] * x + (1 << 12)) >> 13)).clamp(
                    -(1 << 19), (1 << 19) - 1)
                self.a32[self.ar[:, None], cols] = w.to(torch.int32)
            elif t == T.ISSE:
                err = y * 32767 - L[SQ_OFF + p[i] + 2048]
                j = lay.off32[i] + self.cxt[i] * 2
                w0 = (self.g32s(j) + ((err * p[cp[2]] + (1 << 12)) >> 13)
                      ).clamp(-(1 << 19), (1 << 19) - 1)
                w1 = (self.g32s(j + 1) + ((err + 16) >> 5)).clamp(
                    -(1 << 19), (1 << 19) - 1)
                self.s32(j, w0)
                self.s32(j + 1, w1)
                self.s8(lay.off8[i] + self.row[i] + hm4,
                        L[SNS_OFF + self.cxt[i] * 4 + y])
            elif t == T.SSE:
                self.train(lay.off32[i] + (self.cxt[i] & ((32 << cp[1]) - 1)),
                           y, cp[4] * 4)
        # update_tail
        self.c8 = self.c8 * 2 + y
        if phase == 7:
            self.run_hcomp()
            self.hmap4 = torch.ones_like(self.hmap4)
            self.c8 = torch.ones_like(self.c8)
        elif phase == 3:
            self.hmap4 = (self.hmap4 & 15) << 5 | y << 4 | 1
        else:
            self.hmap4 = (self.hmap4 & 0x1F0) | (((self.hmap4 & 15) * 2 + y)
                                                 & 15)

    def update_match(self, i: int, cp, phase: int, y: torch.Tensor) -> None:
        lay = self.lay
        mask = (1 << cp[2]) - 1
        cmmask = (1 << cp[1]) - 1
        off8 = lay.off8[i]
        a = torch.where(self.mc[i] != y, 0, self.ma[i])
        j = off8 + (self.ml[i] & mask)
        self.s8(j, self.g8(j) * 2 + y)
        if phase == 7:
            ml = (self.ml[i] + 1) & mask
            hidx = lay.off32[i] + (self.h[i] & cmmask)
            zero = a == 0
            mb = torch.where(zero, (ml - self.g32u(hidx)) & _M32, self.mb[i])
            run = torch.zeros_like(a)
            act = zero & ((mb & mask) != 0)
            while bool(act.any()):
                b1 = self.g8(off8 + ((ml - run - 1) & mask))
                b2 = self.g8(off8 + ((ml - run - mb - 1) & mask))
                act = act & (run < 255) & (b1 == b2)
                run = run + act.long()
            a = torch.where(zero, run, torch.where(a < 255, a + 1, a))
            self.s32(hidx, ml)
            self.ml[i] = ml
            self.mb[i] = mb
        self.ma[i] = a

    def run_hcomp(self) -> None:
        if self.fh is not None:
            self.win, self.cc, self.h = self.fh.run_columns(
                self.win, self.cc, self.h, self.c8 - 256)
            return
        byte = (self.c8 - 256).tolist()
        act = self.active.tolist()
        bad = []
        rows = []
        for k, vm in enumerate(self.vms):
            if act[k]:
                try:
                    vm.run(byte[k])
                except (ZPAQLRuntimeError, IndexError):
                    bad.append(k)
            rows.append([int(vm.h[i & vm.hmask])
                         for i in range(self.model.n)])
        if bad:
            mask = torch.zeros_like(self.active)
            mask[bad] = True
            self.fail(mask, ST_ZPAQL)
        h = torch.tensor(rows, dtype=torch.int64, device=self.dev)
        self.h = list(h.unbind(1))
