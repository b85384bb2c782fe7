"""HCOMP bytecode -> straight-line code: the per-model HCOMP specialiser.

Ports ``zpaqfranz_tpu/ops/hcomp_fast.py`` (``_Interp``, ``FastHcomp``,
``try_compile``). The per-byte context computation of every standard model
is a pure function of a short window of recent bytes, the position counter
C and the component contexts H[0..n). A symbolic execution of the bytecode
turns it into straight-line integer code: registers become symbolic values,
M reads at c+k become reads of a rolling window of the last 32 bytes, H
becomes n columns at compile-time-constant D, and structured if/else (JT/JF
over a forward JMP, what the method compiler emits for the word models)
becomes selects.

One executor, two value domains:

- ``int64`` tensors masked to 32 bits, one entry per lane (CPU ``uint32``
  has no shifts): ``FastHcomp.run``, the plain version, which the plain CM
  coders (``cm_model.PlainModel``) run;
- C++ expression strings: ``FastHcomp.cuda_source()``, one straight-line
  function per program (``struct HcompFast``), which ``ops/build.py``
  compiles into the CM lane kernels in place of their ZPAQL interpreter
  (``csrc/cm_model.cuh`` ``FastStep``).

Supported shape (anything else bails, and the caller runs the interpreter:
a coverage choice, never a correctness one):

- the standard history preamble ``c-- *c=a a+= 255 d=a *d=c`` (push the
  byte, write its last position at H[byte + 255], which no component reads);
- M reads only at c+k for 0 <= k < 32 (the window);
- H reads and writes only at a compile-time-constant D < n;
- forward structured branches; no loops, R registers, OUT, LJ or swap;
  registers left from the previous byte (B, F, and D after the preamble)
  bail when read.

Two guards the reference lacks: H must have at least 512 entries (hh >= 9),
so that the preamble's write at byte + 255 <= 510 never aliases a
component's column, and M must be larger than every window offset the
program reads, so that no window byte has been overwritten in M. With
smaller arrays libzpaq and the interpreter see the aliasing and the
specialised code would not (``native/src/tzpaq.cpp`` guards its own
transcriptions the same way).

Instruction semantics: ``zpaql/vm.py`` (libzpaq's ZPAQL::execute).
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

import torch

from ..zpaql.header import Model

_M32 = 0xFFFFFFFF

# the standard preamble (see module docstring): c-- *c=a a+= 255 d=a *d=c
_PREAMBLE = bytes([18, 104, 135, 255, 88, 114])

_WINDOW = 32          # rolling window width (max c+k offset supported)
#: smallest hh for which the preamble's H write (at most 255 + 255) stays
#: clear of the component columns
MIN_HH = 9


class _Bail(Exception):
    pass


class _Ptr:
    """Pointer value c + off (B or C register tracking the history window)."""

    __slots__ = ("off",)

    def __init__(self, off: int):
        self.off = off


class _Poison:
    """Stale register (value from a previous run); any use bails."""

    __slots__ = ("why",)

    def __init__(self, why: str):
        self.why = why


# ---------------------------------------------------------------------------
# value domains: the executor's arithmetic on per-lane values


class _Tensors:
    """Values are (L,) int64 tensors in [0, 2^32): the plain version."""

    def __init__(self, win: torch.Tensor, c: torch.Tensor):
        self.win = win            # (L, W) int64, column 0 the newest byte
        self.c = c                # (L,) int64, already decremented

    def full(self, v: int):
        return torch.full_like(self.c, v)

    def window(self, k: int):
        return self.win[:, k]

    def ptr(self, off: int):
        return (self.c + off) & _M32

    def binary(self, op: str, a, b):
        if op == "+":
            return (a + b) & _M32
        if op == "-":
            return (a - b) & _M32
        if op == "*":                 # 16-bit halves: no int64 overflow
            lo = a * (b & 0xFFFF)
            hi = ((a * (b >> 16)) & 0xFFFF) << 16
            return (lo + hi) & _M32
        if op in ("/", "%"):
            safe = torch.where(b == 0, 1, b)
            q = a // safe if op == "/" else a % safe
            return torch.where(b == 0, 0, q)
        if op == "&":
            return a & b
        if op == "&~":
            return a & (~b & _M32)
        if op == "|":
            return a | b
        if op == "^":
            return a ^ b
        if op == "<<":
            return (a << (b & 31)) & _M32
        if op == ">>":
            return a >> (b & 31)
        if op == "==":
            return (a == b).long()
        if op == "<":
            return (a < b).long()
        return (a > b).long()           # ">"

    def invert(self, a):
        return ~a & _M32

    def fires(self, f, jt: bool):
        return f != 0 if jt else f == 0

    def select(self, fire, t, f):
        return torch.where(fire, t, f)


class _Code:
    """Values are C++ expressions (names of ``const u32`` temporaries or
    literals); every operation appends one statement to ``lines``."""

    _OPS = {"+": "{a} + {b}", "-": "{a} - {b}", "*": "{a} * {b}",
            "/": "{b} ? {a} / {b} : 0u", "%": "{b} ? {a} % {b} : 0u",
            "&": "{a} & {b}", "&~": "{a} & ~{b}", "|": "{a} | {b}",
            "^": "{a} ^ {b}", "<<": "{a} << ({b} & 31u)",
            ">>": "{a} >> ({b} & 31u)", "==": "u32({a} == {b})",
            "<": "u32({a} < {b})", ">": "u32({a} > {b})"}

    def __init__(self):
        self.lines: List[str] = []
        self.count = 0
        self.max_off = -1         # largest window offset read
        self._win: Dict[int, str] = {}
        #: statements between a temporary and the byte's push (0: loads)
        self.depth: Dict[str, int] = {}

    def temp(self, expr: str, kind: str = "u32", depth: int = 0) -> str:
        name = f"t{self.count}"
        self.count += 1
        self.lines.append(f"const {kind} {name} = {expr};")
        self.depth[name] = max([depth] + [
            self.depth[t] + 1 for t in re.findall(r"\bt\d+\b", expr)])
        return name

    def full(self, v: int) -> str:
        return f"{v}u"

    def window(self, k: int) -> str:
        if k not in self._win:
            self.max_off = max(self.max_off, k)
            self._win[k] = self.temp(
                f"(w[{k >> 2}] >> {8 * (k & 3)}) & 255u", depth=2)
        return self._win[k]

    def ptr(self, off: int) -> str:
        return self.temp(f"c + {off}u")

    def binary(self, op: str, a: str, b: str) -> str:
        return self.temp(self._OPS[op].format(a=a, b=b))

    def invert(self, a: str) -> str:
        return self.temp(f"~{a}")

    def fires(self, f: str, jt: bool) -> str:
        return self.temp(f"{f} {'!=' if jt else '=='} 0u", "bool")

    def select(self, fire: str, t: str, f: str) -> str:
        return self.temp(f"{fire} ? {t} : {f}")


# ---------------------------------------------------------------------------
# the executor


class _Interp:
    """One symbolic execution of the bytecode over value domain ``ops``."""

    def __init__(self, code: bytes, n: int, ops, h_cols, a0):
        self.code = code
        self.n = n
        self.ops = ops
        self.h = list(h_cols)     # n column values
        # regs after the preamble: A = byte + 255, D = per-lane (poisoned
        # until reassigned), B/F stale from the previous run
        self.A: object = a0
        self.B: object = _Poison("stale B")
        self.D: object = _Poison("per-lane D after preamble")
        self.F: object = _Poison("stale F")

    # ---- value helpers --------------------------------------------------
    def _vec(self, v):
        if isinstance(v, _Poison):
            raise _Bail(v.why)
        if isinstance(v, _Ptr):
            if not 0 <= v.off <= _M32:
                raise _Bail("pointer offset outside 32 bits")
            return self.ops.ptr(v.off)
        if isinstance(v, int):
            if not 0 <= v <= _M32:
                raise _Bail("constant outside 32 bits")
            return self.ops.full(v)
        return v

    def _deref_ptr(self, p):
        """M[p] for p = c + k  ->  window column k."""
        if not isinstance(p, _Ptr):
            raise _Bail("M access at non-window address")
        if not (0 <= p.off < _WINDOW):
            raise _Bail(f"window offset {p.off} out of range")
        return self.ops.window(p.off)

    def _h_col(self, d) -> int:
        if not isinstance(d, int):
            raise _Bail("H access at non-constant D")
        if not (0 <= d < self.n):
            raise _Bail(f"H index {d} outside components")
        return d

    # sss operand value (op & 7); 7 = immediate
    def _src(self, sss: int, arg: int):
        if sss == 0:
            return self._vec(self.A)
        if sss == 1:
            return self._vec(self.B)
        if sss == 2:
            return self._vec(_Ptr(0))
        if sss == 3:
            return self._vec(self.D)
        if sss == 4:
            return self._deref_ptr(self.B)
        if sss == 5:
            return self._deref_ptr(_Ptr(0))     # *C: window head
        if sss == 6:
            return self.h[self._h_col(self.D)]
        return self.ops.full(arg)

    def _get_dst(self, ddd: int):
        return self._src(ddd, 0)

    def _set_dst(self, ddd: int, val) -> None:
        if ddd == 0:
            self.A = val
        elif ddd == 1:
            self.B = val
        elif ddd == 2:
            raise _Bail("write to C")
        elif ddd == 3:
            self.D = val
        elif ddd in (4, 5):
            raise _Bail("M write outside preamble")
        elif ddd == 6:
            self.h[self._h_col(self.D)] = self._vec(val)
        else:
            raise _Bail("bad destination")

    def _hash(self, a, x):
        """(a + x + 512) * 773"""
        ops = self.ops
        return ops.binary("*", ops.binary("+", ops.binary("+", a, x),
                                          ops.full(512)), ops.full(773))

    # ---- execution ------------------------------------------------------
    def run(self, pc: int, end: int) -> None:
        code = self.code
        while pc < min(end, len(code)):
            op = code[pc]
            arg = code[pc + 1] if pc + 1 < len(code) else 0
            sss, ddd = op & 7, (op >> 3) & 7

            if op == 56:                       # HALT
                if end < len(code):
                    raise _Bail("halt inside a branch arm")
                return
            if op == 0 or op in (57, 255):     # ERROR / OUT / LJ
                raise _Bail(f"opcode {op}")
            if op in (7, 15, 23, 31, 55):      # R registers
                raise _Bail("R register use")
            if op == 59:                       # HASH: a=(a+*b+512)*773
                self.A = self._hash(self._vec(self.A),
                                    self._deref_ptr(self.B))
                pc += 1
                continue
            if op == 60:                       # HASHD: *d=(*d+a+512)*773
                d = self._h_col(self.D)
                self.h[d] = self._hash(self.h[d], self._vec(self.A))
                pc += 1
                continue
            if op in (39, 47, 63):             # JT / JF / JMP
                pc = self._branch(op, arg, pc, end)
                continue
            if op < 56 and (op & 7) < 5:       # unary ops on ddd
                self._unary(ddd, sss)
                pc += 1
                continue
            if 64 <= op < 120:                 # assignment ddd = sss
                if ddd == 1 and sss == 2:      # b=c: keep pointerness
                    self.B = _Ptr(0)
                elif sss == 7:
                    self._set_dst(ddd, int(arg))
                else:
                    self._set_dst(ddd, self._src(sss, arg))
                pc += 2 if sss == 7 else 1
                continue
            if 128 <= op < 240:                # binary ALU / comparisons
                self._binary((op >> 3) & 15, self._src(sss, arg))
                pc += 2 if sss == 7 else 1
                continue
            raise _Bail(f"unsupported opcode {op}")
        if end >= len(code):
            raise _Bail("ran off code end")

    def _unary(self, ddd: int, xxx: int) -> None:
        if xxx == 0:                           # swap with A
            raise _Bail("swap")
        if xxx == 4:                           # =0
            self._set_dst(ddd, 0)
            return
        if ddd == 1 and isinstance(self.B, _Ptr):   # b++ / b-- keep pointer
            if xxx == 1:
                self.B = _Ptr(self.B.off + 1)
                return
            if xxx == 2:
                self.B = _Ptr(self.B.off - 1)
                return
        if ddd == 3 and isinstance(self.D, int):    # d++ / d-- stay constant
            if xxx == 1:
                self.D = self.D + 1
                return
            if xxx == 2:
                self.D = self.D - 1
                return
        cur = self._get_dst(ddd)
        ops = self.ops
        if xxx == 1:
            self._set_dst(ddd, ops.binary("+", cur, ops.full(1)))
        elif xxx == 2:
            self._set_dst(ddd, ops.binary("-", cur, ops.full(1)))
        elif xxx == 3:
            self._set_dst(ddd, ops.invert(cur))
        else:
            raise _Bail("bad unary")

    _ALU = ("+", "-", "*", "/", "%", "&", "&~", "|", "^", "<<", ">>")

    def _binary(self, xxxx: int, src) -> None:
        a = self._vec(self.A)
        if xxxx < 11:
            self.A = self.ops.binary(self._ALU[xxxx], a, src)
        elif xxxx < 14:
            self.F = self.ops.binary(("==", "<", ">")[xxxx - 11], a, src)
        else:
            raise _Bail("bad binary")

    def _branch(self, op: int, arg: int, pc: int, end: int) -> int:
        rel = ((arg + 128) & 255) - 127
        if op == 63:                           # unconditional JMP
            tgt = pc + 1 + rel
            if tgt <= pc:
                raise _Bail("backward jump")
            return tgt
        if rel <= 0:
            raise _Bail("backward conditional jump")
        taken_tgt = pc + 1 + rel
        # JT: jump when F; JF: jump when !F ('taken' wins where it fires)
        fire = self.ops.fires(self._vec(self.F), op == 39)
        # Layout produced by structured compilers: fall-through arm
        # [pc+2, taken_tgt) possibly ending in 'jmp join' (else present);
        # taken arm [taken_tgt, join).
        fall_end = taken_tgt
        join = taken_tgt
        # walk instruction starts to find the last one before taken_tgt
        j = pc + 2
        last_start = None
        while j < taken_tgt:
            last_start = j
            o = self.code[j]
            j += 3 if o == 255 else (2 if (o & 7) == 7 else 1)
        if j != taken_tgt:
            raise _Bail("branch arm not instruction-aligned")
        if last_start is not None and self.code[last_start] == 63:
            r2 = ((self.code[last_start + 1] + 128) & 255) - 127
            t2 = last_start + 1 + r2
            if t2 > taken_tgt:
                fall_end = last_start
                join = t2

        snap = (self.A, self.B, self.D, self.F, list(self.h))
        self.run(pc + 2, fall_end)             # fall-through arm
        fall = (self.A, self.B, self.D, self.F, list(self.h))
        self.A, self.B, self.D, self.F = snap[:4]
        self.h = list(snap[4])
        self.run(taken_tgt, join)              # taken arm
        take = (self.A, self.B, self.D, self.F, list(self.h))

        def merge(tv, fv):
            if tv is fv:
                return tv
            if isinstance(tv, int) and isinstance(fv, int) and tv == fv:
                return tv
            if isinstance(tv, _Ptr) and isinstance(fv, _Ptr) \
                    and tv.off == fv.off:
                return tv
            if isinstance(tv, (_Poison, _Ptr)) or isinstance(
                    fv, (_Poison, _Ptr)):
                return _Poison("divergent pointer/poison")
            return self.ops.select(fire, self._vec(tv), self._vec(fv))

        self.A = merge(take[0], fall[0])
        self.B = merge(take[1], fall[1])
        self.D = merge(take[2], fall[2])
        self.F = merge(take[3], fall[3])
        self.h = [merge(t, f) for t, f in zip(take[4], fall[4])]
        return join


# ---------------------------------------------------------------------------


class FastHcomp:
    """Specialised per-byte context updater for one model.

    State dict (all leading dim L, ``int64``): ``win`` (L, 32) rolling
    history (``win[:, 0]`` = current byte), ``hn`` (L, n) component
    contexts, ``cc`` (L,) the C position counter. Construction runs the
    executor once over C++ expressions, so every bail fires here."""

    def __init__(self, model: Model):
        if model.n == 0 or not model.hcomp.startswith(_PREAMBLE):
            raise _Bail("no components / nonstandard preamble")
        if model.hh < MIN_HH:
            raise _Bail(f"H of 2^{model.hh} entries: the preamble's write "
                        f"may alias a component column")
        self.model = model
        self.n = model.n
        self._source = self._generate()

    def init_state(self, L: int, device="cpu") -> Dict[str, torch.Tensor]:
        return {
            "win": torch.zeros((L, _WINDOW), dtype=torch.int64,
                               device=device),
            "hn": torch.zeros((L, self.n), dtype=torch.int64, device=device),
            "cc": torch.zeros(L, dtype=torch.int64, device=device),
        }

    def run_columns(self, win: torch.Tensor, cc: torch.Tensor,
                    h_cols: List[torch.Tensor], byte: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor,
                               List[torch.Tensor]]:
        """Advance one byte (L,) per lane: the window with the byte pushed,
        C decremented and the n new context columns."""
        byte = byte.long() & 255
        win = torch.cat([byte[:, None], win[:, :-1]], dim=1)
        cc = (cc - 1) & _M32
        it = _Interp(self.model.hcomp, self.n, _Tensors(win, cc), h_cols,
                     byte + 255)
        it.run(len(_PREAMBLE), len(self.model.hcomp))
        return win, cc, [it._vec(h) for h in it.h]

    def run(self, st: Dict[str, torch.Tensor], byte: torch.Tensor
            ) -> Dict[str, torch.Tensor]:
        """Advance contexts with the next byte (L,) per lane."""
        win, cc, cols = self.run_columns(st["win"], st["cc"],
                                         list(st["hn"].unbind(1)), byte)
        return {"win": win, "hn": torch.stack(cols, dim=1), "cc": cc}

    # ---- the code generator ---------------------------------------------
    def _generate(self) -> str:
        code = _Code()
        cols = [code.temp(f"h[{i}]") for i in range(self.n)]
        it = _Interp(self.model.hcomp, self.n, code, cols,
                     code.temp("byte + 255u", depth=1))
        it.run(len(_PREAMBLE), len(self.model.hcomp))
        if code.max_off >= 1 << self.model.hm:
            raise _Bail(f"window offset {code.max_off} outside M of "
                        f"2^{self.model.hm} bytes")
        stores = [f"h[{i}] = {it._vec(v)};" for i, v in enumerate(it.h)
                  if v is not cols[i]]
        words = max(code.max_off, 0) // 4 + 1
        #: integer operations a byte (the window's push, C, every
        #: statement but the loads of h) and the longest chain of dependent
        #: ones, ending in a store of h: for the kernels' bound
        self.ops = words + 1 + code.count - self.n
        self.chain = 1 + max(code.depth.values())
        push = [f"w[{k}] = (w[{k}] << 8) | (w[{k - 1}] >> 24);"
                for k in range(words - 1, 0, -1)]
        body = push + ["w[0] = (w[0] << 8) | byte;", "c -= 1u;"] \
            + code.lines + stores
        return "\n".join([
            "// HCOMP specialised by zpaqfranz_tpu_torch/ops/hcomp_fast.py",
            f"// from {len(self.model.hcomp)} bytes of bytecode, "
            f"{self.n} components:",
            f"// {self.model.hcomp.hex()}",
            "#pragma once",
            "#include <stdint.h>",
            "",
            "// One byte: push it into the window w (byte k of the window,",
            "// the byte of k steps ago, at bits 8 * (k % 4) of w[k / 4]),",
            "// decrement C and compute the component contexts h[0..n).",
            "struct HcompFast {",
            f"  static constexpr int words = {words};",
            f"  static constexpr int n = {self.n};",
            "  __device__ __forceinline__ static void run(uint32_t* w, "
            "uint32_t& c,",
            "                                             uint32_t* h, "
            "uint32_t byte) {",
            "    typedef uint32_t u32;",
        ] + [f"    {line}" for line in body] + ["  }", "};", ""])

    def cuda_source(self) -> str:
        """The program as a straight-line C++ function, ``struct
        HcompFast`` (``words`` window words, ``run(w, c, h, byte)``)."""
        return self._source


_CACHE: Dict[Tuple, Optional[FastHcomp]] = {}


def try_compile(model: Model) -> Optional[FastHcomp]:
    """Build a FastHcomp for the model, or None if the bytecode uses
    features outside the specialisable subset (the caller runs the ZPAQL
    interpreter: a coverage choice, never a correctness one)."""
    key = (model.hcomp, model.n, model.hh, model.hm)
    if key not in _CACHE:
        try:
            _CACHE[key] = FastHcomp(model)
        except Exception:
            _CACHE[key] = None
    return _CACHE[key]
