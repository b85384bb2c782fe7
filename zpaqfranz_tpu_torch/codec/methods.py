"""Method strings -> compression models (the reference's makeConfig).

Implements the documented method-string grammar (reference spec:
reference ZSFX/libzpaq.h:86-283):

    {0..5,x,s}[N1[{.,}N2]...] [letter[args]...]

A leading digit 0..5 selects a compression level preset; "x" describes the
exact method: its numeric arguments select the preprocessor (N2: 0=none,
1=packed LZ77, 2=byte LZ77, 3=BWT, +4=E8E9 first) and the remaining letter
commands build the context-mixing component graph:

    c = CM/ICM   i = ISSE chain   a = MATCH   w = word model
    m = MIX      s = SSE          t = MIX2

The generated HCOMP context code reproduces the reference generator's
instruction patterns byte-for-byte where observable (validated against the
-m5 model embedded in the golden archive reference AUTOTEST/
sha256.zpaq: 23 components, 170-byte HCOMP — see tests/test_methods.py).

The implementation is a clean-room reconstruction: the reference's makeConfig
lives only in the absent zpaqfranz.cpp; behavior here follows the libzpaq.h
doc comment plus the golden archive's embedded model.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from ..zpaql.compiler import compile_config
from ..zpaql.header import Model


#: a model with every component type (CONST, CM, ICM, ISSE, MATCH, AVG,
#: MIX2, MIX, SSE) and an HCOMP program for each context
ALL_COMPONENTS_CFG = """
comp 9 16 0 0 10
  0 const 160
  1 cm 9 4
  2 icm 5
  3 isse 5 2
  4 match 8 8
  5 avg 3 4 128
  6 mix2 4 5 1 24 255
  7 mix 4 0 6 24 255
  8 sse 5 7 32 255
  9 mix2 4 8 7 24 255
hcomp
  c-- *c=a a+= 255 d=a *d=c
  d= 1 *d=0 b=c a=*b hashd
  d= 2 *d=0 a=*b hashd
  d= 3 b=c a=*d d++ hash *d=a
  d= 4 a=*d a*= 24 a+=*c a++ *d=a
  d= 6 *d=0 b=c a=*b hashd
  d= 7 *d=0 a=c a&= 3 hashd
  d= 8 *d=0 a=*b hashd
  d= 9 *d=0
  halt
post 0 end
"""


class MethodError(ValueError):
    pass


@dataclass
class PreSpec:
    """Preprocessor selection decoded from the x-command arguments."""

    transform: int = 0        # 0 none, 1 packed LZ77, 2 byte LZ77, 3 BWT
    e8e9: bool = False
    block_bits: int = 24      # log2 max block size in bytes (N1 + 20)
    min_match: int = 0        # N3
    min_match2: int = 0       # N4 secondary context order (0 = off)
    depth_log: int = 0        # N5 log search depth
    hash_bits: int = 0        # N6 log hash table size (N1+21 = suffix array)
    lookahead: int = 0        # N7
    chain: bool = False       # scored parse with the hash-chain finder
                              # (level-2 preset: SA-class candidates at
                              # hash-build cost, native lz77_scored_core)

    @property
    def use_sa(self) -> bool:
        return self.hash_bits == self.block_bits + 1  # N6 == N1 + 21


def parse_method(method: str) -> List[Tuple[str, List[int]]]:
    """Split a method string into (command letter, [numeric args])."""
    out = []
    for m in re.finditer(r"([a-zA-Z])((?:-?\d+[.,]?)*)", method):
        letter = m.group(1)
        nums = [int(x) for x in re.findall(r"-?\d+", m.group(2))]
        out.append((letter, nums))
    if not out or method[0].isdigit():
        nums = [int(x) for x in re.findall(r"-?\d+", method)]
        if method[0].isdigit():
            return [(method[0], nums[1:] if nums else [])] + out
    return out


def _arg(args: List[int], i: int, default: int = 0) -> int:
    return args[i] if i < len(args) and args[i] is not None else default


class _ModelBuilder:
    """Accumulates COMP entries + HCOMP config text for the letter commands.

    Component sizing policy (table bytes ~= block size, per the spec's
    "Most components use no more memory than the block size"): ICM/ISSE
    tables are 64*2^s bytes so the cap is membits-6; CM tables 4*2^s so
    membits-2. Per-component bits grow with modeled context bytes
    (validated against the golden -m5 model's sizes).
    """

    def __init__(self, membits: int):
        self.membits = membits
        self.comps: List[str] = []        # "icm 18" etc
        self.hcomp: List[str] = []        # config-language tokens
        self.bytes_modeled: List[float] = []   # context bytes per component

    @property
    def n(self) -> int:
        return len(self.comps)

    def _cap_icm(self) -> int:
        return max(5, self.membits - 6)

    def _emit(self, *toks: str) -> None:
        self.hcomp.extend(toks)

    # ---- context-byte walkers -------------------------------------------
    def _emit_masked_bytes(self, masks: List[int], target_d: int) -> float:
        """b=c; hashd each masked history byte into H[target_d]."""
        nbytes = 0.0
        self._emit("b=c")
        for j, m in enumerate(masks):
            if j > 0:
                self._emit("b++")
            if m == 0:
                continue
            self._emit("a=*b")
            if m != 255:
                self._emit(f"a&= {m}")
                nbytes += bin(m).count("1") / 8.0
            else:
                nbytes += 1.0
            self._emit("hashd")
        return nbytes

    # ---- letter commands ------------------------------------------------
    def cmd_c(self, args: List[int]) -> None:
        n1 = _arg(args, 0)          # 0 = ICM, 1..256 = CM limit, +1000 halves
        halve = 0
        while n1 >= 1000:
            halve += 1
            n1 -= 1000
        n2 = _arg(args, 1)          # counter / distance-to-byte context
        masks = args[2:]            # order 0.. context byte masks
        i = self.n
        ctx_bits = 0.0
        self._emit(f"d= {i}", "*d=0")
        if 1 <= n2 <= 255:          # offset mod n2
            self._emit("a=c")
            if n2 & (n2 - 1) == 0:
                self._emit(f"a&= {n2 - 1}")
            else:
                self._emit(f"a%= {n2}")
            self._emit("hashd")
            ctx_bits += max(1, n2.bit_length() - 1)  # floor(log2(n2))
        elif n2 >= 1000:            # distance to last byte value n2-1000
            v = n2 - 1000
            self._emit(f"a= {v & 255}", "a+= 255", "d=a", "a=*d")
            self._emit("a!", "a++", "a+=c")           # a = c - lastpos
            self._emit(f"d= {i}", "hashd")
            ctx_bits += 8
        if any(masks):
            ctx_bits += 8 * self._emit_masked_bytes(masks, i)
        if n1 == 0:
            size = min(self._cap_icm(), max(5, 4 + int(ctx_bits))) - halve
            self.comps.append(f"icm {max(size, 1)}")
        else:
            size = min(self.membits - 2, 9 + int(ctx_bits)) - halve
            self.comps.append(f"cm {max(size, 1)} {min(n1, 256) - 1}")
        # chain sizing counts whole context items (a counter or any masked
        # byte each count 1 — validated against the golden -m5 ISSE sizes)
        n_items = (1 if n2 else 0) + sum(1 for m in masks if m)
        self.bytes_modeled.append(float(n_items))

    def cmd_i(self, args: List[int]) -> None:
        """ISSE chain: increments relative to the previous component."""
        if self.n == 0:
            raise MethodError("'i' needs a preceding component")
        base = self.n - 1
        order = self.bytes_modeled[base]
        self._emit(f"d= {base}", "b=c", "a=*d")
        for k, inc in enumerate(args):
            last = k == len(args) - 1
            self._emit("d++")
            for j in range(inc):
                self._emit("hash")
                if not (last and j == inc - 1):
                    self._emit("b++")
            self._emit("*d=a")
            order += inc
            size = min(self._cap_icm(), int(5 + order * 6))
            self.comps.append(f"isse {size} {self.n - 1}")
            self.bytes_modeled.append(order)

    def cmd_a(self, args: List[int]) -> None:
        mult = _arg(args, 0, 24)
        bufhalve = _arg(args, 1)
        hashhalve = _arg(args, 2)
        i = self.n
        self._emit(f"d= {i}", "a=*d", f"a*= {mult}", "a+=*c", "a++", "*d=a")
        cmbits = max(4, self.membits - 2 - hashhalve)
        bufbits = max(4, self.membits - bufhalve)
        self.comps.append(f"match {cmbits} {bufbits}")
        self.bytes_modeled.append(mult / 8.0)

    def cmd_w(self, args: List[int]) -> None:
        length = _arg(args, 0, 1)
        lo = _arg(args, 1, 65)
        rng = _arg(args, 2, 26)
        msk = _arg(args, 3, 223)
        mult = _arg(args, 4, 20)
        halve = _arg(args, 5, 0)
        i = self.n
        self._emit("a=*c", f"a&= {msk}", f"a-= {lo & 255}", "a&= 255",
                   f"a< {rng}", "if",
                   f"d= {i}", "a=*d", f"a*= {mult}", "a+=*c", "a++", "*d=a",
                   "else", f"d= {i}", "*d=0", "endif")
        size = self._cap_icm() - halve
        self.comps.append(f"icm {size}")
        self.bytes_modeled.append(8.0)
        if length > 1:
            # ISSE chain over the word context + following bytes
            self._emit(f"d= {i}", "b=c", "a=*d")
            for k in range(length - 1):
                last = k == length - 2
                self._emit("d++", "hash")
                if not last:
                    self._emit("b++")
                self._emit("*d=a")
                self.comps.append(f"isse {size} {self.n - 1}")
                self.bytes_modeled.append(8.0 + k + 1)

    def _emit_high_context(self, bits: int, i: int) -> None:
        """H[i] = top (bits-8) context bits above c8's 8, shifted left 8."""
        upper = bits - 8
        if upper <= 0:
            return                      # H[i] stays 0; c8 supplies the bits
        nb = (upper + 7) // 8
        self._emit(f"d= {i}", "*d=0", "b=c", "a=0")
        for j in range(nb):
            self._emit("a<<= 8", "a+=*b")
            if j < nb - 1:
                self._emit("b++")
        if upper % 8:
            self._emit(f"a>>= {8 - upper % 8}")
        self._emit("a<<= 8", "*d=a")

    def cmd_m(self, args: List[int]) -> None:
        bits = _arg(args, 0, 8)
        rate = _arg(args, 1, 24)
        i = self.n
        self._emit_high_context(bits, i)
        self.comps.append(f"mix {bits} 0 {i} {rate} 255")
        self.bytes_modeled.append(bits / 8.0)

    def cmd_t(self, args: List[int]) -> None:
        bits = _arg(args, 0, 8)
        rate = _arg(args, 1, 24)
        i = self.n
        if i < 2:
            raise MethodError("'t' needs two preceding components")
        self._emit_high_context(bits, i)
        self.comps.append(f"mix2 {bits} {i - 1} {i - 2} {rate} 255")
        self.bytes_modeled.append(bits / 8.0)

    def cmd_s(self, args: List[int]) -> None:
        bits = _arg(args, 0, 8)
        start = _arg(args, 1, 32)
        limit = _arg(args, 2, 255)
        i = self.n
        if i < 1:
            raise MethodError("'s' needs a preceding component")
        self._emit_high_context(bits, i)
        self.comps.append(f"sse {bits} {i - 1} {start} {limit}")
        self.bytes_modeled.append(bits / 8.0)

    # ---------------------------------------------------------------------
    def build_config(self, ph: int = 0, pm: int = 0,
                     pcomp_body: Optional[str] = None) -> str:
        n = self.n
        hh, hm = (9, 16) if n else (0, 0)
        lines = [f"comp {hh} {hm} {ph} {pm} {n}"]
        for i, c in enumerate(self.comps):
            lines.append(f"  {i} {c}")
        body = ["hcomp"]
        if n:
            # rotating history buffer + last-position-of-byte table
            body += ["c--", "*c=a", "a+= 255", "d=a", "*d=c"]
            body += self.hcomp
        body.append("halt")
        lines.append(" ".join(body))
        if pcomp_body is not None:
            lines.append("pcomp ;")
            lines.append(pcomp_body)
            lines.append("end")
        else:
            lines.append("post 0 end")
        return "\n".join(lines)


# ---- E8E9 output stage -----------------------------------------------------
#
# For composite transforms (N2 = 5/6/7: E8E9 applied BEFORE LZ77/BWT on
# encode), the postprocessor must run the LZ77/BWT inverse first and feed its
# output through an E8E9 inverse. The stage keeps a 5-byte delay window in
# the TOP cells of H (indices -8..-2 mod 2^ph — D wraps, so negative indexes
# address the high end without big immediates): H[-8..-4] = window w0..w4,
# H[-3] = pending count, H[-2] = absolute output position of w0. When the
# window fills, {E8|E9 xx xx xx 00|FF} rewrites the middle 3 bytes by
# subtracting the position (the forward transform added it — reference
# libzpaq.cpp:6117-6126, scanned backward; the forward-with-delay inverse is
# exact because each byte is pattern-checked exactly once as w0, in the
# mirror order of the backward encode). The stage must NOT rewrite the LZ77
# ring M: matches copy TRANSFORMED bytes (the encoder matched transformed
# data), so the window is a separate buffer.
#
# Contract: byte to emit in R10; preserves B (and the M ring); saves and
# restores C and D via R30/R31; clobbers A.

_E8E9_STAGE = """
    a=c r=a 30 a=d r=a 31 (save C, D)
    a=0 a-- a-- a-- d=a a=*d c=a (c = pending count, cell H[-3])
    a++ *d=a
    a=c a-= 8 d=a a=r 10 *d=a (window[count] = byte)
    a=c a== 4 ifl (5 pending: pattern-check, emit w0, slide)
      a=0 a-= 8 d=a a=*d
      a&= 254 a== 232 ifl (w0 is E8/E9)
        a=0 a-= 4 d=a a=*d
        a++ a&= 254 a== 0 if (w4 is 00/FF: un-add the position)
          a=0 a-= 5 d=a a=*d c=a
          a=0 a-= 6 d=a a=c a<<= 8 a+=*d c=a
          a=0 a-- a-= 6 d=a a=c a<<= 8 a+=*d (a = w3<<16|w2<<8|w1)
          c=a a=0 a-- a-- d=a a=c a-=*d (minus abspos H[-2])
          c=a a=0 a-- a-= 6 d=a a=c a&= 255 *d=a
          a=0 a-= 6 d=a a=c a>>= 8 a&= 255 *d=a
          a=0 a-= 5 d=a a=c a>>= 16 a&= 255 *d=a
        endif
      endif
      a=0 a-= 8 d=a a=*d out
      a=0 a-- a-= 6 d=a a=*d c=a a=0 a-= 8 d=a a=c *d=a
      a=0 a-= 6 d=a a=*d c=a a=0 a-- a-= 6 d=a a=c *d=a
      a=0 a-= 5 d=a a=*d c=a a=0 a-= 6 d=a a=c *d=a
      a=0 a-= 4 d=a a=*d c=a a=0 a-= 5 d=a a=c *d=a
      a=0 a-- a-- a-- d=a a= 4 *d=a
      a=0 a-- a-- d=a a=*d a++ *d=a (abspos++)
    endif
    a=r 30 c=a a=r 31 d=a (restore C, D)
"""

# Segment-end flush: the <=4 pending window bytes can never start a pattern
# (a pattern needs 5 bytes), so they are emitted raw; state resets for the
# next segment. Clobbers C and D (callers are at end-of-segment).
_E8E9_FLUSH = """
    a=0 a-- a-- a-- d=a a=*d c=a
    a=c a== 0 ifnot
      a=0 a-= 8 d=a
      do
        a=*d out d++ c--
        a=c a> 0 while
    endif
    a=0 a-- a-- a-- d=a a=0 *d=a
    a=0 a-- a-- d=a a=0 *d=a
"""


def _emit(e8e9: bool) -> str:
    """Emit-byte fragment: byte in A (already stored to *b by the caller
    where the ring matters). Plain ``out`` or the E8E9 stage."""
    return ("r=a 10" + _E8E9_STAGE) if e8e9 else "out"


def lz77_pcomp_source(min_match: int, e8e9: bool = False) -> str:
    """ZPAQL postprocessor inverting the byte-aligned LZ77 stream.

    Stream format (reference libzpaq.cpp:6211-6222): code byte 00xxxxxx =
    x+1 literals follow; yyxxxxxx (y>=1) = y+1 offset bytes MSB-first
    follow, match length x+minMatch, stored offset = off-1.

    Register use (persistent across run() calls within a segment):
      R0 = state (0 code, 1 offset bytes, 2 literals), R1 = offset
      accumulator, R2 = offset bytes remaining, R3 = count, B = output
      ring pointer into M (size 2^pm >= block size).

    With ``e8e9`` (method N2=6), every output byte is routed through the
    E8E9 inverse stage instead of ``out`` — the M ring still receives the
    TRANSFORMED bytes (matches were found on transformed data).
    """
    emit = _emit(e8e9)
    flush = _E8E9_FLUSH if e8e9 else ""
    return f"""
  a> 255 if {flush} halt endif (segment end)
  c=a (save the input byte)
  a=r 0
  a== 1 ifl (collect an offset byte)
    a=r 1 a<<= 8 a+=c r=a 1
    a=r 2 a-- r=a 2
    a== 0 ifl (offset complete: copy the match)
      a=r 1 a++ c=a (c = distance)
      a=b a-=c c=a (c = source = b - distance)
      d=r 3
      do
        a=*c *b=a {emit} b++ c++ d--
        a=d a> 0 while
      a=0 r=a 0
    endif
    halt
  endif
  a== 2 ifl (literal byte)
    a=c *b=a {emit} b++
    a=r 3 a-- r=a 3
    a== 0 if a=0 r=a 0 endif
    halt
  endif
  (state 0: code byte)
  a=c a< 64 if (literal run of code+1)
    a++ r=a 3
    a= 2 r=a 0
  else (match: (code>>6)+1 offset bytes, length (code&63)+minMatch)
    a=c a>>= 6 a++ r=a 2
    a=c a&= 63 a+= {min_match} r=a 3
    a=0 r=a 1
    a= 1 r=a 0
  endif
  halt"""


def lz77p_pcomp_source(rb: int, e8e9: bool = False) -> str:
    """ZPAQL postprocessor inverting the PACKED (bit-level) LZ77 stream.

    Stream format (reference libzpaq.cpp:6211-6222 comment + write_literal/
    write_match level-1 paths, 6466-6516; bits packed LSB-first per putb
    6172-6180):

      00,gamma(lit),L[lit*8]      literal run (interleaved Elias gamma:
                                  leading 1 implied, each data bit preceded
                                  by a 1 flag, terminated by a 0 flag)
      mm,mmm,gamma(len>>2),ll,r[rb],q[lo]
                                  match of length (gamma<<2|ll), offset
                                  off' = ((1<<lo | q) << rb) | r, real
                                  offset = off' - (1<<rb) + 1, where
                                  lo = 8*mm + mmm - 8

    Multi-bit fields (mm, mmm, ll, r, q, literal bytes) are LSB-first;
    gamma data bits are MSB-first. ``rb`` is baked into the program (it is
    a method parameter, = max(0, block_bits - 24)).

    Bit-serial state machine, states in R0:
      0 mm bit 0          1 mm bit 1         2 mmm (3 bits)
      3 gamma flag        4 gamma data       5 ll (2 bits)
      6 r (rb bits)       7 q (lo bits)      8 literal byte (8 bits)
    R1 = field accumulator, R2 = bits remaining, R3 = bit weight,
    R4 = gamma value, R5 = lo, R6 = mode (0 literal / 1 match),
    R7 = mm, R8 = r, R9 = pending count (literals or match length),
    R12 = shifting input byte, R15 = bit loop counter.
    B = output ring pointer into M (2^pm >= block size).

    State 7 (q) completes via the post-dispatch check (R2 == 0), which also
    handles lo == 0 / rb == 0 zero-width fields. Trailing pad bits (<= 7
    zero bits) can never complete a literal byte, so they emit nothing.
    """
    emit = _emit(e8e9)
    flush = _E8E9_FLUSH if e8e9 else ""
    # generic collect-one-bit step: acc += t*weight; weight *= 2; rem -= 1
    collect = """
      a=r 14 a== 0 ifnot a=r 3 c=a a=r 1 a+=c r=a 1 endif
      a=r 3 c=a a+=c r=a 3
      a=r 2 a-- r=a 2
    """
    off_sub = f"a-= {(1 << rb) - 1}" if rb else ""
    return f"""
  a> 255 if {flush} a=0 r=a 0 b=0 halt endif (segment end: reset)
  r=a 12
  a= 8 r=a 15
  do
    a=r 12 a&= 1 r=a 14 (t = next bit, LSB first)
    a=r 12 a>>= 1 r=a 12
    a=r 0
    a== 8 ifl (literal byte: collect 8 bits)
      {collect}
      a== 0 ifl
        a=r 1 *b=a {emit} b++
        a=r 9 a-- r=a 9
        a== 0 if a=0 r=a 0
        else a=0 r=a 1 a= 8 r=a 2 a= 1 r=a 3 endif
      endif
    elsel
    a== 3 ifl (gamma flag bit)
      a=r 14 a== 1 if a= 4 r=a 0
      else
        a=r 6 a== 0 if (literal count complete)
          a=r 4 r=a 9
          a=0 r=a 1 a= 8 r=a 2 a= 1 r=a 3 a= 8 r=a 0
        else (match: collect ll)
          a=0 r=a 1 a= 2 r=a 2 a= 1 r=a 3 a= 5 r=a 0
        endif
      endif
    elsel
    a== 4 ifl (gamma data bit, MSB first)
      a=r 4 a+=a c=a a=r 14 a+=c r=a 4
      a= 3 r=a 0
    elsel
    a== 0 ifl (mm bit 0)
      a=r 14 r=a 7
      a= 1 r=a 0
    elsel
    a== 1 ifl (mm bit 1)
      a=r 14 a+=a c=a a=r 7 a+=c
      a== 0 if (literal code)
        a=0 r=a 6 a= 1 r=a 4 a= 3 r=a 0
      else
        r=a 7
        a=0 r=a 1 a= 3 r=a 2 a= 1 r=a 3 a= 2 r=a 0
      endif
    elsel
    a== 2 ifl (mmm: 3 bits)
      {collect}
      a== 0 if
        a=r 7 a<<= 3 c=a a=r 1 a+=c a-= 8 r=a 5 (lo)
        a= 1 r=a 6 a= 1 r=a 4 a= 3 r=a 0
      endif
    elsel
    a== 5 ifl (ll: 2 bits)
      {collect}
      a== 0 if
        a=r 4 a<<= 2 c=a a=r 1 a+=c r=a 9 (len)
        a=0 r=a 8
        {"a=0 r=a 1 a= %d r=a 2 a= 1 r=a 3 a= 6 r=a 0" % rb if rb
         else "a=0 r=a 1 a=r 5 r=a 2 a= 1 r=a 3 a= 7 r=a 0"}
      endif
    elsel
    a== 6 ifl (r: rb bits)
      {collect}
      a== 0 if
        a=r 1 r=a 8
        a=0 r=a 1 a=r 5 r=a 2 a= 1 r=a 3 a= 7 r=a 0
      endif
    elsel (state 7: q, lo bits; completion via the post-check)
      {collect}
    endif endif endif endif endif endif endif endif
    a=r 0 a== 7 ifl a=r 2 a== 0 ifl (q complete: copy the match)
      a=r 1 c=a a=r 3 a+=c (q with implied leading 1 = acc + weight)
      a<<= {rb} c=a a=r 8 a+=c (off')
      {off_sub}
      c=a a=b a-=c c=a (c = source = b - off)
      d=r 9
      do
        a=*c *b=a {emit} b++ c++ d--
        a=d a> 0 while
      a=0 r=a 0
    endif endif
    a=r 15 a-- r=a 15
    a> 0 while
  halt"""


# ---- level presets ------------------------------------------------------

def level_method(level: int, block_arg: int = 4, ease: int = 128,
                 dtype: int = 0) -> str:
    """Expand a digit level 0..5 into a full x-method string.

    The exact reference expansions live in the absent zpaqfranz.cpp; these
    presets follow the spec's documented examples (libzpaq.h:100-103,
    156-168, 189, 278) and the golden archive's embedded -m5 model.
    """
    b = block_arg
    e89 = 4 if dtype in (2, 3) else 0
    if level == 0:
        return f"x{b}.0"
    if level == 1:                      # fast packed LZ77, store-coded
        # the spec's "typical good values for fast compression"
        # (libzpaq.h:156-160)
        return f"x{b}.{1 + e89}.5.0.3.22"
    if level == 2:                      # packed LZ77, deep match search,
        # same decode speed as -m1 (libzpaq.h:101). The spec's example is
        # the SA finder ("x4.1.4.0.8.25", libzpaq.h:166-170); our preset
        # reaches the same stream-size class with dual hash chains
        # (h4+h12) at ~6x the encode speed (r5: depth 4 parses 30 vs the
        # SA's 4.9 MB/s, LZ stream within 0.5% of depth 8 — the 12-byte
        # chain already finds the long matches, so shallow h4 probing
        # costs little), so the level-2 preset selects chains; explicit
        # x-methods with N6 = N1+21 still get the true suffix array
        return f"x{b}.{1 + e89}.4.0.3.24"
    if level == 3:                      # BWT + low-order chain
        return f"x{b}.{3 + e89}ci1"
    if level == 4:                      # CM: order chain + match + word
        return f"x{b}.{0 + e89}ci1.1.1.1.2aw2mm16tst"
    if level == 5:                      # max: the golden -m5 structure
        return (f"x{b}.{0 + e89}w2c256ci1.1.1.1.1.1.2a"
                f"c0.2.0.255i1c0.3.0.0.255i1c0.4.0.0.0.255i1mm16ts19t0")
    raise MethodError(f"unknown level {level}")


def bwt_pcomp_source(e8e9: bool = False) -> str:
    """ZPAQL postprocessor inverting the BWT stream.

    Stream (reference libzpaq.cpp:6317-6327): B[0..n] = last column over the
    sorted suffixes with the sentinel row's byte replaced by 255, followed by
    the sentinel row index as 4 LSB-first bytes.  Inverse: counting sort to
    get per-char row bases (row 0 is the sentinel), build the successor
    permutation psi in H[256+row] (psi(LF(i)) = i), then walk n steps from
    row idx emitting B[psi^k(idx)].

    Memory: M buffers the n+5 input bytes (pm = block bits); H holds 256
    counters plus psi (ph = block bits, 4*2^ph bytes) — the documented
    "4 times the block size" BWT decode cost (libzpaq.h:137-141).
    Registers: R1 = n, R2 = idx, R3 = n+1, R4 = walk cursor; B = input
    write pointer during buffering.
    With ``e8e9`` (method N2=7), each walked byte is routed through the
    E8E9 inverse stage (window in H[-8..-2]; H holds 256 + n + 8 live
    cells, which fits because blocks are at most 2^N1 MiB - 4096 bytes).
    """
    emit = _emit(e8e9)
    flush = _E8E9_FLUSH if e8e9 else ""
    return f"""
  a> 255 ifnot *b=a b++ halt endif (buffer one input byte)
  (segment end: b = n+5 total bytes)
  a=b a< 5 if b=0 halt endif
  a=b a-= 5 r=a 1 (n)
  a++ r=a 3 (n+1)
  a=r 1 a+= 4 b=a a=*b (idx, 4 bytes LSB first)
  b-- a<<= 8 a+=*b
  b-- a<<= 8 a+=*b
  b-- a<<= 8 a+=*b
  r=a 2
  d=0 do *d=0 d++ a=d a> 255 until (zero the counters)
  b=0 c=r 3 (count byte occurrences, skipping the sentinel row)
  do
    a=r 2 a==b ifnot d=*b *d++ endif
    b++ a=b a==c until
  c= 1 d=0 (exclusive prefix sums -> per-char first row, sentinel = row 0)
  do
    a=*d *d=c a+=c c=a d++ a=d a> 255 until
  b=0 c=r 3 (build psi: H[256 + base[M[b]]++] = b)
  do
    a=r 2 a==b ifnot
      d=*b
      a=*d a++ *d=a
      a-- a+= 255 a++ d=a
      *d=b
    endif
    b++ a=b a==c until
  a=r 1 a== 0 if b=0 halt endif
  a=r 2 r=a 4 (walk n rows from idx)
  c=r 1
  do
    a=r 4 a+= 255 a++ d=a
    a=*d r=a 4
    b=a a=*b {emit}
    c--
    a=c a> 0 while
  {flush}
  b=0
  halt"""


def e8e9_pcomp_source() -> str:
    """ZPAQL postprocessor inverting the E8E9 x86 transform.

    The encoder scans backward adding the block offset to the 3 middle bytes
    of {E8|E9 xx xx xx 00|FF} (reference libzpaq.cpp:6117-6126); the inverse
    therefore runs forward with a 4-byte delay: each incoming byte is
    buffered in the M ring at C, and once 5 bytes are pending the window at
    B is pattern-checked, rewritten (subtracting B mod 2^24), and its first
    byte emitted. B/C grow monotonically (M indexes mod 2^pm; only the
    5-byte window is live, so pm stays tiny). R5 saves the window base.
    """
    return """
  a> 255 if (segment end: flush the pending tail, reset)
    a=c a==b ifnot
      do a=*b out b++ a=c a==b until
    endif
    b=0 c=0 halt
  endif
  *c=a c++
  a=c a-=b a< 5 if halt endif (window not full yet)
  a=*b a&= 254 a== 232 if (E8/E9 at window start)
    a=b r=a 5
    a+= 4 b=a a=*b (last window byte)
    a++ a&= 254 a== 0 if (00 or FF: rewrite the middle 3 bytes)
      b-- a=*b a<<= 8
      b-- a+=*b a<<= 8
      b-- a+=*b (a = middle 3 bytes, LSB first)
      d=r 5 a-=d (subtract the block offset)
      *b=a a>>= 8 b++ *b=a a>>= 8 b++ *b=a
    endif
    a=r 5 b=a
  endif
  a=*b out b++
  halt"""


_FAST_REGISTERED = False


def register_fast_pcomps() -> None:
    """Teach the native engine this framework's stored PCOMP programs so
    decode runs C++ inverses instead of the per-byte ZPAQL VM.

    The reference's "-m1/-m2 decode as fast as encode" property
    (libzpaq.h:100-103) comes from LZ77 being trivially invertible; the
    archive format however stores the inverse as a ZPAQL program, which an
    interpreter executes at ~MB/s. Recognizing our own emitted bytecode
    restores memcpy-class decode while unknown programs still take the VM
    (the format truth). Registered: packed/byte LZ77 (all rb / common
    min-match values), BWT, E8E9, and the E8E9 composites."""
    global _FAST_REGISTERED
    if _FAST_REGISTERED:
        return
    _FAST_REGISTERED = True
    from .. import native
    from ..zpaql.compiler import compile_config

    def bytecode(body: str) -> bytes:
        cfg = ("comp 0 0 0 0 0\nhcomp\n  halt\npcomp ;\n"
               + body + "\nend\n")
        model, _ = compile_config(cfg)
        return model.pcomp

    for e8 in (False, True):
        for rb in range(0, 8):
            native.register_pcomp(
                bytecode(lz77p_pcomp_source(rb, e8e9=e8)), 1, rb, int(e8))
        for mm in (1, 2, 3, 4, 5, 6, 7, 8, 10, 12, 16, 24, 32, 48, 63):
            native.register_pcomp(
                bytecode(lz77_pcomp_source(mm, e8e9=e8)), 2, mm, int(e8))
        native.register_pcomp(bytecode(bwt_pcomp_source(e8e9=e8)),
                              3, 0, int(e8))
    native.register_pcomp(bytecode(e8e9_pcomp_source()), 4, 0, 0)


def config_file_model(method: str) -> Optional[Tuple[Optional[Model],
                                                     PreSpec]]:
    """ZPAQL config file as a method: ``path[,arg1..,arg9]`` names a .cfg
    source compiled with the config-language compiler (grammar documented
    at libzpaq.h:475-716); $1..$9 substitute the comma arguments. Returns
    None when ``method`` is not a config-file reference.

    Configs that declare an external ``pcomp CMD ;`` preprocessor are
    decode-complete (the PCOMP program is stored in the archive) but
    cannot encode here — running arbitrary preprocessor commands is the
    zpaqd workflow, refused with a clear error."""
    import pathlib
    name = method.split(",")[0]
    if not name or (name[0].isdigit() or name in ("x", "s")):
        return None
    cand = None
    for p in (name, name + ".cfg"):
        if pathlib.Path(p).is_file():
            cand = p
            break
    if cand is None:
        if name.endswith(".cfg") or "/" in name:
            raise MethodError(f"config file not found: {name!r}")
        return None
    args = [int(x) for x in method.split(",")[1:]] if "," in method else []
    from ..zpaql.compiler import compile_config
    model, pcomp_cmd = compile_config(
        pathlib.Path(cand).read_text(), args=args)
    if pcomp_cmd and pcomp_cmd.strip():
        raise MethodError(
            f"config {cand!r} needs external preprocessor "
            f"{pcomp_cmd!r}; encode with built-in methods, decode works")
    pre = PreSpec(transform=0, block_bits=24)
    if model.n == 0 and not model.pcomp:
        return None, pre
    return model, pre


def make_model(method: str, n_components_hint: Optional[int] = None
               ) -> Tuple[Optional[Model], PreSpec]:
    """Compile a method string into (Model or None for store, PreSpec).

    ``method`` is a level digit (0-5), an x/s grammar string, or a ZPAQL
    config-file reference (``path[,args]``)."""
    cfg = config_file_model(method)
    if cfg is not None:
        return cfg
    cmds = parse_method(method)
    if not cmds:
        raise MethodError(f"empty method {method!r}")
    letter, args = cmds[0]
    level = None
    if letter.isdigit():
        level = int(letter)
        method = level_method(level, _arg(args, 0, 4), _arg(args, 1, 128),
                              _arg(args, 2, 0))
        cmds = parse_method(method)
        letter, args = cmds[0]
    if letter not in ("x", "s"):
        raise MethodError(f"method must start with a level digit or x: {method!r}")

    block_arg = _arg(args, 0, 4)
    n2 = _arg(args, 1, 0)
    pre = PreSpec(
        transform=n2 & 3, e8e9=bool(n2 & 4), block_bits=block_arg + 20,
        min_match=_arg(args, 2, 0), min_match2=_arg(args, 3, 0),
        depth_log=_arg(args, 4, 0), hash_bits=_arg(args, 5, 0),
        lookahead=_arg(args, 6, 0),
        chain=level == 2,
    )

    builder = _ModelBuilder(membits=block_arg + 20)
    for letter, largs in cmds[1:]:
        fn = getattr(builder, f"cmd_{letter.lower()}", None)
        if fn is None:
            raise MethodError(f"unknown component command {letter!r}")
        fn(largs)

    pcomp_body = None
    ph = pm = 0
    if pre.transform == 1:
        pcomp_body = lz77p_pcomp_source(max(0, pre.block_bits - 24),
                                        e8e9=pre.e8e9)
        pm = pre.block_bits             # output ring must hold a whole block
        if pre.e8e9:
            ph = 3                      # E8E9 stage window cells H[-8..-2]
    elif pre.transform == 2:
        pcomp_body = lz77_pcomp_source(max(1, pre.min_match), e8e9=pre.e8e9)
        pm = pre.block_bits             # output ring must hold a whole block
        if pre.e8e9:
            ph = 3                      # E8E9 stage window cells H[-8..-2]
    elif pre.transform == 3:
        pcomp_body = bwt_pcomp_source(e8e9=pre.e8e9)
        pm = pre.block_bits             # input buffer (n+5 <= block size)
        ph = pre.block_bits             # 256 counters + psi (+ E8E9 cells)
    elif pre.transform == 0 and pre.e8e9:
        pcomp_body = e8e9_pcomp_source()
        pm = 4                          # only a 5-byte window is live

    if builder.n == 0 and pcomp_body is None:
        return None, pre                # store mode (n=0 block)
    model, _ = compile_config(builder.build_config(ph, pm, pcomp_body))
    return model, pre
