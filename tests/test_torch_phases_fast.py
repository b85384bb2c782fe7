"""The port's phases specialiser (``zpaqfranz_tpu_torch/ops/phases_fast.py``):
the generated ``struct PhasesFast`` compiled with g++ (``__device__``
defined away, ``cp.async`` a plain copy), each thread of a group run in
turn, against a mirror of ``csrc/cm_model.cuh``'s generic ``phase_a`` and
``phase_c`` over random lane states and runs of bits (held rows, contexts,
predictions, weights, tables, the bits, bytes' ends), for every preset, a
model of every component type and one whose tables lie in device memory;
which models the generator takes, the build unit that holds the generated
code, and the ``phases`` count of the span ``cm.launch``. Every comparison
is exact."""

import struct
import subprocess

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from zpaqfranz_tpu_torch import trace
from zpaqfranz_tpu_torch.codec.methods import ALL_COMPONENTS_CFG, make_model
from zpaqfranz_tpu_torch.models import tables as T
from zpaqfranz_tpu_torch.ops import build
from zpaqfranz_tpu_torch.ops import cm_encode as cme
from zpaqfranz_tpu_torch.ops import phases_fast as pf
from zpaqfranz_tpu_torch.ops.cm_model import (_BIGLUT, SNS_OFF, SQ_OFF,
                                              STR_OFF, Layout, Placement,
                                              kernel_unit, phases_step,
                                              table_words)
from zpaqfranz_tpu_torch.parallel.engine import selector
from zpaqfranz_tpu_torch.zpaql.compiler import compile_config

M32 = 0xFFFFFFFF
TRIALS = 40
BITS = 12
PRESETS = ["3", "4", "5", "3.0", "4.0", "5.0", "5.1"]
#: the types whose predictions the combine makes
STEPS = (T.AVG, T.MIX2, T.MIX, T.ISSE, T.SSE)

#: tables in device memory beside shared ones: a 20-bit CM, an 18-bit
#: MIX2 and a 12-bit SSE pass a lane's shared budget, a 9-bit CM and a
#: small MIX stay in it
DEVICE_CFG = """comp 9 16 0 0 9
  0 cm 9 4
  1 cm 20 255
  2 icm 12
  3 isse 12 2
  4 match 16 16
  5 mix2 18 1 3 24 255
  6 mix 2 0 6 20 255
  7 sse 12 6 32 255
  8 mix2 4 7 5 30 3
hcomp
  halt
post 0 end
"""


def _cfg_mixes(consts: int, mixes: int) -> str:
    lines = [f"comp 9 16 0 0 {consts + mixes}"]
    lines += [f"  {i} const {(37 * i) % 256}" for i in range(consts)]
    lines += [f"  {consts + k} mix 0 0 {consts} 24 255" for k in range(mixes)]
    return "\n".join(lines + ["hcomp", "  halt", "post 0 end", ""])


def _model(name: str):
    if name == "cfg":
        return compile_config(ALL_COMPONENTS_CFG)[0]
    if name == "dev":
        return compile_config(DEVICE_CFG)[0]
    return make_model(name)[0]


def _i32(x: int) -> int:
    x = int(x) & M32
    return x - (1 << 32) if x >> 31 else x


def _clamp512k(x: int) -> int:
    return max(-(1 << 19), min((1 << 19) - 1, x))


SQ = _BIGLUT[SQ_OFF: SQ_OFF + 4096].astype(np.int16)
ST = _BIGLUT[STR_OFF: STR_OFF + 16384].astype(np.int16)
SNS = _BIGLUT[SNS_OFF: SNS_OFF + 1024].astype(np.uint8)
DT = np.array([((1 << 17) // (2 * k + 3)) * 2 for k in range(1024)],
              np.uint32)
DT2K = np.array([2048 // k if k else 0 for k in range(256)], np.int16)


def _stretch(x: int) -> int:
    return int(ST[x]) if x < 16384 else -int(ST[32767 - x])


def _trained(pn: int, y: int, limit: int) -> int:
    count = pn & 1023
    error = y * 32767 - (pn >> 17)
    return (pn + (((error & M32) * int(DT[count])) & 0xFFFFFC00)
            + (count < limit)) & M32


class Lane:
    """One lane's state as the generic phases see it: the region ``sw``
    (the group's view of shared memory) and the u8 and u32 arenas, whose
    writes go to overlays over shared random contents."""

    def __init__(self, model, plan, layout, sw, a8, a32):
        self.comps = [tuple(c) + (0,) * (6 - len(c)) for c in model.comps]
        self.n = model.n
        self.plan, self.lay = plan, layout
        self.geo = plan.geo
        self.sw = sw
        self.a8, self.a32 = a8, a32
        self.w8, self.w32 = {}, {}
        self.p = self.geo["p"]           # the current prediction buffer

    # the arenas
    def r8(self, at: int) -> int:
        return self.w8.get(at, int(self.a8[at]))

    def r32(self, at: int) -> int:
        return self.w32.get(at, int(self.a32[at]))

    def tab(self, i: int, at: int) -> int:
        sh = self.plan.shared.get(i)
        return int(self.sw[sh + at]) if sh is not None \
            else self.r32(self.lay.off32[i] + at)

    def set_tab(self, i: int, at: int, v: int) -> None:
        sh = self.plan.shared.get(i)
        if sh is not None:
            self.sw[sh + at] = v & M32
        else:
            self.w32[self.lay.off32[i] + at] = v & M32

    def row(self, i: int) -> list:
        o = self.geo["row"] + 4 * i
        return [int(v) for v in self.sw[o: o + 4]]

    def set_row(self, i: int, r) -> None:
        o = self.geo["row"] + 4 * i
        self.sw[o: o + 4] = r

    def pv(self, i: int) -> int:
        return _i32(int(self.sw[self.p + i]))

    # the generic phases, as csrc/cm_model.cuh runs them
    def fetch_row(self, i: int, bits: int, cx: int) -> None:
        ht = self.plan.off8[i]
        back = int(self.sw[self.geo["rowat"] + i])
        if back:
            for b, v in enumerate(struct.pack("<4I", *self.row(i))):
                self.w8[ht + back - 1 + b] = v
        chk = (cx >> (bits + 2)) & 255
        h0 = (cx * 16) & M32 & ((64 << bits) - 16)

        def rd(o):
            return list(struct.unpack("<4I", bytes(self.r8(ht + o + b)
                                                   for b in range(16))))
        r0, r1, r2 = rd(h0), rd(h0 ^ 16), rd(h0 ^ 32)
        m = [(r[0] & 255) == chk for r in (r0, r1, r2)]
        q = [(r[0] >> 8) & 255 for r in (r0, r1, r2)]
        low = h0 if q[0] <= q[1] and q[0] <= q[2] else (
            h0 ^ 16 if q[1] < q[2] else h0 ^ 32)
        at = h0 if m[0] else h0 ^ 16 if m[1] else h0 ^ 32 if m[2] else low
        r = r0 if m[0] else r1 if m[1] else r2 if m[2] else [chk, 0, 0, 0]
        self.set_row(i, r)
        self.sw[self.geo["rowat"] + i] = at + 1

    def phase_a(self, c8: int, hmap4: int, bit: int) -> None:
        sw, g = self.sw, self.geo
        for i, cp in enumerate(self.comps):
            if cp[0] not in (T.MIX, T.SSE):
                continue
            h = int(sw[g["h"] + i])
            if cp[0] == T.MIX:
                base, ln = ((h + (c8 & cp[5])) & ((1 << cp[1]) - 1)) * cp[3], \
                    cp[3]
            else:
                base, ln = ((h + c8) * 32) & M32 & ((32 << cp[1]) - 1), 32
            rs = self.plan.rows[i]
            for j in range(ln):
                sw[rs + j] = self.tab(i, base + j)
        nib = c8 == 1 or (c8 & 0xF0) == 16
        j4 = hmap4 & 15
        for i, cp in enumerate(self.comps):
            t = cp[0]
            h = int(sw[g["h"] + i])
            hashed = t in (T.ICM, T.ISSE)
            if nib and hashed:
                self.fetch_row(i, cp[1], (h + 16 * c8) & M32)
            row = self.row(i)
            st = (row[j4 >> 2] >> (8 * (j4 & 3))) & 255
            mask = (1 << (cp[1] & 31)) - 1
            idx = ((h ^ hmap4) & mask if t == T.CM
                   else (h + (c8 & cp[5])) & mask if t == T.MIX2
                   else st * 2 if t == T.ISSE else st)
            if hashed or t in (T.CM, T.MIX2):
                v0 = self.tab(i, idx)
                v1 = self.tab(i, idx + 1) if t == T.ISSE else 0
            else:
                v0, v1 = int(sw[0]), 0
            mc = (row[3] >> (7 - bit)) & 1
            sx = (v0 >> 17 if t == T.CM else v0 >> 8 if t == T.ICM
                  else (int(DT2K[row[2] & 255]) * (1 - 2 * mc)) & 32767)
            pv = ((cp[1] - 128) * 4 if t == T.CONS
                  else 0 if t == T.MATCH and row[2] == 0 else _stretch(sx))
            sw[self.p + i] = pv & M32
            if t != T.SSE:
                sw[g["cxt"] + i] = mc if t == T.MATCH else st if hashed \
                    else idx
            sw[g["wa"] + i] = v0
            sw[g["wb"] + i] = v1

    def phase_c(self, c8: int, hmap4: int, y: int) -> None:
        sw, g = self.sw, self.geo
        j4 = hmap4 & 15
        for i, cp in enumerate(self.comps):
            t = cp[0]
            cx, v0, v1 = (int(sw[g[k] + i]) for k in ("cxt", "wa", "wb"))
            err = (y * 32767 - int(SQ[self.pv(i) + 2048])) & M32
            if t == T.CM:
                new0 = _trained(v0, y, cp[2] * 4)
            elif t == T.ICM:
                new0 = (v0 + ((y * 32767 - (v0 >> 8)) >> 2)) & M32
            elif t == T.ISSE:
                x2 = self.pv(cp[2]) & M32
                new0 = _clamp512k(_i32(v0) + (_i32(err * x2 + 4096) >> 13))
                isse1 = _clamp512k(_i32(v1) + ((_i32(err) + 16) >> 5))
            elif t == T.MIX2:
                x2, x3 = self.pv(cp[2]) & M32, self.pv(cp[3]) & M32
                e = (_i32(err * cp[4]) >> 5) & M32
                w = _i32(v0) + (_i32(e * ((x2 - x3) & M32) + 4096) >> 13)
                new0 = max(0, min(65535, w))
            if t in (T.CM, T.ICM, T.ISSE, T.MIX2):
                self.set_tab(i, cx * 2 if t == T.ISSE else cx, new0)
            if t == T.ISSE:
                self.set_tab(i, cx * 2 + 1, isse1)
            if t in (T.ICM, T.ISSE):
                r = self.row(i)
                sh = 8 * (j4 & 3)
                r[j4 >> 2] = (r[j4 >> 2] & ~(255 << sh) & M32) | (
                    int(SNS[(cx & 255) * 4 + y]) << sh)
                self.set_row(i, r)
            if t == T.MATCH and self.row(i)[2] != 0 and cx != y:
                sw[g["row"] + 4 * i + 2] = 0
        for i, cp in enumerate(self.comps):
            if cp[0] not in (T.MIX, T.SSE):
                continue
            rs = self.plan.rows[i]
            if cp[0] == T.MIX:
                err = ((y * 32767 - int(SQ[self.pv(i) + 2048])) * cp[4]) >> 4
                h = int(sw[g["h"] + i])
                cx = ((h + (c8 & cp[5])) & ((1 << cp[1]) - 1)) * cp[3]
                for j in range(cp[3]):
                    self.set_tab(i, cx + j, _clamp512k(
                        _i32(sw[rs + j])
                        + ((err * self.pv(cp[2] + j) + 4096) >> 13)))
            else:
                cx = int(sw[g["cxt"] + i])
                self.set_tab(i, cx & ((32 << cp[1]) - 1),
                             _trained(int(sw[rs + (cx & 31)]), y, cp[4] * 4))


def _table(rng, cp, size: int) -> np.ndarray:
    """Random contents of a u32 table of a component, in the ranges the
    coder keeps them in."""
    t = cp[0]
    if t == T.ICM:
        return rng.integers(0, 1 << 23, size)
    if t in (T.ISSE, T.MIX):
        return rng.integers(-(1 << 19), 1 << 19, size) & M32
    if t == T.MIX2:
        return rng.integers(0, 65536, size)
    return rng.integers(0, 1 << 32, size)


def _arenas(model, plan, lay, rng):
    """Random u8 and u32 arenas and shared tables of one lane."""
    a8 = rng.integers(0, 256, plan.s8, dtype=np.uint8)
    a32 = np.zeros(lay.s32, np.uint32)
    sw = np.zeros(plan.lane_words, np.uint32)
    for i, cp in enumerate(model.comps):
        size = table_words(cp)
        if size:
            o = lay.off32[i]
            a32[o: o + size] = _table(rng, cp, size)
        if i in plan.shared:
            o = plan.shared[i]
            sw[o: o + size] = _table(rng, cp, size)
    return sw, a8, a32


def _trial(model, plan, sw0, rng):
    """One trial's start: the region with random contexts, predictions,
    weights, rows and held rows; the lane's place in a byte; and each bit's
    outside writes (the combine's predictions and SSE contexts, a byte's
    new contexts and MATCH state); the check bytes to plant in the u8
    tables so that find() hits."""
    n, g = model.n, plan.geo
    comps = [tuple(c) + (0,) * (6 - len(c)) for c in model.comps]
    sw = sw0.copy()
    sw[g["h"]: g["h"] + n] = rng.integers(0, 1 << 32, n)
    sw[g["p"]: g["p"] + 2 * n] = rng.integers(-2048, 2048, 2 * n) & M32
    for name in ("cxt", "wa", "wb"):
        sw[g[name]: g[name] + n] = rng.integers(0, 1 << 32, n)
    for i, cp in enumerate(comps):
        r = g["row"] + 4 * i
        if cp[0] == T.CONS:
            sw[g["p"] + i] = sw[g["p"] + n + i] = ((cp[1] - 128) * 4) & M32
        elif cp[0] in (T.ICM, T.ISSE):
            sw[r: r + 4] = rng.integers(0, 1 << 32, 4)
            sw[g["rowat"] + i] = (16 * int(rng.integers(0, 4 << cp[1])) + 1
                                  if rng.random() < 0.8 else 0)
        elif cp[0] == T.MATCH:
            sw[r: r + 4] = [rng.integers(0, 1 << 32), rng.integers(0, 1 << 32),
                            rng.integers(0, 256) if rng.random() < 0.7 else 0,
                            rng.integers(0, 256)]
    for i in plan.rows:
        sw[plan.rows[i]: plan.rows[i] + 32] = rng.integers(0, 1 << 32, 32)
    pos = int(rng.integers(0, 8))
    c8 = 1
    hmap4 = 1
    for _ in range(pos):
        c8, hmap4 = _tail(c8, hmap4, int(rng.integers(0, 2)))
    bits, plant = [], []
    h = [int(v) for v in sw[g["h"]: g["h"] + n]]
    c, hm = c8, hmap4
    for _ in range(BITS):
        if c == 1 or (c & 0xF0) == 16:
            for i, cp in enumerate(comps):
                if cp[0] in (T.ICM, T.ISSE) and rng.random() < 0.75:
                    cx = (h[i] + 16 * c) & M32
                    h0 = (cx * 16) & M32 & ((64 << cp[1]) - 16)
                    at = h0 ^ int(rng.choice([0, 16, 32]))
                    plant.append((plan.off8[i] + at,
                                  (cx >> (cp[1] + 2)) & 255))
        y = int(rng.integers(0, 2))
        pstep = [int(rng.integers(-2048, 2048)) & M32 for _ in range(n)]
        sse = [((h[i] + c) * 32 + int(rng.integers(0, 32))) & M32
               for i in range(n)]
        newh = [int(v) for v in rng.integers(0, 1 << 32, n)]
        mrows = [int(v) for i in range(n) for v in (
            rng.integers(0, 1 << 32), rng.integers(0, 1 << 32),
            rng.integers(0, 256) if rng.random() < 0.7 else 0,
            rng.integers(0, 256))]
        bits.append((y, pstep, sse, newh, mrows))
        c, hm = _tail(c, hm, y)
        if c >= 256:
            c, hm, h = 1, 1, newh
    return sw, c8, hmap4, pos, bits, plant


def _tail(c8: int, hmap4: int, y: int):
    """csrc/cm_model.cuh tail's c8 and hmap4 (c8 past 255: a byte's end)."""
    c8 += c8 + y
    if c8 >= 256:
        return c8, 1
    if 16 <= c8 < 32:
        return c8, (hmap4 & 0xF) << 5 | y << 4 | 1
    return c8, (hmap4 & 0x1F0) | (((hmap4 & 0xF) * 2 + y) & 0xF)


HARNESS = r"""
#include <cstdio>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>
#define __device__
#define __forceinline__ inline
#include "phases.cuh"
typedef std::vector<uint32_t> V;
static FILE* in;
static FILE* out;
template <class X> static void rd(X* p, size_t k) {
  if (std::fread(p, sizeof(X), k, in) != k) { std::fprintf(stderr, "eof\n"); std::exit(3); }
}
template <class X> static void wr(const X* p, size_t k) { std::fwrite(p, sizeof(X), k, out); }
int main(int argc, char** argv) {
  const int G = PhasesFast::G, N = PhasesFast::n;
  const int W = %(W)d, S8 = %(S8)d, S32 = %(S32)d, TR = %(T)d, B = %(B)d;
  const int GH = %(GH)d, GP = %(GP)d, GCXT = %(GCXT)d, GROW = %(GROW)d,
            GROWAT = %(GROWAT)d, GMISC = %(GMISC)d;
  const int steps[] = {%(STEPS)s -1}, sses[] = {%(SSES)s -1},
            matches[] = {%(MATCHES)s -1};
  in = std::fopen(argv[1], "rb");
  out = std::fopen(argv[2], "wb");
  std::vector<short> sq(4096), st(16384), dt2k(256);
  std::vector<uint8_t> sns(1024);
  V dt(1024);
  rd(sq.data(), 4096); rd(st.data(), 16384); rd(sns.data(), 1024);
  rd(dt.data(), 1024); rd(dt2k.data(), 256);
  std::vector<uint8_t> a8_0(S8);
  V a32_0(S32);
  rd(a8_0.data(), S8); rd(a32_0.data(), S32);
  std::vector<uint8_t> a8 = a8_0;
  V a32 = a32_0;
  for (int t = 0; t < TR; ++t) {
    V sw(W);
    rd(sw.data(), W);
    uint32_t start[3], np;
    rd(start, 3); rd(&np, 1);
    for (uint32_t q = 0; q < np; ++q) { uint32_t pv[2]; rd(pv, 2); a8[pv[0]] = uint8_t(pv[1]); }
    uint32_t c8 = start[0], hmap4 = start[1];
    int bit = int(start[2]);
    std::vector<PhasesFast> th(G);
    for (int k = 0; k < G; ++k) {
      th[k].init(k, sw.data(), a8.data(), a32.data());
      th[k].byte_start(sw.data());
      if (k < N) {   // the held rows: the lane's, as the generic phases keep them
        std::memcpy(&th[k].row.x, sw.data() + GROW + 4 * k, 16);
        th[k].rowat = sw[GROWAT + k];
        for (int q = 0; matches[q] >= 0; ++q)
          if (matches[q] == k) std::memcpy(&th[k].row.x, sw.data() + GROW + 4 * k, 16);
      }
    }
    int32_t* p = reinterpret_cast<int32_t*>(sw.data() + GP);
    int32_t* pn = p + N;
    auto snap = [&]() {
      for (int k = 0; k < G; ++k) {
        const uint32_t r[8] = {th[k].row.x, th[k].row.y, th[k].row.z, th[k].row.w,
                               th[k].rowat, th[k].cxt, th[k].wa, th[k].wb};
        wr(r, 8);
      }
      wr(sw.data() + GP, GMISC - GP);
    };
    for (int k = 0; k < G; ++k)
      th[k].a(sw.data(), a32.data(), p, c8, hmap4, bit, st.data(),
                dt2k.data());
    snap();
    for (int b = 0; b < B; ++b) {
      uint32_t y;
      V ps(N), sse(N), nh(N), mr(4 * N);
      rd(&y, 1); rd(ps.data(), N); rd(sse.data(), N); rd(nh.data(), N); rd(mr.data(), 4 * N);
      for (int q = 0; steps[q] >= 0; ++q) p[steps[q]] = int32_t(ps[steps[q]]);
      for (int q = 0; sses[q] >= 0; ++q) sw[GCXT + sses[q]] = sse[sses[q]];
      for (int k = 0; k < G; ++k)
        th[k].c(sw.data(), a32.data(), p, c8, hmap4, int(y), sq.data(),
                sns.data(), dt.data());
      snap();
      c8 += c8 + y;
      ++bit;
      if (c8 >= 256) {   // a byte's end: new contexts, MATCH's new state
        for (int i = 0; i < N; ++i) sw[GH + i] = nh[i];
        for (int q = 0; matches[q] >= 0; ++q)
          std::memcpy(sw.data() + GROW + 4 * matches[q], mr.data() + 4 * matches[q], 16);
        c8 = 1; hmap4 = 1; bit = 0;
      } else if (c8 >= 16 && c8 < 32) {
        hmap4 = (hmap4 & 0xfu) << 5 | y << 4 | 1u;
      } else {
        hmap4 = (hmap4 & 0x1f0u) | (((hmap4 & 0xfu) * 2u + y) & 0xfu);
      }
      std::swap(p, pn);
      for (int k = 0; k < G; ++k)
        th[k].a(sw.data(), a32.data(), p, c8, hmap4, bit, st.data(),
                dt2k.data());
      snap();
    }
    wr(sw.data(), W);
    // the arenas' changes, each put back for the next trial
    std::vector<uint32_t> d;
    for (int i = 0; i < S8; ++i)
      if (a8[i] != a8_0[i]) { d.push_back(i); d.push_back(a8[i]); a8[i] = a8_0[i]; }
    uint32_t nd = d.size() / 2;
    wr(&nd, 1); wr(d.data(), d.size());
    d.clear();
    for (int i = 0; i < S32; ++i)
      if (a32[i] != a32_0[i]) { d.push_back(i); d.push_back(a32[i]); a32[i] = a32_0[i]; }
    nd = d.size() / 2;
    wr(&nd, 1); wr(d.data(), d.size());
  }
  std::fclose(out);
  return 0;
}
"""


def _observed(model, plan):
    """Words of the region from p to misc that the generated phases keep
    as the generic ones do (the rest: per-thread state they hold in
    registers, and predictions of steps, which the combine overwrites)."""
    n, g = model.n, plan.geo
    keep = set()
    for i, cp in enumerate(model.comps):
        t = cp[0]
        if t in (T.CONS, T.CM, T.ICM, T.MATCH):
            keep |= {g["p"] + i, g["p"] + n + i}
        if t in (T.ISSE, T.MIX2):
            keep.add(g["wa"] + i)
        if t == T.ISSE:
            keep.add(g["wb"] + i)
        if t == T.SSE:
            keep.add(g["cxt"] + i)
        if t == T.MATCH:
            keep |= {g["row"] + 4 * i + e for e in range(4)}
    for i, o in plan.rows.items():
        keep |= set(range(o, o + (model.comps[i][3]
                                  if model.comps[i][0] == T.MIX else 32)))
    return keep


def _registers(model, plan, sw):
    """Each thread's registers as the generic phases keep them in the
    region, by the components whose phases read them: (row, rowat, cxt,
    wa, wb), None where not kept."""
    g = plan.geo
    out = []
    for i, cp in enumerate(model.comps):
        t = cp[0]
        r = [int(v) for v in sw[g["row"] + 4 * i: g["row"] + 4 * i + 4]]
        hashed = t in (T.ICM, T.ISSE)
        out.append((r if hashed or t == T.MATCH else None,
                    int(sw[g["rowat"] + i]) if hashed else None,
                    int(sw[g["cxt"] + i]) if t in (T.CM, T.ICM, T.ISSE,
                                                   T.MIX2, T.MATCH) else None,
                    int(sw[g["wa"] + i]) if t in (T.CM, T.ICM, T.ISSE,
                                                  T.MIX2) else None,
                    int(sw[g["wb"] + i]) if t == T.ISSE else None))
    return out


@pytest.mark.parametrize("name", PRESETS + ["cfg", "dev"])
def test_generated_phases_match_generic(name, tmp_path):
    """``struct PhasesFast`` compiled with g++, each thread of the group in
    turn, gives what the generic phases give over runs of bits from random
    lane states: the same predictions, weights and contexts for the
    combine, the same registers where the generic phases keep them in the
    region, the same table entries, row copies and held rows, the same u8
    and u32 arenas."""
    model = _model(name)
    plan = Placement(model, "fast")
    lay = Layout(model)
    fast = pf.try_compile(model, plan, lay)
    assert fast is not None
    n, G, g = model.n, plan.G, plan.geo
    rng = np.random.default_rng(sum(map(ord, name)) + 20)
    sw0, a8, a32 = _arenas(model, plan, lay, rng)
    comps = [tuple(c) for c in model.comps]
    steps = [i for i, cp in enumerate(comps) if cp[0] in STEPS]
    sses = [i for i, cp in enumerate(comps) if cp[0] == T.SSE]
    matches = [i for i, cp in enumerate(comps) if cp[0] == T.MATCH]
    blob = [SQ.tobytes(), ST.tobytes(), SNS.tobytes(), DT.tobytes(),
            DT2K.tobytes(), a8.tobytes(), a32.astype(np.uint32).tobytes()]
    trials = []
    for _ in range(TRIALS):
        sw, c8, hmap4, pos, bits, plant = _trial(model, plan, sw0, rng)
        trials.append((sw, c8, hmap4, pos, bits, plant))
        blob += [sw.astype(np.uint32).tobytes(),
                 struct.pack("<4I", c8, hmap4, pos, len(plant)),
                 b"".join(struct.pack("<2I", *q) for q in plant)]
        for y, pstep, sse, newh, mrows in bits:
            blob.append(struct.pack(f"<{1 + 7 * n}I", y, *pstep, *sse,
                                    *newh, *mrows))
    (tmp_path / "in.bin").write_bytes(b"".join(blob))
    (tmp_path / "phases.cuh").write_text(fast.cuda_source())
    lst = lambda xs: "".join(f"{x}, " for x in xs)     # noqa: E731
    (tmp_path / "h.cpp").write_text(HARNESS % {
        "W": plan.lane_words, "S8": plan.s8, "S32": lay.s32, "T": TRIALS,
        "B": BITS, "GH": g["h"], "GP": g["p"], "GCXT": g["cxt"],
        "GROW": g["row"], "GROWAT": g["rowat"], "GMISC": g["misc"],
        "STEPS": lst(steps), "SSES": lst(sses), "MATCHES": lst(matches)})
    subprocess.run(["g++", "-O1", "-std=c++17", "-Wall", "-Werror", "-I",
                    str(tmp_path), "-o", str(tmp_path / "h"),
                    str(tmp_path / "h.cpp")], check=True)
    subprocess.run([str(tmp_path / "h"), str(tmp_path / "in.bin"),
                    str(tmp_path / "out.bin")], check=True)
    got = np.fromfile(tmp_path / "out.bin", np.uint32)
    at = 0

    def take(k):
        nonlocal at
        at += k
        return got[at - k: at]

    keep = sorted(_observed(model, plan))
    span = g["misc"] - g["p"]
    for t, (sw, c8, hmap4, pos, bits, plant) in enumerate(trials):
        lane = Lane(model, plan, lay, sw.copy(), a8, a32)
        lane.w8.update(plant)
        shadow = sw.copy()        # the region with outside writes alone
        bit = pos

        def check(phase):
            regs = take(8 * G).reshape(G, 8)
            region = take(span)
            for i, (row, rowat, cxt, wa, wb) in enumerate(
                    _registers(model, plan, lane.sw)):
                for name_, want, have in (
                        ("row", row, regs[i, :4].tolist()),
                        ("rowat", rowat, int(regs[i, 4])),
                        ("cxt", cxt, int(regs[i, 5])),
                        ("wa", wa, int(regs[i, 6])),
                        ("wb", wb, int(regs[i, 7]))):
                    assert want is None or want == have, \
                        f"trial {t}, {phase}: component {i}'s {name_}"
            want = shadow[g["p"]: g["misc"]].copy()
            for w in keep:
                want[w - g["p"]] = lane.sw[w]
            bad = np.nonzero(region != want)[0]
            assert not bad.size, (f"trial {t}, {phase}: region words "
                                  f"{(bad + g['p']).tolist()[:8]}")

        lane.phase_a(c8, hmap4, bit)
        check("phase (a) 0")
        for b, (y, pstep, sse, newh, mrows) in enumerate(bits):
            for i in steps:
                lane.sw[lane.p + i] = shadow[lane.p + i] = pstep[i]
            for i in sses:
                lane.sw[g["cxt"] + i] = shadow[g["cxt"] + i] = sse[i]
            lane.phase_c(c8, hmap4, y)
            check(f"phase (c) {b}")
            c8, hmap4 = _tail(c8, hmap4, y)
            bit += 1
            if c8 >= 256:
                c8, bit = 1, 0
                lane.sw[g["h"]: g["h"] + n] = shadow[g["h"]: g["h"] + n] = newh
                for i in matches:
                    o = g["row"] + 4 * i
                    lane.sw[o: o + 4] = shadow[o: o + 4] = mrows[4 * i: 4 * i
                                                                 + 4]
            lane.p = g["p"] + n if lane.p == g["p"] else g["p"]
            lane.phase_a(c8, hmap4, bit)
            check(f"phase (a) {b + 1}")
        final = take(plan.lane_words)
        outside = [w for w in range(plan.lane_words)
                   if not g["p"] <= w < g["misc"]]
        assert np.array_equal(final[outside], lane.sw[outside]), \
            f"trial {t}: the region's tables and row copies"
        for base, writes in ((a8, lane.w8), (a32, lane.w32)):
            nd = int(take(1)[0])
            d = take(2 * nd).reshape(nd, 2)
            have = {int(k): int(v) for k, v in d}
            want = {k: v for k, v in writes.items() if v != int(base[k])}
            assert have == want, f"trial {t}: the arenas"
    assert at == got.size


def test_mirror_equals_the_generic_kernel_on_a_real_lane():
    """The mirror of the generic phases holds: driven through a short
    text at -m4 with the scalar predictor's combine (``models/
    predictor.py``) standing in for phase (b), it gives the predictor's
    P(1) and predictions at every bit."""
    from zpaqfranz_tpu_torch.models.predictor import Predictor

    model = make_model("4.0")[0]
    n = model.n
    plan = Placement(model, "fast")
    lay = Layout(model)
    a8 = np.zeros(plan.s8, np.uint8)
    a32 = lay.init_rows()[1]
    sw = np.zeros(plan.lane_words, np.uint32)
    for i, o in plan.shared.items():
        size = table_words(model.comps[i])
        sw[o: o + size] = a32[lay.off32[i]: lay.off32[i] + size]
    lane = Lane(model, plan, lay, sw, a8, a32)
    matches = [i for i, cp in enumerate(model.comps) if cp[0] == T.MATCH]
    pred = Predictor(model)
    steps = [i for i, cp in enumerate(model.comps) if cp[0] in STEPS]
    c8, hmap4, bit = 1, 1, 0
    for byte in b"the cat sat on the mat; the mat sat":
        for k in range(7, -1, -1):
            lane.sw[plan.geo["h"]: plan.geo["h"] + n] = \
                [v & M32 for v in pred.h[:n]]
            for i in matches if c8 == 1 else ():    # its byte end's state
                cr = pred.comp[i]
                mask = cr.ht.size - 1
                lane.sw[plan.geo["row"] + 4 * i + 2] = cr.a
                lane.sw[plan.geo["row"] + 4 * i + 3] = int(
                    cr.ht[(cr.limit - cr.b) & mask])
            lane.phase_a(c8, hmap4, bit)
            want = pred.predict()
            got = [lane.pv(i) for i in range(n)]
            assert [got[i] for i in range(n) if i not in steps] \
                == [pred.p[i] for i in range(n) if i not in steps]
            for i in steps:
                lane.sw[lane.p + i] = pred.p[i] & M32
                if model.comps[i][0] == T.SSE:
                    lane.sw[plan.geo["cxt"] + i] = pred.comp[i].cxt
            assert want == int(SQ[pred.p[n - 1] + 2048])
            y = (byte >> k) & 1
            lane.phase_c(c8, hmap4, y)
            pred.update(y)
            c8, hmap4 = _tail(c8, hmap4, y)
            bit += 1
            if c8 >= 256:
                c8, bit = 1, 0
            lane.p = plan.geo["p"] + n if lane.p == plan.geo["p"] \
                else plan.geo["p"]


@pytest.mark.parametrize("name", PRESETS + ["cfg", "dev"])
def test_generator_accepts_every_preset(name):
    """Every preset with a CM model, the model of every component type
    and the one with device tables run the generated phases by default, at
    both HCOMP steps; a group never has fewer threads than components
    there."""
    model = _model(name)
    for hcomp in ("fast", "interp"):
        plan = Placement(model, hcomp)
        assert plan.G >= model.n
        assert phases_step(model, plan) == "fast"
        assert phases_step(model, plan, "generic") == "generic"
        fast = pf.try_compile(model, plan, Layout(model))
        assert fast.block == plan.lanes_per_block * plan.G
        assert f"#define CM_BLOCK_THREADS {fast.block}" in fast.cuda_source()
        assert fast.copies <= pf.MAX_COPIES


#: each preset's group and block (lanes a block times G) at the specialised
#: HCOMP step, which the generated phases compile their kernels for
BLOCKS = {"3": (2, 114), "3.0": (2, 114), "4": (16, 96), "4.0": (16, 96),
          "5": (32, 160), "5.0": (32, 160), "5.1": (32, 160)}


@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_presets_have_a_thread_a_component(name):
    model = _model(name)
    plan = Placement(model, "fast")
    fast = pf.try_compile(model, plan, Layout(model))
    assert (plan.G, fast.block) == BLOCKS[name]
    assert model.n <= plan.G


def test_generator_refuses_a_group_short_of_threads():
    """41 components on 32 threads: thread k would own two, and the
    kernels run the generic phases; asking for the generated ones
    raises."""
    model = compile_config(_cfg_mixes(40, 1))[0]
    plan = Placement(model, "interp")
    assert plan.G == 32 < model.n
    assert pf.try_compile(model, plan, Layout(model)) is None
    assert phases_step(model, plan) == "generic"
    with pytest.raises(ValueError, match="generator"):
        phases_step(model, plan, "fast")
    assert "PhasesFast" not in "".join(kernel_unit("cm_encode", model))


def test_generator_refuses_a_step_reading_ahead():
    """A step whose input is not before it reads a prediction of this
    bit's phase (a) that the generated phases do not write: refused."""
    model = compile_config(_cfg_mixes(3, 1))[0]
    model.comps[-1] = bytes([T.MIX, 0, 1, 3, 24, 255])
    plan = Placement(model, "interp")
    assert pf.try_compile(model, plan, Layout(model)) is None


def test_unknown_phases_raise():
    model = make_model("4")[0]
    with pytest.raises(ValueError, match="phases must be"):
        phases_step(model, Placement(model, "fast"), "walk")


@pytest.mark.parametrize("name", ["3.0", "4.0", "5.0", "cfg"])
def test_unit_holds_the_generated_phases(name):
    """The unit of a launch holds the generated phases after the HCOMP
    program and the combine, with their switch; forcing the generic
    phases leaves them out, and the unit's library differs."""
    model = _model(name)
    plan = Placement(model, "fast")
    src = pf.try_compile(model, plan, Layout(model)).cuda_source()
    for kernel in ("cm_decode", "cm_encode"):
        unit = kernel_unit(kernel, model)
        assert unit[1].endswith(f"{src}\n#define CM_PHASES_FAST 1\n")
        generic = kernel_unit(kernel, model, phases="generic")
        assert "PhasesFast" not in generic[1]
        assert "CM_BLOCK_THREADS" not in generic[1]
        assert unit[1].startswith(generic[1])
        assert build.unit_key(unit) != build.unit_key(generic)
        assert kernel_unit(kernel, model, "interp", "generic", "generic") \
            == kernel


class _CpuLaunch(cme.Launch):
    """An encode launch prepared on the CPU whose kernel call is left
    out: the launch's choices and its span, without a card."""

    def __init__(self, model, src, in_off, in_len, out_cap, **kw):
        self.prepare(model, src, in_off, in_len, out_cap, **kw)


def test_cm_launch_counts_the_phases(monkeypatch):
    """``cm.launch`` records which phases ran beside the HCOMP step and
    the combine: ``"fast"`` at -m4, ``"generic"`` for a group short of
    threads; the encoder counts its launches by phases."""
    def no_kernel(unit, symbol, device, *args, **hints):
        hints["written"][1].zero_()
    monkeypatch.setattr(build, "call", no_kernel)
    monkeypatch.setattr(cme, "phases_launches", {"fast": 0, "generic": 0})
    trace.clear()
    try:
        for method, want in (("4.0", "fast"), (_cfg_mixes(40, 1), "generic")):
            model = (make_model(method) if method == "4.0"
                     else compile_config(method))[0]
            payload = selector(model) + b"the cat sat on the mat"
            src = torch.frombuffer(bytearray(payload), dtype=torch.uint8)
            lens = torch.tensor([len(payload)])
            with profile(activities=[ProfilerActivity.CPU]):
                _CpuLaunch.code(model, src, torch.tensor([0]), lens,
                                lens + 64)
            rec = [r for r in trace.records() if r.name == "cm.launch"][-1]
            assert rec.counts["phases"] == want
            assert rec.counts["combine"] == "fast"
    finally:
        trace.clear()
    assert cme.phases_launches == {"fast": 1, "generic": 1}
