"""Phases (a) and (c) as straight-line code: the per-model phases specialiser.

Phases (a) and (c) of a CM lane kernel (``csrc/cm_model.cuh``) are the
parallel halves of a bit: every thread of the lane's group reads what its
component needs before the combine (a) and updates its component after it
(c), and the group copies and updates the MIX weight rows and SSE rows.
``phase_a`` and ``phase_c`` interpret the model on every bit: each thread
reloads its component's parameters and placement from the block header,
re-reads its held hash row, context and weights from the lane's region,
reaches each table through a pointer that picks shared or device memory
anew, and walks the MIX and SSE rows with lengths and owners known only at
run time.

Here the phases of one model become ``struct PhasesFast``. In every preset
the group has a thread for each component (``G >= n``), so thread k owns
component k alone: at lane start it loads its component's constants (type,
table offsets, masks, inputs, rates, limits) into registers, from a table
fixed at generation time, and it keeps its own state in registers from
phase (a) to phase (c) and from bit to bit: its context hash (reloaded when
a byte starts), the held ICM/ISSE row with its offset, the context and the
weights its phase (a) read. The lane's region keeps only what another
thread reads or writes: the predictions, the weights the combine reads
(ISSE, MIX2), the SSE contexts the combine writes, MATCH's state (its byte
end searches with the whole group) and the row copies. The MIX and SSE
rows are unrolled, each element's owner thread (``j % G``), length and
placement (a shared copy, or ``cp.async`` from device memory) fixed. One
instruction stream stays, as the kernels' header explains: results are
selected by type, and only the model's own types and placements are
compiled in; shared and device tables are reached through their own
address spaces.

The result is ``phase_a`` / ``phase_c``'s bit for bit: the same
predictions, the same table entries and row bytes written, the same
contexts. Steps' predictions, which ``phase_a`` fills with values the
combine overwrites before anyone reads them, are left to the combine.

``ops/build.py`` compiles the text into the same per-model unit as the
HCOMP program and the combine (``CM_PHASES_FAST``), and the unit's kernels
with launch bounds of their own block (``CM_BLOCK_THREADS``,
``Placement.lanes_per_block * G``): the block's shared memory, not its
registers, sets how many blocks an SM holds. A model whose group has fewer
threads than components, whose step reads a component that is not before
it, whose tables pass what 32-bit offsets reach, or whose rows would take
a thread more than ``MAX_COPIES`` copies a bit, is refused, and the
kernels run ``phase_a`` / ``phase_c``: a coverage choice made from the
model, never a correctness one.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from .. import trace
from ..models import tables as T
from ..zpaql.header import Model

#: the most row elements one thread copies a bit (MIX and SSE rows
#: together); past it the unrolled code grows past what is worth compiling,
#: and the kernels run the generic phases
MAX_COPIES = 64
#: the largest table size in bits (context bits of CM, MIX, MIX2, SSE;
#: hash bits of ICM, ISSE) the generated code's 32-bit offsets take
MAX_BITS = 24

_M32 = 0xFFFFFFFF
_NAMES = {T.CONS: "CONS", T.CM: "CM", T.ICM: "ICM", T.MATCH: "MATCH",
          T.AVG: "AVG", T.MIX2: "MIX2", T.MIX: "MIX", T.ISSE: "ISSE",
          T.SSE: "SSE"}
#: types whose thread reads a u32 table entry in phase (a)
_READS = (T.CM, T.ICM, T.ISSE, T.MIX2)


class _Refused(Exception):
    pass


def _inputs(cp) -> List[int]:
    t = cp[0]
    if t == T.AVG:
        return [cp[1], cp[2]]
    if t == T.MIX2:
        return [cp[2], cp[3]]
    if t == T.MIX:
        return list(range(cp[2], cp[2] + cp[3]))
    if t in (T.ISSE, T.SSE):
        return [cp[2]]
    return []


def _bits(cp) -> Optional[int]:
    """The size in bits of a component's table (None: it has none)."""
    return cp[1] if cp[0] in (T.CM, T.ICM, T.ISSE, T.MIX, T.MIX2, T.SSE) \
        else None


class PhasesFast:
    """The specialised phases of one model at one placement
    (``cm_model.Placement``: G, the lane region's geometry, the shared
    tables, the row copies, the u8 offsets) with the u32 offsets of
    ``layout`` (``cm_model.Layout``). Construction generates the code, so
    every refusal fires here."""

    def __init__(self, model: Model, plan, layout):
        n = model.n
        comps = [tuple(c) for c in model.comps]
        if not n:
            raise _Refused("no components: no CM lane")
        if plan.G < n:
            raise _Refused(f"{n} components on {plan.G} threads")
        for i, cp in enumerate(comps):
            if any(not 0 <= j < i for j in _inputs(cp)):
                raise _Refused(f"component {i} reads one not before it")
            b = _bits(cp)
            if b is not None and b > MAX_BITS:
                raise _Refused(f"component {i}: {b} bits")
        offs = list(plan.off8) + [layout.off32.get(i, 0) for i in range(n)]
        if max(offs + [plan.s8, layout.s32]) >= 1 << 31:
            raise _Refused("tables past 32-bit offsets")
        self.n, self.G = n, plan.G
        self.comps = comps
        self.plan = plan
        self.off32 = [layout.off32.get(i, 0) for i in range(n)]
        self.rows = [i for i, cp in enumerate(comps) if cp[0] in (T.MIX,
                                                                  T.SSE)]
        self.copies = sum(-(-self._row_len(i) // self.G) for i in self.rows)
        if self.copies > MAX_COPIES:
            raise _Refused(f"{self.copies} copies a thread, past "
                           f"{MAX_COPIES}")
        self.block = plan.lanes_per_block * plan.G
        self._source = self._generate()

    def _row_len(self, i: int) -> int:
        cp = self.comps[i]
        return cp[3] if cp[0] == T.MIX else 32

    def _shared(self, i: int) -> bool:
        return i in self.plan.shared

    # ---- the constants of each thread ------------------------------------
    def _columns(self) -> Tuple[List[str], List[List[int]]]:
        """Names of the constant table's columns and one row per thread:
        only what the model's own types use."""
        types = {cp[0] for cp in self.comps}
        reads = [i for i, cp in enumerate(self.comps) if cp[0] in _READS]
        cols = ["ty"]
        if types & {T.ICM, T.ISSE}:
            cols += ["off8", "hm8", "csh"]
        if any(self._shared(i) for i in reads):
            cols += ["tab"]
        if any(not self._shared(i) for i in reads):
            cols += ["off32"]
            if any(self._shared(i) for i in reads):
                cols += ["onsh"]
        if types & {T.CM, T.MIX2}:
            cols += ["mask"]
        if T.MIX2 in types:
            cols += ["cm5", "in3", "rate"]
        if types & {T.MIX2, T.ISSE}:
            cols += ["in2"]
        if T.CM in types:
            cols += ["lim"]
        if T.CONS in types:
            cols += ["cons"]
        rows = []
        for k in range(self.G):
            cp = self.comps[k] if k < self.n else (0,) * 6
            cp = tuple(cp) + (0,) * (6 - len(cp))
            t = cp[0]
            v = {"ty": t,
                 "off8": self.plan.off8[k] if t in (T.ICM, T.ISSE) else 0,
                 "hm8": ((64 << cp[1]) - 16) & _M32
                 if t in (T.ICM, T.ISSE) else 0,
                 "csh": cp[1] + 2 if t in (T.ICM, T.ISSE) else 0,
                 "tab": self.plan.shared.get(k, 0)
                 if t in _READS and self._shared(k) else 0,
                 "off32": self.off32[k] if t in _READS else 0,
                 "onsh": int(t in _READS and self._shared(k)),
                 "mask": ((1 << (cp[1] & 31)) - 1) & _M32
                 if t in (T.CM, T.MIX2) else 0,
                 "cm5": cp[5] if t == T.MIX2 else 0,
                 "in3": cp[3] if t == T.MIX2 else 0,
                 "rate": cp[4] if t == T.MIX2 else 0,
                 "in2": cp[2] if t in (T.MIX2, T.ISSE) else 0,
                 "lim": cp[2] * 4 if t == T.CM else 0,
                 "cons": (cp[1] - 128) * 4 if t == T.CONS else 0}
            rows.append([v[c] for c in cols])
        return cols, rows

    # ---- the code generator ---------------------------------------------
    def _generate(self) -> str:
        comps, n, G, plan = self.comps, self.n, self.G, self.plan
        geo = plan.geo
        types = {cp[0] for cp in comps}
        cols, table = self._columns()
        col = {c: j for j, c in enumerate(cols)}
        hashed = bool(types & {T.ICM, T.ISSE})
        reads = [i for i, cp in enumerate(comps) if cp[0] in _READS]
        rsh = any(self._shared(i) for i in reads)
        rdev = any(not self._shared(i) for i in reads)
        devrows = [i for i in self.rows if not self._shared(i)]
        mixes = [i for i in self.rows if comps[i][0] == T.MIX]
        flags = [(f, t) for f, t in (("icm", T.ICM), ("isse", T.ISSE),
                                     ("cm", T.CM), ("match", T.MATCH),
                                     ("mix2", T.MIX2)) if t in types]

        def any_of(*fs: str) -> str:
            got = [f for f, _ in flags if f in fs]
            return " || ".join(got) if got else "false"

        def sel(cases: List[Tuple[str, str]], last: str) -> str:
            """``f1 ? e1 : f2 ? e2 : ... : last`` over the present flags."""
            out = last
            for f, e in reversed(cases):
                if f in dict(flags):
                    out = f"{f} ? {e} : {out}"
            return out

        def element(i: int, e: int, body: List[str]) -> List[str]:
            """Thread k's e-th element of row i (j = k + e * G), guarded
            where the row ends inside this round."""
            left = self._row_len(i) - e * G
            if left >= G:
                return body
            return [f"if (k < {left}) {{"] + [f"  {b}" for b in body] \
                + ["}"]

        def rowtab(i: int, at: str) -> str:
            """Element ``at`` of row component i's table."""
            if self._shared(i):
                return f"sw[{plan.shared[i]}u + {at}]"
            return f"a32[{self.off32[i]}u + {at}]"

        # members: constants, then the state kept from bit to bit
        members = ["uint32_t k;       // the thread's place in its group, "
                   "its component"]
        members += [f"bool {f};" for f, _ in flags]
        if hashed:
            members += ["uint8_t* ht;     // its ICM/ISSE hash table",
                        "uint32_t hm8, csh;   // the table's row mask, the "
                        "check byte's shift"]
        if rsh:
            members += ["uint32_t tab;    // its u32 table's word offset in "
                        "the lane's region"]
        if rdev:
            members += ["uint32_t* dtab;  // its u32 table in device "
                        "memory"]
            if rsh:
                members += ["bool onsh;       // ... or in the region"]
        if types & {T.CM, T.MIX2}:
            members += ["uint32_t mask;"]
        if T.MIX2 in types:
            members += ["uint32_t cm5, in3;", "int32_t rate;"]
        if types & {T.MIX2, T.ISSE}:
            members += ["uint32_t in2;"]
        if T.CM in types:
            members += ["uint32_t lim;"]
        members += ["uint32_t h;      // its context hash, this byte's",
                    "W4 row;          // ICM/ISSE: the held row; MATCH: ml,"
                    " mb, ma, its byte",
                    "uint32_t rowat;  // ICM/ISSE: the held row's offset "
                    "+ 1 (0: none)",
                    "uint32_t cxt, wa, wb;   // what phase (a) read, for "
                    "phase (c)"]
        # each MIX row's base, and thread k's elements of each shared row
        kept = [(f"b{i}", f"MIX {i}'s row") for i in mixes] + [
            (f"w{i}_{e}", f"its element {e} of {_NAMES[comps[i][0]]} {i}'s "
             "row") for i in self.rows if self._shared(i)
            for e in range(-(-self._row_len(i) // G))]
        members += [f"uint32_t {v};   // {what}, this bit's"
                    for v, what in kept]

        init = ["this->k = uint32_t(k);",
                f"const int32_t* K = phases_fast_k + k * {len(cols)};",
                f"const int32_t ty = K[{col['ty']}];"]
        init += [f"{f} = ty == {t};" for f, t in flags]
        if hashed:
            init += [f"ht = a8 + K[{col['off8']}];",
                     f"hm8 = uint32_t(K[{col['hm8']}]);",
                     f"csh = uint32_t(K[{col['csh']}]);"]
        if rsh:
            init += [f"tab = uint32_t(K[{col['tab']}]);"]
        if rdev:
            init += [f"dtab = a32 + K[{col['off32']}];"]
            if rsh:
                init += [f"onsh = K[{col['onsh']}] != 0;"]
        if types & {T.CM, T.MIX2}:
            init += [f"mask = uint32_t(K[{col['mask']}]);"]
        if T.MIX2 in types:
            init += [f"cm5 = uint32_t(K[{col['cm5']}]);",
                     f"in3 = uint32_t(K[{col['in3']}]);",
                     f"rate = K[{col['rate']}];"]
        if types & {T.MIX2, T.ISSE}:
            init += [f"in2 = uint32_t(K[{col['in2']}]);"]
        if T.CM in types:
            init += [f"lim = uint32_t(K[{col['lim']}]);"]
        if T.CONS in types:
            init += [f"if (ty == {T.CONS}) {{   // a constant: both "
                     "prediction buffers, once",
                     f"  sw[{geo['p']} + k] = uint32_t(K[{col['cons']}]);",
                     f"  sw[{geo['p'] + n} + k] = uint32_t(K[{col['cons']}]"
                     ");", "}"]
        init += ["h = 0u;", "row = W4{0u, 0u, 0u, 0u};",
                 "rowat = cxt = wa = wb = 0u;"]
        init += [f"{v} = 0u;" for v, _ in kept]

        start = [f"h = sw[{geo['h']}u + k];"]
        if T.MATCH in types:
            start += [f"if (match) row = load4(sw + {geo['row']}u + 4u * k);"]

        def rounds(i: int):
            """Thread k's elements of row i: (e, j) with j = k + e * G."""
            return [(e, f"{e * G}u + k" if e else "k")
                    for e in range(-(-self._row_len(i) // G))]

        # phase (a): the rows first, so that their copies overlap the rest;
        # every load of the region before the first store to it
        def copies(i: int, c: str, h: str) -> List[str]:
            """Row i of partial byte ``c`` and context ``h`` into thread
            k's registers (a shared table) or its copy in the region
            (cp.async from device memory)."""
            cp = comps[i]
            rs = plan.rows[i]
            if cp[0] == T.MIX:
                b = f"b{i}"
                out = [f"b{i} = (({h} + ({c} & {cp[5]}u)) & "
                       f"{(1 << cp[1]) - 1}u) * {cp[3]}u;"]
            else:
                b = f"r{i}"
                out = [f"const uint32_t r{i} = (({h} + {c}) * 32u) & "
                       f"{(32 << cp[1]) - 1}u;"]
            for e, j in rounds(i):
                if self._shared(i):
                    left = self._row_len(i) - e * G
                    out += [f"w{i}_{e} = " + (
                        f"{rowtab(i, f'{b} + {j}')};" if left >= G else
                        f"k < {left} ? {rowtab(i, f'{b} + {j}')} : 0u;")]
                else:
                    out += element(i, e, [
                        f"copy_async(sw + {rs}u + {j}, a32 + "
                        f"{self.off32[i]}u + {b} + {j});"])
            return out

        pa = ["if (c8 == 1u) byte_start(sw);"]
        for i in self.rows:
            pa.append(f"const uint32_t h{i} = sw[{geo['h']}u + {i}u];")
        for i in self.rows:
            cp = comps[i]
            pa.append(f"// {_NAMES[cp[0]]} {i}: its row of {self._row_len(i)}"
                      f" into the region at {plan.rows[i]}"
                      + ("" if self._shared(i) else ", by cp.async"))
            pa += copies(i, "c8", f"h{i}")
        if hashed:
            pa += ["if (c8 == 1u || (c8 & 0xf0u) == 16u) {   // a nibble: "
                   "the ICM/ISSE row",
                   f"  if ({any_of('icm', 'isse')}) fetch(h + 16u * c8);",
                   "}",
                   "const uint32_t s8 = row_byte(row, hmap4 & 15u);"]
        idx = sel([("cm", "(h ^ hmap4) & mask"),
                   ("mix2", "(h + (c8 & cm5)) & mask"),
                   ("isse", "s8 * 2u")], "s8" if hashed else "0u")
        if reads:
            pa += [f"const uint32_t idx = {idx};",
                   "uint32_t v0 = 0u, v1 = 0u;"]
            rd = any_of(*[f for f, t in flags if t in _READS])
            if rsh:
                cond = f"({rd}) && onsh" if rdev else rd
                pa += [f"if ({cond}) {{   // its table in the region: the "
                       "even-odd pair",
                       "  const W2 q = load2(sw + tab + (idx & ~1u));",
                       "  v0 = (idx & 1u) ? q.y : q.x;",
                       "  v1 = q.y;", "}"]
            if rdev:
                cond = f"({rd}) && !onsh" if rsh else rd
                pa += [f"if ({cond}) {{   // its table in device memory",
                       "  v0 = dtab[idx];"]
                if T.ISSE in types:
                    pa += ["  if (isse) v1 = dtab[idx + 1u];"]
                pa += ["}"]
            pa += ["wa = v0;", "wb = v1;"]
        pout = [f for f, t in flags if t in (T.CM, T.ICM, T.MATCH)]
        if T.MATCH in types:
            pa += ["const uint32_t mc = (row.w >> (7 - bit)) & 1u;"]
        if pout:
            sx = sel([("cm", "v0 >> 17"), ("icm", "v0 >> 8")],
                     "uint32_t(dt2k[row.z & 255u] * (1 - 2 * int32_t(mc))) "
                     "& 32767u" if T.MATCH in types else "0u")
            pa += [f"const uint32_t sx = {sx};",
                   "const int32_t sp = stretch(st, sx);"]
        # the stores: the shared rows' copies, the prediction, the weights
        for i in self.rows:
            if self._shared(i):
                for e, j in rounds(i):
                    pa += element(i, e, [f"sw[{plan.rows[i]}u + {j}] = "
                                         f"w{i}_{e};"])
        if pout:
            pv = "(match && row.z == 0u) ? 0 : sp" if T.MATCH in types \
                else "sp"
            pa += [f"if ({any_of(*pout)}) p[k] = {pv};"]
        if types & {T.ISSE, T.MIX2}:
            pa += [f"if ({any_of('isse', 'mix2')}) sw[{geo['wa']}u + k] "
                   "= v0;   // for the combine"]
        if T.ISSE in types:
            pa += [f"if (isse) sw[{geo['wb']}u + k] = v1;"]
        if reads or T.MATCH in types:
            pa += ["cxt = " + sel([("match", "mc"), ("icm", "s8"),
                                   ("isse", "s8")],
                                  "idx" if reads else "0u") + ";"]
        if devrows:
            pa += ["copy_wait();"]

        # phase (c): the loads of its component and of the rows, then what
        # they compute, then the stores
        ld: List[str] = []
        calc: List[str] = []
        st: List[str] = []
        if reads or mixes:
            ld += ["const int32_t ey = y * 32767;"]
        if hashed:
            ld += ["const uint32_t j4 = hmap4 & 15u;",
                   "const uint32_t sn = sns[(cxt & 255u) * 4u + "
                   "uint32_t(y)];"]
        if types & {T.ISSE, T.MIX2}:
            ld += ["const int32_t pk = p[k];",
                   "const uint32_t x2 = uint32_t(p[in2]);"]
            # (a thread past the last component reads another buffer's word
            # as its prediction: kept inside squash, its err unused)
            calc += ["const uint32_t err = uint32_t(ey - sq[(pk + 2048) & "
                     "4095]);"]
        if T.MIX2 in types:
            ld += ["const uint32_t x3 = uint32_t(p[in3]);"]
        if T.CM in types:
            ld += ["const uint32_t dc = dt[wa & 1023u];"]
        if reads:
            if T.ISSE in types:
                calc += ["const uint32_t isse0 = uint32_t(clamp512k("
                         "int32_t(wa) + (int32_t(err * x2 + 4096u) >> 13)));",
                         "const uint32_t isse1 = uint32_t(clamp512k("
                         "int32_t(wb) + ((int32_t(err) + 16) >> 5)));"]
            if T.MIX2 in types:
                calc += ["int32_t w = int32_t(wa) + (int32_t(uint32_t(int32_t("
                         "err * uint32_t(rate)) >> 5) * (x2 - x3) + 4096u) >> "
                         "13);",
                         "w = w < 0 ? 0 : (w > 65535 ? 65535 : w);"]
            new0 = sel([("cm", "trained(dc, wa, y, lim)"),
                        ("icm", "wa + uint32_t((ey - int32_t(wa >> 8)) >> 2)"),
                        ("isse", "isse0")],
                       "uint32_t(w)" if T.MIX2 in types else "0u")
            at = "cxt * 2u" if T.ISSE in types else "cxt"
            if T.ISSE in types and len([t for _, t in flags
                                        if t in _READS]) > 1:
                at = "isse ? cxt * 2u : cxt"
            calc += [f"const uint32_t new0 = {new0};",
                     f"const uint32_t at = {at};"]
            rd = any_of(*[f for f, t in flags if t in _READS])
            if rsh:
                cond = f"({rd}) && onsh" if rdev else rd
                st += [f"if ({cond}) sw[tab + at] = new0;"]
                if T.ISSE in types:
                    st += [f"if (isse{' && onsh' if rdev else ''}) "
                           "sw[tab + at + 1u] = isse1;"]
            if rdev:
                cond = f"({rd}) && !onsh" if rsh else rd
                st += [f"if ({cond}) dtab[at] = new0;"]
                if T.ISSE in types:
                    st += [f"if (isse{' && !onsh' if rsh else ''}) "
                           "dtab[at + 1u] = isse1;"]
        if hashed:
            st += [f"if ({any_of('icm', 'isse')}) set_row_byte(row, j4, sn);"]
        if T.MATCH in types:
            st += ["if (match && row.z != 0u && int32_t(cxt) != y) {",
                   "  row.z = 0u;",
                   f"  sw[{geo['row']}u + 4u * k + 2u] = 0u;   // for its "
                   "byte end", "}"]
        for i in self.rows:
            cp = comps[i]
            rs = plan.rows[i]
            if cp[0] == T.MIX:
                ld += [f"const int32_t q{i} = p[{i}];   // MIX {i}"]
                calc += [f"const int32_t e{i} = ((ey - sq[q{i} + 2048]) * "
                         f"{cp[4]}) >> 4;"]
                for e, j in rounds(i):
                    x = f"{cp[2] + e * G}u + k" if cp[2] + e * G else "k"
                    ld += [f"const int32_t x{i}_{e} = p[{x}];"]
                    if not self._shared(i):
                        # a round the row ends in reads no word past it
                        left = self._row_len(i) - e * G
                        at = f"sw[{rs}u + {j}]"
                        ld += [f"const uint32_t w{i}_{e} = " + (
                            f"{at};" if left >= G else
                            f"k < {left} ? {at} : 0u;")]
                    st += element(i, e, [
                        f"{rowtab(i, f'b{i} + {j}')} = uint32_t(clamp512k("
                        f"int32_t(w{i}_{e}) + ((e{i} * x{i}_{e} + 4096) >> "
                        "13)));"])
            else:
                # the counter its interpolation chose, by the thread that
                # copied it: one of the thread's own elements
                ld += [f"const uint32_t sc{i} = sw[{geo['cxt']}u + {i}u];   "
                       f"// SSE {i}"]
                own = []
                for e, j in rounds(i):
                    if not self._shared(i):
                        ld += [f"const uint32_t w{i}_{e} = sw[{rs}u + {j}];"]
                    own.append(f"w{i}_{e}")
                lg = G.bit_length() - 1
                pick = own[-1]
                for e in range(len(own) - 2, -1, -1):
                    pick = (f"((sc{i} & 31u) >> {lg}) == {e}u ? {own[e]} : "
                            f"{pick}")
                calc += [f"const uint32_t s{i} = {pick};",
                         f"const uint32_t d{i} = dt[s{i} & 1023u];"]
                st += [f"if (((sc{i} & 31u) & {G - 1}u) == k)",
                       f"  {rowtab(i, f'(sc{i} & {(32 << cp[1]) - 1}u)')} = "
                       f"trained(d{i}, s{i}, y, {cp[4] * 4}u);"]
        pc = ld + calc + st

        kinds = ", ".join(f"{_NAMES[cp[0]]} {i}" for i, cp in enumerate(comps))
        table_text = ",\n    ".join(", ".join(map(str, r)) for r in table)
        ind = lambda lines, d: [" " * d + x for x in lines]   # noqa: E731
        helpers = _HELPERS.splitlines()
        return "\n".join(
            ["// Phases (a) and (c) specialised by zpaqfranz_tpu_torch/ops/"
             "phases_fast.py",
             f"// for {n} components on G = {G} threads, "
             f"{plan.lanes_per_block} lanes a block:",
             f"// {kinds}",
             "#pragma once",
             "#include <stdint.h>",
             "#ifndef __CUDACC__",
             "#define __constant__",
             "#endif",
             "",
             "// the kernels' launch bounds: this unit's own block",
             f"#define CM_BLOCK_THREADS {self.block}",
             "",
             "// each thread's constants, one row a thread: "
             + ", ".join(cols),
             f"__constant__ int32_t phases_fast_k[{G * len(cols)}] = {{",
             f"    {table_text}}};",
             "",
             "// One thread's phases, csrc/cm_model.cuh phase_a and phase_c",
             "// with the model and its placement compiled in: sw the lane's",
             "// region, a8 and a32 its u8 and u32 arenas, p the bit's",
             "// predictions; c8, hmap4 and bit the lane's place in the byte;",
             "// st stretch below 16384, dt2k MATCH's 2048 / length, sq",
             "// squash at sq[x + 2048], sns the state table, dt the",
             "// counters' steps.",
             "struct PhasesFast {",
             f"  static constexpr int n = {n}, G = {G};"]
            + ind(helpers, 2)
            + ind(members, 2)
            + ["",
               "  __device__ __forceinline__ void init(int32_t k, uint32_t* "
               "sw, uint8_t* a8,",
               "                                       uint32_t* a32) {"]
            + ind(init, 4)
            + ["  }",
               "",
               "  // a byte's start: the contexts HCOMP wrote, MATCH's state "
               "after its byte end",
               "  __device__ __forceinline__ void byte_start(const uint32_t* "
               "sw) {"]
            + ind(start, 4)
            + ["  }"]
            + ([] if not hashed else [
                "",
                "  // the nibble's ICM/ISSE row: the held one written back, "
                "then the",
                "  // three candidates of find() in flight at once",
                "  __device__ __forceinline__ void fetch(uint32_t cx) {",
                "    if (rowat) store4(ht + rowat - 1u, row);",
                "    const uint32_t chk = (cx >> csh) & 255u;",
                "    const uint32_t h0 = (cx * 16u) & hm8;",
                "    const W4 r0 = load4(ht + h0), r1 = load4(ht + (h0 ^ "
                "16u)),",
                "             r2 = load4(ht + (h0 ^ 32u));",
                "    const bool m0 = (r0.x & 255u) == chk, m1 = (r1.x & 255u)"
                " == chk,",
                "               m2 = (r2.x & 255u) == chk;",
                "    const uint32_t q0 = (r0.x >> 8) & 255u, q1 = (r1.x >> 8)"
                " & 255u,",
                "                   q2 = (r2.x >> 8) & 255u;",
                "    const uint32_t low = (q0 <= q1 && q0 <= q2) ? h0",
                "                         : (q1 < q2 ? h0 ^ 16u : h0 ^ 32u);",
                "    const uint32_t at = m0 ? h0 : m1 ? (h0 ^ 16u) : m2 ? "
                "(h0 ^ 32u) : low;",
                "    row = m0 ? r0 : m1 ? r1 : m2 ? r2 : W4{chk, 0u, 0u, 0u};",
                "    rowat = at + 1u;",
                "  }"])
            + ["",
               "  // phase (a)",
               "  __device__ __forceinline__ void a(",
               "      uint32_t* __restrict__ sw, const uint32_t* __restrict__ "
               "a32,",
               "      int32_t* __restrict__ p, uint32_t c8, uint32_t hmap4, "
               "int bit,",
               "      const short* __restrict__ st, const short* __restrict__ "
               "dt2k) {"]
            + ind(pa, 4)
            + ["  }",
               "",
               "  // phase (c), toward bit y",
               "  __device__ __forceinline__ void c(",
               "      uint32_t* __restrict__ sw, uint32_t* __restrict__ a32,",
               "      const int32_t* __restrict__ p, uint32_t c8, uint32_t "
               "hmap4, int y,",
               "      const short* __restrict__ sq, const uint8_t* "
               "__restrict__ sns,",
               "      const uint32_t* __restrict__ dt) {"]
            + ind(pc, 4)
            + ["  }", "};", ""])

    def cuda_source(self) -> str:
        """The phases as ``struct PhasesFast``: ``init``, ``byte_start``,
        ``a`` and ``c``, phase_a / phase_c's results."""
        return self._source


_HELPERS = r"""struct W4 { uint32_t x, y, z, w; };
struct W2 { uint32_t x, y; };
__device__ __forceinline__ static W4 load4(const uint8_t* a) {
#ifdef __CUDACC__
  const uint4 v = *reinterpret_cast<const uint4*>(a);
  return W4{v.x, v.y, v.z, v.w};
#else
  const uint32_t* w = reinterpret_cast<const uint32_t*>(a);
  return W4{w[0], w[1], w[2], w[3]};
#endif
}
__device__ __forceinline__ static W4 load4(const uint32_t* a) {
  return load4(reinterpret_cast<const uint8_t*>(a));
}
__device__ __forceinline__ static void store4(uint8_t* a, const W4& r) {
#ifdef __CUDACC__
  *reinterpret_cast<uint4*>(a) = make_uint4(r.x, r.y, r.z, r.w);
#else
  uint32_t* w = reinterpret_cast<uint32_t*>(a);
  w[0] = r.x; w[1] = r.y; w[2] = r.z; w[3] = r.w;
#endif
}
__device__ __forceinline__ static W2 load2(const uint32_t* a) {
#ifdef __CUDACC__
  const uint2 v = *reinterpret_cast<const uint2*>(a);
  return W2{v.x, v.y};
#else
  return W2{a[0], a[1]};
#endif
}
// a 4-byte copy from device memory into the region, in the background
__device__ __forceinline__ static void copy_async(uint32_t* dst,
                                                  const uint32_t* src) {
#ifdef __CUDACC__
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   uint32_t(__cvta_generic_to_shared(dst))), "l"(src)
               : "memory");
#else
  *dst = *src;
#endif
}
__device__ __forceinline__ static void copy_wait() {
#ifdef __CUDACC__
  asm volatile("cp.async.wait_all;\n" ::: "memory");
#endif
}
__device__ __forceinline__ static uint32_t row_byte(const W4& r, uint32_t j) {
  const uint32_t w = j < 8 ? (j < 4 ? r.x : r.y) : (j < 12 ? r.z : r.w);
  return (w >> (8 * (j & 3))) & 255u;
}
__device__ __forceinline__ static void set_row_byte(W4& r, uint32_t j,
                                                    uint32_t v) {
  const uint32_t sh = 8 * (j & 3);
  const uint32_t keep = ~(255u << sh), put = (v & 255u) << sh;
  if (j < 4) r.x = (r.x & keep) | put;
  else if (j < 8) r.y = (r.y & keep) | put;
  else if (j < 12) r.z = (r.z & keep) | put;
  else r.w = (r.w & keep) | put;
}
__device__ __forceinline__ static int32_t stretch(const short* st,
                                                  uint32_t x) {
  return x < 16384 ? st[x] : -st[32767 - x];
}
__device__ __forceinline__ static int32_t clamp512k(int32_t x) {
  return x < -(1 << 19) ? -(1 << 19) : (x > (1 << 19) - 1 ? (1 << 19) - 1 : x);
}
// a counter trained toward bit y (csrc/cm_model.cuh trained), its step
// d = dt[pn & 1023] read ahead
__device__ __forceinline__ static uint32_t trained(uint32_t d, uint32_t pn,
                                                   int y, uint32_t limit) {
  const uint32_t count = pn & 1023u;
  const int32_t error = y * 32767 - int32_t(pn >> 17);
  return pn + ((uint32_t(error) * d) & 0xFFFFFC00u) + (count < limit);
}"""


_CACHE: Dict[Tuple, Optional[PhasesFast]] = {}


def try_compile(model: Model, plan, layout) -> Optional[PhasesFast]:
    """The specialised phases of the model at placement ``plan`` with the
    u32 offsets of ``layout``, or None where the generator refuses it (the
    kernels then run the generic phases)."""
    key = (tuple(tuple(c) for c in model.comps), plan.G,
           plan.lanes_per_block, tuple(sorted(plan.geo.items())),
           tuple(sorted(plan.shared.items())),
           tuple(sorted(plan.rows.items())), tuple(plan.off8))
    if key not in _CACHE:
        with trace.span("kernel.build", unit="phases"):
            try:
                _CACHE[key] = PhasesFast(model, plan, layout)
            except _Refused:
                _CACHE[key] = None
    return _CACHE[key]
