"""The combine as straight-line code: the per-model combine specialiser.

Phase (b) of a CM lane kernel (``csrc/cm_model.cuh``) is the combine: thread
0 of the lane's group walks the model's AVG, MIX2, MIX, ISSE and SSE
components in order, each mixing predictions that earlier components made.
``phase_b`` does it generically: for every step it loads a packed
descriptor, the step's weights and inputs at addresses the descriptor
gives, dispatches on the type and runs MIX's dot product as a loop of
run-time length. Every one of those loads puts a dependent shared-memory
access on the bit's chain.

Here the combine of one model becomes ``struct CombineFast``, a
``__device__`` function with every step index, type, input, MIX length,
row-copy offset and AVG weight a compile-time constant: no descriptor, no
dispatch, no loop. What does not depend on the bit (each ISSE's and MIX2's
weights, the MIX weight rows, the predictions phase (a) made, an SSE's
context) is loaded ahead of the chain; each step's output stays in a
register for the steps that read it; a MIX sums the terms of inputs known
early first (in ``uint32``, exact in any order), so that only the last
arrivals wait on the chain. SSE's two interpolation loads and the squash
and stretch lookups stay on the chain, as in ``phase_b``. The result and
the side effects are ``phase_b``'s bit for bit: ``p[i]`` of every step (for
phase (c)) and each SSE's context ``cxt[i]``.

``ops/build.py`` compiles the text into the same per-model unit as the
HCOMP program (``ops/hcomp_fast.py``), ahead of the kernel's source
(``CM_COMBINE_FAST``). A combine of more than ``MAX_TERMS`` terms (a step,
or one input of a MIX) is refused, and the kernels run ``phase_b``: a
coverage choice made from the model, never a correctness one. So is a
model whose inputs lie outside its components.
"""

from __future__ import annotations

import re
from typing import Dict, List, Mapping, Optional, Tuple

from .. import trace
from ..models import tables as T
from ..zpaql.header import Model

#: the most terms (a step, or one input of a MIX) a specialised combine
#: has; past it straight-line code grows past what the kernels' registers
#: hold, and the kernels run the generic combine
MAX_TERMS = 512

_NAMES = {T.AVG: "AVG", T.MIX2: "MIX2", T.MIX: "MIX", T.ISSE: "ISSE",
          T.SSE: "SSE"}


class _Refused(Exception):
    pass


def inputs(cp: Tuple[int, ...]) -> List[int]:
    """The components a combine step of parameters ``cp`` reads."""
    t = cp[0]
    if t == T.AVG:
        return [cp[1], cp[2]]
    if t == T.MIX2:
        return [cp[2], cp[3]]
    if t == T.MIX:
        return list(range(cp[2], cp[2] + cp[3]))
    return [cp[2]]                       # ISSE, SSE


def terms(model: Model) -> int:
    """The combine's terms: a step each, plus a MIX's inputs."""
    return sum(1 + (cp[3] if cp[0] == T.MIX else 0) for cp in model.comps
               if cp[0] in _NAMES)


class CombineFast:
    """The specialised combine of one model. ``rows`` maps each MIX and SSE
    component to the word offset of its row copy in the lane's shared
    region (``cm_model.Placement.rows``). Construction generates the code,
    so every refusal fires here."""

    def __init__(self, model: Model, rows: Mapping[int, int]):
        self.n = model.n
        comps = [tuple(c) for c in model.comps]
        if not self.n:
            raise _Refused("no components: no CM lane")
        self.steps = [i for i, cp in enumerate(comps) if cp[0] in _NAMES]
        self.terms = terms(model)
        if self.terms > MAX_TERMS:
            raise _Refused(f"{self.terms} terms, past {MAX_TERMS}")
        for i in self.steps:
            if any(not 0 <= j < self.n for j in inputs(comps[i])):
                raise _Refused(f"component {i} reads outside the model")
            if comps[i][0] in (T.MIX, T.SSE) and i not in rows:
                raise _Refused(f"component {i} has no row copy")
        self.comps = comps
        self.rows = dict(rows)
        self._source = self._generate()

    # ---- the code generator ---------------------------------------------
    def _generate(self) -> str:
        comps, steps = self.comps, set(self.steps)
        loads: List[str] = []
        body: List[str] = []
        loaded: Dict[int, str] = {}
        #: steps between a component's output and the loads (0: loaded)
        depth: Dict[int, int] = {}

        def value(j: int, i: int) -> str:
            """p[j] as step i reads it: an earlier step's register, else
            the prediction phase (a) stored."""
            if j in steps and j < i:
                return f"v{j}"
            if j not in loaded:
                loaded[j] = f"x{j}"
                loads.append(f"const i32 x{j} = p[{j}];")
            return loaded[j]

        def level(j: int, i: int) -> int:
            return depth[j] if j in steps and j < i else 0

        for i in self.steps:
            cp = comps[i]
            t = cp[0]
            ins = inputs(cp)
            depth[i] = 1 + max(level(j, i) for j in ins)
            body.append(f"// {i}: {_NAMES[t]} of "
                        + ", ".join(map(str, ins[:4]))
                        + (f" ... {ins[-1]}" if len(ins) > 4 else ""))
            if t == T.ISSE:
                loads.append(f"const i32 a{i} = i32(wa[{i}]), "
                             f"b{i} = i32(wb[{i}]);")
                body.append(f"const i32 v{i} = clamp2k((a{i} * "
                            f"{value(cp[2], i)} + b{i} * 64) >> 16);")
            elif t == T.MIX2:
                loads.append(f"const i32 a{i} = i32(wa[{i}]);")
                body.append(f"const i32 v{i} = (a{i} * {value(cp[2], i)} "
                            f"+ (65536 - a{i}) * {value(cp[3], i)}) >> 16;")
            elif t == T.AVG:
                body.append(f"const i32 v{i} = ({value(cp[1], i)} * {cp[3]} "
                            f"+ {value(cp[2], i)} * {256 - cp[3]}) >> 8;")
            elif t == T.MIX:
                off = self.rows[i]
                m = cp[3]
                # weights as whole 16-byte words where the row is aligned
                for k in range(0, m - m % 4 if off % 4 == 0 else 0, 4):
                    loads.append(f"const W4 q{i}_{k} = load4(sw + "
                                 f"{off + k});")
                    loads += [f"const i32 w{i}_{k + e} = i32(q{i}_{k}.{f}) "
                              f">> 8;" for e, f in enumerate("xyzw")]
                for k in range(m - m % 4 if off % 4 == 0 else 0, m):
                    loads.append(f"const i32 w{i}_{k} = i32(sw[{off + k}]) "
                                 f">> 8;")
                # the terms whose inputs are known earliest first
                order = sorted(range(m), key=lambda k: level(ins[k], i))
                prods = [f"u32(w{i}_{k}) * u32({value(ins[k], i)})"
                         for k in order]
                body.append(f"const u32 s{i} = " + "\n        + ".join(prods)
                            + ";" if prods else f"const u32 s{i} = 0u;")
                body.append(f"const i32 v{i} = clamp2k(i32(s{i}) >> 8);")
            else:                                            # SSE
                off = self.rows[i]
                loads.append(f"const u32 k{i} = (h[{i}] + c8) * 32u;")
                x = value(cp[2], i)
                body += [
                    f"i32 q{i} = {x} + 992;",
                    f"q{i} = q{i} < 0 ? 0 : (q{i} > 1983 ? 1983 : q{i});",
                    f"const i32 e{i} = q{i} & 63;",
                    f"q{i} >>= 6;",
                    f"const i32 v{i} = stretch(st, u32((i32(sw[{off} + q{i}]"
                    f" >> 10) * (64 - e{i}) + i32(sw[{off + 1} + q{i}] >> "
                    f"10) * e{i}) >> 13));",
                    f"cxt[{i}] = k{i} + u32(q{i}) + u32(e{i} >> 5);"]
            body.append(f"p[{i}] = v{i};")
        last = self.n - 1
        out = f"v{last}" if last in steps else value(last, self.n)
        body.append(f"return sq[{out} + 2048];")
        kinds = ", ".join(f"{_NAMES[comps[i][0]]} {i}" for i in self.steps)
        return "\n".join([
            "// The combine specialised by zpaqfranz_tpu_torch/ops/"
            "combine_fast.py",
            f"// for {self.n} components, {len(self.steps)} steps, "
            f"{self.terms} terms:",
            f"// {kinds or 'no steps'}",
            "#pragma once",
            "#include <stdint.h>",
            "",
            "// One bit's combine, csrc/cm_model.cuh phase_b with the model's",
            "// steps compiled in: p the predictions (stretched; each step's",
            "// stored), wa and wb the weights phase (a) read, sw the lane's",
            "// shared region (MIX and SSE row copies), cxt the SSE contexts,",
            "// h the component contexts, c8 the bit's partial byte, sq",
            "// squash at sq[x + 2048], st stretch below 16384. Returns",
            "// P(1) in 1/4096 units.",
            "struct CombineFast {",
            f"  static constexpr int n = {self.n};",
            "  struct W4 { uint32_t x, y, z, w; };",
            "  __device__ __forceinline__ static W4 load4(const uint32_t* a)"
            " {",
            "#ifdef __CUDACC__",
            "    const uint4 v = *reinterpret_cast<const uint4*>(a);",
            "    return {v.x, v.y, v.z, v.w};",
            "#else",
            "    return {a[0], a[1], a[2], a[3]};",
            "#endif",
            "  }",
            "  __device__ __forceinline__ static int32_t clamp2k(int32_t x) {",
            "    return x < -2048 ? -2048 : (x > 2047 ? 2047 : x);",
            "  }",
            "  __device__ __forceinline__ static int32_t stretch(",
            "      const short* __restrict__ st, uint32_t x) {",
            "    return x < 16384 ? st[x] : -st[32767 - x];",
            "  }",
            "  __device__ __forceinline__ static int32_t run(",
            "      int32_t* __restrict__ p, const uint32_t* __restrict__ wa,",
            "      const uint32_t* __restrict__ wb,",
            "      const uint32_t* __restrict__ sw, uint32_t* __restrict__ "
            "cxt,",
            "      const uint32_t* __restrict__ h, uint32_t c8,",
            "      const short* __restrict__ sq, const short* __restrict__ "
            "st) {",
        ] + [f"    typedef {c}int32_t {c or 'i'}32;" for c in ("", "u")
             if re.search(rf"\b{c or 'i'}32\b", "\n".join(loads + body))]
            + [f"    {line}" for text in (loads, body)
               for line in "\n".join(text).splitlines()]
            + ["  }", "};", ""])

    def cuda_source(self) -> str:
        """The combine as ``struct CombineFast``: ``run(p, wa, wb, sw, cxt,
        h, c8, sq, st)``, phase_b's result and side effects."""
        return self._source


_CACHE: Dict[Tuple, Optional[CombineFast]] = {}


def try_compile(model: Model, rows: Mapping[int, int]
                ) -> Optional[CombineFast]:
    """The specialised combine of the model with MIX and SSE row copies at
    ``rows``, or None where the generator refuses it (the kernels then run
    the generic combine)."""
    key = (tuple(tuple(c) for c in model.comps), tuple(sorted(rows.items())))
    if key not in _CACHE:
        with trace.span("kernel.build", unit="combine"):
            try:
                _CACHE[key] = CombineFast(model, rows)
            except _Refused:
                _CACHE[key] = None
    return _CACHE[key]
