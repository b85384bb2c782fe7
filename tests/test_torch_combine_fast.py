"""The port's combine specialiser
(``zpaqfranz_tpu_torch/ops/combine_fast.py``): the generated ``struct
CombineFast`` compiled with g++ (``__device__`` defined away) against a
mirror of ``csrc/cm_model.cuh``'s generic ``phase_b`` over random
predictions, weights, SSE rows and contexts, for every preset and a
model of every component type; the mirror against the scalar predictor;
which models the generator takes, its cap, the build unit that holds the
generated code, and the kernels' placement, which the combine leaves as
it was. Every comparison is exact."""

import subprocess

import numpy as np
import pytest

from zpaqfranz_tpu_torch.codec.methods import ALL_COMPONENTS_CFG, make_model
from zpaqfranz_tpu_torch.models import tables as T
from zpaqfranz_tpu_torch.ops import build
from zpaqfranz_tpu_torch.ops import combine_fast as cf
from zpaqfranz_tpu_torch.ops import hcomp_fast as hf
from zpaqfranz_tpu_torch.ops import phases_fast as pf
from zpaqfranz_tpu_torch.ops.cm_model import (_BIGLUT, SQ_OFF, STR_OFF,
                                              Layout, Placement,
                                              combine_step, kernel_unit)
from zpaqfranz_tpu_torch.zpaql.compiler import compile_config

M32 = 0xFFFFFFFF
TRIALS = 300
PRESETS = ["3", "4", "5", "3.0", "4.0", "5.0", "5.1"]


def _cfg_mixes(consts: int, mixes: int) -> str:
    """``consts`` CONST components, then ``mixes`` MIXes over all of them:
    ``mixes * (consts + 1)`` terms."""
    lines = [f"comp 9 16 0 0 {consts + mixes}"]
    lines += [f"  {i} const {(37 * i) % 256}" for i in range(consts)]
    lines += [f"  {consts + k} mix 0 0 {consts} 24 255" for k in range(mixes)]
    return "\n".join(lines + ["hcomp", "  halt", "post 0 end", ""])


#: a combine of exactly ``MAX_TERMS`` terms (4 MIXes of 127 inputs: rows of
#: an odd length), and one past it (5)
AT_CAP = _cfg_mixes(127, 4)
PAST_CAP = _cfg_mixes(127, 5)


def _model(name: str):
    if name == "cfg":
        return compile_config(ALL_COMPONENTS_CFG)[0]
    if name == "cap":
        return compile_config(AT_CAP)[0]
    return make_model(name)[0]


def _i32(x: int) -> int:
    x &= M32
    return x - (1 << 32) if x >> 31 else x


def _clamp2k(x: int) -> int:
    return -2048 if x < -2048 else (2047 if x > 2047 else x)


def generic_combine(comps, rows, p, wa, wb, sw, h, c8, sq, st):
    """``phase_b`` of ``csrc/cm_model.cuh`` in Python, step by step over
    ``p`` in place: returns P(1), the predictions after the combine and the
    SSE contexts it wrote."""
    p = [int(v) for v in p]
    cxt = {}

    def stretch(x: int) -> int:
        return int(st[x]) if x < 16384 else -int(st[32767 - x])

    for i, cp in enumerate(comps):
        t = cp[0]
        if t == T.ISSE:
            v = _clamp2k((_i32(wa[i]) * p[cp[2]] + _i32(wb[i]) * 64) >> 16)
        elif t == T.MIX:
            s = 0
            for j in range(cp[3]):
                s = (s + (_i32(sw[rows[i] + j]) >> 8) * p[cp[2] + j]) & M32
            v = _clamp2k(_i32(s) >> 8)
        elif t == T.MIX2:
            a = _i32(wa[i])
            v = (a * p[cp[2]] + (65536 - a) * p[cp[3]]) >> 16
        elif t == T.AVG:
            v = (p[cp[1]] * cp[3] + p[cp[2]] * (256 - cp[3])) >> 8
        elif t == T.SSE:
            pq = min(max(p[cp[2]] + 992, 0), 1983)
            wt = pq & 63
            pq >>= 6
            r = rows[i]
            v = stretch(((int(sw[r + pq]) >> 10) * (64 - wt)
                         + (int(sw[r + pq + 1]) >> 10) * wt) >> 13)
            cxt[i] = ((int(h[i]) + c8) * 32 + pq + (wt >> 5)) & M32
        else:
            continue
        p[i] = v
    return int(sq[p[-1] + 2048]), p, cxt


def _inputs(model, rows, rng):
    """Random states of one bit as phase (a) leaves them: predictions in
    the stretched domain, ISSE weight pairs and MIX weights as phase (c)
    clamps them, MIX2 weights in 0..65535, SSE counters of any value, and
    any contexts and partial byte."""
    n = model.n
    words = max([off + (cp[3] if cp[0] == T.MIX else 32)
                 for i, cp in enumerate(model.comps)
                 for off in [rows.get(i)] if off is not None] + [1])
    p = rng.integers(-2048, 2048, (TRIALS, n))
    wa = rng.integers(-(1 << 19), 1 << 19, (TRIALS, n))
    wb = rng.integers(-(1 << 19), 1 << 19, (TRIALS, n))
    sw = rng.integers(0, 1 << 32, (TRIALS, words))
    # the extremes, so that every clamp fires at both ends
    p[0] = 2047
    p[1] = -2048
    wa[2] = (1 << 19) - 1
    wa[3] = -(1 << 19)
    for i, cp in enumerate(model.comps):
        if cp[0] == T.MIX2:
            wa[:, i] = rng.integers(0, 65536, TRIALS)
        if cp[0] == T.MIX:
            sw[:, rows[i]: rows[i] + cp[3]] = rng.integers(
                -(1 << 19), 1 << 19, (TRIALS, cp[3])) & M32
    h = rng.integers(0, 1 << 32, (TRIALS, n))
    c8 = rng.integers(1, 256, TRIALS)
    return p, wa & M32, wb & M32, sw, h, c8


HARNESS = r"""
#include <cstdio>
#include <cstdint>
#include <vector>
#define __device__
#define __forceinline__ inline
#include "combine.cuh"
int main(int argc, char** argv) {
  const int T = %(T)d, N = CombineFast::n, W = %(W)d;
  std::vector<short> sq(4096), st(16384);
  std::vector<int32_t> p(T * N);
  std::vector<uint32_t> wa(T * N), wb(T * N), sw(T * W), h(T * N), c8(T);
  FILE* in = std::fopen(argv[1], "rb");
  if (!in) return 2;
  std::fread(sq.data(), 2, 4096, in);
  std::fread(st.data(), 2, 16384, in);
  std::fread(p.data(), 4, T * N, in);
  std::fread(wa.data(), 4, T * N, in);
  std::fread(wb.data(), 4, T * N, in);
  std::fread(sw.data(), 4, T * W, in);
  std::fread(h.data(), 4, T * N, in);
  if (std::fread(c8.data(), 4, T, in) != size_t(T)) return 3;
  std::fclose(in);
  FILE* out = std::fopen(argv[2], "wb");
  for (int t = 0; t < T; ++t) {
    std::vector<uint32_t> cxt(N, 0);
    const int32_t pr = CombineFast::run(
        p.data() + t * N, wa.data() + t * N, wb.data() + t * N,
        sw.data() + t * W, cxt.data(), h.data() + t * N, c8[t], sq.data(),
        st.data());
    std::fwrite(&pr, 4, 1, out);
    std::fwrite(p.data() + t * N, 4, N, out);
    std::fwrite(cxt.data(), 4, N, out);
  }
  std::fclose(out);
  return 0;
}
"""


@pytest.mark.parametrize("name", PRESETS + ["cfg", "cap"])
def test_generated_combine_matches_generic(name, tmp_path):
    """``struct CombineFast`` compiled with g++ gives, over random states of
    a bit, what the generic combine gives: P(1), every step's prediction
    stored for phase (c), and each SSE's context."""
    model = _model(name)
    rows = Placement(model, "fast").rows
    fast = cf.try_compile(model, rows)
    assert fast is not None
    rng = np.random.default_rng(sum(map(ord, name)))
    p, wa, wb, sw, h, c8 = _inputs(model, rows, rng)
    sq = _BIGLUT[SQ_OFF: SQ_OFF + 4096].astype(np.int16)
    st = _BIGLUT[STR_OFF: STR_OFF + 16384].astype(np.int16)
    (tmp_path / "combine.cuh").write_text(fast.cuda_source())
    (tmp_path / "h.cpp").write_text(HARNESS % {"T": TRIALS,
                                               "W": sw.shape[1]})
    (tmp_path / "in.bin").write_bytes(b"".join([
        sq.tobytes(), st.tobytes(), p.astype(np.int32).tobytes(),
        *[a.astype(np.uint32).tobytes() for a in (wa, wb, sw, h, c8)]]))
    subprocess.run(["g++", "-O1", "-std=c++17", "-Wall", "-Werror", "-I",
                    str(tmp_path), "-o", str(tmp_path / "h"),
                    str(tmp_path / "h.cpp")], check=True)
    subprocess.run([str(tmp_path / "h"), str(tmp_path / "in.bin"),
                    str(tmp_path / "out.bin")], check=True)
    n = model.n
    got = np.fromfile(tmp_path / "out.bin", np.int32).reshape(
        TRIALS, 1 + 2 * n)
    sse = [i for i, cp in enumerate(model.comps) if cp[0] == T.SSE]
    comps = [tuple(c) for c in model.comps]
    for t in range(TRIALS):
        pr, pp, cxt = generic_combine(comps, rows, p[t], wa[t], wb[t],
                                      sw[t], h[t], int(c8[t]), sq, st)
        assert int(got[t, 0]) == pr, f"trial {t}: P(1)"
        assert got[t, 1:1 + n].tolist() == pp, f"trial {t}: predictions"
        assert [int(got[t, 1 + n + i]) & M32 for i in sse] \
            == [cxt[i] for i in sse], f"trial {t}: SSE contexts"


@pytest.mark.parametrize("name", ["4.0", "cfg"])
def test_generic_mirror_equals_the_predictor(name):
    """The mirror of ``phase_b`` holds: fed what phase (a) reads from the
    port's scalar predictor (``models/predictor.py``) at every bit of a
    short text, with each step's own prediction spoiled, it gives that
    predictor's P(1), predictions and SSE contexts."""
    from zpaqfranz_tpu_torch.models.predictor import Predictor

    model = _model(name)
    n = model.n
    rows = Placement(model, "fast").rows
    comps = [tuple(c) for c in model.comps]
    steps = cf.try_compile(model, rows).steps
    sq = _BIGLUT[SQ_OFF: SQ_OFF + 4096]
    st = _BIGLUT[STR_OFF: STR_OFF + 16384]
    pred = Predictor(model)
    words = max(off + 32 + (cp[3] if cp[0] == T.MIX else 0)
                for i, cp in enumerate(comps) for off in [rows.get(i, 0)])
    for byte in b"The quick brown fox jumps over the lazy dog; the dog " * 2:
        for k in range(7, -1, -1):
            c8, h = pred.c8, list(pred.h[:n])
            want = pred.predict()
            wa, wb, sw = [0] * n, [0] * n, [0] * words
            for i, cp in enumerate(comps):
                cr = pred.comp[i]
                if cp[0] == T.ISSE:
                    wa[i], wb[i] = map(int, cr.cm[2 * cr.cxt: 2 * cr.cxt + 2])
                elif cp[0] == T.MIX2:
                    wa[i] = int(cr.a16[cr.cxt])
                elif cp[0] == T.MIX:
                    sw[rows[i]: rows[i] + cp[3]] = map(
                        int, cr.cm[cr.cxt: cr.cxt + cp[3]])
                elif cp[0] == T.SSE:
                    base = ((h[i] + c8) * 32) & (cr.cm.size - 1)
                    sw[rows[i]: rows[i] + 32] = map(int,
                                                    cr.cm[base: base + 32])
            p = [12345 if i in steps else v for i, v in enumerate(pred.p[:n])]
            pr, pp, cxt = generic_combine(comps, rows, p, wa, wb, sw, h, c8,
                                          sq, st)
            assert (pr, pp) == (want, pred.p[:n])
            assert all(cxt[i] == pred.comp[i].cxt for i in cxt)
            pred.update((byte >> k) & 1)


@pytest.mark.parametrize("name", PRESETS + ["cfg"])
def test_generator_accepts_every_preset(name):
    """Every preset with a CM model, and the model of every component
    type, runs the specialised combine by default, at both HCOMP steps."""
    model = _model(name)
    for hcomp in ("fast", "interp"):
        plan = Placement(model, hcomp)
        assert combine_step(model, plan) == "fast"
        assert combine_step(model, plan, "generic") == "generic"
        fast = cf.try_compile(model, plan.rows)
        assert fast.steps == [i for i, cp in enumerate(model.comps)
                              if cp[0] in (T.AVG, T.MIX2, T.MIX, T.ISSE,
                                           T.SSE)]
        assert fast.terms <= cf.MAX_TERMS


@pytest.mark.parametrize("name", ["1", "2"])
def test_levels_without_a_model_are_refused(name):
    """-m1 and -m2 code no CM lane: there is nothing to specialise."""
    model = make_model(name)[0]
    assert model.n == 0 and cf.try_compile(model, {}) is None


def test_generator_refuses_past_its_cap():
    """A combine of ``MAX_TERMS`` terms is specialised; one past it runs
    the generic combine, and asking for the specialised one raises."""
    at = compile_config(AT_CAP)[0]
    past = compile_config(PAST_CAP)[0]
    assert cf.terms(at) == cf.MAX_TERMS < cf.terms(past)
    plan = Placement(past, "interp")
    assert cf.try_compile(past, plan.rows) is None
    assert combine_step(past, plan) == "generic"
    with pytest.raises(ValueError, match="generator"):
        combine_step(past, plan, "fast")
    assert kernel_unit("cm_encode", past) == "cm_encode"
    assert "struct CombineFast" in kernel_unit("cm_encode", at)[1]


def test_generator_refuses_inputs_outside_the_model():
    """A step reading past the last component is left to the generic
    combine, which reads what the lane's region holds there."""
    model = compile_config(_cfg_mixes(3, 1))[0]
    model.comps[-1] = bytes([T.MIX, 0, 2, 3, 24, 255])
    assert cf.try_compile(model, Placement(model, "interp").rows) is None


def test_unknown_combine_raises():
    model = make_model("4")[0]
    with pytest.raises(ValueError, match="combine must be"):
        combine_step(model, Placement(model, "fast"), "walk")


@pytest.mark.parametrize("name", ["4", "5", "4.0", "5.0", "cfg"])
def test_one_unit_per_kernel_and_model(name):
    """The unit of a launch holds the specialised HCOMP program, the
    specialised combine and the generated phases together, each with its
    switch; forcing a generic step leaves its part out, and all three
    leave the plain kernel."""
    model = _model(name)
    plan = Placement(model, "fast")
    hsrc = hf.try_compile(model).cuda_source()
    csrc = cf.try_compile(model, plan.rows).cuda_source()
    psrc = pf.try_compile(model, plan, Layout(model)).cuda_source()
    for kernel in ("cm_decode", "cm_encode"):
        unit = kernel_unit(kernel, model)
        assert unit == (kernel, f"{hsrc}\n#define CM_HCOMP_FAST 1\n{csrc}\n"
                                f"#define CM_COMBINE_FAST 1\n{psrc}\n"
                                "#define CM_PHASES_FAST 1\n")
        name_, gen = kernel_unit(kernel, model, hcomp="interp")
        assert "HcompFast" not in gen and "#define CM_COMBINE_FAST" in gen
        name_, gen = kernel_unit(kernel, model, combine="generic")
        assert "CombineFast" not in gen and "#define CM_HCOMP_FAST" in gen
        assert kernel_unit(kernel, model, "interp", "generic",
                           "generic") == kernel
    assert build.unit_key(kernel_unit("cm_encode", model)) != build.unit_key(
        kernel_unit("cm_encode", make_model("3")[0]))


def test_build_writes_one_header_and_unit(tmp_path, monkeypatch):
    """``ops/build.py`` writes the generated text once, as
    ``gen-<digest>.cuh``, and a unit that includes it before the kernel's
    source; the library's name hashes the generated text too."""
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    unit = kernel_unit("cm_decode", make_model("4.0")[0])
    d = build._digest(unit[1])
    cu = build._source(unit)
    assert cu == tmp_path / f"cm_decode-{d}.cu"
    assert cu.read_text() == (f'#include "gen-{d}.cuh"\n'
                              '#include "cm_decode.cu"\n')
    assert (tmp_path / f"gen-{d}.cuh").read_text() == unit[1]
    lib = build._lib_path(unit)
    assert lib.name.startswith("libcm_decode-gen-")
    assert build._lib_path(("cm_decode", unit[1] + " ")) != lib
    assert build._lib_path("cm_decode").name.startswith("libcm_decode-")


#: lanes per block of each preset at the HCOMP step given: the combine
#: changes no placement
LANES_PER_BLOCK = {"3": (57, 35), "4": (6, 6), "5": (5, 5), "3.0": (57, 35),
                   "4.0": (6, 6), "5.0": (5, 5), "5.1": (5, 5),
                   "cfg": (16, 13)}


@pytest.mark.parametrize("name", sorted(LANES_PER_BLOCK))
def test_placement_unchanged(name):
    model = _model(name)
    assert (Placement(model, "fast").lanes_per_block,
            Placement(model, "interp").lanes_per_block) \
        == LANES_PER_BLOCK[name]

