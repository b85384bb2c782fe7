"""The port's HCOMP specialiser (``zpaqfranz_tpu_torch/ops/hcomp_fast.py``)
against the reference ``zpaqfranz_tpu/ops/hcomp_fast.py``: the same
accept/bail decisions, the torch executor's context trajectories equal to
the reference ``FastHcomp``'s through ``lax.scan`` (as
tests/test_hcomp_fast.py drives it), and the generated C++ compiled with g++
as a host function equal to both the reference and the native engine's
hand transcriptions (``VM::run_fast``). Every comparison is exact."""

import pathlib
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zpaqfranz_tpu.codec.methods import make_model as ref_make_model
from zpaqfranz_tpu.ops.hcomp_fast import try_compile as ref_try_compile
from zpaqfranz_tpu.zpaql.compiler import compile_config as ref_compile

from zpaqfranz_tpu_torch import convert, native
from zpaqfranz_tpu_torch.ops import cm_decode as cmd, cm_encode as cme
from zpaqfranz_tpu_torch.ops import hcomp_fast as hf
from zpaqfranz_tpu_torch.parallel.engine import parse_block_payload

from test_codec_arena import ALL_COMPONENTS_CFG

METHODS = ["3", "4", "5", "4.0", "5.0"]
L, N = 4, 160


def _lanes():
    """Four seeded lanes of 160 bytes: noise, text (the word models'
    branch both ways), a constant lane (one long word) and noise."""
    rng = np.random.default_rng(7)
    data = rng.integers(0, 256, (L, N)).astype(np.uint32)
    data[1] = np.frombuffer(
        (b"The quick brown fox JUMPS over 123 lazy dogs?! " * 4)[:N],
        np.uint8)
    data[2, :] = ord("Q")
    return data


def _models(method):
    ref = ref_make_model(method)[0]
    return ref, convert.model_from_reference_header(ref.header_bytes())


def _ref_trajectory(ref, data):
    """(N, L, n) contexts of the reference FastHcomp after each byte."""
    fh = ref_try_compile(ref)

    @jax.jit
    def run(data):
        def step(st, b):
            st = fh.run(st, b)
            return st, st["hn"]
        return jax.lax.scan(step, fh.init_state(data.shape[0]), data.T)[1]

    return np.asarray(run(jnp.asarray(data, dtype=jnp.uint32))).astype(
        np.int64)


def _port_trajectory(model, data):
    fh = hf.try_compile(model)
    st = fh.init_state(data.shape[0])
    out = []
    for j in range(data.shape[1]):
        st = fh.run(st, torch.from_numpy(data[:, j].astype(np.int64)))
        out.append(st["hn"].numpy())
    return np.stack(out)


@pytest.mark.parametrize("method", METHODS)
def test_executor_matches_reference(method):
    ref, model = _models(method)
    data = _lanes()
    assert hf.try_compile(model) is not None
    np.testing.assert_array_equal(_port_trajectory(model, data),
                                  _ref_trajectory(ref, data))


PRE = "  c-- *c=a a+= 255 d=a *d=c\n"


def _cfg(body, hh=9, hm=16, comps=("cm 16 4", "cm 12 4")):
    lines = [f"comp {hh} {hm} 0 0 {len(comps)}"]
    lines += [f"  {i} {c}" for i, c in enumerate(comps)]
    return "\n".join(lines + ["hcomp", PRE + body, "  halt", "post 0 end",
                              ""])


# programs the reference's specialiser rejects, each for one reason
BAILS = {
    "do-while": _cfg("  a= 3 do a-- a> 0 while\n  d= 0 *d=0\n"),
    "r-register": _cfg("  r=a 0 d= 0 *d=0\n"),
    "swap": _cfg("  b=c b<>a d= 0 *d=a\n"),
    "m-off-window": _cfg("  a= 5 b=a a=*b d= 0 *d=a\n"),
    "h-non-constant-d": _cfg("  a=c d=a *d=0\n"),
    "halt-in-branch": _cfg("  a=*c a== 0 if halt endif d= 0 *d=0\n"),
}


@pytest.mark.parametrize("name", sorted(BAILS))
def test_same_bail_decisions(name):
    ref = ref_compile(BAILS[name])[0]
    model = convert.model_from_reference_header(ref.header_bytes())
    assert model.hcomp.startswith(hf._PREAMBLE)
    assert ref_try_compile(ref) is None
    assert hf.try_compile(model) is None


@pytest.mark.parametrize("method", ["3", "4", "5", "3.0", "4.0", "5.0",
                                    "5.1", "cfg"])
def test_same_accept_decisions(method):
    ref = (ref_compile(ALL_COMPONENTS_CFG)[0] if method == "cfg"
           else ref_make_model(method)[0])
    model = convert.model_from_reference_header(ref.header_bytes())
    assert ref_try_compile(ref) is not None
    assert hf.try_compile(model) is not None


# accepted by the reference, rejected by the port: the preamble's write at
# H[byte + 255] aliases component 1 when H has 256 entries (hh = 8), and
# window byte 5 has been overwritten when M has 4 bytes (hm = 2)
GUARDS = {
    "hh8": _cfg("  d= 0 *d=0 b=c a=*b hashd\n", hh=8),
    "hm2": _cfg("  d= 0 *d=0 b=c b++ b++ b++ b++ b++ a=*b hashd\n"
                "  d= 1 *d=0 a=*c hashd\n", hm=2),
}


@pytest.mark.parametrize("name", sorted(GUARDS))
def test_port_guards_aliasing_arrays(name):
    """The port bails where the reference does not, and its plain coder
    (the ZPAQL interpreter there) codes as the native engine does, which
    sees the aliasing."""
    ref = ref_compile(GUARDS[name])[0]
    model = convert.model_from_reference_header(ref.header_bytes())
    assert ref_try_compile(ref) is not None
    assert hf.try_compile(model) is None
    raw = bytes(range(1, 40)) * 3 + b"\x02\x02 the cat"
    coded = parse_block_payload(native.compress_block(model, raw, b"t", b"c"),
                                0)[2]
    got = cmd.lanes_to_bytes(*cme.cm_encode(
        model, *cme.pack_payloads([b"\x00" + raw], "cpu")))
    assert got == [coded[:-6]]
    back = cmd.lanes_to_bytes(*cmd.cm_decode(
        model, *cmd.pack_streams([coded], [len(raw) + 8], "cpu")))
    assert back == [b"\x00" + raw]


HARNESS = r"""
#include <cstdio>
#include <cstdint>
#define __device__
#define __forceinline__ inline
#include "hcomp.cuh"
#include "tzpaq.h"
static const unsigned char code[] = {%(code)s};
static const unsigned char data[%(L)d][%(N)d] = {%(data)s};
int main() {
  tzpaq::register_hcomp(code, sizeof code, %(kind)d);
  for (int k = 0; k < %(L)d; ++k) {
    uint32_t w[HcompFast::words] = {0}, c = 0, h[HcompFast::n] = {0};
    tzpaq::VM vm;
    vm.init(code, sizeof code, %(hh)d, %(hm)d);
    if (vm.fast_hcomp != %(kind)d) return 2;
    for (int j = 0; j < %(N)d; ++j) {
      HcompFast::run(w, c, h, data[k][j]);
      vm.run(data[k][j]);
      for (int i = 0; i < HcompFast::n; ++i)
        std::printf("%%u %%u\n", h[i], vm.h[i]);
    }
  }
  return 0;
}
"""


@pytest.mark.parametrize("method", METHODS)
def test_generated_code_matches_reference_and_native(method, tmp_path):
    """The generated ``struct HcompFast`` compiled with g++ (``__device__``
    defined away) beside the native engine's ``VM::run_fast`` over the same
    lanes: both equal the reference FastHcomp's trajectory."""
    ref, model = _models(method)
    data = _lanes()
    (tmp_path / "hcomp.cuh").write_text(hf.try_compile(model).cuda_source())
    (tmp_path / "h.cpp").write_text(HARNESS % {
        "code": ",".join(map(str, model.hcomp)), "L": L, "N": N,
        "data": ",".join("{%s}" % ",".join(map(str, row)) for row in data),
        "kind": int(method[0]), "hh": model.hh, "hm": model.hm})
    lib = native.ensure_built()
    src = pathlib.Path(native.__file__).resolve().parents[1] / "native/src"
    subprocess.run(["g++", "-O1", "-std=c++17", "-I", str(tmp_path), "-I",
                    str(src), "-o", str(tmp_path / "h"),
                    str(tmp_path / "h.cpp"), str(lib),
                    f"-Wl,-rpath,{lib.parent}"], check=True)
    out = subprocess.run([str(tmp_path / "h")], capture_output=True,
                         text=True, check=True).stdout.split()
    got = np.array(out, np.int64).reshape(L, N, model.n, 2)
    want = _ref_trajectory(ref, data).transpose(1, 0, 2)
    np.testing.assert_array_equal(got[..., 0], want)
    np.testing.assert_array_equal(got[..., 1], want)


def test_executor_is_domain_exact_on_every_alu_operation():
    """A program of every ALU operation the subset takes, with division and
    modulo by zero and shifts past 31, over random lanes: the torch
    executor equals the port's scalar ZPAQL VM byte after byte."""
    from zpaqfranz_tpu_torch.zpaql.compiler import compile_config
    from zpaqfranz_tpu_torch.zpaql.vm import VM

    cfg = _cfg("  a=*c a*= 251 d= 0 *d=a\n"
               "  a=*c b=c b++ a-=*b a<<=*b d= 1 *d=a\n"
               "  a=*c a/=*b a+=*d a%=*b a^= 77 a|= 3 a&~ 5 a>>= 40\n"
               "  a! a++ a-- d= 2 *d=a *d++ *d--\n"
               "  a=*c a> 100 ifnot a&= 15 else a= 200 endif\n"
               "  a< 50 if d= 3 *d=a endif d= 3 hashd\n",
               comps=("cm 16 4",) * 4)
    model = compile_config(cfg)[0]
    fh = hf.try_compile(model)
    assert fh is not None
    rng = np.random.default_rng(3)
    data = rng.integers(0, 256, (8, 64))
    data[0, ::3] = 0
    st = fh.init_state(8)
    vms = [VM.for_hcomp(model) for _ in range(8)]
    for j in range(data.shape[1]):
        st = fh.run(st, torch.from_numpy(data[:, j]))
        for k, vm in enumerate(vms):
            vm.run(int(data[k, j]))
            assert st["hn"][k].tolist() == [int(v) for v in vm.h[:4]]
