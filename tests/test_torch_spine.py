"""The port's copied spine against the reference package: format tables,
model headers, the native engine binding, and the state carried into the
port (``convert.py``). Every comparison is exact."""

import dataclasses
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from zpaqfranz_tpu import native as ref_native
from zpaqfranz_tpu.codec import methods as ref_methods
from zpaqfranz_tpu.models import tables as ref_tables
from zpaqfranz_tpu.ops.codec_arena import _Layout as RefLayout
from zpaqfranz_tpu.parallel import engine as ref_engine
from zpaqfranz_tpu.zpaql import compiler as ref_compiler

from zpaqfranz_tpu_torch import convert, native
from zpaqfranz_tpu_torch.codec import methods
from zpaqfranz_tpu_torch.jidac import add as port_add
from zpaqfranz_tpu_torch.models import tables
from zpaqfranz_tpu_torch.ops import cm_decode as cmd
from zpaqfranz_tpu_torch.zpaql import compiler

from test_codec_arena import ALL_COMPONENTS_CFG

ROOT = pathlib.Path(__file__).resolve().parent.parent

METHODS = ["0", "1", "2", "3", "4", "5", "4.0", "5.0"]


@pytest.mark.parametrize("name", ["SNS", "SQUASHT", "STRETCHT", "DT", "DT2K",
                                  "CMINIT", "COMPSIZE", "COMPNAME"])
def test_tables_equal_reference(name):
    ours, ref = getattr(tables, name), getattr(ref_tables, name)
    if isinstance(ref, np.ndarray):
        assert ours.dtype == ref.dtype
        np.testing.assert_array_equal(ours, ref)
    else:
        assert ours == ref


def test_table_self_checks_pass():
    tables.self_test()


@pytest.mark.parametrize("method", METHODS)
def test_make_model_headers_identical(method):
    ours, ours_pre = methods.make_model(method)
    ref, ref_pre = ref_methods.make_model(method)
    assert (ours is None) == (ref is None)
    assert dataclasses.asdict(ours_pre) == dataclasses.asdict(ref_pre)
    if ref is not None:
        assert ours.header_bytes() == ref.header_bytes()
        assert ours.pcomp_bytes() == ref.pcomp_bytes()


def test_compile_config_all_components_identical():
    ours, _ = compiler.compile_config(ALL_COMPONENTS_CFG)
    ref, _ = ref_compiler.compile_config(ALL_COMPONENTS_CFG)
    assert ours.header_bytes() == ref.header_bytes()
    assert ours.comps == ref.comps


@pytest.mark.parametrize("method", ["1", "3"])
def test_native_compress_block_identical(method):
    rng = np.random.default_rng(11)
    words = [b"alpha", b"beta", b"gamma", b"delta", b"\n"]
    raw = b" ".join(words[i] for i in rng.integers(0, 5, 3000))
    model, pre = methods.make_model(method)
    ref_model, ref_pre = ref_methods.make_model(method)
    payload, store = port_add.prepare_payload(pre, raw)
    assert (payload, store) == ref_engine.prepare_payload(ref_pre, raw)
    assert not store
    ours = native.compress_block(model, payload, b"name", b"comment")
    ref = ref_native.compress_block(ref_model, payload, b"name", b"comment")
    assert ours == ref


def test_native_build_uses_the_makefile_flags():
    text = (ROOT / "native" / "Makefile").read_text().replace("\\\n", " ")
    flags = re.search(r"^CXXFLAGS \?= (.*)$", text, re.M).group(1).split()
    want = [f for f in flags if not f.startswith("-W")] + ["-shared"]
    assert sorted(native.CXXFLAGS) == sorted(want)
    rule = re.search(r"^\t\$\(CXX\).*$", text, re.M).group(0)
    assert [f"src/{n}" for n in native.SOURCES] == rule.split()[-2:]


def test_native_build_is_atomic_across_processes(tmp_path):
    # more processes than cores build and load the engine into one fresh
    # directory at once: one compiles, every one loads a whole library
    probe = ("import ctypes, pathlib, sys\n"
             "from zpaqfranz_tpu_torch import native\n"
             "native._BUILD_DIR = pathlib.Path(sys.argv[1])\n"
             "lib = ctypes.CDLL(str(native.ensure_built()))\n"
             "print(lib.tzs_open is not None)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    procs = [subprocess.Popen([sys.executable, "-c", probe, str(tmp_path)],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range((os.cpu_count() or 1) + 1)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert [p.returncode for p in procs] == [0] * len(procs), outs
    assert all(o.strip() == "True" for o, _ in outs)
    assert [p.name for p in tmp_path.glob("*.so")] == [
        native.ensure_built().name]
    assert not list(tmp_path.glob("*.tmp"))


@pytest.mark.parametrize("method", ["3", "4.0", "5.0", "cfg"])
def test_convert_model_and_initial_state(method):
    if method == "cfg":
        ref = ref_compiler.compile_config(ALL_COMPONENTS_CFG)[0]
    else:
        ref = ref_methods.make_model(method)[0]
    model = convert.model_from_reference_header(ref.header_bytes())
    assert model.header_bytes() == ref.header_bytes()
    assert model.comps == ref.comps
    ref_lay = RefLayout(ref)
    lay = cmd.Layout(model)
    assert (lay.s8, lay.s32, lay.off8, lay.off32) == (
        ref_lay.s8, ref_lay.s32, ref_lay.off8, ref_lay.off32)
    want8, want32 = ref_lay.init_rows()
    a8, a32, hmem, mmem = convert.initial_lane_state(model, 2, "cpu")
    assert a8.dtype == torch.uint8 and a32.dtype == torch.int32
    for lane in range(2):
        np.testing.assert_array_equal(a8[lane].numpy(), want8)
        np.testing.assert_array_equal(a32[lane].numpy().view(np.uint32),
                                      want32)
    assert hmem.shape == (2, 1 << model.hh) and not hmem.any()
    assert mmem.shape == (2, 1 << model.hm) and not mmem.any()


def test_convert_rejects_trailing_bytes():
    ref = ref_methods.make_model("3")[0]
    with pytest.raises(ValueError):
        convert.model_from_reference_header(ref.header_bytes() + b"\x00")
