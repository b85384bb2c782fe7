"""The port's table-access microbenchmarks (``zpaqfranz_tpu_torch/
experiments/mb_access.py``, kernels A-E) against the TPU script
``experiments/mb_access.py``: the plain versions, which the wrappers take
for CPU tensors, equal the TPU kernels run in Pallas interpret mode bit for
bit on the same seeded inputs, at ITERS = 16 and small tables."""

import importlib.util
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from zpaqfranz_tpu_torch.experiments import mb_access as mb

ROOT = pathlib.Path(__file__).resolve().parent.parent
ITERS = 16


def _load_reference():
    spec = importlib.util.spec_from_file_location(
        "ref_mb_access", ROOT / "experiments" / "mb_access.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF = _load_reference()


@pytest.fixture(autouse=True)
def short_loops(monkeypatch):
    monkeypatch.setattr(REF, "ITERS", ITERS)
    monkeypatch.setattr(mb, "ITERS", ITERS)


def _same(ref_run, port_run, *arrays):
    """The reference kernel in interpret mode and the port's ``run`` on the
    same arrays: equal outputs, the port's inputs unchanged, and a second
    call equal to the first."""
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(ref_run(*[jnp.asarray(a) for a in arrays]))
    ts = [torch.from_numpy(a.copy()) for a in arrays]
    before = mb.launches.copy()
    got = port_run(*ts)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(port_run(*ts), got)
    for t, a in zip(ts, arrays):
        np.testing.assert_array_equal(t.numpy(), a)
    assert mb.launches == before


@pytest.mark.parametrize("kind", ["gather", "onehot", "selwrite"])
@pytest.mark.parametrize("S,dtype", [(64, "uint8"), (96, "int32")])
def test_column_kernels_match_reference(kind, S, dtype):
    """A, B, C on random tables and random int32 start indices (negative
    ones exercise jnp's floor modulo, int32 tables the wrapping adds)."""
    rng = np.random.default_rng(S)
    if dtype == "uint8":
        tab = rng.integers(0, 256, (S, mb.L), np.uint8)
    else:
        tab = rng.integers(-2**31, 2**31, (S, mb.L), np.int64).astype(np.int32)
    idx = rng.integers(-2**31, 2**31, (1, mb.L), np.int64).astype(np.int32)
    ref_mk = {"gather": REF.mk_gather_kernel, "onehot": REF.mk_onehot_kernel,
              "selwrite": REF.mk_selwrite_kernel}[kind]
    mk = {"gather": mb.mk_gather_kernel, "onehot": mb.mk_onehot_kernel,
          "selwrite": mb.mk_selwrite_kernel}[kind]
    _same(ref_mk(S, getattr(jnp, dtype)), mk(S, getattr(torch, dtype)), tab,
          idx)


@pytest.mark.parametrize("aligned", [True, False])
def test_lane_loop_matches_reference(aligned):
    """D on a random table, rows at 16-byte-aligned offsets (the kernel's
    16-byte path) and at any offset (its byte path)."""
    S, W = 256, 16
    rng = np.random.default_rng(4)
    tab = rng.integers(0, 256, (mb.L, S), np.uint8)
    idx = rng.integers(0, S - W + 1, (mb.L, 1)).astype(np.int32)
    if aligned:
        idx = idx // 16 * 16
    _same(REF.mk_lane_loop_kernel(S, W), mb.mk_lane_loop_kernel(S, W), idx,
          tab)


def test_dma_matches_reference_and_refuses_unaligned_rows():
    S, W = 512, 64
    rng = np.random.default_rng(5)
    hbm = rng.integers(0, 256, (mb.L, S), np.uint8)
    idx = (rng.integers(0, (S - W) // 16 + 1, (mb.L, 1)) * 16).astype(
        np.int32)
    run = mb.mk_dma_kernel(S, W)
    _same(REF.mk_dma_kernel(S, W), run, idx, hbm)
    # cp.async moves 16-byte granules: an unaligned row, a row past the
    # table or a width off the granule raises, on the CPU too
    bad = torch.from_numpy(idx.copy())
    bad[3, 0] += 1
    with pytest.raises(ValueError, match="multiple of 16"):
        run(bad, torch.from_numpy(hbm))
    bad[3, 0] = S - W + 16
    with pytest.raises(ValueError, match="leaves the table"):
        run(bad, torch.from_numpy(hbm))
    with pytest.raises(ValueError, match="multiples of 16"):
        mb.mk_dma_kernel(S, 24)


def test_wrappers_check_their_inputs():
    run = mb.mk_gather_kernel(64, torch.uint8)
    tab = torch.zeros((64, 8), dtype=torch.uint8)
    idx = torch.zeros((1, 8), dtype=torch.int32)
    with pytest.raises(TypeError):
        run(tab.int(), idx)
    with pytest.raises(ValueError, match="shape"):
        run(tab, idx[:, :4])
    with pytest.raises(ValueError, match="no kernel for device meta"):
        run(tab.to("meta"), idx.to("meta"))
    with pytest.raises(ValueError, match="shared memory"):
        mb.mk_gather_kernel(mb.SMEM_MAX // 4 + 1, torch.int32)
    loop = mb.mk_lane_loop_kernel(64, 16)
    with pytest.raises(ValueError, match="leaves the table"):
        loop(torch.full((8, 1), 49, dtype=torch.int32),
             torch.zeros((8, 64), dtype=torch.uint8))


def test_main_on_the_cpu_prints_every_bench_line(capsys):
    """``main --device cpu`` runs bench_A .. bench_F through the plain
    versions (ITERS = 16) and prints the TPU script's lines."""
    before = mb.launches.copy()
    assert mb.main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == f"device: cpu, L={mb.L}, ITERS={ITERS}"
    n = (len(mb.A_SHAPES) + len(mb.B_SHAPES) + len(mb.C_SHAPES)
         + len(mb.D_SHAPES) + len(mb.E_SHAPES) + 2 * len(mb.F_SIZES))
    assert len(lines) == 1 + n
    assert all(line.endswith("ns/lane)") for line in lines[1:])
    assert [line[0] for line in lines[1:]] == sorted(line[0]
                                                     for line in lines[1:])
    assert mb.launches == before
