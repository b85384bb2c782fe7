"""The port's dependent-probe microbenchmarks (``zpaqfranz_tpu_torch/
experiments/mb_vmem_probe.py``, P1 and P2) against the TPU script
``experiments/mb_vmem_probe.py``: its ``main()`` run in Pallas interpret
mode, its kernels' results taken from ``jax.block_until_ready``, equal the
port's plain versions bit for bit."""

import importlib.util
import pathlib
import sys

import jax
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from zpaqfranz_tpu_torch.experiments import mb_vmem_probe as mp

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _load_reference():
    spec = importlib.util.spec_from_file_location(
        "ref_mb_vmem_probe", ROOT / "experiments" / "mb_vmem_probe.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _reference_results(monkeypatch, L, iters):
    """The reference main()'s two kernels' outputs at ``[L] [ITERS]`` (each
    kernel runs twice: a warm-up and a timed call)."""
    ref = _load_reference()
    got = []
    real = jax.block_until_ready

    def record(x):
        got.append(np.asarray(x))
        return real(x)

    monkeypatch.setattr(jax, "block_until_ready", record)
    monkeypatch.setattr(sys, "argv", ["mb_vmem_probe.py", str(L), str(iters)])
    with pltpu.force_tpu_interpret_mode():
        ref.main()
    assert len(got) == 4
    return got


def _p1_overflows(L, iters):
    """Whether P1's ``acc * 741103597`` leaves int32 on its chain (Python
    ints, independent of both implementations)."""
    tab = np.zeros((L, mp.SW), np.int64)
    acc = 0
    over = False
    for it in range(iters):
        for lane in range(L):
            over |= acc * mp.MIX >= 2**31
            x = (acc * mp.MIX + lane + it + 2**31) % 2**32 - 2**31
            i = x % (mp.SW - mp.W)
            r0 = int(tab[lane, i])
            tab[lane, i:i + mp.W] += 1
            acc = (acc + r0) % 2**20
    return over


@pytest.mark.parametrize("L,iters", [(4, 3), (4, 8)])
def test_probes_match_reference_main(monkeypatch, L, iters):
    lane_rw, lane_rw2, lut, lut2 = _reference_results(monkeypatch, L, iters)
    assert _p1_overflows(L, iters) == (iters == 8)
    tab = torch.zeros((L, mp.SW), dtype=torch.int32)
    got = mp.lane_rw_probe(tab, iters)
    np.testing.assert_array_equal(got.numpy(), lane_rw)
    np.testing.assert_array_equal(got.numpy(), lane_rw2)
    assert not tab.any()                     # the caller's table unchanged
    assert torch.equal(mp.lane_rw_probe(tab, iters), got)
    table = torch.arange(mp.LUT, dtype=torch.int32)
    got = mp.lut_probe(table, L, iters)
    np.testing.assert_array_equal(got.numpy(), lut)
    np.testing.assert_array_equal(got.numpy(), lut2)


def test_probes_wrap_like_int32_on_random_tables():
    """Negative and large table words: P1's row adds and accumulator and
    P2's adds wrap as int32 and take floor moduli, like the independent
    Python-int chain."""
    rng = np.random.default_rng(9)
    tab = rng.integers(-2**31, 2**31, (3, 40), np.int64).astype(np.int32)
    work = tab.astype(np.int64)
    acc = 0
    for it in range(5):
        for lane in range(3):
            x = (acc * mp.MIX + lane + it + 2**31) % 2**32 - 2**31
            i = x % (40 - mp.W)
            r0 = int(work[lane, i])
            work[lane, i:i + mp.W] = (work[lane, i:i + mp.W] + 1 + 2**31) \
                % 2**32 - 2**31
            acc = (acc + r0) % 2**20
    assert mp.lane_rw_probe(torch.from_numpy(tab), 5).item() == acc
    lut = rng.integers(-2**31, 2**31, 100, np.int64)
    want = []
    for lane in range(6):
        a = lane
        for it in range(2 * 8):
            a = (a + int(lut[(a + it) % 100])) % 2**20
        want.append(a)
    got = mp.lut_probe(torch.from_numpy(lut.astype(np.int32)), 6, 2)
    assert got.tolist() == [want]


def test_probes_check_their_inputs():
    with pytest.raises(ValueError, match="more than"):
        mp.lane_rw_probe(torch.zeros((2, mp.W), dtype=torch.int32), 1)
    with pytest.raises(TypeError):
        mp.lane_rw_probe(torch.zeros((2, 64), dtype=torch.int64), 1)
    with pytest.raises(ValueError, match="LUT entries"):
        mp.lut_probe(torch.zeros(mp.SMEM_MAX // 4 + 1, dtype=torch.int32), 4,
                     1)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        mp.lut_probe(torch.zeros(16, dtype=torch.int32, device="meta"), 4, 1)


def test_main_on_the_cpu_prints_both_lines(capsys):
    before = mp.launches.copy()
    assert mp.main(["4", "3", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "device=cpu L=4 ITERS=3"
    assert "ns/lane-probe (" in lines[1] and "4-lane probe round" in lines[1]
    assert lines[2].startswith("smem 4096 LUT:")
    assert lines[2].endswith("us/query-round (all 4 lanes)")
    assert mp.launches == before
