"""The CM kernels' placement plan (``ops/cm_model.Placement``): the group
size, the lane's shared region, which tables live in shared memory and
which in device memory, and the launch geometry it gives the CUDA kernels
(``csrc/cm_model.cuh``). Pure arithmetic on the model: no card needed."""

import numpy as np
import pytest
import torch

from zpaqfranz_tpu_torch.codec.methods import ALL_COMPONENTS_CFG, make_model
from zpaqfranz_tpu_torch.models import tables as T
from zpaqfranz_tpu_torch.ops import cm_model as cm
from zpaqfranz_tpu_torch.zpaql.compiler import compile_config
from zpaqfranz_tpu_torch.zpaql.header import Model

# 256 components, the kernels' most (one more than a ZPAQ header holds):
# 255 small CMs and a MIX of all of them
WIDE = Model(hh=2, hm=2, comps=[bytes([T.CM, 4 + k % 5, 4])
                                for k in range(255)]
             + [bytes([T.MIX, 4, 0, 255, 24, 255])], hcomp=b"\x38")
# CM, MIX and SSE tables larger than a lane's budget: only H and the ICM
# and ISSE state tables fit in shared memory
BIG_CFG = """comp 12 0 0 0 5
  0 cm 16 4
  1 icm 12
  2 isse 12 1
  3 mix 12 0 3 24 255
  4 sse 12 3 32 255
hcomp
  halt
post 0 end
"""


def _model(name):
    if name == "cfg":
        return compile_config(ALL_COMPONENTS_CFG)[0]
    if name == "wide":
        return WIDE
    if name == "big":
        return compile_config(BIG_CFG)[0]
    return make_model(name)[0]


MODELS = ["3", "4", "5", "4.0", "5.0", "cfg", "wide", "big"]


@pytest.mark.parametrize("name", MODELS)
def test_placement_plan_holds(name):
    model = _model(name)
    plan = cm.Placement(model)
    n = model.n
    assert plan.G & (plan.G - 1) == 0 and 1 <= plan.G <= 32
    assert plan.G >= min(n, 32) and (plan.G == 1 or plan.G // 2 < n)
    assert plan.lanes_per_block >= 1
    assert plan.lanes_per_block * plan.G <= 1024
    assert plan.smem == plan.header + 4 * plan.lanes_per_block \
        * plan.lane_words <= cm.SMEM_LIMIT
    assert plan.header == cm.header_bytes(n, len(cm.hcomp_bytes(model)))
    assert plan.header % 16 == 0 and plan.lane_words % 4 == 0
    # the lane region: pieces 16-byte aligned, inside it, never overlapping
    spans = sorted((off, off + size) for _, off, size in plan.pieces)
    assert all(off % 4 == 0 for off, _ in spans)
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
    assert spans[-1][1] <= plan.lane_words
    names = [p[0] for p in plan.pieces]
    assert len(names) == len(set(map(str, names)))
    # every table in exactly one place: shared ones are pieces of the
    # region, the rest keep their device offsets
    tables = {i: cm.table_words(cp) for i, cp in enumerate(model.comps)
              if cm.table_words(cp)}
    pieces = {p[0][1]: (p[1], p[2]) for p in plan.pieces
              if isinstance(p[0], tuple) and p[0][0] == "table"}
    assert set(plan.shared) == set(pieces) <= set(tables) | {-1}
    for i, off in plan.shared.items():
        size = (1 << model.hh) if i == -1 else tables[i]
        assert pieces[i] == (off, size)
    shared_bytes = 4 * sum(size for _, size in pieces.values())
    assert 4 * plan.lane_words <= max(cm.LANE_BUDGET,
                                      4 * plan.lane_words - shared_bytes)
    cplan = plan.cplan(model)
    assert cplan.shape == (n, 3) and cplan.dtype == np.int32
    for i, cp in enumerate(model.comps):
        assert cplan[i, 0] == plan.shared.get(i, -1)
        assert cplan[i, 1] == cm.table_words(cp)
        assert (cplan[i, 2] >= 0) == (cp[0] in (T.MIX, T.SSE))
    geo = plan.geometry()
    assert geo.tolist() == [plan.geo[g] for g in cm.GEO]
    assert geo[-1] == plan.shared.get(-1, -1)
    # the device u8 arena: 64-byte aligned tables, one after another
    lay = cm.Layout(model)
    owned = sorted(lay.off8)
    assert plan.s8 % 64 == 0 and plan.s8 >= lay.s8
    for a, b in zip(owned, owned[1:]):
        assert plan.off8[a] % 64 == 0
        assert plan.off8[b] >= plan.off8[a] + (lay.off8[b] - lay.off8[a])


@pytest.mark.parametrize("name", MODELS)
@pytest.mark.parametrize("L", [1, 2, 7, 35, 36, 1000])
def test_launch_covers_every_lane(name, L):
    plan = cm.Placement(_model(name))
    blocks = plan.blocks(L)
    assert blocks * plan.lanes_per_block >= L
    assert (blocks - 1) * plan.lanes_per_block < L


def test_standard_models_geometry():
    """-m3 takes G = 2, -m4 16 and -m5 32; -m4 keeps its 2 ICM and 6 ISSE
    state tables, both MIX2s, MIX 9 and H in shared memory and its SSE,
    MIX 10, hash rows and MATCH tables in device memory."""
    assert cm.Placement(_model("3")).G == 2
    p4 = cm.Placement(_model("4"))
    assert p4.G == 16 and p4.lanes_per_block >= 4
    assert sorted(p4.shared) == [-1, 0, 1, 2, 3, 4, 5, 7, 8, 9, 11, 13]
    assert cm.Placement(_model("5")).G == 32
    big = cm.Placement(_model("big"))
    assert sorted(big.shared) == [-1, 1, 2]
    wide = cm.Placement(_model("wide"))
    assert wide.G == 32 and -1 in wide.shared and len(wide.shared) < 256


@pytest.mark.parametrize("name", ["1", "2"])
def test_store_models_have_no_placement(name):
    model = make_model(name)[0]
    assert model.n == 0
    with pytest.raises(ValueError):
        cm.Placement(model)


@pytest.mark.parametrize("name", ["3", "cfg", "big"])
def test_kernel_state(name):
    model = _model(name)
    plan = cm.Placement(model)
    a8, a32, hmem, mmem = cm.kernel_state(model, plan, 3, "cpu")
    assert a8.shape == (3, plan.s8) and a8.dtype == torch.uint8
    want8 = np.zeros(plan.s8, np.uint8)
    for i, cp in enumerate(model.comps):
        if cp[0] == T.MATCH:
            want8[plan.off8[i]] = 1
    assert all((a8[k].numpy() == want8).all() for k in range(3))
    _, want32, _, _ = cm.initial_lane_state(model, 3, "cpu")
    assert torch.equal(a32, want32)
    assert hmem.numel() == (1 if plan.geo["ht"] >= 0 else 3 << model.hh)
    assert mmem.shape == (3, 1 << model.hm)
    h = 0 if plan.geo["ht"] >= 0 else 4 << model.hh
    assert cm.lane_bytes(model) == plan.s8 + 4 * cm.Layout(model).s32 + h \
        + (1 << model.hm) + 4 * 256


@pytest.mark.parametrize("name", MODELS)
def test_specialised_plan_has_no_h_and_no_m(name):
    """A launch whose HCOMP program is specialised places no H table and
    allocates neither H, M nor ZPAQL R: its lanes need fewer bytes, and its
    blocks hold at least as many lanes. Both plans stay within the
    kernels' compiled thread limit."""
    model = _model(name)
    step = cm.hcomp_step(model)
    assert step == ("interp" if name in ("wide", "big") else "fast")
    interp = cm.Placement(model)
    assert interp.hcomp == "interp"
    for plan in (interp, cm.Placement(model, step)):
        assert plan.lanes_per_block * plan.G <= cm.MAX_BLOCK_THREADS
    if step == "interp":
        with pytest.raises(ValueError, match="specialisable"):
            cm.hcomp_step(model, "fast")
        return
    fast = cm.Placement(model, "fast")
    assert -1 not in fast.shared and fast.geo["ht"] == -1
    assert set(fast.shared) >= set(interp.shared) - {-1}
    assert fast.lane_words <= interp.lane_words
    assert fast.lanes_per_block >= interp.lanes_per_block
    lay = cm.Layout(model)
    assert cm.lane_bytes(model, "fast") == fast.s8 + 4 * lay.s32
    assert cm.lane_bytes(model, "fast") <= cm.lane_bytes(model) \
        - (1 << model.hm) - 1024
    a8, a32, hmem, mmem = cm.kernel_state(model, fast, 3, "cpu")
    assert hmem is None and mmem is None
    assert a8.shape == (3, fast.s8) and a32.shape == (3, lay.s32)


def test_hcomp_step_names():
    model = _model("3")
    assert cm.hcomp_step(model, "interp") == "interp"
    with pytest.raises(ValueError, match="hcomp must be"):
        cm.hcomp_step(model, "vm")
    with pytest.raises(ValueError, match="hcomp must be"):
        cm.Placement(model, "vm")
