"""Whole runs of each cell at a tiny size on the CPU, on the port's plain
PyTorch versions: not the benchmark, which times the card. They drive
everything of a run but the look for a card, and break the timed path
underneath to see ``correct`` come out false."""

import pytest

from benchmark import control, operations
from cellrun import run, tiny

#: tiny trees: the plain CM coders take ~1 ms a coded bit on the CPU
M4 = 600
M1 = 30000


def flip_first_byte(outs):
    return [bytes([outs[0][0] ^ 1]) + outs[0][1:]] + list(outs[1:])


def drop_half(outs):
    """The batch's second half replaced by copies of the first half's."""
    n = len(outs)
    assert n >= 2
    return list(outs[:n - n // 2]) + list(outs[:n // 2])


def on_output(fault):
    return lambda fn: lambda *a, **k: fault(fn(*a, **k))


def break_window(monkeypatch, cell, mod, name, breaker):
    """Run ``cell``'s set-up sound, then replace ``mod.name`` by
    ``breaker(mod.name)`` for the window."""
    kind = operations.KINDS[cell.traffic["operation"]]
    setup = kind.setup

    def setup_then_break(self):
        setup(self)
        monkeypatch.setattr(mod, name, breaker(getattr(mod, name)))
    monkeypatch.setattr(kind, "setup", setup_then_break)


def half_the_fragments(check):
    """``_check_lanes`` leaving the second half of each batch's fragments
    out of the check: the damaged last fragment passes."""
    def half(jd, blocks, outs, device):
        ids = [j for b in blocks for j in range(b.start, b.start + b.frags)]
        saved = {j: jd.ht[j] for j in ids[len(ids) // 2:]}
        for j in saved:
            jd.ht[j] = type(jd.ht[j])(b"\x00" * 20, jd.ht[j].usize)
        try:
            return check(jd, blocks, outs, device)
        finally:
            for j, h in saved.items():
                jd.ht[j] = h
    return half


@pytest.mark.parametrize("workload,size", [("m4_b1.add", M4),
                                           ("m4_b1.extract", M4),
                                           ("m1_b16.test", M1)])
def test_sound_run_is_correct(workload, size, port_on_cpu, request):
    if workload.startswith("m4"):
        request.getfixturevalue("small_blocks")
    result = run(tiny(workload, size), seconds=2.0)
    assert result["correct"], result["checks"]
    assert result["failed"] == 0


@pytest.mark.parametrize("fault", [flip_first_byte, drop_half])
@pytest.mark.parametrize("workload,point", [
    ("m4_b1.add", "encode_streams"), ("m4_b1.extract", "decode_streams")])
def test_broken_cm_lanes_are_not_correct(workload, point, fault,
                                         port_on_cpu, small_blocks,
                                         monkeypatch):
    from zpaqfranz_tpu_torch.parallel import engine
    cell = tiny(workload, M4)
    break_window(monkeypatch, cell, engine, point, on_output(fault))
    assert not run(cell)["correct"]


@pytest.mark.parametrize("where,breaker", [
    ("ops.sha1.to_digests", on_output(flip_first_byte)),
    ("jidac.extract._check_lanes", half_the_fragments)])
def test_broken_test_is_not_correct(where, breaker, port_on_cpu,
                                    monkeypatch):
    import importlib
    mod, name = where.rsplit(".", 1)
    mod = importlib.import_module("zpaqfranz_tpu_torch." + mod)
    cell = tiny("m1_b16.test", M1)
    break_window(monkeypatch, cell, mod, name, breaker)
    result = run(cell, seconds=2.0)
    assert result["attempted"] >= 2
    assert not result["correct"]
    assert result["checks"]["wrong_answers"]["value"] >= 1


@pytest.mark.parametrize("workload,size,check", [
    ("m4_b1.add", M4, "blocks_misheaded"),
    ("m4_b1.extract", M4, "blocks_misheaded"),
    ("m1_b16.test", M1, "wrong_answers")])
def test_control_is_not_correct(workload, size, check, port_on_cpu):
    cell = tiny(workload, size)
    with control.planted(cell):
        result = run(cell, seconds=2.0)
    assert not result["correct"]
    assert result["checks"][check]["value"] >= 1
