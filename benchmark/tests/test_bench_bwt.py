"""The cell ``m3_b1.add``: its metric ``add.bwt_ms`` on synthetic records of
the port's span ``pre.bwt``, and whole runs of the cell cut to a tiny tree
on the CPU (the port's plain PyTorch versions, not the benchmark): sound,
traced, and with the configuration's control, which ``correct`` fails."""

import pytest

from benchmark import cells, control
from benchmark.spans import Span, Trace
from cellrun import run, tiny
from zpaqfranz_tpu_torch import trace as port

#: the plain CM coder codes ~5 ms a byte at -m3 on the CPU
M3 = 400


@pytest.fixture(autouse=True)
def empty_buffer():
    port.clear()
    yield
    port.clear()


def rec(name, start, end, parent=None, **counts):
    r = port.Record(name, parent, dict(counts))
    r.start, r.end = start, end
    port.BUFFER.put(r)
    return r


def window(ops):
    return Trace((0.0, 10.0), [Span("op", s, e) for s, e in ops], [], [], {})


def test_bwt_ms_per_operation():
    for k in range(2):
        op = rec("op.a", 4.0 * k, 4.0 * k + 3.0)
        prep = rec("add.prepare", 4.0 * k, 4.0 * k + 1.0, op, raw=100)
        rec("pre.bwt", 4.0 * k + 0.25, 4.0 * k + 0.75, prep, bytes=100)
    rec("pre.bwt", 12.0, 13.0)                   # after the window
    read = cells.reader("add.bwt_ms")
    assert read(window(((0.0, 3.0), (4.0, 7.0)))) == pytest.approx(500.0)


def test_bwt_ms_with_nothing_to_read_is_none(monkeypatch):
    read = cells.reader("add.bwt_ms")
    assert read(window(((0.0, 3.0),))) is None
    rec("op.a", 0.0, 3.0)
    assert read(window(((0.0, 3.0),))) is None   # a method with no BWT
    monkeypatch.setattr(port, "BUFFER", port.Buffer(cap=1))
    rec("pre.bwt", 1.0, 2.0)
    rec("pre.bwt", 2.0, 2.5)
    assert read(window(((0.0, 3.0),))) is None   # a dropped span


def test_sound_run_is_correct_and_reads_the_bwt(port_on_cpu):
    result = run(tiny("m3_b1.add", M3), seconds=1.0, trace=True)
    assert result["correct"], result["checks"]
    assert result["failed"] == 0
    got = result["metrics"]
    assert got["add.bwt_ms"]["value"] > 0
    assert got["add.prepare_ms"]["value"] >= got["add.bwt_ms"]["value"]


def test_control_is_not_correct(port_on_cpu):
    cell = tiny("m3_b1.add", M3)
    with control.planted(cell):
        result = run(cell, seconds=1.0)
    assert not result["correct"]
    assert result["checks"]["blocks_misheaded"]["value"] >= 1
