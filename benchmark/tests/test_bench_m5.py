"""The cell ``m5_b1.add``: its metric ``cm.ns_per_bit.add`` on synthetic
records of the port's span ``cm.wait``, and whole runs of the cell cut to a
tiny tree on the CPU (the port's plain PyTorch versions, not the
benchmark): sound, traced, and with the configuration's control (the
archive coded at level 4), which ``correct`` fails."""

import pytest

from benchmark import cells, control
from benchmark.spans import Span, Trace
from cellrun import run, tiny
from zpaqfranz_tpu_torch import trace as port

#: the plain CM coder codes ~40 ms a byte at -m5 on the CPU, and a traced
#: run's profiler records each of its tensor operations
M5 = 50


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


def test_ns_per_bit_over_the_windows_lanes():
    """The lanes' summed nanoseconds over their summed coded bits, over
    every stamped ``cm.wait`` of the window's operations."""
    for k in range(2):
        op = rec("op.a", 4.0 * k, 4.0 * k + 3.0)
        rec("cm.wait", 4.0 * k + 1.0, 4.0 * k + 2.0, op,
            lane_ns=[1000, 3000 * (k + 1)], kernel_ns=3000 * (k + 1),
            lane_bits=[8, 16])
    rec("cm.wait", 2.5, 2.6, lane_ns=[50], kernel_ns=50)  # no lane_bits
    rec("cm.wait", 12.0, 13.0, lane_ns=[9], kernel_ns=9, lane_bits=[8])
    read = cells.reader("cm.ns_per_bit.add")
    tr = window(((0.0, 3.0), (4.0, 7.0)))
    assert read(tr) == pytest.approx((1000 + 3000 + 1000 + 6000) / 48)


def test_ns_per_bit_with_nothing_to_read_is_none(monkeypatch):
    read = cells.reader("cm.ns_per_bit.add")
    assert read(window(((0.0, 3.0),))) is None
    op = rec("op.a", 0.0, 3.0)
    rec("cm.wait", 1.0, 2.0, op, lane_ns=[10], kernel_ns=10)
    assert read(window(((0.0, 3.0),))) is None   # a port without bits
    monkeypatch.setattr(port, "BUFFER", port.Buffer(cap=1))
    rec("cm.wait", 1.0, 2.0, lane_ns=[10], kernel_ns=10, lane_bits=[8])
    rec("cm.wait", 2.0, 2.5, lane_ns=[10], kernel_ns=10, lane_bits=[8])
    assert read(window(((0.0, 3.0),))) is None   # a dropped span


def test_sound_run_is_correct_and_traced(port_on_cpu):
    """The plain coder stamps no lanes: ``cm.ns_per_bit.add`` finds
    nothing there and the line leaves it out."""
    result = run(tiny("m5_b1.add", M5), seconds=1.0, trace=True)
    assert result["correct"], result["checks"]
    assert result["failed"] == 0
    assert result["checks"]["blocks_misheaded"]["value"] == 0
    got = result["metrics"]
    assert got["add.prepare_ms"]["value"] > 0
    assert 0 < got["add.host_pct"]["value"] <= 100
    assert "cm.ns_per_bit.add" not in got


def test_control_is_not_correct(port_on_cpu):
    cell = tiny("m5_b1.add", M5)
    with control.planted(cell):
        result = run(cell, seconds=1.0)
    assert not result["correct"]
    assert result["checks"]["blocks_misheaded"]["value"] >= 1
