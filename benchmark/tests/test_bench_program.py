"""The readers of the port's own spans (``benchmark/program.py`` and the
ten metrics that use it) on synthetic records: each returns its number,
and None where the window holds none of its spans, where the port's
buffer dropped a span, or where the port has no tracer."""

import sys

import pytest

from benchmark import cells, idle, program
from benchmark.spans import Span, Trace
from zpaqfranz_tpu_torch import trace as port

MAIN, POOL = 1, 2
READERS = ("add.digest_wait_ms", "add.prepare_ms", "add.commit_ms",
           "cm.lane_busy_pct.add", "extract.verify_ms", "extract.write_ms",
           "cm.lane_busy_pct.extract", "test.index_ms",
           "test.decode_blocked_pct", "test.decode_busy_pct")


@pytest.fixture(autouse=True)
def empty_buffer():
    port.clear()
    yield
    port.clear()


def rec(name, start, end, parent=None, thread=MAIN, **counts):
    """A closed span of the port, in its buffer."""
    r = port.Record(name, parent, dict(counts))
    r.start, r.end, r.thread = start, end, thread
    port.BUFFER.put(r)
    return r


def window(ops=((0.0, 8.0),), device=()):
    return Trace((0.0, 10.0), [Span("op", s, e) for s, e in ops], [],
                 list(device), {})


def read(name, tr):
    return cells.reader(name)(tr)


def test_add_readers():
    op = rec("op.a", 0.0, 8.0)
    rec("add.digest_wait", 1.0, 1.5, op)
    rec("add.digest_wait", 2.0, 2.25, op)
    rec("add.prepare", 2.5, 3.0, op, raw=100, coded=40, store=0)
    rec("add.commit", 7.0, 7.75, op, bytes=500)
    launch = rec("cm.launch", 3.0, 3.5, op, lanes=2, hcomp="fast")
    rec("cm.wait", 3.5, 6.5, op, lane_ns=[3_000_000_000, 1_000_000_000],
        kernel_ns=4_000_000_000)
    rec("cm.wait", 6.6, 6.7, launch)           # a launch without stamps
    rec("add.prepare", 12.0, 13.0)              # after the window
    tr = window()
    assert read("add.digest_wait_ms", tr) == pytest.approx(750.0)
    assert read("add.prepare_ms", tr) == pytest.approx(500.0)
    assert read("add.commit_ms", tr) == pytest.approx(750.0)
    assert read("cm.lane_busy_pct.add", tr) == pytest.approx(50.0)


def test_extract_readers():
    for k in range(2):
        op = rec("op.x", 5.0 * k, 5.0 * k + 4.0)
        rec("extract.verify", 5.0 * k + 1.0, 5.0 * k + 1.2, op,
            fragments=10, bytes=1000)
        rec("extract.write", 5.0 * k + 3.0, 5.0 * k + 3.6, op, files=3,
            bytes=1000)
        rec("cm.wait", 5.0 * k + 1.5, 5.0 * k + 2.5, op,
            lane_ns=[10, 20, 30], kernel_ns=40)
    tr = window(ops=((0.0, 4.0), (5.0, 9.0)))
    assert read("extract.verify_ms", tr) == pytest.approx(200.0)
    assert read("extract.write_ms", tr) == pytest.approx(600.0)
    assert read("cm.lane_busy_pct.extract", tr) == pytest.approx(50.0)


def test_test_readers():
    for k in range(2):
        op = rec("op.t", 4.0 * k, 4.0 * k + 3.0)
        rec("jidac.index", 4.0 * k, 4.0 * k + 0.1, op, blocks=2)
        v = rec("verify", 4.0 * k + 0.5, 4.0 * k + 2.5, op, threads=4,
                batches=1, blocks=2)
        rec("verify.decode_wait", 4.0 * k + 0.5, 4.0 * k + 1.5, v)
        for b in range(2):
            rec("verify.decode", 4.0 * k + 0.5, 4.0 * k + 1.5, v,
                thread=POOL + b, usize=100)
    tr = window(ops=((0.0, 3.0), (4.0, 7.0)))
    assert read("test.index_ms", tr) == pytest.approx(100.0)
    assert read("test.decode_blocked_pct", tr) == pytest.approx(
        100 * 2.0 / 6.0)
    assert read("test.decode_busy_pct", tr) == pytest.approx(
        100 * 4.0 / (2 * 2.0 * 4))


def test_readers_with_nothing_to_read_return_none():
    tr = window()
    for name in READERS:
        assert read(name, tr) is None, name
    rec("op.a", 0.0, 8.0)
    rec("cm.wait", 1.0, 2.0)                   # no stamps
    for name in READERS:
        assert read(name, tr) is None, name


def test_readers_return_none_once_a_span_was_dropped(monkeypatch):
    monkeypatch.setattr(port, "BUFFER", port.Buffer(cap=3))
    op = rec("op.a", 0.0, 8.0)
    rec("add.prepare", 1.0, 2.0, op)
    assert read("add.prepare_ms", window()) == pytest.approx(1000.0)
    for _ in range(2):
        rec("add.commit", 7.0, 7.5, op)
    assert port.dropped() == 1
    for name in READERS:
        assert read(name, window()) is None, name
    assert program.idle_by_span(window()) is None


def test_readers_return_none_without_the_ports_tracer(monkeypatch):
    import zpaqfranz_tpu_torch
    rec("add.prepare", 1.0, 2.0)
    monkeypatch.delattr(zpaqfranz_tpu_torch, "trace")
    monkeypatch.setitem(sys.modules, "zpaqfranz_tpu_torch.trace", None)
    assert program.records(window()) is None
    for name in READERS:
        assert read(name, window()) is None, name


def test_idle_named_by_the_operations_thread_not_a_pool_thread():
    """Idle [0, 2], [2.5, 5] and [9, 10]: named by the main thread's
    innermost span at each instant, never by the pool's ``add.digest``,
    which overlaps all of the operation's first half."""
    op = rec("op.a", 0.0, 9.0)
    rec("add.prepare", 1.0, 3.0, op)
    rec("add.digest", 0.5, 4.0, op, thread=POOL)
    tr = window(ops=((0.0, 9.0),),
                device=[("k", 2.0, 2.5), ("k", 5.0, 9.0)])
    got = program.idle_by_span(tr)
    assert got == pytest.approx({"op.a": 3.0, "add.prepare": 1.5,
                                 program.NO_SPAN: 1.0})
    out = idle.table(tr, 1.0)
    assert out["idle_s"] == pytest.approx(5.5)
    assert out["idle_below_root_pct"] == pytest.approx(100 * 1.5 / 5.5)
    assert out["spans_per_op"] == 3
    assert list(out["idle_by_span"]) == ["op.a", "add.prepare",
                                         program.NO_SPAN]


def test_idle_table_gives_each_spans_counts_per_operation():
    """The second table: per operation, a span's count and milliseconds,
    its numeric counts summed, its named counts listed, its lists left
    out."""
    for k in range(2):
        op = rec("op.a", 4.0 * k, 4.0 * k + 3.0)
        rec("add.prepare", 4.0 * k, 4.0 * k + 1.0, op, raw=100 + k, store=k)
        rec("cm.launch", 4.0 * k + 1.0, 4.0 * k + 1.5, op, lanes=3,
            hcomp=("fast", "interp")[k])
        rec("cm.wait", 4.0 * k + 1.5, 4.0 * k + 2.0, op, lane_ns=[1, 2],
            kernel_ns=2)
    tr = window(ops=((0.0, 3.0), (4.0, 7.0)))
    per = idle.table(tr, 1.0)["per_op"]
    assert per["add.prepare"] == {"count": 1.0, "ms": pytest.approx(1000.0),
                                  "counts": {"raw": 100.5, "store": 0.5}}
    assert per["cm.launch"]["counts"] == {"lanes": 3.0,
                                          "hcomp": ["fast", "interp"]}
    assert per["cm.wait"]["counts"] == {"kernel_ns": 2.0}
    assert list(per)[0] == "op.a"


def test_traced_run_reads_the_ports_spans(port_on_cpu):
    """A traced run of a tiny ``m1_b16.test`` on the CPU: the port's spans
    reach the readers through the profiler alone."""
    from cellrun import run, tiny
    result = run(tiny("m1_b16.test", 30000), seconds=2.0, trace=True)
    assert result["correct"], result["checks"]
    got = result["metrics"]
    for name in ("test.index_ms", "test.decode_blocked_pct",
                 "test.decode_busy_pct"):
        assert got[name]["value"] > 0, name
    assert got["test.decode_busy_pct"]["value"] <= 100
