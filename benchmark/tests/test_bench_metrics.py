import pytest

from benchmark import cells
from benchmark.roofline import peaks, sha1_lanes
from benchmark.spans import Span, Trace

CFG = {"components": [[2, 20, 0]]}
SHA1 = ("void hash_lanes::lanes_kernel<(anonymous namespace)::Sha1, false>"
        "(unsigned char const*)")


def trace(spans=(), device=(), ops=((0.0, 8.0),)):
    return Trace((0.0, 10.0), [Span("op", s, e) for s, e in ops],
                 list(spans), list(device), CFG)


def read(name, tr):
    return cells.reader(name)(tr)


def test_add_readers():
    tr = trace([Span("encode_streams", 2.0, 7.0,
                     {"in_bytes": [100, 200], "out_bytes": [50, 60]})],
               [("(anonymous namespace)::cm_encode_kernel(int)", 2.5, 6.5),
                ("Memcpy DtoH (Device -> Pageable)", 7.0, 7.5)])
    assert read("add.host_pct", tr) == pytest.approx(100 * 3 / 8)
    assert read("add.lanes_per_launch", tr) == 2
    bound = peaks.bound_seconds(8 * 300 * 27, 300 + 110)
    assert read("cm_encode_roofline", tr) == pytest.approx(100 * bound / 4)
    assert read("device.idle_pct.add", tr) == pytest.approx(55.0)


def test_extract_readers():
    tr = trace([Span("decode_streams", 1.0, 5.0,
                     {"in_bytes": [40], "out_bytes": [100]})],
               [("cm_decode_kernel", 1.5, 4.5)])
    assert read("extract.host_pct", tr) == pytest.approx(50.0)
    bound = peaks.bound_seconds(8 * 100 * 27, 140)
    assert read("cm_decode_roofline", tr) == pytest.approx(100 * bound / 3)
    assert read("device.idle_pct.extract", tr) == pytest.approx(70.0)


def test_test_readers():
    tr = trace([Span("check_lanes", 1.0, 2.0), Span("check_lanes", 5.0, 6.5),
                Span("stage_bytes", 1.0, 1.25), Span("stage_bytes", 5.0, 5.5),
                Span("sha1_lanes", 1.3, 1.4, {"lengths": [1000, 10]}),
                Span("sha1_lanes", 5.6, 5.7, {"lengths": [64]})],
               [(SHA1, 1.5, 1.502), (SHA1, 5.8, 5.801),
                ("Memcpy HtoD (Pinned -> Device)", 1.3, 1.4)],
               ops=((0.0, 3.0), (4.0, 7.0)))
    assert read("test.decode_wait_pct", tr) == pytest.approx(
        100 * (6 - 2.5) / 6)
    assert read("test.stage_ms", tr) == pytest.approx(1000 * 0.75 / 2)
    ops = sha1_lanes.OPS_PER_BLOCK * (16 + 1 + 2)
    bound = peaks.bound_seconds(ops, 1074 + 60)
    assert read("sha1_lanes_roofline", tr) == pytest.approx(
        100 * bound / 0.003)
    assert read("device.idle_pct.test", tr) == pytest.approx(
        100 * (1 - 0.103 / 10))


def test_readers_with_nothing_to_read_return_none():
    empty = Trace((0.0, 10.0), [], [], [], CFG)
    for m in ("add.host_pct", "add.lanes_per_launch", "cm_encode_roofline",
              "device.idle_pct.add", "extract.host_pct",
              "cm_decode_roofline", "device.idle_pct.extract",
              "test.decode_wait_pct", "test.stage_ms",
              "sha1_lanes_roofline", "device.idle_pct.test"):
        assert read(m, empty) is None, m


def test_gaps_named_by_the_innermost_span():
    tr = trace([Span("encode_streams", 2.0, 7.0)], [("k", 1.0, 3.0)],
               ops=((0.0, 7.5),))
    assert tr.busy() == [(1.0, 3.0)]
    assert tr.gaps() == [("encode_streams", 7.0), ("op", 1.0)]
    after = trace([], [("k", 1.0, 3.0)], ops=((0.0, 5.0),))
    assert after.gaps()[0] == ("between operations", 7.0)
    b = tr.breakdown()
    assert b["device_ops"] == [["k", 2.0]]
    assert b["idle_gaps"] == [["encode_streams", 7.0], ["op", 1.0]]
