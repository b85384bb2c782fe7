"""The port's tracer (``zpaqfranz_tpu_torch/trace.py``) on the CPU: off it
records nothing; under ``torch.profiler`` it records an add, a test and a
damaged test through the CLI on the plain PyTorch versions, every span
under its operation's root, children inside their parents, pool threads'
spans under the span that handed them the work; the buffer is capped; the
profiler's ``zpaq::`` ranges lie on the records' clock."""

import concurrent.futures
import dataclasses
import json
import re
import time

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile, record_function

import zpaqfranz_tpu_torch.device as zdevice
from zpaqfranz_tpu_torch import cli, trace
from zpaqfranz_tpu_torch.jidac import add as port_add, extract as port_extract
from zpaqfranz_tpu_torch.jidac.index import read_archive

DATE = 20260102030405


def profiled():
    return profile(activities=[ProfilerActivity.CPU])


@pytest.fixture(autouse=True)
def fresh():
    trace.clear()
    yield
    trace.clear()


@pytest.fixture()
def lanes_on_cpu(monkeypatch):
    """``-tpu`` runs the lane paths' plain PyTorch versions on the CPU."""
    orig = zdevice.resolve
    monkeypatch.setattr(zdevice, "resolve",
                        lambda device=None: orig("cpu" if device is None
                                                 else device))
    monkeypatch.setattr(port_add, "now_date", lambda: DATE)


@pytest.fixture()
def small_blocks(monkeypatch):
    """256-byte d blocks, so a small tree makes several blocks."""
    orig = port_add.make_model

    def make(method):
        model, pre = orig(method)
        return model, dataclasses.replace(pre, block_bits=8)
    monkeypatch.setattr(port_add, "make_model", make)


def check_tree(recs):
    """Every record under its operation's root: the root an ``op.`` span,
    each child's interval inside its parent's."""
    ids = {r.id: r for r in recs}
    for r in recs:
        root = ids[r.root]
        assert root.parent is None and root.name.startswith("op."), r.name
        assert r.end >= r.start > 0
        if r.parent is not None:
            p = ids[r.parent]
            assert p.root == r.root
            assert p.start <= r.start and r.end <= p.end, (r.name, p.name)


def test_off_records_nothing_and_hands_out_the_shared_handle():
    assert not trace.enabled()
    s = trace.span("op.x", files=3)
    assert s is trace.OFF
    assert trace.span("child", parent=trace.current()) is trace.OFF
    assert trace.span("child", parent=trace.OFF) is trace.OFF
    with s as h:
        h.add(bytes=5)
        with trace.span("inner"):
            assert trace.current() is None
    assert trace.records() == [] and trace.dropped() == 0


def test_spans_nest_add_counts_and_record_errors():
    with profiled():
        assert trace.enabled()
        with trace.span("op.z", files=1) as op:
            op.add(files=2, hcomp="fast")
            with trace.span("inner") as inner:
                assert trace.current() is inner
            with pytest.raises(ValueError):
                with trace.span("fails"):
                    raise ValueError("no")
            assert trace.current() is op
    recs = {r.name: r for r in trace.records()}
    assert recs["op.z"].counts == {"files": 3, "hcomp": "fast"}
    assert recs["inner"].parent == recs["op.z"].id
    assert recs["fails"].counts == {"error": "ValueError"}
    assert "error" not in recs["op.z"].counts
    check_tree(list(recs.values()))
    assert trace.current() is None


def test_pool_threads_record_under_the_parent_they_are_handed():
    def work(parent):
        with trace.span("job", parent=parent):
            time.sleep(0.001)
        with trace.span("orphan"):       # no parent: the profiler is off here
            pass
        return trace.current()

    with profiled(), trace.span("op.p") as op, \
            concurrent.futures.ThreadPoolExecutor(2) as ex:
        left = list(ex.map(work, [trace.current()] * 4))
    assert left == [None] * 4
    jobs = [r for r in trace.records() if r.name == "job"]
    assert len(jobs) == 4 and {r.parent for r in jobs} == {op.id}
    assert all(r.thread != op.thread for r in jobs)
    assert "orphan" not in {r.name for r in trace.records()}
    check_tree(trace.records())


def test_buffer_is_capped_and_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(trace, "BUFFER", trace.Buffer(cap=3))
    with profiled():
        for k in range(5):
            with trace.span(f"s{k}"):
                pass
    assert [r.name for r in trace.records()] == ["s0", "s1", "s2"]
    assert trace.dropped() == 2
    trace.clear()
    assert trace.records() == [] and trace.dropped() == 0


def test_profiler_ranges_lie_on_the_records_clock(tmp_path):
    """The profiler's ``zpaq::<name>`` ranges, shifted onto the host clock
    by an anchor range as the benchmark shifts the device's events, start
    where their records start."""
    with profiled() as prof:
        with record_function("bench::window"):
            anchor = time.perf_counter()
            for name in ("alpha", "beta", "gamma"):
                with trace.span(name):
                    time.sleep(0.003)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    ts0 = next(e["ts"] for e in events if e.get("name") == "bench::window"
               and e.get("cat") == "user_annotation")
    shift = anchor - float(ts0) / 1e6
    ranges = {e["name"][len("zpaq::"):]: float(e["ts"]) / 1e6 + shift
              for e in events if e.get("name", "").startswith("zpaq::")
              and e.get("cat") == "user_annotation"}
    recs = {r.name: r for r in trace.records()}
    assert set(ranges) == set(recs) == {"alpha", "beta", "gamma"}
    for name, start in ranges.items():
        assert abs(start - recs[name].start) < 1e-3, name


def test_add_records_its_layers_under_op_a(tmp_path, monkeypatch,
                                           lanes_on_cpu):
    """A tiny ``-method 4.0`` add on the plain CM coder."""
    monkeypatch.chdir(tmp_path)
    (tmp_path / "tree" / "sub").mkdir(parents=True)
    (tmp_path / "tree" / "a.txt").write_bytes(b"cat sat mat ")
    (tmp_path / "tree" / "sub" / "b.txt").write_bytes(b"the zpaq lane")
    with profiled():
        assert cli.main(["a", "t.zpaq", "tree", "-method", "4.0",
                         "-tpu"]) == 0
    recs = trace.records()
    check_tree(recs)
    names = [r.name for r in recs]
    for name in ("op.a", "add.scan", "add.digest", "add.digest_wait",
                 "add.plan", "add.prepare", "engine.pack",
                 "engine.unpack", "add.assemble", "add.spill",
                 "add.commit"):
        assert name in names, name
    op = next(r for r in recs if r.name == "op.a")
    assert op.counts == {"rc": 0}
    digests = [r for r in recs if r.name == "add.digest"]
    assert sum(r.counts["bytes"] for r in digests) == 25
    assert all(r.parent == op.id and r.thread != op.thread for r in digests)
    assert names.count("add.digest_wait") == 2
    assert sum(r.counts["raw"] for r in recs if r.name == "add.prepare") == 25
    assert names.count("add.assemble") == names.count("add.spill") - 1
    commit = next(r for r in recs if r.name == "add.commit")
    assert commit.counts["bytes"] == (tmp_path / "t.zpaq").stat().st_size


def test_x_records_its_layers_under_op_x(tmp_path, monkeypatch,
                                         lanes_on_cpu):
    """A tiny ``-method 4.0`` archive (the host engine's) restored on the
    plain CM decoder."""
    monkeypatch.chdir(tmp_path)
    (tmp_path / "tree").mkdir()
    (tmp_path / "tree" / "a.txt").write_bytes(b"cat sat mat ")
    (tmp_path / "tree" / "b.txt").write_bytes(b"the zpaq lane")
    assert cli.main(["a", "t.zpaq", "tree", "-method", "4.0",
                     "-notpu"]) == 0
    trace.clear()
    with profiled():
        assert cli.main(["x", "t.zpaq", "-to", "out", "-tpu"]) == 0
    recs = trace.records()
    check_tree(recs)
    one = {r.name: r for r in recs}
    assert [r.name for r in recs].count("extract.read") == 1
    assert one["engine.pack"].counts["lanes"] == 1
    assert one["extract.verify"].counts == {"fragments": 2, "bytes": 25}
    assert one["extract.write"].counts == {"files": 2, "bytes": 25}
    assert one["op.x"].counts == {"rc": 0}
    assert "extract.postprocess" in one and "engine.unpack" in one


def m1_archive(tmp_path):
    rng = np.random.default_rng(5)
    (tmp_path / "tree").mkdir()
    words = [b"lane ", b"block ", b"zpaq ", b"fragment "]
    for k in range(7):
        text = b"".join(words[i] for i in rng.integers(0, 4, 60 + 20 * k))
        (tmp_path / "tree" / f"f{k}.txt").write_bytes(text)
    assert cli.main(["a", "m1.zpaq", "tree", "-m1", "-notpu"]) == 0
    return read_archive((tmp_path / "m1.zpaq").read_bytes())


def test_t_records_a_decode_per_block_and_a_hash_per_batch(
        tmp_path, monkeypatch, lanes_on_cpu, small_blocks, capsys):
    monkeypatch.chdir(tmp_path)
    jd = m1_archive(tmp_path)
    monkeypatch.setattr(port_extract, "VERIFY_BATCH_BYTES", 1024)
    batches = len(port_extract._batches(jd))
    assert len(jd.block) >= 6 and batches >= 3
    capsys.readouterr()
    with profiled():
        assert cli.main(["t", "m1.zpaq", "-tpu"]) == 0
    m = re.search(r"tested (\d+) blocks, (\d+) fragments",
                  capsys.readouterr().out)
    recs = trace.records()
    check_tree(recs)
    one = {r.name: r for r in recs}
    assert one["verify"].counts == {"threads": one["verify"].counts[
        "threads"], "batches": batches, "blocks": len(jd.block)}
    assert one["jidac.index"].counts["blocks"] == len(jd.block)
    decodes = [r for r in recs if r.name == "verify.decode"]
    assert len(decodes) == len(jd.block) == int(m.group(1))
    assert {r.parent for r in decodes} == {one["verify"].id}
    assert sum(r.counts["usize"] for r in decodes) == sum(
        b.usize for b in jd.block)
    hashes = [r for r in recs if r.name == "verify.hash"]
    assert len(hashes) == batches
    assert sum(r.counts["fragments"] for r in hashes) == int(m.group(2))
    assert [r.name for r in recs].count("verify.decode_wait") == batches


def test_damaged_archive_closes_every_span_with_its_error(
        tmp_path, monkeypatch, lanes_on_cpu, small_blocks, capsys):
    """The last fragment's stored SHA-1 damaged (a byte of its h block):
    ``t`` hashes every fragment and fails in the last batch's hash."""
    monkeypatch.chdir(tmp_path)
    jd = m1_archive(tmp_path)
    monkeypatch.setattr(port_extract, "VERIFY_BATCH_BYTES", 1024)
    path = tmp_path / "m1.zpaq"
    data = bytearray(path.read_bytes())
    last = len(jd.ht) - 1
    at = data.find(jd.ht[last].sha1)
    assert at > 0 and data.count(jd.ht[last].sha1) == 1
    data[at + 7] ^= 0xFF
    path.write_bytes(bytes(data))
    with profiled():
        assert cli.main(["t", "m1.zpaq", "-tpu"]) == 2
    assert f"fragment {last}: checksum failed" in capsys.readouterr().err
    recs = trace.records()
    check_tree(recs)
    failed = [r.name for r in recs if "error" in r.counts]
    assert failed == ["verify.hash", "verify", "op.t"]
    assert {r.counts["error"] for r in recs
            if "error" in r.counts} == {"ExtractError"}
    hashes = [r for r in recs if r.name == "verify.hash"]
    assert len(hashes) == len(port_extract._batches(jd))
    assert trace.current() is None
