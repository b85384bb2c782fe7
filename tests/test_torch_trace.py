"""The port's tracer (``zpaqfranz_tpu_torch/trace.py``) on the CPU: off it
records nothing; under ``torch.profiler`` it records an add, a test and a
damaged test through the CLI on the plain PyTorch versions, every span
under its operation's root, children inside their parents, pool threads'
spans under the span that handed them the work; the buffer is capped; the
profiler's ``zpaq::`` ranges lie on the records' clock; a CM launch
prepared on the CPU counts its lane state and its lanes' coded bits only
while traced."""

import concurrent.futures
import dataclasses
import json
import re
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

import zpaqfranz_tpu_torch.device as zdevice
from zpaqfranz_tpu_torch import cli, trace
from zpaqfranz_tpu_torch.codec.methods import make_model
from zpaqfranz_tpu_torch.jidac import add as port_add, extract as port_extract
from zpaqfranz_tpu_torch.jidac.index import read_archive
from zpaqfranz_tpu_torch.ops import build, cm_decode as cmd, cm_encode as cme
from zpaqfranz_tpu_torch.ops.cm_model import lane_bytes
from zpaqfranz_tpu_torch.parallel.engine import selector

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
            with trace.span("inner"):    # under the span it was handed
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
    inner = [r for r in trace.records() if r.name == "inner"]
    assert sorted(r.parent for r in inner) == sorted(r.id for r in jobs)
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


def bwt_tree(tmp_path):
    (tmp_path / "tree").mkdir()
    (tmp_path / "tree" / "a.txt").write_bytes(b"banana bandana " * 3)
    (tmp_path / "tree" / "b.txt").write_bytes(b"the bwt lane")


@pytest.mark.parametrize("engine", ["-notpu", "-tpu"])
def test_bwt_is_recorded_under_add_prepare(tmp_path, monkeypatch,
                                           lanes_on_cpu, engine):
    """A tiny ``-method 3.0`` add: one ``pre.bwt`` with the job's raw
    bytes inside each ``add.prepare``, on the host engine's pool threads
    (handed ``op.a``; ``card``, ``rounds`` and ``batch`` 0) and on the
    card path (the plain CM coder; the suffix sort on its device, ``card``
    1, its rounds, and a batch of the one job)."""
    monkeypatch.chdir(tmp_path)
    bwt_tree(tmp_path)
    with profiled():
        assert cli.main(["a", "t.zpaq", "tree", "-method", "3.0",
                         engine]) == 0
    recs = trace.records()
    check_tree(recs)
    prepares = {r.id: r for r in recs if r.name == "add.prepare"}
    bwts = [r for r in recs if r.name == "pre.bwt"]
    assert len(prepares) == len(bwts) == 1
    assert sorted(r.parent for r in bwts) == sorted(prepares)
    card = int(engine == "-tpu")
    for r in bwts:
        assert set(r.counts) == {"bytes", "card", "rounds", "batch"}
        assert r.counts["bytes"] == prepares[r.parent].counts["raw"]
        assert r.counts["card"] == card
        assert (r.counts["rounds"] > 0) == bool(card)
        assert r.counts["batch"] == card
    assert sum(r.counts["bytes"] for r in bwts) == 57
    op = next(r for r in recs if r.name == "op.a")
    assert all(r.parent == op.id for r in prepares.values())


def test_bwt_span_records_nothing_with_tracing_off(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    bwt_tree(tmp_path)
    assert trace.span("pre.bwt", bytes=1) is trace.OFF
    assert cli.main(["a", "t.zpaq", "tree", "-method", "3.0",
                     "-notpu"]) == 0
    assert trace.records() == [] and trace.dropped() == 0


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


def cpu_launch(kind):
    """``kind`` (a lane kernel's launch) prepared on the CPU, whose kernel
    call ``no_kernel`` stands in for."""
    class CpuLaunch(kind):
        def __init__(self, model, src, in_off, in_len, out_cap, **kw):
            self.prepare(model, src, in_off, in_len, out_cap, **kw)
    return CpuLaunch


def no_kernel(unit, symbol, device, *args, written, **hints):
    """The kernel's writes: each lane's output length (its index + 5), a
    status of 0, and stamps 1,000 ns apart."""
    out_len, status, *stamps = written
    out_len.copy_(torch.arange(5, 5 + out_len.numel()))
    status.zero_()
    for t in stamps:
        t[:, 0] = 1000
        t[:, 1] = 1000 * torch.arange(2, 2 + t.shape[0])


@pytest.mark.parametrize("method", ["3", "4.0", "5.0"])
def test_cm_launch_counts_its_state_and_each_lanes_bits(monkeypatch,
                                                         method):
    """Traced, ``cm.launch`` counts the lanes' state on the device (L x
    ``lane_bytes`` of the launch's HCOMP step) and ``cm.wait`` each lane's
    coded bits, 8 x its payload (an encode lane's input, a decode lane's
    output), in the order of ``lane_ns``; untraced, nothing is recorded
    and no launch stamps."""
    monkeypatch.setattr(build, "call", no_kernel)
    model = make_model(method)[0]
    raws = [selector(model) + b"the cat sat on the mat" * k
            for k in (1, 3)]
    src = torch.frombuffer(bytearray(b"".join(raws)), dtype=torch.uint8)
    lens = torch.tensor([len(r) for r in raws])
    offs = torch.tensor([0, len(raws[0])])
    for kind, bits in ((cme.Launch, 8 * lens), (cmd.Launch,
                                                8 * torch.tensor([5, 6]))):
        launch = cpu_launch(kind)
        launch.code(model, src, offs, lens, lens + 64)
        assert trace.records() == []
        with profiled():
            launch.code(model, src, offs, lens, lens + 64)
        recs = {r.name: r for r in trace.records()}
        trace.clear()
        assert recs["cm.launch"].counts["state_bytes"] == \
            2 * lane_bytes(model, recs["cm.launch"].counts["hcomp"])
        wait = recs["cm.wait"].counts
        assert wait["lane_ns"] == [1000, 2000]
        assert wait["lane_bits"] == bits.tolist()
    interp = cpu_launch(cme.Launch)(model, src, offs, lens, lens + 64,
                                    hcomp="interp")
    assert interp.stamps is None
    assert interp.state_bytes() == 2 * lane_bytes(model, "interp")
