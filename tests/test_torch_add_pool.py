"""The add prepares its jobs (their bytes, the BWT or LZ77, the store test,
a store block's coding) on the add's pool and takes them in job order
(``jidac/add.py`` ``code_jobs``), on the card and in the host engine
alike: on the CPU through the card path's launch code (``device="cpu"``,
each lane coded by the native engine), the archive is the host engine's at
every pool size; a job's failure is raised from the ``a`` without a hang;
a resumed add writes an uninterrupted add's bytes; the trace holds one
``add.prepare_wait`` a job on the operation's thread; and the card add's
BWT jobs are sorted on its device, the host engine's and the streaming
add's on the host."""

import dataclasses
import pathlib
import threading

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

import zpaqfranz_tpu_torch.device as zdevice
from benchmark import cells
from benchmark.spans import Span, Trace
from zpaqfranz_tpu_torch import cli, trace
from zpaqfranz_tpu_torch.jidac import add as port_add
from zpaqfranz_tpu_torch.ops import cm_encode as cme
from zpaqfranz_tpu_torch.parallel import engine
from zpaqfranz_tpu_torch.pre import bwt_device

from test_torch_bwt_jobs import _native_lanes, _words

DATE = 20260102030405
#: BWT; E8E9 then BWT; the level-4 CM; LZ77 + CM, where the store can fire
METHODS = ["3.0", "x0.7ci1", "4.0", "x0,1,4,0,3,16ci1"]
FRAGMENT = 10                  # 1 KiB fragments: several to a job
LIMIT = 60                     # seconds an add may take before it hangs


@pytest.fixture()
def tree(tmp_path, monkeypatch):
    """~150 KB in jobs of at most 16 KiB: text, x86-like code, and one
    incompressible file the LZ77 method's store takes."""
    orig = port_add.make_model

    def make(method):
        model, pre = orig(method)
        return model, dataclasses.replace(pre, block_bits=14)
    monkeypatch.setattr(port_add, "make_model", make)
    monkeypatch.setattr(cme, "cm_encode_plain", _native_lanes)
    monkeypatch.chdir(tmp_path)
    rng = np.random.default_rng(23)
    src = tmp_path / "src"
    (src / "sub").mkdir(parents=True)
    (src / "a.txt").write_bytes(_words(rng, 20_000)[:70_000])
    code = bytearray(rng.integers(0, 256, 30_000, dtype=np.uint8).tobytes())
    for at in range(0, len(code) - 5, 97):
        code[at:at + 5] = bytes([0xE8, code[at + 1], code[at + 2], 0, 0])
    (src / "b.bin").write_bytes(bytes(code))
    (src / "sub" / "c.rnd").write_bytes(
        rng.integers(0, 256, 40_000, dtype=np.uint8).tobytes())
    (src / "sub" / "d.txt").write_bytes(_words(rng, 3_000)[:12_000])
    return src


def card_add(name, method, threads, use_device=True, **kw):
    """The add through the card path's launch code on the CPU, or with
    ``use_device=False`` through the host engine."""
    return port_add.add(name, ["src"], method=method, date=DATE,
                        fragment_bits=FRAGMENT, threads=threads,
                        use_device=use_device, device="cpu", **kw)


def bounded(fn):
    """Run ``fn`` on a thread of its own; its result, or its exception,
    within ``LIMIT`` seconds."""
    out = {}

    def run():
        try:
            out["value"] = fn()
        except BaseException as e:        # noqa: BLE001 - handed back
            out["error"] = e
    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(LIMIT)
    assert not t.is_alive(), f"hung for {LIMIT} s"
    if "error" in out:
        raise out["error"]
    return out["value"]


#: the preprocessor's entry, before any test's spy
PREPARE = port_add.prepare_payload


def spy_prepares(monkeypatch, fail=None):
    """Spy on ``prepare_payload``: each call's raw bytes, in the order of
    the calls, and the store decisions. ``fail`` = (k, raw): the job of
    those bytes raises ``job k failed``."""
    seen = {"raws": [], "stored": 0}
    lock = threading.Lock()

    def spy(pre, raw, bwt=None):
        with lock:
            seen["raws"].append(raw)
        if fail is not None and raw == fail[1]:
            raise RuntimeError(f"job {fail[0]} failed")
        payload, store = PREPARE(pre, raw, bwt)
        with lock:
            seen["stored"] += int(store)
        return payload, store
    monkeypatch.setattr(port_add, "prepare_payload", spy)
    return seen


def jobs_in_order(monkeypatch, name, method):
    """Each job's raw bytes, from an add on one pool worker."""
    seen = spy_prepares(monkeypatch)
    card_add(name, method, 1)
    return seen["raws"]


@pytest.mark.parametrize("method", METHODS)
def test_card_add_writes_the_host_bytes_at_every_pool_size(tree, method,
                                                           monkeypatch):
    """One pool worker, four, and the host engine: the same archive."""
    port_add.add("h.zpaq", ["src"], method=method, date=DATE,
                 fragment_bits=FRAGMENT, use_device=False)
    jobs = jobs_in_order(monkeypatch, "one.zpaq", method)
    seen = spy_prepares(monkeypatch)
    card_add("four.zpaq", method, 4)
    assert len(jobs) >= 8 and sorted(seen["raws"]) == sorted(jobs)
    assert (seen["stored"] > 0) == (method == "x0,1,4,0,3,16ci1")
    host = pathlib.Path("h.zpaq").read_bytes()
    assert pathlib.Path("one.zpaq").read_bytes() == host
    assert pathlib.Path("four.zpaq").read_bytes() == host


@pytest.mark.parametrize("use_device", [True, False])
@pytest.mark.parametrize("threads", [1, 4])
@pytest.mark.parametrize("k", [0, 5])
def test_a_failed_job_is_raised_without_a_hang(tree, monkeypatch, threads,
                                               k, use_device):
    """The failing job's own error leaves the ``a``, on the card path and
    in the host engine; nothing is written."""
    jobs = jobs_in_order(monkeypatch, "u.zpaq", "3.0")
    spy_prepares(monkeypatch, fail=(k, jobs[k]))
    with pytest.raises(RuntimeError, match=f"job {k} failed"):
        bounded(lambda: card_add("f.zpaq", "3.0", threads, use_device))
    assert not pathlib.Path("f.zpaq").exists()
    assert not pathlib.Path("f.zpaq.spill").exists()


@pytest.mark.parametrize("method", ["3.0", "x0,1,4,0,3,16ci1"])
def test_resumed_add_writes_the_uninterrupted_bytes(tree, monkeypatch,
                                                    method):
    """Launches of 2 lanes; the add fails at the 7th job and leaves the
    journal of the 6 blocks taken before it; the resumed add prepares and
    waits for only the rest, and writes the bytes of an add that never
    stopped."""
    monkeypatch.setattr(engine, "lanes_per_launch", lambda *a: 2)
    jobs = jobs_in_order(monkeypatch, "u.zpaq", method)
    spy_prepares(monkeypatch, fail=(6, jobs[6]))
    with pytest.raises(RuntimeError, match="job 6 failed"):
        bounded(lambda: card_add("r.zpaq", method, 4, resume=True))
    journal = port_add.ResumeJournal.load_or_create(
        pathlib.Path("r.zpaq.resume"), DATE, method)
    kept = len(journal.cache)
    journal._f.close()
    assert kept == 6
    seen = spy_prepares(monkeypatch)
    trace.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        card_add("r.zpaq", method, 4, resume=True)
    waits = [r for r in trace.records() if r.name == "add.prepare_wait"]
    trace.clear()
    assert sorted(seen["raws"]) == sorted(jobs[6:])
    assert len(waits) == len(jobs) - 6
    assert pathlib.Path("r.zpaq").read_bytes() == \
        pathlib.Path("u.zpaq").read_bytes()
    assert not pathlib.Path("r.zpaq.resume").exists()


@pytest.mark.parametrize("engine_flag", ["-tpu", "-notpu"])
def test_trace_holds_a_prepare_wait_a_job(tree, monkeypatch, engine_flag):
    """Under the profiler, on the card path and in the host engine: one
    ``add.prepare_wait`` a job on the operation's thread, each
    ``add.prepare`` on a pool thread under ``op.a`` with its ``pre.bwt``
    inside it, and ``add.prepare_wait_ms`` reads the waits."""
    orig = zdevice.resolve
    monkeypatch.setattr(zdevice, "resolve",
                        lambda device=None: orig("cpu" if device is None
                                                 else device))
    trace.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        assert cli.main(["a", "t.zpaq", "src", "-method", "3.0",
                         engine_flag, "-threads", "4",
                         "-fragment", "0"]) == 0  # 2^10
    recs = trace.records()
    op = next(r for r in recs if r.name == "op.a")
    waits = [r for r in recs if r.name == "add.prepare_wait"]
    prepares = {r.id: r for r in recs if r.name == "add.prepare"}
    bwts = [r for r in recs if r.name == "pre.bwt"]
    assert len(waits) == len(prepares) == len(bwts) >= 8
    assert all(r.thread == op.thread and r.parent == op.id for r in waits)
    assert all(r.counts["ready"] in (0, 1) for r in waits)
    assert all(r.parent == op.id and r.thread != op.thread
               for r in prepares.values())
    for r in bwts:
        p = prepares[r.parent]
        assert p.start <= r.start and r.end <= p.end
    tr = Trace((op.start, op.end), [Span("op", op.start, op.end)], [], [],
               {})
    got = cells.reader("add.prepare_wait_ms")(tr)
    trace.clear()
    assert got == pytest.approx(
        1000.0 * sum(r.seconds for r in waits)) and got > 0


#: the streaming add's form of each BWT method
STREAMING = {"3.0": "s0.3ci1", "x0.7ci1": "s0.7ci1"}


def bwt_counts(run):
    """``run()`` under the profiler and an operation's root span: the
    ``pre.bwt`` spans' counts."""
    trace.clear()
    with profile(activities=[ProfilerActivity.CPU]), trace.span("op.a"):
        run()
    got = [r.counts for r in trace.records() if r.name == "pre.bwt"]
    trace.clear()
    return got


@pytest.mark.parametrize("method", ["3.0", "x0.7ci1"])
def test_card_add_sorts_every_bwt_job_on_its_device(tree, monkeypatch,
                                                    method):
    """Every BWT job of the card add goes through ``bwt_device`` on the
    add's device (``card`` 1, its rounds and its batch of at most the
    pool's four jobs counted); the host engine add and the streaming add
    never call it (``card``, ``rounds`` and ``batch`` 0); the card add
    writes the host engine's bytes."""
    calls = []
    lock = threading.Lock()
    encode = bwt_device.BatchedBwt.encode

    def spy(self, data):
        with lock:
            calls.append(self.dev)
        return encode(self, data)
    monkeypatch.setattr(bwt_device.BatchedBwt, "encode", spy)
    host = bwt_counts(lambda: card_add("h.zpaq", method, 4,
                                       use_device=False))
    stream = bwt_counts(lambda: port_add.add(
        "s.zpaq", ["src"], method=STREAMING[method], date=DATE,
        device="cpu"))
    assert not calls
    assert len(host) >= 8 and stream
    assert all(c["card"] == c["rounds"] == c["batch"] == 0
               for c in host + stream)
    card = bwt_counts(lambda: card_add("c.zpaq", method, 4))
    assert len(calls) == len(card) == len(host)
    assert all(str(d) == "cpu" for d in calls)
    assert all(c["card"] == 1 and c["rounds"] > 0 and 1 <= c["batch"] <= 4
               for c in card)
    assert pathlib.Path("c.zpaq").read_bytes() == \
        pathlib.Path("h.zpaq").read_bytes()

