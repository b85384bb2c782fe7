"""The port's device BWT (``pre/bwt_device.py``, prefix doubling over
``torch.sort``) against the reference's (JAX on the CPU) and the native
SA-IS engine, on the CPU: the same stream bytes, the same suffix array, and
the stream inverts through the -m3 inverse-BWT postprocessor; a card add's
longest jobs; jobs sorted together in one batch, calls from many threads
gathered into batches, and ``launches`` under threads. Its run on the card
is in ``tests/test_torch_card.py``."""

import sys
import threading

import numpy as np
import pytest
import torch

from zpaqfranz_tpu import native as ref_native
from zpaqfranz_tpu.pre import bwt_device as ref_bwt

from zpaqfranz_tpu_torch import native
from zpaqfranz_tpu_torch.codec.methods import make_model
from zpaqfranz_tpu_torch.pre import bwt_device as bwt


def _case(name):
    rng = np.random.default_rng(29)
    return {"empty": b"", "one": b"q", "two": b"ba",
            "255": rng.integers(0, 256, 255, dtype=np.uint8).tobytes(),
            "rep4k": (b"the quick brown fox " * 300)[:4096],
            "rand64k": rng.integers(0, 256, 64 << 10,
                                    dtype=np.uint8).tobytes(),
            "zeros": bytes(1000)}[name]


def _inverse(stream, n):
    model, _ = make_model("3")
    return native.postprocess(model.ph, model.pm,
                              b"\x01" + model.pcomp_bytes() + stream,
                              out_hint=n)


@pytest.mark.parametrize("name", ["empty", "one", "two", "255", "rep4k",
                                  "rand64k", "zeros"])
def test_bwt_matches_reference_and_native(name):
    data = _case(name)
    got = bwt.bwt_encode_device(data, device="cpu")
    assert got == native.bwt_encode(data) == ref_native.bwt_encode(data)
    assert got == ref_bwt.bwt_encode_device(data)
    assert _inverse(got, len(data)) == data


@pytest.mark.parametrize("name", ["empty", "one", "two", "255", "rep4k",
                                  "rand64k"])
def test_suffix_array_matches_reference(name):
    data = _case(name)
    got = bwt.suffix_array_device(data, device="cpu")
    assert got.dtype == np.int32
    assert np.array_equal(got, ref_bwt.suffix_array_device(data))
    suf = [data[i:] for i in got[:200]]
    assert suf == sorted(suf)


def test_prefix_doubling_stops_when_ranks_are_distinct(monkeypatch):
    """Distinct bytes: one round sorts them all; a repetitive string takes
    about log2 of its longest repeat."""
    sorts = []
    sort = torch.sort

    def counted(keys, **kw):
        sorts.append(keys.numel())
        return sort(keys, **kw)

    monkeypatch.setattr(torch, "sort", counted)
    sa, rounds = bwt.prefix_doubling(
        torch.arange(200, dtype=torch.uint8).flip(0))
    monkeypatch.undo()
    assert rounds == 1 and len(sorts) == 1
    assert sa.tolist() == list(range(199, -1, -1))
    sa, rounds = bwt.prefix_doubling(torch.zeros(1000, dtype=torch.uint8))
    assert rounds == 10 and sa.tolist() == list(range(999, -1, -1))


#: the largest BWT job of a 1 MiB block (``jidac/add.py`` ``BWT_SLACK``)
JOB = (1 << 20) - 4096


def _job(name):
    rng = np.random.default_rng(31)
    half = rng.integers(0, 256, JOB // 2, dtype=np.uint8).tobytes()
    return {"run": b"e" * JOB,
            "halves": half + half,
            "tail": rng.integers(0, 256, JOB // 2,
                                 dtype=np.uint8).tobytes() + b"\0" * (JOB // 2)
            }[name]


@pytest.mark.parametrize("name,rounds", [("run", 20), ("halves", 19),
                                         ("tail", 19)])
def test_bwt_of_the_longest_jobs_matches_native(name, rounds):
    """One byte repeated over a whole job (the most rounds a job can
    take), a job of two equal halves, and one that ends in a run of half
    its length: the native engine's stream, inverted by the postprocessor,
    in the rounds the longest repeat needs."""
    data = _job(name)
    got, took, batch = bwt.BatchedBwt("cpu").encode(data)
    assert took == rounds and batch == 1
    assert got == native.bwt_encode(data)
    assert _inverse(got, len(data)) == data


def test_jobs_sorted_together_match_each_alone():
    """Jobs of 1 byte to 64 KiB, runs and random bytes, sorted in one
    batch: each its native stream, in the rounds it takes alone."""
    rng = np.random.default_rng(41)
    datas = [b"q", b"ba", b"zz", bytes(1000), b"ab" * 3000,
             rng.integers(0, 256, 255, dtype=np.uint8).tobytes(),
             rng.integers(0, 3, 65536, dtype=np.uint8).tobytes(), b"e",
             (b"the quick brown fox " * 300)[:4096]]
    outs, rounds = bwt._streams(datas, torch.device("cpu"))
    for data, out, took in zip(datas, outs, rounds):
        assert out == native.bwt_encode(data)
        assert (out, took, 1) == bwt.BatchedBwt("cpu").encode(data)


def _threads(fn, args):
    """``fn(arg)`` on a thread each, started in turn; the threads."""
    threads = [threading.Thread(target=fn, args=(a,)) for a in args]
    for t in threads:
        t.start()
    return threads


def test_calls_waiting_on_a_batch_are_sorted_together(monkeypatch):
    """While one call's batch runs, seven more calls wait; they are sorted
    in the next batch, all seven at once, and each gets its own stream."""
    streams = bwt._streams
    batches, entered, release = [], threading.Event(), threading.Event()

    def held(datas, dev):
        batches.append(len(datas))
        entered.set()
        assert release.wait(60)
        return streams(datas, dev)
    monkeypatch.setattr(bwt, "_streams", held)
    rng = np.random.default_rng(43)
    datas = [rng.integers(0, 4, int(rng.integers(2, 3000)),
                          dtype=np.uint8).tobytes() for _ in range(8)]
    got, sorter = {}, bwt.BatchedBwt("cpu")

    def run(data):
        got[data] = sorter.encode(data)
    threads = _threads(run, datas[:1])
    assert entered.wait(60)
    threads += _threads(run, datas[1:])
    for _ in range(6000):
        with sorter._cv:
            if len(sorter._waiting) == 7:
                break
        threading.Event().wait(0.01)
    release.set()
    for t in threads:
        t.join(60)
    assert batches == [1, 7]
    assert {d: (out, batch) for d, (out, _, batch) in got.items()} == {
        d: (native.bwt_encode(d), 1 if d == datas[0] else 7) for d in datas}
    assert not sorter._waiting and not sorter._running


def test_a_failed_batch_raises_in_each_of_its_calls(monkeypatch):
    """A batch that fails raises its error in every call it held, and the
    next call sorts again."""
    def failed(datas, dev):
        raise RuntimeError("sort failed")
    monkeypatch.setattr(bwt, "_streams", failed)
    errors, sorter = [], bwt.BatchedBwt("cpu")

    def run(data):
        try:
            sorter.encode(data)
        except RuntimeError as e:
            errors.append(str(e))
    threads = _threads(run, [b"abc", b"de", b"fgh"])
    for t in threads:
        t.join(60)
    assert not any(t.is_alive() for t in threads)
    assert errors == ["sort failed"] * 3
    assert not sorter._waiting and not sorter._running
    monkeypatch.undo()
    assert sorter.encode(b"abc")[0] == native.bwt_encode(b"abc")


def test_launches_counts_every_call_of_eight_threads(monkeypatch):
    """Eight threads call one ``BatchedBwt`` at once, on a device stubbed
    as the card (the batches sorted on the CPU): ``launches`` counts every
    call, and each gets its own stream."""
    streams = bwt._streams
    monkeypatch.setattr(bwt, "resolve", lambda device: torch.device("cuda"))
    monkeypatch.setattr(bwt, "_streams", lambda datas, dev: streams(
        datas, torch.device("cpu")))
    sorter = bwt.BatchedBwt()
    rng = np.random.default_rng(37)
    datas = [rng.integers(0, 4, 64, dtype=np.uint8).tobytes()
             for _ in range(8)]
    calls, wrong = 50, []
    before = bwt.launches

    def run(data):
        for _ in range(calls):
            if sorter.encode(data)[0] != native.bwt_encode(data):
                wrong.append(data)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = _threads(run, datas)
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not wrong
    assert bwt.launches == before + calls * len(datas)
