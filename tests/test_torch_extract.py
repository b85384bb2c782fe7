"""The port's archive path against the reference package: archives written
by the reference ``add`` restore through the port's ``extract`` (lanes on
the CPU through the plain versions, and the host engine), ``verify_archive``
counts agree, damage raises, and the port's ``add`` (encode lanes on the CPU
through the plain version, and the host engine) writes the reference's
bytes."""

import hashlib
import pathlib
import sys

import numpy as np
import pytest
import torch

from zpaqfranz_tpu.jidac.add import add as ref_add
from zpaqfranz_tpu.jidac.extract import extract as ref_extract
from zpaqfranz_tpu.jidac.extract import verify_archive as ref_verify
from zpaqfranz_tpu.jidac.index import read_archive as ref_read

from zpaqfranz_tpu_torch.cli import main as cli_main
from zpaqfranz_tpu_torch.device import NoDeviceError
from zpaqfranz_tpu_torch.jidac.add import add
from zpaqfranz_tpu_torch.jidac.extract import (ExtractError, extract,
                                               verify_archive)
from zpaqfranz_tpu_torch.jidac.index import read_archive
from zpaqfranz_tpu_torch.ops import cm_decode as cmd, cm_encode as cme, sha1

DATE = 20260102030405


@pytest.fixture()
def tree(tmp_path, monkeypatch):
    """The tree of tests/test_jidac.py at a size the plain CM decoder
    restores in seconds."""
    src = tmp_path / "src"
    (src / "sub").mkdir(parents=True)
    (src / "a.txt").write_bytes(b"hello world " * 12)
    (src / "b.bin").write_bytes(bytes(range(0, 256, 2)))
    (src / "sub" / "c.txt").write_bytes(b"fox " * 30)
    (src / "empty").write_bytes(b"")
    monkeypatch.chdir(tmp_path)
    return src


def _files(root: pathlib.Path):
    return {str(p.relative_to(root)): p.read_bytes()
            for p in root.rglob("*") if p.is_file()}


@pytest.mark.parametrize("method", ["0", "3", "4.0"])
def test_reference_archive_restores_through_port(tree, tmp_path, method):
    arc = tmp_path / "r.zpaq"
    ref_add(str(arc), ["src"], method=method, date=DATE)
    data = arc.read_bytes()
    jd = read_archive(data)
    want = _files(tmp_path / "src")

    ref_extract(data, ref_read(data), str(tmp_path / "ref"))
    assert _files(tmp_path / "ref" / "src") == want

    before = (cmd.launches, sha1.launches)
    n, total = extract(data, jd, str(tmp_path / "lanes"), device="cpu")
    assert (n, total) == (4, sum(map(len, want.values())))
    assert _files(tmp_path / "lanes" / "src") == want

    extract(data, jd, str(tmp_path / "host"), use_device=False)
    assert _files(tmp_path / "host" / "src") == want

    counts = ref_verify(data, ref_read(data), use_device=False)
    assert verify_archive(data, jd, device="cpu") == counts
    assert verify_archive(data, jd, use_device=False) == counts
    # the CPU ran the plain versions: no kernel launched
    assert (cmd.launches, sha1.launches) == before



def test_port_host_add_writes_reference_bytes(tree, tmp_path):
    for method in ("1", "3", "4.0"):
        ref_add(str(tmp_path / f"r{method}.zpaq"), ["src"], method=method,
                date=DATE)
        add(str(tmp_path / f"p{method}.zpaq"), ["src"], method=method,
            date=DATE, use_device=False)
        assert (tmp_path / f"p{method}.zpaq").read_bytes() == \
            (tmp_path / f"r{method}.zpaq").read_bytes(), method


@pytest.mark.parametrize("method", ["3", "4.0"])
def test_device_add_writes_reference_bytes(tree, tmp_path, capsys, method):
    """Encode lanes on the CPU (the plain version) write the bytes of the
    reference's host add and of its device add (JAX on the CPU)."""
    before = cme.launches
    add(str(tmp_path / "p.zpaq"), ["src"], method=method, date=DATE,
        device="cpu")
    assert cme.launches == before          # no kernel: the plain version
    ref_add(str(tmp_path / "h.zpaq"), ["src"], method=method, date=DATE,
            use_device=False)
    ref_add(str(tmp_path / "d.zpaq"), ["src"], method=method, date=DATE,
            use_device=True)
    # the reference's device add did not fall back to its host engine
    assert "falling back" not in capsys.readouterr().err
    data = (tmp_path / "p.zpaq").read_bytes()
    assert data == (tmp_path / "h.zpaq").read_bytes()
    assert data == (tmp_path / "d.zpaq").read_bytes()
    extract(data, read_archive(data), str(tmp_path / "out"),
            use_device=False)
    assert _files(tmp_path / "out" / "src") == _files(tmp_path / "src")


def test_device_add_keeps_the_resume_journal(tree, tmp_path):
    """-resume on the encode lanes: blocks go through the journal, the
    archive bytes stay the host's and the journal is removed."""
    add(str(tmp_path / "h.zpaq"), ["src"], method="3", date=DATE,
        use_device=False)
    add(str(tmp_path / "p.zpaq"), ["src"], method="3", date=DATE,
        device="cpu", resume=True)
    assert (tmp_path / "p.zpaq").read_bytes() == \
        (tmp_path / "h.zpaq").read_bytes()
    assert not (tmp_path / "p.zpaq.resume").exists()


@pytest.mark.parametrize("method,where", [("0", 200), ("3", -30)])
def test_damaged_block_raises(tree, tmp_path, method, where):
    """A flipped byte inside a d block: a store block fails its fragment
    checksum, a modeled block fails its lane or its checksum."""
    arc = tmp_path / "t.zpaq"
    ref_add(str(arc), ["src"], method=method, date=DATE)
    data = bytearray(arc.read_bytes())
    blk = read_archive(bytes(data)).block[0]
    data[blk.offset + (where if where > 0 else blk.bsize + where)] ^= 0xFF
    jd = read_archive(bytes(data))
    with pytest.raises(ExtractError):
        extract(bytes(data), jd, str(tmp_path / "out"), device="cpu")
    with pytest.raises(Exception):
        verify_archive(bytes(data), jd, device="cpu")


def test_no_card_raises_instead_of_falling_back(tree, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    ref_add(str(tmp_path / "t.zpaq"), ["src"], method="3", date=DATE)
    data = (tmp_path / "t.zpaq").read_bytes()
    jd = read_archive(data)
    with pytest.raises(NoDeviceError):
        extract(data, jd, str(tmp_path / "out"))
    with pytest.raises(NoDeviceError):
        verify_archive(data, jd)
    assert not (tmp_path / "out").exists()
    # the CLI: x and t take the card unless -notpu asks for the host
    assert cli_main(["t", str(tmp_path / "t")]) == 2
    assert cli_main(["t", str(tmp_path / "t"), "-notpu"]) == 0
    assert cli_main(["x", str(tmp_path / "t"), "-to",
                     str(tmp_path / "cli"), "-notpu"]) == 0
    assert _files(tmp_path / "cli" / "src") == _files(tmp_path / "src")


def test_modeled_add_without_card_raises(tree, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(NoDeviceError):
        add(str(tmp_path / "d.zpaq"), ["src"], method="4.0")
    assert not list(tmp_path.glob("d.zpaq*"))
    # store-coded methods never reach the encode kernel
    add(str(tmp_path / "s.zpaq"), ["src"], method="1", date=DATE)
    ref_add(str(tmp_path / "r.zpaq"), ["src"], method="1", date=DATE)
    assert (tmp_path / "s.zpaq").read_bytes() == \
        (tmp_path / "r.zpaq").read_bytes()


def test_cli_add_and_list(tree, tmp_path, capsys):
    assert cli_main(["a", "c", "src", "-m3", "-notpu"]) == 0
    assert cli_main(["l", "c"]) == 0
    assert "src/sub/c.txt" in capsys.readouterr().out
    if not torch.cuda.is_available():
        # a modeled add takes the card unless -notpu asks for the host:
        # without one it fails and writes nothing
        assert cli_main(["a", "d", "src", "-m3"]) == 2
        assert cli_main(["a", "d", "src", "-m3", "-tpu"]) == 2
        assert not list(tmp_path.glob("d.zpaq*"))


def test_mixed_models_group_into_lanes(tree, tmp_path):
    """Three transactions at three methods: two CM models decode as two
    lane groups, the store block on the host; all restore."""
    arc = str(tmp_path / "m.zpaq")
    ref_add(arc, ["src/a.txt"], method="3", date=DATE)
    ref_add(arc, ["src/sub"], method="4.0", date=DATE + 1)
    ref_add(arc, ["src/b.bin", "src/empty"], method="0", date=DATE + 2)
    data = (tmp_path / "m.zpaq").read_bytes()
    jd = read_archive(data)
    assert len(jd.block) == 3
    extract(data, jd, str(tmp_path / "out"), device="cpu")
    assert _files(tmp_path / "out" / "src") == _files(tmp_path / "src")


def test_launch_sizing_against_free_card_memory(monkeypatch):
    from zpaqfranz_tpu_torch.codec.methods import make_model
    from zpaqfranz_tpu_torch.parallel import engine

    model = make_model("4")[0]
    per_lane = cmd.lane_bytes(model) + 1000 + 3000
    free = {"bytes": 10 * per_lane}
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda dev=None: (free["bytes"], 1 << 40))
    card = torch.device("cuda", 0)
    assert engine.lanes_per_launch(model, 4000, card) == 8
    free["bytes"] = per_lane
    with pytest.raises(MemoryError):
        engine.lanes_per_launch(model, 4000, card)
    assert engine.lanes_per_launch(model, 4000,
                                   torch.device("cpu")) == sys.maxsize


@pytest.mark.parametrize("lanes", [1, 2])
def test_encode_launches_fill_mid_stream(tmp_path, monkeypatch, lanes):
    """Launches of ``lanes`` lanes go out as jobs arrive: coded jobs, a
    store-chosen job and a journaled one between them come out in job order,
    each the host engine's block, and the journal records every new block."""
    from zpaqfranz_tpu_torch.codec.methods import make_model
    from zpaqfranz_tpu_torch.jidac import add as port_add
    from zpaqfranz_tpu_torch.parallel import engine

    method = "x0,1,4,0,3,16ci1"        # LZ77 + CM: adaptive store can fire
    model, pre = make_model(method)
    rng = np.random.default_rng(11)
    raws = [b"hello world " * 6, rng.integers(0, 256, 150, np.uint8).tobytes(),
            b"fox " * 20, b"abcabd " * 10, b"zpaq lane " * 7]
    jobs = [port_add._Job(first_frag=1 + 10 * i,
                          frags=[(hashlib.sha1(r).digest(), len(r))],
                          data=bytearray(r)) for i, r in enumerate(raws)]
    host = list(port_add.code_jobs(model, pre, iter(jobs), DATE, None,
                                   1 << 20, 1))
    assert port_add.prepare_payload(pre, raws[1])[1]     # store-chosen
    path = tmp_path / "a.zpaq.resume"
    journal = port_add.ResumeJournal.load_or_create(path, DATE, method)
    journal.cache[journal.identity(jobs[2])] = host[2]   # from a prior run

    batches = []
    encode = engine.encode_streams
    monkeypatch.setattr(engine, "lanes_per_launch", lambda *a: lanes)
    monkeypatch.setattr(engine, "encode_streams", lambda m, p, d: (
        batches.append(len(p)), encode(m, p, d))[1])
    got = list(port_add.code_jobs(model, pre, iter(jobs), DATE,
                                  torch.device("cpu"), 1 << 20, 1,
                                  journal=journal))
    assert got == host
    assert batches == ([1, 1, 1] if lanes == 1 else [2, 1])
    journal._f.close()
    again = port_add.ResumeJournal.load_or_create(path, DATE, method)
    assert again.cache == {again.identity(jobs[i]): host[i]
                           for i in (0, 1, 3, 4)}
    again.done()
