"""The port's multi-host add against the reference's single-process add:
the archive written by 1, 2 or 3 cooperating ranks (hash-sharded dedup,
replayed fragment-ID assignment, ordered gather to the writer), over TCP
or over ``torch.distributed`` (gloo), equals byte for byte the one
``add`` writes, in the reference and in the port. Every rank is a
subprocess with a timeout."""

import hashlib
import os
import pathlib
import socket
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from zpaqfranz_tpu.codec import crypto as ref_crypto
from zpaqfranz_tpu.jidac.add import add as ref_add

from zpaqfranz_tpu_torch.jidac.add import add
from zpaqfranz_tpu_torch.parallel import multihost as mh

_DATE = 20260102030405
ROOT = pathlib.Path(__file__).resolve().parent.parent


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _corpus(root: pathlib.Path) -> None:
    """tests/test_multihost.py's tree."""
    (root / "sub").mkdir(parents=True)
    (root / "a.txt").write_bytes(b"alpha beta gamma " * 4000)
    (root / "b.bin").write_bytes(bytes(range(256)) * 999)
    (root / "sub" / "dup.bin").write_bytes(bytes(range(256)) * 999)
    (root / "sub" / "c.txt").write_bytes(b"delta epsilon " * 7000)
    for k, p in enumerate(("a.txt", "b.bin", "sub/dup.bin", "sub/c.txt")):
        os.utime(root / p, (1_700_000_000 + k, 1_700_000_000 + k))


def _run_world(world: int, cwd: pathlib.Path, archive: str, date: int,
               *flags: str, method: str = "1") -> list:
    """Run ``world`` ranks of the port's worker; returns their stdouts."""
    port = _free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "zpaqfranz_tpu_torch.parallel.multihost",
         "--rank", str(r), "--world", str(world),
         "--coordinator", f"127.0.0.1:{port}", "--method", method,
         "--date", str(date), *flags, archive, "corpus"],
        cwd=cwd, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(world)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=240)
            assert p.returncode == 0, err
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def _launches(outs) -> int:
    return sum(int(m.group(2)) for out in outs
               for m in mh.LAUNCH_LINE.finditer(out))


def _serial(tmp_path, date=_DATE, **kw) -> bytes:
    """The reference's and the port's single-process adds, which agree."""
    ref_add("serial.zpaq", ["corpus"], date=date, **kw)
    add("port.zpaq", ["corpus"], date=date, use_device=False, **kw)
    return (tmp_path / "serial.zpaq").read_bytes()


@pytest.fixture()
def corpus(tmp_path, monkeypatch):
    _corpus(tmp_path / "corpus")
    monkeypatch.chdir(tmp_path)
    return tmp_path


def test_dist_add_world1_matches_serial(corpus):
    want = _serial(corpus, method="1")
    assert (corpus / "port.zpaq").read_bytes() == want
    comm = mh.TcpComm(0, 1, "127.0.0.1:0")
    assert mh.dist_add(comm, "dist.zpaq", ["corpus"], method="1",
                       date=_DATE)[0] == 4
    assert (corpus / "dist.zpaq").read_bytes() == want


@pytest.mark.parametrize("world", [2, 3])
def test_dist_add_matches_serial(corpus, world):
    want = _serial(corpus, method="1")
    outs = _run_world(world, corpus, "dist.zpaq", _DATE)
    assert (corpus / "dist.zpaq").read_bytes() == want
    assert outs[0].startswith("4 +files, ")
    assert _launches(outs) == 0              # store-coded: no CM lane


def test_dist_add_over_torch_distributed(corpus):
    want = _serial(corpus, method="1")
    _run_world(2, corpus, "dist.zpaq", _DATE, "--torch-dist")
    assert (corpus / "dist.zpaq").read_bytes() == want


def test_dist_add_incremental_matches_serial(corpus):
    """A second transaction (modified tree, dedup against the first) is
    also the same for every world size."""
    _serial(corpus, method="1")
    _run_world(2, corpus, "dist.zpaq", _DATE)
    p = corpus / "corpus" / "a.txt"
    p.write_bytes(p.read_bytes() + b"incremental tail")
    os.utime(p, (1_700_000_100, 1_700_000_100))
    (corpus / "corpus" / "new.txt").write_bytes(b"brand new " * 500)
    os.utime(corpus / "corpus" / "new.txt", (1_700_000_101, 1_700_000_101))
    want = _serial(corpus, date=_DATE + 100, method="1")
    _run_world(2, corpus, "dist.zpaq", _DATE + 100, "--torch-dist")
    assert (corpus / "dist.zpaq").read_bytes() == want
    assert (corpus / "port.zpaq").read_bytes() == want


def test_dist_add_encrypted_matches_serial(corpus):
    """Salts are random, so ciphertexts differ; the decrypted transactions
    match."""
    _serial(corpus, method="1", key="pw")
    comm = mh.TcpComm(0, 1, "127.0.0.1:0")
    mh.dist_add(comm, "dist.zpaq", ["corpus"], method="1", date=_DATE,
                key="pw")
    _run_world(3, corpus, "dist3.zpaq", _DATE, "--key", "pw")
    want = ref_crypto.decrypt_archive(
        (corpus / "serial.zpaq").read_bytes(), "pw")
    for name in ("dist.zpaq", "dist3.zpaq", "port.zpaq"):
        assert ref_crypto.decrypt_archive(
            (corpus / name).read_bytes(), "pw") == want, name


def test_tcp_comm_collectives():
    """broadcast/allgather/alltoall/gather over real sockets, in one
    process."""
    port = _free_port()
    world = 3
    results = {}

    def worker(rank):
        comm = mh.TcpComm(rank, world, f"127.0.0.1:{port}")
        try:
            assert comm.broadcast("hello" if rank == 0 else None) == "hello"
            assert comm.allgather(rank * 10) == [0, 10, 20]
            a2a = comm.alltoall([f"{rank}->{d}" for d in range(world)])
            assert a2a == [f"{s}->{rank}" for s in range(world)]
            g = comm.gather(rank + 1)
            assert g == ([1, 2, 3] if rank == 0 else None)
            comm.barrier()
            results[rank] = True
        finally:
            comm.close()

    ts = [threading.Thread(target=worker, args=(r,)) for r in range(world)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in ts)
    assert results == {0: True, 1: True, 2: True}


def test_scaling_report(corpus):
    """The harness runs, archives byte-match across world sizes, and it
    reports MB/s, efficiency and the ranks' CM launches."""
    rep = mh.scaling_report(str(corpus / "corpus"), worlds=(1, 2),
                            timeout=240)
    assert set(rep) == {1, 2}
    want = hashlib.sha1(_serial(corpus, method="1")).hexdigest()
    assert rep[1]["archive_sha1"] == rep[2]["archive_sha1"] == want
    assert rep[1]["MBps"] > 0 and rep[2]["MBps"] > 0
    assert rep[2]["cm_encode_launches"] == 0
    assert "efficiency_vs_1" in rep[2]


def test_dist_add_host_engine_codes_on_every_rank(corpus):
    """``3.0`` (-m3's model and BWT, 1 MiB blocks) over 2.5 MiB: three
    d blocks, so both ranks code; --notpu is the host engine. The ranks
    write the port's single-process bytes; the reference's differ on
    purpose, its BWT jobs passing 2^20 - 4096 bytes (ROADMAP's deliberate
    differences)."""
    rng = np.random.default_rng(5)
    words = [bytes(rng.integers(97, 123, int(n), dtype=np.uint8))
             for n in rng.integers(2, 9, 3000)]
    for k in range(5):
        body = b" ".join(words[i] for i in rng.integers(0, 3000, 90000))
        (corpus / "corpus" / f"t{k}.txt").write_bytes(body[:512 * 1024])
    ref = _serial(corpus, method="3.0")
    want = (corpus / "port.zpaq").read_bytes()
    assert want != ref
    outs = _run_world(2, corpus, "dist.zpaq", _DATE, "--notpu",
                      method="3.0")
    data = (corpus / "dist.zpaq").read_bytes()
    assert data == want
    from zpaqfranz_tpu_torch.jidac.index import read_archive
    assert len(read_archive(data).block) >= 3
    assert _launches(outs) == 0


def test_dist_add_device_branch_plain_versions(tmp_path, monkeypatch):
    """``--device cpu``: the device branch of ``jidac.add.code_jobs`` with
    the CM encoder's plain version, on a ~4 KB tree; no kernel launch."""
    monkeypatch.chdir(tmp_path)
    src = tmp_path / "corpus"
    src.mkdir()
    (src / "a.txt").write_bytes(b"the cat sat on the mat. " * 90)
    (src / "b.txt").write_bytes(b"abcdefgh" * 250)
    ref_add("serial.zpaq", ["corpus"], method="x4.0ci1", date=_DATE)
    outs = _run_world(1, tmp_path, "dist.zpaq", _DATE, "--device", "cpu",
                      method="x4.0ci1")
    assert (tmp_path / "dist.zpaq").read_bytes() == \
        (tmp_path / "serial.zpaq").read_bytes()
    assert outs[0].splitlines()[-1] == "rank 0: cm_encode launches 0"


def test_worker_device_flag(monkeypatch, capsys):
    """The worker's device switches: the reference's bare --device (its
    only form), --device NAME, --notpu, and the card by default."""
    seen = []

    def spy(comm, archive, files, **kw):
        seen.append((archive, files, kw["use_device"], kw["device"]))
        return (0, 0, 0)

    monkeypatch.setattr(mh, "dist_add", spy)
    base = ["--rank", "0", "--world", "1", "--coordinator", "127.0.0.1:0"]
    for flags, want in ((["--device"], "cuda"), (["--device", "cpu"], "cpu"),
                        (["--device", "cuda:0"], "cuda:0"), ([], None)):
        assert mh._main(base + flags + ["a.zpaq", "f"]) == 0
        assert seen.pop() == ("a.zpaq", ["f"], True, want)
    assert mh._main(base + ["--notpu", "a.zpaq", "f", "g"]) == 0
    assert seen.pop() == ("a.zpaq", ["f", "g"], False, None)
    out = capsys.readouterr().out.splitlines()
    assert out[:2] == ["0 +files, 0 +frags, 0 bytes",
                       f"rank 0: cm_encode launches {mh.cme.launches}"]


def test_worker_without_card_exits_non_zero(corpus):
    """Without a card the worker fails before writing; it does not fall
    back to the host engine."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    res = subprocess.run(
        [sys.executable, "-m", "zpaqfranz_tpu_torch.parallel.multihost",
         "--rank", "0", "--world", "1", "--coordinator", "127.0.0.1:0",
         "--method", "3", "--device", "dist.zpaq", "corpus"],
        cwd=corpus, env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode != 0 and "NoDeviceError" in res.stderr
    assert not (corpus / "dist.zpaq").exists()
