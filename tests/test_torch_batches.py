"""Launches bounded in bytes on the port's hash paths, on the CPU through
the plain versions: ``t`` hashes its fragments one batch of whole blocks
at a time (``extract.VERIFY_BATCH_BYTES``), with the counts and the first
failing fragment of one launch, and ``sum`` sends a file larger than a
launch takes (``sha1.MAX_DATA``) to the native hasher, with the same
digest."""

import pytest

from zpaqfranz_tpu.cli import main as ref_main

from zpaqfranz_tpu_torch import cli
from zpaqfranz_tpu_torch.jidac import extract as ex
from zpaqfranz_tpu_torch.jidac.add import add
from zpaqfranz_tpu_torch.jidac.index import read_archive
from zpaqfranz_tpu_torch.ops import sha1

DATE = 20260102030405


@pytest.fixture()
def archive(tmp_path, monkeypatch):
    """An archive of four d blocks, one per transaction (-m3 and store
    blocks in turn), the second of two fragments."""
    monkeypatch.chdir(tmp_path)
    arc = tmp_path / "m.zpaq"
    for k in range(4):
        (tmp_path / f"s{k}").mkdir()
        (tmp_path / f"s{k}" / "f").write_bytes(b"block %d " % k * (300 + k))
        if k == 1:
            (tmp_path / f"s{k}" / "g").write_bytes(b"second file " * 80)
        add(str(arc), [f"s{k}"], method="1" if k % 2 else "3",
            date=DATE + k, use_device=False)
    data = arc.read_bytes()
    return data, read_archive(data)


def _spy_launches(monkeypatch):
    """Count the hash calls ``t`` makes and the bytes each hashes over."""
    calls = []
    real = sha1.sha1_lanes

    def spy(data, off, length, **kw):
        calls.append(int(data.numel()))
        return real(data, off, length, **kw)

    monkeypatch.setattr(sha1, "sha1_lanes", spy)
    return calls


@pytest.mark.parametrize("budget", [1, 6000, 1 << 30])
def test_verify_batches_give_one_launch_counts(archive, monkeypatch, budget):
    data, jd = archive
    assert len(jd.block) == 4
    want = ex.verify_archive(data, jd, use_device=False)
    calls = _spy_launches(monkeypatch)
    monkeypatch.setattr(ex, "VERIFY_BATCH_BYTES", budget)
    assert ex.verify_archive(data, jd, device="cpu") == want
    sizes = [sum(jd.ht[j].usize for j in range(b.start, b.start + b.frags))
             for b in jd.block]
    assert sum(calls) == sum(sizes)
    if budget == 1:
        assert calls == sizes
    elif budget == 1 << 30:
        assert len(calls) == 1
    else:
        assert len(calls) == 2 and max(calls) <= budget


@pytest.mark.parametrize("budget", [1, 1 << 30])
def test_verify_batches_find_the_first_bad_fragment(archive, monkeypatch,
                                                    budget):
    data, jd = archive
    monkeypatch.setattr(ex, "VERIFY_BATCH_BYTES", budget)
    first, later = jd.block[1].start + 1, jd.block[3].start
    for j in (later, first):
        jd.ht[j].sha1 = bytes(20)[:19] + b"\x01"
    with pytest.raises(ex.ExtractError,
                       match=f"^fragment {first}: checksum failed$"):
        ex.verify_archive(data, jd, device="cpu")


def test_sum_sends_a_file_past_max_data_to_the_native_hasher(
        tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    (tmp_path / "d").mkdir()
    for n in (10, 400, 99, 5000, 100, 0):
        (tmp_path / "d" / f"f{n:05d}").write_bytes(bytes(range(7)) * n)
    paths = sorted(p.relative_to(tmp_path) for p in (tmp_path / "d").glob("*"))
    for algo in ("sha1", "sha256"):
        assert ref_main(["sum", "d", f"-{algo}"]) == 0
        want = capsys.readouterr().out.splitlines()
        monkeypatch.setattr(sha1, "MAX_DATA", 700)
        native_sizes = []
        real = cli._hash_one

        def spy(a, data):
            native_sizes.append(len(data))
            return real(a, data)

        monkeypatch.setattr(cli, "_hash_one", spy)
        assert cli.sum_lines(paths, algo, device="cpu") == want
        assert sorted(native_sizes) == [2800, 35000]
        monkeypatch.undo()
        monkeypatch.chdir(tmp_path)
