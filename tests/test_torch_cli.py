"""The port's ``sum`` command against the reference's: the same
``DIGEST  path`` lines for the host hashers (``-notpu``) and for SHA-1 and
SHA-256 as lanes of the hash kernels' plain versions (``device="cpu"``)."""

import numpy as np
import pytest
import torch

from zpaqfranz_tpu.cli import main as ref_main

from zpaqfranz_tpu_torch import cli
from zpaqfranz_tpu_torch.ops import sha1, sha256


@pytest.fixture()
def tree(tmp_path, monkeypatch):
    """Files at the hash padding's edge lengths, an empty one and a nested
    directory."""
    rng = np.random.default_rng(2)
    src = tmp_path / "d"
    (src / "sub").mkdir(parents=True)
    for n in (0, 3, 55, 56, 64, 119, 120, 1000):
        (src / f"f{n}").write_bytes(rng.integers(0, 256, n, dtype=np.uint8)
                                    .tobytes())
    (src / "sub" / "text").write_bytes(b"the cat sat on the mat\n" * 50)
    monkeypatch.chdir(tmp_path)
    return src


def _lines(main, argv, capsys):
    assert main(argv) == 0
    return capsys.readouterr().out.splitlines()


@pytest.mark.parametrize("algo", ["sha1", "sha256", "md5", "crc32",
                                  "xxhash64", "blake3"])
def test_sum_host_prints_reference_lines(tree, capsys, algo):
    want = _lines(ref_main, ["sum", "d", f"-{algo}"], capsys)
    assert len(want) == 9
    assert _lines(cli.main, ["sum", "d", f"-{algo}", "-notpu"],
                  capsys) == want


@pytest.mark.parametrize("algo", ["sha1", "sha256"])
def test_sum_lanes_print_reference_lines(tree, capsys, algo):
    want = _lines(ref_main, ["sum", "d", f"-{algo}"], capsys)
    paths = sorted(p for p in tree.rglob("*") if p.is_file())
    before = (sha1.launches, sha256.launches)
    got = cli.sum_lines([p.relative_to(tree.parent) for p in paths], algo,
                        device="cpu")
    assert got == want
    assert (sha1.launches, sha256.launches) == before
    if not torch.cuda.is_available():
        # without -notpu, SHA-1 and SHA-256 take the card: none, exit 2
        assert cli.main(["sum", "d", f"-{algo}"]) == 2


def test_list_and_test_warn_on_a_truncated_transaction(tmp_path, monkeypatch,
                                                       capsys):
    """``t`` says "all OK" only when the index scan skipped nothing, and
    ``l`` warns and exits 1 on a truncated trailing transaction, as ``t``
    does (the reference's cmd_test prints "all OK" before its warnings, and
    its cmd_list exits 0)."""
    monkeypatch.chdir(tmp_path)
    (tmp_path / "src").mkdir()
    (tmp_path / "src" / "a").write_bytes(b"hello " * 100)
    assert cli.main(["a", "arc", "src", "-notpu"]) == 0
    first = (tmp_path / "arc.zpaq").stat().st_size
    (tmp_path / "src" / "b").write_bytes(b"world " * 200)
    assert cli.main(["a", "arc", "src", "-notpu"]) == 0
    data = (tmp_path / "arc.zpaq").read_bytes()
    (tmp_path / "cut.zpaq").write_bytes(data[:(first + len(data)) // 2])
    capsys.readouterr()
    assert cli.main(["t", "arc", "-notpu"]) == 0
    out, err = capsys.readouterr()
    assert out.rstrip().endswith("all OK") and err == ""
    assert cli.main(["l", "arc"]) == 0
    out, err = capsys.readouterr()
    assert "2 files" in out and err == ""
    assert cli.main(["t", "cut", "-notpu"]) == 1
    out, err = capsys.readouterr()
    assert "all OK" not in out and "OK with 1 warning(s)" in out
    assert err == "warning: incomplete (truncated) trailing transaction " \
                  "ignored\n"
    assert cli.main(["l", "cut"]) == 1
    out, err = capsys.readouterr()
    assert "1 files" in out and "truncated" in err
