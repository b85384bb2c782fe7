"""BWT d blocks (``-method 3.0``, ``x0.7ci1``) held to their own header: a
BWT job closes before its raw bytes would pass ``2^block_bits - 4096``, so
the block's stored PCOMP (``ph = pm = block_bits``) inverts it in any ZPAQ
decoder. Each d block is decoded by the benchmark's independent decoder
(``benchmark/reference/zpaqd.c``, which runs the stored PCOMP in its own
ZPAQL interpreter) to the tree's bytes, from the host engine, from the card
path's launch code on the CPU, and from a streaming add. The JAX package
keeps its own sizing, a deliberate difference. ``-method 4.0`` and ``-m1``
archives keep the bytes they had before the repair."""

import hashlib
import os
import pathlib

import numpy as np
import pytest

from zpaqfranz_tpu.jidac.add import add as ref_add

from benchmark.reference import archive as barc, bwt as ref_bwt
from benchmark.reference.codec import Decoder
from zpaqfranz_tpu_torch import cli, native
from zpaqfranz_tpu_torch.codec.methods import (MethodError, bwt_pcomp_source,
                                               make_model)
from zpaqfranz_tpu_torch.jidac import add as port_add
from zpaqfranz_tpu_torch.ops import cm_encode as cme
from zpaqfranz_tpu_torch.parallel import engine
from zpaqfranz_tpu_torch.parallel.engine import parse_block_payload
from zpaqfranz_tpu_torch.zpaql.compiler import compile_config
from zpaqfranz_tpu_torch.zpaql.vm import VM

DATE = 20260102030405
LIMIT = (1 << 20) - port_add.BWT_SLACK     # 1 MiB blocks: x0.* methods
BWT_METHODS = ["3.0", "x0.7ci1"]           # BWT; E8E9 then BWT


@pytest.fixture(scope="module")
def decoder(tmp_path_factory):
    return Decoder(tmp_path_factory.mktemp("zpaqd"))


def _words(rng, n):
    vocab = [bytes(rng.integers(97, 123, int(k), dtype=np.uint8))
             for k in rng.integers(2, 9, 2000)]
    return b" ".join(vocab[i] for i in rng.integers(0, len(vocab), n))


def _tree(root: pathlib.Path, seed: int = 17) -> pathlib.Path:
    """~2.3 MB of seeded text and x86-like code: a job of the old sizing
    closes at 2^20 bytes or more, past a 1 MiB BWT block's header."""
    rng = np.random.default_rng(seed)
    src = root / "src"
    (src / "sub").mkdir(parents=True)
    (src / "a.txt").write_bytes(_words(rng, 200_000)[:1_200_000])
    code = bytearray(rng.integers(0, 256, 700_000, dtype=np.uint8).tobytes())
    for at in range(0, len(code) - 5, 97):      # E8/E9 calls for E8E9
        code[at:at + 5] = bytes([0xE8, code[at + 1], code[at + 2], 0, 0])
    (src / "sub" / "b.bin").write_bytes(bytes(code))
    (src / "sub" / "c.txt").write_bytes(_words(rng, 70_000)[:400_000])
    for k, p in enumerate(sorted(q for q in src.rglob("*") if q.is_file())):
        os.chmod(p, 0o644)
        os.utime(p, (1_700_000_000 + k, 1_700_000_000 + k))
    return src


@pytest.fixture()
def tree(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    return _tree(tmp_path)


def _names(src: pathlib.Path):
    return sorted(str(p.relative_to(src)) for p in src.rglob("*")
                  if p.is_file())


def _check(path: pathlib.Path, src: pathlib.Path, decoder, method):
    """The reference's reading of the archive: the index against the tree,
    every d block's header the method's, its raw bytes within the BWT
    limit, and its bytes as the reference decoder gets them."""
    buf = path.read_bytes()
    arc = barc.read_archive(buf)
    tc = barc.check_tree(arc, src, _names(src), "src/")
    assert tc.files_wrong == tc.fragments_wrong == 0
    header = make_model(method)[0].header_bytes()
    assert barc.check_headers(buf, arc, [header]) == 0
    usize = [sum(arc.fragments[j].usize
                 for j in range(b.first, b.first + b.frags))
             for b in arc.blocks]
    assert max(usize) <= LIMIT and len(usize) >= 3
    assert barc.check_blocks(buf, arc, src, tc.where, range(len(arc.blocks)),
                             decoder, 4) == 0
    return buf, arc


def _native_lanes(model, data, in_off, in_len, out_cap):
    """``cm_encode_plain``'s contract, each lane coded by the native
    engine: the plain coder takes ~5 ms a byte here, and a 1 MiB lane would
    take hours. The plain coder equals the native engine lane for lane
    (tests/test_torch_cm_encode.py)."""
    from zpaqfranz_tpu_torch.ops.cm_model import plain_result
    prefix = len(engine.selector(model))
    raw = data.numpy().tobytes()
    outs = []
    for off, n in zip(in_off.tolist(), in_len.tolist()):
        block = native.compress_block(model, raw[off + prefix:off + n],
                                      b"t", b"c")
        outs.append(bytearray(parse_block_payload(block, 0)[2][:-6]))
    return plain_result(outs, out_cap, data.device)


@pytest.mark.parametrize("method", BWT_METHODS)
def test_bwt_blocks_decode_by_their_own_header(tree, decoder, method,
                                               monkeypatch):
    """The host engine (-notpu) and the card path's launch code on the CPU
    (``device="cpu"``) write the same archive; every d block holds at most
    2^20 - 4096 raw bytes and decodes through its stored PCOMP."""
    port_add.add("h.zpaq", ["src"], method=method, date=DATE,
                 use_device=False)
    monkeypatch.setattr(cme, "cm_encode_plain", _native_lanes)
    port_add.add("d.zpaq", ["src"], method=method, date=DATE,
                 use_device=True, device="cpu")
    host = pathlib.Path("h.zpaq").read_bytes()
    assert pathlib.Path("d.zpaq").read_bytes() == host
    buf, arc = _check(pathlib.Path("h.zpaq"), tree, decoder, method)
    # the jobs close before the fragment that would pass the limit
    assert sum(f.usize for f in arc.fragments.values()) > 2 * LIMIT


@pytest.mark.parametrize("method", BWT_METHODS)
def test_x_inverts_bwt_blocks_with_the_registered_inverse(tree, method):
    """The header is libzpaq's, so the PCOMP each block stores is the
    program the native engine knows, and it inverts the block with its C++
    inverse, not the ZPAQL VM: that inverse takes no notice of ``ph`` and
    ``pm``, where the VM would need 2^20 of each. ``x`` restores the
    tree."""
    assert cli.main(["a", "a.zpaq", "src", "-method", method,
                     "-notpu"]) == 0
    want = compile_config("comp 0 0 0 0 0\nhcomp\n  halt\npcomp ;\n"
                          + bwt_pcomp_source(e8e9=method != "3.0")
                          + "\nend\n")[0].pcomp
    model, pre = make_model(method)
    assert model.pcomp == want and model.ph == model.pm == 20
    raw = (tree / "a.txt").read_bytes()[:LIMIT]
    payload = port_add.prepare_payload(pre, raw)[0]
    assert native.postprocess(1, 1, b"\x01" + model.pcomp_bytes() + payload,
                              out_hint=len(raw)) == raw
    assert cli.main(["x", "a.zpaq", "-to", "out", "-notpu"]) == 0
    for name in _names(tree):
        assert (pathlib.Path("out/src") / name).read_bytes() == \
            (tree / name).read_bytes()


def test_reference_sizing_writes_a_block_past_its_header(tree, decoder):
    """The deliberate difference: the JAX package closes a job once it
    reaches 2^20 bytes, so its first block holds more than its BWT header
    allows, and an independent decoder gets other bytes."""
    ref_add("r.zpaq", ["src"], method="3.0", date=DATE)
    buf = pathlib.Path("r.zpaq").read_bytes()
    arc = barc.read_archive(buf)
    tc = barc.check_tree(arc, tree, _names(tree), "src/")
    first = arc.blocks[0]
    assert sum(arc.fragments[j].usize for j in
               range(first.first, first.first + first.frags)) > LIMIT
    assert barc.check_blocks(buf, arc, tree, tc.where, [0], decoder, 1) == 1


def test_streaming_bwt_blocks_hold_a_limit_each(tmp_path, monkeypatch,
                                                decoder):
    """``s0.3ci1``: one block per chunk of at most 2^20 - 4096 bytes."""
    monkeypatch.chdir(tmp_path)
    rng = np.random.default_rng(3)
    data = _words(rng, 260_000)[:LIMIT + 5000]
    pathlib.Path("f.txt").write_bytes(data)
    port_add.add("s.zpaq", ["f.txt"], method="s0.3ci1", date=DATE,
                 use_device=False)
    buf = pathlib.Path("s.zpaq").read_bytes()
    offsets = [i for i in range(len(buf)) if buf.startswith(barc.TAG, i)]
    got = [decoder.block(buf, off) for off in offsets]
    assert [len(g) for g in got] == [LIMIT, 5000]
    assert b"".join(got) == data


@pytest.mark.parametrize("method,fragment,fits", [
    ("3.0", 16, True), ("3.0", 17, False), ("x0.7ci1", 17, False),
    ("x1.3ci1", 17, True), ("4.0", 18, True)])
def test_fragment_longer_than_a_bwt_block_is_refused(tmp_path, monkeypatch,
                                                     method, fragment, fits):
    """A BWT method whose largest fragment (8 x 2^fragment + 4 KiB) passes
    the block's limit is refused before the archive is touched; the CLI
    exits non-zero and writes nothing."""
    monkeypatch.chdir(tmp_path)
    pathlib.Path("f.txt").write_bytes(b"zpaq bwt " * 100)
    pre = make_model(method)[1]
    if fits:
        assert port_add.max_job_bytes(pre, fragment) >= \
            port_add.max_fragment_bytes(fragment)
        return
    with pytest.raises(MethodError):
        port_add.max_job_bytes(pre, fragment)
    with pytest.raises(MethodError):
        port_add.add("a.zpaq", ["f.txt"], method=method,
                     fragment_bits=fragment, use_device=False)
    assert cli.main(["a", "c.zpaq", "f.txt", "-method", method, "-fragment",
                     str(fragment - 10), "-notpu"]) != 0
    assert not pathlib.Path("a.zpaq").exists()
    assert not pathlib.Path("c.zpaq").exists()


def _bwt_cases():
    rng = np.random.default_rng(29)
    return {"empty": b"", "one": b"q", "zeros": bytes(3000),
            "runs": b"a" * 700 + b"b" * 300 + b"ab" * 400,
            "random": rng.integers(0, 256, 2500, dtype=np.uint8).tobytes(),
            "ternary": rng.integers(0, 3, 3000, dtype=np.uint8).tobytes(),
            "text": _words(rng, 500)[:3000]}


@pytest.mark.parametrize("case", sorted(_bwt_cases()))
def test_plain_bwt_is_the_native_stream_and_the_pcomp_inverts_it(case):
    """``benchmark/reference/bwt.py`` against ``native.bwt_encode``, and
    its inverse against the stored PCOMP run in the port's ZPAQL VM."""
    data = _bwt_cases()[case]
    stream = ref_bwt.encode(data)
    assert stream == native.bwt_encode(data)
    assert len(stream) == len(data) + 5
    assert ref_bwt.decode(stream) == data
    vm = VM.for_pcomp(make_model("3.0")[0])
    for c in stream:
        vm.run(c)
    vm.run(0xFFFFFFFF)
    assert bytes(vm.out) == data


def _frags(sizes):
    return [(hashlib.sha1(b"%d" % k).digest(), 0, n)
            for k, n in enumerate(sizes)]


@pytest.mark.parametrize("transform", [0, 1, 3])
def test_planner_closes_bwt_jobs_before_the_limit(transform):
    """BWT jobs close before the fragment that would pass the limit; jobs
    of other transforms once they reach 2^block_bits (their old rule)."""
    pre = make_model("3.0")[1]
    pre = type(pre)(transform=transform, block_bits=20)
    sizes = [300_000, 400_000, 340_000, 9_000, 500_000, 600_000, 50_000]
    planner = port_add.FragmentPlanner({}, 1, pre, keep_bytes=False)
    jobs = planner.add_file("f", _frags(sizes), None)
    jobs.append(planner.finish())
    got = [[n for _, n in j.frags] for j in jobs]
    if transform == 3:
        assert got == [[300_000, 400_000, 340_000], [9_000, 500_000],
                       [600_000, 50_000]]
        assert max(map(sum, got)) <= LIMIT
    else:
        assert got == [[300_000, 400_000, 340_000, 9_000],
                       [500_000, 600_000], [50_000]]
    assert [j.first_frag for j in jobs] == [1, 1 + len(got[0]),
                                           1 + len(got[0]) + len(got[1])]
    assert port_add.max_job_bytes(pre, 16) == (
        LIMIT if transform == 3 else (1 << 20) - 1 + (8 << 16) + 4096)


# SHA-1 of each archive of ``_tree`` at the commit before the repair
UNCHANGED = {
    "4.0": "d407dfade5a6d47e7a26f489164b2cde9093e151",
    "1": "9cd11991d1d6067c899b8c787575ee6fd8ec6725",
}


@pytest.mark.parametrize("method", sorted(UNCHANGED))
def test_m4_and_m1_archives_keep_their_bytes(tree, method):
    port_add.add("a.zpaq", ["src"], method=method, date=DATE,
                 use_device=False)
    got = hashlib.sha1(pathlib.Path("a.zpaq").read_bytes()).hexdigest()
    assert got == UNCHANGED[method]
