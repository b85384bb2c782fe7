"""The port's CUDA kernels against their plain PyTorch versions, and the
slices (add, extract, verify and the device bench) on the card. Every test
here needs a CUDA card and skips without one. This file imports no JAX, so
it also runs where the reference's JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_card.py
"""

import hashlib
import pathlib

import numpy as np
import pytest
import torch

from zpaqfranz_tpu import native as ref_native
from zpaqfranz_tpu.codec.methods import make_model as ref_make_model
from zpaqfranz_tpu.jidac.add import add as ref_add
from zpaqfranz_tpu.jidac.extract import verify_archive as ref_verify
from zpaqfranz_tpu.jidac.index import read_archive as ref_read
from zpaqfranz_tpu.parallel import engine as ref_engine
from zpaqfranz_tpu.zpaql.compiler import compile_config as ref_compile

from zpaqfranz_tpu_torch import convert
from zpaqfranz_tpu_torch.codec.methods import ALL_COMPONENTS_CFG, make_model
from zpaqfranz_tpu_torch.experiments import mb_access as mb
from zpaqfranz_tpu_torch.experiments import mb_vmem_probe as mp
from zpaqfranz_tpu_torch.experiments import sanitize as sz
from zpaqfranz_tpu_torch.jidac.add import add
from zpaqfranz_tpu_torch.jidac.extract import extract, verify_archive
from zpaqfranz_tpu_torch.jidac.index import read_archive
from zpaqfranz_tpu_torch.models.predictor import Predictor
from zpaqfranz_tpu_torch.ops import cm_decode as cmd, cm_encode as cme
from zpaqfranz_tpu_torch.ops.cm_model import Placement
from zpaqfranz_tpu_torch.ops.predictor_batched import BatchedPredictor
from zpaqfranz_tpu_torch.ops import hash_batched as hb
from zpaqfranz_tpu_torch.ops import sha1, sha256
from zpaqfranz_tpu_torch.ops.coder_batched import (BatchedDecoder,
                                                   BatchedEncoder)
from zpaqfranz_tpu_torch.pre import bwt_device
from zpaqfranz_tpu_torch.parallel import device_bench
from zpaqfranz_tpu_torch.parallel.engine import parse_block_payload

pytestmark = pytest.mark.cuda
DATE = 20260102030405


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def _own_record(tmp_path, monkeypatch):
    """The engine gate's record in the test's own directory: no record
    unless the test writes one (unforced runs take the card)."""
    from zpaqfranz_tpu_torch import device_policy
    monkeypatch.setenv(device_policy.CAL_ENV, str(tmp_path / "cal.json"))


def test_sha1_kernel_matches_plain(card):
    rng = np.random.default_rng(7)
    chunks = [b"", b"abc", b"a" * 55, b"a" * 56, b"a" * 63, b"a" * 64,
              b"x" * 119, b"x" * 120] + [
        rng.integers(0, 256, int(k), dtype=np.uint8).tobytes()
        for k in rng.integers(0, 5000, 200)]
    data, off, ln = sha1.pack_messages(chunks, card)
    before = sha1.launches
    got = sha1.sha1_lanes(data, off, ln)
    torch.cuda.synchronize()
    assert sha1.launches == before + 1
    assert torch.equal(got.cpu().view(torch.int32),
                       sha1.sha1_plain(data, off, ln).cpu().view(torch.int32))
    assert sha1.to_digests(got) == [hashlib.sha1(c).digest() for c in chunks]


def test_sha256_kernel_matches_plain(card):
    rng = np.random.default_rng(8)
    chunks = [b"", b"abc", b"a" * 55, b"a" * 56, b"a" * 63, b"a" * 64,
              b"x" * 119, b"x" * 120] + [
        rng.integers(0, 256, int(k), dtype=np.uint8).tobytes()
        for k in rng.integers(0, 5000, 200)]
    data, off, ln = sha1.pack_messages(chunks, card)
    before = sha256.launches
    got = sha256.sha256_lanes(data, off, ln)
    torch.cuda.synchronize()
    assert sha256.launches == before + 1
    assert torch.equal(got.cpu().view(torch.int32),
                       sha256.sha256_plain(data, off, ln).cpu().view(
                           torch.int32))
    assert sha1.to_digests(got) == [hashlib.sha256(c).digest()
                                    for c in chunks]
    # lanes at odd offsets of one buffer
    got = sha256.sha256_lanes(data, off + 1, (ln - 1).clamp(min=0))
    assert sha1.to_digests(got) == [hashlib.sha256(c[1:]).digest()
                                    for c in chunks]


HASHES = [(sha1.sha1_lanes, hashlib.sha1), (sha256.sha256_lanes,
                                           hashlib.sha256)]


def _hash_spans(lanes, ref, data, spans):
    """The kernel's digests of ``data[o:o + n]`` for ``spans`` against
    hashlib's."""
    host = data.cpu().numpy().tobytes()
    dev = data.device
    off = torch.tensor([o for o, _ in spans], dtype=torch.int64, device=dev)
    ln = torch.tensor([n for _, n in spans], dtype=torch.int64, device=dev)
    got = sha1.to_digests(lanes(data, off, ln))
    assert got == [ref(host[o:o + n]).digest() for o, n in spans]


@pytest.mark.parametrize("lanes,ref", HASHES)
def test_hash_kernels_at_every_offset_and_padding_edge(card, lanes, ref):
    rng = np.random.default_rng(13)
    data = torch.from_numpy(rng.integers(0, 256, 1001, dtype=np.uint8)).to(
        card)
    _hash_spans(lanes, ref, data, [
        (o, n) for o in range(64)
        for n in (0, 1, 55, 56, 63, 64, 65, 119, 120, 128)])


@pytest.mark.parametrize("lanes,ref", HASHES)
@pytest.mark.parametrize("count", [1, 31, 32, 33, 4223, 4224, 4225,
                                   150_000])
def test_hash_kernels_at_lane_counts(card, lanes, ref, count):
    # one thread block (32 lanes), a block +- 1, one block per SM of the
    # H100 +- 1, and several waves of blocks
    rng = np.random.default_rng(count)
    data = torch.from_numpy(rng.integers(0, 256, 20_000, dtype=np.uint8)).to(
        card)
    lens = rng.integers(0, 300, count)
    offs = rng.integers(0, 20_000 - 300, count)
    _hash_spans(lanes, ref, data, list(zip(offs.tolist(), lens.tolist())))


@pytest.mark.parametrize("lanes,ref", HASHES)
def test_hash_kernels_with_one_lane_far_longer(card, lanes, ref):
    rng = np.random.default_rng(14)
    data = torch.from_numpy(rng.integers(0, 256, 3 << 20, dtype=np.uint8)).to(
        card)
    spans = [(int(o), int(n)) for o, n in zip(rng.integers(0, 1 << 20, 200),
                                              rng.integers(0, 5000, 200))]
    _hash_spans(lanes, ref, data, spans[:77] + [(3, (2 << 20) + 7)]
                + spans[77:])


@pytest.mark.parametrize("lanes,ref", HASHES)
def test_hash_kernels_read_to_the_last_byte_of_data(card, lanes, ref):
    # views of 4,099 bytes (not a multiple of 16) at offsets of one buffer
    rng = np.random.default_rng(15)
    buf = torch.from_numpy(rng.integers(0, 256, 5000, dtype=np.uint8)).to(
        card)
    for start in (0, 5, 16):
        data = buf[start:start + 4099]
        _hash_spans(lanes, ref, data, [(4099 - n, n) for n in
                                       (0, 1, 15, 16, 17, 64, 65, 4099)])


def test_hash_kernels_pinned_packing_and_profile(card):
    rng = np.random.default_rng(16)
    msgs = [rng.integers(0, 256, int(k), dtype=np.uint8).tobytes()
            for k in rng.integers(0, 70_000, 300)]
    data, off, ln = sha1.pack_messages(msgs, card)
    cpu = sha1.pack_messages(msgs, "cpu")
    for a, b in zip((data, off, ln), cpu):
        assert torch.equal(a.cpu(), b)
    prof = torch.zeros(len(sha1.PROFILE), dtype=torch.int64, device=card)
    got = sha256.sha256_lanes(data, off, ln, prof)
    assert sha1.to_digests(got) == [hashlib.sha256(m).digest() for m in msgs]
    p = dict(zip(sha1.PROFILE, prof.tolist()))
    assert p["blocks"] == (max(map(len, msgs)) + 9 + 63) // 64
    assert 0 < p["rounds"] and p["wait"] + p["rounds"] <= p["total"]
    assert 0 < p["words"]


@pytest.mark.parametrize("method", ["3", "4.0", "5.0", "cfg"])
def test_cm_kernel_matches_plain(card, method):
    if method == "cfg":
        ref, pre = ref_compile(ALL_COMPONENTS_CFG)[0], None
    else:
        ref, pre = ref_make_model(method)
    model = convert.model_from_reference_header(ref.header_bytes())
    blob = ref.pcomp_bytes()
    prefix = (b"\x01" + blob) if blob else b"\x00"
    rng = np.random.default_rng(5)
    raws = [b"the cat sat on the mat " * (k // 23 + 1)
            + rng.integers(0, 256, k // 4, dtype=np.uint8).tobytes()
            for k in (0, 60, 130, 200)]
    pays = [r if pre is None else ref_engine.prepare_payload(pre, r)[0]
            for r in raws]
    streams = [parse_block_payload(
        ref_native.compress_block(ref, p, b"t", b"c"), 0)[2] for p in pays]
    packed = cmd.pack_streams(streams, [len(prefix) + len(p) + 64
                                        for p in pays], card)
    before = cmd.launches
    got = cmd.lanes_to_bytes(*cmd.cm_decode(model, *packed))
    torch.cuda.synchronize()
    assert cmd.launches == before + 1
    assert got == [prefix + p for p in pays]
    assert got == cmd.lanes_to_bytes(*cmd.cm_decode_plain(model, *packed))


# HCOMP with a data-dependent loop of 64 * byte + 1 iterations: up to about
# 115,000 ZPAQL instructions for one byte, far more than the standard
# programs run, and well under the kernel's limit of 2^24 per byte.
LOOP_CFG = """
comp 1 0 0 0 2
  0 cm 16 4
  1 cm 12 4
hcomp
  c=a a<<= 6 a++ b=a a=0 r=a 0
  do
    a=r 0 a+=c r=a 0
    a=b a-- b=a
    a> 0
  while
  a=r 0 d= 0 *d=a
  a=c a<<= 8 d= 1 *d=a
  halt
post 0 end
"""

# the same components, with an HCOMP program that never halts
RUNAWAY_CFG = LOOP_CFG.split("hcomp")[0] + """hcomp
  do a++ forever
  halt
post 0 end
"""


def _coded(ref, pays):
    return [parse_block_payload(ref_native.compress_block(ref, p, b"t", b"c"),
                                0)[2] for p in pays]


def test_cm_kernel_runs_long_hcomp_loops(card):
    ref = ref_compile(LOOP_CFG)[0]
    model = convert.model_from_reference_header(ref.header_bytes())
    rng = np.random.default_rng(11)
    pays = [b"a", b"loop", b"\xff\x00\x80zpaq!",
            rng.integers(0, 256, 1000, dtype=np.uint8).tobytes()]
    packed = cmd.pack_streams(_coded(ref, pays), [len(p) + 64 for p in pays],
                              card)
    got = cmd.lanes_to_bytes(*cmd.cm_decode(model, *packed))
    assert got == [b"\x00" + p for p in pays]
    # the plain version (ZPAQL through the scalar VM) on the short lanes
    short = cmd.pack_streams(_coded(ref, pays[:3]),
                             [len(p) + 64 for p in pays[:3]], card)
    assert cmd.lanes_to_bytes(*cmd.cm_decode_plain(model, *short)) == got[:3]


@pytest.mark.parametrize("method", ["3", "4", "5"])
def test_cm_encode_kernel_matches_plain_and_native(card, method):
    """-m3, and -m4 / -m5 at their 16 MiB-block widths: the kernel's coded
    lanes equal the plain version's and the native engine's segments."""
    ref, _ = ref_make_model(method)
    model = convert.model_from_reference_header(ref.header_bytes())
    blob = ref.pcomp_bytes()
    prefix = (b"\x01" + blob) if blob else b"\x00"
    rng = np.random.default_rng(6)
    raws = [b"the cat sat on the mat " * (k // 23 + 1)
            + rng.integers(0, 256, k // 4, dtype=np.uint8).tobytes()
            for k in (0, 40, 90, 150)]
    packed = cme.pack_payloads([prefix + r for r in raws], card)
    before = cme.launches
    got = cmd.lanes_to_bytes(*cme.cm_encode(model, *packed))
    torch.cuda.synchronize()
    assert cme.launches == before + 1
    assert got == [c[:-6] for c in _coded(ref, raws)]
    assert got == cmd.lanes_to_bytes(*cme.cm_encode_plain(model, *packed))


def test_cm_kernel_fails_a_runaway_hcomp(card):
    # coded with a halting program: the first byte decodes alike, then the
    # runaway program runs into the step limit and the lane fails
    stream = _coded(ref_compile(LOOP_CFG)[0], [b"some bytes"])
    runaway = convert.model_from_reference_header(
        ref_compile(RUNAWAY_CFG)[0].header_bytes())
    with pytest.raises(cmd.CMDecodeError, match="HCOMP program faulted"):
        cmd.cm_decode(runaway, *cmd.pack_streams(stream, [64], card))


def test_cm_encode_kernel_runs_long_hcomp_loops(card):
    ref = ref_compile(LOOP_CFG)[0]
    model = convert.model_from_reference_header(ref.header_bytes())
    rng = np.random.default_rng(12)
    raws = [b"a", b"loop", b"\xff\x00\x80zpaq!",
            rng.integers(0, 256, 1000, dtype=np.uint8).tobytes()]
    packed = cme.pack_payloads([b"\x00" + r for r in raws], card)
    got = cmd.lanes_to_bytes(*cme.cm_encode(model, *packed))
    assert got == [c[:-6] for c in _coded(ref, raws)]
    short = cme.pack_payloads([b"\x00" + r for r in raws[:3]], card)
    assert cmd.lanes_to_bytes(*cme.cm_encode_plain(model, *short)) == got[:3]
    # the runaway program runs into the step limit at the first byte
    runaway = convert.model_from_reference_header(
        ref_compile(RUNAWAY_CFG)[0].header_bytes())
    with pytest.raises(cme.CMEncodeError, match="HCOMP program faulted"):
        cme.cm_encode(runaway, *cme.pack_payloads([b"\x00ab"], card))


def _round_trip(card, ref, model, raws, plain=True):
    """Encode and decode ``raws`` as lanes of one launch each: the coded
    lanes equal the native engine's segments (and the plain version's), the
    decoded lanes the payloads (and the plain decode's)."""
    blob = ref.pcomp_bytes()
    prefix = (b"\x01" + blob) if blob else b"\x00"
    packed = cme.pack_payloads([prefix + r for r in raws], card)
    got = cmd.lanes_to_bytes(*cme.cm_encode(model, *packed))
    coded = _coded(ref, raws)
    assert got == [c[:-6] for c in coded]
    streams = cmd.pack_streams(coded, [len(prefix) + len(r) + 64
                                       for r in raws], card)
    back = cmd.lanes_to_bytes(*cmd.cm_decode(model, *streams))
    assert back == [prefix + r for r in raws]
    if plain:
        assert got == cmd.lanes_to_bytes(*cme.cm_encode_plain(model,
                                                              *packed))
        assert back == cmd.lanes_to_bytes(*cmd.cm_decode_plain(model,
                                                               *streams))


@pytest.mark.parametrize("method", ["3", "4.0"])
@pytest.mark.parametrize("count", ["1", "lpb", "lpb+1", "3lpb-1"])
def test_cm_kernels_across_blocks(card, method, count):
    """1 lane, one full block, one lane into a second block, and one lane
    short of three blocks (lanes per block from the placement plan): every
    lane codes as the native engine and the plain version do."""
    ref, _ = ref_make_model(method)
    model = convert.model_from_reference_header(ref.header_bytes())
    lpb = Placement(model).lanes_per_block
    L = {"1": 1, "lpb": lpb, "lpb+1": lpb + 1, "3lpb-1": 3 * lpb - 1}[count]
    rng = np.random.default_rng(L)
    raws = [b"lane %d: " % k + b"the cat sat on the mat " * int(k % 3)
            + rng.integers(0, 256, int(k % 7), dtype=np.uint8).tobytes()
            for k in range(L)]
    before = (cme.launches, cmd.launches)
    _round_trip(card, ref, model, raws)
    assert (cme.launches, cmd.launches) == (before[0] + 1, before[1] + 1)


@pytest.mark.parametrize("method", ["4.0", "cfg"])
def test_cm_kernels_find_a_255_byte_match(card, method):
    """A lane that repeats 700 random bytes: MATCH's length search runs to
    its limit of 255 and stays there."""
    if method == "cfg":
        ref = ref_compile(ALL_COMPONENTS_CFG)[0]
    else:
        ref = ref_make_model(method)[0]
    model = convert.model_from_reference_header(ref.header_bytes())
    rnd = np.random.default_rng(9).integers(0, 256, 700,
                                            dtype=np.uint8).tobytes()
    _round_trip(card, ref, model, [rnd + rnd + rnd[:300], b"", b"ab" * 400],
                plain=False)


# an HCOMP program of most ZPAQL instruction kinds: swaps with registers,
# *B, *C and *D, ++ -- ! on each, every ALU operation with register, memory
# and immediate operands, R, HASH/HASHD, and short and long jumps
OPCODES_CFG = """comp 3 8 0 0 4
  0 cm 12 4
  1 cm 12 4
  2 cm 12 4
  3 cm 12 4
hcomp
  c++ *c=a b=c b-- b--
  a<<= 3 a^=*b a|= 5 a&~ 2 r=a 1
  d= 0 *d=a
  a=r 1 a>>= 1 a+=c a*= 7 a-=b
  b<>a a=b b=c
  d= 1 *d<>a a=*d a++ a-- a! a!
  *d++ *d-- *d! *d!
  a= 100 a/=*b a+= 3 a%= 7 a+=*c
  d= 2 *d=a
  a=*c a== 5 if a+= 1 else a-= 1 endif
  a> 3 ifnot a*= 3 endif
  a< 200 ifl a+= 9 elsel a^= 255 endif
  *b<>a *b++ *c-- a=*b d= 3 *d=a hashd
  b=c hash hashd a=0 a! a&=*c
  c<>a c=a a=c d=r 1 d= 3 *d=a
  halt
post 0 end
"""


def test_cm_kernels_run_every_kind_of_zpaql_instruction(card):
    ref = ref_compile(OPCODES_CFG)[0]
    model = convert.model_from_reference_header(ref.header_bytes())
    rng = np.random.default_rng(7)
    _round_trip(card, ref, model, [
        rng.integers(0, 256, 300, dtype=np.uint8).tobytes(),
        b"hello hello " * 20, b"\x00" * 50 + bytes(range(256))])


# the all-components model with CM, MATCH, MIX, MIX2 and SSE tables beyond a
# lane's shared budget: they stay in device memory
DEVICE_TABLES_CFG = ALL_COMPONENTS_CFG
for _small, _large in (("1 cm 9 4", "1 cm 16 4"),
                       ("4 match 8 8", "4 match 16 16"),
                       ("6 mix2 4 5 1", "6 mix2 14 5 1"),
                       ("7 mix 4 0 6", "7 mix 12 0 6"),
                       ("8 sse 5 7", "8 sse 12 7")):
    DEVICE_TABLES_CFG = DEVICE_TABLES_CFG.replace(_small, _large)


def test_cm_kernels_with_tables_in_device_memory(card):
    ref = ref_compile(DEVICE_TABLES_CFG)[0]
    model = convert.model_from_reference_header(ref.header_bytes())
    plan = Placement(model)
    assert not {1, 4, 6, 7, 8} & set(plan.shared)
    rng = np.random.default_rng(13)
    raws = [b"the cat sat on the mat " * 3 + rng.integers(
        0, 256, k, dtype=np.uint8).tobytes() for k in (0, 20, 50)]
    _round_trip(card, ref, model, raws)


@pytest.mark.parametrize("method", ["3", "4.0", "5.0"])
def test_device_add_writes_host_bytes(card, tmp_path, monkeypatch, method):
    """An add on the card writes the host engine's archive bytes, and the
    archive restores and verifies on the card."""
    src = tmp_path / "src"
    (src / "sub").mkdir(parents=True)
    (src / "a.txt").write_bytes(b"hello world " * 400)
    (src / "b.bin").write_bytes(bytes(range(256)) * 40)
    (src / "sub" / "c.txt").write_bytes(b"fox " * 800)
    monkeypatch.chdir(tmp_path)
    add(str(tmp_path / "h.zpaq"), ["src"], method=method, date=DATE,
        use_device=False)
    before = cme.launches
    add(str(tmp_path / "d.zpaq"), ["src"], method=method, date=DATE)
    assert cme.launches == before + 1
    data = (tmp_path / "d.zpaq").read_bytes()
    assert data == (tmp_path / "h.zpaq").read_bytes()
    jd = read_archive(data)
    extract(data, jd, str(tmp_path / "out"))
    for p in src.rglob("*"):
        if p.is_file():
            rel = p.relative_to(tmp_path)
            assert (tmp_path / "out" / rel).read_bytes() == p.read_bytes()
    assert verify_archive(data, jd)[0] == len(jd.block)


@pytest.mark.parametrize("method", ["0", "3", "4.0", "5.0"])
def test_slice_on_card(card, tmp_path, monkeypatch, method):
    src = tmp_path / "src"
    (src / "sub").mkdir(parents=True)
    (src / "a.txt").write_bytes(b"hello world " * 400)
    (src / "b.bin").write_bytes(bytes(range(256)) * 40)
    (src / "sub" / "c.txt").write_bytes(b"fox " * 800)
    (src / "empty").write_bytes(b"")
    monkeypatch.chdir(tmp_path)
    ref_add(str(tmp_path / "r.zpaq"), ["src"], method=method, date=DATE)
    data = (tmp_path / "r.zpaq").read_bytes()
    jd = read_archive(data)
    before = (cmd.launches, sha1.launches)
    extract(data, jd, str(tmp_path / "out"))
    for p in src.rglob("*"):
        if p.is_file():
            rel = p.relative_to(tmp_path)
            assert (tmp_path / "out" / rel).read_bytes() == p.read_bytes()
    assert verify_archive(data, jd) == ref_verify(data, ref_read(data),
                                                  use_device=False)
    assert cmd.launches == before[0] + (method != "0")
    assert sha1.launches == before[1] + 1


def test_m5_lanes_past_the_count_limit_on_card(card):
    """``5.0`` (23 components, G = 32) over one more lane than a block
    holds, 4-64 KiB each of text, random bytes and repeats: past the
    direct CM's count limit (1,020; its order-0 counter trains once a
    byte) and with MATCH hits. The coded lanes equal the native engine's
    segments, ``cm_decode`` restores them, and ``cm.launch`` counts the
    specialised HCOMP step, combine and phases."""
    from torch.profiler import ProfilerActivity, profile

    from zpaqfranz_tpu_torch import trace
    from zpaqfranz_tpu_torch.parallel.engine import coded_stream, selector

    model = make_model("5.0")[0]
    L = Placement(model, "fast").lanes_per_block + 1
    assert L == 6
    rng = np.random.default_rng(21)
    words = [bytes(rng.integers(97, 123, int(k), dtype=np.uint8))
             for k in rng.integers(2, 9, 500)]
    raws = []
    for k, size in enumerate((4096, 9000, 16384, 30000, 48000, 65536)):
        text = b" ".join(words[i] for i in rng.integers(0, 500, size // 4))
        noise = rng.integers(0, 256, size // 4, dtype=np.uint8).tobytes()
        lane = text[:size // 2] + noise + text[:size // 4]
        raws.append(lane[:size])
    prefix = selector(model)
    coded = [coded_stream(model, r) for r in raws]
    packed = cme.pack_payloads([prefix + r for r in raws], card)
    trace.clear()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            got = cmd.lanes_to_bytes(*cme.cm_encode(model, *packed))
        launch = next(r for r in trace.records() if r.name == "cm.launch")
    finally:
        trace.clear()
    assert got == [c[:-6] for c in coded]
    assert launch.counts["lanes"] == L
    assert [launch.counts[k] for k in ("hcomp", "combine", "phases")] == \
        ["fast"] * 3
    streams = cmd.pack_streams(coded, [len(prefix) + len(r) + 64
                                       for r in raws], card)
    back = cmd.lanes_to_bytes(*cmd.cm_decode(model, *streams))
    assert back == [prefix + r for r in raws]


def _kernel_matches_plain(run, key, *args):
    """``run`` on the card equals its plain version, launches once per
    call, agrees with itself and leaves its inputs unchanged."""
    before = [a.clone() for a in args]
    launches = mb.launches if key in mb.launches else mp.launches
    n = launches[key]
    got = run(*args)
    torch.cuda.synchronize()
    assert launches[key] == n + 1
    assert torch.equal(got, run.plain(*args))
    assert torch.equal(run(*args), got)
    assert all(torch.equal(a, b) for a, b in zip(args, before))


@pytest.mark.parametrize("kind", ["gather", "onehot", "selwrite"])
@pytest.mark.parametrize("S,dtype", [(300, torch.uint8), (96, torch.int32),
                                     (8192, torch.int32)])
def test_column_kernels_match_plain(card, monkeypatch, kind, S, dtype):
    """A, B, C on random tables (int32 at S = 8192 splits the lanes over
    19 blocks) with random int32 start indices, ITERS = 32."""
    monkeypatch.setattr(mb, "ITERS", 32)
    g = torch.Generator().manual_seed(S)
    tab = torch.randint(-2**31, 2**31, (S, mb.L), generator=g,
                        dtype=torch.int64)
    tab = (tab & 0xFF if dtype == torch.uint8 else tab).to(dtype)
    idx = torch.randint(-2**31, 2**31, (1, mb.L), generator=g,
                        dtype=torch.int64).to(torch.int32)
    mk = {"gather": mb.mk_gather_kernel, "onehot": mb.mk_onehot_kernel,
          "selwrite": mb.mk_selwrite_kernel}[kind]
    _kernel_matches_plain(mk(S, dtype), kind, tab.to(card), idx.to(card))


@pytest.mark.parametrize("aligned", [True, False])
def test_lane_loop_and_dma_kernels_match_plain(card, aligned):
    """D on rows at 16-byte boundaries (its 16-byte path) and at any offset
    (its byte path), with 200 lanes over two blocks; E on aligned rows."""
    g = torch.Generator().manual_seed(3)
    S, n = 1024, 200
    tab = torch.randint(0, 256, (n, S), generator=g, dtype=torch.uint8)
    idx = torch.randint(0, S - 64, (n, 1), generator=g).to(torch.int32)
    if aligned:
        idx = idx // 16 * 16
        _kernel_matches_plain(mb.mk_dma_kernel(S, 64), "dma", idx.to(card),
                              tab.to(card))
    _kernel_matches_plain(mb.mk_lane_loop_kernel(S, 16), "lane_loop",
                          idx.to(card), tab.to(card))


def test_probe_kernels_match_plain(card):
    g = torch.Generator().manual_seed(4)
    tab = torch.randint(-2**31, 2**31, (8, 4096), generator=g,
                        dtype=torch.int64).to(torch.int32).to(card)
    lut = torch.randint(-2**31, 2**31, (3000,), generator=g,
                        dtype=torch.int64).to(torch.int32).to(card)
    p1 = lambda t: mp.lane_rw_probe(t, 16)           # noqa: E731
    p1.plain = lambda t: mp.lane_rw_plain(t, 16)
    p2 = lambda t: mp.lut_probe(t, 200, 4)           # noqa: E731
    p2.plain = lambda t: mp.lut_plain(t, 200, 4)
    _kernel_matches_plain(p1, "lane_rw", tab)
    _kernel_matches_plain(p2, "lut", lut)


def _random_column_inputs(S, dtype, n, seed, offset=0):
    """A random (S, n) table of ``dtype``, starting ``offset`` elements into
    its storage (a view the 16-byte staging loads cannot take), and random
    int32 start indices, most of them negative."""
    g = torch.Generator().manual_seed(seed)
    flat = torch.randint(-2**31, 2**31, (S * n + offset,), generator=g,
                         dtype=torch.int64)
    flat = (flat & 0xFF if dtype == torch.uint8 else flat).to(dtype)
    idx = torch.randint(-2**31, 2**31, (1, n), generator=g,
                        dtype=torch.int64).to(torch.int32)
    return flat[offset:].view(S, n), idx


@pytest.mark.parametrize("kind", ["gather", "onehot", "selwrite"])
@pytest.mark.parametrize("S,dtype", [
    (1, torch.uint8), (1, torch.int32), (33, torch.uint8), (33, torch.int32),
    (1000, torch.uint8), (1000, torch.int32), (mb.SMEM_MAX, torch.uint8),
    (mb.SMEM_MAX // 4, torch.int32)])
def test_column_kernels_at_edge_sizes(card, monkeypatch, kind, S, dtype):
    """A, B, C at S = 1, 33, 1000 (the reciprocal floor modulo) and the
    largest S a block holds, over 130 lanes (not a multiple of any block's
    lanes; 3 at the largest S), random tables and starts."""
    monkeypatch.setattr(mb, "ITERS", 8 if S > 1000 else 32)
    n = 3 if S > 1000 else 130
    tab, idx = _random_column_inputs(S, dtype, n, S + 7)
    mk = {"gather": mb.mk_gather_kernel, "onehot": mb.mk_onehot_kernel,
          "selwrite": mb.mk_selwrite_kernel}[kind]
    _kernel_matches_plain(mk(S, dtype), kind, tab.to(card), idx.to(card))


@pytest.mark.parametrize("kind", ["gather", "onehot", "selwrite"])
@pytest.mark.parametrize("S,dtype,offset", [(256, torch.uint8, 3),
                                            (2048, torch.uint8, 4),
                                            (512, torch.int32, 1),
                                            (8192, torch.int32, 2)])
def test_column_kernels_stage_any_alignment(card, monkeypatch, kind, S,
                                            dtype, offset):
    """Tables that start 1-4 elements into their storage, so that the
    staging takes one element at a time instead of 16 bytes, at the
    scripts' sizes over 128 lanes."""
    monkeypatch.setattr(mb, "ITERS", 32)
    tab, idx = _random_column_inputs(S, dtype, mb.L, S + offset, offset)
    mk = {"gather": mb.mk_gather_kernel, "onehot": mb.mk_onehot_kernel,
          "selwrite": mb.mk_selwrite_kernel}[kind]
    _kernel_matches_plain(mk(S, dtype), kind, tab.to(card), idx.to(card))


@pytest.mark.parametrize("n", [1, 33, 1000, 3000, mp.LUT, mb.SMEM_MAX // 4])
def test_lut_kernel_at_both_modulo_kinds(card, n):
    """P2 with a random LUT of n entries (a mask at 1 and 4096, the
    reciprocal otherwise; 16-byte staging where n % 4 == 0) over 200 lanes,
    two blocks of 128."""
    g = torch.Generator().manual_seed(n)
    lut = torch.randint(-2**31, 2**31, (n,), generator=g,
                        dtype=torch.int64).to(torch.int32).to(card)
    p2 = lambda t: mp.lut_probe(t, 200, 4)           # noqa: E731
    p2.plain = lambda t: mp.lut_plain(t, 200, 4)
    _kernel_matches_plain(p2, "lut", lut)


@pytest.mark.parametrize("n", [1, 133, 265])
def test_lane_loop_and_dma_kernels_at_odd_lane_counts(card, n):
    """D (aligned and unaligned rows) and E over lane counts that leave
    the last block of ``spread_plan`` part-empty on a 132-SM card."""
    g = torch.Generator().manual_seed(n)
    S = 512
    tab = torch.randint(0, 256, (n, S), generator=g, dtype=torch.uint8)
    idx = torch.randint(0, S - 64, (n, 1), generator=g).to(torch.int32)
    _kernel_matches_plain(mb.mk_lane_loop_kernel(S, 16), "lane_loop",
                          idx.to(card), tab.to(card))
    idx = idx // 16 * 16
    _kernel_matches_plain(mb.mk_lane_loop_kernel(S, 16), "lane_loop",
                          idx.to(card), tab.to(card))
    _kernel_matches_plain(mb.mk_dma_kernel(S, 64), "dma", idx.to(card),
                          tab.to(card))


@pytest.mark.parametrize("sw", [36, 1000, mp.SW])
def test_lane_rw_kernel_at_both_modulo_kinds(card, sw):
    """P1 on a random table whose SW - W is a power of two (a mask), 996 or
    the script's 32764 (the reciprocal), from random, mostly negative
    words over 5 lanes."""
    g = torch.Generator().manual_seed(sw)
    tab = torch.randint(-2**31, 2**31, (5, sw), generator=g,
                        dtype=torch.int64).to(torch.int32).to(card)
    p1 = lambda t: mp.lane_rw_probe(t, 12)           # noqa: E731
    p1.plain = lambda t: mp.lane_rw_plain(t, 12)
    _kernel_matches_plain(p1, "lane_rw", tab)


@pytest.mark.parametrize("W", [32, 48])
def test_lane_loop_kernel_at_wider_rows(card, W):
    """D with rows of several 16-byte units (the first outside the loop
    over the others) and byte by byte, on a random table over 133 lanes."""
    g = torch.Generator().manual_seed(W)
    S = 1024
    tab = torch.randint(0, 256, (133, S), generator=g, dtype=torch.uint8)
    idx = torch.randint(0, S - W, (133, 1), generator=g).to(torch.int32)
    for rows in (idx // 16 * 16, idx):
        _kernel_matches_plain(mb.mk_lane_loop_kernel(S, W), "lane_loop",
                              rows.to(card), tab.to(card))


def test_chase_steps_order_the_levels(card):
    """The chase ends where its ring says (``chase_ns`` checks it), and a
    shared step is faster than an L2 step, which is faster than HBM's."""
    got = {level: mp.chase_ns(level, card)
           for level in (*mp.CHASE, "l2_rw")}
    print({k: (round(ns, 2), round(c, 1)) for k, (ns, c) in got.items()})
    assert 0 < got["shared"][0] < got["l2"][0] < got["hbm"][0]
    assert got["l2_rw"][0] > 0
    assert all(c > 0 for _, c in got.values())


def test_ladder_codec_stage_on_card(card):
    """-m3 at 64 lanes of 512 bytes (2 blocks of the CM kernels): every
    lane codes as the host engine does and decodes back."""
    before = (cme.launches, cmd.launches)
    st = device_bench.run_ladder(ladder=[("codec", "3", 64, 512)])
    assert st["cm_3_L64"]["ok"]
    assert cme.launches == before[0] + 2 and cmd.launches == before[1] + 2


def test_b_records_each_method_for_this_card(card, monkeypatch, capsys):
    """``b``'s calibration at a small size: SHA-1 and -m3, -m4, -m5 at 1
    and 4 lanes, each with the card's and the host engine's rate, in a
    record of this card; the gate's decisions printed."""
    import json

    from zpaqfranz_tpu_torch import cli, device_policy

    monkeypatch.setattr(device_bench, "CAL_LANE_BYTES", 4096)
    monkeypatch.setattr(device_bench, "CAL_WIDE", 4)
    before = (sha1.launches, cme.launches, cmd.launches)
    assert cli.main(["b"]) == 0
    assert sha1.launches > before[0] and cme.launches > before[1] \
        and cmd.launches > before[2]
    cal = device_policy.load_calibration()
    print(json.dumps(cal))
    assert cal["card"] == torch.cuda.get_device_name()
    for key in ("hash_device_MBps", "hash_host_MBps", "codec_device_MBps",
                "codec_host_MBps"):
        assert cal[key] > 0
    for m in device_bench.CAL_METHODS:
        assert sorted(cal["methods"][m], key=int) == ["1", "4"]
        for e in cal["methods"][m].values():
            assert e["device_MBps"] > 0 and e["host_MBps"] > 0
            assert e["lane_bytes"] == 4096
    out = capsys.readouterr().out
    assert out.count("  gate codec -m") == 9


def test_unforced_add_follows_the_record_on_card(card, tmp_path,
                                                 monkeypatch, capsys):
    """Under a record that favours the host engine an unforced ``a -m3``
    launches no CM kernel, under one that favours the card it codes on the
    card, and both write the bytes of ``a -tpu``."""
    import zpaqfranz_tpu_torch.jidac.add as add_mod
    from zpaqfranz_tpu_torch import cli, device_policy

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(add_mod, "now_date", lambda: DATE)
    monkeypatch.setattr(device_policy, "MIN_JOB_BYTES", 16)
    src = tmp_path / "src"
    src.mkdir()
    (src / "a.txt").write_bytes(b"the gate on the card " * 300)
    (src / "b.txt").write_bytes(b"per method and lane count " * 200)
    assert cli.main(["a", "forced", "src", "-m3", "-tpu"]) == 0
    want = (tmp_path / "forced.zpaq").read_bytes()
    for name, dev_rate, launched in (("host", 0.1, False),
                                     ("card", 40.0, True)):
        device_policy.record_lanes("3", 1, device_MBps=dev_rate,
                                   host_MBps=4.0, lane_bytes=4096)
        before = cme.launches
        assert cli.main(["a", name, "src", "-m3"]) == 0
        assert (cme.launches > before) is launched
        assert (tmp_path / f"{name}.zpaq").read_bytes() == want
    err = capsys.readouterr().err
    assert "-> host engine" in err and "-> card" in err


@pytest.mark.parametrize("method", ["3", "4"])
def test_encrypted_modeled_archive_on_card(card, tmp_path, monkeypatch,
                                           method):
    """An encrypted (``-key``) modeled archive: ``add`` -> ``extract`` ->
    ``verify_archive`` on the card restore every byte, as the host engine
    does."""
    from zpaqfranz_tpu_torch.jidac.archive_io import ArchiveSource
    from zpaqfranz_tpu_torch.jidac.index import read_archive_src

    monkeypatch.chdir(tmp_path)
    src = tmp_path / "src"
    src.mkdir()
    rng = np.random.default_rng(int(method))
    (src / "a.txt").write_bytes(b"encrypted lanes on the card " * 500)
    (src / "b.bin").write_bytes(rng.integers(0, 4, 9000,
                                             dtype=np.uint8).tobytes())
    want = {p.name: p.read_bytes() for p in src.iterdir()}
    before = (cme.launches, cmd.launches, sha1.launches)
    for name, kw in (("card", {"device": card}),
                     ("host", {"use_device": False})):
        arc = str(tmp_path / f"{name}.zpaq")
        add(arc, ["src"], method=method, key="pw", date=DATE, **kw)
        srcs = ArchiveSource.from_spec(arc, key="pw")
        jd = read_archive_src(srcs)
        extract(srcs, jd, str(tmp_path / f"out-{name}"), **kw)
        assert {p.name: p.read_bytes()
                for p in (tmp_path / f"out-{name}" / "src").iterdir()} == want
        assert verify_archive(srcs, jd, **kw)[0] == len(jd.block)
    assert cme.launches > before[0] and cmd.launches > before[1] \
        and sha1.launches > before[2]


# ---------------------------------------------------------------------------
# the HCOMP step: the specialised program against the interpreter


def _prefix(ref):
    blob = ref.pcomp_bytes()
    return (b"\x01" + blob) if blob else b"\x00"


def _both_steps(card, ref, model, raws):
    """Encode and decode ``raws`` with the specialised HCOMP step and with
    the interpreter forced: both steps give the native engine's coded
    segments and restore the payloads. Returns the launches' steps."""
    prefix = _prefix(ref)
    packed = cme.pack_payloads([prefix + r for r in raws], card)
    coded = _coded(ref, raws)
    streams = cmd.pack_streams(coded, [len(prefix) + len(r) + 64
                                       for r in raws], card)
    steps = []
    for hcomp in (None, "interp"):
        enc = cme.Launch(model, *packed, hcomp=hcomp).run()
        dec = cmd.Launch(model, *streams, hcomp=hcomp).run()
        assert cmd.lanes_to_bytes(*enc.result()) == [c[:-6] for c in coded]
        assert cmd.lanes_to_bytes(*dec.result()) == [prefix + r
                                                     for r in raws]
        steps.append((enc.hcomp, dec.hcomp))
    return steps


@pytest.mark.parametrize("method", ["3", "4", "5", "4.0", "5.0"])
@pytest.mark.parametrize("count", ["1", "lpb", "lpb+1"])
def test_cm_hcomp_fast_equals_interp(card, method, count):
    """At 1 lane, one block's lanes and one lane into a second block (lanes
    per block from the specialised launch's placement), the specialised
    HCOMP step and the interpreter code and decode every lane as the host
    engine does."""
    ref, _ = ref_make_model(method)
    model = convert.model_from_reference_header(ref.header_bytes())
    lpb = Placement(model, "fast").lanes_per_block
    L = {"1": 1, "lpb": lpb, "lpb+1": lpb + 1}[count]
    rng = np.random.default_rng(L)
    raws = [b"Lane %d: " % k + b"The Cat sat on the mat, " * int(k % 3)
            + rng.integers(0, 256, int(k % 5), dtype=np.uint8).tobytes()
            for k in range(L)]
    before = dict(cme.hcomp_launches)
    assert _both_steps(card, ref, model, raws) == [("fast", "fast"),
                                                   ("interp", "interp")]
    assert cme.hcomp_launches["fast"] == before["fast"] + 1
    assert cme.hcomp_launches["interp"] == before["interp"] + 1


# ---------------------------------------------------------------------------
# the combine: the generated straight-line code against the generic walk


@pytest.mark.parametrize("method", ["3", "4", "5", "4.0", "5.0"])
@pytest.mark.parametrize("count", ["1", "lpb", "lpb+1"])
def test_cm_combine_fast_equals_generic(card, method, count):
    """At 1 lane, one block's lanes and one lane into a second block, the
    generated combine and the generic one forced each code and decode
    every lane as the host engine does; each launch counts under its
    combine."""
    ref, _ = ref_make_model(method)
    model = convert.model_from_reference_header(ref.header_bytes())
    lpb = Placement(model, "fast").lanes_per_block
    L = {"1": 1, "lpb": lpb, "lpb+1": lpb + 1}[count]
    rng = np.random.default_rng(100 + L)
    raws = [b"Combine %d: " % k + b"the dog, the Dog; THE DOG " * int(k % 4)
            + rng.integers(0, 256, int(k % 7), dtype=np.uint8).tobytes()
            for k in range(L)]
    prefix = _prefix(ref)
    packed = cme.pack_payloads([prefix + r for r in raws], card)
    coded = _coded(ref, raws)
    streams = cmd.pack_streams(coded, [len(prefix) + len(r) + 64
                                       for r in raws], card)
    before = (dict(cme.combine_launches), dict(cmd.combine_launches))
    for combine, want in ((None, "fast"), ("generic", "generic")):
        enc = cme.Launch(model, *packed, combine=combine).run()
        dec = cmd.Launch(model, *streams, combine=combine).run()
        assert (enc.combine, dec.combine, enc.hcomp) == (want, want, "fast")
        assert cmd.lanes_to_bytes(*enc.result()) == [c[:-6] for c in coded]
        assert cmd.lanes_to_bytes(*dec.result()) == [prefix + r
                                                     for r in raws]
    for mod, old in zip((cme, cmd), before):
        assert mod.combine_launches == {k: v + 1 for k, v in old.items()}


@pytest.mark.parametrize("method", ["3", "4", "5", "4.0", "5.0"])
def test_cm_combine_keeps_the_placement(card, method):
    """A launch's placement is the same with either combine: the generated
    code reads the rows where the generic walk reads them."""
    ref, _ = ref_make_model(method)
    model = convert.model_from_reference_header(ref.header_bytes())
    packed = cme.pack_payloads([_prefix(ref) + b"placement"], card)
    a, b = (cme.Launch(model, *packed, combine=c).plan
            for c in ("fast", "generic"))
    assert a.lanes_per_block == b.lanes_per_block == {
        "3": 57, "4": 6, "5": 5, "4.0": 6, "5.0": 5}[method]
    assert (a.G, a.lane_words, a.rows, a.geo, a.smem) \
        == (b.G, b.lane_words, b.rows, b.geo, b.smem)


def test_cm_combine_interp_hcomp_and_generic_combine(card):
    """The four pairings of HCOMP step and combine at -m4 over a block's
    lanes and one more code the same bytes."""
    ref, _ = ref_make_model("4.0")
    model = convert.model_from_reference_header(ref.header_bytes())
    raws = [b"pairing %d " % k * (k + 1) for k in range(7)]
    prefix = _prefix(ref)
    packed = cme.pack_payloads([prefix + r for r in raws], card)
    coded = _coded(ref, raws)
    streams = cmd.pack_streams(coded, [len(prefix) + len(r) + 64
                                       for r in raws], card)
    for hcomp in ("fast", "interp"):
        for combine in ("fast", "generic"):
            enc = cme.Launch(model, *packed, hcomp=hcomp,
                             combine=combine).run()
            dec = cmd.Launch(model, *streams, hcomp=hcomp,
                             combine=combine).run()
            assert cmd.lanes_to_bytes(*enc.result()) == [c[:-6]
                                                         for c in coded]
            assert cmd.lanes_to_bytes(*dec.result()) == [prefix + r
                                                         for r in raws]


# ---------------------------------------------------------------------------
# phases (a) and (c): the generated straight-line code against the generic


@pytest.mark.parametrize("method", ["3", "4", "5", "4.0", "5.0"])
@pytest.mark.parametrize("count", ["1", "lpb", "lpb+1"])
def test_cm_phases_fast_equals_generic(card, method, count):
    """At 1 lane, one block's lanes and one lane into a second block, the
    generated phases and the generic ones forced each code and decode
    every lane as the host engine does, at the same placement; each launch
    counts under its phases."""
    ref, _ = ref_make_model(method)
    model = convert.model_from_reference_header(ref.header_bytes())
    lpb = Placement(model, "fast").lanes_per_block
    L = {"1": 1, "lpb": lpb, "lpb+1": lpb + 1}[count]
    rng = np.random.default_rng(200 + L)
    raws = [b"Phases %d: " % k + b"a bird, a Bird; A BIRD " * int(k % 5)
            + rng.integers(0, 256, int(k % 9), dtype=np.uint8).tobytes()
            for k in range(L)]
    prefix = _prefix(ref)
    packed = cme.pack_payloads([prefix + r for r in raws], card)
    coded = _coded(ref, raws)
    streams = cmd.pack_streams(coded, [len(prefix) + len(r) + 64
                                       for r in raws], card)
    before = (dict(cme.phases_launches), dict(cmd.phases_launches))
    plans = []
    for phases, want in ((None, "fast"), ("generic", "generic")):
        enc = cme.Launch(model, *packed, phases=phases).run()
        dec = cmd.Launch(model, *streams, phases=phases).run()
        assert (enc.phases, dec.phases, enc.combine) == (want, want, "fast")
        assert cmd.lanes_to_bytes(*enc.result()) == [c[:-6] for c in coded]
        assert cmd.lanes_to_bytes(*dec.result()) == [prefix + r
                                                     for r in raws]
        plans.append((enc.plan.lanes_per_block, enc.plan.smem,
                      enc.plan.blocks(L)))
    assert plans[0] == plans[1]
    for mod, old in zip((cme, cmd), before):
        assert mod.phases_launches == {k: v + 1 for k, v in old.items()}


def test_cm_phases_archives_identical(card, tmp_path, monkeypatch):
    """A card ``a`` of one tree at ``3.0``, ``4.0`` and ``5.0`` writes the
    same archive with the generated phases and with the generic ones
    forced in every launch."""
    import zpaqfranz_tpu_torch.jidac.add as add_mod
    from zpaqfranz_tpu_torch import cli
    from zpaqfranz_tpu_torch.ops import cm_model

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(add_mod, "now_date", lambda: DATE)
    rng = np.random.default_rng(20)
    src = tmp_path / "src"
    src.mkdir()
    (src / "text.txt").write_bytes(b"the phases of a bit, " * 4000)
    (src / "mixed.bin").write_bytes(
        b"".join(b"record %d; " % k + rng.integers(0, 256, k % 13,
                                                   dtype=np.uint8).tobytes()
                 for k in range(6000)))
    orig = cm_model.phases_step
    for method in ("3.0", "4.0", "5.0"):
        digests = []
        for phases in ("fast", "generic"):
            monkeypatch.setattr(
                cm_model, "phases_step",
                lambda model, plan, want=None, ph=phases: orig(
                    model, plan, want or ph))
            before = dict(cme.phases_launches)
            name = f"{method}-{phases}"
            assert cli.main(["a", name, "src", "-method", method,
                             "-tpu"]) == 0
            assert cme.phases_launches[phases] > before[phases]
            digests.append(hashlib.sha1(
                (tmp_path / f"{name}.zpaq").read_bytes()).hexdigest())
        print(method, digests)
        assert digests[0] == digests[1], method
    monkeypatch.setattr(cm_model, "phases_step", orig)


def test_cm_rejected_program_runs_the_interpreter(card):
    """A looping program is outside the specialisable subset: a launch
    runs the interpreter, and asking for the specialised step raises."""
    ref = ref_compile(LOOP_CFG)[0]
    model = convert.model_from_reference_header(ref.header_bytes())
    assert _both_steps(card, ref, model, [b"a", b"loop!", b"\x00\xff"]) \
        == [("interp", "interp")] * 2
    with pytest.raises(ValueError, match="specialisable"):
        cme.Launch(model, *cme.pack_payloads([b"\x00a"], card),
                   hcomp="fast")


# HCOMP of 3 * 2^23 + 10 instructions a byte: past the kernels' default
# limit of 2^24, within 2^25
LONG_CFG = """
comp 1 0 0 0 2
  0 cm 16 4
  1 cm 12 4
hcomp
  c=a a= 128 a<<= 16
  do a-- a> 0 while
  a=c a<<= 8 d= 0 *d=a
  a=c d= 1 *d=a
  halt
post 0 end
"""


def test_cm_hcomp_step_limit_per_call(card):
    """The runaway program fails under the default limit; one that needs
    more than 2^24 instructions a byte fails under it too and codes and
    decodes with a raised ``max_hcomp_steps``, at every layer that takes
    it."""
    from zpaqfranz_tpu_torch.parallel import engine

    ref = ref_compile(LONG_CFG)[0]
    model = convert.model_from_reference_header(ref.header_bytes())
    raws = [b"ab"]
    coded = _coded(ref, raws)
    streams = cmd.pack_streams(coded, [64], card)
    with pytest.raises(cmd.CMDecodeError, match="HCOMP program faulted"):
        cmd.cm_decode(model, *streams)
    with pytest.raises(cme.CMEncodeError, match="HCOMP program faulted"):
        cme.cm_encode(model, *cme.pack_payloads([b"\x00ab"], card))
    more = 1 << 25
    assert cmd.lanes_to_bytes(*cmd.cm_decode(
        model, *streams, max_hcomp_steps=more)) == [b"\x00ab"]
    assert engine.decode_streams(model, coded, [64], card,
                                 max_hcomp_steps=more) == [b"\x00ab"]
    assert engine.encode_streams(model, [b"\x00ab"], card,
                                 max_hcomp_steps=more) == [coded[0][:-6]]
    runaway = convert.model_from_reference_header(
        ref_compile(RUNAWAY_CFG)[0].header_bytes())
    with pytest.raises(cmd.CMDecodeError, match="HCOMP program faulted"):
        cmd.cm_decode(runaway, *streams, max_hcomp_steps=1000)


def test_verify_runs_in_several_launches(card, tmp_path, monkeypatch):
    """``t`` with a batch budget of one byte: one launch per block, the
    counts of one launch, and a bad fragment checksum still found."""
    from zpaqfranz_tpu_torch.jidac import extract as ex

    monkeypatch.chdir(tmp_path)
    arc = tmp_path / "m.zpaq"
    for k in range(3):
        (tmp_path / f"s{k}").mkdir()
        (tmp_path / f"s{k}" / "f").write_bytes(b"block %d " % k * 500)
        add(str(arc), [f"s{k}"], method="1", date=DATE + k,
            use_device=False)
    data = arc.read_bytes()
    jd = read_archive(data)
    assert len(jd.block) == 3
    want = verify_archive(data, jd)
    monkeypatch.setattr(ex, "VERIFY_BATCH_BYTES", 1)
    before = sha1.launches
    assert verify_archive(data, jd) == want
    assert sha1.launches == before + 3
    j = jd.block[1].start
    jd.ht[j].sha1 = b"\x01" * 20
    with pytest.raises(ex.ExtractError, match=f"fragment {j}: checksum"):
        verify_archive(data, jd)


def test_sharded_lanes_on_one_card_twice(card):
    """Lanes split over [cuda:0] * 2: the unsharded launch's coded bytes
    and the host engine's, one launch per shard each way, and decoded back
    to the payloads."""
    from zpaqfranz_tpu_torch import native
    from zpaqfranz_tpu_torch.codec.methods import make_model
    from zpaqfranz_tpu_torch.parallel import dist, engine

    model, _ = make_model("4.0")
    rng = np.random.default_rng(12)
    pays = [b"\x00" + b"the cat sat on the mat %d " % k * 40
            + rng.integers(0, 256, 100 * k, dtype=np.uint8).tobytes()
            for k in range(5)]
    want = [parse_block_payload(native.compress_block(model, p[1:], b"t",
                                                      b"c"), 0)[2][:-6]
            for p in pays]
    mesh = [torch.device("cuda", 0)] * 2
    before = (cme.launches, cmd.launches)
    coded = dist.encode_streams_sharded(model, pays, mesh)
    assert coded == want == engine.encode_streams(model, pays, card)
    back = dist.decode_streams_sharded(model, coded,
                                       max(map(len, pays)) + 8, mesh)
    assert back == pays
    assert dist.decode_streams_sharded_chunked(
        model, coded, max(map(len, pays)) + 8, mesh) == pays
    assert cme.launches == before[0] + 3 and cmd.launches == before[1] + 4


def test_dist_add_world2_on_card(card, tmp_path):
    """Two ranks of the multi-host add, each coding its d blocks on the
    card (``--device``), write the host engine's archive; each rank's
    printed launch count shows the card coded its blocks."""
    from zpaqfranz_tpu_torch.parallel import multihost as mh

    corpus = tmp_path / "corpus"
    corpus.mkdir()
    rng = np.random.default_rng(3)
    words = [bytes(rng.integers(97, 123, int(n), dtype=np.uint8))
             for n in rng.integers(2, 9, 2000)]
    for k in range(3):       # 1.2 MiB: two d blocks of 1 MiB at most
        body = b" ".join(words[i] for i in rng.integers(0, 2000, 80000))
        (corpus / f"t{k}.txt").write_bytes(body[:400 * 1024])
    rep = mh.scaling_report(str(corpus), worlds=(2,), method="x0.0ci1",
                            flags=["--device"], timeout=600)
    host = mh.scaling_report(str(corpus), worlds=(1,), method="x0.0ci1",
                             flags=["--notpu"], timeout=600)
    assert rep[2]["archive_sha1"] == host[1]["archive_sha1"]
    assert rep[2]["cm_encode_launches"] == 2      # one on each rank
    assert host[1]["cm_encode_launches"] == 0


def test_paranoid_and_compare_on_card(card, tmp_path, monkeypatch, capsys):
    """``p`` and ``c`` decode on the card (CM lanes) and hash fragments in
    the SHA-1 lanes, and print the host engine's lines."""
    from zpaqfranz_tpu_torch.cli import main as cli_main

    src = tmp_path / "src"
    (src / "sub").mkdir(parents=True)
    (src / "a.txt").write_bytes(b"hello world " * 400)
    (src / "sub" / "c.txt").write_bytes(b"fox " * 800)
    monkeypatch.chdir(tmp_path)
    ref_add(str(tmp_path / "r.zpaq"), ["src"], method="3", date=DATE)
    for cmd_name in ("p", "c"):
        capsys.readouterr()
        assert cli_main([cmd_name, "r", "-notpu"]) == 0
        want = capsys.readouterr().out
        before = (cmd.launches, sha1.launches)
        assert cli_main([cmd_name, "r"]) == 0
        assert capsys.readouterr().out == want
        assert cmd.launches == before[0] + 1
        assert sha1.launches == before[1] + 1


def _crc_spans(data, spans, seg=hb.CRC_SEG):
    """The kernel's CRCs of ``data[o:o + n]`` for ``spans`` over segments
    of ``seg`` bytes against its plain version and native.crc32; one
    launch."""
    host = data.cpu().numpy().tobytes()
    off = torch.tensor([o for o, _ in spans], dtype=torch.int64,
                       device=data.device)
    ln = torch.tensor([n for _, n in spans], dtype=torch.int64,
                      device=data.device)
    before = hb.launches
    got = (hb.crc32_flat(data, off, ln) if seg == hb.CRC_SEG
           else hb.CrcLaunch(data, off, ln, seg).run())
    torch.cuda.synchronize()
    assert hb.launches == before + 1
    assert torch.equal(got.view(torch.int32),
                       hb.crc32_plain(data, off, ln).view(torch.int32))
    assert [int(c) & 0xFFFFFFFF for c in got.view(torch.int32).tolist()] \
        == [ref_native.crc32(host[o:o + n]) for o, n in spans]


def test_crc32_kernel_at_every_offset_and_length(card):
    rng = np.random.default_rng(41)
    data = torch.from_numpy(rng.integers(0, 256, 1001, dtype=np.uint8)).to(
        card)
    _crc_spans(data, [(o, n) for o in range(64)
                      for n in (0, 1, 2, 15, 16, 17, 31, 32, 33, 64, 300)])


@pytest.mark.parametrize("start", [0, 5, 16])
def test_crc32_kernel_reads_to_the_last_byte_of_data(card, start):
    # views of 4,099 bytes (not a multiple of 16) at offsets of one buffer
    rng = np.random.default_rng(42)
    buf = torch.from_numpy(rng.integers(0, 256, 5000, dtype=np.uint8)).to(
        card)
    _crc_spans(buf[start:start + 4099], [(4099 - n, n) for n in
                                         (0, 1, 15, 16, 17, 64, 65, 4099)])


@pytest.mark.parametrize("count", [1, 63, 64, 65, 8449, 150_000])
def test_crc32_kernel_at_lane_counts(card, count):
    # one lane, lanes about a warp, 8449 lanes (one thread a lane: a block
    # per SM + 1) and many waves
    rng = np.random.default_rng(count)
    data = torch.from_numpy(rng.integers(0, 256, 20_000, dtype=np.uint8)).to(
        card)
    lens = rng.integers(0, 300, count)
    offs = rng.integers(0, 20_000 - 300, count)
    _crc_spans(data, list(zip(offs.tolist(), lens.tolist())))


@pytest.mark.parametrize("seg", [64, 1024, hb.CRC_SEG, 65536])
def test_crc32_kernel_at_segment_edges(card, seg):
    # lanes of seg - 1, seg and seg + 1 bytes (and 2 seg + 15) from every
    # offset 0..15 of a segment boundary and of the buffer
    rng = np.random.default_rng(seg)
    size = 3 * seg + 64
    buf = torch.from_numpy(rng.integers(0, 256, size + seg, dtype=np.uint8)
                           ).to(card)
    data = buf[(-buf.data_ptr()) % seg:][:size]     # starts on a boundary
    lens = (seg - 1, seg, seg + 1, 2 * seg + 15)
    _crc_spans(data, [(b + o, n) for b in (0, seg) for o in range(16)
                      for n in lens] + [(size - n, n) for n in lens], seg)


@pytest.mark.parametrize("mib", [1, 64])
def test_crc32_kernel_on_one_long_lane_alone(card, mib):
    """One lane of 1 MiB or 64 MiB alone (256 or 16,384 segments combined
    by a warp), at a start off a segment boundary, against native.crc32
    and zlib; the 1 MiB lane also against the plain segmented path (its
    per-byte loop over 64 KiB segments). crc32_plain's per-byte loop would
    take ~10^6-10^8 launches here: the other tests hold the kernel against
    it."""
    import zlib
    n = mib << 20
    rng = np.random.default_rng(mib)
    host = rng.integers(0, 256, n + 7, dtype=np.uint8)
    data = torch.from_numpy(host).to(card)
    off = torch.tensor([7], dtype=torch.int64, device=card)
    ln = torch.tensor([n], dtype=torch.int64, device=card)
    got = int(hb.crc32_flat(data, off, ln).view(torch.int32)[0]) & 0xFFFFFFFF
    msg = host[7:].tobytes()
    assert got == ref_native.crc32(msg) == zlib.crc32(msg)
    if mib == 1:
        plain = hb.crc32_segmented(data, off, ln, 1 << 16)
        assert int(plain.view(torch.int32)[0]) & 0xFFFFFFFF == got


def test_crc32_kernel_with_empty_and_long_lanes(card):
    rng = np.random.default_rng(44)
    data = torch.from_numpy(rng.integers(0, 256, 200_000, dtype=np.uint8)
                            ).to(card)
    lens = [0, 40_000, 0, 0, 1, 33_333, 0, 17, 39_999, 0]
    offs = rng.integers(0, 200_000 - 40_000, len(lens)).tolist()
    _crc_spans(data, list(zip(offs, lens)))
    _crc_spans(data, [(5, 0)] * 40)                 # every lane empty


def test_crc32_kernel_profile_and_registers(card, tmp_path, capsys):
    """A profiled launch of one aligned segment alone fills its counters;
    the kernels' registers and spills as ptxas reports them (none may
    spill)."""
    import subprocess
    from zpaqfranz_tpu_torch.ops import build
    seg = hb.CRC_SEG
    buf = torch.zeros(3 * seg, dtype=torch.uint8, device=card)
    start = (-buf.data_ptr()) % seg
    prof = torch.zeros(len(hb.CRC_PROFILE), dtype=torch.int64, device=card)
    launch = hb.CrcLaunch(buf, torch.tensor([start], device=card),
                          torch.tensor([seg], device=card), profile=prof)
    assert launch.segments == 1 and launch.group == 1
    launch.run()
    torch.cuda.synchronize()
    cycles, pieces, comb, segs = prof.tolist()
    assert pieces == seg // 16 and segs == 1 and cycles > 0 and comb > 0
    rows = seg // hb.CRC_ROW
    log = subprocess.run(build._command("crc32_lanes", tmp_path / "lib.so"),
                         capture_output=True, text=True, check=True)
    lines = [ln.strip() for ln in (log.stdout + log.stderr).splitlines()
             if "registers" in ln or "spill" in ln]
    with capsys.disabled():
        print(f"\ncrc32_lanes: {cycles / rows:.1f} cycles a row of "
              f"{hb.CRC_ROW} bytes alone; ptxas: " + "; ".join(lines))
    assert lines and all(" 0 bytes spill stores" in ln for ln in lines
                         if "spill" in ln)


def test_hash_batched_lanes_on_card(card):
    rng = np.random.default_rng(43)
    chunks = [rng.integers(0, 256, int(n), dtype=np.uint8).tobytes()
              for n in (0, 1, 15, 16, 63, 64, 65, 4096, 70_000)]
    data, lens = hb.pad_lanes(chunks)
    before = (sha1.launches, sha256.launches, hb.launches)
    s1 = hb.sha1_lanes(data, lens)
    s2 = hb.sha256_lanes(data, lens)
    crc = hb.crc32_lanes(data, lens)
    assert crc.device.type == "cuda"
    assert (sha1.launches, sha256.launches, hb.launches) == tuple(
        b + 1 for b in before)
    assert hb.digest_bytes(s1) == [hashlib.sha1(c).digest() for c in chunks]
    assert hb.digest_bytes(s2) == [hashlib.sha256(c).digest()
                                   for c in chunks]
    assert [int(c) & 0xFFFFFFFF for c in crc.view(torch.int32).tolist()] \
        == [ref_native.crc32(c) for c in chunks]


@pytest.mark.parametrize("kind", ["random", "text", "zeros"])
def test_bwt_encode_device_on_card(card, kind):
    rng = np.random.default_rng(44)
    n = 1 << 20
    data = {"random": rng.integers(0, 256, n, dtype=np.uint8).tobytes(),
            "text": (b"the quick brown fox jumps " * (n // 26 + 1))[:n],
            "zeros": bytes(4096)}[kind]
    before = bwt_device.launches
    assert bwt_device.bwt_encode_device(data) == ref_native.bwt_encode(data)
    assert bwt_device.launches == before + 1
    sa = bwt_device.suffix_array_device(data[:5000])
    assert np.array_equal(sa, bwt_device.suffix_array_device(
        data[:5000], device="cpu"))


def test_card_add_sorts_its_bwt_jobs_on_the_card(card, tmp_path,
                                                monkeypatch):
    """The card add at ``3.0`` of a ~8 MiB tree on 8 pool threads, the
    jobs waiting sorted together: every BWT job's suffix sort runs on the
    card (``bwt_device.launches`` rises by the archive's d blocks, each a
    BWT job), and the archive is the host engine's, byte for byte."""
    rng = np.random.default_rng(47)
    vocab = [bytes(rng.integers(97, 123, int(k), dtype=np.uint8))
             for k in rng.integers(2, 10, 3000)]
    src = tmp_path / "src"
    src.mkdir()
    for k in range(4):
        words = b" ".join(vocab[i] for i in
                          rng.integers(0, len(vocab), 300_000))
        (src / f"t{k}.txt").write_bytes(words[:1_600_000])
    code = rng.integers(0, 256, 1_800_000, dtype=np.uint8)
    code[::97] = 0xE8
    (src / "c.bin").write_bytes(code.tobytes())
    monkeypatch.chdir(tmp_path)
    add("h.zpaq", ["src"], method="3.0", date=DATE, threads=8,
        use_device=False)
    before = bwt_device.launches
    add("d.zpaq", ["src"], method="3.0", date=DATE, threads=8)
    data = (tmp_path / "d.zpaq").read_bytes()
    assert data == (tmp_path / "h.zpaq").read_bytes()
    jobs = len(read_archive(data).block)
    assert jobs >= 8 and bwt_device.launches == before + jobs


def test_batched_predictor_on_card(card):
    """BatchedPredictor with no device runs on the card: three lanes in
    lockstep over every component type give each lane the scalar
    predictor's probability at every bit."""
    model = convert.model_from_reference_header(
        ref_compile(ALL_COMPONENTS_CFG)[0].header_bytes())
    lanes = [b"abcabcabcabd", bytes(range(12)), b"zzzzzzzzzzzz"]
    bp = BatchedPredictor(model)
    st = bp.init_state(len(lanes))
    assert st.dev.type == "cuda"
    scalars = [Predictor(model) for _ in lanes]
    for j in range(len(lanes[0])):
        for phase in range(8):
            p_final, p, st = bp.predict(st, phase)
            assert p_final.tolist() == [s.predict() for s in scalars]
            y = [(lane[j] >> (7 - phase)) & 1 for lane in lanes]
            st = bp.update(st, p, y, phase)
            for s, b in zip(scalars, y):
                s.update(b)


def test_batched_coders_on_card(card):
    """BatchedEncoder / BatchedDecoder at -m4 through the CM kernels: the
    host engine's coded segments, decoded back to the payloads."""
    ref, _ = ref_make_model("4")
    model = convert.model_from_reference_header(ref.header_bytes())
    rng = np.random.default_rng(45)
    raws = [b"lane %d " % k + rng.integers(97, 105, 3000 + 500 * k,
                                           dtype=np.uint8).tobytes()
            for k in range(3)]
    lanes = [b"\x00" + r for r in raws]
    rows = np.zeros((3, max(map(len, lanes))), np.uint8)
    for i, b in enumerate(lanes):
        rows[i, :len(b)] = np.frombuffer(b, np.uint8)
    before = (cme.launches, cmd.launches)
    out, cnt = BatchedEncoder(model).encode(rows, [len(b) for b in lanes])
    coded = _coded(ref, raws)
    assert [bytes(out[i, :cnt[i]]) for i in range(3)] == [c[:-6]
                                                         for c in coded]
    crow = np.zeros((3, max(map(len, coded))), np.uint8)
    for i, c in enumerate(coded):
        crow[i, :len(c)] = np.frombuffer(c, np.uint8)
    dec, lens = BatchedDecoder(model).decode(crow,
                                             max(map(len, lanes)) + 8)
    assert [bytes(dec[i, :lens[i]]) for i in range(3)] == lanes
    assert (cme.launches, cmd.launches) == (before[0] + 1, before[1] + 1)


# ---------------------------------------------------------------------------
# exact allocation bounds (experiments/sanitize.py)


@pytest.fixture(scope="module")
def sanitize_record(tmp_path_factory):
    """The exact-bounds matrix recorded on the card once for the module:
    (directory, symbol -> cases)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    root = tmp_path_factory.mktemp("sanitize")
    return root, sz.record(root, log=lambda m: None)


@pytest.mark.parametrize("symbol", sorted(sz.launch_symbols()))
def test_exact_bounds_guard_replay(card, sanitize_record, symbol):
    """Every recorded launch of ``symbol`` replayed in a process that
    never imports torch, each buffer exactly its tensor's bytes against an
    unmapped granule after its end, then before its start: no fault, and
    every tensor byte-equal to the normal launch's."""
    root, counts = sanitize_record
    rc, _, _, text = sz.run_replay(root, ("end", "start"), only=(symbol,),
                                   timeout=600)
    assert rc == 0, sz.tail(text, 30)
    lines = [ln for ln in text.splitlines()
             if ln.startswith("replay [guard") and f"] {symbol}:" in ln]
    assert len(lines) == 2, text
    assert all(f" {counts[symbol]} cases," in ln for ln in lines), lines


def test_guard_replay_catches_the_controls(card, tmp_path):
    """The guard passes fault on a kernel that writes one byte past its
    buffer's end and one byte before its start."""
    lib = tmp_path / "libcontrols.so"
    sz.nvcc(sz.CONTROLS_CU, lib, shared=True)
    sz.control_records(tmp_path, str(lib))
    for name, where in (("overrun", "end"), ("underrun", "start")):
        rc, _, _, text = sz.run_replay(tmp_path / name, (where,), timeout=120)
        assert rc != 0 and "faulted" in text, (name, sz.tail(text))
    # a plain allocation of 48 bytes does not fault on the 49th
    rc, _, _, text = sz.run_replay(tmp_path / "overrun", (), timeout=120)
    assert rc == 0, sz.tail(text)
