"""The exact-bounds harness of the port's CUDA kernels
(``zpaqfranz_tpu_torch/experiments/sanitize.py``) on the CPU: its catalog
of C entry points against the sources, a recorded launch through its
on-disk form, the guard placement and a replay on a fake driver whose
unmapped bytes fault, and the matrix's hash and CRC-32 cases through the
plain versions against hashlib, zlib and the reference's
``ops/hash_batched.py``. The replay on the card is in
``tests/test_torch_card.py``."""

import hashlib
import pathlib
import re
import subprocess
import sys
import zlib

import numpy as np
import pytest
import torch

from zpaqfranz_tpu.ops import hash_batched as ref_hb

from zpaqfranz_tpu_torch.experiments import sanitize as sz
from zpaqfranz_tpu_torch.ops import build

ROOT = pathlib.Path(__file__).resolve().parent.parent
GRANULE = 1 << 21


# ---------------------------------------------------------------------------
# (a) the catalog


def test_catalog_holds_every_launch_symbol_of_the_sources():
    got = sz.launch_symbols()
    for path in sorted(sz.CSRC.glob("*.cu")):
        names = set(re.findall(r"\b(\w+_launch)\b", path.read_text()))
        assert names == {k for k, v in got.items() if v == path.name}, path
    # the three names MB_COLUMN_ENTRY makes
    assert {"mb_gather_launch", "mb_onehot_launch",
            "mb_selwrite_launch"} <= set(got)
    assert len(got) == 15
    assert set(build.SOURCES.values()) == set(got.values())


def test_every_symbol_has_a_case():
    """The matrix names its cases before anything runs on a device: build
    them for the CPU and count them by symbol."""
    cases = sz.matrix(torch, torch.device("cpu"))
    by = {}
    for c in cases:
        by.setdefault(c.symbol, []).append(c.name)
    assert set(by) == set(sz.launch_symbols())
    assert len({c.name for c in cases}) == len(cases)
    assert len(by["cm_encode_launch"]) == 4 * 2 * 5 + 2
    assert len(by["cm_decode_launch"]) == 4 * 2 * 6 + 2
    assert len(by["sha1_lanes_launch"]) == len(by["sha256_lanes_launch"]) \
        == 35
    assert len(by["crc32_lanes_launch"]) == 40


# ---------------------------------------------------------------------------
# (b) a recorded launch and its on-disk form


class _Launch:
    """A launch on CPU tensors: out = data + 1, count[0] += 1."""

    def __init__(self, data, out, count):
        self.data, self.out, self.count = data, out, count

    def __call__(self):
        self.out.copy_(self.data + 1)
        self.count[0] += 1
        return 0


def _record(tmp_path, monkeypatch, hints_of):
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(build, "build",
                        lambda units: {build.unit_key(u): tmp_path / "lib.so"
                                       for u in units})
    storage = torch.arange(64, dtype=torch.uint8)
    data = storage[5:42]                       # 5 bytes past a boundary
    out = torch.empty(37, dtype=torch.uint8)
    count = torch.zeros(2, dtype=torch.int64)
    rec = sz.Recorder(tmp_path / "rec")
    rec.case = "a case"
    args = (data, 7, out, count, -3)
    rc = rec("unit", "x_launch", args, hints_of(data, out, count),
             _Launch(data, out, count))
    assert rc == 0
    [path] = sz.launch_files(tmp_path / "rec")
    return sz.Launch.load(path), storage


def test_a_recorded_launch_round_trips(tmp_path, monkeypatch):
    got, storage = _record(tmp_path, monkeypatch, lambda d, o, c: {
        "written": (o,), "align": ((d, 1024),), "varies": ((c, 8, 16),),
        "relocate": ((c, d),)})
    assert (got.case, got.unit, got.symbol) == ("a case", "unit", "x_launch")
    assert got.library == str(tmp_path / "lib.so")
    data, seven, out, count, minus = got.args
    assert (seven.tensor, seven.value, minus.value) == (False, 7, -3)
    assert (data.dtype, data.shape, data.head, data.written) == \
        ("uint8", (37,), storage[5:42].data_ptr() % 16, False)
    assert data.align == 1024 and data.pre == storage[5:42].data_ptr() % 1024
    assert data.head == 5 if storage.data_ptr() % 16 == 0 else True
    assert np.array_equal(data.before, storage[5 - data.head:42].numpy())
    assert np.array_equal(data.after, data.before)
    assert out.written and out.before is None and out.align == 16
    assert np.array_equal(out.after, np.arange(5, 42, dtype=np.uint8) + 1)
    assert (count.dtype, count.shape, count.varies, count.points_to) == \
        ("int64", (2,), [(8, 16)], 0)
    assert np.array_equal(count.after.view(np.int64), [1, 0])
    assert data.points_to == -1 and not data.null
    assert data.ptr == storage[5:42].data_ptr()


def test_a_write_only_output_is_filled_before_the_launch(tmp_path,
                                                         monkeypatch):
    seen = {}

    class Peek(_Launch):
        def __call__(self):
            seen["out"] = self.out.clone()
            return super().__call__()

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(build, "build",
                        lambda units: {build.unit_key(u): tmp_path / "l.so"
                                       for u in units})
    data = torch.zeros(8, dtype=torch.uint8)
    out = torch.empty(8, dtype=torch.uint8)
    rec = sz.Recorder(tmp_path)
    rec("u", "y_launch", (data, out), {"written": (out,)},
        Peek(data, out, torch.zeros(2, dtype=torch.int64)))
    assert torch.equal(seen["out"], torch.full((8,), sz.SENTINEL,
                                               dtype=torch.uint8))


def test_equal_rows_are_recorded_once_and_replayed_whole(tmp_path,
                                                        monkeypatch):
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(build, "build",
                        lambda units: {build.unit_key(u): tmp_path / "l.so"
                                       for u in units})
    row = torch.arange(sz.TILE_BYTES // 4, dtype=torch.int32) * 7
    state = row.expand(4, -1).contiguous()
    other = torch.zeros(8, dtype=torch.uint8)
    rec = sz.Recorder(tmp_path / "rec")
    rec("u", "t_launch", (state, other), {}, lambda: 0)
    [path] = sz.launch_files(tmp_path / "rec")
    got = sz.Launch.load(path)
    tiled, plain = got.args
    assert tiled.rows == 4 and tiled.before.nbytes == sz.TILE_BYTES
    assert np.array_equal(tiled.before.view(np.int32), row.numpy())
    assert plain.rows == 0                    # under TILE_BYTES
    drv = FakeDriver()
    assert sz.replay_one(drv, lambda *a: 0, got, "end") < 16   # no mismatch


def test_the_smoke_tool_cases_are_matrix_cases():
    import chip_smoke
    names = {c.name for c in sz.matrix(torch, torch.device("cpu"))}
    assert set(chip_smoke.SAN_TOOL_CASES) <= names


def test_overlapping_and_strided_tensors_are_refused(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    t = torch.zeros(64, dtype=torch.uint8)
    rec = sz.Recorder(tmp_path)
    with pytest.raises(ValueError, match="overlap"):
        rec("u", "z_launch", (t[:40], t[32:]), {}, lambda: 0)
    with pytest.raises(ValueError, match="contiguous"):
        rec("u", "z_launch", (t[::2],), {}, lambda: 0)


def test_build_call_refuses_an_unknown_hint():
    with pytest.raises(TypeError, match="unknown launch hints"):
        build.call("sha1_lanes", "sha1_lanes_launch", torch.device("cpu"),
                   writen=())


# ---------------------------------------------------------------------------
# (c) the guard layout, and a replay on a fake driver


class FakeDriver:
    """Device memory as host bytes: allocations and mapped granules are
    readable; any other byte faults (``sz.CudaError``)."""

    granule = GRANULE

    def __init__(self):
        self.next = 1 << 32
        self.ranges = {}          # start -> bytearray
        self.reserved = []

    def _take(self, size, align):
        base = -(-self.next // align) * align
        self.next = base + size + self.granule    # a gap between them
        return base

    def alloc(self, n):
        base = self._take(n, 256)
        self.ranges[base] = bytearray(n)
        return base

    def free(self, ptr):
        del self.ranges[ptr]

    def reserve(self, size):
        base = self._take(size, self.granule)
        self.reserved.append((base, size))
        return base

    def map(self, ptr, size):
        assert ptr % self.granule == 0 and size % self.granule == 0
        self.ranges[ptr] = bytearray(size)
        return ptr

    def unmap(self, ptr, size, handle):
        del self.ranges[ptr]

    def release(self, ptr, size):
        self.reserved.remove((ptr, size))

    def _at(self, ptr, n):
        for base, mem in self.ranges.items():
            if base <= ptr and ptr + n <= base + len(mem):
                return mem, ptr - base
        raise sz.CudaError(f"fault at {ptr:#x} (+{n})")

    def put(self, ptr, data):
        mem, o = self._at(ptr, data.size)
        mem[o:o + data.size] = data.tobytes()

    def get(self, ptr, n):
        mem, o = self._at(ptr, n)
        return np.frombuffer(bytes(mem[o:o + n]), np.uint8).copy()

    def fill(self, ptr, value, n):
        mem, o = self._at(ptr, n)
        mem[o:o + n] = bytes([value]) * n

    def sync(self):
        pass

    def mapped(self, ptr):
        try:
            self._at(ptr, 1)
            return True
        except sz.CudaError:
            return False


@pytest.mark.parametrize("n", [0, 1, 15, 16, 17, GRANULE + 1])
@pytest.mark.parametrize("align", [16, 1024])
def test_guard_layout(n, align):
    drv = FakeDriver()
    end = sz.Buffer(drv, n, 0, align, "end")
    last = end.ptr + n                 # one past the tensor
    assert end.ptr % align == 0 and 0 <= end.slack < align
    assert not drv.mapped(last + end.slack)
    assert all(drv.mapped(end.ptr + k) for k in (0, n - 1) if n)
    start = sz.Buffer(drv, n, 0, align, "start")
    assert start.ptr % GRANULE == 0 and not drv.mapped(start.ptr - 1)
    assert n == 0 or drv.mapped(start.ptr + n - 1)
    plain = sz.Buffer(drv, n, 0, align, None)
    assert plain.ptr % align == 0
    assert plain.slack == (1 if n == 0 else 0) or align > 256
    for b in (end, start, plain):
        b.close()
    assert drv.ranges == {} and drv.reserved == []


@pytest.mark.parametrize("pre", [0, 5, 15])
def test_guard_layout_keeps_the_address_modulo_its_alignment(pre):
    drv = FakeDriver()
    for where in ("end", "start", None):
        b = sz.Buffer(drv, 40, pre, 16, where)
        assert b.ptr % 16 == pre and drv.mapped(b.ptr - pre)
        if where == "end":
            assert b.slack < 16 and not drv.mapped(b.ptr + 40 + b.slack)
        if where == "start":
            assert not drv.mapped(b.ptr - pre - 1)


def _touch_record(n, lo, hi, pre=0):
    """A recorded launch of a kernel that adds 1 to p[lo:hi] of an n-byte
    buffer, and the fake kernel."""
    before = np.arange(n, dtype=np.uint8)
    after = before.copy()
    after[max(lo, 0):min(hi, n)] += 1
    arg = sz.Arg(tensor=True, dtype="uint8", shape=(n,), pre=pre,
                 head=pre, ptr=(1 << 40) + pre,
                 before=np.concatenate([np.zeros(pre, np.uint8), before]),
                 after=np.concatenate([np.zeros(pre, np.uint8), after]))
    rec = sz.Launch("touch", "u", "touch_launch", "lib.so",
                    [arg, sz.Arg(value=lo), sz.Arg(value=hi)])
    return rec


def _touch(drv):
    def fn(p, lo, hi, stream):
        for i in range(lo, hi):
            b = drv.get(p + i, 1)
            drv.put(p + i, b + 1)
        return 0
    return fn


@pytest.mark.parametrize("where", ["end", "start", None])
def test_a_replay_within_bounds_passes(where):
    drv = FakeDriver()
    rec = _touch_record(48, 0, 48)
    slack = sz.replay_one(drv, _touch(drv), rec, where)
    assert slack > 0 if where == "start" else slack == 0
    assert drv.ranges == {}


def test_the_guard_passes_catch_an_overrun_and_an_underrun():
    drv = FakeDriver()
    with pytest.raises(sz.CudaError):
        sz.replay_one(drv, _touch(drv), _touch_record(48, 0, 49), "end")
    with pytest.raises(sz.CudaError):
        sz.replay_one(drv, _touch(drv), _touch_record(48, -1, 48), "start")


def test_a_replay_catches_a_byte_the_kernel_did_not_write():
    drv = FakeDriver()
    rec = _touch_record(16, 0, 16)
    rec.args[0].written = True
    rec.args[0].before = None
    rec.args[0].after = np.full(16, 7, np.uint8)

    def writes_all_but_one(p, lo, hi, stream):
        drv.put(p, np.full(15, 7, np.uint8))
        return 0
    with pytest.raises(sz.ReplayError, match="differs from the recording at "
                                             "byte 15"):
        sz.replay_one(drv, writes_all_but_one, rec, "end")


def test_addresses_move_with_their_buffer():
    words = np.array([0, 1000, 1010, 1040, 5], np.uint64).view(np.uint8)
    got = sz.relocated(words, 0, 1000, 1040, 24).view(np.uint64)
    assert got.tolist() == [0, 1024, 1034, 1064, 5]
    head = np.concatenate([np.full(3, 9, np.uint8), words])
    got = sz.relocated(head, 3, 1000, 1040, -8)
    assert got[:3].tolist() == [9, 9, 9]
    assert got[3:].view(np.uint64).tolist() == [0, 992, 1002, 1032, 5]


def test_tool_summaries_are_counted():
    assert sz.tool_errors("========= ERROR SUMMARY: 0 errors") == 0
    assert sz.tool_errors("========= ERROR SUMMARY: 3 errors\n") == 3
    assert sz.tool_errors("========= RACECHECK SUMMARY: 2 hazards "
                          "displayed (1 error, 1 warning)") == 1
    assert sz.tool_errors("no summary") == 0


def test_the_replay_process_never_imports_torch():
    code = ("import sys; import zpaqfranz_tpu_torch.experiments.sanitize "
            "as s; s.launch_symbols(); s.Launch; "
            "print('torch' in sys.modules, 'jax' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, text=True,
                         capture_output=True, check=True).stdout
    assert out.split() == ["False", "False"]


# ---------------------------------------------------------------------------
# (d) the matrix's hash and CRC-32 cases through the plain versions


def _cpu_cases(prefix):
    return [c for c in sz.matrix(torch, torch.device("cpu"))
            if c.symbol.startswith(prefix)]


@pytest.mark.parametrize("algo", ["sha1", "sha256"])
def test_hash_cases_hold_on_the_plain_versions(algo):
    cases = _cpu_cases(algo)
    assert len(cases) == 35
    for c in cases:
        c.run()                 # against hashlib


def test_crc_cases_hold_on_the_plain_version():
    cases = _cpu_cases("crc32")
    assert len(cases) == 40
    for c in cases:
        if "1 MiB" not in c.name and "64 lanes" not in c.name:
            c.run()             # against zlib; the long ones below


def test_long_crc_cases_hold_on_the_plain_version():
    for c in _cpu_cases("crc32"):
        if "1 MiB" in c.name or "64 lanes" in c.name:
            c.run()


@pytest.mark.parametrize("algo", ["sha1", "sha256", "crc32"])
def test_edge_lengths_agree_with_the_reference(algo):
    rng = np.random.default_rng(4)
    edges = sz.CRC_EDGES if algo == "crc32" else sz.HASH_EDGES
    chunks = [rng.bytes(n) for n in edges for _ in range(2)]
    data, lens = ref_hb.pad_lanes(chunks)
    want = np.asarray(getattr(ref_hb, f"{algo}_lanes")(data, lens))
    flat = b"".join(chunks)
    for head in range(16):
        t = sz._bytes_on(torch, "cpu", flat, head)
        assert t.data_ptr() % 16 == head
        offs = np.cumsum([len(c) for c in chunks]) - [len(c) for c in chunks]
        off = torch.tensor(offs, dtype=torch.int64)
        length = torch.tensor([len(c) for c in chunks], dtype=torch.int64)
        if algo == "crc32":
            got = [int(x) for x in build_crc(t, off, length)]
            assert got == [int(x) for x in want.astype(np.uint32)]
            assert got == [zlib.crc32(c) for c in chunks]
        else:
            from zpaqfranz_tpu_torch.ops import sha1, sha256
            fn = sha1.sha1_plain if algo == "sha1" else sha256.sha256_plain
            got = fn(t, off, length).view(torch.int32).numpy().view(
                np.uint32)
            assert np.array_equal(got, want)
            assert sha1.to_digests(fn(t, off, length)) == [
                hashlib.new(algo, c).digest() for c in chunks]


def build_crc(t, off, length):
    from zpaqfranz_tpu_torch.ops import hash_batched as hb
    plain = hb.crc32_plain(t, off, length)
    seg = hb.crc32_segmented(t, off, length, 64, t.data_ptr() % 64)
    assert torch.equal(plain, seg)
    return plain.view(torch.int32).numpy().view(np.uint32)
