"""The port's engine gate (``zpaqfranz_tpu_torch/device_policy.py``) on the
CPU: the JAX package's cases of ``tests/test_device_policy.py`` in the
port's terms (no record means the card), the per-lane rule, another
card's record, the stderr line, the records ``b`` and the ladder write,
the gate reached from ``add``, ``extract``, ``verify_archive`` and the CLI,
and the same decision as the JAX package's ``auto_device`` on every flat
record with both rates. Every test points the record at its own
``tmp_path``."""

import json

import pytest
import torch
from hypothesis import given, settings, strategies as st

from zpaqfranz_tpu import device_policy as ref_dp

import zpaqfranz_tpu_torch.jidac.add as add_mod
from zpaqfranz_tpu_torch import cli
from zpaqfranz_tpu_torch import device_policy as dp
from zpaqfranz_tpu_torch.jidac.add import add
from zpaqfranz_tpu_torch.jidac.extract import extract, verify_archive
from zpaqfranz_tpu_torch.jidac.index import read_archive
from zpaqfranz_tpu_torch.ops import cm_decode as cmd, cm_encode as cme, sha1
from zpaqfranz_tpu_torch.parallel import device_bench as db

DATE = 20260102030405
CARD = "Test Card 80GB"


@pytest.fixture
def cal_file(tmp_path, monkeypatch):
    """The record at ``tmp_path/cal.json``, of a card named ``CARD``."""
    p = tmp_path / "cal.json"
    monkeypatch.setenv(dp.CAL_ENV, str(p))
    monkeypatch.setattr(dp, "this_card", lambda device=None: CARD)
    return p


def _lanes(method, **entries):
    """Per-lane entries {lanes: (card MB/s, host MB/s)} of ``method``."""
    for lanes, (dev, host) in entries.items():
        dp.record_lanes(method, int(lanes.lstrip("L")), device_MBps=dev,
                        host_MBps=host, lane_bytes=4096)


def test_record_creates_and_merges(cal_file):
    dp.record(codec_host_MBps=2.0)
    dp.record(codec_device_MBps=5.0)
    dp.record_lanes("4", 8, device_MBps=1.5, host_MBps=3.0, lane_bytes=64)
    cal = json.loads(cal_file.read_text())
    assert cal["codec_host_MBps"] == 2.0
    assert cal["codec_device_MBps"] == 5.0
    assert cal["card"] == CARD and "ts" in cal
    assert cal["methods"] == {"4": {"8": {"device_MBps": 1.5,
                                          "host_MBps": 3.0,
                                          "lane_bytes": 64}}}
    # an entry measured on other payloads is replaced, not merged
    dp.record_lanes("4", 8, host_MBps=2.5, lane_bytes=128)
    assert dp.load_calibration()["methods"]["4"]["8"] == {
        "host_MBps": 2.5, "lane_bytes": 128}
    assert not list(cal_file.parent.glob(".device_cal.*"))   # atomic write


def test_gate_requires_both_rates(cal_file):
    # no record: the card (the JAX package's gate takes the host here)
    assert dp.auto_device("codec")
    dp.record(codec_host_MBps=2.0)
    assert dp.auto_device("codec", est_bytes=2 << 20)   # no card rate: card
    dp.record(codec_device_MBps=2.0)
    assert not dp.auto_device("codec", est_bytes=2 << 20)
    dp.record(codec_device_MBps=5.0)
    assert dp.auto_device("codec", est_bytes=2 << 20)


def test_gate_needs_margin_and_size(cal_file):
    dp.record(codec_host_MBps=2.0, codec_device_MBps=2.1)
    assert not dp.auto_device("codec", est_bytes=2 << 20)   # <1.2x margin
    dp.record(codec_device_MBps=3.0)
    assert dp.auto_device("codec", est_bytes=2 << 20)
    assert not dp.auto_device("codec", est_bytes=1 << 10)   # small job


def test_hash_kind_independent(cal_file):
    dp.record(hash_host_MBps=500.0, hash_device_MBps=80000.0)
    dp.record(codec_host_MBps=9.0, codec_device_MBps=1.0)
    assert dp.auto_device("hash", est_bytes=8 << 20)
    assert not dp.auto_device("codec", est_bytes=8 << 20)


def test_resolve_forced_overrides_gate(cal_file, capsys):
    dp.record(codec_host_MBps=9.0, codec_device_MBps=1.0)
    assert dp.resolve(True, "codec", 8 << 20) is True
    dp.record(codec_host_MBps=1.0, codec_device_MBps=9.0)
    assert dp.resolve(False, "codec", 8 << 20) is False
    assert capsys.readouterr().err == ""         # forced: no gate line


@pytest.mark.parametrize("lanes, card", [
    (1, False),        # below every recorded count but 1: at l = 1
    (8, False),        # between: the largest recorded l <= L, l = 4
    (16, True),        # at a recorded count
    (500, True),       # above all: the largest, l = 256
])
def test_per_lane_rule(cal_file, lanes, card):
    _lanes("3", L1=(0.1, 4.0), L4=(0.4, 12.0), L16=(20.0, 15.0),
           L256=(60.0, 15.0))
    dp.record(codec_host_MBps=1.0, codec_device_MBps=100.0)   # not used
    assert dp.auto_device("codec", 2 << 20, method="3", lanes=lanes) is card


def test_per_lane_rule_smallest_when_all_exceed(cal_file):
    _lanes("4", L8=(1.0, 3.0), L64=(9.0, 3.0))
    assert not dp.auto_device("codec", 2 << 20, method="4", lanes=2)
    # an unrecorded method takes the flat pair
    dp.record(codec_host_MBps=1.0, codec_device_MBps=5.0)
    assert dp.auto_device("codec", 2 << 20, method="5", lanes=2)
    # an entry with one rate does not count as recorded
    dp.record_lanes("5", 1, host_MBps=3.0, lane_bytes=4096)
    assert dp.auto_device("codec", 2 << 20, method="5", lanes=1)


def test_no_record_or_another_cards_record_gives_the_card(cal_file,
                                                          monkeypatch):
    assert dp.decide("codec", 2 << 20, "3", 1).device
    _lanes("3", L1=(0.1, 4.0))
    dp.record(hash_host_MBps=500.0, hash_device_MBps=100.0)
    assert not dp.auto_device("codec", 2 << 20, method="3", lanes=1)
    assert not dp.auto_device("hash", 2 << 20)
    monkeypatch.setattr(dp, "this_card", lambda device=None: "Other Card")
    d = dp.decide("codec", 2 << 20, "3", 1)
    assert d.device and "'Test Card 80GB', not 'Other Card'" in d.why
    assert dp.auto_device("hash", 2 << 20)
    # recording on the other card starts its own record
    dp.record(hash_host_MBps=1.0)
    assert dp.load_calibration() == {"card": "Other Card",
                                     "hash_host_MBps": 1.0,
                                     "ts": dp.load_calibration()["ts"]}


def test_no_modeled_block_takes_the_host(cal_file):
    assert not dp.auto_device("codec", 2 << 20, lanes=0)
    assert dp.auto_device("hash", 2 << 20)


def test_the_reference_record_does_not_steer_the_port(cal_file, tmp_path,
                                                      monkeypatch):
    ref = tmp_path / "ref.json"
    ref.write_text(json.dumps({"codec_device_MBps": 1.0,
                               "codec_host_MBps": 50.0}))
    monkeypatch.setenv("ZPAQFRANZ_DEVICE_CAL", str(ref))
    assert dp.cal_path() == str(cal_file)
    assert dp.auto_device("codec", 2 << 20)


def test_the_record_path_defaults_to_the_cache(monkeypatch, tmp_path):
    monkeypatch.delenv(dp.CAL_ENV, raising=False)
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path))
    assert dp.cal_path() == str(tmp_path / "zpaqfranz_tpu_torch" /
                                "device_cal.json")


def test_unforced_decision_prints_one_stderr_line(cal_file, capsys):
    _lanes("4", L1=(0.06, 1.2))
    assert dp.resolve(None, "codec", 2 << 20, method="4", lanes=1) is False
    err = capsys.readouterr().err.splitlines()
    assert err == [f"zpaqfranz_tpu_torch: engine gate: codec -m4, L=1, "
                   f"2,097,152 bytes: at l=1 recorded lanes the card 0.06 "
                   f"MB/s, the host engine 1.2 MB/s -> host engine (record "
                   f"{cal_file})"]
    assert dp.resolve(None, "hash", 0) is True
    err = capsys.readouterr().err.splitlines()
    assert len(err) == 1 and err[0].endswith("-> card")


def _stub_stages(monkeypatch):
    monkeypatch.setattr(db, "resolve", lambda device=None: torch.device(
        "cuda", 0))
    monkeypatch.setattr(db, "hash_stage", lambda dev: {
        "lanes": 4, "bytes": 256, "sha1_GBps_onchip": 42.0,
        "sha1_GBps_with_copy": 5.1, "host_sha1_GBps": 1.06})

    def codec(method, lanes, block, dev):
        return {"method": method, "lanes": lanes, "block_bytes": block,
                "encode_MBps": 3.5 * lanes, "decode_MBps": 4.0 * lanes,
                "host_encode_MBps": 2.0, "host_decode_MBps": 1.5,
                "host_threads": 1, "ok": True}
    monkeypatch.setattr(db, "codec_stage", codec)


def test_ladder_records_codec_rate(cal_file, monkeypatch):
    """The ladder's record path: each stage updates the record (stage
    execution stubbed, the device a card named ``CARD``: this pins the
    plumbing, not the card)."""
    _stub_stages(monkeypatch)
    out = db.run_ladder(budget_s=60)
    assert out["sha1_lanes"]["sha1_GBps_onchip"] == 42.0
    cal = json.loads(cal_file.read_text())
    assert cal["card"] == CARD
    assert cal["hash_device_MBps"] == 5100.0    # with the copy
    assert cal["hash_host_MBps"] == 1060.0
    assert cal["methods"]["3"]["256"]["device_MBps"] == 3.5 * 256
    assert cal["methods"]["4.0"]["32"] == {
        "device_MBps": 112.0, "host_MBps": 1.5, "lane_bytes": 4096,
        "host_threads": 1}
    assert "codec_device_MBps" not in cal      # only b writes the flat pair
    cal_file.unlink()
    db.run_ladder(budget_s=60, record_calibration=False)
    assert not cal_file.exists()


def test_calibration_records_each_method_and_the_flat_codec_pair(
        cal_file, monkeypatch):
    _stub_stages(monkeypatch)
    monkeypatch.setattr(db.engine, "lanes_per_launch",
                        lambda model, io, dev: 40)
    import zpaqfranz_tpu_torch.ops.build as build
    monkeypatch.setattr(build, "build", lambda units: {})
    res = db.calibrate()
    assert sorted(res) == ["cm_3_L1", "cm_3_L40", "cm_4_L1", "cm_4_L40",
                           "cm_5_L1", "cm_5_L40", "sha1_lanes"]
    cal = dp.load_calibration()
    for m in db.CAL_METHODS:
        assert sorted(cal["methods"][m], key=int) == ["1", "40"]
    # the widest -m3 stage, both sides on its payloads
    assert cal["codec_device_MBps"] == 3.5 * 40
    assert cal["codec_host_MBps"] == 1.5


def test_plain_versions_are_not_recorded(cal_file, monkeypatch):
    monkeypatch.setattr(db, "HASH_LANES", 4)
    monkeypatch.setattr(db, "HASH_BLOCKS", 2)
    db.run_ladder(ladder=[db.LADDER[0], ("codec", "3", 1, 40)],
                  device="cpu")
    assert not cal_file.exists()


def test_b_notpu_records_host_rates_only(cal_file, monkeypatch, capsys):
    monkeypatch.setattr(db, "HASH_LANES", 8)
    monkeypatch.setattr(db, "HASH_BLOCKS", 2)
    monkeypatch.setattr(db, "CAL_LANE_BYTES", 256)
    monkeypatch.setattr(db, "CAL_WIDE", 3)
    before = (sha1.launches, cme.launches, cmd.launches)
    assert cli.main(["b", "-notpu"]) == 0
    assert (sha1.launches, cme.launches, cmd.launches) == before
    cal = json.loads(cal_file.read_text())
    assert cal["card"] == CARD
    assert cal["hash_host_MBps"] > 0 and cal["codec_host_MBps"] > 0
    assert "hash_device_MBps" not in cal and "codec_device_MBps" not in cal
    for m in db.CAL_METHODS:
        for lanes in ("1", "3"):
            e = cal["methods"][m][lanes]
            assert e["host_MBps"] > 0 and "device_MBps" not in e
            assert e["lane_bytes"] == 256
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("sha1 ")
    assert any(line.startswith(f"record {cal_file}") for line in out)
    gates = [line for line in out if line.startswith("  gate codec -m")]
    assert len(gates) == 9 and all(g.endswith("-> card") for g in gates)


@settings(max_examples=200, deadline=None)
@given(dev=st.floats(1e-3, 1e6), host=st.floats(1e-3, 1e6),
       est=st.integers(-1, 1 << 32), kind=st.sampled_from(["codec", "hash"]))
def test_flat_decision_equals_the_reference(tmp_path_factory, dev, host, est,
                                            kind):
    """Both packages read one flat record through their own env vars: on
    every record with both rates they decide alike."""
    path = tmp_path_factory.mktemp("cal") / "cal.json"
    path.write_text(json.dumps({"card": dp.this_card(),
                                f"{kind}_device_MBps": dev,
                                f"{kind}_host_MBps": host}))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv(dp.CAL_ENV, str(path))
        mp.setenv("ZPAQFRANZ_DEVICE_CAL", str(path))
        assert dp.auto_device(kind, est) == ref_dp.auto_device(kind, est)


@pytest.fixture
def gate_tree(tmp_path, monkeypatch, cal_file):
    """A small tree in the working directory, the add's clock pinned, and
    the job floor lowered so that the per-lane rule decides. Where the
    gate takes the card, these tests expect ``NoDeviceError``: the card's
    side is in ``tests/test_torch_card.py``."""
    if torch.cuda.is_available():
        pytest.skip("needs a machine without a CUDA card")
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(add_mod, "now_date", lambda: DATE)
    monkeypatch.setattr(dp, "MIN_JOB_BYTES", 16)
    src = tmp_path / "src"
    src.mkdir()
    (src / "a.txt").write_bytes(b"the gate decides " * 40)
    (src / "b.txt").write_bytes(b"per method and lane count " * 30)
    return src


def test_unforced_add_follows_the_record(gate_tree, tmp_path, capsys):
    _lanes("3", L1=(0.1, 4.0))
    assert cli.main(["a", "h", "src", "-m3", "-notpu"]) == 0
    enc = cme.launches
    assert cli.main(["a", "g", "src", "-m3"]) == 0
    assert cme.launches == enc
    assert (tmp_path / "g.zpaq").read_bytes() == \
        (tmp_path / "h.zpaq").read_bytes()
    err = capsys.readouterr().err
    assert "engine gate: codec -m3, L=1," in err and "-> host engine" in err
    # the card 10x faster: the gate takes the card, absent here
    _lanes("3", L1=(40.0, 4.0))
    assert cli.main(["a", "c", "src", "-m3"]) == 2
    assert not list(tmp_path.glob("c.zpaq*"))
    assert cli.main(["a", "c", "src", "-m3", "-notpu"]) == 0
    # a store method never asks the gate
    assert cli.main(["a", "s", "src", "-m1"]) == 0
    assert "-m1" not in capsys.readouterr().err


def test_unforced_extract_and_verify_follow_the_record(gate_tree, tmp_path,
                                                      monkeypatch):
    add(str(tmp_path / "r.zpaq"), ["src"], method="3", use_device=False,
        date=DATE)
    data = (tmp_path / "r.zpaq").read_bytes()
    jd = read_archive(data)
    _lanes("3", L1=(0.1, 4.0))
    dp.record(hash_host_MBps=1000.0, hash_device_MBps=100.0)
    dec, sha = cmd.launches, sha1.launches
    assert extract(data, jd, str(tmp_path / "out"), use_device=None) == \
        (2, sum(p.stat().st_size for p in gate_tree.iterdir()))
    assert verify_archive(data, jd, use_device=None)[0] == len(jd.block)
    assert (cmd.launches, sha1.launches) == (dec, sha)
    for p in gate_tree.iterdir():
        assert (tmp_path / "out" / "src" / p.name).read_bytes() == \
            p.read_bytes()
    # the extract gate finds the method from the blocks' model
    _lanes("3", L1=(40.0, 4.0))
    with pytest.raises(Exception, match="no CUDA device"):
        extract(data, jd, str(tmp_path / "out2"), use_device=None)
    dp.record(hash_device_MBps=5000.0)
    with pytest.raises(Exception, match="no CUDA device"):
        verify_archive(data, jd, use_device=None)
    # under the job floor t takes the host engine; t -ssd skips the floor
    monkeypatch.setattr(dp, "MIN_JOB_BYTES", 1 << 20)
    assert cli.main(["t", "r"]) == 0
    assert cli.main(["t", "r", "-ssd"]) == 2


def test_unforced_sum_follows_the_hash_rates(gate_tree, capsys):
    dp.record(hash_host_MBps=1000.0, hash_device_MBps=100.0)
    before = sha1.launches
    assert cli.main(["sum", "src", "-sha1"]) == 0
    assert sha1.launches == before
    assert "engine gate: hash" in capsys.readouterr().err
    dp.record(hash_device_MBps=5000.0)
    assert cli.main(["sum", "src", "-sha1"]) == 2
