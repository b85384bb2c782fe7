"""The port's device bench (``zpaqfranz_tpu_torch/parallel/device_bench.py``)
and its ``b`` command against the reference's: the same ladder and
payloads, a codec stage through the plain CM versions (``device="cpu"``)
whose coded lanes equal the reference engine's, and the host line of
``b -notpu``. The engine gate's record goes to each test's ``tmp_path``."""

import dataclasses
import re

import numpy as np
import pytest
import torch

from zpaqfranz_tpu import native as ref_native
from zpaqfranz_tpu.codec.methods import make_model as ref_make_model
from zpaqfranz_tpu.parallel import device_bench as ref_bench
from zpaqfranz_tpu.parallel.engine import parse_block_payload

from zpaqfranz_tpu_torch import cli, device_policy
from zpaqfranz_tpu_torch.ops import cm_decode as cmd, cm_encode as cme, sha1
from zpaqfranz_tpu_torch.parallel import device_bench as db, engine


@pytest.fixture(autouse=True)
def _own_record(tmp_path, monkeypatch):
    monkeypatch.setenv(device_policy.CAL_ENV, str(tmp_path / "cal.json"))


def test_ladder_and_payloads_are_the_reference_ones():
    assert db.LADDER == ref_bench.LADDER
    # the reference child's payloads (device_bench.py:80-87)
    L, BS = 3, 50
    rng = np.random.default_rng(5)
    words = [b"the ", b"of ", b"compression ", b"model ", b"context ",
             b"archive ", b"fragment ", b"entropy ", b"suffix ", b"mix "]
    data = b"".join(words[rng.integers(0, len(words))]
                    for _ in range(L * BS // 4))[: L * BS]
    want = [b"\x00" + data[i * BS:(i + 1) * BS][: BS - 1] for i in range(L)]
    assert db.ladder_payloads(L, BS) == want


def test_codec_stage_round_trips_as_the_reference_engine_codes():
    """-m3, 2 lanes of 100 bytes through the plain CM versions: every lane
    codes as the reference's native engine codes it and decodes back."""
    before = (cme.launches, cmd.launches)
    res = db.run_ladder(ladder=[("codec", "3", 2, 100)], device="cpu")
    st = res["cm_3_L2"]
    assert st["ok"] and st["lanes"] == 2 and st["block_bytes"] == 100
    for key in ("encode_MBps", "decode_MBps", "aggregate_MBps",
                "us_per_byte_per_lane_dec", "host_encode_MBps",
                "host_decode_MBps"):
        assert st[key] > 0
    assert (cme.launches, cmd.launches) == before
    ref, _ = ref_make_model("3")
    plain = dataclasses.replace(ref, pcomp=None)
    pays = db.ladder_payloads(2, 100)
    want = [parse_block_payload(ref_native.compress_block(
        plain, p[1:], b"b", b""), 0)[2][:-6] for p in pays]
    model, _ = db.make_model("3")
    assert engine.encode_streams(model, pays, torch.device("cpu")) == want


def test_a_failing_stage_raises(monkeypatch):
    monkeypatch.setattr(engine, "decode_streams",
                        lambda model, streams, caps, dev: [b"x"] * len(caps))
    with pytest.raises(db.BenchError, match="differ from their payloads"):
        db.run_ladder(ladder=[("codec", "3", 1, 40)], device="cpu")


def test_slow_stage_raises_and_spent_budget_stops(monkeypatch):
    with pytest.raises(db.BenchError, match="over its"):
        db.run_ladder(stage_timeout=0.0, ladder=[("codec", "3", 1, 40)],
                      device="cpu")
    assert db.run_ladder(budget_s=20.0, device="cpu") == {
        "stopped": "budget exhausted"}


def test_hash_stage_matches_the_host_engine(monkeypatch):
    monkeypatch.setattr(db, "HASH_LANES", 6)
    monkeypatch.setattr(db, "HASH_BLOCKS", 2)
    before = sha1.launches
    st = db.run_ladder(ladder=[db.LADDER[0]], device="cpu")["sha1_lanes"]
    assert st["lanes"] == 6 and st["bytes"] == 6 * 128
    assert min(st["sha1_GBps_onchip"], st["sha1_GBps_with_copy"],
               st["host_sha1_GBps"]) > 0
    assert sha1.launches == before


def test_b_prints_the_host_line(capsys, monkeypatch):
    # the engine gate's calibration after it, on the host engine at a
    # small size (tests/test_torch_device_policy.py checks its record)
    monkeypatch.setattr(db, "HASH_LANES", 8)
    monkeypatch.setattr(db, "CAL_LANE_BYTES", 256)
    monkeypatch.setattr(db, "CAL_WIDE", 2)
    assert cli.main(["b", "-notpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[1].startswith("engine gate calibration:")
    assert re.fullmatch(r"sha1 +[\d.]+ MB/s \| lz77 +[\d.]+ MB/s \| "
                        r"cm-encode +[\d.]+ MB/s \| tpu-franzomips \d+",
                        out[0])
    if not torch.cuda.is_available():
        # without -notpu, b runs the ladder's stages on the card: none here
        assert cli.main(["bench"]) == 2
