"""Device bench: the lane ladder of the port's kernels against the host engine.

The one place the port codes many lanes per launch and measures the card's
codec and hash rates. ``LADDER`` holds the stages, cheapest first: the
SHA-1 lane kernel, then CM encode and decode lanes at 8 to 1024 lanes per
launch (up to 30 thread blocks of the CM kernels). Every stage reports the
host engine's rate on the same bytes beside the card's, because the host
engine is the bar the card has to beat, and every codec stage checks that
each lane's coded stream equals the host engine's and decodes back to its
payload.

Stages run in this process, in order. A stage that fails raises, and so
does one that takes longer than ``stage_timeout``; only a spent budget
stops the climb early. (The JAX package ran each stage in a subprocess
behind a readiness probe, because a crashed TPU worker could hang its
client.) Each stage's rates go into the engine gate's record
(``device_policy``), as the JAX package's did: the SHA-1 stage's rate with
the host-to-device copy and the host engine's, each codec stage's card and
host rates at its method and lane count. ``calibrate`` is ``b``'s part:
SHA-1, then -m3, -m4 and -m5 at their own widths at 1 lane and at a wider
lane count, or with ``host_only`` the host engine's side of the same
stages.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import device_policy, native
from ..codec.methods import make_model
from ..device import resolve, seconds
from ..ops import sha1
from . import engine

# (kind, method, lanes, block_bytes), cheapest first: "3" (BWT text level:
# ICM + ISSE, 203,776 state bytes per lane) at 256 and 1024 lanes, "4.0"
# (the 14-component -m4 chain at 1 MiB blocks, 11,269,120 state bytes per
# lane) at 8 and 32 lanes.
LADDER: List[Tuple[str, str, int, int]] = [
    ("hash", "", 0, 0),
    ("codec", "3", 256, 4096),
    ("codec", "4.0", 8, 4096),
    ("codec", "3", 1024, 1024),
    ("codec", "4.0", 32, 4096),
]

#: the hash stage: lanes of HASH_BLOCKS 64-byte blocks (64 MiB in all)
HASH_LANES = 4096
HASH_BLOCKS = 256
#: ``calibrate``: each method at its own block widths (16 MiB blocks), at
#: 1 lane and at CAL_WIDE lanes (fewer where a launch holds fewer), lanes
#: of CAL_LANE_BYTES
CAL_METHODS = ("3", "4", "5")
CAL_WIDE = 64
CAL_LANE_BYTES = 64 << 10
#: what follows a segment's coded bytes: the decoder reads past the last one
SEGMENT_END = b"\x00\x00\x00\x00"
_WORDS = [b"the ", b"of ", b"compression ", b"model ", b"context ",
          b"archive ", b"fragment ", b"entropy ", b"suffix ", b"mix "]


class BenchError(RuntimeError):
    """A stage's result is wrong, or the stage ran past its time limit."""


def _host_best(fn, items: Sequence) -> Tuple[list, float]:
    """``fn`` over ``items`` on the host, one thread per core: the results
    and the best seconds of three passes (host clocks vary more than the
    card's)."""
    best = float("inf")
    with ThreadPoolExecutor(max_workers=os.cpu_count() or 1) as pool:
        for _ in range(3):
            t0 = time.perf_counter()
            res = list(pool.map(fn, items))
            best = min(best, time.perf_counter() - t0)
    return res, best


def _wall(fn, device: torch.device):
    """``(fn(), seconds)`` on the host clock, the device synchronised."""
    t0 = time.perf_counter()
    res = fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return res, time.perf_counter() - t0


def _hash_bytes() -> np.ndarray:
    return np.random.default_rng(0).integers(0, 256, HASH_LANES * HASH_BLOCKS
                                             * 64, dtype=np.uint8)


def _host_sha1(flat: np.ndarray) -> Tuple[bytes, float]:
    """The host engine's digests of the hash stage's lanes of ``flat``
    (``native.sha1_spans``, the SHA-NI loop of its verify path, one
    thread) and the best seconds of three."""
    per_lane = HASH_BLOCKS * 64
    ends = list(range(per_lane, flat.size + 1, per_lane))
    native.sha1_spans(flat, ends[:1])            # load the engine
    host_s = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        spans = native.sha1_spans(flat, ends)
        host_s = min(host_s, time.perf_counter() - t0)
    return spans, host_s


def hash_stage(device: torch.device) -> Dict:
    """SHA-1 of HASH_LANES lanes of HASH_BLOCKS * 64 seeded bytes through
    ``ops/sha1.py``: the rate with the bytes resident on the device, the
    rate with their host-to-device copy, and the host engine's rate on the
    same bytes (``_host_sha1``). The device's digests must equal the host
    engine's."""
    per_lane = HASH_BLOCKS * 64
    flat = _hash_bytes()
    host = torch.from_numpy(flat)
    off = torch.arange(HASH_LANES, dtype=torch.int64, device=device) * per_lane
    length = torch.full((HASH_LANES,), per_lane, dtype=torch.int64,
                        device=device)
    data = host.to(device)
    onchip_s = seconds(sha1.sha1_lanes, data, off, length, reps=3)
    copy_s = min(_wall(lambda: sha1.sha1_lanes(host.to(device), off, length),
                       device)[1] for _ in range(3))
    got = sha1.to_digests(sha1.sha1_lanes(data, off, length))
    spans, host_s = _host_sha1(flat)
    if got != [spans[i:i + 20] for i in range(0, len(spans), 20)]:
        raise BenchError("the SHA-1 lanes differ from the host engine's")
    return {"lanes": HASH_LANES, "bytes": flat.size,
            "sha1_GBps_onchip": flat.size / onchip_s / 1e9,
            "sha1_GBps_with_copy": flat.size / copy_s / 1e9,
            "host_sha1_GBps": flat.size / host_s / 1e9}


def host_hash_stage() -> Dict:
    """The host engine's side of ``hash_stage`` alone."""
    flat = _hash_bytes()
    return {"lanes": HASH_LANES, "bytes": flat.size,
            "host_sha1_GBps": flat.size / _host_sha1(flat)[1] / 1e9}


def ladder_payloads(lanes: int, block: int) -> List[bytes]:
    """The JAX ladder's seeded payloads: ``b"\\x00"`` (no PCOMP) and the
    first ``block - 1`` bytes of each lane's share of a word stream."""
    rng = np.random.default_rng(5)
    idx = rng.integers(0, len(_WORDS), lanes * block // 4).tolist()
    data = b"".join(map(_WORDS.__getitem__, idx))[: lanes * block]
    return [b"\x00" + data[i * block:(i + 1) * block][: block - 1]
            for i in range(lanes)]


def _host_codec(model, payloads: Sequence[bytes]
                ) -> Tuple[List[bytes], float, float]:
    """The host engine on the payloads (no PCOMP), one block per thread on
    ``min(lanes, cores)`` threads: the framed blocks and the best encode
    and decode seconds of three passes. Raises ``BenchError`` unless it
    restores the payloads."""
    plain = dataclasses.replace(model, pcomp=None)
    blocks, enc_s = _host_best(
        lambda p: native.compress_block(plain, p[1:], b"b", b""), payloads)

    def host_decode(blk: bytes) -> bytes:
        with native.NativeStream(blk) as s:
            return b"".join(seg.data for seg in s.read_block())

    back, dec_s = _host_best(host_decode, blocks)
    if back != [p[1:] for p in payloads]:
        raise BenchError(f"{len(payloads)} lanes: the host engine does not "
                         f"restore the payloads")
    return blocks, enc_s, dec_s


def host_codec_stage(method: str, lanes: int, block: int) -> Dict:
    """The host engine's side of ``codec_stage`` alone."""
    payloads = ladder_payloads(lanes, block)
    tot = sum(map(len, payloads))
    _, enc_s, dec_s = _host_codec(make_model(method)[0], payloads)
    return {"method": method, "lanes": lanes, "block_bytes": block,
            "host_encode_MBps": tot / enc_s / 1e6,
            "host_decode_MBps": tot / dec_s / 1e6,
            "host_threads": min(lanes, os.cpu_count() or 1)}


#: bytes of the first lane that warm a stage's kernels before it is timed
WARM_BYTES = 1024


def codec_stage(method: str, lanes: int, block: int, device: torch.device
                ) -> Dict:
    """Code ``lanes`` payloads of ``block`` bytes at ``method`` as lanes of
    one CM encode launch, then decode them as lanes of one decode launch,
    each timed after a warm-up launch of the first lane's first
    ``WARM_BYTES``; then the host engine does the same (``_host_codec``).
    Raises ``BenchError`` unless every lane's coded stream equals the host
    engine's and decodes back to its payload."""
    model, _ = make_model(method)
    payloads = ladder_payloads(lanes, block)
    tot = sum(map(len, payloads))

    warm = [payloads[0][:WARM_BYTES]]
    coded, first_s = _wall(lambda: engine.encode_streams(model, warm,
                                                         device), device)
    engine.decode_streams(model, [c + SEGMENT_END for c in coded],
                          list(map(len, warm)), device)
    coded, enc_s = _wall(lambda: engine.encode_streams(model, payloads,
                                                       device), device)
    streams = [c + SEGMENT_END for c in coded]
    caps = list(map(len, payloads))
    back, dec_s = _wall(lambda: engine.decode_streams(model, streams, caps,
                                                      device), device)
    if back != payloads:
        raise BenchError(f"{method} x{lanes}: the decoded lanes differ from "
                         f"their payloads")

    blocks, host_enc_s, host_dec_s = _host_codec(model, payloads)
    host_coded = [engine.parse_block_payload(b, 0)[2][:-6] for b in blocks]
    bad = [i for i, (a, b) in enumerate(zip(coded, host_coded)) if a != b]
    if bad:
        raise BenchError(f"{method} x{lanes}: lanes {bad[:8]} differ from the "
                         f"host engine's coded streams")
    return {"method": method, "lanes": lanes, "block_bytes": block,
            "first_s": first_s,
            "encode_MBps": tot / enc_s / 1e6,
            "decode_MBps": tot / dec_s / 1e6,
            "aggregate_MBps": tot / enc_s / 1e6 + tot / dec_s / 1e6,
            "us_per_byte_per_lane_dec": dec_s / tot * 1e6,
            "lane_KBps_enc": block / enc_s / 1e3,
            "lane_KBps_dec": block / dec_s / 1e3,
            "host_encode_MBps": tot / host_enc_s / 1e6,
            "host_decode_MBps": tot / host_dec_s / 1e6,
            "host_threads": min(lanes, os.cpu_count() or 1), "ok": True}


def record_stage(res: Dict, card: str) -> None:
    """Write a stage's rates (MB/s) into the engine gate's record of
    ``card`` (``device_policy``): the SHA-1 stage's as the flat hash pair
    (the card's with the host-to-device copy, which ``t`` and ``sum``
    pay), a codec stage's as its method's entry at its lane count, each
    side the lower of encode and decode. A host-only stage writes the host
    engine's side alone."""
    if "method" not in res:
        rates = {"hash_host_MBps": res["host_sha1_GBps"] * 1e3}
        if "sha1_GBps_with_copy" in res:
            rates["hash_device_MBps"] = res["sha1_GBps_with_copy"] * 1e3
        device_policy.record(card, **rates)
        return
    values = {"host_MBps": min(res["host_encode_MBps"],
                               res["host_decode_MBps"]),
              "lane_bytes": res["block_bytes"],
              "host_threads": res["host_threads"]}
    if "encode_MBps" in res:
        values["device_MBps"] = min(res["encode_MBps"], res["decode_MBps"])
    device_policy.record_lanes(res["method"], res["lanes"], card, **values)


def run_ladder(budget_s: float = 600.0, stage_timeout: float = 300.0,
               ladder: Optional[List[Tuple[str, str, int, int]]] = None,
               device=None, record_calibration: bool = True,
               host_only: bool = False) -> Dict:
    """Run the stages of ``ladder`` (default ``LADDER``) in order on
    ``device`` (None = the card, which must be present; "cpu" = the plain
    versions), or with ``host_only`` the host engine's side of each alone;
    returns {stage name: result}. Before each stage, less than 30 s of
    ``budget_s`` left stops the climb (``"stopped"``); a stage that fails
    or takes longer than ``stage_timeout`` raises. With
    ``record_calibration`` each stage that ran on a card, or on the host
    engine alone, goes into the engine gate's record of that card
    (``record_stage``); the plain versions' rates are never recorded."""
    dev = None if host_only else resolve(device)
    card = None
    if record_calibration and (host_only or dev.type == "cuda"):
        card = device_policy.this_card(dev)
    out: Dict = {}
    t0 = time.perf_counter()
    for kind, method, lanes, block in (LADDER if ladder is None else ladder):
        if budget_s - (time.perf_counter() - t0) < 30:
            out["stopped"] = "budget exhausted"
            break
        name = "sha1_lanes" if kind == "hash" else f"cm_{method}_L{lanes}"
        s0 = time.perf_counter()
        if host_only:
            res = (host_hash_stage() if kind == "hash"
                   else host_codec_stage(method, lanes, block))
        elif kind == "hash":
            res = hash_stage(dev)
        else:
            res = codec_stage(method, lanes, block, dev)
        res["seconds"] = time.perf_counter() - s0
        if res["seconds"] > stage_timeout:
            raise BenchError(f"{name} took {res['seconds']:.1f} s, over its "
                             f"{stage_timeout:.0f} s")
        out[name] = res
        if card is not None:
            record_stage(res, card)
    return out


def calibration_ladder(device: Optional[torch.device]
                       ) -> List[Tuple[str, str, int, int]]:
    """``calibrate``'s stages: SHA-1, then each of ``CAL_METHODS`` at 1
    lane and at ``CAL_WIDE`` lanes of ``CAL_LANE_BYTES``, or as many as one
    launch holds on ``device`` where it is a card."""
    out = [LADDER[0]]
    for method in CAL_METHODS:
        wide = CAL_WIDE
        if device is not None and device.type == "cuda":
            model = make_model(method)[0]
            wide = min(wide, engine.lanes_per_launch(
                model, engine.encode_lane_io(model, CAL_LANE_BYTES), device))
        out += [("codec", method, n, CAL_LANE_BYTES)
                for n in sorted({1, wide})]
    return out


def calibrate(device=None, host_only: bool = False,
              budget_s: float = 600.0) -> Dict:
    """``b``'s part: ``calibration_ladder`` on the card beside the host
    engine, or with ``host_only`` the host engine's side alone, every stage
    recorded (``run_ladder``); then the flat codec pair from the widest -m3
    stage, both sides on its payloads. Returns the stages' results."""
    dev = None if host_only else resolve(device)
    if dev is not None and dev.type == "cuda":
        # every unit the stages launch, built in parallel up front
        from ..ops import build
        from ..ops.cm_model import kernel_unit
        build.build(["sha1_lanes"] + [
            kernel_unit(kernel, make_model(m)[0])
            for m in CAL_METHODS for kernel in ("cm_decode", "cm_encode")])
    res = run_ladder(budget_s=budget_s, stage_timeout=180.0,
                     ladder=calibration_ladder(dev), device=dev,
                     host_only=host_only)
    m3 = [st for st in res.values()
          if isinstance(st, dict) and st.get("method") == "3"]
    if m3 and (host_only or dev.type == "cuda"):
        wide = max(m3, key=lambda st: st["lanes"])
        rates = {"codec_host_MBps": min(wide["host_encode_MBps"],
                                        wide["host_decode_MBps"])}
        if not host_only:
            rates["codec_device_MBps"] = min(wide["encode_MBps"],
                                             wide["decode_MBps"])
        device_policy.record(device_policy.this_card(dev), **rates)
    return res


def stage_line(name: str, result) -> str:
    """One printed line per stage: ``  name: key=value, ...``."""
    if isinstance(result, dict):
        result = ", ".join(f"{k}={v:.6g}" if isinstance(v, float)
                           else f"{k}={v}" for k, v in result.items())
    return f"  {name}: {result}"


def _stage(spec: str) -> Tuple[str, str, int, int]:
    if spec == "hash":
        return LADDER[0]
    method, lanes, block = spec.split(":")
    return ("codec", method, int(lanes), int(block))


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m zpaqfranz_tpu_torch.parallel.device_bench",
        description="Run the lane ladder on the card beside the host "
                    "engine; one line per stage. Each stage run on a card "
                    "goes into the engine gate's record "
                    f"(${device_policy.CAL_ENV}).")
    ap.add_argument("stages", nargs="*", type=_stage,
                    help="'hash' or METHOD:LANES:BLOCK codec stages "
                         "(default: the whole LADDER)")
    ap.add_argument("--device", default=None,
                    help="'cpu' for the plain versions; default: the card")
    ap.add_argument("--budget", type=float, default=600.0,
                    help="seconds after which no further stage starts")
    ap.add_argument("--no-record", action="store_true",
                    help="leave the engine gate's record as it is")
    args = ap.parse_args(argv)
    res = run_ladder(budget_s=args.budget, ladder=args.stages or None,
                     device=args.device,
                     record_calibration=not args.no_record)
    for name, st in res.items():
        print(stage_line(name, st), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
