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
client, and recorded its rates for a device gate; the port has no gate.)
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

from .. import native
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


def hash_stage(device: torch.device) -> Dict:
    """SHA-1 of HASH_LANES lanes of HASH_BLOCKS * 64 seeded bytes through
    ``ops/sha1.py``: the rate with the bytes resident on the device, the
    rate with their host-to-device copy, and the host engine's rate on the
    same bytes (``native.sha1_spans``, the SHA-NI loop of its verify path,
    one thread, best of three). The device's digests must equal the host
    engine's."""
    per_lane = HASH_BLOCKS * 64
    flat = np.random.default_rng(0).integers(0, 256, HASH_LANES * per_lane,
                                             dtype=np.uint8)
    host = torch.from_numpy(flat)
    off = torch.arange(HASH_LANES, dtype=torch.int64, device=device) * per_lane
    length = torch.full((HASH_LANES,), per_lane, dtype=torch.int64,
                        device=device)
    data = host.to(device)
    onchip_s = seconds(sha1.sha1_lanes, data, off, length, reps=3)
    copy_s = min(_wall(lambda: sha1.sha1_lanes(host.to(device), off, length),
                       device)[1] for _ in range(3))
    got = sha1.to_digests(sha1.sha1_lanes(data, off, length))
    ends = list(range(per_lane, flat.size + 1, per_lane))
    native.sha1_spans(flat, ends[:1])            # load the engine
    host_s = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        spans = native.sha1_spans(flat, ends)
        host_s = min(host_s, time.perf_counter() - t0)
    if got != [spans[i:i + 20] for i in range(0, len(spans), 20)]:
        raise BenchError("the SHA-1 lanes differ from the host engine's")
    return {"lanes": HASH_LANES, "bytes": flat.size,
            "sha1_GBps_onchip": flat.size / onchip_s / 1e9,
            "sha1_GBps_with_copy": flat.size / copy_s / 1e9,
            "host_sha1_GBps": flat.size / host_s / 1e9}


def ladder_payloads(lanes: int, block: int) -> List[bytes]:
    """The JAX ladder's seeded payloads: ``b"\\x00"`` (no PCOMP) and the
    first ``block - 1`` bytes of each lane's share of a word stream."""
    rng = np.random.default_rng(5)
    data = b"".join(_WORDS[rng.integers(0, len(_WORDS))]
                    for _ in range(lanes * block // 4))[: lanes * block]
    return [b"\x00" + data[i * block:(i + 1) * block][: block - 1]
            for i in range(lanes)]


def codec_stage(method: str, lanes: int, block: int, device: torch.device
                ) -> Dict:
    """Code ``lanes`` payloads of ``block`` bytes at ``method`` as lanes of
    one CM encode launch, then decode them as lanes of one decode launch,
    each once to warm up and once timed; then the host engine does the same
    on all cores (best of three passes). Raises ``BenchError`` unless every
    lane's coded stream equals the host engine's and decodes back to its
    payload."""
    model, _ = make_model(method)
    payloads = ladder_payloads(lanes, block)
    tot = sum(map(len, payloads))

    coded, first_s = _wall(lambda: engine.encode_streams(model, payloads,
                                                         device), device)
    coded, enc_s = _wall(lambda: engine.encode_streams(model, payloads,
                                                       device), device)
    streams = [c + SEGMENT_END for c in coded]
    caps = list(map(len, payloads))
    engine.decode_streams(model, streams, caps, device)
    back, dec_s = _wall(lambda: engine.decode_streams(model, streams, caps,
                                                      device), device)
    if back != payloads:
        raise BenchError(f"{method} x{lanes}: the decoded lanes differ from "
                         f"their payloads")

    # the host engine on the same bytes, one block per core: the payloads
    # carry no PCOMP
    plain = dataclasses.replace(model, pcomp=None)
    blocks, host_enc_s = _host_best(
        lambda p: native.compress_block(plain, p[1:], b"b", b""), payloads)
    host_coded = [engine.parse_block_payload(b, 0)[2][:-6] for b in blocks]
    bad = [i for i, (a, b) in enumerate(zip(coded, host_coded)) if a != b]
    if bad:
        raise BenchError(f"{method} x{lanes}: lanes {bad[:8]} differ from the "
                         f"host engine's coded streams")

    def host_decode(blk: bytes) -> bytes:
        with native.NativeStream(blk) as s:
            return b"".join(seg.data for seg in s.read_block())

    host_back, host_dec_s = _host_best(host_decode, blocks)
    if host_back != [p[1:] for p in payloads]:
        raise BenchError(f"{method} x{lanes}: the host engine does not "
                         f"restore the payloads")
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
            "host_threads": os.cpu_count() or 1, "ok": True}


def run_ladder(budget_s: float = 600.0, stage_timeout: float = 300.0,
               ladder: Optional[List[Tuple[str, str, int, int]]] = None,
               device=None) -> Dict:
    """Run the stages of ``ladder`` (default ``LADDER``) in order on
    ``device`` (None = the card, which must be present; "cpu" = the plain
    versions); returns {stage name: result}. Before each stage, less than
    30 s of ``budget_s`` left stops the climb (``"stopped"``); a stage that
    fails or takes longer than ``stage_timeout`` raises."""
    dev = resolve(device)
    out: Dict = {}
    t0 = time.perf_counter()
    for kind, method, lanes, block in (LADDER if ladder is None else ladder):
        if budget_s - (time.perf_counter() - t0) < 30:
            out["stopped"] = "budget exhausted"
            break
        name = "sha1_lanes" if kind == "hash" else f"cm_{method}_L{lanes}"
        s0 = time.perf_counter()
        res = (hash_stage(dev) if kind == "hash"
               else codec_stage(method, lanes, block, dev))
        res["seconds"] = time.perf_counter() - s0
        if res["seconds"] > stage_timeout:
            raise BenchError(f"{name} took {res['seconds']:.1f} s, over its "
                             f"{stage_timeout:.0f} s")
        out[name] = res
    return out


def bootstrap_calibration(budget_s: float = 240.0, device=None) -> Dict:
    """The ladder's first two stages (the SHA-1 lanes, -m3 at 256 lanes of
    4 KiB): the device part of ``b``. The JAX package recorded their rates
    for its device gate; the port has no gate and records nothing."""
    return run_ladder(budget_s=budget_s, stage_timeout=180.0,
                      ladder=LADDER[:2], device=device)


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
                    "engine; one line per stage.")
    ap.add_argument("stages", nargs="*", type=_stage,
                    help="'hash' or METHOD:LANES:BLOCK codec stages "
                         "(default: the whole LADDER)")
    ap.add_argument("--device", default=None,
                    help="'cpu' for the plain versions; default: the card")
    ap.add_argument("--budget", type=float, default=600.0,
                    help="seconds after which no further stage starts")
    args = ap.parse_args(argv)
    res = run_ladder(budget_s=args.budget, ladder=args.stages or None,
                     device=args.device)
    for name, st in res.items():
        print(stage_line(name, st), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
