"""The CM kernels with the generated combine and phases against the
generic ones, on the card: the units' registers and spills, the profiled
phases of one lane, and many lanes in one launch.

For each model it builds both kernels in three variants, each named
``<combine>/<phases>``: the combine (``ops/combine_fast.py``) and phases
(a) and (c) (``ops/phases_fast.py``) generated (``fast/fast``, the
default), the phases generic (``fast/generic``), and both generic
(``generic/generic``), all with the HCOMP program specialised, and prints
each unit's ``ptxas -v`` lines. Then one lane per model through the encode
kernel in each variant: its rate (CUDA events, an unprofiled launch) and
thread 0's clock cycles a bit in each phase (``LaneLaunch(profile=True)``,
``cm_model.PROFILE``), with phases (a) and (c) summed; at the first model
also the decode kernel. Last, ``--lanes`` lanes in one launch of each
kernel at the first model, timed alone. Every launch must code as the host
engine does. One JSON line on stdout, also written to ``--out``.

    python -m zpaqfranz_tpu_torch.experiments.combine_profile \\
        [--models 4.0 5.0 4 5 3 all-components] [--lane-kib 16] \\
        [--lanes 195] [--out build/combine_profile.json]
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

import numpy as np
import torch

from ..codec.methods import ALL_COMPONENTS_CFG, make_model
from ..ops import build, cm_decode as cmd, cm_encode as cme
from ..ops.cm_model import PROFILE, kernel_unit, lanes_to_bytes
from ..parallel.engine import coded_stream, selector
from ..zpaql.compiler import compile_config

#: (combine, phases) of each variant
VARIANTS = (("fast", "fast"), ("fast", "generic"), ("generic", "generic"))


def label(variant) -> str:
    return "/".join(variant)


def payloads(rng, n: int, size: int) -> list:
    """``n`` payloads of ``size`` bytes: a text of skewed words, a stretch
    of noise and the text again."""
    words = [b"the", b"cat", b"sat", b"on", b"mat", b"zpaq", b"lane",
             b"block", b"1234", b"\n", b"context", b"mixing"]
    out = []
    for _ in range(n):
        idx = rng.zipf(1.5, size) % len(words)
        text = b" ".join(words[i] for i in idx)[: size // 2]
        noise = rng.integers(0, 256, size // 8, dtype=np.uint8).tobytes()
        out.append((text + noise + text)[:size])
    return out


def model_of(name: str):
    if name == "all-components":
        return compile_config(ALL_COMPONENTS_CFG)[0]
    return make_model(name)[0]


def ptxas_lines(log: str) -> list:
    return [line.strip() for line in log.splitlines()
            if "registers" in line or "spill" in line]


def timed(launch, model, packed, variant, profile=False):
    """One launch run alone: (lanes' bytes, ms by CUDA events, job)."""
    job = launch(model, *packed, combine=variant[0], phases=variant[1],
                 profile=profile)
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    job.run()
    b.record()
    torch.cuda.synchronize()
    return lanes_to_bytes(*job.result()), a.elapsed_time(b), job


def one_lane(launch, model, packed, want, variant) -> dict:
    """Rate and per-phase cycles a bit of one lane in ``variant``."""
    got, ms, job = timed(launch, model, packed, variant)
    pgot, pms, pjob = timed(launch, model, packed, variant, profile=True)
    if got != want or pgot != want or (job.combine, job.phases) != variant:
        raise SystemExit(f"{launch.kernel} with {label(variant)} differs "
                         f"from the host engine")
    prof = dict(zip(PROFILE, pjob.profile()[0].tolist()))
    bits, nbytes = prof.pop("bits"), prof.pop("bytes")
    total = sum(prof.values())
    return {"ms": ms, "us_per_bit": ms * 1e3 / (8 * nbytes),
            "profiled_ms": pms, "cycles_per_bit": total / bits,
            "phases": {k: v / bits for k, v in prof.items()},
            "a_c_per_bit": (prof["a"] + prof["c"]) / bits,
            "combine_share": prof["combine"] / total}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--models", nargs="+",
                    default=["4.0", "5.0", "4", "5", "3", "all-components"])
    ap.add_argument("--lane-kib", type=int, default=16)
    ap.add_argument("--lanes", type=int, default=195)
    ap.add_argument("--wide-kib", type=int, default=16)
    ap.add_argument("--seed", type=int, default=16)
    ap.add_argument("--out", default="build/combine_profile.json")
    args = ap.parse_args(argv)
    dev = torch.device("cuda")
    rng = np.random.default_rng(args.seed)
    models = {name: model_of(name) for name in args.models}
    out = {"card": torch.cuda.get_device_name(dev), "units": {},
           "one_lane": {}, "wide": {}}

    units = {(name, k, v): kernel_unit(k, model, combine=v[0], phases=v[1])
             for name, model in models.items()
             for k in ("cm_encode", "cm_decode") for v in VARIANTS}
    t0 = time.perf_counter()
    build.build(units.values())
    print(f"built {len(set(map(build.unit_key, units.values())))} units in "
          f"{time.perf_counter() - t0:.1f} s", file=sys.stderr)
    for (name, k, v), unit in units.items():
        rec = build.BUILD_LOG.get(build.unit_key(unit))
        lines = ptxas_lines(str(rec["ptxas"])) if rec else ["(built before)"]
        out["units"][f"{name} {k} {label(v)}"] = {
            "ptxas": lines, "seconds": rec["seconds"] if rec else None}
        print(f"{name} {k} {label(v)}: " + " | ".join(lines),
              file=sys.stderr)

    for j, (name, model) in enumerate(models.items()):
        pay = payloads(rng, 1, args.lane_kib << 10)[0]
        stream = coded_stream(model, pay)
        enc = cme.pack_payloads([selector(model) + pay], dev)
        dec = cmd.pack_streams([stream], [len(pay) + 64], dev)
        kinds = [("encode", cme.Launch, enc, [stream[:-6]])]
        if j == 0:
            kinds.append(("decode", cmd.Launch, dec, [selector(model) + pay]))
        for kind, launch, packed, want in kinds:
            for v in VARIANTS:
                r = one_lane(launch, model, packed, want, v)
                out["one_lane"][f"{name} {kind} {label(v)}"] = r
                print(f"-m{name} {kind}, one lane of {len(pay)} bytes, "
                      f"{label(v)}: {r['us_per_bit']:.3f} us a bit; "
                      f"profiled {r['cycles_per_bit']:.0f} cycles a bit = "
                      + " + ".join(f"{k} {c:.0f}"
                                   for k, c in r["phases"].items())
                      + f" (a + c {r['a_c_per_bit']:.0f}, combine "
                      f"{100 * r['combine_share']:.1f}%)", file=sys.stderr)

    name, model = next(iter(models.items()))
    pays = payloads(rng, args.lanes, args.wide_kib << 10)
    streams = [coded_stream(model, p) for p in pays]
    enc = cme.pack_payloads([selector(model) + p for p in pays], dev)
    dec = cmd.pack_streams(streams, [len(p) + 64 for p in pays], dev)
    for kind, launch, packed, want in (
            ("encode", cme.Launch, enc, [s[:-6] for s in streams]),
            ("decode", cmd.Launch, dec, [selector(model) + p for p in pays])):
        for v in VARIANTS:
            got, ms, job = timed(launch, model, packed, v)
            if got != want:
                raise SystemExit(f"{kind} of {args.lanes} lanes with "
                                 f"{label(v)} differs from the host engine")
            mbps = sum(map(len, pays)) / ms / 1e3
            out["wide"][f"{name} {kind} {label(v)}"] = {"ms": ms,
                                                        "MBps": mbps}
            print(f"-m{name} {kind}, {args.lanes} lanes of "
                  f"{args.wide_kib} KiB, {label(v)}: {ms:.1f} ms, "
                  f"{mbps:.4f} MB/s", file=sys.stderr)
    line = json.dumps(out)
    path = pathlib.Path(args.out)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
