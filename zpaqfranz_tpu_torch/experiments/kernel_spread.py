"""The spread of a microbenchmark kernel's device time over repeated profiles.

The smoke times each microbenchmark kernel of ``mb_access.py`` from one
``torch.profiler`` profile of a few calls: the mean device time of the
kernel records the profile saw. This repeats that measurement many times
in one process, for every shape the scripts time with one kernel, and
prints, per shape, the spread of the profiles' means and of the single
records under them, so that a reading can be told apart from the noise of
the measurement:

    python -m zpaqfranz_tpu_torch.experiments.kernel_spread [--kind gather ...] [--profiles 20] [--reps 5]

Per shape: the median, least and greatest mean over the profiles (the
smoke's number is one such mean), the least and greatest single record,
the records seen against the calls made, and every profile whose mean
lies more than 10% from the median, with its records. The last line is
one JSON object with the same numbers.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
from typing import Optional, Sequence

import torch

from ..device import resolve
from . import mb_access as mb


def profile_records(run, args, kernel: str, reps: int) -> tuple:
    """One profile of ``reps`` calls of ``run(*args)``: the device
    microseconds of each record of ``kernel`` it saw, and the mean that
    its ``key_averages()`` give (the smoke's reading), or None."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            run(*args)
        torch.cuda.synchronize()
    hits = [e for e in prof.key_averages()
            if kernel in e.key and e.device_time_total > 0]
    return ([e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == DeviceType.CUDA and kernel in e.name],
            hits[0].device_time_total / hits[0].count if hits else None)


def spread(kind: str, profiles: int, reps: int, log=print) -> list:
    """Every shape of ``kind``: ``profiles`` profiles of ``reps`` calls
    after a warm-up call; returns a dict of numbers per shape (ms)."""
    dev = resolve(None)
    kernel = f"{kind}_kernel"
    out = []
    for label, run, args, _ in mb.cases(kind, dev):
        run(*args)
        torch.cuda.synchronize()
        means, lows, highs, seen, odd, apart = [], [], [], [], [], 0
        for k in range(profiles):
            rec, averaged = profile_records(run, args, kernel, reps)
            if rec and (averaged is None
                        or abs(averaged - sum(rec) / len(rec)) > 1e-3):
                apart += 1
            seen.append(len(rec))
            if rec:
                means.append(sum(rec) / len(rec) / 1e3)
                lows.append(min(rec) / 1e3)
                highs.append(max(rec) / 1e3)
            odd.append((k, rec))
        med = statistics.median(means) if means else float("nan")
        odd = [(k, [round(r / 1e3, 4) for r in rec]) for k, rec in odd
               if rec and abs(sum(rec) / len(rec) / 1e3 - med) > 0.1 * med]
        row = {"shape": label, "median_ms": med,
               "min_mean_ms": min(means, default=None),
               "max_mean_ms": max(means, default=None),
               "min_record_ms": min(lows, default=None),
               "max_record_ms": max(highs, default=None),
               "records_seen": sum(seen), "calls": profiles * reps,
               "profiles_seeing_none": seen.count(0),
               "profiles_off_by_10pct": len(odd),
               "profiles_key_averages_apart": apart}
        out.append(row)
        log(f"{kind} [{label}]: mean over {profiles} profiles of {reps} "
            f"calls: median {med:.4f} ms, least {row['min_mean_ms']:.4f}, "
            f"greatest {row['max_mean_ms']:.4f}; single records "
            f"{row['min_record_ms']:.4f}-{row['max_record_ms']:.4f} ms; "
            f"{sum(seen)} records of {profiles * reps} calls, "
            f"{seen.count(0)} profiles saw none, {apart} whose "
            f"key_averages() mean differs from their records'")
        for k, rec in odd:
            log(f"  profile {k} off the median by more than 10%: records "
                f"{rec} ms")
    total = sum(r["median_ms"] for r in out)
    log(f"{kind}: the medians sum to {total:.4f} ms over {len(out)} shapes")
    return out


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m zpaqfranz_tpu_torch.experiments.kernel_spread",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--kind", nargs="+", default=["gather"],
                    choices=("gather", "onehot", "selwrite", "lane_loop",
                             "dma"))
    ap.add_argument("--profiles", type=int, default=20)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_spread: no CUDA device", file=sys.stderr)
        return 2
    rows = {kind: spread(kind, args.profiles, args.reps)
            for kind in args.kind}
    print(json.dumps({"profiles": args.profiles, "reps": args.reps,
                      "kinds": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
