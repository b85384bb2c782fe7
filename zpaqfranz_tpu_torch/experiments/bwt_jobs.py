"""Time the card add's BWT jobs on the card, beside the host's SA-IS.

    python -m zpaqfranz_tpu_torch.experiments.bwt_jobs [--seed N]
        [--per-class K] [--threads T]

Run from the checkout's root (it makes the ``m3_b1.add`` cell's tree with
``benchmark/treegen.py``, in memory). The tree's unique files are cut into
jobs of a 1 MiB BWT block's largest size (2^20 - 4096 bytes), as
``jidac/add.py`` closes them. Every job's stream from
``bwt_device.BatchedBwt`` on the card is held to
``native.bwt_encode``'s. Then, one line each:

- ``alone``: up to K jobs of each rounds class, one at a time on one
  thread, the median ms of a job on the card (the call: copies in and
  out, the rounds' waits) and on the host;
- ``together``: all jobs on T threads, as ``code_jobs``' pool runs them
  (on the card the jobs waiting sorted together in batches), then the
  host's SA-IS; wall seconds, the jobs in a job's batch (mean), the
  card's peak memory, and the device time summed over the BWT's kernels
  and copies (``torch.profiler``, the card's run again);

and a last JSON line with everything, the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence

import torch

from .. import native
from ..jidac.add import BWT_SLACK
from ..pre import bwt_device

JOB = (1 << 20) - BWT_SLACK


def tree_jobs(seed: int, device: torch.device) -> List[bytes]:
    """The ``m3_b1.add`` tree's unique files at ``seed``, cut into jobs of
    ``JOB`` bytes (a file's last job shorter)."""
    from benchmark import cells, treegen

    cell = cells.load(cells.HERE.parent, "m3_b1.add")
    shape = dict(cell.traffic, tree_bytes=cell.config["tree_bytes"])
    seed %= 1 << 63
    voc = treegen.Vocabularies(seed, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    out = []
    for s in treegen.plan(shape, seed):
        if s.dup_of < 0:
            data = treegen.file_bytes(s.kind, s.size, voc, gen).cpu() \
                .numpy().tobytes()
            out += [data[i:i + JOB] for i in range(0, len(data), JOB)]
    return out


def _ms(fn, *args) -> float:
    t0 = time.perf_counter()
    fn(*args)
    return 1e3 * (time.perf_counter() - t0)


def together(jobs: Sequence[bytes], threads: int, fn):
    """Wall seconds of ``fn`` over every job on ``threads`` workers, and
    the results."""
    with ThreadPoolExecutor(threads) as pool:
        t0 = time.perf_counter()
        got = list(pool.map(fn, jobs))
        return time.perf_counter() - t0, got


def device_ms(jobs: Sequence[bytes], threads: int, card) -> float:
    """The device time of the BWT's kernels and copies over every job on
    ``threads`` workers calling ``card``, summed."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        together(jobs, threads, card)
    return sum(e.self_device_time_total for e in prof.key_averages()) / 1e3


def power_limit() -> Optional[str]:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None


def measure(jobs: Sequence[bytes], per_class: int, threads: int,
            dev: torch.device) -> Dict:
    card = bwt_device.BatchedBwt(dev).encode
    card(jobs[0])                                     # warm: sorts loaded
    rounds = []
    for d in jobs:
        got, r, _ = card(d)
        if got != native.bwt_encode(d):
            raise SystemExit(f"job of {len(d)} bytes differs from "
                             "native.bwt_encode")
        rounds.append(r)
    alone = {}
    for r in sorted(set(rounds)):
        some = [d for d, k in zip(jobs, rounds) if k == r][:per_class]
        alone[r] = {"jobs": rounds.count(r),
                    "card_ms": statistics.median(_ms(card, d) for d in some),
                    "host_ms": statistics.median(
                        _ms(native.bwt_encode, d) for d in some)}
        print(f"alone: {r} rounds, {alone[r]['jobs']} jobs: card "
              f"{alone[r]['card_ms']:.2f} ms, host "
              f"{alone[r]['host_ms']:.2f} ms a job", flush=True)
    torch.cuda.reset_peak_memory_stats(dev)
    on_card, got = together(jobs, threads, card)
    peak = torch.cuda.max_memory_allocated(dev)
    batch = statistics.mean(b for _, _, b in got)
    host, _ = together(jobs, threads, native.bwt_encode)
    busy = device_ms(jobs, threads, card)
    print(f"together: {len(jobs)} jobs on {threads} threads: card "
          f"{on_card:.3f} s (a job's batch {batch:.2f} jobs; peak "
          f"{peak / 1e9:.3f} GB; device {busy:.1f} ms summed), host "
          f"{host:.3f} s", flush=True)
    return {"jobs": len(jobs), "rounds": {r: rounds.count(r)
                                          for r in sorted(set(rounds))},
            "alone": alone, "together_s": {"card": on_card, "host": host},
            "batch": batch,
            "device_ms": busy, "peak_bytes": peak}


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=2100000231)
    ap.add_argument("--per-class", type=int, default=8)
    ap.add_argument("--threads", type=int, default=8)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    dev = torch.device("cuda", torch.cuda.current_device())
    t0 = time.perf_counter()
    jobs = tree_jobs(a.seed, dev)
    print(f"{len(jobs)} jobs in {time.perf_counter() - t0:.1f} s",
          flush=True)
    out = measure(jobs, a.per_class, a.threads, dev)
    out.update(card=power_limit(), seed=a.seed, threads=a.threads)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
