"""Time the SHA-1 and SHA-256 lane kernels of a checkout on the card.

    python zpaqfranz_tpu_torch/experiments/hash_lanes_bench.py [--root DIR]

imports ``zpaqfranz_tpu_torch`` from ``DIR`` (default: this checkout), so
that two versions of the kernels can be timed in turns on one card (run
it as a file, once per checkout). Three shapes, each seeded and held
against hashlib: ``smoke``, chip_smoke.py's 4096 lanes of log-uniform
lengths up to 256 KiB (the padding's edge lengths first); ``ladder``, the
device bench's hash stage, 4096 lanes of 16 KiB at multiples of 16 KiB;
``fragments``, 16,384 lanes of log-uniform 4-128 KiB back to back. For
each it prints one JSON line: the kernel's device time per launch
(``torch.profiler``, the kernel alone) and the wrapper call's (CUDA
events), the mean of five launches after a warm-up, with the card's name
and power limit."""

from __future__ import annotations

import argparse
import hashlib
import json
import pathlib
import subprocess
import sys
import time


def shapes(np):
    """name -> (flat bytes, offsets, lengths) of every shape, seeded."""
    rng = np.random.default_rng(1)
    special = [0, 55, 56, 63, 64, 119, 120]
    lens = np.array(special + [int(x) for x in np.exp(rng.uniform(
        0, np.log(256 << 10), 4096 - len(special)))], np.int64)
    out = {"smoke": (rng.bytes(int(lens.sum())), lens)}
    out["ladder"] = (rng.bytes(4096 * (16 << 10)),
                     np.full(4096, 16 << 10, np.int64))
    lens = np.exp(rng.uniform(np.log(4 << 10), np.log(128 << 10),
                              16384)).astype(np.int64)
    out["fragments"] = (rng.bytes(int(lens.sum())), lens)
    return {k: (flat, np.cumsum(lens) - lens, lens)
            for k, (flat, lens) in out.items()}


def device_ms(torch, fn, reps: int = 5) -> float:
    """Mean device milliseconds per call of the one kernel named
    ``*lanes_kernel*`` that ``fn()`` launches."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    hits = [e for e in prof.key_averages()
            if "lanes_kernel" in e.key and e.device_time_total > 0]
    if len(hits) != 1:
        raise RuntimeError(f"profiler saw {[e.key for e in hits]}")
    return hits[0].device_time_total / hits[0].count / 1e3


def call_ms(torch, fn, reps: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(
        pathlib.Path(__file__).resolve().parents[2]))
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("hash_lanes_bench: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(pathlib.Path(args.root).resolve()))
    from zpaqfranz_tpu_torch.ops import sha1, sha256
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    dev = torch.device("cuda")
    for name, (flat, offs, lens) in shapes(np).items():
        data = torch.frombuffer(bytearray(flat), dtype=torch.uint8).to(dev)
        off = torch.from_numpy(offs).to(dev)
        length = torch.from_numpy(lens).to(dev)
        view = memoryview(flat)
        for algo, lanes in (("sha1", sha1.sha1_lanes),
                            ("sha256", sha256.sha256_lanes)):
            got = sha1.to_digests(lanes(data, off, length))
            if got != [hashlib.new(algo, view[o:o + n]).digest()
                       for o, n in zip(offs, lens)]:
                raise RuntimeError(f"{algo} differs from hashlib on {name}")
            t0 = time.perf_counter()
            kernel = device_ms(torch, lambda: lanes(data, off, length))
            call = call_ms(torch, lambda: lanes(data, off, length))
            print(json.dumps({
                "root": args.root, "shape": name, "algo": algo,
                "lanes": len(lens), "bytes": len(flat), "kernel_ms": kernel,
                "call_ms": call, "GBps": len(flat) / kernel / 1e6,
                "card": card, "s": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
