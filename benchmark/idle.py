"""Where a cell's device idles, named by the port's own spans: one
cell's set-up, then a traced window, then two tables.

    python3 benchmark/idle.py --workload m4_b1.add --seed 7 --seconds 51

The first table gives the device's idle seconds in the window by the
innermost span of the port open on the operations' thread
(``program.idle_by_span``), with the share below the operations' roots;
the second each span's count, seconds and counts per operation (a number
summed, a name listed), so that a span's bytes give its rate. The last
line of standard output is the same as one JSON object; ``--records
FILE`` also writes the window's spans to FILE, one JSON object a line.
Not a benchmark run: no reference check, no result line.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent


def table(trace, setup_s: float) -> dict:
    """The idle seconds by span and each span's time per operation."""
    from benchmark import program
    lo, hi = trace.window
    idle = program.idle_by_span(trace) or {}
    total = sum(idle.values())
    below = sum(v for k, v in idle.items()
                if k != program.NO_SPAN and not k.startswith("op."))
    recs = program.records(trace) or []
    n = max(len(trace.ops), 1)
    spans: dict = {}
    for r in recs:
        s = spans.setdefault(r.name, {"count": 0, "seconds": 0.0,
                                      "counts": {}})
        s["count"] += 1
        s["seconds"] += r.seconds
        for k, v in r.counts.items():
            if isinstance(v, str):
                s["counts"].setdefault(k, set()).add(v)
            elif isinstance(v, (int, float)) and not isinstance(v, bool):
                s["counts"][k] = s["counts"].get(k, 0) + v
    return {"setup_s": setup_s, "window_s": hi - lo,
            "busy_s": trace.busy_seconds(), "idle_s": total,
            "idle_below_root_pct": 100.0 * below / total if total else None,
            "ops": len(trace.ops),
            "op_seconds": [s.seconds for s in trace.ops],
            "spans_per_op": len(recs) / n,
            "idle_by_span": dict(sorted(idle.items(), key=lambda x: -x[1])),
            "per_op": {k: {"count": v["count"] / n,
                           "ms": 1000.0 * v["seconds"] / n,
                           "counts": {c: (sorted(x) if isinstance(x, set)
                                          else x / n)
                                      for c, x in v["counts"].items()}}
                       for k, v in sorted(spans.items(),
                                          key=lambda x: -x[1]["seconds"])}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--records", type=pathlib.Path)
    args = ap.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    from benchmark import cells, harness, operations
    cell = cells.load(ROOT, args.workload)
    cache = ROOT / "bench_cache"
    os.environ["ZPAQFRANZ_TORCH_DEVICE_CAL"] = str(cache / "device_cal.json")

    import torch
    if not torch.cuda.is_available():
        print(f"{args.workload} needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    kind = operations.KINDS[cell.traffic["operation"]]
    work = pathlib.Path(tempfile.mkdtemp(prefix="zpaqidle-"))
    cwd = os.getcwd()
    os.chdir(work)
    try:
        op = kind(cell.config, cell.traffic, work, args.seed, device, cache)
        op.setup()
        torch.cuda.synchronize(device)
        setup_s = time.perf_counter() - T0
        _, _, _, trace = harness.traced(op, args.seconds, cell.config, work)
        op.finish()
    finally:
        os.chdir(cwd)
        shutil.rmtree(work, ignore_errors=True)

    out = table(trace, setup_s)
    if args.records:
        from benchmark import program
        with open(args.records, "w") as f:
            for r in program.records(trace) or ():
                f.write(json.dumps({
                    "id": r.id, "parent": r.parent, "root": r.root,
                    "thread": r.thread, "name": r.name, "start": r.start,
                    "end": r.end, "counts": r.counts}) + "\n")
            for s, e in program.idle_gaps(trace):
                f.write(json.dumps({"idle": [s, e]}) + "\n")
    print(f"{args.workload} seed {args.seed}: window {out['window_s']:.3f} s,"
          f" busy {out['busy_s']:.3f} s, idle {out['idle_s']:.3f} s, "
          f"{out['ops']} operations of "
          + ", ".join(f"{s:.3f}" for s in out["op_seconds"]) + " s, "
          f"{out['spans_per_op']:.1f} spans an operation")
    print("idle by span:")
    for name, sec in out["idle_by_span"].items():
        print(f"  {name:24s} {sec:10.4f} s "
              f"{100.0 * sec / (out['idle_s'] or 1):6.2f}%")
    print(f"  below the operations' roots: {out['idle_below_root_pct']}%")
    print("spans per operation:")
    for name, v in out["per_op"].items():
        print(f"  {name:24s} {v['count']:8.1f} x {v['ms']:12.3f} ms  "
              + " ".join(f"{c}={x if isinstance(x, list) else f'{x:g}'}"
                         for c, x in v["counts"].items()))
    print(json.dumps({"workload": args.workload, "seed": args.seed,
                      "device": torch.cuda.get_device_name(device), **out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
