"""Run one cell of the benchmark and print its result as the last line of
standard output (one JSON object), the numbers that decided ``correct``
last on standard error.

    python3 benchmark/run.py --workload m4_b1.add --seed 7 --seconds 51 --trace 0

Exits with 2, printing no result, without as many CUDA cards as the cell
asks for; with 3 if JAX or the JAX package is loaded once the window has
closed.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
#: top-level modules no run may load: JAX and the package it ports
FORBIDDEN = ("jax", "jaxlib", "flax", "zpaqfranz_tpu")


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    from benchmark import cells
    cell = cells.load(ROOT, args.workload)
    # every build and kernel cache at a fixed path inside the checkout
    cache = ROOT / "bench_cache"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_ext"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ["ZPAQFRANZ_TORCH_DEVICE_CAL"] = str(cache / "device_cal.json")

    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    from benchmark import harness
    result = harness.run_cell(cell, args.seed, args.seconds,
                              bool(args.trace), torch.device("cuda", 0), T0,
                              cache)
    found = forbidden_modules()
    if found:
        print(f"loaded, and must not be: {', '.join(found)}",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
