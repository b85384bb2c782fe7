"""Run a cell with its control in the program's place, to show that the
comparison deciding ``correct`` fails it. The benchmark's own runs never
run this.

    python3 benchmark/control.py --workload m4_b1.add --seed 7 --seconds 51

A configuration names its control under ``control`` in its file: other
``switches`` for the CLI (the archive coded at a lower level than the
configuration states), or ``check: sha1_prefix32`` (``t`` comparing only
the first 32 bits of each fragment's SHA-1: the guarantee that every
fragment is checked against its whole SHA-1, broken).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _check_lanes_prefix32(jd, blocks, outs, device) -> int:
    """``jidac/extract._check_lanes`` comparing 4 bytes of each digest."""
    import torch

    from zpaqfranz_tpu_torch.errors import ExtractError
    from zpaqfranz_tpu_torch.ops import sha1
    frag_ids, offs, lens = [], [], []
    base = 0
    for blk, out in zip(blocks, outs):
        q = base
        for j in range(blk.start, blk.start + blk.frags):
            if jd.ht[j].sha1 != b"\x00" * 20:
                frag_ids.append(j)
                offs.append(q)
                lens.append(jd.ht[j].usize)
            q += jd.ht[j].usize
        base += len(out)
    flat = sha1.stage_bytes(outs, device)
    states = sha1.sha1_lanes(
        flat, torch.tensor(offs, dtype=torch.int64).to(device),
        torch.tensor(lens, dtype=torch.int64).to(device))
    for j, dig in zip(frag_ids, sha1.to_digests(states)):
        if dig[:4] != jd.ht[j].sha1[:4]:
            raise ExtractError(f"fragment {j}: checksum failed")
    return len(frag_ids)


@contextlib.contextmanager
def planted(cell):
    """``cell`` with its configuration's control in the program's place."""
    control = cell.config["control"]
    saved = cell.config
    undo = []
    if "switches" in control:
        cell.config = dict(saved, switches=control["switches"])
    if control.get("check") == "sha1_prefix32":
        from zpaqfranz_tpu_torch.jidac import extract
        undo.append((extract, "_check_lanes", extract._check_lanes))
        extract._check_lanes = _check_lanes_prefix32
    try:
        yield cell
    finally:
        cell.config = saved
        for mod, name, fn in undo:
            setattr(mod, name, fn)


def main(argv=None) -> int:
    t0 = time.perf_counter()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark import cells, harness
    cell = cells.load(ROOT, args.workload)
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    with planted(cell):
        result = harness.run_cell(cell, args.seed, args.seconds, False,
                                  torch.device("cuda", 0), t0,
                                  ROOT / "bench_cache")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
