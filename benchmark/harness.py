"""One run of a cell: set-up, the measured window, the reference's check
and the result's line.

The window runs the cell's operation back to back. An operation starts
only while the previous one's duration still fits in the time left, and
the window holds at least one. The rate is all the bytes of the completed
operations over all their wall time.
"""

from __future__ import annotations

import os
import pathlib
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional, Tuple

import torch

from . import cells, operations, spans

MB = 1e6


def window(op: operations.Operation, seconds: float
           ) -> Tuple[List[operations.Answer], float, float]:
    answers: List[operations.Answer] = []
    start = time.perf_counter()
    while True:
        left = start + seconds - time.perf_counter()
        if answers and answers[-1].end - answers[-1].start > left:
            break
        answers.append(op.run(len(answers)))
    return answers, start, time.perf_counter()


def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return out.splitlines()[0].strip() if out.strip() else None


def run_cell(cell: cells.Cell, seed: int, seconds: float, trace: bool,
             device: torch.device, t0: float, cache: pathlib.Path) -> Dict:
    """Run ``cell`` once; returns the result's line as a dict."""
    kind = operations.KINDS[cell.traffic["operation"]]
    work = pathlib.Path(tempfile.mkdtemp(prefix="zpaqbench-"))
    cwd = os.getcwd()
    os.chdir(work)
    try:
        op = kind(cell.config, cell.traffic, work, seed, device, cache)
        op.setup()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
        setup_s = time.perf_counter() - t0
        if trace:
            answers, lo, hi, tr = traced(op, seconds, cell.config, work)
        else:
            answers, lo, hi = window(op, seconds)
        peak = (torch.cuda.max_memory_allocated(device)
                if device.type == "cuda" else 0)
        op.finish()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        t_check = time.perf_counter()
        checks = op.check(answers)
        print(f"reference check {time.perf_counter() - t_check:.1f} s",
              file=sys.stderr)
    finally:
        os.chdir(cwd)
        shutil.rmtree(work, ignore_errors=True)

    metrics: Dict[str, Dict] = {}
    if trace:
        for m in cell.per_layer:
            value = cells.reader(m["name"], cell.here)(tr)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        rate = (sum(a.nbytes for a in answers) / MB
                / sum(a.end - a.start for a in answers))
        values = {"setup_s": setup_s, cell.traffic["rate_metric"]: rate}
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else device.type),
           "count": cell.chips, "memory_peak_bytes": peak}
    if device.type == "cuda":
        dev["power_limit"] = power_limit()
    result = {"correct": all(v <= lim for v, lim in checks.values()),
              "attempted": len(answers),
              "failed": int(checks.get("failed_ops",
                                       checks.get("wrong_answers"))[0]),
              "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = tr.busy_seconds()
        dev["window_s"] = hi - lo
        result["breakdown"] = tr.breakdown()
    result["checks"] = {name: {"value": v, "limit": lim}
                        for name, (v, lim) in checks.items()}
    return result


def traced(op: operations.Operation, seconds: float, config: Dict,
           work: pathlib.Path):
    """The window under ``torch.profiler`` with the spans installed."""
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU]
    if op.device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with spans.Spans() as sp, profile(activities=acts) as prof:
        with record_function("bench::window"):
            anchor = time.perf_counter()
            answers, lo, hi = window(op, seconds)
    path = work / "trace.json"
    prof.export_chrome_trace(str(path))
    device = spans.device_events(path, "bench::window", anchor)
    ops = [spans.Span(f"op {op.cmd}", a.start, a.end) for a in answers]
    return answers, lo, hi, spans.Trace((lo, hi), ops, sp.log, device,
                                        config)
