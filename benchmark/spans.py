"""The traced run: spans around the port's functions, recorded from the
benchmark's own files, and the device's timeline from ``torch.profiler``.

Only a run with ``--trace 1`` installs the wrappers; each records its
host interval and, for the kernel wrappers, the work handed to the kernel,
and opens a ``torch.profiler.record_function`` range so the profiler's
trace shows which span the host was in.
"""

from __future__ import annotations

import json
import pathlib
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import torch

#: device activity in the profiler's trace
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclass
class Span:
    name: str
    start: float               # host clock (time.perf_counter), seconds
    end: float
    attrs: Dict = field(default_factory=dict)

    @property
    def seconds(self) -> float:
        return self.end - self.start


def _lens(seq) -> List[int]:
    return [len(x) for x in seq]


def _wrap(log: List[Span], name: str, fn: Callable,
          attrs: Optional[Callable] = None) -> Callable:
    def wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        with torch.profiler.record_function(f"bench::{name}"):
            out = fn(*args, **kwargs)
        t1 = time.perf_counter()
        log.append(Span(name, t0, t1,
                        attrs(args, out) if attrs is not None else {}))
        return out
    return wrapper


class Spans:
    """Wrappers around the port's layer boundaries, installed on entry and
    removed on exit."""

    def __init__(self):
        self.log: List[Span] = []
        self._saved: List[Tuple[object, str, Callable]] = []

    def __enter__(self) -> "Spans":
        from zpaqfranz_tpu_torch.jidac import extract
        from zpaqfranz_tpu_torch.ops import sha1
        from zpaqfranz_tpu_torch.parallel import engine
        points = [
            (engine, "encode_streams", lambda a, out: {
                "in_bytes": _lens(a[1]), "out_bytes": _lens(out)}),
            (engine, "decode_streams", lambda a, out: {
                "in_bytes": _lens(a[1]), "out_bytes": _lens(out)}),
            (extract, "_check_lanes", None),
            (sha1, "stage_bytes", None),
            (sha1, "sha1_lanes", lambda a, out: {
                "lengths": a[2].cpu().tolist()}),
        ]
        for mod, name, attrs in points:
            fn = getattr(mod, name)
            self._saved.append((mod, name, fn))
            setattr(mod, name, _wrap(self.log, name.lstrip("_"), fn, attrs))
        return self

    def __exit__(self, *exc) -> None:
        for mod, name, fn in reversed(self._saved):
            setattr(mod, name, fn)
        self._saved.clear()


@dataclass
class Trace:
    """What a per-layer metric's reader reads: the operations of the
    window, the spans, the device's activity (host clock, seconds) and the
    cell's configuration."""
    window: Tuple[float, float]
    ops: List[Span]
    spans: List[Span]
    device: List[Tuple[str, float, float]]
    config: Dict

    def of(self, name: str) -> List[Span]:
        return [s for s in self.spans if s.name == name]

    def span_seconds(self, name: str) -> float:
        return sum(s.seconds for s in self.of(name))

    def op_seconds(self) -> float:
        return sum(s.seconds for s in self.ops)

    def kernel_seconds(self, pattern: str) -> float:
        return sum(e - s for n, s, e in self.device if pattern in n)

    def busy(self) -> List[Tuple[float, float]]:
        """The window's device activity as disjoint intervals."""
        lo, hi = self.window
        out: List[List[float]] = []
        for _, s, e in sorted(self.device, key=lambda x: x[1]):
            s, e = max(s, lo), min(e, hi)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    def busy_seconds(self) -> float:
        return sum(e - s for s, e in self.busy())

    def idle_pct(self) -> Optional[float]:
        lo, hi = self.window
        if hi <= lo or not self.device:
            return None
        return 100.0 * (1.0 - self.busy_seconds() / (hi - lo))

    def host_share_outside(self, name: str) -> Optional[float]:
        """Per cent of the operations' time outside spans ``name``."""
        total = self.op_seconds()
        if not total:
            return None
        return 100.0 * (total - self.span_seconds(name)) / total

    def roofline_pct(self, name: str) -> Optional[float]:
        """Kernel ``name``'s share of its roofline: the least time its
        recorded work needs (``roofline/<name>.py``'s ``work``,
        ``peaks.bound_seconds``) over its device time in the window."""
        import importlib

        from .roofline import peaks
        kernel = importlib.import_module(f"{__package__}.roofline.{name}")
        seconds = self.kernel_seconds(kernel.KERNEL)
        launches = [s.attrs for s in self.of(kernel.SPAN)]
        if not seconds or not launches:
            return None
        ops, nbytes = kernel.work(launches, self.config)
        return 100.0 * peaks.bound_seconds(ops, nbytes) / seconds

    def gaps(self) -> List[Tuple[str, float]]:
        """Idle stretches of the device in the window, longest first, each
        named by the innermost span the host was in at its middle."""
        lo, hi = self.window
        edges = [lo] + [t for iv in self.busy() for t in iv] + [hi]
        out = []
        for s, e in zip(edges[0::2], edges[1::2]):
            if e <= s:
                continue
            mid = (s + e) / 2
            inside = [x for x in self.spans + self.ops
                      if x.start <= mid <= x.end]
            name = (max(inside, key=lambda x: x.start).name if inside
                    else "between operations")
            out.append((name, e - s))
        return sorted(out, key=lambda x: -x[1])

    def breakdown(self) -> Dict:
        by_name: Dict[str, float] = {}
        for n, s, e in self.device:
            by_name[n] = by_name.get(n, 0.0) + (e - s)
        ops = sorted(by_name.items(), key=lambda x: -x[1])[:10]
        return {"device_ops": [[n[:120], t] for n, t in ops],
                "idle_gaps": [[n, t] for n, t in self.gaps()[:10]]}


def device_events(trace_file: pathlib.Path, anchor: str,
                  anchor_host: float) -> List[Tuple[str, float, float]]:
    """Kernels, copies and fills from a profiler's chrome trace, on the
    host clock: the ``anchor`` range (a ``record_function`` opened at host
    time ``anchor_host``) ties the two clocks."""
    events = json.loads(trace_file.read_text())["traceEvents"]
    ts0 = next(e["ts"] for e in events
               if e.get("name") == anchor and e.get("cat") == "user_annotation")
    shift = anchor_host - float(ts0) / 1e6
    return [(e.get("name", ""), float(e["ts"]) / 1e6 + shift,
             (float(e["ts"]) + float(e.get("dur", 0))) / 1e6 + shift)
            for e in events
            if e.get("cat") in DEVICE_CATS and e.get("ph") == "X"]
