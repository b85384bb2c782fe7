"""The port's own spans in a traced run: what ``zpaqfranz_tpu_torch.trace``
recorded inside the window, for the per-layer metrics that read the
program from the inside.

The port records its spans while the profiler records, so the window of
``harness.traced`` gets them with nothing installed. A checkout whose port
has no tracer, or whose tracer dropped a span, gives nothing to read: every
function here then returns None.
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Optional

#: where an idle stretch falls outside every span of the port
NO_SPAN = "(no span)"


def records(trace) -> Optional[List]:
    """The port's closed spans that start inside ``trace.window``; None
    where the port has no tracer or its buffer dropped a span."""
    try:
        from zpaqfranz_tpu_torch import trace as port
    except ImportError:
        return None
    if port.dropped():
        return None
    lo, hi = trace.window
    return [r for r in port.records() if lo <= r.start <= hi]


def of(trace, name: str) -> Optional[List]:
    """The window's spans named ``name``; None where there are none."""
    recs = records(trace)
    found = [r for r in recs if r.name == name] if recs else []
    return found or None


def ms_per_op(trace, name: str) -> Optional[float]:
    """Milliseconds in spans ``name`` per operation of the window."""
    found = of(trace, name)
    if found is None or not trace.ops:
        return None
    return 1000.0 * sum(r.seconds for r in found) / len(trace.ops)


def lane_busy_pct(trace) -> Optional[float]:
    """Per cent of the CM launches' lane time in which a lane ran: the
    lanes' own nanoseconds (``lane_ns``) over the lanes times each launch's
    first start to last end (``kernel_ns``), over the ``cm.wait`` spans."""
    waits = [r for r in of(trace, "cm.wait") or ()
             if "lane_ns" in r.counts]
    busy = sum(sum(r.counts["lane_ns"]) for r in waits)
    span = sum(len(r.counts["lane_ns"]) * r.counts["kernel_ns"]
               for r in waits)
    if span <= 0:
        return None
    return 100.0 * busy / span


def idle_gaps(trace) -> List[tuple]:
    """The window's stretches with no device activity, in order."""
    lo, hi = trace.window
    edges = [lo] + [t for iv in trace.busy() for t in iv] + [hi]
    return [(s, e) for s, e in zip(edges[0::2], edges[1::2]) if e > s]


def idle_by_span(trace) -> Optional[Dict[str, float]]:
    """The device's idle seconds in the window by the innermost span open
    on the thread that opened the operations' roots (``op.<cmd>``), at
    each instant; ``NO_SPAN`` where none was. None where the port recorded
    no operation."""
    recs = records(trace)
    if not recs:
        return None
    main = {r.thread for r in recs
            if r.parent is None and r.name.startswith("op.")}
    if not main:
        return None
    # spans of one thread nest: sweep their edges with a stack
    edges = sorted([(r.start, 1, r) for r in recs if r.thread in main]
                   + [(r.end, 0, r) for r in recs if r.thread in main],
                   key=lambda x: (x[0], x[1]))
    gaps = idle_gaps(trace)
    starts = [s for s, _ in gaps]
    cuts = sorted({t for g in gaps for t in g} | {t for t, _, _ in edges})
    out: Dict[str, float] = {}
    stack: List = []
    k = 0
    for a, b in zip(cuts, cuts[1:]):
        while k < len(edges) and edges[k][0] <= a:
            _, opening, r = edges[k]
            if opening:
                stack.append(r)
            elif r in stack:
                stack.remove(r)
            k += 1
        mid = (a + b) / 2
        g = bisect.bisect_right(starts, mid) - 1
        if g < 0 or mid > gaps[g][1]:
            continue
        name = stack[-1].name if stack else NO_SPAN
        out[name] = out.get(name, 0.0) + (b - a)
    return out
