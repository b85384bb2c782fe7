"""The port's spans and counts: where the time of an operation goes.

A span is a named stretch of one thread's time on the host clock
(``time.perf_counter``), with counts found inside it::

    with trace.span("verify.hash", fragments=n) as sp:
        ...
        sp.add(bytes=nbytes)

Spans record only while a ``torch.profiler`` session records on the
calling thread: then each also opens ``record_function("zpaq::<name>")``,
so the profiler's timeline shows the spans beside the kernels, and its
record goes to an in-memory buffer that ``records()`` reads. Otherwise
``span()`` returns one shared no-op handle (``OFF``) after one check.

The profiler records per thread, and a thread pool does not copy the
caller's context: work handed to a pool names its parent, taken with
``current()`` on the submitting thread, and records whenever that parent
does. Spans are per operation, file, job, block, batch or launch, never
per fragment or bit.
"""

from __future__ import annotations

import itertools
import sys
import threading
import time
from typing import Dict, List, Optional

#: records the buffer holds; past it a span is counted as dropped
CAP = 1 << 20


class Record:
    """One closed span: ``id``, ``parent`` (an id, or None at an
    operation's root), ``root`` (the id of the operation's root span),
    ``thread`` (``threading.get_ident``), ``name``, ``start`` and ``end``
    (seconds, ``time.perf_counter``) and ``counts``, where an exception
    that left the span is ``error=<its type>``."""

    __slots__ = ("id", "parent", "root", "thread", "name", "start", "end",
                 "counts", "_profiled")

    def __init__(self, name: str, parent: Optional["Record"],
                 counts: Dict):
        self.id = next(_IDS)
        self.parent = None if parent is None else parent.id
        self.root = self.id if parent is None else parent.root
        self.thread = threading.get_ident()
        self.name = name
        self.counts = counts
        self.start = self.end = 0.0
        self._profiled = None

    @property
    def seconds(self) -> float:
        return self.end - self.start

    def add(self, **counts) -> None:
        """Counts found inside the span: a number adds to the count of its
        name, anything else replaces it."""
        for k, v in counts.items():
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                self.counts[k] = self.counts.get(k, 0) + v
            else:
                self.counts[k] = v

    def __enter__(self) -> "Record":
        # the profiler's range opens and closes inside the span's stamps,
        # so that back-to-back spans leave no gap of the tracer's own
        self.start = time.perf_counter()
        _stack().append(self)
        if _profiling():
            self._profiled = sys.modules["torch"].autograd.profiler \
                .record_function("zpaq::" + self.name)
            self._profiled.__enter__()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if self._profiled is not None:
            self._profiled.__exit__(exc_type, exc, tb)
            self._profiled = None
        stack = _stack()
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:
            stack.remove(self)
        if exc_type is not None:
            self.counts["error"] = exc_type.__name__
        self.end = time.perf_counter()
        BUFFER.put(self)
        return False


class _Off:
    """The handle of a span that does not record."""

    __slots__ = ()

    def add(self, **counts) -> None:
        pass

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False


#: the one handle ``span()`` returns while nothing records
OFF = _Off()


class Buffer:
    """The closed spans of the process, at most ``cap``; past it each is
    counted in ``dropped`` and the buffer does not grow."""

    def __init__(self, cap: int = CAP):
        self.cap = cap
        self.dropped = 0
        self._lock = threading.Lock()
        self._records: List[Record] = []

    def put(self, rec: Record) -> None:
        with self._lock:
            if len(self._records) < self.cap:
                self._records.append(rec)
            else:
                self.dropped += 1

    def records(self) -> List[Record]:
        with self._lock:
            return list(self._records)

    def clear(self) -> None:
        with self._lock:
            self._records.clear()
            self.dropped = 0


BUFFER = Buffer()
_IDS = itertools.count(1)
_LOCAL = threading.local()


def _find_profiler() -> bool:
    """Whether a ``torch.profiler`` session records on this thread: none
    can before torch is imported; once it is, ``_profiling`` is torch's own
    check, so that a span that does not record costs one call of it."""
    global _profiling
    torch = sys.modules.get("torch")
    if torch is None:
        return False
    _profiling = torch.autograd._profiler_enabled
    return _profiling()


_profiling = _find_profiler


def _stack() -> List[Record]:
    try:
        return _LOCAL.stack
    except AttributeError:
        _LOCAL.stack = []
        return _LOCAL.stack


def current() -> Optional[Record]:
    """The calling thread's innermost open span (None if none records): the
    parent to hand to work submitted to a thread pool."""
    stack = getattr(_LOCAL, "stack", None)
    return stack[-1] if stack else None


def enabled() -> bool:
    """Whether a span opened on this thread now would record."""
    return current() is not None or _profiling()


def span(name: str, parent=None, **counts):
    """A span named ``name`` with ``counts``, as a context manager whose
    handle has ``add(**counts)``. It records when ``parent`` (a span of
    another thread: ``current()`` there, or the handle of a span opened
    there) records, or else, with no parent, when the profiler
    records on this thread, under this thread's innermost span."""
    if parent is OFF:
        return OFF
    if parent is None:
        if not _profiling():
            return OFF
        parent = current()
    return Record(name, parent, counts)


def records() -> List[Record]:
    """The closed spans in the order they closed."""
    return BUFFER.records()


def dropped() -> int:
    """Spans closed while the buffer was full."""
    return BUFFER.dropped


def clear() -> None:
    """Empty the buffer and its dropped count."""
    BUFFER.clear()
