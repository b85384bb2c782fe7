"""Device BWT: a prefix-doubling suffix sort in torch ops, on the card.

The port of ``zpaqfranz_tpu/pre/bwt_device.py``. The card add
(``jidac/add.py code_jobs`` with a device) transforms each -m3 job here;
the host engine, the streaming add and the verify keep the host's SA-IS
(``native.bwt_encode``). Each round of prefix doubling sorts the suffixes
by the pair (rank[i], rank[i + k]) as one key, rank[i] * m + rank[i + k]
(ranks from 1, 0 past the end, m above every rank), and refreshes the
ranks from the sorted keys (a diff, a cumsum and a scatter). The
reference's only device work here is XLA's sort, with no Pallas kernel,
so its counterpart is ``torch.sort``, the card's radix sort, with no hand
kernel.

The emitted stream is byte-identical to the host engine's
``tz_bwt_encode`` (the suffix array of a string with an implicit unique
smallest sentinel is unique):

    out[0]       = in[n-1]                (the sentinel's BWT char)
    out[1..n]    = in[sa[i]-1], 255 at the sa[i]==0 row
    out[n+1..+4] = little-endian index of the sentinel row

which is what the inverse-BWT ZPAQL postprocessor expects. Every entry
point runs on the card unless the caller passes ``device="cpu"``.

Jobs sorted together: every thread of the card add's pool hands its jobs
to the add's ``BatchedBwt``, and one batch runs at a time. A caller that
finds no batch running sorts every job waiting (up to ``BATCH_BYTES``) in
one segmented prefix doubling, the job's number above its first rank and
0 past each job's own end, so that a round is ~11 calls and one wait for
the whole batch. Eight threads each sorting their own job at once contend
for the interpreter's lock and the CUDA runtime: on an H100 a 1 MiB job
took ~75 ms on each of eight threads against ~2.6 ms alone; one job at a
time, the card add held its sort 1.2-2.4 s an ``a`` of ~211 jobs.
"""

from __future__ import annotations

import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve

__all__ = ["suffix_array_device", "bwt_encode_device", "BatchedBwt",
           "prefix_doubling", "launches", "BATCH_BYTES"]

#: calls that ran on the card in this process
launches = 0
#: the most bytes of jobs sorted in one batch (a larger job runs alone)
BATCH_BYTES = 16 << 20


def _layout(lens: Sequence[int], dev: torch.device
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The end of each job of ``lens`` bytes, laid end to end, and each
    byte's job number (int64, on ``dev``)."""
    ends = torch.tensor(lens, dtype=torch.int64, device=dev).cumsum(0)
    jid = torch.zeros(sum(lens), dtype=torch.int64, device=dev)
    jid[ends[:-1]] = 1               # each job after the first starts
    return ends, jid.cumsum(0)


def _rows(x: torch.Tensor, lens: Sequence[int], ends: torch.Tensor,
          jid: torch.Tensor) -> Tuple[torch.Tensor, List[int]]:
    """Each suffix's rank (int64, from 1) among the suffixes of the jobs of
    ``lens`` bytes that the uint8 tensor ``x`` holds end to end (laid out
    as ``_layout`` gives), and the rounds each job took.

    A job's suffixes sort after those of the jobs before it, so job j's
    ranks are off_j + 1 .. off_j + n_j and its own rows (the inverse
    suffix array plus 1) are its ranks less off_j. A job is done once its
    ranks are distinct, since a further round sorts its pairs into the
    same order; the batch stops when every job is done, or when k reaches
    the longest job, as the reference's ceil(log2 n) rounds do. Equal keys
    take equal ranks whatever their order."""
    dev, n = x.device, x.numel()
    end_of = ends[jid]
    m = max(n, 256 * len(lens)) + 1  # above every rank
    rank = torch.zeros(n + 1, dtype=torch.int64, device=dev)  # [n]: past
    rank[:n] = jid * 256 + x + 1
    last = ends - 1                  # each job's last sorted position
    pos = torch.arange(n, device=dev)
    new = torch.ones(n, dtype=torch.bool, device=dev)
    size = np.array(lens)
    rounds = np.where(size < 2, 0, -1)
    k, r, top = 1, 0, int(size.max())
    while r == 0 or (rounds < 0).any():
        nxt = pos + k
        key = rank[torch.where(nxt < end_of, nxt, n)]
        key.add_(rank[:n], alpha=m)
        s, order = torch.sort(key, stable=True)
        torch.ne(s[1:], s[:-1], out=new[1:])
        ranked = new.cumsum(0)
        rank[:n].scatter_(0, order, ranked)
        k, r = 2 * k, r + 1
        # a job's distinct keys, read at its last sorted position
        done = k >= top or np.diff(ranked[last].cpu().numpy(),
                                   prepend=0) == size
        rounds[(rounds < 0) & done] = r
    return rank[:n], rounds.tolist()


def prefix_doubling(x: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """Suffix array (int64) of the uint8 tensor ``x`` and the rounds it
    took."""
    n = x.numel()
    if n == 0:
        return torch.zeros(0, dtype=torch.int64, device=x.device), 0
    rows, (rounds,) = _rows(x, [n], *_layout([n], x.device))
    sa = torch.empty_like(rows)
    sa[rows - 1] = torch.arange(n, device=x.device)
    return sa, rounds


def _upload(datas: Sequence[bytes], dev: torch.device) -> torch.Tensor:
    """The jobs end to end as one uint8 tensor on ``dev``; to the card
    through one pinned buffer."""
    if dev.type != "cuda":
        return torch.frombuffer(bytearray(b"".join(datas)),
                                dtype=torch.uint8).to(dev)
    host = torch.empty(sum(map(len, datas)), dtype=torch.uint8,
                       pin_memory=True)
    view, at = host.numpy(), 0
    for d in datas:
        view[at:at + len(d)] = np.frombuffer(d, dtype=np.uint8)
        at += len(d)
    return host.to(dev, non_blocking=True)


def _streams(datas: Sequence[bytes], dev: torch.device
             ) -> Tuple[List[bytes], List[int]]:
    """Each job's BWT stream and the rounds its sort took, the jobs sorted
    together on ``dev``.

    The streams are assembled on the device from the ranks alone, end to
    end, job j's at off_j + 5j: byte i of a job lands at its job's row of
    suffix i + 1 (rank[i + 1] + 5j), a job's last byte at its stream's
    start, 255 at the sentinel's row (that of suffix 0) and that row after
    the n_j + 1 bytes. They come back in one copy."""
    lens = [len(d) for d in datas]
    x = _upload(datas, dev)
    n, jobs = x.numel(), len(lens)
    ends, jid = _layout(lens, dev)
    rank, rounds = _rows(x, lens, ends, jid)
    off = ends - torch.tensor(lens, dtype=torch.int64, device=dev)
    five = 5 * torch.arange(jobs, device=dev)
    dest = torch.empty(n, dtype=torch.int64, device=dev)
    dest[:-1] = rank[1:]
    dest[ends - 1] = off
    out = torch.empty(n + 5 * jobs, dtype=torch.uint8, device=dev)
    out[dest + 5 * jid] = x
    first = rank[off]
    out[first + five] = 255
    row = (first - off).to(torch.int32).view(torch.uint8).view(jobs, 4)
    out[(ends + five + 1)[:, None] + torch.arange(4, device=dev)] = row
    if dev.type == "cuda":
        host = torch.empty(out.numel(), dtype=torch.uint8, pin_memory=True)
        host.copy_(out, non_blocking=True)
        torch.cuda.current_stream(dev).synchronize()
        out = host
    flat, at, got = out.numpy(), 0, []
    for size in lens:
        got.append(flat[at:at + size + 5].tobytes())
        at += size + 5
    return got, rounds


class _Job:
    """One caller's job, waiting for a batch."""

    __slots__ = ("data", "out", "rounds", "batch", "error", "done")

    def __init__(self, data: bytes):
        self.data = data
        self.out, self.rounds, self.batch = b"", 0, 0
        self.error: Optional[BaseException] = None
        self.done = False


#: guards ``launches``
_count = threading.Lock()


def _launched(calls: int) -> None:
    global launches
    with _count:
        launches += calls


class BatchedBwt:
    """The BWT of jobs handed in by many threads at once, on one device.

    One batch runs at a time: a call waits while a batch runs, and the
    first to find none running sorts every job waiting (up to
    ``BATCH_BYTES``, its own first) in one segmented prefix doubling."""

    def __init__(self, device=None):
        self.dev = resolve(device)
        self._cv = threading.Condition()
        self._waiting: List[_Job] = []
        self._running = False

    def _take(self, job: _Job) -> List[_Job]:
        """``job`` and the jobs waiting, oldest first, up to
        ``BATCH_BYTES``; taken off the waiting list (under ``_cv``)."""
        batch, size = [job], len(job.data)
        for other in self._waiting:
            if other is not job and size + len(other.data) <= BATCH_BYTES:
                batch.append(other)
                size += len(other.data)
        for j in batch:
            self._waiting.remove(j)
        return batch

    def encode(self, data: bytes) -> Tuple[bytes, int, int]:
        """The BWT stream of ``data`` (n+5 bytes, byte-identical to
        native.bwt_encode), the rounds its suffix sort took, and the jobs
        sorted in its batch, itself included."""
        if not data:
            return b"\xff" + b"\x00" * 4, 0, 1
        job = _Job(data)
        with self._cv:
            self._waiting.append(job)
            while self._running and not job.done:
                self._cv.wait()
            if not job.done:
                batch = self._take(job)
                self._running = True
        if not job.done:
            if self.dev.type == "cuda":
                _launched(len(batch))
            try:
                outs, rounds = _streams([j.data for j in batch], self.dev)
                for j, out, r in zip(batch, outs, rounds):
                    j.out, j.rounds, j.batch = out, r, len(batch)
            except BaseException as e:     # raised again in every call
                for j in batch:
                    j.error = e
            finally:
                with self._cv:
                    for j in batch:
                        j.done = True
                    self._running = False
                    self._cv.notify_all()
        if job.error is not None:
            raise job.error
        return job.out, job.rounds, job.batch


def suffix_array_device(data: bytes, device=None) -> np.ndarray:
    """Suffix array of ``data`` (implicit unique smallest sentinel), int32."""
    if not data:
        return np.zeros(0, np.int32)
    dev = resolve(device)
    if dev.type == "cuda":
        _launched(1)
    sa, _ = prefix_doubling(_upload([data], dev))
    return sa.to(torch.int32).cpu().numpy()


def bwt_encode_device(data: bytes, device=None) -> bytes:
    """BWT stream (n+5 bytes), byte-identical to native.bwt_encode."""
    return BatchedBwt(device).encode(data)[0]
