"""Several devices: CM lanes split over a list of devices.

Mirrors ``zpaqfranz_tpu/parallel/dist.py``. Blocks are the unit of
parallelism: the lanes of one call split into contiguous shards, one per
device, and each shard codes through ``parallel/engine.py`` on its own
device. Lanes never talk to each other (block independence is a format
guarantee, reference libzpaq.h:57-59), so the only movement between devices
is the lanes' bytes going out and the coded bytes coming back, gathered in
lane order: the archive's bytes do not depend on the number of devices.

The reference's mesh is a JAX ``Mesh`` with a ``dp`` axis over lanes and a
``tp`` axis over the size axis of a lane's largest tables
(``shard_state_spec``). Here a "mesh" is a list of ``torch.device``s, the
lane split is the ``dp`` axis, and ``tp`` has no counterpart: a lane's
tables belong to one group of threads of one kernel. A device may appear
more than once (one card split into several shards). Each card runs its
shards in a thread of its own, so several cards code at once; the shards
of one card run in turn.
"""

from __future__ import annotations

import concurrent.futures
import math
from typing import Callable, Dict, List, Optional, Sequence, Union

import torch

from ..device import NoDeviceError, resolve
from ..ops import cm_encode as cme
from ..zpaql.header import Model
from . import engine

Mesh = Sequence[Union[str, torch.device]]


def default_mesh(n_devices: Optional[int] = None) -> List[torch.device]:
    """The CUDA cards, the first ``n_devices`` of them (all by default)."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise NoDeviceError("no CUDA device: pass a list of devices, "
                            "e.g. ['cpu'] * 8 for the plain versions")
    want = n_devices or n
    if want > n:
        raise ValueError(f"{want} devices asked for, {n} present")
    return [torch.device("cuda", i) for i in range(want)]


def _shards(mesh: Optional[Mesh], n: int):
    """``(device, first lane, end lane)`` of each non-empty contiguous
    shard of ``n`` lanes over the mesh's devices."""
    devices = [resolve(d) for d in (default_mesh() if mesh is None
                                    else mesh)]
    if not devices:
        raise ValueError("the mesh has no device")
    per = max(1, math.ceil(n / len(devices)))
    return [(dev, s, min(s + per, n))
            for dev, s in zip(devices, range(0, n, per))]


def _run_sharded(mesh: Optional[Mesh], n: int,
                 shard: Callable[[torch.device, int, int], List[bytes]]
                 ) -> List[bytes]:
    """``shard(device, start, end)`` for every shard; the lanes' results in
    lane order. Each distinct device runs its shards in turn in a thread of
    its own, so that several cards code at once (on the CPU the plain
    versions' threads would only contend)."""
    by_dev: Dict[torch.device, List] = {}
    for part in _shards(mesh, n):
        by_dev.setdefault(part[0], []).append(part)
    with concurrent.futures.ThreadPoolExecutor(len(by_dev) or 1) as ex:
        futs = [ex.submit(lambda ps: [(s, shard(d, s, e)) for d, s, e in ps],
                          parts) for parts in by_dev.values()]
        done = dict(r for f in futs for r in f.result())
    return [b for s in sorted(done) for b in done[s]]


def encode_streams_sharded(model: Model, payloads: Sequence[bytes],
                           mesh: Optional[Mesh] = None) -> List[bytes]:
    """Code payloads (selector prefix included) as CM encode lanes split
    over the mesh's devices (None: every CUDA card). Returns each lane's
    coded segment body, byte-identical to one ``engine.encode_streams``
    over all lanes."""
    def shard(dev: torch.device, s: int, e: int) -> List[bytes]:
        top = max(len(p) for p in payloads[s:e])
        step = engine.lanes_per_launch(model, top + cme.lane_cap(top), dev)
        return [b for k in range(s, e, step)
                for b in engine.encode_streams(
                    model, payloads[k:min(k + step, e)], dev)]

    return _run_sharded(mesh, len(payloads), shard)


def decode_streams_sharded(model: Model, streams: Sequence[bytes],
                           max_out: int, mesh: Optional[Mesh] = None
                           ) -> List[bytes]:
    """Decode coded segment bodies, as ``encode_streams_sharded`` returns
    them, as CM decode lanes split over the mesh's devices; each lane may
    give at most ``max_out`` bytes. Returns each lane's selector prefix and
    body. The segment's four zero bytes, which the body lacks, are
    appended here."""
    tails = [bytes(s) + bytes(4) for s in streams]

    def shard(dev: torch.device, s: int, e: int) -> List[bytes]:
        return engine.decode_streams(model, tails[s:e], [max_out] * (e - s),
                                     dev)

    return _run_sharded(mesh, len(streams), shard)


def decode_streams_sharded_chunked(model: Model, streams: Sequence[bytes],
                                   max_out: int, mesh: Optional[Mesh] = None,
                                   chunk: int = 64) -> List[bytes]:
    """The reference's entry for its 512-step device programs. A CUDA lane
    runs to its end in one launch, so ``chunk`` is accepted and unused:
    this is ``decode_streams_sharded``."""
    del chunk
    return decode_streams_sharded(model, streams, max_out, mesh)
