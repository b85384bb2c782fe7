"""Microbenchmarks: per-lane dynamic table access on the CUDA card.

The CM codec's hot loop is per-lane random table access. This measures the
candidate mechanisms, as the TPU microbenchmark ``experiments/mb_access.py``
did on the TPU:

  A. shared-memory gather: dependent loads from the lane's table column
  B. one-hot gather (compare-select-sum over every row of the column)
  C. select-pass write (a select over every row of the column per write)
  D. per-lane row read/write at a dynamic offset in device memory
  E. per-lane copy of a row from device memory into shared memory (a bulk
     copy of the tensor memory accelerator, waited on by an mbarrier)
  F. PyTorch ``gather`` / ``scatter_`` on (L, S)

A to E are the CUDA kernels of ``csrc/mb_access.cu``; beside each is its
plain PyTorch version. ``mk_*_kernel`` return ``run(...)`` with the TPU
script's argument order and layouts: ``run`` launches the kernel for CUDA
tensors, takes the plain version for CPU tensors and raises for any other
device; ``run.plain`` is the plain version on any device. No ``run``
changes the caller's tensors. A, B and C launch with ``column_plan``'s
lanes, threads, blocks and shared bytes, and take every floor modulo by S
through ``mod_plan``'s reciprocal (``csrc/floor_mod.cuh``): no divide in
their chains. D and E spread their lanes over the SMs (``spread_plan``).
Each kernel runs ITERS dependent iterations (ITERS / 8 rounds over the
lanes for D and E); the reported number is ns per iteration (all lanes).

    python -m zpaqfranz_tpu_torch.experiments.mb_access [--device cpu]
"""

from __future__ import annotations

import argparse
import sys
from typing import Callable, Iterator, NamedTuple, Optional, Sequence, Tuple

import torch

from ..device import resolve, seconds
from ..ops import build

L = 128          # lanes
ITERS = 256      # dependent iterations inside kernel

#: shared memory one block may use (H100), which bounds a lane's column
SMEM_MAX = 227 * 1024
#: kernel launches made by each wrapper in this process
launches = {"gather": 0, "onehot": 0, "selwrite": 0, "lane_loop": 0,
            "dma": 0}

#: the configurations bench_A .. bench_E time (the TPU script's own)
A_SHAPES = ((256, torch.uint8), (2048, torch.uint8), (8192, torch.uint8),
            (512, torch.int32), (8192, torch.int32))
B_SHAPES = ((256, torch.uint8), (2048, torch.uint8), (512, torch.int32))
C_SHAPES = ((256, torch.uint8), (2048, torch.uint8), (8192, torch.uint8),
            (512, torch.int32))
D_SHAPES = ((2048, 16), (131072, 16))
E_SHAPES = ((1 << 20, 64),)
F_SIZES = (1 << 14, 1 << 18)

_ESIZE = {torch.uint8: 1, torch.int32: 4}
#: bytes of one staging load where a row segment allows it
VEC_BYTES = 16
#: A: threads a block (its T lanes' chains, and all of them stage)
GATHER_THREADS = 512
#: B, C: lanes a block at most, one warp each (a warp per SM sub-partition)
WARP_LANES = 4
#: D, E: lanes a block at most, the lanes spread over the SMs
SPREAD_LANES = 128


class ModPlan(NamedTuple):
    """A floor modulo by ``n`` as ``csrc/floor_mod.cuh`` computes it: a mask
    when ``pow2``; else ``q = umulhi(x & 0x7fffffff, m) >> shift`` and
    ``k = 2^31 mod n`` for the sign bit."""
    n: int
    pow2: bool
    m: int
    shift: int
    k: int


def mod_plan(n: int) -> ModPlan:
    """The reciprocal of ``n`` (1 <= n < 2^31) that the kernels' floor
    modulo takes, computed once per launch: ``m = ceil(2^(31 + l) / n)``
    with ``l = ceil(log2 n)``, below 2^32, exact for the 31 low bits of
    any int32 (Granlund and Montgomery 1994, theorem 4.2)."""
    if not 1 <= n < 1 << 31:
        raise ValueError(f"no floor modulo by {n}")
    if n & (n - 1) == 0:
        return ModPlan(n, True, 0, 0, 0)
    l = n.bit_length()
    return ModPlan(n, False, -(-(1 << (31 + l)) // n), l - 1, (1 << 31) % n)


class ColumnPlan(NamedTuple):
    """A launch of kernel A, B or C: ``lanes`` per block, ``threads`` per
    block, ``blocks``, ``smem`` shared bytes per block and ``pitch``: the
    bytes of a row of the block's columns (A) or of one lane's column (B,
    C)."""
    lanes: int
    threads: int
    blocks: int
    smem: int
    pitch: int


def spread_plan(n: int, sms: int, width: int = 0
                ) -> Tuple[int, int, int, int]:
    """The launch of kernel D (``width`` 0) or E over ``n`` lanes on a card
    of ``sms`` SMs: ``(lanes, threads, blocks, smem)``. The lanes spread
    over the SMs, ``ceil(n / sms)`` a block (at most SPREAD_LANES), one
    thread each in whole warps; E's shared memory holds an 8-byte mbarrier
    a lane, padded to 16 bytes, then a ``width``-byte row a lane."""
    lanes = max(1, min(SPREAD_LANES, -(-n // sms)))
    smem = -(-(8 * lanes) // 16) * 16 + lanes * width if width else 0
    return lanes, -(-lanes // 32) * 32, -(-n // lanes), smem


def column_plan(kind: str, S: int, esize: int, n: int) -> ColumnPlan:
    """The launch of kernel ``kind`` over ``n`` lanes of ``S`` rows of
    ``esize`` bytes. A: a thread a lane, ``VEC_BYTES // esize`` lanes a
    block (a row segment one 16-byte load; fewer where a block's shared
    memory cannot hold that many columns), so that the staging spreads over
    many SMs, and GATHER_THREADS threads staging. B, C: a warp a lane, at
    most WARP_LANES lanes a block, each column padded to 16 bytes."""
    if kind == "gather":
        T = max(1, min(n, VEC_BYTES // esize, SMEM_MAX // (S * esize)))
        return ColumnPlan(T, GATHER_THREADS, -(-n // T), S * T * esize,
                          T * esize)
    pitch = -(-(S * esize) // 16) * 16
    T = max(1, min(n, WARP_LANES, SMEM_MAX // pitch))
    return ColumnPlan(T, 32 * T, -(-n // T), T * pitch, pitch)


def wrap32(x):
    """``x`` (an int or an int64 tensor) wrapped to int32, as JAX's int32
    arithmetic wraps."""
    return (x + (1 << 31)) % (1 << 32) - (1 << 31)


def check(t: torch.Tensor, name: str, dtype: torch.dtype,
          shape: Tuple[int, ...]) -> None:
    if not isinstance(t, torch.Tensor) or t.dtype != dtype:
        raise TypeError(f"{name} must be a {dtype} tensor")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, want {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def device_of(*ts: torch.Tensor) -> torch.device:
    """The one device of ``ts``: the card or the CPU; raises otherwise."""
    dev = ts[0].device
    if any(t.device != dev for t in ts):
        raise ValueError("inputs lie on different devices")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {dev}")
    return dev


def sm_count(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _lanes(t: torch.Tensor) -> int:
    n = t.shape[1] if t.dim() == 2 else 0
    if n < 1:
        raise ValueError("need a 2-D table with at least one lane")
    return n


def _rows(idx: torch.Tensor, width: int, size: int) -> bool:
    """Each lane's row ``[idx, idx + width)`` must lie in ``[0, size)``.
    Returns whether every row starts at a multiple of 16 (one read of the
    card for all three facts)."""
    if idx.numel() == 0:
        raise ValueError("no lanes")
    lo, hi, odd = torch.stack([idx.min(), idx.max(),
                               (idx % 16 != 0).sum()]).tolist()
    if lo < 0 or hi + width > size:
        raise ValueError(f"a lane's row [{lo}|{hi}, +{width}) leaves the "
                         f"table of {size}")
    return odd == 0


# ---------------------------------------------------------------------------
# plain PyTorch versions


def gather_plain(tab: torch.Tensor, idx: torch.Tensor, iters: int
                 ) -> torch.Tensor:
    """A: per lane, ``iters`` times ``acc += tab[(idx0 + acc) % S, lane]``.
    Returns (1, L) int32."""
    S, n = tab.shape
    t = tab.long()
    i0 = idx[0].long()
    lanes = torch.arange(n, device=tab.device)
    acc = torch.zeros(n, dtype=torch.int64, device=tab.device)
    for _ in range(iters):
        acc = wrap32(acc + t[wrap32(i0 + acc) % S, lanes])
    return acc.to(torch.int32)[None]


def onehot_plain(tab: torch.Tensor, idx: torch.Tensor, iters: int
                 ) -> torch.Tensor:
    """B: A's result, each row picked by comparing every row index."""
    S, n = tab.shape
    t = tab.long()
    i0 = idx[0].long()
    rows = torch.arange(S, device=tab.device)[:, None]
    acc = torch.zeros(n, dtype=torch.int64, device=tab.device)
    for _ in range(iters):
        m = rows == (wrap32(i0 + acc) % S)[None]
        acc = wrap32(acc + torch.where(m, t, 0).sum(0))
    return acc.to(torch.int32)[None]


def selwrite_plain(tab: torch.Tensor, idx: torch.Tensor, iters: int
                   ) -> torch.Tensor:
    """C: write ``i & 0xFF`` into row ``(idx0 + i) % S`` of each lane's
    column for i < iters (on a copy); returns ``iters + column[0]``."""
    S, n = tab.shape
    t = tab.clone()
    i0 = idx[0].long()
    lanes = torch.arange(n, device=tab.device)
    for i in range(iters):
        t[wrap32(i0 + i) % S, lanes] = i & 0xFF
    return wrap32(iters + t[0].long()).to(torch.int32)[None]


def lane_loop_plain(idx: torch.Tensor, tab: torch.Tensor, width: int,
                    rounds: int) -> torch.Tensor:
    """D: ``rounds`` times per lane, read the ``width``-byte row at
    ``tab[l, idx[l]]``, write it back + 1 (on a copy) and add its first
    byte to the sum. Returns (1, 1) int32."""
    n = tab.shape[0]
    t = tab.clone()
    cols = idx.long() + torch.arange(width, device=tab.device)
    lanes = torch.arange(n, device=tab.device)[:, None]
    acc = torch.zeros((), dtype=torch.int64, device=tab.device)
    for _ in range(rounds):
        row = t[lanes, cols]
        t[lanes, cols] = row + 1
        acc = acc + row[:, 0].long().sum()
    return wrap32(acc).to(torch.int32).reshape(1, 1)


def dma_plain(idx: torch.Tensor, hbm: torch.Tensor, width: int,
              rounds: int) -> torch.Tensor:
    """E: ``rounds`` times per lane, copy the ``width``-byte row at
    ``hbm[l, idx[l]]`` and add the copy's first byte to the sum."""
    n = hbm.shape[0]
    cols = idx.long() + torch.arange(width, device=hbm.device)
    lanes = torch.arange(n, device=hbm.device)[:, None]
    acc = torch.zeros((), dtype=torch.int64, device=hbm.device)
    for _ in range(rounds):
        scratch = hbm[lanes, cols]
        acc = acc + scratch[:, 0].long().sum()
    return wrap32(acc).to(torch.int32).reshape(1, 1)


# ---------------------------------------------------------------------------
# kernels


def _column_kernel(kind: str, plain: Callable, S: int, dtype: torch.dtype
                   ) -> Callable:
    """``run(tab, idx)`` of kernel A, B or C: tab (S, L) ``dtype``, idx
    (1, L) int32 -> (1, L) int32."""
    if dtype not in _ESIZE:
        raise TypeError(f"tables are uint8 or int32, not {dtype}")
    if S < 1 or S * _ESIZE[dtype] > SMEM_MAX:
        raise ValueError(f"a column of {S} rows does not fit one block's "
                         f"{SMEM_MAX} bytes of shared memory")
    iters = ITERS
    mod = mod_plan(S)

    def run(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        n = _lanes(tab)
        check(tab, "tab", dtype, (S, n))
        check(idx, "idx", torch.int32, (1, n))
        dev = device_of(tab, idx)
        if dev.type == "cpu":
            return plain(tab, idx, iters)
        out = torch.empty((1, n), dtype=torch.int32, device=dev)
        build.call("mb_access", f"mb_{kind}_launch", dev, tab, idx, out, S,
                   n, iters, _ESIZE[dtype],
                   *column_plan(kind, S, _ESIZE[dtype], n), *mod[1:],
                   written=(out,))
        launches[kind] += 1
        return out
    run.plain = lambda tab, idx: plain(tab, idx, iters)
    return run


def mk_gather_kernel(S: int, dtype: torch.dtype) -> Callable:
    return _column_kernel("gather", gather_plain, S, dtype)


def mk_onehot_kernel(S: int, dtype: torch.dtype) -> Callable:
    return _column_kernel("onehot", onehot_plain, S, dtype)


def mk_selwrite_kernel(S: int, dtype: torch.dtype) -> Callable:
    return _column_kernel("selwrite", selwrite_plain, S, dtype)


def mk_lane_loop_kernel(S: int, W: int) -> Callable:
    """``run(idx, tab)``: idx (L, 1) int32, tab (L, S) uint8 -> (1, 1)
    int32. Rows are ``W`` bytes; 16-byte aligned rows move as 16-byte
    words, others byte by byte."""
    rounds = ITERS // 8

    def run(idx: torch.Tensor, tab: torch.Tensor) -> torch.Tensor:
        n = idx.shape[0] if idx.dim() == 2 else 0
        check(idx, "idx", torch.int32, (n, 1))
        check(tab, "tab", torch.uint8, (n, S))
        dev = device_of(idx, tab)
        aligned = _rows(idx, W, S)
        if dev.type == "cpu":
            return lane_loop_plain(idx, tab, W, rounds)
        work = torch.empty_like(tab)
        out = torch.zeros((1, 1), dtype=torch.int32, device=dev)
        vec = (aligned and W % 16 == 0 and S % 16 == 0
               and tab.data_ptr() % 16 == 0 and work.data_ptr() % 16 == 0)
        build.call("mb_access", "mb_lane_loop_launch", dev, idx, tab, work,
                   out, S, W, n, rounds, int(vec),
                   *spread_plan(n, sm_count(dev))[:3])
        launches["lane_loop"] += 1
        return out
    run.plain = lambda idx, tab: lane_loop_plain(idx, tab, W, rounds)
    return run


def mk_dma_kernel(S: int, W: int) -> Callable:
    """``run(idx, hbm)``: idx (L, 1) int32, hbm (L, S) uint8 -> (1, 1)
    int32. A bulk copy moves multiples of 16 bytes between 16-byte
    boundaries, so ``W``, ``S`` and every row start must be multiples of 16
    (on the CPU too); others raise. ``W`` is at most SMEM_MAX // 128, so
    that a block of SPREAD_LANES lanes holds its rows and mbarriers."""
    if W < 16 or W % 16 or S % 16 or W * 128 > SMEM_MAX:
        raise ValueError("W and S must be multiples of 16, W at most "
                         f"{SMEM_MAX // 128}")
    rounds = ITERS // 8

    def run(idx: torch.Tensor, hbm: torch.Tensor) -> torch.Tensor:
        n = idx.shape[0] if idx.dim() == 2 else 0
        check(idx, "idx", torch.int32, (n, 1))
        check(hbm, "hbm", torch.uint8, (n, S))
        dev = device_of(idx, hbm)
        if not _rows(idx, W, S):
            raise ValueError("every row must start at a multiple of 16 bytes")
        if hbm.data_ptr() % 16:
            raise ValueError("hbm must start at a 16-byte boundary")
        if dev.type == "cpu":
            return dma_plain(idx, hbm, W, rounds)
        out = torch.zeros((1, 1), dtype=torch.int32, device=dev)
        build.call("mb_access", "mb_dma_launch", dev, idx, hbm, out, S, W, n,
                   rounds, *spread_plan(n, sm_count(dev), W))
        launches["dma"] += 1
        return out
    run.plain = lambda idx, hbm: dma_plain(idx, hbm, W, rounds)
    return run


# ---------------------------------------------------------------------------
# benchmarks


def timeit(fn: Callable, *args, reps: int = 5) -> float:
    return seconds(fn, *args, reps=reps) / ITERS * 1e9  # ns per iter


def report(name: str, ns: float) -> None:
    print(f"{name:55s} {ns:10.1f} ns/iter  ({ns/L:6.2f} ns/lane)",
          flush=True)


def device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def _table(S: int, dtype: torch.dtype, device) -> torch.Tensor:
    """arange(S * L) as an (S, L) table of ``dtype``, wrapped as JAX's
    astype wraps."""
    vals = torch.arange(S * L, dtype=torch.int64, device=device).view(S, L)
    return (vals & 0xFF if dtype == torch.uint8 else vals).to(dtype)


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def cases(kind: str, device) -> Iterator[Tuple[str, Callable, tuple, float]]:
    """``(name, run, inputs, scale)`` for each configuration that bench_A
    .. bench_E time with kernel ``kind``: the report prints ns per
    iteration times ``scale``."""
    dev = torch.device(device)
    col = torch.arange(L, dtype=torch.int32, device=dev)
    if kind in ("gather", "onehot", "selwrite"):
        shapes, mk, label = {
            "gather": (A_SHAPES, mk_gather_kernel, "A smem gather"),
            "onehot": (B_SHAPES, mk_onehot_kernel, "B onehot gather"),
            "selwrite": (C_SHAPES, mk_selwrite_kernel,
                         "C select-pass write")}[kind]
        for S, dt in shapes:
            tab = (torch.zeros((S, L), dtype=dt, device=dev)
                   if kind == "selwrite" else _table(S, dt, dev))
            yield (f"{label} S={S} {_dtype_name(dt)}", mk(S, dt),
                   (tab, (col % S)[None]), 1.0)
    elif kind == "lane_loop":
        for S, W in D_SHAPES:
            yield (f"D lane-loop RW row S={S} W={W} (ns per lane-rw)",
                   mk_lane_loop_kernel(S, W),
                   (((col * 16) % S)[:, None].contiguous(),
                    torch.zeros((L, S), dtype=torch.uint8, device=dev)),
                   8 / L)
    elif kind == "dma":
        for S, W in E_SHAPES:
            yield (f"E per-lane device->shared bulk copy W={W} (ns per "
                   f"lane-dma)", mk_dma_kernel(S, W),
                   (((col * 4096) % S)[:, None].contiguous(),
                    torch.zeros((L, S), dtype=torch.uint8, device=dev)),
                   8 / L)
    else:
        raise ValueError(f"no kernel {kind!r}")


def _bench(kind: str, device) -> None:
    for name, run, args, scale in cases(kind, resolve(device)):
        report(name, timeit(run, *args) * scale)


def bench_A(device=None) -> None:
    _bench("gather", device)


def bench_B(device=None) -> None:
    _bench("onehot", device)


def bench_C(device=None) -> None:
    _bench("selwrite", device)


def bench_D(device=None) -> None:
    _bench("lane_loop", device)


def bench_E(device=None) -> None:
    _bench("dma", device)


def bench_F(device=None) -> None:
    """PyTorch gather / scatter_ over (L, S) int32, one call per step."""
    dev = resolve(device)
    for S in F_SIZES:
        tab = torch.zeros((L, S), dtype=torch.int32, device=dev)
        idx0 = torch.arange(L, device=dev)

        def g(tab, idx0):
            acc = torch.zeros(L, dtype=torch.int32, device=tab.device)
            for i in range(ITERS):
                idx = (idx0 + i) % S
                acc = acc + tab.gather(1, idx[:, None])[:, 0]
            return acc

        report(f"F torch gather (L,{S}) int32", timeit(g, tab, idx0))

        def s(tab, idx0):
            tab = tab.clone()
            for i in range(ITERS):
                tab.scatter_(1, ((idx0 + i) % S)[:, None], 1)
            return tab

        report(f"F torch scatter_ (L,{S}) int32", timeit(s, tab, idx0))


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m zpaqfranz_tpu_torch.experiments.mb_access",
        description="Per-lane table-access microbenchmarks (A-F).")
    ap.add_argument("--device", default=None,
                    help="'cpu' for the plain versions; default: the card")
    dev = resolve(ap.parse_args(argv).device)
    print(f"device: {device_name(dev)}, L={L}, ITERS={ITERS}", flush=True)
    for bench in (bench_A, bench_B, bench_C, bench_D, bench_E, bench_F):
        bench(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
