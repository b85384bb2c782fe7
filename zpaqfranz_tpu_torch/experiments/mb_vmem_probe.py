"""Per-lane dynamic-slice probe cost with DEPENDENT indices, on the CUDA card.

The CM codec's linchpin: per nibble, each lane reads a 16-byte row at a
data-dependent offset from its own table and writes it back. This measures
ns per lane-probe at the "3" chain's shapes, with the next index derived
from the read (a true dependency chain), as the TPU probe
``experiments/mb_vmem_probe.py`` did on the TPU:

  P1 ``lane_rw_probe``: one serial chain over ITERS rounds of L lanes, each
     probe a 4-word row read and written back + 1 in an (L, 32768) int32
     table (the ISSE table's 128 KiB per lane) in device memory;
  P2 ``lut_probe``: per lane, ITERS * 8 dependent lookups in a 4096-entry
     int32 LUT held in shared memory.

The kernels are ``csrc/mb_vmem_probe.cu``; beside each is its plain
PyTorch version, which the wrapper takes for CPU tensors. Neither changes
the caller's tensors.

``chase_ns(level)`` is the microbenchmarks' yardstick, not a port of a TPU
kernel: one thread walks a ring of pointers in shared memory, in an
L2-resident ring of a few MiB or in an HBM-resident ring of several hundred
MiB, each step's address the word the step before loaded; at level
"l2_rw" it reads back the word its own last store wrote to L2. It runs on
the card only; ``chip_smoke.py`` prices every microbenchmark's chain floor
with it.

    python -m zpaqfranz_tpu_torch.experiments.mb_vmem_probe [L] [ITERS] [--device cpu]
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence, Tuple

import torch

from ..device import resolve, seconds
from ..ops import build
from .mb_access import (SMEM_MAX, check, device_name, device_of, mod_plan,
                        wrap32)

SW = 32768            # ISSE ht as u32 words: 131072 B / 4
W = 4                 # 16-byte row = 4 words
LUT = 4096            # P2's table entries
MIX = 741103597       # P1's index multiplier
ACC_MASK = (1 << 20) - 1

#: P2: threads a block, one lane each (all of them stage the LUT)
LUT_THREADS = 128

#: kernel launches made by each wrapper in this process
launches = {"lane_rw": 0, "lut": 0}
#: the chase's levels: ring bytes, bytes between entries, steps timed
CHASE = {"shared": (16 << 10, 4, 1 << 16), "l2": (4 << 20, 128, 1 << 14),
         "hbm": (512 << 20, 128, 1 << 13)}
#: bytes written after the HBM ring is filled: twice the H100's 50 MB L2
CHASE_FLUSH = 128 << 20
#: the "l2_rw" chase (a store, then a read of the same word): words, bytes
#: between them, steps (a word's share in turn)
CHASE_RW = (64, 4224, 1 << 14)
#: timed reps of a chase after its warm-up; the median is kept (the SM
#: clock may still be rising in the first, which makes a difference of two
#: launches read fast)
CHASE_REPS = 7


def lane_rw_plain(tab: torch.Tensor, iters: int) -> torch.Tensor:
    """P1 in plain PyTorch: for it < iters, for l < L: ``idx = (acc * MIX + l
    + it) mod (SW - W)``; ``row = tab[l, idx:idx + W]``; the row written back
    + 1 (on a copy); ``acc = (acc + row[0]) mod 2^20``, in int32 arithmetic.
    Returns (1, 1) int32."""
    n, sw = tab.shape
    flat = tab.long().reshape(-1)
    offs = torch.arange(W, device=tab.device)
    acc = torch.zeros((), dtype=torch.int64, device=tab.device)
    for it in range(iters):
        for lane in range(n):
            pos = lane * sw + wrap32(acc * MIX + lane + it) % (sw - W) + offs
            row = flat[pos]
            flat[pos] = wrap32(row + 1)
            acc = (acc + row[0]) & ACC_MASK
    return acc.to(torch.int32).reshape(1, 1)


def lut_plain(lut: torch.Tensor, lanes: int, iters: int) -> torch.Tensor:
    """P2 in plain PyTorch: per lane, ``acc = lane``, then iters * 8 times
    ``idx = (acc + it) mod n``; ``acc = (acc + lut[idx]) mod 2^20``.
    Returns (1, lanes) int32."""
    v = lut.long()
    acc = torch.arange(lanes, dtype=torch.int64, device=lut.device)
    for it in range(iters * 8):
        acc = (acc + v[wrap32(acc + it) % v.numel()]) & ACC_MASK
    return acc.to(torch.int32)[None]


def lut_plan(n: int, lanes: int) -> Tuple[int, int, int]:
    """P2's launch over ``lanes`` lanes with an ``n``-entry LUT:
    ``(threads, blocks, smem)``, LUT_THREADS threads a block, one lane each,
    and the LUT in shared memory, padded to 16 bytes."""
    return (LUT_THREADS, -(-lanes // LUT_THREADS), -(-(4 * n) // 16) * 16)


def lane_rw_probe(tab: torch.Tensor, iters: int) -> torch.Tensor:
    """P1: tab (L, SW) int32 with SW > W -> (1, 1) int32."""
    n = tab.shape[0] if tab.dim() == 2 else 0
    sw = tab.shape[1] if tab.dim() == 2 else 0
    check(tab, "tab", torch.int32, (n, sw))
    if sw <= W or iters < 0:
        raise ValueError(f"need rows of more than {W} words and iters >= 0")
    dev = device_of(tab)
    if dev.type == "cpu":
        return lane_rw_plain(tab, iters)
    work = tab.clone()
    out = torch.empty((1, 1), dtype=torch.int32, device=dev)
    build.call("mb_vmem_probe", "mb_lane_rw_launch", dev, work, out, n, sw, W,
               iters, *mod_plan(sw - W)[1:])
    launches["lane_rw"] += 1
    return out


def lut_probe(lut: torch.Tensor, lanes: int, iters: int) -> torch.Tensor:
    """P2: lut (n,) int32 with n * 4 bytes in shared memory -> (1, lanes)
    int32."""
    n = lut.shape[0] if lut.dim() == 1 else 0
    check(lut, "lut", torch.int32, (n,))
    if n < 1 or 4 * n > SMEM_MAX or lanes < 1 or iters < 0:
        raise ValueError(f"need 1..{SMEM_MAX // 4} LUT entries, lanes >= 1 "
                         f"and iters >= 0")
    dev = device_of(lut)
    if dev.type == "cpu":
        return lut_plain(lut, lanes, iters)
    out = torch.empty((1, lanes), dtype=torch.int32, device=dev)
    build.call("mb_vmem_probe", "mb_lut_launch", dev, lut, out, n, lanes,
               iters * 8, *lut_plan(n, lanes), *mod_plan(n)[1:])
    launches["lut"] += 1
    return out


def chase_ring(slots: int, seed: int, device) -> Tuple[torch.Tensor,
                                                       torch.Tensor]:
    """``(order, nxt)``: a random order of ``slots`` slots and, for each
    slot, the next slot of that order, the last leading back to the first:
    one cycle through every slot."""
    g = torch.Generator(device=device).manual_seed(seed)
    order = torch.randperm(slots, generator=g, device=device)
    nxt = torch.empty_like(order)
    nxt[order] = order.roll(-1)
    return order, nxt


def chase_end(order: torch.Tensor, steps: int) -> int:
    """The slot a walk from slot 0 reaches after ``steps`` steps."""
    at = int((order == 0).nonzero()[0, 0])
    return int(order[(at + steps) % order.numel()])


def chase_ns(level: str, device=None, seed: int = 0) -> Tuple[float, float]:
    """``(ns, cycles)`` of one step of the bare dependent chase at ``level``
    ("shared", "l2" or "hbm"; or "l2_rw", a read of the word the thread's
    last store wrote to L2) on the card. A rep queues three launches: one
    of ``CHASE[level]`` steps (``CHASE_RW``'s for "l2_rw") that keeps the
    card busy while the host queues the others, then, between CUDA events,
    one of as many steps and one of twice as many. The step is the
    difference of the two timed launches over those steps, so that the
    launch and the ring's fill cancel, and the cycles are the difference of
    their own clock counts, over the same span. The median of CHASE_REPS
    reps after a warm-up is kept. The L2 ring's walks repeat the warm-up's
    (the ring is in L2); the HBM ring is pushed out of L2 after it is
    filled, and each walk goes on from where the last ended, onto entries
    no launch has read. Fails unless each walk ends on the slot
    ``chase_end`` gives (for "l2_rw": on its count of stores)."""
    dev = resolve(device)
    if dev.type != "cuda":
        raise ValueError("the chase times the card: it has no plain version")
    if level == "l2_rw":
        words, apart, steps = CHASE_RW

        def launch(n: int, out: torch.Tensor) -> int:
            cells = torch.zeros(words * apart // 8, dtype=torch.int64,
                                device=dev)
            build.call("mb_vmem_probe", "mb_chase_rw_launch", dev, cells,
                       words, apart // 8, out, n // words)
            return n

        def ended(out: torch.Tensor) -> int:
            return out[0].item()
    else:
        nbytes, stride, steps = CHASE[level]
        slots = nbytes // stride
        order, nxt = chase_ring(slots, seed, dev)
        if level == "shared":
            ring = nxt.to(torch.int32)
        else:
            ring = torch.zeros(nbytes // 8, dtype=torch.int64, device=dev)
            ring[::stride // 8] = ring.data_ptr() + nxt * stride
            if level == "hbm":      # push the ring's last lines out of L2
                torch.ones(CHASE_FLUSH, dtype=torch.uint8, device=dev)
        first = [0]             # the slot the next walk starts from, as a step

        def launch(n: int, out: torch.Tensor) -> int:
            if level == "shared":
                build.call("mb_vmem_probe", "mb_chase_shared_launch", dev,
                           ring, out, slots, n)
                return chase_end(order, n)
            build.call("mb_vmem_probe", "mb_chase_global_launch", dev, ring,
                       chase_end(order, first[0]) * stride, out, n)
            want = chase_end(order, first[0] + n)
            if level == "hbm":
                first[0] += n
            return want

        def ended(out: torch.Tensor) -> int:
            end = out[0].item()
            return end if level == "shared" else (
                end - ring.data_ptr()) // stride

    reps = []
    for rep in range(1 + CHASE_REPS):   # a warm-up, then timed reps
        outs = torch.zeros((3, 2), dtype=torch.int64, device=dev)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        wants = [launch(steps, outs[0])]
        ev[0].record()
        wants.append(launch(steps, outs[1]))
        ev[1].record()
        wants.append(launch(2 * steps, outs[2]))
        ev[2].record()
        ev[2].synchronize()
        for out, want in zip(outs, wants):
            if ended(out) != want:
                raise RuntimeError(f"the {level} chase ended on "
                                   f"{ended(out)}, want {want}")
        if rep:
            t1, t2 = ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2])
            c1, c2 = outs[1, 1].item(), outs[2, 1].item()
            reps.append(((t2 - t1) * 1e6 / steps, (c2 - c1) / steps))
    return sorted(reps)[len(reps) // 2]


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m zpaqfranz_tpu_torch.experiments.mb_vmem_probe",
        description="Dependent per-lane probes (P1, P2).")
    ap.add_argument("L", nargs="?", type=int, default=64)
    ap.add_argument("ITERS", nargs="?", type=int, default=64)
    ap.add_argument("--device", default=None,
                    help="'cpu' for the plain versions; default: the card")
    args = ap.parse_args(argv)
    L, ITERS = args.L, args.ITERS
    dev = resolve(args.device)
    print(f"device={device_name(dev)} L={L} ITERS={ITERS}", flush=True)

    # --- per-lane dynamic-slice RW over (L, SW) i32 in device memory ------
    tab = torch.zeros((L, SW), dtype=torch.int32, device=dev)
    dt = seconds(lane_rw_probe, tab, ITERS)
    per_lane = dt / ITERS / L * 1e9
    print(f"gmem lane-RW 16B row: {per_lane:8.1f} ns/lane-probe "
          f"({dt/ITERS*1e6:.2f} us per {L}-lane probe round)", flush=True)

    # --- dependent lookups in a (4096,) LUT in shared memory, (L,) lanes ---
    lut = torch.arange(LUT, dtype=torch.int32, device=dev)
    dt = seconds(lut_probe, lut, L, ITERS)
    print(f"smem 4096 LUT: {dt/(ITERS*8)*1e6:8.2f} us/query-round "
          f"(all {L} lanes)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
