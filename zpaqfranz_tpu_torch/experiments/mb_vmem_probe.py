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

    python -m zpaqfranz_tpu_torch.experiments.mb_vmem_probe [L] [ITERS] [--device cpu]
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence

import torch

from ..device import resolve, seconds
from ..ops import build
from .mb_access import SMEM_MAX, check, device_name, device_of, wrap32

SW = 32768            # ISSE ht as u32 words: 131072 B / 4
W = 4                 # 16-byte row = 4 words
LUT = 4096            # P2's table entries
MIX = 741103597       # P1's index multiplier
ACC_MASK = (1 << 20) - 1

#: kernel launches made by each wrapper in this process
launches = {"lane_rw": 0, "lut": 0}


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
               iters)
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
               iters * 8)
    launches["lut"] += 1
    return out


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
