#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port, ``zpaqfranz_tpu_torch``.

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

It builds the port's seven CUDA sources (``zpaqfranz_tpu_torch/csrc/*.cu``)
with their twelve kernels, and the CM decode and encode kernels once more
for each HCOMP program of its models that ``ops/hcomp_fast.py``
specialises (-m3, -m4, -m5 and the all-components model), one ``nvcc``
each, all started together, into ``zpaqfranz_tpu_torch/build/``, printing
each build's seconds and registers. It holds each kernel bit-exact against
its plain PyTorch version: the SHA-1, SHA-256 and CM decode and encode
kernels on the checks' own lanes (the CM kernels with the specialised
HCOMP step and again with the interpreter forced, on the same lanes; the
hash kernels
also against hashlib at every offset 0..63 at the padding's edge lengths,
on messages that end on the last byte of a tensor and on the fragment
shape, 16,384 lanes of ~0.6 GB, each shape timed beside its bound: bytes,
instructions and the chain of the longest lane, from a profiled lane
alone; the CM kernels also against the native host engine, with each
model's placement printed: G threads per lane, lanes per block, shared
bytes; then one lane per level for its rate and a profiled breakdown of a
bit, with each HCOMP step, beside the interpreter design's), the CRC-32
lane kernel (one aligned segment alone, profiled for its step; one 1 MiB
lane alone, 1,024 lanes of 1-4 KiB and the fragment shape against its
plain version and ``native.crc32``, timed beside its bound, its chain
floor and the one-thread design's times; the fragment shape also on zero
bytes and at several segment sizes), the seven
table-access
microbenchmark kernels (``experiments/mb_access.py`` A-E,
``experiments/mb_vmem_probe.py`` P1, P2) at every shape their scripts
time, on the scripts' inputs and on seeded random tables and indices of
the same shapes (A also with every lane on the same row), each timed
beside its chain floor: its dependent accesses priced at this run's
chase (``mb_vmem_probe.chase_ns``: one thread walking a ring of pointers
in shared memory, in L2 and in HBM, and a read of a word after the
thread's own store in L2, run first, which also prices the CM design's
chain floor) and the integer instructions between them. The
device BWT (``pre/bwt_device.py``) sorts one 16 MiB
block of text on the card, byte-identical to ``native.bwt_encode``, with
its rounds and the share of ``torch.sort``. Then it drives the port's
paths on the card. The
archive path at -m4 (16 MiB blocks), -m3 and -m5: ``add``
writes a seeded corpus as a jidac archive through the CM encode kernel,
byte-identical to the host engine's ``add`` of the same tree and date;
``extract`` restores it through the CM decode kernel; ``verify_archive``
checks every fragment through the SHA-1 kernel; ``sum -sha1`` and ``sum
-sha256`` hash the corpus through the SHA-1 and SHA-256 kernels; and a
flipped byte inside a d block must raise ``ExtractError``. Several devices
and hosts: 16 -m4 lanes of 16 KiB split over the card named 1, 2 and 4
times (``parallel/dist.py``), equal to one launch and to the host engine,
decoded back, with the aggregate MB/s; the multi-host add
(``parallel/multihost.py``) at method 3.0 over 4 MiB, 1-3 ranks over TCP
and 1-2 over torch.distributed, each rank a process coding on the card,
every world's archive equal to one ``add`` on the card and on the host
engine, each rank's CM encode launches read from its printed count. The
CLI: ``backup`` at -m4 twice (a second part), ``testbackup``, ``p`` and
``c`` on the parts, equal to the host engine's lines; ``autotest -all``.
The batched-hash API (``ops/hash_batched.py``): ``sha1_lanes``,
``sha256_lanes`` and ``crc32_lanes`` over the fragment shape as padded rows,
equal to hashlib and ``native.crc32``. The batched coders
(``ops/coder_batched.py``) at -m4, equal to the host engine's streams,
and the per-bit ``BatchedPredictor`` on the card, equal to the scalar
predictor.
``zfsbackup`` twice and ``zfsrestore`` at -m4 through the CLI on a fake
``zfs``, the received streams equal to the sent ones. Every path above is
forced onto the card (``device=dev``, or ``-tpu`` on the CLI). The engine
gate (``device_policy.py``), whose record the smoke points at
``build/smoke/device_cal.json`` before any phase: ``b`` through the CLI
records SHA-1 and -m3, -m4 and -m5 at 1 lane and a wider lane count on the
card beside the host engine; for each main-path level the gate's decision
and predicted rates beside the measured ``a`` (the faster engine wherever
the two differ by more than 2x; -m4's one lane to the host engine); an
unforced ``a -m3`` of a 1.25 MiB tree under the measured record and under
one with the card 10x faster, byte-identical; an unforced ``t`` through
the SHA-1 kernel.
The measurement path: the two microbenchmark entry points' ``main()``, and the
device bench's whole lane ladder (SHA-1 lanes, then CM encode and decode
at -m3 x 256 and x 1024 lanes and "4.0" x 8 and x 32, every lane equal to
the host engine's coded stream and decoded back to its payload). Every
kernel must have launched on its paths: each path runs with the launch
counts set to 0 just before it and read just after, and the JSON line
sums them. Last, ``sanitize``: every CUDA entry point at its exact
allocation bounds (``experiments/sanitize.py``): the matrix's cases
recorded on the normal path, each held against its plain version, then
every launch replayed in a process that never imports torch, each buffer
exactly its tensor's bytes against an unmapped granule after its end and
then before its start, every output byte-equal to the recording, one line
per entry point; compute-sanitizer's memcheck and racecheck on the
smallest SHA-1 and CM decode cases where the tool can check the card (on
the H100 machine it cannot, and the phase says so). Scratch files go to
``build/smoke/`` and ``build/smoke_sanitize/`` and are removed at the end.

Output: per-phase lines, then one JSON line of kernel measurements (in the
order: SHA-1, SHA-256, CM decode, CM encode, CRC-32, the specialised HCOMP
step in the CM decode and encode kernels, A-E, P1, P2), the card's name and
power limit, and last ``{"ok": true, "device": ...}``.
Any failure exits non-zero; so does a machine without a CUDA card, or a
directory that does not hold the repository.
"""

from __future__ import annotations

import contextlib
import hashlib
import io
import json
import os
import pathlib
import re
import shutil
import statistics
import subprocess
import sys
import time

T0 = time.perf_counter()
ROOT = pathlib.Path(__file__).resolve().parent
WORK = ROOT / "build" / "smoke"
# the sanitize phase's record of the exact-bounds matrix
SAN_WORK = ROOT / "build" / "smoke_sanitize"
# its compute-sanitizer runs, when the tool can check this card: the
# smallest SHA-1 and CM decode cases
SAN_TOOL_CASES = ("sha1 1 lanes", "cm_decode -m3, HCOMP specialised: one "
                  "lane")

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, and INT32 issue rate
# = 132 SMs x 64 INT32 lanes x 1.98 GHz boost clock (Hopper white paper).
HBM_BYTES_PER_S = 3.35e12
SM_CLOCK_HZ = 1.98e9
INT32_OPS_PER_S = 132 * 64 * SM_CLOCK_HZ
# Instructions of one SHA-1 compression (FIPS 180-4) as Hopper issues them,
# counted from csrc/sha1_lanes.cu with 3-input logic fused into one LOP3
# and 3-input adds into one IADD3: per round rotl(a,5), f (1 LOP3), the
# 5-term sum (2 IADD3), rotl(b,30); 64 schedule words at 2 LOP3 + 1 rotl;
# 5 final adds. Loads and byte swaps are not counted.
SHA1_OPS_PER_BLOCK = 80 * 5 + 64 * 3 + 5
# The same for SHA-256 (csrc/sha256_lanes.cu): per round S1 and S0 (3
# funnel shifts + 1 LOP3 each), ch and maj (1 LOP3 each), t1 (2 IADD3),
# e and a (2 adds); 48 schedule words at s0 and s1 (3 shifts + 1 LOP3
# each) and 2 IADD3; 8 final adds.
SHA256_OPS_PER_BLOCK = 64 * 14 + 48 * 10 + 8
# Dependent instructions on one compression's critical path, counted from
# the same sources: SHA-1 2 a round (rotl(a, 5) beside f's LOP3, then one
# IADD3 with e + k + w summed off the path), SHA-256 3 a round (e's funnel
# shifts side by side, S1's LOP3 beside ch's, then one IADD3 with h + K + w
# summed off the path), and the final add. Times the cycles a dependent
# instruction takes (the one-lane profile) and the longest lane's blocks,
# they make the chain floor: no launch can hash that lane faster.
SHA1_CHAIN_PER_BLOCK = 80 * 2 + 1
SHA256_CHAIN_PER_BLOCK = 64 * 3 + 1
# 32-bit integer operations of one component's predict and update for one
# coded bit (index, table read, arithmetic, clamp, write), counted loosely
# from csrc/cm_model.cuh; the CM bound is bytes-bound either way.
CM_OPS_PER_COMPONENT_BIT = 20

# main-path corpora: 16 MiB blocks (membits 24) at -m4 and -m5 are never
# cut; the corpus bytes are sized to the CM kernels' measured rate per lane
# (see PERF.md)
M4_BYTES = 2 << 20
M3_BYTES = 2 << 20
M5_BYTES = 2 << 20
# lanes split over several devices (parallel/dist.py): 16 lanes of 16 KiB
# at -m4 (16 MiB blocks), over the one card named 1, 2 and 4 times
SHARD_LANES = 16
SHARD_LANE_BYTES = 16 << 10
SHARD_KS = (1, 2, 4)
# the multi-host add (parallel/multihost.py), one rank a process, all on
# the one card: method 3.0 (-m3's model and BWT at 1 MiB blocks; one -m4
# block of 16 MiB would be one lane of ~540 s) over 4 MiB of distinct
# text, which makes 4 d blocks; over TCP at 1-3 ranks, over
# torch.distributed (gloo) at 1-2
MH_METHOD = "3.0"
MH_BYTES = 4 << 20
MH_WORLDS = (1, 2, 3)
MH_TORCH_WORLDS = (1, 2)
# backup, testbackup, p and c through the CLI: -m4 over a 256 KiB tree
BACKUP_BYTES = 256 << 10
# hash kernels: 4096 lanes of log-uniform lengths up to 256 KiB (the main
# path hashes files and fragments of 1-175 KiB), held against the plain
# version and hashlib, and timed
HASH_LANES = 4096
HASH_MAX = 256 << 10
# kernel times of the earlier design, one message per thread, on that
# shape (PERF.md, smoke) and on the fragment shape (PERF.md,
# hash_lanes_bench), for reading
ONE_THREAD_HASH_MS = {"sha1": 9.141, "sha256": 11.831}
ONE_THREAD_FRAG_MS = {"sha1": 4.47, "sha256": 5.95}
# every offset 0..63 of a buffer at each of the padding's edge lengths
HASH_EDGES = (0, 1, 55, 56, 63, 64, 65, 119, 120, 128)
# the fragment shape: the fragments of ``t`` over an archive of ~0.6 GB at
# zpaqfranz's default fragment size (64 KiB on average), back to back
FRAG_LANES = 16384
FRAG_MIN, FRAG_MAX = 4 << 10, 128 << 10
# the one-lane profile: one lane of 1 MiB alone
PROFILE_LANE = 1 << 20
# the CRC-32 lane kernel: held against its plain version on a cut shape,
# 1,024 lanes of log-uniform 1-4 KiB, and on the fragment shape, where the
# plain version's few launches a byte step take ~20 s; through
# hash_batched.crc32_lanes on the fragment shape
CRC_CUT_LANES = 1024
CRC_CUT_MIN, CRC_CUT_MAX = 1 << 10, 4 << 10
# Operations of the CRC-32 of one input byte, whatever computes it: its
# extract, its table lookup and its XOR into the register
CRC_OPS_PER_BYTE = 3
# kernel times of the earlier design, one thread a lane (PERF.md, smoke):
# the fragment shape, one 1 MiB lane alone and the cut shape
ONE_THREAD_CRC_MS = {"fragments": 10.151, "one_lane": 61.441, "cut": 0.2692}
# segment sizes the fragment shape is also timed at (the kernel's own is
# hash_batched.CRC_SEG)
CRC_SEGS = (1 << 10, 2 << 10, 4 << 10, 8 << 10, 16 << 10)
# the device BWT: one block of -m3's default block size (16 MiB), text
BWT_BYTES = 16 << 20
# the batched coders at -m4 (16 MiB-block widths): 4 lanes of 16 KiB
BATCHED_LANES = 4
BATCHED_LANE_BYTES = 16 << 10
# the per-bit predictor on the card: 3 lanes of 16 bytes (a few hundred
# torch ops a bit)
PREDICTOR_BYTES = 16
# zfsbackup / zfsrestore at -m4 on a fake zfs: a 128 KiB dataset, backed up
# twice (the second time with a changed tail)
ZFS_BYTES = 128 << 10
# the engine gate's unforced adds: one -m3 lane of text, above the gate's
# 1 MiB job floor
GATE_BYTES = 5 << 18
# CM kernel vs plain: four short lanes per model. The plain version runs a
# few hundred tensor ops per coded bit (~80 ms per decoded byte at -m4), so
# a main-path lane of ~1 MB would take about a day; longer lanes are held
# against the native host decode instead. The CM kernel's time and bound
# come from the -m4 native-check launch (16 MiB-block widths, 64 KiB lane).
CM_PLAIN_SIZES = (30, 70, 110, 160)
CM_NATIVE_LANES = (("4", (8 << 10, 24 << 10, 48 << 10, 64 << 10)),
                   ("5", (16 << 10, 32 << 10)))

# one-lane CM encode rate at -m4 (16 MiB-block widths) of the earlier
# design, one lane per thread: the yardstick of the group design (PERF.md)
ONE_THREAD_M4_KBPS = 11.8
# one-lane rates of the group design with HCOMP always interpreted
# (PERF.md), KB/s, and its profiled HCOMP cycles per byte and share of a
# lane
INTERP_LANE_KBPS = {"3": 82.5, "4": 22.8, "5": 16.4}
INTERP_HCOMP = {"3": (4721, 20.3), "4": (21827, 25.8), "5": (46772, 38.4)}
# The chase (mb_vmem_probe.chase_ns), run at each level before the kernel
# checks: its ns a step price every chain floor below, the CM design's and
# the table-access kernels'. A dependent integer instruction costs
# CHAIN_CYCLES at the SM clock the chase's own cycle count gives.
CHAIN_CYCLES = 4
# Dependent instructions of a floor modulo by n as the work needs it, not as
# a divide compiles: a mask where n is a power of two; else LOP3, IMAD.HI,
# SHF, IMAD, IADD and VIMNMX (csrc/floor_mod.cuh)
FLOOR_MOD_OPS = {True: 1, False: 6}

# table-access microbenchmark kernels: smoke name, module, wrapper key, the
# TPU kernel it replaces
MICRO = (("mb_gather", "mb_access", "gather", "experiments/mb_access.py:47"),
         ("mb_onehot", "mb_access", "onehot", "experiments/mb_access.py:83"),
         ("mb_selwrite", "mb_access", "selwrite",
          "experiments/mb_access.py:121"),
         ("mb_lane_loop", "mb_access", "lane_loop",
          "experiments/mb_access.py:160"),
         ("mb_dma", "mb_access", "dma", "experiments/mb_access.py:198"),
         ("lane_rw_probe", "mb_vmem_probe", "lane_rw",
          "experiments/mb_vmem_probe.py:32"),
         ("lut_probe", "mb_vmem_probe", "lut",
          "experiments/mb_vmem_probe.py:68"))
# 32-bit integer instructions for the operations bound (the JSON line's):
# a fixed count of what the work itself needs, whatever a kernel's design
# issues (loads and stores not counted; the table's staging is counted in
# bytes). Per dependent access: A the index add, the address and the sum's
# add, 3; D four per-byte adds (__vadd4) for the 16 bytes, a mask, an add
# and the address, 8; P1 the index's multiply and two adds, the address,
# four row adds and the accumulator's add and mask, 10; P2 the index add,
# the address and the accumulator's add and mask, 4; A, P1 and P2 also a
# floor modulo each (FLOOR_MOD_OPS). B and C: per access, per 32-bit word of
# the lane's column (an int32 row, or four u8 rows): the load, compare,
# select and add (B) or store (C), 4. E: one per 16 bytes copied and the
# wait, read and add.
MICRO_OPS_PER_ACCESS = {"gather": 3, "lane_loop": 8, "lane_rw": 10, "lut": 4}
MICRO_OPS_PER_WORD = 4
# P1 and P2 at their script's shapes: L = 64 lanes, ITERS = 64
PROBE_L = 64
PROBE_ITERS = 64
# kernel times of the kernels' first design, one thread a lane with a
# runtime divide in every floor modulo and B, C a row at a time (PERF.md,
# kernel table), summed over each kernel's shapes, ms: for reading beside
# the floors
FIRST_MICRO_MS = {"gather": 1.5186, "onehot": 3.2478, "selwrite": 49.216,
                "lane_loop": 0.0235, "dma": 0.0126, "lane_rw": 1.2810,
                "lut": 0.0386}

class SmokeError(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeError(what)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def cuda_ms(torch, fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` runs after one warm-up,
    timed with CUDA events."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def wall_ms(torch, fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def kernel_ms(torch, fn, args, kernel: str, reps: int = 5,
              profiles: int = 3, tries: int = 3) -> float:
    """Device milliseconds of the CUDA kernel named ``kernel`` per launch,
    from ``torch.profiler``: the median, over ``profiles`` profiles of
    ``reps`` calls of ``fn(*args)`` after a warm-up, of each profile's mean
    over the launches it saw; the kernel alone, without the wrapper's
    checks and allocations around it. One profile can read far off (PERF.md
    §6, PR 12: 0.0043 ms for a kernel of 0.0090 ms), which the median of
    three leaves out. Fails if the profiler saw another
    kernel of that name or more launches than calls. Its trace may drop
    records: a profile that saw none is taken again, and after ``tries``
    such profiles with none seen the kernel is timed with CUDA events
    around the whole calls instead (the wrapper's host work included),
    which the log says."""
    from torch.profiler import ProfilerActivity, profile

    fn(*args)
    torch.cuda.synchronize()
    means, empty = [], 0
    while len(means) < profiles and empty < tries:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn(*args)
            torch.cuda.synchronize()
        hits = [e for e in prof.key_averages()
                if kernel in e.key and e.device_time_total > 0]
        check(len(hits) <= 1 and all(e.count <= reps for e in hits),
              f"the profiler saw {[(e.key, e.count) for e in hits]} for "
              f"{kernel}, want at most {reps} launches")
        if hits:
            means.append(hits[0].device_time_total / hits[0].count / 1e3)
        else:
            empty += 1
    if means:
        return statistics.median(means)
    log(f"  (the profiler saw no launch of {kernel} in {tries} profiles: "
        f"timed with CUDA events around the calls)")
    return cuda_ms(torch, lambda: fn(*args), reps)


def bound(nbytes: float, ops: float) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# kernel checks

def hash_messages(np, rng, n: int, top: int) -> list:
    """``n`` seeded messages: the padding's edge lengths, then log-uniform
    lengths up to ``top`` bytes."""
    special = [0, 55, 56, 63, 64, 119, 120]
    lens = special + [int(x) for x in np.exp(rng.uniform(
        0, np.log(top), n - len(special)))]
    return [rng.integers(0, 256, k, dtype=np.uint8).tobytes() for k in lens]


def graphed(torch, dev, fn, *shapes):
    """``fn`` over int64 tensors of ``shapes`` on the card ``dev``, captured
    once as a CUDA graph and replayed for each call: the same kernels,
    without the host's dispatch of each tensor op, which bounds a plain
    hash's block loop. Returns the graph's output tensor, rewritten by the
    next call."""
    args = [torch.zeros(s, dtype=torch.int64, device=dev) for s in shapes]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn(*args)

    def run(*xs):
        for a, x in zip(args, xs):
            a.copy_(x)
        graph.replay()
        return out
    return run


def hash_bounds(np, lens, state: int, ops_per_block: int,
                rounds_ns: float) -> dict:
    """The three terms of a hash launch's least time, in ms, for lanes of
    ``lens`` bytes: its bytes (each message byte, offset and length read
    once, each state written once) over the card's memory rate, its
    instructions over the INT32 rate, and the chain floor: the longest
    lane's blocks at ``rounds_ns`` per block (one lane's rounds alone)."""
    lens = np.asarray(lens, np.int64)
    blocks = (lens + 9 + 63) // 64
    return {"bytes": (int(lens.sum()) + (16 + state) * lens.size)
            / HBM_BYTES_PER_S * 1e3,
            "operations": int(blocks.sum()) * ops_per_block
            / INT32_OPS_PER_S * 1e3,
            "chain": int(blocks.max()) * rounds_ns / 1e6}


def bound_text(b: dict) -> str:
    by = max(b, key=b.get)
    return (f"bound {b[by]:.4f} ms ({by}; " + ", ".join(
        f"{k} {v:.4f}" for k, v in b.items()) + ")")


def check_hash(torch, np, dev, seed: int, algo: str) -> dict:
    """Hold a hash lane kernel (``sha1`` or ``sha256``) against hashlib and
    time it beside its three-term bound (``hash_bounds``) on every shape:
    one 1 MiB lane alone, profiled (``PROFILE``: the cycles a block waits
    for its bytes, builds its words, runs its rounds; the chain's cycles
    per dependent instruction and the SM clock); ``HASH_LANES`` lanes of
    log-uniform lengths, also against the plain version (its block loop
    with the compression replayed as a CUDA graph, ``graphed``) and
    profiled, with the host-to-device copy pageable and pinned; every
    offset 0..63 at the padding's edge lengths; messages that end on the
    last byte of a tensor of 4,099 bytes; and the fragment shape."""
    from zpaqfranz_tpu_torch.ops import sha1, sha256

    mod, ops_per_block, chain_per_block, ref = {
        "sha1": (sha1, SHA1_OPS_PER_BLOCK, SHA1_CHAIN_PER_BLOCK,
                 hashlib.sha1),
        "sha256": (sha256, SHA256_OPS_PER_BLOCK, SHA256_CHAIN_PER_BLOCK,
                   hashlib.sha256)}[algo]
    lanes = getattr(mod, f"{algo}_lanes")
    state = ref().digest_size
    rng = np.random.default_rng(seed)

    def launch_ms(*args) -> float:
        """The kernel alone: CUDA events around launches of one prepared
        launch (the wrapper's checks and plan done once)."""
        job = sha1.HashLaunch(f"{algo}_lanes", len(mod._IV), *args)
        return cuda_ms(torch, job.run, 5)

    def digests_ok(data, off, length, want, what: str, profile=None):
        got = lanes(data, off, length, profile)
        check(sha1.to_digests(got) == want,
              f"{algo} kernel differs from hashlib ({what})")
        return got

    def profiled(data, off, length, want, what: str) -> dict:
        prof = torch.zeros(len(sha1.PROFILE), dtype=torch.int64, device=dev)
        digests_ok(data, off, length, want, what, prof)
        return dict(zip(sha1.PROFILE, prof.tolist()))

    def per_block(p: dict) -> str:
        k = p["blocks"]
        return (f"consumer {p['total'] / k:.0f} cycles a block = wait for "
                f"the schedule {p['wait'] / k:.0f} + rounds "
                f"{p['rounds'] / k:.0f}; producer: wait for a free buffer "
                f"and the bytes {p['bytes'] / k:.0f}, words, schedule and "
                f"copies {p['words'] / k:.0f}")

    # one lane alone: the chain's cycles on this card. The profiled launch
    # gives the SM clock and the rounds' share of the consumer's cycles;
    # the rounds' time a block is that share of the plain launch's.
    one = rng.bytes(PROFILE_LANE)
    args = sha1.pack_messages([one], dev)
    want = [ref(one).digest()]
    p = profiled(*args, want, "one lane")
    prof = torch.zeros(len(sha1.PROFILE), dtype=torch.int64, device=dev)
    prof_ms = launch_ms(*args, prof)
    one_ms = launch_ms(*args)
    clock_ghz = p["total"] / (prof_ms * 1e6)
    rounds_ns = one_ms * 1e6 / p["blocks"] * p["rounds"] / p["total"]
    log(f"{algo} one lane of {PROFILE_LANE} bytes alone: kernel {one_ms:.3f} "
        f"ms ({p['blocks']} blocks, {one_ms * 1e6 / p['blocks']:.0f} ns a "
        f"block, the rounds {rounds_ns:.0f}; profiled {prof_ms:.3f} ms, SM "
        f"clock {clock_ghz:.3f} GHz); {per_block(p)}; the rounds' chain "
        f"{rounds_ns * clock_ghz / chain_per_block:.2f} cycles per dependent "
        f"instruction ({chain_per_block} a block)")

    # HASH_LANES log-uniform lanes: plain, hashlib, profile, copies
    msgs = hash_messages(np, rng, HASH_LANES, HASH_MAX)
    want = [ref(m).digest() for m in msgs]
    data, off, length = sha1.pack_messages(msgs, dev)
    # host -> device: the copy alone from pageable and pinned memory, and
    # the whole staging of the messages, pageable (join, copy, a pageable
    # copy) and as stage_bytes does it (the first call allocates its
    # pinned block, later ones reuse it)
    flat = data.cpu()
    h2d_ms = wall_ms(torch, lambda: flat.to(dev))
    pinned = flat.pin_memory()
    pin_ms = wall_ms(torch, lambda: pinned.to(dev, non_blocking=True))
    del pinned
    join_ms = wall_ms(torch, lambda: torch.from_numpy(np.frombuffer(
        b"".join(msgs), np.uint8).copy()).to(dev))
    stage_ms = [wall_ms(torch, lambda: sha1.stage_bytes(msgs, dev))
                for _ in range(3)]
    got = digests_ok(data, off, length, want, f"{HASH_LANES} lanes")
    p = profiled(data, off, length, want, f"{HASH_LANES} lanes")
    ms = launch_ms(data, off, length)
    call_ms = cuda_ms(torch, lambda: lanes(data, off, length), 5)
    compress = graphed(torch, dev, mod._compress, (len(msgs), len(mod._IV)),
                       (len(msgs), 16))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain = sha1.plain_lanes(mod._IV, compress, data, off, length)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = int((got.view(torch.int32).long() & 0xFFFFFFFF).sub(
        plain.view(torch.int32).long() & 0xFFFFFFFF).abs().max())
    check(err == 0, f"{algo} kernel differs from its plain version")
    lens = [len(m) for m in msgs]
    b = hash_bounds(np, lens, state, ops_per_block, rounds_ns)
    nbytes = sum(lens)
    log(f"{algo}_lanes: {len(msgs)} lanes, {nbytes} bytes, log-uniform up "
        f"to {HASH_MAX}: kernel {ms:.3f} ms ({nbytes / ms / 1e6:.2f} GB/s; "
        f"one message per thread: {ONE_THREAD_HASH_MS[algo]} ms), {bound_text(b)}; wrapper call "
        f"{call_ms:.3f} ms; longest lane in the launch: {per_block(p)}; "
        f"host->device copy alone pageable {h2d_ms:.2f} ms, pinned "
        f"{pin_ms:.2f} ms; staging the messages pageable (join, copy, "
        f"pageable copy) {join_ms:.2f} ms, stage_bytes (gather into pinned "
        f"memory, copy) {stage_ms[0]:.2f} ms first, "
        f"{min(stage_ms[1:]):.2f} ms reusing its block; plain "
        f"{plain_ms:.1f} ms (compression as a CUDA graph); digests match "
        f"plain and hashlib")
    b_ms, b_by = bound(nbytes + (16 + state) * len(msgs),
                       sum((n + 9 + 63) // 64 for n in lens) * ops_per_block)

    # every offset 0..63 at the padding's edge lengths, one buffer of 1,001
    # bytes
    buf = rng.bytes(1001)
    spans = [(o, n) for o in range(64) for n in HASH_EDGES]
    data = torch.frombuffer(bytearray(buf), dtype=torch.uint8).to(dev)
    off = torch.tensor([o for o, _ in spans], dtype=torch.int64, device=dev)
    length = torch.tensor([n for _, n in spans], dtype=torch.int64,
                          device=dev)
    digests_ok(data, off, length, [ref(buf[o:o + n]).digest()
                                   for o, n in spans], "offsets 0..63")
    edge_ms = launch_ms(data, off, length)
    b_edge = hash_bounds(np, [n for _, n in spans], state, ops_per_block,
                         rounds_ns)
    # messages ending on the last byte of a 4,099-byte view at offset 5
    big = torch.frombuffer(bytearray(rng.bytes(5000)), dtype=torch.uint8)
    data = big.to(dev)[5:5 + 4099]
    tail = [1, 15, 16, 64, 65, 4099]
    host = big[5:5 + 4099].numpy().tobytes()
    digests_ok(data, torch.tensor([4099 - n for n in tail], dtype=torch.int64,
                                  device=dev),
               torch.tensor(tail, dtype=torch.int64, device=dev),
               [ref(host[-n:]).digest() for n in tail], "end of data")
    log(f"{algo}_lanes: every offset 0..63 at lengths {list(HASH_EDGES)} "
        f"({len(spans)} lanes): kernel {edge_ms:.4f} ms, "
        f"{bound_text(b_edge)}; messages of {tail} bytes ending on the last "
        f"byte of a 4,099-byte view: digests match hashlib")

    # the fragment shape, back to back
    lens = np.exp(rng.uniform(np.log(FRAG_MIN), np.log(FRAG_MAX),
                              FRAG_LANES)).astype(np.int64)
    frag = rng.bytes(int(lens.sum()))
    ends = np.cumsum(lens)
    view = memoryview(frag)
    want = [ref(view[e - n:e]).digest() for e, n in zip(ends, lens)]
    data = sha1.stage_bytes([frag], dev)
    off = torch.from_numpy(ends - lens).to(dev)
    length = torch.from_numpy(lens).to(dev)
    digests_ok(data, off, length, want, "fragments")
    frag_ms = launch_ms(data, off, length)
    b_frag = hash_bounds(np, lens, state, ops_per_block, rounds_ns)
    log(f"{algo}_lanes: fragments, {FRAG_LANES} lanes of log-uniform "
        f"{FRAG_MIN}-{FRAG_MAX} bytes, {len(frag)} bytes: kernel "
        f"{frag_ms:.3f} ms ({len(frag) / frag_ms / 1e6:.2f} GB/s; one message "
        f"per thread: {ONE_THREAD_FRAG_MS[algo]} ms), {bound_text(b_frag)}; digests match "
        f"hashlib")
    del frag, view, data
    return {"name": f"{algo}_lanes", "route": "cuda",
            "source": f"zpaqfranz_tpu_torch/csrc/{algo}_lanes.cu",
            "replaces": "zpaqfranz_tpu/ops/hash_pallas.py:216",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}


def fragment_shape(np, seed: int) -> tuple:
    """The fragment shape's lane lengths and bytes, back to back."""
    rng = np.random.default_rng(seed)
    lens = np.exp(rng.uniform(np.log(FRAG_MIN), np.log(FRAG_MAX),
                              FRAG_LANES)).astype(np.int64)
    return lens, rng.bytes(int(lens.sum()))


def crc_words(torch, t) -> list:
    """A uint32 tensor's values as Python ints."""
    return (t.view(torch.int32).long() & 0xFFFFFFFF).tolist()


def check_crc(torch, np, dev, seed: int, lens, frag) -> dict:
    """Hold the CRC-32 lane kernel bit for bit against its plain version
    (``hash_batched.crc32_plain``, on the card) and ``native.crc32``, each
    shape timed beside the one-thread design's (``ONE_THREAD_CRC_MS``):
    one aligned segment alone, profiled (the cycles of one warp's row of
    ``hash_batched.CRC_ROW`` bytes: the chain's step); one lane of 1 MiB
    alone (with its combine's profiled cycles); a cut shape of
    ``CRC_CUT_LANES`` lanes; the fragment shape, timed beside its bound
    (bytes; operations at ``CRC_OPS_PER_BYTE``) and its chain floor (the
    longest segment's rows at the step alone, plus the longest lane's
    combine alone), split into the plan and the two kernels, again on zero
    bytes (every table lookup the same word: no bank conflicts, whatever
    the tables' layout) and at each of ``CRC_SEGS``, with segment 0's
    cycles a row under load. Returns the JSON entry and the fragments'
    CRCs."""
    from zpaqfranz_tpu_torch import native
    from zpaqfranz_tpu_torch.ops import hash_batched as hb, sha1

    rng = np.random.default_rng(seed)
    seg = hb.CRC_SEG

    def launch_ms(data, off, length, s=seg) -> float:
        """The kernel alone: CUDA events around launches with the plan
        built once."""
        return cuda_ms(torch, hb.CrcLaunch(data, off, length, s).run, 5)

    def device_ms(launch) -> tuple:
        """The two kernels' device times (``torch.profiler``): where the
        kernels take microseconds, CUDA events around the calls time the
        host's launches instead."""
        return tuple(kernel_ms(torch, launch.run, (), k)
                     for k in ("crc32_segments", "crc32_combine"))

    def sweep(what: str, data, off, length, want) -> None:
        """The kernels' device time at each of ``CRC_SEGS``, the CRCs
        equal to ``want``."""
        times = {}
        for s in CRC_SEGS:
            launch = hb.CrcLaunch(data, off, length, s)
            times[s] = sum(device_ms(launch))
            check(crc_words(torch, launch.out) == want, f"crc32 kernel "
                  f"differs from native.crc32 ({what}, segments of {s})")
        log(f"crc32_lanes: {what}, the kernels' device time at each "
            f"segment size: " + ", ".join(f"{s} bytes {t:.4f} ms"
                                          for s, t in times.items()))

    def profiled(data, off, length) -> list:
        prof = torch.zeros(len(hb.CRC_PROFILE), dtype=torch.int64,
                           device=dev)
        hb.CrcLaunch(data, off, length, profile=prof).run()
        return prof.tolist()

    def against_plain(data, off, length, what: str) -> tuple:
        got = hb.crc32_flat(data, off, length)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain = hb.crc32_plain(data, off, length)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        err = max(abs(a - b) for a, b in zip(crc_words(torch, got),
                                             crc_words(torch, plain)))
        check(err == 0, f"crc32 kernel differs from its plain version "
              f"({what})")
        return got, err, plain_ms

    # one aligned segment alone: the cycles of one row, the chain's step
    buf = torch.from_numpy(np.frombuffer(bytearray(rng.bytes(3 * seg)),
                                         np.uint8)).to(dev)
    start = (-buf.data_ptr()) % seg
    aligned = (buf, torch.tensor([start], device=dev),
               torch.tensor([seg], device=dev))
    cycles, pieces, _, _ = profiled(*aligned)
    check(pieces == seg // 16, f"the aligned segment ran {pieces} pieces")
    row_cyc = cycles / (seg // hb.CRC_ROW)
    check(crc_words(torch, hb.crc32_flat(*aligned)) == [native.crc32(
        buf[start:start + seg].cpu().numpy().tobytes())],
        "crc32 kernel differs from native.crc32 (one segment)")
    log(f"crc32_lanes one aligned segment of {seg} bytes alone, profiled: "
        f"{cycles} cycles over {seg // hb.CRC_ROW} rows of {hb.CRC_ROW} "
        f"bytes = {row_cyc:.1f} cycles a row ({cycles / seg:.2f} a byte, "
        f"one warp) at {SM_CLOCK_HZ / 1e9:.2f} GHz")

    one = rng.bytes(PROFILE_LANE)
    data, off, length = sha1.pack_messages([one], dev)
    check(crc_words(torch, hb.crc32_flat(data, off, length))
          == [native.crc32(one)], "crc32 kernel differs from native.crc32 "
          "(one lane)")
    launch = hb.CrcLaunch(data, off, length)
    one_ms = cuda_ms(torch, launch.run, 5)
    dev_ms = device_ms(launch)
    _, _, comb, segs = profiled(data, off, length)
    log(f"crc32_lanes one lane of {PROFILE_LANE} bytes alone: {segs} "
        f"segments of {seg} bytes, a group of {launch.group} threads "
        f"combines them in {comb} cycles; kernel {one_ms:.4f} ms (CUDA "
        f"events), on the device segments {dev_ms[0]:.4f} + combine "
        f"{dev_ms[1]:.4f} ms ({PROFILE_LANE / sum(dev_ms) / 1e6:.2f} GB/s; "
        f"one thread a lane: {ONE_THREAD_CRC_MS['one_lane']} ms, "
        f"{ONE_THREAD_CRC_MS['one_lane'] / sum(dev_ms):.0f}x)")
    sweep("one lane", data, off, length, [native.crc32(one)])

    cut = np.exp(rng.uniform(np.log(CRC_CUT_MIN), np.log(CRC_CUT_MAX),
                             CRC_CUT_LANES)).astype(np.int64)
    msgs = [rng.bytes(int(n)) for n in cut]
    data, off, length = sha1.pack_messages(msgs, dev)
    got, _, cut_plain_ms = against_plain(data, off, length, "cut shape")
    check(crc_words(torch, got) == [native.crc32(m) for m in msgs],
          "crc32 kernel differs from native.crc32 (cut shape)")
    cut_ms = launch_ms(data, off, length)
    dev_ms = device_ms(hb.CrcLaunch(data, off, length))
    call_ms = min(wall_ms(torch, lambda: hb.crc32_flat(data, off, length))
                  for _ in range(3))
    log(f"crc32_lanes: {CRC_CUT_LANES} lanes of log-uniform {CRC_CUT_MIN}-"
        f"{CRC_CUT_MAX} bytes: kernel {cut_ms:.4f} ms (CUDA events), on "
        f"the device segments {dev_ms[0]:.4f} + combine {dev_ms[1]:.4f} ms "
        f"(one thread a lane: {ONE_THREAD_CRC_MS['cut']} ms), the call "
        f"with its plan and host sync {call_ms:.3f} ms, plain "
        f"{cut_plain_ms:.1f} ms; equal to the plain version and "
        f"native.crc32")
    sweep("cut shape", data, off, length, crc_words(torch, got))

    ends = np.cumsum(lens)
    t0 = time.perf_counter()
    want = [native.crc32(frag[e - n:e]) for e, n in zip(ends, lens)]
    native_s = time.perf_counter() - t0
    data = sha1.stage_bytes([frag], dev)
    off = torch.from_numpy(ends - lens).to(dev)
    length = torch.from_numpy(lens).to(dev)
    got, err, plain_ms = against_plain(data, off, length, "fragments")
    check(crc_words(torch, got) == want,
          "crc32 kernel differs from native.crc32 (fragments)")
    plan_ms = min(wall_ms(torch, lambda: hb.CrcLaunch(data, off, length))
                  for _ in range(3))
    launch = hb.CrcLaunch(data, off, length)
    ms = cuda_ms(torch, launch.run, 5)
    seg_ms, comb_ms = device_ms(launch)
    cycles, pieces, _, _ = profiled(data, off, length)
    longest = int(np.argmax(lens))
    _, _, comb, segs = profiled(data, off[longest:longest + 1],
                                length[longest:longest + 1])
    zeros = torch.zeros_like(data)
    check(crc_words(torch, hb.crc32_flat(zeros, off, length)) == [
        native.crc32(bytes(int(n))) for n in lens],
        "crc32 kernel differs from native.crc32 (fragments of zeros)")
    zero_ms = launch_ms(zeros, off, length)
    del zeros
    nbytes = int(lens.sum())
    chain_ms = ((seg // hb.CRC_ROW) * row_cyc + comb) / SM_CLOCK_HZ * 1e3
    b = {"bytes": (nbytes + 20 * len(lens)) / HBM_BYTES_PER_S * 1e3,
         "operations": nbytes * CRC_OPS_PER_BYTE / INT32_OPS_PER_S * 1e3}
    b_ms, b_by = bound(nbytes + 20 * len(lens), nbytes * CRC_OPS_PER_BYTE)
    log(f"crc32_lanes: fragments, {FRAG_LANES} lanes, {nbytes} bytes, "
        f"{launch.segments} segments of {seg} bytes, groups of "
        f"{launch.group}: kernel {ms:.4f} ms ({nbytes / ms / 1e6:.2f} GB/s, "
        f"{b_ms / ms:.1%} of the {bound_text(b)}; one thread a lane: "
        f"{ONE_THREAD_CRC_MS['fragments']} ms, "
        f"{ONE_THREAD_CRC_MS['fragments'] / ms:.1f}x); profiled: segments "
        f"{seg_ms:.4f} ms + combine {comb_ms:.4f} ms; the plan (torch ops "
        f"and the host sync) {plan_ms:.3f} ms; chain floor {chain_ms:.4f} "
        f"ms ({seg // hb.CRC_ROW} rows at {row_cyc:.1f} cycles + the "
        f"longest lane's combine, {segs} segments, {comb} cycles); segment 0 "
        f"under load {cycles * hb.CRC_ROW / max(16 * pieces, 1):.1f} cycles "
        f"a row; on zero bytes (every lookup one word) {zero_ms:.4f} ms; "
        f"plain {plain_ms:.1f} ms; "
        f"native.crc32 on the host {native_s * 1e3:.1f} ms; equal to the "
        f"plain version and native.crc32")
    sweep("fragments", data, off, length, want)
    del data
    return {"name": "crc32_lanes", "route": "cuda",
            "source": "zpaqfranz_tpu_torch/csrc/crc32_lanes.cu",
            "replaces": "zpaqfranz_tpu/ops/hash_batched.py:212",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}, want


def lane_payloads(np, rng, sizes) -> list:
    words = [b"the", b"cat", b"sat", b"on", b"mat", b"zpaq", b"lane",
             b"block", b"1234", b"\n", b"context", b"mixing"]
    out = []
    for n in sizes:
        idx = rng.zipf(1.5, n) % len(words)
        text = b" ".join(words[i] for i in idx)[: n // 2]
        out.append(text + rng.integers(0, 256, n - len(text),
                                       dtype=np.uint8).tobytes()[: n // 8]
                   + text[: n - len(text) - n // 8])
    return out


def cm_touch_bytes(model, nbytes: int) -> int:
    """Least global-memory bytes a CM kernel reads and writes to code
    ``nbytes`` bytes of one lane, each byte counted once per use, from
    ``predict``/``update`` in csrc/cm_model.cuh. Per coded bit: CM and MIX2
    read and write one u32; ICM one state byte and one u32 counter; ISSE one
    state byte and two u32 weights; MIX m u32 weights; SSE reads two u32 and
    writes one; MATCH reads one history byte and rewrites another. Per byte:
    one check byte per ICM/ISSE probe (two probes), the MATCH pointer read
    and written, and the n context hashes read from H."""
    from zpaqfranz_tpu_torch.models import tables as T

    per_bit = {T.CM: 8, T.MIX2: 8, T.ICM: 10, T.ISSE: 18, T.SSE: 12,
               T.MATCH: 3}
    per_byte = {T.ICM: 2, T.ISSE: 2, T.MATCH: 8}
    bit = sum(8 * cp[3] if cp[0] == T.MIX else per_bit.get(cp[0], 0)
              for cp in model.comps)
    byte = 4 * model.n + sum(per_byte.get(cp[0], 0) for cp in model.comps)
    return nbytes * (8 * bit + byte)


def timed_cm(torch, launch, model, packed, hcomp=None) -> tuple:
    """Code through one prepared launch of a CM kernel (``launch`` is
    ``cm_decode.Launch`` or ``cm_encode.Launch``) with HCOMP step ``hcomp``
    (None: specialised where the program allows). Returns the lanes' bytes,
    the state set-up's milliseconds (host clock: the arenas' initial rows,
    copied to the card for every lane) and the launch's alone (CUDA
    events)."""
    from zpaqfranz_tpu_torch.ops.cm_model import lanes_to_bytes

    t0 = time.perf_counter()
    job = launch(model, *packed, hcomp=hcomp)
    check(job.hcomp == (hcomp or "fast"),
          f"the launch runs HCOMP step {job.hcomp}, not {hcomp or 'fast'}")
    torch.cuda.synchronize()
    setup_ms = (time.perf_counter() - t0) * 1e3
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    job.run()
    b.record()
    torch.cuda.synchronize()
    return lanes_to_bytes(*job.result()), setup_ms, a.elapsed_time(b)


def byte_err(np, a: list, b: list) -> int:
    """Largest absolute difference between the bytes of paired lanes."""
    err = 0
    for x, y in zip(a, b):
        n = min(len(x), len(y))
        d = np.abs(np.frombuffer(x[:n], np.uint8).astype(np.int64)
                   - np.frombuffer(y[:n], np.uint8).astype(np.int64))
        err = max(err, int(d.max()) if d.size else 0)
    return err


def cm_models() -> dict:
    """The CM kernels' check models: -m3, -m4 and -m5 at 1 MiB blocks
    ("4.0", "5.0"), all component types, and the main path's -m4 and -m5
    (16 MiB blocks)."""
    from zpaqfranz_tpu_torch.codec.methods import (ALL_COMPONENTS_CFG,
                                                   make_model)
    from zpaqfranz_tpu_torch.zpaql.compiler import compile_config

    models = {m: make_model(m)[0] for m in ("3", "4.0", "5.0", "4", "5")}
    models["all-components"] = compile_config(ALL_COMPONENTS_CFG)[0]
    return models


def chase_steps(torch, dev) -> dict:
    """ns of one step of the bare dependent chase at each level
    (``mb_vmem_probe.chase_ns``), of a read of the word the thread's own
    last store wrote to L2 ("l2_rw"), and under "ghz" the SM clock that the
    shared chase's own cycle count gives over the same span."""
    from zpaqfranz_tpu_torch.experiments import mb_vmem_probe as mp

    steps = {}
    for level in mp.CHASE:
        ns, cycles = mp.chase_ns(level, dev)
        steps[level] = ns
        if level == "shared":
            steps["ghz"] = cycles / ns
        nbytes, stride, n = mp.CHASE[level]
        log(f"chase [{level}]: {ns:.3f} ns a step ({cycles:.1f} cycles), "
            f"{n} and {2 * n} steps over a ring of {nbytes} bytes, an entry "
            f"every {stride} bytes")
    ns, cycles = mp.chase_ns("l2_rw", dev)
    steps["l2_rw"] = ns
    words, apart, n = mp.CHASE_RW
    log(f"chase [l2_rw]: {ns:.3f} ns ({cycles:.1f} cycles) a read of the "
        f"word the thread's last store wrote to L2 and the store, "
        f"{ns / steps['l2']:.3f} L2 steps; {n} and {2 * n} steps over "
        f"{words} words {apart} bytes apart")
    log(f"  SM clock under the chase: {steps['ghz']:.4f} GHz; a dependent "
        f"integer instruction {CHAIN_CYCLES / steps['ghz']:.3f} ns")
    return steps


def chain_floor_ns(model, steps: dict) -> float:
    """Per-bit chain that the access costs give the CM kernels' design, for
    reading beside the measured time, not a bound: one dependent L2 access
    (phase (a)'s early reads), then one shared-memory step for phase (a)'s
    table read, one per component of the combine on thread 0 (AVG, MIX2,
    MIX, ISSE, SSE), and two for the coder's bit and the update; each
    priced at this run's chase (``chase_steps``)."""
    from zpaqfranz_tpu_torch.models import tables as T

    combine = sum(cp[0] in (T.AVG, T.MIX2, T.MIX, T.ISSE, T.SSE)
                  for cp in model.comps)
    return steps["l2"] + steps["shared"] * (combine + 3)


def placement_line(model, name: str) -> str:
    """The placement of a launch of ``model`` (its HCOMP step's), beside
    the interpreter's."""
    from zpaqfranz_tpu_torch.ops.cm_model import (Placement, hcomp_step,
                                                  table_words)

    step = hcomp_step(model)
    p = Placement(model, step)
    pi = Placement(model)
    tables = (step == "interp") + sum(1 for cp in model.comps
                                      if table_words(cp))
    return (f"placement [{name}], HCOMP {step}: n={model.n}, G={p.G}, "
            f"{p.lanes_per_block} lanes/block, {p.smem} shared bytes/block "
            f"({4 * p.lane_words} per lane), {len(p.shared)} of {tables} "
            f"tables in shared memory (interpreted: {pi.lanes_per_block} "
            f"lanes/block, {4 * pi.lane_words} bytes per lane with H)")


def check_cm(torch, np, dev, seed: int) -> dict:
    from zpaqfranz_tpu_torch import native
    from zpaqfranz_tpu_torch.ops import cm_decode as cmd
    from zpaqfranz_tpu_torch.parallel.engine import (coded_stream,
                                                     parse_block_payload,
                                                     selector)

    rng = np.random.default_rng(seed)
    models = cm_models()
    err = 0
    plain_ms = None
    # kernel vs plain, 4 short lanes of mixed lengths per model; "4" and "5"
    # are the main path's -m4 and -m5 models (16 MiB blocks)
    for name in ("3", "4.0", "5.0", "all-components", "4", "5"):
        model = models[name]
        log(placement_line(model, name))
        pays = lane_payloads(np, rng, CM_PLAIN_SIZES)
        streams = [coded_stream(model, p) for p in pays]
        caps = [len(p) + 4096 for p in pays]
        packed = cmd.pack_streams(streams, caps, dev)
        a, setup_ms, k_ms = timed_cm(torch, cmd.Launch, model, packed)
        ai, _, ki_ms = timed_cm(torch, cmd.Launch, model, packed, "interp")
        t0 = time.perf_counter()
        plain = cmd.cm_decode_plain(model, *packed)
        torch.cuda.synchronize()
        p_ms = (time.perf_counter() - t0) * 1e3
        b = cmd.lanes_to_bytes(*plain)
        err = max(err, byte_err(np, a, b), byte_err(np, ai, b))
        check(a == b, f"CM kernel differs from its plain version ({name})")
        check(ai == a, f"CM kernel's HCOMP steps differ ({name})")
        check(a == [selector(model) + p for p in pays],
              f"CM kernel output is not the coded payload ({name})")
        log(f"cm_decode vs plain [{name}]: {len(pays)} lanes "
            f"{sum(map(len, pays))} bytes, n={model.n}, "
            f"{cmd.lane_bytes(model, 'fast')} state bytes/lane "
            f"({cmd.lane_bytes(model)} interpreted): state set-up "
            f"{setup_ms:.1f} ms, kernel launch {k_ms:.3f} ms (HCOMP "
            f"interpreted {ki_ms:.3f} ms), plain {p_ms:.0f} ms, identical")
        if name == "4":
            plain_ms = p_ms
    # kernel vs the native host decode, longer lanes at the main path's
    # widths; the -m4 launch gives the kernel's time and bound
    timing = None
    for name, sizes in CM_NATIVE_LANES:
        model = models[name]
        pays = lane_payloads(np, rng, sizes)
        blocks = [native.compress_block(model, p, b"t", b"c") for p in pays]
        streams = [parse_block_payload(b, 0)[2] for b in blocks]
        packed = cmd.pack_streams(streams, [len(p) + 8192 for p in pays], dev)
        got, setup_ms, k_ms = timed_cm(torch, cmd.Launch, model, packed)
        gi, _, ki_ms = timed_cm(torch, cmd.Launch, model, packed, "interp")
        check(gi == got, f"CM kernel's HCOMP steps differ ({name})")
        for g, blk, p in zip(got, blocks, pays):
            with native.NativeStream(blk) as s:
                host = b"".join(seg.data for seg in s.read_block())
            check(host == p, "native host decode does not restore payload")
            check(native.postprocess(model.ph, model.pm, g,
                                     out_hint=len(p)) == host,
                  f"CM kernel differs from the native host decode ({name})")
        out_bytes = sum(map(len, got))
        log(f"cm_decode vs native [{name}]: {len(pays)} lanes "
            f"{sum(sizes)} bytes, n={model.n}, "
            f"{cmd.lane_bytes(model, 'fast')} state bytes/lane: state set-up "
            f"{setup_ms:.1f} ms, kernel launch {k_ms:.1f} ms "
            f"({max(sizes) / k_ms:.2f} KB/s for the longest lane; HCOMP "
            f"interpreted {ki_ms:.1f} ms, {max(sizes) / ki_ms:.2f} KB/s; "
            f"{cm_touch_bytes(model, 1)} bytes touched per decoded byte), "
            f"identical")
        if name == "4":
            timing = (model, sum(map(len, streams)), out_bytes, k_ms)
    model, in_bytes, out_bytes, ms = timing
    b_ms, b_by = bound(in_bytes + out_bytes + 4 * cmd.lut("cpu").numel()
                       + cm_touch_bytes(model, out_bytes),
                       8 * out_bytes * model.n * CM_OPS_PER_COMPONENT_BIT)
    return {"name": "cm_decode", "route": "cuda",
            "source": "zpaqfranz_tpu_torch/csrc/cm_decode.cu",
            "replaces": "zpaqfranz_tpu/ops/codec_arena.py:830",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}


def check_cm_encode(torch, np, dev, seed: int, steps: dict) -> dict:
    """Hold the CM encode kernel against its plain version and the native
    engine's coded segments; time it on the -m4 native-check launch."""
    from zpaqfranz_tpu_torch.ops import cm_decode as cmd, cm_encode as cme
    from zpaqfranz_tpu_torch.parallel.engine import coded_stream, selector

    rng = np.random.default_rng(seed)
    models = cm_models()
    err = 0
    plain_ms = None
    # kernel vs plain, 4 short lanes of mixed lengths per model
    for name in ("3", "4.0", "5.0", "all-components", "4", "5"):
        model = models[name]
        pays = lane_payloads(np, rng, CM_PLAIN_SIZES)
        packed = cme.pack_payloads([selector(model) + p for p in pays], dev)
        a, setup_ms, k_ms = timed_cm(torch, cme.Launch, model, packed)
        ai, _, ki_ms = timed_cm(torch, cme.Launch, model, packed, "interp")
        t0 = time.perf_counter()
        plain = cme.cm_encode_plain(model, *packed)
        torch.cuda.synchronize()
        p_ms = (time.perf_counter() - t0) * 1e3
        b = cmd.lanes_to_bytes(*plain)
        err = max(err, byte_err(np, a, b), byte_err(np, ai, b))
        check(a == b, f"CM encode kernel differs from its plain version "
              f"({name})")
        check(ai == a, f"CM encode kernel's HCOMP steps differ ({name})")
        check(a == [coded_stream(model, p)[:-6] for p in pays],
              f"CM encode kernel differs from the native engine ({name})")
        log(f"cm_encode vs plain [{name}]: {len(pays)} lanes "
            f"{sum(map(len, pays))} bytes -> {sum(map(len, a))} coded, "
            f"n={model.n}: state set-up {setup_ms:.1f} ms, kernel launch "
            f"{k_ms:.3f} ms (HCOMP interpreted {ki_ms:.3f} ms), plain "
            f"{p_ms:.0f} ms, identical to plain and native")
        if name == "4":
            plain_ms = p_ms
    # kernel vs the native engine, longer lanes at the main path's widths;
    # the -m4 launch gives the kernel's time and bound
    timing = None
    for name, sizes in CM_NATIVE_LANES:
        model = models[name]
        pays = [selector(model) + p for p in lane_payloads(np, rng, sizes)]
        packed = cme.pack_payloads(pays, dev)
        got, setup_ms, k_ms = timed_cm(torch, cme.Launch, model, packed)
        gi, _, ki_ms = timed_cm(torch, cme.Launch, model, packed, "interp")
        want = [coded_stream(model, p[len(selector(model)):])[:-6]
                for p in pays]
        check(got == want and gi == want,
              f"CM encode kernel differs from the native engine ({name})")
        in_bytes = sum(map(len, pays))
        log(f"cm_encode vs native [{name}]: {len(pays)} lanes {in_bytes} "
            f"bytes -> {sum(map(len, got))} coded, n={model.n}: state set-up "
            f"{setup_ms:.1f} ms, kernel launch {k_ms:.1f} ms "
            f"({max(map(len, pays)) / k_ms:.2f} KB/s for the longest lane; "
            f"HCOMP interpreted {ki_ms:.1f} ms, "
            f"{max(map(len, pays)) / ki_ms:.2f} KB/s), identical")
        if name == "4":
            timing = (model, in_bytes, sum(map(len, got)), k_ms)
            top = max(map(len, pays))
            log(f"-m4 one lane: {top / k_ms:.2f} KB/s per lane, "
                f"{k_ms * 1e3 / (8 * top):.3f} us per bit (HCOMP "
                f"interpreted: {top / ki_ms:.2f} KB/s, "
                f"{top / k_ms / (top / ki_ms):.2f}x; one lane per "
                f"thread: {ONE_THREAD_M4_KBPS} KB/s, "
                f"{1e3 / (8 * ONE_THREAD_M4_KBPS):.2f} us per bit; "
                f"{top / k_ms / ONE_THREAD_M4_KBPS:.2f}x); chain floor of "
                f"the design {chain_floor_ns(model, steps) / 1e3:.3f} us per "
                f"bit (one L2 access and shared steps at this run's chase; "
                f"for reading, not a bound)")
    model, in_bytes, out_bytes, ms = timing
    b_ms, b_by = bound(in_bytes + out_bytes + 4 * cmd.lut("cpu").numel()
                       + cm_touch_bytes(model, in_bytes),
                       8 * in_bytes * model.n * CM_OPS_PER_COMPONENT_BIT)
    return {"name": "cm_encode", "route": "cuda",
            "source": "zpaqfranz_tpu_torch/csrc/cm_encode.cu",
            "replaces": "zpaqfranz_tpu/ops/codec_arena.py:915",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}


# one lane per model for the per-lane rates and the profiled breakdown of a
# bit: -m3 (4 KiB, as the ladder's lanes), -m4 and -m5 at 16 MiB-block
# widths
CM_PROFILE_LANES = (("3", 4 << 10), ("4", 16 << 10), ("5", 16 << 10))


def profile_cm(torch, np, dev, seed: int) -> dict:
    """One lane per model through the CM encode kernel, with the
    specialised HCOMP step and with the interpreter: its rate (CUDA events,
    a launch of its own) and, from a profiled launch of the same lane
    (``LaneLaunch(profile=True)``: thread 0's clock counters per phase),
    the cycles of a bit in each phase and HCOMP's cycles per byte and share
    of the lane's time, beside the interpreter design's (PERF.md). Every
    launch must code as the native engine does. At -m4 also the decode
    kernel and the plain HCOMP step (``FastHcomp.run`` over the lane's
    bytes, on the CPU): returns the specialised HCOMP step's measurements
    in the two kernels there."""
    from zpaqfranz_tpu_torch.ops import cm_decode as cmd, cm_encode as cme
    from zpaqfranz_tpu_torch.ops.cm_model import PROFILE, lanes_to_bytes
    from zpaqfranz_tpu_torch.ops.hcomp_fast import try_compile
    from zpaqfranz_tpu_torch.parallel.engine import coded_stream, selector

    rng = np.random.default_rng(seed)
    models = cm_models()
    out = {}

    def profiled(launch, model, packed, hcomp, want) -> tuple:
        got, _, ms = timed_cm(torch, launch, model, packed, hcomp)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        job = launch(model, *packed, profile=True, hcomp=hcomp)
        a.record()
        job.run()
        b.record()
        torch.cuda.synchronize()
        check(got == want and lanes_to_bytes(*job.result()) == want,
              f"CM kernel differs from the native engine ({hcomp})")
        prof = dict(zip(PROFILE, job.profile()[0].tolist()))
        return ms, a.elapsed_time(b), prof

    for name, size in CM_PROFILE_LANES:
        model = models[name]
        pay = lane_payloads(np, rng, [size])[0]
        stream = coded_stream(model, pay)
        packed = cme.pack_payloads([selector(model) + pay], dev)
        rates = {}
        for hcomp in ("fast", "interp"):
            ms, prof_ms, prof = profiled(cme.Launch, model, packed, hcomp,
                                         [stream[:-6]])
            bits, nbytes = prof.pop("bits"), prof.pop("bytes")
            total = sum(prof.values())
            rates[hcomp] = len(pay) / ms
            log(f"-m{name} one lane of {len(pay)} bytes, HCOMP {hcomp}: "
                f"{len(pay) / ms:.2f} KB/s, {ms * 1e3 / (8 * len(pay)):.3f} "
                f"us per bit; profiled: {total / bits:.0f} cycles per bit = "
                + " + ".join(f"{k} {v / bits:.0f}" for k, v in prof.items())
                + f"; HCOMP {prof['hcomp'] / nbytes:.0f} cycles per byte "
                f"({100 * prof['hcomp'] / total:.1f}% of the lane; "
                f"interpreter design: {INTERP_HCOMP[name][0]}, "
                f"{INTERP_HCOMP[name][1]}%)")
            if name == "4" and hcomp == "fast":
                out["cm_encode"] = (prof_ms * prof["hcomp"] / total,
                                    prof["hcomp"] / nbytes,
                                    total / prof_ms / 1e6)
        log(f"-m{name} one lane: {rates['fast']:.2f} KB/s specialised, "
            f"{rates['interp']:.2f} interpreted "
            f"({rates['fast'] / rates['interp']:.2f}x); interpreter "
            f"design {INTERP_LANE_KBPS[name]} KB/s")
        if name == "4":
            streams = cmd.pack_streams([stream], [len(pay) + 64], dev)
            ms, prof_ms, prof = profiled(cmd.Launch, model, streams, "fast",
                                         [selector(model) + pay])
            nbytes = prof.pop("bytes")
            prof.pop("bits")
            total = sum(prof.values())
            out["cm_decode"] = (prof_ms * prof["hcomp"] / total,
                                prof["hcomp"] / nbytes, total / prof_ms / 1e6)
            fh = try_compile(model)
            byte = torch.frombuffer(bytearray(selector(model) + pay),
                                    dtype=torch.uint8).long()[:, None]
            st = fh.init_state(1)
            t0 = time.perf_counter()
            for j in range(byte.shape[0]):
                st = fh.run(st, byte[j])
            plain_ms = (time.perf_counter() - t0) * 1e3
            out["plain"] = (plain_ms, byte.shape[0], fh)
            log(f"-m4 HCOMP specialised: {fh.ops} integer operations and a "
                f"chain of {fh.chain} a byte (ops/hcomp_fast.py); in the "
                f"kernels {out['cm_encode'][1]:.0f} (encode) and "
                f"{out['cm_decode'][1]:.0f} (decode) cycles a byte; plain "
                f"version {plain_ms / byte.shape[0] * 1e3:.1f} us a byte")
    return out


def hcomp_entries(prof: dict, errs: dict) -> list:
    """The JSON lines of the specialised HCOMP step in the two CM kernels:
    its time in the -m4 one-lane profile (HCOMP's profiled share of the
    launch), the plain version's over the same bytes, and its bound: the
    bytes it must read and write (the lane's bytes, n contexts a byte) or
    its counted integer operations; the chain of its dependent operations
    at 4 cycles each, one byte after another, is printed beside it."""
    plain_ms, nbytes, fh = prof["plain"]
    out = []
    for kernel in ("cm_decode", "cm_encode"):
        ms, cycles, ghz = prof[kernel]
        b_ms, b_by = bound(nbytes * (1 + 4 * fh.n), nbytes * fh.ops)
        chain_ms = nbytes * fh.chain * 4 / ghz / 1e6
        log(f"{kernel}_hcomp_fast: -m4, {nbytes} bytes: {ms:.3f} ms in the "
            f"kernel ({cycles:.0f} cycles a byte at {ghz:.3f} GHz), bound "
            f"{b_ms:.5f} ms ({b_by}), chain floor {chain_ms:.4f} ms "
            f"({fh.chain} dependent operations a byte), plain {plain_ms:.0f} "
            f"ms")
        out.append({"name": f"{kernel}_hcomp_fast", "route": "cuda",
                    "source": "zpaqfranz_tpu_torch/ops/hcomp_fast.py",
                    "replaces": "zpaqfranz_tpu/ops/hcomp_fast.py:354",
                    "max_abs_err": errs[kernel], "ms": ms,
                    "plain_ms": plain_ms, "bound_ms": b_ms,
                    "bound_by": b_by, "library_ms": None})
    return out


# ---------------------------------------------------------------------------
# table-access microbenchmark kernels

def micro_cases(torch, dev, kind: str):
    """``(label, run, plain, inputs)`` for every shape the scripts time
    with kernel ``kind``: bench_A .. bench_E's, and P1 / P2 at L = 64,
    ITERS = 64 on the script's own inputs."""
    from zpaqfranz_tpu_torch.experiments import mb_access as mb
    from zpaqfranz_tpu_torch.experiments import mb_vmem_probe as mp

    if kind == "lane_rw":
        tab = torch.zeros((PROBE_L, mp.SW), dtype=torch.int32, device=dev)
        yield (f"L={PROBE_L} ITERS={PROBE_ITERS}",
               lambda t: mp.lane_rw_probe(t, PROBE_ITERS),
               lambda t: mp.lane_rw_plain(t, PROBE_ITERS), (tab,))
    elif kind == "lut":
        lut = torch.arange(mp.LUT, dtype=torch.int32, device=dev)
        yield (f"L={PROBE_L} ITERS={PROBE_ITERS}",
               lambda t: mp.lut_probe(t, PROBE_L, PROBE_ITERS),
               lambda t: mp.lut_plain(t, PROBE_L, PROBE_ITERS), (lut,))
    else:
        for label, run, args, _ in mb.cases(kind, dev):
            yield label, run, run.plain, args


def micro_work(kind: str, args) -> tuple:
    """``(bytes, operations, chain)`` of one call: the bytes it must move
    (A-C read the whole table, which their design stages in shared memory
    and which B and C touch row by row; D, E and P1 only the rows they
    touch; P2 its LUT), the integer instructions (MICRO_OPS_PER_ACCESS,
    MICRO_OPS_PER_WORD, FLOOR_MOD_OPS) and the length of the longest chain
    of dependent accesses."""
    from zpaqfranz_tpu_torch.experiments import mb_access as mb
    from zpaqfranz_tpu_torch.experiments import mb_vmem_probe as mp

    def pow2(n):
        return n & (n - 1) == 0

    rounds = mb.ITERS // 8
    if kind in ("gather", "onehot", "selwrite"):
        tab, _ = args
        S, n = tab.shape
        nbytes = tab.numel() * tab.element_size() + 8 * n
        if kind == "gather":
            per = MICRO_OPS_PER_ACCESS[kind] + FLOOR_MOD_OPS[pow2(S)]
        else:
            per = MICRO_OPS_PER_WORD * -(-(S * tab.element_size()) // 4)
        return nbytes, n * mb.ITERS * per, mb.ITERS
    if kind in ("lane_loop", "dma"):
        idx, tab = args
        n, S = tab.shape
        width = dict(mb.D_SHAPES if kind == "lane_loop" else mb.E_SHAPES)[S]
        moved = (2 if kind == "lane_loop" else 1) * n * width
        ops = (MICRO_OPS_PER_ACCESS[kind] if kind == "lane_loop"
               else width // 16 + 3)
        return moved + 4 * n + 4, n * rounds * ops, rounds
    if kind == "lane_rw":
        probes = PROBE_L * PROBE_ITERS
        per = MICRO_OPS_PER_ACCESS[kind] + FLOOR_MOD_OPS[pow2(mp.SW - mp.W)]
        return 2 * 16 * probes + 4, probes * per, probes
    steps = PROBE_ITERS * 8
    per = MICRO_OPS_PER_ACCESS[kind] + FLOOR_MOD_OPS[pow2(mp.LUT)]
    return 4 * mp.LUT + 4 * PROBE_L, PROBE_L * steps * per, steps


def micro_floor_ns(kind: str, args, steps: dict,
                   write_back: bool = False) -> float:
    """The chain floor of one call: no design can be faster. Each lane's
    (P1: the one thread's) dependent accesses, each priced at the chase
    step of the level it touches, plus the dependent integer instructions
    the work itself needs at CHAIN_CYCLES each: the adds and masks, and one
    floor modulo (FLOOR_MOD_OPS) where the index is data-dependent. A:
    the index add, the modulo, the address and the sum's add beside each
    shared load. B: no row read depends on the chain, which is the index
    add and modulo, the compare and select, the warp's sum and the
    accumulator's add, and a warp's issue of its share of the rows, one
    instruction a cycle: load, compare-select and add a word (four u8 rows
    or one int32 row) each. C: a pass's index needs no data; each word's
    load, select and store follow the last pass's store (one shared step and
    the select), and a warp issues the load, compare, select and store of
    its words. D: an L2 access and the add a round (``write_back``: the
    access priced at the "l2_rw" chase, a read of the word the thread's
    own last store wrote, since the next round reads the row it wrote). E:
    the
    first round's row from HBM, the others from L2, and the shared read of
    the copy. P1: an L2 probe, the index multiply-add, the modulo, the
    address and the accumulator's add and mask (the next probe reads
    another row, so the write-back is off the chain). P2: a shared load,
    the index add, the modulo (a mask: 4096 entries), the address and the
    accumulator's add and mask."""
    from zpaqfranz_tpu_torch.experiments import mb_access as mb

    op = CHAIN_CYCLES / steps["ghz"]
    cycle = 1 / steps["ghz"]
    rounds = mb.ITERS // 8
    if kind in ("gather", "onehot", "selwrite"):
        tab, _ = args
        S = tab.shape[0]
        fm = FLOOR_MOD_OPS[S & (S - 1) == 0]
        words = -(-(S * tab.element_size()) // 4)
        k = -(-words // 32)
        per = {"gather": steps["shared"] + op * (fm + 3),
               "onehot": op * (fm + 5) + cycle * 3 * k,
               "selwrite": steps["shared"] + op + cycle * 4 * k}[kind]
        return mb.ITERS * per
    if kind == "lane_loop":
        return rounds * (steps["l2_rw" if write_back else "l2"] + op)
    if kind == "dma":
        return (steps["hbm"] + (rounds - 1) * steps["l2"]
                + rounds * steps["shared"])
    if kind == "lane_rw":
        return PROBE_L * PROBE_ITERS * (steps["l2"]
                                        + op * (FLOOR_MOD_OPS[False] + 4))
    return PROBE_ITERS * 8 * (steps["shared"]
                              + op * (FLOOR_MOD_OPS[True] + 4))


def micro_random(torch, dev, kind: str, args, seed: int) -> list:
    """``(label, inputs)`` of seeded random inputs with the shapes and types
    of ``args``: random tables, and random int32 start indices (A-C) or
    random row offsets (D, E), so that a kernel that reads the wrong lane,
    row or address cannot agree with its plain version. The scripts' own
    inputs are all-zero tables (C, D, E) or give sums that do not depend on
    the row (D). D's offsets are drawn at 16-byte boundaries (its 16-byte
    path) and at any byte (its byte path); E's at 16-byte boundaries only."""
    from zpaqfranz_tpu_torch.experiments import mb_access as mb

    g = torch.Generator(device=dev).manual_seed(seed)

    def ints(shape, lo=-2**31, hi=2**31):
        return torch.randint(lo, hi, shape, generator=g, device=dev,
                             dtype=torch.int64).to(torch.int32)

    def like(t):
        if t.dtype == torch.uint8:
            return torch.randint(0, 256, t.shape, generator=g, device=dev,
                                 dtype=torch.uint8)
        return ints(t.shape)

    if kind in ("gather", "onehot", "selwrite"):
        tab, idx = args
        out = [("random table and starts", (like(tab), ints(idx.shape)))]
        if kind == "gather":
            # every lane on the same row at every step: no bank conflicts
            # among a warp's loads, to set beside the random rows above
            rows = like(tab[:, :1]).expand(tab.shape).contiguous()
            out.append(("rows equal across lanes",
                        (rows, ints(idx.shape[:1] + (1,)).expand(
                            idx.shape).contiguous())))
        return out
    if kind in ("lane_loop", "dma"):
        idx, tab = args
        n, S = tab.shape
        width = dict(mb.D_SHAPES if kind == "lane_loop" else mb.E_SHAPES)[S]
        rnd = like(tab)
        out = [("random table, aligned rows",
                (ints((n, 1), 0, (S - width) // 16 + 1) * 16, rnd))]
        if kind == "lane_loop":
            out.append(("random table, unaligned rows",
                        (ints((n, 1), 0, S - width + 1), rnd)))
        return out
    return [("random table", (like(args[0]),))]


def check_micro(torch, dev, steps: dict) -> list:
    """Hold the seven table-access kernels bit-exact against their plain
    versions on the card at every shape their scripts time, on the
    scripts' inputs and on seeded random inputs of the same shapes
    (``micro_random``); a second call must agree and leave the inputs
    unchanged. Times each kernel alone (``kernel_ms``), the whole call
    (CUDA events) and the plain version (host clock) on the scripts'
    inputs, each beside its chain floor (``micro_floor_ns``) and its bytes
    or operations bound; A also on its random inputs (bank replays). A
    kernel's row sums its shapes."""
    from zpaqfranz_tpu_torch.device import seconds
    from zpaqfranz_tpu_torch.experiments import mb_access as mb

    out = []
    for k, (name, module, kind, replaces) in enumerate(MICRO):
        err = 0
        ms = plain_ms = floor_ms = floor2_ms = 0.0
        nbytes = ops = 0
        cases = micro_cases(torch, dev, kind)
        for seed, (label, run, plain, args) in enumerate(cases, 16 * k):
            variants = [("script's inputs", args)] + micro_random(
                torch, dev, kind, args, seed)
            for what, inputs in variants:
                before = [a.clone() for a in inputs]
                got = run(*inputs)
                again = run(*inputs)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                want = plain(*inputs)
                torch.cuda.synchronize()
                p_ms = (time.perf_counter() - t0) * 1e3
                err = max(err, int((got.long() - want.long()).abs().max()))
                check(torch.equal(got, want) and torch.equal(got, again),
                      f"{name} differs from its plain version [{label}, "
                      f"{what}]")
                check(all(torch.equal(a, b) for a, b in zip(inputs, before)),
                      f"{name} changed its inputs [{label}, {what}]")
                if inputs is not args:
                    timed = ""
                    if kind == "gather":
                        r_ms = kernel_ms(torch, run, inputs, f"{kind}_kernel")
                        timed = (f", kernel {r_ms:.4f} ms = "
                                 f"{r_ms * 1e6 / mb.ITERS:.1f} "
                                 f"ns per access")
                    log(f"{name} [{label}, {what}]: identical to plain "
                        f"({p_ms:.1f} ms){timed}")
                    continue
                k_ms = kernel_ms(torch, run, args, f"{kind}_kernel")
                call_ms = seconds(run, *args) * 1e3
                b, o, chain = micro_work(kind, args)
                b_ms, b_by = bound(b, o)
                f_ms = micro_floor_ns(kind, args, steps) / 1e6
                if kind == "lane_loop":
                    f2_ms = micro_floor_ns(kind, args, steps, True) / 1e6
                    floor2_ms += f2_ms
                    log(f"{name} [{label}]: a round's read priced at the "
                        f"l2_rw chase: floor {f2_ms:.5f} ms "
                        f"({f2_ms / k_ms:.1%} of it reached)")
                log(f"{name} [{label}]: kernel {k_ms:.4f} ms = "
                    f"{k_ms * 1e6 / chain:.1f} ns per dependent access "
                    f"({chain} in the chain; the whole call {call_ms:.4f} "
                    f"ms), chain floor {f_ms:.5f} ms ({f_ms / k_ms:.1%} of "
                    f"it reached), bound {b_ms:.5f} ms ({b_by}), plain "
                    f"{p_ms:.1f} ms; identical")
                ms += k_ms
                plain_ms += p_ms
                floor_ms += f_ms
                nbytes += b
                ops += o
        b_ms, b_by = bound(nbytes, ops)
        old = FIRST_MICRO_MS[kind]
        log(f"{name} over its shapes: kernel {ms:.4f} ms against its chain "
            f"floor {floor_ms:.5f} ms ({floor_ms / ms:.1%}; the first design "
            f"{old} ms, {floor_ms / old:.1%}, {old / ms:.2f}x this one), "
            f"bytes/operations bound {b_ms:.6f} ms ({b_by}, "
            f"{b_ms / ms:.2%})")
        if floor2_ms:
            log(f"{name} over its shapes, a round's read priced at the "
                f"l2_rw chase: chain floor {floor2_ms:.5f} ms "
                f"({floor2_ms / ms:.1%}; the first design "
                f"{floor2_ms / old:.1%})")
        out.append({"name": name, "route": "cuda",
                    "source": f"zpaqfranz_tpu_torch/csrc/{module}.cu",
                    "replaces": replaces, "max_abs_err": err, "ms": ms,
                    "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                    "library_ms": None})
    return out


def measurement_path(torch, dev) -> dict:
    """Run the two microbenchmark entry points and the device bench's whole
    ladder on the card. Returns each kernel's launches on its own path:
    the counts are set to 0 just before each path and read just after."""
    from zpaqfranz_tpu_torch.experiments import mb_access as mb
    from zpaqfranz_tpu_torch.experiments import mb_vmem_probe as mp
    from zpaqfranz_tpu_torch.ops import cm_decode as cmd, cm_encode as cme
    from zpaqfranz_tpu_torch.ops import sha1
    from zpaqfranz_tpu_torch.parallel import device_bench

    counts = {}
    for mod in (mb, mp):
        for k in mod.launches:
            mod.launches[k] = 0
        t0 = time.perf_counter()
        check(mod.main([]) == 0, f"{mod.__name__}.main failed")
        torch.cuda.synchronize()
        log(f"  ({mod.__name__}.main took {time.perf_counter() - t0:.1f} s, "
            f"launches {mod.launches})")
        counts.update(mod.launches)

    sha1.launches = cme.launches = cmd.launches = 0
    t0 = time.perf_counter()
    res = device_bench.run_ladder(budget_s=900.0, device=dev)
    check(len(res) == len(device_bench.LADDER) and "stopped" not in res,
          f"the ladder stopped: {res.get('stopped')}")
    log(f"ladder: {len(res)} stages in {time.perf_counter() - t0:.1f} s, "
        f"launches: sha1 {sha1.launches}, cm_encode {cme.launches}, "
        f"cm_decode {cmd.launches}; every lane equals the host engine's "
        f"coded stream and decodes to its payload")
    check(sha1.launches > 0 and cme.launches > 0 and cmd.launches > 0,
          "the ladder did not launch the SHA-1 and CM kernels")
    for name, st in res.items():
        log(device_bench.stage_line(name, st))
    return counts


# ---------------------------------------------------------------------------
# main path

def make_corpus(np, root: pathlib.Path, nbytes: int, seed: int) -> None:
    """Seeded backup-like tree of ``nbytes``: text-like files, structured
    binary records and incompressible data, each followed by an exact
    duplicate in another directory (half the bytes dedup away)."""
    rng = np.random.default_rng(seed)
    vocab = [bytes(rng.integers(97, 123, int(k), dtype=np.uint8))
             for k in rng.integers(2, 10, 4000)]
    root.mkdir(parents=True)
    made = 0
    k = 0
    body = b""
    while made < nbytes:
        kind = k % 6
        size = int(min(nbytes - made,
                       rng.integers(nbytes // 48 + 1, nbytes // 12 + 2)))
        if kind == 0:                          # text
            idx = rng.zipf(1.3, size // 4) % len(vocab)
            body = b" ".join(vocab[i] for i in idx)
            body = body.replace(b"a ", b".\n", 1 + size // 500)[:size]
        elif kind == 2:                        # structured binary records
            rec = np.zeros((size // 16 + 1, 4), np.uint32)
            rec[:, 0] = np.arange(rec.shape[0]) + seed
            rec[:, 1] = rng.integers(0, 50, rec.shape[0]).cumsum()
            rec[:, 2] = rng.integers(0, 4, rec.shape[0]) * 1000
            rec[:, 3] = 0xABCD0000 | rng.integers(0, 16, rec.shape[0])
            body = rec.tobytes()[:size]
        elif kind == 4:                        # incompressible
            body = rng.integers(0, 256, size, dtype=np.uint8).tobytes()
        else:                                  # duplicate of the last file
            body = body[:nbytes - made]
        path = root / f"d{k % 3}" / f"f{k:04d}"
        path.parent.mkdir(exist_ok=True)
        path.write_bytes(body)
        made += len(body)
        k += 1


def tree_bytes(root: pathlib.Path) -> dict:
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def in_dir(path: pathlib.Path, fn):
    """``fn()`` run with ``path`` as the working directory."""
    cwd = os.getcwd()
    os.chdir(path)
    try:
        return fn()
    finally:
        os.chdir(cwd)


def main_path(torch, np, dev, level: str, nbytes: int, seed: int,
              damage: bool) -> dict:
    from zpaqfranz_tpu_torch.cli import main as cli_main
    from zpaqfranz_tpu_torch.jidac.add import add
    from zpaqfranz_tpu_torch.jidac.extract import (ExtractError, extract,
                                                   verify_archive)
    from zpaqfranz_tpu_torch.jidac.index import read_archive
    from zpaqfranz_tpu_torch.ops import cm_decode as cmd, cm_encode as cme
    from zpaqfranz_tpu_torch.parallel.engine import parse_block_payload

    name = f"c{level}"
    src = WORK / name
    make_corpus(np, src, nbytes, seed)
    want = tree_bytes(src)
    total = sum(map(len, want.values()))
    arc = WORK / f"{name}.zpaq"
    host_arc = WORK / f"{name}-host.zpaq"
    date = 20260102030405

    def timed_add(path, **kw) -> float:
        t0 = time.perf_counter()
        in_dir(WORK, lambda: add(str(path), [name], method=level, date=date,
                                 **kw))
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    enc0 = cme.launches
    t_add = timed_add(arc, device=dev)
    enc_launches = cme.launches - enc0
    t_host = timed_add(host_arc, use_device=False)
    data = arc.read_bytes()
    check(data == host_arc.read_bytes(),
          f"-m{level}: the card's add differs from the host engine's")
    jd = read_archive(data)
    cm_blocks = [b for b in jd.block if parse_block_payload(
        data[b.offset:b.offset + b.bsize], 0)[0].n > 0]
    modeled = len(cm_blocks)
    cm_bytes = sum(b.usize for b in cm_blocks)
    check(1 <= enc_launches <= modeled,
          f"-m{level}: {enc_launches} encode launches for {modeled} lanes")
    log(f"-m{level}: add {total} bytes on the card in {t_add:.2f} s "
        f"({total / t_add / 1e6:.3f} MB/s), on the host engine in "
        f"{t_host:.2f} s ({total / t_host / 1e6:.3f} MB/s): identical "
        f"archives of {len(data)} bytes, {len(jd.block)} blocks; {modeled} "
        f"CM lanes of {cm_bytes} modeled bytes in {enc_launches} encode "
        f"launches ({modeled / enc_launches:.1f} lanes/launch, "
        f"{cm_bytes / modeled / t_add / 1e3:.2f} KB/s per encode lane)")

    # sum -sha1 / -sha256 over the corpus: lanes of the hash kernels
    for algo in ("sha1", "sha256"):
        out_text = io.StringIO()
        with contextlib.redirect_stdout(out_text):
            rc = in_dir(WORK, lambda: cli_main(["sum", name, f"-{algo}",
                                                "-tpu"]))
        lines = [f"{hashlib.new(algo, b).hexdigest().upper()}  {name}/{rel}"
                 for rel, b in want.items()]
        check(rc == 0 and out_text.getvalue().splitlines() == lines,
              f"-m{level}: sum -{algo} differs from hashlib")
    log(f"-m{level}: sum -sha1 and -sha256 of {len(want)} files equal "
        f"hashlib's")

    out = WORK / f"out{level}"
    cm0 = cmd.launches
    t0 = time.perf_counter()
    nfiles, nout = extract(data, jd, str(out), device=dev)
    torch.cuda.synchronize()
    t_x = time.perf_counter() - t0
    got = tree_bytes(out / name)
    check(got == want, f"-m{level}: extracted files differ from the corpus")
    check(nout == total, f"-m{level}: extracted {nout} of {total} bytes")
    lanes = modeled / max(1, cmd.launches - cm0)
    log(f"-m{level}: extract {nfiles} files {nout} bytes in {t_x:.2f} s "
        f"({nout / t_x / 1e6:.3f} MB/s), {modeled} CM lanes of {cm_bytes} "
        f"bytes in {cmd.launches - cm0} launches ({lanes:.1f} lanes/launch, "
        f"{cm_bytes / max(1, modeled) / t_x / 1e3:.2f} KB/s per lane); "
        f"byte-identical")

    expect = (len(jd.block), sum(1 for j in range(1, len(jd.ht))
                                 if jd.ht[j].sha1 != b"\x00" * 20))
    t0 = time.perf_counter()
    res = verify_archive(data, jd, device=dev)
    torch.cuda.synchronize()
    t_t = time.perf_counter() - t0
    check(tuple(res) == expect, f"-m{level}: verify gave {res}, want {expect}")
    log(f"-m{level}: verify {res[0]} blocks {res[1]} fragments in "
        f"{t_t:.2f} s ({total / t_t / 1e6:.2f} MB/s)")

    if damage:
        blk = next(b for b in jd.block if parse_block_payload(
            data[b.offset:b.offset + b.bsize], 0)[0].n > 0)
        bad = bytearray(data)
        bad[blk.offset + blk.bsize // 2] ^= 0x55
        t0 = time.perf_counter()
        try:
            extract(bytes(bad), read_archive(bytes(bad)), str(WORK / "bad"),
                    device=dev)
        except ExtractError as e:
            log(f"-m{level}: flipped byte in a d block -> ExtractError "
                f"({str(e)[:80]}) in {time.perf_counter() - t0:.2f} s")
        else:
            raise SmokeError(f"-m{level}: a flipped byte was not detected")
        torch.cuda.synchronize()
    shutil.rmtree(src)
    shutil.rmtree(out)
    return {"level": level, "bytes": total, "a_s": t_add, "a_host_s": t_host,
            "x_s": t_x, "t_s": t_t, "cm_bytes": cm_bytes, "lanes": modeled,
            "enc_KBps": cm_bytes / modeled / t_add / 1e3,
            "lane_KBps": cm_bytes / max(1, modeled) / t_x / 1e3}


# ---------------------------------------------------------------------------
# the paths of several devices, several hosts and the CLI's commands


def run_cli(argv) -> tuple:
    """``cli.main(argv)`` run in ``WORK``: its exit code and stdout."""
    from zpaqfranz_tpu_torch.cli import main as cli_main

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = in_dir(WORK, lambda: cli_main(argv))
    return rc, out.getvalue()


def sharded_lanes(torch, np, dev, seed: int) -> int:
    """-m4 lanes split over the card named k times (``parallel/dist.py``):
    the coded bytes equal the unsharded launch's and the host engine's, the
    decode gives the payloads back, and each non-empty shard launches each
    kernel at least once. Prints the aggregate MB/s at each k."""
    from zpaqfranz_tpu_torch.codec.methods import make_model
    from zpaqfranz_tpu_torch.ops import cm_decode as cmd, cm_encode as cme
    from zpaqfranz_tpu_torch.parallel import dist, engine

    model = make_model("4")[0]
    sel = engine.selector(model)
    rng = np.random.default_rng(seed)
    pays = [sel + p for p in lane_payloads(
        np, rng, [SHARD_LANE_BYTES] * SHARD_LANES)]
    single = engine.encode_streams(model, pays, dev)
    check(single == [engine.coded_stream(model, p[len(sel):])[:-6]
                     for p in pays],
          "-m4 lanes: the card's encode differs from the host engine's")
    nbytes = sum(map(len, pays))
    for k in SHARD_KS:
        mesh = [dev] * k
        e0, d0 = cme.launches, cmd.launches
        t0 = time.perf_counter()
        coded = dist.encode_streams_sharded(model, pays, mesh)
        torch.cuda.synchronize()
        t_enc = time.perf_counter() - t0
        check(coded == single, f"-m4 lanes over {k} shards: the coded "
              f"bytes differ from the unsharded launch's")
        t0 = time.perf_counter()
        back = dist.decode_streams_sharded(model, coded,
                                           max(map(len, pays)) + 8, mesh)
        torch.cuda.synchronize()
        t_dec = time.perf_counter() - t0
        check(back == pays, f"-m4 lanes over {k} shards: the decode "
              f"differs from the payloads")
        shards = min(k, SHARD_LANES)
        enc, dec = cme.launches - e0, cmd.launches - d0
        check(enc >= shards and dec >= shards,
              f"-m4 lanes over {k} shards: {enc} encode and {dec} decode "
              f"launches")
        log(f"sharded lanes, -m4 x {SHARD_LANES} lanes of "
            f"{SHARD_LANE_BYTES} bytes over [{dev}] x {k}: encode "
            f"{t_enc:.2f} s ({nbytes / t_enc / 1e6:.4f} MB/s aggregate, "
            f"{enc} launches), decode {t_dec:.2f} s "
            f"({nbytes / t_dec / 1e6:.4f} MB/s, {dec} launches); equal to "
            f"the unsharded launch and the host engine, decoded back")
    return 0


def text_corpus(np, root: pathlib.Path, nbytes: int, seed: int) -> None:
    """Seeded text files of 512 KiB (the last one the rest of ``nbytes``),
    no two alike (nothing dedups)."""
    rng = np.random.default_rng(seed)
    vocab = [bytes(rng.integers(97, 123, int(k), dtype=np.uint8))
             for k in rng.integers(2, 10, 5000)]
    root.mkdir(parents=True)
    for k in range(-(-nbytes // (512 << 10))):
        idx = rng.zipf(1.2, 120000) % len(vocab)
        body = b" ".join(vocab[i] for i in idx)
        check(len(body) >= 512 << 10, "text corpus: a file came out short")
        (root / f"t{k:02d}.txt").write_bytes(
            body[:min(512 << 10, nbytes - (k << 19))])


def multihost_add(torch, np, dev, seed: int) -> int:
    """The multi-host add (``parallel/multihost.py``) on the card:
    ``scaling_report`` over 1-3 ranks on TCP and 1-2 on torch.distributed,
    each rank a process coding its d blocks on the card (``--device``).
    The archive of every world equals the single-process ``add``'s on the
    card and on the host engine; every rank that owns a block launched the
    CM encoder (the workers' printed counts). Returns those launches."""
    from zpaqfranz_tpu_torch.jidac.add import add
    from zpaqfranz_tpu_torch.jidac.index import read_archive
    from zpaqfranz_tpu_torch.ops import cm_encode as cme
    from zpaqfranz_tpu_torch.parallel import multihost as mh

    root = WORK / "mh" / "corpus"
    text_corpus(np, root, MH_BYTES, seed)
    date = 20260102030405              # scaling_report's date

    def single(name: str, **kw) -> tuple:
        t0 = time.perf_counter()
        in_dir(root.parent, lambda: add(name, [root.name], method=MH_METHOD,
                                        date=date, **kw))
        torch.cuda.synchronize()
        return (root.parent / name).read_bytes(), time.perf_counter() - t0

    e0 = cme.launches
    data, t_card = single("card.zpaq", device=dev)
    check(cme.launches > e0, f"{MH_METHOD}: add did not launch the encoder")
    host, t_host = single("host.zpaq", use_device=False)
    check(data == host, f"{MH_METHOD}: the card's add differs from the "
          f"host engine's")
    nblocks = len(read_archive(data).block)
    check(nblocks >= 4, f"{MH_METHOD}: {nblocks} d blocks, want 4")
    want = hashlib.sha1(data).hexdigest()
    log(f"multi-host add, {MH_METHOD} over {MH_BYTES} bytes ({nblocks} d "
        f"blocks): one process {t_card:.2f} s on the card, {t_host:.2f} s "
        f"on the host engine, identical")
    launches = 0
    for flags, worlds in ((["--device"], MH_WORLDS),
                          (["--device", "--torch-dist"], MH_TORCH_WORLDS)):
        t0 = time.perf_counter()
        rep = mh.scaling_report(str(root), worlds=worlds, method=MH_METHOD,
                                flags=flags, timeout=600)
        for w in worlds:
            r = rep[w]
            check(r["archive_sha1"] == want, f"{flags} world {w}: the "
                  f"archive differs from the single-process add's")
            check(r["cm_encode_launches"] >= min(w, nblocks),
                  f"{flags} world {w}: {r['cm_encode_launches']} encode "
                  f"launches over its ranks")
            launches += r["cm_encode_launches"]
            log(f"  {' '.join(flags)} world {w}: {r['seconds']} s "
                f"({r['MBps']} MB/s, efficiency {r['efficiency_vs_1']}), "
                f"{r['cm_encode_launches']} encode launches over its ranks, "
                f"archive identical")
        log(f"  ({' '.join(flags)} worlds {worlds} took "
            f"{time.perf_counter() - t0:.1f} s)")
    shutil.rmtree(root.parent)
    return launches


def backup_commands(np, seed: int) -> int:
    """``backup`` at -m4 twice (a changed file makes a second part), then
    ``testbackup``, ``p`` and ``c`` on the parts, each through the CLI on
    the card: the exit codes and lines, ``p`` and ``c`` equal to the host
    engine's, and the CM decoder and the SHA-1 lanes launched."""
    from zpaqfranz_tpu_torch.ops import cm_decode as cmd, cm_encode as cme
    from zpaqfranz_tpu_torch.ops import sha1

    src = WORK / "bsrc"
    make_corpus(np, src, BACKUP_BYTES, seed)
    nfiles = len(tree_bytes(src))
    parts = "bk_????????.zpaq"
    for k in (1, 2):
        e0 = cme.launches
        t0 = time.perf_counter()
        rc, out = run_cli(["backup", "bk", "bsrc", "-m4", "-tpu"])
        check(rc == 0 and out.endswith(f"{k} parts indexed in "
                                       f"bk_backup.txt\n"),
              f"backup {k}: rc {rc}, {out!r}")
        check(cme.launches > e0, f"backup {k} did not launch the encoder")
        log(f"backup {k}: {out.strip()} ({time.perf_counter() - t0:.2f} s)")
        victim = sorted(src.rglob("f*"))[0]
        victim.write_bytes(victim.read_bytes() + b"changed %d" % k)
    rc, out = run_cli(["testbackup", "bk"])
    check((rc, out) == (0, "testbackup: 0 bad parts\n"),
          f"testbackup: rc {rc}, {out!r}")
    for argv, line in ((["p", parts], f"paranoid: {nfiles} files, "),
                       (["c", parts], f"{nfiles - 1} identical, 1 differ, "
                                      f"0 missing")):
        d0, s0 = cmd.launches, sha1.launches
        t0 = time.perf_counter()
        rc, out = run_cli(argv + ["-tpu"])
        dt = time.perf_counter() - t0
        check(line in out and rc == (1 if argv[0] == "c" else 0),
              f"{argv[0]}: rc {rc}, {out!r}")
        check(cmd.launches > d0 and sha1.launches > s0,
              f"{argv[0]} did not launch the CM decoder and SHA-1 lanes")
        host = run_cli(argv + ["-notpu"])
        check(host == (rc, out), f"{argv[0]}: the card's lines differ from "
              f"the host engine's: {host!r}")
        log(f"{argv[0]} {parts}: {out.strip().splitlines()[-1]} in "
            f"{dt:.2f} s on the card, the host engine's lines")
    shutil.rmtree(src)
    return 0


def batched_hash_path(torch, np, dev, lens, frag, crcs) -> int:
    """The batched-hash lane API (``ops/hash_batched.py``) on the fragment
    shape as padded (L, N) rows on the card: ``sha1_lanes``,
    ``sha256_lanes`` and ``crc32_lanes``, equal to hashlib and
    ``native.crc32``."""
    from zpaqfranz_tpu_torch.ops import hash_batched as hb

    ends = np.cumsum(lens)
    rows, lengths = hb.pad_lanes([frag[e - n:e] for e, n in zip(ends, lens)])
    rows = torch.from_numpy(rows).to(dev)
    for algo, ref in (("sha1", hashlib.sha1), ("sha256", hashlib.sha256),
                      ("crc32", None)):
        t0 = time.perf_counter()
        got = getattr(hb, f"{algo}_lanes")(rows, lengths)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if ref is None:
            check(crc_words(torch, got) == crcs, "hash_batched.crc32_lanes "
                  "differs from native.crc32")
        else:
            check(hb.digest_bytes(got) == [ref(frag[e - n:e]).digest()
                                           for e, n in zip(ends, lens)],
                  f"hash_batched.{algo}_lanes differs from hashlib")
        log(f"hash_batched.{algo}_lanes: {len(lens)} rows of "
            f"{rows.shape[1]} bytes ({int(lens.sum())} message bytes) on the "
            f"card in {dt * 1e3:.1f} ms, the call; equal to "
            f"{'native.crc32' if ref is None else 'hashlib'}")
    del rows
    return 0


def device_bwt(torch, np, dev, seed: int) -> None:
    """``bwt_encode_device`` at full width: one 16 MiB block of text on the
    card, byte-identical to ``native.bwt_encode`` and inverted by the -m3
    postprocessor; the rounds, the seconds on the card and on the host, and
    the share of ``torch.sort`` (CUDA events around each sort)."""
    from zpaqfranz_tpu_torch import native
    from zpaqfranz_tpu_torch.codec.methods import make_model
    from zpaqfranz_tpu_torch.parallel.engine import selector
    from zpaqfranz_tpu_torch.pre import bwt_device

    rng = np.random.default_rng(seed)
    vocab = [bytes(rng.integers(97, 123, int(k), dtype=np.uint8))
             for k in rng.integers(2, 10, 5000)]
    idx = rng.zipf(1.2, BWT_BYTES // 3) % len(vocab)
    data = b" ".join(vocab[i] for i in idx)[:BWT_BYTES]
    check(len(data) == BWT_BYTES, "BWT block came out short")
    t0 = time.perf_counter()
    want = native.bwt_encode(data)
    native_s = time.perf_counter() - t0

    x = torch.frombuffer(bytearray(data), dtype=torch.uint8).to(dev)
    sorts = []
    sort = torch.sort

    def timed_sort(*args, **kw):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        res = sort(*args, **kw)
        b.record()
        sorts.append((a, b))
        return res

    # CUDA events around each sort of one suffix sort: torch.sort wrapped
    # for that call alone
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.sort = timed_sort
    try:
        sa, rounds = bwt_device.prefix_doubling(x)
        torch.cuda.synchronize()
    finally:
        torch.sort = sort
    sa_s = time.perf_counter() - t0
    sort_ms = sum(a.elapsed_time(b) for a, b in sorts)
    del sa, x
    l0 = bwt_device.launches
    t0 = time.perf_counter()
    got = bwt_device.bwt_encode_device(data)
    dev_s = time.perf_counter() - t0
    check(bwt_device.launches == l0 + 1, "bwt_encode_device did not run on "
          "the card")
    check(got == want, "bwt_encode_device differs from native.bwt_encode")
    model = make_model("3")[0]
    check(native.postprocess(model.ph, model.pm, selector(model) + got,
                             out_hint=len(data)) == data,
          "the device BWT does not invert through the -m3 postprocessor")
    b_ms = (2 * len(data) + 5) / HBM_BYTES_PER_S * 1e3
    log(f"device BWT, one {len(data)}-byte block of text (-m3's block "
        f"size): {rounds} rounds ({len(sorts)} sorts), "
        f"bwt_encode_device {dev_s:.3f} s on the card (suffix sort "
        f"{sa_s:.3f} s, torch.sort {sort_ms:.1f} ms = "
        f"{sort_ms / 1e3 / sa_s:.1%} of it), native.bwt_encode "
        f"{native_s:.3f} s on the host; equal to native.bwt_encode, "
        f"inverted by the -m3 postprocessor; bound {b_ms:.4f} ms (bytes)")


def batched_coders(torch, np, dev, seed: int) -> int:
    """``BatchedEncoder`` / ``BatchedDecoder`` (``ops/coder_batched.py``)
    at -m4 on the card: the host engine's coded segments, decoded back to
    the payloads; then ``BatchedPredictor`` per bit on the card, equal to
    the scalar predictor."""
    from zpaqfranz_tpu_torch.codec.methods import (ALL_COMPONENTS_CFG,
                                                   make_model)
    from zpaqfranz_tpu_torch.models.predictor import Predictor
    from zpaqfranz_tpu_torch.ops.coder_batched import (BatchedDecoder,
                                                       BatchedEncoder)
    from zpaqfranz_tpu_torch.ops.predictor_batched import BatchedPredictor
    from zpaqfranz_tpu_torch.parallel.engine import coded_stream, selector
    from zpaqfranz_tpu_torch.zpaql.compiler import compile_config

    model = make_model("4")[0]
    rng = np.random.default_rng(seed)
    raws = lane_payloads(np, rng, [BATCHED_LANE_BYTES] * BATCHED_LANES)
    lanes = [selector(model) + r for r in raws]

    def rows(bs):
        out = np.zeros((len(bs), max(map(len, bs))), np.uint8)
        for i, b in enumerate(bs):
            out[i, :len(b)] = np.frombuffer(b, np.uint8)
        return out

    t0 = time.perf_counter()
    out, cnt = BatchedEncoder(model).encode(rows(lanes), list(map(len,
                                                                  lanes)))
    enc_s = time.perf_counter() - t0
    coded = [coded_stream(model, r) for r in raws]
    check([bytes(out[i, :cnt[i]]) for i in range(len(raws))]
          == [c[:-6] for c in coded], "BatchedEncoder at -m4 differs from "
          "the host engine")
    t0 = time.perf_counter()
    dec, dl = BatchedDecoder(model).decode(rows(coded),
                                           max(map(len, lanes)) + 8)
    dec_s = time.perf_counter() - t0
    check([bytes(dec[i, :dl[i]]) for i in range(len(raws))] == lanes,
          "BatchedDecoder at -m4 does not give the payloads back")
    log(f"batched coders, -m4 x {BATCHED_LANES} lanes of "
        f"{BATCHED_LANE_BYTES} bytes: encode {enc_s:.2f} s, decode "
        f"{dec_s:.2f} s on the card; the host engine's streams, decoded "
        f"back")

    # the per-bit predictor, on the card by default: every component type,
    # three lanes in lockstep, each lane's probability the scalar
    # predictor's at every bit
    model = compile_config(ALL_COMPONENTS_CFG)[0]
    bp = BatchedPredictor(model)
    st = bp.init_state(3)
    check(st.dev.type == "cuda", "BatchedPredictor did not run on the card")
    lanes = [payload[:PREDICTOR_BYTES] for payload in raws[:3]]
    scalars = [Predictor(model) for _ in lanes]
    t0 = time.perf_counter()
    for j in range(PREDICTOR_BYTES):
        for phase in range(8):
            p_final, p, st = bp.predict(st, phase)
            check(p_final.tolist() == [sc.predict() for sc in scalars],
                  "BatchedPredictor differs from the scalar predictor")
            y = [(lane[j] >> (7 - phase)) & 1 for lane in lanes]
            st = bp.update(st, p, y, phase)
            for sc, b in zip(scalars, y):
                sc.update(b)
    log(f"BatchedPredictor, every component type x 3 lanes of "
        f"{PREDICTOR_BYTES} bytes, per bit on the card: "
        f"{time.perf_counter() - t0:.2f} s (host clock, the scalar "
        f"predictor beside it); equal to the scalar predictor")
    return 0


# a fake zfs for zfsbackup / zfsrestore: datasets are directories of a pool
# ($FAKE_POOL), a snapshot a copy, a send stream a header line and a tar of
# the snapshot; every stream sent and received is also kept
FAKE_ZFS = r"""#!/usr/bin/env python3
import io, os, pathlib, shutil, sys, tarfile
POOL = pathlib.Path(os.environ["FAKE_POOL"])
def snap_dir(name):
    ds, snap = name.split("@", 1)
    return POOL / ".snaps" / ds.replace("/", "_") / snap
def keep(kind, data):
    d = POOL / kind
    d.mkdir(exist_ok=True)
    (d / str(len(list(d.iterdir())))).write_bytes(data)
cmd = sys.argv[1]
if cmd == "snapshot":
    d = snap_dir(sys.argv[2])
    d.parent.mkdir(parents=True, exist_ok=True)
    shutil.copytree(POOL / sys.argv[2].split("@", 1)[0], d)
    with open(d.parent / "ORDER", "a") as f:
        f.write(sys.argv[2] + "\n")
elif cmd == "list":
    order = POOL / ".snaps" / sys.argv[-1].replace("/", "_") / "ORDER"
    if order.exists():
        sys.stdout.write(order.read_text())
elif cmd == "send":
    name = sys.argv[-1]
    head = (f"INCR {sys.argv[3]} {name}\n" if sys.argv[2] == "-i"
            else f"FULL {name}\n")
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w") as t:
        t.add(snap_dir(name), arcname="snap")
    data = head.encode() + buf.getvalue()
    keep(".sent", data)
    sys.stdout.buffer.write(data)
elif cmd == "receive":
    data = sys.stdin.buffer.read()
    keep(".received", data)
    out = POOL / sys.argv[-1]
    if out.exists():
        shutil.rmtree(out)
    with tarfile.open(fileobj=io.BytesIO(data[data.index(b"\n") + 1:])) as t:
        t.extractall(POOL / ".rx")
    shutil.move(str(POOL / ".rx" / "snap"), str(out))
else:
    sys.exit(1)
"""


def zfs_commands(np, seed: int) -> int:
    """``zfsbackup`` twice and ``zfsrestore`` at -m4 through the CLI on the
    card, on a fake zfs (``ZPAQ_ZFS_CMD``): the streams received are the
    streams sent, the restored dataset the backed-up one, and the CM
    kernels launched."""
    from zpaqfranz_tpu_torch.ops import cm_decode as cmd, cm_encode as cme

    pool = WORK / "pool"
    ds = "tank/data"
    (pool / ds).mkdir(parents=True)
    shim = WORK / "zfs"
    shim.write_text(FAKE_ZFS)
    shim.chmod(0o755)
    saved = {k: os.environ.get(k) for k in ("ZPAQ_ZFS_CMD", "FAKE_POOL")}
    os.environ.update(ZPAQ_ZFS_CMD=str(shim), FAKE_POOL=str(pool))
    rng = np.random.default_rng(seed)
    body = lane_payloads(np, rng, [ZFS_BYTES])[0]
    try:
        for k in (1, 2):
            (pool / ds / "data.bin").write_bytes(body)
            e0 = cme.launches
            t0 = time.perf_counter()
            rc, out = run_cli(["zfsbackup", "z", ds, "-m4", "-tpu"])
            check(rc == 0 and f"@zpaqfranz0000000{k - 1}:" in out,
                  f"zfsbackup {k}: rc {rc}, {out!r}")
            check(cme.launches > e0, f"zfsbackup {k} did not launch the CM "
                  f"encoder")
            log(f"zfsbackup {k} -m4: {out.strip()} "
                f"({time.perf_counter() - t0:.2f} s)")
            body = body[:-4096] + rng.bytes(4096)
        d0 = cmd.launches
        t0 = time.perf_counter()
        rc, out = run_cli(["zfsrestore", "z", ds, "-to", "tank/back",
                           "-tpu"])
        dt = time.perf_counter() - t0
        check((rc, out) == (0, "2 streams received\n"),
              f"zfsrestore: rc {rc}, {out!r}")
        check(cmd.launches > d0, "zfsrestore did not launch the CM decoder")
        sent = [(pool / ".sent" / str(i)).read_bytes() for i in range(2)]
        got = [(pool / ".received" / str(i)).read_bytes() for i in range(2)]
        check(got == sent, "zfsrestore: the received streams differ from "
              "the sent ones")
        check((pool / "tank" / "back" / "data.bin").read_bytes()
              == (pool / ds / "data.bin").read_bytes(),
              "zfsrestore: the restored dataset differs")
        log(f"zfsrestore -m4: 2 streams of {list(map(len, sent))} bytes "
            f"received in {dt:.2f} s, equal to the streams sent")
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return 0


def autotest_all() -> int:
    """``autotest -all`` on the card: every level's round trip (levels 3-5
    through the CM kernels) and the expected failures."""
    from zpaqfranz_tpu_torch.ops import cm_decode as cmd, cm_encode as cme

    e0, d0 = cme.launches, cmd.launches
    t0 = time.perf_counter()
    rc, out = run_cli(["autotest", "-all", "-tpu"])
    check(rc == 0 and out.rstrip().endswith("autotest: PASS")
          and out.count("expected-failure=detected") == 3
          and out.count(": OK (") == 6, f"autotest -all: rc {rc}, {out!r}")
    check(cme.launches > e0 and cmd.launches > d0,
          "autotest -all did not launch the CM kernels")
    log(f"autotest -all: PASS in {time.perf_counter() - t0:.2f} s, "
        f"{cme.launches - e0} encode and {cmd.launches - d0} decode "
        f"launches")
    return 0


def engine_gate(torch, np, runs, seed: int) -> int:
    """The engine gate (``device_policy.py``): ``b`` through the CLI writes
    the record of this card, printed; for each main-path level (one lane)
    the gate's decision and predicted rates beside the ``a`` the main path
    timed on the card and on the host engine, the decision equal to the
    faster engine wherever the two differ by more than 2x (-m4 to the host
    engine); an unforced ``a -m3`` of a 1.25 MiB text tree (one lane)
    under the measured record (no CM encode launch where the record picks
    the host engine) and under a record with the card 10x faster (CM
    encode launches), the two archives identical (``now_date`` pinned);
    an unforced ``t`` of that archive under the measured record, through
    the SHA-1 kernel."""
    import zpaqfranz_tpu_torch.jidac.add as add_mod
    from zpaqfranz_tpu_torch import device_policy as dp
    from zpaqfranz_tpu_torch.ops import cm_encode as cme, sha1
    from zpaqfranz_tpu_torch.parallel import device_bench as db

    path = pathlib.Path(dp.cal_path())
    check(path.parent == WORK, f"the record {path} is not the smoke's own")
    path.unlink(missing_ok=True)
    t0 = time.perf_counter()
    rc, out = run_cli(["b"])
    check(rc == 0, f"b: rc {rc}, {out[-2000:]!r}")
    log(f"b (the engine gate's calibration) in "
        f"{time.perf_counter() - t0:.1f} s:")
    for line in out.splitlines():
        log(f"  | {line}")
    cal = dp.load_calibration()
    check(cal.get("card") == torch.cuda.get_device_name(0),
          f"b's record is of {cal.get('card')!r}")
    for key in ("hash_device_MBps", "hash_host_MBps", "codec_device_MBps",
                "codec_host_MBps"):
        check(cal.get(key, 0) > 0, f"b recorded no {key}")
    for m in db.CAL_METHODS:
        got = dp.lane_rates(cal, m)
        check(1 in got and len(got) == 2,
              f"b's record of -m{m} holds lane counts {sorted(got)}")
    log(f"engine gate: the record of {cal['card']} ({card_line()}), "
        f"{db.CAL_LANE_BYTES:,} bytes a lane: {json.dumps(cal)}")

    for r in sorted(runs, key=lambda r: r["level"]):
        level = r["level"]
        d = dp.decide("codec", r["bytes"], level, r["lanes"])
        rates = dp.lane_rates(cal, level)
        dev, host = rates[dp.judged_lanes(rates, r["lanes"])]
        card_s, host_s = r["a_s"], r["a_host_s"]
        log(f"-m{level}, {r['lanes']} lane(s), {r['bytes']:,} bytes: gate -> "
            f"{'card' if d.device else 'host engine'}; predicted card "
            f"{dev} MB/s, host engine {host} MB/s (card/host "
            f"{dev / host:.4f}); measured a: card {card_s:.2f} s "
            f"({r['cm_bytes'] / card_s / 1e6:.4f} MB/s of "
            f"{r['cm_bytes']:,} modeled bytes), host engine {host_s:.2f} s "
            f"({r['cm_bytes'] / host_s / 1e6:.4f} MB/s; card/host "
            f"{host_s / card_s:.4f}); predicted/measured card/host "
            f"{dev / host / (host_s / card_s):.3f}")
        if max(card_s, host_s) > 2 * min(card_s, host_s):
            check(d.device == (card_s < host_s),
                  f"-m{level}: the gate picks the slower engine: {d.why}")
        if level == "4":
            check(not d.device, f"-m4 one lane not gated to the host "
                  f"engine: {d.why}")

    src = WORK / "gsrc"
    text_corpus(np, src, GATE_BYTES, seed)
    date = 20260203040506
    real_now = add_mod.now_date
    add_mod.now_date = lambda: date
    measured = path.read_text()
    fast = json.loads(measured)
    for e in fast["methods"]["3"].values():
        e["device_MBps"] = 10 * e["host_MBps"]
    card_rec = WORK / "device_cal_card.json"
    card_rec.write_text(json.dumps(fast))
    arcs = {}
    try:
        for name, rec in (("measured", path), ("card", card_rec)):
            os.environ[dp.CAL_ENV] = str(rec)
            e0 = cme.launches
            err = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stderr(err):
                rc, out = run_cli(["a", f"g_{name}", "gsrc", "-m3"])
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            launches = cme.launches - e0
            check(rc == 0, f"a -m3 under the {name} record: rc {rc}, {out!r}")
            gate = err.getvalue().strip()
            log(f"unforced a -m3 of {GATE_BYTES:,} bytes under the {name} "
                f"record: {dt:.2f} s, {launches} CM encode launches; {gate}")
            if name == "card":
                check(launches > 0, "the card-favouring record coded no "
                      "lane on the card")
            elif "-> host engine" in gate:
                check(launches == 0, "the gate picked the host engine, "
                      "yet the card coded")
            else:
                log("  (the measured record sends one -m3 lane to the card)")
            arcs[name] = (WORK / f"g_{name}.zpaq").read_bytes()
    finally:
        add_mod.now_date = real_now
        os.environ[dp.CAL_ENV] = str(path)
    check(arcs["measured"] == arcs["card"], "the two unforced adds differ")
    s0 = sha1.launches
    err = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(err):
        rc, out = run_cli(["t", "g_measured"])
    torch.cuda.synchronize()
    check(rc == 0 and "all OK" in out, f"t: rc {rc}, {out!r}")
    check(sha1.launches > s0, f"the unforced t did not launch the SHA-1 "
          f"kernel: {err.getvalue().strip()}")
    log(f"unforced t under the measured record: {out.strip()} in "
        f"{time.perf_counter() - t0:.2f} s, {sha1.launches - s0} SHA-1 "
        f"launches; {err.getvalue().strip()}")
    shutil.rmtree(src)
    return 0


def sanitize_phase() -> None:
    """Hold every CUDA entry point to its exact allocation bounds
    (``experiments/sanitize.py``): record the matrix's cases on the normal
    path (each held against its plain version), then replay every launch
    in a process that never imports torch, each buffer exactly its
    tensor's bytes against an unmapped granule, after its end and then
    before its start, every output byte-equal to the recording. One line
    per entry point. compute-sanitizer's memcheck and racecheck run the
    smallest SHA-1 and CM decode cases too, where the tool can check this
    card; where it cannot, the phase says why. Any fault fails the
    smoke."""
    from zpaqfranz_tpu_torch.experiments import sanitize as sz

    if SAN_WORK.exists():
        shutil.rmtree(SAN_WORK)
    try:
        t0 = time.perf_counter()
        wide = []          # the 16 MiB-block lanes' recording seconds
        counts = sz.record(SAN_WORK / "matrix", log=lambda m: wide.extend(
            float(t) for t in re.findall(r"16 MiB blocks.*\(([\d.]+) s\)$",
                                         m)))
        rec_s = time.perf_counter() - t0
        rec_mb = sum(f.stat().st_size for f in (SAN_WORK / "matrix").rglob(
            "*") if f.is_file()) / 1e6
        rc, _, sec, text = sz.run_replay(SAN_WORK / "matrix",
                                         ("end", "start"), timeout=900)
        check(rc == 0, f"the guard replay failed:\n{sz.tail(text, 30)}")
        seen: dict = {}
        for ln in text.splitlines():
            m = re.match(r"replay \[guard (\w+)\] (\w+): (\d+) cases, "
                         r"(\d+) launches, 0 faults, ([\d.]+) s, at most "
                         r"(\d+) B", ln)
            if m:
                seen.setdefault(m[2], {})[m[1]] = (int(m[3]), int(m[4]),
                                                  float(m[5]), int(m[6]))
        check(set(seen) == set(sz.launch_symbols()) == set(counts)
              and all(set(v) == {"end", "start"} for v in seen.values()),
              f"the guard replay missed entry points: {sorted(seen)}")
        for sym, v in seen.items():
            (cases, n, e_s, slack), (_, _, s_s, _) = v["end"], v["start"]
            check(cases == counts[sym], f"{sym}: {cases} cases replayed of "
                  f"{counts[sym]}")
            log(f"sanitize {sym}: {cases} cases ({n} launches), 0 faults in "
                f"both guard passes, {e_s + s_s:.3f} s (end {e_s:.3f}, "
                f"start {s_s:.3f}), at most {slack} B after a tensor's end")
        log(f"sanitize: recorded {sum(counts.values())} cases in "
            f"{rec_s:.1f} s ({len(wide)} 16 MiB-block lanes {sum(wide):.1f} "
            f"s), {rec_mb:.1f} MB on disk; replayed both guard passes in "
            f"{sec:.1f} s")
        for tool in ("memcheck", "racecheck"):
            rc, errors, sec, text = sz.run_replay(
                SAN_WORK / "matrix", (), tool, SAN_TOOL_CASES, timeout=60)
            gone = sz.UNAVAILABLE.search(text)
            if gone:
                log(f"sanitize {tool}: cannot check this card "
                    f"({gone.group(1)}); the guard passes stand in")
                continue
            check(rc == 0 and errors == 0, f"{tool} reported {errors} "
                  f"errors (exit {rc}):\n{sz.tail(text, 30)}")
            log(f"sanitize {tool}: {len(SAN_TOOL_CASES)} cases, 0 errors, "
                f"{sec:.1f} s")
    finally:
        shutil.rmtree(SAN_WORK, ignore_errors=True)


def main() -> int:
    if not (ROOT / "zpaqfranz_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(zpaqfranz_tpu_torch/ not found)", file=sys.stderr)
        return 2
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from zpaqfranz_tpu_torch import device_policy
    # the engine gate's record is the smoke's own: neither a record left in
    # ~/.cache nor one the ladder writes can steer a phase
    os.environ[device_policy.CAL_ENV] = str(WORK / "device_cal.json")
    from zpaqfranz_tpu_torch.codec.methods import make_model
    from zpaqfranz_tpu_torch.device import resolve
    from zpaqfranz_tpu_torch.ops import build, cm_decode as cmd
    from zpaqfranz_tpu_torch.ops import cm_encode as cme, sha1, sha256
    from zpaqfranz_tpu_torch.ops import hash_batched as hb
    from zpaqfranz_tpu_torch.ops.cm_model import kernel_unit

    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    dev = resolve(None)

    t0 = time.perf_counter()
    labels = {}
    # every CM unit a path runs, built before the multi-host ranks start:
    # the libraries are named by their sources' hash, so the ranks find them
    models = {**cm_models(), MH_METHOD: make_model(MH_METHOD)[0]}
    for name, model in models.items():
        for kernel in ("cm_decode", "cm_encode"):
            unit = kernel_unit(kernel, model)
            labels.setdefault(build.unit_key(unit), (unit, []))[1].append(
                name)
    build.build(list(build.SOURCES) + [u for u, _ in labels.values()])
    log(f"built {', '.join(build.SOURCES)} and the CM kernels of "
        f"{len(labels) // 2} specialised models (HCOMP, combine and "
        f"phases) in "
        f"{time.perf_counter() - t0:.1f} s")
    for key, rec in build.BUILD_LOG.items():
        name = key if key not in labels else (
            f"{key.split('+')[0]} specialised for "
            f"{'/'.join(labels[key][1])}")
        log(f"  {name}: {rec['seconds']:.1f} s")
        for line in str(rec["ptxas"]).splitlines():
            if "registers" in line or "spill" in line:
                log(f"    {line.strip()}")

    t0 = time.perf_counter()
    steps = chase_steps(torch, dev)
    log(f"  (the chase took {time.perf_counter() - t0:.1f} s)")
    kernels = []
    for fn, seed in ((lambda s: check_hash(torch, np, dev, s, "sha1"), 1),
                     (lambda s: check_hash(torch, np, dev, s, "sha256"), 6),
                     (lambda s: check_cm(torch, np, dev, s), 2),
                     (lambda s: check_cm_encode(torch, np, dev, s, steps), 7)):
        t0 = time.perf_counter()
        kernels.append(fn(seed))
        torch.cuda.synchronize()
        log(f"  ({kernels[-1]['name']} checks took "
            f"{time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    lens, frag = fragment_shape(np, 10)
    entry, crcs = check_crc(torch, np, dev, 9, lens, frag)
    kernels.append(entry)
    torch.cuda.synchronize()
    log(f"  (crc32_lanes checks took {time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    device_bwt(torch, np, dev, 14)
    log(f"  (device BWT took {time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    kernels += hcomp_entries(profile_cm(torch, np, dev, 8),
                             {k["name"]: k["max_abs_err"] for k in kernels})
    log(f"  (CM one-lane rates and profiles took "
        f"{time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    kernels += check_micro(torch, dev, steps)
    log(f"  (table-access kernel checks took {time.perf_counter() - t0:.1f} "
        f"s)")

    if WORK.exists():
        shutil.rmtree(WORK)
    WORK.mkdir(parents=True)
    modules = {"sha1_lanes": sha1, "sha256_lanes": sha256, "cm_decode": cmd,
               "cm_encode": cme, "crc32_lanes": hb}

    def path_counts(what: str, fn) -> dict:
        """Run one path with every count set to 0 just before it; its
        launches, read just after (``fn``'s return value: launches in
        other processes, added to cm_encode)."""
        for mod in modules.values():
            mod.launches = 0
        for mod in (cmd, cme):
            mod.hcomp_launches.update(fast=0, interp=0)
            mod.combine_launches.update(fast=0, generic=0)
            mod.phases_launches.update(fast=0, generic=0)
        t0 = time.perf_counter()
        elsewhere = fn()
        torch.cuda.synchronize()
        got = {name: mod.launches for name, mod in modules.items()}
        for name, mod in (("cm_decode", cmd), ("cm_encode", cme)):
            got[f"{name}_hcomp_fast"] = mod.hcomp_launches["fast"]
            check(mod.hcomp_launches == {"fast": mod.launches, "interp": 0},
                  f"the {what}'s {name} launches did not all run the "
                  f"specialised HCOMP step: {mod.hcomp_launches}")
            check(mod.combine_launches == {"fast": mod.launches,
                                           "generic": 0},
                  f"the {what}'s {name} launches did not all run the "
                  f"specialised combine: {mod.combine_launches}")
            check(mod.phases_launches == {"fast": mod.launches,
                                          "generic": 0},
                  f"the {what}'s {name} launches did not all run the "
                  f"generated phases: {mod.phases_launches}")
        got["cm_encode"] += elsewhere
        log(f"{what} launches: {got}"
            + (f" ({elsewhere} cm_encode in the ranks' processes)"
               if elsewhere else "")
            + f"; {time.perf_counter() - t0:.1f} s")
        return got

    runs = []

    def archive_path() -> int:
        runs.extend([
            main_path(torch, np, dev, "4", M4_BYTES, 4, damage=False),
            main_path(torch, np, dev, "3", M3_BYTES, 3, damage=True),
            main_path(torch, np, dev, "5", M5_BYTES, 5, damage=False)])
        return 0

    paths = (
        ("main path", archive_path),
        ("sharded lanes", lambda: sharded_lanes(torch, np, dev, 11)),
        ("multi-host add", lambda: multihost_add(torch, np, dev, 12)),
        ("backup commands", lambda: backup_commands(np, 13)),
        ("autotest", autotest_all),
        ("batched-hash path", lambda: batched_hash_path(
            torch, np, dev, lens, frag, crcs)),
        ("batched coders", lambda: batched_coders(torch, np, dev, 15)),
        ("zfs commands", lambda: zfs_commands(np, 16)),
        ("engine gate", lambda: engine_gate(torch, np, runs, 17)))
    counts: dict = {}
    try:
        for what, fn in paths:
            for name, n in path_counts(what, fn).items():
                counts[name] = counts.get(name, 0) + n
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    log(f"launches on the paths: {counts}")
    t0 = time.perf_counter()
    micro_counts = measurement_path(torch, dev)
    log(f"  (measurement path took {time.perf_counter() - t0:.1f} s)")
    counts.update({name: micro_counts[kind] for name, _, kind, _ in MICRO})
    t0 = time.perf_counter()
    sanitize_phase()
    log(f"  (sanitize phase took {time.perf_counter() - t0:.1f} s)")
    for k in kernels:
        k["launches"] = counts[k["name"]]
        check(k["launches"] > 0, f"{k['name']} never launched on its path")
    for r in runs:
        log(f"-m{r['level']}: {r['bytes']} bytes, a {r['a_s']:.2f} s on the "
            f"card ({r['enc_KBps']:.2f} KB/s per encode lane), "
            f"{r['a_host_s']:.2f} s on the host engine; x {r['x_s']:.2f} s "
            f"({r['lane_KBps']:.2f} KB/s per decode lane), t {r['t_s']:.2f} s")
    log(f"smoke took {time.perf_counter() - T0:.1f} s")

    order = ("name", "route", "source", "replaces", "launches",
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms")
    print(json.dumps({"kernels": [{k: kk[k] for k in order}
                                  for kk in kernels]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
