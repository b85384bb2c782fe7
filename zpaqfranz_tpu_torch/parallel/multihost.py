"""Multi-host distributed add: hash-sharded dedup and an ordered gather.

Mirrors ``zpaqfranz_tpu/parallel/multihost.py``. The reference zpaqfranz is
one process; its story for several machines is "rsync the append-only
archive" (reference README.md:301-313). Here several hosts, one process
each, append one transaction together:

 - every host digests a share of the changed files (CDC and SHA-1 in the
   native engine; the input files come from shared storage, the
   reference's own file-server deployment);
 - the existing archive's dedup table is sharded by hash prefix over the
   hosts, and an all-to-all exchange answers "is this fragment stored
   already?" (index metadata, not data);
 - the surviving fragments are allgathered as compact descriptors in file
   order, and every host replays the same deterministic assignment
   (``jidac.add.FragmentPlanner``), so fragment IDs, d-block packing and
   therefore the archive's bytes do not depend on the number of hosts;
 - each host codes the d blocks it owns (round robin by job index)
   through ``jidac.add.code_jobs``: a modeled block as a lane of the CM
   encode kernel on its card unless the host engine is asked for, and an
   ordered gather brings the blocks to host 0, the one writer (the
   reference's write mutex, zsfx.cpp:1711);
 - host 0 appends the c + d... + h... + i transaction.

Communication:
 - ``TcpComm``: collectives routed through rank 0 over plain sockets (rank
   0 listens, the others connect). What crosses hosts is index metadata and
   coded blocks, host objects, not device tensors.
 - ``TorchComm``: the same five collectives over ``torch.distributed`` on
   the gloo backend (``init_torch_distributed``). The payloads are pickled
   host objects, so NCCL has no role here (and NCCL refuses two ranks on
   one card).

Gate (tests/test_torch_multihost.py): the archive written by 1, 2 or 3
hosts equals, byte for byte, the single-process ``jidac.add.add`` of the
same tree.
"""

from __future__ import annotations

import datetime
import hashlib
import io
import os
import pathlib
import pickle
import re
import socket
import struct
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch.distributed as tdist

from .. import native
from ..jidac import add as jadd
from ..ops import cm_encode as cme

#: a worker's line with its count of CM encode launches
LAUNCH_LINE = re.compile(r"rank (\d+): cm_encode launches (\d+)")


# ---------------------------------------------------------------------------
# Communication backends
# ---------------------------------------------------------------------------

class CommError(RuntimeError):
    pass


def _send_msg(sock: socket.socket, obj) -> None:
    blob = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    sock.sendall(struct.pack("<Q", len(blob)) + blob)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = io.BytesIO()
    got = 0
    while got < n:
        chunk = sock.recv(min(1 << 20, n - got))
        if not chunk:
            raise CommError("peer closed")
        buf.write(chunk)
        got += len(chunk)
    return buf.getvalue()


def _recv_msg(sock: socket.socket):
    (n,) = struct.unpack("<Q", _recv_exact(sock, 8))
    return pickle.loads(_recv_exact(sock, n))


class TcpComm:
    """Coordinator-routed collectives: rank 0 listens, ranks 1..W-1 connect.

    All collectives route through rank 0 (world sizes here are hosts, not
    cards: single digits to low tens; the payloads are index metadata and
    coded blocks)."""

    def __init__(self, rank: int, world: int, coordinator: str,
                 timeout: float = 120.0):
        self.rank = rank
        self.world = world
        host, port_s = coordinator.rsplit(":", 1)
        port = int(port_s)
        self._peers: Dict[int, socket.socket] = {}
        if world == 1:
            return
        if rank == 0:
            srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            srv.bind((host, port))
            srv.listen(world)
            srv.settimeout(timeout)
            for _ in range(world - 1):
                conn, _addr = srv.accept()
                conn.settimeout(timeout)
                r = _recv_msg(conn)
                self._peers[r] = conn
            srv.close()
        else:
            deadline = time.time() + timeout
            while True:
                try:
                    s = socket.create_connection((host, port), timeout=5.0)
                    break
                except OSError:
                    if time.time() > deadline:
                        raise CommError("coordinator unreachable")
                    time.sleep(0.05)
            s.settimeout(timeout)
            _send_msg(s, rank)
            self._peers[0] = s

    def close(self) -> None:
        for s in self._peers.values():
            try:
                s.close()
            except OSError:
                pass
        self._peers.clear()

    # -- collectives --------------------------------------------------------
    def broadcast(self, obj=None):
        """Rank 0's obj to everyone."""
        if self.world == 1:
            return obj
        if self.rank == 0:
            for r in range(1, self.world):
                _send_msg(self._peers[r], obj)
            return obj
        return _recv_msg(self._peers[0])

    def gather(self, obj) -> Optional[List]:
        """Everyone's obj to rank 0 (returns list indexed by rank; None on
        other ranks)."""
        if self.world == 1:
            return [obj]
        if self.rank == 0:
            out = [None] * self.world
            out[0] = obj
            for r in range(1, self.world):
                out[r] = _recv_msg(self._peers[r])
            return out
        _send_msg(self._peers[0], obj)
        return None

    def allgather(self, obj) -> List:
        got = self.gather(obj)
        return self.broadcast(got)

    def alltoall(self, per_dst: List) -> List:
        """per_dst[r] goes to rank r; returns [from rank 0, from 1, ...]."""
        if self.world == 1:
            return [per_dst[0]]
        rows = self.gather(per_dst)          # rank0: rows[src][dst]
        if self.rank == 0:
            cols = [[rows[src][dst] for src in range(self.world)]
                    for dst in range(self.world)]
            for r in range(1, self.world):
                _send_msg(self._peers[r], cols[r])
            return cols[0]
        return _recv_msg(self._peers[0])

    def barrier(self) -> None:
        self.allgather(None)


class TorchComm:
    """The same collectives over ``torch.distributed`` (gloo backend), for
    deployments that bring up a process group anyway. The process group
    must be initialised (``init_torch_distributed``); objects are pickled
    by ``torch.distributed``'s object collectives."""

    def __init__(self):
        self.rank = tdist.get_rank()
        self.world = tdist.get_world_size()

    def allgather(self, obj) -> List:
        out: List = [None] * self.world
        tdist.all_gather_object(out, obj)
        return out

    def broadcast(self, obj=None):
        box = [obj]
        tdist.broadcast_object_list(box, src=0)
        return box[0]

    def gather(self, obj) -> Optional[List]:
        out = [None] * self.world if self.rank == 0 else None
        tdist.gather_object(obj, out, dst=0)
        return out

    def alltoall(self, per_dst: List) -> List:
        rows = self.allgather(per_dst)
        return [rows[src][self.rank] for src in range(self.world)]

    def barrier(self) -> None:
        tdist.barrier()

    def close(self) -> None:
        tdist.destroy_process_group()


def init_torch_distributed(coordinator: str, world: int, rank: int,
                           timeout: float = 120.0) -> TorchComm:
    """Join a gloo process group of ``world`` ranks whose rank 0 listens at
    ``coordinator`` (host:port), and return its collectives. A collective
    that waits longer than ``timeout`` seconds raises."""
    tdist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator}", world_size=world,
        rank=rank, timeout=datetime.timedelta(seconds=timeout))
    return TorchComm()


# ---------------------------------------------------------------------------
# The distributed add pipeline
# ---------------------------------------------------------------------------

def _hash_owner(sha: bytes, world: int) -> int:
    return sha[0] % world


def dist_add(comm, archive: str, files: Sequence[str], method: str = "1",
             fragment_bits: int = 16, date: Optional[int] = None,
             key: Optional[str] = None, use_device: bool = True,
             device=None, franz: str = "xxhash64") -> Tuple[int, int, int]:
    """Distributed append of one transaction; archive bytes are identical
    to the single-process ``jidac.add.add`` of the same tree.

    Requires shared storage for the input files (every rank can open them);
    only rank 0 touches the archive. As in ``add``, modeled d blocks
    (-m3..-m5) are coded as lanes of the CM encode kernel on ``device``
    (None = the CUDA card, which must be present; "cpu" = the plain PyTorch
    version), and ``use_device=False`` asks for the host engine. Returns
    (files, frags, bytes) on rank 0 and zeros elsewhere."""
    from ..codec.methods import make_model

    rank, world = comm.rank, comm.world
    model, pre = make_model(method)
    max_job = jadd.max_job_bytes(pre, fragment_bits)  # raises: nothing written
    if use_device and model is not None and model.n > 0:
        from ..device import resolve
        device = resolve(device)      # no card: every rank raises here
    else:
        device = None

    # ---- stage 0 (rank 0): open archive, diff, broadcast the plan --------
    if rank == 0:
        ctx = jadd.open_for_append(archive, key=key)
        jd = ctx.jd
        ext = jadd.scan_files(files)
        date = jadd.pick_date(jd, date)
        changed, deleted = jadd.diff_index(jd, ext, files)
        old = jadd.old_dedup_table(jd)
        # hash-sharded old-index shards: owner r receives {sha -> id}
        shards: List[Dict[bytes, int]] = [dict() for _ in range(world)]
        for sha, fid in old.items():
            shards[_hash_owner(sha, world)][sha] = fid
        plan = {"date": date, "changed": changed, "deleted": deleted,
                "ext": ext, "next_frag": len(jd.ht)}
    else:
        ctx = None
        shards = None
        plan = None
    plan = comm.broadcast(plan)
    my_shard: Dict[bytes, int] = comm.alltoall(
        shards if rank == 0 else [None] * world)[0] or {}
    changed: List[str] = plan["changed"]
    date = plan["date"]
    if not changed and not plan["deleted"]:
        return (0, 0, 0)

    # ---- stage 1: digest my shard of the changed files --------------------
    # round robin by file index keeps the order reconstruction trivial
    mine = [(i, name) for i, name in enumerate(changed) if i % world == rank]
    my_digests: Dict[int, Tuple[Tuple[int, int],
                                List[Tuple[bytes, int, int]]]] = {}
    for i, name in mine:
        data = pathlib.Path(name).read_bytes()
        frags, crc, xxh = native.digest_file(data, fragment_bits)
        my_digests[i] = ((crc, xxh), [(sha, start, end)
                                      for sha, start, end in frags])

    # ---- stage 2: hash-sharded dedup queries against the OLD index --------
    # (all-to-all: each rank asks the owner of each hash; answers come back
    # as {sha: old_id}; only 1/world of the old table lives on each host)
    queries: List[List[bytes]] = [[] for _ in range(world)]
    for i, (_sums, frags) in my_digests.items():
        for sha, _s, _e in frags:
            queries[_hash_owner(sha, world)].append(sha)
    incoming = comm.alltoall(queries)
    answers = [{sha: my_shard[sha] for sha in q if sha in my_shard}
               for q in incoming]
    replies = comm.alltoall(answers)
    old_ids: Dict[bytes, int] = {}
    for rep in replies:
        old_ids.update(rep)

    # ---- stage 3: allgather descriptors, replay assignment everywhere -----
    rows = comm.allgather(
        [(i, my_digests[i][0], my_digests[i][1]) for i, _ in mine])
    per_file: Dict[int, Tuple[Tuple[int, int],
                              List[Tuple[bytes, int, int]]]] = {}
    all_old_ids: Dict[bytes, int] = dict(old_ids)
    for row in rows:
        for i, sums, frags in row:
            per_file[i] = (sums, frags)
    # old-id answers were only fetched for local queries; allgather the
    # merged map so the replay sees every known fragment
    for m in comm.allgather(old_ids):
        all_old_ids.update(m)

    planner = jadd.FragmentPlanner(dict(all_old_ids), plan["next_frag"],
                                   pre, keep_bytes=False)
    jobs: List[jadd._Job] = []
    file_sums: Dict[str, Tuple[int, int]] = {}
    for i, name in enumerate(changed):
        sums, frags = per_file[i]
        file_sums[name] = sums
        jobs.extend(planner.add_file(name, frags, None))
    tail = planner.finish()
    if tail is not None:
        jobs.append(tail)

    # ---- stage 4: code my jobs (round robin by job index) -----------------
    # a job carries spans; each coder reads its bytes from shared storage
    my_jobs = [(k, job) for k, job in enumerate(jobs) if k % world == rank]
    blocks = jadd.code_jobs(model, pre, [job for _k, job in my_jobs], date,
                            device, max_job, threads=1)
    my_blocks = {k: blk for (k, _job), blk in zip(my_jobs, blocks)}

    # ---- stage 5: ordered gather to the writer host ------------------------
    gathered = comm.gather(my_blocks)
    if rank != 0:
        return (0, 0, 0)
    d_blocks: List[bytes] = [b""] * len(jobs)
    for m in gathered:
        for k, blk in m.items():
            d_blocks[k] = blk

    out, ix = jadd.build_transaction(
        date, jobs, d_blocks, changed, plan["deleted"], plan["ext"],
        file_sums, planner.file_ptrs, planner.first_frag, franz=franz)
    jadd.commit_transaction(ctx, out, ix)
    return len(changed), len(planner.new_ht), len(out)


# ---------------------------------------------------------------------------
# Scaling harness: MB/s at 1 host against N hosts
# ---------------------------------------------------------------------------

def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def scaling_report(corpus: str, worlds: Sequence[int] = (1, 2),
                   method: str = "1", port: int = 0,
                   flags: Sequence[str] = (), timeout: float = 3600.0
                   ) -> dict:
    """Time ``dist_add`` over the corpus at each world size; returns
    {world: {'seconds': s, 'MBps': r, 'cm_encode_launches': n,
    'archive_sha1': h, 'efficiency_vs_1': e}}, ``n`` the CM encode
    launches of all the world's ranks as each printed them, ``h`` the
    SHA-1 of the archive written (dated 2026-01-02 03:04:05).

    Spawns one process per rank (all on this host: the harness's shape;
    real multi-host runs point --coordinator at host 0), each with
    ``flags`` (``--notpu``, ``--device cpu``, ``--torch-dist``). Archive
    bytes are checked identical across world sizes. A rank that fails, or
    a world that takes more than ``timeout`` seconds, raises; every
    process started is ended."""
    import subprocess
    import sys
    import tempfile

    corpus_path = pathlib.Path(corpus).resolve()
    nbytes = sum(p.stat().st_size
                 for p in corpus_path.rglob("*") if p.is_file())
    out: dict = {}
    ref_bytes = None
    date = 20260102030405
    env = dict(os.environ)
    pkg_root = str(pathlib.Path(__file__).resolve().parents[2])
    env["PYTHONPATH"] = pkg_root + os.pathsep + env.get("PYTHONPATH", "")
    for world in worlds:
        with tempfile.TemporaryDirectory() as td:
            arc = str(pathlib.Path(td) / "s.zpaq")
            p = port or _free_port()
            logs = [(open(pathlib.Path(td) / f"r{r}.out", "w+"),
                     open(pathlib.Path(td) / f"r{r}.err", "w+"))
                    for r in range(world)]
            procs = []
            try:
                t0 = time.perf_counter()
                for r in range(world):
                    procs.append(subprocess.Popen(
                        [sys.executable, "-m",
                         "zpaqfranz_tpu_torch.parallel.multihost",
                         "--rank", str(r), "--world", str(world),
                         "--coordinator", f"127.0.0.1:{p}",
                         "--method", method, "--date", str(date), *flags,
                         arc, corpus_path.name],
                        cwd=corpus_path.parent, env=env,
                        stdout=logs[r][0], stderr=logs[r][1]))
                deadline = time.perf_counter() + timeout
                for pr in procs:
                    pr.wait(timeout=max(1.0, deadline - time.perf_counter()))
                dt = time.perf_counter() - t0
                launches = 0
                for pr, (o, e) in zip(procs, logs):
                    o.seek(0)
                    e.seek(0)
                    if pr.returncode != 0:
                        raise RuntimeError(
                            f"world={world}: a rank exited "
                            f"{pr.returncode}: {e.read()[-2000:]}")
                    launches += sum(int(m.group(2)) for m in
                                    LAUNCH_LINE.finditer(o.read()))
            finally:
                for pr in procs:
                    if pr.poll() is None:
                        pr.kill()
                        pr.wait()
                for o, e in logs:
                    o.close()
                    e.close()
            blob = pathlib.Path(arc).read_bytes()
            if ref_bytes is None:
                ref_bytes = blob
            elif blob != ref_bytes:
                raise RuntimeError(f"world={world}: archive bytes diverged")
            out[world] = {"seconds": round(dt, 2),
                          "MBps": round(nbytes / dt / 1e6, 2),
                          "cm_encode_launches": launches,
                          "archive_sha1": hashlib.sha1(blob).hexdigest()}
    base = out[worlds[0]]["MBps"]
    for world in worlds:
        out[world]["efficiency_vs_1"] = round(
            out[world]["MBps"] / (base * world / worlds[0]), 3)
    return out


# ---------------------------------------------------------------------------
# Worker entry point (one process per host)
# ---------------------------------------------------------------------------

_DEVICE_NAME = re.compile(r"cpu|cuda(:\d+)?")


def _main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse
    import sys
    argv = list(sys.argv[1:] if argv is None else argv)
    # the reference's bare --device (its only form) means the card
    for i, a in enumerate(argv):
        if a == "--device" and not (i + 1 < len(argv)
                                    and _DEVICE_NAME.fullmatch(argv[i + 1])):
            argv[i] = "--device=cuda"
    ap = argparse.ArgumentParser(
        prog="python -m zpaqfranz_tpu_torch.parallel.multihost",
        description="distributed add worker (one process per host); "
        "modeled blocks are coded on the CUDA card unless --notpu or "
        "--device cpu is given")
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--coordinator", required=True,
                    help="host:port of rank 0's listener")
    ap.add_argument("--method", default="1")
    ap.add_argument("--date", type=int, default=None)
    ap.add_argument("--key", default=None)
    ap.add_argument("--device", default=None,
                    help="cuda[:N] (the default), or cpu for the kernels' "
                    "plain PyTorch versions; bare --device means the card")
    ap.add_argument("--notpu", action="store_true",
                    help="code on the host engine instead of the card")
    ap.add_argument("--torch-dist", action="store_true",
                    help="use torch.distributed (gloo) collectives "
                    "instead of TCP")
    ap.add_argument("archive")
    ap.add_argument("files", nargs="+")
    a = ap.parse_args(argv)
    if a.torch_dist:
        comm = init_torch_distributed(a.coordinator, a.world, a.rank)
    else:
        comm = TcpComm(a.rank, a.world, a.coordinator)
    try:
        nfiles, nfrags, nbytes = dist_add(
            comm, a.archive, a.files, method=a.method, date=a.date,
            key=a.key, use_device=not a.notpu, device=a.device)
        if comm.rank == 0:
            print(f"{nfiles} +files, {nfrags} +frags, {nbytes} bytes")
        # the card and the host engine write the same bytes: the count
        # says which one coded this rank's blocks
        print(f"rank {comm.rank}: cm_encode launches {cme.launches}")
    finally:
        comm.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(_main())
