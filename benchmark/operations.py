"""The operations a cell's window runs back to back: a backup (`a`), a
restore (`x`) or a test (`t`) of a generated tree, each as a user runs it,
through ``zpaqfranz_tpu_torch.cli`` called in-process with ``-tpu``.

Each kind sets up what its window needs (the tree, an archive, the warmed
kernels), runs one operation, and after the window hands what the
operations produced to the reference (``reference/``), which gives the
numbers that decide ``correct``, each with its limit.
"""

from __future__ import annotations

import contextlib
import io
import mmap
import os
import pathlib
import random
import re
import shutil
import time
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import torch

from . import treegen
from .reference import archive as ref
from .reference.codec import Decoder


@dataclass
class Answer:
    """One operation of the window."""
    k: int
    start: float            # host clock, seconds
    end: float
    rc: int
    out: str
    err: str
    nbytes: int             # the bytes the operation's rate counts
    info: Dict = field(default_factory=dict)


def cli(argv: List[str]) -> Tuple[int, str, str]:
    """The port's CLI in this process: exit code, stdout, stderr."""
    from zpaqfranz_tpu_torch import cli as zcli
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = zcli.main(argv)
    return rc, out.getvalue(), err.getvalue()


def _must(argv: List[str]) -> str:
    rc, out, err = cli(argv)
    if rc != 0:
        raise RuntimeError(f"{' '.join(argv)}: exit {rc}: {err.strip()}")
    return out


class Operation:
    """The cell's operation in working directory ``work`` (the process's
    working directory while the cell runs, so the archive names the tree
    as ``tree/...``)."""

    cmd = ""

    def __init__(self, config: Dict, traffic: Dict, work: pathlib.Path,
                 seed: int, device: torch.device, cache: pathlib.Path):
        self.config = config
        self.traffic = traffic
        self.work = work
        self.seed = seed
        self.device = device
        self.cache = cache
        self.switches = list(config["switches"])
        self.files: List[treegen.FileSpec] = []

    @property
    def names(self) -> List[str]:
        return [f.name for f in self.files]

    @property
    def tree_bytes(self) -> int:
        return sum(f.size for f in self.files)

    def make_tree(self) -> None:
        shape = dict(self.traffic, tree_bytes=self.config["tree_bytes"])
        self.files = treegen.write_tree(shape, self.seed,
                                        self.work / "tree", self.device)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()

    def warm(self, *cmds: List[str]) -> None:
        """Run ``cmds`` on a small copy of the tree's first bytes, so the
        window's kernels are built and loaded before it opens."""
        warm = self.work / "warm"
        warm.mkdir()
        with open(self.work / "tree" / self.files[0].name, "rb") as f:
            (warm / "w.bin").write_bytes(f.read(1 << 16))
        for argv in cmds:
            _must(argv)
        shutil.rmtree(warm)
        for p in self.work.glob("warm*"):
            if p.is_dir():
                shutil.rmtree(p)
            else:
                p.unlink()

    def timed(self, k: int, argv: List[str], nbytes: int) -> Answer:
        t0 = time.perf_counter()
        rc, out, err = cli(argv)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return Answer(k, t0, time.perf_counter(), rc, out, err, nbytes)

    def sample(self, n_blocks: int, sizes: List[int]) -> List[int]:
        """``check_blocks`` block indices drawn from the seed, the largest
        block among them; largest first, so the decoding threads finish
        together."""
        k = min(n_blocks, int(self.traffic["check_blocks"]))
        if not k:
            return []
        big = max(range(n_blocks), key=lambda i: sizes[i])
        rest = [i for i in range(n_blocks) if i != big]
        pick = [big] + random.Random(self.seed).sample(rest, k - 1)
        return sorted(pick, key=lambda i: -sizes[i])

    def check_archive(self, path: pathlib.Path, decode: bool
                      ) -> Tuple[ref.Archive, ref.TreeCheck]:
        """The reference's reading of archive ``path`` against the tree:
        the index (every file, fragment and SHA-1), the model of every d
        block, and, with ``decode``, the sampled d blocks' bytes, decoded by
        the reference's own decoder."""
        with open(path, "rb") as f, \
                mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ) as buf:
            arc = ref.read_archive(buf)
            tc = ref.check_tree(arc, self.work / "tree", self.names, "tree/")
            allowed = [bytes.fromhex(self.config["header_hex"]),
                       ref.STORE_HEADER]
            tc.blocks_misheaded = ref.check_headers(buf, arc, allowed)
            if decode:
                usize = [sum(arc.fragments[j].usize
                             for j in range(b.first, b.first + b.frags))
                         for b in arc.blocks]
                pick = self.sample(len(arc.blocks), usize)
                tc.blocks_wrong = ref.check_blocks(
                    bytes(buf), arc, self.work / "tree", tc.where, pick,
                    Decoder(self.cache / "reference"), os.cpu_count() or 4)
        return arc, tc

    def setup(self) -> None:
        raise NotImplementedError

    def run(self, k: int) -> Answer:
        raise NotImplementedError

    def finish(self) -> None:
        """Undo what the window's operations left changed, before the
        check."""

    def check(self, answers: List[Answer]) -> Dict[str, Tuple[float, float]]:
        raise NotImplementedError


def _tree_checks(tc: ref.TreeCheck) -> Dict[str, Tuple[float, float]]:
    return {"files_wrong": (tc.files_wrong, 0),
            "fragments_wrong": (tc.fragments_wrong, 0),
            "blocks_misheaded": (tc.blocks_misheaded, 0),
            "blocks_decoded_wrong": (tc.blocks_wrong, 0)}


class Add(Operation):
    """`a` of the whole tree into a new archive, one per operation."""

    cmd = "a"

    def setup(self) -> None:
        self.make_tree()
        self.warm(["a", "warm.zpaq", "warm", *self.switches, "-tpu"])

    def run(self, k: int) -> Answer:
        return self.timed(k, ["a", f"a{k}.zpaq", "tree", *self.switches,
                              "-tpu"], self.tree_bytes)

    def check(self, answers):
        failed = sum(1 for a in answers if a.rc != 0
                     or f"{len(self.files)} files added" not in a.out)
        pick = random.Random(self.seed).randrange(len(answers))
        worst: Dict[str, Tuple[float, float]] = {}
        for a in answers:
            path = self.work / f"a{a.k}.zpaq"
            if not path.exists():
                continue
            _, tc = self.check_archive(path, decode=a.k == pick)
            for name, (v, lim) in _tree_checks(tc).items():
                worst[name] = (max(v, worst.get(name, (0, 0))[0]), lim)
        return {"failed_ops": (failed, 0), **worst}


class Extract(Operation):
    """`x` of the tree's archive, coded on the card in the set-up, into a
    fresh directory per operation."""

    cmd = "x"

    def setup(self) -> None:
        self.make_tree()
        _must(["a", "arch.zpaq", "tree", *self.switches, "-tpu"])
        self.warm(["a", "warm.zpaq", "warm", *self.switches, "-tpu"],
                  ["x", "warm.zpaq", "-to", "warmout", "-tpu"])

    def run(self, k: int) -> Answer:
        return self.timed(k, ["x", "arch.zpaq", "-to", f"x{k}", "-tpu"],
                          self.tree_bytes)

    def check(self, answers):
        failed = sum(1 for a in answers if a.rc != 0)
        wrong = max(ref.check_restored(self.work / "tree", self.names,
                                       self.work / f"x{a.k}" / "tree")
                    for a in answers)
        # the archive restored from: the stated model in every d block
        _, tc = self.check_archive(self.work / "arch.zpaq", decode=False)
        return {"failed_ops": (failed, 0), "files_restored_wrong": (wrong, 0),
                "blocks_misheaded": (tc.blocks_misheaded, 0)}


class Test(Operation):
    """`t` of the tree's archive, written by the host engine in the
    set-up. Every second operation tests it with the stored SHA-1 of its
    last fragment damaged (one byte flipped in the h block), so the test
    runs every fragment and has to report that one."""

    cmd = "t"
    ANSWER = re.compile(r"tested (\d+) blocks, (\d+) fragments")

    def setup(self) -> None:
        self.make_tree()
        _must(["a", "arch.zpaq", "tree", *self.switches])
        with open(self.work / "arch.zpaq", "rb") as f, \
                mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ) as buf:
            self.arc = ref.read_archive(buf)
        hashed = [j for j, f in self.arc.fragments.items()
                  if f.sha1 != ref.ZERO_SHA1]
        self.victim = max(hashed)
        frag = self.arc.fragments[self.victim]
        h = self.arc.hblocks[frag.block]
        first = self.arc.blocks[frag.block].first
        self.flip_at = h.file_offset(4 + 24 * (self.victim - first) + 19)
        self.content = sum(f.usize for f in self.arc.fragments.values())
        self.damaged = False
        self.warm(["a", "warm.zpaq", "warm", *self.switches],
                  ["t", "warm.zpaq", "-tpu"])

    def damage(self, on: bool) -> None:
        if on == self.damaged:
            return
        fd = os.open(self.work / "arch.zpaq", os.O_RDWR)
        try:
            b = os.pread(fd, 1, self.flip_at)
            os.pwrite(fd, bytes([b[0] ^ 0xFF]), self.flip_at)
        finally:
            os.close(fd)
        self.damaged = on

    def run(self, k: int) -> Answer:
        self.damage(k % 2 == 1)
        a = self.timed(k, ["t", "arch.zpaq", "-tpu"], self.content)
        a.info["damaged"] = self.damaged
        return a

    def finish(self) -> None:
        self.damage(False)

    def check(self, answers):
        _, tc = self.check_archive(self.work / "arch.zpaq", decode=True)
        sound = (len(self.arc.blocks), tc.fragments_hashed)
        wrong = 0
        for a in answers:
            if a.info["damaged"]:
                ok = (a.rc == 2 and f"fragment {self.victim}: checksum "
                      "failed" in a.err)
            else:
                m = self.ANSWER.search(a.out)
                ok = (a.rc == 0 and m is not None
                      and (int(m.group(1)), int(m.group(2))) == sound)
            wrong += not ok
        return {"wrong_answers": (wrong, 0), **_tree_checks(tc)}


KINDS = {"add": Add, "extract": Extract, "test": Test}
