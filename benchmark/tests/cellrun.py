"""Tiny cells for the CPU tests: a cell of ``BENCHMARK.json`` cut to a
few kilobytes of tree, run on the port's plain PyTorch versions."""

import pathlib
import time

ROOT = pathlib.Path(__file__).resolve().parents[2]


def tiny_files(files, tree_bytes: int):
    """The file list ``files`` scaled to about ``tree_bytes`` in all,
    each file at least a byte."""
    total = sum(size for _, _, size in files)
    return [[name, kind, max(1, size * tree_bytes // total)]
            for name, kind, size in files]


def tiny(workload: str, tree_bytes: int):
    """The cell ``workload`` cut to a tree of about ``tree_bytes``: one
    round of its file list, every file scaled down alike."""
    from benchmark import cells
    cell = cells.load(ROOT, workload)
    files = tiny_files(cell.traffic["files"], tree_bytes)
    cell.traffic = dict(cell.traffic, files=files)
    cell.config = dict(cell.config,
                       tree_bytes=sum(size for _, _, size in files))
    return cell


def run(cell, seed: int = 98765432109, seconds: float = 1.0,
        trace: bool = False) -> dict:
    import torch

    from benchmark import harness
    return harness.run_cell(cell, seed, seconds, trace, torch.device("cpu"),
                            time.perf_counter(), ROOT / "bench_cache")
