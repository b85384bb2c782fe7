import json
import pathlib

import pytest
import torch

from benchmark import treegen
from cellrun import ROOT, tiny

CPU = torch.device("cpu")


def shape(tree_bytes=300_000):
    """m4_b1.add's traffic with its file list scaled to ``tree_bytes``."""
    cell = tiny("m4_b1.add", tree_bytes)
    return dict(cell.traffic, tree_bytes=cell.config["tree_bytes"])


def read_tree(root: pathlib.Path):
    return {p.relative_to(root).as_posix(): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_same_seed_same_tree(tmp_path):
    a = treegen.write_tree(shape(), 2**40 + 3, tmp_path / "a", CPU)
    b = treegen.write_tree(shape(), 2**40 + 3, tmp_path / "b", CPU)
    assert a == b
    assert read_tree(tmp_path / "a") == read_tree(tmp_path / "b")


def test_seed_changes_content_and_order_not_sizes(tmp_path):
    a = treegen.write_tree(shape(), 11, tmp_path / "a", CPU)
    b = treegen.write_tree(shape(), 12, tmp_path / "b", CPU)
    assert sorted((s.size, s.kind) for s in a) == \
        sorted((s.size, s.kind) for s in b)
    assert [s.size for s in a] != [s.size for s in b]
    ta, tb = read_tree(tmp_path / "a"), read_tree(tmp_path / "b")
    by_size = {len(v): v for v in tb.values()}
    assert all(by_size[len(v)] != v for v in ta.values())


@pytest.mark.parametrize("workload", ["m4_b1.add", "m1_b16.test",
                                      "m4_b1.extract"])
def test_tree_is_rounds_of_the_corpus_plus_copies(workload):
    cell = tiny(workload, 0)
    traffic = json.loads((ROOT / "benchmark" / "traffic"
                          / f"{workload}.json").read_text())
    tree_bytes = json.loads(
        (ROOT / "benchmark" / "configs"
         / f"{cell.config['name']}.json").read_text())["tree_bytes"]
    files = traffic["files"]
    corpus = sum(size for _, _, size in files)
    # Silesia's published file sizes, and its 211,938,580 bytes in all
    assert corpus == 211_938_580 and len(files) == 12
    assert tree_bytes % corpus == 0
    specs = treegen.plan(dict(traffic, tree_bytes=tree_bytes), 5)
    unique = [s for s in specs if s.dup_of < 0]
    assert sorted((s.size, s.kind) for s in unique) == sorted(
        (size, kind) for _, kind, size in files
        for _ in range(tree_bytes // corpus))
    dup = sum(s.size for s in specs if s.dup_of >= 0)
    total = sum(s.size for s in specs)
    # the largest files that fit, so the share falls short by less than
    # the smallest file
    assert 0 <= traffic["dup_share"] * total - dup
    assert traffic["dup_share"] * total - dup < min(s for _, _, s in files)


def test_tree_bytes_off_the_rounds_is_refused():
    t = shape()
    with pytest.raises(ValueError):
        treegen.plan(dict(t, tree_bytes=t["tree_bytes"] + 1), 5)


def test_duplicates_are_whole_copies(tmp_path):
    specs = treegen.write_tree(shape(), 7, tmp_path, CPU)
    dups = [s for s in specs if s.dup_of >= 0]
    assert dups
    for s in dups:
        src = specs[s.dup_of]
        assert src.dup_of < 0 and src.size == s.size
        assert (tmp_path / s.name).read_bytes() == \
            (tmp_path / src.name).read_bytes()


def test_classes_look_like_their_kind(tmp_path):
    specs = treegen.write_tree(shape(), 9, tmp_path, CPU)
    seen = set()
    for s in specs:
        data = (tmp_path / s.name).read_bytes()
        assert len(data) == s.size
        seen.add(s.kind)
        if s.kind == "csv":
            rows = data.split(b"\n")[1:-1]
            assert rows and all(r.count(b",") == 5 for r in rows)
        elif s.kind == "xml":
            assert data.count(b"<record>") > 10
        elif s.kind == "text":
            assert data.count(b" ") > len(data) // 12
        elif s.kind == "code":
            assert data.count(0xE8) > len(data) // 100
    assert seen == set(treegen.CLASSES)
