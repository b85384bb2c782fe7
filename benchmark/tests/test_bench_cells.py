import json
import re
import shutil

import pytest

from benchmark import cells, operations
from cellrun import ROOT, run, tiny_files

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")


def one_line(s, n=200):
    return 1 <= len(s) <= n and "\n" not in s and "\t" not in s


def test_benchmark_json_keeps_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert all(one_line(w) for w in BENCH["command"])
    for p in BENCH["paths"]:
        assert (ROOT / p).is_dir() and not p.startswith("/") and ".." not in p
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.fullmatch(c["name"]) and c["name"] in used
        assert one_line(c["source"]) and one_line(c["why"])
        assert any(c["file"].startswith(p + "/") for p in BENCH["paths"])
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert all(NAME.fullmatch(k) and k in cfg for k in c["reduced"])
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.fullmatch(w["name"]) and NAME.fullmatch(w["traffic"])
        assert w["chips"] == 1 and one_line(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    layers = {}
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and one_line(m["layer"])
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        for w in m["workloads"]:
            assert w in e2e[m["moves"]].get("workloads", [w])
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.fullmatch(m["name"]) and UNIT.fullmatch(m["unit"])
        assert m["better"] in ("lower", "higher")
    for w in BENCH["workloads"]:
        cell = cells.load(ROOT, w["name"])
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
        assert len(cell.end_to_end) >= 2 and cell.per_layer
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_files_under_paths_are_named_from_name_characters():
    for p in BENCH["paths"]:
        for f in (ROOT / p).rglob("*"):
            if "__pycache__" in f.parts or not f.is_file():
                continue
            for part in f.relative_to(ROOT).parts:
                assert NAME.fullmatch(part), f


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_finds_its_parts_by_name(workload):
    cell = cells.load(ROOT, workload)
    assert cell.traffic["operation"] in operations.KINDS
    assert cell.traffic["rate_metric"] in {m["name"]
                                           for m in cell.end_to_end}
    for key in ("switches", "header_hex", "tree_bytes", "components",
                "control"):
        assert key in cell.config
    for m in cell.per_layer:
        assert callable(cells.reader(m["name"]))


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        cells.load(ROOT, "no_such.cell")


def test_a_cell_and_a_metric_added_from_new_files_alone(tmp_path,
                                                        port_on_cpu):
    """A later cell brings a configuration, a traffic mix and a metric
    reader as new files, and entries in BENCHMARK.json; no file of the
    harness changes."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    traffic = json.loads((ROOT / "benchmark" / "traffic"
                          / "m1_b16.test.json").read_text())
    traffic.update(files=tiny_files(traffic["files"], 30000))
    cfg = json.loads((ROOT / "benchmark" / "configs"
                      / "m1_b16.json").read_text())
    cfg.update(name="m1_tiny",
               tree_bytes=sum(size for _, _, size in traffic["files"]))
    (tmp_path / "benchmark" / "configs" / "m1_tiny.json").write_text(
        json.dumps(cfg))
    (tmp_path / "benchmark" / "traffic" / "m1_tiny.test.json").write_text(
        json.dumps(traffic))
    (tmp_path / "benchmark" / "metrics" / "test.ops_seen.py").write_text(
        "def read(trace):\n    return float(len(trace.ops))\n")
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append(dict(bench["configs"][0], name="m1_tiny",
                                 file="benchmark/configs/m1_tiny.json",
                                 reduced=[]))
    bench["workloads"].append({"name": "m1_tiny.test", "config": "m1_tiny",
                               "traffic": "test", "chips": 1, "why": "x"})
    for m in bench["end_to_end"]:
        if m["name"] == "test_MBps":
            m["workloads"].append("m1_tiny.test")
    bench["per_layer"].append({"name": "test.ops_seen", "unit": "ops",
                               "better": "higher", "source": "host_clock",
                               "layer": "device", "moves": "test_MBps",
                               "workloads": ["m1_tiny.test"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = cells.load(tmp_path, "m1_tiny.test", tmp_path / "benchmark")
    assert [m["name"] for m in cell.per_layer] == ["test.ops_seen"]
    result = run(cell, trace=True)
    assert result["correct"]
    assert result["metrics"]["test.ops_seen"] == {
        "value": float(result["attempted"]), "unit": "ops"}
