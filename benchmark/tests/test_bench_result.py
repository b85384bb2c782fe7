import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from benchmark.run import forbidden_modules
from cellrun import ROOT, run, tiny


def test_result_line_keys(port_on_cpu):
    cell = tiny("m1_b16.test", 30000)
    plain = run(cell)
    assert list(plain)[:5] == ["correct", "attempted", "failed", "metrics",
                               "device"]
    assert list(plain)[-1] == "checks"
    assert plain["correct"] and plain["attempted"] >= 1
    assert set(plain["metrics"]) == {"test_MBps", "setup_s"}
    assert all(set(m) == {"value", "unit"} for m in plain["metrics"].values())
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= \
        set(plain["device"])
    assert all(set(c) == {"value", "limit"} for c in plain["checks"].values())
    traced = run(cell, trace=True)
    assert set(traced["metrics"]) <= {m["name"] for m in cell.per_layer}
    assert {"busy_s", "window_s"} <= set(traced["device"])
    assert set(traced["breakdown"]) == {"device_ops", "idle_gaps"}
    assert list(traced)[-1] == "checks"
    json.dumps(traced)


def test_no_card_no_result(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "m1_b16.test", "--seed", "1", "--seconds", "1"],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "CUDA card" in p.stderr


def test_benchmark_alone_gives_no_result(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's folder has
    no program to measure."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "m4_b1.add", "--seed", "1", "--seconds", "1"],
                       cwd=tmp_path, env=env, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    import zpaqfranz_tpu_torch  # noqa: F401  (its name starts like one)
    assert forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", object())
    monkeypatch.setitem(sys.modules, "zpaqfranz_tpu.cli", object())
    assert forbidden_modules() == ["jaxlib", "zpaqfranz_tpu"]


def test_reference_imports_nothing_of_the_archiver():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import benchmark.reference.archive, benchmark.reference.codec\n"
            "bad = {m.split('.')[0] for m in sys.modules} & "
            "{'zpaqfranz_tpu_torch', 'zpaqfranz_tpu', 'jax', 'jaxlib'}\n"
            "print(sorted(bad))" % str(ROOT))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, check=True)
    assert p.stdout.strip() == "[]"
    imports = re.compile(r"^\s*(from|import)\s+(zpaqfranz_tpu|jax)",
                         re.MULTILINE)
    for f in (ROOT / "benchmark" / "reference").rglob("*.py"):
        assert not imports.search(f.read_text()), f


def test_nothing_reads_the_jax_benchmarks():
    for f in (ROOT / "benchmark").rglob("*.py"):
        if "tests" in f.parts:
            continue
        text = f.read_text()
        assert "bench.py" not in text and "BENCH_" not in text, f
        assert not re.search(r"^\s*(from|import)\s+(jax|zpaqfranz_tpu\b)",
                             text, re.MULTILINE), f


@pytest.mark.cuda
def test_a_cell_on_the_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "m1_b16.test", "--seed", "77", "--seconds", "5"],
                       cwd=ROOT, capture_output=True, text=True,
                       timeout=900)
    assert p.returncode == 0, p.stderr[-2000:]
    result = json.loads(p.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
