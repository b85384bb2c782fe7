"""The port stands alone: importing every module of ``zpaqfranz_tpu_torch``
and ``chip_smoke`` loads neither JAX nor any module of the reference
package. Checked in a fresh interpreter, because this test process has
imported JAX already (tests/conftest.py)."""

import ast
import json
import os
import pathlib
import shutil
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent

PROBE = r"""
import importlib, json, pkgutil, sys
import zpaqfranz_tpu_torch
names = ["chip_smoke"] + [m.name for m in pkgutil.walk_packages(
    zpaqfranz_tpu_torch.__path__, "zpaqfranz_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "zpaqfranz_tpu" or m.startswith("zpaqfranz_tpu."))
print(json.dumps({"imported": names, "bad": bad,
                  "modules": sorted(m for m in sys.modules
                                    if m.startswith("torch.distributed"))}))
"""


def _run(args, cwd, pythonpath=True):
    """Run Python in a child that sees no CUDA card, even on a machine
    that has one."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    if pythonpath:
        env["PYTHONPATH"] = str(ROOT)
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_port_and_smoke_import_no_jax_and_no_reference():
    res = _run(["-c", PROBE], ROOT)
    assert res.returncode == 0, res.stderr
    out = json.loads(res.stdout.strip().splitlines()[-1])
    for mod in ("ops.cm_model", "ops.cm_decode", "ops.cm_encode", "ops.sha1",
                "ops.sha256", "experiments.mb_access",
                "experiments.mb_vmem_probe", "parallel.device_bench",
                "parallel.dist", "parallel.multihost", "codec.writer",
                "ops.hash_batched", "pre.bwt_device", "ops.predictor_batched",
                "ops.coder_batched", "jidac.zfs", "jidac.sfx", "cli",
                "device_policy"):
        assert f"zpaqfranz_tpu_torch.{mod}" in out["imported"]
    # multihost imports torch.distributed, which must not bring JAX in
    assert "torch.distributed" in out["modules"]
    assert out["bad"] == []


def test_multihost_worker_help_without_card():
    res = _run(["-m", "zpaqfranz_tpu_torch.parallel.multihost", "--help"],
               ROOT)
    assert res.returncode == 0, res.stderr
    assert "--torch-dist" in res.stdout and "--notpu" in res.stdout


def test_smoke_fails_without_card_or_repository(tmp_path):
    # without a CUDA card: non-zero exit and no result line
    res = _run([str(ROOT / "chip_smoke.py")], ROOT)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
    # alone in a directory without the repository: non-zero, no result
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    res = _run(["chip_smoke.py"], tmp_path, pythonpath=False)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_lane_engine_and_ops_import_nothing_of_jidac():
    """The arrows point one way: ``jidac`` calls down into the lane engine
    and the kernels' wrappers, which import nothing of ``jidac``, absolute
    or relative, at module level or inside a function."""
    port = ROOT / "zpaqfranz_tpu_torch"
    for path in [port / "parallel" / "engine.py",
                 *sorted((port / "ops").glob("*.py"))]:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mod = node.module or ""
                names = [mod] + [f"{mod}.{a.name}" for a in node.names]
            else:
                continue
            assert not any("jidac" in n.split(".") for n in names), \
                f"{path.relative_to(ROOT)}:{node.lineno} imports jidac"


# reference modules whose counterpart has another name in the port
RENAMED = {
    "ops/codec_arena.py": ("ops/cm_decode.py", "ops/cm_encode.py",
                           "ops/cm_model.py"),
    "ops/hash_pallas.py": ("ops/sha1.py", "ops/sha256.py"),
    "ops/vm_batched.py": ("ops/cm_model.py", "zpaql/vm.py"),
}
# not ported: an empty package marker
NOT_PORTED = {"utils/__init__.py"}


def test_every_reference_module_has_a_counterpart():
    ref, port = ROOT / "zpaqfranz_tpu", ROOT / "zpaqfranz_tpu_torch"
    for path in sorted(ref.rglob("*.py")):
        rel = path.relative_to(ref).as_posix()
        if rel in NOT_PORTED:
            continue
        for twin in RENAMED.get(rel, (rel,)):
            assert (port / twin).is_file(), f"{rel}: no {twin} in the port"
