"""The port's boundary: it stands alone, and it never runs on the CPU
unless asked.

* No module under ``distel_tpu_torch/``, and none of ``chip_smoke.py``,
  ``chip_ab.py`` and ``chip_memory.py``, imports ``jax`` or ``distel_tpu`` — checked on the source (AST) and
  by importing every module in a fresh interpreter and reading
  ``sys.modules``.
* Importing a module builds nothing: the CUDA kernels and the native
  load plane compile at first use.
* With no CUDA device and no device given, the entry points raise, and
  ``chip_smoke.py`` and ``chip_memory.py`` exit non-zero without
  printing a result.
"""

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from distel_tpu_torch import cli
from distel_tpu_torch.core.incremental import IncrementalClassifier
from distel_tpu_torch.ops.bitmatmul import PackedColsMatmulPlan
from distel_tpu_torch.runtime import classifier

ROOT = Path(__file__).resolve().parent.parent
SCRIPTS = [ROOT / "chip_smoke.py", ROOT / "chip_ab.py", ROOT / "chip_memory.py"]
PORT_FILES = sorted((ROOT / "distel_tpu_torch").rglob("*.py")) + SCRIPTS
FORBIDDEN = ("jax", "jaxlib", "distel_tpu")


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(node.func, "id", None) == "__import__":
            if node.args and isinstance(node.args[0], ast.Constant):
                yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_nothing_of_jax(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


@pytest.mark.parametrize("rel", ["core/components.py", "frontend/partition_text.py"])
def test_component_plane_is_inside_the_boundary(rel):
    """The component plane's modules (the text partitioner a copy of the
    reference's) are among the files the checks above read."""
    assert ROOT / "distel_tpu_torch" / rel in PORT_FILES


def test_importing_every_module_loads_no_jax():
    mods = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
        for p in PORT_FILES
        if p not in SCRIPTS
    )
    code = (
        "import importlib, json, sys\n"
        f"for m in {mods!r} + {[p.stem for p in SCRIPTS]!r}:\n"
        "    importlib.import_module(m)\n"
        "print(json.dumps(sorted(m for m in sys.modules\n"
        "    if m.split('.')[0] in ('jax', 'jaxlib', 'distel_tpu'))))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_importing_every_module_builds_nothing(tmp_path):
    """No module compiles at import: with a build directory of its own
    and no working compiler, importing every module (the native load
    plane's binding included) leaves the directory empty."""
    mods = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
        for p in PORT_FILES
        if p not in SCRIPTS
    )
    assert "distel_tpu_torch.owl.native_loader" in mods
    code = "import importlib\n" f"for m in {mods!r}:\n    importlib.import_module(m)\n"
    env = {**os.environ, "DISTEL_TORCH_BUILD_DIR": str(tmp_path),
           "CXX": "false"}
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                   capture_output=True, text=True, timeout=120, check=True)
    assert list(tmp_path.iterdir()) == []


def test_entry_points_raise_without_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        classifier.ELClassifier()
    src = tmp_path / "a.ofn"
    src.write_text("SubClassOf(A B)\n")
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["classify", str(src)])
    with pytest.raises(RuntimeError, match="CUDA"):
        IncrementalClassifier()
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["stream", str(src)])
    # an explicit CPU request runs
    assert classifier.ELClassifier(device="cpu").device.type == "cpu"


@pytest.mark.parametrize("rel", [
    "runtime/profiling.py", "obs/card_basis.py", "analysis/__init__.py",
    "analysis/findings.py", "analysis/project.py", "analysis/lockorder.py",
    "analysis/sharedstate.py", "analysis/knobs.py", "analysis/metricnames.py",
    "analysis/purity.py", "analysis/runner.py",
])
def test_measurement_plane_is_inside_the_boundary(rel):
    """The measurement plane and the port's distel-lint are among the
    files the checks above read and import; the lint's modules import
    the standard library and their own package only (no torch)."""
    path = ROOT / "distel_tpu_torch" / rel
    assert path in PORT_FILES
    if rel.startswith("analysis/"):
        assert set(_imported_roots(path)) <= set(sys.stdlib_module_names) | {
            "distel_tpu_torch", "__future__"}


def test_measurement_entry_points_raise_without_a_card(monkeypatch, tmp_path):
    """``cli profile``, ``cli bench`` and the one-shot ``classify()`` run
    on the card unless asked for the CPU, and raise without one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    src = tmp_path / "a.ofn"
    src.write_text("SubClassOf(A B)\n")
    for argv in (["profile", str(src)], ["bench", str(src)]):
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(argv)
    with pytest.raises(RuntimeError, match="CUDA"):
        classifier.classify(str(src))
    assert classifier.classify(str(src), device="cpu").result.derivations >= 1


def test_serve_and_obs_are_checked():
    """The serve plane and its observability modules are among the files
    the checks above read and import."""
    rel = {str(p.relative_to(ROOT / "distel_tpu_torch")) for p in PORT_FILES
           if p not in SCRIPTS}
    for want in ("serve/server.py", "serve/registry.py", "serve/scheduler.py",
                 "serve/client.py", "serve/metrics.py", "serve/traces.py",
                 "serve/query/snapshot.py", "serve/storage/tiers.py",
                 "serve/fleet/__init__.py", "serve/fleet/placement.py",
                 "serve/fleet/replica.py", "serve/fleet/router.py",
                 "serve/fleet/supervisor.py", "testing/lockdep.py",
                 "obs/trace.py", "obs/flight.py",
                 "runtime/instrumentation.py"):
        assert want in rel, want


def test_serve_entry_points_raise_without_a_card(monkeypatch, tmp_path):
    from distel_tpu_torch.serve.fleet.replica import ReplicaApp
    from distel_tpu_torch.serve.registry import OntologyRegistry
    from distel_tpu_torch.serve.server import ServeApp

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeApp()
    with pytest.raises(RuntimeError, match="CUDA"):
        OntologyRegistry()
    with pytest.raises(RuntimeError, match="CUDA"):
        ReplicaApp(replica_id="r0", spill_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["serve", "--port", "0", "--spill-dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["serve", "--port", "0", "--spill-dir", str(tmp_path),
                  "--replica-id", "r0"])
    # an explicit CPU request runs
    app = ServeApp(device="cpu")
    try:
        assert app.registry.device.type == "cpu"
    finally:
        app.close(final_spill=False)


def test_fleet_without_a_device_fails_without_a_card(tmp_path):
    """``cli fleet`` with no ``--device`` starts replicas on the first
    card; with none, the replica fails at startup, the fleet exits
    non-zero, and the replica's log says why (no CPU fallback)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the fleet would run for real")
    spill = tmp_path / "spill"
    out = subprocess.run(
        [sys.executable, "-m", "distel_tpu_torch.cli", "fleet", "--replicas",
         "1", "--port", "0", "--spill-dir", str(spill)],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "fleet startup failed" in out.stderr and '"serving"' not in out.stdout
    log = (spill / "logs" / "r0.log").read_text()
    assert "CUDA" in log and '"serving"' not in log


def test_plan_refuses_a_device_without_a_kernel():
    plan = PackedColsMatmulPlan(2, 2, 1)
    a = torch.zeros((2, 2), dtype=torch.int8, device="meta")
    b = torch.zeros((2, 1), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no packed-columns kernel"):
        plan(a, b)


def _run_smoke(cwd: Path, script: str = "chip_smoke.py"):
    return subprocess.run([sys.executable, script], cwd=cwd,
                          capture_output=True, text=True, timeout=120)


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the smoke would run for real")
    out = _run_smoke(ROOT)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and '"kernels"' not in out.stdout


def test_chip_memory_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the scan would run for real")
    out = _run_smoke(ROOT, "chip_memory.py")
    assert out.returncode != 0
    assert '"memory"' not in out.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = _run_smoke(tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
