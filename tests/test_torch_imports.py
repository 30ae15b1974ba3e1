"""Import hygiene of smi_tpu_torch: the port loads neither jax nor the
JAX package, nothing builds or launches on import, and its entry points
default to CUDA."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PACKAGE = ROOT / "smi_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "smi_tpu", "networkx"}
#: loaded only inside the functions that need it (the routing layer's
#: graph solver): never at a module's import
LAZY = {"networkx"}

_PROBE = """
import json, sys
before = set(sys.modules)
import smi_tpu_torch
from smi_tpu_torch.kernels import _build
new = sorted(set(sys.modules) - before)
print(json.dumps({"new": new, "libs": len(_build._libs),
                  "launches": _build.LAUNCHES}))
"""


def test_fresh_import_loads_no_jax_and_builds_nothing():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    loaded = {m.split(".")[0] for m in report["new"]}
    assert not loaded & FORBIDDEN, sorted(loaded & FORBIDDEN)
    assert "smi_tpu_torch" in loaded
    # the SMI API's modules load with the package — the ring kernels'
    # wrapper too, which needs no nvcc until a CUDA tensor reaches it
    for module in ("ops.types", "ops.operations", "ops.program",
                   "ops.serialization", "parallel.backend",
                   "parallel.local", "parallel.collectives",
                   "parallel.channels", "parallel.context",
                   "parallel.errors", "parallel.routing",
                   "parallel.membership", "parallel.recovery",
                   "parallel.checkpoint",
                   "utils.watchdog", "kernels.ring", "models.kmeans",
                   "models.gesummv", "tuning.engine", "tuning.cost_model",
                   "tuning.cache", "tuning.plan", "tuning.seeded"):
        assert f"smi_tpu_torch.{module}" in report["new"], module
    # the benchmark suite, the profiler helpers and the sweeps load only
    # when asked
    assert not [m for m in report["new"]
                if m.startswith(("smi_tpu_torch.benchmarks",
                                 "smi_tpu_torch.utils.tracing",
                                 "smi_tpu_torch.tuning.sweep"))]
    assert report["libs"] == 0
    assert set(report["launches"].values()) == {0}


def _imported_roots(path: Path, module_level: bool = False):
    """The top-level packages a source imports: anywhere in it, or only
    in statements that run when the module is imported (outside every
    function)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    nodes = ast.walk(tree)
    if module_level:
        def outside_functions(node):
            yield node
            for child in ast.iter_child_nodes(node):
                if not isinstance(child, (ast.FunctionDef,
                                          ast.AsyncFunctionDef)):
                    yield from outside_functions(child)
        nodes = outside_functions(tree)
    for node in nodes:
        if isinstance(node, ast.Import):
            yield from (alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize(
    "path",
    sorted(PACKAGE.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                      ROOT / "tests" / "torch_gloo_worker.py",
                                      ROOT / "probes" /
                                      "roll_chain_layouts.py"],
    ids=lambda p: str(p.relative_to(ROOT)),
)
def test_no_source_imports_jax_or_the_jax_package(path):
    assert not set(_imported_roots(path)) & (FORBIDDEN - LAZY)
    assert not set(_imported_roots(path, module_level=True)) & FORBIDDEN


def test_package_lists_its_kernel_sources_as_package_data():
    text = (ROOT / "pyproject.toml").read_text()
    assert '"smi_tpu_torch" = ["kernels/csrc/*.cu"]' in text
    assert sorted(p.name for p in (PACKAGE / "kernels" / "csrc").glob("*.cu")
                  ) == ["flash_bwd.cu", "flash_fwd.cu", "ring.cu",
                        "roll_chain.cu", "stencil_pipeline.cu",
                        "stencil_sweep.cu", "stencil_temporal.cu"]


def test_chip_smoke_refuses_to_run_without_a_card(monkeypatch):
    """``chip_smoke.py`` exits non-zero and prints no result without CUDA."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device; chip_smoke would run")
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
