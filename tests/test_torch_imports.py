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
                   "parallel.checkpoint", "parallel.credits",
                   "parallel.faults",
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


def test_chip_smoke_defines_every_phase_before_it_runs():
    """``chip_smoke.py``'s ``if __name__ == "__main__"`` guard is its last
    statement, so every phase ``main`` calls is defined when it runs."""
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    last = tree.body[-1]
    assert isinstance(last, ast.If) and ast.unparse(last.test) == \
        "__name__ == '__main__'"
    calls = {n.func.id for n in ast.walk(tree)
             if isinstance(n, ast.Call) and isinstance(n.func, ast.Name)}
    defined = {n.name for n in tree.body
               if isinstance(n, (ast.FunctionDef, ast.ClassDef))}
    assert {"cli_phase", "serving_phase", "main"} <= calls & defined


def test_chip_smoke_refuses_to_run_without_a_card(monkeypatch):
    """``chip_smoke.py`` exits non-zero and prints no result without CUDA."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device; chip_smoke would run")
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


#: the analysis and observability tiers and the serving tier they
#: drive, and the command line with its build, report and traffic
#: tiers: host code, imported on demand
HOST_TIER_MODULES = (
    "serving.qos", "serving.scheduler", "serving.admission",
    "serving.placement", "serving.frontend", "serving.elasticity",
    "serving.moe", "serving.inference", "serving.campaign", "serving",
    "obs.events", "obs.metrics", "analysis.verifier", "analysis.mutants",
    "analysis.properties", "analysis.model", "analysis.perf",
    "analysis.perf_mutants", "analysis", "obs.spans", "obs.slo",
    "obs.trace", "obs", "parallel.traffic", "parallel.aot",
    "utils.native", "utils.report", "__main__",
)

_HOST_PROBE = """
import json, sys
from smi_tpu_torch.kernels import _build
out = {}
for module in %r:
    __import__("smi_tpu_torch." + module)
    out[module] = sorted({m.split(".")[0] for m in sys.modules})
print(json.dumps({"roots": out, "libs": len(_build._libs),
                  "launches": _build.LAUNCHES}))
"""


@pytest.fixture(scope="module")
def host_tier_imports():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-c", _HOST_PROBE % (HOST_TIER_MODULES,)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("module", HOST_TIER_MODULES)
def test_host_tier_module_imports_no_jax_and_builds_nothing(
        host_tier_imports, module):
    """Imported in turn in one fresh interpreter, each module of the
    analysis, observability and serving tiers leaves every forbidden
    package unloaded (so none of them brought one in), and nothing is
    built or launched."""
    roots = set(host_tier_imports["roots"][module])
    assert not roots & FORBIDDEN, sorted(roots & FORBIDDEN)
    assert (PACKAGE / (module.replace(".", "/") + ".py")).is_file() or \
        (PACKAGE / module.replace(".", "/") / "__init__.py").is_file()
    assert host_tier_imports["libs"] == 0
    assert set(host_tier_imports["launches"].values()) == {0}


def test_serving_exports_the_jax_packages_names():
    """The port's ``serving`` exports the JAX package's
    ``serving.__all__``, name for name and in its order, and every name
    resolves."""
    import smi_tpu.serving as jax_serving
    import smi_tpu_torch.serving as serving

    assert serving.__all__ == jax_serving.__all__
    for name in serving.__all__:
        value = getattr(serving, name)
        if callable(value):
            assert value.__module__.startswith("smi_tpu_torch.serving."), \
                name
        else:
            assert value == getattr(jax_serving, name), name


_GENERATED_PROBE = """
import importlib.util, json, sys
before = set(sys.modules)
for name in ("smi_generated_device", "smi_generated_host"):
    spec = importlib.util.spec_from_file_location(name, sys.argv[1] + "/"
                                                  + name + ".py")
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
print(json.dumps(sorted({m.split(".")[0]
                         for m in set(sys.modules) - before})))
"""


def test_generated_modules_import_no_jax(tmp_path):
    """The device and host modules ``python -m smi_tpu_torch`` writes
    import the port, never jax or the JAX package: by their source, and
    loaded in a fresh interpreter."""
    import smi_tpu_torch.__main__ as cli

    meta = tmp_path / "app.json"
    meta.write_text((ROOT / "tests" / "data" / "cli-program.json")
                    .read_text())
    assert cli.main(["device", str(tmp_path / "smi_generated_device.py"),
                     str(meta)]) == 0
    assert cli.main(["host", str(tmp_path / "smi_generated_host.py"),
                     str(meta)]) == 0
    for name in ("smi_generated_device.py", "smi_generated_host.py"):
        roots = set(_imported_roots(tmp_path / name))
        assert "smi_tpu_torch" in roots and not roots & FORBIDDEN, roots
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", _GENERATED_PROBE,
                           str(tmp_path)], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    loaded = set(json.loads(proc.stdout.strip().splitlines()[-1]))
    assert "smi_tpu_torch" in loaded and not loaded & FORBIDDEN
