"""The benchmark's files, found by name: ``BENCHMARK.json`` at the root
of the checkout, and under ``smibench/`` one file a cell
(``workloads/<cell>.json``), a configuration (``configs/<config>.json``
with its driver ``drivers/<config>.py`` and plain reference
``references/<config>.py``) and a metric (``metrics/<metric>.py``).

Each file is looked for under :data:`DIRS` in order; the command reads
the benchmark's own directory alone."""

from __future__ import annotations

import importlib.util
import json
import re
import sys
from pathlib import Path
from types import ModuleType
from typing import Dict, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BENCHMARK = ROOT / "BENCHMARK.json"

#: directories searched, in order, for a file found by name (a test puts
#: a fixture's directory before the benchmark's own)
DIRS = (HERE,)

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def check_name(name: str, what: str) -> str:
    if not isinstance(name, str) or not NAME.match(name):
        raise ValueError(f"{what} {name!r} is not a valid name")
    return name


def find(kind: str, name: str, suffix: str) -> Path:
    """The first ``<dir>/<kind>/<name><suffix>`` of :data:`DIRS`."""
    check_name(name, kind)
    for base in DIRS:
        path = base / kind / f"{name}{suffix}"
        if path.is_file():
            return path
    raise FileNotFoundError(f"no {kind} file {kind}/{name}{suffix}")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(BENCHMARK)


def workload(name: str) -> dict:
    return load_json(find("workloads", name, ".json"))


def config(name: str) -> dict:
    return load_json(find("configs", name, ".json"))


def load_module(kind: str, name: str) -> ModuleType:
    """``smibench/<kind>/<name>.py`` as a module (names may hold ``-``
    and ``.``, so they load by path)."""
    path = find(kind, name, ".py")
    modname = f"smibench.{kind}.{re.sub(r'[^A-Za-z0-9_]', '_', name)}"
    if modname in sys.modules:
        return sys.modules[modname]
    loader_spec = importlib.util.spec_from_file_location(modname, path)
    module = importlib.util.module_from_spec(loader_spec)
    sys.modules[modname] = module
    loader_spec.loader.exec_module(module)
    return module


def metrics_for(bench: dict, cell: str, trace: bool) -> List[dict]:
    """The metrics a run of ``cell`` reports: its end-to-end metrics
    untraced, its per-layer metrics traced."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def cell_entry(bench: dict, cell: str) -> Dict:
    for entry in bench["workloads"]:
        if entry["name"] == cell:
            return entry
    raise KeyError(f"BENCHMARK.json has no workload {cell!r}")
