"""What the benchmark loads and refuses: no JAX and no JAX package in
the harness, the references free of the program, and no result without
a card."""

import json
import os
import shutil
import subprocess
import sys
import textwrap

import pytest

from smibench import spec

ROOT = str(spec.ROOT)
TOP_FORBIDDEN = ("jax", "jaxlib", "flax", "smi_tpu")


def _modules_after(code: str, env=None) -> set:
    """Top-level names of the modules a fresh interpreter holds after
    ``code``."""
    script = textwrap.dedent(code) + textwrap.dedent("""
        import json, sys
        print(json.dumps(sorted({m.split(".", 1)[0] for m in sys.modules})))
    """)
    out = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                         capture_output=True, text=True, check=True,
                         env=env, timeout=300)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_files_load_no_jax_nor_the_jax_package():
    tops = _modules_after("""
        from smibench import spec, harness, calibrate, trace, yardstick
        import smibench.__main__
        bench = spec.benchmark()
        for c in bench["configs"]:
            spec.load_module("drivers", c["name"])
            spec.load_module("references", c["name"])
        for m in bench["end_to_end"] + bench["per_layer"]:
            spec.load_module("metrics", m["name"])
    """)
    assert not tops & set(TOP_FORBIDDEN)


def test_references_load_nothing_of_the_program():
    tops = _modules_after("""
        from smibench import spec
        for c in spec.benchmark()["configs"]:
            spec.load_module("references", c["name"])
    """)
    assert not tops & set(TOP_FORBIDDEN + ("smi_tpu_torch",))


def test_a_run_through_the_port_loads_no_jax():
    tops = _modules_after("""
        from smibench import harness
        r = harness.run_cell("stencil-1x1", 3, 0.0, False, "cpu",
                             overrides={"config": {"X": 32, "Y": 32,
                                                   "sweeps": 19},
                                        "traffic": {"grid": [2, 4]}})
        assert r["correct"]
    """)
    assert "smi_tpu_torch" in tops
    assert not tops & set(TOP_FORBIDDEN)


def test_forbidden_names_are_compared_whole(monkeypatch):
    from smibench.__main__ import forbidden_modules

    monkeypatch.setitem(sys.modules, "smi_tpu_torch_fake_probe", object())
    assert "smi_tpu_torch_fake_probe" not in forbidden_modules()
    monkeypatch.setitem(sys.modules, "smi_tpu.fake_probe", object())
    assert "smi_tpu.fake_probe" in forbidden_modules()


def _no_card_env():
    env = dict(os.environ)
    env["CUDA_VISIBLE_DEVICES"] = ""
    return env


def _run_cli(cwd, env):
    return subprocess.run(
        [sys.executable, "-m", "smibench", "--workload", "stencil-1x1",
         "--seed", str(2**31 + 11), "--seconds", "1", "--trace", "0"],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_no_card_exits_non_zero_with_no_result():
    done = _run_cli(ROOT, _no_card_env())
    assert done.returncode != 0
    assert done.stdout.strip() == ""
    assert "no CUDA card" in done.stderr


def _bare_checkout(tmp_path):
    """A directory that holds only BENCHMARK.json and the benchmark."""
    shutil.copy(spec.BENCHMARK, tmp_path / "BENCHMARK.json")
    for path in spec.benchmark()["paths"]:
        shutil.copytree(spec.ROOT / path, tmp_path / path,
                        ignore=shutil.ignore_patterns("__pycache__"))
    return tmp_path


def test_bare_checkout_without_a_card_gives_no_result(tmp_path):
    done = _run_cli(_bare_checkout(tmp_path), _no_card_env())
    assert done.returncode != 0 and done.stdout.strip() == ""


@pytest.mark.gpu
def test_bare_checkout_on_the_card_gives_no_result(cuda_device, tmp_path):
    done = _run_cli(_bare_checkout(tmp_path), dict(os.environ))
    assert done.returncode != 0 and done.stdout.strip() == ""
    assert "smi_tpu_torch" in done.stderr
