"""The port's benchmark suite on an 8-rank CPU world, against the JAX
package's suite on the 8-device fake mesh.

The counterpart of ``tests/test_benchmarks.py``, at its tiny parameters:
every benchmark runs on both tiers where it has them and writes its
``.dat``/``.json``; each measurement's name, unit and ``config`` keys
equal the JAX benchmark's for the same parameters (its ``xla`` tier: the
JAX ring tier runs interpreted, and names a ring run as the port does);
``Measurement``'s statistics and files are byte-equal to JAX's on the
same samples. Like the reference's emulator runs, these validate the
measurement code path, not performance.
"""

import dataclasses
import json

import pytest
import torch

import smi_tpu_torch as st
from smi_tpu.benchmarks import stats as jstats
from smi_tpu.benchmarks.micro import run_benchmark as jax_run_benchmark
from smi_tpu_torch.benchmarks import stats
from smi_tpu_torch.benchmarks.__main__ import main
from smi_tpu_torch.benchmarks.micro import BENCHMARKS, run_benchmark
from smi_tpu_torch.kernels import ring as kring

#: tests/test_benchmarks.py's parameters
PARAMS = {
    "bandwidth": {"size_kb": 8, "runs": 2},
    "latency": {"pingpongs": 4, "runs": 2},
    "injection": {"messages": 4, "runs": 2},
    "broadcast": {"elements": 256, "runs": 2},
    "reduce": {"elements": 256, "runs": 2, "root": 3},
    "scatter": {"elements": 64, "runs": 2},
    "gather": {"elements": 64, "runs": 2},
    "multi_collectives": {"elements": 128, "runs": 2},
    "pipeline": {"elements": 224, "rounds": 2, "runs": 2},
    "bandwidth_eager": {"size_kb": 8, "runs": 2},
    "pipeline_double_rail": {"elements": 224, "rounds": 2, "runs": 2},
    "overlap": {"size_kb": 8, "sweep_kb": (8,), "chunks": 2,
                "repeats": 2, "runs": 2},
    "app_stencil": {"size": 64, "iterations": 4, "runs": 2},
    "app_gesummv": {"n": 64, "runs": 2},
    "app_kmeans": {"points": 256, "iterations": 2, "runs": 2},
    "app_ring_attention": {
        "seq_per_rank": 16, "heads": 2, "head_dim": 16, "runs": 2,
    },
    "app_ring_attention_train": {
        "seq_per_rank": 16, "heads": 2, "head_dim": 16, "runs": 2,
        "reps": 2,
    },
}
CASES = [(name, backend) for name in PARAMS
         for backend in (("xla",) if name.startswith("app_")
                         else ("xla", "ring"))]


@pytest.fixture(scope="module")
def world():
    return st.LocalWorld(8, device="cpu")


@pytest.fixture(scope="module")
def port_runs(world, tmp_path_factory):
    """Every case once: ``(measurement, out_dir)``, and how many times
    the ring tier's overlap ran the chunked schedule."""
    out = tmp_path_factory.mktemp("port")
    calls = []
    rows = kring._all_reduce_rows

    def counted(xus, op):
        calls.append(xus[0].shape[0])
        return rows(xus, op)

    runs = {}
    for name, backend in CASES:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(kring, "_all_reduce_rows", counted)
            runs[name, backend] = run_benchmark(
                name, world, out_dir=str(out), backend=backend,
                **PARAMS[name])
        if (name, backend) == ("overlap", "ring"):
            runs["chunked schedules"] = list(calls)
        calls.clear()
    return runs, out


@pytest.fixture(scope="module")
def jax_runs(comm8):
    return {name: jax_run_benchmark(name, comm=comm8, **p)
            for name, p in PARAMS.items()}


def test_the_suite_is_the_jax_suite():
    assert set(PARAMS) == set(BENCHMARKS)


@pytest.mark.parametrize("name,backend", CASES)
def test_benchmark_runs_and_writes_its_files(port_runs, name, backend):
    runs, out = port_runs
    m = runs[name, backend]
    assert len(m.samples) == 2 and m.mean > 0
    assert m.name.endswith("-ring") == (backend == "ring")
    assert m.config.get("backend", "xla") == backend
    assert (out / f"{m.name}.dat").exists()
    assert json.loads((out / f"{m.name}.json").read_text())["name"] == m.name


@pytest.mark.parametrize("name,backend", CASES)
def test_measurement_names_units_and_config_keys_match_jax(
        port_runs, jax_runs, name, backend):
    got, want = port_runs[0][name, backend], jax_runs[name]
    suffix = "-ring" if backend == "ring" else ""
    assert got.name == want.name + suffix
    assert got.unit == want.unit
    assert sorted(got.config) == sorted(want.config)
    if name == "overlap":
        assert sorted(got.config["sweep"]) == sorted(want.config["sweep"])
        assert got.config["overlap_report"] is None


def test_ring_overlap_runs_the_chunked_all_reduce(port_runs):
    """Each chunked step of the ring tier's overlap is the chunked
    kernel's schedule (its plain version on CPU tensors), 2 chunks."""
    chunked = port_runs[0]["chunked schedules"]
    # warm-up plus two timed runs, two allreduce steps each
    assert chunked == [2] * 6


@pytest.mark.parametrize("samples", [
    [1.0, 2.0, 3.0], [0.125], [3.5e-05, 4.25e-05, 1.0e-04, 7.7e-05],
    [2.0, 2.0],
])
def test_statistics_and_files_equal_jax(tmp_path, samples):
    config = {"size_kb": 8, "backend": "ring", "sweep": {"8": {"a": 1.5}}}
    got = stats.Measurement("x", "usec", list(samples), dict(config))
    want = jstats.Measurement("x", "usec", list(samples), dict(config))
    assert (got.mean, got.stddev, got.ci99, got.summary()) == (
        want.mean, want.stddev, want.ci99, want.summary())
    assert stats.Z99 == jstats.Z99
    for m, sub in ((got, "port"), (want, "jax"), (got, "port")):
        m.write_dat(str(tmp_path / sub))
    assert (tmp_path / "port" / "x.json").read_bytes() == (
        tmp_path / "jax" / "x.json").read_bytes()
    # the .dat line appends: two runs of the port's, one of JAX's
    port_dat = (tmp_path / "port" / "x.dat").read_text().splitlines()
    jax_dat = (tmp_path / "jax" / "x.dat").read_text().splitlines()
    assert port_dat == jax_dat * 2


def test_timed_samples_calls_once_more_to_warm_up():
    calls = []
    out = stats.timed_samples(lambda: calls.append(1), 3)
    assert len(out) == 3 and len(calls) == 4 and min(out) >= 0


def test_pipeline_eager_mode(world):
    m = run_benchmark("pipeline", world, elements=112, rounds=2, runs=2,
                      rendezvous=False)
    assert m.name == "pipeline-eager"


def test_unknown_benchmark_rejected(world):
    with pytest.raises(KeyError, match="unknown benchmark"):
        run_benchmark("warp-speed", world)


def test_backendless_benchmark_rejects_non_default_tier(world):
    """A benchmark without backend tiers refuses a requested non-default
    tier rather than recording an xla measurement under it; the default
    'xla' is dropped harmlessly."""
    with pytest.raises(ValueError, match="no backend tiers"):
        run_benchmark("app_gesummv", world, n=64, runs=2, backend="ring")
    assert run_benchmark("app_gesummv", world, n=64, runs=2,
                         backend="xla").mean > 0


def test_gesummv_needs_two_ranks():
    with pytest.raises(ValueError, match="at least 2 ranks"):
        run_benchmark("app_gesummv", st.LocalWorld(1, device="cpu"), n=8)


def test_cli_runs_a_benchmark_on_a_cpu_world(tmp_path, capsys):
    rc = main(["overlap", "--cpu", "--fake-ranks", "8", "--runs", "2",
               "--size-kb", "16", "--backend", "ring",
               "--out-dir", str(tmp_path)])
    assert rc == 0
    assert "overlap-ring: mean" in capsys.readouterr().out
    written = json.loads((tmp_path / "overlap-ring.json").read_text())
    assert written["config"]["chunks"] == 4
    assert sorted(written["config"]["sweep"]) == ["16", "256", "64"]
    # an app benchmark has no ring tier: refused, nothing recorded
    assert main(["app_gesummv", "--cpu", "--fake-ranks", "2",
                 "--backend", "ring"]) == 1
    assert "no backend tiers" in capsys.readouterr().err


def test_cli_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        main(["latency", "--runs", "1"])


def test_tracing_helpers(tmp_path):
    from smi_tpu_torch.utils.tracing import annotate, timed, trace

    with trace(str(tmp_path / "tb")):
        with annotate("smoke-region"):
            out, secs = timed(lambda: torch.arange(16.0) * 2)
    assert secs >= 0
    assert float(out[2]) == 4.0
    produced = list((tmp_path / "tb").glob("trace-*.json"))
    assert len(produced) == 1
    events = json.loads(produced[0].read_text())["traceEvents"]
    assert any(e.get("name") == "smoke-region" for e in events)


def test_timed_reads_nested_results_back():
    from smi_tpu_torch.utils.tracing import timed

    out, secs = timed(lambda: {"a": [torch.ones(2), (torch.zeros(1),)]})
    assert secs >= 0 and torch.equal(out["a"][0], torch.ones(2))


def test_measurement_is_a_dataclass_like_jax():
    fields = [f.name for f in dataclasses.fields(stats.Measurement)]
    assert fields == [f.name for f in dataclasses.fields(jstats.Measurement)]
