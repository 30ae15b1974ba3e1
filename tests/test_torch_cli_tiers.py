"""The port's command line over the host tiers, held to the JAX CLI.

``python -m smi_tpu_torch``'s ``chaos``, ``serve``, ``trace``,
``health``, ``lint``, ``tune`` and ``traffic`` against ``python -m
smi_tpu``'s on the same argv (``tests/torch_cli_parity.py``): exit
code, stdout, stderr, ``--json`` documents and every report, trace and
cache file, byte for byte. The cases are the CLI cases of
``tests/test_cli.py``, ``tests/test_analysis.py`` (from line 747),
``tests/test_moe.py::test_cli_chaos_moe``, ``tests/test_alltoall.py``,
``tests/test_multislice.py``, ``tests/test_tuning.py``,
``tests/test_chaos.py``, ``tests/test_elastic.py``,
``tests/test_stencil_pipeline.py`` and ``tests/test_overlap.py``.

The model tier's default grid takes about a minute a side; its cases
(``lint --model --all``, ``lint --combined``) run here on the grid's
five smallest scopes, patched into ``DEFAULT_SCOPES`` of both packages
alike (``tests/test_torch_model_parity.py`` holds every scope of the
grid to the JAX package's).
"""

import pytest

import smi_tpu.analysis as janalysis
import smi_tpu_torch.analysis as panalysis
from torch_cli_parity import assert_same, both

#: (id, argv, prepared inputs)
CASES = [
    # serve
    ("serve-selftest", ["serve", "--selftest", "--seed", "1729", "-o",
                        "{d}/serve.json"], ()),
    ("serve-json", ["serve", "--selftest", "--json"], ()),
    ("serve-needs-selftest", ["serve"], ()),
    ("serve-metrics", ["serve", "--selftest", "--metrics"], ()),
    ("serve-json-metrics", ["serve", "--selftest", "--json", "--metrics"],
     ()),
    ("serve-retune", ["serve", "--selftest", "--retune", "--seed", "3",
                      "-o", "{d}/retune.json"], ()),
    ("serve-autoscale", ["serve", "--selftest", "--autoscale", "-o",
                         "{d}/autoscale.json"], ()),
    ("serve-autoscale-needs-selftest", ["serve", "--autoscale"], ()),
    ("serve-autoscale-retune", ["serve", "--selftest", "--autoscale",
                                "--retune"], ()),
    ("serve-partition", ["serve", "--selftest", "--partition"], ()),
    ("serve-infer", ["serve", "--selftest", "--infer", "--seed", "5", "-o",
                     "{d}/infer.json"], ()),
    ("serve-infer-needs-selftest", ["serve", "--infer"], ()),
    ("serve-infer-partition", ["serve", "--selftest", "--infer",
                               "--partition"], ()),
    ("serve-infer-metrics", ["serve", "--selftest", "--infer",
                             "--metrics"], ()),
    # chaos
    ("chaos-base", ["chaos", "--seed", "11", "--ranks", "2", "3",
                    "--trials", "1", "-o", "{d}/chaos.json"], ()),
    ("chaos-unknown-protocol", ["chaos", "--protocols", "ring_of_power"],
     ()),
    ("chaos-elastic", ["chaos", "--elastic", "--seed", "1729", "--ranks",
                       "2", "3", "--trials", "1", "-o",
                       "{d}/elastic.json"], ()),
    ("chaos-elastic-protocols", ["chaos", "--elastic", "--protocols",
                                 "all_gather"], ()),
    ("chaos-elastic-max-faults", ["chaos", "--elastic", "--max-faults",
                                  "3"], ()),
    ("chaos-load", ["chaos", "--load", "--seed", "1729", "--trials", "1",
                    "--duration", "160", "-o", "{d}/load.json"], ()),
    ("chaos-load-elastic", ["chaos", "--load", "--elastic"], ()),
    ("chaos-load-protocols", ["chaos", "--load", "--protocols",
                              "all_gather"], ()),
    ("chaos-load-max-faults", ["chaos", "--load", "--max-faults", "3"], ()),
    ("chaos-load-ranks", ["chaos", "--load", "--ranks", "8", "9"], ()),
    ("chaos-load-short", ["chaos", "--load", "--duration", "50"], ()),
    ("chaos-load-default-ranks", ["chaos", "--load", "--ranks", "2", "3",
                                  "4", "5"], ()),
    ("chaos-duration-alone", ["chaos", "--duration", "100"], ()),
    ("chaos-elastic-n", ["chaos", "--elastic", "-n", "8"], ()),
    ("chaos-load-metrics", ["chaos", "--load", "--metrics", "--trials",
                            "1", "--duration", "160"], ()),
    ("chaos-metrics-alone", ["chaos", "--metrics"], ()),
    ("chaos-elastic-metrics", ["chaos", "--elastic", "--metrics"], ()),
    ("chaos-moe-metrics", ["chaos", "--moe", "--metrics"], ()),
    ("chaos-load-retune", ["chaos", "--load", "--retune", "--seed", "1729",
                           "--trials", "1", "--duration", "160", "-o",
                           "{d}/load.json"], ()),
    ("chaos-retune-alone", ["chaos", "--retune"], ()),
    ("chaos-elastic-retune", ["chaos", "--elastic", "--retune"], ()),
    ("chaos-flash-crowd", ["chaos", "--load", "--flash-crowd", "--seed",
                           "1729", "--trials", "1", "-o",
                           "{d}/flash.json"], ()),
    ("chaos-flash-crowd-alone", ["chaos", "--flash-crowd"], ()),
    ("chaos-moe-flash-crowd", ["chaos", "--moe", "--flash-crowd"], ()),
    ("chaos-moe", ["chaos", "--moe", "--trials", "1", "--duration", "120",
                   "-o", "{d}/moe.json"], ()),
    ("chaos-moe-protocols", ["chaos", "--moe", "--protocols",
                             "all_gather"], ()),
    ("chaos-moe-max-faults", ["chaos", "--moe", "--max-faults", "2"], ()),
    ("chaos-moe-elastic", ["chaos", "--moe", "--elastic"], ()),
    ("chaos-partition", ["chaos", "--partition", "--trials", "1", "-o",
                         "{d}/partition.json"], ()),
    ("chaos-partition-asymmetric", ["chaos", "--partition",
                                    "--asymmetric", "--trials", "1"], ()),
    ("chaos-asymmetric-alone", ["chaos", "--asymmetric"], ()),
    ("chaos-asymmetric-flap", ["chaos", "--partition", "--asymmetric",
                               "--flap"], ()),
    ("chaos-infer", ["chaos", "--infer", "--seed", "1729", "--trials", "1",
                     "-o", "{d}/infer.json"], ()),
    ("chaos-infer-kill-prefill", ["chaos", "--infer", "--kill-prefill",
                                  "--trials", "1", "-o", "{d}/kp.json"],
     ()),
    ("chaos-infer-load", ["chaos", "--infer", "--load"], ()),
    ("chaos-infer-moe", ["chaos", "--infer", "--moe"], ()),
    ("chaos-infer-partition", ["chaos", "--infer", "--partition"], ()),
    ("chaos-infer-elastic", ["chaos", "--infer", "--elastic"], ()),
    ("chaos-kill-decode-alone", ["chaos", "--kill-decode"], ()),
    ("chaos-kill-prefill-alone", ["chaos", "--kill-prefill"], ()),
    ("chaos-load-saturate", ["chaos", "--load", "--saturate"], ()),
    ("chaos-infer-two-cells", ["chaos", "--infer", "--kill-decode",
                               "--saturate"], ()),
    ("chaos-infer-protocols", ["chaos", "--infer", "--protocols",
                               "all_gather"], ()),
    ("chaos-infer-max-faults", ["chaos", "--infer", "--max-faults", "3"],
     ()),
    ("chaos-infer-ranks", ["chaos", "--infer", "--ranks", "4", "8"], ()),
    ("chaos-infer-short", ["chaos", "--infer", "--duration", "50"], ()),
    # trace + health
    ("trace-files", ["trace", "--protocol", "allreduce_pod", "--seed", "7",
                     "-o", "{d}/traces"], ()),
    ("trace-stdout", ["trace", "--protocol", "all_gather"], ()),
    ("trace-nothing", ["trace"], ()),
    ("trace-all-and-protocol", ["trace", "--all", "--protocol",
                                "all_reduce"], ()),
    ("trace-unknown", ["trace", "--protocol", "warp_drive"], ()),
    ("trace-bad-payload", ["trace", "--protocol", "all_reduce",
                           "--payload-kb", "0"], ()),
    ("trace-payload", ["trace", "--protocol", "all_reduce",
                       "--payload-kb", "64"], ()),
    ("trace-serve", ["trace", "--serve", "--seed", "3", "-o",
                     "{d}/traces"], ()),
    ("trace-serve-all", ["trace", "--serve", "--all"], ()),
    ("trace-serve-protocol", ["trace", "--serve", "--protocol",
                              "all_reduce"], ()),
    ("trace-serve-payload", ["trace", "--serve", "--payload-kb", "64"], ()),
    ("health-selftest", ["health", "--selftest", "--seed", "2"], ()),
    ("health-selftest-json", ["health", "--selftest", "--json"], ()),
    ("health-nothing", ["health"], ()),
    ("health-both", ["health", "x.json", "--selftest"], ()),
    ("health-seed-with-report", ["health", "x.json", "--seed", "0"], ()),
    ("health-missing", ["health", "{d}/nope.json"], ()),
    ("health-legacy", ["health", "{d}/legacy.json"], ("legacy",)),
    ("health-not-json", ["health", "{d}/notjson.json"], ("legacy",)),
    # tune
    ("tune-online", ["tune", "--online", "{d}/sink.json", "--cache",
                     "{d}/plans.json", "--device-kind", "live-sim"],
     ("sink",)),
    ("tune-online-empty", ["tune", "--online", "{d}/sink.json", "--cache",
                           "{d}/empty.json"], ("sink",)),
    ("tune-online-explain", ["tune", "--online", "{d}/sink.json",
                             "--explain", "all_reduce"], ("sink",)),
    ("tune-online-ops", ["tune", "--online", "{d}/sink.json", "--ops",
                         "all_reduce"], ("sink",)),
    ("tune-device-kind", ["tune", "--device-kind", "v5e"], ()),
    ("tune-online-missing", ["tune", "--online", "{d}/nope.json"], ()),
    ("tune-online-bad-json", ["tune", "--online", "{d}/notjson.json"],
     ("legacy",)),
    ("tune-online-junk", ["tune", "--online", "{d}/junk.json", "--cache",
                          "{d}/plans.json"], ("legacy", "sink")),
    ("tune-online-slices", ["tune", "--online", "{d}/sink.json",
                            "--slices", "3"], ("sink",)),
    ("tune-explain-all-reduce", ["tune", "--explain", "all_reduce"], ()),
    ("tune-explain-unknown", ["tune", "--explain", "bogus"], ()),
    ("tune-explain-slices", ["tune", "--explain", "all_reduce", "--ranks",
                             "8", "--slices", "2"], ()),
    ("tune-explain-bad-slices", ["tune", "--explain", "all_reduce",
                                 "--ranks", "8", "--slices", "3"], ()),
    ("tune-explain-alltoall", ["tune", "--explain", "all_to_all"], ()),
    ("tune-explain-alltoall-6", ["tune", "--explain", "alltoall",
                                 "--ranks", "6"], ()),
    ("tune-explain-alltoall-pod", ["tune", "--explain", "all_to_all",
                                   "--slices", "2"], ()),
    ("tune-unknown-op", ["tune", "--ops", "ghost", "--cache",
                         "{d}/plans.json"], ()),
    ("tune-hierarchical-needs-slices", ["tune", "--ops", "hierarchical",
                                        "--cache", "{d}/plans.json"], ()),
    # traffic
    ("traffic-overlap", ["traffic", "{d}/dump.hlo", "--overlap", "-o",
                         "{d}/report.json"], ("hlo",)),
    ("traffic-records", ["traffic", "{d}/dump.hlo"], ("hlo",)),
    ("traffic-require-overlap", ["traffic", "{d}/empty.hlo",
                                 "--require-overlap"], ("hlo",)),
    ("traffic-missing", ["traffic", "{d}/nope.hlo"], ()),
    ("traffic-lint", ["traffic", "{d}/chained.hlo", "--lint", "-o",
                      "{d}/lint.json"], ("hlo",)),
    ("traffic-lint-overlap", ["traffic", "{d}/dump.hlo", "--lint",
                              "--overlap"], ("hlo",)),
    ("traffic-chained-overlap", ["traffic", "{d}/chained.hlo",
                                 "--overlap", "--require-overlap"],
     ("hlo",)),
]

#: lint: tests/test_cli.py's and tests/test_analysis.py's CLI cases
LINT_CASES = [
    ("lint-all", ["lint", "--all"], ()),
    ("lint-json", ["lint", "--json", "-o", "{d}/lint.json"], ()),
    ("lint-mutant", ["lint", "--protocol", "all_reduce", "--mutant",
                     "dropped_wait", "--json"], ()),
    ("lint-mutant-benign", ["lint", "--protocol", "neighbour_stream",
                            "--mutant", "late_grant"], ()),
    ("lint-single", ["lint", "--protocol", "allreduce_pod"], ()),
    ("lint-ghost", ["lint", "--protocol", "ghost"], ()),
    ("lint-mutant-alone", ["lint", "--mutant", "dropped_wait"], ()),
    ("lint-unknown-mutant", ["lint", "--protocol", "all_reduce",
                             "--mutant", "ghost"], ()),
    ("lint-ghost-mutant", ["lint", "--protocol", "ghost", "--mutant",
                           "dropped_wait"], ()),
    ("lint-all-protocol", ["lint", "--all", "--protocol", "all_reduce"],
     ()),
    ("lint-alltoall-family", ["lint", "--protocol", "all_to_all",
                              "--protocol", "all_to_all_bruck",
                              "--protocol", "all_to_all_pod", "--json"],
     ()),
    ("lint-model-all", ["lint", "--model", "--all", "-o",
                        "{d}/model.json"], ()),
    ("lint-model-scope", ["lint", "--model", "--scope",
                          "tenants=1,ranks=2,chunks=2,silence=2,pool=2",
                          "--json"], ()),
    ("lint-model-mutant", ["lint", "--model", "--mutant",
                           "heartbeat_after_confirm", "--scope",
                           "tenants=2,ranks=2,chunks=2,kill=1,consume=1,"
                           "pool=3", "--json"], ()),
    ("lint-model-benign", ["lint", "--model", "--mutant",
                           "heartbeat_after_confirm", "--scope",
                           "tenants=1,ranks=1,chunks=1,pool=1"], ()),
    ("lint-model-scope-alone", ["lint", "--scope", "tenants=2"], ()),
    ("lint-model-protocol", ["lint", "--model", "--protocol",
                             "all_reduce"], ()),
    ("lint-model-protocol-mutant", ["lint", "--model", "--mutant",
                                    "dropped_wait"], ()),
    ("lint-model-bad-key", ["lint", "--model", "--scope", "bogus=1"], ()),
    ("lint-model-too-big", ["lint", "--model", "--scope", "tenants=99"],
     ()),
    ("lint-model-all-scope", ["lint", "--model", "--all", "--scope",
                              "tenants=2"], ()),
    ("lint-perf-all", ["lint", "--perf", "--all", "-o", "{d}/perf.json"],
     ()),
    ("lint-perf-json", ["lint", "--perf", "--protocol", "all_reduce",
                        "--json"], ()),
    ("lint-perf-halved", ["lint", "--perf", "--mutant",
                          "halved_wire_credits", "--protocol",
                          "all_gather", "--json"], ()),
    ("lint-perf-unoverlapped", ["lint", "--perf", "--mutant",
                                "unoverlapped_chunks", "--json"], ()),
    ("lint-perf-oversized", ["lint", "--perf", "--mutant",
                             "oversized_flash_tile", "--json"], ()),
    ("lint-perf-benign", ["lint", "--perf", "--mutant",
                          "halved_wire_credits", "--protocol",
                          "neighbour_stream"], ()),
    ("lint-perf-hlo", ["lint", "--perf", "--protocol", "all_reduce",
                       "--hlo", "{d}/chained.hlo", "--json"], ("hlo",)),
    ("lint-perf-missing-hlo", ["lint", "--perf", "--hlo",
                               "{d}/nope.hlo"], ()),
    ("lint-perf-model", ["lint", "--perf", "--model"], ()),
    ("lint-perf-scope", ["lint", "--perf", "--scope", "tenants=2"], ()),
    ("lint-hlo-alone", ["lint", "--hlo", "x.hlo"], ()),
    ("lint-perf-model-mutant", ["lint", "--perf", "--mutant",
                                "leaked_stream_credit"], ()),
    ("lint-perf-mutant-on-protocol", ["lint", "--protocol", "all_reduce",
                                      "--mutant", "halved_wire_credits"],
     ()),
    ("lint-perf-oversized-protocol", ["lint", "--perf", "--mutant",
                                      "oversized_flash_tile",
                                      "--protocol", "all_gather"], ()),
    ("lint-combined-perf", ["lint", "--combined", "--perf"], ()),
    ("lint-combined-scope", ["lint", "--combined", "--scope",
                             "tenants=2"], ()),
    ("lint-perf-bogus", ["lint", "--perf", "--protocol", "bogus"], ()),
    ("lint-combined", ["lint", "--combined", "-o", "{d}/combined.json"],
     ()),
    ("lint-combined-hlo", ["lint", "--combined", "--hlo",
                           "{d}/chained.hlo", "--json"], ("hlo",)),
    ("route-check-lint", ["route", "{d}/topo4ring.json", "--check",
                          "--lint"], ("topo4ring",)),
    ("route-check-lint-slices", ["route", "{d}/topo4ring.json", "--check",
                                 "--slices", "2", "--lint"],
     ("topo4ring",)),
    ("route-check-lint-6", ["route", "{d}/topo6ring.json", "--check",
                            "--lint"], ("topo6ring",)),
]

#: the model grid's scopes that take under a second each
SMALL_SCOPES = (0, 2, 4, 5, 7)


@pytest.fixture()
def small_model_grid(monkeypatch):
    for mod in (janalysis, panalysis):
        scopes = tuple(mod.DEFAULT_SCOPES[i] for i in SMALL_SCOPES)
        monkeypatch.setattr(mod, "DEFAULT_SCOPES", scopes)


@pytest.mark.parametrize("argv,what", [c[1:] for c in CASES],
                         ids=[c[0] for c in CASES])
def test_host_tier_subcommands_match_the_jax_cli(tmp_path, argv, what):
    assert_same(*both(tmp_path, argv, what))


@pytest.mark.parametrize("argv,what", [c[1:] for c in LINT_CASES],
                         ids=[c[0] for c in LINT_CASES])
def test_lint_matches_the_jax_cli(tmp_path, small_model_grid, argv, what):
    assert_same(*both(tmp_path, argv, what))


def test_check_lint_shapes_match(capsys):
    """``route --check --lint``'s job list at 6 ranks (Bruck capped to a
    power of two and named) and with the pod: the JAX function's."""
    import smi_tpu.__main__ as jcli
    import smi_tpu_torch.__main__ as pcli

    for args in ((None, list(range(6))), (None, list(range(4))),
                 (2, list(range(4))), (3, list(range(6)))):
        prc = pcli._check_lint(*args)
        port = capsys.readouterr().out
        jrc = jcli._check_lint(*args)
        assert (prc, port) == (jrc, capsys.readouterr().out)


@pytest.mark.parametrize("op", ["stencil", "flash_fwd"])
def test_tune_explain_differs_only_by_the_port_kernels_gates(tmp_path,
                                                             op):
    """``tune --explain stencil|flash_fwd``: the candidate table is the
    JAX package's; the notes under it, and flash's chosen tiles, are the
    port's kernel plans (the H100's shared-memory plans where the JAX
    ones name VMEM budgets; flash's tile pair is ``kflash._plan``), as
    ``tests/test_torch_tuning.py`` holds the engines."""
    jax, port = both(tmp_path, ["tune", "--explain", op])
    assert port[0] == jax[0] == 0 and port[2] == jax[2] == ""

    def table(text):
        return [l for l in text.splitlines()
                if not l.startswith(("  - ", "  block_q = ",
                                     "  block_k = "))]

    assert table(port[1]) == table(jax[1])
    notes = [l for l in port[1].splitlines() if l.startswith("  - ")]
    if op == "stencil":
        assert any("pipeline tier: stripe" in l and "shared memory" in l
                   for l in notes)
    else:
        assert "  block_q = 128  [heuristic]" in port[1]
        assert any("Hopper forward kernel's own plan" in l for l in notes)
