"""The port's command line: the build pipeline, generated modules, entry.

``python -m smi_tpu_torch`` (``smi_tpu_torch/__main__.py``) against
``python -m smi_tpu`` on the same argv and inputs
(``tests/torch_cli_parity.py``): exit codes, stdout, stderr and every
file written — program JSON, routing tables and hostfiles byte for byte
(``tests/data/cli-routes.bin``), the generated device module as the JAX
text with ``smi_tpu`` read as ``smi_tpu_torch``. ``tests/test_cli.py``'s
topology, manifest, route, host, device and build cases, run on both.
The JAX ``build`` fails (its ``route`` stage lacks the check flags), so
the port's ``build`` is held to the JAX stages run one by one. The
generated host module's ``SmiInit`` differs by design: it returns a
``LocalWorld`` of ``ranks`` threads, or the rank's process-group
communicator when one is initialised (a 2-process gloo group here).
"""

import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import smi_tpu.__main__ as jcli
import smi_tpu_torch as st
import smi_tpu_torch.__main__ as pcli
from torch_cli_parity import (
    APP_SOURCE,
    DATA_DIR,
    PORT_APP_SOURCE,
    assert_same,
    both,
    port_text,
    prepare,
)

from smi_tpu_torch.utils.native import manifest_tool_available

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

needs_tool = pytest.mark.skipif(
    not manifest_tool_available(), reason="smi-manifest does not run here"
)

#: (id, argv, prepared inputs): tests/test_cli.py's pipeline cases
PIPELINE_CASES = [
    ("topology-bus", ["topology", "-n", "4", "-p", "app", "-f",
                      "{d}/topo.json"], ()),
    ("topology-ring", ["topology", "-n", "4", "-p", "a", "--ring", "-f",
                       "{d}/ring.json"], ()),
    ("topology-too-few", ["topology", "-n", "1", "-p", "a", "b", "-f",
                          "{d}/topo.json"], ()),
    ("route-tables", ["route", "{d}/topo4.json", "{d}/smi-routes",
                      "{d}/app.json"], ("topo4", "program")),
    ("route-unknown-program", ["route", "{d}/topo4.json", "{d}/routes",
                               "{d}/nonexistent.json"], ("topo4",)),
    ("route-missing-topology", ["route", "{d}/nope.json", "{d}/routes"],
     ()),
    ("route-check-healthy", ["route", "{d}/topo4ring.json", "--check"],
     ("topo4ring",)),
    ("route-check-one-cut", ["route", "{d}/topo4ring.json", "--check",
                             "--down", "device-0:0:ch0"], ("topo4ring",)),
    ("route-check-partition", ["route", "{d}/topo4ring.json", "--check",
                               "--down", "device-0:0:ch0", "--down",
                               "device-2:0:ch0"], ("topo4ring",)),
    ("route-check-down-device", ["route", "{d}/topo4ring.json", "--check",
                                 "--down", "device-1:0"], ("topo4ring",)),
    ("route-check-unknown-down", ["route", "{d}/topo4ring.json",
                                  "--check", "--down", "ghost-9:0"],
     ("topo4ring",)),
    ("route-check-hostfile", ["route", "{d}/topo4ring.json", "--check",
                              "--hostfile", "{d}/hostfile"],
     ("topo4ring", "hostfiles")),
    ("route-check-bad-hostfile", ["route", "{d}/topo4ring.json",
                                  "--check", "--hostfile",
                                  "{d}/bad-hostfile"],
     ("topo4ring", "hostfiles")),
    ("route-needs-dest", ["route", "{d}/topo4ring.json"], ("topo4ring",)),
    ("route-flags-need-check", ["route", "{d}/topo4ring.json", "{d}/out",
                                "--down", "device-0:0:ch0"],
     ("topo4ring",)),
    ("route-check-metadata", ["route", "{d}/topo4ring.json",
                              "{d}/app.json", "--check"],
     ("topo4ring", "program")),
    ("route-check-ghost-metadata", ["route", "{d}/topo4ring.json",
                                    "{d}/ghost.json", "--check"],
     ("topo4ring",)),
    ("route-check-heirs", ["route", "{d}/topo4ring.json", "--check",
                           "--down", "device-1:0"], ("topo4ring",)),
    ("route-check-heirless", ["route", "{d}/topo4ring.json", "--check"]
     + [x for i in range(4) for x in ("--down", f"device-{i}:0")],
     ("topo4ring",)),
    ("route-check-slices", ["route", "{d}/topo4ring.json", "--check",
                            "--slices", "2"], ("topo4ring",)),
    ("route-check-slices-indivisible", ["route", "{d}/topo4ring.json",
                                        "--check", "--slices", "3"],
     ("topo4ring",)),
    ("route-check-slices-fallbackless", ["route", "{d}/topo6.json",
                                         "--check", "--slices", "3"],
     ("topo6",)),
    ("route-check-slices-down", ["route", "{d}/topo4ring.json", "--check",
                                 "--slices", "2", "--down", "device-2:0",
                                 "--down", "device-3:0"], ("topo4ring",)),
    ("route-slices-need-check", ["route", "{d}/topo4ring.json", "{d}/out",
                                 "--slices", "2"], ("topo4ring",)),
    ("route-lint-needs-check", ["route", "{d}/topo4ring.json", "{d}/o",
                                "--lint"], ("topo4ring",)),
    ("host-duplicate-name", ["host", "{d}/h.py", "{d}/app.json",
                             "{d}/dup/app.json"], ("badnames",)),
    ("host-bad-name", ["host", "{d}/h.py",
                       "{d}/not-an-identifier.json"], ("badnames",)),
    ("host-module", ["host", "{d}/smi_generated_host.py", "{d}/app.json"],
     ("program",)),
    ("device-golden", ["device", "{d}/cli-program-device.py",
                       "{d}/cli_program.json"], ("program",)),
    ("device-bad-name", ["device", "{d}/o.py", "{d}/my-prog.json"],
     ("badnames",)),
    ("build-bad-name", ["build", "{d}/t.json", "x.py", "-o", "{d}/build",
                        "--name", "my-app"], ()),
]

TOOL_CASES = [
    ("manifest", ["manifest", "{d}/app.py", "-o", "{d}/app.json"],
     ("app",)),
    ("manifest-stdout", ["manifest", "{d}/app.py"], ("app",)),
    ("manifest-port-conflict", ["manifest", "{d}/bad.py", "-o",
                                "{d}/o.json"], ("badsources",)),
    ("manifest-no-validate", ["manifest", "{d}/bad.py", "--no-validate",
                              "-o", "{d}/o.json"], ("badsources",)),
]


@pytest.mark.parametrize("argv,what", [c[1:] for c in PIPELINE_CASES],
                         ids=[c[0] for c in PIPELINE_CASES])
def test_pipeline_matches_the_jax_cli(tmp_path, argv, what):
    assert_same(*both(tmp_path, argv, what))


@needs_tool
@pytest.mark.parametrize("argv,what", [c[1:] for c in TOOL_CASES],
                         ids=[c[0] for c in TOOL_CASES])
def test_manifest_matches_the_jax_cli(tmp_path, argv, what):
    assert_same(*both(tmp_path, argv, what))


def test_route_tables_equal_the_golden_bytes(tmp_path):
    """The port's tables, concatenated, are ``tests/data/cli-routes.bin``
    (``tests/test_cli.py::test_route_golden_tables``)."""
    prepare(str(tmp_path), ("topo4", "program"))
    dest = tmp_path / "smi-routes"
    assert pcli.main(["route", str(tmp_path / "topo4.json"), str(dest),
                      str(tmp_path / "app.json")]) == 0
    blob = b"".join(
        (dest / f"{kind}-rank{rank}-channel{ch}").read_bytes()
        for rank in range(4) for kind in ("cks", "ckr") for ch in range(4))
    with open(os.path.join(DATA_DIR, "cli-routes.bin"), "rb") as f:
        assert blob == f.read()


def test_device_module_equals_the_golden_as_port_text(tmp_path):
    prepare(str(tmp_path), ("program",))
    out = tmp_path / "cli-program-device.py"
    assert pcli.main(["device", str(out),
                      str(tmp_path / "cli_program.json")]) == 0
    with open(os.path.join(DATA_DIR, "cli-device.py")) as f:
        assert out.read_text() == port_text(f.read())


def _host_parts(text):
    """``(header, program blocks)`` of a generated host module."""
    head, *rest = text.split("\n\n_PROGRAM_")
    return head, ["_PROGRAM_" + r.split('"""', 2)[0] + '"""'
                  + r.split('"""', 2)[1] for r in rest]


def test_host_module_differs_only_by_smiinit(tmp_path):
    """The program blocks are the JAX package's; the header and the
    ``SmiInit`` functions are the port's documented templates."""
    prepare(str(tmp_path), ("program",))
    j, p = tmp_path / "j.py", tmp_path / "p.py"
    meta = str(tmp_path / "app.json")
    assert jcli.main(["host", str(j), meta]) == 0
    assert pcli.main(["host", str(p), meta]) == 0
    assert _host_parts(p.read_text())[1] == _host_parts(j.read_text())[1]
    program = open(meta).read().strip()
    assert p.read_text() == pcli._HOST_TEMPLATE + pcli._HOST_FN_TEMPLATE.format(
        name="app", program_json=program)
    assert "import smi_tpu\n" not in p.read_text()
    assert "from smi_tpu." not in p.read_text()


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_host_module_bootstraps_a_local_world(tmp_path):
    """``SmiInit_app`` validates rank 0's tables and returns a 4-rank
    ``LocalWorld`` with the program; undersized tables raise."""
    prepare(str(tmp_path), ("topo4", "program"))
    routes = tmp_path / "smi-routes"
    assert pcli.main(["route", str(tmp_path / "topo4.json"), str(routes),
                      str(tmp_path / "app.json")]) == 0
    assert pcli.main(["host", str(tmp_path / "host.py"),
                      str(tmp_path / "app.json")]) == 0
    h = _load(tmp_path / "host.py", "port_generated_host")
    world, prog = h.SmiInit_app(rank=0, ranks=4, routing_dir=str(routes),
                                device="cpu")
    assert isinstance(world, st.LocalWorld)
    assert world.size == 4 and prog.logical_port_count == 3
    with pytest.raises(ValueError):
        h.SmiInit_app(rank=0, ranks=4, routing_dir=str(tmp_path),
                      device="cpu")


def _jax_stages(d, source):
    """The JAX package's ``build`` stages run one by one (its own
    ``build`` fails at ``route``)."""
    prog = os.path.join(d, "app.json")
    for argv in (["manifest", source, "-o", prog],
                 ["route", os.path.join(d, "..", "topo.json"),
                  os.path.join(d, "smi-routes"), prog],
                 ["device", os.path.join(d, "smi_generated_device.py"),
                  prog],
                 ["host", os.path.join(d, "smi_generated_host.py"), prog]):
        assert jcli.main(argv) == 0


@needs_tool
@pytest.mark.parametrize("named", [True, False], ids=["name", "derived"])
def test_build_equals_the_jax_stages_run_one_by_one(tmp_path, named):
    """The port's ``build`` succeeds end to end where the JAX one fails,
    and writes what the JAX stages write one by one."""
    (tmp_path / "app.py").write_text(APP_SOURCE)
    assert jcli.main(["topology", "-n", "4", "-p", "app", "-f",
                      str(tmp_path / "topo.json")]) == 0
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    jdir.mkdir()
    _jax_stages(str(jdir), str(tmp_path / "app.py"))
    argv = ["build", str(tmp_path / "topo.json"), str(tmp_path / "app.py"),
            "-o", str(pdir)] + (["--name", "app"] if named else [])
    assert pcli.main(argv) == 0
    jfiles = sorted(os.path.relpath(os.path.join(r, f), jdir)
                    for r, _, fs in os.walk(jdir) for f in fs)
    pfiles = sorted(os.path.relpath(os.path.join(r, f), pdir)
                    for r, _, fs in os.walk(pdir) for f in fs)
    assert pfiles == jfiles
    for name in jfiles:
        want = (jdir / name).read_bytes()
        got = (pdir / name).read_bytes()
        if name == "smi_generated_device.py":
            assert got.decode() == port_text(want.decode())
        elif name != "smi_generated_host.py":
            assert got == want, name
    # the JAX build itself still fails as it did (nothing fixed there)
    with pytest.raises(AttributeError, match="check"):
        jcli.main(argv[:4] + [str(tmp_path / "jaxbuild")] + argv[5:])


@needs_tool
def test_build_report_runs_every_op_on_a_cpu_world(tmp_path, capsys):
    (tmp_path / "app.py").write_text(PORT_APP_SOURCE)
    assert pcli.main(["topology", "-n", "8", "-p", "app", "-f",
                      str(tmp_path / "topo.json")]) == 0
    out = tmp_path / "b"
    assert pcli.main(["build", str(tmp_path / "topo.json"),
                      str(tmp_path / "app.py"), "-o", str(out), "--report",
                      "--cpu"]) == 0
    text = capsys.readouterr().out
    assert "program report — 8 ranks" in text
    assert "hbm_pred_us" in text
    import json

    report = json.loads((out / "report.json").read_text())
    assert report["program"] == "app" and report["target"] == "cpu"
    assert [e["op"] for e in report["operations"]] == [
        "push", "reduce", "broadcast"]
    # CPU tensors run the plain versions: no kernel launches
    assert all(e["launches"] == 0 for e in report["operations"])


def test_generated_app_on_both_tiers(tmp_path):
    """The CLI-built app (transfer -> reduce(max) -> bcast through the
    generated device module) on an 8-rank CPU world: the ring tier's
    results equal the default tier's, and every rank holds the root's
    max(x, 0)."""
    prepare(str(tmp_path), ("topo4", "program"))
    assert pcli.main(["device", str(tmp_path / "appdev.py"),
                      str(tmp_path / "app.json")]) == 0
    dev = _load(tmp_path / "appdev.py", "port_appdev")
    world = st.LocalWorld(8, device="cpu")
    x = torch.from_numpy(
        np.random.default_rng(0).standard_normal(1024).astype(np.float32))
    outs = {}
    for backend in ("xla", "ring"):
        @st.smi_kernel(world, in_specs=None, out_specs="smi",
                       program=dev.PROGRAM, backend=backend)
        def app(ctx, x):
            ch = dev.SMI_Open_send_channel_0_float(ctx, src=0, dst=1,
                                                   count=x.shape[0])
            got = dev.SMI_Push_0_float(ctx, ch, x)
            r = dev.SMI_Reduce_1_int(ctx, got, root=0)
            return dev.SMI_Bcast_2_int(ctx, r, root=0)[None]

        outs[backend] = app(x)
    assert torch.equal(outs["ring"], outs["xla"])
    assert torch.equal(outs["xla"], x.clamp(min=0).expand(8, -1))
    with pytest.raises(ValueError, match="specialized"):
        @st.smi_kernel(world, in_specs=None, out_specs="smi")
        def bad(ctx, x):
            ch = ctx.open_channel(port=3, src=0, dst=1, count=16)
            return dev.SMI_Push_0_float(ctx, ch, x)[None]

        bad(x[:16])


def test_host_module_on_a_gloo_group(tmp_path):
    """Two gloo processes: each ``SmiInit_app`` validates its rank's
    tables and returns its process-group communicator."""
    from torch_gloo_worker import run_group, run_host_module

    prepare(str(tmp_path), ("program",))
    assert pcli.main(["topology", "-n", "2", "-p", "app", "-f",
                      str(tmp_path / "topo.json")]) == 0
    assert pcli.main(["route", str(tmp_path / "topo.json"),
                      str(tmp_path / "smi-routes"),
                      str(tmp_path / "app.json")]) == 0
    assert pcli.main(["host", str(tmp_path / "smi_generated_host.py"),
                      str(tmp_path / "app.json")]) == 0
    reports = run_group(run_host_module, 2, (str(tmp_path),))
    for rank in range(2):
        assert reports[rank] == {"rank": rank, "size": 2, "ports": 3,
                                 "sum": 3.0}


def test_python_dash_m_entrypoint(tmp_path):
    out = tmp_path / "t.json"
    proc = subprocess.run(
        [sys.executable, "-m", "smi_tpu_torch", "topology", "-n", "2",
         "-p", "x", "-f", str(out)],
        capture_output=True, text=True, env={**os.environ,
                                             "PYTHONPATH": REPO},
    )
    assert proc.returncode == 0, proc.stderr
    assert out.exists()


SUBCOMMANDS = [c for c in jcli.build_parser()._subparsers._group_actions[0]
               .choices]


@pytest.mark.parametrize("cmd", SUBCOMMANDS)
def test_every_jax_subcommand_has_a_port_with_its_flags(cmd):
    """``--help`` works for each of the JAX parser's subcommands, and the
    port's takes every flag the JAX one takes (``--cpu`` where it makes
    tensors is the port's own)."""
    def flags(parser):
        sub = parser._subparsers._group_actions[0].choices[cmd]
        return {o for a in sub._actions for o in a.option_strings}

    jflags, pflags = flags(jcli.build_parser()), flags(pcli.build_parser())
    assert jflags <= pflags
    assert pflags - jflags <= {"--cpu"}
    with pytest.raises(SystemExit) as e:
        pcli.main([cmd, "--help"])
    assert e.value.code == 0


@needs_tool
def test_tensor_making_subcommands_need_a_card_or_cpu(tmp_path,
                                                      monkeypatch):
    """Without CUDA, ``build --report`` and ``tune``'s sweeps raise
    unless given ``--cpu``."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    (tmp_path / "app.py").write_text(PORT_APP_SOURCE)
    assert pcli.main(["topology", "-n", "2", "-p", "app", "-f",
                      str(tmp_path / "topo.json")]) == 0
    argv = ["build", str(tmp_path / "topo.json"), str(tmp_path / "app.py"),
            "-o", str(tmp_path / "b"), "--report", "--max-ranks", "2"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pcli.main(argv)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pcli.main(["tune", "--ops", "all_reduce", "--ranks", "2",
                   "--cache", str(tmp_path / "plans.json")])
    assert pcli.main(["tune", "--ops", "all_reduce", "--ranks", "2",
                      "--sizes-kb", "4", "--runs", "1", "--cpu",
                      "--cache", str(tmp_path / "plans.json")]) == 0
    assert (tmp_path / "plans.json").exists()
