"""The command-line parity harness: one argv through both packages' CLIs.

Used by ``tests/test_torch_cli*.py`` (not a test module). :func:`both`
runs ``python -m smi_tpu``'s ``main`` and ``python -m smi_tpu_torch``'s
on the same argv, each in a directory of its own that ``prepare`` filled
alike; ``{d}`` in the argv stands for that directory. Each side's exit
code, stdout, stderr (the directory written back as ``{d}``) and every
file it left are returned; :func:`assert_same` holds the port's to the
JAX package's. Generated device modules are compared as the JAX text
with ``smi_tpu`` read as ``smi_tpu_torch``; the host module's
documented ``SmiInit`` difference is checked by its own tests.
"""

import contextlib
import io
import os
import re
import shutil

import smi_tpu.__main__ as jcli
import smi_tpu_torch.__main__ as pcli

DATA_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")

APP_SOURCE = '''\
import smi_tpu as smi

def kernel(ctx, x):
    ch = ctx.open_channel(port=0, src=0, dst=1, count=64, dtype="float",
                          buffer_size=17)
    got = ctx.transfer(ch, x)
    r = ctx.reduce(got, op="max", port=1)
    return ctx.bcast(r, root=0, port=2)
'''

#: the same app written against the port's package
PORT_APP_SOURCE = APP_SOURCE.replace("import smi_tpu as", "import "
                                     "smi_tpu_torch as")

_CHAINED = (
    "ENTRY %main (p0: f32[256,128]) -> f32[256,128] {\n"
    "  %p0 = f32[256,128]{1,0} parameter(0)\n"
    "  %mul = f32[256,128]{1,0} multiply(f32[256,128]{1,0} %p0,"
    " f32[256,128]{1,0} %p0)\n"
    "  %cp1-start = (f32[256,128]{1,0}, f32[256,128]{1,0}, u32[],"
    " u32[]) collective-permute-start(f32[256,128]{1,0} %mul),"
    " source_target_pairs={{0,1},{1,0}}\n"
    "  %cp1-done = f32[256,128]{1,0} collective-permute-done("
    "(f32[256,128]{1,0}, f32[256,128]{1,0}, u32[], u32[])"
    " %cp1-start)\n"
    "  %cp2-start = (f32[256,128]{1,0}, f32[256,128]{1,0}, u32[],"
    " u32[]) collective-permute-start(f32[256,128]{1,0}"
    " %cp1-done), source_target_pairs={{0,1},{1,0}}\n"
    "  %cp2-done = f32[256,128]{1,0} collective-permute-done("
    "(f32[256,128]{1,0}, f32[256,128]{1,0}, u32[], u32[])"
    " %cp2-start)\n"
    "  ROOT %add = f32[256,128]{1,0} add(f32[256,128]{1,0}"
    " %cp2-done, f32[256,128]{1,0} %mul)\n"
    "}\n"
)


def _write(d, name, text):
    path = os.path.join(d, name)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(text)


def prepare(d, what):
    """Fill ``d`` with the inputs named in ``what`` (a tuple of names)."""
    for item in what:
        if item == "app":
            _write(d, "app.py", APP_SOURCE)
        elif item == "program":
            shutil.copy(os.path.join(DATA_DIR, "cli-program.json"),
                        os.path.join(d, "app.json"))
            shutil.copy(os.path.join(DATA_DIR, "cli-program.json"),
                        os.path.join(d, "cli_program.json"))
        elif item.startswith("topo"):
            # "topo4", "topo4ring", "topo6"
            m = re.fullmatch(r"topo(\d+)(ring)?", item)
            argv = ["topology", "-n", m.group(1), "-p", "app", "-f",
                    os.path.join(d, f"{item}.json")]
            if m.group(2):
                argv.append("--ring")
            assert jcli.main(argv) == 0
        elif item == "hostfiles":
            _write(d, "hostfile", "".join(
                f"device-{i}  # device-{i}:0, rank{i}\n" for i in range(4)))
            _write(d, "bad-hostfile", "device-0\ndevice-0\n")
        elif item == "badnames":
            _write(d, "not-an-identifier.json", "{}")
            _write(d, "my-prog.json", "{}")
            _write(d, "dup/app.json", '{"operations": []}')
            _write(d, "app.json", '{"operations": []}')
        elif item == "badsources":
            _write(d, "bad.py", "def k(ctx, x):\n    return "
                   "ctx.bcast(x, port=3) + ctx.reduce(x, port=3)\n")
        elif item == "hlo":
            _write(d, "chained.hlo", _CHAINED)
            _write(d, "dump.hlo",
                   "%ar.1 = f32[128]{0} all-reduce(%x), channel_id=2, "
                   "replica_groups={{0,1,2,3}}, to_apply=%add\n"
                   "%free.1 = f32[32]{0} fusion(%y), kind=kLoop, "
                   "calls=%f\n")
            _write(d, "empty.hlo",
                   "%f.1 = f32[8]{0} fusion(%x), kind=kLoop\n")
        elif item == "sink":
            sink_and_cache(d)
        elif item == "legacy":
            _write(d, "legacy.json", '{"ok": true}')
            _write(d, "notjson.json", "{not json")
            _write(d, "junk.json", '{"entries": [{"cost_us": 1.0}]}')
        else:
            raise ValueError(item)


def sink_and_cache(d):
    """A recorded SampleSink JSON (20 stale-ring timings at 4 MiB) plus
    a plan cache whose active entry a replay must retire
    (``tests/test_cli.py``'s ``_sink_and_cache``, written by the JAX
    package)."""
    import json

    from smi_tpu.obs.metrics import SampleSink
    from smi_tpu.tuning import cost_model as cm
    from smi_tpu.tuning.cache import CacheEntry, PlanCache
    from smi_tpu.tuning.engine import _collective_topology
    from smi_tpu.tuning.online import priced_sample_us
    from smi_tpu.tuning.plan import PlanKey, payload_bucket

    topo = cm.TopologySpec(n=8)
    sink = SampleSink()
    us = priced_sample_us("all_reduce", "ring", 4 << 20, topo)
    for _ in range(20):
        sink.record("all_reduce", us * 1e-6, payload_bytes=4 << 20,
                    tenant="t3")
    with open(os.path.join(d, "sink.json"), "w") as f:
        f.write(json.dumps(sink.snapshot()))
    cache = PlanCache()
    cache.put(
        PlanKey("all_reduce", payload_bucket(4 << 20), "float32",
                "live-sim", _collective_topology(topo)),
        CacheEntry({"algorithm": "ring"}, cost_us=700.0,
                   provenance="sweep:stale"),
    )
    cache.save(os.path.join(d, "plans.json"))
    PlanCache().save(os.path.join(d, "empty.json"))


def _tree(d):
    out = {}
    for root, _dirs, files in os.walk(d):
        for name in files:
            path = os.path.join(root, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, d)] = f.read()
    return out


def run_side(cli, argv, d):
    """``cli.main(argv)`` with ``{d}`` read as ``d``: ``(rc, stdout,
    stderr, files)``, ``d`` written back as ``{d}`` in the texts."""
    argv = [a.replace("{d}", str(d)) for a in argv]
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            rc = cli.main(argv)
        except SystemExit as e:  # argparse errors and --help
            rc = e.code
    sub = lambda t: t.replace(str(d), "{d}")  # noqa: E731
    return rc, sub(out.getvalue()), sub(err.getvalue()), _tree(d)


def both(tmp_path, argv, what=()):
    """Run ``argv`` through both CLIs in two prepared directories."""
    sides = []
    for name, cli in (("jax", jcli), ("port", pcli)):
        d = tmp_path / name
        d.mkdir()
        prepare(str(d), what)
        sides.append(run_side(cli, argv, d))
    return sides


def port_text(jax_text: str) -> str:
    """A generated module's JAX text as the port must write it."""
    return re.sub(r"\bsmi_tpu\b", "smi_tpu_torch", jax_text)


def assert_same(jax_side, port_side, files=True):
    """The port's exit code, stdout, stderr and files equal the JAX
    package's; a generated device module as :func:`port_text`."""
    jrc, jout, jerr, jfiles = jax_side
    prc, pout, perr, pfiles = port_side
    assert prc == jrc, (prc, jrc, perr, jerr)
    assert pout == jout
    assert perr == jerr
    if not files:
        return
    assert sorted(pfiles) == sorted(jfiles)
    for name, data in jfiles.items():
        if name.endswith("_generated_host.py"):
            continue  # the documented SmiInit difference
        if name.endswith(".py") and "device" in name:
            assert pfiles[name].decode() == port_text(data.decode()), name
        else:
            assert pfiles[name] == data, name
