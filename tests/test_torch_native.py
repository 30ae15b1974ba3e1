"""The port's native bindings: ``smi_tpu_torch/utils/native.py``.

The port binds the same ``native/`` runtime and manifest tool as
``smi_tpu/utils/native.py``. ``tests/test_native.py``'s cases that go
through the bindings re-run here with their alias ``native`` standing
for both packages' modules (``tests/torch_ref_rerun.py``): every result
must be equal. Each runs twice: with the port on the native runtime and
on its pure-Python fallbacks (``native_available()`` says which), the
JAX side native both times, so the two implementations are held to one
another. The routing tables of ``tests/data/cli-routes.bin`` round-trip
byte for byte through either; the scanner reads ``smi_tpu_torch``
imports as it reads ``smi_tpu``'s; and where the committed binaries do
not run, the port builds them from ``native/``'s sources into
``build/native/`` (here into a temporary directory).
"""

import os

import pytest

from smi_tpu.utils import native as jn
from smi_tpu_torch.utils import native as pn
from torch_ref_rerun import Both, load_reference, norm, run_reference

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")

pytestmark = pytest.mark.skipif(
    not (jn.native_available() and jn.manifest_tool_available()),
    reason="native components not built (run `make -C native`)",
)

REF = load_reference("test_native")

#: tests/test_native.py's cases that call the bindings
CASES = [
    "test_manifest_via_python_wrapper",
    "test_runtime_version",
    "test_runtime_timers_monotonic",
    "test_routing_table_round_trip",
    "test_load_missing_table_raises",
    "test_bootstrap_against_python_writer",
    "test_bootstrap_missing_rank_fails",
]

#: results that differ between the runtime and the fallbacks by design
SKIP = {"runtime_version", "time_usecs", "time_nsecs", "native_available"}


@pytest.fixture(params=["native", "fallback"])
def mode(request, monkeypatch):
    if request.param == "fallback":
        monkeypatch.setattr(pn, "_lib", None)
        monkeypatch.setattr(pn, "_load", lambda: None)
    return request.param


@pytest.mark.parametrize("name", CASES)
def test_reference_native_case_on_the_port(name, mode, request,
                                           monkeypatch):
    # the fallbacks word their errors as the JAX package's fallbacks do,
    # not as its runtime: the error types must agree
    monkeypatch.setattr(REF, "native", Both(jn, pn, skip=SKIP,
                                            messages=mode == "native"))
    run_reference(getattr(REF, name), request)


def test_mode_is_reported(mode):
    assert pn.native_available() == (mode == "native")
    version = pn.runtime_version()
    if mode == "native":
        assert version == jn.runtime_version()
    else:
        assert version == "python-fallback"
    a, b = pn.time_usecs(), pn.time_usecs()
    assert b >= a > 0 and pn.time_nsecs() > 0


def test_cli_route_tables_round_trip(mode, tmp_path):
    """``tests/data/cli-routes.bin`` (4 ranks x cks/ckr x 4 channels of
    the CLI's program) stored and loaded back through the port equals
    the file, and the port bootstraps every rank from it as the JAX
    package does."""
    with open(os.path.join(DATA, "cli-routes.bin"), "rb") as f:
        blob = f.read()
    # cks tables hold 4 destinations x 3 ports, ckr 2 x 3 ports
    sizes = {"cks": 12, "ckr": 6}
    pos, back = 0, b""
    for rank in range(4):
        for kind in ("cks", "ckr"):
            for ch in range(4):
                entries = blob[pos:pos + sizes[kind]]
                pos += sizes[kind]
                pn.store_routing_table(str(tmp_path), kind, rank, ch, entries)
    assert pos == len(blob)
    for rank in range(4):
        for kind in ("cks", "ckr"):
            for ch in range(4):
                got = pn.load_routing_table(str(tmp_path), kind, rank, ch)
                assert got == jn.load_routing_table(str(tmp_path), kind,
                                                    rank, ch)
                back += bytes(got)
    assert back == blob
    for rank in range(4):
        assert pn.bootstrap_rank(str(tmp_path), rank, 4, 4) == \
            jn.bootstrap_rank(str(tmp_path), rank, 4, 4) == 3
    with pytest.raises(ValueError):
        pn.bootstrap_rank(str(tmp_path), 5, channels=4, max_ranks=4)


@pytest.mark.parametrize("source", [
    "from {pkg} import Push as P, Pop as Q\n"
    "from {pkg}.ops.operations import Reduce\n"
    "ops = [P(0, 'float'), Q(0, 'float'), Reduce(1, 'int', op='max')]\n",
    "from {pkg} import (\n    Push as Send,\n    Pop,\n)\n"
    "ops = [Send(2, 'double'), Pop(2, 'double')]\n",
    "import {pkg} as smi\n"
    "def app(ctx, x):\n"
    "    ch = ctx.open_channel(port=1, src=0, dst=3, count=64, "
    "dtype='int')\n"
    "    return ctx.bcast(ctx.transfer(ch, x), root=0, port=3)\n",
], ids=["aliases", "parenthesized", "qualified"])
def test_scanner_reads_the_port_package_as_the_jax_one(tmp_path, source):
    jsrc, psrc = tmp_path / "j.py", tmp_path / "p.py"
    jsrc.write_text(source.format(pkg="smi_tpu"))
    psrc.write_text(source.format(pkg="smi_tpu_torch"))
    got = pn.extract_manifest([str(psrc)])
    want = jn.extract_manifest([str(jsrc)])
    assert got and norm(got) == norm(want)


def test_builds_from_sources_where_the_committed_binaries_do_not_run(
        tmp_path, monkeypatch):
    """With no usable binary under ``native/build/``, the port builds the
    runtime and the tool from ``native/``'s sources with the Makefile's
    flags, once, and uses them."""
    import shutil

    if shutil.which("g++") is None and shutil.which("c++") is None:
        pytest.skip("no C++ compiler")
    monkeypatch.setattr(pn, "_BUILD_DIR", str(tmp_path / "missing"))
    monkeypatch.setattr(pn, "LOCAL_BUILD_DIR", str(tmp_path / "local"))
    monkeypatch.setattr(pn, "_lib", None)
    monkeypatch.setattr(pn, "_tool", None)
    assert pn.native_available()
    assert pn.runtime_version() == jn.runtime_version()
    assert pn.manifest_tool() == str(tmp_path / "local" / "smi-manifest")
    src = tmp_path / "prog.py"
    src.write_text('ops = [Push(0, "float"), Pop(0, "float")]\n')
    assert norm(pn.extract_manifest([str(src)])) == norm(
        jn.extract_manifest([str(src)]))
    assert sorted(os.listdir(tmp_path / "local")) == [
        "libsmi_runtime.so", "smi-manifest"]
