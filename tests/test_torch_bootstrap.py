"""The port's hostfile bootstrap against the JAX package's.

``parse_hostfile`` on ``tests/test_bootstrap.py``'s hostfiles (outputs
and error texts), ``backoff_schedule`` for a seed, ``init_distributed``
driven by an injected initializer, sleep and clock (the same attempts,
the same timeouts asked for, the same ``BootstrapTimeout`` text), and
one real two-process gloo initialisation through it. The one deliberate
difference: a process of the port drives one card, so every hostfile
line is a process."""

import itertools
import multiprocessing as mp
import socket

import pytest

from smi_tpu.parallel import bootstrap as jboot
from smi_tpu_torch.parallel import bootstrap as tboot

HOSTFILE = """\
node-a  # node-a:0, rank0
node-a  # node-a:1, rank1
node-b  # node-b:0, rank2
node-c  # node-c:0, rank3
"""

#: every hostfile of tests/test_bootstrap.py
HOSTFILES = [
    HOSTFILE,
    "node-a  # node-a:0, rank0\r\nnode-b\t \r\n",
    "# a comment\n   \n# another\n",
    "",
    "node-a  # node-a:0, rank0\nnode-b  # node-b:0, rank1\n"
    "node-c  # node-c:0, rank1\n",
    "node-a  # rank0\nnode-b  # rank2\n",
    "node-a  # rank7\nnode-b\n",
    "node-a node-b\n",
    "node-a  # crank 7\nnode-b  # shrank 9\n",
    "node-a\nnode-b\nnode-a\n",
]


def _parsed(mod, text):
    try:
        return mod.parse_hostfile(text)
    except mod.HostfileError as e:
        return ("HostfileError", str(e))


@pytest.mark.parametrize("text", HOSTFILES)
def test_parse_hostfile_matches_jax(text):
    assert _parsed(tboot, text) == _parsed(jboot, text)
    assert issubclass(tboot.HostfileError, ValueError)


def test_one_process_per_hostfile_line(tmp_path, monkeypatch):
    """The port's deviation: a process per rank (line), where the JAX
    package makes one per distinct node; the coordinator is the same."""
    path = tmp_path / "hostfile"
    path.write_text(HOSTFILE)
    got = tboot.distributed_options(path, process_id=3)
    want = jboot.distributed_options(path, process_id=2)
    assert got.coordinator_address == want.coordinator_address == \
        "node-a:8476"
    assert (got.num_processes, want.num_processes) == (4, 3)
    monkeypatch.setenv("SMI_PROCESS_ID", "1")
    assert tboot.distributed_options(HOSTFILE).process_id == 1
    assert tboot.distributed_options(
        "node-x\n", process_id=0,
        coordinator_port=29500).coordinator_address == "node-x:29500"


@pytest.mark.parametrize("args", [("x:1", 2, 5), ("x:1", 2, -1)])
def test_process_id_range_checked_alike(args):
    texts = []
    for mod in (jboot, tboot):
        with pytest.raises(ValueError) as e:
            mod.DistributedOptions(*args)
        texts.append(str(e.value))
    assert texts[0] == texts[1]


def test_empty_hostfile_refused_alike():
    texts = []
    for mod in (jboot, tboot):
        with pytest.raises(ValueError) as e:
            mod.distributed_options("# only comments\n")
        texts.append(str(e.value))
    assert texts[0] == texts[1]


@pytest.mark.parametrize("seed", [0, 1, 1729])
@pytest.mark.parametrize("initial,cap,jitter", [(1.0, 30.0, 0.25),
                                                (0.1, 0.5, 0.0),
                                                (2.0, 8.0, 0.9)])
def test_backoff_schedule_matches_jax(seed, initial, cap, jitter):
    got = list(itertools.islice(
        tboot.backoff_schedule(initial, cap, jitter, seed=seed), 12))
    want = list(itertools.islice(
        jboot.backoff_schedule(initial, cap, jitter, seed=seed), 12))
    assert got == want
    assert (tboot.DEFAULT_INIT_DEADLINE_S, tboot.DEFAULT_INITIAL_BACKOFF_S,
            tboot.DEFAULT_MAX_BACKOFF_S, tboot.DEFAULT_BACKOFF_JITTER,
            tboot.DEFAULT_COORDINATOR_PORT) == (
        jboot.DEFAULT_INIT_DEADLINE_S, jboot.DEFAULT_INITIAL_BACKOFF_S,
        jboot.DEFAULT_MAX_BACKOFF_S, jboot.DEFAULT_BACKOFF_JITTER,
        jboot.DEFAULT_COORDINATOR_PORT)


def _drive(mod, fail_first, deadline, takes_timeout=True):
    """``init_distributed`` with an initializer that fails its first
    ``fail_first`` calls (costing one clock second each), on a fake
    clock: the calls it saw, the sleeps, and the error text if any."""
    now, calls, slept = [0.0], [], []

    def sleep(s):
        slept.append(s)
        now[0] += s

    def record(kwargs):
        calls.append(kwargs)
        now[0] += 1.0
        if len(calls) <= fail_first:
            raise ConnectionError("coordinator still booting")

    if takes_timeout:
        def initialize(**kwargs):
            record(kwargs)
    else:
        def initialize(coordinator_address, num_processes, process_id):
            record(dict(coordinator_address=coordinator_address,
                        num_processes=num_processes, process_id=process_id))
    try:
        mod.init_distributed(mod.DistributedOptions("coord:8476", 4, 1),
                             total_deadline_s=deadline,
                             initialize=initialize, sleep=sleep,
                             clock=lambda: now[0], seed=0)
        error = None
    except mod.BootstrapTimeout as e:
        error = str(e)
    return calls, slept, error


@pytest.mark.parametrize("takes_timeout", [True, False])
@pytest.mark.parametrize("fail_first,deadline", [(0, 60.0), (2, 60.0),
                                                 (5, 60.0), (100, 10.0),
                                                 (100, 45.0)])
def test_init_distributed_makes_the_jax_attempts(fail_first, deadline,
                                                 takes_timeout):
    got = _drive(tboot, fail_first, deadline, takes_timeout)
    want = _drive(jboot, fail_first, deadline, takes_timeout)
    assert got == want
    calls, _, error = got
    assert calls and (error is None) == (fail_first < len(calls))
    if error is not None:
        assert "coord:8476" in error and "ConnectionError" in error


def test_a_pool_of_one_never_connects():
    def boom(**kwargs):
        raise AssertionError("must not be called")

    tboot.init_distributed(tboot.DistributedOptions("solo:8476", 1, 0),
                           initialize=boom)
    assert issubclass(tboot.BootstrapTimeout, TimeoutError)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _init_rank(hostfile, rank, port, results):
    """One process of the pool: initialise through ``init_distributed``
    and all-reduce its rank."""
    try:
        import torch
        import torch.distributed as dist

        from smi_tpu_torch.parallel import bootstrap

        opts = bootstrap.distributed_options(
            hostfile, process_id=rank, coordinator_port=port)
        bootstrap.init_distributed(opts, total_deadline_s=60.0)
        try:
            x = torch.tensor([float(rank + 1)])
            dist.all_reduce(x)
            results.put((rank, dist.get_world_size(), x.item()))
        finally:
            dist.destroy_process_group()
    except BaseException as e:  # reported to the parent
        results.put((rank, "error", repr(e)))
        raise


def test_init_distributed_brings_up_a_gloo_pool():
    """Two lines of one host: two processes, each through the default
    initializer (``init_process_group`` over ``tcp://``)."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    hostfile = "127.0.0.1  # rank0\n127.0.0.1  # rank1\n"
    procs = [ctx.Process(target=_init_rank, args=(hostfile, r, port,
                                                  results))
             for r in range(2)]
    try:
        for p in procs:
            p.start()
        got = sorted(results.get(timeout=120) for _ in procs)
        for p in procs:
            p.join(timeout=30)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
    assert got == [(0, 2, 3.0), (1, 2, 3.0)]
    assert [p.exitcode for p in procs] == [0, 0]
