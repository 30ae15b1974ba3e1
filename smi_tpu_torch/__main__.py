"""The port's command line: ``python -m smi_tpu_torch`` (``smi-tpu-torch``).

PyTorch counterpart of ``python -m smi_tpu`` (``smi_tpu/__main__.py``):
the same 16 subcommands with the same flags, exit codes, stdout,
``--json`` schemas and files, over the port's tiers. Reference parity:
``codegen/main.py`` (click CLI with ``codegen-device``,
``codegen-host``, ``route``) plus ``codegen/topology_file_generator.py``:

- ``manifest`` — the ``codegen-device`` front half: drive the native
  analysis tool (``native/build/smi-manifest``, the source-rewriter
  equivalent; :mod:`smi_tpu_torch.utils.native`) over user sources,
  validate the discovered operations, and write the program-metadata
  JSON.
- ``device`` — the ``codegen-device`` back half: emit the monomorphized
  device module (one ``SMI_<Op>_<port>_<dtype>`` helper per declared op)
  from a program manifest; the helpers pin the *manifest* — declared
  port/dtype/operator/buffer-size. The module's text is the JAX
  package's with ``smi_tpu`` read as ``smi_tpu_torch``.
- ``route`` — topology JSON + program metadata → binary per-rank routing
  tables + a hostfile (``codegen/main.py:107-133``).
- ``host`` — the ``codegen-host`` analog: a host bootstrap module with one
  ``SmiInit_<program>()`` per program, which validates the rank's
  routing tables and returns the ranks' communicator + program. Where
  the JAX function builds one controller's communicator over its
  devices, the port's returns the rank's process-group communicator when
  a process group of ``ranks`` is initialised, else a
  :class:`~smi_tpu_torch.parallel.local.LocalWorld` of ``ranks`` threads
  on one device.
- ``build`` — manifest → route → device → host in one call, and with
  ``--report`` the per-op kernel report (:mod:`smi_tpu_torch.utils.
  report`). The JAX ``build`` hands ``route`` a namespace without its
  check flags and fails; this one passes every flag ``route`` reads.
- ``aot-verify`` — build every CUDA source for ``sm_90a`` and check every
  launch of the multi-chip surface against the card's limits
  (:mod:`smi_tpu_torch.parallel.aot`).
- ``topology`` — generate a bus-topology file for testing.

Tensor-making subcommands (``build --report``, ``tune``'s sweeps,
``bench``) run on the card by default and raise without one; ``--cpu``
asks for the CPU. The analysis, fault, serving and observability
subcommands are host code and need neither.

Usage::

    python -m smi_tpu_torch topology -n 8 -p app -f cluster.json
    python -m smi_tpu_torch build cluster.json app.py -o build/app --report
    python -m smi_tpu_torch lint --combined
    smi-tpu-torch tune --explain all_reduce
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional, Sequence

from smi_tpu_torch.ops.program import Program
from smi_tpu_torch.ops.serialization import (
    parse_program,
    parse_topology_file,
    serialize_program,
)


def write_nodefile(topology, stream) -> None:
    """MPI-hostfile-style rank map (``codegen/common.py:15-19`` parity):
    one line per rank, host node first, sorted by rank."""
    for rank, device in enumerate(topology.devices):
        stream.write(f"{device.node}  # {device}, rank{rank}\n")


def cmd_manifest(args: argparse.Namespace) -> int:
    from smi_tpu_torch.utils.native import extract_manifest, manifest_tool_available

    if not manifest_tool_available():
        print(
            "error: native manifest tool not built; run `make -C native`",
            file=sys.stderr,
        )
        return 2
    try:
        ops = extract_manifest(
            args.sources,
            p2p_rendezvous=not args.no_rendezvous,
            validate=not args.no_validate,
        )
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    ops = sorted(ops, key=lambda op: op.port)
    try:
        program = Program(
            ops,
            consecutive_reads=args.consecutive_read_limit,
            max_ranks=args.max_ranks,
            p2p_rendezvous=not args.no_rendezvous,
        )
    except ValueError as e:  # PortConflict and friends
        print(f"error: {e}", file=sys.stderr)
        return 1
    text = serialize_program(program)
    if args.output:
        os.makedirs(
            os.path.dirname(os.path.abspath(args.output)), exist_ok=True
        )
        with open(args.output, "w") as f:
            f.write(text + "\n")
    else:
        print(text)
    return 0


def _parse_down_links(topology, specs):
    """``--down node:dev:chN`` specs → a routing FailureSet."""
    from smi_tpu_torch.ops.serialization import _parse_endpoint
    from smi_tpu_torch.parallel.routing import FailureSet

    links = set()
    devices = set()
    known = set(topology.devices)
    for spec in specs:
        # "node:dev:chN" (two colons) = one wire endpoint;
        # "node:dev" = the whole device
        if spec.count(":") >= 2:
            dev, link = _parse_endpoint(spec)
            links.add((dev, link))
        else:
            from smi_tpu_torch.ops.program import Device

            dev = Device.parse(spec)
            devices.add(dev)
        if dev not in known:
            raise ValueError(
                f"--down {spec!r} names device {dev}, which is not in "
                f"the topology"
            )
    return FailureSet(links=frozenset(links), devices=frozenset(devices))


def _route_check(args: argparse.Namespace, topology, ctx) -> int:
    """``route --check``: fail fast before a launcher grabs a pod.

    Validates that (a) every device pair is routable — around the
    ``--down`` failure set when one is given, with the cut named when
    not — and (b) the hostfile (given or freshly derivable) passes the
    strict bootstrap validation and matches the topology's rank count.
    Exit is nonzero on any violation; output is one line per check so
    launch scripts can log it.
    """
    from smi_tpu_torch.parallel.bootstrap import HostfileError, parse_hostfile
    from smi_tpu_torch.parallel.routing import (
        NoRouteFound,
        build_routing_context,
    )

    rc = 0
    excluded = None
    if args.down:
        excluded = _parse_down_links(topology, args.down)
        ctx = build_routing_context(
            topology, ctx.links_per_device, excluded=excluded
        )
    healthy = [
        d for d in topology.devices
        if excluded is None or d not in excluded.devices
    ]
    try:
        # down devices are routed *around*, not *to*: validate the
        # healthy subset only
        from smi_tpu_torch.parallel.routing import check_all_pairs_routable

        check_all_pairs_routable(ctx, healthy)
        print(
            f"routes: ok ({len(healthy)} devices all-pairs "
            f"routable{' around ' + str(excluded) if excluded else ''})"
        )
    except NoRouteFound as e:
        print(f"routes: FAIL — {e}")
        rc = 1
    if excluded is not None and excluded.devices:
        rc = max(rc, _check_heirs(topology, ctx, excluded, healthy,
                                  routes_ok=rc == 0))
    if getattr(args, "slices", None) is not None:
        rc = max(rc, _check_slices(args.slices, topology, ctx,
                                   excluded, healthy,
                                   routes_ok=rc == 0))
    if getattr(args, "lint", False):
        rc = max(rc, _check_lint(getattr(args, "slices", None), healthy))
    if args.hostfile:
        try:
            with open(args.hostfile) as f:
                nodes = parse_hostfile(f.read())
            want = len(topology.devices)
            if len(nodes) != want:
                raise HostfileError(
                    f"hostfile lists {len(nodes)} ranks but the "
                    f"topology has {want} devices"
                )
            topo_nodes = [d.node for d in topology.devices]
            if nodes != topo_nodes:
                raise HostfileError(
                    f"hostfile node order {nodes} does not match the "
                    f"topology's rank order {topo_nodes}"
                )
            print(f"hostfile: ok ({len(nodes)} ranks)")
        except (OSError, HostfileError) as e:
            print(f"hostfile: FAIL — {e}")
            rc = 1
    return rc


def _check_heirs(topology, ctx, excluded, healthy,
                 routes_ok: bool = True) -> int:
    """``route --check --down``: every down rank must have a reachable
    heir under the regrow plan.

    The elastic runtime's launch-time counterpart: when a device is
    declared down, its duties (progress log, logged contribution,
    checkpoint shard) pass to its heir — the nearest surviving
    successor on the original ring
    (:func:`smi_tpu_torch.parallel.recovery.heir_of`) — and the survivors
    later regrow around the same rank slots. A down rank with no
    survivor to inherit to is named HERE (the one shape the all-pairs
    check passes trivially: nobody healthy means no pairs), before a
    launcher grabs a pod that could never heal. When the all-pairs
    check already FAILED (``routes_ok=False``), the per-down-rank scan
    additionally names which heirs the cut strands — redundant for the
    exit code, but it turns "some pair is unroutable" into "rank 3's
    state cannot be reassembled". One line per verdict; returns the
    exit contribution.
    """
    from smi_tpu_torch.parallel.recovery import UnrecoverableError, heir_of
    from smi_tpu_torch.parallel.routing import NoRouteFound, _paths_to_device

    devices = topology.devices
    n = len(devices)
    survivors = [r for r, d in enumerate(devices) if d in set(healthy)]
    rc = 0
    inherited = []
    for rank, device in enumerate(devices):
        if device not in excluded.devices:
            continue
        try:
            heir = heir_of(rank, survivors, n)
        except UnrecoverableError:
            print(
                f"heirs: FAIL — rank {rank} ({device}) has no "
                f"surviving heir under the regrow plan: every rank is "
                f"down"
            )
            rc = 1
            continue
        heir_dev = devices[heir]
        stranded = None
        if not routes_ok:
            # all-pairs among the healthy devices already holds when
            # routes_ok: the heir is healthy, so it is reachable — no
            # need to re-derive a subset of that check
            for peer in healthy:
                if peer == heir_dev:
                    continue
                try:
                    for link in ctx.links(peer):
                        _paths_to_device(ctx, link, heir_dev)
                except NoRouteFound:
                    stranded = peer
                    break
        if stranded is not None:
            print(
                f"heirs: FAIL — rank {rank} ({device}) inherits to "
                f"rank {heir} ({heir_dev}), but the failure set "
                f"[{excluded}] cuts {stranded} off from the heir — "
                f"the regrow plan cannot reassemble its state"
            )
            rc = 1
            continue
        inherited.append((rank, heir))
    if not rc and inherited:
        print(
            "heirs: ok ("
            + ", ".join(f"rank {r} -> rank {h}" for r, h in inherited)
            + " all reachable under the regrow plan)"
        )
    return rc


def _check_slices(n_slices: int, topology, ctx, excluded, healthy,
                  routes_ok: bool = True) -> int:
    """``route --check --slices N``: pod-of-slices launch validation.

    Two pod-specific properties on top of the all-pairs check:

    - **cross-slice leaders reach each other** — the two-tier
      collectives' phase B runs over slice leaders, so every live
      leader pair must route (around any ``--down`` failures);
    - **every slice has a flat-ring fallback** — for EACH slice, the
      what-if of that whole slice down must leave the remaining
      healthy devices all-pairs routable (the ``plan_pod_rings``
      flat-fallback shape), and a slice whose loss would strand the
      survivors is NAMED before a launcher grabs the pod.

    One line per verdict; returns the exit contribution.
    """
    from smi_tpu_torch.parallel.routing import (
        FailureSet,
        NoRouteFound,
        _paths_to_device,
        build_routing_context,
        check_all_pairs_routable,
        pod_slice_partition,
    )

    try:
        groups = pod_slice_partition(topology, n_slices)
    except ValueError as e:
        print(f"slices: FAIL — {e}")
        return 1
    rc = 0
    healthy_set = set(healthy)
    leaders = []
    for group in groups:
        alive = [d for d in group if d in healthy_set]
        leaders.append(alive[0] if alive else None)
    live_leaders = [l for l in leaders if l is not None]
    leader_fail = False
    if not routes_ok:
        # all-pairs among the healthy devices already holds when
        # routes_ok: every live leader is healthy, so the pair scan is
        # a proven subset — only re-derive it after a routes failure
        for a in live_leaders:
            for b in live_leaders:
                if a == b:
                    continue
                try:
                    for link in ctx.links(a):
                        _paths_to_device(ctx, link, b)
                except NoRouteFound as e:
                    print(
                        f"slices: FAIL — leader {a} cannot reach "
                        f"leader {b}: {e}"
                    )
                    rc = 1
                    leader_fail = True
                    break
            if leader_fail:
                break
    if not leader_fail:
        down_slices = sum(1 for l in leaders if l is None)
        print(
            f"slices: ok ({len(live_leaders)} slice leaders all-pairs "
            f"reachable"
            + (f"; {down_slices} slice(s) fully down" if down_slices
               else "")
            + ")"
        )
    base_links = excluded.links if excluded is not None else frozenset()
    base_devices = (excluded.devices if excluded is not None
                    else frozenset())
    for s, group in enumerate(groups):
        group_set = frozenset(group)
        what_if = FailureSet(
            links=base_links,
            devices=base_devices | group_set,
        )
        survivors = [d for d in healthy if d not in group_set]
        if not survivors:
            # every healthy device lives in this slice: it is the last
            # live slice, and "fall back without it" is vacuous — the
            # heirs/all-pairs checks own the everything-down story
            print(
                f"slices: slice {s} is the last live slice — no "
                f"fallback scenario to validate"
            )
            continue
        ctx_s = build_routing_context(
            topology, ctx.links_per_device, excluded=what_if
        )
        try:
            check_all_pairs_routable(ctx_s, survivors)
        except NoRouteFound as e:
            print(
                f"slices: FAIL — slice {s} has no flat-ring fallback: "
                f"losing it strands the survivors ({e})"
            )
            rc = 1
    if rc == 0:
        print(
            f"slices: every slice down-scenario keeps a flat-ring "
            f"fallback over the survivors ({n_slices} checked)"
        )
    return rc


def _check_lint(n_slices, healthy) -> int:
    """``route --check --lint``: statically verify the protocols the
    plan engine would select for this topology.

    After reachability has passed, the remaining launch risk is the
    *protocol* tier: the collectives the plan engine will pick for this
    shape (the four base rings plus the chunked pipeline on any
    topology; the two-tier pod protocol when ``--slices`` declares one)
    must be deadlock- and race-free at this rank count — so a
    misconfigured pod fails at check time, not trace time. Rank counts
    above ``analysis.MAX_LINT_N`` verify a representative instance (the
    protocols are size-generic); the output names the shape used.
    """
    from smi_tpu_torch import analysis
    from smi_tpu_torch.parallel import faults

    n = len(healthy)
    if n < 2:
        print("lint: skipped (needs >= 2 healthy devices)")
        return 0
    vn = min(n, analysis.MAX_LINT_N)
    # derive the job list from the registries the verifier itself
    # covers — a protocol added to faults.PROTOCOLS/CHUNKED_PROTOCOLS
    # joins the launch gate without this list needing to remember it
    jobs = [
        (p, {"n": vn})
        for p in faults.PROTOCOLS + faults.CHUNKED_PROTOCOLS
    ]
    for p in faults.ALLTOALL_PROTOCOLS:
        if p.endswith("_pod"):
            continue  # joins the pod jobs below when --slices declares
        if p == "all_to_all_bruck":
            # Bruck is power-of-two-only by construction: verify the
            # largest power-of-two instance inside the budget and NAME
            # the shape in the output — a non-power-of-two topology is
            # a documented structural refusal for this variant, never
            # a silently skipped gate ("no silent caps")
            bn = 1 << (vn.bit_length() - 1)
            if bn < 2:
                print(f"lint: FAIL — {p} needs >= 2 ranks to shape")
                return 1
            jobs.append((p, {"n": bn}))
        else:
            jobs.append((p, {"n": vn}))
    if n_slices and n_slices > 1:
        if n % n_slices:
            print(
                f"lint: FAIL — {n} healthy devices do not divide into "
                f"{n_slices} slices; the pod protocol cannot shape"
            )
            return 1
        per = n // n_slices
        pod_slices = n_slices
        if pod_slices * per > analysis.MAX_LINT_N:
            # keep the declared slice STRUCTURE whenever it fits the
            # budget: shrink the per-slice ring first, the slice count
            # only as a last resort — a defect that needs an odd slice
            # count must not vanish behind a 2-slice cap
            per = min(per, 2)
            if pod_slices * per > analysis.MAX_LINT_N:
                pod_slices = max(2, analysis.MAX_LINT_N // per)
        jobs.extend(
            (p, {"n": pod_slices * per, "slices": pod_slices})
            for p in faults.POD_PROTOCOLS + tuple(
                q for q in faults.ALLTOALL_PROTOCOLS
                if q.endswith("_pod")
            )
        )
    rc = 0
    for protocol, shape in jobs:
        report = analysis.verify_protocol(protocol, **shape)
        if not report.ok:
            print("lint: FAIL — " + report.describe())
            rc = 1
    if not rc:
        # name each protocol's ACTUAL verified shape — a capped pod
        # must read as the representative it is, not as the full size
        names = ", ".join(
            p if shape == {"n": vn} else
            p + "[" + ", ".join(f"{k}={v}"
                                for k, v in sorted(shape.items())) + "]"
            for p, shape in jobs
        )
        print(
            f"lint: ok ({len(jobs)} protocols statically verified at "
            f"n={vn}: {names})"
        )
        # safety held — the remaining launch risk is performance: the
        # same protocol set runs through the makespan decomposition,
        # and a perf finding (idle upstream, collapsed pipeline) fails
        # the check exactly like a safety finding would
        max_idle = 0.0
        for protocol, shape in jobs:
            # verify=False: the safety pass above JUST proved these
            # exact instances — the decomposition need not re-prove
            perf = analysis.decompose_protocol(protocol, verify=False,
                                               **shape)
            max_idle = max(
                max_idle,
                max(r["idle_fraction"] for r in perf.per_rank),
            )
            if not perf.ok:
                for finding in perf.findings:
                    print("perf: FAIL — " + str(finding))
                rc = 1
        if not rc:
            print(
                f"perf: ok ({len(jobs)} protocol makespans decomposed,"
                f" max idle fraction {max_idle:.3f} <= "
                f"{analysis.IDLE_FRACTION_THRESHOLD})"
            )
    return rc


def cmd_route(args: argparse.Namespace) -> int:
    from smi_tpu_torch.parallel.routing import (
        NoRouteFound,
        build_routing_context,
        write_routing_tables,
    )

    if not args.check and args.dest_dir is None:
        print("error: dest_dir is required unless --check is given",
              file=sys.stderr)
        return 2
    if not args.check and (args.down or args.hostfile
                           or getattr(args, "slices", None) is not None
                           or getattr(args, "lint", False)):
        # writing healthy tables while silently ignoring a declared
        # failure set would hand the launcher routes over dead wires
        print("error: --down/--hostfile/--slices/--lint only apply "
              "with --check", file=sys.stderr)
        return 2
    if args.check and args.dest_dir is not None:
        # in check mode there is no output directory: the second
        # positional is really the first metadata file (argparse's
        # optional dest_dir captures it) — reclassify rather than
        # silently dropping it from the validation
        args.metadata = [args.dest_dir] + list(args.metadata)
        args.dest_dir = None
    try:
        with open(args.topology) as f:
            topology = parse_topology_file(
                f.read(), program_paths=args.metadata,
                ignore_programs=not args.metadata,
            )
        ctx = build_routing_context(topology)
        if args.check:
            return _route_check(args, topology, ctx)
        write_routing_tables(args.dest_dir, topology, ctx)
    except (NoRouteFound, KeyError, OSError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    with open(os.path.join(args.dest_dir, "hostfile"), "w") as f:
        write_nodefile(topology, f)
    return 0


_DEVICE_HEADER = '''"""Generated device module for program "{name}" — do not edit.

Trace-time analog of ``smi_generated_device.cl`` (reference
``codegen/templates/device.cl``): one monomorphized helper per declared
(op, port, dtype) — the reference's rewriter renames user call sites to
exactly such specialized symbols (``codegen/tests/data/
port-expected.cl:5-19``) so each gets its own hardware FIFOs. Under JAX
the specialization itself is free at trace time; what these helpers pin
down is the *manifest*: the declared port, dtype, reduce operator and
buffer size are baked into each symbol, so a program written against
this module cannot drift from the artifacts its routing tables were
built from.
"""

from smi_tpu_torch.ops.serialization import parse_program as _parse_program

_PROGRAM_JSON = r"""{program_json}"""

#: The declared operations (the manifest this module was generated from).
PROGRAM = _parse_program(_PROGRAM_JSON)

#: (family, port, stream-usage) -> stream slot, the port allocation the
#: routing tables were built from (``codegen/notes.txt`` deal order).
STREAMS = dict(PROGRAM.allocation)


def _check_channel(channel, port, dtype):
    if channel.port != port or channel.dtype.value != dtype:
        raise ValueError(
            f"channel (port={{channel.port}}, dtype="
            f"{{channel.dtype.value}}) used through the specialized "
            f"symbol for port {{port}}/{{dtype}}"
        )
'''

_DEVICE_P2P_TEMPLATE = '''

def SMI_Open_{dirn}_channel_{port}_{dtype}(ctx, src, dst, count):
    """Open the declared port-{port} {dtype} channel
    (``include/smi/{hdr}.h`` analog; buffer size pinned from the
    manifest)."""
    return ctx.open_channel(port={port}, src=src, dst=dst, count=count,
                            dtype="{dtype}", buffer_size={buffer_size})


def SMI_{opname}_{port}_{dtype}(ctx, channel, data, backend=None):
    """Move the full message through the port-{port} channel (the SPMD
    fusion of the reference's per-element {opname} loop,
    ``templates/{tmpl}.cl``)."""
    _check_channel(channel, {port}, "{dtype}")
    return ctx.transfer(channel, data, backend=backend)
'''

_DEVICE_COLLECTIVE_TEMPLATE = '''

def SMI_{opname}_{port}_{dtype}(ctx, x, root=0, backend=None):
    """Port-{port} {dtype} {lower} (``templates/{tmpl}.cl`` analog{extra_doc})."""
    return ctx.{method}(x, root=root, port={port}{extra_arg},
                        backend=backend)
'''


def _emit_device_module(name: str, program_json: str) -> str:
    program = parse_program(program_json)
    parts = [_DEVICE_HEADER.format(name=name, program_json=program_json)]
    for op in program.operations:
        dt = op.dtype.value
        buf = repr(op.buffer_size)
        if op.family == "push":
            parts.append(_DEVICE_P2P_TEMPLATE.format(
                dirn="send", opname="Push", tmpl="push", hdr="push",
                port=op.port, dtype=dt, buffer_size=buf,
            ))
        elif op.family == "pop":
            parts.append(_DEVICE_P2P_TEMPLATE.format(
                dirn="receive", opname="Pop", tmpl="pop", hdr="pop",
                port=op.port, dtype=dt, buffer_size=buf,
            ))
        elif op.family == "reduce":
            parts.append(_DEVICE_COLLECTIVE_TEMPLATE.format(
                opname="Reduce", tmpl="reduce", lower="reduce",
                method="reduce", port=op.port, dtype=dt,
                extra_arg=f', op="{op.op.value}"',
                extra_doc=f'; operator pinned to {op.op.value.upper()}',
            ))
        else:
            opname = {"broadcast": "Bcast", "scatter": "Scatter",
                      "gather": "Gather"}[op.family]
            parts.append(_DEVICE_COLLECTIVE_TEMPLATE.format(
                opname=opname, tmpl=op.family, lower=op.family,
                method={"broadcast": "bcast"}.get(op.family, op.family),
                port=op.port, dtype=dt, extra_arg="", extra_doc="",
            ))
    return "".join(parts)


def cmd_device(args: argparse.Namespace) -> int:
    """Emit the monomorphized device module (codegen-device's back half;
    the front half — call-site discovery — is ``manifest``)."""
    name = os.path.splitext(os.path.basename(args.metadata))[0]
    if not name.isidentifier():
        print(
            f"error: program name {name!r} is not a valid identifier",
            file=sys.stderr,
        )
        return 1
    with open(args.metadata) as f:
        program_json = f.read().strip()
    try:
        text = _emit_device_module(name, program_json)
    except (ValueError, KeyError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    out_dir = os.path.dirname(os.path.abspath(args.device_src))
    os.makedirs(out_dir, exist_ok=True)
    with open(args.device_src, "w") as f:
        f.write(text)
    return 0


_HOST_TEMPLATE = '''"""Generated host bootstrap — do not edit.

One ``SmiInit_<program>()`` per program, the analog of the generated
``smi_generated_host.c`` (reference ``codegen/templates/host_hlslib.cl``):
validates the rank's binary routing tables, builds the communicator, and
returns it with the program metadata. With a ``torch.distributed``
process group of ``ranks`` initialised, the communicator is this
process's rank's; without one, every rank is a thread of this process
and the communicator is the ``LocalWorld`` of all ``ranks`` on
``device`` (run the program with ``world.run`` or ``smi_kernel``).
"""

import json

import torch.distributed as dist

from smi_tpu_torch.ops.serialization import parse_program
from smi_tpu_torch.parallel.local import LocalWorld
from smi_tpu_torch.parallel.mesh import make_communicator
from smi_tpu_torch.utils.native import bootstrap_rank


def _init(program_json, rank, ranks, routing_dir, device=None, channels=4):
    program = parse_program(program_json)
    if routing_dir is not None:
        # egress tables are sized by the actual rank count of the routed
        # topology (one row per destination rank), not the program's
        # compile-time max_ranks bound
        ports = bootstrap_rank(
            routing_dir, rank, channels=channels, max_ranks=ranks,
        )
        if ports < program.logical_port_count:
            raise ValueError(
                f"routing tables sized for {ports} ports but program "
                f"declares {program.logical_port_count}"
            )
    if dist.is_available() and dist.is_initialized():
        if dist.get_rank() != rank:
            raise ValueError(
                f"SmiInit for rank {rank} called by process-group rank "
                f"{dist.get_rank()}"
            )
        comm = make_communicator(ranks, device=device)
    else:
        comm = LocalWorld(ranks, device=device)
    return comm, program
'''

_HOST_FN_TEMPLATE = '''

_PROGRAM_{name} = r"""{program_json}"""


def SmiInit_{name}(rank, ranks, routing_dir=None, device=None, channels=4):
    """Bootstrap rank ``rank`` of ``{name}`` (ref host_hlslib.cl:8-91)."""
    return _init(_PROGRAM_{name}, rank, ranks, routing_dir,
                 device=device, channels=channels)
'''


def cmd_host(args: argparse.Namespace) -> int:
    parts = [_HOST_TEMPLATE]
    seen = set()
    for path in args.metadata:
        name = os.path.splitext(os.path.basename(path))[0]
        if not name.isidentifier():
            print(
                f"error: program name {name!r} is not a valid identifier",
                file=sys.stderr,
            )
            return 1
        if name in seen:
            print(
                f"error: duplicate program name {name!r}", file=sys.stderr
            )
            return 1
        seen.add(name)
        with open(path) as f:
            program_json = f.read().strip()
        parse_program(program_json)  # validate before emitting
        parts.append(
            _HOST_FN_TEMPLATE.format(name=name, program_json=program_json)
        )
    out_dir = os.path.dirname(os.path.abspath(args.host_src))
    os.makedirs(out_dir, exist_ok=True)
    with open(args.host_src, "w") as f:
        f.write("".join(parts))
    return 0


def cmd_topology(args: argparse.Namespace) -> int:
    n, programs = args.n, args.programs
    if n < len(programs):
        print(
            "error: the number of devices must be >= the number of programs",
            file=sys.stderr,
        )
        return 1
    device_programs = {
        f"device-{i}:0": programs[i % len(programs)] for i in range(n)
    }
    connections = {}
    # bus: link 0 of device i wired to link 1 of device i+1
    # (codegen/topology_file_generator.py's shape)
    for i in range(n - 1):
        connections[f"device-{i}:0:ch0"] = f"device-{i + 1}:0:ch1"
    if args.ring and n > 1:
        connections[f"device-{n - 1}:0:ch0"] = "device-0:0:ch1"
    data = {"fpgas": device_programs, "connections": connections}
    with open(args.file, "w") as f:
        json.dump(data, f, indent=4, separators=(",", ": "))
        f.write("\n")
    return 0


def cmd_build(args: argparse.Namespace) -> int:
    """The ``smi_target()`` pipeline in one call: manifest → route →
    device → host.

    Reference: ``CMakeLists.txt:38-196`` wires codegen-device → route →
    codegen-host per target; here the stages run back-to-back into one
    output directory.
    """
    derived = args.name is None
    if derived:
        # reference parity: program metadata is named after the kernel
        # source (codegen/main.py:86), so `topology -p app` + `build
        # app.py` line up without an explicit --name
        args.name = os.path.splitext(os.path.basename(args.sources[0]))[0]
    if not args.name.isidentifier():
        hint = (
            " (derived from the first source file; pass --name to override)"
            if derived else ""
        )
        print(
            f"error: program name {args.name!r} is not a valid "
            f"identifier{hint}",
            file=sys.stderr,
        )
        return 1
    out = args.out_dir
    program_json = os.path.join(out, f"{args.name}.json")
    ns = argparse.Namespace(
        sources=args.sources, output=program_json,
        consecutive_read_limit=args.consecutive_read_limit,
        max_ranks=args.max_ranks, no_rendezvous=args.no_rendezvous,
        no_validate=False,
    )
    rc = cmd_manifest(ns)
    if rc:
        return rc
    # every flag cmd_route reads, at its parser default: the JAX build
    # passes only three and fails on the first it lacks (`check`)
    rc = cmd_route(argparse.Namespace(
        topology=args.topology,
        dest_dir=os.path.join(out, "smi-routes"),
        metadata=[program_json],
        check=False, down=[], hostfile=None, slices=None, lint=False,
    ))
    if rc:
        return rc
    rc = cmd_device(argparse.Namespace(
        device_src=os.path.join(out, "smi_generated_device.py"),
        metadata=program_json,
    ))
    if rc:
        return rc
    rc = cmd_host(argparse.Namespace(
        host_src=os.path.join(out, "smi_generated_host.py"),
        metadata=[program_json],
    ))
    # --report-topology implies --report (the topology is only ever
    # consumed by the report stage)
    want_report = getattr(args, "report", False) or getattr(
        args, "report_topology", None
    )
    if rc or not want_report:
        return rc
    return _build_report(args, out, program_json)


def _build_report(args: argparse.Namespace, out: str,
                  program_json: str) -> int:
    """``build --report``: run every manifest op once and tabulate the
    kernels it launched — the ``aoc -rtl -report`` stage of the pipeline
    (reference ``CMakeLists.txt:113-118``; ``utils/report.py``).

    The ops run on a :class:`~smi_tpu_torch.parallel.local.LocalWorld`
    of ``--max-ranks`` threads (or of ``--report-topology``'s rank
    count), on the card unless ``--cpu`` asks for the CPU."""
    from smi_tpu_torch.ops.serialization import parse_program
    from smi_tpu_torch.parallel.local import LocalWorld
    from smi_tpu_torch.utils.report import format_report, program_report

    with open(program_json) as f:
        program = parse_program(f.read())
    topology = getattr(args, "report_topology", None)
    if topology:
        from smi_tpu_torch.parallel import aot

        try:
            n = aot.topology_ranks(topology)
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return 1
    else:
        n = args.max_ranks
    if n < 2:
        print(
            "error: --report needs >= 2 ranks to run P2P channels; pass "
            "--max-ranks 2 or more (or --report-topology v5e:2x4)",
            file=sys.stderr,
        )
        return 1
    world = LocalWorld(n, device="cpu" if getattr(args, "cpu", False)
                       else None)
    report = program_report(program, world)
    report["program"] = args.name
    report["target"] = topology or world.device.type
    path = os.path.join(out, "report.json")
    with open(path, "w") as f:
        json.dump(report, f, indent=2)
        f.write("\n")
    print(format_report(report))
    print(f"report -> {path}")
    return 0


#: Ring-size sweep the base and elastic chaos campaigns share when
#: --ranks is not given (one constant: the two campaigns and the help
#: text can never drift on what the default sweep is).
DEFAULT_CHAOS_RANKS = [2, 3, 4, 5]

#: Faults per random plan when --max-faults is not given.
DEFAULT_CHAOS_MAX_FAULTS = 2


def cmd_chaos(args: argparse.Namespace) -> int:
    """Seeded randomized fault campaign over the ring protocols.

    Every cell injects a random multi-fault :class:`FaultPlan` into one
    (protocol, ring size) collective and requires it to heal — results
    identical to the fault-free run — or to end in a *named* state.
    Any other outcome is delta-debugged to a minimal reproducing plan.
    Exit is nonzero on any failure (and on any silent corruption in
    particular); the JSON report carries the per-cell evidence. Pure
    Python (the credit-protocol simulator): no JAX, no devices, seconds
    per thousand cells.
    """
    from smi_tpu_torch.parallel.faults import PROTOCOLS
    from smi_tpu_torch.parallel.recovery import chaos_campaign

    picked = [f for f, v in (("--elastic", args.elastic),
                             ("--load", args.load),
                             ("--moe", getattr(args, "moe", False)),
                             ("--partition",
                              getattr(args, "partition", False)),
                             ("--infer",
                              getattr(args, "infer", False)))
              if v]
    if len(picked) > 1:
        print(f"error: {' and '.join(picked)} are distinct campaigns; "
              f"pick one", file=sys.stderr)
        return 2
    for flag, value in (("--asymmetric",
                         getattr(args, "asymmetric", False)),
                        ("--flap", getattr(args, "flap", False))):
        if value and not getattr(args, "partition", False):
            print(f"error: {flag} applies only to --partition (it "
                  f"narrows the partition-tolerance campaign to one "
                  f"cell)", file=sys.stderr)
            return 2
    if (getattr(args, "asymmetric", False)
            and getattr(args, "flap", False)):
        print("error: --asymmetric and --flap are distinct "
              "partition cells; pick one (or neither, for the full "
              "campaign)", file=sys.stderr)
        return 2
    infer_only = [f for f, v in
                  (("--kill-decode",
                    getattr(args, "kill_decode", False)),
                   ("--kill-prefill",
                    getattr(args, "kill_prefill", False)),
                   ("--saturate",
                    getattr(args, "saturate", False)))
                  if v]
    if infer_only and not getattr(args, "infer", False):
        print(f"error: {' and '.join(infer_only)} "
              f"appl{'y' if len(infer_only) > 1 else 'ies'} only to "
              f"--infer (each narrows the streaming-inference "
              f"campaign to one chaos cell; add --infer)",
              file=sys.stderr)
        return 2
    if len(infer_only) > 1:
        print(f"error: {' and '.join(infer_only)} are distinct "
              f"inference cells; pick one (or neither, for the full "
              f"campaign)", file=sys.stderr)
        return 2
    if getattr(args, "metrics", False) and not args.load:
        print("error: --metrics applies only to --load (the serving "
              "campaign is the tier with a metrics registry; the "
              "base/--elastic/--moe campaigns report their own "
              "gates)", file=sys.stderr)
        return 2
    if getattr(args, "retune", False) and not args.load:
        print("error: --retune applies only to --load (the online "
              "tuner rides the serving front-end; the base/--elastic/"
              "--moe campaigns have no plan traffic to retune)",
              file=sys.stderr)
        return 2
    if getattr(args, "flash_crowd", False) and not args.load:
        print("error: --flash-crowd applies only to --load (the "
              "demand-elasticity cell rides the serving front-end; "
              "the base/--elastic/--moe campaigns have no "
              "autoscaler)", file=sys.stderr)
        return 2
    if args.load:
        return _cmd_chaos_load(args)
    if getattr(args, "moe", False):
        return _cmd_chaos_moe(args)
    if getattr(args, "partition", False):
        return _cmd_chaos_partition(args)
    if getattr(args, "infer", False):
        return _cmd_chaos_infer(args)
    if args.duration is not None or args.n_ranks is not None:
        print("error: --duration/-n apply only to "
              "--load/--moe/--partition/--infer (the base and "
              "--elastic campaigns sweep --ranks/--trials)",
              file=sys.stderr)
        return 2
    if args.elastic:
        return _cmd_chaos_elastic(args)
    protocols = args.protocols or list(PROTOCOLS)
    unknown = [p for p in protocols if p not in PROTOCOLS]
    if unknown:
        print(f"error: unknown protocol(s) {unknown}; "
              f"known: {list(PROTOCOLS)}", file=sys.stderr)
        return 2
    report = chaos_campaign(
        seed=args.seed,
        protocols=protocols,
        ns=(args.ranks if args.ranks is not None
            else DEFAULT_CHAOS_RANKS),
        trials=args.trials,
        max_faults=(args.max_faults if args.max_faults is not None
                    else DEFAULT_CHAOS_MAX_FAULTS),
    )
    for key in sorted(report["outcomes"]):
        print(f"{key:>12}: {report['outcomes'][key]}")
    print(
        f"{report['cells']} cells (seed {args.seed}), "
        f"{report['replayed_chunks']} chunks replayed by resume passes, "
        f"{report['silent_corruptions']} silent corruptions"
    )
    for failure in report["failures"]:
        print(
            f"FAILURE {failure['protocol']} n={failure['n']} "
            f"(cell seed {failure['cell_seed']}): {failure['reason']}"
        )
        print(f"  minimal reproducer: {failure['minimal_plan']}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)
            f.write("\n")
        print(f"report -> {args.out}")
    if report["ok"]:
        print("campaign ok: every cell healed or ended in a named state")
    return 0 if report["ok"] else 1


def _cmd_chaos_elastic(args: argparse.Namespace) -> int:
    """``chaos --elastic``: the seeded kill→detect→shrink→
    checkpoint-restore→regrow soak (:mod:`smi_tpu_torch.parallel.membership`).

    Every cell runs a sharded iterative Jacobi job under a seeded
    elastic fault plan (FlappingRank / StalledHeartbeat): the
    phi-accrual detector must confirm a crash before the watchdog
    budget, survivors must shrink and restore from the last complete
    checkpoint manifest, the flapped rank must regrow under a new
    epoch, and the final grid must be bit-identical to the fault-free
    run. Exit gate: zero silent corruptions AND zero stale-epoch
    leaks (every packet from a dead incarnation rejected loudly).
    """
    from smi_tpu_torch.parallel.membership import elastic_campaign

    if args.protocols:
        print("error: --protocols does not apply to --elastic (the "
              "soak drives the sharded Jacobi job)", file=sys.stderr)
        return 2
    if args.max_faults is not None:
        print("error: --max-faults does not apply to --elastic "
              "(elastic plans draw exactly one job-level fault; "
              "sweep more cells with --trials/--ranks instead)",
              file=sys.stderr)
        return 2
    report = elastic_campaign(
        seed=args.seed,
        ns=(args.ranks if args.ranks is not None
            else DEFAULT_CHAOS_RANKS),
        trials=args.trials,
    )
    for key in sorted(report["outcomes"]):
        print(f"{key:>18}: {report['outcomes'][key]}")
    print(
        f"{report['cells']} cells (seed {args.seed}), "
        f"max detect latency "
        f"{report['max_detect_ticks']} ticks "
        f"(watchdog budget {report['watchdog_budget_ticks']}), "
        f"{report['stale_epoch_rejections']} stale-epoch packets "
        f"rejected, {report['silent_corruptions']} silent corruptions, "
        f"{report['stale_epoch_leaks']} stale-epoch leaks"
    )
    for failure in report["failures"]:
        print(
            f"FAILURE n={failure['n']} (cell seed "
            f"{failure['cell_seed']}): {failure['verdict']}"
        )
        print(f"  plan: {failure['plan']}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)
            f.write("\n")
        print(f"report -> {args.out}")
    if report["ok"]:
        print("elastic campaign ok: every cell detected, restored, "
              "regrew, and matched the fault-free grid bit-for-bit")
    return 0 if report["ok"] else 1


def _cmd_chaos_load(args: argparse.Namespace) -> int:
    """``chaos --load``: the chaos-under-load campaign
    (:mod:`smi_tpu_torch.serving.campaign`).

    Open-loop multi-tenant traffic drives the serving front-end
    through an overload cell (2x capacity), a kill-one-rank cell
    (phi-accrual detect + heir failover + replay DURING traffic), and
    a consumer-stall backpressure cell per trial. Exit gate: zero
    silent corruption, zero lost-accepted requests, zero stale-epoch
    leaks, bounded queue occupancy, lowest-class-first shedding, and
    the interactive p99 admission-latency bound.
    """
    from smi_tpu_torch.serving.campaign import load_campaign

    if args.protocols:
        print("error: --protocols does not apply to --load (the "
              "campaign drives the serving front-end)",
              file=sys.stderr)
        return 2
    if args.max_faults is not None:
        print("error: --max-faults does not apply to --load (cells "
              "draw one serving-level fault each; sweep more cells "
              "with --trials)", file=sys.stderr)
        return 2
    if args.ranks is not None:
        print("error: --ranks does not apply to --load (the serving "
              "front-end runs one rank count per campaign; use "
              "-n/--n instead)", file=sys.stderr)
        return 2
    try:
        report = load_campaign(
            seed=args.seed,
            n=args.n_ranks if args.n_ranks is not None else 4,
            duration=(args.duration if args.duration is not None
                      else 240),
            trials=args.trials,
            retune=getattr(args, "retune", False),
            flash_crowd=getattr(args, "flash_crowd", False),
        )
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    for cell in report["reports"]:
        lat = cell["admission_latency"]["interactive"]
        print(
            f"{cell['cell']:>12}: {cell['verdict']}"
            f" | accepted {sum(cell['accepted'].values())}"
            f" shed {sum(sum(s.values()) for s in cell['shed'].values())}"
            f" | interactive p99 {lat['p99']} ticks"
        )
        if cell["cell"] == "retune-shift":
            rt = cell["retune"]
            print(
                f"{'retune':>12}: {rt['swaps']} swap(s) -> "
                f"{cell['converged_algorithm']!r} "
                f"(expected {cell['expected_algorithm']!r}), "
                f"{rt['samples_ingested']} samples, "
                f"{rt['stale_plan_rejections']} stale-plan "
                f"straggler(s) rejected"
            )
        if cell["cell"] == "flash-crowd":
            el = cell["elasticity"]
            migs = el["migrations"]
            committed = sum(
                1 for m in migs if m["state"] == "committed"
            )
            print(
                f"{'elastic':>12}: {el['scale_outs']} scale-out(s), "
                f"{el['scale_ins']} scale-in(s), "
                f"parked {el['parked']}, "
                f"{len(migs)} migration(s) ({committed} committed)"
            )
        if getattr(args, "metrics", False):
            counters = cell["metrics"]["counters"]
            obs = cell["obs"]
            print(
                f"{'metrics':>12}: "
                + ", ".join(
                    f"{k}={v}" for k, v in sorted(counters.items())
                    if k.startswith(("admitted_total", "delivered_tot",
                                     "shed_total", "epoch_bumps"))
                )
                + f" | events {obs['total_events']} "
                f"(dropped {obs['dropped_events']})"
            )
    print(
        f"{report['cells']} cells (seed {args.seed}), "
        f"{report['silent_corruptions']} silent corruptions, "
        f"{report['lost_accepted']} lost accepted, "
        f"{report['stale_epoch_leaks']} stale-epoch leaks"
    )
    for failure in report["failures"]:
        print(
            f"FAILURE {failure['cell']} trial {failure['trial']}: "
            f"{failure['verdict']}"
        )
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)
            f.write("\n")
        print(f"report -> {args.out}")
    if report["ok"]:
        print("load campaign ok: every accepted stream delivered "
              "bit-identically, shedding lowest-class-first, queues "
              "bounded")
    return 0 if report["ok"] else 1


def _cmd_chaos_moe(args: argparse.Namespace) -> int:
    """``chaos --moe``: the MoE expert-dispatch campaign
    (:mod:`smi_tpu_torch.serving.moe`).

    Seeded token batches scatter to experts and gather back through
    the serving front-end — one uniform-routing cell and one
    hot-expert cell (a seeded expert at 8x routing weight) per trial.
    Exit gate: zero silent corruption (every accepted batch
    reassembles bit-identically under the inverse routing
    permutation), zero lost-accepted, lowest-class-first shedding,
    bounded queues, and the hot rank's saturation surfacing as NAMED
    per-route backpressure — never as a membership transition.
    """
    from smi_tpu_torch.serving.moe import moe_campaign

    if args.protocols:
        print("error: --protocols does not apply to --moe (the "
              "campaign drives the MoE dispatch workload)",
              file=sys.stderr)
        return 2
    if args.max_faults is not None:
        print("error: --max-faults does not apply to --moe (cells "
              "draw the hot-expert skew, not wire faults; sweep more "
              "cells with --trials)", file=sys.stderr)
        return 2
    if args.ranks is not None:
        print("error: --ranks does not apply to --moe (one rank "
              "count per campaign; use -n/--n instead)",
              file=sys.stderr)
        return 2
    try:
        report = moe_campaign(
            seed=args.seed,
            n=args.n_ranks if args.n_ranks is not None else 4,
            duration=(args.duration if args.duration is not None
                      else 120),
            trials=args.trials,
        )
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    for cell in report["reports"]:
        print(
            f"{cell['cell']:>16}: {cell['verdict']}"
            f" | batches {cell['batches_accepted']}/{cell['batches']}"
            f" accepted"
            + (f" | hot rank {cell['hot_rank']} "
               f"({cell['hot_factor']}x)"
               if cell["hot_expert"] is not None else "")
        )
    print(
        f"{report['cells']} cells (seed {args.seed}), "
        f"{report['silent_corruptions']} silent corruptions, "
        f"{report['lost_accepted']} lost accepted, "
        f"{report['stale_epoch_leaks']} stale-epoch leaks"
    )
    for failure in report["failures"]:
        print(
            f"FAILURE {failure['cell']} trial {failure['trial']}: "
            f"{failure['verdict']}"
        )
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)
            f.write("\n")
        print(f"report -> {args.out}")
    if report["ok"]:
        print("moe campaign ok: every accepted batch reassembled "
              "bit-identically; hot-expert skew surfaced as named "
              "backpressure, never as a membership transition")
    return 0 if report["ok"] else 1


def _cmd_chaos_partition(args: argparse.Namespace) -> int:
    """``chaos --partition``: the partition-tolerance campaign
    (:mod:`smi_tpu_torch.serving.campaign`).

    Per trial: a clean symmetric cut/heal A/B (the minority's quorum
    lease lapses and it parks, every stream homed there is refused
    LOUDLY, the quorate majority fails over under a fenced epoch
    bump, and the heal's delivery is bit-identical to the
    no-partition control), an asymmetric cut during a live migration
    (the one-way link loss only round-trip lease evidence can see;
    the migration must abort loudly, loss-free), and a flapping-link
    soak (suspect/clear hysteresis — zero membership transitions).
    Exit gate: zero split-brain incidents, zero lost-accepted, zero
    silent corruption, zero stale-epoch leaks.
    """
    from smi_tpu_torch.serving.campaign import partition_campaign

    if args.protocols:
        print("error: --protocols does not apply to --partition "
              "(the campaign cuts the serving front-end's control "
              "plane, not a ring protocol)", file=sys.stderr)
        return 2
    if args.max_faults is not None:
        print("error: --max-faults does not apply to --partition "
              "(each cell injects exactly one partition-class "
              "fault; sweep more cells with --trials)",
              file=sys.stderr)
        return 2
    if args.ranks is not None:
        print("error: --ranks does not apply to --partition (one "
              "rank count per campaign; use -n/--n instead)",
              file=sys.stderr)
        return 2
    only = None
    if getattr(args, "asymmetric", False):
        only = "partition-migration-abort"
    elif getattr(args, "flap", False):
        only = "flapping-link"
    try:
        report = partition_campaign(
            seed=args.seed,
            n=args.n_ranks if args.n_ranks is not None else 4,
            duration=(args.duration if args.duration is not None
                      else 240),
            trials=args.trials,
            only=only,
        )
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    for cell in report["reports"]:
        part = cell.get("partition") or {}
        line = f"{cell['cell']:>25}: {cell['verdict']}"
        if cell["cell"] == "partition-heal":
            line += (
                f" | park {part.get('quorum_losses', 0)}, "
                f"refused loudly "
                f"{part.get('quorum_rejections', 0)}, "
                f"rejoined {part.get('heal_rejoins', 0)}, "
                f"split-brain "
                f"{part.get('split_brain_incidents', 0)}, "
                f"{cell['digest_common']} streams bit-identical "
                f"to control"
            )
        elif cell["cell"] == "partition-migration-abort":
            migs = cell.get("elasticity", {}).get("migrations", ())
            reasons = [m.get("abort_reason") for m in migs
                       if m.get("state") == "aborted"]
            line += (
                f" | {len(list(migs))} migration(s), aborted: "
                f"{reasons}, rejoined "
                f"{part.get('heal_rejoins', 0)}"
            )
        elif cell["cell"] == "flapping-link":
            line += (
                f" | {len(cell['suspected'])} suspect/clear "
                f"cycle(s), epoch {cell['epoch']}, "
                f"{len(cell['discarded_vectors'])} vector(s) "
                f"discarded"
            )
        print(line)
    print(
        f"{report['cells']} cells (seed {args.seed}), "
        f"{report['split_brain_incidents']} split-brain incidents, "
        f"{report['silent_corruptions']} silent corruptions, "
        f"{report['lost_accepted']} lost accepted, "
        f"{report['stale_epoch_leaks']} stale-epoch leaks"
    )
    for failure in report["failures"]:
        print(
            f"FAILURE {failure['cell']} trial {failure['trial']}: "
            f"{failure['verdict']}"
        )
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)
            f.write("\n")
        print(f"report -> {args.out}")
    if report["ok"]:
        print("partition campaign ok: the minority parked loudly, "
              "the majority stayed fenced, heals rejoined, and no "
              "tenant ever had two primaries")
    return 0 if report["ok"] else 1


def _cmd_chaos_infer(args: argparse.Namespace) -> int:
    """``chaos --infer``: the streaming-inference campaign
    (:mod:`smi_tpu_torch.serving.campaign`).

    Disaggregated prefill/decode under chaos, per trial: the no-fault
    smoke, kill-decode-mid-generation (ONE committed KV handoff names
    the dead rank; delivery bit-identical to the no-fault control,
    zero lost accepted tokens), kill-prefill (stateless WAL replay —
    zero handoffs), saturate-decode (the named backpressure blame
    verdict triggers the handoff, never a membership event),
    partition-during-handoff (loud fenced abort, loss-free), and the
    scale-in victim discipline (a rank holding resident KV shards is
    never the victim). Exit gate: every cell ``ok``.
    """
    from smi_tpu_torch.serving.campaign import infer_campaign

    if args.protocols:
        print("error: --protocols does not apply to --infer (the "
              "campaign kills and saturates the serving front-end's "
              "decode/prefill ranks, not a ring protocol)",
              file=sys.stderr)
        return 2
    if args.max_faults is not None:
        print("error: --max-faults does not apply to --infer (each "
              "cell injects exactly one inference-class fault; sweep "
              "more cells with --trials)", file=sys.stderr)
        return 2
    if args.ranks is not None:
        print("error: --ranks does not apply to --infer (one rank "
              "count per campaign; use -n/--n instead)",
              file=sys.stderr)
        return 2
    only = None
    if getattr(args, "kill_decode", False):
        only = "infer-kill-decode"
    elif getattr(args, "kill_prefill", False):
        only = "infer-kill-prefill"
    elif getattr(args, "saturate", False):
        only = "infer-saturate"
    try:
        report = infer_campaign(
            seed=args.seed,
            n=args.n_ranks if args.n_ranks is not None else 4,
            duration=(args.duration if args.duration is not None
                      else 200),
            trials=args.trials,
            only=only,
        )
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    for cell in report["reports"]:
        inf = cell["inference"]
        committed = [h for h in inf["handoffs"]
                     if h["state"] == "committed"]
        line = (
            f"{cell['cell']:>25}: {cell['verdict']}"
            f" | {inf['states']['done']} done, "
            f"{len(committed)} handoff(s) committed, "
            f"{inf['replayed_prefills']} prefill replay(s)"
        )
        if "digest_intersection" in cell:
            line += (
                f", {cell['digest_intersection']} generation(s) "
                f"bit-identical to control"
            )
        print(line)
    print(
        f"{report['cells']} cells (seed {args.seed}), "
        f"{report['kv_handoffs_committed']} KV handoffs committed, "
        f"{report['replayed_prefills']} prefills replayed, "
        f"{report['lost_accepted_tokens']} lost accepted tokens, "
        f"{report['silent_corruptions']} silent corruptions, "
        f"{report['stale_epoch_leaks']} stale-epoch leaks"
    )
    for failure in report["failures"]:
        print(
            f"FAILURE {failure['cell']} trial {failure['trial']}: "
            f"{failure['verdict']}"
        )
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)
            f.write("\n")
        print(f"report -> {args.out}")
    if report["ok"]:
        print("inference campaign ok: decode deaths handed their KV "
              "off exactly once, prefill deaths replayed statelessly, "
              "and no accepted token was ever lost")
    return 0 if report["ok"] else 1


def cmd_serve(args: argparse.Namespace) -> int:
    """``serve --selftest``: the deterministic serving smoke.

    One seeded admit→stream→shed→drain pass of the multi-tenant
    front-end at 2x overload on the CPU (pure Python, milliseconds):
    every acceptance must end in bit-identical delivery, shedding must
    be lowest-class-first with named errors, queue occupancy must stay
    inside the structural bound, and the interactive p99
    admission-latency bound must hold. Nonzero exit on any gate
    failure — the CI hook for the serving layer.
    """
    from smi_tpu_torch.serving.campaign import (
        autoscale_selftest,
        infer_selftest,
        partition_selftest,
        retune_selftest,
        serve_selftest,
    )

    if not args.selftest:
        print("error: serve requires --selftest (the live serving "
              "loop needs a mesh; only the deterministic smoke runs "
              "from the CLI)", file=sys.stderr)
        return 2
    if args.json and getattr(args, "metrics", False):
        print("error: --json and --metrics are exclusive output "
              "modes (--json's full report already embeds the "
              "metrics snapshot)", file=sys.stderr)
        return 2
    if getattr(args, "metrics", False) and getattr(args, "infer",
                                                   False):
        print("error: --metrics does not apply to --infer (the "
              "inference cell reports the engine's own handoff/"
              "replay counters; use --json for the full report)",
              file=sys.stderr)
        return 2
    picked = [f for f, v in (("--retune",
                              getattr(args, "retune", False)),
                             ("--autoscale",
                              getattr(args, "autoscale", False)),
                             ("--partition",
                              getattr(args, "partition", False)),
                             ("--infer",
                              getattr(args, "infer", False)))
              if v]
    if len(picked) > 1:
        print(f"error: {' and '.join(picked)} are distinct "
              f"selftests; pick one", file=sys.stderr)
        return 2
    if getattr(args, "retune", False):
        report = retune_selftest(seed=args.seed)
    elif getattr(args, "autoscale", False):
        report = autoscale_selftest(seed=args.seed)
    elif getattr(args, "partition", False):
        report = partition_selftest(seed=args.seed)
    elif getattr(args, "infer", False):
        report = infer_selftest(seed=args.seed)
    else:
        report = serve_selftest(seed=args.seed)
    if args.json:
        print(json.dumps(report, indent=2))
    elif getattr(args, "metrics", False):
        # the deterministic metrics snapshot alone (scriptable): the
        # registry's counters equal the gate's own bookkeeping
        print(json.dumps(
            {"metrics": report["metrics"], "obs": report["obs"],
             "ok": report["ok"]},
            indent=2, sort_keys=True,
        ))
    elif getattr(args, "infer", False):
        inf = report["inference"]
        committed = [h for h in inf["handoffs"]
                     if h["state"] == "committed"]
        print(f"selftest (seed {args.seed}): {report['verdict']}")
        print(
            f"      infer: decode rank {report['victim']} killed "
            f"at tick {report['kill_at']}"
        )
        print(
            f"  generated: {inf['states']['done']} done "
            f"({inf['tokens_emitted']} tokens), "
            f"{inf['replayed_prefills']} prefill replay(s)"
        )
        print(
            f"    handoff: {len(committed)} KV handoff(s) committed "
            f"({', '.join(h['reason'] for h in committed)}), "
            f"{inf['lost_accepted_tokens']} accepted token(s) lost"
        )
        print(
            f"     digest: {report['digest_intersection']} "
            f"generation(s) bit-identical to the no-fault control, "
            f"{report['silent_corruptions']} silent corruptions, "
            f"{report['stale_epoch_leaks']} stale-epoch leaks"
        )
    else:
        lat = report["admission_latency"]
        print(f"selftest (seed {args.seed}): {report['verdict']}")
        print(f"   accepted: {report['accepted']}")
        print(f"  delivered: {report['delivered']}")
        print(f"       shed: " + ", ".join(
            f"{c}={sum(report['shed'][c].values())}"
            for c in report["shed"]
        ))
        print(
            f"  admission p99 (ticks): " + ", ".join(
                f"{c}={lat[c]['p99']}" for c in lat
            )
        )
        print(
            f"  queue depth max {report['max_queue_depth']} "
            f"(bound {report['queue_bound']}), "
            f"{report['silent_corruptions']} silent corruptions, "
            f"{report['lost_accepted']} lost accepted"
        )
        # the r15 health line: burn-rate state + the blame verdict
        health = report.get("health")
        if health is not None:
            breached = [
                q for q, c in health["classes"].items()
                if c["breaches"]
            ]
            print(
                f"     health: "
                + ("ok" if not health["breaches_total"] else
                   f"{health['breaches_total']} SLO breach(es) "
                   f"[{', '.join(breached)}]")
                + f"; span exactness "
                + ("held" if report.get("span_exact") else "FAILED")
            )
        blame = report.get("blame")
        if blame is not None:
            b = blame["binding"]
            print(
                f"      blame: tail bound by {b['component']} -> "
                f"{b['resource']} ({b['share']:.0%} of the slow "
                f"decile)"
            )
        if getattr(args, "retune", False):
            rt = report["retune"]
            print(
                f"     retune: {rt['samples_ingested']} samples, "
                f"{rt['proposals']} proposal(s), {rt['swaps']} "
                f"swap(s), {rt['rollbacks']} rollback(s); converged "
                f"to {report['converged_algorithm']!r} (expected "
                f"{report['expected_algorithm']!r}) "
                f"{report['convergence_ticks']} ticks after the "
                f"shift; {rt['stale_plan_rejections']} stale-plan "
                f"straggler(s) rejected, {rt['stale_plan_leaks']} "
                f"leaked"
            )
        if getattr(args, "autoscale", False):
            el = report["elasticity"]
            migs = el["migrations"]
            committed = sum(
                1 for m in migs if m["state"] == "committed"
            )
            print(
                f"    elastic: {el['scale_outs']} scale-out(s), "
                f"{el['scale_ins']} scale-in(s), "
                f"parked {el['parked']}, {len(migs)} migration(s) "
                f"({committed} committed), "
                f"crowd window {report['crowd_window']} at "
                f"{report['crowd_factor']}x"
            )
        if getattr(args, "partition", False):
            part = report["partition"]
            print(
                f"  partition: rank {report['victim_rank']} cut for "
                f"{report['window']} ticks; parked "
                f"{part['quorum_losses']}, refused loudly "
                f"{part['quorum_rejections']}, rejoined "
                f"{part['heal_rejoins']}, split-brain "
                f"{part['split_brain_incidents']}; "
                f"{report['digest_common']} streams bit-identical "
                f"to the no-partition control "
                f"({report['digest_divergent']} divergent)"
            )
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)
            f.write("\n")
        print(f"report -> {args.out}")
    return 0 if report["ok"] else 1


def cmd_trace(args: argparse.Namespace) -> int:
    """``smi-tpu trace``: Perfetto/Chrome-trace export of registered
    protocols (:mod:`smi_tpu_torch.obs.trace`).

    Runs the timestamped simulator over the selected protocols'
    DEFAULT_SHAPES grid and writes one Chrome-trace JSON per instance
    (open in Perfetto / ``chrome://tracing``): per-rank tracks, every
    span attributed alpha/beta/serialization/idle by the static perf
    decomposer, span sums asserted bit-identical to the simulator's
    ``elapsed_seconds()``. Deterministic per ``--seed`` — same seed,
    byte-identical files. With ``-o DIR`` one ``<name>.trace.json``
    per instance; without, one combined JSON document on stdout.
    """
    from smi_tpu_torch.analysis.verifier import DEFAULT_SHAPES
    from smi_tpu_torch.obs import trace as obs_trace

    if getattr(args, "serve", False):
        if args.all or args.protocols:
            print("error: --serve and --protocol/--all are exclusive "
                  "(--serve traces the seeded serving selftest, not "
                  "a simulator protocol)", file=sys.stderr)
            return 2
        if args.payload_kb is not None:
            print("error: --payload-kb only applies to protocol "
                  "traces (--serve's payloads are the selftest's own "
                  "chunk streams)", file=sys.stderr)
            return 2
        return _cmd_trace_serve(args)
    if args.all and args.protocols:
        print("error: --all and --protocol are exclusive (--all "
              "already selects every registered protocol)",
              file=sys.stderr)
        return 2
    if not args.all and not args.protocols:
        print("error: pick protocols with --protocol NAME "
              "(repeatable), trace every registered protocol with "
              "--all, or export a serving run with --serve",
              file=sys.stderr)
        return 2
    known = list(DEFAULT_SHAPES)
    protocols = known if args.all else args.protocols
    unknown = [p for p in protocols if p not in known]
    if unknown:
        print(f"error: unknown protocol(s) {unknown}; known: {known}",
              file=sys.stderr)
        return 2
    if args.payload_kb is not None and args.payload_kb <= 0:
        print(f"error: --payload-kb must be positive, got "
              f"{args.payload_kb}", file=sys.stderr)
        return 2
    payload_bytes = float(
        (args.payload_kb if args.payload_kb is not None else 4096)
        * 1024
    )
    traces = obs_trace.trace_all(
        protocols, payload_bytes=payload_bytes, seed=args.seed
    )
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        for t in traces:
            other = t["otherData"]
            path = os.path.join(
                args.out, obs_trace.trace_name(t) + ".trace.json"
            )
            with open(path, "wb") as f:
                f.write(obs_trace.trace_to_json_bytes(t))
            shape = ", ".join(
                f"{k}={v}" for k, v in sorted(other["shape"].items())
            )
            print(
                f"{other['protocol']} [{shape}]: makespan "
                f"{other['makespan_us']:.1f} us, "
                f"{len(t['traceEvents'])} events -> {path}"
            )
        print(f"{len(traces)} trace(s) (seed {args.seed}) -> "
              f"{args.out}")
    else:
        sys.stdout.write(
            obs_trace.trace_to_json_bytes(
                {"traces": traces}
            ).decode()
        )
    return 0


def _cmd_trace_serve(args: argparse.Namespace) -> int:
    """``smi-tpu trace --serve``: export a seeded ``serve --selftest``
    run as a Chrome trace — per-tenant track groups, one thread per
    request, spans from the r15 span builder (components + parks/
    sheds/retune-quiesce annotations). Deterministic per ``--seed``:
    same seed, byte-identical file; schema-validated before writing.
    """
    from smi_tpu_torch.obs import trace as obs_trace
    from smi_tpu_torch.obs.spans import frontend_spans
    from smi_tpu_torch.serving.campaign import serve_selftest

    report, fe = serve_selftest(seed=args.seed, return_frontend=True)
    payload = obs_trace.trace_serving(
        frontend_spans(fe), seed=args.seed, label="selftest"
    )
    obs_trace.validate_chrome_trace(payload)
    data = obs_trace.trace_to_json_bytes(payload)
    other = payload["otherData"]
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        path = os.path.join(
            args.out, obs_trace.trace_name(payload) + ".trace.json"
        )
        with open(path, "wb") as f:
            f.write(data)
        print(
            f"serving selftest (seed {args.seed}): "
            f"{other['requests']} request(s) across "
            f"{other['tenants']} tenant(s), "
            f"{other['delivered']} delivered / {other['shed']} shed, "
            f"makespan {other['makespan_ticks']} ticks -> {path}"
        )
    else:
        sys.stdout.write(data.decode())
    return 0 if report["ok"] else 1


def cmd_health(args: argparse.Namespace) -> int:
    """``smi-tpu health``: render span / SLO / blame state from a
    recorded run (a ``serve --selftest -o`` / ``chaos --load -o``
    report JSON) or from a fresh seeded selftest (``--selftest``).

    Text output: per cell, the burn-rate health table, the
    tail-latency blame verdict, and the span digest. ``--json``
    prints the extracted state. Exit 1 when any rendered cell failed
    its gates (breaches alone are health *observations*, not
    failures); 2 on usage errors.
    """
    from smi_tpu_torch.obs.slo import format_health
    from smi_tpu_torch.obs.spans import format_blame

    if args.selftest and args.report:
        print("error: pass a recorded REPORT.json or --selftest, "
              "not both", file=sys.stderr)
        return 2
    if args.report and args.seed is not None:
        print("error: --seed only applies to --selftest (a recorded "
              "report carries its own seed)", file=sys.stderr)
        return 2
    if not args.selftest and not args.report:
        print("error: pass a recorded REPORT.json (serve --selftest "
              "-o / chaos --load -o) or run a fresh one with "
              "--selftest", file=sys.stderr)
        return 2
    if args.selftest:
        from smi_tpu_torch.serving.campaign import serve_selftest

        seed = args.seed if args.seed is not None else 0
        payload = serve_selftest(seed=seed)
        source = f"selftest (seed {seed})"
    else:
        try:
            with open(args.report) as f:
                payload = json.load(f)
        except OSError as e:
            print(f"error: cannot read {args.report}: {e}",
                  file=sys.stderr)
            return 2
        except json.JSONDecodeError as e:
            print(f"error: {args.report} is not JSON: {e}",
                  file=sys.stderr)
            return 1
        source = args.report
    cells = payload.get("reports") if isinstance(payload, dict) \
        else None
    if cells is None:
        cells = [payload]
    missing = [i for i, c in enumerate(cells)
               if not isinstance(c, dict) or "health" not in c]
    if missing:
        print(
            f"error: {source} carries no health state (cell(s) "
            f"{missing} lack the r15 'health' field — re-record with "
            f"this build)", file=sys.stderr)
        return 1
    if args.json:
        print(json.dumps({
            "source": source,
            "cells": [{
                "cell": c.get("cell", "selftest"),
                "ok": c.get("ok"),
                "verdict": c.get("verdict"),
                "health": c["health"],
                "blame": c.get("blame"),
                "spans": c.get("spans"),
                "span_exact": c.get("span_exact"),
            } for c in cells],
        }, indent=2, sort_keys=True))
    else:
        print(f"health: {source} ({len(cells)} cell(s))")
        for c in cells:
            name = c.get("cell", "selftest")
            print(f"\n[{name}] verdict: {c.get('verdict', '?')}")
            for line in format_health(c["health"]):
                print(line)
            for line in format_blame(c.get("blame")):
                print(line)
            spans = c.get("spans") or {}
            if "error" in spans:
                print(f"  spans: {spans['error']}")
            elif spans:
                comps = ", ".join(
                    f"{k}={v}" for k, v in
                    spans.get("components_ticks", {}).items()
                )
                print(
                    f"  spans: {spans.get('requests', 0)} request(s) "
                    f"{spans.get('outcomes', {})}, exact="
                    f"{c.get('span_exact')} [{comps}]"
                )
    return 0 if all(c.get("ok") for c in cells) else 1


def cmd_lint(args: argparse.Namespace) -> int:
    """``smi-tpu lint``: the static protocol verifier as a merge gate.

    Verifies every registered protocol (or the ``--protocol`` subset)
    over the default shape grid: deadlock-freedom, slot-race-freedom,
    credit conservation, and wire-lane monotonicity, proven for the
    WHOLE schedule space from one symbolic replay per rank
    (:mod:`smi_tpu_torch.analysis`). Pure Python — no JAX, no devices,
    milliseconds — so CI gates merges on it the way the reference's
    codegen rejects ill-formed programs before anything runs. Exit is
    nonzero on any finding; ``--json`` emits the schema-tested report.

    ``--mutant`` applies one deliberately broken variant
    (:data:`smi_tpu_torch.analysis.MUTANTS`) across the protocol's whole
    default shape grid before verifying — the demonstration (and test)
    path for the nonzero exit and the diagnostics' (rank, step,
    primitive) coordinates. A mutant absorbed at every default shape
    (possible: some damage is benign at small sizes) exits 0 with an
    explicit note, never a silent ok.
    """
    from smi_tpu_torch import analysis

    if getattr(args, "combined", False):
        # the combined gate runs the full default grid of every tier —
        # narrowing flags would let a CI caller believe the whole gate
        # ran when a subset did. --hlo is NOT a narrowing flag: it
        # supplies an artifact that ADDS the serialized-dma check to
        # the perf tier, so the one-command gate accepts it.
        conflicts = [
            flag for flag, val in (
                ("--model", args.model),
                ("--perf", getattr(args, "perf", False)),
                ("--protocol", args.protocol),
                ("--mutant", args.mutant),
                ("--scope", getattr(args, "scope", None)),
            ) if val
        ]
        if conflicts:
            print(f"error: --combined runs all three tiers at their "
                  f"default grids; {', '.join(conflicts)} "
                  f"{'select' if len(conflicts) > 1 else 'selects'} a "
                  f"subset — drop it or run the tier alone",
                  file=sys.stderr)
            return 2
        return _cmd_lint_combined(args)
    if args.all and args.protocol:
        # silently dropping the filter (or the --all) would let a CI
        # caller believe a different gate ran than the one that did
        print("error: --all and --protocol are mutually exclusive",
              file=sys.stderr)
        return 2
    if args.model and getattr(args, "perf", False):
        print("error: --model and --perf are distinct tiers; pick one "
              "(or --combined for all of them)", file=sys.stderr)
        return 2
    if getattr(args, "scope", None) and not args.model:
        print("error: --scope applies only to --model (protocol "
              "instances are sized by the default shape grid)",
              file=sys.stderr)
        return 2
    if getattr(args, "hlo", None) and not getattr(args, "perf", False):
        print("error: --hlo applies only to --perf or --combined (the "
              "serialized-dma rule reads a compiled artifact; the "
              "protocol/model tiers read none)", file=sys.stderr)
        return 2
    if args.model:
        return _cmd_lint_model(args)
    if getattr(args, "perf", False):
        return _cmd_lint_perf(args)
    try:
        if args.mutant:
            if not args.protocol:
                print("error: --mutant needs --protocol NAME",
                      file=sys.stderr)
                return 2
            if args.mutant not in analysis.MUTANTS:
                print(f"error: unknown mutant {args.mutant!r} for the "
                      f"protocol tier; known: {list(analysis.MUTANTS)} "
                      f"(perf mutants {list(analysis.PERF_MUTANTS)} "
                      f"apply with --perf; control-plane mutants "
                      f"{list(analysis.MODEL_MUTANTS)} with --model)",
                      file=sys.stderr)
                return 2
            unknown = [p for p in args.protocol
                       if p not in analysis.DEFAULT_SHAPES]
            if unknown:
                # same diagnostic as the non-mutant path — a typo must
                # not surface as a bare KeyError repr
                print(f"error: unknown protocol(s) {unknown}; known: "
                      f"{list(analysis.DEFAULT_SHAPES)}",
                      file=sys.stderr)
                return 2
            # sweep the protocol's WHOLE default shape grid, like the
            # non-mutant path: some protocol x mutant pairs are benign
            # at one size but fire at another
            reports = []
            for protocol in args.protocol:
                for shape in analysis.DEFAULT_SHAPES[protocol]:
                    shape = dict(shape)
                    reports.append(analysis.verify_generators(
                        lambda p=protocol, s=shape:
                            analysis.mutant_generators(
                                p, mutant=args.mutant, **s
                            ),
                        protocol=f"{protocol}[{args.mutant}]",
                        shape=shape,
                    ))
        else:
            protocols = None if args.all else (args.protocol or None)
            reports = analysis.lint_all(protocols=protocols)
    except (ValueError, KeyError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    payload = analysis.reports_to_json(reports)
    if args.json:
        print(json.dumps(payload, indent=2))
    else:
        print(analysis.render_reports(reports))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(payload, f, indent=2)
            f.write("\n")
        if not args.json:
            print(f"report -> {args.out}")
    if args.mutant and payload["ok"]:
        # an ok mutant run must not read as "the gate is broken" —
        # the injected damage is genuinely absorbed at every default
        # shape of this protocol (the dynamic fuzzer agrees)
        print(
            f"note: mutant {args.mutant!r} did not manifest at any "
            f"default shape of {list(args.protocol)} — the damage is "
            f"benign at these sizes, not missed by the verifier",
            file=sys.stderr,
        )
    return 0 if payload["ok"] else 1


def _emit_lint_report(args: argparse.Namespace, payload: dict,
                      text: str) -> int:
    """The shared lint-report epilogue: print JSON or the rendered
    text, optionally also write the JSON artifact — one copy for every
    lint tier, so the output contract cannot drift between them.
    Returns the exit code (1 on findings)."""
    if args.json:
        print(json.dumps(payload, indent=2))
    else:
        print(text)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(payload, f, indent=2)
            f.write("\n")
        if not args.json:
            print(f"report -> {args.out}")
    return 0 if payload["ok"] else 1


def _cmd_lint_model(args: argparse.Namespace) -> int:
    """``smi-tpu lint --model``: the control-plane model checker.

    Exhaustively verifies the seven control-plane properties —
    queue-occupancy bound, stream-credit conservation,
    starvation-freedom, epoch safety, no-lost-accepted, plan-epoch
    safety, no-lost-accepted-across-swap — over every
    reachable state of each scope in the default grid (or the single
    ``--scope SPEC``), driving the REAL admission gate / scheduler /
    membership / WAL objects (:mod:`smi_tpu_torch.analysis.model`). Exit 1
    on any finding, each carried as a minimal counterexample trace
    that ``smi_tpu_torch.serving.campaign.replay_model_trace`` re-executes
    as a failing campaign cell. ``--mutant`` applies one control-plane
    mutant (:data:`smi_tpu_torch.analysis.MODEL_MUTANTS`) across the grid.
    Truncated budgets are never silent: the report carries
    explored/estimated_total/truncated per scope and in the coverage
    summary.
    """
    from smi_tpu_torch import analysis

    if args.protocol:
        print("error: --protocol applies to the protocol tier; the "
              "model tier is sized by --scope", file=sys.stderr)
        return 2
    if args.all and args.scope:
        # same discipline as --all vs --protocol: silently narrowing
        # the sweep to one scope would let a CI caller believe the
        # whole grid ran
        print("error: --all and --scope are mutually exclusive "
              "(--all is the default grid; --scope checks one scope)",
              file=sys.stderr)
        return 2
    try:
        scopes = (
            [analysis.parse_scope(args.scope)] if args.scope
            else list(analysis.DEFAULT_SCOPES)
        )
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if args.mutant:
        if args.mutant not in analysis.MODEL_MUTANTS:
            print(f"error: unknown control-plane mutant "
                  f"{args.mutant!r}; known: "
                  f"{list(analysis.MODEL_MUTANTS)} (protocol mutants "
                  f"{list(analysis.MUTANTS)} apply without --model)",
                  file=sys.stderr)
            return 2
        factory = analysis.model_mutant_world(args.mutant)
        reports = [
            analysis.check_scope(scope, world_factory=factory,
                                 mutant=args.mutant)
            for scope in scopes
        ]
    else:
        reports = analysis.check_scopes(scopes)
    payload = analysis.model_reports_to_json(reports)
    rc = _emit_lint_report(args, payload,
                           analysis.render_model_reports(reports))
    if args.mutant and payload["ok"]:
        print(
            f"note: control-plane mutant {args.mutant!r} did not "
            f"manifest at any checked scope — the damage is benign at "
            f"these sizes, not missed by the checker",
            file=sys.stderr,
        )
    return rc


def _cmd_lint_perf(args: argparse.Namespace) -> int:
    """``smi-tpu lint --perf``: the static performance analyzer.

    Sub-tier (a) decomposes every registered protocol's makespan (or
    the ``--protocol`` subset) on the timestamped credits simulator
    into alpha/beta/serialization/idle per rank and per wire tier,
    naming the binding wait edge as (rank, step, primitive) events;
    sub-tier (b) runs the kernel roofline lint (VMEM double-buffer
    bound, tile roofline fraction, analytic drift vs the committed
    expectations, and — with ``--hlo DUMP`` — serialized dependent DMA
    chains). Exit 1 on findings / 2 on usage. ``--mutant`` applies one
    safe-but-slow variant (:data:`smi_tpu_torch.analysis.PERF_MUTANTS`);
    each must be convicted by exactly its rule.
    """
    from smi_tpu_torch import analysis

    hlo_text = None
    if getattr(args, "hlo", None):
        try:
            with open(args.hlo) as f:
                hlo_text = f.read()
        except OSError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
    try:
        if args.mutant:
            return _cmd_lint_perf_mutant(args, analysis, hlo_text)
        protocols = None if args.all else (args.protocol or None)
        reports = analysis.perf_all(protocols=protocols)
        roofline = analysis.roofline_lint(hlo_text=hlo_text)
    except (ValueError, KeyError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    payload = analysis.perf_reports_to_json(reports, roofline)
    return _emit_lint_report(
        args, payload, analysis.render_perf_reports(reports, roofline)
    )


def _cmd_lint_perf_mutant(args, analysis, hlo_text) -> int:
    """The ``lint --perf --mutant NAME`` path: protocol-timing mutants
    sweep their protocol's default shape grid; the roofline mutant
    prices its mis-tiled compile. Benign-at-every-shape exits 0 with an
    explicit note, mirroring the protocol tier."""
    if args.mutant not in analysis.PERF_MUTANTS:
        print(f"error: unknown perf mutant {args.mutant!r}; known: "
              f"{list(analysis.PERF_MUTANTS)} (protocol mutants "
              f"{list(analysis.MUTANTS)} apply without --perf; "
              f"control-plane mutants {list(analysis.MODEL_MUTANTS)} "
              f"with --model)", file=sys.stderr)
        return 2
    reports = []
    roofline = []
    if args.mutant == "oversized_flash_tile":
        if args.protocol:
            print("error: oversized_flash_tile is a roofline-tier "
                  "mutant (a tile choice, not a protocol transform); "
                  "drop --protocol", file=sys.stderr)
            return 2
        roofline = analysis.roofline_lint(
            flash_tiles=[analysis.OVERSIZED_FLASH_TILE],
            hlo_text=hlo_text, check_expectations=False,
        )
    else:
        protocols = args.protocol or (
            ["all_reduce_chunked"]
            if args.mutant == "unoverlapped_chunks"
            else list(analysis.DEFAULT_SHAPES)
        )
        unknown = [p for p in protocols
                   if p not in analysis.DEFAULT_SHAPES]
        if unknown:
            print(f"error: unknown protocol(s) {unknown}; known: "
                  f"{list(analysis.DEFAULT_SHAPES)}", file=sys.stderr)
            return 2
        from smi_tpu_torch.analysis.perf import _costs_for

        for protocol in protocols:
            for shape in analysis.DEFAULT_SHAPES[protocol]:
                shape = dict(shape)
                costs, _message, pipeline = _costs_for(
                    protocol, shape, float(analysis.PERF_PAYLOAD_BYTES)
                )
                try:
                    reports.append(analysis.decompose_generators(
                        lambda p=protocol, s=shape:
                            analysis.perf_mutant_generators(
                                p, args.mutant, s["n"],
                                chunks=s.get("chunks", 3),
                                slices=s.get("slices", 2),
                            ),
                        costs,
                        protocol=f"{protocol}[{args.mutant}]",
                        shape=shape,
                        pipeline_chunks=pipeline,
                    ))
                except ValueError as e:
                    print(f"error: {e}", file=sys.stderr)
                    return 2
    payload = analysis.perf_reports_to_json(reports, roofline)
    rc = _emit_lint_report(
        args, payload, analysis.render_perf_reports(reports, roofline)
    )
    if payload["ok"]:
        print(
            f"note: perf mutant {args.mutant!r} did not manifest at "
            f"any checked shape — the damage is benign at these "
            f"sizes, not missed by the analyzer",
            file=sys.stderr,
        )
    return rc


def _cmd_lint_combined(args: argparse.Namespace) -> int:
    """``smi-tpu lint --combined``: protocol + model + perf tiers in
    one invocation — the one-command merge gate. Each tier runs its
    full default grid (an ``--hlo`` artifact additionally feeds the
    perf tier's serialized-dma rule); the merged JSON carries one
    section per tier and the exit code is 1 if ANY tier found
    anything."""
    from smi_tpu_torch import analysis

    hlo_text = None
    if getattr(args, "hlo", None):
        try:
            with open(args.hlo) as f:
                hlo_text = f.read()
        except OSError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
    protocol_reports = analysis.lint_all()
    model_reports = analysis.check_scopes(list(analysis.DEFAULT_SCOPES))
    # the protocol tier just verified the identical DEFAULT_SHAPES
    # grid — re-proving safety inside the decomposition would double
    # the static-analysis bill for nothing
    perf_reports = analysis.perf_all(verify=False)
    roofline = analysis.roofline_lint(hlo_text=hlo_text)
    tiers = {
        "protocol": analysis.reports_to_json(protocol_reports),
        "model": analysis.model_reports_to_json(model_reports),
        "perf": analysis.perf_reports_to_json(perf_reports, roofline),
    }
    findings = sum(t["findings"] for t in tiers.values())
    payload = {
        "ok": all(t["ok"] for t in tiers.values()),
        "tier": "combined",
        "findings": findings,
        "tiers": tiers,
    }
    text = "\n".join([
        "=== protocol tier ===",
        analysis.render_reports(protocol_reports),
        "=== model tier ===",
        analysis.render_model_reports(model_reports),
        "=== perf tier ===",
        analysis.render_perf_reports(perf_reports, roofline),
        f"combined: {findings} finding(s) across {len(tiers)} tiers",
    ])
    return _emit_lint_report(args, payload, text)


def cmd_traffic(args: argparse.Namespace) -> int:
    """Offline traffic/overlap analysis of an HLO text dump.

    The artifact-reading half of the ``aoc -rtl -report`` workflow for
    the overlap engine: feed it ``compiled.as_text()`` (saved by an AOT
    run or ``jax.jit(...).lower(x).compile().as_text()``) and it prints
    either the per-collective payload records or — with ``--overlap`` —
    the comm/compute overlap report
    (:func:`smi_tpu_torch.parallel.traffic.overlap_report`), making overlap a
    checkable property of a build artifact rather than a profile-time
    hope. ``--require-overlap`` exits nonzero when no compute is
    overlappable/scheduled during the collectives — a CI gate.
    """
    from smi_tpu_torch.parallel import traffic as T

    try:
        with open(args.hlo) as f:
            text = f.read()
    except OSError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    if getattr(args, "lint", False):
        if args.overlap or args.require_overlap:
            # silently dropping either flag would let a CI caller
            # believe a gate ran that never did
            print("error: --lint and --overlap/--require-overlap are "
                  "separate modes", file=sys.stderr)
            return 2
        findings = T.traffic_lint(hlo_text=text)
        for f in findings:
            print(f"[{f['check']}] {f['message']}")
        print(f"{len(findings)} lint finding(s)")
        if args.out:
            with open(args.out, "w") as fh:
                json.dump({"lint": findings}, fh, indent=2)
                fh.write("\n")
            print(f"report -> {args.out}")
        return 1 if findings else 0
    if args.overlap:
        report = T.overlap_report(hlo_text=text)
        print(
            f"collectives: {report['collectives']} "
            f"({report['async_pairs']} async pairs)"
        )
        print(
            f"overlappable compute: {report['overlappable_bytes']} B "
            f"in {report['overlappable_ops']} ops "
            f"({report['overlap_fraction']:.1%} of "
            f"{report['compute_bytes']} B compute)"
        )
        if report["async_pairs"]:
            print(
                f"scheduled between start/done: "
                f"{report['scheduled_bytes']} B"
            )
        payload = report
        failed = args.require_overlap and report["overlapped_bytes"] == 0
    else:
        records = T.collective_traffic(None, hlo_text=text)
        for rec in records:
            loop = " (in loop)" if rec.get("in_loop") else ""
            print(
                f"{rec['op']:>20} {rec['name']:<32} "
                f"{rec['bytes']:>12} B{loop}"
            )
        print(
            f"{len(records)} collectives, "
            f"{sum(r['bytes'] for r in records)} B total payload"
        )
        payload = {"collectives": records}
        failed = args.require_overlap and not records
    if args.out:
        with open(args.out, "w") as f:
            json.dump(payload, f, indent=2)
            f.write("\n")
        print(f"report -> {args.out}")
    if failed:
        print("error: no comm/compute overlap found", file=sys.stderr)
        return 1
    return 0


def cmd_tune(args: argparse.Namespace) -> int:
    """``smi-tpu tune``: measured sweep + plan-cache write; with
    ``--explain OP``, print the candidate table instead.

    ``--explain`` is CPU-deterministic (no sweep, no devices beyond
    reading the local device kind): for each knob it prints the
    candidates with modeled vs measured costs and the layer — cache /
    model / heuristic — that decided it (``tuning.Plan.explain``).

    The sweep mode times candidate plans on the available backend with
    the microbenchmark harness and merges the winners into the cache
    file (``--cache``, ``$SMI_TPU_PLAN_CACHE``, or the per-user
    default); merging keeps whichever entry measured faster, so
    repeated/fleet-wide runs only ever improve the cache.
    """
    from smi_tpu_torch.tuning import PlanCache, PlanCacheError, engine
    from smi_tpu_torch.tuning.cache import default_cache_path

    if args.online:
        conflicts = [flag for flag, val in (
            ("--explain", args.explain), ("--ops", args.ops),
        ) if val]
        if conflicts:
            print(f"error: --online replays a recorded sample sink "
                  f"through the online tuner; {', '.join(conflicts)} "
                  f"{'select' if len(conflicts) > 1 else 'selects'} a "
                  f"different tune mode — drop it or run the modes "
                  f"separately", file=sys.stderr)
            return 2
        return _cmd_tune_online(args)
    if args.device_kind:
        print("error: --device-kind applies only to --online (sweeps "
              "and --explain key by the MEASURED local device kind)",
              file=sys.stderr)
        return 2
    if args.explain:
        try:
            print(engine.get_engine().explain_text(
                args.explain, n=args.ranks, dtype=args.dtype,
                slices=args.slices,
            ))
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        return 0

    from smi_tpu_torch.parallel.local import LocalWorld
    from smi_tpu_torch.tuning.sweep import (
        sweep_allreduce,
        sweep_allreduce_hierarchical,
        sweep_allreduce_precision,
        sweep_alltoall,
        sweep_stencil,
    )

    path = args.cache or default_cache_path()
    if not path:
        print("error: no cache path (pass --cache or set "
              "$SMI_TPU_PLAN_CACHE)", file=sys.stderr)
        return 2
    ops = args.ops or ["all_reduce"]
    unknown = [o for o in ops
               if o not in ("all_reduce", "flash_fwd", "hierarchical",
                            "alltoall", "stencil", "quantized")]
    if unknown:
        print(f"error: unknown op(s) {unknown}; sweepable: "
              f"all_reduce, flash_fwd, hierarchical, alltoall, "
              f"stencil, quantized",
              file=sys.stderr)
        return 2
    if "hierarchical" in ops and not args.slices:
        print("error: the hierarchical sweep needs --slices N (the "
              "pod shape to tier over)", file=sys.stderr)
        return 2
    # the sweeps' ranks are the threads of one LocalWorld of --ranks on
    # the card (the JAX package's are the devices of one controller)
    device = "cpu" if getattr(args, "cpu", False) else None

    def world_of(slices):
        if not slices:
            return LocalWorld(args.ranks, device=device)
        if slices < 1 or args.ranks % slices:
            raise ValueError(f"{args.ranks} ranks do not split into "
                             f"{slices} slices")
        return LocalWorld((slices, args.ranks // slices), ("dcn", "ici"),
                          device=device)

    measured = PlanCache()
    if "hierarchical" in ops:
        try:
            hcomm = world_of(args.slices)
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        print(f"sweeping flat-vs-hierarchical allreduce over "
              f"{args.slices} slices x {hcomm.size // args.slices} "
              f"ranks "
              f"({', '.join(f'{kb} KiB' for kb in args.sizes_kb)})")
        try:
            measured.merge(sweep_allreduce_hierarchical(
                hcomm, sizes_kb=args.sizes_kb, runs=args.runs,
                verbose=True,
            ))
        except ValueError as e:
            # e.g. --slices 1: the world builds but has no DCN tier
            print(f"error: {e}", file=sys.stderr)
            return 2
    for op, sweep, what in (
        ("alltoall", sweep_alltoall, "all_to_all candidates"),
        ("all_reduce", sweep_allreduce, "all_reduce"),
        ("quantized", sweep_allreduce_precision,
         "allreduce wire precisions"),
    ):
        if op not in ops:
            continue
        sliced = args.slices if op != "all_reduce" else None
        try:
            comm = world_of(sliced)
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        if comm.size < 2:
            # a 1-rank "sweep" would persist meaningless entries that
            # every later multi-rank call on this device kind consults
            print(f"error: the {op} sweep needs >= 2 ranks; pass "
                  f"--ranks 2 or more or drop {op} from --ops",
                  file=sys.stderr)
            return 2
        where = (f"{sliced} slices x {comm.size // sliced} ranks"
                 if sliced else f"{comm.size} ranks")
        print(f"sweeping {what} over {where} "
              f"({', '.join(f'{kb} KiB' for kb in args.sizes_kb)})")
        measured.merge(sweep(comm, sizes_kb=args.sizes_kb,
                             runs=args.runs, verbose=True))
    if "flash_fwd" in ops:
        print("sweeping flash_fwd forward tiles")
        print("  skipped: the port's flash kernels compile one tile pair "
              "a dtype and head dim (kernels/flash.py _plan), so there "
              "is no candidate to time")
    if "stencil" in ops:
        print("sweeping stencil pipeline candidates (depth x stripe x "
              "compute dtype; on the card every candidate is timed, on "
              "the CPU the proxy tier gates correctness and prices with "
              "the replay-adjusted model)")
        measured.merge(sweep_stencil(runs=args.runs, verbose=True,
                                     device=device))
    try:
        disk = PlanCache.load(path) if os.path.exists(path) else PlanCache()
    except PlanCacheError as e:
        print(f"error: existing cache at {path} is unusable: {e}",
              file=sys.stderr)
        return 1
    landed = sum(
        1 for sig, e in measured.entries.items()
        if e.better_than(disk.entries.get(sig))
    )
    disk.merge(measured)
    disk.save(path)
    print(f"{len(measured.entries)} plans measured, {landed} "
          f"new/improved -> {path}")
    # the running process should trace with what it just measured
    engine.set_engine(None)
    return 0


def _cmd_tune_online(args: argparse.Namespace) -> int:
    """``smi-tpu tune --online SINK.json``: offline replay of recorded
    live samples through the online tuner (:mod:`smi_tpu_torch.tuning.online`).

    The sink is a :class:`~smi_tpu_torch.obs.metrics.SampleSink` snapshot
    (``{"entries": [...]}``) or a bare entries list — the vocabulary
    ``tracing.timed(sink=)`` aggregates during a run. The tuner
    shadow-compares every qualified cell against the cost model's
    rival candidates and prints each propose/swap decision with its
    evidence and per-knob provenance. Read-only: nothing is written —
    the live path (``serve --selftest --retune`` / a retune-wired
    front-end) is where swaps land in a running job's cache.
    """
    from smi_tpu_torch.tuning import PlanCache, PlanCacheError
    from smi_tpu_torch.tuning import cost_model as cm
    from smi_tpu_torch.tuning.cache import default_cache_path
    from smi_tpu_torch.tuning.online import OnlineTuner

    if not os.path.exists(args.online):
        print(f"error: sample sink {args.online!r} not found",
              file=sys.stderr)
        return 2
    with open(args.online) as f:
        try:
            payload = json.load(f)
        except json.JSONDecodeError as e:
            print(f"error: sample sink {args.online!r} is not valid "
                  f"JSON: {e}", file=sys.stderr)
            return 1
    if args.slices and args.slices > 1:
        if args.ranks % args.slices:
            print(f"error: n={args.ranks} ranks do not split into "
                  f"{args.slices} slices", file=sys.stderr)
            return 2
        topo = cm.TopologySpec(n=args.ranks,
                               inner=args.ranks // args.slices,
                               outer=args.slices)
    else:
        topo = cm.TopologySpec(n=args.ranks)
    cache_path = args.cache or default_cache_path()
    if cache_path and os.path.exists(cache_path):
        try:
            cache = PlanCache.load(cache_path)
        except PlanCacheError as e:
            print(f"error: cache at {cache_path} is unusable: {e}",
                  file=sys.stderr)
            return 1
        print(f"active plans from {cache_path} "
              f"({len(cache.entries)} entries)")
    else:
        cache = PlanCache()
        print("no plan cache found: the tuner has no active entries "
              "to retune against (pass --cache, or sweep first)")
    tuner = OnlineTuner(
        cache=cache, topo=topo, dtype=args.dtype,
        device_kind=args.device_kind or "unknown",
    )
    try:
        n = tuner.ingest(payload)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    print(f"{n} samples across {len(tuner.cells)} cells ingested "
          f"(thresholds: min_samples={tuner.min_samples}, "
          f"margin={tuner.margin:g}x)")
    decisions = tuner.run_offline()
    for kind, info in decisions:
        if kind == "propose":
            print(
                f"propose {info['op']} bucket={info['bucket']} B"
                + (f" tenant={info['tenant']}" if info.get("tenant")
                   else "")
                + f": {info['from']} measured "
                f"{info['measured_us']:.1f} us over {info['samples']} "
                f"samples vs {info['to']} modeled "
                f"{info['rival_modeled_us']:.1f} us "
                f"({info['advantage']:g}x >= margin "
                f"{tuner.margin:g}x)"
            )
        else:
            print(
                f"swap {info['key']}: algorithm = "
                f"{info['algorithm']!r}  [live] (revision "
                f"{info['revision']}, plan epoch "
                f"{info['plan_epoch']}; {info['provenance']})"
            )
    if not decisions:
        print("no retune proposals: every active plan holds under "
              "the recorded samples")
    # cells a committed swap reset hold 0 samples — only genuinely
    # under-sampled cells are reported as held back
    held = sum(1 for c in tuner.cells.values()
               if 0 < c.count < tuner.min_samples)
    if held:
        print(f"{held} cell(s) below the {tuner.min_samples}-sample "
              f"threshold (noise can never flip a plan)")
    return 0


def cmd_bench(args: argparse.Namespace) -> int:
    """``bench NAME [flags]``: the port's microbenchmark CLI
    (``python -m smi_tpu_torch.benchmarks``; ``--cpu`` runs it on the
    CPU)."""
    from smi_tpu_torch.benchmarks.__main__ import main as bench_main

    return bench_main(args.rest)


def cmd_aot_verify(args: argparse.Namespace) -> int:
    """Build the CUDA sources and check the multi-chip surface's launches.

    The reference proves emulator-tested kernels against the real
    hardware toolchain without owning hardware (``aoc`` bitstream
    targets, ``CMakeLists.txt:159-196``); this is the H100 analog —
    ``nvcc`` builds every source for ``sm_90a``, and every launch the
    port makes for each case of the JAX package's surface is held to the
    card's limits from the ptxas figures, and on a card to the runtime's
    own occupancy (``parallel/aot.py``); the per-case reports land in a
    JSON evidence artifact. Without ``nvcc`` it fails, naming why.
    """
    import torch

    from smi_tpu_torch.kernels import _build
    from smi_tpu_torch.parallel import aot

    topos = args.topology or [
        aot.DEFAULT_TOPOLOGY, "v5e:4x4", f"{aot.DEFAULT_TOPOLOGY}*2",
    ]
    payload = {"torch": torch.__version__, "cuda": torch.version.cuda,
               "card": (torch.cuda.get_device_name(0)
                        if torch.cuda.is_available() else None),
               "topologies": {}}
    print(f"building {len(_build.SOURCES)} CUDA sources for sm_90a")
    try:
        waited = aot.build_sources()
    except (aot.NvccNotFound, RuntimeError) as e:
        print(f"error: {type(e).__name__}: {e}", file=sys.stderr)
        return 1
    resources = aot.source_resources()
    payload["sources"] = {
        name: {"built_s": waited.get(name), "instances": figs}
        for name, figs in resources.items()
    }
    rc = 0
    for topo in topos:
        print(f"checking the multi-chip surface's launches for {topo}")
        entry: dict = {"devices": None}
        try:
            entry["devices"] = aot.topology_ranks(topo)
            if aot.is_multislice(topo):
                entry["slice_partition"] = {
                    str(k): v for k, v in aot.slice_partition(topo).items()
                }
            reports = aot.check_surface(topo, verbose=True)
            entry.update(ok=True, programs=reports)
            print(f"  {len(reports)} programs fit [{topo}]")
        except Exception as e:
            entry.update(ok=False, error=f"{type(e).__name__}: {e}")
            print(f"FAILED [{topo}]: {type(e).__name__}: {e}",
                  file=sys.stderr)
            rc = 1
        payload["topologies"][topo] = entry
    payload["topology"] = topos[0]
    payload["ok"] = all(
        e.get("ok") for e in payload["topologies"].values()
    )
    if payload["ok"]:
        print(f"all topologies ok -> {args.out}")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(payload, f, indent=2)
        f.write("\n")
    return rc


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m smi_tpu_torch",
        description="smi_tpu_torch build-time toolchain (codegen/main.py "
                    "parity)",
    )
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser(
        "manifest",
        help="scan user sources for channel ops; write program JSON",
    )
    p.add_argument("sources", nargs="+", help="user source files to scan")
    p.add_argument("-o", "--output", help="program JSON path (default stdout)")
    p.add_argument("--consecutive-read-limit", type=int, default=8)
    p.add_argument("--max-ranks", type=int, default=8)
    p.add_argument("--no-rendezvous", action="store_true",
                   help="compile P2P channels for the eager protocol")
    p.add_argument("--no-validate", action="store_true",
                   help="skip port-conflict validation")
    p.set_defaults(fn=cmd_manifest)

    p = sub.add_parser(
        "route", help="write binary routing tables + hostfile, or "
                      "--check a topology/hostfile without writing"
    )
    p.add_argument("topology", help="topology JSON (connections + programs)")
    p.add_argument("dest_dir", nargs="?", default=None,
                   help="output directory for tables + hostfile "
                        "(optional with --check)")
    p.add_argument("metadata", nargs="*",
                   help="program metadata JSON files (basename = name)")
    p.add_argument("--check", action="store_true",
                   help="validate only: all device pairs routable "
                        "(around any --down failures; exit nonzero on an "
                        "unroutable cut, naming it) and the --hostfile "
                        "strictly valid — a fail-fast for launch scripts "
                        "before they grab a pod")
    p.add_argument("--down", action="append", default=[],
                   metavar="NODE:DEV[:chN]",
                   help="with --check: treat this wire endpoint (or whole "
                        "device, without :chN) as failed; repeatable")
    p.add_argument("--hostfile", default=None,
                   help="with --check: hostfile to validate against the "
                        "topology's rank order")
    p.add_argument("--slices", type=int, default=None, metavar="N",
                   help="with --check: validate the topology as an "
                        "N-slice pod — every cross-slice leader pair "
                        "must be reachable (around --down failures) "
                        "and every slice's loss must leave a flat-ring "
                        "fallback over the survivors, naming the slice "
                        "that doesn't")
    p.add_argument("--lint", action="store_true",
                   help="with --check: after reachability, run the "
                        "static protocol verifier on the protocols the "
                        "plan engine would select for this topology "
                        "(the base rings + chunked pipeline; the pod "
                        "protocol too with --slices) — a misconfigured "
                        "pod fails at check time, not trace time")
    p.set_defaults(fn=cmd_route)

    p = sub.add_parser(
        "host", help="emit the host bootstrap module (codegen-host analog)"
    )
    p.add_argument("host_src", help="path of the generated Python module")
    p.add_argument("metadata", nargs="+",
                   help="program metadata JSON files (basename = name)")
    p.set_defaults(fn=cmd_host)

    p = sub.add_parser(
        "device",
        help="emit the monomorphized device module (codegen-device analog)",
    )
    p.add_argument("device_src", help="path of the generated Python module")
    p.add_argument("metadata", help="program metadata JSON (basename = name)")
    p.set_defaults(fn=cmd_device)

    p = sub.add_parser(
        "topology", help="generate a bus-topology JSON for testing"
    )
    p.add_argument("-n", type=int, required=True, help="number of devices")
    p.add_argument("-p", dest="programs", nargs="+", required=True,
                   help="program names to assign round-robin")
    p.add_argument("-f", dest="file", required=True, help="output file")
    p.add_argument("--ring", action="store_true",
                   help="close the bus into a ring")
    p.set_defaults(fn=cmd_topology)

    p = sub.add_parser(
        "build",
        help="manifest + route + host in one call (smi_target parity)",
    )
    p.add_argument("topology", help="topology JSON")
    p.add_argument("sources", nargs="+", help="user source files")
    p.add_argument("-o", "--out-dir", required=True)
    p.add_argument("--name", default=None,
                   help="program name (default: first source's basename)")
    p.add_argument("--consecutive-read-limit", type=int, default=8)
    p.add_argument("--max-ranks", type=int, default=8)
    p.add_argument("--no-rendezvous", action="store_true")
    p.add_argument("--report", action="store_true",
                   help="run each manifest op once on a world of "
                        "--max-ranks rank threads and emit report.json "
                        "(the aoc -rtl -report stage): the kernels each "
                        "launches, its bytes, registers and shared "
                        "memory, and a predicted time at the card's "
                        "memory rate")
    p.add_argument("--report-topology", default=None, metavar="NAME",
                   help="run the report on a world of this topology's "
                        "rank count (e.g. v5e:2x4: 8 ranks) instead of "
                        "--max-ranks")
    p.add_argument("--cpu", action="store_true",
                   help="run the --report world on the CPU (default: the "
                        "card)")
    p.set_defaults(fn=cmd_build)

    p = sub.add_parser(
        "aot-verify",
        help="build every CUDA source for sm_90a and check the "
             "multi-chip surface's launches against the card's limits",
    )
    # nargs='+': a bare `--topology` (e.g. an empty shell variable) is
    # a parse error, not a silent fall-through to the 3-topology sweep
    p.add_argument("--topology", nargs="+", default=None,
                   help="topology names of the JAX surface, read as "
                        "their rank counts; a '*2' suffix asks for 2 "
                        "slices (default: v5e:2x4, v5e:4x4, and "
                        "v5e:2x4*2)")
    p.add_argument("-o", "--out", default=os.path.join("build", "aot",
                                                       "AOT_H100.json"),
                   help="evidence JSON path")
    p.set_defaults(fn=cmd_aot_verify)

    p = sub.add_parser(
        "chaos",
        help="seeded randomized fault campaign over the ring protocols "
             "(self-healing soak; nonzero exit + minimal reproducer on "
             "any unhealed cell)",
    )
    p.add_argument("--seed", type=int, default=0,
                   help="campaign seed; the whole report is "
                        "deterministic per seed (default 0)")
    p.add_argument("--protocols", nargs="+", default=None,
                   metavar="PROTO",
                   help="protocols to sweep (default: all four ring "
                        "protocols)")
    p.add_argument("--ranks", nargs="+", type=int, default=None,
                   metavar="N",
                   help="ring sizes to sweep (default 2 3 4 5; not "
                        "applicable to --load)")
    p.add_argument("--trials", type=int, default=3,
                   help="random plans per (protocol, n) cell")
    p.add_argument("--max-faults", type=int, default=None,
                   help="faults per random plan (1..N drawn; default "
                        "2; not applicable to --elastic/--load)")
    p.add_argument("--elastic", action="store_true",
                   help="run the elastic runtime soak instead: seeded "
                        "kill→detect→shrink→checkpoint-restore→regrow "
                        "cells over a sharded Jacobi job, gated on "
                        "zero silent corruption and zero stale-epoch "
                        "leaks (--ranks/--trials apply; --protocols "
                        "does not)")
    p.add_argument("--load", action="store_true",
                   help="run the chaos-under-load campaign instead: "
                        "open-loop multi-tenant traffic through the "
                        "serving front-end with overload, "
                        "kill-one-rank, and consumer-stall cells, "
                        "gated on zero silent corruption, zero "
                        "lost-accepted requests, zero stale-epoch "
                        "leaks, bounded queues, and "
                        "lowest-class-first shedding (--trials "
                        "applies; --protocols/--ranks/--max-faults "
                        "do not)")
    p.add_argument("--moe", action="store_true",
                   help="run the MoE expert-dispatch campaign "
                        "instead: seeded token batches scatter to "
                        "experts and gather back through the serving "
                        "front-end — a uniform-routing cell plus a "
                        "hot-expert cell (one expert at 8x routing "
                        "weight) per trial, gated on bit-identical "
                        "batch reassembly, zero lost-accepted, "
                        "lowest-class-first shedding, and the hot "
                        "rank surfacing as named backpressure "
                        "(--trials/-n/--duration apply; "
                        "--protocols/--ranks/--max-faults do not)")
    p.add_argument("--partition", action="store_true",
                   help="run the partition-tolerance campaign "
                        "instead: a clean symmetric cut/heal A/B "
                        "(minority parks loudly, majority fails over "
                        "fenced, heal delivery bit-identical to the "
                        "no-partition control), an asymmetric cut "
                        "during a live migration (loud loss-free "
                        "abort), and a flapping-link soak (no "
                        "membership oscillation) per trial "
                        "(--trials/-n/--duration apply; "
                        "--protocols/--ranks/--max-faults do not)")
    p.add_argument("--infer", action="store_true",
                   help="run the streaming-inference campaign "
                        "instead: disaggregated prefill/decode "
                        "serving under chaos — the no-fault smoke, "
                        "kill-decode-mid-generation (exactly one "
                        "committed KV handoff naming the dead rank, "
                        "delivery bit-identical to the no-fault "
                        "control, zero lost accepted tokens), "
                        "kill-prefill (stateless WAL replay, zero "
                        "handoffs), saturate-decode (blame-triggered "
                        "handoff, never a membership event), "
                        "partition-during-handoff (loud fenced "
                        "abort), and the scale-in victim discipline "
                        "per trial (--trials/-n/--duration apply; "
                        "--protocols/--ranks/--max-faults do not)")
    p.add_argument("--kill-decode", action="store_true",
                   dest="kill_decode",
                   help="with --infer: run only the "
                        "kill-decode-mid-generation cell (the "
                        "stateful KV-shard handoff path)")
    p.add_argument("--kill-prefill", action="store_true",
                   dest="kill_prefill",
                   help="with --infer: run only the kill-prefill "
                        "cell (the stateless WAL-replay path)")
    p.add_argument("--saturate", action="store_true",
                   help="with --infer: run only the saturate-decode "
                        "cell (the blame-triggered handoff; "
                        "saturation is not death)")
    p.add_argument("--asymmetric", action="store_true",
                   help="with --partition: run only the "
                        "asymmetric-cut-during-migration cell (the "
                        "one-way link loss only round-trip lease "
                        "evidence can see)")
    p.add_argument("--flap", action="store_true",
                   help="with --partition: run only the "
                        "flapping-link soak (suspect/clear "
                        "hysteresis, zero membership transitions)")
    p.add_argument("--metrics", action="store_true",
                   help="with --load: print each cell's metrics "
                        "summary (admitted/shed/delivered counters + "
                        "event counts) next to its verdict; the full "
                        "deterministic snapshot always rides the "
                        "JSON report")
    p.add_argument("--retune", action="store_true",
                   help="with --load: add the seeded payload-shift "
                        "retune cell per trial — the online tuner "
                        "must hot-swap to the plan the offline sweep "
                        "picks for the shifted distribution, with "
                        "bit-identical delivery, zero lost-accepted, "
                        "and zero stale-plan leaks (--load only)")
    p.add_argument("--flash-crowd", action="store_true",
                   dest="flash_crowd",
                   help="with --load: add the seeded flash-crowd "
                        "demand-elasticity cell per trial — one "
                        "tenant 10x's its rate mid-run and capacity "
                        "must FOLLOW the load: scale-out under the "
                        "crowd, a blame-driven live migration when "
                        "the tail convicts the hot rank, scale-in "
                        "after it drains, loss-free throughout "
                        "(--load only)")
    p.add_argument("--duration", type=int, default=None, metavar="TICKS",
                   help="ticks of open-loop traffic per --load/--moe/"
                        "--infer cell (defaults 240/120/200; "
                        "--load/--moe/--partition/--infer only)")
    p.add_argument("-n", "--n", type=int, default=None, dest="n_ranks",
                   help="serving ranks for --load/--moe/--infer "
                        "cells (default 4; "
                        "--load/--moe/--partition/--infer only)")
    p.add_argument("-o", "--out", default=None,
                   help="write the JSON campaign report here")
    p.set_defaults(fn=cmd_chaos)

    p = sub.add_parser(
        "serve",
        help="the multi-tenant streaming front-end; --selftest runs "
             "the deterministic CPU admit→stream→shed→drain smoke "
             "(nonzero exit on any serving gate failure)",
    )
    p.add_argument("--selftest", action="store_true",
                   help="run the deterministic serving smoke and exit "
                        "nonzero on any gate failure")
    p.add_argument("--retune", action="store_true",
                   help="with --selftest: run the seeded payload-shift "
                        "retune cell instead — the front-end serves "
                        "with the online tuner wired "
                        "(ServingFrontend(retune=)) and must hot-swap "
                        "to the offline-sweep pick with bit-identical "
                        "delivery")
    p.add_argument("--autoscale", action="store_true",
                   help="with --selftest: run the seeded flash-crowd "
                        "cell instead — the elasticity controller "
                        "must scale out under the crowd, migrate the "
                        "hot tenant off its convicted rank, and "
                        "scale back in after the drain, loss-free")
    p.add_argument("--partition", action="store_true",
                   help="with --selftest: run the seeded clean "
                        "partition/heal cell instead — the minority "
                        "parks and refuses loudly, the quorate "
                        "majority fails over fenced, the heal "
                        "rejoins, and delivery is bit-identical to "
                        "the no-partition control")
    p.add_argument("--infer", action="store_true",
                   help="with --selftest: run the seeded "
                        "kill-decode-mid-generation inference cell "
                        "instead — prefill, KV transport, generate, "
                        "kill, fail over through exactly one "
                        "committed KV-shard handoff, and deliver "
                        "bit-identically to the no-fault control "
                        "with zero lost accepted tokens")
    p.add_argument("--seed", type=int, default=0,
                   help="selftest seed (default 0; the report is "
                        "deterministic per seed)")
    p.add_argument("--json", action="store_true",
                   help="print the full cell report as JSON")
    p.add_argument("--metrics", action="store_true",
                   help="print only the deterministic metrics "
                        "snapshot + event accounting as JSON (the "
                        "scriptable surface; the full --json report "
                        "carries it too)")
    p.add_argument("-o", "--out", default=None,
                   help="write the JSON report here")
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser(
        "trace",
        help="export Perfetto/Chrome traces of registered protocols "
             "from the timestamped simulator (per-rank tracks, spans "
             "attributed alpha/beta/serialization/idle, span sums "
             "bit-identical to elapsed_seconds())",
    )
    p.add_argument("--protocol", action="append", default=None,
                   dest="protocols", metavar="NAME",
                   help="protocol to trace over its DEFAULT_SHAPES "
                        "grid (repeatable); exclusive with --all")
    p.add_argument("--all", action="store_true",
                   help="trace every registered protocol")
    p.add_argument("--serve", action="store_true",
                   help="export a seeded serve --selftest run "
                        "instead: per-tenant track groups, one "
                        "thread per request, spans from the r15 "
                        "span builder (components + annotations); "
                        "exclusive with --protocol/--all/"
                        "--payload-kb")
    p.add_argument("--seed", type=int, default=0,
                   help="schedule seed (default 0; same seed -> "
                        "byte-identical trace files)")
    p.add_argument("--payload-kb", type=int, default=None,
                   metavar="KB",
                   help="total collective payload per instance "
                        "(default 4096 KiB, the perf tier's "
                        "PERF_PAYLOAD_BYTES)")
    p.add_argument("-o", "--out", default=None, metavar="DIR",
                   help="write one <protocol>_<shape>.trace.json per "
                        "instance here (default: one combined JSON "
                        "document on stdout)")
    p.set_defaults(fn=cmd_trace)

    p = sub.add_parser(
        "health",
        help="render span / SLO / blame state from a recorded "
             "serving run (serve --selftest -o / chaos --load -o "
             "report JSON) or a fresh seeded selftest: per-class "
             "burn rates and breaches, the tail-latency blame "
             "verdict, and the span digest",
    )
    p.add_argument("report", nargs="?", default=None,
                   help="recorded report JSON to render (exclusive "
                        "with --selftest)")
    p.add_argument("--selftest", action="store_true",
                   help="run the seeded serving selftest and render "
                        "its health state instead of reading a file")
    p.add_argument("--seed", type=int, default=None,
                   help="with --selftest: the selftest seed "
                        "(default 0); a usage error with a recorded "
                        "report, which carries its own seed")
    p.add_argument("--json", action="store_true",
                   help="print the extracted health/blame/span "
                        "state as JSON instead of text")
    p.set_defaults(fn=cmd_health)

    p = sub.add_parser(
        "traffic",
        help="analyze an HLO text dump: per-collective payloads, or "
             "--overlap for the statically-verified comm/compute "
             "overlap report",
    )
    p.add_argument("hlo", help="path to an HLO text dump "
                               "(compiled.as_text())")
    p.add_argument("--overlap", action="store_true",
                   help="report compute schedulable (sync modules) or "
                        "scheduled (async pairs) during the "
                        "collectives instead of payload records")
    p.add_argument("--lint", action="store_true",
                   help="lint the artifact instead: flag sync "
                        "collectives gating all compute, collectives "
                        "inside loop bodies, and P2P channels missing "
                        "verified-transport framing; exit nonzero on "
                        "any finding")
    p.add_argument("--require-overlap", action="store_true",
                   help="exit nonzero when the report finds no "
                        "overlap (with --overlap) or no collectives — "
                        "a CI gate on build artifacts")
    p.add_argument("-o", "--out", default=None,
                   help="write the full JSON report here")
    p.set_defaults(fn=cmd_traffic)

    p = sub.add_parser(
        "lint",
        help="static protocol verifier: prove deadlock-freedom, "
             "slot-race-freedom, credit conservation, and wire-lane "
             "monotonicity over the whole schedule space of every "
             "registered protocol (pure Python, no devices); exit "
             "nonzero on any finding",
    )
    p.add_argument("--protocol", action="append", default=None,
                   metavar="NAME",
                   help="verify only this protocol (repeatable; "
                        "default: every registered protocol — the "
                        "four base rings, the chunked pipeline, the "
                        "two-tier pod)")
    p.add_argument("--all", action="store_true",
                   help="verify every registered protocol (the "
                        "default when no --protocol is given)")
    p.add_argument("--mutant", default=None, metavar="NAME",
                   help="apply a deliberately broken variant before "
                        "verifying (dropped_wait, reused_slot, "
                        "unbalanced_grant, late_grant; with --model: "
                        "leaked_stream_credit, skipped_aging, "
                        "epoch_bump_without_void, "
                        "heartbeat_after_confirm) — demonstrates "
                        "the nonzero exit and the named diagnostics; "
                        "needs --protocol (or --model)")
    p.add_argument("--model", action="store_true",
                   help="run the control-plane model checker instead: "
                        "exhaustive BFS over every reachable state of "
                        "each small scope, driving the real admission/"
                        "scheduling/membership/WAL objects, checking "
                        "queue bounds, stream-credit conservation, "
                        "starvation-freedom, epoch safety, and "
                        "no-lost-accepted; findings carry minimal "
                        "counterexample traces replayable as failing "
                        "campaign cells")
    p.add_argument("--scope", default=None, metavar="SPEC",
                   help="with --model: check one scope instead of the "
                        "default grid, e.g. "
                        "'tenants=2,ranks=2,chunks=2,kill=1' "
                        "(keys: tenants/ranks/chunks/streams/pool/"
                        "kill/silence/consume/starve)")
    p.add_argument("--perf", action="store_true",
                   help="run the static performance analyzer instead: "
                        "decompose every registered protocol's "
                        "simulated makespan into alpha/beta/"
                        "serialization/idle per rank and wire tier "
                        "(naming the binding wait edge), plus the "
                        "kernel roofline lint (VMEM double-buffer "
                        "bound, tile roofline fraction, analytic "
                        "drift vs committed expectations); perf "
                        "mutants: halved_wire_credits, "
                        "unoverlapped_chunks, oversized_flash_tile")
    p.add_argument("--hlo", default=None, metavar="DUMP",
                   help="with --perf or --combined: also lint this "
                        "HLO text dump for serialized dependent DMA "
                        "chains (async pairs moving with zero "
                        "scheduled compute)")
    p.add_argument("--combined", action="store_true",
                   help="run protocol + model + perf tiers in one "
                        "invocation at their full default grids; "
                        "merged JSON report with per-tier sections, "
                        "single exit code")
    p.add_argument("--json", action="store_true",
                   help="print the JSON report instead of text")
    p.add_argument("-o", "--out", default=None,
                   help="also write the JSON report here")
    p.set_defaults(fn=cmd_lint)

    p = sub.add_parser(
        "tune",
        help="sweep candidate plans and write the persistent plan "
             "cache; --explain OP prints the candidate table with the "
             "deciding layer (cache / model / heuristic) per knob",
    )
    p.add_argument("--explain", default=None, metavar="OP",
                   help="print the plan decision table for OP "
                        "(all_reduce, all_to_all, flash_fwd, "
                        "stencil, stencil_temporal, ring_all_reduce) "
                        "instead of sweeping — CPU-deterministic, no "
                        "hardware needed; an online-won entry renders "
                        "as [live] naming its sample count and margin")
    p.add_argument("--online", default=None, metavar="SINK_JSON",
                   help="replay a recorded SampleSink JSON (the "
                        "tracing.timed(sink=) aggregate) through the "
                        "online tuner offline and print each "
                        "propose/swap decision with its evidence and "
                        "per-knob provenance — read-only, "
                        "CPU-deterministic; --cache names the active "
                        "plans to retune against")
    p.add_argument("--device-kind", default=None, metavar="KIND",
                   help="with --online: the device kind the recorded "
                        "samples were measured on (keys the plan "
                        "lookups; default 'unknown')")
    p.add_argument("--ops", nargs="+", default=None, metavar="OP",
                   help="ops to sweep (default: all_reduce; flash_fwd "
                        "has no candidate in the port, whose kernels "
                        "compile one tile pair a dtype and head dim; "
                        "hierarchical sweeps "
                        "flat-vs-two-tier over --slices N virtual "
                        "slices and persists the measured crossover; "
                        "alltoall times pairwise vs Bruck vs "
                        "hierarchical per payload bucket; stencil "
                        "sweeps the r18 double-buffered pipeline "
                        "depth x stripe x compute-dtype grid; "
                        "quantized times the allreduce wire "
                        "precisions f32/bf16/int8/topk per payload "
                        "bucket and persists the measured dense/lossy "
                        "crossover)")
    p.add_argument("--slices", type=int, default=None, metavar="N",
                   help="pod slice count: with --explain, price the "
                        "all_reduce/all_to_all tables for an N-slice "
                        "pod (all three candidates); with --ops "
                        "hierarchical/alltoall/quantized, the shape "
                        "the sweep tiers over")
    p.add_argument("--cache", default=None,
                   help="plan-cache JSON path (default: "
                        "$SMI_TPU_PLAN_CACHE or "
                        "~/.cache/smi_tpu/plans.json)")
    p.add_argument("--sizes-kb", nargs="+", type=int,
                   default=[64, 256, 1024, 4096], metavar="KB",
                   help="allreduce payload sweep grid")
    p.add_argument("--runs", type=int, default=5,
                   help="timed repetitions per candidate")
    p.add_argument("--ranks", type=int, default=8,
                   help="with --explain: rank count the collective "
                        "table models; with --ops: the ranks (threads "
                        "of one world) the sweeps time")
    p.add_argument("--dtype", default="float32",
                   help="with --explain: payload dtype of the table")
    p.add_argument("--cpu", action="store_true",
                   help="run the sweeps' world on the CPU (default: the "
                        "card)")
    p.set_defaults(fn=cmd_tune)

    p = sub.add_parser("bench", help="run a microbenchmark")
    p.add_argument("rest", nargs=argparse.REMAINDER)
    p.set_defaults(fn=cmd_bench)

    return parser


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
