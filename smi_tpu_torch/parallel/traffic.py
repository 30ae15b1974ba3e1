"""Collective-traffic analysis of XLA HLO text.

PyTorch counterpart of :mod:`smi_tpu.parallel.traffic`, the text parser
carried whole. It reads HLO text a user hands it — the optimised module
of a JAX program (``compiled.as_text()``, saved by an AOT run or a
``jax.jit(...).lower(x).compile().as_text()``) — and analyses no program
of the port's own: the port issues no XLA collective, so its programs
have no HLO (its kernels' launches are checked by
:mod:`smi_tpu_torch.parallel.aot` and tabulated by
:mod:`smi_tpu_torch.utils.report` instead). ``compiled=`` accepts any
object with ``as_text()``; the module imports only ``re``.

Reference parity: the reference's offline report workflow — ``aoc``
emits per-build area/Fmax reports that are read *before* committing
hardware time (the reference's ``CMakeLists.txt:113-118``, the
``-rtl -report`` stage). The optimised HLO of an AOT-compiled program
names every XLA collective with its shape and replica groups, from which
per-tier traffic is exact.

:func:`collective_traffic` parses the text into a list of collective
records; :func:`tier_crossing_bytes` folds them into per-device bytes
that cross a given device partition (e.g. the slice boundary of a hybrid
mesh). :func:`overlap_report` verifies comm/compute overlap and
:func:`traffic_lint` lints collective usage.

Scope caveat: records are per HLO *occurrence*, not per execution — a
collective inside a ``while``/``fori_loop`` body prints once but runs
trip-count times, so volume comparisons must use loop-free programs or
scale by the known trip count themselves. The parser marks such records
``in_loop: True`` (:func:`_scan_computations`).

The predicted-time helpers (:func:`predicted_us`,
:func:`predicted_program_us`) price the parsed TPU collectives at the
v5e ICI link rate, as the JAX package does; they describe the TPU
program the text came from, never a run of the port.
:func:`ring_traffic` implements the per-hop formulas of the four ring
protocols.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence, Set, Tuple

#: HLO dtype -> bytes per element (the dtypes the framework emits)
_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "f16": 2,
    "bf16": 2, "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8,
    "f64": 8,
}

_COLLECTIVES = (
    "all-reduce", "all-gather", "reduce-scatter", "collective-permute",
    "all-to-all",
)

#: one HLO instruction line: ``%name = f32[8,128]{...} all-reduce(...)``
#: the ``type`` group spans the whole result type — possibly a tuple
#: for async ``-start`` forms, whose LAST element is the result shape
#: (the leading elements alias operands)
_INSTR_RE = re.compile(
    r"%?(?P<name>[\w.\-]+)\s*=\s*"
    r"(?P<type>[^=]+?)\s(?P<op>" + "|".join(_COLLECTIVES)
    + r")(?:-start|-done)?\("
)
_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")
_GROUPS_RE = re.compile(r"replica_groups=\{(\{[\d,{}]*\})\}")
_PAIRS_RE = re.compile(r"source_target_pairs=\{(\{[\d,{}]*\})\}")

#: megascale DCN egress: on a GENUINE multi-slice topology XLA compiles
#: one ``num_partitions=n_per_slice`` module per slice and lowers the
#: cross-slice stage of a collective to host-transfer ``send``/``recv``
#: pairs handled by the megascale runtime (frontend attribute
#: ``_xla_host_transfer_handler_name="xla_megascale_runtime"``) — the
#: slice-crossing payload never appears in any replica group, so the
#: parser must book the send's tuple payload instead
_SEND_RE = re.compile(
    r"%?(?P<name>[\w.\-]+)\s*=\s*(?P<type>[^=]+?)\ssend\("
)


def _parse_groups(text: str) -> List[List[int]]:
    """``{{0,1},{2,3}}`` (inner part) -> [[0,1],[2,3]]."""
    return [
        [int(x) for x in grp.split(",") if x]
        for grp in re.findall(r"\{([\d,]*)\}", text)
    ]


def _elems(shape: str) -> int:
    """``"2,1,128"`` -> 256 (empty shape = scalar = 1)."""
    n = 1
    for dim in shape.split(","):
        if dim:
            n *= int(dim)
    return n


#: computation header: ``%name (params) -> type {`` or ``ENTRY %name ...{``.
#: Params may nest parens (tuple-typed while carries), so the regex
#: stops at the opening paren — headers are the only lines whose name
#: is followed by ``(`` with no ``=`` (instructions are ``%name = ...``),
#: and the caller additionally requires the line to end with ``{``.
_COMP_RE = re.compile(r"^\s*(?:ENTRY\s+)?%?([\w.\-]+)\s*\(")
#: computation references on an instruction line
_CALLED_RE = re.compile(r"(?:body|condition|to_apply|calls)=%?([\w.\-]+)")
_BRANCHES_RE = re.compile(r"branch_computations=\{([^}]*)\}")


def _scan_computations(
    lines: Sequence[str],
) -> Tuple[Set[str], List[Optional[str]]]:
    """One pass over pre-split HLO lines: ``(loop_comps, comp_of_line)``.

    ``loop_comps`` — computation names reachable from any ``while``
    instruction's body/condition (regions whose instructions execute
    trip-count times per run, not once per HLO occurrence).
    ``comp_of_line[i]`` — the computation containing line ``i``, so the
    instruction parser shares this scan instead of re-matching headers
    over the multi-MB text."""
    refs: Dict[str, Set[str]] = {}
    roots: List[str] = []
    cur: Optional[str] = None
    comp_of_line: List[Optional[str]] = []
    for line in lines:
        mc = _COMP_RE.match(line)
        if mc and line.rstrip().endswith("{"):
            cur = mc.group(1)
            refs.setdefault(cur, set())
        elif line.strip() == "}":
            # a computation's closing brace ends its scope. Without
            # this reset, a header the regex cannot match (some print
            # options drop the parameter list) leaves ``cur`` pointing
            # at the PREVIOUS computation — e.g. a while body — and
            # every later instruction inherits a false ``in_loop``.
            # (Inline braces — constants, replica groups — never put a
            # lone ``}`` on its own line.)
            cur = None
        else:
            called = _CALLED_RE.findall(line)
            mb = _BRANCHES_RE.search(line)
            if mb:
                called += [
                    c.strip().lstrip("%")
                    for c in mb.group(1).split(",") if c.strip()
                ]
            if cur is not None:
                refs[cur].update(called)
            # while-roots are collected even in unrecognized scope —
            # a while whose enclosing header the regex missed still
            # makes its body's collectives per-iteration records
            if re.search(r"\swhile\(", line):
                roots.extend(called)
        comp_of_line.append(cur)
    reachable: Set[str] = set()
    stack = roots
    while stack:
        c = stack.pop()
        if c in reachable:
            continue
        reachable.add(c)
        stack.extend(refs.get(c, ()))
    return reachable, comp_of_line


def collective_traffic(compiled, hlo_text: Optional[str] = None) -> List[dict]:
    """Every XLA collective of a compiled executable, with exact bytes.

    Returns one record per collective instruction: ``op``, ``dtype``,
    element count and payload ``bytes`` (per participating device's
    operand), and the ``groups`` (replica groups, or source->target
    pairs for collective-permute). ``-start``/``-done`` async halves are
    deduplicated by instruction name. ``hlo_text`` lets a caller that
    already rendered ``compiled.as_text()`` (a multi-MB string for
    large programs) avoid a second render.

    A record whose instruction lives inside a ``while`` body (directly
    or through nested calls) carries ``in_loop: True`` — its bytes are
    per HLO occurrence, an under-count by the loop trip count, so
    volume columns must either exclude it or scale it themselves.
    """
    records = []
    seen: Set[Tuple[str, str]] = set()
    if hlo_text is None:
        hlo_text = compiled.as_text()
    lines = hlo_text.splitlines()
    loop_comps, comp_of_line = _scan_computations(lines)
    for lineno, line in enumerate(lines):
        cur_comp = comp_of_line[lineno]
        m = _INSTR_RE.search(line)
        if not m:
            ms = _SEND_RE.search(line)
            if (
                ms
                and "is_host_transfer=true" in line
                and "_xla_megascale" in line
            ):
                # DCN egress of a multi-slice collective: payload is
                # the largest array of the (data, u32[], token[]) tuple
                shapes = [
                    (dt, _elems(sh), _elems(sh) * _DTYPE_BYTES[dt])
                    for dt, sh in _SHAPE_RE.findall(ms.group("type"))
                    if dt in _DTYPE_BYTES
                ]
                if shapes:
                    dt, el, by = max(shapes, key=lambda t: t[2])
                    rec = {
                        "op": "megascale-send", "name": ms.group("name"),
                        "dtype": dt, "elements": el, "bytes": by,
                        "megascale": True, "computation": cur_comp,
                    }
                    if cur_comp in loop_comps:
                        rec["in_loop"] = True
                    records.append(rec)
            continue
        name = m.group("name")
        # async halves share a base name and describe ONE collective;
        # sync instructions are keyed by their full (unique) name so a
        # sync 'all-gather.3' never collides with an async pair whose
        # base normalizes to the same string
        if re.search(r"-(start|done)(\.|$)", name):
            key = ("async", re.sub(r"-(start|done)(\.|$)", r"\2", name))
        else:
            key = ("sync", name)
        if key in seen:
            continue
        base = key[1]
        # Payload bytes from a possibly-tuple result type. Two tuple
        # flavors exist and need opposite rules:
        # - async ``-start`` tuples are (operand aliases..., result,
        #   u32[] contexts...): the payload is the LARGEST array
        #   (picking "last" once recorded a 4 MB permute as its 4-byte
        #   context scalar; picking "first" understates an all-gather
        #   by its operand/result ratio);
        # - a SYNC tuple is a fused collective (XLA combines gradient
        #   psums into one all-reduce over many tensors): the payload
        #   is the SUM of the arrays (the max rule recorded a fused
        #   3-tensor psum as its largest member).
        shapes = [
            (dtype, _elems(shape), _elems(shape) * _DTYPE_BYTES[dtype])
            for dtype, shape in _SHAPE_RE.findall(m.group("type"))
            if dtype in _DTYPE_BYTES
        ]
        if not shapes:
            # token-typed line carries no payload shape; leave the key
            # unseen so the paired half (e.g. the -done) can record it
            continue
        seen.add(key)
        # an all-reduce's (sync or -start) tuple holds only results —
        # XLA fuses several reduced tensors into one op — so SUM them;
        # other async -start tuples are POSITIONALLY (operand
        # aliases..., results..., u32[] context scalars...): drop the
        # context scalars and sum the second half — the results. The
        # split is by position, not size: a reduce-scatter-start's
        # result is SMALLER than its operand (1/n), so "take the
        # largest array" overbooked it n-fold, and booked a fused pair
        # of gathers as one. ("Take the last" once recorded a 4 MB
        # permute as its 4-byte context scalar.) Bytes are summed
        # directly per-array so mixed-dtype fusions don't truncate
        # through one dtype's width; ``dtype`` reports the largest
        # member's, ``elements`` the summed element count.
        if key[0] == "async" and m.group("op") != "all-reduce":
            arrays = [
                s for s in shapes
                if not (s[0] in ("u32", "s32") and s[1] == 1)
            ] or shapes
            selected = arrays[(len(arrays) + 1) // 2:] or arrays
        else:
            selected = shapes
        rec = {
            "op": m.group("op"),
            "name": base,
            "dtype": max(selected, key=lambda t: t[2])[0],
            "elements": sum(e for _, e, _ in selected),
            "bytes": sum(b for _, _, b in selected),
            "computation": cur_comp,
        }
        if cur_comp in loop_comps:
            rec["in_loop"] = True
        g = _GROUPS_RE.search(line)
        if g:
            rec["groups"] = _parse_groups(g.group(1))
        p = _PAIRS_RE.search(line)
        if p:
            rec["pairs"] = _parse_groups(p.group(1))
        records.append(rec)
    return records


def has_collectives(hlo_text: str) -> bool:
    """Does the HLO text name any collective instruction?

    The companion check for :func:`collective_traffic`, kept next to
    the parser so the two rule sets stay in sync: text for which this
    is true but ``collective_traffic`` returns zero records is a
    parser miss (e.g. a print-option variant), not a collective-free
    program.

    Megascale host-transfer ``send`` instructions count too: on a
    genuine multi-slice artifact the cross-slice stage of a collective
    lowers to host-transfer sends handled by the megascale runtime
    (see ``_SEND_RE``), so a line carrying `` send(`` with
    ``is_host_transfer=true`` and a megascale marker is collective
    traffic even when no classic collective op appears — and a
    megascale-send parser regression is then flagged exactly like a
    collective-parser miss instead of reading as a collective-free
    program. The marker here is the bare string ``"xla_megascale"``,
    deliberately LOOSER than the parser's ``_xla_megascale`` attribute
    key: it also matches the handler-name value
    (``...handler_name="xla_megascale_runtime"``), so a renamed
    attribute escapes the parser but still trips this check. Host
    *callbacks* (``jax.debug.print`` / ``io_callback``) also lower to
    host-transfer sends but carry no megascale marker — they must NOT
    count, or every collective-free program with a debug print would
    book a spurious parser-miss error.
    """
    if any(
        f"{op}(" in hlo_text or f"{op}-start(" in hlo_text
        for op in _COLLECTIVES
    ):
        return True
    return any(
        " send(" in line and "is_host_transfer=true" in line
        and "xla_megascale" in line
        for line in hlo_text.splitlines()
    )


# ---------------------------------------------------------------------------
# Comm/compute overlap verification
# ---------------------------------------------------------------------------

#: one generic instruction definition: ``%name = <type> opcode(...``
_DEF_RE = re.compile(
    r"^\s*(?:ROOT\s+)?%?(?P<name>[\w.\-]+)\s*=\s*"
    r"(?P<type>[^=]+?)\s(?P<op>[\w\-]+)\("
)
#: candidate operand/attribute reference tokens after the opcode's ``(``
_TOKEN_RE = re.compile(r"%?([\w.\-]+)")

#: opcodes that move, reshape or describe data (or carry control)
#: rather than computing — excluded from the "compute scheduled during
#: communication" buckets so a ``pad``/``slice`` shuffle cannot
#: masquerade as hidden arithmetic. Fusions, elementwise ops, dots,
#: convolutions, selects, reduces all count.
_NON_COMPUTE_OPS = frozenset({
    "parameter", "constant", "get-tuple-element", "tuple", "bitcast",
    "copy", "copy-start", "copy-done", "after-all", "partition-id",
    "replica-id", "while", "call", "conditional", "send", "send-done",
    "recv", "recv-done", "infeed", "outfeed", "domain", "opt-barrier",
    "pad", "reshape", "transpose", "slice", "dynamic-slice",
    "dynamic-update-slice", "concatenate", "broadcast", "iota",
    "reverse", "gather", "scatter", "rng", "rng-bit-generator",
}) | frozenset(_COLLECTIVES) | frozenset(
    f"{op}-{half}" for op in _COLLECTIVES for half in ("start", "done")
) | frozenset({"async-start", "async-update", "async-done"})


def _result_bytes_elems(type_str: str) -> Tuple[int, int]:
    """(bytes, elements) of a result type — arrays summed over tuples."""
    shapes = [
        (_elems(sh) * _DTYPE_BYTES[dt], _elems(sh))
        for dt, sh in _SHAPE_RE.findall(type_str)
        if dt in _DTYPE_BYTES
    ]
    return sum(b for b, _ in shapes), sum(e for _, e in shapes)


def _closure(start: str, edges: Dict[str, Set[str]]) -> Set[str]:
    """Transitive closure of ``edges`` from ``start`` (start excluded)."""
    seen: Set[str] = set()
    stack = list(edges.get(start, ()))
    while stack:
        nxt = stack.pop()
        if nxt in seen:
            continue
        seen.add(nxt)
        stack.extend(edges.get(nxt, ()))
    return seen


def overlap_report(compiled=None, hlo_text: Optional[str] = None) -> dict:
    """Statically verify comm/compute overlap on compiled HLO.

    For every collective instruction, measure the compute the scheduler
    can (or did) run while the transfer is in flight — turning "XLA will
    overlap it" from a hope into a checked property of the artifact:

    - an **async pair** (``collective-permute-start``/``done``,
      async all-reduce/all-gather/reduce-scatter) reports the compute
      instructions literally printed between start and done: compiled
      executables are scheduled modules, so between-ness in the text IS
      the schedule (``scheduled_ops``/``scheduled_bytes``);
    - a **sync** collective (the CPU backend, pre-scheduling dumps)
      has no printed flight window, so the report falls back to
      dataflow: compute in the same computation that neither feeds the
      collective's operands nor consumes its result — exactly the set
      the scheduler is free to place between start and done once the
      op is asynced (``independent_ops``/``independent_bytes``).

    Per-collective independence alone can flatter a bulk-synchronous
    program (the compute feeding collective B is "independent" of
    collective A), so the summary's headline bucket is stricter:
    ``overlappable_bytes`` counts compute independent of **every**
    collective in its computation — work the scheduler could run while
    the whole exchange is in flight. The naive stencil step reports
    ~zero there (every cell consumes the halos; only loop bookkeeping
    is free); the overlapped step reports its interior — the
    deterministic CPU-HLO assertion in ``tests/test_overlap.py``.

    Summary keys: ``scheduled_bytes`` (async pairs only — achieved
    overlap in the printed schedule; an instruction sitting inside
    several overlapping flight windows books once, though each pair's
    own ``scheduled_bytes`` still reports its full window),
    ``overlappable_bytes`` (the
    independent-of-all-collectives bucket), ``overlapped_bytes``
    (scheduled when the module has async pairs, else overlappable —
    the strongest overlap evidence this artifact supports),
    ``compute_bytes`` (all compute in collective-bearing
    computations), and ``overlap_fraction`` = overlappable/compute.
    ``flops_estimate`` is a 1-op-per-result-element lower bound
    (dots/convolutions undercounted) — a comparator between two
    schedules of one program, not an absolute flop count.
    """
    if hlo_text is None:
        hlo_text = compiled.as_text()
    lines = hlo_text.splitlines()
    _, comp_of_line = _scan_computations(lines)

    # per-computation: defs in print (schedule) order with deps
    comps: Dict[Optional[str], dict] = {}
    for lineno, line in enumerate(lines):
        m = _DEF_RE.match(line)
        if not m:
            continue
        comp = comps.setdefault(
            comp_of_line[lineno],
            {"order": [], "op": {}, "deps": {}, "bytes": {}, "elems": {}},
        )
        name, op = m.group("name"), m.group("op")
        nbytes, nelems = _result_bytes_elems(m.group("type"))
        comp["order"].append(name)
        comp["op"][name] = op
        comp["bytes"][name] = nbytes
        comp["elems"][name] = nelems
        rest = line[m.end():]
        comp["deps"][name] = {
            t for t in _TOKEN_RE.findall(rest) if t != name
        }
    for comp in comps.values():
        defs = set(comp["order"])
        comp["deps"] = {
            n: (d & defs) for n, d in comp["deps"].items()
        }
        users: Dict[str, Set[str]] = {n: set() for n in defs}
        for n, d in comp["deps"].items():
            for o in d:
                users[o].add(n)
        comp["users"] = users

    records = []
    scheduled_bytes = 0
    overlappable_bytes = 0
    overlappable_ops = 0
    flops_estimate = 0
    compute_bytes = 0
    for comp_name, comp in comps.items():
        order, ops = comp["order"], comp["op"]
        index = {n: i for i, n in enumerate(order)}
        coll_names = [
            n for n in order
            if ops[n] in _COLLECTIVES
            or any(ops[n] == f"{c}-start" for c in _COLLECTIVES)
        ]
        if not coll_names:
            continue
        # every collective-ish instruction (starts, syncs, AND dones):
        # the ancestor test below uses it to tell "this transfer is a
        # link of a dependent collective chain" — the input the perf
        # tier's serialized-dma rule consumes
        collectivish = {
            n for n in order
            if ops[n] in _COLLECTIVES
            or any(ops[n] in (f"{c}-start", f"{c}-done")
                   for c in _COLLECTIVES)
        }
        compute = [n for n in order if ops[n] not in _NON_COMPUTE_OPS]
        comp_compute_bytes = sum(comp["bytes"][n] for n in compute)
        compute_bytes += comp_compute_bytes
        windowed_names: Set[str] = set()
        # the strict bucket: compute linked to NO collective at all —
        # upstream of none (not operand prep), downstream of none (not
        # a consumer) — schedulable while the whole exchange flies
        linked: Set[str] = set()
        for cname in coll_names:
            linked |= _closure(cname, comp["deps"])
            linked |= _closure(cname, comp["users"])
            linked.add(cname)
        free_all = [n for n in compute if n not in linked]
        overlappable_bytes += sum(comp["bytes"][n] for n in free_all)
        overlappable_ops += len(free_all)
        flops_estimate += sum(comp["elems"][n] for n in free_all)
        for name in coll_names:
            op = ops[name]
            is_start = any(op == f"{c}-start" for c in _COLLECTIVES)
            rec = {
                "op": op[: -len("-start")] if is_start else op,
                "name": name,
                "computation": comp_name,
                "async": is_start,
                # total compute in the surrounding computation: the
                # denominator that tells "nothing to overlap" (0) apart
                # from "overlap impossible" (>0 but fully dependent) —
                # what traffic_lint's sync-no-overlap rule needs
                "computation_compute_bytes": comp_compute_bytes,
            }
            # per-collective freedom: neither upstream nor downstream
            # of THIS collective (looser than free_all — operand prep
            # for a sibling collective counts here)
            ancestors = _closure(name, comp["deps"])
            descendants = _closure(name, comp["users"])
            free = [
                n for n in compute
                if n != name and n not in ancestors
                and n not in descendants
            ]
            rec["independent_ops"] = len(free)
            rec["independent_bytes"] = sum(comp["bytes"][n] for n in free)
            # additive chain column: the nearest upstream collective
            # this transfer's start depends on (None = chain head) —
            # a dependent chain whose links move with zero scheduled
            # compute is the perf tier's serialized-dma finding
            upstream = [n for n in ancestors
                        if n != name and n in collectivish]
            rec["depends_on_collective"] = (
                max(upstream, key=lambda n: index[n]) if upstream
                else None
            )
            if is_start:
                done = next(
                    (
                        n for n in order
                        if any(ops[n] == f"{c}-done" for c in _COLLECTIVES)
                        and name in comp["deps"].get(n, ())
                    ),
                    None,
                )
                rec["done"] = done
                lo = index[name]
                hi = index[done] if done is not None else len(order)
                between = [
                    n for n in compute
                    if n != name and lo < index[n] < hi
                ]
                rec["scheduled_ops"] = len(between)
                rec["scheduled_bytes"] = sum(
                    comp["bytes"][n] for n in between
                )
                # summary dedup: compute inside several overlapping
                # flight windows (4 starts, interior, 4 dones) must
                # book ONCE, or the headline would quadruple-count it
                windowed_names.update(between)
            records.append(rec)
        scheduled_bytes += sum(
            comp["bytes"][n] for n in windowed_names
        )

    async_pairs = sum(1 for r in records if r["async"])
    return {
        "collectives": len(records),
        "async_pairs": async_pairs,
        "scheduled_bytes": scheduled_bytes,
        "overlappable_bytes": overlappable_bytes,
        "overlappable_ops": overlappable_ops,
        "overlapped_bytes": (
            scheduled_bytes if async_pairs else overlappable_bytes
        ),
        "compute_bytes": compute_bytes,
        "flops_estimate": flops_estimate,
        "overlap_fraction": (
            overlappable_bytes / compute_bytes if compute_bytes else 0.0
        ),
        "per_collective": records,
    }


def _group_crossing(group: Sequence[int], partition: Dict[int, int]) -> bool:
    """Does a replica group span more than one partition cell?"""
    return len({partition[d] for d in group}) > 1


def tier_crossing_bytes(
    records: Sequence[dict], partition: Dict[int, int]
) -> Dict[str, float]:
    """Per-device payload bytes whose collective spans the partition.

    ``partition`` maps device id -> tier cell (e.g. slice index of the
    hybrid mesh). A collective whose replica group stays inside one
    cell rides the fast tier only; one that spans cells must move its
    payload across the slow boundary. Returns
    ``{"crossing": B, "local": B}`` — the result-shape bytes of each
    class (floats: proportional accounting splits a record's bytes
    fractionally), the quantity the hierarchical-vs-flat comparison
    needs. For an all-reduce, every participating device contributes
    and receives the full result shape, so result bytes IS the
    per-device volume; for collective-permute, pairs that cross count.
    For gather-type collectives (all-gather, reduce-scatter) the
    per-device LINK traffic is smaller than the result shape — using
    result bytes is a deliberate upper-bound approximation, consistent
    across the programs being compared.

    Accounting is proportional: a device's payload counts as crossing
    when ITS replica group (or permute pair) spans the partition, so a
    record whose groups are part-local part-crossing contributes
    ``bytes * crossing_fraction`` to each bucket (e.g. a ring permute
    on a two-slice mesh crosses on exactly the 2 of n wrap links). A
    record whose group structure did not parse (``replica_groups={}``
    meaning all replicas, or the iota ``[n,m]<=[k]`` form) is counted
    as fully CROSSING — conservatively overstating the slow-tier
    volume rather than silently dropping payload.

    If any record carries ``in_loop`` the result gains an
    ``in_loop_records`` count: those records' bytes are per HLO
    occurrence (an under-count by the loop trip count), so both
    buckets are lower bounds for such programs.

    Multi-slice caveat: on a GENUINE multi-slice artifact XLA compiles
    ONE ``num_partitions=n_per_slice`` module PER SLICE, and the
    records come from a single module's text. The ``crossing`` bucket
    is still exact — every slice-crossing byte appears as a megascale
    send in whichever module it leaves — but ``local`` counts only the
    one compiled module's in-slice traffic, i.e. it is PER-MODULE, not
    the job-wide total (slices run the same SPMD program, so the
    job-wide figure is ``local × n_slices`` when you need it). Only
    compare ``local`` across programs compiled for the same topology.
    """
    out = {"crossing": 0.0, "local": 0.0}
    in_loop = sum(1 for rec in records if rec.get("in_loop"))
    if in_loop:
        # per-occurrence bytes of a while-body collective under-count
        # by the trip count — the volumes below are LOWER BOUNDS; the
        # key makes the understatement visible instead of silent
        out["in_loop_records"] = in_loop
    for rec in records:
        if rec.get("megascale"):
            # a megascale send exists ONLY to cross the slice boundary
            # (in-slice traffic stays in replica-grouped collectives)
            out["crossing"] += rec["bytes"]
            continue
        sets = rec.get("groups") or rec.get("pairs")
        if sets:
            ncross = sum(
                1 for g in sets if _group_crossing(g, partition)
            )
            frac = ncross / len(sets)
        else:
            frac = 1.0  # unknown structure: assume it crosses
        out["crossing"] += rec["bytes"] * frac
        out["local"] += rec["bytes"] * (1.0 - frac)
    return out


def ring_traffic(
    kind: str,
    n: int,
    payload_bytes: int,
    chunks: int = 1,
    hops: int = 1,
) -> Dict[str, int]:
    """Predicted per-device ICI traffic of a ring-tier program.

    The remote DMAs live inside Mosaic kernels, so HLO shows nothing;
    the schedule, however, is static (``kernels/ring.py``), and each
    protocol's per-device send volume follows from it:

    - ``all_gather``: each device forwards ``n - 1`` units of the
      per-rank payload around the ring.
    - ``all_reduce``: the running partial makes ``n - 1`` hops.
    - ``reduce_scatter``: ``n - 1`` block-sized partials leave each
      device.
    - ``neighbour_stream``: every chunk moves one hop per call;
      ``hops`` calls move ``chunks * hops`` chunk payloads.

    ``payload_bytes`` is the per-unit payload (the per-rank chunk for
    all_gather/all_reduce, the per-destination block for
    reduce_scatter, the chunk row for neighbour_stream). Returns
    ``{"ici_send_bytes": B}`` per device; receives are symmetric.
    """
    if kind in ("all_gather", "all_reduce", "reduce_scatter"):
        return {"ici_send_bytes": (n - 1) * payload_bytes}
    if kind == "neighbour_stream":
        return {"ici_send_bytes": chunks * hops * payload_bytes}
    raise ValueError(f"unknown ring protocol {kind!r}")


#: v5e one-way ICI bandwidth per link (the public scaling-book figure,
#: jax-ml.github.io/scaling-book: ~4.5e10 B/s one-way per link, 4 links
#: per chip in the 2-D torus). All predictions below are BANDWIDTH-ONLY
#: lower bounds at one link's rate — no per-hop latency, no multi-link
#: credit, no compute overlap — the compiled-evidence column that lets
#: the ring and XLA tiers be compared without owning a pod.
V5E_ICI_LINK_BYTES_PER_S = 4.5e10


def predicted_us(
    send_bytes: float,
    link_bytes_per_s: float = V5E_ICI_LINK_BYTES_PER_S,
) -> float:
    """Bandwidth-only wall-clock bound of moving ``send_bytes`` over
    one ICI link at the v5e rate, in microseconds."""
    return send_bytes / link_bytes_per_s * 1e6


def collective_wire_bytes(rec: dict) -> float:
    """Per-device ICI wire bytes of one HLO collective record under the
    standard ring algorithms (the basis of the predicted wall-clock
    column): all-reduce moves ``2(n-1)/n`` of its payload per device,
    all-gather and all-to-all ``(n-1)/n`` of the result, reduce-scatter
    ``(n-1)x`` its scattered output piece, collective-permute one hop
    of its payload. ``n`` comes from the record's largest replica
    group (default 2 when the group structure did not parse —
    a conservative under-count flagged by the default's rarity)."""
    op, b = rec["op"], rec["bytes"]
    groups = rec.get("groups")
    n = max((len(g) for g in groups), default=2) if groups else 2
    if op == "all-reduce":
        return 2 * (n - 1) / n * b
    if op in ("all-gather", "all-to-all"):
        return (n - 1) / n * b
    if op == "reduce-scatter":
        return (n - 1) * b
    return float(b)


def predicted_program_us(
    records: Sequence[dict],
    link_bytes_per_s: float = V5E_ICI_LINK_BYTES_PER_S,
) -> float:
    """Predicted per-device ICI wall-clock of a program's collectives,
    summed serially (no overlap credit) at the v5e link rate."""
    return sum(
        predicted_us(collective_wire_bytes(r), link_bytes_per_s)
        for r in records
    )


# ---------------------------------------------------------------------------
# HLO lint tier
# ---------------------------------------------------------------------------

#: The lint rules ``traffic_lint`` applies — documented one-for-one in
#: docs/analysis.md (drift-guarded by tests/test_perf_docs).
TRAFFIC_LINT_CHECKS = ("sync-no-overlap", "collective-in-loop",
                      "unframed-channel")

#: ``unframed-channel`` abstains on groups whose largest record is at
#: most this many bytes: at header scale a payload and a frame header
#: are the same shape, so the rule cannot classify them.
_UNFRAMED_MIN_BYTES = 64

#: A frame-header candidate must be at most 1/this of the payload it
#: vouches for — a real ``transfer_verified`` header is one s32 per
#: chunk (4 B per >=chunk_elements-element chunk), far below this; two
#: similarly-sized bare s32 transfers stay above it and both get
#: flagged instead of silently clearing each other.
_UNFRAMED_HEADER_RATIO = 8


def traffic_lint(compiled=None, hlo_text: Optional[str] = None) -> List[dict]:
    """Lint a compiled artifact's collective usage.

    The static-artifact counterpart of the protocol verifier: each rule
    flags a pattern that costs real wall-clock or durability at serving
    scale, checkable from ``compiled.as_text()`` alone:

    - ``sync-no-overlap`` — a sync collective in a computation that HAS
      compute, yet no compute is independent of it
      (``overlap_report``'s pairing): the transfer serializes the whole
      step, the exact shape the overlap engine exists to fix. A
      computation with no compute at all is NOT flagged — there is
      nothing to overlap.
    - ``collective-in-loop`` — a collective inside a ``while`` body: it
      is re-traced per iteration, its traffic is invisible to volume
      accounting (``in_loop`` records under-count by the trip count),
      and ``executable_report`` must withhold predicted wall-clock.
      Hoist or unroll it.
    - ``unframed-channel`` — a P2P channel payload (a single-pair
      ``collective-permute``) with no verified-transport frame header
      riding the same route. A framed transfer
      (``P2PChannel.transfer_verified``) moves its s32 checksum vector
      over an identical source-target pair in the same computation, at
      most ``1/_UNFRAMED_HEADER_RATIO`` of the payload's bytes; a bare
      payload is silent-corruption surface (the fault matrix's
      existence proof). Every record of an unframed group is flagged
      (two bare transfers on one route are two findings, and two bare
      s32 transfers cannot clear each other as pseudo-headers).
      Multi-pair permutes (ring shifts, halo exchanges) are NOT
      channels and are not flagged, and groups at or below
      ``_UNFRAMED_MIN_BYTES`` are skipped — at header scale payload
      and header are indistinguishable by shape.

    Returns one dict per finding: ``{"check", "name", "op", "bytes",
    "message"}`` (empty list = clean) — the ``smi-tpu traffic --lint``
    payload, exit-nonzero-on-findings at the CLI.
    """
    if hlo_text is None:
        hlo_text = compiled.as_text()
    findings: List[dict] = []
    records = collective_traffic(None, hlo_text=hlo_text)

    report = overlap_report(hlo_text=hlo_text)
    for rec in report["per_collective"]:
        if rec["async"]:
            continue
        if (rec["computation_compute_bytes"] > 0
                and rec["independent_bytes"] == 0):
            findings.append({
                "check": "sync-no-overlap",
                "name": rec["name"],
                "op": rec["op"],
                "bytes": 0,
                "message": (
                    f"sync {rec['op']} %{rec['name']} gates every "
                    f"compute instruction in its computation "
                    f"({rec['computation_compute_bytes']} B of compute, "
                    f"0 B independent) — the transfer cannot overlap "
                    f"anything; restructure so some compute is free of "
                    f"it (see overlap_report)"
                ),
            })

    for rec in records:
        if rec.get("in_loop"):
            findings.append({
                "check": "collective-in-loop",
                "name": rec["name"],
                "op": rec["op"],
                "bytes": rec["bytes"],
                "message": (
                    f"{rec['op']} %{rec['name']} sits inside a while "
                    f"body: it runs trip-count times per occurrence, "
                    f"its volume is under-counted by traffic "
                    f"accounting, and predicted wall-clock is withheld "
                    f"— hoist it out of the loop or scale its budget "
                    f"by the trip count explicitly"
                ),
            })

    by_pairs: Dict[tuple, List[dict]] = {}
    for rec in records:
        pairs = rec.get("pairs")
        if rec["op"] == "collective-permute" and pairs:
            # a header only vouches for a payload in its OWN
            # computation — an unrelated framed transfer elsewhere in
            # the module must not clear this one
            by_pairs.setdefault(
                (rec.get("computation"),
                 tuple(tuple(p) for p in pairs)), []
            ).append(rec)
    for (_, pairs), group in sorted(
        by_pairs.items(), key=lambda kv: (str(kv[0][0]), kv[0][1])
    ):
        if len(pairs) != 1:
            continue  # ring/halo shifts, not point-to-point channels
        top = max(r["bytes"] for r in group)
        if top <= _UNFRAMED_MIN_BYTES:
            # below the classification floor a payload is the same
            # size as a frame header — undecidable from shapes alone,
            # so the rule abstains (documented in docs/analysis.md)
            continue
        framed = any(
            r["dtype"] in ("s32", "u32")
            and r["bytes"] * _UNFRAMED_HEADER_RATIO <= top
            for r in group
        )
        if framed:
            continue
        # no plausible header: EVERY record in the group is a bare
        # channel payload (not just the largest — two unframed
        # transfers on one route are two findings)
        for rec in group:
            findings.append({
                "check": "unframed-channel",
                "name": rec["name"],
                "op": rec["op"],
                "bytes": rec["bytes"],
                "message": (
                    f"P2P channel payload %{rec['name']} "
                    f"({rec['bytes']} B over pair "
                    f"{list(pairs[0])}) moves with no verified-"
                    f"transport frame header on the same route — "
                    f"in-flight corruption lands silently; use "
                    f"transfer_verified/stream_verified"
                ),
            })
    return findings
