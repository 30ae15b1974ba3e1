"""Deliberately slow protocol variants — the perf analyzer's existence proof.

The port's copy of :mod:`smi_tpu.analysis.perf_mutants`, kept in
step with it line for line.

Same falsifiability discipline as :mod:`smi_tpu_torch.analysis.mutants`, one
tier up: each mutant here is *safe* (the PR 7 verifier proves it clean
— deadlock-free, race-free, credit-balanced) but *slow* in exactly one
named way, and the decomposition must convict it by exactly its rule,
differentially against the timestamped simulator (the mutant's
simulated makespan must actually be worse than the healthy protocol's,
with bit-identical delivery):

- :func:`hold_grants` — ``"halved_wire_credits"``: one rank's credit
  grants are held until its next semaphore wait completes, so every
  grant arrives a scheduling round late — the effective credit window
  is halved. The ring still completes and still delivers bit-identical
  results, but the throttled rank's neighbours now block *before the
  awaited event was even issued* (genuine upstream lateness), which is
  the one component that is exactly zero on every healthy protocol:
  conviction by ``idle-fraction``.
- :func:`all_reduce_chunked_serial_rank` — ``"unoverlapped_chunks"``:
  the chunked pipeline with phase A/B/C fused per chunk — chunk ``c+1``
  starts only after chunk ``c``'s arrival was combined. Credit
  discipline and delivery are byte-identical per chunk; what dies is
  the overlap: no two chunk copies are ever in flight together, so the
  measured wire pipeline depth collapses to 1 against a declared
  ``chunks > 1``: conviction by ``serialized-critical-path``.
- :data:`OVERSIZED_FLASH_TILE` — ``"oversized_flash_tile"``: a flash
  forward tile whose single-buffer VMEM footprint exceeds half the
  scoped-VMEM frame, so the HBM->VMEM pipeline cannot double-buffer:
  conviction by ``no-double-buffer`` (roofline sub-tier — no simulator
  run; the differential evidence is the footprint arithmetic itself,
  pinned against ``cost_model.flash_fwd_vmem_bytes``).
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Sequence

from smi_tpu_torch.parallel import credits as C

from smi_tpu_torch.analysis.verifier import build_generators

#: Perf-mutant registry, in acceptance-matrix order.
PERF_MUTANTS = ("halved_wire_credits", "unoverlapped_chunks",
                "oversized_flash_tile")

#: The exactly-one rule each perf mutant must be convicted by
#: (docs/analysis.md's perf mutant table, drift-guarded).
PERF_MUTANT_RULE = {
    "halved_wire_credits": "idle-fraction",
    "unoverlapped_chunks": "serialized-critical-path",
    "oversized_flash_tile": "no-double-buffer",
}

#: The mis-tiled flash compile: bq/bk 4096 needs ~9.4 MiB of VMEM per
#: buffer generation — over the 8 MiB double-buffer bound of the
#: 16 MiB scoped-VMEM frame.
OVERSIZED_FLASH_TILE = {
    "name": "oversized 4096/4096", "dtype": "bfloat16",
    "block_q": 4096, "block_k": 4096,
}


def hold_grants(gen: Iterator):
    """Hold every credit grant this rank signals until its NEXT
    semaphore wait has completed — each grant reaches the neighbour a
    full scheduling round late, halving the usable credit window.

    No grant is ever dropped (grants still held when the generator
    finishes are flushed, so credit conservation is intact) and no
    wait-for cycle is created (the held grant is released by a wait
    satisfied by the *other* neighbour), so the verifier stays clean —
    only the timing rots.
    """
    held: List[tuple] = []
    value = None
    while True:
        try:
            action = gen.send(value)
        except StopIteration:
            for grant in held:
                yield grant
            return
        if action[0] == "signal" and action[2] == C.SEM_CREDIT:
            held.append(action)
            value = None
            continue
        value = yield action
        if action[0] == "wait" and held:
            for grant in held:
                yield grant
            held = []


def all_reduce_chunked_serial_rank(me: int, n: int, values: Sequence,
                                   combine, flow_control: bool = True):
    """The chunked ring all-reduce with its pipeline un-overlapped:
    per ring step, each chunk runs start -> land -> combine -> re-grant
    to completion before the next chunk starts (contrast
    ``credits.all_reduce_chunked_rank``'s start-all-then-combine
    phases). Per chunk the credit discipline and delivered bits are
    identical; only the overlap is gone."""
    left = (me - 1) % n
    right = (me + 1) % n
    k = len(values)
    if flow_control:
        yield from C._barrier_steps(me, n)
    for c in range(k):
        yield ("write_slot", 2 * c, values[c])
        if flow_control:
            yield ("signal", left, C.SEM_CREDIT, 2 * c + 1, 1)
    for s in range(n - 1):
        slot, nslot = s % 2, (s + 1) % 2
        for c in range(k):
            if flow_control:
                yield ("wait", C.SEM_CREDIT, 2 * c + nslot, 1)
            payload = yield ("read_slot", 2 * c + slot)
            yield ("dma", right, 2 * c + nslot, payload,
                   2 * c + slot, 2 * c + nslot)
            yield ("wait", C.SEM_SEND, 2 * c + slot, 1)
            yield ("wait", C.SEM_RECV, 2 * c + nslot, 1)
            arrived = yield ("read_slot", 2 * c + nslot)
            yield ("write_slot", 2 * c + nslot,
                   combine(arrived, values[c]))
            if flow_control and s < n - 2:
                yield ("signal", left, C.SEM_CREDIT, 2 * c + slot, 1)
    final_slot = (n - 1) % 2
    for c in range(k):
        final = yield ("read_slot", 2 * c + final_slot)
        yield ("output", c, final)


def perf_mutant_generators(protocol: str, mutant: str, n: int,
                           chunks: int = 3, slices: int = 2,
                           rank: int = 0) -> List[Iterator]:
    """Per-rank generators of ``protocol`` with one perf mutant
    applied. ``halved_wire_credits`` throttles a single ``rank`` (a
    one-rank firmware/NIC bug — the asymmetry is what turns the lost
    window into neighbour idle); ``unoverlapped_chunks`` replaces the
    chunked protocol wholesale (the compiled kernel is shared) and is
    only meaningful there."""
    if mutant == "halved_wire_credits":
        gens = build_generators(protocol, n, chunks=chunks,
                                slices=slices)
        gens[rank] = hold_grants(gens[rank])
        return gens
    if mutant == "unoverlapped_chunks":
        if protocol != "all_reduce_chunked":
            raise ValueError(
                f"unoverlapped_chunks un-overlaps the chunked "
                f"pipeline; it applies to 'all_reduce_chunked', not "
                f"{protocol!r}"
            )
        return [
            all_reduce_chunked_serial_rank(
                r, n, [frozenset([(r, c)]) for c in range(chunks)],
                lambda a, b: a | b,
            )
            for r in range(n)
        ]
    if mutant == "oversized_flash_tile":
        raise ValueError(
            "oversized_flash_tile is a roofline-tier mutant (a tile "
            "choice, not a protocol transform); run it without "
            "--protocol"
        )
    raise ValueError(
        f"unknown perf mutant {mutant!r}; known: {PERF_MUTANTS}"
    )


def healthy_outputs(protocol: str, n: int, chunks: int = 3,
                    slices: int = 2) -> List[Dict]:
    """The fault-free delivery a mutant run must still match
    bit-identically (slower, never wrong)."""
    sim = C.RingSimulator(
        build_generators(protocol, n, chunks=chunks, slices=slices),
        C.Strategy(0),
    )
    return sim.run()
