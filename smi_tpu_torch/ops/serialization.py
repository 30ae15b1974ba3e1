"""JSON wire formats: programs, operations, and topology files.

Reference parity: ``codegen/serialization.py``. Formats are kept
field-compatible with the reference where it costs nothing, so topology
files written for the reference (e.g. ``test/p2p/p2p.json``) parse here
unchanged:

- a *program* file: ``{"operations": [...], "consecutive_reads": N,
  "max_ranks": N, "p2p_rendezvous": bool}``;
- an *operation*: ``{"type": "push", "port": 0, "data_type": "float",
  "buffer_size": null, ...}`` (Reduce adds ``"op": "add"|"max"|"min"``);
- a *topology* file: ``{"fpgas": {"node:dev": "<program-name>", ...},
  "connections": {"node:dev:chX": "node:dev:chY", ...}}`` — the MPMD
  program map plus the physical link list.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

from smi_tpu_torch.ops.operations import Reduce, SmiOperation, make_operation
from smi_tpu_torch.ops.program import Device, Program, ProgramMapping

Endpoint = Tuple[Device, int]  # (device, link index)


def serialize_operation(op: SmiOperation) -> dict:
    data = {
        "type": op.NAME,
        "port": op.port,
        "data_type": op.dtype.value,
        "buffer_size": op.buffer_size,
        "args": {},
    }
    if isinstance(op, Reduce):
        # nested exactly as the reference writes it
        # (codegen/serialization.py:30-38, ops.py:172-174)
        data["args"] = {"op_type": op.op.value}
    return data


def parse_operation(data: Mapping) -> SmiOperation:
    kwargs = {}
    if data["type"] == "reduce":
        args = data.get("args", {})
        kwargs["op"] = args.get("op_type", data.get("op", "add"))
    return make_operation(
        data["type"],
        port=data["port"],
        # missing data_type defaults to "int", as in the reference
        # (codegen/serialization.py:22)
        dtype=data.get("data_type", "int"),
        buffer_size=data.get("buffer_size"),
        **kwargs,
    )


def serialize_program(program: Program) -> str:
    return json.dumps(
        {
            "operations": [serialize_operation(op) for op in program.operations],
            "consecutive_reads": program.consecutive_reads,
            "max_ranks": program.max_ranks,
            "p2p_rendezvous": program.p2p_rendezvous,
        },
        indent=2,
    )


def parse_program(data: Union[str, Mapping]) -> Program:
    if isinstance(data, str):
        data = json.loads(data)
    return Program(
        [parse_operation(op) for op in data["operations"]],
        consecutive_reads=data.get("consecutive_reads", 8),
        max_ranks=data.get("max_ranks", 8),
        p2p_rendezvous=data.get("p2p_rendezvous", True),
    )


@dataclasses.dataclass
class Topology:
    """Parsed topology file: physical links + MPMD program map.

    ``connections`` is bidirectional: both ``(a, la) -> (b, lb)`` and
    ``(b, lb) -> (a, la)`` are present (``codegen/serialization.py:91-107``).
    """

    connections: Dict[Endpoint, Endpoint]
    mapping: ProgramMapping

    @property
    def devices(self) -> List[Device]:
        return self.mapping.devices

    def neighbours(self, device: Device) -> List[Tuple[int, Device, int]]:
        """(local link, peer device, peer link) triples, sorted by link."""
        out = []
        for (dev, link), (peer, peer_link) in self.connections.items():
            if dev == device:
                out.append((link, peer, peer_link))
        return sorted(out)


_LINK_RE = re.compile(r"(\d+)$")


def _parse_endpoint(text: str) -> Endpoint:
    """``node:dev:chN`` → (Device, N)."""
    head, _, link = text.rpartition(":")
    match = _LINK_RE.search(link)
    if match is None:
        raise ValueError(f"endpoint link must end in digits, got {text!r}")
    return Device.parse(head), int(match.group(1))


def parse_topology_file(
    data: Union[str, Mapping],
    programs: Optional[Mapping[str, Program]] = None,
    program_paths: Sequence[str] = (),
    ignore_programs: bool = False,
) -> Topology:
    """Parse a topology JSON into connections + a rank→program mapping.

    ``programs`` maps program names to already-built ``Program`` objects;
    alternatively ``program_paths`` lists JSON files whose basenames are the
    program names (the reference's metadata-path mechanism,
    ``codegen/serialization.py:65-78``). With ``ignore_programs`` the map
    values become None (used by routing-only consumers).
    """
    if isinstance(data, str):
        data = json.loads(data)

    path_index = {
        os.path.splitext(os.path.basename(p))[0]: p for p in program_paths
    }
    cache: Dict[str, Optional[Program]] = dict(programs or {})

    device_map: Dict[Device, Optional[Program]] = {}
    for dev_text, prog_name in data.get("fpgas", data.get("devices", {})).items():
        if prog_name not in cache:
            if ignore_programs:
                cache[prog_name] = None
            elif prog_name in path_index:
                with open(path_index[prog_name]) as f:
                    cache[prog_name] = parse_program(f.read())
            else:
                raise KeyError(
                    f"program {prog_name!r} not provided (have "
                    f"{sorted(cache) + sorted(path_index)})"
                )
        device_map[Device.parse(dev_text)] = cache[prog_name]

    connections: Dict[Endpoint, Endpoint] = {}
    for src_text, dst_text in data.get("connections", {}).items():
        src, dst = _parse_endpoint(src_text), _parse_endpoint(dst_text)
        if src in connections or dst in connections:
            raise ValueError(f"endpoint reused in connections: {src_text} / {dst_text}")
        connections[src] = dst
        connections[dst] = src

    mapping = ProgramMapping(
        programs=[p for p in cache.values() if p is not None],
        device_to_program=device_map,
    )
    return Topology(connections=connections, mapping=mapping)
