"""Readings behind each limit of ``correct``: the program's and the
control's (the cell's lower-precision reference in the program's place),
seed by seed, at the cell's own size, in one process.

``python3 -m smibench.calibrate --workload <cell> --seeds <first> <n>``
prints one JSON line a seed and a last line with the largest program
reading and the smallest control reading of each number compared. It
runs the benchmark's own path (:func:`smibench.harness.run_cell`) with a
window of one solve; the benchmark's runs never run it.
"""

import argparse
import json
import sys


def readings(cell: str, seeds, device, overrides=None,
             control_seeds=None):
    """``{program: {number: [reading a seed]}}`` for the port on every
    seed and the control on the first ``control_seeds`` (all when
    None)."""
    from smibench import harness

    out = {"port": {}, "control": {}}
    seeds = list(seeds)
    n_control = len(seeds) if control_seeds is None else control_seeds
    for i, seed in enumerate(seeds):
        for program in ("port", "control")[:2 if i < n_control else 1]:
            result = harness.run_cell(cell, seed, 0.0, False, device,
                                      overrides=overrides, program=program)
            line = {"seed": seed, "program": program,
                    "correct": result["correct"]}
            for name, check in result["checks"].items():
                out[program].setdefault(name, []).append(check["value"])
                line[name] = check["value"]
            print(json.dumps(line), flush=True)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="smibench.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs=2, required=True,
                   metavar=("FIRST", "COUNT"))
    p.add_argument("--control-seeds", type=int, default=None,
                   help="run the control on the first N seeds only")
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("smibench.calibrate: no CUDA card", file=sys.stderr)
        return 2
    first, count = args.seeds
    found = readings(args.workload, range(first, first + count),
                     torch.device("cuda", 0),
                     control_seeds=args.control_seeds)
    summary = {name: {"port_max": max(found["port"][name]),
                      "control_min": min(found["control"][name])}
               for name in found["port"]}
    print(json.dumps({"workload": args.workload, "seeds": count,
                      "summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
