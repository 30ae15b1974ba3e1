"""``python3 -m smibench --workload <cell> --seed <n> --seconds <s>
--trace <0|1>``: one run of one cell on the CUDA card.

The last line of standard output is the result, one JSON object; the
numbers compared with the reference, each beside its limit, are the
last lines of standard error. Without a CUDA card holding the chips the
cell asks for, or with JAX or the JAX package loaded once the window
has closed, the run exits non-zero and prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

#: top-level modules the port must not load: JAX and the JAX package
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "smi_tpu"})


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, taken whole, is one of
    :data:`FORBIDDEN`."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".", 1)[0] in FORBIDDEN)


def parse(argv):
    p = argparse.ArgumentParser(prog="smibench")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    from smibench import spec

    chips = int(spec.cell_entry(spec.benchmark(), args.workload)["chips"])
    import torch

    if not torch.cuda.is_available():
        print("smibench: no CUDA card; the benchmark does not run on the "
              "CPU", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < chips:
        print(f"smibench: {args.workload} needs {chips} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    from smibench import harness

    result = harness.run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), torch.device("cuda", 0),
                              t_start=T_START)
    found = forbidden_modules()
    if found:
        print(f"smibench: JAX or the JAX package was loaded: {found}",
              file=sys.stderr)
        return 3
    for name, check in result["checks"].items():
        print(f"check {name}: {check['value']!r} limit {check['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
