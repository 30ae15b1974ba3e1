"""CLI: ``python -m smi_tpu_torch.benchmarks <name> [--ranks N] ...``

The flags of ``python -m smi_tpu.benchmarks``. The ranks are the threads
of one :class:`~smi_tpu_torch.parallel.local.LocalWorld` on the card (or
on the CPU with ``--cpu``): ``--ranks N`` and ``--fake-ranks N`` both
make a world of N ranks (the JAX package's fake mesh is the second; a
launch form that puts ranks on cards of their own is not built), and the
default is one rank per card.
"""

import argparse
import contextlib
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="smi_tpu_torch.benchmarks")
    parser.add_argument("name", help="benchmark name, or 'all'")
    parser.add_argument("--ranks", type=int, default=None,
                        help="world size (default: one rank per card)")
    parser.add_argument("--runs", type=int, default=10)
    parser.add_argument("--root", type=int, default=None,
                        help="collective root (collectives only)")
    parser.add_argument("--elements", type=int, default=None)
    parser.add_argument("--size-kb", type=int, default=None,
                        help="bandwidth payload")
    parser.add_argument("--eager", action="store_true",
                        help="pipeline: disable rendezvous chunking")
    parser.add_argument("--window", type=int, default=None,
                        help="ring attention: sliding-window size")
    parser.add_argument("--seq-per-rank", type=int, default=None,
                        help="ring attention: tokens per rank")
    parser.add_argument("--out-dir", default=None,
                        help="write .dat/.json result files here")
    parser.add_argument("--trace", default=None, metavar="DIR",
                        help="write a torch.profiler trace into DIR")
    parser.add_argument("--backend", default="xla",
                        choices=("xla", "ring"),
                        help="communication tier: the world's collectives "
                             "or the credit-flow ring kernels")
    parser.add_argument("--cpu", action="store_true",
                        help="run the world on the CPU")
    parser.add_argument("--fake-ranks", type=int, default=None,
                        help="world size: N threads on one device")
    args = parser.parse_args(argv)

    import torch

    from smi_tpu_torch.benchmarks.micro import BENCHMARKS, run_benchmark
    from smi_tpu_torch.parallel.local import LocalWorld

    device = "cpu" if args.cpu else None
    ranks = args.fake_ranks or args.ranks
    if ranks is None:
        ranks = 1 if args.cpu else max(1, torch.cuda.device_count())
    world = LocalWorld(ranks, device=device)
    names = sorted(BENCHMARKS) if args.name == "all" else [args.name]
    params = {"runs": args.runs}
    if args.backend != "xla":
        params["backend"] = args.backend
    if args.root is not None:
        params["root"] = args.root
    if args.elements is not None:
        params["elements"] = args.elements

    for name in names:
        p = dict(params)
        if name.startswith("bandwidth"):
            p.pop("root", None)
            p.pop("elements", None)
            if args.size_kb is not None:
                p["size_kb"] = args.size_kb
        elif name in ("latency", "injection", "multi_collectives"):
            p.pop("root", None)
            if name in ("latency", "injection"):
                p.pop("elements", None)
        elif name == "pipeline":
            p.pop("root", None)
            p["rendezvous"] = not args.eager
        elif name == "pipeline_double_rail":
            p.pop("root", None)
        elif name == "overlap":
            p.pop("root", None)
            p.pop("elements", None)
            if args.size_kb is not None:
                p["size_kb"] = args.size_kb
        elif name.startswith("app_"):
            p.pop("root", None)
            p.pop("elements", None)
            if p.pop("backend", "xla") != "xla":
                # app benchmarks have no ring tier; never record an xla
                # measurement under a requested non-default tier
                # (run_benchmark's own guard enforces the same rule)
                msg = (f"{name}: no backend tiers — skipping under "
                       f"backend={args.backend!r}")
                if args.name == "all":
                    print(msg, file=sys.stderr)
                    continue
                print(f"error: {msg}", file=sys.stderr)
                return 1
            if name.startswith("app_ring_attention"):
                if args.window is not None:
                    p["window"] = args.window
                if args.seq_per_rank is not None:
                    p["seq_per_rank"] = args.seq_per_rank
        if args.trace:
            from smi_tpu_torch.utils.tracing import trace

            ctx = trace(args.trace)
        else:
            ctx = contextlib.nullcontext()
        try:
            with ctx:
                run_benchmark(name, world, out_dir=args.out_dir, **p)
        except ValueError as e:
            # an 'all' sweep keeps going past benchmarks whose rank
            # requirements this world cannot meet
            if args.name != "all":
                raise
            print(f"{name}: skipped ({e})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
