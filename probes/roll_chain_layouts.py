#!/usr/bin/env python3
"""Time the roll-chain kernel's layout choices on one NVIDIA GPU.

Run from the root of a checkout: ``python3 probes/roll_chain_layouts.py``
(one card, ``nvcc``; about a minute). At 512x2048 f32, R=4096, each pair
timed in turns (a, b, b, a; CUDA events over about 0.3 s of launches),
every output ``torch.equal`` to the plain version's:

- blocks of 1, 2 and 4 warps (the plan's ``warps``), each body;
- the kernel's step, which issues all of a line's shuffles before its
  selects up to 64 registers a line, against the walk that overwrites
  each register after its shuffle at every length (built from
  ``csrc/roll_chain.cu`` with ``kShufflesFirst`` 0, into
  ``build/probe/``);
- ``lane`` and ``add`` at 256x2048 x2 (512 warps of 64 registers, the
  kernel's layout: a warp a line of one chain) against 256x4096 x1
  (256 warps of 128 registers: the shuffles a warp takes when it holds
  a row of both chains).

Prints the card's name and power limit first.
"""

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
R = 4096

#: the walk at every line length
SHUFFLES_FIRST = "constexpr int kShufflesFirst = 64;"
WALK = "constexpr int kShufflesFirst = 0;"


def main() -> int:
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke
    from smi_tpu_torch.kernels import _build, roll

    if not torch.cuda.is_available():
        print("roll_chain_layouts: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", "0"],
        check=True, capture_output=True, text=True).stdout.strip())

    source = (_build.CSRC / "roll_chain.cu").read_text()
    if source.count(SHUFFLES_FIRST) != 1:
        raise SystemExit("csrc/roll_chain.cu no longer has the constant "
                         "this probe replaces")
    out = ROOT / "build" / "probe" / "roll_chain_layouts"
    out.mkdir(parents=True, exist_ok=True)
    variant = out / "roll_chain.cu"
    variant.write_text(source.replace(SHUFFLES_FIRST, WALK))
    library = out / "libroll_chain_walk.so"
    subprocess.run(_build.nvcc_command(_build.find_nvcc(), variant, library),
                   check=True, capture_output=True)
    _build.build_kernels(["roll_chain"])
    libs = {"tree": _build._libs["roll_chain"],
            "walk": _build._declare(
                "roll_chain", ctypes.CDLL(str(library)))}

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)

    def measure(lib, warps, shape, chains, body):
        xs = tuple(torch.randn(shape, generator=gen, device=dev)
                   for _ in range(chains))
        tree_plan = roll._plan

        def plan(*args):
            p = dict(tree_plan(*args))
            p["args"] = (p["regs"], warps)
            return p

        _build._libs["roll_chain"], roll._plan = libs[lib], plan
        try:
            got = roll.roll_chain(xs, R, body)
            for g, w in zip(got, roll.roll_chain_plain(xs, R, body)):
                if not torch.equal(g, w):
                    raise AssertionError(f"{lib} {shape} x{chains} {body}")
            return chip_smoke.timed(lambda: roll.roll_chain(xs, R, body))
        finally:
            _build._libs["roll_chain"], roll._plan = libs["tree"], tree_plan

    def in_turns(name, a, b):
        first = [measure(*a)]
        second = [measure(*b), measure(*b)]
        first.append(measure(*a))
        print(f"{name}: {sum(first) / 2:.4f} ms against "
              f"{sum(second) / 2:.4f} ms", flush=True)

    for body in roll.BODIES:
        for warps in (1, 2):
            in_turns(f"{body} 512x2048 x1, blocks of 4 warps against {warps}",
                     ("tree", 4, (512, 2048), 1, body),
                     ("tree", warps, (512, 2048), 1, body))
    for body in ("lane", "sublane"):
        in_turns(f"{body} 512x2048 x1, shuffles first against the walk",
                 ("tree", 4, (512, 2048), 1, body),
                 ("walk", 4, (512, 2048), 1, body))
    for body in ("lane", "add"):
        in_turns(f"{body}, 512 warps of 64 registers (256x2048 x2) against "
                 f"256 of 128 (256x4096 x1)",
                 ("tree", 4, (256, 2048), 2, body),
                 ("tree", 4, (256, 4096), 1, body))
    return 0


if __name__ == "__main__":
    sys.exit(main())
