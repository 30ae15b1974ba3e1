"""Driver of the SMI stencil configuration: one solve is
``make_temporal_stencil_fn(comm, sweeps, X, Y, depth)`` over every
rank's block of the seeded grid, on the cell's process grid.

A 1x1 grid runs on a one-rank communicator; any other on a
``LocalWorld`` of rank threads, each rank's block made once in set-up.
Every solve starts from the same blocks. The solve's output is the list
of the ranks' blocks, assembled into the grid only when it is judged.
"""

from __future__ import annotations

from smibench import spec, yardstick

reference = spec.load_module("references", "stencil_smi-8192")

#: the program's kernels a solve launches (their launch counters)
KERNELS = ("stencil_temporal", "stencil_sweep")


class Cell:
    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 program: str = "port"):
        import torch

        self.device = device
        self.seed = seed
        self.program = program
        self.gh, self.gw = int(config["X"]), int(config["Y"])
        self.sweeps = int(config["sweeps"])
        self.px, self.py = (int(n) for n in traffic["grid"])
        if self.gh % self.px or self.gw % self.py:
            raise ValueError(f"grid {self.gh}x{self.gw} does not divide "
                             f"over {self.px}x{self.py} ranks")
        h, w = self.gh // self.px, self.gw // self.py
        self.work = {"cells": yardstick.stencil_cell_updates(
            self.gh, self.gw, self.sweeps)}
        grid = reference.make_grid(self.gh, self.gw, seed, device)
        if program == "control":
            self.grid = grid
            self.facts = {"block": [h, w], "depth": None}
            return
        if program != "port":
            raise ValueError(f"unknown program {program!r}")

        from smi_tpu_torch.kernels import _build
        from smi_tpu_torch.kernels import stencil_temporal as kt

        self._build = _build
        depth = kt.pick_temporal_depth(h, w, torch.float32, self.sweeps)
        if depth is None:
            raise ValueError(f"no k-sweep depth for a {h}x{w} block")
        self.facts = {"block": [h, w], "depth": depth}
        if self.px * self.py == 1:
            from smi_tpu_torch.parallel.mesh import make_communicator

            comm = make_communicator(shape=(1, 1), axis_names=("sx", "sy"),
                                     device=device)
            self.world = None
            self.coords = [(0, 0)]
            self.fns = [kt.make_temporal_stencil_fn(
                comm, self.sweeps, self.gh, self.gw, depth=depth)]
        else:
            from smi_tpu_torch.parallel.local import LocalWorld

            self.world = LocalWorld((self.px, self.py), ("sx", "sy"),
                                    device=device)
            self.coords = [tuple(c.coords) for c in self.world.comms]
            self.fns = [kt.make_temporal_stencil_fn(
                c, self.sweeps, self.gh, self.gw, depth=depth)
                for c in self.world.comms]
        self.blocks = [grid[r * h:(r + 1) * h, c * w:(c + 1) * w].contiguous()
                       for r, c in self.coords]
        del grid

    def _sync(self):
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def warm(self) -> None:
        """Builds the kernels (the first run of a checkout compiles) and
        runs two solves of the cell's own shape."""
        if self.program == "port" and self.device.type == "cuda":
            self._build.build_kernels(list(KERNELS))
        for _ in range(2):
            self.solve()

    def solve(self):
        if self.program == "control":
            import torch

            out = reference.jacobi(self.grid, self.sweeps, torch.bfloat16)
        elif self.world is None:
            out = [self.fns[0](self.blocks[0])]
        else:
            fns, blocks = self.fns, self.blocks
            out = self.world.run(lambda c: fns[c.rank](blocks[c.rank]))
        self._sync()
        return out

    def reset_counters(self) -> None:
        if self.program == "port":
            self._build.reset_launches()

    def counters(self) -> dict:
        if self.program != "port":
            return {}
        return {k: self._build.LAUNCHES[k] for k in KERNELS}

    def release(self) -> None:
        """Drops the program's state: its world, functions and blocks."""
        import torch

        for name in ("world", "fns", "blocks", "grid"):
            self.__dict__.pop(name, None)
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def assemble(self, out):
        """The whole grid of a solve's output."""
        import torch

        if torch.is_tensor(out):
            return out
        rows = []
        for r in range(self.px):
            rows.append(torch.cat(
                [out[self.coords.index((r, c))] for c in range(self.py)],
                dim=1))
        return torch.cat(rows, dim=0)

    def compare(self, outputs) -> dict:
        """The widest gap of the kept solves' grids to the reference's
        float32 sweeps of the same seeded grid."""
        grid = reference.make_grid(self.gh, self.gw, self.seed, self.device)
        ref = reference.jacobi(grid, self.sweeps)
        del grid
        gap = max(reference.max_abs_err(self.assemble(o), ref)
                  for o in outputs)
        return {"grid_max_abs_err": gap}
