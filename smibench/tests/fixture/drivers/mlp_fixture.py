"""Driver of the fixture's MLP stage: one solve is the stage's forward
pass over the cell's tokens in float32, plain ``torch`` matmuls; the
control runs the reference in bfloat16."""

from __future__ import annotations

import torch

from smibench import spec

reference = spec.load_module("references", "mlp_fixture")


class Cell:
    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 program: str = "port"):
        if program not in ("port", "control"):
            raise ValueError(f"unknown program {program!r}")
        self.config, self.seed, self.device = config, seed, device
        self.program = program
        self.tokens = int(traffic["tokens"])
        h, f = int(config["hidden_size"]), int(config["intermediate_size"])
        layers = int(config["num_hidden_layers"])
        self.work = {"flops": 2 * 2 * self.tokens * h * f * layers}
        self.facts = {"tokens": self.tokens}
        self.x, self.w1, self.w2 = reference.make_inputs(
            config, self.tokens, seed, device)

    def warm(self) -> None:
        for _ in range(2):
            self.solve()

    def solve(self):
        if self.program == "control":
            return reference.forward(self.x, self.w1, self.w2, torch.bfloat16)
        h = self.x
        for a, b in zip(self.w1, self.w2):
            h = h + torch.relu(h @ a) @ b
        return h

    def reset_counters(self) -> None:
        pass

    def counters(self) -> dict:
        return {}

    def release(self) -> None:
        for name in ("x", "w1", "w2"):
            self.__dict__.pop(name, None)

    def compare(self, outputs) -> dict:
        """The widest gap of the kept outputs to the reference's float64
        pass over the same seeded inputs."""
        x, w1, w2 = reference.make_inputs(self.config, self.tokens,
                                          self.seed, self.device)
        ref = reference.forward(x, w1, w2)
        return {"out_max_abs_err": max(reference.max_abs_err(o, ref)
                                       for o in outputs)}
