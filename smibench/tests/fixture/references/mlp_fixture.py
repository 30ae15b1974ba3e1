"""Plain reference of the fixture's MLP stage: its inputs made from the
seed, and ``h = h + relu(h @ w1) @ w2`` layer by layer in the precision
asked for."""

from __future__ import annotations

import torch


def make_inputs(config: dict, tokens: int, seed: int, device):
    """The stage's input rows ``(tokens, hidden)`` and each layer's two
    matrices, normal from the seed and scaled by their fan-in."""
    h, f = int(config["hidden_size"]), int(config["intermediate_size"])
    layers = int(config["num_hidden_layers"])
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % 2**63)
    x = torch.randn((tokens, h), generator=gen, device=device)
    w1 = torch.randn((layers, h, f), generator=gen, device=device) * h**-0.5
    w2 = torch.randn((layers, f, h), generator=gen, device=device) * f**-0.5
    return x, w1, w2


def forward(x, w1, w2, dtype: torch.dtype = torch.float64) -> torch.Tensor:
    """The stage's output computed in ``dtype``; returns float64."""
    h = x.to(dtype)
    for a, b in zip(w1.to(dtype), w2.to(dtype)):
        h = h + torch.relu(h @ a) @ b
    return h.to(torch.float64)


def max_abs_err(out: torch.Tensor, ref: torch.Tensor) -> float:
    if tuple(out.shape) != tuple(ref.shape):
        return float("inf")
    return float((out.to(ref.device, torch.float64) - ref).abs().max())
