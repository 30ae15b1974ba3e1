"""An expert layer that holds some of a router's experts.

Under expert parallelism each rank of a layer holds a share of its
experts. This layer is told which ones (``ExpertConfig.held``): it scores
every token against all of the router's experts, picks each token's
``topk``, and computes its held experts' part of the result for the
tokens routed to them, plus the shared expert that every rank holds
whole. The absent experts' part is left out: on one rank the layer runs
without its exchange, so what it returns is this rank's share of the
layer, as one rank of the deployment computes it.

Routing, in f32 over all ``router`` experts (``afmoe``'s sigmoid
router): ``s = sigmoid(x Wr)``, ``sel = topk(s)``, ``w = s[sel] /
sum(s[sel]) * route_scale`` (the sum over all ``topk`` choices, held or
not). Each expert, and the shared one, is a SwiGLU ``W2(silu(W1 x) * W3
x)``. No token is dropped: the layer has no capacity factor, and an
expert takes every token routed to it.

The held assignments are sorted by expert and gathered once; each of an
expert's three matrices is one grouped product over all held experts
(``torch._grouped_mm``, one product per expert on its rows, their
offsets on the device). The count of held assignments crosses to the
host once a step (:data:`COUNTERS` ``"host_reads"``) to size the
gathered rows: the recompute of a checkpointed layer reuses its
forward's routing. The weighted outputs are added
into the token rows in f32 (``index_add_``).

Spans (``utils/tracing.annotate``), siblings, never nested:
``smi.moe.route``, ``smi.moe.dispatch`` (sort and counts; then the wait
for the read, the gather), ``smi.moe.experts`` (the shared expert,
queued while the counts cross; then the held ones) and
``smi.moe.combine``.
"""

from __future__ import annotations

import dataclasses
import functools
import threading
from typing import Callable, Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from smi_tpu_torch.utils.tracing import annotate

#: the layer's counters, kept as ``kernels/_build.LAUNCHES`` keeps
#: launches, each counted at the layer's device->host read (a recompute
#: that reuses its routing reads nothing and counts nothing): the reads,
#: the held assignments routed here, and the most tokens one held expert
#: took in a call
COUNTERS: Dict[str, int] = {"held_assignments": 0, "max_expert_load": 0,
                            "host_reads": 0}
_count_lock = threading.Lock()


def reset_counters() -> None:
    with _count_lock:
        for name in COUNTERS:
            COUNTERS[name] = 0


@dataclasses.dataclass(frozen=True)
class ExpertConfig:
    #: experts the router scores (the published count)
    router: int
    #: experts each token picks
    topk: int
    #: hidden width of each expert
    width: int
    #: expert ids this rank holds, in the order of the stacked weights
    held: Tuple[int, ...]
    #: shared experts, every rank holding them whole (one SwiGLU of
    #: ``shared * width``)
    shared: int = 1
    route_scale: float = 1.0
    route_norm: bool = True

    def __post_init__(self):
        held = tuple(int(e) for e in self.held)
        if len(set(held)) != len(held) or not all(
                0 <= e < self.router for e in held):
            raise ValueError(f"held experts {held} must be distinct ids "
                             f"below {self.router}")
        if not 1 <= self.topk <= self.router:
            raise ValueError(f"topk {self.topk} must lie in [1, "
                             f"{self.router}]")
        object.__setattr__(self, "held", held)


@functools.lru_cache(maxsize=None)
def _slots(cfg: ExpertConfig, device: torch.device) -> torch.Tensor:
    """Each expert's place among the held ones (``len(held)``: absent),
    made once a configuration and device: a copy to the card from the
    host waits for the card."""
    slots = torch.full((cfg.router,), len(cfg.held), dtype=torch.long)
    slots[list(cfg.held)] = torch.arange(len(cfg.held))
    return slots.to(device)


def swiglu(x, w1, w3, w2, mm: Callable):
    """``W2(silu(W1 x) * W3 x)`` with the product ``mm``."""
    return mm(F.silu(mm(x, w1)) * mm(x, w3), w2)


def _read(counts: torch.Tensor) -> Callable[[], list]:
    """Starts the copy of ``counts`` to the host; the function returned
    waits for it and gives the list. On a card the copy lands in pinned
    memory behind an event, so the host may queue more work first."""
    if counts.device.type != "cuda":
        return counts.tolist
    host = torch.empty(counts.shape, dtype=counts.dtype, pin_memory=True)
    host.copy_(counts, non_blocking=True)
    done = torch.cuda.Event()
    done.record()

    def wait() -> list:
        done.synchronize()
        return host.tolist()

    return wait


def _count(loads) -> None:
    with _count_lock:
        COUNTERS["host_reads"] += 1
        COUNTERS["held_assignments"] += sum(loads)
        COUNTERS["max_expert_load"] = max(COUNTERS["max_expert_load"],
                                          max(loads, default=0))


def expert_layer(params: Mapping[str, torch.Tensor], x: torch.Tensor,
                 cfg: ExpertConfig, mm: Callable, dtype: torch.dtype,
                 cache: Optional[dict] = None) -> torch.Tensor:
    """This rank's share of the layer on ``x`` ``(T, E)`` f32: its held
    experts' weighted outputs plus the shared expert, f32.

    ``mm(a, w)`` is the block's product (in ``dtype``, rounded, widened);
    each operand is cast to ``dtype`` once. ``cache``, when given, is
    filled by the layer's first call with its routing (``"sel"``, each
    token's expert ids ``(T, topk)``, and ``"loads"``, each held
    expert's tokens); a later call with the same dict (the recompute of
    a checkpointed layer) routes as the first did and reads nothing from
    the device. The bias ``afmoe`` adds to the scores for the choice is
    held at 0, so the choice is ``topk(s)``."""
    k, n_held = cfg.topk, len(cfg.held)
    again = cache is not None and "loads" in cache
    with annotate("smi.moe.route"):
        scores = torch.sigmoid(x @ params["router"])
        sel = (cache["sel"] if again
               else scores.detach().topk(k, dim=-1).indices)
        w = scores.gather(-1, sel)
        if cfg.route_norm:
            w = w / w.sum(-1, keepdim=True)
        w = w * cfg.route_scale
    with annotate("smi.moe.dispatch"):
        slot = _slots(cfg, x.device)[sel].reshape(-1)         # (T * k,)
        order = torch.argsort(slot, stable=True)
        counts = (slot[:, None] == torch.arange(
            n_held, device=x.device)).sum(0)
        read = None if again else _read(counts)
    with annotate("smi.moe.experts"):
        # queued while the counts cross to the host, so the card has
        # work when the host resumes
        shared = swiglu(x.to(dtype), params["shared_w1"],
                        params["shared_w3"], params["shared_w2"], mm)
    with annotate("smi.moe.dispatch"):
        if again:
            loads = cache["loads"]
        else:
            loads = read()               # the layer's device->host read
            _count(loads)
            if cache is not None:
                cache.update(sel=sel, loads=loads)
        order = order[:sum(loads)]       # held assignments, by expert
        tokens = torch.div(order, k, rounding_mode="floor")
        rows = x[tokens].to(dtype)
        weights = w.reshape(-1)[order]
        offs = counts.cumsum(0).to(torch.int32)

    def grouped(a, name):
        """One product per held expert on its rows, in one launch,
        rounded to ``dtype`` and widened."""
        return torch._grouped_mm(a, params[name].to(dtype), offs=offs).float()

    with annotate("smi.moe.experts"):
        h = F.silu(grouped(rows, "experts_w1")) * grouped(rows, "experts_w3")
        y = grouped(h.to(dtype), "experts_w2")
    with annotate("smi.moe.combine"):
        out = torch.zeros_like(x).index_add_(0, tokens, y * weights[:, None])
        return out + shared


def param_shapes(embed: int, cfg: ExpertConfig) -> Dict[str, tuple]:
    """The shape of each of the layer's weights, by name: the router
    ``(E, router)``, the held experts stacked ``(n_held, E, width)`` /
    ``(n_held, width, E)`` in the order of ``held``, the shared expert
    ``(E, shared * width)`` / ``(shared * width, E)``."""
    n, f, fs = len(cfg.held), cfg.width, cfg.shared * cfg.width
    return {"router": (embed, cfg.router), "experts_w1": (n, embed, f),
            "experts_w3": (n, embed, f), "experts_w2": (n, f, embed),
            "shared_w1": (embed, fs), "shared_w3": (embed, fs),
            "shared_w2": (fs, embed)}
