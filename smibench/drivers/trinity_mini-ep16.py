"""Driver of the Trinity-Mini (``afmoe``) configuration: one solve is one
training step of the port's :class:`LanguageModel` through
``make_train_step`` on a one-card 1x1 ``(dp, sp)`` communicator: the
forward, the loss, the backward and the SGD update in place.

Set-up draws the weights from the seed on the card and keeps a copy of
the f32 master weights there; each solve first restores the weights
from it, so step ``i`` is a function of (seed, ``i``) alone and the
reference can judge any kept step. The step's batch is drawn from
(seed, ``i``) by the reference. A solve's output is small and on the
card: the loss, the gradients of the probe weights (by the reference's
names, of the mean loss), one weight after the update, and the expert
ids every expert layer chose (the reference takes them when it judges
the step).
"""

from __future__ import annotations

import gc
import json
import math
import sys

from smibench import afmoe, spec

reference = spec.load_module("references", "trinity_mini-ep16")

#: the flash kernels' sources a step launches
SOURCES = ("flash_fwd", "flash_bwd")


def probes(config: dict):
    """``(grads, updated)``: the weights whose gradients a solve gives,
    and the one it gives after the update. The first dense layer's
    ``wq`` and ``w2``; the first expert layer's router, the held
    experts' three matrices and the shared expert's down matrix; the
    first full layer's ``wg``, ``wq`` and its q and k norms; the last
    layer's router; the final norm."""
    dense = config["num_dense_layers"]
    full = config["layer_types"].index("full_attention")
    last = config["num_hidden_layers"] - 1
    names = [f"layers.0.{n}" for n in ("wq", "w2")]
    names += [f"layers.{dense}.{n}" for n in (
        "router", "experts_w1", "experts_w3", "experts_w2", "shared_w2")]
    names += [f"layers.{full}.{n}" for n in ("wg", "wq", "q_norm", "k_norm")]
    names += [f"layers.{last}.router", "final_norm"]
    return names, "layers.0.wq"


def route_layers(config: dict):
    """The layers whose expert choices are held against the reference's
    own: the first expert layer and the last."""
    return (config["num_dense_layers"], config["num_hidden_layers"] - 1)


def probe_gaps(got: dict, want: dict) -> dict:
    """Each probe's relative gap by name; the held experts' stacked
    matrices expert by expert, as ``<name>[<slot>]``, so that an expert
    left out reads 1 whatever the others read."""
    gaps = {}
    for name, g in want.items():
        if ".experts_" in name:
            for e in range(g.shape[0]):
                gaps[f"{name}[{e}]"] = _rel(got[name][e], g[e])
        else:
            gaps[name] = _rel(got[name], g)
    return gaps


def _rel(got, want) -> float:
    """``|got - want| / |want|`` in float64 (0 where both are 0)."""
    num = float((got.double() - want.double()).norm())
    den = float(want.double().norm())
    return num / den if den else (0.0 if num == 0 else math.inf)


class Cell:
    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 program: str = "port"):
        if program not in ("port", "control"):
            raise ValueError(f"unknown program {program!r}")
        self.device = device
        self.seed = seed
        self.program = program
        self.config = config
        self.batch, self.seq = int(traffic["batch"]), int(traffic["seq"])
        self.zipf = float(traffic["zipf_s"])
        self.lr = float(config["optimizer"]["lr"])
        self.probes, self.updated = probes(config)
        self.route_layers = route_layers(config)
        self.expert_layers = range(config["num_dense_layers"],
                                   config["num_hidden_layers"])
        self.index = 0
        self.work = {"flops": afmoe.step_flops(config, self.batch, self.seq)}
        self.facts = {
            "batch": self.batch, "seq": self.seq,
            "heads": config["num_attention_heads"],
            "kv_heads": config["num_key_value_heads"],
            "head_dim": config["head_dim"],
            "windows": afmoe.layer_windows(config),
            "mean_live_pairs": afmoe.mean_live_pairs(config, self.seq),
            "held_experts": config["num_experts"],
            "router_experts": config.get("router_experts",
                                         config["num_experts"]),
        }
        if program == "control":
            self.weights = reference.make_weights(config, seed, device)
            return

        from smi_tpu_torch.kernels import _build
        from smi_tpu_torch.models import moe, transformer
        from smi_tpu_torch.parallel.mesh import make_communicator

        self._build, self._moe = _build, moe
        weights = reference.make_weights(config, seed, device)
        self.model = transformer.LanguageModel.from_config(
            config, weights=weights, compute_dtype=config["compute_dtype"],
            device=device)
        del weights
        self.params = list(self.model.parameters())
        self.master = [p.detach().clone() for p in self.params]
        comm = make_communicator(shape=(1, 1), axis_names=("dp", "sp"),
                                 device=device)
        self.step = transformer.make_train_step(
            comm, self.model.config, lr=self.lr,
            layers=len(self.model.blocks))

    def _sync(self):
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _batch(self, index: int):
        return reference.make_batch(self.config["vocab_size"], self.batch,
                                    self.seq, self.zipf, self.seed, index,
                                    self.device)

    def warm(self) -> None:
        """Builds the flash kernels (the first run of a checkout compiles)
        and runs two steps. The control compiles nothing."""
        if self.program != "port":
            return
        if self.device.type == "cuda":
            self._build.build_kernels(list(SOURCES))
        for _ in range(2):
            self.solve()
        # as in a long training loop, the set-up's objects (the
        # interpreter's modules, the model) leave the collector: a full
        # pass over them took 0.20-0.31 s every ~5 steps on the card's
        # host. The collector still runs during steps, over what they
        # make (a step leaves 7 small objects in a cycle a checkpointed
        # layer, torch's pytree flattening helper, none of them a tensor)
        gc.collect()
        gc.freeze()

    def solve(self):
        import torch

        index = self.index
        self.index += 1
        ids, labels = self._batch(index)
        if self.program == "control":
            chosen = {i: [] for i in self.expert_layers}
            loss, grads = reference.loss_and_grads(
                self.weights, ids, labels, self.config, names=self.probes,
                round_fn=reference.fp8_round, routes=chosen)
            after = self.weights[self.updated] - self.lr * grads[
                self.updated]
            routes = {i: r[0] for i, r in chosen.items()}
        else:
            with torch.no_grad():
                torch._foreach_copy_(self.params, self.master)
            loss = self.step(self.model, ids, labels)
            sums = self.model.reference_names(grads=True)
            grads = {n: sums[n] / ids.numel() for n in self.probes}
            after = self.model.reference_names()[self.updated].detach(
            ).clone()
            routes = {i: self.model.routing[i]["sel"]
                      for i in self.expert_layers}
        out = {"step": index, "loss": loss.detach().reshape(()),
               "grads": grads, "after": after,
               "routes": {i: r.to(torch.int16) for i, r in routes.items()}}
        self._sync()
        return out

    def reset_counters(self) -> None:
        if self.program == "port":
            self._build.reset_launches()
            self._moe.reset_counters()

    def counters(self) -> dict:
        if self.program != "port":
            return {}
        return {f"moe_{k}": v for k, v in self._moe.COUNTERS.items()}

    def release(self) -> None:
        """Drops the program's state (its model, master copy, step and
        weights) and returns the set-up's objects to the collector."""
        import torch

        for name in ("model", "params", "master", "step", "weights"):
            self.__dict__.pop(name, None)
        gc.unfreeze()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def compare(self, outputs) -> dict:
        """Against the float32 reference of the same seeded weights and
        the step's batch, its tokens taking the experts the judged run
        chose in every expert layer (a choice that rounding flips near a
        tie would move an expert's or a router's gradient by a whole
        token's share): the loss's gap; the widest relative gap of a
        probe's gradient, the held experts' expert by expert; the
        relative gap of the update; and the share of tokens in the two
        route layers whose choice differs from the reference's own.
        Each is the worst over the kept solves; each probe's gap goes to
        stderr, a line a solve.
        """
        import torch

        weights = reference.make_weights(self.config, self.seed, self.device)
        found = {"loss_abs_err": 0.0, "grad_rel_err": 0.0,
                 "update_rel_err": 0.0, "route_mismatch_pct": 0.0}
        for out in outputs:
            ids, labels = self._batch(out["step"])
            own = {i: [] for i in self.route_layers}
            loss, grads = reference.loss_and_grads(
                weights, ids, labels, self.config, names=self.probes,
                routes=own, forced={i: r.long()
                                    for i, r in out["routes"].items()})
            step = self.lr * grads[self.updated]
            want = weights[self.updated] - step
            differ = [
                (out["routes"][i].long().sort(-1).values
                 != own[i][0].sort(-1).values).any(-1).double().mean()
                for i in self.route_layers]
            gaps = probe_gaps(out["grads"], grads)
            print(json.dumps({"step": out["step"], "probe_rel_err": gaps}),
                  file=sys.stderr, flush=True)
            readings = {
                "loss_abs_err": abs(float(out["loss"]) - float(loss)),
                "grad_rel_err": max(gaps.values()),
                "update_rel_err": float((out["after"].double()
                                         - want.double()).norm()
                                        / step.double().norm()),
                "route_mismatch_pct": 100.0 * float(torch.stack(differ)
                                                    .mean()),
            }
            for name, value in readings.items():
                # a NaN reading stays NaN (``max`` would drop it)
                if not value <= found[name]:
                    found[name] = value
            del grads, want, step
        return found
