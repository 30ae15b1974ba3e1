"""Driver of the Moonlight-16B-A3B (``deepseek_v3``) configuration: one
solve is one training step of the port's :class:`LanguageModel` through
``make_train_step`` on a one-card 1x1 ``(dp, sp)`` communicator: the
forward, the loss, the backward and the SGD update in place. Every layer
runs latent attention on the flash kernels' split form (queries and
keys 192 wide, values 128).

As in the Trinity cell, set-up draws the weights from the seed on the
card and keeps a copy of the f32 master weights there; each solve first
restores the weights from it, so step ``i`` is a function of (seed,
``i``) alone and the reference can judge any kept step. A solve's output
is small and on the card: the loss, the gradients of the probe weights
(by the reference's names, of the mean loss), one weight after the
update, and the expert ids every expert layer chose (the reference
takes them when it judges the step).
"""

from __future__ import annotations

import gc
import json
import sys

from smibench import mla, spec

reference = spec.load_module("references", "moonlight_16b_a3b-ep8")
#: the Trinity cell's driver: the probes' gaps are measured alike
_trinity = spec.load_module("drivers", "trinity_mini-ep16")

#: the flash kernels' sources a step launches
SOURCES = ("flash_fwd", "flash_bwd")


def probes(config: dict):
    """``(grads, updated)``: the weights whose gradients a solve gives,
    and the one it gives after the update. The dense layer's latent
    attention (``wq``, ``wkv_a``, the latent norm, ``wkv_b``, ``wo``) and
    ``w2``; the first expert layer's held experts' three matrices and the
    shared experts' down matrix; the last layer's ``wkv_a`` and latent
    norm; the final norm; and every expert layer's router, judged
    together (:func:`probe_gaps`)."""
    first = config["first_k_dense_replace"]
    last = config["num_hidden_layers"] - 1
    names = [f"layers.0.{n}" for n in ("wq", "wkv_a", "kv_norm", "wkv_b",
                                       "wo", "w2")]
    names += [f"layers.{first}.{n}" for n in (
        "experts_w1", "experts_w3", "experts_w2", "shared_w2")]
    names += [f"layers.{last}.{n}" for n in ("wkv_a", "kv_norm")]
    names += ["final_norm"]
    return names + routers(config), "layers.0.wq"


def routers(config: dict):
    """The routers' names, one an expert layer."""
    return [f"layers.{i}.router" for i in range(
        config["first_k_dense_replace"], config["num_hidden_layers"])]


def probe_gaps(got: dict, want: dict, names) -> dict:
    """Each probe's relative gap by name, as the Trinity cell's (the held
    experts' matrices expert by expert), but for the routers ``names``:
    one gap over their gradients stacked, ``"routers"``. A layer's router
    gradient is a sum over tokens that nearly cancels on some seeds, and
    its own relative gap then swings with that cancellation, not with the
    program; stacked, each layer weighs by its size."""
    import torch

    gaps = _trinity.probe_gaps(got, {n: g for n, g in want.items()
                                     if n not in names})
    gaps["routers"] = _trinity._rel(
        torch.cat([got[n].reshape(-1) for n in names]),
        torch.cat([want[n].reshape(-1) for n in names]))
    return gaps


def route_layers(config: dict):
    """The layers whose expert choices are held against the reference's
    own: the first expert layer and the last."""
    return (config["first_k_dense_replace"], config["num_hidden_layers"] - 1)


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
        self.expert_layers = range(config["first_k_dense_replace"],
                                   config["num_hidden_layers"])
        self.index = 0
        self.work = {"flops": mla.step_flops(config, self.batch, self.seq)}
        d_qk, d_v = mla.head_dims(config)
        self.facts = {
            "batch": self.batch, "seq": self.seq,
            "heads": config["num_attention_heads"],
            "qk_head_dim": d_qk, "v_head_dim": d_v,
            "live_pairs": mla.live_pairs(self.seq, None),
            "held_experts": config["n_routed_experts"],
            "router_experts": config.get("router_experts",
                                         config["n_routed_experts"]),
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
        # as in the Trinity cell: the set-up's objects leave the collector
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
        chose in every expert layer: the widest relative gap of a probe's
        gradient, the held experts' expert by expert and the routers
        together; the relative gap of the update; and the share of tokens
        in the two route layers whose choice differs from the reference's
        own. Each is the worst over the kept solves. Each probe's gap,
        each router's own and the loss's gap go to stderr, a line a
        solve: the loss is not judged here, since the float8 control's
        gap lies within three times the program's."""
        import torch

        weights = reference.make_weights(self.config, self.seed, self.device)
        found = {"grad_rel_err": 0.0, "update_rel_err": 0.0,
                 "route_mismatch_pct": 0.0}
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
            names = routers(self.config)
            gaps = probe_gaps(out["grads"], grads, names)
            own_gaps = {n: _trinity._rel(out["grads"][n], grads[n])
                        for n in names}
            print(json.dumps({"step": out["step"], "probe_rel_err": gaps,
                              "router_rel_err": own_gaps,
                              "loss_abs_err": abs(float(out["loss"])
                                                  - float(loss))}),
                  file=sys.stderr, flush=True)
            readings = {
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
