"""The arithmetic of the ``deepseek_v3`` training cells (Moonlight-16B-A3B):
the model's operations in a training step, and the flash kernels'
operations a launch of their split form (queries and keys 192 wide,
values 128).

Nothing here asks the program: every function takes the configuration's
keys and the cell's shapes. As in :mod:`smibench.afmoe`, a product's
multiply and add count as two operations, a training step as three
forwards (the recompute under checkpointing is not counted), and the
expert layer's work as the held experts' share of the average load.
Every layer attends causally over the whole sequence.
"""

from __future__ import annotations

import re
from typing import List, Tuple

from smibench.afmoe import BF16_FLOPS, live_pairs, train_steps  # noqa: F401

#: the flash kernels a training step launches: the forward, dq and dk/dv
FLASH_KERNELS = ("flash_bf16_kernel", "flash_dq_bf16_kernel",
                 "flash_dkdv_bf16_kernel")


def head_dims(config: dict) -> Tuple[int, int]:
    """``(d_qk, d_v)``: the query and key head dim (the dims without
    positions and the rotated ones) and the value head dim."""
    return (config["qk_nope_head_dim"] + config["qk_rope_head_dim"],
            config["v_head_dim"])


def flash_ops_per_pair(kernel: str, d_qk: int, d_v: int) -> int:
    """Operations a live (query, key) pair and head of each flash kernel:
    the forward (Q K^T and P V) 2 (d_qk + d_v), dq (Q K^T, dO V^T, dS K)
    4 d_qk + 2 d_v, dk/dv (Q K^T, dO V^T, P^T dO, dS^T Q) 4 d_qk + 4 d_v;
    640, 1024 and 1280 at (192, 128)."""
    return {"flash_bf16_kernel": 2 * (d_qk + d_v),
            "flash_dq_bf16_kernel": 4 * d_qk + 2 * d_v,
            "flash_dkdv_bf16_kernel": 4 * d_qk + 4 * d_v}[kernel]


def forward_flops(config: dict, batch: int, seq: int) -> float:
    """The forward pass's operations over ``batch`` sequences of ``seq``
    tokens: the latent attention's products (``Wq``, ``Wkv_a``,
    ``Wkv_b``, ``Wo``) and core, the dense and the expert layers, and the
    head."""
    e, h = config["hidden_size"], config["num_attention_heads"]
    d_qk, d_v = head_dims(config)
    c = config["kv_lora_rank"]
    tokens = batch * seq
    proj = 2 * tokens * (e * h * d_qk + e * (c + config["qk_rope_head_dim"])
                         + c * h * (config["qk_nope_head_dim"] + d_v)
                         + h * d_v * e)
    core = 2 * (d_qk + d_v) * h * batch * live_pairs(seq, None)
    router = config.get("router_experts", config["n_routed_experts"])
    fe = config["moe_intermediate_size"]
    held_share = config["n_routed_experts"] / router
    dense = 2 * tokens * 3 * e * config["intermediate_size"]
    moe = 2 * tokens * (e * router
                        + 3 * e * fe * config["n_shared_experts"]
                        + 3 * e * fe * config["num_experts_per_tok"]
                        * held_share)
    layers = config["num_hidden_layers"]
    n_dense = config["first_k_dense_replace"]
    head = 2 * tokens * e * config["vocab_size"]
    return (layers * (proj + core) + n_dense * dense
            + (layers - n_dense) * moe + head)


def step_flops(config: dict, batch: int, seq: int) -> float:
    """A training step's model operations: three forwards."""
    return 3 * forward_flops(config, batch, seq)


def split_form_launches(trace, kernel: str, d_qk: int, d_v: int
                        ) -> List[Tuple[str, float, float]]:
    """The device operations of ``kernel``'s instance at head dims
    ``(d_qk, d_v)``, whose template arguments open ``<d_qk, d_v``."""
    form = re.compile(re.escape(kernel) + rf"<{d_qk}, {d_v}[,>]")
    return [op for op in trace.ops_named(kernel) if form.search(op[0])]


def flash_launch_ops(kernel: str, facts: dict) -> float:
    """Operations one launch of a flash kernel does on the cell's
    attention: every head of the folded batch over one layer's live
    pairs."""
    return (flash_ops_per_pair(kernel, facts["qk_head_dim"],
                               facts["v_head_dim"])
            * facts["batch"] * facts["heads"] * facts["live_pairs"])
