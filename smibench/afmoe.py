"""The arithmetic of the ``afmoe`` training cells (Trinity-Mini): the
live (query, key) pairs of causal and windowed attention, the model's
operations in a training step, and the flash kernels' operations a
launch; and the training steps a trace shows.

Nothing here asks the program: every function takes the configuration's
keys and the cell's shapes. The model's work counts each product's
multiply and add as two operations, the forward once and the backward
at twice the forward (a training step's work is three forwards; the
recompute under checkpointing is not counted). The expert layer's work
is what the held experts would do at the average load: each token's
``num_experts_per_tok`` choices spread over the router's experts, the
held share of them computed here.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

#: NVIDIA H100 SXM data sheet, dense bf16 at a 700 W power limit
BF16_FLOPS = 989e12

#: operations a live pair and head dim of each flash kernel: the forward
#: (Q K^T and P V), dq (Q K^T, dO V^T, dS K) and dk/dv (Q K^T, dO V^T,
#: P^T dO, dS^T Q), two a multiply-add
FLASH_OPS_PER_PAIR = {"flash_bf16_kernel": 4, "flash_dq_bf16_kernel": 6,
                      "flash_dkdv_bf16_kernel": 8}

#: the span around one training step
STEP_SPAN = "smi.train.step"


def live_pairs(seq: int, window: Optional[int]) -> int:
    """(query, key) pairs a causal sequence of ``seq`` positions attends,
    each query seeing itself and the ``window - 1`` positions before it
    (all before it where ``window`` is None)."""
    if window is None or window >= seq:
        return seq * (seq + 1) // 2
    return window * (window + 1) // 2 + (seq - window) * window


def layer_windows(config: dict) -> List[Optional[int]]:
    """Each layer's attention window (None: full)."""
    return [config["sliding_window"] if t == "sliding_attention" else None
            for t in config["layer_types"]]


def mean_live_pairs(config: dict, seq: int) -> float:
    """The live pairs of one sequence, averaged over the layers."""
    windows = layer_windows(config)
    return sum(live_pairs(seq, w) for w in windows) / len(windows)


def forward_flops(config: dict, batch: int, seq: int) -> float:
    """The forward pass's operations over ``batch`` sequences of ``seq``
    tokens: the attention block's products and core, the dense and the
    expert layers, and the head."""
    e, d = config["hidden_size"], config["head_dim"]
    hd = config["num_attention_heads"] * d
    kvd = config["num_key_value_heads"] * d
    tokens = batch * seq
    router = config.get("router_experts", config["num_experts"])
    fe = config["moe_intermediate_size"]
    held_share = config["num_experts"] / router
    proj = 2 * tokens * (e * (2 * hd + 2 * kvd) + hd * e)   # q k v g, o
    core = sum(4 * d * config["num_attention_heads"] * batch
               * live_pairs(seq, w) for w in layer_windows(config))
    dense = 2 * tokens * 3 * e * config["intermediate_size"]
    moe = 2 * tokens * (e * router
                        + 3 * e * fe * config["num_shared_experts"]
                        + 3 * e * fe * config["num_experts_per_tok"]
                        * held_share)
    n_dense = config["num_dense_layers"]
    n_moe = config["num_hidden_layers"] - n_dense
    head = 2 * tokens * e * config["vocab_size"]
    return (config["num_hidden_layers"] * proj + core + n_dense * dense
            + n_moe * moe + head)


def step_flops(config: dict, batch: int, seq: int) -> float:
    """A training step's model operations: three forwards."""
    return 3 * forward_flops(config, batch, seq)


def flash_launch_ops(kernel: str, facts: dict) -> float:
    """Operations one launch of a flash kernel does on the cell's
    attention: every head of the folded batch over the layers' mean live
    pairs, so a layer's launches count alike whichever layer they
    serve."""
    return (FLASH_OPS_PER_PAIR[kernel] * facts["batch"] * facts["heads"]
            * facts["head_dim"] * facts["mean_live_pairs"])


def train_steps(trace) -> List[Tuple[str, float, float]]:
    """The training-step spans wholly inside the traced window; none
    without a trace or where the trace shows no device work."""
    if trace is None or not trace.device_ops:
        return []
    lo, hi = trace.window
    return [op for op in trace.host_ops
            if op[0] == STEP_SPAN and lo <= op[1] and op[2] <= hi]
