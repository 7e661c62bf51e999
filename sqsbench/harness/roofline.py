"""The yardstick's arithmetic: published H100 peaks, the bytes each SQS
kernel needs from its call's shapes, and the FLOPs the window's model
work needs from the configuration's shapes.

Peaks (NVIDIA H100 SXM data sheet, dense, at the 700 W limit): 989
TFLOP/s bf16 on the tensor cores, 3.35 TB/s of HBM.  The SQS kernels
are bound by bytes: ``sqs_fused`` reads each padded vocabulary entry's
float32 logit and writes its int32 count and mask (12 B an entry),
``topk_threshold`` reads the logit (4 B an entry).  Model FLOPs count
2 per multiply-add of every weight a token passes through (a MoE token:
the router, its top k experts and the shared experts, never the experts
it is not routed to) and the attention over the context it attends to;
work the system does beyond that (the dropless buffer's other experts,
masked cache slots) is not counted, so it shows as time.
"""
from __future__ import annotations

PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
LANE = 128


def padded_vocab(V: int) -> int:
    return -(-V // LANE) * LANE


def sqs_bytes(rows: int, V: int) -> float:
    return 12.0 * rows * padded_vocab(V)


def topk_bytes(rows: int, V: int) -> float:
    return 4.0 * rows * padded_vocab(V)


def bytes_roofline_pct(nbytes: float, seconds: float):
    """Share (%) of the HBM roofline: the least time over the time taken;
    None when the kernel did not run."""
    if seconds <= 0 or nbytes <= 0:
        return None
    return 100.0 * (nbytes / PEAK_HBM_BYTES) / seconds


def weight_flops_per_token(cfg: dict, head: bool = True) -> float:
    """2 x the weights one token multiplies through (with the head or
    not)."""
    d, nq, nkv, hd, V = (cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"],
                         cfg["head_dim"], cfg["vocab"])
    attn = d * (nq + 2 * nkv) * hd + nq * hd * d
    if "moe" in cfg.get("ffn_pattern", ["mlp"]):
        f = cfg["d_expert"]
        ffn = d * cfg["n_experts"] + 3 * d * f * (cfg["moe_top_k"]
                                                  + cfg["n_shared_experts"])
    else:
        ffn = 3 * d * cfg["d_ff"]
    return 2.0 * (cfg["n_layers"] * (attn + ffn) + (d * V if head else 0))


def attn_flops(cfg: dict, context: float) -> float:
    """Scores and weighted values of one query over ``context`` keys, all
    layers."""
    return 4.0 * cfg["n_layers"] * cfg["n_heads"] * cfg["head_dim"] * context


def prefill_flops(cfg: dict, S: int) -> float:
    """A prompt of S tokens (causal: S (S + 1) / 2 query-key pairs), the
    head at its last position only."""
    return (S * weight_flops_per_token(cfg, head=False)
            + 2.0 * cfg["d_model"] * cfg["vocab"]
            + attn_flops(cfg, S * (S + 1) / 2))


def step_flops(cfg: dict, rows: int, queries: int, context: float) -> float:
    """``rows`` sequences each extending by ``queries`` tokens over a mean
    context of ``context`` keys."""
    return rows * queries * (weight_flops_per_token(cfg)
                             + attn_flops(cfg, context))
