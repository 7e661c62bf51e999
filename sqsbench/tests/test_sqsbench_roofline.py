"""The yardstick's byte and FLOP counts from shapes."""
import json
import math
import pathlib

import pytest

from harness import roofline
from reference import decoder

HERE = pathlib.Path(__file__).resolve().parent
# the served pair, and the smoke pair for the mixture-of-experts count
PAIRS = [HERE.parent / "configs" / "gptneo-pair.json",
         HERE / "data" / "smoke-pair.json"]


def test_sqs_bytes():
    assert roofline.padded_vocab(50257) == 50304
    assert roofline.padded_vocab(151936) == 151936
    assert roofline.sqs_bytes(64, 50257) == 12 * 64 * 50304
    assert roofline.topk_bytes(32, 151936) == 4 * 32 * 151936
    assert roofline.bytes_roofline_pct(3.35e12, 1.0) == pytest.approx(100.0)
    assert roofline.bytes_roofline_pct(1.0, 0.0) is None


@pytest.mark.parametrize("path", PAIRS, ids=lambda p: p.stem)
def test_weight_flops_count_each_weight_a_token_meets(path):
    pair = json.loads(path.read_text())
    for cfg in (pair["edge"], pair["cloud"]):
        per = {}
        for leaf, shape, kind, init, _ in decoder.leaves(cfg):
            if init == "normal" and leaf != "embedding":
                per[leaf] = math.prod(shape)
        if cfg.get("tie_embeddings"):
            per["head"] = cfg["vocab"] * cfg["d_model"]
        if "moe" in cfg.get("ffn_pattern", []):
            # a token meets top_k of the routed experts, not all of them
            E, k = cfg["n_experts"], cfg["moe_top_k"]
            for leaf in list(per):
                if ".moe.w_" in leaf:
                    per[leaf] = per[leaf] * k // E
        assert roofline.weight_flops_per_token(cfg) == 2 * sum(per.values())


def test_prefill_and_step_flops():
    cfg = {"d_model": 8, "n_heads": 2, "n_kv_heads": 2, "head_dim": 4,
           "vocab": 10, "n_layers": 1, "d_ff": 16}
    w = roofline.weight_flops_per_token(cfg, head=False)
    assert w == 2 * (8 * 6 * 4 + 8 * 8 + 3 * 8 * 16)
    assert roofline.prefill_flops(cfg, 3) == 3 * w + 2 * 8 * 10 + \
        4 * 2 * 4 * 6
    assert roofline.step_flops(cfg, 2, 3, 5.0) == 6 * (w + 160 + 4 * 8 * 5)
