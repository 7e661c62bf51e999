"""Edge-cloud SQS-SD serving entry point of the port, fixed-batch mode
(the paper's Algorithm 1 over a modeled uplink):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b \
        --method csqs --rounds 4 --batch 4                 # on the card
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b \
        --smoke --device cpu --rounds 2                    # CPU smoke

Weights are random, drawn by ``bridge.init_params`` from seeded torch
generators (target seed+1, draft seed+2).  The continuous-batching trace
mode (``--trace``) comes with the serving slice; checkpoint loading with
the training slice.
"""
from __future__ import annotations

import argparse
import json

import torch

from repro_torch import configs, resolve_device
from repro_torch.bridge import init_params
from repro_torch.core.channel import ChannelConfig
from repro_torch.core.engine import (EdgeCloudEngine, EngineConfig,
                                     MethodConfig, summarize)
from repro_torch.data.pipeline import DataConfig, SyntheticLM


def build_model(cfg, seed: int, device):
    gen = torch.Generator(device=device).manual_seed(seed)
    return init_params(cfg, gen, device=device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=configs.ASSIGNED)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--draft-scale", type=int, default=2)
    ap.add_argument("--method", default="csqs",
                    choices=["ksqs", "csqs", "qs", "uncompressed"])
    ap.add_argument("--K", type=int, default=64)
    ap.add_argument("--ell", type=int, default=100)
    ap.add_argument("--alpha", type=float, default=5e-4)
    ap.add_argument("--eta", type=float, default=1e-3)
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--L-max", type=int, default=8)
    ap.add_argument("--bit-budget", type=float, default=5000.0)
    ap.add_argument("--wire-codec", default="v1", choices=["v1", "v2"])
    ap.add_argument("--budget-model", default="analytic",
                    choices=["analytic", "calibrated"])
    ap.add_argument("--uplink-bps", type=float, default=1e6)
    ap.add_argument("--downlink-mbps", type=float, default=20.0)
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json", default="")
    ap.add_argument("--trace", action="store_true",
                    help="continuous-batching trace mode (not yet ported)")
    args = ap.parse_args(argv)
    if args.trace:
        raise SystemExit("--trace: the continuous-batching trace mode is "
                         "not yet ported")
    device = resolve_device(args.device)

    tc = configs.get_config(args.arch)
    if args.smoke:
        tc = configs.smoke_variant(tc)
    dc = configs.draft_variant(tc, args.draft_scale)
    tp = build_model(tc, args.seed + 1, device)
    dp = build_model(dc, args.seed + 2, device)

    eng = EdgeCloudEngine(
        dc, dp, tc, tp,
        MethodConfig(args.method, K=args.K, ell=args.ell, alpha=args.alpha,
                     eta=args.eta),
        EngineConfig(L_max=args.L_max, bit_budget=args.bit_budget,
                     temperature=args.temperature,
                     wire_codec=args.wire_codec,
                     budget_model=args.budget_model),
        ChannelConfig(uplink_bps=args.uplink_bps,
                      downlink_bps=args.downlink_mbps * 1e6),
        seed=args.seed, device=device)

    data = SyntheticLM(DataConfig(vocab=tc.vocab, seed=77))
    prompts = data.sample(args.batch, args.prompt_len)[:, :-1]
    rounds, _ = eng.run(prompts, args.rounds)
    s = summarize(rounds)
    print(f"[serve] {tc.name} <- {dc.name}  method={args.method} "
          f"codec={args.wire_codec} device={device}")
    for k, v in s.items():
        print(f"  {k:24s} {v:.6g}")
    t = rounds[-1]
    print(f"  latency split (last round): slm={t['t_slm']*1e3:.1f}ms "
          f"up={t['t_up']*1e3:.1f}ms llm={t['t_llm']*1e3:.1f}ms "
          f"down={t['t_down']*1e3:.1f}ms")
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"summary": s, "args": vars(args)}, f, indent=1)


if __name__ == "__main__":
    main()
