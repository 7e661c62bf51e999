"""Edge-cloud SQS-SD serving entry point of the port.

Fixed-batch mode (default): the paper's Algorithm 1 over a modeled
uplink, with its latency split and resampling rate.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b \
        --method csqs --rounds 4 --batch 4                 # on the card
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b \
        --smoke --device cpu --rounds 2                    # CPU smoke

Trace mode (``--trace``): replays a seeded Poisson arrival trace through
the continuous-batching scheduler (``repro_torch.serve``) over shared
contended links, with dense per-slot caches or the paged pool
(``--page-size``), lockstep or pipelined rounds, 1..N cells, and reports
throughput, latency percentiles and the rejection rate.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b \
        --trace --page-size 16 --pipeline pipelined        # on the card

Weights are random, drawn by ``bridge.init_params`` from seeded torch
generators (target seed+1, draft seed+2).  The socket transport
(``--transport tcp``), the observability artifacts (``--trace-out``,
``--metrics-out``) and checkpoint loading are not ported yet.
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
from repro_torch.serve import (ServeConfig, ServeSession, TraceConfig,
                               poisson_trace)


def build_model(cfg, seed: int, device):
    gen = torch.Generator(device=device).manual_seed(seed)
    return init_params(cfg, gen, device=device)


def serve_trace(args, eng, tc, dc):
    cache_len = args.cache_len or (
        args.prompt_len + args.max_new_tokens + args.L_max + 8)
    trace = poisson_trace(TraceConfig(
        n_requests=args.n_requests, rate_rps=args.rate,
        prompt_len=args.prompt_len, min_new_tokens=args.min_new_tokens,
        max_new_tokens=args.max_new_tokens, vocab=tc.vocab, seed=args.seed,
        cells=args.cells))
    sess = ServeSession(eng, ServeConfig(
        max_batch=args.max_batch, queue_cap=args.queue_cap,
        policy=args.policy, cache_len=cache_len, page_size=args.page_size,
        n_pages=args.n_pages or None, pipeline=args.pipeline,
        speculate=not args.no_speculate, n_cells=args.cells,
        verdict_batch=args.verdict_batch))
    rep = sess.run_trace(trace)
    kv = (f"paged({args.page_size}-tok pages)" if args.page_size
          else "dense")
    print(f"[serve --trace] {tc.name} <- {dc.name}  method={args.method} "
          f"policy={args.policy} pipeline={args.pipeline} "
          f"codec={args.wire_codec} rate={args.rate}/s "
          f"slots={args.max_batch} kv={kv} cells={args.cells} "
          f"verdict_batch={args.verdict_batch} device={eng.device}")
    for k, v in rep.summary().items():
        if isinstance(v, float):
            print(f"  {k:24s} {v:.6g}")
        else:
            print(f"  {k:24s} {v}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"report": rep.summary(), "args": vars(args)}, f,
                      indent=1)
    return rep


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
    # --- trace (continuous-batching) mode ---
    ap.add_argument("--trace", action="store_true",
                    help="replay a Poisson arrival trace through the "
                         "continuous-batching scheduler")
    ap.add_argument("--rate", type=float, default=2.0,
                    help="trace mode: mean arrival rate (requests/s)")
    ap.add_argument("--n-requests", type=int, default=16)
    ap.add_argument("--max-new-tokens", type=int, default=32)
    ap.add_argument("--min-new-tokens", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=4,
                    help="trace mode: engine slots")
    ap.add_argument("--queue-cap", type=int, default=64,
                    help="trace mode: waiting-room size before rejecting")
    ap.add_argument("--policy", default="continuous",
                    choices=["continuous", "static"])
    ap.add_argument("--pipeline", default="lockstep",
                    choices=["lockstep", "pipelined"],
                    help="trace mode: lockstep barrier rounds, or the "
                         "event-driven loop overlapping edge drafting, "
                         "uplink, cloud verify and downlink (same token "
                         "streams, lower latency)")
    ap.add_argument("--no-speculate", action="store_true",
                    help="pipelined: disable the edge's optimistic "
                         "draft-ahead of round t+1")
    ap.add_argument("--cells", type=int, default=1,
                    help="trace mode: radio cells, each with its own "
                         "shared uplink + broadcast downlink and slot "
                         "partition; one cloud verifier")
    ap.add_argument("--verdict-batch", action="store_true",
                    help="trace mode: one coded downlink frame of "
                         "verdicts per cell per verify batch")
    ap.add_argument("--cache-len", type=int, default=0,
                    help="per-slot cache capacity (0 = auto)")
    ap.add_argument("--page-size", type=int, default=0,
                    help="trace mode: paged KV pool page size in tokens "
                         "(0 = dense per-slot caches)")
    ap.add_argument("--n-pages", type=int, default=0,
                    help="trace mode: KV pool size in pages (0 = auto: "
                         "slots x pages-per-slot, the dense footprint)")
    for flag in ("--transport", "--trace-out", "--metrics-out"):
        ap.add_argument(flag, default=None, help="not ported yet")
    args = ap.parse_args(argv)
    for flag in ("transport", "trace_out", "metrics_out"):
        if getattr(args, flag) not in (None, "sim"):
            raise SystemExit(f"--{flag.replace('_', '-')}: not yet ported "
                             "(next slice)")
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

    if args.trace:
        return serve_trace(args, eng, tc, dc)
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
