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

``--transport tcp`` replays the same trace over real sockets against a
``CloudServer`` (``--cloud-port``, or 0 for one in this process; start a
separate one with ``python -m repro_torch.launch.cloud``) with the
simulated run as differential oracle: the streams must be equal
(``[PASS-TRANSPORT]``).  ``--trace-out`` / ``--metrics-out`` write the
Chrome trace of the round phases and the metrics snapshot (with the
Theorem-1 decomposition on lockstep runs) and check them
(``[PASS-OBS]``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b \
        --smoke --device cpu --trace --transport tcp \
        --trace-out /tmp/t.json --metrics-out /tmp/m.json   # CPU smoke

The SSM and hybrid configs (``xlstm-1.3b``, ``jamba-1.5-large-398b``)
serve fixed-batch and lockstep traces; ``--pipeline pipelined`` and
``--transport tcp`` are refused at argument time (exit 2) with the
message of ``serve.events`` / ``serve.net`` (sequential state rolls back
only in lockstep rounds).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-1.3b \
        --smoke --device cpu --rounds 2                    # CPU smoke

An encoder-decoder config (``seamless-m4t-large-v2``) is refused at
argument time (exit 2, ``core.engine.ENCDEC_REFUSAL``): the engine does
not serve one, as the reference cannot; ``qwen2-vl-72b`` serves as text
(M-RoPE positions t == h == w).

Weights come from ``--target-ckpt`` / ``--draft-ckpt`` (flat-npz
checkpoints of ``repro_torch.launch.train`` or of the reference's
trainer); an empty flag draws random ones with ``bridge.seeded_model``
from seeded torch generators (target seed+1, draft seed+2).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gptneo-1.3b \
        --target-ckpt ckpt/target --draft-ckpt ckpt/draft   # on the card
"""
from __future__ import annotations

import argparse
import json

from repro_torch import configs, resolve_device
from repro_torch.bridge import from_jax, seeded_model
from repro_torch.core.channel import ChannelConfig
from repro_torch.core.engine import (ENCDEC_REFUSAL, EdgeCloudEngine,
                                     EngineConfig, MethodConfig, is_stateful,
                                     summarize)
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.obs import DecompTracker, Obs, span_names_by_clock
from repro_torch.serve import (ServeConfig, ServeSession, TraceConfig,
                               poisson_trace)
from repro_torch.serve.events import PIPELINED_REFUSAL
from repro_torch.serve.net import TCP_TARGET_REFUSAL
from repro_torch.train import checkpoint


def load_or_init(cfg, ckpt, seed, device):
    """A serving model from a checkpoint, or seeded random weights."""
    if ckpt:
        return from_jax(checkpoint.load(ckpt), cfg, device)
    return seeded_model(cfg, seed, device)


def build_obs(args) -> Obs:
    """Obs bundle for --trace-out/--metrics-out runs.  The Theorem-1
    decomposition needs the dense collect_theory arrays, which only the
    lockstep simulator round emits — pipelined runs still get spans,
    counters and coverage-free telemetry."""
    decomp = None
    if args.pipeline == "lockstep":
        decomp = DecompTracker(args.alpha, args.eta, args.ell)
    return Obs.on(decomp=decomp)


def finish_obs(args, obs: Obs, tcp: bool):
    """Export the trace/metrics artifacts and gate on the obs
    invariants: required round-phase spans per clock, and the per-round
    rejection telemetry reconciling with ``core.theory.thm1_terms``."""
    if obs is None:
        return
    failures = []
    if args.trace_out:
        obs.tracer.export(args.trace_out)
        names = span_names_by_clock(obs.tracer.chrome_trace())
        missing = {"draft", "uplink", "verify",
                   "downlink"} - names.get("modeled", set())
        if missing:
            failures.append(
                f"modeled clock missing spans {sorted(missing)}")
        if tcp:
            wmissing = {"draft", "verify_rpc"} - names.get("wall", set())
            if wmissing:
                failures.append(
                    f"wall clock missing spans {sorted(wmissing)}")
        print(f"  obs  trace: {obs.tracer.n_events} events -> "
              f"{args.trace_out}")
    if args.metrics_out:
        snap = obs.metrics.snapshot()
        if obs.decomp is not None:
            snap["decomp"] = obs.decomp.snapshot()
        with open(args.metrics_out, "w") as f:
            json.dump(snap, f, indent=1, sort_keys=True)
        print(f"  obs  metrics -> {args.metrics_out}")
    if obs.decomp is not None:
        ok, err = obs.decomp.reconcile()
        if not ok:
            failures.append(
                f"thm1 decomposition does not reconcile "
                f"(max |mismatch+dropped+lattice - bound| = {err:.3g})")
        cov = obs.decomp.coverage()
        print(f"  obs  thm1 per-round terms reconcile "
              f"(max err {err:.3g}); conformal dropped mass "
              f"{cov['mean_dropped']:.3g} vs alpha={cov['alpha']:.3g} "
              f"over {cov['n_positions']} positions")
    if failures:
        for msg in failures:
            print(f"[FAIL-OBS] {msg}")
        raise SystemExit(1)
    print("[PASS-OBS] trace/metrics artifacts valid: round-phase spans "
          "present, rejection telemetry reconciles with thm1_terms")


def run_tcp_vs_sim(args, tc, dc, dm, sim_rep, cache_len, device, obs=None):
    """Replay the SAME seeded trace over real sockets, with the
    simulated run as differential oracle: token streams must be
    bit-identical (the transport moves bytes, never tokens), while the
    tcp side reports MEASURED wall-clock latency next to the sim's
    modeled clock.  An in-process server (``--cloud-port 0``) verifies
    on ``device``."""
    from repro_torch.serve.net import CloudServer, EdgeClient

    method = MethodConfig(args.method, K=args.K, ell=args.ell,
                          alpha=args.alpha, eta=args.eta)
    ecfg = EngineConfig(L_max=args.L_max, bit_budget=args.bit_budget,
                        temperature=args.temperature,
                        wire_codec=args.wire_codec,
                        budget_model=args.budget_model)
    cfg = ServeConfig(
        max_batch=args.max_batch, queue_cap=args.queue_cap,
        policy=args.policy, cache_len=cache_len,
        pipeline=args.pipeline, speculate=not args.no_speculate,
        n_cells=args.cells, verdict_batch=args.verdict_batch)
    # a fresh trace: Request objects are mutated by a run, and the
    # generator is fully determined by its seeded config
    trace = poisson_trace(make_trace_config(args, tc))

    server = None
    port = args.cloud_port
    try:
        if port == 0:
            server = CloudServer(host=args.cloud_host,
                                 device=device).start()
            port = server.port
            print(f"[tcp] in-process cloud server on "
                  f"{args.cloud_host}:{port} device={device}")
        client = EdgeClient(dc, dm, method, ecfg, cfg,
                            arch=args.arch, smoke=args.smoke,
                            host=args.cloud_host, port=port,
                            seed=args.seed, obs=obs, device=device)
        with client:
            net_rep = client.run_trace(trace)
    finally:
        if server is not None:
            server.stop()

    sim_streams = {r.rid: tuple(r.tokens) for r in sim_rep.requests}
    tcp_streams = net_rep.streams()
    print(f"[serve --trace --transport tcp] {tc.name} <- {dc.name}  "
          f"method={args.method} pipeline={args.pipeline} "
          f"codec={args.wire_codec} cells={args.cells} "
          f"verdict_batch={args.verdict_batch} device={device}")
    print(f"  sim  makespan={sim_rep.makespan_s:.4f}s (modeled clock)")
    s = net_rep.summary()
    print(f"  tcp  makespan={s['makespan_s']:.4f}s (measured), "
          f"{s['n_verify_rpcs']} verify RPCs")
    print(f"  tcp  rpc round  mean={s['rpc_round_s']['mean']*1e3:.2f}ms "
          f"p50={s['rpc_round_s']['p50']*1e3:.2f}ms "
          f"p95={s['rpc_round_s']['p95']*1e3:.2f}ms")
    print(f"  tcp  verify (server) mean={s['t_llm_s']['mean']*1e3:.2f}ms"
          f"  draft (edge) mean={s['t_slm_s']['mean']*1e3:.2f}ms")
    if net_rep.cloud_stats is not None:
        c = net_rep.cloud_stats.get("counters", {})
        print(f"  tcp  cloud stats: "
              f"{c.get('cloud.verify_rpcs', 0)} verify RPCs, "
              f"{c.get('cloud.wire_decode_errors', 0)} decode errors")
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"sim": sim_rep.summary(), "tcp": s,
                       "identical": tcp_streams == sim_streams,
                       "args": vars(args)}, f, indent=1)
    if tcp_streams == sim_streams:
        print(f"[PASS-TRANSPORT] tcp == sim: {len(tcp_streams)} streams "
              f"bit-identical over real sockets")
        finish_obs(args, obs, tcp=True)
        return net_rep
    bad = [rid for rid in sorted(set(sim_streams) | set(tcp_streams))
           if sim_streams.get(rid) != tcp_streams.get(rid)]
    print(f"[FAIL-TRANSPORT] streams diverge for rids {bad[:8]}"
          f"{'...' if len(bad) > 8 else ''}")
    raise SystemExit(1)


def make_trace_config(args, tc) -> TraceConfig:
    return TraceConfig(
        n_requests=args.n_requests, rate_rps=args.rate,
        prompt_len=args.prompt_len, min_new_tokens=args.min_new_tokens,
        max_new_tokens=args.max_new_tokens, vocab=tc.vocab, seed=args.seed,
        cells=args.cells)


def serve_trace(args, eng, tc, dc, dm, device, obs=None):
    cache_len = args.cache_len or (
        args.prompt_len + args.max_new_tokens + args.L_max + 8)
    trace = poisson_trace(make_trace_config(args, tc))
    sess = ServeSession(eng, ServeConfig(
        max_batch=args.max_batch, queue_cap=args.queue_cap,
        policy=args.policy, cache_len=cache_len, page_size=args.page_size,
        n_pages=args.n_pages or None, pipeline=args.pipeline,
        speculate=not args.no_speculate, n_cells=args.cells,
        verdict_batch=args.verdict_batch), obs=obs)
    rep = sess.run_trace(trace)
    if args.transport == "tcp":
        return run_tcp_vs_sim(args, tc, dc, dm, rep, cache_len, device,
                              obs=obs)
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
    finish_obs(args, obs, tcp=False)
    return rep


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=configs.list_configs())
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--target-ckpt", default="",
                    help="flat-npz checkpoint of the target (empty: "
                         "seeded random weights)")
    ap.add_argument("--draft-ckpt", default="",
                    help="flat-npz checkpoint of the draft (empty: "
                         "seeded random weights)")
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
    ap.add_argument("--transport", default="sim",
                    choices=["sim", "tcp"],
                    help="trace mode: 'sim' replays over the modeled "
                         "channel; 'tcp' drives a real CloudServer over "
                         "sockets AND runs the simulator as differential "
                         "oracle — streams must be bit-identical "
                         "([PASS-TRANSPORT])")
    ap.add_argument("--cloud-host", default="127.0.0.1")
    ap.add_argument("--cloud-port", type=int, default=0,
                    help="tcp transport: CloudServer port (0 = spawn an "
                         "in-process threaded server on an ephemeral "
                         "port)")
    ap.add_argument("--trace-out", default="",
                    help="trace mode: write a Chrome-trace-event JSON "
                         "of the run's round phases (open in "
                         "ui.perfetto.dev); sim rounds land on the "
                         "'modeled clock' process, tcp RPCs on the "
                         "'wall clock' process")
    ap.add_argument("--metrics-out", default="",
                    help="trace mode: write the metrics registry "
                         "snapshot (counters/gauges/histograms, plus "
                         "the Theorem-1 rejection decomposition when "
                         "pipeline=lockstep) as JSON")
    args = ap.parse_args(argv)
    if args.transport == "tcp" and not args.trace:
        ap.error("--transport tcp requires --trace")
    if args.transport == "tcp" and args.page_size:
        ap.error("--transport tcp serves dense slots only (--page-size 0)")
    if args.transport == "tcp" and args.target_ckpt:
        ap.error("--transport tcp: the cloud draws its target from --seed; "
                 "serve a --target-ckpt with --transport sim")
    if (args.trace_out or args.metrics_out) and not args.trace:
        ap.error("--trace-out/--metrics-out require --trace")
    tc = configs.get_config(args.arch)
    if tc.n_encoder_layers:
        ap.error(f"{tc.name}: {ENCDEC_REFUSAL}")
    # sequential-state models roll back only in lockstep simulated rounds
    if is_stateful(tc) and args.trace and args.pipeline == "pipelined":
        ap.error(PIPELINED_REFUSAL)
    if is_stateful(tc) and args.transport == "tcp":
        ap.error(TCP_TARGET_REFUSAL)
    obs = build_obs(args) if (args.trace_out or args.metrics_out) \
        else None
    device = resolve_device(args.device)

    if args.smoke:
        tc = configs.smoke_variant(tc)
    dc = configs.draft_variant(tc, args.draft_scale)
    tp = load_or_init(tc, args.target_ckpt, args.seed + 1, device)
    dp = load_or_init(dc, args.draft_ckpt, args.seed + 2, device)

    eng = EdgeCloudEngine(
        dc, dp, tc, tp,
        MethodConfig(args.method, K=args.K, ell=args.ell, alpha=args.alpha,
                     eta=args.eta),
        EngineConfig(L_max=args.L_max, bit_budget=args.bit_budget,
                     temperature=args.temperature,
                     wire_codec=args.wire_codec,
                     budget_model=args.budget_model,
                     # dense q/p arrays for the Theorem-1 decomposition;
                     # records only — tokens are unaffected
                     collect_theory=bool(obs and obs.decomp)),
        ChannelConfig(uplink_bps=args.uplink_bps,
                      downlink_bps=args.downlink_mbps * 1e6),
        seed=args.seed, device=device)

    if args.trace:
        return serve_trace(args, eng, tc, dc, dp, device, obs=obs)
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
    return rounds


if __name__ == "__main__":
    main()
