"""End-to-end edge-cloud serving with a TRAINED pair and batched requests
on the PyTorch/CUDA port (the counterpart of examples/edge_cloud_serve.py):
the paper's full pipeline -- draft on the edge, SQS-compress the token
distributions, ship over a 1 Mbit/s uplink, verify in the cloud.

    PYTHONPATH=src python examples/torch_edge_cloud_serve.py [--method csqs]
    PYTHONPATH=src python examples/torch_edge_cloud_serve.py --device cpu \\
        --steps 40 --rounds 2

The SQS edge step runs the port's default path, the fused CUDA kernels on
the card (their plain twins on the CPU); ``--no-kernels`` runs the plain
torch path instead.
"""
import argparse
import os
import sys

from repro_torch.core.channel import ChannelConfig
from repro_torch.core.engine import MethodConfig

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_pair  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--method", default="csqs",
                    choices=["ksqs", "csqs", "qs", "uncompressed"])
    ap.add_argument("--K", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--rounds", type=int, default=12)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--uplink-mbps", type=float, default=1.0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--no-kernels", action="store_true",
                    help="plain torch SQS instead of the fused kernels")
    ap.add_argument("--steps", type=int, default=torch_pair.BENCH_STEPS,
                    help="target train steps of the pair (draft: half)")
    ap.add_argument("--cache", default=torch_pair.CACHE,
                    help="where the pair's checkpoints are cached")
    args = ap.parse_args(argv)

    print("loading / training the draft-target pair (cached)...")
    dc, dp, tc, tp, data = torch_pair.trained_pair(
        steps=args.steps, device=args.device, cache=args.cache)
    rounds, s = torch_pair.run_engine(
        dc, dp, tc, tp, data,
        method=MethodConfig(args.method, K=args.K,
                            use_kernels=not args.no_kernels),
        temperature=args.temperature, rounds=args.rounds,
        batch=args.batch,
        channel=ChannelConfig(uplink_bps=args.uplink_mbps * 1e6))
    print(f"\nmethod={args.method} T={args.temperature} "
          f"uplink={args.uplink_mbps}Mbit/s")
    for k, v in s.items():
        print(f"  {k:24s} {v:.6g}")
    r = rounds[-1]
    total = r["t_total"]
    print(f"  latency breakdown: draft {100*r['t_slm']/total:.0f}% | "
          f"uplink {100*r['t_up']/total:.0f}% | "
          f"verify {100*r['t_llm']/total:.0f}% | "
          f"feedback {100*r['t_down']/total:.0f}%")
    return s


if __name__ == "__main__":
    main()
