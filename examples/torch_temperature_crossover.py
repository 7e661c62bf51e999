"""Reproduce the paper's headline result (Fig. 2) with the PyTorch/CUDA
port (the counterpart of examples/temperature_crossover.py): the K-SQS /
C-SQS crossover -- fixed top-K wins in low-temperature (peaked) regimes,
the conformal threshold wins when sampling uncertainty grows.

    PYTHONPATH=src python examples/torch_temperature_crossover.py   # card
    PYTHONPATH=src python examples/torch_temperature_crossover.py \\
        --device cpu --steps 40 --rounds 2

The SQS edge step runs the port's default path, the fused CUDA kernels on
the card (their plain twins on the CPU); ``--no-kernels`` runs the plain
torch path instead.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_pair  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--no-kernels", action="store_true",
                    help="plain torch SQS instead of the fused kernels")
    ap.add_argument("--steps", type=int, default=torch_pair.BENCH_STEPS,
                    help="target train steps of the pair (draft: half)")
    ap.add_argument("--rounds", type=int, default=torch_pair.BENCH_ROUNDS,
                    help="rounds a sweep after the 2 warmup rounds")
    ap.add_argument("--cache", default=torch_pair.CACHE,
                    help="where the pair's checkpoints are cached")
    args = ap.parse_args(argv)

    pair = torch_pair.trained_pair(steps=args.steps, device=args.device,
                                   cache=args.cache)
    rows, _ = torch_pair.crossover(pair, rounds=args.rounds,
                                   use_kernels=not args.no_kernels)
    print(f"{'T':>5} | {'K-SQS lat(ms)':>14} {'resmp':>6} | "
          f"{'C-SQS lat(ms)':>14} {'resmp':>6} | winner")
    for T, (k, c, w) in torch_pair.winners(rows).items():
        print(f"{T:5.2f} | {k['latency_per_batch_s']*1e3:14.1f} "
              f"{k['resampling_rate']:6.3f} | "
              f"{c['latency_per_batch_s']*1e3:14.1f} "
              f"{c['resampling_rate']:6.3f} | {w}")
    print("\nfull data:")
    for r in rows:
        print("  " + " ".join(f"{key}={r[key]:.6g}"
                              if isinstance(r[key], float)
                              else f"{key}={r[key]}"
                              for key in torch_pair.KEYS))
    return rows


if __name__ == "__main__":
    main()
