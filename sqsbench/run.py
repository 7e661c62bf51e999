"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

    python3 sqsbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Runs one cell of ``BENCHMARK.json`` on the card it starts on: weights and
traffic from the seed, set-up, a window of ``--seconds``, then the check
against the plain reference.  Prints the set-up's parts and each compared
number beside its limit on standard error, and one JSON line last on
standard output.  Exits 2 without a CUDA card, or with fewer cards than
the cell asks for.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path[:0] = [str(HERE), str(ROOT / "src")]
from harness import host  # noqa: E402  (no torch: the threads are set first)

# one process, few host threads; every cache inside the checkout
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[var] = str(host.HOST_THREADS)
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton-cache")
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch-extensions")
os.environ["USE_FLAX"] = "0"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    from harness import cell
    bench = cell.load_json(ROOT / "BENCHMARK.json")
    wl = [w for w in bench["workloads"] if w["name"] == args.workload]
    if not wl:
        cell.log(f"no workload {args.workload!r} in BENCHMARK.json")
        return 2
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < wl[0]["chips"]:
        cell.log(f"{args.workload} needs {wl[0]['chips']} CUDA card(s); "
                 f"this machine has "
                 f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    out = cell.run_cell(bench, args.workload, args.seed, args.seconds,
                        bool(args.trace), "cuda", T_START)
    from harness import isolation
    forbidden = isolation.loaded_forbidden()
    if forbidden:
        cell.log(f"loaded modules of JAX or the JAX package: {forbidden}")
        return 3
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
