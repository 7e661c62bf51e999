"""The check's control, on the card: for each seed, one short run of a
cell at its own load and size, whose served requests are judged twice:
the system against the float32 reference, and the reference computed
with float8 weights in the system's place.  Both sides' readings go
through the cell's limits file as a run's ``correct`` does, and each
side's verdict is printed: the system's must read true and the
control's false.  A limit sits between the system's largest reading
over seeds and the control's smallest.  The benchmark's own runs never
run this.

    python3 sqsbench/control.py --workload <name> --seeds 1 2 3 --seconds 10
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

import run as _run  # noqa: E402,F401  (environment and paths as run.py sets them)


def judged(readings: dict, limits: dict):
    """``correct`` as a run decides it, from one side's readings and the
    cell's limits: every number present and within its limit."""
    numbers = {k: readings.get(k) for k in limits}
    return (all(v is not None and v <= limits[k] for k, v in numbers.items()),
            numbers)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)
    import torch
    from harness import cell
    if not torch.cuda.is_available():
        cell.log("the control runs on a CUDA card")
        return 2
    bench = cell.load_json(_run.ROOT / "BENCHMARK.json")
    limits = cell.load_json(_run.HERE / "limits" / f"{args.workload}.json")
    for seed in args.seeds:
        out = cell.run_cell(bench, args.workload, seed, args.seconds, False,
                            "cuda", time.perf_counter(), control=True)
        verdicts = {side: judged(out[key], limits)
                    for side, key in (("system", "readings"),
                                      ("control", "control"))}
        for side, (ok, numbers) in verdicts.items():
            cell.log(f"seed {seed} {side}: correct {str(ok).lower()}, "
                     + ", ".join(f"{k} {v} limit {limits[k]}"
                                 for k, v in numbers.items()))
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "system": out["readings"],
                          "control": out["control"],
                          "system_correct": verdicts["system"][0],
                          "control_correct": verdicts["control"][0],
                          "peak_bytes": out["device"]["memory_peak_bytes"]}),
              flush=True)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    return 0


if __name__ == "__main__":
    sys.exit(main())
