"""Device times of the SQS kernels around the cluster their plan picks,
and where one call's time goes, on one NVIDIA card.

    python3 sqs_sweep.py        # needs one CUDA card

``repro_torch.kernels.sqs_fused.plan_cluster`` chooses the blocks per
row from the padded vocabulary alone.  At Vp 151936 (qwen2.5-3b) this
script holds that choice against twice as many blocks, at the main path's
4 rows and at 32, for two kinds of rows made from a seed: peaked logits
(N(0, 3^2)), where the select compacts at once, and near-uniform ones
(N(0, 0.05^2), beta below every q so K = V), where it sweeps the cluster
first, as it does at the main path's random-weight logits.  It times
``topk_threshold`` (K 64) and ``sqs_fused`` (C-SQS) by CUDA-graph replay
(``chip_smoke.graph_ms``).  Then it builds the library with
``-DSQS_PROFILE`` and prints, for row 0 of each kind at the plan, the SM
cycles block 0 spent between the kernel's marks (listed in
``csrc/sqs_fused.cu``).  Imports nothing of JAX or of the JAX package
``repro``.
"""
from __future__ import annotations

import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

VP, K, SEED = 151936, 64, 21
KINDS = {"peaked": (3.0, 2e-3), "near-uniform": (0.05, 2e-6)}
MARKS = {0: "load + max", 1: "exchange", 2: "exp pass", 3: "exchange",
         4: "q (+ support)", 5: "rounding + exchange",
         6: "sweep 0 start", 7: "mids", 8: "bins", 9: "barrier",
         10: "replay", 11: "", 12: "sweep 1 mids", 13: "bins",
         14: "barrier", 15: "replay", 16: "", 17: "", 18: "", 19: "compact",
         20: "barrier", 21: "block 0 finish", 22: "verdict", 23: "end"}


def rows(kind, B, dev):
    import torch
    from repro_torch.kernels.ops import pad_logits
    scale, beta = KINDS[kind]
    g = torch.Generator(device=dev).manual_seed(SEED)
    lp = pad_logits(torch.randn((B, VP), generator=g, device=dev) * scale)[0]
    return lp, torch.full((B, 2), beta, device=dev)


def profile(lib, lp, beta, dev):
    """Marks of row 0 of one topk_threshold and one sqs_fused call."""
    import torch
    from repro_torch.kernels import sqs_fused as k
    B, Vp = lp.shape
    C, L = k.plan_cluster(Vp)
    info = torch.zeros((B, 32), dtype=torch.int32, device=dev)
    tau = torch.empty((B, 2), device=dev)
    b = torch.empty((B, Vp), dtype=torch.int32, device=dev)
    mask = torch.empty_like(b)
    stats = torch.empty((B, 4), device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    out = {}
    for name, call in (
            ("topk_threshold", lambda: lib.topk_threshold_launch(
                lp.data_ptr(), tau.data_ptr(), info.data_ptr(), B, Vp, C, L,
                1.0, K, stream)),
            ("sqs_fused", lambda: lib.sqs_fused_launch(
                lp.data_ptr(), beta.data_ptr(), b.data_ptr(), mask.data_ptr(),
                stats.data_ptr(), info.data_ptr(), B, Vp, C, L, 1.0, 100, 0,
                stream))):
        for _ in range(3):
            info.zero_()
            if call():
                raise RuntimeError(f"{name}: launch failed")
        torch.cuda.synchronize()
        row = info[0].tolist()
        marks = [(m, row[4 + m]) for m in range(28) if row[4 + m]]
        prev, parts = 0, []
        for m, t in marks:
            parts.append(f"{MARKS.get(m) or m} {t - prev}")
            prev = t
        out[name] = (row[:4], parts, prev)
    return out


def main():
    import torch
    if not torch.cuda.is_available():
        print("sqs_sweep: no CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import graph_ms, sqs_path
    from repro_torch.kernels import sqs_fused as k
    from repro_torch.kernels.build import KernelLibrary
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    dev = torch.device("cuda")
    plan = k.plan_cluster
    planned = plan(VP)
    twice = (planned[0] * 2, -(-VP // (planned[0] * 2 * k.LANE)) * k.LANE)
    for kind in KINDS:
        for B in (4, 32):
            lp, beta = rows(kind, B, dev)
            calls = {"topk_threshold": lambda: k.topk_threshold(
                         lp, K, inv_temp=1.0),
                     "sqs_fused": lambda: k.sqs_fused(lp, beta, inv_temp=1.0,
                                                      ell=100)}
            for C, L in (planned, twice):
                k.plan_cluster = lambda Vp, C=C, L=L: (C, L)
                try:
                    times = {n: graph_ms(f) for n, f in calls.items()}
                finally:
                    k.plan_cluster = plan
                print(f"{kind}, B {B}: {C} blocks of {L}"
                      f"{' (plan)' if (C, L) == planned else ''}: "
                      + ", ".join(f"{n} {t:.4f} ms" for n, t in times.items()))
    lib = KernelLibrary("sqs_fused.cu", k.NVCC_FLAGS + ["-DSQS_PROFILE"],
                        k._bind).load()
    for kind in KINDS:
        lp, beta = rows(kind, 4, dev)
        for name, (info, parts, total) in profile(lib, lp, beta, dev).items():
            print(f"{kind}, B 4, {name}, row 0 ({sqs_path(info)}): SM "
                  f"cycles of block 0 between marks: " + ", ".join(parts)
                  + f"; {total} in all")
    return 0


if __name__ == "__main__":
    sys.exit(main())
