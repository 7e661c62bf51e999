"""Profile one K-SQS draft call of the fixed-batch main path on one card.

    python3 draft_profile.py                  # this checkout's src/
    python3 draft_profile.py --src OTHER/src  # another checkout's port

Builds the full-width ``qwen2.5-3b`` pair of ``chip_smoke.py`` phase 3
(seeded bf16 random weights, batch 4, prompt 16, L_max 8, K 64, ell 100),
runs one K-SQS round to warm up, then runs one draft call (L_max + 1
decode steps with the SQS kernels, committing nothing) under
``torch.profiler``.  Prints the call's wall time, its device time, the
device-busy share and the kernels with the most device time, then one
JSON line of the same numbers.  With ``--src`` pointing at an earlier
checkout, two versions of the port are compared inside one run on one
card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=os.path.join(HERE, "src"))
    ap.add_argument("--label", default="")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.src))
    import torch
    if not torch.cuda.is_available():
        print("draft_profile: no CUDA device", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import configs
    from repro_torch.bridge import init_params
    from repro_torch.core.engine import (EdgeCloudEngine, EngineConfig,
                                         MethodConfig)
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    dev = torch.device("cuda")
    tc = configs.get_config("qwen2.5-3b")
    dc = configs.draft_variant(tc, 2)
    tp = init_params(tc, torch.Generator(device=dev).manual_seed(1),
                     device=dev)
    dp = init_params(dc, torch.Generator(device=dev).manual_seed(2),
                     device=dev)
    prompts = SyntheticLM(DataConfig(vocab=tc.vocab, seed=77)).sample(
        4, 16)[:, :-1]
    eng = EdgeCloudEngine(dc, dp, tc, tp, MethodConfig("ksqs", K=64,
                                                       ell=100),
                          EngineConfig(L_max=8), seed=0, device=dev)
    eng.run(prompts, 1)
    edge = eng.edge
    call = (edge.x_last, edge.pos, edge.beta, edge.keys)
    _, _, bare = edge._run_draft(*call)              # warm, unprofiled
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, _, wall = edge._run_draft(*call)
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA \
                or getattr(ev, "is_user_annotation", False):
            continue
        t = getattr(ev, "self_device_time_total",
                    getattr(ev, "self_cuda_time_total", 0.0))
        if t > 0:
            rows.append((t / 1e3, ev.count, ev.key))
    rows.sort(reverse=True)
    dev_ms = sum(t for t, _, _ in rows)
    label = args.label or os.path.relpath(os.path.abspath(args.src), HERE)
    print(smi)
    print(f"[{label}] one ksqs draft call: wall {wall * 1e3:.2f} ms "
          f"({bare * 1e3:.2f} ms unprofiled), device time {dev_ms:.3f} ms "
          f"= {dev_ms / (bare * 1e3):.3f} of the unprofiled wall")
    for t, n, key in rows[:8]:
        print(f"    {t:9.3f} ms over {n:5d} calls  {key[:90]}")
    print(json.dumps({"label": label, "wall_ms": wall * 1e3,
                      "unprofiled_ms": bare * 1e3, "device_ms": dev_ms,
                      "top": [{"ms": t, "calls": n, "kernel": key}
                              for t, n, key in rows[:8]]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
