"""Device times of the flash-decode kernels around the chunk their plan
picks, on one NVIDIA card.

    python3 decode_sweep.py        # needs one CUDA card

``repro_torch.kernels.decode_attention.plan_chunks`` chooses the
positions per block from the shapes alone.  This script holds that choice
against its neighbours: at the two shapes ``chip_smoke.py`` times (4
slots with pos 16 / 1024 / 2560 / 4000 in a 4112-position pool; 32 slots
with pos drawn from [2048, 4095] in 4096-position slots), random bf16
pools at the target's attention widths (nq 16, nkv 2, hd 128, 16-position
pages), it times the dense, paged and int8 dense kernels at half, equal
and twice the planned chunk by CUDA-graph replay (``chip_smoke.graph_ms``)
and the SDPA yardstick beside them.  Imports nothing of JAX or of the JAX
package ``repro``.
"""
from __future__ import annotations

import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

SHAPES = {"served-like": (4, [16, 1024, 2560, 4000], 4112, 1028),
          "long pool": (32, range(2048, 4096), 4096, 8192)}
PAGE, SEED = 16, 13


def pool(B, pos, cap, n_pages, dev):
    """Pools, page table and gathered caches of one shape; ``pos`` is a
    list, or a range to draw each slot's pos from."""
    import numpy as np
    import torch
    from repro_torch.kernels import decode_attention as da
    from repro_torch.models.attention import page_gather
    rng = np.random.default_rng(SEED)
    if isinstance(pos, range):
        pos = rng.integers(pos.start, pos.stop, B)
    pos = np.asarray(pos, np.int32)
    table = np.full((B, cap // PAGE), n_pages, np.int32)
    perm, used = rng.permutation(n_pages), 0
    for b in range(B):
        n = int(pos[b]) // PAGE + 1
        table[b, :n] = perm[used:used + n]
        used += n
    g = torch.Generator(device=dev).manual_seed(SEED)
    shape = (n_pages + 1, PAGE, 2, 128)
    pk = torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
    pv = torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
    q = torch.randn((B, 16, 128), generator=g, device=dev).to(torch.bfloat16)
    pt = torch.from_numpy(table).to(dev)
    gk = page_gather(pk, pt.long()).contiguous()
    gv = page_gather(pv, pt.long()).contiguous()
    k8, ks = da.quantize_kv(gk)
    v8, vs = da.quantize_kv(gv)
    return dict(q=q, pk=pk, pv=pv, pt=pt, pos=torch.from_numpy(pos).to(dev),
                gk=gk, gv=gv, k8=k8, v8=v8, ks=ks, vs=vs)


def main():
    import torch
    if not torch.cuda.is_available():
        print("decode_sweep: no CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import graph_ms, sdpa_call
    from repro_torch.kernels import decode_attention as da
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    dev = torch.device("cuda")
    plan = da.plan_chunks
    for name, (B, pos, cap, n_pages) in SHAPES.items():
        c = pool(B, pos, cap, n_pages, dev)
        planned, _ = plan(cap, B, 2, PAGE)
        calls = {
            "dense": lambda: da.flash_gqa_decode(c["q"], c["gk"], c["gv"],
                                                 c["pos"]),
            "paged": lambda: da.paged_flash_gqa_decode(
                c["q"], c["pk"], c["pv"], c["pt"], c["pos"]),
            "int8 dense": lambda: da.flash_gqa_decode(
                c["q"], c["k8"], c["v8"], c["pos"], c["ks"], c["vs"])}
        lib = graph_ms(sdpa_call(c["q"], c["gk"], c["gv"], c["pos"])[0])
        print(f"{name}: B {B}, capacity {cap}, pos {c['pos'].tolist()}; "
              f"plan {planned}; SDPA {lib:.4f} ms")
        for chunk in (planned // 2, planned, planned * 2):
            da.plan_chunks = (lambda cap_, B_, nkv_, ps=1, chunk=chunk:
                              (chunk, -(-cap_ // chunk)))
            try:
                times = {k: graph_ms(f) for k, f in calls.items()}
            finally:
                da.plan_chunks = plan
            print(f"  chunk {chunk}{' (plan)' if chunk == planned else ''}: "
                  + ", ".join(f"{k} {t:.4f} ms" for k, t in times.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
