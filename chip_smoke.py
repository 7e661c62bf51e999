"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py        # needs one CUDA card

Phases:
  1. the card (nvidia-smi name and power limit) and the kernel build;
  2. each Hopper kernel against its plain PyTorch twin on the card, over
     the shapes of the reference's kernel tests plus the main path's
     (4, 151936), with the differing rows counted and classified;
  3. the port's main path through its user entry point
     (``EdgeCloudEngine.run``) at full ``qwen2.5-3b`` width with a
     ``qwen2.5-3b-draft2x`` edge model, bf16 random weights from a seed,
     for ksqs/csqs (codecs v1 and v2), qs and uncompressed, with the
     kernel launch counts of that run and output checks;
  4. kernel, twin and library timings at the main path's inputs.

The second-to-last line of output is one JSON object describing every
kernel; the last is the contract line {"ok": true, "device": {...}}.  Any
failed check exits nonzero before it.  Imports nothing of JAX or of the
JAX package ``repro``.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
F32_FLOPS = 67e12                  # H100 SXM non-tensor float32
ULP_RULE = 8                       # boundary tolerance, float32 ulps
# the main path's shape: batch, prompt length, drafts per round, and the
# rounds per K-SQS/C-SQS run (one round each for qs and uncompressed)
BATCH, PROMPT_LEN, L_MAX, ROUNDS = 4, 16, 8, 3
TPU_SOURCES = {
    "sqs_fused": "src/repro/kernels/sqs_fused.py:118",
    "topk_threshold": "src/repro/kernels/sqs_fused.py:171",
}


class CheckFailed(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise CheckFailed(msg)


def cuda_ms(fn, reps=10, warm=2):
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def near(x, y, k=ULP_RULE):
    """Elementwise: x within k float32 ulps of y."""
    import numpy as np
    x = np.asarray(x, np.float32).astype(np.float64)
    y = np.asarray(y, np.float32)
    return np.abs(x - y) <= k * np.spacing(np.abs(y)).astype(np.float64)


# ----------------------------------------------------------------------
# phase 2: kernels against their twins
# ----------------------------------------------------------------------
DROPPED_ATOL = 1e-6     # dropped mass: 1 - (a float32 sum of up to V terms)


def compare_sqs(lp, beta2, it, ell, exact_k, label, beta2_twin=None):
    """Kernel vs twin on one input (K-SQS: each with its own top-K
    threshold, as ops.sqs_topk chains them).  Every output is held:
    b, mask and all four stats [dropped, K, sum_b_raw, max_logit].

    The kernel must be consistent with itself (sum b = ell, K = its mask
    size, dropped = 1 - the twin's q summed over its mask) and its max
    logit equal the twin's.  A row that differs from the twin is excused
    only by the boundary rule: every index where the masks differ is a
    boundary index (the twin's q within ULP_RULE ulps of the kernel's or
    the twin's threshold, or l*q~ within ULP_RULE ulps of a half-integer);
    every index where b alone differs is a boundary index or moved by
    exactly 1 (the cascade of the +-1 correction); and the row holds a
    boundary index that starts it (a differing mask or b entry, or a
    rounding boundary inside the mask when sum_b_raw differs).  Returns
    (differing rows, rows not excused)."""
    import numpy as np
    import torch
    from repro_torch.kernels import ref, sqs_fused as k
    if beta2_twin is None:
        beta2_twin = beta2
    kb, km, ks = k.sqs_fused(lp, beta2, inv_temp=it, ell=ell,
                             exact_k=exact_k)
    rb, rm, rs = ref.sqs_fused_ref(lp, beta2_twin, inv_temp=it, ell=ell,
                                   exact_k=exact_k)
    torch.cuda.synchronize()
    kb, km, ks = kb.cpu().numpy(), km.cpu().numpy(), ks.cpu().numpy()
    rb, rm, rs = rb.cpu().numpy(), rm.cpu().numpy(), rs.cpu().numpy()
    q = ref.softmax_padded(lp, it)
    qm = torch.where(torch.from_numpy(rm).bool().to(q.device), q, 0.0)
    lq = (ell * (qm / qm.sum(-1, keepdim=True))).cpu().numpy()
    q = q.cpu().numpy()
    kmb, rmb = km.astype(bool), rm.astype(bool)
    check((kb.sum(-1) == ell).all(), f"{label}: kernel sum b != ell "
          f"{kb.sum(-1).tolist()}")
    check((ks[:, 3] == rs[:, 3]).all(), f"{label}: max logit differs "
          f"{ks[:, 3].tolist()} vs {rs[:, 3].tolist()}")
    check((ks[:, 1] == kmb.sum(-1)).all(), f"{label}: kernel K "
          f"{ks[:, 1].tolist()} != its mask size {kmb.sum(-1).tolist()}")
    own = 1.0 - np.where(kmb, q.astype(np.float64), 0.0).sum(-1)
    check((np.abs(ks[:, 0] - own) <= DROPPED_ATOL).all(),
          f"{label}: kernel dropped {ks[:, 0].tolist()} != 1 - sum of q "
          f"over its mask {own.tolist()}")
    if exact_k:
        check((ks[:, 1] == exact_k).all() and (rs[:, 1] == exact_k).all(),
              f"{label}: K-SQS K differs "
              f"{ks[:, 1].tolist()} vs {rs[:, 1].tolist()}")
    bad = diff = 0
    for r in range(kb.shape[0]):
        d_mask = np.nonzero(kmb[r] != rmb[r])[0]
        d_b = np.nonzero((kb[r] != rb[r]) & (kmb[r] == rmb[r]))[0]
        d_sum = float(ks[r, 2] - rs[r, 2])
        d_drop = float(abs(ks[r, 0] - rs[r, 0]))
        if (d_mask.size == 0 and d_b.size == 0 and d_sum == 0
                and ks[r, 1] == rs[r, 1] and d_drop <= DROPPED_ATOL):
            continue
        diff += 1
        half = near(lq[r], np.floor(lq[r]) + 0.5)
        bnd = (near(q[r], beta2_twin[r, 0].item())
               | near(q[r], beta2[r, 0].item()) | half)
        casc = d_b[~bnd[d_b]]
        unexplained = int((~bnd[d_mask]).sum()
                          + (np.abs(kb[r, casc] - rb[r, casc]) != 1).sum())
        started = bool(bnd[d_mask].any() or bnd[d_b].any()
                       or (d_sum != 0 and (half & rmb[r]).any()))
        if d_mask.size == 0:
            unexplained += int(ks[r, 1] != rs[r, 1])
            unexplained += int(d_drop > DROPPED_ATOL)
        excused = unexplained == 0 and started
        print(f"    row {r}: mask differs at {d_mask.size} entries "
              f"({int(bnd[d_mask].sum())} boundary), b at {d_b.size} more "
              f"({int(bnd[d_b].sum())} boundary, {casc.size} cascade), "
              f"sum_b_raw by {d_sum:+.0f}, dropped by {d_drop:.3g}; "
              f"first {np.union1d(d_mask, d_b)[:4].tolist()}; "
              f"{unexplained} not explained, "
              + ("a" if started else "no") + " boundary index starts it; "
              + ("excused by the boundary rule" if excused
                 else "NOT a boundary case"))
        bad += not excused
    return diff, bad


def phase_kernels():
    import torch
    from repro_torch.kernels import ref, sqs_fused as k
    from repro_torch.kernels.ops import pad_logits
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1234)
    n_bad = 0

    def logits(B, V, scale=3.0):
        x = torch.randn((B, V), generator=gen, device=dev) * scale
        return pad_logits(x)[0]

    print("phase 2: kernels vs plain twins on the card")
    shapes = [(1, 128), (4, 1000), (2, 4096), (3, 50257), (1, 152064),
              (4, 151936)]
    for B, V in shapes:
        for temp in (0.5, 1.0):
            lp = logits(B, V)
            it = 1.0 / temp
            beta2 = torch.full((B, 2), 2e-3, device=dev)
            label = f"sqs_threshold B={B} V={V} T={temp}"
            nd, nb = compare_sqs(lp, beta2, it, 100, 0, label)
            tk = cuda_ms(lambda: k.sqs_fused(lp, beta2, inv_temp=it,
                                             ell=100), reps=5)
            tr = cuda_ms(lambda: ref.sqs_fused_ref(lp, beta2, inv_temp=it,
                                                   ell=100), reps=5)
            print(f"  {label}: {nd} differing rows, {nb} unexcused; "
                  f"kernel {tk:.4f} ms, twin {tr:.4f} ms")
            n_bad += nb
    for B, V in shapes:
        for K in (1, 8, 64, 256):
            if K > V:
                continue
            for temp in (0.5, 1.0):
                lp = logits(B, V)
                it = 1.0 / temp
                tau = k.topk_threshold(lp, K, inv_temp=it)
                q = ref.softmax_padded(lp, it)
                tau_r = ref.topk_threshold_ref(q, K)
                # the kernel's q may sit an ulp off the twin's (another
                # summation order for the softmax denominator)
                kth = torch.topk(q, K, dim=-1).values[:, -1]
                eps = ULP_RULE * torch.finfo(torch.float32).eps
                slack = eps * kth
                check(bool((tau[:, 0] <= kth + slack).all()
                           and (kth <= tau[:, 1] + slack).all()),
                      f"topk_threshold does not bracket the K-th value "
                      f"(B={B} V={V} K={K}): {tau.tolist()} vs "
                      f"{kth.tolist()}")
                check(bool(((q >= tau[:, 0:1] * (1 - eps)).sum(-1) >= K)
                           .all()),
                      "count(q >= lo) < K")
                tau_eq = int((tau != tau_r).any(-1).sum())
                label = f"sqs_topk B={B} V={V} K={K} T={temp}"
                nd, nb = compare_sqs(lp, tau, it, 100, K, label, tau_r)
                tk = cuda_ms(lambda: k.topk_threshold(lp, K, inv_temp=it),
                             reps=5)
                tr = cuda_ms(lambda: ref.topk_threshold_ref(
                    ref.softmax_padded(lp, it), K), reps=5)
                tl = cuda_ms(lambda: torch.topk(q, K, dim=-1), reps=5)
                print(f"  {label}: tau differs from twin in {tau_eq} rows; "
                      f"sqs {nd} differing rows, {nb} unexcused; "
                      f"topk kernel {tk:.4f} ms, twin {tr:.4f} ms, "
                      f"torch.topk {tl:.4f} ms")
                n_bad += nb
    # the +-1 correction at its heaviest: near-uniform rows, beta <= 0 so
    # K = V and delta = -ell (every increment goes through the select)
    for B, V in [(4, 151936), (3, 50257)]:
        lp = logits(B, V, scale=0.01)
        beta2 = torch.full((B, 2), -1.0, device=dev)
        label = f"correction B={B} V={V} near-uniform beta<=0"
        nd, nb = compare_sqs(lp, beta2, 1.0, 100, 0, label)
        _, _, ks = k.sqs_fused(lp, beta2, inv_temp=1.0, ell=100)
        print(f"  {label}: K={ks[:, 1].tolist()} sum_b_raw="
              f"{ks[:, 2].tolist()}; {nd} differing rows, {nb} unexcused")
        n_bad += nb
    check(n_bad == 0, f"{n_bad} kernel rows differ from the twin outside "
          f"the {ULP_RULE}-ulp boundary rule")


# ----------------------------------------------------------------------
# phase 3: the main path at full width
# ----------------------------------------------------------------------
def edge_logits(eng):
    """One more draft-model step from the edge's state after a run: the
    logits the SQS kernels see next (the cache write lands past the
    committed position)."""
    from repro_torch.models import model as model_mod
    edge = eng.edge
    logits, _ = model_mod.decode_step(edge.model, edge.x_last, edge.dcache,
                                      edge.pos)
    return logits


def phase_main_path(dev, tc, dc):
    import numpy as np
    import torch
    from repro_torch.bridge import init_params
    from repro_torch.core.engine import (EdgeCloudEngine, EngineConfig,
                                         MethodConfig, summarize)
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.kernels import sqs_fused as k
    from repro_torch.models import model as model_mod
    t0 = time.perf_counter()
    tp = init_params(tc, torch.Generator(device=dev).manual_seed(1),
                     device=dev)
    dp = init_params(dc, torch.Generator(device=dev).manual_seed(2),
                     device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    n_t = sum(p.numel() for p in tp.parameters())
    n_d = sum(p.numel() for p in dp.parameters())
    print(f"phase 3: main path, {tc.name} ({tc.n_layers} layers, d "
          f"{tc.d_model}, {tc.n_heads}/{tc.n_kv_heads} heads, V {tc.vocab}; "
          f"{n_t / 1e9:.3f} B params) <- {dc.name} ({dc.n_layers} layers, "
          f"d {dc.d_model}; {n_d / 1e9:.3f} B params), {tp.dtype} weights "
          f"built "
          f"in {time.perf_counter() - t0:.1f} s")
    data = SyntheticLM(DataConfig(vocab=tc.vocab, seed=77))
    prompts = data.sample(BATCH, PROMPT_LEN)[:, :-1]
    runs = [("ksqs", "v1", ROUNDS), ("ksqs", "v2", ROUNDS),
            ("csqs", "v1", ROUNDS), ("csqs", "v2", ROUNDS),
            ("qs", "v1", 1), ("uncompressed", "v1", 1)]
    launches = {name: 0 for name in k.LAUNCHES}
    engines = {}
    for method, codec, n_rounds in runs:
        eng = EdgeCloudEngine(
            dc, dp, tc, tp, MethodConfig(method, K=64, ell=100),
            EngineConfig(L_max=L_MAX, wire_codec=codec), seed=0,
            device=dev)
        k.reset_launches()
        rounds, toks = eng.run(prompts, n_rounds)
        got = dict(k.LAUNCHES)
        for name in launches:
            launches[name] += got[name]
        steps = n_rounds * (L_MAX + 1)
        want = {"sqs_fused": steps if method in ("ksqs", "csqs") else 0,
                "topk_threshold": steps if method == "ksqs" else 0}
        check(got == want or dev.type == "cpu",
              f"{method}/{codec}: launches {got} != {want}")
        s = summarize(rounds)
        print(f"  {method}/{codec}: {n_rounds} rounds; mean K "
              f"{s['mean_K']:.1f}; launches {got}")
        print("    summarize: " + json.dumps(s))
        print("    t_slm ms " + " ".join(f"{r['t_slm'] * 1e3:.2f}"
                                           for r in rounds)
              + " | t_llm ms " + " ".join(f"{r['t_llm'] * 1e3:.2f}"
                                          for r in rounds))
        for row in toks:
            check(len(row) >= n_rounds, f"{method}: too few tokens")
            check(all(0 <= t < tc.vocab for t in row),
                  f"{method}: token outside [0, V)")
        n_pay = 0
        for r in rounds:
            for data in r["packed"].values():
                p = eng.fmt.unpack_draft(data, codec=codec)
                n_pay += 1
                check(p.n_drafts >= 1, f"{method}: empty payload")
                if p.probs is not None:
                    check(all(np.isfinite(pr).all() for pr in p.probs),
                          f"{method}: raw probabilities not finite")
                else:
                    check(all(sum(c) == 100 for c in p.counts),
                          f"{method}: transmitted sum b != ell")
        check(n_pay == BATCH * n_rounds,
              f"{method}: {n_pay} payloads")
        lg = edge_logits(eng)
        lt, _ = model_mod.extend_step(eng.cloud.model,
                                      eng.cloud.x_last[:, None],
                                      eng.cloud.tcache, eng.cloud.pos)
        check(bool(torch.isfinite(lg).all() and torch.isfinite(lt).all()),
              f"{method}: NaN/inf logits")
        engines[method] = eng
    return engines, launches


# ----------------------------------------------------------------------
# phase 4: timings at the main path's inputs
# ----------------------------------------------------------------------
def phase_timing(engines, launches):
    import torch
    from repro_torch.kernels import ref, sqs_fused as k
    from repro_torch.kernels.ops import pad_logits
    out = []
    for method in ("csqs", "ksqs"):
        edge = engines[method].edge
        lp = pad_logits(edge_logits(engines[method]))[0]
        B, Vp = lp.shape
        if method == "csqs":
            beta2 = torch.stack([edge.beta, edge.beta], -1).contiguous()
            nd, nb = compare_sqs(lp, beta2, 1.0, 100, 0,
                                 "sqs_fused at main-path input")
            check(nb == 0, f"csqs main-path input: {nb} rows differ from "
                  f"the twin outside the boundary rule")
            kb, km, ks = k.sqs_fused(lp, beta2, inv_temp=1.0, ell=100)
            rb, rm, rs = ref.sqs_fused_ref(lp, beta2, inv_temp=1.0, ell=100)
            err = float((kb - rb).abs().max().item())
            t = cuda_ms(lambda: k.sqs_fused(lp, beta2, inv_temp=1.0,
                                            ell=100))
            tr = cuda_ms(lambda: ref.sqs_fused_ref(lp, beta2, inv_temp=1.0,
                                                   ell=100))
            nbytes = B * Vp * (4 + 8) + B * (8 + 16)
            corr = bool((ks[:, 2] != 100).any())
            # softmax 4, support 2, rounding 4, zeta 2; 40 bisection
            # compares + the tie pass when the +-1 fix runs
            nops = B * Vp * (12 + (41 if corr else 0))
            print(f"  sqs_fused at main-path input (csqs, B={B}, Vp={Vp}, "
                  f"K={ks[:, 1].tolist()}, sum_b_raw={ks[:, 2].tolist()}): "
                  f"{nd} rows differ from the twin, {nb} unexcused; "
                  f"kernel {t:.4f} ms, twin {tr:.4f} ms")
            out.append(("sqs_fused", t, tr, None, err, nbytes, nops))
        else:
            it = 1.0
            tau = k.topk_threshold(lp, 64, inv_temp=it)
            q = ref.softmax_padded(lp, it)
            tau_r = ref.topk_threshold_ref(q, 64)
            err = float((tau - tau_r).abs().max().item())
            nd, nb = compare_sqs(lp, tau, it, 100, 64,
                                 "sqs_topk at main-path input", tau_r)
            check(nb == 0, f"ksqs main-path input: {nb} rows differ from "
                  f"the twin outside the boundary rule")
            t = cuda_ms(lambda: k.topk_threshold(lp, 64, inv_temp=it))
            tr = cuda_ms(lambda: ref.topk_threshold_ref(
                ref.softmax_padded(lp, it), 64))
            tl = cuda_ms(lambda: torch.topk(q, 64, dim=-1))
            nbytes = B * Vp * 4 + B * 8
            nops = B * Vp * (4 + 40)      # softmax, 40 compares
            print(f"  topk_threshold at main-path input (ksqs, B={B}, "
                  f"Vp={Vp}, K=64): tau differs from the twin by {err:.3g}, "
                  f"sqs {nd} rows differ, {nb} unexcused; "
                  f"kernel {t:.4f} ms, twin {tr:.4f} ms, "
                  f"torch.topk {tl:.4f} ms")
            out.append(("topk_threshold", t, tr, tl, err, nbytes, nops))
    rows = []
    for name, t, tr, tl, err, nbytes, nops in out:
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = nops / F32_FLOPS * 1e3
        rows.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/sqs_fused.cu",
            "replaces": TPU_SOURCES[name], "launches": launches[name],
            "max_abs_err": err, "ms": t, "plain_ms": tr,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": tl})
    return rows


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    print(smi[0])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import sqs_fused as k
    t0 = time.perf_counter()
    lib = k.build(verbose=True)
    print(f"phase 1: built {os.path.relpath(lib, HERE)} in "
          f"{time.perf_counter() - t0:.1f} s")
    phase_kernels()
    from repro_torch import configs
    tc = configs.get_config("qwen2.5-3b")
    engines, launches = phase_main_path(torch.device("cuda"), tc,
                                        configs.draft_variant(tc, 2))
    print("phase 4: timings at the main path's inputs")
    rows = phase_timing(engines, launches)
    check(all(r["launches"] > 0 for r in rows), "a kernel never ran")
    print(smi[0])
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
