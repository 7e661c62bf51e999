"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py        # needs one CUDA card

Phases:
  1. the card (nvidia-smi name and power limit) and the build of both
     kernel libraries (one nvcc each, started together);
  2. each Hopper kernel against its plain PyTorch twin on the card: the
     SQS kernels over the shapes of the reference's kernel tests plus the
     main path's (4, 151936), with the differing rows counted and
     classified, and the select's paths (cluster sweeps then compaction
     on near-uniform rows, never compacting on all-equal rows, the K-SQS
     index trim on tied logits); the two flash-decode kernels over the reference's
     sweeps in f32, bf16 and int8, paged against dense on gathered
     pages, and the serving shape (nq 16, nkv 2, hd 128, bf16);
  3. the fixed-batch main path through its user entry point
     (``EdgeCloudEngine.run``) at full ``qwen2.5-3b`` width with a
     ``qwen2.5-3b-draft2x`` edge model, bf16 random weights from a seed,
     for ksqs/csqs (codecs v1 and v2), qs and uncompressed, with the
     kernel launch counts of that run and output checks, and one ksqs
     draft call under torch.profiler (device-busy share, SQS kernel time);
  4. SQS kernel, twin and library timings at the main path's inputs, with
     each kernel's cluster plan and the barriers of each call;
  5. continuous-batching serving (``ServeSession.run_trace``) of one
     Poisson trace at full width: dense lockstep, paged lockstep, paged
     pipelined with speculation, and int8 paged against int8 dense, with
     per-request streams equal across them, the launch counts of that
     path and the measured per-round t_slm / t_llm;
  6. the flash-decode kernels on the page pools that serving wrote (4
     slots admitted through the slot API with prompts of 17 to 4001
     tokens, two paged rounds): against their twins and each other (paged
     equal to dense bit for bit), in bf16 and int8, with their launch
     counts, device times, the ``scaled_dot_product_attention`` and
     page gather + SDPA yardsticks and the bytes bound;
  7. the same kernels on a long pool larger than L2: 32 slots of up to
     4096 positions (pos drawn from [2048, 4095]) in 16-position pages
     permuted over a pool of 8192 + 1 pages, at the target's attention
     widths, bf16 and int8, checked and timed as in phase 6.

All four kernels, their twins and the yardsticks are timed by device
time: a CUDA graph of GRAPH_CALLS calls is replayed between two events
and the time divided by GRAPH_CALLS, so no host work of a wrapper sits in
the timed window.  The SQS rows also print a one-call event time (one
event pair around one wrapper call, its host work inside the window), the
method of the earlier SQS timings.

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
# flash-decode tolerances of the reference's kernel tests
# (tests/test_kernels.py): f32 and int8 against its twin, a bf16 cache,
# int8 against the float oracle
ATOL_F32, ATOL_BF16, ATOL_INT8_ORACLE = 2e-5, 5e-3, 0.02
# serving: slots, page size, and the phase-6 prompt lengths / capacity
SLOTS, PAGE = 4, 16
LONG_PROMPTS, LONG_CACHE = (17, 1025, 2561, 4001), 4112
# phase 7: slots, positions per slot, pool pages (+1 trash), pos range
POOL_SLOTS, POOL_CAP, POOL_PAGES = 32, 4096, 8192
POOL_POS, POOL_SEED = (2048, 4095), 13
GRAPH_CALLS = 20                   # calls per CUDA graph in graph_ms
TPU_SOURCES = {
    "sqs_fused": "src/repro/kernels/sqs_fused.py:118",
    "topk_threshold": "src/repro/kernels/sqs_fused.py:171",
    "flash_gqa_decode": "src/repro/kernels/decode_attention.py:98",
    "paged_flash_gqa_decode": "src/repro/kernels/decode_attention.py:157",
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


def graph_ms(fn, calls=GRAPH_CALLS, reps=5):
    """Device time of one call of ``fn``: GRAPH_CALLS calls captured in a
    CUDA graph (after warm-up on a side stream), the graph replayed
    between two events, the median of ``reps`` replays over the calls."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        graph.replay()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e) / calls)
    del graph
    return statistics.median(times)


def near(x, y, k=ULP_RULE):
    """Elementwise: x within k float32 ulps of y."""
    import numpy as np
    x = np.asarray(x, np.float32).astype(np.float64)
    y = np.asarray(y, np.float32)
    return np.abs(x - y) <= k * np.spacing(np.abs(y)).astype(np.float64)


def sqs_path(info):
    """What one row's SQS kernel call ran, from its ``info`` row
    [cluster barriers, cluster sweeps, buffer size or -1, steps finished in
    block 0]."""
    barriers, sweeps, nbuf, steps = (int(v) for v in info)
    from repro_torch.kernels import sqs_fused as k
    if nbuf < 0:
        finish = "never compacted"
    else:
        finish = (f"compacted {nbuf} values into block 0, which took "
                  f"{steps} steps "
                  + ("in one warp" if nbuf <= k.WARP_MAX else
                     "in block sweeps"))
    return (f"{barriers} cluster barriers, {sweeps} cluster sweeps, "
            f"{finish}")


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
    # K = V and delta = -ell (every increment goes through the select);
    # the eligible keys exceed the compaction buffer, so the select sweeps
    # the cluster first (the fallback) and compacts after.  With every
    # logit equal no sweep narrows [lo, hi): the select never compacts and
    # the ties come from the last histogram.
    for B, V, kind in [(4, 151936, "near-uniform"), (3, 50257, "near-uniform"),
                       (2, 151936, "all-equal")]:
        lp = (logits(B, V, scale=0.01) if kind == "near-uniform"
              else pad_logits(torch.zeros((B, V), device=dev))[0])
        beta2 = torch.full((B, 2), -1.0, device=dev)
        label = f"correction B={B} V={V} {kind} beta<=0"
        nd, nb = compare_sqs(lp, beta2, 1.0, 100, 0, label)
        info = torch.zeros((B, 4), dtype=torch.int32, device=dev)
        _, _, ks = k.sqs_fused(lp, beta2, inv_temp=1.0, ell=100, info=info)
        info = info.tolist()
        check(all(r[1] > 0 for r in info), f"{label}: the select did not "
              f"take the cluster sweeps: {info}")
        if kind == "all-equal":
            check(all(r[2] == -1 for r in info), f"{label}: compacted {info}")
        print(f"  {label}: K={ks[:, 1].tolist()} sum_b_raw="
              f"{ks[:, 2].tolist()}; {nd} differing rows, {nb} unexcused; "
              f"row 0: {sqs_path(info[0])}")
        n_bad += nb
    # K-SQS with K inside a run of tied probabilities: more than K
    # candidates q >= lo, trimmed to the first K by index across blocks
    B, V, K = 4, 151936, 64
    x = torch.round(torch.randn((B, V), generator=gen, device=dev) * 4) / 2
    lp = pad_logits(x)[0]
    q = ref.softmax_padded(lp, 1.0)
    tau = k.topk_threshold(lp, K, inv_temp=1.0)
    n_cand = (q >= tau[:, 0:1]).sum(-1)
    label = f"sqs_topk B={B} V={V} K={K} tied logits"
    nd, nb = compare_sqs(lp, tau, 1.0, 100, K, label,
                         ref.topk_threshold_ref(q, K))
    info = torch.zeros((B, 4), dtype=torch.int32, device=dev)
    k.sqs_fused(lp, tau, inv_temp=1.0, ell=100, exact_k=K, info=info)
    check(bool((n_cand > K).any()), f"{label}: no row had more than K "
          f"candidates {n_cand.tolist()}")
    print(f"  {label}: candidates q >= lo {n_cand.tolist()} trimmed to {K}; "
          f"{nd} differing rows, {nb} unexcused; row 0: "
          f"{sqs_path(info[0].tolist())}")
    n_bad += nb
    check(n_bad == 0, f"{n_bad} kernel rows differ from the twin outside "
          f"the {ULP_RULE}-ulp boundary rule")


def decode_case(label, run, twins):
    """Run kernel calls ``run`` -> dict of outputs, hold each against
    its twin with its tolerance; ``twins``: name -> (twin fn, atol).
    Returns the largest error (checked) and prints the timings."""
    import torch
    outs = run()
    torch.cuda.synchronize()
    parts = []
    for name, (twin, atol) in twins.items():
        err = float((outs[name] - twin()).abs().max().item())
        check(err <= atol, f"{label}: {name} off its twin by {err:.3g} > "
              f"{atol}")
        parts.append(f"{name} {err:.3g} (<= {atol})")
    return outs, "; ".join(parts)


def phase_decode_kernels():
    """The flash-decode kernels against their twins: the sweeps of
    tests/test_kernels.py:116-198 in f32, bf16 and int8, paged against
    dense on gathered pages, and the serving shape."""
    import numpy as np
    import torch
    from repro_torch.kernels import decode_attention as da, ops, ref
    from repro_torch.models.attention import page_gather
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4321)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    print("phase 2: flash-decode kernels vs plain twins on the card")
    dense_cases = [(2, 1024, 2, 4, 64, "f32"), (1, 512, 1, 8, 128, "f32"),
                   (3, 2000, 4, 1, 128, "f32"), (2, 384, 8, 2, 64, "f32"),
                   (2, 640, 2, 4, 64, "bf16"), (4, LONG_CACHE, 2, 8, 128,
                                                "serving bf16")]
    for B, S, nkv, qpk, hd, kind in dense_cases:
        kdt = torch.bfloat16 if "bf16" in kind else torch.float32
        qdt = torch.bfloat16 if kind == "serving bf16" else torch.float32
        q = randn(B, nkv * qpk, hd, dtype=qdt)
        kc, vc = randn(B, S, nkv, hd, dtype=kdt), randn(B, S, nkv, hd,
                                                        dtype=kdt)
        pos = torch.tensor([min(S - 1, S // 2 + 7 * b) for b in range(B)],
                           dtype=torch.int32, device=dev)
        if kind == "bf16":
            pos[0] = S - 1
        atol = ATOL_F32 if kdt == torch.float32 else ATOL_BF16
        k8, ks = da.quantize_kv(kc)
        v8, vs = da.quantize_kv(vc)
        label = f"gqa_decode B={B} S={S} nkv={nkv} qpk={qpk} hd={hd} {kind}"
        _, errs = decode_case(label, lambda: {
            "cache": ops.gqa_decode(q, kc, vc, pos),
            "int8": ops.gqa_decode(q, k8, v8, pos, ks, vs)}, {
            "cache": (lambda: ref.gqa_decode_ref(q, kc, vc, pos), atol),
            "int8": (lambda: ref.gqa_decode_ref(q, k8, v8, pos, ks, vs),
                     ATOL_F32)})
        o8 = ops.gqa_decode(q, k8, v8, pos, ks, vs)
        oracle = float((o8 - ref.gqa_decode_ref(q, kc, vc, pos)).abs().max())
        check(oracle < ATOL_INT8_ORACLE, f"{label}: int8 off the float "
              f"oracle by {oracle:.3g}")
        tk = graph_ms(lambda: ops.gqa_decode(q, kc, vc, pos))
        tr = graph_ms(lambda: ref.gqa_decode_ref(q, kc, vc, pos))
        print(f"  {label}: max err {errs}; int8 vs float oracle "
              f"{oracle:.3g} (< {ATOL_INT8_ORACLE}); kernel {tk:.4f} ms, "
              f"twin {tr:.4f} ms")
    paged_cases = [(2, 4, 64, 16, 8, 20), (1, 8, 128, 32, 4, 6),
                   (4, 1, 64, 8, 16, 40), (2, 8, 128, PAGE, 64, 200)]
    rng = np.random.default_rng(7)
    for nkv, qpk, hd, ps, maxp, n_pages in paged_cases:
        B, P = 3, n_pages + 1
        serving = (nkv, qpk, hd) == (2, 8, 128)
        dt = torch.bfloat16 if serving else torch.float32
        q = randn(B, nkv * qpk, hd, dtype=dt)
        pk, pv = randn(P, ps, nkv, hd, dtype=dt), randn(P, ps, nkv, hd,
                                                         dtype=dt)
        perm = rng.permutation(n_pages)
        pt_np = np.full((B, maxp), n_pages, np.int32)
        used, pos_l = 0, []
        for b in range(B):
            npg = int(rng.integers(1, min(maxp, n_pages - used - (B - 1 - b))
                                   + 1))
            pt_np[b, :npg] = perm[used:used + npg]
            used += npg
            pos_l.append(npg * ps - int(rng.integers(1, ps)))
        pt = torch.from_numpy(pt_np).to(dev)
        pos = torch.tensor(pos_l, dtype=torch.int32, device=dev)
        def gather(pool):
            return page_gather(pool, pt.long()).contiguous()
        gk, gv = gather(pk), gather(pv)
        k8, ks = da.quantize_kv(pk)
        v8, vs = da.quantize_kv(pv)
        atol = ATOL_BF16 if serving else ATOL_F32
        label = (f"paged_gqa_decode nkv={nkv} qpk={qpk} hd={hd} ps={ps} "
                 f"maxp={maxp} P={P} {'serving bf16' if serving else 'f32'}")
        outs, errs = decode_case(label, lambda: {
            "pool": ops.paged_gqa_decode(q, pk, pv, pt, pos),
            "int8": ops.paged_gqa_decode(q, k8, v8, pt, pos, ks, vs)}, {
            "pool": (lambda: ref.paged_gqa_decode_ref(q, pk, pv, pt, pos),
                     atol),
            "int8": (lambda: ref.paged_gqa_decode_ref(q, k8, v8, pt, pos,
                                                      ks, vs), ATOL_F32)})
        dense = ops.gqa_decode(q, gk, gv, pos)
        dense8 = ops.gqa_decode(q, gather(k8), gather(v8), pos, gather(ks),
                                gather(vs))
        check(torch.equal(outs["pool"], dense)
              and torch.equal(outs["int8"], dense8),
              f"{label}: paged and dense kernels differ on gathered pages")
        tk = graph_ms(lambda: ops.paged_gqa_decode(q, pk, pv, pt, pos))
        tr = graph_ms(lambda: ref.paged_gqa_decode_ref(q, pk, pv, pt, pos))
        print(f"  {label}: max err {errs}; paged equals dense on gathered "
              f"pages bit for bit (cache and int8); kernel {tk:.4f} ms, twin "
              f"{tr:.4f} ms")


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
    profile_draft(engines["ksqs"])
    return engines, launches


SQS_KERNELS = ("sqs_fused_kernel", "topk_threshold_kernel")


def profile_draft(eng):
    """One K-SQS draft call (L_MAX + 1 decode steps with the SQS kernels)
    under ``torch.profiler``: the device-busy share of the call's wall
    time and the two SQS kernels' device time.  The call drafts from the
    edge's committed state and commits nothing (its cache writes land past
    the committed positions, as edge_logits' do)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    edge = eng.edge
    args = (edge.x_last, edge.pos, edge.beta, edge.keys)
    _, _, bare = edge._run_draft(*args)          # warm, unprofiled
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, _, wall = edge._run_draft(*args)
    # device time: the kernels' own rows (the CPU ops' rows repeat it), as
    # the profiler's table totals it
    dev_us, sqs_us, sqs_n, by_op = 0.0, {}, {}, []
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA \
                or getattr(ev, "is_user_annotation", False):
            continue
        t = getattr(ev, "self_device_time_total",
                    getattr(ev, "self_cuda_time_total", 0.0))
        if t <= 0:
            continue
        dev_us += t
        by_op.append((t, ev.count, ev.key))
        for name in SQS_KERNELS:
            if name in ev.key:
                sqs_us[name] = sqs_us.get(name, 0.0) + t
                sqs_n[name] = sqs_n.get(name, 0) + ev.count
    if dev_us == 0.0:
        print("  profiler, one ksqs draft call: the profiler saw no device "
              "time (device-busy share not measured)")
        return
    print(f"  profiler, one ksqs draft call ({L_MAX + 1} decode steps, "
          f"torch.profiler): wall {wall * 1e3:.2f} ms ({bare * 1e3:.2f} ms "
          f"unprofiled), device busy "
          f"{dev_us / 1e3:.3f} ms = {dev_us / 1e6 / wall:.3f} of the wall "
          f"({dev_us / 1e6 / bare:.3f} of the unprofiled wall); "
          + "; ".join(f"{name} {sqs_us.get(name, 0.0) / 1e3:.4f} ms over "
                      f"{sqs_n.get(name, 0)} launches"
                      for name in SQS_KERNELS)
          + f" = {sum(sqs_us.values()) / dev_us:.4f} of the device time")
    print("    most device time: " + "; ".join(
        f"{key[:60]} {t / 1e3:.3f} ms over {n} calls"
        for t, n, key in sorted(by_op, reverse=True)[:6]))


# ----------------------------------------------------------------------
# phase 4: timings at the main path's inputs
# ----------------------------------------------------------------------
def timed(fn):
    """Device time of one call by CUDA-graph replay, and its one-call
    event time (host work of the call inside the window)."""
    return graph_ms(fn), cuda_ms(fn)


def phase_timing(engines, launches):
    """Both SQS kernels at the next draft step's logits of the csqs and
    ksqs runs: checked against their twins, timed (kernels, twins,
    torch.topk and softmax + torch.topk by CUDA-graph replay, with the
    one-call event times beside them), with their cluster plan and the
    barriers each call took."""
    import torch
    from repro_torch.kernels import ref, sqs_fused as k
    from repro_torch.kernels.ops import pad_logits
    out = []
    for method in ("csqs", "ksqs"):
        edge = engines[method].edge
        lp = pad_logits(edge_logits(engines[method]))[0]
        B, Vp = lp.shape
        C, L = k.plan_cluster(Vp)
        info = torch.zeros((B, 4), dtype=torch.int32, device=lp.device)
        if method == "csqs":
            beta2 = torch.stack([edge.beta, edge.beta], -1).contiguous()
            nd, nb = compare_sqs(lp, beta2, 1.0, 100, 0,
                                 "sqs_fused at main-path input")
            check(nb == 0, f"csqs main-path input: {nb} rows differ from "
                  f"the twin outside the boundary rule")
            kb, km, ks = k.sqs_fused(lp, beta2, inv_temp=1.0, ell=100,
                                     info=info)
            rb, rm, rs = ref.sqs_fused_ref(lp, beta2, inv_temp=1.0, ell=100)
            err = float((kb - rb).abs().max().item())
            t, t1 = timed(lambda: k.sqs_fused(lp, beta2, inv_temp=1.0,
                                              ell=100))
            tr, tr1 = timed(lambda: ref.sqs_fused_ref(lp, beta2, inv_temp=1.0,
                                                      ell=100))
            nbytes = B * Vp * (4 + 8) + B * (8 + 16)
            # the function's work: softmax (scale, subtract, exp, sum,
            # divide) and the support test on every entry; rounding (divide,
            # scale, add, floor, zeta) on the support; the 40-step select
            # over the eligible keys where sum b != ell
            K = ks[:, 1].tolist()
            corr = [int(v) != 100 for v in ks[:, 2].tolist()]
            nops = B * Vp * 7 + sum(5 * kr + (40 * kr if c else 0)
                                    for kr, c in zip(K, corr))
            print(f"  sqs_fused at main-path input (csqs, B={B}, Vp={Vp}, "
                  f"K={[int(v) for v in K]}, sum_b_raw={ks[:, 2].tolist()}):"
                  f" {nd} rows differ from the twin, {nb} unexcused")
            rows = [("sqs_fused", t, t1, tr, tr1, None, None, None, err,
                     nbytes, nops, info.tolist())]
        else:
            it = 1.0
            tau = k.topk_threshold(lp, 64, inv_temp=it, info=info)
            q = ref.softmax_padded(lp, it)
            tau_r = ref.topk_threshold_ref(q, 64)
            err = float((tau - tau_r).abs().max().item())
            nd, nb = compare_sqs(lp, tau, it, 100, 64,
                                 "sqs_topk at main-path input", tau_r)
            check(nb == 0, f"ksqs main-path input: {nb} rows differ from "
                  f"the twin outside the boundary rule")
            t, t1 = timed(lambda: k.topk_threshold(lp, 64, inv_temp=it))
            tr, tr1 = timed(lambda: ref.topk_threshold_ref(
                ref.softmax_padded(lp, it), 64))
            tl, tl1 = timed(lambda: torch.topk(q, 64, dim=-1))
            tsl, _ = timed(lambda: torch.topk(ref.softmax_padded(lp, it), 64,
                                              dim=-1))
            nbytes = B * Vp * 4 + B * 8
            # softmax (5 a entry) and one compare a entry: a selection
            # needs to look at every value once
            nops = B * Vp * 6
            print(f"  topk_threshold at main-path input (ksqs, B={B}, "
                  f"Vp={Vp}, K=64): tau differs from the twin by {err:.3g}, "
                  f"sqs {nd} rows differ, {nb} unexcused")
            rows = [("topk_threshold", t, t1, tr, tr1, tl, tl1, tsl, err,
                     nbytes, nops, info.tolist())]
        out += rows
        name = rows[0][0]
        print(f"    {name}: cluster of {C} blocks a row, slices of {L} "
              f"entries, {k.smem_bytes(C, L)} B of dynamic shared memory a "
              f"block; per row: " + " | ".join(sqs_path(r)
                                                for r in info.tolist()))
    result = []
    for (name, t, t1, tr, tr1, tl, tl1, tsl, err, nbytes, nops,
         info) in out:
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = nops / F32_FLOPS * 1e3
        bound = max(t_bytes, t_ops)
        print(f"  {name}: device time {t:.4f} ms (CUDA graph of "
              f"{GRAPH_CALLS} calls), one call {t1:.4f} ms (event pair, "
              f"host work inside); twin {tr:.4f} ms (graph), {tr1:.4f} ms "
              f"(one call); bound {bound:.5f} ms "
              f"({'bytes' if t_bytes >= t_ops else 'operations'}: "
              f"{nbytes / 1e6:.2f} MB, {nops / 1e6:.2f} M operations), "
              f"{bound / t:.3f} of it"
              + (f"; torch.topk {tl:.4f} ms (graph), {tl1:.4f} ms (one "
                 f"call); softmax_padded + torch.topk {tsl:.4f} ms (graph)"
                 if tl is not None else ""))
        result.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/sqs_fused.cu",
            "replaces": TPU_SOURCES[name], "launches": launches[name],
            "max_abs_err": err, "ms": t, "plain_ms": tr,
            "bound_ms": bound,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": tl, "one_call_ms": t1, "plain_one_call_ms": tr1,
            "library_one_call_ms": tl1, "softmax_topk_ms": tsl,
            "cluster_barriers": [r[0] for r in info]})
    return result


# ----------------------------------------------------------------------
# phase 5: continuous-batching serving at full width
# ----------------------------------------------------------------------
def record_times(eng, log):
    """Record the measured draft and verify wall-clock of every engine
    call (the serving clock itself runs on fixed t_slm / t_llm)."""
    run_draft, verify = eng.edge._run_draft, eng.cloud.verify

    def timed_draft(*a):
        ys, keys, t = run_draft(*a)
        log["t_slm"].append(t)
        return ys, keys, t

    def timed_verify(*a, **kw):
        vb = verify(*a, **kw)
        log["t_llm"].append(vb.t_llm)
        return vb
    eng.edge._run_draft = timed_draft
    eng.cloud.verify = timed_verify


def serve_run(label, dc, dp, tc, tp, dev, trace_cfg, **serve_kw):
    from repro_torch.core.engine import (EdgeCloudEngine, EngineConfig,
                                         MethodConfig)
    from repro_torch.serve import (ServeConfig, ServeSession, TraceConfig,
                                   poisson_trace)
    eng = EdgeCloudEngine(dc, dp, tc, tp, MethodConfig("csqs"),
                          EngineConfig(L_max=L_MAX), seed=0, device=dev)
    log = {"t_slm": [], "t_llm": []}
    record_times(eng, log)
    t0 = time.perf_counter()
    cfg = dict(max_batch=SLOTS, cache_len=48, t_slm_s=0.05, t_llm_s=0.03)
    cfg.update(serve_kw)
    rep = ServeSession(eng, ServeConfig(**cfg)).run_trace(
        poisson_trace(TraceConfig(**trace_cfg)))
    wall = time.perf_counter() - t0
    check(rep.n_finished == rep.n_requests == trace_cfg["n_requests"],
          f"{label}: {rep.n_finished} of {rep.n_requests} finished")
    streams = {r.rid: tuple(r.tokens) for r in rep.requests}
    for rid, toks in streams.items():
        check(0 < len(toks) and all(0 <= t < tc.vocab for t in toks),
              f"{label}: request {rid} stream {toks}")
    if rep.page_size:
        check(0 < rep.peak_pages_in_use < rep.n_pages,
              f"{label}: peak pages {rep.peak_pages_in_use} of "
              f"{rep.n_pages}")
    summ = rep.summary()
    print(f"  {label}: {wall:.1f} s wall; " + json.dumps(
        {k: summ[k] for k in ("n_requests", "n_finished", "total_tokens",
                              "n_rounds", "makespan_s", "latency_p50_s",
                              "latency_p99_s", "n_preempted", "peak_active",
                              "n_pages", "peak_pages_in_use", "n_spec_hits",
                              "n_spec_misses", "uplink_bits_total")}))
    print("    measured t_slm ms " + " ".join(
        f"{t * 1e3:.1f}" for t in log["t_slm"]))
    print("    measured t_llm ms " + " ".join(
        f"{t * 1e3:.1f}" for t in log["t_llm"]))
    return streams


def phase_serving(dev, tc, dc, tp, dp):
    import dataclasses
    import torch
    from repro_torch.bridge import init_params
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import sqs_fused as k
    print(f"phase 5: continuous-batching serving, {tc.name} <- {dc.name}, "
          f"bf16, csqs, L_max {L_MAX}, {SLOTS} slots, fixed clock t_slm "
          f"50 ms / t_llm 30 ms")
    trace = dict(n_requests=6, rate_rps=4.0, prompt_len=PROMPT_LEN,
                 min_new_tokens=8, max_new_tokens=12, vocab=tc.vocab, seed=5)
    k.reset_launches()
    da.reset_launches()
    dense = serve_run("dense lockstep", dc, dp, tc, tp, dev, trace)
    paged = serve_run("paged(16) lockstep", dc, dp, tc, tp, dev, trace,
                      page_size=PAGE)
    pipe = serve_run("paged(16) pipelined + speculation", dc, dp, tc, tp,
                     dev, trace, page_size=PAGE, pipeline="pipelined")
    launches = {**k.LAUNCHES, **da.LAUNCHES}
    print(f"  launches over the three runs: {launches}")
    check(launches["sqs_fused"] > 0, "serving never launched sqs_fused")
    check(dense == paged, "paged lockstep streams differ from dense")
    check(dense == pipe, "pipelined streams differ from lockstep")
    print(f"  streams equal across dense lockstep, paged lockstep and paged "
          f"pipelined: {len(dense)} requests, "
          f"{sum(map(len, dense.values()))} tokens")
    tc8 = dataclasses.replace(tc, kv_cache_dtype="int8")
    dc8 = dataclasses.replace(dc, kv_cache_dtype="int8")
    tp8 = init_params(tc8, torch.Generator(device=dev).manual_seed(1),
                      device=dev)
    dp8 = init_params(dc8, torch.Generator(device=dev).manual_seed(2),
                      device=dev)
    short = dict(trace, n_requests=2, min_new_tokens=6, max_new_tokens=8)
    d8 = serve_run("int8 dense lockstep", dc8, dp8, tc8, tp8, dev, short)
    p8 = serve_run("int8 paged(16) lockstep", dc8, dp8, tc8, tp8, dev, short,
                   page_size=PAGE)
    check(d8 == p8, "int8 paged streams differ from int8 dense")
    print(f"  int8 paged streams equal int8 dense: {len(d8)} requests")
    del tp8, dp8
    torch.cuda.empty_cache()
    return launches


# ----------------------------------------------------------------------
# phase 6: the flash-decode kernels on the served page pools
# ----------------------------------------------------------------------
def sdpa_call(q, gk, gv, pos):
    """The yardstick: one torch.nn.functional.scaled_dot_product_attention
    call over the gathered bf16 cache, positions <= pos; GQA by
    ``enable_gqa`` where the installed torch has it, else by K/V heads
    repeated (outside the timed call)."""
    import torch
    import torch.nn.functional as F
    B, nq, hd = q.shape
    S, nkv = gk.shape[1], gk.shape[2]
    qs = q[:, :, None, :]
    ks, vs = gk.permute(0, 2, 1, 3), gv.permute(0, 2, 1, 3)
    mask = (torch.arange(S, device=q.device)[None, :]
            <= pos.long()[:, None])[:, None, None, :]
    if "enable_gqa" in (F.scaled_dot_product_attention.__doc__ or ""):
        return (lambda: F.scaled_dot_product_attention(
            qs, ks, vs, attn_mask=mask, enable_gqa=True)), "enable_gqa=True"
    ks = ks.repeat_interleave(nq // nkv, 1)
    vs = vs.repeat_interleave(nq // nkv, 1)
    return (lambda: F.scaled_dot_product_attention(
        qs, ks, vs, attn_mask=mask)), "K/V heads repeated"


def decode_bound(B, nq, nkv, hd, pos, kv_bytes, paged_cols=0, scales=False):
    """Least time for one decode call: each input read once (K and V at
    positions <= pos, their scales, q, pos, the page table) and the f32
    output written once, over device memory; against 4 flops per
    position, query head and hd (two products, f32 outside the tensor
    cores).  Returns (ms, bound_by, bytes)."""
    n = int(sum(int(p) + 1 for p in pos))
    nbytes = (2 * n * nkv * hd * kv_bytes + (2 * n * nkv * 4 if scales
                                             else 0)
              + B * nq * hd * 2 + B * 4 + B * paged_cols * 4
              + B * nq * hd * 4)
    nops = 4 * n * nq * hd
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / F32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), nbytes


def phase_served_pools(dev, tc, dc, tp, dp):
    import numpy as np
    import torch
    from repro_torch.core.engine import (EdgeCloudEngine, EngineConfig,
                                         MethodConfig)
    from repro_torch.kernels import decode_attention as da, ops, ref
    from repro_torch.models.attention import page_gather
    print(f"phase 6: flash-decode kernels on the served page pools "
          f"({SLOTS} slots, prompts {LONG_PROMPTS}, cache {LONG_CACHE}, "
          f"page {PAGE}, two paged lockstep rounds)")
    eng = EdgeCloudEngine(dc, dp, tc, tp, MethodConfig("csqs"),
                          EngineConfig(L_max=L_MAX), seed=0, device=dev)
    eng.init_slots(SLOTS, LONG_CACHE, page_size=PAGE)
    rng = np.random.default_rng(11)
    t0 = time.perf_counter()
    for slot, n in enumerate(LONG_PROMPTS):
        eng.admit_slot(slot, rng.integers(0, tc.vocab, n), seed=100 + slot)
    for _ in range(2):
        eng.run_round()
    torch.cuda.synchronize()
    print(f"  admitted and served two rounds in "
          f"{time.perf_counter() - t0:.1f} s; pages in use "
          f"{eng.alloc.pages_in_use} of {eng.alloc.n_pages}")
    # the last committed position of each slot: the engines' pos - 1
    pos = (eng.cloud.pos - 1).to(torch.int32)
    check(torch.equal(eng.cloud.pos, eng.edge.pos), "edge/cloud pos differ")
    cases = []
    for name, cache, cfg in (("target", eng.cloud.tcache, tc),
                             ("draft", eng.edge.dcache, dc)):
        n = len(cache)
        for layer in sorted({0, n // 2, n - 1}):
            c = cache[layer]
            pt = c["page_table"].to(torch.int32)
            P = c["k"].shape[0]
            check(bool(((pt >= 0) & (pt < P)).all()),
                  f"{name} layer {layer}: page table entry outside the pool")
            check(bool((pt == P - 1).any()), "no trash entries in the table")
            g = torch.Generator(device=dev).manual_seed(layer)
            q = torch.randn((SLOTS, cfg.n_heads, cfg.head_dim), generator=g,
                            device=dev).to(torch.bfloat16)
            k8, ks = da.quantize_kv(c["k"])
            v8, vs = da.quantize_kv(c["v"])
            cases.append(dict(
                label=f"{name} layer {layer}", q=q, k=c["k"], v=c["v"],
                pt=pt, gk=page_gather(c["k"], pt.long()).contiguous(),
                gv=page_gather(c["v"], pt.long()).contiguous(), k8=k8, ks=ks,
                v8=v8, vs=vs, gk8=page_gather(k8, pt.long()).contiguous(),
                gv8=page_gather(v8, pt.long()).contiguous(),
                gks=page_gather(ks, pt.long()).contiguous(),
                gvs=page_gather(vs, pt.long()).contiguous()))
    # the path: one paged and one dense decode per pool and type
    da.reset_launches()
    for c in cases:
        c["paged"] = ops.paged_gqa_decode(c["q"], c["k"], c["v"], c["pt"],
                                          pos)
        c["dense"] = ops.gqa_decode(c["q"], c["gk"], c["gv"], pos)
        c["paged8"] = ops.paged_gqa_decode(c["q"], c["k8"], c["v8"], c["pt"],
                                           pos, c["ks"], c["vs"])
        c["dense8"] = ops.gqa_decode(c["q"], c["gk8"], c["gv8"], pos,
                                     c["gks"], c["gvs"])
    torch.cuda.synchronize()
    launches = dict(da.LAUNCHES)
    print(f"  launches: {launches}")
    check(all(v > 0 for v in launches.values()),
          f"a decode kernel never ran on the served pools: {launches}")
    err = {"flash_gqa_decode": 0.0, "paged_flash_gqa_decode": 0.0}
    for c in cases:
        twin = ref.paged_gqa_decode_ref(c["q"], c["k"], c["v"], c["pt"], pos)
        twin8 = ref.paged_gqa_decode_ref(c["q"], c["k8"], c["v8"], c["pt"],
                                         pos, c["ks"], c["vs"])
        e = {"paged": float((c["paged"] - twin).abs().max()),
             "dense": float((c["dense"] - twin).abs().max()),
             "paged vs dense": float((c["paged"] - c["dense"]).abs().max()),
             "paged8": float((c["paged8"] - twin8).abs().max()),
             "dense8": float((c["dense8"] - twin8).abs().max()),
             "paged8 vs dense8": float((c["paged8"] - c["dense8"]).abs()
                                       .max()),
             "paged8 vs float": float((c["paged8"] - twin).abs().max())}
        tol = {"paged": ATOL_BF16, "dense": ATOL_BF16,
               "paged vs dense": ATOL_F32, "paged8": ATOL_F32,
               "dense8": ATOL_F32, "paged8 vs dense8": ATOL_F32}
        for key, val in tol.items():
            check(e[key] <= val, f"{c['label']}: {key} error {e[key]:.3g} "
                  f"> {val}")
        err["flash_gqa_decode"] = max(err["flash_gqa_decode"], e["dense"],
                                      e["dense8"])
        err["paged_flash_gqa_decode"] = max(err["paged_flash_gqa_decode"],
                                            e["paged"], e["paged8"])
        print(f"  {c['label']} (nq {c['q'].shape[1]}): " + ", ".join(
            f"{key} {e[key]:.3g} (<= {val})" for key, val in tol.items())
            + f"; int8 quantization: paged8 vs the bf16 twin "
            f"{e['paged8 vs float']:.3g} (information)")
    # timings at the target's last layer, bf16 and int8
    c = [c for c in cases if c["label"].startswith("target")][-1]
    t, bounds = decode_timings(c["label"], c, pos)
    rows = []
    for name, key in (("flash_gqa_decode", "dense"),
                      ("paged_flash_gqa_decode", "paged")):
        bound = bounds[key]
        rows.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
            "replaces": TPU_SOURCES[name], "launches": launches[name],
            "max_abs_err": err[name], "ms": t[key],
            "plain_ms": t[key + "_twin"], "bound_ms": bound[0],
            "bound_by": bound[1], "library_ms": t["library"],
            "share_of_bound": bound[0] / t[key], "int8_ms": t[key + "8"]})
    rows[1]["gather_library_ms"] = t["gather_library"]
    return rows


def decode_timings(label, c, pos):
    """Device times (graph_ms) of both decode kernels in bf16 and int8,
    their twins and two yardsticks on one pool ``c``: one
    scaled_dot_product_attention call over the gathered bf16 cache, and
    page_gather of K and V + the pos mask + that call (the paged
    kernel's whole job done by library calls).  Prints achieved GB/s and
    the share of the bytes bound.  Returns (times, bounds)."""
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.models.attention import page_gather
    q, pt = c["q"], c["pt"]
    ptl = pt.long()
    B, nq, hd = q.shape
    nkv, maxp = c["k"].shape[2], pt.shape[1]
    lib_fn, lib_how = sdpa_call(q, c["gk"], c["gv"], pos)
    e_lib = float((lib_fn()[:, :, 0].float() - c["paged"]).abs().max())

    def gather_lib():
        return sdpa_call(q, page_gather(c["k"], ptl), page_gather(c["v"], ptl),
                         pos)[0]()
    t = {
        "paged": graph_ms(lambda: ops.paged_gqa_decode(q, c["k"], c["v"], pt,
                                                       pos)),
        "dense": graph_ms(lambda: ops.gqa_decode(q, c["gk"], c["gv"], pos)),
        "paged8": graph_ms(lambda: ops.paged_gqa_decode(
            q, c["k8"], c["v8"], pt, pos, c["ks"], c["vs"])),
        "dense8": graph_ms(lambda: ops.gqa_decode(
            q, c["gk8"], c["gv8"], pos, c["gks"], c["gvs"])),
        "paged_twin": graph_ms(lambda: ref.paged_gqa_decode_ref(
            q, c["k"], c["v"], pt, pos)),
        "dense_twin": graph_ms(lambda: ref.gqa_decode_ref(q, c["gk"], c["gv"],
                                                          pos)),
        "library": graph_ms(lib_fn),
        "gather_library": graph_ms(gather_lib),
    }
    p = pos.tolist()
    bounds = {"paged": decode_bound(B, nq, nkv, hd, p, 2, paged_cols=maxp),
              "dense": decode_bound(B, nq, nkv, hd, p, 2),
              "paged8": decode_bound(B, nq, nkv, hd, p, 1, paged_cols=maxp,
                                     scales=True),
              "dense8": decode_bound(B, nq, nkv, hd, p, 1, scales=True)}
    print(f"  device times ({GRAPH_CALLS} calls per CUDA graph), {label} "
          f"(B {B}, nq {nq}, nkv {nkv}, hd {hd}, capacity "
          f"{maxp * c['k'].shape[1]}, pos {p if B <= 8 else 'see above'}, "
          f"bf16 q; cache bf16 or int8): "
          + ", ".join(f"{key} {v:.4f} ms" for key, v in t.items())
          + f"; library = scaled_dot_product_attention over the gathered "
          f"bf16 cache with the pos mask ({lib_how}), off the paged kernel "
          f"by {e_lib:.3g}; gather_library = page_gather + mask + that call")
    for key, (ms, by, nbytes) in bounds.items():
        print(f"    {key}: bound {ms:.5f} ms ({by}, {nbytes / 1e6:.2f} MB "
              f"over {HBM_BYTES_PER_S / 1e12} TB/s); {t[key]:.4f} ms = "
              f"{nbytes / t[key] / 1e6:.1f} GB/s, {ms / t[key]:.3f} of the "
              f"bound")
    return t, bounds


# ----------------------------------------------------------------------
# phase 7: the flash-decode kernels on a pool larger than L2
# ----------------------------------------------------------------------
def phase_long_pool(dev, tc, rows):
    """32 slots with pos drawn uniformly from [2048, 4095], 16-position
    pages permuted over a pool of 8192 + 1 (trash) pages, table entries
    past a slot's pages on the trash page; the target's attention widths
    (nq 16, nkv 2, hd 128), bf16 and int8.  Adds the long-pool numbers to
    the two decode rows."""
    import numpy as np
    import torch
    from repro_torch.kernels import decode_attention as da, ops, ref
    from repro_torch.models.attention import page_gather
    nq, nkv, hd = tc.n_heads, tc.n_kv_heads, tc.head_dim
    rng = np.random.default_rng(POOL_SEED)
    pos_np = rng.integers(POOL_POS[0], POOL_POS[1] + 1,
                          POOL_SLOTS).astype(np.int32)
    maxp = POOL_CAP // PAGE
    perm = rng.permutation(POOL_PAGES)
    table = np.full((POOL_SLOTS, maxp), POOL_PAGES, np.int32)
    used = 0
    for b, p in enumerate(pos_np):
        n = int(p) // PAGE + 1
        table[b, :n] = perm[used:used + n]
        used += n
    g = torch.Generator(device=dev).manual_seed(POOL_SEED)
    shape = (POOL_PAGES + 1, PAGE, nkv, hd)
    pk = torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
    pv = torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
    q = torch.randn((POOL_SLOTS, nq, hd), generator=g, device=dev).to(
        torch.bfloat16)
    pt = torch.from_numpy(table).to(dev)
    pos = torch.from_numpy(pos_np).to(dev)
    k8, ks = da.quantize_kv(pk)
    v8, vs = da.quantize_kv(pv)

    def gather(pool):
        return page_gather(pool, pt.long()).contiguous()
    c = dict(label="long pool", q=q, k=pk, v=pv, pt=pt, gk=gather(pk),
             gv=gather(pv), k8=k8, ks=ks, v8=v8, vs=vs, gk8=gather(k8),
             gv8=gather(v8), gks=gather(ks), gvs=gather(vs))
    print(f"phase 7: flash-decode kernels on a long pool: {POOL_SLOTS} "
          f"slots, pos {pos_np.tolist()}, capacity {POOL_CAP}, page {PAGE}, "
          f"{used} of {POOL_PAGES} pages (+1 trash), pool "
          f"{2 * pk.numel() * 2 / 1e6:.1f} MB bf16; {used * PAGE} positions")
    da.reset_launches()
    c["paged"] = ops.paged_gqa_decode(q, pk, pv, pt, pos)
    c["dense"] = ops.gqa_decode(q, c["gk"], c["gv"], pos)
    c["paged8"] = ops.paged_gqa_decode(q, k8, v8, pt, pos, ks, vs)
    c["dense8"] = ops.gqa_decode(q, c["gk8"], c["gv8"], pos, c["gks"],
                                 c["gvs"])
    torch.cuda.synchronize()
    launches = dict(da.LAUNCHES)
    print(f"  launches: {launches}")
    check(all(v > 0 for v in launches.values()),
          f"a decode kernel never ran on the long pool: {launches}")
    twin = ref.gqa_decode_ref(q, c["gk"], c["gv"], pos)
    twin8 = ref.gqa_decode_ref(q, c["gk8"], c["gv8"], pos, c["gks"],
                               c["gvs"])
    e = {"paged": float((c["paged"] - twin).abs().max()),
         "paged8": float((c["paged8"] - twin8).abs().max()),
         "paged8 vs float": float((c["paged8"] - twin).abs().max())}
    for key, tol in (("paged", ATOL_BF16), ("paged8", ATOL_F32),
                     ("paged8 vs float", ATOL_INT8_ORACLE)):
        check(e[key] <= tol, f"long pool: {key} error {e[key]:.3g} > {tol}")
    check(torch.equal(c["paged"], c["dense"])
          and torch.equal(c["paged8"], c["dense8"]),
          "long pool: paged and dense kernels differ on gathered pages")
    check(bool(torch.isfinite(c["paged"]).all()), "long pool: not finite")
    print(f"  paged vs twin {e['paged']:.3g} (<= {ATOL_BF16}), int8 vs twin "
          f"{e['paged8']:.3g} (<= {ATOL_F32}), int8 vs the bf16 twin "
          f"{e['paged8 vs float']:.3g} (< {ATOL_INT8_ORACLE}); paged equals "
          f"dense bit for bit in bf16 and int8")
    t, bounds = decode_timings("long pool", c, pos)
    for r in rows:
        key = {"flash_gqa_decode": "dense",
               "paged_flash_gqa_decode": "paged"}.get(r["name"])
        if key is None:
            continue
        r["launches"] += launches[r["name"]]
        # the dense kernel's output equals the paged one's (checked above)
        r["max_abs_err"] = max(r["max_abs_err"], e["paged"], e["paged8"])
        r.update({"long_ms": t[key], "long_plain_ms": t[key + "_twin"],
                  "long_bound_ms": bounds[key][0],
                  "long_share_of_bound": bounds[key][0] / t[key],
                  "long_library_ms": t["library"],
                  "long_int8_ms": t[key + "8"]})
    rows[-1]["long_gather_library_ms"] = t["gather_library"]


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
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import sqs_fused as k
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        libs = list(pool.map(lambda m: m.build(verbose=True), (k, da)))
    print("phase 1: built " + ", ".join(os.path.relpath(lib, HERE)
                                       for lib in libs)
          + f" in {time.perf_counter() - t0:.1f} s")
    phase_kernels()
    phase_decode_kernels()
    from repro_torch import configs
    dev = torch.device("cuda")
    tc = configs.get_config("qwen2.5-3b")
    dc = configs.draft_variant(tc, 2)
    engines, launches = phase_main_path(dev, tc, dc)
    print("phase 4: timings at the main path's inputs")
    rows = phase_timing(engines, launches)
    check(all(r["launches"] > 0 for r in rows), "a kernel never ran")
    eng = engines["csqs"]
    tp, dp = eng.cloud.model, eng.edge.model
    del engines, eng
    serve_launches = phase_serving(dev, tc, dc, tp, dp)
    for r in rows:
        r["launches"] += serve_launches[r["name"]]
    rows += phase_served_pools(dev, tc, dc, tp, dp)
    phase_long_pool(dev, tc, rows)
    print(smi[0])
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
