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
     index trim on tied logits), the top-K search's lo equal to the K-th
     largest probability (within ULP_RULE ulps of the twin's) at T 1 and
     0.5 and, at logit std 3 and 8, T 0.2 and 0.05 (where the
     reference's search stops at max q * 2^-40), timed there by graph
     replay, and rows whose K-th value underflows to 0 with their
     nonzero probabilities past the first K indices (the support holds
     them), and at the vocabularies of the other
     dense configs (granite-3-8b's 49155, padded to 49280; stablelm-12b's
     100352; deepseek-7b's 102400) and of the paper's pair (gptneo-1.3b's
     50257, padded to 50304), and C-SQS at beta 0 and -0.01 on rows
     padded past V 50257 and 1003 (K == V, nothing past V, sum b ==
     ell); the two flash-decode kernels over
     the reference's sweeps in f32, bf16 and int8, paged against dense
     on gathered pages, and the serving shape (nq 16, nkv 2, hd 128,
     bf16);
  3. the fixed-batch main path through its user entry point
     (``EdgeCloudEngine.run``) at full ``qwen2.5-3b`` width with a
     ``qwen2.5-3b-draft2x`` edge model, bf16 random weights from a seed,
     for ksqs/csqs (codecs v1 and v2), qs and uncompressed, with the
     kernel launch counts of that run and output checks, and one ksqs
     draft call under torch.profiler (device-busy share, SQS kernel time);
  4. SQS kernel, twin and library timings at the main path's inputs, with
     each kernel's cluster plan and the barriers of each call;
     sqs_fused within SQS_FUSED_SLACK of its time before the C-SQS
     support was cut to the true vocabulary;
  5. continuous-batching serving (``ServeSession.run_trace``) of one Poisson
     trace (SERVE_REQUESTS requests on SLOTS slots) at full width: dense
     lockstep, paged lockstep, paged pipelined with speculation, and int8
     paged against int8 dense, with per-request streams equal across them,
     a request admitted into a slot that another had finished in (each of
     the first three), the launch counts of that path and the measured
     per-round t_slm / t_llm; (b) a confirmed speculative round against
     another slot's replay: (i) on the full-width slot engine, dense and
     paged, the round after it equal with and without a draft of another
     slot between its drafting and its confirmation; (ii) the smoke
     qwen2.5-3b as its own draft at T 0.35 over a seeded trace,
     pipelined equal to lockstep, with its speculation hits;
  6. the flash-decode kernels on the page pools that serving wrote (4
     slots admitted through the slot API with prompts of 17 to 4001
     tokens, two paged rounds): against their twins and each other (paged
     equal to dense bit for bit), in bf16 and int8, with their launch
     counts, device times, the ``scaled_dot_product_attention`` and
     page gather + SDPA yardsticks and the bytes bound;
  7. the same kernels on a long pool larger than L2: 32 slots of up to
     4096 positions (pos drawn from [2048, 4095]) in 16-position pages
     permuted over a pool of 8192 + 1 pages, at the target's attention
     widths, bf16 and int8, checked and timed as in phase 6;
  8. two processes on the card: ``python -m repro_torch.launch.cloud`` as a
     child process, and an ``EdgeClient`` in this one serving a seeded 2-cell
     Poisson trace (SERVE_REQUESTS requests) at full ``qwen2.5-3b`` width,
     C-SQS, lockstep with codec v1 and verdict batching, then pipelined with
     codec v2 and speculation, obs on both legs: the streams equal the
     in-process simulator's on the same weights, a request admitted into a
     freed slot over TCP, with the measured RPC round
     (mean, p99), the server's t_llm, the measured makespan beside the
     simulator's modeled one and the server's counters (0 wire decode errors);
  9. the serving entry point (``repro_torch.launch.serve.main``) with
     ``--transport tcp --trace-out --metrics-out`` against the same
     server, lockstep: the Theorem-1 decomposition must reconcile and
     the modeled and wall-clock spans be present; then the server is
     sent SIGTERM and must print its shutdown line and exit 0;
 10. ``qwen2-moe-a2.7b`` at full width (60 routed top-4 + 4 shared
     experts) cut from 24 to MOE_LAYERS layers with its 2x draft, after the
     qwen2.5-3b models are freed: fixed-batch K-SQS and C-SQS rounds at
     the phase-3 settings, both SQS kernels against their twins at the
     draft's next-step logits, a short trace served lockstep and
     pipelined with equal streams;
 11. the paper's pair trained and served, after the MoE models are
     freed: (a) full-width ``gptneo-1.3b`` (24 layers, d 2048, 16/16
     heads, V 50257; float32 masters, bf16 compute, AdamW, per-layer
     remat) train steps at B 8 x S 512, with microbatches 1 and then 2
     from the same start (losses agree within TRAIN_LOSS_ATOL), step time
     by CUDA events, tokens/s, peak memory, and one step under
     torch.profiler (busy share, device time by op class); (b) the
     target and its 2x draft trained from seeded weights on
     ``benchmarks/common.py`` ``trained_pair``'s corpus at V 50257 (the
     loss must fall by 0.5), saved with the port's ``checkpoint.save``;
     (c) served from those checkpoints through
     ``repro_torch.launch.serve.main``: fixed-batch K-SQS and C-SQS at
     the phase-3 settings (accepted tokens in every method, both SQS
     kernels launched at Vp 50304, the dropped mass a draft printed) and
     a short pipelined trace; then phase 16 on the same checkpoints.

 12. the SSM and hybrid family, after the pair's models are freed: (a)
     full-width ``xlstm-1.3b`` (7 mLSTM : 1 sLSTM, d 2048, 4 heads, mLSTM
     width 4096, V 50304) cut from 48 to SSM_LAYERS layers with its 2x
     draft, seeded bf16
     weights, fixed-batch rounds of all four methods at the phase-3
     settings, both SQS kernels against their twins at the draft's
     next-step logits, t_slm / t_llm / accepted tokens, one K-SQS draft
     call under torch.profiler; (b) rollback after uncompressed rounds
     with every draft sent (rows accept tokens; the phase fails if none
     does): at full width in bf16 and then in float32, each row's
     rolled-back target and draft states against a fresh prefill of its
     verified prefix, the first layer within ROLLBACK_RTOL_FIRST and the
     state one token short outside it, and in float32 every layer within
     ROLLBACK_FLOOR_MULT times its batch floor and the next-token argmax
     equal; and the reference's check (next-token logits of the two
     caches, equal argmax and 3e-4) at the float32 smoke variants of
     ``xlstm-1.3b`` and ``jamba-1.5-large-398b``; (c) the
     ``jamba-1.5-large-398b`` smoke pair served as a 4-request lockstep
     trace, dense and paged with equal streams, and one full-width Mamba
     layer (d 8192, d_inner 16384, d_state 16) at B 4 x S 16 in float32
     and bf16: the sequence form with its trajectory against the step
     loop; then a pipelined trace and a TCP handshake with a stateful
     target, each refused, with the peak memory of the phase.
 13. MLA with its dense prefix layer, and the sliding window, after the
     SSM models are freed: (a) full-width ``deepseek-v2-lite-16b`` cut
     from 27 to MLA_LAYERS layers (the first a dense MLP layer, MLA with
     kv_lora 512 and
     rope_hd 64, 64 routed top-6 + 2 shared experts, V 102400) with its
     2x draft, seeded bf16 weights: fixed-batch rounds of all four
     methods at the phase-3 settings, both SQS kernels against their
     twins at the draft's next-step logits (Vp 102400), one K-SQS draft
     call and one verify forward under torch.profiler (busy share, GEMM
     time, the MoE layers' share), and a 4-request trace served dense
     lockstep, paged lockstep and paged pipelined with equal streams;
     (b) the ring of ``for_shape(qwen2.5-3b, long_500k)`` (W 8192) at
     full width, cut from 36 to WINDOW_LAYERS layers for (b)-(d) (its
     draft to 6): a prompt RING_PAST positions past W prefilled (the ring
     wrapped), RING_STEPS decode steps through it against the windowed
     teacher-forced logits, in bf16 and in float32, each within its
     bound of RING_ATOL, and the reference's ring check at the float32
     smoke variant (W 8) at RING_SMOKE_ATOL; (c) ROUNDS K-SQS rounds
     served on the ring at a capacity it cannot wrap, then the pair
     served past the wrap on the engine's rings of W + ring_spare(L_MAX)
     slots: prompts of W + WRAP_PAST + 1 tokens (B 4), K-SQS rounds
     (which reject) and uncompressed rounds at WRAP_BUDGET bits (which
     accept), fixed batch and a pipelined trace with speculation, their
     SQS launches counted and t_slm / t_llm printed beside the round
     before the wrap, and each row's target and draft caches held
     against a teacher-forced windowed recompute of its committed tokens
     at RING_ATOL; (d) the float32 pair at W SMALL_W, where
     one lost key shows, served past its wrap with the engine's spare
     (fixed batch and a pipelined trace, within RING_ATOL["float32"])
     and with none (fixed batch, the target past it).

 14. the encoder-decoder and M-RoPE family, after the MLA models are
     freed: (a) ``qwen2-vl-72b`` at full width (d 8192, 64/8 heads,
     d_ff 29568, V 152064, M-RoPE sections (16, 24, 24), qkv biases) cut
     from 80 to VL_LAYERS layers (33.07 GB bf16; 145.4 GB does not fit)
     with its 2x draft cut in the same proportion, from 40 to
     VL_DRAFT_LAYERS layers (d 4096): fixed-batch rounds
     of all four methods at the phase-3 settings, both SQS kernels against
     their twins at the draft's next-step logits (Vp 152064), one K-SQS
     draft call and one verify forward under torch.profiler, a 4-request
     trace dense lockstep, paged lockstep and paged pipelined with equal
     streams, and a vision prefill (a 16 x 16 patch grid's M-RoPE ids,
     then text) followed by decode steps and an extend against the
     teacher-forced logits at the same positions, in bf16 and, at
     VL_F32_LAYERS layers, in float32; (b) ``seamless-m4t-large-v2`` (24
     encoder + 24 decoder layers, V 256206) and its 2x draft at full
     width and depth over B 4 x 4096 stub audio frames: the encoder
     prefill timed, the cross cache's bytes a frame, decode steps and an
     extend against the teacher-forced logits in bf16 and in float32, a
     decode step's memory rise against a float32 copy of one layer's
     cross K/V (the cache is read in place), both SQS kernels against
     their twins at the draft's logits (Vp 256256, 16 blocks a row), and
     three ``launch.train`` steps of the target with stub frames; (c) the
     engine's ``EncoderDecoderServingError`` for an encoder-decoder
     target or draft, in fixed batch and in slots, and ``launch.serve``'s
     exit 2.

 15. the tooling, after the enc-dec models are freed: (a) the dry run
     (``repro_torch.launch.dryrun.run_combo``: the port's model on the
     meta device, DTensor parameters by the ``Partitioner``, one step of
     rank 0 of the 16 x 16 production mesh, a fake process group of 256
     ranks, fake cuda tensors; begun after phase 1 in DRY_RUN_WORKERS
     processes of its own, on the host's CPU beside phases 2-14, and
     read here) for ``qwen2.5-3b`` x decode_32k,
     ``qwen2-moe-a2.7b`` x prefill_32k with MoE dispatch groups,
     ``xlstm-1.3b`` x long_500k, ``granite-3-8b`` x train_4k,
     ``qwen2.5-3b`` x train_4k (the vocab-parallel cross entropy: its
     peak at most TRAIN_MAX_PEAK), ``jamba-1.5-large-398b`` x decode_32k
     (the Mamba mixers on their shard) and ``xlstm-1.3b`` x prefill_32k
     by the calibrated count (``calibrate=True``), each ``ok``, with its
     peak a device, FLOPs, collective bytes by kind and trace seconds,
     no SSM combo gathering a mixer projection or a state whole
     (``whole_mixer_gathers`` 0) and xlstm's decode moving at most
     SSM_DECODE_MAX_COLL bytes of collectives; (b) rank 0 of the same
     mesh for real on the card (``dryrun.run_rank0``) for each combo
     traced whole whose dry-run peak is at most RANK0_MAX_PEAK: real
     local shards from a seeded generator, no-op collectives, the rise
     of ``max_memory_allocated`` against the dry run's peak (their ratio
     within RANK0_MEM_RATIO), the FLOP count and the collectives by kind
     equal to the dry run's, no whole mixer gather, and the local step's
     time by CUDA events (compute without communication); (c)
     ``examples/torch_quickstart.py``
     in process (both SQS kernels launched) and, beside it,
     ``examples/torch_train_draft_slm.py --steps 4`` as a child process.
 16. the paper's Fig. 2, run after phase 11 (c): (b) first, then (a)
     alone: (a) ``examples/torch_temperature_crossover.py`` with its
     defaults as a child process (the smoke pair trained on the card, 12
     rounds a sweep; exit 0 and all 10 rows); (b) ``torch_pair.crossover`` on
     phase 11's full-width pair at B CROSS_BATCH, CROSS_ROUNDS rounds a
     sweep after 2 warmup rounds, five temperatures, K-SQS and C-SQS, on
     the fused kernels and then on plain torch (the same prompts): per
     temperature and method the latency per batch, resampling and accept
     rates, bits, mean K, the largest dropped mass of a draft and the
     winner; the phase fails if a K-SQS draft on the kernel path drops
     FAULT_DROP of its mass where torch.topk's support on the same q
     drops less than TOPK_DROP, or where the mean K of a method and
     temperature on the kernels differs from plain torch's, and prints
     the mass the reference's search would lose on the same q at K 16
     and 64.

Every phase that drives a path sets the kernels' launch counts to 0
just before it and reads them just after; the SQS rows of the kernels
line add the launches of phases 3, 5, 5 (b), 8, 9, 10, 11, 12, 13, 14,
15 and 16.

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

import contextlib
import gc
import io
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
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
# serving: slots, page size, the requests of the phase-5 and phase-8
# traces (more than the slots: some queue and are admitted into a slot
# that a finished request freed) and the range of their new tokens (the
# serving walls are host-bound: at 8-12 tokens a slow host took phases
# 1-16 to 1188.7 s), and the phase-6 prompt lengths / capacity
SLOTS, PAGE, SERVE_REQUESTS = 4, 16, 6
SERVE_NEW_TOKENS = (5, 8)
LONG_PROMPTS, LONG_CACHE = (17, 1025, 2561, 4001), 4112
# phase 7: slots, positions per slot, pool pages (+1 trash), pos range
POOL_SLOTS, POOL_CAP, POOL_PAGES = 32, 4096, 8192
POOL_POS, POOL_SEED = (2048, 4095), 13
GRAPH_CALLS = 20                   # calls per CUDA graph in graph_ms
# phase 2: the dense configs whose vocabularies the SQS kernels also see
DENSE_VOCAB_ARCHS = ("granite-3-8b", "stablelm-12b", "deepseek-7b",
                     "gptneo-1.3b")
# phases 8-9: two-process serving, 2 cells over the phase-5 slots
TCP_CELLS = 2
MOE_ARCH = "qwen2-moe-a2.7b"
# phase 10 runs it cut from 24 to MOE_LAYERS layers at full width (its
# draft 4 of 12): every layer is the same routed + shared MoE block
MOE_LAYERS = 8
# phase 11: the paper's pair; (a) train steps a run, their batch and
# sequence, and the bound on |loss(microbatches 1) - loss(microbatches 2)|
# a step (bf16 GEMMs of other shapes round otherwise); (b) target and
# draft train steps, the least fall of each loss, and the peak learning
# rate (trained_pair's 2e-3 is for its smoke widths; at d 2048 the loss
# spikes past its start in the first 50 steps)
PAIR_ARCH = "gptneo-1.3b"
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 4, 8, 512
TRAIN_LOSS_ATOL = 2e-2
PAIR_STEPS, DRAFT_STEPS, LOSS_FALL, PAIR_LR = 300, 150, 0.5, 3e-4
BF16_FLOPS = 989e12                # H100 SXM dense bf16 tensor cores
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


def depth_cut(cfg, n_layers):
    """``cfg`` at its published width cut to ``n_layers`` layers (named
    ``<name>-d<n_layers>``)."""
    import dataclasses
    return dataclasses.replace(cfg, name=f"{cfg.name}-d{n_layers}",
                               n_layers=n_layers)


def free_cuda():
    """Return the memory of freed models to the card."""
    import torch
    gc.collect()
    torch.cuda.empty_cache()


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


def compare_sqs(lp, beta2, it, ell, exact_k, label, beta2_twin=None,
                V=None):
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
    (differing rows, rows not excused).  ``V``: the true vocabulary of
    a padded row (None: every lane), given to both."""
    import numpy as np
    import torch
    from repro_torch.kernels import ref, sqs_fused as k
    if beta2_twin is None:
        beta2_twin = beta2
    kb, km, ks = k.sqs_fused(lp, beta2, inv_temp=it, ell=ell,
                             exact_k=exact_k, V=V)
    rb, rm, rs = ref.sqs_fused_ref(lp, beta2_twin, inv_temp=it, ell=ell,
                                   exact_k=exact_k, V=V)
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


def check_kth(tau, q, K, label):
    """The top-K search's lo is the K-th largest of the twin's q (the
    kernel's q may sit ULP_RULE ulps off it: another summation order for
    the softmax denominator), 0 where that underflows, and hi the float32
    after lo."""
    import torch
    kth = torch.topk(q, K, dim=-1).values[:, -1]
    lo, hi = tau[:, 0], tau[:, 1]
    check(bool(near(lo.cpu(), kth.cpu()).all()),
          f"topk_threshold lo is not the K-th value ({label}): "
          f"{lo.tolist()} vs {kth.tolist()}")
    check(bool(torch.equal(hi, torch.nextafter(lo, torch.full_like(
        lo, math.inf)))), f"topk_threshold hi is not the float after lo "
          f"({label}): {tau.tolist()}")
    return kth


# low temperatures for the top-K search: the K-th value lies below max q *
# 2^-40 (the reference's bisection floor) at logit std 3 and 8; the shapes
# and K at which it is held and timed (CUDA-graph replay at the main path's)
LOW_TEMPS, LOW_STDS = (0.2, 0.05), (3.0, 8.0)
LOW_SHAPES, LOW_KS = ((4, 151936), (3, 50257)), (16, 64)


def topk_low_temperature(logits, dev):
    """Phase 2's low-temperature rows: lo equal to torch.topk's K-th value
    within ULP_RULE at T 0.2 and 0.05 and logit std 3 and 8, K-SQS kernel
    against twin there, and rows whose K-th value underflows to 0 with
    their nonzero probabilities past the first K indices (the support
    must hold them).  Returns the rows not excused."""
    import torch
    from repro_torch.kernels import ref, sqs_fused as k
    from repro_torch.kernels.ops import pad_logits
    n_bad = 0
    for (B, V), temp, std, K in ((s, t, d, kk) for s in LOW_SHAPES
                                 for t in LOW_TEMPS for d in LOW_STDS
                                 for kk in LOW_KS):
        lp, it = logits(B, V, scale=std), 1.0 / temp
        q = ref.softmax_padded(lp, it)
        info = torch.zeros((B, 4), dtype=torch.int32, device=lp.device)
        tau = k.topk_threshold(lp, K, inv_temp=it, info=info)
        label = f"B={B} V={V} K={K} T={temp} std={std}"
        kth = check_kth(tau, q, K, label)
        floor = q.amax(-1) * 2.0 ** -40
        nd, nb = compare_sqs(lp, tau, it, 100, K, f"sqs_topk {label}",
                             ref.topk_threshold_ref(q, K))
        n_bad += nb
        ms = graph_ms(lambda: k.topk_threshold(lp, K, inv_temp=it)) \
            if (B, V) == LOW_SHAPES[0] else None
        print(f"  sqs_topk {label}: lo == K-th value (within {ULP_RULE} "
              f"ulps) in every row, {int((kth < floor).sum())} of {B} rows "
              f"below max q * 2^-40, {int((kth == 0).sum())} with K-th "
              f"value 0; sqs {nd} differing rows, {nb} unexcused"
              + (f"; topk_threshold {ms:.4f} ms (graph)" if ms else "")
              + f"; row 0: {sqs_path(info[0].tolist())}")
    # K-th value 0 with the nonzero probabilities at high indices: the
    # reference's trim (the first K of q >= 0 by index) keeps zeros
    B, V, K = 2, 151936, 64
    x = torch.full((B, V), -200.0, device=dev)
    x[:, V - 40:] = torch.linspace(0.0, -30.0, 40, device=dev)
    lp = pad_logits(x)[0]
    q = ref.softmax_padded(lp, 1.0)
    tau = k.topk_threshold(lp, K, inv_temp=1.0)
    kth = check_kth(tau, q, K, "underflow")
    nd, nb = compare_sqs(lp, tau, 1.0, 100, K, "sqs_topk underflow",
                         ref.topk_threshold_ref(q, K))
    _, mask, stats = k.sqs_fused(lp, tau, inv_temp=1.0, ell=100, exact_k=K)
    check(bool((kth == 0).all()), f"underflow rows: K-th value {kth}")
    check(bool(mask[:, V - 40:V].bool().all()), "underflow rows: the "
          "support misses a nonzero probability")
    check(bool((stats[:, 0].abs() <= DROPPED_ATOL).all()),
          f"underflow rows drop {stats[:, 0].tolist()}")
    print(f"  sqs_topk underflow B={B} V={V} K={K} (40 nonzero "
          f"probabilities at the last indices): lo {tau[:, 0].tolist()}, "
          f"support holds all 40, dropped {stats[:, 0].tolist()}; sqs "
          f"{nd} differing rows, {nb} unexcused")
    return n_bad + nb


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
                check_kth(tau, q, K, f"B={B} V={V} K={K} T={temp}")
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
    n_bad += topk_low_temperature(logits, dev)
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


def phase_kernels_vocabularies():
    """Both SQS kernels against their twins at the vocabularies of the
    three other dense configs and of the paper's pair (49155 pads to
    49280, 50257 to 50304: the kernels see -inf padding), C-SQS at two
    temperatures and K-SQS at two K."""
    import torch
    from repro_torch import configs
    from repro_torch.kernels import ref, sqs_fused as k
    from repro_torch.kernels.ops import pad_logits
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4242)
    t0 = time.perf_counter()
    n_bad = 0
    print("phase 2: SQS kernels vs plain twins at the other dense configs' "
          "and the paper pair's vocabularies")
    for name in DENSE_VOCAB_ARCHS:
        V = configs.get_config(name).vocab
        lp = pad_logits(torch.randn((BATCH, V), generator=gen, device=dev)
                        * 3.0)[0]
        Vp = lp.shape[1]
        for temp in (0.5, 1.0):
            beta2 = torch.full((BATCH, 2), 2e-3, device=dev)
            nd, nb = compare_sqs(lp, beta2, 1.0 / temp, 100, 0,
                                 f"sqs_threshold {name} V={V} T={temp}")
            print(f"  sqs_threshold {name} B={BATCH} V={V} Vp={Vp} "
                  f"T={temp}: {nd} differing rows, {nb} unexcused")
            n_bad += nb
        for K in (8, 64):
            tau = k.topk_threshold(lp, K, inv_temp=1.0)
            tau_r = ref.topk_threshold_ref(ref.softmax_padded(lp, 1.0), K)
            nd, nb = compare_sqs(lp, tau, 1.0, 100, K,
                                 f"sqs_topk {name} V={V} K={K}", tau_r)
            print(f"  sqs_topk {name} B={BATCH} V={V} Vp={Vp} K={K}: tau "
                  f"differs from twin in {int((tau != tau_r).any(-1).sum())}"
                  f" rows; sqs {nd} differing rows, {nb} unexcused")
            n_bad += nb
    n_bad += padded_csqs(gen, dev)
    check(n_bad == 0, f"{n_bad} kernel rows differ from the twin outside "
          f"the {ULP_RULE}-ulp boundary rule at the other vocabularies")
    print(f"  phase 2 vocabularies: {time.perf_counter() - t0:.1f} s")


# C-SQS at beta <= 0 on padded rows: the paper pair's vocabulary and one
# far from a multiple of 128
PADDED_VOCABS, NONPOS_BETAS = (50257, 1003), (0.0, -0.01)


def padded_csqs(gen, dev):
    """C-SQS at beta 0 and -0.01, where every true token joins the
    support, on rows padded with -inf past V: the kernel against its twin,
    K == V (no padded lane counted), no support or count past V, and
    sum b == ell.  Returns the rows not excused."""
    import torch
    from repro_torch.kernels import sqs_fused as k
    from repro_torch.kernels.ops import pad_logits
    n_bad = 0
    for V in PADDED_VOCABS:
        lp = pad_logits(torch.randn((BATCH, V), generator=gen, device=dev)
                        * 3.0)[0]
        for beta in NONPOS_BETAS:
            beta2 = torch.full((BATCH, 2), beta, device=dev)
            label = f"sqs_threshold V={V} Vp={lp.shape[1]} beta={beta}"
            nd, nb = compare_sqs(lp, beta2, 1.0, 100, 0, label, V=V)
            b, mask, stats = k.sqs_fused(lp, beta2, inv_temp=1.0, ell=100,
                                         V=V)
            check(bool((stats[:, 1] == V).all()), f"{label}: K "
                  f"{stats[:, 1].tolist()} != V")
            check(not bool(mask[:, V:].any() or b[:, V:].any()),
                  f"{label}: support or counts past V")
            check(bool((b.sum(-1) == 100).all()), f"{label}: sum b "
                  f"{b.sum(-1).tolist()}")
            print(f"  {label}: K {stats[:, 1].tolist()} == V, nothing past "
                  f"V, sum b == 100; {nd} differing rows, {nb} unexcused")
            n_bad += nb
    return n_bad


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
        lt, _, _ = model_mod.extend_step(eng.cloud.model,
                                      eng.cloud.x_last[:, None],
                                      eng.cloud.tcache, eng.cloud.pos)
        check(bool(torch.isfinite(lg).all() and torch.isfinite(lt).all()),
              f"{method}: NaN/inf logits")
        engines[method] = eng
    profile_draft(engines["ksqs"])
    return engines, launches


SQS_KERNELS = ("sqs_fused_kernel", "topk_threshold_kernel")


def device_ops(prof):
    """Device time (µs) of a ``torch.profiler`` run and its (µs, calls,
    name) rows: the kernels' own rows (the CPU ops' rows repeat them), as
    the profiler's table totals them."""
    import torch
    dev_us, by_op = 0.0, []
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA \
                or getattr(ev, "is_user_annotation", False):
            continue
        t = getattr(ev, "self_device_time_total",
                    getattr(ev, "self_cuda_time_total", 0.0))
        if t > 0:
            dev_us += t
            by_op.append((t, ev.count, ev.key))
    return dev_us, by_op


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
    dev_us, by_op = device_ops(prof)
    sqs_us, sqs_n = {}, {}
    for t, n, key in by_op:
        for name in SQS_KERNELS:
            if name in key:
                sqs_us[name] = sqs_us.get(name, 0.0) + t
                sqs_n[name] = sqs_n.get(name, 0) + n
    if dev_us == 0.0:
        print("  profiler, one ksqs draft call: the profiler saw no device "
              "time (device-busy share not measured)")
        return prof, dev_us
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
    return prof, dev_us


# ----------------------------------------------------------------------
# phase 4: timings at the main path's inputs
# ----------------------------------------------------------------------
def timed(fn):
    """Device time of one call by CUDA-graph replay, and its one-call
    event time (host work of the call inside the window)."""
    return graph_ms(fn), cuda_ms(fn)


# sqs_fused's graph-replay time at phase 4's input before the C-SQS
# support was cut to the true vocabulary (PERF.md, kernel table row 1),
# and how far above it the kernel may now run
SQS_FUSED_MS, SQS_FUSED_SLACK = 0.0407, 0.05


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
        if name == "sqs_fused":
            check(t <= SQS_FUSED_MS * (1.0 + SQS_FUSED_SLACK),
                  f"sqs_fused {t:.4f} ms at the main-path input, more than "
                  f"{SQS_FUSED_SLACK:.0%} over {SQS_FUSED_MS} ms")
            print(f"  sqs_fused: {t / SQS_FUSED_MS:.3f} of the "
                  f"{SQS_FUSED_MS} ms before the padded-lane cut (at most "
                  f"{1.0 + SQS_FUSED_SLACK:.2f})")
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


def slot_reuses(label, requests, n_slots):
    """The admissions into a slot that another request had finished in:
    (freed by, admitted) request ids.  Where the trace holds more requests
    than ``n_slots`` there must be one."""
    reuse = [(a.rid, b.rid) for a in requests for b in requests
             if a is not b and a.slot == b.slot and a.t_finish is not None
             and b.t_admit is not None and b.t_admit >= a.t_finish]
    check(bool(reuse) or len(requests) <= n_slots,
          f"{label}: {len(requests)} requests on {n_slots} slots, none "
          f"admitted into a freed slot")
    return reuse


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
    reuse = slot_reuses(label, rep.requests, cfg["max_batch"])
    summ = rep.summary()
    print(f"  {label}: {wall:.1f} s wall; admitted into a freed slot "
          f"(freed by, admitted): {reuse}; " + json.dumps(
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
    trace = dict(n_requests=SERVE_REQUESTS, rate_rps=4.0,
                 prompt_len=PROMPT_LEN, min_new_tokens=SERVE_NEW_TOKENS[0],
                 max_new_tokens=SERVE_NEW_TOKENS[1],
                 vocab=tc.vocab, seed=5)
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
# phase 5 (b): a confirmed speculative round against another slot's replay
# ----------------------------------------------------------------------
# (i) L_max 4 and a budget under two drafts' bits: round t sends n_live =
# 1 <= L_max - 2 drafts; (ii) tests/test_torch_spec_replay.py's serving
# setting and its trace of seed 7, on the smoke qwen2.5-3b as its own
# draft (seeded on the card)
SPEC_L_MAX, SPEC_BUDGET = 4, 1.0
SPEC_SERVE = dict(L_max=SPEC_L_MAX, bit_budget=400.0, temperature=0.35)
SPEC_TRACE = dict(n_requests=6, rate_rps=20.0, prompt_len=10,
                  min_new_tokens=16, max_new_tokens=24, vocab=512, seed=7)


def forced_interleaving(eng, V, interleave, page_size):
    """On 2 slots: draft both, speculate slot 0, verify slot 1 and (with
    ``interleave``) draft it again, which replays slot 0; confirm slot
    0's premise, accept its speculative round, draft slot 0.  Returns
    that round's (n_live of round t, drafts, packed bytes)."""
    import numpy as np
    from repro_torch.core import wire
    eng.init_slots(2, 48, page_size=page_size)
    rng = np.random.default_rng(0)
    for s in range(2):
        eng.admit_slot(s, rng.integers(0, V, PROMPT_LEN), seed=s + 11)
    recs = eng.draft_slots([0, 1])
    spec = eng.draft_speculative_slot(0, recs[0])
    check(spec is not None, "phase 5 (b): no speculative round")
    vb = eng.verify_slots({1: recs[1].packed})
    eng.apply_verdict_slot(1, vb.verdicts[1], recs[1])
    if interleave:
        eng.draft_slots([1])
    r0, sr = recs[0], spec.round
    hit = wire.VerdictPayload(n_accept=r0.n_live, new_token=spec.in_x,
                              beta_next=float(r0.betas[r0.n_live]))
    check(eng.spec_premise_holds(spec, r0, hit), "phase 5 (b): premise")
    eng.apply_verdict_slot(0, hit, r0, shrink=False)
    eng.commit_speculative(spec)
    eng.apply_verdict_slot(0, wire.VerdictPayload(
        n_accept=sr.n_live, new_token=int(sr.drafts[sr.n_live]),
        beta_next=float(sr.betas[sr.n_live])), sr)
    rec = eng.draft_slots([0])[0]
    return r0.n_live, rec.drafts.tolist(), rec.packed


def count_replayed_hits(eng):
    """Wrap ``eng``'s edge so that it counts the confirmed speculative
    rounds that a draft of another slot replayed between their drafting
    and their confirmation; returns the one-entry counter."""
    edge, open_, n = eng.edge, {}, [0]
    spec, draft, commit = (edge.draft_speculative, edge.draft,
                           edge.commit_speculative)

    def on_spec(slot, *a):
        open_[slot] = False
        return spec(slot, *a)

    def on_draft(mask):
        for s in open_:
            open_[s] = open_[s] or not mask[s]
        for s in [int(s) for s in mask.nonzero()[0]]:
            open_.pop(s, None)
        return draft(mask)

    def on_commit(sp):
        n[0] += open_.pop(sp.slot, False)
        return commit(sp)
    edge.draft_speculative, edge.draft = on_spec, on_draft
    edge.commit_speculative = on_commit
    return n


def phase_spec_replay(dev, tc, dc, tp, dp):
    """(i) the forced interleaving on the full-width slot engine, dense
    and paged: the round after a confirmed speculative round gives the
    same drafts and payload bytes with and without another slot's draft
    between; (ii) the smoke self-pair served pipelined and lockstep at
    T 0.35: equal streams, with the speculation hits printed.  Returns
    the SQS launches."""
    from repro_torch import bridge, configs
    from repro_torch.core.engine import (EdgeCloudEngine, EngineConfig,
                                         MethodConfig)
    from repro_torch.kernels import sqs_fused as k
    from repro_torch.serve import (ServeConfig, ServeSession, TraceConfig,
                                   poisson_trace)
    t0 = time.perf_counter()
    print(f"phase 5 (b): a confirmed speculative round against another "
          f"slot's replay ({tc.name} <- {dc.name}, csqs, L_max "
          f"{SPEC_L_MAX}, budget {SPEC_BUDGET} bits)")
    k.reset_launches()
    eng = EdgeCloudEngine(dc, dp, tc, tp, MethodConfig("csqs"),
                          EngineConfig(L_max=SPEC_L_MAX,
                                       bit_budget=SPEC_BUDGET),
                          seed=0, device=dev)
    for page_size in (0, PAGE):
        alone, mixed = (forced_interleaving(eng, tc.vocab, inter, page_size)
                        for inter in (False, True))
        layout = f"paged({page_size})" if page_size else "dense"
        check(alone[0] <= SPEC_L_MAX - 2, f"phase 5 (b) {layout}: n_live "
              f"{alone[0]}")
        check(mixed == alone, f"phase 5 (b) {layout}: the round after the "
              f"confirmed speculative round moved with the replay: drafts "
              f"{mixed[1]} vs {alone[1]}, payloads of {len(mixed[2])} and "
              f"{len(alone[2])} bytes")
        print(f"  (i) {layout}: n_live {alone[0]}; next round's drafts "
              f"{alone[1]} and its {len(alone[2])} payload bytes equal with "
              f"and without slot 1's draft")
    del eng
    cfg = configs.smoke_variant(configs.get_config("qwen2.5-3b"))
    m = bridge.seeded_model(cfg, 1, device=dev)
    streams = {}
    for pipe in ("lockstep", "pipelined"):
        eng = EdgeCloudEngine(cfg, m, cfg, m, MethodConfig(
            "csqs", alpha=5e-3, eta=5e-2), EngineConfig(**SPEC_SERVE),
            seed=0, device=dev)
        replayed = count_replayed_hits(eng)
        rep = ServeSession(eng, ServeConfig(
            max_batch=SLOTS, cache_len=64, t_slm_s=0.01, t_llm_s=0.02,
            pipeline=pipe)).run_trace(poisson_trace(TraceConfig(
                **SPEC_TRACE)))
        check(rep.n_finished == SPEC_TRACE["n_requests"],
              f"phase 5 (b) {pipe}: {rep.n_finished} finished")
        streams[pipe] = {r.rid: tuple(r.tokens) for r in rep.requests}
    check(streams["pipelined"] == streams["lockstep"],
          "phase 5 (b): pipelined streams differ from lockstep")
    check(rep.n_spec_hits > 0, "phase 5 (b): no speculation hit")
    print(f"  (ii) smoke self-pair, T {SPEC_SERVE['temperature']}, budget "
          f"{SPEC_SERVE['bit_budget']:.0f}, trace seed {SPEC_TRACE['seed']}:"
          f" pipelined == lockstep "
          f"({sum(map(len, streams['lockstep'].values()))} tokens); "
          f"{rep.n_spec_hits} hits ({replayed[0]} replayed by another "
          f"slot's draft before their confirmation), {rep.n_spec_misses} "
          f"misses")
    launches = dict(k.LAUNCHES)
    check(launches["sqs_fused"] > 0, f"phase 5 (b) launched {launches}")
    print(f"  phase 5 (b): launches {launches}; "
          f"{time.perf_counter() - t0:.1f} s")
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


# ----------------------------------------------------------------------
# phases 8-9: two processes on the card
# ----------------------------------------------------------------------
def start_cloud(tmp, dev):
    """``python -m repro_torch.launch.cloud`` on ``dev`` (the card) as a
    child process, its output in a file; returns (process, port, log
    path)."""
    from repro_torch.serve.net import wait_port_file
    port_file = os.path.join(tmp, "cloud.port")
    log_path = os.path.join(tmp, "cloud.log")
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
    with open(log_path, "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.cloud", "--device",
             dev.type, "--port", "0", "--port-file", port_file],
            stdout=log, stderr=subprocess.STDOUT, env=env, cwd=HERE)
    try:
        port = wait_port_file(port_file, timeout_s=180.0)
    except TimeoutError as e:
        proc.kill()
        proc.wait()
        with open(log_path) as f:
            raise CheckFailed(f"the cloud server did not start: {e}; its "
                              f"output: {f.read()[-2000:]}") from e
    check(proc.poll() is None, "the cloud server exited after starting")
    return proc, port, log_path


def stop_cloud(proc, log_path):
    """SIGTERM the server; it must print its shutdown line and exit 0.
    Returns the shutdown line."""
    import signal
    proc.send_signal(signal.SIGTERM)
    try:
        rc = proc.wait(timeout=60)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        raise CheckFailed("the cloud server ignored SIGTERM")
    with open(log_path) as f:
        lines = f.read().splitlines()
    down = [ln for ln in lines if ln.startswith("[cloud] shutting down "
                                                "(SIGTERM)")]
    check(rc == 0 and len(down) == 1, f"cloud server exit {rc}, output "
          f"tail {lines[-5:]}")
    return down[0]


def tcp_leg(label, dev, tc, dc, tp, dp, port, pipeline, codec, batch,
            trace_cfg):
    """The in-process simulator and an EdgeClient against the cloud
    process on one seeded trace, obs on both legs; the streams must be
    equal.  Returns (SQS launches of the tcp run, numbers to print)."""
    import numpy as np
    from repro_torch.core.engine import (EdgeCloudEngine, EngineConfig,
                                         MethodConfig)
    from repro_torch.kernels import sqs_fused as k
    from repro_torch.obs import Obs, span_names_by_clock
    from repro_torch.serve import (EdgeClient, ServeConfig, ServeSession,
                                   TraceConfig, poisson_trace)
    method = MethodConfig("csqs")
    ecfg = EngineConfig(L_max=L_MAX, wire_codec=codec)
    serve_kw = dict(max_batch=SLOTS, cache_len=48, n_cells=TCP_CELLS,
                    pipeline=pipeline, verdict_batch=batch)
    obs = Obs.on()
    t0 = time.perf_counter()
    sim = ServeSession(
        EdgeCloudEngine(dc, dp, tc, tp, method, ecfg, seed=0, device=dev),
        ServeConfig(t_slm_s=0.05, t_llm_s=0.03, **serve_kw), obs=obs) \
        .run_trace(poisson_trace(TraceConfig(**trace_cfg)))
    t_sim = time.perf_counter() - t0
    client = EdgeClient(dc, dp, method, ecfg, ServeConfig(**serve_kw),
                        arch=tc.name, smoke=False, host="127.0.0.1",
                        port=port, seed=0, obs=obs, device=dev,
                        session_id=f"chip-smoke-{pipeline}-{codec}")
    k.reset_launches()
    t0 = time.perf_counter()
    with client:
        rep = client.run_trace(poisson_trace(TraceConfig(**trace_cfg)))
    t_tcp = time.perf_counter() - t0
    launches = dict(k.LAUNCHES)
    sim_streams = {r.rid: tuple(r.tokens) for r in sim.requests}
    check(rep.n_finished == trace_cfg["n_requests"],
          f"{label}: {rep.n_finished} finished")
    check(rep.streams() == sim_streams, f"{label}: tcp streams differ from "
          f"the simulator's")
    reuse = slot_reuses(f"{label} tcp", rep.requests, SLOTS)
    check(launches["sqs_fused"] > 0, f"{label}: the edge never launched "
          f"sqs_fused: {launches}")
    names = span_names_by_clock(obs.tracer.chrome_trace())
    check({"draft", "uplink", "verify", "downlink"} <= names["modeled"]
          and {"draft", "verify_rpc"} <= names["wall"],
          f"{label}: spans {names}")
    c = rep.cloud_stats["counters"]
    check(c.get("cloud.wire_decode_errors", 0) == 0,
          f"{label}: wire decode errors {c}")
    rpc = np.asarray(client._rpc_s)
    print(f"  {label}: streams equal the simulator's ({len(sim_streams)} "
          f"requests, {sum(map(len, sim_streams.values()))} tokens; "
          f"admitted into a freed slot (freed by, admitted): {reuse}); "
          f"launches {launches}; sim {t_sim:.1f} s wall, tcp "
          f"{t_tcp:.1f} s wall")
    print(f"    measured RPC round mean {rpc.mean() * 1e3:.2f} ms, p50 "
          f"{np.percentile(rpc, 50) * 1e3:.2f} ms, p99 "
          f"{np.percentile(rpc, 99) * 1e3:.2f} ms over {rpc.size}; server "
          f"t_llm mean {rep.t_llm_s['mean'] * 1e3:.2f} ms; edge t_slm mean "
          f"{rep.t_slm_s['mean'] * 1e3:.2f} ms; makespan measured "
          f"{rep.makespan_s:.3f} s vs simulator (modeled) "
          f"{sim.makespan_s:.3f} s; cloud verify_rpcs "
          f"{c.get('cloud.verify_rpcs', 0)}, wire_decode_errors "
          f"{c.get('cloud.wire_decode_errors', 0)}; spec hits "
          f"{rep.n_spec_hits} misses {rep.n_spec_misses}")
    return launches


def phase_tcp(dev, tc, dc, tp, dp, tmp):
    """Phase 8 (two processes, both legs) then phase 9 (the serving entry
    point with --transport tcp --trace-out --metrics-out against the same
    server); SIGTERM last.  Returns the SQS launches of the tcp runs."""
    import json as _json
    from repro_torch.launch import serve as launch_serve
    t0 = time.perf_counter()
    proc, port, log_path = start_cloud(tmp, dev)
    try:
        print(f"phase 8: two processes on the card, {tc.name} <- {dc.name}, "
              f"csqs, {SLOTS} slots in {TCP_CELLS} cells; cloud server pid "
              f"{proc.pid} on port {port} (up in "
              f"{time.perf_counter() - t0:.1f} s)")
        trace = dict(n_requests=SERVE_REQUESTS, rate_rps=4.0,
                     prompt_len=PROMPT_LEN,
                     min_new_tokens=SERVE_NEW_TOKENS[0],
                     max_new_tokens=SERVE_NEW_TOKENS[1], vocab=tc.vocab,
                     seed=5,
                     cells=TCP_CELLS)
        launches = {}
        for label, pipeline, codec, batch in (
                ("lockstep v1 + verdict batching", "lockstep", "v1", True),
                ("pipelined v2 + speculation", "pipelined", "v2", False)):
            got = tcp_leg(label, dev, tc, dc, tp, dp, port, pipeline, codec,
                          batch, trace)
            for name, n in got.items():
                launches[name] = launches.get(name, 0) + n
        print(f"  phase 8: {time.perf_counter() - t0:.1f} s")
        t1 = time.perf_counter()
        trace_out = os.path.join(tmp, "trace.json")
        metrics_out = os.path.join(tmp, "metrics.json")
        print(f"phase 9: repro_torch.launch.serve --trace --transport tcp "
              f"--trace-out --metrics-out at full width, lockstep csqs "
              f"(Theorem-1 decomposition on), against the same server")
        from repro_torch.kernels import sqs_fused as k
        k.reset_launches()
        try:
            launch_serve.main([
                "--arch", tc.name, "--device", dev.type, "--trace",
                "--transport", "tcp",
                "--cloud-port", str(port), "--pipeline", "lockstep",
                "--n-requests", "4", "--rate", "4", "--prompt-len",
                str(PROMPT_LEN), "--min-new-tokens", "6",
                "--max-new-tokens", "10", "--max-batch", str(SLOTS),
                "--L-max", str(L_MAX), "--cells", str(TCP_CELLS),
                "--trace-out", trace_out, "--metrics-out", metrics_out])
        except SystemExit as e:
            raise CheckFailed(f"phase 9: the serving entry point exited "
                              f"{e.code}") from e
        for name, n in k.LAUNCHES.items():
            launches[name] = launches.get(name, 0) + n
        check(k.LAUNCHES["sqs_fused"] > 0, "phase 9 never launched sqs_fused")
        with open(metrics_out) as f:
            decomp = _json.load(f)["decomp"]
        rounds = [r for r in decomp["rounds"] if "bound" in r]
        err = max(abs(r["mismatch"] + r["dropped"] + r["lattice"]
                      - r["bound"]) for r in rounds)
        check(err <= 1e-4 and all(r["exact"] <= r["bound"] + 1e-4
                                  for r in rounds),
              f"phase 9: decomposition does not reconcile ({err:.3g})")
        cov = decomp["coverage"]
        print(f"  phase 9: {len(rounds)} rounds reconcile, max |mismatch + "
              f"dropped + lattice - bound| {err:.3g}; C-SQS coverage: mean "
              f"dropped mass {cov['mean_dropped']:.4g} vs alpha "
              f"{cov['alpha']:.4g} over {cov['n_positions']} positions, "
              f"Theorem-2 bound {cov['thm2_bound']:.4g} (within: "
              f"{cov['within_thm2']}), beta in [{cov['beta_min']:.4g}, "
              f"{cov['beta_max']:.4g}]; launches {dict(k.LAUNCHES)}; "
              f"{time.perf_counter() - t1:.1f} s")
    finally:
        if proc.poll() is None:
            down = stop_cloud(proc, log_path)
            print(f"  {down}")
    return launches


# ----------------------------------------------------------------------
# phase 10: the MoE family at full width
# ----------------------------------------------------------------------
def profile_verify(eng):
    """One verify forward of the target (an (L_MAX + 1)-token extend over
    the batch, as ``CloudVerifyEngine`` runs it) under ``torch.profiler``:
    its wall, the device-busy share, and the device time beside the floor
    of reading every weight once at the memory rate.  The extend writes
    past the committed positions and commits nothing."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import model as model_mod
    cloud = eng.cloud
    toks = cloud.x_last[:, None].expand(-1, L_MAX + 1).contiguous()

    def run():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model_mod.extend_step(cloud.model, toks, cloud.tcache, cloud.pos)
        torch.cuda.synchronize()
        return time.perf_counter() - t0
    run()
    bare = run()                                  # warm, unprofiled
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall = run()
    dev_us, by_op = device_ops(prof)
    wbytes = sum(p.numel() * p.element_size()
                 for p in cloud.model.parameters())
    floor = wbytes / HBM_BYTES_PER_S * 1e3
    if dev_us == 0.0:
        print("  profiler, one verify forward: the profiler saw no device "
              f"time (not measured); unprofiled wall {bare * 1e3:.2f} ms")
        return prof, dev_us
    bmm = sum(t for t, _, key in by_op if "gemm" in key.lower()
              or "nvjet" in key.lower())
    print(f"  profiler, one verify forward (B {toks.shape[0]}, "
          f"{toks.shape[1]} tokens a row, torch.profiler): wall "
          f"{wall * 1e3:.2f} ms ({bare * 1e3:.2f} ms unprofiled), device "
          f"busy {dev_us / 1e3:.3f} ms = {dev_us / 1e6 / bare:.3f} of the "
          f"unprofiled wall; GEMM kernels {bmm / 1e3:.3f} ms; floor of "
          f"reading the {wbytes / 1e9:.2f} GB of weights once "
          f"{floor:.2f} ms (device time {dev_us / 1e3 / floor:.2f}x it)")
    print("    most device time: " + "; ".join(
        f"{key[:60]} {t / 1e3:.3f} ms over {n} calls"
        for t, n, key in sorted(by_op, reverse=True)[:6]))
    return prof, dev_us


def phase_moe(dev):
    """qwen2-moe-a2.7b at full width (24 layers, 60 routed top-4 + 4
    shared experts, depth not cut) with its 2x draft, seeded random bf16
    weights: fixed-batch K-SQS and C-SQS rounds at the phase-3 settings,
    both SQS kernels held against their twins at the draft's next-step
    logits, and a short trace served lockstep and pipelined with equal
    streams.  Returns the SQS launches of the path."""
    import torch
    from repro_torch import configs
    from repro_torch.bridge import seeded_model
    from repro_torch.core.engine import (EdgeCloudEngine, EngineConfig,
                                         MethodConfig, summarize)
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.kernels import sqs_fused as k
    t0 = time.perf_counter()
    full = configs.get_config(MOE_ARCH)
    tc = depth_cut(full, MOE_LAYERS)
    dc = configs.draft_variant(tc, 2)
    tp = seeded_model(tc, 1, dev)
    dp = seeded_model(dc, 2, dev)
    torch.cuda.synchronize()
    n_t = sum(p.numel() for p in tp.parameters())
    n_d = sum(p.numel() for p in dp.parameters())
    print(f"phase 10: {tc.name} ({tc.n_layers} of {full.n_layers} layers, "
          f"d {tc.d_model}, "
          f"{tc.n_experts} routed top-{tc.moe_top_k} + "
          f"{tc.n_shared_experts} shared experts of {tc.d_expert}; "
          f"{n_t / 1e9:.3f} B params) <- {dc.name} ({dc.n_layers} layers, d "
          f"{dc.d_model}, experts of {dc.d_expert}; {n_d / 1e9:.3f} B "
          f"params), {tp.dtype} weights built in "
          f"{time.perf_counter() - t0:.1f} s; "
          f"{torch.cuda.memory_allocated() / 1e9:.1f} GB allocated")
    data = SyntheticLM(DataConfig(vocab=tc.vocab, seed=77))
    prompts = data.sample(BATCH, PROMPT_LEN)[:, :-1]
    launches = {name: 0 for name in k.LAUNCHES}
    engines = {}
    for method in ("ksqs", "csqs"):
        eng = EdgeCloudEngine(dc, dp, tc, tp, MethodConfig(method, K=64,
                                                           ell=100),
                              EngineConfig(L_max=L_MAX), seed=0, device=dev)
        k.reset_launches()
        t1 = time.perf_counter()
        rounds, toks = eng.run(prompts, ROUNDS)
        got = dict(k.LAUNCHES)
        steps = ROUNDS * (L_MAX + 1)
        want = {"sqs_fused": steps,
                "topk_threshold": steps if method == "ksqs" else 0}
        check(got == want, f"moe {method}: launches {got} != {want}")
        for name in launches:
            launches[name] += got[name]
        for row in toks:
            check(len(row) >= ROUNDS and all(0 <= t < tc.vocab for t in row),
                  f"moe {method}: tokens {row}")
        for r in rounds:
            for data_ in r["packed"].values():
                p = eng.fmt.unpack_draft(data_)
                check(all(sum(c) == 100 for c in p.counts),
                      f"moe {method}: transmitted sum b != ell")
        s = summarize(rounds)
        print(f"  {method}/v1: {ROUNDS} rounds in "
              f"{time.perf_counter() - t1:.1f} s; mean K {s['mean_K']:.1f}; "
              f"accept rate {s['accept_rate']:.3f}; launches {got}")
        print("    t_slm ms " + " ".join(f"{r['t_slm'] * 1e3:.2f}"
                                           for r in rounds)
              + " | t_llm ms " + " ".join(f"{r['t_llm'] * 1e3:.2f}"
                                          for r in rounds))
        engines[method] = eng
    profile_verify(engines["csqs"])
    for method, eng in engines.items():
        check(bool(torch.isfinite(edge_logits(eng)).all()),
              f"moe {method}: logits")
    hold_sqs_at_draft_logits("moe", engines)
    del engines, eng
    trace = dict(n_requests=4, rate_rps=4.0, prompt_len=PROMPT_LEN,
                 min_new_tokens=6, max_new_tokens=10, vocab=tc.vocab, seed=5)
    k.reset_launches()
    t1 = time.perf_counter()
    lock = serve_run("moe dense lockstep", dc, dp, tc, tp, dev, trace)
    pipe = serve_run("moe dense pipelined + speculation", dc, dp, tc, tp,
                     dev, trace, pipeline="pipelined")
    check(lock == pipe, "moe: pipelined streams differ from lockstep")
    check(k.LAUNCHES["sqs_fused"] > 0, "moe serving never launched sqs_fused")
    for name, n in k.LAUNCHES.items():
        launches[name] += n
    print(f"  moe streams equal across lockstep and pipelined: {len(lock)} "
          f"requests; serving launches {dict(k.LAUNCHES)}; "
          f"{time.perf_counter() - t1:.1f} s")
    print(f"  phase 10: {time.perf_counter() - t0:.1f} s; peak "
          f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB allocated")
    return launches


# ----------------------------------------------------------------------
# phase 11: the paper's pair, trained and served
# ----------------------------------------------------------------------
OP_CLASSES = (("GEMM", ("gemm", "nvjet", "cutlass", "xmma", "sm90_")),
              ("softmax", ("softmax",)),
              ("reduction", ("reduce", "norm")),
              ("index / scatter / gather", ("index", "scatter", "gather")),
              ("copy / fill", ("copy", "memcpy", "memset", "fill")),
              ("elementwise", ("elementwise", "vectorized")))


def op_class(name):
    low = name.lower()
    for cls, keys in OP_CLASSES:
        if any(key in low for key in keys):
            return cls
    return "other"


def event_ms(fn):
    """One call of ``fn`` between two CUDA events on the current stream."""
    import torch
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    out = fn()
    e.record()
    e.synchronize()
    return s.elapsed_time(e), out


def phase_train_steps(dev):
    """(a) Full-width train steps of the paper's target: microbatches 1,
    then 2 from the same start, the losses held together; step time,
    tokens/s, peak memory, and one step under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import configs
    from repro_torch.bridge import seeded_model
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models.model import param_count
    from repro_torch.train.optimizer import AdamWConfig, init_state
    from repro_torch.train.trainer import make_train_step, parameters
    t0 = time.perf_counter()
    tc = configs.get_config(PAIR_ARCH)
    model = seeded_model(tc, 1, dev, trainable=True)
    params = parameters(model)
    n = param_count(model)
    start = [p.detach().to("cpu", copy=True) for p in params]
    data = SyntheticLM(DataConfig(vocab=tc.vocab, seq_len=TRAIN_SEQ,
                                  batch=TRAIN_BATCH, seed=1234))
    batches = [{"tokens": torch.from_numpy(b["tokens"]).to(dev)}
               for b in data.batches(TRAIN_STEPS)]
    # launch/train.py's warmup rule
    oc = AdamWConfig(lr=PAIR_LR,
                     warmup_steps=min(100, TRAIN_STEPS // 10 + 1),
                     total_steps=TRAIN_STEPS)
    state_bytes = 16 * n                  # f32 params, grads, m and v
    print(f"phase 11: the paper's pair, {tc.name} ({tc.n_layers} layers, d "
          f"{tc.d_model}, {tc.n_heads}/{tc.n_kv_heads} heads, V {tc.vocab}; "
          f"{n / 1e9:.3f} B params), float32 masters, {tc.dtype} compute, "
          f"AdamW, remat per layer; built in "
          f"{time.perf_counter() - t0:.1f} s")
    torch.cuda.reset_peak_memory_stats()
    runs = {}
    for mb in (1, 2):
        with torch.no_grad():
            for p, p0 in zip(params, start):
                p.copy_(p0)
        state = init_state(params)
        step = make_train_step(tc, oc, microbatches=mb)
        losses, ms = [], []
        for b in batches:
            t, (_, state, m) = event_ms(lambda: step(model, state, b))
            ms.append(t)
            losses.append(float(m["loss"]))
        del state
        runs[mb] = (losses, ms)
        check(all(math.isfinite(x) for x in losses), f"train losses {losses}")
        steady = statistics.median(ms[1:])
        tok = TRAIN_BATCH * TRAIN_SEQ
        print(f"  (a) microbatches {mb}: B {TRAIN_BATCH} x S {TRAIN_SEQ}, "
              f"losses {[round(x, 5) for x in losses]}; step ms (CUDA "
              f"events) {' '.join(f'{t:.1f}' for t in ms)}; steady "
              f"{steady:.1f} ms = {tok / steady * 1e3:.0f} tokens/s, "
              f"6 N tokens / step time = "
              f"{6 * n * tok / steady / 1e9:.1f} TFLOP/s "
              f"({6 * n * tok / steady / 1e9 / (BF16_FLOPS / 1e12):.3f} of "
              f"the bf16 peak)")
    peak = torch.cuda.max_memory_allocated()
    diff = max(abs(a - b) for a, b in zip(runs[1][0], runs[2][0]))
    check(diff <= TRAIN_LOSS_ATOL, f"microbatches 1 vs 2: losses differ by "
          f"{diff} > {TRAIN_LOSS_ATOL}")
    print(f"  (a) microbatches 1 vs 2 from the same start: max |loss "
          f"difference| {diff:.3g} (bound {TRAIN_LOSS_ATOL}); peak "
          f"{peak / 1e9:.2f} GB allocated against "
          f"{state_bytes / 1e9:.2f} GB of params + grads + m + v")
    state = init_state(params)
    step = make_train_step(tc, oc)
    bare, _ = event_ms(lambda: step(model, state, batches[0]))   # warm
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall, _ = event_ms(lambda: step(model, state, batches[1]))
    dev_us, by_op = device_ops(prof)
    if dev_us == 0.0:
        print("  (a) profiler, one train step: the profiler saw no device "
              f"time (not measured); unprofiled step {bare:.1f} ms")
    else:
        classes = {}
        for t, cnt, key in by_op:
            c = classes.setdefault(op_class(key), [0.0, 0])
            c[0] += t
            c[1] += cnt
        print(f"  (a) profiler, one train step (microbatches 1): wall "
              f"{wall:.1f} ms ({bare:.1f} ms unprofiled), device busy "
              f"{dev_us / 1e3:.1f} ms = {dev_us / 1e3 / bare:.3f} of the "
              f"unprofiled step; by op class: " + "; ".join(
                  f"{cls} {t / 1e3:.1f} ms over {cnt} calls"
                  for cls, (t, cnt) in sorted(classes.items(),
                                              key=lambda kv: -kv[1][0])))
        print("    most device time: " + "; ".join(
            f"{key[:60]} {t / 1e3:.2f} ms over {cnt} calls"
            for t, cnt, key in sorted(by_op, reverse=True)[:6]))
    del model, params, state, start, batches
    free_cuda()


def phase_train_pair(dev, tmp):
    """(b) Train the target and its 2x draft on ``trained_pair``'s corpus
    at V 50257 (one stream: the draft continues where the target
    stopped, as ``benchmarks/common.py`` does) and save both with the
    port's checkpoint.  Returns the checkpoint paths."""
    import torch
    from repro_torch import configs
    from repro_torch.bridge import seeded_model, to_jax_tree
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models.model import param_count
    from repro_torch.train import checkpoint
    from repro_torch.train.optimizer import AdamWConfig, init_state
    from repro_torch.train.trainer import make_train_step, parameters
    tc = configs.get_config(PAIR_ARCH)
    dc = configs.draft_variant(tc, 2)
    data = SyntheticLM(DataConfig(vocab=tc.vocab, seq_len=48, batch=16,
                                  p_bigram=0.85, jitter=2, seed=5))
    paths = {}
    for role, cfg, steps, seed in (("target", tc, PAIR_STEPS, 1),
                                   ("draft", dc, DRAFT_STEPS, 2)):
        model = seeded_model(cfg, seed, dev, trainable=True)
        step = make_train_step(cfg, AdamWConfig(lr=PAIR_LR, warmup_steps=10,
                                                total_steps=steps))
        state = init_state(parameters(model))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses = []
        for b in data.batches(steps):
            _, state, m = step(model, state,
                               {"tokens": torch.from_numpy(b["tokens"])
                                .to(dev)})
            losses.append(m["loss"])
        losses = torch.stack(losses).tolist()
        train_s = time.perf_counter() - t0
        check(all(math.isfinite(x) for x in losses),
              f"{role}: non-finite loss")
        check(losses[-1] < losses[0] - LOSS_FALL,
              f"{role}: loss {losses[0]:.4f} -> {losses[-1]:.4f} fell by "
              f"less than {LOSS_FALL}")
        path = os.path.join(tmp, role)
        t1 = time.perf_counter()
        checkpoint.save(path, to_jax_tree(model),
                        meta={"arch": cfg.name, "steps": steps,
                              "loss": losses[-1]})
        save_s = time.perf_counter() - t1
        print(f"  (b) {cfg.name} ({param_count(model) / 1e9:.3f} B params): "
              f"{steps} steps of B 16 x S 48 in {train_s:.1f} s "
              f"({train_s / steps * 1e3:.1f} ms a step, host clock); loss "
              f"{losses[0]:.4f} -> {losses[-1]:.4f} (every 25th: "
              f"{[round(x, 3) for x in losses[::25]]}); checkpoint "
              f"{os.path.getsize(path + '.npz') / 1e9:.2f} GB saved in "
              f"{save_s:.1f} s")
        paths[role] = path
        del model, state, step
        free_cuda()
    return paths


def phase_serve_pair(paths):
    """(c) Serve the trained pair from its checkpoints through the port's
    serve entry point: fixed-batch K-SQS and C-SQS at the phase-3
    settings (accepted tokens in every method), then a short pipelined
    trace.  Returns the SQS launches of the path."""
    import numpy as np
    from repro_torch.core.engine import summarize
    from repro_torch.kernels import sqs_fused as k
    from repro_torch.launch import serve as serve_launch
    base = ["--arch", PAIR_ARCH, "--target-ckpt", paths["target"],
            "--draft-ckpt", paths["draft"], "--device", "cuda",
            "--L-max", str(L_MAX), "--prompt-len", str(PROMPT_LEN)]
    launches = {name: 0 for name in k.LAUNCHES}
    for method in ("ksqs", "csqs"):
        k.reset_launches()
        t0 = time.perf_counter()
        rounds = serve_launch.main(base + [
            "--method", method, "--K", "64", "--ell", "100",
            "--rounds", str(ROUNDS), "--batch", str(BATCH)])
        wall = time.perf_counter() - t0
        got = dict(k.LAUNCHES)
        steps = ROUNDS * (L_MAX + 1)
        want = {"sqs_fused": steps,
                "topk_threshold": steps if method == "ksqs" else 0}
        check(got == want, f"pair {method}: launches {got} != {want}")
        for name in launches:
            launches[name] += got[name]
        s = summarize(rounds)
        acc = [float(np.mean(r["n_accept"])) for r in rounds]
        check(float(np.mean(acc)) > 0,
              f"pair {method}: no token accepted ({acc})")
        drop = [round(float(r["dropped_mean"]), 4) for r in rounds]
        print(f"  (c) {method}/v1 from the checkpoints ({wall:.1f} s with "
              f"loading): dropped mass a draft (mean a round) {drop}; "
              f"accepted tokens a row a round "
              f"{[round(a, 3) for a in acc]} (mean "
              f"{float(np.mean(acc)):.3f}); accept rate "
              f"{s['accept_rate']:.4f}; resampling rate "
              f"{s['resampling_rate']:.4f}; mean K {s['mean_K']:.1f}; "
              f"latency per token {s['latency_per_token_s'] * 1e3:.2f} ms; "
              f"wire bits per batch {s['wire_bits_per_batch']:.0f}; "
              f"launches {got}")
        print("    t_slm ms " + " ".join(f"{r['t_slm'] * 1e3:.2f}"
                                           for r in rounds)
              + " | t_llm ms " + " ".join(f"{r['t_llm'] * 1e3:.2f}"
                                          for r in rounds))
    k.reset_launches()
    rep = serve_launch.main(base + [
        "--trace", "--pipeline", "pipelined", "--n-requests", "4",
        "--rate", "4", "--min-new-tokens", "6", "--max-new-tokens", "10",
        "--max-batch", str(SLOTS)])
    check(rep.n_finished == rep.n_requests == 4,
          f"pair trace: {rep.n_finished} of {rep.n_requests} finished")
    check(k.LAUNCHES["sqs_fused"] > 0, "pair trace never launched sqs_fused")
    for name, cnt in k.LAUNCHES.items():
        launches[name] += cnt
    summ = rep.summary()
    print("  (c) pipelined trace from the checkpoints: " + json.dumps(
        {key: summ[key] for key in ("n_requests", "n_finished",
                                    "total_tokens", "n_rounds",
                                    "makespan_s", "latency_p50_s",
                                    "latency_p99_s", "n_spec_hits",
                                    "n_spec_misses")})
        + f"; launches {dict(k.LAUNCHES)}")
    return launches


def phase_pair(dev, smi):
    """Phase 11: (a) train steps at full width, (b) the pair trained and
    saved, (c) served from its checkpoints; then phase 16 on the same
    checkpoints.  Returns the SQS launches of phases 11 and 16."""
    t0 = time.perf_counter()
    phase_train_steps(dev)
    with tempfile.TemporaryDirectory() as tmp:
        paths = phase_train_pair(dev, tmp)
        launches = phase_serve_pair(paths)
        print(f"  phase 11: {time.perf_counter() - t0:.1f} s")
        free_cuda()
        cross = phase_crossover(dev, paths, tmp, smi)
    return {n: launches[n] + cross[n] for n in launches}


# ----------------------------------------------------------------------
# phase 16: the Fig. 2 temperature crossover
# ----------------------------------------------------------------------
# (b) the full-width pair: batch and rounds a sweep after its 2 warmup
# rounds.  A K-SQS draft on the kernel path fails the phase where it drops
# FAULT_DROP of its mass while torch.topk's support on the same q drops
# less than TOPK_DROP: the signature of a top-K search that stops above
# the K-th value (ROADMAP Queue 3 item 12)
CROSS_BATCH, CROSS_ROUNDS = 4, 3
FAULT_DROP, TOPK_DROP = 0.5, 1e-3
# K at which the reference's search is replayed on the drafts' q: the
# crossover's and phase 11 (c)'s
REPLAY_KS = (16, 64)


def load_example(name):
    """An ``examples/`` module by file, registered under its name (the
    examples import ``torch_pair`` so)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(HERE, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def draft_dropped(rounds):
    """The dropped mass of every live draft in ``rounds`` (run with
    ``collect_theory``), with its dense q: [(dropped, q (V,))]."""
    import numpy as np
    out = []
    for r in rounds:
        live = r["live_seq"]                            # (B, L)
        dropped = r["dropped_seq"][:, :live.shape[1]]
        for b, i in zip(*np.nonzero(live)):
            out.append((float(dropped[b, i]), r["q"][b, i]))
    return out


def reference_search_dropped(q, K):
    """Dropped mass of the reference's K-SQS rule on rows q (N, V): its
    40-step float bisection of [0, max q] (``repro.kernels.ref.
    topk_threshold_ref``), then the first K of q >= lo by index."""
    import torch
    hi = q.amax(-1, keepdim=True)
    lo = torch.zeros_like(hi)
    for _ in range(40):
        mid = 0.5 * (lo + hi)
        take = (q >= mid).sum(-1, keepdim=True) >= K
        lo, hi = torch.where(take, mid, lo), torch.where(take, hi, mid)
    cand = q >= lo
    keep = cand & (torch.cumsum(cand.to(torch.int32), -1) <= K)
    return 1.0 - torch.where(keep, q, 0.0).sum(-1)


def crossover_example(tmp):
    """(a) examples/torch_temperature_crossover.py with its defaults as a
    child process, alone on the card after (b) (the smoke pair trained on
    the card, 500 + 250 steps, 12 rounds a sweep, the fused kernels):
    exit 0 and all 10 rows (five temperatures, two methods)."""
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, os.path.join(HERE, "examples",
                                      "torch_temperature_crossover.py"),
         "--cache", os.path.join(tmp, "smoke_pair")],
        cwd=HERE, capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=os.path.join(HERE, "src")))
    text = r.stdout + r.stderr
    check(r.returncode == 0, f"torch_temperature_crossover.py exit "
          f"{r.returncode}: " + text[-3000:])
    lines = text.splitlines()
    table = [ln for ln in lines if ln.rstrip().endswith(("| K-SQS",
                                                          "| C-SQS"))]
    rows = [ln.strip() for ln in lines if ln.strip().startswith("method=")]
    check(len(table) == 5 and len(rows) == 10,
          f"torch_temperature_crossover.py printed {len(table)} table rows "
          f"and {len(rows)} data rows: {text[-2000:]}")
    head = [ln for ln in lines if ln.lstrip().startswith("T |")]
    print("phase 16 (a): examples/torch_temperature_crossover.py (its "
          "defaults: the smoke pair trained on the card, 12 rounds a sweep,"
          " the fused kernels), exit 0:\n  "
          + "\n  ".join(head + table + rows))
    print(f"  phase 16 (a): {time.perf_counter() - t0:.1f} s")


def crossover_full_width(dev, paths, smi):
    """(b) torch_pair.crossover on phase 11's full-width pair, on the fused
    kernels and on plain torch (the same prompts), with the fault's
    signature checked on every K-SQS draft of the kernel path and the
    reference's search replayed on the same q.  Returns the SQS launches
    of the kernel path."""
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.kernels import sqs_fused as k
    from repro_torch.launch.serve import load_or_init
    tp_mod = load_example("torch_pair")
    tc = configs.get_config(PAIR_ARCH)
    dc = configs.draft_variant(tc, 2)
    check(k.pad_vocab(tc.vocab) == 50304, f"{PAIR_ARCH} pads to "
          f"{k.pad_vocab(tc.vocab)}")
    t0 = time.perf_counter()
    tp = load_or_init(tc, paths["target"], 1, dev)
    dp = load_or_init(dc, paths["draft"], 2, dev)
    print(f"phase 16 (b): the Fig. 2 crossover on phase 11's full-width "
          f"{PAIR_ARCH} pair (loaded in {time.perf_counter() - t0:.1f} s), "
          f"B {CROSS_BATCH}, {CROSS_ROUNDS} rounds a sweep after 2 warmup "
          f"rounds, L_max 6, K-SQS K 16, C-SQS alpha 5e-4 eta 1e-3, l 100, "
          f"Vp 50304; {smi[0]}")
    launches, mean_K = {}, {}
    for use_kernels in (True, False):
        label = "fused kernels" if use_kernels else "plain torch"
        data = SyntheticLM(DataConfig(vocab=tc.vocab, seq_len=48, batch=16,
                                      p_bigram=0.85, jitter=2, seed=5))
        k.reset_launches()
        t1 = time.perf_counter()
        rows, runs = tp_mod.crossover((dc, dp, tc, tp, data),
                                      rounds=CROSS_ROUNDS, batch=CROSS_BATCH,
                                      use_kernels=use_kernels,
                                      collect_theory=True)
        got = dict(k.LAUNCHES)
        wall = time.perf_counter() - t1
        if use_kernels:
            check(all(n > 0 for n in got.values()),
                  f"crossover on the kernels launched {got}")
            launches = got
        else:
            check(not any(got.values()),
                  f"crossover on plain torch launched {got}")
        print(f"  {label} ({wall:.1f} s, launches {got}):")
        for r in rows:
            drafts = draft_dropped(runs[(r["method"], r["temperature"])])
            dropped = torch.tensor([d for d, _ in drafts])
            extra = (f"; largest dropped mass of a draft "
                     f"{float(dropped.max()):.4g}")
            if r["method"] == "ksqs":
                q = torch.from_numpy(np.stack([q for _, q in drafts])).to(dev)
                top = {K: (1.0 - torch.topk(q, K, dim=-1).values.sum(-1))
                       .cpu() for K in REPLAY_KS}
                fault = (dropped >= FAULT_DROP) & (top[16] < TOPK_DROP)
                if use_kernels:
                    check(not bool(fault.any()),
                          f"{int(fault.sum())} K-SQS drafts at T "
                          f"{r['temperature']} drop >= {FAULT_DROP} where "
                          f"torch.topk drops < {TOPK_DROP}")
                # mass the reference's rule loses against the top-K set
                lost = {K: reference_search_dropped(q, K).cpu() - top[K]
                        for K in REPLAY_KS}
                extra += (f" (torch.topk's support {float(top[16].max()):.4g}"
                          f"); {int(fault.sum())} of {len(drafts)} drafts "
                          f"with the fault's signature; the reference's rule "
                          f"on the same q loses > {TOPK_DROP} of mass in "
                          + ", ".join(f"{int((v > TOPK_DROP).sum())} (at "
                                      f"most {float(v.max()):.4g}) at K {K}"
                                      for K, v in lost.items()))
            print(f"    {r['method']} T={r['temperature']}: latency_per_batch "
                  f"{r['latency_per_batch_s'] * 1e3:.2f} ms, resampling_rate "
                  f"{r['resampling_rate']:.4f}, accept_rate "
                  f"{r['accept_rate']:.4f}, bits_per_batch "
                  f"{r['bits_per_batch']:.1f}, mean_K {r['mean_K']:.2f}"
                  + extra)
        print("    winner by latency: " + ", ".join(
            f"T={T} {w}" for T, (_, _, w) in tp_mod.winners(rows).items()))
        mean_K[use_kernels] = {(r["method"], r["temperature"]): r["mean_K"]
                               for r in rows}
    # the kernel path counts the true vocabulary: where beta < 0 C-SQS
    # keeps every token, V of them, not the padded width
    check(mean_K[True] == mean_K[False], "mean K on the kernels differs "
          f"from plain torch: {mean_K[True]} vs {mean_K[False]}")
    check(max(mean_K[True].values()) <= tc.vocab, "mean K past V: "
          f"{mean_K[True]}")
    print(f"  mean K on the kernels == plain torch's at every T and method "
          f"(largest {max(mean_K[True].values()):.2f}, V {tc.vocab})")
    del tp, dp
    return launches


def phase_crossover(dev, paths, tmp, smi):
    """Phase 16: (b) the crossover on the full-width pair, then (a) the
    crossover example as a child process; neither is timed beside the
    other.  Returns the SQS launches of (b)'s kernel path."""
    t0 = time.perf_counter()
    launches = crossover_full_width(dev, paths, smi)
    free_cuda()
    print(f"  phase 16 (b): {time.perf_counter() - t0:.1f} s")
    crossover_example(tmp)
    print(f"  phase 16: {time.perf_counter() - t0:.1f} s")
    return launches


# ----------------------------------------------------------------------
# phase 12: the SSM and hybrid family
# ----------------------------------------------------------------------
SSM_ARCH, HYBRID_ARCH = "xlstm-1.3b", "jamba-1.5-large-398b"
# (a) and (b) run xlstm-1.3b cut from 48 to SSM_LAYERS layers at full
# width, two periods of 7 mLSTM : 1 sLSTM (its draft one period of 24)
SSM_LAYERS = 16
# rolled-back caches against a fresh prefill of the verified prefix,
# target and draft, after uncompressed rounds of the pair with a budget
# that lets every draft go out (rows accept 0..L_max tokens; K-SQS on
# random weights accepts none, and a check on none sees only snapshot 0)
ROLLBACK_BUDGET = 1e9
# the reference's float32 bound on the next-token logits
# (tests/test_engine.py) at the smoke variants
ROLLBACK_ATOL_F32 = 3e-4
# full width: the first stateful layer's state within ROLLBACK_RTOL_FIRST
# (max |difference| / max |fresh| over its leaves), and the state one token
# short outside it.  Deeper down, 48 layers of random weights grow a GEMM's
# rounding (other row counts round otherwise); the same prefix prefilled
# at batch 1 and at batch 4 differs by the batch floor.  In bf16 the logits
# decorrelate (their argmax differs at the floor), so deeper layers and
# the logits are printed only; in float32 every stateful layer must lie
# within ROLLBACK_FLOOR_MULT times its floor (at least ROLLBACK_FLOOR_MIN)
# and the argmax must agree
ROLLBACK_RTOL_FIRST = 1e-2
ROLLBACK_FLOOR_MULT, ROLLBACK_FLOOR_MIN = 10.0, 1e-6
# one full-width Mamba layer, sequence form against the step loop: a bound
# on max |difference| / max |reference| per leaf, float32 and bf16
MAMBA_B, MAMBA_S = 4, 16
MAMBA_RTOL = {"float32": 1e-4, "bfloat16": 5e-2}


def stateful_logits(model, cache, token, pos):
    """Next-token logits from a cache without advancing it: the step
    replaces stateful layers' states in a copy of the layer list, and
    writes KV past the committed positions."""
    from repro_torch.models import model as model_mod
    logits, _ = model_mod.decode_step(model, token, list(cache), pos)
    return logits


def fixed_batch_methods(tag, dc, dp, tc, tp, dev, prompts):
    """Fixed-batch rounds of all four methods at the phase-3 settings
    through ``EdgeCloudEngine.run`` (ROUNDS rounds of ksqs and csqs, one
    of qs and uncompressed): each kernel launched once a draft step where
    its method runs it, tokens in [0, V), every payload well formed, and
    both sides' next-token logits finite after the run.  Prints t_slm,
    t_llm and the accepted tokens; returns (the ksqs and csqs engines by
    method, the SQS launches of the runs); the others are dropped, their
    caches freed."""
    import numpy as np
    import torch
    from repro_torch.core.engine import (EdgeCloudEngine, EngineConfig,
                                         MethodConfig, summarize)
    from repro_torch.kernels import sqs_fused as k
    launches = {name: 0 for name in k.LAUNCHES}
    engines = {}
    for method, n_rounds in (("ksqs", ROUNDS), ("csqs", ROUNDS),
                             ("qs", 1), ("uncompressed", 1)):
        eng = EdgeCloudEngine(dc, dp, tc, tp,
                              MethodConfig(method, K=64, ell=100),
                              EngineConfig(L_max=L_MAX), seed=0, device=dev)
        k.reset_launches()
        t1 = time.perf_counter()
        rounds, toks = eng.run(prompts, n_rounds)
        got = dict(k.LAUNCHES)
        steps = n_rounds * (L_MAX + 1)
        want = {"sqs_fused": steps if method in ("ksqs", "csqs") else 0,
                "topk_threshold": steps if method == "ksqs" else 0}
        check(got == want, f"{tag} {method}: launches {got} != {want}")
        for name in launches:
            launches[name] += got[name]
        for row in toks:
            check(len(row) >= n_rounds
                  and all(0 <= t < tc.vocab for t in row),
                  f"{tag} {method}: tokens {row}")
        for r in rounds:
            for data_ in r["packed"].values():
                p = eng.fmt.unpack_draft(data_)
                check(p.n_drafts >= 1, f"{tag} {method}: empty payload")
                if p.probs is not None:
                    check(all(np.isfinite(pr).all() for pr in p.probs),
                          f"{tag} {method}: raw probabilities not finite")
                else:
                    check(all(sum(c) == 100 for c in p.counts),
                          f"{tag} {method}: transmitted sum b != ell")
        s = summarize(rounds)
        acc = [float(r["n_accept"].mean()) for r in rounds]
        print(f"  {method}/v1: {n_rounds} rounds in "
              f"{time.perf_counter() - t1:.1f} s; mean K "
              f"{s['mean_K']:.1f}; accepted tokens a row a round "
              + " ".join(f"{a:.2f}" for a in acc) + f"; launches {got}")
        print("    t_slm ms " + " ".join(f"{r['t_slm'] * 1e3:.2f}"
                                           for r in rounds)
              + " | t_llm ms " + " ".join(f"{r['t_llm'] * 1e3:.2f}"
                                          for r in rounds))
        lg = stateful_logits(eng.edge.model, eng.edge.dcache,
                             eng.edge.x_last, eng.edge.pos)
        lt = stateful_logits(eng.cloud.model, eng.cloud.tcache,
                             eng.cloud.x_last, eng.cloud.pos)
        check(bool(torch.isfinite(lg).all() and torch.isfinite(lt).all()),
              f"{tag} {method}: NaN/inf logits")
        if method in ("ksqs", "csqs"):
            engines[method] = eng
        del eng
    print(f"  peak {torch.cuda.max_memory_allocated() / 1e9:.1f} GB "
          f"allocated over the four methods")
    return engines, launches


def hold_sqs_at_draft_logits(tag, engines):
    """Both SQS kernels against their twins at the draft's next-step
    logits after the ksqs and csqs runs of ``fixed_batch_methods``: no row
    may differ outside the boundary rule."""
    from repro_torch.kernels.ops import pad_logits
    for method in ("ksqs", "csqs"):
        eng = engines[method]
        lp = pad_logits(stateful_logits(eng.edge.model, eng.edge.dcache,
                                        eng.edge.x_last, eng.edge.pos))[0]
        hold_sqs(tag, method, lp, eng.edge.beta)


def hold_sqs(tag, method, lp, beta):
    """One SQS method's kernels against their twins on padded draft logits
    ``lp`` (B, Vp) (C-SQS at thresholds ``beta`` (B,), K-SQS at K 64): no
    row may differ outside the boundary rule."""
    import torch
    from repro_torch.kernels import ref, sqs_fused as k
    if method == "csqs":
        beta2 = torch.stack([beta, beta], -1).contiguous()
        nd, nb = compare_sqs(lp, beta2, 1.0, 100, 0,
                             f"{tag} sqs_fused at the draft's logits")
    else:
        tau = k.topk_threshold(lp, 64, inv_temp=1.0)
        tau_r = ref.topk_threshold_ref(ref.softmax_padded(lp, 1.0), 64)
        nd, nb = compare_sqs(lp, tau, 1.0, 100, 64,
                             f"{tag} sqs_topk at the draft's logits", tau_r)
    check(nb == 0, f"{tag} {method}: {nb} rows differ from the twin "
          f"outside the boundary rule")
    print(f"  {method} kernels at the draft's next-step logits (B="
          f"{lp.shape[0]}, Vp={lp.shape[1]}): {nd} rows differ from the "
          f"twin, {nb} unexcused")


def rollback_engine(dc, dp, tc, tp, dev, prompts, l_max, label):
    """``ROUNDS`` uncompressed rounds of the pair with every draft sent;
    fails unless some row accepted a token.  Returns the engine."""
    from repro_torch.core.engine import (EdgeCloudEngine, EngineConfig,
                                         MethodConfig)
    eng = EdgeCloudEngine(dc, dp, tc, tp, MethodConfig("uncompressed"),
                          EngineConfig(L_max=l_max,
                                       bit_budget=ROLLBACK_BUDGET),
                          seed=0, device=dev)
    eng.prefill(prompts)
    acc = [eng.run_round()["n_accept"].tolist() for _ in range(ROUNDS)]
    print(f"  {label}: accepted tokens a row, round by round {acc}")
    check(any(t > 0 for r in acc for t in r), f"{label}: no row accepted "
          f"a token, so the rollback check would see only snapshot 0")
    return eng


def verified_prefix(eng, prompts, b, label):
    """Row ``b``'s verified prefix (1, pos) and the token after it."""
    import torch
    dev = eng.cloud.model.device
    seq = [int(t) for t in prompts[b]] + eng.out_tokens[b]
    prefix = torch.tensor([seq[:-1]], device=dev)
    pos = int(eng.pos[b])
    check(pos == prefix.shape[1] == int(eng.edge.pos[b]),
          f"{label}: row {b} pos {pos} != verified prefix {prefix.shape[1]}")
    return prefix, torch.tensor([seq[-1]], device=dev), \
        torch.tensor([pos], device=dev)


def row_cache(cache, b):
    return [{n: t[b:b + 1] for n, t in c.items()} for c in cache]


def sides(eng):
    return (("target", eng.cloud.model, eng.cloud.tcache),
            ("draft", eng.edge.model, eng.edge.dcache))


def rollback_check(eng, prompts, label, failures, atol):
    """Each row's rolled-back target and draft caches against a fresh
    prefill of its verified prefix (tests/test_engine.py's rollback test):
    the argmax of the next-token logits equal, and max |difference| within
    ``atol``; a row that is not is added to ``failures`` (phase 12 fails
    on them after its other parts ran).  Returns the largest difference."""
    from repro_torch.models import model as model_mod
    worst = 0.0
    for b in range(len(prompts)):
        prefix, nxt, at = verified_prefix(eng, prompts, b, label)
        for side, model, cache in sides(eng):
            _, fresh = model_mod.prefill(model, prefix,
                                         cache_len=prefix.shape[1] + 8)
            ref = stateful_logits(model, fresh, nxt, at)
            got = stateful_logits(model, row_cache(cache, b), nxt, at)
            err = float((got - ref).abs().max())
            top2 = ref[0].topk(2).values
            print(f"    {label} {side} row {b}: {prefix.shape[1]} positions "
                  f"kept; max |logit difference| {err:.3g} (bound "
                  f"{atol:.3g}; max |logit| {float(ref.abs().max()):.3g}, "
                  f"top-2 gap {float(top2[0] - top2[1]):.3g}); argmax "
                  f"{int(got.argmax())} vs {int(ref.argmax())}")
            if err > atol:
                failures.append(f"{label} {side}: row {b} rolled-back "
                                f"logits differ by {err:.3g} > {atol:.3g}")
            if int(got.argmax()) != int(ref.argmax()):
                failures.append(f"{label} {side}: row {b} argmax differs")
            worst = max(worst, err)
    return worst


def state_diff(got, ref):
    """max |got - ref| / max |ref| over one stateful layer's leaves."""
    return max(float((got[n].float() - ref[n].float()).abs().max())
               / max(float(ref[n].float().abs().max()), 1e-30) for n in ref)


def rollback_state_check(eng, prompts, failures, label, whole_stack):
    """Full width: each row's rolled-back target and draft states against
    a fresh prefill of its verified prefix, layer by layer, beside the
    batch floor (the same prefix prefilled at batch 1 and at batch B).
    The first stateful layer must agree within ROLLBACK_RTOL_FIRST, and
    the state one token short (what an off-by-one rollback keeps) must
    not.  With ``whole_stack`` (float32) every stateful layer must lie
    within ROLLBACK_FLOOR_MULT times its floor and the next-token argmax
    must agree.  Returns the largest ratio of a layer's difference to its
    floor."""
    from repro_torch.models import model as model_mod
    B, worst = len(prompts), 0.0
    for b in range(B):
        prefix, nxt, at = verified_prefix(eng, prompts, b, label)
        for side, model, cache in sides(eng):
            layers = [i for i, blk in enumerate(model.layers)
                      if blk.stateful]
            first = layers[0]
            _, fresh = model_mod.prefill(model, prefix)
            _, short = model_mod.prefill(model, prefix[:, :-1])
            _, wide = model_mod.prefill(model,
                                        prefix.expand(B, -1).contiguous())
            row, wide0 = row_cache(cache, b), row_cache(wide, 0)
            errs = {i: state_diff(row[i], fresh[i]) for i in layers}
            floors = {i: state_diff(wide0[i], fresh[i]) for i in layers}
            ratio = {i: errs[i] / max(floors[i], ROLLBACK_FLOOR_MIN)
                     for i in layers}
            top = max(layers, key=ratio.get)
            off = state_diff(short[first], fresh[first])
            ref = stateful_logits(model, fresh, nxt, at)
            got = stateful_logits(model, row, nxt, at)
            flo = stateful_logits(model, wide0, nxt, at)
            top2 = ref[0].topk(2).values
            print(f"    {label} {side} row {b}: {prefix.shape[1]} positions "
                  f"kept; layer {first} state differs by {errs[first]:.3g} "
                  f"(bound {ROLLBACK_RTOL_FIRST}; batch floor "
                  f"{floors[first]:.3g}; one token short {off:.3g}); "
                  f"largest difference / floor over {len(layers)} layers "
                  f"{ratio[top]:.3g} at layer {top} ({errs[top]:.3g} / "
                  f"{floors[top]:.3g}); layers " + ", ".join(
                      f"{i}: {errs[i]:.3g} (floor {floors[i]:.3g})"
                      for i in sorted({layers[len(layers) // 2],
                                       layers[-1]}))
                  + f"; next-token logits differ by "
                  f"{float((got - ref).abs().max()):.3g} (floor "
                  f"{float((flo - ref).abs().max()):.3g}, max |logit| "
                  f"{float(ref.abs().max()):.3g}, top-2 gap "
                  f"{float(top2[0] - top2[1]):.3g}), argmax "
                  f"{int(got.argmax())} vs {int(ref.argmax())} (floor "
                  f"{int(flo.argmax())})")
            where = f"{label} {side}: row {b}"
            if errs[first] > ROLLBACK_RTOL_FIRST:
                failures.append(f"{where} layer {first} rolled-back state "
                                f"differs by {errs[first]:.3g}")
            if off <= ROLLBACK_RTOL_FIRST:
                failures.append(f"{where} one token short differs by only "
                                f"{off:.3g}: the bound cannot see an "
                                f"off-by-one rollback")
            if whole_stack and ratio[top] > ROLLBACK_FLOOR_MULT:
                failures.append(f"{where} layer {top} differs by "
                                f"{ratio[top]:.3g} times its batch floor")
            if whole_stack and int(got.argmax()) != int(ref.argmax()):
                failures.append(f"{where} next-token argmax differs")
            worst = max(worst, ratio[top])
    return worst


def profile_stateful_draft(eng):
    """``profile_draft`` on a stateful draft: the profiled calls advance
    the draft's recurrent state, so the state is put back after them."""
    saved = list(eng.edge.dcache)
    try:
        profile_draft(eng)
    finally:
        eng.edge.dcache = saved


def phase_ssm_full_width(dev, failures):
    """(a) xlstm-1.3b at full width with its 2x draft: fixed-batch rounds
    of all four methods at the phase-3 settings, both SQS kernels held
    against their twins at the draft's next-step logits, one K-SQS draft
    call under torch.profiler; (b) uncompressed rounds of the pair in
    bf16 and then in float32, each row's rolled-back target and draft
    states against a fresh prefill of its verified prefix.  Returns the
    SQS launches of the path."""
    import torch
    from repro_torch import configs
    from repro_torch.bridge import seeded_model
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    t0 = time.perf_counter()
    full = configs.get_config(SSM_ARCH)
    tc = depth_cut(full, SSM_LAYERS)
    dc = configs.draft_variant(tc, 2)
    tp = seeded_model(tc, 1, dev)
    dp = seeded_model(dc, 2, dev)
    torch.cuda.synchronize()
    n_t = sum(p.numel() for p in tp.parameters())
    n_d = sum(p.numel() for p in dp.parameters())
    print(f"phase 12 (a): {tc.name} ({tc.n_layers} of {full.n_layers} "
          f"layers "
          f"{'/'.join(tc.block_pattern[:1] + tc.block_pattern[-1:])} 7:1, "
          f"d {tc.d_model}, {tc.n_heads} heads, mLSTM width "
          f"{int(tc.mlstm_proj_factor * tc.d_model)}, V {tc.vocab}; "
          f"{n_t / 1e9:.3f} B params, {tc.param_count() / 1e9:.3f} B by "
          f"param_count) <- {dc.name} ({dc.n_layers} layers, d "
          f"{dc.d_model}; {n_d / 1e9:.3f} B params), {tp.dtype} weights "
          f"built in {time.perf_counter() - t0:.1f} s; "
          f"{torch.cuda.memory_allocated() / 1e9:.1f} GB allocated")
    data = SyntheticLM(DataConfig(vocab=tc.vocab, seed=77))
    prompts = data.sample(BATCH, PROMPT_LEN)[:, :-1]
    engines, launches = fixed_batch_methods("ssm", dc, dp, tc, tp, dev,
                                            prompts)
    profile_stateful_draft(engines["ksqs"])
    hold_sqs_at_draft_logits("ssm", engines)
    del engines
    free_cuda()
    print("phase 12 (b): rolled-back target and draft caches against a "
          "fresh prefill of the verified prefix")
    for dtype in (torch.bfloat16, torch.float32):
        if dtype != tp.dtype:
            del tp, dp
            free_cuda()
            tp = seeded_model(tc, 1, dev, dtype=dtype)
            dp = seeded_model(dc, 2, dev, dtype=dtype)
        label = f"full width {str(dtype).split('.')[-1]}"
        eng = rollback_engine(dc, dp, tc, tp, dev, prompts, L_MAX, label)
        worst = rollback_state_check(eng, prompts, failures, label,
                                     whole_stack=dtype == torch.float32)
        print(f"  {label}: largest layer difference / batch floor "
              f"{worst:.3g} (bound {ROLLBACK_FLOOR_MULT} in float32); peak "
              f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB allocated")
        del eng
    del tp, dp
    return launches


def phase_ssm_smoke_rollback(dev, failures):
    """The rollback check at the float32 smoke variants of both configs
    on the card, at the reference's 3e-4 (its test's seeds and shapes:
    L_max 3, two rows of six prompt tokens), after uncompressed rounds."""
    import torch
    from repro_torch import configs
    from repro_torch.bridge import seeded_model
    for arch in (SSM_ARCH, HYBRID_ARCH):
        tc = configs.smoke_variant(configs.get_config(arch))
        dc = configs.draft_variant(tc, 2)
        gen = torch.Generator().manual_seed(4)
        prompts = torch.randint(0, tc.vocab, (2, 6), generator=gen)
        label = f"{tc.name} f32"
        eng = rollback_engine(dc, seeded_model(dc, 3, dev), tc,
                              seeded_model(tc, 2, dev), dev,
                              prompts, 3, label)
        worst = rollback_check(eng, prompts.tolist(), label, failures,
                               atol=ROLLBACK_ATOL_F32)
        print(f"  {label}: largest difference {worst:.3g} "
              f"(bound {ROLLBACK_ATOL_F32})")


def phase_hybrid(dev):
    """(c) the jamba-1.5-large-398b smoke pair served as a 4-request
    lockstep trace, dense and paged (equal streams), and one full-width
    Mamba layer: the sequence form with its trajectory against the step
    loop.  Returns the SQS launches of the trace."""
    import torch
    from repro_torch import configs
    from repro_torch.bridge import init_params, seeded_model
    from repro_torch.kernels import sqs_fused as k
    from repro_torch.models import ssm
    t0 = time.perf_counter()
    tc = configs.smoke_variant(configs.get_config(HYBRID_ARCH))
    dc = configs.draft_variant(tc, 2)
    tp, dp = seeded_model(tc, 1, dev), seeded_model(dc, 2, dev)
    print(f"phase 12 (c): {tc.name} ({tc.n_layers} layers "
          f"{'/'.join(tc.block_pattern)}, ffn {'/'.join(tc.ffn_pattern)}, "
          f"d {tc.d_model}, V {tc.vocab}, float32) <- {dc.name}")
    trace = dict(n_requests=4, rate_rps=4.0, prompt_len=PROMPT_LEN,
                 min_new_tokens=6, max_new_tokens=10, vocab=tc.vocab, seed=5)
    k.reset_launches()
    dense = serve_run("jamba smoke dense lockstep", dc, dp, tc, tp, dev,
                      trace)
    paged = serve_run("jamba smoke paged(16) lockstep", dc, dp, tc, tp, dev,
                      trace, page_size=PAGE)
    launches = dict(k.LAUNCHES)
    check(launches["sqs_fused"] > 0, "jamba serving never launched "
          "sqs_fused")
    check(dense == paged, "jamba paged streams differ from dense")
    print(f"  streams equal dense and paged: {len(dense)} requests, "
          f"{sum(map(len, dense.values()))} tokens; launches {launches}")
    full = configs.get_config(HYBRID_ARCH)
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        m = ssm.Mamba(full, dtype, dev)
        gen = torch.Generator(device=dev).manual_seed(7)
        with torch.no_grad():
            # the reference's init: constants and 1/sqrt(fan_in) normals
            for leaf, fan in (("in_proj", full.d_model),
                              ("conv_w", full.mamba_d_conv),
                              ("x_proj", full.d_inner),
                              ("dt_proj", full.dt_rank),
                              ("out_proj", full.d_inner)):
                prm = getattr(m, leaf)
                prm.copy_(torch.randn(prm.shape, generator=gen, device=dev)
                          / math.sqrt(fan))
            x = (torch.randn((MAMBA_B, MAMBA_S, full.d_model),
                             generator=gen, device=dev) * 0.5).to(dtype)
            st = ssm.make_mamba_state(full, MAMBA_B, dtype, dev)
            t1 = time.perf_counter()
            out, last, traj = ssm.mamba_seq(full, m, x, state=st,
                                            return_state=True,
                                            collect_traj=True)
            torch.cuda.synchronize()
            t_seq = time.perf_counter() - t1
            outs, steps = [], []
            t1 = time.perf_counter()
            for t in range(MAMBA_S):
                o, st = ssm.mamba_step(full, m, x[:, t:t + 1], st)
                outs.append(o)
                steps.append(st)
            torch.cuda.synchronize()
            t_step = time.perf_counter() - t1
        pairs = [("out", out, torch.cat(outs, 1))]
        pairs += [(f"trajectory {n}", traj[n],
                   torch.stack([s[n] for s in steps], 1)) for n in traj]
        pairs += [(f"final {n}", last[n], st[n]) for n in last]
        errs = []
        for what, a, b in pairs:
            err = float((a.float() - b.float()).abs().max())
            scale = max(float(b.float().abs().max()), 1e-30)
            errs.append(f"{what} {err / scale:.3g}")
            check(err <= MAMBA_RTOL[name] * scale,
                  f"full-width Mamba {name}: {what} differs by {err:.3g} "
                  f"(max |ref| {scale:.3g})")
        print(f"  full-width Mamba layer (d {full.d_model}, d_inner "
              f"{full.d_inner}, d_state {full.mamba_d_state}, dt_rank "
              f"{full.dt_rank}), {name}, B {MAMBA_B} x S {MAMBA_S}: "
              f"sequence form {t_seq * 1e3:.1f} ms, step loop "
              f"{t_step * 1e3:.1f} ms; max |seq - step| / max |step| "
              + ", ".join(errs) + f" (bound {MAMBA_RTOL[name]})")
        del m, out, traj, steps, outs
    del tp, dp
    torch.cuda.empty_cache()
    print(f"  phase 12 (c): {time.perf_counter() - t0:.1f} s")
    return launches


def phase_refusals(dev):
    """A pipelined trace and a TCP handshake with a stateful target each
    end in the refusal of serve.events / serve.net, and in nothing
    else."""
    import socket
    from repro_torch import configs
    from repro_torch.bridge import seeded_model
    from repro_torch.core import transport as tp_mod
    from repro_torch.core.engine import (EdgeCloudEngine, EngineConfig,
                                         MethodConfig, StatefulModelError)
    from repro_torch.serve import (ServeConfig, ServeSession, TraceConfig,
                                   poisson_trace)
    from repro_torch.serve.events import PIPELINED_REFUSAL
    from repro_torch.serve.net import (TCP_TARGET_REFUSAL, CloudServer,
                                       engine_digest)
    tc = configs.smoke_variant(configs.get_config(SSM_ARCH))
    dc = configs.draft_variant(tc, 2)
    method, ecfg = MethodConfig("csqs"), EngineConfig(L_max=L_MAX)
    eng = EdgeCloudEngine(dc, seeded_model(dc, 2, dev), tc,
                          seeded_model(tc, 1, dev), method, ecfg, seed=0,
                          device=dev)
    sess = ServeSession(eng, ServeConfig(max_batch=2, cache_len=48,
                                         pipeline="pipelined"))
    try:
        sess.run_trace(poisson_trace(TraceConfig(
            n_requests=2, prompt_len=8, vocab=tc.vocab, seed=1)))
    except StatefulModelError as e:
        check(str(e) == PIPELINED_REFUSAL, f"pipelined refusal: {e}")
        print(f"  pipelined trace refused: {e}")
    else:
        raise CheckFailed("a pipelined trace served a stateful model")
    server = CloudServer(device=dev).start()
    try:
        sock = socket.create_connection(("127.0.0.1", server.port),
                                        timeout=60)
        conn = tp_mod.Conn(sock, timeout_s=60)
        try:
            conn.send_json(tp_mod.MSG_HELLO, {
                "proto": tp_mod.PROTO_VERSION, "session": "ssm", "cell": 0,
                "n_cells": 1, "config": engine_digest(
                    SSM_ARCH, False, method, ecfg, 0, SLOTS, 48, False)})
            conn.recv_expect(tp_mod.MSG_HELLO_OK)
        except tp_mod.TransportError as e:
            want = f"peer error: bad config: {TCP_TARGET_REFUSAL}"
            check(str(e) == want, f"tcp refusal: {e}")
            print(f"  tcp handshake with a full-width {SSM_ARCH} target "
                  f"refused: {e}")
        else:
            raise CheckFailed("the tcp server accepted a stateful target")
        finally:
            conn.close()
    finally:
        server.stop()


def phase_ssm(dev):
    """Phase 12: the SSM and hybrid family, after the earlier models are
    freed; every part sets the kernels' launch counts to 0 before it and
    reads them after.  Returns the SQS launches of the phase."""
    import torch
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    failures = []
    launches = phase_ssm_full_width(dev, failures)
    free_cuda()
    phase_ssm_smoke_rollback(dev, failures)
    for name, n in phase_hybrid(dev).items():
        launches[name] += n
    phase_refusals(dev)
    check(not failures, "phase 12 rollback: " + "; ".join(failures))
    print(f"  phase 12: {time.perf_counter() - t0:.1f} s; peak "
          f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB allocated; SQS "
          f"launches {launches}")
    return launches


# ----------------------------------------------------------------------
# phase 13: MLA with its dense prefix layer, and the sliding window
# ----------------------------------------------------------------------
MLA_ARCH, WINDOW_ARCH = "deepseek-v2-lite-16b", "qwen2.5-3b"
# (a) runs deepseek-v2-lite-16b cut from 27 to MLA_LAYERS layers at full
# width: the dense first layer and 8 MoE layers (its draft 5 of 14)
MLA_LAYERS = 9
# (b)-(d) run the window's config at full width cut from 36 to
# WINDOW_LAYERS layers (its draft 6 of 18): the ring is a layer's own, and
# a third of the stack still has later layers that read what an earlier
# layer's replay wrote; the cut keeps the phase near a minute shorter
WINDOW_LAYERS = 12
# (b) for_shape(qwen2.5-3b, long_500k) at full width: a prompt RING_PAST
# positions longer than its window W (so the ring has wrapped), then
# RING_STEPS decode steps through the ring against the teacher-forced
# windowed logits of the same tokens (W + RING_PAST and W + RING_PAST +
# RING_STEPS are multiples of 32, so both passes run in query chunks of 32
# or more).  Bounds on max |logit difference|, set before the first card
# run: a ring that lost or mislabelled keys decorrelates the logits by
# whole units; the next-token argmax must agree wherever the recompute's
# top-2 gap exceeds the bound.  At the float32 smoke variant the
# reference's own ring test (W 8, a 12-token prompt, 24 tokens) at its
# bound.
RING_PAST, RING_STEPS = 32, 32
RING_ATOL = {"bfloat16": 0.5, "float32": 1e-3}
RING_SMOKE_ATOL = 2e-4


@contextlib.contextmanager
def moe_ranges(model):
    """Each MoE layer's forward inside a ``record_function("moe")`` range,
    so a profile can total the device time of its kernels."""
    import torch
    from repro_torch.models.moe import MoE
    opened, hooks = [], []

    def enter(mod, args):
        rf = torch.profiler.record_function("moe")
        rf.__enter__()
        opened.append(rf)

    def leave(mod, args, out):
        opened.pop().__exit__(None, None, None)
    for m in model.modules():
        if isinstance(m, MoE):
            hooks += [m.register_forward_pre_hook(enter),
                      m.register_forward_hook(leave)]
    try:
        yield
    finally:
        for h in hooks:
            h.remove()


def moe_share(label, prof, dev_us):
    """The device time of the ``moe`` ranges of a profile and its share of
    the profile's device time."""
    import torch
    if dev_us == 0.0:
        print(f"    {label}: MoE share not measured (no device time)")
        return
    moe_us = sum(ev.device_time_total for ev in prof.events()
                 if ev.name == "moe"
                 and ev.device_type == torch.autograd.DeviceType.CPU)
    print(f"    {label}: MoE layers {moe_us / 1e3:.3f} ms of device time = "
          f"{moe_us / dev_us:.3f} of it")


def phase_mla(dev):
    """(a) deepseek-v2-lite-16b at full width with its 2x draft.  Returns
    the SQS launches of the path."""
    import torch
    from repro_torch import configs
    from repro_torch.bridge import seeded_model
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.kernels import sqs_fused as k
    t0 = time.perf_counter()
    full = configs.get_config(MLA_ARCH)
    tc = depth_cut(full, MLA_LAYERS)
    dc = configs.draft_variant(tc, 2)
    tp = seeded_model(tc, 1, dev)
    dp = seeded_model(dc, 2, dev)
    torch.cuda.synchronize()
    n_t = sum(p.numel() for p in tp.parameters())
    n_d = sum(p.numel() for p in dp.parameters())
    print(f"phase 13 (a): {tc.name} ({tc.n_layers} of {full.n_layers} "
          f"layers, the first "
          f"dense; d {tc.d_model}, {tc.n_heads} heads, MLA kv_lora "
          f"{tc.kv_lora_rank}, rope_hd {tc.rope_head_dim}; "
          f"{tc.n_experts} routed top-{tc.moe_top_k} + "
          f"{tc.n_shared_experts} shared experts of {tc.d_expert}; V "
          f"{tc.vocab}; {n_t / 1e9:.3f} B params) <- {dc.name} "
          f"({dc.n_layers} layers, d {dc.d_model}, kv_lora "
          f"{dc.kv_lora_rank}; {n_d / 1e9:.3f} B params), {tp.dtype} "
          f"weights built in {time.perf_counter() - t0:.1f} s; "
          f"{torch.cuda.memory_allocated() / 1e9:.1f} GB allocated")
    data = SyntheticLM(DataConfig(vocab=tc.vocab, seed=77))
    prompts = data.sample(BATCH, PROMPT_LEN)[:, :-1]
    engines, launches = fixed_batch_methods("mla", dc, dp, tc, tp, dev,
                                            prompts)
    eng = engines["ksqs"]
    for side, cache in (("target", eng.cloud.tcache),
                        ("draft", eng.edge.dcache)):
        check(all(sorted(c) == ["k_rope", "latent"] and
                  c["latent"].dtype == tp.dtype for c in cache),
              f"mla {side}: cache leaves")
        lat, rope = cache[0]["latent"], cache[0]["k_rope"]
        per_token = (lat.shape[-1] + rope.shape[-1]) * lat.element_size()
        print(f"  {side} cache: {len(cache)} layers of latent "
              f"{tuple(lat.shape)} + k_rope {tuple(rope.shape)}, "
              f"{lat.dtype}; {per_token} B a token a layer")
    with moe_ranges(dp), moe_ranges(tp):
        moe_share("the draft call", *profile_draft(eng))
        moe_share("the verify forward", *profile_verify(eng))
    hold_sqs_at_draft_logits("mla", engines)
    del engines, eng
    trace = dict(n_requests=4, rate_rps=4.0, prompt_len=PROMPT_LEN,
                 min_new_tokens=4, max_new_tokens=6, vocab=tc.vocab, seed=5)
    k.reset_launches()
    t1 = time.perf_counter()
    dense = serve_run("mla dense lockstep", dc, dp, tc, tp, dev, trace)
    paged = serve_run("mla paged(16) lockstep", dc, dp, tc, tp, dev, trace,
                      page_size=PAGE)
    pipe = serve_run("mla paged(16) pipelined + speculation", dc, dp, tc,
                     tp, dev, trace, page_size=PAGE, pipeline="pipelined")
    check(dense == paged == pipe, "mla: paged or pipelined streams differ "
          "from dense lockstep")
    check(k.LAUNCHES["sqs_fused"] > 0, "mla serving never launched "
          "sqs_fused")
    for name, n in k.LAUNCHES.items():
        launches[name] += n
    print(f"  mla streams equal across dense lockstep, paged lockstep and "
          f"paged pipelined: {len(dense)} requests, "
          f"{sum(map(len, dense.values()))} tokens; serving launches "
          f"{dict(k.LAUNCHES)}; {time.perf_counter() - t1:.1f} s")
    return launches


def ring_check(model, toks, n_steps, atol, label):
    """Prefill all but the last ``n_steps`` tokens of ``toks`` (1, S) into
    a cache of capacity S, decode the rest one step at a time, and hold
    each step's logits against the teacher-forced logits of ``toks``:
    max |difference| within ``atol``, and the argmax equal wherever the
    recompute's top-2 gap exceeds ``atol``."""
    import torch
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import model as model_mod
    S = toks.shape[1]
    S_p, W = S - n_steps, attn_mod.window(model.cfg)
    with torch.no_grad():
        full = model_mod.forward_logits(model, toks)[0, S_p:].clone()
    _, cache = model_mod.prefill(model, toks[:, :S_p], cache_len=S)
    ring = cache[0]["k"].shape[1]
    check(ring == min(W, S), f"{label}: a ring of {ring} slots")
    worst, near_ties = 0.0, 0
    for t in range(n_steps):
        pos = torch.full((1,), S_p + t, device=toks.device)
        lg, cache = model_mod.decode_step(model, toks[:, S_p + t], cache,
                                          pos)
        ref = full[t]
        worst = max(worst, float((lg[0] - ref).abs().max()))
        if int(lg[0].argmax()) != int(ref.argmax()):
            top2 = ref.topk(2).values
            check(float(top2[0] - top2[1]) <= atol,
                  f"{label}: step {t} argmax differs (gap "
                  f"{float(top2[0] - top2[1]):.3g})")
            near_ties += 1
    print(f"  {label}: W {W}, prompt {S_p} (the ring wrapped "
          f"{S_p // W} time(s)), {n_steps} decode steps through the ring: "
          f"max |logit difference| {worst:.3g} (bound {atol}); argmax "
          f"equal in {n_steps - near_ties} of {n_steps}, the rest near "
          f"ties of the recompute")
    check(worst <= atol, f"{label}: {worst:.3g} > {atol}")


def phase_window(dev):
    """(b) the ring at full width in bf16 and float32 and at the float32
    smoke variant; (c) a K-SQS round on the full-width ring where it
    cannot wrap, then rounds past the wrap; (d) the float32 pair at a
    small window with and without the spare.  Returns the SQS launches
    of (c) and (d)."""
    import dataclasses
    import torch
    from repro_torch import configs
    from repro_torch.bridge import seeded_model
    from repro_torch.core.engine import (EdgeCloudEngine, EngineConfig,
                                         MethodConfig)
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.kernels import sqs_fused as k
    full = configs.for_shape(configs.get_config(WINDOW_ARCH),
                             configs.INPUT_SHAPES["long_500k"])
    tc = depth_cut(full, WINDOW_LAYERS)
    W = tc.sliding_window
    print(f"phase 13 (b): {full.name} for long_500k ({tc.attention}, W {W}) "
          f"at full width (d {tc.d_model}, {tc.n_heads}/{tc.n_kv_heads} "
          f"heads) cut from {full.n_layers} to {tc.n_layers} layers")
    gen = torch.Generator(device=dev).manual_seed(17)
    toks = torch.randint(0, tc.vocab, (1, W + RING_PAST + RING_STEPS),
                         generator=gen, device=dev)
    for dtype in (torch.float32, torch.bfloat16):
        t1 = time.perf_counter()
        tp = seeded_model(tc, 1, dev, dtype=dtype)
        name = str(dtype).split(".")[-1]
        ring_check(tp, toks, RING_STEPS, RING_ATOL[name],
                   f"full width {name}")
        print(f"    {time.perf_counter() - t1:.1f} s; peak "
              f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB allocated")
        if dtype == torch.float32:
            del tp
            free_cuda()
    smoke = dataclasses.replace(
        configs.smoke_variant(configs.get_config(WINDOW_ARCH)),
        attention="sliding", sliding_window=8)
    ring_check(seeded_model(smoke, 0, dev), toks[:, :24] % smoke.vocab, 12,
               RING_SMOKE_ATOL, "smoke float32")
    dc = configs.draft_variant(tc, 2)
    dp = seeded_model(dc, 2, dev)
    print(f"phase 13 (c): {tc.name} (W {W}) <- {dc.name} (W "
          f"{dc.sliding_window}), {tp.dtype}, served before and past the "
          "wrap")
    eng = EdgeCloudEngine(dc, dp, tc, tp, MethodConfig("ksqs", K=64,
                                                       ell=100),
                          EngineConfig(L_max=L_MAX), seed=0, device=dev)
    prompts = SyntheticLM(DataConfig(vocab=tc.vocab, seed=77)).sample(
        BATCH, PROMPT_LEN)[:, :-1]
    k.reset_launches()
    rounds, out = eng.run(prompts, ROUNDS)
    launches = dict(k.LAUNCHES)
    steps = ROUNDS * (L_MAX + 1)
    check(launches == {"sqs_fused": steps, "topk_threshold": steps},
          f"window: launches {launches}")
    check(all(len(row) >= ROUNDS and all(0 <= t < tc.vocab for t in row)
              for row in out), f"window: tokens {out}")
    print(f"  {ROUNDS} ksqs rounds at capacity {eng.cloud.cache_len} <= W: "
          f"ring of {eng.tcache[0]['k'].shape[1]} slots, t_slm ms median "
          f"{statistics.median(r['t_slm'] for r in rounds) * 1e3:.2f} ("
          + " ".join(f"{r['t_slm'] * 1e3:.1f}" for r in rounds)
          + "), t_llm ms median "
          f"{statistics.median(r['t_llm'] for r in rounds) * 1e3:.2f} ("
          + " ".join(f"{r['t_llm'] * 1e3:.1f}" for r in rounds)
          + f"); launches {launches}")
    del eng
    for name, n in past_the_wrap(dev, dc, dp, tc, tp).items():
        launches[name] += n
    del tp, dp
    free_cuda()
    for name, n in small_window_rings(dev, tc).items():
        launches[name] += n
    return launches


# (c) past the wrap: prompts of W + WRAP_PAST + 1 tokens (the prefill's
# W + WRAP_PAST, a multiple of 512, runs in query chunks of 512: the
# chunk loop is host-bound at B 1), so the ring wrapped before the first
# round; K-SQS rounds, which reject, and uncompressed rounds with every
# draft sent (WRAP_BUDGET bits), which accept, fixed batch then a
# pipelined trace with speculation
WRAP_PAST, WRAP_BUDGET = 512, 1e9
WRAP_ROUNDS = {"ksqs": 3, "uncompressed": 1}
# a trace's requests and new tokens a request: room for a speculative
# round after the first (K-SQS sends ~5 drafts a round at 5000 bits,
# uncompressed all L_MAX)
WRAP_TRACE = {"ksqs": (1, 7), "uncompressed": (1, 10)}
# (d) the full-width float32 pair at a window where one lost key shows
# (W 8192 hides a few): prompts of SMALL_W_PROMPT tokens, SMALL_W_ROUNDS
# K-SQS rounds (which reject), with the engine's spare and with none,
# and with the spare a pipelined trace of SMALL_W_TRACE
SMALL_W, SMALL_W_PROMPT, SMALL_W_ROUNDS = 64, 161, 3
SMALL_W_TRACE = (2, 7)


def teacher_forced_last(model, rows):
    """The windowed teacher-forced logits after the last token of each of
    ``rows`` (token lists): one pass of the stack over the rows padded to
    a multiple of 512 (causal, so the padding is not read; query chunks
    of 512), the head at each row's last position only.  (B, V)."""
    import torch
    from repro_torch.models import model as model_mod
    lens = [len(r) for r in rows]
    t = torch.zeros((len(rows), -(-max(lens) // 512) * 512),
                    dtype=torch.int64, device=model.device)
    for i, r in enumerate(rows):
        t[i, :len(r)] = torch.tensor(r, device=model.device)
    last = torch.tensor(lens, device=model.device) - 1
    with torch.no_grad():
        x, _ = model_mod._stack(model, t, None, None, remat=False,
                                dropless=True)
        x = x[torch.arange(len(rows), device=model.device), last]
        return model.head(x[:, None])[:, 0]


def hold_rings(label, eng, streams, atol, strict=True):
    """Each row's served target and draft caches against a teacher-forced
    windowed recompute of its committed tokens ``streams[b]`` (prompt +
    emitted): the next-token logits of a decode step of the row's last
    committed token on the served cache against the recompute's.  With
    ``strict``, max |difference| within ``atol`` and the argmax equal
    wherever the recompute's top-2 gap exceeds it.  Returns the worst
    difference of each side."""
    from repro_torch.models import model as model_mod
    worst = {}
    for side, actor, cache in (("target", eng.cloud, eng.cloud.tcache),
                               ("draft", eng.edge, eng.edge.dcache)):
        rows = sorted(streams)
        for b, p in zip(rows, actor.pos[rows].tolist()):
            check(len(streams[b]) == p + 1
                  and streams[b][-1] == int(actor.x_last[b]),
                  f"{label} {side}: row {b} stream and position disagree")
        lg, _ = model_mod.decode_step(actor.model, actor.x_last, cache,
                                      actor.pos)
        ref = teacher_forced_last(actor.model, [streams[b] for b in rows])
        got = lg[rows].float()
        worst[side] = float((got - ref).abs().max())
        if strict:
            check(worst[side] <= atol, f"{label} {side}: max |logit "
                  f"difference| {worst[side]:.3g} > {atol}")
            for i, b in enumerate(rows):
                if int(got[i].argmax()) != int(ref[i].argmax()):
                    top2 = ref[i].topk(2).values
                    check(float(top2[0] - top2[1]) <= atol,
                          f"{label} {side}: row {b} argmax differs")
    return worst


def serve_rounds(label, eng, prompts, pipeline, n_rounds, trace):
    """Fixed-batch ``n_rounds`` of ``prompts`` (B, P) (``pipeline``
    "lockstep"), or a pipelined trace of ``trace`` = (requests, new
    tokens a request) prompts of P tokens over SLOTS slots, which must
    speculate.  Returns (each row's committed tokens: prompt + emitted,
    a summary for the log)."""
    import numpy as np
    from repro_torch.serve import (ServeConfig, ServeSession, TraceConfig,
                                   poisson_trace)
    P = prompts.shape[1]
    if pipeline == "lockstep":
        rounds, _ = eng.run(prompts, n_rounds)
        streams = {b: [int(t) for t in prompts[b]]
                   for b in range(prompts.shape[0])}
        extra = ("accepted tokens a row a round " + " ".join(
            f"{float(r['n_accept'].mean()):.2f}" for r in rounds))
    else:
        streams, admit = {}, eng.admit_slot

        def admitted(slot, prompt, seed, **kw):
            streams[slot] = [int(t) for t in np.asarray(prompt)]
            return admit(slot, prompt, seed, **kw)
        eng.admit_slot = admitted
        n_req, new = trace
        rep = ServeSession(eng, ServeConfig(
            max_batch=SLOTS, cache_len=P + new + L_MAX + 1, t_slm_s=0.05,
            t_llm_s=0.03, pipeline="pipelined")).run_trace(
                poisson_trace(TraceConfig(
                    n_requests=n_req, rate_rps=50.0, prompt_len=P,
                    min_new_tokens=new, max_new_tokens=new,
                    vocab=eng.V, seed=6)))
        summ = rep.summary()
        check(rep.n_finished == n_req and summ["n_spec_hits"]
              + summ["n_spec_misses"] > 0, f"{label}: {rep.n_finished} "
              f"of {n_req} finished, {summ['n_spec_hits']} + "
              f"{summ['n_spec_misses']} speculative rounds")
        extra = (f"{summ['total_tokens']} tokens in {summ['n_rounds']} "
                 f"rounds, speculation {summ['n_spec_hits']} hits / "
                 f"{summ['n_spec_misses']} misses")
    for b in streams:
        streams[b] += [int(t) for t in eng.out_tokens[b]]
    return streams, extra


def past_the_wrap(dev, dc, dp, tc, tp):
    """(c): the W-8192 pair past the wrap, fixed batch and a pipelined
    trace, each method's rounds timed, each row's caches held against the
    windowed recompute at RING_ATOL.  Returns the SQS launches."""
    import torch
    from repro_torch.core.engine import (EdgeCloudEngine, EngineConfig,
                                         MethodConfig, ring_spare)
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.kernels import sqs_fused as k
    W = tc.sliding_window
    P = W + WRAP_PAST + 1
    atol = RING_ATOL[str(tp.dtype).split(".")[-1]]
    prompts = SyntheticLM(DataConfig(vocab=tc.vocab, seed=78)).sample(
        BATCH, P)[:, :P]
    launches = {name: 0 for name in k.LAUNCHES}
    for method in ("ksqs", "uncompressed"):
        budget = WRAP_BUDGET if method == "uncompressed" else 5000.0
        for pipeline in ("lockstep", "pipelined"):
            label = f"past the wrap, {method}, {pipeline}"
            eng = EdgeCloudEngine(dc, dp, tc, tp,
                                  MethodConfig(method, K=64, ell=100),
                                  EngineConfig(L_max=L_MAX,
                                               bit_budget=budget),
                                  seed=0, device=dev)
            log = {"t_slm": [], "t_llm": []}
            record_times(eng, log)
            t1 = time.perf_counter()
            k.reset_launches()
            streams, extra = serve_rounds(label, eng, prompts, pipeline,
                                          WRAP_ROUNDS[method],
                                          WRAP_TRACE[method])
            got = dict(k.LAUNCHES)
            wall = time.perf_counter() - t1
            if method == "ksqs":
                check(got["sqs_fused"] == got["topk_threshold"] > 0,
                      f"{label}: launches {got}")
            for name in launches:
                launches[name] += got[name]
            R = eng.tcache[0]["k"].shape[1]
            check(R == W + ring_spare(L_MAX) and eng.dcache[0]["k"].shape[1]
                  == R, f"{label}: a ring of {R} slots")
            worst = hold_rings(label, eng, streams, atol)
            print(f"  {label}: prompts of {P} tokens, rings of {R} slots "
                  f"(W + {R - W}); {wall:.1f} s; {extra}; launches {got}")
            print(f"    t_slm ms median "
                  f"{statistics.median(log['t_slm']) * 1e3:.2f} ("
                  + " ".join(f"{t * 1e3:.1f}" for t in log["t_slm"])
                  + f"), t_llm ms median "
                  f"{statistics.median(log['t_llm']) * 1e3:.2f} ("
                  + " ".join(f"{t * 1e3:.1f}" for t in log["t_llm"]) + ")")
            print(f"    caches against the windowed recompute of "
                  f"{len(streams)} rows' committed tokens: max |logit "
                  f"difference| target {worst['target']:.3g}, draft "
                  f"{worst['draft']:.3g} (bound {atol})")
            del eng
            torch.cuda.empty_cache()
    return launches


def small_window_rings(dev, tc):
    """(d): the full-width float32 pair at W SMALL_W served past its wrap
    with the engine's spare (fixed batch and a pipelined trace) and with
    none (fixed batch): the caches within RING_ATOL["float32"] of the
    recompute with the spare, the target's past it without.  Returns the
    SQS launches."""
    import dataclasses
    import torch
    from repro_torch.bridge import seeded_model
    from repro_torch.core import engine as engine_mod
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.kernels import sqs_fused as k
    from repro_torch import configs
    t0 = time.perf_counter()
    tc = dataclasses.replace(tc, sliding_window=SMALL_W)
    dc = configs.draft_variant(tc, 2)
    tp = seeded_model(tc, 1, dev, dtype=torch.float32)
    dp = seeded_model(dc, 2, dev, dtype=torch.float32)
    atol = RING_ATOL["float32"]
    prompts = SyntheticLM(DataConfig(vocab=tc.vocab, seed=79)).sample(
        BATCH, SMALL_W_PROMPT)[:, :SMALL_W_PROMPT]
    spare = engine_mod.ring_spare
    launches = {name: 0 for name in k.LAUNCHES}
    worst = {}
    try:
        for label, sp in (("the engine's spare", spare(L_MAX)),
                          ("no spare", 0)):
            engine_mod.ring_spare = lambda L, sp=sp: sp
            # with the spare also a pipelined trace, whose speculative
            # drafts write furthest past the committed position
            for pipeline in ("lockstep", "pipelined")[:1 + (sp > 0)]:
                name = f"W {SMALL_W}, {label}, {pipeline}"
                eng = engine_mod.EdgeCloudEngine(
                    dc, dp, tc, tp, engine_mod.MethodConfig("ksqs", K=64,
                                                            ell=100),
                    engine_mod.EngineConfig(L_max=L_MAX), seed=0,
                    device=dev)
                k.reset_launches()
                rows, extra = serve_rounds(name, eng, prompts, pipeline,
                                           SMALL_W_ROUNDS, SMALL_W_TRACE)
                for kname, n in k.LAUNCHES.items():
                    launches[kname] += n
                check(eng.tcache[0]["k"].shape[1] == SMALL_W + sp,
                      f"{name}: ring size")
                worst[name] = hold_rings(name, eng, rows, atol,
                                         strict=sp > 0)
                print(f"  full width float32 {name} (rings of "
                      f"{SMALL_W + sp}), ksqs on {SMALL_W_PROMPT}-token "
                      f"prompts, {extra}: max |logit difference| against "
                      f"the recompute: target {worst[name]['target']:.3g}, "
                      f"draft {worst[name]['draft']:.3g} (bound {atol})")
                del eng
    finally:
        engine_mod.ring_spare = spare
    no_spare = worst[f"W {SMALL_W}, no spare, lockstep"]["target"]
    check(no_spare > atol, f"W {SMALL_W}, no spare: the lost keys do not "
          f"show ({no_spare:.3g})")
    print(f"  phase 13 (d): {time.perf_counter() - t0:.1f} s; launches "
          f"{launches}")
    del tp, dp
    free_cuda()
    return launches


def phase_mla_window(dev):
    """Phase 13, after the earlier models are freed.  Returns the SQS
    launches of the phase."""
    import torch
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    launches = phase_mla(dev)
    print(f"  phase 13 (a): {time.perf_counter() - t0:.1f} s; peak "
          f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB allocated")
    free_cuda()
    for name, n in phase_window(dev).items():
        launches[name] += n
    print(f"  phase 13: {time.perf_counter() - t0:.1f} s; peak "
          f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB allocated; SQS "
          f"launches {launches}")
    return launches


# ----------------------------------------------------------------------
# phase 14: the encoder-decoder and M-RoPE family
# ----------------------------------------------------------------------
VL_ARCH, VL_LAYERS, VL_F32_LAYERS = "qwen2-vl-72b", 16, 4
# the 2x draft cut from 40 layers in the target's proportion (80 -> 16):
# at 40 layers the draft is deeper than the cut target, and its t_slm
# (~1 s a round) was most of the phase's time
VL_DRAFT_LAYERS = 8
ENCDEC_ARCH = "seamless-m4t-large-v2"
# (a) a VL_GRID x VL_GRID patch grid (frontend.vision_patch_positions),
# then VL_TEXT text positions from VL_GRID on (mrope_text_positions), a
# batch of VL_BATCH; (a) and (b) then run N_DECODE decode steps and one
# N_EXTEND-token extend, each step against the teacher-forced logits of
# the same tokens at the same positions (decoded tokens at t == h == w ==
# their index, as extend and decode place them)
VL_BATCH, VL_GRID, VL_TEXT = 2, 16, 16
N_DECODE, N_EXTEND = 16, 9
# (b) B ENCDEC_BATCH x ENC_LEN stub frames (launch/dryrun.py's ENC_LEN)
# and ENCDEC_PROMPT prompt tokens; three launch.train steps at B
# ENCDEC_TRAIN[0] x S ENCDEC_TRAIN[1]
ENCDEC_BATCH, ENC_LEN, ENCDEC_PROMPT = 4, 4096, 16
ENCDEC_TRAIN = (4, 128, 3)
# cross K/V a frame of one row: 2 x layers x nkv x hd x 2 B (bf16)
CROSS_BYTES = {"target": 98_304, "draft": 24_576}
# bounds on max |logit difference| of the serve path against the
# teacher-forced logits, set before the first card run: bf16 logits near
# 4-8 have an ulp of 0.03 and 16-24 random layers drift a few ulps, a
# lost cross cache or a wrong position stream moves them by whole units;
# in bf16 the argmax must agree wherever the recompute's top-2 gap
# exceeds the bound, in float32 everywhere
SERVE_ATOL = {"bfloat16": 0.5, "float32": 1e-3}


def serve_vs_teacher(label, model, toks, S_p, positions=None,
                     enc_embeds=None, measure_rise=False):
    """Prefill ``toks[:, :S_p]`` (at ``positions[..., :S_p]`` when
    given), N_DECODE decode steps and one N_EXTEND-token extend, against
    ``forward_logits`` of all of ``toks`` at ``positions``: max |logit
    difference| within SERVE_ATOL of the model's dtype, and the argmax
    equal (in bf16 wherever the recompute's top-2 gap exceeds the bound).
    With ``measure_rise``, returns the largest rise of
    ``max_memory_allocated`` over one decode step (which resets the
    peak)."""
    import torch
    from repro_torch.models import model as model_mod
    B, S = toks.shape
    check(S == S_p + N_DECODE + N_EXTEND, f"{label}: {S} tokens")
    dtype = str(model.dtype).split(".")[-1]
    atol = SERVE_ATOL[dtype]
    with torch.no_grad():
        full = model_mod.forward_logits(model, toks, positions=positions,
                                        enc_embeds=enc_embeds)[:, S_p - 1:]
    lg, cache = model_mod.prefill(
        model, toks[:, :S_p], cache_len=S, enc_embeds=enc_embeds,
        positions=None if positions is None else positions[..., :S_p])
    got, rise = [lg], 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(N_DECODE):
        pos = torch.full((B,), S_p + t, device=toks.device)
        if measure_rise:
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        lg, cache = model_mod.decode_step(model, toks[:, S_p + t], cache,
                                          pos)
        if measure_rise:
            rise = max(rise, torch.cuda.max_memory_allocated() - base)
        got.append(lg)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / N_DECODE
    pos = torch.full((B,), S_p + N_DECODE, device=toks.device)
    lg, _, _ = model_mod.extend_step(model, toks[:, S_p + N_DECODE:], cache,
                                     pos)
    got = torch.cat([torch.stack(got, 1), lg], 1)
    worst = float((got - full).abs().max())
    ga, fa = got.argmax(-1), full.argmax(-1)
    top2 = full.topk(2, -1).values
    gap = top2[..., 0] - top2[..., 1]
    n_diff = int((ga != fa).sum())
    unexcused = int(((ga != fa) & (gap > atol)).sum()) \
        if dtype == "bfloat16" else n_diff
    print(f"  {label} ({dtype}): prefill {S_p}, {N_DECODE} decode steps and "
          f"a {N_EXTEND}-token extend against the teacher-forced logits: max "
          f"|logit difference| {worst:.3g} (bound {atol}); argmax equal at "
          f"{ga.numel() - n_diff} of {ga.numel()} positions, "
          f"{n_diff - unexcused} near ties of the recompute; a decode step "
          f"{step_ms:.2f} ms of wall")
    check(worst <= atol, f"{label}: {worst:.3g} > {atol}")
    check(unexcused == 0, f"{label}: argmax differs at {unexcused} "
          "positions past the bound's gap")
    return rise


def phase_vl(dev):
    """(a) qwen2-vl-72b at full width, cut to VL_LAYERS layers, with its
    2x draft cut to VL_DRAFT_LAYERS: all four methods, the SQS kernels
    held, one draft call and one verify profiled, a trace dense / paged /
    pipelined, and the vision prefill in bf16 and at VL_F32_LAYERS layers
    in float32.
    Returns the SQS launches of the path."""
    import torch
    from repro_torch import configs
    from repro_torch.bridge import seeded_model
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.kernels import sqs_fused as k
    from repro_torch.models import frontend
    t0 = time.perf_counter()
    full = configs.get_config(VL_ARCH)
    tc = depth_cut(full, VL_LAYERS)
    dc = depth_cut(configs.draft_variant(full, 2), VL_DRAFT_LAYERS)
    tp = seeded_model(tc, 1, dev)
    dp = seeded_model(dc, 2, dev)
    torch.cuda.synchronize()
    n_t = sum(p.numel() for p in tp.parameters())
    n_d = sum(p.numel() for p in dp.parameters())
    print(f"phase 14 (a): {tc.name}: {VL_ARCH} at full width (d "
          f"{tc.d_model}, {tc.n_heads}/{tc.n_kv_heads} heads of "
          f"{tc.head_dim}, d_ff {tc.d_ff}, V {tc.vocab}, M-RoPE sections "
          f"{tc.mrope_sections}, qkv biases) cut from {full.n_layers} to "
          f"{tc.n_layers} layers ({n_t / 1e9:.3f} B params, "
          f"{n_t * 2 / 1e9:.2f} GB bf16; the full depth is 145.4 GB) <- "
          f"{dc.name} at full width ({dc.n_layers} layers, d {dc.d_model}, "
          f"{dc.n_heads}/{dc.n_kv_heads} heads; {n_d / 1e9:.3f} B params), "
          f"{tp.dtype} weights built in {time.perf_counter() - t0:.1f} s; "
          f"{torch.cuda.memory_allocated() / 1e9:.1f} GB allocated")
    data = SyntheticLM(DataConfig(vocab=tc.vocab, seed=77))
    prompts = data.sample(BATCH, PROMPT_LEN)[:, :-1]
    engines, launches = fixed_batch_methods("vl", dc, dp, tc, tp, dev,
                                            prompts)
    eng = engines["ksqs"]
    profile_draft(eng)
    profile_verify(eng)
    hold_sqs_at_draft_logits("vl", engines)
    del engines, eng
    # 2-3 new tokens a request: a 40-layer draft call takes ~1 s of host
    # work on an H100 80GB HBM3, so 4-6 new tokens took 62.8 s (PERF.md)
    trace = dict(n_requests=4, rate_rps=4.0, prompt_len=PROMPT_LEN,
                 min_new_tokens=2, max_new_tokens=3, vocab=tc.vocab, seed=5)
    k.reset_launches()
    t1 = time.perf_counter()
    dense = serve_run("vl dense lockstep", dc, dp, tc, tp, dev, trace)
    paged = serve_run("vl paged(16) lockstep", dc, dp, tc, tp, dev, trace,
                      page_size=PAGE)
    pipe = serve_run("vl paged(16) pipelined + speculation", dc, dp, tc, tp,
                     dev, trace, page_size=PAGE, pipeline="pipelined")
    check(dense == paged == pipe, "vl: paged or pipelined streams differ "
          "from dense lockstep")
    check(k.LAUNCHES["sqs_fused"] > 0, "vl serving never launched sqs_fused")
    for name, n in k.LAUNCHES.items():
        launches[name] += n
    print(f"  vl streams equal across dense lockstep, paged lockstep and "
          f"paged pipelined: {len(dense)} requests, "
          f"{sum(map(len, dense.values()))} tokens; serving launches "
          f"{dict(k.LAUNCHES)}; {time.perf_counter() - t1:.1f} s")
    del dp
    free_cuda()
    n_patch = VL_GRID * VL_GRID
    S_p = n_patch + VL_TEXT
    pos3 = torch.cat([
        frontend.vision_patch_positions(VL_BATCH, n_patch, VL_GRID, VL_GRID,
                                        device=dev),
        frontend.mrope_text_positions(VL_BATCH, VL_TEXT, start=VL_GRID,
                                      device=dev),
        frontend.mrope_text_positions(VL_BATCH, N_DECODE + N_EXTEND,
                                      start=S_p, device=dev)], -1)
    gen = torch.Generator(device=dev).manual_seed(23)
    toks = torch.randint(0, tc.vocab, (VL_BATCH, pos3.shape[-1]),
                         generator=gen, device=dev)
    print(f"  vision prefill: a {VL_GRID} x {VL_GRID} patch grid (t 0, h "
          f"and w 0..{VL_GRID - 1}) then {VL_TEXT} text positions from "
          f"{VL_GRID}, B {VL_BATCH}")
    serve_vs_teacher(f"vl {tc.name}", tp, toks, S_p, positions=pos3)
    del tp
    free_cuda()
    tc32 = depth_cut(configs.get_config(VL_ARCH), VL_F32_LAYERS)
    serve_vs_teacher(f"vl {tc32.name}",
                     seeded_model(tc32, 1, dev, dtype=torch.float32), toks,
                     S_p, positions=pos3)
    return launches


def cross_bytes_per_frame(cache):
    """Bytes of cross K/V a frame of one batch row, over the layers."""
    return sum(c[n][0, 0].numel() * c[n].element_size()
               for c in cache for n in ("cross_k", "cross_v"))


def phase_encdec(dev):
    """(b) seamless-m4t-large-v2 and its 2x draft at full width and depth
    through the model API and training; (c) the refusals."""
    import dataclasses
    import torch
    from repro_torch import configs
    from repro_torch.bridge import seeded_model
    from repro_torch.core.engine import (EdgeCloudEngine,
                                         EncoderDecoderServingError,
                                         EngineConfig, MethodConfig)
    from repro_torch.kernels import sqs_fused as k
    from repro_torch.kernels.ops import pad_logits
    from repro_torch.launch import serve as serve_mod
    from repro_torch.launch import train as train_mod
    from repro_torch.models import frontend
    from repro_torch.models import model as model_mod
    t0 = time.perf_counter()
    tc = configs.get_config(ENCDEC_ARCH)
    dc = configs.draft_variant(tc, 2)
    tp = seeded_model(tc, 1, dev)
    dp = seeded_model(dc, 2, dev)
    torch.cuda.synchronize()
    n_t = sum(p.numel() for p in tp.parameters())
    n_d = sum(p.numel() for p in dp.parameters())
    print(f"phase 14 (b): {tc.name} ({tc.n_encoder_layers} encoder + "
          f"{tc.n_layers} decoder layers, d {tc.d_model}, {tc.n_heads} "
          f"heads of {tc.head_dim}, d_ff {tc.d_ff}, V {tc.vocab}; "
          f"{n_t / 1e9:.3f} B params) <- {dc.name} ({dc.n_encoder_layers} + "
          f"{dc.n_layers} layers, d {dc.d_model}; {n_d / 1e9:.3f} B params), "
          f"{tp.dtype} weights built in {time.perf_counter() - t0:.1f} s")
    gen = torch.Generator(device=dev).manual_seed(29)
    # the stub's frames, at each model's width
    frames = {c.d_model: frontend.audio_frame_embeds(gen, ENCDEC_BATCH,
                                                     ENC_LEN, c.d_model)
              for c in (tc, dc)}
    S = ENCDEC_PROMPT + N_DECODE + N_EXTEND
    toks = torch.randint(0, tc.vocab, (ENCDEC_BATCH, S), generator=gen,
                         device=dev)
    prompt = toks[:, :ENCDEC_PROMPT]
    for side, model in (("target", tp), ("draft", dp)):
        ms = []
        for _ in range(2):                       # the first call warms up
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            lg, cache = model_mod.prefill(
                model, prompt, cache_len=S,
                enc_embeds=frames[model.cfg.d_model])
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t1) * 1e3)
        per = cross_bytes_per_frame(cache)
        print(f"  {side}: encoder prefill (B {ENCDEC_BATCH} x {ENC_LEN} "
              f"frames, {ENCDEC_PROMPT} prompt tokens) {ms[1]:.2f} ms "
              f"({ms[0]:.2f} ms cold); cross cache {per} B a frame over "
              f"{len(cache)} layers, {per * ENCDEC_BATCH * ENC_LEN / 1e9:.3f}"
              f" GB at B {ENCDEC_BATCH}, {cache[0]['cross_k'].dtype}")
        check(bool(torch.isfinite(lg).all()),
              f"encdec {side}: prefill logits")
        check(per == CROSS_BYTES[side], f"encdec {side}: {per} B a frame")
        if side == "draft":
            draft_logits = lg
    del cache
    rise = serve_vs_teacher(f"encdec {tc.name}", tp, toks, ENCDEC_PROMPT,
                            enc_embeds=frames[tc.d_model],
                            measure_rise=True)
    one_layer = 2 * ENCDEC_BATCH * ENC_LEN * tc.n_kv_heads * tc.head_dim * 4
    print(f"  a decode step raises max_memory_allocated by at most "
          f"{rise / 1e6:.2f} MB; one layer's cross K/V in float32 is "
          f"{one_layer / 1e6:.1f} MB, the whole cross cache in float32 "
          f"{one_layer * tc.n_layers / 1e9:.2f} GB")
    check(rise < one_layer, f"encdec: a decode step allocated {rise} B, as "
          "much as a float32 copy of one layer's cross K/V")
    lp, V = pad_logits(draft_logits)
    C, L = k.plan_cluster(lp.shape[1])
    print(f"  SQS kernels at the draft's next-step logits: V {V}, Vp "
          f"{lp.shape[1]}, cluster plan C {C} blocks a row, L {L} entries a "
          f"block, {k.smem_bytes(C, L)} B of shared memory a block")
    check(C == 16, f"encdec: cluster plan C {C}, not 16 blocks a row")
    hold_sqs("encdec", "ksqs", lp, None)
    hold_sqs("encdec", "csqs", lp, torch.full(
        (lp.shape[0],), MethodConfig("csqs").beta0, device=dev))
    print("phase 14 (c): the engine refuses an encoder-decoder target or "
          "draft, in fixed batch and in slots; launch.serve exits 2")

    def decoder_only(cfg):
        return dataclasses.replace(
            configs.smoke_variant(cfg), name=cfg.name + "-decoder-smoke",
            family="dense", n_encoder_layers=0, frontend="none",
            vocab=cfg.vocab, dtype="bfloat16")
    for side in ("target", "draft"):
        if side == "target":
            d_cfg = decoder_only(dc)
            pair = (d_cfg, seeded_model(d_cfg, 3, dev), tc, tp)
        else:
            t_cfg = decoder_only(tc)
            pair = (dc, dp, t_cfg, seeded_model(t_cfg, 3, dev))
        eng = EdgeCloudEngine(*pair, MethodConfig("ksqs", K=64, ell=100),
                              EngineConfig(L_max=L_MAX), seed=0, device=dev)
        host_prompt = prompt.cpu().numpy()
        for label, call in (("fixed batch",
                             lambda: eng.run(host_prompt, 1)),
                            ("slots", lambda: eng.init_slots(SLOTS, 64))):
            try:
                call()
            except EncoderDecoderServingError as e:
                print(f"  {side} {ENCDEC_ARCH}, {label}: refused: {e}")
            else:
                raise CheckFailed(f"encdec {side} {label}: served")
    err = io.StringIO()
    try:
        with contextlib.redirect_stderr(err):
            serve_mod.main(["--arch", ENCDEC_ARCH, "--rounds", "1"])
    except SystemExit as e:
        check(e.code == 2, f"launch.serve exited {e.code}")
        print(f"  launch.serve --arch {ENCDEC_ARCH}: exit {e.code}, "
              f"{err.getvalue().strip().splitlines()[-1]}")
    else:
        raise CheckFailed("launch.serve served an encoder-decoder model")
    del tp, dp, eng, pair
    free_cuda()
    serve_vs_teacher(f"encdec {tc.name}",
                     seeded_model(tc, 1, dev, dtype=torch.float32), toks,
                     ENCDEC_PROMPT, enc_embeds=frames[tc.d_model])
    free_cuda()
    torch.cuda.reset_peak_memory_stats()
    B, S_train, steps = ENCDEC_TRAIN
    step_ms, make = [], train_mod.make_train_step

    def timed_make(*a, **kw):
        step = make(*a, **kw)

        def run(*args):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            out = step(*args)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t1) * 1e3)
            return out
        return run
    train_mod.make_train_step = timed_make
    try:
        hist = train_mod.main(["--arch", ENCDEC_ARCH, "--steps", str(steps),
                               "--batch", str(B), "--seq", str(S_train),
                               "--log-every", "1"])
    finally:
        train_mod.make_train_step = make
    peak = torch.cuda.max_memory_allocated()
    check(len(hist) == steps and all(math.isfinite(h["loss"])
                                     for h in hist),
          f"encdec train: {hist}")
    print(f"  launch.train, {steps} steps of {tc.name} at B {B} x S "
          f"{S_train} with 32 stub frames a row: losses "
          + " ".join(f"{h['loss']:.4f}" for h in hist)
          + "; step ms " + " ".join(f"{t:.1f}" for t in step_ms)
          + f"; peak {peak / 1e9:.2f} GB allocated, against 16 B a "
          f"parameter = {16 * n_t / 1e9:.2f} GB")


def phase_encdec_mrope(dev):
    """Phase 14, after the earlier models are freed.  Returns the SQS
    launches of the phase."""
    import torch
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    launches = phase_vl(dev)
    print(f"  phase 14 (a): {time.perf_counter() - t0:.1f} s; peak "
          f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB allocated")
    free_cuda()
    t1 = time.perf_counter()
    phase_encdec(dev)
    print(f"  phase 14 (b), (c): {time.perf_counter() - t1:.1f} s")
    print(f"  phase 14: {time.perf_counter() - t0:.1f} s; SQS launches "
          f"{launches}")
    return launches


# phase 15: the dry-run combos (arch, shape, levers, calibrated count),
# the largest dry-run peak that rank 0 runs for real on the card, the
# bound on measured / predicted memory, qwen2.5-3b's train peak with the
# vocab-parallel cross entropy (40 GiB; the reference records 33.1) and
# what xlstm's decode may move (0.25 GiB; the reference records 0.0)
TOOLING_COMBOS = (("qwen2.5-3b", "decode_32k", {}, False),
                  ("qwen2-moe-a2.7b", "prefill_32k",
                   {"shard_acts": True, "moe_groups": True}, False),
                  ("xlstm-1.3b", "long_500k", {}, False),
                  ("granite-3-8b", "train_4k", {}, False),
                  ("qwen2.5-3b", "train_4k", {}, False),
                  ("jamba-1.5-large-398b", "decode_32k", {}, False),
                  ("xlstm-1.3b", "prefill_32k", {}, True))
RANK0_MAX_PEAK = 70e9
RANK0_MEM_RATIO = (0.85, 1.15)
TRAIN_MAX_PEAK = 40 * 2**30
SSM_DECODE_MAX_COLL = 0.25 * 2**30
SSM_ARCHS = ("xlstm-1.3b", "jamba-1.5-large-398b")
DRY_RUN_WORKERS = 2


def start_dry_runs():
    """Phase 15 (a)'s dry runs, begun after phase 1 in DRY_RUN_WORKERS
    processes of their own: they trace on the host's CPU (fake tensors, a
    fake process group) while the card runs phases 2-14.  Returns (the
    pool, {(arch, shape): future of the record})."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    from repro_torch.launch import dryrun
    pool = ProcessPoolExecutor(
        DRY_RUN_WORKERS, mp_context=multiprocessing.get_context("spawn"))
    return pool, {(arch, shape): pool.submit(
        dryrun.run_combo, arch, shape, device="cuda",
        opts=dryrun.Options(**kw), calibrate=cal)
        for arch, shape, kw, cal in TOOLING_COMBOS}


def phase_tooling(dev, dry):
    """Phase 15: the dry run (``dry``: ``start_dry_runs``'s futures), rank
    0 for real, the two examples.  Returns the SQS launches of the
    quickstart."""
    import torch
    from repro_torch.kernels import sqs_fused as k
    from repro_torch.launch import dryrun
    t0 = time.perf_counter()
    print("phase 15 (a): dry run on the 16 x 16 production mesh (fake "
          "group of 256 ranks, fake cuda tensors; begun after phase 1 in "
          f"{DRY_RUN_WORKERS} worker processes)")
    recs = {}
    for arch, shape, kw, cal in TOOLING_COMBOS:
        rec = dry[(arch, shape)].result()
        check(rec["status"] == "ok", f"dry run {arch} {shape}: "
              f"{rec['status']} {rec.get('error', rec.get('reason'))}\n"
              f"{rec.get('traceback', '')}")
        m, c = rec["memory"], rec["collectives"]
        if cal:
            sc = rec["scan_calibration"]
            print(f"  {arch} x {shape}: calibrated count ("
                  f"{rec['calibration_status']}), {sc['n_units']} units "
                  "from traces of " + ", ".join(
                      f"{k} ({v['trace_s']} s)" for k, v in sc.items()
                      if isinstance(v, dict)) + ", the position loops' "
                  "trips multiplied; the peak extrapolated")
        print(f"  {arch} x {shape} {kw or ''}: peak "
              f"{m['peak_per_device'] / 1e9:.3f} GB a device (arguments "
              f"{m['argument_bytes'] / 1e9:.3f}, outputs "
              f"{m['output_bytes'] / 1e9:.3f}, temporaries "
              f"{m['temp_bytes'] / 1e9:.3f}); {rec['cost']['flops']:.6g} "
              f"FLOP, {rec['cost']['bytes accessed'] / 1e9:.3f} GB "
              f"accessed; collectives "
              f"{c['total_collective_bytes'] / 1e9:.4f} GB "
              + json.dumps({kd: [c['per_kind_count'][kd], v]
                            for kd, v in c['per_kind_bytes'].items()})
              + f" [count, bytes]; whole mixer gathers "
              f"{c['whole_mixer_gathers']}; trace {rec['trace_s']} s; "
              f"levers {rec['levers']}")
        if arch in SSM_ARCHS:
            check(c["whole_mixer_gathers"] == 0, f"dry run {arch} {shape}: "
                  f"{c['whole_mixer_gathers']} whole mixer gathers")
        if arch == "xlstm-1.3b" and shape != "prefill_32k":
            check(c["total_collective_bytes"] <= SSM_DECODE_MAX_COLL,
                  f"dry run {arch} {shape}: "
                  f"{c['total_collective_bytes'] / 2**30:.3f} GiB of "
                  "collectives")
        if (arch, shape) == ("qwen2.5-3b", "train_4k"):
            check(m["peak_per_device"] <= TRAIN_MAX_PEAK, f"dry run {arch} "
                  f"{shape}: peak {m['peak_per_device'] / 2**30:.2f} GiB")
        recs[(arch, shape)] = rec
    print(f"  phase 15 (a): waited {time.perf_counter() - t0:.1f} s for "
          "the dry runs")
    t1 = time.perf_counter()
    print("phase 15 (b): rank 0 of the same mesh for real on the card "
          "(collectives are no-ops: memory, FLOPs and shapes only)")
    n_real = 0
    for arch, shape, kw, cal in TOOLING_COMBOS:
        rec = recs[(arch, shape)]
        peak = rec["memory"]["peak_per_device"]
        if cal:
            print(f"  {arch} x {shape}: a calibrated count, not run")
            continue
        if peak > RANK0_MAX_PEAK:
            print(f"  {arch} x {shape}: dry-run peak {peak / 1e9:.3f} GB > "
                  f"{RANK0_MAX_PEAK / 1e9:.0f} GB, not run")
            continue
        free_cuda()
        r = dryrun.run_rank0(arch, shape, device="cuda",
                             opts=dryrun.Options(**kw), seed=15,
                             time_reps=2)
        ratio = r["mem_rise"] / peak
        print(f"  {arch} x {shape}: max_memory_allocated rise "
              f"{r['mem_rise'] / 1e9:.3f} GB against the dry run's "
              f"{peak / 1e9:.3f} GB (ratio {ratio:.4f}, bound "
              f"{RANK0_MEM_RATIO}); arguments allocated "
              f"{r['args_allocated'] / 1e9:.3f} GB against "
              f"{r['argument_bytes'] / 1e9:.3f}; FLOPs {r['flops']} against "
              f"{rec['cost']['flops']}; local step (compute without "
              f"communication) " + ", ".join(f"{t:.2f}" for t in r["ms"])
              + " ms")
        check(r["flops"] == rec["cost"]["flops"], f"rank 0 {arch} "
              f"{shape}: FLOPs {r['flops']} != dry run "
              f"{rec['cost']['flops']}")
        check(RANK0_MEM_RATIO[0] <= ratio <= RANK0_MEM_RATIO[1],
              f"rank 0 {arch} {shape}: memory ratio {ratio:.4f}")
        check(r["collectives"]["per_kind_count"]
              == rec["collectives"]["per_kind_count"],
              f"rank 0 {arch} {shape}: collectives "
              f"{r['collectives']['per_kind_count']} != dry run "
              f"{rec['collectives']['per_kind_count']}")
        check(r["collectives"]["whole_mixer_gathers"] == 0,
              f"rank 0 {arch} {shape}: whole mixer gathers")
        n_real += 1
    check(n_real > 0, "phase 15 (b) ran no combo")
    free_cuda()
    print(f"  phase 15 (b): {time.perf_counter() - t1:.1f} s")
    t2 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        # the train example runs as a child process beside the quickstart
        log = os.path.join(tmp, "train.log")
        with open(log, "w") as f:
            child = subprocess.Popen(
                [sys.executable, os.path.join(HERE, "examples",
                                              "torch_train_draft_slm.py"),
                 "--steps", "4", "--out", tmp],
                cwd=HERE, stdout=f, stderr=subprocess.STDOUT, text=True,
                env=dict(os.environ, PYTHONPATH=os.path.join(HERE, "src")))
        try:
            quick = load_example("torch_quickstart")
            for name in k.LAUNCHES:
                k.LAUNCHES[name] = 0
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                quick.main(["--device", "cuda"])
            launches = dict(k.LAUNCHES)
            print("phase 15 (c): examples/torch_quickstart.py\n  "
                  + out.getvalue().strip().replace("\n", "\n  "))
            check(all(launches[n] > 0 for n in ("sqs_fused",
                                                 "topk_threshold")),
                  f"the quickstart launched {launches}")
            check(all(m in out.getvalue() for m in ("K-SQS", "C-SQS")),
                  "quickstart output")
            rc = child.wait(timeout=600)
        finally:
            if child.poll() is None:
                child.kill()
                child.wait()
        with open(log) as f:
            text = f.read()
        check(rc == 0, f"torch_train_draft_slm.py exit {rc}: {text[-3000:]}")
        ckpts = sorted(f for f in os.listdir(tmp) if f.endswith(".npz"))
    print(f"  examples/torch_train_draft_slm.py --steps 4 (a child "
          f"process beside the quickstart): exit 0, {ckpts}; SQS launches "
          f"of the quickstart {launches}")
    print(f"  phase 15 (c): {time.perf_counter() - t2:.1f} s")
    print(f"  phase 15: {time.perf_counter() - t0:.1f} s")
    return launches


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
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
    dry_pool, dry = start_dry_runs()
    try:
        return run_phases(torch, t_start, smi, dry)
    finally:
        dry_pool.shutdown(cancel_futures=True)


def run_phases(torch, t_start, smi, dry):
    """Phases 2-16 and the closing lines."""
    phase_kernels()
    phase_kernels_vocabularies()
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
    replay_launches = phase_spec_replay(dev, tc, dc, tp, dp)
    for r in rows:
        r["launches"] += (serve_launches[r["name"]]
                          + replay_launches.get(r["name"], 0))
    rows += phase_served_pools(dev, tc, dc, tp, dp)
    phase_long_pool(dev, tc, rows)
    with tempfile.TemporaryDirectory() as tmp:
        tcp_launches = phase_tcp(dev, tc, dc, tp, dp, tmp)
    del tp, dp
    free_cuda()
    torch.cuda.reset_peak_memory_stats()
    moe_launches = phase_moe(dev)
    free_cuda()
    pair_launches = phase_pair(dev, smi)
    free_cuda()
    ssm_launches = phase_ssm(dev)
    check(all(n > 0 for n in ssm_launches.values()), "phase 12 never "
          f"launched a kernel: {ssm_launches}")
    free_cuda()
    mla_launches = phase_mla_window(dev)
    check(all(n > 0 for n in mla_launches.values()), "phase 13 never "
          f"launched a kernel: {mla_launches}")
    free_cuda()
    vl_launches = phase_encdec_mrope(dev)
    check(all(n > 0 for n in vl_launches.values()), "phase 14 never "
          f"launched a kernel: {vl_launches}")
    free_cuda()
    tool_launches = phase_tooling(dev, dry)
    for r in rows:
        r["launches"] += (tcp_launches.get(r["name"], 0)
                          + moe_launches.get(r["name"], 0)
                          + pair_launches.get(r["name"], 0)
                          + ssm_launches.get(r["name"], 0)
                          + mla_launches.get(r["name"], 0)
                          + vl_launches.get(r["name"], 0)
                          + tool_launches.get(r["name"], 0))
    print(f"chip_smoke: phases 1-16 in {time.perf_counter() - t_start:.1f} s")
    print(smi[0])
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
