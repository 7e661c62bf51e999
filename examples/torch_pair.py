"""The trained draft/target pair, one engine sweep and the Fig. 2 crossover
for the examples of the PyTorch/CUDA port (the port's copy of what
``examples/edge_cloud_serve.py`` and ``examples/temperature_crossover.py``
take from ``benchmarks/common.py`` and ``benchmarks/fig2_temperature.py``).

The pair mirrors the paper's GPT-Neo-125M -> GPT-Neo-1.3B setup at smoke
scale: same-family models with a 2x capacity gap, trained on the seeded
synthetic Zipf-Markov corpus until a real draft/target mismatch exists.
Imports ``torch`` and ``repro_torch`` only.
"""
from __future__ import annotations

import os

import torch

from repro_torch import configs, resolve_device
from repro_torch.bridge import from_jax, seeded_model, to_jax_tree
from repro_torch.core.channel import ChannelConfig
from repro_torch.core.engine import (EdgeCloudEngine, EngineConfig,
                                     MethodConfig, summarize)
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.train import checkpoint
from repro_torch.train.optimizer import AdamWConfig, init_state
from repro_torch.train.trainer import make_train_step, parameters

CACHE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "experiments", "cache")
BENCH_STEPS = 500
BENCH_ROUNDS = 12
# constrained edge uplink (paper §1 motivation): bits must matter
BENCH_UPLINK_BPS = 2e5
# Fig. 2: the sampling temperatures and the two methods
TEMPS = [0.2, 0.5, 0.8, 1.0, 1.3]
KEYS = ["method", "temperature", "latency_per_batch_s", "resampling_rate",
        "accept_rate", "bits_per_batch", "mean_K", "tokens_per_batch"]


def _train(cfg, steps, seed, data, device):
    model = seeded_model(cfg, seed, device, trainable=True)
    step = make_train_step(cfg, AdamWConfig(lr=2e-3, warmup_steps=10,
                                            total_steps=steps))
    state = init_state(parameters(model))
    for b in data.batches(steps):
        _, state, m = step(model, state,
                           {"tokens": torch.from_numpy(b["tokens"])
                            .to(device)})
    return to_jax_tree(model), float(m["ce"])


def trained_pair(arch: str = "gptneo-1.3b", steps: int = BENCH_STEPS,
                 device="cuda", cache: str = CACHE):
    """Returns (draft_cfg, draft_model, target_cfg, target_model, data):
    the smoke variant of ``arch`` and its 2x draft, trained for ``steps``
    (target, seed 1) and max(steps // 2, 30) (draft, seed 2) steps on one
    corpus stream.  Checkpoints are cached under ``cache`` by (arch,
    steps), in names of their own (``torch-...``)."""
    device = resolve_device(device)
    tc = configs.smoke_variant(configs.get_config(arch))
    dc = configs.draft_variant(tc, 2)
    # strongly structured corpus: trained pairs reach the high per-token
    # acceptance regime where the paper's K / beta dynamics are visible
    data = SyntheticLM(DataConfig(vocab=tc.vocab, seq_len=48, batch=16,
                                  p_bigram=0.85, jitter=2, seed=5))
    tpath = os.path.join(cache, f"torch-{arch}-target-{steps}.npz")
    dpath = os.path.join(cache, f"torch-{arch}-draft-{steps}.npz")
    if os.path.exists(tpath) and os.path.exists(dpath):
        ttree, dtree = checkpoint.load(tpath), checkpoint.load(dpath)
    else:
        ttree, tce = _train(tc, steps, 1, data, device)
        dtree, dce = _train(dc, max(steps // 2, 30), 2, data, device)
        checkpoint.save(tpath, ttree, meta={"ce": tce})
        checkpoint.save(dpath, dtree, meta={"ce": dce})
    return (dc, from_jax(dtree, dc, device), tc, from_jax(ttree, tc, device),
            data)


def run_engine(dc, dp, tc, tp, data, *, method: MethodConfig,
               temperature: float, L_max: int = 6,
               bit_budget: float = 5000.0, rounds: int = BENCH_ROUNDS,
               batch: int = 2, warmup: int = 2, seed: int = 0,
               collect_theory: bool = False,
               channel: ChannelConfig = None):
    """One engine sweep on the pair's device: ``rounds + warmup`` rounds
    on ``batch`` prompts of 8 tokens from ``data``; the first ``warmup``
    rounds are dropped.  Returns (rounds, summary)."""
    if channel is None:
        channel = ChannelConfig(uplink_bps=BENCH_UPLINK_BPS)
    eng = EdgeCloudEngine(
        dc, dp, tc, tp, method,
        EngineConfig(L_max=L_max, bit_budget=bit_budget,
                     temperature=temperature,
                     collect_theory=collect_theory),
        channel, seed=seed, device=next(tp.parameters()).device)
    prompts = data.sample(batch, 9)[:, :-1]
    all_rounds, _ = eng.run(prompts, rounds + warmup)
    return all_rounds[warmup:], summarize(all_rounds[warmup:])


def crossover(pair, *, rounds: int = BENCH_ROUNDS, batch: int = 2,
              use_kernels: bool = True, collect_theory: bool = False):
    """Fig. 2 on a pair (``trained_pair``'s tuple): K-SQS at K 16 and
    C-SQS at alpha 5e-4, eta 1e-3 (both at l 100) at each of TEMPS, on the
    fused SQS kernels or, with ``use_kernels=False``, plain torch.
    Returns (rows, runs): one row of KEYS a method and temperature, in
    that order, and runs[(method, T)] the per-round metrics of that sweep
    (with dense q when ``collect_theory``)."""
    dc, dp, tc, tp, data = pair
    rows, runs = [], {}
    for method in (MethodConfig("ksqs", K=16, ell=100,
                                use_kernels=use_kernels),
                   MethodConfig("csqs", ell=100, alpha=5e-4, eta=1e-3,
                                use_kernels=use_kernels)):
        for T in TEMPS:
            rs, s = run_engine(dc, dp, tc, tp, data, method=method,
                               temperature=T, rounds=rounds, batch=batch,
                               collect_theory=collect_theory)
            rows.append({"method": method.name, "temperature": T,
                         **{k: s[k] for k in KEYS[2:]}})
            runs[(method.name, T)] = rs
    return rows, runs


def winners(rows):
    """{T: (K-SQS row, C-SQS row, winner)}: the method of lower latency
    per batch wins, as in examples/temperature_crossover.py."""
    by = {}
    for r in rows:
        by.setdefault(r["temperature"], {})[r["method"]] = r
    return {T: (m["ksqs"], m["csqs"],
                "K-SQS" if m["ksqs"]["latency_per_batch_s"]
                < m["csqs"]["latency_per_batch_s"] else "C-SQS")
            for T, m in sorted(by.items())}
