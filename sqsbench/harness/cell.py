"""One run of one cell: set-up, the measured window, the metrics the
cell's entries in ``BENCHMARK.json`` name, and the check that decides
``correct``.  Everything a cell needs is found by name: its
configuration file, its traffic file (``traffic/<traffic>.json``), its
limits (``limits/<workload>.json``), each metric's reader
(``metrics/<metric>.py``) and the configuration's plain reference
(``reference/<reference>.py``)."""
from __future__ import annotations

import contextlib
import dataclasses
import importlib
import importlib.util
import json
import pathlib
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from harness import fleet as fleet_mod
from harness import host, trace, traffic as traffic_mod, weights
from reference import check as check_mod

HERE = pathlib.Path(__file__).resolve().parents[1]      # the benchmark
ROOT = HERE.parent                                       # the checkout
WARMUP_ROUNDS = 2       # rounds after the fleet's admissions, before the window


def log(msg: str):
    print(msg, file=sys.stderr, flush=True)


def load_json(path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Run:
    """What a metric's reader reads."""
    workload: str
    pair: dict
    traffic: dict
    served: fleet_mod.Served
    setup_s: float
    red: Optional[Dict] = None         # the reduced trace (--trace 1)


def metric_reader(name: str):
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"sqsbench_metric_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metrics_for(bench: dict, workload: str, traced: bool) -> List[dict]:
    """The cell's end-to-end metrics (--trace 0) or per-layer metrics
    (--trace 1)."""
    group = bench["per_layer"] if traced else bench["end_to_end"]
    if not traced:
        return [m for m in group
                if "workloads" not in m or workload in m["workloads"]]
    reported = {m["name"] for m in metrics_for(bench, workload, False)}
    return [m for m in group
            if (workload in m["workloads"] if "workloads" in m
                else m["moves"] in reported)]


def _spans(engine, span):
    """Wrap the system's round stages in the benchmark's spans (traced
    runs only; the system is not edited)."""
    def wrap(obj, attr, name):
        fn = getattr(obj, attr)

        def inner(*a, **kw):
            with span(name):
                return fn(*a, **kw)
        setattr(obj, attr, inner)
    wrap(engine.edge, "_draft_round", "bench.edge.decode")
    wrap(engine.edge, "_build_batch", "bench.edge.payload")
    wrap(engine.cloud, "verify", "bench.cloud.verify")
    wrap(engine.cloud, "_verify_round", "bench.cloud.extend")
    wrap(engine.edge, "apply_verdicts_batch", "bench.edge.apply")


def build_engine(pair: dict, traffic: dict, models, seed: int, device):
    from repro_torch.core import channel, engine as eng_mod
    m, e, ln = traffic["method"], traffic["engine"], traffic["link"]
    method = eng_mod.MethodConfig(
        name=m["name"], K=m["K"], ell=m["ell"], alpha=m["alpha"],
        eta=m["eta"], beta0=m["beta0"],
        use_kernels=torch.device(device).type == "cuda")
    engine = eng_mod.EngineConfig(
        L_max=e["L_max"], bit_budget=e["bit_budget"],
        temperature=e["temperature"], wire_codec=e["wire_codec"],
        budget_model=e["budget_model"])
    ch = channel.ChannelConfig(
        uplink_bps=ln["uplink_bps"], downlink_bps=ln["downlink_bps"],
        rtt_s=ln["rtt_s"], per_msg_overhead_bits=ln["per_msg_overhead_bits"])
    ecfg = weights.model_config(pair["edge"])
    ccfg = weights.model_config(pair["cloud"])
    return eng_mod.EdgeCloudEngine(ecfg, models[0], ccfg, models[1], method,
                                   engine, ch, seed=seed % (2 ** 31),
                                   device=device)


def cache_len(traffic: dict) -> int:
    need = (traffic["prompt_tokens"]["max"] + traffic["output_tokens"]["max"]
            + traffic["engine"]["L_max"] + 1)
    return -(-need // 16) * 16


def sample(served: fleet_mod.Served, n: int, n_slots: int,
           seed: int) -> List:
    """Requests to check, drawn from the seed: the finished ones and those
    still in flight when the window closed (their rounds so far), one from
    each of n runs of consecutive slots, so the sample spans the batch,
    with the one served the most tokens in it."""
    done = served.finished + [lv for lv in served.live if lv.rounds]
    if not done:
        return []
    size = [sum(len(r[2]) for r in lv.rounds) for lv in done]
    longest = int(np.argmax(size))
    rng = np.random.default_rng([int(seed) % (2 ** 63), 11])
    pick = []
    for stratum in np.array_split(np.arange(n_slots), n):
        cand = [i for i, lv in enumerate(done) if lv.req.device in stratum]
        if not cand:
            continue
        pick.append(longest if longest in cand else
                    int(cand[rng.integers(len(cand))]))
    return [done[i] for i in pick]


def run_cell(bench: dict, workload: str, seed: int, seconds: float,
             traced: bool, device, t_start: float,
             pair: Optional[dict] = None, traffic: Optional[dict] = None,
             limits: Optional[dict] = None, control: bool = False) -> dict:
    """One run; returns the result line's fields.  ``pair``, ``traffic``
    and ``limits`` default to the cell's files.  ``control`` also reads
    the control's numbers (``control.py``; the benchmark's runs do not)."""
    cell = next(w for w in bench["workloads"] if w["name"] == workload)
    if pair is None:
        conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
        pair = load_json(ROOT / conf["file"])
    traffic = traffic or load_json(HERE / "traffic" / f"{cell['traffic']}.json")
    limits = limits or load_json(HERE / "limits" / f"{workload}.json")
    ref = importlib.import_module(f"reference.{pair['reference']}")
    cuda = torch.device(device).type == "cuda"
    torch.set_num_threads(host.HOST_THREADS)
    parts = {"start_s": time.perf_counter() - t_start}

    t = time.perf_counter()
    W = {role: weights.make(pair[role], ref.leaves(pair[role]), seed, i,
                            device)
         for i, role in enumerate(("edge", "cloud"))}
    models = (weights.build(pair["edge"], W["edge"]),
              weights.build(pair["cloud"], W["cloud"]))
    if cuda:
        torch.cuda.synchronize()
    parts["weights_s"] = time.perf_counter() - t

    t = time.perf_counter()
    if cuda:
        from repro_torch.kernels import sqs_fused
        sqs_fused.LIBRARY.load()
    parts["kernels_s"] = time.perf_counter() - t

    t = time.perf_counter()
    engine = build_engine(pair, traffic, models, seed, device)
    engine.init_slots(traffic["devices"], cache_len(traffic))
    fleet = traffic_mod.Fleet(traffic, pair["edge"]["vocab"], seed)
    parts["engine_s"] = time.perf_counter() - t
    prof = trace.profiler() if traced else None
    span = torch.profiler.record_function if traced else None
    if traced:
        _spans(engine, span)
    loop = fleet_mod.Loop(engine, fleet, traffic, device, span)

    t = time.perf_counter()
    loop.admit_all()
    parts["admissions_s"] = time.perf_counter() - t
    t = time.perf_counter()
    for _ in range(WARMUP_ROUNDS):
        loop.step()
    parts["warmup_s"] = time.perf_counter() - t
    setup_s = time.perf_counter() - t_start
    log("setup: " + ", ".join(f"{k} {v:.3f}" for k, v in parts.items())
        + f", total {setup_s:.3f} s")

    if cuda:
        torch.cuda.synchronize()
    before = host.snapshot()
    with (prof if prof is not None else contextlib.nullcontext()):
        window_s = loop.window(seconds)
    host_use = host.between(before, host.snapshot())
    memory_peak = torch.cuda.max_memory_allocated() if cuda else 0
    served = loop.result(window_s)
    rs = [r for r in served.rounds if r.in_window]
    live = max(sum(r.n_live for r in rs), 1)
    log(f"window: {window_s:.3f} s, {len(rs)} rounds, "
        f"{sum(r.admits for r in rs)} admissions, "
        f"{sum(r.tokens for r in rs)} tokens, mean K "
        f"{sum(r.k_sum for r in rs) / live:.1f}, "
        f"{sum(r.n_accept for r in rs)} of {live} drafts accepted")
    log(host.line(host_use))
    red = trace.reduce(prof) if traced else None
    del prof

    run = Run(workload, pair, traffic, served, setup_s, red)
    metrics = {}
    for m in metrics_for(bench, workload, traced):
        value = metric_reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    # free the system's state, then judge what it served
    chosen = sample(served, int(traffic["check"]["requests"]),
                    int(traffic["devices"]), seed)
    to_judge = [check_mod.Served(lv.req.prompt, lv.req.seed, lv.rounds)
                for lv in chosen]
    del loop, engine, models
    if cuda:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    judged = check_mod.judge(pair, W, traffic["method"], traffic["engine"],
                             to_judge, device, with_control=control) \
        if to_judge else {}
    readings = judged.get("system", {})
    log(f"check: {len(to_judge)} requests, "
        f"{readings.get('draft_steps', 0)} draft steps, "
        f"{readings.get('verify_rounds', 0)} rounds in "
        f"{time.perf_counter() - t:.3f} s")
    check = {name: {"value": readings.get(name), "limit": lim}
             for name, lim in limits.items()}
    correct = bool(to_judge) and all(
        c["value"] is not None and c["value"] <= c["limit"]
        for c in check.values())
    if not to_judge:
        log("no request was served a token: nothing to check")

    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": int(memory_peak)}
    out = {"correct": correct, "attempted": served.attempted, "failed": 0,
           "metrics": metrics, "device": dev}
    if traced and red:
        dev["busy_s"] = red["busy_s"]
        dev["window_s"] = red["window_s"]
        out["breakdown"] = trace.breakdown(red)
    if control:
        out["control"] = judged.get("control", {})
        out["readings"] = readings
    out["check"] = check
    for name, c in check.items():
        log(f"{name} {c['value']} limit {c['limit']}")
    return out

