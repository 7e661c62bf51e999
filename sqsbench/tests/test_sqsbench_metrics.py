"""Rates from totals, tails from all samples, and each cell's metric
list as BENCHMARK.json names it."""
import json
import pathlib

import numpy as np
import pytest

from harness import cell, fleet, readers, stats

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def rnd(in_window, stall, wall, link, active, tokens, **kw):
    base = dict(admits=0, admit_tokens=[], t_slm=0.1, t_llm=0.05, rows=active,
                positions=np.zeros(active), up_bits=100.0, n_live=active,
                n_accept=0, k_sum=0.0)
    base.update(kw)
    return fleet.Round(in_window=in_window, stall_s=stall, wall_s=wall,
                       link_s=link, active=active, tokens=tokens, **base)


def make_run(rounds, ttft=(), gaps=(), window_s=2.0):
    served = fleet.Served(rounds=rounds, finished=[], live=[],
                          window_s=window_s,
                          ttft_s=list(ttft), gaps_s=list(gaps), attempted=4)
    return cell.Run("w", {"edge": {"vocab": 512}, "cloud": {}},
                    {"engine": {"L_max": 4}}, served, 1.0)


def test_rates_are_totals_over_totals():
    rs = [rnd(False, 0.0, 9.0, 1.0, 4, 400),          # before the window
          rnd(True, 0.2, 0.5, 0.3, 4, 4),
          rnd(True, 0.0, 0.4, 0.2, 4, 8),
          rnd(True, 0.1, 0.6, 0.3, 2, 2)]
    run = make_run(rs)
    read = {n: cell.metric_reader(n) for n in
            ("tokens_per_s", "latency_per_token_ms", "wire_host_ms",
             "uplink_bits_per_token", "draft_accept_share", "admit_ms.chat")}
    assert read["tokens_per_s"](run) == pytest.approx(14 / 2.0)
    cost = 1.0 * 4 + 0.6 * 4 + 1.0 * 2
    assert read["latency_per_token_ms"](run) == pytest.approx(1000 * cost / 14)
    assert read["wire_host_ms"](run) == pytest.approx(
        1000 * ((0.5 + 0.4 + 0.6) - 3 * 0.15) / 3)
    assert read["uplink_bits_per_token"](run) == pytest.approx(300 / 14)
    assert read["draft_accept_share"](run) == 0.0
    assert read["admit_ms.chat"](run) is None           # no admission: nothing


def test_tails_take_every_sample():
    gaps = list(np.linspace(0.1, 1.0, 100)) + [5.0] * 3
    run = make_run([rnd(True, 0, 1, 0, 1, 1)], ttft=[0.5, 0.7], gaps=gaps)
    got = cell.metric_reader("token_gap_p95_ms.chat")(run)
    assert got == pytest.approx(1000 * np.percentile(gaps, 95))
    assert cell.metric_reader("ttft_p95_ms.chat")(run) == pytest.approx(
        1000 * np.percentile([0.5, 0.7], 95))
    assert stats.p95([]) is None


def test_trace_readers_need_a_trace():
    run = make_run([rnd(True, 0, 1, 0, 1, 1)])
    for name in ("mfu", "device_idle_share", "sqs_fused_roofline",
                 "topk_threshold_roofline"):
        assert cell.metric_reader(name)(run) is None


@pytest.mark.parametrize("w", [w["name"] for w in BENCH["workloads"]])
def test_every_metric_has_a_reader_and_every_cell_its_metrics(w):
    e2e = cell.metrics_for(BENCH, w, False)
    layer = cell.metrics_for(BENCH, w, True)
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2 and layer
    for m in e2e + layer:
        assert callable(cell.metric_reader(m["name"]))
    for m in layer:
        assert m["moves"] in names


def test_kernel_roofline_from_the_trace():
    run = make_run([rnd(True, 0, 1, 0, 8, 8, rows=8)])
    run.red = {"window_s": 1.0, "busy_s": 0.25,
               "kernels": {"void sqs_fused_kernel<8>(float*)": (2e-3, 10)},
               "idle": {}}
    nbytes = 10 * 12 * 8 * 512
    assert readers.kernel_roofline(run, "sqs_fused_kernel", 12.0) == \
        pytest.approx(100 * nbytes / 3.35e12 / 2e-3)
    assert readers.kernel_roofline(run, "topk_threshold_kernel", 4.0) is None
    assert cell.metric_reader("device_idle_share")(run) == pytest.approx(75.0)


def test_trace_reduction_counts_operations_not_span_annotations():
    """The device's busy time is the union of its operations inside the
    window; a span's mirror on the device's timeline is no operation, and
    each idle gap is charged to the innermost span the host was in at its
    middle."""
    from harness import trace
    ms = 1_000_000
    evs = [(0, 100 * ms, "bench.window", False),
           (0, 100 * ms, "bench.window", True),         # annotation
           (10 * ms, 60 * ms, "bench.round", False),
           (10 * ms, 60 * ms, "bench.round", True),     # annotation
           (60 * ms, 90 * ms, "bench.admit", False),
           (10 * ms, 20 * ms, "gemm", True),
           (15 * ms, 30 * ms, "Memcpy HtoD (Pageable -> Device)", True),
           (40 * ms, 50 * ms, "gemm", True),
           (95 * ms, 120 * ms, "tail", True)]           # cut at the window
    red = trace.reduce_events(evs)
    assert red["window_s"] == pytest.approx(0.1)
    assert red["busy_s"] == pytest.approx(0.035)
    assert red["kernels"]["gemm"] == (pytest.approx(0.02), 2)
    assert "bench.round" not in red["kernels"]
    assert red["idle"] == {"host.other": pytest.approx(0.01),
                           "bench.round": pytest.approx(0.01),
                           "bench.admit": pytest.approx(0.045)}
    out = trace.breakdown(red)
    assert out["device_ops"][0][0] == "gemm" and len(out["idle_gaps"]) <= 10
