"""Shared arithmetic of the metric readers (``metrics/<name>.py``): each
reader takes the run (``harness.cell.Run``) and returns a number, or None
where its cell gives it nothing to read."""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from harness import roofline, stats, trace


def window_rounds(run) -> List:
    return [r for r in run.served.rounds if r.in_window]


def tokens(run) -> int:
    return sum(r.tokens for r in window_rounds(run))


def per_round_ms(run, field) -> Optional[float]:
    rs = window_rounds(run)
    return stats.ratio(1000.0 * sum(field(r) for r in rs), len(rs))


def admit_ms(run) -> Optional[float]:
    rs = window_rounds(run)
    return stats.ratio(1000.0 * sum(r.stall_s for r in rs),
                       sum(r.admits for r in rs))


def tail_ms(samples) -> Optional[float]:
    v = stats.p95(samples)
    return None if v is None else 1000.0 * v


def kernel_roofline(run, needle: str, bytes_per_entry: float):
    if not run.red:
        return None
    seconds, launches = trace.kernel_time(run.red, needle)
    rows = window_rounds(run)[0].rows if window_rounds(run) else 0
    nbytes = launches * bytes_per_entry * rows * roofline.padded_vocab(
        run.pair["edge"]["vocab"])
    return roofline.bytes_roofline_pct(nbytes, seconds)


def window_flops(run) -> float:
    """The FLOPs the window's work needs (``harness.roofline``)."""
    e, c = run.pair["edge"], run.pair["cloud"]
    L = run.traffic["engine"]["L_max"]
    total = 0.0
    for r in window_rounds(run):
        for S in r.admit_tokens:
            total += roofline.prefill_flops(e, S - 1) + \
                roofline.prefill_flops(c, S - 1)
        pos = np.asarray(r.positions, np.float64)
        n = len(pos)
        if not n:
            continue
        ctx = float(pos.mean()) + 1.0 + L / 2.0     # mean over the L+1 steps
        total += roofline.step_flops(e, n, L + 1, ctx)
        total += roofline.step_flops(c, n, L + 1, ctx)
    return total
