"""The traced run: ``torch.profiler`` over the measured window, reduced to
the device's busy time, the time of each kernel by name, and the idle
gaps between device operations, each charged to the innermost span of
the benchmark's own that the host was in (``bench.*``)."""
from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Tuple

import torch

WINDOW = "bench.window"


def profiler():
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                   record_shapes=False, with_stack=False,
                   profile_memory=False)


def _ns(e, what: str) -> int:
    f = getattr(e, f"{what}_ns", None)
    return int(f()) if f else int(getattr(e, f"{what}_us")() * 1000)


def _merge(iv: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def events(prof) -> List[Tuple[int, int, str, bool]]:
    """(start ns, end ns, name, on the device) of every profiled event."""
    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for e in prof.profiler.kineto_results.events():
        start = _ns(e, "start")
        out.append((start, start + _ns(e, "duration"), e.name(),
                    e.device_type() == cuda))
    return out


def reduce(prof) -> Dict:
    return reduce_events(events(prof))


def reduce_events(evs: List[Tuple[int, int, str, bool]]) -> Dict:
    """busy_s, window_s, per-kernel (seconds, launches), the device ops that
    took most time, and idle seconds by host span.  The profiler mirrors
    each span onto the device's timeline as an annotation, which is no
    operation: only the host's copy of a ``bench.`` span counts."""
    spans, dev = [], []
    for start, end, name, on_device in evs:
        if not name.startswith("bench."):
            if on_device:
                dev.append((start, end, name))
        elif not on_device:
            spans.append((start, end, name))
    win = [s for s in spans if s[2] == WINDOW]
    if not win or not dev:
        return {}
    w0, w1 = win[0][0], win[0][1]
    kernels: Dict[str, list] = defaultdict(lambda: [0.0, 0])
    iv = []
    for a, b, name in dev:
        a, b = max(a, w0), min(b, w1)
        if b <= a:
            continue
        iv.append((a, b))
        kernels[name][0] += (b - a) / 1e9
        kernels[name][1] += 1
    busy = _merge(iv)
    busy_s = sum(b - a for a, b in busy) / 1e9
    # idle gaps, charged to the innermost bench span around their middle
    inner = sorted((s for s in spans if s[2] != WINDOW), key=lambda s: s[0])
    starts = [s[0] for s in inner]
    idle: Dict[str, float] = defaultdict(float)
    edges = [w0] + [x for ab in busy for x in ab] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) // 2
        best = None
        i = bisect.bisect_right(starts, mid)
        for s in reversed(inner[max(0, i - 64):i]):
            if s[1] >= mid and (best is None or s[1] - s[0] < best[1] - best[0]):
                best = s
        idle[best[2] if best else "host.other"] += (b - a) / 1e9
    return {"busy_s": busy_s, "window_s": (w1 - w0) / 1e9,
            "kernels": {k: tuple(v) for k, v in kernels.items()},
            "idle": dict(idle)}


def kernel_time(red: Dict, needle: str) -> Tuple[float, int]:
    """Seconds and launches of the kernels whose name holds ``needle``."""
    s, n = 0.0, 0
    for name, (t, c) in red.get("kernels", {}).items():
        if needle in name:
            s += t
            n += c
    return s, n


def breakdown(red: Dict) -> Dict:
    ops = sorted(red["kernels"].items(), key=lambda kv: -kv[1][0])[:10]
    gaps = sorted(red["idle"].items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n, t] for n, (t, _) in ops],
            "idle_gaps": [[n, t] for n, t in gaps]}
