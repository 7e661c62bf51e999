"""The host side of a run: how many threads it keeps, and how busy its
own process was over the window (``getrusage``), printed on standard
error beside the window's rounds.  The loop dispatches every launch from
one thread; a run whose process was busy for nearly all of the window
was paced by the speed of that core, one that was not by waiting."""
from __future__ import annotations

import os
import resource
import time
from typing import Dict

HOST_THREADS = 1    # torch's intra-op threads and the OMP / MKL pools


def snapshot() -> dict:
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return {"t": time.perf_counter(), "utime": ru.ru_utime,
            "stime": ru.ru_stime}


def between(a: dict, b: dict) -> Dict[str, float]:
    """This process's CPU time from snapshot ``a`` to ``b``, as shares of
    the wall time between them (above 1 where several threads ran)."""
    wall = max(b["t"] - a["t"], 1e-9)
    return {"proc_cpu_per_wall": (b["utime"] - a["utime"]
                                  + b["stime"] - a["stime"]) / wall,
            "proc_sys_per_wall": (b["stime"] - a["stime"]) / wall,
            "cores": len(os.sched_getaffinity(0))}


def line(d: Dict[str, float]) -> str:
    return "host: " + ", ".join(
        f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
        for k, v in d.items())
