"""Dual-clock span tracer with Chrome-trace-event (Perfetto) export (a
copy of ``repro.obs.trace``).

The serving stack runs on two kinds of time: the discrete-event
simulator's MODELED clock (``ServeSession`` / ``EventDrivenLoop``
virtual seconds) and the socket runner's WALL clock
(``time.perf_counter`` deltas in ``serve.net.EdgeClient``).  The
tracer maps each clock to its own Chrome-trace *process* (pid), so
Perfetto shows modeled round phases (draft / uplink / verify /
downlink) and measured spans side by side on independent timelines.

Design constraints, in order:

  * ZERO PERTURBATION — the tracer only ever receives caller-supplied
    timestamps and never reads a clock, an RNG or any token-affecting
    state itself.  Token streams are bit-identical with tracing on or
    off (tests/test_fuzz_serve.py sweeps exactly this).
  * near-zero cost disabled — every public method starts with one
    ``enabled`` check and allocates nothing when off.
  * deterministic ids — span ids and thread ids are monotone counters
    in emission/first-use order, so the same run produces the same
    trace byte for byte.

Export is the Chrome trace-event JSON format (the ``traceEvents``
array of ``"ph": "X"`` complete events plus ``"M"`` metadata naming
the processes/threads), which https://ui.perfetto.dev and
``chrome://tracing`` open directly.  Timestamps are microseconds.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional, Set, Tuple

__all__ = ["SpanTracer", "CLOCK_MODELED", "CLOCK_WALL",
           "span_names_by_clock"]

CLOCK_MODELED = "modeled"
CLOCK_WALL = "wall"
_CLOCK_PIDS = {CLOCK_MODELED: 1, CLOCK_WALL: 2}


class SpanTracer:
    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._events: List[dict] = []
        self._next_id = 0
        self._tids: Dict[Tuple[str, str], int] = {}
        self._stacks: Dict[Tuple[str, str], List[dict]] = {}
        self._named_pids: Set[int] = set()

    # -- id plumbing ----------------------------------------------------
    def _pid(self, clock: str) -> int:
        pid = _CLOCK_PIDS.get(clock)
        if pid is None:
            raise ValueError(f"unknown clock {clock!r}: "
                             f"{sorted(_CLOCK_PIDS)}")
        if pid not in self._named_pids:
            self._named_pids.add(pid)
            self._events.append({
                "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
                "args": {"name": f"{clock} clock"}})
        return pid

    def _tid(self, clock: str, tid_name: str, pid: int) -> int:
        key = (clock, tid_name)
        tid = self._tids.get(key)
        if tid is None:
            tid = self._tids[key] = len(self._tids) + 1
            self._events.append({
                "name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
                "args": {"name": tid_name}})
        return tid

    # -- emission -------------------------------------------------------
    def span(self, name: str, t0_s: float, t1_s: float,
             clock: str = CLOCK_MODELED, tid: str = "main",
             args: Optional[dict] = None) -> int:
        """One complete span [t0_s, t1_s] (seconds on ``clock``).
        Returns the deterministic span id (-1 when disabled)."""
        if not self.enabled:
            return -1
        pid = self._pid(clock)
        sid = self._next_id
        self._next_id += 1
        ev = {"name": name, "ph": "X", "pid": pid,
              "tid": self._tid(clock, tid, pid),
              "ts": t0_s * 1e6, "dur": max(t1_s - t0_s, 0.0) * 1e6,
              "args": {"id": sid, **(args or {})}}
        self._events.append(ev)
        return sid

    def begin(self, name: str, t_s: float, clock: str = CLOCK_MODELED,
              tid: str = "main", args: Optional[dict] = None) -> int:
        """Open a nested span; close it with ``end`` on the same
        (clock, tid) lane.  Nesting is strict LIFO per lane."""
        if not self.enabled:
            return -1
        sid = self._next_id
        self._next_id += 1
        self._stacks.setdefault((clock, tid), []).append(
            {"name": name, "t0": t_s, "id": sid, "args": args})
        return sid

    def end(self, t_s: float, clock: str = CLOCK_MODELED,
            tid: str = "main", args: Optional[dict] = None) -> int:
        """Close the innermost open span on (clock, tid)."""
        if not self.enabled:
            return -1
        stack = self._stacks.get((clock, tid))
        assert stack, f"end() with no open span on {(clock, tid)}"
        top = stack.pop()
        pid = self._pid(clock)
        self._events.append({
            "name": top["name"], "ph": "X", "pid": pid,
            "tid": self._tid(clock, tid, pid),
            "ts": top["t0"] * 1e6,
            "dur": max(t_s - top["t0"], 0.0) * 1e6,
            "args": {"id": top["id"], **(top["args"] or {}),
                     **(args or {})}})
        return top["id"]

    def instant(self, name: str, t_s: float, clock: str = CLOCK_MODELED,
                tid: str = "main", args: Optional[dict] = None) -> int:
        """A zero-duration marker (speculation hit/miss/abort...)."""
        if not self.enabled:
            return -1
        pid = self._pid(clock)
        sid = self._next_id
        self._next_id += 1
        self._events.append({
            "name": name, "ph": "i", "s": "t", "pid": pid,
            "tid": self._tid(clock, tid, pid), "ts": t_s * 1e6,
            "args": {"id": sid, **(args or {})}})
        return sid

    # -- export ---------------------------------------------------------
    @property
    def n_events(self) -> int:
        return len(self._events)

    def chrome_trace(self) -> dict:
        assert not any(self._stacks.values()), \
            f"unclosed spans at export: {self._stacks}"
        return {"traceEvents": list(self._events),
                "displayTimeUnit": "ms"}

    def export(self, path: str):
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f, indent=1)


def span_names_by_clock(trace: dict) -> Dict[str, Set[str]]:
    """Span (and instant) names grouped by clock name, from an exported
    Chrome trace dict — what the [PASS-OBS] gate validates against."""
    pid_clock = {e["pid"]: e["args"]["name"].split()[0]
                 for e in trace.get("traceEvents", [])
                 if e.get("ph") == "M" and e.get("name") == "process_name"}
    out: Dict[str, Set[str]] = {}
    for e in trace.get("traceEvents", []):
        if e.get("ph") in ("X", "i"):
            out.setdefault(pid_clock.get(e["pid"], "?"), set()).add(
                e["name"])
    return out
