"""Observability layer for the serving stack (mirrors ``repro.obs``).

    SpanTracer       — dual-clock (modeled + wall) span tracing with
                       Chrome-trace-event / Perfetto export (obs.trace)
    MetricsRegistry  — counters / gauges / fixed-bucket histograms with
                       deterministic snapshots (obs.metrics)
    DecompTracker    — online Theorem-1 rejection decomposition and
                       conformal coverage telemetry (obs.decomp)
    Obs              — the bundle threaded through ServeSession /
                       EventDrivenLoop / EdgeClient; ``NULL_OBS`` is the
                       shared disabled instance

Every instrument only reads caller-supplied host values: token streams
are bit-identical with observability on or off, over the simulator and
over sockets.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.obs.decomp import DecompTracker
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,
                                     MetricsRegistry, percentile,
                                     summary_stats)
from repro_torch.obs.trace import (CLOCK_MODELED, CLOCK_WALL, SpanTracer,
                                   span_names_by_clock)

__all__ = [
    "CLOCK_MODELED", "CLOCK_WALL", "Counter", "DecompTracker", "Gauge",
    "Histogram", "MetricsRegistry", "NULL_OBS", "Obs", "SpanTracer",
    "percentile", "snapshot_topology", "span_names_by_clock",
    "summary_stats",
]


class Obs:
    """Tracer + metrics + (optional) Theorem-1 decomposition, as one
    handle the serving loops thread through.  Construct with
    ``Obs.on()`` for everything enabled, or default-construct (or use
    ``NULL_OBS``) for the disabled bundle."""

    def __init__(self, tracer: Optional[SpanTracer] = None,
                 metrics: Optional[MetricsRegistry] = None,
                 decomp: Optional[DecompTracker] = None):
        self.tracer = tracer if tracer is not None \
            else SpanTracer(enabled=False)
        self.metrics = metrics if metrics is not None \
            else MetricsRegistry(enabled=False)
        self.decomp = decomp

    @classmethod
    def on(cls, decomp: Optional[DecompTracker] = None) -> "Obs":
        return cls(SpanTracer(enabled=True), MetricsRegistry(enabled=True),
                   decomp)

    @property
    def enabled(self) -> bool:
        return (self.tracer.enabled or self.metrics.enabled
                or self.decomp is not None)


NULL_OBS = Obs()


def snapshot_topology(metrics: MetricsRegistry, topo) -> None:
    """Fold a ``serve.cells.CellTopology``'s end-of-run link and
    scheduler state into the registry: per-cell uplink/downlink traffic
    + backlog, and per-cell admission/preemption counts."""
    if not metrics.enabled:
        return
    for cell in topo.cells:
        base = f"serve.cell{cell.cell_id}"
        for lname, link in (("uplink", cell.uplink),
                            ("downlink", cell.downlink)):
            metrics.counter(f"{base}.{lname}.msgs").inc(link.n_msgs)
            metrics.counter(f"{base}.{lname}.delayed_msgs").inc(
                link.n_delayed)
            metrics.gauge(f"{base}.{lname}.bits_total").set(
                link.bits_total)
            metrics.gauge(f"{base}.{lname}.peak_backlog_s").set(
                link.peak_backlog_s)
        sched = cell.sched
        metrics.counter(f"{base}.sched.submitted").inc(sched.n_submitted)
        metrics.counter(f"{base}.sched.admitted").inc(sched.n_admitted)
        metrics.counter(f"{base}.sched.rejected").inc(len(sched.rejected))
        metrics.counter(f"{base}.sched.preemptions").inc(
            sched.n_preemptions)
        metrics.gauge(f"{base}.sched.queue_depth").set(len(sched.waiting))
