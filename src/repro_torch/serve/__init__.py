"""Continuous-batching serving layer (mirrors ``repro.serve``).

    Request / RequestState     — request lifecycle (serve.request)
    Scheduler, SchedulerConfig — admission/eviction, slot packing
    Cell, CellTopology         — multi-cell topology (serve.cells):
                                 per-cell uplink/downlink/scheduler,
                                 one cloud verifier
    ServeSession, ServeConfig  — serving loop, contended-link clock
    EventDrivenLoop, EventQueue— pipelined schedule (serve.events)
    RoundStateMachine          — clock-free round logic of the loops
    ServeReport                — throughput / latency-percentile report
    TraceConfig, poisson_trace — seeded per-cell Poisson workloads
    CloudServer, EdgeClient    — two-process serving over real TCP
                                 (serve.net), the simulator as oracle
"""
from repro_torch.serve.cells import Cell, CellTopology
from repro_torch.serve.events import (EventDrivenLoop, EventQueue,
                                      RoundStateMachine, VerdictOutcome)
from repro_torch.serve.net import CloudServer, EdgeClient, NetReport
from repro_torch.serve.request import Request, RequestState
from repro_torch.serve.scheduler import Scheduler, SchedulerConfig
from repro_torch.serve.session import ServeConfig, ServeReport, ServeSession
from repro_torch.serve.trace import TraceConfig, poisson_trace

__all__ = [
    "Cell", "CellTopology", "CloudServer", "EdgeClient", "EventDrivenLoop",
    "EventQueue", "NetReport", "Request", "RequestState",
    "RoundStateMachine", "Scheduler", "SchedulerConfig", "ServeConfig",
    "ServeReport", "ServeSession", "TraceConfig", "VerdictOutcome",
    "poisson_trace",
]
