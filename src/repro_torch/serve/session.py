"""Continuous-batching serving loop over the slot-level engine API
(mirrors ``repro.serve.session``).

Two schedules behind one config (``ServeConfig.pipeline``):

  lockstep   — the global-barrier loop in this module (below);
  pipelined  — the event-driven loop in ``serve.events``: edge
               drafting, uplink serialisation, cloud verification and
               downlink feedback overlap across requests, and each edge
               speculatively drafts its next round while its verdict is
               in flight.  Token streams are bit-identical to lockstep;
               only the clock (and therefore every latency metric)
               differs.

In BOTH schedules the uplink is charged with the PACKED DraftPayload
bytes (``core.wire``) — ``len(pack(p)) * 8`` — and the downlink with the
packed VerdictPayload, not with the analytic formulas of ``core.bits``
(those remain the edge's budget estimate for choosing L^t).

``ServeSession`` owns the virtual serving clock.  Per lockstep
iteration:

  1. release arrivals whose t_arrival <= now into the scheduler
     (admission control may reject);
  2. scheduling tick: admitted requests are prefilled into engine slots
     (continuous policy refills mid-flight; static waits for the batch
     to drain);
  3. one SD round over the active slots;
  4. clock accounting: edge drafting runs in parallel on every edge
     device (max t_slm), then each live request's payload queues FIFO on
     the SHARED uplink (core.channel.SharedUplink) — per-request
     head-of-line waits are charged to the request — then one batched
     cloud verify + the downlink feedback broadcast;
  5. EOS/length completions are evicted, freeing their slots for the
     next tick.

When no request is active the clock jumps to the next arrival (the
server idles).  The loop ends when the trace is drained.

Multi-cell topology (``n_cells > 1``): the engine's slots are
partitioned among radio cells (serve.cells.CellTopology) — each cell
has its OWN SharedUplink, its own broadcast SharedDownlink, and its own
admission/preemption scheduler, while ONE cloud verify engine batches
verify calls across every cell.  Per round, each cell's live payloads
serialise FIFO on that cell's uplink (cells transmit in parallel), the
barrier is the slowest cell's last arrival, and the verdicts return on
each cell's downlink — per-verdict (each paying the per-message framing
overhead) or, with ``verdict_batch=True``, coalesced into ONE coded
frame per cell per round (wire.pack_verdict_batch, codec negotiated
per link like the draft codec).  Cells move bytes and clocks only:
per-request token streams are bit-identical to the single-cell
reference for every topology × schedule × codec combination.

Paged KV serving (``page_size > 0``): the engine's caches become a
shared page pool (core.pages.PageAllocator) and admission is gated by
FREE PAGES, not free slots — ``max_batch`` can exceed what dense
per-slot caches would allow because short requests only hold the pages
they actually use.  Before every round the active slots' draft windows
are grown; on pool exhaustion the most recently admitted request is
preempted (pages freed, re-queued at the front — its deterministic RNG
re-emits the same tokens) until the round fits.  ``ServeReport`` gains
n_preempted / peak_active / peak_pages_in_use for the load study.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.engine import EdgeCloudEngine
from repro_torch.obs import NULL_OBS, Obs, percentile, snapshot_topology
from repro_torch.serve.cells import CellTopology
from repro_torch.serve.request import Request


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    max_batch: int = 4
    queue_cap: int = 64
    policy: str = "continuous"      # continuous | static
    cache_len: int = 256            # per-REQUEST KV capacity ceiling
    max_rounds: int = 100_000       # safety valve for the replay loop
    # Serving schedule: "lockstep" is the global-barrier loop below
    # (draft ∥, transmit, one batched verify, broadcast); "pipelined"
    # is the event-driven overlap of serve.events — same token streams
    # bit for bit, different clock.
    pipeline: str = "lockstep"      # lockstep | pipelined
    speculate: bool = True          # pipelined: optimistic continuation
    # Cell topology: n_cells radio cells partition the engine's slots,
    # each behind its own shared uplink + broadcast downlink, all
    # feeding the one cloud verifier.  verdict_batch coalesces each
    # cell's verdicts into one coded downlink frame per verify batch
    # (amortising per-message framing — the lever in downlink-limited
    # regimes); off, every verdict is its own framed downlink message.
    n_cells: int = 1
    verdict_batch: bool = False
    # Paged KV pool: page_size > 0 switches eligible attention layers to
    # a shared page pool; admission is then by free pages.  n_pages None
    # defaults to max_batch * ceil(cache_len / page_size) (the dense
    # footprint); set it LOWER to serve more slots than dense caches
    # could back — the whole point of paging.
    page_size: int = 0
    n_pages: Optional[int] = None
    # Fixed per-round compute costs for the serving clock (seconds).
    # None: use the engine's measured wall-clock per round.  Setting both
    # turns the replay into a deterministic discrete-event simulation —
    # required when COMPARING scheduler policies, where host timing noise
    # would otherwise dominate the makespan difference.
    t_slm_s: Optional[float] = None
    t_llm_s: Optional[float] = None


@dataclasses.dataclass
class ServeReport:
    policy: str
    n_requests: int
    n_finished: int
    n_rejected: int
    makespan_s: float
    total_tokens: int
    throughput_tok_s: float
    latency_p50_s: float
    latency_p90_s: float
    latency_p95_s: float
    latency_p99_s: float
    ttft_mean_s: float
    queue_wait_mean_s: float
    uplink_wait_mean_s: float
    uplink_utilization: float
    rejection_rate: float
    n_rounds: int
    # paged-KV load metrics (zeros in dense mode)
    n_preempted: int = 0
    peak_active: int = 0
    page_size: int = 0
    n_pages: int = 0
    peak_pages_in_use: int = 0
    # schedule + wire metrics (pipelined serving)
    pipeline: str = "lockstep"
    latency_mean_s: float = float("nan")
    n_spec_hits: int = 0
    n_spec_misses: int = 0
    # cell topology + downlink metrics (multi-cell serving).  Utilization
    # aggregates are means over cells (a cell with no traffic reports
    # 0.0, never NaN); bits totals include per-message framing, so
    # verdict batching shows up as a strict reduction.
    n_cells: int = 1
    verdict_batch: bool = False
    downlink_utilization: float = 0.0
    downlink_bits_total: float = 0.0
    downlink_msgs: int = 0
    uplink_bits_total: float = 0.0
    cell_uplink_utilization: List[float] = dataclasses.field(
        default_factory=list)
    cell_downlink_utilization: List[float] = dataclasses.field(
        default_factory=list)
    requests: List[Request] = dataclasses.field(default_factory=list,
                                                repr=False)

    def summary(self) -> Dict[str, float]:
        # not asdict(): that would deep-copy every Request (prompt
        # arrays, token lists) just to drop them
        return {f.name: getattr(self, f.name)
                for f in dataclasses.fields(self) if f.name != "requests"}


class ServeSession:
    def __init__(self, engine: EdgeCloudEngine, cfg: ServeConfig,
                 obs: Optional[Obs] = None):
        assert cfg.pipeline in ("lockstep", "pipelined"), cfg.pipeline
        self.engine = engine
        self.cfg = cfg
        # observability is read-only over the serving state: spans and
        # counters never feed back into scheduling or tokens (NULL_OBS =
        # everything disabled)
        self.obs = obs if obs is not None else NULL_OBS
        self.n_spec_hits = 0
        self.n_spec_misses = 0
        # the topology IS the scheduler: one cell degenerates to the
        # classic single-scheduler single-uplink serving layer
        self.topo = CellTopology(cfg.n_cells, cfg.max_batch,
                                 cfg.queue_cap, cfg.policy, engine.ch)
        self.sched = self.topo
        self.now = 0.0
        self.n_rounds = 0
        self.peak_active = 0
        self.paged = cfg.page_size > 0
        if self.paged:
            # per-request capacity ceiling, rounded up to whole pages
            # (also what makes paged == contiguous bit-identical: both
            # layouts see the same masked cache width)
            ps = cfg.page_size
            self.cache_len = -(-cfg.cache_len // ps) * ps
            engine.init_slots(cfg.max_batch, self.cache_len,
                              page_size=ps, n_pages=cfg.n_pages)
        else:
            self.cache_len = cfg.cache_len
            engine.init_slots(cfg.max_batch, cfg.cache_len)

    # ------------------------------------------------------------------
    def _cache_need(self, req: Request) -> int:
        """Worst-case per-request cache footprint: prompt + generated
        tokens + one full draft window beyond the last accepted
        position."""
        return (int(req.prompt.shape[0]) + req.max_new_tokens
                + self.engine.e.L_max + 1)

    def _admit_arrivals(self, pending: List[Request]):
        """Move trace arrivals with t_arrival <= now into the scheduler.
        A request that could never fit its per-request capacity (or, in
        paged mode, the whole pool) is REJECTED at arrival — one bad
        request must not abort the replay for everyone else."""
        while pending and pending[0].t_arrival <= self.now:
            req = pending.pop(0)
            if self._cache_need(req) > self.cache_len:
                self.sched.reject(req)
                continue
            self.sched.submit(req, self.now)

    def _page_gate(self):
        """Paged admission gate: enough free pages for the prompt plus
        one draft window.  Deliberately NOT the worst case — memory is
        oversubscribed and preemption is the backstop, which is how the
        pool serves more concurrent requests than dense slots could.

        Pages are only CONSUMED when ``_schedule_tick`` later calls
        ``admit_slot``, so within one tick the gate must account for the
        admissions it already approved: it reserves each one's prefill
        need (<= the window need it was gated on), which guarantees
        every approved ``admit_slot`` succeeds."""
        eng = self.engine
        reserved = [0]

        def gate(req: Request) -> bool:
            S0 = int(req.prompt.shape[0])
            window_need = eng.pages_needed(S0 + eng.e.L_max + 1)
            if eng.free_pages() - reserved[0] < window_need:
                return False
            reserved[0] += eng.pages_needed(S0 - 1)   # consumed at admit
            return True

        return gate

    def _schedule_tick(self):
        gate = self._page_gate() if self.paged else None
        for slot, req in self.sched.schedule(self.now, can_admit=gate):
            assert self._cache_need(req) <= self.cache_len, \
                f"request {req.rid} exceeds cache_len {self.cache_len}"
            self.engine.admit_slot(slot, req.prompt, req.seed,
                                   wire_codec=req.wire_codec)

    def _grow_or_preempt(self):
        """Grow every active slot's draft window; on pool exhaustion
        preempt the most recently admitted request (LIFO — it has the
        least sunk work) until the round fits.  Terminates: a single
        active request's window is <= cache_len <= pool size."""
        eng, sched = self.engine, self.sched
        while not eng.ensure_round_capacity():
            assert sched.n_active > 1, \
                "single request exceeded the page pool — arrival " \
                "admission should have rejected it"
            slot = sched.preempt(sched.pick_preemption_victim())
            eng.release_slot(slot)

    def _step_round(self):
        """One SD round + clock accounting.  Returns finished requests."""
        eng, sched = self.engine, self.sched
        if self.paged:
            self._grow_or_preempt()
        self.peak_active = max(self.peak_active, sched.n_active)
        t_round0 = self.now
        groups = self.topo.slot_groups(
            r.slot for r in sched.active_requests)
        m = eng.run_round(
            verdict_groups=[slots for _, slots in groups]
            if self.cfg.verdict_batch else None)
        self.n_rounds += 1

        # --- clock: parallel edge drafting, per-cell contended uplinks,
        # batched cloud verify, per-cell downlink feedback ---
        t_slm = self.cfg.t_slm_s if self.cfg.t_slm_s is not None \
            else m["t_slm"]
        t_llm = self.cfg.t_llm_s if self.cfg.t_llm_s is not None \
            else m["t_llm"]
        edge_done = self.now + t_slm
        arrive = edge_done
        by_slot = {r.slot: r for r in sched.active_requests}
        for cell, slots in groups:
            # cells transmit in PARALLEL; payloads within a cell
            # serialise FIFO on its shared uplink in slot order.
            # wire_bits_row is len(pack(DraftPayload)) * 8 — the ACTUAL
            # bytes the edge serialises, not the analytic budget the
            # edge used to choose L^t (bits_row, kept for reporting)
            for slot in slots:
                tx = cell.uplink.transmit(
                    edge_done, float(m["wire_bits_row"][slot]))
                by_slot[slot].uplink_wait_s += tx.wait_s
                arrive = max(arrive, tx.arrive_s)
        # downlink feedback: each cell's verdicts serialise FIFO on its
        # shared broadcast downlink — per-verdict messages, or ONE coded
        # frame per cell when verdict batching is on.  The lockstep
        # barrier is the last verdict's arrival across all cells.
        verify_done = arrive + t_llm
        self.now = verify_done
        frames = {tuple(f["slots"]): f["bits"]
                  for f in m["verdict_frames"]}
        for cell, slots in groups:
            if self.cfg.verdict_batch:
                tx = cell.downlink.transmit(verify_done,
                                            frames[tuple(slots)])
                self.now = max(self.now, tx.arrive_s)
            else:
                for slot in slots:
                    tx = cell.downlink.transmit(
                        verify_done, float(m["verdict_bits_row"][slot]))
                    self.now = max(self.now, tx.arrive_s)

        # --- observability (read-only over m and the clock marks) ---
        if self.obs.enabled:
            tr = self.obs.tracer
            if tr.enabled:
                rd = {"round": self.n_rounds, "n_slots": len(by_slot)}
                tr.span("draft", t_round0, edge_done, tid="lockstep",
                        args=rd)
                tr.span("uplink", edge_done, arrive, tid="lockstep")
                tr.span("verify", arrive, verify_done, tid="lockstep")
                tr.span("downlink", verify_done, self.now, tid="lockstep")
            mx = self.obs.metrics
            mx.counter("serve.rounds").inc()
            mx.histogram("serve.t_slm_s").observe(t_slm)
            mx.histogram("serve.t_llm_s").observe(t_llm)
            mx.gauge("serve.active_slots").set(len(by_slot))
            if self.obs.decomp is not None:
                self.obs.decomp.observe_round(m)

        # --- token delivery + completion ---
        finished = []
        for req in list(sched.active_requests):
            req.n_rounds += 1
            if req.add_tokens(m["emitted"][req.slot], self.now):
                slot = sched.complete(req, self.now)
                eng.release_slot(slot)
                finished.append(req)
        return finished

    # ------------------------------------------------------------------
    def run_trace(self, trace: List[Request]) -> ServeReport:
        """Replay an arrival trace to completion and report.  Dispatches
        on the configured schedule: the global-barrier lockstep loop
        below, or the event-driven pipelined loop (serve.events) — both
        emit bit-identical per-request token streams."""
        if self.cfg.pipeline == "pipelined":
            from repro_torch.serve.events import EventDrivenLoop
            loop = EventDrivenLoop(self)
            n_total = loop.run(trace)
            self.now = loop.now
            self.n_rounds = loop.n_verify_batches
            self.n_spec_hits = loop.n_spec_hits
            self.n_spec_misses = loop.n_spec_misses
            return self._report(n_total)
        pending = sorted(trace, key=lambda r: r.t_arrival)
        n_total = len(pending)
        while True:
            self._admit_arrivals(pending)
            self._schedule_tick()
            self.sched.check_invariants()
            if self.sched.n_active == 0:
                if pending:                    # idle: jump to next arrival
                    self.now = max(self.now, pending[0].t_arrival)
                    continue
                break                          # trace drained
            self._step_round()
            if self.n_rounds >= self.cfg.max_rounds:
                raise RuntimeError("serve loop exceeded max_rounds — "
                                   "request(s) not terminating?")
        return self._report(n_total)

    # ------------------------------------------------------------------
    def _report(self, n_total: int) -> ServeReport:
        fin = self.sched.finished
        lats = [r.latency_s for r in fin]
        toks = sum(r.n_tokens for r in fin)
        mk = self.now
        up_util = [c.uplink.utilization(mk) for c in self.topo.cells]
        down_util = [c.downlink.utilization(mk) for c in self.topo.cells]
        snapshot_topology(self.obs.metrics, self.topo)
        return ServeReport(
            policy=self.cfg.policy,
            n_requests=n_total,
            n_finished=len(fin),
            n_rejected=len(self.sched.rejected),
            makespan_s=mk,
            total_tokens=toks,
            throughput_tok_s=toks / mk if mk > 0 else 0.0,
            latency_p50_s=percentile(lats, 50),
            latency_p90_s=percentile(lats, 90),
            latency_p95_s=percentile(lats, 95),
            latency_p99_s=percentile(lats, 99),
            ttft_mean_s=float(np.mean([r.ttft_s for r in fin]))
            if fin else float("nan"),
            queue_wait_mean_s=float(np.mean([r.queue_wait_s
                                             for r in fin]))
            if fin else float("nan"),
            uplink_wait_mean_s=float(np.mean([r.uplink_wait_s
                                              for r in fin]))
            if fin else float("nan"),
            uplink_utilization=float(np.mean(up_util)),
            rejection_rate=len(self.sched.rejected) / max(n_total, 1),
            n_rounds=self.n_rounds,
            n_preempted=self.sched.n_preemptions,
            peak_active=self.peak_active,
            page_size=self.cfg.page_size,
            n_pages=self.engine.alloc.n_pages if self.paged else 0,
            peak_pages_in_use=self.engine.alloc.peak_in_use
            if self.paged else 0,
            pipeline=self.cfg.pipeline,
            latency_mean_s=float(np.mean(lats)) if lats else float("nan"),
            n_spec_hits=self.n_spec_hits,
            n_spec_misses=self.n_spec_misses,
            n_cells=self.cfg.n_cells,
            verdict_batch=self.cfg.verdict_batch,
            downlink_utilization=float(np.mean(down_util)),
            downlink_bits_total=float(sum(c.downlink.bits_total
                                          for c in self.topo.cells)),
            downlink_msgs=sum(c.downlink.n_msgs
                              for c in self.topo.cells),
            uplink_bits_total=float(sum(c.uplink.bits_total
                                        for c in self.topo.cells)),
            cell_uplink_utilization=up_util,
            cell_downlink_utilization=down_util,
            requests=self.sched.finished + self.sched.rejected,
        )
