"""Event-driven pipelined serving loop (PipeSD-style overlap; mirrors
``repro.serve.events``).

The lockstep loop (``ServeSession._step_round``) is a global barrier:
every active request drafts, then every payload serialises on the shared
uplink, then ONE batched verify runs, then the feedback broadcast — the
cloud idles while the edges draft and the edges idle while the cloud
verifies.  This module replaces the barrier with a discrete-event
simulation over a heap of

    arrival → edge-done → uplink-arrive → verify-done → downlink-arrive

events, so the three resources overlap across requests:

  * each request drafts on its OWN edge device (drafts run in parallel
    across requests, t_slm each);
  * payloads serialise FIFO on the ONE shared uplink the moment their
    draft finishes (``core.channel.SharedUplink`` — head-of-line waits
    are charged per request, exactly as in lockstep);
  * the cloud is a single server that batches every payload that has
    arrived by the time it goes idle into one verify call (t_llm) —
    masked-batch equivalence makes the verdicts independent of how the
    requests happen to be grouped;
  * each verdict returns on the downlink independently
    (``wire.VerdictPayload`` packed bits).

Optimistic continuation: after a payload is handed to the uplink the
edge device is idle, so it speculatively drafts round t+1 under the
premise that every live draft is accepted and the bonus token equals
its own continuation sample (``PendingRound.drafts[n_live]``).  When the
verdict confirms the premise the next payload is ready the moment the
speculative draft finishes; when it refutes it, the speculative work is
aborted (modeled as free — a cancelled kernel) and the corrective draft
starts at verdict arrival, exactly where lockstep would start it — so
mis-speculation never makes the pipeline slower than lockstep, and the
PRNG discipline (the corrective draft re-consumes the same per-round
key the speculation used) keeps token streams BIT-IDENTICAL to lockstep
either way.  That also holds when another slot drafts between a
speculative draft and its verdict: the speculative draft moved its
slot's replay registers to its own inputs, so the other slot's call
rewrites the speculative KV with the same values
(``core.engine.EdgeDraftEngine.draft_speculative``).  The reference
replays the slot's last committed round there instead, which
overwrites the speculative KV, and its pipelined streams can leave its
lockstep streams once a speculative round is confirmed (ROADMAP Queue 3
item 14).

Pipelined mode needs positional (attention-KV) draft/target caches,
which is all the port serves so far.  Paged serving is supported with a
WORST-CASE admission gate (pages for prompt + max_new + draft window
reserved up front), so mid-flight preemption — which would tangle with
in-flight verdicts — never triggers.

Multi-cell topology: each request's payload rides ITS cell's shared
uplink and its verdict returns on ITS cell's broadcast downlink
(serve.cells.CellTopology); the cloud stays one server batching every
arrived payload across cells.  With verdict batching the cloud
coalesces each verify batch's verdicts into one coded frame per cell
(engine.pack_verdict_batch) — the frame serialises once on the cell's
downlink and its verdicts are applied in ascending slot order on
arrival, which is the same deterministic order the lockstep loop uses.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
from typing import Dict, List, Optional

from repro_torch.core.engine import PendingRound, SpecDraft, \
    StatefulModelError
from repro_torch.obs import CLOCK_MODELED, NULL_OBS, Obs
from repro_torch.serve.request import Request

PIPELINED_REFUSAL = ("pipelined serving requires attention-only "
                     "draft/target models (sequential-state rollback is "
                     "lockstep-only)")

ARRIVAL = "arrival"
EDGE_DONE = "edge_done"
UPLINK_ARRIVE = "uplink_arrive"
VERIFY_DONE = "verify_done"
DOWNLINK_ARRIVE = "downlink_arrive"


class EventQueue:
    """Deterministic min-heap of (time, seq, kind, data) events.

    ``seq`` is a monotone insertion counter, which pins two properties
    the replayable-serving tests depend on: (1) same-timestamp events
    pop in PUSH order — the tie-break is explicit, not an accident of
    heap layout; (2) ``kind``/``data`` are NEVER compared, so payloads
    may be dicts, dataclasses, bytes or anything else unorderable
    without ever raising from inside heapq."""

    def __init__(self):
        self._heap: list = []
        self._seq = itertools.count()

    def push(self, t: float, kind: str, data=None):
        heapq.heappush(self._heap, (t, next(self._seq), kind, data))

    def pop(self):
        """(t, kind, data) of the earliest event (FIFO within ties)."""
        t, _, kind, data = heapq.heappop(self._heap)
        return t, kind, data

    def __len__(self) -> int:
        return len(self._heap)


@dataclasses.dataclass
class _SlotCtx:
    """Per-slot in-flight state between events."""
    req: Request
    rec: Optional[PendingRound] = None    # round awaiting verdict
    spec: Optional[SpecDraft] = None      # optimistic round t+1
    spec_ready_s: float = 0.0


@dataclasses.dataclass
class VerdictOutcome:
    """What one verdict did to its request — the state machine's answer
    the driving loop turns into its next action: stop (``finished``),
    send the confirmed speculative round (``spec_round``), or start a
    corrective draft (neither)."""
    req: Request
    emitted: List[int]
    finished: bool
    spec_round: Optional[PendingRound]


class RoundStateMachine:
    """The clock-free per-slot round logic of the serving loops:
    admission into engine slots, drafting, optimistic continuation and
    verdict application — every TOKEN-AFFECTING step, with the clock
    and the transport left entirely to the caller (the simulated
    ``EventDrivenLoop`` here; a socket runner reuses it unchanged).

    ``now`` arguments are whatever clock the caller runs (virtual
    seconds in the simulator); they feed request METRICS only, never
    token decisions."""

    def __init__(self, eng, sched, speculate: bool, cache_len: int,
                 obs: Optional[Obs] = None, clock: str = CLOCK_MODELED):
        self.eng = eng
        self.sched = sched
        self.speculate = speculate
        self.cache_len = cache_len
        self.slots: Dict[int, _SlotCtx] = {}
        self.n_drafts = 0
        self.n_spec_hits = 0
        self.n_spec_misses = 0
        # observability: counters + speculation instants on the caller's
        # clock ("modeled" in the simulator, "wall" over sockets).  The
        # instruments only ever SEE state; they never steer it.
        self.obs = obs if obs is not None else NULL_OBS
        self.clock = clock

    # -- admission ------------------------------------------------------
    def cache_need(self, req: Request) -> int:
        """Worst-case slot footprint: prompt + generation + one draft
        window (the engine's admit-time capacity contract)."""
        return int(req.prompt.shape[0]) + req.max_new_tokens \
            + self.eng.e.L_max + 1

    def submit(self, req: Request, now: float) -> bool:
        """Queue an arrival; oversized requests are rejected up front
        (they could never fit a slot, no matter how empty the system)."""
        if self.cache_need(req) > self.cache_len:
            self.sched.reject(req)
            return False
        return self.sched.submit(req, now)

    def admit_ready(self, now: float, can_admit=None) -> List[int]:
        """One scheduling tick: admit waiting requests into free engine
        slots; returns the newly occupied slot ids (the caller starts
        their first drafts)."""
        admitted = []
        for slot, req in self.sched.schedule(now, can_admit=can_admit):
            assert self.cache_need(req) <= self.cache_len
            self.eng.admit_slot(slot, req.prompt, req.seed,
                                wire_codec=req.wire_codec)
            self.slots[slot] = _SlotCtx(req=req)
            admitted.append(slot)
        return admitted

    # -- drafting -------------------------------------------------------
    def draft(self, slot: int) -> PendingRound:
        rec = self.eng.draft_slots([slot])[slot]
        self.n_drafts += 1
        self.obs.metrics.counter("serve.drafts").inc()
        self.slots[slot].rec = rec
        return rec

    def draft_many(self, slots: List[int]) -> Dict[int, PendingRound]:
        """One BATCHED draft call over several slots (the lockstep
        barrier's shape) — masked-batch equivalence makes the rounds
        identical to per-slot drafting."""
        recs = self.eng.draft_slots(list(slots))
        self.n_drafts += len(recs)
        self.obs.metrics.counter("serve.drafts").inc(len(recs))
        for s, rec in recs.items():
            self.slots[s].rec = rec
        return recs

    def would_finish(self, req: Request, rec: PendingRound) -> bool:
        """Under the optimistic premise the request emits n_live+1
        tokens — if that completes it, round t+1 never runs."""
        return req.n_tokens + rec.n_live + 1 >= req.max_new_tokens

    def speculate_after(self, slot: int,
                        rec: PendingRound) -> Optional[SpecDraft]:
        """Optimistic round t+1 once ``rec``'s payload is in flight."""
        ctx = self.slots[slot]
        if not self.speculate or self.would_finish(ctx.req, rec):
            return None
        spec = self.eng.draft_speculative_slot(slot, rec)
        if spec is not None:
            self.n_drafts += 1
            self.obs.metrics.counter("serve.spec_drafts").inc()
            ctx.spec = spec
        return spec

    # -- verdict application --------------------------------------------
    def apply_verdict(self, slot: int, verdict,
                      now: float) -> VerdictOutcome:
        ctx = self.slots[slot]
        rec, ctx.rec = ctx.rec, None
        spec, ctx.spec = ctx.spec, None
        req = ctx.req
        hit = spec is not None and \
            self.eng.spec_premise_holds(spec, rec, verdict)
        # on a hit the speculative round's draft window must survive the
        # post-verdict page shrink; on a miss it is reclaimed
        emitted = self.eng.apply_verdict_slot(slot, verdict, rec,
                                              shrink=not hit)
        req.n_rounds += 1
        finished = req.add_tokens(emitted, now)
        if finished:
            self.sched.complete(req, now)
            self.eng.release_slot(slot)
            del self.slots[slot]
            return VerdictOutcome(req=req, emitted=emitted,
                                  finished=True, spec_round=None)
        if hit:
            self.n_spec_hits += 1
            self.obs.metrics.counter("serve.spec_hits").inc()
            self.obs.tracer.instant("spec_hit", now, clock=self.clock,
                                    tid=f"slot{slot}")
            self.eng.commit_speculative(spec)
            ctx.rec = spec.round     # the confirmed round is now in flight
            return VerdictOutcome(req=req, emitted=emitted,
                                  finished=False, spec_round=spec.round)
        if spec is not None:
            self.n_spec_misses += 1   # abort is free (cancelled work)
            self.obs.metrics.counter("serve.spec_misses").inc()
            self.obs.tracer.instant("spec_abort", now, clock=self.clock,
                                    tid=f"slot{slot}")
        return VerdictOutcome(req=req, emitted=emitted,
                              finished=False, spec_round=None)


class EventDrivenLoop:
    """Drives a ServeSession's engine/scheduler/uplink through the
    event heap.  Token streams are bit-identical to the lockstep loop;
    only the CLOCK differs (overlap instead of barriers).  All token-
    affecting steps live in the shared ``RoundStateMachine``; this class
    owns the virtual clock, the simulated links and the paged
    reservation accounting."""

    def __init__(self, sess):
        self.sess = sess
        self.eng = sess.engine
        self.sched = sess.sched
        self.topo = sess.topo
        self.cfg = sess.cfg
        if self.eng.edge.stateful or self.eng.peer_stateful:
            raise StatefulModelError(PIPELINED_REFUSAL)
        self.now = 0.0
        self._queue = EventQueue()
        self.cloud_busy_until = 0.0
        self.cloud_queue: List[int] = []
        self.obs = sess.obs
        self.rsm = RoundStateMachine(self.eng, self.sched,
                                     cfg_speculate(sess.cfg), sess.cache_len,
                                     obs=sess.obs)
        self.slots = self.rsm.slots
        self.reserved_pages = 0
        self.n_verify_batches = 0

    @property
    def n_drafts(self) -> int:
        return self.rsm.n_drafts

    @property
    def n_spec_hits(self) -> int:
        return self.rsm.n_spec_hits

    @property
    def n_spec_misses(self) -> int:
        return self.rsm.n_spec_misses

    # -- clock helpers --------------------------------------------------
    def _dur_slm(self, measured: float) -> float:
        return self.cfg.t_slm_s if self.cfg.t_slm_s is not None \
            else measured

    def _dur_llm(self, measured: float) -> float:
        return self.cfg.t_llm_s if self.cfg.t_llm_s is not None \
            else measured

    def _push(self, t: float, kind: str, data=None):
        self._queue.push(t, kind, data)

    # -- main loop ------------------------------------------------------
    def run(self, trace: List[Request]) -> int:
        """Replay ``trace`` to completion; returns total requests."""
        pending = sorted(trace, key=lambda r: r.t_arrival)
        for req in pending:
            self._push(req.t_arrival, ARRIVAL, req)
        handlers = {
            ARRIVAL: self._on_arrival,
            EDGE_DONE: self._on_edge_done,
            UPLINK_ARRIVE: self._on_uplink_arrive,
            VERIFY_DONE: self._on_verify_done,
            DOWNLINK_ARRIVE: self._on_downlink_arrive,
        }
        budget = self.cfg.max_rounds * max(self.cfg.max_batch, 1)
        while self._queue:
            t, kind, data = self._queue.pop()
            self.now = max(self.now, t)
            handlers[kind](data)
            self.sched.check_invariants()
            if self.n_drafts > budget:
                raise RuntimeError("pipelined loop exceeded its draft "
                                   "budget — request(s) not terminating?")
        assert self.sched.n_active == 0 and not self.sched.waiting
        return len(trace)

    # -- admission ------------------------------------------------------
    def _worst_case_gate(self):
        """Paged admission gate, WORST CASE: reserve pages for prompt +
        max_new_tokens + one draft window, so mid-flight growth (incl.
        the speculative window, which is strictly smaller) can never
        exhaust the pool — pipelined serving has no preemption path."""
        if not self.eng.paged:
            return None

        def gate(req: Request) -> bool:
            need = self.eng.pages_needed(self.rsm.cache_need(req))
            if self.reserved_pages + need > self.eng.alloc.n_pages:
                return False
            # reserve AT THE GATE: several admissions in one scheduling
            # tick must each see the previous one's reservation
            self.reserved_pages += need
            return True

        return gate

    def _on_arrival(self, req: Request):
        self.rsm.submit(req, self.now)
        self._tick_admissions()

    def _tick_admissions(self):
        for slot in self.rsm.admit_ready(self.now,
                                         can_admit=self._worst_case_gate()):
            self.sess.peak_active = max(self.sess.peak_active,
                                        self.sched.n_active)
            self._start_draft(slot)

    # -- edge -----------------------------------------------------------
    def _start_draft(self, slot: int):
        rec = self.rsm.draft(slot)
        t_done = self.now + self._dur_slm(rec.t_slm)
        self.obs.tracer.span("draft", self.now, t_done,
                             tid=f"slot{slot}")
        self._push(t_done, EDGE_DONE, (slot, rec))

    def _on_edge_done(self, data):
        slot, rec = data
        ctx = self.slots[slot]
        ctx.rec = rec
        tx = self.topo.cell_of_slot(slot).uplink.transmit(
            self.now, rec.wire_bits)
        ctx.req.uplink_wait_s += tx.wait_s
        self.obs.tracer.span("uplink", self.now, tx.arrive_s,
                             tid=f"slot{slot}",
                             args={"wait_s": tx.wait_s,
                                   "bits": rec.wire_bits})
        self._push(tx.arrive_s, UPLINK_ARRIVE, slot)
        # the edge device is idle until the verdict returns: draft ahead
        spec = self.rsm.speculate_after(slot, rec)
        if spec is not None:
            ctx.spec_ready_s = self.now + self._dur_slm(spec.round.t_slm)
            self.obs.tracer.span("spec_draft", self.now, ctx.spec_ready_s,
                                 tid=f"slot{slot}")

    # -- uplink / cloud -------------------------------------------------
    def _on_uplink_arrive(self, slot: int):
        self.cloud_queue.append(slot)
        self.obs.metrics.gauge("serve.cloud.queue_depth").set(
            len(self.cloud_queue))
        if self.now >= self.cloud_busy_until:
            self._start_verify()

    def _start_verify(self):
        batch, self.cloud_queue = self.cloud_queue, []
        packed = {s: self.slots[s].rec.packed for s in batch}
        vb = self.eng.verify_slots(packed)
        self.n_verify_batches += 1
        done = self.now + self._dur_llm(vb.t_llm)
        self.cloud_busy_until = done
        self.obs.tracer.span("verify", self.now, done, tid="cloud",
                             args={"n_slots": len(batch)})
        self.obs.metrics.histogram(
            "serve.verify.batch_size",
            bounds=(1, 2, 4, 8, 16, 32)).observe(len(batch))
        self._push(done, VERIFY_DONE, (batch, vb))

    def _on_verify_done(self, data):
        batch, vb = data
        # each cell's verdicts serialise FIFO on ITS broadcast downlink
        # (cells in id order, slots ascending within a cell — the same
        # deterministic order the lockstep loop charges)
        for cell, slots in self.topo.slot_groups(batch):
            if self.cfg.verdict_batch:
                # ONE coded frame per cell per verify batch; its
                # verdicts travel (and later apply) together
                frame = self.eng.pack_verdict_batch(
                    {s: vb.verdicts[s] for s in slots})
                tx = cell.downlink.transmit(self.now, len(frame) * 8)
                self.obs.tracer.span("downlink", self.now, tx.arrive_s,
                                     tid=f"cell{cell.cell_id}",
                                     args={"slots": list(slots)})
                self._push(tx.arrive_s, DOWNLINK_ARRIVE,
                           ("frame", frame))
            else:
                for slot in slots:
                    # per-slot negotiated codec (wire codec v2 entropy-
                    # codes the verdict); the edge decodes with the same
                    # negotiation
                    data_v = self.eng.pack_verdict_slot(
                        slot, vb.verdicts[slot])
                    tx = cell.downlink.transmit(self.now,
                                                len(data_v) * 8)
                    self.obs.tracer.span("downlink", self.now,
                                         tx.arrive_s,
                                         tid=f"cell{cell.cell_id}",
                                         args={"slots": [slot]})
                    self._push(tx.arrive_s, DOWNLINK_ARRIVE,
                               ("verdict", (slot, data_v)))
        if self.cloud_queue:                 # work queued while busy
            self._start_verify()

    # -- verdict application --------------------------------------------
    def _on_downlink_arrive(self, data):
        kind, payload = data
        if kind == "frame":
            # ascending slot order — the frame's packed order
            for slot, verdict in self.eng.unpack_verdict_batch(payload):
                self._apply_verdict(slot, verdict)
        else:
            slot, data_v = payload
            self._apply_verdict(
                slot, self.eng.unpack_verdict_slot(slot, data_v))

    def _apply_verdict(self, slot: int, verdict):
        spec_ready_s = self.slots[slot].spec_ready_s
        out = self.rsm.apply_verdict(slot, verdict, self.now)
        if out.finished:
            if self.eng.paged:
                self.reserved_pages -= self.eng.pages_needed(
                    self.rsm.cache_need(out.req))
            self._tick_admissions()
            return
        if out.spec_round is not None:
            self._push(max(self.now, spec_ready_s), EDGE_DONE,
                       (slot, out.spec_round))
        else:
            self._start_draft(slot)


def cfg_speculate(cfg) -> bool:
    """Whether a serving config asks for optimistic continuation (on
    when the config has no ``speculate`` field)."""
    return getattr(cfg, "speculate", True)
