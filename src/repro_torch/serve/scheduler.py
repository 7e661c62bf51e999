"""Admission/eviction scheduler: packs requests into engine slots.

Two policies:

  continuous  (default) — every free slot is refilled from the FIFO
              waiting queue at every scheduling tick: requests join and
              leave the SD batch mid-flight (continuous batching, the
              Orca/vLLM discipline).
  static      — slots are only refilled when the WHOLE batch has
              drained: classic static batching, kept as the baseline
              the serve_load benchmark compares against.

Admission control: the waiting room holds at most ``queue_cap``
requests; arrivals beyond that are rejected (the per-method rejection
rate the paper-level load study reports).

Paged-KV serving adds two mechanisms:
  * ``schedule(now, can_admit=...)`` gates admissions on a resource
    predicate (the session passes "enough free pages for the prompt +
    one draft window"); the queue stays FIFO — a head request that does
    not fit blocks the tail (no size-based skipping / starvation);
  * ``preempt`` evicts an ACTIVE request back to the FRONT of the
    waiting queue when the page pool is exhausted mid-flight.  Its
    tokens are discarded — per-request RNG streams make the re-run emit
    the identical text — and it bypasses ``queue_cap`` (it was already
    admitted once).

Invariants (asserted by ``check_invariants`` and the scheduler tests):
  * a slot holds at most one ACTIVE request, and every ACTIVE request
    holds exactly one slot;
  * len(active) <= max_batch;
  * len(waiting) <= queue_cap + max_batch (the slack is preempted
    requests re-queued at the front);
  * requests never skip states (QUEUED -> ACTIVE -> {FINISHED | back to
    QUEUED on preemption}, or QUEUED -> REJECTED on arrival only).
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Callable, List, Optional, Tuple

from repro_torch.serve.request import Request, RequestState


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    max_batch: int = 4          # engine slots
    queue_cap: int = 64         # waiting-room size; beyond this -> reject
    policy: str = "continuous"  # continuous | static


class Scheduler:
    def __init__(self, cfg: SchedulerConfig,
                 slot_ids: Optional[List[int]] = None):
        """``slot_ids`` (multi-cell serving): the GLOBAL engine slots
        this scheduler owns — a cell's scheduler manages its partition
        of the engine's slot space and every Request.slot it assigns is
        a global id.  Default: slots 0..max_batch−1 (the single-cell
        identity mapping, unchanged behavior)."""
        assert cfg.policy in ("continuous", "static"), cfg.policy
        self.cfg = cfg
        self.slot_ids = (list(slot_ids) if slot_ids is not None
                         else list(range(cfg.max_batch)))
        assert len(self.slot_ids) == cfg.max_batch
        assert len(set(self.slot_ids)) == cfg.max_batch
        self._local = {g: i for i, g in enumerate(self.slot_ids)}
        self.waiting: collections.deque = collections.deque()
        self.slots: List[Optional[Request]] = [None] * cfg.max_batch
        self.finished: List[Request] = []
        self.rejected: List[Request] = []
        self.n_preemptions = 0
        self.n_submitted = 0     # arrivals offered (admitted to queue or not)
        self.n_admitted = 0      # queue -> slot transitions (re-admissions
        #                          after preemption count again)

    # -- queries --------------------------------------------------------
    @property
    def n_active(self) -> int:
        return sum(r is not None for r in self.slots)

    @property
    def free_slots(self) -> List[int]:
        """Free GLOBAL slot ids, in this scheduler's fixed slot order."""
        return [self.slot_ids[i] for i, r in enumerate(self.slots)
                if r is None]

    @property
    def active_requests(self) -> List[Request]:
        return [r for r in self.slots if r is not None]

    def has_work(self) -> bool:
        return self.n_active > 0 or len(self.waiting) > 0

    # -- transitions ----------------------------------------------------
    def reject(self, req: Request):
        """Turn away an arrival (queue full, or it can never fit a
        slot)."""
        assert req.state == RequestState.QUEUED
        req.state = RequestState.REJECTED
        self.rejected.append(req)

    def submit(self, req: Request, now: float) -> bool:
        """Arrival.  Returns False (and marks REJECTED) when the waiting
        room is full."""
        assert req.state == RequestState.QUEUED
        self.n_submitted += 1
        if len(self.waiting) >= self.cfg.queue_cap:
            self.reject(req)
            return False
        self.waiting.append(req)
        return True

    def schedule(self, now: float,
                 can_admit: Optional[Callable[[Request], bool]] = None,
                 ) -> List[Tuple[int, Request]]:
        """One scheduling tick: admit waiting requests into free slots
        according to the policy.  ``can_admit`` (paged serving) gates
        each admission on resources; the FIFO head blocks the tail when
        it does not fit.  Returns (slot, request) admissions; the
        session must prefill each admitted request into its slot."""
        if self.cfg.policy == "static" and self.n_active > 0:
            return []          # batch barrier: drain before refilling
        admissions = []
        for slot in self.free_slots:
            if not self.waiting:
                break
            if can_admit is not None and not can_admit(self.waiting[0]):
                break
            req = self.waiting.popleft()
            req.state = RequestState.ACTIVE
            req.slot = slot
            req.t_admit = now
            self.slots[self._local[slot]] = req
            self.n_admitted += 1
            admissions.append((slot, req))
        return admissions

    def pick_preemption_victim(self) -> Request:
        """LIFO victim selection for page-pool exhaustion: the most
        recently admitted active request has the least sunk work (and
        its deterministic RNG re-emits the same tokens on the re-run).

        The order is FULLY deterministic, which is what makes preemption
        replayable: victims sort by (t_admit, global slot id) and the
        MAXIMUM wins — a t_admit tie (several admissions in one
        scheduling tick) falls to the HIGHEST global slot, i.e. the last
        slot filled that tick.  ``CellTopology`` extends the same key
        across cells: global slot ids are unique engine-wide, so the
        cross-cell victim order is pinned too (tested by
        test_fuzz_serve.py)."""
        active = self.active_requests
        assert active, "no active request to preempt"
        return max(active, key=lambda r: (r.t_admit, r.slot))

    def preempt(self, req: Request) -> int:
        """Page-pool exhaustion eviction: the request loses its slot and
        its generated-so-far tokens (deterministic per-request RNG makes
        the re-run reproduce them) and re-queues at the FRONT of the
        waiting room.  Returns the freed slot id for the engine side."""
        assert req.state == RequestState.ACTIVE and req.slot is not None
        assert self.slots[self._local[req.slot]] is req
        slot = req.slot
        self.slots[self._local[slot]] = None
        req.state = RequestState.QUEUED
        req.slot = None
        req.tokens = []
        req.t_first_token = None
        req.n_preempts += 1
        self.n_preemptions += 1
        self.waiting.appendleft(req)
        return slot

    def complete(self, req: Request, now: float) -> int:
        """Eviction on completion: frees the slot.  Returns the slot id
        so the session can release the engine side."""
        assert req.state == RequestState.ACTIVE and req.slot is not None
        assert self.slots[self._local[req.slot]] is req
        slot = req.slot
        self.slots[self._local[slot]] = None
        req.state = RequestState.FINISHED
        req.t_finish = now
        self.finished.append(req)
        return slot

    # -- invariants ------------------------------------------------------
    def check_invariants(self):
        assert len(self.slots) == self.cfg.max_batch
        # slack over queue_cap: preempted requests re-queue at the front
        # without re-passing admission control
        assert len(self.waiting) <= self.cfg.queue_cap + self.cfg.max_batch
        seen = set()
        for gslot, req in zip(self.slot_ids, self.slots):
            if req is None:
                continue
            assert req.state == RequestState.ACTIVE
            assert req.slot == gslot, (req.rid, req.slot, gslot)
            assert req.rid not in seen
            seen.add(req.rid)
        for req in self.waiting:
            assert req.state == RequestState.QUEUED and req.slot is None
        for req in self.finished:
            assert req.state == RequestState.FINISHED
        for req in self.rejected:
            assert req.state == RequestState.REJECTED
