"""Multi-cell serving topology: many radio cells, one cloud verifier.

The paper's bit-budget analysis assumes a single contended edge-cloud
link.  Production serving looks different: many radio cells each
aggregate their own edge devices behind their OWN shared uplink (and
their own broadcast downlink), and every cell feeds the SAME cloud
verify engine.  This module is that topology layer:

  ``Cell``          — one radio cell: a contiguous partition of the
                      engine's slot space, a per-cell admission/
                      preemption ``Scheduler`` over those slots, and the
                      cell's ``SharedUplink`` / ``SharedDownlink``.
  ``CellTopology``  — the fan-in: routes arrivals to their cell
                      (``Request.cell`` mod n_cells, so any trace
                      replays under any cell count), runs every cell's
                      scheduling tick in cell order, and aggregates the
                      scheduler-facing queries the serving loops use.

What it deliberately does NOT own: the verify side.  The cloud remains
ONE ``CloudVerifyEngine`` batching verify calls across cells (masked-
batch equivalence makes the verdicts independent of the grouping), and
one engine slot space backs all cells — a cell is a LINK + SCHEDULING
domain, not a model replica.  That is exactly why multi-cell streams
are bit-identical to the single-cell reference: cells only change which
wire a payload rides and when, never the tokens.

Preemption across cells (page-pool exhaustion — the page pool is a
CLOUD resource shared by every cell): the victim order must be
replayable, so ``pick_preemption_victim`` extends the per-cell LIFO
rule with a global key — maximum (t_admit, global slot id) over ALL
cells' active requests.  A t_admit tie (several cells admitting in one
scheduling tick) falls to the highest global slot id; cell membership
never enters the key, so renumbering cells cannot reorder victims.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Tuple

from repro_torch.core import channel as channel_mod
from repro_torch.serve.request import Request
from repro_torch.serve.scheduler import Scheduler, SchedulerConfig


@dataclasses.dataclass
class Cell:
    """One radio cell: slots, scheduler, and its two shared links."""
    cell_id: int
    slot_ids: List[int]
    sched: Scheduler
    uplink: channel_mod.SharedUplink
    downlink: channel_mod.SharedDownlink

    @property
    def active_requests(self) -> List[Request]:
        return self.sched.active_requests


class CellTopology:
    """N cells × (uplink + downlink + scheduler) feeding one cloud.

    The engine's ``max_batch`` slots are partitioned contiguously and
    as evenly as possible among the cells (earlier cells take the
    remainder); ``queue_cap`` is PER CELL — each cell has its own
    waiting room, as each has its own radio access network.  With
    ``n_cells == 1`` every method degenerates to the single Scheduler /
    single SharedUplink behavior the pre-cell serving layer had.
    """

    def __init__(self, n_cells: int, max_batch: int, queue_cap: int,
                 policy: str, ch: channel_mod.ChannelConfig):
        assert 1 <= n_cells <= max_batch, \
            f"{n_cells} cells need at least one engine slot each " \
            f"(max_batch={max_batch})"
        self.n_cells = n_cells
        self.max_batch = max_batch
        self.cells: List[Cell] = []
        base = 0
        for c in range(n_cells):
            n_c = max_batch // n_cells + (1 if c < max_batch % n_cells
                                          else 0)
            slot_ids = list(range(base, base + n_c))
            base += n_c
            self.cells.append(Cell(
                cell_id=c, slot_ids=slot_ids,
                sched=Scheduler(SchedulerConfig(
                    max_batch=n_c, queue_cap=queue_cap, policy=policy),
                    slot_ids=slot_ids),
                uplink=channel_mod.SharedUplink(ch),
                downlink=channel_mod.SharedDownlink(ch)))
        self._cell_of_slot = {s: cell for cell in self.cells
                              for s in cell.slot_ids}

    # -- routing --------------------------------------------------------
    def cell_of(self, req: Request) -> Cell:
        return self.cells[req.cell % self.n_cells]

    def cell_of_slot(self, slot: int) -> Cell:
        return self._cell_of_slot[slot]

    def slot_groups(self, slots) -> List[Tuple[Cell, List[int]]]:
        """Group engine slots by cell, cells in id order, slots
        ascending within each — the deterministic order downlink frames
        are packed and applied in."""
        slots = set(slots)
        out = []
        for cell in self.cells:
            mine = sorted(slots.intersection(cell.slot_ids))
            if mine:
                out.append((cell, mine))
        return out

    # -- aggregate queries (the Scheduler-facing union interface) -------
    @property
    def n_active(self) -> int:
        return sum(c.sched.n_active for c in self.cells)

    @property
    def waiting(self) -> List[Request]:
        return [r for c in self.cells for r in c.sched.waiting]

    @property
    def active_requests(self) -> List[Request]:
        """All cells' active requests in global slot order."""
        return sorted((r for c in self.cells
                       for r in c.sched.active_requests),
                      key=lambda r: r.slot)

    @property
    def finished(self) -> List[Request]:
        return [r for c in self.cells for r in c.sched.finished]

    @property
    def rejected(self) -> List[Request]:
        return [r for c in self.cells for r in c.sched.rejected]

    @property
    def n_preemptions(self) -> int:
        return sum(c.sched.n_preemptions for c in self.cells)

    @property
    def n_submitted(self) -> int:
        return sum(c.sched.n_submitted for c in self.cells)

    @property
    def n_admitted(self) -> int:
        return sum(c.sched.n_admitted for c in self.cells)

    def has_work(self) -> bool:
        return any(c.sched.has_work() for c in self.cells)

    # -- transitions (routed to the owning cell) ------------------------
    def reject(self, req: Request):
        self.cell_of(req).sched.reject(req)

    def submit(self, req: Request, now: float) -> bool:
        return self.cell_of(req).sched.submit(req, now)

    def schedule(self, now: float,
                 can_admit: Optional[Callable[[Request], bool]] = None,
                 ) -> List[Tuple[int, Request]]:
        """One scheduling tick over every cell, in cell order.  A shared
        ``can_admit`` resource gate (the paged pool is cloud-side and
        cell-agnostic) sees admissions in that same order, so same-tick
        reservations compose across cells exactly as they did within
        one scheduler."""
        admissions = []
        for cell in self.cells:
            admissions.extend(cell.sched.schedule(now,
                                                  can_admit=can_admit))
        return admissions

    def pick_preemption_victim(self) -> Request:
        """Globally deterministic LIFO: max (t_admit, global slot id)
        over every cell's active requests (see module docstring)."""
        active = [r for c in self.cells for r in c.sched.active_requests]
        assert active, "no active request to preempt"
        return max(active, key=lambda r: (r.t_admit, r.slot))

    def preempt(self, req: Request) -> int:
        return self.cell_of(req).sched.preempt(req)

    def complete(self, req: Request, now: float) -> int:
        return self.cell_of(req).sched.complete(req, now)

    # -- invariants -----------------------------------------------------
    def check_invariants(self):
        for cell in self.cells:
            cell.sched.check_invariants()
        rids = [r.rid for c in self.cells
                for r in c.sched.active_requests]
        assert len(rids) == len(set(rids)), "request active in two cells"
