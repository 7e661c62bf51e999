"""The closed loop of edge devices over the system's lockstep serving path.

One slot per device.  ``EdgeCloudEngine.admit_slot`` prefills a request
on both models, ``run_round`` runs one round for every active slot (edge
draft with the SQS kernels, wire pack and unpack, cloud extend, accept and
resample, verdict pack and apply), ``release_slot`` frees a finished one.
The loop never sleeps for the link: each round's cost on the modeled
clock is its wall time, with the admissions that stalled it, plus its
modeled link time (``harness.link``).  A token arrives at the end of the
round that carried it; a request is sent the moment its device's last
one ended.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from harness import link as link_mod
from harness.traffic import Fleet, Request


@dataclasses.dataclass
class Live:
    """A request in flight and everything the metrics and the check read
    of it."""
    req: Request
    send_clock: float
    delivered: int = 0
    first_clock: Optional[float] = None
    last_clock: Optional[float] = None
    rounds: list = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class Round:
    in_window: bool
    stall_s: float          # admissions before it
    admits: int
    admit_tokens: list      # prompt lengths admitted before it
    wall_s: float           # run_round
    t_slm: float
    t_llm: float
    link_s: float
    active: int
    rows: int               # slots the round computed (all, active or not)
    positions: np.ndarray   # active slots' positions at the round's start
    tokens: int             # delivered
    up_bits: float          # payload bits, framing excluded
    n_live: int
    n_accept: int
    k_sum: float            # support sizes of the live drafts, summed


@dataclasses.dataclass
class Served:
    rounds: List[Round]
    finished: List[Live]
    live: List[Live]        # in flight when the window closed
    window_s: float
    ttft_s: List[float]     # requests whose first token fell in the window
    gaps_s: List[float]     # every later token delivered in the window
    attempted: int


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Loop:
    def __init__(self, engine, fleet: Fleet, traffic: dict, device,
                 span=None):
        self.eng = engine
        self.fleet = fleet
        self.link = traffic["link"]
        self.device = device
        self.span = span or (lambda name: contextlib.nullcontext())
        self.live: Dict[int, Live] = {}
        self.pending: List[int] = []
        self.clock = 0.0
        self.rounds: List[Round] = []
        self.finished: List[Live] = []
        self.ttft: List[float] = []
        self.gaps: List[float] = []
        self.in_window = False
        self.attempted = 0

    # -- admissions -----------------------------------------------------
    def admit(self, slot: int):
        req = self.fleet.next(slot)
        with self.span("bench.admit"):
            self.eng.admit_slot(slot, req.prompt, seed=req.seed)
            _sync(self.device)
        self.live[slot] = Live(req, self.clock)
        if self.in_window:
            self.attempted += 1
        return len(req.prompt)

    def admit_all(self):
        for slot in range(self.fleet.n):
            self.admit(slot)

    # -- one iteration: the admissions it waits for, then a round -------
    def step(self):
        t0 = time.perf_counter()
        admitted = [self.admit(s) for s in self.pending]
        self.pending = []
        stall = time.perf_counter() - t0
        pos = self.eng.pos.cpu().numpy()
        active_slots = sorted(self.live)
        t1 = time.perf_counter()
        with self.span("bench.round"):
            m = self.eng.run_round()
        wall = time.perf_counter() - t1
        up = [len(b) * 8.0 for b in m["packed"].values()]
        down = [len(b) * 8.0 for b in m["verdict_packed"].values()]
        link_s = link_mod.round_link_s(self.link, up, down)
        self.clock += stall + wall + link_s
        delivered = 0
        for slot in active_slots:
            lv = self.live[slot]
            emitted = m["emitted"][slot]
            lv.rounds.append((m["packed"][slot], m["verdict_packed"][slot],
                              tuple(emitted)))
            take = min(len(emitted), lv.req.out_len - lv.delivered)
            for _ in range(take):
                if lv.first_clock is None:
                    lv.first_clock = self.clock
                    if self.in_window:
                        self.ttft.append(self.clock - lv.send_clock)
                elif self.in_window:
                    self.gaps.append(self.clock - lv.last_clock)
                lv.last_clock = self.clock
            lv.delivered += take
            delivered += take
            if lv.delivered >= lv.req.out_len:
                self.eng.release_slot(slot)
                self.finished.append(self.live.pop(slot))
                self.pending.append(slot)
        act = m["active"]
        self.rounds.append(Round(
            in_window=self.in_window, stall_s=stall, admits=len(admitted),
            admit_tokens=admitted, wall_s=wall, t_slm=m["t_slm"],
            t_llm=m["t_llm"], link_s=link_s, active=int(act.sum()),
            rows=len(act), positions=pos[act], tokens=delivered,
            up_bits=float(sum(up)), n_live=int(m["L_live"][act].sum()),
            n_accept=int(m["n_accept"][act].sum()),
            k_sum=float(m["K_mean"]) * int(m["L_live"][act].sum())))

    # -- the measured window --------------------------------------------
    def window(self, seconds: float) -> float:
        gc.collect()
        gc.freeze()
        gc.disable()
        self.in_window = True
        self.attempted = len(self.live)
        try:
            with self.span("bench.window"):
                t0 = time.perf_counter()
                while time.perf_counter() - t0 < seconds:
                    self.step()
                elapsed = time.perf_counter() - t0
        finally:
            self.in_window = False
            gc.enable()
        return elapsed

    def result(self, window_s: float) -> Served:
        return Served(self.rounds, self.finished, list(self.live.values()),
                      window_s, self.ttft,
                      self.gaps, self.attempted)
